"""smollm-135m [dense]: 30L d576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="smollm-135m-smoke",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=3,
    head_dim=16,
    d_ff=128,
    vocab=256,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
