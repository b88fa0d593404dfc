"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    ffn="moe",
    n_experts=40,
    top_k=8,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="granite-moe-3b-a800m-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=256,
    n_experts=8,
    top_k=4,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
