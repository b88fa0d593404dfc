"""granite-8b [dense] — 36L d4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="granite-8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
