"""mamba2-780m [ssm] — 48L d1536, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    n_layers=48,
    d_model=1536,
    n_heads=1,      # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    kind="mamba",
    ffn="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,   # d_inner = 3072, 48 SSD heads
    ssm_groups=1,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-780m-smoke",
    n_layers=2,
    d_model=64,
    vocab=256,
    ssm_state=16,
    ssm_head_dim=16,  # d_inner=128, 8 heads
    ssm_chunk=16,
    loss_chunk=16,
)
