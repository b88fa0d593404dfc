"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16, parallel attention + mamba heads per layer, SWA everywhere
except three global-attention layers. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    kind="hybrid",
    window=1024,
    global_attn_layers=(0, 15, 31),
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    ssm_expand=1,   # ssm branch width == d_model (25 x 64 = 1600)
    ssm_groups=1,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="hymba-1.5b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    window=16,
    global_attn_layers=(0,),
    ssm_state=16,
    ssm_heads=4,
    ssm_head_dim=16,
    ssm_chunk=16,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
