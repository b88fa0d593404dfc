"""seamless-m4t-medium [audio] — enc-dec, 12L d1024 16H (kv=16) d_ff=4096
vocab=256206. Audio frontend is a stub: a batch carries precomputed
frame embeddings (B, S_enc, frame_dim). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    modality="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    ffn="gelu",
    norm="layernorm",
    mlp_activation="gelu",
    frame_dim=1024,
    dec_ratio=8,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-medium-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    frame_dim=32,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
