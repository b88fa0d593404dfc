"""llava-next-34b [vlm] — 60L d7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
anyres tiling. Vision frontend is a stub: a batch carries
precomputed patch embeddings (B, P, mm_dim); P counts toward seq_len.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    modality="vlm",
    mm_dim=1024,       # vision tower (CLIP-L) hidden size
    mm_patches=2880,   # anyres: 5 tiles x 576 patches
)

SMOKE = CONFIG.replace(
    name="llava-next-34b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    mm_dim=32,
    mm_patches=8,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
