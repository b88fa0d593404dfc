"""mixtral-8x7b [moe] — 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    ffn="moe",
    n_experts=8,
    top_k=2,
    window=4096,
    window_all=True,
    rope_base=1e6,
)

SMOKE = CONFIG.replace(
    name="mixtral-8x7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    n_experts=4,
    top_k=2,
    window=32,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
