"""gemma3-12b [dense] — 48L d3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local(SWA 1024):global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    local_global_ratio=(5, 1),
    window=1024,
    rope_base=1e6,
    tie_embeddings=True,
    mlp_activation="gelu",  # gemma uses gelu-gated (geglu)
)

SMOKE = CONFIG.replace(
    name="gemma3-12b-smoke",
    n_layers=6,  # one full 5:1 local:global period
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    window=16,
    attn_q_chunk=16,
    attn_kv_chunk=16,
    loss_chunk=16,
)
