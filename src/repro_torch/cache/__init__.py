"""Quantized (int8 / packed int4) KV cache, dense layout.  See
``repro_torch.cache.base``."""
from repro_torch.cache.base import (DenseCache, KernelView, KV_LEVELS,
                                    dequantize_kv, kv_levels, quantize_kv)

__all__ = ["DenseCache", "KernelView", "KV_LEVELS", "dequantize_kv",
           "kv_levels", "quantize_kv"]
