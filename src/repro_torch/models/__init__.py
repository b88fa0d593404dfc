"""Model substrate: functional modules over nested-dict parameters."""
from repro_torch.models.model import CausalLM, EncDecLM, build_model

__all__ = ["CausalLM", "EncDecLM", "build_model"]
