"""Model substrate: functional modules over nested-dict parameters."""
from repro_torch.models.model import CausalLM, build_model

__all__ = ["CausalLM", "build_model"]
