from .precision import full_f32
from .profiling import traced

__all__ = ["full_f32", "traced"]
