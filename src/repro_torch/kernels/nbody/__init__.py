from .nbody import nbody_cuda, nbody_plan, nbody_plain
from .ops import nbody_direct

__all__ = ["nbody_cuda", "nbody_plan", "nbody_plain", "nbody_direct"]
