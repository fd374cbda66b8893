from .synthetic import particles, particles_numpy, ragged_requests

__all__ = ["particles", "particles_numpy", "ragged_requests"]
