from .synthetic import particles, particles_numpy

__all__ = ["particles", "particles_numpy"]
