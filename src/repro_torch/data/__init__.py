from .synthetic import (DataConfig, Prefetcher, lm_batch, particles,
                        particles_numpy, ragged_requests)

__all__ = ["DataConfig", "Prefetcher", "lm_batch", "particles",
           "particles_numpy", "ragged_requests"]
