"""What the drivers share: the port's configuration from a config file,
the kernel build, seeded samples and the window's end readings."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import FmmConfig, num_levels_for
from repro_torch.solver import program_memory


def fmm_config(config: dict, n: int, strong_cap=None,
               weak_cap=None) -> FmmConfig:
    """The port's ``FmmConfig`` of a configuration file at ``n``
    particles, its depth by the paper's eq. (5.2) from ``n_d``; caps
    default to the file's."""
    return FmmConfig(
        n=n, nlevels=num_levels_for(n, config["n_d"]), p=config["p"],
        theta=config["theta"], kernel=config["kernel"],
        strong_cap=strong_cap or config["strong_cap"],
        weak_cap=weak_cap or config["weak_cap"], dtype=config["dtype"],
        use_p2l_m2p=config["use_p2l_m2p"],
        translations=config["translations"])


def build_kernels(device) -> None:
    """Build every kernel library of the port (one ``nvcc`` a source, all
    at once; a library already built is loaded as it is), so that no
    build falls inside the window."""
    if torch.device(device).type != "cuda":
        return
    import repro_torch.kernels  # noqa: F401  (registers the libraries)
    from repro_torch.kernels.build import LIBRARIES, build_all
    build_all()
    for lib in LIBRARIES.values():
        lib.lib()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample(seed: int, tag: int, population: int, k: int) -> np.ndarray:
    """``k`` distinct indices of ``range(population)`` (all of them when
    ``k`` is larger), sorted, drawn from ``(seed, tag)``."""
    rng = np.random.default_rng([seed, tag])
    k = min(k, population)
    return np.sort(rng.choice(population, size=k, replace=False))


def window_end(run) -> None:
    """Readings every driver takes when its window closes."""
    run.readings["program_pool_bytes"] = program_memory(run.device)["held"]
