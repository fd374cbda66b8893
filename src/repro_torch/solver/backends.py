"""Per-phase backend registry for the FMM.

The pipeline in ``repro_torch.core.fmm`` exposes the hooks kernels are
swapped into. A ``Backend`` bundles one implementation per hook; the
registry maps names to backends:

  "reference"  plain torch sweeps of ``repro_torch.core.fmm`` (every hook
               None -> the core path runs its own sweep; the topology's
               is ``classify_level_reference``, once a level, the same
               plain version the "cuda" hook runs on CPU tensors)
  "cuda"       the hand-written CUDA kernels of ``repro_torch.kernels``,
               one per hook: classify (one launch a tree level), the
               upward pass (P2M and every M2M level, at most two
               launches), level-fused M2L, P2L and the
               fused evaluation phase (the main path), and the per-level
               M2L, L2P and P2P. The fused hooks take precedence, so the
               main path runs the first four; a backend derived with
               ``dataclasses.replace(..., m2l_fused=None,
               eval_fused=None)`` and registered under its own name runs
               the per-phase path. Each wrapper launches its kernel on
               CUDA tensors and runs its plain version only on CPU
               tensors.
  "auto"       "cuda" for a CUDA device; "reference" only when the
               caller asked for the CPU

Every hook takes tensors with a leading problem axis B, so a backend
serves ``apply`` (B = 1) and ``apply_batched`` alike — on "cuda", B
problems are one launch per kernel.

Each backend declares its **batched-dispatch contract**
(``batched_dispatch``), the reference's three values read for explicit
(B, ...) tensors instead of ``jax.vmap``:

  "native"     the hooks take the (B, ...) problem axis into one kernel
               launch each, whatever B ("cuda")
  "vmap"       plain torch hooks that take the B axis as they are
               ("reference"; the default for a new backend)
  "fallback"   hooks that cannot serve a batch: ``FmmSolver`` serves
               ``apply_batched`` through the "reference" hooks instead
               and warns once (``errors.BackendDowngradeWarning``)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..core.config import FmmConfig
from ..device import resolve_device


PhaseImpl = Optional[Callable]

#: Valid ``Backend.batched_dispatch`` values (module docstring).
BATCHED_DISPATCH = ("native", "vmap", "fallback")


@dataclasses.dataclass(frozen=True)
class Backend:
    """Named bundle of per-phase implementations (None -> core sweep),
    with its batched-dispatch contract; ``supports(cfg)`` gates dispatch
    per config."""

    name: str
    p2p: PhaseImpl = None
    m2l: PhaseImpl = None
    l2p: PhaseImpl = None
    m2l_fused: PhaseImpl = None
    p2l: PhaseImpl = None
    eval_fused: PhaseImpl = None
    leaf_classify: PhaseImpl = None    # the topology hook, every level
    upward: PhaseImpl = None
    batched_dispatch: str = "vmap"

    def __post_init__(self):
        if self.batched_dispatch not in BATCHED_DISPATCH:
            raise ValueError(
                f"batched_dispatch={self.batched_dispatch!r} not in "
                f"{BATCHED_DISPATCH}")

    def supports(self, cfg: FmmConfig) -> bool:
        return True

    def phase_impls(self) -> dict:
        """kwargs for ``fmm_evaluate`` selecting this backend's hooks."""
        return {"p2p_impl": self.p2p, "m2l_impl": self.m2l,
                "l2p_impl": self.l2p, "m2l_fused_impl": self.m2l_fused,
                "p2l_impl": self.p2l, "eval_fused_impl": self.eval_fused,
                "upward_impl": self.upward}

    def topology_impls(self) -> dict:
        """kwargs for ``fmm_build`` selecting this backend's topology hook."""
        return {"leaf_classify_impl": self.leaf_classify}


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> list[str]:
    return sorted(_REGISTRY) + ["auto"]


def get_backend(name: str, device=None) -> Backend:
    """Resolve a backend name; "auto" picks by ``device`` (only "auto"
    reads it; ``None`` is the CUDA card, as for every entry point)."""
    if name == "auto":
        device = resolve_device(device)
        return _REGISTRY["cuda" if device.type == "cuda" else "reference"]
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; available: "
                       f"{available_backends()}") from None


def _make_cuda() -> Backend:
    from ..kernels import (eval_fused_apply, l2p_apply, level_classify_cuda,
                           m2l_fused_apply, m2l_level_apply, p2l_apply,
                           p2p_apply, upward_cuda)

    return Backend(name="cuda", p2p=p2p_apply, m2l=m2l_level_apply,
                   l2p=l2p_apply, m2l_fused=m2l_fused_apply, p2l=p2l_apply,
                   eval_fused=eval_fused_apply,
                   leaf_classify=level_classify_cuda, upward=upward_cuda,
                   batched_dispatch="native")


register_backend(Backend(name="reference"))
register_backend(_make_cuda())
