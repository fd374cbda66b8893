"""Shared helpers of the PyTorch-port parity tests (``test_torch_*``).

Inputs are made once with numpy from a seed and handed to both packages
as numpy arrays; the JAX side runs on the CPU with x64 (``conftest.py``).
"""
from __future__ import annotations

import numpy as np
import jax
import torch

from repro.core import FmmConfig as JaxConfig
from repro.core.fmm import fmm_build as jax_fmm_build
from repro.data.synthetic import particles as jax_particles
from repro_torch.core.config import FmmConfig
from repro_torch.core.fmm import plan_from_numpy

_jit_build = jax.jit(jax_fmm_build, static_argnums=2)

# The port's CPU tests run small tensors: one intra-op thread per test
# worker avoids oversubscribing the cores the parallel workers share.
torch.set_num_threads(1)


def configs(**kw):
    """The same config in both packages (carried across by its fields)."""
    return JaxConfig(**kw), FmmConfig(**kw)


def inputs(dist: str, n: int, seed: int = 0):
    """(z, q) complex128 numpy arrays from the reference's generator."""
    z, q = jax_particles(dist, n, seed)
    return np.array(z), np.array(q)


def jax_plan(jcfg, z, q):
    """The reference's jitted topology, as numpy (one ``device_get``)."""
    return jax.device_get(_jit_build(z, q, jcfg))


def shared_plan(dist="uniform", n=1024, seed=0, **kw):
    """One topology fed to both packages: (jcfg, tcfg, the reference's
    plan (JAX arrays), the same plan as torch tensors (B = 1, CPU))."""
    jcfg, tcfg = configs(n=n, **kw)
    z, q = inputs(dist, n, seed)
    jp = jax_plan(jcfg, z, q)
    plan = plan_from_numpy(jp.tree, jp.conn, tcfg, device="cpu")
    return jcfg, tcfg, jax.tree.map(jax.numpy.asarray, jp), plan


def t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor with a leading B = 1 axis."""
    return torch.from_numpy(np.array(a))[None]


def rel(got, ref) -> float:
    """max |got - ref| / max |ref| over numpy-convertible arrays."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
