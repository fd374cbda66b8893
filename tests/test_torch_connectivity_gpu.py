"""PyTorch port on the CUDA card: the connectivity's kernel (the "cuda"
backend's topology hook, one classify launch a level that classifies and
compacts the level's lists, no sort) against its plain twin
(``classify_level_reference``, the build with no hook: theta tests and
cumsum compaction in torch, on the card) on the same tree, bit for bit:
every level's strong and weak lists, the leaf p2p / p2l / m2p lists, the
margins and the overflow. Also that the kept entries of every compacted
row ascend (the invariant the sort-free compaction rests on), and the
launches and level counters of a build.

Cases: the CPU parity cases of ``test_torch_topology.py`` (an overflowing
strong cap, no swapped test, theta 0.3, nlevels 0) and nlevels 1; the
three 2^20 cells' inputs at their caps (uniform f64 48/128, layer f64
256/1024, the vortex pair f32 376/1456); B = 4 problems of different
layouts; rows of more than 4096 valid candidates at caps eight times the
vortex cell's (three doublings of the guard).

Marked ``gpu``: skipped (inside a fixture, never at import) where no
CUDA card is present. On the machine with the card:
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_connectivity_gpu.py``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core.config import FmmConfig
from repro_torch.core.topology import build_connectivity, build_tree
from repro_torch.data import particles
from repro_torch.kernels import (launch_counts, level_classify_cuda,
                                 reset_launch_counts)

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]

# (n, nlevels, distribution, dtype, config fields)
CONN_CASES = [
    (1024, 3, "uniform", "f64", {}),
    (4096, 3, "normal", "f32", {}),
    (4096, 3, "layer", "f64", {}),
    (4096, 3, "layer", "f32", dict(theta=0.3)),
    (4096, 3, "normal", "f64", dict(theta=0.3)),
    (777, 2, "normal", "f64", dict(use_p2l_m2p=False)),
    (4096, 3, "normal", "f32", dict(strong_cap=8)),      # overflowing
    (50, 0, "normal", "f32", {}),
    (4096, 1, "normal", "f64", {}),
    (4096, 1, "layer", "f32", dict(strong_cap=2, weak_cap=1)),
]

N_CELL = 1 << 20
CELLS = {"uniform": ("f64", 48, 128), "layer": ("f64", 256, 1024),
         "vortex": ("f32", 376, 1456)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _vortex_pair(n: int, cuda):
    """The vortex example's pair (positions, strengths as charges)."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    from torch_vortex_dynamics import vortex_pair
    z, gamma = vortex_pair(n)
    return (torch.as_tensor(z, device=cuda),
            torch.as_tensor(gamma.astype(np.complex128), device=cuda))


def _tree(cfg, layouts, cuda, seed=0):
    """The tree of B = len(layouts) problems on the card."""
    zs, qs = [], []
    for b, dist in enumerate(layouts):
        if dist == "vortex":
            z, q = _vortex_pair(cfg.n, cuda)
        else:
            z, q = particles(dist, cfg.n, seed + b, device=cuda)
        zs.append(z)
        qs.append(q)
    return build_tree(torch.stack(zs), torch.stack(qs), cfg)


def _fields(conn):
    return ([(f"strong[{l}]", s) for l, s in enumerate(conn.strong)]
            + [(f"weak[{l}]", w) for l, w in enumerate(conn.weak)]
            + [(k, getattr(conn, k)) for k in ("p2p", "p2l", "m2p",
                                              "margins", "overflow")])


def _kernel_equals_plain(tree, cfg):
    """Build with the kernel and with its plain twin; assert every field
    bit for bit and that each compacted row keeps its entries first,
    ascending. Returns the kernel's lists."""
    plain = build_connectivity(tree, cfg)
    kern = build_connectivity(tree, cfg, leaf_classify_impl=level_classify_cuda)
    torch.cuda.synchronize()
    differ = [name for (name, a), (_, b) in zip(_fields(plain), _fields(kern))
              if a.dtype != b.dtype or not torch.equal(a, b)]
    assert differ == []
    for name, lst in _fields(kern)[:-2]:
        kept = lst >= 0
        # entries first, then -1 padding, and the entries ascend
        assert not (~kept[..., :-1] & kept[..., 1:]).any(), name
        assert ((lst[..., 1:] > lst[..., :-1]) | ~kept[..., 1:]).all(), name
    return kern


@pytest.mark.parametrize("n,levels,dist,dt,kw", CONN_CASES)
def test_kernel_path_equals_plain_path(cuda, n, levels, dist, dt, kw):
    """The kernel against its plain twin at the CPU parity cases (at
    nlevels 0 neither runs: the root's lists are built alike)."""
    cfg = FmmConfig(n=n, nlevels=levels, p=5, dtype=dt, **kw)
    tree = _tree(cfg, [dist], cuda)
    conn = _kernel_equals_plain(tree, cfg)
    if kw.get("strong_cap") == 8:
        assert int(conn.overflow.max()) > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_path_equals_plain_path_at_the_cells(cuda, cell):
    """The kernel against its plain twin on a cell's 2^20 inputs at its
    caps, with no list overflowing."""
    from repro_torch.configs import fmm_config
    dt, S, W = CELLS[cell]
    base = fmm_config(N_CELL, dtype=dt)
    cfg = FmmConfig(n=N_CELL, nlevels=base.nlevels, p=5, dtype=dt,
                    strong_cap=S, weak_cap=W)
    conn = _kernel_equals_plain(_tree(cfg, [cell], cuda), cfg)
    assert int(conn.overflow.max()) == 0


def test_a_batch_of_four_layouts(cuda):
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=5, dtype="f64", strong_cap=64,
                    weak_cap=256)
    tree = _tree(cfg, ["uniform", "normal", "layer", "vortex"], cuda, seed=3)
    conn = _kernel_equals_plain(tree, cfg)
    assert conn.margins.shape == (4, 5)
    assert len({tuple(m) for m in conn.margins.tolist()}) > 1


def test_rows_wider_than_4096_candidates(cuda):
    """theta 0.03 makes most boxes near: leaf rows of up to 4 x ~1,900
    valid candidates, at the vortex cell's caps doubled three times."""
    cfg = FmmConfig(n=1 << 18, nlevels=7, p=5, dtype="f32", theta=0.03,
                    strong_cap=8 * 376, weak_cap=8 * 1456)
    conn = _kernel_equals_plain(_tree(cfg, ["uniform"], cuda), cfg)
    widest = 4 * int((conn.strong[cfg.nlevels - 1] >= 0).sum(-1).max())
    assert widest > 4096


def test_a_cuda_build_counts_its_levels_under_the_kernel(cuda):
    """One classify launch a level, counted under
    ``connectivity.kernel_levels``; no level under ``.plain_levels``."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=5, dtype="f32")
    tree = _tree(cfg, ["normal"], cuda)
    before = trace.snapshot()["counters"]
    torch.cuda.synchronize()
    reset_launch_counts()
    build_connectivity(tree, cfg, leaf_classify_impl=level_classify_cuda)
    torch.cuda.synchronize()
    assert launch_counts()["classify"] == cfg.nlevels
    after = trace.snapshot()["counters"]
    gained = {k: after[k] - before.get(k, 0)
              for k in ("connectivity.kernel_levels",
                        "connectivity.plain_levels")}
    assert gained == {"connectivity.kernel_levels": cfg.nlevels,
                      "connectivity.plain_levels": 0}
