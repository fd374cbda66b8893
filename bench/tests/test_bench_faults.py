"""The rest of a run with the timed path broken underneath, at a tiny size
on the CPU: each fault a cell can have makes ``correct`` false."""
from __future__ import annotations

import pytest
import torch

from repro_torch.solver import FmmSolver, GuardedSolver

from ._cells import run_cell, tiny_cell

#: A relative change that no sound answer shows, well below what a
#: visibly broken kernel would give.
NUDGE = 1e-2


def altered(method):
    def broken(self, *args, **kwargs):
        out = method(self, *args, **kwargs)
        if isinstance(out, tuple):
            return (out[0] * (1 + NUDGE),) + out[1:]
        return out * (1 + NUDGE)
    return broken


@pytest.mark.parametrize("name", ["f64-uniform-solve", "f64-layer-solve"])
def test_solve_answer_altered(monkeypatch, name):
    monkeypatch.setattr(FmmSolver, "apply", altered(FmmSolver.apply))
    _, numbers, correct = run_cell(tiny_cell(name))
    assert not correct, numbers


def test_vortex_answer_altered(monkeypatch):
    monkeypatch.setattr(GuardedSolver, "apply_plan",
                        altered(GuardedSolver.apply_plan))
    _, numbers, correct = run_cell(tiny_cell("f32-vortex-rk2"))
    assert not correct, numbers


def test_vortex_step_returns_its_state_unchanged(monkeypatch):
    from bench.traffic import vortex
    step = vortex.Driver._step

    def stuck(self, z):
        _, u1, zm, u2, reports = step(self, z)
        return z, u1, zm, u2, reports

    monkeypatch.setattr(vortex.Driver, "_step", stuck)
    _, numbers, correct = run_cell(tiny_cell("f32-vortex-rk2"))
    assert not correct and numbers["state_err"] > 0.5, numbers


def _one_bucket():
    """Requests of one bucket only, so that waves make wide batches."""
    return tiny_cell("f32-serve-ragged", rate=40, lattice=[256, 256, 2.0],
                     median_n=128, n_max=256, warm_batches=[1, 2, 4, 8])


def test_serve_answer_altered(monkeypatch):
    monkeypatch.setattr(GuardedSolver, "apply_batched_guarded",
                        altered(GuardedSolver.apply_batched_guarded))
    _, numbers, correct = run_cell(_one_bucket())
    assert not correct, numbers


def test_serve_half_of_the_batch_left_out(monkeypatch):
    method = GuardedSolver.apply_batched_guarded
    widths = []

    def half(self, z, q):
        b = z.shape[0]
        widths.append(b)
        phi, report = method(self, z[:max(1, b // 2)], q[:max(1, b // 2)])
        out = torch.zeros((b,) + tuple(phi.shape[1:]), dtype=phi.dtype)
        out[:phi.shape[0]] = phi
        return out, report

    monkeypatch.setattr(GuardedSolver, "apply_batched_guarded", half)
    _, numbers, correct = run_cell(_one_bucket())
    assert max(widths) >= 2
    assert not correct, numbers
