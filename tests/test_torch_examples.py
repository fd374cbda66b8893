"""PyTorch port, the three examples (``examples/torch_*.py``) against the
reference's (``examples/*.py``): the vortex twin's ``velocity`` and one
RK2 step against the reference's ``velocity`` on the same guard
configuration (f64, p = 12: within 1e-10 relative, equal re-plans and
caps), the quickstart twin's tuned caps against the reference
quickstart's printed ones, and each twin's ``main`` at a small size on
the CPU."""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fmm2d import fmm_config as jax_fmm_config
from repro.solver import FmmSolver as JaxSolver
from repro_torch.configs import fmm_config
from repro_torch.solver import FmmSolver

from _torch_parity import rel

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10


def _example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


vortex = _example("torch_vortex_dynamics")
quickstart = _example("torch_quickstart")
serve_traffic = _example("torch_serve_traffic")


def _guards(n, p, caps):
    """The same guard in both packages on the example's vortex pair (f64):
    tuned with the example's margin, or at fixed small caps that make the
    first refresh re-plan."""
    z0, gamma = vortex.vortex_pair(n)
    jcfg = jax_fmm_config(n, p=p, dtype="f64")
    tcfg = fmm_config(n, p=p, dtype="f64")
    jz, jg = jnp.asarray(z0), jnp.asarray(gamma + 0j)
    tz, tg = torch.from_numpy(z0), torch.from_numpy(gamma + 0j)
    if caps == "tuned":
        jsolver = JaxSolver.build(jcfg, "reference").tune(
            jz, jg, margin=1.5, tiles=False)
        tsolver = FmmSolver.build(tcfg, "cuda", device="cpu").tune(
            tz, tg, margin=1.5, tiles=False)
    else:
        jsolver = JaxSolver.build(dataclasses.replace(jcfg, **caps),
                                  "reference")
        tsolver = FmmSolver.build(dataclasses.replace(tcfg, **caps), "cuda",
                                  device="cpu")
    assert (jsolver.cfg.strong_cap, jsolver.cfg.weak_cap) == \
        (tsolver.cfg.strong_cap, tsolver.cfg.weak_cap)
    return (jz, jg, jsolver.guarded(max_cap_doublings=3),
            tz, tg, tsolver.guarded(max_cap_doublings=3))


@pytest.mark.parametrize("caps", ["tuned", dict(strong_cap=8, weak_cap=16)],
                         ids=["tuned", "small-caps"])
def test_velocity_and_rk2_step_match_the_reference(caps):
    ref = _example("vortex_dynamics")
    dt = 2e-4
    jz, jg, jguard, tz, tg, tguard = _guards(2000, 12, caps)
    ju, jrep = ref.velocity(jz, jg, jguard)
    tu, trep = vortex.velocity(tz, tg, tguard)
    assert tu.dtype == torch.complex128 and not tu.is_conj()
    assert rel(tu, ju) <= TOL
    assert trep.retries == jrep.retries
    assert [a.rung for a in trep.attempts] == [a.rung for a in jrep.attempts]
    if caps != "tuned":
        assert trep.retries > 0
    # one RK2 step, the reference's arithmetic on its velocity
    ju1, _ = ref.velocity(jz, jg, jguard)
    ju2, jrep2 = ref.velocity(jz + 0.5 * dt * ju1, jg, jguard)
    jz1 = jz + dt * ju2
    tz1, (trep1, trep2) = vortex.rk2_step(tz, tg, tguard, dt)
    assert rel(tz1 - tz, np.asarray(jz1 - jz)) <= TOL
    assert trep2.retries == jrep2.retries and trep1.retries == 0
    assert (tguard.cfg.strong_cap, tguard.cfg.weak_cap) == \
        (jguard.cfg.strong_cap, jguard.cfg.weak_cap)


def test_quickstart_tuned_caps_match_the_reference(capsys, monkeypatch):
    n, p = 3000, 12
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--n", str(n),
                                      "--p", str(p), "--backend",
                                      "reference", "--batch", "0"])
    _example("quickstart").main()
    printed = capsys.readouterr().out
    m = re.search(r"tuned caps: strong=(\d+) weak=(\d+) \(from (\d+)/(\d+)\)",
                  printed)
    assert m and "[quickstart] OK" in printed
    got = quickstart.run(n, p, batch=0, backend="cuda", device="cpu",
                         log=lambda s: None)
    assert got["caps"] == (int(m[1]), int(m[2]))
    assert got["default_caps"] == (int(m[3]), int(m[4]))
    assert got["err"] < 1e-4


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--n", "3000", "--p", "12", "--batch", "2"]),
    ("vortex", ["--n", "2000", "--steps", "6"]),
    ("serve_traffic", ["--num", "8", "--median-n", "96"]),
])
def test_example_main_runs_on_the_cpu(capsys, name, argv):
    mod = {"quickstart": quickstart, "vortex": vortex,
           "serve_traffic": serve_traffic}[name]
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    if name == "serve_traffic":
        assert "cumulative:" in out and "wave 1:" in out
    else:
        assert f"[{name}] OK" in out


def test_quickstart_batched_section_on_the_cpu():
    out = quickstart.run(2000, 12, "uniform", backend="cuda", batch=3,
                         device="cpu", log=lambda s: None)
    assert out["dispatched"] == "cuda"
    assert out["err"] < 1e-4 and out["batched_caps"][0] >= 8


def test_vortex_run_holds_z_in_the_config_dtype():
    out = vortex.run(1500, steps=3, p=8, device="cpu", log=lambda s: None)
    assert out["z"].dtype == torch.complex64 and out["z"].device.type == "cpu"
    assert len(out["reports"]) == 6 and out["drift"] < 1e-2
    assert all(r.final_backend == out["reports"][0].final_backend
               and r.degradations == () for r in out["reports"])
    assert out["trace_counts"]["build"] == 1 or out["replans"] > 0


def test_serve_traffic_rejects_each_poison_with_the_reference_error():
    out = serve_traffic.run(num=10, poison=0.5, median_n=96, waves=1,
                            device="cpu", log=lambda s: None)
    want = {"nan-q": "NonFiniteInputError", "inf-z": "NonFiniteInputError",
            "real-z": "DTypeError", "empty": "ShapeError"}
    wave = out["waves"][0]
    kinds = [kind for _, _, _, kind in wave["requests"]]
    assert "ok" in kinds and len(set(kinds)) > 1
    for (n, _, _, kind), (phi, rep) in zip(wave["requests"],
                                           wave["results"]):
        if kind == "ok":
            assert rep.status in ("ok", "recovered") and phi.shape == (n,)
        else:
            assert phi is None and rep.error == want[kind]
