"""The port's multi-device substrate against the JAX reference:
``repro_torch.parallel`` (sharding rules, ``maybe_shard``, the int8
error-feedback all-reduce, compressed data parallelism),
``repro_torch.launch.mesh`` and the elastic checkpoint path.

The reference runs on forced host devices in a subprocess
(``tests/_parallel_ref.py``); the port runs one process a rank over gloo
(``tests/_torch_ranks.py`` through ``repro_torch.testing.ranks``): three
spawns (4, 2 and 8 ranks), each covering several checks.
"""
import ast
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import jax.numpy as jnp

from repro.checkpoint import (restore_checkpoint as ref_restore,
                              save_checkpoint as ref_save)
from repro.launch.hlo_analysis import collective_bytes_weighted
from repro.parallel import dequantize_int8 as ref_dequantize
from repro.parallel import quantize_int8 as ref_quantize
import repro.parallel as ref_parallel

import torch
import repro_torch.parallel as port_parallel
from repro_torch.parallel import (NamedSharding, PartitionSpec,
                                  dequantize_int8, quantize_int8)
from repro_torch.testing.ranks import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _parallel_ref as R  # noqa: E402
import _torch_ranks as T  # noqa: E402


def norm(spec) -> tuple:
    """A spec as comparable entries: each a tuple of names or None, one
    name as the name, trailing Nones dropped."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) != 1 else e[0]
            e = e or None
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    ref_dir = str(d / "reference")
    full = T.ckpt_tree()
    ref_save(ref_dir, 7, {"a": {"w": full["a"]["w"].numpy()},
                          "b": full["b"].numpy(), "c": full["c"].numpy()})
    return str(d), ref_dir


@pytest.fixture(scope="module")
def ref_run(dirs):
    """The reference subprocess, started first so it runs beside the
    spawns."""
    path = os.path.join(dirs[0], "ref.npz")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE,
                                                          "_parallel_ref.py"),
                             "parallel", path], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks4(ref_run, dirs):
    return run_ranks(T.four, 4, dirs[0])


@pytest.fixture(scope="module")
def ranks2(ranks4, dirs):
    return run_ranks(T.two, 2, dirs[0], dirs[1])


@pytest.fixture(scope="module")
def ranks8(ref_run):
    return run_ranks(T.eight, 8)


@pytest.fixture(scope="module")
def ref(ref_run):
    proc, path = ref_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_parallel_exports_match_reference():
    assert set(ref_parallel.__all__) <= set(port_parallel.__all__)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(R.SHARD_CASES)))
def test_maybe_shard_keeps_the_reference_spec(ranks4, ref, case):
    """On a (2, 2) gloo mesh the placements of ``maybe_shard`` are the spec
    the reference's keeps (absent axis, non-dividing dim and two-axis
    entries dropped or kept alike), and each rank holds its row-major
    block."""
    shape, spec = R.SHARD_CASES[case]
    want = norm(ast.literal_eval(str(ref[f"shard{case}"])))
    full = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    for rank, out in enumerate(ranks4):
        got, local, whole = out[f"shard{case}"]
        assert norm(got) == want, (rank, got, want)
        assert whole
        coord = out["coordinate"]
        block = full
        for d, entry in enumerate(norm(want)):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k, idx = 1, 0
            for n in names:
                i = mesh.mesh_dim_names.index(n)
                k, idx = k * mesh.shape[i], idx * mesh.shape[i] + coord[i]
            block = np.split(block, k, axis=d)[idx]
        np.testing.assert_array_equal(local, block)


def test_maybe_shard_redistributes_a_dtensor(ranks4):
    full = np.arange(48.0, dtype=np.float32).reshape(8, 6)
    for out in ranks4:
        spec, local = out["reshard"]
        assert norm(spec) == (None, "data")
        d = out["coordinate"][0]
        np.testing.assert_array_equal(local, full[:, 3 * d:3 * d + 3])


def test_maybe_shard_without_a_mesh_is_identity():
    x = torch.ones(4, 4)
    assert port_parallel.maybe_shard(x, PartitionSpec("data", None)) is x


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    pl = NamedSharding(mesh, PartitionSpec(("pod", "data"), None,
                                           "model")).placements
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(mesh, PartitionSpec()).placements == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        NamedSharding(mesh, PartitionSpec(("data", "pod"))).placements
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, PartitionSpec("data", "data")).placements


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_info_matches_reference(ranks4, ranks8, ref):
    assert all(o["mesh_info"] == ast.literal_eval(str(ref["mesh22_info"]))
               for o in ranks4)
    assert all(o["mesh_info"] == ast.literal_eval(str(ref["mesh222_info"]))
               for o in ranks8)


def test_production_mesh_refuses_the_world(ranks4, ref):
    assert str(ref["production_error"]) == "ValueError"
    assert all(o["production_error"] == ("MeshError", True) for o in ranks4)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _quantize_inputs(kind, scale):
    rng = np.random.default_rng(3)
    if kind == "normal":
        return (rng.normal(size=257) * scale).astype(np.float32)
    if kind == "ties":
        # amax 127 * scale: the codes' quantum is scale, and every other
        # entry sits exactly half a quantum off a code
        k = np.arange(-127, 128, dtype=np.float32)
        x = (k + np.where(np.abs(k) < 127, 0.5, 0.0)) * np.float32(scale)
        x[0], x[-1] = -127 * np.float32(scale), 127 * np.float32(scale)
        return x.astype(np.float32)
    return np.zeros(64, np.float32)


@pytest.mark.parametrize("kind,scale", [
    ("normal", 1e-6), ("normal", 1e-2), ("normal", 1.0), ("normal", 3e3),
    ("normal", 1e6), ("ties", 1.0), ("ties", 0.25), ("ties", 1e-3),
    ("zeros", 1.0)])
def test_quantize_int8_bitwise_reference(kind, scale):
    """Half-to-even rounding and the 1e-30 floor on the scale, bit for
    bit the reference's codes, scale and dequantized values."""
    x = _quantize_inputs(kind, scale)
    rq, rs = ref_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(
        dequantize_int8(q, s).numpy().view(np.int32),
        np.asarray(ref_dequantize(rq, rs)).view(np.int32))
    if kind == "ties" and scale in (1.0, 0.25):   # exact ties
        assert (q.numpy()[1:-1] % 2 == 0).all()


@pytest.mark.parametrize("world", R.EF_WORLDS)
def test_ef_allreduce_bitwise_reference(ranks4, ranks2, ref, world):
    """The port's ``ef_allreduce`` on ``world`` gloo ranks against the
    reference under ``shard_map`` on the same per-rank inputs: the mean
    and every rank's new error bit for bit."""
    outs = {2: ranks2, 4: ranks4}[world]
    for rank, o in enumerate(outs):
        got = o["ef_group"]
        assert got["mean"].tobytes() == ref[f"ef{world}_mean"].tobytes()
        assert got["new_err"].tobytes() == \
            ref[f"ef{world}_new_err"][rank].tobytes()


def test_ef_allreduce_by_mesh_axis_name(ranks4):
    for o in ranks4:
        for k in ("mean", "new_err"):
            assert o["ef_named"][k].tobytes() == o["ef_group"][k].tobytes()


def test_ef_allreduce_bytes_on_the_wire(ranks4, ref):
    """int32 codes and one f32 scale: the traced bytes of ``ef_allreduce``
    are the reference HLO's (4 bytes an element + 4), and a plain f32
    all-reduce is 4 bytes an element — no byte reduction. A gloo trace
    of an all-gather is refused, not sized by its input."""
    n = T.TRACE_N
    hlo = collective_bytes_weighted(str(ref["hlo_ef"]))
    assert hlo == {"all-reduce": 4 * R.HLO_N + 4, "total": 4 * R.HLO_N + 4}
    assert collective_bytes_weighted(str(ref["hlo_pmean"]))["total"] == \
        4 * R.HLO_N
    for o in ranks4:
        assert o["traced_ef"] == {"all-reduce": 4 * n + 4,
                                  "total": 4 * n + 4}
        assert o["traced_plain"] == {"all-reduce": 4 * n, "total": 4 * n}
        # a gloo trace does not size an all-gather's result: refused
        assert o["traced_gather"] == "ValueError"


def _pod_grads(w, batch):
    """Exact per-pod gradients (f64) of the reference loss on each pod's
    half of the batch."""
    out = []
    for b in np.split(batch.astype(np.float64), 2):
        g = np.zeros_like(w, dtype=np.float64)
        r = b @ w[:2].astype(np.float64)
        g[:2] = 2.0 * b.T @ r / r.size
        out.append(g)
    return out


def _quantum(w, batches):
    """The largest quantization step (scale) of the error-feedback steps
    on ``batches``, from the exact per-pod gradients."""
    q, err = 0.0, [0.0, 0.0]
    for b in batches:
        ys = [g + e for g, e in zip(_pod_grads(w, b), err)]
        scale = max(np.abs(y).max() for y in ys) / 127.0
        err = [y - np.round(y / scale) * scale for y in ys]
        q = max(q, scale)
    return q


EPS = float(np.finfo(np.float32).eps)
# f32 rounding of one step, in units of EPS * max |y| (y = a pod's
# gradient plus the error fed in): what a step's gradient, its errors and
# the identity below may be off by; a feedback fault moves them by up to
# half a quantum, 127 / 2 of those units
F32_ROUNDING = 4.0


def _hold_step(w, batch, got, got_in, want, want_in):
    """One step of ``make_compressed_value_and_grad``: the port's ``(grad,
    errors)`` after being fed ``got_in`` against the reference's ``want``
    after ``want_in`` (errors: one row a pod).

    The identity error feedback keeps, from the exact per-pod gradients
    g_p: grad + mean_p(new_err_p) = mean_p(g_p + err_in_p), within f32
    rounding. Each pod's codes, (y_p - new_err_p) / scale, are integers
    and equal the reference's (but at a tie of the rounding); where they
    are, the grad and the errors equal the reference's within f32
    rounding."""
    (grad, err), (rgrad, rerr) = got, want
    pod_g = _pod_grads(w, batch)
    ys = [g + e for g, e in zip(pod_g, got_in.astype(np.float64))]
    rys = [g + e for g, e in zip(pod_g, want_in.astype(np.float64))]
    top = max(np.abs(y).max() for y in ys)
    tol, scale = F32_ROUNDING * EPS * top, top / 127.0
    gap = np.abs(grad + err.astype(np.float64).mean(0) - sum(ys) / 2).max()
    assert gap <= tol, f"feedback identity off by {gap / (EPS * top):.1f}"
    same = np.ones(grad.shape, bool)
    for y, e, ry, re in zip(ys, err, rys, rerr):
        codes, rcodes = (y - e) / scale, (ry - re) / scale
        for c in (codes, rcodes):
            assert np.abs(c - np.round(c)).max() < 1e-2, "codes not integer"
        tie = np.abs(np.abs(y / scale) % 1.0 - 0.5) < 1e-3
        differ = np.round(codes) != np.round(rcodes)
        assert not (differ & ~tie).any(), "codes differ off a tie"
        same &= ~differ
    assert same.mean() > 0.9
    assert np.abs(grad - rgrad)[same].max() <= tol
    assert np.abs(err - rerr)[:, same].max() <= tol


def test_compressed_value_and_grad_reference_problem(ranks8, ref):
    """The reference test's problem on 8 gloo ranks, mesh (2, 2, 2): the
    reference's own bounds against the exact gradient, within one quantum
    of the reference's grads and errors, and the feedback identity and
    the reference's codes and errors within f32 rounding."""
    w, batch = np.ones((8, 8), np.float32), \
        np.arange(16.0, dtype=np.float32).reshape(8, 2)
    exact = sum(_pod_grads(w, batch)) / 2
    exact_loss = np.mean((batch.astype(np.float64) @ w[:2]) ** 2)
    quantum = _quantum(w, [batch])
    zeros = np.zeros((2,) + w.shape, np.float32)
    for o in ranks8:
        loss, grad, err, spec = o["test"]
        rel = np.abs(grad - exact).max() / np.abs(exact).max()
        assert rel < 0.02, rel
        assert abs(float(loss) - exact_loss) < 1e-5
        assert abs(float(loss) - float(ref["vg_test_loss"])) <= \
            1e-6 * abs(float(ref["vg_test_loss"]))
        assert np.abs(grad - ref["vg_test_grad"]).max() <= quantum
        assert np.abs(err - ref["vg_test_err"]).max() <= quantum
        _hold_step(w, batch, (grad, err), zeros,
                   (ref["vg_test_grad"], ref["vg_test_err"]), zeros)
        assert norm(spec) == ("pod",)


@pytest.mark.parametrize("inputs", ["dtensor", "plain"])
def test_compressed_value_and_grad_feeds_errors_back(ranks8, ref, inputs):
    """The seeded problem over two steps, errors fed back: loss within
    1e-6 relative, grads and errors within one quantum of the
    reference's at each step, and at each step the feedback identity and
    the reference's codes and errors within f32 rounding; DTensor and
    plain inputs alike."""
    x = R.inputs()
    quantum = _quantum(x["vg_w"], list(x["vg_batch"]))
    for o in ranks8:
        got_in = want_in = np.zeros((2, 8, 8), np.float32)
        for s, (loss, grad, err) in enumerate(o[inputs]):
            rl = float(ref[f"vg{s}_loss"])
            assert abs(float(loss) - rl) <= 1e-6 * abs(rl)
            assert np.abs(grad - ref[f"vg{s}_grad"]).max() <= quantum
            assert np.abs(err - ref[f"vg{s}_err"]).max() <= quantum
            _hold_step(x["vg_w"], x["vg_batch"][s], (grad, err), got_in,
                       (ref[f"vg{s}_grad"], ref[f"vg{s}_err"]), want_in)
            got_in, want_in = err, ref[f"vg{s}_err"]
    for a, b in zip(ranks8[0]["dtensor"], ranks8[0]["plain"]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("fault", ["zeros", "pod0"])
def test_compressed_value_and_grad_planted_feedback_fault_fails(ranks8, ref,
                                                                fault):
    """The second step fed zero errors, or pod 0's errors on every pod —
    what a vg that dropped its incoming errors, or took the wrong pod's
    slice, returns: held to the errors really carried, the step check
    fails, and the feedback identity is off by far more than rounding."""
    x = R.inputs()
    w, batch = x["vg_w"], x["vg_batch"][1]
    for o in ranks8:
        carried = o["dtensor"][0][2]
        got = o[f"fault_{fault}"]
        with pytest.raises(AssertionError):
            _hold_step(w, batch, got, carried,
                       (ref["vg1_grad"], ref["vg1_err"]), ref["vg0_err"])
        ys = [g + e for g, e in zip(_pod_grads(w, batch),
                                    carried.astype(np.float64))]
        top = max(np.abs(y).max() for y in ys)
        gap = np.abs(got[0] + got[1].astype(np.float64).mean(0)
                     - sum(ys) / 2).max()
        assert gap > 100 * F32_ROUNDING * EPS * top


def test_error_feedback_telescopes(ranks8):
    """Three steps of ``ef_allreduce_tree`` over "pod": the sum of what
    was sent equals the mean over pods of the true gradients' sum minus
    the final errors, within f32 rounding."""
    by_pod = {o["telescope"]["pod"]: o["telescope"] for o in ranks8}
    assert set(by_pod) == {0, 1}
    for k in T.TELESCOPE_SHAPES:
        sent = by_pod[0]["sent"][k]
        for o in ranks8:
            np.testing.assert_array_equal(o["telescope"]["sent"][k], sent)
        want = sum(by_pod[p]["true"][k] - by_pod[p]["err"][k]
                   for p in (0, 1)) / 2
        bound = 3 * T.TELESCOPE_STEPS * np.finfo(np.float32).eps * \
            max(np.abs(by_pod[p]["true"][k]).max() for p in (0, 1))
        assert np.abs(sent - want).max() <= bound


# ---------------------------------------------------------------------------
# elastic checkpoints
# ---------------------------------------------------------------------------

def _files(d):
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man.pop("time")
    return man, {n: open(os.path.join(d, n), "rb").read()
                 for n in sorted(os.listdir(d)) if n.endswith(".npy")}


def test_dtensor_save_writes_the_full_arrays(ranks4, dirs):
    """A save of DTensor leaves (sharded over both axes, one, none) on 4
    ranks writes the files a save of the full arrays writes; every rank
    returns the final directory; the manager writes once."""
    root = dirs[0]
    dt = os.path.join(root, "dtensor", "step_00000003")
    assert {o["saved_to"] for o in ranks4} == {dt}
    assert _files(dt) == _files(os.path.join(root, "full", "step_00000003"))
    assert os.listdir(os.path.join(root, "dtensor")) == ["step_00000003"]
    assert os.listdir(os.path.join(root, "managed")) == ["step_00000005"]


def test_dtensor_save_copies_to_the_host_on_rank_zero_only(ranks4):
    """In a save of DTensor leaves every rank joins the gather, and only
    the writing rank (0) copies the leaves to the host: the three leaves
    of each of the two saves there, none on the other ranks."""
    assert ranks4[0]["host_copies"] == sorted(["a/w", "b", "c"] * 2)
    assert all(o["host_copies"] == [] for o in ranks4[1:])


def test_dtensor_checkpoint_restores_in_the_reference(ranks4, dirs):
    tree, step = ref_restore(os.path.join(dirs[0], "dtensor"))
    full = T.ckpt_tree()
    assert step == 3
    np.testing.assert_array_equal(np.asarray(tree["a"]["w"]),
                                  full["a"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(tree["b"]), full["b"].numpy())
    np.testing.assert_array_equal(np.asarray(tree["c"]), full["c"].numpy())


@pytest.mark.parametrize("source", ["dtensor", "reference"])
def test_restore_onto_a_narrower_mesh(ranks2, source):
    """A checkpoint saved from 4 ranks (or by the reference) restores with
    ``shardings=`` of ``NamedSharding`` onto a (2,) mesh: DTensors with the
    asked placements and local blocks, and the saved full arrays."""
    full = T.ckpt_tree()
    want = {"a/w": (("data",), (4, 6), full["a"]["w"]),
            "b": (("data",), (4,), full["b"]),
            "c": ((), (3,), full["c"])}
    for o in ranks2:
        got = o[source]
        assert got["step"] == {"dtensor": 3, "reference": 7}[source]
        for k, (spec, local, arr) in want.items():
            gspec, glocal, gfull = got[k]
            assert norm(gspec) == spec and glocal == local
            assert gfull.dtype == arr.numpy().dtype
            np.testing.assert_array_equal(gfull, arr.numpy())


def test_manager_restores_latest_onto_a_mesh(ranks2):
    for o in ranks2:
        step, spec, b = o["managed"]
        assert step == 5 and norm(spec) == ()
        np.testing.assert_array_equal(b, T.ckpt_tree()["b"].numpy())
