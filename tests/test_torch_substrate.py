"""PyTorch port, the single-host runtime substrate, each against its twin
in the JAX package on the same inputs: ``lm_batch`` and ``Prefetcher``
(``data/synthetic.py``), the checkpoint format both ways (a checkpoint
written by either package restores in the other, leaf values bitwise,
dtypes and step equal), retention, atomicity, the corrupt-leaf check,
the async save's snapshot, and ``train_loop`` with ``FailureInjector``
(failure, restore, resume; the summary and the log lines the
reference's). Everything exact: no arithmetic differs."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.launch.runtime import FailureInjector as JaxInjector
from repro.launch.runtime import train_loop as jax_train_loop
from repro_torch import errors
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as ckpt_module
from repro_torch.data import DataConfig, Prefetcher, lm_batch
from repro_torch.launch import FailureInjector, train_loop

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,vocab", [(0, 0, 512), (1, 10, 512),
                                             (7, 123, 5000), (3, 2, 17)])
def test_lm_batch_is_the_references(seed, step, vocab):
    got = lm_batch(DataConfig(vocab=vocab, batch=4, seq=32, seed=seed),
                   step, device="cpu")
    want = jax_lm_batch(JaxDataConfig(vocab=vocab, batch=4, seq=32,
                                      seed=seed), step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].device == CPU
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got["labels"][:, :-1] == got["tokens"][:, 1:]).all()


def test_prefetcher_orders_batches():
    dc = DataConfig(vocab=512, batch=2, seq=8, seed=1)
    pf = Prefetcher(lambda s: lm_batch(dc, s, device="cpu"), start_step=3,
                    depth=2)
    got = [pf.get() for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    jdc = JaxDataConfig(vocab=512, batch=2, seq=8, seed=1)
    for s, batch in got:
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      np.asarray(jax_lm_batch(jdc, s)
                                                 ["tokens"]))
    pf = Prefetcher(lambda s: s * s, start_step=3, depth=2)
    assert [pf.get() for _ in range(4)] == [(3, 9), (4, 16), (5, 25),
                                            (6, 36)]
    pf.close()


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree():
    """One leaf of each dtype the FMM state uses, a list and a scalar."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=64) + 1j * rng.normal(size=64)
    return {"state": {"z": z.astype(np.complex64), "z64": z,
                      "w": rng.normal(size=(3, 4)).astype(np.float32)},
            "caps": [np.int32(48), np.int64(128)],
            "mask": rng.uniform(size=5) > 0.5,
            "step": np.int32(7)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return _flat({str(i): v for i, v in enumerate(tree)}, prefix)
    return {prefix[:-1]: tree}


def _same(got: dict, want: dict) -> None:
    """Leaf for leaf: dtype, shape and bits equal."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, g in got.items():
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_checkpoint_roundtrip_and_retention(tmp_path):
    tree = {"a": {"w": torch.arange(12.0).reshape(3, 4)},
            "step": torch.tensor(7, dtype=torch.int32)}
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        cm.save(s, tree)
    cm.wait()
    restored, step = cm.restore_latest(device="cpu")
    assert step == 3
    _same(restored, tree)
    assert restored["a"]["w"].device == CPU
    kept = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert kept == ["step_00000002", "step_00000003"]
    # the reference's manager reads the same retention set
    assert JaxManager(str(tmp_path)).restore_latest()[1] == 3


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, {"w": torch.zeros(128, 128)})
    assert os.listdir(d) == ["step_00000005"]
    assert latest_step(d) == 5
    leaf = os.path.join(d, "step_00000005", "w.npy")
    with open(leaf, "wb") as f:
        f.write(b"xx")
    with pytest.raises(IOError, match="corrupt checkpoint leaf w"):
        restore_checkpoint(d, 5, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    jax_save(str(tmp_path), 11, {k: (jnp.asarray(v) if k == "step" else v)
                                 for k, v in tree.items()})
    got, step = restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 11
    assert all(t.device == CPU for t in _flat(got).values())
    _same(got, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    as_tensors = {"state": {k: torch.from_numpy(v)
                            for k, v in tree["state"].items()},
                  "caps": [torch.tensor(48, dtype=torch.int32),
                           torch.tensor(128)],
                  "mask": torch.from_numpy(tree["mask"]),
                  "step": np.int32(7)}
    save_checkpoint(str(tmp_path), 12, as_tensors)
    got, step = jax_restore(str(tmp_path))
    assert step == 12
    _same(got, tree)
    # the port reads what it wrote, lists as dicts keyed "0", "1", ...
    mine, _ = restore_checkpoint(str(tmp_path), 12, device="cpu")
    assert set(mine["caps"]) == {"0", "1"}
    _same(mine, got)


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The writer thread is held until the caller has changed every leaf
    in place: the checkpoint still holds the values at ``save``."""
    import threading
    release = threading.Event()
    write = ckpt_module._write

    def held(*args):
        assert release.wait(10)
        return write(*args)

    monkeypatch.setattr(ckpt_module, "_write", held)
    w = torch.arange(6.0)
    z = torch.ones(4, dtype=torch.complex64)
    tree = {"w": w, "z": z, "n": np.arange(3)}
    want = {"w": w.clone(), "z": z.clone(), "n": np.arange(3)}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree)
    w.add_(1)
    z.mul_(2)
    tree["n"] += 5
    release.set()
    cm.wait()
    got, _ = cm.restore_latest(device="cpu")
    _same(got, want)


def test_a_leaf_numpy_cannot_hold_raises_a_typed_error(tmp_path):
    bad = {"w": torch.ones(3, dtype=torch.bfloat16)}
    with pytest.raises(errors.DTypeError, match="bfloat16"):
        save_checkpoint(str(tmp_path), 1, bad)
    assert latest_step(str(tmp_path)) is None
    cm = CheckpointManager(str(tmp_path))
    with pytest.raises(errors.DTypeError):
        cm.save(1, bad)


def test_restore_places_leaves_by_shardings(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2),
                                       "b": [torch.zeros(3)]})
    tree, _ = restore_checkpoint(str(tmp_path), shardings=CPU)
    assert tree["a"].device == CPU and tree["b"]["0"].device == CPU
    tree, _ = restore_checkpoint(str(tmp_path),
                                 shardings={"a": CPU, "b": ["cpu"]})
    assert tree["b"]["0"].device == CPU
    # the default device is the card: no silent fall-back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.DeviceUnavailableError):
        restore_checkpoint(str(tmp_path))
    with pytest.raises(errors.DeviceUnavailableError):
        restore_checkpoint(str(tmp_path), shardings={"a": CPU})


# ---------------------------------------------------------------------------
# the fault-tolerant step loop
# ---------------------------------------------------------------------------

def _masked(lines):
    """Log lines with the step time masked (the one number that differs
    between two runs)."""
    return [re.sub(r"dt +[0-9.]+ms", "dt <t>ms", s) for s in lines]


def _run_both(ckpt, state, injector, loop, tmp):
    """Fail at step 5, restore the latest checkpoint, resume to 10: the
    logs and summaries of both attempts."""
    step_fn = lambda s, b, i: (s + 1, {"loss": 0.5 * i + float(b)})
    logs = []
    cm = ckpt(str(tmp))
    fi = injector(fail_at=(5,))
    with pytest.raises(RuntimeError, match="injected node failure at step 5"):
        loop(step_fn, state, lambda s: s % 3, start_step=0, num_steps=10,
             ckpt_manager=cm, ckpt_every=2, failure=fi, log_every=2,
             log_fn=logs.append)
    restored, step = cm.restore_latest()
    out, summary = loop(step_fn, restored, lambda s: s % 3, start_step=step,
                        num_steps=10, ckpt_manager=cm, ckpt_every=2,
                        failure=fi, log_every=2, log_fn=logs.append)
    return out, step, summary, logs


def test_train_loop_failure_and_resume_matches_the_reference(tmp_path):
    port = _run_both(lambda d: _CpuManager(d), torch.zeros(()),
                     FailureInjector, train_loop, tmp_path / "port")
    ref = _run_both(JaxManager, jnp.zeros(()), JaxInjector, jax_train_loop,
                    tmp_path / "ref")
    (state, step, summary, logs), (jstate, jstep, jsummary, jlogs) = port, ref
    assert isinstance(state, torch.Tensor) and float(state) == 10.0
    assert float(jstate) == 10.0 and step == jstep == 4
    assert set(summary) == set(jsummary)
    for k in ("last_step", "losses", "slow_steps"):
        assert summary[k] == jsummary[k], k
    assert summary["last_step"] == 9
    assert np.isfinite(summary["median_step_time"])
    assert _masked(logs) == _masked(jlogs)


class _CpuManager(CheckpointManager):
    """The port's manager restoring onto the CPU (its default device is
    the card)."""

    def restore_latest(self, shardings=None, *, device="cpu"):
        return super().restore_latest(shardings, device=device)


def test_failure_injector_fires_once_a_step():
    fi = FailureInjector(fail_at=(2, 4))
    fi.check(1)
    for s in (2, 4):
        with pytest.raises(RuntimeError):
            fi.check(s)
        fi.check(s)
    assert fi._done == {2, 4}
