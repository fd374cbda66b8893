"""The JAX reference's multi-device paths, run on forced host devices for
the port's parity tests (``tests/test_torch_parallel.py``,
``tests/test_torch_launch_infra.py``). A subprocess, so the forced device
count cannot leak into the test session:

    python tests/_parallel_ref.py hlo OUT.npz        # 2 devices
    python tests/_parallel_ref.py parallel OUT.npz   # 8 devices

``jax.make_mesh`` gives Explicit axes under jax >= 0.7, where a ``jit``
outside a mesh context refuses a sharded program; every mesh here takes
Auto axes and every program runs inside ``jax.set_mesh``.

Inputs come from ``inputs()`` (numpy, seeded), which the torch side
imports too.
"""
from __future__ import annotations

import os
import sys

import numpy as np

SECTION_DEVICES = {"hlo": 2, "parallel": 8}
HLO_N = 1 << 20
EF_SHAPE = (37, 29)
EF_WORLDS = (2, 4)
# maybe_shard cases on the ("data", "model") = (2, 2) mesh: (shape, spec)
SHARD_CASES = (
    ((8, 6), ("data", "model")),
    ((8, 6), (("pod", "data"), None)),     # "pod" is not a mesh axis
    ((3, 6), ("data", "model")),           # 2 does not divide 3
    ((8, 6), (("data", "model"), None)),   # one dim over both axes
    ((2, 6), (("data", "model"), None)),   # 4 does not divide 2
    ((8, 4, 2), (None, "model", "data")),
    ((8,), ()),
)
VG_STEPS = 2


def inputs() -> dict:
    """Seeded inputs of every parity case."""
    rng = np.random.default_rng(0)
    out = {}
    for n in EF_WORLDS:
        scale = 10.0 ** rng.uniform(-3, 3, size=(n, 1, 1))
        out[f"ef{n}_g"] = (rng.normal(size=(n,) + EF_SHAPE)
                           * scale).astype(np.float32)
        out[f"ef{n}_err"] = (rng.normal(size=(n,) + EF_SHAPE)
                             * scale * 1e-2).astype(np.float32)
    out["vg_w"] = rng.normal(size=(8, 8)).astype(np.float32)
    out["vg_batch"] = rng.normal(size=(VG_STEPS, 8, 2)).astype(np.float32)
    out["hlo_g"] = rng.normal(size=(2, HLO_N)).astype(np.float32)
    return out


def loss_fn(p, b):
    """The reference test's loss (``test_compressed_allreduce_multidevice_
    subprocess``); ``b @ w[:2]``."""
    return ((b @ p["w"][:2, :]) ** 2).mean()


def _mesh(jax, shape, axes, devices=None):
    from jax.sharding import AxisType
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=devices)


def hlo(jax, jnp) -> dict:
    """Optimized HLO of ``ef_allreduce`` and of a plain ``pmean`` of a
    2^20-element f32 tensor under shard_map over 2 devices."""
    from jax.sharding import PartitionSpec as PS
    from repro.parallel.compression import _shard_map, ef_allreduce

    mesh = _mesh(jax, (2,), ("pod",))
    g = inputs()["hlo_g"]

    def ef(g, e):
        out, err = ef_allreduce(g[0], e[0], "pod")
        return out, err[None]

    def plain(g):
        return jax.lax.pmean(g[0], "pod")

    texts = {}
    with jax.set_mesh(mesh):
        f = _shard_map(ef, mesh, (PS("pod"), PS("pod")), (PS(), PS("pod")),
                       ("pod",))
        texts["hlo_ef"] = jax.jit(f).lower(g, jnp.zeros_like(g)).compile() \
            .as_text()
        f = _shard_map(plain, mesh, (PS("pod"),), PS(), ("pod",))
        texts["hlo_pmean"] = jax.jit(f).lower(g).compile().as_text()
    return {k: np.array(v) for k, v in texts.items()}


def parallel(jax, jnp) -> dict:
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from repro.launch.mesh import make_production_mesh, mesh_info
    from repro.parallel import (ef_allreduce, init_pod_errors,
                                make_compressed_value_and_grad, maybe_shard)
    from repro.parallel.compression import _shard_map

    x = inputs()
    out = hlo(jax, jnp)
    devs = jax.devices()
    for n in EF_WORLDS:
        mesh = _mesh(jax, (n,), ("x",), devs[:n])

        def ef(g, e):
            m, err = ef_allreduce(g[0], e[0], "x")
            return m, err[None]

        with jax.set_mesh(mesh):
            f = _shard_map(ef, mesh, (PS("x"), PS("x")), (PS(), PS("x")),
                           ("x",))
            m, err = jax.jit(f)(x[f"ef{n}_g"], x[f"ef{n}_err"])
        out[f"ef{n}_mean"], out[f"ef{n}_new_err"] = np.asarray(m), \
            np.asarray(err)

    mesh = _mesh(jax, (2, 2), ("data", "model"), devs[:4])
    out["mesh22_info"] = np.array(repr(mesh_info(mesh)))
    with jax.set_mesh(mesh):
        for i, (shape, spec) in enumerate(SHARD_CASES):
            y = maybe_shard(jnp.zeros(shape, jnp.float32), PS(*spec))
            out[f"shard{i}"] = np.array(repr(tuple(y.sharding.spec)))
    try:
        make_production_mesh()
    except ValueError as e:
        out["production_error"] = np.array(type(e).__name__)

    mesh = _mesh(jax, (2, 2, 2), ("pod", "data", "model"))
    out["mesh222_info"] = np.array(repr(mesh_info(mesh)))
    vg = make_compressed_value_and_grad(loss_fn, mesh)
    with jax.set_mesh(mesh):
        # the reference test's problem, as it writes it
        w = jax.device_put(jnp.ones((8, 8)),
                           NamedSharding(mesh, PS(None, "model")))
        batch = jax.device_put(jnp.arange(16.0).reshape(8, 2),
                               NamedSharding(mesh, PS(("pod", "data"), None)))
        errors = jax.device_put(init_pod_errors({"w": w}, 2),
                                {"w": NamedSharding(mesh, PS("pod"))})
        loss, grads, errors = jax.jit(vg)({"w": w}, batch, errors)
        out["vg_test_loss"] = np.asarray(loss)
        out["vg_test_grad"] = np.asarray(grads["w"])
        out["vg_test_err"] = np.asarray(errors["w"])
        # a seeded problem over VG_STEPS steps, the errors fed back
        w = jax.device_put(jnp.asarray(x["vg_w"]),
                           NamedSharding(mesh, PS(None, "model")))
        errors = init_pod_errors({"w": w}, 2)
        for s in range(VG_STEPS):
            batch = jax.device_put(jnp.asarray(x["vg_batch"][s]),
                                   NamedSharding(mesh,
                                                 PS(("pod", "data"), None)))
            loss, grads, errors = jax.jit(vg)({"w": w}, batch, errors)
            out[f"vg{s}_loss"] = np.asarray(loss)
            out[f"vg{s}_grad"] = np.asarray(grads["w"])
            out[f"vg{s}_err"] = np.asarray(errors["w"])
    return out


def main(argv) -> int:
    section, path = argv
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{SECTION_DEVICES[section]}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    import jax
    import jax.numpy as jnp

    np.savez(path, **{"hlo": hlo, "parallel": parallel}[section](jax, jnp))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
