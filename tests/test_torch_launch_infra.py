"""The port's launch layer against the JAX reference's: collective bytes
from HLO text (``repro_torch.launch.hlo_analysis``, its own copy of the
parser) and from a profiler trace, the sharding rules, the mesh entry
points, and the public names of every module of the multi-device
substrate."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.launch as ref_launch
from repro.launch import hlo_analysis as ref_hlo
from repro.parallel.sharding import Rules as RefRules, dp_axes as ref_dp_axes

import repro_torch.launch as port_launch
from repro_torch.errors import MeshError
from repro_torch.launch import hlo_analysis as port_hlo
from repro_torch.launch import make_production_mesh, make_test_mesh
from repro_torch.parallel.sharding import Rules, dp_axes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "tests")

# the reference test's loop-weighted HLO (tests/test_launch_infra.py)
LOOP_HLO = """
%body.1 (p: (s32[], f32[64])) -> (s32[], f32[64]) {
  %p = (s32[], f32[64]) parameter(0)
  %ar = f32[64]{0} all-reduce(%x), to_apply=%add.1
}

%cond.1 (p: (s32[], f32[64])) -> pred[] {
  %p = (s32[], f32[64]) parameter(0)
}

ENTRY %main (a: f32[64]) -> f32[64] {
  %ag = f32[128]{0} all-gather(%a), dimensions={0}
  %w = (s32[], f32[64]) while(%t), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"n":"10"}}
}
"""
# nested loops, a fusion call and every collective kind
NESTED_HLO = """
%inner (p: (s32[], bf16[8,8])) -> (s32[], bf16[8,8]) {
  %rs = bf16[2,8]{1,0} reduce-scatter(%x), dimensions={0}, to_apply=%add
  %cp = s8[16]{0} collective-permute(%y), source_target_pairs={{0,1}}
}

%outer (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %a2a = (f32[4]{0}, f32[4]{0}) all-to-all(%u, %v), dimensions={0}
  %w2 = (s32[], bf16[8,8]) while(%t), condition=%c2, body=%inner, backend_config={"known_trip_count":{"n":"3"}}
}

%fused (x: f32[32]) -> f32[32] {
  %ar2 = f32[32]{0} all-reduce-start(%x), to_apply=%add
}

ENTRY %main (a: f32[64]) -> f32[64] {
  %w = (s32[], f32[4]) while(%t), condition=%c1, body=%outer, backend_config={"known_trip_count":{"n":"5"}}
  %f = f32[32]{0} fusion(%a), kind=kLoop, calls=%fused
}
"""


@pytest.mark.parametrize("s", [
    "f32[128,256]", "bf16[8,8]{1,0}", "(f32[4], s8[16])", "pred[]",
    "(s32[], f64[3,5]{1,0}, c64[2])", "token[]", "u4[7]", "f8e4m3fn[2,2]"])
def test_shape_bytes_matches_reference(s):
    assert port_hlo.shape_bytes(s) == ref_hlo.shape_bytes(s)


@pytest.mark.parametrize("hlo", [LOOP_HLO, NESTED_HLO, "", "garbage\n}\n"])
def test_collective_weighting_matches_reference(hlo):
    assert port_hlo._split_computations(hlo) == \
        ref_hlo._split_computations(hlo)
    assert port_hlo.collective_bytes_weighted(hlo) == \
        ref_hlo.collective_bytes_weighted(hlo)


def test_collective_weighting_by_trip_count():
    out = port_hlo.collective_bytes_weighted(LOOP_HLO)
    assert out["all-gather"] == 128 * 4
    assert out["all-reduce"] == 10 * 64 * 4
    assert set(port_hlo._split_computations(LOOP_HLO)) == \
        {"body.1", "cond.1", "main"}


@pytest.fixture(scope="module")
def compiled_hlo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hlo") / "hlo.npz")
    r = subprocess.run([sys.executable, os.path.join(HERE, "_parallel_ref.py"),
                        "hlo", path], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: str(z[k]) for k in z.files}


def test_compiled_hlo_of_ef_allreduce(compiled_hlo):
    """The reference's ``ef_allreduce`` of 2^20 f32 elements under
    shard_map over 2 devices, optimized by XLA: the int32 codes and the
    f32 scale put 4,194,308 bytes on the wire against a plain pmean's
    4,194,304 — both parsers read the same."""
    n = 1 << 20
    for key, want in (("hlo_ef", 4 * n + 4), ("hlo_pmean", 4 * n)):
        got = port_hlo.collective_bytes_weighted(compiled_hlo[key])
        assert got == ref_hlo.collective_bytes_weighted(compiled_hlo[key])
        assert got == {"all-reduce": want, "total": want}


def _x(name, **args):
    return {"ph": "X", "name": name, "args": args}


@pytest.mark.parametrize("events,want", [
    # NCCL: record_param_comms carries the result's element count
    ([_x("record_param_comms", **{"Collective name": "allreduce",
                                  "dtype": "Int", "Out msg nelems": 1 << 20}),
      _x("record_param_comms", **{"Collective name": "allreduce",
                                  "dtype": "Float", "Out msg nelems": 1}),
      _x("nccl:all_reduce", **{"Input type": ["int"],
                               "Input Dims": [[1 << 20]]}),
      _x("record_param_comms", **{"Collective name": "_allgather_base",
                                  "dtype": "BFloat16", "Out msg nelems": 64}),
      _x("record_param_comms", **{"Collective name": "barrier",
                                  "dtype": "Float", "Out msg nelems": 1})],
     {"all-reduce": 4 * (1 << 20) + 4, "all-gather": 128}),
    # gloo: no record_param_comms; its all-reduce events' inputs (in place:
    # the result)
    ([_x("gloo:all_reduce", **{"Input type": ["int"],
                               "Input Dims": [[1024]]}),
      _x("gloo:all_reduce"),
      _x("gloo:all_reduce", **{"Input type": ["double"],
                               "Input Dims": [[3, 4]]}),
      _x("gloo:broadcast", **{"Input type": ["float"], "Input Dims": [[9]]}),
      _x("gloo:barrier"),
      _x("c10d::allreduce_", **{"Input type": ["TensorList"],
                                "Input Dims": [[[1024]]]})],
     {"all-reduce": 4096 + 96}),
    ([], {}),
])
def test_collective_bytes_traced(events, want):
    want = dict(want, total=sum(want.values()))
    assert port_hlo.collective_bytes_traced({"traceEvents": events}) == want


@pytest.mark.parametrize("name", [
    "gloo:all_gather", "c10d::_allgather_base_", "c10d::allgather_",
    "_c10d_functional::all_gather_into_tensor", "c10d::reduce_scatter_",
    "c10d::_reduce_scatter_base_", "gloo:all_to_all", "gloo:recv",
    "gloo:send"])
def test_collective_bytes_traced_refuses_what_gloo_does_not_size(name):
    """A gloo trace sizes only all-reduce: its all-gather events name no
    group size and it runs a reduce-scatter as all-reduces, so a trace
    holding another collective raises instead of counting its input."""
    events = [_x("gloo:all_reduce", **{"Input type": ["float"],
                                       "Input Dims": [[40]]}),
              _x(name, **{"Input type": ["float"], "Input Dims": [[10]]})]
    with pytest.raises(ValueError, match="does not size"):
        port_hlo.collective_bytes_traced({"traceEvents": events})


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_field_for_field(multi_pod, fsdp):
    ref, port = RefRules(multi_pod, fsdp), Rules(multi_pod, fsdp)
    assert port.table() == ref.table()
    assert tuple(port.batch()) == tuple(ref.batch())
    for rest in ((), ("model",), (None, "model"), (("data", "model"),)):
        assert tuple(port.act(*rest)) == tuple(ref.act(*rest))
    assert dp_axes(multi_pod) == ref_dp_axes(multi_pod)


def test_launch_exports_match_reference():
    assert set(port_launch.__all__) == set(ref_launch.__all__)


def test_mesh_needs_a_process_group():
    """Outside an initialised process group no mesh is made (a typed
    error that is also the reference's ``ValueError``)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    for make in (lambda: make_test_mesh(device_type="cpu"),
                 lambda: make_production_mesh(multi_pod=True,
                                              device_type="cpu")):
        with pytest.raises(MeshError, match="process group"):
            make()
    assert issubclass(MeshError, ValueError)


def _public(path) -> set:
    tree = ast.parse(open(path).read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("module,by_design", [
    ("parallel/sharding.py", set()),
    # one process a rank: no shard_map to wrap
    ("parallel/compression.py", {"_shard_map"}),
    ("launch/mesh.py", set()),
    ("launch/hlo_analysis.py", set()),
    ("launch/runtime.py", set()),
    ("checkpoint/checkpoint.py", set()),
])
def test_every_reference_def_has_a_twin(module, by_design):
    ref = _public(os.path.join(ROOT, "src", "repro", module))
    port = _public(os.path.join(ROOT, "src", "repro_torch", module))
    assert ref - port == by_design
