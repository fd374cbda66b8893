"""Collective bytes: from optimized HLO text (the twin of
``repro.launch.hlo_analysis``, a copy of its parser) and from a
``torch.profiler`` trace of the port's collectives.

HLO. ``compiled.cost_analysis()`` and a naive text scan both count a
while body ONCE (measured: a 10-iteration scan of matmuls reports 1
matmul of flops), so per-step collective bytes must be weighted by the
loop trip counts. XLA annotates scan-derived loops with
``known_trip_count`` in backend_config; we build the computation call
graph (while bodies/conditions, fusion `calls`, `to_apply`) and
propagate multipliers from ENTRY.

Trace. The port has no HLO: ``collective_bytes_traced`` reads the same
categories from the events a ``torch.profiler`` trace holds for each
collective a rank ran. Like the HLO count, a collective counts the bytes
of its result. Where the backend records ``record_param_comms`` events
(NCCL), each gives its collective's name, output element count and
dtype. Gloo records none; its ``gloo:<op>`` events give the tensors of
gloo's own operations, which size only an all-reduce (in place: its input
is its result). Gloo runs a reduce-scatter as all-reduces, and its
all-gather events name no group size, so a gloo trace holding any
collective but all-reduce raises ``ValueError`` rather than count another
quantity.
"""
from __future__ import annotations

import json
import math
import os
import re
import tempfile

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
    "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# NOTE: while-body params are tuple-typed (nested parens), so only anchor
# on "column-0 %name (" — never try to match the full signature.
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(")
_COLL_RE = re.compile(
    r"=\s*(\(?[a-z0-9]+\[[^=\n]*?)\s"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[-a-z0-9.]*\(")
_CALL_RE = re.compile(r"(?:body|calls|to_apply|condition)=%?([\w.\-]+)")
_TRIP_RE = re.compile(r"known_trip_count\W+n\W+(\d+)")


def shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_computations(hlo: str) -> dict[str, str]:
    """computation name -> body text.

    Line-based: the HLO pretty-printer opens a computation with a def line
    at column 0 and closes it with a lone '}' at column 0 (brace counting
    is unreliable — layouts/backend_configs contain braces)."""
    comps: dict[str, str] = {}
    cur: str | None = None
    buf: list[str] = []
    for line in hlo.split("\n"):
        if cur is None:
            m = _COMP_RE.match(line)
            if m and line.rstrip().endswith("{"):
                cur = m.group(1)
                buf = [line]
        else:
            if line.startswith("}"):
                comps[cur] = "\n".join(buf)
                cur = None
                buf = []
            else:
                buf.append(line)
    if cur is not None:
        comps[cur] = "\n".join(buf)
    return comps


def collective_bytes_weighted(hlo: str) -> dict:
    """Collective bytes per category, weighted by loop trip counts."""
    comps = _split_computations(hlo)
    entry = None
    for line in hlo.split("\n"):
        if line.startswith("ENTRY"):
            m = _COMP_RE.match(line)
            if m:
                entry = m.group(1)
    if entry is None or entry not in comps:
        entry = max(comps, key=lambda k: len(comps[k])) if comps else None
    out: dict[str, float] = {}
    if entry is None:
        return {"total": 0.0}

    seen: set[tuple[str, int]] = set()

    def visit(name: str, mult: int):
        if (name, mult) in seen or name not in comps or mult <= 0:
            return
        seen.add((name, mult))
        body = comps[name]
        for m in _COLL_RE.finditer(body):
            kind = m.group(2)
            out[kind] = out.get(kind, 0.0) + mult * shape_bytes(m.group(1))
        for line in body.split("\n"):
            if " while(" in line:
                trip = 1
                tm = _TRIP_RE.search(line)
                if tm:
                    trip = int(tm.group(1))
                for cm in _CALL_RE.finditer(line):
                    # condition runs trip+1 times but holds no collectives
                    visit(cm.group(1), mult * trip)
            else:
                for cm in _CALL_RE.finditer(line):
                    visit(cm.group(1), mult)

    visit(entry, 1)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# torch.profiler's dtype names: ScalarType names in record_param_comms,
# C++ type names in a gloo event's "Input type"
_TORCH_DTYPE_BYTES = {
    "Bool": 1, "Byte": 1, "Char": 1, "Short": 2, "Int": 4, "Long": 8,
    "Half": 2, "BFloat16": 2, "Float": 4, "Double": 8,
    "ComplexFloat": 8, "ComplexDouble": 16,
    "Float8_e4m3fn": 1, "Float8_e5m2": 1,
    "bool": 1, "unsigned char": 1, "signed char": 1, "short int": 2,
    "int": 4, "long int": 8, "c10::Half": 2, "c10::BFloat16": 2,
    "float": 4, "double": 8, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}
# record_param_comms "Collective name"s -> the HLO categories
_TRACE_KINDS = (
    ("reduce_scatter", "reduce-scatter"),
    ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
    ("allgather", "all-gather"), ("all_gather", "all-gather"),
    ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
    ("recv", "collective-permute"),
)


# the collectives a gloo trace does not size: their events (``gloo:<op>``,
# ``c10d::<op>``, ``_c10d_functional::<op>``) name one of these
_GLOO_UNSIZED = ("gather", "scatter", "all_to_all", "alltoall", "send",
                 "recv")


def _trace_kind(name: str) -> str | None:
    for key, kind in _TRACE_KINDS:
        if key in name:
            return kind
    return None


def _trace_events(prof) -> list:
    """The events of a profiler (exported to a temporary chrome trace) or
    of a chrome-trace dict."""
    if isinstance(prof, dict):
        return prof.get("traceEvents", [])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def collective_bytes_traced(prof) -> dict:
    """Collective bytes per category from a ``torch.profiler`` trace
    (``record_shapes=True``): the profiler itself or its chrome-trace
    dict. Same keys as ``collective_bytes_weighted``: the categories
    seen and ``total``. A gloo trace holding a collective other than
    all-reduce raises ``ValueError``."""
    events = [e for e in _trace_events(prof) if e.get("ph") == "X"]
    comms = [e for e in events if e.get("name") == "record_param_comms"]
    out: dict[str, float] = {}
    if comms:
        for e in comms:
            a = e.get("args", {})
            kind = _trace_kind(str(a.get("Collective name", "")))
            if kind is None:
                continue
            n = int(a.get("Out msg nelems", 0))
            out[kind] = out.get(kind, 0.0) + n * _TORCH_DTYPE_BYTES.get(
                str(a.get("dtype")), 0)
    else:
        for e in events:
            name = e.get("name", "")
            if not (name.startswith("gloo:") or "c10d" in name):
                continue
            if any(k in name for k in _GLOO_UNSIZED):
                raise ValueError(
                    f"collective_bytes_traced: a gloo trace does not size "
                    f"the result of {name!r} (only all-reduce)")
            if not name.startswith("gloo:all_reduce"):
                continue
            a = e.get("args", {})
            for dims, ty in zip(a.get("Input Dims", []),
                                a.get("Input type", [])):
                out["all-reduce"] = out.get("all-reduce", 0.0) + \
                    math.prod(dims) * _TORCH_DTYPE_BYTES.get(ty, 0)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out
