"""Compiled programs: each solver entry point at each problem shape,
captured as a CUDA graph on the card.

The reference jit-compiles six programs per solver (``apply``,
``apply_batched``, their health twins, ``refresh`` and ``apply_plan``);
the port's counterpart is a ``Program``: one entry point of one solver
at one key ``(entry, B, dtype, device)``. The solver holds every device
constant the pipeline reads (the leaf layout, the tree's split tables,
the M2L matrix; ``FmmSolver._prepare``), so no cache miss can copy from
the host inside a capture.

On a CUDA device

  1. the first call at a key runs the pipeline eagerly and returns its
     result: a shape seen once costs what the eager pipeline costs, and
     the run builds the kernels and lets every library set itself up
     outside a capture (the warm-up);
  2. the second call copies its inputs into static buffers of the
     program, captures the pipeline into a ``torch.cuda.CUDAGraph`` in
     the solver's private memory pool, on the solver's stream, and
     replays it;
  3. every later call copies its inputs into the static buffers (device
     to device) and replays.

A program may hold its leading arguments (``held``; ``apply_charges``
holds its plan, less its charges): it binds them by identity, so that a
call whose held arguments are the very tensors of the last bind copies
only the rest, and one with others (of the same shapes) binds them
anew, copying them once. Binding by identity means that writes into a
bound plan's tensors after the bind are not seen by a replay;
``refresh`` returns fresh tensors, so the normal path never makes such
writes.

A call that replays returns fresh tensors cloned from the static
outputs: nothing returned aliases a graph buffer, and the next replay
cannot overwrite it. The programs of one solver share its pool; their
replays are serialised on its stream and every output is cloned before
the next replay, so no program reads memory another one wrote. A capture
or replay error is raised as it comes: there is no return to eager
dispatch.

On the CPU a program runs the pipeline eagerly on every call: there is
no graph, but it counts the same way.

Memory. A graph pool holds every intermediate of its programs for as
long as they live. The bytes each capture adds to the pools
(``memory_reserved`` across the capture) are charged to the solver's
``ProgramSet``; when the sets of one device hold more than its budget
(``program_budget``: ``BUDGET_FRACTION`` of the card unless
``set_program_budget`` says otherwise), the least recently run sets are
released until the rest fit. A released solver stays usable: its next
call at a shape runs eagerly and the one after captures again. The set
that just captured is never released to make room for itself.

Counting, all of it measured where a kernel wrapper runs:
``Program.launches`` holds the host launches of the first, eager run
(``kernels.launch_counts()``), ``Program.recorded`` those recorded into
the graph at its capture (``kernels.build.recorded_counts()``; empty on
the CPU), ``Program.calls`` the calls and ``Program.replays`` the graph
replays. A replay makes no host launch.

Tracing (``repro_torch.trace``): an eager run is the span
``program::eager`` and a capture ``program::capture``, each tagged with
the entry point's name and, for a program of K densities on one geometry
(``apply_charges``), carrying K (``Span.densities``); the counters
``program.eager``, ``program.capture`` and ``program.replay`` count them
across every program of the process, released ones included, and
``program.plan_bind`` counts the binds of held arguments (eager, capture
or replay); a replay's copy of newly bound arguments is the span
``program::bind``, tagged and carrying K alike. A capture
keeps the pipeline's phase marks with an end mark after it, and each
replay records a timing event before the graph's launch, so
``repro_torch.trace.snapshot()["phases"][entry]`` holds the device time
of each phase of every replay and the launch gap before it (the
benchmark's ``*_ms`` per-layer metrics read them).
"""
from __future__ import annotations

import gc
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch

from .. import trace
from ..errors import ShapeError
from ..kernels.build import launch_counts, recorded_counts

#: Share of a card's memory that the graph pools of all programs on it
#: may hold before the least recently run solvers' programs are released.
BUDGET_FRACTION = 0.25

_BUDGET: dict = {}                     # device -> bytes, set by the caller
# ProgramSets that hold a graph pool, least recently run first
_POOLED: "OrderedDict[int, weakref.ref]" = OrderedDict()
_RELEASED = {"sets": 0, "bytes": 0}


def set_program_budget(nbytes: Optional[int], device=None) -> None:
    """Let the programs on ``device`` (default: the current CUDA device)
    hold ``nbytes`` in their graph pools; ``None`` restores the default
    share of the card."""
    dev = _device(device)
    if nbytes is None:
        _BUDGET.pop(dev, None)
    else:
        _BUDGET[dev] = int(nbytes)


def program_budget(device=None) -> int:
    """The bytes the programs on ``device`` may hold in graph pools."""
    dev = _device(device)
    if dev in _BUDGET:
        return _BUDGET[dev]
    if dev.type != "cuda":
        return 0
    return int(BUDGET_FRACTION
               * torch.cuda.get_device_properties(dev).total_memory)


def program_memory(device=None) -> dict:
    """The budget of ``device``, the pool bytes its solvers' programs
    hold now (as charged at their captures), how many solvers hold any,
    and the solvers and bytes the budget has released so far (all
    devices)."""
    dev = _device(device)
    sets = [s for s in _live() if s.device == dev]
    return {"budget": program_budget(dev),
            "held": sum(s.bytes for s in sets), "solvers": len(sets),
            "released_sets": _RELEASED["sets"],
            "released_bytes": _RELEASED["bytes"]}


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _live() -> list:
    """The ProgramSets holding a pool, least recently run first."""
    out = []
    for key, ref in list(_POOLED.items()):
        s = ref()
        if s is None:
            del _POOLED[key]
        else:
            out.append(s)
    return out


def _leaves(obj) -> list:
    """The tensors of a nest of tuples (NamedTuples included), in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    return []


def _map(fn, obj):
    """``obj`` with ``fn`` applied to each of its tensors."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(fn, o) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, o) for o in obj)
    return obj


def _signature(args) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(args))


def _copy(pairs) -> None:
    for dst, src in pairs:
        if dst is not src:
            dst.copy_(src)


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


class Program:
    """One entry point of one solver at one key (module docstring).
    ``fn(*args)`` is the pipeline; ``owner`` is the solver's
    ``ProgramSet`` (its pool and stream on the card), held weakly so
    that no reference cycle keeps a released graph alive until a
    garbage collection; ``held`` the leading arguments bound by
    identity; ``densities`` the K its spans carry (None: not a
    densities program)."""

    def __init__(self, key: tuple, fn: Callable, args: tuple,
                 owner: "ProgramSet", held: int = 0,
                 densities: Optional[int] = None):
        self.key = key
        self.densities = densities
        self.launches: dict[str, int] = {}
        self.recorded: dict[str, int] = {}
        self.calls = 0
        self.replays = 0
        self._fn = fn
        self._owner = weakref.ref(owner)
        self._signature = _signature(args)
        self._graph = None
        self._marks: Optional[trace.Marks] = None
        self._held = len(_leaves(args[:held]))
        self._bound: list = []          # weak references to held tensors

    @property
    def entry(self) -> str:
        return self.key[0]

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *args):
        if _signature(args) != self._signature:
            raise ShapeError(
                f"{self.entry}: inputs of shapes {_signature(args)} do not "
                f"match this program's {self._signature}")
        bind = self._bind(args)
        if self._graph is not None:
            out = self._replay(args, bind)
        elif self.calls == 0 or self.key[-1].type != "cuda":
            before = launch_counts()
            trace.count("program.eager")
            with trace.span("program::eager", tag=self.entry,
                            densities=self.densities):
                out = self._fn(*args)
            if self.calls == 0:
                self.launches = _diff(launch_counts(), before)
        else:
            trace.count("program.capture")
            with trace.span("program::capture", tag=self.entry,
                            densities=self.densities):
                self._capture(args)
            out = self._replay(args, False)
        self.calls += 1
        return out

    def _bind(self, args: tuple) -> bool:
        """Whether the held arguments of this call are other tensors than
        the last bind's: then they are bound (and counted)."""
        if not self._held:
            return False
        held = _leaves(args)[:self._held]
        if len(self._bound) == len(held) and all(
                ref() is t for ref, t in zip(self._bound, held)):
            return False
        self._bound = [weakref.ref(t) for t in held]
        trace.count("program.plan_bind")
        return True

    def _capture(self, args: tuple) -> None:
        owner = self._owner()
        pool, stream = owner.pool_and_stream(self.key[-1])
        caller = torch.cuda.current_stream(stream.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            static_in = _map(torch.clone, args)
        graph = torch.cuda.CUDAGraph()
        before = recorded_counts()
        # A garbage collection inside the capture could destroy another
        # graph (one held in a reference cycle elsewhere), and destroying
        # a graph while a stream captures invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream), \
                    trace.marking() as marking:
                reserved = torch.cuda.memory_reserved(stream.device)
                static_out = self._fn(*static_in)
                marks = marking.close(self.entry)
                grown = torch.cuda.memory_reserved(stream.device) - reserved
        finally:
            if collecting:
                gc.enable()
        self.recorded = _diff(recorded_counts(), before)
        self._graph, self._marks = graph, marks
        self._static_in, self._static_out = static_in, static_out
        owner.charge(grown)

    def _replay(self, args: tuple, bind: bool):
        """Copy the inputs into the static buffers (the held ones only
        when ``bind``) and replay the graph."""
        owner = self._owner()
        stream = owner.stream
        caller = torch.cuda.current_stream(stream.device)
        stream.wait_stream(caller)
        pairs = list(zip(_leaves(self._static_in), _leaves(args)))
        with torch.cuda.stream(stream):
            if bind:
                with trace.span("program::bind", tag=self.entry,
                                densities=self.densities):
                    _copy(pairs[:self._held])
            _copy(pairs[self._held:])
            self._marks.before_replay(stream)
            self._graph.replay()
            out = _map(torch.clone, self._static_out)
        caller.wait_stream(stream)
        for t in _leaves(out):
            t.record_stream(caller)
        self.replays += 1
        trace.count("program.replay")
        owner.touch()
        return out


class ProgramSet:
    """The programs of one solver by key, and (on the card) the private
    graph pool and stream they share and the pool bytes charged to them.
    ``copy.copy`` of a solver shares its set, as the reference's copy
    shares its jitted functions."""

    def __init__(self):
        self._programs: dict[tuple, Program] = {}
        self.pool = self.stream = self.device = None
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._programs)

    def items(self) -> dict:
        """A snapshot of the programs by key."""
        return dict(self._programs)

    def program(self, key: tuple, fn: Callable, args: tuple,
                held: int = 0, densities: Optional[int] = None) -> Program:
        """The program of ``key``, made from a first call's ``args`` if
        there is none (``fn()`` makes its pipeline; it holds the first
        ``held`` arguments; its spans carry ``densities``)."""
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = Program(key, fn(), args, self,
                                                    held, densities)
        return program

    def pool_and_stream(self, device: torch.device) -> tuple:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
            self.device = _device(device)
        return self.pool, self.stream

    def touch(self) -> None:
        """Mark this set the most recently run of its device."""
        if id(self) in _POOLED:
            _POOLED.move_to_end(id(self))

    def charge(self, nbytes: int) -> None:
        """Add a capture's pool growth to this set, then release the least
        recently run other sets of its device until the device's sets fit
        its budget."""
        self.bytes += max(int(nbytes), 0)
        _POOLED[id(self)] = weakref.ref(self)
        self.touch()
        budget = program_budget(self.device)
        sets = [s for s in _live() if s.device == self.device]
        held = sum(s.bytes for s in sets)
        for s in sets:
            if held <= budget:
                break
            if s is not self:
                held -= s.bytes
                _RELEASED["sets"] += 1
                _RELEASED["bytes"] += s.bytes
                s.release()

    def release(self) -> None:
        """Drop every program: graphs, static buffers and the pool (it is
        freed when the last graph made in it goes). The phase marks of
        each program's last replay are read first."""
        for program in self._programs.values():
            if program._marks is not None:
                program._marks.read()
        self._programs.clear()
        _POOLED.pop(id(self), None)
        self.pool = self.stream = self.device = None
        self.bytes = 0
