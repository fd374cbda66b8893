"""The port's program calls that did not replay a graph over the whole
run, set-up included: eager first calls and captures (the counters
``program.eager`` + ``program.capture`` of ``repro_torch.trace``)."""
from ._spans import snapshot


def read(run, scope):
    snap = snapshot()
    if snap is None:
        return None
    counters = snap["counters"]
    if "program.eager" not in counters and "program.capture" not in counters:
        return None
    return counters.get("program.eager", 0) + counters.get("program.capture",
                                                           0)
