"""The bytes the port's compiled programs held in their CUDA-graph pools
when the window closed (``repro_torch.solver.program_memory()["held"]``,
as charged at their captures; GiB)."""


def read(run, scope):
    held = run.readings.get("program_pool_bytes")
    return None if held is None else held / 2 ** 30
