"""Seconds from the start of the process to the start of the window:
loading, building the kernels (on a checkout's first run), making the
inputs and warming every shape the cell uses."""


def read(run, scope):
    return run.setup_seconds
