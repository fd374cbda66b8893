"""The most device memory the process reserved over the whole run, set-up
included (``torch.cuda.max_memory_reserved``, GiB), read when the window
closed."""


def read(run, scope):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
