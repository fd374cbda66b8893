"""Misses of the serving plane's plan cache in the window
(``ServePlane.stats()["cache"]``, summed over buckets)."""


def read(run, scope):
    return run.readings.get("cache_misses")
