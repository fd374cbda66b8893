"""The 95th percentile (ms, numpy's linear interpolation) of the
``serve::queue`` spans: each dispatched request's wait inside its
``serve`` call, from the wave's start to its dispatch's packing."""
import numpy as np

from ._spans import duration_ms, spans


def read(run, scope):
    waits = [duration_ms(s) for s in spans("serve::queue")]
    return float(np.percentile(waits, 95)) if waits else None
