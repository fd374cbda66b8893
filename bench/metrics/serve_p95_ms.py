"""The 95th percentile (ms), over every request due in the window, of its
completion time minus its due time (numpy's linear interpolation); a
request not answered as it should be counts as infinitely late."""
import numpy as np


def read(run, scope):
    lat = run.readings.get("latency_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
