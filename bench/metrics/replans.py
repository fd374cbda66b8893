"""Re-plans of the guard in the window (``GuardReport.retries`` summed
over every half-step)."""


def read(run, scope):
    return run.readings.get("replans")
