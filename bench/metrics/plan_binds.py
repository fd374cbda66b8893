"""How many times a program bound a plan in the window (the rise of the
port's counter ``program.plan_bind``): 0 when every call evaluated the
plan its program already held."""


def read(run, scope):
    return run.readings.get("plan_binds")
