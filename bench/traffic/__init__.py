"""Traffic drivers, one module a driver, found by the ``traffic`` name of a
cell file (``bench/workloads/<cell>.json``). Each defines ``Driver``."""
