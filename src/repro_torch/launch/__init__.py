"""Deployment runtime: ``StragglerMonitor`` (also the serving plane's
slow-dispatch detector, ``repro_torch.serve.plane``), ``FailureInjector``
and the fault-tolerant step loop ``train_loop``."""
from .runtime import FailureInjector, StragglerMonitor, train_loop

__all__ = ["FailureInjector", "StragglerMonitor", "train_loop"]
