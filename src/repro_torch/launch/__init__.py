"""Deployment runtime. Ported so far: ``StragglerMonitor``, the serving
plane's slow-dispatch detector (``repro_torch.serve.plane``)."""
from .runtime import StragglerMonitor

__all__ = ["StragglerMonitor"]
