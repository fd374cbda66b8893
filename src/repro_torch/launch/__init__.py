"""Deployment runtime: mesh definitions (``mesh``), ``StragglerMonitor``
(also the serving plane's slow-dispatch detector,
``repro_torch.serve.plane``), ``FailureInjector``, the fault-tolerant step
loop ``train_loop``, and collective accounting (``hlo_analysis``)."""
from .mesh import make_production_mesh, make_test_mesh, mesh_info
from .runtime import FailureInjector, StragglerMonitor, train_loop

__all__ = ["make_production_mesh", "make_test_mesh", "mesh_info",
           "FailureInjector", "StragglerMonitor", "train_loop"]
