"""repro_torch: the adaptive FMM of "Adaptive fast multipole methods on
the GPU" (Goude & Engblom, 2012) in PyTorch, with its hot kernels written
by hand in CUDA C++ for the NVIDIA H100 (``sm_90a``).

The package mirrors the layout of the JAX reference package ``repro``
module for module, so every file here has a twin there. It imports
neither JAX nor ``repro``.

    from repro_torch.configs import fmm_config
    from repro_torch.solver import FmmSolver
    solver = FmmSolver.build(fmm_config(1 << 20))     # device="cuda"
    phi = solver.apply(z, q)
"""

__version__ = "0.1.0"
