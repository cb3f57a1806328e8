"""Gravity: Poisson solvers, force computation, analytic fields (PyTorch).

Port of ``ramses_tpu/poisson/``: dense whole-grid multigrid, CG and the
periodic FFT solve on the uniform grid, the isolated (multipole-Dirichlet)
solve for open boxes, and the per-level solve of the AMR hierarchy.
"""
