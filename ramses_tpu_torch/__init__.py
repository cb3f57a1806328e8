"""ramses_tpu_torch — the PyTorch/CUDA port of ramses_tpu.

A second package beside the JAX reference ``ramses_tpu``, with the same
module layout and names.  Plain tensor code is PyTorch; each TPU kernel
of the JAX package becomes a kernel written by hand for Hopper under
``csrc/``, built with ``nvcc`` at first use (:mod:`ramses_tpu_torch.kernels`).
The port imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of ``ramses_tpu``.

Entry points (:class:`~ramses_tpu_torch.driver.Simulation`,
:class:`~ramses_tpu_torch.amr.hierarchy.AmrSim`,
:class:`~ramses_tpu_torch.mhd.driver.MhdSimulation`,
:func:`~ramses_tpu_torch.driver.run_namelist`, ``python -m
ramses_tpu_torch``) run on CUDA unless the caller asks for the CPU.  Each
driver writes and restores the reference-format ``output_NNNNN/``
snapshots (:mod:`ramses_tpu_torch.io`), and ``run_namelist`` and the CLI
run every namelist under the supervisor
(:mod:`ramses_tpu_torch.resilience`); the CLI writes the outputs and
guards each attempt.
"""

__version__ = "0.1.0"
