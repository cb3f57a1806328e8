"""ramses_tpu_torch — the PyTorch/CUDA port of ramses_tpu.

A second package beside the JAX reference ``ramses_tpu``, with the same
module layout and names.  Plain tensor code is PyTorch; each TPU kernel
of the JAX package becomes a kernel written by hand for Hopper under
``csrc/``, built with ``nvcc`` at first use (:mod:`ramses_tpu_torch.kernels`).
The port imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of ``ramses_tpu``.

Entry points (:class:`~ramses_tpu_torch.driver.Simulation`,
:func:`~ramses_tpu_torch.driver.run_namelist`, ``python -m
ramses_tpu_torch``) run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
