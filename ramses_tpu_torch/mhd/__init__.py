"""Ideal MHD with constrained transport (PyTorch).

Port of ``ramses_tpu/mhd``: cell-centred conservative state plus the
staggered face-centred field, HLLD/HLL/LLF/Roe interface solvers, the
Gardiner-Stone or 2D-Riemann corner EMF, and the uniform-grid CT step,
whose TPU kernel (``mhd/pallas_ct.py``) is the hand-written CUDA kernel
``csrc/mhd_ct.cu`` here (:mod:`ramses_tpu_torch.mhd.ct_slab`).
"""
