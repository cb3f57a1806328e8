"""M1-closure radiative transfer (PyTorch), the port of ``ramses_tpu/rt``.

Photon density and flux per group advected with the M1 Eddington closure
at a reduced speed of light (:mod:`.m1`), coupled to non-equilibrium
H (and H/He) photochemistry with photoheating (:mod:`.chem`), on the
uniform grid (:mod:`.driver`, :mod:`.coupling`) and on the AMR hierarchy
(:mod:`.amr`).  One substep is two hand-written Hopper kernels on the
card: K8, the GLF transport (``csrc/rt_m1.cu``), and K9, the
photochemistry (``csrc/rt_chem.cu``).  The group properties
(:mod:`.spectra`) and the stellar SED tables (:mod:`.sed`) are host numpy.
"""
