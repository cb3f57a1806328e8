"""Barotropic equations of state (``hydro/eos.f90``), PyTorch.

Port of ``ramses_tpu/hydro/eos.py``: ``barotropic_eos_temperature`` gives
T2 = T/mu [K] as a function of density [H/cc], selected by
``barotropic_eos_form`` (&COOLING_PARAMS, ``amr/amr_parameters.f90:
219-230``).  The cooling pass takes it as the polytrope temperature floor
(:func:`ramses_tpu_torch.hydro.cooling.cooling_step`).
"""

from __future__ import annotations

import torch


def barotropic_eos_temperature(nH, form: str, T2_eos: float,
                               polytrope_rho_cu: float,
                               polytrope_index: float):
    """T2(nH); ``polytrope_rho_cu`` is the break density in H/cc
    (``cooling_fine.f90:139``)."""
    x = nH / polytrope_rho_cu
    if form == "isothermal":
        return torch.full_like(nH, T2_eos)
    if form == "polytrope":
        return T2_eos * x ** (polytrope_index - 1.0)
    if form == "double_polytrope":
        return T2_eos * (1.0 + x ** (polytrope_index - 1.0))
    if form == "custom":
        # the untaken power-law branch is fed the break density, as the
        # JAX package does (its x -> 0 limit is unbounded for index < 1)
        lo = x < 1.0
        hi = T2_eos * torch.where(lo, torch.ones_like(x), x) \
            ** (polytrope_index - 1.0)
        return torch.where(lo, torch.full_like(x, T2_eos), hi)
    raise ValueError(f"unknown barotropic eos form {form!r}")
