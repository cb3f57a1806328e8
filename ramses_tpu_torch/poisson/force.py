"""Gravitational acceleration from the potential (PyTorch).

Port of ``ramses_tpu/poisson/force.py``.  ``force_fine → gradient_phi``
(``poisson/force_fine.f90:5,199``): the reference uses a 5-point,
4th-order finite-difference gradient with coefficients a=0.5*4/3/dx,
b=0.25*1/3/dx — i.e.
``dphi/dx = [8(phi_{+1}-phi_{-1}) - (phi_{+2}-phi_{-2})] / (12 dx)`` —
and f = -grad(phi).
"""

from __future__ import annotations

import torch


def gradient_phi(phi, dx: float):
    """4th-order central gradient, periodic wrap.  Returns [ndim, *sp]."""
    a = 2.0 / (3.0 * dx)
    b = 1.0 / (12.0 * dx)
    comps = []
    for ax in range(phi.dim()):
        d1 = torch.roll(phi, -1, ax) - torch.roll(phi, 1, ax)
        d2 = torch.roll(phi, -2, ax) - torch.roll(phi, 2, ax)
        comps.append(a * d1 - b * d2)
    return torch.stack(comps)


def force(phi, dx: float):
    """f = -grad(phi), shape [ndim, *spatial]."""
    return -gradient_phi(phi, dx)
