"""Monte-Carlo gas tracers on the uniform grid (PyTorch).

Port of ``ramses_tpu/pm/tracers.py`` (``pm/move_tracer.f90`` /
``pm/tracer_utils.f90``, the Cadiou et al. flux-probability scheme): a
tracer in cell i jumps across face f with probability (outgoing mass
through f) / (cell gas mass), so the tracers follow the gas mass
distribution in expectation.  One categorical draw per tracer per step,
all on the device.

The JAX package draws with ``jax.random.categorical`` (Gumbel-max on the
log-probabilities); here the draw is an inverse-CDF lookup of one uniform
number per tracer from a ``torch.Generator``, the same distribution.  The
draws of the two packages differ, so the tests feed the same choices to
both (``choice=``).  As in the JAX package, the uniform driver does not
call this step: it is a library function beside
:func:`ramses_tpu_torch.grid.uniform.step_with_flux`, which yields its
fluxes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def jump_probs(x, rho_before, mass_fluxdt, shape: Tuple[int, ...],
               dx: float):
    """(cell [ntr, ndim] int64, full [ntr, 1 + 2·ndim]): each tracer's cell
    and its normalised probabilities of staying (column 0) or leaving
    through face −d (column 1 + 2d) or +d (column 2 + 2d)."""
    ndim = len(shape)
    sh = torch.as_tensor(shape, dtype=torch.int64, device=x.device)
    cell = torch.minimum(torch.clamp((x / dx).to(torch.int64), min=0),
                         sh - 1)
    idx = tuple(cell[:, d] for d in range(ndim))
    mcell = rho_before[idx]                       # mass/volume; flux is /dx
    probs = []
    for d in range(ndim):
        f_lo = mass_fluxdt[d][idx]
        hi = tuple((cell[:, dd] + (1 if dd == d else 0)) % shape[dd]
                   for dd in range(ndim))
        f_hi = mass_fluxdt[d][hi]
        probs.append(torch.clamp(-f_lo, min=0.0))     # leave through low
        probs.append(torch.clamp(f_hi, min=0.0))      # leave through high
    p = torch.stack(probs, dim=1) / torch.clamp(mcell, min=1e-300)[:, None]
    p = torch.clamp(p, 0.0, 1.0)
    stay = torch.clamp(1.0 - p.sum(dim=1), min=0.0)
    full = torch.cat([stay[:, None], p], dim=1)
    return cell, full / full.sum(dim=1, keepdim=True)


def mc_tracer_step(x, rho_before, mass_fluxdt, shape: Tuple[int, ...],
                   dx: float, generator: Optional[torch.Generator] = None,
                   choice: Optional[torch.Tensor] = None):
    """Move tracers for one hydro step.

    ``x`` [ntr, ndim] positions (user units), ``rho_before`` the gas
    density BEFORE the step, ``mass_fluxdt`` [ndim, *shape] the mass
    flux·dt/dx at each cell's LOW face (positive = flowing in +d, as
    :func:`ramses_tpu_torch.grid.uniform.step_with_flux` returns it).
    Each tracer's move is drawn from ``generator`` (one uniform number a
    tracer), or given as ``choice`` [ntr] (0 stay, 1 + 2d a −d move,
    2 + 2d a +d move).  Returns the new positions; a tracer keeps its
    offset inside the cell."""
    ndim = len(shape)
    cell, full = jump_probs(x, rho_before, mass_fluxdt, shape, dx)
    if choice is None:
        r = torch.rand(x.shape[0], generator=generator, dtype=full.dtype,
                       device=x.device)
        cdf = torch.cumsum(full, dim=1)
        choice = torch.clamp(torch.sum(cdf <= r[:, None], dim=1),
                             max=2 * ndim)
    sh = torch.as_tensor(shape, dtype=torch.int64, device=x.device)
    move = torch.stack([torch.where(choice == 1 + 2 * d, -1,
                                    torch.where(choice == 2 + 2 * d, 1, 0))
                        for d in range(ndim)], dim=1)
    newcell = torch.remainder(cell + move, sh)
    # keep the intra-cell offset so that tracers do not pile on centres
    frac = x / dx - cell
    return (newcell + frac) * dx
