"""Isolated-boundary Poisson solve: multipole Dirichlet + dense CG
(PyTorch).

Port of ``ramses_tpu/poisson/isolated.py``.  Reference:
``pm/rho_fine.f90:666`` (multipole_fine — mass moments of the density) +
``poisson/boundary_potential.f90:5-341`` (phi_boundary: the ghost
potential on non-periodic faces from the multipole expansion), then the
usual interior solve.  Here the expansion is monopole + quadrupole about
the centre of mass (the dipole vanishes there), the ghost layer enters the
right-hand side of a zero-Dirichlet 7-point Laplacian (SPD), and a
fixed-iteration CG solves it, converged iterations frozen on the device.

Sign convention matches the rest of the package: ``Lap(phi) = coeff*rho``
with attractive force ``f = -grad phi``; a positive mass produces
``phi < 0`` wells via the Green's function ``phi = -coeff M / (4 pi r)``
(3D).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ramses_tpu_torch.poisson.solver import frozen_cg


def _shift0(a, s: int, ax: int):
    """Shift with zero fill (Dirichlet-0 ghost)."""
    z = torch.zeros_like(a)
    src = [slice(None)] * a.dim()
    dst = [slice(None)] * a.dim()
    if s == 1:
        src[ax], dst[ax] = slice(0, -1), slice(1, None)
    else:
        src[ax], dst[ax] = slice(1, None), slice(0, -1)
    z[tuple(dst)] = a[tuple(src)]
    return z


def lap_dirichlet0(phi, dx: float):
    """7-point Laplacian with zero Dirichlet ghosts (SPD operator)."""
    nd = phi.dim()
    out = -2.0 * nd * phi
    for ax in range(nd):
        out = out + _shift0(phi, 1, ax) + _shift0(phi, -1, ax)
    return out / (dx * dx)


def _axes(shape, dx: float, dtype, device):
    return [(torch.arange(n, dtype=dtype, device=device) + 0.5) * dx
            for n in shape]


def multipole_moments(rho, dx: float):
    """(M, com, Q) — total mass, centre of mass, and (3D) the symmetric
    quadrupole tensor about it (``multipole_fine``; 6 unique components,
    Q_ij = Σ ρ (3 x_i x_j − |x|² δ_ij) dV).  One set of whole-grid
    reductions, shared by every boundary-face evaluation."""
    nd = rho.dim()
    vol = dx ** nd
    grids = torch.meshgrid(*_axes(rho.shape, dx, rho.dtype, rho.device),
                           indexing="ij")
    M = torch.sum(rho) * vol
    Msafe = torch.where(torch.abs(M) > 1e-300, M, 1.0)
    com = torch.stack([torch.sum(rho * g) * vol / Msafe for g in grids])
    Q = None
    if nd == 3:
        rel = [g - com[d] for d, g in enumerate(grids)]
        x2 = sum(x * x for x in rel)
        q = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(i, 3):
                qij = torch.sum(rho * (3.0 * rel[i] * rel[j]
                                       - (x2 if i == j else 0.0))) * vol
                q[i][j] = q[j][i] = qij
        Q = torch.stack([torch.stack(row) for row in q])
    return M, com, Q


def multipole_phi(rho, dx: float, coeff, points, moments=None):
    """Multipole potential at ``points`` [n, ndim] (box coordinates).

    Monopole + quadrupole about the centre of mass (the dipole is zero
    there) — ``boundary_potential.f90`` keeps the same orders.  3D uses
    the 1/r kernel, 2D the log kernel.  Pass precomputed ``moments``
    to amortize the grid reductions over many evaluation batches.
    """
    nd = rho.dim()
    M, com, Q = (multipole_moments(rho, dx) if moments is None
                 else moments)
    r = points - com[None, :]                       # [n, ndim]
    r2 = torch.clamp((r ** 2).sum(dim=1), min=(0.5 * dx) ** 2)
    if nd == 3:
        quad = torch.einsum("ni,ij,nj->n", r, Q, r)
        rr = torch.sqrt(r2)
        return -coeff / (4.0 * math.pi) * (M / rr + 0.5 * quad / rr ** 5)
    if nd == 2:
        return coeff / (2.0 * math.pi) * 0.5 * M * torch.log(r2)
    # 1D: |x| kernel (phi'' = coeff*rho → phi = coeff*M*|x|/2)
    return coeff * 0.5 * M * torch.sqrt(r2)


def _face_points(shape: Tuple[int, ...], dx: float, d: int, side: int,
                 dtype, device="cpu"):
    """Ghost-cell centre coordinates of one face, flat [nface, ndim]."""
    axes = []
    for dd in range(len(shape)):
        if dd == d:
            x = torch.full((1,), -0.5 * dx if side == 0
                           else (shape[d] + 0.5) * dx, dtype=dtype,
                           device=device)
        else:
            x = (torch.arange(shape[dd], dtype=dtype, device=device)
                 + 0.5) * dx
        axes.append(x)
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=1)


def isolated_solve(rho, dx: float, coeff, iters: int = 300,
                   tol: float = 1e-6, phi0=None):
    """Solve ``Lap(phi) = coeff*rho`` with open (isolated) boundaries.

    Returns (phi, ghost_faces) where ``ghost_faces[d][side]`` is the
    multipole Dirichlet layer used — callers feed it to
    :func:`grad_isolated` so the boundary force is consistent with the
    solve.  No mean subtraction: the isolated problem is well-posed.
    """
    nd = rho.dim()
    rhs = coeff * rho
    moments = multipole_moments(rho, dx)   # grid reductions once
    ghosts: List[List[torch.Tensor]] = []
    for d in range(nd):
        pair = []
        for side in (0, 1):
            pts = _face_points(tuple(rho.shape), dx, d, side, rho.dtype,
                               rho.device)
            g = multipole_phi(rho, dx, coeff, pts, moments=moments)
            fshape = tuple(1 if dd == d else rho.shape[dd]
                           for dd in range(nd))
            pair.append(g.reshape(fshape))
        ghosts.append(pair)

    # the Dirichlet layer folds into the rhs: Lap0(phi) = rhs - ghosts/dx^2
    rhs_adj = rhs.clone()
    dx2 = dx * dx
    for d in range(nd):
        lo = [slice(None)] * nd
        hi = [slice(None)] * nd
        lo[d] = slice(0, 1)
        hi[d] = slice(rho.shape[d] - 1, None)
        lo, hi = tuple(lo), tuple(hi)
        rhs_adj[lo] = rhs_adj[lo] + (-ghosts[d][0] / dx2)
        rhs_adj[hi] = rhs_adj[hi] + (-ghosts[d][1] / dx2)

    phi = torch.zeros_like(rhs) if phi0 is None else phi0
    return frozen_cg(lambda x: lap_dirichlet0(x, dx), rhs_adj, phi, iters,
                     tol), ghosts


def grad_isolated(phi, ghosts, dx: float):
    """Central-difference force ``f = -grad(phi)`` [ndim, *sp] using the
    multipole Dirichlet ghost layers at the boundary."""
    nd = phi.dim()
    comps = []
    for d in range(nd):
        padded = torch.cat([ghosts[d][0].to(phi.dtype), phi,
                            ghosts[d][1].to(phi.dtype)], dim=d)
        n = padded.shape[d]
        comps.append(-(padded.narrow(d, 2, n - 2) - padded.narrow(d, 0, n - 2))
                     / (2.0 * dx))
    return torch.stack(comps)
