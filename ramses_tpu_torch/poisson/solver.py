"""Uniform-grid Poisson solvers: FFT (exact discrete), multigrid, CG.

Port of ``ramses_tpu/poisson/solver.py``.  Solves the 7-point
(2*ndim+1) finite-difference Poisson problem ``Lap(phi) = rhs`` with
periodic boundaries on a [*spatial] grid.

Reference equivalents: per-level multigrid ``multigrid_fine``
(``poisson/multigrid_fine_commons.f90:25-305``) with red-black Gauss-Seidel
smoothing (``poisson/multigrid_fine_fine.f90:332``), and the conjugate
gradient alternative ``phi_fine_cg`` (``poisson/phi_fine_cg.f90:5-625``).
The FFT path solves the same discrete operator exactly (eigenvalues of the
periodic difference Laplacian), so MG/CG can be validated against it.

All functions are shape-generic over ndim 1/2/3 and keep every value on
the device: iteration counts are fixed (the reference's MAXITER=10 cap,
``multigrid_fine_commons.f90:33-34``) and CG freezes converged iterations
with ``torch.where`` instead of reading the residual on the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def laplacian(phi, dx: float):
    """Periodic 2*ndim+1-point Laplacian, all spatial axes of ``phi``."""
    nd = phi.dim()
    out = -2.0 * nd * phi
    for ax in range(nd):
        out = out + torch.roll(phi, 1, ax) + torch.roll(phi, -1, ax)
    return out / (dx * dx)


def residual(phi, rhs, dx: float):
    return rhs - laplacian(phi, dx)


@lru_cache(maxsize=None)
def _red_black(shape: Tuple[int, ...], device: str):
    red = torch.from_numpy(sum(np.indices(shape)) % 2 == 0).to(device)
    return red, ~red


def _parity_mask(shape: Tuple[int, ...], device="cpu"):
    """Checkerboard mask: True on 'red' cells (sum of indices even); built
    once per (shape, device)."""
    return _red_black(tuple(shape), str(torch.device(device)))[0]


def gauss_seidel(phi, rhs, dx: float, iters: int):
    """Red-black Gauss-Seidel sweeps (``gauss_seidel_mg_fine``,
    ``poisson/multigrid_fine_fine.f90:332``): one call = ``iters`` full
    (red+black) relaxations."""
    red, black = _red_black(tuple(phi.shape), str(phi.device))
    nd = phi.dim()
    dx2 = dx * dx
    inv = 1.0 / (2.0 * nd)

    def half_sweep(phi, mask):
        nb = torch.zeros_like(phi)
        for ax in range(nd):
            nb = nb + torch.roll(phi, 1, ax) + torch.roll(phi, -1, ax)
        upd = (nb - dx2 * rhs) * inv
        return torch.where(mask, upd, phi)

    for _ in range(iters):
        phi = half_sweep(phi, red)
        phi = half_sweep(phi, black)
    return phi


def restrict(r):
    """Full restriction: average over 2^ndim children (the reference
    restricts residuals by child averaging, ``restrict_residual_fine``,
    ``poisson/multigrid_fine_fine.f90:457``)."""
    nd = r.dim()
    for ax in range(nd):
        shape = r.shape[:ax] + (r.shape[ax] // 2, 2) + r.shape[ax + 1:]
        r = r.reshape(shape).mean(dim=ax + 1)
    return r


def prolong(e, fine_shape: Tuple[int, ...]):
    """Cell-centered linear prolongation, periodic wrap
    (``interpolate_and_correct_fine``,
    ``poisson/multigrid_fine_fine.f90:596``): a child at offset -/+1/4 of
    its parent gets ``3/4 parent + 1/4 neighbour``, per axis."""
    for ax in range(e.dim()):
        lo = 0.75 * e + 0.25 * torch.roll(e, 1, ax)
        hi = 0.75 * e + 0.25 * torch.roll(e, -1, ax)
        e = torch.stack([lo, hi], dim=ax + 1)
        shape = e.shape[:ax] + (e.shape[ax] * 2,) + e.shape[ax + 2:]
        e = e.reshape(shape)
    return e


def _mg_levels(shape: Tuple[int, ...], min_size: int = 4) -> int:
    """Number of coarsenings possible (all dims halve evenly, stay >= min)."""
    lv = 0
    s = list(shape)
    while all(n % 2 == 0 and n // 2 >= min_size for n in s):
        s = [n // 2 for n in s]
        lv += 1
    return lv


def vcycle(phi, rhs, dx: float, nlevel: int, npre: int = 2, npost: int = 2,
           ncoarse_iter: int = 32):
    """One V-cycle over ``nlevel`` coarsenings."""
    if nlevel == 0:
        return gauss_seidel(phi, rhs, dx, ncoarse_iter)
    phi = gauss_seidel(phi, rhs, dx, npre)
    r = restrict(residual(phi, rhs, dx))
    e = vcycle(torch.zeros_like(r), r, 2.0 * dx, nlevel - 1, npre, npost,
               ncoarse_iter)
    phi = phi + prolong(e, tuple(phi.shape))
    return gauss_seidel(phi, rhs, dx, npost)


def mg_solve(rhs, dx: float, phi0=None, ncycle: int = 10, npre: int = 2,
             npost: int = 2):
    """Multigrid solve: fixed ``ncycle`` V-cycles (the reference caps at
    MAXITER=10, ``multigrid_fine_commons.f90:33``).  Periodic compatibility
    (zero mean) is enforced on the rhs; the returned phi has zero mean."""
    rhs = rhs - torch.mean(rhs)
    phi = torch.zeros_like(rhs) if phi0 is None else phi0
    nlevel = _mg_levels(tuple(rhs.shape))
    for _ in range(ncycle):
        phi = vcycle(phi, rhs, dx, nlevel, npre, npost)
    return phi - torch.mean(phi)


@lru_cache(maxsize=None)
def _fft_eigenvalues(shape: Tuple[int, ...], dx: float, dtype, device: str):
    """Eigenvalues of the periodic 2*ndim+1-point Laplacian on the rfft
    half-spectrum of ``shape`` (f64 on the host, then cast once)."""
    nd = len(shape)
    rshape = shape[:-1] + (shape[-1] // 2 + 1,)
    lam = np.zeros(rshape)
    for ax in range(nd):
        n = shape[ax]
        k = np.arange(rshape[ax])
        ev = 2.0 * np.cos(2.0 * np.pi * k / n) - 2.0
        bshape = [1] * nd
        bshape[ax] = rshape[ax]
        lam = lam + ev.reshape(bshape)
    lam = lam / (dx * dx)
    return torch.from_numpy(lam).to(device=device, dtype=dtype)


def fft_solve(rhs, dx: float):
    """Exact solve of the discrete periodic problem via FFT.

    Divides by the eigenvalues of the 2*ndim+1-point Laplacian
    ``sum_d (2 cos(2 pi k_d / N_d) - 2) / dx^2`` so the result satisfies
    the *same discrete equations* as MG/CG (not the continuum solution);
    the zero mode is set to 0 (zero-mean solution).
    """
    shape = tuple(rhs.shape)
    rhat = torch.fft.rfftn(rhs)
    lam = _fft_eigenvalues(shape, float(dx), rhs.dtype, str(rhs.device))
    zero = lam == 0.0
    lam0 = torch.where(zero, 1.0, lam)
    phat = torch.where(zero, 0.0, rhat / lam0)
    return torch.fft.irfftn(phat, s=shape)


def frozen_cg(op, b, x, iters: int, tol: float):
    """Conjugate gradient on ``op(x) = b`` (``op`` symmetric) from ``x``:
    ``iters`` iterations, each frozen by ``torch.where`` once
    ``|r|² <= max(eps², tol²)·|r0|²`` (rounding level or the tolerance), so
    no value leaves the device."""
    r = b - op(x)
    p = r
    rs = torch.sum(r * r)
    eps = torch.finfo(b.dtype).eps
    cut = torch.full((), max(eps * eps, tol * tol), dtype=b.dtype,
                     device=b.device)
    floor = cut * torch.clamp(rs, min=1e-300)
    for _ in range(iters):
        live = rs > floor
        ap = op(p)
        denom = torch.sum(p * ap)
        alpha = torch.where(live & (denom != 0.0),
                            rs / torch.where(denom == 0, 1.0, denom), 0.0)
        x = x + alpha * p
        r_new = r - alpha * ap
        rs_new = torch.sum(r_new * r_new)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
        p = torch.where(live, r_new + beta * p, p)
        r = torch.where(live, r_new, r)
        rs = torch.where(live, rs_new, rs)
    return x


def cg_solve(rhs, dx: float, phi0=None, iters: int = 200, tol: float = 0.0):
    """Conjugate gradient on the periodic Laplacian (``phi_fine_cg``,
    ``poisson/phi_fine_cg.f90:5``): a fixed iteration count, iterations
    frozen once ``|r|/|r0| < tol`` (&POISSON_PARAMS epsilon) or the
    residual hits rounding level."""
    rhs = rhs - torch.mean(rhs)
    phi = torch.zeros_like(rhs) if phi0 is None else phi0
    phi = frozen_cg(lambda x: laplacian(x, dx), rhs, phi, iters, tol)
    return phi - torch.mean(phi)
