"""Per-level Poisson solve on the AMR hierarchy (PyTorch).

Port of ``ramses_tpu/poisson/amr_solve.py``: the
``multigrid_fine``/``phi_fine_cg`` capability.  Levels are solved
coarse→fine with a one-way interface — each level's solve sees Dirichlet
boundary values interpolated from the coarser φ (``make_fine_bc_rhs``),
the reference's masked level solve.  Complete levels take the exact FFT
inversion; partial levels run preconditioned CG with matvec = one gather
over the face-neighbour index map.

Every solve keeps its values on the device: a fixed iteration count with
converged iterations frozen by ``torch.where`` (the JAX package's
``fori_loop``), the iteration count a device tensor.  The preconditioner's
restriction sums each parent's children in ascending order through a host
table (:func:`ramses_tpu_torch.amr.maps.mg_children`) instead of an atomic
scatter-add, so a solve is bitwise reproducible on the card.
"""

from __future__ import annotations

import torch


def _ext(phi, ghosts):
    return torch.cat([phi, ghosts, phi.new_zeros(1)])


def laplacian(phi, ghosts, nb, dx, valid, ndim: int):
    """7-point Laplacian over the face-neighbour map; zero on pad rows."""
    s = torch.zeros_like(phi)
    ext = _ext(phi, ghosts)
    for d in range(ndim):
        s = s + ext[nb[:, d, 0]] + ext[nb[:, d, 1]]
    lap = (s - 2.0 * ndim * phi) / dx ** 2
    return torch.where(valid, lap, 0.0)


def _system_rhs(rhs, ghosts, nb, dx, valid, ndim: int):
    """b ≡ rhs − lap(0, ghosts) on the valid cells: the affine split of
    Δφ = rhs with fixed Dirichlet ghosts into A(φ) = lap(φ, 0)."""
    return torch.where(valid, rhs - laplacian(torch.zeros_like(rhs), ghosts,
                                              nb, dx, valid, ndim), 0.0)


def cg_level(rhs, ghosts, nb, dx, valid, ndim: int, iters: int = 200,
             phi0=None):
    """CG solve of Δφ = rhs with fixed Dirichlet ghosts (A is symmetric
    negative definite on the masked cells; CG runs on −A)."""
    zero_g = torch.zeros_like(ghosts)
    b = _system_rhs(rhs, ghosts, nb, dx, valid, ndim)

    def A(x):
        return -laplacian(x, zero_g, nb, dx, valid, ndim)

    x = phi0 if phi0 is not None else torch.zeros_like(rhs)
    r = torch.where(valid, -b - A(x), 0.0)
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        Ap = A(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom != 0.0, rs / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        beta = torch.where(rs != 0.0, rs_new / rs, 0.0)
        p = r + beta * p
        rs = rs_new
    return torch.where(valid, x, 0.0)


def _lat_apply(e, lat_nb, dxj, ndim: int):
    """−Δe on a masked lattice (sentinel row = outside the mask =
    Dirichlet 0 for the error equation)."""
    ext = torch.cat([e, e.new_zeros(1)])
    s = torch.zeros_like(e)
    for d in range(ndim):
        s = s + ext[lat_nb[:, d, 0]] + ext[lat_nb[:, d, 1]]
    return -(s - 2.0 * ndim * e) / (dxj * dxj)


def _lat_jacobi(e, r, lat_nb, dxj, ndim: int, nu: int):
    """``nu`` damped-Jacobi sweeps of −Δe = r on a masked lattice."""
    diag = 2.0 * ndim / (dxj * dxj)
    for _ in range(nu):
        e = e + 0.6 * (r - _lat_apply(e, lat_nb, dxj, ndim)) / diag
    return e


def _restrict_children(resid, kids):
    """Sum of each parent's children ``kids [n_next, k]`` (ascending, pad
    entries index an appended zero), in a fixed order."""
    ext = torch.cat([resid, resid.new_zeros(1)])
    acc = ext[kids[:, 0]]
    for k in range(1, kids.shape[1]):
        acc = acc + ext[kids[:, k]]
    return acc


def pcg_level(rhs, ghosts, nb, oct_nb, dx, valid, ndim: int,
              tol: float = 1e-4, iters: int = 200, nu: int = 4,
              phi0=None, mg=()):
    """Preconditioned CG with residual-targeted termination.

    CG on the masked level system, preconditioned by the masked-multigrid
    ladder — ``M^-1 r = w_f * D^-1 r + P V(P^T r)`` where V is a symmetric
    V-cycle (damped-Jacobi smoothing, piecewise-constant transfer) over the
    coarsened oct lattices of the SAME masked domain (``mg``: per depth
    ``(nb, par, kids)``, :func:`ramses_tpu_torch.amr.maps.
    build_mg_lattices` and :func:`ramses_tpu_torch.amr.maps.mg_children`).
    The iteration stops counting once ``|r| <= tol·|b|`` (the system rhs,
    not the warm start's residual); all ``iters`` iterations run.

    Returns (phi, niter), niter a 0-d int32 device tensor.
    """
    ttd = 2 ** ndim
    zero_g = torch.zeros_like(ghosts)
    b = _system_rhs(rhs, ghosts, nb, dx, valid, ndim)

    def A(x):
        return -laplacian(x, zero_g, nb, dx, valid, ndim)

    def vcycle(j, rj):
        """Symmetric V-cycle on lattice depth j (0 = oct lattice)."""
        dxj = dx * (2.0 ** (j + 1))
        lat_nb = oct_nb if j == 0 else mg[j - 1][0]
        ej = _lat_jacobi(torch.zeros_like(rj), rj, lat_nb, dxj, ndim, nu)
        if j < len(mg):
            par, kids = mg[j][1], mg[j][2]
            resid = rj - _lat_apply(ej, lat_nb, dxj, ndim)
            r_next = _restrict_children(resid, kids) / ttd
            e_next = vcycle(j + 1, r_next)
            ext = torch.cat([e_next, e_next.new_zeros(1)])
            ej = ej + ext[par[:rj.shape[0]]]
            ej = _lat_jacobi(ej, rj, lat_nb, dxj, ndim, nu)
        return ej

    def Minv(r):
        # restrict cells -> oct lattice (adjoint of repeat), V-cycle down
        # the masked ladder, prolong back; the fine half a damped diagonal
        rc = r.reshape(-1, ttd).sum(dim=1) / ttd
        e = torch.repeat_interleave(vcycle(0, rc), ttd)
        diag_f = 2.0 * ndim / (dx * dx)
        e = e + 0.6 * r / diag_f
        return torch.where(valid, e, 0.0)

    x = phi0 if phi0 is not None else torch.zeros_like(rhs)
    r = torch.where(valid, -b - A(x), 0.0)
    z = Minv(r)
    p = z
    rz = torch.sum(r * z)
    tiny = torch.finfo(rhs.dtype).tiny
    cut = torch.full((), tol, dtype=rhs.dtype, device=rhs.device) ** 2 \
        * torch.clamp(torch.sum(b * b), min=tiny)
    niter = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for _ in range(iters):
        live = torch.sum(r * r) > cut
        Ap = A(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(live & (denom != 0.0),
                            rz / torch.where(denom == 0.0, 1.0, denom), 0.0)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = Minv(r_new)
        rz_new = torch.sum(r_new * z_new)
        beta = torch.where(live & (rz != 0.0),
                           rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
        p = torch.where(live, z_new + beta * p, p)
        r = torch.where(live, r_new, r)
        rz = torch.where(live, rz_new, rz)
        niter = niter + live.to(torch.int32)
    return torch.where(valid, x, 0.0), niter


def grad_phi(phi, ghosts, nb, dx, valid, ndim: int):
    """Central-difference force f = −∇φ, [ncell_pad, ndim]
    (``force_fine``'s gradient on the face-neighbour map)."""
    ext = _ext(phi, ghosts)
    comps = []
    for d in range(ndim):
        g = -(ext[nb[:, d, 1]] - ext[nb[:, d, 0]]) / (2.0 * dx)
        comps.append(torch.where(valid, g, 0.0))
    return torch.stack(comps, dim=1)


def grad_dense(phi_dense, dx, ndim: int):
    """f = −∇φ on a dense periodic grid, 4th-order 5-point stencil
    (``force_fine``'s gradient, the operator of
    :func:`ramses_tpu_torch.poisson.force.gradient_phi`); returns the dense
    grid ``[*shape, ndim]``."""
    a = 2.0 / (3.0 * dx)
    b = 1.0 / (12.0 * dx)
    comps = []
    for d in range(ndim):
        d1 = torch.roll(phi_dense, -1, d) - torch.roll(phi_dense, 1, d)
        d2 = torch.roll(phi_dense, -2, d) - torch.roll(phi_dense, 2, d)
        comps.append(-(a * d1 - b * d2))
    return torch.stack(comps, dim=-1)


def kick_flat(u, f, dteff, ndim: int, smallr: float):
    """Gravity momentum kick on flat cells [ncell, nvar] at fixed internal
    energy (``synchro_hydro_fine``)."""
    r = torch.clamp(u[:, 0], min=smallr)
    ek_old = sum(0.5 * u[:, 1 + d] ** 2 for d in range(ndim)) / r
    mom = [u[:, 1 + d] + r * f[:, d] * dteff for d in range(ndim)]
    ek_new = sum(0.5 * m * m for m in mom) / r
    e = u[:, 1 + ndim] - ek_old + ek_new
    cols = [u[:, 0:1]] + [m[:, None] for m in mom] + [e[:, None]]
    if u.shape[1] > ndim + 2:
        cols.append(u[:, ndim + 2:])
    return torch.cat(cols, dim=1)
