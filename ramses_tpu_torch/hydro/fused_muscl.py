"""Fused 3D MUSCL-Hancock step: the CUDA kernel and its plain version.

Port of ``ramses_tpu/hydro/pallas_muscl.py`` (``fused_step_padded``).  The
whole unsplit update — ctoprim → TVD slopes → trace3d → LLF/HLLC face
fluxes → conservative update — is one launch of the hand-written kernel
``csrc/fused_muscl.cu``, which also returns the Courant dt of the updated
state (``courant=True``) and zeroes every face next to a refined cell
when given a mask ``ok``.  With ``want_flux`` it also returns the dt/dx-scaled
mass flux through each cell's low and high faces, ``phi [3, 2, nx, ny,
nz]``: the MC gas tracers' capture (``pallas_muscl.py:289-291``).

:func:`fused_step` launches the kernel for a CUDA tensor and runs
:func:`fused_step_ref`, the same function in plain PyTorch (the TPU
kernel's arithmetic, with ``torch.roll`` on a ghost-padded tensor), for a
CPU tensor.  It never falls back: on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.hydro.core import HydroStatic

NG = 2  # ghost cells per side (matches muscl.NGHOST)

# Kernel launches since the count was last reset (the main path's proof
# that it ran through the kernel), without and with the face mass fluxes;
# the plain version does not count.
launches = 0
flux_launches = 0

_RIEMANN = {"llf": 0, "hllc": 1}
_COURANT_RATIO = 1e-4              # cmpdt's gravity-off strength ratio


def supports(cfg: HydroStatic, shape, bc_kinds, dtype) -> bool:
    """True when the fused kernel covers this configuration: the JAX
    kernel's physics scope (``pallas_muscl.supports``) without its TPU
    lane rules, and boundary kinds 0/1/2 on every axis.

    ``bc_kinds``: per-dim (low, high) boundary kinds (grid.boundary codes).
    """
    if getattr(cfg, "physics", "hydro") != "hydro":
        return False
    if cfg.ndim != 3 or cfg.nener != 0 or cfg.npassive != 0:
        return False
    if cfg.scheme != "muscl" or cfg.slope_type not in (1, 2, 8):
        return False
    if cfg.pressure_fix or cfg.riemann not in _RIEMANN:
        return False
    if len(shape) != 3 or any(n < NG for n in shape) or shape[0] > 65535:
        return False
    if any(k not in (0, 1, 2) for pair in bc_kinds for k in pair):
        return False
    return dtype == torch.float32


def _slope_factor(cfg: HydroStatic) -> float:
    st = cfg.slope_type
    return float(st) if st in (1, 2) else float(cfg.slope_theta)


def courant_fac(cfg: HydroStatic) -> float:
    """``(sqrt(1 + 2 cf ratio) - 1) / ratio`` folded into one scalar on the
    host, as the TPU kernel folds it (``pallas_muscl.py:312-315``)."""
    cf = cfg.courant_factor
    r = _COURANT_RATIO
    return (math.sqrt(1.0 + 2.0 * cf * r) - 1.0) / r


def dtmax(cfg: HydroStatic, dx: float) -> float:
    return cfg.courant_factor * dx / cfg.smallc


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _ghost_index(n: int, lo: int, hi: int) -> list:
    """Source index of each of the n + 2*NG padded cells along one axis
    (periodic / reflecting / outflow), as grid.boundary.pad fills them."""
    out = []
    for i in range(-NG, n + NG):
        if i < 0:
            out.append({0: i + n, 1: -1 - i}.get(lo, 0))
        elif i >= n:
            out.append({0: i - n, 1: 2 * n - 1 - i}.get(hi, n - 1))
        else:
            out.append(i)
    return out


def _pad_mask(okf: torch.Tensor, bc: bmod.BoundarySpec) -> torch.Tensor:
    for d, (lo, hi) in enumerate(bc.kinds):
        idx = torch.tensor(_ghost_index(okf.shape[d], lo, hi),
                           device=okf.device)
        okf = torch.index_select(okf, d, idx)
    return okf


def _slopes(ql, q, qr, f: float):
    """TVD slope of one variable given (left, centre, right) neighbours."""
    dl = q - ql
    dr = qr - q
    dcen = 0.5 * (dl + dr)
    slop = f * torch.minimum(torch.abs(dl), torch.abs(dr))
    dlim = torch.where(dl * dr <= 0.0, 0.0, slop)
    return torch.sign(dcen) * torch.minimum(dlim, torch.abs(dcen))


def _llf_flux(ql, qr, d: int, cfg: HydroStatic):
    """LLF flux of one face set (``pallas_muscl._llf_flux``); ql/qr are
    5-tuples (r, vx, vy, vz, p), already floored."""
    g = cfg.gamma
    entho = 1.0 / (g - 1.0)
    ul, ur = ql[1 + d], qr[1 + d]
    cl = torch.sqrt(torch.clamp(g * ql[4] / ql[0], min=cfg.smallc ** 2))
    cr = torch.sqrt(torch.clamp(g * qr[4] / qr[0], min=cfg.smallc ** 2))
    cmax = torch.maximum(torch.abs(ul) + cl, torch.abs(ur) + cr)

    def cons_flux(q5, un):
        r, p = q5[0], q5[4]
        ek = 0.5 * r * (q5[1] * q5[1] + q5[2] * q5[2] + q5[3] * q5[3])
        et = p * entho + ek
        ucons = (r, r * q5[1], r * q5[2], r * q5[3], et)
        f = [r * un * q5[1 + c] for c in range(3)]
        f[d] = f[d] + p
        return ucons, (r * un, f[0], f[1], f[2], un * (et + p))

    uL, fL = cons_flux(ql, ul)
    uR, fR = cons_flux(qr, ur)
    return tuple(0.5 * (fl + fr - cmax * (ur_ - ul_))
                 for fl, fr, ul_, ur_ in zip(fL, fR, uL, uR))


def _hllc_flux(ql, qr, d: int, cfg: HydroStatic):
    """HLLC with Toro sampling (``pallas_muscl._hllc_flux``)."""
    g = cfg.gamma
    entho = 1.0 / (g - 1.0)
    rl, pl_ = ql[0], ql[4]
    rr, pr_ = qr[0], qr[4]
    ul, ur = ql[1 + d], qr[1 + d]
    ekl = 0.5 * rl * (ql[1] * ql[1] + ql[2] * ql[2] + ql[3] * ql[3])
    ekr = 0.5 * rr * (qr[1] * qr[1] + qr[2] * qr[2] + qr[3] * qr[3])
    etotl = pl_ * entho + ekl
    etotr = pr_ * entho + ekr
    cfastl = torch.sqrt(torch.clamp(g * pl_ / rl, min=cfg.smallc ** 2))
    cfastr = torch.sqrt(torch.clamp(g * pr_ / rr, min=cfg.smallc ** 2))
    SL = torch.minimum(ul, ur) - torch.maximum(cfastl, cfastr)
    SR = torch.maximum(ul, ur) + torch.maximum(cfastl, cfastr)
    rcl = rl * (ul - SL)
    rcr = rr * (SR - ur)
    ustar = (rcr * ur + rcl * ul + (pl_ - pr_)) / (rcr + rcl)
    pstar = (rcr * pl_ + rcl * pr_ + rcl * rcr * (ul - ur)) / (rcr + rcl)
    rstarl = rl * (SL - ul) / (SL - ustar)
    etotstarl = ((SL - ul) * etotl - pl_ * ul + pstar * ustar) / (SL - ustar)
    rstarr = rr * (SR - ur) / (SR - ustar)
    etotstarr = ((SR - ur) * etotr - pr_ * ur + pstar * ustar) / (SR - ustar)

    def sel(a_l, a_sl, a_sr, a_r):
        return torch.where(SL > 0.0, a_l,
               torch.where(ustar > 0.0, a_sl,
               torch.where(SR > 0.0, a_sr, a_r)))

    ro = sel(rl, rstarl, rstarr, rr)
    uo = sel(ul, ustar, ustar, ur)
    po = sel(pl_, pstar, pstar, pr_)
    etoto = sel(etotl, etotstarl, etotstarr, etotr)
    left = ustar > 0.0
    fmass = ro * uo
    f = [None] * 5
    f[0] = fmass
    f[4] = (etoto + po) * uo
    for c in range(3):
        if c == d:
            f[1 + c] = fmass * uo + po
        else:
            f[1 + c] = fmass * torch.where(left, ql[1 + c], qr[1 + c])
    return tuple(f)


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one rounded division (torch's ``float / tensor`` is
    ``t.reciprocal() * a``, which rounds twice)."""
    return torch.div(torch.full_like(t, a), t)


def masked_fluxes(up: torch.Tensor, dt: torch.Tensor, cfg: HydroStatic,
                  dx: float, okf: Optional[torch.Tensor] = None):
    """The TPU kernels' MUSCL body in plain PyTorch on a block
    ``up [5, X, Y, Z, *batch]`` whose edges are halo: ctoprim → TVD slopes →
    trace3d → face states → floors → LLF/HLLC, neighbours by ``torch.roll``
    along the three spatial axes (what wraps around lands only on halo
    results).  Returns, per direction d, the 5 unscaled fluxes through each
    cell's LOW face; with ``okf`` (the refined mask on the same cells, in
    ``up``'s dtype) a face next to a refined cell carries none.  Shared by
    K1's plain version and those of K2 and K3
    (:mod:`ramses_tpu_torch.hydro.oct_muscl`)."""
    f = _slope_factor(cfg)
    solver = _llf_flux if cfg.riemann == "llf" else _hllc_flux
    # ---- ctoprim (umuscl.f90:861-967) ----
    r = torch.clamp(up[0], min=cfg.smallr)
    ir = 1.0 / r
    v = [up[1] * ir, up[2] * ir, up[3] * ir]
    ek = 0.5 * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    eint = torch.clamp(up[4] * ir - ek, min=cfg.smalle)
    p = (cfg.gamma - 1.0) * r * eint
    q = (r, v[0], v[1], v[2], p)
    # ---- uslope: dq[d][comp] ----
    dq = []
    for d in range(3):
        dq.append(tuple(_slopes(torch.roll(c, 1, d), c, torch.roll(c, -1, d),
                                f) for c in q))
    # ---- trace3d source terms (umuscl.f90:176-714) ----
    divv = dq[0][1] + dq[1][2] + dq[2][3]

    def adv(comp):
        return v[0] * dq[0][comp] + v[1] * dq[1][comp] + v[2] * dq[2][comp]

    sr0 = -adv(0) - divv * r
    sp0 = -adv(4) - divv * cfg.gamma * p
    sv0 = [-adv(1 + j) - dq[j][4] * ir for j in range(3)]
    dtdx2 = 0.5 * dt / dx
    # ---- per-direction face flux ----
    fluxes = []
    for d in range(3):
        def face_state(sgn):
            rho = r + sgn * 0.5 * dq[d][0] + sr0 * dtdx2
            rho = torch.where(rho < cfg.smallr, r, rho)
            vs = [v[j] + sgn * 0.5 * dq[d][1 + j] + sv0[j] * dtdx2
                  for j in range(3)]
            pp = p + sgn * 0.5 * dq[d][4] + sp0 * dtdx2
            return (rho, vs[0], vs[1], vs[2], pp)
        qm = face_state(+1.0)     # high-side face state
        qp = face_state(-1.0)     # low-side face state
        # face i between cells i-1, i: left = qm(i-1), right = qp(i)
        ql5 = tuple(torch.roll(c, 1, d) for c in qm)
        qr5 = qp
        # floors (riemann.py _prims); the pressure floor uses the
        # unfloored density, as the TPU kernel does
        ql5 = (torch.clamp(ql5[0], min=cfg.smallr), ql5[1], ql5[2], ql5[3],
               torch.maximum(ql5[4], ql5[0] * cfg.smallp))
        qr5 = (torch.clamp(qr5[0], min=cfg.smallr), qr5[1], qr5[2], qr5[3],
               torch.maximum(qr5[4], qr5[0] * cfg.smallp))
        flux = solver(ql5, qr5, d, cfg)
        if okf is not None:
            # face kept iff neither adjacent cell is refined
            keepf = (1.0 - okf) * (1.0 - torch.roll(okf, 1, d))
            flux = tuple(fl * keepf for fl in flux)
        fluxes.append(flux)
    return fluxes


def flux_update(fluxes, scale):
    """Per variable, Σ_d (F_low − F_high)·dt/dx of :func:`masked_fluxes`'
    output over the whole block, in the kernels' order."""
    du = [None] * 5
    for d in range(3):
        for c in range(5):
            contrib = (fluxes[d][c] - torch.roll(fluxes[d][c], -1, d)) * scale
            du[c] = contrib if du[c] is None else du[c] + contrib
    return du


def _results(un, dt_next, phi, courant: bool, want_flux: bool):
    out = (un,) + ((dt_next,) if courant else ()) + \
        ((phi,) if want_flux else ())
    return out if len(out) > 1 else un


def fused_step_ref(u: torch.Tensor, dt: torch.Tensor, cfg: HydroStatic,
                   dx: float, bc: bmod.BoundarySpec,
                   ok: Optional[torch.Tensor] = None, courant: bool = False,
                   dt_scale: float = 1.0, want_flux: bool = False):
    """Plain-PyTorch version of :func:`fused_step` (``_make_kernel``'s
    arithmetic, with ``torch.roll`` on a ghost-padded tensor).  Same
    arguments and results."""
    nx, ny, nz = u.shape[1:]
    dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    up = bmod.pad(u, bc, cfg, NG)
    sl = (slice(NG, NG + nx), slice(NG, NG + ny), slice(NG, NG + nz))
    okf = _pad_mask(ok.to(u.dtype), bc) if ok is not None else None
    fluxes = masked_fluxes(up, dt, cfg, dx, okf)
    scale = dt / dx
    du = flux_update(fluxes, scale)
    un = torch.stack([(up[c] + du[c])[sl] for c in range(5)])
    phi = None
    if want_flux:
        phi = torch.stack([torch.stack([
            (fluxes[d][0] * scale)[sl],
            (torch.roll(fluxes[d][0], -1, d) * scale)[sl]])
            for d in range(3)])
    if not courant:
        return _results(un, None, phi, False, want_flux)
    # Courant min of the UPDATED state (cmpdt, godunov_utils.f90:5-125
    # with gravity off), folded as the kernel folds it
    r2 = torch.clamp(un[0], min=cfg.smallr)
    ir2 = 1.0 / r2
    v2 = [un[1] * ir2, un[2] * ir2, un[3] * ir2]
    ek2 = 0.5 * r2 * (v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2])
    p2 = torch.maximum((cfg.gamma - 1.0) * (un[4] - ek2), r2 * cfg.smallp)
    c2 = torch.sqrt(cfg.gamma * p2 * ir2)
    ws = 3.0 * c2 + torch.abs(v2[0]) + torch.abs(v2[1]) + torch.abs(v2[2])
    local = torch.min(_rdiv(dx, ws)) * courant_fac(cfg)
    return _results(un, torch.clamp(local * dt_scale, max=dtmax(cfg, dx)),
                    phi, True, want_flux)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 10 + [ctypes.c_void_p])


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("fused_muscl"))


def bind(lib):
    """Declare the C entry point's signature on a loaded build of
    ``csrc/fused_muscl.cu`` (the tests also load a host build of it)."""
    fn = lib.ramses_fused_muscl
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def fused_step(u: torch.Tensor, dt: torch.Tensor, cfg: HydroStatic,
               dx: float, bc: bmod.BoundarySpec,
               ok: Optional[torch.Tensor] = None, courant: bool = False,
               dt_scale: float = 1.0, want_flux: bool = False):
    """One fused MUSCL-Hancock step of the unpadded state.

    ``u``: ``[5, nx, ny, nz]`` f32, contiguous; ``dt``: a 0-d tensor on
    ``u``'s device, read by the kernel through a pointer; ``bc``: the
    boundary spec (kinds 0/1/2); ``ok``: optional refined-cell mask
    ``[nx, ny, nz]`` (faces touching a refined cell get zero flux,
    ``godunov_fine.f90:718``).  Returns ``un`` or, with ``courant``,
    ``(un, dt_next)``: ``dt_next`` is a 0-d device tensor holding
    ``min(dtmax, dt_scale * Courant min of un)`` (``grid/uniform.py:156``
    of the JAX package).  ``want_flux`` appends ``phi [3, 2, nx, ny,
    nz]``: per direction, the masked mass flux through each cell's low
    (0) and high (1) face, ×dt/dx.

    A CPU tensor runs :func:`fused_step_ref`.  A CUDA tensor launches the
    kernel (counted in ``flux_launches`` with ``want_flux``, else in
    ``launches``) or raises.
    """
    if u.device.type == "cpu":
        return fused_step_ref(u, dt, cfg, dx, bc, ok=ok, courant=courant,
                              dt_scale=dt_scale, want_flux=want_flux)
    un, crt, phi = _launch(u, dt, cfg, dx, bc, ok, courant, want_flux)
    dt_next = (torch.clamp(crt * dt_scale, max=dtmax(cfg, dx)) if courant
               else None)
    return _results(un, dt_next, phi, courant, want_flux)


def _launch(u, dt, cfg, dx, bc, ok, courant, want_flux):
    """One launch of the kernel, counted in ``launches`` (or
    ``flux_launches``): :func:`call`'s ``(un, crt, phi)``.  Raises on a
    configuration outside :func:`supports`, on bad arguments, and when the
    build or the launch fails."""
    global launches, flux_launches
    if not supports(cfg, tuple(u.shape[1:]), bc.kinds, u.dtype):
        raise ValueError("fused_step: configuration outside the kernel's "
                         f"scope (cfg={cfg}, shape={tuple(u.shape)}, "
                         f"bc={bc.kinds}, dtype={u.dtype})")
    if u.device.type != "cuda" or u.shape[0] != 5 or not u.is_contiguous():
        raise ValueError("fused_step: u must be a contiguous [5, nx, ny, nz] "
                         "CUDA tensor")
    if not (torch.is_tensor(dt) and dt.dim() == 0 and dt.device == u.device
            and dt.dtype == torch.float32):
        raise ValueError("fused_step: dt must be a 0-d f32 tensor on "
                         "u's device")
    okf = None
    if ok is not None:
        if tuple(ok.shape) != tuple(u.shape[1:]) or ok.device != u.device:
            raise ValueError("fused_step: ok must be [nx, ny, nz] on "
                             "u's device")
        okf = ok.to(torch.float32).contiguous()
    lib = _library()
    with torch.cuda.device(u.device):
        out = call(lib, u, okf, dt, cfg, dx, bc, courant, want_flux,
                   torch.cuda.current_stream(u.device).cuda_stream)
    if want_flux:
        flux_launches += 1
    else:
        launches += 1
    return out


def call(lib, u, okf, dt, cfg, dx, bc, courant, want_flux, stream=None):
    """One call of the C entry of ``lib`` (a build of ``csrc/fused_muscl.cu``
    with :func:`bind` applied) on checked arguments: ``okf`` the refined
    mask as f32 0/1 or None, ``dt`` a 0-d f32 tensor.  Returns ``(un, crt,
    phi)``: ``crt`` the raw Courant min of ``un`` (None without
    ``courant``), ``phi`` the face mass fluxes (None without
    ``want_flux``); outputs go on ``u``'s device.  Raises on an error it
    returns."""
    un = torch.empty_like(u)
    crt = (torch.full((), math.inf, dtype=torch.float32, device=u.device)
           if courant else None)
    phi = u.new_empty((3, 2) + tuple(u.shape[1:])) if want_flux else None
    nx, ny, nz = u.shape[1:]
    kinds = [k for pair in bc.kinds for k in pair]
    g = cfg.gamma
    err = lib.ramses_fused_muscl(
        u.data_ptr(), okf.data_ptr() if okf is not None else None,
        dt.data_ptr(), un.data_ptr(),
        crt.data_ptr() if crt is not None else None,
        phi.data_ptr() if phi is not None else None,
        nx, ny, nz, *kinds, _RIEMANN[cfg.riemann], _slope_factor(cfg),
        g, g - 1.0, 1.0 / (g - 1.0), cfg.smallr, cfg.smallc ** 2,
        cfg.smallp, cfg.smalle, dx, courant_fac(cfg), stream)
    if err:
        raise RuntimeError(f"fused_muscl kernel launch failed "
                           f"(cudaError {err})")
    return un, crt, phi
