"""M1 photon transport: closure, face fluxes, conservative update
(PyTorch), and the wrappers of K8.

Port of ``ramses_tpu/rt/m1.py`` and of ``rt/amr._glf_block``.  Reference:
``rt/rt_flux_module.f90`` (``cmp_eddington:208-248`` for the closure; GLF
interface fluxes) and ``rt/rt_godunov_fine.f90``.  State per group: photon
number density N [1/cm^3] and flux F [1/cm^2/s], advanced at the reduced
speed of light ``c_red``.

The plain versions (:func:`transport_step_ref`, one group on a dense box,
and :func:`glf_block_ref`, one group on gathered 6^d oct stencils) are the
JAX package's formulation as torch: ``_pad`` + rolls + ``_unpad``, in its
order of operations.  One substep of every group is one launch of K8
(``csrc/rt_m1.cu``) on the card:

* :func:`transport` (the dense entry: the uniform grid and complete AMR
  levels) takes the state as one ``[ng, 1+nd, *sp]`` tensor, group-major
  (N, F_x..F_z) blocks, adds ``dt·src`` and, with beams, ``dt·src_F``, and
  returns the new state;
* :func:`block_update` (the block entry: partial AMR levels) takes the
  gathered ``[ng·(1+nd), 6^d, noct]`` stencils and writes the updated
  interior ``[2:4]^d`` cells of each oct into a copy of the level's rows.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches K8 (counted in :data:`launches` and :data:`block_launches`) or
raises.  K8 is f64 only, as the RT state is: in f32 ``(c_red·SMALL_NP)²``
underflows and the closure of an empty cell is 0/0.

The plain versions divide tensors by tensors only (``dt/dx`` is a Python
division), so on the card they round where K8, built without FMA
contraction, does (ROADMAP §C12).
"""

from __future__ import annotations

import ctypes

import torch

SMALL_NP = 1e-30

# K8 launches since the counts were last reset (the main path's proof that
# the transport went through the kernel): the dense entry and the block
# entry
launches = 0
block_launches = 0


def eddington(N, F, c_red, ndim: int):
    """Pressure tensor P[i][j] (units of N) from the M1 closure
    (``cmp_eddington``): chi = (3+4f²)/(5+2√(4-3f²)),
    D = (1-chi)/2 I + (3chi-1)/2 n⊗n."""
    Ns = torch.clamp(N, min=SMALL_NP)
    f2 = sum(F[d] ** 2 for d in range(ndim)) / (c_red * Ns) ** 2
    f2 = torch.clamp(f2, 0.0, 1.0)
    chi = (3.0 + 4.0 * f2) / (5.0 + 2.0 * torch.sqrt(
        torch.clamp(4.0 - 3.0 * f2, min=0.0)))
    iterm = 0.5 * (1.0 - chi)
    oterm = 0.5 * (3.0 * chi - 1.0)
    fmag2 = sum(F[d] ** 2 for d in range(ndim))
    inv = 1.0 / torch.clamp(fmag2, min=SMALL_NP)
    P = [[None] * ndim for _ in range(ndim)]
    for i in range(ndim):
        for j in range(ndim):
            nn = F[i] * F[j] * inv
            P[i][j] = N * (oterm * nn + (iterm if i == j else 0.0))
    return P


def _phys_flux(N, F, c_red, ndim, d):
    """[1+ndim] physical flux components along direction d."""
    P = eddington(N, F, c_red, ndim)
    out = [F[d]]
    for j in range(ndim):
        out.append(c_red ** 2 * P[d][j])
    return out


def _pad(a, ndim, ng=1, periodic=True):
    for d in range(ndim):
        ax = a.dim() - ndim + d
        n = a.shape[ax]
        if periodic:
            lo = a.narrow(ax, n - ng, ng)
            hi = a.narrow(ax, 0, ng)
        else:  # outflow
            reps = [1] * a.dim()
            reps[ax] = ng
            lo = a.narrow(ax, 0, 1).repeat(reps)
            hi = a.narrow(ax, n - 1, 1).repeat(reps)
        a = torch.cat([lo, a, hi], dim=ax)
    return a


def _unpad(a, ndim, ng=1):
    idx = [slice(None)] * a.dim()
    for d in range(ndim):
        ax = a.dim() - ndim + d
        idx[ax] = slice(ng, a.shape[ax] - ng)
    return a[tuple(idx)]


def _glf(N, F, dtdx, c_red, ndim, ax0):
    """The GLF increments (dN, [dF_j]) of the rolled stencil: spatial axis
    ``d`` is tensor axis ``ax0 + d``."""
    U = [N] + F
    dN = torch.zeros_like(N)
    dF = [torch.zeros_like(N) for _ in range(ndim)]
    for d in range(ndim):
        ax = ax0 + d
        flux = _phys_flux(N, F, c_red, ndim, d)
        # GLF at the low face of each cell
        face = []
        for k in range(1 + ndim):
            fl = torch.roll(flux[k], 1, dims=ax)
            ul = torch.roll(U[k], 1, dims=ax)
            face.append(0.5 * (fl + flux[k]) - 0.5 * c_red * (U[k] - ul))
        dN = dN + dtdx * (face[0] - torch.roll(face[0], -1, dims=ax))
        for j in range(ndim):
            dF[j] = dF[j] + dtdx * (
                face[1 + j] - torch.roll(face[1 + j], -1, dims=ax))
    return dN, dF


def _limit(N_new, F_new, c_red, ndim):
    """flux limiter |F| <= c N (M1 physical bound)."""
    fmag = torch.sqrt(sum(F_new[j] ** 2 for j in range(ndim)))
    cap = c_red * N_new
    scale = torch.where(fmag > cap, cap / torch.clamp(fmag, min=SMALL_NP),
                        1.0)
    return F_new * scale


def transport_step_ref(N, F, dt: float, dx: float, c_red: float, ndim: int,
                       periodic: bool = True):
    """One first-order GLF transport step of one group (the JAX package's
    ``transport_step``): ``N [*sp]``, ``F [ndim, *sp]``; returns (N', F')."""
    Np = _pad(N, ndim, 1, periodic)
    Fp = _pad(F, ndim, 1, periodic)
    Fl = [Fp[d] for d in range(ndim)]
    dN, dF = _glf(Np, Fl, dt / dx, c_red, ndim, Np.dim() - ndim)
    N_new = torch.clamp(_unpad(Np + dN, ndim), min=SMALL_NP)
    F_new = torch.stack([_unpad(Fl[j] + dF[j], ndim) for j in range(ndim)])
    return N_new, _limit(N_new, F_new, c_red, ndim)


def glf_block_ref(blk, dt: float, dx: float, c_red: float, nd: int):
    """The GLF update on one group's gathered stencil block ``[1+nd, 6..,
    noct]`` (spatial axes 1..nd, trailing oct batch; the ghosts come with
    the gather, so no padding: the JAX package's ``rt/amr._glf_block``).
    The rolls wrap inside the 6-wide block; the interior ``[2:4]^d`` cells,
    the only ones kept, read their ±1 neighbours only."""
    N = blk[0]
    F = [blk[1 + d] for d in range(nd)]
    dN, dF = _glf(N, F, dt / dx, c_red, nd, 0)
    N_new = torch.clamp(N + dN, min=SMALL_NP)
    F_new = torch.stack([F[j] + dF[j] for j in range(nd)])
    return torch.cat([N_new[None], _limit(N_new, F_new, c_red, nd)])


def transport_ref(U, dt: float, dx: float, c_red: float, ndim: int,
                  periodic: bool = True, src=None, src_F=None):
    """Plain version of K8's dense entry: ``U [ng, 1+ndim, *sp]`` plus
    ``dt·src [ng, *sp]`` and ``dt·src_F [ng, ndim, *sp]`` (each optional),
    then :func:`transport_step_ref` on every group.  Returns the new
    ``[ng, 1+ndim, *sp]`` state."""
    N, F = U[:, 0], U[:, 1:]
    if src is not None:
        N = N + dt * src
    if src_F is not None:
        F = F + dt * src_F
    out = []
    for g in range(U.shape[0]):
        Ng, Fg = transport_step_ref(N[g], F[g], dt, dx, c_red, ndim,
                                    periodic)
        out.append(torch.cat([Ng[None], Fg]))
    return torch.stack(out)


def block_update_ref(rad, blk, dt: float, dx: float, c_red: float, nd: int,
                     ng: int):
    """Plain version of K8's block entry: every group's
    :func:`glf_block_ref` on the gathered ``blk [ng·(1+nd), 6^d.., noct]``,
    its interior cells written oct-major (like ``level_sweep``'s du
    extraction) over the leading ``noct·2^d`` rows of a copy of ``rad
    [ncell_pad, ng·(1+nd)]``."""
    ncols = ng * (1 + nd)
    blk = torch.cat([glf_block_ref(blk[g * (1 + nd):(g + 1) * (1 + nd)],
                                   dt, dx, c_red, nd)
                     for g in range(ng)], dim=0)
    interior = (slice(None),) + tuple(slice(2, 4) for _ in range(nd))
    noct = blk.shape[-1]
    upd = blk[interior].permute((nd + 1,) + tuple(range(1, nd + 1)) + (0,)
                                ).reshape(noct * 2 ** nd, ncols)
    out = rad.clone()
    out[:noct * 2 ** nd] = upd
    return out


def rt_courant_dt(dx: float, c_red: float, courant: float = 0.8) -> float:
    """dt = C*dx/(3c) (``rt/rt_godunov_utils.f90:18``)."""
    return courant * dx / 3.0 / c_red


# ----------------------------------------------------------------------
# K8
# ----------------------------------------------------------------------

def transport(U, dt: float, dx: float, c_red: float, ndim: int,
              periodic: bool = True, src=None, src_F=None):
    """One transport substep of every group: :func:`transport_ref` on a
    CPU tensor, one launch of K8's dense entry on a CUDA tensor."""
    if U.device.type == "cpu":
        return transport_ref(U, dt, dx, c_red, ndim, periodic, src, src_F)
    global launches
    _check(U, "U", U)
    for name, t in (("src", src), ("src_F", src_F)):
        if t is not None:
            _check(t, name, U)
    shape = tuple(U.shape)
    if len(shape) != 2 + ndim or shape[1] != 1 + ndim:
        raise ValueError(f"rt transport: U {shape} is not [ng, 1+{ndim}, "
                         f"*sp]")
    out = torch.empty_like(U)
    if U.numel():
        with torch.cuda.device(U.device):
            call_dense(_library(), U, out, dt, dx, c_red, ndim, periodic,
                       src, src_F,
                       torch.cuda.current_stream(U.device).cuda_stream)
        launches += 1
    return out


def block_update(rad, blk, dt: float, dx: float, c_red: float, nd: int,
                 ng: int):
    """The transport substep of a partial level: :func:`block_update_ref`
    on a CPU tensor, one launch of K8's block entry on a CUDA tensor."""
    if rad.device.type == "cpu":
        return block_update_ref(rad, blk, dt, dx, c_red, nd, ng)
    global block_launches
    _check(rad, "rad", rad)
    _check(blk, "blk", rad)
    ncols = ng * (1 + nd)
    noct = blk.shape[-1]
    if (blk.dim() != 2 + nd or blk.shape[0] != ncols
            or tuple(blk.shape[1:-1]) != (6,) * nd
            or rad.dim() != 2 or rad.shape[1] != ncols
            or rad.shape[0] < noct * 2 ** nd):
        raise ValueError(f"rt block update: blk {tuple(blk.shape)}, rad "
                         f"{tuple(rad.shape)} for ng={ng}, nd={nd}")
    out = rad.clone()
    if noct:
        with torch.cuda.device(rad.device):
            call_block(_library(), blk, out, dt, dx, c_red, nd, ng,
                       torch.cuda.current_stream(rad.device).cuda_stream)
        block_launches += 1
    return out


def _check(t, name, like):
    if (t.dtype != torch.float64 or t.device != like.device
            or t.device.type != "cuda" or not t.is_contiguous()):
        raise ValueError(f"rt_m1: {name} must be a contiguous float64 "
                         f"tensor on the CUDA device, got {t.dtype} on "
                         f"{t.device}")


_DENSE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
               + [ctypes.c_double] * 4 + [ctypes.c_void_p])
_BLOCK_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_longlong] + [ctypes.c_double] * 3
               + [ctypes.c_void_p])


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("rt_m1"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/rt_m1.cu``."""
    for name, args in (("ramses_rt_m1_dense", _DENSE_ARGS),
                       ("ramses_rt_m1_block", _BLOCK_ARGS)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def call_dense(lib, U, out, dt, dx, c_red, ndim, periodic, src=None,
               src_F=None, stream=None):
    """One call of ``ramses_rt_m1_dense`` in the loaded build ``lib``
    (the card's build on CUDA tensors, or a host build of the source on
    CPU ones) on contiguous f64 tensors; raises on the error it returns."""
    sp = list(U.shape[2:]) + [1] * (3 - ndim)
    err = lib.ramses_rt_m1_dense(
        U.data_ptr(), src.data_ptr() if src is not None else None,
        src_F.data_ptr() if src_F is not None else None, out.data_ptr(),
        U.shape[0], ndim, *sp, int(bool(periodic)), float(dt),
        float(dt) / float(dx), float(c_red), float(c_red) ** 2, stream)
    if err:
        raise RuntimeError(f"rt_m1 dense kernel launch failed (cudaError "
                           f"{err})")


def call_block(lib, blk, out, dt, dx, c_red, nd, ng, stream=None):
    """One call of ``ramses_rt_m1_block`` in the loaded build ``lib``:
    writes the interior cells of every oct of ``blk`` over the leading
    rows of ``out``; raises on the error it returns."""
    err = lib.ramses_rt_m1_block(blk.data_ptr(), out.data_ptr(), ng, nd,
                                 blk.shape[-1], float(dt) / float(dx),
                                 float(c_red), float(c_red) ** 2, stream)
    if err:
        raise RuntimeError(f"rt_m1 block kernel launch failed (cudaError "
                           f"{err})")
