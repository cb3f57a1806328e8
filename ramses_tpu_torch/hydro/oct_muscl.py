"""MUSCL-Hancock sweeps of partial AMR levels: CUDA kernels and plain versions.

Port of ``ramses_tpu/hydro/pallas_oct.py``: the fused sweep of one partial
level on a gathered batch of blocks.

* :func:`tile_sweep` (K3, ``pallas_oct.tile_sweep``): blocked Morton tiles
  ``ut [5, N, td, td, td]`` (``td = c + 4``, ``c = 2**(shift+1)``) →
  ``du [5, N, c, c, c]`` and the per-oct-face flux planes ``corrp [5, 3,
  N, c//2+1, c, c]``, already ×dt/dx.  The JAX package's layout with the
  batch axis moved from last to just before the cell axes (``movedim``),
  so that a tile's variable is one contiguous run for the kernel's block.
* :func:`oct_sweep` (K2, ``pallas_oct.oct_sweep``): per-oct stencils
  ``uloc [5, 6, 6, 6, N]`` → ``du [5, 2, 2, 2, N]`` and the per-oct
  boundary-flux sums ``corr [5, 3, 2, N]``, already ×dt/dx: the JAX
  package's layout, batch last.

With ``want_flux`` each also returns the dt/dx-scaled mass fluxes of the
MC gas tracers' capture: K3 all ``c+1`` cell-face planes along each
direction, ``phip [3, N, c+1, c, c]``; K2 each interior cell's (low, high)
faces, ``phi [3, 2, 2, 2, 2, N]`` (direction, side, cell).

Both kernels are ``csrc/oct_muscl.cu`` on K1's body (``csrc/
muscl_common.cuh``).  A wrapper launches its kernel for a CUDA tensor, or
raises, and runs its plain version (:func:`tile_sweep_ref`,
:func:`oct_sweep_ref`: the TPU kernel's arithmetic in PyTorch, with
``torch.roll``) for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ramses_tpu_torch.hydro import fused_muscl as fm
from ramses_tpu_torch.hydro.core import HydroStatic

NG = 2                      # block halo width (MUSCL-Hancock stencil)
SHIFTS = (0, 1, 2, 3)       # tile shifts the K3 build carries (c = 2..16)

# Kernel launches since the counts were last reset (the main path's proof
# that it ran through each kernel), the flux variants under their own
# keys; the plain versions do not count.
launches = {"tile_sweep": 0, "oct_sweep": 0, "tile_sweep_flux": 0,
            "oct_sweep_flux": 0}


def supports(cfg: HydroStatic, dtype) -> bool:
    """True when K2 and K3 cover this configuration: the physics scope of
    ``pallas_oct.available`` / ``tile_available`` without their backend,
    device-count and lane-size rules."""
    if getattr(cfg, "physics", "hydro") != "hydro":
        return False
    if cfg.ndim != 3 or cfg.nener != 0 or cfg.npassive != 0:
        return False
    if cfg.pressure_fix or cfg.scheme != "muscl":
        return False
    if cfg.slope_type not in (1, 2, 8) or cfg.riemann not in fm._RIEMANN:
        return False
    return dtype == torch.float32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _sweep_fluxes(u, ok, dt, cfg: HydroStatic, dx: float):
    dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    fl = fm.masked_fluxes(u, dt, cfg, dx, ok.to(u.dtype))
    return fl, dt / dx


def _interior_update(fl, scale, c: int):
    """du of the c^3 interior cells."""
    core = (slice(NG, NG + c),) * 3
    return torch.stack([x[core] for x in fm.flux_update(fl, scale)])


def _planes(f, d: int, c: int, step: int):
    """Face values of ``f [td, td, td, N]`` at positions ``NG, NG + step,
    ..., NG + c`` along d, transverse interior: ``[c/step + 1, c, c, N]``
    (the transverse axes in increasing order)."""
    ix = tuple(slice(NG, NG + c + 1, step) if dd == d
               else slice(NG, NG + c) for dd in range(3))
    return torch.movedim(f[ix], d, 0)


def tile_sweep_ref(ut, ok, dt, cfg: HydroStatic, dx: float, shift: int,
                   want_flux: bool = False):
    """Plain-PyTorch version of :func:`tile_sweep` (``_make_tile_kernel``'s
    arithmetic, on the batch-last views of the tile-major arrays).  Same
    arguments and results; the results are views."""
    c = 1 << (shift + 1)
    fl, scale = _sweep_fluxes(ut.movedim(1, -1), ok.movedim(0, -1), dt, cfg,
                              dx)
    # per-oct faces: positions NG + 2k along d
    planes = [torch.stack([_planes(f * scale, d, c, 2) for f in fl[d]])
              for d in range(3)]
    out = (_interior_update(fl, scale, c).movedim(-1, 1),
           torch.stack(planes, dim=1).movedim(-1, 2))
    if want_flux:
        # every cell face: positions NG + j, j = 0..c
        out += (torch.stack([_planes(fl[d][0] * scale, d, c, 1)
                             for d in range(3)]).movedim(-1, 1),)
    return out


def oct_sweep_ref(uloc, ok, dt, cfg: HydroStatic, dx: float,
                  want_flux: bool = False):
    """Plain-PyTorch version of :func:`oct_sweep` (``_make_kernel``'s
    arithmetic).  Same arguments and results."""
    fl, scale = _sweep_fluxes(uloc, ok, dt, cfg, dx)
    corr = torch.empty((5, 3, 2) + tuple(uloc.shape[4:]), dtype=uloc.dtype,
                       device=uloc.device)
    for d in range(3):
        for side, pos in ((0, NG), (1, NG + 2)):
            ix = tuple(pos if dd == d else slice(NG, NG + 2)
                       for dd in range(3))
            for v in range(5):
                corr[v, d, side] = fl[d][v][ix].sum(dim=(0, 1)) * scale
    out = (_interior_update(fl, scale, 2), corr)
    if want_flux:
        # a cell's low face sits at its own slot, its high face at the
        # next slot along d
        core = (slice(NG, NG + 2),) * 3
        out += (torch.stack([torch.stack([
            (fl[d][0] * scale)[core],
            (torch.roll(fl[d][0], -1, d) * scale)[core]])
            for d in range(3)]),)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_CONSTS = [ctypes.c_float] * 9 + [ctypes.c_void_p]
_ARGTYPES = {
    "ramses_tile_sweep": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + _CONSTS,
    "ramses_oct_sweep": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + _CONSTS,
    "ramses_tile_sweep_info": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("oct_muscl"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/oct_muscl.cu`` (the tests also load a host build of it)."""
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(name, u, ok, dt, cfg, block, tile_major: bool):
    if not supports(cfg, u.dtype):
        raise ValueError(f"{name}: configuration outside the kernel's scope "
                         f"(cfg={cfg}, dtype={u.dtype})")
    b = block
    n = u.shape[1 if tile_major else -1] if u.dim() == 5 else 0
    want = (5, n, b, b, b) if tile_major else (5, b, b, b, n)
    if (u.device.type != "cuda" or tuple(u.shape) != want
            or not u.is_contiguous()):
        layout = (f"5, N, {b}, {b}, {b}" if tile_major
                  else f"5, {b}, {b}, {b}, N")
        raise ValueError(f"{name}: the batch must be a contiguous "
                         f"[{layout}] CUDA tensor, got {tuple(u.shape)} on "
                         f"{u.device}")
    if tuple(ok.shape) != want[1:] or ok.device != u.device:
        raise ValueError(f"{name}: ok must be {want[1:]} on {u.device}")
    if not (torch.is_tensor(dt) and dt.dim() == 0 and dt.device == u.device
            and dt.dtype == torch.float32):
        raise ValueError(f"{name}: dt must be a 0-d f32 tensor on the "
                         "batch's device")


def _consts(cfg: HydroStatic, dx: float):
    g = cfg.gamma
    return (fm._slope_factor(cfg), g, g - 1.0, 1.0 / (g - 1.0), cfg.smallr,
            cfg.smallc ** 2, cfg.smallp, cfg.smalle, dx)


def _run(name, u, ok, dt, cfg, dx, shift, want_flux):
    """One launch, counted under ``name`` or ``name + "_flux"``."""
    lib = _library()
    with torch.cuda.device(u.device):
        outs = call(lib, u, ok.to(torch.float32).contiguous(), dt, cfg, dx,
                    shift, want_flux,
                    torch.cuda.current_stream(u.device).cuda_stream)
    launches[name + ("_flux" if want_flux else "")] += 1
    return outs


def launch_info(shift: int, n: int, riemann: str = "llf", chunk: int = 0,
                lib=None) -> dict:
    """K3's launch on the current device for ``n`` tiles at ``shift``: the
    x planes of a tile a block takes (``chunk``, chosen by the kernel when
    0), blocks an SM resident, dynamic shared memory, registers and local
    (spill) bytes a thread, threads a block, and every chunk that fits a
    block's shared memory (``chunks``; a chunk that does not fit raises).
    ``lib`` defaults to the card's build."""
    lib = _library() if lib is None else bind(lib)
    out = (ctypes.c_int * 7)()
    err = lib.ramses_tile_sweep_info(shift, n, fm._RIEMANN[riemann], chunk,
                                     out)
    if err:
        raise RuntimeError(f"tile_sweep launch info failed (cudaError {err})")
    return {"chunk": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2],
            "registers": out[3], "local_bytes": out[4], "threads": out[5],
            "chunks": [cx for cx in (1, 2, 4, 8, 16) if out[6] & cx]}


def call(lib, u, okf, dt, cfg, dx, shift, want_flux, stream=None,
         chunk: int = 0):
    """One call of K3 (``shift`` an int) or K2 (``shift`` None) in ``lib``
    (a build of ``csrc/oct_muscl.cu`` with :func:`bind` applied) on checked
    arguments: ``okf`` the refined mask as f32 0/1, ``dt`` a 0-d f32
    tensor.  ``chunk`` (K3): the x planes of a tile a block updates, 0 to
    let the kernel choose them from N and the card; the result does not
    depend on it.  Returns ``(du, corr)``, with ``want_flux`` ``(du, corr,
    phi)``; outputs go on ``u``'s device.  Raises on an error it returns."""
    riemann = fm._RIEMANN[cfg.riemann]
    if shift is None:
        n = u.shape[-1]
        outs = (u.new_empty((5, 2, 2, 2, n)), u.new_empty((5, 3, 2, n)))
        if want_flux:
            outs += (u.new_empty((3, 2, 2, 2, 2, n)),)
        fn, ints, name = lib.ramses_oct_sweep, (n, riemann), "oct_sweep"
    else:
        n = u.shape[1]
        c = 1 << (shift + 1)
        outs = (u.new_empty((5, n, c, c, c)),
                u.new_empty((5, 3, n, c // 2 + 1, c, c)))
        if want_flux:
            outs += (u.new_empty((3, n, c + 1, c, c)),)
        if u.data_ptr() % 16 or okf.data_ptr() % 16:
            raise ValueError("tile_sweep: the batch and its mask must be "
                             "16-byte aligned (the kernel's vector loads)")
        fn, name = lib.ramses_tile_sweep, "tile_sweep"
        ints = (shift, n, riemann, chunk)
    err = fn(u.data_ptr(), okf.data_ptr(), dt.data_ptr(), outs[0].data_ptr(),
             outs[1].data_ptr(), outs[2].data_ptr() if want_flux else None,
             *ints, *_consts(cfg, dx), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
    return outs


def tile_sweep(ut, ok, dt, cfg: HydroStatic, dx: float, shift: int,
               want_flux: bool = False):
    """Fused partial-level sweep on a blocked tile batch.

    ``ut``: ``[5, N, td, td, td]`` f32 contiguous (``td = 2**(shift+1) +
    4``); ``ok``: ``[N, td, td, td]`` refined-cell mask (0/1); ``dt``: a
    0-d tensor on ``ut``'s device, read by the kernel through a pointer.
    Returns ``(du [5, N, c, c, c], corrp [5, 3, N, c//2+1, c, c])``,
    fluxes ×dt/dx, and with ``want_flux`` also ``phip [3, N, c+1, c,
    c]``.  A CPU tensor runs :func:`tile_sweep_ref`; a CUDA tensor
    launches the kernel (counted in ``launches["tile_sweep"]``, or
    ``["tile_sweep_flux"]``) or raises.
    """
    if ut.device.type == "cpu":
        return tile_sweep_ref(ut, ok, dt, cfg, dx, shift, want_flux)
    if shift not in SHIFTS:
        raise ValueError(f"tile_sweep: shift {shift} outside {SHIFTS}")
    _check("tile_sweep", ut, ok, dt, cfg, (1 << (shift + 1)) + 2 * NG, True)
    return _run("tile_sweep", ut, ok, dt, cfg, dx, shift, want_flux)


def oct_sweep(uloc, ok, dt, cfg: HydroStatic, dx: float,
              want_flux: bool = False):
    """Fused partial-level sweep on a per-oct stencil batch.

    ``uloc``: ``[5, 6, 6, 6, N]`` f32 contiguous; ``ok``: ``[6, 6, 6, N]``
    refined-cell mask (0/1); ``dt``: a 0-d tensor on ``uloc``'s device.
    Returns ``(du [5, 2, 2, 2, N], corr [5, 3, 2, N])``, fluxes ×dt/dx, and
    with ``want_flux`` also ``phi [3, 2, 2, 2, 2, N]``.  A CPU tensor runs
    :func:`oct_sweep_ref`; a CUDA tensor launches the kernel (counted in
    ``launches["oct_sweep"]``, or ``["oct_sweep_flux"]``) or raises.
    """
    if uloc.device.type == "cpu":
        return oct_sweep_ref(uloc, ok, dt, cfg, dx, want_flux)
    _check("oct_sweep", uloc, ok, dt, cfg, 6, False)
    return _run("oct_sweep", uloc, ok, dt, cfg, dx, None, want_flux)
