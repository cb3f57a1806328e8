"""The MHD constrained-transport step: the CUDA kernel and its plain version.

Port of ``ramses_tpu/mhd/pallas_ct.py`` (``ct_step_slab``): one whole CT
step — ``mhd/uniform.step_padded`` — on a ghost-padded box.  On the TPU it
is one VMEM-resident block behind a size gate; here it is the
hand-written kernel ``csrc/mhd_ct.cu``, one launch a call: each block
marches a tile of columns along axis 0 and keeps every intermediate
(primitives; slopes, Hancock predictor and half-dt face field; face
fluxes; edge EMFs) in shared memory or registers, so device memory sees
the padded inputs and the interior outputs only.  Like the TPU kernel it covers every
configuration ``step_padded`` takes in f32: 1D/2D/3D, each 1D solver
(llf, hll, hlld, roe, upwind), each corner solver (average, llf, roe,
upwind, hll, hlla, hlld), slope types 0/1/2/7/8 and up to
:data:`MAX_PASSIVE` passive scalars.  It takes the padded contract — cells
padded by 2, faces by 3, with an optional padded refined mask and EMF
override — and returns only the interior, which is all any caller keeps.

:func:`ct_step_slab` launches the kernel for a CUDA tensor and runs
:func:`ct_step_slab_ref` (``step_padded`` then unpadding) for a CPU
tensor.  It never falls back: on a CUDA tensor it launches the kernel or
raises.  :func:`supports` is the kernel's scope; callers take
``step_padded`` outside it, by configuration only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ramses_tpu_torch.mhd import uniform as mu
from ramses_tpu_torch.mhd.core import MhdStatic, NCOMP

# Kernel launches (wrapper calls that launched the kernel) since the count
# was last reset; the plain version does not count.
launches = 0

_RIEMANN = {"llf": 0, "hll": 1, "hlld": 2, "roe": 3, "upwind": 4}
_RIEMANN2D = {"average": 0, "llf": 1, "roe": 2, "upwind": 3, "hll": 4,
              "hlla": 5, "hlld": 6}
_SLOPES = (0, 1, 2, 7, 8)
# The largest passive count the kernel takes (MAX_PASSIVE in
# csrc/mhd_ct.cu); more passives run step_padded by configuration.
MAX_PASSIVE = 4
NG = mu.NGHOST


def supports(cfg: MhdStatic, shape, dtype) -> bool:
    """True when the kernel covers this configuration: 1D, 2D or 3D with a
    matching shape, f32, the untransposed layout (no trailing batch), any
    1D and corner solver, slope types 0/1/2/7/8 and at most
    :data:`MAX_PASSIVE` passives."""
    if cfg.ndim not in (1, 2, 3) or len(shape) != cfg.ndim:
        return False
    if not 0 <= cfg.npassive <= MAX_PASSIVE or cfg.trailing_batch:
        return False
    if cfg.riemann not in _RIEMANN or cfg.riemann2d not in _RIEMANN2D:
        return False
    if cfg.slope_type not in _SLOPES or any(n < 1 for n in shape):
        return False
    return dtype == torch.float32


def _pairs(nd: int):
    return [(d1, d2) for d1 in range(nd) for d2 in range(d1 + 1, nd)]


def _dx3(dx, nd: int):
    dx = tuple(dx) if isinstance(dx, (list, tuple)) else (dx,) * nd
    return [float(x) for x in dx] + [1.0] * (3 - nd)


def ct_step_slab_ref(up, bfp_ext, dt, dx: Sequence[float], cfg: MhdStatic,
                     okp=None, ovr: Optional[dict] = None):
    """Plain-PyTorch version of :func:`ct_step_slab`: ``step_padded`` on
    the padded arrays, then the interior.  Same arguments and results."""
    nd = cfg.ndim
    dx = _dx3(dx, nd)[:nd]
    dt = torch.as_tensor(dt, dtype=up.dtype, device=up.device)
    un, bfn = mu.step_padded(cfg, dx, up, bfp_ext, dt, okp=okp, ovr=ovr)
    return mu._unpad(un, nd), torch.stack([mu._unpad(b, nd) for b in bfn])


def ct_step_slab(up, bfp_ext, dt, dx: Sequence[float], cfg: MhdStatic,
                 okp=None, ovr: Optional[dict] = None):
    """One CT step of a padded box.

    ``up`` [8 + npassive, \\*sp+4] padded cells (raw B slots, ignored:
    the cell field is the face average), ``bfp_ext`` [3, \\*sp+6] padded
    low faces, ``dt`` a 0-d tensor on ``up``'s device (or a float),
    ``dx`` per-dim cell sizes (or one float), ``okp`` optional padded
    refined mask [\\*sp+4], ``ovr`` optional dict (d1,d2) → (padded mask,
    padded values), each [\\*sp+4]; a pair it lacks keeps its computed
    EMF (1D has no pairs).
    Returns the interior ``(un [8 + npassive, *sp], bfn [3, *sp])``.

    A CPU tensor runs :func:`ct_step_slab_ref`; a CUDA tensor launches the
    kernel or raises (outside :func:`supports` too)."""
    if up.device.type == "cpu":
        return ct_step_slab_ref(up, bfp_ext, dt, dx, cfg, okp=okp, ovr=ovr)
    return _launch(up, bfp_ext, dt, dx, cfg, okp, ovr)


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 13 + [ctypes.c_int] + [ctypes.c_void_p])


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("mhd_ct"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/mhd_ct.cu`` (the tests also load a host build of it)."""
    fn = lib.ramses_mhd_ct
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.ramses_mhd_ct_info.argtypes = ([ctypes.c_int] * 4
                                           + [ctypes.POINTER(ctypes.c_int)])
        lib.ramses_mhd_ct_info.restype = ctypes.c_int
    return lib


def launch_info(cfg: MhdStatic, lib=None) -> dict:
    """The kernel's launch for ``cfg`` on the current device: threads and
    dynamic shared memory a block, blocks an SM resident, registers and
    local (spill) bytes a thread.  ``lib`` defaults to the card's build."""
    lib = _library() if lib is None else bind(lib)
    out = (ctypes.c_int * 5)()
    err = lib.ramses_mhd_ct_info(cfg.ndim, _RIEMANN[cfg.riemann],
                                 _RIEMANN2D[cfg.riemann2d], cfg.npassive, out)
    if err:
        raise RuntimeError(f"mhd_ct launch info failed (cudaError {err})")
    return {"blocks_per_sm": out[0], "smem_bytes": out[1],
            "registers": out[2], "local_bytes": out[3], "threads": out[4]}


def _launch(up, bfp_ext, dt, dx, cfg, okp, ovr):
    """One call of the kernel, counted in ``launches``.  Raises on a
    configuration outside :func:`supports`, on bad arguments, and when
    the build or a launch fails."""
    global launches
    nd = cfg.ndim
    sp = tuple(int(n) - 2 * NG for n in up.shape[1:])
    if not supports(cfg, sp, up.dtype):
        raise ValueError("ct_step_slab: configuration outside the kernel's "
                         f"scope (cfg={cfg}, shape={sp}, dtype={up.dtype})")
    dev = up.device
    nvar = cfg.nvar
    if (up.device.type != "cuda" or up.dim() != nd + 1
            or up.shape[0] != nvar or not up.is_contiguous()):
        raise ValueError("ct_step_slab: up must be a contiguous "
                         f"[{nvar}, *sp+4] CUDA tensor")
    if (tuple(bfp_ext.shape) != (NCOMP,) + tuple(n + 2 * NG + 2 for n in sp)
            or bfp_ext.device != dev or bfp_ext.dtype != up.dtype
            or not bfp_ext.is_contiguous()):
        raise ValueError("ct_step_slab: bfp_ext must be a contiguous "
                         "[3, *sp+6] tensor on up's device")
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    if dt.dim() != 0:
        raise ValueError("ct_step_slab: dt must be a scalar")
    pshape = tuple(up.shape[1:])
    okf = None
    if okp is not None:
        if tuple(okp.shape) != pshape or okp.device != dev:
            raise ValueError("ct_step_slab: okp must be [*sp+4] on up's "
                             "device")
        okf = okp.to(torch.float32).contiguous()
    ovm = ovv = None
    if ovr is not None:
        pairs = _pairs(nd)
        zeros = torch.zeros(pshape, dtype=torch.float32, device=dev)
        for p, (m, v) in ovr.items():
            if (p not in pairs or tuple(m.shape) != pshape
                    or tuple(v.shape) != pshape):
                raise ValueError(f"ct_step_slab: override {p} must be a "
                                 "pair (d1 < d2) with [*sp+4] mask and "
                                 "values")
        if pairs:                       # 1D has no edges to override
            ovm = torch.stack([ovr[p][0].to(dev, torch.float32) if p in ovr
                               else zeros for p in pairs]).contiguous()
            ovv = torch.stack([ovr[p][1].to(dev, torch.float32) if p in ovr
                               else zeros for p in pairs]).contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        out = call(lib, up, bfp_ext, dt, dx, cfg, okf, ovm, ovv,
                   torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out


def call(lib, up, bfp_ext, dt, dx, cfg, okf=None, ovm=None, ovv=None,
         stream=None, chunk: int = 0):
    """One call of the C entry of ``lib`` (a build of ``csrc/mhd_ct.cu``
    with :func:`bind` applied) on checked arguments: ``dt`` a 0-d f32
    tensor, ``okf`` the padded refined mask as f32 0/1, ``ovm``/``ovv``
    the stacked override [npair, \\*sp+4] in f32, each or None.
    ``chunk``: the rows of axis 0 a block updates, 0 to let the kernel
    choose them from the box and the card; the result does not depend on
    it.  Outputs go on ``up``'s device; raises on an error it returns."""
    nd = cfg.ndim
    pshape = tuple(up.shape[1:])
    sp = tuple(n - 2 * NG for n in pshape)
    nvar = cfg.nvar
    dev = up.device
    un = torch.empty((nvar,) + sp, dtype=torch.float32, device=dev)
    bfn = torch.empty((NCOMP,) + sp, dtype=torch.float32, device=dev)
    n3 = list(sp) + [1] * (3 - nd)
    dx3 = _dx3(dx, nd)
    g = cfg.gamma
    slope = (float(cfg.slope_type) if cfg.slope_type in (1, 2)
             else float(cfg.slope_theta))
    err = lib.ramses_mhd_ct(
        up.data_ptr(), bfp_ext.data_ptr(),
        okf.data_ptr() if okf is not None else None,
        ovm.data_ptr() if ovm is not None else None,
        ovv.data_ptr() if ovv is not None else None,
        dt.data_ptr(), un.data_ptr(), bfn.data_ptr(), nd, *n3,
        cfg.npassive,
        _RIEMANN[cfg.riemann], _RIEMANN2D[cfg.riemann2d],
        cfg.slope_type, slope, g, g - 1.0, g - 2.0, 1.0 / (g - 1.0),
        cfg.smallr, cfg.smallc, cfg.smallc ** 2,
        cfg.smallr * cfg.smallc ** 2,
        cfg.smallc ** 2 / cfg.gamma / (cfg.gamma - 1.0),
        *dx3, chunk, stream)
    if err:
        raise RuntimeError(f"mhd_ct kernel launch failed (cudaError {err})")
    return un, bfn
