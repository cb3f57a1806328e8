"""Device-resident regrid migration (PyTorch).

Port of ``ramses_tpu/amr/device_regrid.py``.  The host path
(``maps.build_prolong_maps`` + ``AmrSim._migrate_level``) builds numpy row
tables for every changed level of every regrid.  This module derives the
same survivor-copy and new-oct prolongation maps on the device, straight
from the sorted Morton key arrays of the new level, the old level and the
new coarser level:

* survivors: a binary search of the new level's keys in the old level's
  (``Octree.lookup_keys`` is the same search on the host);
* father cells: a level-l oct key is its father cell's level-(l-1) Morton
  key, so the covering oct is ``key >> ndim`` and the child slot the
  bit-reversed low ``ndim`` bits of the key;
* the father's face neighbours: decode, step one cell, map through the
  boundaries (``tree.map_coords``: periodic wrap, reflecting mirror,
  outflow clamp, on the level's ``cell_dims``, non-cubic roots included),
  encode and search again; a missing neighbour or one across a reflecting
  face takes the father cell itself.

:func:`regrid_maps` computes those maps: K7 (``csrc/regrid_maps.cu``, one
thread an oct, its searches in lockstep over keys staged in shared memory)
on a CUDA tensor, :func:`regrid_maps_ref` (the plain torch formulation of
``_migrate_level_jit``'s map lines) on a CPU one.  The maps
are integers, so the two agree bit for bit.  :func:`migrate_level` then
interpolates with ``amr/kernels.interp_cells`` and selects with ``where``,
as the JAX package does: ``interp_cells`` is elementwise per request row,
so the migrated rows are bitwise the host path's.

Keys are int64.  JAX spreads them in uint64; every mask of :data:`_TABS`
is below 2^63 and :func:`keys_fit` keeps 2D keys within 62 bits, so int64
arithmetic with the same masks gives the same bits (the shifts never carry
into the sign bit that a mask keeps).  The hierarchy takes the host path
by configuration where :func:`keys_fit` fails, never after a failure.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ramses_tpu_torch.amr import kernels as K
from ramses_tpu_torch.amr.tree import cell_offsets

# spread-mask ladders keyed by ndim: premask + (shift, mask) steps, the
# 64-bit ladders of amr/keys.py; compact runs the same table in reverse
_TABS = {
    2: (0xFFFFFFFF,
        ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
         (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
         (1, 0x5555555555555555))),
    3: (0x1FFFFF,
        ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
         (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
         (2, 0x1249249249249249))),
}

# pad key of the sentinel-padded sorted arrays: above every real key, so
# the arrays stay sorted, and never equal to one under keys_fit
SENTINEL = int(np.iinfo(np.int64).max)

# K7 launches since the count was last reset (the main path's proof that
# the regrid went through the kernel)
launches = 0


def keys_fit(ndim: int, lvl: int, root=None) -> bool:
    """Can every key and coordinate level ``lvl`` needs fit an int64 key
    (the JAX package's x64 limits)?"""
    root = tuple(root or ()) or (1,) * ndim
    n = max(root[:ndim]) << max(lvl - 1, 0)       # cells a dim at lvl-1
    bits = max(int(n - 1).bit_length(), 1)
    return bits <= {1: 62, 2: 31, 3: 20}[ndim]


def upload_keys(keys: np.ndarray, pad: int, device) -> torch.Tensor:
    """Sorted level keys padded to ``pad`` with :data:`SENTINEL`, on the
    device."""
    out = np.full(pad, SENTINEL, dtype=np.int64)
    n = min(len(keys), pad)
    out[:n] = keys[:n]
    return torch.as_tensor(out, device=device)


def _spread(x, ndim: int):
    pre, tab = _TABS[ndim]
    x = x & pre
    for s, m in tab:
        x = (x | (x << s)) & m
    return x


def _compact(x, ndim: int):
    pre, tab = _TABS[ndim]
    x = x & tab[-1][1]
    for i in range(len(tab) - 1, 0, -1):
        x = (x | (x >> tab[i][0])) & tab[i - 1][1]
    return (x | (x >> tab[0][0])) & pre


def _encode(c, ndim: int):
    """``keys.encode`` on int64 tensors: coords [n, ndim] → keys [n]."""
    if ndim == 1:
        return c[:, 0]
    k = _spread(c[:, 0], ndim)
    for d in range(1, ndim):
        k = k | (_spread(c[:, d], ndim) << d)
    return k


def _decode(k, ndim: int):
    """``keys.decode`` on int64 tensors: keys [n] → coords [n, ndim]."""
    if ndim == 1:
        return k[:, None]
    return torch.stack([_compact(k >> d, ndim) for d in range(ndim)], dim=1)


def _bitrev_low(k, ndim: int):
    """Child slot within the father oct: the host ``f_off*2 +
    (coords[:, d] & 1)`` fold over ascending d, read off the low
    interleaved key bits."""
    off = torch.zeros_like(k)
    for d in range(ndim):
        off = off * 2 + ((k >> d) & 1)
    return off


def _map_coords(cc, bc_kinds, dims, ndim: int):
    """``tree.map_coords`` on int64 tensors: mapped coords and the
    per-dim 'crossed a reflecting face' flags."""
    outs, refls = [], []
    for d in range(ndim):
        n = int(dims[d])
        lo, hi = bc_kinds[d]
        x = cc[:, d]
        if lo == 0 and hi == 0:
            outs.append(torch.remainder(x, n))
            refls.append(torch.zeros_like(x, dtype=torch.bool))
            continue
        below, above = x < 0, x >= n
        r = torch.zeros_like(x, dtype=torch.bool)
        if lo == 1:
            x = torch.where(below, -1 - x, x)
            r = r | below
        elif lo != 0:
            x = torch.where(below, 0, x)
        if hi == 1:
            x = torch.where(above, 2 * n - 1 - x, x)
            r = r | above
        elif hi != 0:
            x = torch.where(above, n - 1, x)
        outs.append(torch.clamp(x, 0, n - 1))
        refls.append(r)
    return torch.stack(outs, dim=1), torch.stack(refls, dim=1)


def _find(sorted_keys, ks):
    """(clipped position, exact hit) of ``ks`` in a sorted key array: the
    device half of ``Octree.lookup_keys``."""
    pos = torch.searchsorted(sorted_keys, ks)
    pos = torch.clamp(pos, 0, sorted_keys.shape[0] - 1)
    return pos, sorted_keys[pos] == ks


def regrid_maps_ref(new_keys, old_keys, coarse_keys, ndim: int,
                    bc_kinds, dims):
    """The plain version of K7: for each (sentinel-padded) new-level key,
    ``(pos, kept, f_cell, nb)``: its clipped position in the old level's
    keys and whether it survived there (a real oct only), its father's
    flat cell at the coarser level, and the father's face neighbours
    ``[n, ndim, 2]`` (the father itself where a neighbour is missing or
    crossed a reflecting face).  ``dims``: the lvl-1 cells a dim."""
    ttd = 1 << ndim
    valid = new_keys < SENTINEL
    pos, kept = _find(old_keys, new_keys)
    kept = kept & valid
    f_pos, _ = _find(coarse_keys, new_keys >> ndim)
    f_cell = f_pos * ttd + _bitrev_low(new_keys, ndim)
    og = _decode(new_keys, ndim)                  # cell coords at lvl-1
    nb = []
    for d in range(ndim):
        cols = []
        for s in (-1, +1):
            nc = og.clone()
            nc[:, d] += s
            ncm, nrefl = _map_coords(nc, bc_kinds, dims, ndim)
            nkey = _encode(ncm, ndim)
            n_pos, found = _find(coarse_keys, nkey >> ndim)
            bad = ~found | nrefl.any(dim=1)
            cols.append(torch.where(bad, f_cell,
                                    n_pos * ttd + _bitrev_low(nkey, ndim)))
        nb.append(torch.stack(cols, dim=1))
    return pos, kept, f_cell, torch.stack(nb, dim=1)


def regrid_maps(new_keys, old_keys, coarse_keys, ndim: int, bc_kinds, dims):
    """:func:`regrid_maps_ref`'s maps: on a CPU tensor the plain version, on
    a CUDA tensor one K7 launch (counted in :data:`launches`) or an
    exception."""
    if new_keys.device.type == "cpu":
        return regrid_maps_ref(new_keys, old_keys, coarse_keys, ndim,
                               bc_kinds, dims)
    return _launch(new_keys, old_keys, coarse_keys, ndim, bc_kinds, dims)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 5)


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("regrid_maps"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/regrid_maps.cu``."""
    fn = lib.ramses_regrid_maps
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.ramses_regrid_maps_staged.argtypes = [ctypes.c_longlong] * 2
        lib.ramses_regrid_maps_staged.restype = ctypes.c_int
        lib.ramses_regrid_empty.argtypes = [ctypes.c_longlong,
                                            ctypes.c_void_p]
        lib.ramses_regrid_empty.restype = ctypes.c_int
    return lib


def staged(lib, n_old: int, n_c: int) -> bool:
    """Whether K7 (the loaded build ``lib``) stages ``n_old`` old and
    ``n_c`` coarse keys whole in shared memory; else it reads them
    through L1."""
    return bool(lib.ramses_regrid_maps_staged(n_old, n_c))


def _launch(new_keys, old_keys, coarse_keys, ndim, bc_kinds, dims):
    """One K7 launch, counted in :data:`launches`; raises on bad arguments
    and when the build or the launch fails."""
    global launches
    dev = new_keys.device
    for name, t in (("new_keys", new_keys), ("old_keys", old_keys),
                    ("coarse_keys", coarse_keys)):
        if t.dtype != torch.int64 or t.dim() != 1 or t.device != dev \
                or not t.is_contiguous() or dev.type != "cuda":
            raise ValueError(f"regrid_maps: {name} must be a contiguous 1-D "
                             f"int64 tensor on the CUDA device of new_keys, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not new_keys.numel():
        return call(None, new_keys, old_keys, coarse_keys, ndim, bc_kinds,
                    dims)
    lib = _library()
    with torch.cuda.device(dev):
        out = call(lib, new_keys, old_keys, coarse_keys, ndim, bc_kinds,
                   dims, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out


def call(lib, new_keys, old_keys, coarse_keys, ndim: int, bc_kinds, dims,
         stream=None):
    """One call of ``ramses_regrid_maps`` in the loaded build ``lib`` on
    contiguous int64 key tensors (the card's build on CUDA tensors, or a
    host build of the source on CPU ones); returns ``(pos, kept, f_cell,
    nb)`` and raises on the error the call returns.  No new keys: nothing
    is called."""
    if not old_keys.numel() or not coarse_keys.numel():
        raise ValueError("regrid_maps: the old and coarse key arrays must "
                         "hold at least one (sentinel) key")
    if ndim not in (1, 2, 3):
        raise ValueError(f"regrid_maps: ndim {ndim}")
    n = new_keys.numel()
    pos = torch.empty_like(new_keys)
    kept = torch.empty(n, dtype=torch.bool, device=new_keys.device)
    f_cell = torch.empty_like(new_keys)
    nb = new_keys.new_empty((n, ndim, 2))
    if not n:
        return pos, kept, f_cell, nb
    kinds = [int(k) for d in range(3)
             for k in (bc_kinds[d] if d < ndim else (0, 0))]
    dd = [int(dims[d]) if d < ndim else 1 for d in range(3)]
    err = lib.ramses_regrid_maps(
        new_keys.data_ptr(), n, old_keys.data_ptr(), old_keys.numel(),
        coarse_keys.data_ptr(), coarse_keys.numel(), ndim, *kinds, *dd,
        pos.data_ptr(), kept.data_ptr(), f_cell.data_ptr(), nb.data_ptr(),
        stream)
    if err:
        raise RuntimeError(f"regrid_maps kernel launch failed (cudaError "
                           f"{err})")
    return pos, kept, f_cell, nb


def migrate_level(old_u, u_coarse, new_keys, old_keys, coarse_keys,
                  ncell_pad: int, ndim: int, bc_kinds, dims, cfg,
                  itype: int):
    """One level's regrid migration with its maps derived on the device.

    ``new_keys``/``old_keys``/``coarse_keys``: sentinel-padded sorted key
    arrays (:func:`upload_keys`) of the new level, the old level and the
    new coarser level; ``old_u`` the old level's rows (None where the level
    is new), ``u_coarse`` the migrated coarser level's; ``dims`` the lvl-1
    cells a dim.  Returns the migrated ``[ncell_pad, nvar]`` rows: kept
    octs copied, new octs interpolated, pad rows zero, bitwise the host
    path's."""
    ttd = 1 << ndim
    dev, dtype = u_coarse.device, u_coarse.dtype
    if old_u is None:
        old_u = u_coarse.new_zeros((ttd, u_coarse.shape[1]))
    pos, kept, f_cell, nb = regrid_maps(new_keys, old_keys, coarse_keys,
                                        ndim, bc_kinds, dims)
    valid = new_keys < SENTINEL
    sgn_tab = torch.as_tensor((cell_offsets(ndim) * 2 - 1).astype(np.float64),
                              dtype=dtype, device=dev)
    noct = ncell_pad // ttd
    vals = K.interp_cells(u_coarse, f_cell.repeat_interleave(ttd),
                          nb.repeat_interleave(ttd, dim=0),
                          sgn_tab.repeat(noct, 1), cfg, itype=itype)
    # a dropped oct's clipped position may lie past the old rows: gather
    # row 0 for it, which the selection discards
    src = (torch.where(kept, pos, 0)[:, None] * ttd
           + torch.arange(ttd, device=dev)).reshape(-1)
    copied = old_u.index_select(0, src)
    keep = kept.repeat_interleave(ttd)[:, None]
    live = valid.repeat_interleave(ttd)[:, None]
    return torch.where(keep, copied.to(old_u.dtype),
                       torch.where(live, vals.to(old_u.dtype), 0))
