"""Per-level gather/scatter index maps (host, numpy).

The port's own copy of ``ramses_tpu/amr/maps.py`` up to the prolongation
maps; the gravity maps are not ported yet.

These are the TPU equivalents of the reference's per-step tree walks: the
6^ndim stencil gather of ``godfine1`` (``hydro/godunov_fine.f90:553-676``),
the buffer-cell interpolation requests (``:583-593``), the coarse-level
flux-correction targets (``nbor(ind_grid, 2*idim-1/2)``, ``:795-910``), and
the leaf→father restriction of ``upload_fine`` (``hydro/interpol_hydro.f90:5``).
Where the reference re-walks the tree for every nvector batch every step,
we materialize int32 index maps once per regrid (the ``build_comm``
amortization pattern, ``amr/virtual_boundaries.f90:1286``) and the per-step
work becomes pure XLA gathers/scatter-adds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ramses_tpu_torch.amr import keys as kmod
from ramses_tpu_torch.amr.tree import Octree, cell_offsets, map_coords


def bucket(n: int, lo: int = 16) -> int:
    """Pad count to power-of-2 buckets to bound jit recompiles
    (SURVEY.md §7 hard part 2)."""
    if n <= lo:
        return lo
    return 1 << int(np.ceil(np.log2(n)))


@dataclass
class LevelMaps:
    """All index maps of one level (numpy; hierarchy moves them to device)."""
    lvl: int
    noct: int
    noct_pad: int
    ni: int
    ni_pad: int
    # gather: src row for each stencil cell, into
    # concat(cells [ncell_pad], interp [ni_pad], trash [1])
    stencil_src: np.ndarray          # [noct_pad, 6^d] int32
    vsgn: Optional[np.ndarray]       # [noct_pad, 6^d] uint8 bitmask, or None
    ok_ref: np.ndarray               # [noct_pad, 6^d] bool: cell refined
    # interpolation requests (absent at levelmin: ni=0)
    interp_cell: np.ndarray          # [ni_pad] int32 flat cell idx at lvl-1
    interp_nb: np.ndarray            # [ni_pad, ndim, 2] int32 (left,right)
    interp_sgn: np.ndarray           # [ni_pad, ndim] int8 (±1 child offset)
    # coarse flux-correction targets (absent at levelmin)
    corr_idx: np.ndarray             # [noct_pad, ndim, 2] int32, -1 invalid
    # restriction (upload_fine) from lvl+1 into this level
    nref: int
    nref_pad: int
    ref_cell: np.ndarray             # [nref_pad] int32 flat cell idx, -1 pad
    son_oct: np.ndarray              # [nref_pad] int32 oct idx at lvl+1
    valid_oct: np.ndarray            # [noct_pad] bool
    # COMPLETE level (covers the whole box, e.g. the base level): the
    # sweep runs dense (roll-based uniform kernel) instead of through the
    # 6^d stencil gather — stencil/interp/corr maps above are then empty.
    complete: bool = False
    perm: Optional[np.ndarray] = None      # [ncell] flat row → dense ravel
    inv_perm: Optional[np.ndarray] = None  # [ncell] dense ravel → flat row
    ok_dense: Optional[np.ndarray] = None  # [ncell] bool refined, dense order
    # same mask in FLAT row order (shardable over contiguous row chunks
    # for the slab-sharded dense path, parallel/dense_slab.py)
    ok_flat: Optional[np.ndarray] = None   # [ncell] bool refined, flat order

    @property
    def ndim(self) -> int:
        return self.interp_sgn.shape[1]

    @property
    def ncell_pad(self) -> int:
        return self.noct_pad * 2 ** self.ndim


def stencil_offsets(ndim: int) -> np.ndarray:
    """[6^ndim, ndim] stencil offsets in row-major order, range 0..5
    (stencil cell coords = 2*og - 2 + offset)."""
    return np.indices((6,) * ndim).reshape(ndim, -1).T.astype(np.int64)


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[:len(a)] = a
    return out


def _restriction_maps(tree: Octree, lvl: int):
    """upload_fine source/target maps: (nref, nref_pad, ref_cell, son_oct,
    refined_mask-or-None).

    Built from the FINE level's oct list (every lvl+1 oct covers exactly
    one lvl cell), O(noct(lvl+1)) instead of a lookup over every lvl
    cell — the regrid hot path."""
    if not tree.has(lvl + 1):
        return 0, 8, np.full(8, -1, dtype=np.int32), \
            np.zeros(8, dtype=np.int32), None
    ndim = tree.ndim
    twotondim = 1 << ndim
    ref_all = tree.son_parent_cells(lvl)       # flat lvl cell per son oct
    son_all = np.nonzero(ref_all >= 0)[0]
    ref_idx = ref_all[son_all]
    order = np.argsort(ref_idx, kind="stable")  # deterministic map order
    ref_idx = ref_idx[order]
    son = son_all[order]                        # son octs in tree order
    nref = len(ref_idx)
    nref_pad = bucket(nref, 8)
    rmask = np.zeros(tree.noct(lvl) * twotondim, dtype=bool)
    rmask[ref_idx] = True
    return nref, nref_pad, _pad_rows(ref_idx.astype(np.int32), nref_pad, -1), \
        _pad_rows(son.astype(np.int32), nref_pad), rmask


def _interp_requests(tree: Octree, lvl: int, uniq_keys: np.ndarray,
                     bc_kinds: List[tuple]):
    """Coarse-cell interpolation maps for a sorted list of unique missing
    fine-cell Morton keys: (interp_cell, interp_nb, interp_sgn).

    Shared by the 6^d stencil maps and the blocked tile maps so the two
    gather paths interpolate bitwise-identical ghost values."""
    ndim = tree.ndim
    twotondim = 1 << ndim
    ucoords = kmod.decode(uniq_keys, ndim)             # fine cell coords
    ni = len(uniq_keys)
    ccoarse = ucoords >> 1                             # cell coords at lvl-1
    f_oct = tree.lookup(lvl - 1, ccoarse >> 1)
    if (f_oct < 0).any():
        raise RuntimeError(
            f"2:1 gradedness violated at level {lvl}: "
            f"{int((f_oct < 0).sum())} missing father octs")
    f_off = np.zeros(ni, dtype=np.int64)
    for d in range(ndim):
        f_off = f_off * 2 + (ccoarse[:, d] & 1)
    interp_cell = (f_oct * twotondim + f_off).astype(np.int32)
    interp_sgn = ((ucoords & 1) * 2 - 1).astype(np.int8)
    interp_nb = np.empty((ni, ndim, 2), dtype=np.int32)
    for d in range(ndim):
        for side, s in ((0, -1), (1, +1)):
            nc = ccoarse.copy()
            nc[:, d] += s
            ncm, nrefl = map_coords(nc, lvl - 1, bc_kinds, ndim,
                                    dims=tree.cell_dims(lvl - 1))
            n_oct = tree.lookup(lvl - 1, ncm >> 1)
            n_off = np.zeros(ni, dtype=np.int64)
            for d2 in range(ndim):
                n_off = n_off * 2 + (ncm[:, d2] & 1)
            flat = n_oct * twotondim + n_off
            # neighbour absent at lvl-1 (grade transition) or mirrored:
            # fall back to the centre cell (zero slope contribution) —
            # the reference walks up the tree instead
            # (amr/nbors_utils.f90:404); this degrades to 1st order
            # locally, which the minmod limiter tolerates.
            bad = (n_oct < 0) | nrefl.any(axis=1)
            interp_nb[:, d, side] = np.where(bad, interp_cell,
                                             flat).astype(np.int32)
    return interp_cell, interp_nb, interp_sgn


def build_level_maps(tree: Octree, lvl: int, bc_kinds: List[tuple],
                     noct_pad: Optional[int] = None) -> LevelMaps:
    ndim = tree.ndim
    twotondim = 1 << ndim
    lev = tree.levels[lvl]
    noct = lev.noct
    noct_pad = noct_pad or bucket(noct)
    ncell_pad = noct_pad * twotondim
    if noct == int(np.prod(tree.oct_dims(lvl))):
        return _build_complete_level_maps(tree, lvl, noct, noct_pad)
    soff = stencil_offsets(ndim)                       # [6^d, ndim]
    ns = len(soff)

    # --- stencil cell coords, BC-mapped ---
    fc = (2 * lev.og[:, None, :] - 2 + soff[None, :, :]).reshape(-1, ndim)
    mapped, refl = map_coords(fc, lvl, bc_kinds, ndim,
                              dims=tree.cell_dims(lvl))
    oc = mapped >> 1
    off = np.zeros(len(mapped), dtype=np.int64)
    for d in range(ndim):
        off = off * 2 + (mapped[:, d] & 1)
    oct_idx = tree.lookup(lvl, oc)
    exists = oct_idx >= 0

    # refined flag (``ok`` of godfine1): does the stencil cell have a son?
    if tree.has(lvl + 1):
        ok = tree.lookup(lvl + 1, mapped) >= 0
        ok &= exists
    else:
        ok = np.zeros(len(mapped), dtype=bool)

    # --- interpolation requests for missing stencil cells ---
    miss = ~exists
    if lvl > tree.levelmin and miss.any():
        miss_keys = kmod.encode(mapped[miss], ndim)
        uniq_keys, inv = np.unique(miss_keys, return_inverse=True)
        ni = len(uniq_keys)
        interp_cell, interp_nb, interp_sgn = _interp_requests(
            tree, lvl, uniq_keys, bc_kinds)
    else:
        ni = 0
        inv = None
        interp_cell = np.zeros(0, dtype=np.int32)
        interp_sgn = np.zeros((0, ndim), dtype=np.int8)
        interp_nb = np.zeros((0, ndim, 2), dtype=np.int32)

    ni_pad = bucket(ni, 8) if ni > 0 else 8
    trash = ncell_pad + ni_pad

    src = np.full(len(mapped), trash, dtype=np.int64)
    src[exists] = oct_idx[exists] * twotondim + off[exists]
    if ni > 0:
        src[miss] = ncell_pad + inv

    stencil_src = np.full((noct_pad, ns), trash, dtype=np.int32)
    stencil_src[:noct] = src.reshape(noct, ns).astype(np.int32)
    ok_ref = np.zeros((noct_pad, ns), dtype=bool)
    ok_ref[:noct] = ok.reshape(noct, ns)

    # velocity sign-flip bitmask for reflecting boundaries
    if refl.any():
        bits = np.zeros(len(mapped), dtype=np.uint8)
        for d in range(ndim):
            bits |= (refl[:, d].astype(np.uint8) << d)
        vsgn = np.zeros((noct_pad, ns), dtype=np.uint8)
        vsgn[:noct] = bits.reshape(noct, ns)
    else:
        vsgn = None

    # pad interp arrays
    def _pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
        out[:len(a)] = a
        return out
    interp_cell = _pad(interp_cell, ni_pad)
    interp_nb = _pad(interp_nb, ni_pad)
    interp_sgn = _pad(interp_sgn, ni_pad, 1)

    # --- coarse flux-correction targets ---
    corr_idx = np.full((noct_pad, ndim, 2), -1, dtype=np.int32)
    if lvl > tree.levelmin:
        for d in range(ndim):
            for side, s in ((0, -1), (1, +1)):
                nc = lev.og.copy()                     # father cell coords
                nc[:, d] += s
                inb = nc[:, d]
                in_domain = np.ones(noct, dtype=bool)
                lo, hi = bc_kinds[d]
                n_l1 = tree.cell_dims(lvl - 1)[d]
                if lo == 0 and hi == 0:
                    nc[:, d] = np.mod(inb, n_l1)
                else:
                    # non-periodic: out-of-domain faces get no correction
                    in_domain = (inb >= 0) & (inb < n_l1)
                    nc[:, d] = np.clip(inb, 0, n_l1 - 1)
                # target must be a coarse leaf: no oct at lvl covering it
                covered = tree.lookup(lvl, nc) >= 0
                f_oct = tree.lookup(lvl - 1, nc >> 1)
                f_off = np.zeros(noct, dtype=np.int64)
                for d2 in range(ndim):
                    f_off = f_off * 2 + (nc[:, d2] & 1)
                flat = f_oct * twotondim + f_off
                valid = in_domain & ~covered & (f_oct >= 0)
                corr_idx[:noct, d, side] = np.where(valid, flat,
                                                    -1).astype(np.int32)

    # --- restriction map (upload_fine at this level) ---
    nref, nref_pad, ref_cell, son_oct, _rm = _restriction_maps(tree, lvl)

    valid_oct = np.zeros(noct_pad, dtype=bool)
    valid_oct[:noct] = True

    return LevelMaps(lvl=lvl, noct=noct, noct_pad=noct_pad, ni=ni,
                     ni_pad=ni_pad, stencil_src=stencil_src, vsgn=vsgn,
                     ok_ref=ok_ref, interp_cell=interp_cell,
                     interp_nb=interp_nb, interp_sgn=interp_sgn,
                     corr_idx=corr_idx, nref=nref, nref_pad=nref_pad,
                     ref_cell=ref_cell, son_oct=son_oct,
                     valid_oct=valid_oct)


def _build_complete_level_maps(tree: Octree, lvl: int, noct: int,
                               noct_pad: int) -> LevelMaps:
    """Maps for a level that covers the whole box: dense permutation +
    restriction only.  The stencil gather, ghost interpolation, and
    coarse flux correction are structurally absent — the sweep runs on
    the dense grid with physical boundaries, and every coarse parent
    cell is refined so corrections to lvl-1 all drop."""
    ndim = tree.ndim
    twotondim = 1 << ndim
    ncell = noct * twotondim
    dims = tree.cell_dims(lvl)
    cc = tree.cell_coords(lvl)
    perm = np.ravel_multi_index(
        tuple(cc[:, d] for d in range(ndim)), dims)
    inv_perm = np.empty(ncell, dtype=np.int64)
    inv_perm[perm] = np.arange(ncell)

    nref, nref_pad, ref_cell, son_oct, rmask = _restriction_maps(tree, lvl)
    if rmask is not None:
        ok_dense = np.zeros(ncell, dtype=bool)
        ok_dense[perm] = rmask
    else:
        ok_dense = None
    ok_flat = rmask

    valid_oct = np.zeros(noct_pad, dtype=bool)
    valid_oct[:noct] = True
    return LevelMaps(
        lvl=lvl, noct=noct, noct_pad=noct_pad, ni=0, ni_pad=8,
        stencil_src=np.zeros((0, 0), dtype=np.int32), vsgn=None,
        ok_ref=np.zeros((0, 0), dtype=bool),
        interp_cell=np.zeros(8, dtype=np.int32),
        interp_nb=np.zeros((8, ndim, 2), dtype=np.int32),
        interp_sgn=np.ones((8, ndim), dtype=np.int8),
        corr_idx=np.full((noct_pad, ndim, 2), -1, dtype=np.int32),
        nref=nref, nref_pad=nref_pad, ref_cell=ref_cell, son_oct=son_oct,
        valid_oct=valid_oct, complete=True,
        perm=perm.astype(np.int64), inv_perm=inv_perm, ok_dense=ok_dense,
        ok_flat=ok_flat)


def refresh_restriction(m: LevelMaps, tree: Octree) -> LevelMaps:
    """New LevelMaps with only the lvl+1-dependent parts rebuilt
    (restriction targets + dense refined mask) — used when a COMPLETE
    level's own oct set is unchanged across a regrid."""
    from dataclasses import replace

    nref, nref_pad, ref_cell, son_oct, rmask = _restriction_maps(tree,
                                                                 m.lvl)
    ok_dense = None
    if rmask is not None and m.perm is not None:
        ok_dense = np.zeros(len(m.perm), dtype=bool)
        ok_dense[m.perm] = rmask
    return replace(m, nref=nref, nref_pad=nref_pad, ref_cell=ref_cell,
                   son_oct=son_oct, ok_dense=ok_dense, ok_flat=rmask)


# ---------------------------------------------------------------------------
# Blocked Morton tile maps (gather-fused oct sweep)
# ---------------------------------------------------------------------------

NGHOST_TILE = 2       # MUSCL-Hancock halo width (slopes at ±1 need ±2)


def _flat_off_table(ndim: int) -> np.ndarray:
    """Morton low-bit pattern (x at bit 0) → flat cell offset (x slowest)."""
    n = 1 << ndim
    out = np.zeros(n, dtype=np.int64)
    for m in range(n):
        f = 0
        for d in range(ndim):
            f = f * 2 + ((m >> d) & 1)
        out[m] = f
    return out


@dataclass
class BlockMaps:
    """Morton-aligned oct-tile maps for the gather-fused partial sweep.

    Octs are grouped into aligned cubes of ``2**shift`` octs per side.
    Because the per-level oct list is Morton-sorted, every tile is a
    contiguous oct range and all of a tile's cells live in one dense
    ``td^ndim`` box (``2**(shift+1)`` interior cells per side plus a
    2-cell halo).  ``tile_src`` replaces the per-oct 6^ndim stencil
    gather of :class:`LevelMaps`: one compact row per tile slot instead
    of a ~(3^ndim)x duplicated per-oct batch, so the sweep's HBM gather
    traffic scales with tile volume, not stencil volume.
    """
    lvl: int
    shift: int                       # octs per tile side = 2**shift
    ntile: int
    ntile_pad: int
    ni: int
    ni_pad: int
    # gather: src row per tile slot into concat(cells, interp, trash)
    tile_src: np.ndarray             # [ntile_pad, td^d] int32
    tile_vsgn: Optional[np.ndarray]  # [ntile_pad, td^d] uint8, or None
    tile_ok: np.ndarray              # [ntile_pad, td^d] bool (cell refined)
    # interpolation requests (same semantics as LevelMaps)
    interp_cell: np.ndarray          # [ni_pad] int32
    interp_nb: np.ndarray            # [ni_pad, ndim, 2] int32
    interp_sgn: np.ndarray           # [ni_pad, ndim] int8
    # scatter-back maps (kernel tile outputs → flat rows / per-oct corr)
    cell_tile: np.ndarray            # [ncell_pad] int32 tile of each row
    cell_slot: np.ndarray            # [ncell_pad] int32 interior C^d slot
    oct_tile: np.ndarray             # [noct_pad] int32
    oct_slot: np.ndarray             # [noct_pad] int32 tile-local oct slot
    # incremental-rebuild state: per-tile slot geometry is a pure
    # function of (tile prefix, bc, level dims) — reusable across
    # regrids for every tile whose Morton prefix survives
    tile_key: np.ndarray             # [ntile] int64 prefixes, sorted
    slot_ckey: np.ndarray            # [ntile, td^d] int64 mapped cell key
    slot_vbits: Optional[np.ndarray]  # [ntile, td^d] uint8, or None
    noct: int = 0
    noct_pad: int = 0
    blocks_rebuilt: int = 0          # tiles whose geometry was re-derived

    @property
    def ndim(self) -> int:
        return self.interp_sgn.shape[1]

    @property
    def td(self) -> int:
        return (1 << (self.shift + 1)) + 2 * NGHOST_TILE

    @property
    def ncell_pad(self) -> int:
        return self.noct_pad * 2 ** self.ndim


def _shift0(a: np.ndarray, s: int, ax: int) -> np.ndarray:
    """Zero-padded shift of ``a`` by ``s`` along ``ax``."""
    b = np.zeros_like(a)
    n = a.shape[ax]
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    if s > 0:
        dst[ax], src[ax] = slice(s, n), slice(0, n - s)
    else:
        dst[ax], src[ax] = slice(0, n + s), slice(-s, n)
    b[tuple(dst)] = a[tuple(src)]
    return b


def _dilate2(mask: np.ndarray, ndim: int) -> np.ndarray:
    """Chebyshev-radius-2 binary dilation over the tile axes (1..ndim) —
    the MUSCL-Hancock influence radius of a cell."""
    out = mask
    for ax in range(1, ndim + 1):
        m = out
        for s in (1, 2):
            out = out | _shift0(m, s, ax) | _shift0(m, -s, ax)
    return out


def _tile_geometry(tree: Octree, lvl: int, tile_key: np.ndarray,
                   shift: int, bc_kinds: List[tuple]):
    """Tree-independent slot geometry of each tile: the BC-mapped cell
    Morton key and reflection bitmask for every td^ndim slot."""
    ndim = tree.ndim
    td = (1 << (shift + 1)) + 2 * NGHOST_TILE
    nslot = td ** ndim
    # tile origin in cell coords: decode the prefix back to oct coords
    org = kmod.decode(tile_key << (ndim * shift), ndim) * 2
    loc = np.indices((td,) * ndim).reshape(ndim, -1).T  # [nslot, ndim]
    gc = (org[:, None, :] + loc[None, :, :]
          - NGHOST_TILE).reshape(-1, ndim)
    mapped, refl = map_coords(gc, lvl, bc_kinds, ndim,
                              dims=tree.cell_dims(lvl))
    ckey = kmod.encode(mapped, ndim).reshape(len(tile_key), nslot)
    if refl.any():
        bits = np.zeros(len(gc), dtype=np.uint8)
        for d in range(ndim):
            bits |= (refl[:, d].astype(np.uint8) << d)
        vbits = bits.reshape(len(tile_key), nslot)
    else:
        vbits = None
    return ckey, vbits


def build_block_maps(tree: Octree, lvl: int, bc_kinds: List[tuple],
                     shift: int = 2, noct_pad: Optional[int] = None,
                     prev: Optional[BlockMaps] = None) -> BlockMaps:
    """Blocked tile maps for a partial level; with ``prev`` from the last
    regrid, slot geometry is re-derived only for tiles whose Morton
    prefix is new (``blocks_rebuilt`` counts them)."""
    ndim = tree.ndim
    twotondim = 1 << ndim
    lev = tree.levels[lvl]
    noct = lev.noct
    noct_pad = noct_pad or bucket(noct)
    ncell_pad = noct_pad * twotondim
    c = 1 << (shift + 1)
    td = c + 2 * NGHOST_TILE
    nslot = td ** ndim

    tile_key, oct_tile_r = np.unique(lev.keys >> (ndim * shift),
                                     return_inverse=True)
    ntile = len(tile_key)
    ntile_pad = bucket(ntile, 8)

    reuse = (prev is not None and prev.shift == shift
             and prev.lvl == lvl and len(prev.tile_key) > 0)
    if reuse:
        pos = np.searchsorted(prev.tile_key, tile_key)
        pos = np.clip(pos, 0, len(prev.tile_key) - 1)
        hit = prev.tile_key[pos] == tile_key
        new = ~hit
        slot_ckey = np.empty((ntile, nslot), dtype=np.int64)
        slot_ckey[hit] = prev.slot_ckey[pos[hit]]
        vb_new = None
        if new.any():
            ck_new, vb_new = _tile_geometry(tree, lvl, tile_key[new],
                                            shift, bc_kinds)
            slot_ckey[new] = ck_new
        if prev.slot_vbits is None and vb_new is None:
            slot_vbits = None
        else:
            slot_vbits = np.zeros((ntile, nslot), dtype=np.uint8)
            if prev.slot_vbits is not None:
                slot_vbits[hit] = prev.slot_vbits[pos[hit]]
            if vb_new is not None:
                slot_vbits[new] = vb_new
        rebuilt = int(new.sum())
    else:
        slot_ckey, slot_vbits = _tile_geometry(tree, lvl, tile_key,
                                               shift, bc_kinds)
        rebuilt = ntile

    # --- tree-dependent lookups (vectorized over all slots) ---
    ck = slot_ckey.reshape(-1)
    oct_idx = tree.lookup_keys(lvl, ck >> ndim)
    foff = _flat_off_table(ndim)[ck & (twotondim - 1)]
    exists = oct_idx >= 0
    if tree.has(lvl + 1):
        # the slot's cell key at lvl IS its covering oct key at lvl+1
        ok = tree.lookup_keys(lvl + 1, ck) >= 0
        ok &= exists
    else:
        ok = np.zeros(len(ck), dtype=bool)

    # Sparse tiles have holes/halo slots arbitrarily far from any real
    # oct — their fathers need not exist (2:1 gradedness only covers the
    # 1-oct neighbourhood), and their values cannot influence any kept
    # output (du/corr/phi read at most 2 cells from an existing oct).
    # Interpolate only the slots inside that influence radius; the rest
    # read the zero trash row.
    near = _dilate2(exists.reshape((ntile,) + (td,) * ndim),
                    ndim).reshape(-1)
    miss = near & ~exists
    if lvl > tree.levelmin and miss.any():
        uniq_keys, inv = np.unique(ck[miss], return_inverse=True)
        ni = len(uniq_keys)
        interp_cell, interp_nb, interp_sgn = _interp_requests(
            tree, lvl, uniq_keys, bc_kinds)
    else:
        ni = 0
        inv = None
        interp_cell = np.zeros(0, dtype=np.int32)
        interp_sgn = np.zeros((0, ndim), dtype=np.int8)
        interp_nb = np.zeros((0, ndim, 2), dtype=np.int32)
    ni_pad = bucket(ni, 8) if ni > 0 else 8
    trash = ncell_pad + ni_pad

    src = np.full(len(ck), trash, dtype=np.int64)
    src[exists] = oct_idx[exists] * twotondim + foff[exists]
    if ni > 0:
        src[miss] = ncell_pad + inv
    tile_src = np.full((ntile_pad, nslot), trash, dtype=np.int32)
    tile_src[:ntile] = src.reshape(ntile, nslot).astype(np.int32)
    tile_ok = np.zeros((ntile_pad, nslot), dtype=bool)
    tile_ok[:ntile] = ok.reshape(ntile, nslot)
    if slot_vbits is not None and slot_vbits.any():
        tile_vsgn = np.zeros((ntile_pad, nslot), dtype=np.uint8)
        tile_vsgn[:ntile] = slot_vbits
    else:
        tile_vsgn = None

    interp_cell = _pad_rows(interp_cell, ni_pad)
    interp_nb = _pad_rows(interp_nb, ni_pad)
    interp_sgn = _pad_rows(interp_sgn, ni_pad, 1)

    # per-oct scatter map: tile + tile-local oct slot (d=0 slowest)
    a = lev.og & ((1 << shift) - 1)
    oslot = np.zeros(noct, dtype=np.int64)
    for d in range(ndim):
        oslot = oslot * (1 << shift) + a[:, d]
    oct_tile = np.zeros(noct_pad, dtype=np.int32)
    oct_slot = np.zeros(noct_pad, dtype=np.int32)
    oct_tile[:noct] = oct_tile_r
    oct_slot[:noct] = oslot

    # per-cell scatter map: tile + interior C^d slot
    co = cell_offsets(ndim)
    gc = 2 * lev.og[:, None, :] + co[None, :, :]       # [noct, 2^d, ndim]
    lc = gc - 2 * ((lev.og >> shift) << shift)[:, None, :]
    cslot = np.zeros((noct, twotondim), dtype=np.int64)
    for d in range(ndim):
        cslot = cslot * c + lc[:, :, d]
    # pad rows must come out exactly zero (level_sweep zeroes them via
    # its ok masks, and the sharded-vs-single suites compare full
    # padded arrays): slot c^d flattens one past the interior batch,
    # where the kernels' reorder gathers an appended zero column
    cell_tile = np.zeros(ncell_pad, dtype=np.int32)
    cell_slot = np.full(ncell_pad, c ** ndim, dtype=np.int32)
    cell_tile[:noct * twotondim] = np.repeat(oct_tile_r, twotondim)
    cell_slot[:noct * twotondim] = cslot.reshape(-1)

    return BlockMaps(lvl=lvl, shift=shift, ntile=ntile,
                     ntile_pad=ntile_pad, ni=ni, ni_pad=ni_pad,
                     tile_src=tile_src, tile_vsgn=tile_vsgn,
                     tile_ok=tile_ok, interp_cell=interp_cell,
                     interp_nb=interp_nb, interp_sgn=interp_sgn,
                     cell_tile=cell_tile, cell_slot=cell_slot,
                     oct_tile=oct_tile, oct_slot=oct_slot,
                     tile_key=tile_key, slot_ckey=slot_ckey,
                     slot_vbits=slot_vbits, noct=noct,
                     noct_pad=noct_pad, blocks_rebuilt=rebuilt)


def build_prolong_maps(tree_new: Octree, tree_old: Octree, lvl: int,
                       bc_kinds: List[tuple]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    """Maps to fill level ``lvl`` of the new tree from old data.

    Returns (copy_dst, copy_src, new_father_cell, new_nb, new_sgn):
      * copy_dst/copy_src: oct indices new←old for octs that survived;
      * for brand-new octs: father-cell interpolation request against the
        NEW lvl-1 state (``make_grid_fine``, ``amr/refine_utils.f90:590``),
        one request per (new oct, child cell) in flat-cell order.
    """
    ndim = tree_new.ndim
    twotondim = 1 << ndim
    newlev = tree_new.levels[lvl]
    old_idx = tree_old.lookup_keys(lvl, newlev.keys) if tree_old.has(lvl) \
        else np.full(newlev.noct, -1, dtype=np.int64)
    kept = old_idx >= 0
    copy_dst = np.nonzero(kept)[0].astype(np.int32)
    copy_src = old_idx[kept].astype(np.int32)

    new_octs = np.nonzero(~kept)[0]
    nnew = len(new_octs)
    father = newlev.og[new_octs]                       # cell coords at lvl-1
    f_oct = tree_new.lookup(lvl - 1, father >> 1)
    if nnew and (f_oct < 0).any():
        raise RuntimeError("prolongation: father oct missing")
    f_off = np.zeros(nnew, dtype=np.int64)
    for d in range(ndim):
        f_off = f_off * 2 + (father[:, d] & 1)
    f_cell = (f_oct * twotondim + f_off).astype(np.int32)
    nb = np.empty((nnew, ndim, 2), dtype=np.int32)
    for d in range(ndim):
        for side, s in ((0, -1), (1, +1)):
            nc = father.copy()
            nc[:, d] += s
            ncm, nrefl = map_coords(nc, lvl - 1, bc_kinds, ndim,
                                    dims=tree_new.cell_dims(lvl - 1))
            n_oct = tree_new.lookup(lvl - 1, ncm >> 1)
            n_off = np.zeros(nnew, dtype=np.int64)
            for d2 in range(ndim):
                n_off = n_off * 2 + (ncm[:, d2] & 1)
            bad = (n_oct < 0) | nrefl.any(axis=1)
            nb[:, d, side] = np.where(
                bad, f_cell, n_oct * twotondim + n_off).astype(np.int32)
    return copy_dst, copy_src, new_octs.astype(np.int32), f_cell, nb


