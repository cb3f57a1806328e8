"""Refinement flag computation — ``flag_fine`` (``amr/flag_utils.f90:57-718``).

The port's own copy of ``ramses_tpu/amr/flag.py`` (numpy only).

Per level: device gradient criteria (``hydro_refine``) + host geometric
criteria, ``nexpand``-fold dilation (``smooth_fine``, ``:555``), then a
top-down nesting sweep that is the constructive form of the reference's
2:1 ``ensure_ref_rules`` (``:213``): a cell at level l is flagged whenever
any flagged cell x at level l+1 has a father-neighbourhood cell
``(x+e)>>1`` equal to it — this guarantees every surviving oct's 3^ndim
father-cell stencil exists.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

from ramses_tpu_torch.amr import keys as kmod
from ramses_tpu_torch.amr.tree import Octree, map_coords
from ramses_tpu_torch.config import Params


def _neighbor_offsets(ndim: int) -> np.ndarray:
    return np.array(list(itertools.product((-1, 0, 1), repeat=ndim)),
                    dtype=np.int64)


def dilate(flag_coords: np.ndarray, lvl: int, bc_kinds, ndim: int,
           dims=None) -> np.ndarray:
    """One smoothing pass: the 3^ndim dilation of the flagged cell set."""
    if len(flag_coords) == 0:
        return flag_coords
    offs = _neighbor_offsets(ndim)
    ex = (flag_coords[:, None, :] + offs[None, :, :]).reshape(-1, ndim)
    ex, _ = map_coords(ex, lvl, bc_kinds, ndim, dims=dims)
    ks = np.unique(kmod.encode(ex, ndim))
    return kmod.decode(ks, ndim)


def geometry_flags(centers: np.ndarray, lvl: int, p: Params) -> np.ndarray:
    """Geometric refinement region of this level
    (``amr/flag_utils.f90:494-553``): generalized-ellipsoid ball around
    (x_refine, y_refine, z_refine) with radius r_refine, semi-axis ratios
    a/b_refine and p-norm exp_refine.  r_refine < 0 → disabled."""
    r = p.refine
    i = lvl - 1                                        # 1-based level lists
    if i >= len(r.r_refine) or r.r_refine[i] <= 0.0:
        return np.zeros(len(centers), dtype=bool)
    cen = [r.x_refine[i], r.y_refine[i], r.z_refine[i]][:p.ndim]
    ax = [1.0, r.a_refine[i], r.b_refine[i]][:p.ndim]
    en = float(r.exp_refine[i])
    rr = np.zeros(len(centers))
    for d in range(p.ndim):
        t = np.abs(centers[:, d] - cen[d]) / ax[d]
        rr += t ** min(en, 10.0) if en < 10.0 else 0.0
    if en < 10.0:
        rr = rr ** (1.0 / en)
    else:
        rr = np.maximum.reduce(
            [np.abs(centers[:, d] - cen[d]) / ax[d] for d in range(p.ndim)])
    return rr < float(r.r_refine[i])


def compute_new_tree(tree: Octree, crit_flags: Dict[int, np.ndarray],
                     bc_kinds, params: Params) -> Octree:
    """New octree from per-level per-cell criteria flags.

    ``crit_flags[l]``: bool [ncell_flat(l)] on the CURRENT tree.  Returns a
    tree whose level-(l+1) oct set is exactly the flagged cell set of level
    l after smoothing + nesting.
    """
    ndim = tree.ndim
    lmin, lmax = tree.levelmin, tree.levelmax
    nexpand = params.amr.nexpand

    # flagged cell coordinate sets per level, smoothed
    fcoords: Dict[int, np.ndarray] = {}
    for l in range(lmin, lmax + 1):
        if not tree.has(l):
            fcoords[l] = np.zeros((0, ndim), dtype=np.int64)
            continue
        cc = tree.cell_coords(l)
        f = crit_flags.get(l)
        coords = cc[f] if f is not None and f.any() else \
            np.zeros((0, ndim), dtype=np.int64)
        ne = nexpand[l - 1] if l - 1 < len(nexpand) else 1
        for _ in range(max(int(ne), 0)):
            coords = dilate(coords, l, bc_kinds, ndim,
                            dims=tree.cell_dims(l))
        fcoords[l] = coords

    # top-down nesting: project fine flags into father-neighbourhood flags
    offs = _neighbor_offsets(ndim)
    for l in range(lmax, lmin, -1):
        x = fcoords[l]
        if len(x) == 0:
            continue
        ex = (x[:, None, :] + offs[None, :, :]).reshape(-1, ndim)
        ex, _ = map_coords(ex, l, bc_kinds, ndim, dims=tree.cell_dims(l))
        up = ex >> 1
        ks = np.unique(kmod.encode(up, ndim))
        prev = kmod.encode(fcoords[l - 1], ndim) if len(fcoords[l - 1]) \
            else np.zeros(0, dtype=np.int64)
        allk = np.unique(np.concatenate([prev, ks]))
        fcoords[l - 1] = kmod.decode(allk, ndim)

    # flags only refine existing cells: intersect with current cell sets
    new = Octree(ndim, lmin, lmax, root=tree.root)
    new.set_level(lmin, tree.levels[lmin].og)          # base stays complete
    for l in range(lmin, lmax):
        coords = fcoords[l]
        if len(coords) == 0:
            break
        # a flagged cell must exist on the (new) level l to spawn an oct
        parent = new.lookup(l, coords >> 1)
        coords = coords[parent >= 0]
        if len(coords) == 0:
            break
        new.set_level(l + 1, coords)                   # cell coords = oct
    return new
