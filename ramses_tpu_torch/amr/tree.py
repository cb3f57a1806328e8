"""Host-resident octree topology.

The port's own copy of ``ramses_tpu/amr/tree.py`` (numpy only).

Replaces the reference's pointer-based fully-threaded tree
(``son/father/nbor`` arrays + per-(level,cpu) linked lists,
``amr/amr_commons.f90:54-75``) with one sorted Morton-key array per level:
an oct at level ``l`` is identified by its integer coordinates on the
``2^(l-1)``-per-dim oct grid (cells are ``2^l`` per dim), membership and
neighbour lookup are ``np.searchsorted`` on the sorted keys, and "linked
list order" is simply array order.  Levels below ``levelmin`` are implicitly
fully refined (the reference's coarse levels 1..levelmin-1 exist only as
scaffolding; ours don't exist at all).

Conventions:
  * level ``l`` cell grid: ``2^l`` cells per dim over the unit box
    (``levelmin=7`` ⇒ 128³ base cells, matching the reference).
  * oct at level ``l`` has oct coords ``og ∈ [0, 2^(l-1))^ndim``; its 2^ndim
    cells have cell coords ``2*og + c, c ∈ {0,1}^ndim``.
  * cell offset index within an oct: ``off = c_x * 2^(ndim-1) + ... + c_z``
    (x slowest), matching a row-major reshape to ``[2]*ndim`` cell axes.
    (The reference uses x-fastest ``ind_son=1+ix+2*iy+4*iz``; ours matches
    numpy/XLA reshape order instead.)
  * flat cell index at a level: ``oct_index * 2^ndim + off``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ramses_tpu_torch.amr import keys as kmod


@dataclass
class OctLevel:
    """Sorted oct set of one level."""
    lvl: int
    keys: np.ndarray          # [noct] int64 Morton keys, sorted ascending
    og: np.ndarray            # [noct, ndim] int64 oct coords (decoded)

    @property
    def noct(self) -> int:
        return len(self.keys)


class Octree:
    """Per-level sorted oct sets for levels levelmin..levelmax.

    ``root``: coarse root-cell counts per dim (``nx, ny, nz`` of
    &AMR_PARAMS; ``amr/init_amr.f90:37-60`` builds the tree over this
    arbitrary coarse grid).  Level ``l`` then has ``root[d]·2^l`` cells
    along dim ``d`` (cubic cells; the domain extent is
    ``root[d]·boxlen``), reducing to the single-cube 2^l layout for
    the default all-ones root."""

    def __init__(self, ndim: int, levelmin: int, levelmax: int,
                 root=None):
        self.ndim = ndim
        self.levelmin = levelmin
        self.levelmax = levelmax
        self.root = tuple(int(r) for r in
                          (root if root is not None else (1,) * ndim))
        self.levels: Dict[int, OctLevel] = {}

    def cell_dims(self, lvl: int):
        """Cells per dim at level ``lvl``."""
        return tuple(r << lvl for r in self.root)

    def oct_dims(self, lvl: int):
        """Octs per dim at level ``lvl``."""
        return tuple(r << (lvl - 1) for r in self.root)

    @classmethod
    def base(cls, ndim: int, levelmin: int, levelmax: int,
             root=None) -> "Octree":
        """Complete base level (the reference's fully-refined levelmin)."""
        t = cls(ndim, levelmin, levelmax, root=root)
        axes = [np.arange(n, dtype=np.int64)
                for n in t.oct_dims(levelmin)]
        grids = np.meshgrid(*axes, indexing="ij")
        og = np.stack([g.ravel() for g in grids], axis=1)
        t.set_level(levelmin, og)
        return t

    def set_level(self, lvl: int, og: np.ndarray) -> None:
        og = np.asarray(og, dtype=np.int64).reshape(-1, self.ndim)
        ks = kmod.encode(og, self.ndim)
        order = np.argsort(ks, kind="stable")
        self.levels[lvl] = OctLevel(lvl, ks[order], og[order])

    def has(self, lvl: int) -> bool:
        return lvl in self.levels and self.levels[lvl].noct > 0

    def noct(self, lvl: int) -> int:
        return self.levels[lvl].noct if lvl in self.levels else 0

    @property
    def finest(self) -> int:
        """Finest level actually populated."""
        lv = self.levelmin
        for l in range(self.levelmin, self.levelmax + 1):
            if self.has(l):
                lv = l
        return lv

    def lookup(self, lvl: int, og: np.ndarray) -> np.ndarray:
        """Oct indices for coords ``og [n, ndim]``; -1 where absent."""
        if not self.has(lvl):
            return np.full(len(og), -1, dtype=np.int64)
        lev = self.levels[lvl]
        ks = kmod.encode(np.asarray(og, dtype=np.int64), self.ndim)
        pos = np.searchsorted(lev.keys, ks)
        pos = np.clip(pos, 0, lev.noct - 1)
        hit = lev.keys[pos] == ks
        return np.where(hit, pos, -1)

    def lookup_keys(self, lvl: int, ks: np.ndarray) -> np.ndarray:
        """Oct indices for Morton keys; -1 where absent."""
        if not self.has(lvl):
            return np.full(len(ks), -1, dtype=np.int64)
        lev = self.levels[lvl]
        pos = np.searchsorted(lev.keys, ks)
        pos = np.clip(pos, 0, lev.noct - 1)
        hit = lev.keys[pos] == ks
        return np.where(hit, pos, -1)

    def cell_coords(self, lvl: int) -> np.ndarray:
        """Global cell coords of every cell of the level, flat-cell order:
        ``[noct * 2^ndim, ndim]``."""
        lev = self.levels[lvl]
        offs = cell_offsets(self.ndim)                   # [2^d, ndim]
        return (2 * lev.og[:, None, :] + offs[None, :, :]).reshape(
            -1, self.ndim)

    def cell_centers(self, lvl: int, boxlen: float = 1.0) -> np.ndarray:
        """Physical cell-centre coords ``[ncell, ndim]`` in [0, boxlen]."""
        dx = boxlen / (1 << lvl)
        return (self.cell_coords(lvl) + 0.5) * dx

    def son_parent_cells(self, lvl: int) -> np.ndarray:
        """Flat lvl-cell index covered by each lvl+1 oct (tree order),
        -1 where the parent oct is missing (2:1 violation)."""
        og1 = self.levels[lvl + 1].og
        f_oct = self.lookup(lvl, og1 >> 1)
        off = np.zeros(len(og1), dtype=np.int64)
        for d in range(self.ndim):
            off = off * 2 + (og1[:, d] & 1)
        return np.where(f_oct >= 0, f_oct * (1 << self.ndim) + off, -1)

    def refined_mask(self, lvl: int) -> np.ndarray:
        """Bool [ncell_flat]: cell has a son oct at lvl+1.

        Built from the fine level's oct coords (each lvl+1 oct marks
        exactly one lvl cell): O(noct(lvl+1)), not O(ncell(lvl))."""
        ncell = self.noct(lvl) * (1 << self.ndim)
        out = np.zeros(ncell, dtype=bool)
        if not self.has(lvl + 1):
            return out
        rows = self.son_parent_cells(lvl)
        out[rows[rows >= 0]] = True
        return out


def cell_offsets(ndim: int) -> np.ndarray:
    """[2^ndim, ndim] cell offsets in flat-cell order (x slowest)."""
    offs = np.indices((2,) * ndim).reshape(ndim, -1).T
    return offs.astype(np.int64)


def map_coords(cc: np.ndarray, lvl: int, bc_kinds: List[tuple],
               ndim: int, dims=None):
    """Map (possibly out-of-domain) cell coords to in-domain coords per the
    physical boundaries (``amr/physical_boundaries.f90`` semantics realized
    as index mapping instead of ghost regions).

    ``bc_kinds[d] = (low_kind, high_kind)`` with kinds from
    ``grid.boundary``: 0 periodic, 1 reflecting, 2 outflow.
    ``dims``: per-dim cell counts (``tree.cell_dims(lvl)``); defaults
    to the single-cube ``2^lvl`` everywhere.
    Returns (mapped coords, reflect_mask [n, ndim] bool — True where the
    coordinate was mirrored an odd number of times, i.e. velocity component
    d must be sign-flipped).
    """
    out = cc.copy()
    refl = np.zeros(cc.shape, dtype=bool)
    for d in range(ndim):
        n = (1 << lvl) if dims is None else int(dims[d])
        lo, hi = bc_kinds[d]
        x = out[:, d]
        if lo == 0 and hi == 0:            # periodic
            out[:, d] = np.mod(x, n)
        else:
            # reflecting: mirror about the wall; outflow: clamp (zero-grad)
            below = x < 0
            above = x >= n
            if lo == 1:
                out[:, d] = np.where(below, -1 - x, out[:, d])
                refl[:, d] |= below
            elif lo != 0:
                out[:, d] = np.where(below, 0, out[:, d])
            if hi == 1:
                x2 = out[:, d]
                out[:, d] = np.where(above, 2 * n - 1 - x2, out[:, d])
                refl[:, d] |= above
            elif hi != 0:
                out[:, d] = np.where(above, n - 1, out[:, d])
            # mixed periodic on one side only: clamp handles the remainder
            out[:, d] = np.clip(out[:, d], 0, n - 1)
    return out, refl
