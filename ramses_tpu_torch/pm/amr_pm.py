"""Particles on the AMR hierarchy (PyTorch).

Port of ``ramses_tpu/pm/amr_pm.py``.  The reference attaches particles to
tree grids with per-grid linked lists (``pm/particle_tree.f90:174-646``),
deposits their mass level by level (``cic_amr``, ``pm/rho_fine.f90:343``),
interpolates forces back at each particle's level (``move1``,
``pm/move_fine.f90:193``), and kicks and drifts them inside ``amr_step``
(``amr/amr_step.f90:219-236, 268-273, 479-486``).

As in the JAX package, no linked lists and no per-grid walks: once per
coarse step flat index maps are built from the sorted-key octree — for
every (particle, stencil corner) the flat cell row of that corner at each
level, or a dump row where the level does not cover the corner — in
float64 from one snapshot of the positions, then the deposits are segment
sums and the gathers dense gathers with those maps.  The JAX package
builds the maps in host numpy; here the same float64 arithmetic and the
same Morton-key lookups (``searchsorted`` on each level's sorted keys,
uploaded from the host tree) run where the positions are, so on the card
the 2.1 M particles × 8 corners × 3 levels of config 5 neither leave the
device nor wait on the host's numpy (the maps are equal, integer for
integer, on either device).

Level semantics match the reference:
  * a particle is assigned to the finest level whose oct covers it
    (``make_tree_fine``); forces are gathered at that level;
  * its mass is deposited at every level that covers it (coverage is
    nested), so each level's Poisson rhs sees all mass in its domain;
    corners outside a level's coverage are dropped there.

The deposit sums each row's contributions in one fixed order, the JAX
package's (ascending particle, then corner: the order in which XLA:CPU
applies ``.at[idx].add``): the device sorts the flat map stably by row
once per map build, and ``torch.segment_reduce`` sums each row's segment
without atomics.  So the deposit is bitwise the same from run to run on
the card, and a refinement flag on ``density > m_refine·m̄/dx³`` cannot
flip between two runs.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List

import torch

from ramses_tpu_torch.amr.tree import Octree, map_coords


@dataclass
class PmLevelMap:
    """The maps of one level for one position snapshot (tensors on the
    positions' device)."""
    lvl: int
    idx: torch.Tensor       # [npart, ncorner] int64 flat cell row;
    #                         ncorner = 1|2^d|3^d (ngp/cic/tsc);
    #                         ncell_pad = dump row
    w: torch.Tensor         # [npart, ncorner] float64 weights (0=dropped)
    assigned: torch.Tensor  # [npart] bool: particle's finest covering level


def _spread(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """The bits of ``x`` spread for a ``ndim``-D Morton interleave (the
    port's ``amr/keys._spread2``/``_spread3`` on int64 tensors)."""
    if ndim == 2:
        for sh, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                         (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                         (1, 0x5555555555555555)):
            x = (x | (x << sh)) & mask
        return x
    x = x & 0x1FFFFF
    for sh, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                     (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                     (2, 0x1249249249249249)):
        x = (x | (x << sh)) & mask
    return x


def _lookup(tree: Octree, lvl: int, og: torch.Tensor, keys: dict):
    """Oct indices of the oct coordinates ``og [n, ndim]`` (int64 tensor)
    on level ``lvl``, -1 where absent: ``tree.lookup`` on the tensors'
    device (the level's sorted Morton keys cached in ``keys``)."""
    if not tree.has(lvl):
        return torch.full((og.shape[0],), -1, dtype=torch.int64,
                          device=og.device)
    if lvl not in keys:
        keys[lvl] = torch.as_tensor(tree.levels[lvl].keys, device=og.device)
    lev = keys[lvl]
    nd = tree.ndim
    ks = og[:, 0]
    if nd > 1:
        ks = _spread(og[:, 0], nd)
        for d in range(1, nd):
            ks = ks | (_spread(og[:, d], nd) << d)
    pos = torch.clamp(torch.searchsorted(lev, ks), max=lev.shape[0] - 1)
    return torch.where(lev[pos] == ks, pos, -1)


def _map_coords(cc: torch.Tensor, lvl: int, bc_kinds, ndim: int):
    """``amr/tree.map_coords`` for periodic and outflow kinds on int64
    tensors: periodic dims wrap, the others clamp into the box."""
    n = 1 << lvl
    cols = []
    for d in range(ndim):
        lo, hi = bc_kinds[d]
        x = cc[:, d]
        if lo == 0 and hi == 0:
            x = torch.remainder(x, n)
        else:
            if lo != 0:
                x = torch.where(x < 0, 0, x)
            if hi != 0:
                x = torch.where(x >= n, n - 1, x)
            x = torch.clamp(x, 0, n - 1)
        cols.append(x)
    return torch.stack(cols, dim=1)


def assign_levels(tree: Octree, x: torch.Tensor, boxlen: float,
                  keys=None) -> torch.Tensor:
    """Finest level whose oct covers each particle (``make_tree_fine``);
    ``x`` float64 positions."""
    keys = {} if keys is None else keys
    lv = torch.full((x.shape[0],), tree.levelmin, dtype=torch.int32,
                    device=x.device)
    for l in range(tree.levelmin + 1, tree.levelmax + 1):
        if not tree.has(l):
            break
        dx_oct = boxlen / (1 << (l - 1))       # oct size at level l
        og = torch.floor(x / dx_oct).to(torch.int64)
        og = torch.clamp(og, 0, (1 << (l - 1)) - 1)
        lv = torch.where(_lookup(tree, l, og, keys) >= 0, l, lv)
    return lv


def _stencil_1d(s: torch.Tensor, scheme: str):
    """Per-dim (base index, [(offset, weight)]) for one coordinate
    ``s = x/dx`` (cells [i, i+1)): ``rho_fine``'s CIC plus the NGP and TSC
    alternatives (``pm/rho_fine.f90`` deposition kernels)."""
    if scheme == "ngp":
        return torch.floor(s).to(torch.int64), [(0, torch.ones_like(s))]
    if scheme == "cic":
        i0 = torch.floor(s - 0.5)
        f = (s - 0.5) - i0
        return i0.to(torch.int64), [(0, 1.0 - f), (1, f)]
    if scheme == "tsc":
        ic = torch.floor(s)
        f = s - (ic + 0.5)                     # in [-0.5, 0.5)
        return ic.to(torch.int64), [(-1, 0.5 * (0.5 - f) ** 2),
                                    (0, 0.75 - f ** 2),
                                    (1, 0.5 * (0.5 + f) ** 2)]
    raise ValueError(f"deposit scheme {scheme!r}")


def build_pm_maps(tree: Octree, x: torch.Tensor, boxlen: float,
                  bc_kinds: List[tuple], ncell_pad: Dict[int, int],
                  scheme: str = "cic") -> Dict[int, PmLevelMap]:
    """Deposit index/weight maps for every populated level.

    ``x`` is a float64 snapshot of the positions ``[npart, ndim]``, on the
    device the maps are built on; ``ncell_pad[l]`` the padded flat-cell
    count of the level (its value doubles as the dump row index);
    ``scheme`` ∈ ngp|cic|tsc selects the kernel (1, 2^d or 3^d corners a
    particle).  The same float64 arithmetic and integer lookups as the
    JAX package's numpy pass, so the maps are the same on any device.  A
    reflecting wall raises: it would need the wall-normal force flipped on
    mirrored corners and a bouncing drift.
    """
    ndim = tree.ndim
    ttd = 1 << ndim
    if any(k == 1 for pair in bc_kinds for k in pair):
        raise NotImplementedError(
            "AMR particles: reflecting boundaries unsupported")
    # open (outflow/inflow) dims: corners outside the box are dropped —
    # mass near the edge leaks as in the reference's isolated runs;
    # escaped particles are deactivated by the drift
    open_dim = [tuple(bc_kinds[d]) != (0, 0) for d in range(ndim)]
    keys: Dict[int, torch.Tensor] = {}
    levels = assign_levels(tree, x, boxlen, keys)
    npart = x.shape[0]
    out: Dict[int, PmLevelMap] = {}
    for l in range(tree.levelmin, tree.levelmax + 1):
        if not tree.has(l):
            break
        dx = boxlen / (1 << l)
        base = []
        offw = []
        for d in range(ndim):
            i0, ow = _stencil_1d(x[:, d] / dx, scheme)
            base.append(i0)
            offw.append(ow)
        nl = 1 << l
        base_cc = torch.stack(base, dim=1)
        idx, w = [], []
        for combo in itertools.product(*[range(len(ow)) for ow in offw]):
            cc = base_cc.clone()
            wc = torch.ones(npart, dtype=torch.float64, device=x.device)
            for d, k in enumerate(combo):
                off, wd = offw[d][k]
                cc[:, d] += off
                wc = wc * wd
            oob = torch.zeros(npart, dtype=torch.bool, device=x.device)
            for d in range(ndim):
                if open_dim[d]:
                    oob |= (cc[:, d] < 0) | (cc[:, d] >= nl)
            cc = _map_coords(cc, l, bc_kinds, ndim)
            wc = torch.where(oob, 0.0, wc)
            oi = _lookup(tree, l, cc >> 1, keys)
            off = torch.zeros(npart, dtype=torch.int64, device=x.device)
            for d in range(ndim):
                off = (off << 1) | (cc[:, d] & 1)
            hit = oi >= 0
            idx.append(torch.where(hit, oi * ttd + off, ncell_pad[l]))
            w.append(torch.where(hit, wc, 0.0))
        out[l] = PmLevelMap(lvl=l, idx=torch.stack(idx, dim=1),
                            w=torch.stack(w, dim=1), assigned=(levels == l))
    return out


def segment_plan(idx: torch.Tensor, w: torch.Tensor, ncell_pad: int) -> dict:
    """The deposit's segment plan of a device map ``idx``/``w`` ``[npart,
    ncorner]`` onto a level of ``ncell_pad`` rows: the entries that land on
    a real row (rows ``>= ncell_pad`` are the dump row, or out of range
    and dropped, as XLA drops them), sorted stably by row, with each
    entry's particle (``part``) and weight (``w_sorted``), and each row's
    entry count (``lengths [ncell_pad]``)."""
    flat = idx.reshape(-1)
    # one fetch: the count of real entries; they sort before the rest
    nvalid = int((flat < ncell_pad).sum())
    order = torch.argsort(flat, stable=True)[:nvalid]
    return dict(part=order // idx.shape[1], w_sorted=w.reshape(-1)[order],
                lengths=torch.bincount(flat[order], minlength=ncell_pad),
                ncell_pad=ncell_pad)


def device_maps(mp: PmLevelMap, ncell_pad: int, dtype) -> dict:
    """One level's maps for the deposit and the gather: ``idx``, ``w`` in
    ``dtype``, the ``mask`` of the particles assigned to the level, and the
    deposit's :func:`segment_plan`."""
    w = mp.w.to(dtype)
    return dict(idx=mp.idx, w=w, mask=mp.assigned,
                plan=segment_plan(mp.idx, w, ncell_pad))


def deposit_flat(plan: dict, m, active, cell_vol: float):
    """Segment-sum mass deposition into a flat level: the density
    ``[ncell_pad]`` from a :func:`segment_plan`, each row's contributions
    ``m·active·w`` summed in the map's order."""
    contrib = (m * active)[plan["part"]] * plan["w_sorted"]
    rho = torch.segment_reduce(contrib, "sum", lengths=plan["lengths"])
    return rho / cell_vol


def gather_flat(field, idx, w, mask):
    """Inverse-CIC gather of a per-cell field at mapped positions.

    ``field`` [ncell_pad, ncomp]; ``idx``/``w`` [npart, ncorner]; returns
    [npart, ncomp], zero rows for particles with ``mask`` False (their
    corners may carry dump-row indices from another level's map)."""
    ext = torch.cat([field, field.new_zeros((1, field.shape[1]))])
    vals = ext[idx]                            # [npart, ncorner, ncomp]
    out = torch.sum(vals * w[..., None], dim=1)
    return torch.where(mask[:, None], out, 0.0)
