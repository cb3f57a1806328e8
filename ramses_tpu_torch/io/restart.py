"""Checkpoint-resume: rebuild simulation state from a snapshot directory.

The port's own copy of ``ramses_tpu/io/restart.py`` (host numpy; the
restored particles go to the caller's device once).

The reference restarts by re-reading its own dump inside ``init_amr`` /
``init_hydro`` / ``init_part`` (``nrestart>0``, SURVEY.md §5.4).  Here the
same files restore the host octree and the per-level conservative state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ramses_tpu_torch.io import reader as rdr
from ramses_tpu_torch.io.snapshot import prim_out_to_cons, ref_cell_perm


def restore_tree_state(outdir: str, cfg, levelmin: int, to_cons=None):
    """(tree_levels, u_levels, meta): per-level oct coords and conservative
    cell arrays (our x-slowest flat order) for levels >= levelmin.

    ``to_cons(q_rows)``: output-variable → stored-state conversion;
    defaults to the hydro ``prim_out_to_cons``.  MHD restores pass a
    converter for its extended column set (or identity to get the raw
    output rows)."""
    snap = rdr.load_snapshot(outdir)
    ncpu = len(snap["amr"])
    h = snap["amr"][0].header
    ndim = h["ndim"]
    perm = ref_cell_perm(ndim)
    inv = np.argsort(perm)                  # our off → ref ind

    # concatenate every domain's levels (``init_amr``'s multi-cpu read:
    # each file holds its own contiguous key range, any count merges)
    tree_og: Dict[int, np.ndarray] = {}
    u_lv: Dict[int, np.ndarray] = {}
    for l in sorted({lv for amr in snap["amr"] for lv in amr.levels}):
        if l < levelmin:
            continue
        scale = 2.0 ** (l - 1)
        ogs, qs = [], []
        for amr, hyd in zip(snap["amr"], snap["hydro"]):
            lev = amr.levels.get(l)
            if lev is None or len(lev["xg"]) == 0:
                continue
            ogs.append(np.rint(lev["xg"] * scale - 0.5).astype(np.int64))
            vals = hyd["levels"][l]         # [n, 2^d, nvar] ref order
            qs.append(vals[:, inv])         # our cell order
        if not ogs:
            continue
        tree_og[l] = np.concatenate(ogs)
        q = np.concatenate(qs).reshape(-1, qs[0].shape[2])
        u_lv[l] = (prim_out_to_cons(q, cfg) if to_cons is None
                   else to_cons(q))
    meta = dict(t=h["t"], nstep=h["nstep"], iout=h["iout"],
                aexp=h["aexp"], boxlen=h["boxlen"],
                nlevelmax=h["nlevelmax"], dtold=h["dtold"],
                dtnew=h["dtnew"], info=snap["info"])
    parts = None
    if "part" in snap:
        # concatenate array fields across domains; scalar header
        # entries (ncpu, npart, nstar_tot, …) come from file 1 with the
        # count totals recomputed
        first = snap["part"][0]
        parts = {}
        for k, v in first.items():
            if isinstance(v, np.ndarray):
                parts[k] = np.concatenate([p[k] for p in snap["part"]])
            else:
                parts[k] = v
        if "npart" in first:
            parts["npart"] = sum(int(p["npart"]) for p in snap["part"])
        parts["fields"] = snap["part_fields"]
    return tree_og, u_lv, meta, parts


def restore_particles(parts: Optional[dict], ndim: int, *, dtype, device,
                      nmax: Optional[int] = None):
    """Rebuild a :class:`ramses_tpu_torch.pm.particles.ParticleSet` in
    ``dtype`` on ``device`` from a read particle file (None for none).

    ``nmax`` (clamped to the stored count) sets the lane headroom for runs
    that keep creating particles.  Birth times and metallicities
    round-trip when the file carries the star records
    (``pm/output_part.f90`` optional ``birth_time``/``metallicity``)."""
    from ramses_tpu_torch.pm.particles import ParticleSet
    if parts is None:
        return None
    dims = "xyz"[:ndim]
    x = np.stack([parts[f"position_{d}"] for d in dims], axis=1)
    v = np.stack([parts[f"velocity_{d}"] for d in dims], axis=1)
    nmax = max(nmax or 0, len(x)) or None
    ps = ParticleSet.make(x, v, parts["mass"], dtype=dtype, device=device,
                          idp=parts["identity"].astype(np.int64),
                          family=parts["family"], nmax=nmax)
    pad = ps.n - len(x)
    for key, attr in (("birth_time", "tp"), ("metallicity", "zp")):
        if key in parts:
            setattr(ps, attr, torch.as_tensor(
                np.pad(np.asarray(parts[key], np.float64), (0, pad)),
                dtype=dtype, device=device))
    return ps


def restore_uniform(outdir: str, params, cfg) -> Tuple[np.ndarray, dict,
                                                       Optional[dict]]:
    """Dense [nvar, *sp] conservative state for a single-level hydro
    run."""
    base = [params.amr.nx, params.amr.ny, params.amr.nz][:cfg.ndim]
    lmin = params.amr.levelmin
    tree_og, u_lv, meta, parts = restore_tree_state(outdir, cfg, lmin)
    if lmin not in u_lv:
        raise ValueError(f"snapshot has no level {lmin} data")
    from ramses_tpu_torch.amr.tree import cell_offsets
    og = tree_og[lmin]
    ndim = cfg.ndim
    n = 1 << lmin
    offs = cell_offsets(ndim)
    cc = (2 * og[:, None, :] + offs[None, :, :]).reshape(-1, ndim)
    dense = np.zeros((cfg.nvar,)
                     + tuple(base[d] * n for d in range(ndim)))
    u = u_lv[lmin]                          # [ncell, nvar]
    idx = tuple(cc[:, d] for d in range(ndim))
    for iv in range(cfg.nvar):
        dense[iv][idx] = u[:, iv]
    return dense, meta, parts
