"""Snapshot reader: parses ``output_NNNNN/`` back into arrays.

The port's own copy of ``ramses_tpu/io/reader.py``.  Record-walking
counterpart of :mod:`ramses_tpu_torch.io.snapshot` (the restart
path of the reference, ``amr/init_amr.f90`` / ``hydro/init_hydro.f90:137+``),
and the basis of the test oracle: :func:`leaf_cells` reproduces what the
reference's ``visu_ramses.load_snapshot`` extracts (leaf cells with
level/x/y/z/dx + primitive variables).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ramses_tpu_torch.io import fortran as frt

_KIND_DTYPES = {"d": np.float64, "f": np.float32, "i": np.int32,
                "q": np.int64, "b": np.int8, "h": np.int16}


def read_descriptor(path: str) -> List[tuple]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) >= 3:
                out.append((parts[1], parts[2]))
    return out


def read_info(path: str) -> dict:
    info = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            k, v = k.strip(), v.strip()
            try:
                info[k] = int(v)
            except ValueError:
                try:
                    info[k] = float(v)
                except ValueError:
                    info[k] = v
    return info


@dataclass
class AmrFileData:
    header: dict
    # per level: dict with ind_grid, xg [n, ndim], son [n, 2^d] (ref order)
    levels: Dict[int, dict] = field(default_factory=dict)


def read_amr_file(path: str) -> AmrFileData:
    with open(path, "rb") as f:
        h = {}
        h["ncpu"] = frt.read_int(f)
        h["ndim"] = frt.read_int(f)
        h["nx"], h["ny"], h["nz"] = frt.read_ints(f)
        h["nlevelmax"] = frt.read_int(f)
        h["ngridmax"] = frt.read_int(f)
        h["nboundary"] = frt.read_int(f)
        h["ngrid_current"] = frt.read_int(f)
        h["boxlen"] = float(frt.read_reals(f)[0])
        h["noutput"], h["iout"], h["ifout"] = frt.read_ints(f)
        h["tout"] = frt.read_reals(f)
        h["aout"] = frt.read_reals(f)
        h["t"] = float(frt.read_reals(f)[0])
        h["dtold"] = frt.read_reals(f)
        h["dtnew"] = frt.read_reals(f)
        h["nstep"], h["nstep_coarse"] = frt.read_ints(f)
        frt.read_reals(f)                       # einit, mass_tot_0, rho_tot
        h["cosmo"] = tuple(frt.read_reals(f))
        aexp_rec = frt.read_reals(f)
        h["aexp"] = float(aexp_rec[0])
        frt.read_reals(f)                       # mass_sph
        ncpu, nlev = h["ncpu"], h["nlevelmax"]
        h["headl"] = frt.read_ints(f).reshape(nlev, ncpu).T
        h["taill"] = frt.read_ints(f).reshape(nlev, ncpu).T
        h["numbl"] = frt.read_ints(f).reshape(nlev, ncpu).T
        frt.read_ints(f)                        # numbtot
        if h["nboundary"] > 0:
            frt.read_ints(f)
            frt.read_ints(f)
            h["numbb"] = frt.read_ints(f).reshape(nlev, -1).T
        frt.read_ints(f)                        # free list
        h["ordering"] = frt.read_str(f)
        if h["ordering"] == "bisection":
            for _ in range(5):
                frt.skip_record(f)
        else:
            h["bound_key"] = frt.read_reals(f)
        ncoarse = h["nx"] * h["ny"] * h["nz"]
        h["son_coarse"] = frt.read_ints(f)
        frt.read_ints(f)                        # flag1 coarse
        frt.read_ints(f)                        # cpu_map coarse

        ndim = h["ndim"]
        twotondim = 1 << ndim
        twondim = 2 * ndim
        data = AmrFileData(header=h)
        for l in range(1, nlev + 1):
            ncache = int(h["numbl"][:, l - 1].sum())
            if h["nboundary"] > 0:
                ncache_b = int(h["numbb"][:, l - 1].sum())
            else:
                ncache_b = 0
            if ncache + ncache_b == 0:
                continue
            ind_grid = frt.read_ints(f)
            frt.read_ints(f)                    # next
            frt.read_ints(f)                    # prev
            xg = np.stack([frt.read_reals(f) for _ in range(ndim)], axis=1)
            frt.read_ints(f)                    # father
            for _ in range(twondim):
                frt.read_ints(f)                # nbor
            son = np.stack([frt.read_ints(f) for _ in range(twotondim)],
                           axis=1)
            for _ in range(2 * twotondim):
                frt.read_ints(f)                # cpu_map, flag1
            data.levels[l] = dict(ind_grid=ind_grid, xg=xg, son=son)
        return data


def read_hydro_file(path: str) -> dict:
    with open(path, "rb") as f:
        ncpu = frt.read_int(f)
        nvar = frt.read_int(f)
        ndim = frt.read_int(f)
        nlevelmax = frt.read_int(f)
        nboundary = frt.read_int(f)
        gamma = float(frt.read_reals(f)[0])
        twotondim = 1 << ndim
        levels: Dict[int, np.ndarray] = {}
        for l in range(1, nlevelmax + 1):
            for ib in range(ncpu + nboundary):
                ilevel = frt.read_int(f)
                ncache = frt.read_int(f)
                if ncache == 0:
                    continue
                arr = np.empty((ncache, twotondim, nvar))
                for ind in range(twotondim):
                    for ivar in range(nvar):
                        arr[:, ind, ivar] = frt.read_reals(f)
                if ib < ncpu:
                    levels.setdefault(l, []).append(arr)
        for l in list(levels):
            levels[l] = np.concatenate(levels[l], axis=0)
        return dict(ncpu=ncpu, nvar=nvar, ndim=ndim, nlevelmax=nlevelmax,
                    gamma=gamma, levels=levels)


def read_grav_file(path: str) -> dict:
    with open(path, "rb") as f:
        ncpu = frt.read_int(f)
        nvar = frt.read_int(f)
        nlevelmax = frt.read_int(f)
        nboundary = frt.read_int(f)
        levels: Dict[int, np.ndarray] = {}
        twotondim = None
        for l in range(1, nlevelmax + 1):
            for ib in range(ncpu + nboundary):
                ilevel = frt.read_int(f)
                ncache = frt.read_int(f)
                if ncache == 0:
                    continue
                if twotondim is None:
                    # nvar = ndim + 1 ⇒ ndim ⇒ 2^ndim
                    twotondim = 1 << (nvar - 1)
                arr = np.empty((ncache, twotondim, nvar))
                for ind in range(twotondim):
                    for ivar in range(nvar):
                        arr[:, ind, ivar] = frt.read_reals(f)
                levels.setdefault(l, []).append(arr)
        for l in list(levels):
            levels[l] = np.concatenate(levels[l], axis=0)
        return dict(ncpu=ncpu, nvar=nvar, levels=levels)


def read_part_file(path: str, fields: List[tuple]) -> dict:
    with open(path, "rb") as f:
        ncpu = frt.read_int(f)
        ndim = frt.read_int(f)
        npart = frt.read_int(f)
        frt.read_ints(f)                        # localseed
        nstar = frt.read_int(f)
        mstar = float(frt.read_reals(f)[0])
        mstar_lost = float(frt.read_reals(f)[0])
        nsink = frt.read_int(f)
        out = dict(ncpu=ncpu, ndim=ndim, npart=npart, nstar_tot=nstar,
                   mstar_tot=mstar, mstar_lost=mstar_lost, nsink=nsink)
        for name, kind in fields:
            out[name] = frt.read_array(f, _KIND_DTYPES[kind])
        return out


def load_snapshot(outdir: str, read_grav: bool = False) -> dict:
    """Load a full snapshot directory (all cpu files)."""
    suffix = os.path.basename(outdir.rstrip("/")).split("_")[-1]
    info = read_info(os.path.join(outdir, f"info_{suffix}.txt"))
    ncpu = info["ncpu"]
    amr = []
    hyd = []
    grav = []
    for icpu in range(1, ncpu + 1):
        amr.append(read_amr_file(
            os.path.join(outdir, f"amr_{suffix}.out{icpu:05d}")))
        hyd.append(read_hydro_file(
            os.path.join(outdir, f"hydro_{suffix}.out{icpu:05d}")))
        gpath = os.path.join(outdir, f"grav_{suffix}.out{icpu:05d}")
        if read_grav and os.path.exists(gpath):
            grav.append(read_grav_file(gpath))
    var_names = [n for n, _ in read_descriptor(
        os.path.join(outdir, "hydro_file_descriptor.txt"))]
    snap = dict(info=info, amr=amr, hydro=hyd, grav=grav,
                var_names=var_names)
    pdesc = os.path.join(outdir, "part_file_descriptor.txt")
    if os.path.exists(pdesc):
        fields = read_descriptor(pdesc)
        parts = [read_part_file(
            os.path.join(outdir, f"part_{suffix}.out{icpu:05d}"), fields)
            for icpu in range(1, ncpu + 1)]
        snap["part"] = parts
        snap["part_fields"] = fields
    return snap


def leaf_cells(snap: dict) -> dict:
    """Leaf-cell table: the quantity ``visu_ramses.load_snapshot`` builds
    (cells where son==0 or level==levelmax) with positions in user units."""
    info = snap["info"]
    ndim = snap["amr"][0].header["ndim"]
    nlevelmax = snap["amr"][0].header["nlevelmax"]
    boxlen = snap["amr"][0].header["boxlen"]
    var_names = snap["var_names"]
    cols: Dict[str, List[np.ndarray]] = {k: [] for k in
                                         var_names + ["level", "dx"]
                                         + ["xyz"[d] for d in range(ndim)]}
    for amr, hyd in zip(snap["amr"], snap["hydro"]):
        for l, lev in amr.levels.items():
            if l not in hyd["levels"]:
                continue
            vals = hyd["levels"][l]               # [n, 2^d, nvar]
            son = lev["son"]
            xg = lev["xg"]
            dxc = 0.5 ** l
            n, ttd = son.shape
            for ind in range(ttd):
                leaf = ~((son[:, ind] > 0) & (l < nlevelmax))
                if not leaf.any():
                    continue
                # ref ind → cell offsets, x fastest
                cx = ind & 1
                cy = (ind >> 1) & 1 if ndim > 1 else 0
                cz = (ind >> 2) & 1 if ndim > 2 else 0
                offs = [cx, cy, cz][:ndim]
                for d in range(ndim):
                    x = xg[leaf, d] + (offs[d] - 0.5) * dxc
                    cols["xyz"[d]].append(x * boxlen)
                cols["level"].append(np.full(leaf.sum(), l))
                cols["dx"].append(np.full(leaf.sum(), dxc * boxlen))
                for iv, nm in enumerate(var_names):
                    cols[nm].append(vals[leaf, ind, iv])
    return {k: np.concatenate(v) if v else np.empty(0)
            for k, v in cols.items()}
