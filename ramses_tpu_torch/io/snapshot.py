"""Snapshot writer in the reference's on-disk layout.

The port's own copy of ``ramses_tpu/io/snapshot.py`` (host numpy): given the
same f64 state it writes the JAX package's bytes, file for file.  The
drivers' device tensors are fetched once each (:func:`host64`), outside any
step loop.  Particles (dark matter, stars and the MC gas tracers) ride
the part files; the sinks and the stellar objects have their CSVs
(:func:`write_sink_csv`, :func:`write_stellar_csv`).

One call to :func:`dump_all` produces ``output_NNNNN/`` with the same file
set and record structure as the reference's ``dump_all``
(``amr/output_amr.f90:5-206``): ``info_*.txt``, ``amr_*.outNNNNN``,
``hydro_*.outNNNNN``, optional ``grav_*/part_*`` files, ``header_*.txt``
and the ``*_file_descriptor.txt`` sidecars (``io/dump_utils.f90``).  The
record sequences follow ``backup_amr`` (``amr/output_amr.f90:268-393``),
``backup_hydro`` (``hydro/output_hydro.f90:54-160``), ``backup_part``
(``pm/output_part.f90``) and ``output_info/output_header``
(``amr/output_amr.f90:411-575``) byte for byte, so the reference's own
test oracle (``tests/visu/visu_ramses.py:load_snapshot``) parses our
snapshots unchanged.

The cell-in-oct index convention differs between us (x slowest, numpy
reshape order) and the reference (x fastest, ``ind=1+ix+2*iy+4*iz``); all
per-cell records are permuted to reference order on the way out.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ramses_tpu_torch.io import fortran as frt
from ramses_tpu_torch.units import Units


def host64(x) -> np.ndarray:
    """A device tensor (or array) as a host f64 numpy array: one
    device→host copy in the tensor's own dtype, then ``astype`` (exact
    for f32, the JAX package's ``np.asarray(x, np.float64)``)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.float64)


# ----------------------------------------------------------------------
# cell-order permutation
# ----------------------------------------------------------------------

def ref_cell_perm(ndim: int) -> np.ndarray:
    """perm[ind_ref] = our flat cell offset, where ind_ref runs x-fastest
    (the reference's ``ind_son``) and ours runs x-slowest."""
    n = 1 << ndim
    perm = np.zeros(n, dtype=np.int64)
    for ind in range(n):
        coords = [(ind >> d) & 1 for d in range(ndim)]   # cx, cy, cz
        off = 0
        for d in range(ndim):
            off += coords[d] << (ndim - 1 - d)
        perm[ind] = off
    return perm


# ----------------------------------------------------------------------
# hydro output variables (primitive, hydro/output_hydro.f90:84-146)
# ----------------------------------------------------------------------

def hydro_var_names(cfg) -> List[str]:
    dim_keys = ["x", "y", "z"]
    names = ["density"]
    names += [f"velocity_{dim_keys[d]}" for d in range(cfg.ndim)]
    names += [f"non_thermal_energy_{i + cfg.ndim:02d}"
              for i in range(cfg.nener)]
    names += ["pressure"]
    names += [f"scalar_{i:02d}" for i in range(cfg.npassive)]
    return names


def cons_to_prim_out(u: np.ndarray, cfg) -> np.ndarray:
    """[ncell, nvar] conservative → reference output variables (primitive).

    Mirrors the arithmetic of ``backup_hydro`` exactly: velocity =
    momentum/max(rho,smallr); non-thermal pressures (gamma_rad-1)*e;
    thermal pressure from total minus kinetic minus non-thermal; passive
    scalars per unit mass.
    """
    u = np.asarray(u, dtype=np.float64)
    ndim = cfg.ndim
    rho = np.maximum(u[:, 0], cfg.smallr)
    out = np.empty_like(u)
    out[:, 0] = u[:, 0]
    ekin = np.zeros_like(rho)
    for d in range(ndim):
        out[:, 1 + d] = u[:, 1 + d] / rho
        ekin += 0.5 * u[:, 1 + d] ** 2 / rho
    p = u[:, ndim + 1] - ekin
    for i in range(cfg.nener):
        e = u[:, ndim + 2 + i]
        out[:, ndim + 2 + i] = (cfg.gamma_rad[i] - 1.0) * e
        p = p - e
    out[:, ndim + 1] = (cfg.gamma - 1.0) * p
    for i in range(cfg.npassive):
        j = ndim + 2 + cfg.nener + i
        out[:, j] = u[:, j] / rho
    return out


def prim_out_to_cons(q: np.ndarray, cfg) -> np.ndarray:
    """Inverse of :func:`cons_to_prim_out` (the restart read,
    ``hydro/init_hydro.f90:137+``)."""
    q = np.asarray(q, dtype=np.float64)
    ndim = cfg.ndim
    u = np.empty_like(q)
    rho = q[:, 0]
    u[:, 0] = rho
    ekin = np.zeros_like(rho)
    for d in range(ndim):
        u[:, 1 + d] = rho * q[:, 1 + d]
        ekin += 0.5 * rho * q[:, 1 + d] ** 2
    etot = q[:, ndim + 1] / (cfg.gamma - 1.0) + ekin
    for i in range(cfg.nener):
        e = q[:, ndim + 2 + i] / (cfg.gamma_rad[i] - 1.0)
        u[:, ndim + 2 + i] = e
        etot = etot + e
    u[:, ndim + 1] = etot
    for i in range(cfg.npassive):
        j = ndim + 2 + cfg.nener + i
        u[:, j] = rho * q[:, j]
    return u


# ----------------------------------------------------------------------
# MHD output variables (mhd/output_hydro.f90:82-150: density, velocity,
# B_left, B_right, [non-thermal], thermal_pressure, scalars)
# ----------------------------------------------------------------------

def mhd_var_names(mcfg) -> List[str]:
    dim_keys = ["x", "y", "z"]
    names = ["density"]
    names += [f"velocity_{k}" for k in dim_keys]
    names += [f"B_{k}_left" for k in dim_keys]
    names += [f"B_{k}_right" for k in dim_keys]
    names += ["thermal_pressure"]
    names += [f"scalar_{i:02d}" for i in range(mcfg.npassive)]
    return names


def mhd_rows_to_out(raw: np.ndarray, mcfg) -> np.ndarray:
    """Raw rows [n, nvar+6] = [u | bf_left(3) | bf_right(3)] → the
    reference MHD output columns (``mhd/output_hydro.f90:82-150``)."""
    raw = np.asarray(raw, dtype=np.float64)
    nv = mcfg.nvar
    rho = np.maximum(raw[:, 0], mcfg.smallr)
    out = np.empty((len(raw), 11 + mcfg.npassive))
    out[:, 0] = raw[:, 0]
    ekin = np.zeros_like(rho)
    for c in range(3):
        out[:, 1 + c] = raw[:, 1 + c] / rho
        ekin += 0.5 * raw[:, 1 + c] ** 2 / rho
    emag = 0.5 * (raw[:, 5:8] ** 2).sum(axis=1)
    out[:, 4:7] = raw[:, nv:nv + 3]          # B_left
    out[:, 7:10] = raw[:, nv + 3:nv + 6]     # B_right
    out[:, 10] = (mcfg.gamma - 1.0) * (raw[:, 4] - ekin - emag)
    for i in range(mcfg.npassive):
        out[:, 11 + i] = raw[:, 8 + i] / rho
    return out


def mhd_out_to_state(q: np.ndarray, mcfg):
    """Inverse of :func:`mhd_rows_to_out`: output columns → (u rows
    [n, nvar], bf rows [n, 3, 2]) with cell-centred B rebuilt as the
    face mean (``mhd/init_hydro.f90`` restart read)."""
    q = np.asarray(q, dtype=np.float64)
    n = len(q)
    u = np.zeros((n, mcfg.nvar))
    bf = np.zeros((n, 3, 2))
    rho = q[:, 0]
    u[:, 0] = rho
    ekin = np.zeros(n)
    for c in range(3):
        u[:, 1 + c] = rho * q[:, 1 + c]
        ekin += 0.5 * rho * q[:, 1 + c] ** 2
    bf[:, :, 0] = q[:, 4:7]
    bf[:, :, 1] = q[:, 7:10]
    bc = 0.5 * (bf[:, :, 0] + bf[:, :, 1])
    u[:, 5:8] = bc
    emag = 0.5 * (bc ** 2).sum(axis=1)
    u[:, 4] = q[:, 10] / (mcfg.gamma - 1.0) + ekin + emag
    for i in range(mcfg.npassive):
        u[:, 8 + i] = rho * q[:, 11 + i]
    return u, bf


def snapshot_from_mhd_amr(sim, iout: int = 1) -> Snapshot:
    """Snapshot of an :class:`~ramses_tpu_torch.mhd.amr.MhdAmrSim` — the raw
    rows append both duplicated face fields to the cell state so the
    staggered field round-trips exactly."""
    mcfg = sim.mcfg

    def raw_of(l, nc):
        u = host64(sim.u[l][:nc])
        bf = host64(sim.bfs[l][:nc])
        return np.concatenate([u, bf[:, :, 0], bf[:, :, 1]], axis=1)

    return snapshot_from_amr(
        sim, iout, raw_of=raw_of,
        to_out=lambda rows: mhd_rows_to_out(rows, mcfg),
        names=mhd_var_names(mcfg), nvar_raw=mcfg.nvar + 6,
        gamma=mcfg.gamma)


def write_sink_csv(path: str, sinks, dmf: Optional[dict] = None) -> None:
    """``sink_NNNNN.csv`` with the reference's column header
    (``pm/output_sink.f90:16-27``); unsampled quantities (angular
    momentum, Bondi diagnostics, SMBH mass) write 0 — the oracle
    (``tests/visu/visu_ramses.py:424-447``) parses any float there."""
    with open(path, "w") as f:
        f.write(" # id,msink,x,y,z,vx,vy,vz,lx,ly,lz,tform,acc_rate,"
                "del_mass,rho_gas,cs**2,etherm,vx_gas,vy_gas,vz_gas,"
                "mbh,dmfsink,level \n")
        f.write(" # 1,m,l,l,l,l t**-1,l t**-1,l t**-1,m l**2 t**-1,"
                "m l**2 t**-1,m l**2 t**-1,t,m t**-1,m,m l**-3,"
                "l**2 t**-2,m l**2 t**-2,l t**-1,l t**-1,l t**-1,"
                "m,m,1\n")
        nd = sinks.x.shape[1]
        for k in range(sinks.n):
            x3 = list(sinks.x[k]) + [0.0] * (3 - nd)
            v3 = list(sinks.v[k]) + [0.0] * (3 - nd)
            dmfk = (dmf or {}).get(int(sinks.idp[k]), 0.0)
            vals = ([sinks.m[k]] + x3 + v3 + [0.0, 0.0, 0.0]
                    + [sinks.tform[k], 0.0, 0.0, 0.0, 0.0, 0.0,
                       0.0, 0.0, 0.0, 0.0, dmfk])
            f.write(f"{int(sinks.idp[k]):10d}"
                    + "".join(f",{v:21.10e}" for v in vals)
                    + f",{1:10d}\n")


def write_stellar_csv(path: str, stellar) -> None:
    """``stellar_NNNNN.csv`` (``pm/output_stellar.f90:16-21``)."""
    with open(path, "w") as f:
        f.write(" # id,mstellar,tform,tlife \n")
        f.write(" # 1,m,t,t\n")
        for k in range(stellar.n):
            f.write(f"{int(stellar.idp[k]):10d},{stellar.m[k]:21.10e},"
                    f"{stellar.tform[k]:21.10e},"
                    f"{stellar.tlife[k]:21.10e}\n")


# ----------------------------------------------------------------------
# snapshot tree model
# ----------------------------------------------------------------------

@dataclass
class SnapLevel:
    """One output level: octs in storage order (our sorted-key order)."""
    og: np.ndarray                      # [noct, ndim] int oct coords
    son: np.ndarray                     # [noct, 2^d] global son grid ids,
    #                                     reference ind order, 0 = leaf
    hydro: np.ndarray                   # [noct, 2^d, nvar_out] float64,
    #                                     reference ind order
    grav: Optional[np.ndarray] = None   # [noct, 2^d, ndim+1] phi + forces

    @property
    def noct(self) -> int:
        return len(self.og)


@dataclass
class Snapshot:
    """Everything :func:`dump_all` needs, solver-agnostic."""
    ndim: int
    nlevelmax: int                       # declared max (levelmax)
    levels: Dict[int, SnapLevel]         # 1-based level → data
    boxlen: float
    t: float
    gamma: float
    var_names: List[str]
    units: Units
    levelmin: int = 1
    nstep: int = 0
    nstep_coarse: int = 0
    aexp: float = 1.0
    cosmo: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.045, 1.0, 1.0, 1.0)
    # (omega_m, omega_l, omega_k, omega_b, h0, aexp_ini, boxlen_ini)
    dtold: Optional[np.ndarray] = None
    dtnew: Optional[np.ndarray] = None
    tout: Sequence[float] = (0.0,)
    particles: Optional[dict] = None     # arrays: x,v,m,idp,level,family,tag
    mstar_tot: float = 0.0
    mstar_lost: float = 0.0
    # coarse grid dimensions (&AMR_PARAMS nx, ny, nz — the reference's
    # icoarse/jcoarse/kcoarse extents, amr/init_amr.f90:37-60); cells
    # stay cubic with side boxlen/2^l, the domain extends to
    # (nx, ny, nz)·boxlen
    base: Tuple[int, ...] = (1, 1, 1)

    def grid_id_base(self) -> Dict[int, int]:
        base, tot = {}, 0
        for l in range(1, self.nlevelmax + 1):
            base[l] = tot
            tot += self.levels[l].noct if l in self.levels else 0
        return base

    @property
    def ngrid_total(self) -> int:
        return sum(lv.noct for lv in self.levels.values())


# ----------------------------------------------------------------------
# builders
# ----------------------------------------------------------------------

def _dense_to_level(dense: np.ndarray) -> np.ndarray:
    """Restrict a dense [*sp, nvar] cell array one level down (2^d mean)."""
    nd = dense.ndim - 1
    sl = dense
    for d in range(nd):
        sh = sl.shape
        ns = sh[d] // 2
        sl = sl.reshape(sh[:d] + (ns, 2) + sh[d + 1:])
        sl = sl.mean(axis=d + 1)
    return sl


def _full_level_og(lvl: int, ndim: int, base=None) -> np.ndarray:
    """All oct coords of a complete level, Morton-key sorted order.
    ``base``: coarse-grid dims (nx, ny, nz); level-l oct extents are
    ``base[d] * 2^(l-1)``."""
    from ramses_tpu_torch.amr import keys as kmod
    n = 1 << (lvl - 1)
    if base is None:
        base = (1,) * ndim
    axes = [np.arange(base[d] * n, dtype=np.int64) for d in range(ndim)]
    grids = np.meshgrid(*axes, indexing="ij")
    og = np.stack([g.ravel() for g in grids], axis=1)
    ks = kmod.encode(og, ndim)
    return og[np.argsort(ks, kind="stable")]


def _gather_cells_dense(dense: np.ndarray, og: np.ndarray,
                        perm: np.ndarray) -> np.ndarray:
    """Per-oct cell values from a dense [*sp, nvar] array, ref ind order."""
    from ramses_tpu_torch.amr.tree import cell_offsets
    ndim = og.shape[1]
    offs = cell_offsets(ndim)                       # our flat order
    cc = (2 * og[:, None, :] + offs[None, :, :])    # [noct, 2^d, ndim]
    idx = tuple(cc[..., d] for d in range(ndim))
    vals = dense[idx]                               # [noct, 2^d, nvar]
    return vals[:, perm]


def uniform_levels_from_dense(dense: np.ndarray, lmin: int,
                              ndim: int, base=None) -> Dict[int, SnapLevel]:
    """Scaffolded level set 1..lmin from a dense [*sp, nvar_out] array of
    already-converted output variables (scaffold values by plain mean —
    adequate for the never-leaf coarse levels).  ``base``: coarse-grid
    dims for non-cubic boxes (nx, ny, nz)."""
    from ramses_tpu_torch.amr import keys as kmod
    from ramses_tpu_torch.amr.tree import cell_offsets

    if base is None:
        base = (1,) * ndim
    ncoarse = int(np.prod(base))
    perm = ref_cell_perm(ndim)
    offs = cell_offsets(ndim)
    denses = {lmin: dense}
    for l in range(lmin - 1, 0, -1):
        denses[l] = _dense_to_level(denses[l + 1])
    id_base, tot = {}, 0
    for l in range(1, lmin + 1):
        id_base[l] = tot
        tot += ncoarse * (1 << (l - 1)) ** ndim
    levels: Dict[int, SnapLevel] = {}
    for l in range(1, lmin + 1):
        og = _full_level_og(l, ndim, base)
        hyd = _gather_cells_dense(denses[l], og, perm)
        if l < lmin:
            cc = (2 * og[:, None, :] + offs[None, :, :]).reshape(-1, ndim)
            og1 = _full_level_og(l + 1, ndim, base)
            ks1 = kmod.encode(og1, ndim)
            pos = np.searchsorted(ks1, kmod.encode(cc, ndim))
            son = (id_base[l + 1] + pos + 1).astype(np.int32)
            son = son.reshape(len(og), -1)[:, perm]
        else:
            son = np.zeros((len(og), 1 << ndim), dtype=np.int32)
        levels[l] = SnapLevel(og=og, son=son, hydro=hyd)
    return levels


def snapshot_from_uniform(sim, iout: int = 1) -> Snapshot:
    """Build a snapshot from a single-level
    :class:`~ramses_tpu_torch.driver.Simulation`.

    Emits the full scaffold hierarchy 1..levelmin (coarser levels fully
    refined, values by conservative restriction) so readers that walk the
    octree see the same structure the reference writes.
    """
    from ramses_tpu_torch.units import units as units_fn

    cfg = sim.cfg
    params = sim.params
    lmin = params.amr.levelmin
    ndim = cfg.ndim
    perm = ref_cell_perm(ndim)
    base = tuple([params.amr.nx, params.amr.ny, params.amr.nz][:ndim])

    u = host64(sim.state.u)                         # [nvar, *sp]
    dense = np.moveaxis(u, 0, -1)                   # [*sp, nvar]
    dense_prim = cons_to_prim_out(
        dense.reshape(-1, cfg.nvar), cfg).reshape(dense.shape)
    levels = uniform_levels_from_dense(dense_prim, lmin, ndim, base)

    if getattr(sim.state, "f", None) is not None:
        f = host64(sim.state.f)                          # [ndim, *sp]
        # the uniform driver keeps no potential: the phi column is zero,
        # as the JAX package's uniform driver writes it
        phi = np.zeros((1,) + f.shape[1:])
        grav_dense = np.moveaxis(np.concatenate([phi, f], axis=0), 0, -1)
        for l, lv in levels.items():
            if l == lmin:
                lv.grav = _gather_cells_dense(grav_dense, lv.og, perm)
            else:
                lv.grav = np.zeros((lv.noct, 1 << ndim, ndim + 1))

    cosmo = getattr(sim, "cosmo", None)
    aexp = (float(cosmo.aexp_of_tau(sim.state.t))
            if cosmo is not None else 1.0)
    un = units_fn(params, cosmo=cosmo, aexp=aexp)
    snap = Snapshot(
        ndim=ndim, nlevelmax=max(params.amr.levelmax, lmin), levels=levels,
        boxlen=float(params.amr.boxlen), t=float(sim.state.t),
        gamma=cfg.gamma, var_names=hydro_var_names(cfg), units=un,
        levelmin=lmin, nstep=int(sim.state.nstep),
        nstep_coarse=int(sim.state.nstep),
        tout=[params.output.tend or 0.0],
        base=base + (1,) * (3 - ndim),
    )
    if cosmo is not None:
        snap.aexp = aexp
        snap.cosmo = (cosmo.omega_m, cosmo.omega_l, cosmo.omega_k,
                      cosmo.omega_b, cosmo.h0, cosmo.aexp_ini,
                      cosmo.boxlen_ini)
    if getattr(sim.state, "p", None) is not None:
        snap.particles = particles_dict(sim.state.p)
    return snap


def snapshot_from_amr(sim, iout: int = 1, raw_of=None, to_out=None,
                      names: Optional[List[str]] = None,
                      nvar_raw: Optional[int] = None,
                      gamma: Optional[float] = None) -> Snapshot:
    """Build a snapshot from an
    :class:`~ramses_tpu_torch.amr.hierarchy.AmrSim` (host octree +
    levels).

    The optional hooks generalize the cell-state handling for solver
    families whose stored state is not the hydro [ncell, nvar] array
    (MHD carries staggered faces): ``raw_of(l, nc)`` returns the raw
    per-cell rows of a level, ``to_out(rows)`` converts raw rows to the
    reference output variables, ``names`` the matching column names,
    ``nvar_raw`` the raw column count.  Defaults implement the hydro
    behaviour (``cons_to_prim_out`` on ``sim.u``).
    """
    from ramses_tpu_torch.amr import keys as kmod
    from ramses_tpu_torch.amr.tree import cell_offsets
    from ramses_tpu_torch.units import units as units_fn

    cfg = sim.cfg
    params = sim.params
    ndim = cfg.ndim
    if raw_of is None:
        # the port has no balance layouts: a level's real rows are its
        # leading rows, in tree order
        def raw_of(l, nc):
            return host64(sim.u[l][:nc])
    if to_out is None:
        to_out = lambda rows: cons_to_prim_out(rows, cfg)
    names = names if names is not None else hydro_var_names(cfg)
    nvar_raw = nvar_raw if nvar_raw is not None else cfg.nvar
    gamma = gamma if gamma is not None else cfg.gamma
    lmin, lmax = sim.lmin, sim.lmax
    perm = ref_cell_perm(ndim)
    offs = cell_offsets(ndim)
    tree = sim.tree

    # per-level oct sets: scaffold 1..lmin-1 complete, lmin..finest real
    og_of: Dict[int, np.ndarray] = {}
    for l in range(1, lmin):
        og_of[l] = _full_level_og(l, ndim, base=tree.root)
    for l in range(lmin, lmax + 1):
        if tree.has(l):
            og_of[l] = tree.levels[l].og

    id_base, tot = {}, 0
    for l in sorted(og_of):
        id_base[l] = tot
        tot += len(og_of[l])

    # cell values: real levels from device state; scaffold by restriction
    cellvals: Dict[int, np.ndarray] = {}
    for l in range(lmin, lmax + 1):
        if not tree.has(l):
            continue
        m = sim.maps[l]
        nc = m.noct * (1 << ndim)
        cellvals[l] = raw_of(l, nc)
    dense = None
    for l in range(lmin - 1, 0, -1):
        if dense is None:
            # build dense array at lmin (complete base level)
            nv = nvar_raw
            dense = np.zeros(tree.cell_dims(lmin) + (nv,))
            cc = tree.cell_coords(lmin)
            dense[tuple(cc[:, d] for d in range(ndim))] = cellvals[lmin]
            dense = _dense_to_level(dense)
        else:
            dense = _dense_to_level(dense)
        cc = (2 * og_of[l][:, None, :] + offs[None, :, :]).reshape(-1, ndim)
        cellvals[l] = dense[tuple(cc[:, d] for d in range(ndim))]

    levels: Dict[int, SnapLevel] = {}
    for l, og in og_of.items():
        noct = len(og)
        cc = (2 * og[:, None, :] + offs[None, :, :]).reshape(-1, ndim)
        if (l + 1) in og_of:
            ks1 = kmod.encode(og_of[l + 1], ndim)
            pos = np.searchsorted(ks1, kmod.encode(cc, ndim))
            pos = np.clip(pos, 0, len(ks1) - 1)
            hit = ks1[pos] == kmod.encode(cc, ndim)
            son = np.where(hit, id_base[l + 1] + pos + 1, 0).astype(np.int32)
        else:
            son = np.zeros(noct * (1 << ndim), dtype=np.int32)
        hyd = to_out(cellvals[l])
        levels[l] = SnapLevel(
            og=og, son=son.reshape(noct, -1)[:, perm],
            hydro=hyd.reshape(noct, 1 << ndim, -1)[:, perm])

    # the JAX package's hierarchy writes the non-cosmological units and no
    # cosmo record, whatever the run
    un = units_fn(params)
    parts = (particles_dict(sim.p)
             if getattr(sim, "p", None) is not None else None)
    trc = getattr(sim, "tracer_x", None)
    if trc is not None and len(trc):
        # gas tracers ride the particle files as massless
        # FAM_GAS_TRACER entries (``pm/output_part.f90`` writes them
        # in the same records).  Ids are the sim's stable per-tracer
        # ids (assigned once at seeding) so cross-snapshot trajectory
        # tracking by id survives particle-population changes.
        tb = _tracer_dict(np.asarray(trc, np.float64),
                          np.asarray(sim.tracer_id))
        parts = (tb if parts is None else
                 {k: np.concatenate([parts[k], tb[k]]) for k in parts})
    # per-level dtold/dtnew from the exact factor-2 subcycling
    # (``amr/update_time.f90`` bookkeeping): restarts need the lmin
    # dtold to complete the pending closing half-kick, and the lmin
    # dtnew (the fused step's emitted CFL dt) to take the SAME next
    # step a continuous run would
    def sub(v):
        return np.array([float(v) * 0.5 ** max(l - lmin, 0)
                         for l in range(1, lmax + 1)])

    dtc = getattr(sim, "_dt_cache", None)   # a 0-d device tensor: fetched
    return Snapshot(
        ndim=ndim, nlevelmax=lmax, levels=levels,
        boxlen=sim.boxlen, t=float(sim.t), gamma=gamma,
        var_names=names, units=un, levelmin=lmin,
        nstep=int(sim.nstep), nstep_coarse=int(sim.nstep),
        tout=[params.output.tend or 0.0], particles=parts,
        dtold=sub(getattr(sim, "dt_old", 0.0)),
        dtnew=sub(dtc) if dtc is not None else None)


def _tracer_dict(x: np.ndarray, ids: np.ndarray) -> dict:
    """Massless FAM_GAS_TRACER rows in the JAX package's
    ``particles_dict`` layout for the tracer positions ``x`` with
    per-tracer ids."""
    from ramses_tpu_torch.pm.particles import FAM_GAS_TRACER
    n = len(x)
    z = np.zeros(n)
    return dict(
        x=np.asarray(x, np.float64), v=np.zeros_like(x), m=z.copy(),
        idp=np.asarray(ids).astype(np.int32),
        level=np.full(n, 1, dtype=np.int32),
        family=np.full(n, FAM_GAS_TRACER, dtype=np.int8),
        tag=np.zeros(n, dtype=np.int8), tp=z.copy(), zp=z.copy())


def particles_dict(p) -> dict:
    """Host copies of a :class:`ramses_tpu_torch.pm.particles.ParticleSet`
    (one fetch a field), active lanes only, in the JAX package's
    ``particles_dict`` layout."""
    h = p.to_host()
    act = h["active"].astype(bool)
    n = int(act.sum())
    return dict(
        x=h["x"].astype(np.float64)[act],
        v=h["v"].astype(np.float64)[act],
        m=h["m"].astype(np.float64)[act],
        idp=h["idp"][act].astype(np.int32),
        level=np.full(n, 1, dtype=np.int32),
        family=h["family"][act].astype(np.int8),
        tag=np.zeros(n, dtype=np.int8),
        tp=h["tp"].astype(np.float64)[act],
        zp=h["zp"].astype(np.float64)[act],
    )


# ----------------------------------------------------------------------
# file writers
# ----------------------------------------------------------------------

def _fname(outdir: str, ftype: str, iout: int, icpu: int) -> str:
    return os.path.join(outdir, f"{ftype}_{iout:05d}.out{icpu:05d}")


def write_amr_file(path: str, snap: Snapshot, iout: int,
                   ncpu: int = 1, icpu: int = 1,
                   partial_links: bool = False) -> None:
    """``backup_amr`` record sequence (``amr/output_amr.f90:268-393``).

    ``partial_links``: the snapshot holds only one domain's octs, so
    father/nbor grid ids pointing into other domains cannot be
    resolved — write 0 (the reference's null link) instead of a wrong
    clipped lookup.  Our restart path rebuilds topology from ``xg``
    coordinates and never reads these records."""
    ndim = snap.ndim
    nlevelmax = snap.nlevelmax
    twotondim = 1 << ndim
    twondim = 2 * ndim
    base = tuple(snap.base[:ndim]) + (1,) * (3 - ndim)
    ncoarse = int(np.prod(base))
    ngrid = snap.ngrid_total
    ngridmax = max(ngrid, 1)
    id_base = snap.grid_id_base()
    noutput = max(1, len(snap.tout))
    tout = np.asarray(list(snap.tout) + [0.0] * noutput, dtype=np.float64)
    tout = tout[:noutput]
    dtold = (snap.dtold if snap.dtold is not None
             else np.zeros(nlevelmax))[:nlevelmax]
    dtnew = (snap.dtnew if snap.dtnew is not None
             else np.zeros(nlevelmax))[:nlevelmax]

    numbl = np.zeros((ncpu, nlevelmax), dtype=np.int32)
    headl = np.zeros((ncpu, nlevelmax), dtype=np.int32)
    taill = np.zeros((ncpu, nlevelmax), dtype=np.int32)
    for l in range(1, nlevelmax + 1):
        if l in snap.levels and snap.levels[l].noct > 0:
            n = snap.levels[l].noct
            numbl[icpu - 1, l - 1] = n
            headl[icpu - 1, l - 1] = id_base[l] + 1
            taill[icpu - 1, l - 1] = id_base[l] + n
    numbtot = np.zeros((10, nlevelmax), dtype=np.int32)
    numbtot[0] = numbl.sum(axis=0)
    numbtot[1] = numbl.min(axis=0)
    numbtot[2] = numbl.max(axis=0)

    with open(path, "wb") as f:
        frt.write_ints(f, ncpu)
        frt.write_ints(f, ndim)
        frt.write_ints(f, *base)                         # nx, ny, nz
        frt.write_ints(f, nlevelmax)
        frt.write_ints(f, ngridmax)
        frt.write_ints(f, 0)                             # nboundary
        frt.write_ints(f, ngrid)                         # ngrid_current
        frt.write_reals(f, snap.boxlen)
        frt.write_ints(f, noutput, iout, iout)           # noutput,iout,ifout
        frt.write_record(f, tout)
        frt.write_record(f, np.ones(noutput))            # aout
        frt.write_reals(f, snap.t)
        frt.write_record(f, np.asarray(dtold, dtype=np.float64))
        frt.write_record(f, np.asarray(dtnew, dtype=np.float64))
        frt.write_ints(f, snap.nstep, snap.nstep_coarse)
        frt.write_reals(f, 0.0, 0.0, 0.0)   # einit, mass_tot_0, rho_tot
        om, ol, ok, ob, h0, aexp_ini, boxlen_ini = snap.cosmo
        frt.write_reals(f, om, ol, ok, ob, h0, aexp_ini, boxlen_ini)
        frt.write_reals(f, snap.aexp, 0.0, snap.aexp, 0.0, 0.0)
        # aexp, hexp, aexp_old, epot_tot_int, epot_tot_old
        frt.write_reals(f, 0.0)                          # mass_sph
        # level linked lists (Fortran column-major: cpu fastest)
        frt.write_record(f, headl.T.ravel().astype(np.int32))
        frt.write_record(f, taill.T.ravel().astype(np.int32))
        frt.write_record(f, numbl.T.ravel().astype(np.int32))
        frt.write_record(f, numbtot.T.ravel().astype(np.int32))
        # free memory
        frt.write_ints(f, 0, 0, 0, ngrid, ngrid)
        frt.write_str(f, "hilbert", 128)
        ndomain = ncpu
        bk_max = float(2 ** min(ndim * nlevelmax, 62))
        bound_key = np.linspace(0.0, bk_max, ndomain + 1)
        frt.write_record(f, bound_key)
        # coarse level: each coarse cell's son = the covering level-1
        # oct's grid id (x-fastest cell order, init_amr.f90 ind layout)
        if 1 in snap.levels and snap.levels[1].noct:
            axes = [np.arange(base[d], dtype=np.int64)
                    for d in range(ndim)]
            gr = np.meshgrid(*axes, indexing="ij")
            cc = np.stack([g.ravel() for g in gr], axis=1)
            order = np.zeros(len(cc), dtype=np.int64)    # x-fastest
            for d in range(ndim - 1, -1, -1):
                order = order * base[d] + cc[:, d]
            son_c = np.zeros(ncoarse, dtype=np.int32)
            son_c[order] = _lookup_ids(snap.levels[1].og, cc, 0)
        else:
            son_c = np.zeros(ncoarse, dtype=np.int32)
        frt.write_record(f, son_c)                        # son
        frt.write_record(f, np.zeros(ncoarse, dtype=np.int32))  # flag1
        frt.write_record(f, np.full(ncoarse, icpu, dtype=np.int32))
        # fine levels
        for l in range(1, nlevelmax + 1):
            lv = snap.levels.get(l)
            if lv is None or lv.noct == 0:
                continue
            n = lv.noct
            ids = np.arange(id_base[l] + 1, id_base[l] + n + 1,
                            dtype=np.int32)
            frt.write_record(f, ids)                     # ind_grid
            nxt = np.where(ids < id_base[l] + n, ids + 1, 0).astype(np.int32)
            frt.write_record(f, nxt)                     # next
            prv = np.where(ids > id_base[l] + 1, ids - 1, 0).astype(np.int32)
            frt.write_record(f, prv)                     # prev
            scale = 0.5 ** (l - 1)
            for d in range(ndim):
                frt.write_record(f, (lv.og[:, d] + 0.5) * scale)
            # father cell index
            if l == 1:
                # the coarse cell this oct fills (x-fastest, 1-based)
                acc = np.zeros(n, dtype=np.int64)
                for d in range(ndim - 1, -1, -1):
                    acc = acc * base[d] + lv.og[:, d]
                father = (acc + 1).astype(np.int32)
            elif partial_links:
                father = np.zeros(n, dtype=np.int32)
            else:
                pog = lv.og // 2
                coff = lv.og - 2 * pog
                ind_ref = np.zeros(n, dtype=np.int64)
                for d in range(ndim):
                    ind_ref += coff[:, d] << d           # x fastest
                plv = snap.levels[l - 1]
                pid = _lookup_ids(plv.og, pog, id_base[l - 1])
                father = (ncoarse + ind_ref * ngridmax + pid).astype(np.int32)
            frt.write_record(f, father)
            # nbor: father's 2*ndim neighbour cells,
            # reference order (-x,+x,-y,+y,-z,+z)
            for idir in range(twondim):
                d, sgn = idir // 2, (-1 if idir % 2 == 0 else 1)
                if l == 1:
                    # neighbour COARSE cell index (periodic wrap)
                    cc = lv.og.copy()
                    cc[:, d] = np.mod(cc[:, d] + sgn, base[d])
                    acc = np.zeros(n, dtype=np.int64)
                    for dd in range(ndim - 1, -1, -1):
                        acc = acc * base[dd] + cc[:, dd]
                    frt.write_record(f, (acc + 1).astype(np.int32))
                    continue
                if partial_links:
                    frt.write_record(f, np.zeros(n, dtype=np.int32))
                    continue
                cc = lv.og.copy()
                cc[:, d] += sgn
                ncell = base[d] << (l - 1)
                cc[:, d] = np.mod(cc[:, d], ncell)       # periodic wrap
                pog = cc // 2
                coff = cc - 2 * pog
                ind_ref = np.zeros(n, dtype=np.int64)
                for dd in range(ndim):
                    ind_ref += coff[:, dd] << dd
                plv = snap.levels[l - 1]
                pid = _lookup_ids(plv.og, pog, id_base[l - 1])
                frt.write_record(
                    f, (ncoarse + ind_ref * ngridmax + pid).astype(np.int32))
            # son / cpu_map / flag1 per cell slot (reference ind order)
            for ind in range(twotondim):
                frt.write_record(f, lv.son[:, ind].astype(np.int32))
            for ind in range(twotondim):
                frt.write_record(f, np.full(n, icpu, dtype=np.int32))
            for ind in range(twotondim):
                frt.write_record(f, np.zeros(n, dtype=np.int32))


def _lookup_ids(og_sorted: np.ndarray, q: np.ndarray, base: int) -> np.ndarray:
    """Global grid ids of oct coords ``q`` within a level's sorted oct set."""
    from ramses_tpu_torch.amr import keys as kmod
    ndim = og_sorted.shape[1]
    ks = kmod.encode(og_sorted, ndim)
    kq = kmod.encode(q.astype(np.int64), ndim)
    pos = np.searchsorted(ks, kq)
    pos = np.clip(pos, 0, len(ks) - 1)
    return base + pos + 1


def write_hydro_file(path: str, snap: Snapshot, desc_path: Optional[str],
                     ncpu: int = 1, icpu: int = 1) -> None:
    """``backup_hydro`` record sequence (``hydro/output_hydro.f90:54-160``)."""
    ndim = snap.ndim
    twotondim = 1 << ndim
    nvar = len(snap.var_names)
    with open(path, "wb") as f:
        frt.write_ints(f, ncpu)
        frt.write_ints(f, nvar)
        frt.write_ints(f, ndim)
        frt.write_ints(f, snap.nlevelmax)
        frt.write_ints(f, 0)
        frt.write_reals(f, snap.gamma)
        for l in range(1, snap.nlevelmax + 1):
            for ibound in range(ncpu):
                # a domain's file carries data only in its own slot
                lv = snap.levels.get(l) if ibound == icpu - 1 else None
                ncache = lv.noct if lv is not None else 0
                frt.write_ints(f, l)
                frt.write_ints(f, ncache)
                if ncache == 0:
                    continue
                for ind in range(twotondim):
                    for ivar in range(nvar):
                        frt.write_record(f, lv.hydro[:, ind, ivar])
    if desc_path:
        write_descriptor(desc_path, [(v, "d") for v in snap.var_names])


def write_grav_file(path: str, snap: Snapshot, ncpu: int = 1,
                    icpu: int = 1) -> None:
    """``backup_poisson`` record sequence (``poisson/output_poisson.f90``):
    header ncpu/nvar/nlevelmax/nboundary then per (level, domain)
    ilevel, ncache, and per cell slot phi + ndim force records."""
    ndim = snap.ndim
    twotondim = 1 << ndim
    with open(path, "wb") as f:
        frt.write_ints(f, ncpu)
        frt.write_ints(f, ndim + 1)
        frt.write_ints(f, snap.nlevelmax)
        frt.write_ints(f, 0)
        for l in range(1, snap.nlevelmax + 1):
            for ibound in range(ncpu):
                lv = snap.levels.get(l) if ibound == icpu - 1 else None
                ncache = lv.noct if lv is not None else 0
                frt.write_ints(f, l)
                frt.write_ints(f, ncache)
                if ncache == 0:
                    continue
                g = (lv.grav if lv.grav is not None
                     else np.zeros((ncache, twotondim, ndim + 1)))
                for ind in range(twotondim):
                    for ivar in range(ndim + 1):
                        frt.write_record(f, g[:, ind, ivar])


def write_part_file(path: str, snap: Snapshot, desc_path: Optional[str],
                    ncpu: int = 1,
                    has_star: Optional[bool] = None) -> None:
    """``backup_part`` record sequence (``pm/output_part.f90``).

    ``has_star`` must be decided from the FULL particle set when
    writing multi-domain files — a per-domain decision would make the
    record layout disagree with the shared descriptor."""
    p = snap.particles
    ndim = snap.ndim
    npart = len(p["m"])
    fields: List[Tuple[str, np.ndarray, str]] = []
    dim_keys = ["x", "y", "z"]
    for d in range(ndim):
        fields.append((f"position_{dim_keys[d]}",
                       np.asarray(p["x"][:, d], dtype=np.float64), "d"))
    for d in range(ndim):
        fields.append((f"velocity_{dim_keys[d]}",
                       np.asarray(p["v"][:, d], dtype=np.float64), "d"))
    fields.append(("mass", np.asarray(p["m"], dtype=np.float64), "d"))
    fields.append(("identity", np.asarray(p["idp"], dtype=np.int32), "i"))
    fields.append(("levelp", np.asarray(p["level"], dtype=np.int32), "i"))
    fields.append(("family", np.asarray(p["family"], dtype=np.int8), "b"))
    fields.append(("tag", np.asarray(p["tag"], dtype=np.int8), "b"))
    if has_star is None:
        has_star = bool(np.any(p["family"] == 2)) or np.any(p.get("tp", 0))
    if has_star:
        fields.append(("birth_time",
                       np.asarray(p["tp"], dtype=np.float64), "d"))
        if "zp" in p:
            fields.append(("metallicity",
                           np.asarray(p["zp"], dtype=np.float64), "d"))

    with open(path, "wb") as f:
        frt.write_ints(f, ncpu)
        frt.write_ints(f, ndim)
        frt.write_ints(f, npart)
        frt.write_record(f, np.zeros(4, dtype=np.int32))   # localseed
        frt.write_ints(f, int(np.sum(p["family"] == 2)))   # nstar_tot
        frt.write_reals(f, snap.mstar_tot)
        frt.write_reals(f, snap.mstar_lost)
        frt.write_ints(f, 0)                               # nsink
        for _, arr, _k in fields:
            frt.write_record(f, arr)
    if desc_path:
        write_descriptor(desc_path, [(n, k) for n, _, k in fields])


def write_descriptor(path: str, fields: Sequence[Tuple[str, str]]) -> None:
    """``*_file_descriptor.txt`` (``io/dump_utils.f90:127-139``)."""
    with open(path, "w") as f:
        f.write("# version:  1\n")
        f.write("# ivar, variable_name, variable_type\n")
        for i, (name, kind) in enumerate(fields, start=1):
            f.write(f"{i:2d}, {name}, {kind}\n")


def write_info_file(path: str, snap: Snapshot, ncpu: int = 1) -> None:
    """``output_info`` (``amr/output_amr.f90:411-491``)."""
    un = snap.units
    om, ol, ok, ob, h0, _aexp_ini, _bli = snap.cosmo
    with open(path, "w") as f:
        f.write(f"ncpu        ={ncpu:11d}\n")
        f.write(f"ndim        ={snap.ndim:11d}\n")
        f.write(f"levelmin    ={snap.levelmin:11d}\n")
        f.write(f"levelmax    ={snap.nlevelmax:11d}\n")
        f.write(f"ngridmax    ={max(snap.ngrid_total, 1):11d}\n")
        f.write(f"nstep_coarse={snap.nstep_coarse:11d}\n")
        f.write("\n")
        for k, v in [("boxlen", snap.boxlen), ("time", snap.t),
                     ("aexp", snap.aexp), ("H0", h0), ("omega_m", om),
                     ("omega_l", ol), ("omega_k", ok), ("omega_b", ob),
                     ("unit_l", un.scale_l), ("unit_d", un.scale_d),
                     ("unit_t", un.scale_t)]:
            f.write(f"{k:<12s}={v:23.15E}\n")
        f.write("\n")
        f.write(f"ordering type={'hilbert':>80s}\n")
        f.write("   DOMAIN   ind_min                 ind_max\n")
        bk_max = float(2 ** min(snap.ndim * snap.nlevelmax, 62))
        bounds = np.linspace(0.0, bk_max, ncpu + 1)
        for idom in range(1, ncpu + 1):
            f.write(f"{idom:8d} {bounds[idom - 1]:23.15E}"
                    f" {bounds[idom]:23.15E}\n")


# family keys, pm/pm_commons.f90:84-87 (index -5..5)
FAMILY_KEYS = ["other_tracer", "debris_tracer", "cloud_tracer",
               "star_tracer", "other_tracer", "gas_tracer",
               "DM", "star", "cloud", "debris", "other"]


def write_header_file(path: str, snap: Snapshot) -> None:
    """``output_header`` (``amr/output_amr.f90:496-575``)."""
    counts = np.zeros(11, dtype=np.int64)
    total = 0
    if snap.particles is not None:
        fam = np.asarray(snap.particles["family"])
        total = len(fam)
        for i, f_code in enumerate(range(-5, 6)):
            counts[i] = int(np.sum(fam == f_code))
    with open(path, "w") as f:
        f.write("#" + "Family".rjust(12) + "Count".rjust(10) + "\n")
        for key, cnt in zip(FAMILY_KEYS, counts):
            f.write(key.rjust(13) + f"{cnt:10d}" + "\n")
        f.write("undefined".rjust(13) + f"{total - int(counts.sum()):10d}\n")
        f.write(" Particle fields\n")
        f.write("pos vel mass iord level family tag \n")


def split_snapshot(snap: Snapshot, ncpu: int) -> List[Snapshot]:
    """Split into ``ncpu`` per-domain snapshots: each level's octs cut
    into ``ncpu`` contiguous equal row ranges of the Morton/Hilbert
    storage order — the row-sharded device layout IS the domain
    decomposition (``parallel/amr_sharded.py``), so a sharded run's
    checkpoint writers each own exactly their shard
    (``amr/output_amr.f90:256-400``'s per-cpu files, token ring
    replaced by independent writers).  Particles split the same way."""
    from dataclasses import replace

    def _ranges(n):
        edges = np.linspace(0, n, ncpu + 1).round().astype(int)
        return list(zip(edges[:-1], edges[1:]))

    out = []
    p = snap.particles
    pranges = _ranges(len(p["m"])) if p is not None else None
    for k in range(ncpu):
        levels = {}
        for l, lv in snap.levels.items():
            a, b = _ranges(lv.noct)[k]
            levels[l] = SnapLevel(
                og=lv.og[a:b], son=lv.son[a:b], hydro=lv.hydro[a:b],
                grav=None if lv.grav is None else lv.grav[a:b])
        pk = None
        if p is not None:
            a, b = pranges[k]
            pk = {key: val[a:b] for key, val in p.items()}
        out.append(replace(snap, levels=levels, particles=pk))
    return out


def dump_all(snap: Snapshot, iout: int, base_dir: str = ".",
             namelist_path: Optional[str] = None,
             write_grav: bool = False, ncpu: int = 1,
             extra_dir: Optional[str] = None,
             keep_last: int = 0) -> str:
    """Write ``output_NNNNN/`` with the full reference file set; returns
    the output directory path (``dump_all``, ``amr/output_amr.f90:5-206``).

    The file set is staged into ``output_NNNNN.tmp/``, hashed into a
    ``manifest.json`` and atomically renamed into place — a crash
    mid-dump never leaves a directory that validates as a checkpoint,
    and a stale ``output_NNNNN/`` from an earlier run is replaced, not
    merged.  ``extra_dir`` names a directory of driver extras (movie
    CSVs, clump catalogs, turbulence phases) folded into the stage
    before finalize so they are covered by the manifest too;
    ``keep_last > 0`` rotates older manifest-valid checkpoints away.

    ``ncpu > 1`` writes one file set per domain (multi-domain
    checkpoint); the restore path re-concatenates any domain count onto
    any device count."""
    from ramses_tpu_torch.resilience import checkpoint as ckpt

    if ncpu > 1 and any(b != 1 for b in snap.base):
        # the domain split orders octs by Hilbert keys over a 2^l cube;
        # non-cubic coarse grids need the reference's multi-root walk
        raise NotImplementedError(
            "multi-domain output with nx,ny,nz != 1 is unsupported "
            f"(base={snap.base}, ncpu={ncpu})")
    final = os.path.join(base_dir, f"output_{iout:05d}")
    outdir = final + ".tmp"
    if os.path.isdir(outdir):
        shutil.rmtree(outdir)     # stale stage from a killed dump
    os.makedirs(outdir)
    suffix = f"{iout:05d}"
    write_info_file(os.path.join(outdir, f"info_{suffix}.txt"), snap,
                    ncpu=ncpu)
    parts = split_snapshot(snap, ncpu) if ncpu > 1 else [snap]
    for icpu, sub in enumerate(parts, start=1):
        write_amr_file(_fname(outdir, "amr", iout, icpu), sub, iout,
                       ncpu=ncpu, icpu=icpu, partial_links=ncpu > 1)
        write_hydro_file(
            _fname(outdir, "hydro", iout, icpu), sub,
            os.path.join(outdir, "hydro_file_descriptor.txt")
            if icpu == 1 else None, ncpu=ncpu, icpu=icpu)
        if write_grav or any(lv.grav is not None
                             for lv in sub.levels.values()):
            write_grav_file(_fname(outdir, "grav", iout, icpu), sub,
                            ncpu=ncpu, icpu=icpu)
        if snap.particles is not None and len(snap.particles["m"]) > 0:
            pfull = snap.particles
            has_star = bool(np.any(pfull["family"] == 2)) \
                or bool(np.any(pfull.get("tp", 0)))
            write_part_file(
                _fname(outdir, "part", iout, icpu), sub,
                os.path.join(outdir, "part_file_descriptor.txt")
                if icpu == 1 else None, ncpu=ncpu, has_star=has_star)
    write_header_file(os.path.join(outdir, f"header_{suffix}.txt"), snap)
    if namelist_path and os.path.exists(namelist_path):
        shutil.copy(namelist_path, os.path.join(outdir, "namelist.txt"))
    if extra_dir and os.path.isdir(extra_dir):
        for name in sorted(os.listdir(extra_dir)):
            shutil.move(os.path.join(extra_dir, name),
                        os.path.join(outdir, name))
        shutil.rmtree(extra_dir, ignore_errors=True)
    out = ckpt.finalize_checkpoint(outdir, final, meta={
        "kind": "output", "iout": int(iout), "nstep": int(snap.nstep),
        "nstep_coarse": int(snap.nstep_coarse), "t": float(snap.t),
        "aexp": float(snap.aexp), "ncpu": int(ncpu),
        "dtold": None if snap.dtold is None
        else [float(x) for x in np.asarray(snap.dtold)]})
    if keep_last > 0:
        ckpt.rotate_checkpoints(base_dir, keep_last, protect=out)
    # the JAX package's fault-injection hook (faultinject.post_dump) is
    # ROADMAP A7: &RUN_PARAMS fault_inject stays refused by name
    return out
