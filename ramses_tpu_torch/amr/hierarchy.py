"""AMR simulation driver: recursive subcycled level stepping (PyTorch).

Port of the pure-hydro, single-device ``AmrSim`` of
``ramses_tpu/amr/hierarchy.py``.  The host keeps the octree and builds the
per-level index maps at each regrid; every level's state lives on the
device as flat rows ``[ncell_pad, nvar]`` (the JAX package's bucket padding
and its hysteresis are kept, so the two compare row for row).  One coarse
step is the recursion of ``amr_step`` (``amr/amr_step.f90:1-586``) with the
hydro-only operation order:

    set_unew(l) → recurse(l+1) ×2 → godunov(l) [+ coarse corrections]
    → set_uold(l) → upload_fine(l)

and ``dt = min_l courant(l)·2^(l-levelmin)`` with exact factor-2
subcycling.  A coarse step issues device work only; the host fetches what
the JAX package fetches: the packed refinement flags once per regrid and
the Courant dt once per coarse step.

Complete levels sweep through K1, blocked partial levels through K3 and
stencil partial levels (``oct_blocking=.false.``) through K2 where the
kernels cover the configuration (:mod:`ramses_tpu_torch.amr.kernels`).
On :class:`ramses_tpu_torch.parallel.amr_sharded.ShardedAmrSim` a complete
level sweeps and flags shard by shard instead (``FusedSpec.slab``,
:mod:`ramses_tpu_torch.parallel.dense_slab`).

``&RUN_PARAMS tracer`` seeds Monte-Carlo gas tracers in proportion to the
gas mass on the leaf cells.  Each coarse step then captures every level's
face mass fluxes (the kernels' ``want_flux``, fine boundary fluxes folded
into the coarse face slots by ``scatter_corr_flux``) and keeps the
pre-step density; after the step the host fetches both once and makes the
flux-probability jumps (:func:`ramses_tpu_torch.pm.amr_physics.
mc_tracer_amr`).  While tracers exist, ``evolve`` steps one coarse step at
a time, as the JAX package does.

``&RUN_PARAMS poisson`` adds the per-level Poisson solve before each coarse
step (:meth:`AmrSim.solve_gravity`: the exact FFT on complete levels, the
isolated multipole-Dirichlet solve on an open box, PCG with coarse ghosts
on partial levels) and a half kick of each level before and after its
sweep (:func:`ramses_tpu_torch.poisson.amr_solve.kick_flat`); the sweep
itself goes through the same kernels.  The solve's one host fetch is the
mean density of a periodic box (:meth:`AmrSim.totals`); ``evolve`` then
steps one coarse step at a time, as the JAX package does.

``&RUN_PARAMS pic`` with particles (``AmrSim(params, particles=...)``, or
the grafic/Gadget ICs of a ``cosmo`` namelist through the entry points)
adds the particle-mesh layer (:mod:`ramses_tpu_torch.pm.amr_pm`): before
each coarse step every level's deposit and gather maps are built in
float64 on the device against the host tree's keys, each level's Poisson
rhs gets the particles' deposit (summed in a fixed order), the particles
are kicked with the force gathered at their finest covering level and
drifted after the sweep; their Courant dt and the lagged free-fall time
cap the coarse dt, and ``m_refine`` flags cells holding more than that
many mean particle masses.  ``&RUN_PARAMS cosmo`` runs the supercomoving clock: the time is
the conformal tau from ``aexp_ini``, the Poisson coefficient is
``1.5·Ωm·aexp`` and ``0.1/|hexp|`` caps the dt.  The base-level baryons of
the ICs are sampled onto each level (``init_dense_u``).

``AmrSim.dump`` writes a reference-format ``output_NNNNN/`` (every level's
rows fetched once, the file writing optionally on an
:class:`ramses_tpu_torch.io.async_writer.AsyncDumper`'s thread) and
``from_snapshot`` restores one onto a tree rebuilt from the file's oct
coordinates (:func:`restore_amr_scaffold`), any domain count onto one
device.

Regrids always take the host prolongation-map migrate; the JAX package's
``device_regrid`` (on by default there) is pinned bitwise equal to it by
its own tests and is not ported.  Cooling, star formation, sinks, the
lightcone, the clump finder, RT, movies, load balance, offload, the step
guard, the watchdog, telemetry, patch hooks, non-cubic roots and elastic
sharded checkpoints are not ported yet: a namelist that turns one on
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ramses_tpu_torch.amr import flag as flagmod
from ramses_tpu_torch.amr import kernels as K
from ramses_tpu_torch.amr import maps as mapmod
from ramses_tpu_torch.amr.tree import Octree, cell_offsets
from ramses_tpu_torch.config import Params
from ramses_tpu_torch.device import resolve_device
from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.hydro.core import HydroStatic
from ramses_tpu_torch.init import regions
from ramses_tpu_torch.pm import amr_physics
from ramses_tpu_torch.pm import amr_pm
from ramses_tpu_torch.pm import particles as pmod
from ramses_tpu_torch.pm.cosmology import Cosmology
from ramses_tpu_torch.pm.particles import TRACER_ID0
from ramses_tpu_torch.poisson import amr_solve as gs


class FusedSpec(NamedTuple):
    """Static description of one coarse step's level structure (re-derived
    per regrid)."""
    cfg: HydroStatic
    bspec: bmod.BoundarySpec
    lmin: int
    boxlen: float
    levels: tuple          # populated levels, ascending
    complete: tuple        # per-level bool
    itype: int
    # per-level bool: partial level runs the blocked tile sweep
    blocked: tuple = ()
    block_shift: int = 2
    # capture per-cell face mass fluxes for the MC gas tracers
    # (godunov_fine.f90:685-715)
    want_flux: bool = False
    # per-level SlabSpec of a complete level's slab-sharded sweep
    # (parallel/dense_slab.py), None for the single-device sweep; empty on
    # the single-device AmrSim
    slab: tuple = ()
    # self-gravity: a half kick of each level before and after its sweep
    gravity: bool = False


class _Cfg1:
    """Minimal cfg shim for interp_cells on a single-column array."""

    def __init__(self, ndim: int):
        self.ndim = ndim


def _sample_dense_periodic(dense: np.ndarray, x01: np.ndarray) -> np.ndarray:
    """Periodic multilinear interpolation of a cell-centred dense field
    ``[nvar, n, n, …]`` at unit-box positions ``x01 [npts, ndim]``: seeds
    refined levels from base-resolution IC grids (the grafic baryons)."""
    nvar = dense.shape[0]
    nd = x01.shape[1]
    n = dense.shape[1]
    g = x01 * n - 0.5
    i0 = np.floor(g).astype(np.int64)
    w1 = g - i0
    out = np.zeros((nvar, len(x01)))
    for corner in range(1 << nd):
        idx = []
        w = np.ones(len(x01))
        for d in range(nd):
            bit = (corner >> d) & 1
            idx.append(np.mod(i0[:, d] + bit, n))
            w = w * (w1[:, d] if bit else 1.0 - w1[:, d])
        out += dense[(slice(None),) + tuple(idx)] * w
    return out


def _advance(u, dev, dt, spec: FusedSpec, fg=None):
    """One coarse step (the recursive subcycled ``amr_step``) as device work
    only: ``u`` maps level → rows, ``dt`` is a 0-d device tensor in the
    state dtype, ``fg`` (with ``spec.gravity``) level → the force rows
    ``[ncell_pad, ndim]``.  Returns ``(u, phi)``: the new state dict and,
    with ``spec.want_flux``, each level's face mass fluxes ``[ncell_pad,
    ndim, 2]`` summed over its substeps (else None).  The input tensors are
    not modified."""
    cfg = spec.cfg
    u = dict(u)
    unew = dict(u)
    levels = spec.levels
    wf = spec.want_flux
    phi = ({l: u[l].new_zeros((u[l].shape[0], cfg.ndim, 2))
            for l in levels} if wf else None)

    def dx(l):
        return spec.boxlen / (1 << l)

    def advance(i, dtl):
        l = levels[i]
        d = dev[l]
        if spec.gravity:
            u[l] = gs.kick_flat(u[l], fg[l], 0.5 * dtl, cfg.ndim, cfg.smallr)
        unew[l] = u[l]
        if i + 1 < len(levels):
            advance(i + 1, 0.5 * dtl)
            advance(i + 1, 0.5 * dtl)
        corr = None
        if spec.complete[i]:
            sl = spec.slab[i] if spec.slab else None
            if sl is not None:
                # the explicit slab-sharded formulation: shard-local
                # bitperm + ring halos (parallel/dense_slab.py, dma_halo.py)
                from ramses_tpu_torch.parallel import dense_slab
                out = dense_slab.dense_sweep_slab(
                    u[l], d.get("ok_flat"), dtl, dx(l), sl, cfg,
                    ret_flux=wf)
            else:
                out = K.dense_sweep(u[l], None, None, d["ok_dense"], dtl,
                                    dx(l), (1 << l,) * cfg.ndim, spec.bspec,
                                    cfg, ret_flux=wf)
            du = out[0] if wf else out
        elif spec.blocked and spec.blocked[i]:
            interp = K.interp_cells(u[l - 1], d["b_interp_cell"],
                                    d["b_interp_nb"], d["b_interp_sgn"],
                                    cfg, itype=spec.itype)
            out = K.tile_sweep(
                u[l], interp, d["tile_src"], d["tile_vsgn"], d["tile_ok"],
                d["cell_tile"], d["cell_slot"], d["oct_tile"],
                d["oct_slot"], dtl, dx(l), cfg, spec.block_shift,
                ret_flux=wf)
            du, corr = out[0], out[1]
        else:
            interp = K.interp_cells(u[l - 1], d["interp_cell"],
                                    d["interp_nb"], d["interp_sgn"], cfg,
                                    itype=spec.itype)
            out = K.level_sweep(u[l], interp, d["stencil_src"], d["vsgn"],
                                d["ok_ref"], dtl, dx(l), cfg, ret_flux=wf)
            du, corr = out[0], out[1]
        if wf:
            phi[l] = phi[l] + out[-1]
        unew[l] = unew[l] + du
        if corr is not None and l > spec.lmin:
            unew[l - 1] = K.scatter_corrections(unew[l - 1], corr,
                                                d["corr_plan"], cfg)
            if wf:
                phi[l - 1] = K.scatter_corr_flux(phi[l - 1], corr,
                                                 d["flux_plan"], cfg)
        u[l] = unew[l]
        if spec.gravity:
            u[l] = gs.kick_flat(u[l], fg[l], 0.5 * dtl, cfg.ndim, cfg.smallr)
        if i + 1 < len(levels):
            u[l] = K.restrict_upload(u[l], u[levels[i + 1]], d["ref_cell"],
                                     d["son_oct"], cfg)

    advance(0, dt)
    return u, phi


def _courant(u, dev, spec: FusedSpec, fg=None):
    """All levels' CFL dts as coarse-step equivalents ``[nlevel]``.
    ``fg`` (level → force rows) adds the gravity-strength correction on
    the levels it holds (one solve stale, as the reference's
    ``courant_fine`` reads the last force)."""
    return torch.stack([
        K.level_courant(u[l], dev[l]["valid_cell"], spec.boxlen / (1 << l),
                        spec.cfg, fg.get(l) if fg else None)
        * (2.0 ** (l - spec.lmin))
        for l in spec.levels])


def _coarse_step(u, dev, dt, spec: FusedSpec, fg=None):
    """One coarse step and the NEXT step's Courant dt (a 0-d device
    tensor), the reference's ``dtnew`` bookkeeping; with
    ``spec.want_flux`` also the step's face mass fluxes per level."""
    u, phi = _advance(u, dev, dt, spec, fg)
    dtn = torch.min(_courant(u, dev, spec, fg if spec.gravity else None))
    return (u, dtn, phi) if spec.want_flux else (u, dtn)


def _multi_step(u, dev, t, tend, dt0, spec: FusedSpec, nsteps: int):
    """``nsteps`` coarse steps with the time bookkeeping on the device
    (``t``, ``tend``, ``dt0``: 0-d f64 tensors); steps past ``tend`` are
    no-ops.  Only valid while the tree is frozen.  Returns ``(u, t, dt_next,
    n_done)`` as device values."""
    dtc = dt0
    ndone = torch.zeros((), dtype=torch.int64, device=t.device)
    sdtype = u[spec.lmin].dtype
    for _ in range(nsteps):
        dt = torch.minimum(dtc, torch.clamp(tend - t, min=0.0))
        active = t < tend
        un, dtn = _coarse_step(u, dev,
                               torch.where(active, dt, 0.0).to(sdtype), spec)
        u = {l: torch.where(active, un[l], u[l]) for l in u}
        t = torch.where(active, t + dt, t)
        dtc = torch.where(active, dtn.to(dtc.dtype), dtc)
        ndone = ndone + active.to(torch.int64)
    return u, t, dtc, ndone


def unported_amr_features(params: Params) -> list:
    """Names of the namelist's features the port's AMR hierarchy does not
    run yet: :func:`ramses_tpu_torch.driver.unported_features` and the
    hierarchy's own."""
    from ramses_tpu_torch.driver import unported_features
    a = params.amr
    root = [a.nx, a.ny, a.nz][:params.ndim]
    checks = [
        ("load balance (&AMR_PARAMS load_balance)", a.load_balance),
        ("offload (&AMR_PARAMS offload)",
         str(a.offload).strip().lower() != "off"),
        ("non-cubic coarse grid (&AMR_PARAMS nx, ny, nz)",
         any(int(n) != 1 for n in root)),
    ]
    return unported_features(params) + [n for n, on in checks if on]


def restore_amr_scaffold(cls, params: Params, outdir: str, dtype, to_cons,
                         place_level, device=None, **kw):
    """The restart scaffold (the ``nrestart`` path) of the hydro and MHD
    hierarchies, as the JAX package's: rebuild the octree from the file's
    oct coordinates, construct the sim on it (``kw`` to the constructor),
    place each level's restored rows (re-mapped through the rebuilt tree's
    key order), then restrict.  ``to_cons(q_rows)`` converts the file's
    output columns to the solver's stored rows; ``place_level(sim, l, rows,
    og, order)`` writes them into the sim state.  The MC gas tracers come
    back from the part file's family-0 rows; restarts never re-seed them.
    Returns the sim."""
    from ramses_tpu_torch.io.restart import (restore_particles,
                                             restore_tree_state)
    from ramses_tpu_torch.pm.particles import FAM_GAS_TRACER, lane_headroom
    tree_og, rows_lv, meta, parts = restore_tree_state(
        outdir, None, params.amr.levelmin, to_cons=to_cons)
    tree = Octree(params.ndim, params.amr.levelmin, params.amr.levelmax)
    for l, og in tree_og.items():
        tree.set_level(l, og)
    tracer_x = None
    tracer_id = None
    ps = None
    if parts:
        # gas tracers ride the part files as massless family-0 rows:
        # split them back out (they are host positions, not lanes)
        fam = parts.get("family")
        if fam is not None and (fam == FAM_GAS_TRACER).any():
            sel = fam == FAM_GAS_TRACER
            dims = "xyz"[:params.ndim]
            tracer_x = np.stack(
                [parts[f"position_{d}"][sel] for d in dims], axis=1)
            tracer_id = parts["identity"][sel].astype(np.int64)
            npart = len(fam)
            parts = {k: (v[~sel] if isinstance(v, np.ndarray)
                         and len(v) == npart else v)
                     for k, v in parts.items()}
        if len(parts.get("mass", ())):
            if not cls._pm_physics:
                raise NotImplementedError(
                    "not ported to ramses_tpu_torch yet: particles in a "
                    f"snapshot restored on {cls.__name__}")
            ps = restore_particles(parts, params.ndim, dtype=dtype,
                                   device=resolve_device(device),
                                   nmax=lane_headroom(params, False))
            kw = dict(kw, particles=ps)
    # restarts never re-seed tracers: the restored population is the
    # truth, INCLUDING the empty one (e.g. every tracer escaped an open
    # box) — resurrecting a fresh population would fabricate trajectories
    sim = cls(params, dtype=dtype, device=device, init_tree=tree,
              seed_tracers=False, **kw)
    if tracer_x is not None:
        sim.tracer_x = tracer_x
        sim.tracer_id = tracer_id
        sim._spec = None               # enable the MC flux capture
    elif bool(params.run.tracer):
        sim.tracer_x = np.zeros((0, params.ndim))
        sim.tracer_id = np.zeros(0, dtype=np.int64)
        sim._spec = None
    for l, rows in rows_lv.items():
        og = tree_og[l]
        pos = tree.lookup(l, og)
        place_level(sim, l, rows, og, np.argsort(pos))
    sim._restrict_all()
    sim._dt_cache = None
    sim.t = float(meta["t"])
    sim.nstep = int(meta["nstep"])
    # the stored dtnew makes the restart take the SAME next step a
    # continuous run would (its cached CFL dt included the gravity term
    # the fresh sim's empty force field cannot reproduce)
    lm = params.amr.levelmin
    dtold = np.atleast_1d(np.asarray(meta.get("dtold", 0.0)))
    if len(dtold) >= lm:
        sim.dt_old = float(dtold[lm - 1])
    dtnew = np.atleast_1d(np.asarray(meta.get("dtnew", 0.0)))
    if len(dtnew) >= lm and dtnew[lm - 1] > 0.0:
        sim._dt_cache = torch.tensor(float(dtnew[lm - 1]),
                                     dtype=torch.float64, device=sim.device)
    if sim.gravity:
        # prime the force field (and, with particles, the deposited-density
        # maximum) so that the first post-restart coarse_dt carries a
        # gravity term and a free-fall cap, and the PCG a warm start, as
        # the JAX package primes them: from the restored state, at the
        # restored epoch's supercomoving coefficient
        if sim.pic:
            sim._build_pm()
        sim.solve_gravity()
    return sim


def _place_u_rows(sim, l: int, rows: np.ndarray, og: np.ndarray,
                  order: np.ndarray):
    """Default row placement: the cell-state rows only (hydro); a level's
    real rows are its leading rows, in tree order."""
    nvar = sim.cfg.nvar
    ttd = 2 ** sim.cfg.ndim
    out = sim.u[l].clone()
    out[:len(og) * ttd] = torch.as_tensor(
        rows.reshape(len(og), ttd, nvar)[order].reshape(-1, nvar),
        dtype=sim.dtype, device=sim.device)
    sim.u[l] = out


def _mig_consts(ndim: int):
    offs = cell_offsets(ndim)
    return (offs * 2 - 1).astype(np.float64), np.arange(1 << ndim)


class AmrSim:
    """Adaptive simulation: host octree + per-level device states.

    Runs on CUDA unless ``device="cpu"`` is given; without a GPU a run that
    did not ask for the CPU raises."""

    # subclasses carrying per-cell state beside ``u`` (the MHD face field)
    # set this: ``regrid`` then logs each migrated level's copy rows, new
    # octs and their father cells in ``_mig_log`` for them to replay
    _needs_mig_log = False
    # the particle-mesh layer runs on this hierarchy (a subclass that
    # refuses particles clears it, so that a restore refuses them too)
    _pm_physics = True

    @classmethod
    def _unported(cls, params: Params) -> list:
        """The namelist's features this hierarchy does not run (subclass
        hook): hydro here, so a namelist with a region field too."""
        from ramses_tpu_torch.driver import is_mhd
        mhd = ["magnetic fields (&INIT_PARAMS A/B/C_region; MHD runs "
               "through ramses_tpu_torch.mhd.amr.MhdAmrSim)"]
        return unported_amr_features(params) + (mhd if is_mhd(params)
                                                else [])

    def __init__(self, params: Params, dtype=torch.float32, device=None,
                 init_tree: Optional[Octree] = None,
                 noct_pad: Optional[Dict[int, int]] = None,
                 seed_tracers: bool = True, particles=None,
                 init_dense_u=None):
        missing = self._unported(params)
        if missing:
            raise NotImplementedError(
                "not ported to ramses_tpu_torch's AMR hierarchy yet: "
                + ", ".join(missing))
        self.device = resolve_device(device)
        self.params = params
        self.cfg = HydroStatic.from_params(params)
        self.dtype = dtype
        self.boxlen = float(params.amr.boxlen)
        self.bspec = bmod.BoundarySpec.from_params(params)
        self.bc_kinds = list(self.bspec.kinds)
        self.lmin = params.amr.levelmin
        self.lmax = params.amr.levelmax
        self.t = 0.0
        self.nstep = 0
        self.dt_old = 0.0
        # regrid cadence: nremap coarse steps (>= 1), amr/amr_step.f90:100-123
        self.regrid_interval = max(1, int(params.run.nremap))
        # next-step CFL dt (0-d device tensor) from the last fused step;
        # None whenever u changed outside a step (regrid, ICs)
        self._dt_cache = None
        # last padded oct count per level (seeded by from_state)
        self._pad_hist: Dict[int, int] = dict(noct_pad or {})
        self._spec = None
        self.blocks: Dict[int, mapmod.BlockMaps] = {}
        # cells × level substeps advanced by evolve (bench.py's count)
        self.cell_updates = 0
        # MC gas tracers: host positions [ntr, ndim] and stable ids, the
        # jump generator, and the last step's capture and pre-step density
        self.tracer_x = None
        self.tracer_id = None
        self._tracer_rng = np.random.default_rng(20481)
        self._tracer_phi = None
        self._tracer_rho0 = None
        # self-gravity (per-level Poisson): periodic boxes solve the
        # zero-mean problem; any non-periodic face switches complete levels
        # to the isolated multipole-Dirichlet solve (poisson/isolated.py)
        self.gravity = bool(params.run.poisson)
        self.grav_periodic = all(k == bmod.PERIODIC
                                 for pair in self.bc_kinds for k in pair)
        if self.gravity and any(k == bmod.REFLECTING
                                for pair in self.bc_kinds for k in pair):
            # mirror walls need image masses, which the isolated multipole
            # solve does not provide
            raise NotImplementedError(
                "self-gravity with reflecting walls is unsupported "
                "(isolated solve covers outflow/inflow boxes)")
        # per level: the potential and the force rows, and the PCG's live
        # iteration count (0-d device tensors) of partial levels
        self.phi: Dict[int, torch.Tensor] = {}
        self.fg: Dict[int, torch.Tensor] = {}
        self.poisson_iters: Dict[int, torch.Tensor] = {}
        # cosmology: supercomoving conformal-time integration
        # (``amr/update_time.f90``; aexp/hexp from the Friedmann tables)
        self.cosmo = None
        if bool(params.run.cosmo):
            if self.gravity and not self.grav_periodic:
                raise NotImplementedError(
                    "cosmology requires a periodic box")
            self.cosmo = Cosmology.from_params(params)
            self.t = float(self.cosmo.tau_ini)
        # dense base-grid gas ICs (grafic baryons) sampled per level
        self._init_dense = (np.asarray(init_dense_u)
                            if init_dense_u is not None else None)
        # the particle-mesh layer: the particles (a ParticleSet in the
        # caller's dtype), each level's device maps of the last build, the
        # gravity solve's total density per level (the m_refine input) and
        # its maximum (the next step's free-fall cap)
        self.p = particles
        self.pic = bool(params.run.pic) and particles is not None
        if self.pic and any(k == bmod.REFLECTING
                            for pair in self.bc_kinds for k in pair):
            raise NotImplementedError(
                "AMR particles: reflecting boundaries unsupported")
        self._pm_dev: Dict[int, dict] = {}
        self._rho_dev: Dict[int, torch.Tensor] = {}
        self._rho_max: Optional[float] = None
        if init_tree is not None:
            self.tree = init_tree
            self._rebuild_maps()
            self._alloc_from_ics()
        else:
            self._init_refine()
        if bool(params.run.tracer) and seed_tracers:
            self._seed_tracers()

    @classmethod
    def from_state(cls, params: Params, tree_og: Dict[int, np.ndarray],
                   rows: Dict[int, np.ndarray], t: float = 0.0,
                   nstep: int = 0, noct_pad: Optional[Dict[int, int]] = None,
                   dtype=None, device=None, tracer_x=None, tracer_id=None,
                   tracer_rng=None, phi=None, fg=None, poisson_iters=None,
                   dt_old: float = 0.0, dt_next: Optional[float] = None,
                   particles=None, **kwargs) -> "AmrSim":
        """Start from a given hierarchy: per-level oct coordinates
        ``tree_og`` and state rows ``rows`` (numpy, e.g. from
        :func:`ramses_tpu_torch.convert.amr_state_from`), the time and the
        step count.  ``noct_pad`` (per level) reproduces another run's
        padding so that arrays compare row for row; the dtype defaults to
        the rows'.  With ``&RUN_PARAMS tracer`` the tracers are the given
        ``tracer_x``/``tracer_id`` and the jump generator continues from
        the bit-generator state ``tracer_rng``, or, without them, are
        seeded on the given state.  With gravity, ``phi``, ``fg`` and
        ``poisson_iters`` (per level) carry the last solve: its force for
        the Courant dt and its potential as the next PCG's warm start.
        ``dt_old`` is the last coarse step and ``dt_next`` (or None) the
        cached Courant dt of the next one, as a snapshot records them.
        ``particles``: a :class:`ramses_tpu_torch.pm.particles.ParticleSet`
        (e.g. from :func:`ramses_tpu_torch.convert.particles_from`).
        ``kwargs`` go to the constructor (a subclass's own arguments, such
        as a shard mesh)."""
        tree = Octree(params.ndim, params.amr.levelmin, params.amr.levelmax)
        for l, og in tree_og.items():
            tree.set_level(l, og)
        if dtype is None:
            dtype = (torch.float64 if next(iter(rows.values())).dtype
                     == np.float64 else torch.float32)
        if particles is not None:
            kwargs = dict(kwargs, particles=particles)
        sim = cls(params, dtype=dtype, device=device, init_tree=tree,
                  noct_pad=noct_pad, seed_tracers=False, **kwargs)
        for l in sim.levels():
            sim.u[l] = sim._rows_from(sim.u[l], rows[l], l)
        sim.t, sim.nstep, sim.dt_old = float(t), int(nstep), float(dt_old)
        sim._dt_cache = (None if dt_next is None else torch.tensor(
            float(dt_next), dtype=torch.float64, device=sim.device))
        for name, arrs in (("phi", phi), ("fg", fg)):
            getattr(sim, name).update(
                {l: torch.tensor(np.asarray(a), dtype=sim.dtype,
                                 device=sim.device)
                 for l, a in (arrs or {}).items()})
        sim.poisson_iters.update(
            {l: torch.tensor(int(n), dtype=torch.int32, device=sim.device)
             for l, n in (poisson_iters or {}).items()})
        if bool(params.run.tracer):
            if tracer_x is None:
                sim._seed_tracers()
            else:
                sim.tracer_x = np.array(tracer_x, dtype=np.float64)
                sim.tracer_id = np.array(tracer_id, dtype=np.int64)
                sim._spec = None
            if tracer_rng is not None:
                sim._tracer_rng.bit_generator.state = tracer_rng
        return sim

    def _seed_tracers(self):
        """Seed the gas tracers on the leaf cells (``pm/tracer_utils.f90``
        initial seeding): Poisson-sampled per cell with mean
        ``tracer_per_cell · N_leaf · (the cell's share of the gas mass)``,
        so a refined region is not over-weighted, and jittered inside the
        cell; ids from ``TRACER_ID0``.  Draws from its own
        ``default_rng(20480)`` in the JAX package's order."""
        rng = np.random.default_rng(20480)
        tpc = float(self.params.run.tracer_per_cell)
        nd = self.cfg.ndim
        cen, mass, dxs = [], [], []
        for l in self.levels():
            leaf = ~self.tree.refined_mask(l)
            n = self.tree.noct(l) * 2 ** nd
            rho = self.u[l][:n, 0].cpu().numpy()[leaf]
            cen.append(self.tree.cell_centers(l, self.boxlen)[leaf])
            mass.append(rho * self.dx(l) ** nd)
            dxs.append(np.full(len(cen[-1]), self.dx(l)))
        cen = np.concatenate(cen)
        mass = np.concatenate(mass)
        dxs = np.concatenate(dxs)
        lam = tpc * len(cen) * mass / max(mass.sum(), 1e-300)
        nper = rng.poisson(lam)
        rep = np.repeat(cen, nper, axis=0)
        jit = (rng.uniform(-0.5, 0.5, rep.shape)
               * np.repeat(dxs, nper)[:, None])
        self.tracer_x = rep + jit if len(rep) else None
        if self.tracer_x is not None:
            self.tracer_id = TRACER_ID0 + np.arange(len(self.tracer_x),
                                                    dtype=np.int64)
            self._spec = None            # turns the flux capture on

    def _rows_from(self, cur: torch.Tensor, r, l: int) -> torch.Tensor:
        """``cur`` (a level's padded rows) with its leading rows replaced by
        the host rows ``r``, which must cover the level's cells."""
        r = np.asarray(r)
        ncell = self.tree.noct(l) * 2 ** self.tree_ndim
        if r.shape[0] < ncell:
            raise ValueError(f"level {l}: {r.shape[0]} rows for {ncell} "
                             "cells")
        full = np.array(cur.cpu().numpy())
        n = min(r.shape[0], full.shape[0])
        full[:n] = r[:n]
        return torch.as_tensor(full, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def dx(self, lvl: int) -> float:
        return self.boxlen / (1 << lvl)

    @property
    def tree_ndim(self) -> int:
        return self.params.ndim

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _noct_pad(self, lvl: int, noct: int) -> int:
        """Padded oct count with hysteresis: keep the previous bucket while
        the level still fits in it and fills more than 1/4."""
        pad = mapmod.bucket(noct)
        prev = self._pad_hist.get(lvl)
        if prev is not None and pad <= prev and noct * 4 > prev:
            pad = prev
        self._pad_hist[lvl] = pad
        return pad

    def _keys_same(self, other: Optional[Octree], l: int) -> bool:
        """True when level ``l`` has identical oct sets in self.tree and
        ``other`` (both absent counts as same)."""
        if other is None:
            return False
        ha, hb = self.tree.has(l), other.has(l)
        if ha != hb:
            return False
        if not ha:
            return True
        a, b = self.tree.levels[l].keys, other.levels[l].keys
        return len(a) == len(b) and np.array_equal(a, b)

    def tree_order_cells(self, arr, l: int) -> np.ndarray:
        """Host f64 copy of a level's real rows in tree order."""
        n = self.tree.noct(l) * (1 << self.tree.ndim)
        return arr[:n].to(torch.float64).cpu().numpy()

    def _restriction_dev(self, m: mapmod.LevelMaps) -> dict:
        # the valid prefix only: pad rows write nothing
        return dict(ref_cell=self._dev(m.ref_cell[:m.nref], torch.int64),
                    son_oct=self._dev(m.son_oct[:m.nref], torch.int64))

    def _rebuild_maps(self, old_tree: Optional[Octree] = None,
                      old_maps: Optional[dict] = None,
                      old_dev: Optional[dict] = None):
        """(Re)build per-level index maps, reusing cached maps for levels
        whose (l-1, l, l+1) oct sets are unchanged."""
        prev_maps = old_maps or {}
        prev_dev = old_dev or {}
        prev_blocks = self.blocks
        ttd = 1 << self.tree.ndim
        shift = int(self.params.amr.oct_block_shift)
        self._spec = None
        self.maps: Dict[int, mapmod.LevelMaps] = {}
        self.dev: Dict[int, dict] = {}
        self.blocks = {}
        self.block_stats = {"blocks_total": 0, "blocks_rebuilt": 0}
        for l in range(self.lmin, self.lmax + 1):
            if not self.tree.has(l):
                break
            if (l in prev_maps and self._keys_same(old_tree, l - 1)
                    and self._keys_same(old_tree, l)
                    and self._keys_same(old_tree, l + 1)):
                self.maps[l] = prev_maps[l]
                self.dev[l] = prev_dev[l]
                if l in prev_blocks:
                    self.blocks[l] = prev_blocks[l]
                    self.block_stats["blocks_total"] += prev_blocks[l].ntile
                continue
            if (l in prev_maps and prev_maps[l].complete
                    and self._keys_same(old_tree, l)):
                # complete level, same oct set: only the restriction and
                # refined-mask maps (which read l+1) change
                m = mapmod.refresh_restriction(prev_maps[l], self.tree)
                self.maps[l] = m
                self.dev[l] = dict(
                    prev_dev[l], ok_dense=(self._dev(m.ok_dense)
                                           if m.ok_dense is not None
                                           else None),
                    **self._restriction_dev(m))
                continue
            m = mapmod.build_level_maps(
                self.tree, l, self.bc_kinds,
                noct_pad=self._noct_pad(l, self.tree.noct(l)))
            self.maps[l] = m
            valid_cell = self._dev(np.repeat(m.valid_oct, ttd))
            if m.complete:
                self.dev[l] = dict(
                    ok_dense=(self._dev(m.ok_dense)
                              if m.ok_dense is not None else None),
                    valid_cell=valid_cell, **self._restriction_dev(m))
                continue
            self.dev[l] = dict(
                stencil_src=self._dev(m.stencil_src),
                vsgn=self._dev(m.vsgn) if m.vsgn is not None else None,
                ok_ref=self._dev(m.ok_ref),
                interp_cell=self._dev(m.interp_cell),
                interp_nb=self._dev(m.interp_nb),
                interp_sgn=self._dev(m.interp_sgn, self.dtype),
                corr_plan=K.corr_plan(m.corr_idx, self.device),
                valid_cell=valid_cell, **self._restriction_dev(m))
            self.dev[l]["flux_plan"] = K.flux_plan(m.corr_idx, self.device)
            if self.params.amr.oct_blocking:
                b = mapmod.build_block_maps(
                    self.tree, l, self.bc_kinds, shift=shift,
                    noct_pad=m.noct_pad, prev=prev_blocks.get(l))
                self.blocks[l] = b
                self.block_stats["blocks_total"] += b.ntile
                self.block_stats["blocks_rebuilt"] += b.blocks_rebuilt
                self.dev[l].update(
                    tile_src=self._dev(b.tile_src),
                    tile_vsgn=(self._dev(b.tile_vsgn)
                               if b.tile_vsgn is not None else None),
                    tile_ok=self._dev(b.tile_ok),
                    cell_tile=self._dev(b.cell_tile),
                    cell_slot=self._dev(b.cell_slot),
                    oct_tile=self._dev(b.oct_tile),
                    oct_slot=self._dev(b.oct_slot),
                    b_interp_cell=self._dev(b.interp_cell),
                    b_interp_nb=self._dev(b.interp_nb),
                    b_interp_sgn=self._dev(b.interp_sgn, self.dtype))
            if self.gravity:
                self.dev[l].update(self._gravity_dev(
                    mapmod.build_gravity_maps(self.tree, l, self.bc_kinds,
                                              noct_pad=m.noct_pad)))

    def _gravity_dev(self, g: mapmod.GravityMaps) -> dict:
        """A partial level's gravity maps on the device; each depth of the
        multigrid ladder as ``(nb, par, kids)``, ``kids`` the child table
        of its restriction (:func:`mapmod.mg_children`)."""
        mg = tuple((self._dev(nb_j, torch.int64),
                    self._dev(par_j, torch.int64),
                    self._dev(mapmod.mg_children(par_j, nb_j.shape[0])))
                   for nb_j, par_j, _n in g.mg)
        return dict(g_nb=self._dev(g.nb, torch.int64),
                    g_cell=self._dev(g.g_cell, torch.int64),
                    g_gnb=self._dev(g.g_nb, torch.int64),
                    g_sgn=self._dev(g.g_sgn, self.dtype),
                    g_octnb=self._dev(g.oct_nb, torch.int64),
                    g_valid=self._dev(g.valid_cell),
                    g_mg=mg)

    def _ic_state(self, lvl: int) -> torch.Tensor:
        """Analytic conservative ICs on this level's (padded) rows, or
        periodic multilinear samples of a dense IC grid (grafic
        baryons)."""
        m = self.maps[lvl]
        centers = self.tree.cell_centers(lvl, self.boxlen)
        if self._init_dense is not None:
            u = _sample_dense_periodic(self._init_dense,
                                       centers / self.boxlen)
        else:
            x = [centers[:, d] for d in range(self.cfg.ndim)]
            q = regions.region_condinit(x, self.dx(lvl), self.params,
                                        self.cfg)
            u = regions.prim_to_cons(q, self.cfg)      # [nvar, ncell]
        out = np.zeros((m.ncell_pad, self.cfg.nvar))
        out[:, 0] = self.cfg.smallr
        out[:, self.cfg.ndim + 1] = self.cfg.smalle * self.cfg.smallr
        out[:u.shape[1]] = u.T
        return self._dev(out, self.dtype)

    def _alloc_from_ics(self):
        self.u: Dict[int, torch.Tensor] = {l: self._ic_state(l)
                                           for l in self.levels()}
        self._restrict_all()
        self._dt_cache = None

    def _init_refine(self):
        """Iterative initial mesh build (``amr/init_refine.f90:5-154``):
        apply analytic ICs, flag, rebuild, repeat until stable."""
        self.tree = Octree.base(self.params.ndim, self.lmin, self.lmax)
        self._rebuild_maps()
        self._alloc_from_ics()
        for _ in range(self.lmax - self.lmin + 2):
            newtree = self._flag_and_tree()
            if all(newtree.has(l) == self.tree.has(l)
                   and (not newtree.has(l) or np.array_equal(
                       newtree.levels[l].keys, self.tree.levels[l].keys))
                   for l in range(self.lmin, self.lmax + 1)):
                break
            self.tree = newtree
            self._rebuild_maps()
            self._alloc_from_ics()

    def levels(self):
        return [l for l in range(self.lmin, self.lmax + 1)
                if self.tree.has(l)]

    # ------------------------------------------------------------------
    # refinement
    # ------------------------------------------------------------------
    def _criteria_flags(self, spec: FusedSpec):
        """Per-level gradient criteria ``[noct_pad, 2^d]`` bool on the
        device (``hydro_refine`` of ``flag_fine``)."""
        r = self.params.refine
        eg = (float(r.err_grad_d), float(r.err_grad_u), float(r.err_grad_p))
        fls = (float(r.floor_d), float(r.floor_u), float(r.floor_p))
        cfg = self.cfg
        out = []
        for i, l in enumerate(spec.levels):
            d = self.dev[l]
            if spec.complete[i]:
                sl = spec.slab[i] if spec.slab else None
                if sl is not None:
                    from ramses_tpu_torch.parallel import dense_slab
                    out.append(dense_slab.dense_flags_slab(
                        self.u[l], sl,
                        lambda up: K._grad_flags(up, eg, fls, 0, cfg),
                        2 ** cfg.ndim))
                    continue
                out.append(K.dense_refine_flags(
                    self.u[l], None, None, eg, fls, self.tree.cell_dims(l),
                    self.bspec, cfg))
                continue
            pre = "b_" if spec.blocked and spec.blocked[i] else ""
            interp = K.interp_cells(self.u[l - 1], d[pre + "interp_cell"],
                                    d[pre + "interp_nb"],
                                    d[pre + "interp_sgn"], cfg,
                                    itype=spec.itype)
            if pre:
                out.append(K.tile_refine_flags(
                    self.u[l], interp, d["tile_src"], d["tile_vsgn"],
                    d["cell_tile"], d["cell_slot"], eg, fls, cfg,
                    spec.block_shift))
            else:
                out.append(K.refine_flags(self.u[l], interp,
                                          d["stencil_src"], d["vsgn"], eg,
                                          fls, cfg))
        return out

    def _flag_and_tree(self) -> Octree:
        spec = self._fused_spec()
        ttd = 2 ** self.tree.ndim
        shifts = torch.arange(ttd, dtype=torch.int32, device=self.device)
        # one uint8 per oct, all levels in one fetch: the only
        # device→host copy of a regrid
        packed = [(fl.to(torch.int32) << shifts).sum(dim=1).to(torch.uint8)
                  for fl in self._criteria_flags(spec)]
        host = torch.cat(packed).cpu().numpy()
        r = self.params.refine
        crit: Dict[int, np.ndarray] = {}
        off = 0
        for fl, l in zip(packed, spec.levels):
            bits = host[off:off + fl.shape[0]]
            off += fl.shape[0]
            f = ((bits[:self.maps[l].noct, None] >> np.arange(ttd)) & 1) \
                .astype(bool).reshape(-1)
            i = l - 1                                  # 1-based level lists
            if i < len(r.r_refine) and r.r_refine[i] > 0.0:
                f = f | flagmod.geometry_flags(
                    self.tree.cell_centers(l, self.boxlen), l, self.params)
            if self.pic and i < len(r.m_refine) and r.m_refine[i] >= 0.0:
                f = f | self._mass_flags(l, len(f), r.m_refine[i])
            crit[l] = f
        return flagmod.compute_new_tree(self.tree, crit, self.bc_kinds,
                                        self.params)

    def _mass_flags(self, l: int, ncell: int, m_refine: float):
        """Quasi-Lagrangian refinement (``flag_utils.f90`` m_refine): the
        cells of level ``l`` holding more than ``m_refine`` mean particle
        masses, from the gravity solve's total density of the level when it
        has one, else deposited on demand with the last maps (as the JAX
        package: without a solve since, the maps may be a build or more
        old).  Host bools in tree order, or all False without a density."""
        rho_dev = self._rho_dev.get(l)
        if rho_dev is None or rho_dev.shape[0] < ncell:
            if not self._pm_dev:
                self._build_pm()
            if l in self._pm_dev:
                rho_dev = self.u[l][:, 0] + self._pm_rho(l).to(
                    self.u[l].dtype)
        if rho_dev is None or rho_dev.shape[0] < ncell:
            return np.zeros(ncell, dtype=bool)
        mp = (float(torch.sum(self.p.m * self.p.active))
              / max(int(torch.sum(self.p.active)), 1))
        thr = m_refine * mp / self.dx(l) ** self.tree_ndim
        return self.tree_order_cells(rho_dev, l)[:ncell] > thr

    def regrid(self):
        """Flag, rebuild the tree, and migrate the device state
        (``flag_fine`` + ``refine_fine``/``kill_grid``) through the host
        prolongation maps."""
        self._mig_log: Dict[int, tuple] = {}
        if self.lmax == self.lmin:
            return
        newtree = self._flag_and_tree()
        old_u, oldtree = self.u, self.tree
        old_maps, old_dev = self.maps, self.dev
        self.tree = newtree
        if all(self._keys_same(oldtree, l)
               for l in range(self.lmin, self.lmax + 2)):
            self.tree = oldtree
            self.block_stats = {"blocks_total": sum(
                b.ntile for b in self.blocks.values()), "blocks_rebuilt": 0}
            return
        self._rebuild_maps(oldtree, old_maps, old_dev)
        new_u: Dict[int, torch.Tensor] = {}
        for l in self.levels():
            m = self.maps[l]
            if ((l == self.lmin or self._keys_same(oldtree, l))
                    and old_u[l].shape[0] == m.ncell_pad):
                new_u[l] = old_u[l]
                continue
            pmaps = mapmod.build_prolong_maps(self.tree, oldtree, l,
                                              self.bc_kinds)
            if self._needs_mig_log:
                # (copy_dst, copy_src, new_octs, f_cell, ncell_pad)
                self._mig_log[l] = pmaps[:4] + (m.ncell_pad,)
            new_u[l] = self._migrate_level(old_u.get(l), new_u[l - 1],
                                           m.ncell_pad, *pmaps)
        self.u = new_u
        # prune stale gravity state: a level whose bucketed size changed or
        # that vanished must not seed the next solve's warm start
        for l in list(self.phi):
            if (l not in self.maps
                    or self.phi[l].shape[0] != self.maps[l].ncell_pad):
                self.phi.pop(l, None)
                self.fg.pop(l, None)
                self.poisson_iters.pop(l, None)
                self._rho_dev.pop(l, None)
        self._restrict_all()
        self._dt_cache = None

    def _migrate_level(self, old, u_coarse, ncell_pad, copy_dst, copy_src,
                       new_octs, f_cell, nb):
        """One level of the new tree: surviving octs copied from the old
        rows, new octs interpolated from the (already migrated) coarser
        level (``make_grid_fine``, ``amr/refine_utils.f90:590``).  Every
        destination row is written once."""
        ttd = 1 << self.cfg.ndim
        sgn_tab, oct_ar = _mig_consts(self.cfg.ndim)
        buf = torch.zeros((ncell_pad, u_coarse.shape[1]), dtype=self.dtype,
                          device=self.device)
        if len(copy_dst):
            rows_d = (copy_dst.astype(np.int64)[:, None] * ttd
                      + oct_ar).reshape(-1)
            rows_s = (copy_src.astype(np.int64)[:, None] * ttd
                      + oct_ar).reshape(-1)
            buf.index_copy_(0, self._dev(rows_d),
                            old.index_select(0, self._dev(rows_s)))
        if len(new_octs):
            vals = K.interp_cells(
                u_coarse, self._dev(np.repeat(f_cell, ttd)),
                self._dev(np.repeat(nb, ttd, axis=0)),
                self._dev(np.tile(sgn_tab, (len(new_octs), 1)), self.dtype),
                self.cfg, itype=int(self.params.refine.interpol_type))
            rows_new = (new_octs.astype(np.int64)[:, None] * ttd
                        + oct_ar).reshape(-1)
            buf.index_copy_(0, self._dev(rows_new), vals.to(self.dtype))
        return buf

    def _restrict_all(self):
        """Restriction sweep fine→coarse so refined cells hold son means."""
        for l in sorted(self.levels(), reverse=True):
            if self.tree.has(l + 1):
                d = self.dev[l]
                self.u[l] = K.restrict_upload(self.u[l], self.u[l + 1],
                                              d["ref_cell"], d["son_oct"],
                                              self.cfg)

    # ------------------------------------------------------------------
    # time stepping
    # ------------------------------------------------------------------
    def _fused_spec(self) -> FusedSpec:
        if self._spec is None:
            lv = tuple(self.levels())
            self._spec = FusedSpec(
                cfg=self.cfg, bspec=self.bspec, lmin=self.lmin,
                boxlen=self.boxlen, levels=lv,
                complete=tuple(self.maps[l].complete for l in lv),
                itype=int(self.params.refine.interpol_type),
                blocked=tuple(l in self.blocks for l in lv),
                block_shift=int(self.params.amr.oct_block_shift),
                want_flux=(self.tracer_x is not None
                           and len(self.tracer_x) > 0),
                gravity=self.gravity)
            slab = tuple(self._slab_spec(l) if self.maps[l].complete
                         else None for l in lv)
            if any(sl is not None for sl in slab):
                self._spec = self._spec._replace(slab=slab)
        return self._spec

    def _slab_spec(self, l: int):
        """SlabSpec of a complete level's slab-sharded sweep, or None for
        the single-device sweep.  The single-device sim has no mesh:
        :class:`ramses_tpu_torch.parallel.amr_sharded.ShardedAmrSim`
        overrides this."""
        return None

    def coarse_dt(self) -> float:
        """The coarse step's dt: the CFL dt (the one device→host fetch of
        a hydro step) capped by :meth:`_aux_dts`."""
        if self._dt_cache is not None:
            dt = float(self._dt_cache)
        else:
            dt = float(torch.min(_courant(
                self.u, self.dev, self._fused_spec(),
                self.fg if (self.gravity and self.fg) else None)))
        return min([dt] + self._aux_dts())

    def _aux_dts(self) -> list:
        """The dt caps beside the CFL dt: the particle Courant and the
        lagged free-fall time, and the cosmological expansion."""
        dts = []
        if self.pic:
            cf = float(self.cfg.courant_factor)
            # particle Courant: a level-l particle moves cf*dx(l) per level
            # substep, i.e. cf*dx(lmin) per coarse step
            # (pm/newdt_fine.f90:186-233 folded through the exact factor-2
            # subcycling)
            dts.append(float(pmod.particle_dt(self.p, self.dx(self.lmin),
                                              cf)))
            if self.gravity and self._rho_max:
                # free-fall cap from the last solve's deposited density
                # (one step lagged; pm/newdt_fine.f90:51-60)
                dts.append(float(pmod.freefall_dt(self._rho_max, cf,
                                                  self.grav_coeff())))
        if self.cosmo is not None:
            # expansion cap (amr/update_time.f90 cosmo branch)
            dts.append(0.1 / abs(self.hexp_now()))
        return dts

    # ------------------------------------------------------------------
    # cosmology (host interpolation of the Friedmann tables)
    # ------------------------------------------------------------------
    # numpy's interpolation, as the JAX package's hierarchy takes it: its
    # rounding differs from ``Cosmology.aexp_of_tau`` (``jnp.interp``'s)
    # at a few times in a thousand, and grav_coeff must be the JAX
    # hierarchy's to the bit (tests/test_torch_cosmo.py)
    def aexp_now(self) -> float:
        if self.cosmo is None:
            return 1.0
        return float(np.interp(self.t, self.cosmo.tau_frw,
                               self.cosmo.axp_frw))

    def hexp_now(self) -> float:
        if self.cosmo is None:
            return 0.0
        return float(np.interp(self.t, self.cosmo.tau_frw,
                               self.cosmo.hexp_frw))

    def grav_coeff(self) -> float:
        """Poisson source coefficient: 4π, or the supercomoving
        ``1.5·Ωm·aexp`` (``poisson/multigrid_fine_commons.f90`` rhs)."""
        if self.cosmo is None:
            return 4.0 * np.pi
        return 1.5 * self.cosmo.omega_m * self.aexp_now()

    # ------------------------------------------------------------------
    # particle-mesh on the hierarchy (pm/amr_pm.py)
    # ------------------------------------------------------------------
    def _build_pm(self):
        """The maps pass, once per coarse step (``make_tree_fine`` + the
        index part of ``cic_amr``): each level's maps from a float64 copy
        of the positions, built on the device against the host tree's
        keys, and each level's deposit plan."""
        from ramses_tpu_torch.pm.coupling import deposit_scheme_from_params
        ncp = {l: self.maps[l].ncell_pad for l in self.levels()}
        pm_maps = amr_pm.build_pm_maps(
            self.tree, self.p.x.to(torch.float64), self.boxlen,
            self.bc_kinds, ncp,
            scheme=deposit_scheme_from_params(self.params))
        wdtype = (torch.float64 if self.p.x.dtype == torch.float64
                  else self.dtype)
        self._pm_dev = {l: amr_pm.device_maps(mp, ncp[l], wdtype)
                        for l, mp in pm_maps.items()}

    def _pm_rho(self, l: int):
        """Particle density on level ``l``'s flat cells (``rho_fine``)."""
        pd = self._pm_dev[l]
        ncp = self.maps[l].ncell_pad
        if pd["plan"]["ncell_pad"] != ncp:
            # maps of an older tree (the JAX package deposits with them
            # all the same): the plan onto this level's rows
            pd["plan"] = amr_pm.segment_plan(pd["idx"], pd["w"], ncp)
        return amr_pm.deposit_flat(pd["plan"], self.p.m.to(pd["w"].dtype),
                                   self.p.active,
                                   self.dx(l) ** self.cfg.ndim)

    def _pm_force(self):
        """Force at the particle positions, gathered at each particle's
        finest covering level (``move1``, ``pm/move_fine.f90:193``)."""
        f = None
        for l in self.levels():
            pd = self._pm_dev[l]
            fl = amr_pm.gather_flat(self.fg[l].to(pd["w"].dtype), pd["idx"],
                                    pd["w"], pd["mask"])
            f = fl if f is None else f + fl
        return f

    def _grav_pm_pre(self, dt: float):
        """The sequence before the sweep: rebuild the particle maps, solve
        the per-level Poisson problem, and complete the previous half-kick
        plus this step's opening half-kick with the new force at x^n
        (``synchro_fine``)."""
        if self.pic:
            self._build_pm()
        if self.gravity:
            self.solve_gravity()
        if self.pic and self.gravity:
            self.p = pmod.kick(self.p, self._pm_force(),
                               0.5 * (self.dt_old + dt))

    def _pm_drift(self, dt: float):
        """``move_fine``: drift with the coarse dt (fine levels would split
        it into exact halves with the same frozen force)."""
        if self.pic:
            self.p = pmod.drift(self.p, dt, self.boxlen,
                                periodic=self.grav_periodic)

    def solve_gravity(self):
        """Per-level Poisson solve, coarse→fine one-way interface
        (``multigrid_fine``): the exact periodic FFT on any complete level
        (the isolated multipole-Dirichlet CG when the box is open),
        Dirichlet-ghost PCG on partial levels warm-started from the last
        solve's potential; then the gradient force.  A periodic box's mean
        density is the solve's one host fetch."""
        from ramses_tpu_torch.poisson.isolated import (grad_isolated,
                                                       isolated_solve)
        from ramses_tpu_torch.poisson.solver import fft_solve
        nd = self.cfg.ndim
        coeff = self.grav_coeff()
        eps = float(self.params.poisson.epsilon)
        if self.grav_periodic:
            # mean density over leaves + particles (periodic solvability)
            mtot = float(self.totals()["mass"])
            if self.pic:
                mtot += float(torch.sum(self.p.m * self.p.active))
            rho_mean = mtot / (self.boxlen ** nd * np.prod(self.tree.root))
        else:
            rho_mean = 0.0       # the isolated problem is well-posed as is
        rho_max = None
        for l in self.levels():
            m = self.maps[l]
            d = self.dev[l]
            dx = self.dx(l)
            rho = self.u[l][:, 0]
            if self.pic:
                rho = rho + self._pm_rho(l).to(rho.dtype)
                self._rho_dev[l] = rho     # the m_refine criterion's input
                mx = torch.max(rho)
                rho_max = mx if rho_max is None else torch.maximum(rho_max,
                                                                   mx)
            rhs = coeff * (rho - rho_mean)
            if m.complete:
                ncell = m.noct * (1 << nd)
                shp = self.tree.cell_dims(l)
                dense = K.rows_to_dense(rhs, None, shp)
                if self.grav_periodic:
                    phi_dense = fft_solve(dense, dx)
                    fg_rows = K.dense_to_rows(
                        gs.grad_dense(phi_dense, dx, nd), None, shp)
                else:
                    phi_dense, gh = isolated_solve(dense / coeff, dx, coeff,
                                                   iters=300, tol=eps)
                    fg_rows = K.dense_to_rows(torch.movedim(
                        grad_isolated(phi_dense, gh, dx), 0, -1), None, shp)
                phi = K.dense_to_rows(phi_dense, None, shp).to(rhs.dtype)
                if m.ncell_pad > ncell:
                    phi = torch.cat([phi, phi.new_zeros(m.ncell_pad - ncell)])
                    fg_rows = torch.cat([fg_rows, fg_rows.new_zeros(
                        m.ncell_pad - ncell, nd)])
                self.phi[l] = phi
                self.fg[l] = fg_rows.to(self.dtype)
                continue
            ghosts = K.interp_cells(self.phi[l - 1][:, None], d["g_cell"],
                                    d["g_gnb"], d["g_sgn"], _Cfg1(nd),
                                    itype=1)[:, 0]
            phi, nit = gs.pcg_level(
                rhs, ghosts, d["g_nb"], d["g_octnb"], dx, d["g_valid"], nd,
                tol=eps, iters=200, phi0=self.phi.get(l), mg=d["g_mg"])
            self.poisson_iters[l] = nit
            self.phi[l] = phi
            self.fg[l] = gs.grad_phi(phi, ghosts, d["g_nb"], dx, d["g_valid"],
                                     nd).to(self.dtype)
        if rho_max is not None:
            self._rho_max = float(rho_max)   # one host fetch a solve

    def step_coarse(self, dt: float):
        # the particle maps, the solve and the particle kick at x^n
        self._grav_pm_pre(float(dt))
        spec = self._fused_spec()
        if spec.want_flux:
            # density BEFORE the step: the jump probabilities' denominator
            # (move_tracer.f90 uses the pre-step cell mass)
            self._tracer_rho0 = {l: self.u[l][:, 0] for l in spec.levels}
        out = _coarse_step(
            self.u, self.dev,
            torch.tensor(float(dt), dtype=self.dtype, device=self.device),
            spec, self.fg if self.gravity else None)
        self.u, self._dt_cache = out[0], out[1]
        if spec.want_flux:
            self._tracer_phi = out[2]
        self._pm_drift(float(dt))
        self.t += float(dt)
        self._source_passes(float(dt))
        self.dt_old = float(dt)
        self.nstep += 1

    def _source_passes(self, dt: float):
        """Coarse-cadence source passes after the step: the MC tracer
        jumps (``pm/move_tracer.f90``) from this step's capture."""
        if self.tracer_x is not None and self._tracer_phi is not None:
            amr_physics.mc_tracer_amr(self)

    def step_chunk(self, nsteps: int, tend: float) -> int:
        """Up to ``nsteps`` coarse steps with no host synchronisation in
        between, then one fetch of (t, dt, steps done); callers guarantee
        no regrid is due inside the chunk.  Returns the steps done."""
        spec = self._fused_spec()
        if (spec.want_flux or self.gravity or self.pic
                or self.cosmo is not None):
            raise ValueError("step_chunk: the MC tracers move, the gravity "
                             "solve and the particles run, and the "
                             "cosmological caps change before every coarse "
                             "step; use step_coarse")
        f64 = dict(dtype=torch.float64, device=self.device)
        dt0 = (self._dt_cache if self._dt_cache is not None
               else torch.min(_courant(self.u, self.dev, spec))).to(**f64)
        u, t, dtn, ndone = _multi_step(
            self.u, self.dev, torch.tensor(self.t, **f64),
            torch.tensor(float(tend), **f64), dt0, spec, nsteps)
        self.u, self._dt_cache = u, dtn
        t_host, dt_host, n = torch.stack([t, dtn, ndone.to(t.dtype)]) \
            .cpu().tolist()
        self.t, self.dt_old = t_host, dt_host
        self.nstep += int(n)
        return int(n)

    def updates_per_step(self) -> int:
        """Cell updates of one coarse step (every level substep counted):
        ``Σ_l noct(l)·2^d·2^(l-levelmin)``, as ``bench.py`` counts them."""
        ttd = 2 ** self.cfg.ndim
        return sum(self.tree.noct(l) * ttd * 2 ** (l - self.lmin)
                   for l in self.levels())

    def evolve(self, tend: float, nstepmax: int = 10 ** 9,
               verbose: bool = False, guard=None):
        """Advance to ``tend`` or ``nstepmax``: a regrid every
        ``regrid_interval`` coarse steps, and between regrids chunks of
        power-of-two length without host synchronisation.  ``guard``:
        optional :class:`ramses_tpu_torch.utils.ops.OpsGuard` (signal
        dumps, stop_run file, walltime watchdog), checked before each
        chunk."""
        # sign-safe end test: cosmology runs in negative conformal time
        tstop = tend * (1 - 1e-12) if tend >= 0 else tend * (1 + 1e-12)
        while self.t < tstop and self.nstep < nstepmax:
            if guard is not None and not guard.check():
                break
            t0 = time.perf_counter()
            if self.nstep % self.regrid_interval == 0:
                self.regrid()
            to_regrid = (self.regrid_interval
                         - self.nstep % self.regrid_interval)
            lim = min(to_regrid, nstepmax - self.nstep, 64)
            chunk = 1 << (max(lim, 1).bit_length() - 1)
            per = self.updates_per_step()
            if (chunk > 1 and self.tracer_x is None and not self.gravity
                    and not self.pic and self.cosmo is None):
                n = self.step_chunk(chunk, tend)
            else:
                dt = min(self.coarse_dt(), tend - self.t)
                self.step_coarse(dt)
                n = 1
            self.cell_updates += n * per
            if verbose:
                print(f"step {self.nstep:6d}  t={self.t:.6e} "
                      f"dt={self.dt_old:.3e} octs="
                      f"{[self.tree.noct(l) for l in self.levels()]} "
                      f"wall={time.perf_counter() - t0:.3f}s"
                      + (f" chunk={n}" if chunk > 1 else ""))
            if n == 0:
                break

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def drain(self):
        """Wait until the device has finished the queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def totals(self) -> dict:
        """Conservation audit over leaf cells (``check_cons``): the volume
        integrals of mass, momentum and energy, summed in f64 on the host
        from one fetch of every level's rows, keyed as
        :meth:`ramses_tpu_torch.driver.Simulation.totals`."""
        nd = self.cfg.ndim
        tot = np.zeros(self.cfg.nvar)
        levels = self.levels()
        n = [self.tree.noct(l) * (1 << self.tree.ndim) for l in levels]
        rows = torch.cat([self.u[l][:k] for l, k in zip(levels, n)]) \
            .to(torch.float64).cpu().numpy()
        for l, u in zip(levels, np.split(rows, np.cumsum(n)[:-1])):
            leaf = ~self.tree.refined_mask(l)
            tot += u[leaf].sum(axis=0) * self.dx(l) ** nd
        return {"mass": tot[0], "momentum": list(tot[1:1 + nd]),
                "energy": tot[1 + nd]}

    def status_note(self) -> str:
        """The CLI's closing note on the run: octs per level, and the
        tracer count when tracers run."""
        note = f"octs={[self.tree.noct(l) for l in self.levels()]}"
        if self.tracer_x is not None:
            note += f" tracers={len(self.tracer_x)}"
        return note

    def cosmo_line(self) -> str:
        """The JAX CLI's closing line of a cosmological hierarchy
        (``ramses_tpu/__main__.py:372-374``)."""
        return (f"cosmo-amr aexp={self.aexp_now():.4f} nstep={self.nstep} "
                f"octs={[self.tree.noct(l) for l in self.levels()]}")

    def leaf_sample(self, lvl: int):
        """(centers [n, ndim], u [n, nvar]) of the leaf cells at one level,
        on the host in f64."""
        u = self.tree_order_cells(self.u[lvl], lvl)
        leaf = ~self.tree.refined_mask(lvl)
        return self.tree.cell_centers(lvl, self.boxlen)[leaf], u[leaf]

    def ncell_leaf(self) -> int:
        return sum(int((~self.tree.refined_mask(l)).sum())
                   for l in self.levels())

    # ------------------------------------------------------------------
    # snapshot / restart
    # ------------------------------------------------------------------
    def dump(self, iout: int = 1, base_dir: str = ".",
             namelist_path: Optional[str] = None, ncpu: int = 1,
             dumper=None) -> str:
        """Write a reference-format ``output_NNNNN/`` snapshot (``ncpu >
        1``: one file set per domain, restorable onto any shard count) and
        return its path.

        ``dumper``: optional :class:`ramses_tpu_torch.io.async_writer.
        AsyncDumper`; the host snapshot is assembled here (every level's
        rows fetched once), the files are written on its thread."""
        from ramses_tpu_torch.io import snapshot as snapmod
        snap = snapmod.snapshot_from_amr(self, iout)
        keep = int(self.params.output.checkpoint_keep)
        if dumper is not None:
            dumper.submit(snap, iout, base_dir,
                          namelist_path=namelist_path, ncpu=ncpu,
                          keep_last=keep)
            return os.path.join(base_dir, f"output_{iout:05d}")
        return snapmod.dump_all(snap, iout, base_dir,
                                namelist_path=namelist_path, ncpu=ncpu,
                                keep_last=keep)

    @classmethod
    def from_snapshot(cls, params: Params, outdir: str, dtype=torch.float32,
                      device=None, **kw) -> "AmrSim":
        """Resume from a snapshot directory (the ``nrestart`` path); ``kw``
        go to the constructor (a subclass's own arguments, such as a shard
        mesh)."""
        from ramses_tpu_torch.io.snapshot import prim_out_to_cons
        cfg = HydroStatic.from_params(params)
        return restore_amr_scaffold(
            cls, params, outdir, dtype,
            to_cons=lambda q: prim_out_to_cons(q, cfg),
            place_level=_place_u_rows, device=device, **kw)

    @classmethod
    def from_checkpoint_dir(cls, params: Params, outdir: str,
                            dtype=torch.float32, device=None,
                            **kw) -> "AmrSim":
        """Restore from a checkpoint directory: ``output_NNNNN`` through
        :meth:`from_snapshot`; the JAX package's elastic sharded
        ``pario_NNNNN`` dumps are refused by name (ROADMAP A7)."""
        if os.path.basename(os.path.normpath(outdir)).startswith("pario_"):
            raise NotImplementedError(
                "not ported to ramses_tpu_torch yet: elastic sharded "
                f"checkpoints (&OUTPUT_PARAMS pario): {outdir}")
        return cls.from_snapshot(params, outdir, dtype=dtype, device=device,
                                 **kw)
