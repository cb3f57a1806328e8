"""Simulation driver: config → initial state → time loop → outputs
(PyTorch).

Port of the uniform, pure-hydro branch of ``ramses_tpu/driver.py`` (and
the dispatch of ``ramses_tpu/__main__.py`` to the AMR hierarchies and to
the uniform MHD driver): the host keeps the output-time bookkeeping and
the device advances in fused multi-step chunks of
:func:`ramses_tpu_torch.grid.uniform.run_steps`, with one host
synchronisation per chunk.  Time is integrated in f64 whatever the state
dtype.

``Simulation.dump`` writes a reference-format ``output_NNNNN/``
(:mod:`ramses_tpu_torch.io.snapshot`: staged, hashed into
``manifest.json``, renamed atomically) and ``from_snapshot`` restores one;
:func:`run_namelist` runs every driver through the supervisor
(:mod:`ramses_tpu_torch.resilience.supervisor`), which resolves
``&RUN_PARAMS nrestart``/``auto_resume`` and resumes an interrupted
attempt from the newest manifest-valid checkpoint; the CLI adds the
outputs and the run guard.

With ``&RUN_PARAMS poisson``, ``pic`` or ``cosmo`` the uniform driver
steps through :func:`ramses_tpu_torch.pm.coupling.run_steps_pm`
(self-gravity or an analytic field, particles, the supercomoving clock; the
general hydro formulation), as the JAX driver does.  A cosmological run
starts from the namelist's grafic or Gadget ICs (:func:`load_cosmo_ics`)
at the conformal time of ``aexp_ini`` and turns ``aout`` into output
times.

Runs on CUDA unless the caller passes ``device="cpu"``; without a GPU a
run that did not ask for the CPU raises.  Every feature of the JAX driver
beyond hydro with gravity, particles and cosmology, and MHD (uniform, or
AMR on one device) raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ramses_tpu_torch.config import Params, load_params
from ramses_tpu_torch.device import resolve_device
from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.grid.uniform import UniformGrid, run_steps
from ramses_tpu_torch.grid.uniform import totals as _totals
from ramses_tpu_torch.hydro.core import HydroStatic
from ramses_tpu_torch.init.regions import condinit
from ramses_tpu_torch.pm.coupling import PMSpec, run_steps_pm, total_density
from ramses_tpu_torch.pm.cosmology import Cosmology
from ramses_tpu_torch.pm.particles import ParticleSet
from ramses_tpu_torch.poisson.coupling import GravitySpec, gravity_field


@dataclass
class SimState:
    u: torch.Tensor
    t: float = 0.0
    nstep: int = 0
    iout: int = 1  # next output slot (1-based, like the reference)
    f: Optional[torch.Tensor] = None  # gravity field [ndim, *sp] (poisson)
    p: Optional[ParticleSet] = None
    # the previous step (the split particle kick's) on the particle-mesh
    # path, else the mean step of the last chunk (OpsGuard's dt probe)
    dt_old: float = 0.0


def load_cosmo_ics(params, cosmo, cfg, shape, dtype, device):
    """(ParticleSet in ``dtype`` on ``device``, gas u [nvar, *shape] numpy
    | None) from the namelist's ``initfile``/``filetype``
    (``amr/init_time.f90:303-414`` init_file)."""
    from ramses_tpu_torch.pm import init_part as ip

    path = params.init.initfile[0]
    want_gas = bool(params.run.hydro)
    if params.init.filetype == "grafic":
        x, v, m, ghdr = ip.particles_from_grafic(
            path, cosmo, omega_b=(cosmo.omega_b if want_gas else None))
        u0 = None
        if want_gas:
            dense, _ = ip.baryons_from_grafic(path, cosmo, cfg.gamma,
                                              cosmo.omega_b)
            if dense.shape[1:] != tuple(shape):
                raise ValueError(
                    f"grafic grid {dense.shape[1:]} != run grid {shape} "
                    "(levelmin must match the IC resolution)")
            u0 = np.zeros((cfg.nvar,) + tuple(shape))
            u0[:dense.shape[0]] = dense
        if abs(ghdr.astart - cosmo.aexp_ini) > 1e-3 * ghdr.astart:
            import warnings
            warnings.warn(f"grafic astart={ghdr.astart} != namelist "
                          f"aexp_ini={cosmo.aexp_ini}; file wins for "
                          "displacements, namelist for the time axis")
    else:
        x, v, m, _ = ip.particles_from_gadget(path, cosmo)
        u0 = None
    return ParticleSet.make(x, v, m, dtype=dtype, device=device), u0


def is_mhd(params: Params) -> bool:
    """The solver the JAX CLI picks without ``--solver``: MHD when
    &INIT_PARAMS sets a region field (``ramses_tpu/__main__.py:189-193``)."""
    init = params.init
    return bool(any(init.A_region) or any(init.B_region)
                or any(init.C_region))


def unported_features(params: Params) -> list:
    """Names of the namelist's features this port does not run yet, on the
    uniform grid or the AMR hierarchy (which adds its own,
    :func:`ramses_tpu_torch.amr.hierarchy.unported_amr_features`).  MHD
    runs uniform (:class:`ramses_tpu_torch.mhd.driver.MhdSimulation`) and on
    the hierarchy (:class:`ramses_tpu_torch.mhd.amr.MhdAmrSim`), with the
    refusals of :func:`ramses_tpu_torch.mhd.driver.unported_mhd_features`."""
    raw, r = params.raw or {}, params.run

    def on(group, key):
        v = raw.get(group, {}).get(key, False)
        return bool(v[0] if isinstance(v, list) else v)

    checks = [
        ("radiative transfer (&RUN_PARAMS rt)", params.run.rt),
        ("cooling (&COOLING_PARAMS cooling)", params.cooling.cooling),
        ("turbulence forcing (&TURB_PARAMS turb)",
         on("turb_params", "turb")),
        ("star formation (&SF_PARAMS)", bool(raw.get("sf_params"))),
        ("sinks (&SINK_PARAMS create_sinks)",
         on("sink_params", "create_sinks")),
        ("movies (&MOVIE_PARAMS movie)", on("movie_params", "movie")),
        ("ensemble (&ENSEMBLE_PARAMS nmember > 1)",
         params.ensemble.nmember > 1),
        ("elastic sharded checkpoints (&OUTPUT_PARAMS pario)",
         params.output.pario),
        ("step guard (&RUN_PARAMS max_step_retries)",
         r.max_step_retries > 0),
        ("watchdog (&RUN_PARAMS *_deadline_s)",
         max(r.compile_deadline_s, r.step_deadline_s, r.io_deadline_s) > 0),
        ("fault injection (&RUN_PARAMS fault_inject)",
         bool(str(r.fault_inject or "").strip("'\" "))),
        ("telemetry (&OUTPUT_PARAMS telemetry)",
         bool(str(params.output.telemetry or "").strip("'\" "))),
        ("patch hooks (&RUN_PARAMS patch)",
         bool(str(r.patch or "").strip("'\" "))),
        ("lightcone (&RUN_PARAMS lightcone)", r.lightcone),
        ("clump finder (&RUN_PARAMS clumpfind)", r.clumpfind),
    ]
    return [name for name, enabled in checks if enabled]


class Simulation:
    """Single-level simulation on a uniform grid.

    Resolution is ``2**levelmin`` per dimension scaled by nx/ny/nz coarse
    cells, cell size ``boxlen / 2**levelmin`` in user units — matching the
    reference's fully-refined base mesh.
    """

    def __init__(self, params: Params, dtype=torch.float32, device=None,
                 particles: Optional[ParticleSet] = None):
        missing = unported_features(params)
        if missing:
            raise NotImplementedError(
                "not ported to ramses_tpu_torch yet: " + ", ".join(missing))
        if is_mhd(params):
            raise NotImplementedError(
                "MHD namelists run through "
                "ramses_tpu_torch.mhd.driver.MhdSimulation, not the hydro "
                "Simulation (run_namelist and the CLI pick it)")
        if params.amr.levelmax > params.amr.levelmin:
            raise NotImplementedError(
                "AMR (levelmax > levelmin) runs through "
                "ramses_tpu_torch.amr.hierarchy.AmrSim, not the uniform "
                "Simulation (run_namelist and the CLI pick it)")
        self.device = resolve_device(device)
        self.params = params
        self.dtype = dtype
        self.cfg = HydroStatic.from_params(params)
        lmin = params.amr.levelmin
        n = 2 ** lmin
        base = [params.amr.nx, params.amr.ny, params.amr.nz][:params.ndim]
        shape = tuple(b * n for b in base)
        self.dx = params.amr.boxlen / n
        self.bc = bmod.BoundarySpec.from_params(params)
        self.grid = UniformGrid(cfg=self.cfg, shape=shape, dx=self.dx,
                                bc=self.bc)
        self.pspec = PMSpec.from_params(params)
        self.cosmo = (Cosmology.from_params(params) if params.run.cosmo
                      else None)
        self.gspec = GravitySpec.from_params(params)
        box_periodic = all(f.kind == bmod.PERIODIC
                           for pair in self.bc.faces for f in pair)
        if not box_periodic:
            if self.pspec.enabled:
                # the uniform stepper wraps the drift and the deposit
                # periodically: an open box would teleport escapers
                raise NotImplementedError(
                    "uniform-grid particles require a periodic box; "
                    "use the AMR driver for open-box PM runs")
            if self.cosmo is not None:
                raise NotImplementedError(
                    "cosmology requires a periodic box")
        if (self.gspec.enabled and self.gspec.gravity_type == 0
                and any(f.kind == bmod.REFLECTING
                        for pair in self.bc.faces for f in pair)):
            # mirror walls need image masses, which the isolated multipole
            # solve does not provide
            raise NotImplementedError(
                "self-gravity with reflecting walls is unsupported "
                "(isolated solve covers outflow/inflow boxes)")
        # cosmological IC files (grafic/gadget): particles + baryons
        # (init_part.f90 / init_flow_fine.f90 'file' branches)
        u0 = None
        if (self.cosmo is not None and params.init.initfile
                and params.init.filetype in ("grafic", "gadget")
                and particles is None):
            particles, u0 = load_cosmo_ics(params, self.cosmo, self.cfg,
                                           shape, dtype, self.device)
        if u0 is None:
            u0 = condinit(shape, self.dx, params, self.cfg)
        self.state = SimState(u=torch.as_tensor(u0, dtype=dtype,
                                                device=self.device))
        if self.pspec.enabled:
            from ramses_tpu_torch.pm.particles import lane_headroom
            # pic without IC particles: an empty set of npartmax lanes
            self.state.p = particles if particles is not None else \
                ParticleSet.make(np.zeros((0, params.ndim)),
                                 np.zeros((0, params.ndim)), np.zeros(0),
                                 dtype=dtype, device=self.device,
                                 nmax=lane_headroom(params, False) or 1)
        if self.gspec.enabled:
            # the supercomoving source coefficient at aexp_ini
            self._initial_force(
                1.5 * self.cosmo.omega_m * self.cosmo.aexp_ini
                if self.cosmo is not None else None)
        elif self.pspec.enabled or self.cosmo is not None:
            self.state.f = torch.zeros((params.ndim,) + shape, dtype=dtype,
                                       device=self.device)
        if self.cosmo is not None:
            self.state.t = self.cosmo.tau_ini
            # aexp-ladder outputs: aout -> conformal output times
            if params.output.aout:
                taus = [float(self.cosmo.tau_of_aexp(a))
                        for a in params.output.aout if a <= 1.0]
                params.output.tout = sorted(set(params.output.tout + taus))
                params.output.noutput = len(params.output.tout)
        self.output_times = list(params.output.tout[:params.output.noutput])
        # called as on_output(sim, iout) at each output time reached (the
        # CLI dumps there); None writes nothing
        self.on_output: Optional[Callable] = None
        # perf accounting (mus/pt of adaptive_loop.f90:204-212)
        self.cell_updates = 0
        self.wall_s = 0.0

    def fourpi_now(self):
        """The Poisson factor at the current time: None (the static 4π)
        without cosmology, else the supercomoving ``1.5·Ωm·aexp(t)``."""
        if self.cosmo is None:
            return None
        return 1.5 * self.cosmo.omega_m * self.cosmo.aexp_of_tau(
            self.state.t)

    @property
    def pm_path(self) -> bool:
        """True when the steps go through :func:`run_steps_pm` (gravity,
        particles or cosmology)."""
        return (self.gspec.enabled or self.pspec.enabled
                or self.cosmo is not None)

    def _initial_force(self, fourpi=None):
        """The force of the current state, so that the first -0.5 dt
        un-kick cancels exactly (the reference's nstep==0 save_phi_old,
        ``amr/amr_step.f90:260``); ``fourpi`` the Poisson factor when it
        is not the static one (cosmology)."""
        rho = total_density(self.pspec, self.state.u, self.state.p,
                            self.grid.shape, self.dx)
        self.state.f = gravity_field(self.gspec, rho, self.dx, fourpi)

    @classmethod
    def from_state(cls, params: Params, u, t: float, nstep: int,
                   device=None, dtype=None, particles=None, f=None,
                   dt_old: float = 0.0) -> "Simulation":
        """Start from a given state ``u [nvar, *sp]`` (numpy or tensor —
        e.g. ``np.asarray(jax_sim.state.u)``), time ``t`` and step count
        ``nstep``; the dtype defaults to ``u``'s.  ``particles`` (a
        :class:`ramses_tpu_torch.pm.particles.ParticleSet`, e.g. from
        :func:`ramses_tpu_torch.convert.particles_from`), the force ``f``
        of the last step (else the force of the given state) and the last
        step ``dt_old`` carry the particle-mesh state."""
        from ramses_tpu_torch.convert import state_from_numpy
        arr = np.asarray(u)
        if dtype is None:
            dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
        sim = cls(params, dtype=dtype, device=device, particles=particles)
        if tuple(arr.shape) != (sim.cfg.nvar,) + sim.grid.shape:
            raise ValueError(f"state shape {arr.shape} != "
                             f"{(sim.cfg.nvar,) + sim.grid.shape}")
        sim.state.u = state_from_numpy(arr, sim.device, dtype)
        sim.state.t = float(t)
        sim.state.dt_old = float(dt_old)
        if f is not None:
            sim.state.f = state_from_numpy(np.asarray(f), sim.device, dtype)
        elif sim.gspec.enabled:
            sim._initial_force(sim.fourpi_now())
        sim.state.nstep = int(nstep)
        sim.state.iout = 1 + sum(
            1 for tt in sim.output_times
            if sim.state.t >= tt - 1e-12 * (abs(tt) + 1.0))
        return sim

    @property
    def nstep(self) -> int:
        return int(self.state.nstep)

    @property
    def t(self) -> float:
        return float(self.state.t)

    @property
    def tend(self) -> float:
        if self.output_times:
            return self.output_times[-1]
        return float("inf")

    @property
    def dt_old(self) -> float:
        return float(self.state.dt_old)

    def evolve(self, chunk: int = 16, verbose: bool = False, guard=None):
        """Run through each output time in turn up to the last (or
        ``nstepmax``), calling ``on_output(self, iout)`` at each output time
        reached.  One host synchronisation per chunk of ``chunk`` steps
        (with gravity, :func:`run_steps_pm`, which also carries the
        force).  ``guard``: optional :class:`ramses_tpu_torch.utils.ops.
        OpsGuard` (signal dumps, stop_run file, walltime watchdog), checked
        before each chunk."""
        st = self.state
        nstepmax = self.params.run.nstepmax
        for tout in self.output_times[st.iout - 1:]:
            ttol = 1e-12 * (abs(tout) + 1.0)
            while st.t < tout - ttol and st.nstep < nstepmax:
                if guard is not None and not guard.check():
                    return st
                n = min(chunk, nstepmax - st.nstep)
                t_before = st.t
                t0 = time.perf_counter()
                if self.pm_path:
                    f64 = dict(dtype=torch.float64, device=self.device)
                    u, st.p, st.f, t, dt_old, ndone = run_steps_pm(
                        self.grid, self.gspec, self.pspec, st.u, st.p,
                        st.f, torch.tensor(st.t, **f64),
                        torch.tensor(tout, **f64),
                        torch.tensor(st.dt_old, **f64), n,
                        cosmo=self.cosmo)
                else:
                    u, t, ndone = run_steps(self.grid, st.u, st.t, tout, n)
                    dt_old = None
                # the chunk's one synchronisation: fetch (t, ndone[,
                # dt_old])
                vals = [t, ndone.to(t.dtype)] + (
                    [dt_old] if dt_old is not None else [])
                host = torch.stack(vals).cpu().tolist()
                t_host, ndone = host[0], int(host[1])
                wall = time.perf_counter() - t0
                self.wall_s += wall
                st.u, st.t, st.nstep = u, t_host, st.nstep + ndone
                if dt_old is not None:
                    st.dt_old = host[2]
                elif ndone:
                    st.dt_old = (st.t - t_before) / ndone
                self.cell_updates += ndone * self.grid.ncell
                if verbose:
                    print(self.step_line((st.t - t_before) / ndone
                                         if ndone else None, ndone))
                if ndone == 0:
                    break
            if st.t < tout - ttol:
                break  # budget exhausted before this output time: no dump
            if self.on_output is not None:
                self.on_output(self, st.iout)
            st.iout += 1
        return st

    def step_line(self, dt: Optional[float], chunk: int) -> str:
        """The per-chunk progress line."""
        line = f"step {self.nstep:6d}  t={self.t:.6e}"
        if dt is not None:
            line += f" dt={dt:.3e}"
        if self.cell_updates:
            line += f" mus/pt={self.mus_per_cell_update():.4f}"
        if chunk > 1:
            line += f" chunk={chunk}"
        return line

    def mus_per_cell_update(self) -> float:
        return 1e6 * self.wall_s / max(self.cell_updates, 1)

    def totals(self):
        """Conservation audit (``check_cons``) over the active grid."""
        return _totals(self.state.u, self.cfg, self.dx)

    def status_note(self) -> str:
        """The CLI's closing note on the run: microseconds per cell
        update."""
        return f"mus/pt={self.mus_per_cell_update():.4f}"

    # ------------------------------------------------------------------
    # snapshot / restart
    # ------------------------------------------------------------------
    def dump(self, iout: Optional[int] = None, base_dir: Optional[str] = None,
             namelist_path: Optional[str] = None) -> str:
        """Write a reference-format ``output_NNNNN/`` snapshot (the state
        is fetched once) and return its path."""
        import os

        from ramses_tpu_torch.io import snapshot as snapmod
        iout = iout if iout is not None else self.state.iout
        snap = snapmod.snapshot_from_uniform(self, iout)
        base = base_dir or self.params.output.output_dir
        extra = None
        if self.params.output.savegadget and self.state.p is not None:
            # &OUTPUT_PARAMS savegadget: each particle output also lands as
            # a Gadget SnapFormat=1 file, staged into the extras dir so
            # that it rides the checkpoint manifest
            from ramses_tpu_torch.io.gadget import dump_gadget_particles
            extra = os.path.join(base, f"output_{iout:05d}.extras.tmp")
            os.makedirs(extra, exist_ok=True)
            dump_gadget_particles(
                os.path.join(extra, f"gadget_{iout:05d}.dat"),
                self.state.p, boxlen=self.params.amr.boxlen,
                time=self.state.t)
        return snapmod.dump_all(
            snap, iout, base, namelist_path=namelist_path, extra_dir=extra,
            keep_last=int(self.params.output.checkpoint_keep))

    @classmethod
    def from_snapshot(cls, params: Params, outdir: str, dtype=torch.float32,
                      device=None) -> "Simulation":
        """Resume from a snapshot directory (the ``nrestart`` path).  The
        file holds f64 primitives, so an f32 state comes back within an
        ulp or two of the dumped one (E is rebuilt from them)."""
        from ramses_tpu_torch.io.restart import (restore_particles,
                                                 restore_uniform)
        from ramses_tpu_torch.pm.particles import lane_headroom
        dense, meta, parts = restore_uniform(
            outdir, params, HydroStatic.from_params(params))
        dev = resolve_device(device)
        p = (restore_particles(parts, params.ndim, dtype=dtype, device=dev,
                               nmax=lane_headroom(params, False))
             if parts else None)
        sim = cls(params, dtype=dtype, device=device, particles=p)
        sim.state.u = torch.as_tensor(dense, dtype=dtype, device=sim.device)
        sim.state.t = float(meta["t"])
        sim.state.nstep = int(meta["nstep"])
        iout_meta = int(meta["iout"])
        if iout_meta < 900:
            sim.state.iout = max(iout_meta, 1) + 1
        else:
            # emergency checkpoint (OpsGuard's 900+): its iout is NOT an
            # output-schedule index, so the next pending output comes from
            # the restored time
            sim.state.iout = 1 + sum(
                1 for tt in sim.output_times
                if sim.state.t >= tt - 1e-12 * (abs(tt) + 1.0))
        if sim.gspec.enabled:
            # the force of the restored density; the supercomoving factor
            # at the restored time, not at aexp_ini, so that the restart
            # continues the original trajectory
            sim._initial_force(sim.fourpi_now())
        return sim


def namelist_driver(params: Params, solver: Optional[str] = None):
    """``(cls, tend)``: the driver class a namelist runs on, as
    ``ramses_tpu/__main__.py`` dispatches, and the time the hierarchies
    evolve to (None on the uniform drivers, which follow the output
    times).  ``solver`` "hydro" or "mhd" (default: :func:`is_mhd`): hydro
    runs the uniform :class:`Simulation` or, with ``levelmax > levelmin``,
    :class:`ramses_tpu_torch.amr.hierarchy.AmrSim`; MHD the uniform
    :class:`ramses_tpu_torch.mhd.driver.MhdSimulation` or
    :class:`ramses_tpu_torch.mhd.amr.MhdAmrSim`."""
    if solver is None:
        solver = "mhd" if is_mhd(params) else "hydro"
    if solver not in ("hydro", "mhd"):
        raise ValueError(f"solver must be 'hydro' or 'mhd', not {solver!r}")
    out = params.output
    if params.amr.levelmax > params.amr.levelmin:
        if solver == "mhd":
            from ramses_tpu_torch.mhd.amr import MhdAmrSim as cls
        else:
            from ramses_tpu_torch.amr.hierarchy import AmrSim as cls
        if params.run.cosmo and out.aout:
            # a cosmological hierarchy runs to the conformal time of the
            # last aout (ramses_tpu/__main__.py:358-363)
            return cls, float(Cosmology.from_params(params).tau_of_aexp(
                min(out.aout[-1], 1.0)))
        return cls, (out.tout[-1] if out.tout else out.tend)
    if solver == "mhd":
        from ramses_tpu_torch.mhd.driver import MhdSimulation
        return MhdSimulation, None
    return Simulation, None


def build_namelist_sim(cls, params: Params, restart: Optional[str],
                       dtype=torch.float32, device=None):
    """A fresh ``cls`` on ``params``, or, with a ``restart`` directory, the
    one restored from it (the hierarchies through ``from_checkpoint_dir``,
    the uniform drivers through ``from_snapshot``)."""
    if restart is None:
        from ramses_tpu_torch.amr.hierarchy import AmrSim
        if (cls is AmrSim and params.run.cosmo and params.init.initfile
                and params.init.filetype in ("grafic", "gadget")):
            # the cosmological ICs on the hierarchy: the particles and the
            # base-level baryons, sampled onto each level
            n = 2 ** params.amr.levelmin
            particles, dense = load_cosmo_ics(
                params, Cosmology.from_params(params),
                HydroStatic.from_params(params), (n,) * params.ndim, dtype,
                resolve_device(device))
            return cls(params, dtype=dtype, device=device,
                       particles=particles, init_dense_u=dense)
        return cls(params, dtype=dtype, device=device)
    restore = getattr(cls, "from_checkpoint_dir", cls.from_snapshot)
    return restore(params, restart, dtype=dtype, device=device)


def evolve_namelist(sim, params: Params, tend: Optional[float],
                    verbose: bool = False, guard=None) -> None:
    """Evolve a sim of :func:`namelist_driver`'s class to its end: a
    hierarchy to ``tend`` or ``nstepmax``, the uniform drivers through
    their output times (``guard`` an :class:`ramses_tpu_torch.utils.ops.
    OpsGuard` checked once a chunk, or None)."""
    if tend is not None:
        sim.evolve(tend, nstepmax=params.run.nstepmax, verbose=verbose,
                   guard=guard)
    elif isinstance(sim, Simulation):
        sim.evolve(verbose=verbose, guard=guard)
    else:
        sim.evolve(nstepmax=params.run.nstepmax, verbose=verbose,
                   guard=guard)


def supervise_namelist(params: Params, build: Callable, drive: Callable,
                       max_attempts: int = 1, tend: Optional[float] = None):
    """``drive(build(restart_dir))`` through :func:`ramses_tpu_torch.
    resilience.supervisor.supervise`: the first attempt restores
    ``output_<nrestart>`` when ``&RUN_PARAMS nrestart > 0``, or the newest
    manifest-valid checkpoint under ``auto_resume`` or ``nrestart=-1``.
    With ``max_attempts > 1``, ``auto_resume`` or ``nrestart=-1`` the run
    is supervised (at least two attempts): an interrupted or failed
    attempt resumes from the newest valid checkpoint, with exponential
    backoff in between.  Returns the final sim."""
    from ramses_tpu_torch.resilience import supervisor as rsup
    r = params.run
    supervised = max_attempts > 1 or r.auto_resume or r.nrestart == -1
    return rsup.supervise(build, drive, params,
                          base_dir=params.output.output_dir,
                          max_attempts=(max(2, int(max_attempts))
                                        if supervised else 1), tend=tend)


def run_namelist(path: str, ndim: int = 3, dtype=torch.float32,
                 verbose: bool = False, max_attempts: int = 1,
                 device=None, solver: Optional[str] = None,
                 nstepmax: Optional[int] = None):
    """Build-and-evolve from a namelist to the last output time or
    ``nstepmax`` (the namelist's unless given here), on the driver
    :func:`namelist_driver` picks (``solver`` as there), through
    :func:`supervise_namelist` (``nrestart``, ``auto_resume`` and
    ``max_attempts``).  Writes nothing unless a restore or the caller
    asks: the CLI (``ramses_tpu_torch/__main__.py``) adds the outputs and
    the :class:`ramses_tpu_torch.utils.ops.OpsGuard`."""
    params = load_params(path, ndim=ndim)
    if nstepmax is not None:
        params.run.nstepmax = int(nstepmax)
    cls, tend = namelist_driver(params, solver)
    return supervise_namelist(
        params,
        lambda restart: build_namelist_sim(cls, params, restart, dtype,
                                           device),
        lambda sim: evolve_namelist(sim, params, tend, verbose=verbose),
        max_attempts=max_attempts, tend=tend)
