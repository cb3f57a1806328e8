"""Simulation driver: config → initial state → time loop (PyTorch).

Port of the uniform, pure-hydro branch of ``ramses_tpu/driver.py`` (and
the dispatch of ``ramses_tpu/__main__.py`` to the AMR hierarchies and to
the uniform MHD driver): the host keeps the output-time bookkeeping and
the device advances in fused multi-step chunks of
:func:`ramses_tpu_torch.grid.uniform.run_steps`, with one host
synchronisation per chunk.  Time is integrated in f64 whatever the state
dtype.

With ``&RUN_PARAMS poisson`` the uniform driver steps through
:func:`ramses_tpu_torch.pm.coupling.run_steps_pm` (self-gravity or an
analytic field, the general hydro formulation), as the JAX driver does.

Runs on CUDA unless the caller passes ``device="cpu"``; without a GPU a
run that did not ask for the CPU raises.  Every feature of the JAX driver
beyond hydro with gravity and MHD (uniform, or AMR on one device) raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

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
from ramses_tpu_torch.poisson.coupling import GravitySpec, gravity_field


@dataclass
class SimState:
    u: torch.Tensor
    t: float = 0.0
    nstep: int = 0
    iout: int = 1  # next output slot (1-based, like the reference)
    f: Optional[torch.Tensor] = None  # gravity field [ndim, *sp] (poisson)


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
        ("particles (&RUN_PARAMS pic)", params.run.pic),
        ("cosmology (&RUN_PARAMS cosmo)", params.run.cosmo),
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
        ("supervised restart (&RUN_PARAMS auto_resume / nrestart=-1)",
         r.auto_resume or r.nrestart == -1),
        ("restart (&RUN_PARAMS nrestart)", r.nrestart > 0),
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
    ]
    return [name for name, enabled in checks if enabled]


class Simulation:
    """Single-level simulation on a uniform grid.

    Resolution is ``2**levelmin`` per dimension scaled by nx/ny/nz coarse
    cells, cell size ``boxlen / 2**levelmin`` in user units — matching the
    reference's fully-refined base mesh.
    """

    def __init__(self, params: Params, dtype=torch.float32, device=None):
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
        u0 = condinit(shape, self.dx, params, self.cfg)
        self.state = SimState(u=torch.as_tensor(u0, dtype=dtype,
                                                device=self.device))
        self.pspec = PMSpec.from_params(params)
        self.gspec = GravitySpec.from_params(params)
        if (self.gspec.enabled and self.gspec.gravity_type == 0
                and any(f.kind == bmod.REFLECTING
                        for pair in self.bc.faces for f in pair)):
            # mirror walls need image masses, which the isolated multipole
            # solve does not provide
            raise NotImplementedError(
                "self-gravity with reflecting walls is unsupported "
                "(isolated solve covers outflow/inflow boxes)")
        if self.gspec.enabled:
            self._initial_force()
        self.output_times = list(params.output.tout[:params.output.noutput])
        # perf accounting (mus/pt of adaptive_loop.f90:204-212)
        self.cell_updates = 0
        self.wall_s = 0.0

    def _initial_force(self):
        """The force of the current state, so that the first -0.5 dt
        un-kick cancels exactly (the reference's nstep==0 save_phi_old,
        ``amr/amr_step.f90:260``)."""
        self.state.f = gravity_field(
            self.gspec, total_density(self.pspec, self.state.u), self.dx)

    @classmethod
    def from_state(cls, params: Params, u, t: float, nstep: int,
                   device=None, dtype=None) -> "Simulation":
        """Start from a given state ``u [nvar, *sp]`` (numpy or tensor —
        e.g. ``np.asarray(jax_sim.state.u)``), time ``t`` and step count
        ``nstep``; the dtype defaults to ``u``'s."""
        from ramses_tpu_torch.convert import state_from_numpy
        arr = np.asarray(u)
        if dtype is None:
            dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
        sim = cls(params, dtype=dtype, device=device)
        if tuple(arr.shape) != (sim.cfg.nvar,) + sim.grid.shape:
            raise ValueError(f"state shape {arr.shape} != "
                             f"{(sim.cfg.nvar,) + sim.grid.shape}")
        sim.state.u = state_from_numpy(arr, sim.device, dtype)
        if sim.gspec.enabled:
            sim._initial_force()
        sim.state.t = float(t)
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

    def evolve(self, chunk: int = 16, verbose: bool = False):
        """Run through each output time in turn up to the last (or
        ``nstepmax``).  One host synchronisation per chunk of ``chunk``
        steps (with gravity, :func:`run_steps_pm`, which also carries the
        force).  Snapshot output at the output times is not ported yet."""
        st = self.state
        nstepmax = self.params.run.nstepmax
        for tout in self.output_times[st.iout - 1:]:
            ttol = 1e-12 * (abs(tout) + 1.0)
            while st.t < tout - ttol and st.nstep < nstepmax:
                n = min(chunk, nstepmax - st.nstep)
                t_before = st.t
                t0 = time.perf_counter()
                if self.gspec.enabled:
                    f64 = dict(dtype=torch.float64, device=self.device)
                    u, st.f, t, ndone = run_steps_pm(
                        self.grid, self.gspec, self.pspec, st.u, st.f,
                        torch.tensor(st.t, **f64),
                        torch.tensor(tout, **f64), n)
                else:
                    u, t, ndone = run_steps(self.grid, st.u, st.t, tout, n)
                # the chunk's one synchronisation: fetch (t, ndone)
                t_host, ndone = (float(v) for v in
                                 torch.stack([t, ndone.to(t.dtype)]).cpu())
                ndone = int(ndone)
                wall = time.perf_counter() - t0
                self.wall_s += wall
                st.u, st.t, st.nstep = u, t_host, st.nstep + ndone
                self.cell_updates += ndone * self.grid.ncell
                if verbose:
                    print(self.step_line((st.t - t_before) / ndone
                                         if ndone else None, ndone))
                if ndone == 0:
                    break
            if st.t < tout - ttol:
                break  # budget exhausted before this output time
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


def run_namelist(path: str, ndim: int = 3, dtype=torch.float32,
                 verbose: bool = False, max_attempts: int = 1,
                 device=None, solver: Optional[str] = None,
                 nstepmax: Optional[int] = None):
    """Build-and-evolve from a namelist to the last output time or
    ``nstepmax`` (the namelist's unless given here).  ``solver`` "hydro"
    or "mhd" (default: :func:`is_mhd`, the JAX CLI's choice): hydro runs
    the uniform :class:`Simulation` or, with ``levelmax > levelmin``, the
    AMR hierarchy (:class:`ramses_tpu_torch.amr.hierarchy.AmrSim`); MHD
    runs the uniform :class:`ramses_tpu_torch.mhd.driver.MhdSimulation`
    or, with ``levelmax > levelmin``, the MHD hierarchy
    (:class:`ramses_tpu_torch.mhd.amr.MhdAmrSim`), as
    ``ramses_tpu/__main__.py`` dispatches.  ``max_attempts > 1``, a
    supervised run, is not ported yet."""
    if max_attempts > 1:
        raise NotImplementedError("not ported to ramses_tpu_torch yet: "
                                  "supervised restart (max_attempts > 1)")
    params = load_params(path, ndim=ndim)
    if nstepmax is not None:
        params.run.nstepmax = int(nstepmax)
    if solver is None:
        solver = "mhd" if is_mhd(params) else "hydro"
    if solver not in ("hydro", "mhd"):
        raise ValueError(f"solver must be 'hydro' or 'mhd', not {solver!r}")
    if params.amr.levelmax > params.amr.levelmin:
        if solver == "mhd":
            from ramses_tpu_torch.mhd.amr import MhdAmrSim as cls
        else:
            from ramses_tpu_torch.amr.hierarchy import AmrSim as cls
        sim = cls(params, dtype=dtype, device=device)
        out = params.output
        sim.evolve(out.tout[-1] if out.tout else out.tend,
                   nstepmax=params.run.nstepmax, verbose=verbose)
        return sim
    if solver == "mhd":
        from ramses_tpu_torch.mhd.driver import MhdSimulation
        sim = MhdSimulation(params, dtype=dtype, device=device)
        sim.evolve(nstepmax=params.run.nstepmax, verbose=verbose)
        return sim
    sim = Simulation(params, dtype=dtype, device=device)
    sim.evolve(verbose=verbose)
    return sim
