"""Simulation driver: config → initial state → time loop (PyTorch).

Port of the uniform, pure-hydro branch of ``ramses_tpu/driver.py``: the
host keeps the output-time bookkeeping and the device advances in fused
multi-step chunks of :func:`ramses_tpu_torch.grid.uniform.run_steps`,
with one host synchronisation per chunk.  Time is integrated in f64
whatever the state dtype.

Runs on CUDA unless the caller passes ``device="cpu"``; without a GPU a
run that did not ask for the CPU raises.  Every feature of the JAX driver
beyond uniform pure hydro raises ``NotImplementedError`` naming it.
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


@dataclass
class SimState:
    u: torch.Tensor
    t: float = 0.0
    nstep: int = 0
    iout: int = 1  # next output slot (1-based, like the reference)


def unported_features(params: Params) -> list:
    """Names of the namelist's features this port does not run yet."""
    raw = params.raw or {}

    def on(group, key):
        v = raw.get(group, {}).get(key, False)
        return bool(v[0] if isinstance(v, list) else v)

    checks = [
        ("AMR (levelmax > levelmin)",
         params.amr.levelmax > params.amr.levelmin),
        ("gravity (&RUN_PARAMS poisson)", params.run.poisson),
        ("particles (&RUN_PARAMS pic)", params.run.pic),
        ("cosmology (&RUN_PARAMS cosmo)", params.run.cosmo),
        ("MHD", params.run.mhd or any(params.init.A_region)
         or any(params.init.B_region) or any(params.init.C_region)),
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
         params.run.auto_resume or params.run.nrestart == -1),
        ("patch hooks (&RUN_PARAMS patch)",
         bool(str(params.run.patch or "").strip("'\" "))),
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
        self.output_times = list(params.output.tout[:params.output.noutput])
        # perf accounting (mus/pt of adaptive_loop.f90:204-212)
        self.cell_updates = 0
        self.wall_s = 0.0

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
        steps.  Snapshot output at the output times is not ported yet."""
        st = self.state
        nstepmax = self.params.run.nstepmax
        for tout in self.output_times[st.iout - 1:]:
            ttol = 1e-12 * (abs(tout) + 1.0)
            while st.t < tout - ttol and st.nstep < nstepmax:
                n = min(chunk, nstepmax - st.nstep)
                t_before = st.t
                t0 = time.perf_counter()
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


def run_namelist(path: str, ndim: int = 3, dtype=torch.float32,
                 verbose: bool = False, max_attempts: int = 1,
                 device=None) -> Simulation:
    """Build-and-evolve from a namelist (``max_attempts > 1``, a
    supervised run, is not ported yet)."""
    if max_attempts > 1:
        raise NotImplementedError("not ported to ramses_tpu_torch yet: "
                                  "supervised restart (max_attempts > 1)")
    sim = Simulation(load_params(path, ndim=ndim), dtype=dtype,
                     device=device)
    sim.evolve(verbose=verbose)
    return sim
