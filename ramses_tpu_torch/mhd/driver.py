"""MHD simulation driver: region ICs and the time loop (PyTorch).

Port of the uniform-grid part of ``ramses_tpu/mhd/driver.py`` (the
hierarchy is :mod:`ramses_tpu_torch.mhd.amr`).  Region
ICs follow ``mhd/init_flow_fine.f90:475-596``: square regions set
[d, u, v, w, P] plus a uniform field [A_region, B_region, C_region].
The host keeps the output-time bookkeeping and the device advances in
chunks of :func:`ramses_tpu_torch.mhd.uniform.run_steps`, one host
synchronisation per chunk.

``dump`` writes the reference MHD snapshot layout (B as left/right face
columns) and ``from_snapshot`` restores it, the staggered faces verbatim.

Runs on CUDA unless the caller passes ``device="cpu"``.  Not ported yet,
each raising ``NotImplementedError`` naming it when the namelist turns it
on: the step guard, the watchdog, fault injection and telemetry.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ramses_tpu_torch.config import Params
from ramses_tpu_torch.device import resolve_device
from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.mhd import core, uniform as mu
from ramses_tpu_torch.mhd.core import IBX, IP, MhdStatic, NCOMP


def _region_mask(x, k, init, ndim):
    centers = [init.x_center, init.y_center, init.z_center]
    lengths = [init.length_x, init.length_y, init.length_z]
    en = float(init.exp_region[k])
    if en < 10.0:
        r = sum((2.0 * np.abs(x[d] - centers[d][k]) / lengths[d][k]) ** en
                for d in range(ndim)) ** (1.0 / en)
    else:
        r = np.maximum.reduce(
            [2.0 * np.abs(x[d] - centers[d][k]) / lengths[d][k]
             for d in range(ndim)])
    return r < 1.0


def mhd_condinit(shape, dx: float, p: Params, cfg: MhdStatic):
    """(u [nvar, *sp], bf [3, *sp]) as f64 numpy: conservative cell state
    and staggered faces from &INIT_PARAMS regions (uniform B per
    region)."""
    init = p.init
    ndim = cfg.ndim
    axes_c = [(np.arange(n) + 0.5) * dx for n in shape]

    q = np.zeros((cfg.nvar,) + tuple(shape))
    q[0] = cfg.smallr
    q[IP] = cfg.smallr * cfg.smallc ** 2 / cfg.gamma
    vels = [init.u_region, init.v_region, init.w_region]
    bvals = [init.A_region, init.B_region, init.C_region]

    # staggered faces: each cell's LOW face takes the owning cell's region
    # value, as the reference seeds both face fields from the cell's
    # region (mhd/init_flow_fine.f90:529-532)
    bf = np.zeros((NCOMP,) + tuple(shape))
    xc = np.meshgrid(*axes_c, indexing="ij")
    for k in range(init.nregion):
        if str(init.region_type[k]).strip() != "square":
            raise NotImplementedError("mhd ICs: square regions only")
        m = _region_mask(xc, k, init, ndim)
        q[0][m] = init.d_region[k]
        for c in range(NCOMP):
            q[1 + c][m] = vels[c][k]
            bf[c][m] = bvals[c][k]
        q[IP][m] = init.p_region[k]

    for c in range(NCOMP):
        if c < ndim:
            q[IBX + c] = 0.5 * (bf[c] + np.roll(bf[c], -1, axis=c))
        else:
            q[IBX + c] = bf[c]
    u = core.prim_to_cons(torch.from_numpy(q), cfg).numpy()
    return u, bf


def unported_mhd_features(params: Params) -> list:
    """Names of the namelist's features the port's MHD drivers do not run
    yet: the uniform :class:`MhdSimulation`, or with ``levelmax >
    levelmin`` the hierarchy :class:`ramses_tpu_torch.mhd.amr.MhdAmrSim`
    (beyond what :func:`ramses_tpu_torch.driver.unported_features` and, on
    the hierarchy, :func:`ramses_tpu_torch.amr.hierarchy.
    unported_amr_features` list: particles, restart, the step guard,
    telemetry, offload and the rest), and gravity, particles and
    cosmology, which the hydro drivers run.  The hierarchy refuses tracers too: the JAX package
    moves them there as CIC velocity tracers, which need the particle
    layer."""
    from ramses_tpu_torch.amr.hierarchy import unported_amr_features
    from ramses_tpu_torch.driver import unported_features
    amr = params.amr.levelmax > params.amr.levelmin
    out = (unported_amr_features if amr else unported_features)(params)
    if params.run.poisson:
        out.append("gravity on the MHD drivers (&RUN_PARAMS poisson)")
    if params.run.pic:
        out.append("particles on the MHD drivers (&RUN_PARAMS pic)")
    if params.run.cosmo:
        out.append("cosmology on the MHD drivers (&RUN_PARAMS cosmo)")
    if params.run.tracer and amr:
        out.append("tracers (&RUN_PARAMS tracer) on the MHD hierarchy")
    return out


class MhdSimulation:
    """Uniform-grid MHD run (the CT solver)."""

    def __init__(self, params: Params, dtype=torch.float32, device=None):
        missing = unported_mhd_features(params)
        if missing:
            raise NotImplementedError(
                "not ported to ramses_tpu_torch's MHD driver yet: "
                + ", ".join(missing))
        if params.amr.levelmax > params.amr.levelmin:
            raise NotImplementedError(
                "MHD on the AMR hierarchy (levelmax > levelmin) runs "
                "through ramses_tpu_torch.mhd.amr.MhdAmrSim (the port of "
                "ramses_tpu/mhd/amr.py), not the uniform MhdSimulation "
                "(run_namelist and the CLI pick it)")
        self.device = resolve_device(device)
        self.params = params
        self.dtype = dtype
        self.cfg = MhdStatic.from_params(params)
        base = [params.amr.nx, params.amr.ny, params.amr.nz][:params.ndim]
        if any(b != 1 for b in base):
            # this solver family builds cubic grids
            raise NotImplementedError(
                f"MHD requires nx=ny=nz=1 (got {base})")
        n = 2 ** params.amr.levelmin
        shape = tuple([n] * params.ndim)
        self.dx = params.amr.boxlen / n
        spec = bmod.BoundarySpec.from_params(params)
        bc_kinds = tuple((f[0].kind, f[1].kind) for f in spec.faces)
        for lo, hi in bc_kinds:
            for k in (lo, hi):
                if k not in (bmod.PERIODIC, bmod.OUTFLOW):
                    raise NotImplementedError(
                        "mhd boundaries: periodic/outflow only")
        self.grid = mu.MhdGrid(cfg=self.cfg, shape=shape, dx=self.dx,
                               bc_kinds=bc_kinds)
        u0, bf0 = mhd_condinit(shape, self.dx, params, self.cfg)
        self.u = torch.tensor(u0, dtype=dtype, device=self.device)
        self.bf = torch.tensor(bf0, dtype=dtype, device=self.device)
        self.t = 0.0
        self.nstep = 0
        self.iout = 1
        self.dt_old = 0.0  # mean step of the last chunk (OpsGuard's probe)
        self.cell_updates = 0
        self.wall_s = 0.0

    @classmethod
    def from_state(cls, params: Params, u, bf, t: float = 0.0,
                   nstep: int = 0, device=None, dtype=None
                   ) -> "MhdSimulation":
        """Start from a given state (numpy or tensors, e.g. a JAX run's
        ``np.asarray(sim.u)``/``sim.bf``): ``u [nvar, *sp]``, ``bf [3,
        *sp]``; the dtype defaults to ``u``'s."""
        from ramses_tpu_torch.convert import state_from_numpy
        arr = np.asarray(u.detach().cpu() if torch.is_tensor(u) else u)
        fac = np.asarray(bf.detach().cpu() if torch.is_tensor(bf) else bf)
        if dtype is None:
            dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
        sim = cls(params, dtype=dtype, device=device)
        want = (sim.cfg.nvar,) + sim.grid.shape
        if arr.shape != want or fac.shape != (NCOMP,) + sim.grid.shape:
            raise ValueError(f"state shapes {arr.shape}, {fac.shape} != "
                             f"{want}, {(NCOMP,) + sim.grid.shape}")
        sim.u = state_from_numpy(arr, sim.device, dtype)
        sim.bf = state_from_numpy(fac, sim.device, dtype)
        sim.t = float(t)
        sim.nstep = int(nstep)
        return sim

    def mus_per_cell_update(self) -> float:
        return 1e6 * self.wall_s / max(self.cell_updates, 1)

    def evolve(self, tend: Optional[float] = None, chunk: int = 16,
               nstepmax: int = 10 ** 9, verbose: bool = False, guard=None):
        """Advance to ``tend`` (default: the last output time, else
        ``tend`` of the namelist) or ``nstepmax`` steps, in chunks of
        ``chunk`` steps with one host synchronisation each.  ``guard``:
        optional :class:`ramses_tpu_torch.utils.ops.OpsGuard`, checked
        before each chunk."""
        p = self.params
        tend = tend if tend is not None else (
            p.output.tout[-1] if p.output.tout else p.output.tend)
        while self.t < tend * (1.0 - 1e-12) and self.nstep < nstepmax:
            if guard is not None and not guard.check():
                break
            n = min(chunk, nstepmax - self.nstep)
            t0 = time.perf_counter()
            t_before = self.t
            u, bf, t, ndone = mu.run_steps(self.grid, self.u, self.bf,
                                           self.t, tend, n)
            # the chunk's one synchronisation: fetch (t, ndone)
            t_host, ndone = (float(v) for v in
                             torch.stack([t, ndone.to(t.dtype)]).cpu())
            ndone = int(ndone)
            wall = time.perf_counter() - t0
            self.wall_s += wall
            self.u, self.bf, self.t = u, bf, t_host
            self.nstep += ndone
            if ndone:
                self.dt_old = (self.t - t_before) / ndone
            self.cell_updates += ndone * self.grid.ncell
            if verbose:
                dt = (self.t - t_before) / ndone if ndone else None
                print(self.step_line(dt, ndone))
            if ndone == 0:
                break

    def step_line(self, dt: Optional[float], chunk: int) -> str:
        """The per-chunk progress line."""
        line = f"step {self.nstep:6d}  t={self.t:.6e}"
        if dt is not None:
            line += f" dt={dt:.3e}"
        if self.cell_updates:
            line += f" mus/pt={self.mus_per_cell_update():.4f}"
        if chunk > 1:
            line += f" chunk={chunk}"
        return line + f" divb={float(self.max_divb()):.2e}"

    def max_divb(self):
        """max |div B| over the grid (a 0-d device tensor)."""
        return torch.max(torch.abs(core.div_b(
            [self.bf[c] for c in range(NCOMP)],
            (self.dx,) * self.cfg.ndim, self.cfg.ndim)))

    def totals(self):
        return mu.totals(self.u, self.cfg, self.dx)

    def status_note(self) -> str:
        """The CLI's closing note: microseconds per cell update and the
        divergence of B."""
        return (f"mus/pt={self.mus_per_cell_update():.4f} "
                f"max|divB|={float(self.max_divb()):.3e}")

    # ------------------------------------------------------------------
    # snapshot output (reference MHD layout: B left/right columns,
    # mhd/output_hydro.f90:88-149)
    # ------------------------------------------------------------------
    def var_names(self) -> List[str]:
        dims = "xyz"
        names = ["density"]
        names += [f"velocity_{dims[d]}" for d in range(self.cfg.ndim)]
        names += [f"B_{dims[c]}_left" for c in range(3)]
        names += [f"B_{dims[c]}_right" for c in range(3)]
        names += ["pressure"]
        names += [f"scalar_{i:02d}" for i in range(self.cfg.npassive)]
        return names

    def output_vars(self) -> np.ndarray:
        """[*sp, nvar_out] float64 in var_names() order (the state and the
        faces fetched once each)."""
        from ramses_tpu_torch.io.snapshot import host64
        cfg = self.cfg
        u = host64(self.u)
        bf = host64(self.bf)
        rho = np.maximum(u[0], cfg.smallr)
        cols = [u[0]]
        cols += [u[1 + d] / rho for d in range(cfg.ndim)]
        b_left, b_right = [], []
        for c in range(3):
            if c < cfg.ndim:
                b_left.append(bf[c])
                br = np.roll(bf[c], -1, axis=c)
                if self.grid.bc_kinds[c][1] != bmod.PERIODIC:
                    # outflow: the wrap would import the opposite edge;
                    # replicate the local edge face instead (zero-gradient)
                    idx = [slice(None)] * cfg.ndim
                    idx[c] = -1
                    br[tuple(idx)] = bf[c][tuple(idx)]
                b_right.append(br)
            else:
                b_left.append(u[IBX + c])
                b_right.append(u[IBX + c])
        cols += b_left + b_right
        ek = 0.5 * sum(u[1 + c] ** 2 for c in range(NCOMP)) / rho
        em = 0.5 * sum((0.5 * (bl + br)) ** 2
                       for bl, br in zip(b_left, b_right))
        cols.append((cfg.gamma - 1.0) * (u[IP] - ek - em))
        for s in range(cfg.npassive):
            cols.append(u[8 + s] / rho)
        return np.stack(cols, axis=-1)

    def dump(self, iout: int = 1, base_dir: str = ".",
             namelist_path: Optional[str] = None) -> str:
        """Write a reference-format ``output_NNNNN/`` snapshot and return
        its path."""
        from ramses_tpu_torch.io import snapshot as sm
        from ramses_tpu_torch.units import units as units_fn
        params = self.params
        lmin = params.amr.levelmin
        ndim = self.cfg.ndim
        dense = self.output_vars()
        levels = sm.uniform_levels_from_dense(dense, lmin, ndim)
        snap = sm.Snapshot(
            ndim=ndim, nlevelmax=max(params.amr.levelmax, lmin),
            levels=levels, boxlen=float(params.amr.boxlen), t=float(self.t),
            gamma=self.cfg.gamma, var_names=self.var_names(),
            units=units_fn(params), levelmin=lmin, nstep=self.nstep,
            nstep_coarse=self.nstep, tout=[params.output.tend or 0.0])
        return sm.dump_all(snap, iout, base_dir,
                           namelist_path=namelist_path,
                           keep_last=int(params.output.checkpoint_keep))

    @classmethod
    def from_snapshot(cls, params: Params, outdir: str, dtype=torch.float32,
                      device=None) -> "MhdSimulation":
        """Rebuild from a :meth:`dump` directory (the restart path).

        The MHD columns store B as left/right face pairs: the staggered
        ``bf`` comes straight back from the left columns and the
        cell-centred field from their average, so dump→restore round
        trips exactly at file precision.  Velocity components beyond
        ndim are not written by :meth:`output_vars` and restore as zero.
        """
        from ramses_tpu_torch.amr.tree import cell_offsets
        from ramses_tpu_torch.io.restart import restore_tree_state
        cfg = MhdStatic.from_params(params)
        lmin = params.amr.levelmin
        tree_og, rows_lv, meta, _parts = restore_tree_state(
            outdir, cfg, lmin, to_cons=lambda q: q)   # raw output rows
        if lmin not in rows_lv:
            raise ValueError(f"snapshot has no level {lmin} data")
        ndim = cfg.ndim
        n = 1 << lmin
        og = tree_og[lmin]
        offs = cell_offsets(ndim)
        cc = (2 * og[:, None, :] + offs[None, :, :]).reshape(-1, ndim)
        rows = rows_lv[lmin]                          # [ncell, nvar_out]
        dense = np.zeros((rows.shape[1],) + (n,) * ndim)
        idx = tuple(cc[:, d] for d in range(ndim))
        for iv in range(rows.shape[1]):
            dense[iv][idx] = rows[:, iv]
        ib = 1 + ndim                                 # first B_left column
        bl = dense[ib:ib + 3]
        br = dense[ib + 3:ib + 6]
        q = np.zeros((cfg.nvar,) + (n,) * ndim)
        q[0] = dense[0]
        for d in range(ndim):
            q[1 + d] = dense[1 + d]
        for c in range(NCOMP):
            q[IBX + c] = 0.5 * (bl[c] + br[c])
        q[IP] = dense[ib + 6]
        for s in range(cfg.npassive):
            q[8 + s] = dense[ib + 7 + s]              # per-mass scalar
        sim = cls(params, dtype=dtype, device=device)
        sim.u = torch.as_tensor(core.prim_to_cons(torch.from_numpy(q), cfg),
                                dtype=dtype, device=sim.device)
        sim.bf = torch.as_tensor(bl, dtype=dtype, device=sim.device)
        sim.t = float(meta["t"])
        sim.nstep = int(meta["nstep"])
        sim.iout = max(int(meta["iout"]), 0) + 1
        return sim
