"""Explicit halo exchange for the uniform grid: the slab pipeline (PyTorch).

Port of ``ramses_tpu/parallel/halo.py``.  The state lives as per-shard
blocks along the leading spatial axis of a :class:`~ramses_tpu_torch.
parallel.mesh.ShardMesh`; each step sends the ``NGHOST``-deep boundary
slabs to the ring neighbours through the backend-dispatched exchange
(:mod:`ramses_tpu_torch.parallel.dma_halo`: K5 on the ``dma`` backend),
pads the remaining axes locally, and updates each shard's padded block:
K1's padded entry (:func:`ramses_tpu_torch.hydro.fused_muscl.
fused_step_padded`) where it covers the configuration, else the general
formulation (``muscl.unsplit``).  The step's dt is the min over the
shards' Courant mins, a 0-d device tensor (the JAX package's ``pmin``);
nothing synchronises with the host.

On the ``dma`` backend the step is region-split: the boundary slabs go out
on a side stream while the interior band, which reads no ghost of the cut
axis, is updated on the current stream; the two ``NGHOST``-thin strips
are finished once the ghosts have arrived.  The update is per-cell
arithmetic, so the split is bitwise invisible, and a run on any number of
shards is bitwise the single-device ``grid.uniform.run_steps``.

Scope: fully periodic boxes, 1-D decomposition over the leading axis.
"""

from __future__ import annotations

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.grid.uniform import UniformGrid, _time
from ramses_tpu_torch.hydro import fused_muscl as fm
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.hydro.timestep import compute_dt
from ramses_tpu_torch.parallel import dma_halo
from ramses_tpu_torch.parallel.mesh import ShardMesh

NG = muscl.NGHOST


def _check(grid: UniformGrid, mesh: ShardMesh):
    n = mesh.ndev
    if any(f[0].kind != 0 or f[1].kind != 0 for f in grid.bc.faces):
        raise NotImplementedError(
            "halo backend: fully periodic boxes only (physical boundary "
            "slabs are not part of the slab pipeline)")
    if grid.shape[0] % n:
        raise ValueError(f"leading axis {grid.shape[0]} not divisible by "
                         f"the {n}-shard mesh")
    if grid.shape[0] // n < NG:
        raise ValueError("shard thinner than the stencil halo")


def _ring(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]    # data moves +x
    bwd = [(i, (i - 1) % n) for i in range(n)]    # data moves -x
    return fwd, bwd


def _exchange(blocks, ng: int, backend: str):
    """Ring exchange of the leading-spatial-axis boundary slabs: each
    shard's block ``[nvar, nx_loc, ...]`` extended to ``nx_loc + 2*ng``
    (the low ghost is the left neighbour's high interior slab and vice
    versa; shard 0's left neighbour is the last shard, the periodic
    wrap)."""
    fwd, bwd = _ring(len(blocks))
    lo, hi = dma_halo.exchange_pair([b[:, -ng:] for b in blocks],
                                    [b[:, :ng] for b in blocks], fwd, bwd,
                                    backend)
    return [torch.cat([lo[s], b, hi[s]], dim=1)
            for s, b in enumerate(blocks)]


def _pad_rest(u_ext, ndim: int, ng: int):
    """Periodic-wrap padding of the non-decomposed spatial axes."""
    for ax in range(2, ndim + 1):
        n = u_ext.shape[ax]
        u_ext = torch.cat([u_ext.narrow(ax, n - ng, ng), u_ext,
                           u_ext.narrow(ax, 0, ng)], dim=ax)
    return u_ext


def _block(up, dt, grid: UniformGrid, fused: bool):
    """One padded block's update: ``(un, dt_next)`` of K1's padded entry
    (``dt_next`` its Courant min) or of the general formulation (None)."""
    cfg = grid.cfg
    if fused:
        return fm.fused_step_padded(up, dt, cfg, grid.dx, courant=True)
    flux, tmp = muscl.unsplit(up, None, dt, (grid.dx,) * cfg.ndim, cfg)
    un = muscl.apply_fluxes(up, flux, cfg)
    if cfg.pressure_fix or cfg.nener:
        un = muscl.dual_energy_fix(up, un, tmp, dt, (grid.dx,) * cfg.ndim,
                                   cfg)
    return bmod.unpad(un, cfg.ndim, NG), None


def _local_step(shards, dt, grid: UniformGrid, backend: str, split: bool,
                fused: bool):
    """One step of every shard: ``(new shards, per-block Courant mins)``."""
    nd = grid.cfg.ndim
    if not split:
        outs = [_block(_pad_rest(e, nd, NG), dt, grid, fused)
                for e in _exchange(shards, NG, backend)]
        return [o[0] for o in outs], [o[1] for o in outs]
    # overlap split: pad the uncut axes first, start the ring exchange of
    # the (rest-padded) boundary slabs, update the interior band while the
    # copies are in flight, then finish the two NGHOST-thin strips from
    # the received ghosts.  Exchanging rest-padded slabs gives the corner
    # values of the sequenced pad-after-exchange order (the wrap is a
    # per-axis local copy, identical on either side of the exchange).
    upr = [_pad_rest(u, nd, NG) for u in shards]
    fwd, bwd = _ring(len(shards))
    (lo_g, hi_g), finish = dma_halo.start_exchange(
        [[b[:, -NG:] for b in upr], [b[:, :NG] for b in upr]], [fwd, bwd],
        backend)
    inner = [_block(b, dt, grid, fused) for b in upr]   # cells [ng, nx-ng)
    finish()
    new, dts = [], []
    for s, b in enumerate(upr):
        lo = _block(torch.cat([lo_g[s], b[:, :2 * NG]], dim=1), dt, grid,
                    fused)                              # cells [0, ng)
        hi = _block(torch.cat([b[:, -2 * NG:], hi_g[s]], dim=1), dt, grid,
                    fused)                              # cells [nx-ng, nx)
        new.append(torch.cat([lo[0], inner[s][0], hi[0]], dim=1))
        dts += [lo[1], inner[s][1], hi[1]]
    return new, dts


def run_steps_halo(grid: UniformGrid, mesh: ShardMesh, u, t, tend,
                   nsteps: int, halo_backend: str = "auto"):
    """``grid.uniform.run_steps`` on the shards of ``mesh`` with the
    explicit slab pipeline: every step one ring exchange (two slabs a
    shard) and a min over the shards' Courant mins.  ``u``: the global
    state ``[nvar, *shape]`` (tensor or numpy); ``halo_backend``:
    ``auto``/``dma``/``ppermute`` (:func:`ramses_tpu_torch.parallel.
    dma_halo.resolve_backend`).  Returns ``(u, t, n_done)`` like
    ``run_steps``, ``u`` the shards concatenated along x (the global view)
    on the mesh's device."""
    _check(grid, mesh)
    cfg = grid.cfg
    n = mesh.ndev
    backend = dma_halo.resolve_backend(halo_backend, mesh.device)
    shards = mesh.shard(u, 1)
    dtype = shards[0].dtype
    split = backend == "dma" and grid.shape[0] // n > 2 * NG
    if split:
        nloc = grid.shape[0] // n
        dma_halo.TRAFFIC["overlap_frac"] = (nloc - 2 * NG) / nloc
    fused = fm.supports_padded(cfg, dtype)
    t = _time(t, shards[0])
    tend = _time(tend, shards[0])

    def cfl():
        return torch.min(torch.stack([compute_dt(s, None, grid.dx, cfg)
                                      for s in shards]))

    # the fused formulation takes each step's dt from the previous step's
    # kernels (grid.uniform._run_steps_fused), the general one from the
    # state (run_steps)
    dtc = cfl() if fused else None
    ndone = torch.zeros((), dtype=torch.int64, device=t.device)
    for _ in range(nsteps):
        dt = (dtc if fused else cfl()).to(torch.float64)
        dt = torch.minimum(dt, torch.clamp(tend - t, min=0.0))
        active = t < tend
        dt_eff = torch.where(active, dt, 0.0)
        new, dts = _local_step(shards, dt_eff.to(dtype), grid, backend,
                               split, fused)
        if fused:
            # an inactive step has dt = 0 and returns the state itself
            shards = new
            dtc = torch.where(active, torch.min(torch.stack(dts)), dtc)
        else:
            shards = [torch.where(active, a, b) for a, b in zip(new, shards)]
        t = torch.where(active, t + dt, t)
        ndone = ndone + active.to(torch.int64)
    return mesh.gather(shards, 1), t, ndone
