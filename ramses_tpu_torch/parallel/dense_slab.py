"""Explicit slab-sharded dense sweep for COMPLETE levels (PyTorch).

Port of the hydro half of ``ramses_tpu/parallel/dense_slab.py``.  A
complete level's flat rows split into equal contiguous chunks, one per
shard of a :class:`~ramses_tpu_torch.parallel.mesh.ShardMesh`, and each
shard

1. converts only its own rows to its dense sub-box (:func:`ramses_tpu_torch.
   amr.bitperm.flat_to_dense_slab`: a contiguous chunk of flat rows is an
   axis-aligned box, z cut first);
2. extends the box by ring halo exchanges, one per cut axis through the
   backend-dispatched exchange (:mod:`ramses_tpu_torch.parallel.dma_halo`:
   K5 on the ``dma`` backend), axis by axis over the growing block so that
   corner ghosts carry their global periodic values; uncut axes wrap
   locally.  The refined-cell mask, in the state dtype, is extended with
   the state in the same exchanges;
3. updates the box: K1's padded entry (:func:`ramses_tpu_torch.hydro.
   fused_muscl.fused_step_padded`) where it covers the configuration, else
   :func:`ramses_tpu_torch.amr.kernels.dense_interior_update`; the same
   per-cell arithmetic as the single-device :func:`ramses_tpu_torch.amr.
   kernels.dense_sweep`, so the result is bitwise that sweep's.  On the
   ``dma`` backend the last cut axis' exchange runs on a side stream while
   the interior band, which reads none of its ghosts, is updated;
   ``NGHOST``-thin strips are finished after it;
4. converts the update back to its flat rows.

Layout differs from the JAX package in one respect: dense blocks keep the
port's variables-leading order ``[nvar, *box]`` (K1's), where the JAX
functions keep the spatial axes leading.

The MHD constrained-transport advance (``mhd_ct_slab``) is not ported yet
(ROADMAP A8).  Scope: fully periodic cubic power-of-two levels with
unpadded rows and a power-of-two shard count; anything else keeps the
single-device sweep.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ramses_tpu_torch.amr import bitperm
from ramses_tpu_torch.hydro import fused_muscl as fm
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.parallel import dma_halo
from ramses_tpu_torch.parallel.mesh import ShardMesh


class SlabSpec(NamedTuple):
    """Static description of one complete level's slab decomposition."""
    lvl: int
    ndim: int
    mbits: int             # log2(ndev): top flat bits = shard index
    mesh: ShardMesh
    grid: Tuple[int, ...]  # shard grid extent per axis (prod = ndev)
    loc: Tuple[int, ...]   # local dense sub-box shape per shard
    # per-axis ring schedules ((fwd, bwd) pairs of (src, dst) tuples) for
    # cut axes; None = uncut (local periodic wrap)
    perms: tuple
    backend: str = "ppermute"  # resolved halo backend ("dma" | "ppermute")


def max_slab_devices(lvl: int, ndim: int) -> int:
    """Largest power-of-two shard count a complete level at ``lvl`` can
    cut into under :func:`build_slab_spec`'s rules."""
    return 1 << max(0, ndim * (lvl - 1))


def build_slab_spec(mesh: ShardMesh, lvl: int, ndim: int,
                    shape: Tuple[int, ...], ncell_pad: int, bc_kinds,
                    halo_backend: str = "auto") -> Optional[SlabSpec]:
    """SlabSpec for a complete level, or None when the level must keep the
    single-device sweep (non-periodic, non-cubic, padded rows, or a
    non-power-of-two / single-shard mesh).  ``halo_backend``: the
    ``&AMR_PARAMS`` knob, resolved by :func:`ramses_tpu_torch.parallel.
    dma_halo.resolve_backend` for the mesh's device."""
    ndev = mesh.ndev
    if ndev <= 1 or ndev & (ndev - 1):
        return None
    if tuple(shape) != (1 << lvl,) * ndim:
        return None
    if ncell_pad != (1 << lvl) ** ndim:
        return None
    mbits = ndev.bit_length() - 1
    if mbits > ndim * (lvl - 1):
        return None
    if any(k != 0 for lohi in bc_kinds for k in lohi):
        return None                                   # periodic only
    grid = tuple(1 << b for b in bitperm.grid_bits(lvl, ndim, mbits))
    loc = bitperm.slab_shape(lvl, ndim, mbits)
    if any(loc[d] < muscl.NGHOST for d in range(ndim)):
        return None                                   # shard < stencil
    coords = bitperm.chunk_coords(lvl, ndim, mbits)
    dev_of = {g: D for D, g in enumerate(coords)}
    perms = []
    for d in range(ndim):
        if grid[d] == 1:
            perms.append(None)
            continue
        fwd, bwd = [], []
        for D, g in enumerate(coords):
            up, dn = list(g), list(g)
            up[d] = (g[d] + 1) % grid[d]
            dn[d] = (g[d] - 1) % grid[d]
            fwd.append((D, dev_of[tuple(up)]))
            bwd.append((D, dev_of[tuple(dn)]))
        perms.append((tuple(fwd), tuple(bwd)))
    return SlabSpec(lvl=lvl, ndim=ndim, mbits=mbits, mesh=mesh, grid=grid,
                    loc=loc, perms=tuple(perms),
                    backend=dma_halo.resolve_backend(halo_backend,
                                                     mesh.device))


def _exchange_axis(fields, spec: SlabSpec, d: int, ng: int):
    """The send lists of axis ``d``'s ring exchange for every field
    ``(blocks, spatial0)``: (high slabs, fwd), (low slabs, bwd) each."""
    fwd, bwd = spec.perms[d]
    sends, perms = [], []
    for blocks, s0 in fields:
        ax = s0 + d
        sends += [[b.narrow(ax, b.shape[ax] - ng, ng) for b in blocks],
                  [b.narrow(ax, 0, ng) for b in blocks]]
        perms += [list(fwd), list(bwd)]
    return sends, perms


def halo_extend(fields, spec: SlabSpec, ng: int, axes=None):
    """Extend every shard's dense block of each field ``(blocks,
    spatial0)`` (spatial axes ``spatial0 .. spatial0+ndim-1``) by ``ng``
    ghost cells on every spatial axis: a ring exchange on cut axes (one
    for all fields, so one K5 launch an axis on the ``dma`` backend), a
    local periodic wrap on uncut ones.  Later axes exchange the already
    extended blocks, so corner ghosts carry their global periodic values.
    ``axes``: the subset of spatial axes to extend (the overlap split
    defers its cut axis).  Returns the extended per-shard lists, one per
    field."""
    out = [list(blocks) for blocks, _ in fields]
    s0s = [s0 for _, s0 in fields]
    for d in range(spec.ndim):
        if axes is not None and d not in axes:
            continue
        if spec.perms[d] is None:
            for f, s0 in enumerate(s0s):
                ax = s0 + d
                out[f] = [torch.cat([b.narrow(ax, b.shape[ax] - ng, ng), b,
                                     b.narrow(ax, 0, ng)], dim=ax)
                          for b in out[f]]
            continue
        sends, perms = _exchange_axis(list(zip(out, s0s)), spec, d, ng)
        recv = dma_halo.exchange_slabs(sends, perms, spec.backend)
        for f, s0 in enumerate(s0s):
            lo, hi = recv[2 * f], recv[2 * f + 1]
            out[f] = [torch.cat([lo[s], b, hi[s]], dim=s0 + d)
                      for s, b in enumerate(out[f])]
    return out


def _shard_rows(rows, spec: SlabSpec) -> List[torch.Tensor]:
    return list(torch.chunk(rows, spec.mesh.ndev, dim=0))


def _to_dense(rows, spec: SlabSpec):
    """One shard's rows ``[n, *trailing]`` → its dense box ``[*trailing,
    *loc]``."""
    return bitperm.flat_to_dense_slab(rows, spec.lvl, spec.ndim, spec.mbits,
                                      vars_first=True)


def _to_rows(dense, spec: SlabSpec):
    """A dense box ``[*trailing, *loc]`` → one shard's rows ``[n,
    *trailing]``."""
    return bitperm.dense_to_flat_slab(dense, spec.lvl, spec.ndim, spec.mbits,
                                      vars_first=True)


def dense_apply_slab(rows, spec: SlabSpec, local_fn, ng: int):
    """Generic slab engine: flat rows ``[ncell, *trailing]`` → each
    shard's dense box ``[*trailing, *loc]`` → ``ng``-deep halo extension →
    ``local_fn(extended) -> [*trailing_out, *loc]`` → flat rows
    ``[ncell, *trailing_out]``."""
    nt = rows.dim() - 1
    blocks = [_to_dense(r, spec) for r in _shard_rows(rows, spec)]
    ext = halo_extend([(blocks, nt)], spec, ng)[0]
    return torch.cat([_to_rows(local_fn(e), spec) for e in ext])


def _split_axis(spec: SlabSpec, ng: int) -> Optional[int]:
    """Cut axis for the ``dma`` overlap split, or None.  The LAST cut axis
    is chosen because its exchange comes last in :func:`halo_extend`'s
    order, so deferring it reproduces the corner values of the unsplit
    pipeline."""
    if spec.backend != "dma":
        return None
    cut = [d for d in range(spec.ndim) if spec.perms[d] is not None]
    if not cut:
        return None
    d = cut[-1]
    return d if spec.loc[d] > 2 * ng else None


def dense_sweep_slab(u_flat, ok_flat, dt, dx: float, spec: SlabSpec, cfg,
                     ret_flux: bool = False):
    """Slab-sharded complete-level hydro sweep, the explicit formulation of
    :func:`ramses_tpu_torch.amr.kernels.dense_sweep` (bitwise the same du
    and phi).  ``u_flat [ncell, nvar]``; ``ok_flat``: flat-row refined mask
    or None; ``dt``: scalar or 0-d tensor.  Returns du rows (and with
    ``ret_flux`` phi rows ``[ncell, ndim, 2]``)."""
    from ramses_tpu_torch.amr import kernels as K

    nd = spec.ndim
    ng = muscl.NGHOST
    masked = ok_flat is not None
    dtype = u_flat.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=u_flat.device)
    k1 = fm.supports_padded(cfg, dtype)
    dsp = _split_axis(spec, ng)
    if dsp is not None:
        dma_halo.TRAFFIC["overlap_frac"] = (
            (spec.loc[dsp] - 2 * ng) / spec.loc[dsp])

    def update(up, okp, shape):
        """``(du [nvar, *shape], phi [2*nd, *shape] or None)`` of one
        padded block."""
        if k1:
            out = fm.fused_step_padded(up, dt, cfg, dx, ok_pad=okp,
                                       want_flux=ret_flux)
            un, phi = out if ret_flux else (out, None)
            inner = up[(slice(None),) + (slice(ng, -ng),) * nd]
            return un - inner, (phi.reshape((2 * nd,) + tuple(shape))
                                if ret_flux else None)
        out = K.dense_interior_update(up, okp, dt, dx, shape, cfg,
                                      ret_flux=ret_flux)
        if not ret_flux:
            return out, None
        return out[0], out[1].reshape(tuple(shape) + (2 * nd,)).movedim(
            -1, 0)

    ud = [_to_dense(r, spec) for r in _shard_rows(u_flat, spec)]
    fields = [(ud, 1)]
    if masked:
        okd = [_to_dense(r.to(dtype), spec)
               for r in _shard_rows(ok_flat, spec)]
        fields.append((okd, 0))
    ext = None if dsp is None else tuple(d for d in range(nd) if d != dsp)
    ups = halo_extend(fields, spec, ng, axes=ext)
    up, okp = ups[0], (ups[1] if masked else [None] * len(ud))
    outs = []
    if dsp is None:
        outs = [update(u, o, spec.loc) for u, o in zip(up, okp)]
    else:
        # overlap split: start the exchange of the deferred axis' slabs,
        # update the ghost-free interior band meanwhile, finish the two
        # boundary strips from the received ghosts
        ax = 1 + dsp
        sends, perms = _exchange_axis(
            [(up, 1)] + ([(okp, 0)] if masked else []), spec, dsp, ng)
        ghosts, finish = dma_halo.start_exchange(sends, perms, spec.backend)
        shape_int = tuple(spec.loc[d] - (2 * ng if d == dsp else 0)
                          for d in range(nd))
        shape_strip = tuple(ng if d == dsp else spec.loc[d]
                            for d in range(nd))
        inner = [update(u, o, shape_int) for u, o in zip(up, okp)]
        finish()
        for s, (u, o) in enumerate(zip(up, okp)):
            n = u.shape[ax]
            lo = update(torch.cat([ghosts[0][s], u.narrow(ax, 0, 2 * ng)],
                                  dim=ax),
                        None if o is None else torch.cat(
                            [ghosts[2][s], o.narrow(dsp, 0, 2 * ng)],
                            dim=dsp), shape_strip)
            hi = update(torch.cat([u.narrow(ax, n - 2 * ng, 2 * ng),
                                   ghosts[1][s]], dim=ax),
                        None if o is None else torch.cat(
                            [o.narrow(dsp, n - 2 * ng, 2 * ng),
                             ghosts[3][s]], dim=dsp), shape_strip)
            parts = (lo, inner[s], hi)
            outs.append((torch.cat([p[0] for p in parts], dim=ax),
                         torch.cat([p[1] for p in parts], dim=ax)
                         if ret_flux else None))
    du_rows = torch.cat([_to_rows(o[0], spec) for o in outs])
    if not ret_flux:
        return du_rows
    phi_rows = torch.cat([_to_rows(o[1], spec) for o in outs])
    return du_rows, phi_rows.reshape(-1, nd, 2)


def dense_flags_slab(u_flat, spec: SlabSpec, flags_fn, twotondim: int):
    """Slab-sharded complete-level refinement flags: ``flags_fn`` maps the
    1-ghost-extended block ``[nvar, *loc+2]`` to a bool grid of its spatial
    shape (``amr.kernels._grad_flags``); the interior is sliced here.
    Returns ``[noct, 2^ndim]`` flag rows."""
    nd = spec.ndim

    def local_fn(ext):
        return flags_fn(ext)[(slice(1, -1),) * nd]

    flags = dense_apply_slab(u_flat, spec, local_fn, ng=1)
    return flags.reshape(flags.shape[0] // twotondim, twotondim)
