"""AMR with complete levels slab-sharded over a shard mesh (PyTorch).

Port of the hydro half of ``ramses_tpu/parallel/amr_sharded.py``
(``ShardedAmrSim``).  Every level keeps its flat rows, padded to a
multiple of the shard count, and shard ``s`` owns the ``s``-th equal
contiguous chunk of them.  A complete level inside the slab envelope (a
fully periodic cubic power-of-two level with unpadded rows on a
power-of-two mesh) sweeps and flags through the explicit slab formulation
(:mod:`ramses_tpu_torch.parallel.dense_slab`): shard-local bitperm and
ring halos through the exchange of :mod:`ramses_tpu_torch.parallel.
dma_halo` (K5 on the ``dma`` backend, chosen by ``&AMR_PARAMS
halo_backend``), the update through K1's padded entry.  The result is
bitwise the single-device :class:`~ramses_tpu_torch.amr.hierarchy.AmrSim`'s.

Partial levels keep the single-device sweeps (K3, K2).  All shards of a
mesh share one device here, so the global view those sweeps take needs no
communication: the same arithmetic on the same rows, not a fallback.

``dump`` writes one file set per shard (``ncpu`` = the shard count), as
the JAX package's does; :meth:`AmrSim.from_snapshot` restores it onto any
shard count.

Not ported yet, and refused by name: the explicit partial-level schedules
(``explicit_comm=True``, ``parallel/amr_comm``), load balance, a mesh
across several cards, MHD on a mesh (``ShardedMhdAmrSim`` with
``dense_slab.mhd_ct_slab``) and self-gravity (``&RUN_PARAMS poisson``,
which the single-device hierarchy runs); ROADMAP A8 holds them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ramses_tpu_torch.amr.hierarchy import AmrSim
from ramses_tpu_torch.config import Params
from ramses_tpu_torch.device import resolve_device
from ramses_tpu_torch.parallel.mesh import ShardMesh


class ShardedAmrSim(AmrSim):
    """AmrSim whose complete levels sweep shard by shard over ``devices``
    (a :class:`ShardMesh`, or a sequence of devices for one; default every
    visible card)."""

    _pm_physics = False

    @classmethod
    def _unported(cls, params: Params) -> list:
        from ramses_tpu_torch.driver import is_mhd
        mhd = ["MHD on a shard mesh (ShardedMhdAmrSim, dense_slab."
               "mhd_ct_slab; ROADMAP A8)"]
        grav = ["gravity on ShardedAmrSim (&RUN_PARAMS poisson; ROADMAP A8)"]
        pm = [name for name, on in (
            ("particles on ShardedAmrSim (&RUN_PARAMS pic; ROADMAP A8)",
             params.run.pic),
            ("cosmology on ShardedAmrSim (&RUN_PARAMS cosmo; ROADMAP A8)",
             params.run.cosmo)) if on]
        return (super()._unported(params) + (mhd if is_mhd(params) else [])
                + (grav if params.run.poisson else []) + pm)

    def __init__(self, params: Params, devices=None, dtype=torch.float32,
                 device=None, init_tree=None,
                 noct_pad: Optional[Dict[int, int]] = None,
                 seed_tracers: bool = True, explicit_comm: bool = False):
        if explicit_comm:
            raise NotImplementedError(
                "not ported to ramses_tpu_torch yet: explicit partial-level "
                "comm schedules (explicit_comm=True, parallel/amr_comm; "
                "ROADMAP A8)")
        mesh = devices if isinstance(devices, ShardMesh) else \
            ShardMesh(devices)
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.devices = mesh
        self.ndev = mesh.ndev
        self._ok_flat: Dict[int, tuple] = {}
        super().__init__(params, dtype=dtype, device=mesh.device,
                         init_tree=init_tree, noct_pad=noct_pad,
                         seed_tracers=seed_tracers)

    def dump(self, iout: int = 1, base_dir: str = ".", namelist_path=None,
             ncpu: Optional[int] = None, dumper=None) -> str:
        """One file set per shard by default (``ncpu`` = the shard count:
        each domain is its shard's contiguous rows), restorable onto any
        shard count through :meth:`AmrSim.from_snapshot`."""
        return super().dump(iout, base_dir, namelist_path=namelist_path,
                            ncpu=self.ndev if ncpu is None else ncpu,
                            dumper=dumper)

    def _slab_spec(self, lvl: int):
        """Slab decomposition of a complete level, or None when the level
        falls outside the slab envelope and keeps the single-device
        sweep."""
        from ramses_tpu_torch.parallel import dense_slab
        shape = (1 << lvl,) * self.cfg.ndim
        ncell_pad = self.maps[lvl].noct_pad * 2 ** self.cfg.ndim
        return dense_slab.build_slab_spec(
            self.devices, lvl, self.cfg.ndim, shape, ncell_pad,
            self.bc_kinds, halo_backend=self.params.amr.halo_backend)

    def _noct_pad(self, lvl: int, noct: int) -> int:
        """Bucketed oct count (with the base class's hysteresis) rounded to
        a multiple of the shard count, so the rows split evenly."""
        b = super()._noct_pad(lvl, noct)
        if b % self.ndev:
            b += self.ndev - (b % self.ndev)
            self._pad_hist[lvl] = b
        return b

    def _rebuild_maps(self, old_tree=None, old_maps=None, old_dev=None):
        """The base maps, plus each complete level's refined mask in flat
        row order (``ok_flat``): a shard cuts its own chunk of it."""
        super()._rebuild_maps(old_tree, old_maps, old_dev)
        for l, m in self.maps.items():
            if not m.complete:
                continue
            hit = self._ok_flat.get(l)
            if hit is None or hit[0] is not m:
                ok = (self._dev(m.ok_flat) if m.ok_flat is not None
                      else None)
                hit = self._ok_flat[l] = (m, ok)
            self.dev[l]["ok_flat"] = hit[1]
