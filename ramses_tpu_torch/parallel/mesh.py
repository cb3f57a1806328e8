"""Shard meshes for the slab-sharded paths (PyTorch).

Port of ``ramses_tpu/parallel/mesh.py``'s ``factorize`` and of the 1-D
meshes the explicit slab paths run on (``oct_mesh``, axis ``"oct"``;
``halo.make_halo_mesh``, axis ``"hx"``).  A :class:`ShardMesh` is an
ordered tuple of devices, one per shard: shard ``s`` owns its own tensors
on ``devices[s]``.  Entries may repeat one card, as the JAX package's tests
run 8 virtual devices on one CPU; the default is every visible CUDA card,
as ``jax.devices()`` is.

In this port all shards of a mesh live on one device.  A mesh whose shards
span several cards is refused with ``NotImplementedError`` (a ring across
cards, over NVLink peer access or NCCL, is ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ramses_tpu_torch.device import resolve_device


def factorize(n: int, ndim: int) -> Tuple[int, ...]:
    """Split n devices into an ndim mesh shape, most-balanced first (the
    smallest sum of cross-sections, so the least halo bytes)."""
    best: Tuple[int, ...] = (n,) + (1,) * (ndim - 1)
    best_cost = None

    def rec(rem: int, dims: List[int]):
        nonlocal best, best_cost
        if len(dims) == ndim - 1:
            dims = dims + [rem]
            cost = sum(np.prod(dims) / d for d in dims)
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = tuple(sorted(dims, reverse=True))
            return
        d = 1
        while d <= rem:
            if rem % d == 0:
                rec(rem // d, dims + [d])
            d += 1

    rec(n, [])
    return best


def _visible_cards() -> list:
    resolve_device("cuda")                 # raises without a GPU
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class ShardMesh:
    """An ordered tuple of shard devices (``None``: every visible card)."""
    devices: Tuple[torch.device, ...]

    def __init__(self, devices: Sequence = None):
        devs = _visible_cards() if devices is None else list(devices)
        if not devs:
            raise ValueError("a shard mesh needs at least one shard")
        devs = [resolve_device(d) for d in devs]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"a shard mesh over {sorted(set(map(str, devs)))}: rings "
                "across several cards are not ported yet (ROADMAP A8); "
                "put every shard on one device")
        object.__setattr__(self, "devices", tuple(devs))

    @property
    def ndev(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]

    def shard(self, u, axis: int, dtype=None) -> List[torch.Tensor]:
        """``u`` (tensor or numpy) cut into ``ndev`` equal contiguous
        pieces along ``axis``, each a tensor of its own on its shard's
        device (copies)."""
        u = u if torch.is_tensor(u) else torch.from_numpy(np.array(u))
        if u.shape[axis] % self.ndev:
            raise ValueError(f"axis {axis} of {tuple(u.shape)} does not "
                             f"divide into {self.ndev} shards")
        return [p.to(device=d, dtype=dtype or p.dtype,
                     memory_format=torch.contiguous_format, copy=True)
                for p, d in zip(torch.chunk(u, self.ndev, dim=axis),
                                self.devices)]

    @staticmethod
    def gather(shards: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
        """The global view: the shards concatenated along ``axis``."""
        return torch.cat(list(shards), dim=axis)
