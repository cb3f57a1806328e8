"""Flat↔dense conversion of COMPLETE cubic levels (PyTorch).

Port of ``ramses_tpu/amr/bitperm.py`` (``flat_index_np``, ``flat_to_dense``,
``dense_to_flat``).  A complete level's flat row order is (sorted-Morton oct
index) × (cell offset), a fixed bit permutation of the dense C-order ravel
index::

    flat bits (MSB→LSB):  [z_{l-1} y_{l-1} x_{l-1}] … [z_1 y_1 x_1] [x_0 y_0 z_0]
    dense bits (MSB→LSB): [x_{l-1} … x_0] [y_{l-1} … y_0] [z_{l-1} … z_0]

The JAX package moves the rows with a reshape to one axis per bit and a
transpose.  In 3D at level 7 that is a 22-dimensional permute (21 bit axes
and the variables), at level 9 a 28-dimensional one, past the 25 dimensions
PyTorch's TensorIterator indexes.  The port gathers instead: the
permutation is built once per (level, ndim, device) on the host by
:func:`flat_index_np` and kept on the device, and one ``index_select`` moves
each row once, whatever the level.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

_INDEX: Dict[Tuple[int, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


@lru_cache(maxsize=None)
def _bit_seq(lvl: int, ndim: int) -> tuple:
    """The flat index's bit slots MSB→LSB as (axis, coord_bit) pairs: oct
    Morton triplets (z most significant) then the within-oct offset (x
    slowest)."""
    seq = [(d, i) for i in range(lvl - 1, 0, -1)
           for d in range(ndim - 1, -1, -1)]
    seq += [(d, 0) for d in range(ndim)]
    return tuple(seq)


def flat_index_np(coords, lvl: int, ndim: int) -> np.ndarray:
    """Flat row index of dense cell coordinates ``coords [..., ndim]``
    (values in ``[0, 2^lvl)``); int64 of shape ``coords.shape[:-1]``."""
    coords = np.asarray(coords)
    seq = _bit_seq(lvl, ndim)
    nb = len(seq)
    flat = np.zeros(coords.shape[:-1], dtype=np.int64)
    for p, (d, i) in enumerate(seq):
        flat |= ((coords[..., d].astype(np.int64) >> i) & 1) << (nb - 1 - p)
    return flat


def indices(lvl: int, ndim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows_of_dense, dense_of_rows)`` int64 on ``device``: the flat row
    of each dense C-order cell, and its inverse (the dense index of each
    flat row).  Built once per (level, ndim, device)."""
    key = (lvl, ndim, str(torch.device(device)))
    hit = _INDEX.get(key)
    if hit is None:
        n = 1 << lvl
        coords = np.indices((n,) * ndim).reshape(ndim, -1).T
        rows = flat_index_np(coords, lvl, ndim)
        dense = np.empty_like(rows)
        dense[rows] = np.arange(len(rows))
        hit = (torch.from_numpy(rows).to(device),
               torch.from_numpy(dense).to(device))
        _INDEX[key] = hit
    return hit


def flat_to_dense(rows: torch.Tensor, lvl: int, ndim: int) -> torch.Tensor:
    """``[ncell(+pad), *trailing]`` flat-order rows → dense
    ``(2^lvl,)*ndim + trailing`` (pad rows dropped)."""
    idx, _ = indices(lvl, ndim, rows.device)
    return rows.index_select(0, idx).reshape(
        (1 << lvl,) * ndim + tuple(rows.shape[1:]))


def dense_to_flat(dense: torch.Tensor, lvl: int, ndim: int) -> torch.Tensor:
    """Dense ``(2^lvl,)*ndim + trailing`` → ``[ncell, *trailing]`` flat-order
    rows (inverse of :func:`flat_to_dense`)."""
    _, idx = indices(lvl, ndim, dense.device)
    ncell = 1 << (lvl * ndim)
    return dense.reshape((ncell,) + tuple(dense.shape[ndim:])).index_select(
        0, idx)
