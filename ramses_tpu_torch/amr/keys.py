"""Integer Morton (Z-order) keys for oct coordinates.

The port's own copy of ``ramses_tpu/amr/keys.py`` (numpy only; the
optional native encoder of the JAX package is not carried over).

Replaces the reference's Hilbert state-machine keys (``amr/hilbert.f90:5-196``)
for *topology bookkeeping*: the tree only needs a total order with fast
encode/decode and uniqueness, which bit-interleaved int64 Morton codes give
without the reference's ``real*16 QUADHILBERT`` workaround (its level cap —
19 in 3D — came from squeezing keys into floats; int64 Morton supports 21
bits/dim in 3D).  Hilbert ordering still matters for *domain decomposition*
locality and is provided separately (``parallel/``); within a single host the
sorted Morton array is the whole "tree": membership = ``searchsorted``.
"""

from __future__ import annotations

import numpy as np


def _spread2(x: np.ndarray) -> np.ndarray:
    """Spread bits of x (< 2^31) with 1 zero between (2D interleave)."""
    x = x.astype(np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _spread3(x: np.ndarray) -> np.ndarray:
    """Spread bits of x (< 2^21) with 2 zeros between (3D interleave)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def encode(ig: np.ndarray, ndim: int) -> np.ndarray:
    """Morton keys (int64) from integer coords ``ig [n, ndim]``."""
    ig = np.asarray(ig)
    if ndim == 1:
        return ig[:, 0].astype(np.int64)
    if ndim == 2:
        return (_spread2(ig[:, 0]) | (_spread2(ig[:, 1]) << np.uint64(1))
                ).astype(np.int64)
    return (_spread3(ig[:, 0]) | (_spread3(ig[:, 1]) << np.uint64(1))
            | (_spread3(ig[:, 2]) << np.uint64(2))).astype(np.int64)


def _compact2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def _compact3(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1249249249249249)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return x


def decode(keys: np.ndarray, ndim: int) -> np.ndarray:
    """Integer coords ``[n, ndim]`` from Morton keys."""
    k = np.asarray(keys).astype(np.uint64)
    if ndim == 1:
        return k.astype(np.int64)[:, None]
    if ndim == 2:
        return np.stack([_compact2(k), _compact2(k >> np.uint64(1))],
                        axis=1).astype(np.int64)
    return np.stack([_compact3(k), _compact3(k >> np.uint64(1)),
                     _compact3(k >> np.uint64(2))], axis=1).astype(np.int64)
