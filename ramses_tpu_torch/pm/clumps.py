"""Clump finder: watershed peak-patch segmentation (PHEW).

The port's copy of ``ramses_tpu/pm/clumps.py`` (reference
``pm/clump_finder.f90``: ``count_peaks:428``, ``propagate_flag:499``,
``saddlepoint_search:524``; doc ``doc/wiki/PHEW.md``).  The labelling is
the device's O(N) work: each cell's steepest-ascent parent over its
periodic 3^ndim neighbourhood, followed to its fixed point, the density
peak.  On a CUDA tensor :func:`watershed` is one call of K10
(``csrc/watershed.cu``); on a CPU tensor it runs :func:`watershed_ref`,
the JAX package's rolls and pointer jumping.  The saddle merging and the
clump properties stay host numpy, as in the JAX package: peaks are few,
cells are many.

Labels are int64 flat indices.  The tests run the JAX package in x64, where
its ``jnp.asarray`` keeps the host deposit's float64: the port watersheds
the float64 deposit as it is.
"""

from __future__ import annotations

import ctypes
import itertools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ramses_tpu_torch.device import resolve_device

# K10 labellings since the count was last reset (the main path's proof that
# the clump pass went through the kernel)
launches = 0


def _neighbor_offsets(ndim: int):
    return [off for off in itertools.product((-1, 0, 1), repeat=ndim)
            if any(off)]


def steepest_parent(rho: torch.Tensor, ndim: int) -> torch.Tensor:
    """Flat index of the densest 3^ndim neighbour (self if local max),
    periodic; equal densities go to the larger flat index."""
    flat_idx = torch.arange(rho.numel(), device=rho.device).reshape(rho.shape)
    best_rho, best_idx = rho, flat_idx
    for off in _neighbor_offsets(ndim):
        r, i = rho, flat_idx
        for d, o in enumerate(off):
            if o:
                r = torch.roll(r, -o, dims=d)
                i = torch.roll(i, -o, dims=d)
        # strict ascent, with an index tie-break so equal-density plateaus
        # (e.g. a peak centred exactly on a cell face) drain to one cell
        take = (r > best_rho) | ((r == best_rho) & (i > best_idx))
        best_rho = torch.where(take, r, best_rho)
        best_idx = torch.where(take, i, best_idx)
    return best_idx


def _pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Iterate parent ← parent[parent] to the fixed point (peak labels)."""
    p = parent.reshape(-1)
    while True:
        p2 = p[p]
        if torch.equal(p2, p):
            return p2.reshape(parent.shape)
        p = p2


def watershed_ref(rho: torch.Tensor, threshold: float,
                  ndim: int) -> torch.Tensor:
    """The plain version of K10: the label of each cell, the flat index of
    its peak where ``rho > threshold``, else -1 (int64)."""
    labels = _pointer_jump(steepest_parent(rho, ndim))
    return torch.where(rho > threshold, labels, -1)


def watershed(rho, threshold: float, ndim: int) -> torch.Tensor:
    """:func:`watershed_ref`'s labels: on a CPU tensor the plain version, on
    a CUDA tensor (float64, the deposit's type) one K10 call (counted in
    :data:`launches`) or an exception."""
    rho = torch.as_tensor(rho)
    if rho.device.type == "cpu":
        return watershed_ref(rho, threshold, ndim)
    return _launch(rho, threshold, ndim)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("watershed"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/watershed.cu``."""
    fn = lib.ramses_watershed
    if fn.argtypes is None:
        for name in ("ramses_watershed", "ramses_watershed_wide"):
            getattr(lib, name).argtypes = _ARGTYPES
            getattr(lib, name).restype = ctypes.c_int
        lib.ramses_watershed_empty.argtypes = [ctypes.c_longlong,
                                               ctypes.c_void_p]
        lib.ramses_watershed_empty.restype = ctypes.c_int
    return lib


def _launch(rho: torch.Tensor, threshold: float, ndim: int) -> torch.Tensor:
    """One K10 call, counted in :data:`launches`; raises on what the kernel
    does not take and when the build or the launch fails."""
    global launches
    if rho.device.type != "cuda" or rho.dtype != torch.float64:
        raise ValueError(f"watershed: rho must be a float64 CUDA tensor, got "
                         f"{rho.dtype} on {rho.device}")
    rho = rho.contiguous()
    if not rho.numel():
        return call(None, rho, threshold, ndim)
    lib = _library()
    with torch.cuda.device(rho.device):
        out = call(lib, rho, threshold, ndim,
                   torch.cuda.current_stream(rho.device).cuda_stream)
    launches += 1
    return out


# cells from which K10 runs its 64-bit instantiation (int64 scratch and
# indices); below, 32-bit
WIDE_CELLS = 1 << 31


def call(lib, rho: torch.Tensor, threshold: float, ndim: int,
         stream=None, wide=None) -> torch.Tensor:
    """One call of ``ramses_watershed`` in the loaded build ``lib`` on a
    contiguous float64 ``rho`` of ``ndim`` (1 to 3) axes (the card's build
    on a CUDA tensor, or a host build of the source on a CPU one); returns
    the int64 labels and raises on the error the call returns.  No cells:
    nothing is called.  ``wide``: the 64-bit instantiation
    (``ramses_watershed_wide``); by default from :data:`WIDE_CELLS` cells
    on."""
    if ndim not in (1, 2, 3) or rho.dim() != ndim:
        raise ValueError(f"watershed: ndim {ndim} for a rho of shape "
                         f"{tuple(rho.shape)}")
    labels = torch.empty(rho.shape, dtype=torch.int64, device=rho.device)
    if not rho.numel():
        return labels
    if wide is None:
        wide = rho.numel() >= WIDE_CELLS
    # the kernel's scratch, a cell's pointer or its encoded root
    scratch = torch.empty(rho.shape, device=rho.device,
                          dtype=torch.int64 if wide else torch.int32)
    dims = list(rho.shape) + [1] * (3 - ndim)
    entry = lib.ramses_watershed_wide if wide else lib.ramses_watershed
    err = entry(rho.data_ptr(), *dims, ndim, float(threshold),
                scratch.data_ptr(), labels.data_ptr(), stream)
    if err:
        raise RuntimeError(f"watershed kernel launch failed (cudaError "
                           f"{err})")
    return labels


@dataclass
class Clump:
    """One clump's properties (``pm/clump_merger.f90``
    ``write_clump_properties`` columns)."""
    index: int
    peak_cell: Tuple[int, ...]
    peak_rho: float
    ncell: int
    mass: float
    pos: np.ndarray          # mass-weighted centre [ndim]
    relevance: float         # peak / max saddle
    # saddle-threshold halo membership (merge_clumps('saddleden')):
    # the surviving peak index of this clump's halo (= index when the
    # HOP-style halo pass is off or the clump is its own halo)
    parent: int = -1
    rho_min: float = 0.0
    rho_av: float = 0.0
    max_saddle: float = 0.0


def _saddles(rho, labels, ndim: int) -> Dict[Tuple[int, int], float]:
    """Max over faces of min(rho_a, rho_b) for neighbouring labels."""
    rho = np.asarray(rho)
    lab = np.asarray(labels)
    out: Dict[Tuple[int, int], float] = {}
    for d in range(ndim):
        la, lb = lab, np.roll(lab, -1, axis=d)
        ra, rb = rho, np.roll(rho, -1, axis=d)
        m = (la != lb) & (la >= 0) & (lb >= 0)
        if not m.any():
            continue
        key_a, key_b = la[m], lb[m]
        val = np.minimum(ra[m], rb[m])
        for a, b, v in zip(key_a, key_b, val):
            k = (min(a, b), max(a, b))
            if v > out.get(k, -np.inf):
                out[k] = v
    return out


def _merge_pass(rho, labels, ndim: int, action: str, thresh: float,
                density_threshold: float) -> np.ndarray:
    """Iterative peak merging to a fixed point — the two actions of
    ``merge_clumps`` (``pm/clump_merger.f90:560-640``):

    * ``'relevance'``: a peak whose relevance
      ``max_dens / max_saddle`` (``max_dens / density_threshold``
      when it has no saddle) is below ``thresh`` merges into the
      neighbour across its HIGHEST saddle;
    * ``'saddleden'``: a peak whose highest saddle density exceeds
      ``thresh`` merges the same way (the HOP-style halo grouping of
      ``saddle_threshold > 0`` cosmo runs).

    Both actions only move a peak into a DENSER partner (equal
    densities tie-break to the smaller index), exactly like the
    reference's ``max_dens(jpeak) > max_dens(ipeak)`` guard — the
    fixed point is therefore order-independent.
    """
    flat_rho = rho.reshape(-1)
    changed = True
    while changed:
        changed = False
        saddles = _saddles(rho, labels, ndim)
        best: Dict[int, Tuple[float, int]] = {}
        for (a, b), v in saddles.items():
            if v > best.get(a, (-np.inf, -1))[0]:
                best[a] = (v, b)
            if v > best.get(b, (-np.inf, -1))[0]:
                best[b] = (v, a)
        peaks = np.unique(labels[labels >= 0])
        peak_rho = {p: flat_rho[p] for p in peaks}
        # process the least dense peak first (deterministic; the fixed
        # point matches any order by the denser-partner guard)
        for p in sorted(peaks, key=lambda q: (peak_rho[q], q)):
            s, partner = best.get(p, (0.0, -1))
            if action == "relevance":
                denom = s if s > 0 else max(density_threshold, 1e-300)
                do = peak_rho[p] / denom < thresh
            else:
                do = s > thresh
            if not (do and partner >= 0):
                continue
            rp = peak_rho[partner]
            if rp > peak_rho[p] or (rp == peak_rho[p] and partner < p):
                labels[labels == p] = partner
                changed = True
                break
    return labels


def find_clumps(rho, threshold: float, relevance: float = 2.0,
                dx: float = 1.0, merge: bool = True,
                saddle_threshold: float = 0.0, device=None):
    """Full PHEW pass: watershed → relevance merge → properties
    [→ saddle-threshold halo grouping].

    ``saddle_threshold > 0`` additionally runs the HOP-style
    ``merge_clumps('saddleden')`` pass AFTER the clump properties are
    taken: clumps whose mutual saddle exceeds the threshold group into
    halos, recorded per clump as ``parent`` (the reference's two-level
    clump→halo hierarchy for cosmo runs).  Returns
    (labels [same shape, -1 outside], [Clump]) — with the halo pass,
    ``labels`` carries the HALO segmentation and each ``Clump.parent``
    names its halo peak.

    ``rho``: a tensor is labelled on its own device; a host array goes to
    ``device`` (the CUDA device unless the caller asks for the CPU) for the
    labelling.
    """
    if not torch.is_tensor(rho):
        rho = torch.as_tensor(np.asarray(rho), device=resolve_device(device))
    ndim = rho.dim()
    labels = watershed(rho, threshold, ndim).cpu().numpy()
    rho = rho.cpu().numpy()

    if merge:
        labels = _merge_pass(rho, labels, ndim, "relevance", relevance,
                             threshold)

    clumps: List[Clump] = []
    vol = dx ** ndim
    peaks = np.unique(labels[labels >= 0])
    saddles = _saddles(rho, labels, ndim)
    for p in peaks:
        m = labels == p
        cells = np.argwhere(m)
        rr = rho[m]
        mass = rr.sum() * vol
        pos = (cells * rr[:, None]).sum(0) / rr.sum()
        smax = max([v for (a, b), v in saddles.items()
                    if p in (a, b)] or [0.0])
        pk = np.unravel_index(p, rho.shape)
        clumps.append(Clump(
            index=int(p), peak_cell=tuple(int(c) for c in pk),
            peak_rho=float(rho.reshape(-1)[p]), ncell=int(m.sum()),
            mass=float(mass), pos=(pos + 0.5) * dx,
            relevance=float(rho.reshape(-1)[p] / max(smax, 1e-300)),
            parent=int(p), rho_min=float(rr.min()),
            rho_av=float(rr.mean()), max_saddle=float(smax)))

    if saddle_threshold > 0.0 and len(clumps) > 1:
        labels = _merge_pass(rho, labels, ndim, "saddleden",
                             saddle_threshold, threshold)
        flat = labels.reshape(-1)
        for c in clumps:
            # the halo this clump's peak cell ended up in
            c.parent = int(flat[c.index])

    clumps.sort(key=lambda c: -c.mass)
    return labels, clumps


def write_clump_table(clumps: List[Clump], path: str):
    """``output_clump``-style ascii table (the
    ``write_clump_properties`` column set incl. the halo parent and
    the rho min/av/max summary)."""
    with open(path, "w") as f:
        f.write("# index parent ncell peak_x peak_y peak_z rho- rho+ "
                "rho_av mass relevance\n")
        for c in clumps:
            pk = list(c.peak_cell) + [0] * (3 - len(c.peak_cell))
            f.write(f"{c.index:8d} {c.parent:8d} {c.ncell:8d} "
                    f"{pk[0]:6d} {pk[1]:6d} {pk[2]:6d} "
                    f"{c.rho_min:12.4e} {c.peak_rho:12.4e} "
                    f"{c.rho_av:12.4e} {c.mass:14.6e} "
                    f"{c.relevance:10.3f}\n")
