"""Halo finder + merger tree CLI over snapshot outputs.

The port's copy of ``ramses_tpu/utils/halos.py``.  The reference's halo
chain (``pm/clump_finder.f90`` → ``pm/unbinding.f90`` →
``pm/merger_tree.f90``) runs inside the simulation; the standalone analysis
equivalents live in ``utils/f90`` (``part2map``-family).  This CLI reads the
particle files of one or more ``output_NNNNN`` directories, deposits an NGP
density grid, runs the watershed clump finder (K10 on the CUDA device unless
``--device cpu``), unbinds, writes a halo table per output, and links
consecutive outputs into a merger tree.

CLI:  ``python -m ramses_tpu_torch.utils.halos output_00001 output_00002
      --nx 64 --threshold-over-mean 5 --tree tree.txt [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ramses_tpu_torch.io import reader as rdr
from ramses_tpu_torch.pm.clumps import find_clumps
from ramses_tpu_torch.pm.halo import (MergerTree, build_catalogue,
                                      write_halo_table)


def load_particles(outdir: str):
    """(x [n, ndim], v, m, ids, boxlen, t) from one output directory."""
    snap = rdr.load_snapshot(outdir)
    if "part" not in snap:
        raise FileNotFoundError(f"no particle files in {outdir}")
    ndim = snap["info"]["ndim"]
    boxlen = snap["amr"][0].header["boxlen"]
    t = snap["info"].get("time", 0.0)
    xs, vs, ms, ids = [], [], [], []
    for part in snap["part"]:
        n = len(part["mass"])
        if n == 0:
            continue
        xs.append(np.stack([part[f"position_{'xyz'[d]}"]
                            for d in range(ndim)], axis=1))
        vs.append(np.stack([part[f"velocity_{'xyz'[d]}"]
                            for d in range(ndim)], axis=1))
        ms.append(np.asarray(part["mass"]))
        ids.append(np.asarray(part["identity"], dtype=np.int64))
    if not xs:
        raise ValueError(f"{outdir}: particle files are empty")
    return (np.concatenate(xs), np.concatenate(vs), np.concatenate(ms),
            np.concatenate(ids), float(boxlen), float(t))


def catalogue_from_arrays(x, v, m, ids, boxlen, nx: int = 64,
                          threshold: float = -1.0,
                          threshold_over_mean: float = 5.0,
                          relevance: float = 1.5, G: float = 1.0,
                          npart_min: int = 10, unbind: bool = True,
                          saddle_pot: bool = False, nmassbins: int = 0,
                          saddle_threshold: float = 0.0, device=None):
    """PHEW chain on in-memory particle arrays: deposit → watershed →
    unbind.  Shared by the offline CLI and the in-run
    ``clumpfind=.true.`` pass.  ``threshold``: absolute density
    threshold in code units (<0 → ``threshold_over_mean`` × mean).
    The deposit is host numpy; the grid goes to ``device`` (the CUDA
    device unless the caller asks for the CPU) for the labelling."""
    nd = x.shape[1]
    dx = boxlen / nx
    idx = tuple(np.clip((np.mod(x[:, d], boxlen) / dx).astype(int),
                        0, nx - 1) for d in range(nd))
    rho = np.zeros((nx,) * nd)
    np.add.at(rho, idx, m / dx ** nd)
    thr = (float(threshold) if threshold > 0
           else float(rho.mean()) * threshold_over_mean)
    labels, _ = find_clumps(rho, thr, relevance=relevance, dx=dx,
                            saddle_threshold=saddle_threshold, device=device)
    pl = np.asarray(labels)[idx]        # NGP labels, one gather
    return build_catalogue(x, v, m, ids, pl, boxlen, G=G,
                           unbind=unbind, npart_min=npart_min,
                           saddle_pot=saddle_pot, nmassbins=nmassbins)


def catalogue_output(outdir: str, nx: int = 64,
                     threshold_over_mean: float = 5.0,
                     relevance: float = 1.5, G: float = 1.0,
                     npart_min: int = 10, unbind: bool = True,
                     saddle_pot: bool = False, nmassbins: int = 0,
                     device=None):
    """Full chain on one output directory; returns (halos, t)."""
    x, v, m, ids, boxlen, t = load_particles(outdir)
    return catalogue_from_arrays(
        x, v, m, ids, boxlen, nx=nx,
        threshold_over_mean=threshold_over_mean, relevance=relevance,
        G=G, npart_min=npart_min, unbind=unbind,
        saddle_pot=saddle_pot, nmassbins=nmassbins, device=device), t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ramses_tpu_torch.utils.halos")
    ap.add_argument("outdirs", nargs="+",
                    help="output_NNNNN directories, time-ordered")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--threshold-over-mean", type=float, default=5.0)
    ap.add_argument("--relevance", type=float, default=1.5)
    ap.add_argument("--npart-min", type=int, default=10)
    ap.add_argument("--no-unbind", action="store_true")
    ap.add_argument("--saddle-pot", action="store_true",
                    help="reference binding energies to the clump "
                         "boundary potential (unbinding.f90 saddle_pot)")
    ap.add_argument("--nmassbins", type=int, default=0,
                    help="binned mass-profile potential with N radial "
                         "bins (0 = exact per-particle monopole)")
    ap.add_argument("--nmost-bound", type=int, default=0,
                    help="merger-tree tracers per halo (0 = all bound; "
                         "merger_tree.f90 nmost_bound)")
    ap.add_argument("--max-gap", type=int, default=2,
                    help="snapshots a vanished progenitor stays "
                         "linkable across (merger_tree.f90 jumpers)")
    ap.add_argument("--tree", default=None,
                    help="merger-tree table path (needs >=2 outputs)")
    ap.add_argument("--device", default=None,
                    help="where the watershed runs: the CUDA device by "
                         "default, 'cpu' for its plain version")
    args = ap.parse_args(argv)

    tree = MergerTree(max_gap=args.max_gap,
                      nmost_bound=args.nmost_bound)
    for outdir in args.outdirs:
        halos, t = catalogue_output(
            outdir, nx=args.nx,
            threshold_over_mean=args.threshold_over_mean,
            relevance=args.relevance, npart_min=args.npart_min,
            unbind=not args.no_unbind, saddle_pot=args.saddle_pot,
            nmassbins=args.nmassbins, device=args.device)
        table = os.path.join(outdir, "halos.txt")
        write_halo_table(halos, table)
        print(f"{outdir}: {len(halos)} halos -> {table}"
              + (f" (max mass {halos[0].mass:.4e})" if halos else ""))
        tree.add_snapshot(t, halos)
    if args.tree and len(args.outdirs) >= 2:
        tree.write(args.tree)
        nlink = sum(len(ls) for _s, ls in tree.links)
        print(f"merger tree: {nlink} links -> {args.tree}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
