"""Command-line entry point: ``python -m ramses_tpu_torch run.nml``.

Runs a namelist on the GPU (``--device cpu`` for the CPU): hydro (with
self-gravity under ``&RUN_PARAMS poisson``), or with ``--solver mhd`` (the
default when &INIT_PARAMS sets a region field, as in the JAX CLI)
constrained-transport MHD, each on a uniform grid or, with ``levelmax >
levelmin``, on the AMR hierarchy of one device.
Prints one line per chunk of steps (per coarse step on the hierarchy) and
the final conservation totals; MHD on the hierarchy closes with the JAX
CLI's ``mhd-amr t=… nstep=… max|divB|/max|B|*dx=…`` line.  Snapshot output
is not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ramses_tpu_torch",
        description="PyTorch/CUDA port of ramses_tpu (hydro with gravity "
                    "and CT MHD, uniform or AMR on one device)")
    ap.add_argument("namelist", help="Fortran-namelist runtime config")
    ap.add_argument("--ndim", type=int, default=3,
                    help="spatial dimensions (compile-time in the reference)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default cuda; a run without a GPU must ask for "
                         "the CPU")
    ap.add_argument("--solver", default=None, choices=["hydro", "mhd"],
                    help="default: mhd when &INIT_PARAMS sets A/B/C_region, "
                         "else hydro")
    args = ap.parse_args(argv)

    import torch

    from ramses_tpu_torch.driver import run_namelist

    sim = run_namelist(args.namelist, ndim=args.ndim,
                       dtype=getattr(torch, args.dtype), verbose=True,
                       device=args.device, solver=args.solver)
    tot = sim.totals()
    mom = ", ".join(f"{float(m):.9e}" for m in tot["momentum"])
    print(f"totals: t={sim.t:.6e} nstep={sim.nstep} "
          f"mass={float(tot['mass']):.9e} momentum=[{mom}] "
          f"energy={float(tot['energy']):.9e} {sim.status_note()} "
          f"device={sim.device}")
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    if isinstance(sim, MhdAmrSim):
        print(f"mhd-amr t={sim.t:.5e} nstep={sim.nstep} "
              f"max|divB|/max|B|*dx={sim.max_divb():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
