"""Command-line entry point: ``python -m ramses_tpu_torch run.nml``.

Runs a namelist on the GPU (``--device cpu`` for the CPU): hydro (with
self-gravity under ``&RUN_PARAMS poisson``, particles under ``pic``, the
supercomoving clock and the grafic/Gadget ICs under ``cosmo``, as
``namelists/cosmo.nml``), or with ``--solver mhd`` (the
default when &INIT_PARAMS sets a region field, as in the JAX CLI)
constrained-transport MHD, each on a uniform grid or, with ``levelmax >
levelmin``, on the AMR hierarchy of one device.

Writes the snapshots the JAX CLI writes into ``&OUTPUT_PARAMS
output_dir``: the uniform hydro driver a reference-format
``output_NNNNN/`` at each output time, the other drivers
``output_00001/`` at the end.  Every run goes through the supervisor,
which restores ``output_<nrestart>`` (``&RUN_PARAMS nrestart``) or, with
``--auto-resume`` (``auto_resume``, ``nrestart=-1``), the newest
manifest-valid checkpoint; ``--max-attempts N`` resumes an interrupted
attempt from the newest one.  SIGTERM/SIGINT or a ``stop_run`` file in the
output directory dump an emergency snapshot (``output_00900`` on) and
stop; SIGUSR1 dumps one and carries on; ``--walltime`` stops in time.

Prints one line per chunk of steps (per coarse step on the hierarchy) and
the final conservation totals; MHD on the hierarchy closes with the JAX
CLI's ``mhd-amr t=… nstep=… max|divB|/max|B|*dx=…`` line, a cosmological
hierarchy prints its ``cosmo-amr aexp=… nstep=… octs=[…]`` line before
the dump.
"""

from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ramses_tpu_torch",
        description="PyTorch/CUDA port of ramses_tpu (hydro with gravity, "
                    "particles and cosmology, and CT MHD, uniform or AMR "
                    "on one device)")
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
    ap.add_argument("--walltime", type=float, default=None,
                    help="wall-clock budget in hours; the watchdog dumps "
                         "a restartable snapshot and stops before it "
                         "expires (amr/adaptive_loop.f90:216-226)")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from the newest manifest-valid "
                         "checkpoint in the output dir (same as "
                         "&RUN_PARAMS auto_resume=.true.)")
    ap.add_argument("--max-attempts", type=int, default=1,
                    help="supervised retry-with-resume: on an "
                         "interrupted or failed run, rebuild from the "
                         "latest valid checkpoint and continue, up to "
                         "this many attempts (exponential backoff)")
    return ap


def run_cli(argv=None):
    """Run a namelist as the CLI does and return the final sim: each
    attempt under an :class:`ramses_tpu_torch.utils.ops.OpsGuard` (which
    installs its signal handlers), through the supervisor, writing the
    snapshots the JAX CLI writes."""
    args = _parser().parse_args(argv)

    import torch

    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import (Simulation, build_namelist_sim,
                                         evolve_namelist, namelist_driver,
                                         supervise_namelist)
    from ramses_tpu_torch.utils.ops import OpsGuard

    params = load_params(args.namelist, ndim=args.ndim)
    if args.auto_resume:
        params.run.auto_resume = True
    dtype = getattr(torch, args.dtype)
    cls, tend = namelist_driver(params, args.solver)
    base = params.output.output_dir

    def make_guard(sim):
        return OpsGuard(sim, base, walltime_s=(args.walltime * 3600.0
                                               if args.walltime else None))

    def build(restart):
        sim = build_namelist_sim(cls, params, restart, dtype, args.device)
        if cls is Simulation:
            # the uniform hydro driver dumps at each output time
            sim.on_output = lambda s, i: s.dump(
                i, namelist_path=args.namelist)
        return sim

    def drive(sim):
        guard = make_guard(sim)
        guard.run_guarded(lambda: evolve_namelist(sim, params, tend,
                                                  verbose=True, guard=guard))

    sim = supervise_namelist(params, build, drive,
                             max_attempts=args.max_attempts, tend=tend)
    if getattr(sim, "cosmo", None) is not None and cls is not Simulation:
        print(sim.cosmo_line())
    if cls is not Simulation:
        sim.dump(1, base, namelist_path=args.namelist)
    return sim


def main(argv=None) -> int:
    sim = run_cli(argv)
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
    from ramses_tpu_torch.resilience.watchdog import (HANG_EXIT_CODE,
                                                      HangDetected)
    try:
        sys.exit(main())
    except HangDetected as e:
        # hang budget exhausted: exit with the dedicated status so a
        # parent (a batch system, a subprocess capture) classifies hang
        # vs crash without parsing logs
        print(f"ramses_tpu_torch: unrecoverable hang: {e}", file=sys.stderr)
        sys.exit(HANG_EXIT_CODE)
