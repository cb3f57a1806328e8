"""Time K8 (the M1 transport) and K6 (the cooling solve) of two trees of the
port on one card, in turns.

    python tools/kernel_turns.py OTHER_TREE [--reps N] [--out FILE]

``OTHER_TREE`` is another checkout of the repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The script runs four child processes, the other
tree, this tree, this tree, the other tree, each importing
``ramses_tpu_torch`` from its own tree (and building its kernels there),
and each timing the same work made from the same seeds through entry points
both trees have:

* ``k8_dense_ms``: K8's dense entry (``m1.transport``) on a random 128³
  one-group f64 state with a source field (phase 58's shape), device ms a
  launch from CUDA events around 50 launches;
* ``k8_block_ms``: K8's block entry (``m1.block_update``) on 65,536
  random gathered 3D oct stencils, one group;
* ``k6_march_ms``: K6's march (``cooling.solve_cooling``) on the march
  inputs of phase 50's state (sedov3d at 256³, f32, ISM units, with
  cooling, after 5 steps), device ms a launch;
* ``cooling_step_ms``: ``cooling.cooling_step`` on that state, ms a call
  (CUDA events around 20 calls: the conversions and the march, or the
  fused entry);
* ``cool_step_ms``: ``run_steps_cool`` on that state, ms a step (phase 50's
  step: K1, then the cooling pass), a synchronised wall over 20 steps;
* ``rt_substep_ms``: ``stromgren3.nml`` at 128³ (phase 58), the RT
  advance of 40 substeps (K8 and K9 each), ms a substep, a synchronised
  wall.

Each child prints the card's name and power limit (``nvidia-smi``) and one
JSON line; the parent prints a table of the four turns and writes them to
``--out`` (default ``chiprun_out/kernel_turns.json``).  Each child also
prints ``nvcc``'s ``-Xptxas -v`` report of ``csrc/rt_m1.cu`` and
``csrc/cooling.cu`` when it builds them.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
RT_SHAPE = (128, 128, 128)     # K8's dense entry (phase 58's grid)
NOCT = 65536                   # K8's block entry
COOL_LEVEL = 8                 # phase 50: sedov3d at 256³
RT_LEVEL = 7                   # phase 58: stromgren3 at 128³


def _events_ms(fn, n: int) -> float:
    """Device ms a call of ``fn``: CUDA events around ``n`` calls after a
    warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _wall_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _rt_state(shape, c_red, seed):
    """A random one-group RT state [1, 1+3, *shape] with N over 25 decades,
    |F| up to 1.2 c_red N, and a source on a tenth of the cells."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    N = 10.0 ** rng.uniform(-30, -5, (1,) + shape)
    F = rng.standard_normal((1, 3) + shape)
    F *= 1.2 * c_red * N[:, None] * rng.random((1, 1) + shape) / \
        np.sqrt((F ** 2).sum(axis=1, keepdims=True))
    src = np.where(rng.random((1,) + shape) < 0.1,
                   10.0 ** rng.uniform(-20, -15, (1,) + shape), 0.0)
    return (torch.from_numpy(np.concatenate([N[:, None], F], axis=1)),
            torch.from_numpy(src))


def _with_levels(path: str, lvl: int, extra: str = "") -> str:
    text = open(path).read()
    for key in ("levelmin", "levelmax"):
        text = re.sub(rf"{key}=\d+", f"{key}={lvl}", text)
    return text + extra


def child(reps: int) -> dict:
    """The timings of this process's tree (the tree ``ramses_tpu_torch``
    is imported from)."""
    import torch
    from ramses_tpu_torch import kernels
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.grid.uniform import run_steps_cool
    from ramses_tpu_torch.hydro import cooling as pc
    from ramses_tpu_torch.rt import m1
    logs = kernels.build(["rt_m1", "cooling", "rt_chem", "fused_muscl"])
    for name in ("rt_m1", "cooling"):
        for line in logs.get(name, "").splitlines():
            if ("Used" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"{name}: {line.strip()}")
    dev = torch.device(DEVICE)
    out = {"tree": os.path.dirname(os.path.dirname(kernels.__file__))}
    # K8
    c_red = 3e7
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    U, src = [t.to(dev) for t in _rt_state(RT_SHAPE, c_red, 1)]
    out["k8_dense_ms"] = _events_ms(
        lambda: m1.transport(U, dt, dx, c_red, 3, True, src), reps)
    ref = m1.transport_ref(U, dt, dx, c_red, 3, True, src)
    out["k8_dense_max_abs_err"] = float(
        (m1.transport(U, dt, dx, c_red, 3, True, src) - ref).abs().max())
    del U, src, ref
    blkU, _ = _rt_state((6, 6, 6, NOCT), c_red, 2)
    blk = blkU.reshape(4, 6, 6, 6, NOCT).contiguous().to(dev)
    rad = torch.zeros((NOCT * 8, 4), dtype=torch.float64, device=dev)
    out["k8_block_ms"] = _events_ms(
        lambda: m1.block_update(rad, blk, dt, dx, c_red, 3, 1), reps)
    del blk, blkU, rad
    # K6 on phase 50's state
    units = ("\n&UNITS_PARAMS\nunits_density=1.66e-24\nunits_time=3.15e13\n"
             "units_length=3.08e18\n/\n&COOLING_PARAMS\ncooling=.true.\n/\n")
    text = _with_levels(os.path.join(HERE, "namelists", "sedov3d.nml"),
                        COOL_LEVEL, units).replace("tout=1.0", "tout=100.0")
    sim = Simulation(params_from_string(text, ndim=3))
    f64 = dict(dtype=torch.float64, device=dev)
    t0, tend = torch.tensor(0.0, **f64), torch.tensor(1e30, **f64)
    tabs, spec, cfg = sim.cool_tables, sim.cool_spec, sim.cfg
    u, t, _ = run_steps_cool(sim.grid, sim.state.u, t0, tend, 5, tabs, spec)
    dtc = torch.tensor(1e-3, dtype=u.dtype, device=dev)
    out["cooling_step_ms"] = _events_ms(
        lambda: pc.cooling_step(u, tabs, spec, dtc, cfg), 20)
    # the march inputs as cooling_step forms them
    rho = torch.clamp(u[0], min=cfg.smallr)
    ekin = sum(0.5 * u[1 + d] ** 2 for d in range(3)) / rho
    T2 = torch.clamp((cfg.gamma - 1.0) * (u[4] - ekin) / rho
                     * spec.scale_T2, min=pc.T2_MIN)
    nH = rho * spec.scale_nH
    dts = dtc * spec.scale_t
    out["k6_march_ms"] = _events_ms(
        lambda: pc.solve_cooling(tabs, nH, T2, spec.z_ave, 1.0, dts), 20)
    out["cool_step_ms"] = _wall_ms(
        lambda: run_steps_cool(sim.grid, u, t, tend, 20, tabs, spec), 20)
    del sim, u, rho, ekin, T2, nH
    torch.cuda.empty_cache()
    # phase 58's substeps
    text = _with_levels(os.path.join(HERE, "namelists", "stromgren3.nml"),
                        RT_LEVEL)
    sim = Simulation(params_from_string(text, ndim=3))
    rs = sim.rt.sim
    sub = m1.rt_courant_dt(rs.dx, rs.spec.c_red, rs.spec.courant)
    out["rt_substep_ms"] = _wall_ms(lambda: rs.advance(40 * sub), 40)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "kernel_turns.json"))
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        import torch
        if not torch.cuda.is_available():
            print("kernel_turns: needs a CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(child(a.reps)))
        return 0
    if not a.other:
        ap.error("the other tree is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    other = os.path.abspath(a.other)
    turns = []
    for label, tree in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--reps", str(a.reps)], cwd=tree, env=env,
            capture_output=True, text=True, timeout=1800)
        sys.stdout.write(proc.stdout[:-1] if proc.stdout else "")
        print()
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["turn"] = label
        turns.append(r)
    keys = [k for k in turns[0] if k.endswith("_ms")]
    print(f"turns on {card} (other, this, this, other):")
    for k in keys:
        print(f"  {k}: " + ", ".join(f"{t[k]:.4f}" for t in turns))
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
