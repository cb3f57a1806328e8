"""Time K8 (the M1 transport), K6 (the cooling solve), K7 (the regrid maps)
and K10 (the watershed) of two trees of the port on one card, in turns.

    python tools/kernel_turns.py OTHER_TREE [--reps N] [--only GROUPS]
                                            [--out FILE]

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
  wall;
* ``k7_level_ms``: K7 (``device_regrid.regrid_maps``) on a 3D key set
  shaped like config 2's largest regrid level: the 2,000 level-9 octs of a
  spherical shell (radius 12.5 to 13.5 lvl-8 cells about the box centre),
  padded to 2,048; the old level the shell half a cell further in; the
  coarse level every father and the level-8 shell from 5.5 to 7.5 cells;
  periodic; device ms a call from the profiler (K7's kernel);
* ``k7_random3d_ms``, ``k7_random2d_ms``: K7 on phase 55's random sorted
  key sets of 262,144 octs (3D at level 8, 2D at level 11, periodic);
* ``k10_64_ms``, ``k10_256_ms``, ``k10_plateau_ms``, ``k10_smooth_ms``:
  K10 (``clumps.watershed``) on phase 61's fields (random 64³ and 256³,
  plateau 256³, smooth 128³, the same seeds) at phase 61's timed threshold
  (the median less 1e-9); device ms a call from the profiler, both of its
  kernels.

``--only`` takes a comma list of the groups ``k8``, ``k6`` (with
``rt_substep_ms``), ``k7`` and ``k10`` (default: all).  Each child prints
the card's name and power limit (``nvidia-smi``) and one JSON line; the
parent prints a table of the four turns and writes them to ``--out``
(default ``chiprun_out/kernel_turns.json``).  Each child also prints
``nvcc``'s ``-Xptxas -v`` report of the sources of its groups' kernels
when it builds them.  Needs one CUDA device.
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
K7_RANDOM_OCTS = 262144        # phase 55's random key sets
# phase 61's fields (kind, shape, seed) at the entries' names
K10_FIELDS = {"k10_64_ms": ("random", (64, 64, 64), 61),
              "k10_256_ms": ("random", (256, 256, 256), 63),
              "k10_plateau_ms": ("plateau", (256, 256, 256), 65),
              "k10_smooth_ms": ("smooth", (128, 128, 128), 66)}
GROUPS = ("k8", "k6", "k7", "k10")
SOURCES = {"k8": ("rt_m1",),
           "k6": ("cooling", "rt_chem", "rt_m1", "fused_muscl"),
           "k7": ("regrid_maps",), "k10": ("watershed",)}


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


def _profiled_ms(fn, names, n: int, tries: int = 5) -> float:
    """Device ms a call of ``fn``: the profiler's device time of each
    kernel whose name holds one of ``names``, over its launches seen in a
    window of ``n`` calls after a warm-up (the window opens with 20 small
    kernels, since a trace may drop the records of its first launches).  A
    window that lost the records of a kernel (seen on an H100: every
    record of a window) is traced again, up to ``tries`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    lead = torch.zeros(16, device=DEVICE)
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                lead.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(k in e.key for k in names)]
        if len(rows) == len(names) and all(e.count >= n // 2 for e in rows):
            return sum(e.self_device_time_total / e.count
                       for e in rows) / 1e3
        seen.append([(e.key, e.count) for e in rows])
    raise RuntimeError(f"the traces hold {seen} for {names} over {n} calls")


def _k7_level_keys():
    """K7's inputs shaped like config 2's largest regrid level (3D, lvl 9):
    the sorted keys of a shell of octs, of the shell half a cell further in,
    and of the coarse shell with every father; sentinel-padded."""
    import numpy as np
    from ramses_tpu_torch.amr import keys as kmod

    def shell(side, r0, r1):
        c = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        d = np.sqrt(((c + 0.5 - side / 2) ** 2).sum(axis=1))
        return np.unique(kmod.encode(c[(d >= r0) & (d < r1)], 3))
    new = shell(256, 12.5, 13.5)
    old = shell(256, 12.0, 13.0)
    coarse = np.union1d(new >> 3, shell(128, 5.5, 7.5))
    return new, old, coarse, (256,) * 3, 2048


def _k7_key_set(ndim: int, lvl: int, n: int, seed: int):
    """Phase 55's random regrid (``chip_smoke._k7_key_set``): ``n`` new
    octs among level ``lvl``'s slots of a cubic box, an old level that kept
    80 % of them and gained a fifth as many others, a coarser level holding
    every father and a fifth as many others."""
    import numpy as np
    from ramses_tpu_torch.amr import keys as kmod
    rng = np.random.default_rng(seed)
    side = 1 << (lvl - 1)

    def keys_of(flat, s):
        c = np.stack(np.unravel_index(flat, (s,) * ndim), axis=1)
        return np.unique(kmod.encode(c, ndim))
    new = keys_of(rng.choice(side ** ndim, n, replace=False), side)
    old = np.unique(np.concatenate([
        new[rng.random(n) < 0.8],
        keys_of(rng.choice(side ** ndim, n // 5, replace=False), side)]))
    coarse = np.unique(np.concatenate([
        new >> ndim,
        keys_of(rng.choice((side // 2) ** ndim, n // 5, replace=False),
                side // 2)]))
    return new, old, coarse, (side,) * ndim


def _k10_field(kind: str, shape, seed: int):
    """Phase 61's density (``chip_smoke._k10_field``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape)
    if kind == "plateau":
        return np.floor(rng.random(shape) * 4.0) / 4.0
    axes = [(np.arange(n) + 0.5) / n for n in shape]
    rho = np.full(shape, 0.01)
    for _ in range(4):
        c = rng.random(len(shape))
        r2 = np.zeros(shape)
        for d, (g, ci) in enumerate(zip(axes, c)):
            dd = np.abs(g - ci)
            dd = np.minimum(dd, 1.0 - dd) ** 2
            r2 = r2 + dd.reshape([-1 if e == d else 1
                                  for e in range(len(shape))])
        rho += rng.uniform(1.0, 5.0) * np.exp(-r2 / (2 * 0.08 ** 2))
    return rho


def _k7_entries(out: dict, reps: int, dev):
    """``k7_level_ms``, ``k7_random3d_ms``, ``k7_random2d_ms``; each call
    also checked bitwise against the plain version."""
    import torch
    from ramses_tpu_torch.amr import device_regrid as dr
    new, old, coarse, dims, pad = _k7_level_keys()
    sets = {"k7_level_ms": (new, old, coarse, dims, 3, pad)}
    for name, nd, lvl in (("k7_random3d_ms", 3, 8), ("k7_random2d_ms", 2,
                                                       11)):
        new, old, coarse, dims = _k7_key_set(nd, lvl, K7_RANDOM_OCTS, 60 + nd)
        sets[name] = (new, old, coarse, dims, nd, len(new) + 4096)
    for name, (new, old, coarse, dims, nd, pad) in sets.items():
        args = (dr.upload_keys(new, pad, dev),
                dr.upload_keys(old, len(old) + 16, dev),
                dr.upload_keys(coarse, len(coarse) + 16, dev), nd,
                ((0, 0),) * nd, dims)
        got, want = dr.regrid_maps(*args), dr.regrid_maps_ref(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: K7 differs from its plain version")
        out[name] = _profiled_ms(lambda: dr.regrid_maps(*args),
                                 ("regrid_maps_kernel",), reps)
        out[name.replace("_ms", "_octs")] = [len(new), len(old), len(coarse)]


def _k10_entries(out: dict, reps: int, dev):
    """``k10_64_ms``, ``k10_256_ms``, ``k10_plateau_ms``, ``k10_smooth_ms``;
    each call also checked bitwise against the plain version."""
    import numpy as np
    import torch
    from ramses_tpu_torch.pm import clumps
    for name, (kind, shape, seed) in K10_FIELDS.items():
        host = _k10_field(kind, shape, seed)
        rho = torch.from_numpy(host).to(dev)
        thr = float(np.median(host)) - 1e-9
        if not torch.equal(clumps.watershed(rho, thr, 3),
                           clumps.watershed_ref(rho, thr, 3)):
            raise AssertionError(f"{name}: K10 differs from its plain "
                                 f"version")
        out[name] = _profiled_ms(lambda: clumps.watershed(rho, thr, 3),
                                 ("parents_kernel", "labels_kernel"), reps)
        del rho
        torch.cuda.empty_cache()


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


def child(reps: int, groups) -> dict:
    """The timings of ``groups`` on this process's tree (the tree
    ``ramses_tpu_torch`` is imported from)."""
    import torch
    from ramses_tpu_torch import kernels
    names = list(dict.fromkeys(n for g in groups for n in SOURCES[g]))
    logs = kernels.build(names)
    for name in names:
        for line in logs.get(name, "").splitlines():
            if ("Used" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"{name}: {line.strip()}")
    dev = torch.device(DEVICE)
    out = {"tree": os.path.dirname(os.path.dirname(kernels.__file__))}
    if "k7" in groups:
        _k7_entries(out, reps, dev)
    if "k10" in groups:
        _k10_entries(out, reps, dev)
    if "k8" in groups:
        _k8_entries(out, reps, dev)
    if "k6" in groups:
        _k6_entries(out, dev)
    return out


def _k8_entries(out: dict, reps: int, dev):
    """``k8_dense_ms``, ``k8_dense_max_abs_err``, ``k8_block_ms``."""
    import torch
    from ramses_tpu_torch.rt import m1
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
    torch.cuda.empty_cache()


def _k6_entries(out: dict, dev):
    """``cooling_step_ms``, ``k6_march_ms``, ``cool_step_ms`` and
    ``rt_substep_ms``."""
    import torch
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.grid.uniform import run_steps_cool
    from ramses_tpu_torch.hydro import cooling as pc
    from ramses_tpu_torch.rt import m1
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma list of k8, k6, k7, k10")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "kernel_turns.json"))
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    groups = [g for g in a.only.split(",") if g]
    if not groups or any(g not in GROUPS for g in groups):
        ap.error(f"--only takes a comma list of {', '.join(GROUPS)}")
    if a.child:
        import torch
        if not torch.cuda.is_available():
            print("kernel_turns: needs a CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(child(a.reps, groups)))
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
             "--reps", str(a.reps), "--only", ",".join(groups)], cwd=tree,
            env=env,
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
