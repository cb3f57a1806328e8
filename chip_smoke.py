#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ramses_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions;
2. build: every kernel under ``ramses_tpu_torch/csrc/`` with ``nvcc``,
   with each kernel's registers and spill bytes from ptxas;
3. kernel check: the fused MUSCL kernel against its plain PyTorch version
   on random 64³ states (llf/hllc × slope 1/2/8, a masked case, a
   reflecting/outflow case): ``un`` within rtol 2e-5 / atol 2e-6,
   ``dt_next`` within rel 3e-3 (the table of tests/test_pallas_kernel.py);
4. main path: ``run_namelist("namelists/sedov3d.nml", ndim=3)`` at 256³
   (``nstepmax=10``) on the card, with every kernel launch counter set to
   0 just before and read just after: one fused-kernel launch per step, a
   finite state, mass conserved to rel 1e-5 (periodic box);
5. timing at 256³ on the main path's final state: the kernel checked
   against its plain version there, cell by cell, within
   ``LOCAL_ATOL + LOCAL_RTOL * M`` where M is the max of the field's
   magnitude over the cell's 5³ stencil (``dt_next`` within rel 3e-3),
   both timed (median of CUDA-event times after warm-up), the bound
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s f32), the steady
   step rate of ``run_steps``;
6. profile: 10 ``run_steps`` steps at 256³ under ``torch.profiler``: the
   device's busy share of the window and the time of each kernel; the
   trace goes to ``chiprun_out/chip_smoke_trace.json``;
7. AMR kernel check: K3 (``tile_sweep``, shift 1 and 2) and K2
   (``oct_sweep``, N = 256) against their plain versions on random batches
   (llf/hllc × slope 1/2/8, half of them masked), within the same table;
8. AMR main path: ``AmrSim(params).evolve(tend, nstepmax=10)`` on
   ``namelists/sedov3d.nml`` at levelmin=7, levelmax=9 with
   ``err_grad_d = err_grad_p = 0.1`` set in code (``bench.py``'s AMR
   config), every launch counter at 0 just before: K1 once per coarse
   step, K3 once per partial-level substep, K2 never; a finite state,
   leaf mass conserved to rel 1e-5; octs per level, wall time and
   cell-updates/s (``Σ_l noct·8·2^(l-lmin)`` per coarse step);
9. from that state, 3 coarse steps three times: blocked twice (bitwise
   equal: the replay contract of ``bench.py``) and with
   ``oct_blocking=.false.`` once (K2 launched, K3 not; equal trees, rows
   within ``AMR_REL`` of each field's max on the level);
10. the kernels at the main path's shapes, on the phase-8 state gathered
   as the path gathers it: K3 and K2 on levels 8 and 9, K1 on level 7
   with its refined-cell mask.  Each is checked against its plain version
   there, each value within ``LOCAL_ATOL + LOCAL_RTOL·M``: M is the
   field's max over the cell's 5³ stencil (inside the block for K3 and
   K2; over the cells a face touches for a face flux, over the four faces
   for K2's per-oct sums).  Each is timed on the device per launch
   (``torch.profiler``); K3 and K2 also by the wall of one wrapper call
   (CUDA events), with their plain versions' times and bounds; the
   level-7 flat↔dense gather against the 22-dimensional bit-axis permute
   it replaces;
11. profile: one AMR coarse step (regrid, Courant fetch, step) under
   ``torch.profiler``, trace to ``chiprun_out/chip_smoke_amr_trace.json``.

The line before the last holds every ported kernel's numbers as one JSON
object (``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NML = os.path.join(ROOT, "namelists", "sedov3d.nml")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
RTOL, ATOL, DT_REL = 2e-5, 2e-6, 3e-3
CHECK_SHAPE = (64, 64, 64)
# On the Sedov state the tolerance scales with the magnitudes a cell's step
# reads: nvcc contracts a*b+c into FMAs that the plain version rounds
# twice, so where a transverse momentum is roundoff (~1e-6 beside 143 in
# the shell) the two differ by a rounding of the shell's values, past the
# table's atol.  Scaling by the field's max over the cell's 5³ stencil
# admits that and stays at 1.25e-10 in the ambient gas (E = 2.5e-5).  On
# an H100 the worst value of any kernel's output reads 1.3e-7 of its scale
# (K1 at 256³; K3 and K2 8.4e-8 at most; PERF.md): LOCAL_RTOL is 7.6x
# that and 20x below the elementwise table's rtol.
LOCAL_RTOL, LOCAL_ATOL = 1e-6, 1e-10
# blocked (K3) against stencil (K2) after 3 AMR steps: the two paths sum a
# face's four fluxes in different orders, so they may part by f32 roundoff
# in the coarse corrections, which the following steps carry to cells
# outside any one step's stencil; so the scale is the field's max on the
# level.  The kernels' own per-value checks are phases 7 and 10.
AMR_REL = 1e-5
AMR_LEVELS = (7, 9)            # levelmin, levelmax of BASELINE config 2


def _print(*a):
    print(*a, flush=True)


def _median_ms(fn, reps: int = 30, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _random_state(shape, gamma: float, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    r = 1.0 + 0.3 * rng.random(shape)
    v = 0.2 * rng.standard_normal((3,) + shape)
    p = 0.5 + 0.2 * rng.random(shape)
    e = p / (gamma - 1.0) + 0.5 * r * (v ** 2).sum(axis=0)
    return np.stack([r, r * v[0], r * v[1], r * v[2], e]).astype(np.float32)


def _excess(got, want) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 when within tolerance."""
    return float(((got - want).abs() - (ATOL + RTOL * want.abs())).max())


def _stencil_scale(x):
    """Max of ``|x|`` over each cell's 5³ neighbourhood, per field,
    wrapping periodically (the main path's box is periodic): the
    magnitudes one MUSCL step of that cell reads."""
    import torch.nn.functional as F
    a = F.pad(x.abs()[None], (2,) * 6, mode="circular")
    return F.max_pool3d(a, 5, stride=1)[0]


def _ptxas_report(log: str) -> str:
    """Registers and spill stores of each kernel entry, from nvcc's
    ``-Xptxas -v`` report."""
    import re
    names = re.findall(r"Compiling entry function '([^']+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return "; ".join(f"{n}: {r} registers, {sp} B spill stores"
                     for n, r, sp in zip(names, regs, spills))


def _count_ops(fn) -> int:
    """Elementwise f32 operations the plain version performs, counted from
    the tensors it computes on: each arithmetic, comparison or select op
    counts its output's elements, a reduction its input's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    elementwise = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sign",
                   "sqrt", "reciprocal", "maximum", "minimum", "clamp",
                   "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge",
                   "eq", "ne"}
    reductions = {"min", "max", "sum", "amin", "amax"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in elementwise:
                Count.n += out.numel()
            elif name in reductions:
                Count.n += args[0].numel()
            return out

    with Count():
        fn()
    return Count.n


def _profile(run, out_dir: str, name: str = "chip_smoke_trace.json",
             warm: bool = True) -> str:
    """One traced run of ``run`` (after one untraced run when ``warm``):
    device kernel time by name and the device's busy share of the window;
    the trace goes to ``out_dir/name``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, name))
    # kernels only: an aten op's own row repeats its kernels' device time
    rows = sorted(((e.self_device_time_total, e.count,
                    e.key.replace("void ", "").replace(
                        "(anonymous namespace)::", "")[:40])
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    top = "; ".join(f"{k} x{n} {us / 1e3:.3f} ms" for us, n, k in rows[:8])
    ours = "; ".join(
        f"{kern} x{sum(n for _, n, k in rows if kern in k)} "
        f"{sum(us for us, _, k in rows if kern in k) / 1e3:.3f} ms"
        for kern in ("fused_muscl_kernel", "sweep_kernel")
        if any(kern in k for _, _, k in rows))
    return (f"device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
            f"wall ({100 * busy_us / 1e6 / wall:.1f} %); port kernels: "
            f"{ours}; top: {top}")


def _reset_counts():
    """Every kernel's launch count to 0."""
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    fm.launches = 0
    for name in om.launches:
        om.launches[name] = 0


def _counts() -> dict:
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    return {"fused_muscl": fm.launches, **om.launches}


def _amr_params(blocked: bool = True):
    """sedov3d at ``AMR_LEVELS`` as ``bench.py`` sets it up: the namelist
    is a uniform production file with no refinement criteria, so relative
    density and pressure jumps of 0.1 are set here."""
    from ramses_tpu_torch.config import load_params
    p = load_params(NML, ndim=3)
    p.amr.levelmin, p.amr.levelmax = AMR_LEVELS
    p.amr.oct_blocking = blocked
    p.refine.err_grad_d = p.refine.err_grad_p = 0.1
    return p


def _pair_check(got, want):
    """(max abs err, worst tolerance excess) over matching outputs."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err, max(_excess(g, w) for g, w in zip(got, want))


def _block_stencil_scale(blk):
    """Max of ``|blk|`` over each cell's 5³ neighbourhood inside its own
    block ``blk [5, s, s, s, N]``, per field and batch entry: the
    magnitudes one MUSCL step of that cell reads."""
    import torch.nn.functional as F
    s, n = blk.shape[1], blk.shape[-1]
    a = blk.abs().movedim(-1, 1).reshape(1, 5 * n, s, s, s)
    m = F.max_pool3d(a, 5, stride=1, padding=2)
    return m.reshape(5, n, s, s, s).movedim(1, -1)


def _output_scales(blk, c: int, planes: bool):
    """The scale of each value a sweep of ``blk`` returns: a cell's own
    5³ stencil max for ``du``; for a face flux the larger of the two cells
    it touches, and for K2's per-oct face sums the largest over the four
    faces summed.  Shaped as ``(du, corrp)`` (K3) or ``(du, corr)`` (K2)."""
    import torch
    from ramses_tpu_torch.amr import kernels as K
    s = _block_stencil_scale(blk)
    du = s[:, 2:2 + c, 2:2 + c, 2:2 + c]
    faces = []
    for d in range(3):
        # index f of the face axis: the face between cells f - 1 and f
        f = K._face_planes(torch.maximum(s, s.roll(1, dims=1 + d)), d, 3, c)
        faces.append(f if planes else f.amax(dim=(2, 3)))
    return du, torch.stack(faces, dim=1)


def _local_check(got, want, scales):
    """(max abs err, worst err / M of each output, tolerance excess) with
    each value held to ``LOCAL_ATOL + LOCAL_RTOL * M``, M its entry of
    ``scales``."""
    import torch
    err, rels = 0.0, []
    excess = -1.0
    for g, w, m in zip(got, want, scales):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        # where the atol does not dominate the tolerance
        big = m > LOCAL_ATOL / LOCAL_RTOL
        rels.append(float(torch.where(big, d / m, 0.0).max()))
        excess = max(excess, float((d - (LOCAL_ATOL + LOCAL_RTOL * m)).max()))
    return err, rels, excess


def _device_ms(fn, kernel: str, n: int = 50) -> float:
    """Device time per launch of the kernels whose name holds ``kernel``,
    from ``torch.profiler`` over ``n`` calls of ``fn`` after a warm-up:
    the kernel's own time.  CUDA events around a call of a ~10 µs kernel
    measure the host's dispatch of the call instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in rows)
    if count != n:
        raise AssertionError(f"profiled {count} launches of {kernel}, "
                             f"expected {n}")
    return sum(e.self_device_time_total for e in rows) / count / 1e3


def _host_breakdown(sim, run) -> str:
    """Wall seconds of one ``run`` of an AMR coarse step split by the
    hierarchy's parts, the device synchronised around each part."""
    import torch
    parts = ("_flag_and_tree", "_rebuild_maps", "_migrate_level",
             "_restrict_all", "coarse_dt", "step_coarse")
    acc = dict.fromkeys(parts, 0.0)

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return call
    for name in parts:
        setattr(sim, name, timed(name, getattr(sim, name)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for name in parts:
        delattr(sim, name)
    acc["other host"] = total - sum(acc.values())
    return f"total {total:.4f} s: " + ", ".join(
        f"{k.strip('_')} {v:.4f}" for k, v in acc.items())


def _amr_phases(dev):
    """Phases 7-11 (the AMR slice); returns K1's max abs err on level 7 of
    the AMR state and the K3 and K2 rows of the kernels line."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import bitperm
    from ramses_tpu_torch.amr import kernels as K
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.convert import amr_state_from
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.hydro.core import HydroStatic

    # ---- 7. K3 and K2 against their plain versions, random batches ----
    worst = {"tile_sweep": 0.0, "oct_sweep": 0.0}
    ncase = 0
    for i, (rs, st) in enumerate((rs, st) for rs in ("llf", "hllc")
                                 for st in (1, 2, 8)):
        cfg = HydroStatic(ndim=3, riemann=rs, slope_type=st)
        masked = i % 2 == 0
        for name, side, n, shift in (("tile_sweep", 8, 64, 1),
                                     ("tile_sweep", 12, 64, 2),
                                     ("oct_sweep", 6, 256, None)):
            shape = (side,) * 3 + (n,)
            u = torch.from_numpy(_random_state(shape, cfg.gamma, 7 + i))
            u = u.to(dev)
            g = torch.Generator(device="cpu").manual_seed(200 + i)
            ok = ((torch.rand(shape, generator=g) < 0.15) & masked).to(dev)
            dt = torch.tensor(1e-3, dtype=torch.float32, device=dev)
            extra = (shift,) if shift is not None else ()
            got = getattr(om, name)(u, ok, dt, cfg, 1.0 / 64, *extra)
            want = getattr(om, name + "_ref")(u, ok, dt, cfg, 1.0 / 64, *extra)
            torch.cuda.synchronize()
            err, ex = _pair_check(got, want)
            if not ex <= 0.0:
                raise AssertionError(
                    f"{name} disagrees with its plain version: riemann={rs} "
                    f"slope_type={st} shape={shape} masked={masked}: max abs "
                    f"err {err:.3e}, tolerance excess {ex:.3e}")
            worst[name] = max(worst[name], err)
            ncase += 1
    _print(f"phase 7 AMR kernel check: {ncase} cases (K3 shift 1 and 2, N "
           f"64; K2 N 256) pass; max abs err tile_sweep "
           f"{worst['tile_sweep']:.3e}, oct_sweep {worst['oct_sweep']:.3e}")

    # ---- 8. the AMR main path: sedov3d levelmin=7, levelmax=9 ----
    p = _amr_params()
    lmin, lmax = AMR_LEVELS
    tend = p.output.tout[-1] if p.output.tout else p.output.tend
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim = AmrSim(p)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mass0 = float(sim.totals()["mass"])
    stepped = []                       # populated levels of each step
    step_coarse = sim.step_coarse
    sim.step_coarse = lambda dt: (stepped.append(tuple(sim.levels())),
                                  step_coarse(dt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.evolve(tend, nstepmax=p.run.nstepmax)
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse
    want = {"fused_muscl": len(stepped), "oct_sweep": 0,
            "tile_sweep": sum(2 ** (l - lmin) for lv in stepped for l in lv
                              if l > lmin)}
    mass1 = float(sim.totals()["mass"])
    octs = {l: sim.tree.noct(l) for l in sim.levels()}
    every = list(range(p.amr.levelmin, p.amr.levelmax + 1))
    if sim.nstep != 10 or len(stepped) != 10 or sim.levels() != every:
        raise AssertionError(f"AMR main path ran {sim.nstep} steps on "
                             f"levels {sim.levels()}; expected 10 on "
                             f"{every}")
    if launches != want:
        raise AssertionError(f"AMR main path launched {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels()):
        raise AssertionError("AMR main path state is not finite")
    if abs(mass1 - mass0) > 1e-5 * abs(mass0):
        raise AssertionError(f"AMR leaf mass not conserved: {mass0} -> "
                             f"{mass1}")
    _print(f"phase 8 AMR main path: sedov3d levelmin={lmin} "
           f"levelmax={lmax}, "
           f"{sim.nstep} coarse steps t={sim.t:.6e}, octs per level {octs}, "
           f"tiles per partial level "
           f"{ {l: b.ntile for l, b in sim.blocks.items()} }, launches "
           f"{launches} (expected {want}); leaf mass {mass0:.9e} -> "
           f"{mass1:.9e}; AmrSim() {init_s:.3f} s, evolve {wall:.3f} s = "
           f"{sim.cell_updates / wall:.4e} cell-updates/s "
           f"({sim.cell_updates} cell updates)")

    # ---- 9. replay and the stencil path (K2) from one state ----
    state = amr_state_from(sim)

    def three_steps(blocked):
        s = AmrSim.from_state(_amr_params(blocked), **state)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        s.evolve(tend, nstepmax=s.nstep + 3)
        s.drain()
        return s, _counts(), time.perf_counter() - t0

    a, la, wa = three_steps(True)
    b, _, wb = three_steps(True)
    c, lc, wc = three_steps(False)
    if lc["oct_sweep"] == 0 or lc["tile_sweep"] != 0 or \
            lc["fused_muscl"] != 3 or la["oct_sweep"] != 0:
        raise AssertionError(f"stencil run launched {lc}, blocked {la}")
    worst_rel = 0.0
    for l in a.levels():
        if not (np.array_equal(a.tree.levels[l].keys, b.tree.levels[l].keys)
                and torch.equal(a.u[l], b.u[l])):
            raise AssertionError(f"replay of 3 AMR steps is not bitwise "
                                 f"equal on level {l}")
        if not np.array_equal(a.tree.levels[l].keys, c.tree.levels[l].keys):
            raise AssertionError(f"stencil and blocked trees differ on "
                                 f"level {l}")
        n = a.tree.noct(l) * 8
        ua, uc = a.u[l][:n], c.u[l][:n]
        rel = float(((uc - ua).abs() / ua.abs().amax(dim=0)).max())
        worst_rel = max(worst_rel, rel)
        if not rel <= AMR_REL:
            raise AssertionError(f"stencil and blocked runs part on level "
                                 f"{l}: {rel:.3e} of the field max")
    _print(f"phase 9 AMR replay: 3 blocked steps twice, bitwise equal "
           f"({wa:.3f} s, {wb:.3f} s); oct_blocking=.false. {wc:.3f} s, "
           f"launches {lc}, octs {[c.tree.noct(l) for l in c.levels()]}, "
           f"worst |stencil - blocked| / field max {worst_rel:.3e}")
    oct_launches = lc["oct_sweep"]
    del a, b, c, state
    torch.cuda.empty_cache()

    # ---- 10. K3 and K2 at the main path's shapes ----
    cfg = sim.cfg
    shift = sim._fused_spec().block_shift
    c_ = 1 << (shift + 1)
    td = c_ + 4
    dtc = sim.coarse_dt()
    rows = {}
    lines = []
    partial = sim.levels()[1:]
    for name in ("tile_sweep", "oct_sweep"):
        for l in partial:
            d = sim.dev[l]
            dx = sim.dx(l)
            dt = torch.tensor(dtc / 2 ** (l - lmin), dtype=torch.float32,
                              device=dev)
            if name == "tile_sweep":
                interp = K.interp_cells(sim.u[l - 1], d["b_interp_cell"],
                                        d["b_interp_nb"], d["b_interp_sgn"],
                                        cfg)
                blk = K._gather_utile(sim.u[l], interp, d["tile_src"],
                                      d["tile_vsgn"], cfg, td)
                ok = K._block_mask(d["tile_ok"], td, 3).to(torch.float32)
                extra, keep = (shift,), c_ ** 3 / td ** 3
            else:
                interp = K.interp_cells(sim.u[l - 1], d["interp_cell"],
                                        d["interp_nb"], d["interp_sgn"], cfg)
                blk = K._gather_uloc(sim.u[l], interp, d["stencil_src"],
                                     d["vsgn"], cfg)
                ok = K._block_mask(d["ok_ref"], 6, 3).to(torch.float32)
                extra, keep = (), 8 / 216
            kern = getattr(om, name)
            plain = getattr(om, name + "_ref")
            got = kern(blk, ok, dt, cfg, dx, *extra)
            want = plain(blk, ok, dt, cfg, dx, *extra)
            torch.cuda.synchronize()
            scales = _output_scales(blk, c_ if name == "tile_sweep" else 2,
                                    name == "tile_sweep")
            err, rel, ex = _local_check(got, want, scales)
            del scales
            rel = "/".join(f"{x:.3e}" for x in rel)
            if not ex <= 0.0:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on level {l} of the AMR "
                                     f"state: max abs err {err:.3e}, err / "
                                     f"stencil max (du/faces) {rel}")
            ms = _device_ms(lambda: kern(blk, ok, dt, cfg, dx, *extra),
                            "sweep_kernel")
            call_ms = _median_ms(lambda: kern(blk, ok, dt, cfg, dx, *extra),
                                 reps=200, warm=50)
            pms = _median_ms(lambda: plain(blk, ok, dt, cfg, dx, *extra),
                             reps=10)
            nbytes = 4 * (blk.numel() + ok.numel() + 1
                          + sum(x.numel() for x in got))
            # the plain version computes on the whole block; the kernel's
            # work is the interior's share of it
            nops = _count_ops(lambda: plain(blk, ok, dt, cfg, dx, *extra)) \
                * keep
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * nops / F32_OPS_PER_S
            n = blk.shape[-1]
            tx = 32 if n >= 32 else 16 if n >= 16 else 8   # the launcher's
            nblock = -(-n // tx) * (-(-c_ ** 3 // (128 // tx))
                                    if name == "tile_sweep" else 1)
            rows[(name, l)] = dict(ms=ms, plain_ms=pms, err=err,
                                   bound_ms=max(bytes_ms, ops_ms),
                                   bound_by=("bytes" if bytes_ms >= ops_ms
                                             else "operations"))
            lines.append(f"{name} level {l} N={n} ({nblock} blocks): "
                         f"{ms:.4f} ms/launch on the device (profiler), "
                         f"{call_ms:.4f} ms a wrapper call (CUDA events), "
                         f"plain {pms:.4f} ms, bound "
                         f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes / 1e6:.3f}"
                         f" MB -> {bytes_ms:.5f} ms; {nops / 1e9:.4f} G ops "
                         f"-> {ops_ms:.5f} ms), max abs err {err:.3e}, err / "
                         f"stencil max (du/faces) {rel}")
    # K1 on level 7 as dense_sweep hands it over: the dense gather of the
    # flat rows, the refined-cell mask, the coarse dt
    u7 = sim.u[lmin]
    shape7 = sim.tree.cell_dims(lmin)
    ud = K._rows_to_vars(u7, None, shape7)
    ok7 = sim.dev[lmin]["ok_dense"].reshape(shape7)
    dt7 = torch.tensor(dtc, dtype=torch.float32, device=dev)
    args7 = (ud, dt7, cfg, sim.dx(lmin), sim.bspec)
    un = fm.fused_step(*args7, ok=ok7)
    ref = fm.fused_step_ref(*args7, ok=ok7)
    torch.cuda.synchronize()
    err = (un - ref).abs()
    scale = _stencil_scale(ref)
    excess7 = float((err - (LOCAL_ATOL + LOCAL_RTOL * scale)).max())
    err7 = float(err.max())
    rel7 = [float((err[i] / scale[i]).nan_to_num(nan=0.0).max())
            for i in range(5)]
    if not excess7 <= 0.0:
        raise AssertionError(f"fused_muscl disagrees with its plain version "
                             f"on level {lmin} of the AMR state: max abs err "
                             f"{err7:.3e}, err / stencil max per field "
                             f"{rel7}")
    del un, ref, err, scale
    ms7 = _device_ms(lambda: fm.fused_step(*args7, ok=ok7),
                     "fused_muscl_kernel")
    lines.append(f"fused_muscl level {lmin} {tuple(shape7)} with "
                 f"{int(ok7.sum())} refined cells: {ms7:.4f} ms/launch on "
                 f"the device (profiler), max abs err {err7:.3e}, err / "
                 f"stencil max per field {[f'{x:.3e}' for x in rel7]}")
    del ud
    gather_ms = _median_ms(lambda: K._rows_to_vars(u7, None, shape7))
    seq = bitperm._bit_seq(lmin, 3)
    pos = {bit: i for i, bit in enumerate(seq)}
    axes = tuple(pos[(d, i)] for d in range(3)
                 for i in range(lmin - 1, -1, -1)) + (3 * lmin,)
    ncell = 1 << (3 * lmin)

    def permute():
        x = u7[:ncell].reshape((2,) * (3 * lmin) + (u7.shape[1],))
        return x.permute(axes).reshape(shape7 + (u7.shape[1],)) \
            .movedim(-1, 0).contiguous()
    try:
        same = torch.equal(permute(), K._rows_to_vars(u7, None, shape7))
        perm_note = (f"{_median_ms(permute):.4f} ms ({len(axes)}-dim "
                     f"permute, equal: {same})")
    except RuntimeError as e:
        perm_note = f"refused ({str(e).splitlines()[0][:80]})"
    _print("phase 10 AMR kernels at the main path's shapes: "
           + "; ".join(lines) + f"; level-7 flat->dense gather "
           f"{gather_ms:.4f} ms, bit-axis permute {perm_note}; library "
           f"call: none (no single PyTorch call computes a MUSCL sweep)")

    # ---- 11. where one AMR coarse step's time goes, and its profile ----
    def coarse_step():
        sim.regrid()
        sim.step_coarse(sim.coarse_dt())
    walls = _host_breakdown(sim, coarse_step)
    prof = _profile(coarse_step, os.path.join(ROOT, "chiprun_out"),
                    "chip_smoke_amr_trace.json", warm=False)
    _print(f"phase 11 one AMR coarse step (regrid + Courant fetch + step, "
           f"octs {[sim.tree.noct(l) for l in sim.levels()]}): wall by part, "
           f"each synchronised: {walls}; profiled: {prof}")

    def row(name, src_line, launches):
        r = rows[(name, partial[-1])]
        return {"name": name, "route": "cuda",
                "source": "ramses_tpu_torch/csrc/oct_muscl.cu",
                "replaces": src_line, "launches": launches,
                "max_abs_err": max([worst[name]] + [rows[(name, l)]["err"]
                                                    for l in partial]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}
    return err7, [row("tile_sweep", "ramses_tpu/hydro/pallas_oct.py:396",
                      launches["tile_sweep"]),
                  row("oct_sweep", "ramses_tpu/hydro/pallas_oct.py:213",
                      oct_launches)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ramses_tpu_torch import kernels
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import Simulation, run_namelist
    from ramses_tpu_torch.grid import boundary as bmod
    from ramses_tpu_torch.grid.uniform import cfl_dt, run_steps
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro.core import HydroStatic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    _print(card)
    kind = torch.cuda.get_device_name(0)
    _print(f"phase 1 device: {kind} count={torch.cuda.device_count()} "
           f"torch={torch.__version__} cuda={torch.version.cuda} "
           f"python={sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    logs = kernels.build(kernels.sources())
    build_s = time.perf_counter() - t0
    report = "; ".join(_ptxas_report(log) for log in logs.values())
    _print(f"phase 2 build: {kernels.sources()} in {build_s:.1f} s; "
           f"{report or 'already built'}")

    # ---- 3. kernel against its plain version at 64³ ----
    dx = 1.0 / CHECK_SHAPE[0]
    periodic = bmod.BoundarySpec.periodic(3)
    walls = bmod.BoundarySpec(faces=(
        (bmod.FaceBC(1), bmod.FaceBC(1)), (bmod.FaceBC(2), bmod.FaceBC(1)),
        (bmod.FaceBC(1), bmod.FaceBC(2))))
    cases = [(rs, st, periodic, False) for rs in ("llf", "hllc")
             for st in (1, 2, 8)]
    cases += [("llf", 1, periodic, True), ("hllc", 2, walls, True)]
    worst = {"excess": -1.0, "max_abs_err": 0.0, "dt_rel": 0.0}
    for i, (rs, st, bc, masked) in enumerate(cases):
        cfg = HydroStatic(ndim=3, riemann=rs, slope_type=st)
        u = torch.from_numpy(_random_state(CHECK_SHAPE, cfg.gamma, i)).to(dev)
        ok = None
        if masked:
            g = torch.Generator(device="cpu").manual_seed(100 + i)
            ok = (torch.rand(CHECK_SHAPE, generator=g) < 0.1).to(dev)
        dt = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        un, dtn = fm.fused_step(u, dt, cfg, dx, bc, ok=ok, courant=True)
        ref, dtr = fm.fused_step_ref(u, dt, cfg, dx, bc, ok=ok, courant=True)
        torch.cuda.synchronize()
        ex = _excess(un, ref)
        err = float((un - ref).abs().max())
        rel = abs(float(dtn) - float(dtr)) / float(dtr)
        if not (ex <= 0.0 and rel <= DT_REL and torch.isfinite(un).all()):
            raise AssertionError(
                f"fused_muscl disagrees with its plain version: riemann={rs} "
                f"slope_type={st} bc={bc.kinds} masked={masked}: max abs "
                f"err {err:.3e}, tolerance excess {ex:.3e}, dt rel {rel:.3e}")
        worst["excess"] = max(worst["excess"], ex)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["dt_rel"] = max(worst["dt_rel"], rel)
    _print(f"phase 3 kernel check: {len(cases)} cases at {CHECK_SHAPE} pass "
           f"(max abs err {worst['max_abs_err']:.3e}, worst tolerance "
           f"excess {worst['excess']:.3e}, worst dt rel err "
           f"{worst['dt_rel']:.3e})")

    # ---- 4. the main path at 256³ ----
    params = load_params(NML, ndim=3)
    mass0 = float(Simulation(params).totals()["mass"])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim = run_namelist(NML, ndim=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    u = sim.state.u
    mass1 = float(sim.totals()["mass"])
    if sim.grid.shape != (256, 256, 256) or sim.nstep != 10:
        raise AssertionError(f"main path ran {sim.nstep} steps at "
                             f"{sim.grid.shape}, expected 10 at 256³")
    if launches != {"fused_muscl": sim.nstep, "tile_sweep": 0,
                    "oct_sweep": 0}:
        raise AssertionError(f"kernels launched {launches} for "
                             f"{sim.nstep} uniform steps")
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("main path state is not finite")
    if abs(mass1 - mass0) > 1e-5 * abs(mass0):
        raise AssertionError(f"mass not conserved: {mass0} -> {mass1}")
    ncell = sim.grid.ncell
    _print(f"phase 4 main path: sedov3d {sim.grid.shape} {sim.nstep} steps "
           f"t={sim.t:.6e} launches={launches} mass {mass0:.9e} -> "
           f"{mass1:.9e}; run_namelist {wall:.3f} s (incl. condinit), "
           f"evolve {sim.wall_s:.4f} s = "
           f"{sim.cell_updates / sim.wall_s:.4e} cell-updates/s")

    # ---- 5. timing at 256³ on the main path's state ----
    cfg, bc = sim.cfg, sim.bc
    dt = cfl_dt(sim.grid, u).to(torch.float32)     # the next step's dt
    un, dtn = fm.fused_step(u, dt, cfg, sim.dx, bc, courant=True)
    ref, dtr = fm.fused_step_ref(u, dt, cfg, sim.dx, bc, courant=True)
    torch.cuda.synchronize()
    err = (un - ref).abs()
    scale = _stencil_scale(ref)
    excess = float((err - (LOCAL_ATOL + LOCAL_RTOL * scale)).max())
    err_256 = float(err.max())
    # per field: worst error over the stencil scale (0/0 counts as 0) and
    # worst error over the field's global max
    local_rel = [float((err[c] / scale[c]).nan_to_num(nan=0.0).max())
                 for c in range(5)]
    field_rel = [float(err[c].max() / ref[c].abs().max()) for c in range(5)]
    rel = abs(float(dtn) - float(dtr)) / float(dtr)
    readings = (f"max abs err {err_256:.3e}, err / stencil max per field "
                f"{[f'{x:.3e}' for x in local_rel]}, err / field max "
                f"{[f'{x:.3e}' for x in field_rel]}, tolerance excess "
                f"{excess:.3e}, dt rel {rel:.3e}")
    if not (excess <= 0.0 and rel <= DT_REL):
        raise AssertionError(f"fused_muscl disagrees at 256³ on the main "
                             f"path's state: {readings}")
    del un, ref, err, scale
    ms = _median_ms(lambda: fm.fused_step(u, dt, cfg, sim.dx, bc,
                                          courant=True))
    torch.cuda.reset_peak_memory_stats()
    plain_ms = _median_ms(lambda: fm.fused_step_ref(u, dt, cfg, sim.dx, bc,
                                                    courant=True), reps=20)
    plain_peak = torch.cuda.max_memory_allocated()
    nbytes = 2 * u.numel() * u.element_size() + 2 * 4   # u, un, dt, dt_next
    nops = _count_ops(lambda: fm.fused_step_ref(u, dt, cfg, sim.dx, bc,
                                                courant=True))
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    nsteps = 20
    t = torch.tensor(sim.t, dtype=torch.float64, device=dev)
    run = lambda: run_steps(sim.grid, u, t, 1e30, nsteps)  # noqa: E731
    step_ms = _median_ms(run, reps=5, warm=1) / nsteps
    _print(f"phase 5 timing at {tuple(u.shape[1:])}: fused_muscl "
           f"{ms:.4f} ms/launch, plain version {plain_ms:.4f} ms (same "
           f"shape, peak {plain_peak / 2**30:.2f} GiB), bound {bound_ms:.4f} "
           f"ms by {bound_by} ({nbytes / 1e9:.4f} GB -> {bytes_ms:.4f} ms; "
           f"{nops / 1e9:.4f} G ops -> {ops_ms:.4f} ms); against plain: "
           f"{readings}; "
           f"run_steps x{nsteps}: {step_ms:.4f} ms/step = "
           f"{ncell / (step_ms * 1e-3):.4e} cell-updates/s; library call: "
           f"none (no single PyTorch call computes a MUSCL step)")

    # ---- 6. profile ----
    prof = _profile(lambda: run_steps(sim.grid, u, t, 1e30, 10),
                    os.path.join(ROOT, "chiprun_out"))
    _print(f"phase 6 profile run_steps x10 at 256³: {prof}")

    k1 = {
        "name": "fused_muscl",
        "route": "cuda",
        "source": "ramses_tpu_torch/csrc/fused_muscl.cu",
        "replaces": "ramses_tpu/hydro/pallas_muscl.py:387",
        "launches": launches["fused_muscl"],
        "max_abs_err": max(worst["max_abs_err"], err_256),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    del sim, u, t
    torch.cuda.empty_cache()

    # ---- 7-11. the AMR slice ----
    err7, oct_rows = _amr_phases(dev)
    k1["max_abs_err"] = max(k1["max_abs_err"], err7)
    _print(json.dumps({"kernels": [k1] + oct_rows}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
