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
   reflecting/outflow case) and on boxes ragged against its tiles and
   chunks, thin, and with 2-cell periodic axes (every boundary kind, masked
   and not): ``un`` within rtol 2e-5 / atol 2e-6,
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
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s f32) and the share
   of it the kernel reaches, the launch's shared memory, resident blocks
   an SM, registers and spill, the steady step rate of ``run_steps``;
6. profile: 10 ``run_steps`` steps at 256³ under ``torch.profiler``: the
   device's busy share of the window and the time of each kernel; the
   trace goes to ``chiprun_out/chip_smoke_trace.json``;
7. AMR kernel check: K3 (``tile_sweep`` on tile-major batches ``[5, N,
   td, td, td]``: shift 1 and 2 at N = 64, shift 3, ragged N of 1, 3 and
   33, ``K3_CASES``) and K2 (``oct_sweep`` at N = 1, 7, 45, 300, 2048 and
   256, ``K2_N``) against their plain versions on random batches
   (llf/hllc × slope 1/2/8, half of them masked), within the same table;
   K2 at every count of octs a block that fits (``launch_info``), each
   bitwise equal to the launch's own choice;
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
   (CUDA events), with their plain versions' times and bounds; K3 with
   N, its launch (the chunk of x planes a block takes, blocks, shared
   memory, blocks an SM, registers, spill) and every other chunk that fits
   a block, each bitwise equal to the launch's own and timed, and the
   same for random tiles at the ``K3_CHOICE_N`` batch sizes; K2 with
   its launch (the octs a block takes, blocks, shared memory, blocks an
   SM, registers, spill) and every other count of octs a block, each
   bitwise equal to the launch's own and timed; K2 with the mass fluxes on
   each level's octs bitwise K3 at shift 0 on the same octs laid out
   tile-major (du and phi; corr the sum of K3's four face planes in K2's
   order, ``oct_muscl.oct_from_tiles``); K1
   beside its bound (u, mask and update moved once); the level-7
   flat↔dense gather against the 22-dimensional bit-axis permute
   it replaces;
11. profile: one AMR coarse step (regrid, Courant fetch, step) under
   ``torch.profiler``, trace to ``chiprun_out/chip_smoke_amr_trace.json``;
12. MHD kernel check: K4 (``ct_step_slab``) against its plain version on
   random 2D 256² and 3D 64³ padded boxes, {llf, hll, hlld} × riemann2d
   {average, llf} × slope {1, 2, 8}, half of them with a random refined
   mask and EMF override, then its whole scope: 1D 256 with each of the
   five solvers, 2D 64² with each of the 5 × 7 (riemann, riemann2d)
   pairs plain and masked, 3D 16³ with each corner and solver, slope
   types 0/1/2/7/8 in turn and a passive scalar in some, then boxes
   ragged against K4's tiles and row chunks on every axis and crossing
   two or more of them (2D 70 x 131, 3D 34 x 13 x 20, masked with an
   override and 2 passives; bitwise the same at row chunks of 3 and 7
   rows); every case within rtol 2e-5 / atol 2e-6; 12b: at the Roe mean's degenerate field
   limits (no field; Bx alone), where the f32 formulation itself reads
   ~1e-5 from f64, K4 against the plain f32 and f64 versions and R's
   condition number at the worst cell, reported (finite required);
13. MHD main path: Orszag-Tang at 2048² (``namelists/orszag2d.nml`` with
   levelmin = levelmax = 11, the exact vortex set in code),
   ``MhdSimulation(...).evolve(nstepmax=20)`` with every launch counter
   at 0 just before: K4 once per step, K1/K2/K3 never; a finite state,
   mass and energy conserved to rel 1e-5, ``max|div B|·dx / max|B|``
   under ``DIVB_REL``; wall time, cell-updates/s and the steady rate of
   ``run_steps``;
14. K4 at the main path's data: the final 2048² state, kernel against
   plain cell by cell within ``LOCAL_ATOL + LOCAL_RTOL·M`` (M the largest
   magnitude of any field over the cell's 5² stencil; for a face, over
   the two cells it touches), the kernel's device time per call
   (``torch.profiler``, its one launch a call) beside its launch (threads,
   shared memory, blocks an SM, registers, spill), the plain version's
   time and the bound: the least bytes (the five hydro fields of the padded
   cells, the padded faces and dt in, 8 + 3 interior fields out) and the
   operations (the plain version's traced count less the HLLD regions it
   evaluates and does not select);
15. profile: 10 ``run_steps`` steps at 2048², trace to
   ``chiprun_out/chip_smoke_mhd_trace.json``;
16. 3D: 128³ with a random solenoidal field (hlld, llf corners), 10
   steps: K4 once per step, div B at roundoff, a finite state; then K4
   against its plain version on the final state, cell by cell as in
   phase 14 (M over the cell's 5³ stencil), and its device time;
16b-16d. K4's wider scope at full width: phase 16's 3D run with HLLD
   corners (10 steps), and Orszag-Tang 2048² with riemann/riemann2d =
   hlld/hlld and roe/roe (20 steps each): K4 once a step, div B, a finite
   state, then K4 against its plain version at the final state as in
   phase 14, its device time, the plain version's and the bound (the Roe
   solves' untraced operations added by hand, ``ROE_SOLVE_OPS``);
17. ``BASELINE.json`` config 4, ``namelists/tube_mhd.nml`` (1D, Roe,
   outflow) through K4: ``run_namelist`` for 20 steps (K4 20 launches)
   and K4 against its plain version at that state (M over the cell's 5
   cells, edges replicated); the whole run to tend and the CLI (``python
   -m ramses_tpu_torch namelists/tube_mhd.nml --ndim 1``) in this
   process, each with one K4 launch per step the driver issues (the last
   chunk's steps past tend run at dt = 0); a finite state and ``bf[0]``
   bitwise unchanged;
18. MHD on the AMR hierarchy, K4 at a complete level: the exact
   Orszag-Tang vortex (``tests/test_mhd_amr.py:86-146``) on
   ``orszag2d.nml``'s parameters at levelmin=9, levelmax=11 after two warm
   regrids; in its second coarse step every K4 call is captured as the
   hierarchy makes it, and the one at the parent of a partial level (its
   refined mask and coarse-fine EMF override, both non-empty) goes through
   the kernel and its plain version, cell by cell as in phase 14; the
   kernel's device time there, the plain version's, and the bound;
19. the MHD AMR main path: from the phase-18 set-up state,
   ``MhdAmrSim.evolve`` for 10 coarse steps (a regrid before each) with
   every launch counter at 0 just before: K4 once per complete-level
   substep, K1/K2/K3 never; octs per level, wall, cell-updates/s
   (``Σ_l noct(l)·4·2^(l-9)`` per coarse step), peak device memory, leaf
   mass (rel 1e-5), energy, div B per level (``DIVB_REL`` on complete
   levels, and on a partial level whose parent is complete and which has
   no finer level: the reference scheme's reach, ROADMAP §C3) and the two
   stored copies of every face shared by two leaf cells of a level bitwise
   equal;
20. one MHD AMR coarse step: host wall by part (flagging, maps and EMF
   maps, u and face migration with the donor maps, restriction, Courant
   fetch, the step) and a profile, trace to
   ``chiprun_out/chip_smoke_mhd_amr_trace.json``;
21. ``namelists/orszag2d.nml`` as the CLI runs it: ``run_namelist(...,
   ndim=2, solver="mhd")`` to t = 0.2, then two 3-coarse-step replays
   from its final state, bitwise equal;
22. the flux variants (``want_flux``, the MC gas tracers' face mass
   fluxes) of K1 (64³, masked with dt_next and unmasked), K3 (shift 1 and
   2) and K2 against their plain versions on random inputs: du,
   corrections and phi within rtol 2e-5 / atol 2e-6;
23. the MC-tracer main path: phase 8's sedov3d AMR with ``tracer=.true.``
   and ``tracer_per_cell=1.0`` set in code (~2.1 M tracers), ``evolve``
   for 5 coarse steps (a regrid before each) with every launch count at 0
   just before ``AmrSim()``: K1 with the fluxes once per coarse step, K3
   with the fluxes once per partial-level substep, no other kernel; after
   each step Σ_d (φ_lo − φ_hi) == Δρ on every leaf cell of every level
   (rtol 2e-4 / atol 2e-6, the JAX package's oracle); the tracer count and
   ids conserved (periodic box); the tracers on the level 8-9 leaves within
   5σ of tracer_per_cell · N_leaf · their gas mass share; wall and
   cell-updates/s;
24. the flux variants at the tracer path's state, as the path gathers it
   (K1 on level 7 with its mask, K3 and K2 on levels 8 and 9), each value
   within ``LOCAL_ATOL + LOCAL_RTOL·M`` of the plain version (for phi, M
   the density's max over the 5³ stencils of the cells a face touches);
   device ms a call with and without the fluxes, the plain version's ms,
   the bound;
25. one tracer coarse step: host wall by part (regrid, Courant fetch, the
   step, the phi fetch, ``mc_tracer_amr``) and a profile, trace to
   ``chiprun_out/chip_smoke_tracer_trace.json``;
26. the tracer path with ``oct_blocking=.false.`` for 2 coarse steps: K2
   with the fluxes once per partial-level substep, the mass identity, the
   tracer count;
27. ``namelists/detente.nml`` (1D, ``riemann='exact'``) through
   ``run_namelist`` on the card to tend, against the CPU f64 run (each
   field within 1e-4 of its max);
28. K5 (``halo_exchange``, ``csrc/halo_exchange.cu``) against its plain
   version: ring exchanges of random slabs on 2, 4 and 8 shards, f32 and
   f64, cut along each axis, 1 and 2 deep, into fresh tensors and into
   ghost regions, bitwise, one launch each; K5's device time at the
   uniform path's exchange (16 slabs of ``[5, 2, 260, 260]`` f32) against
   its byte bound, the plain version's and ``torch._foreach_copy_``'s
   times (the kernels line's ``halo_exchange`` row); its time at each of
   phase 30's level-7 exchanges (the sweep's x, y and z with the mask, the
   flag pass's x, y and z), bitwise, against each bound, and the plain
   version's and ``torch._foreach_copy_``'s times at the sweep's z
   exchange (the row ``halo_exchange_amr_z``), and K5's time there from
   contiguous copies of its sources;
29. uniform sedov3d at 256³ (phase 4's state) through ``run_steps_halo``
   on 8 shards of the card (``halo_backend='auto'`` → K5, the overlap
   split), 10 steps with every count at 0 just before: K5 once a step,
   K1's padded entry 3 times a shard a step, nothing else; a finite state,
   mass to rel 1e-5; bitwise equal to the single-device ``run_steps`` from
   the same state (else each cell within ``LOCAL_ATOL + LOCAL_RTOL·M``,
   reported); cell-updates/s, halo bytes a step and a profile (trace to
   ``chiprun_out/chip_smoke_halo_trace.json``); K1's padded entry against
   its plain version at a shard's interior call, timed against its bound;
30. phase 8's sedov3d AMR (levelmin=7, levelmax=9, 10 coarse steps) on
   ``ShardedAmrSim`` with 8 shards, every count at 0 just before
   ``ShardedAmrSim()``: level 7 through ``dense_sweep_slab`` (K5 once per
   cut axis a sweep and a flag pass, the mask in the same launches; K1's
   padded entry 3 times a shard a sweep), K3 as in phase 8; bitwise equal
   to a single-device ``AmrSim`` run on every level (else within
   ``AMR_REL`` of each field's max, reported), leaf mass to rel 1e-5;
   cell-updates/s and one coarse step's profile;
31. config 3 as ``bench.py``'s ``bench_mg``: ``poisson/solver.mg_solve``
   at 128³ f32 (rhs ``default_rng(0).standard_normal``, mean removed),
   10 V-cycles a solve, each solve fed the last one's result times 0,
   repeated until the window is 1 s: V-cycles/s, the relative residual
   (limit 1e-6), ``mg_solve`` against ``fft_solve`` (limit 1e-4 of
   max|φ|), launches a V-cycle and the busy share from the profiler; no
   port kernel;
32. ``namelists/pointmass.nml`` at 128³ f32 through ``Simulation``
   (FFT self-gravity, the general hydro formulation): 5 steps, a finite
   state, mass to rel 1e-5, no port kernel launched, the initial force
   within 1e-4 of max|f| of the same set-up in f64 on the CPU, the
   point-mass law (median |f_r r²/M − 1| under 0.2 on 0.2 < r < 0.3, the
   judge of ``tests/test_amr_gravity.py``), ms a step and a profile;
33. config 2 with self-gravity as ``bench.py``'s ``bench_amr_poisson``
   (``poisson=.true.``): 6 warm coarse steps, then 4 timed, each a regrid
   and a coarse step: PCG iterations/s, iterations a step, cell-updates/s;
   K1 and K3 exactly as the levels stepped require, leaf mass to rel 1e-5,
   every level's phi, fg and u finite; a coarse step's host seconds by
   part with ``solve_gravity`` as one; the finest level's PCG cut to 0 and
   10 iterations under the profiler (launches an iteration, busy share);
   3 coarse steps twice from one state, bitwise (u, phi, fg, iterations);
34. ``namelists/pointmass.nml`` (levelmin=4, levelmax=7, ``nstepmax=4``)
   through ``run_namelist`` as the CLI runs it: K1 and K3 as the levels
   stepped require, finite, mass to rel 1e-5;
35. config 1 (sedov3d 256³ f32) restarted: 10 steps straight, then from a
   fresh start 5 steps, ``dump`` (an emergency number, 900, so that the
   restore resumes the output schedule), ``Simulation.from_snapshot`` and 5
   more steps (K1 5 launches after the restore, counts at 0 just before);
   the dump validates, the restored state is within the f32 round trip
   (each value within one ulp of the dumped one), mass to rel 1e-5; the
   dump's bytes and seconds by stage (device→host, to primitives, the
   octs and levels, writing, hash and fsync), GB/s, the restore's
   seconds, and max |Δ| / (1e-10 + M) against the straight run (M as in
   phase 5) within ``RESTART_DRIFT``;
36. config 2 (levelmin 7, levelmax 9) restarted: 5 coarse steps, a dump,
   the same dump through ``AsyncDumper`` beside the next coarse step,
   ``AmrSim.from_snapshot`` of the first and 5 more coarse steps (K1 and
   K3 as the levels stepped require); octs per level equal after the
   restore, each level's rows within the round trip, both dumps validate,
   leaf mass to rel 1e-5; the dump and restore seconds, the wall of the
   coarse step beside the asynchronous write; the same tree as 10
   straight coarse steps and the same rows, bitwise;
37. Orszag-Tang 2048² (K4) restarted: 5 steps, dump,
   ``MhdSimulation.from_snapshot``, 5 steps (K4 5 launches after the
   restore); faces bitwise, cells within the round trip, mass and energy
   to rel 1e-5, div B; cells and faces bitwise 10 straight steps';
38. the CLI in a subprocess on a copy of sedov3d.nml whose output time
   the run reaches after ``CLI_STEPS`` steps, ``--max-attempts 3``: a
   SIGTERM after its first step line stops it with ``output_00900``, the
   supervisor resumes from it, and ``output_00001`` validates; a second
   CLI run of the namelist with ``nrestart=1`` and a second output time
   continues from it and writes a valid ``output_00002``.  Phases 35-38
   write under a ``tempfile.mkdtemp`` directory, removed at the end;
39. ``BASELINE.json`` config 5: ``namelists/cosmo.nml`` at levelmin=7,
   levelmax=9 (``nremap=1``, ``smallc=1e-6`` and level 8's ``m_refine``
   set in code, see ``COSMO_NREMAP``), its ICs a Gaussian random δ (P(k) ∝ k⁻²,
   ``default_rng(1)``, 0.2 rms a cell) written with the port's
   ``write_zeldovich_ics`` (2,097,152 particles and the baryons), built
   through ``build_namelist_sim`` with every launch count at 0 just
   before, 20 coarse steps through ``evolve`` (a regrid each): K1 and K3
   exactly as the levels stepped require, levels 8 and 9 reached, the leaf
   gas mass (rel 1e-5), the particle count and mass kept, u, phi, fg and
   the particles finite, aexp rising; octs per level, the steps' walls and
   dts, s a coarse step and cell-updates/s; then one more coarse step's
   host seconds by part (regrid, maps, solve, gather and kick, the K1/K3
   sweep, drift, Courant fetch);
40. 3 coarse steps twice from phase 39's state after 15 steps
   (``from_state`` with the particles; level 8 present, level 9 made by
   the first regrid): u, phi, fg, particle x and v, trees and PCG
   iterations bitwise;
41. linear growth, the JAX package's oracles: the uniform ``Simulation``
   on the single mode at 128³ (N-body, FFT) to a = 0.06, growth ∝ a within
   12 %; the hierarchy at ``test_cosmo_amr_growth``'s size (16³, levelmax
   5, m_refine 4) to a = 0.05 within 20 %;
42. config 5 restarted: 5 coarse steps from the ICs, a dump with the
   particles (validates, 2,097,152 part rows), ``AmrSim.from_snapshot``
   (particles bitwise, cells within the round trip) and 5 more: against
   phase 39's first 10 steps bitwise where the first restored dt equals
   the straight run's and no partial level's PCG ran (the restore primes a
   solve, so a PCG warm-starts from it), else both dts and the deviations
   reported;
43. ``python -m ramses_tpu_torch`` on a copy of cosmo.nml (its own
   levelmin 6: 64³ ICs written beside it, ``nstepmax=3``): rc 0, the
   ``cosmo-amr aexp=… nstep=3 octs=[…]`` line, an ``output_00001`` that
   validates with 262,144 particle rows.  Phases 39-43 write under a
   ``tempfile.mkdtemp`` directory, removed at the end.  Config 5's K1 and
   K3 launches join the kernels line's ``fused_muscl`` and ``tile_sweep``
   rows.

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
# phase 7's K3 batches (name, td, N, shift), alternating by case: the
# main path's shift 2 and shift 1 at N 64, shift 3, and ragged N (1, 3, 33)
K3_CASES = ((("tile_sweep", 8, 64, 1), ("tile_sweep", 12, 64, 2),
             ("tile_sweep", 20, 3, 3), ("tile_sweep", 6, 33, 0)),
            (("tile_sweep", 12, 1, 2), ("tile_sweep", 8, 33, 1),
             ("tile_sweep", 20, 1, 3), ("tile_sweep", 12, 64, 2)))
# phase 7's K2 batches, one a case: ragged against the octs a block
# takes, and the main path's level-9 N
K2_N = (1, 7, 45, 300, 2048, 256)
# phase 10's batches of random tiles at shift 2 past the main path's N:
# K3's chunk choice beside every chunk's time
K3_CHOICE_N = (128, 256, 1024)
OT_LEVEL = 11                  # Orszag-Tang at 2048²
# Orszag-Tang on the hierarchy: 512² complete, 2048² effective (PR 3's
# uniform run), cut to 10 coarse steps
OT_AMR_LEVELS = (9, 11)
OT_AMR_STEPS = 10
MHD3D_LEVEL = 7                # the 3D solenoidal run at 128³
MHD_CHECK_SHAPES = ((256, 256), (64, 64, 64))
OT_NML = os.path.join(ROOT, "namelists", "orszag2d.nml")
TUBE_NML = os.path.join(ROOT, "namelists", "tube_mhd.nml")
DETENTE_NML = os.path.join(ROOT, "namelists", "detente.nml")
# the MC-tracer main path: BASELINE config 2 with &RUN_PARAMS tracer and
# tracer_per_cell=1.0 (the namelist default) set in code, cut to 5 coarse
# steps (2 with oct_blocking=.false.)
TRACER_STEPS, TRACER_STENCIL_STEPS = 5, 2
# Σ_d (φ_lo − φ_hi) == Δρ on the leaf cells: the JAX package's own oracle
# (tests/test_mc_tracer_amr.py:44-73) and its f32 tolerance
FLUX_RTOL, FLUX_ATOL = 2e-4, 2e-6
# max|div B|·dx / max|B| after 20 (2D) or 10 (3D) f32 steps.  CT keeps
# div B zero in exact arithmetic; in f32 each face update rounds once per
# pair (0.5 ulp of |B|, 6e-8), four faces meet in one divergence and the
# roundings of successive steps add as a random walk: ~1e-6 after 20
# steps.  The limit leaves 7x room above that and is 5 decades below an
# O(1) error (a CT fault breaks div B at the size of the field).
DIVB_REL = 1e-5
# K4's per-cell check scales by the largest magnitude of ANY field over
# the cell's stencil, not the field's own: the CT step updates momentum
# and the transverse field by differences of fluxes built from the total
# pressure and the magnetic stress (flux_along), so their rounding (the
# FMA contraction the plain version does not do) scales with those.
# Where a momentum component crosses zero (the Orszag-Tang vortex has
# such lines), its own stencil max bounds nothing: on an H100 the kernel
# and the plain version read 1.07e-5 of it there, a -fmad=false build of
# the kernel 1.3e-6 against the plain version on the host CPU, and the
# plain version on the card 7.3e-6 against itself on the CPU (PyTorch on
# the card divides by a Python float as a multiplication by its
# reciprocal).  Against M the kernel reads 3.9e-7 (PERF.md, §6).
# LOCAL_RTOL is unchanged.


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


def _stencil_scale(x, nd: int = 3, periodic: bool = True):
    """Max of ``|x|`` over each cell's 5^nd neighbourhood, per field,
    wrapping periodically (most main paths' boxes are periodic) or
    replicating the edge cells (outflow, as the ghosts do): the magnitudes
    one MUSCL step of that cell reads."""
    import torch.nn.functional as F
    a = F.pad(x.abs()[None], (2,) * (2 * nd),
              mode="circular" if periodic else "replicate")
    pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
    return pool(a, 5, stride=1)[0]


def _ptxas_report(log: str) -> str:
    """Registers and spill stores of each kernel entry, from nvcc's
    ``-Xptxas -v`` report."""
    import re
    names = re.findall(r"Compiling entry function '([^']+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return "; ".join(f"{n}: {r} registers, {sp} B spill stores"
                     for n, r, sp in zip(names, regs, spills))


def _sweep_bytes(c: int, n: int, outs) -> int:
    """Bytes a K3 or K2 call must move for ``n`` blocks of ``(c+4)^3``
    stencil cells (K2: c = 2): each output written once, the 0-d dt, and
    only the stencil cells its outputs read.  A face reads the state, the
    slopes and the mask of the cells beside it (those one step past the
    c^3 interior, summed over the axes), and their slopes read the state of
    the cells two steps past it; no output reads the rest (at c = 2, 80
    cells' state and 32 cells' mask of 216)."""
    band = [max(2 - x, x - c - 1, 0) for x in range(c + 4)]
    far = [a + b + e for a in band for b in band for e in band]
    state, mask = sum(a <= 2 for a in far), sum(a <= 1 for a in far)
    return 4 * (n * (5 * state + mask) + 1 + sum(x.numel() for x in outs))


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
             warm: bool = True, stats: dict = None) -> str:
    """One traced run of ``run`` (after one untraced run when ``warm``):
    device kernel time by name and the device's busy share of the window;
    the trace goes to ``out_dir/name`` (not kept when ``name`` is None).
    ``stats``, when given, receives the busy microseconds, the wall
    seconds and the kernel launches of the window."""
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
    if name is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, name))
    # kernels only: an aten op's own row repeats its kernels' device time
    rows = sorted(((e.self_device_time_total, e.count,
                    e.key.replace("void ", "").replace(
                        "(anonymous namespace)::", "")[:40])
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if stats is not None:
        stats.update(busy_us=busy_us, wall_s=wall,
                     launches=sum(n for _, n, _ in rows))
    top = "; ".join(f"{k} x{n} {us / 1e3:.3f} ms" for us, n, k in rows[:8])
    ours = "; ".join(
        f"{kern} x{sum(n for _, n, k in rows if kern in k)} "
        f"{sum(us for us, _, k in rows if kern in k) / 1e3:.3f} ms "
        f"({100 * sum(us for us, _, k in rows if kern in k) / busy_us:.1f} "
        f"% of busy)"
        for kern in ("fused_muscl_kernel", "sweep_kernel", "mhd_ct_fused",
                     "halo_exchange_kernel")
        if any(kern in k for _, _, k in rows))
    return (f"device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
            f"wall ({100 * busy_us / 1e6 / wall:.1f} %), "
            f"{sum(n for _, n, _ in rows)} kernel launches; port kernels: "
            f"{ours}; top: {top}")


def _reset_counts():
    """Every kernel's launch count to 0."""
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.parallel import dma_halo
    fm.launches = fm.flux_launches = 0
    fm.padded_launches = fm.padded_flux_launches = 0
    ct_slab.launches = dma_halo.launches = 0
    for name in om.launches:
        om.launches[name] = 0


def _counts() -> dict:
    """Every kernel's launch count, the flux variants under their own
    keys (``fused_muscl_flux``, ``tile_sweep_flux``, ``oct_sweep_flux``)
    and K1's padded entry under ``fused_muscl_padded(_flux)``."""
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.parallel import dma_halo
    return {"fused_muscl": fm.launches, "fused_muscl_flux": fm.flux_launches,
            "fused_muscl_padded": fm.padded_launches,
            "fused_muscl_padded_flux": fm.padded_flux_launches,
            **om.launches, "ct_step_slab": ct_slab.launches,
            "halo_exchange": dma_halo.launches}


def _want(**n) -> dict:
    """The counts a path should show: ``n`` for the kernels named, 0 for
    every other kernel and variant."""
    return {k: n.get(k, 0) for k in _counts()}


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


def _batch_last(outs):
    """K3's tile-major arrays (``[5, N, td...]``, ``du [5, N, ...]``,
    ``corrp [5, 3, N, ...]``, ``phip [3, N, ...]``) as batch-last views,
    the layout of the JAX package and of the scales here."""
    return tuple(o.movedim(2 if i == 1 else 1, -1)
                 for i, o in enumerate(outs))


def _chunks(blk, ok, dt, cfg, dx: float, shift, want,
            timed: bool = True) -> str:
    """K3 (``shift`` an int) at every x chunk of a tile, or K2 (``shift``
    None) at every count of octs a block, that fits a block (as the launch
    reports them): bitwise equal to ``want`` (the launch's own choice) or
    raise; with ``timed`` each one's device ms."""
    import torch
    from ramses_tpu_torch.hydro import oct_muscl as om
    lib = om._library()
    n = blk.shape[1 if shift is not None else -1]
    okf = ok.to(torch.float32).contiguous()
    name = "tile_sweep" if shift is not None else "oct_sweep"
    parts = []
    for cx in om.launch_info(shift, n, cfg.riemann)["chunks"]:
        def run():
            return om.call(lib, blk, okf, dt, cfg, dx, shift, False,
                           torch.cuda.current_stream().cuda_stream, chunk=cx)
        got = run()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} at chunk {cx} is not bitwise the "
                                 f"launch's own chunk (N {n})")
        if timed:
            info = om.launch_info(shift, n, cfg.riemann, cx)
            parts.append(f"{cx}: {_device_ms(run, 'sweep_kernel'):.4f} ms "
                         f"({info['blocks_per_sm']}/SM)")
    return "bitwise equal" + (", " + ", ".join(parts) if parts else "")


def _k2_is_k3(blk, ok, dt, cfg, dx: float) -> str:
    """K2 with the mass fluxes on the octs ``blk [5, 6, 6, 6, N]`` against
    K3 at shift 0 on the same octs laid out tile-major: du and phi bitwise,
    corr bitwise the sum of K3's four face planes in K2's order (the
    kernels share their stage code), or raise."""
    from ramses_tpu_torch.hydro import oct_muscl as om
    got = om.oct_sweep(blk, ok, dt, cfg, dx, want_flux=True)
    want = om.oct_from_tiles(om.tile_sweep(
        blk.movedim(-1, 1).contiguous(), ok.movedim(-1, 0).contiguous(), dt,
        cfg, dx, 0, want_flux=True))
    for name, g, w in zip(("du", "corr", "phi"), got, want):
        if not (g.shape == w.shape and bool((g == w).all())):
            raise AssertionError(
                f"oct_sweep's {name} is not bitwise tile_sweep's at shift 0 "
                f"on the same octs: max abs difference "
                f"{float((g - w).abs().max()):.3e}")
    return "du, corr and phi bitwise K3 at shift 0 on the same octs"


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


# kernels whose device time came from queued CUDA events because the
# profiler lost their records in every window (see _device_ms)
PROFILER_LOST = []


def _device_ms(fn, kernel: str, n: int = 50, tries: int = 5,
               launched=None, lost: int = 2) -> float:
    """Device time per call of ``fn`` of the one kernel whose name holds
    ``kernel``, from ``torch.profiler`` over ``n`` calls after a warm-up:
    its mean time.  CUDA events around a call of a ~10 µs kernel measure
    the host's dispatch of the call instead.  The trace may miss a launch
    or two of a window (it missed one of 180 K4 launches once, two and
    three of 50 K3 launches with the fluxes once each), which leaves the
    mean unchanged, so the kernel must show n - ``lost`` to n launches; a
    window that shows fewer is traced again, up to ``tries`` windows.
    The trace drops the records of the first launches of a window (more
    of them late in a run: phase 24 saw 47 of 50 in every window), so each
    window opens with 20 untimed elementwise kernels and a
    synchronisation, and the timed calls come after them.  The trace has
    also lost every kernel record of a window (and of three windows in a
    row) while it held all n launch calls; where no window passes, the
    time is taken by :func:`_queued_ms` (the kernel's time and the gaps
    between launches) and the kernel is listed in ``PROFILER_LOST``,
    which ``main`` prints.  ``launched``, where given,
    reads the wrapper's launch count: the host must then have launched
    exactly n times in the window, so that what the trace lacks is the
    trace's loss, not a call that launched nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    lead = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        before = launched() if launched else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                lead.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        if launched and launched() - before != n:
            raise AssertionError(f"{launched() - before} launches of "
                                 f"{kernel} in a window of {n} calls")
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        counts = [e.count for e in rows]
        if len(rows) > 1:
            raise AssertionError(f"{len(rows)} kernels hold {kernel} in "
                                 f"their names, expected one")
        if rows and n - lost <= counts[0] <= n:
            return rows[0].self_device_time_total / counts[0] / 1e3
        seen.append(counts[0] if rows else 0)
    before = launched() if launched else None
    ms = _queued_ms(fn, n)
    if launched and launched() - before != n + 3:
        raise AssertionError(f"{launched() - before} launches of {kernel} "
                             f"in {n + 3} calls")
    PROFILER_LOST.append(f"{kernel} (records of {n} launches seen: "
                         f"{seen}; queued events {ms:.4f} ms)")
    return ms


def _host_breakdown(sim, run, parts=("_flag_and_tree", "_rebuild_maps",
                                      "_migrate_level", "_restrict_all",
                                      "coarse_dt", "step_coarse"),
                    nested=()) -> str:
    """Wall seconds of one ``run`` of an AMR coarse step split by the
    hierarchy's parts (methods of ``sim``), the device synchronised around
    each part; the ``nested`` parts run inside others and stay out of the
    remainder ("other host").  Returns (the line, seconds by part)."""
    import torch
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
    acc["other host"] = total - sum(v for k, v in acc.items()
                                    if k not in nested)
    return f"total {total:.4f} s: " + ", ".join(
        f"{k.strip('_')} {v:.4f}" for k, v in acc.items()), acc


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
    k2_octs = {}                       # N -> (the launch's octs a block,
                                       #       the counts that fit)
    for i, (rs, st) in enumerate((rs, st) for rs in ("llf", "hllc")
                                 for st in (1, 2, 8)):
        cfg = HydroStatic(ndim=3, riemann=rs, slope_type=st)
        masked = i % 2 == 0
        for name, side, n, shift in K3_CASES[i % 2] + (
                ("oct_sweep", 6, K2_N[i], None),):
            # K3 takes the tile-major batch [5, N, td, td, td], K2 the
            # batch-last [5, 6, 6, 6, N]
            shape = ((n,) + (side,) * 3 if shift is not None
                     else (side,) * 3 + (n,))
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
            if shift is None:
                info = om.launch_info(None, n, rs)
                _chunks(u, ok, dt, cfg, 1.0 / 64, None, got, False)
                k2_octs[n] = (info["chunk"], len(info["chunks"]))
    _print(f"phase 7 AMR kernel check: {ncase} cases (K3 (shift, N) "
           f"{sorted({(c[3], c[2]) for k in K3_CASES for c in k})}; K2 N "
           f"{list(K2_N)}) pass; max abs err tile_sweep "
           f"{worst['tile_sweep']:.3e}, oct_sweep {worst['oct_sweep']:.3e}; "
           f"K2 bitwise at every count of octs a block that fits (N: the "
           f"launch's count, the counts that fit) {k2_octs}")

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
    want = _want(fused_muscl=len(stepped),
                 tile_sweep=sum(2 ** (l - lmin) for lv in stepped for l in lv
                                if l > lmin))
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
                blk = K._gather_tiles(sim.u[l], interp, d["tile_src"],
                                      d["tile_vsgn"], cfg, td)
                ok = d["tile_ok"].reshape(blk.shape[1:]).to(torch.float32)
                extra, keep = (shift,), c_ ** 3 / td ** 3
                n, as_last = blk.shape[1], _batch_last
            else:
                interp = K.interp_cells(sim.u[l - 1], d["interp_cell"],
                                        d["interp_nb"], d["interp_sgn"], cfg)
                blk = K._gather_uloc(sim.u[l], interp, d["stencil_src"],
                                     d["vsgn"], cfg)
                ok = K._block_mask(d["ok_ref"], 6, 3).to(torch.float32)
                extra, keep = (), 8 / 216
                n, as_last = blk.shape[-1], tuple
            kern = getattr(om, name)
            plain = getattr(om, name + "_ref")
            got = kern(blk, ok, dt, cfg, dx, *extra)
            want = plain(blk, ok, dt, cfg, dx, *extra)
            torch.cuda.synchronize()
            scales = _output_scales(as_last((blk,))[0],
                                    c_ if name == "tile_sweep" else 2,
                                    name == "tile_sweep")
            err, rel, ex = _local_check(as_last(got), as_last(want), scales)
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
            nbytes = _sweep_bytes(c_ if name == "tile_sweep" else 2, n, got)
            # the plain version computes on the whole block; the kernel's
            # work is the interior's share of it
            nops = _count_ops(lambda: plain(blk, ok, dt, cfg, dx, *extra)) \
                * keep
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * nops / F32_OPS_PER_S
            if name == "tile_sweep":
                info = om.launch_info(shift, n, cfg.riemann)
                launch = (f"{info['blocks']} blocks of "
                          f"{info['threads']} threads, chunk "
                          f"{info['chunk']} of {c_} planes, "
                          f"{info['smem_bytes']} B shared, "
                          f"{info['blocks_per_sm']} blocks/SM, "
                          f"{info['registers']} registers, "
                          f"{info['local_bytes']} B local; every chunk "
                          + _chunks(blk, ok, dt, cfg, dx, shift, got))
            else:
                info = om.launch_info(None, n, cfg.riemann)
                launch = (f"{info['blocks']} blocks of {info['threads']} "
                          f"threads, {info['chunk']} octs a block, "
                          f"{info['smem_bytes']} B shared, "
                          f"{info['blocks_per_sm']} blocks/SM, "
                          f"{info['registers']} registers, "
                          f"{info['local_bytes']} B local; every count of "
                          f"octs a block "
                          + _chunks(blk, ok, dt, cfg, dx, None, got)
                          + "; with the mass fluxes "
                          + _k2_is_k3(blk, ok, dt, cfg, dx))
            rows[(name, l)] = dict(ms=ms, plain_ms=pms, err=err,
                                   bound_ms=max(bytes_ms, ops_ms),
                                   bound_by=("bytes" if bytes_ms >= ops_ms
                                             else "operations"))
            lines.append(f"{name} level {l} N={n} ({launch}): "
                         f"{ms:.4f} ms/launch on the device (profiler), "
                         f"{call_ms:.4f} ms a wrapper call (CUDA events), "
                         f"plain {pms:.4f} ms, bound "
                         f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes / 1e6:.3f}"
                         f" MB -> {bytes_ms:.5f} ms; {nops / 1e9:.4f} G ops "
                         f"-> {ops_ms:.5f} ms), max abs err {err:.3e}, err / "
                         f"stencil max (du/faces) {rel}")
    # K3's chunk choice at larger batches: random tiles, a fifth refined
    rng = np.random.default_rng(10)
    for n in K3_CHOICE_N:
        blk = torch.from_numpy(_random_state((n,) + (td,) * 3, cfg.gamma,
                                             100 + n)).to(dev)
        ok = torch.from_numpy((rng.random((n,) + (td,) * 3) < 0.2)
                              .astype(np.float32)).to(dev)
        dt = torch.tensor(dtc / 4, dtype=torch.float32, device=dev)
        got = om.tile_sweep(blk, ok, dt, cfg, sim.dx(lmin + 2), shift)
        torch.cuda.synchronize()
        chunk = om.launch_info(shift, n, cfg.riemann)["chunk"]
        lines.append(f"tile_sweep on {n} random tiles: the launch takes "
                     f"chunk {chunk}; every chunk "
                     + _chunks(blk, ok, dt, cfg, sim.dx(lmin + 2), shift,
                                  got))
    del blk, ok, got
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
    # u and the mask read once, un written once, dt
    nbytes7 = 4 * (2 * ud.numel() + ok7.numel() + 1)
    nops7 = _count_ops(lambda: fm.fused_step_ref(*args7, ok=ok7))
    b7, o7 = 1e3 * nbytes7 / HBM_BYTES_PER_S, 1e3 * nops7 / F32_OPS_PER_S
    lines.append(f"fused_muscl level {lmin} {tuple(shape7)} with "
                 f"{int(ok7.sum())} refined cells: {ms7:.4f} ms/launch on "
                 f"the device (profiler), bound {max(b7, o7):.4f} ms by "
                 f"{'bytes' if b7 >= o7 else 'operations'} "
                 f"({nbytes7 / 1e6:.3f} MB -> {b7:.4f} ms; "
                 f"{nops7 / 1e9:.4f} G ops -> {o7:.4f} ms), "
                 f"{100 * max(b7, o7) / ms7:.1f} % of the bound, max abs err "
                 f"{err7:.3e}, err / stencil max per field "
                 f"{[f'{x:.3e}' for x in rel7]}")
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
    walls, _ = _host_breakdown(sim, coarse_step)
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

def _ct_check(got, want, nd: int, periodic: bool = True):
    """K4 against its plain version at a main path's state, each value
    within ``LOCAL_ATOL + LOCAL_RTOL * M``: M the largest magnitude of any
    field over the cell's 5^nd stencil (the K4 note beside DIVB_REL), a
    face the larger of the two cells it touches (the first cell's own on
    an outflow box's low edge).  Returns (max abs err, worst err / M of un
    and bfn, tolerance excess, a line of readings that also holds each
    field of un against its own stencil max)."""
    import torch
    own = _stencil_scale(want[0], nd, periodic)
    cell = own.amax(dim=0)

    def low(c):                    # the cell below each face along c
        if periodic:
            return cell.roll(1, dims=c)
        return torch.cat([cell.narrow(c, 0, 1),
                          cell.narrow(c, 0, cell.shape[c] - 1)], dim=c)
    scale_b = torch.stack([torch.maximum(cell, low(c))
                           if c < nd else cell for c in range(3)])
    err, rels, excess = _local_check(got, want,
                                     (cell.expand_as(want[0]), scale_b))
    per_field = [float(torch.where(own[c] > LOCAL_ATOL / LOCAL_RTOL,
                                   (got[0][c] - want[0][c]).abs()
                                   / own[c], 0.0).max())
                 for c in range(want[0].shape[0])]
    readings = (f"max abs err {err:.3e}, worst err / M (un/bfn) "
                f"{rels[0]:.3e}/{rels[1]:.3e}; per field of un against "
                f"its own stencil max {[f'{x:.2e}' for x in per_field]}; "
                f"tolerance excess {excess:.3e}")
    return err, rels, excess, readings


# The HLLD selection of the plain version forms, for each of a face's 8
# components, all four intermediate fluxes (F*L, F*R, F**L, F**R: 3
# operations each) and a 5-deep compare and select chain (10); a kernel
# needs 5 compares a face and, a component, the selected flux (6
# operations at most) and one select.
HLLD_SELECT_EXCESS = 8 * (4 * 3 + 5 + 5) - (5 + 8 * (6 + 1))


# The Roe solvers' work that the trace does not see: the plain version's
# torch.linalg.solve (one library call) and its two einsums (bmm).  The
# 7x7 solve by elimination with partial pivoting: the LU factorisation 91
# multiply-adds and 21 divisions (about 203 operations), the two
# triangular solves on the right-hand side about 91: ~300 a solve.  Then
# R (|lam| alpha), 49 multiply-adds (98), and for a face M applied by its
# rows (32); a corner reads row 5 alone (14 and one scale).
ROE_SOLVE_OPS = 300
ROE_FACE_CONTRACT_OPS = 98 + 32
ROE_CORNER_CONTRACT_OPS = 15


def _ct_ops(plain, cfg, npad: int, ncell: int) -> float:
    """The operations a CT step of ``ncell`` interior cells needs: the
    plain version's traced count on the padded box (``npad`` cells, one
    face solve a direction a cell) less what its HLLD selection evaluates
    and the selected flux does not need, plus the Roe solves' untraced
    work (one a face for the Roe 1D solver, two an edge for the Roe
    corner), scaled to the interior."""
    nops = _count_ops(plain)
    if cfg.riemann == "hlld":
        nops -= HLLD_SELECT_EXCESS * cfg.ndim * npad
    if cfg.riemann == "roe":
        nops += (ROE_SOLVE_OPS + ROE_FACE_CONTRACT_OPS) * cfg.ndim * npad
    if cfg.riemann2d == "roe" and cfg.ndim >= 2:
        npair = 3 if cfg.ndim == 3 else 1
        nops += 2 * (ROE_SOLVE_OPS + ROE_CORNER_CONTRACT_OPS) * npair * npad
    return nops * ncell / npad


def _mhd_box(sp, seed: int, masked: bool, dev, npassive: int = 0):
    """A random padded MHD box on the card for K4's check: (up [8 +
    npassive, sp+4], bfp_ext [3, sp+6], okp, ovr) with density, pressure
    and faces of order one and a random refined mask and EMF override
    (none in 1D: no edges) when ``masked``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nd = len(sp)
    spp = tuple(n + 4 for n in sp)
    spe = tuple(n + 6 for n in sp)
    r = 1.0 + 0.3 * rng.random(spp)
    v = 0.2 * rng.standard_normal((3,) + spp)
    p = 0.5 + 0.2 * rng.random(spp)
    e = p / (2.0 / 3.0) + 0.5 * r * (v ** 2).sum(axis=0) + 0.2
    up = np.stack([r, r * v[0], r * v[1], r * v[2], e,
                   *np.zeros((3,) + spp)])
    bf = 0.3 + 0.2 * rng.standard_normal((3,) + spe)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    okp = ovr = None
    if masked:
        okp = torch.from_numpy(rng.random(spp) < 0.15).to(dev)
        ovr = {(a, b): (torch.from_numpy(rng.random(spp) < 0.2).to(dev),
                        t(0.05 * rng.standard_normal(spp)))
               for a in range(nd) for b in range(a + 1, nd)} or None
    if npassive:
        up = np.concatenate([up, r * rng.random((npassive,) + spp)])
    return t(up), t(bf), okp, ovr


def _orszag_tang(n: int):
    """The exact Orszag-Tang vortex at n² as ``tests/test_mhd.py:224-257``
    builds it (f64 numpy): (u [8, n, n], bf [3, n, n]), the staggered
    faces from the corner vector potential Az, so div B is zero to
    roundoff."""
    import numpy as np
    dx = 1.0 / n
    gamma = 5.0 / 3.0
    d0 = 25.0 / (36.0 * np.pi)
    p0 = 5.0 / (12.0 * np.pi)
    b0 = 1.0 / np.sqrt(4.0 * np.pi)
    xc = (np.arange(n) + 0.5) * dx
    X, Y = np.meshgrid(xc, xc, indexing="ij")
    vx, vy = -np.sin(2 * np.pi * Y), np.sin(2 * np.pi * X)
    xf = np.arange(n) * dx
    Xf, Yf = np.meshgrid(xf, xf, indexing="ij")
    Az = (b0 / (4 * np.pi) * np.cos(4 * np.pi * Xf)
          + b0 / (2 * np.pi) * np.cos(2 * np.pi * Yf))
    bfx = (np.roll(Az, -1, 1) - Az) / dx          # Bx = dAz/dy at x-faces
    bfy = -(np.roll(Az, -1, 0) - Az) / dx         # By = -dAz/dx at y-faces
    bf = np.stack([bfx, bfy, np.zeros((n, n))])
    bcx = 0.5 * (bfx + np.roll(bfx, -1, 0))
    bcy = 0.5 * (bfy + np.roll(bfy, -1, 1))
    u = np.zeros((8, n, n))
    u[0] = d0
    u[1], u[2] = d0 * vx, d0 * vy
    u[5], u[6] = bcx, bcy
    u[4] = (p0 / (gamma - 1.0) + 0.5 * d0 * (vx ** 2 + vy ** 2)
            + 0.5 * (bcx ** 2 + bcy ** 2))
    return u, bf


def _divb_rel(sim) -> float:
    """max|div B|·dx / max|B| of an MHD simulation's staggered field."""
    return float(sim.max_divb()) * sim.dx / float(sim.bf.abs().max())


def _degenerate_field_check(dev):
    """Phase 12b: K4 at the Roe mean's degenerate field limits, a field of
    zero and a uniform Bx alone (bn = 0 on the other faces; the transverse
    field is then only what the predictor makes, and crosses zero).  Where
    the transverse field of a Roe mean nearly vanishes the flux turns on
    its direction (b1h, b2h = bt / |bt|), so two f32 evaluations of the
    JAX formulation, K4 and its plain version, each read up to ~2e-5 from
    the f64 one at such faces, at different faces, while R stays well
    conditioned.  The elementwise table cannot hold there (the plain f32
    version misses it against f64 too), so these cases are reported, not
    held to it: K4 against the plain f32 and f64 versions, the plain f32
    against f64, and the condition number of R at the worst cell's faces
    and edges.  They must be finite."""
    import torch
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import roe as roemod
    from ramses_tpu_torch.mhd.core import MhdStatic
    lines = []
    cases = [(sp, rs, r2, bx) for sp, rs, r2 in (
        ((256,), "roe", "average"), ((64, 64), "roe", "roe"),
        ((64, 64), "hlld", "hlld"), ((16, 16, 16), "roe", "hlld"))
        for bx in (0.0, 0.5)]
    eigvec = roemod._right_eigenvectors
    for i, (sp, rs, r2, bx) in enumerate(cases):
        nd = len(sp)
        cfg = MhdStatic(ndim=nd, riemann=rs, riemann2d=r2)
        up, bfp, _, _ = _mhd_box(sp, 1100 + i, False, dev)
        bfp.zero_()
        bfp[0] = bx
        dt = torch.tensor(2e-3, dtype=torch.float32, device=dev)
        dx = (1.0 / sp[0],) * nd
        got = ct_slab.ct_step_slab(up, bfp, dt, dx, cfg)
        want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg)
        conds = []

        def recorded(m):
            lams, R = eigvec(m)
            rb = torch.movedim(R.reshape(7, 7, -1), -1, 0)
            conds.append(torch.linalg.cond(rb).reshape(R.shape[2:]))
            return lams, R
        roemod._right_eigenvectors = recorded
        try:
            exact = ct_slab.ct_step_slab_ref(up.double(), bfp.double(),
                                             dt.double(), dx, cfg)
        finally:
            roemod._right_eigenvectors = eigvec
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"ct_step_slab is not finite at a "
                                 f"degenerate field: {sp} {rs}/{r2} "
                                 f"Bx={bx}")
        dk = torch.stack([(g.double() - e).abs().amax(dim=0)
                          for g, e in zip(got, exact)]).amax(dim=0)
        err_k = float(dk.max())
        err_p = max(float((w.double() - e).abs().max())
                    for w, e in zip(want, exact))
        f32_err, f32_ex = _pair_check(got, want)
        line = (f"{sp} {rs}/{r2} Bx={bx}: K4 {err_k:.3e} and plain "
                f"{err_p:.3e} from f64, K4 against plain {f32_err:.3e} "
                f"(table excess {f32_ex:.3e})")
        if conds:
            # the worst cell in padded coordinates, with its neighbours
            # along each axis: the faces and edges its step reads
            at = [int(x) + 2 for x in
                  torch.unravel_index(dk.argmax(), dk.shape)]
            near = tuple(slice(a - 1, a + 2) for a in at)
            line += (f", cond(R) at the worst cell's faces and edges "
                     f"{max(float(c[near].max()) for c in conds):.3e} "
                     f"(box max {max(float(c.max()) for c in conds):.3e})")
        lines.append(line)
    _print("phase 12b K4 at the Roe mean's degenerate field limits "
           "(reported, not held to the table: the f32 formulation reads "
           "~1e-5 from f64 there): " + "; ".join(lines))


def _solenoidal_3d(dev, riemann: str, riemann2d: str):
    """The 3D MHD run at 128³: a uniform region (``&INIT_PARAMS`` set in
    code) plus random solenoidal faces from a staggered vector potential,
    periodic, f32 on the card."""
    import numpy as np
    import torch
    from ramses_tpu_torch.config import params_from_dict
    from ramses_tpu_torch.mhd.core import IBX, IP
    from ramses_tpu_torch.mhd.driver import MhdSimulation
    n3 = 2 ** MHD3D_LEVEL
    groups = {
        "run_params": {"hydro": True},
        "amr_params": {"levelmin": MHD3D_LEVEL, "levelmax": MHD3D_LEVEL,
                       "boxlen": 1.0},
        "init_params": {"nregion": 1, "region_type": ["square"],
                        "x_center": [0.5], "y_center": [0.5],
                        "z_center": [0.5], "length_x": [10.0],
                        "length_y": [10.0], "length_z": [10.0],
                        "exp_region": [10.0], "d_region": [1.0],
                        "p_region": [1.0], "u_region": [0.5],
                        "v_region": [-0.3], "w_region": [0.2],
                        "A_region": [0.3], "B_region": [0.4],
                        "C_region": [0.5]},
        "hydro_params": {"gamma": 5.0 / 3.0, "riemann": riemann,
                         "riemann2d": riemann2d, "courant_factor": 0.8},
        "output_params": {"tend": 1.0},
    }
    sim3 = MhdSimulation(params_from_dict(groups, ndim=3))
    rng = np.random.default_rng(0)
    ax, ay, az = rng.standard_normal((3, n3, n3, n3))
    # faces from a staggered vector potential: solenoidal to roundoff, of
    # rms ~0.1 beside the uniform field
    bfx = (np.roll(az, -1, 1) - az) - (np.roll(ay, -1, 2) - ay)
    bfy = (np.roll(ax, -1, 2) - ax) - (np.roll(az, -1, 0) - az)
    bfz = (np.roll(ay, -1, 0) - ay) - (np.roll(ax, -1, 1) - ax)
    bfn3 = sim3.bf.cpu().double().numpy() + 0.05 * np.stack([bfx, bfy, bfz])
    del ax, ay, az, bfx, bfy, bfz
    u3 = sim3.u.cpu().double().numpy()
    bc = [0.5 * (bfn3[c] + np.roll(bfn3[c], -1, axis=c)) for c in range(3)]
    for c in range(3):
        u3[IBX + c] = bc[c]
    u3[IP] = 1.0 / (5.0 / 3.0 - 1.0) + 0.5 * (
        u3[1] ** 2 + u3[2] ** 2 + u3[3] ** 2) / u3[0] + 0.5 * sum(
        b ** 2 for b in bc)
    sim3.u = torch.tensor(u3, dtype=torch.float32, device=dev)
    sim3.bf = torch.tensor(bfn3, dtype=torch.float32, device=dev)
    del u3, bfn3, bc
    return sim3


def _mhd_phases(dev):
    """Phases 12-17 (the MHD slice); returns K4's row of the kernels
    line."""
    import torch
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import uniform as mu
    from ramses_tpu_torch.mhd.core import MhdStatic
    from ramses_tpu_torch.mhd.driver import MhdSimulation

    # ---- 12. K4 against its plain version on random boxes ----
    worst = {"max_abs_err": 0.0, "excess": -1.0}
    ncase = 0
    for sp in MHD_CHECK_SHAPES:
        nd = len(sp)
        combos = [(rs, r2, st) for rs in ("llf", "hll", "hlld")
                  for r2 in ("average", "llf") for st in (1, 2, 8)]
        for i, (rs, r2, st) in enumerate(combos):
            cfg = MhdStatic(ndim=nd, riemann=rs, riemann2d=r2,
                            slope_type=st)
            masked = i % 2 == 1
            up, bfp, okp, ovr = _mhd_box(sp, 300 + 50 * nd + i, masked, dev)
            dt = torch.tensor(2e-3, dtype=torch.float32, device=dev)
            dx = (1.0 / sp[0],) * nd
            got = ct_slab.ct_step_slab(up, bfp, dt, dx, cfg, okp=okp,
                                       ovr=ovr)
            want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp,
                                            ovr=ovr)
            torch.cuda.synchronize()
            err, ex = _pair_check(got, want)
            if not (ex <= 0.0 and all(bool(torch.isfinite(g).all())
                                      for g in got)):
                raise AssertionError(
                    f"ct_step_slab disagrees with its plain version: {sp} "
                    f"riemann={rs} riemann2d={r2} slope_type={st} "
                    f"masked={masked}: max abs err {err:.3e}, tolerance "
                    f"excess {ex:.3e}")
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            worst["excess"] = max(worst["excess"], ex)
            ncase += 1
            del up, bfp, okp, ovr, got, want
    # the whole scope: 1D with each solver; 2D with each (solver, corner)
    # pair, plain and with a mask and an override; 3D with each corner
    # and each solver; slope types 0/1/2/7/8 in turn; passive scalars
    solvers = ("llf", "hll", "hlld", "roe", "upwind")
    corners = ("average", "llf", "roe", "upwind", "hll", "hlla", "hlld")
    slopes = (0, 1, 2, 7, 8)
    matrix = [((256,), rs, "average", slopes[i], i % 2 == 1, i % 2)
              for i, rs in enumerate(solvers)]
    matrix += [((64, 64), rs, r2, slopes[(i + j) % 5], masked,
                int(masked and j == 6))
               for i, rs in enumerate(solvers)
               for j, r2 in enumerate(corners) for masked in (False, True)]
    matrix += [((16, 16, 16), solvers[j % 5], r2, slopes[j % 5], j % 2 == 0,
                int(j == 2)) for j, r2 in enumerate(corners)]
    # ragged against K4's tiles (2D 126 columns, 3D 12 x 16 columns) on
    # every axis, two or more of them an axis; their row chunks below
    ragged = [((70, 131), "hlld", "hlld", 1, True, 2),
              ((34, 13, 20), "roe", "llf", 2, True, 2)]
    matrix += ragged
    by_kind = {}
    for i, (sp, rs, r2, st, masked, npas) in enumerate(matrix):
        nd = len(sp)
        cfg = MhdStatic(ndim=nd, riemann=rs, riemann2d=r2, slope_type=st,
                        npassive=npas)
        up, bfp, okp, ovr = _mhd_box(sp, 900 + i, masked, dev, npas)
        dt = torch.tensor(2e-3, dtype=torch.float32, device=dev)
        dx = (1.0 / sp[0],) * nd
        got = ct_slab.ct_step_slab(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
        want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp,
                                        ovr=ovr)
        torch.cuda.synchronize()
        err, ex = _pair_check(got, want)
        if not (ex <= 0.0 and all(bool(torch.isfinite(g).all())
                                  for g in got)):
            raise AssertionError(
                f"ct_step_slab disagrees with its plain version: {sp} "
                f"riemann={rs} riemann2d={r2} slope_type={st} npassive="
                f"{npas} masked={masked}: max abs err {err:.3e}, "
                f"tolerance excess {ex:.3e}")
        if (sp, rs, r2, st, masked, npas) in ragged:
            # rows chunked against the box through the C entry: the same
            # bits as the kernel's own chunk
            pairs = sorted(ovr)
            args = (okp.to(torch.float32),
                    torch.stack([ovr[p][0].to(torch.float32) for p in pairs]),
                    torch.stack([ovr[p][1] for p in pairs]),
                    torch.cuda.current_stream().cuda_stream)
            for chunk in (3, 7):
                again = ct_slab.call(ct_slab._library(), up, bfp, dt, dx, cfg,
                                     *args, chunk)
                if not all(torch.equal(a, g) for a, g in zip(again, got)):
                    raise AssertionError(f"ct_step_slab {sp} {rs}/{r2}: "
                                         f"chunk {chunk} changes the bits")
        key = f"{nd}D {rs}/{r2 if nd > 1 else '-'}"
        by_kind[key] = max(by_kind.get(key, 0.0), err)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["excess"] = max(worst["excess"], ex)
        ncase += 1
        del up, bfp, okp, ovr, got, want
    _print(f"phase 12 MHD kernel check: {ncase} cases pass (2D 256², 3D "
           f"64³: llf/hll/hlld × average/llf × slope 1/2/8, half masked "
           f"with an EMF override; 1D 256 each solver; 2D 64² each of the "
           f"5 × 7 solver and corner pairs, plain and masked; 3D 16³ each "
           f"corner and solver; 2D 70 x 131 and 3D 34 x 13 x 20, ragged "
           f"against the tiles, bitwise at row chunks of 3 and 7; slope "
           f"types 0/1/2/7/8 in turn, passive "
           f"scalars in {sum(m[5] > 0 for m in matrix)} of them); max abs err "
           f"{worst['max_abs_err']:.3e}, worst tolerance excess "
           f"{worst['excess']:.3e}; max abs err by kind "
           f"{ {k: float(f'{v:.3e}') for k, v in by_kind.items()} }")

    _degenerate_field_check(dev)

    # ---- 13. the MHD main path: Orszag-Tang at 2048² ----
    p = load_params(OT_NML, ndim=2)
    p.amr.levelmin = p.amr.levelmax = OT_LEVEL
    n = 2 ** OT_LEVEL
    t0 = time.perf_counter()
    sim = MhdSimulation(p)
    u0, bf0 = _orszag_tang(n)
    sim.u = torch.tensor(u0, dtype=torch.float32, device=dev)
    sim.bf = torch.tensor(bf0, dtype=torch.float32, device=dev)
    del u0, bf0
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tot0 = {k: float(v) for k, v in sim.totals().items() if k != "momentum"}
    divb0 = _divb_rel(sim)
    if not ct_slab.supports(sim.cfg, sim.grid.shape, sim.u.dtype):
        raise AssertionError(f"Orszag-Tang is outside K4's gate: {sim.cfg}")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim.evolve(nstepmax=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    tot1 = {k: float(v) for k, v in sim.totals().items() if k != "momentum"}
    divb1 = _divb_rel(sim)
    want = _want(ct_step_slab=sim.nstep)
    if sim.nstep != 20 or sim.grid.shape != (n, n):
        raise AssertionError(f"MHD main path ran {sim.nstep} steps at "
                             f"{sim.grid.shape}, expected 20 at {n}²")
    if launches != want:
        raise AssertionError(f"MHD main path launched {launches}, "
                             f"expected {want}")
    if not (bool(torch.isfinite(sim.u).all())
            and bool(torch.isfinite(sim.bf).all())):
        raise AssertionError("MHD main path state is not finite")
    for k in ("mass", "energy"):
        if abs(tot1[k] - tot0[k]) > 1e-5 * abs(tot0[k]):
            raise AssertionError(f"MHD {k} not conserved: {tot0[k]} -> "
                                 f"{tot1[k]}")
    if not divb1 <= DIVB_REL:
        raise AssertionError(f"MHD div B grew: max|div B|·dx/max|B| "
                             f"{divb0:.3e} -> {divb1:.3e}")
    ncell = sim.grid.ncell
    u, bf = sim.u, sim.bf
    t = torch.tensor(sim.t, dtype=torch.float64, device=dev)
    nsteps = 20
    step_ms = _median_ms(lambda: mu.run_steps(sim.grid, u, bf, t, 1e30,
                                              nsteps),
                         reps=5, warm=1) / nsteps
    _print(f"phase 13 MHD main path: Orszag-Tang {sim.grid.shape} "
           f"(orszag2d.nml, riemann={sim.cfg.riemann} "
           f"riemann2d={sim.cfg.riemann2d} slope_type="
           f"{sim.cfg.slope_type}), {sim.nstep} steps t={sim.t:.6e}, "
           f"launches {launches}; mass {tot0['mass']:.9e} -> "
           f"{tot1['mass']:.9e}, energy {tot0['energy']:.9e} -> "
           f"{tot1['energy']:.9e}; max|div B|·dx/max|B| {divb0:.3e} -> "
           f"{divb1:.3e} (limit {DIVB_REL:.0e}); set-up {init_s:.3f} s, "
           f"evolve {wall:.4f} s = {sim.cell_updates / wall:.4e} "
           f"cell-updates/s (first chunk included); run_steps x{nsteps}: "
           f"{step_ms:.4f} ms/step = {ncell / (step_ms * 1e-3):.4e} "
           f"cell-updates/s")

    # ---- 14. K4 at the main path's data ----
    cfg = sim.cfg
    dx = (sim.dx, sim.dx)
    up = mu._pad(u, 2, sim.grid.bc_kinds)
    bfp = mu._pad(bf, 2, sim.grid.bc_kinds, mu.NGHOST + 1)
    dt = mu.cfl_dt(sim.grid, u, bf)                # the next step's dt
    got = ct_slab.ct_step_slab(up, bfp, dt, dx, cfg)
    want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg)
    torch.cuda.synchronize()
    err, _, excess, readings = _ct_check(got, want, 2)
    if not excess <= 0.0:
        raise AssertionError(f"ct_step_slab disagrees with its plain "
                             f"version on the Orszag-Tang state: {readings}")
    del got, want
    kern = lambda: ct_slab.ct_step_slab(up, bfp, dt, dx, cfg)  # noqa: E731
    plain = lambda: ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg)  # noqa
    ms = _device_ms(kern, "mhd_ct_fused", n=30)
    call_ms = _median_ms(kern, reps=30)
    torch.cuda.reset_peak_memory_stats()
    plain_ms = _median_ms(plain, reps=10)
    plain_peak = torch.cuda.max_memory_allocated()
    # the least bytes: the five hydro fields of up (its B slots are not
    # read: the cell field is the face average), the faces and dt in, the
    # 8 + 3 interior fields out
    nbytes = 4 * (5 * up[0].numel() + bfp.numel() + 1 + 8 * ncell
                  + 3 * ncell)
    nops = _ct_ops(plain, cfg, up[0].numel(), ncell)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    _print(f"phase 14 K4 at the main path's data {tuple(u.shape[1:])}: "
           f"ct_step_slab {ms:.4f} ms/call on the device (profiler, one "
           f"kernel a call), {call_ms:.4f} ms a wrapper call (CUDA "
           f"events), {100 * bound_ms / ms:.1f} % of the bound; "
           f"{_k4_launch(cfg)}; plain version {plain_ms:.4f} ms (peak "
           f"{plain_peak / 2**30:.2f} GiB), bound {bound_ms:.4f} ms by "
           f"{bound_by} ({nbytes / 1e9:.4f} GB -> {bytes_ms:.4f} ms; "
           f"{nops / 1e9:.4f} G ops -> {ops_ms:.4f} ms); against plain: "
           f"{readings}; library call: none (no single PyTorch call "
           f"computes a CT step)")
    del up, bfp

    # ---- 15. profile ----
    prof = _profile(lambda: mu.run_steps(sim.grid, u, bf, t, 1e30, 10),
                    os.path.join(ROOT, "chiprun_out"),
                    "chip_smoke_mhd_trace.json")
    _print(f"phase 15 profile MHD run_steps x10 at {n}²: {prof}")
    k4_launches = launches["ct_step_slab"]
    del sim, u, bf, t
    torch.cuda.empty_cache()

    # ---- 16. 3D: 128³ with a random solenoidal field ----
    sim3 = _solenoidal_3d(dev, "hlld", "llf")
    dx3 = sim3.dx
    m0 = float(sim3.totals()["mass"])
    d0 = _divb_rel(sim3)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim3.evolve(nstepmax=10)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    l3 = _counts()
    d1 = _divb_rel(sim3)
    m1 = float(sim3.totals()["mass"])
    if sim3.nstep != 10 or l3 != _want(ct_step_slab=10):
        raise AssertionError(f"3D MHD ran {sim3.nstep} steps, launched "
                             f"{l3}")
    if not (bool(torch.isfinite(sim3.u).all()) and d1 <= DIVB_REL
            and abs(m1 - m0) <= 1e-5 * abs(m0)):
        raise AssertionError(f"3D MHD: finite "
                             f"{bool(torch.isfinite(sim3.u).all())}, "
                             f"div B {d0:.3e} -> {d1:.3e}, mass {m0} -> "
                             f"{m1}")
    up3 = mu._pad(sim3.u, 3, sim3.grid.bc_kinds)
    bfp3 = mu._pad(sim3.bf, 3, sim3.grid.bc_kinds, mu.NGHOST + 1)
    dt3 = mu.cfl_dt(sim3.grid, sim3.u, sim3.bf)
    got = ct_slab.ct_step_slab(up3, bfp3, dt3, (dx3,) * 3, sim3.cfg)
    want = ct_slab.ct_step_slab_ref(up3, bfp3, dt3, (dx3,) * 3, sim3.cfg)
    torch.cuda.synchronize()
    err3, _, excess3, readings3 = _ct_check(got, want, 3)
    del got, want
    if not excess3 <= 0.0:
        raise AssertionError(f"ct_step_slab disagrees with its plain "
                             f"version on the 3D state: {readings3}")
    ms3 = _device_ms(lambda: ct_slab.ct_step_slab(
        up3, bfp3, dt3, (dx3,) * 3, sim3.cfg), "mhd_ct_fused", n=10)
    _print(f"phase 16 MHD 3D {sim3.grid.shape} solenoidal (hlld, llf "
           f"corners): {sim3.nstep} steps t={sim3.t:.6e}, launches {l3}, "
           f"max|div B|·dx/max|B| {d0:.3e} -> {d1:.3e}, mass {m0:.9e} -> "
           f"{m1:.9e}; evolve {wall3:.4f} s = "
           f"{sim3.cell_updates / wall3:.4e} cell-updates/s; "
           f"ct_step_slab {ms3:.4f} ms/call on the device (one kernel a "
           f"call; {_k4_launch(sim3.cfg)}); against plain on the final "
           f"state: {readings3}")
    del sim3, up3, bfp3
    torch.cuda.empty_cache()

    # ---- 16b. 3D 128³ with HLLD corners on all three EMF pairs ----
    rows = [_mhd_variant_3d(dev)]
    torch.cuda.empty_cache()

    # ---- 16c, 16d. Orszag-Tang 2048² with the HLLD and Roe corners ----
    for rs, r2, tag in (("hlld", "hlld", "16c"), ("roe", "roe", "16d")):
        rows.append(_mhd_variant_ot(dev, rs, r2, tag))
        torch.cuda.empty_cache()

    # ---- 17. BASELINE config 4: tube_mhd.nml through K4 ----
    rows.append(_tube_phase(dev))

    return {
        "name": "ct_step_slab",
        "route": "cuda",
        "source": "ramses_tpu_torch/csrc/mhd_ct.cu",
        "replaces": "ramses_tpu/mhd/pallas_ct.py:126",
        "launches": k4_launches + sum(r["launches"] for r in rows),
        "max_abs_err": max([worst["max_abs_err"], err, err3]
                           + [r["max_abs_err"] for r in rows]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "variants": [{k: r[k] for k in ("name", "launches", "ms",
                                          "plain_ms", "bound_ms",
                                          "bound_by")} for r in rows],
    }


def _k4_at(sim, periodic: bool = True, n: int = 30):
    """K4 against its plain version at an MHD run's state (the next step's
    dt), cell by cell (``_ct_check``); its device ms a call, the plain
    version's ms and the bound.  Returns a dict and a line."""
    import torch
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import uniform as mu
    cfg, nd = sim.cfg, sim.cfg.ndim
    dx = (sim.dx,) * nd
    up = mu._pad(sim.u, nd, sim.grid.bc_kinds)
    bfp = mu._pad(sim.bf, nd, sim.grid.bc_kinds, mu.NGHOST + 1)
    dt = mu.cfl_dt(sim.grid, sim.u, sim.bf)

    def kern():
        return ct_slab.ct_step_slab(up, bfp, dt, dx, cfg)

    def plain():
        return ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, _, excess, readings = _ct_check(got, want, nd, periodic)
    if not excess <= 0.0:
        raise AssertionError(f"ct_step_slab disagrees with its plain "
                             f"version at the {cfg.riemann}/"
                             f"{cfg.riemann2d} {sim.grid.shape} state: "
                             f"{readings}")
    del got, want
    ms = _device_ms(kern, "mhd_ct_fused", n=n)
    plain_ms = _median_ms(plain, reps=5, warm=1)
    ncell = sim.grid.ncell
    nbytes = 4 * (5 * up[0].numel() + bfp.numel() + 1 + 8 * ncell
                  + 3 * ncell)
    nops = _ct_ops(plain, cfg, up[0].numel(), ncell)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F32_OPS_PER_S
    r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    line = (f"ct_step_slab {ms:.4f} ms/call on the device (profiler, one "
            f"kernel a call), {100 * r['bound_ms'] / ms:.1f} % of the bound; "
            f"{_k4_launch(cfg)}; plain version {plain_ms:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({nbytes / 1e9:.5f} GB -> {bytes_ms:.5f} ms; "
            f"{nops / 1e9:.5f} G ops -> {ops_ms:.5f} ms); against plain: "
            f"{readings}")
    return r, line


def _evolve_counted(sim, nstep: int):
    """``sim.evolve(nstepmax=nstep)`` with every launch count at 0 just
    before; returns (wall s, the counts just after)."""
    import torch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim.evolve(nstepmax=nstep)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _counts()


def _k4_only(n: int) -> dict:
    return _want(ct_step_slab=n)


def _k4_launch(cfg) -> str:
    """K4's launch for ``cfg``: threads and dynamic shared memory a block,
    blocks an SM resident, registers and local (spill) bytes a thread."""
    from ramses_tpu_torch.mhd import ct_slab
    i = ct_slab.launch_info(cfg)
    return (f"launch {i['threads']} threads, {i['smem_bytes']} B dynamic "
            f"shared memory a block, {i['blocks_per_sm']} blocks an SM, "
            f"{i['registers']} registers, {i['local_bytes']} B local a "
            f"thread")


def _mhd_variant_ot(dev, riemann: str, riemann2d: str, tag: str) -> dict:
    """Orszag-Tang at 2048² (phase 13's vortex) with another pair of
    solvers, 20 steps: K4 once a step, div B, a finite state, mass and
    energy; then K4 at the final state (``_k4_at``)."""
    import torch
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.driver import MhdSimulation
    p = load_params(OT_NML, ndim=2)
    p.amr.levelmin = p.amr.levelmax = OT_LEVEL
    p.hydro.riemann, p.hydro.riemann2d = riemann, riemann2d
    n = 2 ** OT_LEVEL
    sim = MhdSimulation(p)
    u0, bf0 = _orszag_tang(n)
    sim.u = torch.tensor(u0, dtype=torch.float32, device=dev)
    sim.bf = torch.tensor(bf0, dtype=torch.float32, device=dev)
    del u0, bf0
    if not ct_slab.supports(sim.cfg, sim.grid.shape, sim.u.dtype):
        raise AssertionError(f"outside K4's gate: {sim.cfg}")
    tot0 = {k: float(v) for k, v in sim.totals().items() if k != "momentum"}
    wall, launches = _evolve_counted(sim, 20)
    tot1 = {k: float(v) for k, v in sim.totals().items() if k != "momentum"}
    divb = _divb_rel(sim)
    if sim.nstep != 20 or launches != _k4_only(sim.nstep):
        raise AssertionError(f"Orszag-Tang {riemann}/{riemann2d} ran "
                             f"{sim.nstep} steps, launched {launches}")
    if not (bool(torch.isfinite(sim.u).all()) and divb <= DIVB_REL):
        raise AssertionError(f"Orszag-Tang {riemann}/{riemann2d}: finite "
                             f"{bool(torch.isfinite(sim.u).all())}, div B "
                             f"{divb:.3e}")
    for k in ("mass", "energy"):
        if abs(tot1[k] - tot0[k]) > 1e-5 * abs(tot0[k]):
            raise AssertionError(f"Orszag-Tang {riemann}/{riemann2d}: {k} "
                                 f"{tot0[k]} -> {tot1[k]}")
    r, line = _k4_at(sim)
    _print(f"phase {tag} Orszag-Tang {sim.grid.shape} riemann={riemann} "
           f"riemann2d={riemann2d}: {sim.nstep} steps t={sim.t:.6e}, "
           f"launches {launches}; max|div B|·dx/max|B| {divb:.3e}; mass "
           f"{tot0['mass']:.9e} -> {tot1['mass']:.9e}, energy "
           f"{tot0['energy']:.9e} -> {tot1['energy']:.9e}; evolve "
           f"{wall:.4f} s = {sim.cell_updates / wall:.4e} cell-updates/s; "
           f"{line}")
    r.update(name=f"2048² {riemann}/{riemann2d}",
             launches=launches["ct_step_slab"])
    return r


def _mhd_variant_3d(dev) -> dict:
    """Phase 16's 3D run at 128³ with HLLD corners, 10 steps."""
    import torch
    sim = _solenoidal_3d(dev, "hlld", "hlld")
    m0 = float(sim.totals()["mass"])
    wall, launches = _evolve_counted(sim, 10)
    m1 = float(sim.totals()["mass"])
    divb = _divb_rel(sim)
    if sim.nstep != 10 or launches != _k4_only(10):
        raise AssertionError(f"3D hlld/hlld ran {sim.nstep} steps, "
                             f"launched {launches}")
    if not (bool(torch.isfinite(sim.u).all()) and divb <= DIVB_REL
            and abs(m1 - m0) <= 1e-5 * abs(m0)):
        raise AssertionError(f"3D hlld/hlld: finite "
                             f"{bool(torch.isfinite(sim.u).all())}, div B "
                             f"{divb:.3e}, mass {m0} -> {m1}")
    r, line = _k4_at(sim, n=10)
    _print(f"phase 16b MHD 3D {sim.grid.shape} solenoidal, riemann=hlld "
           f"riemann2d=hlld: {sim.nstep} steps t={sim.t:.6e}, launches "
           f"{launches}, max|div B|·dx/max|B| {divb:.3e}, mass {m0:.9e} "
           f"-> {m1:.9e}; evolve {wall:.4f} s = "
           f"{sim.cell_updates / wall:.4e} cell-updates/s; {line}")
    r.update(name="3D 128³ hlld/hlld", launches=launches["ct_step_slab"])
    return r


def _tube_phase(dev) -> dict:
    """Phase 17: ``BASELINE.json`` config 4, ``namelists/tube_mhd.nml``
    (1D, 256 cells, Roe, outflow), through K4: 20 steps and K4 against
    its plain version at that state; the whole run to tend through
    ``run_namelist``; and the CLI, ``python -m ramses_tpu_torch
    namelists/tube_mhd.nml --ndim 1``, in this process, in a scratch
    directory (it writes ``output_00001/`` there) with the signal handlers
    its guard installs put back after it."""
    import contextlib
    import io
    import re
    import shutil
    import signal
    import tempfile

    import torch
    from ramses_tpu_torch import __main__ as cli
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import run_namelist
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import uniform as mu
    from ramses_tpu_torch.mhd.core import MhdStatic
    from ramses_tpu_torch.mhd.driver import mhd_condinit
    pt = load_params(TUBE_NML, ndim=1)
    tcfg = MhdStatic.from_params(pt)
    shape = (2 ** pt.amr.levelmin,)
    if not ct_slab.supports(tcfg, shape, torch.float32):
        raise AssertionError(f"tube_mhd.nml is outside K4's gate: {tcfg}")
    _, bft0 = mhd_condinit(shape, pt.amr.boxlen / shape[0], pt, tcfg)
    bx0 = torch.tensor(bft0[0], dtype=torch.float32, device=dev)
    tend = pt.output.tout[-1] if pt.output.tout else pt.output.tend
    # MhdSimulation.evolve issues steps in chunks with one host wait each;
    # the chunk that reaches tend runs its remaining steps at dt = 0
    # (masked: the state stays as it is), and each issued step is one
    # K4 call.  So K4's launches are the steps issued, which exceed the
    # steps taken by fewer than one chunk, in the last chunk only.
    issued = []
    run_steps = mu.run_steps

    def counted_run_steps(grid, u, bf, t, tend_, nsteps, *a, **k):
        issued.append(nsteps)
        return run_steps(grid, u, bf, t, tend_, nsteps, *a, **k)

    def check(sim, launches, what):
        n = sum(issued)
        if not (launches == _k4_only(n) and sim.nstep <= n
                and n - sim.nstep < max(issued)):
            raise AssertionError(f"{what}: {sim.nstep} steps taken, {n} "
                                 f"issued in chunks {issued}, launched "
                                 f"{launches}")
        if not (bool(torch.isfinite(sim.u).all())
                and torch.equal(sim.bf[0], bx0)):
            raise AssertionError(f"{what}: state not finite or Bx changed")

    def run(**kw):
        torch.cuda.synchronize()
        issued.clear()
        _reset_counts()
        t0 = time.perf_counter()
        sim = run_namelist(TUBE_NML, ndim=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(sim, _counts(), "tube_mhd.nml")
        return sim, wall, sum(issued)

    mu.run_steps = counted_run_steps
    try:
        tube, wall20, _ = run(nstepmax=20)
        if tube.nstep != 20:
            raise AssertionError(f"tube_mhd ran {tube.nstep} steps, not 20")
        r, line = _k4_at(tube, periodic=False)
        full, wall, nissued = run()
        if not full.t >= tend * (1 - 1e-12):
            raise AssertionError(f"tube_mhd stopped at t={full.t}, tend "
                                 f"{tend}")
        out = io.StringIO()
        issued.clear()
        cwd, here = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_cli_")
        handlers = {s: signal.getsignal(s) for s in
                    (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
        try:
            os.chdir(here)
            _reset_counts()
            with contextlib.redirect_stdout(out):
                rc = cli.main([TUBE_NML, "--ndim", "1"])
            lc = _counts()
            from ramses_tpu_torch.resilience import checkpoint as ckpt
            written = ckpt.validate_checkpoint("output_00001")
        finally:
            os.chdir(cwd)
            for sig, h in handlers.items():
                signal.signal(sig, h)
            shutil.rmtree(here, ignore_errors=True)
    finally:
        mu.run_steps = run_steps
    m = re.search(r"totals: t=(\S+) nstep=(\d+)", out.getvalue())
    if rc != 0 or m is None or int(m.group(2)) != full.nstep or \
            not written[0]:
        raise AssertionError(f"the CLI on tube_mhd.nml: rc {rc}, closing "
                             f"line {m and m.group(0)}, output_00001 "
                             f"{written[1]}")
    check(full, lc, "the CLI on tube_mhd.nml")
    _print(f"phase 17 BASELINE config 4 tube_mhd.nml {full.grid.shape} "
           f"(riemann={full.cfg.riemann}, outflow) through K4: 20 steps "
           f"({wall20:.3f} s, K4 20 launches), K4 at the step-20 state: "
           f"{line}; run_namelist to t={full.t:.6e}: {full.nstep} steps "
           f"taken, {nissued} issued in chunks, K4 {nissued} launches "
           f"(one an issued step; the last chunk's {nissued - full.nstep} "
           f"past tend at dt = 0), finite, Bx bitwise unchanged, "
           f"{wall:.3f} s, evolve {full.wall_s:.4f} s = "
           f"{full.wall_s / full.nstep * 1e3:.4f} ms/step; the CLI: rc "
           f"{rc}, {m.group(0)}, K4 {lc['ct_step_slab']} launches, "
           f"output_00001 validates")
    r.update(name="tube_mhd.nml 1D roe", launches=nissued)
    return r


def _ot_amr_params(lmin: int, lmax: int):
    """``namelists/orszag2d.nml`` (gamma 1.6666667, courant 0.8, hlld,
    slope_type 1, ``err_grad_d = err_grad_p = err_grad_b = 0.05``, periodic,
    ``nremap=1``) at the given levels."""
    from ramses_tpu_torch.config import load_params
    p = load_params(OT_NML, ndim=2)
    p.amr.levelmin, p.amr.levelmax = lmin, lmax
    return p


def _set_ot_amr(sim):
    """The exact Orszag-Tang vortex on every level of an MHD hierarchy, as
    ``tests/test_mhd_amr.py:86-146`` builds it: faces from the vector
    potential Az at each level's own resolution (div B zero to roundoff, a
    coarse face the mean of its fine faces), cell B the face mean."""
    import numpy as np
    import torch
    from ramses_tpu_torch.mhd import core
    rho0, p0 = 25.0 / (36.0 * np.pi), 5.0 / (12.0 * np.pi)
    b0, two_pi = 1.0 / np.sqrt(4.0 * np.pi), 2.0 * np.pi

    def az(x, y):
        return b0 * (np.cos(4.0 * np.pi * x) / (4.0 * np.pi)
                     + np.cos(two_pi * y) / two_pi)
    for l in sim.levels():
        dxl = sim.dx(l)
        cc = sim.tree.cell_coords(l).astype(np.float64)
        x0, y0 = cc[:, 0] * dxl, cc[:, 1] * dxl
        n, npad = len(cc), sim.maps[l].ncell_pad
        bf = np.zeros((npad, 3, 2))
        bf[:n, 0, 0] = (az(x0, y0 + dxl) - az(x0, y0)) / dxl
        bf[:n, 0, 1] = (az(x0 + dxl, y0 + dxl) - az(x0 + dxl, y0)) / dxl
        bf[:n, 1, 0] = -(az(x0 + dxl, y0) - az(x0, y0)) / dxl
        bf[:n, 1, 1] = -(az(x0 + dxl, y0 + dxl) - az(x0, y0 + dxl)) / dxl
        xc, yc = x0 + 0.5 * dxl, y0 + 0.5 * dxl
        q = np.zeros((8, npad))
        q[0] = sim.mcfg.smallr
        q[0, :n] = rho0
        q[1, :n] = -np.sin(two_pi * yc)
        q[2, :n] = np.sin(two_pi * xc)
        q[4] = 1e-20
        q[4, :n] = p0
        q[5:8] = 0.5 * (bf[:, :, 0] + bf[:, :, 1]).T
        u = core.prim_to_cons(torch.from_numpy(q), sim.mcfg).T
        sim.u[l] = u.to(sim.device, sim.dtype).contiguous()
        sim.bfs[l] = torch.tensor(bf, dtype=sim.dtype, device=sim.device)
    sim._restrict_all()
    sim._dt_cache = None


def _mhd_amr_phases(dev):
    """Phases 18-21 (MHD on the AMR hierarchy); returns K4's launches on
    this slice's main path (phase 19), its worst max abs err of phase 18,
    and that phase's readings at the AMR complete level."""
    import numpy as np
    import torch
    from ramses_tpu_torch.convert import mhd_amr_state_from
    from ramses_tpu_torch.driver import run_namelist
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.amr import MhdAmrSim

    lmin, lmax = OT_AMR_LEVELS
    p = _ot_amr_params(lmin, lmax)
    t0 = time.perf_counter()
    sim = MhdAmrSim(p)
    _set_ot_amr(sim)
    for _ in range(2):                 # let the tree adapt to the vortex
        sim.regrid()
        _set_ot_amr(sim)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state0 = mhd_amr_state_from(sim)

    # ---- 18. K4 at the AMR complete level ----
    sim.regrid()
    sim.step_coarse(sim.coarse_dt())
    sim.regrid()
    calls = []
    kernel = ct_slab.ct_step_slab

    def capture(*a, **k):
        calls.append((a, k))
        return kernel(*a, **k)
    ct_slab.ct_step_slab = capture
    try:
        sim.step_coarse(sim.coarse_dt())
    finally:
        ct_slab.ct_step_slab = kernel
    torch.cuda.synchronize()
    with_ovr = [(a, k) for a, k in calls if k.get("ovr") is not None]
    if not with_ovr:
        raise AssertionError(f"no complete level of {sim.levels()} (complete "
                             f"{sim._fused_spec().complete}) received a "
                             f"coarse-fine EMF override")
    a, k = with_ovr[0]
    up, bfp, dt, dx, cfg = a
    okp, ovr = k["okp"], k["ovr"]
    inner = (slice(2, -2), slice(2, -2))
    n_ok = int(okp[inner].sum()) if okp is not None else 0
    n_ovr = int(ovr[(0, 1)][0][inner].sum())
    if n_ok == 0 or n_ovr == 0:
        raise AssertionError(f"K4 at the AMR complete level: refined mask "
                             f"{n_ok} cells, override {n_ovr} corners")
    got = kernel(*a, **k)
    want = ct_slab.ct_step_slab_ref(*a, **k)
    torch.cuda.synchronize()
    err18, _, excess, readings = _ct_check(got, want, 2)
    if not excess <= 0.0:
        raise AssertionError(f"ct_step_slab disagrees with its plain version "
                             f"at the AMR complete level: {readings}")
    del got, want
    sp = tuple(int(n) - 4 for n in up.shape[1:])
    ncell = sp[0] * sp[1]
    ms18 = _device_ms(lambda: kernel(*a, **k), "mhd_ct_fused", n=30)
    plain18 = _median_ms(lambda: ct_slab.ct_step_slab_ref(*a, **k), reps=10)
    nbytes = 4 * (5 * up[0].numel() + bfp.numel() + 1 + 8 * ncell
                  + 3 * ncell + okp.numel() + 2 * up[0].numel())
    nops = _ct_ops(lambda: ct_slab.ct_step_slab_ref(*a, **k), cfg,
                   up[0].numel(), ncell)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F32_OPS_PER_S
    _print(f"phase 18 K4 at the AMR complete level {sp} (Orszag-Tang "
           f"levelmin={lmin} levelmax={lmax}, the second coarse step; "
           f"{len(calls)} K4 calls in the step, {len(with_ovr)} with an EMF "
           f"override): refined mask {n_ok} cells, override {n_ovr} corners; "
           f"ct_step_slab {ms18:.4f} ms/call on the device (profiler, one "
           f"kernel a call), {100 * max(bytes_ms, ops_ms) / ms18:.1f} % of "
           f"the bound; {_k4_launch(cfg)}; plain "
           f"version {plain18:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
           f"by {'bytes' if bytes_ms >= ops_ms else 'operations'} "
           f"({nbytes / 1e9:.4f} GB -> {bytes_ms:.4f} ms; {nops / 1e9:.4f} G "
           f"ops -> {ops_ms:.4f} ms); against plain: {readings}")
    del calls, with_ovr, a, k, up, bfp, okp, ovr, sim
    torch.cuda.empty_cache()

    # ---- 19. the MHD AMR main path: Orszag-Tang levelmin=9, levelmax=11 --
    sim = MhdAmrSim.from_state(p, **state0)
    tend = p.output.tout[-1] if p.output.tout else p.output.tend
    tot0 = sim.totals()
    stepped = []
    step_coarse = sim.step_coarse
    sim.step_coarse = lambda dt: (stepped.append(sim._fused_spec()),
                                  step_coarse(dt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    sim.evolve(tend, nstepmax=OT_AMR_STEPS)
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse
    peak = torch.cuda.max_memory_allocated()
    k4_want = sum(2 ** (l - lmin) for spec in stepped
                  for l, c in zip(spec.levels, spec.complete) if c)
    want = _want(ct_step_slab=k4_want)
    tot1 = sim.totals()
    octs = {l: sim.tree.noct(l) for l in sim.levels()}
    complete = [l for l in sim.levels() if sim.maps[l].complete]
    divb = sim.divb_levels()
    # div B stays at roundoff where the JAX package's scheme keeps it: on
    # complete levels, and on a partial level with a complete parent and
    # no finer level.  A partial level with finer levels steps its leaves
    # next to refined cells from their restricted faces, and keeps its own
    # EMFs (no coarse-fine matching: the "first-order coupling" of
    # ramses_tpu/mhd/amr.py:26-30), so those faces drift from its own, and
    # the faces migrated below it inherit the mismatch (ROADMAP §C3)
    held = [l for l in sim.levels() if sim.maps[l].complete
            or (sim.maps[l - 1].complete and not sim.tree.has(l + 1))]
    gap = sim.max_face_gap()
    if sim.nstep != OT_AMR_STEPS or len(stepped) != OT_AMR_STEPS:
        raise AssertionError(f"MHD AMR main path ran {sim.nstep} steps")
    if launches != want or k4_want == 0:
        raise AssertionError(f"MHD AMR main path launched {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(sim.u[l]).all())
               and bool(torch.isfinite(sim.bfs[l]).all())
               for l in sim.levels()):
        raise AssertionError("MHD AMR main path state is not finite")
    if abs(tot1["mass"] - tot0["mass"]) > 1e-5 * abs(tot0["mass"]):
        raise AssertionError(f"MHD AMR leaf mass not conserved: "
                             f"{tot0['mass']} -> {tot1['mass']}")
    if not (gap == 0.0 and max(divb[l] for l in held) <= DIVB_REL):
        raise AssertionError(f"MHD AMR div B: shared-face gap {gap}, per "
                             f"level {divb} (held on {held})")
    _print(f"phase 19 MHD AMR main path: Orszag-Tang (orszag2d.nml) "
           f"levelmin={lmin} levelmax={lmax}, {sim.nstep} coarse steps "
           f"t={sim.t:.6e}; octs per level {octs}, complete levels "
           f"{complete}; launches {launches} (K4 expected {k4_want} = Σ "
           f"2^(l-{lmin}) over complete levels per step); set-up "
           f"{setup_s:.3f} s, evolve {wall:.3f} s = "
           f"{sim.cell_updates / wall:.4e} cell-updates/s "
           f"({sim.cell_updates} cell updates); peak device memory "
           f"{peak / 2**30:.3f} GiB; leaf mass {tot0['mass']:.9e} -> "
           f"{tot1['mass']:.9e}, energy {tot0['energy']:.9e} -> "
           f"{tot1['energy']:.9e}; max|div B|·dx/max|B| per level "
           f"{ {l: float(f'{v:.3e}') for l, v in divb.items()} } (limit "
           f"{DIVB_REL:.0e} on {held}); shared leaf faces' two copies "
           f"differ by at most {gap}")

    # ---- 20. where the time of one coarse step goes ----
    def coarse_step():
        sim.regrid()
        sim.step_coarse(sim.coarse_dt())
    _, acc = _host_breakdown(
        sim, coarse_step,
        parts=("regrid", "_flag_and_tree", "_rebuild_maps", "_build_emf_maps",
               "_donor_maps", "_migrate_level", "_restrict_all", "coarse_dt",
               "step_coarse"),
        nested=("_flag_and_tree", "_rebuild_maps", "_build_emf_maps",
                "_donor_maps", "_migrate_level", "_restrict_all"))
    total = sum(acc[k] for k in ("regrid", "coarse_dt", "step_coarse",
                                 "other host"))
    faces = acc["regrid"] - sum(acc[k] for k in (
        "_flag_and_tree", "_rebuild_maps", "_migrate_level", "_restrict_all"))
    prof = _profile(coarse_step, os.path.join(ROOT, "chiprun_out"),
                    "chip_smoke_mhd_amr_trace.json", warm=False)
    _print(f"phase 20 one MHD AMR coarse step (regrid + Courant fetch + "
           f"step, octs {[sim.tree.noct(l) for l in sim.levels()]}): wall by "
           f"part, each synchronised: total {total:.4f} s: flag_and_tree "
           f"{acc['_flag_and_tree']:.4f}, rebuild_maps "
           f"{acc['_rebuild_maps']:.4f} (of which EMF maps "
           f"{acc['_build_emf_maps']:.4f}), u migration "
           f"{acc['_migrate_level']:.4f}, face migration {faces:.4f} (of "
           f"which donor maps {acc['_donor_maps']:.4f}), restriction "
           f"{acc['_restrict_all']:.4f}, Courant fetch "
           f"{acc['coarse_dt']:.4f}, step {acc['step_coarse']:.4f}, other "
           f"host {acc['other host']:.4f}; profiled: {prof}")
    del sim
    torch.cuda.empty_cache()

    # ---- 21. namelists/orszag2d.nml as the CLI runs it ----
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    cli = run_namelist(OT_NML, ndim=2, solver="mhd")
    cli.drain()
    wall21 = time.perf_counter() - t0
    l21 = _counts()
    if not (isinstance(cli, MhdAmrSim) and cli.t >= 0.2 * (1 - 1e-12)
            and l21["ct_step_slab"] > 0):
        raise AssertionError(f"orszag2d.nml: {type(cli).__name__} t={cli.t} "
                             f"launches {l21}")
    state = mhd_amr_state_from(cli)
    replays = []
    for _ in range(2):
        r = MhdAmrSim.from_state(cli.params, **state)
        r.evolve(2 * cli.t, nstepmax=r.nstep + 3)
        replays.append(r)
    ra, rb = replays
    if ra.nstep != cli.nstep + 3 or ra.levels() != rb.levels() or not all(
            np.array_equal(ra.tree.levels[l].keys, rb.tree.levels[l].keys)
            and torch.equal(ra.u[l], rb.u[l])
            and torch.equal(ra.bfs[l], rb.bfs[l]) for l in ra.levels()):
        raise AssertionError("orszag2d.nml: two 3-step replays differ")
    _print(f"phase 21 orszag2d.nml as the CLI runs it (run_namelist, "
           f"levelmin={cli.lmin} levelmax={cli.lmax}, its uniform-region "
           f"ICs): {cli.nstep} coarse steps to t={cli.t:.6e} in "
           f"{wall21:.3f} s, octs {[cli.tree.noct(l) for l in cli.levels()]}"
           f", launches {l21}, max|divB|/max|B|*dx={cli.max_divb():.3e}; "
           f"two 3-coarse-step replays from its final state bitwise equal")
    return launches["ct_step_slab"], err18


def _flux_scales(blk, c: int, planes: bool):
    """The scale of each mass flux a sweep of ``blk`` returns: the largest
    density over the 5³ stencils of the cells the face touches (K3's
    planes ``[3, c+1, c, c, N]``), or over the cell's own 5³ stencil,
    which holds both cells of either face (K2's ``[3, 2, 2, 2, 2, N]``)."""
    import torch
    from ramses_tpu_torch.amr import kernels as K
    s = _block_stencil_scale(blk)[0]
    if planes:
        return torch.stack([K._mass_planes(torch.maximum(s, s.roll(1, d)),
                                           d, 3, c) for d in range(3)])
    core = s[2:4, 2:4, 2:4]
    return core.expand((3, 2) + tuple(core.shape))


def _leaf_tracers(sim, levels):
    """How many tracers sit on leaf cells of ``levels`` (each tracer at its
    finest covering level, as the jumps locate it), and the gas mass share
    of those leaves."""
    import numpy as np
    from ramses_tpu_torch.pm import amr_physics
    lev = np.full(len(sim.tracer_x), -1)
    for l in sim.levels():
        rows = amr_physics.ngp_rows(sim.tree, sim.tracer_x, l, sim.boxlen,
                                    sim.bc_kinds)
        lev[rows >= 0] = l
    mass = {}
    for l in sim.levels():
        _, u = sim.leaf_sample(l)
        mass[l] = float(u[:, 0].sum()) * sim.dx(l) ** 3
    share = sum(mass[l] for l in levels) / sum(mass.values())
    return int(np.isin(lev, levels).sum()), share


def _mass_identity(tree, u0, u1, phi):
    """Worst (|Σ_d (φ_lo − φ_hi) − Δρ| − tolerance) over the leaf cells of
    every level of one coarse step (``tree`` the step's tree, ``u0``/``u1``
    the state before and after it, ``phi`` its capture), and the worst
    |difference|."""
    import torch
    excess, worst = -1.0, 0.0
    for l in phi:
        nc = tree.noct(l) * 8
        leaf = torch.from_numpy(~tree.refined_mask(l)).to(phi[l].device)
        drho = (u1[l][:nc, 0] - u0[l][:nc, 0])[leaf]
        net = (phi[l][:nc, :, 0] - phi[l][:nc, :, 1]).sum(dim=1)[leaf]
        d = (net - drho).abs()
        worst = max(worst, float(d.max()))
        excess = max(excess, float(
            (d - (FLUX_ATOL + FLUX_RTOL * drho.abs())).max()))
    return excess, worst


def _tracer_run(blocked: bool, nsteps: int) -> dict:
    """sedov3d AMR at ``AMR_LEVELS`` with ``tracer=.true.`` and
    ``tracer_per_cell=1.0`` set in code, ``evolve`` for ``nsteps`` coarse
    steps (a regrid before each) with every launch count at 0 just before
    ``AmrSim()``; each step's tree, state before and after and capture are
    kept for the checks."""
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    p = _amr_params(blocked)
    p.run.tracer = True
    p.run.tracer_per_cell = 1.0
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim = AmrSim(p)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []
    step_coarse, source = sim.step_coarse, sim._source_passes

    def stepped(dt):
        rec = dict(levels=tuple(sim.levels()), tree=sim.tree,
                   u0=dict(sim.u))
        steps.append(rec)
        step_coarse(dt)
        rec["u1"] = dict(sim.u)

    def captured(dt):
        steps[-1]["phi"] = dict(sim._tracer_phi)
        source(dt)
    sim.step_coarse, sim._source_passes = stepped, captured
    n0, ids0 = len(sim.tracer_x), sim.tracer_id.copy()
    nleaf0 = sim.ncell_leaf()
    mass0 = float(sim.totals()["mass"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.evolve(p.output.tout[-1], nstepmax=nsteps)
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse, sim._source_passes
    return dict(sim=sim, steps=steps, launches=launches, n0=n0, ids0=ids0,
                nleaf0=nleaf0, mass0=mass0, wall=wall, init_s=init_s)


def _tracer_check(r: dict, kern: str, nsteps: int):
    """The tracer path's launches (K1 with the fluxes once per coarse
    step, ``kern`` once per partial-level substep, no other kernel), the
    capture's mass identity on every leaf cell of every level after each
    step, the tracer count and ids (periodic box), the leaf mass and a
    finite state.  Returns the identity's worst |difference|."""
    import numpy as np
    import torch
    sim, lmin = r["sim"], AMR_LEVELS[0]
    want = _want(fused_muscl_flux=len(r["steps"]), **{
        kern: sum(2 ** (l - lmin) for rec in r["steps"]
                  for l in rec["levels"] if l > lmin)})
    if sim.nstep != nsteps or len(r["steps"]) != nsteps:
        raise AssertionError(f"tracer path ran {sim.nstep} steps, expected "
                             f"{nsteps}")
    if r["launches"] != want or want[kern] == 0:
        raise AssertionError(f"tracer path launched {r['launches']}, "
                             f"expected {want}")
    worst = 0.0
    for k, rec in enumerate(r["steps"]):
        ex, w = _mass_identity(rec["tree"], rec["u0"], rec["u1"],
                               rec["phi"])
        worst = max(worst, w)
        if not ex <= 0.0:
            raise AssertionError(
                f"step {k}: the captured face fluxes miss the mass update "
                f"on a leaf cell by {w:.3e} (tolerance excess {ex:.3e})")
    if len(sim.tracer_x) != r["n0"] or not np.array_equal(sim.tracer_id,
                                                           r["ids0"]):
        raise AssertionError(f"tracer count {r['n0']} -> "
                             f"{len(sim.tracer_x)} in a periodic box")
    mass1 = float(sim.totals()["mass"])
    if abs(mass1 - r["mass0"]) > 1e-5 * abs(r["mass0"]):
        raise AssertionError(f"leaf mass {r['mass0']} -> {mass1}")
    if not all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels()):
        raise AssertionError("tracer path state is not finite")
    return worst


def _tracer_phases(dev):
    """Phases 22-26 (the MC-tracer slice); returns the kernels line's rows
    of K1, K3 and K2 with the face mass fluxes."""
    import torch
    from ramses_tpu_torch.amr import kernels as K
    from ramses_tpu_torch.grid import boundary as bmod
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.hydro.core import HydroStatic
    from ramses_tpu_torch.pm import amr_physics

    # ---- 22. the flux variants against their plain versions ----
    worst = {"fused_muscl_flux": 0.0, "tile_sweep_flux": 0.0,
             "oct_sweep_flux": 0.0}
    ncase = 0
    periodic = bmod.BoundarySpec.periodic(3)
    for i, (rs, st, masked) in enumerate((("llf", 1, True),
                                          ("hllc", 2, False),
                                          ("hllc", 8, True))):
        cfg = HydroStatic(ndim=3, riemann=rs, slope_type=st)
        dt = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        u = torch.from_numpy(_random_state(CHECK_SHAPE, cfg.gamma,
                                           300 + i)).to(dev)
        g = torch.Generator(device="cpu").manual_seed(400 + i)
        ok = ((torch.rand(CHECK_SHAPE, generator=g) < 0.1)
              & masked).to(dev)
        got = fm.fused_step(u, dt, cfg, 1.0 / 64, periodic, ok=ok,
                            courant=masked, want_flux=True)
        want = fm.fused_step_ref(u, dt, cfg, 1.0 / 64, periodic, ok=ok,
                                 courant=masked, want_flux=True)
        torch.cuda.synchronize()
        err, ex = _pair_check((got[0], got[-1]), (want[0], want[-1]))
        rel = (abs(float(got[1]) - float(want[1])) / float(want[1])
               if masked else 0.0)
        if not (ex <= 0.0 and rel <= DT_REL):
            raise AssertionError(
                f"fused_muscl with want_flux disagrees with its plain "
                f"version: riemann={rs} slope_type={st} masked={masked}: "
                f"max abs err {err:.3e}, tolerance excess {ex:.3e}, dt rel "
                f"{rel:.3e}")
        worst["fused_muscl_flux"] = max(worst["fused_muscl_flux"], err)
        ncase += 1
        for name, side, n, shift in (("tile_sweep", 8, 64, 1),
                                     ("tile_sweep", 12, 64, 2),
                                     ("oct_sweep", 6, 256, None)):
            shape = ((n,) + (side,) * 3 if shift is not None
                     else (side,) * 3 + (n,))
            ub = torch.from_numpy(_random_state(shape, cfg.gamma,
                                                500 + i)).to(dev)
            okb = ((torch.rand(shape, generator=g) < 0.15)
                   & masked).to(dev)
            extra = (shift,) if shift is not None else ()
            got = getattr(om, name)(ub, okb, dt, cfg, 1.0 / 64, *extra,
                                    want_flux=True)
            want = getattr(om, name + "_ref")(ub, okb, dt, cfg, 1.0 / 64,
                                              *extra, want_flux=True)
            torch.cuda.synchronize()
            err, ex = _pair_check(got, want)
            if not (ex <= 0.0 and len(got) == 3):
                raise AssertionError(
                    f"{name} with want_flux disagrees with its plain "
                    f"version: riemann={rs} slope_type={st} shape={shape} "
                    f"masked={masked}: max abs err {err:.3e}, tolerance "
                    f"excess {ex:.3e}")
            worst[name + "_flux"] = max(worst[name + "_flux"], err)
            ncase += 1
    _print(f"phase 22 flux-variant kernel check: {ncase} cases (K1 64³ "
           f"masked with dt_next and unmasked; K3 shift 1 and 2, N 64; K2 "
           f"N 256) pass for du, corrections and phi; max abs err "
           + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # ---- 23. the MC-tracer main path ----
    lmin, lmax = AMR_LEVELS
    r = _tracer_run(True, TRACER_STEPS)
    sim = r["sim"]
    worst_id = _tracer_check(r, "tile_sweep_flux", TRACER_STEPS)
    n_fine, share = _leaf_tracers(sim, [l for l in sim.levels() if l > lmin])
    expect = float(sim.params.run.tracer_per_cell) * r["nleaf0"] * share
    sigma = expect ** 0.5
    if not abs(n_fine - expect) <= 5.0 * sigma:
        raise AssertionError(
            f"{n_fine} tracers on the level {lmin + 1}-{lmax} leaves "
            f"against {expect:.1f} +- {sigma:.1f} for their gas mass "
            f"share {share:.6e}")
    octs = {l: sim.tree.noct(l) for l in sim.levels()}
    _print(f"phase 23 MC-tracer main path: sedov3d levelmin={lmin} "
           f"levelmax={lmax} tracer=.true. tracer_per_cell=1.0, "
           f"{sim.nstep} coarse steps t={sim.t:.6e}, octs per level {octs}, "
           f"launches {r['launches']}; {len(sim.tracer_x)} tracers, "
           f"conserved with their ids; on the level {lmin + 1}-{lmax} "
           f"leaves {n_fine} against tpc * N_leaf * mass share = "
           f"{expect:.1f} (sigma {sigma:.1f}, share {share:.6e}); mass "
           f"identity on every leaf cell of every step within rtol "
           f"{FLUX_RTOL} / atol {FLUX_ATOL} (worst |difference| "
           f"{worst_id:.3e}); AmrSim() with seeding {r['init_s']:.3f} s, "
           f"evolve {r['wall']:.3f} s = "
           f"{sim.cell_updates / r['wall']:.4e} cell-updates/s")
    del r["steps"]
    torch.cuda.empty_cache()

    # ---- 24. the flux variants at the path's state, and their times ----
    cfg = sim.cfg
    shift = sim._fused_spec().block_shift
    c_ = 1 << (shift + 1)
    td = c_ + 4
    dtc = sim.coarse_dt()
    rows, lines = {}, []
    fine = sim.levels()[1:]

    def timing(kern, plain, args, nbytes, keep, base_kern, name=None):
        """Device ms a call with and without the fluxes, the plain
        version's ms with them, and the bound of the flux variant.  The
        wrapper's count must show every launch of a timed window."""
        def counter(key):
            return None if name is None else lambda: om.launches[key]
        ms = _device_ms(lambda: kern(*args, want_flux=True), base_kern,
                        launched=counter(f"{name}_flux"))
        ms0 = _device_ms(lambda: kern(*args), base_kern,
                         launched=counter(name))
        pms = _median_ms(lambda: plain(*args, want_flux=True), reps=10)
        nops = _count_ops(lambda: plain(*args, want_flux=True)) * keep
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nops / F32_OPS_PER_S
        return dict(ms=ms, ms0=ms0, plain_ms=pms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    note=(f"{nbytes / 1e6:.3f} MB -> {bytes_ms:.5f} ms; "
                          f"{nops / 1e9:.4f} G ops -> {ops_ms:.5f} ms"))
    for name in ("tile_sweep", "oct_sweep"):
        for l in fine:
            d = sim.dev[l]
            dx = sim.dx(l)
            dt = torch.tensor(dtc / 2 ** (l - lmin), dtype=torch.float32,
                              device=dev)
            if name == "tile_sweep":
                interp = K.interp_cells(sim.u[l - 1], d["b_interp_cell"],
                                        d["b_interp_nb"], d["b_interp_sgn"],
                                        cfg)
                blk = K._gather_tiles(sim.u[l], interp, d["tile_src"],
                                      d["tile_vsgn"], cfg, td)
                ok = d["tile_ok"].reshape(blk.shape[1:]).to(torch.float32)
                extra, keep, c = (shift,), c_ ** 3 / td ** 3, c_
                n, as_last = blk.shape[1], _batch_last
            else:
                interp = K.interp_cells(sim.u[l - 1], d["interp_cell"],
                                        d["interp_nb"], d["interp_sgn"], cfg)
                blk = K._gather_uloc(sim.u[l], interp, d["stencil_src"],
                                     d["vsgn"], cfg)
                ok = K._block_mask(d["ok_ref"], 6, 3).to(torch.float32)
                extra, keep, c = (), 8 / 216, 2
                n, as_last = blk.shape[-1], tuple
            kern = getattr(om, name)
            plain = getattr(om, name + "_ref")
            args = (blk, ok, dt, cfg, dx, *extra)
            got = kern(*args, want_flux=True)
            want = plain(*args, want_flux=True)
            torch.cuda.synchronize()
            blk_last = as_last((blk,))[0]
            scales = _output_scales(blk_last, c, name == "tile_sweep") + (
                _flux_scales(blk_last, c, name == "tile_sweep"),)
            err, rel, ex = _local_check(as_last(got), as_last(want), scales)
            del scales
            rel = "/".join(f"{x:.3e}" for x in rel)
            if not ex <= 0.0:
                raise AssertionError(f"{name} with want_flux disagrees with "
                                     f"its plain version on level {l} of "
                                     f"the tracer path: max abs err "
                                     f"{err:.3e}, err / M (du/faces/phi) "
                                     f"{rel}")
            nbytes = _sweep_bytes(c, n, got)
            rows[(name, l)] = dict(err=err, **timing(
                kern, plain, args, nbytes, keep, "sweep_kernel", name))
            t = rows[(name, l)]
            lines.append(f"{name} with fluxes level {l} N={n}: "
                         f"{t['ms']:.4f} ms/launch (without the fluxes "
                         f"{t['ms0']:.4f}), plain {t['plain_ms']:.4f} ms, "
                         f"bound {t['bound_ms']:.5f} ms ({t['note']}), max "
                         f"abs err {err:.3e}, err / M (du/faces/phi) {rel}")
    u7 = sim.u[lmin]
    shape7 = sim.tree.cell_dims(lmin)
    ud = K._rows_to_vars(u7, None, shape7)
    ok7 = sim.dev[lmin]["ok_dense"].reshape(shape7)
    dt7 = torch.tensor(dtc, dtype=torch.float32, device=dev)
    args7 = (ud, dt7, cfg, sim.dx(lmin), sim.bspec)
    un, phi = fm.fused_step(*args7, ok=ok7, want_flux=True)
    ref, pref = fm.fused_step_ref(*args7, ok=ok7, want_flux=True)
    torch.cuda.synchronize()
    scale = _stencil_scale(ref)
    err7, rel7, ex7 = _local_check(
        (un, phi), (ref, pref),
        (scale, scale[0].expand((3, 2) + tuple(shape7))))
    if not ex7 <= 0.0:
        raise AssertionError(f"fused_muscl with want_flux disagrees with its "
                             f"plain version on level {lmin} of the tracer "
                             f"path: max abs err {err7:.3e}, err / M "
                             f"(un/phi) {rel7}")
    del un, phi, ref, pref, scale
    nbytes7 = 4 * (ud.numel() + ok7.numel() + 1 + ud.numel()
                   + 6 * ok7.numel())
    k1 = dict(err=err7, **timing(
        lambda *a, **k: fm.fused_step(*a, ok=ok7, **k),
        lambda *a, **k: fm.fused_step_ref(*a, ok=ok7, **k),
        args7, nbytes7, 1.0, "fused_muscl_kernel"))
    lines.append(f"fused_muscl with fluxes level {lmin} {tuple(shape7)} "
                 f"with {int(ok7.sum())} refined cells: {k1['ms']:.4f} "
                 f"ms/launch (without the fluxes {k1['ms0']:.4f}), plain "
                 f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.5f} ms "
                 f"({k1['note']}), max abs err {err7:.3e}, err / M (un/phi) "
                 f"{'/'.join(f'{x:.3e}' for x in rel7)}")
    del ud
    _print("phase 24 flux variants at the tracer path's shapes: "
           + "; ".join(lines) + "; library call: none (no single PyTorch "
           "call computes a MUSCL sweep)")

    # ---- 25. where one tracer coarse step's time goes ----
    parts = dict.fromkeys(("regrid", "step", "mc_tracer_amr", "phi fetch"),
                          0.0)

    def timed(fn, key):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t0
            return out
        return call
    fetch = amr_physics._fetch
    sim.regrid = timed(sim.regrid, "regrid")
    sim._source_passes = timed(sim._source_passes, "mc_tracer_amr")
    amr_physics._fetch = timed(fetch, "phi fetch")
    step_coarse = sim.step_coarse
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.regrid()
        dt = sim.coarse_dt()
        t1 = time.perf_counter()
        step_coarse(dt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        amr_physics._fetch = fetch
        del sim.regrid, sim._source_passes
    total = t2 - t0
    parts["step"] = t2 - t1 - parts["mc_tracer_amr"]
    parts["mc_tracer_amr"] -= parts["phi fetch"]
    parts["coarse_dt fetch"] = t1 - t0 - parts["regrid"]
    prof = _profile(lambda: (sim.regrid(), sim.step_coarse(sim.coarse_dt())),
                    os.path.join(ROOT, "chiprun_out"),
                    "chip_smoke_tracer_trace.json", warm=False)
    _print(f"phase 25 one tracer coarse step ({len(sim.tracer_x)} tracers, "
           f"octs {[sim.tree.noct(l) for l in sim.levels()]}): total "
           f"{total:.4f} s, " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         parts.items())
           + f"; profiled: {prof}")
    flux_launches = dict(fused_muscl_flux=r["launches"]["fused_muscl_flux"],
                         tile_sweep_flux=r["launches"]["tile_sweep_flux"])
    del r, sim
    torch.cuda.empty_cache()

    # ---- 26. the stencil variant: oct_blocking=.false. ----
    r = _tracer_run(False, TRACER_STENCIL_STEPS)
    worst_st = _tracer_check(r, "oct_sweep_flux", TRACER_STENCIL_STEPS)
    _print(f"phase 26 MC tracers with oct_blocking=.false.: "
           f"{r['sim'].nstep} coarse steps, launches {r['launches']}; "
           f"{len(r['sim'].tracer_x)} tracers conserved; mass identity "
           f"within rtol {FLUX_RTOL} / atol {FLUX_ATOL} (worst |difference| "
           f"{worst_st:.3e}); evolve {r['wall']:.3f} s")
    flux_launches["oct_sweep_flux"] = r["launches"]["oct_sweep_flux"]
    del r
    torch.cuda.empty_cache()

    def row(name, src, replaces, t, errs):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": flux_launches[name],
                "max_abs_err": max(errs), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None}
    return [
        row("fused_muscl_flux", "ramses_tpu_torch/csrc/fused_muscl.cu",
            "ramses_tpu/hydro/pallas_muscl.py:387", k1,
            [worst["fused_muscl_flux"], err7]),
        row("tile_sweep_flux", "ramses_tpu_torch/csrc/oct_muscl.cu",
            "ramses_tpu/hydro/pallas_oct.py:396", rows[("tile_sweep",
                                                        fine[-1])],
            [worst["tile_sweep_flux"]] + [rows[("tile_sweep", l)]["err"]
                                          for l in fine]),
        row("oct_sweep_flux", "ramses_tpu_torch/csrc/oct_muscl.cu",
            "ramses_tpu/hydro/pallas_oct.py:213", rows[("oct_sweep",
                                                       fine[-1])],
            [worst["oct_sweep_flux"]] + [rows[("oct_sweep", l)]["err"]
                                         for l in fine]),
    ]


def _options_phase(dev):
    """Phase 27: ``namelists/detente.nml`` (1D, ``riemann='exact'``,
    outflow) through ``run_namelist`` on the card (the general formulation
    in f32: no kernel covers 1D) to tend, against the same run in f64 on
    the CPU."""
    import torch
    from ramses_tpu_torch.driver import run_namelist
    t0 = time.perf_counter()
    gpu = run_namelist(DETENTE_NML, ndim=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = run_namelist(DETENTE_NML, ndim=1, dtype=torch.float64,
                       device="cpu")
    got = gpu.state.u.cpu().double()
    want = cpu.state.u
    rel = float(((got - want).abs().amax(dim=1)
                 / want.abs().amax(dim=1)).max())
    if not (gpu.device.type == "cuda" and gpu.cfg.riemann == "exact"
            and bool(torch.isfinite(got).all()) and gpu.nstep == cpu.nstep
            and abs(gpu.t - cpu.t) <= 1e-6 * cpu.t and rel <= 1e-4):
        raise AssertionError(f"detente.nml on the card: nstep {gpu.nstep} "
                             f"(CPU f64 {cpu.nstep}), t {gpu.t} ({cpu.t}), "
                             f"worst field difference {rel:.3e} of its max")
    _print(f"phase 27 detente.nml (riemann='exact', 1D {gpu.grid.shape}, "
           f"outflow) through run_namelist on the card: {gpu.nstep} steps "
           f"to t={gpu.t:.6e} in {wall:.3f} s; against the CPU f64 run, "
           f"worst field difference {rel:.3e} of its max")


POINTMASS_NML = os.path.join(ROOT, "namelists", "pointmass.nml")
MG_N = 128                     # bench.py's bench_mg: 128³ f32, 10 V-cycles
MG_NCYCLE = 10
MG_RESIDUAL = 1e-6             # JAX: 4.871e-7 (TPU, BENCH_r02), 5.106e-7 (CPU)
MG_FFT_REL = 1e-4              # JAX on the CPU: 7.97e-6
GRAV_UNIFORM_LEVEL = 7         # pointmass.nml at 128³
GRAV_UNIFORM_STEPS = 5
GRAV_WARM, GRAV_TIMED = 6, 4   # bench.py's bench_amr_poisson


def _force_law(f, shape, dx: float, rho):
    """Median over the shell 0.2 < r < 0.3 around the box centre of
    |f_r / (M_c / r²) − 1|, M_c the mass above the background: the judge
    of ``tests/test_amr_gravity.py::test_point_mass_force_law_3d``."""
    import numpy as np
    x = (np.indices(shape).reshape(3, -1).T + 0.5) * dx - 0.5
    r = np.sqrt((x ** 2).sum(1))
    f = f.reshape(3, -1).T
    fr = -(f * x).sum(1) / np.maximum(r, 1e-12)
    rho = rho.reshape(-1)
    mass_c = ((rho - rho.min()) * dx ** 3).sum()
    shell = (r > 0.2) & (r < 0.3)
    return float(np.median(np.abs(fr[shell] / (mass_c / r[shell] ** 2)
                                  - 1.0)))


def _gravity_phases(dev, card: str):
    """Phases 31-34: self-gravity (BASELINE config 3 and config 2 with
    self-gravity).  The Poisson layer is the torch formulation (the JAX
    package has no Pallas kernel there): the hydro kernels K1 and K3 run
    on the hierarchy's sweeps, nothing else.  ``card`` (``nvidia-smi``'s
    name and power limit) goes beside each rate."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import kernels as K
    from ramses_tpu_torch.amr.hierarchy import AmrSim, _Cfg1
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.convert import amr_state_from
    from ramses_tpu_torch.driver import Simulation, run_namelist
    from ramses_tpu_torch.pm.coupling import run_steps_pm
    from ramses_tpu_torch.poisson import amr_solve as gs
    from ramses_tpu_torch.poisson import solver

    # ---- 31. config 3: uniform multigrid as bench.py's bench_mg ----
    n = MG_N
    rhs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, n, n))).to(dev, torch.float32)
    rhs = rhs - torch.mean(rhs)
    dx = 1.0 / n
    _reset_counts()
    phi = solver.mg_solve(rhs, dx, phi0=rhs * 0.0, ncycle=MG_NCYCLE)
    torch.cuda.synchronize()

    def run(reps):
        p = phi
        t0 = time.perf_counter()
        for _ in range(reps):
            p = solver.mg_solve(rhs, dx, phi0=p * 0.0, ncycle=MG_NCYCLE)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, p
    reps = 3
    wall, phi = run(reps)
    while wall < 1.0 and reps < 8192:
        reps = min(8192, max(reps * 2, int(reps * 1.3 / max(wall, 1e-3))))
        wall, phi = run(reps)
    if _counts() != _want():
        raise AssertionError(f"mg_solve launched port kernels {_counts()}")
    vps = MG_NCYCLE * reps / wall
    rel = float(torch.linalg.norm(solver.residual(phi, rhs, dx))
                / torch.linalg.norm(rhs))
    phi_fft = solver.fft_solve(rhs, dx)
    fft_rel = float((phi - phi_fft).abs().max() / phi_fft.abs().max())
    if not (bool(torch.isfinite(phi).all()) and rel <= MG_RESIDUAL
            and fft_rel <= MG_FFT_REL):
        raise AssertionError(
            f"mg_solve at {n}³ f32: relative residual {rel:.3e} (limit "
            f"{MG_RESIDUAL:.0e}), max|mg - fft|/max|fft| {fft_rel:.3e} "
            f"(limit {MG_FFT_REL:.0e})")
    one, ten = {}, {}
    _profile(lambda: solver.mg_solve(rhs, dx, phi0=phi * 0.0, ncycle=1),
             None, None, stats=one)
    prof = _profile(lambda: solver.mg_solve(rhs, dx, phi0=phi * 0.0,
                                            ncycle=MG_NCYCLE),
                    None, None, stats=ten)
    per_cycle = (ten["launches"] - one["launches"]) / (MG_NCYCLE - 1)
    fft_ms = _median_ms(lambda: solver.fft_solve(rhs, dx), reps=20)
    nlev = solver._mg_levels(tuple(rhs.shape))
    _print(f"phase 31 config 3 multigrid on {card}: {n}³ f32 ({nlev} "
           f"coarsenings, "
           f"2+2 red-black sweeps, 32 on the coarsest): "
           f"{reps} solves of {MG_NCYCLE} V-cycles in {wall:.4f} s = "
           f"{vps:.4f} V-cycles/s; relative residual after {MG_NCYCLE} "
           f"V-cycles {rel:.4e}; max|mg - fft|/max|fft| {fft_rel:.4e}; "
           f"{per_cycle:.1f} kernel launches a V-cycle; one solve "
           f"profiled: {prof}; fft_solve {fft_ms:.4f} ms")
    del rhs, phi, phi_fft
    torch.cuda.empty_cache()

    # ---- 32. uniform self-gravity hydro: pointmass.nml at 128³ f32 ----
    p = load_params(POINTMASS_NML, ndim=3)
    p.amr.levelmin = p.amr.levelmax = GRAV_UNIFORM_LEVEL
    p.run.nstepmax = GRAV_UNIFORM_STEPS
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim = Simulation(p)
    mass0 = float(sim.totals()["mass"])
    f_card = sim.state.f.double().cpu()
    sim.evolve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    mass1 = float(sim.totals()["mass"])
    u, f = sim.state.u, sim.state.f
    shape = sim.grid.shape
    # the initial force against the same set-up in f64 on the CPU
    f_cpu = Simulation(p, dtype=torch.float64, device="cpu").state.f
    f_rel = float((f_card - f_cpu).abs().max() / f_cpu.abs().max())
    law = _force_law(f.double().cpu().numpy(), shape, sim.dx,
                     u[0].double().cpu().numpy())
    if not (sim.nstep == GRAV_UNIFORM_STEPS and bool(torch.isfinite(u).all())
            and bool(torch.isfinite(f).all())
            and abs(mass1 - mass0) <= 1e-5 * abs(mass0)
            and launches == _want() and f_rel <= 1e-4 and law < 0.2):
        raise AssertionError(
            f"pointmass.nml at {shape}: {sim.nstep} steps, mass {mass0} -> "
            f"{mass1}, launches {launches}, initial force against the CPU "
            f"f64 solve {f_rel:.3e} of max|f| (limit 1e-4), force law "
            f"median |f_r r²/M - 1| {law:.3f} (limit 0.2)")
    t = torch.tensor(sim.t, dtype=torch.float64, device=dev)
    tend = torch.tensor(1e30, dtype=torch.float64, device=dev)

    def steps():
        return run_steps_pm(sim.grid, sim.gspec, sim.pspec, u, None, f, t,
                            tend, t.new_zeros(()), 2)
    step_ms = _median_ms(steps, reps=5, warm=1) / 2
    prof = _profile(steps, None, None)
    _print(f"phase 32 uniform self-gravity on {card}: pointmass.nml "
           f"{shape} f32 "
           f"through Simulation (FFT solve, the general hydro formulation): "
           f"{sim.nstep} steps t={sim.t:.6e} in {wall:.3f} s (incl. set-up "
           f"and the initial solve); mass {mass0:.9e} -> {mass1:.9e}; port "
           f"kernels launched {launches}; initial force against the CPU f64 "
           f"solve {f_rel:.3e} of max|f|; point-mass law median "
           f"|f_r r²/M - 1| on 0.2 < r < 0.3: {law:.4f}; run_steps_pm x2: "
           f"{step_ms:.4f} ms/step = "
           f"{sim.grid.ncell / (step_ms * 1e-3):.4e} cell-updates/s; "
           f"profiled 2 steps: {prof}")
    del sim, u, f, f_card, f_cpu
    torch.cuda.empty_cache()

    # ---- 33. config 2 with self-gravity, as bench.py's bench_amr_poisson ----
    p = _amr_params()
    p.run.poisson = True
    lmin = p.amr.levelmin
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim = AmrSim(p)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mass0 = float(sim.totals()["mass"])
    stepped = []
    step_coarse = sim.step_coarse
    sim.step_coarse = lambda dt: (stepped.append(tuple(sim.levels())),
                                  step_coarse(dt))
    t0 = time.perf_counter()
    sim.evolve(1e9, nstepmax=GRAV_WARM)
    sim.drain()
    warm_s = time.perf_counter() - t0
    iters, updates = 0, 0
    per_step = []
    t0 = time.perf_counter()
    for _ in range(GRAV_TIMED):
        sim.regrid()
        updates += sim.updates_per_step()
        sim.step_coarse(sim.coarse_dt())
        it = {l: int(v) for l, v in sim.poisson_iters.items()}
        per_step.append(it)
        iters += sum(it.values())
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse
    want = _want(fused_muscl=len(stepped),
                 tile_sweep=sum(2 ** (l - lmin) for lv in stepped for l in lv
                                if l > lmin))
    mass1 = float(sim.totals()["mass"])
    finite = all(bool(torch.isfinite(sim.phi[l]).all())
                 and bool(torch.isfinite(sim.fg[l]).all())
                 and bool(torch.isfinite(sim.u[l]).all())
                 for l in sim.levels())
    if not (sim.nstep == GRAV_WARM + GRAV_TIMED
            and len(stepped) == sim.nstep and launches == want and finite
            and set(sim.fg) == set(sim.levels())
            and abs(mass1 - mass0) <= 1e-5 * abs(mass0)):
        raise AssertionError(
            f"config 2 with self-gravity: {sim.nstep} steps on "
            f"{sim.levels()}, launches {launches} (expected {want}), "
            f"phi/fg/u finite {finite}, fg levels {sorted(sim.fg)}, leaf "
            f"mass {mass0} -> {mass1}")
    octs = {l: sim.tree.noct(l) for l in sim.levels()}
    ladder = {l: len(sim.dev[l].get("g_mg", ())) for l in sim.levels()}
    _print(f"phase 33 config 2 with self-gravity on {card}: sedov3d "
           f"levelmin={lmin} "
           f"levelmax={p.amr.levelmax} poisson=.true., AmrSim() "
           f"{init_s:.3f} s, {GRAV_WARM} warm coarse steps {warm_s:.3f} s, "
           f"then {GRAV_TIMED} timed (regrid + coarse step each) in "
           f"{wall:.4f} s: {iters / wall:.4f} PCG iterations/s, "
           f"{iters / GRAV_TIMED:.2f} iterations a step (per step and "
           f"level {per_step}), {updates / wall:.4e} cell-updates/s; octs "
           f"per level {octs}, multigrid ladder depth per partial level "
           f"{ladder}; launches {launches} (expected {want}); leaf mass "
           f"{mass0:.9e} -> {mass1:.9e}; phi, fg and u finite on every "
           f"level")

    # where a coarse step's time goes, with the solve as a part
    def coarse_step():
        sim.regrid()
        sim.step_coarse(sim.coarse_dt())
    walls, _ = _host_breakdown(
        sim, coarse_step, parts=("_flag_and_tree", "_rebuild_maps",
                                 "_migrate_level", "_restrict_all",
                                 "coarse_dt", "step_coarse",
                                 "solve_gravity"),
        nested=("solve_gravity",))
    # a PCG solve's launches and busy share: the finest level's solve cut
    # to 0 and to 10 iterations (a whole solve runs 200)
    lf = sim.levels()[-1]
    d = sim.dev[lf]
    rhs_l = sim.grav_coeff() * (sim.u[lf][:, 0] - float(
        sim.totals()["mass"]) / sim.boxlen ** 3)
    ghosts = K.interp_cells(sim.phi[lf - 1][:, None], d["g_cell"],
                            d["g_gnb"], d["g_sgn"], _Cfg1(3), itype=1)[:, 0]

    def pcg(k):
        return lambda: gs.pcg_level(
            rhs_l, ghosts, d["g_nb"], d["g_octnb"], sim.dx(lf),
            d["g_valid"], 3, tol=float(p.poisson.epsilon), iters=k,
            phi0=sim.phi[lf], mg=d["g_mg"])
    zero, ten = {}, {}
    _profile(pcg(0), None, None, stats=zero)
    prof = _profile(pcg(10), None, None, stats=ten)
    per_iter = (ten["launches"] - zero["launches"]) / 10
    _print(f"phase 33 where a coarse step's time goes (octs "
           f"{[sim.tree.noct(l) for l in sim.levels()]}): wall by part, "
           f"each synchronised: {walls}; the level-{lf} PCG "
           f"({sim.tree.noct(lf)} octs): {per_iter:.1f} kernel launches "
           f"an iteration, 10 iterations profiled: {prof}")

    # replay: 3 coarse steps twice from one state, bitwise
    state = amr_state_from(sim)

    def three_steps():
        s = AmrSim.from_state(p, **state)
        s.evolve(1e9, nstepmax=s.nstep + 3)
        s.drain()
        return s
    a, b = three_steps(), three_steps()
    for l in a.levels():
        same = (np.array_equal(a.tree.levels[l].keys, b.tree.levels[l].keys)
                and torch.equal(a.u[l], b.u[l])
                and torch.equal(a.phi[l], b.phi[l])
                and torch.equal(a.fg[l], b.fg[l]))
        if not same:
            raise AssertionError(f"self-gravity replay of 3 AMR steps is "
                                 f"not bitwise equal on level {l}")
    if {l: int(v) for l, v in a.poisson_iters.items()} != \
            {l: int(v) for l, v in b.poisson_iters.items()}:
        raise AssertionError("self-gravity replay: PCG iteration counts "
                             "differ")
    _print(f"phase 33 replay: 3 coarse steps with self-gravity twice from "
           f"one state, bitwise equal (u, phi, fg, trees, PCG iterations "
           f"{ {l: int(v) for l, v in a.poisson_iters.items()} })")
    del sim, a, b, state
    torch.cuda.empty_cache()

    # ---- 34. namelists/pointmass.nml as the CLI runs it ----
    p = load_params(POINTMASS_NML, ndim=3)
    mass0 = float(AmrSim(p).totals()["mass"])
    stepped = []
    step_coarse = AmrSim.step_coarse

    def counted(self, dt):
        stepped.append(tuple(self.levels()))
        return step_coarse(self, dt)
    AmrSim.step_coarse = counted
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        sim = run_namelist(POINTMASS_NML, ndim=3)
        sim.drain()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        AmrSim.step_coarse = step_coarse
    lmin = p.amr.levelmin
    want = _want(fused_muscl=len(stepped),
                 tile_sweep=sum(2 ** (l - lmin) for lv in stepped for l in lv
                                if l > lmin))
    mass1 = float(sim.totals()["mass"])
    if not (isinstance(sim, AmrSim) and sim.nstep == p.run.nstepmax
            and launches == want
            and all(bool(torch.isfinite(sim.u[l]).all())
                    and bool(torch.isfinite(sim.fg[l]).all())
                    for l in sim.levels())
            and abs(mass1 - mass0) <= 1e-5 * abs(mass0)):
        raise AssertionError(
            f"pointmass.nml through run_namelist: {sim.nstep} steps, "
            f"launches {launches} (expected {want}), mass {mass0} -> "
            f"{mass1}")
    _print(f"phase 34 pointmass.nml through run_namelist (levelmin="
           f"{p.amr.levelmin}, levelmax={p.amr.levelmax}): {sim.nstep} "
           f"coarse steps t={sim.t:.6e} in {wall:.3f} s, octs "
           f"{[sim.tree.noct(l) for l in sim.levels()]}, PCG iterations "
           f"{ {l: int(v) for l, v in sim.poisson_iters.items()} }, "
           f"launches {launches} (expected {want}), mass {mass0:.9e} -> "
           f"{mass1:.9e}")


# the slab-sharded paths: 8 shards of the one card, as the JAX package's
# tests run 8 virtual devices of one CPU
NSHARD = 8
K5_CASES = ((2, 4, 8), (5, 6, 10, 13))     # shard counts, block shape


def _queued_ms(fn, n: int = 50) -> float:
    """Device ms a call of ``fn``: CUDA events around ``n`` calls queued
    behind a sleeping kernel, so that the card runs them back to back and
    the window holds their device time and the gaps between them, not the
    host's dispatch.  The profiler's count of a window can miss launches
    (phase 24, and K5 in a long run), which this does not depend on."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))   # ~0.1 s, longer than issuing the calls
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _ring_pairs(blocks, ax: int, ng: int, ghost_region: bool = False):
    """Every shard's high slab along ``ax`` to its +1 neighbour and its low
    slab to its -1 neighbour, as the ``(src, dst)`` pairs of
    :func:`dma_halo.halo_exchange` (one K5 launch): into fresh contiguous
    tensors, as ``exchange_slabs`` has them, or into the ghost regions of
    the receivers' blocks extended along ``ax``."""
    import torch
    n = len(blocks)
    pairs = []
    for s, b in enumerate(blocks):
        for src, off in ((b.narrow(ax, b.shape[ax] - ng, ng), 0),
                         (b.narrow(ax, 0, ng), b.shape[ax] + ng)):
            if ghost_region:
                shape = list(b.shape)
                shape[ax] += 2 * ng
                dst = b.new_zeros(shape).narrow(ax, off, ng)
            else:
                dst = torch.empty_like(src,
                                       memory_format=torch.contiguous_format)
            pairs.append((src, dst))
    return pairs


def _k5_check(pairs, what: str) -> float:
    """K5 over ``pairs`` into its destinations, NaN-filled first, against
    its plain version into NaN-filled copies of them: raises unless they
    are bitwise equal and K5 launched exactly once.  Returns the max abs
    error."""
    import torch
    from ramses_tpu_torch.parallel import dma_halo
    for _, d in pairs:
        d.fill_(float("nan"))
    ref = [(s, torch.full_like(d, float("nan"))) for s, d in pairs]
    n0 = dma_halo.launches
    dma_halo.halo_exchange(pairs)
    n = dma_halo.launches - n0
    dma_halo.halo_exchange_ref(ref)
    torch.cuda.synchronize()
    if n != 1 or not all(torch.equal(d, r) for (_, d), (_, r)
                         in zip(pairs, ref)):
        raise AssertionError(f"halo_exchange disagrees with its plain "
                             f"version (or launched {n} times): {what}")
    return max(float((d - r).abs().max()) for (_, d), (_, r)
               in zip(pairs, ref))


def _valid_scale(up):
    """Max of ``|up|`` over each interior cell's 5³ stencil in a block
    padded by 2 on every axis, per field: the magnitudes the cell's step
    reads."""
    import torch.nn.functional as F
    return F.max_pool3d(up.abs()[None], 5, stride=1)[0]


def _parallel_phases(dev):
    """Phases 28-30 (the slab-sharded slice); returns the kernels line's
    rows of K5 (at the uniform exchange, and at the AMR sweep's z
    exchange) and of K1's padded entry."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.grid import uniform
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.parallel import dense_slab, dma_halo
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.halo import _pad_rest
    from ramses_tpu_torch.parallel.halo import run_steps_halo
    from ramses_tpu_torch.parallel.mesh import ShardMesh

    # ---- 28. K5 against its plain version, and its time ----
    ncase = 0
    for nshard in K5_CASES[0]:
        for dtype in (torch.float32, torch.float64):
            g = torch.Generator(device="cpu").manual_seed(nshard)
            blocks = [torch.randn(K5_CASES[1], generator=g, dtype=dtype)
                      .to(dev) for _ in range(nshard)]
            for ax in (1, 2, 3):
                for ng, ghost_region in ((2, False), (2, True), (1, False)):
                    _k5_check(_ring_pairs(blocks, ax, ng, ghost_region),
                              f"{nshard} shards, {dtype}, axis {ax}, ng {ng}, "
                              f"ghost region {ghost_region}")
                    ncase += 1
    # at the uniform path's exchange: 8 shards of 256³ rest-padded, 16 slabs
    # of [5, 2, 260, 260] f32
    g = torch.Generator(device=dev).manual_seed(28)
    upr = [torch.rand((5, 32, 260, 260), generator=g, device=dev)
           for _ in range(NSHARD)]
    pairs = _ring_pairs(upr, 1, 2)
    slab_bytes = sum(s.numel() * s.element_size() for s, _ in pairs)
    k5_err = _k5_check(pairs, f"the uniform path's {len(pairs)} slabs")
    k5_ms = _queued_ms(lambda: dma_halo.halo_exchange(pairs))
    k5_plain_ms = _queued_ms(lambda: dma_halo.halo_exchange_ref(pairs))
    dsts, srcs = [d for _, d in pairs], [s for s, _ in pairs]
    k5_lib_ms = _queued_ms(lambda: torch._foreach_copy_(dsts, srcs))
    torch.cuda.synchronize()
    if not all(torch.equal(s, d) for s, d in pairs):
        raise AssertionError("torch._foreach_copy_ moved other bytes")
    k5_bound = 1e3 * 2 * slab_bytes / HBM_BYTES_PER_S
    del upr, pairs, dsts, srcs
    # at the AMR level-7 exchanges of phase 30: 8 shards of 64³, the x
    # exchange on the box, y on the box extended along x, z on the box
    # extended along x and y; the sweep's carry the state and its mask
    # (ng 2), the flag pass's the state alone (ng 1)
    amr, amr_err = {}, 0.0
    for kind, ng, masked in (("sweep", 2, True), ("flags", 1, False)):
        for ax, name in enumerate("xyz"):
            sp = [64 + 2 * ng if a < ax else 64 for a in range(3)]
            blk = [torch.rand([5] + sp, generator=g, device=dev)
                   for _ in range(NSHARD)]
            pairs = _ring_pairs(blk, 1 + ax, ng)
            if masked:
                msk = [torch.rand(sp, generator=g, device=dev)
                       for _ in range(NSHARD)]
                pairs += _ring_pairs(msk, ax, ng)
            nbytes = sum(s.numel() * 4 for s, _ in pairs)
            row = pairs[0][0].shape[-1] * 4 if ax == 2 else None
            amr_err = max(amr_err, _k5_check(
                pairs, f"the AMR level-7 {kind} {name} exchange's "
                f"{len(pairs)} slabs"))
            amr[(kind, name)] = dict(
                ms=_queued_ms(lambda: dma_halo.halo_exchange(pairs)),
                bytes=nbytes, n=len(pairs), row=row)
            if (kind, name) == ("sweep", "z"):
                # the case the kernels line reports: the most launches
                dsts, srcs = [d for _, d in pairs], [s for s, _ in pairs]
                amr_lib_ms = _queued_ms(
                    lambda: torch._foreach_copy_(dsts, srcs))
                amr_plain_ms = _queued_ms(
                    lambda: dma_halo.halo_exchange_ref(pairs))
                # the same bytes from contiguous sources: what the 8-byte
                # rows every 256 bytes cost
                flat = [(s.contiguous(), d) for s, d in pairs]
                amr_flat_ms = _queued_ms(
                    lambda: dma_halo.halo_exchange(flat))
                del dsts, srcs, flat
            del blk, pairs
            if masked:
                del msk
    torch.cuda.empty_cache()
    k5_err = max(k5_err, amr_err)
    z = amr[("sweep", "z")]
    amr_bound = 1e3 * 2 * z["bytes"] / HBM_BYTES_PER_S
    amr_line = "; ".join(
        f"{kind} {name} ({v['n']} slabs, {v['bytes'] / 1e6:.3f} MB"
        + (f", {v['row']}-byte rows" if v["row"] else "")
        + f"): {v['ms']:.4f} ms/launch, bound "
        f"{1e3 * 2 * v['bytes'] / HBM_BYTES_PER_S:.5f} ms"
        for (kind, name), v in amr.items())
    _print(f"phase 28 halo_exchange (K5) check: {ncase} cases ({K5_CASES[0]}"
           f" shards of {K5_CASES[1]}, f32 and f64, each axis, depth 1 and "
           f"2, fresh and ghost-region destinations) bitwise equal to the "
           f"plain version, one launch each; uniform path's exchange "
           f"({2 * NSHARD} slabs of [5, 2, 260, 260] f32, "
           f"{slab_bytes / 1e6:.3f} MB, bitwise equal to the plain version, "
           f"one launch): {k5_ms:.4f} ms/launch, plain {k5_plain_ms:.4f} ms, "
           f"torch._foreach_copy_ {k5_lib_ms:.4f} ms (each on the device: "
           f"queued CUDA events), bound {k5_bound:.5f} ms by bytes "
           f"({2 * slab_bytes / 1e6:.3f} MB read and written); the AMR "
           f"level-7 exchanges of phase 30, each bitwise equal to the plain "
           f"version in one launch: {amr_line}; at the sweep's z exchange "
           f"plain {amr_plain_ms:.4f} ms, torch._foreach_copy_ "
           f"{amr_lib_ms:.4f} ms, K5 from contiguous copies of its sources "
           f"{amr_flat_ms:.4f} ms")

    # ---- 29. uniform sedov3d 256³ through run_steps_halo on 8 shards ----
    p = load_params(NML, ndim=3)
    sim = Simulation(p)
    grid, cfg = sim.grid, sim.cfg
    u0 = sim.state.u
    tend = sim.tend
    nsteps = p.run.nstepmax
    mesh = ShardMesh([dev] * NSHARD)
    mass0 = float(uniform.totals(u0, cfg, grid.dx)["mass"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ur, tr, nr = uniform.run_steps(grid, u0, 0.0, tend, nsteps)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    _reset_counts()
    dma_halo.reset_traffic()
    t0 = time.perf_counter()
    uh, th, nh = run_steps_halo(grid, mesh, u0, 0.0, tend, nsteps)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    launches29 = _counts()
    halo_bytes = dma_halo.TRAFFIC["bytes"] / nsteps
    overlap = dma_halo.TRAFFIC["overlap_frac"]
    # the overlap split: an interior call and two strips a shard a step
    per = 3 if grid.shape[0] // NSHARD > 4 else 1
    want = _want(halo_exchange=nsteps,
                 fused_muscl_padded=per * NSHARD * nsteps)
    if launches29 != want or int(nh) != nsteps:
        raise AssertionError(f"run_steps_halo launched {launches29} in "
                             f"{int(nh)} steps, expected {want}")
    mass1 = float(uniform.totals(uh, cfg, grid.dx)["mass"])
    if not bool(torch.isfinite(uh).all()):
        raise AssertionError("run_steps_halo state is not finite")
    if abs(mass1 - mass0) > 1e-5 * abs(mass0):
        raise AssertionError(f"run_steps_halo mass not conserved: {mass0} "
                             f"-> {mass1}")
    if torch.equal(uh, ur) and float(th) == float(tr):
        same = "bitwise equal to the single-device run_steps"
    else:
        err = (uh - ur).abs()
        scale = _stencil_scale(ur)
        excess = float((err - (LOCAL_ATOL + LOCAL_RTOL * scale)).max())
        rel = [float((err[c] / scale[c]).nan_to_num(nan=0.0).max())
               for c in range(5)]
        same = (f"NOT bitwise equal to the single-device run_steps: max abs "
                f"err {float(err.max()):.3e}, err / stencil max per field "
                f"{[f'{x:.3e}' for x in rel]}, t {float(th)!r} against "
                f"{float(tr)!r}")
        if not excess <= 0.0 or abs(float(th) - float(tr)) > 1e-6 * float(tr):
            raise AssertionError(f"run_steps_halo parts from run_steps: "
                                 f"{same}")
        del err, scale
    steady_ms = _median_ms(lambda: run_steps_halo(grid, mesh, u0, 0.0, tend,
                                                  nsteps), reps=3, warm=1)
    prof = _profile(lambda: run_steps_halo(grid, mesh, u0, 0.0, tend,
                                           nsteps),
                    os.path.join(ROOT, "chiprun_out"),
                    "chip_smoke_halo_trace.json")
    # K1's padded entry at the path's shapes on the final state: shard 0's
    # interior call of the split (without the split, its whole block)
    nloc = grid.shape[0] // NSHARD
    blk = uh[:, :nloc] if per == 3 else torch.roll(uh, 2, 1)[:, :nloc + 4]
    upr = _pad_rest(blk.contiguous(), 3, 2)
    dt = uniform.cfl_dt(grid, uh).to(torch.float32)
    args = (upr, dt, cfg, grid.dx)
    got, dtn = fm.fused_step_padded(*args, courant=True)
    ref, dtr = fm.fused_step_padded_ref(*args, courant=True)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    scale = _valid_scale(upr)
    excess = float((err - (LOCAL_ATOL + LOCAL_RTOL * scale)).max())
    k1p_err = float(err.max())
    k1p_rel = [float((err[c] / scale[c]).nan_to_num(nan=0.0).max())
               for c in range(5)]
    dt_rel = abs(float(dtn) - float(dtr)) / float(dtr)
    if not (excess <= 0.0 and dt_rel <= DT_REL):
        raise AssertionError(f"fused_muscl_padded disagrees with its plain "
                             f"version at {tuple(upr.shape)}: max abs err "
                             f"{k1p_err:.3e}, err / stencil max per field "
                             f"{k1p_rel}, dt rel {dt_rel:.3e}")
    del err, scale
    k1p_ms = _queued_ms(lambda: fm.fused_step_padded(*args, courant=True),
                        n=20)
    k1p_plain_ms = _median_ms(lambda: fm.fused_step_padded_ref(
        *args, courant=True), reps=5)
    keep = got[0].numel() / upr[0].numel()
    nops = _count_ops(lambda: fm.fused_step_padded_ref(*args,
                                                       courant=True)) * keep
    nbytes = 4 * (upr.numel() + got.numel() + 2)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F32_OPS_PER_S
    k1p_bound = max(bytes_ms, ops_ms)
    k1p_by = "bytes" if bytes_ms >= ops_ms else "operations"
    ncell = grid.ncell
    _print(f"phase 29 uniform sedov3d {grid.shape} through run_steps_halo on "
           f"{NSHARD} shards of the card (halo_backend auto -> dma, overlap "
           f"split {overlap:.4f} of a shard's planes): {int(nh)} steps "
           f"t={float(th):.6e}, launches {launches29} (expected {want}); "
           f"{same}; mass {mass0:.9e} -> {mass1:.9e}; halo "
           f"{halo_bytes / 1e6:.3f} MB a step; first run {wall8:.4f} s = "
           f"{ncell * nsteps / wall8:.4e} cell-updates/s, steady "
           f"{steady_ms:.3f} ms = {ncell * nsteps / steady_ms * 1e3:.4e} "
           f"cell-updates/s (single-device run_steps {wall1:.4f} s); "
           f"profiled: {prof}; fused_muscl_padded at shard 0's call "
           f"{tuple(upr.shape)} -> {tuple(got.shape)}: {k1p_ms:.4f} "
           f"ms/launch (queued CUDA events), plain {k1p_plain_ms:.4f} ms, "
           f"bound "
           f"{k1p_bound:.4f} ms by {k1p_by} ({nbytes / 1e9:.4f} GB -> "
           f"{bytes_ms:.4f} ms; {nops / 1e9:.4f} G ops -> {ops_ms:.4f} ms), "
           f"max abs err {k1p_err:.3e}, err / stencil max per field "
           f"{[f'{x:.3e}' for x in k1p_rel]}, dt rel {dt_rel:.3e}")
    del sim, u0, ur, uh, blk, upr, got, ref, args
    torch.cuda.empty_cache()

    # ---- 30. sedov3d AMR levelmin=7, levelmax=9 on ShardedAmrSim ----
    p = _amr_params()
    lmin = AMR_LEVELS[0]
    tend = p.output.tout[-1] if p.output.tout else p.output.tend
    s1 = AmrSim(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1.evolve(tend, nstepmax=p.run.nstepmax)
    s1.drain()
    s1_rate = s1.cell_updates / (time.perf_counter() - t0)
    calls = {"sweep": 0, "flags": 0}
    sweep, flags = dense_slab.dense_sweep_slab, dense_slab.dense_flags_slab

    def counted(fn, key):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    dense_slab.dense_sweep_slab = counted(sweep, "sweep")
    dense_slab.dense_flags_slab = counted(flags, "flags")
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        s8 = ShardedAmrSim(p, devices=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mass0 = float(s8.totals()["mass"])
        stepped = []
        step_coarse = s8.step_coarse
        s8.step_coarse = lambda dt: (stepped.append(tuple(s8.levels())),
                                     step_coarse(dt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s8.evolve(tend, nstepmax=p.run.nstepmax)
        s8.drain()
        wall = time.perf_counter() - t0
        launches30 = _counts()
        del s8.step_coarse
    finally:
        dense_slab.dense_sweep_slab, dense_slab.dense_flags_slab = \
            sweep, flags
    spec7 = s8._fused_spec().slab[0]
    ncut = sum(pm is not None for pm in spec7.perms)
    per = 3 if dense_slab._split_axis(spec7, 2) is not None else 1
    want = _want(halo_exchange=ncut * (calls["sweep"] + calls["flags"]),
                 fused_muscl_padded=per * NSHARD * calls["sweep"],
                 tile_sweep=sum(2 ** (l - lmin) for lv in stepped for l in lv
                                if l > lmin))
    if (spec7 is None or spec7.backend != "dma" or spec7.grid != (2, 2, 2)
            or calls["sweep"] != len(stepped) or s8.nstep != 10):
        raise AssertionError(f"ShardedAmrSim did not sweep level {lmin} by "
                             f"slabs each coarse step: {spec7}, {calls}, "
                             f"{len(stepped)} steps, nstep {s8.nstep}")
    if launches30 != want:
        raise AssertionError(f"ShardedAmrSim launched {launches30}, "
                             f"expected {want}")
    mass1 = float(s8.totals()["mass"])
    if abs(mass1 - mass0) > 1e-5 * abs(mass0):
        raise AssertionError(f"ShardedAmrSim leaf mass not conserved: "
                             f"{mass0} -> {mass1}")
    if s8.levels() != s1.levels() or not all(
            np.array_equal(s8.tree.levels[l].keys, s1.tree.levels[l].keys)
            for l in s1.levels()):
        raise AssertionError("ShardedAmrSim and AmrSim trees differ")
    if all(torch.equal(s8.u[l], s1.u[l]) for l in s1.levels()):
        same30 = "bitwise equal to AmrSim on every level"
    else:
        worst = 0.0
        for l in s1.levels():
            n = s1.tree.noct(l) * 8
            a, b = s1.u[l][:n], s8.u[l][:n]
            worst = max(worst, float(((b - a).abs()
                                      / a.abs().amax(dim=0)).max()))
        same30 = (f"NOT bitwise equal to AmrSim: worst |difference| / field "
                  f"max {worst:.3e}")
        if not worst <= AMR_REL:
            raise AssertionError(f"ShardedAmrSim parts from AmrSim: "
                                 f"{same30}")
    octs = {l: s8.tree.noct(l) for l in s8.levels()}
    nstep30, t30 = s8.nstep, s8.t
    prof30 = _profile(lambda: (s8.regrid(), s8.step_coarse(s8.coarse_dt())),
                      os.path.join(ROOT, "chiprun_out"),
                      "chip_smoke_sharded_amr_trace.json", warm=False)
    _print(f"phase 30 sedov3d AMR levelmin={lmin} levelmax={AMR_LEVELS[1]} on "
           f"ShardedAmrSim, {NSHARD} shards of the card (level {lmin}: shard "
           f"grid {spec7.grid}, local box {spec7.loc}, {spec7.backend}): "
           f"{nstep30} coarse steps t={t30:.6e}, octs {octs}, "
           f"{calls['sweep']} slab sweeps and {calls['flags']} slab flag "
           f"passes, launches {launches30} (expected {want}); {same30}; leaf "
           f"mass {mass0:.9e} -> {mass1:.9e}; ShardedAmrSim() {init_s:.3f} "
           f"s, evolve {wall:.3f} s = {s8.cell_updates / wall:.4e} "
           f"cell-updates/s (AmrSim, the same run: {s1_rate:.4e}); one "
           f"more coarse step profiled: {prof30}")
    del s1, s8
    torch.cuda.empty_cache()

    k5 = {"name": "halo_exchange", "route": "cuda",
          "source": "ramses_tpu_torch/csrc/halo_exchange.cu",
          "replaces": "ramses_tpu/parallel/dma_halo.py:209",
          "launches": launches29["halo_exchange"]
          + launches30["halo_exchange"],
          "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
          "bound_ms": k5_bound, "bound_by": "bytes",
          "library_ms": k5_lib_ms}
    # the same kernel at the AMR sweep's z exchange, where phase 30 spends
    # most of its K5 time: a row of its own, so that each row keeps one
    # shape from run to run
    k5z = dict(k5, name="halo_exchange_amr_z",
               launches=launches30["halo_exchange"], max_abs_err=amr_err,
               ms=z["ms"], plain_ms=amr_plain_ms, bound_ms=amr_bound,
               library_ms=amr_lib_ms)
    k1p = {"name": "fused_muscl_padded", "route": "cuda",
           "source": "ramses_tpu_torch/csrc/fused_muscl.cu",
           "replaces": "ramses_tpu/hydro/pallas_muscl.py:387",
           "launches": launches29["fused_muscl_padded"]
           + launches30["fused_muscl_padded"],
           "max_abs_err": k1p_err, "ms": k1p_ms, "plain_ms": k1p_plain_ms,
           "bound_ms": k1p_bound, "bound_by": k1p_by, "library_ms": None}
    return [k5, k5z, k1p]


# ---------------------------------------------------------------------------
# phases 35-38: snapshots, restarts and supervised runs
# ---------------------------------------------------------------------------

# phase 38's CLI run: the copy of sedov3d.nml reaches its output time after
# CLI_STEPS steps (measured in process first), its continuation CLI_MORE
# steps later
CLI_STEPS, CLI_MORE = 400, 50
CLI_TIMEOUT = 600
# phase 35: the restarted config 1 against 10 straight steps, max |Δ| /
# (1e-10 + M).  Not 0: the uniform driver recomputes the Courant dt at a
# chunk's start (``cfl_dt``) where a chunk goes on with K1's in-kernel dt,
# and a restart starts a chunk; 2.648e-5 in every run measured
RESTART_DRIFT = 5e-5


def _timed_dump(dump):
    """Run ``dump()`` (it returns the output directory) with the snapshot
    writer's stages timed by wrapping them: the device→host fetch
    (``host64``), the conversion to primitives (``cons_to_prim_out``), the
    assembly of the octs and levels (the rest of the snapshot's build),
    the writing of the files (``dump_all`` less the manifest) and the hash
    and fsync of every file (``write_manifest``).  Returns (path, wall s,
    bytes written, seconds by stage)."""
    import torch
    from ramses_tpu_torch.io import snapshot as snapmod
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    acc = {"d2h": 0.0, "to_primitive": 0.0, "dump_all": 0.0,
           "hash_fsync": 0.0}
    saved = []
    for mod, name, key in ((snapmod, "host64", "d2h"),
                           (snapmod, "cons_to_prim_out", "to_primitive"),
                           (snapmod, "dump_all", "dump_all"),
                           (ckpt, "write_manifest", "hash_fsync")):
        real = getattr(mod, name)

        def timed(*a, _real=real, _key=key, **k):
            t0 = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                acc[_key] += time.perf_counter() - t0
        saved.append((mod, name, real))
        setattr(mod, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dump()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    nbytes = sum(os.path.getsize(os.path.join(out, f))
                 for f in os.listdir(out))
    parts = {"d2h": acc["d2h"], "to_primitive": acc["to_primitive"],
             "assemble": wall - acc["dump_all"] - acc["d2h"]
             - acc["to_primitive"],
             "write": acc["dump_all"] - acc["hash_fsync"],
             "hash_fsync": acc["hash_fsync"]}
    return out, wall, nbytes, parts


def _dump_line(wall, nbytes, parts) -> str:
    split = ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
    return (f"{nbytes} bytes in {wall:.3f} s ({nbytes / wall / 1e9:.3f} "
            f"GB/s; {nbytes / max(parts['write'], 1e-9) / 1e9:.3f} GB/s "
            f"while writing): {split}")


def _round_trip(got, want, axis: int):
    """A restored f32 state against the one dumped: (worst |Δ| in ulps of
    each value, worst |Δ| over its field's max, pass).  Each value passes
    within one ulp of itself (the file holds f64 primitives and E is
    rebuilt from them; every restore measured so far is bitwise)."""
    import torch
    d = (got - want).abs()
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    dims = [i for i in range(want.dim()) if i != axis % want.dim()]
    fmax = a.amax(dim=dims, keepdim=True)
    ulps = d / ulp
    rel = (d / fmax).nan_to_num(nan=0.0)
    return float(ulps.max()), float(rel.max()), bool((ulps <= 1.0).all())


def _restart_phases(dev, card: str):
    """Phases 35-38 in a scratch directory that is removed at the end."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        _restart_uniform(dev, tmp)
        _restart_amr(dev, tmp)
        _restart_mhd(dev, tmp)
        _restart_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _print(f"phases 35-38 on {card}")


def _restart_uniform(dev, tmp: str):
    """Phase 35: config 1 at 256³, 10 steps straight against 5, dump,
    restore, 5."""
    import torch
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    p10 = load_params(NML, ndim=3)
    straight = Simulation(p10)
    mass0 = float(straight.totals()["mass"])
    straight.evolve()
    u_straight = straight.state.u
    del straight
    p5 = load_params(NML, ndim=3)
    p5.run.nstepmax = 5
    sim = Simulation(p5)
    sim.evolve()
    # mid-run, before the output time: an emergency checkpoint's number
    # (900 on, as OpsGuard's), so that the restore resumes the schedule
    out, wall, nbytes, parts = _timed_dump(
        lambda: sim.dump(900, os.path.join(tmp, "uniform")))
    ok, reason = ckpt.validate_checkpoint(out)
    if not ok:
        raise AssertionError(f"phase 35 dump does not validate: {reason}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = Simulation.from_snapshot(load_params(NML, ndim=3), out)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ulps, rel, rt_ok = _round_trip(back.state.u, sim.state.u, axis=0)
    mass_r = float(back.totals()["mass"])
    if not (rt_ok and back.nstep == 5 and back.t == sim.t
            and abs(mass_r - mass0) <= 1e-5 * abs(mass0)):
        raise AssertionError(
            f"phase 35 restore: nstep {back.nstep}, t {back.t} vs {sim.t}, "
            f"{ulps:.2f} ulps / {rel:.3e} of a field max, mass {mass0} -> "
            f"{mass_r}")
    del sim
    torch.cuda.synchronize()
    _reset_counts()
    back.evolve()
    torch.cuda.synchronize()
    launches = _counts()
    mass1 = float(back.totals()["mass"])
    if (back.nstep != 10 or launches != _want(fused_muscl=5)
            or not bool(torch.isfinite(back.state.u).all())
            or abs(mass1 - mass0) > 1e-5 * abs(mass0)):
        raise AssertionError(f"phase 35 after the restore: {back.nstep} "
                             f"steps, launches {launches}, mass {mass0} -> "
                             f"{mass1}")
    diff = float(((back.state.u - u_straight).abs()
                  / (LOCAL_ATOL + _stencil_scale(u_straight))).max())
    if not diff <= RESTART_DRIFT:
        raise AssertionError(f"phase 35 against 10 straight steps: max "
                             f"|Δ| / (1e-10 + M) {diff:.3e} > "
                             f"{RESTART_DRIFT}")
    _print(f"phase 35 restart of config 1 (sedov3d 256³ f32): 5 steps, "
           f"dump {_dump_line(wall, nbytes, parts)}; validates; restore "
           f"{restore_s:.3f} s, state within {ulps:.2f} ulps of each value "
           f"(worst {rel:.3e} of a field max); 5 more steps, launches "
           f"{launches}; mass {mass0:.9e} -> {mass1:.9e}; against 10 "
           f"straight steps max |Δ| / (1e-10 + M) {diff:.3e} (M the "
           f"field's max over the cell's 5³ stencil)")


def _restart_amr(dev, tmp: str):
    """Phase 36: config 2 (levelmin 7, levelmax 9), 10 coarse steps
    straight against 5, a synchronous and an asynchronous dump, restore,
    5."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.io.async_writer import AsyncDumper
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    p = _amr_params()
    lmin = p.amr.levelmin
    tend = p.output.tout[-1] if p.output.tout else p.output.tend
    straight = AmrSim(p)
    mass0 = float(straight.totals()["mass"])
    straight.evolve(tend, nstepmax=10)
    ref = {l: (straight.tree.levels[l].keys,
               straight.u[l][:straight.tree.noct(l) * 8])
           for l in straight.levels()}
    del straight
    sim = AmrSim(_amr_params())
    sim.evolve(tend, nstepmax=4)
    sim.drain()
    t0 = time.perf_counter()
    sim.evolve(tend, nstepmax=5)
    sim.drain()
    step_s = time.perf_counter() - t0
    octs = {l: sim.tree.noct(l) for l in sim.levels()}
    rows = {l: sim.u[l][:n * 8].clone() for l, n in octs.items()}
    out, wall, nbytes, parts = _timed_dump(
        lambda: sim.dump(1, os.path.join(tmp, "amr")))
    ok, reason = ckpt.validate_checkpoint(out)
    if not ok:
        raise AssertionError(f"phase 36 dump does not validate: {reason}")
    # the same state through the writer's thread, the next coarse step
    # beside it
    dumper = AsyncDumper()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = sim.dump(2, os.path.join(tmp, "amr"), dumper=dumper)
    submit_s = time.perf_counter() - t0
    sim.evolve(tend, nstepmax=6)
    sim.drain()
    overlap_s = time.perf_counter() - t0 - submit_s
    dumper.wait()
    async_s = time.perf_counter() - t0
    dumper.close()
    ok, reason = ckpt.validate_checkpoint(out2)
    if not ok:
        raise AssertionError(f"phase 36 async dump does not validate: "
                             f"{reason}")
    del sim
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = AmrSim.from_snapshot(_amr_params(), out)
    back.drain()
    restore_s = time.perf_counter() - t0
    worst_ulps, worst_rel = 0.0, 0.0
    for l, n in octs.items():
        if back.tree.noct(l) != n:
            raise AssertionError(f"phase 36 restore: level {l} has "
                                 f"{back.tree.noct(l)} octs, dumped {n}")
        ulps, rel, rt_ok = _round_trip(back.u[l][:n * 8], rows[l], axis=1)
        worst_ulps, worst_rel = max(worst_ulps, ulps), max(worst_rel, rel)
        if not rt_ok:
            raise AssertionError(f"phase 36 restore: level {l} off by "
                                 f"{ulps:.2f} ulps, {rel:.3e} of a field "
                                 f"max")
    if sorted(octs) != back.levels() or back.nstep != 5:
        raise AssertionError(f"phase 36 restore: levels {back.levels()}, "
                             f"nstep {back.nstep}")
    stepped = []
    step_coarse = back.step_coarse
    back.step_coarse = lambda dt: (stepped.append(tuple(back.levels())),
                                   step_coarse(dt))
    torch.cuda.synchronize()
    _reset_counts()
    back.evolve(tend, nstepmax=10)
    back.drain()
    launches = _counts()
    del back.step_coarse
    want = _want(fused_muscl=len(stepped),
                 tile_sweep=sum(2 ** (l - lmin) for lv in stepped for l in lv
                                if l > lmin))
    mass1 = float(back.totals()["mass"])
    if (back.nstep != 10 or launches != want or launches["tile_sweep"] == 0
            or not all(bool(torch.isfinite(back.u[l]).all())
                       for l in back.levels())
            or abs(mass1 - mass0) > 1e-5 * abs(mass0)):
        raise AssertionError(f"phase 36 after the restore: {back.nstep} "
                             f"steps, launches {launches} (expected {want}), "
                             f"mass {mass0} -> {mass1}")
    # the restore brings back the next dt (the file's dtnew), so the
    # restarted run is the straight one, bitwise
    same_tree = sorted(ref) == back.levels() and all(
        np.array_equal(ref[l][0], back.tree.levels[l].keys) for l in ref)
    if not same_tree:
        raise AssertionError(
            f"phase 36: the tree differs from 10 straight steps' (octs "
            f"{[back.tree.noct(l) for l in back.levels()]} against "
            f"{[len(ref[l][0]) for l in sorted(ref)]})")
    diff = max(float(((back.u[l][:len(k) * 8] - u).abs()
                      / (1e-10 + u.abs().amax(dim=0))).max())
               for l, (k, u) in ref.items())
    if diff != 0.0:
        raise AssertionError(f"phase 36: not bitwise 10 straight steps, max "
                             f"|Δ| / (1e-10 + the field's max on the "
                             f"level) {diff:.3e}")
    vs = "same tree as 10 straight steps, bitwise"
    _print(f"phase 36 restart of config 2 (levelmin=7, levelmax=9): 5 "
           f"coarse steps (the 5th {step_s:.3f} s), octs {octs}; dump "
           f"{_dump_line(wall, nbytes, parts)}; validates; through "
           f"AsyncDumper: submit {submit_s:.3f} s, the next coarse step "
           f"beside the write {overlap_s:.3f} s, on disk after {async_s:.3f} "
           f"s, validates; restore {restore_s:.3f} s, octs equal, rows "
           f"within {worst_ulps:.2f} ulps (worst {worst_rel:.3e} of a field "
           f"max); 5 more coarse steps, launches {launches} (expected "
           f"{want}); leaf mass {mass0:.9e} -> {mass1:.9e}; {vs}")


def _restart_mhd(dev, tmp: str):
    """Phase 37: Orszag-Tang at 2048² (K4), 5 steps, dump, restore, 5."""
    import torch
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.mhd.driver import MhdSimulation
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    p = load_params(OT_NML, ndim=2)
    p.amr.levelmin = p.amr.levelmax = OT_LEVEL
    n = 2 ** OT_LEVEL
    u0, bf0 = _orszag_tang(n)

    def fresh():
        s = MhdSimulation(p)
        s.u = torch.tensor(u0, dtype=torch.float32, device=dev)
        s.bf = torch.tensor(bf0, dtype=torch.float32, device=dev)
        return s

    straight = fresh()
    tot0 = {k: float(v) for k, v in straight.totals().items()
            if k != "momentum"}
    straight.evolve(nstepmax=10)
    u_straight, bf_straight = straight.u, straight.bf
    del straight
    sim = fresh()
    sim.evolve(nstepmax=5)
    out, wall, nbytes, parts = _timed_dump(
        lambda: sim.dump(1, os.path.join(tmp, "mhd")))
    ok, reason = ckpt.validate_checkpoint(out)
    if not ok:
        raise AssertionError(f"phase 37 dump does not validate: {reason}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = MhdSimulation.from_snapshot(p, out)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ulps, rel, rt_ok = _round_trip(back.u, sim.u, axis=0)
    if not (torch.equal(back.bf, sim.bf) and rt_ok and back.nstep == 5
            and back.t == sim.t):
        raise AssertionError(
            f"phase 37 restore: faces bitwise {torch.equal(back.bf, sim.bf)}"
            f", cells {ulps:.2f} ulps / {rel:.3e} of a field max, nstep "
            f"{back.nstep}, t {back.t} vs {sim.t}")
    del sim
    torch.cuda.synchronize()
    _reset_counts()
    back.evolve(nstepmax=10)
    torch.cuda.synchronize()
    launches = _counts()
    tot1 = {k: float(v) for k, v in back.totals().items() if k != "momentum"}
    if (back.nstep != 10 or launches != _want(ct_step_slab=5)
            or not bool(torch.isfinite(back.u).all())
            or any(abs(tot1[k] - tot0[k]) > 1e-5 * abs(tot0[k])
                   for k in ("mass", "energy"))
            or not _divb_rel(back) <= DIVB_REL):
        raise AssertionError(f"phase 37 after the restore: {back.nstep} "
                             f"steps, launches {launches}, totals {tot0} -> "
                             f"{tot1}, div B {_divb_rel(back):.3e}")
    diff = float(((back.u - u_straight).abs()
                  / (LOCAL_ATOL + _stencil_scale(u_straight, nd=2))).max())
    if diff != 0.0 or not torch.equal(back.bf, bf_straight):
        raise AssertionError(f"phase 37: not bitwise 10 straight steps, max "
                             f"|Δ| / (1e-10 + M) {diff:.3e}, faces equal "
                             f"{torch.equal(back.bf, bf_straight)}")
    _print(f"phase 37 restart of Orszag-Tang 2048² (K4): 5 steps, dump "
           f"{_dump_line(wall, nbytes, parts)}; validates; restore "
           f"{restore_s:.3f} s, faces bitwise, cells within {ulps:.2f} ulps "
           f"(worst {rel:.3e} of a field max); 5 more steps, launches "
           f"{launches}; mass and energy to 1e-5, max|div B|·dx/max|B| "
           f"{_divb_rel(back):.3e}; against 10 straight steps bitwise")


def _restart_cli(tmp: str):
    """Phase 38: the CLI in a subprocess on a copy of sedov3d.nml whose
    output time the run reaches, ``--max-attempts 3``, stopped by a SIGTERM
    once it has printed a step and resumed by the supervisor; then a second
    CLI run with ``nrestart=1`` continues to a second output time."""
    import signal

    import torch
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    # the output times: where an uninterrupted run stands after CLI_STEPS
    # and CLI_STEPS + CLI_MORE steps
    p = load_params(NML, ndim=3)
    p.run.nstepmax = CLI_STEPS
    probe = Simulation(p)
    probe.output_times = [1e30]
    probe.evolve()
    t1 = probe.t
    probe.params.run.nstepmax = CLI_STEPS + CLI_MORE
    probe.evolve()
    t2 = probe.t
    del probe
    torch.cuda.empty_cache()
    text = open(NML).read().replace("nstepmax=10", "nstepmax=100000")
    run_dir = os.path.join(tmp, "cli")
    os.makedirs(run_dir)
    first = os.path.join(run_dir, "first.nml")
    with open(first, "w") as f:
        f.write(text.replace("tout=1.0", f"tout={t1!r}"))
    second = os.path.join(run_dir, "second.nml")
    with open(second, "w") as f:
        f.write(text.replace("noutput=1\ntout=1.0",
                             f"noutput=2\ntout={t1!r},{t2!r}")
                .replace("nstepmax=100000", "nstepmax=100000\nnrestart=1"))
    # unbuffered: the step lines must reach this process as they are made
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "ramses_tpu_torch", first, "--ndim", "3",
           "--max-attempts", "3"]
    t0 = time.perf_counter()
    with open(os.path.join(run_dir, "first.err"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=run_dir, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line.rstrip())
                if line.startswith("step "):
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, _ = proc.communicate(timeout=CLI_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    lines += rest.splitlines()
    errs = open(os.path.join(run_dir, "first.err")).read()
    resumed = [ln for ln in lines if "resuming from" in ln]
    stops = [ln for ln in lines if ln.startswith("ops: stop signal")]
    out1 = os.path.join(run_dir, "output_00001")
    ok, reason = (ckpt.validate_checkpoint(out1) if os.path.isdir(out1)
                  else (False, "missing"))
    if proc.returncode != 0 or not resumed or not stops or not ok:
        raise AssertionError(
            f"phase 38 CLI: rc {proc.returncode}, stop {stops}, resume "
            f"{resumed}, output_00001 {reason}; stdout tail {lines[-8:]}; "
            f"stderr tail {errs[-2000:]}")
    meta1 = ckpt.read_manifest_meta(out1)
    t0 = time.perf_counter()
    cont = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", second, "--ndim", "3"],
        cwd=run_dir, env=env, text=True, capture_output=True,
        timeout=CLI_TIMEOUT)
    wall2 = time.perf_counter() - t0
    out2 = os.path.join(run_dir, "output_00002")
    ok2, reason2 = (ckpt.validate_checkpoint(out2) if os.path.isdir(out2)
                    else (False, "missing"))
    meta2 = ckpt.read_manifest_meta(out2) if ok2 else {}
    if cont.returncode != 0 or not ok2 or \
            not meta2.get("nstep", 0) > meta1["nstep"] or \
            not abs(meta2.get("t", 0.0) - t2) <= 1e-12 * (abs(t2) + 1.0):
        raise AssertionError(
            f"phase 38 nrestart=1: rc {cont.returncode}, output_00002 "
            f"{reason2} {meta2}; stdout tail {cont.stdout[-1500:]}; stderr "
            f"tail {cont.stderr[-1500:]}")
    _print(f"phase 38 CLI sedov3d 256³ --max-attempts 3 to tout={t1!r} "
           f"({CLI_STEPS} steps): SIGTERM after its first step line; "
           f"{stops[0]}; {resumed[0]}; rc 0 in {wall:.1f} s, output_00001 "
           f"validates (nstep {meta1['nstep']}, t {meta1['t']!r}); the "
           f"second run with nrestart=1 to tout={t2!r}: rc 0 in {wall2:.1f} "
           f"s, output_00002 validates (nstep {meta2['nstep']})")


# ---------------------------------------------------------------------------
# phases 39-43: particles and cosmology, BASELINE.json config 5
# ---------------------------------------------------------------------------

COSMO_NML = os.path.join(ROOT, "namelists", "cosmo.nml")
COSMO_LEVELS = (7, 9)          # BASELINE config 5: cosmo.nml at 128³
COSMO_STEPS = 20
# the ICs: a Gaussian random δ with P(k) ∝ k⁻² from default_rng(COSMO_SEED),
# scaled to COSMO_SIGMA rms per level-7 cell.  The particle density must
# pass m_refine = 8 mean masses a cell, then 64 (levels 8 and 9), within
# the 20 steps: at 0.2 rms level 8 appears at step 11 and level 9 at step
# 15 on an H100 (PERF.md §6).  The baryon density fb·(1+δ) must stay
# positive on every cell: the 128³ field's minimum is -5.06σ for seed 0
# (negative at 0.2 rms), -4.97σ for seed 1 (checked, phase 39)
COSMO_SEED, COSMO_SIGMA = 1, 0.2
# set in code, each a cut of cosmo.nml's parameters (PERF.md §4):
# nremap=1 refines at every coarse step, as the reference's flag_fine does
# (its nremap is the load-balance cadence; the JAX package regrids every
# nremap steps, and at 10 level 9 could not appear within 20 steps);
# smallc=1e-6: with the default 1e-10 the f32 step of the cold gas (T2 =
# 1e-8 at the start) goes non-finite after 9 coarse steps, in the JAX
# package's formulation as in the port's (ROADMAP §C6); cosmo.nml's
# m_refine=8 list stops at level 7, so level 8 would never refine: its
# value carries on to the levels below levelmax
COSMO_NREMAP, COSMO_SMALLC = 1, 1e-6
COSMO_REPLAY_STEPS = 3
COSMO_REPLAY_AT = 15           # phase 40 replays from the state at step 15
COSMO_RESTART_AT = 5           # phase 42: 5 steps, dump, restore, 5 more
GROWTH_LEVEL, GROWTH_AEND = 7, 0.06        # phase 41, uniform: 128³
GROWTH_AMR = (4, 5, 0.05)                   # test_cosmo_amr_growth's size
COSMO_CLI_LEVEL, COSMO_CLI_STEPS = 6, 3     # phase 43: 64³ ICs


def _gaussian_ics(dirname: str, n: int, sigma: float, seed: int):
    """A grafic directory of a Gaussian random δ (P(k) ∝ k⁻², rms
    ``sigma``) and its Zel'dovich velocities at cosmo.nml's epoch, written
    with the port's own ``write_zeldovich_ics``.  Returns min(1+δ)."""
    import numpy as np
    from ramses_tpu_torch.io import grafic
    from ramses_tpu_torch.pm.init_part import fpeebl
    rng = np.random.default_rng(seed)
    kf = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky, kz = np.meshgrid(kf, kf, kf, indexing="ij")
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    k2[0, 0, 0] = 1.0
    dk = np.fft.fftn(rng.standard_normal((n, n, n))) / np.sqrt(k2)
    dk[0, 0, 0] = 0.0
    delta = np.real(np.fft.ifftn(dk))
    delta *= sigma / delta.std()
    hdr = grafic.GraficHeader(n, n, n, dx=100.0 / n, astart=0.02,
                              omega_m=1.0, omega_v=0.0, h0=70.0)
    grafic.write_zeldovich_ics(dirname, delta, hdr,
                               fpeebl(0.02, 1.0, 0.0, 0.0))
    return float(1.0 + delta.min())


def _mode_ics(dirname: str, n: int, amp: float):
    """``tests/test_cosmo_ics.py``'s single mode δ = amp·cos(2πx) with its
    Zel'dovich velocities (EdS, astart 0.02)."""
    import numpy as np
    from ramses_tpu_torch.io import grafic
    from ramses_tpu_torch.pm.init_part import fpeebl
    x = (np.arange(n) + 0.5) / n
    delta = (amp * np.cos(2 * np.pi * x))[:, None, None] * np.ones((1, n, n))
    hdr = grafic.GraficHeader(n, n, n, dx=100.0 / n, astart=0.02,
                              omega_m=1.0, omega_v=0.0, h0=70.0)
    grafic.write_zeldovich_ics(dirname, delta, hdr,
                               fpeebl(0.02, 1.0, 0.0, 0.0))


def _mode_amplitude(ps, n: int) -> float:
    """The cos(2πx) amplitude of the particles' CIC density at n³."""
    import numpy as np
    from ramses_tpu_torch.pm import particles as pmod
    rho = pmod.deposit_cic(ps, (n, n, n), 1.0 / n).double().cpu().numpy()
    x = (np.arange(n) + 0.5) / n
    return 2.0 * float(np.mean(rho.mean(axis=(1, 2)) * np.cos(2 * np.pi * x)))


def _mode_params(lmin: int, lmax: int, initdir: str, hydro: bool):
    """``tests/test_cosmo_ics.py``'s ``_cosmo_params``: EdS, omega_b 0,
    100 Mpc/h, aexp_ini 0.02."""
    from ramses_tpu_torch.config import Params
    p = Params(ndim=3)
    p.run.cosmo = p.run.pic = p.run.poisson = True
    p.run.hydro = hydro
    p.amr.levelmin, p.amr.levelmax, p.amr.boxlen = lmin, lmax, 1.0
    p.init.filetype = "grafic"
    p.init.initfile = [initdir]
    p.init.aexp_ini = 0.02
    p.raw = {"cosmo_params": {"omega_m": 1.0, "omega_l": 0.0,
                              "omega_b": 0.0, "h0": 70.0, "aexp": 0.02,
                              "boxlen_ini": 100.0}}
    return p


def _cosmo_config(initdir: str):
    """cosmo.nml at levelmin 7, levelmax 9 on the ICs in ``initdir``, with
    the cuts above (``m_refine`` carried on to level 8)."""
    from ramses_tpu_torch.config import load_params
    p = load_params(COSMO_NML, ndim=3)
    p.amr.levelmin, p.amr.levelmax = COSMO_LEVELS
    p.init.initfile = [initdir]
    p.run.nremap = COSMO_NREMAP
    p.hydro.smallc = COSMO_SMALLC
    m = list(p.refine.m_refine)
    given = [v for v in m if v >= 0.0]
    for i in range(p.amr.levelmax - 1):
        if m[i] < 0.0:
            m[i] = given[-1]
    p.refine.m_refine = m
    return p


def _cosmo_snapshot(sim) -> dict:
    """Device copies of a hierarchy's state: rows, potentials, forces,
    particles, trees and PCG iterations."""
    return dict(
        u={l: sim.u[l].clone() for l in sim.levels()},
        phi={l: v.clone() for l, v in sim.phi.items()},
        fg={l: v.clone() for l, v in sim.fg.items()},
        x=sim.p.x.clone(), v=sim.p.v.clone(),
        keys={l: sim.tree.levels[l].keys.copy() for l in sim.levels()},
        iters={l: int(v) for l, v in sim.poisson_iters.items()},
        t=sim.t, nstep=sim.nstep)


def _cosmo_diff(a: dict, b: dict) -> dict:
    """Bitwise flags and the largest deviation of each part of two
    :func:`_cosmo_snapshot`s (a part's max |Δ| over its max |value|)."""
    import numpy as np
    import torch

    def rel(x, y):
        if x.shape != y.shape:
            return float("inf")
        return float((x.double() - y.double()).abs().max()
                     / y.double().abs().max().clamp(min=1e-300))
    same_tree = (a["keys"].keys() == b["keys"].keys() and all(
        np.array_equal(a["keys"][l], b["keys"][l]) for l in a["keys"]))
    out = {"trees": same_tree, "iters": a["iters"] == b["iters"]}
    for part in ("u", "phi", "fg"):
        common = set(a[part]) & set(b[part])
        out[part] = (same_tree and set(a[part]) == set(b[part]) and all(
            torch.equal(a[part][l], b[part][l]) for l in common))
        out[part + "_rel"] = max([rel(a[part][l], b[part][l])
                                  for l in common] or [0.0])
    for part in ("x", "v"):
        out[part] = torch.equal(a[part], b[part])
        out[part + "_rel"] = rel(a[part], b[part])
    out["bitwise"] = all(out[k] for k in ("trees", "iters", "u", "phi",
                                          "fg", "x", "v"))
    return out


def _cosmo_want(stepped, lmin: int) -> dict:
    """The launches that the recorded coarse steps' levels require: K1 a
    complete level's substep, K3 a blocked partial level's, K2 a stencil
    partial level's."""
    n = {"fused_muscl": 0, "tile_sweep": 0, "oct_sweep": 0}
    for levels, complete, blocked in stepped:
        for l, c, b in zip(levels, complete, blocked or (False,) * len(
                levels)):
            key = ("fused_muscl" if c else "tile_sweep" if b
                   else "oct_sweep")
            n[key] += 2 ** (l - lmin)
    return _want(**n)


def _record_kernel_inputs(store: dict):
    """Wrap K1's and K3's wrappers so that each one's first call at each
    cell size records device copies of its inputs in ``store`` (keyed by
    the kernel's name and dx), then runs the kernel as before (one launch,
    counted as before).  Returns the function that restores them."""
    import torch
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    k1, k3 = fm.fused_step, om.tile_sweep

    def keep(a):
        return a.clone() if torch.is_tensor(a) else a

    def k3_rec(ut, ok, dt, cfg, dx, shift, want_flux=False):
        if ("tile_sweep", dx) not in store:
            store["tile_sweep", dx] = tuple(keep(a) for a in (
                ut, ok, dt, cfg, dx, shift, want_flux))
        return k3(ut, ok, dt, cfg, dx, shift, want_flux)

    def k1_rec(u, dt, cfg, dx, bc, **kw):
        if ("fused_muscl", dx) not in store:
            store["fused_muscl", dx] = ((keep(u), keep(dt), cfg, dx, bc),
                                        {k: keep(v) for k, v in kw.items()})
        return k1(u, dt, cfg, dx, bc, **kw)
    fm.fused_step, om.tile_sweep = k1_rec, k3_rec

    def restore():
        fm.fused_step, om.tile_sweep = k1, k3
    return restore


def _recorded_kernel_check(store: dict, level_of: dict) -> str:
    """Each recorded K3 batch and K1 state (:func:`_record_kernel_inputs`)
    through the kernel and its plain version on the card: K3's du and
    face fluxes each within ``LOCAL_ATOL + LOCAL_RTOL·M`` (M the stencil
    scale of phase 10), K1's state within the same of its 5³ stencil max.
    Raises on a disagreement; returns a line of the N and the errors."""
    import torch
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    parts = []
    for (name, dx), args in sorted(store.items(),
                                   key=lambda kv: level_of[kv[0][1]]):
        lvl = level_of[dx]
        if name == "tile_sweep":
            ut, ok, dt, cfg, _, shift, want_flux = args
            got = om.tile_sweep(ut, ok, dt, cfg, dx, shift, want_flux)
            want = om.tile_sweep_ref(ut, ok, dt, cfg, dx, shift, want_flux)
            torch.cuda.synchronize()
            scales = _output_scales(_batch_last((ut,))[0], 1 << (shift + 1),
                                    True)
            err, rel, ex = _local_check(_batch_last(got), _batch_last(want),
                                        scales)
            what = (f"K3 level {lvl} (N {ut.shape[1]} tiles, shift {shift}):"
                    f" max abs err {err:.3e}, err / M (du/faces) "
                    f"{rel[0]:.3e}/{rel[1]:.3e}")
            del got, want, scales
        else:
            (u, dt, cfg, _, bc), kw = args
            got = fm.fused_step(u, dt, cfg, dx, bc, **kw)
            want = fm.fused_step_ref(u, dt, cfg, dx, bc, **kw)
            if isinstance(got, tuple):
                got, want = got[0], want[0]
            torch.cuda.synchronize()
            d = (got - want).abs()
            scale = _stencil_scale(want)
            ex = float((d - (LOCAL_ATOL + LOCAL_RTOL * scale)).max())
            err = float(d.max())
            rel = float((d / scale).nan_to_num(nan=0.0).max())
            what = (f"K1 level {lvl} ({'x'.join(map(str, u.shape[1:]))}, "
                    f"{'masked' if kw.get('ok') is not None else 'unmasked'})"
                    f": max abs err {err:.3e}, err / stencil max {rel:.3e}")
            del got, want, d, scale
        if not ex <= 0.0:
            raise AssertionError(f"config 5: {name} disagrees with its "
                                 f"plain version on the inputs the main "
                                 f"path gave it: {what}, tolerance excess "
                                 f"{ex:.3e}")
        parts.append(what)
    return "; ".join(parts)


def _cosmo_phases(dev, card: str):
    """Phases 39-43 in a scratch directory that is removed at the end.
    Returns config 5's K1 and K3 launches."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cosmo_")
    try:
        launches, straight = _cosmo_main(dev, card, tmp)
        _cosmo_growth(card, tmp)
        _cosmo_restart(card, tmp, straight)
        _cosmo_cli(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _cosmo_main(dev, card: str, tmp: str):
    """Phases 39 (config 5 at 128³, 20 coarse steps) and 40 (a bitwise
    replay).  Returns the launches of the run and its state after
    ``2 * COSMO_RESTART_AT`` steps (phase 42's straight run)."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import hierarchy as H
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.convert import amr_state_from, particles_from
    from ramses_tpu_torch.driver import build_namelist_sim
    from ramses_tpu_torch.pm import particles as pmod
    ics = os.path.join(tmp, "ics128")
    t0 = time.perf_counter()
    pos = _gaussian_ics(ics, 2 ** COSMO_LEVELS[0], COSMO_SIGMA, COSMO_SEED)
    ics_s = time.perf_counter() - t0
    if not pos > 0.0:
        raise AssertionError(f"config 5 ICs: min(1+δ) = {pos} <= 0")
    p = _cosmo_config(ics)
    lmin = p.amr.levelmin
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim = build_namelist_sim(AmrSim, p, None, torch.float32, None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    a0 = sim.aexp_now()
    npart = int(sim.p.active.sum())
    mass0 = float(sim.totals()["mass"])
    pmass0 = float(sim.p.m.double().sum())
    stepped, dts, octs, walls = [], [], [], []
    # each step's lagged free-fall cap (None before the first solve): a
    # restore does not carry it (phase 42)
    caps = []
    # the inputs the last step hands K1 and K3, held against their plain
    # versions after the run
    recorded = {}
    step_coarse = sim.step_coarse
    cf = float(sim.cfg.courant_factor)

    def counted(dt):
        spec = sim._fused_spec()
        stepped.append((spec.levels, spec.complete, spec.blocked))
        dts.append(float(dt))
        caps.append(float(pmod.freefall_dt(sim._rho_max, cf,
                                           sim.grav_coeff()))
                    if sim._rho_max else None)
        restore = (_record_kernel_inputs(recorded)
                   if len(stepped) == COSMO_STEPS else None)
        t0 = time.perf_counter()
        try:
            step_coarse(dt)
        finally:
            if restore is not None:
                restore()
        walls.append(time.perf_counter() - t0)
        octs.append([sim.tree.noct(l) for l in sim.levels()])
    sim.step_coarse = counted
    tend = float(sim.cosmo.tau_of_aexp(1.0))
    updates = []
    regrid = sim.regrid

    def regrid_counted():
        regrid()
        updates.append(sim.updates_per_step())
    sim.regrid = regrid_counted
    t0 = time.perf_counter()
    sim.evolve(tend, nstepmax=2 * COSMO_RESTART_AT)
    straight = dict(_cosmo_snapshot(sim), dts=list(dts), caps=list(caps),
                    stepped=list(stepped))
    sim.evolve(tend, nstepmax=COSMO_REPLAY_AT)
    # phase 40's state: host copies (no kernel launches)
    state = amr_state_from(sim)
    p_state = particles_from(sim.p, dtype=torch.float32, device="cpu")
    sim.evolve(tend, nstepmax=COSMO_STEPS)
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse, sim.regrid
    want = _cosmo_want(stepped, lmin)
    mass1 = float(sim.totals()["mass"])
    finite = (all(bool(torch.isfinite(sim.u[l]).all())
                  and bool(torch.isfinite(sim.phi[l]).all())
                  and bool(torch.isfinite(sim.fg[l]).all())
                  for l in sim.levels())
              and bool(torch.isfinite(sim.p.x).all())
              and bool(torch.isfinite(sim.p.v).all()))
    reached = sorted({lv for step in stepped for lv in step[0]})
    if not (sim.nstep == COSMO_STEPS and len(stepped) == COSMO_STEPS
            and launches == want and finite
            and int(sim.p.active.sum()) == npart == 8 ** COSMO_LEVELS[0]
            and abs(mass1 - mass0) <= 1e-5 * abs(mass0)
            and float(sim.p.m.double().sum()) == pmass0
            and sim.aexp_now() > a0
            and reached == list(range(lmin, p.amr.levelmax + 1))):
        raise AssertionError(
            f"config 5: {sim.nstep} coarse steps, launches {launches} "
            f"(expected {want}), finite {finite}, particles "
            f"{int(sim.p.active.sum())} of {npart}, leaf gas mass {mass0} -> "
            f"{mass1}, aexp {a0} -> {sim.aexp_now()}, levels stepped "
            f"{reached}, octs per step {octs}, dts {dts}, max density "
            f"{sim._rho_max}")
    nupd = sum(updates[i] for i in range(len(updates)))
    _print(f"phase 39 config 5 on {card}: cosmo.nml levelmin={lmin} "
           f"levelmax={p.amr.levelmax} (nremap={COSMO_NREMAP}, smallc="
           f"{COSMO_SMALLC}, m_refine {p.refine.m_refine[:p.amr.levelmax]} "
           f"set in code), {npart} particles, ICs "
           f"(σ={COSMO_SIGMA}, min(1+δ)={pos:.4f}) written in {ics_s:.2f} "
           f"s, AmrSim() {init_s:.3f} s; {COSMO_STEPS} coarse steps "
           f"(a regrid each) in {wall:.3f} s = {wall / COSMO_STEPS:.4f} s a "
           f"coarse step, {nupd / wall:.4e} cell-updates/s; aexp {a0:.4f} -> "
           f"{sim.aexp_now():.4f}; octs per level at the end "
           f"{ {l: sim.tree.noct(l) for l in sim.levels()} }, per step "
           f"{octs}; step walls {[round(w, 3) for w in walls]}; dts "
           f"{[round(d, 5) for d in dts]}; PCG iterations at the end "
           f"{ {l: int(v) for l, v in sim.poisson_iters.items()} }; "
           f"launches {launches} (expected {want}); leaf gas mass "
           f"{mass0:.9e} -> {mass1:.9e}, particles {npart} kept, everything "
           f"finite")

    # K1 and K3 against their plain versions on the inputs the last coarse
    # step handed them: every level it stepped, at its first substep
    levels, complete, blocked = stepped[-1]
    want_rec = {("fused_muscl" if c else "tile_sweep", sim.dx(l))
                for l, c, b in zip(levels, complete,
                                   blocked or (False,) * len(levels))
                if c or b}
    if set(recorded) != want_rec:
        raise AssertionError(
            f"config 5: the last step's K1/K3 inputs were not all recorded: "
            f"{sorted((k, round(dx, 8)) for k, dx in recorded)} against "
            f"{sorted((k, round(dx, 8)) for k, dx in want_rec)}")
    line = _recorded_kernel_check(
        recorded, {sim.dx(l): l for l in range(lmin, p.amr.levelmax + 1)})
    recorded.clear()
    torch.cuda.empty_cache()
    _print(f"phase 39 K1 and K3 at config 5's shapes (the inputs the last "
           f"coarse step gave them, each level's first substep) against "
           f"their plain versions within LOCAL_ATOL + LOCAL_RTOL·M: {line}")

    # where a coarse step's time goes: one more step, each part synchronised
    coarse = H._coarse_step
    acc = {"sweep": 0.0}

    def timed_coarse(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = coarse(*a, **k)
        torch.cuda.synchronize()
        acc["sweep"] += time.perf_counter() - t0
        return out
    H._coarse_step = timed_coarse
    try:
        def coarse_step():
            sim.regrid()
            sim.step_coarse(sim.coarse_dt())
        line, parts = _host_breakdown(
            sim, coarse_step,
            parts=("regrid", "_build_pm", "solve_gravity", "_pm_force",
                   "_pm_drift", "coarse_dt", "step_coarse"),
            nested=("_build_pm", "solve_gravity", "_pm_force", "_pm_drift"))
    finally:
        H._coarse_step = coarse
    _print(f"phase 39 where a coarse step's time goes (octs "
           f"{[sim.tree.noct(l) for l in sim.levels()]}): {line}; of "
           f"step_coarse the K1/K3 sweep (_coarse_step) {acc['sweep']:.4f} "
           f"s; host seconds by part: maps (_build_pm) "
           f"{parts['_build_pm']:.4f}, solve {parts['solve_gravity']:.4f}, "
           f"kick (gather) {parts['_pm_force']:.4f}, K1/K3 step "
           f"{acc['sweep']:.4f}, drift {parts['_pm_drift']:.4f}, regrid "
           f"{parts['regrid']:.4f}, Courant fetch {parts['coarse_dt']:.4f}")

    # ---- 40. replay: 3 coarse steps twice from one state, bitwise ----
    def replay():
        s = AmrSim.from_state(p, **state, particles=particles_from(
            p_state, dtype=torch.float32, device=dev))
        s.evolve(tend, nstepmax=s.nstep + COSMO_REPLAY_STEPS)
        s.drain()
        return _cosmo_snapshot(s)
    t0 = time.perf_counter()
    a, b = replay(), replay()
    rwall = time.perf_counter() - t0
    d = _cosmo_diff(a, b)
    if not d["bitwise"]:
        raise AssertionError(f"config 5 replay of {COSMO_REPLAY_STEPS} "
                             f"coarse steps is not bitwise: {d}")
    _print(f"phase 40 config 5 replay: {COSMO_REPLAY_STEPS} coarse steps "
           f"twice from phase 39's state at step {COSMO_REPLAY_AT} (octs "
           f"{ {l: len(v) for l, v in state['tree_og'].items()} }; "
           f"{rwall:.3f} s for both), bitwise equal: "
           f"u, phi, fg, particle x and v, trees and PCG iterations "
           f"{a['iters']}")
    out = {"fused_muscl": launches["fused_muscl"],
           "tile_sweep": launches["tile_sweep"]}
    del sim, a, b, state
    torch.cuda.empty_cache()
    return out, straight


def _cosmo_growth(card: str, tmp: str):
    """Phase 41: linear growth, the JAX package's two oracles, on the
    card."""
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.driver import Simulation, build_namelist_sim
    from ramses_tpu_torch.pm.cosmology import Cosmology
    n = 2 ** GROWTH_LEVEL
    ics = os.path.join(tmp, "mode128")
    _mode_ics(ics, n, 0.01)
    p = _mode_params(GROWTH_LEVEL, GROWTH_LEVEL, ics, hydro=False)
    p.output.tout = [float(Cosmology.from_params(p).tau_of_aexp(
        GROWTH_AEND))]
    p.output.noutput = 1
    t0 = time.perf_counter()
    sim = Simulation(p)
    amp0 = _mode_amplitude(sim.state.p, n)
    sim.evolve(chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    aexp = sim.cosmo.aexp_of_tau(sim.t)
    growth = _mode_amplitude(sim.state.p, n) / 0.01
    want = GROWTH_AEND / 0.02
    if not (abs(aexp - GROWTH_AEND) <= 1e-2 * GROWTH_AEND
            and abs(growth - want) <= 0.12 * want
            and bool(torch.isfinite(sim.state.p.x).all())):
        raise AssertionError(
            f"uniform linear growth at {n}³: aexp {aexp}, growth {growth} "
            f"(D ∝ a: {want} within 12 %)")
    line = (f"uniform {n}³ single mode (amp 0.01, {n ** 3} particles, FFT) "
            f"to aexp {aexp:.5f} in {sim.nstep} steps, {wall:.3f} s: growth "
            f"{growth:.4f} against a/a0 = {want:.4f} ({100 * (growth / want - 1):+.2f} "
            f"%, limit 12 %; initial amplitude {amp0:.6f})")
    del sim
    lmin, lmax, a_end = GROWTH_AMR
    n = 2 ** lmin
    ics = os.path.join(tmp, "mode16")
    _mode_ics(ics, n, 0.02)
    p = _mode_params(lmin, lmax, ics, hydro=True)
    p.refine.m_refine = [4.0] * 10
    t0 = time.perf_counter()
    sim = build_namelist_sim(AmrSim, p, None, torch.float32, None)
    amp0 = _mode_amplitude(sim.p, n)
    sim.evolve(float(sim.cosmo.tau_of_aexp(a_end)), nstepmax=400)
    sim.drain()
    wall = time.perf_counter() - t0
    growth = _mode_amplitude(sim.p, n) / amp0
    want = a_end / 0.02
    if not (abs(sim.aexp_now() - a_end) <= 0.02 * a_end
            and abs(growth - want) <= 0.2 * want):
        raise AssertionError(
            f"hierarchy linear growth: aexp {sim.aexp_now()}, growth "
            f"{growth} (D ∝ a: {want} within 20 %)")
    _print(f"phase 41 linear growth on {card}: {line}; hierarchy levelmin "
           f"{lmin} levelmax {lmax} (m_refine 4, test_cosmo_amr_growth's "
           f"size) to aexp {sim.aexp_now():.5f} in {sim.nstep} coarse steps, "
           f"{wall:.3f} s, octs {[sim.tree.noct(l) for l in sim.levels()]}: "
           f"growth {growth:.4f} against {want:.4f} "
           f"({100 * (growth / want - 1):+.2f} %, limit 20 %)")
    del sim
    torch.cuda.empty_cache()


def _cosmo_restart(card: str, tmp: str, straight: dict):
    """Phase 42: config 5 from its ICs, 5 coarse steps, a dump with the
    particles, ``from_snapshot``, 5 more; against phase 39's first 10."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.driver import build_namelist_sim
    from ramses_tpu_torch.io import reader
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    p = _cosmo_config(os.path.join(tmp, "ics128"))
    sim = build_namelist_sim(AmrSim, p, None, torch.float32, None)
    tend = float(sim.cosmo.tau_of_aexp(1.0))
    sim.evolve(tend, nstepmax=COSMO_RESTART_AT)
    x5, v5 = sim.p.x.clone(), sim.p.v.clone()
    u5 = {l: sim.u[l].clone() for l in sim.levels()}
    t0 = time.perf_counter()
    out = sim.dump(1, os.path.join(tmp, "restart"))
    dump_s = time.perf_counter() - t0
    ok, reason = ckpt.validate_checkpoint(out)
    nbytes = sum(os.path.getsize(os.path.join(out, f))
                 for f in os.listdir(out))
    parts = reader.load_snapshot(out)["part"][0]
    del sim
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back = AmrSim.from_snapshot(p, out)
    restore_s = time.perf_counter() - t0
    same_p = torch.equal(back.p.x, x5) and torch.equal(back.p.v, v5)
    ulps = 0.0
    rt_ok = back.levels() == list(u5)
    for l in u5:
        n = back.tree.noct(l) * 8
        w, _rel, good = _round_trip(back.u[l][:n], u5[l][:n], axis=1)
        ulps, rt_ok = max(ulps, w), rt_ok and good
    first = []
    step_coarse = back.step_coarse

    def first_dt(dt):
        first.append(float(dt))
        step_coarse(dt)
    back.step_coarse = first_dt
    back.evolve(tend, nstepmax=2 * COSMO_RESTART_AT)
    del back.step_coarse
    back.drain()
    if not (ok and len(parts["mass"]) == 8 ** COSMO_LEVELS[0] and same_p
            and rt_ok and back.nstep == 2 * COSMO_RESTART_AT):
        raise AssertionError(
            f"config 5 restart: dump {reason}, {len(parts['mass'])} part "
            f"rows, restored particles bitwise {same_p}, cells within "
            f"{ulps:.2f} ulps, {back.nstep} steps")
    d = _cosmo_diff(_cosmo_snapshot(back), straight)
    dt_straight = straight["dts"][COSMO_RESTART_AT]
    # a partial level's PCG starts from the restore's own solve where the
    # straight run starts from its last step's: the two agree to the
    # solver's tolerance, not bitwise
    pcg = any(len(lv) > 1 for lv, _, _ in
              straight["stepped"][COSMO_RESTART_AT:])
    if first[0] == dt_straight and not pcg and not d["bitwise"]:
        raise AssertionError(f"config 5 restart: the first restored dt "
                             f"equals the straight run's ({first[0]!r}) but "
                             f"10 steps differ: {d}")
    # the one known cause of a different first dt: the straight run's
    # lagged free-fall cap bound it, and the restore does not carry the
    # density it comes from, so the restored dt is the larger
    cap = straight["caps"][COSMO_RESTART_AT]
    if first[0] != dt_straight and not (first[0] > dt_straight
                                        and dt_straight == cap):
        raise AssertionError(
            f"config 5 restart: the first restored dt {first[0]!r} is not "
            f"the straight run's {dt_straight!r}, and the straight run's "
            f"free-fall cap ({cap!r}), which a restore does not carry, "
            f"does not explain it")
    if not all(bool(torch.isfinite(back.u[l]).all()) for l in back.levels()):
        raise AssertionError("config 5 restart: state not finite")
    verdict = ("bitwise equal to 10 straight steps" if d["bitwise"] else
               f"not bitwise (u {d['u_rel']:.3e}, phi {d['phi_rel']:.3e}, "
               f"x {d['x_rel']:.3e}, v {d['v_rel']:.3e} of their scale; "
               f"trees equal {d['trees']}, PCG iterations equal "
               f"{d['iters']})")
    _print(f"phase 42 config 5 restart on {card}: {COSMO_RESTART_AT} steps, "
           f"dump {nbytes} bytes in {dump_s:.3f} s (validates, "
           f"{len(parts['mass'])} particle rows), from_snapshot "
           f"{restore_s:.3f} s (particles bitwise, cells within "
           f"{ulps:.2f} ulps), {COSMO_RESTART_AT} more steps: first dt "
           f"{first[0]!r} restored, {dt_straight!r} straight (its "
           f"free-fall cap {cap!r}); {verdict}")


def _cosmo_cli(card: str, tmp: str):
    """Phase 43: ``python -m ramses_tpu_torch`` on a copy of cosmo.nml with
    64³ ICs (its own levelmin) and ``nstepmax`` cut."""
    import re

    from ramses_tpu_torch.io import reader
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    run_dir = os.path.join(tmp, "cli")
    os.makedirs(run_dir)
    pos = _gaussian_ics(os.path.join(run_dir, "grafic_files"),
                        2 ** COSMO_CLI_LEVEL, COSMO_SIGMA, COSMO_SEED)
    if not pos > 0.0:
        raise AssertionError(f"phase 43 ICs: min(1+δ) = {pos} <= 0")
    text = open(COSMO_NML).read()
    if f"levelmin={COSMO_CLI_LEVEL}" not in text:
        raise AssertionError(f"cosmo.nml's levelmin is not "
                             f"{COSMO_CLI_LEVEL}")
    nml = os.path.join(run_dir, "cosmo.nml")
    with open(nml, "w") as f:
        f.write(text.replace("&RUN_PARAMS",
                             f"&RUN_PARAMS\nnstepmax={COSMO_CLI_STEPS}", 1))
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "ramses_tpu_torch", nml],
                         cwd=run_dir, env=env, text=True,
                         capture_output=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = run.stdout.strip().splitlines()
    cosmo = [ln for ln in lines if re.match(r"cosmo-amr aexp=\S+ nstep=", ln)]
    out = os.path.join(run_dir, "output_00001")
    ok, reason = (ckpt.validate_checkpoint(out) if os.path.isdir(out)
                  else (False, "missing"))
    nrows = (len(reader.load_snapshot(out)["part"][0]["mass"]) if ok
             else 0)
    if not (run.returncode == 0 and len(cosmo) == 1
            and f"nstep={COSMO_CLI_STEPS}" in cosmo[0] and ok
            and nrows == 8 ** COSMO_CLI_LEVEL):
        raise AssertionError(
            f"phase 43 CLI: rc {run.returncode}, cosmo-amr lines {cosmo}, "
            f"output_00001 {reason}, {nrows} particle rows; stdout tail "
            f"{lines[-6:]}; stderr tail {run.stderr[-2000:]}")
    _print(f"phase 43 the CLI on {card}: python -m ramses_tpu_torch "
           f"cosmo.nml (64³ ICs, nstepmax={COSMO_CLI_STEPS}) rc 0 in "
           f"{wall:.1f} s: {cosmo[0]}; output_00001 validates, "
           f"{nrows} particle rows")


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
    mixed = bmod.BoundarySpec(faces=(
        (bmod.FaceBC(0), bmod.FaceBC(0)), (bmod.FaceBC(1), bmod.FaceBC(1)),
        (bmod.FaceBC(2), bmod.FaceBC(2))))
    cases = [(rs, st, periodic, False, CHECK_SHAPE) for rs in ("llf", "hllc")
             for st in (1, 2, 8)]
    cases += [("llf", 1, periodic, True, CHECK_SHAPE),
              ("hllc", 2, walls, True, CHECK_SHAPE)]
    # ragged against K1's 32 x 8 tiles and 16-plane chunks, thin axes, and
    # 2-cell periodic axes whose ring wraps onto the tile itself
    cases += [("hllc", 2, periodic, True, (19, 13, 37)),
              ("llf", 8, walls, False, (19, 13, 37)),
              ("llf", 1, mixed, True, (2, 16, 16)),
              ("hllc", 8, walls, True, (16, 3, 33)),
              ("llf", 2, periodic, False, (2, 2, 2)),
              ("hllc", 1, periodic, True, (2, 2, 34)),
              ("llf", 2, mixed, True, (67, 45, 70))]
    worst = {"excess": -1.0, "max_abs_err": 0.0, "dt_rel": 0.0}
    for i, (rs, st, bc, masked, shape) in enumerate(cases):
        cfg = HydroStatic(ndim=3, riemann=rs, slope_type=st)
        u = torch.from_numpy(_random_state(shape, cfg.gamma, i)).to(dev)
        ok = None
        if masked:
            g = torch.Generator(device="cpu").manual_seed(100 + i)
            ok = (torch.rand(shape, generator=g) < 0.1).to(dev)
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
                f"slope_type={st} bc={bc.kinds} masked={masked} shape="
                f"{shape}: max abs "
                f"err {err:.3e}, tolerance excess {ex:.3e}, dt rel {rel:.3e}")
        worst["excess"] = max(worst["excess"], ex)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["dt_rel"] = max(worst["dt_rel"], rel)
    _print(f"phase 3 kernel check: {len(cases)} cases at "
           f"{sorted({c[-1] for c in cases})} pass "
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
    if launches != _want(fused_muscl=sim.nstep):
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
    info = fm.launch_info(cfg.riemann)
    nsteps = 20
    t = torch.tensor(sim.t, dtype=torch.float64, device=dev)
    run = lambda: run_steps(sim.grid, u, t, 1e30, nsteps)  # noqa: E731
    step_ms = _median_ms(run, reps=5, warm=1) / nsteps
    _print(f"phase 5 timing at {tuple(u.shape[1:])}: fused_muscl "
           f"{ms:.4f} ms/launch, plain version {plain_ms:.4f} ms (same "
           f"shape, peak {plain_peak / 2**30:.2f} GiB), bound {bound_ms:.4f} "
           f"ms by {bound_by} ({nbytes / 1e9:.4f} GB -> {bytes_ms:.4f} ms; "
           f"{nops / 1e9:.4f} G ops -> {ops_ms:.4f} ms), "
           f"{100 * bound_ms / ms:.1f} % of the bound; launch: "
           f"{info['smem_bytes']} B dynamic shared memory a block, "
           f"{info['blocks_per_sm']} blocks an SM resident, "
           f"{info['registers']} registers, {info['local_bytes']} B local a "
           f"thread; against plain: "
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

    # ---- 12-17. the MHD slice ----
    k4 = _mhd_phases(dev)

    # ---- 18-21. MHD on the AMR hierarchy ----
    k4_amr, err18 = _mhd_amr_phases(dev)
    k4["launches"] += k4_amr
    k4["max_abs_err"] = max(k4["max_abs_err"], err18)

    # ---- 22-26. the MC tracers on the hydro hierarchy ----
    flux_rows = _tracer_phases(dev)

    # ---- 27. the remaining hydro options: detente.nml ----
    _options_phase(dev)

    # ---- 28-30. the slab-sharded paths: K5 and K1's padded entry ----
    parallel_rows = _parallel_phases(dev)

    # ---- 31-34. self-gravity: config 3 and config 2 with gravity ----
    _gravity_phases(dev, card)

    # ---- 35-38. snapshots, restarts and supervised runs ----
    _restart_phases(dev, card)

    # ---- 39-43. particles and cosmology: config 5 ----
    cfg5 = _cosmo_phases(dev, card)
    k1["launches"] += cfg5["fused_muscl"]
    for r in oct_rows:
        if r["name"] == "tile_sweep":
            r["launches"] += cfg5["tile_sweep"]
    if PROFILER_LOST:
        _print("timing: the profiler lost these kernels' records in every "
               "window; their ms are queued CUDA events: "
               + "; ".join(PROFILER_LOST))
    _print(json.dumps({"kernels": [k1] + oct_rows + [k4] + flux_rows
                       + parallel_rows}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
