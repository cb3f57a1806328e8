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
   cell-updates/s (``Σ_l noct·8·2^(l-lmin)`` per coarse step).  Its
   regrids migrate on the device (``device_regrid``, the default): K7
   (``csrc/regrid_maps.cu``) once a changed level above levelmin;
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
   then, from that state, one coarse step split by part with
   ``device_regrid`` on and off (each synchronised), a ``cProfile`` of one
   regrid with the top 12 functions by cumulative time under
   ``_flag_and_tree`` and under ``_rebuild_maps``, and ``keys.encode`` and
   ``Octree.lookup_keys`` at 262,144 keys through the native library and
   through numpy (bitwise equal), and both paths at batch sizes from 1,024
   to 262,144 (``KEY_SWEEP``), timed in turn, to place ``keys.NATIVE_MIN``;
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
   for 3 coarse steps (a regrid before each) with every launch count at 0
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
   (``poisson=.true.``), its depth cut to fit the script's time limit
   (``GRAV_WARM``): 1 warm coarse step, then 2 timed, each a regrid
   and a coarse step: PCG iterations/s, iterations a step, cell-updates/s;
   K1 and K3 exactly as the levels stepped require, leaf mass to rel 1e-5,
   every level's phi, fg and u finite; a coarse step's host seconds by
   part with ``solve_gravity`` as one; the finest level's PCG cut to 0 and
   10 iterations under the profiler (launches an iteration, busy share);
   one coarse step twice from one state, bitwise (u, phi, fg,
   iterations);
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
38. the CLI in a subprocess on a copy of sedov3d.nml at 128³
   (``CLI_LEVEL``) whose output time
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
   before, 16 coarse steps through ``evolve`` (a regrid each; level 9
   first appears in the 16th): K1 and K3
   exactly as the levels stepped require, levels 8 and 9 reached, the leaf
   gas mass (rel 1e-5), the particle count and mass kept, u, phi, fg and
   the particles finite, aexp rising; octs per level, the steps' walls and
   dts, s a coarse step and cell-updates/s over the first 15; the 16th
   with its host seconds by part (regrid, maps, solve, gather and kick,
   the K1/K3 sweep, drift, Courant fetch);
40. one coarse step twice from phase 39's state after 11 steps
   (``from_state`` with the particles; level 8 created by the step's
   regrid): u, phi, fg, particle x and v, trees and PCG iterations
   bitwise;
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
   rows;
44. self-gravity with particles on the MHD hierarchy: the JAX test's
   magnetised blob (``tests/test_mhd_amr.py:218``) in 3D at levelmin 6,
   levelmax 7 (``MHD_GRAV_LEVELS``, cut from config 2's sizes), f32,
   ``poisson`` and ``pic`` with 2,097,152 particles from
   ``default_rng(44)``, 2 coarse steps (a regrid each; step 1 timed part
   by part, step 2 under the profiler, its device busy share; cut from 5
   to fit the time limit): K4 once a
   complete-level substep, the leaf gas mass to rel 1e-5, the particle
   count and mass kept, ``max|div B|·dx/max|B|`` ≤ 1e-5 where the scheme
   keeps it, a finite state, the peak leaf density rising; K4 on the
   last step's first complete-level inputs against its plain version
   within ``LOCAL_ATOL + LOCAL_RTOL·M``; step 2 replayed twice
   (``MHD_GRAV_REPLAY``), bitwise (u, faces, phi, particles, trees);
45. velocity tracers on the phase-44 hierarchy without gravity, in a
   bulk flow, a tracer a leaf cell: 3 coarse steps, the tracers kept,
   finite, inside the box and moving; the tracer pass's seconds;
46. the uniform MC tracer functions at 256³ on a random state:
   ``step_with_flux`` through K1's ``want_flux`` entry (one launch)
   against the plain version within ``LOCAL_ATOL + LOCAL_RTOL·M``, then
   ``mc_tracer_step`` on 2,097,152 tracers: kept and inside the box, the
   moved fraction beside the expected Σp/N;
47. ``collapse_iso.nml`` through ``run_cli`` in process, as shipped but
   ``nstepmax`` and ``levelmax`` (``COLLAPSE_STEPS``, 1, and
   ``COLLAPSE_LEVELMAX``, 7 for the shipped 8): K1 and K3 as the levels stepped
   require, a finite state, a sink CSV with the reference's header; the
   sinks, and s a coarse step by part with the sink pass on its own;
48. ``smbh_bondi.nml`` through ``run_cli`` as shipped, ``--dtype
   float64`` (2D, the general formulation): a sink forms in the first
   pass, accretes and dumps AGN energy (the state turns non-finite a few
   steps on, ROADMAP §C8); the sink mass by pass;
49. ``turb_driving.nml`` through ``run_cli`` as shipped (32³, a
   ``turb_fields.npz`` in its output), then at 256³ for 20 steps through
   ``Simulation``: K1 once a step, the rms momentum finite and rising from
   rest, a same-seed replay bitwise (u and the OU field), ms a step with
   and without the forcing.  Phases 47-49 write under a
   ``tempfile.mkdtemp`` directory, removed at the end; their K1, K3 and
   K4 launches (and phase 46's flux launch) join the kernels line's rows;
50. ``BASELINE.json`` config 1 with cooling: sedov3d at 256³ f32 with
   ``&COOLING_PARAMS cooling`` and the JAX tests' ISM units, 20 steps
   through ``Simulation`` (``run_steps_cool``): K1 and K6's fused entry
   (``csrc/cooling.cu``, cooling_step's conversions and the per-cell
   cooling solve in one launch) once a step and K6's march never, no host
   sync in two steps under the sync debug mode "error", a replay bitwise,
   the energy below the adiabatic run's, a finite state; K6's fused entry
   on the last step's recorded state against ``cooling_step_ref`` (the E
   row per cell, |ΔE| over the new thermal energy, under the gates below
   through the march's conditioning, in the state's f32 and again in f64;
   the other rows untouched), timed beside the plain version, the torch
   passes around the march entry, and its bound; K6's march on that
   state's march inputs against its plain version (f32: each cell within
   rel 2e-5 of the plain f32 result or ten times its conditioning move,
   at most 0.1 % of the cells in that form, and at each quantile of the
   cells' error against the f64 plain result within twice the plain f32
   version's; f64: each cell within rel 1e-10 or ten times its
   conditioning move; the worst cell with both iteration counts), its
   device time, the plain version's, the bound (the bytes of what varies
   per cell and the tables, and its operations at this run's iteration
   counts at the unfused f32 rate), the iterations a cell; the same check
   and timing on 2^20 random cells over dt 3e15 s, where the march is
   long; ms a step with and without cooling, and the cooled step's
   Courant pass and select;
51. config 2's hierarchy cut to 6 / 7 (f32) on the JAX test's SF blob
   (``tests/test_amr_physics.py:73-98``) with cooling, self-gravity, star
   formation and thermal feedback, 3 coarse steps: K1, K3 and K6's fused
   entry as the stepped levels require (once a level substep), K1, K3 and
   K6 on the last step's inputs against their plain versions (K1 and K3
   with M any field's stencil max; K6 as in phase 50 on each level's last
   call, the level's rows as ``u[l].T``, and timed on the finest level's
   rows), gas + stars mass to
   rel 1e-5, stars above levelmin, each SN fired once; s a coarse step by
   part and the device's busy share;
52. kinetic feedback (``f_w`` = 1) on the blob at 6 / 7, every pass's
   mass and energy budget; then the JAX stellar test's set-up at 6 / 7
   (quanta scaled by the cell volume): objects spawn and explode, and
   ``stellar_00001.csv`` parses with the reference's header;
53. uniform SF: the blob at 128³ through ``Simulation`` with ``pic``, SF
   and thermal feedback, 5 chunks: gas + stars mass kept, a dump and a
   restore, new star ids past the restored ones;
54. ``namelists/cosmo_gal.nml`` through ``run_cli`` in process, as shipped
   but its 64³ ICs (written by the port's ``write_zeldovich_ics``) and
   ``nstepmax``: the state finite, the cooling tables rebuilt as aexp
   moves, gas + particle mass kept, K6's fused entry (never its march)
   with the epoch's scales a device tensor, checked as in phase 50 on the
   last call's rows; stars, aexp and s a step by part.
   Phases 52-54 write under a ``tempfile.mkdtemp`` directory, removed at
   the end; the K6 row's launches are phases 50, 51 and 54's (both
   entries); its times are the fused entry's at phase 50;
55. the device migrate: config 2 from one initial state for 10 coarse
   steps with ``device_regrid`` on and off, after every regrid the trees'
   keys and every level's ``u`` bitwise equal, ``build_prolong_maps``
   never called on the device path, K7's launches equal to the changed
   levels above levelmin, K7 bitwise to its plain version on every
   regrid's inputs and on random sorted key sets of 262,144 octs (2D and
   3D, periodic and reflecting); K7's device ms, its plain version's and
   its bound (the new keys read once, the maps written once) at the main
   path's largest regrid level and at 262,144 octs;
56. non-cubic roots: (a) config 2's twin, sedov3d at ``nx=ny=nz=2``,
   ``boxlen=0.25``, levelmin 6 / levelmax 8 (config 2's cells), 10
   coarse steps: after each regrid its level-l oct coordinates equal
   phase 55's level-(l+1) ones, its leaf field within ``1e-10 + 1e-6·M``
   of config 2's (and whether bitwise), K1 and K3 launched as the levels
   require, cell-updates/s beside config 2's; (b) sedov3d at root
   (2, 1, 1), 6 / 8, 5 coarse steps: K1 on the 128×64×64 complete level,
   K1 and K3 on the last step's inputs against their plain versions, mass
   conserved to rel 1e-5;
57. radiative transfer, the kernels: K8 (``csrc/rt_m1.cu``) against its
   plain version on random f64 states, its dense entry in 1D, 2D and 3D,
   periodic and outflow, 1 to 3 groups, with and without beams, on sizes
   ragged against its 32 × 8 tiles and with fewer than three x planes,
   its chunks of x planes (1, 2, 3 and all 37) bitwise the launch's own
   choice, and its block entry on random gathered stencils, the last
   block's octs ragged (only the octs' rows written), every value within
   1e-13 × the field's max over the cell's 3^d stencil; K9
   (``csrc/rt_chem.cu``) gray
   and 3-ion (1 to 8 groups), with and without the UV background, heating
   on and off, on 1,000,003 random cells (N 1e-30 to 1e-5, T 10 to 1e6 K),
   every value within rel 1e-12;
58. the RT main path: ``stromgren3.nml`` at 128³ (levelmin = levelmax = 7
   set in code) through ``run_namelist``: one static advance of 684
   substeps, K8 and K9 launched once each a substep, the state finite,
   photons within 1.05 of those injected, the x²-weighted ionized volume
   within rel 0.3 of the analytic Strömgren growth; the RT wall, ms a
   substep, a 40-substep window's device busy share; K8 and K9 timed on
   the final state beside their plain versions and bounds (bytes at
   3.35 TB/s or f64 operations unfused at 16.75e12/s, pow and exp one
   each);
59. ``iliev1``, ``rad_beams``, ``stromgren2d``, ``stromgren3`` and
   ``twin_rad_src`` through the CLI in process as shipped, each run's
   substeps and launches (K9 none under ``rt_pp``); ``iliev1.nml`` at 128³
   to tout = 100: K1 once an issued step, K8/K9 once a substep, mass to
   rel 1e-5, the energy up, the photon budget, RT's share of the wall;
60. RT on the hierarchy: ``tests/test_rt_amr.py``'s refined front at
   levelmin 6 / levelmax 7 (one refined level, as the JAX test's 4 / 5;
   f32 gas, r_refine 0.25), one coarse step of 59 substeps: K1, K3, K8's
   dense and block entries and K9 launched as
   the levels and substeps require, K7 never; the ionized volume and the
   gas energy up, every level's radiation finite with N >= 0, the front
   radially ordered on level 7; then the 3-group He ladder at 64³ beside
   the uniform driver (the JAX test's bound, rel 0.35);
61. the clump finder's watershed (K10, ``csrc/watershed.cu``) against its
   plain version ``watershed_ref`` on the card, labels bitwise: random
   f64 fields at 64³, 256² and 256³, the noise quantised to four levels
   (plateaus for the index tie-break) at 64³ and 256³, four Gaussian peaks
   at 128³ (long uphill chains), each at thresholds that cut off none,
   half and 99 % of the cells; K10's device ms a call (its two kernels
   in ``torch.profiler``) and a call's wall on the stream (median of CUDA
   events after warm-up), the plain version's, the bound (rho read and
   the labels written once, 16 B a cell, or a comparison a neighbour and
   a link followed at 33.5 TFLOP/s f64), the share of it, the links
   followed, and the registers and spills of its build;
62. ``namelists/mergertree.nml`` (f32, ``build_namelist_sim`` and
   ``evolve`` as ``run_namelist`` runs it, a dump at each output) on the
   port's 64³ Gaussian ICs, its clump finder, AMR, refinement and
   cosmology keys as shipped, ``aout`` cut to ``MT_AOUT``: at each of the
   three outputs a ``clump_NNNNN.txt``, a ``clump_cat_NNNNN.npz`` and from
   the second a ``mergertree_NNNNN.txt`` under the manifest; K10 once an
   output, K1/K3 as the levels stepped require; each output's K10 labels
   bitwise the plain version's on the deposit the run built (recorded);
   the largest halo of the last output has a main progenitor in the one
   before; the bound mass within the particles'; the clump pass's host
   seconds an output by part; then a restart from the second output
   (``nrestart=2``) whose ``mergertree_00003.txt`` is the straight run's,
   bitwise or with the same main branch; and the CLI in process
   (``nstepmax=2``): K10 once, its one output's clump table;
63. config 5 (phase 39's ``cosmo.nml`` at 128³) with ``lightcone``, full
   sky, ``zmax_cone`` 1000 and ``boxlen_ini`` ``CONE_BOX`` set in code,
   ``CONE_STEPS`` coarse steps: one ``cone_NNNNN.npz`` a step, each
   ``a_emit`` between its step's epochs, the shells tiling the lookback
   distance; a dump restored emits its first shell; the emission's host
   ms a step and the particles a shell.
   A line then gives the script's wall by group of phases.

The line before the last holds every ported kernel's numbers as one JSON
object (``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script fails before printing any result.
"""

from __future__ import annotations

import json
import math
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
# tracer_per_cell=1.0 (the namelist default) set in code, cut to 3 coarse
# steps (2 with oct_blocking=.false.)
TRACER_STEPS, TRACER_STENCIL_STEPS = 3, 2
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


# (script seconds, phase) at each printed phase line, for the per-phase
# wall line at the end: a phase's wall is the gap to the line before it
PHASE_MARKS = []


def _print(*a):
    text = " ".join(str(x) for x in a)
    if text.startswith("phase "):
        PHASE_MARKS.append((time.perf_counter(), text.split()[1]))
    print(text, flush=True)


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
    ``-Xptxas -v`` report: each entry's first figures after its
    "Compiling entry function" line (the functions it calls report their
    own frames after them)."""
    import re
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                   f"{spill.group(1) if spill else '?'} B spill stores")
    return "; ".join(out)


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


def _count_ops(fn, extra=()) -> int:
    """Elementwise operations the plain version performs, counted from
    the tensors it computes on: each arithmetic, comparison or select op
    counts its output's elements, a reduction its input's; ``extra`` names
    more ops counted as one operation an element (``pow``, ``exp``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    elementwise = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sign",
                   "sqrt", "reciprocal", "maximum", "minimum", "clamp",
                   "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge",
                   "eq", "ne"} | set(extra)
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
             warm: bool = True, stats: dict = None, raw: bool = False,
             names=None, expect: int = None, tries: int = 5) -> str:
    """One traced run of ``run`` (after one untraced run when ``warm``):
    device kernel time by name and the device's busy share of the window;
    the trace goes to ``out_dir/name`` (not kept when ``name`` is None).
    ``stats``, when given, receives the busy microseconds, the wall
    seconds and the kernel launches of the window.  With ``raw`` only the
    device is traced and its busy time is the sum of the raw events, with
    no trace and no table by name: the tables take minutes to build at the
    ~400,000 launches of an MHD gravity coarse step.  With ``names`` (raw
    only) the sum is that of the kernels whose names hold one of
    ``names``, and the window opens with 20 untimed kernels and a
    synchronisation (the trace drops a window's first records, as
    :func:`_device_ms` says); with ``expect`` too, a window that kept
    other than ``expect`` of those records is traced again, up to
    ``tries`` windows, and the share is reported as not measured when
    none did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        run()
    lead = torch.zeros(16, device="cuda") if names else None
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries if expect is not None else 1):
        with profile(activities=[ProfilerActivity.CUDA] if raw else
                     [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if names:
                for _ in range(20):
                    lead.add_(1.0)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if not raw:
            break
        ev = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and (not names or any(k in e.name() for k in names))]
        if expect is None or len(ev) == expect:
            break
        seen.append(len(ev))
    else:
        return (f"busy share not measured: the profiler kept {seen} of "
                f"{expect} kernel records in {tries} windows")
    if raw:
        busy_us = sum(e.duration_ns() for e in ev) / 1e3
        if stats is not None:
            stats.update(busy_us=busy_us, wall_s=wall, launches=len(ev))
        return (f"device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
                f"wall ({100 * busy_us / 1e6 / wall:.1f} %), {len(ev)} "
                f"{'kernel records' if names else 'device events'}")
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
    from ramses_tpu_torch.hydro import cooling
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.parallel import dma_halo
    from ramses_tpu_torch.amr import device_regrid
    from ramses_tpu_torch.pm import clumps
    from ramses_tpu_torch.rt import chem as rt_chem
    from ramses_tpu_torch.rt import m1 as rt_m1
    cooling.launches = cooling.step_launches = 0
    device_regrid.launches = clumps.launches = 0
    rt_m1.launches = rt_m1.block_launches = rt_chem.launches = 0
    fm.launches = fm.flux_launches = 0
    fm.padded_launches = fm.padded_flux_launches = 0
    ct_slab.launches = dma_halo.launches = 0
    for name in om.launches:
        om.launches[name] = 0


def _counts() -> dict:
    """Every kernel's launch count, the flux variants under their own
    keys (``fused_muscl_flux``, ``tile_sweep_flux``, ``oct_sweep_flux``)
    and K1's padded entry under ``fused_muscl_padded(_flux)``; K6's fused
    entry under ``cooling_step``; K8's block entry under ``rt_m1_block``;
    K10 under ``watershed``."""
    from ramses_tpu_torch.hydro import cooling
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.parallel import dma_halo
    from ramses_tpu_torch.pm import clumps
    from ramses_tpu_torch.rt import chem as rt_chem
    from ramses_tpu_torch.rt import m1 as rt_m1
    return {"fused_muscl": fm.launches, "fused_muscl_flux": fm.flux_launches,
            "fused_muscl_padded": fm.padded_launches,
            "fused_muscl_padded_flux": fm.padded_flux_launches,
            **om.launches, "ct_step_slab": ct_slab.launches,
            "halo_exchange": dma_halo.launches, "cooling": cooling.launches,
            "cooling_step": cooling.step_launches,
            "rt_m1": rt_m1.launches, "rt_m1_block": rt_m1.block_launches,
            "rt_chem": rt_chem.launches, "watershed": clumps.launches}


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


def _output_scales(blk, c: int, planes: bool, any_field: bool = False):
    """The scale of each value a sweep of ``blk`` returns: a cell's own
    5³ stencil max for ``du``; for a face flux the larger of the two cells
    it touches, and for K2's per-oct face sums the largest over the four
    faces summed.  Shaped as ``(du, corrp)`` (K3) or ``(du, corr)`` (K2).
    With ``any_field`` each field's scale is the largest of every field's
    (K4's M)."""
    import torch
    from ramses_tpu_torch.amr import kernels as K
    s = _block_stencil_scale(blk)
    if any_field:
        s = s.amax(0, keepdim=True).expand_as(s)
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


def _timed_parts(patches: dict):
    """Wrap each ``name: (owner, attribute)`` (a method of a hierarchy, a
    class or a module function) so that its calls are synchronised and
    their wall seconds summed into ``acc[name]``; returns (acc, the
    function that puts the originals back)."""
    import torch
    acc = dict.fromkeys(patches, 0.0)
    saved = []
    for name, (owner, attr) in patches.items():
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn, attr in vars(owner)))

        def call(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            acc[_name] += time.perf_counter() - t0
            return out
        setattr(owner, attr, call)

    def restore():
        for owner, attr, fn, own in reversed(saved):
            if own:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
    return acc, restore


def _host_breakdown(sim, run, parts=("_flag_and_tree", "_rebuild_maps",
                                      "_migrate_level", "_restrict_all",
                                      "coarse_dt", "step_coarse"),
                    nested=()) -> str:
    """Wall seconds of one ``run`` of an AMR coarse step split by the
    hierarchy's parts (methods of ``sim``, :func:`_timed_parts`); the
    ``nested`` parts run inside others and stay out of the remainder
    ("other host").  Returns (the line, seconds by part)."""
    import torch
    acc, restore = _timed_parts({name: (sim, name) for name in parts})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        restore()
    total = time.perf_counter() - t0
    acc["other host"] = total - sum(v for k, v in acc.items()
                                    if k not in nested)
    return f"total {total:.4f} s: " + ", ".join(
        f"{k.strip('_')} {v:.4f}" for k, v in acc.items()), acc


def _amr_phases(dev, card: str):
    """Phases 7-11 (the AMR slice); returns K1's max abs err on level 7 of
    the AMR state, the K3 and K2 rows of the kernels line and phase 8's
    cell-updates/s."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import bitperm
    from ramses_tpu_torch.amr import device_regrid as dregrid
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
    k7 = dregrid.launches
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
    if not k7 > 0:
        raise AssertionError("AMR main path: no regrid went through K7 "
                             "(regrid_maps)")
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
           f"{launches} (expected {want}), regrid_maps (K7) {k7}; leaf mass {mass0:.9e} -> "
           f"{mass1:.9e}; AmrSim() {init_s:.3f} s, evolve {wall:.3f} s = "
           f"{sim.cell_updates / wall:.4e} cell-updates/s "
           f"({sim.cell_updates} cell updates)")
    rate8 = sim.cell_updates / wall

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
    _print(f"phase 11 the regrid on {card}: " + _regrid_split(sim))

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
                      oct_launches)], rate8, k7

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
# bench.py's bench_amr_poisson runs 6 warm and 4 timed coarse steps and
# phase 33 replayed 3: ~5 s each on an H100, so cut to fit the time limit
GRAV_WARM, GRAV_TIMED, GRAV_REPLAY = 1, 2, 1


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

    # replay: GRAV_REPLAY coarse steps twice from one state, bitwise
    state = amr_state_from(sim)

    def replay():
        s = AmrSim.from_state(p, **state)
        s.evolve(1e9, nstepmax=s.nstep + GRAV_REPLAY)
        s.drain()
        return s
    a, b = replay(), replay()
    for l in a.levels():
        same = (np.array_equal(a.tree.levels[l].keys, b.tree.levels[l].keys)
                and torch.equal(a.u[l], b.u[l])
                and torch.equal(a.phi[l], b.phi[l])
                and torch.equal(a.fg[l], b.fg[l]))
        if not same:
            raise AssertionError(f"self-gravity replay of {GRAV_REPLAY} AMR "
                                 f"steps is not bitwise equal on level {l}")
    if {l: int(v) for l, v in a.poisson_iters.items()} != \
            {l: int(v) for l, v in b.poisson_iters.items()}:
        raise AssertionError("self-gravity replay: PCG iteration counts "
                             "differ")
    _print(f"phase 33 replay: {GRAV_REPLAY} coarse steps with self-gravity "
           f"twice from one state, bitwise equal (u, phi, fg, trees, PCG iterations "
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
# ... at levelmin = levelmax = 7 (128³) instead of the shipped 8: at 256³
# its three 1.15 GB dumps and two restores took ~90 s of the script's time
# limit, and phase 35 already round-trips config 1 at 256³
CLI_LEVEL = 7
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
    p.amr.levelmin = p.amr.levelmax = CLI_LEVEL
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
    text = (open(NML).read().replace("nstepmax=10", "nstepmax=100000")
            .replace("levelmin=8\nlevelmax=8",
                     f"levelmin={CLI_LEVEL}\nlevelmax={CLI_LEVEL}"))
    if f"levelmin={CLI_LEVEL}" not in text:
        raise AssertionError("phase 38: sedov3d.nml's levelmin line moved")
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
    n = 2 ** CLI_LEVEL
    _print(f"phase 38 CLI sedov3d {n}³ (levelmin = levelmax = {CLI_LEVEL} "
           f"in the copy) --max-attempts 3 to tout={t1!r} "
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
# cut from 20 to fit the script's time limit: the steps after the
# 16th cost 7-10 s each on an H100 (the host regrid and PCG)
COSMO_STEPS = 16
# the ICs: a Gaussian random δ with P(k) ∝ k⁻² from default_rng(COSMO_SEED),
# scaled to COSMO_SIGMA rms per level-7 cell.  The particle density must
# pass m_refine = 8 mean masses a cell, then 64 (levels 8 and 9), within
# the 16 steps: at 0.2 rms level 8 is first stepped in step 12 and level 9
# in step 16 on an H100 (PERF.md §6).  The baryon density fb·(1+δ) must stay
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
# phase 40 replays one coarse step from the state at step 11: level 8
# first appears in the regrid of step 12, so the replay covers a partial
# level's creation, its PCG and K3 on it (from step 15, level 9's
# creation, 2 steps took 23-33 s and 1 step 19-25 s on an H100 at 700 W)
COSMO_REPLAY_STEPS = 1
COSMO_REPLAY_AT = 11
COSMO_RESTART_AT = 5           # phase 42: 5 steps, dump, restore, 5 more
GROWTH_LEVEL, GROWTH_AEND = 7, 0.06        # phase 41, uniform: 128³
GROWTH_AMR = (4, 5, 0.05)                   # test_cosmo_amr_growth's size
COSMO_CLI_LEVEL, COSMO_CLI_STEPS = 6, 3     # phase 43: 64³ ICs


def _gaussian_ics(dirname: str, n: int, sigma: float, seed: int,
                  box: float = 100.0):
    """A grafic directory of a Gaussian random δ (P(k) ∝ k⁻², rms
    ``sigma``) and its Zel'dovich velocities at cosmo.nml's epoch in a box
    of ``box`` Mpc/h, written with the port's own ``write_zeldovich_ics``.
    Returns min(1+δ)."""
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
    hdr = grafic.GraficHeader(n, n, n, dx=box / n, astart=0.02,
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


def _record_kernel_inputs(store: dict, last: bool = False):
    """Wrap K1's and K3's wrappers so that each one's first call at each
    cell size (with ``last``, its latest) records device copies of its
    inputs in ``store`` (keyed by the kernel's name and dx), then runs the
    kernel as before (one launch, counted as before).  Returns the
    function that restores them."""
    import torch
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.hydro import oct_muscl as om
    k1, k3 = fm.fused_step, om.tile_sweep

    def keep(a):
        return a.clone() if torch.is_tensor(a) else a

    def k3_rec(ut, ok, dt, cfg, dx, shift, want_flux=False):
        if last or ("tile_sweep", dx) not in store:
            store["tile_sweep", dx] = tuple(keep(a) for a in (
                ut, ok, dt, cfg, dx, shift, want_flux))
        return k3(ut, ok, dt, cfg, dx, shift, want_flux)

    def k1_rec(u, dt, cfg, dx, bc, **kw):
        if last or ("fused_muscl", dx) not in store:
            store["fused_muscl", dx] = ((keep(u), keep(dt), cfg, dx, bc),
                                        {k: keep(v) for k, v in kw.items()})
        return k1(u, dt, cfg, dx, bc, **kw)
    fm.fused_step, om.tile_sweep = k1_rec, k3_rec

    def restore():
        fm.fused_step, om.tile_sweep = k1, k3
    return restore


def _recorded_kernel_check(store: dict, level_of: dict,
                           what: str = "config 5",
                           any_field: bool = False) -> str:
    """Each recorded K3 batch and K1 state (:func:`_record_kernel_inputs`)
    through the kernel and its plain version on the card: K3's du and
    face fluxes each within ``LOCAL_ATOL + LOCAL_RTOL·M`` (M the stencil
    scale of phase 10), K1's state within the same of its 5³ stencil max
    (edge cells replicated where the box is not periodic).  With
    ``any_field`` M is the largest of every field's, as for K4: where the
    gas is at rest under pressure (collapse_iso.nml's box) a momentum's
    update is a difference of pressure fluxes, and the plain version's own
    f32 error there (against itself in f64) reaches 1.6e-5 of the
    momentum's own M but 1.2e-7 of every field's (a CPU run).  Raises on
    a disagreement; returns a line of the N and the errors."""
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
                                    True, any_field)
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
            scale = _stencil_scale(want, periodic=all(
                k == (0, 0) for k in bc.kinds))
            if any_field:
                scale = scale.amax(0, keepdim=True).expand_as(scale)
            ex = float((d - (LOCAL_ATOL + LOCAL_RTOL * scale)).max())
            err = float(d.max())
            rel = float((d / scale).nan_to_num(nan=0.0).max())
            what = (f"K1 level {lvl} ({'x'.join(map(str, u.shape[1:]))}, "
                    f"{'masked' if kw.get('ok') is not None else 'unmasked'})"
                    f": max abs err {err:.3e}, err / stencil max {rel:.3e}")
            del got, want, d, scale
        if not ex <= 0.0:
            raise AssertionError(f"{what}: {name} disagrees with its "
                                 f"plain version on the inputs the main "
                                 f"path gave it: {what}, tolerance excess "
                                 f"{ex:.3e}")
        parts.append(what)
    return "; ".join(parts)


def _last_step_check(sim, recorded: dict, last, what: str,
                     any_field: bool = False) -> str:
    """:func:`_recorded_kernel_check` of the K1 and K3 inputs that one
    coarse step of ``sim`` recorded (``last``: its ``_fused_spec``'s
    levels, complete and blocked flags), after checking that every level
    it stepped through K1 or K3 was recorded; empties ``recorded``."""
    import torch
    levels, complete, blocked = last
    want = {("fused_muscl" if c else "tile_sweep", sim.dx(l))
            for l, c, b in zip(levels, complete,
                               blocked or (False,) * len(levels))
            if c or b}
    if set(recorded) != want:
        raise AssertionError(
            f"{what}: the last step's K1/K3 inputs were not all recorded: "
            f"{sorted((k, round(dx, 8)) for k, dx in recorded)} against "
            f"{sorted((k, round(dx, 8)) for k, dx in want)}")
    line = _recorded_kernel_check(
        recorded, {sim.dx(l): l for l in range(sim.lmin, sim.lmax + 1)},
        what, any_field)
    recorded.clear()
    torch.cuda.empty_cache()
    return line


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
    """Phases 39 (config 5 at 128³, 16 coarse steps) and 40 (a bitwise
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
    sim.evolve(tend, nstepmax=COSMO_STEPS - 1)
    sim.drain()
    wall = time.perf_counter() - t0
    # where a coarse step's time goes: the last step, each part
    # synchronised (it is also the step whose K1/K3 inputs are recorded)
    acc, restore = _timed_parts({"sweep": (H, "_coarse_step")})
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
        restore()
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
    nupd = sum(updates[:COSMO_STEPS - 1])
    _print(f"phase 39 config 5 on {card}: cosmo.nml levelmin={lmin} "
           f"levelmax={p.amr.levelmax} (nremap={COSMO_NREMAP}, smallc="
           f"{COSMO_SMALLC}, m_refine {p.refine.m_refine[:p.amr.levelmax]} "
           f"set in code), {npart} particles, ICs "
           f"(σ={COSMO_SIGMA}, min(1+δ)={pos:.4f}) written in {ics_s:.2f} "
           f"s, AmrSim() {init_s:.3f} s; {COSMO_STEPS} coarse steps "
           f"(a regrid each), the first {COSMO_STEPS - 1} through evolve in "
           f"{wall:.3f} s = {wall / (COSMO_STEPS - 1):.4f} s a coarse step, "
           f"{nupd / wall:.4e} cell-updates/s; aexp {a0:.4f} -> "
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
    line = _last_step_check(sim, recorded, stepped[-1], "config 5")
    _print(f"phase 39 K1 and K3 at config 5's shapes (the inputs the last "
           f"coarse step gave them, each level's first substep) against "
           f"their plain versions within LOCAL_ATOL + LOCAL_RTOL·M: {line}")

    _print(f"phase 39 where the last coarse step's time goes (octs "
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
    if not (d["bitwise"] and lmin + 1 in a["u"]):
        raise AssertionError(f"config 5 replay of {COSMO_REPLAY_STEPS} "
                             f"coarse steps from step {COSMO_REPLAY_AT}: "
                             f"levels {sorted(a['u'])}, {d}")
    _print(f"phase 40 config 5 replay: {COSMO_REPLAY_STEPS} coarse steps "
           f"twice from phase 39's state at step {COSMO_REPLAY_AT} (octs "
           f"{ {l: len(v) for l, v in state['tree_og'].items()} }, at "
           f"the end { {l: len(k) for l, k in a['keys'].items()} }; "
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


# ----------------------------------------------------------------------
# 44-49. the coarse-step source passes: gravity, particles and tracers on
# the MHD hierarchy, sinks, turbulence forcing
# ----------------------------------------------------------------------

# config 2's sizes, 7 / 9, took over 600 s for the phase on an H100 at
# 700 W (7-8 s a coarse step, a 32 s set-up, the replay 151 s, the
# profile's tables minutes): cut to 6 / 8, then (the script's time
# limit; 6 / 8 took 72 s for the phase on a slow host) to 6 / 7
MHD_GRAV_LEVELS = (6, 7)
MHD_TRACER_LEVELS = (6, 8)     # phase 45's blob
MHD_GRAV_STEPS = 2             # ~7 s each on an H100 (host regrid and PCG)
MHD_GRAV_NPART = 2097152       # 128³ particles from default_rng(seed)
MHD_GRAV_SEED = 44
MHD_GRAV_PMASS = 0.05          # their total mass (the gas holds ~0.51)
MHD_GRAV_REPLAY_AT, MHD_GRAV_REPLAY = 1, 1   # step 2, twice
MHD_TRACER_STEPS = 3
MC_UNIFORM_NTR = 2097152
MC_UNIFORM_SEED = 46
COLLAPSE_NML = os.path.join(ROOT, "namelists", "collapse_iso.nml")
# tend 0.05 takes 14 coarse steps, over 300 s (the host regrid and the PCG
# ~10 s each a step at 64 k level-8 octs; 4 steps took 85 s on an H100):
# cut by nstepmax to 1, and its levelmax 8 to 7 (one step
# and phase 47b's at 8 took 41 s on a slow host), to fit the script's
# time limit
COLLAPSE_STEPS, COLLAPSE_LEVELMAX = 1, 7
# phase 47b: 1 more coarse step from phase 47's state with n_sink lowered
# to just under the leaf density of the SINK_SEED_CELLS-th densest cell and
# nsinkmax to SINK_MAX, so that sinks form, accrete, merge and drift on the
# 3D hierarchy (as shipped none forms before tend: the clump's nH ~15
# against n_sink 1e4).  After two steps at the shipped levelmax 8 the
# clump's ~3e5 leaf cells lay within 0.02 of its peak density (a CPU
# run), so most of them pass the lowered threshold: nsinkmax ends the
# creation loop early
COLLAPSE_LIVE_STEPS, SINK_SEED_CELLS, SINK_MAX = 1, 64, 16
SMBH_NML = os.path.join(ROOT, "namelists", "smbh_bondi.nml")
TURB_NML = os.path.join(ROOT, "namelists", "turb_driving.nml")
TURB_LEVEL, TURB_STEPS = 8, 20          # phase 49: 256³ through Simulation

# tests/test_mhd_amr.py::test_mhd_amr_self_gravity_collapse's magnetised
# blob (tube_mhd.nml's roe with llf corners, a periodic box) in 3D
MHD_BLOB3D = """
&RUN_PARAMS
hydro=.true.
nremap=1
{run}
/
&AMR_PARAMS
levelmin={lmin}
levelmax={lmax}
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type='square','square'
x_center=0.5,0.5
y_center=0.5,0.5
z_center=0.5,0.5
length_x=10.0,0.25
length_y=10.0,0.25
length_z=10.0,0.25
exp_region=10.0,2.0
d_region=0.1,50.0
p_region=0.05,0.05
A_region=0.1,0.1
B_region=0.0,0.0
C_region=0.0,0.0
/
&HYDRO_PARAMS
gamma=1.6666667
courant_factor=0.8
riemann='roe'
slope_type=1
/
&REFINE_PARAMS
err_grad_d=0.2
/
"""


def _blob3d(run: str, flow: bool = False, levels=MHD_GRAV_LEVELS):
    """Phase 44's blob at ``levels``; ``flow`` gives the gas a bulk
    velocity (0.3, 0.2, 0.1) for phase 45's tracers to follow."""
    from ramses_tpu_torch.config import params_from_string
    lmin, lmax = levels
    text = MHD_BLOB3D.format(lmin=lmin, lmax=lmax, run=run)
    if flow:
        text = text.replace("C_region=0.0,0.0", "C_region=0.0,0.0\n"
                            "u_region=0.3,0.3\nv_region=0.2,0.2\n"
                            "w_region=0.1,0.1")
    return params_from_string(text, ndim=3)


def _leaf_rho_max(sim) -> float:
    """The largest density of any leaf cell of the hierarchy."""
    import torch
    peak = 0.0
    for l in sim.levels():
        leaf = torch.as_tensor(~sim.tree.refined_mask(l), device=sim.device)
        if bool(leaf.any()):
            rho = sim.u[l][:sim.tree.noct(l) * 2 ** sim.tree_ndim, 0]
            peak = max(peak, float(rho[leaf].max()))
    return peak


def _leaf_rho(sim):
    """Every leaf cell's density on the host (f64 numpy, one fetch a
    level)."""
    import numpy as np
    return np.concatenate([
        sim.u[l][:sim.tree.noct(l) * 2 ** sim.tree.ndim, 0].double().cpu()
        .numpy()[~sim.tree.refined_mask(l)] for l in sim.levels()])


def _mhd_held(sim):
    """The levels where the MHD scheme keeps div B at roundoff (phase 19,
    ROADMAP §C3)."""
    return [l for l in sim.levels() if sim.maps[l].complete
            or (sim.maps[l - 1].complete and not sim.tree.has(l + 1))]


def _source_phases(dev, card: str) -> dict:
    """Phases 44-49; returns the launches of their main paths by kernel."""
    import shutil
    import tempfile
    out = {}
    out["ct_step_slab"] = _mhd_grav_phase(dev, card)
    _mhd_tracer_phase(card)
    out["fused_muscl_flux"] = _mc_uniform_phase(dev, card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sources_")
    try:
        k47 = _collapse_phase(card, tmp)
        _smbh_phase(card, tmp)
        k49 = _turb_phase(dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["fused_muscl"] = k47["fused_muscl"] + k49
    out["tile_sweep"] = k47["tile_sweep"]
    return out


def _mhd_grav_phase(dev, card: str) -> int:
    """Phase 44: the magnetised blob in 3D on the MHD hierarchy with
    self-gravity and 2,097,152 particles; returns K4's launches."""
    import numpy as np
    import torch
    from ramses_tpu_torch.convert import mhd_amr_state_from, particles_from
    from ramses_tpu_torch.mhd import amr as mamr
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.pm.particles import ParticleSet
    p = _blob3d("poisson=.true.\npic=.true.")
    lmin = p.amr.levelmin
    rng = np.random.default_rng(MHD_GRAV_SEED)
    x = rng.random((MHD_GRAV_NPART, 3))
    ps = ParticleSet.make(x, np.zeros_like(x),
                          np.full(MHD_GRAV_NPART,
                                  MHD_GRAV_PMASS / MHD_GRAV_NPART),
                          dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    sim = mamr.MhdAmrSim(p, particles=ps)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mass0 = float(sim.totals()["mass"])
    pmass0 = float(sim.p.m.double().sum())
    rho0 = _leaf_rho_max(sim)
    stepped, walls, recorded, state = [], [], [], {}
    step_coarse = sim.step_coarse
    kernel = ct_slab.ct_step_slab

    def record(*a, **k):
        if not recorded:
            recorded.append((tuple(v.clone() if torch.is_tensor(v) else v
                                   for v in a),
                             {kk: (v.clone() if torch.is_tensor(v) else v)
                              for kk, v in k.items()}))
        return kernel(*a, **k)

    def counted(dt):
        stepped.append(sim._fused_spec())
        if len(stepped) == MHD_GRAV_REPLAY_AT + 1:
            state.update(mhd_amr_state_from(sim))
            state["particles"] = particles_from(sim.p, torch.float32,
                                                "cpu")
        if len(stepped) == MHD_GRAV_STEPS:
            ct_slab.ct_step_slab = record
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            step_coarse(dt)
        finally:
            ct_slab.ct_step_slab = kernel
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    def coarse_step():
        sim.regrid()
        sim.step_coarse(sim.coarse_dt())
    # the first steps as evolve runs them, the last but one with each part
    # synchronised, the last under the profiler (its K4 inputs recorded)
    sim.step_coarse = counted
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim.evolve(1e9, nstepmax=MHD_GRAV_STEPS - 2)
    acc, restore = _timed_parts({"sweep": (mamr, "_coarse_step")})
    try:
        line, parts = _host_breakdown(
            sim, coarse_step,
            parts=("regrid", "_build_pm", "solve_gravity", "_pm_force",
                   "_pm_drift", "coarse_dt", "step_coarse"),
            nested=("_build_pm", "solve_gravity", "_pm_force", "_pm_drift"))
    finally:
        restore()
    busy = _profile(coarse_step, None, name=None, warm=False, raw=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse
    k4_want = sum(2 ** (l - lmin) for spec in stepped
                  for l, c in zip(spec.levels, spec.complete) if c)
    want = _want(ct_step_slab=k4_want)
    mass1 = float(sim.totals()["mass"])
    pmass1 = float(sim.p.m.double().sum())
    npart = int(sim.p.active.sum())
    rho1 = _leaf_rho_max(sim)
    divb = sim.divb_levels()
    held = _mhd_held(sim)
    gap = sim.max_face_gap()
    finite = (all(bool(torch.isfinite(sim.u[l]).all())
                  and bool(torch.isfinite(sim.bfs[l]).all())
                  and bool(torch.isfinite(sim.fg[l]).all())
                  for l in sim.levels())
              and bool(torch.isfinite(sim.p.x).all()))
    octs = {l: sim.tree.noct(l) for l in sim.levels()}
    readings = (f"{len(stepped)} coarse steps, launches {launches} (K4 "
                f"expected {k4_want} = Σ 2^(l-{lmin}) over complete levels a "
                f"step), leaf gas mass {mass0:.9e} -> {mass1:.9e}, particles "
                f"{npart} of {MHD_GRAV_NPART}, particle mass {pmass0!r} -> "
                f"{pmass1!r}, peak leaf density {rho0:.6e} -> {rho1:.6e}, "
                f"max|div B|·dx/max|B| per level "
                f"{ {l: float(f'{v:.3e}') for l, v in divb.items()} } (limit "
                f"{DIVB_REL:.0e} on {held}), shared-face gap {gap}, finite "
                f"{finite}, octs {octs}")
    if not (len(stepped) == MHD_GRAV_STEPS and launches == want
            and k4_want > 0 and finite
            and abs(mass1 - mass0) <= 1e-5 * abs(mass0)
            and npart == MHD_GRAV_NPART and pmass1 == pmass0
            and rho1 > rho0 and gap == 0.0
            and max(divb[l] for l in held) <= DIVB_REL):
        raise AssertionError(f"phase 44 MHD gravity with particles: "
                             f"{readings}")
    _print(f"phase 44 MHD self-gravity with particles on {card}: the "
           f"magnetised blob in 3D, levelmin {lmin} levelmax "
           f"{p.amr.levelmax}, f32, {MHD_GRAV_NPART} particles "
           f"(default_rng({MHD_GRAV_SEED}), total mass {MHD_GRAV_PMASS}); "
           f"MhdAmrSim() {init_s:.3f} s, {MHD_GRAV_STEPS} coarse steps (a "
           f"regrid each; step {MHD_GRAV_STEPS - 1} synchronised part by "
           f"part, step {MHD_GRAV_STEPS} under the profiler) in {wall:.3f} "
           f"s, step walls "
           f"{[round(w, 3) for w in walls]}; {readings}")

    # K4 against its plain version on the last step's first complete-level
    # call
    a, k = recorded[0]
    got = kernel(*a, **k)
    want4 = ct_slab.ct_step_slab_ref(*a, **k)
    torch.cuda.synchronize()
    err, _, excess, k4_line = _ct_check(got, want4, 3)
    if not excess <= 0.0:
        raise AssertionError(f"phase 44: ct_step_slab disagrees with its "
                             f"plain version on the last step's inputs: "
                             f"{k4_line}")
    ms = _device_ms(lambda: kernel(*a, **k), "mhd_ct_fused", n=20)
    plain_ms = _median_ms(lambda: ct_slab.ct_step_slab_ref(*a, **k),
                          reps=5, warm=1)
    del got, want4, recorded[:]
    _print(f"phase 44 K4 on the inputs the last coarse step gave it "
           f"({tuple(int(n) - 4 for n in a[0].shape[1:])} with its refined "
           f"mask{' and EMF override' if k.get('ovr') is not None else ''}) "
           f"against its plain version within LOCAL_ATOL + LOCAL_RTOL·M: "
           f"{k4_line}; {ms:.4f} ms/call on the device, plain {plain_ms:.4f} "
           f"ms")
    del a, k
    torch.cuda.empty_cache()

    _print(f"phase 44 where step {MHD_GRAV_STEPS - 1}'s time goes: {line}; "
           f"seconds "
           f"by part: regrid {parts['regrid']:.4f}, PM maps (_build_pm) "
           f"{parts['_build_pm']:.4f}, solve_gravity "
           f"{parts['solve_gravity']:.4f}, sweep (kicks and CT, "
           f"_coarse_step) {acc['sweep']:.4f}, particle kick (gather) "
           f"{parts['_pm_force']:.4f}, drift {parts['_pm_drift']:.4f}, "
           f"Courant fetch {parts['coarse_dt']:.4f}; step {MHD_GRAV_STEPS} "
           f"under the profiler: {busy}")
    del sim
    torch.cuda.empty_cache()

    # a replay from the state before step MHD_GRAV_REPLAY_AT + 1, twice:
    # bitwise
    def replay():
        pp = state.pop("particles")
        s = mamr.MhdAmrSim.from_state(p, **state, particles=particles_from(
            pp, torch.float32, dev))
        state["particles"] = pp
        s.evolve(1e9, nstepmax=s.nstep + MHD_GRAV_REPLAY)
        s.drain()
        return s
    t0 = time.perf_counter()
    ra = replay()
    snap = {l: (ra.u[l].cpu(), ra.bfs[l].cpu(), ra.phi[l].cpu())
            for l in ra.levels()}
    px, pv = ra.p.x.cpu(), ra.p.v.cpu()
    keys = {l: ra.tree.levels[l].keys.copy() for l in ra.levels()}
    del ra
    rb = replay()
    rwall = time.perf_counter() - t0
    same = (set(keys) == set(rb.levels())
            and all(np.array_equal(keys[l], rb.tree.levels[l].keys)
                    and torch.equal(snap[l][0], rb.u[l].cpu())
                    and torch.equal(snap[l][1], rb.bfs[l].cpu())
                    and torch.equal(snap[l][2], rb.phi[l].cpu())
                    for l in keys)
            and torch.equal(px, rb.p.x.cpu()) and torch.equal(pv,
                                                              rb.p.v.cpu()))
    if not same:
        raise AssertionError(f"phase 44: two {MHD_GRAV_REPLAY}-step replays "
                             f"differ")
    _print(f"phase 44 replay: {MHD_GRAV_REPLAY} coarse steps twice from the "
           f"state before step {MHD_GRAV_REPLAY_AT + 1} ({rwall:.3f} s for "
           f"both): bitwise equal (u, faces, phi, particle x and v, trees)")
    del rb, snap, px, pv, state
    torch.cuda.empty_cache()
    return launches["ct_step_slab"]


def _mhd_tracer_phase(card: str):
    """Phase 45: phase 44's hierarchy without gravity, in a bulk flow, with
    velocity tracers."""
    import numpy as np
    import torch
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    from ramses_tpu_torch.pm import amr_physics
    p = _blob3d("tracer=.true.\ntracer_per_cell=1.0", flow=True,
                levels=MHD_TRACER_LEVELS)
    t0 = time.perf_counter()
    sim = MhdAmrSim(p)
    init_s = time.perf_counter() - t0
    x0 = np.array(sim.tracer_x)
    n0 = len(x0)
    nleaf = sim.ncell_leaf()
    drift = amr_physics.tracer_drift_amr
    tw = []

    def timed(s, dt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drift(s, dt)
        tw.append(time.perf_counter() - t0)
    amr_physics.tracer_drift_amr = timed
    try:
        t0 = time.perf_counter()
        sim.evolve(1e9, nstepmax=MHD_TRACER_STEPS)
        sim.drain()
        wall = time.perf_counter() - t0
    finally:
        amr_physics.tracer_drift_amr = drift
    x1 = np.asarray(sim.tracer_x)
    # the largest displacement, each the shortest way round the box
    moved = (float(np.abs((x1 - x0 + 0.5) % 1.0 - 0.5).max())
             if len(x1) == n0 else 0.0)
    if not (len(x1) == n0 and np.isfinite(x1).all()
            and ((x1 >= 0.0) & (x1 < 1.0)).all() and moved > 0.0
            and len(tw) == MHD_TRACER_STEPS):
        raise AssertionError(f"phase 45 MHD tracers: {len(x1)} of {n0}, "
                             f"finite {np.isfinite(x1).all()}, moved {moved}")
    _print(f"phase 45 velocity tracers on the MHD hierarchy on {card}: the "
           f"phase-44 blob without gravity in a bulk flow (0.3, 0.2, 0.1), "
           f"levelmin {p.amr.levelmin} "
           f"levelmax {p.amr.levelmax}, {n0} tracers seeded on {nleaf} leaf "
           f"cells (MhdAmrSim() {init_s:.3f} s), {MHD_TRACER_STEPS} coarse "
           f"steps in {wall:.3f} s, the tracer pass (tracer_drift_amr) "
           f"{[round(w, 4) for w in tw]} s a step; all {len(x1)} kept, "
           f"finite and inside the box; largest move {moved:.4e}")
    del sim
    torch.cuda.empty_cache()


def _mc_uniform_phase(dev, card: str) -> int:
    """Phase 46: ``step_with_flux`` through K1's ``want_flux`` entry at 256³
    and ``mc_tracer_step`` on 2,097,152 tracers; returns K1's flux
    launches."""
    import torch
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.grid.uniform import cfl_dt, step_with_flux
    from ramses_tpu_torch.hydro import fused_muscl as fm
    from ramses_tpu_torch.pm import tracers
    sim = Simulation(load_params(NML, ndim=3))
    g = sim.grid
    # a random state (phase 3's), so that every cell has flows to jump on
    u = torch.from_numpy(_random_state(g.shape, g.cfg.gamma, 46)).to(dev)
    dt = cfl_dt(g, u).to(torch.float32)
    torch.cuda.synchronize()
    _reset_counts()
    un, phi = step_with_flux(g, u, dt)
    torch.cuda.synchronize()
    launches = _counts()
    ref, pref = fm.fused_step_ref(u, dt, g.cfg, g.dx, g.bc, want_flux=True)
    torch.cuda.synchronize()
    scale = _stencil_scale(ref)
    err, rel, ex = _local_check((un, phi), (ref, pref[:, 0]),
                                (scale, scale[0].expand((3,) + g.shape)))
    del ref, pref, scale
    if not (launches == _want(fused_muscl_flux=1) and ex <= 0.0):
        raise AssertionError(f"phase 46 step_with_flux: launches {launches}, "
                             f"against the plain version: max abs err "
                             f"{err:.3e}, err / M (un/phi) {rel}, excess "
                             f"{ex:.3e}")
    swf_ms = _median_ms(lambda: step_with_flux(g, u, dt), reps=10)
    gen = torch.Generator(device=dev).manual_seed(MC_UNIFORM_SEED)
    boxlen = float(sim.params.amr.boxlen)
    x = torch.rand((MC_UNIFORM_NTR, 3), generator=gen, dtype=torch.float64,
                   device=dev) * boxlen
    rho = u[0].to(torch.float64)
    flux = phi.to(torch.float64)
    _, full = tracers.jump_probs(x, rho, flux, g.shape, g.dx)
    expect = float((1.0 - full[:, 0]).mean())
    del full
    t0 = time.perf_counter()
    xn = tracers.mc_tracer_step(x, rho, flux, g.shape, g.dx, generator=gen)
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    mc_ms = _median_ms(lambda: tracers.mc_tracer_step(
        x, rho, flux, g.shape, g.dx, generator=gen), reps=5, warm=1)
    moved = float((torch.floor(xn / g.dx) != torch.floor(x / g.dx))
                  .any(dim=1).double().mean())
    inside = bool(((xn >= 0.0) & (xn < boxlen)).all())
    if not (xn.shape == x.shape and inside
            and bool(torch.isfinite(xn).all())):
        raise AssertionError(f"phase 46 mc_tracer_step: shape {xn.shape}, "
                             f"inside the box {inside}")
    _print(f"phase 46 the uniform MC tracer step at {g.shape} (a random "
           f"state, sedov3d.nml's solver) on {card}: step_with_flux through "
           f"K1's want_flux entry (launches "
           f"{ {k: v for k, v in launches.items() if v} }) against the "
           f"plain version within LOCAL_ATOL + LOCAL_RTOL·M: max abs err "
           f"{err:.3e}, err / M (un/phi) {'/'.join(f'{v:.3e}' for v in rel)}"
           f"; step_with_flux {swf_ms:.4f} ms; mc_tracer_step on "
           f"{MC_UNIFORM_NTR} tracers (f64, default Generator seed "
           f"{MC_UNIFORM_SEED}): first call {mc_s:.4f} s, {mc_ms:.4f} ms a "
           f"call; all kept and inside the box; moved fraction {moved:.6f} "
           f"against the expected Σp/N {expect:.6f}")
    del sim, u, un, phi, x, xn, rho, flux
    torch.cuda.empty_cache()
    return launches["fused_muscl_flux"]


def _cli_in_process(argv, run_dir):
    """``ramses_tpu_torch.__main__.run_cli(argv)`` in ``run_dir``: returns
    (the sim, wall seconds); the signal handlers it installs are
    restored."""
    import signal

    import torch
    from ramses_tpu_torch.__main__ import run_cli
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT,
                                              signal.SIGUSR1)}
    cwd = os.getcwd()
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    try:
        t0 = time.perf_counter()
        sim = run_cli(argv)
        torch.cuda.synchronize()
        return sim, time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for s, h in saved.items():
            signal.signal(s, h)


def _sink_csv(path: str):
    """(header line, rows [n, 23]) of a ``sink_NNNNN.csv``."""
    import numpy as np
    lines = open(path).read().splitlines()
    rows = [[float(v) for v in ln.split(",")] for ln in lines[2:]]
    return lines[0], np.array(rows, dtype=np.float64).reshape(len(rows), 23)


SINK_HEADER = (" # id,msink,x,y,z,vx,vy,vz,lx,ly,lz,tform,acc_rate,del_mass,"
               "rho_gas,cs**2,etherm,vx_gas,vy_gas,vz_gas,mbh,dmfsink,level ")


def _collapse_phase(card: str, tmp: str) -> dict:
    """Phase 47: collapse_iso.nml through the CLI, in process, as shipped
    but for ``nstepmax`` and ``levelmax`` (``COLLAPSE_STEPS``,
    ``COLLAPSE_LEVELMAX``), K1 and K3 held against their
    plain versions on its last coarse step's inputs; then 47b, live sinks
    on its hierarchy (:func:`_live_sinks`).  Returns the K1 and K3
    launches of both."""
    import torch
    from ramses_tpu_torch.amr import hierarchy as H
    from ramses_tpu_torch.pm import amr_physics
    stepped, recorded = [], {}
    step_coarse = H.AmrSim.step_coarse

    def counted(self, dt):
        spec = self._fused_spec()
        stepped.append((spec.levels, spec.complete, spec.blocked))
        rec = (_record_kernel_inputs(recorded)
               if len(stepped) == COLLAPSE_STEPS else None)
        try:
            step_coarse(self, dt)
        finally:
            if rec is not None:
                rec()
    run_dir = os.path.join(tmp, "collapse")
    os.makedirs(run_dir)
    nml = os.path.join(run_dir, "collapse_iso.nml")
    with open(nml, "w") as f:
        text = open(COLLAPSE_NML).read().replace(
            "&RUN_PARAMS", f"&RUN_PARAMS\nnstepmax={COLLAPSE_STEPS}", 1)
        if "levelmax=8" not in text:
            raise AssertionError("phase 47: collapse_iso.nml's levelmax moved")
        f.write(text.replace("levelmax=8", f"levelmax={COLLAPSE_LEVELMAX}"))
    acc, restore = _timed_parts({
        "regrid": (H.AmrSim, "regrid"),
        "solve_gravity": (H.AmrSim, "solve_gravity"),
        "sweep": (H, "_coarse_step"),
        "sinks": (amr_physics, "sink_passes_amr"),
        "Courant fetch": (H.AmrSim, "coarse_dt")})
    H.AmrSim.step_coarse = counted
    torch.cuda.synchronize()
    _reset_counts()
    try:
        sim, wall = _cli_in_process([nml, "--ndim", "3"], run_dir)
    finally:
        H.AmrSim.step_coarse = step_coarse
        restore()
    launches = _counts()
    lmin = sim.lmin
    want = _cosmo_want(stepped, lmin)
    csv = os.path.join(tmp, "collapse", "output_00001", "sink_00001.csv")
    header, rows = _sink_csv(csv)
    finite = all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())
    nst = max(len(stepped), 1)
    if not (isinstance(sim, H.AmrSim) and launches == want
            and launches["fused_muscl"] > 0 and finite
            and header == SINK_HEADER and len(rows) == sim.sinks.n
            and sim.nstep == COLLAPSE_STEPS):
        raise AssertionError(
            f"phase 47 collapse_iso.nml: t={sim.t} after {sim.nstep} coarse "
            f"steps, launches {launches} (expected {want}), finite {finite}, "
            f"sink CSV header {header!r}, {len(rows)} rows for "
            f"{sim.sinks.n} sinks")
    _print(f"phase 47 collapse_iso.nml through the CLI on {card} (run_cli "
           f"in process, as shipped but nstepmax={COLLAPSE_STEPS} and "
           f"levelmax={COLLAPSE_LEVELMAX}: levelmin "
           f"{lmin} levelmax {sim.lmax}, open box, isolated solve, f32): "
           f"t={sim.t:.6e} in {sim.nstep} coarse "
           f"steps, {wall:.3f} s; octs "
           f"{[sim.tree.noct(l) for l in sim.levels()]}"
           f"; launches {launches} (expected {want}); {sim.sinks.n} sinks, "
           f"masses {[float(f'{m:.4e}') for m in sim.sinks.m]}; sink CSV "
           f"parses with the reference header; seconds a coarse step by part"
           f" (synchronised): " + ", ".join(f"{k} {v / nst:.4f}"
                                            for k, v in acc.items())
           + f", other {(wall - sum(acc.values())) / nst:.4f}")
    line = _last_step_check(sim, recorded, stepped[-1],
                            "phase 47 collapse_iso.nml", any_field=True)
    _print(f"phase 47 K1 and K3 on the inputs collapse_iso.nml's last coarse "
           f"step gave them (each level's first substep; outflow faces) "
           f"against their plain versions within LOCAL_ATOL + "
           f"LOCAL_RTOL·M, M any field's stencil max: {line}")
    live = _live_sinks(sim, card)
    out = {k: launches[k] + live[k] for k in ("fused_muscl", "tile_sweep")}
    del sim
    torch.cuda.empty_cache()
    return out


def _creation_logged(create, log: list):
    """``pm/amr_physics.create_sinks_amr`` (``create``) that also adds the
    sinks it makes and the mass it gives them to the entry ``log[-1]``."""
    import numpy as np

    def created(s, sinks, spec, units):
        n0, m0 = sinks.n, float(np.sum(sinks.m))
        out = create(s, sinks, spec, units)
        log[-1].update(born=out.n - n0, created=float(np.sum(out.m)) - m0)
        return out
    return created


def _live_sinks(sim, card: str) -> dict:
    """Phase 47b: ``COLLAPSE_LIVE_STEPS`` coarse steps of phase 47's
    hierarchy with ``n_sink`` just under the ``SINK_SEED_CELLS``-th densest
    leaf cell and at most ``SINK_MAX`` sinks.  Gates: sinks form; every pass moves mass from the gas to
    the sinks and nowhere else (threshold accretion, no AGN: the change
    of the leaf gas mass and of the sinks' mass sum to zero within
    1e-4 of the latter plus 1e-9 of the gas, f32 roundoff of the cells
    written); the state finite, the sinks in the box; K1 and K3 launched
    as the levels stepped require.  Returns the K1 and K3 launches."""
    import dataclasses

    import numpy as np
    import torch
    from ramses_tpu_torch.pm import amr_physics
    thr = float(np.sort(_leaf_rho(sim))[-SINK_SEED_CELLS - 1])
    sim.sink_spec = dataclasses.replace(
        sim.sink_spec, n_sink=thr * sim.units.scale_nH, nsinkmax=SINK_MAX)
    passes, create = amr_physics.sink_passes_amr, amr_physics.create_sinks_amr
    log, stepped = [], []
    def recorded(s, dt):
        g0, m0 = float(s.totals()["mass"]), float(np.sum(s.sinks.m))
        log.append({"born": 0, "created": 0.0})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        passes(s, dt)
        torch.cuda.synchronize()
        log[-1].update(s=time.perf_counter() - t0, n=s.sinks.n,
                       dgas=float(s.totals()["mass"]) - g0,
                       dsink=float(np.sum(s.sinks.m)) - m0)
    amr_physics.sink_passes_amr = recorded
    amr_physics.create_sinks_amr = _creation_logged(create, log)
    gas0 = float(sim.totals()["mass"])
    x0 = None
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        for _ in range(COLLAPSE_LIVE_STEPS):
            sim.regrid()
            spec = sim._fused_spec()
            stepped.append((spec.levels, spec.complete, spec.blocked))
            if sim.sinks.n:
                x0 = sim.sinks.x.copy()
            sim.step_coarse(sim.coarse_dt())
        torch.cuda.synchronize()
    finally:
        amr_physics.sink_passes_amr = passes
        amr_physics.create_sinks_amr = create
    wall = time.perf_counter() - t0
    launches = _counts()
    want = _cosmo_want(stepped, sim.lmin)
    finite = (all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())
              and bool(np.isfinite(sim.sinks.x).all())
              and bool(np.isfinite(sim.sinks.m).all()))
    inside = bool(((sim.sinks.x >= 0.0) & (sim.sinks.x < sim.boxlen)).all())
    resid = [abs(e["dgas"] + e["dsink"]) for e in log]
    held = all(r <= 1e-4 * abs(e["dsink"]) + 1e-9 * abs(gas0)
               for r, e in zip(resid, log))
    moved = (float(np.abs(sim.sinks.x - x0).max())
             if x0 is not None and len(x0) == sim.sinks.n else None)
    readings = (f"n_sink {sim.sink_spec.n_sink:.6e} (density {thr:.6e}); "
                f"{COLLAPSE_LIVE_STEPS} coarse steps in {wall:.3f} s, octs "
                f"{[sim.tree.noct(l) for l in sim.levels()]}; by pass: "
                + "; ".join(
                    f"{e['born']} new ({e['created']:.4e} created), "
                    f"{e['n']} sinks, sinks {e['dsink']:+.6e}, gas "
                    f"{e['dgas']:+.6e} (|sum| {r:.3e}), {e['s']:.4f} s"
                    for e, r in zip(log, resid))
                + f"; launches {launches} (expected {want}); finite "
                f"{finite}, in the box {inside}; largest sink move in the "
                f"last pass {moved}")
    if not (len(log) == COLLAPSE_LIVE_STEPS and log[0]["born"] > 0
            and sim.sinks.n > 0 and held and finite and inside
            and launches == want and float(np.sum(sim.sinks.m)) > 0.0):
        raise AssertionError(f"phase 47b live sinks: {readings}")
    _print(f"phase 47b live sinks on collapse_iso.nml's hierarchy on {card} "
           f"(phase 47's state, n_sink under the {SINK_SEED_CELLS + 1}th "
           f"densest leaf cell, nsinkmax {SINK_MAX}, threshold accretion, "
           f"f32): {readings}; the "
           f"sink pass {sum(e['s'] for e in log) / len(log):.4f} s a coarse "
           f"step at {sim.sinks.n} sinks")
    return {"fused_muscl": launches["fused_muscl"],
            "tile_sweep": launches["tile_sweep"]}


def _smbh_phase(card: str, tmp: str):
    """Phase 48: smbh_bondi.nml through the CLI as shipped (2D, the
    general formulation), with ``--dtype float64``.  Its clump overshoots
    in the first coarse step and the first AGN dump drives the dt to
    ~1e-31, in the JAX package as in the port (ROADMAP §C8), so the state
    goes non-finite some steps on.  Gates: a sink forms in the first pass,
    accretes and injects AGN energy; the state is finite after that pass;
    in every pass whose sums are finite, the sinks' mass grows by exactly
    the mass created plus (1 - eps_r) of the mass accreted, within 1e-12
    of the largest of those masses and the sinks' mass before the pass
    (host f64)."""
    import numpy as np
    import torch
    from ramses_tpu_torch.pm import amr_physics, sinks as smod
    log = []
    passes, create = amr_physics.sink_passes_amr, amr_physics.create_sinks_amr
    energy = smod.agn_energy

    def recorded(s, dt):
        rho = _leaf_rho(s)
        m0 = float(np.sum(s.sinks.m))
        log.append({"born": 0, "created": 0.0, "dm": 0.0, "e": 0.0,
                    "rho": (float(rho.min()), float(rho.max())),
                    "neg": int((rho < 0.0).sum()),
                    "gas0": float(s.totals()["mass"]), "m0": m0})
        passes(s, dt)
        log[-1].update(
            dsink=float(np.sum(s.sinks.m)) - m0, n=s.sinks.n,
            gas=float(s.totals()["mass"]) - log[-1]["gas0"],
            finite=all(bool(torch.isfinite(s.u[l]).all())
                       for l in s.levels()))

    def agn_recorded(dm, spec, units):
        e, gain = energy(dm, spec, units)
        log[-1].update(dm=float(np.sum(dm)), e=float(np.sum(e)))
        return e, gain
    amr_physics.sink_passes_amr = recorded
    amr_physics.create_sinks_amr = _creation_logged(create, log)
    smod.agn_energy = agn_recorded
    try:
        sim, wall = _cli_in_process([SMBH_NML, "--ndim", "2", "--dtype",
                                     "float64"], os.path.join(tmp, "smbh"))
    finally:
        amr_physics.sink_passes_amr = passes
        amr_physics.create_sinks_amr = create
        smod.agn_energy = energy
    header, rows = _sink_csv(os.path.join(tmp, "smbh", "output_00001",
                                          "sink_00001.csv"))
    eps_r = sim.sink_spec.eps_r
    book = []            # (pass, |Δsink - created - (1 - eps_r)·dm|, scale)
    for k, e in enumerate(log):
        want = e["created"] + (1.0 - eps_r) * e["dm"]
        if np.isfinite([e["dsink"], want]).all():
            book.append((k + 1, abs(e["dsink"] - want),
                         max(abs(e["m0"]), abs(e["dsink"]),
                             abs(e["created"]), abs(e["dm"]))))
    held = all(r <= 1e-12 * sc for _, r, sc in book)
    finite = all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())
    first = log[0] if log else {}
    readings = "; ".join(
        f"pass {k + 1}: {e['born']} new sinks ({e['created']:.4e} created), "
        f"accreted {e['dm']:.4e}, AGN energy {e['e']:.4e}, sinks "
        f"{e['dsink']:+.6e} to {e['n']}, leaf gas {e['gas']:+.6e}, leaf "
        f"density {e['rho'][0]:.3e}..{e['rho'][1]:.3e} ({e['neg']} cells "
        f"below 0) before it, finite after it {e['finite']}"
        for k, e in enumerate(log))
    if not (first and first["born"] > 0 and first["dm"] > 0.0
            and first["e"] > 0.0 and first["finite"] and book
            and book[0][0] == 1 and held and header == SINK_HEADER
            and len(rows) == sim.sinks.n):
        raise AssertionError(f"phase 48 smbh_bondi.nml: {sim.nstep} steps; "
                             f"{readings}; sink mass bookkeeping (pass, "
                             f"|residual|, scale) {book}")
    _print(f"phase 48 smbh_bondi.nml through the CLI as shipped on {card} "
           f"(run_cli in process, 2D, levelmin {sim.lmin} levelmax "
           f"{sim.lmax}, f64): {sim.nstep} coarse steps, t={sim.t:.6e}, "
           f"{wall:.3f} s, state finite at the end {finite} (ROADMAP §C8); "
           f"{readings}; the sinks' mass grew by the mass created plus "
           f"(1 - eps_r) of the mass accreted in passes "
           f"{[k for k, _, _ in book]} (worst |residual| / scale "
           f"{max(r / max(sc, 1e-300) for _, r, sc in book):.3e})")
    del sim
    torch.cuda.empty_cache()


def _turb_phase(dev, card: str, tmp: str) -> int:
    """Phase 49: turb_driving.nml through the CLI as shipped (32³), then at
    256³ for 20 steps through ``Simulation``; returns the 256³ run's K1
    launches."""
    import math
    import re

    import torch
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.driver import Simulation
    sim, wall = _cli_in_process([TURB_NML, "--ndim", "3"],
                                os.path.join(tmp, "turb"))
    v32 = float(torch.sqrt(torch.mean(torch.sum(
        (sim.state.u[1:4] / sim.state.u[0]) ** 2, dim=0))))
    out32 = os.path.join(tmp, "turb", "output_00001", "turb_fields.npz")
    if not (os.path.exists(out32) and v32 > 0.0 and bool(
            torch.isfinite(sim.state.u).all())):
        raise AssertionError(f"phase 49 turb_driving.nml: {sim.nstep} steps, "
                             f"rms velocity {v32}, turb_fields.npz "
                             f"{os.path.exists(out32)}")
    line32 = (f"turb_driving.nml through the CLI as shipped ({sim.grid.shape}"
              f", run_cli in process): {sim.nstep} steps to t={sim.t:.4e} in "
              f"{wall:.3f} s, rms velocity {v32:.4e}, output_00001 with "
              f"turb_fields.npz")
    del sim
    text = open(TURB_NML).read()
    text = re.sub(r"levelmin=\d+", f"levelmin={TURB_LEVEL}", text)
    text = re.sub(r"levelmax=\d+", f"levelmax={TURB_LEVEL}", text)
    text = re.sub(r"nstepmax=\d+", f"nstepmax={TURB_STEPS}", text)
    text = text.replace("tout=0.25", "tout=100.0")

    def run(forced: bool, store=None):
        t = text if forced else text.replace("turb=.true.", "turb=.false.")
        s = Simulation(params_from_string(t, ndim=3))
        rms0 = float(torch.sqrt(torch.mean(s.state.u[1:4] ** 2)))
        torch.cuda.synchronize()
        _reset_counts()
        rec = (_record_kernel_inputs(store, last=True) if store is not None
               else None)
        t0 = time.perf_counter()
        try:
            s.evolve()
            torch.cuda.synchronize()
        finally:
            if rec is not None:
                rec()
        return s, time.perf_counter() - t0, _counts(), rms0
    # the first forced run records K1's inputs at each step (its last
    # step's are kept) for the check against the plain version
    store = {}
    a, _, launches, rms0 = run(True, store)
    k1_line = _recorded_kernel_check(store, {a.grid.dx: TURB_LEVEL},
                                     "phase 49 turbulence", any_field=True)
    store.clear()
    rms = float(torch.sqrt(torch.mean(a.state.u[1:4] ** 2)))
    # the replay is the timed run with forcing (the first one also made
    # the FFT plans)
    b, wall_a, _, _ = run(True)
    same = (torch.equal(a.state.u, b.state.u)
            and torch.equal(a.turb.fhat, b.turb.fhat))
    del b
    c, wall_c, _, _ = run(False)
    if not (a.nstep == TURB_STEPS and launches == _want(
            fused_muscl=TURB_STEPS) and rms > rms0 and math.isfinite(rms)
            and bool(torch.isfinite(a.state.u).all()) and same):
        raise AssertionError(f"phase 49 turbulence at 256³: {a.nstep} steps, "
                             f"launches {launches}, rms momentum {rms0} -> "
                             f"{rms}, replay bitwise {same}")
    _print(f"phase 49 turbulence on {card}: {line32}; turb_driving.nml at "
           f"{a.grid.shape} through Simulation, {TURB_STEPS} steps (chunks "
           f"of 16, one OU update and kick a chunk): launches {launches}, "
           f"rms momentum {rms0:.4e} -> {rms:.4e}, a replay with the same "
           f"seed bitwise (u and the OU field); "
           f"{1e3 * wall_a / TURB_STEPS:.4f} "
           f"ms a step with forcing against {1e3 * wall_c / c.nstep:.4f} ms "
           f"without ({c.nstep} steps); K1 on the forced run's last step's "
           f"inputs against its plain version within LOCAL_ATOL + "
           f"LOCAL_RTOL·M, M any field's stencil max: {k1_line}")
    del a, c
    torch.cuda.empty_cache()
    return launches["fused_muscl"]


# ----------------------------------------------------------------------
# 50-54. cooling (K6), star formation and SN feedback, stellar objects,
# cosmo_gal.nml
# ----------------------------------------------------------------------

# the JAX tests' ISM units (tests/test_amr_physics.py:13-14)
ISM_UNITS = {"units_density": 1.66e-24, "units_time": 3.15e13,
             "units_length": 3.08e18}
COOL_LEVEL, COOL_STEPS = 8, 20             # phase 50: config 1 at 256³
# phase 51: config 2's levels, 7 / 9, took 23 s a coarse step on an H100
# at 700 W (the regrid 12.0 s at 87,975 level-9 octs, the PCG 10.5 s):
# cut to 6 / 8, then to 6 / 7 and 3 coarse steps (after 5 at 6 / 8, 875
# of 1683 stars had fired; 3 at 6 / 8 took 60 s for the phase on a slow
# host), to fit the script's time limit
SF_AMR_LEVELS, SF_AMR_STEPS = (6, 7), 3
FB_LEVELS, FB_STEPS = (6, 7), 3            # phase 52
# phase 52's stellar objects at 6 / 7: the JAX test's set-up at 4 / 5
# with its sink-mass quantum and SN energy scaled by the cell volume
STELLAR_SCALE = 1.0 / 64
SF_UNIFORM_LEVEL, SF_UNIFORM_CHUNKS = 7, 5  # phase 53: 128³, 16 steps each
GAL_NML = os.path.join(ROOT, "namelists", "cosmo_gal.nml")
GAL_LEVEL, GAL_STEPS = 6, 8                # phase 54: 64³ ICs as shipped
# K6 in f64 against its plain version: per cell rel 1e-10, or ten times
# the move of the plain version's own result when nH, T2 or dt change by
# 1 to 64 ulps (tests/test_torch_gpu.py)
K6_F64_REL = 1e-10
# K6 in f32 against its plain f32 version: per cell rel 2e-5 (RTOL), or ten
# times the move of the plain f32 result when nH, T2 or dt change by 1 to
# 4 ulps; at most this share of the cells may take the second form (K6
# and its plain version agree bit for bit in f32 on the card: 2^20 random
# cells, dt 3e15 s, at z = 0 and with the UV of z = 3)
K6_F32_CONDITIONED = 1e-3
# K6 is built with -fmad=false, so its adds and multiplies issue apart:
# half the f32 rate that counts an FMA as two operations
F32_UNFUSED_OPS_PER_S = F32_OPS_PER_S / 2
K6_MARCH_CELLS = 1 << 20                   # phase 50's random cells


def _sf_blob(lmin: int, lmax: int, d_in=10.0, p_in=100.0, tend=0.01,
             **groups):
    """``tests/test_amr_physics.py``'s blob (3D, ISM units) as the port's
    params, with the extra namelist groups given."""
    from ramses_tpu_torch.config import params_from_dict
    g = {"run_params": {"hydro": True},
         "amr_params": {"levelmin": lmin, "levelmax": lmax, "boxlen": 1.0,
                        "npartmax": 10000},
         "init_params": {"nregion": 2, "region_type": ["square", "square"],
                         "x_center": [0.5, 0.5], "y_center": [0.5, 0.5],
                         "z_center": [0.5, 0.5],
                         "length_x": [10.0, 0.25], "length_y": [10.0, 0.25],
                         "length_z": [10.0, 0.25], "exp_region": [10.0, 2.0],
                         "d_region": [0.1, d_in], "p_region": [0.05, p_in]},
         "hydro_params": {"gamma": 5.0 / 3.0, "courant_factor": 0.5},
         "units_params": dict(ISM_UNITS), "output_params": {"tend": tend}}
    for k, v in groups.items():
        g[k] = dict(g.get(k, {}), **v)
    return params_from_dict(g, ndim=3)


def _record_k6(store: dict, order=None):
    """Wrap K6's fused entry (``cooling._fused_step``, which
    ``cooling_step`` launches for what ``fused_supports`` takes) so that
    its calls record device copies of their inputs in ``store``, then
    launch as before: under the key "last" the latest call, or with
    ``order`` (the level of each call, in call order) each level's latest
    call under its level.  A record is ``(tables, u, spec, dt, cfg,
    scales)``, ``u`` laid out as the caller handed it (a level's rows as
    ``u[l].T``).  Returns the function that restores it."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    k6 = pc._fused_step
    calls = [0]

    def kept(a):
        return a.clone() if torch.is_tensor(a) else a

    def rec(u, tables, spec, dt, cfg, t2_floor, scales, inplace):
        if t2_floor is not None:
            raise AssertionError("K6's record keeps no given t2_floor")
        key = "last" if order is None else order[calls[0]]
        calls[0] += 1
        store[key] = (tables, u.clone(), spec, kept(dt), cfg, kept(scales))
        return k6(u, tables, spec, dt, cfg, t2_floor, scales, inplace)
    pc._fused_step = rec

    def restore():
        pc._fused_step = k6
    return restore


def _substep_order(levels) -> list:
    """The level of each cooling call of one coarse step, in call order:
    ``hierarchy._advance`` cools a level after its two finer substeps."""
    if not levels:
        return []
    inner = _substep_order(levels[1:])
    return inner + inner + [levels[0]]


def _k6_ops_per_iter(dev) -> float:
    """The plain version's elementwise operations per cell and iteration
    (``_count_ops``; the five 10^x, the log10 and the table gathers not
    counted), from two runs of 1,024 equal cells whose iteration counts
    differ."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    tabs = pc.build_tables(device=dev)
    nH = torch.ones(1024, dtype=torch.float32, device=dev)
    T2 = torch.full_like(nH, 1e6)
    got = []
    for dt in (3e13, 3e14):
        _, it = pc.solve_cooling_ref(tabs, nH, T2, 0.0, 1.0, dt,
                                     want_iters=True)
        got.append((int(it.max()), _count_ops(
            lambda: pc.solve_cooling_ref(tabs, nH, T2, 0.0, 1.0, dt))))
    (i1, n1), (i2, n2) = got
    return (n2 - n1) / ((i2 - i1) * 1024)


def _random_cooling_cells(n: int, seed: int = 3):
    """Random cells of the cooling tables' whole range (nH 1e-6..1e4, T2
    10..3e8, metallicity 0..1, the self-shielding boost), as numpy f64 (the
    card tests' cells)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nH, T2 = 10 ** rng.uniform(-6, 4, n), 10 ** rng.uniform(1, 8.5, n)
    z = rng.uniform(0, 1, n)
    return [nH, T2, z, np.maximum(np.exp(-nH / 0.01), 1e-20)]


def _k6_f32_spread(dev) -> str:
    """The plain version in f32 against f64 on 20,000 random cells (z = 0
    and the UV tables of z = 3): the cells past 2e-5 and the worst, why K6
    in f32 is held per cell to the plain f32 version and not to f64."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    n = 20000
    cells = _random_cooling_cells(n)
    out = []
    for aexp, j21 in ((1.0, 0.0), (0.25, 1.0)):
        tabs = pc.build_tables(aexp=aexp, J21=j21, device=dev)
        res = [pc.solve_cooling_ref(
            tabs, *[torch.tensor(a, dtype=dt, device=dev) for a in cells],
            torch.tensor(3e15, dtype=dt, device=dev)).double()
            for dt in (torch.float32, torch.float64)]
        rel = (res[0] - res[1]).abs() / res[1].abs()
        out.append(f"{'UV at z=3' if j21 else 'z=0'} {int((rel > 2e-5).sum())} "
                   f"of {n} past 2e-5, the worst {float(rel.max()):.3e}")
    return "; ".join(out)


def _conditioning_move(tabs, args, want, cells, ks, ulp: float):
    """Each of ``cells``' largest relative move of the plain version's
    result ``want`` when nH, T2 or dt alone is scaled by ``1 + k·ulp`` for
    each k of ``ks``: every such copy of the cells in one batched call
    (the plain version is elementwise, so a cell's result does not depend
    on its batch)."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    nH = args[0].reshape(-1)
    m = int(cells.numel())

    def rows(v):
        v = torch.as_tensor(v, dtype=nH.dtype, device=nH.device).reshape(-1)
        return v[cells] if v.numel() == nH.numel() else v.expand(m)
    sub = [rows(v) for v in args]
    batch = [[], [], [], [], []]
    for i in (0, 1, 4):
        for k in ks:
            for j in range(5):
                batch[j].append(sub[j] * (1 + k * ulp) if j == i else sub[j])
    got = pc.solve_cooling_ref(tabs, *[torch.cat(b) for b in batch])
    w = want.reshape(-1)[cells]
    return (got.reshape(-1, m) - w).abs().amax(0) / w.abs()


def _k6_bound(rec, iters, ops_per_iter: float) -> dict:
    """K6's least time on these inputs: the bytes of what varies per cell
    (nH, T2 and the result; zsolar or boost where they are per cell, not
    numbers at stride 0) and the tables, once each, over HBM's rate, and
    the operations at this run's iteration counts (``iters`` summed) over
    the unfused f32 rate; the larger binds."""
    import torch
    tabs, nH, T2, zs, bs, _ = rec
    n, size = nH.numel(), nH.element_size()
    per_cell = 3 + sum(1 for v in (zs, bs)
                       if torch.is_tensor(v) and v.numel() == n)
    tables = sum(t.numel() * t.element_size()
                 for t in tabs.packed(nH.dtype))
    nbytes = size * per_cell * n + tables
    nops = ops_per_iter * float(iters.double().sum())
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F32_UNFUSED_OPS_PER_S
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms, nbytes=nbytes, nops=nops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _k6_check(rec, what: str, ops_per_iter: float, time_it: bool = False,
              plain_reps: int = 3):
    """K6 on one recorded call's inputs (``_record_k6``) against its plain
    version on the card.  f32, per cell: within rel 2e-5 of the plain f32
    result or, where the plain f32 result itself moves when nH, T2 or dt
    change by 1 to 4 ulps, within ten times that move, with at most
    ``K6_F32_CONDITIONED`` of the cells in the second form; and against the
    plain f64 result at each quantile of the cells' error (median to max)
    within twice the plain f32 version's plus 1e-6 (the f32 march departs
    from the f64 one: :func:`_k6_f32_spread`).  f64: the same inputs in f64
    through both, each cell within ``K6_F64_REL`` or, where the plain
    version's own result moves when nH, T2 or dt change by 1 to 64 ulps,
    ten times that move.  Returns a dict of the readings (and, with
    ``time_it``, the kernel's device ms, the plain version's ms and the
    bound)."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    tabs, nH, T2, zs, bs, dts = rec
    n = nH.numel()
    got, it_k = pc.solve_cooling(tabs, nH, T2, zs, bs, dts, want_iters=True)
    plain, it_p = pc.solve_cooling_ref(tabs, nH, T2, zs, bs, dts,
                                       want_iters=True)
    d64 = [x.double() if torch.is_tensor(x) else x
           for x in (nH, T2, zs, bs, dts)]
    exact = pc.solve_cooling_ref(tabs, *d64)
    torch.cuda.synchronize()
    q = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64,
                     device=nH.device)

    def quant(x):
        rel = ((x.double() - exact).abs() / exact.abs()).reshape(-1)
        if rel.numel() > 1 << 24:            # torch.quantile's input cap
            rel = rel[torch.randperm(rel.numel(), device=rel.device)
                      [:1 << 24]]
        return torch.quantile(rel, q)
    ek, ep = quant(got), quant(plain)
    if not bool((ek <= 2 * ep + 1e-6).all()):
        raise AssertionError(f"{what}: K6 in f32 less accurate than its "
                             f"plain version: error quantiles against f64 "
                             f"{ek.tolist()} against {ep.tolist()}")
    # f32: every cell against the plain f32 result
    rel32 = ((got - plain).abs() / plain.abs()).reshape(-1)
    bad32 = torch.nonzero(rel32 > RTOL).reshape(-1)
    nbad32, move32 = int(bad32.numel()), 0.0
    if nbad32:
        mv = _conditioning_move(tabs, (nH, T2, zs, bs, dts), plain, bad32,
                                (1, -1, 2, -2, 4, -4), 2.0 ** -23)
        over = rel32[bad32] > torch.clamp(10 * mv, min=RTOL)
        move32 = float(mv.max())
        if bool(over.any()) or nbad32 > K6_F32_CONDITIONED * n:
            j = int(torch.nonzero(over)[0]) if bool(over.any()) else 0
            c = int(bad32[j])
            raise AssertionError(
                f"{what}: K6 in f32 disagrees with its plain f32 version: "
                f"{nbad32} of {n} cells past {RTOL:g} (at most "
                f"{K6_F32_CONDITIONED:g} of them may be); cell {c} rel "
                f"{float(rel32[c]):.3e}, its conditioning move "
                f"{float(mv[j]):.3e}, iterations {int(it_k.reshape(-1)[c])}"
                f" kernel, {int(it_p.reshape(-1)[c])} plain")
    w = int(torch.argmax(rel32))
    worst = (f"worst cell against plain f32: rel {float(rel32[w]):.3e} "
             f"(iterations {int(it_k.reshape(-1)[w])} kernel, "
             f"{int(it_p.reshape(-1)[w])} plain), {nbad32} of {n} cells "
             f"past {RTOL:g}, each within ten times its conditioning move "
             f"(the largest {move32:.3e})")
    # f64: every cell, the conditioned ones probed where they fail
    k64 = pc.solve_cooling(tabs, *d64)
    rel64 = ((k64 - exact).abs() / exact.abs()).reshape(-1)
    bad = torch.nonzero(rel64 > K6_F64_REL).reshape(-1)
    nbad = int(bad.numel())
    if nbad:
        move = _conditioning_move(tabs, d64, exact, bad,
                                  (1, -2, 4, -8, 16, -64), 1.1e-16)
        over = rel64[bad] > torch.clamp(10 * move, min=K6_F64_REL)
        if bool(over.any()):
            j = int(torch.nonzero(over)[0])
            raise AssertionError(
                f"{what}: K6 in f64 disagrees with its plain version: cell "
                f"{int(bad[j])} rel {float(rel64[bad[j]]):.3e}, its "
                f"conditioning move {float(move[j]):.3e}")
    out = dict(n=n, iters_mean=float(it_k.double().mean()),
               iters_max=int(it_k.max()), max_abs_err=float(
                   (got - plain).abs().max()), rel64=float(rel64.max()),
               conditioned=nbad, q_kernel=ek.tolist(), q_plain=ep.tolist(),
               worst=worst)
    if time_it:
        out["ms"] = _device_ms(
            lambda: pc.solve_cooling(tabs, nH, T2, zs, bs, dts),
            "cooling_kernel", n=20, launched=lambda: pc.launches)
        out["plain_ms"] = _median_ms(
            lambda: pc.solve_cooling_ref(tabs, nH, T2, zs, bs, dts),
            reps=plain_reps, warm=1)
        out.update(_k6_bound(rec, it_k, ops_per_iter))
    del got, plain, exact, k64
    torch.cuda.empty_cache()
    return out


def _k6_timing(r: dict, ops_per_iter: float) -> str:
    return (f"{r['ms']:.4f} ms/launch, plain version {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} (bytes "
            f"{r['bytes_ms']:.4f} ms for {r['nbytes'] / 1e9:.4f} GB; "
            f"operations {r['ops_ms']:.4f} ms for {r['nops'] / 1e9:.4f} G "
            f"at {ops_per_iter:.1f} a cell and iteration, unfused f32 at "
            f"{F32_UNFUSED_OPS_PER_S:.3g}/s), "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound")


def _k6_march(dev, ops_per_iter: float) -> dict:
    """K6 where the march is long: ``K6_MARCH_CELLS`` random cells
    (:func:`_random_cooling_cells`, z = 0 tables) over dt 3e15 s in f32,
    checked as the main paths' calls are, and timed."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    tabs = pc.build_tables(device=dev)
    cells = [torch.tensor(a, dtype=torch.float32, device=dev)
             for a in _random_cooling_cells(K6_MARCH_CELLS)]
    rec = (tabs, *cells, torch.tensor(3e15, dtype=torch.float32,
                                      device=dev))
    return _k6_check(rec, "phase 50 random cells", ops_per_iter,
                     time_it=True, plain_reps=1)


def _k6_line(r: dict) -> str:
    return (f"{r['n']} cells, iterations mean {r['iters_mean']:.3f} max "
            f"{r['iters_max']}; f32 error quantiles against plain f64 "
            f"{[f'{x:.2e}' for x in r['q_kernel']]} (plain f32 "
            f"{[f'{x:.2e}' for x in r['q_plain']]}); {r['worst']}; f64 "
            f"max rel {r['rel64']:.3e} ({r['conditioned']} cells past "
            f"{K6_F64_REL:g}, each within ten times its conditioning move)")


def _k6_step_ops(rec) -> int:
    """The plain version's operations of cooling_step's conversions on a
    recorded state (everything but the march), as ``_count_ops`` counts
    them."""
    from ramses_tpu_torch.hydro import cooling as pc
    tabs, u, spec, dt, cfg, scales = rec

    def conversions():
        p = pc.cooling_inputs(u, spec, dt, cfg, scales=scales)
        eint = pc.cooling_energy(p["T2"], p, spec, cfg, scales)
        return eint + p["ekin"] + p["eother"]
    return _count_ops(conversions, ("exp",))


def _k6_step_check(rec, what: str, ops_per_iter: float,
                   time_it: bool = False, plain_reps: int = 3) -> dict:
    """K6's fused entry on one recorded call's state (:func:`_record_k6`)
    against its plain version (``cooling_step_ref``) on the card, in the
    state's type and again with the state in f64: the E row per cell,
    |ΔE| over the plain new thermal energy, within K6's gates (f32 rel
    2e-5, f64 rel 1e-10), or within ten times the march's conditioning
    move at the cell (:func:`_conditioning_move` on the march's inputs)
    plus two ulps of E (the last add's rounding), with at most
    ``K6_F32_CONDITIONED`` of the f32 cells in that second form; every
    other row untouched; one launch of the fused entry a call.  Then K6's
    march on that state's march inputs (:func:`_k6_check`).  With
    ``time_it``, the fused entry's device ms, the plain version's, the
    torch passes around the march entry (the route before the fused
    entry), and the bound.  Returns the readings, the march's under
    "march"."""
    import torch
    from ramses_tpu_torch.hydro import cooling as pc
    tabs, u, spec, dt, cfg, scales = rec
    e = cfg.ndim + 1
    n = u[0].numel()
    keep = [k for k in range(u.shape[0]) if k != e]
    out = {}
    for dtype in dict.fromkeys((u.dtype, torch.float64)):
        def cast(x):
            return x.to(dtype) if torch.is_tensor(x) else x
        uu, dd, ss = cast(u), cast(dt), cast(scales)
        if not pc.fused_supports(spec):
            raise AssertionError(f"{what}: K6's fused entry does not take "
                                 f"the recorded configuration")
        n0 = pc.step_launches
        got = pc.cooling_step(uu, tabs, spec, dd, cfg, scales=ss)
        want = pc.cooling_step_ref(uu, tabs, spec, dd, cfg, scales=ss)
        if pc.step_launches != n0 + 1 or not torch.equal(got[keep],
                                                          uu[keep]):
            raise AssertionError(f"{what}: K6's fused entry launched "
                                 f"{pc.step_launches - n0} times or wrote "
                                 f"past the E row")
        p = pc.cooling_inputs(uu, spec, dd, cfg, scales=ss)
        args = (p["nH"], p["T2"], p["zsolar"], p["boost"], p["dt_s"])
        T2n = pc.solve_cooling_ref(tabs, *args)
        eint = pc.cooling_energy(T2n, p, spec, cfg, ss)
        err = (got[e] - want[e]).abs().reshape(-1)
        rel = err / eint.abs().reshape(-1)
        f64 = dtype == torch.float64
        tol = K6_F64_REL if f64 else RTOL
        bad = torch.nonzero(rel > tol).reshape(-1)
        nbad = int(bad.numel())
        if nbad:
            ks, ulp = (((1, -2, 4, -8, 16, -64), 1.1e-16) if f64
                       else ((1, -1, 2, -2, 4, -4), 2.0 ** -23))
            mv = _conditioning_move(tabs, args, T2n, bad, ks, ulp)
            slack = (2 * torch.finfo(dtype).eps * want[e].abs().reshape(-1)
                     / eint.abs().reshape(-1))[bad]
            over = rel[bad] > torch.clamp(10 * mv, min=tol) + slack
            if bool(over.any()) or (not f64
                                    and nbad > K6_F32_CONDITIONED * n):
                c = int(bad[int(torch.argmax(rel[bad]))])
                raise AssertionError(
                    f"{what}: K6's fused entry in {dtype} disagrees with "
                    f"cooling_step: {nbad} of {n} cells past {tol:g}; cell "
                    f"{c} rel {float(rel[c]):.3e}")
        out[str(dtype).split(".")[-1]] = dict(
            rel=float(rel.max()), past=nbad, max_abs_err=float(err.max()),
            equal=int((got[e] == want[e]).sum()))
        del got, want, p, args, T2n, eint
    march_rec = (tabs, *(pc.cooling_inputs(u, spec, dt, cfg,
                                           scales=scales)[k]
                         for k in ("nH", "T2", "zsolar", "boost", "dt_s")))
    march = _k6_check(march_rec, f"{what} march", ops_per_iter,
                      time_it=time_it, plain_reps=plain_reps)
    r = dict(n=n, march=march, max_abs_err=max(
        march["max_abs_err"], out[str(u.dtype).split(".")[-1]]["max_abs_err"]),
        **{f"fused_{k}": v for k, v in out.items()})
    if time_it:
        # the entry alone: its E row into a copy of the state, which the
        # wrapper (not in place) would make on every call
        out = u.clone()
        lib = pc._library()
        stream = torch.cuda.current_stream().cuda_stream
        r["ms"] = _device_ms(
            lambda: pc.call_step(lib, u, out, tabs, spec, dt, cfg, scales,
                                 stream),
            "ramses_cooling::step_kernel", n=20)
        del out
        r["plain_ms"] = _median_ms(
            lambda: pc.cooling_step_ref(u, tabs, spec, dt, cfg,
                                        scales=scales),
            reps=plain_reps, warm=1)
        def torch_route():
            # the pass as torch passes around the march entry (the route
            # before the fused entry)
            p = pc.cooling_inputs(u, spec, dt, cfg, scales=scales)
            T2n = pc.solve_cooling(tabs, p["nH"], p["T2"], p["zsolar"],
                                   p["boost"], p["dt_s"])
            o = u.clone()
            o[cfg.ndim + 1] = (pc.cooling_energy(T2n, p, spec, cfg, scales)
                               + p["ekin"] + p["eother"])
            return o
        r["torch_route_ms"] = _median_ms(torch_route, reps=10)
        size = u.element_size()
        tables = sum(t.numel() * t.element_size()
                     for t in tabs.packed(u.dtype))
        nbytes = size * n * (cfg.ndim + 3 + cfg.nener) + tables
        nops = (ops_per_iter * march["iters_mean"] * n + _k6_step_ops(rec))
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nops / F32_UNFUSED_OPS_PER_S
        r.update(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                 ops_ms=ops_ms, nbytes=nbytes, nops=nops,
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    torch.cuda.empty_cache()
    return r


def _k6_step_timing(r: dict, ops_per_iter: float) -> str:
    return (f"{r['ms']:.4f} ms/launch, plain version (cooling_step_ref) "
            f"{r['plain_ms']:.4f} ms, the torch passes around the march "
            f"entry {r['torch_route_ms']:.4f} ms (a synchronised call), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} (bytes "
            f"{r['bytes_ms']:.4f} ms for {r['nbytes'] / 1e9:.4f} GB: the "
            f"state's rows in, E out, the tables; operations "
            f"{r['ops_ms']:.4f} ms for {r['nops'] / 1e9:.4f} G: the march at "
            f"{ops_per_iter:.1f} a cell and iteration and the conversions, "
            f"unfused f32 at {F32_UNFUSED_OPS_PER_S:.3g}/s), "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound")


def _k6_step_line(r: dict) -> str:
    fused = "; ".join(
        f"{k[6:]}: E rel max {v['rel']:.3e}, {v['past']} cells past the "
        f"gate's first form, {v['equal']} of {r['n']} bitwise"
        for k, v in r.items() if k.startswith("fused_"))
    return (f"fused entry against cooling_step_ref ({fused}); the march on "
            f"the state's march inputs: {_k6_line(r['march'])}")


def _cooling_phases(dev, card: str) -> dict:
    """Phases 50-54; returns the K6 row and the main paths' launches."""
    import shutil
    import tempfile
    ops = _k6_ops_per_iter(dev)
    row, l50 = _cool_uniform_phase(dev, card, ops)
    march = _k6_march(dev, ops)
    _print(f"phase 50 K6 where the march is long, on {card}: "
           f"{K6_MARCH_CELLS} random cells (z = 0 tables, dt 3e15 s, f32): "
           f"{_k6_timing(march, ops)}; {_k6_line(march)}")
    l51, e51 = _sf_amr_phase(dev, card, ops)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sf_")
    try:
        _feedback_stellar_phase(card, tmp)
        _sf_uniform_phase(card, tmp)
        l54, e54 = _cosmo_gal_phase(card, tmp, ops)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {k: l50.get(k, 0) + l51.get(k, 0) + l54.get(k, 0)
           for k in ("fused_muscl", "tile_sweep", "cooling", "cooling_step")}
    # K6's two entries: the march and the fused pass the main paths take
    row["launches"] = out["cooling"] + out["cooling_step"]
    row["max_abs_err"] = max(row["max_abs_err"], e51, e54)
    return dict(out, row=row)


def _hot_energy(sim, t2_hot: float = 1e4) -> float:
    """The thermal energy of a uniform state's cells hotter than ``t2_hot``
    in T2 (K): the blast's, without the cold ambient that cooling_step
    raises to T2_MIN (``ramses_tpu/hydro/cooling.py:665``)."""
    import torch
    u = sim.state.u.double()
    ekin = 0.5 * (u[1:4] ** 2).sum(0) / u[0]
    eint = u[4] - ekin
    t2 = (sim.cfg.gamma - 1.0) * eint / u[0] * sim.units.scale_T2
    return float(torch.sum(torch.where(t2 > t2_hot, eint, 0.0))) \
        * sim.dx ** 3


def _cool_uniform_phase(dev, card: str, ops_per_iter: float):
    """Phase 50: config 1 (sedov3d at 256³, f32) with ``&COOLING_PARAMS
    cooling`` and the ISM units, 20 steps through ``Simulation``."""
    import re

    import torch
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.driver import Simulation
    from ramses_tpu_torch.grid.uniform import cfl_dt, run_steps_cool
    text = open(NML).read()
    text = re.sub(r"levelmin=\d+", f"levelmin={COOL_LEVEL}", text)
    text = re.sub(r"levelmax=\d+", f"levelmax={COOL_LEVEL}", text)
    text = re.sub(r"nstepmax=\d+", f"nstepmax={COOL_STEPS}", text)
    text = text.replace("tout=1.0", "tout=100.0") + "\n&UNITS_PARAMS\n" \
        + "\n".join(f"{k}={v}" for k, v in ISM_UNITS.items()) + "\n/\n"
    cool = text + "&COOLING_PARAMS\ncooling=.true.\n/\n"

    def run(t, store=None):
        s = Simulation(params_from_string(t, ndim=3))
        torch.cuda.synchronize()
        _reset_counts()
        rec = _record_k6(store) if store is not None else None
        t0 = time.perf_counter()
        try:
            s.evolve()
            torch.cuda.synchronize()
        finally:
            if rec is not None:
                rec()
        return s, time.perf_counter() - t0, _counts()
    store = {}
    a, _, launches = run(cool, store)
    b, wall_b, _ = run(cool)
    same = torch.equal(a.state.u, b.state.u)
    del b
    c, wall_c, _ = run(text)
    # the adiabatic run to the cooled run's end time
    d, _, _ = run(re.sub(r"nstepmax=\d+", "nstepmax=1000", text).replace(
        "tout=100.0", f"tout={a.t!r}"))
    e_cool, e_adia = _hot_energy(a), _hot_energy(d)
    tot = (float(a.totals()["energy"]), float(d.totals()["energy"]))
    finite = bool(torch.isfinite(a.state.u).all())
    del c, d
    # the step loop waits on nothing: two steps under the sync debug mode
    f64 = dict(dtype=torch.float64, device=dev)
    t0, tend = torch.tensor(a.t, **f64), torch.tensor(1e30, **f64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_steps_cool(a.grid, a.state.u, t0, tend, 2, a.cool_tables,
                       a.cool_spec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (a.nstep == COOL_STEPS and launches == _want(
            fused_muscl=COOL_STEPS, cooling_step=COOL_STEPS) and finite
            and same and e_cool < e_adia):
        raise AssertionError(
            f"phase 50 sedov3d with cooling at 256³: {a.nstep} steps, "
            f"launches {launches}, finite {finite}, replay bitwise {same}, "
            f"thermal energy above 1e4 K {e_cool} against the adiabatic "
            f"run's {e_adia} (total energies {tot})")
    r = _k6_step_check(store["last"], "phase 50", ops_per_iter,
                       time_it=True)
    # the cooled step's other passes beside K1 and K6: the Courant dt of
    # the cooled state (torch) and the active mask's select
    u = a.state.u
    courant_ms = _median_ms(lambda: cfl_dt(a.grid, u), reps=10)
    where_ms = _median_ms(lambda: torch.where(t0 < tend, u, u), reps=10)
    spread = _k6_f32_spread(dev)
    _print(f"phase 50 config 1 with cooling on {card}: sedov3d "
           f"{a.grid.shape} f32, ISM units, {COOL_STEPS} steps through "
           f"Simulation (run_steps_cool: K1, then cooling_step through "
           f"K6's fused entry): "
           f"launches {launches}; no host sync in 2 steps under sync debug "
           f"'error'; a replay bitwise; thermal energy of the gas above "
           f"1e4 K {e_cool:.9e} against {e_adia:.9e} in the adiabatic run "
           f"to the same time (total energy {tot[0]:.9e} against "
           f"{tot[1]:.9e}: the T2_MIN clip heats the 1e-3 K ambient); "
           f"{1e3 * wall_b / COOL_STEPS:.4f} ms a step with cooling "
           f"(the replay), {1e3 * wall_c / COOL_STEPS:.4f} ms without "
           f"(run_steps on K1 with its Courant min); in the cooled step, "
           f"the Courant pass on the cooled state (cfl_dt, torch) "
           f"{courant_ms:.4f} ms and the active mask's where {where_ms:.4f} "
           f"ms (synchronised calls); K6's fused entry on the "
           f"last step's recorded state: {_k6_step_timing(r, ops_per_iter)}; "
           f"its march entry on that state's march inputs: "
           f"{_k6_timing(r['march'], ops_per_iter)}; "
           f"{_k6_step_line(r)}; the plain version in f32 against f64 "
           f"on random cells (dt 3e15 s): {spread}; library call: none")
    row = {"name": "cooling", "route": "cuda",
           "source": "ramses_tpu_torch/csrc/cooling.cu",
           "replaces": "ramses_tpu/hydro/cooling.py:373 (solve_cooling's "
                       "lax.while_loop, and cooling_step's conversions; no "
                       "pallas_call)",
           "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": None}
    del a
    torch.cuda.empty_cache()
    return row, launches


def _sf_amr_phase(dev, card: str, ops_per_iter: float) -> dict:
    """Phase 51: config 2's levels (7 / 9, f32) on the JAX test's SF blob
    with cooling, self-gravity, star formation and thermal feedback,
    ``SF_AMR_STEPS`` coarse steps; returns the launches."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import hierarchy as H
    from ramses_tpu_torch.pm import amr_physics as ap
    from ramses_tpu_torch.pm.star_formation import (FLAG_SN_DONE,
                                                    mstar_quantum)
    lmin, lmax = SF_AMR_LEVELS
    p = _sf_blob(lmin, lmax, d_in=50.0, p_in=0.5, tend=1.0,
                 run_params={"poisson": True},
                 amr_params={"npartmax": 400000},
                 refine_params={"err_grad_d": 0.2},
                 cooling_params={"cooling": True},
                 sf_params={"n_star": 1.0, "t_star": 0.1, "m_star": 1.0},
                 feedback_params={"eta_sn": 0.1, "t_sne": 0.001})
    stepped, recorded, k6rec = [], {}, {}
    step_coarse = H.AmrSim.step_coarse

    def counted(self, dt):
        spec = self._fused_spec()
        stepped.append((spec.levels, spec.complete, spec.blocked))
        last = len(stepped) == SF_AMR_STEPS
        rec = _record_kernel_inputs(recorded) if last else None
        rec6 = (_record_k6(k6rec, _substep_order(spec.levels)) if last
                else None)
        try:
            step_coarse(self, dt)
        finally:
            if rec is not None:
                rec()
                rec6()
    sim = H.AmrSim(p)
    m0 = float(sim.totals()["mass"])
    acc, restore = _timed_parts({
        "regrid": (H.AmrSim, "regrid"),
        "solve": (H.AmrSim, "solve_gravity"),
        "sweep with cooling": (H, "_coarse_step"),
        "cooling": (H, "cooling_step"),
        "SF": (ap, "star_formation_amr"),
        "feedback": (ap, "thermal_feedback_amr"),
        "Courant fetch": (H.AmrSim, "coarse_dt")})
    H.AmrSim.step_coarse = counted
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        sim.evolve(1.0, nstepmax=SF_AMR_STEPS)
        torch.cuda.synchronize()
    finally:
        H.AmrSim.step_coarse = step_coarse
        restore()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = _cosmo_want(stepped, lmin)
    want["cooling_step"] = sum(2 ** (l - lmin) for levels, _, _ in stepped
                               for l in levels)
    f = {k: v.cpu().numpy() for k, v in (("m", sim.p.m), ("x", sim.p.x),
                                          ("act", sim.p.active),
                                          ("flags", sim.p.flags),
                                          ("fam", sim.p.family))}
    stars = f["act"] & (f["fam"] == 2)
    m_star = float(f["m"][stars].astype(np.float64).sum())
    m1 = float(sim.totals()["mass"])
    lv = ap._levels_of(sim, f["x"][stars].astype(np.float64))
    mq = np.float32(mstar_quantum(sim.sf_spec, sim.units, sim.dx(lmax), 3))
    fired = stars & ((f["flags"] & FLAG_SN_DONE) != 0)
    # each SN fired once: a fired star holds (1 - eta_sn) of the quantum,
    # an unfired one the quantum
    once = (np.allclose(f["m"][fired], np.float32(0.9) * mq, rtol=1e-6)
            and np.allclose(f["m"][stars & ~fired], mq, rtol=1e-6))
    finite = all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())
    ok = (launches == want and abs(m1 + m_star - m0) <= 1e-5 * m0
          and stars.sum() > 0 and (lv > lmin).any() and fired.any()
          and once and finite)
    if not ok:
        raise AssertionError(
            f"phase 51 SF blob at {lmin}/{lmax}: launches {launches} "
            f"(expected {want}), gas+stars {m1 + m_star} against {m0}, "
            f"{int(stars.sum())} stars, levels {np.bincount(lv)}, SNe "
            f"{int(fired.sum())}, once {once}, finite {finite}")
    nst = len(stepped)
    _print(f"phase 51 config 2 with cooling, gravity, SF and thermal "
           f"feedback on {card}: the JAX test's SF blob at "
           f"levelmin {lmin} levelmax {lmax} f32, {nst} coarse steps in "
           f"{wall:.3f} s, octs {[sim.tree.noct(l) for l in sim.levels()]};"
           f" launches {launches} (expected {want}); {int(stars.sum())} "
           f"stars, by level {dict(zip(*np.unique(lv, return_counts=True)))}"
           f", {int(fired.sum())} SNe fired once each; gas + stars "
           f"{m1 + m_star:.9e} against {m0:.9e}; s a coarse step by part "
           f"(synchronised; the sweep holds the cooling): "
           + ", ".join(f"{k} {v / nst:.4f}" for k, v in acc.items())
           + f", other {(wall - sum(acc.values())) / nst:.4f}")
    # M any field's: the SN-heated gas's pressure dwarfs its momenta, whose
    # updates are differences of pressure fluxes (as in phases 47 and 49)
    line = _last_step_check(sim, recorded, stepped[-1], "phase 51",
                            any_field=True)
    finest = max(k6rec)
    k6 = {l: _k6_step_check(r, f"phase 51 level {l}", ops_per_iter,
                            time_it=l == finest)
          for l, r in sorted(k6rec.items())}
    stats = {}
    prof = _profile(lambda: (sim.regrid(), sim.step_coarse(
        sim.coarse_dt())), os.path.join(ROOT, "chiprun_out"), name=None,
        warm=False, stats=stats, raw=True)
    _print(f"phase 51 K1 and K3 on the last coarse step's inputs against "
           f"their plain versions within LOCAL_ATOL + LOCAL_RTOL·M, M any "
           f"field's stencil max: {line}; "
           f"K6 on each level's last-step rows (u[l].T as the hierarchy "
           f"hands them over): "
           + "; ".join(f"level {l}: {_k6_step_line(r)}"
                       for l, r in k6.items())
           + f"; K6's fused entry timed on level {finest}'s rows: "
           f"{_k6_step_timing(k6[finest], ops_per_iter)}; its march entry "
           f"on their march inputs: "
           f"{_k6_timing(k6[finest]['march'], ops_per_iter)}"
           + f"; one more coarse step under the profiler: {prof}")
    del sim
    torch.cuda.empty_cache()
    return launches, max(r["max_abs_err"] for r in k6.values())


def _feedback_stellar_phase(card: str, tmp: str):
    """Phase 52: kinetic feedback on the SF blob at 6 / 7 (its mass and
    energy budget at every pass), then the JAX stellar test's set-up at 6
    / 7 (sinks, stellar objects that spawn and explode, the CSV)."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.pm import amr_physics as ap
    from ramses_tpu_torch.pm.star_formation import (M_SUN, host_particles,
                                                    sn_due_mask)
    lmin, lmax = FB_LEVELS
    p = _sf_blob(lmin, lmax, d_in=50.0, p_in=0.5, tend=1.0,
                 amr_params={"npartmax": 200000},
                 refine_params={"err_grad_d": 0.2},
                 sf_params={"n_star": 1.0, "t_star": 0.1, "m_star": 1.0},
                 feedback_params={"eta_sn": 0.1, "t_sne": 0.001,
                                  "f_w": 1.0})
    sim = AmrSim(p)
    budgets = []
    kin = ap.kinetic_feedback_amr

    def checked(s):
        f = host_particles(s.p)
        due = sn_due_mask(f, s.sf_spec, s.units, s.t)
        mej = s.sf_spec.eta_sn * f["m"][due].astype(np.float64)
        v2 = (f["v"][due].astype(np.float64) ** 2).sum(1)
        esn = (1e51 / (10.0 * M_SUN)) / s.units.scale_v ** 2
        t0 = s.totals()
        kin(s)
        t1 = s.totals()
        budgets.append((len(mej), t1["mass"] - t0["mass"], mej.sum(),
                        t1["energy"] - t0["energy"],
                        (mej * esn + 0.5 * mej * v2).sum(), t0["energy"],
                        t0["mass"]))
    ap.kinetic_feedback_amr = checked
    t0 = time.perf_counter()
    try:
        sim.evolve(1.0, nstepmax=FB_STEPS)
        torch.cuda.synchronize()
    finally:
        ap.kinetic_feedback_amr = kin
    wall = time.perf_counter() - t0
    nsn = sum(b[0] for b in budgets)
    # the rows are f32: a total moves by its own rounding, ~1e-7 of it
    bad = [b for b in budgets if b[0] and not (
        abs(b[1] - b[2]) <= 1e-4 * b[2] + 1e-6 * b[6]
        and abs(b[3] - b[4]) <= 1e-4 * b[4] + 1e-6 * abs(b[5]))]
    if not (len(budgets) == FB_STEPS and nsn > 0 and not bad):
        raise AssertionError(f"phase 52 kinetic feedback: {nsn} SNe, "
                             f"budgets (n, dm, mej, dE, expected, E, M) "
                             f"{bad}")
    kin_line = (f"kinetic feedback (f_w=1) on the SF blob at {lmin}/{lmax}, "
                f"{FB_STEPS} coarse steps in {wall:.3f} s: {nsn} SNe; every "
                f"pass's leaf gas mass and energy changed by the ejecta and "
                f"E_SN + their kinetic energy within 1e-4 (and 1e-6 of the "
                f"totals) (passes: "
                + "; ".join(f"{b[0]} SNe dm {b[1]:.6e}/{b[2]:.6e} dE "
                            f"{b[3]:.6e}/{b[4]:.6e}" for b in budgets if b[0])
                + ")")
    del sim
    p = _sf_blob(lmin, lmax, d_in=100.0, p_in=1.0, tend=1.0,
                 refine_params={"err_grad_d": 0.2},
                 sink_params={"create_sinks": True, "n_sink": 10.0,
                              "accretion_scheme": "threshold",
                              "c_acc": 0.2},
                 stellar_params={"stellar_msink_th": 0.002 * STELLAR_SCALE,
                                 "imf_index": -2.35, "imf_low": 8.0,
                                 "imf_high": 120.0, "lt_t0": 1e-6,
                                 "sn_e_ref": 0.02 * STELLAR_SCALE,
                                 "sn_direct": False})
    sim = AmrSim(p)
    e0 = float(sim.totals()["energy"])
    t0 = time.perf_counter()
    sim.evolve(1.0, nstepmax=FB_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spawned = sim.stellar.next_id - 1
    out = sim.dump(1, os.path.join(tmp, "stellar"))
    lines = open(os.path.join(out, "stellar_00001.csv")).read().splitlines()
    ids = [int(ln.split(",")[0]) for ln in lines[2:]]
    e1 = float(sim.totals()["energy"])
    finite = all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())
    if not (spawned > 0 and sim.stellar.n < spawned and finite
            and lines[:2] == [" # id,mstellar,tform,tlife ", " # 1,m,t,t"]
            and ids == [int(i) for i in sim.stellar.idp]):
        raise AssertionError(
            f"phase 52 stellar objects: {spawned} spawned, {sim.stellar.n} "
            f"alive, finite {finite}, CSV head {lines[:3]}, {len(ids)} rows")
    _print(f"phase 52 on {card}: {kin_line}; stellar objects (the JAX "
           f"stellar test's set-up at {lmin}/{lmax}, its quanta x "
           f"{STELLAR_SCALE:g}, lt_t0 1e-6 so that an object explodes the "
           f"step after its birth) {FB_STEPS} coarse steps in {wall:.3f} s:"
           f" {sim.sinks.n} sinks, {spawned} objects spawned, "
           f"{spawned - sim.stellar.n} exploded, {sim.stellar.n} alive; "
           f"energy {e0:.6e} -> {e1:.6e}; stellar_00001.csv parses with the "
           f"reference header, {len(ids)} rows")
    del sim
    torch.cuda.empty_cache()


def _sf_uniform_phase(card: str, tmp: str):
    """Phase 53: the SF blob at 128³ through the uniform ``Simulation``
    with ``pic``, SF and thermal feedback, 5 chunks; then a dump, a
    restore and one more chunk."""
    import torch
    from ramses_tpu_torch.driver import Simulation
    lv = SF_UNIFORM_LEVEL
    nsteps = 16 * SF_UNIFORM_CHUNKS
    p = _sf_blob(lv, lv, d_in=50.0, p_in=0.5, tend=1.0,
                 run_params={"pic": True, "nstepmax": nsteps},
                 amr_params={"npartmax": 200000},
                 sf_params={"n_star": 1.0, "t_star": 0.1, "m_star": 1.0},
                 feedback_params={"eta_sn": 0.1, "t_sne": 0.001},
                 output_params={"noutput": 1, "tout": [100.0]})
    sim = Simulation(p)
    m0 = float(sim.totals()["mass"])
    t0 = time.perf_counter()
    sim.evolve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    act = sim.state.p.active.cpu().numpy()
    m1 = float(sim.totals()["mass"]) + float(
        sim.state.p.m.double().cpu().numpy()[act].sum())
    nstar = sim.n_stars()
    out = sim.dump(900, os.path.join(tmp, "sf_uniform"))
    ids = set(sim.state.p.idp.cpu().numpy()[act].tolist())
    back = Simulation.from_snapshot(p, out)
    next_id = back._next_star_id
    # after the SNe the heated gas cuts the dt a hundredfold: chunks until
    # new stars form (up to four)
    for _ in range(4):
        back.params.run.nstepmax = back.nstep + 16
        back.evolve()
        bact = back.state.p.active.cpu().numpy()
        new = set(back.state.p.idp.cpu().numpy()[bact].tolist()) - ids
        if new:
            break
    restored = set(back.state.p.idp.cpu().numpy()[bact].tolist()) & ids
    if not (sim.nstep == nsteps and nstar > 0 and abs(m1 - m0) <= 1e-5 * m0
            and next_id == max(ids) + 1 and new
            and min(new) > max(ids) and len(restored) == len(ids)):
        raise AssertionError(
            f"phase 53 uniform SF: {sim.nstep} steps, {nstar} stars, gas + "
            f"stars {m1} against {m0}, {len(new)} new ids after the "
            f"restore (min {min(new) if new else None}, restored max "
            f"{max(ids) if ids else None})")
    _print(f"phase 53 uniform SF on {card}: the SF blob at "
           f"{sim.grid.shape} f32 through Simulation with pic, SF and "
           f"thermal feedback, {SF_UNIFORM_CHUNKS} chunks of 16 steps in "
           f"{wall:.3f} s ({1e3 * wall / nsteps:.3f} ms a step with the "
           f"passes): {nstar} stars, gas + stars {m1:.9e} against "
           f"{m0:.9e}; dumped, restored, {back.nstep - sim.nstep} more "
           f"steps: {len(new)} new stars, ids from {min(new)} past the "
           f"restored {max(ids)}")
    del sim, back
    torch.cuda.empty_cache()


def _cosmo_gal_phase(card: str, tmp: str, ops_per_iter: float):
    """Phase 54: ``namelists/cosmo_gal.nml`` as shipped but its ICs (64³,
    written by the port's ``write_zeldovich_ics``) and ``nstepmax``,
    through the CLI in process, K6's fused entry on the last cooling call's
    rows (the epoch's scales a device tensor) against ``cooling_step``;
    returns the launches and K6's largest error."""
    import torch
    from ramses_tpu_torch.amr import hierarchy as H
    from ramses_tpu_torch.hydro import cooling as pc
    from ramses_tpu_torch.pm import amr_physics as ap
    run_dir = os.path.join(tmp, "gal")
    os.makedirs(run_dir)
    pos = _gaussian_ics(os.path.join(run_dir, "grafic_files"),
                        2 ** GAL_LEVEL, COSMO_SIGMA, COSMO_SEED)
    text = open(GAL_NML).read()
    if f"levelmin={GAL_LEVEL}" not in text:
        raise AssertionError(f"cosmo_gal.nml's levelmin is not {GAL_LEVEL}")
    nml = os.path.join(run_dir, "cosmo_gal.nml")
    with open(nml, "w") as f:
        f.write(text.replace("&RUN_PARAMS",
                             f"&RUN_PARAMS\nnstepmax={GAL_STEPS}", 1))
    walls, masses, finite = [], [], []
    step_coarse = H.AmrSim.step_coarse

    def logged(self, dt):
        t0 = time.perf_counter()
        step_coarse(self, dt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        masses.append(float(self.totals()["mass"])
                      + float(torch.sum(self.p.m.double() * self.p.active)))
        finite.append(all(bool(torch.isfinite(self.u[l]).all())
                          for l in self.levels()))
    acc, restore = _timed_parts({
        "regrid": (H.AmrSim, "regrid"),
        "tables (host numpy)": (pc, "tables_from_params"),
        "maps": (H.AmrSim, "_build_pm"),
        "solve": (H.AmrSim, "solve_gravity"),
        "sweep with cooling": (H, "_coarse_step"),
        "cooling": (H, "cooling_step"),
        "SF": (ap, "star_formation_amr"),
        "feedback": (ap, "thermal_feedback_amr")})
    H.AmrSim.step_coarse = logged
    store = {}
    torch.cuda.synchronize()
    _reset_counts()
    rec = _record_k6(store)
    try:
        sim, wall = _cli_in_process([nml, "--ndim", "3"], run_dir)
    finally:
        H.AmrSim.step_coarse = step_coarse
        restore()
        rec()
    launches = _counts()
    m0 = masses[0] if masses else 0.0
    bad = [i for i, ok in enumerate(finite) if not ok]
    ok = (sim.nstep == GAL_STEPS and not bad and sim.cool_tabulations >= 2
          and all(abs(m - m0) <= 1e-5 * m0 for m in masses)
          and launches["cooling_step"] > 0 and launches["cooling"] == 0
          and os.path.isdir(os.path.join(run_dir, "output_00001")))
    if not ok:
        raise AssertionError(
            f"phase 54 cosmo_gal.nml: {sim.nstep} steps, non-finite after "
            f"steps {bad}, tables built {sim.cool_tabulations} times, total "
            f"mass by step {masses}, launches {launches}")
    n = len(walls)
    _print(f"phase 54 cosmo_gal.nml through the CLI on {card} (run_cli in "
           f"process, f32, as shipped but its {2 ** GAL_LEVEL}³ ICs (min "
           f"1+δ {pos:.3f}) and nstepmax={GAL_STEPS}; pressure_fix: the "
           f"general hydro formulation, cooling through K6's fused "
           f"entry): "
           f"{sim.cosmo_line()}, "
           f"{sim.n_stars()} stars, in {wall:.3f} s; tables built "
           f"{sim.cool_tabulations} times; total mass (gas + particles) "
           f"{masses[0]:.9e} -> {masses[-1]:.9e}; launches {launches}; s a "
           f"coarse step {[round(w, 3) for w in walls]}, by part "
           f"(synchronised): " + ", ".join(f"{k} {v / n:.4f}"
                                           for k, v in acc.items()))
    k6 = _k6_step_check(store["last"], "phase 54", ops_per_iter)
    _print(f"phase 54 K6 on the last cooling call's rows "
           f"{tuple(store['last'][1].shape)} (scales a device tensor): "
           f"{_k6_step_line(k6)}")
    del sim, store
    torch.cuda.empty_cache()
    return launches, k6["max_abs_err"]


# ---------------------------------------------------------------------------
# phase 11's regrid split, phases 55-56: the device migrate (K7) and
# non-cubic roots
# ---------------------------------------------------------------------------

REGRID_STEPS = 10              # phase 55: config 2's coarse steps
K7_RANDOM_OCTS = 262144        # phase 55's random key sets (2D and 3D)
K7_BLOCK = 128                 # octs a K7 block (csrc/regrid_maps.cu)
TWIN_LEVELS, TWIN_ROOT, TWIN_BOXLEN = (6, 8), (2, 2, 2), 0.25
TWIN_STEPS = 10
SLAB_ROOT, SLAB_STEPS = (2, 1, 1), 5   # phase 56b
TWIN_REL = 1e-6                # leaf field within 1e-10 + TWIN_REL·M
PROFILE_TOP = 12
KEY_SWEEP = (1024, 2048, 4096, 8192, 16384, 65536, 262144)   # phase 11


def _host_ms(fn, reps: int = 5) -> float:
    """Median wall ms of a host function (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _paired_ms(fa, fb, reps: int = 11) -> tuple:
    """Median wall ms of two host functions, called in turn (after one
    warm call each), so that both see the same host."""
    fa(), fb()
    ta, tb = [], []
    for _ in range(reps):
        for fn, times in ((fa, ta), (fb, tb)):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ta), statistics.median(tb)


def _top_cumulative(prof, skip: str) -> str:
    """The ``PROFILE_TOP`` functions of a ``cProfile`` by cumulative time
    (the wrapper ``skip`` left out): name, file:line, seconds, calls."""
    import pstats
    st = pstats.Stats(prof).stats
    rows = sorted(((ct, nc, f"{fn} ({os.path.basename(fl)}:{ln})")
                   for (fl, ln, fn), (_, nc, _, ct, _) in st.items()
                   if fn != skip), reverse=True)[:PROFILE_TOP]
    return "; ".join(f"{name} {ct:.4f} s x{nc}" for ct, nc, name in rows)


def _regrid_split(sim) -> str:
    """Phase 11's regrid by function, from ``sim``'s state: one coarse step
    split by part with ``device_regrid`` on and off (each from a sim
    restored on that state), a ``cProfile`` of one regrid under
    ``_flag_and_tree`` and ``_rebuild_maps``, and the key paths at
    262,144 keys and at ``KEY_SWEEP``'s batch sizes through the native
    library and numpy."""
    import cProfile

    import numpy as np
    import torch
    from ramses_tpu_torch import native
    from ramses_tpu_torch.amr import keys as kmod
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.amr.tree import lookup_np
    from ramses_tpu_torch.convert import amr_state_from
    state = amr_state_from(sim)

    def fresh(on: bool):
        p = _amr_params()
        p.amr.device_regrid = on
        return AmrSim.from_state(p, **state)
    walls = {}
    for on in (True, False):
        s = fresh(on)

        def coarse_step(s=s):
            s.regrid()
            s.step_coarse(s.coarse_dt())
        walls[on] = _host_breakdown(s, coarse_step)[0]
        del s
    s = fresh(True)
    profs = {}
    for name in ("_flag_and_tree", "_rebuild_maps"):
        prof = profs[name] = cProfile.Profile()

        def profiled(*a, _fn=getattr(s, name), _prof=prof, **k):
            _prof.enable()
            try:
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                return out
            finally:
                _prof.disable()
        setattr(s, name, profiled)
    s.regrid()
    torch.cuda.synchronize()
    split = "; ".join(f"under {name}: {_top_cumulative(prof, 'profiled')}"
                      for name, prof in profs.items())
    del s
    lev = sim.tree.levels[sim.lmin]
    og, keys = lev.og, lev.keys
    rng = np.random.default_rng(55)
    queries = np.concatenate([keys[rng.permutation(len(keys))[:len(keys) // 2]],
                              rng.integers(0, 2 * int(keys[-1]),
                                           len(keys) - len(keys) // 2)])
    enc = native.morton_encode(og, 3)
    look = native.lookup_sorted(keys, queries)
    if not (np.array_equal(enc, kmod.encode_np(og, 3))
            and np.array_equal(look, lookup_np(keys, queries))):
        raise AssertionError("phase 11: the native key paths differ from "
                             "numpy")
    paths = (f"keys.encode of {len(og)} level-{sim.lmin} octs native "
             f"{_host_ms(lambda: native.morton_encode(og, 3)):.3f} ms, numpy "
             f"{_host_ms(lambda: kmod.encode_np(og, 3)):.3f} ms; "
             f"lookup_keys of {len(queries)} keys (half present) native "
             f"{_host_ms(lambda: native.lookup_sorted(keys, queries)):.3f} "
             f"ms, numpy {_host_ms(lambda: lookup_np(keys, queries)):.3f} ms"
             f" (bitwise equal)")
    # where the native path starts to win (keys.NATIVE_MIN): batches of
    # the level's octs and queries, native and numpy timed in turn
    sweep = []
    for n in KEY_SWEEP:
        o, q = og[:n], queries[rng.permutation(len(queries))[:n]]
        enc_n, enc_p = _paired_ms(lambda: native.morton_encode(o, 3),
                                  lambda: kmod.encode_np(o, 3))
        look_n, look_p = _paired_ms(lambda: native.lookup_sorted(keys, q),
                                    lambda: lookup_np(keys, q))
        sweep.append(f"{n}: encode {enc_n:.4f}/{enc_p:.4f}, lookup "
                     f"{look_n:.4f}/{look_p:.4f}")
    paths += (f"; native/numpy ms by batch size (lookups in the "
              f"{len(keys)} level-{sim.lmin} keys, the switch at "
              f"{kmod.NATIVE_MIN}) " + ", ".join(sweep))
    return (f"one coarse step from phase 11's state with device_regrid on: "
            f"{walls[True]}; off: {walls[False]}; cProfile of one regrid "
            f"(top {PROFILE_TOP} by cumulative time) {split}; {paths}")


def _k7_key_set(ndim: int, lvl: int, n: int, seed: int):
    """A random regrid's sorted key arrays at level ``lvl`` of a cubic
    box: ``n`` new octs among the level's 2^(ndim(lvl-1)) slots, an old
    level that kept 80 % of them and gained a fifth as many others, and a
    coarser level holding every new oct's father and a fifth as many
    others; each padded with sentinels."""
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


def _k7_bytes(n: int, ndim: int) -> int:
    """The least bytes of one K7 call on ``n`` (padded) new octs: the keys
    read once, pos, f_cell and the 2·ndim neighbours (int64) and kept
    (bool) written once."""
    return n * (8 + 8 + 1 + 8 + 16 * ndim)


def _k7_err(got, want) -> float:
    """The largest |got - want| over K7's outputs (the maps as int64)."""
    return max(float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _empty_ms(lib, entry: str, kernel: str, blocks: int) -> float:
    """Device ms of an empty kernel on ``blocks`` blocks as wide as the
    kernel's own (``entry`` of the loaded build ``lib``, its kernel named
    ``kernel``): the latency floor under a kernel's small shapes."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = getattr(lib, entry)(blocks, stream)
        if err:
            raise RuntimeError(f"{entry} failed (cudaError {err})")
    return _device_ms(launch, kernel)


def _regrid_phase(dev, card: str, ptxas: str) -> dict:
    """Phase 55: config 2 with the device migrate against the host maps
    from one initial state, K7 against its plain version on every
    regrid's inputs and on random key sets; returns the K7 row, the
    device run's oct coordinates after each regrid and its final sim.
    ``ptxas``: K7's build report (registers, spills)."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import device_regrid as dr
    from ramses_tpu_torch.amr import maps as mapmod
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.convert import amr_state_from
    p = _amr_params()
    tend = p.output.tout[-1] if p.output.tout else p.output.tend
    state = amr_state_from(AmrSim(p))
    host_maps, k7_fn = mapmod.build_prolong_maps, dr.regrid_maps
    runs = {}
    for on in (True, False):
        p = _amr_params()
        p.amr.device_regrid = on
        sim = AmrSim.from_state(p, **state)
        rec = dict(og=[], keys=[], u=[], changed=0, host_maps=0, k7=[])
        regrid = sim.regrid

        def recorded(sim=sim, rec=rec, regrid=regrid):
            old = {l: (sim.tree.levels[l].keys, sim.u[l].shape[0])
                   for l in sim.levels()}
            regrid()
            rec["changed"] += sum(
                1 for l in sim.levels() if l > sim.lmin and not (
                    l in old and old[l][1] == sim.u[l].shape[0]
                    and np.array_equal(old[l][0], sim.tree.levels[l].keys)))
            rec["og"].append({l: sim.tree.levels[l].og
                              for l in sim.levels()})
            rec["keys"].append({l: sim.tree.levels[l].keys
                                for l in sim.levels()})
            rec["u"].append({l: sim.u[l].clone() for l in sim.levels()})

        def counted(*a, rec=rec, **k):
            rec["host_maps"] += 1
            return host_maps(*a, **k)

        def k7_rec(*a, rec=rec):
            out = k7_fn(*a)
            rec["k7"].append((tuple(x.clone() if torch.is_tensor(x) else x
                                    for x in a),
                              tuple(o.clone() for o in out)))
            return out
        sim.regrid = recorded
        mapmod.build_prolong_maps, dr.regrid_maps = counted, k7_rec
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        try:
            sim.evolve(tend, nstepmax=REGRID_STEPS)
            sim.drain()
        finally:
            mapmod.build_prolong_maps, dr.regrid_maps = host_maps, k7_fn
        rec.update(sim=sim, wall=time.perf_counter() - t0,
                   k7_launches=dr.launches, counts=_counts())
        del sim.regrid
        runs[on] = rec
    a, b = runs[True], runs[False]
    nreg = len(a["u"])
    if not (a["sim"].nstep == b["sim"].nstep == REGRID_STEPS
            and nreg == len(b["u"]) == REGRID_STEPS):
        raise AssertionError(f"phase 55: {a['sim'].nstep} and "
                             f"{b['sim'].nstep} steps, {nreg} and "
                             f"{len(b['u'])} regrids")
    for i in range(nreg):
        ka, kb = a["keys"][i], b["keys"][i]
        same = sorted(ka) == sorted(kb) and all(
            np.array_equal(ka[l], kb[l]) and torch.equal(a["u"][i][l],
                                                           b["u"][i][l])
            for l in ka)
        if not same:
            raise AssertionError(f"phase 55: regrid {i + 1} differs between "
                                 f"device_regrid on and off")
    if not (a["host_maps"] == 0 and b["host_maps"] == b["changed"] > 0
            and a["k7_launches"] == a["changed"] == len(a["k7"])
            and b["k7_launches"] == 0 and a["counts"] == b["counts"]):
        raise AssertionError(
            f"phase 55: build_prolong_maps calls {a['host_maps']} (device) "
            f"{b['host_maps']} (host), changed levels {a['changed']} / "
            f"{b['changed']}, K7 launches {a['k7_launches']} / "
            f"{b['k7_launches']} ({len(a['k7'])} recorded), other launches "
            f"{a['counts']} / {b['counts']}")
    err = 0.0
    for args, got in a["k7"]:
        want = dr.regrid_maps_ref(*args)
        err = max(err, _k7_err(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"phase 55: regrid_maps disagrees with its "
                                 f"plain version on {args[0].numel()} octs "
                                 f"of a regrid")
    del b["u"], a["u"]
    torch.cuda.empty_cache()
    # K7 at the main path's largest regrid level, timed
    args = max(a["k7"], key=lambda r: r[0][0].numel())[0]
    n, nd = args[0].numel(), args[3]
    lib = dr._library()
    ms = _device_ms(lambda: dr.regrid_maps(*args), "regrid_maps_kernel",
                    launched=lambda: dr.launches)
    call_ms = _median_ms(lambda: dr.regrid_maps(*args))
    pms = _median_ms(lambda: dr.regrid_maps_ref(*args), reps=10)
    bound = 1e3 * _k7_bytes(n, nd) / HBM_BYTES_PER_S
    empty = _empty_ms(lib, "ramses_regrid_empty", "regrid_empty_kernel",
                      -(-n // K7_BLOCK))
    branch = ("keys staged whole" if dr.staged(lib, args[1].numel(),
                                                args[2].numel())
              else "keys read through L1")
    # random key sets of 262,144 octs: 2D and 3D, periodic and reflecting
    lines = []
    for nd_, lvl in ((2, 11), (3, 8)):
        new, old, coarse, dims = _k7_key_set(nd_, lvl, K7_RANDOM_OCTS,
                                             60 + nd_)
        kn = dr.upload_keys(new, len(new) + 4096, dev)
        ko = dr.upload_keys(old, len(old) + 16, dev)
        kc = dr.upload_keys(coarse, len(coarse) + 16, dev)
        for kinds in (((0, 0),) * nd_, ((1, 1), (1, 2), (2, 1))[:nd_]):
            call = (kn, ko, kc, nd_, kinds, dims)
            got = dr.regrid_maps(*call)
            want = dr.regrid_maps_ref(*call)
            torch.cuda.synchronize()
            err = max(err, _k7_err(got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"phase 55: regrid_maps disagrees with "
                                     f"its plain version on {len(new)} "
                                     f"random {nd_}D octs, kinds {kinds}")
            kms = _device_ms(lambda: dr.regrid_maps(*call),
                             "regrid_maps_kernel",
                             launched=lambda: dr.launches)
            kpms = _median_ms(lambda: dr.regrid_maps_ref(*call), reps=10)
            kb = 1e3 * _k7_bytes(kn.numel(), nd_) / HBM_BYTES_PER_S
            how = ("staged whole" if dr.staged(lib, ko.numel(), kc.numel())
                   else "read through L1")
            lines.append(f"{nd_}D {'periodic' if kinds[0] == (0, 0) else 'reflecting/outflow'} "
                         f"{kn.numel()} octs ({len(new)} real; "
                         f"{ko.numel()} old, {kc.numel()} coarse keys, "
                         f"{how}): "
                         f"bitwise, {kms:.4f} ms, plain {kpms:.4f} ms, "
                         f"bound {kb:.5f} ms ({100 * kb / kms:.1f} %)")
        blocks = -(-kn.numel() // K7_BLOCK)
        ems = _empty_ms(lib, "ramses_regrid_empty", "regrid_empty_kernel",
                        blocks)
        lines.append(f"an empty launch on its {blocks} blocks {ems:.4f} ms")
        del kn, ko, kc
    _print(f"phase 55 the device migrate on {card}: config 2 (sedov3d "
           f"levelmin={AMR_LEVELS[0]} levelmax={AMR_LEVELS[1]}) from one "
           f"initial state, {REGRID_STEPS} coarse steps with device_regrid "
           f"on and off: after each of {nreg} regrids the keys and every "
           f"level's u bitwise equal; build_prolong_maps calls "
           f"{a['host_maps']} (on) / {b['host_maps']} (off); changed levels "
           f"above levelmin {a['changed']}, K7 launches {a['k7_launches']} "
           f"(on) / {b['k7_launches']} (off), each bitwise to its plain "
           f"version on its inputs; walls (recording each regrid's state) "
           f"{a['wall']:.3f} s (on) / {b['wall']:.3f} s (off); K7 at the "
           f"main path's largest regrid level ({n} octs, {nd}D; "
           f"{args[1].numel()} old, {args[2].numel()} coarse keys, "
           f"{branch}): {ms:.4f} ms on the device (profiler), a call's "
           f"wall on the stream {call_ms:.4f} ms, plain {pms:.4f} ms, "
           f"bound {bound:.6f} ms by bytes ({_k7_bytes(n, nd)} B), the "
           f"latency floor (an empty launch on its {-(-n // K7_BLOCK)} blocks) "
           f"{empty:.4f} ms, library call: none (no single PyTorch call "
           f"derives these maps); random sorted key sets: "
           + "; ".join(lines)
           + f"; max |K7 - plain| over every comparison {err:.1f}; K7's "
           f"build: {ptxas or 'not rebuilt in this run'}")
    row = {"name": "regrid_maps", "route": "cuda",
           "source": "ramses_tpu_torch/csrc/regrid_maps.cu",
           "replaces": "ramses_tpu/amr/device_regrid.py:214",
           "launches": a["k7_launches"], "max_abs_err": err, "ms": ms,
           "plain_ms": pms, "bound_ms": bound, "bound_by": "bytes",
           "library_ms": None}
    og, sim = a["og"], a["sim"]
    del runs, a, b
    torch.cuda.empty_cache()
    return {"row": row, "og": og, "sim": sim}


def _root_params(root, levels, boxlen: float):
    """sedov3d at ``levels`` (``_amr_params``'s criteria) on a coarse grid
    of ``root`` root cells of side ``boxlen``."""
    p = _amr_params()
    p.amr.levelmin, p.amr.levelmax = levels
    p.amr.nx, p.amr.ny, p.amr.nz = root
    p.amr.boxlen = boxlen
    return p


def _stepped_run(p, nsteps: int, record_last: bool = False):
    """``AmrSim(p).evolve`` for ``nsteps`` coarse steps with the launch
    counters at 0 just before; returns the sim, the leaf mass before, the
    wall s of evolve, the launches and the K1/K3 launches its levels
    require, each regrid's oct coordinates, and (``record_last``) the last
    step's recorded K1/K3 inputs and levels."""
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    tend = p.output.tout[-1] if p.output.tout else p.output.tend
    sim = AmrSim(p)
    stepped, og, recorded = [], [], {}
    step_coarse, regrid = sim.step_coarse, sim.regrid

    def counted(dt):
        spec = sim._fused_spec()
        stepped.append((spec.levels, spec.complete, spec.blocked))
        rec = (_record_kernel_inputs(recorded)
               if record_last and len(stepped) == nsteps else None)
        try:
            step_coarse(dt)
        finally:
            if rec is not None:
                rec()

    def traced():
        regrid()
        og.append({l: sim.tree.levels[l].og for l in sim.levels()})
    sim.step_coarse, sim.regrid = counted, traced
    mass0 = float(sim.totals()["mass"])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim.evolve(tend, nstepmax=nsteps)
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse, sim.regrid
    return dict(sim=sim, mass0=mass0, wall=wall, launches=launches,
                want=_cosmo_want(stepped, sim.lmin), og=og,
                recorded=recorded, last=stepped[-1] if stepped else None)


def _noncubic_phases(dev, card: str, rg: dict, rate8: float) -> dict:
    """Phase 56: (a) config 2's twin on a 2³ root against phase 55's
    config-2 run, (b) sedov3d on a (2, 1, 1) root with K1 and K3 on its
    last step's inputs; returns their K1 and K3 launches."""
    import numpy as np
    import torch
    # ---- 56a. the twin: the same cells as config 2 ----
    p = _root_params(TWIN_ROOT, TWIN_LEVELS, TWIN_BOXLEN)
    r = _stepped_run(p, TWIN_STEPS)
    twin, wall, launches, want, og = (r["sim"], r["wall"], r["launches"],
                                      r["want"], r["og"])
    c2 = rg["sim"]
    if not (twin.nstep == TWIN_STEPS and launches == want
            and len(og) == len(rg["og"])):
        raise AssertionError(f"phase 56a twin: {twin.nstep} steps, launches "
                             f"{launches} (expected {want}), {len(og)} "
                             f"regrids against {len(rg['og'])}")
    for i, (ta, cb) in enumerate(zip(og, rg["og"])):
        if sorted(l + 1 for l in ta) != sorted(cb) or not all(
                np.array_equal(ta[l], cb[l + 1]) for l in ta):
            raise AssertionError(f"phase 56a: the twin's tree differs from "
                                 f"config 2's after regrid {i + 1}")
    worst, bitwise = 0.0, True
    for l in twin.levels():
        ca, ua = twin.leaf_sample(l)
        cb, ub = c2.leaf_sample(l + 1)
        oa, ob = np.lexsort(ca.T), np.lexsort(cb.T)
        if not np.array_equal(ca[oa], cb[ob]):
            raise AssertionError(f"phase 56a: leaf cells of twin level {l} "
                                 f"differ from config 2's level {l + 1}")
        d = np.abs(ua[oa] - ub[ob])
        m = np.abs(ub).max(axis=0)
        worst = max(worst, float((d / (1e-10 + TWIN_REL * m)).max()))
        bitwise = bitwise and bool((d == 0).all())
    if not worst <= 1.0:
        raise AssertionError(f"phase 56a: the twin's leaf field parts from "
                             f"config 2's: max |Δ| / (1e-10 + {TWIN_REL}·M) "
                             f"{worst:.3e}")
    rate = twin.cell_updates / wall
    _print(f"phase 56a non-cubic twin of config 2 on {card}: sedov3d at "
           f"nx=ny=nz={TWIN_ROOT[0]}, boxlen={TWIN_BOXLEN}, levelmin "
           f"{TWIN_LEVELS[0]} levelmax {TWIN_LEVELS[1]} "
           f"({twin.tree.cell_dims(twin.lmin)} base cells), "
           f"{twin.nstep} coarse steps: after each of {len(og)} regrids its "
           f"level-l octs equal config 2's level-(l+1) octs; leaf field "
           f"max |Δ| / (1e-10 + {TWIN_REL}·M) {worst:.3e}, bitwise "
           f"{bitwise}; octs {[twin.tree.noct(l) for l in twin.levels()]}; "
           f"launches {launches} (expected {want}); evolve {wall:.3f} s = "
           f"{rate:.4e} cell-updates/s against config 2's {rate8:.4e} "
           f"(phase 8)")
    out = {k: launches[k] for k in ("fused_muscl", "tile_sweep")}
    del twin, c2, r, rg["sim"]
    torch.cuda.empty_cache()
    # ---- 56b. a (2, 1, 1) root: K1 on a 128 x 64 x 64 complete level ----
    p = _root_params(SLAB_ROOT, TWIN_LEVELS, TWIN_BOXLEN)
    r = _stepped_run(p, SLAB_STEPS, record_last=True)
    sim, wall, launches, want = (r["sim"], r["wall"], r["launches"],
                                 r["want"])
    mass0, mass1 = r["mass0"], float(sim.totals()["mass"])
    finite = all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())
    shape = sim.tree.cell_dims(sim.lmin)
    if not (sim.nstep == SLAB_STEPS and launches == want and finite
            and launches["fused_muscl"] == SLAB_STEPS
            and abs(mass1 - mass0) <= 1e-5 * abs(mass0)):
        raise AssertionError(f"phase 56b: {sim.nstep} steps, launches "
                             f"{launches} (expected {want}), finite {finite},"
                             f" mass {mass0} -> {mass1}")
    line = _last_step_check(sim, r["recorded"], r["last"], "phase 56b")
    _print(f"phase 56b sedov3d on a {SLAB_ROOT} root on {card}: levelmin "
           f"{sim.lmin} levelmax {sim.lmax}, boxlen {TWIN_BOXLEN}, base level "
           f"{shape}, {sim.nstep} coarse steps in {wall:.3f} s, octs "
           f"{[sim.tree.noct(l) for l in sim.levels()]}; launches {launches}"
           f" (expected {want}); leaf mass {mass0:.9e} -> {mass1:.9e}; K1 and"
           f" K3 on the last coarse step's inputs against their plain "
           f"versions within LOCAL_ATOL + LOCAL_RTOL·M: {line}")
    for k in out:
        out[k] += launches[k]
    del sim, r
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 57-60. radiative transfer: K8 (csrc/rt_m1.cu) and K9 (csrc/rt_chem.cu)
# ---------------------------------------------------------------------------

F64_OPS_PER_S = 33.5e12        # H100 SXM f64 outside the tensor cores
# K8 and K9 are built with -fmad=false, so their adds and multiplies issue
# apart: half the f64 rate that counts an FMA as two operations
F64_UNFUSED_OPS_PER_S = F64_OPS_PER_S / 2
# K8 (+, -, *, /, sqrt only) and K9 are built with -fmad=false and round
# where their plain versions do on the card: K8 every value within 1e-13 ×
# the field's max over the cell's 3^d stencil, K9 within rel 1e-12
K8_REL, K9_REL = 1e-13, 1e-12
RT_UNITS = {"units_density": 1.66e-24, "units_time": 3.15e13,
            "units_length": 3.08e18}
STROMGREN3_NML = os.path.join(ROOT, "namelists", "stromgren3.nml")
RT_NAMELISTS = (("iliev1", 3), ("rad_beams", 2), ("stromgren2d", 2),
                ("stromgren3", 3), ("twin_rad_src", 2))
RT_LEVEL = 7                   # phase 58: stromgren3 at 128³, 684 substeps
ILIEV_LEVEL, ILIEV_TOUT = 7, 100.0     # phase 59: iliev1 at 128³, 100 Myr
# phase 60: the refined front of tests/test_rt_amr.py at levelmin 6 /
# levelmax 7 (its r_refine sphere widened to 0.25 so that the front's far
# band lies on level 7), 59 substeps; then the 3-group He ladder at 64³.
# At levelmax 8 (162,616 level-8 octs, 118 substeps) its host
# build and regrid took 53 s of the script's time limit
RT_AMR_LEVELS, RT_AMR_TEND, RT_AMR_R = (6, 7), 0.004, 0.25
RT_AMR_NSUB = (40, 150)        # the substeps phase 60 is sized for
RT_AMR_R_GROWN = 0.27          # phase 60's regrid: the sphere grows
RT_HE_LEVEL, RT_HE_TEND = 6, 0.004
RT_K9_CELLS = 1000003          # phase 57's random cells (3-ion: half)


def _rt_state(shape, ng, c_red, seed, beams=False, nd=None):
    """Random RT state on the CPU, f64: ``U [ng, 1+nd, *shape]`` with N over
    25 decades and |F| up to 1.2 c_red N (so the limiter acts), sources on
    a tenth of the cells, beams (src_F) where asked."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nd = len(shape) if nd is None else nd
    N = 10.0 ** rng.uniform(-30, -5, (ng,) + shape)
    F = rng.standard_normal((ng, nd) + shape)
    F *= 1.2 * c_red * N[:, None] * rng.random((ng, 1) + shape) / \
        np.sqrt((F ** 2).sum(axis=1, keepdims=True))
    F[:, :, rng.random(shape) < 0.2] = 0.0
    src = np.where(rng.random((ng,) + shape) < 0.1,
                   10.0 ** rng.uniform(-20, -15, (ng,) + shape), 0.0)
    srcF = (c_red * src[:, None] * rng.standard_normal((ng, nd) + shape)
            if beams else None)
    return (torch.from_numpy(np.concatenate([N[:, None], F], axis=1)),
            torch.from_numpy(src),
            None if srcF is None else torch.from_numpy(srcF))


def _rt_cells(n, seed, ng=1):
    """Random chemistry cells, f64: N from 1e-30 to 1e-5, T from 10 to 1e6
    K, nH from 1e-4 to 1e2, the fractions from 1e-12 to 1."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(10.0 ** rng.uniform(-30, -5, (ng, n))),
            t(10.0 ** rng.uniform(-12, 0, n)),
            t(10.0 ** rng.uniform(-12, -0.31, n)),
            t(10.0 ** rng.uniform(-12, -0.31, n)),
            t(10.0 ** rng.uniform(1, 6, n)), t(10.0 ** rng.uniform(-4, 2, n)))


def _stencil_max(x, nd: int, periodic: bool = True):
    """|x| maxed over each cell's 3^nd neighbourhood along the last nd axes
    (wrapping, or replicating the edge as the outflow ghosts do)."""
    import torch
    a = x.abs()
    for ax in range(a.dim() - nd, a.dim()):
        n = a.shape[ax]
        lo = a.roll(1, ax) if periodic else torch.cat(
            [a.narrow(ax, 0, 1), a.narrow(ax, 0, n - 1)], ax)
        hi = a.roll(-1, ax) if periodic else torch.cat(
            [a.narrow(ax, 1, n - 1), a.narrow(ax, n - 1, 1)], ax)
        a = torch.maximum(a, torch.maximum(lo, hi))
    return a


def _k8_check(got, want, scale, what: str) -> tuple:
    """(max abs err, worst err / (K8_REL·M)); raises past the tolerance."""
    import torch
    err = (got - want).abs()
    ratio = float((err / (K8_REL * scale)).nan_to_num(0.0, posinf=1e30)
                  .max())
    if not (bool(torch.isfinite(got).all()) and ratio <= 1.0):
        raise AssertionError(f"{what}: K8 disagrees with its plain version: "
                             f"max abs err {float(err.max()):.3e}, worst "
                             f"err / (1e-13 M) {ratio:.3e}")
    return float(err.max()), ratio


def _k9_check(pairs, what: str) -> tuple:
    """(max abs err, max rel err) over (got, want) pairs; raises past rel
    K9_REL."""
    import torch
    mx, rel = 0.0, 0.0
    for got, want in pairs:
        r = float(((got - want).abs() / want.abs()).nan_to_num(
            0.0, posinf=1e30).max())
        mx = max(mx, float((got - want).abs().max()))
        rel = max(rel, r)
        if not (bool(torch.isfinite(got).all()) and r <= K9_REL):
            raise AssertionError(f"{what}: K9 disagrees with its plain "
                                 f"version: rel {r:.3e}")
    return mx, rel


def _block_rows(blk, nd: int):
    """The interior [2:4]^nd cells of ``blk [ncols, 6.., noct]`` as
    oct-major rows ``[noct·2^nd, ncols]`` (K8's block-entry layout)."""
    interior = (slice(None),) + tuple(slice(2, 4) for _ in range(nd))
    return blk[interior].permute((nd + 1,) + tuple(range(1, nd + 1)) + (0,)
                                 ).reshape(-1, blk.shape[0])


def _k8_block_held(rad, blk, dt, dx, c_red, nd, ng, what: str) -> tuple:
    """K8's block entry on ``rad``/``blk`` against the plain version: the
    written rows within K8_REL × the field's max over the cell's 3^nd
    stencil in its block, the rest of the rows untouched."""
    import torch
    from ramses_tpu_torch.rt import m1
    got = m1.block_update(rad, blk, dt, dx, c_red, nd, ng)
    want = m1.block_update_ref(rad, blk, dt, dx, c_red, nd, ng)
    ref = torch.cat([m1.glf_block_ref(blk[g * (1 + nd):(g + 1) * (1 + nd)],
                                      dt, dx, c_red, nd) for g in range(ng)])
    scale = _block_rows(_stencil_max(ref.movedim(-1, 1), nd).movedim(1, -1),
                        nd)
    del ref
    n = blk.shape[-1] * 2 ** nd
    if not torch.equal(got[n:], rad[n:]):
        raise AssertionError(f"{what}: K8 block entry wrote past its octs' "
                             f"rows")
    return _k8_check(got[:n], want[:n], scale, what)


def _k8_block_check(dev, nd, ng, noct, seed):
    """K8's block entry on random gathered stencils against the plain
    version (:func:`_k8_block_held`)."""
    import torch
    c_red = 3e7
    U, _, _ = _rt_state((6,) * nd + (noct,), ng, c_red, seed, nd=nd)
    blk = U.reshape((ng * (1 + nd),) + U.shape[2:]).contiguous().to(dev)
    rad = torch.rand((noct * 2 ** nd + 7, ng * (1 + nd)),
                     dtype=torch.float64, device=dev)
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    return _k8_block_held(rad, blk, dt, dx, c_red, nd, ng,
                          f"block entry nd={nd} ng={ng} noct={noct}")


def _rt_kernel_phase(dev, card: str) -> dict:
    """Phase 57: K8's dense entry (1D/2D/3D, periodic and outflow, 1 and 3
    groups, with and without beams, sizes ragged against its 256-thread
    blocks), its block entry on random gathered stencils, and K9 gray and
    3-ion (with and without the UV background, heating on and off) on
    random f64 states, each against its plain version."""
    import numpy as np
    import torch
    from ramses_tpu_torch.hydro.cooling import uv_rates
    from ramses_tpu_torch.rt import chem, m1, spectra
    t0 = time.perf_counter()
    c_red = 3e7
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    err8 = ratio8 = 0.0
    dense = [((33,), 1, True, False), ((1000,), 3, False, True),
             ((9, 14), 1, False, False), ((45, 70), 3, True, True),
             ((5, 7, 6), 1, True, True), ((37, 29, 41), 3, False, False),
             ((37, 29, 41), 1, True, True), ((1, 4, 3), 2, True, False),
             ((64, 64, 64), 1, False, True), ((300,), 1, True, True),
             ((19, 45), 3, True, False), ((2, 9, 33), 3, False, False),
             ((7, 37, 41), 3, True, True)]
    for i, (shape, ng, periodic, beams) in enumerate(dense):
        U, src, srcF = [None if t is None else t.to(dev)
                        for t in _rt_state(shape, ng, c_red, 70 + i, beams)]
        nd = len(shape)
        got = m1.transport(U, dt, dx, c_red, nd, periodic, src, srcF)
        want = m1.transport_ref(U, dt, dx, c_red, nd, periodic, src, srcF)
        e, r = _k8_check(got, want, _stencil_max(want, nd, periodic),
                         f"dense entry {shape} ng={ng} periodic={periodic} "
                         f"beams={beams}")
        err8, ratio8 = max(err8, e), max(ratio8, r)
    # the dense entry's chunks of x planes (a 3D block marches one chunk,
    # as many chunks as keep every block resident): copies of one group
    # give the group's own bits, 1 to 128 groups cutting x from one plane
    # a block to the whole box
    U, src, srcF = [t.to(dev) for t in _rt_state((37, 29, 41), 1, c_red, 89,
                                                 True)]
    one = m1.transport(U, dt, dx, c_red, 3, True, src, srcF)
    for ng in (2, 4, 8, 32, 128):
        got = m1.transport(U.repeat(ng, 1, 1, 1, 1), dt, dx, c_red, 3, True,
                           src.repeat(ng, 1, 1, 1),
                           srcF.repeat(ng, 1, 1, 1, 1))
        if not all(torch.equal(g, one[0]) for g in got):
            raise AssertionError(f"phase 57: K8's dense entry differs "
                                 f"between one group and {ng} copies of it "
                                 f"(its chunks of x planes)")
    del one, got, U, src, srcF
    for i, (nd, ng, noct) in enumerate(((1, 1, 7), (2, 3, 500),
                                        (3, 1, 4099), (3, 2, 3000),
                                        (3, 3, 33), (2, 2, 130),
                                        (1, 3, 300))):
        e, r = _k8_block_check(dev, nd, ng, noct, 90 + i)
        err8, ratio8 = max(err8, e), max(ratio8, r)
    g, h = uv_rates(1.0, 1.0)
    uv = ((g["HI"], g["HeI"], g["HeII"]), (h["HI"], h["HeI"], h["HeII"]))
    err9 = rel9 = 0.0
    for i, (use_uv, heating, otsa) in enumerate(((False, True, True),
                                                 (True, True, True),
                                                 (True, False, False))):
        N, x, _, _, T, nH = [t.to(dev) for t in _rt_cells(RT_K9_CELLS,
                                                          110 + i)]
        uvv = uv if use_uv else None
        want = chem.chem_step_ref(N[0], x, T, nH, 3e10, c_red,
                                  chem.GroupSpec(), otsa, heating=heating,
                                  uv=uvv)
        rows = torch.zeros((N.shape[1], 4), dtype=torch.float64, device=dev)
        rows[:, 0] = N[0]
        got = chem.chem_gray(rows[:, 0], x, T, nH, 3e10, c_red,
                             chem.GroupSpec(), otsa, heating=heating, uv=uvv)
        e, r = _k9_check(zip((rows[:, 0],) + got, want),
                         f"gray uv={use_uv} heating={heating}")
        err9, rel9 = max(err9, e), max(rel9, r)
    for i, (ng, use_uv, heating) in enumerate(((1, False, True),
                                               (3, True, True),
                                               (2, False, False),
                                               (8, True, True))):
        N, x, h2, h3, T, nH = [t.to(dev) for t in _rt_cells(
            RT_K9_CELLS // 2, 120 + i, ng)]
        nHe = nH * 0.08
        groups = spectra.blackbody_groups(1e5, list(np.geomspace(
            13.6, 1e3, ng + 1)))
        uvv = uv if use_uv else None
        want = chem.chem_step_3ion_ref(list(N), (x, h2, h3), T, nH, nHe,
                                       1e11, c_red, groups, heating=heating,
                                       uv=uvv)
        he = torch.stack([h2, h3], dim=1)
        Nv = N.clone()
        got = chem.chem_3ion(Nv, x, he[:, 0], he[:, 1], T, nH, nHe, 1e11,
                             c_red, groups, heating=heating, uv=uvv)
        e, r = _k9_check(list(zip(Nv, want[0]))
                         + list(zip(got, list(want[1]) + [want[2]])),
                         f"3-ion ng={ng} uv={use_uv} heating={heating}")
        err9, rel9 = max(err9, e), max(rel9, r)
    torch.cuda.synchronize()
    _print(f"phase 57 RT kernels against their plain versions on {card}: "
           f"K8 dense entry {len(dense)} cases (1D/2D/3D, periodic and "
           f"outflow, ng 1-3, beams, ragged against its tiles, fewer than "
           f"three x planes) and its x chunks bitwise alike (1 to 128 "
           f"copies of a group at 37 x 29 x 41), block entry 7 cases (the "
           f"last block's octs ragged); max abs "
           f"err {err8:.3e}, worst err / (1e-13 M) {ratio8:.3e}; K9 gray 3 "
           f"cases and 3-ion 4 cases (ng 1-8, UV, heating on/off) on "
           f"{RT_K9_CELLS} / {RT_K9_CELLS // 2} random cells: max abs err "
           f"{err9:.3e}, max rel err {rel9:.3e} (tolerance {K9_REL:g}); "
           f"{time.perf_counter() - t0:.1f} s")
    return dict(k8_err=err8, k9_err=err9)


def _rt_bound(nbytes: float, nops: float) -> dict:
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / F64_UNFUSED_OPS_PER_S
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms, nbytes=nbytes, nops=nops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _k8_ops(U, src=None, src_F=None) -> int:
    """The operations of K8's dense entry as the function needs them,
    each counted as ``_count_ops`` counts the plain version's (an
    elementwise operation a value, a power one), but with one closure a
    cell (the plain version forms three a padded cell, each the whole
    pressure tensor), row d of P for axis d, and each face once.  A cell's
    closure 2nd + 21: the N clamp, |F|² (nd squares and adds), f² (a
    multiply, a square, a divide, a clamp), chi 9, iterm 2, oterm 3,
    1/|F|² 2; at the cells and their face neighbours.  A flux row 5nd + 1
    (F_d F_j times 1/|F|², times oterm, iterm on the diagonal, times N,
    times c²) at the cells and the two neighbours along its axis.  A face
    5 (1 + nd): a component's flux sum, its half, the jump in U, its c/2
    multiple, the difference.  A cell and axis 3 (1 + nd): the faces'
    difference, times dt/dx, into the increment.  The finish 4nd + 8: N +
    dN and its clamp, F + dF, the limiter (|F| 2nd + 1, c N, the
    comparison, the clamp, the divide, the select, F times the scale).
    The sources two a value."""
    ng, nd = U.shape[0], U.shape[1] - 1
    sp = U.shape[2:]
    cells = math.prod(sp)
    side = [cells // n for n in sp]       # the cells of a plane across d
    n = (cells + 2 * sum(side)) * (2 * nd + 21) \
        + sum(cells + 2 * a for a in side) * (5 * nd + 1) \
        + sum(cells + a for a in side) * 5 * (1 + nd) \
        + cells * nd * 3 * (1 + nd) + cells * (4 * nd + 8)
    n += 2 * cells * ((src is not None) + nd * (src_F is not None))
    return ng * n


def _rt_timing(r: dict) -> str:
    return (f"{r['ms']:.4f} ms/launch, plain version {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} (bytes "
            f"{r['bytes_ms']:.4f} ms for {r['nbytes'] / 1e6:.1f} MB; "
            f"operations {r['ops_ms']:.4f} ms for {r['nops'] / 1e9:.4f} G "
            f"f64, unfused at {F64_UNFUSED_OPS_PER_S:.3g}/s), "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound: "
            f"{100 * r['bytes_ms'] / r['ms']:.1f} % of the bytes' time, "
            f"{100 * r['ops_ms'] / r['ms']:.1f} % of the operations'")


RT_OPS = ("pow", "exp")           # counted as one operation each


def _rt_substep(rs) -> float:
    """One RT-Courant substep of an RtSim [s]."""
    from ramses_tpu_torch.rt import m1
    return m1.rt_courant_dt(rs.dx, rs.spec.c_red, rs.spec.courant)


def _rt_time_kernels(rs) -> tuple:
    """K8 and K9 timed per launch (device ms) on an RtSim's state beside
    their plain versions and their bounds, each checked against its plain
    version on that state; returns (K8 readings, K9 readings)."""
    import torch
    from ramses_tpu_torch.rt import chem, m1
    spec = rs.spec
    nd = spec.ndim
    dt = _rt_substep(rs)
    U, src = rs.U.clone(), rs._src
    k8 = lambda: m1.transport(U, dt, rs.dx, spec.c_red, nd,  # noqa: E731
                              spec.periodic, src)
    plain8 = lambda: m1.transport_ref(U, dt, rs.dx,  # noqa: E731
                                      spec.c_red, nd, spec.periodic, src)
    want = plain8()
    e8, r8 = _k8_check(k8(), want, _stencil_max(want, nd, spec.periodic),
                       "phase 58 final state")
    del want
    r8 = dict(max_abs_err=e8, ratio=r8,
              ms=_device_ms(k8, "rt_m1::dense_kernel", n=30,
                            launched=lambda: m1.launches),
              plain_ms=_median_ms(plain8, reps=5, warm=1),
              plain_ops=_count_ops(plain8, RT_OPS),
              **_rt_bound(8 * (2 * U.numel() + src.numel()),
                          _k8_ops(U, src)))
    n = U[0, 0].numel()
    x, T, nH = (a.reshape(-1) for a in (rs.x, rs.T, rs.nH))
    N0 = U.reshape(-1, 1 + nd, n)[0, 0].clone()
    Nk = N0.clone()
    got = chem.chem_gray(Nk, x, T, nH, dt, spec.c_red, spec.group,
                         spec.otsa, heating=spec.heating)
    want = chem.chem_step_ref(N0, x, T, nH, dt, spec.c_red, spec.group,
                              spec.otsa, heating=spec.heating)
    e9, rel9 = _k9_check(zip((Nk,) + got, want), "phase 58 final state")
    k9 = lambda: chem.chem_gray(Nk, x, T, nH, dt,  # noqa: E731
                                spec.c_red, spec.group, spec.otsa,
                                heating=spec.heating)
    plain9 = lambda: chem.chem_step_ref(N0, x, T, nH, dt,  # noqa: E731
                                        spec.c_red, spec.group, spec.otsa,
                                        heating=spec.heating)
    r9 = dict(max_abs_err=e9, rel=rel9,
              ms=_device_ms(k9, "rt_chem::gray_kernel", n=30,
                            launched=lambda: chem.launches),
              plain_ms=_median_ms(plain9, reps=5, warm=1),
              **_rt_bound(8 * 7 * n, _count_ops(plain9, RT_OPS)))
    del U, N0, Nk
    torch.cuda.empty_cache()
    return r8, r9


def _with_levels(src: str, lvl: int, subs=()) -> str:
    """A namelist's text with levelmin = levelmax = ``lvl`` and the given
    (pattern, replacement) edits."""
    import re
    text = open(src).read()
    for pat, rep in ((r"levelmin=\d+", f"levelmin={lvl}"),
                     (r"levelmax=\d+", f"levelmax={lvl}")) + tuple(subs):
        text, n = re.subn(pat, rep, text)
        if not n:
            raise AssertionError(f"{src}: no {pat!r} to edit")
    return text


def _stromgren_phase(dev, card: str, tmp: str) -> dict:
    """Phase 58: stromgren3.nml at 128³ through ``run_namelist`` (static:
    one advance of 684 substeps); returns the launches and the K8/K9
    readings on the final state."""
    import numpy as np
    import torch
    from ramses_tpu_torch.driver import run_namelist
    from ramses_tpu_torch.rt import chem
    from ramses_tpu_torch.rt.coupling import RtCoupled
    from ramses_tpu_torch.rt.driver import stromgren_radius
    path = os.path.join(tmp, "stromgren3_128.nml")
    with open(path, "w") as f:
        f.write(_with_levels(STROMGREN3_NML, RT_LEVEL))
    acc, restore = _timed_parts({"rt": (RtCoupled, "advance")})
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        sim = run_namelist(path)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = _counts()
    rs = sim.rt.sim
    nsub = rs.substeps
    n = 2 ** RT_LEVEL
    if rs.shape != (n,) * 3 or sim.nstep != 1 or nsub != rs.nsub(sim.t):
        raise AssertionError(f"phase 58: {sim.nstep} steps, {nsub} substeps "
                             f"at {rs.shape}, expected 1 and "
                             f"{rs.nsub(sim.t)} at {n}³")
    if launches != _want(rt_m1=nsub, rt_chem=nsub):
        raise AssertionError(f"phase 58: launches {launches} for {nsub} "
                             f"substeps")
    for f in ("N", "F", "x", "T"):
        if not bool(torch.isfinite(getattr(rs, f)).all()):
            raise AssertionError(f"phase 58: {f} is not finite")
    st = sim.rt.rt_stats()
    if not 0.0 < st["photons"] <= 1.05 * st["injected"]:
        raise AssertionError(f"phase 58: photon budget {st}")
    # the x²-weighted ionized volume against the analytic Strömgren
    # growth at this time (tests/test_rt_driver.py:72-104)
    xf, Tf = rs.x.cpu().numpy(), rs.T.cpu().numpy()
    t_ion = float(np.median(Tf[xf > 0.9])) if (xf > 0.9).any() else 1e4
    nH, ndot = 1e-2, 5e48
    r_s = stromgren_radius(ndot, nH, T=t_ion)
    t_rec = 1.0 / (float(chem.alpha_B(torch.tensor(t_ion,
                                                   dtype=torch.float64)))
                   * nH)
    v_exp = 4.0 / 3.0 * np.pi * r_s ** 3 * (1.0 - np.exp(-sim.t / t_rec))
    v_got = float((xf ** 2).sum()) * rs.dx ** 3
    if abs(v_got / v_exp - 1.0) > 0.3:
        raise AssertionError(f"phase 58: ionized volume {v_got:.4e} against "
                             f"the Strömgren {v_exp:.4e}")
    busy = _profile(lambda: rs.advance(40 * _rt_substep(rs)), None,
                    name=None, warm=False, raw=True,
                    names=("ramses_rt_m1", "ramses_rt_chem"), expect=80)
    r8, r9 = _rt_time_kernels(rs)
    _print(f"phase 58 RT main path on {card}: stromgren3.nml at {n}³ "
           f"(levelmin = levelmax = {RT_LEVEL} set in code, static), "
           f"{nsub} substeps, launches K8 {launches['rt_m1']} K9 "
           f"{launches['rt_chem']}; run_namelist {wall:.3f} s, RT "
           f"{acc['rt']:.3f} s = {1e3 * acc['rt'] / nsub:.4f} ms a "
           f"substep; a 40-substep window: {busy}; photons "
           f"{st['photons']:.6e} of {st['injected']:.6e} injected (ratio "
           f"{st['ratio']:.6f}); x²-weighted ionized volume {v_got:.6e} "
           f"cm³ against the Strömgren {v_exp:.6e} (rel "
           f"{v_got / v_exp - 1.0:+.4f}, T_ion {t_ion:.1f} K)")
    _print(f"phase 58 K8 on the final state: {_rt_timing(r8)} (the "
           f"operations as the function needs them, one closure a cell; "
           f"the plain version performs {r8['plain_ops'] / 1e9:.4f} G); "
           f"against plain: max abs err {r8['max_abs_err']:.3e}, worst err / "
           f"(1e-13 M) {r8['ratio']:.3e}; library call: none (no PyTorch "
           f"call computes an M1 step)")
    _print(f"phase 58 K9 on the final state: {_rt_timing(r9)}; against "
           f"plain: max abs err {r9['max_abs_err']:.3e}, max rel "
           f"{r9['rel']:.3e}; library call: none (no PyTorch call computes "
           f"the photochemistry)")
    del sim, rs
    torch.cuda.empty_cache()
    return dict(launches=launches, k8=r8, k9=r9)


def _issued_steps():
    """Wrap the uniform driver's ``run_steps`` so that the steps each call
    issues are summed (K1 launches once an issued step: the steps past the
    output time are masked on the device, not skipped); returns (the
    count, the function that restores it)."""
    from ramses_tpu_torch import driver
    real = driver.run_steps
    n = [0]

    def counted(grid, u, t, tend, nsteps, **kw):
        n[0] += nsteps
        return real(grid, u, t, tend, nsteps, **kw)
    driver.run_steps = counted

    def restore():
        driver.run_steps = real
    return n, restore


def _rt_cli_phase(card: str, tmp: str) -> dict:
    """Phase 59: the five RT namelists through the CLI as shipped, then
    iliev1.nml at 128³; returns the launches."""
    import torch
    from ramses_tpu_torch.driver import run_namelist
    from ramses_tpu_torch.rt.coupling import RtCoupled
    total = dict.fromkeys(_counts(), 0)
    lines = []
    for name, ndim in RT_NAMELISTS:
        src = os.path.join(ROOT, "namelists", f"{name}.nml")
        torch.cuda.synchronize()
        _reset_counts()
        issued, restore = _issued_steps()
        try:
            sim, wall = _cli_in_process([src, "--ndim", str(ndim)],
                                        os.path.join(tmp, name))
        finally:
            restore()
        launches = _counts()
        rs = sim.rt.sim
        k9 = 0 if rs.spec.pp else rs.substeps
        if launches != _want(rt_m1=rs.substeps, rt_chem=k9,
                             fused_muscl=issued[0]):
            raise AssertionError(f"phase 59 {name}: launches {launches} for "
                                 f"{sim.nstep} steps, {rs.substeps} "
                                 f"substeps")
        for f in ("N", "F", "x", "T"):
            if not bool(torch.isfinite(getattr(rs, f)).all()):
                raise AssertionError(f"phase 59 {name}: {f} is not finite")
        if not bool(torch.isfinite(sim.state.u).all()):
            raise AssertionError(f"phase 59 {name}: u is not finite")
        for k in total:
            total[k] += launches[k]
        lines.append(f"{name} {rs.shape} {sim.nstep} steps ({issued[0]} "
                     f"issued) {rs.substeps} substeps K8 "
                     f"{launches['rt_m1']} K9 {launches['rt_chem']} K1 "
                     f"{launches['fused_muscl']} {wall:.2f} s")
    _print(f"phase 59 the RT namelists through the CLI on {card} (run_cli "
           f"in process, as shipped): " + "; ".join(lines))
    # iliev1 at 128³: f32 gas through K1, f64 RT through K8/K9 once a chunk
    path = os.path.join(tmp, "iliev1_128.nml")
    with open(path, "w") as f:
        f.write(_with_levels(os.path.join(ROOT, "namelists", "iliev1.nml"),
                             ILIEV_LEVEL, ((r"tout=0\.03",
                                            f"tout={ILIEV_TOUT}"),)))
    acc, restore = _timed_parts({"rt": (RtCoupled, "advance")})
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import Simulation
    base = Simulation(load_params(path, ndim=3))
    mass0, e0 = (float(base.totals()[k]) for k in ("mass", "energy"))
    del base
    issued, restore_steps = _issued_steps()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        sim = run_namelist(path)
        torch.cuda.synchronize()
    finally:
        restore()
        restore_steps()
    wall = time.perf_counter() - t0
    launches = _counts()
    rs = sim.rt.sim
    if launches != _want(fused_muscl=issued[0], rt_m1=rs.substeps,
                         rt_chem=rs.substeps):
        raise AssertionError(f"phase 59 iliev1 128³: launches {launches} for "
                             f"{sim.nstep} steps, {rs.substeps} substeps")
    tot = sim.totals()
    mass1, e1 = float(tot["mass"]), float(tot["energy"])
    st = sim.rt.rt_stats()
    if abs(mass1 - mass0) > 1e-5 * abs(mass0) or not e1 > e0 \
            or not 0.0 < st["photons"] <= 1.05 * st["injected"] \
            or not bool(torch.isfinite(sim.state.u).all()):
        raise AssertionError(f"phase 59 iliev1 128³: mass {mass0} -> "
                             f"{mass1}, energy {e0} -> {e1}, photons {st}")
    for k in total:
        total[k] += launches[k]
    _print(f"phase 59 iliev1.nml at 128³ on {card} (levelmin = levelmax = "
           f"{ILIEV_LEVEL}, tout = {ILIEV_TOUT:g} set in code; f32 gas): "
           f"{sim.nstep} hydro steps ({issued[0]} issued, K1 "
           f"{launches['fused_muscl']}), "
           f"{rs.substeps} RT substeps (K8 {launches['rt_m1']}, K9 "
           f"{launches['rt_chem']}); mass {mass0:.9e} -> {mass1:.9e}, "
           f"energy {e0:.6e} -> {e1:.6e}; photons {st['photons']:.4e} of "
           f"{st['injected']:.4e}; run_namelist {wall:.3f} s, RT "
           f"{acc['rt']:.3f} s ({100 * acc['rt'] / wall:.1f} % of the wall)")
    del sim
    torch.cuda.empty_cache()
    return total


def _rt_amr_params(lmin, lmax, tend, refine=None, **rt):
    """The RT set-up of tests/test_rt_amr.py (a uniform neutral box, a
    central source, reduced light speed 1e-4 c) as port Params."""
    from ramses_tpu_torch.config import params_from_dict
    g = {
        "run_params": {"hydro": True, "rt": True},
        "amr_params": {"levelmin": lmin, "levelmax": lmax, "boxlen": 1.0},
        "init_params": {"nregion": 1, "region_type": ["square"],
                        "x_center": [0.5], "y_center": [0.5],
                        "z_center": [0.5], "length_x": [10.0],
                        "length_y": [10.0], "length_z": [10.0],
                        "exp_region": [10.0], "d_region": [1.0],
                        "p_region": [1e-4]},
        "hydro_params": {"gamma": 5.0 / 3.0, "courant_factor": 0.5},
        "rt_params": dict({"rt_ndot": 1e48, "rt_c_fraction": 1e-4,
                           "rt_src_pos": [0.5, 0.5, 0.5], "rt_otsa": True},
                          **rt),
        "units_params": dict(RT_UNITS),
        "output_params": {"tend": tend},
    }
    if refine:
        g["refine_params"] = refine
    return params_from_dict(g, ndim=3)


class _Kept:
    """A device copy of a tensor that keeps its layout: a copy of its
    whole (contiguous) base, and the sizes, strides and offset that lay
    the tensor out in it (the K9 columns of the AMR rows are strided
    views)."""

    def __init__(self, t):
        base = t if t._base is None else t._base
        if not base.is_contiguous():
            raise AssertionError("a recorded tensor's base is not "
                                 "contiguous")
        self.base = base.clone()
        self.view = (tuple(t.size()), tuple(t.stride()),
                     t.storage_offset() - base.storage_offset())

    def fresh(self):
        """(a new copy of the base, the tensor laid out in it)."""
        b = self.base.clone()
        return b, b.as_strided(*self.view)


RT_ENTRIES = (("transport", "m1", "dense"), ("block_update", "m1", "block"),
              ("chem_gray", "chem", "gray"), ("chem_3ion", "chem", "3ion"))


def _record_rt(rt, store: dict):
    """Wrap K8's and K9's wrappers as ``rt`` (an ``RtAmrCoupled``) calls
    them, so that each call records its arguments (tensors as
    :class:`_Kept`) in ``store`` under (entry, level), then launches as
    before; the latest call of an entry on a level is kept.  Returns the
    function that restores them."""
    import torch
    from ramses_tpu_torch.rt import chem, m1
    mods = {"m1": m1, "chem": chem}
    level = [None]
    real = {}

    def kept(x):
        return _Kept(x) if torch.is_tensor(x) else x
    for fn, mod, entry in RT_ENTRIES:
        real[fn] = getattr(mods[mod], fn)

        def rec(*a, _fn=real[fn], _entry=entry, **kw):
            store[(_entry, level[0])] = ([kept(x) for x in a],
                                         {k: kept(v) for k, v in kw.items()})
            return _fn(*a, **kw)
        setattr(mods[mod], fn, rec)
    transport, chemistry = rt._transport, rt._chemistry

    def tr(sim, l, *a):
        level[0] = l
        return transport(sim, l, *a)

    def ch(l, *a):
        level[0] = l
        return chemistry(l, *a)
    rt._transport, rt._chemistry = tr, ch

    def restore():
        for fn, mod, _ in RT_ENTRIES:
            setattr(mods[mod], fn, real[fn])
        del rt._transport, rt._chemistry
    return restore


def _rt_recorded_check(store: dict, what: str) -> tuple:
    """K8's and K9's entries on the arguments :func:`_record_rt` kept,
    laid out as the hierarchy gave them, against their plain versions:
    K8 within K8_REL × the field's stencil max, K9 within rel K9_REL, and
    K9 leaves the rows' other columns as they were.  Returns (K8 max abs
    err, K9 max abs err, what was checked)."""
    import inspect
    import torch
    from ramses_tpu_torch.rt import chem, m1
    e8 = e9 = 0.0
    done = []
    for (entry, l), (args, kw) in sorted(store.items(),
                                         key=lambda kv: kv[0][::-1]):
        fn = {"dense": m1.transport, "block": m1.block_update,
              "gray": chem.chem_gray, "3ion": chem.chem_3ion}[entry]
        base, first = args[0].fresh()
        b = inspect.signature(fn).bind(
            first, *[x.fresh()[1] if isinstance(x, _Kept) else x
                     for x in args[1:]],
            **{k: v.fresh()[1] if isinstance(v, _Kept) else v
               for k, v in kw.items()})
        b.apply_defaults()
        p = b.arguments
        tag = f"{what} level {l} {entry}"
        if entry == "dense":
            got = fn(*b.args, **b.kwargs)
            want = m1.transport_ref(*b.args, **b.kwargs)
            e8 = max(e8, _k8_check(got, want, _stencil_max(
                want, p["ndim"], p["periodic"]), tag)[0])
            shape = tuple(p["U"].shape)
        elif entry == "block":
            e8 = max(e8, _k8_block_held(*b.args, what=tag)[0])
            shape = tuple(p["blk"].shape)
        else:
            N0 = first.clone()
            got = fn(*b.args, **b.kwargs)
            if entry == "gray":
                want = chem.chem_step_ref(
                    N0, p["x"], p["T"], p["nH"], p["dt"], p["c_red"],
                    p["group"], p["otsa"], heating=p["heating"], uv=p["uv"])
                pairs = zip((first,) + tuple(got), want)
            else:
                want = chem.chem_step_3ion_ref(
                    list(N0), (p["x"], p["xhe2"], p["xhe3"]), p["T"],
                    p["nH"], p["nHe"], p["dt"], p["c_red"], p["groups"],
                    p["otsa"], heating=p["heating"], uv=p["uv"])
                pairs = (list(zip(first, want[0]))
                         + list(zip(got, list(want[1]) + [want[2]])))
            e9 = max(e9, _k9_check(pairs, tag)[0])
            rest = torch.ones_like(base, dtype=torch.bool)
            rest.as_strided(*args[0].view).fill_(False)
            if not torch.equal(base[rest], args[0].base[rest]):
                raise AssertionError(f"{tag}: K9 wrote outside its N "
                                     f"columns")
            shape = tuple(first.shape)
        done.append(f"{l} {entry} {list(shape)}")
    return e8, e9, ", ".join(done)


def _rt_recorded_substep(sim, what: str) -> tuple:
    """One RT substep of an ``AmrSim`` (a coarse dt of half the RT Courant
    step) with K8's and K9's inputs recorded on every level, then each
    entry checked on them (:func:`_rt_recorded_check`)."""
    from ramses_tpu_torch.rt import m1
    rt = sim.rt_amr
    spec = rt.spec
    dx = sim.dx(max(sim.levels())) * rt.un.scale_l
    store = {}
    restore = _record_rt(rt, store)
    try:
        nsub = rt.advance(sim, 0.5 * m1.rt_courant_dt(
            dx, spec.c_red, spec.courant) / rt.un.scale_t)
    finally:
        restore()
    if nsub != 1 or len(store) != 2 * len(sim.levels()):
        raise AssertionError(f"{what}: {nsub} substeps, recorded "
                             f"{sorted(store)}")
    return _rt_recorded_check(store, what)


def _rt_forced_regrid(sim, r: float, what: str) -> tuple:
    """Grow the refined sphere of an RT hierarchy to radius ``r`` and
    regrid, so that new octs take their rows from the coarser level
    through ``apply_migration`` and the host maps; checks that rows moved,
    that K7 never launched and that every level's rows fit its new maps,
    finite with N >= 0.  Returns (levels migrated, octs, seconds)."""
    import torch
    from ramses_tpu_torch.amr import device_regrid as dr
    rt = sim.rt_amr
    migrated, k7 = [], dr.launches
    apply = rt.apply_migration
    rt.apply_migration = lambda s: (migrated.append(len(s._mig_log)),
                                    apply(s))
    sim.params.refine.r_refine = [r] * 10
    t0 = time.perf_counter()
    try:
        sim.regrid()
        torch.cuda.synchronize()
    finally:
        del rt.apply_migration
    wall = time.perf_counter() - t0
    if not (migrated and migrated[0] > 0) or dr.launches != k7:
        raise AssertionError(f"{what} regrid: migrations {migrated} (the "
                             f"levels logged), K7 {dr.launches - k7}")
    for l in sim.levels():
        rad = rt.rad[l]
        if rad.shape[0] != sim.maps[l].ncell_pad or not (
                bool(torch.isfinite(rad).all())
                and bool((rad[:, ::1 + rt.nd] >= 0).all())
                and bool(torch.isfinite(rt.xion[l]).all())):
            raise AssertionError(f"{what} regrid: level {l} rows "
                                 f"{tuple(rad.shape)} not finite or N < 0")
    return migrated[0], [sim.tree.noct(l) for l in sim.levels()], wall


def _rt_amr_phase(dev, card: str) -> dict:
    """Phase 60: RT on the hierarchy (the refined front at levelmin 6 /
    levelmax 8, f32 gas through K1/K3, f64 RT through K8's two entries and
    K9; K7 never launched), a regrid that migrates the rows, K8 and K9 on
    one substep's inputs as the migrated hierarchy lays them out against
    their plain versions, then the 3-group He ladder at 64³ beside the
    uniform driver (and K9's 3-ion entry on its rows); returns the
    launches and the K8/K9 errors."""
    import numpy as np
    import torch
    from ramses_tpu_torch.amr import device_regrid as dr
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.driver import Simulation
    lmin, lmax = RT_AMR_LEVELS
    p = _rt_amr_params(lmin, lmax, RT_AMR_TEND, rt_ndot=1e44, refine={
        k: [v] * 10 for k, v in (("r_refine", RT_AMR_R), ("x_refine", 0.5),
                                 ("y_refine", 0.5), ("z_refine", 0.5))})
    p.init.d_region = [10.0]
    t_build = time.perf_counter()
    sim = AmrSim(p)
    t_build = time.perf_counter() - t_build
    e0 = float(sim.totals()["energy"])
    v0 = sim.rt_amr.ionized_volume(sim)
    stepped, rt_calls = [], []
    step_coarse, advance = sim.step_coarse, sim.rt_amr.advance

    def counted(dt):
        spec = sim._fused_spec()
        stepped.append((spec.levels, spec.complete, spec.blocked))
        step_coarse(dt)

    def rt_counted(s, dt):
        nc = sum(bool(s.maps[l].complete) for l in s.levels())
        n = advance(s, dt)
        rt_calls.append((n, nc, len(s.levels()) - nc))
        return n
    sim.step_coarse, sim.rt_amr.advance = counted, rt_counted
    k7 = dr.launches
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sim.evolve(RT_AMR_TEND)
    sim.drain()
    wall = time.perf_counter() - t0
    launches = _counts()
    del sim.step_coarse, sim.rt_amr.advance
    want = _cosmo_want(stepped, lmin)
    nsub = sum(n for n, _, _ in rt_calls)
    want.update(rt_m1=sum(n * c for n, c, _ in rt_calls),
                rt_m1_block=sum(n * q for n, _, q in rt_calls),
                rt_chem=sum(n * (c + q) for n, c, q in rt_calls))
    if launches != want or dr.launches != k7:
        raise AssertionError(f"phase 60: launches {launches}, the levels "
                             f"require {want}; K7 {dr.launches - k7}")
    if not RT_AMR_NSUB[0] <= nsub <= RT_AMR_NSUB[1]:
        raise AssertionError(f"phase 60: {nsub} substeps, sized for "
                             f"{RT_AMR_NSUB}")
    v1 = sim.rt_amr.ionized_volume(sim)
    e1 = float(sim.totals()["energy"])
    for l in sim.levels():
        rad = sim.rt_amr.rad[l]
        if not (bool(torch.isfinite(rad).all())
                and bool((rad[:, 0] >= 0).all())):
            raise AssertionError(f"phase 60: level {l} rad not finite or "
                                 f"N < 0")
    x = sim.tree_order_cells(sim.rt_amr.xion[lmax], lmax)
    xc = sim.tree.cell_centers(lmax, sim.boxlen)
    rr = np.sqrt(((xc - 0.5) ** 2).sum(axis=1))
    near = float(x[rr < 0.04].mean())
    far = float(x[(rr > 0.18) & (rr < 0.23)].mean())
    if not (v1 > 1.5 * v0 and e1 > e0 and near > 0.8 and far < 0.1):
        raise AssertionError(f"phase 60: ionized volume {v0} -> {v1}, "
                             f"energy {e0} -> {e1}, near {near} far {far}")
    octs = [sim.tree.noct(l) for l in sim.levels()]
    nmig, octs_mig, t_mig = _rt_forced_regrid(sim, RT_AMR_R_GROWN, "phase 60")
    # K8's entries and K9 on one substep's inputs as the migrated
    # hierarchy lays them out, against their plain versions
    e8, e9, held = _rt_recorded_substep(sim, "phase 60")
    # the 3-group He ladder at 64³ beside the uniform driver on the grid
    he = dict(rt_ngroups=3, rt_y_he=0.25, rt_t_star=1e5)
    t_he = time.perf_counter()
    asim = AmrSim(_rt_amr_params(RT_HE_LEVEL, RT_HE_LEVEL, RT_HE_TEND, **he))
    _reset_counts()
    asim.evolve(RT_HE_TEND, nstepmax=3)
    usim = Simulation(_rt_amr_params(RT_HE_LEVEL, RT_HE_LEVEL, RT_HE_TEND,
                                     **he))
    usim.evolve()
    torch.cuda.synchronize()
    he_launches = _counts()
    t_he = time.perf_counter() - t_he
    v_amr = asim.rt_amr.ionized_volume(asim)
    v_uni = float(usim.rt.sim.x.sum()) * usim.dx ** 3
    xhe2 = float(asim.rt_amr.xhe[RT_HE_LEVEL][:, 0].max())
    if not (v_amr > 0.05 and v_uni > 0.05
            and abs(v_amr - v_uni) < 0.35 * max(v_amr, v_uni)
            and xhe2 > 1e-3):
        raise AssertionError(f"phase 60 He ladder: AMR {v_amr} uniform "
                             f"{v_uni}, max xHeII {xhe2}")
    he8, he9, he_held = _rt_recorded_substep(asim, "phase 60 He")
    _print(f"phase 60 RT on the hierarchy on {card}: the refined front "
           f"(tests/test_rt_amr.py set-up at levelmin {lmin} / levelmax "
           f"{lmax}, r_refine {RT_AMR_R}, d_region 10, f32 gas), octs "
           f"{octs}, {len(stepped)} coarse steps, {nsub} substeps; "
           f"launches K1 {launches['fused_muscl']} K3 "
           f"{launches['tile_sweep']} K8 dense {launches['rt_m1']} block "
           f"{launches['rt_m1_block']} K9 {launches['rt_chem']} K7 0 (as "
           f"the levels require); ionized volume {v0:.4e} -> {v1:.4e}, gas "
           f"energy {e0:.6e} -> {e1:.6e}, level {lmax} near {near:.4f} far "
           f"{far:.4f}; built in {t_build:.3f} s (host tree and maps), "
           f"evolved in {wall:.3f} s; r_refine grown to {RT_AMR_R_GROWN} "
           f"and regridded in {t_mig:.3f} s: {nmig} levels migrated "
           f"through apply_migration, octs {octs_mig}, K7 0, rows finite "
           f"with N >= 0.  3-group He at {2 ** RT_HE_LEVEL}³ "
           f"({t_he:.3f} s): "
           f"AMR {v_amr:.4e}, uniform {v_uni:.4e} (rel "
           f"{abs(v_amr - v_uni) / max(v_amr, v_uni):.4f} of the 0.35 "
           f"bound), max xHeII {xhe2:.4f}")
    _print(f"phase 60 K8 and K9 on one substep's inputs as the hierarchy "
           f"lays them out (level entry [shape]), against their plain "
           f"versions: after the regrid {held}; He {he_held}; K8 max abs "
           f"err {max(e8, he8):.3e} (tolerance {K8_REL:g} × stencil max), "
           f"K9 max abs err {max(e9, he9):.3e} (rel {K9_REL:g})")
    out = {k: launches[k] + he_launches[k] for k in launches}
    out.update(k8_err=max(e8, he8), k9_err=max(e9, he9))
    del sim, asim, usim
    torch.cuda.empty_cache()
    return out


def _rt_phases(dev, card: str) -> dict:
    """Phases 57-60; returns the K8 and K9 rows and the K1/K3 launches of
    their main paths."""
    import shutil
    import tempfile
    marks = [time.perf_counter()]
    k = _rt_kernel_phase(dev, card)
    marks.append(time.perf_counter())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rt_")
    try:
        s = _stromgren_phase(dev, card, tmp)
        marks.append(time.perf_counter())
        cli = _rt_cli_phase(card, tmp)
        marks.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    amr = _rt_amr_phase(dev, card)
    marks.append(time.perf_counter())
    _print("phases 57-60 wall: " + ", ".join(
        f"{57 + i} {b - a:.1f} s" for i, (a, b) in enumerate(
            zip(marks, marks[1:]))))
    n = {key: s["launches"][key] + cli[key] + amr[key]
         for key in s["launches"]}
    err = {"rt_m1": max(k["k8_err"], s["k8"]["max_abs_err"], amr["k8_err"]),
           "rt_chem": max(k["k9_err"], s["k9"]["max_abs_err"],
                          amr["k9_err"])}
    rows = []
    for name, src, replaces, r, err, launched in (
            ("rt_m1", "rt_m1.cu",
             "ramses_tpu/rt/m1.py:81 (transport_step, and rt/amr.py:63 "
             "_glf_block; fused by XLA, no pallas_call)", s["k8"],
             err["rt_m1"], n["rt_m1"] + n["rt_m1_block"]),
            ("rt_chem", "rt_chem.cu",
             "ramses_tpu/rt/chem.py:179 (chem_step, and :92 "
             "chem_step_3ion; fused by XLA, no pallas_call)", s["k9"],
             err["rt_chem"], n["rt_chem"])):
        rows.append({"name": name, "route": "cuda",
                     "source": f"ramses_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": err, "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    return dict(rows=rows, fused_muscl=n["fused_muscl"],
                tile_sweep=n["tile_sweep"])


# ---------------------------------------------------------------------------
# phases 61-63: the clump finder's watershed (K10), mergertree.nml and the
# lightcone
# ---------------------------------------------------------------------------

MT_NML = os.path.join(ROOT, "namelists", "mergertree.nml")
# phase 61: K10 against its plain version on these fields (name, shape,
# kind: uniform noise, the noise quantised to four levels, a few periodic
# Gaussian peaks), each at thresholds that cut off none, half and nearly
# all (99 %) of the cells; timed at the half threshold
K10_CASES = (("random 64³", (64, 64, 64), "random"),
             ("random 256²", (256, 256), "random"),
             ("random 256³", (256, 256, 256), "random"),
             ("plateau 64³", (64, 64, 64), "plateau"),
             ("plateau 256³", (256, 256, 256), "plateau"),
             ("smooth 128³", (128, 128, 128), "smooth"))
# phase 62: mergertree.nml's own clump finder, AMR, refinement and cosmology
# keys, on a P(k) ∝ k⁻² Gaussian δ of MT_SIGMA rms per level-6 cell at
# a = 0.02 (default_rng(MT_SEED)), written by the port.  At 0.3 rms the
# shipped thresholds (density 80, mass 10 particles) keep 3, 10 and 22
# halos at a = 0.1, 0.12 and 0.14 (phase 62 on an H100).
# Cuts: aout 0.1, 0.2, ..., 1.0 (10 outputs) to MT_AOUT, so that three
# outputs come within ~30 coarse steps (nremap=50 then never regrids after
# the initial refinement); nstepmax MT_NSTEPMAX as a guard
MT_SIGMA, MT_SEED = 0.3, 1
MT_AOUT = (0.1, 0.12, 0.14)
MT_NSTEPMAX = 200
# phase 63: config 5 (phase 39's cosmo.nml at 128³ on its ICs) with the
# lightcone, full sky, zmax_cone 1000, for CONE_STEPS coarse steps.
# cosmo.nml sets no boxlen_ini, so its box is boxlen = 1 Mpc/h and a step's
# shell lies ~5,150 box lengths away (~1e8 periodic replicas, each a pass
# over the 2,097,152 particles); set in code, boxlen_ini = CONE_BOX Mpc/h
# (the ICs written at that size) puts it 0.52 box lengths away, in the box
# and the replicas beside it (at 3,000 Mpc/h, 1.7 box lengths: 160
# replicas, each a pass over every particle)
CONE_STEPS, CONE_BOX = 5, 10000.0


def _k10_field(kind: str, shape, seed: int):
    """Phase 61's density (float64 on the host): ``random`` uniform noise,
    ``plateau`` the noise quantised to four levels, ``smooth`` four periodic
    Gaussian peaks (σ 0.08 box) over a floor."""
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


def _k10_chains(rho, thr: float, nd: int):
    """(links followed, the longest chain) by the cells above ``thr`` on
    their way to their peaks: the chase's data-dependent work."""
    import torch
    from ramses_tpu_torch.pm import clumps
    parent = clumps.steepest_parent(rho, nd).reshape(-1)
    cur = torch.nonzero((rho > thr).reshape(-1)).reshape(-1)
    links = longest = 0
    while cur.numel():
        nxt = parent[cur]
        moving = nxt != cur
        n = int(moving.sum())
        if not n:
            break
        links += n
        longest += 1
        cur = nxt[moving]
    return links, longest


def _k10_floor(shape) -> tuple:
    """(ms, text): the latency floor under K10 at ``shape``: an empty
    launch on its parents kernel's grid (one block a tile: 16 x 16 x 4
    cells in 3D, 32 x 32 in 2D, 1,024 in 1D, as ``csrc/watershed.cu``'s
    Tile) and one on its labels kernel's (1,024 cells a block), device ms
    each."""
    import math

    from ramses_tpu_torch.pm import clumps
    tile = {1: (1024,), 2: (32, 32), 3: (4, 16, 16)}[len(shape)]
    grids = (math.prod(-(-n // t) for n, t in zip(shape, tile)),
             -(-math.prod(shape) // 1024))
    lib = clumps._library()
    parts = [_empty_ms(lib, "ramses_watershed_empty",
                       "watershed_empty_kernel", b) for b in grids]
    return sum(parts), (f"the latency floor {sum(parts):.4f} ms (empty "
                        f"launches on its {grids[0]} and {grids[1]} blocks "
                        f"{parts[0]:.4f} + {parts[1]:.4f})")


def _k10_check(rho, thr: float, nd: int, what: str):
    """K10 against its plain version on one field and threshold: labels
    bitwise; returns the max |K10 - plain| (0)."""
    import torch
    from ramses_tpu_torch.pm import clumps
    got = clumps.watershed(rho, thr, nd)
    want = clumps.watershed_ref(rho, thr, nd)
    torch.cuda.synchronize()
    if got.dtype != torch.int64 or not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K10 disagrees with its plain version on "
                             f"{what} (threshold {thr!r}): {bad} labels of "
                             f"{got.numel()}")
    return float((got - want).abs().max())


def _watershed_kernel_phase(dev, card: str, ptxas: str) -> dict:
    """Phase 61: K10 bitwise against ``watershed_ref`` on the card on
    random, plateau and smooth fields at three thresholds each, timed
    beside its plain version and its bound; ``ptxas``: the registers and
    spills of its build."""
    import numpy as np
    import torch
    from ramses_tpu_torch.pm import clumps
    rows, err = {}, 0.0
    for i, (name, shape, kind) in enumerate(K10_CASES):
        host = _k10_field(kind, shape, 61 + i)
        rho = torch.from_numpy(host).to(dev)
        nd = len(shape)
        # just under the quantiles, so that a plateau at one is kept
        thrs = (float(host.min()) - 1.0, float(np.median(host)) - 1e-9,
                float(np.quantile(host, 0.99)) - 1e-9)
        for thr in thrs:
            err = max(err, _k10_check(rho, thr, nd, name))
        thr = thrs[1]

        def call():
            return clumps.watershed(rho, thr, nd)
        # a call's wall on the stream (CUDA events: with the device idle,
        # the host's enqueue of the call), and the device time of its two
        # kernels (the profiler; where it lost a kernel's records, the
        # queued events of whole calls, which hold both)
        call_ms = _median_ms(call)
        lost = len(PROFILER_LOST)
        parts = [_device_ms(call, k, launched=lambda: clumps.launches)
                 for k in ("parents_kernel", "labels_kernel")]
        ms = max(parts) if len(PROFILER_LOST) > lost else sum(parts)
        big = rho.numel() > 2 ** 22
        plain_ms = _median_ms(lambda: clumps.watershed_ref(rho, thr, nd),
                              reps=5 if big else 20, warm=1 if big else 3)
        links, longest = _k10_chains(rho, thr, nd)
        ncell = rho.numel()
        floor, floor_text = _k10_floor(shape)
        # rho read once, the labels written once; a cell's 3^nd - 1
        # comparisons and its threshold test, and a comparison a link
        b = _rt_bound(16.0 * ncell, ncell * 3 ** nd + links)
        rows[name] = dict(b, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                          links=links, longest=longest, ncell=ncell,
                          floor_ms=floor)
        _print(f"phase 61 K10 {name} ({kind}, f64): bitwise at thresholds "
               f"{[f'{t:.4g}' for t in thrs]}; at the median: "
               + _rt_timing(rows[name])
               + f" (device: parents {parts[0]:.4f} + labels {parts[1]:.4f}"
               f" ms; a call's wall on the stream {call_ms:.4f} ms); "
               f"{floor_text}; {links} links followed (longest chain "
               f"{longest})")
        del rho
    _print(f"phase 61 K10's build: {ptxas or 'not rebuilt in this run'}")
    torch.cuda.empty_cache()
    return dict(rows=rows, max_abs_err=err)


def _mt_text(aout) -> str:
    """mergertree.nml with phase 62's cuts (``aout``, ``noutput``,
    ``nstepmax``); its other keys as shipped."""
    import re
    text = open(MT_NML).read()
    for key in ("relevance_threshold=3", "density_threshold=80",
                "saddle_threshold=200", "mass_threshold=10", "nx_clump=64",
                "unbind=.true.", "saddle_pot=.true.", "nmassbins=100",
                "levelmin=6", "levelmax=9", "clumpfind=.true.",
                "nremap=50", "m_refine=8.0"):
        if key not in text:
            raise AssertionError(f"mergertree.nml no longer holds {key}")
    text = re.sub(r"aout=[0-9.,]+", "aout=" + ",".join(map(str, aout)),
                  text)
    text = re.sub(r"noutput=\d+", f"noutput={len(aout)}", text)
    return text.replace("&RUN_PARAMS", f"&RUN_PARAMS\nnstepmax={MT_NSTEPMAX}",
                        1)


def _clump_table(path: str):
    """The rows of a ``clump_NNNNN.txt`` as [n, 12] (none: [0, 12])."""
    import numpy as np
    rows = np.loadtxt(path, ndmin=2)
    return rows.reshape(-1, 12)


def _mergertree_phase(dev, card: str, tmp: str) -> dict:
    """Phase 62: mergertree.nml through the CLI in process on the card,
    three outputs, each output's K10 labels held to the plain version on
    the deposit the run built; then a restart from the second output.
    Returns the launches."""
    import shutil

    import numpy as np
    import torch
    from ramses_tpu_torch.amr import device_regrid
    from ramses_tpu_torch.amr import hierarchy as H
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.driver import build_namelist_sim
    from ramses_tpu_torch.pm import clumps
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    from ramses_tpu_torch.utils import halos
    run_dir = os.path.join(tmp, "mergertree")
    os.makedirs(run_dir)
    pos = _gaussian_ics(os.path.join(run_dir, "grafic_files"), 64, MT_SIGMA,
                        MT_SEED)
    nml = os.path.join(run_dir, "mergertree.nml")
    with open(nml, "w") as f:
        f.write(_mt_text(MT_AOUT))
    # every watershed of the run: its input (the deposit the run built, on
    # the card) and K10's labels
    recorded = []
    watershed = clumps.watershed

    def recording(rho, threshold, ndim):
        out = watershed(rho, threshold, ndim)
        recorded.append((rho, float(threshold), ndim, out.clone()))
        return out
    clumps.watershed = recording
    steps, stepped = [], []
    step_coarse = H.AmrSim.step_coarse

    def logged(self, dt):
        spec = self._fused_spec()
        stepped.append((spec.levels, spec.complete, spec.blocked))
        t0 = time.perf_counter()
        step_coarse(self, dt)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    acc, restore = _timed_parts({
        "pass": (H.AmrSim, "_clumpfind_pass"),
        "catalogue": (halos, "catalogue_from_arrays"),
        "find_clumps": (halos, "find_clumps"),
        "K10": (clumps, "watershed"),
        "unbinding": (halos, "build_catalogue")})
    H.AmrSim.step_coarse = logged
    params = load_params(nml, ndim=3)
    params.init.initfile = [os.path.join(run_dir, "grafic_files")]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        sim = build_namelist_sim(H.AmrSim, params, None, torch.float32,
                                 None)
        for i, a in enumerate(MT_AOUT, 1):
            sim.evolve(float(sim.cosmo.tau_of_aexp(a)),
                       nstepmax=MT_NSTEPMAX)
            sim.dump(i, run_dir, namelist_path=nml)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        H.AmrSim.step_coarse = step_coarse
        restore()
        clumps.watershed = watershed
    launches = _counts()
    k7 = device_regrid.launches
    nout = len(MT_AOUT)
    outs = [os.path.join(run_dir, f"output_{i:05d}")
            for i in range(1, nout + 1)]
    # the files of every output, under its manifest
    for i, out in enumerate(outs, 1):
        want = [f"clump_{i:05d}.txt", f"clump_cat_{i:05d}.npz"]
        if i > 1:
            want.append(f"mergertree_{i:05d}.txt")
        ok, why = (ckpt.validate_checkpoint(out) if os.path.isdir(out)
                   else (False, "missing"))
        man = (open(os.path.join(out, "manifest.json")).read() if ok
               else "")
        if not ok or any(w not in man for w in want):
            raise AssertionError(f"phase 62 {out}: {why}; manifest holds "
                                 f"{[w for w in want if w in man]} of {want}")
    if launches["watershed"] != nout or len(recorded) != nout:
        raise AssertionError(f"phase 62: K10 launched {launches['watershed']}"
                             f" times ({len(recorded)} recorded) for {nout} "
                             f"outputs")
    want = _cosmo_want(stepped, sim.lmin)
    sweeps = ("fused_muscl", "tile_sweep", "oct_sweep")
    if any(launches[key] != want[key] for key in sweeps) \
            or len(stepped) != sim.nstep:
        raise AssertionError(f"phase 62: launches {launches} where the "
                             f"{sim.nstep} coarse steps' levels require "
                             f"{ {key: want[key] for key in sweeps} }")
    # each output's K10 labels against the plain version on that output's
    # own deposit
    err = 0.0
    for k, (rho, thr, nd, got) in enumerate(recorded, 1):
        want = clumps.watershed_ref(rho, thr, nd)
        if rho.dtype != torch.float64 or rho.shape != (64, 64, 64) \
                or not torch.equal(got, want):
            raise AssertionError(f"phase 62 output {k}: K10's labels on the "
                                 f"run's deposit {tuple(rho.shape)} "
                                 f"{rho.dtype} differ from the plain "
                                 f"version's")
        err = max(err, float((got - want).abs().max()))
    # K10 on the last output's own 64³ deposit: device ms of its two
    # kernels (profiler) and a call's wall on the stream (CUDA events)
    rho, thr, nd, _ = recorded[-1]
    k10_parts = [_device_ms(lambda: clumps.watershed(rho, thr, nd), k,
                            launched=lambda: clumps.launches)
                 for k in ("parents_kernel", "labels_kernel")]
    k10_call = _median_ms(lambda: clumps.watershed(rho, thr, nd))
    k10_text = (f"K10 on output {nout}'s deposit (threshold {thr:.4g}, "
                f"{int((rho > thr).sum())} cells above): device "
                f"{sum(k10_parts):.4f} ms (parents {k10_parts[0]:.4f} + "
                f"labels {k10_parts[1]:.4f}), a call's wall on the stream "
                f"{k10_call:.4f} ms, {_k10_floor(tuple(rho.shape))[1]}")
    del rho
    tables = [_clump_table(os.path.join(o, f"clump_{i:05d}.txt"))
              for i, o in enumerate(outs, 1)]
    nhalo = [len(t) for t in tables]
    act = sim.p.active
    mtot = float(sim.p.m.double()[act].sum())
    bound = [float(t[:, 2].sum()) for t in tables]
    if not all(n > 0 for n in nhalo) or max(bound) > mtot:
        raise AssertionError(f"phase 62: halos by output {nhalo}, bound mass "
                             f"{bound} of {mtot}")
    tree = np.loadtxt(os.path.join(outs[-1], f"mergertree_{nout:05d}.txt"),
                      ndmin=2)
    top = int(tables[-1][0, 0])
    main = tree[(tree[:, 0] == nout - 1) & (tree[:, 1] == top)
                & (tree[:, 6] == 1)]
    if len(main) != 1 or int(main[0, 2]) != nout - 2:
        raise AssertionError(f"phase 62: the largest halo {top} of the last "
                             f"output has main links {main.tolist()}")
    # restart from the second output (the nrestart=2 path): the tree
    # rebuilt from the persisted catalogues
    rdir = os.path.join(tmp, "mergertree_restart")
    os.makedirs(rdir)
    for name in ("output_00001", "output_00002"):
        shutil.copytree(os.path.join(run_dir, name),
                        os.path.join(rdir, name))
    _reset_counts()
    t0 = time.perf_counter()
    back = build_namelist_sim(H.AmrSim, params,
                              os.path.join(rdir, "output_00002"),
                              torch.float32, None)
    nstep0 = back.nstep
    back.evolve(float(back.cosmo.tau_of_aexp(MT_AOUT[-1])),
                nstepmax=MT_NSTEPMAX)
    back.dump(nout, rdir, namelist_path=nml)
    torch.cuda.synchronize()
    rwall = time.perf_counter() - t0
    rlaunch = _counts()
    # the CLI starts the namelist on the card (cut to 2 coarse steps; a
    # hierarchy's CLI run writes its one output at its end)
    cdir = os.path.join(tmp, "mergertree_cli")
    os.makedirs(cdir)
    os.symlink(os.path.join(run_dir, "grafic_files"),
               os.path.join(cdir, "grafic_files"))
    cnml = os.path.join(cdir, "mergertree.nml")
    with open(cnml, "w") as f:
        f.write(_mt_text(MT_AOUT).replace(f"nstepmax={MT_NSTEPMAX}",
                                          "nstepmax=2"))
    _reset_counts()
    cli, cwall = _cli_in_process([cnml, "--ndim", "3"], cdir)
    claunch = _counts()
    cout = os.path.join(cdir, "output_00001")
    if cli.nstep != 2 or claunch["watershed"] != 1 or not os.path.exists(
            os.path.join(cout, "clump_00001.txt")) \
            or not ckpt.validate_checkpoint(cout)[0]:
        raise AssertionError(f"phase 62 CLI: {cli.nstep} coarse steps, "
                             f"launches {claunch}, output "
                             f"{sorted(os.listdir(cdir))}")
    name = f"mergertree_{nout:05d}.txt"
    straight = open(os.path.join(outs[-1], name), "rb").read()
    again = open(os.path.join(rdir, f"output_{nout:05d}", name), "rb").read()
    rtree = np.loadtxt(os.path.join(rdir, f"output_{nout:05d}", name),
                       ndmin=2)
    rtop = int(_clump_table(os.path.join(
        rdir, f"output_{nout:05d}", f"clump_{nout:05d}.txt"))[0, 0])
    rmain = rtree[(rtree[:, 0] == nout - 1) & (rtree[:, 1] == rtop)
                  & (rtree[:, 6] == 1)]
    bitwise = straight == again
    if rlaunch["watershed"] != 1 or not (
            bitwise or (rtop == top and len(rmain) == 1
                        and rmain[0, 3] == main[0, 3])):
        raise AssertionError(f"phase 62 restart: K10 {rlaunch['watershed']}, "
                             f"{name} bitwise {bitwise}, largest halo {rtop} "
                             f"(straight {top}), main links "
                             f"{rmain.tolist()} (straight {main.tolist()})")
    n = max(nout, 1)
    split = {"deposit": acc["catalogue"] - acc["find_clumps"]
             - acc["unbinding"],
             "K10": acc["K10"], "merges": acc["find_clumps"] - acc["K10"],
             "unbinding": acc["unbinding"],
             "files": acc["pass"] - acc["catalogue"]}
    _print(f"phase 62 mergertree.nml on {card} (build_namelist_sim and "
           f"evolve as run_namelist, f32, a dump at each aout as the "
           f"reference writes its outputs; &CLUMPFIND, &AMR, &REFINE and "
           f"&COSMO as shipped; cuts: aout {list(MT_AOUT)} of 0.1..1.0, so "
           f"three outputs come within ~30 coarse steps, and "
           f"nstepmax={MT_NSTEPMAX} as a guard; 64³ ICs, {MT_SIGMA} rms, "
           f"min 1+δ {pos:.3f}): {sim.cosmo_line()} "
           f"in {wall:.3f} s, {sim.nstep} coarse steps "
           f"(median {statistics.median(steps):.4f} s); halos by output "
           f"{nhalo}, bound mass {[f'{b:.4e}' for b in bound]} of "
           f"{mtot:.6e}; the largest halo {top} of output {nout} has main "
           f"progenitor {int(main[0, 3])} in output {nout - 1} "
           f"({int(main[0, 4])} shared); launches {launches}, K7 {k7}; K10 "
           f"bitwise the plain version on each output's own deposit; "
           f"clump pass host s an output (synchronised): "
           + ", ".join(f"{k} {v / n:.4f}" for k, v in split.items())
           + f", in all {acc['pass'] / n:.4f}; restart from output 2 "
           f"(nrestart=2): {back.nstep - nstep0} coarse steps in "
           f"{rwall:.3f} s, "
           f"{name} bitwise the straight run's: {bitwise}"
           + ("" if bitwise else f" (main branch {top} <- "
              f"{int(rmain[0, 3])} as straight)")
           + f"; python -m ramses_tpu_torch mergertree.nml (nstepmax=2, in "
           f"process): {cwall:.3f} s, K10 {claunch['watershed']}; "
           + k10_text)
    del sim, back, cli, recorded
    torch.cuda.empty_cache()
    launches["max_abs_err"] = err
    launches["split"] = {k: v / n for k, v in split.items()}
    return launches


def _cone_config(initdir: str, outdir: str):
    """Config 5 (``_cosmo_config``) with the lightcone on, full sky,
    zmax_cone 1000 and boxlen_ini ``CONE_BOX``, writing into ``outdir``."""
    p = _cosmo_config(initdir)
    p.run.lightcone = True
    p.lightcone.zmax_cone = 1000.0
    p.lightcone.thetay_cone = p.lightcone.thetaz_cone = 90.0
    p.raw.setdefault("cosmo_params", {})["boxlen_ini"] = CONE_BOX
    p.output.output_dir = outdir
    return p


def _cone_shells(outdir: str, epochs: list, what: str) -> list:
    """The cones in ``outdir`` against the JAX test's checks: one a coarse
    step (``epochs``: its (a before, a after) each), each ``a_emit``
    between its step's two epochs, the shells tiling the lookback distance
    with no overlap beyond roundoff.  Returns the particles a shell."""
    import glob

    import numpy as np
    names = sorted(glob.glob(os.path.join(outdir, "cone_*.npz")))
    if len(names) != len(epochs):
        raise AssertionError(f"phase 63 {what}: {len(names)} cones for "
                             f"{len(epochs)} coarse steps")
    counts, ranges = [], []
    for name, (a0, a1) in zip(names, epochs):
        z = np.load(name)
        r, ae = z["r"], z["a_emit"]
        ok = (len(r) > 0 and z["pos"].shape == z["vel"].shape == (len(r), 3)
              and len(ae) == len(r) and float(z["aexp"]) == a1
              and bool((ae >= a0 - 1e-12).all())
              and bool((ae <= a1 + 1e-12).all()))
        if not ok:
            raise AssertionError(f"phase 63 {what} {name}: {len(r)} "
                                 f"particles, a_emit in [{ae.min()}, "
                                 f"{ae.max()}] for the step {a0} -> {a1}")
        counts.append(len(r))
        ranges.append((float(r.min()), float(r.max())))
    for (lo1, hi1), (lo0, hi0) in zip(ranges[1:], ranges[:-1]):
        if hi1 > lo0 + 1e-8:
            raise AssertionError(f"phase 63 {what}: shells overlap: "
                                 f"{ranges}")
    return counts


def _lightcone_phase(dev, card: str, tmp: str) -> dict:
    """Phase 63: config 5 with the lightcone for CONE_STEPS coarse steps,
    then a dump restored that emits its first shell.  Returns the
    launches."""
    import torch
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.driver import build_namelist_sim
    from ramses_tpu_torch.pm import lightcone as lc
    ics = os.path.join(tmp, "cone_ics")
    pos = _gaussian_ics(ics, 2 ** COSMO_LEVELS[0], COSMO_SIGMA, COSMO_SEED,
                        box=CONE_BOX)
    cone_dir = os.path.join(tmp, "cones")
    p = _cone_config(ics, cone_dir)
    sim = build_namelist_sim(AmrSim, p, None, torch.float32, None)
    epochs, ms = [], []
    emit = lc.emit_coarse_step

    def timed(s, outdir="."):
        a0 = s._cone_aexp_prev
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = emit(s, outdir=outdir)
        ms.append(1e3 * (time.perf_counter() - t0))
        epochs.append((a0, s.aexp_now()))
        return out
    lc.emit_coarse_step = timed
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        sim.evolve(float(sim.cosmo.tau_of_aexp(1.0)), nstepmax=CONE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        counts = _cone_shells(cone_dir, epochs, "run")
        npart = int(sim.p.active.sum())
        # a restore emits its first shell
        out = sim.dump(1, os.path.join(tmp, "cone_dump"))
        rdir = os.path.join(tmp, "cones_restored")
        back = AmrSim.from_snapshot(_cone_config(ics, rdir), out)
        seeded = back._cone_aexp_prev == back.aexp_now()
        epochs.clear()
        back.step_coarse(back.coarse_dt())
        rcount = _cone_shells(rdir, epochs, "restore")
    finally:
        lc.emit_coarse_step = emit
    if sim.nstep != CONE_STEPS or not seeded or \
            launches["fused_muscl"] != CONE_STEPS:
        raise AssertionError(f"phase 63: {sim.nstep} coarse steps, restore "
                             f"seeded {seeded}, launches {launches}")
    _print(f"phase 63 config 5 with the lightcone on {card} (cosmo.nml at "
           f"128³, {npart} particles, full sky, zmax_cone 1000; cut: "
           f"boxlen_ini {CONE_BOX:g} Mpc/h set in code, the ICs written at "
           f"that size (min 1+δ {pos:.3f}), because cosmo.nml's 1 Mpc/h box "
           f"puts a step's shell ~5,150 box lengths away, ~1e8 replicas): "
           f"{CONE_STEPS} "
           f"coarse steps in {wall:.3f} s, one cone a step, shells tiling "
           f"the lookback distance, each a_emit between its step's epochs; "
           f"particles a shell {counts}; emission host ms a step "
           f"{[round(m, 1) for m in ms[:CONE_STEPS]]}; launches {launches}; "
           f"the restore from a dump emits its first shell "
           f"({rcount[0]} particles, {ms[-1]:.1f} ms)")
    del sim, back
    torch.cuda.empty_cache()
    return launches


def _clump_phases(dev, card: str, ptxas: str) -> dict:
    """Phases 61-63; returns the K10 row and the K1/K3 launches of their
    main paths.  ``ptxas``: K10's build report (registers, spills)."""
    import shutil
    import tempfile
    marks = [time.perf_counter()]
    k = _watershed_kernel_phase(dev, card, ptxas)
    marks.append(time.perf_counter())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_clumps_")
    try:
        mt = _mergertree_phase(dev, card, tmp)
        marks.append(time.perf_counter())
        cone = _lightcone_phase(dev, card, tmp)
        marks.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _print("phases 61-63 wall: " + ", ".join(
        f"{61 + i} {b - a:.1f} s" for i, (a, b) in enumerate(
            zip(marks, marks[1:]))))
    r = k["rows"]["random 64³"]
    row = {"name": "watershed", "route": "cuda",
           "source": "ramses_tpu_torch/csrc/watershed.cu",
           "replaces": "ramses_tpu/pm/clumps.py:28 (steepest_parent, :50 "
                       "_pointer_jump and :64 watershed; fused by XLA, no "
                       "pallas_call)",
           "launches": mt["watershed"] + cone["watershed"],
           "max_abs_err": max(k["max_abs_err"], mt["max_abs_err"]),
           "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
           "library_ms": None}
    return dict(row=row, fused_muscl=mt["fused_muscl"] + cone["fused_muscl"],
                tile_sweep=mt["tile_sweep"] + cone["tile_sweep"])


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
    # the script's wall by group of phases, for its time limit
    marks = [("start", time.perf_counter())]

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

    marks.append(("1-6", time.perf_counter()))
    # ---- 7-11. the AMR slice ----
    err7, oct_rows, rate8, k7 = _amr_phases(dev, card)
    k1["max_abs_err"] = max(k1["max_abs_err"], err7)

    marks.append(("7-11", time.perf_counter()))
    # ---- 12-17. the MHD slice ----
    k4 = _mhd_phases(dev)

    marks.append(("12-17", time.perf_counter()))
    # ---- 18-21. MHD on the AMR hierarchy ----
    k4_amr, err18 = _mhd_amr_phases(dev)
    k4["launches"] += k4_amr
    k4["max_abs_err"] = max(k4["max_abs_err"], err18)

    marks.append(("18-21", time.perf_counter()))
    # ---- 22-26. the MC tracers on the hydro hierarchy ----
    flux_rows = _tracer_phases(dev)

    marks.append(("22-26", time.perf_counter()))
    # ---- 27. the remaining hydro options: detente.nml ----
    _options_phase(dev)

    marks.append(("27", time.perf_counter()))
    # ---- 28-30. the slab-sharded paths: K5 and K1's padded entry ----
    parallel_rows = _parallel_phases(dev)

    marks.append(("28-30", time.perf_counter()))
    # ---- 31-34. self-gravity: config 3 and config 2 with gravity ----
    _gravity_phases(dev, card)

    marks.append(("31-34", time.perf_counter()))
    # ---- 35-38. snapshots, restarts and supervised runs ----
    _restart_phases(dev, card)

    marks.append(("35-38", time.perf_counter()))
    # ---- 39-43. particles and cosmology: config 5 ----
    cfg5 = _cosmo_phases(dev, card)
    k1["launches"] += cfg5["fused_muscl"]
    for r in oct_rows:
        if r["name"] == "tile_sweep":
            r["launches"] += cfg5["tile_sweep"]

    marks.append(("39-43", time.perf_counter()))
    # ---- 44-49. the coarse-step source passes ----
    src = _source_phases(dev, card)
    k1["launches"] += src["fused_muscl"]
    k4["launches"] += src["ct_step_slab"]
    for r in oct_rows + flux_rows:
        if r["name"] in ("tile_sweep", "fused_muscl_flux"):
            r["launches"] += src[r["name"]]
    marks.append(("44-49", time.perf_counter()))
    # ---- 50-54. cooling (K6), star formation, stellar objects ----
    cool = _cooling_phases(dev, card)
    k1["launches"] += cool["fused_muscl"]
    for r in oct_rows:
        if r["name"] == "tile_sweep":
            r["launches"] += cool["tile_sweep"]
    marks.append(("50-54", time.perf_counter()))
    # ---- 55-56. the device migrate (K7) and non-cubic roots ----
    rg = _regrid_phase(dev, card, _ptxas_report(logs.get("regrid_maps", "")))
    rg["row"]["launches"] = k7
    nc = _noncubic_phases(dev, card, rg, rate8)
    k1["launches"] += nc["fused_muscl"]
    for r in oct_rows:
        if r["name"] == "tile_sweep":
            r["launches"] += nc["tile_sweep"]
    marks.append(("55-56", time.perf_counter()))
    # ---- 57-60. radiative transfer: K8 and K9 ----
    rt = _rt_phases(dev, card)
    k1["launches"] += rt["fused_muscl"]
    for r in oct_rows:
        if r["name"] == "tile_sweep":
            r["launches"] += rt["tile_sweep"]
    marks.append(("57-60", time.perf_counter()))
    # ---- 61-63. the clump finder (K10), mergertree.nml, the lightcone ----
    cl = _clump_phases(dev, card, _ptxas_report(logs.get("watershed", "")))
    k1["launches"] += cl["fused_muscl"]
    for r in oct_rows:
        if r["name"] == "tile_sweep":
            r["launches"] += cl["tile_sweep"]
    marks.append(("61-63", time.perf_counter()))
    phase_walls = {}
    for (t0, _), (t1, ph) in zip(PHASE_MARKS, PHASE_MARKS[1:]):
        phase_walls[ph] = phase_walls.get(ph, 0.0) + t1 - t0
    _print("wall by phase (from the phase's previous line): " + ", ".join(
        f"{ph} {w:.1f}" for ph, w in phase_walls.items() if w >= 1.0))
    _print("script wall by phases: " + ", ".join(
        f"{label} {t - t0:.1f} s" for (_, t0), (label, t)
        in zip(marks, marks[1:]))
        + f"; total {marks[-1][1] - marks[0][1]:.1f} s")
    if PROFILER_LOST:
        _print("timing: the profiler lost these kernels' records in every "
               "window; their ms are queued CUDA events: "
               + "; ".join(PROFILER_LOST))
    _print(json.dumps({"kernels": [k1] + oct_rows + [k4] + flux_rows
                       + parallel_rows + [cool["row"], rg["row"]]
                       + rt["rows"] + [cl["row"]]}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
