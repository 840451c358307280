#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hidenn_fem_tpu_torch``) on one CUDA
card, the quickest proof that the port still starts on the GPU.

Run from the repository root:  ``python3 chip_smoke.py``

Phases (each raises on failure, and the script then exits non-zero):

1. Environment: CUDA is required; prints the card's name and power limit
   and checks that TF32 is off.
2. Build: compiles every ``hidenn_fem_tpu_torch/csrc/*.cu`` for sm_90a,
   one nvcc each, in parallel (into ``hidenn_fem_tpu_torch/csrc/build/``).
3. Kernel vs plain at full size, timed in turns plain, kernel, kernel,
   plain:
   a. the gather route on the 922K-class plate
      (``generate_mesh(nx=961, ny=481, keep_dead_nodes=True)``, three
      reference holes: 852,676 elements; lattice and banded tables
      stripped, so the gather route is what runs): K1, K2 and
      ``incidence_sum`` against their plain versions, and the energy with
      both gradient groups on the kernel path against the plain path;
   b. the lattice route on the same plate (zigzag; sel, t1 and t2 all in
      use): K6 and K7 against their plain versions, and the lattice-route
      energy and both gradient groups on the kernel path against the
      plain path;
   c. the hole-free 961x481 "up" ``StructuredGridP1`` (uniform diagonal,
      ``quad_mask`` as presence): K6 and K7 against their plain versions;
   d. the banded route on the 898K Delaunay plate
      (``generate_mesh_delaunay(lc=0.00218)``, three reference holes:
      898,032 elements): K3, K4 and K5 (over the recompute windows and
      over the two-pass windows, the two fallbacks; one launch each)
      against their plain versions on the paired (k=4), triangle (k=3)
      and strip (k=6) tables, with the registers and CTAs per SM of K4
      and K5; then the
      banded-route energy with both gradient groups against the flat
      gather route (banded stripped: K1, K2, ``incidence_sum``) on the
      same mesh, timed in turns;
   e. the windowed-gather probe K8 on the RCM-reordered hole-free
      961x481 plate (921,600 elements) at sub-blocks of 64 and 128:
      against its plain version and the flat-gather sum, and the same
      kernel over flat (absolute) index tables, all timed.
   f. K6 and K7 over 2, 3 and 4 row windows (the ranks' split of
      ``parallel/sharded_slab.py``) and over windows of 1, 4 and 6 rows at
      both ends and inside, on the 922K-class plate and the 961x481 grid:
      K6 writes into a NaN-filled output, each window's gradient rows
      equal the whole-lattice K6's bit for bit and every other row is
      +0.0, K6's window energy equals K7's, the window energies of each
      split sum to the whole within ROWS_SUM_RTOL, each window against its
      plain versions; K6 over a window, K6 whole and K7 over a window are
      one device kernel a call (the profiler's counts), and K6 and K7 over
      window 1 of 4 are printed beside the parent's (PARENT_ROWS_US), K6's
      beside the zero fill it no longer launches, K7's beside the launch
      floor (an empty kernel with K7's grid);
   g. K4 and K5 on each rank slice of the 898K plate's paired tables
      rebanded for 4 ranks (``reband_for_shards``), launched in turn: the
      rows placed at row_start equal the unsharded K4/K5 rows bit for bit,
      K4 and K5 writing into NaN-filled outputs (+0.0 outside the slice),
      K5 = ct x K4 bit for bit, the slice energies sum to the whole within
      ROWS_SUM_RTOL; K4 and K5 on a slice and K4 on the whole tables one
      device kernel a call; K4 on slice 1 of the same tables cut into each
      of 1, 2, 4, 8 and 16 slices that their block counts allow (device
      µs, blocks, waves of the card's resident CTAs); K5 on slice 1 of 4
      and on the whole tables at 1, 4 and 8 threads a node (bit-equal);
      slice 1 of 4 beside the parent's split.
   h. the compact L-BFGS's two passes over its [2m, P] float32 history
      (``ops/lbfgs_history.py``: the dots SY [y, s, g] and the
      combination gamma g + coef^T SY) at the shapes of the 898K plate
      (m = 100, P = 1,803,696: the kernels' JSON entries), example 4,
      the 922K-class plate and example 6 (m = 10), each against its plain
      version per entry (HISTORY_RTOL of the same sum over absolute
      values), two launches bit-equal, timed in turns against the plain
      versions and one library call each (``torch.mm(SY, V)`` on a
      stacked V, ``coef @ SY``); the example-4 shape also in float64.
   Each kernel is also profiled (``torch.profiler``, 20 calls): its device
   µs per call by kernel name, beside its bound (``bound``: bytes over
   3.35 TB/s or flops over 67 TFLOP/s, whichever is larger) and, for the
   node sums, one ``index_add_`` of the same cotangents (beside K5, of
   the forward rows' cotangents).  K4 is held bit for bit to itself over
   two launches and to K5 over the recompute windows (K5 = ct x K4), K5
   over the two-pass windows to K5 over the recompute windows, and K4's
   energy to K3's; K6's energy to K7's.
4. Example 4 on its default route, the lattice route: 600 ``run_lbfgs``
   steps from u0 = 1e-5 N(0,1) (``np.random.default_rng(0)``), K6 on
   every step; the final energy against the JAX package's lattice-route
   value for the same init; then the energy under ``torch.no_grad()``
   (K7), held to the solve's last loss.
5. Example 4 on the gather route (lattice stripped), 600 steps, K1, K2
   and ``incidence_sum``; final energy against the JAX gather-route value.
6. Example 6 (``examples/example6_structured_torch.py``): the 1000x500
   structured plate with holes, 600 L-BFGS steps (history 10) on K6; the
   energy must fall and the von Mises stress be finite and positive; the
   energy at step 25 against the JAX package's (the 600-step value
   against the spread of the reference runs; see ``EX6_COMPARE_STEP``).
7. Scale: 50 L-BFGS steps on the 922K-class plate, lattice route (K6).
8. The irregular-mesh path at full width: on the 898K Delaunay plate,
   ``PlaneStressEnergy`` on its default route (banded, paired tables),
   50 ``run_lbfgs`` steps from u0 = 1e-5 N(0,1), K4 on every step and K3
   for the energy under ``torch.no_grad()``; the energy at init and at
   step 25 against the JAX package's; von Mises.  Then 5 steps on each
   fallback, each a path of its own (no ownership intervals: K3 + K5 over
   the recompute windows; no recompute tables: K3 + K5 over the two-pass
   windows).
9. Hybrid at scale: ``generate_mesh_hybrid(lc=0.00209)`` (847,261
   elements): the hybrid-route energy and both gradient groups against
   the same mesh with the route stripped (gather route, K1/K2), then 10
   L-BFGS steps against the JAX package's.

10. The sharded paths (``hidenn_fem_tpu_torch/parallel``) as groups of
    ranks sharing the one card (spawned processes, ``rank_main``): a world
    of 1 on NCCL, then 2 and 4 ranks on gloo over ``cuda:0``, each running
    SHARDED_PATHS (the slab kernels over row windows on the 922K-class
    plate and the banded kernels with row_start on the rebanded 898K
    plate, each with 10 L-BFGS steps; the banded fallback without
    ownership intervals; the padded gather route and the lattice route on
    example 4; the lattice route on the 847K hybrid plate): every rank's
    values and history bit-equal across the ranks and within PERF.md
    section 2's limits of the single-rank run; ms per value-and-grad and
    per step printed as ranks sharing one card.  Each group also solves
    the 898K plate from rest by ``aux_pcg_solve_sharded`` (K4 at row_start
    each matvec and Jacobi probe, a replicated V-cycle on the level
    steps): solution
    and history bit-equal across the ranks, within 6 iterations and
    5e-3 x max|u| of the one-process ``aux_pcg_solve``.  Each group
    also solves example 9's 961x481 grid by ``mg_pcg_solve_sharded`` with
    both engines ("all": every level with 4 rows a rank padded and
    sharded; "replicated_coarse": the fine level only), from rest and from
    the noise start, to relres 1e-6: K6 over a row window on the sharded
    levels, one ``all_reduce`` a sharded level operator; solutions and
    histories bit-equal across the ranks, within 3 iterations of the card's
    one-process ``mg_pcg_solve`` and of JAX's and within 5e-4 x max|u| of
    the one-process solution (the JAX test's bounds), the ``all_reduce``
    calls equal to ``count_collectives``' census; ms and K6 / K6-row
    launches per call of the loop body by the slope between the two
    starts.  The one-rank NCCL group (captured) also prints the sharded
    MG "all"'s steady-state iteration (``sharded_mg_steady``): host ms,
    device busy, idle share, device kernels and port-kernel launches.

11. The CG family (``solve/linear.py``): a. example 8
    (``examples/example8_linear_solve_torch.py``: the 81x41 proxy plate on
    the lattice route, ``cg_solve`` to 1e-6 then 3 epochs of
    ``radapt_cg_solve``; K6 each matvec, K7 each energy) against the JAX
    package's energies, its residual plateau at or below JAX's; b. the
    898K Delaunay plate from u = 0 (banded route: K4 each matvec and
    probe, K3 each energy): ``color_nodes`` (proper, the numpy rounds'
    colors, JAX's count), ``jacobi_diagonal`` (finite, zero exactly on the
    Dirichlet rows), ``cg_solve`` and ``jacobi_pcg_solve`` capped at
    CG_CAP iterations, their energies against JAX's f32 and f64 values;
    ms per iteration and the stop test's read cost (profiler); c.
    ``minimize(method="cg")`` and ``minimize(method="jacobi_cg",
    mesh=...)`` on example 4 from u = 0: ``kind`` "relres", the same
    minimum, at or below the 600-step L-BFGS energy.
12. Multigrid (``solve/multigrid.py``): example 9
    (``examples/example9_multigrid_torch.py``: the hole-free 961x481
    ``StructuredGridP1``, 921,600 elements): the six-level hierarchy
    (lmax against JAX's), ``mg_pcg_solve`` to 1e-6 (the level steps every
    level operator, fractional weights on the coarse levels; K6 the
    right-hand side, K7 the energy), its
    energy against JAX's and against the port's own ``cg_solve`` of the
    same system on the card; ms and the level kernels' launches per
    MG-PCG iteration, exact;
    ``radapt_mg_solve`` for 2 epochs (the energies fall); then each level
    kernel on every level of the hierarchy against its plain version on
    the same seeded inputs (``level_kernels``; the same on the 898K
    plate's 513x257 aux background in phase 14b): the five level steps of
    K6's level epilogues within LEVEL_ATOL of the largest entry, the
    restriction bit for bit, the whole V-cycle and the bottom levels'
    one-CTA V-cycle within LEVEL_CYCLE_ATOL; each on a level above the
    bottom, and the bottom
    cycle, timed in turns against its plain version and profiled, with its
    kernel entry (bytes bound: LEVEL_NODE_BYTES).
13. Node-space L-BFGS (``solve/nodespace.py``) on example 4, 600 steps
    (K6 each step, K7 the energy at the solution): the final energy
    against the JAX package's node-space value and phase 4's params-space
    solve.
14. Auxiliary-space PCG (``solve/auxspace.py``): a. example 10
    (``examples/example10_auxspace_torch.py``, the 961x481 proxy plate,
    921,600 elements, lattice route: K6 each matvec) on the generic
    background (513x257, windowed P^T) and on the lattice-aligned one
    ("reshape", 961x481), each as the example runs it (set-up, cold and
    warm solves from its noise start; iterations and energy against
    JAX's) and from rest on the same preconditioner (energy against JAX
    at SOLVE_RTOL); b. the 898K Delaunay plate from rest (K4 each matvec
    and probe, the level steps each level operator, K3 the energy; flat
    P^T as JAX selects it); c. the 847K hybrid plate from rest ("reshape"
    with rim tables; the hybrid route launches no kernel, so the level
    steps of the V-cycle are the only launches, and its energies are
    counted exactly by ``losses.route_counts``), then example 12 at its
    own size; d. example 11 at its
    own size (gather route) and 2 epochs of ``radapt_aux_solve`` on its
    mesh (the energies fall, the pins stay).  Each solve from rest runs
    three times, the first building the aux plan on a copy of the
    preconditioner without one and the two others replaying it (bit for
    bit the first's answer), and counts its launches exactly (the level
    kernels: a V-cycle before the loop and each call of the loop body,
    ``solve_launches``; the fine kernel once and each call, the
    iterations rounded up to ``READ_EVERY``, and twice more in a replay's
    check) and prints its set-up seconds and ms per iteration.

15. Example 5 (``examples/example5_scaling_torch.py``) at its own size:
    the 1000x500 plate with the three holes (922,250 elements; the hole
    nodes dropped, so a renumbered lattice: the plain lattice route, as in
    the JAX package, and no kernel, which is checked), the slope-timed
    value-and-grad (qp/s) and two 200-step L-BFGS runs (cold, warm); the
    warm history against JAX's at init, step 25 and step 199.
16. The L-BFGS variants on example 4 (lattice route, K6 every
    value-and-grad), 50 steps each: the zoom line search
    (``linesearch="zoom"``) against JAX's ``run_lbfgs(linesearch="zoom")``
    at every step, with ms and value-and-grads per iteration; the
    two-loop mode (``mode="scan"``) against the compact mode.
17. Utils: ``solve_with_checkpointing`` on example 4 (compact L-BFGS, two
    chunks of 25), stopped after the first chunk and resumed, bit-equal to
    an uninterrupted run; ``check_gradients`` on the card.
18. Examples 1-3 (``examples/example{1,2,3}_torch.py``) at their own
    sizes (100 nodes and 500 Adam epochs; 25x25 and 5000 minibatch epochs
    of 1000 points; 89 nodes and 4000 epochs; plain torch, no kernel):
    example 1's final MSE within a factor 2 of JAX's, example 3's RMS error
    against the exact solution under 5e-4 and its final energy within
    2e-3 of JAX's, example 2's final MSE over all points within a factor
    2 of JAX's (other minibatch streams), then 100 epochs of example 2 on
    one numpy index table from one numpy init against JAX's f32 and f64
    losses at step 100; ms per epoch of each.
19. Point evaluation at full width: 10^6 points uniform in the bounding
    box of the 898K plate after phase 8's 50 steps (moved coordinates),
    ``locate_points`` (the bucket grid, on the card) and
    ``evaluate_at_points`` timed apart; NaN exactly outside the mesh,
    every point clear of the holes found and none inside one, a linear
    field reproduced to f32 rounding, the field at the element centroids
    equal to the vertex mean.
20. The native mesh loader (``mesh/native.py``): built with g++, then the
    whole 898K Delaunay plate (``generate_mesh_delaunay``) and its host
    tables alone (``TriMesh.from_arrays`` on its arrays) built with it and
    with ``HDNN_NO_NATIVE=1``, every table array-equal, the four host
    times printed.
21. The captured step (``solve/drivers.py``: the first call and a
    warm-up eager, then one CUDA graph a step, replayed) against the
    eager loop, from the same inputs, in turns eager, captured, captured,
    eager: example 4 on the lattice route (K6) and on the gather route
    (K1, K2, ``incidence_sum``), 600 steps each; example 6, 600 steps
    (history 10); the 898K Delaunay plate on the banded route (K4), 50
    steps.  Where the two eager runs are bit-equal the captured history
    and params must be too (else the first differing step is named and
    the run held to the f32 spread rule), every launch count equal; ms
    per step of each run, and the steady-state step of each mode
    profiled (wall, device busy, idle share).  Then the two-loop
    L-BFGS's reordered history copies at the 922K-class plate's size
    against one whole direction.
22. Figure parity (``tests/test_figure_parity.py`` on the card): the
    81x41 proxy plate with the reference numerics, 600 captured L-BFGS
    steps from u0 = 1e-5 N(0,1), against the reference implementation's
    run stored in ``tests/data/reference_snapshot_81x41.npz``: the final
    loss within rtol 2e-3, the peak von Mises stress within 2% and within
    one element diameter of the reference's, the displacement extrema
    within 2%, the median von Mises difference under 5% of the peak.

23. The linear solvers' while loops (``solve/loop.py``: an eager
    warm-up, then one iteration recorded in a CUDA graph and replayed, the
    stop flag read every ``READ_EVERY`` replays) against the same body run
    eagerly, in turns eager, captured, captured, eager, to relres 1e-6:
    the 898K Delaunay plate's ``cg_solve`` and ``jacobi_pcg_solve`` from
    rest capped at CG_CAP (K4), example 9's 961x481 ``mg_pcg_solve`` from
    its noise start (K6 and the level steps), ``aux_pcg_solve`` from rest
    on example 10's 961x481 plate on both backgrounds (K6 and the level
    steps) and on the 898K plate (K4 and the level steps), the level
    steps counted exactly.  Where the two eager solves are bit-equal the captured ones must
    be too, every launch count equal, one graph recorded; the energies
    and iteration counts held to the JAX constants of phases 11, 12 and
    14.  For each: whole-solve ms of every run and the host seconds spent
    recording the graph; the steady-state iteration of both modes (the
    difference between tol-0 solves capped at SOLVER_CAPS: host-clock ms,
    device-busy ms and kernels by name from the profiler, idle share,
    launches); the captured solve at each READ_EVERY_SWEEP period (bits
    equal to the shipped period's, ms).

24. Analytic validation (the JAX package's own analytic checks, at its
    tests' sizes and with their bounds; ``tests/test_torch_validation.py``
    on the CPU), every solve from rest (u = 0), each check's value printed
    beside the JAX test's and the JAX package's from rest, with its seconds
    and launches:
    a. Kirsch/Howland: one hole (d = 0.2) in the 2x1 plate under t = 1e5,
       on the hybrid mesh (lc 0.012, 27,264 elements; the plain hybrid
       route, the level steps in the aux V-cycle) and on the Delaunay
       mesh (31,418
       elements, below the banded threshold: K1, K2 and ``incidence_sum``
       each matvec, the level steps in the V-cycle), ``aux_pcg_solve``
       to relres 1e-6:
       the last relres below 1e-6, the peak P1 centroid von Mises within
       [0.91, 1.05] x 3.14 t and within 2 lc of the rim's top or bottom,
       and within 1% of JAX's;
    b. O(h^2): the manufactured solution on the clamped Delaunay unit
       square (lc 1/8 -> 1/16, CG cap 4000) and the clamped hybrid 2x1
       plate with a hole of radius 0.25 (lc 0.1 -> 0.05, cap 8000; the rim
       traction a work term built once as device tensors), ``cg_solve`` to
       tol 1e-8 on the plain route (JAX's ``backend="xla"``, so no kernel,
       which is checked): order > 1.8, e2 < 1e-2 A, both errors within 1%
       of JAX's;
    c. r-adaptivity: the example-3 bar (``examples/example3_torch.py``'s
       ``b_force`` and ``u_true``) at 41 nodes, 2000 L-BFGS steps fixed and
       r-adapted (the history kernels at P = 39 and 79): the adapted energy
       lower, its L2 error < 0.85 x the fixed one's, the grid moved by
       > 0.05, the fixed error within 1% of JAX's; the adapted run again on
       the plain history passes, its first 50 losses within 1e-4 of the
       kernels' run and its end within the bounds;
    d. diagonal independence: the 21x11 proxy plate, "zigzag" and "up",
       200 L-BFGS steps on the lattice route (K6 each step, K7 the no-grad
       energy at the solution): the plateaus within rel 5e-3 of each other
       and within 1e-4 of JAX's and of the no-grad energy.

Every ``run_lbfgs``/``run_optimizer`` solve of phases 4-24 (and those
inside the linear solvers' r-adaptive epochs) replays a captured step on
the card, and so does every linear solve's iteration (CG, Jacobi-PCG,
MG-PCG, aux-PCG, the one-rank NCCL sharded MG), except the zoom line
search and the gloo ranks of phase 10, which stay eager loops; the
launch counts count each replay, the solvers' masked calls past the stop
included.

Phases 1-19 run with ``HDNN_NO_NATIVE=1``: the host tables and the
coloring take the numpy paths whether or not an earlier run left a native
library in ``hidenn_fem_tpu_torch/csrc/build/``, so every run takes the
same path and phase 11b holds the colors to the JAX package's numpy
rounds.  Phase 20 alone turns the library on.

Each path of phases 4-24 (and K8's timed A/B) runs with every launch
count set to 0 just before it and read just after (in each rank for
phase 10), and fails if a kernel of that path did not launch; a solve
whose residual turns non-finite fails.  Every compact L-BFGS update on
the card launches both history kernels, so phases 4-8 need them too, and
the paths that must launch no kernel (the hybrid route, example 5's
plain lattice route) are held to launch no energy kernel.  Each phase's header prints the
seconds since the start.  The last three lines of standard output
are the kernels' JSON, the ``nvidia-smi`` name and power limit, and
``{"ok": true, ...}``.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Final energies of example 4 in the JAX package (f32, CPU) after 600
# L-BFGS steps from the init above, made with
#   JAX_PLATFORMS=cpu python -c "
#   import dataclasses, numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   from hidenn_fem_tpu.config import PlateConfig
#   c = PlateConfig()
#   m = ht.generate_mesh(c.length, c.height, list(c.holes),
#       c.make_boundaries(), c.nx, c.ny, keep_dead_nodes=True)
#   m = dataclasses.replace(m, lattice=None)   # gather route only
#   u0 = 1e-5 * np.random.default_rng(0).standard_normal((m.n_nodes, 2))
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1())
#   _, l = ht.run_lbfgs(e.total, {'coords': m.coords,
#       'u': jnp.asarray(u0, jnp.float32)}, num_steps=600, loss_args=(m,))
#   print(float(l[-1]))"
# the lattice route (the JAX package's default) without the replace line,
# the gather route with it.
JAX_EX4_LATTICE_FINAL_ENERGY = -1.3143489360809326
JAX_EX4_FINAL_ENERGY = -1.3143504858016968
EX4_RTOL = 2e-3

# Example 6 in the JAX package on the CPU: StructuredGridP1(E=10e9, nu=0.3,
# F_total=100e3, dtype=<f32 or f64>) on generate_structured_grid(holes=
# <the three reference holes>, nx=1000, ny=500), run_lbfgs(model.total,
# {"coords": grid.coords, "u": u0}, num_steps=600, memory_size=10,
# loss_args=(grid,)) with u0 = 1e-5 N(0,1) of shape [1000, 500, 2] from
# np.random.default_rng(0); entries of the loss history.  At 600 steps the
# solve is far from converged and the fixed-step L-BFGS amplifies
# rounding: JAX f32 -0.297194, JAX f64 -0.291068, and the port on the CPU
# -0.292732 (f32) and -0.289454 (f64) after 600 steps, while all four agree
# within 3e-4 at step 25.  So the rtol-2e-3 check is made at step 25
# against JAX f32, and the 600-step value is held to JAX f64 within the
# 2.6% spread of those four runs (rtol 5e-2).
EX6_COMPARE_STEP = 25
JAX_EX6_F32_AT_STEP = 34.600921630859375
JAX_EX6_F64_AT_STEP = 34.60655657313985
EX6_RTOL = 2e-3
JAX_EX6_F64_FINAL = -0.2910684935454196
EX6_FINAL_RTOL = 5e-2

# The irregular-mesh plates, with the three reference holes.  JAX package
# values (CPU) of the L-BFGS loss history from u0 = 1e-5 N(0,1) of shape
# [n_nodes, 2] (np.random.default_rng(0)), made with
#   JAX_PLATFORMS=cpu python -c "
#   import numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   from hidenn_fem_tpu.mesh.delaunay import generate_mesh_delaunay
#   from hidenn_fem_tpu.mesh.hybrid import generate_mesh_hybrid
#   holes = [(0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)]
#   m = generate_mesh_delaunay(holes=holes, lc=0.00218)  # or:
#   # m = generate_mesh_hybrid(holes=holes, lc=0.00209)
#   u0 = 1e-5 * np.random.default_rng(0).standard_normal((m.n_nodes, 2))
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1())
#   _, l = ht.run_lbfgs(e.total, {'coords': m.coords,
#       'u': jnp.asarray(u0, jnp.float32)}, num_steps=50, loss_args=(m,))
#   print(float(l[0]), float(l[25]))"
# (10 steps and l[9] for the hybrid mesh).  On the CPU the JAX package
# runs the Delaunay plate through gather_banded (the triangle tables) and
# XLA, the hybrid mesh on its hybrid route: the same physics as the
# port's kernels.  The f64 values come from the same arrays in f64 on the
# gather route, made with
#   JAX_PLATFORMS=cpu python -c "
#   import jax; jax.config.update('jax_enable_x64', True)
#   <the imports and m as above>
#   import jax.numpy as jnp
#   m = ht.TriMesh.from_arrays(*[np.asarray(a) for a in m.astuple()],
#       dtype=jnp.float64, build_banded=False, build_lattice=False)
#   u0 = <as above>
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jnp.float64))
#   _, l = ht.run_lbfgs(e.total, {'coords': m.coords, 'u': jnp.asarray(u0)},
#       num_steps=26, loss_args=(m,))"   # 10 for the hybrid mesh
# The first fixed step jumps to ~2e10 and each run's f32 rounding of it
# carries on: at step 25 of the Delaunay solve JAX f32 lies 2.1e-3 from
# JAX f64 (and a second JAX f32 run, on the XLA gather route with the
# banded tables stripped, 13.000329971313477, 6.2e-5 from it), at step 9
# of the hybrid solve 9.4e-4.  So the energy at init is held to JAX f32 at
# rtol 1e-4; the later energy to JAX f64 at rtol 2e-3, and to JAX f32
# within that f32 spread, rtol 5e-3 (the limit of the f32 L-BFGS checks
# of tests/test_torch_delaunay.py and tests/test_torch_hybrid.py).
HOLES = [(0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)]
DELAUNAY_LC = 0.00218
JAX_DELAUNAY_INIT = 1156116.125
DELAUNAY_COMPARE_STEP = 25
JAX_DELAUNAY_F32_AT_STEP = 12.971711158752441
JAX_DELAUNAY_F64_AT_STEP = 12.999536768762024
HYBRID_LC = 0.00209
# (elements, nodes) of the Delaunay plate; (elements, nodes, collar
# triangles, stair rows) of the hybrid plate, as the JAX package builds
# them; the K8 plate's lattice (921,600 elements)
DELAUNAY_SIZES = (898_032, 450_924)
HYBRID_SIZES = (847_261, 459_995, 2_553, 1_440)
K8_GRID = (961, 481)
JAX_HYBRID_INIT = 1257711.0
HYBRID_STEPS = 10
JAX_HYBRID_F32_LAST = 1063.1953125
JAX_HYBRID_F64_LAST = 1064.1994153392743
INIT_RTOL = 1e-4
F64_RTOL = 2e-3
F32_SPREAD_RTOL = 5e-3

# The linear solvers (phases 11-13).  JAX package values on the CPU for
# the same numpy inputs, made with (JAX_PLATFORMS=cpu, f32 unless noted)
#   import numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   # example 8: the 81x41 proxy plate, u0 = 1e-5 N(0,1) (default_rng(0))
#   m = ht.proxy_plate_mesh(nx=81, ny=41)
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1(), E=10e9, nu=0.3)
#   ul = lambda p, c, m: e({"u": p["u"], "coords": c}, m)
#   sol, h = ht.cg_solve(ul, {"u": u0}, (m.coords, m), max_iters=600,
#                        tol=1e-6)           # iterations, h's last, ul(sol)
#   _, en = ht.radapt_cg_solve(lambda p, m: e(p, m), {"u": sol["u"],
#       "coords": m.coords}, (m,), outer_epochs=3, cg_iters=600,
#       coord_steps=20, coord_lr=1e-5)
#   # the 898K Delaunay plate from u = 0, capped at CG_CAP iterations,
#   # the colors from _greedy_color_numpy (f64: the same arrays in f64 on
#   # the gather route, as for phase 8):
#   sol, _ = ht.cg_solve(ul, {"u": zeros}, (m.coords, m), max_iters=200,
#                        tol=1e-6)
#   sol, _ = ht.jacobi_pcg_solve(ul, {"u": zeros}, (m.coords, m),
#       node_colors=colors, max_iters=200, tol=1e-6)   # energies ul(sol)
#   # example 9: StructuredGridP1(E=10e9, nu=0.3, dtype) on the hole-free
#   # generate_structured_grid(nx=961, ny=481), u0 = 1e-5 N(0,1):
#   lv = ht.build_hierarchy(model, grid, model.coords(params, grid))
#   sol, h = ht.mg_pcg_solve(model, grid, params, max_iters=40, tol=1e-6,
#                            levels=lv)          # lmax, iterations, energy
#   # example 4 (as JAX_EX4_LATTICE_FINAL_ENERGY above) in node space:
#   sol, l = lbfgs_node_space(e, params, m, num_steps=600)
# Converged solves (CG and MG-PCG to relres 1e-6) agree to ~1e-7 in f32
# and f64 there, so they are held at SOLVE_RTOL; the capped 898K solves
# (f32 2.2e-5 and 1.8e-5 from f64 on the CPU) at the f32 spread rule of
# phases 8-9.
SOLVE_RTOL = 1e-4
# the r-adaptive MG epochs' coordinate step (5% of the 961x481 spacing in
# 10 Adam steps): example 9's 1e-7 moves the energy less than the MG
# solve's own f32 noise (~1e-7 relative), so "the energies fall" could not
# show
RADAPT_MG_LR = 1e-5
# the cap of the CG solve that phase 12 holds MG-PCG to (2,138 iterations
# to 1e-6 on the card)
MG_CG_CAP = 4000
JAX_EX8_CG_ITERS = 339
JAX_EX8_CG_RELRES = 9.672751275502378e-07
JAX_EX8_CG_ENERGY = -0.9937148094177246
JAX_EX8_RADAPT = (-0.9937335848808289, -0.9937341213226318,
                  -0.9937342405319214)
CG_CAP = 200
JAX_898K_COLORS = 7
# (f32, f64) energies after CG_CAP iterations
JAX_898K_CG = (-0.16281384229660034, -0.1628174890962335)
JAX_898K_PCG = (-0.1617916375398636, -0.16179449943196103)
MG_SHAPES = [(961, 481), (481, 241), (241, 121), (121, 61), (61, 31),
             (31, 16)]
JAX_MG_LMAX = (3.7544643878936768, 3.746400833129883, 3.7941272258758545,
               3.668827772140503, 3.7501957416534424, 3.7587616443634033)
JAX_MG_ITERS = 15
JAX_MG_ENERGY = (-0.9938671588897705, -0.9938672685126402)   # f32, f64
JAX_EX4_NODE_SPACE = -1.3143513202667236
JAX_EX4_NODE_SPACE_AT_SOLUTION = -1.3143532276153564

# The sharded multigrid (phase 10's groups) on example 9's grid.  The JAX
# package's mg_pcg_solve there (made as JAX_MG_ITERS above, with u0 = 0 and
# max_iters=80) reaches relres 1e-6 from rest in 40 iterations; from the
# noise start in JAX_MG_ITERS.  Each group solves by both engines from
# both starts, capped at SHARDED_MG_MAX_ITERS, and is held within
# MG_ITERS_SPREAD iterations of the card's one-process mg_pcg_solve and of
# JAX's, and within MG_U_RTOL x max|u| of the one-process solution (the
# bounds of tests/test_sharding.py::
# test_sharded_multigrid_matches_single_device).
JAX_MG_REST_ITERS = 40
SHARDED_MG_RUNS = (("all", "rest"), ("all", "noise"),
                   ("replicated_coarse", "rest"),
                   ("replicated_coarse", "noise"))
SHARDED_MG_MAX_ITERS = 60
MG_ITERS_SPREAD = 3
MG_U_RTOL = 5e-4

# Example 5 (phase 15) in the JAX package on the CPU, from the port
# example's init (u0 = 1e-5 N(0,1) from np.random.default_rng(0)):
#   JAX_PLATFORMS=cpu python -c "
#   import numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   m = ht.generate_mesh(length=2.0, height=1.0, holes=<the three
#       reference holes>, nx=1000, ny=500)
#   u0 = 1e-5 * np.random.default_rng(0).standard_normal((m.n_nodes, 2))
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1(u_fixed=0.0), E=10e9,
#       nu=0.3)
#   _, l = ht.run_lbfgs(e.total, {'coords': m.coords,
#       'u': jnp.asarray(u0, jnp.float32)}, num_steps=200, loss_args=(m,))"
# (f64: the same arrays in f64, from_arrays(dtype=jnp.float64,
# build_banded=False), under jax_enable_x64).  The fixed step jumps to
# 2.2e10 at step 1 and f32 rounding carries on: at step 25 JAX f32 lies
# 1.7e-3 from JAX f64 (the port on the CPU, 2e-6), after 200 steps, where
# the energy nears zero, 1.4e-2 (the port on the CPU, 3.3e-3).  So the
# energy is held to JAX f32 at init (INIT_RTOL), at step 25 by the f32
# spread rule of phases 8-9, and after 200 steps to JAX f64 within
# EX5_FINAL_RTOL, twice JAX's own f32 spread there (as example 6's
# 600-step value).
JAX_EX5_INIT = 1371073.5
JAX_EX5_AT_25 = (15.767266273498535, 15.74019626963804)       # f32, f64
JAX_EX5_FINAL = (-0.07035034149885178, -0.07134962448182439)  # f32, f64
EX5_FINAL_RTOL = 3e-2

# The L-BFGS variants on example 4 (phase 16), the lattice route from the
# init of phase 4.  The JAX package's run_lbfgs(linesearch="zoom"),
# 50 steps (f32, CPU, made as JAX_EX4_LATTICE_FINAL_ENERGY with
# num_steps=50, linesearch="zoom"): its f64 run lies within 1.4e-5 of it
# at every step, so each step is held at EX4_RTOL.  The fixed-step modes
# after 50 steps sit near zero, where f32 rounding (amplified since the
# first step's jump to 2.2e10) moves them by a few 1e-3 in absolute terms:
# JAX f64 -0.0239161929 in both modes, JAX f32 two-loop
# -0.027732759714126587 and compact -0.02737283706665039, the port on the
# CPU two-loop -0.0237884 and compact -0.0278816.  So each mode is held to
# JAX f64 within FIXED_STEP_ATOL, 5e-3 of the converged energy's
# magnitude, and the two-loop mode to the compact mode within twice that.
JAX_EX4_ZOOM = (
    53818.48046875, 6163.54638671875, 5148.28759765625, 3676.0869140625,
    2551.201904296875, 1749.5079345703125, 1191.5469970703125,
    803.944580078125, 533.6575317382812, 354.8449401855469,
    242.05506896972656, 167.0326385498047, 114.97779083251953,
    79.69266510009766, 57.317481994628906, 42.23512649536133,
    31.134634017944336, 23.72939109802246, 18.761459350585938,
    14.802947044372559, 11.983932495117188, 9.993685722351074,
    8.168585777282715, 6.9145026206970215, 5.897523403167725,
    4.879368305206299, 4.19343900680542, 3.521838665008545,
    3.0279998779296875, 2.614903688430786, 2.201627492904663,
    1.9119758605957031, 1.625853419303894, 1.4194787740707397,
    1.2543463706970215, 1.0894254446029663, 0.9733156561851501,
    0.8676310777664185, 0.7738773226737976, 0.6981697082519531,
    0.6191807985305786, 0.5586407780647278, 0.4998500347137451,
    0.44897085428237915, 0.40381044149398804, 0.3596063554286957,
    0.32312774658203125, 0.2869100272655487, 0.2578788995742798,
    0.23160117864608765)
JAX_EX4_FIXED_STEP_50 = -0.023916192916413198           # f64
VARIANT_STEPS = 50
FIXED_STEP_ATOL = 5e-3 * abs(JAX_EX4_LATTICE_FINAL_ENERGY)

# Auxiliary-space PCG (phase 14).  JAX package values on the CPU for the
# same numpy inputs, made with (JAX_PLATFORMS=cpu; f64 under
# jax_enable_x64, dt the matching dtype)
#   import numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   from hidenn_fem_tpu.models.structured_grid import StructuredGridP1
#   from hidenn_fem_tpu.solve import auxspace as ax
#   m = ht.proxy_plate_mesh(nx=961, ny=481)     # example 10; or the 898K
#   # Delaunay plate of phase 8 (f64: its arrays in f64 on the gather
#   # route, as there) or the 847K hybrid plate of phase 9
#   u0 = 1e-5 * np.random.default_rng(0).standard_normal((m.n_nodes, 2))
#   # ("noise", example 10's start), or u0 = 0 ("rest")
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=dt), E=10e9, nu=0.3)
#   ul = lambda p, c, m: e({"u": p["u"], "coords": c}, m)
#   c = jnp.asarray(np.asarray(m.coords), dt)
#   bg = StructuredGridP1(E=10e9, nu=0.3, dtype=dt)
#   pre = ax.build_aux_preconditioner(ul, {"u": u0}, (c, m), m,
#       bg_model=bg, lattice_bg=<False for "generic">)
#   sol, h = ax.aux_pcg_solve(ul, {"u": u0}, (c, m), pre=pre, bg_model=bg,
#                             max_iters=200, tol=1e-6)
#   # iterations: (h > 0).sum(); energy: ul(sol, c, m)
# Under x64 the generic background's windowed P^T raises in the JAX
# package (dynamic_slice index types int32 and int64), so its f64 values
# come from the flat tables of the same preconditioner
# (dataclasses.replace(pre, ptw_rel=None, ptw_w=None, ptw_starts=None,
# ptw_width=0)), which apply the same P^T (2.3e-7 apart in f32 at this
# size).  From example 10's noise start the first residual is the
# noise's, and relres 1e-6 leaves the f32 solves far apart: JAX's own two
# layouts of the generic background take 21 (windowed) and 28 (flat)
# iterations to energies 3.5e-4 apart.  So the noise-start solves are
# held to JAX's energies by the f32 spread rule of phases 8-9; the solves
# from rest, to SOLVE_RTOL (JAX f32 and f64 there lie within 5.4e-7).
# Iteration counts wander in f32 even from rest (71 against f64's 64 on
# the lattice-aligned background): each path is held within
# AUX_ITERS_SPREAD of the range of JAX's counts.
JAX_AUX = {
    # (path, start): (JAX's iteration counts: f32, [f32 on the other P^T
    # layout,] f64; the f32 energy; the f64 energy)
    ("lattice", "noise"): ((26, 26), -0.9938489198684692,
                           -0.9938762597428269),
    ("generic", "noise"): ((21, 28, 21), -0.9938318729400635,
                           -0.9938818247333342),
    ("lattice", "rest"): ((71, 64), -0.9938826560974121,
                          -0.9938830750013381),
    ("generic", "rest"): ((27, 27), -0.9938825368881226,
                          -0.9938830750013379),
    ("delaunay", "rest"): ((34, 34), -1.2771071195602417,
                           -1.2771068675489459),
    ("hybrid", "rest"): ((84, 82), -1.277075171470642,
                         -1.2770752690367217),
}
AUX_ITERS_SPREAD = 6
AUX_MAX_ITERS = 200
# the preconditioners JAX builds there: background lattice, levels, and
# the generic P^T layout (windowed: rel shape and window width; flat: the
# table depth)
JAX_AUX_SETUP = {
    "lattice": ((961, 481), 6, "reshape"),
    "generic": ((513, 257), 7, ("windowed", (65, 2056, 16), 8177)),
    "delaunay": ((513, 257), 7, ("flat", 20)),
    "hybrid": ((961, 481), 6, "reshape"),
}
# the r-adaptive aux epochs' coordinate step on example 11's mesh
# (lc = 0.05: 0.2% of the spacing a step)
RADAPT_AUX_LR = 1e-4

# Examples 1-3 (phase 18) in the JAX package on the CPU at their own sizes
# (f32), made with
#   JAX_PLATFORMS=cpu python -c "
#   import numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   from examples.example3 import b_force
#   m, p = ht.Linear1D.from_node_coords(np.linspace(0, 1, 100),
#                                       r_adapt=True)          # example 1
#   x = jnp.linspace(0, 1, 1000)
#   _, l = ht.minimize(lambda q: ht.l2_loss(m, q, x, jnp.sin(2 * jnp.pi
#       * x)), p, method='adam', num_steps=500, learning_rate=5e-3)
#   m, p = ht.Linear1D.from_node_coords(np.linspace(0, 10, 89),
#       r_adapt=True, u0=0.0, uN=0.0)                          # example 3
#   _, l = ht.minimize(lambda q: ht.bar_energy_1d(m, q, 2, b_force,
#       E=175.0), p, method='adam', num_steps=4000, learning_rate=1e-4)
#   print(float(l[-1]))"
# and example 2 as examples/example2.py runs it (its own PRNG stream), the
# final MSE over all 10,000 collocation points from the returned params.
# Both packages' inits of examples 1 and 3 are deterministic and equal; the
# port on the CPU ends at MSE 3.245e-7 and energy -0.0315217599 (rel
# 2.0e-4 from JAX's).  Example 2's packages draw their minibatches from
# different generators (the port's CPU run: 5.45e-6 against JAX's 4.81e-6),
# so its final MSE is held to JAX's within EX2_MSE_FACTOR, and the same
# loop is run again for 100 epochs on one numpy index table from one numpy
# init (rng = np.random.default_rng(0); batches = rng.integers(0, 10000,
# (100, 1000)); u0 = rng.standard_normal((25, 25)); the raw-diff
# increments), the JAX side a lax.scan of examples/example2.py's step over
# those batches.  At step 100 of that run JAX f32 lies 3.4e-3 from JAX f64
# (training points that are grid nodes put the element choice on the last
# bit of the grid, and Adam's normalized steps carry it), while the port's
# f64 run on the CPU equals JAX's f64 to 1e-16: so the card's f32 value is
# held to both at the f32 spread rule of phases 8-9 (F32_SPREAD_RTOL).
JAX_EX1_FINAL_MSE = 3.2339582389795396e-07
EX1_MSE_FACTOR = 2.0          # tests/test_baseline_parity.py: < 6.5e-7
JAX_EX3_FINAL_ENERGY = -0.03152796998620033
EX3_ENERGY_RTOL = 2e-3
EX3_RMS_LIMIT = 5e-4          # tests/test_losses_1d.py
JAX_EX2_FULL_MSE = 4.8130932555068284e-06
EX2_MSE_FACTOR = 2.0
EX2_TABLE_EPOCHS = 100
JAX_EX2_TABLE_LAST = (0.3700171709060669, 0.37128129055777664)  # f32, f64

# Point evaluation (phase 19) on the 898K plate after phase 8's solve:
# POINT_COUNT points uniform in the plate's bounding box.  A linear field
# is reproduced, and the centroid value is the vertex mean, up to the f32
# rounding of the blend (the reference coordinates are cast to f32):
# POINT_ATOL x max|u|.  Points farther than HOLE_MARGIN inside a hole are
# NaN, and farther than HOLE_MARGIN outside every hole (and inside the
# plate) are found (the hole boundaries are polygons of ~DELAUNAY_LC
# edges, pinned under r-adaptivity).
POINT_COUNT = 1_000_000
POINT_ATOL = 1e-5
HOLE_MARGIN = 0.005

# kernel vs plain tolerances at full size (f32 on both sides, sums and
# products in other orders): energy rtol 1e-4; gradients rtol 5e-4 with
# atol GRAD_ATOL x max|grad| per group.  Coordinate gradients are sums of
# cancelling terms whose f32 value lies ~4e-6 x max|grad| from an f64
# reference in either implementation (tests/test_torch_losses.py), hence
# 1e-5 rather than 1e-6.
ENERGY_RTOL = 1e-4
GRAD_RTOL = 5e-4
# the history passes (phase 3h) against their plain versions, per entry:
# HISTORY_RTOL (float32; HISTORY_RTOL_F64 in float64) times the same sum
# over absolute values, |SY| @ |[y, s, g]| and |gamma| |g| + |coef| @ |SY|
# (sums in other orders; S.g may cancel)
HISTORY_RTOL = 1e-5
HISTORY_RTOL_F64 = 1e-13
HISTORY_M = 100                 # run_lbfgs's memory_size
EX6_HISTORY = (10, 4 * 1000 * 500)  # example 6: memory 10, [1000, 500, 4]
GRAD_ATOL = 1e-5
# the row windows' (and the rank slices') energies, each a sum of the same
# quads' (rows') f32 energies in another grouping, against the whole
ROWS_SUM_RTOL = 1e-6
# The parent's row launches (device µs a call: the whole, its kernel, the
# separate zero fill of the [N, 4] output, the separate one-block energy
# sum; PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# this run's one-launch kernels: K6 over window 1 of 4 of the 922K-class
# plate, K4 on slice 1 of 4 of the 898K plate's rebanded tables
PARENT_ROWS_US = {"lattice_stencil_vg_rows": (9.02, 4.76, 2.68, 1.58),
                  "banded_vg_rows": (13.92, 9.76, 2.57, 1.50),
                  # K5 on that slice: the whole, its kernel, the zero fill
                  "banded_bwd_rows": (10.96, 8.85, 2.68),
                  # K7 over that window, in one launch
                  "lattice_stencil_fwd_rows": (4.45,)}

# The least time the card could take for a kernel's work (bound_ms) is the
# larger of its bytes over the memory rate and its flops over the float32
# rate (NVIDIA H100 SXM at 700 W: 3.35 TB/s of HBM3, 67 TFLOP/s of f32
# outside the tensor cores).  Bytes: each input read once, each output
# written once.  Flops, counted from csrc/p1_triangle.cuh (one per add,
# multiply or divide): a triangle's strain and energy TRI_E, the
# cotangents of its three corners given the strain TRI_C, the sum of one
# float4 ADD4.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TRI_E = 42
TRI_C = 60
ADD4 = 4


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms (CUDA events, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_close(name, got, want, rtol, atol_scale):
    """|got - want| <= rtol |want| + atol_scale max|want|; returns the
    max abs error."""
    got = got.detach().double()
    want = want.detach().double().to(got.device)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bound = rtol * want.abs() + atol_scale * want.abs().max()
    worst = float((err / bound.clamp_min(1e-300)).max())
    log(f"  {name}: max_abs_err={float(err.max()):.6g} "
        f"max|ref|={float(want.abs().max()):.6g} "
        f"worst err/bound={worst:.4g}")
    if worst > 1.0:
        raise AssertionError(f"{name}: kernel and plain disagree "
                             f"(err/bound {worst:.4g})")
    return float(err.max())


def value_and_grads(energy, params, mesh):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    v = energy.total(p, mesh)
    gc, gu = torch.autograd.grad(v, [p["coords"], p["u"]])
    return v.detach(), gc, gu


class Counts:
    """The launch counters of every kernel module, read and reset as one."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for m in self.modules:
            m.reset_launch_counts()

    def read(self):
        out = {}
        for m in self.modules:
            out.update(m.launch_counts)
        return out


def sum_launches(paths):
    """The launch counts of several paths, added kernel by kernel."""
    out = {}
    for launches in paths:
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


def run_path(counts, name, needs, fn):
    """Drive one path with every count at 0 just before and read just
    after; fails unless each kernel of ``needs`` launched."""
    torch.cuda.synchronize()
    counts.reset()
    result = fn()
    torch.cuda.synchronize()
    launches = counts.read()
    log(f"  launches in the {name} path: {launches}")
    for k in needs:
        if launches[k] == 0:
            raise AssertionError(f"{k} was not launched by the {name} path")
    return result, launches


def bound(bytes_, flops):
    """(bound_ms, bound_by) of a kernel that must move ``bytes_`` and do
    ``flops`` float32 operations."""
    mem_ms = 1e3 * bytes_ / HBM_BYTES_PER_S
    op_ms = 1e3 * flops / F32_FLOPS_PER_S
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def device_us(fn, calls=20):
    """(device µs per call, {kernel: µs per call}) of fn() from
    torch.profiler's key_averages(), after one warm-up call (windows that
    lost kernel events are profiled again).  If no window saw a kernel,
    the time per call of ``calls`` calls recorded in a CUDA graph and
    replayed (CUDA events; eager calls if fn() cannot be captured),
    under one name that says so."""
    from tools.profile_torch_port import graph_us, kernel_profile

    per = kernel_profile(fn, calls, tries=6)
    if per and sum(per.values()) > 0.0:
        return sum(per.values()), per
    try:
        us, how = graph_us(fn, calls), "CUDA graph replay"
    except RuntimeError:
        us, how = 1e3 * cuda_ms(fn, calls), "CUDA events"
    log(f"  the profiler recorded no kernel of this call: {us:.2f} us a "
        f"call from a {how}")
    return us, {f"all kernels ({how}, no profiler events)": us}


def kernel_entry(name, source, replaces, err, ms, plain_ms, bytes_, flops,
                 prof, card, library_ms=None, tag=""):
    """One kernel's record for the kernels JSON line (its launches on the
    main path are filled in later); logs its device time against its
    bound."""
    bound_ms, bound_by = bound(bytes_, flops)
    us, per = prof
    log(f"  {tag}{name}: {us:.2f} us of device time per call (profiler: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"); bound {1e3 * bound_ms:.2f} us by {bound_by} "
        f"({bytes_ / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP): "
        f"{1e3 * bound_ms / us:.0%} of the bound [{card}]")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_us": us, "device_kernels": per,
            "bytes": bytes_, "flops": flops}


def index_add_ms(src, index, n_nodes):
    """The library yardstick of a node sum: one ``index_add_`` of the
    corner cotangents ``src`` [R, 4] into a zeroed [n_nodes, 4] (timed as
    the kernels are; never used by the port)."""
    src = src.reshape(-1, 4).contiguous()
    index = index.reshape(-1).long()
    return cuda_ms(lambda: torch.zeros((n_nodes, 4), device=src.device)
                   .index_add_(0, index, src))


def plate_922k(ht, dev):
    from hidenn_fem_tpu_torch.mesh.lattice import detect_lattice

    t0 = time.perf_counter()
    mesh = ht.generate_mesh(nx=961, ny=481, keep_dead_nodes=True,
                            device=dev)
    build_s = time.perf_counter() - t0
    arrays = [a.cpu().numpy() for a in (mesh.coords, mesh.connectivity,
                                        mesh.neumann_edges)]
    t0 = time.perf_counter()
    route = detect_lattice(*arrays, device=dev)
    detect_s = time.perf_counter() - t0
    log(f"  922K-class plate: {mesh.n_nodes} nodes, {mesh.n_elements} "
        f"elements, {mesh.n_neumann_edges} Neumann edges, incidence "
        f"{tuple(mesh.incidence.shape)} ({build_s:.2f} s on the host, of "
        f"which detect_lattice {detect_s:.2f} s)")
    if mesh.n_elements != 852_676:
        raise AssertionError(f"expected 852676 elements, got "
                             f"{mesh.n_elements}")
    lat = mesh.lattice
    if not (lat is not None and route is not None and lat.identity
            and lat.uniform_sel == "" and not lat.all_present):
        raise AssertionError("the 922K-class plate must carry an identity "
                             "zigzag lattice route with holes")
    if mesh.banded is None:
        raise AssertionError("the 922K-class plate must carry banded "
                             "tables, as in the JAX package")
    return mesh


def perturbed_params(ht, mesh, dev, coord_scale=1e-3):
    """coords + coord_scale N(0,1), u ~ 1e-4 N(0,1).  The irregular
    plates take coord_scale 2e-5 (1% of their spacing): at 1e-3 many of
    their elements fold to near-zero area, whose f32 energies then hang on
    which corner the determinant starts from, and two routes that order
    the corners differently part by more than a rounding error."""
    rng = np.random.default_rng(0)
    n = mesh.n_nodes
    coords = mesh.coords.cpu().numpy().astype(np.float64)
    return ht.params_from_numpy(
        {"coords": coords + coord_scale * rng.standard_normal((n, 2)),
         "u": 1e-4 * rng.standard_normal((n, 2))}, device=dev)


def phase_gather(ht, ee, mesh922, dev, card):
    """Phase 3a: K1, K2, incidence_sum and the gather-route energy."""
    from hidenn_fem_tpu_torch.ops.assembly import (assemble_node_grad,
                                                   flat_gather)

    # strip the lattice and the banded tables, or total() would take the
    # lattice or the banded route instead of K1/K2
    mesh = dataclasses.replace(mesh922, lattice=None, banded=None,
                               banded_paired=None)
    params = perturbed_params(ht, mesh, dev)
    model = ht.TriangleP1()
    E, nu, w_sum = 10e9, 0.3, 0.5
    n = mesh.n_nodes
    node = model.packed_nodes(params, mesh).contiguous()
    conn = mesh.connectivity

    g = flat_gather(node, conn)
    k1 = ee.element_energy_fwd(node, conn, E, nu, w_sum)
    p1 = ee.element_energy_plain(g, E, nu, w_sum)
    err1 = check_close("K1 element_energy_fwd vs plain", k1, p1,
                       ENERGY_RTOL, 0.0)
    ct = torch.tensor(1.0, device=dev)
    k2 = ee.element_energy_bwd(node, conn, ct, E, nu, w_sum)
    p2 = ee.element_cotangent_plain(g, ct, E, nu, w_sum)
    err2 = check_close("K2 element_energy_bwd vs plain", k2, p2,
                       GRAD_RTOL, GRAD_ATOL)
    ga = g.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ee.element_energy_plain(ga, E, nu,
                                                           w_sum), ga)
    check_close("K2 element_energy_bwd vs autograd(plain)", k2, auto,
                GRAD_RTOL, GRAD_ATOL)
    inc = mesh.incidence
    k3 = ee.incidence_sum(k2, inc)
    p3 = assemble_node_grad(k2, conn, inc, n)
    err3 = check_close("incidence_sum vs plain gather-sum", k3, p3,
                       GRAD_RTOL, GRAD_ATOL)
    fconn = mesh.fused_connectivity
    fg = flat_gather(node, fconn)
    ne, tw = mesh.n_elements, -100e3
    check_close("K1 fused edges vs plain",
                ee.element_energy_fwd(node, fconn, E, nu, w_sum, ne, tw),
                ee.element_energy_plain(fg, E, nu, w_sum, ne, tw),
                ENERGY_RTOL, 0.0)
    check_close("K2 fused edges vs plain",
                ee.element_energy_bwd(node, fconn, ct, E, nu, w_sum, ne, tw),
                ee.element_cotangent_plain(fg, ct, E, nu, w_sum, ne, tw),
                GRAD_RTOL, GRAD_ATOL)
    torch.cuda.synchronize()

    ms1, pms1 = ab_ms(
        lambda: ee.element_energy_fwd(node, conn, E, nu, w_sum),
        lambda: ee.element_energy_plain(flat_gather(node, conn), E, nu,
                                        w_sum))
    ms2, pms2 = ab_ms(
        lambda: ee.element_energy_bwd(node, conn, ct, E, nu, w_sum),
        lambda: ee.element_cotangent_plain(flat_gather(node, conn), ct, E,
                                           nu, w_sum))
    ms3, pms3 = ab_ms(lambda: ee.incidence_sum(k2, inc),
                      lambda: assemble_node_grad(k2, conn, inc, n))
    log(f"  K1 fwd at {mesh.n_elements} elements: kernel {ms1:.4f} ms, "
        f"plain (gather + energy) {pms1:.4f} ms [{card}]")
    log(f"  K2 bwd at {mesh.n_elements} elements: kernel {ms2:.4f} ms, "
        f"plain (gather + cotangent) {pms2:.4f} ms [{card}]")
    log(f"  incidence_sum at {n} nodes x {inc.shape[1]} slots: kernel "
        f"{ms3:.4f} ms, plain (pad + gather + sum) {pms3:.4f} ms [{card}]")

    for fuse in (False, True):
        ek = ht.PlaneStressEnergy(model=model, backend="kernel",
                                  fuse_edges=fuse)
        ep = ht.PlaneStressEnergy(model=model, backend="plain",
                                  fuse_edges=fuse)
        before = dict(ee.launch_counts)
        vk, gck, guk = value_and_grads(ek, params, mesh)
        grew = {k: ee.launch_counts[k] - before[k] for k in before}
        if min(grew.values()) < 1:
            raise AssertionError(f"gather-route kernel path launched {grew}")
        vp, gcp, gup = value_and_grads(ep, params, mesh)
        tag = f"gather-route total(fuse_edges={fuse})"
        check_close(f"{tag} energy", vk, vp, ENERGY_RTOL, 0.0)
        check_close(f"{tag} d/d coords", gck, gcp, GRAD_RTOL, GRAD_ATOL)
        check_close(f"{tag} d/d u", guk, gup, GRAD_RTOL, GRAD_ATOL)
        kms, pms = ab_ms(lambda: value_and_grads(ek, params, mesh),
                         lambda: value_and_grads(ep, params, mesh))
        log(f"  value-and-grad {tag} at {mesh.n_elements} elements: "
            f"kernel path {kms:.4f} ms, plain path {pms:.4f} ms [{card}]")
    src = "hidenn_fem_tpu_torch/csrc/element_energy.cu"
    ne = mesh.n_elements
    nodes_b, conn_b, cot_b = 16 * n, 12 * ne, 48 * ne
    lib3 = index_add_ms(k2, conn, n)
    log(f"  library yardstick: index_add_ of the corner cotangents into "
        f"[{n}, 4] {lib3:.4f} ms [{card}]")
    return [
        kernel_entry(
            "element_energy_fwd", src,
            "hidenn_fem_tpu/ops/pallas_energy.py:154", err1, ms1, pms1,
            nodes_b + conn_b + 4, ne * (TRI_E + 1),
            device_us(lambda: ee.element_energy_fwd(node, conn, E, nu,
                                                    w_sum)), card),
        kernel_entry(
            "element_energy_bwd", src,
            "hidenn_fem_tpu/ops/pallas_energy.py:178", err2, ms2, pms2,
            nodes_b + conn_b + 4 + cot_b, ne * (TRI_E + TRI_C + 12),
            device_us(lambda: ee.element_energy_bwd(node, conn, ct, E, nu,
                                                    w_sum)), card),
        kernel_entry(
            "incidence_sum", src, "hidenn_fem_tpu/ops/assembly.py:113",
            err3, ms3, pms3, cot_b + inc.numel() * 4 + 16 * n,
            3 * ne * ADD4, device_us(lambda: ee.incidence_sum(k2, inc)),
            card, library_ms=lib3),
    ]


def stencil_ab(ls, tag, node, nx, ny, E, nu, w_sum, kw, card):
    """K7 and K6 against their plain versions on one lattice: checks,
    times and profiles; returns their kernel entries."""
    k7 = ls.lattice_stencil_fwd(node, nx, ny, E, nu, w_sum, **kw)
    p7 = ls.lattice_stencil_fwd_plain(node, nx, ny, E, nu, w_sum, **kw)
    err7 = check_close(f"{tag} K7 lattice_stencil_fwd vs plain", k7, p7,
                       ENERGY_RTOL, 0.0)
    e6, g6 = ls.lattice_stencil_vg(node, nx, ny, E, nu, w_sum, **kw)
    pe6, pg6 = ls.lattice_stencil_vg_plain(node, nx, ny, E, nu, w_sum, **kw)
    check_close(f"{tag} K6 energy vs plain", e6, pe6, ENERGY_RTOL, 0.0)
    err6 = check_close(f"{tag} K6 node gradient vs plain", g6, pg6,
                       GRAD_RTOL, GRAD_ATOL)
    na = node.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        ls.lattice_stencil_fwd_plain(na, nx, ny, E, nu, w_sum, **kw), na)
    check_close(f"{tag} K6 node gradient vs autograd(plain K7)", g6, auto,
                GRAD_RTOL, GRAD_ATOL)
    if float(e6) != float(k7):
        raise AssertionError(f"{tag}: K6 and K7 energies differ "
                             f"({float(e6)!r} vs {float(k7)!r})")
    torch.cuda.synchronize()
    ms7, pms7 = ab_ms(
        lambda: ls.lattice_stencil_fwd(node, nx, ny, E, nu, w_sum, **kw),
        lambda: ls.lattice_stencil_fwd_plain(node, nx, ny, E, nu, w_sum,
                                             **kw))
    ms6, pms6 = ab_ms(
        lambda: ls.lattice_stencil_vg(node, nx, ny, E, nu, w_sum, **kw),
        lambda: ls.lattice_stencil_vg_plain(node, nx, ny, E, nu, w_sum,
                                            **kw))
    quads = (nx - 1) * (ny - 1)
    log(f"  {tag} K7 fwd at {nx}x{ny} ({quads} quads): kernel {ms7:.4f} ms,"
        f" plain {pms7:.4f} ms [{card}]")
    log(f"  {tag} K6 vg at {nx}x{ny} ({quads} quads): kernel {ms6:.4f} ms, "
        f"plain (hand-derived gradient in torch) {pms6:.4f} ms [{card}]")
    n = nx * ny
    masks = sum(4 * quads for k in ("sel", "t1", "t2")
                if kw.get(k) is not None)
    tris = (2 * quads if kw.get("t1") is None
            else int((kw["t1"] != 0).sum()) + int((kw["t2"] != 0).sum()))
    src = "hidenn_fem_tpu_torch/csrc/lattice_stencil.cu"
    return [
        kernel_entry(
            "lattice_stencil_vg", src, "hidenn_fem_tpu/ops/lattice_slab.py:346",
            err6, ms6, pms6, 32 * n + masks + 4,
            tris * (TRI_E + 2 + TRI_C + 3 * (ADD4 + 4)),
            device_us(lambda: ls.lattice_stencil_vg(node, nx, ny, E, nu,
                                                    w_sum, **kw)),
            card, tag=f"{tag} "),
        kernel_entry(
            "lattice_stencil_fwd", src,
            "hidenn_fem_tpu/ops/lattice_slab.py:365", err7, ms7, pms7,
            16 * n + masks + 4, tris * (TRI_E + 2),
            device_us(lambda: ls.lattice_stencil_fwd(node, nx, ny, E, nu,
                                                     w_sum, **kw)),
            card, tag=f"{tag} ")]


def phase_lattice(ht, ls, mesh, dev, card):
    """Phase 3b: K6/K7 and the lattice-route energy on the 922K plate."""
    params = perturbed_params(ht, mesh, dev)
    model = ht.TriangleP1()
    route = mesh.lattice
    node = model.packed_nodes(params, mesh).contiguous()
    res = stencil_ab(ls, "922K zigzag+holes", node, route.nx, route.ny,
                     10e9, 0.3, 0.5, ls.route_stencil(route), card)

    ek = ht.PlaneStressEnergy(model=model, backend="kernel")
    ep = ht.PlaneStressEnergy(model=model, backend="plain")
    before = dict(ls.launch_counts)
    vk, gck, guk = value_and_grads(ek, params, mesh)
    if ls.launch_counts["lattice_stencil_vg"] == before["lattice_stencil_vg"]:
        raise AssertionError("the lattice-route kernel path did not "
                             "launch K6")
    vp, gcp, gup = value_and_grads(ep, params, mesh)
    tag = "lattice-route total"
    check_close(f"{tag} energy", vk, vp, ENERGY_RTOL, 0.0)
    check_close(f"{tag} d/d coords", gck, gcp, GRAD_RTOL, GRAD_ATOL)
    check_close(f"{tag} d/d u", guk, gup, GRAD_RTOL, GRAD_ATOL)
    kms, pms = ab_ms(lambda: value_and_grads(ek, params, mesh),
                     lambda: value_and_grads(ep, params, mesh))
    log(f"  value-and-grad {tag} at {mesh.n_elements} elements: kernel "
        f"path {kms:.4f} ms, plain path {pms:.4f} ms [{card}]")
    res += phase_rows_lattice(ls, "922K zigzag+holes", node, route.nx,
                              route.ny, 10e9, 0.3, ls.route_stencil(route),
                              card, timed=True)
    return res


def phase_structured(ls, dev, card):
    """Phase 3c: K6/K7 on the hole-free 961x481 "up" StructuredGridP1."""
    from hidenn_fem_tpu_torch.models.structured_grid import (
        StructuredGridP1, generate_structured_grid)

    grid = generate_structured_grid(nx=961, ny=481, split="up", device=dev)
    model = StructuredGridP1()
    params = model.init(np.random.default_rng(1), grid, device=dev)
    params["u"] = params["u"] * 10.0
    node = model._node(params, grid).reshape(-1, 4).contiguous()
    qm = grid.quad_mask
    kw = dict(diag=ls.UP, t1=qm, t2=qm)
    stencil_ab(ls, "961x481 structured up", node, grid.nx, grid.ny,
               model.E, model.nu, 0.5, kw, card)
    phase_rows_lattice(ls, "961x481 structured up", node, grid.nx, grid.ny,
                       model.E, model.nu, kw, card, timed=False)


def one_launch(tag, name, fn):
    """Fails unless each call of fn() runs exactly one device kernel: one
    kernel name in the profiler's counts over 20 calls, at one launch a
    call once rounded (the profiler can drop a kernel event on the H100,
    and ``kernel_launches`` profiles again only a few times).  Fails too
    if no window saw a kernel: a launch count needs the profiler."""
    from tools.profile_torch_port import kernel_launches

    per = kernel_launches(fn)
    log(f"  {tag}{name}: device kernels per call {per}")
    if len(per) != 1 or round(next(iter(per.values()))) != 1:
        raise AssertionError(f"{tag}{name}: {per} device kernels a call, "
                             "not one launch")


def narrow_windows(nx):
    """Windows of 1, 4 and 6 node rows at row_lo = 0, at row_hi = nx and
    inside (the sharded multigrid's windows are 4-6 rows)."""
    mid = nx // 2
    return [(0, 1), (0, 4), (0, 6), (mid, mid + 1), (mid, mid + 5),
            (nx - 6, nx), (nx - 4, nx), (nx - 1, nx)]


def k7_launch_floor(ls, dev, rows, ny):
    """A call that launches an empty kernel with K7's grid over a window
    of ``rows`` rows of a lattice ``ny`` wide (its fixed cost)."""
    from hidenn_fem_tpu_torch.ops.cuda_build import raise_on

    lib = ls._library()

    def launch():
        raise_on(lib, lib.hdnn_lattice_launch_floor(
            dev.index, rows, ny, torch.cuda.current_stream(dev).cuda_stream),
            "launch_floor")
    return launch


def phase_rows_lattice(ls, tag, node, nx, ny, E, nu, kw, card, timed):
    """Phase 3f: K6 and K7 over 2, 3 and 4 row windows (the ranks' split
    of ``parallel/sharded_slab.py``) and over narrow windows: K6 writes
    into a NaN-filled output, each window's gradient rows equal the
    whole-lattice K6's bit for bit and every other row is +0.0, K6's
    window energy equals K7's bit for bit, each window against its plain
    versions, the window energies of each split sum to the whole within
    ROWS_SUM_RTOL; when timed, one device kernel a call and the kernel
    entries of window 1 of 4, beside the parent's three-launch split
    (PARENT_ROWS_US)."""
    from hidenn_fem_tpu_torch.parallel.sharded_slab import row_window

    w_sum = 0.5
    e_whole, g_whole = ls.lattice_stencil_vg(node, nx, ny, E, nu, w_sum,
                                             **kw)
    stencil = dict(phase=0, sel=None, t1=None, t2=None)
    stencil.update(kw)
    err6 = err7 = 0.0
    splits = [[w for w in (row_window(nx, r, n) for r in range(n))
               if w[0] < w[1]] for n in (2, 3, 4)]
    for partition, windows in ([(True, w) for w in splits]
                               + [(False, narrow_windows(nx))]):
        total = 0.0
        for lo, hi in windows:
            args = (node, nx, ny, E, nu, w_sum, lo, hi)
            nan = torch.full_like(node, float("nan"))
            e6, g6 = ls._launch(True, node, nx, ny, E, nu, w_sum,
                                rows=(lo, hi), grad=nan, **stencil)
            e7 = ls.lattice_stencil_fwd_rows(*args, **kw)
            rows = slice(lo * ny, hi * ny)
            outside = torch.cat([g6[:lo * ny], g6[hi * ny:]])
            if not torch.equal(g6[rows], g_whole[rows]) or not bool(
                    ((outside == 0) & ~torch.signbit(outside)).all()):
                raise AssertionError(f"{tag}: window [{lo}, {hi}): K6 rows "
                                     "differ from the whole lattice's, or "
                                     "a row outside is not +0.0")
            if float(e6) != float(e7):
                raise AssertionError(f"{tag}: window [{lo}, {hi}): K6 and "
                                     "K7 energies differ")
            pe, pg = ls.lattice_stencil_vg_rows_plain(*args, **kw)
            err7 = max(err7, check_close(
                f"{tag} rows [{lo}, {hi}) energy vs plain", e7, pe,
                ENERGY_RTOL, 0.0))
            err6 = max(err6, check_close(
                f"{tag} rows [{lo}, {hi}) gradient vs plain", g6, pg,
                GRAD_RTOL, GRAD_ATOL))
            total += float(e6)
        if not partition:
            continue
        rel = abs(total - float(e_whole)) / abs(float(e_whole))
        log(f"  {tag}: {len(windows)} row windows: rows bit-equal to the "
            f"whole lattice's in a NaN-filled output, +0.0 outside, K6 = K7 "
            f"per window; energy sum {total!r} vs whole "
            f"{float(e_whole)!r}: rel {rel:.3e} (limit {ROWS_SUM_RTOL})")
        if rel > ROWS_SUM_RTOL:
            raise AssertionError(f"{tag}: window energies off the whole")
    log(f"  {tag}: narrow windows {narrow_windows(nx)}: rows bit-equal, "
        "+0.0 outside, K6 = K7")
    torch.cuda.synchronize()
    if not timed:
        return None
    lo, hi = row_window(nx, 1, 4)
    args = (node, nx, ny, E, nu, w_sum, lo, hi)
    tag_w = f"{tag} rows [{lo}, {hi}) "
    one_launch(tag_w, "K6 over a row window",
               lambda: ls.lattice_stencil_vg_rows(*args, **kw))
    one_launch(tag_w, "K6 on the whole lattice",
               lambda: ls.lattice_stencil_vg(node, nx, ny, E, nu, w_sum,
                                             **kw))
    one_launch(tag_w, "K7 over a row window",
               lambda: ls.lattice_stencil_fwd_rows(*args, **kw))
    ms6, pms6 = ab_ms(lambda: ls.lattice_stencil_vg_rows(*args, **kw),
                      lambda: ls.lattice_stencil_vg_rows_plain(*args, **kw))
    ms7, pms7 = ab_ms(lambda: ls.lattice_stencil_fwd_rows(*args, **kw),
                      lambda: ls.lattice_stencil_fwd_rows_plain(*args, **kw))
    log(f"  {tag_w}of {nx}: K6 kernel {ms6:.4f} ms, plain "
        f"{pms6:.4f} ms; K7 kernel {ms7:.4f} ms, plain {pms7:.4f} ms "
        f"[{card}]")
    # the window's work: its node rows and the one-row halo on each side
    # read, the quad rows lo-1 .. hi-1 evaluated (their masks read), the
    # placed [nx*ny, 4] gradient written (zeros outside the window)
    q0, q1 = max(lo - 1, 0), min(hi, nx - 1)
    quads = (q1 - q0) * (ny - 1)
    masks = sum(4 * quads for k in ("sel", "t1", "t2")
                if kw.get(k) is not None)
    tris = (2 * quads if kw.get("t1") is None else
            int((kw["t1"][q0:q1] != 0).sum())
            + int((kw["t2"][q0:q1] != 0).sum()))
    node_b = 16 * (min(hi + 1, nx) - q0) * ny
    src = "hidenn_fem_tpu_torch/csrc/lattice_stencil.cu"
    entries = [
        kernel_entry(
            "lattice_stencil_vg_rows", src,
            "hidenn_fem_tpu/ops/lattice_slab.py:346", err6, ms6, pms6,
            node_b + masks + 16 * nx * ny + 4,
            tris * (TRI_E + 2 + TRI_C + 3 * (ADD4 + 4)),
            device_us(lambda: ls.lattice_stencil_vg_rows(*args, **kw)),
            card, tag=tag_w),
        kernel_entry(
            "lattice_stencil_fwd_rows", src,
            "hidenn_fem_tpu/ops/lattice_slab.py:365", err7, ms7, pms7,
            node_b + masks + 4, tris * (TRI_E + 2),
            device_us(lambda: ls.lattice_stencil_fwd_rows(*args, **kw)),
            card, tag=tag_w)]
    fill_us, _ = device_us(lambda: torch.zeros_like(node))
    parent = PARENT_ROWS_US["lattice_stencil_vg_rows"]
    log(f"  {tag_w}K6: {entries[0]['device_us']:.2f} us in one launch "
        f"against the parent's {parent[0]} us in three (kernel "
        f"{parent[1]}, zero fill {parent[2]}, sum {parent[3]}; PERF.md, "
        f"NVIDIA H100 80GB HBM3, 700.00 W); the zero fill of the [N, 4] "
        f"output alone, as the parent launched it: {fill_us:.2f} us "
        f"[{card}]")
    floor_us, _ = device_us(k7_launch_floor(ls, node.device, hi - lo, ny))
    log(f"  {tag_w}K7: {entries[1]['device_us']:.2f} us in one launch "
        f"against the parent's "
        f"{PARENT_ROWS_US['lattice_stencil_fwd_rows'][0]} us (PERF.md, "
        f"NVIDIA H100 80GB HBM3, 700.00 W); an empty kernel with its grid "
        f"(the launch floor): {floor_us:.2f} us; its bound "
        f"{1e3 * entries[1]['bound_ms']:.2f} us [{card}]")
    return entries


def delaunay_898k(ht, mb, dev):
    """The 898K Delaunay plate (host build timed) and its table sizes."""
    t0 = time.perf_counter()
    mesh = ht.generate_mesh_delaunay(holes=HOLES, lc=DELAUNAY_LC, device=dev)
    build_s = time.perf_counter() - t0
    conn = mesh.connectivity.cpu().numpy()
    n = mesh.n_nodes
    inc = mesh.incidence.cpu().numpy()
    t0 = time.perf_counter()
    mb.build_banded_assembly(conn, n, inc, device=dev)
    tri_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mb.build_paired_assembly(conn, n, device=dev)
    pair_s = time.perf_counter() - t0
    pa, tri = mesh.banded_paired, mesh.banded
    log(f"  898K Delaunay plate: {n} nodes, {mesh.n_elements} elements, "
        f"{mesh.n_neumann_edges} Neumann edges; built in {build_s:.2f} s on "
        f"the host, of which the triangle tables {tri_s:.2f} s and the "
        f"paired tables {pair_s:.2f} s (timed again alone)")
    if (mesh.n_elements, n) != DELAUNAY_SIZES:
        raise AssertionError(f"expected (elements, nodes) {DELAUNAY_SIZES},"
                             f" got {(mesh.n_elements, n)}")
    if mesh.lattice is not None or tri is None or pa is None or pa.k != 4:
        raise AssertionError("the Delaunay plate must carry triangle and "
                             "paired banded tables and no lattice route")
    for tag, ba in (("paired", pa), ("triangle", tri)):
        if ba.re_conn_rel is None or ba.re_own_lo is None:
            raise AssertionError(f"the {tag} tables lack the recompute "
                                 "tables or their ownership intervals")
        log(f"  {tag} tables (k={ba.k}): conn_rel "
            f"{tuple(ba.conn_rel.shape)}, inc_rel {tuple(ba.inc_rel.shape)},"
            f" re_conn_rel {tuple(ba.re_conn_rel.shape)}, re_inc_rel "
            f"{tuple(ba.re_inc_rel.shape)}")
    return mesh


def banded_layout(be, tag, node, ba, ct, card, timed, ne):
    """K3, K4 and K5 (both fallbacks: the recompute and the two-pass
    windows) against their plain versions on one table layout of a mesh of
    ``ne`` elements; K5 = ct x K4 and K5 over the two kinds of window bit
    for bit; returns their kernel entries when timed."""
    from tools.profile_torch_port import without_recompute

    E, nu, w_sum = 10e9, 0.3, 0.5
    args = (E, nu, w_sum)
    k3 = be.banded_fwd(node, ba, *args)
    err3 = check_close(f"{tag} K3 banded_fwd vs plain", k3,
                       be.banded_fwd_plain(node, ba, *args), ENERGY_RTOL, 0.0)
    e4, g4 = be.banded_vg(node, ba, *args)
    pe4, pg4 = be.banded_vg_plain(node, ba, *args)
    check_close(f"{tag} K4 energy vs plain", e4, pe4, ENERGY_RTOL, 0.0)
    check_close(f"{tag} K4 energy (owned rows) vs K3 (every row)", e4, k3,
                ENERGY_RTOL, 0.0)
    log(f"  {tag} K4 energy {float(e4)!r}, K3 energy {float(k3)!r}: "
        + ("equal bit for bit" if float(e4) == float(k3) else
           "not bit-equal"))
    e4b, g4b = be.banded_vg(node, ba, *args)
    if float(e4b) != float(e4) or not torch.equal(g4b, g4):
        raise AssertionError(f"{tag} K4: two launches gave other bits")
    err4 = check_close(f"{tag} K4 node gradient vs plain", g4, pg4,
                       GRAD_RTOL, GRAD_ATOL)
    na = node.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(be.banded_fwd_plain(na, ba, *args), na)
    check_close(f"{tag} K4 node gradient vs autograd(plain K3)", g4, auto,
                GRAD_RTOL, GRAD_ATOL)
    kinds = {}
    for kind, keep in (("recompute windows", True),
                       ("two-pass windows", False)):
        fb = without_recompute(ba, keep)
        g5 = be.banded_bwd(node, fb, ct, *args)
        kinds[kind] = (fb, g5, check_close(
            f"{tag} K5 ({kind}) vs plain", g5,
            be.banded_bwd_plain(node, fb, ct, *args), GRAD_RTOL, GRAD_ATOL))
        check_close(f"{tag} K5 ({kind}) vs ct x K4 node gradient", g5,
                    ct * g4, GRAD_RTOL, GRAD_ATOL)
    # K4 and both kinds of K5 add the same cotangents in the same order
    re5, two5 = (kinds[k][1] for k in kinds)
    if not torch.equal(re5, ct * g4):
        raise AssertionError(f"{tag} K5 over the recompute windows is not "
                             "ct x K4 bit for bit")
    if not torch.equal(two5, re5):
        raise AssertionError(f"{tag} K5 over the two-pass windows differs "
                             "from K5 over the recompute windows")
    log(f"  {tag} K5 (recompute windows) equals ct x K4, and K5 (two-pass "
        "windows) equals K5 (recompute windows), bit for bit")
    for which in ("vg", "grad", "grad_two_pass"):
        regs, ctas = be.kernel_occupancy(which, ba.k, node.device)
        log(f"  {tag} {which} kernel: {regs} registers a thread, {ctas} "
            "CTAs of 256 threads an SM")
    torch.cuda.synchronize()
    if not timed:
        return None
    ms3, pms3 = ab_ms(lambda: be.banded_fwd(node, ba, *args),
                      lambda: be.banded_fwd_plain(node, ba, *args))
    ms4, pms4 = ab_ms(lambda: be.banded_vg(node, ba, *args),
                      lambda: be.banded_vg_plain(node, ba, *args))
    ms5 = {}
    for kind, (fb, _, _) in kinds.items():
        ms5[kind] = ab_ms(lambda: be.banded_bwd(node, fb, ct, *args),
                          lambda: be.banded_bwd_plain(node, fb, ct, *args))
    rows = ba.conn_rel.shape[0] * ba.conn_rel.shape[1]
    re_rows = ba.re_conn_rel.shape[0] * ba.re_conn_rel.shape[1]
    log(f"  {tag} K3 fwd over {rows} rows: kernel {ms3:.4f} ms, plain "
        f"{pms3:.4f} ms [{card}]")
    log(f"  {tag} K4 vg over {re_rows} recompute rows: kernel {ms4:.4f} ms, "
        f"plain {pms4:.4f} ms [{card}]")
    for kind, (kms, pms) in ms5.items():
        log(f"  {tag} K5 bwd over the {kind}: kernel {kms:.4f} ms, plain "
            f"{pms:.4f} ms [{card}]")
    n = node.shape[0]
    nodes_b = 16 * n
    fwd_b = 4 * ba.starts.numel() + 4 * ba.conn_rel.numel()
    re_b = 4 * ba.re_nstarts.numel() + 4 * ba.re_conn_rel.numel()
    inc_b = 4 * ba.re_inc_rel.numel()
    own_b = 4 * (ba.re_own_lo.numel() + ba.re_own_hi.numel())
    two_b = 4 * ba.inc_rel.numel() + 4 * ba.ct_starts.numel()
    grad_flops = ne * (TRI_E + TRI_C + 3 * ADD4) + 4 * n
    src = "hidenn_fem_tpu_torch/csrc/banded_energy.cu"
    line = "hidenn_fem_tpu/ops/banded_energy.py:"
    entries = [
        kernel_entry("banded_fwd", src, line + "116", err3, ms3, pms3,
                     nodes_b + fwd_b + 4, ne * (TRI_E + 1),
                     device_us(lambda: be.banded_fwd(node, ba, *args)),
                     card, tag=f"{tag} "),
        kernel_entry("banded_vg", src, line + "133", err4, ms4, pms4,
                     2 * nodes_b + re_b + own_b + inc_b + 4,
                     ne * (TRI_E + 1 + TRI_C + 3 * ADD4),
                     device_us(lambda: be.banded_vg(node, ba, *args)),
                     card, tag=f"{tag} ")]
    for name, kind, bytes_ in (
            ("banded_bwd", "recompute windows", 2 * nodes_b + re_b + inc_b
             + 4),
            ("banded_bwd_two_pass", "two-pass windows", 2 * nodes_b + fwd_b
             + two_b + 4)):
        fb, _, err5 = kinds[kind]
        entries.append(kernel_entry(
            name, src, line + "159", err5, *ms5[kind], bytes_, grad_flops,
            device_us(lambda: be.banded_bwd(node, fb, ct, *args)), card,
            tag=f"{tag} "))
    # the library yardstick beside K5: one index_add_ of the forward rows'
    # cotangents (each element once), which K5 recomputes instead
    fwd_cot = be._row_cotangents(be._rows(node, ba.starts, ba.conn_rel),
                                 *args)
    fwd_idx = ba.starts.long()[:, None, None] + ba.conn_rel.long()
    lib = index_add_ms(fwd_cot, fwd_idx, n)
    log(f"  {tag} beside K5: index_add_ of the forward rows' cotangents "
        f"{lib:.4f} ms [{card}]")
    return entries


def phase_banded(ht, be, mb, mesh, dev, card):
    """Phase 3d: K3/K4/K5 against plain on the three layouts, then the
    banded route against the flat gather route."""
    params = perturbed_params(ht, mesh, dev, coord_scale=2e-5)
    model = ht.TriangleP1()
    node = model.packed_nodes(params, mesh).contiguous()
    ct = torch.tensor(0.75, device=dev)
    ne = mesh.n_elements
    res = banded_layout(be, "paired k=4", node, mesh.banded_paired, ct, card,
                        timed=True, ne=ne)
    banded_layout(be, "triangle k=3", node, mesh.banded, ct, card,
                  timed=True, ne=ne)
    t0 = time.perf_counter()
    strip = mb.build_striped_assembly(mesh.connectivity.cpu().numpy(),
                                      mesh.n_nodes, device=dev)
    log(f"  strip tables built in {time.perf_counter() - t0:.2f} s: "
        f"conn_rel {tuple(strip.conn_rel.shape)}")
    banded_layout(be, "strip k=6", node, strip, ct, card, timed=False,
                  ne=ne)

    # the banded route against the flat gather route on the same mesh
    energy = ht.PlaneStressEnergy(model=model)
    flat = dataclasses.replace(mesh, banded=None, banded_paired=None)
    before = dict(be.launch_counts)
    vb, gcb, gub = value_and_grads(energy, params, mesh)
    if be.launch_counts["banded_vg"] == before["banded_vg"]:
        raise AssertionError("the banded route did not launch K4")
    vf, gcf, guf = value_and_grads(energy, params, flat)
    tag = "banded route vs flat gather route"
    check_close(f"{tag} energy", vb, vf, ENERGY_RTOL, 0.0)
    check_close(f"{tag} d/d coords", gcb, gcf, GRAD_RTOL, GRAD_ATOL)
    check_close(f"{tag} d/d u", gub, guf, GRAD_RTOL, GRAD_ATOL)
    bms, fms = ab_ms(lambda: value_and_grads(energy, params, mesh),
                     lambda: value_and_grads(energy, params, flat))
    log(f"  value-and-grad at {mesh.n_elements} elements: banded route "
        f"(K4) {bms:.4f} ms, flat gather route (K1, K2, incidence_sum) "
        f"{fms:.4f} ms [{card}]")
    return res


def phase_rows_banded(ht, be, mesh, dev, card, ranks=4):
    """Phase 3g: K4 and K5 on each rank's slice of the 898K Delaunay plate's
    tables rebanded for ``ranks`` (block_multiple), the slices launched in
    turn: the rows placed at row_start equal the unsharded K4/K5 rows on
    the same tables bit for bit, K4 writing into a NaN-filled output
    (every other row +0.0), the slices' energies sum to the whole within
    ROWS_SUM_RTOL, each slice against its plain versions; one device kernel
    a K4 call; K4's device time on slice 1 of the same tables in 1, 2, 4,
    8 or 16 slices (``k4_slice_scaling``), with its grid against the CTAs
    the card holds at once; returns (the rebanded mesh, the kernel entries
    of slice 1)."""
    from hidenn_fem_tpu_torch.parallel.sharding import (rank_tables,
                                                        reband_for_shards)

    t0 = time.perf_counter()
    tri = reband_for_shards(mesh, ranks)
    ba = tri.banded_paired
    log(f"  898K tables rebanded for {ranks} ranks in "
        f"{time.perf_counter() - t0:.2f} s on the host (k={ba.k}): "
        f"{ba.starts.shape[0]} element blocks, {ba.re_nstarts.shape[0]} "
        f"node blocks")
    if ba.re_own_lo is None:
        raise AssertionError("the rebanded tables lack ownership intervals")
    params = perturbed_params(ht, mesh, dev, coord_scale=2e-5)
    node = ht.TriangleP1().packed_nodes(params, mesh).contiguous()
    args = (10e9, 0.3, 0.5)
    ct = torch.tensor(0.75, device=dev)
    e4, g4 = be.banded_vg(node, ba, *args)
    no_own = dataclasses.replace(ba, re_own_lo=None, re_own_hi=None)
    g5 = be.banded_bwd(node, no_own, ct, *args)
    n = node.shape[0]
    total, err4, err5, slices = 0.0, 0.0, 0.0, []
    for r in range(ranks):
        loc, rs = rank_tables(ba, r, ranks)
        loc5 = dataclasses.replace(loc, re_own_lo=None, re_own_hi=None)
        e, g = be._vg_launch("banded_vg_rows", node, loc, *args, rs,
                             grad=torch.full_like(node, float("nan")))
        g5r = be._bwd_launch("banded_bwd_rows", node, loc5, ct, *args, rs,
                             grad=torch.full_like(node, float("nan")))
        if not torch.equal(g5r, ct * g):
            raise AssertionError(f"slice {r}: K5 at row_start is not ct x K4 "
                                 "at row_start bit for bit")
        end = min(n, rs + loc.re_inc_rel.shape[0] * loc.re_inc_rel.shape[1])
        for name, got, want in (("K4", g, g4), ("K5", g5r, g5)):
            outside = torch.cat([got[:rs], got[end:]])
            if not torch.equal(got[rs:end], want[rs:end]) or not bool(
                    ((outside == 0) & ~torch.signbit(outside)).all()):
                raise AssertionError(f"slice {r}: {name} rows at row_start "
                                     "differ from the unsharded launch, or "
                                     "a row outside is not +0.0")
        pe, pg = be.banded_vg_plain(node, loc, *args, rs)
        check_close(f"slice {r} of {ranks} K4 energy vs plain", e, pe,
                    ENERGY_RTOL, 0.0)
        err4 = max(err4, check_close(f"slice {r} of {ranks} K4 rows vs "
                                     "plain", g, pg, GRAD_RTOL, GRAD_ATOL))
        err5 = max(err5, check_close(
            f"slice {r} of {ranks} K5 rows vs plain", g5r,
            be.banded_bwd_plain(node, loc5, ct, *args, rs), GRAD_RTOL,
            GRAD_ATOL))
        total += float(e)
        slices.append((loc, loc5, rs))
    rel = abs(total - float(e4)) / abs(float(e4))
    log(f"  {ranks} slices: K4 and K5 rows at row_start bit-equal to the "
        f"unsharded launches (into NaN-filled outputs, +0.0 outside; K5 = "
        f"ct x K4); "
        f"energy sum {total!r} vs whole {float(e4)!r}: rel {rel:.3e} "
        f"(limit {ROWS_SUM_RTOL})")
    if rel > ROWS_SUM_RTOL:
        raise AssertionError("slice energies off the whole")
    loc, loc5, rs = slices[1]
    one_launch(f"slice 1 of {ranks} ", "K4 at row_start",
               lambda: be.banded_vg_rows(node, loc, *args, rs))
    one_launch(f"slice 1 of {ranks} ", "K5 at row_start",
               lambda: be.banded_bwd_rows(node, loc5, ct, *args, rs))
    one_launch("", "K4 on the whole tables",
               lambda: be.banded_vg(node, ba, *args))
    k4_slice_scaling(be, node, ba, args, card)
    ms4, pms4 = ab_ms(lambda: be.banded_vg_rows(node, loc, *args, rs),
                      lambda: be.banded_vg_plain(node, loc, *args, rs))
    ms5, pms5 = ab_ms(lambda: be.banded_bwd_rows(node, loc5, ct, *args, rs),
                      lambda: be.banded_bwd_plain(node, loc5, ct, *args, rs))
    log(f"  slice 1 of {ranks} (row_start {rs}): K4 kernel {ms4:.4f} ms, "
        f"plain {pms4:.4f} ms; K5 kernel {ms5:.4f} ms, plain {pms5:.4f} ms "
        f"[{card}]")
    # the slice's work: the node rows its windows span read, its tables
    # read, its share of the triangles recomputed, the placed [N, 4]
    # gradient written (zeros outside its rows)
    span = int(loc.re_nstarts.max() + ba.re_wnode - loc.re_nstarts.min())
    re_b = 4 * (loc.re_nstarts.numel() + loc.re_conn_rel.numel()
                + loc.re_inc_rel.numel())
    own_b = 4 * 2 * loc.re_own_lo.numel()
    share = loc.re_conn_rel.shape[0] / ba.re_conn_rel.shape[0]
    tris = mesh.n_elements * share
    src = "hidenn_fem_tpu_torch/csrc/banded_energy.cu"
    line = "hidenn_fem_tpu/ops/banded_energy.py:"
    entries = [
        kernel_entry("banded_vg_rows", src, line + "133", err4, ms4, pms4,
                     16 * span + re_b + own_b + 16 * n + 4,
                     tris * (TRI_E + 1 + TRI_C + 3 * ADD4),
                     device_us(lambda: be.banded_vg_rows(node, loc, *args,
                                                         rs)),
                     card, tag=f"slice 1 of {ranks} "),
        kernel_entry("banded_bwd_rows", src, line + "159", err5, ms5, pms5,
                     16 * span + re_b + 16 * n + 4,
                     tris * (TRI_E + TRI_C + 3 * ADD4),
                     device_us(lambda: be.banded_bwd_rows(node, loc5, ct,
                                                          *args, rs)),
                     card, tag=f"slice 1 of {ranks} ")]
    fill_us, _ = device_us(lambda: torch.zeros_like(node))
    parent = PARENT_ROWS_US["banded_vg_rows"]
    log(f"  slice 1 of {ranks} K4: {entries[0]['device_us']:.2f} us in one "
        f"launch against the parent's {parent[0]} us in three (kernel "
        f"{parent[1]}, zero fill {parent[2]}, sum {parent[3]}; PERF.md, "
        f"NVIDIA H100 80GB HBM3, 700.00 W); the zero fill of the [N, 4] "
        f"output alone, as the parent launched it: {fill_us:.2f} us "
        f"[{card}]")
    parent = PARENT_ROWS_US["banded_bwd_rows"]
    log(f"  slice 1 of {ranks} K5: {entries[1]['device_us']:.2f} us in one "
        f"launch against the parent's {parent[0]} us in two (kernel {parent[1]}, zero fill "
        f"{parent[2]}; PERF.md, NVIDIA H100 80GB HBM3, 700.00 W) [{card}]")
    return tri, entries


def k4_slice_scaling(be, node, ba, args, card):
    """K4's device time on slice 1 (slice 0 of 1) of the same tables cut
    into each of 1, 2, 4, 8 and 16 slices that their block counts allow:
    its row and node blocks (256 threads),
    and those blocks over the CTAs the card holds at once (waves), the
    zero CTAs apart.  A time that stays flat as the slice shrinks below
    one wave is the launch shape's (latency of one wave), one that falls
    with the slice is the core's work."""
    from hidenn_fem_tpu_torch.parallel.sharding import rank_tables

    regs, ctas = be.kernel_occupancy("vg", ba.k, node.device)
    sms = torch.cuda.get_device_properties(node.device).multi_processor_count
    tpb = be._library().hdnn_banded_threads_per_block()
    line = []
    for size in (1, 2, 4, 8, 16):
        if ba.re_nstarts.shape[0] % size or ba.starts.shape[0] % size:
            continue
        loc, rs = rank_tables(ba, min(1, size - 1), size)
        n_rows = loc.re_conn_rel.shape[0] * loc.re_conn_rel.shape[1]
        n_nodes = be._placed_rows(
            loc.re_inc_rel.shape[0] * loc.re_inc_rel.shape[1], rs,
            node.shape[0])
        blocks = -(-max(n_rows, n_nodes) // tpb)
        us, _ = device_us(lambda: be.banded_vg_rows(node, loc, *args, rs))
        line.append(f"1/{size}: {us:.2f} us, {n_rows} rows, {n_nodes} "
                    f"nodes, {blocks} blocks = {blocks / (ctas * sms):.2f} "
                    "waves")
    log(f"  K4 by slice ({regs} registers a thread, {ctas} CTAs an SM, "
        f"{sms} SMs): " + "; ".join(line) + f" [{card}]")


def phase_window_gather(ht, wg, mb, counts, dev, card):
    """Phase 3e: K8 against its plain version and the flat-gather sum."""
    t0 = time.perf_counter()
    mesh = mb.reorder_mesh(ht.generate_mesh(nx=K8_GRID[0], ny=K8_GRID[1],
                                            holes=(), device=dev),
                           build_banded=False)
    log(f"  reordered hole-free {K8_GRID[0]}x{K8_GRID[1]} plate: "
        f"{mesh.n_elements} elements, "
        f"{mesh.n_nodes} nodes ({time.perf_counter() - t0:.2f} s on the "
        "host)")
    if mesh.n_elements != 2 * (K8_GRID[0] - 1) * (K8_GRID[1] - 1):
        raise AssertionError(f"unexpected element count {mesh.n_elements}")
    conn = mesh.connectivity.cpu().numpy()
    n = mesh.n_nodes
    node = torch.tensor(np.random.default_rng(3).standard_normal((n, 4)),
                        dtype=torch.float32, device=dev)
    conn_d = mesh.connectivity
    cases, err = [], 0.0
    for eb in (64, 128):
        relT, wblk, wp, npad, s = wg.build_subblocks(conn, n, eb)
        node_pad = wg.pad_nodes(node, npad)
        relT_d = torch.tensor(relT, device=dev)
        wblk_d = torch.tensor(wblk, device=dev)
        # the same kernel over absolute indices (window block 0): the flat
        # gather with the windowed kernel's access pattern
        flatT = torch.tensor(np.ascontiguousarray(np.swapaxes(
            conn.reshape(s, eb, 3), 1, 2)).astype(np.int32), device=dev)
        zero = torch.zeros(s, dtype=torch.int32, device=dev)
        k = wg.window_sq(node_pad, relT_d, wblk_d, wp)
        tag = f"K8 eb={eb} (wp={wp}, {s} sub-blocks)"
        err = max(err, check_close(
            f"{tag} vs window_sq_plain", k,
            wg.window_sq_plain(node_pad, relT_d, wblk_d, wp), ENERGY_RTOL,
            0.0))
        check_close(f"{tag} vs the flat-gather sum", k,
                    wg.flat_sq_plain(node, conn_d), ENERGY_RTOL, 0.0)
        check_close(f"{tag} over flat index tables vs windowed", wg.window_sq(
            node_pad, flatT, zero, wp), k, ENERGY_RTOL, 0.0)
        cases.append((eb, node_pad, relT_d, wblk_d, wp, flatT, zero))
    torch.cuda.synchronize()

    def timed_ab():
        out = []
        for eb, node_pad, relT_d, wblk_d, wp, flatT, zero in cases:
            kms, pms = ab_ms(
                lambda: wg.window_sq(node_pad, relT_d, wblk_d, wp),
                lambda: wg.window_sq_plain(node_pad, relT_d, wblk_d, wp))
            fkms, fpms = ab_ms(
                lambda: wg.window_sq(node_pad, flatT, zero, wp),
                lambda: wg.flat_sq_plain(node, conn_d))
            log(f"  K8 at {mesh.n_elements} elements, eb={eb}: windowed "
                f"kernel {kms:.4f} ms, same kernel over flat tables "
                f"{fkms:.4f} ms, plain windowed gather {pms:.4f} ms, plain "
                f"flat gather {fpms:.4f} ms [{card}]")
            out.append((kms, pms))
        return out

    times, launches = run_path(counts, "K8 windowed-vs-flat gather A/B",
                               ("window_sq",), timed_ab)
    kms, pms = times[0]
    _, node_pad, relT_d, wblk_d, wp, _, _ = cases[0]
    entry = kernel_entry(
        "window_sq", "hidenn_fem_tpu_torch/csrc/window_gather.cu",
        "tools/microbench_gather.py:177", err, kms, pms,
        16 * node_pad.shape[0] + 4 * (relT_d.numel() + wblk_d.numel()) + 4,
        24 * mesh.n_elements,
        device_us(lambda: wg.window_sq(node_pad, relT_d, wblk_d, wp)), card,
        tag="eb=64 ")
    entry["launches"] = launches["window_sq"]
    return entry


def ab_library_ms(kernel_fn, plain_fn, library_fn):
    """(kernel, plain, library) ms, timed in turns plain, library,
    kernel, kernel, library, plain."""
    p1, l1 = cuda_ms(plain_fn), cuda_ms(library_fn)
    k1, k2 = cuda_ms(kernel_fn), cuda_ms(kernel_fn)
    l2, p2 = cuda_ms(library_fn), cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2


def history_inputs(m, p, dev, dtype=torch.float32, seed=0):
    """A [2m, P] history with one zero (rejected) pair, y, s, g [P], coef
    [2m] and gamma > 0, from a seeded generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    SY = randn(2 * m, p)
    SY[[1, m + 1]] = 0.0
    return SY, randn(p), randn(p), randn(p), randn(2 * m), \
        randn().abs() + 0.1


def check_history(name, got, want, scale, rtol):
    """|got - want| <= rtol x scale per entry; returns the max abs
    error."""
    err = (got.double() - want.double()).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    worst = float((err / (rtol * scale).clamp_min(1e-300)).max())
    log(f"  {name}: max_abs_err={float(err.max()):.6g} "
        f"worst err/bound={worst:.4g} (rtol {rtol} of the sum over "
        "absolute values)")
    if worst > 1.0:
        raise AssertionError(f"{name}: kernel and plain disagree")
    return float(err.max())


def history_case(lh, tag, m, p, dev, card, dtype=torch.float32):
    """Both history kernels at one (m, P): checked against their plain
    versions, two launches bit-equal; in float32 also timed and profiled
    (returns their kernel entries)."""
    SY, y, s, g, coef, gamma = history_inputs(m, p, dev, dtype)
    log(f"  {tag}: history [{2 * m}, {p}] {str(dtype)[6:]}, SY.nbytes "
        f"{SY.nbytes}")
    rtol = HISTORY_RTOL if dtype == torch.float32 else HISTORY_RTOL_F64
    V = torch.stack([y, s, g], 1)
    dots = lh.history_dots(SY, y, s, g)
    comb = lh.history_combine(SY, g, coef, gamma)
    A = SY.abs().double()
    err_d = check_history(f"{tag} dots vs plain", dots,
                          lh.history_dots_plain(SY, y, s, g),
                          A @ V.abs().double(), rtol)
    err_c = check_history(f"{tag} combination vs plain", comb,
                          lh.history_combine_plain(SY, g, coef, gamma),
                          gamma.abs().double() * g.abs().double()
                          + coef.abs().double() @ A, rtol)
    del A
    if not (torch.equal(dots, lh.history_dots(SY, y, s, g)) and torch.equal(
            comb, lh.history_combine(SY, g, coef, gamma))):
        raise AssertionError(f"{tag}: two launches of a history kernel "
                             "differ")
    log(f"  {tag}: two launches of each kernel bit-equal")
    if dtype != torch.float32:
        return None
    runs = {
        "lbfgs_history_dots": (
            lambda: lh.history_dots(SY, y, s, g),
            lambda: lh.history_dots_plain(SY, y, s, g),
            lambda: torch.mm(SY, V), "torch.mm(SY, V)", err_d,
            4 * (2 * m * p + 3 * p + 6 * m), 12 * m * p,
            "hidenn_fem_tpu/solve/optimizers.py:155"),
        "lbfgs_history_combine": (
            lambda: lh.history_combine(SY, g, coef, gamma),
            lambda: lh.history_combine_plain(SY, g, coef, gamma),
            lambda: coef @ SY, "coef @ SY", err_c,
            4 * (2 * m * p + 2 * p + 2 * m + 1), 4 * m * p + 3 * p,
            "hidenn_fem_tpu/solve/optimizers.py:201"),
    }
    entries = []
    for name, (kfn, pfn, lfn, lname, err, bytes_, flops, replaces) in \
            runs.items():
        kms, pms, lms = ab_library_ms(kfn, pfn, lfn)
        lib_us, _ = device_us(lfn)
        log(f"  {tag} {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
            f"library {lname} {lms:.4f} ms ({lib_us:.2f} us device) "
            f"[{card}]")
        entries.append(kernel_entry(
            name, "hidenn_fem_tpu_torch/csrc/lbfgs_history.cu", replaces,
            err, kms, pms, bytes_, flops, device_us(kfn), card,
            library_ms=lms, tag=f"{tag} "))
    return entries


def phase_lbfgs_history(lh, shapes, dev, card):
    """Phase 3h: the history passes at each (tag, m, P) of ``shapes``
    (the first gives the JSON entries), and the smallest again in
    float64."""
    entries = None
    for tag, m, p in shapes:
        out = history_case(lh, tag, m, p, dev, card)
        entries = entries or out
        torch.cuda.empty_cache()
    tag, m, p = min(shapes, key=lambda t: t[1] * t[2])
    history_case(lh, f"{tag} (float64)", m, p, dev, card, torch.float64)
    torch.cuda.empty_cache()
    return entries


def lbfgs_from_rest(ht, energy, mesh, dev, steps):
    """run_lbfgs from u0 = 1e-5 N(0,1) after a 3-step warm-up; returns
    (params, losses as numpy, seconds of the timed solve)."""
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    ht.run_lbfgs(energy.total, params, num_steps=3, loss_args=(mesh,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(energy.total, params, num_steps=steps,
                                  loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = losses.cpu().numpy()
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"energy not finite and falling: {losses[0]} "
                             f"-> {losses[-1]}")
    return params, losses, seconds


def check_ref(what, got, f32, f32_rtol, f64=None):
    """|got - ref| <= rtol |ref| against the JAX f32 value and, when
    given, the JAX f64 value (at F64_RTOL)."""
    refs = [("f32", f32, f32_rtol)] + (
        [] if f64 is None else [("f64", f64, F64_RTOL)])
    for name, want, rtol in refs:
        rel = abs(got - want) / abs(want)
        log(f"  {what}: {got!r} vs JAX {name} {want!r}: rel {rel:.3e} "
            f"(limit {rtol})")
        if rel > rtol:
            raise AssertionError(f"{what} off the JAX {name} value")


def phase_delaunay_solve(ht, be, mesh, dev, card, steps=50):
    """Phase 8: the slice's main path on the 898K Delaunay plate; returns
    (losses, the params after the solve)."""
    from hidenn_fem_tpu_torch import postproc

    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model)
    before = dict(be.launch_counts)
    params, losses, seconds = lbfgs_from_rest(ht, energy, mesh, dev, steps)
    vg = be.launch_counts["banded_vg"] - before["banded_vg"]
    if vg != steps + 3:
        raise AssertionError(f"K4 launched {vg} times in {steps} + 3 "
                             "steps")
    before = be.launch_counts["banded_fwd"]
    with torch.no_grad():
        at_solution = float(energy.total(params, mesh))
    if be.launch_counts["banded_fwd"] != before + 1:
        raise AssertionError("the no_grad energy did not run K3")
    for i in range(0, steps, 10):
        log(f"  Iter {i:04d}: Loss = {losses[i]:.6e}")
    check_ref("898K Delaunay energy at init", float(losses[0]),
              JAX_DELAUNAY_INIT, INIT_RTOL)
    check_ref(f"898K Delaunay energy at step {DELAUNAY_COMPARE_STEP}",
              float(losses[DELAUNAY_COMPARE_STEP]), JAX_DELAUNAY_F32_AT_STEP,
              F32_SPREAD_RTOL, JAX_DELAUNAY_F64_AT_STEP)
    # the solve is unconverged at step 50, so the energy at the solution
    # is held to the plain route's at the same point, not to the last loss
    with torch.no_grad():
        plain = float(ht.PlaneStressEnergy(model=model, backend="plain")
                      .total(params, mesh))
    rel = abs(at_solution - plain) / abs(plain)
    log(f"  energy at the solution under no_grad: K3 {at_solution!r} vs the "
        f"plain banded gather {plain!r}: rel {rel:.3e} (limit "
        f"{ENERGY_RTOL})")
    if not np.isfinite(at_solution) or rel > ENERGY_RTOL:
        raise AssertionError("no_grad energy off the plain route's")
    vm = postproc.von_mises_per_element(model, params, mesh, 10e9, 0.3)
    if not (bool(torch.isfinite(vm).all()) and float(vm.max()) > 0.0):
        raise AssertionError("bad von Mises stress")
    log(f"  max von Mises stress {float(vm.max()):.6e}")
    log(f"  898K Delaunay L-BFGS (banded route, paired tables) at "
        f"{mesh.n_elements} elements: {steps} steps in {seconds:.3f} s, "
        f"{1e3 * seconds / steps:.4f} ms/iter [{card}]")
    return losses, params


def phase_banded_fallback(ht, mesh, dev, card, main_losses, name, keep,
                          steps=5):
    """One fallback of the banded gradient for a few steps: ``keep`` the
    recompute tables (no ownership intervals: K3 + K5 over the recompute
    windows) or not (K3 + K5 over the two-pass windows)."""
    from tools.profile_torch_port import without_recompute

    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())
    m = dataclasses.replace(mesh, banded_paired=without_recompute(
        mesh.banded_paired, keep))
    _, losses, seconds = lbfgs_from_rest(ht, energy, m, dev, steps)
    rel = np.abs(losses[:2] - main_losses[:2]) / np.abs(main_losses[:2])
    log(f"  fallback ({name}): {steps} steps, {1e3 * seconds / steps:.4f}"
        f" ms/iter, losses[:2] rel {rel.max():.3e} to the main path "
        f"[{card}]")
    if rel.max() > INIT_RTOL:
        raise AssertionError(f"fallback ({name}) off the main path")


def phase_hybrid(ht, ee, dev, card):
    """Phase 9: the hybrid route at scale."""
    t0 = time.perf_counter()
    mesh = ht.generate_mesh_hybrid(holes=HOLES, lc=HYBRID_LC, device=dev)
    build_s = time.perf_counter() - t0
    hy = mesh.hybrid
    sizes = (mesh.n_elements, mesh.n_nodes, hy.extra_conn.shape[0],
             hy.stair_ids.shape[0])
    log(f"  hybrid plate: {sizes[0]} elements, {sizes[1]} nodes, {sizes[2]}"
        f" collar triangles, {sizes[3]} stair rows, lattice "
        f"{hy.lattice.nx}x{hy.lattice.ny} ({build_s:.2f} s on the host)")
    if sizes != HYBRID_SIZES:
        raise AssertionError(f"unexpected hybrid mesh sizes {sizes}")
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model)
    params = perturbed_params(ht, mesh, dev, coord_scale=2e-5)
    gather = dataclasses.replace(mesh, hybrid=None)
    before = dict(ee.launch_counts)
    vh, gch, guh = value_and_grads(energy, params, mesh)
    if ee.launch_counts != before:
        raise AssertionError("the hybrid route launched a gather kernel")
    vg, gcg, gug = value_and_grads(energy, params, gather)
    if ee.launch_counts["element_energy_fwd"] == before["element_energy_fwd"]:
        raise AssertionError("the stripped mesh did not take the gather "
                             "route")
    tag = "hybrid route vs gather route"
    check_close(f"{tag} energy", vh, vg, ENERGY_RTOL, 0.0)
    check_close(f"{tag} d/d coords", gch, gcg, GRAD_RTOL, GRAD_ATOL)
    check_close(f"{tag} d/d u", guh, gug, GRAD_RTOL, GRAD_ATOL)
    hms, gms = ab_ms(lambda: value_and_grads(energy, params, mesh),
                     lambda: value_and_grads(energy, params, gather))
    log(f"  value-and-grad at {mesh.n_elements} elements: hybrid route "
        f"{hms:.4f} ms, gather route (K1, K2, incidence_sum) {gms:.4f} ms "
        f"[{card}]")

    def solve():
        _, losses, seconds = lbfgs_from_rest(ht, energy, mesh, dev,
                                             HYBRID_STEPS)
        check_ref("hybrid energy at init", float(losses[0]),
                  JAX_HYBRID_INIT, INIT_RTOL)
        check_ref(f"hybrid energy at step {HYBRID_STEPS - 1}",
                  float(losses[-1]), JAX_HYBRID_F32_LAST, F32_SPREAD_RTOL,
                  JAX_HYBRID_F64_LAST)
        log(f"  hybrid L-BFGS at {mesh.n_elements} elements: "
            f"{1e3 * seconds / HYBRID_STEPS:.4f} ms/iter [{card}]")
    return solve, mesh


def rest_params(ht, mesh, dev):
    """coords at the mesh, u0 = 1e-5 N(0,1) (np.random.default_rng(0))."""
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    return ht.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                 "u": u0}, device=dev)


def sharded_inputs(ht, mesh922, tri898, mesh4, hybrid, dev):
    """Each sharded path's mesh (the tables it does not use stripped, to
    keep the ranks' file small), params ("vg": perturbed, "init": at
    rest) and energy, keyed as SHARDED_PATHS names them."""
    from hidenn_fem_tpu_torch.parallel import pad_mesh

    def strip(m, **keep):
        return dataclasses.replace(m, **{**dict(
            incidence=None, banded=None, banded_paired=None,
            fused_connectivity=None, fused_incidence=None), **keep})

    def params(m, coord_scale=1e-3):
        return {"vg": perturbed_params(ht, m, dev, coord_scale),
                "init": rest_params(ht, m, dev)}

    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())
    ba = tri898.banded_paired
    no_own = dataclasses.replace(ba, re_own_lo=None, re_own_hi=None)
    p898 = params(tri898, 2e-5)
    return {
        "plate922": (strip(mesh922), params(mesh922), energy),
        "delaunay898": (strip(tri898, banded_paired=ba), p898, energy),
        "delaunay898_no_own": (strip(tri898, banded_paired=no_own), p898,
                               energy),
        # padded for 4 ranks, which 1 and 2 divide too
        "ex4_padded": (strip(pad_mesh(mesh4, 4)), params(mesh4), energy),
        "ex4": (strip(mesh4), params(mesh4), energy),
        "hybrid847": (strip(hybrid), params(hybrid, 2e-5), energy),
    }


def plate_energy(ht, cfg, model):
    return ht.PlaneStressEnergy(
        model=model, E=cfg.youngs_modulus, nu=cfg.poisson_ratio,
        gauss_order=cfg.gauss_order, gauss_order_1d=cfg.gauss_order_1d,
        F_total=cfg.traction_total, traction_length=cfg.traction_length)


def solve_example4(ht, mesh, dev, card, want, route_name):
    """Example 4's 600-step solve on ``mesh``; checks the final energy
    against the JAX value ``want`` and the von Mises stress."""
    from hidenn_fem_tpu_torch import postproc
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    model = ht.TriangleP1(u_fixed=0.0)
    energy = plate_energy(ht, cfg, model)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    # warm-up outside the timed solve: the first L-BFGS steps of a process
    # load the solver's kernels and libraries
    ht.run_lbfgs(energy.total, params, num_steps=3, loss_args=(mesh,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(energy.total, params,
                                  num_steps=cfg.lbfgs_steps,
                                  loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        at_solution = float(energy.total(params, mesh))
    losses = losses.cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite energy in the {route_name} solve")
    for i in range(0, cfg.lbfgs_steps, 100):
        log(f"  Iter {i:04d}: Loss = {losses[i]:.6e}")
    final = float(losses[-1])
    rel = abs(final - want) / abs(want)
    log(f"  {route_name}: final energy {final!r} vs JAX {want!r}: rel "
        f"{rel:.3e} (limit {EX4_RTOL})")
    if rel > EX4_RTOL:
        raise AssertionError(f"example-4 {route_name} final energy off the "
                             "JAX value")
    rel2 = abs(at_solution - final) / abs(final)
    log(f"  {route_name}: energy at the solution under no_grad "
        f"{at_solution!r} vs the last loss: rel {rel2:.3e} "
        f"(limit {EX4_RTOL})")
    if rel2 > EX4_RTOL:
        raise AssertionError("no_grad energy at the solution off the last "
                             "loss")
    vm = postproc.von_mises_per_element(model, params, mesh,
                                        cfg.youngs_modulus,
                                        cfg.poisson_ratio)
    vm_max = float(vm.max())
    if not (np.isfinite(vm_max) and vm_max > 0.0
            and bool(torch.isfinite(vm).all())):
        raise AssertionError(f"bad von Mises stress (max {vm_max})")
    log(f"  {route_name}: max von Mises stress {vm_max:.6e}")
    log(f"  example-4 {route_name} 600-step solve: {seconds:.3f} s "
        f"({1e3 * seconds / cfg.lbfgs_steps:.4f} ms/iter) [{card}]")
    return final


def example4_mesh(ht, dev):
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    mesh = ht.generate_mesh(cfg.length, cfg.height, list(cfg.holes),
                            cfg.make_boundaries(), cfg.nx, cfg.ny,
                            keep_dead_nodes=True, device=dev)
    log(f"  example-4 plate: {mesh.n_nodes} nodes, {mesh.n_elements} "
        f"elements, {mesh.n_neumann_edges} Neumann edges; lattice route "
        f"{mesh.lattice.nx}x{mesh.lattice.ny}, identity "
        f"{mesh.lattice.identity}")
    return mesh


def phase_example6(dev, card):
    """Phase 6: example 6 at full size; returns the solve's loss history."""
    from examples.example6_structured_torch import main as example6

    t0 = time.perf_counter()
    _, losses, vm, final = example6(device=dev)
    seconds = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"example-6 energy did not fall: {losses[0]} "
                             f"-> {losses[-1]}")
    vm_max = float(vm.max())
    if not (bool(torch.isfinite(vm).all()) and vm_max > 0.0):
        raise AssertionError(f"bad example-6 von Mises stress ({vm_max})")
    if not np.isfinite(final):
        raise AssertionError("non-finite example-6 energy at the solution")
    log(f"  example 6: energy {losses[0]:.6e} -> {losses[-1]:.6e} in "
        f"{len(losses)} steps, {final:.6e} at the solution; max von Mises "
        f"{vm_max:.6e}; {seconds:.3f} s with set-up and post-processing "
        f"[{card}]")
    at = float(losses[EX6_COMPARE_STEP])
    rel = abs(at - JAX_EX6_F32_AT_STEP) / abs(JAX_EX6_F32_AT_STEP)
    log(f"  example 6 at step {EX6_COMPARE_STEP}: {at!r} vs JAX f32 "
        f"{JAX_EX6_F32_AT_STEP!r} (f64 {JAX_EX6_F64_AT_STEP!r}): rel "
        f"{rel:.3e} (limit {EX6_RTOL})")
    if rel > EX6_RTOL:
        raise AssertionError("example-6 energy off the JAX value")
    rel = abs(float(losses[-1]) - JAX_EX6_F64_FINAL) / abs(JAX_EX6_F64_FINAL)
    log(f"  example 6 after {len(losses)} steps: {float(losses[-1])!r} vs "
        f"JAX f64 {JAX_EX6_F64_FINAL!r}: rel {rel:.3e} (limit "
        f"{EX6_FINAL_RTOL}, the spread of the reference runs)")
    if rel > EX6_FINAL_RTOL:
        raise AssertionError("example-6 final energy outside the spread "
                             "of the reference runs")
    return losses


def phase_scale(ht, mesh, dev, card, steps=50):
    """Phase 7: L-BFGS on the 922K-class plate, lattice route."""
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    ht.run_lbfgs(energy.total, params, num_steps=3, loss_args=(mesh,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = ht.run_lbfgs(energy.total, params, num_steps=steps,
                             loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = losses.cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite energy in the 922K-class solve")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"922K-class solve did not descend: "
                             f"{losses[0]} -> {losses[-1]}")
    log(f"  922K-class L-BFGS: energy {losses[0]:.6e} -> "
        f"{losses[-1]:.6e} in {steps} steps")
    log(f"  922K-class L-BFGS (lattice route) at {mesh.n_elements} "
        f"elements: {1e3 * seconds / steps:.4f} ms/iter [{card}]")


# ------------------------------------------------- the linear solvers
def check_launches(name, launches, want):
    """The launches ``want`` names, exactly (the others unchecked)."""
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")


def check_hist(name, hist):
    """The executed part of a residual history (fails on a non-finite
    residual: a diverged solve)."""
    h = hist.cpu().double().numpy()
    if not np.all(np.isfinite(h)):
        raise AssertionError(f"{name}: non-finite residual (diverged)")
    k = int(np.count_nonzero(h))
    if k == 0 or np.any(h[k:] != 0.0):
        raise AssertionError(f"{name}: history not zero past the stop")
    return h[:k]


def stop_read_ms(solve):
    """Host ms per stop-test read of ``solve()`` (a solver run): the CPU
    time of the device reads (``aten::_local_scalar_dense``, the wait for
    the device included) from torch.profiler, per read; and the reads."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve()
        torch.cuda.synchronize()
    reads = [e for e in prof.key_averages()
             if e.key == "aten::_local_scalar_dense"]
    if not reads or reads[0].count == 0:
        raise AssertionError("the profiler saw no stop-test read")
    return reads[0].cpu_time_total / 1e3 / reads[0].count, reads[0].count


def phase_example8(dev, card):
    """Phase 11a: example 8 at its own size (81x41 proxy plate, lattice
    route: K6 each matvec, K7 each energy under no_grad)."""
    from examples.example8_linear_solve_torch import main as example8

    t0 = time.perf_counter()
    _, energies, hist, e_cg = example8(device=dev)
    seconds = time.perf_counter() - t0
    h = check_hist("example-8 CG", hist)
    log(f"  example 8: CG {len(h)} iterations to rel res {h[-1]:.6e} (JAX: "
        f"{JAX_EX8_CG_ITERS} to {JAX_EX8_CG_RELRES!r}); {seconds:.3f} s "
        f"with the r-adaptive epochs [{card}]")
    if h[-1] > max(JAX_EX8_CG_RELRES, 1e-6):
        raise AssertionError("example-8 CG plateau above JAX's")
    check_ref("example-8 CG energy", e_cg, JAX_EX8_CG_ENERGY, SOLVE_RTOL)
    for i, (got, want) in enumerate(zip(energies, JAX_EX8_RADAPT)):
        check_ref(f"example-8 r-adaptive energy, epoch {i}", float(got),
                  want, SOLVE_RTOL)
    if not energies[-1] < energies[0]:
        raise AssertionError("example-8 r-adaptive energies did not fall")


def phase_cg_898k(ht, be, mesh, dev, card, counts):
    """Phase 11b: the CG family on the 898K Delaunay plate (banded route,
    K4 each matvec and probe, K3 each energy under no_grad), from u = 0,
    capped at CG_CAP iterations; returns the path's launch counts."""
    from hidenn_fem_tpu_torch.mesh import coloring, native

    conn = mesh.connectivity
    t0 = time.perf_counter()
    colors = coloring.color_nodes(conn, mesh.n_nodes)
    color_s = time.perf_counter() - t0
    if not coloring.check_coloring(conn, colors):
        raise AssertionError("color_nodes gave an improper coloring")
    n_colors = int(colors.max()) + 1
    if native.available():
        raise AssertionError("the native library is on before phase 20")
    if not np.array_equal(colors, coloring._greedy_color_numpy(
            conn.cpu().numpy(), mesh.n_nodes)):
        raise AssertionError("color_nodes differs from the numpy rounds")
    log(f"  898K coloring: {n_colors} colors (JAX: {JAX_898K_COLORS}) "
        f"in {color_s:.2f} s on the host; check_coloring passes")
    if n_colors != JAX_898K_COLORS:
        raise AssertionError("color count differs from the JAX package's")
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    args = (mesh.coords, mesh)
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}

    def path():
        out = {}
        before = be.launch_counts["banded_vg"]
        t0 = time.perf_counter()
        diag = ht.jacobi_diagonal(loss, u0, args, colors)["u"]
        torch.cuda.synchronize()
        probes = be.launch_counts["banded_vg"] - before - 1
        log(f"  jacobi_diagonal: {probes} probes ({n_colors} colors x 2 "
            f"components) in {time.perf_counter() - t0:.3f} s [{card}]")
        fixed = mesh.dirichlet_mask
        if not (bool(torch.isfinite(diag).all())
                and bool((diag[fixed] == 0).all())
                and bool((diag[~fixed] != 0).all())):
            raise AssertionError("Jacobi diagonal not finite, or not zero "
                                 "exactly on the Dirichlet rows")
        for name, solve, want in (
                ("cg_solve", lambda: ht.cg_solve(
                    loss, u0, args, max_iters=CG_CAP, tol=1e-6),
                 JAX_898K_CG),
                ("jacobi_pcg_solve", lambda: ht.jacobi_pcg_solve(
                    loss, u0, args, node_colors=colors, max_iters=CG_CAP,
                    tol=1e-6), JAX_898K_PCG)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol, hist = solve()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            h = check_hist(f"898K {name}", hist)
            with torch.no_grad():
                e = float(loss(sol, *args))
            log(f"  898K {name}: {len(h)} iterations, rel res {h[-1]:.6e}; "
                f"{1e3 * seconds / len(h):.4f} ms/iter [{card}]")
            check_ref(f"898K {name} energy after {CG_CAP} iterations", e,
                      want[0], F32_SPREAD_RTOL, want[1])
            out[name] = seconds / len(h)
        return out

    per_iter, launches = run_path(counts, "898K CG family",
                                  ("banded_vg", "banded_fwd"), path)
    read_ms, reads = stop_read_ms(lambda: ht.cg_solve(
        loss, u0, args, max_iters=20, tol=1e-6))
    log(f"  898K CG stop test: {read_ms:.4f} ms of host time per read "
        f"(profiler, {reads} reads in a 20-iteration solve; the wait for "
        f"the device included) against {1e3 * per_iter['cg_solve']:.4f} "
        f"ms per iteration [{card}]")
    return launches


def phase_minimize_ex4(ht, mesh, dev, card):
    """Phase 11c: minimize(method="cg") and minimize(method="jacobi_cg",
    mesh=...) on example 4 (lattice route: K6 each matvec), from u = 0:
    both reach the same minimum, at or below the 600-step L-BFGS energy.
    (From the 1e-5 N(0,1) start the first residual is the noise's, and a
    relative residual of 1e-6 leaves the solution 5e-3 off in energy:
    measured on the card for jacobi_cg.)"""
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())
    params = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    found = {}
    for method, kw in (("cg", {}), ("jacobi_cg", {"mesh": mesh})):
        t0 = time.perf_counter()
        res = ht.minimize(loss, params, method=method, num_steps=3000,
                          loss_args=(mesh.coords, mesh), **kw)
        seconds = time.perf_counter() - t0
        if res.kind != "relres":
            raise AssertionError(f"minimize({method}).kind is {res.kind!r}")
        h = check_hist(f"example-4 minimize({method})", res.history)
        with torch.no_grad():
            e = float(loss(res.params, mesh.coords, mesh))
        log(f"  example 4, minimize(method={method!r}): {len(h)} "
            f"iterations to rel res {h[-1]:.6e}, energy {e!r}, kind "
            f"{res.kind!r}; {seconds:.3f} s [{card}]")
        if h[-1] > 1e-6:
            raise AssertionError(f"minimize({method}) did not converge")
        check_ref(f"example-4 energy by minimize({method}) against the "
                  "600-step L-BFGS", e, JAX_EX4_LATTICE_FINAL_ENERGY,
                  EX4_RTOL)
        found[method] = e
    rel = abs(found["cg"] - found["jacobi_cg"]) / abs(found["cg"])
    log(f"  example 4: cg and jacobi_cg minima rel {rel:.3e} (limit "
        f"{SOLVE_RTOL})")
    if rel > SOLVE_RTOL:
        raise AssertionError("cg and jacobi_cg reach different minima")


def phase_multigrid(ht, ls, dev, card, counts):
    """Phase 12: example 9 at full width (961x481, 921,600 elements):
    hierarchy, MG-PCG (the level steps every level operator, K6 the
    right-hand side, K7 the energy), held to JAX and to the port's own CG;
    then 2 r-adaptive epochs, and the level kernels on the hierarchy's
    levels against their plain versions (``level_kernels``).  Returns the
    example's launches and the level kernels' entries."""
    from examples.example9_multigrid_torch import main as example9
    from hidenn_fem_tpu_torch.models.structured_grid import (
        StructuredGridP1, generate_structured_grid)

    (sol, hist, _, levels), launches = run_path(
        counts, "example-9 MG-PCG", ("lattice_stencil_vg",
                                     "lattice_stencil_fwd",
                                     "lattice_level_step"),
        lambda: example9(device=dev))
    shapes = [(lv.grid.nx, lv.grid.ny) for lv in levels]
    if shapes != MG_SHAPES:
        raise AssertionError(f"hierarchy {shapes}, expected {MG_SHAPES}")
    for (nx, ny), lv, want in zip(shapes, levels, JAX_MG_LMAX):
        check_ref(f"lmax of the {nx}x{ny} level", lv.lmax_host, want,
                  INIT_RTOL)
    h = check_hist("example-9 MG-PCG", hist)
    if h[-1] > 1e-6:
        raise AssertionError("MG-PCG did not reach 1e-6")
    log(f"  MG-PCG: {len(h)} iterations (JAX: {JAX_MG_ITERS}) to "
        f"{h[-1]:.6e}")
    grid = generate_structured_grid(length=2.0, height=1.0, holes=(),
                                    nx=961, ny=481, device=dev)
    model = StructuredGridP1(E=10e9, nu=0.3)
    params = model.init(np.random.default_rng(0), grid, device=dev)
    with torch.no_grad():
        e_mg = float(model(sol, grid))
    check_ref("961x481 MG-PCG energy", e_mg, JAX_MG_ENERGY[0], SOLVE_RTOL,
              JAX_MG_ENERGY[1])

    # the warm solve, timed, with its launches per iteration: K6 once (the
    # right-hand side), the level steps a V-cycle for the start and a
    # V-cycle and K p each call of the loop body
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    _, hist = ht.mg_pcg_solve(model, grid, params, max_iters=40, tol=1e-6,
                              levels=levels)
    iters = len(check_hist("warm MG-PCG", hist))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts.read()
    calls = loop_calls(iters, 40)
    level = {k: launched[k] for k in ls.LEVEL_KERNELS}
    log(f"  warm MG-PCG: {iters} iterations ({calls} calls of the loop "
        f"body) in {seconds:.3f} s, {1e3 * seconds / iters:.3f} ms per "
        f"iteration; {launched['lattice_stencil_vg']} K6 launches, level "
        f"kernels {level}, {sum(level.values()) / calls:.2f} per call "
        f"[{card}]")
    check_launches("warm MG-PCG", launched, {
        "lattice_stencil_vg": 1,
        **solve_launches(model, levels, calls, matvecs=calls)})

    # the port's own CG on the same system from the same start.  That
    # start's first residual is the noise's, so a relative residual of
    # 1e-6 leaves CG's energy 5.3e-4 off MG-PCG's (measured on the card;
    # at 481x241 on the CPU, CG from u = 0 needs 4,018 iterations and
    # lands 2.8e-6 from MG-PCG), hence PERF.md section 2's solve limit
    def loss(p, coords, g):
        return model({"coords": coords, "u": p["u"]}, g)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg, hist = ht.cg_solve(loss, {"u": params["u"]},
                           (params["coords"], grid), max_iters=MG_CG_CAP,
                           tol=1e-6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    h = check_hist("961x481 CG", hist)
    with torch.no_grad():
        e_cg = float(loss(cg, params["coords"], grid))
    rel = abs(e_mg - e_cg) / abs(e_cg)
    du = float((sol["u"] - cg["u"]).abs().max() / cg["u"].abs().max())
    log(f"  961x481 cg_solve: {len(h)} iterations to {h[-1]:.6e} in "
        f"{seconds:.3f} s ({1e3 * seconds / len(h):.4f} ms/iter); energy "
        f"{e_cg!r}; MG-PCG's {e_mg!r}: rel {rel:.3e} (limit {EX4_RTOL}); "
        f"max|u_mg - u_cg| / max|u_cg| {du:.3e} [{card}]")
    if rel > EX4_RTOL:
        raise AssertionError("MG-PCG energy off the port's CG solution")

    def radapt():
        t0 = time.perf_counter()
        _, energies = ht.radapt_mg_solve(model, grid, params,
                                         outer_epochs=2, coord_steps=10,
                                         coord_lr=RADAPT_MG_LR)
        e = energies.cpu().numpy()
        log(f"  radapt_mg_solve, 2 epochs: energies {float(e[0])!r} -> "
            f"{float(e[1])!r} "
            f"({time.perf_counter() - t0:.3f} s) [{card}]")
        if not (np.all(np.isfinite(e)) and e[1] < e[0]):
            raise AssertionError("r-adaptive MG energies did not fall")

    run_path(counts, "961x481 r-adaptive MG", ("lattice_stencil_vg",
                                                "lattice_stencil_fwd"),
             radapt)
    return launches, level_kernels(ls, "961x481 MG", model, levels, card)


# The multigrid level kernels against their plain versions on the same
# inputs, as tests/test_torch_level_step.py holds them: the plain stencil
# sums in another order than K6, so each output within LEVEL_ATOL of its
# largest entry (LEVEL_CYCLE_ATOL for the bottom levels' V-cycle), the
# restriction bit for bit
LEVEL_ATOL = 1e-5
LEVEL_CYCLE_ATOL = 1e-4
# Bytes a node each level step reads and writes once (float32 vectors of
# 8 B a node, the pinned mask 1 B): coordinates, mask and the staged
# vector read and w written (K d); b read besides (the residual); d, r, x
# and dinv read and r, d, x written (a step); b and dinv read and r, d, x
# written (the first two steps from x = 0); x, free, b and dinv read and
# r, d, x written (the prolonged correction with the first post-step, xc
# besides).  Each quad's two presence weights: 8 B more.
LEVEL_NODE_BYTES = {"MATVEC": 25, "RESIDUAL": 33, "STEP": 65,
                    "FROM_ZERO": 49, "POST_FIRST": 65}


def level_gap(got, want):
    """(the largest max |got - want| over max |want|, the largest
    max |got - want|) over the outputs."""
    gaps = [(g.double() - w.double()).abs().max() for g, w in zip(got, want)]
    return (max(float(e) / max(float(w.double().abs().max()), 1e-300)
                for e, w in zip(gaps, want)), max(float(e) for e in gaps))


def level_kernels(ls, tag, model, levels, card):
    """The multigrid level kernels on a hierarchy (``levels`` with their
    V(3, 3) smoothers, the coarsest to degree 24, as ``multigrid._vcycle``
    hands them over on the card) against their plain versions on the same
    seeded inputs: every level step kind (K6's level epilogues: K d, the
    residual, a Chebyshev step, the first two steps from x = 0, the
    prolonged correction with the first post-step) and the restriction on
    every level, within LEVEL_ATOL of the largest entry (the restriction
    bit for bit), and the whole V-cycle and the bottom cycle
    (``level_bottom_kernel``, from the first level whose levels fit it)
    within LEVEL_CYCLE_ATOL.  Each kernel
    on a level above the bottom, and the bottom cycle, is timed against
    its plain version and profiled; returns their kernel entries (one a
    kind and level, ``variant`` names them)."""
    from hidenn_fem_tpu_torch.solve import multigrid as mg

    lat = mg._fused_levels(mg._level_ops(model, levels), levels, 3, 24)
    if lat is None:
        raise AssertionError(f"{tag}: the levels are off the level-step "
                             "route")
    bottom = next((k for k in range(len(lat)) if ls._fits_bottom(lat[k:])),
                  len(lat))
    src = "hidenn_fem_tpu_torch/csrc/lattice_stencil.cu"
    jax_mg = "hidenn_fem_tpu/solve/multigrid.py"
    gen = torch.Generator(device=lat[0].coords.device).manual_seed(24)

    def vec(shape, scale, mask=None):
        v = scale * torch.randn(shape, generator=gen, device=gen.device)
        return v if mask is None else v * mask

    entries = []
    for k, (lev, lv) in enumerate(zip(levels, lat)):
        nx, ny = lv.nx, lv.ny
        n, shape = nx * ny, (nx, ny, 2)
        t1, t2 = lv.stencil["t1"], lv.stencil["t2"]
        tris = int((t1 != 0).sum()) + int((t2 != 0).sum())
        quad_bytes = 8 * (nx - 1) * (ny - 1)
        b, r = vec(shape, 1e3, lev.free), vec(shape, 1e3)
        d, x = vec(shape, 1e-6, lev.free), vec(shape, 1e-6, lev.free)
        c = lv.coeffs[0]
        coarse = k < len(lat) - 1
        xc = vec((lat[k + 1].nx, lat[k + 1].ny, 2), 1e-6) if coarse else None
        nc = 0 if xc is None else xc.shape[0] * xc.shape[1]
        # a step updates r and x in place: it gets copies of its own
        kinds = {"MATVEC": (ls.MATVEC, d, {}),
                 "RESIDUAL": (ls.RESIDUAL, x, {"b": b}),
                 "STEP": (ls.STEP, d, {"r": r.clone(), "x": x.clone(),
                                       "c": c}),
                 "FROM_ZERO": (ls.FROM_ZERO, b, {"c": c})}
        if coarse:
            kinds["POST_FIRST"] = (ls.POST_FIRST, x, {"b": b, "xc": xc})
        timed = k < bottom
        worst = {}
        for kind, (code, v, kw) in kinds.items():
            def kernel(code=code, v=v, kw=kw):
                return ls.lattice_level_step(code, lv, v, **kw)

            def plain(code=code, v=v, kw=kw):
                return ls.lattice_level_step_plain(code, lv, v, **kw)
            # the check on copies of r and x, read before the kernel
            # writes them
            fresh = {key: t.clone() if key in ("r", "x") else t
                     for key, t in kw.items()}
            want = plain(kw=fresh)
            got = ls.lattice_level_step(code, lv, v, **fresh)
            want, got = ([t] if torch.is_tensor(t) else list(t)
                         for t in (want, got))
            worst[kind], err = level_gap(got, want)
            if worst[kind] > LEVEL_ATOL:
                raise AssertionError(f"{tag} {kind} at {nx}x{ny}: kernel "
                                     f"and plain {worst[kind]:.3g} of the "
                                     "largest entry apart")
            if not timed:
                continue
            ms, plain_ms = ab_ms(kernel, plain)
            # the stencil's strain and cotangents of each triangle: a floor
            # of its operations (the bytes bound it)
            e = kernel_entry(
                "lattice_level_step", src, f"{jax_mg}:259 (_cheb_smooth)",
                err, ms, plain_ms, LEVEL_NODE_BYTES[kind] * n + quad_bytes
                + (8 * nc if code == ls.POST_FIRST else 0),
                tris * (TRI_E + TRI_C), device_us(kernel), card,
                tag=f"{tag} {kind} at {nx}x{ny} ")
            e["variant"] = f"{tag} {kind} at {nx}x{ny}"
            entries.append(e)
        if coarse:
            res = ls.lattice_level_step(ls.RESIDUAL, lv, x, b=b)
            got, want = ls.lattice_restrict(res), ls.restrict_plain(res)
            if not torch.equal(got, want):
                raise AssertionError(f"{tag} restriction of {nx}x{ny}: "
                                     "kernel and plain differ")
            if timed:
                ms, plain_ms = ab_ms(lambda: ls.lattice_restrict(res),
                                     lambda: ls.restrict_plain(res))
                # a coarse entry: the column pass on three rows and the row
                # pass, four operations each, for each component
                e = kernel_entry(
                    "lattice_restrict", src, f"{jax_mg}:110 (_restrict)",
                    0.0, ms, plain_ms, 8 * n + 8 * nc, 32 * nc,
                    device_us(lambda: ls.lattice_restrict(res)), card,
                    tag=f"{tag} restriction of {nx}x{ny} ")
                e["variant"] = f"{tag} restriction of {nx}x{ny}"
                entries.append(e)
        log(f"  {tag} level {nx}x{ny}: kernel against plain, largest gap "
            "of the largest entry "
            + ", ".join(f"{kind} {g:.3g}" for kind, g in worst.items())
            + (", restriction 0 (bit-equal)" if coarse else ""))
    b = vec((lat[0].nx, lat[0].ny, 2), 1e3, levels[0].free)
    gap, _ = level_gap([ls.lattice_level_cycle(lat, b)],
                       [ls.lattice_level_cycle_plain(lat, b)])
    log(f"  {tag} V-cycle from {lat[0].nx}x{lat[0].ny}: kernels against "
        f"plain {gap:.3g} of the largest entry")
    if gap > LEVEL_CYCLE_ATOL:
        raise AssertionError(f"{tag} V-cycle: kernels and plain {gap:.3g} "
                             "of the largest entry apart")
    if bottom == len(lat):
        return entries
    sub = lat[bottom:]
    b = vec((sub[0].nx, sub[0].ny, 2), 1e3, levels[bottom].free)
    got = ls.lattice_bottom_cycle(sub, b)
    want = ls.lattice_level_cycle_plain(sub, b)
    gap, err = level_gap([got], [want])
    where = (f"{len(sub)} levels, {sub[0].nx}x{sub[0].ny} to "
             f"{sub[-1].nx}x{sub[-1].ny}")
    log(f"  {tag} bottom cycle over {where}: kernel against plain "
        f"{gap:.3g} of the largest entry")
    if gap > LEVEL_CYCLE_ATOL:
        raise AssertionError(f"{tag} bottom cycle: kernel and plain "
                             f"{gap:.3g} of the largest entry apart")
    ms, plain_ms = ab_ms(lambda: ls.lattice_bottom_cycle(sub, b),
                         lambda: ls.lattice_level_cycle_plain(sub, b))
    # each input read once, the answer written once; its stencil passes
    # (2 nu a level above the coarsest, degree - 1 on the coarsest)
    bytes_ = 16 * sub[0].nx * sub[0].ny + sum(
        25 * lv.nx * lv.ny + 8 * (lv.nx - 1) * (lv.ny - 1) for lv in sub)
    passes = [2 * len(lv.coeffs) + 2 for lv in sub[:-1]] + [
        len(sub[-1].coeffs)]
    flops = sum(p * (int((lv.stencil["t1"] != 0).sum())
                     + int((lv.stencil["t2"] != 0).sum())) * (TRI_E + TRI_C)
                for p, lv in zip(passes, sub))
    e = kernel_entry(
        "lattice_bottom_cycle", src, f"{jax_mg}:288 (vcycle)",
        err, ms, plain_ms, bytes_, flops,
        device_us(lambda: ls.lattice_bottom_cycle(sub, b)), card,
        tag=f"{tag} bottom cycle over {where} ")
    e["variant"] = f"{tag} bottom cycle over {where}"
    entries.append(e)
    return entries


def phase_node_space(ht, mesh, dev, card, params_space_final):
    """Phase 13: node-space L-BFGS on example 4 (lattice route, K6 each
    step, K7 for the energy at the solution), 600 steps."""
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    energy = plate_energy(ht, cfg, ht.TriangleP1(u_fixed=0.0))
    params = rest_params(ht, mesh, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, losses = ht.lbfgs_node_space(energy, params, mesh,
                                      num_steps=cfg.lbfgs_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = losses.cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite node-space energy")
    with torch.no_grad():
        at_solution = float(energy.total(sol, mesh))
    final = float(losses[-1])
    log(f"  node-space L-BFGS: {cfg.lbfgs_steps} steps in {seconds:.3f} s "
        f"({1e3 * seconds / cfg.lbfgs_steps:.4f} ms/iter); energy "
        f"{losses[0]:.6e} -> {final!r}, {at_solution!r} at the solution "
        f"[{card}]")
    check_ref("node-space final energy", final, JAX_EX4_NODE_SPACE,
              EX4_RTOL)
    check_ref("node-space final energy against phase 4's params-space "
              "solve", final, params_space_final, EX4_RTOL)
    check_ref("node-space energy at the solution", at_solution,
              JAX_EX4_NODE_SPACE_AT_SOLUTION, EX4_RTOL)


# ---------------------------------------------- auxiliary-space PCG
def aux_loss(ht):
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1(), E=10e9, nu=0.3)

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)
    return loss


def check_aux_setup(key, pre):
    """The preconditioner's background, levels and P^T layout as the JAX
    package builds them (JAX_AUX_SETUP)."""
    shape, n_lev, layout = JAX_AUX_SETUP[key]
    got_layout = pre.lat_kind or (
        ("windowed", tuple(pre.ptw_rel.shape), pre.ptw_width)
        if pre.ptw_rel is not None else ("flat", pre.pt_w.shape[1]))
    got = ((pre.grid.nx, pre.grid.ny), len(pre.levels), got_layout)
    log(f"  {key} preconditioner: background {got[0][0]}x{got[0][1]}, "
        f"{got[1]} levels, P^T {got[2]} (JAX: {layout})")
    if got != (shape, n_lev, layout):
        raise AssertionError(f"{key}: preconditioner {got}, JAX builds "
                             f"{(shape, n_lev, layout)}")


def check_aux_iters(name, iters, want):
    lo, hi = min(want) - AUX_ITERS_SPREAD, max(want) + AUX_ITERS_SPREAD
    log(f"  {name}: {iters} iterations (JAX: {want}; limits {lo}-{hi})")
    if not lo <= iters <= hi:
        raise AssertionError(f"{name}: {iters} iterations, outside {lo}-"
                             f"{hi}")


def timed_aux_solve(ht, counts, name, loss, args, pre, fine, card):
    """Three solves from rest, timed on the host clock, with their
    launches counted exactly: the first on a copy of the prebuilt
    preconditioner without its plan, so it builds one, the second and
    the third on the plan it keeps (the second records the loop's start,
    the third replays both graphs).  Each solve launches a V-cycle's
    level kernels (``solve_launches``) before the loop and each call of
    the loop body (the iterations, and the masked calls past the stop), and
    the fine gradient at the start and once a call on ``fine``'s kernel
    (None: the hybrid route, no kernel: ``losses.route_counts["hybrid"]``
    counts its energies instead, and is held to the same count); building
    the plan launches nothing more (the fused levels need no gradient at
    zero).  A replay takes the fine gradient twice more, in the check of
    its answer, which is the first's bit for bit (the same loss from the
    same start).  Returns (solution, history, seconds) of the first."""
    from hidenn_fem_tpu_torch.ops import losses
    from hidenn_fem_tpu_torch.solve import auxspace

    mesh = args[1]
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=mesh.coords.device)}
    pre = dataclasses.replace(pre)          # no plan: the first builds one
    before = dict(auxspace.plan_counts)
    runs = []
    for i, what in enumerate(("builds the plan", "replays the iteration",
                              "replays both graphs")):
        torch.cuda.synchronize()
        counts.reset()
        evals = losses.route_counts["hybrid"]
        t0 = time.perf_counter()
        sol, hist = ht.aux_pcg_solve(loss, u0, args, pre=pre,
                                     max_iters=AUX_MAX_ITERS, tol=1e-6)
        h = check_hist(name, hist)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in counts.read().items() if v}
        iters = len(h)
        calls = loop_calls(iters, AUX_MAX_ITERS)
        want = {k: v for k, v in solve_launches(
            pre.bg_model, pre.levels, calls).items() if v}
        fine_calls = 1 + calls + (2 if i else 0)
        if fine is not None:
            want[fine] = want.get(fine, 0) + fine_calls
        else:
            evals = losses.route_counts["hybrid"] - evals
            log(f"  {name}, solve {i + 1}: {evals} energies of the hybrid "
                f"route (expected {fine_calls})")
            if evals != fine_calls:
                raise AssertionError(f"{name}, solve {i + 1}: {evals} "
                                     "hybrid-route energies, expected "
                                     f"{fine_calls}")
        log(f"  {name} from rest, solve {i + 1} ({what}): {iters} "
            f"iterations ({calls} calls of the loop body) to "
            f"{h[-1]:.6e} in {seconds:.3f} s, "
            f"{1e3 * seconds / iters:.3f} ms per iteration; launches "
            f"{launched} (expected {want}), per call "
            + ", ".join(f"{k} {v / calls:.2f}" for k, v in launched.items())
            + f" [{card}]")
        if launched != want:
            raise AssertionError(f"{name}, solve {i + 1}: launches "
                                 f"{launched}, expected {want}")
        if h[-1] > 1e-6:
            raise AssertionError(f"{name}: did not reach relres 1e-6")
        if runs and not (torch.equal(sol["u"], runs[0][0]["u"])
                         and torch.equal(hist, runs[0][3])):
            raise AssertionError(f"{name}, solve {i + 1}: the kept plan's "
                                 "answer is not the first solve's")
        runs.append((sol, h, seconds, hist))
    moved = {k: auxspace.plan_counts[k] - before[k] for k in before}
    log(f"  {name}: aux plans {moved}; the replays bit-equal to the first "
        "solve")
    if moved != {"built": 1, "reused": 2, "refused": 0}:
        raise AssertionError(f"{name}: aux plans {moved}, expected one "
                             "built and two reused")
    return runs[0][:3]


def phase_aux_example10(ht, counts, dev, card):
    """Phase 14a: example 10 at 961x481 (921,600 elements), both
    framings: the example as a user runs it (noise start, timed set-up,
    cold and warm solves), then a solve from rest on its preconditioner
    with exact launch counts (K6 each matvec, the level steps each
    V-cycle)."""
    from examples.example10_auxspace_torch import FRAMINGS
    from examples.example10_auxspace_torch import main as example10

    for label, lattice_bg in FRAMINGS:
        key = "lattice" if lattice_bg else "generic"
        res, _ = run_path(
            counts, f"example-10 aux-PCG, {label}",
            ("lattice_stencil_vg", "lattice_stencil_fwd"),
            lambda: example10(device=dev, framings=((label, lattice_bg),)))
        r = res[label]
        check_aux_setup(key, r["pre"])
        (want_it, f32, f64) = JAX_AUX[(key, "noise")]
        h = check_hist(f"example-10 {label}", r["hist"])
        warm = check_hist(f"example-10 {label}, warm", r["warm_hist"])
        if h[-1] > 1e-6 or warm[-1] > 1e-6:
            raise AssertionError(f"example 10, {label}: relres above 1e-6")
        check_aux_iters(f"example 10, {label}", len(h), want_it)
        log(f"  example 10, {label}: set-up {r['setup_s']:.3f} s, cold "
            f"solve {r['solve_s']:.3f} s, warm solve {r['warm_s']:.3f} s "
            f"({1e3 * r['warm_s'] / len(warm):.3f} ms per iteration, "
            f"{len(warm)} iterations) [{card}]")
        check_ref(f"example-10 energy, {label} (noise start)", r["energy"],
                  f32, F32_SPREAD_RTOL, f64)
        sol, h, _ = timed_aux_solve(ht, counts, f"example 10, {label}",
                                    r["loss"], r["args"], r["pre"],
                                    "lattice_stencil_vg", card)
        (want_it, f32, f64) = JAX_AUX[(key, "rest")]
        check_aux_iters(f"example 10, {label}, from rest", len(h), want_it)
        with torch.no_grad():
            e = float(r["loss"](sol, *r["args"]))
        check_ref(f"example-10 energy, {label} (from rest)", e, f32,
                  SOLVE_RTOL, f64)


def phase_aux_898k(ht, ls, counts, mesh, dev, card):
    """Phase 14b: the 898K Delaunay plate from rest (banded route: K4 each
    matvec and Jacobi probe, the level steps in the V-cycle on the
    generic background,
    K3 the energy under no_grad); then the level kernels on its 513x257
    background against their plain versions (``level_kernels``), whose
    kernel entries it returns."""
    loss = aux_loss(ht)
    args = (mesh.coords, mesh)
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    (want_it, f32, f64) = JAX_AUX[("delaunay", "rest")]

    def path():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = ht.build_aux_preconditioner(
            loss, u0, args, mesh, bg_model=ht.StructuredGridP1(E=10e9,
                                                               nu=0.3))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check_aux_setup("delaunay", pre)
        t0 = time.perf_counter()
        sol, hist = ht.aux_pcg_solve(loss, u0, args, pre=pre,
                                     max_iters=AUX_MAX_ITERS, tol=1e-6)
        h = check_hist("898K aux-PCG", hist)
        seconds = time.perf_counter() - t0
        with torch.no_grad():
            e = float(loss(sol, *args))
        log(f"  898K aux-PCG: set-up {setup_s:.3f} s, {len(h)} iterations "
            f"to {h[-1]:.6e} in {seconds:.3f} s ({1e3 * seconds / len(h):.3f}"
            f" ms per iteration) [{card}]")
        if h[-1] > 1e-6:
            raise AssertionError("898K aux-PCG did not reach 1e-6")
        check_aux_iters("898K aux-PCG", len(h), want_it)
        check_ref("898K aux-PCG energy (from rest)", e, f32, SOLVE_RTOL, f64)
        return pre

    pre, _ = run_path(counts, "898K aux-PCG",
                      ("banded_vg", "banded_fwd", "lattice_level_step"), path)
    timed_aux_solve(ht, counts, "898K aux-PCG, warm", loss, args, pre,
                    "banded_vg", card)
    return level_kernels(ls, "898K aux background", pre.bg_model,
                         pre.levels, card)


def phase_aux_hybrid(ht, counts, mesh, dev, card):
    """Phase 14c: the 847K hybrid plate from rest (kind "reshape" with the
    rim tables; the fine matvec is the plain hybrid route, so the only
    kernels are the V-cycle's level steps), then example 12 at its own
    size."""
    from examples.example12_hybrid_torch import main as example12

    loss = aux_loss(ht)
    args = (mesh.coords, mesh)
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    (want_it, f32, f64) = JAX_AUX[("hybrid", "rest")]

    def path():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = ht.build_aux_preconditioner(
            loss, u0, args, mesh, bg_model=ht.StructuredGridP1(E=10e9,
                                                               nu=0.3))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check_aux_setup("hybrid", pre)
        if pre.rim_corners is None:
            raise AssertionError("the hybrid preconditioner has no rim "
                                 "tables")
        log(f"  847K hybrid aux set-up {setup_s:.3f} s; rim "
            f"{pre.rim_w.shape[0]} nodes, {pre.aff_ids.shape[0]} affected "
            f"background nodes [{card}]")
        return pre

    pre, _ = run_path(counts, "847K hybrid aux set-up",
                      ("lattice_level_step",), path)
    sol, h, _ = timed_aux_solve(ht, counts, "847K hybrid aux-PCG", loss,
                                args, pre, None, card)
    check_aux_iters("847K hybrid aux-PCG", len(h), want_it)
    with torch.no_grad():
        e = float(loss(sol, *args))
    check_ref("847K hybrid aux-PCG energy (from rest)", e, f32, SOLVE_RTOL,
              f64)
    e12, _ = run_path(counts, "example-12 aux-PCG", ("lattice_level_step",),
                      lambda: example12(device=dev))
    if not np.isfinite(e12):
        raise AssertionError("example 12: non-finite energy")


def phase_aux_radapt(ht, counts, dev, card):
    """Phase 14d: example 11 at its own size (lc = 0.05, gather route:
    K1/K2 and incidence_sum each matvec, the level steps in the V-cycle),
    then two
    epochs of radapt_aux_solve on the same mesh: the equilibrated energies
    fall and the pinned coordinates do not move."""
    from examples.example11_delaunay_torch import HOLES as EX11_HOLES
    from examples.example11_delaunay_torch import main as example11

    gather = ("element_energy_fwd", "element_energy_bwd", "incidence_sum",
              "lattice_level_step")
    e11, _ = run_path(counts, "example-11 aux-PCG", gather,
                      lambda: example11(device=dev))
    if not np.isfinite(e11):
        raise AssertionError("example 11: non-finite energy")
    mesh = ht.generate_mesh_delaunay(holes=EX11_HOLES, lc=0.05, device=dev)
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model, E=10e9, nu=0.3)
    params = rest_params(ht, mesh, dev)

    def radapt():
        t0 = time.perf_counter()
        pf, energies = ht.radapt_aux_solve(
            lambda p, m: energy(p, m), params, mesh, loss_args=(mesh,),
            bg_model=ht.StructuredGridP1(E=10e9, nu=0.3), outer_epochs=2,
            pcg_iters=100, coord_steps=10, coord_lr=RADAPT_AUX_LR)
        e = energies.cpu().numpy()
        with torch.no_grad():
            moved = (model.coords(pf, mesh) - mesh.coords).abs()
        pin = mesh.geom_boundary_mask | mesh.dirichlet_mask
        log(f"  radapt_aux_solve, 2 epochs on example 11's mesh: energies "
            f"{float(e[0])!r} -> {float(e[1])!r}; max coordinate move "
            f"{float(moved.max()):.3e}, on the pins "
            f"{float(moved[pin].max())!r} ({time.perf_counter() - t0:.3f} "
            f"s) [{card}]")
        if not (np.all(np.isfinite(e)) and e[1] < e[0]):
            raise AssertionError("r-adaptive aux energies did not fall")
        if float(moved[pin].max()) != 0.0 or float(moved.max()) <= 0.0:
            raise AssertionError("r-adaptive aux moved a pinned node, or "
                                 "none")

    run_path(counts, "example-11 r-adaptive aux", gather, radapt)


# ---------------------------------------------- sharded paths on one card
# (name, sharded function, mesh input, L-BFGS steps, energy under no_grad,
#  kernels the path must launch on the card)
SHARDED_PATHS = (
    ("slab 922K", "shard_map_lattice_slab", "plate922", 10, True,
     ("lattice_stencil_vg_rows", "lattice_stencil_fwd_rows")),
    ("banded 898K", "shard_map_banded_energy", "delaunay898", 10, True,
     ("banded_vg_rows", "banded_fwd")),
    ("banded 898K, no ownership", "shard_map_banded_energy",
     "delaunay898_no_own", 0, False, ("banded_fwd", "banded_bwd_rows")),
    ("gather example 4", "shard_map_energy", "ex4_padded", 0, False,
     ("element_energy_fwd", "element_energy_bwd")),
    ("lattice example 4", "sharded_lattice_energy", "ex4", 0, False, ()),
    ("lattice 847K hybrid", "sharded_lattice_energy", "hybrid847", 0, False,
     ()),
)
# the sharded aux path: its input (the 898K plate, paired tables rebanded
# for 4 ranks, which 1 and 2 divide too) and the kernels each group must
# launch (K4 at row_start each matvec and Jacobi probe, the level steps in
# the replicated V-cycle)
SHARDED_AUX = ("aux-PCG 898K", "delaunay898",
               ("banded_vg_rows", "lattice_level_step", "lattice_restrict",
                "lattice_bottom_cycle"))
SHARDED_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
SHARDED_TIMEOUT_S = 600
VG_REPS = 5


def _sharded_run(loss_fn, params, mesh, steps, nograd, counts):
    """One path on this rank: value-and-grad (timed), ``steps`` L-BFGS
    steps (timed) and the energy under no_grad; launch counts of the
    value-and-grad, the steps and the no_grad energy (counts set to 0
    just before, read just after)."""
    import hidenn_fem_tpu_torch as ht

    def vg():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params["vg"].items()}
        v = loss_fn(p, mesh)
        return (v.detach(),) + torch.autograd.grad(v, [p["coords"],
                                                       p["u"]])

    vg()
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    for _ in range(VG_REPS):
        value, gc, gu = vg()
    torch.cuda.synchronize()
    out = {"vg_ms": 1e3 * (time.perf_counter() - t0) / VG_REPS,
           "energy": value.cpu(), "g_coords": gc.cpu(), "g_u": gu.cpu()}
    if steps:
        ht.run_lbfgs(loss_fn, params["init"], num_steps=2, loss_args=(mesh,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = ht.run_lbfgs(loss_fn, params["init"], num_steps=steps,
                                 loss_args=(mesh,))
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
        out["losses"] = losses.cpu()
    if nograd:
        with torch.no_grad():
            out["nograd"] = loss_fn(params["vg"], mesh).cpu()
    torch.cuda.synchronize()
    out["launches"] = counts.read()
    return out


def _sharded_aux_run(parallel, energy, mesh, dmesh, counts):
    """The sharded aux-PCG solve from rest on this rank (set-up included,
    timed); its solution, history and launch counts."""
    params = {"coords": mesh.coords,
              "u": torch.zeros((mesh.n_nodes, 2), device=mesh.coords.device)}
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    sol, hist = parallel.aux_pcg_solve_sharded(
        energy, mesh, params, dmesh=dmesh, max_iters=AUX_MAX_ITERS,
        tol=1e-6)
    torch.cuda.synchronize()
    return {"u": sol["u"].cpu(), "hist": hist.cpu(),
            "seconds": time.perf_counter() - t0, "launches": counts.read()}


def mg_inputs(dev):
    """Example 9's grid and model on ``dev``, and its params from each
    start: "noise" (1e-5 N(0,1), np.random.default_rng(0)) and "rest"."""
    from hidenn_fem_tpu_torch.models.structured_grid import (
        StructuredGridP1, generate_structured_grid)

    grid = generate_structured_grid(length=2.0, height=1.0, holes=(),
                                    nx=961, ny=481, device=dev)
    model = StructuredGridP1(E=10e9, nu=0.3)
    noise = model.init(np.random.default_rng(0), grid, device=dev)
    rest = {"coords": noise["coords"], "u": torch.zeros_like(noise["u"])}
    return grid, model, {"noise": noise, "rest": rest}


def _sharded_mg_run(dmesh, counts, grid, model, params, engine):
    """One sharded MG-PCG solve on this rank (set-up included, timed):
    its solution, history, launch counts, the all_reduce calls it issued
    and count_collectives' census for the loop body's calls."""
    from hidenn_fem_tpu_torch.parallel import sharded_mg, sharding

    torch.cuda.synchronize()
    counts.reset()
    sharding.reset_collective_counts()
    t0 = time.perf_counter()
    sol, hist = sharded_mg.mg_pcg_solve_sharded(
        model, grid, params, dmesh=dmesh, max_iters=SHARDED_MG_MAX_ITERS,
        tol=1e-6, engine=engine)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    iters = int((hist > 0).sum())
    census = sharded_mg.count_collectives(
        model, grid, params, n_devices=dmesh.size, engine=engine,
        max_iters=loop_calls(iters, SHARDED_MG_MAX_ITERS))
    return {"u": sol["u"].cpu(), "hist": hist.cpu(), "seconds": seconds,
            "launches": counts.read(),
            "all_reduce": sharding.collective_counts["all_reduce"],
            "census": census["all_reduce"]}


def sharded_mg_steady(dmesh, counts, grid, model, params):
    """The steady-state iteration of the captured sharded MG "all" on a
    one-rank NCCL group (``solver_steady``: tol-0 solves at SOLVER_CAPS'
    MG caps): host ms, device busy, kernels and port-kernel launches an
    iteration."""
    from hidenn_fem_tpu_torch.parallel import sharded_mg

    def solve(m, tol):
        sol, h = sharded_mg.mg_pcg_solve_sharded(
            model, grid, params, dmesh=dmesh, max_iters=m, tol=tol,
            engine="all")
        return sol["u"], h
    return solver_steady(counts, solve, True, *SOLVER_CAPS["mg"])


def rank_main(rank, world, port, backend, folder, queue):
    """One rank of a sharded group on ``cuda:0``: join the group, load the
    meshes and params the parent saved, run every path of SHARDED_PATHS and
    save the results; reports "ok" or the error on ``queue``."""
    import os

    try:
        from hidenn_fem_tpu_torch import parallel
        from hidenn_fem_tpu_torch.ops import banded_energy as be
        from hidenn_fem_tpu_torch.ops import element_energy as ee
        from hidenn_fem_tpu_torch.ops import lattice_slab as ls

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        parallel.initialize_multihost(f"localhost:{port}", world, rank,
                                      backend)
        dmesh = parallel.device_mesh(device=dev)
        inputs = torch.load(os.path.join(folder, "inputs.pt"),
                            weights_only=False)
        counts = Counts(ee, ls, be)
        results = {}
        for name, fn, key, steps, nograd, _ in SHARDED_PATHS:
            mesh, params, energy = inputs[key]
            mesh = mesh.to(dev)
            params = {k: {n: t.to(dev) for n, t in p.items()}
                      for k, p in params.items()}
            loss_fn = getattr(parallel, fn)(energy, dmesh)
            results[name] = _sharded_run(loss_fn, params, mesh, steps,
                                         nograd, counts)
        name, key, _ = SHARDED_AUX
        mesh, _, energy = inputs[key]
        results[name] = _sharded_aux_run(parallel, energy, mesh.to(dev),
                                         dmesh, counts)
        grid, model, starts = mg_inputs(dev)
        for engine, start in SHARDED_MG_RUNS:
            results[("mg", engine, start)] = _sharded_mg_run(
                dmesh, counts, grid, model, starts[start], engine)
        if world == 1 and backend == "nccl":       # captured on the card
            results["mg_steady"] = sharded_mg_steady(
                dmesh, counts, grid, model, starts["noise"])
        torch.save(results, os.path.join(folder, f"w{world}r{rank}.pt"))
        queue.put((rank, "ok"))
    except Exception as e:        # reported to the parent, which fails
        import traceback
        queue.put((rank, f"{e!r}\n{traceback.format_exc()}"))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_group(world, backend, folder):
    """Start ``world`` ranks of rank_main and wait for them; raises if a
    rank fails or does not end in time (every rank is then stopped)."""
    import multiprocessing as mp
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, backend, folder, queue))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        reports = [queue.get(timeout=SHARDED_TIMEOUT_S) for _ in procs]
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [msg for _, msg in reports if msg != "ok"]
    if bad or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank of the {world}-rank {backend} group "
                             f"failed: {bad or [p.exitcode for p in procs]}")
    log(f"  {world} rank(s), {backend}: {time.perf_counter() - t0:.1f} s "
        "with start-up")
    return [torch.load(os.path.join(folder, f"w{world}r{r}.pt"),
                       weights_only=False) for r in range(world)]


def single_rank_references(ht, inputs):
    """The unsharded energy's value-and-grad and L-BFGS history on each
    path's mesh (this process, no group)."""
    refs = {}
    for name, fn, key, steps, _, _ in SHARDED_PATHS:
        mesh, params, energy = inputs[key]
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params["vg"].items()}
        v = energy.total(p, mesh)
        gc, gu = torch.autograd.grad(v, [p["coords"], p["u"]])
        refs[name] = {"energy": v.detach(), "g_coords": gc, "g_u": gu}
        if steps:
            _, losses = ht.run_lbfgs(energy.total, params["init"],
                                     num_steps=steps, loss_args=(mesh,))
            refs[name]["losses"] = losses
    name, key, _ = SHARDED_AUX
    mesh, _, energy = inputs[key]

    def u_loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=mesh.coords.device)}
    sol, hist = ht.aux_pcg_solve(u_loss, u0, (mesh.coords, mesh), mesh=mesh,
                                 bg_model=ht.StructuredGridP1(E=energy.E,
                                                              nu=energy.nu),
                                 max_iters=AUX_MAX_ITERS, tol=1e-6)
    refs[name] = {"u": sol["u"].cpu(),
                  "hist": check_hist("898K aux-PCG, one process", hist)}
    grid, model, starts = mg_inputs(mesh.coords.device)
    for start, params in starts.items():
        sol, hist = ht.mg_pcg_solve(model, grid, params,
                                    max_iters=SHARDED_MG_MAX_ITERS, tol=1e-6)
        refs[("mg", start)] = {
            "u": sol["u"].cpu(),
            "iters": len(check_hist(f"961x481 MG-PCG from {start}", hist))}
    return refs


def phase_sharded(ht, inputs, card):
    """Phase 10: every sharded path as a group of ranks on the one card:
    a world of 1 on NCCL, then 2 and 4 ranks on gloo.  Every rank's
    values and loss history bit-equal across the ranks, and within PERF.md
    section 2's limits of the single-rank run; returns the 4-rank group's
    launch counts a path (summed over the ranks)."""
    import os
    import tempfile

    refs = single_rank_references(ht, inputs)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        torch.save({k: (m.to("cpu"), {n: {q: t.cpu() for q, t in p.items()}
                                      for n, p in params.items()}, e)
                    for k, (m, params, e) in inputs.items()},
                   os.path.join(folder, "inputs.pt"))
        log(f"  meshes and params saved for the ranks in "
            f"{time.perf_counter() - t0:.1f} s")
        launches = {}
        for world, backend in SHARDED_WORLDS:
            ranks = run_group(world, backend, folder)
            for name, fn, key, steps, nograd, needs in SHARDED_PATHS:
                r0 = ranks[0][name]
                for r in ranks[1:]:
                    for f in ("energy", "g_coords", "g_u", "losses",
                              "nograd"):
                        if f in r0 and not torch.equal(r[name][f], r0[f]):
                            raise AssertionError(f"{name}: {f} differs "
                                                 "across the ranks")
                ref = refs[name]
                tag = f"{name}, {world} rank(s)"
                check_close(f"{tag} energy vs single rank", r0["energy"],
                            ref["energy"], ENERGY_RTOL, 0.0)
                for g in ("g_coords", "g_u"):
                    check_close(f"{tag} {g} vs single rank", r0[g], ref[g],
                                GRAD_RTOL, GRAD_ATOL)
                total = {}
                for r in ranks:
                    for k, v in r[name]["launches"].items():
                        total[k] = total.get(k, 0) + v
                for k in needs:
                    if total[k] == 0:
                        raise AssertionError(f"{k} was not launched by the "
                                             f"{tag} path")
                line = (f"  {tag}: value-and-grad {r0['vg_ms']:.3f} ms "
                        "(ranks sharing one card, not multi-GPU scaling)")
                if steps:
                    want = ref["losses"].cpu().double()
                    rel = (r0["losses"].double() - want).abs() / want.abs()
                    if rel[0] > INIT_RTOL or rel.max() > F32_SPREAD_RTOL:
                        raise AssertionError(f"{tag}: loss history off the "
                                             f"single rank's ({rel.max()})")
                    line += (f", {r0['step_ms']:.3f} ms per L-BFGS step; "
                             f"history rel {float(rel.max()):.3e} to the "
                             "single rank")
                launched = {k: v for k, v in total.items() if v}
                log(line + f"; launches {launched} [{card}]")
                if world == 4:
                    launches[name] = total
            check_sharded_aux(ranks, refs, world, backend, card)
            mg = check_sharded_mg(ranks, refs, world, backend, card)
            if "mg_steady" in ranks[0]:
                st = ranks[0]["mg_steady"]
                log(f"  sharded MG all, {world} rank ({backend}), captured: "
                    f"steady-state iteration {st['host_ms']:.4f} ms on the "
                    f"host clock, {st['busy_ms']:.4f} ms device busy, idle "
                    f"share {st['idle']:.3f}; {st['kernels']:.1f} kernels "
                    f"and {st['launches']:.2f} port-kernel launches an "
                    "iteration; device us an iteration by kernel: "
                    + ", ".join(f"{k} {us:.1f}" for us, k in st["top_us"])
                    + f" [{card}]")
            if world == 4:
                launches["sharded MG"] = mg
    return launches


def check_sharded_aux(ranks, refs, world, backend, card):
    """The sharded aux-PCG path of one group: histories and solutions
    bit-equal across the ranks, the kernels of SHARDED_AUX launched, and
    within the JAX test's limits of the one-process solve
    (``tests/test_sharding.py::test_sharded_aux_pcg_matches_single_device``:
    iterations within 6, solutions within 5e-3 x max|u|)."""
    name, _, needs = SHARDED_AUX
    r0 = ranks[0][name]
    for r in ranks[1:]:
        for f in ("u", "hist"):
            if not torch.equal(r[name][f], r0[f]):
                raise AssertionError(f"{name}: {f} differs across the ranks")
    total = {}
    for r in ranks:
        for k, v in r[name]["launches"].items():
            total[k] = total.get(k, 0) + v
    tag = f"{name}, {world} rank(s) ({backend})"
    for k in needs:
        if total[k] == 0:
            raise AssertionError(f"{k} was not launched by the {tag} path")
    h = check_hist(tag, r0["hist"])
    ref = refs[name]
    du = float((r0["u"] - ref["u"]).abs().max() / ref["u"].abs().max())
    launched = {k: v for k, v in total.items() if v}
    log(f"  {tag}: {len(h)} iterations to {h[-1]:.6e} (one process: "
        f"{len(ref['hist'])}) in {r0['seconds']:.3f} s with the set-up "
        f"(ranks sharing one card); max|u - u_1| / max|u_1| {du:.3e}; "
        f"launches {launched} [{card}]")
    if h[-1] > 1e-6 or abs(len(h) - len(ref["hist"])) > 6 or du > 5e-3:
        raise AssertionError(f"{tag}: off the one-process solve")


def phase_example5(dev, card):
    """Phase 15: example 5 at its own size (1000x500 nodes, 922,250
    elements): the slope-timed value-and-grad and 200 L-BFGS steps twice,
    as the example runs them; its warm history against JAX's.  The plate
    takes the JAX package's route: a renumbered lattice (the hole nodes
    dropped), the plain lattice route, no kernel."""
    from examples.example5_scaling_torch import main as example5

    t0 = time.perf_counter()
    _, losses = example5(device=dev)
    log(f"  example 5: {time.perf_counter() - t0:.1f} s with the mesh "
        f"build [{card}]")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite energy in example 5")
    check_ref("example-5 energy at init", float(losses[0]), JAX_EX5_INIT,
              INIT_RTOL)
    check_ref("example-5 energy at step 25", float(losses[25]),
              JAX_EX5_AT_25[0], F32_SPREAD_RTOL, JAX_EX5_AT_25[1])
    final, (f32, f64) = float(losses[-1]), JAX_EX5_FINAL
    rel = abs(final - f64) / abs(f64)
    log(f"  example-5 energy after 200 steps: {final!r} vs JAX f64 {f64!r}:"
        f" rel {rel:.3e} (limit {EX5_FINAL_RTOL}; JAX f32 {f32!r})")
    if rel > EX5_FINAL_RTOL:
        raise AssertionError("example-5 energy after 200 steps off JAX's")


def phase_lbfgs_variants(ht, mesh, dev, card, counts):
    """Phase 16: the zoom line search and the two-loop mode on example 4
    (lattice route, K6 every value-and-grad), 50 steps each, against JAX
    and against the compact mode; returns each path's launches."""
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    energy = plate_energy(ht, cfg, ht.TriangleP1(u_fixed=0.0))
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)

    def solve(**kw):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, losses = ht.run_optimizer(energy.total, params,
                                         ht.lbfgs(**kw), VARIANT_STEPS,
                                         loss_args=(mesh,))
            losses = losses.cpu().numpy()
            return losses, time.perf_counter() - t0
        return run

    out = {}
    for name, kw in (("zoom", dict(linesearch="zoom")),
                     ("two-loop", dict(mode="scan")),
                     ("compact", {})):
        (losses, seconds), launches = run_path(
            counts, f"example-4 {name} L-BFGS", ("lattice_stencil_vg",),
            solve(**kw))
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"non-finite energy in the {name} solve")
        vg = launches["lattice_stencil_vg"] / VARIANT_STEPS
        log(f"  example-4 {name} L-BFGS, {VARIANT_STEPS} steps: {seconds:.3f}"
            f" s ({1e3 * seconds / VARIANT_STEPS:.4f} ms/iter), "
            f"{vg:.2f} value-and-grads per iteration; energy "
            f"{float(losses[0])!r} -> {float(losses[-1])!r} [{card}]")
        out[name] = (losses, launches)
    zoom = out["zoom"][0]
    rel = np.abs(zoom - np.asarray(JAX_EX4_ZOOM)) / np.abs(
        np.asarray(JAX_EX4_ZOOM))
    log(f"  zoom history vs JAX's run_lbfgs(linesearch='zoom'): max rel "
        f"{rel.max():.3e} (limit {EX4_RTOL})")
    if rel.max() > EX4_RTOL:
        raise AssertionError("zoom L-BFGS history off JAX's")
    scan, compact = out["two-loop"][0][-1], out["compact"][0][-1]
    log(f"  after {VARIANT_STEPS} steps: two-loop {float(scan)!r}, compact "
        f"{float(compact)!r}, JAX f64 {JAX_EX4_FIXED_STEP_50!r}: "
        f"|two-loop - compact| {abs(scan - compact):.3e} (limit "
        f"{2 * FIXED_STEP_ATOL:.3e}), |two-loop - JAX| "
        f"{abs(scan - JAX_EX4_FIXED_STEP_50):.3e}, |compact - JAX| "
        f"{abs(compact - JAX_EX4_FIXED_STEP_50):.3e} (limit "
        f"{FIXED_STEP_ATOL:.3e})")
    if (abs(scan - compact) > 2 * FIXED_STEP_ATOL
            or abs(scan - JAX_EX4_FIXED_STEP_50) > FIXED_STEP_ATOL
            or abs(compact - JAX_EX4_FIXED_STEP_50) > FIXED_STEP_ATOL):
        raise AssertionError("two-loop L-BFGS off the compact mode")
    return {name: launches for name, (_, launches) in out.items()}


def phase_utils(ht, mesh, dev, card, counts):
    """Phase 17: ``solve_with_checkpointing`` on example 4 (compact
    L-BFGS, two chunks of 25 steps): a run stopped after its first chunk
    and resumed ends bit-equal to an uninterrupted one; then
    ``check_gradients`` on the card.  Returns the launches."""
    import os
    import tempfile

    from hidenn_fem_tpu_torch.config import PlateConfig
    from hidenn_fem_tpu_torch.solve.drivers import solve_with_checkpointing
    from hidenn_fem_tpu_torch.utils import check_gradients

    cfg = PlateConfig()
    energy = plate_energy(ht, cfg, ht.TriangleP1(u_fixed=0.0))
    params = rest_params(ht, mesh, dev)

    def loss(p):
        return energy.total(p, mesh)

    def run():
        with tempfile.TemporaryDirectory() as d:
            a, b = os.path.join(d, "resumed"), os.path.join(d, "whole")
            solve_with_checkpointing(loss, params, ht.lbfgs(), 25, a,
                                     checkpoint_every=25)
            p_res, hist = solve_with_checkpointing(
                loss, params, ht.lbfgs(), 50, a, checkpoint_every=25,
                metrics_path=os.path.join(d, "metrics.jsonl"))
            p_full, _ = solve_with_checkpointing(loss, params, ht.lbfgs(),
                                                 50, b, checkpoint_every=25)
            files = sorted(os.listdir(a))
        if len(hist) != 1 or files != ["ckpt_25.pt", "ckpt_50.pt"]:
            raise AssertionError(f"the resumed run did not start from its "
                                 f"checkpoint ({files}, {len(hist)} chunks)")
        for k in p_full:
            if not torch.equal(p_res[k], p_full[k]):
                raise AssertionError(f"resumed {k} differs from the "
                                     "uninterrupted run's")
        log("  solve_with_checkpointing: stopped after 25 of 50 steps and "
            "resumed; params bit-equal to the uninterrupted run")
        norms = check_gradients(loss, params, verbose=False)
        log(f"  check_gradients on the card: {norms}")
        if not all(np.isfinite(v) and v > 0 for v in norms.values()):
            raise AssertionError("check_gradients: bad gradient norms")

    _, launches = run_path(counts, "example-4 checkpointed solve",
                           ("lattice_stencil_vg",), run)
    return launches


def check_sharded_mg(ranks, refs, world, backend, card):
    """The sharded MG-PCG runs of one group (SHARDED_MG_RUNS): solutions
    and histories bit-equal across the ranks; relres 1e-6 within
    MG_ITERS_SPREAD iterations of the one-process solve and of JAX's, and
    within MG_U_RTOL x max|u| of the one-process solution; K6 over a row
    window launched; the all_reduce calls equal to count_collectives'
    census.  Per engine, ms and launches per call of the loop body by the
    slope between the two starts (the set-up is the same in both).  Returns
    the launch counts of every run summed over the ranks."""
    total, by = {}, {}
    for engine, start in SHARDED_MG_RUNS:
        key = ("mg", engine, start)
        tag = f"sharded MG {engine} from {start}, {world} rank(s) ({backend})"
        r0 = ranks[0][key]
        for r in ranks[1:]:
            for f in ("u", "hist"):
                if not torch.equal(r[key][f], r0[f]):
                    raise AssertionError(f"{tag}: {f} differs across the "
                                         "ranks")
        h = check_hist(tag, r0["hist"])
        ref = refs[("mg", start)]
        want = JAX_MG_REST_ITERS if start == "rest" else JAX_MG_ITERS
        du = float((r0["u"] - ref["u"]).abs().max()
                   / ref["u"].abs().max())
        summed = {}
        for r in ranks:
            for k, v in r[key]["launches"].items():
                summed[k] = summed.get(k, 0) + v
                total[k] = total.get(k, 0) + v
        launched = {k: v for k, v in summed.items() if v}
        log(f"  {tag}: {len(h)} iterations to {h[-1]:.6e} (one process "
            f"{ref['iters']}, JAX {want}) in {r0['seconds']:.3f} s with "
            f"the set-up; max|u - u_1| / max|u_1| {du:.3e}; all_reduce "
            f"calls {r0['all_reduce']} a rank (census {r0['census']}); "
            f"launches {launched} [{card}]")
        if (h[-1] > 1e-6 or abs(len(h) - ref["iters"]) > MG_ITERS_SPREAD
                or abs(len(h) - want) > MG_ITERS_SPREAD
                or du > MG_U_RTOL):
            raise AssertionError(f"{tag}: off the one-process solve")
        if r0["all_reduce"] != r0["census"]:
            raise AssertionError(f"{tag}: {r0['all_reduce']} all_reduce "
                                 f"calls, census {r0['census']}")
        if summed["lattice_stencil_vg_rows"] == 0:
            raise AssertionError(f"{tag}: K6 over a row window did not "
                                 "launch")
        by[(engine, start)] = (len(h), r0["seconds"], r0["launches"])
    for engine in ("all", "replicated_coarse"):
        (i1, s1, l1), (i0, s0, l0) = by[(engine, "rest")], \
            by[(engine, "noise")]
        di = (loop_calls(i1, SHARDED_MG_MAX_ITERS)
              - loop_calls(i0, SHARDED_MG_MAX_ITERS))
        if di <= 0:
            raise AssertionError(f"sharded MG {engine}: the solve from rest "
                                 "took no more iterations than the one "
                                 "from the noise start")
        per = {k: (l1[k] - l0[k]) / di for k in
               ("lattice_stencil_vg", "lattice_stencil_vg_rows")}
        log(f"  sharded MG {engine}, {world} rank(s) ({backend}): "
            f"{1e3 * (s1 - s0) / di:.3f} ms per call of the loop body "
            f"(slope between the starts, ranks sharing one card; one "
            f"iteration a call, masked past the stop); per call on rank "
            f"0: K6 {per['lattice_stencil_vg']:.2f}, K6 over a row window "
            f"{per['lattice_stencil_vg_rows']:.2f} launches [{card}]")
    return total


def phase_examples_1d(ht, dev, card):
    """Phase 18: examples 1-3 on the card at their own sizes (plain torch,
    no kernel), against the JAX package's values."""
    from examples import example1_torch, example2_torch, example3_torch
    from hidenn_fem_tpu_torch.config import Projection2DConfig

    def within_factor(what, got, want, factor):
        ratio = got / want
        log(f"  {what}: {got!r} vs JAX {want!r}: ratio {ratio:.4f} "
            f"(limit a factor {factor})")
        if not (np.isfinite(got) and 1 / factor <= ratio <= factor):
            raise AssertionError(f"{what} off JAX's")

    t0 = time.perf_counter()
    _, losses = example1_torch.main(device=dev)
    sec = time.perf_counter() - t0
    within_factor("example-1 final MSE", float(losses[-1]),
                  JAX_EX1_FINAL_MSE, EX1_MSE_FACTOR)
    log(f"  example 1: {len(losses)} epochs in {sec:.3f} s, "
        f"{1e3 * sec / len(losses):.4f} ms/epoch with the set-up [{card}]")

    t0 = time.perf_counter()
    _, _, losses, mse = example2_torch.main(device=dev)
    sec = time.perf_counter() - t0
    within_factor("example-2 final MSE over all points", mse,
                  JAX_EX2_FULL_MSE, EX2_MSE_FACTOR)
    log(f"  example 2: {len(losses)} epochs in {sec:.3f} s, "
        f"{1e3 * sec / len(losses):.4f} ms/epoch with the set-up [{card}]")
    rng = np.random.default_rng(0)
    batches = rng.integers(0, 10_000, (EX2_TABLE_EPOCHS, 1000))
    u0 = rng.standard_normal((25, 25))
    _, params = ht.Bilinear2D.create(np.linspace(0, 1, 25),
                                     np.linspace(0, 1, 25), r_adapt=True,
                                     device=dev)
    params["u"] = torch.tensor(u0, dtype=torch.float32, device=dev)
    _, _, losses, _ = example2_torch.main(
        Projection2DConfig(epochs=EX2_TABLE_EPOCHS), device=dev,
        params=params, batches=batches)
    for dt, want in zip(("f32", "f64"), JAX_EX2_TABLE_LAST):
        rel = abs(float(losses[-1]) - want) / abs(want)
        log(f"  example-2 loss at step {EX2_TABLE_EPOCHS} on the index "
            f"table: {float(losses[-1])!r} vs JAX {dt} {want!r}: rel "
            f"{rel:.3e} (limit {F32_SPREAD_RTOL})")
        if rel > F32_SPREAD_RTOL:
            raise AssertionError(f"example 2 on the index table off JAX "
                                 f"{dt}")

    t0 = time.perf_counter()
    _, losses, err = example3_torch.main(device=dev)
    sec = time.perf_counter() - t0
    check_ref("example-3 final energy", float(losses[-1]),
              JAX_EX3_FINAL_ENERGY, EX3_ENERGY_RTOL)
    log(f"  example-3 RMS error against the exact solution: {err:.4e} "
        f"(limit {EX3_RMS_LIMIT})")
    if not err < EX3_RMS_LIMIT:
        raise AssertionError("example 3 off the exact solution")
    log(f"  example 3: {len(losses)} epochs in {sec:.3f} s, "
        f"{1e3 * sec / len(losses):.4f} ms/epoch with the set-up [{card}]")


def timed(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_point_eval(ht, mesh, params, dev, card):
    """Phase 19: point location and evaluation at full width on the 898K
    plate's phase-8 solution (moved coordinates): POINT_COUNT points over
    the bounding box, timed; holes and margins, a linear field, and the
    element centroids checked."""
    from hidenn_fem_tpu_torch import postproc

    model = ht.TriangleP1()
    coords = model.coords(params, mesh).detach()
    conn = mesh.connectivity
    rng = np.random.default_rng(0)
    lo = coords.min(0).values.double().cpu().numpy()
    hi = coords.max(0).values.double().cpu().numpy()
    pts = torch.tensor(lo + (hi - lo) * rng.random((POINT_COUNT, 2)),
                       device=dev)
    (eid, ref), cold = timed(lambda: postproc.locate_points(coords, conn,
                                                            pts))
    (eid, ref), warm = timed(lambda: postproc.locate_points(coords, conn,
                                                            pts))
    u, total = timed(lambda: postproc.evaluate_at_points(model, params,
                                                         mesh, pts))
    _, interp = timed(lambda: model.interpolate(params, mesh,
                                                ref.float(),
                                                eid.clamp_min(0)))
    log(f"  {POINT_COUNT} points on {mesh.n_elements} elements: locate "
        f"{cold:.4f} s cold, {warm:.4f} s warm; evaluate_at_points "
        f"{total:.4f} s (locate + interpolate), interpolate alone "
        f"{interp:.4f} s [{card}]")
    outside = eid < 0
    if not torch.equal(torch.isnan(u).any(dim=1), outside) or \
            bool(torch.isnan(u[~outside]).any()):
        raise AssertionError("NaN rows are not the points outside the mesh")
    p = pts.cpu().numpy()
    gap = np.min([np.hypot(p[:, 0] - cx, p[:, 1] - cy) - r
                  for cx, cy, r in HOLES], axis=0)
    in_plate = ((p[:, 0] > lo[0] + HOLE_MARGIN)
                & (p[:, 0] < hi[0] - HOLE_MARGIN)
                & (p[:, 1] > lo[1] + HOLE_MARGIN)
                & (p[:, 1] < hi[1] - HOLE_MARGIN))
    out = outside.cpu().numpy()
    lost = int((out & in_plate & (gap > HOLE_MARGIN)).sum())
    found_in_hole = int((~out & (gap < -HOLE_MARGIN)).sum())
    log(f"  outside the mesh: {int(out.sum())} points "
        f"({out.mean():.4%}; the holes cover "
        f"{np.pi * sum(r * r for _, _, r in HOLES) / 2.0:.4%} of the "
        f"plate); lost inside the plate {lost}, found in a hole "
        f"{found_in_hole}")
    if lost or found_in_hole:
        raise AssertionError("point location disagrees with the geometry")

    # a linear field (no Dirichlet pins) is reproduced exactly
    A = torch.tensor([[1e-3, 2e-4], [-3e-4, 5e-4]], dtype=torch.float64,
                     device=dev)
    b = torch.tensor([1e-4, -2e-4], dtype=torch.float64, device=dev)
    free = dataclasses.replace(mesh, dirichlet_mask=torch.zeros_like(
        mesh.dirichlet_mask))
    lin = {"coords": params["coords"],
           "u": (coords.double() @ A.T + b).float()}
    got = postproc.evaluate_at_points(model, lin, free, pts)
    want = pts @ A.T + b
    err = float((got.double() - want)[~outside].abs().max())
    scale = float(want.abs().max())
    log(f"  linear field: max|err| {err:.4e} (limit {POINT_ATOL} x "
        f"max|u| = {POINT_ATOL * scale:.4e})")
    if not err <= POINT_ATOL * scale:
        raise AssertionError("a linear field is not reproduced")

    # the field at every element centroid is the vertex mean
    cen = coords.double()[conn.long()].mean(dim=1)
    ceid, _ = postproc.locate_points(coords, conn, cen)
    own = ceid == torch.arange(mesh.n_elements, device=dev)
    got = postproc.evaluate_at_points(model, params, mesh, cen)
    mean = model.u_full(params, mesh)[conn.long()].mean(dim=1)
    err = float((got - mean)[own].abs().max())
    scale = float(mean.abs().max())
    log(f"  centroids: {int(own.sum())} of {mesh.n_elements} in their own "
        f"element; field vs vertex mean max|err| {err:.4e} (limit "
        f"{POINT_ATOL * scale:.4e})")
    if float(own.double().mean()) < 0.999 or not err <= POINT_ATOL * scale:
        raise AssertionError("the centroid field is not the vertex mean")


def tables_equal(a, b, what):
    """Every tensor of two meshes (their banded tables too) array-equal."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            tables_equal(x, y, f"{what}.{f.name}")
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}.{f.name} differs")
        elif x != y:
            raise AssertionError(f"{what}.{f.name}: {x!r} vs {y!r}")


def phase_native(ht, arrays, dev, card):
    """Phase 20: the native loader: build, then the whole 898K Delaunay
    plate and its host tables alone (``TriMesh.from_arrays`` on its
    arrays: incidence, fused, triangle and paired banded tables), each
    with the library and with HDNN_NO_NATIVE=1, array-equal, all timed in
    this run."""
    import os

    from hidenn_fem_tpu_torch.mesh import native

    os.environ.pop("HDNN_NO_NATIVE", None)
    try:
        path, sec = timed(lambda: native.build(verbose=False))
        log(f"  built {path} in {sec:.2f} s; available: "
            f"{native.available()}")
        if not native.available():
            raise AssertionError("the native library is not available")
        builds = {
            "whole plate": lambda: ht.generate_mesh_delaunay(
                holes=HOLES, lc=DELAUNAY_LC, device=dev),
            "tables alone": lambda: ht.TriMesh.from_arrays(*arrays,
                                                           device=dev)}
        for what, fn in builds.items():
            meshes = {}
            for name in ("native", "numpy"):
                if name == "numpy":
                    os.environ["HDNN_NO_NATIVE"] = "1"
                try:
                    meshes[name], sec = timed(fn)
                finally:
                    os.environ.pop("HDNN_NO_NATIVE", None)
                log(f"  898K Delaunay plate, {what}, with the {name} "
                    f"paths: {sec:.2f} s on the host [{card}]")
            m = meshes["native"]
            if (m.n_elements, m.n_nodes) != DELAUNAY_SIZES \
                    or m.banded is None or m.banded_paired is None:
                raise AssertionError("expected the 898K plate with its "
                                     "triangle and paired tables")
            tables_equal(m, meshes["numpy"], "mesh")
            log(f"  {what}: every table array-equal (coordinates, "
                "connectivity, incidence, fused, triangle and paired "
                "banded tables)")
    finally:
        os.environ["HDNN_NO_NATIVE"] = "1"


# Phase 21: the captured step against the eager loop.  Each route runs
# from the same inputs in turns eager, captured, captured, eager; where the
# two eager runs are bit-equal the captured history and params must be
# too, else the first differing step is named and the captured run is
# held to the eager one by the f32 spread rule.  The steady state (a
# solve's step after its first call, warm-up and capture) is profiled in
# CAPTURE_WINDOW steps, CAPTURE_CALLS times.
CAPTURE_WINDOW = 10
CAPTURE_CALLS = 3
# Phase 22: the figure parity of tests/test_figure_parity.py on the card,
# against the reference implementation's run stored in the repo
FIGURE_SNAPSHOT = "tests/data/reference_snapshot_81x41.npz"
FIGURE_LOSS_RTOL = 2e-3
FIGURE_FIELD_RTOL = 2e-2


def flat_params(params):
    return params if isinstance(params, torch.Tensor) else torch.cat(
        [params[k].reshape(-1) for k in sorted(params)])


def steady_window(run_steps, steps):
    """(wall ms, device-busy ms per step, idle share, kernels per step) of
    ``run_steps()`` (``steps`` steps of one solve's steady state) under
    the profiler, CAPTURE_CALLS calls after one untimed call."""
    from tools.profile_torch_port import (_busy_ms, _kernel_events,
                                          device_window)

    run_steps()
    torch.cuda.synchronize()
    with device_window() as prof:
        t0 = time.perf_counter()
        for _ in range(CAPTURE_CALLS):
            run_steps()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (CAPTURE_CALLS * steps)
    busy = _busy_ms(prof) / (CAPTURE_CALLS * steps)
    kernels = sum(e.count for _, e in _kernel_events(prof)) / (
        CAPTURE_CALLS * steps)
    return wall, busy, 1.0 - busy / wall, kernels


def phase_capture(ht, counts, route, loss, params, args, steps,
                  memory_size, card):
    """Phase 21 on one route: ``steps`` L-BFGS steps eager
    (``drivers._solve(capture=False)``) and captured (``run_lbfgs``) from
    the same inputs, in turns; bits, launches, ms per step and the
    steady state's idle share of both."""
    from hidenn_fem_tpu_torch.solve import drivers
    from tools.profile_torch_port import steady_steps

    def run(capture):
        torch.cuda.synchronize()
        counts.reset()
        t0 = time.perf_counter()
        if capture:
            p, h = ht.run_lbfgs(loss, params, num_steps=steps,
                                memory_size=memory_size, loss_args=args)
        else:
            p, h = drivers._solve(loss, params, ht.lbfgs(
                memory_size=memory_size), steps, args, capture=False)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        return flat_params(p), h, ms, counts.read()

    e1, c1, c2, e2 = (run(c) for c in (False, True, True, False))
    if not torch.isfinite(c1[1]).all():
        raise AssertionError(f"{route}: non-finite captured history")
    for a, b, what in ((e1, e2, "eager vs eager"),
                       (c1, c2, "captured vs captured"),
                       (c1, e1, "captured vs eager")):
        same = torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
        if same:
            msg = "bit-equal (history and params)"
        elif torch.equal(a[1], b[1]):
            msg = "histories bit-equal, final params differ"
        else:
            msg = ("first differing step "
                   f"{int(torch.nonzero(a[1] != b[1])[0, 0])}")
        log(f"  {route}: {what}: {msg}")
        if what == "captured vs eager" and not same:
            if torch.equal(e1[1], e2[1]) and torch.equal(e1[0], e2[0]):
                raise AssertionError(f"{route}: the captured run is not "
                                     "bit-equal to the eager run, which is "
                                     "deterministic")
            check_close(f"{route} captured vs eager history", c1[1], e1[1],
                        F32_SPREAD_RTOL, 0.0)
    if c1[3] != e1[3]:
        raise AssertionError(f"{route}: launches {c1[3]} captured vs "
                             f"{e1[3]} eager")
    log(f"  {route}: launches in each run {e1[3]}")
    log(f"  {route}: {steps} steps, whole run ms/step eager "
        f"{e1[2]:.4f} / {e2[2]:.4f}, captured {c1[2]:.4f} / {c2[2]:.4f} "
        "(the captured runs include the first call, the warm-up and the "
        f"capture) [{card}]")
    out = {}
    for capture in (False, True):
        tag = "captured" if capture else "eager"
        out[tag] = steady_window(steady_steps(
            loss, params, args, ht.lbfgs(memory_size=memory_size), capture,
            CAPTURE_WINDOW), CAPTURE_WINDOW)
        wall, busy, idle, kernels = out[tag]
        log(f"  {route}: steady-state {tag} step (profiled, "
            f"{CAPTURE_CALLS} x {CAPTURE_WINDOW} steps): {wall:.4f} ms "
            f"wall, {busy:.4f} ms device busy, idle share {idle:.3f}, "
            f"{kernels:.1f} kernels a step, "
            f"{1e3 * (wall - busy) / kernels:.2f} us idle a kernel "
            f"[{card}]")
    return out


def two_loop_copies(mesh, dev, card, m=100):
    """The two-loop L-BFGS's reordered history (``S[order]``,
    ``Y[order]``: one copy of each [m, P] memory a step, which the
    capture needs) against one whole two-loop direction, at ``mesh``'s
    P, device ms per call (CUDA events)."""
    from hidenn_fem_tpu_torch.solve import optimizers as topt

    p = 4 * mesh.n_nodes
    opt = topt.TwoLoopLBFGS(memory_size=m)
    x = torch.randn(p, device=dev)
    state = opt.init(x)
    gen = torch.Generator(device=dev).manual_seed(0)
    state.diff_params_memory.normal_(generator=gen)
    state.diff_updates_memory.normal_(generator=gen)
    state.weights_memory.fill_(1e-3)
    state = state._replace(count=m)
    order = torch.arange(m, device=dev)
    copies = cuda_ms(lambda: (state.diff_params_memory[order],
                              state.diff_updates_memory[order]), iters=5,
                     warmup=1)
    g = torch.randn(p, device=dev)

    def direction():
        state.device_count.fill_(m)
        opt.direction(g, state, x)
    whole = cuda_ms(direction, iters=5, warmup=1)
    log(f"  two-loop L-BFGS at P = {p} (the 922K-class plate), m = {m}: "
        f"the two reordered history copies {copies:.4f} ms of a "
        f"{whole:.4f} ms direction ({100 * copies / whole:.1f}%; "
        f"{2 * 2 * m * p * 4 / 1e9:.2f} GB moved by the copies) [{card}]")
    return copies, whole


def capture_cases(ht, mesh4, mesh898, dev):
    """Phase 21's routes: route -> (loss, params, loss args, steps,
    memory size, kernels that must launch)."""
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    energy4 = plate_energy(ht, cfg, ht.TriangleP1(u_fixed=0.0))
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())

    def plate(mesh):
        u0 = 1e-5 * np.random.default_rng(0).standard_normal(
            (mesh.n_nodes, 2))
        return ht.params_from_numpy(
            {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    gather4 = dataclasses.replace(mesh4, lattice=None)
    grid = ht.generate_structured_grid(holes=tuple(HOLES), nx=1000, ny=500,
                                       device=dev)
    model6 = ht.StructuredGridP1()
    return {
        "example 4, lattice route": (
            energy4.total, plate(mesh4), (mesh4,), cfg.lbfgs_steps, 100,
            ("lattice_stencil_vg",)),
        "example 4, gather route": (
            energy4.total, plate(gather4), (gather4,), cfg.lbfgs_steps,
            100, ("element_energy_fwd", "element_energy_bwd",
                  "incidence_sum")),
        "example 6": (
            model6.total, model6.init(np.random.default_rng(0), grid,
                                      device=dev), (grid,), 600, 10,
            ("lattice_stencil_vg",)),
        "898K Delaunay, banded route": (
            energy.total, plate(mesh898), (mesh898,), 50, 100,
            ("banded_vg",)),
    }


def phase_figure_parity(ht, dev, card):
    """Phase 22: tests/test_figure_parity.py on the card: the 81x41 proxy
    plate, reference numerics, 600 captured L-BFGS steps from
    u0 = 1e-5 N(0,1) (np.random.default_rng(0)), against the reference
    implementation's run (FIGURE_SNAPSHOT), with that test's bounds."""
    import os

    snap = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), FIGURE_SNAPSHOT))
    mesh = ht.proxy_plate_mesh(nx=81, ny=41, device=dev)
    model = ht.TriangleP1(compat="reference")
    energy = ht.PlaneStressEnergy(model=model, compat="reference")
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(energy.total, params, num_steps=600,
                                  loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    final, want = float(losses[-1]), float(snap["final_loss"])
    checks = [("final loss", final, want, FIGURE_LOSS_RTOL)]
    _, grad_u = model.element_fields(params, mesh)
    g = grad_u.double().cpu().numpy()
    exx, eyy = g[:, 0, 0], g[:, 1, 1]
    exy = 0.5 * (g[:, 0, 1] + g[:, 1, 0])
    E, nu = 10e9, 0.3
    sxx = E / (1 - nu ** 2) * (exx + nu * eyy)
    syy = E / (1 - nu ** 2) * (eyy + nu * exx)
    sxy = E / (1 + nu) * exy
    vm = np.sqrt(sxx ** 2 - sxx * syy + syy ** 2 + 3 * sxy ** 2)
    vm_ref = np.asarray(snap["von_mises"], np.float64)
    checks.append(("max von Mises", vm.max(), vm_ref.max(),
                   FIGURE_FIELD_RTOL))
    u = model.u_full(params, mesh).double().cpu().numpy()
    u_ref = np.asarray(snap["u_full"], np.float64)
    checks.append(("max |u_x|", np.abs(u[:, 0]).max(),
                   np.abs(u_ref[:, 0]).max(), FIGURE_FIELD_RTOL))
    checks.append(("max |u|", np.linalg.norm(u, axis=1).max(),
                   np.linalg.norm(u_ref, axis=1).max(), FIGURE_FIELD_RTOL))
    for what, got, ref, rtol in checks:
        rel = abs(got - ref) / abs(ref)
        log(f"  figure parity: {what} {got!r} vs the reference run "
            f"{ref!r}: rel {rel:.3e} (limit {rtol})")
        if rel > rtol:
            raise AssertionError(f"figure parity: {what} off the reference")
    conn = mesh.connectivity.cpu().numpy()
    cent = model.coords(params, mesh).double().cpu().numpy()[conn].mean(1)
    cent_ref = np.asarray(snap["coords"], np.float64)[
        np.asarray(snap["connectivity"])].mean(1)
    d = float(np.linalg.norm(cent[vm.argmax()] - cent_ref[vm_ref.argmax()]))
    h = 2.0 / 80.0
    med = float(np.median(np.abs(vm - vm_ref)))
    log(f"  figure parity: peak von Mises {d:.3e} from the reference's "
        f"(limit {2.0 * h}, one element diameter); median |vm - vm_ref| "
        f"{med:.6e} (limit {0.05 * vm_ref.max():.6e}); 600 steps in "
        f"{seconds:.3f} s with the capture [{card}]")
    if d > 2.0 * h or med > 0.05 * vm_ref.max():
        raise AssertionError("figure parity: the von Mises field is off "
                             "the reference's")


# Phase 23: the linear solvers' captured while loops (solve/loop.py)
# against the same body run eagerly.  The steady state of an iteration is
# the difference between two solves at tol 0 capped at SOLVER_CAPS (the
# same set-up and capture in both; the caps far enough apart that the
# iterations between them take several times the set-up's host-time
# spread); READ_EVERY_SWEEP are the host-read periods timed against the
# shipped one.
SOLVER_CAPS = {"cg": ((10, 40), (20, 420)), "mg": ((5, 25), (10, 210)),
               "aux": ((5, 25), (10, 210))}
# (the profiled and the eager host-clock solves' caps, the captured
# host-clock solves' caps)
STEADY_RUNS = 3
READ_EVERY_SWEEP = (1, 2, 4, 8)


def loop_calls(iters, max_iters):
    """Calls of a solver's loop body for ``iters`` iterations
    (``solve/loop.py``): rounded up to ``READ_EVERY``, at most
    ``max_iters``; every call launches its kernels, masked or not."""
    from hidenn_fem_tpu_torch.solve import loop

    k = loop.READ_EVERY
    return min(k * -(-iters // k), max_iters)


def solve_launches(model, levels, calls, matvecs=0, nu=3,
                   coarse_degree=24):
    """The level kernels' launches of a PCG solve on the card, by wrapper
    (``ops/lattice_slab.LEVEL_KERNELS``): a fused V(nu, nu) cycle before
    the loop and each of its ``calls`` (``lattice_slab.cycle_launches`` on
    the levels as ``multigrid._vcycle`` takes them), and ``matvecs`` level
    steps of K p.  A cycle on 961x481 (V(3, 3)): 4 levels above the bottom
    with 2 nu = 6 level steps and one restriction each, and one bottom
    cycle (61x31 and 31x16): 24 + 4 + 1 = 29 launches; on a 513x257
    background: 3 x 6 = 18 level steps, 3 restrictions and one bottom
    (65x33 to 9x5), 22."""
    from hidenn_fem_tpu_torch.ops import lattice_slab as ls
    from hidenn_fem_tpu_torch.solve import multigrid as mg

    cycle = ls.cycle_launches(mg._fused_levels(
        mg._level_ops(model, levels), levels, nu, coarse_degree))
    out = {k: (calls + 1) * v for k, v in cycle.items()}
    out["lattice_level_step"] += matvecs
    return out


@contextlib.contextmanager
def solver_loop(capture=True, every=None):
    """The solvers' loops captured (the default) or eager, with
    ``loop.READ_EVERY`` set to ``every`` when given."""
    from hidenn_fem_tpu_torch.solve import loop

    saved = loop.capturable, loop.READ_EVERY
    if not capture:
        loop.capturable = lambda device: False
    if every is not None:
        loop.READ_EVERY = every
    try:
        yield loop
    finally:
        loop.capturable, loop.READ_EVERY = saved


def solver_run(counts, solve, capture, max_iters, tol, every=None):
    """One solve ``solve(max_iters, tol) -> (u, history)``, host-timed:
    (u, history, seconds, launches, graphs recorded, seconds recording)."""
    with solver_loop(capture, every) as loop:
        torch.cuda.synchronize()
        counts.reset()
        graphs, rec = loop.captures["graphs"], loop.captures["seconds"]
        t0 = time.perf_counter()
        u, h = solve(max_iters, tol)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return (u, h, seconds, counts.read(),
                loop.captures["graphs"] - graphs,
                loop.captures["seconds"] - rec)


def solver_steady(counts, solve, capture, pcaps, hcaps):
    """One iteration of the steady state, from the difference between
    solves at tol 0: on the host clock between solves capped at ``hcaps``
    (captured: after one untimed solve, each the least of STEADY_RUNS
    runs taken in turns, as the set-up's host time varies by tens of ms)
    and under the profiler between solves
    capped at ``pcaps`` (device busy, kernels by name); the idle share is
    that of the host-clock iteration (the profiler's own cost inflates a
    replay's wall); launches by the counters."""
    from tools.profile_torch_port import steady_profile

    if capture:     # the first captured solves pay the graphs' pools
        solver_run(counts, solve, capture, hcaps[0], 0.0)
    runs = [[solver_run(counts, solve, capture, m, 0.0) for m in hcaps]
            for _ in range(STEADY_RUNS if capture else 1)]
    host = [1e3 * min(r[i][2] for r in runs) for i in range(2)]
    launches = [sum(runs[0][i][3].values()) for i in range(2)]
    with solver_loop(capture):
        busy, kernels, by_name = steady_profile(lambda m: solve(m, 0.0),
                                                pcaps)
    dh = hcaps[1] - hcaps[0]
    host_ms = (host[1] - host[0]) / dh
    top = [(us, k) for k, us in list(by_name.items())[:6]]
    return {"host_ms": host_ms, "busy_ms": busy,
            "idle": 1.0 - busy / host_ms, "kernels": kernels,
            "launches": (launches[1] - launches[0]) / dh, "top_us": top}


def phase_solver_loop(counts, name, solve, max_iters, check, needs, caps,
                      card):
    """Phase 23 on one solve: eager, captured, captured, eager to tol 1e-6
    (bits, launches, whole-solve ms, the capture's cost), ``check`` on the
    captured solution (JAX's values), the steady state of both modes, and
    the captured solve at each READ_EVERY_SWEEP (bits and ms)."""
    from hidenn_fem_tpu_torch.solve import loop

    e1, c1, c2, e2 = (solver_run(counts, solve, c, max_iters, 1e-6)
                      for c in (False, True, True, False))
    h = check_hist(name, c1[1])
    n = len(h)
    calls = loop_calls(n, max_iters)
    for a, b, what in ((e1, e2, "eager vs eager"),
                       (c1, c2, "captured vs captured"),
                       (c1, e1, "captured vs eager")):
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        log(f"  {name}: {what}: "
            + ("bit-equal (solution and history)" if same else "differ"))
        if what == "captured vs eager" and not same:
            if torch.equal(e1[0], e2[0]) and torch.equal(e1[1], e2[1]):
                raise AssertionError(f"{name}: the captured solve is not "
                                     "bit-equal to the eager solve, which "
                                     "is deterministic")
            check_close(f"{name} captured vs eager history", c1[1], e1[1],
                        F32_SPREAD_RTOL, 0.0)
    if c1[3] != e1[3] or (c1[4], e1[4]) != (1, 0):
        raise AssertionError(f"{name}: launches {c1[3]} and graphs {c1[4]} "
                             f"captured vs {e1[3]} and {e1[4]} eager")
    for k in needs:
        if c1[3][k] == 0:
            raise AssertionError(f"{k} was not launched by {name}")
    check(c1[0], n, c1[3])
    log(f"  {name}: {n} iterations, {calls} calls of the loop body "
        f"(READ_EVERY {loop.READ_EVERY}); launches {c1[3]}; whole solve "
        f"ms eager {1e3 * e1[2]:.3f} / {1e3 * e2[2]:.3f}, captured "
        f"{1e3 * c1[2]:.3f} / {1e3 * c2[2]:.3f} (the captured solves "
        f"include the warm-up and recording the graph: {1e3 * c1[5]:.3f} "
        f"/ {1e3 * c2[5]:.3f} ms) [{card}]")
    out = {"iters": n, "calls": calls, "eager_s": (e1[2], e2[2]),
           "captured_s": (c1[2], c2[2]), "record_s": (c1[5], c2[5])}
    if caps is not None:
        for capture in (False, True):
            tag = "captured" if capture else "eager"
            hcaps = caps[1] if capture else caps[0]
            st = out[tag] = solver_steady(counts, solve, capture, caps[0],
                                          hcaps)
            log(f"  {name}: steady-state {tag} iteration (tol-0 solves "
                f"of {hcaps[0]} and {hcaps[1]} on the host clock, "
                f"{caps[0][0]} and {caps[0][1]} profiled): "
                f"{st['host_ms']:.4f} ms on "
                f"the host clock, {st['busy_ms']:.4f} ms device busy, idle "
                f"share {st['idle']:.3f}; {st['kernels']:.1f} kernels and "
                f"{st['launches']:.2f} port-kernel launches an iteration; "
                "device us an iteration by kernel: " + ", ".join(
                    f"{k} {us:.1f}" for us, k in st["top_us"])
                + f" [{card}]")
    sweep = {}
    for every in READ_EVERY_SWEEP + READ_EVERY_SWEEP[::-1]:
        u, hk, seconds, _, _, _ = solver_run(counts, solve, True,
                                             max_iters, 1e-6, every)
        if not (torch.equal(u, c1[0]) and torch.equal(hk, c1[1])):
            raise AssertionError(f"{name}: READ_EVERY {every} changes the "
                                 "solve's bits")
        sweep.setdefault(every, []).append(1e3 * seconds)
    log(f"  {name}: captured solve ms by READ_EVERY (two runs each, in "
        "turns; bit-equal): " + ", ".join(
            f"{k}: {v[0]:.3f} / {v[1]:.3f}" for k, v in sweep.items())
        + f" [{card}]")
    out["sweep"] = sweep
    return out


def solver_cases(ht, counts, mesh898, dev, card):
    """Phase 23's solves: name -> (solve(max_iters, tol) -> (u, history),
    max_iters, check(u, iterations, launches), kernels that must launch,
    steady-state caps or None).  Hierarchies and preconditioners are built
    here, once; the energies are held to the JAX constants of phases 11, 12
    and 14, and the V-cycle's level steps counted exactly: a V-cycle each
    solve's start and each call of the loop body, and K p each call
    (multigrid)."""
    from hidenn_fem_tpu_torch.mesh import coloring

    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    args898 = (mesh898.coords, mesh898)
    z898 = {"u": torch.zeros((mesh898.n_nodes, 2), device=dev)}
    colors = coloring.color_nodes(mesh898.connectivity, mesh898.n_nodes)

    def capped_898k(want, what):
        def check(u, n, launches):
            with torch.no_grad():
                e = float(loss({"u": u}, *args898))
            check_ref(f"898K {what} energy after {n} iterations (captured)",
                      e, want[0], F32_SPREAD_RTOL, want[1])
        return check

    def krylov(fn, **kw):
        def solve(m, tol):
            sol, h = fn(loss, z898, args898, max_iters=m, tol=tol, **kw)
            return sol["u"], h
        return solve

    grid, model, starts = mg_inputs(dev)
    with torch.no_grad():
        levels = ht.build_hierarchy(model, grid,
                                    model.coords(starts["noise"], grid))

    def mg_solve(m, tol):
        sol, h = ht.mg_pcg_solve(model, grid, starts["noise"], max_iters=m,
                                 tol=tol, levels=levels)
        return sol["u"], h

    def mg_check(u, n, launches):
        calls = loop_calls(n, 40)
        check_launches("captured MG-PCG", launches, {
            **solve_launches(model, levels, calls, matvecs=calls),
            "lattice_stencil_vg": 1})
        if abs(n - JAX_MG_ITERS) > MG_ITERS_SPREAD:
            raise AssertionError(f"captured MG-PCG: {n} iterations, JAX "
                                 f"{JAX_MG_ITERS}")
        with torch.no_grad():
            e = float(model({"coords": starts["noise"]["coords"], "u": u},
                            grid))
        check_ref("961x481 MG-PCG energy (captured)", e, JAX_MG_ENERGY[0],
                  SOLVE_RTOL, JAX_MG_ENERGY[1])

    aux = aux_loss(ht)
    bg = ht.StructuredGridP1(E=10e9, nu=0.3)
    proxy = ht.proxy_plate_mesh(nx=961, ny=481, device=dev)

    def aux_case(mesh, key, lattice_bg, colors=None):
        args = (mesh.coords, mesh)
        u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
        t0 = time.perf_counter()
        pre = ht.build_aux_preconditioner(aux, u0, args, mesh, bg_model=bg,
                                          node_colors=colors,
                                          lattice_bg=lattice_bg)
        torch.cuda.synchronize()
        log(f"  aux-PCG {key}: set-up {time.perf_counter() - t0:.3f} s "
            f"[{card}]")
        check_aux_setup(key, pre)
        (want_it, f32, f64) = JAX_AUX[(key, "rest")]

        def solve(m, tol):
            sol, h = ht.aux_pcg_solve(aux, u0, args, pre=pre, max_iters=m,
                                      tol=tol)
            return sol["u"], h

        def check(u, n, launches):
            check_launches(f"aux-PCG {key} (captured)", launches,
                           solve_launches(pre.bg_model, pre.levels,
                                          loop_calls(n, AUX_MAX_ITERS)))
            check_aux_iters(f"aux-PCG {key} from rest (captured)", n,
                            want_it)
            with torch.no_grad():
                e = float(aux({"u": u}, *args))
            check_ref(f"aux-PCG {key} energy from rest (captured)", e, f32,
                      SOLVE_RTOL, f64)
        return solve, check

    cases = {
        "898K cg_solve": (krylov(ht.cg_solve), CG_CAP,
                          capped_898k(JAX_898K_CG, "cg_solve"),
                          ("banded_vg",), SOLVER_CAPS["cg"]),
        "898K jacobi_pcg_solve": (
            krylov(ht.jacobi_pcg_solve, node_colors=colors), CG_CAP,
            capped_898k(JAX_898K_PCG, "jacobi_pcg_solve"), ("banded_vg",),
            None),
        "961x481 mg_pcg_solve": (mg_solve, 40, mg_check,
                                 ("lattice_stencil_vg", "lattice_level_step"),
                                 SOLVER_CAPS["mg"]),
    }
    for name, mesh, key, lattice_bg, c in (
            ("961x481 aux_pcg_solve, lattice-aligned background", proxy,
             "lattice", True, None),
            ("961x481 aux_pcg_solve, generic background", proxy, "generic",
             False, None),
            ("898K aux_pcg_solve", mesh898, "delaunay", True, colors)):
        solve, check = aux_case(mesh, key, lattice_bg, c)
        needs = ("lattice_level_step",) + (
            ("banded_vg",) if key == "delaunay" else ("lattice_stencil_vg",))
        cases[name] = (solve, AUX_MAX_ITERS, check, needs,
                       SOLVER_CAPS["aux"])
    return cases


# Phase 24: the JAX package's analytic checks on the card, at the JAX
# tests' own sizes and with their bounds (tests/test_torch_validation.py
# holds the port to them, and to JAX, on the CPU).  Every solve starts
# from rest.  The JAX values printed beside the card's: the JAX test's
# docstring (from its random start) and the JAX package's from rest on the
# CPU, made with that test file's helpers (f32), e.g.
#   JAX_PLATFORMS=cpu python -c "
#   import sys; sys.path[:0] = ['tests', '.']
#   import hidenn_fem_tpu as ht, test_torch_validation as v
#   m = ht.generate_mesh_hybrid(holes=(v.KIRSCH_HOLE,), lc=0.012)
#   u, vm, cent, h = v._kirsch(ht, m); print(v._peak(vm, cent, 0.012))
#   jm, _ = v._mms_meshes('delaunay', 1 / 8); print(v._mms_solve(ht,
#       'delaunay', jm)[1])
#   print(v._bar(ht, True, 2000)[:2])
#   print(v._plateau(ht, ht.proxy_plate_mesh(nx=21, ny=11,
#       variant='zigzag')))"
# Kirsch/Howland: one hole (d/W = 0.2) in the 2x1 plate under t = F/L,
# aux_pcg_solve to relres 1e-6; the peak P1 centroid von Mises within
# KIRSCH_BAND x sigma_max = (2 + (1 - d/W)^3) / (1 - d/W) t (Heywood's fit
# to Howland's series) and within 2 lc of the rim's top or bottom.
KIRSCH_HOLE, KIRSCH_LC = (1.0, 0.5, 0.1), 0.012
KIRSCH_BAND = (0.91, 1.05)
# peak / sigma_max: (the JAX test's doc, JAX from rest)
JAX_KIRSCH = {"hybrid": (0.966, 0.9660271282663391),
              "delaunay": (0.976, 0.9753011536601744)}
# The manufactured solution u = (A sin(ax x) sin(by y), 0) on the clamped
# Delaunay unit square and the clamped hybrid 2x1 plate with a hole of
# radius 0.25 (the rim traction sigma(u) n as a midpoint work term over
# the rim edges), cg_solve to tol 1e-8 on the plain route (JAX's
# backend="xla"); order log2(e1 / e2) > MMS_ORDER and e2 < MMS_E2 x A.
# kind: (length, holes, (lc1, lc2), CG cap, (ax, by)).  From rest the CG's
# recursive residual reaches 1e-8 in 37-151 f32 iterations on the CPU, in
# both packages, so the captured loop stops on its device flag before the
# cap.
MMS_A, MMS_ORDER, MMS_E2 = 1e-2, 1.8, 1e-2
MMS_CASES = {"delaunay": (1.0, (), (1 / 8, 1 / 16), 4000, (np.pi, np.pi)),
             "hybrid": (2.0, ((1.0, 0.5, 0.25),), (0.1, 0.05), 8000,
                        (np.pi / 2, np.pi))}
# (e1, e2): the JAX test's doc, JAX from rest
JAX_MMS = {"delaunay": ((1.75e-4, 3.90e-5),
                        (1.7336585733573884e-4, 3.903258402715437e-05)),
           "hybrid": ((1.40e-4, 3.57e-5),
                      (1.404473150614649e-4, 3.572701461962424e-05))}
# The example-3 bar at 41 nodes, 2000 L-BFGS steps, fixed and r-adapted:
# the adapted energy lower, its L2 error < BAR_RATIO x the fixed one's,
# its grid moved by > BAR_MOVED.  (fixed, adapted) L2 errors: the JAX
# test's doc, JAX from rest.  The adapted run is also made on the plain
# history passes (a P of 79 on the card's kernels otherwise): the first
# BAR_PATHS_STEPS losses within BAR_PATHS_RTOL of the kernels' (JAX and
# the port in f32 on the CPU lie 5e-6 apart at step 50; later, f32
# rounding may take a run off the -0.0307 plateau to a lower one, so each
# run is held to the bounds alone).
BAR_NODES, BAR_STEPS, BAR_RATIO, BAR_MOVED = 41, 2000, 0.85, 0.05
JAX_BAR = ((3.27e-4, 2.49e-4),
           (0.00032653913283580354, 0.0002490607759711886))
BAR_PATHS_STEPS, BAR_PATHS_RTOL = 50, 1e-4
# The 21x11 proxy plate, 200 L-BFGS steps from rest on the lattice route:
# the "zigzag" and "up" plateaus within DIAGONAL_RTOL of each other; each
# within PLATEAU_RTOL of JAX's from rest and of its no-grad energy at the
# solution (K7).
DIAGONAL_RTOL, PLATEAU_RTOL = 5e-3, 1e-4
JAX_PLATEAUS = {"zigzag": -0.9930872321128845, "up": -0.99286288022995}
# the card's peak ratio and errors against JAX's from rest (the slow CPU
# mirrors' limit)
MIRROR_RTOL = 1e-2


def kirsch_check(ht, backend, dev, card):
    """One Kirsch/Howland case (phase 24); returns peak / sigma_max."""
    from hidenn_fem_tpu_torch.postproc import von_mises_per_element

    E, nu, f_total = 10e9, 0.3, 100e3
    cx, cy, a = KIRSCH_HOLE
    t0 = time.perf_counter()
    mesh = getattr(ht, f"generate_mesh_{backend}")(
        holes=(KIRSCH_HOLE,), lc=KIRSCH_LC, device=dev)
    if backend == "delaunay" and mesh.banded is not None:
        raise AssertionError("the Kirsch Delaunay plate has banded tables")
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model, E=E, nu=nu, F_total=f_total)
    coords0 = mesh.coords

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)
    sol, hist = ht.aux_pcg_solve(loss, {"u": torch.zeros((mesh.n_nodes, 2), device=dev)},
                                 (coords0, mesh), mesh=mesh, max_iters=100,
                                 tol=1e-6)
    params = {"u": sol["u"], "coords": coords0}
    with torch.no_grad():
        vm = von_mises_per_element(model, params, mesh, E, nu)
        coords = model.coords(params, mesh)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    h = hist.cpu().numpy()
    vm = vm.double().cpu().numpy()
    cent = coords.double().cpu().numpy()[
        mesh.connectivity.long().cpu().numpy()].mean(1)
    d_w = 2 * a / 1.0
    sigma_max = (2 + (1 - d_w) ** 3) / (1 - d_w) * (f_total / 1.0)
    i = int(np.argmax(vm))
    ratio = float(vm[i] / sigma_max)
    dist = float(min(np.hypot(cent[i, 0] - cx, cent[i, 1] - (cy + a)),
                     np.hypot(cent[i, 0] - cx, cent[i, 1] - (cy - a))))
    last = float(h[h > 0][-1])
    doc, rest = JAX_KIRSCH[backend]
    log(f"  Kirsch/Howland on the {backend} plate (lc {KIRSCH_LC}, "
        f"{mesh.connectivity.shape[0]} elements, {mesh.n_nodes} nodes): "
        f"peak von Mises / sigma_max {ratio!r} (limits {KIRSCH_BAND}; JAX "
        f"{doc} from its random start, {rest!r} from rest), at "
        f"({cent[i, 0]:.5f}, {cent[i, 1]:.5f}), {dist / KIRSCH_LC:.4f} lc "
        f"from the rim's top or bottom (limit 2); aux-PCG "
        f"{int((h > 0).sum())} iterations, last relres {last!r} (limit "
        f"1e-6); {sec:.3f} s with the mesh and the set-up [{card}]")
    if not last < 1e-6:
        raise AssertionError(f"Kirsch {backend}: aux-PCG stopped at relres "
                             f"{last}")
    if not KIRSCH_BAND[0] <= ratio <= KIRSCH_BAND[1]:
        raise AssertionError(f"Kirsch {backend}: peak ratio {ratio}")
    if not dist < 2 * KIRSCH_LC:
        raise AssertionError(f"Kirsch {backend}: the peak lies off the "
                             "rim's top and bottom")
    if abs(ratio - rest) > MIRROR_RTOL * rest:
        raise AssertionError(f"Kirsch {backend}: peak ratio off JAX's")
    return ratio


def mms_error(ht, kind, lc, dev):
    """The manufactured-solution solve from rest on the ``kind`` mesh at
    ``lc``; (area-weighted centroid L2 error, CG iterations, seconds)."""
    length, holes, _, cap, (ax, by) = MMS_CASES[kind]
    E, nu, A = 10.0, 0.3, MMS_A
    c11 = E / (1 - nu ** 2)
    c12, c33 = nu * c11, 0.5 * (1 - nu) * c11

    def u_exact(x):
        ux = A * torch.sin(ax * x[:, 0]) * torch.sin(by * x[:, 1])
        return torch.stack([ux, 0.0 * ux], 1)

    def body_force(x):
        s = torch.sin(ax * x[:, 0]) * torch.sin(by * x[:, 1])
        c = torch.cos(ax * x[:, 0]) * torch.cos(by * x[:, 1])
        return torch.stack([A * (c11 * ax ** 2 + c33 * by ** 2) * s,
                            -A * ax * by * (c33 + c12) * c], 1)

    t0 = time.perf_counter()
    mesh = getattr(ht, f"generate_mesh_{kind}")(
        length=length, height=1.0, holes=holes, lc=lc, device=dev,
        boundaries={"left": 1, "right": 1, "up": 1, "down": 1})
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model, E=E, nu=nu,
                                  body_force=body_force, backend="plain")
    coords0 = mesh.coords

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)
    if holes:
        # the rim traction as device tensors built once: the captured CG
        # body reads nothing from the host
        (cx, cy, r), = holes
        n_lat = mesh.hybrid.lattice.nx * mesh.hybrid.lattice.ny
        pts = mesh.coords[n_lat:].cpu().numpy()
        ids = n_lat + np.argsort(np.arctan2(pts[:, 1] - cy, pts[:, 0] - cx))
        edges = torch.tensor(np.stack([ids, np.roll(ids, -1)], 1),
                             device=dev)
        center = torch.tensor([cx, cy], device=dev)
        domain = loss

        def loss(p, coords, m):
            u_full = model.u_full({"u": p["u"], "coords": coords}, m)
            c1, c2 = coords[edges[:, 0]], coords[edges[:, 1]]
            xm = 0.5 * (c1 + c2)
            um = 0.5 * (u_full[edges[:, 0]] + u_full[edges[:, 1]])
            dl = torch.sqrt(torch.sum((c2 - c1) ** 2, 1))
            nvec = -(xm - center) / r
            exx = A * ax * torch.cos(ax * xm[:, 0]) * torch.sin(by * xm[:, 1])
            gxy = A * by * torch.sin(ax * xm[:, 0]) * torch.cos(by * xm[:, 1])
            sxx, syy, sxy = c11 * exx, c12 * exx, c33 * gxy
            tx = sxx * nvec[:, 0] + sxy * nvec[:, 1]
            ty = sxy * nvec[:, 0] + syy * nvec[:, 1]
            return domain(p, coords, m) - torch.sum(
                dl * (tx * um[:, 0] + ty * um[:, 1]))
    sol, hist = ht.cg_solve(loss, {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}, (coords0, mesh),
                            max_iters=cap, tol=1e-8)
    params = {"u": sol["u"], "coords": coords0}
    with torch.no_grad():
        conn = mesh.connectivity.long()
        cent = model.coords(params, mesh)[conn].mean(1)
        uh = model.u_full(params, mesh)[conn].mean(1)
        det, _ = model.element_fields(params, mesh)
        err = float(torch.sqrt(torch.sum(
            0.5 * torch.abs(det) * torch.sum((uh - u_exact(cent)) ** 2, 1))))
    sec = time.perf_counter() - t0
    h = hist.cpu().numpy()
    if not np.all(np.isfinite(h)):
        raise AssertionError(f"{kind} manufactured solution: non-finite "
                             "residual")
    return err, int((h > 0).sum()), sec, mesh.n_nodes


def mms_check(ht, kind, dev, card):
    """One manufactured-solution order check (phase 24)."""
    lcs, cap = MMS_CASES[kind][2], MMS_CASES[kind][3]
    runs = [mms_error(ht, kind, lc, dev) for lc in lcs]
    (e1, it1, s1, n1), (e2, it2, s2, n2) = runs
    order = float(np.log2(e1 / e2))
    doc, rest = JAX_MMS[kind]
    log(f"  manufactured solution on the {kind} meshes, lc {lcs[0]:.4g} -> "
        f"{lcs[1]:.4g} ({n1} -> {n2} nodes): L2 error {e1!r} -> {e2!r}, "
        f"order {order:.4f} (limit > {MMS_ORDER}), e2 / A {e2 / MMS_A:.4e} "
        f"(limit {MMS_E2}); JAX {doc[0]} -> {doc[1]} from its random start, "
        f"{rest[0]!r} -> {rest[1]!r} from rest; CG {it1} and {it2} "
        f"iterations (cap {cap}), {s1:.3f} and {s2:.3f} s [{card}]")
    if not (order > MMS_ORDER and e2 < MMS_E2 * MMS_A):
        raise AssertionError(f"{kind}: not second order")
    for got, want in zip((e1, e2), rest):
        if abs(got - want) > MIRROR_RTOL * want:
            raise AssertionError(f"{kind}: L2 error off JAX's")
    return order


@contextlib.contextmanager
def plain_history():
    """The compact L-BFGS on the plain history passes (a comparison, not a
    path of the port)."""
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh
    from hidenn_fem_tpu_torch.solve import optimizers

    saved = optimizers.history_dots, optimizers.history_combine
    optimizers.history_dots = lh.history_dots_plain
    optimizers.history_combine = lh.history_combine_plain
    try:
        yield
    finally:
        optimizers.history_dots, optimizers.history_combine = saved


def bar_solve(ht, r_adapt, dev):
    """The example-3 bar at BAR_NODES nodes, BAR_STEPS L-BFGS steps;
    (loss history, L2 error against u_true, grid moved, seconds)."""
    from examples.example3_torch import b_force, u_true

    t0 = time.perf_counter()
    model, params = ht.Linear1D.from_node_coords(
        np.linspace(0, 10, BAR_NODES), r_adapt=r_adapt, u0=0.0, uN=0.0,
        device=dev)
    params, hist = ht.run_lbfgs(
        lambda p: ht.bar_energy_1d(model, p, 4, b_force, 175.0), params,
        num_steps=BAR_STEPS)
    xs = np.linspace(0, 10, 4001)
    with torch.no_grad():
        u = model.apply(params, torch.tensor(xs, dtype=torch.float32,
                                             device=dev))
        grid = model.grid(params)
    u = u.double().cpu().numpy()
    sec = time.perf_counter() - t0
    err = float(np.sqrt(np.trapezoid((u - u_true(xs, 175.0)) ** 2, xs)))
    moved = float(np.abs(grid.double().cpu().numpy()
                         - np.linspace(0, 10, BAR_NODES)).max())
    hist = hist.double().cpu().numpy()
    if not np.all(np.isfinite(hist)):
        raise AssertionError("the bar's loss history is not finite")
    return hist, err, moved, sec


def bar_check(ht, counts, dev, card):
    """The r-adapted bar against the fixed one (phase 24), then the
    adapted run on the plain history passes; returns the kernels' path
    launches."""
    (h_fix, e_fix, _, s_fix), launches = run_path(
        counts, "bar fixed", ("lbfgs_history_dots", "lbfgs_history_combine"),
        lambda: bar_solve(ht, False, dev))
    (h_ad, e_ad, moved, s_ad), ad_launches = run_path(
        counts, "bar r-adapted",
        ("lbfgs_history_dots", "lbfgs_history_combine"),
        lambda: bar_solve(ht, True, dev))
    doc, rest = JAX_BAR
    log(f"  bar, {BAR_NODES} nodes, {BAR_STEPS} steps: energy fixed "
        f"{float(h_fix[-1])!r}, r-adapted {float(h_ad[-1])!r}; L2 error fixed {e_fix!r}, "
        f"r-adapted {e_ad!r}, ratio {e_ad / e_fix:.4f} (limit {BAR_RATIO}; "
        f"JAX {doc[1] / doc[0]:.2f} from its doc, {rest[1] / rest[0]:.4f} "
        f"from the same init: {rest[0]!r}, {rest[1]!r}); grid moved "
        f"{moved:.4f} (limit > {BAR_MOVED}); {s_fix:.3f} and {s_ad:.3f} s "
        f"[{card}]")
    if not (h_ad[-1] < h_fix[-1] and e_ad < BAR_RATIO * e_fix
            and moved > BAR_MOVED):
        raise AssertionError("the r-adapted bar does not beat the fixed one")
    if abs(e_fix - rest[0]) > MIRROR_RTOL * rest[0]:
        raise AssertionError("the fixed bar's error is off JAX's")
    with plain_history():
        (h_pl, e_pl, moved_pl, s_pl), pl_launches = run_path(
            counts, "bar r-adapted, plain history passes", (),
            lambda: bar_solve(ht, True, dev))
    if any(pl_launches.values()):
        raise AssertionError("the plain history passes launched a kernel")
    n = BAR_PATHS_STEPS
    step_rel = np.abs(h_pl[:n] - h_ad[:n]) / np.abs(h_ad[:n]).clip(min=1e-30)
    rel = float(step_rel.max())
    log(f"  bar r-adapted on the plain history passes: energy "
        f"{float(h_pl[-1])!r}, L2 error {e_pl!r}, ratio {e_pl / e_fix:.4f}, "
        f"grid moved {moved_pl:.4f}; the first {n} losses within rel "
        f"{rel:.3e} of the kernels' (limit {BAR_PATHS_RTOL}; at steps 1, 2, "
        f"5, 10, 20, {n - 1}: "
        f"{', '.join(f'{step_rel[k]:.2e}' for k in (1, 2, 5, 10, 20, n - 1))}"
        f"); {s_pl:.3f} s [{card}]")
    if rel > BAR_PATHS_RTOL:
        raise AssertionError("the bar's history kernels depart from the "
                             "plain passes")
    if not (h_pl[-1] < h_fix[-1] and e_pl < BAR_RATIO * e_fix
            and moved_pl > BAR_MOVED):
        raise AssertionError("the bar on the plain history passes misses "
                             "a bound")
    return sum_launches((launches, ad_launches))


def diagonal_check(ht, counts, dev, card):
    """The 21x11 plate's plateaus on the two diagonals (phase 24);
    returns the path launches."""
    plateaus, paths = {}, []
    for variant in ("zigzag", "up"):
        def solve():
            t0 = time.perf_counter()
            mesh = ht.proxy_plate_mesh(nx=21, ny=11, variant=variant,
                                       device=dev)
            if mesh.lattice is None:
                raise AssertionError(f"{variant}: no lattice route")
            energy = ht.PlaneStressEnergy(model=ht.TriangleP1())
            coords0 = mesh.coords

            def loss(p):
                return energy({"u": p["u"], "coords": coords0}, mesh)
            sol, losses = ht.run_lbfgs(loss, {"u": torch.zeros((mesh.n_nodes, 2), device=dev)},
                                       num_steps=200)
            with torch.no_grad():
                at_solution = float(loss(sol))
            return (losses.double().cpu().numpy(), at_solution,
                    time.perf_counter() - t0)
        (losses, at_solution, sec), launches = run_path(
            counts, f"21x11 {variant}",
            ("lattice_stencil_vg", "lattice_stencil_fwd",
             "lbfgs_history_dots", "lbfgs_history_combine"), solve)
        paths.append(launches)
        plateau = float(losses[-1])
        want = JAX_PLATEAUS[variant]
        log(f"  21x11 {variant}: plateau {plateau!r} (JAX from rest "
            f"{want!r}, rel {abs(plateau - want) / abs(want):.3e}, limit "
            f"{PLATEAU_RTOL}); no-grad energy at the solution "
            f"{at_solution!r}; 200 steps in {sec:.3f} s [{card}]")
        if not np.all(np.isfinite(losses)) or \
                abs(plateau - want) > PLATEAU_RTOL * abs(want) or \
                abs(at_solution - plateau) > PLATEAU_RTOL * abs(plateau):
            raise AssertionError(f"21x11 {variant}: plateau off")
        plateaus[variant] = plateau
    rel = abs(plateaus["zigzag"] - plateaus["up"]) / abs(plateaus["up"])
    log(f"  diagonal independence: zigzag against up rel {rel:.3e} (limit "
        f"{DIAGONAL_RTOL}; JAX from rest "
        f"{abs(JAX_PLATEAUS['zigzag'] - JAX_PLATEAUS['up']) / abs(JAX_PLATEAUS['up']):.3e})")
    if rel > DIAGONAL_RTOL:
        raise AssertionError("the plateau depends on the diagonal")
    return sum_launches(paths)


def phase_validation(ht, counts, dev, card):
    """Phase 24: the five analytic checks; returns each kernel path's
    launches by check."""
    launches = {}
    for backend, needs in (
            ("hybrid", ("lattice_level_step",)),
            ("delaunay", ("element_energy_fwd", "element_energy_bwd",
                          "incidence_sum", "lattice_level_step"))):
        t0 = time.perf_counter()
        _, launches[f"Kirsch {backend}"] = run_path(
            counts, f"Kirsch {backend}", needs,
            lambda: kirsch_check(ht, backend, dev, card))
        log(f"  Kirsch {backend}: {time.perf_counter() - t0:.3f} s")
    for kind in ("delaunay", "hybrid"):
        t0 = time.perf_counter()
        _, mms_launches = run_path(counts, f"{kind} manufactured solution",
                                   (), lambda: mms_check(ht, kind, dev, card))
        if any(mms_launches.values()):
            raise AssertionError(f"the {kind} manufactured solution on the "
                                 "plain route launched a kernel")
        log(f"  {kind} order: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    launches["bar"] = bar_check(ht, counts, dev, card)
    log(f"  bar: {time.perf_counter() - t0:.3f} s, launches "
        f"{launches['bar']}")
    t0 = time.perf_counter()
    launches["diagonals"] = diagonal_check(ht, counts, dev, card)
    log(f"  diagonals: {time.perf_counter() - t0:.3f} s, launches "
        f"{launches['diagonals']}")
    return launches


def main():
    import os

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on a GPU")
    # the numpy host paths until phase 20 (module doc)
    os.environ["HDNN_NO_NATIVE"] = "1"
    import hidenn_fem_tpu_torch as ht
    from hidenn_fem_tpu_torch.mesh import banded as mb
    from hidenn_fem_tpu_torch.ops import banded_energy as be
    from hidenn_fem_tpu_torch.ops import cuda_build
    from hidenn_fem_tpu_torch.ops import element_energy as ee
    from hidenn_fem_tpu_torch.ops import lattice_slab as ls
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh
    from hidenn_fem_tpu_torch.ops import window_gather as wg

    counts = Counts(ee, ls, be, wg, lh)
    history = tuple(lh.launch_counts)   # every compact L-BFGS update

    def energy_launches(launches):
        return {k: v for k, v in launches.items() if k not in history}
    t_start = time.perf_counter()

    def phase(title):
        log(f"{title} (t = {time.perf_counter() - t_start:.1f} s)")

    phase("[1/24] environment")
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    log("  TF32 off for matmul and cuDNN")

    phase("[2/24] build")
    build = cuda_build.build_kernels()
    for stem, path in build["libraries"].items():
        log(f"  {stem}: {path}")
    log(f"  built in {build['seconds']:.2f} s (one nvcc per source, in "
        "parallel)")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    phase("[3/24] kernel vs plain at full size")
    mesh922 = plate_922k(ht, dev)
    kernels = phase_gather(ht, ee, mesh922, dev, card)
    stencil = phase_lattice(ht, ls, mesh922, dev, card)
    phase_structured(ls, dev, card)
    kernels += stencil
    mesh898 = delaunay_898k(ht, mb, dev)
    banded = phase_banded(ht, be, mb, mesh898, dev, card)
    kernels += banded
    tri898, banded_rows = phase_rows_banded(ht, be, mesh898, dev, card)
    kernels += banded_rows
    kernels.append(phase_window_gather(ht, wg, mb, counts, dev, card))
    mesh4 = example4_mesh(ht, dev)
    kernels += phase_lbfgs_history(lh, (
        ("898K Delaunay plate", HISTORY_M, 4 * mesh898.n_nodes),
        ("example 4", HISTORY_M, 4 * mesh4.n_nodes),
        ("922K-class plate", HISTORY_M, 4 * mesh922.n_nodes),
        ("example 6", *EX6_HISTORY)), dev, card)

    phase("[4/24] example 4 on its default route (lattice), 600 steps")
    ex4_final, lattice_launches = run_path(
        counts, "example-4 lattice-route",
        ("lattice_stencil_vg", "lattice_stencil_fwd") + history,
        lambda: solve_example4(ht, mesh4, dev, card,
                               JAX_EX4_LATTICE_FINAL_ENERGY,
                               "lattice route"))

    phase("[5/24] example 4 on the gather route (lattice stripped), 600 steps")
    _, gather_launches = run_path(
        counts, "example-4 gather-route",
        ("element_energy_fwd", "element_energy_bwd", "incidence_sum")
        + history,
        lambda: solve_example4(ht, dataclasses.replace(mesh4, lattice=None),
                               dev, card, JAX_EX4_FINAL_ENERGY,
                               "gather route"))

    phase("[6/24] example 6: 1000x500 structured plate, 600 steps")
    run_path(counts, "example-6", ("lattice_stencil_vg",
                                   "lattice_stencil_fwd") + history,
             lambda: phase_example6(dev, card))

    phase("[7/24] scale: 922K-class plate, 50 L-BFGS steps, lattice route")
    run_path(counts, "922K-class", ("lattice_stencil_vg",) + history,
             lambda: phase_scale(ht, mesh922, dev, card))

    phase("[8/24] 898K Delaunay plate: 50 L-BFGS steps on the banded route")
    (main_losses, delaunay_params), delaunay_launches = run_path(
        counts, "898K Delaunay banded-route",
        ("banded_vg", "banded_fwd") + history,
        lambda: phase_delaunay_solve(ht, be, mesh898, dev, card))
    fallback_launches = {}
    for name, keep in (("no ownership intervals", True),
                       ("no recompute tables", False)):
        _, fallback_launches[keep] = run_path(
            counts, f"898K Delaunay banded fallback ({name})",
            ("banded_fwd", "banded_bwd"),
            lambda: phase_banded_fallback(ht, mesh898, dev, card,
                                          main_losses, name, keep))

    phase("[9/24] hybrid lattice+collar plate at scale, 10 L-BFGS steps")
    solve, hybrid = phase_hybrid(ht, ee, dev, card)
    _, hybrid_launches = run_path(counts, "847K hybrid-route", history,
                                  solve)
    if any(energy_launches(hybrid_launches).values()):
        raise AssertionError("the hybrid route launched an energy kernel")

    phase("[10/24] the sharded paths as groups of ranks on the one card")
    sharded = phase_sharded(ht, sharded_inputs(ht, mesh922, tri898, mesh4,
                                               hybrid, dev), card)

    phase("[11/24] the CG family: example 8, the 898K plate, minimize")
    run_path(counts, "example-8 CG", ("lattice_stencil_vg",
                                      "lattice_stencil_fwd"),
             lambda: phase_example8(dev, card))
    phase_cg_898k(ht, be, mesh898, dev, card, counts)
    run_path(counts, "example-4 minimize(cg, jacobi_cg)",
             ("lattice_stencil_vg", "lattice_stencil_fwd"),
             lambda: phase_minimize_ex4(ht, mesh4, dev, card))

    phase("[12/24] multigrid: example 9 at 961x481")
    mg_launches, level_entries = phase_multigrid(ht, ls, dev, card, counts)
    kernels += level_entries

    phase("[13/24] node-space L-BFGS on example 4, 600 steps")
    run_path(counts, "example-4 node-space", ("lattice_stencil_vg",
                                              "lattice_stencil_fwd"),
             lambda: phase_node_space(ht, mesh4, dev, card, ex4_final))

    phase("[14/24] auxiliary-space PCG: examples 10-12, the 898K and 847K "
        "plates, r-adaptivity")
    phase_aux_example10(ht, counts, dev, card)
    kernels += phase_aux_898k(ht, ls, counts, mesh898, dev, card)
    phase_aux_hybrid(ht, counts, hybrid, dev, card)
    phase_aux_radapt(ht, counts, dev, card)

    phase("[15/24] example 5: the 1000x500 plate, slope-timed "
        "value-and-grad and 2 x 200 L-BFGS steps")
    _, ex5_launches = run_path(counts, "example-5", history,
                               lambda: phase_example5(dev, card))
    if any(energy_launches(ex5_launches).values()):
        raise AssertionError("example 5's plain lattice route launched an "
                             "energy kernel")

    phase("[16/24] the zoom line search and the two-loop L-BFGS on "
        "example 4")
    variants = phase_lbfgs_variants(ht, mesh4, dev, card, counts)

    phase("[17/24] utils: a checkpointed and resumed solve, check_gradients")
    utils_launches = phase_utils(ht, mesh4, dev, card, counts)

    phase("[18/24] examples 1-3 at their own sizes")
    run_path(counts, "examples 1-3", (),
             lambda: phase_examples_1d(ht, dev, card))

    phase("[19/24] point evaluation: 10^6 points on the 898K plate's "
        "solution")
    run_path(counts, "point evaluation", (),
             lambda: phase_point_eval(ht, mesh898, delaunay_params, dev,
                                      card))
    arrays898 = [t.cpu().numpy() for t in mesh898.astuple()]
    del delaunay_params

    phase("[20/24] the native mesh loader: the 898K plate's host tables "
        "both ways")
    run_path(counts, "native loader", (),
             lambda: phase_native(ht, arrays898, dev, card))

    phase("[21/24] the captured step against the eager loop")
    capture_routes = capture_cases(ht, mesh4, mesh898, dev)
    captured = {}
    for route, (loss, params, args, steps, m, needs) in \
            capture_routes.items():
        captured[route], _ = run_path(
            counts, f"{route} captured vs loop", needs,
            lambda: phase_capture(ht, counts, route, loss, params, args,
                                  steps, m, card))
    del capture_routes
    two_loop_copies(mesh922, dev, card)

    phase("[22/24] figure parity: the 81x41 proxy plate against the "
        "reference run, 600 captured steps")
    # the reference numerics take the plain route: no energy kernel
    run_path(counts, "figure parity", (),
             lambda: phase_figure_parity(ht, dev, card))

    phase("[23/24] the linear solvers' captured while loops against the "
        "eager loop")
    for name, (solve, max_iters, check, needs, caps) in solver_cases(
            ht, counts, mesh898, dev, card).items():
        phase_solver_loop(counts, name, solve, max_iters, check, needs,
                          caps, card)
    del mesh898

    phase("[24/24] analytic validation: Kirsch/Howland, O(h^2) on Delaunay "
          "and hybrid meshes, the r-adapted bar, diagonal independence")
    validation = phase_validation(ht, counts, dev, card)

    # each entry's launches: (the path's counts, the wrapper's counter);
    # K6 and its row variant also count slice 9's paths
    k6_paths = (lattice_launches, variants["zoom"], variants["two-loop"],
                variants["compact"], utils_launches, sharded["sharded MG"],
                validation["diagonals"])
    # phase 24's paths count too: the Delaunay Kirsch solve for the gather
    # kernels (its V-cycle and the hybrid one's run the level steps), the
    # 21x11 plates for K6, K7 and the history kernels, the bar for the
    # history kernels
    gather_paths = sum_launches((gather_launches,
                                 validation["Kirsch delaunay"]))
    path_launches = {
        "lattice_stencil_vg": (sum_launches(k6_paths),
                               "lattice_stencil_vg"),
        "lattice_stencil_fwd": (sum_launches((lattice_launches,
                                              validation["diagonals"])),
                                "lattice_stencil_fwd"),
        "element_energy_fwd": (gather_paths, "element_energy_fwd"),
        "element_energy_bwd": (gather_paths, "element_energy_bwd"),
        "incidence_sum": (gather_paths, "incidence_sum"),
        "banded_fwd": (delaunay_launches, "banded_fwd"),
        "banded_vg": (delaunay_launches, "banded_vg"),
        "banded_bwd": (fallback_launches[True], "banded_bwd"),
        "banded_bwd_two_pass": (fallback_launches[False], "banded_bwd"),
        "lattice_stencil_vg_rows": (sum_launches((sharded["slab 922K"],
                                                  sharded["sharded MG"])),
                                    "lattice_stencil_vg_rows"),
        "lattice_stencil_fwd_rows": (sharded["slab 922K"],
                                     "lattice_stencil_fwd_rows"),
        "banded_vg_rows": (sharded["banded 898K"], "banded_vg_rows"),
        "banded_bwd_rows": (sharded["banded 898K, no ownership"],
                            "banded_bwd_rows"),
    }
    # the level kernels: example 9's MG-PCG (phase 12)
    for name in ls.LEVEL_KERNELS:
        path_launches[name] = (mg_launches, name)
    # the history kernels: every compact L-BFGS update of example 4's
    # lattice route, of the 898K plate's banded route and of phase 24
    for name in history:
        path_launches[name] = (sum_launches((
            lattice_launches, delaunay_launches, validation["bar"],
            validation["diagonals"])), name)
    for k in kernels:
        if k["launches"] is None:
            launches, counter = path_launches[k["name"]]
            k["launches"] = launches[counter]
    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
