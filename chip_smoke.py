#!/usr/bin/env python3
"""Drive the gpmpc_tpu_torch port on one NVIDIA GPU and check it.

Run from the repository root: python3 chip_smoke.py [--out DIR]
(DIR, default chip_smoke_out/, receives the run summary and a profiler table)

Phases (each one fails the script with a non-zero exit; nothing is caught):
  1. device     CUDA present; the card's name and power limit.
  2. build      every CUDA source under gpmpc_tpu_torch/ops/kernels/csrc is
                compiled by nvcc into gpmpc_tpu_torch/_build/, one nvcc per
                source, all started together (each kernel's f32 and f64
                instances are two sources); each source's seconds. Then the
                FP64 instructions of CUDA's double exp, read from the SASS
                of a one-line kernel built with the libraries' flags
                (benchmarks/sass_fp64.py): the f64 bounds count each pair's
                exp by them; the static DMMA and vector FP64 counts of the
                tensor-core body's kernels; the registers and local memory
                (spills) of K1's f64 instances, from cuobjdump -res-usage
                (benchmarks/res_usage.py).
  3. kernels    Each kernel's f32 instance, evaluated natively in f32
                (native=True: the trace's precision policy would run the f64
                instance), against its plain PyTorch version in f64 on the
                card, at the headline shape and a ragged one, on the JAX
                kernel test's inputs: forward rtol 5e-5 (atol 5e-5),
                backward rtol 2e-3 (atol 2e-4), that test's bars. On the
                headline GP's own x and b_lam, whose trace cancels, the
                kernels' f32 and f64 instances against the plain f64 version:
                rtol 5e-5 (f32) or 1e-12 (f64) of |t| plus 16 ulps of the
                terms' magnitude sum; K1 (both instances) also at every
                lane count of the recipe there (RECIPE_WIDTHS: B = 64 to
                3,584). A tied f64 launch (K1, K3) takes the route of
                variance_trace.rw_tied_body: the f64 tensor-core body
                (csrc/rw_tied_f64_body.cuh) where its grid holds a block for
                every SM, else the scalar body's plan. The p50
                relative error of its f32 t against f64 beside the JAX
                kernel's on a TPU. K1 (tied)
                and K2 (untied); K3 (the row
                block) as its partial traces summed over n_m = 1, 2 and 4 row
                blocks, also against K1 in f32; K4 (the symmetric pairs,
                GPMPC_SYM_KERNEL=1) tied and per-output, also against K1 and
                K2 in f32. Then the precision policy, every path (K1-K4) from
                f32 operands against the plain f64 trace of the same
                operands: within one f32 ulp of |t| plus 16 f64 ulps of the
                magnitude sum. Then K1's f32 and f64 instances and the policy
                on the non-diagonal M2 of the full-covariance rollout (the
                f64 headline rollout at the reference controls, its traces'
                operands captured at four steps). Each kernel's f32 and f64
                instances are timed with CUDA events beside their plain
                versions and their bounds (K2 one launch a trace for all E); K3 at the (1, 1) sharded solve's
                shape (Nl = N), whose launches the `kernels` line counts, and
                at one rank's half of a (1, 2) mesh (Nl = N / 2). Each is
                timed twice: by CUDA events around 50 calls enqueued from the
                host (`ms`), and as the slope of CUDA-graph replays of 24 and
                96 captured calls (`graph_ms`, gpmpc_tpu_torch/benchmarks/
                chain.py), which leaves the host's enqueue out; K1's f64
                instance also at B = 3,584 by graph slope; K1 and K3 f64
                also in each body, the scalar one (the f64 instance before
                the tensor-core body) and the tensor-core one, whatever the
                route. Bounds: f32 at the f32 peak; f64 the exp, scale and
                blam multiplies at the FP64 vector peak plus the
                multiply-adds at the FP64 tensor-core peak (they share the
                datapath).
                Before the
                times, each kernel's launch plan at the headline shape
                (variance_trace.rw_tied_plan, rw_sym_plan: rows, slices,
                scenarios a block, threads, shared bytes, grid, and the
                blocks an SM holds by cudaOccupancyMaxActiveBlocksPerMultiprocessor).
  3b. probes    P1 and P2, the probe kernel (csrc/variance_trace_probe.cu, K1's
                body under its variants, full_s1 among them: K1 with scenario
                sharing off; and plan_*: K1 at other block shapes). Each
                variant against its plain
                version on the JAX kernel test's inputs at the headline and
                a ragged shape, at the bars of ops/kernels/probe.checks
                (scalar variants rtol 5e-5 atol 5e-5; hwexp at those plus
                __expf's documented error; the tensor-core variants against
                their TF32-emulating plain versions at 2 N eps a pass of the
                terms' magnitude sum plus the operands' rounding slack, and
                red_3xtf32 and tc_p also at 5e-5 against the plain f64 full);
                `full` equal to K1 (`rw_tied`) to the bit on those inputs and
                on the headline operands. The f64 variants (the scalar
                body's stages at T = double and the tensor-core body's
                variants, probe.F64_VARIANTS) against their plain f64
                versions (1e-12 |rw| + 16 ulps of the magnitude sum), f64
                `full` and `mma` equal to K1 f64 in the scalar and the
                tensor-core body to the bit. Then both probes at the
                headline shape, and P1 again at f64
                (gpmpc_tpu_torch/benchmarks: kernel_ablate.run and
                kernel_probe.run), each
                with the counts set to 0 just before and read just after: the
                probe kernel launched, no other kernel, every variant within
                its bars on the probes' own inputs.
  3c. loop kernels  K1 and K2 at every shape and lane count the closed loop
                (phase 7) launches them at: B = 1 and the multistart's
                candidate count (4 starts plus the warm start, read from
                parallel.batch._multistart_starts), N = 128 (100 valid rows)
                and 512 (320 valid), (d, E) = (2, 1), (3, 2), (5, 4), on the
                JAX kernel test's inputs with the padded rows zeroed: each f32
                instance against its plain f64 version at that test's bars
                (forward and backward), both instances at phase 3's
                conditioned bars; K1 and K2 at their small-B plans (S <= B,
                the contraction split over a cluster where the grid is small)
                against the split sum's plain version, and K2 one launch a
                trace. Then the f64 instances at the loop's shapes
                (B = 1: the integrator's K1, the pendulum's and cartpole's
                K2; the pendulum's K2 at the multistart's count) timed by
                events and graph slope beside their plain versions and
                bounds, each with its plan (body; S, split, cluster, grid
                or S, grid; blocks an SM), K1 also in each body.
  3e. eigh     the small symmetric eigensolver of the full-covariance
                PSD clip (csrc/eigh_small.cu, ops/kernels/eigh_small.py: one
                thread a matrix, cyclic Jacobi) against its plain version
                (within 4 ulps of ||A||_F: the same IEEE operations in the
                same order) and torch.linalg.eigh (eigenvalues,
                ||V diag(w) V^T - A|| and ||V^T V - I|| within 16 d eps
                ||A||_F, eps of the dtype): random definite, indefinite,
                near-degenerate and diagonal matrices at d = 2, 3, 4, 5, 8
                in f32 and f64, and the pre-clip covariances the paths hand
                it (the headline's f32 rollout, B = 256; config 4's,
                B = 64; the swing-up controller's f64 route (b), B = 1).
                Timed at those three shapes and at (256, 4, 4), f32 and f64,
                by events and by graph slope, beside its plain version,
                torch.linalg.eigh (library_ms; the port never calls it) and
                its bound on these inputs (the rotations the plain version
                counts).
  4. objective  the port's f64 objective on the card (the f64 kernel
                instances) at the reference controls and at 0 against the
                JAX package's values in gpmpc_tpu_torch/data/headline_ref.npz,
                rtol 1e-8: through K1, and with the K4 opt-in on.
  5. solve      the plain path: solve_batch on the headline problem
                (B=256, H=20, f32, 40 iterations): finite costs, no lane
                worse than its start, and exactly H * (1 + iterations)
                launches of K1's f64 instance (the precision policy) and no
                other. Solves/s over fresh x0s, and the cost excess
                against the f64 reference controls. The same solve with the
                trace forced to K1's f32 instance in f32 (k1_f32, as
                benchmarks/recipe_quality.py's row), counted and scored the
                same way: the path whose launches the `kernels` line gives
                K1's f32 instance. Then the untied path
                (K2) on the same problem with per-output lengthscales, and a
                profiler pass (of a 4-iteration solve, as every profiler
                pass here but phase 5e's, of one value-and-grad, phase 5f's
                graphed one, of ITERS, and phase 7's, of one control step).
                Every solve here and below runs as its caller runs it, full
                covariance (5e, 7b, 8b) included, except the sharded
                value-and-grad (6), which runs eagerly: through the solver's
                kept program (mpc/solver.py), whose first call runs the
                first value-and-grad and iteration 1 eagerly and captures
                two CUDA graphs, the init and the step, and whose later
                calls with the same key replay them, capturing nothing; each
                replay counts the kernel launches that the graph's own
                kernel nodes hold (utils/replay_counts.py). The timed phases
                (5f, 5e, 5c, 7b, 8a, 8b) hold three executions of the loop
                against each other (loop_mode): 'eager', 'graphed' (each
                solve captures its program anew and drops it, the execution
                before programs were kept) and 'reused' (as callers run it),
                all equal to the bit; a phase starts with an empty program
                cache and fails unless its reused calls capture each key
                once (two graphs a program), and logs the bytes the cache
                holds.
  5f. graph     the lockstep loop eager, graphed and reused, the plain
                solve_batch at the headline (B=256, f32, K1 f64, 40
                iterations): each counted as phase 5, the three results
                equal to the bit (u, cost, iters, pg_norm, converged), each
                program's step and init graphs exactly H K1 f64 launches a
                replay; solves/s of the three over 3 fresh-x0 batches in
                turns, all equal to the bit, the reused calls capturing
                nothing; host launch calls and the device's busy share of
                the eager and the reused solve under the profiler (eager 4
                iterations, reused 40), and in each device trace exactly H
                K1 kernels a value-and-grad, the graphs' replays included.
  5c. recipe    the main path: the production recipe
                (solve_batch_multistart_retired with problems.RECIPE and
                REFINE, ret_prod_nopre) on the same problem, counted: finite
                costs, exactly H K1 launches (its f64 instance) a
                propagated-variance rollout of the recipe (counted by
                wrapping parallel.batch.rollout_batched) and no other kernel,
                each rollout at a lane count that phase 3 checked K1 at, its
                diag counters; its cost excess against the f64 reference
                controls beside the JAX recipe's bar (fails at p90 >= 1 %);
                quality-paired solves/s on a fresh-x0 batch, eager, graphed
                and reused in turns, the three equal to the bit (one batch:
                the eager recipe takes ~25 s); each key captured once over
                the reused calls.
  5e. full cov  solve_batch(full_cov=True) on the same problem (B=256, H=20,
                f32, 40 iterations), its PSD clip through the small
                eigensolver: eager, graphed and reused, each with finite
                costs, no lane worse than its start, exactly H * (1 +
                iterations) launches of K1's f64 instance and of the
                eigensolver and no other kernel, the three equal to the
                bit, each program's graphs exactly H K1 f64 and H
                eigensolver launches a replay; solves/s of the three on a
                fresh-x0 batch in turns, equal to the bit; the reused solve
                at 2 iterations under the profiler (busy share, host launch
                calls, H K1 kernels a value-and-grad in the device trace). Its f64 objective at
                the reference controls (all lanes) and its gradient (the
                reference file's eight grad_full_lanes) against JAX's
                rollout_batched(full_cov=True) values in headline_ref.npz,
                rtol 1e-8. No f64 reference solve exists for this
                objective, so no cost excess is recorded.
  5d. sym       phase 5 again with the K4 opt-in on: the headline solve
                with exactly H * (1 + iterations) K4 launches and no K1 one,
                scored, timed and profiled the same way, and the untied solve
                with one K4 launch a trace for all outputs.
  6. sharded    solve_batch_2d at the headline width: (a) a (1, 1) mesh on
                NCCL in this process: finite costs, none above its start,
                exactly H * (1 + iterations) K3 launches, solves/s, cost
                excess and a profiler pass; (b) a (1, 2) mesh on gloo, two processes on the same
                card started from here with a timeout: their f64 objective at
                the reference controls against headline_ref.npz (rtol 1e-8)
                and their gradient against this process's unsharded f64
                gradient (rtol 1e-10, atol 1e-10 of its largest entry, so it
                is not counted twice), both ranks equal to the bit, and
                exactly H K3 launches on each rank (one forward rollout).
  7. closed loop  the online learn-and-control loop, each part with the
                counts set to 0 just before it, every step's wall, K1 and K2
                launches logged, and every K1 / K2 call at a shape phase 3c
                checked: (a) experiments/integrator.py at f64, u* = [-1]*5
                within 5e-3; (b) tests/test_closed_loop.py's swing-up at f64
                on the stored JAX transitions (gpmpc_tpu_torch/data/
                closed_loop_ref.npz): train_gp(80) timed and its
                hyperparameters and iterations against JAX's (rtol 1e-8),
                one append-and-refit at N = 512 timed, 40 Simulator steps
                whose first five actions, states and costs match JAX's
                (atol 1e-6, 1e-6, rtol 1e-6) and whose tail meets the
                test's criteria (|theta| < 0.15, |theta_dot| < 0.5, actions
                in bounds, count 250 + steps); on the B = 1 route each step
                launches exactly H * (1 + iters) K2 (one launch a trace for
                all E outputs), the episode's one key captured once (its
                step p50 and captures logged); then 3 steps from the last
                state in each of eager, graphed and reused, in turns, each
                round equal to the bit and each graph's kernel nodes H K2
                launches a replay, the reused steps capturing nothing (the
                episode's program); then one step from the last state with
                full_cov=True on the same route in each mode, each
                launching H * (1 + iters) K2 and eigensolver launches, equal
                to the bit and each graph's kernel nodes H K2 and H
                eigensolver launches a replay; one step under
                the profiler, its device trace exactly H K2 kernels a
                value-and-grad; (c)
                pretrain_pendulum's delta mode in f32 (300 transitions,
                train_gp(150), multistart n_starts = 4, N = 512, H = 8) for
                10 steps; (d) pretrain_cartpole's delta mode, (d, E) =
                (5, 4), for 10 steps: finite costs, actions in bounds; (e)
                run_episode_on_device for 4 steps with tests/test_sim.py's
                assertions, its single-scenario L-BFGS solves through one
                kept program (one key, two captures). Each episode's
                captures are logged.
  3d. sparse kernels  K1 at the three shapes phase 8 launches it at:
                (B, N, d, E) = (256, 128, 5, 4) (suite config 3b),
                (64, 128, 3, 2) (config 4, full covariance) and (1, 512, 4, 2)
                (the uncertainty experiment, 400 valid rows), on the JAX
                kernel test's inputs with the padded rows zeroed, at phase
                3c's bars; the f64 instance timed at each by events and
                graph slope beside its plain version, bound and launch plan
                (S, shared bytes, grid, blocks an SM), and in each body.
  8. sparse     the sparse GP and the remaining modules, each part with
                the counts set to 0 just before it, every K1 launch at a
                shape phase 3d checked:
                (a) config 3b at full width (problems.
                make_sparse_cartpole_problem, B = 256, N = 1,000 through the
                FITC GP of M = 128, H = 10, f32): the f64 posterior (W,
                alpha) within 1e-8 of JAX's largest entry, the f64 objective
                at 0 and at the f64 reference controls (benchmarks/results/
                quality_sparse_ref_3b_sparse_cartpole.npz) within rtol 1e-8
                of JAX's (gpmpc_tpu_torch/data/sparse_ref.npz) and its
                gradient within 1e-8 of the largest entry; the plain
                solve_batch at 40 iterations, eager, graphed and reused,
                each with exactly H (1 + iters) K1 f64 launches and the
                three equal to the bit, its cost excess
                (fails at p90 >= 1 %) beside the JAX package's TPU figure
                (benchmarks/results/quality_sparse.json), solves/s over 3
                fresh-x0 batches in the three modes in turns; (b) config 4 (B = 64, H = 50, full
                covariance): on JAX's posterior carried across, the f64
                objective at 0 and u_ref within rtol 1e-8 of JAX's and the
                gradient within 1e-8 (at 0) and 1e-5 (at u_ref) of its
                largest entry; on the port's own fit, the posterior within
                1e-6, J within 1e-7, the gradient within 1e-6 and 1e-4
                (SPARSE_BARS); the f32 solve (its PSD clip through the
                eigensolver) at 5 iterations eager, graphed and reused, each
                counted (H (1 + iters) K1 f64 and eigensolver launches),
                equal to the bit; then at the suite's 40 iterations, counted
                the same way, its program's graphs H K1 f64 and H
                eigensolver launches a replay, timed in the three modes in
                turns, its cost excess recorded beside the JAX package's
                p50 (no gate); (c)
                the per-scenario routes in f64, solve_batch with Adam
                ('auto' -> 'vmap') on four headline lanes and solve_batch_gp
                over three stack_gps draws, against JAX's stored results,
                launching no kernel; (d) experiments/uncertainty.py at its
                published settings, both gammas against JAX's stored f64
                controls and means (atol 1e-4), exactly H (1 + iters) K1 f64
                launches each, walls; (e) hs071 by solve_constrained (x*, f*
                within 1e-5, violations below 1e-7), a checkpoint round
                trip of the uncertainty controller and its GP, and
                native.solve_box built into gpmpc_tpu_torch/_build/ on the
                integrator objective.
  9. output     the card line, one `kernels` JSON line and the result line.

Times, rates and bounds printed here are measured in this run on this card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = 'gpmpc_tpu_torch/ops/kernels/csrc/variance_trace_tied.cu'
SOURCE_F64 = 'gpmpc_tpu_torch/ops/kernels/csrc/variance_trace_tied_f64.cu'
SYM_SOURCE_F64 = 'gpmpc_tpu_torch/ops/kernels/csrc/variance_trace_sym_f64.cu'
PROBE_SOURCE = 'gpmpc_tpu_torch/ops/kernels/csrc/variance_trace_probe.cu'
TPU_FILE = 'gpmpc_tpu/ops/pallas/variance_trace.py'
CLOSED_LOOP_REF = os.path.join(ROOT, 'gpmpc_tpu_torch', 'data',
                               'closed_loop_ref.npz')

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 and
# float64 outside the tensor cores, float64 on the tensor cores (FP64 Tensor
# Core, IEEE double: the f64 mma.sync of csrc/rw_tied_f64_body.cuh), and
# HBM3 bandwidth. The f32 bounds count no tensor core: the precision policy
# admits no TF32. The FP64 tensor cores and the FP64 vector pipe do not run
# at once: benchmarks/dmma_rate.py measured 66 TFLOP/s of m16n8k4 alone, 32
# of DFMA alone, and 38 for the two in one loop, below the 49 that running
# them one after the other would give (one H100 80GB HBM3 at 700 W). So an
# f64 bound adds the two times.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_F64_TC_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP64 instructions (DFMA + DMUL + DADD) of the cheapest accurate double exp
# the kernels use, read from the SASS of one-line kernels built with the
# kernel libraries' flags for sm_90a (benchmarks/sass_fp64.py, cuobjdump
# -sass; CUDA 12.8 on the H100's machine): exp_fast of
# csrc/rw_tied_f64_body.cuh, the exp of K1's f64 tensor-core body (within 1
# ulp of exp for |x| < 707, every pair's -p/4 here): 8 DFMA, 1 DMUL and 2
# DADD, no branch; CUDA's exp (the other f64 kernels' accurate_exp,
# csrc/common.cuh) takes 15 on its ordinary path (14 DFMA and 1 DADD before
# its special-case branch, 17 in all). Each takes one FP64 issue slot, which
# the 34 TFLOP/s peak counts as the 2 flops of a DFMA, so an f64 bound counts
# the exp as 2 * EXP_F64_INSTR flops (the f32 bounds count expf as one): the
# same work, whichever exp a kernel runs. Phase 2 reads both counts again
# and this run's bounds use the smaller.
EXP_F64_INSTR = 11
# The JAX kernel's p50 relative error of t against f64 on the headline b_lam,
# on a TPU v5e (benchmarks/quality_retired.py:245-246).
JAX_TPU_T_REL_ERR_P50 = 7.8e-6
# The operand sets of the full-covariance rollout phase 3 checks K1 on: the
# traces of these steps of the f64 headline rollout at the reference
# controls, 256 lanes each.
FULL_COV_STEPS = (1, 5, 10, 19)

FWD_TOL = dict(rtol=5e-5, atol=5e-5)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
OBJ_RTOL = 1e-8
GRAD_RTOL = 1e-10
ITERS = 40
UNTIED_ITERS = 10
# Phase 5f: fresh-x0 batches each path (eager, graphed) is timed on, in
# turns; and the closed loop's control steps timed each way (phase 7b).
# Cut from 5, as RECIPE_REPS from 2, to make room for the graphed
# full-covariance phases within about 700 s on a slow host.
GRAPH_REPS = 3
# The three executions of the solver's loop that the timed phases hold
# together (loop_mode): eager, each solve captured anew, kept programs.
MODES = ('eager', 'graphed', 'reused')
# The profiled solves are cut to 4 iterations: the profiler's own
# processing takes ~1 s per 1,000 device kernels (~3,000 a value-and-grad),
# ~45 s at 10 iterations on a slow host.
PROFILE_ITERS = 4
# Traces a counted profile may take to get one that lost no device record.
PROFILE_TRACES = 4
WORKER_TIMEOUT_S = 600
PG_TIMEOUT_S = 300.0
# The lane counts at which the recipe (problems.RECIPE at B = 256) launches
# K1: 64, the polish chunks (polish_lanes); 128, the shift refinement's
# chunks (shift_lanes_per_chunk 64 x shift_top 2); 256, phase A and the
# scores at B; 1,024, phase 0 after prune_to = 4; 2,048, phase 0's first
# frozen round (n_starts 8 x B); 3,584, the exchange rounds' scoring of 1 +
# 4 shifts + 6 neighbours + 2 shifted neighbours + 1 smoothed = 14
# candidates a lane. Phase 3 holds K1 at each on the headline operands, and
# phase 5c fails if the recipe's rollouts run at any other.
RECIPE_WIDTHS = (64, 128, 256, 1024, 2048, 14 * 256)
# The recipe's quality gate: with every trace evaluated in f64 (the precision
# policy) seed 0 reads p90 ~0.1 % on the card, with K1's f32 arithmetic
# 1.77 % and the plain 40-iteration solve ~34 % (one H100 80GB HBM3 at 700 W,
# PERF.md); the JAX recipe's bar on a TPU v5e is 0.58 % (BENCH_r05.json). A
# return to f32 arithmetic in the trace, a broken gate or scatter fails
# here; the JAX bar itself is recorded beside it.
RECIPE_P90_MAX = 0.01
JAX_RECIPE_BAR = dict(p90=0.0058, lanes_above_1pct=17, max=0.033)
RECIPE_REPS = 1
# Phase 5e's depth: one timed batch, eager and graphed in turns (beside
# the two counted solves), and a
# profile pass of the graphed solve cut to 2 iterations (the first
# value-and-grad and iteration 1 eager, then one replay: ~20,000 device
# kernels each; the profiler took ~165 s to process 10 eager iterations).
FULL_COV_REPS = 1
FULL_COV_PROFILE_ITERS = 2
# The closed loop's kernel shapes (phase 3c checks K1 and K2 at each; phase
# 7 fails on a launch at any other): each capacity N with the valid rows it
# holds there (the integrator's 100 in 128; the pendulum's 250-310 and the
# cartpole's 300-310 in 512), the (d, E) of the integrator, the pendulum and
# the cartpole, and the lane counts of loop_lane_counts.
LOOP_CAPACITIES = ((128, 100), (512, 320))
LOOP_DIMS = ((2, 1), (3, 2), (5, 4))
# pretrain_pendulum's multistart: 4 starts plus the shifted last trajectory.
LOOP_N_STARTS = 4
SWING_STEPS = 40
# The swing-up's full-covariance control steps from the episode's last
# state (phase 7b), eager and graphed in turns, each this many times.
FULL_COV_LOOP_REPS = 1
PRETRAIN_STEPS = 10
DEVICE_EPISODE_STEPS = 4
# The swing-up against the stored JAX reference (closed_loop_ref.npz). The
# port on the CPU reads the trained hyperparameters within 4.9e-11 of JAX's
# (relative), the first five actions equal (all at the bound -5), the states
# within 4.8e-8 (the plants step in f32) and the costs within 1.5e-8
# relative; the bars leave the card's f64 linear algebra two decades more.
LOOP_HP_RTOL = 1e-8
LOOP_ACTION_ATOL = 1e-6
LOOP_STATE_ATOL = 1e-6
LOOP_COST_RTOL = 1e-6
# Each kernel's launch counter in ops/kernels/variance_trace.py; K1's are
# split by instance: LAUNCHES counts both, LAUNCHES_F64 the f64 ones.
COUNTER = {'K2': 'LAUNCHES_UNTIED', 'K3': 'LAUNCHES_BLOCK',
           'K4': 'LAUNCHES_SYM'}
# The small symmetric eigensolver (ops/kernels/eigh_small.py), the PSD
# clip of the full-covariance rollout; it replaces jnp.linalg.eigh (XLA's)
# at gpmpc_tpu/dynamics.py:312 (batched) and :164 (single scenario). Phase
# 3e checks it on random symmetric matrices of every EIGH_KIND at each of
# EIGH_DIMS, and on the operands of the paths at EIGH_PATH_SHAPES (B, d):
# the headline full-covariance solve's 256 lanes, config 4's 64 and the
# controller's route (b) at B = 1; it is timed there and at (256, 4), a
# ds = 4 full covariance, in f32 and f64.
EIGH_SOURCE = 'gpmpc_tpu_torch/ops/kernels/csrc/eigh_small.cu'
EIGH_REPLACES = 'gpmpc_tpu/dynamics.py:312'
EIGH_KINDS = ('definite', 'indefinite', 'near-degenerate', 'diagonal')
EIGH_DIMS = (2, 3, 4, 5, 8)
EIGH_PATH_SHAPES = ((256, 2), (64, 2), (1, 2))
EIGH_TIMED_SHAPES = EIGH_PATH_SHAPES + ((256, 4),)
# The eigensolver's bars, in units of eps (the dtype's) times d times
# ||A||_F (eigenvalues against torch.linalg.eigh's, the reconstruction),
# of eps times d (orthonormality), and of ulps of ||A||_F (kernel against
# its plain version: the same IEEE operations in the same order).
EIGH_BAR = 16
EIGH_PLAIN_ULPS = 4


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run, prefixed with the seconds since the start."""
    print(f'{time.perf_counter() - _T0:7.1f}s {msg}', flush=True)


def sync(dev) -> None:
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def reset_counts() -> None:
    from gpmpc_tpu_torch.ops.kernels import eigh_small, probe
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    for name in ('LAUNCHES', 'LAUNCHES_F64', *COUNTER.values()):
        setattr(vt, name, 0)
    probe.LAUNCHES_PROBE = 0
    eigh_small.LAUNCHES_EIGH = 0


def read_counts() -> dict:
    """Launches since reset_counts: K1's f32 and f64 instances, K2-K4, 'P'
    of the probe kernel and 'eigh' of the small eigensolver."""
    from gpmpc_tpu_torch.ops.kernels import eigh_small, probe
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    return {'K1 f32': vt.LAUNCHES - vt.LAUNCHES_F64,
            'K1 f64': vt.LAUNCHES_F64,
            **{k: getattr(vt, name) for k, name in COUNTER.items()},
            'P': probe.LAUNCHES_PROBE, 'eigh': eigh_small.LAUNCHES_EIGH}


@contextlib.contextmanager
def sym_opt_in():
    """The K4 opt-in of the JAX package, GPMPC_SYM_KERNEL=1, for a block."""
    os.environ['GPMPC_SYM_KERNEL'] = '1'
    try:
        yield
    finally:
        os.environ.pop('GPMPC_SYM_KERNEL', None)


@contextlib.contextmanager
def eager_loop():
    """Every lockstep solve in a block with its loop run eagerly, whatever
    its caller asks (mpc/solver.py's _run_graphed replaced by _run_eager):
    the execution of the port before the graphed loop, held against it."""
    from gpmpc_tpu_torch.mpc import solver
    graphed = solver._run_graphed
    solver._run_graphed = solver._run_eager
    try:
        yield
    finally:
        solver._run_graphed = graphed


@contextlib.contextmanager
def loop_mode(mode: str):
    """The execution of every lockstep solve in a block: 'eager'
    (eager_loop), 'graphed' (each solve captures its program anew and drops
    it, in a cache of its own: the execution before programs were kept) or
    'reused' (as callers run it: the program cache kept across calls)."""
    from gpmpc_tpu_torch.mpc import solver
    if mode == 'eager':
        with eager_loop():
            yield
        return
    if mode != 'graphed':
        yield
        return
    kept, run = solver._PROGRAMS, solver._run_graphed
    solver._PROGRAMS = type(kept)()

    def anew(p, u0):
        solver.clear_programs()
        return run(p, u0)

    solver._run_graphed = anew
    try:
        yield
    finally:
        solver.clear_programs()
        solver._PROGRAMS, solver._run_graphed = kept, run


def cache_note(tag, captures: int, capture_s: float) -> dict:
    """The program cache after a phase's 'reused' calls, which took
    `captures` captures in all: each key must have been captured once (each
    graph a program holds, its step and its init, and Adam's polish step,
    once);
    its programs and bytes, logged."""
    from gpmpc_tpu_torch.mpc import solver
    stats = solver.program_stats()
    graphs = sum(len(prog.graphs) for prog in solver._PROGRAMS.values())
    if captures != graphs:
        raise AssertionError(f'{tag}: the reused calls took {captures} '
                             f'captures for {stats["programs"]} programs of '
                             f'{graphs} graphs, expected one capture of '
                             'each program\'s graphs')
    log(f'[{tag}] reused: {stats["programs"]} programs, each key captured '
        f'once ok ({captures} graphs, {capture_s:.3f} s of capture); the '
        f'cache holds {stats["bytes"]} bytes ({stats["pool_bytes"]} in '
        'graph pools)')
    return dict(stats, captures=captures, capture_s=capture_s)


def reused_captures(r) -> tuple:
    """The captures and capture seconds of time_solves' 'reused' calls (r:
    its 'reused' entry)."""
    return sum(r['captures']), float(sum(r['capture_s']))


def counted_modes(tag, desc, solve, x0s, key, horizon, cost0, want,
                  also=()):
    """One counted solve (solve_checked) in each of MODES, the program
    cache emptied first: the three equal to the bit; 'graphed' and 'reused'
    each capture two graphs (step and init) whose kernel nodes hold `want`
    launches a replay, 'eager' none. Returns ({mode: result}, launches,
    loop iterations, {mode: capture_note})."""
    from gpmpc_tpu_torch.mpc import solver
    solver.clear_programs()
    res, notes = {}, {}
    for mode in MODES:
        with loop_mode(mode), capture_walls() as walls:
            t0 = time.perf_counter()
            res[mode], launches, iters = solve_checked(
                f'{tag} {mode}', desc, solve, x0s, key, 1, horizon, cost0,
                also=also)
            notes[mode] = capture_note(walls, time.perf_counter() - t0)
    for mode in MODES[1:]:
        same_bits(f'{tag} {MODES[0]} vs {mode}', res[MODES[0]], res[mode])
    graphs = {m: n['replay_launches'] for m, n in notes.items()}
    if graphs != {'eager': [], 'graphed': [want] * 2, 'reused': [want] * 2}:
        raise AssertionError(f'{tag}: the graphs hold {graphs} kernel '
                             f'launches a replay, expected two of {want} '
                             'graphed and reused, none eager')
    log(f'[{tag}] eager, graphed and reused equal to the bit (u, cost, '
        f'iters, pg_norm, converged) ok; each program\'s step and init '
        f'graphs hold {want} launches a replay ok; capture '
        f'{1e3 * notes["reused"]["capture_s"]:.1f} ms '
        f'({100 * notes["reused"]["capture_share"]:.1f} % of the first '
        'reused solve)')
    return res, launches, iters, notes


@contextlib.contextmanager
def capture_walls():
    """Each CUDA-graph capture the solver takes in a block (mpc/solver.py's
    _capture: recording a program's step or init, reading its kernel nodes
    and instantiating the graph): yields the list of (host seconds, kernel
    launches a replay by the graph's nodes) they go to."""
    from gpmpc_tpu_torch.mpc import solver
    capture, walls = solver._capture, []

    def timed(record, s, pool=None):
        t0 = time.perf_counter()
        graph, counts = capture(record, s, pool)
        walls.append((time.perf_counter() - t0, counts.launches))
        return graph, counts

    solver._capture = timed
    try:
        yield walls
    finally:
        solver._capture = capture


def capture_note(walls, wall) -> dict:
    """The captures of a graphed run of `wall` seconds (capture_walls):
    their count, total and median seconds and share of the wall, and each
    graph's kernel launches a replay, for the log and the json."""
    secs = [w for w, _ in walls]
    total = float(sum(secs))
    return dict(captures=len(walls), capture_s=total,
                capture_median_s=float(np.median(secs)) if walls else 0.0,
                capture_share=total / wall,
                replay_launches=[n for _, n in walls])


def _bits(t):
    """A tensor's bits: floats viewed as integers of their width."""
    import torch
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}.get(t.dtype, t.dtype))


def same_bits(tag, res_a, res_b) -> None:
    """Raises unless two SolveResults are equal to the bit in u, cost,
    iters, pg_norm and converged (None on both for Adam)."""
    import torch
    for k in ('u', 'cost', 'iters', 'pg_norm', 'converged'):
        a, b = getattr(res_a, k), getattr(res_b, k)
        if a is None and b is None:
            continue
        if a is None or b is None or not (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(_bits(a), _bits(b))):
            raise AssertionError(f'{tag}: eager and graphed {k} differ '
                                 f'(max abs diff '
                                 f'{float((a.double() - b.double()).abs().max())})')


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fns: dict, dev) -> dict:
    """Device milliseconds per call of each zero-arg fn, as the slope of
    CUDA-graph replays of 24 and 96 captured calls (benchmarks/chain.py's
    kernel-only mode)."""
    from gpmpc_tpu_torch.benchmarks.chain import kernel_slopes
    res = kernel_slopes(fns, dev)['results']
    return {key: r['us'] / 1e3 for key, r in res.items()}


def assert_close(name, got, want, rtol, atol) -> float:
    """Max abs error; raises AssertionError past rtol/atol."""
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(got - want)))


def _bound(flops, elems, f64=False, tc_flops=0):
    """(ms, what bounds it): the larger of the operations over the card's
    peaks for their type (f32: all of `flops` at the f32 peak; f64: `flops`
    on the FP64 vector pipe plus `tc_flops` on the FP64 tensor cores, which
    share it) and the bytes (elems of 8 or 4 bytes) over its memory rate."""
    t_ops = (flops / (PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
             + tc_flops / PEAK_F64_TC_FLOPS)
    t_bytes = elems * (8 if f64 else 4) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def exp_flops(f64: bool) -> int:
    """The flops a bound counts for one exp: expf as one; the double exp as
    the FP64 instructions of the cheapest accurate one at 2 flops each
    (EXP_F64_INSTR)."""
    return 2 * EXP_F64_INSTR if f64 else 1


def bound_ms(b, n_out, n_c, d, e, chains, f64=False):
    """Least time for the rw function (K1, K2, K3) on this card: the largest
    of its operations over the peak for their type and its bytes (each
    input read once, each output written once) over the memory rate. Per
    (i, j) pair and exp chain: d multiply-adds and one scale for the
    exponent, one exp (exp_flops), and per output one blam multiply and
    (1 + d) multiply-adds. In f32 all of them at the f32 peak; in f64 the
    scale, the exp and the blam multiplies on the vector pipe
    (PEAK_F64_FLOPS) and the multiply-adds, products of small matrices, on
    the FP64 tensor cores (PEAK_F64_TC_FLOPS), the two times added (they
    share the FP64 datapath): the same work whatever implements it."""
    w1 = d + 1
    e_per_chain = e // chains
    pairs = b * n_out * n_c * chains
    elems = (b * n_out * (d + 1) * chains + b * n_c * (d + w1) * chains
             + e * n_c * n_out + b * e * n_out * w1)
    if not f64:
        return _bound(pairs * (2 * d + 1 + exp_flops(False)
                               + e_per_chain * (1 + 2 * w1)), elems)
    return _bound(pairs * (1 + exp_flops(True) + e_per_chain), elems, True,
                  tc_flops=pairs * (2 * d + e_per_chain * 2 * w1))


def sym_bound_ms(b, n, d, e, chains, f64=False):
    """K4's least time: the exponent (d multiply-adds, a scale, one exp as
    exp_flops counts it) and per output one blam multiply on each of the
    n (n + 1) / 2 unordered pairs (W and blam are symmetric), and per
    output the (1 + d) multiply-adds of each of the n^2 ordered pairs; in
    f64 the multiply-adds at the FP64 tensor-core peak and the rest at the
    vector pipe's, added, as bound_ms. Bytes: z and dv per chain, ao, blam
    and rw, each once."""
    w1 = d + 1
    e_pc = e // chains
    pairs = n * (n + 1) // 2
    elems = (b * n * (d + 1) * chains + b * n * w1 + e * n * n
             + b * e * n * w1)
    if not f64:
        return _bound(b * chains * (pairs * (2 * d + 1 + exp_flops(False)
                                             + e_pc)
                                    + n * n * e_pc * 2 * w1), elems)
    return _bound(b * chains * pairs * (1 + exp_flops(True) + e_pc), elems,
                  True, tc_flops=b * chains * (pairs * 2 * d
                                               + n * n * e_pc * 2 * w1))


def instr_bound_ms(b, n, d, e, props, clock_mhz):
    """Instruction-rate estimate from the card's own SM count and clock:
    d FMAs + 1 scale + ~8 for the accurate expf + E * (1 + (1+d)) per pair,
    at 128 f32 lanes per SM per cycle."""
    instr = b * n * n * (d + 1 + 8 + e * (1 + d + 1))
    return 1e3 * instr / (props.multi_processor_count * 128 * clock_mhz * 1e6)


def as64(v, dev):
    import torch
    return torch.tensor(v, dtype=torch.float64, device=dev)


def kernel_test_inputs(rng, b, n, d, e, tied, dev):
    """Inputs drawn as the JAX kernel test draws them (tests/test_batched.py,
    TestTiedStreamedKernel._problem): normal u and x, M2 = 0.1 m m^T + I, a
    random symmetric blam of scale 0.003, a normal cotangent; f64 on `dev`."""
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, d, d) if tied else (b, e, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n, d))
    br = rng.normal(size=(e, n, n)) * 0.003
    ct = rng.normal(size=(b, e))
    return tuple(as64(v, dev) for v in (u, m2, x, br + np.swapaxes(br, -1, -2),
                                        ct))


def trace_fns(tied, native=True):
    """(trace, its plain version). native=True evaluates the trace in its
    operands' dtype, so f32 operands run a kernel's f32 instance; False
    takes the precision policy (the f64 instance, t rounded)."""
    import functools
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    if tied:
        return (functools.partial(vt.variance_trace_batched_tied,
                                  native=native),
                vt.variance_trace_batched_tied_reference)
    return (functools.partial(vt.variance_trace_batched, native=native),
            vt.variance_trace_batched_reference)


def block_fn(n_m, native=True):
    """The tied trace as K3's partials over n_m row blocks, summed: the
    model-sharded path's arithmetic on one device. Under the policy
    (native=False) u and M2 enter the blocks in f64 and only the sum of the
    f64 partials is rounded, as parallel/model_sharded.py does it."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt

    def fn(u, m2, x, blam):
        n_loc = x.shape[0] // n_m
        dt = u.dtype if native else vt.TRACE_DTYPE
        u_w, m2_w = u.to(dt), m2.to(dt)
        return sum(vt.variance_trace_tied_block(
            u_w, m2_w, x, x[k:k + n_loc], blam[:, k:k + n_loc].transpose(1, 2),
            native=native) for k in range(0, x.shape[0], n_loc)).to(u.dtype)
    return fn


def sym_fn(tied, native=True):
    """The trace with the K4 opt-in on (the backward needs no opt-in)."""
    base = trace_fns(tied, native)[0]

    def fn(*args):
        with sym_opt_in():
            return base(*args)
    return fn


def check_trace(name, fn, ref, u, m2, x, blam, ct, also=None):
    """The f32 `fn` (a kernel, on CUDA) against the plain `ref` in f64: value
    and the analytic (du, dm2) against autograd of the plain version; and
    against `also` in f32 (another kernel on the same inputs) at the same
    bars. Returns the max abs forward error against the plain version."""
    import torch

    def run(f, dtype):
        uu = u.to(dtype).requires_grad_()
        mm = m2.to(dtype).requires_grad_()
        out = f(uu, mm, x.to(dtype), blam.to(dtype))
        return (out, *torch.autograd.grad(torch.sum(out * ct.to(dtype)),
                                          (uu, mm)))

    k_out, k_du, k_dm2 = run(fn, torch.float32)
    wants = [('plain f64', run(ref, torch.float64))]
    if also is not None:
        wants.append(('other kernel f32', run(also, torch.float32)))
    err = None
    for what, (r_out, r_du, r_dm2) in wants:
        e = assert_close(f'{name} forward vs {what}', k_out, r_out, **FWD_TOL)
        assert_close(f'{name} du vs {what}', k_du, r_du, **BWD_TOL)
        assert_close(f'{name} dm2 vs {what}', k_dm2, r_dm2, **BWD_TOL)
        err = e if err is None else err
    return err


def check_conditioned(name, fn, ref, u, m2, x, blam, dtype, rtol):
    """`fn` in `dtype` against the plain `ref` in f64 on the headline
    operands. On the headline b_lam the trace cancels: the magnitudes of its
    terms, mag = sum_ij |blam_ij| w_ij dv_i dv_j, reach 1e3-1e6 times the
    result, so no evaluation in `dtype` (the plain version's included) meets
    a plain rtol everywhere. The bar adds 16 ulps of mag, the forward-error
    bound of a sum whose terms each carry a few ulps:
    |k - r64| <= rtol |r64| + 16 eps mag. Returns the max abs errors of the
    kernel and of the plain version in `dtype`, both against f64, the
    kernel's largest |k - r64| / mag and its p50 |k - r64| / |r64|."""
    import torch
    cast = lambda t: t.to(dtype)
    r64 = ref(u, m2, x, blam)
    mag = ref(u, m2, x, blam.abs())
    k = fn(cast(u), cast(m2), cast(x), cast(blam)).double()
    p = ref(cast(u), cast(m2), cast(x), cast(blam)).double()
    err = (k - r64).abs()
    eps = torch.finfo(dtype).eps
    bound = rtol * r64.abs() + 16 * eps * mag
    if not bool((err <= bound).all()):
        raise AssertionError(f'{name}: |k - r64| exceeds {rtol} |r64| + 16 eps '
                             f'mag by up to {float((err / bound).max()):.3f}x')
    return (float(err.max()), float((p - r64).abs().max()),
            float((err / mag).max()), float((err / r64.abs()).median()))


def check_policy(name, fn, ref, u, m2, x, blam):
    """The trace under the precision policy from f32 operands against the
    plain f64 trace of the same operands: t is f32 and within one f32 ulp of
    |r64| plus 16 f64 ulps of the terms' magnitude sum (the f64 instance's
    own sum). Returns the max abs error and the largest err / bar."""
    import torch
    ops = [t.to(torch.float32) for t in (u, m2, x, blam)]
    r64 = ref(*(t.double() for t in ops))
    mag = ref(*(t.double() for t in ops[:3]), ops[3].double().abs())
    t = fn(*ops)
    if t.dtype != torch.float32:
        raise AssertionError(f'{name}: policy trace of f32 operands is {t.dtype}')
    err = (t.double() - r64).abs()
    bar = (torch.finfo(torch.float32).eps * r64.abs()
           + 16 * torch.finfo(torch.float64).eps * mag)
    ratio = float((err / bar).max())
    if not ratio <= 1.0:
        raise AssertionError(f'{name}: policy trace off the f64 trace by '
                             f'{ratio:.3f}x its bar')
    return float(err.max()), ratio


def check_kernel(key, fn, ref, tied, dev, b, n_ragged, cache, rng, also=None):
    """One kernel's checks at the headline and a ragged shape on the JAX
    kernel test's inputs, then on the headline operands in f32 and f64.
    Returns the f32 instance's max abs forward error at the JAX test's bar,
    the f64 instance's on the headline operands, and the f32 instance's p50
    relative error of t there."""
    import torch
    from gpmpc_tpu_torch.problems import headline_operands
    n, d = cache.x.shape
    e = cache.b_lam.shape[0]
    err = check_trace(f'{key} headline shape', fn, ref,
                      *kernel_test_inputs(rng, b, n, d, e, tied, dev), also=also)
    err_r = check_trace(f'{key} ragged B=7 N={n_ragged}', fn, ref,
                        *kernel_test_inputs(rng, 7, n_ragged, d, e, tied, dev),
                        also=also)
    log(f'[kernels] {key} f32 vs plain f64{" and vs the column sweep" if also else ""}'
        f', B={b} N={n} and B=7 N={n_ragged}: max abs err {err:.3e} / '
        f'{err_r:.3e} (fwd rtol 5e-5 atol 5e-5, bwd rtol 2e-3 atol 2e-4) ok')
    # The f64 instance serves every solver path (the precision policy) and
    # the reference objective.
    p50, k_err = {}, {}
    for dtype, rtol in ((torch.float32, 5e-5), (torch.float64, 1e-12)):
        k_err[dtype], p_max, k_mag, p50[dtype] = check_conditioned(
            f'{key} headline operands {dtype}', fn, ref,
            *headline_operands(rng, b, cache, tied), dtype, rtol)
        log(f'[kernels] {key} in {dtype} on the headline x and b_lam vs '
            f'plain f64: max abs err {k_err[dtype]:.3e} (at most '
            f'{k_mag:.3e} of the terms\' magnitude sum; the plain version in '
            f'{dtype}: {p_max:.3e}); p50 |t - t64| / |t64| '
            f'{p50[dtype]:.3e}; bar {rtol} |t| + 16 eps mag ok')
    return max(err, err_r), k_err[torch.float64], p50[torch.float32]


def check_k1_wide(cache, rng, b):
    """K1's f32 and f64 instances at one of the recipe's lane counts
    (RECIPE_WIDTHS) on the headline operands, against the plain f64 version
    at the bar of check_conditioned (rtol 5e-5 in f32, 1e-12 in f64: the
    recipe's launches at these widths run the f64 instance)."""
    import torch
    from gpmpc_tpu_torch.problems import headline_operands
    k1, k1_ref = trace_fns(True)
    ops = headline_operands(rng, b, cache, True)
    out = {}
    for dtype, rtol in ((torch.float32, 5e-5), (torch.float64, 1e-12)):
        k_max, p_max, k_mag, _ = check_conditioned(
            f'K1 B={b} headline operands {dtype}', k1, k1_ref, *ops, dtype,
            rtol)
        log(f'[kernels] K1 in {dtype} at B={b} on the headline x and b_lam '
            f'vs plain f64: max abs err {k_max:.3e} (at most {k_mag:.3e} of '
            f'the terms\' magnitude sum; the plain version in {dtype}: '
            f'{p_max:.3e}); bar {rtol} |t| + 16 eps mag ok')
        out[_DT_NAME[str(dtype)]] = k_max
    return out


def full_cov_operands(dev, steps=FULL_COV_STEPS):
    """(u, M2, x, b_lam), f64, of the tied traces of the full-covariance
    rollout: the f64 headline problem (B = 256) rolled out at the reference
    controls with full_cov=True, each trace's operands captured at `steps`
    and stacked (B = 256 len(steps)). M2 = (Lambda/2 + S)^{-1} of a joint
    covariance S with its cross-output terms: non-diagonal and SPD."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout_batched
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from gpmpc_tpu_torch.problems import REF_FILE, make_headline_problem
    p = make_headline_problem(b=256, dtype=torch.float64, device=dev)
    cache = build_rollout_cache(p.gp, 2, 1)
    orig, seen = vt.variance_trace_batched_tied, []

    def capture(u, m2, x, blam, **kw):
        seen.append((u, m2))
        return orig(u, m2, x, blam, **kw)

    vt.variance_trace_batched_tied = capture
    try:
        with torch.no_grad():
            rollout_batched(cache, p.x0s, as64(np.load(REF_FILE)['u_ref'], dev),
                            full_cov=True)
    finally:
        vt.variance_trace_batched_tied = orig
    u = torch.cat([seen[s][0] for s in steps])
    m2 = torch.cat([seen[s][1] for s in steps])
    off = float(m2[:, 0, 1].abs().max())
    if not off > 0 or not bool((torch.linalg.eigvalsh(m2) > 0).all()):
        raise AssertionError('full-covariance M2: not non-diagonal SPD')
    return u, m2, cache.x, cache.b_lam


def sym_inputs(kind, n, d, dtype, seed):
    """(n, d, d) symmetric matrices of a kind, numpy, rounded to dtype:
    'definite' (m m^T / d + I / 10), 'indefinite' (N(0, 1) symmetrised),
    'near-degenerate' (Q diag(w) Q^T, the eigenvalues in pairs 1e-7 apart,
    relative) or 'diagonal'."""
    import torch
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, d, d))
    if kind == 'definite':
        a = m @ np.swapaxes(m, -1, -2) / d + 0.1 * np.eye(d)
    elif kind == 'indefinite':
        a = (m + np.swapaxes(m, -1, -2)) / 2
    elif kind == 'near-degenerate':
        q = np.linalg.qr(m)[0]
        w = np.repeat(rng.uniform(0.5, 2.0, (n, (d + 1) // 2)), 2,
                      axis=1)[:, :d] * (1 + 1e-7 * np.arange(d))
        a = q @ (w[..., None] * np.swapaxes(q, -1, -2))
        a = (a + np.swapaxes(a, -1, -2)) / 2
    elif kind == 'diagonal':
        a = np.zeros((n, d, d))
        a[:, np.arange(d), np.arange(d)] = rng.normal(size=(n, d))
    else:
        raise ValueError(f'unknown kind {kind!r}')
    return a.astype(np.float32 if dtype == torch.float32 else np.float64)


def check_eigh(tag, a, w, v, wp, vp) -> dict:
    """The eigensolver's bars on (..., d, d) matrices a: the kernel's (w, v)
    against its plain version's (wp, vp) within EIGH_PLAIN_ULPS ulps of
    ||A||_F (w) and of 1 (v); its eigenvalues within EIGH_BAR d eps ||A||_F
    of torch.linalg.eigh's, ||V diag(w) V^T - A||_F within EIGH_BAR d eps
    ||A||_F and ||V^T V - I||_F within EIGH_BAR d eps (eps of a's dtype;
    the norms taken in f64). Raises past a bar; returns each error in its
    unit and the largest absolute difference from the plain version."""
    import torch
    d = a.shape[-1]
    eps = torch.finfo(a.dtype).eps
    a64 = a.double().reshape(-1, d, d)
    w64, v64 = w.double().reshape(-1, d), v.double().reshape(-1, d, d)
    fro = torch.linalg.matrix_norm(a64)                         # (n,)
    ulp_a = torch.tensor(np.spacing(fro.cpu().numpy().astype(
        np.float32 if a.dtype == torch.float32 else np.float64)),
        dtype=torch.float64, device=a.device)
    dw = (w64 - wp.double().reshape(-1, d)).abs().amax(-1)
    dv = (v64 - vp.double().reshape(-1, d, d)).abs().amax((-1, -2))
    wl = torch.linalg.eigvalsh(a.reshape(-1, d, d)).double()
    rec = torch.linalg.matrix_norm(
        v64 @ (w64[..., None] * v64.transpose(-1, -2)) - a64)
    orth = torch.linalg.matrix_norm(v64.transpose(-1, -2) @ v64
                                    - torch.eye(d, dtype=torch.float64,
                                                device=a.device))
    scale = d * eps * fro
    out = dict(
        plain_ulps=float(torch.maximum(dw / ulp_a, dv / eps).max()),
        max_abs_err=float(torch.maximum(dw, dv).max()),
        eig_vs_library=float(((w64 - wl).abs().amax(-1) / scale).max()),
        reconstruction=float((rec / scale).max()),
        orthonormality=float((orth / (d * eps)).max()))
    bars = dict(plain_ulps=EIGH_PLAIN_ULPS, eig_vs_library=EIGH_BAR,
                reconstruction=EIGH_BAR, orthonormality=EIGH_BAR)
    for k, bar in bars.items():
        if not out[k] <= bar:
            raise AssertionError(f'eigh {tag}: {k} {out[k]:.3g} past its '
                                 f'bar {bar} ({out})')
    return out


def phase_kernels(dev, b, n_ragged, cache):
    """Phase 3: each kernel against its plain version, then the precision
    policy on every path, then K1 on the full-covariance rollout's M2.
    Returns ({kernel: (max abs forward error of its f32 instance at the JAX
    test's bar, of its f64 instance on the headline operands)}, a summary of
    the policy and full-covariance checks)."""
    import torch
    from gpmpc_tpu_torch.problems import headline_operands
    rng = np.random.default_rng(0)
    out = {}      # {kernel: (f32 instance's max abs err, f64 instance's)}
    *out['K1'], k1_p50 = check_kernel('K1', *trace_fns(True), True, dev, b,
                                      n_ragged, cache, rng)
    log(f'[kernels] K1 in f32 on the headline operands at B={b}: p50 '
        f'relative error of t vs f64 {k1_p50:.3e} (the JAX kernel on a TPU '
        f'v5e: {JAX_TPU_T_REL_ERR_P50:.1e}, benchmarks/quality_retired.py)')
    out['K2'] = check_kernel('K2', *trace_fns(False), False, dev, b,
                             n_ragged, cache, rng)[:2]
    for width in RECIPE_WIDTHS:
        check_k1_wide(cache, rng, width)
    k1, k1_ref = trace_fns(True)
    k3 = [check_kernel(f'K3 summed over n_m={n_m} row blocks', block_fn(n_m),
                       k1_ref, True, dev, b, n_ragged, cache, rng, also=k1)
          for n_m in (1, 2, 4)]
    out['K3'] = [max(r[i] for r in k3) for i in (0, 1)]
    for tied, key in ((True, 'K4 tied'), (False, 'K4 per-output')):
        base, ref = trace_fns(tied)
        out[key] = check_kernel(key, sym_fn(tied), ref, tied, dev, b,
                                n_ragged, cache, rng, also=base)[:2]
    policy = {}
    for key, fn, tied in (
            ('K1', trace_fns(True, native=False)[0], True),
            ('K2', trace_fns(False, native=False)[0], False),
            ('K3 n_m=2', block_fn(2, native=False), True),
            ('K4 tied', sym_fn(True, native=False), True),
            ('K4 per-output', sym_fn(False, native=False), False)):
        policy[key] = check_policy(f'{key} policy', fn, trace_fns(tied)[1],
                                   *headline_operands(rng, b, cache, tied))
        log(f'[kernels] precision policy, {key} from f32 operands (the f64 '
            f'instance, t rounded) vs plain f64 on the headline operands: '
            f'max abs err {policy[key][0]:.3e}, at most {policy[key][1]:.3f} '
            'of its bar (1 f32 ulp of |t| + 16 f64 ulps of the magnitude '
            'sum) ok')
    fc = full_cov_operands(dev)
    full = {}
    for dtype, rtol in ((torch.float32, 5e-5), (torch.float64, 1e-12)):
        k_max, p_max, k_mag, k_p50 = check_conditioned(
            f'K1 full-covariance M2 {dtype}', k1, k1_ref, *fc, dtype, rtol)
        full[str(dtype)] = dict(max_abs_err=k_max, plain_max_abs_err=p_max,
                                p50_rel_err=k_p50)
        log(f'[kernels] K1 in {dtype} on the full-covariance rollout\'s M2 '
            f'(B={fc[0].shape[0]}, steps {FULL_COV_STEPS}, max |M2_01| '
            f'{float(fc[1][:, 0, 1].abs().max()):.3e}) vs plain f64: max abs '
            f'err {k_max:.3e} (the plain version in {dtype}: {p_max:.3e}), '
            f'at most {k_mag:.3e} of the magnitude sum, p50 rel err '
            f'{k_p50:.3e}; bar {rtol} |t| + 16 eps mag ok')
    full['policy'] = check_policy('K1 policy, full-covariance M2',
                                  trace_fns(True, native=False)[0], k1_ref,
                                  *fc)
    log(f'[kernels] precision policy, K1 on the full-covariance M2: max abs '
        f'err {full["policy"][0]:.3e}, at most {full["policy"][1]:.3f} of '
        'its bar ok')
    return out, dict(k1_f32_p50_rel_err=k1_p50, policy=policy, full_cov=full)


def rw_plan(key, b, n_out, n_c, d, e, dtype, dev) -> dict:
    """The launch plan of kernel `key` (K2: untied, one launch for all E) on
    this card, with the blocks an SM holds at its S: a tied launch's in the
    body its route takes (`rw_tied_body`: 'mma', the f64 tensor-core body
    at rw_tied_mma_plan, or 'scalar', K1's scalar body at rw_tied_plan)."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    sms = vt.device_sms(dev)
    untied = key.startswith('K2')
    body = 'scalar' if untied else vt.rw_tied_body(b, n_out, n_c, d, e,
                                                   dtype, sms)
    if body == 'mma':
        plan = vt.rw_tied_mma_plan(b, n_out, d, e)._asdict()
        plan['blocks_per_sm'] = vt.rw_tied_mma_blocks_per_sm(
            d, e, plan['scenarios'])
        return dict(body=body, **plan)
    plan = (vt.rw_untied_plan(b, n_c, d, e, dtype, sms) if untied
            else vt.rw_tied_plan(b, n_out, n_c, d, e, dtype, sms))._asdict()
    plan['blocks_per_sm'] = vt.rw_tied_blocks_per_sm(
        d, e, dtype, untied, plan['scenarios'], plan['split'])
    return dict(body=body, **plan)


def phase_sass() -> dict:
    """Phase 2's count of the double exp's FP64 instructions from SASS
    (benchmarks/sass_fp64.py); the f64 bounds of this run use it."""
    global EXP_F64_INSTR
    from gpmpc_tpu_torch.benchmarks import sass_fp64
    from gpmpc_tpu_torch.ops.kernels import _build
    res = sass_fp64.run(_build.BUILD_DIR / 'sass_fp64')
    exp, fast = res['exp_f64'], res['exp_fast_f64']
    log(f'[build] CUDA double exp in SASS (sm_90a, the libraries\' flags): '
        f'{exp["arith"]} FP64 instructions (DFMA {exp["DFMA"]}, DMUL '
        f'{exp["DMUL"]}, DADD {exp["DADD"]}; {exp["arith_before_first_branch"]}'
        f' on the ordinary path, before the special-case branch; other FP64 '
        f'{exp["other_fp64"]}); the same exp inlined {res["exp_copies"]} '
        f'times in {res["kernels_with_exp"]} of the f64 library\'s '
        f'{res["kernels"]} kernels; exp_fast (K1\'s tensor-core body) '
        f'{fast["arith"]} (DFMA {fast["DFMA"]}, DMUL {fast["DMUL"]}, DADD '
        f'{fast["DADD"]}, {fast["arith_before_first_branch"]} before a branch)'
        f'; EXP_F64_INSTR is {EXP_F64_INSTR}')
    cheapest = min(exp['arith_before_first_branch'], fast['arith'])
    for kname, ops in res['mma_kernels'].items():
        log(f'[build] tensor-core body {kname}: static SASS counts {ops}')
    if cheapest != EXP_F64_INSTR:
        log(f'[build] this toolkit\'s cheapest accurate exp takes {cheapest} '
            f'FP64 instructions, not EXP_F64_INSTR = {EXP_F64_INSTR}: this '
            'run\'s bounds use that')
        EXP_F64_INSTR = cheapest
    return res


BODIES = ('scalar', 'mma')


def body_fns(name, args) -> dict:
    """A tied f64 launch on `args` in each body, whatever its route (the
    scalar body is the f64 instance before the tensor-core body): the
    evidence for the route. Keys '<name> scalar', '<name> mma'."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    return {f'{name} {bd}': (lambda a=args, bd=bd: vt._launch(*a, body=bd))
            for bd in BODIES}


def bodies_note(r) -> str:
    """' (<route> body, scalar body <ms>, mma body <ms>)' of a timing row of
    K1's body (its plan names the body; the times where it has them)."""
    if 'body' not in r['plan']:
        return ''
    return f' ({r["plan"]["body"]} body' + ''.join(
        f', {bd} body {r[f"graph_ms_{bd}"]:.4f}' for bd in BODIES
        if f'graph_ms_{bd}' in r) + ')'


def phase_res_usage() -> dict:
    """Phase 2's registers and local memory (spills) of K1's f64 instances
    at the headline's (d, E), read from the built libraries
    (benchmarks/res_usage.py)."""
    from gpmpc_tpu_torch.benchmarks import res_usage
    res = res_usage.run()
    for name, u in res['summary'].items():
        log(f'[build] {name}: {u.get("REG")} registers, stack '
            f'{u.get("STACK")} B, local {u.get("LOCAL")} B a thread')
    return res['summary']


def launch_plans(b, n, d, e, dtype, dev) -> dict:
    """Each kernel's launch plan at the headline shape in `dtype`, with the
    blocks an SM holds (CUDA occupancy), logged and returned."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    plans = {key: rw_plan(key, b, n_out, n, d, e, dtype, dev)
             for key, n_out in (('K1', n), ('K2', n), ('K3', n),
                                ('K3 Nl=N/2', n // 2))}
    for key, tied in (('K4 tied', True), ('K4 per-output', False)):
        plan = vt.rw_sym_plan(b, n, d, e, dtype, tied)._asdict()
        plan['blocks_per_sm'] = vt.rw_sym_blocks_per_sm(d, e, dtype, tied)
        plans[key] = plan
    for key, plan in plans.items():
        log(f'[kernels] plan {key} {dtype}: ' + ', '.join(
            f'{k} {v}' for k, v in plan.items()))
    return plans


def time_kernels(dev, b, cache, reps, dtype):
    """Phase 3, timing at the headline shape: each wrapper (the kernel's
    instance for `dtype`) beside its plain PyTorch version on the same
    inputs, and its bound for `dtype`. K3 at n_m = 1 (all N rows, the (1, 1)
    sharded solve's launches) and, as 'K3 Nl=N/2', at n_m = 2 (one rank's
    half of the rows against all N)."""
    import torch
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from gpmpc_tpu_torch.problems import headline_operands
    rng = np.random.default_rng(1)
    e, n, d = cache.b_lam.shape[0], cache.x.shape[0], cache.x.shape[1]
    f64 = dtype == torch.float64
    cast = lambda t: t.to(dtype).contiguous()
    u, m2, x, _ = headline_operands(rng, b, cache, True)
    a, g, dv = vt._prep_tied(cast(u), cast(m2), cast(x))
    aod = vt._aug(a) * dv[..., None]
    k1 = [cast(t) for t in (g, dv, a, aod, cache.b_lam)]
    k3 = {}
    for n_loc in (n, n // 2):
        _, g_b, dv_b = vt._prep_tied(cast(u), cast(m2), cast(x[:n_loc]))
        k3[n_loc] = [cast(t) for t in (g_b, dv_b, a, aod,
                                       cache.b_lam[:, :n_loc].transpose(1, 2))]
    uu, m2u, xu, _ = headline_operands(rng, b, cache, False)
    au, gu, dvu = vt._prep_batched(cast(uu), cast(m2u), cast(xu))
    k2 = [cast(t) for t in (gu, dvu, au, vt._aug(au), cache.b_lam)]
    a4, z4, dv4 = vt._prep_sym(cast(u), cast(m2), cast(x), 1)
    k4t = [cast(t) for t in (z4, a4, dv4, vt._aug(a4), cache.b_lam)]
    a4u, z4u, dv4u = vt._prep_sym(cast(uu), cast(m2u), cast(xu), 2)
    k4u = [cast(t) for t in (z4u, a4u, dv4u, vt._aug(a4u), cache.b_lam)]
    res = {
        'K1': dict(ms=cuda_ms(lambda: vt.rw_tied(*k1), reps),
                   plain_ms=cuda_ms(lambda: vt.rw_tied_reference(*k1), reps),
                   bound=bound_ms(b, n, n, d, e, 1, f64)),
        'K2': dict(ms=cuda_ms(lambda: vt.rw_untied(*k2), reps),
                   plain_ms=cuda_ms(lambda: vt.rw_untied_reference(*k2), reps),
                   bound=bound_ms(b, n, n, d, e, e, f64)),
        **{key: dict(
            ms=cuda_ms(lambda: vt.rw_tied_block(*k3[n_loc]), reps),
            plain_ms=cuda_ms(lambda: vt.rw_tied_block_reference(*k3[n_loc]),
                             reps),
            bound=bound_ms(b, n_loc, n, d, e, 1, f64), n_loc=n_loc)
           for key, n_loc in (('K3', n), ('K3 Nl=N/2', n // 2))},
        'K4 tied': dict(
            ms=cuda_ms(lambda: vt.rw_sym(*k4t, shared_chain=True), reps),
            plain_ms=cuda_ms(lambda: vt.rw_sym_reference(*k4t, True), reps),
            bound=sym_bound_ms(b, n, d, e, 1, f64)),
        'K4 per-output': dict(
            ms=cuda_ms(lambda: vt.rw_sym(*k4u, shared_chain=False), reps),
            plain_ms=cuda_ms(lambda: vt.rw_sym_reference(*k4u, False), reps),
            bound=sym_bound_ms(b, n, d, e, e, f64)),
    }
    fns = {
        'K1': lambda: vt.rw_tied(*k1), 'K2': lambda: vt.rw_untied(*k2),
        'K3': lambda: vt.rw_tied_block(*k3[n]),
        'K3 Nl=N/2': lambda: vt.rw_tied_block(*k3[n // 2]),
        'K4 tied': lambda: vt.rw_sym(*k4t, shared_chain=True),
        'K4 per-output': lambda: vt.rw_sym(*k4u, shared_chain=False)}
    if f64:
        fns.update(body_fns('K1', k1))
        fns.update(body_fns('K3 Nl=N/2', k3[n // 2]))
    graphed = graph_ms(fns, dev)
    plans = launch_plans(b, n, d, e, dtype, dev)
    for key, r in res.items():
        r['graph_ms'] = graphed[key]
        r['plan'] = plans[key]
        for body in BODIES:
            if f'{key} {body}' in graphed:
                r[f'graph_ms_{body}'] = graphed[f'{key} {body}']
        log(f'[kernels] {key} {dtype} at B={b} N={n} d={d} E={e}'
            f'{" Nl=" + str(r["n_loc"]) if "n_loc" in r else ""}: '
            f'{r["ms"]:.4f} ms by events over host-enqueued calls, '
            f'{r["graph_ms"]:.4f} ms by graph slope{bodies_note(r)}, plain '
            f'{r["plain_ms"]:.4f} ms, bound {r["bound"][0]:.4f} ms '
            f'({r["bound"][1]})')
    return res


def time_k1_f64_wide(dev, b, cache):
    """K1's f64 instance by graph slope at B = b (the recipe's widest lane
    count), beside its bound."""
    import torch
    from gpmpc_tpu_torch.benchmarks.chain import kernel_args
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from gpmpc_tpu_torch.problems import headline_operands
    args = kernel_args(*headline_operands(np.random.default_rng(3), b, cache,
                                          True))
    if args[0].dtype != torch.float64:
        raise AssertionError('K1 f64 timing: operands are not f64')
    n, d, e = cache.x.shape[0], cache.x.shape[1], cache.b_lam.shape[0]
    ms = graph_ms({'K1 f64': lambda: vt.rw_tied(*args),
                   **body_fns('K1 f64', args)}, dev)
    out = dict(graph_ms=ms['K1 f64'],
               **{f'graph_ms_{bd}': ms[f'K1 f64 {bd}'] for bd in BODIES},
               body=vt.rw_tied_body(b, n, n, d, e, torch.float64,
                                    vt.device_sms(dev)),
               bound=bound_ms(b, n, n, d, e, 1, f64=True))
    log(f'[kernels] K1 float64 at B={b} N={n}: {out["graph_ms"]:.4f} ms by '
        f'graph slope{bodies_note(dict(out, plan=dict(body=out["body"])))}, '
        f'bound {out["bound"][0]:.4f} ms ({out["bound"][1]})')
    return out


def probe_args(inputs):
    """K1's f32 arguments (g, dv, a, aod, blam) from tied (u, m2, x, blam)."""
    import torch
    from gpmpc_tpu_torch.benchmarks.chain import kernel_args
    return kernel_args(*(t.to(torch.float32) for t in inputs[:4]))


def check_probe_variants(dev, b, n, n_ragged, cache):
    """Every probe variant against its plain versions (probe.checks) on the
    JAX kernel test's inputs at (b, n) and (7, n_ragged); `full` equal to
    K1 to the bit there and on the headline operands. Returns {variant:
    (max abs err against its first plain version, largest err / bar)}."""
    import torch
    from gpmpc_tpu_torch.ops.kernels import probe
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from gpmpc_tpu_torch.problems import headline_operands
    rng = np.random.default_rng(2)
    d, e = cache.x.shape[1], cache.b_lam.shape[0]
    shapes = {f'B={b} N={n}': probe_args(kernel_test_inputs(
                  rng, b, n, d, e, True, dev)),
              f'B=7 N={n_ragged}': probe_args(kernel_test_inputs(
                  rng, 7, n_ragged, d, e, True, dev))}
    out = {v: (0.0, 0.0) for v in probe.VARIANTS}
    for shape, args in shapes.items():
        for v in probe.VARIANTS:
            got = probe.rw_probe(v, *args).double()
            for i, (label, want, bar) in enumerate(probe.checks(v, *args)):
                err = (got - want).abs()
                ratio = float((err / bar).max())
                if not ratio <= 1.0:
                    raise AssertionError(f'probe {v} at {shape} vs {label}: '
                                         f'|err| exceeds the bar {ratio:.3f}x')
                e_max = float(err.max()) if i == 0 else out[v][0]
                out[v] = (max(out[v][0], e_max), max(out[v][1], ratio))
        if not torch.equal(probe.rw_probe('full', *args), vt.rw_tied(*args)):
            raise AssertionError(f'probe full differs from K1 at {shape}')
    head = probe_args(headline_operands(rng, b, cache, True))
    if not torch.equal(probe.rw_probe('full', *head), vt.rw_tied(*head)):
        raise AssertionError('probe full differs from K1 on the headline '
                             'operands')
    for v, (err, ratio) in out.items():
        log(f'[probes] {v} vs its plain version(s), {" and ".join(shapes)}: '
            f'max abs err {err:.3e}, at most {ratio:.3e} of its bar ok')
    log('[probes] full equal to K1 (rw_tied) to the bit on both shapes and '
        'on the headline operands ok')
    # The f64 variants: the scalar body's stages at T = double and the
    # tensor-core body's variants, each against its plain f64 version;
    # `full` and `mma` equal to K1's f64 launch in that body to the bit.
    for shape, args in shapes.items():
        args = [t.double() for t in args]
        for v in probe.F64_VARIANTS:
            got = probe.rw_probe(v, *args)
            (_, want, bar), = probe.checks(v, *args)
            err = (got - want).abs()
            ratio = float((err / bar).max())
            if not ratio <= 1.0:
                raise AssertionError(f'probe {v} f64 at {shape}: |err| '
                                     f'exceeds the bar {ratio:.3f}x')
            key = f'{v} f64'
            old = out.get(key, (0.0, 0.0))
            out[key] = (max(old[0], float(err.max())), max(old[1], ratio))
        for v, body in (('full', 'scalar'), ('mma', 'mma')):
            k1 = (vt._launch(*args, body=body)[0] if dev.type == 'cuda'
                  else vt.rw_tied(*args))
            if not torch.equal(probe.rw_probe(v, *args), k1):
                raise AssertionError(f'probe {v} f64 differs from K1 f64 in '
                                     f'the {body} body at {shape}')
    for v in probe.F64_VARIANTS:
        err, ratio = out[f'{v} f64']
        log(f'[probes] {v} f64 vs its plain f64 version, '
            f'{" and ".join(shapes)}: max abs err {err:.3e}, at most '
            f'{ratio:.3e} of its bar (1e-12 |rw| + 16 eps mag) ok')
    log('[probes] f64 full and mma equal to K1 f64 in the scalar and the '
        'tensor-core body to the bit on both shapes ok')
    return out


def phase_probes(dev, b, n_ragged, cache, reps):
    """Phase 3b: the probe kernel's checks, then P1 and P2 at the headline
    shape, each counted. Returns (checks, ablate, probe results, launches,
    plain ms of full and tc_p)."""
    import torch
    from gpmpc_tpu_torch.benchmarks import kernel_ablate, kernel_probe
    from gpmpc_tpu_torch.ops.kernels import probe
    n = cache.x.shape[0]
    checks = check_probe_variants(dev, b, n, n_ragged, cache)
    runs, launches = {}, {}
    for key, mod, dtype in (('P1', kernel_ablate, torch.float32),
                            ('P2', kernel_probe, torch.float32),
                            ('P1 f64', kernel_ablate, torch.float64)):
        reset_counts()
        runs[key] = (mod.run(device=dev, b=b, n=n) if dtype == torch.float32
                     else mod.run(device=dev, b=b, n=n, dtype=dtype))
        counts = read_counts()
        if counts['P'] == 0 or any(v for k, v in counts.items() if k != 'P'):
            raise AssertionError(f'{key}: launches {counts}, expected the '
                                 'probe kernel and no other')
        launches[key] = counts['P']
        for name, row in runs[key]['variants'].items():
            if not row['bar_ratio'] <= 1.0:
                raise AssertionError(f'{key} {name} on the probes\' inputs: '
                                     f'error {row["bar_ratio"]:.3f}x its bar')
    x, m2, blam, rng = kernel_ablate.probe_inputs(n, dev)
    args = probe_args((kernel_ablate.draw_u(rng, (b, 3), dev), m2, x, blam))
    plain = {v: cuda_ms(lambda v=v: probe.rw_probe_reference(v, *args), reps)
             for v in ('full', 'tc_p')}
    log(f'[probes] P1 (kernel_ablate) at B={b} N={n}, microseconds: '
        'kernel-only graph slope / chain-step graph slope / max abs err vs '
        f'plain; {launches["P1"]} probe wrapper calls')
    for name, r in runs['P1']['variants'].items():
        log(f'[probes]   {name:13s} ({r["tpu_variant"]}): {r["kernel_us"]:8.3f}'
            f' / {r["chain_us"]:8.3f} / {r["max_abs_err_vs_plain"]:.3e}')
    log(f'[probes] P1 at f64 (the scalar body\'s stages at T = double, the '
        f'tensor-core body\'s variants) at B={b} N={n}, microseconds: '
        f'kernel-only / chain-step / max abs err vs plain; '
        f'{launches["P1 f64"]} probe wrapper calls')
    for name, r in runs['P1 f64']['variants'].items():
        log(f'[probes]   {name:13s}: {r["kernel_us"]:8.3f} / '
            f'{r["chain_us"]:8.3f} / {r["max_abs_err_vs_plain"]:.3e}')
    log(f'[probes] P2 (kernel_probe) at B={b} N={n}, microseconds: '
        'kernel-only / chain-step; max rel err of t vs f64 on the probes\' '
        f'inputs / on the headline GP; {launches["P2"]} probe wrapper calls')
    for name, r in runs['P2']['variants'].items():
        log(f'[probes]   {name:8s} ({r["variant"]}): {r["kernel_us"]:8.3f} / '
            f'{r["chain_us"]:8.3f}; {r["t_rel_err_probe_inputs"]:.3e} / '
            f'{r["t_rel_err_headline"]:.3e}')
    log(f'[probes] plain versions by events: full {plain["full"]:.4f} ms, '
        f'tc_p {plain["tc_p"]:.4f} ms')
    return checks, runs, launches, plain


def check_objective(tag, j64, ref, b, dev):
    """J64 at u_ref and at 0, and dJ64/du at 0, against the stored JAX
    values (rtol 1e-8). Returns (J64(u_ref), max rel errs)."""
    import torch
    f64 = torch.float64
    u_ref = torch.tensor(ref['u_ref'][:b], dtype=f64, device=dev)
    with torch.no_grad():
        j_uref = j64(u_ref)
    u0 = torch.zeros_like(u_ref, requires_grad=True)
    j_zero = j64(u0)
    n_grad = min(b, ref['grad_zero'].shape[0])
    (g_zero,) = torch.autograd.grad(j_zero[:n_grad].sum(), u0)
    assert_close(f'{tag} J64(u_ref)', j_uref, torch.tensor(ref['j_uref'][:b]),
                 rtol=OBJ_RTOL, atol=0.0)
    assert_close(f'{tag} J64(0)', j_zero, torch.tensor(ref['j_zero'][:b]),
                 rtol=OBJ_RTOL, atol=0.0)
    assert_close(f'{tag} dJ64/du at 0', g_zero[:n_grad],
                 torch.tensor(ref['grad_zero'][:n_grad]), rtol=OBJ_RTOL,
                 atol=1e-10)
    rel_uref = np.max(np.abs(j_uref.cpu().numpy() / ref['j_uref'][:b] - 1))
    rel_zero = np.max(np.abs(j_zero.detach().cpu().numpy() / ref['j_zero'][:b]
                             - 1))
    log(f'[objective] {tag}: f64 J at u_ref and 0, B={b}: max rel err vs JAX '
        f'{rel_uref:.2e} / {rel_zero:.2e} (rtol {OBJ_RTOL}) ok')
    return j_uref, dict(rel_uref=float(rel_uref), rel_zero=float(rel_zero))


def phase_objective(dev, ref, b):
    """Phase 4: the port's f64 objective vs the JAX package's, through K1
    and through K4. Returns the f64 objective, its values at u_ref and a
    summary."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    from gpmpc_tpu_torch.problems import headline_j64, make_headline_problem
    j64 = headline_j64(b, dev)
    reset_counts()
    j_uref, rel_k1 = check_objective('K1 path', j64, ref, b, dev)
    if read_counts()['K1 f64'] == 0:
        raise AssertionError('objective: the f64 objective launched no K1')
    reset_counts()
    with sym_opt_in():
        _, rel_k4 = check_objective('K4 path', j64, ref, b, dev)
    counts = read_counts()
    if counts['K4'] == 0 or counts['K1 f64'] or counts['K1 f32']:
        raise AssertionError(f'objective with the K4 opt-in: launches {counts}')

    p32 = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    j32 = batch_objective(build_rollout_cache(p32.gp, 2, 1), p32.x0s, p32.params)
    u_ref = torch.tensor(ref['u_ref'][:b], dtype=torch.float32, device=dev)
    with torch.no_grad():
        rel = (j32(u_ref).double() - j_uref).abs() / j_uref.abs()
    rel = rel.cpu().numpy()
    log(f'[objective] f32 J at u_ref vs f64: rel err p50 '
        f'{np.median(rel):.3e}, max {rel.max():.3e}')
    return j64, j_uref, dict(k1_path=rel_k1, k4_path=rel_k4,
                             f32_rel_err_p50=float(np.median(rel)),
                             f32_rel_err_max=float(rel.max()))


def solve_checked(tag, desc, solve, x0s, key, per_trace, horizon,
                  cost0=None, also=()):
    """One counted solve: finite costs, exactly per_trace * H * (1 + iters)
    launches of `key` and of each kernel of `also` (the eigensolver of a
    full-covariance solve, one a step) and none of any other kernel, and
    (given cost0) no lane above its start. Returns (result, launches of
    `key`, loop iterations)."""
    import torch
    reset_counts()
    res = solve(x0s)
    sync(x0s.device)
    counts = read_counts()
    loop_iters = int(res.iters.max())
    expect = per_trace * horizon * (1 + loop_iters)
    keys = (key, *also)
    others = {k: v for k, v in counts.items() if k not in keys and v}
    if any(counts[k] != expect for k in keys) or others:
        raise AssertionError(f'{tag}: launches {counts}, expected {expect} '
                             f'{" and ".join(keys)} = {per_trace} * H * '
                             f'(1 + iters) and no other')
    if not bool(torch.isfinite(res.cost).all()):
        raise AssertionError(f'{tag}: non-finite costs')
    msg = ''
    if cost0 is not None:
        # The Armijo test admits f_try <= f + eps_f with eps_f = 16 eps
        # (1 + |f|), so a lane may end up to iters * eps_f above its start.
        slack = (loop_iters * 16 * torch.finfo(cost0.dtype).eps
                 * (1 + cost0.abs()))
        worse = int((res.cost > cost0 + slack).sum())
        if worse:
            raise AssertionError(f'{tag}: {worse} lanes end above their start')
        msg = (f'; costs finite, none above its start ok; mean cost '
               f'{float(res.cost.mean()):.4f} vs {float(cost0.mean()):.4f} '
               f'at u=0')
    log(f'[{tag}] {desc}: loop iterations {loop_iters}, '
        f'{" and ".join(keys)} launches {counts[key]} each = '
        f'{per_trace}*H*(1+iters) ok, no other kernel{msg}')
    return res, counts[key], loop_iters


def score_and_time(tag, b, solve, res, j64, j_uref, reps, dev, modes=None):
    """Cost excess of `res` against the f64 reference controls, then
    solves/s over fresh x0s (as the solve runs; with `modes`, in each of
    them in turns: time_solves)."""
    from gpmpc_tpu_torch.problems import cost_excess
    quality = cost_excess(j64, res.u, j_uref)
    log(f'[{tag}] cost excess vs f64 u_ref (J64): p50 {quality["p50"]:.4%} '
        f'p90 {quality["p90"]:.4%} max {quality["max"]:.4%}, lanes >1% '
        f'{quality["lanes_above_1pct"]}/{b}')
    if modes:
        timed = time_solves(tag, b, solve, reps, dev, modes=modes)
        return dict(quality=quality, **timed['reused'],
                    **{m: timed[m] for m in modes if m != 'reused'})
    return dict(quality=quality, **time_solves(tag, b, solve, reps, dev))


def time_solves(tag, b, solve, reps, dev, draw_x0s=None, modes=None):
    """Solves/s over `reps` batches of fresh x0s (the median); draw_x0s(rng)
    gives a batch (numpy), by default the headline's U(-1, 1)^(B, 2). With
    modes (of MODES) each batch is solved in each mode in turns, the order
    rotating by one each batch (loop_mode), all results equal to the bit
    (same_bits), and the result is {mode: ...}: each mode's walls, solves/s
    and each call's captures and capture seconds (capture_walls)."""
    import torch
    rng = np.random.default_rng(123)
    order = tuple(modes or (None,))
    walls = {mode: [] for mode in order}
    caps = {mode: [] for mode in order}
    iters = []
    for rep in range(reps):
        x0s = torch.tensor(rng.uniform(-1, 1, (b, 2)) if draw_x0s is None
                           else draw_x0s(rng), dtype=torch.float32,
                           device=dev)
        res = {}
        k = rep % len(order)
        for mode in order[k:] + order[:k]:
            with (loop_mode(mode) if mode else contextlib.nullcontext(),
                  capture_walls() as cw):
                sync(dev)
                t0 = time.perf_counter()
                res[mode] = solve(x0s)
                sync(dev)
                walls[mode].append(time.perf_counter() - t0)
            caps[mode].append((len(cw), float(sum(w for w, _ in cw))))
        for mode in order[1:]:
            same_bits(f'{tag} batch {rep} {order[0]} vs {mode}',
                      res[order[0]], res[mode])
        iters.append(int(res[order[-1]].iters.max()))
    out = {}
    for mode, w in walls.items():
        rate = [b / x for x in w]
        out[mode] = dict(walls=w, solves_per_s=float(np.median(rate)),
                         iters_timed=iters,
                         captures=[n for n, _ in caps[mode]],
                         capture_s=[s for _, s in caps[mode]])
        log(f'[{tag}]{"" if mode is None else " " + mode} wall s per batch '
            f'{[round(x, 4) for x in w]}, loop iterations {iters}; solves/s '
            f'median {float(np.median(rate)):.2f} (min {min(rate):.2f}, max '
            f'{max(rate):.2f}); captures per call '
            f'{out[mode]["captures"]} '
            f'({[round(s, 4) for s in out[mode]["capture_s"]]} s)')
    if not modes:
        return out[None]
    log(f'[{tag}] {reps} batches, {", ".join(modes)} in turns: equal to the '
        f'bit (u, cost, iters, pg_norm, converged) ok; solves/s '
        + ', '.join(f'{m} / {modes[0]} '
                    f'{out[m]["solves_per_s"] / out[modes[0]]["solves_per_s"]:.2f}'
                    for m in modes[1:]))
    return out


def headline_solve_setup(dev, b):
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    j32 = batch_objective(build_rollout_cache(p.gp, 2, 1), p.x0s, p.params)
    with torch.no_grad():
        cost0 = j32(torch.zeros((b, p.horizon, 1), dtype=torch.float32,
                                device=dev))
    return p, SolverConfig(max_iters=ITERS, tol=1e-4), cost0


def phase_solve(dev, b, j64, j_uref, reps, tag='solve', key='K1 f64'):
    """Phase 5: the plain path (K1's f64 instance, by the precision policy;
    'K1 f32' under the k1_f32 trace), or with the K4 opt-in on (key 'K4'),
    counted, then scored and timed."""
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    p, cfg, cost0 = headline_solve_setup(dev, b)

    def solve(x0s):
        return solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg)

    res, launches, loop_iters = solve_checked(
        tag, f'B={b} H={p.horizon} max_iters={ITERS}', solve, p.x0s, key, 1,
        p.horizon, cost0)
    return dict(launches=launches, loop_iters=loop_iters,
                **score_and_time(tag, b, solve, res, j64, j_uref, reps, dev))


def untied_gp(dev):
    """The headline data with per-output lengthscales (the untied path)."""
    import torch
    from gpmpc_tpu_torch.gp.state import make_gp
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=2, dtype=torch.float32, device=dev)
    n = int(p.gp.count)
    gp = make_gp(p.gp.config, p.gp.x[:n].cpu().numpy(),
                 p.gp.y[:, :n].T.cpu().numpy(),
                 log_lambdas=np.log([[4.0, 4.0, 4.0], [3.0, 5.0, 4.0]]),
                 log_sigma_f=0.0, log_sigma_n=np.log(0.1),
                 dtype=torch.float32, device=dev)
    assert not gp.config.tied_lambdas
    return gp


def phase_untied(dev, b, key='K2'):
    """Phase 5b: the untied path (per-output lengthscales): K2, or with the
    K4 opt-in on (key 'K4'), one launch a trace for all E outputs."""
    import torch
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    gp = untied_gp(dev)

    def solve(x0s):
        return solve_batch(gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           SolverConfig(max_iters=UNTIED_ITERS, tol=1e-4))

    _, launches, _ = solve_checked(
        'untied', f'{key} B={b} max_iters={UNTIED_ITERS}', solve, p.x0s, key,
        1, p.horizon)
    return launches


def tally(counts: dict):
    """A dict of counts, made visible to CUDA-graph replays
    (utils/replay_counts.py): a call captured in a solver's program counts
    once per replay; the program cache is emptied first. A context
    manager."""
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.utils import replay_counts

    def add(delta):
        for k, n in delta.items():
            counts[k] = counts.get(k, 0) + n
    # A tally sees the replays of the graphs captured while it is
    # registered: the programs kept from before go.
    solver.clear_programs()
    return replay_counts.registered(lambda: dict(counts), add)


def phase_graph(dev, b, card, out_dir):
    """Phase 5f: the lockstep loop eager, graphed (each solve captures its
    program anew) and reused (the program kept across calls), on the plain
    solve_batch at the headline (B = 256, f32, K1 f64, ITERS iterations):
    each counted (exactly H * (1 + iters) K1 f64 launches, replays
    included; counted_modes) and the three equal to the bit, each program's
    step and init graphs exactly H K1 f64 launches a replay; solves/s of
    the three over GRAPH_REPS fresh-x0 batches in turns (time_solves), the
    reused calls capturing nothing; the eager solve (PROFILE_ITERS) and the
    reused one, both at PROFILE_ITERS, under the profiler: host launch
    calls, the device's busy share, and exactly H K1 kernels a
    value-and-grad in the device trace, the graphs' replays included."""
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    p, cfg, cost0 = headline_solve_setup(dev, b)

    def solve(x0s, iters=ITERS):
        return solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg.replace(max_iters=iters))

    want = {'LAUNCHES': p.horizon, 'LAUNCHES_F64': p.horizon}
    _, launches, iters, capture = counted_modes(
        'graph', f'B={b} H={p.horizon} max_iters={ITERS}', solve, p.x0s,
        'K1 f64', p.horizon, cost0, want)
    timed = time_solves('graph headline', b, solve, GRAPH_REPS, dev,
                        modes=MODES)
    n, secs = reused_captures(timed['reused'])
    if n:
        raise AssertionError(f'graph: the timed reused calls captured {n} '
                             'graphs, expected none')
    cache = cache_note('graph', 2 + n, capture['reused']['capture_s'] + secs)
    with eager_loop():
        prof_e = profile_solve('graph eager', lambda x: solve(x, PROFILE_ITERS),
                               p.x0s, 'rw_tied', out_dir, per_eval=p.horizon)
    # At PROFILE_ITERS too: a trace of 40 back-to-back replays (~125,000
    # device kernels in ~0.6 s) has lost a quarter of its kernel records
    # (617 K1 kernels of 820); the smaller a trace, the fewer it loses.
    prof_g = profile_solve('graph reused',
                           lambda x: solve(x, PROFILE_ITERS), p.x0s,
                           'rw_tied', out_dir, per_eval=p.horizon)
    out = dict(launches=launches, loop_iters=iters, profile_eager=prof_e,
               profile_reused=prof_g, capture=capture, cache=cache, **timed)
    if prof_e and prof_g:
        log(f'[graph] on {card}: solves/s eager '
            f'{timed["eager"]["solves_per_s"]:.2f}, graphed '
            f'{timed["graphed"]["solves_per_s"]:.2f}, reused '
            f'{timed["reused"]["solves_per_s"]:.2f}; host launch calls: '
            f'eager {prof_e["kernel_launches"] / prof_e["evaluations"]:.0f} '
            f'kernels a value-and-grad; reused '
            f'{prof_g["graph_launches"]} graph launches for its '
            f'{prof_g["evaluations"]} value-and-grads (the init graph and '
            f'one step graph an iteration), and {prof_g["kernel_launches"]} '
            f'kernel launches (the inputs\' copies and the result\'s); '
            f'device busy {100 * prof_e["device_busy_s"] / prof_e["wall_s"]:.1f}'
            f' % of the eager solve, '
            f'{100 * prof_g["device_busy_s"] / prof_g["wall_s"]:.1f} % of '
            f'the reused one; the first reused solve\'s 2 captures '
            f'{1e3 * capture["reused"]["capture_s"]:.1f} ms '
            f'({100 * capture["reused"]["capture_share"]:.1f} % of it)')
    return out


@contextlib.contextmanager
def count_propagated_rollouts():
    """Count the propagated-variance rollouts of parallel.batch (those with
    neither frozen_cov_diag nor mean_only: each runs the variance trace at
    every step) in a block, a rollout captured in the solver's graph once
    per replay (`tally`); yields a dict {lanes: rollouts}."""
    from gpmpc_tpu_torch.parallel import batch
    orig, widths = batch.rollout_batched, {}

    def counted(cache, x0s, actions, *args, **kw):
        if kw.get('frozen_cov_diag') is None and not kw.get('mean_only'):
            lanes = int(actions.shape[0])
            widths[lanes] = widths.get(lanes, 0) + 1
        return orig(cache, x0s, actions, *args, **kw)

    batch.rollout_batched = counted
    try:
        with tally(widths):
            yield widths
    finally:
        batch.rollout_batched = orig


def phase_recipe(dev, b, j64, j_uref, card, lane_counts=RECIPE_WIDTHS):
    """Phase 5c: the production recipe (solve_batch_multistart_retired with
    problems.RECIPE and REFINE) on the f32 headline problem, counted: finite
    costs, exactly H launches of K1's f64 instance a propagated-variance
    rollout and no other kernel, each rollout at one of `lane_counts` (the
    B = 256 ones phase 3 checked; None, at another B, skips that check); its
    diag counters, its cost excess against the f64 reference controls (fails
    at p90 >= RECIPE_P90_MAX) and its solves/s over fresh x0s eager, graphed
    and reused in turns, equal to the bit; over its reused calls each key
    is captured once (cache_note)."""
    import torch
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch_multistart_retired
    from gpmpc_tpu_torch.problems import (RECIPE, RECIPE_NAME, REFINE,
                                          make_headline_problem)
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    refine = SolverConfig(**REFINE)

    def solve(x0s, diag=None):
        return solve_batch_multistart_retired(
            p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub, refine,
            diag=diag, **RECIPE)

    diag = {}
    with count_propagated_rollouts() as widths, capture_walls() as walls:
        reset_counts()
        t0 = time.perf_counter()
        res = solve(p.x0s, diag)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
    capture = capture_note(walls, wall)
    rollouts = sum(widths.values())
    expect = p.horizon * rollouts
    others = {k: v for k, v in counts.items() if k != 'K1 f64' and v}
    if counts['K1 f64'] != expect or others:
        raise AssertionError(f'recipe: launches {counts}, expected {expect} '
                             f'K1 f64 = H * {rollouts} propagated-variance '
                             'rollouts and no other')
    widths = dict(sorted(widths.items()))
    if lane_counts is not None and not set(widths) <= set(lane_counts):
        raise AssertionError(f'recipe: propagated-variance rollouts at lane '
                             f'counts {widths}, phase 3 checked K1 only at '
                             f'{lane_counts}')
    if not bool(torch.isfinite(res.cost).all()):
        raise AssertionError('recipe: non-finite costs')
    log(f'[recipe] {RECIPE_NAME} B={b} H={p.horizon} f32: {rollouts} '
        f'propagated-variance rollouts ({{lanes: rollouts}} {widths}, each '
        f'lane count checked in phase 3 ok), K1 f64 launches '
        f'{counts["K1 f64"]} = H * rollouts ok, no other kernel; costs finite '
        f'ok; max iters {int(res.iters.max())}; diag {diag}; wall {wall:.2f} '
        f's (the first solve), of it {capture["captures"]} graph captures '
        f'{capture["capture_s"]:.3f} s ({100 * capture["capture_share"]:.1f} '
        f'%, median {1e3 * capture["capture_median_s"]:.2f} ms)')
    out = score_and_time('recipe', b, solve, res, j64, j_uref, RECIPE_REPS,
                         dev, modes=MODES)
    n, secs = reused_captures(out)
    cache = cache_note('recipe', capture['captures'] + n,
                       capture['capture_s'] + secs)
    log(f'[recipe] solves/s on {RECIPE_REPS} fresh batch (the eager recipe '
        f'costs ~25 s a batch, so every mode is timed on one): eager '
        f'{out["eager"]["solves_per_s"]:.3f}, graphed '
        f'{out["graphed"]["solves_per_s"]:.3f}, reused '
        f'{out["solves_per_s"]:.3f}; the reused call captured {n} graphs')
    q = out['quality']
    log(f'[recipe] beside the JAX recipe on a TPU (BENCH_r05.json): p90 '
        f'{q["p90"]:.4%} (JAX {JAX_RECIPE_BAR["p90"]:.2%}), lanes >1% '
        f'{q["lanes_above_1pct"]}/{b} (JAX {JAX_RECIPE_BAR["lanes_above_1pct"]}'
        f'), max {q["max"]:.4%} (JAX {JAX_RECIPE_BAR["max"]:.1%}); '
        f'quality-paired solves/s {out["solves_per_s"]:.3f} over '
        f'{RECIPE_REPS} fresh batches on {card}')
    if not q['p90'] < RECIPE_P90_MAX:
        raise AssertionError(f'recipe: p90 cost excess {q["p90"]:.4%} is not '
                             f'below {RECIPE_P90_MAX:.0%}')
    return dict(launches=counts['K1 f64'], propagated_rollouts=rollouts,
                rollout_lanes=widths, diag=diag, first_wall_s=wall,
                capture=capture, cache=cache, **out)


def phase_full_cov(dev, b, ref, card, out_dir):
    """Phase 5e: the full-covariance headline solve, solve_batch(full_cov=
    True): its f64 objective and gradient against the JAX package's (K1 f64
    and the eigensolver, H launches each a rollout); then the f32 solve at
    ITERS iterations eager, graphed and reused (counted_modes), each
    counted (H (1 + iters) launches of K1 f64 and of the eigensolver and no
    other kernel), the three equal to the bit and each program's graphs
    exactly H K1 f64 and H eigensolver launches a replay; solves/s of the
    three over FULL_COV_REPS fresh-x0 batches in turns; the reused solve at
    FULL_COV_PROFILE_ITERS under the profiler (H K1 kernels a
    value-and-grad in the device trace)."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import batch_objective, solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    p64 = make_headline_problem(b=b, dtype=torch.float64, device=dev)
    cache64 = build_rollout_cache(p64.gp, 2, 1)
    u_ref = as64(ref['u_ref'][:b], dev)
    reset_counts()
    with torch.no_grad():
        j = batch_objective(cache64, p64.x0s, p64.params, full_cov=True)(u_ref)
    counts = read_counts()
    if counts['K1 f64'] != p64.horizon or counts['eigh'] != p64.horizon:
        raise AssertionError(f'full cov: the f64 objective launched '
                             f'{counts}, expected H K1 f64 and H eigh')
    j_want = torch.tensor(ref['j_uref_full'][:b])
    assert_close('full-cov J64(u_ref)', j, j_want, rtol=OBJ_RTOL, atol=0.0)
    lanes = ref['grad_full_lanes']
    u = u_ref[lanes].clone().requires_grad_()
    (g,) = torch.autograd.grad(batch_objective(
        cache64, p64.x0s[lanes], p64.params._replace(
            gamma=p64.params.gamma[lanes]), full_cov=True)(u).sum(), u)
    g_want = torch.tensor(ref['grad_uref_full'])
    assert_close('full-cov dJ64/du at u_ref', g, g_want, rtol=OBJ_RTOL,
                 atol=1e-10)
    rel_j = float((j.cpu() / j_want - 1).abs().max())
    rel_g = float((g.cpu() - g_want).abs().max() / g_want.abs().max())
    penalised = int((j_want > 1e5).sum())
    log(f'[full cov] f64 J at u_ref with full_cov=True, B={b}, through K1 f64'
        f' and the eigensolver: max rel err vs JAX {rel_j:.2e} (rtol '
        f'{OBJ_RTOL}; {penalised} lanes take the PD-cone penalty there, as in '
        f'JAX); dJ/du on lanes {[int(k) for k in lanes]}: max abs err '
        f'{rel_g:.2e} of max |g| ok')

    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=ITERS, tol=1e-4)
    with torch.no_grad():
        cost0 = batch_objective(build_rollout_cache(p.gp, 2, 1), p.x0s,
                                p.params, full_cov=True)(
            torch.zeros((b, p.horizon, 1), dtype=torch.float32, device=dev))

    def solve(x0s, iters=ITERS):
        return solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg.replace(max_iters=iters), full_cov=True)

    desc = (f'solve_batch(full_cov=True) B={b} H={p.horizon} '
            f'max_iters={ITERS}')
    want = {'LAUNCHES': p.horizon, 'LAUNCHES_F64': p.horizon,
            'LAUNCHES_EIGH': p.horizon}
    _, launches, loop_iters, capture = counted_modes(
        'full cov', desc, solve, p.x0s, 'K1 f64', p.horizon, cost0, want,
        also=('eigh',))
    log('[full cov] no f64 reference solve exists for the full-covariance '
        'objective: no cost excess is recorded')
    timed = time_solves('full cov', b, solve, FULL_COV_REPS, dev, modes=MODES)
    n, secs = reused_captures(timed['reused'])
    cache = cache_note('full cov', 2 + n,
                       capture['reused']['capture_s'] + secs)
    prof = profile_solve(
        'full cov reused', lambda x0s: solve(x0s, FULL_COV_PROFILE_ITERS),
        p.x0s, 'rw_tied', out_dir, per_eval=p.horizon)
    if prof:
        log(f'[full cov] on {card}: solves/s eager '
            f'{timed["eager"]["solves_per_s"]:.2f}, graphed '
            f'{timed["graphed"]["solves_per_s"]:.2f}, reused '
            f'{timed["reused"]["solves_per_s"]:.2f}; the reused solve at '
            f'{FULL_COV_PROFILE_ITERS} iterations (its own program): device '
            f'busy {100 * prof["device_busy_s"] / prof["wall_s"]:.1f} % of '
            f'its wall, {prof["kernel_launches"]} host kernel launches, '
            f'{prof["graph_launches"]} graph launches')
    return dict(launches=launches, eigh_launches=launches,
                loop_iters=loop_iters, rel_j=rel_j, rel_g=rel_g,
                penalised_lanes_at_uref=penalised, capture=capture,
                cache=cache, profile_reused=prof, **timed['reused'],
                eager=timed['eager'], graphed=timed['graphed'])


def _demangle(name: str) -> str:
    """A C++ symbol as the profiler names its kernel (the mangled name if
    libstdc++ cannot demangle it)."""
    import ctypes
    try:
        f = ctypes.CDLL('libstdc++.so.6').__cxa_demangle
    except (OSError, AttributeError):
        return name
    f.restype = ctypes.c_char_p
    status = ctypes.c_int(-1)
    out = f(name.encode(), None, None, ctypes.byref(status))
    return out.decode() if status.value == 0 and out else name


def replayed_nodes(before: dict, after: dict) -> dict:
    """The kernel nodes run by the replays between two
    `replay_counts.replays_run()` snapshots, by the name the profiler gives
    a kernel."""
    from collections import Counter
    nodes = Counter()
    for graph, n in after.items():
        times = n - before.get(graph, 0)
        for name, k in (graph.names.items() if times else ()):
            nodes[_demangle(name)] += k * times
    return nodes


def _trace(solve, x0s):
    """One solve under torch.profiler: the profiler, the result, the wall,
    and the kernel nodes that the replays of captured graphs ran in it, by
    name."""
    from torch.profiler import ProfilerActivity, profile
    from gpmpc_tpu_torch.utils import replay_counts
    before = replay_counts.replays_run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(x0s)
        sync(x0s.device)
        wall = time.perf_counter() - t0
    return prof, res, wall, replayed_nodes(before, replay_counts.replays_run())


def profile_solve(tag, solve, x0s, kernel, out_dir, per_eval=None):
    """One solve (after a warm one) under torch.profiler: wall, device busy
    time, the number and share of the kernels whose name holds `kernel`,
    the number of device kernels, and the host time of the collectives,
    each also per value-and-grad (1 + iterations of them a solve). With
    per_eval, raises unless the device ran exactly per_eval x (1 +
    iterations) of `kernel` (replays of a captured graph included: the
    profiler traces each kernel node a replay runs). The profiler can lose
    device records (a trace of 40 replays, ~125,000 kernels, has lost a
    quarter), so that count is read only from a trace that lost none that
    can be told: none of the kernel nodes its replays ran (by name,
    utils/replay_counts.replays_run), and, where nothing was replayed, none
    of the kernels the host launched. With per_eval, a trace that lost
    some is taken again, up to PROFILE_TRACES in all, and none whole
    raises. The table goes to out_dir/chip_smoke_profile_<tag>.txt."""
    from collections import Counter
    dev = x0s.device
    solve(x0s)
    sync(dev)
    for trace in range(1, PROFILE_TRACES + 1):
        prof, res, wall, nodes = _trace(solve, x0s)
        events = [e for e in prof.events() if e.device_type.name == 'CUDA']
        # The host's launch calls (cudaLaunchKernel*, cuLaunchKernel*):
        # kernels, and graphs (cudaGraphLaunch).
        launch_calls = {}
        for e in prof.events():
            if (e.device_type.name == 'CPU' and e.name.startswith('cu')
                    and 'Launch' in e.name):
                launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
        graph_launches = sum(n for k, n in launch_calls.items()
                             if 'Graph' in k)
        kernel_launches = sum(launch_calls.values()) - graph_launches
        seen = Counter(e.name for e in events
                       if not e.name.startswith(('Memcpy', 'Memset')))
        n_kernels = sum(seen.values())
        if nodes:
            lost = sum(max(0, n - seen[k]) for k, n in nodes.items())
        else:
            lost = max(0, kernel_launches - n_kernels)
        if lost == 0 or per_eval is None or not events:
            break
        log(f'[profile] {tag}: trace {trace} lost {lost} of the '
            f'{sum(nodes.values()) or kernel_launches} kernels that '
            f'{"its replays" if nodes else "the host"} ran; tracing again')
    if per_eval is not None and events and lost:
        raise AssertionError(f'{tag}: each of {PROFILE_TRACES} traces lost '
                             f'kernel records (the last {lost}): the count '
                             f'of {kernel} cannot be read')
    evals = 1 + int(res.iters.max())
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    k_events = [e for e in events if kernel in e.name]
    k_us = sum(e.time_range.elapsed_us() for e in k_events)
    averages = prof.key_averages()
    coll = [e for e in averages if 'allreduce' in e.key.lower()
            or 'all_reduce' in e.key.lower()]
    coll_host_us = max((e.cpu_time_total for e in coll), default=0.0)
    coll_calls = max((e.count for e in coll), default=0)
    os.makedirs(out_dir, exist_ok=True)
    name = tag.replace(' ', '_')
    with open(os.path.join(out_dir, f'chip_smoke_profile_{name}.txt'), 'w') as f:
        f.write(averages.table(sort_by='self_device_time_total', row_limit=40))
    if busy_us == 0:
        log(f'[profile] {tag}: device time: not measured (the profiler saw '
            'no device events)')
        if per_eval is not None:
            raise AssertionError(f'{tag}: no device trace to count {kernel} '
                                 'in')
        return None
    if per_eval is not None and len(k_events) != per_eval * evals:
        raise AssertionError(f'{tag}: the device ran {len(k_events)} '
                             f'{kernel} kernels, expected {per_eval} x '
                             f'{evals} value-and-grads (the trace holds '
                             f'{len(events)} device kernels in {wall:.4f} s)')
    out = dict(evaluations=evals, traces=trace, lost_kernels=lost,
               replayed_kernels=sum(nodes.values()), wall_s=wall,
               device_busy_s=busy_us / 1e6,
               device_kernels=len(events), kernel_s=k_us / 1e6,
               kernel_calls=len(k_events),
               collective_calls=coll_calls,
               collective_host_s=coll_host_us / 1e6,
               launch_calls=launch_calls, kernel_launches=kernel_launches,
               graph_launches=graph_launches)
    log(f'[profile] {tag}, one solve of {evals} value-and-grads under the '
        f'profiler: wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} s '
        f'({100 * busy_us / 1e6 / wall:.1f}%), {len(events)} device kernels '
        f'({len(events) / evals:.0f} a value-and-grad; {n_kernels} '
        f'kernels: {sum(nodes.values())} replayed, {kernel_launches} host '
        f'launches, {lost} lost; trace {trace}), {len(k_events)} '
        f'{kernel}{"" if per_eval is None else f" (= {per_eval} x {evals} ok)"}'
        f' {k_us / 1e6:.4f} s ({100 * k_us / max(busy_us, 1):.1f}% of busy); '
        f'all_reduce calls {coll_calls}, host time {coll_host_us / 1e6:.4f} s;'
        f' host launch calls: {kernel_launches} kernels '
        f'({kernel_launches / evals:.0f} a value-and-grad), {graph_launches} '
        f'graphs {launch_calls}')
    return out


def phase_profile(dev, b, out_dir, tag='K1 solve', kernel='rw_tied'):
    """One headline solve_batch under the profiler (the K4 opt-in, when on,
    makes it the sym solve)."""
    import torch
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=PROFILE_ITERS, tol=1e-4)

    def solve(x0s):
        return solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg)

    return profile_solve(tag, solve, p.x0s, kernel, out_dir)


def phase_sharded_11(dev, b, j64, j_uref, reps, out_dir):
    """Phase 6a: solve_batch_2d on a (1, 1) mesh in this process (NCCL on the
    card), counted (K3), scored and timed."""
    import torch.distributed as dist
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.distributed import free_port, initialize
    from gpmpc_tpu_torch.parallel.mesh import make_mesh
    from gpmpc_tpu_torch.parallel.model_sharded import solve_batch_2d
    initialize(f'tcp://localhost:{free_port()}', world_size=1, rank=0,
               device=dev, timeout_s=PG_TIMEOUT_S)
    backend = dist.get_backend()
    mesh = make_mesh(1, 1, device=dev)
    p, cfg, cost0 = headline_solve_setup(dev, b)

    def solve(x0s):
        return solve_batch_2d(mesh, p.gp, 2, 1, x0s, p.params, p.horizon,
                              p.lb, p.ub, cfg)

    tag = 'sharded 1x1'
    res, launches, loop_iters = solve_checked(
        tag, f'{backend} B={b} max_iters={ITERS}', solve, p.x0s, 'K3', 1,
        p.horizon, cost0)
    out = dict(backend=backend, launches=launches, loop_iters=loop_iters,
               **score_and_time(tag, b, solve, res, j64, j_uref, reps, dev))
    cfg_prof = SolverConfig(max_iters=PROFILE_ITERS, tol=1e-4)
    out['profile'] = profile_solve(
        tag, lambda x0s: solve_batch_2d(mesh, p.gp, 2, 1, x0s, p.params,
                                        p.horizon, p.lb, p.ub, cfg_prof),
        p.x0s, 'rw_tied', out_dir)
    dist.destroy_process_group()
    return out


def shard_worker(out_dir):
    """One rank of phase 6b, started by launch_ranks: the (1, world) mesh on
    gloo on the card, the f64 headline objective and gradient at the
    reference controls through K3; writes sharded_rank<r>.npz to out_dir."""
    import torch
    import torch.distributed as dist
    from gpmpc_tpu_torch.parallel.distributed import finish_rank, initialize
    from gpmpc_tpu_torch.parallel.mesh import make_mesh
    from gpmpc_tpu_torch.parallel.model_sharded import (sharded_value_and_grad,
                                                        shard_problem)
    from gpmpc_tpu_torch.problems import REF_FILE, make_headline_problem
    initialize(backend='gloo', device='cuda', timeout_s=PG_TIMEOUT_S)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device('cuda', torch.cuda.current_device())
    mesh = make_mesh(1, world, device=dev)
    ref = np.load(REF_FILE)
    b = ref['u_ref'].shape[0]
    p = make_headline_problem(b=b, dtype=torch.float64, device=dev)
    parts = shard_problem(mesh, p.gp, 2, 1, p.x0s, p.params)
    reset_counts()
    f, g = sharded_value_and_grad(mesh, *parts)(
        torch.tensor(ref['u_ref'], dtype=torch.float64, device=dev))
    sync(dev)
    np.savez(os.path.join(out_dir, f'sharded_rank{rank}.npz'),
             f=f.cpu().numpy(), g=g.cpu().numpy(),
             n_loc=parts[1].shape[2], k3=read_counts()['K3'])
    finish_rank()


def phase_sharded_12(dev, b, ref, out_dir, world=2):
    """Phase 6b: solve_batch_2d's value-and-grad on a (1, 2) mesh in two
    processes on gloo on the same card; their f64 J against the JAX values
    and their gradient against the unsharded one here."""
    import torch
    from gpmpc_tpu_torch.parallel.distributed import launch_ranks
    from gpmpc_tpu_torch.problems import headline_j64
    env = dict(os.environ)
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    launch_ranks([sys.executable, os.path.abspath(__file__), '--out', out_dir,
                  '--shard-worker'], world, WORKER_TIMEOUT_S, env=env,
                 cwd=ROOT)
    outs = [np.load(os.path.join(out_dir, f'sharded_rank{r}.npz'))
            for r in range(world)]
    horizon = ref['u_ref'].shape[1]
    for r in range(world):
        if int(outs[r]['k3']) != horizon:
            raise AssertionError(f'sharded 1x{world}: rank {r} launched K3 '
                                 f'{int(outs[r]["k3"])} times, expected H = '
                                 f'{horizon} (one forward rollout)')
    for r in range(1, world):
        for k in ('f', 'g'):
            if not np.array_equal(outs[r][k], outs[0][k]):
                raise AssertionError(f'sharded 1x{world}: rank {r} {k} '
                                     'differs from rank 0')
    f, g = outs[0]['f'], outs[0]['g']
    np.testing.assert_allclose(f, ref['j_uref'][:b], rtol=OBJ_RTOL,
                               err_msg='sharded J64(u_ref) vs JAX')
    u = torch.tensor(ref['u_ref'][:b], dtype=torch.float64, device=dev,
                     requires_grad=True)
    (g_full,) = torch.autograd.grad(headline_j64(b, dev)(u).sum(), u)
    g_full = g_full.cpu().numpy()
    # u_ref is the optimum, where dJ/du cancels to ~1e-7 of its largest
    # entries: those entries are held to the same rtol of max |g|.
    atol = GRAD_RTOL * np.abs(g_full).max()
    np.testing.assert_allclose(g, g_full, rtol=GRAD_RTOL, atol=atol,
                               err_msg='sharded dJ64/du vs unsharded')
    rel_f = float(np.max(np.abs(f / ref['j_uref'][:b] - 1)))
    rel_g = float(np.max(np.abs(g - g_full)) / np.abs(g_full).max())
    log(f'[sharded 1x{world}] gloo, {world} processes on one card, '
        f'{int(outs[0]["n_loc"])} b_lam rows each, {int(outs[0]["k3"])} K3 '
        f'launches a rank (= H) ok: f64 J at u_ref max rel err vs JAX {rel_f:.2e} '
        f'(rtol {OBJ_RTOL}); dJ/du vs unsharded: max abs err {rel_g:.2e} of '
        f'max |g| '
        f'(rtol {GRAD_RTOL}, atol {GRAD_RTOL} max|g|); ranks equal to the bit '
        f'ok')
    return dict(rel_f=rel_f, rel_g=rel_g, k3_per_rank=int(outs[0]['k3']))


# ------------------------------------------------ the closed loop (3c, 7) --
_DT_NAME = {'torch.float32': 'f32', 'torch.float64': 'f64'}


def loop_lane_counts(dev) -> tuple:
    """The lane counts at which the closed loop launches K1 and K2: B = 1
    (the controller's single solves) and the candidate count of
    solve_batch_multistart at B = 1 with n_starts = LOOP_N_STARTS and the
    shifted last trajectory as one extra start, read from the port's own
    start set."""
    import torch
    from gpmpc_tpu_torch.parallel.batch import _multistart_starts
    x0 = torch.zeros((1, 2), dtype=torch.float64, device=dev)
    k = _multistart_starts(x0, 8, 1, -5.0, 5.0, LOOP_N_STARTS, 0, 0.02, 0.6,
                           0, extra_starts=torch.zeros(
                               (1, 1, 8, 1), dtype=torch.float64,
                               device=dev)).shape[0]
    return (1, k)


def loop_inputs(rng, b, n, n_valid, d, e, tied, dev):
    """The JAX kernel test's inputs (kernel_test_inputs) at a capacity n
    with n_valid valid rows, as a padded GP gives them: x and blam zero
    outside the valid block."""
    u, m2, x, blam, ct = kernel_test_inputs(rng, b, n, d, e, tied, dev)
    x[n_valid:] = 0.0
    blam[:, n_valid:] = 0.0
    blam[:, :, n_valid:] = 0.0
    return u, m2, x, blam, ct


def check_split(tag, key, u, m2, x, blam, dev) -> dict:
    """K1's or K2's wrapper at its plan for this card (S <= B, the
    contraction split over a cluster where the grid is small) against the
    split sum's plain version in f64 on the same operands: f32 at the JAX
    kernel test's forward bar, f64 within 1e-12 |rw| plus 16 f64 ulps of the
    terms' magnitude sum; one counted launch each, K2's for all E. Returns
    the max abs errors by instance, the plan and its blocks."""
    import functools
    import torch
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    tied = key == 'K1'
    b, n, d = u.shape[0], x.shape[0], x.shape[1]
    e = blam.shape[0]
    prep = vt._prep_tied if tied else vt._prep_batched
    a, g, dv = prep(u, m2, x)
    ao = vt._aug(a)
    ops = (g, dv, a, ao * dv[..., None] if tied else ao, blam)
    errs, sms = {}, vt.device_sms(dev)
    for dtype in (torch.float32, torch.float64):
        args = [t.to(dtype).contiguous() for t in ops]
        plan = (vt.rw_tied_plan(b, n, n, d, e, dtype, sms) if tied
                else vt.rw_untied_plan(b, n, d, e, dtype, sms))
        ref = functools.partial(vt.rw_split_reference if tied
                                else vt.rw_untied_split_reference, plan=plan)
        if tied and vt.rw_tied_body(b, n, n, d, e, dtype, sms) == 'mma':
            plan = vt.rw_tied_mma_plan(b, n, d, e)
            ref = vt.rw_tied_mma_reference
        counter = 'LAUNCHES' if tied else COUNTER['K2']
        before = getattr(vt, counter)
        got = (vt.rw_tied if tied else vt.rw_untied)(*args).double()
        sync(dev)
        if getattr(vt, counter) != before + 1:
            raise AssertionError(f'{tag}: {getattr(vt, counter) - before} '
                                 f'{key} launches for one call')
        a64 = [t.double() for t in args]
        want = ref(*a64)
        if dtype == torch.float32:
            errs['f32'] = assert_close(f'{tag} f32 vs the split plain f64',
                                       got, want, **FWD_TOL)
            continue
        mag = ref(a64[0], a64[1], a64[2], a64[3].abs(), a64[4].abs())
        err = (got - want).abs()
        bar = 1e-12 * want.abs() + 16 * torch.finfo(torch.float64).eps * mag
        if not bool((err <= bar).all()):
            raise AssertionError(f'{tag} f64 vs the split plain version: '
                                 f'{float((err / bar).max()):.3f}x its bar')
        errs['f64'] = float(err.max())
        errs['plan'] = dict(scenarios=plan.scenarios, grid=plan.grid,
                            **({} if isinstance(plan, vt.MmaPlan)
                               else {'split': plan.split}))
    return errs


def phase_loop_kernels(dev):
    """Phase 3c: K1 and K2 at every shape and lane count of the closed loop
    (LOOP_CAPACITIES x LOOP_DIMS x loop_lane_counts): each f32 instance
    against the plain f64 version at the JAX kernel test's bars (forward
    and backward), and both instances at check_conditioned's bars (f32:
    5e-5 |t| + 16 eps mag; f64: 1e-12 |t| + 16 eps mag). Returns the set of
    (kernel, instance, B, N, d, E) checked, the max abs errors per shape
    and the lane counts."""
    import torch
    rng = np.random.default_rng(7)
    lanes = loop_lane_counts(dev)
    checked, errs = set(), {}
    for key, tied in (('K1', True), ('K2', False)):
        fn, ref = trace_fns(tied)
        for n, n_valid in LOOP_CAPACITIES:
            for d, e in LOOP_DIMS:
                for b in lanes:
                    tag = f'{key} loop B={b} N={n} ({n_valid} valid) d={d} E={e}'
                    ins = loop_inputs(rng, b, n, n_valid, d, e, tied, dev)
                    err = {'f32 bars': check_trace(tag, fn, ref, *ins)}
                    for dtype, rtol in ((torch.float32, 5e-5),
                                        (torch.float64, 1e-12)):
                        err[_DT_NAME[str(dtype)]] = check_conditioned(
                            tag, fn, ref, *(t.detach() for t in ins[:4]),
                            dtype, rtol)[0]
                    err['split'] = check_split(tag, key, *ins[:4], dev)
                    errs[f'{key} B={b} N={n} d={d} E={e}'] = err
                    checked |= {(key, dt, b, n, d, e) for dt in ('f32', 'f64')}
        mine = [v for name, v in errs.items() if name.startswith(key)]
        worst = {k: max(v[k] for v in mine) for k in ('f32 bars', 'f32', 'f64')}
        worst_split = {k: max(v['split'][k] for v in mine)
                       for k in ('f32', 'f64')}
        log(f'[loop kernels] {key} at B in {lanes}, N in '
            f'{[c[0] for c in LOOP_CAPACITIES]}, (d, E) in {list(LOOP_DIMS)}: '
            f'f32 vs plain f64 max abs err {worst["f32 bars"]:.3e} (fwd rtol '
            f'5e-5 atol 5e-5, bwd rtol 2e-3 atol 2e-4); on the conditioned '
            f'bar f32 {worst["f32"]:.3e}, f64 {worst["f64"]:.3e}; rw against '
            f'the split sum\'s plain version f32 {worst_split["f32"]:.3e}, '
            f'f64 {worst_split["f64"]:.3e} (1e-12 |rw| + 16 eps mag), one '
            f'launch a call ok')
        for name, v in errs.items():
            if name.startswith(key):
                log(f'[loop kernels] plan {name}: {v["split"]["plan"]}')
    return checked, errs, lanes


def _loop_kernel_args(rng, b, n, n_valid, d, e, tied, dev, n_loc=None):
    """Each kernel's f64 arguments at a loop shape, prepped as the traces
    prep them; tied with n_loc, K3's: the first n_loc output rows against
    all n, blam's column block transposed (as mesh.row_block stores it)."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    u, m2, x, blam, _ = loop_inputs(rng, b, n, n_valid, d, e, tied, dev)
    if tied:
        a, g, dv = vt._prep_tied(u, m2, x)
        aod = vt._aug(a) * dv[..., None]
        if n_loc is not None:
            _, g, dv = vt._prep_tied(u, m2, x[:n_loc])
            blam = blam[:, :n_loc].transpose(1, 2)
        return [t.contiguous() for t in (g, dv, a, aod, blam)]
    a, g, dv = vt._prep_batched(u, m2, x)
    return [t.contiguous() for t in (g, dv, a, vt._aug(a), blam)]


# K2's f64 graph slopes at B = 1 as K1 launched once per output, before the
# one-launch design (one H100 80GB HBM3 at 700 W; PERF.md §6): the one-launch
# K2 must take at most a quarter of them.
K2_GRAPH_MS_BEFORE = {('K2', 1, 512, 320, 3, 2): 0.0898,
                   ('K2', 1, 512, 320, 5, 4): 0.1460}
# (kernel, B, N, valid rows, d, E) of the closed loop's timed launches: the
# integrator's K1; the pendulum's and the cartpole's K2 at B = 1 and the
# pendulum's K2 at the multistart's candidate count (filled in by
# time_loop_kernels); K1 at the pendulum's shape for comparison.
LOOP_TIMED = (('K1', 1, 128, 100, 2, 1), ('K1', 1, 512, 320, 3, 2),
              ('K2', 1, 512, 320, 3, 2), ('K2', 1, 512, 320, 5, 4))


def time_loop_kernels(dev, lanes):
    """The f64 instances of K1 and K2 at the closed loop's shapes
    (LOOP_TIMED, and K2 at the multistart's lane count), time_shapes; fails
    where K2 at B = 1 takes more than a quarter of its graph slope as K1
    launched once per output (K2_GRAPH_MS_BEFORE)."""
    res = time_shapes(dev, list(LOOP_TIMED) + [('K2', lanes[-1], 512, 320,
                                                3, 2)], 'loop kernels',
                      np.random.default_rng(11))
    for (key, b, n, _, d, e), before in K2_GRAPH_MS_BEFORE.items():
        ms = res[f'{key} f64 B={b} N={n} d={d} E={e}']['graph_ms']
        if not ms <= before / 4:
            raise AssertionError(f'{key} f64 at (B, N, d, E) = ({b}, {n}, {d}, '
                                 f'{e}): {ms:.4f} ms by graph slope, more '
                                 f'than a quarter of the {before} ms of K1 '
                                 'launched once per output')
        log(f'[loop kernels] {key} f64 at ({b}, {n}, {d}, {e}): {ms:.4f} ms, '
            f'{ms / before:.3f} of the {before} ms as K1 per output (at most '
            f'0.25) ok')
    return res


def time_shapes(dev, shapes, tag, rng, bodies=True):
    """The f64 instances of K1 / K2 / K3 at (kernel, B, N, valid rows, d, E)
    `shapes` (K3: the first N / 2 output rows, one rank of a (1, 2) mesh):
    CUDA events over 50 host-enqueued calls, CUDA-graph slope, the plain
    version's events time, the bound and the launch plan. With `bodies`,
    a tied launch is also timed by graph slope in each body, 'scalar' (the
    plan before the tensor-core body, `graph_ms_scalar`) and 'mma'
    (`graph_ms_mma`), whatever its route: the evidence for the route."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    res, fns = {}, {}
    for key, b, n, n_valid, d, e in shapes:
        tied = key != 'K2'
        n_out = n // 2 if key == 'K3' else n
        args = _loop_kernel_args(rng, b, n, n_valid, d, e, tied, dev,
                                 n_out if key == 'K3' else None)
        kern = {'K1': vt.rw_tied, 'K2': vt.rw_untied,
                'K3': vt.rw_tied_block}[key]
        plain = vt.rw_tied_reference if tied else vt.rw_untied_reference
        name = f'{key} f64 B={b} N={n} d={d} E={e}'
        if key == 'K3':
            name += f' Nl={n_out}'
        fns[name] = (lambda k=kern, a=args: k(*a))
        if tied and bodies:
            fns.update(body_fns(name, args))
        bound = bound_ms(b, n_out, n, d, e, 1 if tied else e, f64=True)
        plan = rw_plan(key, b, n_out, n, d, e, args[0].dtype, dev)
        res[name] = dict(ms=cuda_ms(fns[name], 50),
                         plain_ms=cuda_ms(lambda p=plain, a=args: p(*a), 50),
                         bound=bound, plan=plan)
    for name, ms in graph_ms(fns, dev).items():
        base, _, body = name.rpartition(' ')
        if body in BODIES and base in res:
            res[base][f'graph_ms_{body}'] = ms
        else:
            res[name]['graph_ms'] = ms
    for name, r in res.items():
        log(f'[{tag}] {name}: {r["ms"]:.4f} ms by events, '
            f'{r["graph_ms"]:.4f} ms by graph slope{bodies_note(r)}, plain '
            f'{r["plain_ms"]:.4f} ms, bound '
            f'{r["bound"][0]:.5f} ms ({r["bound"][1]}); plan '
            + ', '.join(f'{k} {v}' for k, v in r['plan'].items()
                        if k != 'body'))
    return res


@contextlib.contextmanager
def record_launch_shapes():
    """Record (kernel, instance, B, N, d, E) of every K1 and K2 call on CUDA
    tensors in a block (K2's E is the GP's, all in one launch), a call
    captured in the solver's graph once per replay (`tally`); yields a dict
    {shape: calls}."""
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    seen = {}
    orig_t, orig_u = vt.rw_tied, vt.rw_untied

    def note(key, g, e):
        if g.is_cuda:
            k = (key, _DT_NAME[str(g.dtype)], g.shape[0], g.shape[-2],
                 g.shape[-1], e)
            seen[k] = seen.get(k, 0) + 1

    def tied(g_out, dv_out, a, aod, blam):
        note('K1', g_out, blam.shape[0])
        return orig_t(g_out, dv_out, a, aod, blam)

    def untied(g, dv, a, ao, blam):
        note('K2', g, g.shape[1])
        return orig_u(g, dv, a, ao, blam)

    vt.rw_tied, vt.rw_untied = tied, untied
    try:
        with tally(seen):
            yield seen
    finally:
        vt.rw_tied, vt.rw_untied = orig_t, orig_u


def _loop_launches() -> dict:
    c = read_counts()
    return {'K1': c['K1 f32'] + c['K1 f64'], 'K2': c['K2'], 'eigh': c['eigh']}


def count_steps(mpc, steps: list, horizon: int):
    """Wrap mpc.get_optimal_trajectory to log each control step: its wall
    (synchronized), its K1 and K2 launches, solver iterations and first
    action. On the controller's single B = 1 route (no multistart) each
    value-and-grad runs one rollout, H traces: the step must launch exactly
    H * (1 + iters) of K1 (tied) or of K2 (untied: one launch a trace for
    all E outputs)."""
    orig = mpc.get_optimal_trajectory

    def step(x):
        before = _loop_launches()
        t0 = time.perf_counter()
        u = orig(x)
        sync(mpc.device)
        wall = time.perf_counter() - t0
        after = _loop_launches()
        res = mpc.last_result
        row = dict(wall_s=wall, iters=int(res.iters) if res is not None else 0,
                   u0=float(u[0, 0]),
                   **{k: after[k] - before[k] for k in after})
        if res is not None and mpc.solver_recipe != 'multistart':
            rollouts = 1 + row['iters']
            want = ({'K1': horizon * rollouts, 'K2': 0}
                    if mpc.gp.config.tied_lambdas else
                    {'K1': 0, 'K2': horizon * rollouts})
            if {k: row[k] for k in want} != want:
                raise AssertionError(f'closed loop step {len(steps)}: launches '
                                     f'{row}, expected {want}')
        steps.append(row)
        return u

    mpc.get_optimal_trajectory = step


def check_loop_step(tag, mpc, x, horizon, reps, dev, full_cov=False):
    """One control step of `mpc` from state x, `reps` times in each of MODES
    (loop_mode), in turns, the order rotating each round, the controller's
    last trajectory (u_prev) reset before each: every step launches exactly
    H * (1 + iters) of K1 (tied) or K2 (untied) on the B = 1 route, and with
    full_cov (the controller's full covariance, for these steps) as many of
    the eigensolver; each round's three results are equal to the bit; each
    graphed step captures its program's two graphs, each holding exactly H
    of each a replay by its kernel nodes; the reused steps capture the
    key's two graphs once in all (none where the key is kept already, as
    the episode's own). Returns the step walls (synchronized) of each mode,
    their p50 and their captures."""
    import torch
    traj, own_cov = mpc.last_traj.copy(), mpc.full_cov
    mpc.full_cov = full_cov
    kernel = 'K1' if mpc.gp.config.tied_lambdas else 'K2'
    each = ({'LAUNCHES_UNTIED': horizon} if kernel == 'K2' else
            {'LAUNCHES': horizon, **({'LAUNCHES_F64': horizon}
                                     if mpc.gp.x.dtype == torch.float64
                                     else {})})
    if full_cov:
        each['LAUNCHES_EIGH'] = horizon
    walls = {m: [] for m in MODES}
    captures = {m: [] for m in MODES}
    launched = {m: [] for m in MODES}
    for rep in range(reps):
        res = {}
        k = rep % len(MODES)
        for mode in MODES[k:] + MODES[:k]:
            mpc.last_traj = traj.copy()
            reset_counts()
            with loop_mode(mode), capture_walls() as cap:
                _, wall = _timed(lambda: mpc.get_optimal_trajectory(x), dev)
            captures[mode].append(cap)
            r = res[mode] = mpc.last_result
            got, want = _loop_launches(), horizon * (1 + int(r.iters))
            if (got[kernel] != want or got['eigh'] != want * full_cov
                    or sum(got.values()) != want * (1 + full_cov)):
                raise AssertionError(f'{tag} {mode} step: launches {got}, '
                                     f'expected {want} {kernel}'
                                     + (' and eigh' if full_cov else ''))
            walls[mode].append(wall)
            launched[mode].append(got)
        for mode in MODES[1:]:
            same_bits(f'{tag} step {rep} {MODES[0]} vs {mode}',
                      res[MODES[0]], res[mode])
    mpc.last_traj, mpc.full_cov = traj, own_cov
    graphs = {m: [n for cap in c for _, n in cap] for m, c in captures.items()}
    if (graphs['eager'] or graphs['graphed'] != [each] * 2 * reps
            or graphs['reused'] not in ([], [each] * 2)
            or any(captures['reused'][1:])):
        raise AssertionError(f'{tag}: the steps\' graphs hold {graphs} kernel '
                             f'launches a replay, expected none eager, two of '
                             f'{each} each graphed step, and two or none in '
                             'all, on the first, reused')
    out = {mode: dict(walls=w, wall_p50_s=float(np.median(w)),
                      launches=launched[mode],
                      capture=capture_note([c for cap in captures[mode]
                                            for c in cap], sum(w)))
           for mode, w in walls.items()}
    log(f'[loop {tag}] one step from the last state, {", ".join(MODES)} in '
        f'turns, {reps} each: {kernel}{" and eigh" if full_cov else ""} = '
        f'H * (1 + iters) each, each graph\'s kernel nodes {each} a replay, '
        f'equal to the bit ok; wall p50 '
        + ', '.join(f'{m} {out[m]["wall_p50_s"]:.4f} s' for m in MODES)
        + f' (walls {dict((m, [round(w, 4) for w in walls[m]]) for m in MODES)}'
        f'); captures: graphed {len(graphs["graphed"])} (median '
        f'{1e3 * out["graphed"]["capture"]["capture_median_s"]:.2f} ms), '
        f'reused {len(graphs["reused"])}')
    return out


def _log_steps(tag, steps, walls):
    """Each step's log line; the episode's step p50 and max, K1 and K2
    launches, and its captures (walls: capture_walls of the episode)."""
    for i, r in enumerate(steps):
        log(f'[loop {tag}] step {i}: {r["wall_s"]:.3f} s, iters {r["iters"]}, '
            f'K1 {r["K1"]} K2 {r["K2"]}, u0 {r["u0"]:+.4f}')
    step_walls = [r['wall_s'] for r in steps]
    out = dict(steps=steps, wall_p50_s=float(np.median(step_walls)),
               wall_max_s=float(np.max(step_walls)),
               k1=sum(r['K1'] for r in steps), k2=sum(r['K2'] for r in steps),
               captures=len(walls),
               capture_s=float(sum(w for w, _ in walls)))
    log(f'[loop {tag}] {len(steps)} steps: step wall p50 '
        f'{out["wall_p50_s"]:.4f} s, max {out["wall_max_s"]:.4f} s; '
        f'{len(walls)} captures in the episode ({out["capture_s"]:.3f} s)')
    return out


def _timed(fn, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def time_append(mpc, dev, reps=3):
    """Seconds of one append-and-refit of a single transition (not kept)
    at the controller's capacity, the median of `reps`."""
    from gpmpc_tpu_torch.gp import state as gp_state
    d, e = mpc.gp.config.x_dim, mpc.gp.config.out_dim
    row = mpc.gp.x[:1].clone(), mpc.gp.y[:, :1].T.clone()
    walls = [_timed(lambda: gp_state.append(mpc.gp, *row), dev)[1]
             for _ in range(reps)]
    return float(np.median(walls)), (mpc.gp.config.capacity, d, e)


def phase_closed_loop(dev, checked, ref_path, out_dir):
    """Phase 7: the online learn-and-control loop on the card, each part
    with the counts set to 0 just before it and read just after, every K1
    and K2 launch at a shape phase 3c checked. (a) the integrator's known
    answer; (b) the swing-up of tests/test_closed_loop.py at f64 on the
    stored JAX transitions, its trained hyperparameters and first steps
    against JAX's and the test's criteria; (c) pretrain_pendulum's delta
    mode in f32 with the multistart recipe; (d) pretrain_cartpole's delta
    mode; (e) run_episode_on_device with tests/test_sim.py's assertions.
    One more swing-up step from the episode's last state runs under the
    profiler (device busy share, kernels a value-and-grad)."""
    import torch
    from gpmpc_tpu_torch.envs import pendulum
    from gpmpc_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams
    from gpmpc_tpu_torch.experiments import pretrain_cartpole, pretrain_pendulum
    from gpmpc_tpu_torch.experiments.integrator import integrator_experiment
    from gpmpc_tpu_torch.gp import state as gp_state
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.cost import CostParams
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.sim.simulator import Simulator, run_episode_on_device
    out = {}
    t_phase = time.perf_counter()
    with record_launch_shapes() as shapes:
        # (a) The integrator: K1 f64 at B = 1, N = 128, d = 2, E = 1.
        reset_counts()
        (u, err), wall = _timed(lambda: integrator_experiment(
            verbose=False, device=dev), dev)
        launches = _loop_launches()
        if not err < 5e-3:
            raise AssertionError(f'integrator: u* {u.ravel()} off [-1]*5 by {err}')
        out['integrator'] = dict(u=u.ravel().tolist(), err=err, wall_s=wall,
                                 **launches)
        log(f'[loop integrator] u* {np.round(u.ravel(), 6).tolist()}, max '
            f'|u + 1| {err:.2e} (< 5e-3) ok; {wall:.3f} s with the fit; '
            f'launches {launches}')

        # (b) The swing-up at f64 on the stored JAX transitions.
        ref = np.load(ref_path)
        params = PendulumParams(g=10.0, max_torque=5.0)
        mpc = RiskSensitiveMPC(
            gamma=0.0, horizon=8, state_dim=2, input_dim=1,
            Q=np.diag([8.0, 1.0]), R=0.001 * np.eye(1),
            R_delta=0.001 * np.eye(1), capacity=512, delta_dynamics=True,
            dtype=torch.float64, solver=SolverConfig(max_iters=60, tol=1e-4),
            device=dev)
        mpc.set_ub([params.max_torque])
        mpc.set_lb([-params.max_torque])
        mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_f=1.0,
                               sigma_n=1e-2)
        mpc.dynamics.append_train_data(ref['states'], ref['actions'],
                                       ref['next_states'])
        reset_counts()
        res, train_s = _timed(lambda: mpc.train_gp(num_iters=80), dev)
        hp_err = {}
        for k in ('log_lambdas', 'log_sigma_f', 'log_sigma_n'):
            got = getattr(mpc.gp, k).cpu().numpy()
            np.testing.assert_allclose(got, ref[k], rtol=LOOP_HP_RTOL,
                                       err_msg=f'swing-up trained {k} vs JAX')
            hp_err[k] = float(np.max(np.abs(got / ref[k] - 1)))
        if res.iters != int(ref['train_iters']):
            raise AssertionError(f'swing-up: train iters {res.iters}, JAX '
                                 f'{int(ref["train_iters"])}')
        append_s, at = time_append(mpc, dev)
        steps = []
        count_steps(mpc, steps, 8)
        env = PendulumEnv(params=params, device=dev,
                          init_state={'th_init': 1.0, 'thdot_init': 0.5})
        with capture_walls() as ep_walls:
            ep = Simulator(mpc, env, num_iters=SWING_STEPS).run()
        if len(ep_walls) != 2:
            raise AssertionError(f'swing-up: the episode took {len(ep_walls)}'
                                 ' captures, expected its one key\'s two')
        n_ref = ref['ep_actions'].shape[0]
        np.testing.assert_allclose(ep.actions[:n_ref], ref['ep_actions'],
                                   rtol=0, atol=LOOP_ACTION_ATOL,
                                   err_msg='swing-up first actions vs JAX')
        np.testing.assert_allclose(ep.states[:n_ref + 1], ref['ep_states'],
                                   rtol=0, atol=LOOP_STATE_ATOL,
                                   err_msg='swing-up first states vs JAX')
        np.testing.assert_allclose(ep.costs[:n_ref], ref['ep_costs'],
                                   rtol=LOOP_COST_RTOL,
                                   err_msg='swing-up first costs vs JAX')
        th_tail, thdot_tail = ep.states[-8:, 0], ep.states[-8:, 1]
        if not (np.max(np.abs(th_tail)) < 0.15
                and np.max(np.abs(thdot_tail)) < 0.5):
            raise AssertionError(f'swing-up not upright: tail theta '
                                 f'{np.round(th_tail, 3)}, theta_dot '
                                 f'{np.round(thdot_tail, 3)}')
        if not np.all(np.abs(ep.actions) <= params.max_torque + 1e-9):
            raise AssertionError('swing-up: actions outside the bounds')
        if int(mpc.gp.count) != 250 + len(ep.actions):
            raise AssertionError(f'swing-up: GP count {int(mpc.gp.count)}')
        del mpc.get_optimal_trajectory          # count_steps' wrapper
        graph_step = check_loop_step('swing-up', mpc, ep.states[-1], 8,
                                     GRAPH_REPS, dev)
        graph_step_full = check_loop_step('swing-up full_cov', mpc,
                                          ep.states[-1], 8,
                                          FULL_COV_LOOP_REPS, dev,
                                          full_cov=True)

        def one_step(_):
            mpc.get_optimal_trajectory(ep.states[-1])
            return mpc.last_result

        prof = profile_solve('loop step', one_step, mpc.gp.x, 'rw_tied',
                             out_dir, per_eval=8)
        out['swing_up'] = dict(
            train_s=train_s, train_iters=res.iters, hp_rel_err=hp_err,
            append_refit_s=append_s, append_at=at,
            first_action_err=float(np.max(np.abs(
                ep.actions[:n_ref] - ref['ep_actions']))),
            first_cost_rel_err=float(np.max(np.abs(
                ep.costs[:n_ref] / ref['ep_costs'] - 1))),
            tail_theta_max=float(np.max(np.abs(th_tail))),
            tail_thdot_max=float(np.max(np.abs(thdot_tail))),
            iters_vs_jax=[ep.iters[:n_ref].tolist(), ref['ep_iters'].tolist()],
            profile=prof, graph_step=graph_step,
            graph_step_full_cov=graph_step_full,
            **_log_steps('swing-up', steps, ep_walls))
        r = out['swing_up']
        log(f'[loop swing-up] f64 N=512: train_gp(80) {train_s:.3f} s, {res.iters}'
            f' iters (JAX {int(ref["train_iters"])}), hyperparameters vs JAX '
            f'max rel err {max(hp_err.values()):.2e} (rtol {LOOP_HP_RTOL}) ok;'
            f' append-and-refit at (N, D, E) = {at}: {append_s * 1e3:.2f} ms; '
            f'first {n_ref} actions vs JAX max abs err '
            f'{r["first_action_err"]:.2e} (atol {LOOP_ACTION_ATOL}), costs '
            f'{r["first_cost_rel_err"]:.2e} (rtol {LOOP_COST_RTOL}) ok; tail '
            f'|theta| {r["tail_theta_max"]:.4f} < 0.15, |theta_dot| '
            f'{r["tail_thdot_max"]:.4f} < 0.5, actions in bounds, count '
            f'{int(mpc.gp.count)} ok; step wall p50 {r["wall_p50_s"]:.3f} s, '
            f'max {r["wall_max_s"]:.3f} s; K2 {r["k2"]}, K1 {r["k1"]}')

        # (c) pretrain_pendulum, delta mode, f32, the multistart recipe.
        mpc, env, params = pretrain_pendulum.make_controller(
            'delta', train_iters=0, device=dev)
        reset_counts()
        res, train_s = _timed(lambda: mpc.train_gp(num_iters=150), dev)
        append_s, at = time_append(mpc, dev)
        steps = []
        count_steps(mpc, steps, 8)
        with capture_walls() as ep_walls:
            ep = Simulator(mpc, env, num_iters=PRETRAIN_STEPS).run()
        if not (np.all(np.isfinite(ep.costs))
                and np.all(np.abs(ep.actions) <= params.max_torque + 1e-6)):
            raise AssertionError(f'pretrain_pendulum: costs {ep.costs}, '
                                 f'actions {ep.actions.ravel()}')
        out['pretrain_pendulum'] = dict(train_s=train_s, train_iters=res.iters,
                                        append_refit_s=append_s, append_at=at,
                                        **_log_steps('pendulum', steps, ep_walls))
        r = out['pretrain_pendulum']
        log(f'[loop pendulum] f32 multistart n_starts={LOOP_N_STARTS}: '
            f'train_gp(150) {train_s:.3f} s ({res.iters} iters), '
            f'append-and-refit {append_s * 1e3:.2f} ms; costs finite, actions '
            f'in bounds ok; step wall p50 {r["wall_p50_s"]:.3f} s; K2 '
            f'{r["k2"]}, K1 {r["k1"]}')

        # (d) pretrain_cartpole, delta mode: (d, E) = (5, 4).
        mpc, env, params = pretrain_cartpole.make_controller(
            'delta', train_iters=0, device=dev)
        reset_counts()
        res, train_s = _timed(lambda: mpc.train_gp(num_iters=150), dev)
        append_s, at = time_append(mpc, dev)
        steps = []
        count_steps(mpc, steps, 5)
        with capture_walls() as ep_walls:
            ep = Simulator(mpc, env, num_iters=PRETRAIN_STEPS).run()
        if not (np.all(np.isfinite(ep.costs))
                and np.all(np.abs(ep.actions) <= 1.0 + 1e-6)):
            raise AssertionError(f'pretrain_cartpole: costs {ep.costs}, '
                                 f'actions {ep.actions.ravel()}')
        out['pretrain_cartpole'] = dict(train_s=train_s, train_iters=res.iters,
                                        append_refit_s=append_s, append_at=at,
                                        **_log_steps('cartpole', steps, ep_walls))
        r = out['pretrain_cartpole']
        log(f'[loop cartpole] f32: train_gp(150) {train_s:.3f} s '
            f'({res.iters} iters), append-and-refit {append_s * 1e3:.2f} ms; '
            f'costs finite, actions in bounds ok; step wall p50 '
            f'{r["wall_p50_s"]:.3f} s; K2 {r["k2"]}, K1 {r["k1"]}')

        # (e) run_episode_on_device (tests/test_sim.py:49-73).
        p = PendulumParams(max_torque=3.0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        s, a, ns = pendulum.sample_transitions(gen, 20, p, dtype=torch.float64,
                                               device=dev)
        gp = gp_state.make_gp(
            gp_state.GPConfig(capacity=32, x_dim=3, out_dim=2),
            torch.cat([s, a], 1).cpu().numpy(), (ns - s).cpu().numpy(),
            log_lambdas=np.log(np.full((2, 3), 3.0)),
            log_sigma_n=np.log(np.full(2, 0.05)), dtype=torch.float64,
            device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        cp = CostParams(Q=2 * torch.eye(2, **f64), R=0.1 * torch.eye(1, **f64),
                        gamma=torch.tensor(0.0, **f64),
                        x_ref=torch.zeros(2, **f64), u_ref=torch.zeros(1, **f64))
        reset_counts()
        with capture_walls() as ep_walls:
            (gp_f, outs), wall = _timed(lambda: run_episode_on_device(
                gp, lambda st, u: pendulum.step(st, u, p),
                torch.tensor([0.5, 0.0], **f64), cp, horizon=3,
                num_steps=DEVICE_EPISODE_STEPS, lb=-3.0, ub=3.0,
                solver=SolverConfig(max_iters=25), delta_dynamics=True), dev)
        if not (outs['state'].shape == (DEVICE_EPISODE_STEPS, 2)
                and bool(torch.isfinite(outs['state']).all())
                and int(gp_f.count) == 20 + DEVICE_EPISODE_STEPS
                and float(outs['action'].abs().max()) <= 3.0 + 1e-9
                and outs['state'].device == gp.x.device):
            raise AssertionError(f'run_episode_on_device: {outs}, count '
                                 f'{int(gp_f.count)}')
        if len(ep_walls) != 2:
            raise AssertionError(f'run_episode_on_device: {len(ep_walls)} '
                                 'captures, expected its one key\'s two')
        out['device_episode'] = dict(wall_s=wall, captures=len(ep_walls),
                                     **_loop_launches())
        log(f'[loop on device] run_episode_on_device {DEVICE_EPISODE_STEPS} '
            f'steps: states finite on the card, count {int(gp_f.count)} = 20 + '
            f'{DEVICE_EPISODE_STEPS}, actions in bounds ok; {wall:.3f} s '
            f'(the single-scenario rollout: launches {_loop_launches()}); its '
            f'L-BFGS solves through one kept program: {len(ep_walls)} '
            'captures in the episode')
    unchecked = {k: v for k, v in shapes.items() if k not in checked}
    if unchecked:
        raise AssertionError(f'closed loop: K1/K2 launched at shapes phase 3c '
                             f'did not check: {unchecked}')
    out['launch_shapes'] = {' '.join(map(str, k)): v for k, v in shapes.items()}
    out['wall_s'] = time.perf_counter() - t_phase
    log(f'[loop] calls by (kernel, instance, B, N, d, E), each checked in '
        f'phase 3c ok: {out["launch_shapes"]}; phase {out["wall_s"]:.1f} s')
    return out


# (B, N, valid rows, d, E) of K1's launches in phase 8: suite config 3b
# (B = 256 lanes, M = 128 inducing points, the cartpole's d = 5, E = 4),
# config 4 (B = 64, M = 128, the pendulum's d = 3, E = 2; full covariance,
# so a non-diagonal M2) and the uncertainty experiment (B = 1, its 400
# points in capacity 512, d = 4, E = 2). Phase 3d checks K1 at each; phase 8
# fails on a K1 launch at any other.
SPARSE_SHAPES = ((256, 128, 128, 5, 4), (64, 128, 128, 3, 2),
                 (1, 512, 400, 4, 2))
# Config 3b's solve (benchmarks/suite.py config3b): the plain solve_batch at
# 40 iterations, f32; three fresh-x0 batches timed; the cost-excess gate of
# phase 5c.
SPARSE_ITERS = 40
SPARSE_REPS = 3
SPARSE_P90_MAX = 0.01
# Config 4's solve at the suite's 40 iterations, graphed; its eager and
# graphed solves are held equal to the bit at 5 (at H = 50 an eager
# value-and-grad launches ~50,000 kernels, 1.2 s on the card).
FULLCOV_H50_ITERS = 40
FULLCOV_BITS_ITERS = 5
# The bars of sparse_objective_parity against JAX's stored f64 values, and
# what the port reads on the CPU. The posterior (W, alpha) entrywise within
# a share of its largest entry: W is a difference of two inverses of
# matrices of condition 1e4 (3b) to 5e5 (config 4), so the packages' f64
# fits agree only to a share of the largest entry (CPU: 3b 7.8e-11 and
# 4.2e-10, config 4 3.3e-8 and 5.2e-8). J at rtol (CPU: 3b 1.4e-10; config
# 4 4.4e-9 on its own fit, 4.3e-10 on JAX's posterior). The gradient within
# a share of its largest entry at u = 0 (CPU: 3b 5e-11; config 4 on JAX's
# posterior 1.1e-9 at 0 and 1.3e-7 at u_ref, on its own fit 3.5e-8 and
# 2.4e-6: 50 steps of the full-covariance recurrence, with its eigenvalue
# clip, amplify the rounding away from u = 0).
SPARSE_BARS = {
    '3b': dict(posterior=1e-8, j=1e-8, grad_zero=1e-8, grad_uref=1e-8),
    '4 own fit': dict(posterior=1e-6, j=1e-7, grad_zero=1e-6,
                      grad_uref=1e-4),
    '4 carried': dict(j=1e-8, grad_zero=1e-8, grad_uref=1e-5)}
# The per-scenario routes (phase 8c) against the stored JAX results: the
# port on the CPU reads controls within 2.4e-13 (Adam) and 1.4e-10 (the GP
# draws) of JAX's, costs within 7.4e-13 and 4.9e-12 relative, iterations
# equal; the bars leave the card's f64 arithmetic about two decades.
VMAP_U_ATOL = 1e-8
VMAP_COST_RTOL = 1e-9
# Phase 8c at full width, the per-scenario routes as one lockstep solve of
# all lanes: (b) solve_batch_gp over VMAP_LANES exact-GP draws (the headline
# data of seeds 0..255, f32, H = 20, gamma swept, L-BFGS 40 iterations at
# tol 1e-4) and (c) solve_batch's projected Adam on the headline (the Adam
# config of the stored reference), each timed graphed and reused over
# VMAP_REPS fresh-x0 batches and eager on the first (an eager call at B =
# 256 takes ~45 s: ~48,000 kernels a value-and-grad launched from Python);
# (b)'s f32 controls scored against f64 solves of the same lanes and x0s
# (VMAP_F64_LANES of them); the lanes route with a full
# covariance (its PSD clip through the eigensolver's vmap rule) at
# VMAP_FULL_COV_LANES lanes for VMAP_FULL_COV_ITERS iterations; (d)
# ROUTE_C_STEPS Adam control steps of the swing-up controller (route (c)).
VMAP_LANES = 256
VMAP_REPS = 2
VMAP_F64_LANES = 256
VMAP_FULL_COV_LANES = 64
VMAP_FULL_COV_ITERS = 5
ROUTE_C_STEPS = 4
# The uncertainty experiment (phase 8d) against the stored JAX results: on
# the CPU the port's controls read within 1.8e-6 of JAX's at gamma = -1
# after 112 iterations to JAX's 110 (the trace cancels and sigma_n = 1e-5
# leaves the objective flat; 1.4e-7 at gamma = 1e-5, 29 iterations to 29),
# its GP means 1.5e-6; the bar leaves the card almost two decades.
UNC_ATOL = 1e-4
# hs071's known optimum (tests/test_solver_oracle.py:35-36, 50-61's bars).
HS071_X_STAR = (1.00000000, 4.74299963, 3.82114998, 1.37940829)
HS071_F_STAR = 17.0140173


def phase_sparse_kernels(dev):
    """Phase 3d: K1 at the shapes of phase 8 (SPARSE_SHAPES), on the JAX
    kernel test's inputs with the padded rows zeroed: the f32 instance
    against the plain f64 version at that test's bars (forward and
    backward), both instances at check_conditioned's bars; then the f64
    instance timed at each (time_shapes: events, graph slope, plain, bound,
    launch plan). Returns (the set of (kernel, instance, B, N, d, E)
    checked, the max abs errors per shape, the timings)."""
    import torch
    rng = np.random.default_rng(17)
    fn, ref = trace_fns(True)
    checked, errs = set(), {}
    for b, n, n_valid, d, e in SPARSE_SHAPES:
        tag = f'K1 B={b} N={n} d={d} E={e}'
        ins = loop_inputs(rng, b, n, n_valid, d, e, True, dev)
        err = {'f32 bars': check_trace(f'{tag} ({n_valid} valid)', fn, ref,
                                       *ins)}
        for dtype, rtol in ((torch.float32, 5e-5), (torch.float64, 1e-12)):
            err[_DT_NAME[str(dtype)]] = check_conditioned(
                tag, fn, ref, *(t.detach() for t in ins[:4]), dtype, rtol)[0]
        errs[tag] = err
        checked |= {('K1', dt, b, n, d, e) for dt in ('f32', 'f64')}
        log(f'[sparse kernels] {tag} ({n_valid} valid rows): f32 vs plain '
            f'f64 max abs err {err["f32 bars"]:.3e} (fwd rtol 5e-5 atol 5e-5, '
            f'bwd rtol 2e-3 atol 2e-4); conditioned bar f32 {err["f32"]:.3e}, '
            f'f64 {err["f64"]:.3e} ok')
    times = time_shapes(dev, [('K1', *shape) for shape in SPARSE_SHAPES],
                        'sparse kernels', np.random.default_rng(19))
    return checked, errs, times


def eigh_bound_ms(a) -> tuple:
    """(ms, what bounds it, rotations, visits): the eigensolver's least time
    on this card for these inputs, the larger of its bytes (A read once, w
    and V written once) over the memory rate and its operations over the
    peak of its dtype, counting each arithmetic operation (sqrt and division
    included) as one: 8 a pair visit (the skip test), 16 d + 4 a rotation
    (the rotation and its update of a's two rows and V's two columns), as
    many as the plain version counts on these inputs (eigh_small.work),
    and d (d - 1) a matrix for the symmetrisation."""
    import torch
    from gpmpc_tpu_torch.ops.kernels import eigh_small
    d = a.shape[-1]
    n = a.numel() // (d * d)
    rotations, visits = eigh_small.work(a)
    flops = 8 * visits + (16 * d + 4) * rotations + n * d * (d - 1)
    f64 = a.dtype == torch.float64
    t_ops = flops / (PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
    t_bytes = n * (2 * d * d + d) * a.element_size() / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', rotations, visits)


@contextlib.contextmanager
def record_eigh_operands():
    """The operands of every eigensolver call in a block (the PSD clip's
    pre-clip covariances), copied contiguous, in a list."""
    import torch
    from gpmpc_tpu_torch.ops.kernels import eigh_small
    orig, seen = eigh_small.eigh, []

    def rec(a):
        seen.append(a.detach().clone(memory_format=torch.contiguous_format))
        return orig(a)

    eigh_small.eigh = rec
    try:
        yield seen
    finally:
        eigh_small.eigh = orig


def eigh_path_operands(dev) -> dict:
    """{(B, d): [(tag, operands (B, 2, 2)), ...]}: the pre-clip covariances
    the paths hand the eigensolver, from full-covariance rollouts at u = 0:
    the headline (f32, B = 256, 20 steps), config 4 (f32, B = 64, 50 steps),
    the lanes route (the headline's first VMAP_FULL_COV_LANES lanes, f32,
    20 steps of dynamics.rollout_lanes: what the eigensolver's vmap rule
    hands the kernel) and the swing-up controller's route (b) (f64, B = 1,
    H = 8, its stored transitions and trained hyperparameters, delta
    dynamics)."""
    import torch
    from gpmpc_tpu_torch.dynamics import (build_rollout_cache, rollout_batched,
                                          rollout_lanes)
    from gpmpc_tpu_torch.ops.kernels import eigh_small
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.problems import make_headline_problem, sparse_problem
    ref = np.load(CLOSED_LOOP_REF)
    mpc = RiskSensitiveMPC(
        gamma=0.0, horizon=8, state_dim=2, input_dim=1,
        Q=np.diag([8.0, 1.0]), R=0.001 * np.eye(1), capacity=512,
        delta_dynamics=True, dtype=torch.float64, device=dev)
    mpc.dynamics.append_train_data(ref['states'], ref['actions'],
                                   ref['next_states'])
    mpc.set_gp_hyperparams(lambdas=np.exp(ref['log_lambdas']),
                           sigma_f=np.exp(ref['log_sigma_f']),
                           sigma_n=np.exp(ref['log_sigma_n']))
    cases = (('headline f32', make_headline_problem(
                  b=256, dtype=torch.float32, device=dev), False),
             ('config 4 f32', sparse_problem('4_sparse_fullcov',
                                             dtype=torch.float32,
                                             device=dev), False))
    out = {}
    with torch.no_grad():
        for tag, p, delta in cases:
            with record_eigh_operands() as seen:
                rollout_batched(build_rollout_cache(p.gp, 2, 1), p.x0s,
                                p.x0s.new_zeros((p.x0s.shape[0], p.horizon,
                                                 1)), full_cov=True)
            out.setdefault((p.x0s.shape[0], 2), []).extend(
                (f'{tag} step {k + 1}', a) for k, a in enumerate(seen))
        lanes = make_headline_problem(b=VMAP_FULL_COV_LANES,
                                      dtype=torch.float32, device=dev)
        forward, seen = eigh_small._forward, []

        def rec(a):
            seen.append(a.detach().clone())
            return forward(a)

        eigh_small._forward = rec
        try:
            rollout_lanes(build_rollout_cache(lanes.gp, 2, 1), lanes.x0s,
                          lanes.x0s.new_zeros((VMAP_FULL_COV_LANES,
                                               lanes.horizon, 1)),
                          full_cov=True)
        finally:
            eigh_small._forward = forward
        out.setdefault((VMAP_FULL_COV_LANES, 2), []).extend(
            (f'lanes route f32 step {k + 1}', a) for k, a in enumerate(seen))
        x0 = torch.tensor(ref['ep_states'][1], dtype=torch.float64,
                          device=dev)[None]
        with record_eigh_operands() as seen:
            rollout_batched(build_rollout_cache(mpc.gp, 2, 1), x0,
                            x0.new_zeros((1, 8, 1)), full_cov=True,
                            delta=True)
        out[(1, 2)] = [(f'swing-up f64 step {k + 1}', a)
                       for k, a in enumerate(seen)]
    return out


def phase_eigh(dev):
    """Phase 3e: the small eigensolver (csrc/eigh_small.cu) against its
    plain version and torch.linalg.eigh (check_eigh's bars): on random
    symmetric matrices of every EIGH_KIND at each of EIGH_DIMS (256 of
    each), f32 and f64; on the operands the paths launch it on
    (eigh_path_operands, at EIGH_PATH_SHAPES). Then its time at
    EIGH_TIMED_SHAPES in both dtypes: by CUDA events around 200 launches,
    by the slope of CUDA-graph replays, beside its plain version's,
    torch.linalg.eigh's (library_ms; the port never calls it) and its bound
    on these inputs (eigh_bound_ms). Returns (the largest errors by shape,
    the times)."""
    import torch
    from gpmpc_tpu_torch.ops.kernels import eigh_small

    worst = {}

    def check(tag, key, a):
        w, v, _ = eigh_small.launch(a)
        r = check_eigh(tag, a, w, v, *eigh_small.eigh_reference(a))
        worst[key] = {k: max(x, worst.get(key, {}).get(k, 0.0))
                      for k, x in r.items()}

    for dtype in (torch.float32, torch.float64):
        for d in EIGH_DIMS:
            for kind in EIGH_KINDS:
                check(f'{kind} d={d} {dtype}',
                      f'random d={d} {_DT_NAME[str(dtype)]}',
                      torch.tensor(sym_inputs(kind, 256, d, dtype, seed=d),
                                   device=dev))
    log('[eigh] random definite, indefinite, near-degenerate and diagonal '
        'inputs, 256 each, d = ' + ', '.join(map(str, EIGH_DIMS))
        + ', f32 and f64: kernel vs plain version within '
        f'{EIGH_PLAIN_ULPS} ulps (max '
        f'{max(r["plain_ulps"] for r in worst.values()):.1f}), eigenvalues '
        f'vs torch.linalg.eigh, reconstruction and orthonormality within '
        f'{EIGH_BAR} d eps (max '
        f'{max(r["eig_vs_library"] for r in worst.values()):.2f}, '
        f'{max(r["reconstruction"] for r in worst.values()):.2f}, '
        f'{max(r["orthonormality"] for r in worst.values()):.2f}) ok')
    for shape, ops in eigh_path_operands(dev).items():
        if shape not in EIGH_PATH_SHAPES:
            raise AssertionError(f'eigh: a path launches it at {shape}, not '
                                 f'in EIGH_PATH_SHAPES')
        for tag, a in ops:
            key = f'path B={shape[0]} d={shape[1]} {_DT_NAME[str(a.dtype)]}'
            check(tag, key, a)
        log(f'[eigh] the paths\' operands at (B, d) = {shape}: '
            f'{len(ops)} launches ({ops[0][0]} ... {ops[-1][0]}), each at the '
            f'bars ok: {worst[key]}')
    times = {}
    for dtype in (torch.float32, torch.float64):
        for b, d in EIGH_TIMED_SHAPES:
            a = torch.tensor(sym_inputs('definite', b, d, dtype, seed=b + d),
                             device=dev)
            key = f'eigh {_DT_NAME[str(dtype)]} B={b} d={d}'
            ms = cuda_ms(lambda: eigh_small.launch(a), 200)
            g_ms = graph_ms({key: lambda: eigh_small.launch(a)}, dev)[key]
            plain = cuda_ms(lambda: eigh_small.eigh_reference(a), 5)
            lib = cuda_ms(lambda: torch.linalg.eigh(a), 50)
            bound, by, rotations, visits = eigh_bound_ms(a)
            times[key] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain,
                              library_ms=lib, bound=(bound, by),
                              rotations=rotations, visits=visits)
            log(f'[eigh] {key}: {ms:.4f} ms by events, {g_ms:.4f} ms by '
                f'graph slope, plain {plain:.4f} ms, torch.linalg.eigh '
                f'{lib:.4f} ms, bound {bound:.2e} ms ({by}; {rotations} '
                f'rotations, {visits} pair visits)')
    return worst, times


def assert_close_to_max(name, got, want, tol) -> float:
    """|got - want| <= tol max |want| entrywise; returns the largest
    |got - want| / max |want|."""
    got = got.detach().double().cpu().numpy()
    want = np.asarray(want)
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    if not rel <= tol:
        raise AssertionError(f'{name}: off by {rel:.3e} of its largest entry '
                             f'(bar {tol})')
    return rel


def sparse_objective_parity(tag, name, ref, dev, bars, carried=False):
    """The f64 objective of a sparse workload (problems.sparse_j64: the f64
    FITC posterior, the workload's covariance) and its gradient on every
    lane, at u = 0 and at the reference controls u_ref, against JAX's stored
    values: J at rtol bars['j']; the gradient within bars['grad_zero'] /
    bars['grad_uref'] of the largest gradient entry at 0 (at 3b's u_ref, an
    optimum of tol 1e-9, the gradient is a cancelling residual). The
    posterior is the port's own fit, its (W, alpha) within bars['posterior']
    of JAX's largest entry, or with `carried` JAX's stored (W, alpha) carried
    across (the rollout, cost and kernels alone). Exactly 2 H K1 f64
    launches (one forward rollout at each point; the backward launches
    none), and with full covariance 2 H of the eigensolver. Returns (j64,
    J64(u_ref), summary)."""
    import dataclasses
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    from gpmpc_tpu_torch.problems import (SPARSE_U_REF, SPARSE_WORKLOADS,
                                          sparse_j64, sparse_problem)
    p64 = sparse_problem(name, dtype=torch.float64, device=dev)
    out = {}
    if carried:
        gp = dataclasses.replace(p64.gp, kinv=as64(ref[f'{tag}_w'], dev),
                                 beta=as64(ref[f'{tag}_alpha'], dev))
        j64 = batch_objective(
            build_rollout_cache(gp, p64.state_dim, p64.action_dim), p64.x0s,
            p64.params, full_cov=SPARSE_WORKLOADS[name]['full_cov'])
    else:
        out['w_rel'] = assert_close_to_max(f'{tag} W', p64.gp.kinv,
                                           ref[f'{tag}_w'], bars['posterior'])
        out['alpha_rel'] = assert_close_to_max(f'{tag} alpha', p64.gp.beta,
                                               ref[f'{tag}_alpha'],
                                               bars['posterior'])
        j64 = sparse_j64(name, dev)
    u_ref = as64(np.load(SPARSE_U_REF.format(name))['u_ref'], dev)
    reset_counts()
    vals = {}
    for at, u0 in (('uref', u_ref), ('zero', torch.zeros_like(u_ref))):
        u = u0.clone().requires_grad_()
        j = j64(u)
        (g,) = torch.autograd.grad(j.sum(), u)
        vals[at] = (j.detach(), g)
    sync(dev)
    launches = read_counts()
    full_cov = SPARSE_WORKLOADS[name]['full_cov']
    want = {'K1 f64': 2 * p64.horizon, 'eigh': 2 * p64.horizon * full_cov}
    if dev.type == 'cuda' and any(v != want.get(k, 0)
                                  for k, v in launches.items()):
        raise AssertionError(f'{tag}: the f64 objective and gradient at two '
                             f'points launched {launches}, expected {want} '
                             f'(2 H K1 f64, and 2 H eigensolver launches '
                             f'with full covariance)')
    g_scale = float(np.abs(ref[f'{tag}_grad_zero']).max())
    for at, (j, g) in vals.items():
        j_want, g_want = ref[f'{tag}_j_{at}'], ref[f'{tag}_grad_{at}']
        assert_close(f'{tag} J64 at u_{at}', j, torch.tensor(j_want),
                     rtol=bars['j'], atol=0.0)
        assert_close(f'{tag} dJ64/du at u_{at}', g, torch.tensor(g_want),
                     rtol=0.0, atol=bars[f'grad_{at}'] * g_scale)
        out[f'j_rel_{at}'] = float(np.max(np.abs(j.cpu().numpy() / j_want
                                                 - 1)))
        out[f'grad_err_{at}'] = float(np.max(np.abs(g.cpu().numpy() - g_want))
                                      / g_scale)
    posterior = ("JAX's (W, alpha) carried across" if carried else
                 f'its own f64 fit (W, alpha {out["w_rel"]:.2e}, '
                 f'{out["alpha_rel"]:.2e} of the largest entry of JAX\'s, bar '
                 f'{bars["posterior"]})')
    log(f'[sparse {tag}] on {posterior}: J64 on {u_ref.shape[0]} lanes at u_ref'
        f' and 0 max rel err {out["j_rel_uref"]:.2e} / {out["j_rel_zero"]:.2e}'
        f' (rtol {bars["j"]}); dJ/du {out["grad_err_uref"]:.2e} / '
        f'{out["grad_err_zero"]:.2e} of max |g(0)| (bars {bars["grad_uref"]} '
        f'/ {bars["grad_zero"]}) ok; launches {launches}')
    return j64, vals['uref'][0], out


def phase_sparse_3b(dev, ref, jax_tpu):
    """Phase 8a: suite config 3b at full width (B = 256 cartpole lanes, the
    FITC GP of M = 128 over N = 1,000, (d, E) = (5, 4), H = 10, f32): the
    f64 parity, then the plain solve_batch at SPARSE_ITERS, counted (exactly
    H (1 + iters) K1 f64 launches and no other kernel), scored against the
    f64 reference controls (fails at p90 >= 1 %) and timed over fresh
    x0s, eager, graphed and reused in turns (counted_modes, time_solves),
    each key captured once over the reused calls."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import batch_objective, solve_batch
    from gpmpc_tpu_torch.problems import cost_excess, sparse_problem
    name = '3b_sparse_cartpole'
    j64, j_uref, parity = sparse_objective_parity('3b', name, ref, dev,
                                                  SPARSE_BARS['3b'])
    p = sparse_problem(name, dtype=torch.float32, device=dev)
    b = p.x0s.shape[0]
    with torch.no_grad():
        cost0 = batch_objective(build_rollout_cache(p.gp, 4, 1), p.x0s,
                                p.params)(p.x0s.new_zeros((b, p.horizon, 1)))
    cfg = SolverConfig(max_iters=SPARSE_ITERS, tol=1e-4)

    def solve(x0s):
        return solve_batch(p.gp, 4, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg)

    desc = f'solve_batch B={b} H={p.horizon} M=128 max_iters={SPARSE_ITERS}'
    want = {'LAUNCHES': p.horizon, 'LAUNCHES_F64': p.horizon}
    res_m, launches, loop_iters, capture = counted_modes(
        'sparse 3b', desc, solve, p.x0s, 'K1 f64', p.horizon, cost0, want)
    res = res_m['reused']
    quality = cost_excess(j64, res.u, j_uref)
    log(f'[sparse 3b] cost excess vs f64 u_ref: p50 {quality["p50"]:.4%} p90 '
        f'{quality["p90"]:.4%} max {quality["max"]:.4%}, lanes >1% '
        f'{quality["lanes_above_1pct"]}/{b} (the JAX package on a TPU v5e, '
        f'benchmarks/results/quality_sparse.json: p90 '
        f'{jax_tpu["excess_p90"]:.4%}, max {jax_tpu["excess_max"]:.4%}, '
        f'{jax_tpu["n_gt1pct"]} lanes)')
    if not quality['p90'] < SPARSE_P90_MAX:
        raise AssertionError(f'sparse 3b: p90 cost excess {quality["p90"]:.4%}'
                             f' not below {SPARSE_P90_MAX:.0%}')
    timed = time_solves('sparse 3b', b, solve, SPARSE_REPS, dev,
                        lambda rng: rng.uniform(-0.2, 0.2, (b, 4)),
                        modes=MODES)
    n, secs = reused_captures(timed['reused'])
    cache = cache_note('sparse 3b', 2 + n,
                       capture['reused']['capture_s'] + secs)
    return dict(launches=launches, loop_iters=loop_iters, quality=quality,
                parity=parity, capture=capture, cache=cache,
                **timed['reused'], eager=timed['eager'],
                graphed=timed['graphed'])


def phase_sparse_fullcov(dev, ref, jax_tpu):
    """Phase 8b: suite config 4 (B = 64, H = 50, the FITC GP of M = 128,
    (d, E) = (3, 2), gamma = -0.01, full covariance): the f64 objective and
    gradient at u_ref against JAX's; the f32 solve at FULLCOV_BITS_ITERS
    eager, graphed and reused, each counted (H (1 + iters) launches of K1
    f64 and of the eigensolver, no other kernel), equal to the bit; then
    the suite's FULLCOV_H50_ITERS-iteration solve as callers run it,
    counted the same way, its program's graphs H K1 f64 and H eigensolver
    launches a replay, timed in the three modes in turns, its cost excess
    recorded beside the JAX package's (no gate: the JAX package's own solve
    reads p50 347 % on a TPU, VERDICT.md)."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import batch_objective, solve_batch
    from gpmpc_tpu_torch.problems import cost_excess, sparse_problem
    name = '4_sparse_fullcov'
    parity = {'carried': sparse_objective_parity(
        '4', name, ref, dev, SPARSE_BARS['4 carried'], carried=True)[2]}
    j64, j_uref, parity['own fit'] = sparse_objective_parity(
        '4', name, ref, dev, SPARSE_BARS['4 own fit'])
    p = sparse_problem(name, dtype=torch.float32, device=dev)
    b = p.x0s.shape[0]
    with torch.no_grad():
        cost0 = batch_objective(build_rollout_cache(p.gp, 2, 1), p.x0s,
                                p.params, full_cov=True)(
            p.x0s.new_zeros((b, p.horizon, 1)))
    cfg = SolverConfig(max_iters=FULLCOV_H50_ITERS, tol=1e-4)

    def solve(x0s, iters=FULLCOV_H50_ITERS):
        return solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg.replace(max_iters=iters), full_cov=True)

    def desc(iters):
        return (f'solve_batch(full_cov=True) B={b} H={p.horizon} M=128 '
                f'max_iters={iters}')

    def bits_solve(x0s):
        return solve(x0s, FULLCOV_BITS_ITERS)

    want = {'LAUNCHES': p.horizon, 'LAUNCHES_F64': p.horizon,
            'LAUNCHES_EIGH': p.horizon}
    _, _, _, bits_capture = counted_modes(
        'sparse 4', desc(FULLCOV_BITS_ITERS), bits_solve, p.x0s, 'K1 f64',
        p.horizon, cost0, want, also=('eigh',))
    with capture_walls() as walls:
        (res, launches, loop_iters), wall = _timed(lambda: solve_checked(
            'sparse 4', desc(FULLCOV_H50_ITERS), solve, p.x0s, 'K1 f64', 1,
            p.horizon, cost0, also=('eigh',)), dev)
    capture = capture_note(walls, wall)
    if capture['replay_launches'] != [want] * 2:
        raise AssertionError(f'sparse 4: the graphs hold '
                             f'{capture["replay_launches"]} kernel launches '
                             f'a replay, expected two of {want}')
    timed = time_solves('sparse 4', b, solve, 1, dev,
                        lambda rng: p.x0s.cpu().numpy(), modes=MODES)
    n, secs = reused_captures(timed['reused'])
    cache = cache_note('sparse 4', 4 + n,
                       bits_capture['reused']['capture_s']
                       + capture['capture_s'] + secs)
    quality = cost_excess(j64, res.u, j_uref)
    log(f'[sparse 4] the program\'s graphs hold {want} launches a replay '
        f'ok; the first solve {wall:.3f} s ({b / wall:.2f} solves/s, its two '
        f'captures {1e3 * capture["capture_s"]:.1f} ms); then eager '
        f'{timed["eager"]["walls"][0]:.3f} s, graphed '
        f'{timed["graphed"]["walls"][0]:.3f} s, reused '
        f'{timed["reused"]["walls"][0]:.3f} s ('
        f'{1e3 * timed["reused"]["walls"][0] / (1 + loop_iters):.1f} ms a '
        f'value-and-grad); cost excess vs f64 '
        f'u_ref: p50 {quality["p50"]:.4%} p90 {quality["p90"]:.4%}, lanes >1%'
        f' {quality["lanes_above_1pct"]}/{b} (no gate; the JAX package at 40 '
        f'iterations on a TPU v5e: p50 {jax_tpu["excess_p50"]:.2%})')
    return dict(launches=launches, eigh_launches=launches,
                loop_iters=loop_iters, first_wall_s=wall, capture=capture,
                cache=cache, quality=quality, parity=parity,
                **timed['reused'], eager=timed['eager'],
                graphed=timed['graphed'])


def phase_vmap_routes(dev, ref):
    """Phase 8c: the per-scenario routes, each one lockstep solve of all
    its lanes on the single-scenario rollout mapped over the lanes. (a) In
    f64 against JAX's stored results, with no kernel launched: (1)
    solve_batch with projected Adam ('auto' -> 'vmap') on two headline
    lanes; (2) solve_batch_gp over stack_gps of three headline data draws;
    u within VMAP_U_ATOL, costs VMAP_COST_RTOL, iterations equal. (b)-(d)
    are phase_vmap_full."""
    import torch
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import (solve_batch, solve_batch_gp,
                                                stack_gps)
    from gpmpc_tpu_torch.problems import make_headline_problem
    cfgs = json.loads(str(ref['configs']))
    hp = make_headline_problem(b=256, dtype=torch.float64, device=dev)
    lanes = torch.as_tensor(ref['adam_lanes'], device=dev)
    gps = stack_gps([make_headline_problem(b=1, dtype=torch.float64,
                                           seed=int(s), device=dev).gp
                     for s in ref['gp_seeds']])
    runs = {
        'adam': lambda: solve_batch(
            hp.gp, 2, 1, hp.x0s[lanes], hp.params._replace(
                gamma=hp.params.gamma[lanes]), hp.horizon, hp.lb, hp.ub,
            SolverConfig(**cfgs['adam'])),
        'gp': lambda: solve_batch_gp(
            gps, 2, 1, hp.x0s[:len(ref['gp_seeds'])], hp.params._replace(
                gamma=as64(cfgs['gp_gammas'], dev)), hp.horizon, hp.lb,
            hp.ub, SolverConfig(**cfgs['gp_solver']))}
    out = {}
    for key, run in runs.items():
        reset_counts()
        res, wall = _timed(run, dev)
        launches = read_counts()
        if any(launches.values()):
            raise AssertionError(f'vmap route {key}: launched {launches}')
        u_err = assert_close(f'vmap {key} u', res.u, torch.tensor(
            ref[f'{key}_u']), rtol=0.0, atol=VMAP_U_ATOL)
        assert_close(f'vmap {key} cost', res.cost,
                     torch.tensor(ref[f'{key}_cost']), rtol=VMAP_COST_RTOL,
                     atol=0.0)
        cost_rel = float(np.max(np.abs(res.cost.cpu().numpy()
                                       / ref[f'{key}_cost'] - 1)))
        iters = res.iters.cpu().numpy()
        if not np.array_equal(iters, ref[f'{key}_iters']):
            raise AssertionError(f'vmap {key}: iterations {iters}, JAX '
                                 f'{ref[f"{key}_iters"]}')
        out[key] = dict(u_max_abs_err=u_err, cost_rel_err=cost_rel,
                        iters=iters.tolist(), wall_s=wall)
        log(f'[vmap {key}] {len(iters)} lanes: u max abs err vs JAX {u_err:.2e}'
            f' (atol {VMAP_U_ATOL}), costs {cost_rel:.2e} (rtol '
            f'{VMAP_COST_RTOL}), iterations {iters.tolist()} equal ok; no '
            f'kernel launched; {wall:.3f} s (one lockstep solve of its '
            'lanes)')
    return out


def phase_vmap_full(dev, ref):
    """Phase 8c at full width (the constants above): (b) solve_batch_gp
    over 256 GP draws, (c) Adam on the headline, the lanes route with a
    full covariance, (d) route (c)'s control steps."""
    cfgs = json.loads(str(ref['configs']))
    return dict(gp_full=phase_vmap_gp_full(dev),
                adam_full=phase_vmap_adam_full(dev, cfgs['adam']),
                full_cov=phase_vmap_full_cov(dev),
                route_c=phase_route_c(dev, cfgs['adam']))


def _program_nodes() -> dict:
    """The kernel nodes of each graph of the one kept program: what a
    replay of its init (one value-and-grad and the solver's init), step
    (one value-and-grad and an iteration) and polish (one value-and-grad
    and a polish step) graphs launches."""
    from gpmpc_tpu_torch.mpc import solver
    (prog,) = solver._PROGRAMS.values()
    out = {'init': prog.init_counts, 'step': prog.step_counts}
    if prog.polish is not None:
        out['polish'] = prog.polish_counts
    return {k: sum(c.names.values()) for k, c in out.items()}


def timed_lanes_route(tag, b, solve, x0s, dev):
    """A per-scenario route at full width, the counts set to 0 just before
    and read just after (no kernel may launch): a first call on x0s as the
    callers run it (it captures the program), then 'graphed' and 'reused'
    in turns over VMAP_REPS fresh-x0 batches, then 'eager' beside 'reused'
    on the first of them (time_solves: every batch equal to the bit across
    the modes); each key captured once (the first call's captures are the
    program's graphs); the program's bytes and its graphs' kernel nodes.
    Returns (result on x0s, the record)."""
    from gpmpc_tpu_torch.mpc import solver
    solver.clear_programs()
    reset_counts()
    with capture_walls() as walls:
        first, first_s = _timed(lambda: solve(x0s), dev)
    timed = time_solves(tag, b, solve, VMAP_REPS, dev,
                        modes=('graphed', 'reused'))
    timed['eager'] = time_solves(f'{tag} eager', b, solve, 1, dev,
                                 modes=('eager', 'reused'))['eager']
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f'{tag}: launched {launches}')
    n, secs = reused_captures(timed['reused'])
    if n:
        raise AssertionError(f'{tag}: the timed reused calls captured {n} '
                             'graphs, expected none')
    capture_s = sum(w for w, _ in walls)
    cache = cache_note(tag, len(walls), capture_s)
    nodes = _program_nodes()
    log(f'[{tag}] no kernel launched ok; kernel nodes a replay: {nodes}; '
        f'the first call {first_s:.2f} s (its {len(walls)} captures '
        f'{capture_s:.2f} s); solves/s eager (one batch) '
        f'{timed["eager"]["solves_per_s"]:.2f}, graphed '
        f'{timed["graphed"]["solves_per_s"]:.2f}, reused '
        f'{timed["reused"]["solves_per_s"]:.2f}; program '
        f'{cache["bytes"] / 2 ** 30:.2f} GiB '
        f'({cache["pool_bytes"] / 2 ** 30:.2f} GiB of graph pools)')
    return first, dict(timed, first_s=first_s, cache=cache,
                       graph_kernel_nodes=nodes)


def _gp_draws(b, dtype, dev):
    """stack_gps of the headline GP of seeds 0..b-1 (N = 200 in capacity
    256, ds = 2, da = 1, E = 2): one exact GP a lane."""
    from gpmpc_tpu_torch.parallel.batch import stack_gps
    from gpmpc_tpu_torch.problems import make_headline_problem
    return stack_gps([make_headline_problem(b=1, seed=s, dtype=dtype,
                                            device=dev).gp
                      for s in range(b)])


def phase_vmap_gp_full(dev):
    """Phase 8c (b): solve_batch_gp over VMAP_LANES GP draws at full width
    (timed_lanes_route), then the f32 controls of its first call (the
    headline's x0s) scored under the f64 objective of the same lanes
    against f64 solves of the same lanes and x0s (cost_excess: p50, p90,
    max, lanes above 1 %)."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import lanes_objective, solve_batch_gp
    from gpmpc_tpu_torch.problems import cost_excess, make_headline_problem
    b = VMAP_LANES
    t0 = time.perf_counter()
    gps = _gp_draws(b, torch.float32, dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    hp = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=ITERS, tol=1e-4)

    def solve(x0s):
        return solve_batch_gp(gps, 2, 1, x0s, hp.params, hp.horizon, hp.lb,
                              hp.ub, cfg)

    log(f'[vmap gp full] {b} GP draws built and stacked in {build_s:.1f} s')
    res32, out = timed_lanes_route('vmap gp full', b, solve, hp.x0s, dev)
    out['draws_build_s'] = build_s
    solver.clear_programs()

    # f32 quality: the f64 solve of the same lanes and x0s, and the f64
    # objective of the same lanes at both controls.
    m = VMAP_F64_LANES
    gps64 = _gp_draws(m, torch.float64, dev)
    x0s64 = hp.x0s[:m].double()
    p64 = hp.params._replace(**{k: getattr(hp.params, k).double()
                                for k in ('Q', 'R', 'x_ref', 'u_ref')},
                             gamma=hp.params.gamma[:m].double())
    res64, wall64 = _timed(lambda: solve_batch_gp(
        gps64, 2, 1, x0s64, p64, hp.horizon, hp.lb, hp.ub, cfg), dev)
    stats64 = solver.program_stats()
    solver.clear_programs()
    j64 = lanes_objective(build_rollout_cache(gps64, 2, 1), x0s64, p64)
    quality = cost_excess(j64, res32.u[:m], res64.cost)
    out['f32_quality'] = dict(quality, lanes=m, f64_wall_s=wall64,
                              f64_program_bytes=stats64['bytes'])
    log(f'[vmap gp full] f32 controls vs f64 solves of the same {m} lanes '
        f'and x0s (J64): p50 {quality["p50"]:.4%} p90 {quality["p90"]:.4%} '
        f'max {quality["max"]:.4%}, lanes >1% {quality["lanes_above_1pct"]}'
        f'/{m}; the f64 solve {wall64:.1f} s, its program '
        f'{stats64["bytes"] / 2 ** 30:.2f} GiB')
    return out


def phase_vmap_adam_full(dev, adam_cfg):
    """Phase 8c (c): solve_batch with projected Adam ('auto' -> the lanes
    route) on the headline (B = 256, f32), the stored reference's Adam
    config, timed_lanes_route."""
    import torch
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    hp = make_headline_problem(b=VMAP_LANES, dtype=torch.float32, device=dev)
    cfg = SolverConfig(**adam_cfg)

    def solve(x0s):
        return solve_batch(hp.gp, 2, 1, x0s, hp.params, hp.horizon, hp.lb,
                           hp.ub, cfg)

    return timed_lanes_route('vmap adam full', VMAP_LANES, solve, hp.x0s,
                             dev)[1]


def phase_vmap_full_cov(dev):
    """Phase 8c: solve_batch(impl='vmap', full_cov=True) on the headline's
    first VMAP_FULL_COV_LANES lanes (f32, VMAP_FULL_COV_ITERS iterations),
    counted: its PSD clip reaches the eigensolver through the kernel's vmap
    rule, exactly H launches at (B, 2, 2) a value-and-grad and no other
    kernel; eager and reused equal to the bit."""
    import torch
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    b = VMAP_FULL_COV_LANES
    hp = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=VMAP_FULL_COV_ITERS, tol=1e-4)
    res, launches = {}, {}
    for mode in ('eager', 'reused'):
        solver.clear_programs()
        with loop_mode(mode):
            reset_counts()
            res[mode], wall = _timed(lambda: solve_batch(
                hp.gp, 2, 1, hp.x0s, hp.params, hp.horizon, hp.lb, hp.ub,
                cfg, full_cov=True, impl='vmap'), dev)
            launches[mode] = read_counts()
        iters = int(res[mode].iters.max())
        want = {k: (hp.horizon * (1 + iters) if k == 'eigh' else 0)
                for k in launches[mode]}
        if launches[mode] != want:
            raise AssertionError(f'vmap full_cov {mode}: launched '
                                 f'{launches[mode]}, expected {want}')
        log(f'[vmap full_cov] {mode}: B={b} H={hp.horizon} {iters} '
            f'iterations, {launches[mode]["eigh"]} eigensolver launches '
            f'(H a value-and-grad, at ({b}, 2, 2)) and no other kernel ok; '
            f'{wall:.2f} s')
    solver.clear_programs()
    same_bits('vmap full_cov eager vs reused', res['eager'], res['reused'])
    if not bool(torch.isfinite(res['reused'].cost).all()):
        raise AssertionError('vmap full_cov: a cost is not finite')
    return dict(eigh_launches=launches['reused']['eigh'],
                launches=launches, iters=iters)


def phase_route_c(dev, adam_cfg):
    """Phase 8c (d): the controller's route (c) over ROUTE_C_STEPS Adam
    control steps of the swing-up controller (phase 7b's: f64, N = 512,
    delta dynamics, its stored transitions and trained hyperparameters; the
    stored reference's Adam config), the pendulum stepped and each
    transition appended between steps: the first step captures its
    program's three graphs, the later steps nothing; no kernel launched;
    each step's wall."""
    import torch
    from gpmpc_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.sim.simulator import Simulator
    ref = np.load(CLOSED_LOOP_REF)
    params = PendulumParams(g=10.0, max_torque=5.0)
    mpc = RiskSensitiveMPC(
        gamma=0.0, horizon=8, state_dim=2, input_dim=1,
        Q=np.diag([8.0, 1.0]), R=0.001 * np.eye(1),
        R_delta=0.001 * np.eye(1), capacity=512, delta_dynamics=True,
        dtype=torch.float64, solver=SolverConfig(**adam_cfg), device=dev)
    mpc.set_ub([params.max_torque])
    mpc.set_lb([-params.max_torque])
    mpc.dynamics.append_train_data(ref['states'], ref['actions'],
                                   ref['next_states'])
    mpc.set_gp_hyperparams(lambdas=np.exp(ref['log_lambdas']),
                           sigma_f=np.exp(ref['log_sigma_f']),
                           sigma_n=np.exp(ref['log_sigma_n']))
    env = PendulumEnv(params=params, device=dev,
                      init_state={'th_init': 1.0, 'thdot_init': 0.5})
    solver.clear_programs()
    reset_counts()
    per_step = []
    orig = mpc.get_optimal_trajectory

    def step(x):
        with capture_walls() as walls:
            u = orig(x)
        per_step.append(len(walls))
        return u

    mpc.get_optimal_trajectory = step
    ep = Simulator(mpc, env, num_iters=ROUTE_C_STEPS).run()
    launches = read_counts()
    solver.clear_programs()
    if per_step != [3] + [0] * (ROUTE_C_STEPS - 1):
        raise AssertionError(f'route (c): captures a step {per_step}, '
                             'expected 3 at the first and none after')
    if any(launches.values()):
        raise AssertionError(f'route (c): launched {launches}')
    if not (np.isfinite(ep.actions).all() and np.isfinite(ep.costs).all()):
        raise AssertionError('route (c): a non-finite action or cost')
    log(f'[route c] {ROUTE_C_STEPS} Adam steps of the swing-up controller: '
        f'captures a step {per_step} (the first step captures its program, '
        f'the later steps replay it) ok; no kernel launched; step walls '
        f'{[round(w, 4) for w in ep.solve_times.tolist()]} s; iterations '
        f'{ep.iters.tolist()}')
    return dict(captures=per_step, solve_s=ep.solve_times.tolist(),
                iters=ep.iters.tolist(), actions=ep.actions.tolist())


def phase_uncertainty(dev, ref):
    """Phase 8d: experiments/uncertainty.py at its published settings on
    the card, each gamma counted: exactly H (1 + iters) K1 f64 launches (the
    controller's B = 1 route), its controls and GP means along them within
    UNC_ATOL of JAX's stored f64 results, its iterations beside JAX's.
    Returns the summary and the gamma = -1 controller."""
    from gpmpc_tpu_torch.experiments.uncertainty import uncertainty_experiment
    out, mpc = {}, None
    for k, gamma in enumerate(ref['unc_gammas']):
        reset_counts()
        res, wall = _timed(lambda: uncertainty_experiment(
            gammas=(float(gamma),), verbose=False, device=dev), dev)
        r = res[float(gamma)]
        launches = read_counts()
        horizon = r['u'].shape[0]
        if dev.type == 'cuda' and (
                launches['K1 f64'] != horizon * (1 + r['iters']) or any(
                    v for key, v in launches.items() if key != 'K1 f64')):
            raise AssertionError(f'uncertainty gamma={gamma}: launches '
                                 f'{launches}, iters {r["iters"]}')
        u_err = float(np.max(np.abs(r['u'] - ref['unc_u'][k])))
        m_err = float(np.max(np.abs(r['expected'] - ref['unc_expected'][k])))
        if not (u_err <= UNC_ATOL and m_err <= UNC_ATOL):
            raise AssertionError(f'uncertainty gamma={gamma}: u off JAX by '
                                 f'{u_err:.3e}, means by {m_err:.3e} (atol '
                                 f'{UNC_ATOL})')
        out[str(float(gamma))] = dict(
            wall_s=wall, iters=r['iters'], jax_iters=int(ref['unc_iters'][k]),
            u_max_abs_err=u_err, means_max_abs_err=m_err, **launches)
        if k == 0:
            mpc, u_first = r['mpc'], r['u']
        log(f'[uncertainty] gamma={gamma}: {wall:.3f} s with the fit, '
            f'{r["iters"]} iterations (JAX {int(ref["unc_iters"][k])}), K1 f64 '
            f'{launches["K1 f64"]} = H (1 + iters) ok; u vs JAX max abs err '
            f'{u_err:.2e}, means {m_err:.2e} (atol {UNC_ATOL}) ok')
    return out, mpc, u_first


def phase_aux(dev, mpc, u_mpc, out_dir):
    """Phase 8e: hs071 by solve_constrained in f64 on the card (x* and f*
    within 1e-5, violations below 1e-7); checkpoint round trips on the card
    (the uncertainty controller's GP, every array equal, and the controller,
    whose resumed solve is within UNC_ATOL of its last controls: on this
    flat objective two identical solves on the CPU's 4 threads differ by
    1.8e-7, the reductions' order); and
    native.solve_box built into gpmpc_tpu_torch/_build/ on the integrator
    objective (u within 1e-4 of the bound -1 on the first four steps, and
    within 5e-3 of solve_trajectory's)."""
    import torch
    from gpmpc_tpu_torch import native
    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout
    from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
    from gpmpc_tpu_torch.mpc.constrained import solve_constrained
    from gpmpc_tpu_torch.mpc.controller import single_cost
    from gpmpc_tpu_torch.mpc.cost import CostParams
    from gpmpc_tpu_torch.mpc.solver import SolverConfig, solve_trajectory
    from gpmpc_tpu_torch.utils import checkpoint
    out = {}

    def no_launch(part):
        launches = read_counts()
        if any(launches.values()):
            raise AssertionError(f'{part} launched {launches}')

    reset_counts()

    def hs071(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    res, wall = _timed(lambda: solve_constrained(
        hs071, as64([1.0, 5.0, 5.0, 1.0], dev), 1.0, 5.0,
        eq_con=lambda x: (torch.sum(x * x) - 40.0)[None],
        ineq_con=lambda x: (x[0] * x[1] * x[2] * x[3] - 25.0)[None],
        config=SolverConfig(max_iters=200, tol=1e-10), outer_iters=15), dev)
    x_err = float(np.max(np.abs(res.u.cpu().numpy() - HS071_X_STAR)))
    f_err = abs(float(res.cost) - HS071_F_STAR)
    if not (x_err < 1e-5 and f_err < 1e-5 and float(res.eq_viol) < 1e-7
            and float(res.ineq_viol) < 1e-7 and res.u.device.type == dev.type):
        raise AssertionError(f'hs071: {res}')
    no_launch('hs071')
    out['hs071'] = dict(x_err=x_err, f_err=f_err, eq_viol=float(res.eq_viol),
                        ineq_viol=float(res.ineq_viol), wall_s=wall)
    log(f'[aux] hs071 by solve_constrained on {dev}: |x - x*| {x_err:.2e}, '
        f'|f - f*| {f_err:.2e} (< 1e-5), violations {float(res.eq_viol):.1e}'
        f' / {float(res.ineq_viol):.1e} (< 1e-7) ok; {wall:.3f} s')

    base = os.path.join(out_dir, 'checkpoint', 'uncertainty')
    checkpoint.save_controller(base, mpc)
    gp2 = checkpoint.load_gp(base + '.gp.npz', device=dev)
    for f in checkpoint._ARRAY_FIELDS:
        a, b = getattr(gp2, f), getattr(mpc.gp, f)
        if a.device.type != dev.type or not torch.equal(a, b):
            raise AssertionError(f'checkpoint: GP field {f} changed')
    mpc2 = checkpoint.load_controller(base, device=dev)
    reset_counts()
    u2 = mpc2.get_optimal_trajectory(np.array([4.0, -4.0]))
    launches = read_counts()
    want = mpc2.horizon * (1 + int(mpc2.last_result.iters))
    ck_err = float(np.max(np.abs(u2 - u_mpc)))
    if not (ck_err <= UNC_ATOL and mpc2.gamma == mpc.gamma
            and np.array_equal(mpc2.last_traj, u2)):
        raise AssertionError(f'checkpoint: the resumed solve is off by '
                             f'{ck_err:.3e}')
    if dev.type == 'cuda' and (launches['K1 f64'] != want or any(
            v for k, v in launches.items() if k != 'K1 f64')):
        raise AssertionError(f'checkpoint: the resumed solve launched '
                             f'{launches}, expected {want} K1 f64')
    out['checkpoint'] = dict(resumed_u_err=ck_err, **launches)
    log(f'[aux] checkpoint of the uncertainty controller on {dev}: every GP '
        f'array equal, the resumed solve within {ck_err:.1e} of its controls '
        f'ok; launches {launches}')
    reset_counts()

    rng = np.random.default_rng(0)
    s = rng.uniform(-10, 10, (60, 1))
    a = rng.uniform(-1, 1, (60, 1))
    gp = make_gp(GPConfig(capacity=64, x_dim=2, out_dim=1),
                 np.concatenate([s, a], 1), s + a,
                 log_lambdas=np.log([2.0, 2.0]), log_sigma_f=np.log(3.0),
                 log_sigma_n=np.log(1e-4), dtype=torch.float64, device=dev)
    cache = build_rollout_cache(gp, 1, 1)
    params = CostParams(Q=2 * torch.eye(1, dtype=torch.float64, device=dev),
                        R=torch.zeros((1, 1), dtype=torch.float64, device=dev),
                        gamma=as64(1e-5, dev), x_ref=as64([0.0], dev),
                        u_ref=as64([0.0], dev))
    x0 = as64([5.0], dev)

    def obj(u):
        m, c = rollout(cache, x0, u)
        return single_cost(params, m, c, u)

    def fg(u_flat):
        u = as64(u_flat, dev).reshape(5, 1).requires_grad_()
        v = obj(u)
        (g,) = torch.autograd.grad(v, u)
        return float(v.detach()), g.cpu().numpy().ravel()

    built = not native.library_path().exists()
    build_s = _timed(native.build, dev)[1]
    res_n, wall = _timed(lambda: native.solve_box(
        fg, np.zeros(5), -np.ones(5), np.ones(5), max_iters=200, tol=1e-8),
        dev)
    res_p = solve_trajectory(obj, torch.zeros((5, 1), dtype=torch.float64,
                                              device=dev), -1.0, 1.0,
                             SolverConfig(max_iters=400, tol=1e-6))
    p_err = float(np.max(np.abs(res_p.u.cpu().numpy().ravel() - res_n.x)))
    if not (np.max(np.abs(res_n.x[:4] + 1.0)) < 1e-4 and p_err < 5e-3
            and native.library_path().parent.name == '_build'):
        raise AssertionError(f'native: {res_n}, solve_trajectory off by '
                             f'{p_err}')
    no_launch('native')
    out['native'] = dict(x=res_n.x.tolist(), iterations=res_n.iterations,
                         vs_solve_trajectory=p_err, built=built,
                         build_s=build_s, wall_s=wall)
    log(f'[aux] native.solve_box ({"built" if built else "found"} in '
        f'{native.library_path().parent}, {build_s:.2f} s) on the integrator '
        f'objective: u '
        f'{np.round(res_n.x, 6).tolist()}, {res_n.iterations} iterations, '
        f'solve_trajectory within {p_err:.1e} ok; no kernel launched')
    return out


def phase_sparse(dev, checked, out_dir):
    """Phase 8: the sparse GP, the per-scenario routes and the remaining
    modules, each part with the counts set to 0 just before it and read just
    after, every K1 launch at a shape phase 3d checked: (a) config 3b, (b)
    config 4, (c) the per-scenario routes (against JAX's stored results,
    then at full width), (d) the uncertainty experiment, (e) hs071,
    checkpoints and the native solver."""
    from gpmpc_tpu_torch.problems import SPARSE_REF_FILE
    ref = np.load(SPARSE_REF_FILE)
    with open(os.path.join(ROOT, 'benchmarks', 'results',
                           'quality_sparse.json')) as f:
        jax_tpu = json.load(f)
    out = {}
    t_phase = time.perf_counter()
    with record_launch_shapes() as shapes:
        for key, fn in (('3b', lambda: phase_sparse_3b(
                dev, ref, jax_tpu['3b_sparse_cartpole'])),
                        ('4', lambda: phase_sparse_fullcov(
                            dev, ref, jax_tpu['4_sparse_fullcov'])),
                        ('vmap', lambda: phase_vmap_routes(dev, ref)),
                        ('vmap_full', lambda: phase_vmap_full(dev, ref))):
            t0 = time.perf_counter()
            out[key] = fn()
            out[key + '_phase_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['uncertainty'], mpc, u_mpc = phase_uncertainty(dev, ref)
        out['uncertainty_phase_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['aux'] = phase_aux(dev, mpc, u_mpc, out_dir)
        out['aux_phase_s'] = time.perf_counter() - t0
    unchecked = {k: v for k, v in shapes.items() if k not in checked}
    if unchecked or not shapes:
        raise AssertionError(f'phase 8: K1/K2 launched at shapes phase 3d did '
                             f'not check: {unchecked}')
    out['launch_shapes'] = {' '.join(map(str, k)): v for k, v in shapes.items()}
    out['wall_s'] = time.perf_counter() - t_phase
    log(f'[sparse] calls by (kernel, instance, B, N, d, E), each checked in '
        f'phase 3d ok: {out["launch_shapes"]}; phase {out["wall_s"]:.1f} s')
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'chip_smoke_out'),
                    help='directory for the run summary and the profiler '
                         'table')
    # One rank of phase 6b (chip_smoke starts these itself).
    ap.add_argument('--shard-worker', action='store_true',
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    out_dir = args.out
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 2
    if args.shard_worker:
        shard_worker(out_dir)
        return 0
    from gpmpc_tpu_torch.benchmarks.chain import card_line
    from gpmpc_tpu_torch.benchmarks.recipe_quality import k1_f32, tied_trace
    from gpmpc_tpu_torch.device import resolve_device
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.ops.kernels import _build
    from gpmpc_tpu_torch.problems import REF_FILE, make_headline_problem

    t_start = time.perf_counter()
    dev = resolve_device('cuda')
    card = card_line()
    props = torch.cuda.get_device_properties(dev)
    clock = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                            '--format=csv,noheader,nounits'],
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.strip().splitlines()[0]
    log(f'[device] {card}; {props.multi_processor_count} SMs, max SM clock '
        f'{clock} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}')

    build_s, each_s = _build.build_all()
    log(f'[build] nvcc built the kernels in {build_s:.1f} s ('
        + ', '.join(f'{k} {v:.1f} s' for k, v in each_s.items()) + ')')
    sass = phase_sass()
    sass['res_usage'] = phase_res_usage()

    b = 256
    f32, f64 = torch.float32, torch.float64
    cache = build_rollout_cache(
        make_headline_problem(b=b, dtype=f32, device=dev).gp, 2, 1)
    checks, precision = phase_kernels(dev, b, 200, cache)
    loop_checked, loop_errs, loop_lanes = phase_loop_kernels(dev)
    loop_times = time_loop_kernels(dev, loop_lanes)
    sparse_checked, sparse_errs, sparse_times = phase_sparse_kernels(dev)
    eigh_errs, eigh_times = phase_eigh(dev)
    times = {dt: time_kernels(dev, b, cache, 50, dt) for dt in (f32, f64)}
    k1_f64_wide = time_k1_f64_wide(dev, RECIPE_WIDTHS[-1], cache)
    k1_instr = instr_bound_ms(b, cache.x.shape[0], 3, cache.b_lam.shape[0],
                              props, float(clock))
    log(f'[kernels] K1 instruction-rate estimate from {props.multi_processor_count}'
        f' SMs x 128 lanes at {clock} MHz: {k1_instr:.4f} ms')
    probe_checks, probes, probe_launches, probe_plain = phase_probes(
        dev, b, 200, cache, reps=50)

    ref = np.load(REF_FILE)
    j64, j_uref, obj = phase_objective(dev, ref, b)
    solve = phase_solve(dev, b, j64, j_uref, reps=3)
    with tied_trace(k1_f32):
        solve_f32 = phase_solve(dev, b, j64, j_uref, reps=1,
                                tag='solve k1_f32', key='K1 f32')
    untied_launches = phase_untied(dev, b)
    os.makedirs(out_dir, exist_ok=True)
    graph = phase_graph(dev, b, card, out_dir)
    prof = phase_profile(dev, b, out_dir)
    recipe = phase_recipe(dev, b, j64, j_uref, card)
    full_cov = phase_full_cov(dev, b, ref, card, out_dir)
    with sym_opt_in():
        sym_solve = phase_solve(dev, b, j64, j_uref, reps=3, tag='sym solve',
                                key='K4')
        sym_untied_launches = phase_untied(dev, b, key='K4')
        sym_solve['profile'] = phase_profile(dev, b, out_dir, 'sym solve',
                                             'rw_sym')
    sharded_11 = phase_sharded_11(dev, b, j64, j_uref, reps=3, out_dir=out_dir)
    sharded_12 = phase_sharded_12(dev, b, ref, out_dir)
    loop = phase_closed_loop(dev, loop_checked, CLOSED_LOOP_REF, out_dir)
    sparse = phase_sparse(dev, sparse_checked, out_dir)

    # One row a kernel instance that a path launches: K1's f32 instance (the
    # k1_f32 solve) and its f64 instance (the recipe, the main path); K2-K4
    # launch their f64 instances, by the precision policy.
    kernels = []
    for key, dt, fn, src, line, launches in (
            ('K1', f32, 'rw_tied f32 instance (variance_trace_batched_tied, '
             'native=True; launches: the k1_f32 plain solve)', SOURCE, 638,
             solve_f32['launches']),
            ('K1', f64, 'rw_tied f64 instance (variance_trace_batched_tied '
             'under the precision policy; the FP64 tensor-core body of '
             'csrc/rw_tied_f64_body.cuh where B fills its S; launches: the '
             'recipe solve)', SOURCE_F64, 638, recipe['launches']),
            ('K2', f64, 'rw_untied f64 instance (variance_trace_batched)',
             SOURCE_F64, 214, untied_launches),
            ('K3', f64, 'rw_tied_block f64 instance '
             '(variance_trace_tied_block)', SOURCE_F64, 598,
             sharded_11['launches']),
            ('K4 tied', f64, 'rw_sym shared chain, f64 instance '
             '(GPMPC_SYM_KERNEL=1)', SYM_SOURCE_F64, 527,
             sym_solve['launches']),
            ('K4 per-output', f64, 'rw_sym per output, f64 instance '
             '(GPMPC_SYM_KERNEL=1)', SYM_SOURCE_F64, 527,
             sym_untied_launches)):
        t = times[dt][key]
        kernels.append(dict(
            name=f'{key} {fn}', route='cuda', source=src,
            replaces=f'{TPU_FILE}:{line}', launches=launches,
            max_abs_err=checks[key][dt == f64], ms=t['ms'],
            plain_ms=t['plain_ms'], bound_ms=t['bound'][0],
            bound_by=t['bound'][1], library_ms=None))
    # The closed loop's rows (phase 7): each f64 instance at the shape its
    # part launches it at, with that part's launches.
    for key, shape, part, count, line in (
            ('K1', 'B=1 N=128 d=2 E=1', 'the integrator', 'K1', 638),
            ('K2', 'B=1 N=512 d=3 E=2', 'the pendulum swing-up', 'k2', 214),
            ('K2', 'B=1 N=512 d=5 E=4', 'the cartpole', 'k2', 214)):
        t = loop_times[f'{key} f64 {shape}']
        launches = {'K1': loop['integrator']['K1'],
                    'k2': loop['swing_up' if 'pendulum' in part
                               else 'pretrain_cartpole']['k2']}[count]
        kernels.append(dict(
            name=f'{key} f64 instance, closed loop ({part}, {shape})',
            route='cuda', source=SOURCE_F64, replaces=f'{TPU_FILE}:{line}',
            launches=launches, max_abs_err=loop_errs[f'{key} {shape}']['f64'],
            ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound'][0],
            bound_by=t['bound'][1], library_ms=None))
    # Phase 8's rows: K1's f64 instance at each shape of phase 8, with the
    # launches of the part that runs it there.
    for (b, n, _, d, e), part, launches in zip(
            SPARSE_SHAPES, ('suite config 3b, the sparse cartpole solve',
                            'suite config 4, the full-covariance H = 50 solve',
                            'the uncertainty experiment, both gammas'),
            (sparse['3b']['launches'], sparse['4']['launches'],
             sum(r['K1 f64'] for r in sparse['uncertainty'].values()))):
        shape = f'B={b} N={n} d={d} E={e}'
        t = sparse_times[f'K1 f64 {shape}']
        kernels.append(dict(
            name=f'K1 f64 instance, phase 8 ({part}, {shape})', route='cuda',
            source=SOURCE_F64, replaces=f'{TPU_FILE}:638', launches=launches,
            max_abs_err=sparse_errs[f'K1 {shape}']['f64'], ms=t['ms'],
            plain_ms=t['plain_ms'], bound_ms=t['bound'][0],
            bound_by=t['bound'][1], library_ms=None))
    # The eigensolver's rows (phase 3e): its instance at each shape a path
    # launches it at, with that path's launches (phase 7b's over its eager,
    # graphed and reused full-covariance steps).
    loop_full = loop['swing_up']['graph_step_full_cov']
    for (bb, d), dt, part, launches in (
            ((256, 2), f32, 'the headline full-covariance solve, phase 5e',
             full_cov['eigh_launches']),
            ((64, 2), f32, 'suite config 4, the full-covariance H = 50 '
             'solve, phase 8b', sparse['4']['eigh_launches']),
            ((VMAP_FULL_COV_LANES, 2), f32, 'the lanes route with '
             "full_cov=True through the kernel's vmap rule, phase 8c",
             sparse['vmap_full']['full_cov']['eigh_launches']),
            ((1, 2), f64, "the swing-up controller's route (b) with "
             'full_cov=True, phase 7b',
             sum(r['eigh'] for mode in MODES
                 for r in loop_full[mode]['launches']))):
        dtn = _DT_NAME[str(dt)]
        t = eigh_times[f'eigh {dtn} B={bb} d={d}']
        kernels.append(dict(
            name=f'eigh_small {dtn} instance, the PSD clip ({part}, B={bb} '
                 f'd={d})', route='cuda', source=EIGH_SOURCE,
            replaces=EIGH_REPLACES, launches=launches,
            max_abs_err=eigh_errs[f'path B={bb} d={d} {dtn}']['max_abs_err'],
            ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound'][0],
            bound_by=t['bound'][1], library_ms=t['library_ms']))
    # The probes' rows: `ms` is the kernel-only graph slope of P1's `full`
    # (K1's body) and of P2's `base` counterpart `tc_p`; `launches` counts the
    # probe's own wrapper calls in its run, not the solve's.
    for key, mode, variant, src in (
            ('P1', 'full', 'full', 'benchmarks/kernel_ablate.py:131'),
            ('P2', 'base', 'tc_p', 'benchmarks/kernel_probe.py:83')):
        run = probes[key]
        modes = ([r['variant'] for r in run['variants'].values()]
                 if key == 'P2' else list(run['variants']))
        kernels.append(dict(
            name=f'{key} rw_probe ({run["probe"]}; launches are the probe\'s '
                 f'wrapper calls, not the solve\'s)', route='cuda',
            source=PROBE_SOURCE, replaces=src, launches=probe_launches[key],
            max_abs_err=max(probe_checks[v][0] for v in modes),
            ms=run['variants'][mode]['kernel_us'] / 1e3,
            plain_ms=probe_plain[variant],
            bound_ms=times[f32]['K1']['bound'][0],
            bound_by=times[f32]['K1']['bound'][1], library_ms=None))
    detail = dict(objective=obj, solve=solve, solve_k1_f32=solve_f32,
                  graph=graph,
                  recipe=recipe, full_cov=full_cov, sym_solve=sym_solve,
                  sharded_1x1=sharded_11, sharded_1x2=sharded_12,
                  closed_loop=loop, loop_kernel_errs=loop_errs,
                  loop_kernel_times=loop_times, sparse=sparse,
                  sparse_kernel_errs=sparse_errs,
                  sparse_kernel_times=sparse_times,
                  eigh_errs=eigh_errs, eigh_times=eigh_times,
                  profile=prof, k1_instr_bound_ms=k1_instr,
                  precision=precision, k1_f64_wide=k1_f64_wide, sass=sass,
                  kernel_times={str(dt): r for dt, r in times.items()},
                  probes=dict(checks=probe_checks, launches=probe_launches,
                              plain_ms=probe_plain, **probes),
                  total_s=time.perf_counter() - t_start)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
        json.dump(dict(card=card, kernels=kernels, **detail), f, indent=1)
    log(f'[output] total {detail["total_s"]:.1f} s')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
