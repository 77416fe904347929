#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (koopmanx_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (nvcc); it exits non-zero without them,
or without the rest of the repository beside it. Three kernels, each
replacing a TPU kernel of the JAX package:

- ``box_admm`` (``csrc/box_admm.cu``; ``koopmanx/ops/qp_pallas_box.py``),
  on the flagship loop's path;
- ``fused_qp`` (``csrc/fused_qp.cu``, AoS, one warp per scenario: for
  N*m <= 32 the Newton-Schulz products as 4 x 4 register tiles and the
  KKT-inverse row in registers, above that the working set in shared
  memory; ``koopmanx/ops/qp_pallas.py``) and ``fused_qp_soa``
  (``csrc/fused_qp_soa.cu``, scenario-in-lanes, 32 scenarios a block in
  float32 and 16 in float64 with the working set in shared memory and
  registers, or one thread per scenario with a global scratch for larger
  shapes; ``koopmanx/ops/qp_pallas_soa.py``), the whole condensed QP of one
  control step in one launch, behind their own entry points.

Phases, each of which fails the run on error:

1. build every kernel from ``koopmanx_torch/csrc`` (one nvcc per source,
   all started together, and the native C++ plant of ``csrc/`` by g++
   beside them), print each one's register, stack and spill
   report (and fail if ptxas gives a ``fused_qp`` or ``fused_qp_soa``
   instance any stack or spills) and the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of its path (float32, B=8192 and a ragged B=1000, float64), and
   time both; ``box_admm`` also at every compiled instance (nx = 5 and 32,
   the smallest and widest with the KKT-inverse row in registers; 33 and
   128, the first and widest with it in shared memory; B=1000, float32 and
   float64), and at the other paths' inputs at B=8192 in float32 and
   float64: nx = 10 (the shipped duffing preset of phase 8, register
   instance 16), nx = 20 with the tank path's per-scenario folded
   bounds (phase 7: the first move's box cut by the applied window, down
   to lo = hi) and nx = 40 (tank_mimo's N*m, phase 11, the shared-memory
   instance: synthetic QPs, timed against the bound, then the phase 11
   loop's own first-step KKT inverse, rho, q and box), each case with its
   registers, block size, resident warps per SM and waves; both fused kernels also at N = 10 (the convergence
   gate's shape; B3's shared instance at NXP = 12, B2's register instance
   at NXP = 12) and at m = 2 (N*m = 40: B3's global instance, B2's first
   design), ``fused_qp`` at N = 8, m = 4 (N*m = 32, its widest register
   instance), float32 and float64 at B=1000, each fused case with its
   instance, registers, shared bytes per block, warps per block, resident
   warps per SM and waves; the fused kernels' inputs hold a few poisoned
   (non-finite) scenarios, which must come out as in the plain version and
   leave their neighbours alone. With ``--parent-fused-qp LIB`` (the
   ``libfused_qp.so`` of another checkout, built from its own source) it
   also prints, without gating, max |kernel - LIB's kernel| on the float32
   B=8192 inputs and both kernels' device times in turns (LIB, this, this,
   LIB);
3. drive the slice-1 path through the user entry points: the flagship
   batched Duffing closed loop (8192 scenarios x 200 steps, f32, horizon
   20, plant switch at step 100, qp_backend='pallas'), with every kernel
   launch count zeroed just before and read just after;
4. run the same loop through the plain route (qp_backend='xla') and hold
   the two against each other: the first 16 steps tightly in float64, then
   the batch-mean control quality of the float32 200-step runs. Beside the
   gate it measures the float32 round-off floor: the plain route against
   itself with x0 nudged by one ulp (the scratch-RLS warm-up amplifies
   such a difference to O(0.1) within 16 steps, which is why the tight
   early gate runs in float64);
5. time both loops once more, warm, with CUDA events;
6. drive the fused path: the flagship loop's end state from phase 3 (its
   per-scenario models, lifted states and warm starts, the constant
   reference window) through ``koopmanx_torch.ops.fused_qp_solve`` and
   ``fused_qp_solve_soa``, one launch each with the counts zeroed before
   and read after, each held against the plain version and the two
   against each other; it prints, without gating, the first move's gap
   to the engine's own control solve and the Newton-Schulz residual. Then
   the convergence gate of tests/test_pallas.py at B=8192: both kernels
   at 24 Newton-Schulz steps and 800 iterations within 5e-3 of the port's
   ``solve_qp`` (float64);
7. drive the tank family's path, the JAX package's second benched workload
   (``koopmanx_torch.configs.tank_bench_config``: 8192 scenarios with x0
   ~ U[0, 2]^2, param_scale 0.15, thinplate RBF lift of 10 normalized, du
   formulation with |du| <= 0.5 and the applied window [-8, 8] folded into
   each scenario's first bounds, N = 20, the windowed estimator over 256
   observations refit every 8th step past a 300-step warm-up, f32; 400
   steps, the switch at step 200), through the kernel route and the plain
   route, counts zeroed before each run and read after: 400 ``box_admm``
   launches, then 0. Gates: everything finite, the du box, the applied
   window and x >= 0 held, kernel vs plain route over the first 16 steps in
   float64, and the float32 batch-mean control quality of the tracked
   level x2 against r = 1. Prints both routes' warm wall time in turns;
8. drive the shipped ``duffing`` preset (weights from
   ``artifacts/duffing_kmae_encoder.mat``, normalized lift, horizon 10) at
   8192 scenarios for 200 steps through the kernel route: 200 launches,
   finite, |u| <= 2; its quality printed beside the random-init
   flagship's;
9. drive the large-lift path, the JAX package's ``BENCH_PRESET=
   duffing_rbf128`` workload (``koopmanx_torch.configs.
   rbf128_bench_config``: 8192 scenarios with x0 ~ U[-2, 2]^2,
   param_scale 0.15, 126 k-means thinplate-eps RBF centers plus the state,
   normalized, nlift 128, N = 20, the Woodbury lane over a 256-step window
   with polish 2, f32; cut to 60 steps, the switch at step 30), through the
   kernel route and the plain route, counts zeroed before each run and
   read after: 60 ``box_admm`` launches, then 0. Gates: everything
   finite (the carried statistics included), |u| <= 2, kernel vs plain
   route over the first 16 steps in float64, and the float32 batch-mean
   control quality of x1. Prints the x1 tail means before and after the
   switch, both routes' warm wall time (one run each, plain first), and
   each run's peak device memory;
10. drive the ``duffing_rff`` preset (32 random Fourier features plus the
   state, nlift 34, N = 10, the Woodbury lane) at 8192 scenarios for 60
   steps, and the phase 9 loop with its ring stored in bfloat16, both
   through the kernel route with their launches counted: 60 each,
   finite, |u| <= 2; their quality and peak memory printed beside phase
   9's;
11. drive the two-pump tank, the JAX package's ``BENCH_PRESET=tank_mimo``
   workload (``koopmanx_torch.configs.tank_mimo_bench_config``: 8192
   scenarios with x0 ~ U[0, 2]^2, param_scale 0.15, m = 2 under a +-4 box
   per channel, thinplate RBF lift of 10 normalized, N = 20, the windowed
   estimator over 256 observations refit every step, f32; cut to 100
   steps, the switch at step 50), through the kernel route (the dense
   40 x 40 KKT inverse, then ``box_admm`` at nx = 40) and the plain route (the
   output-space low-rank inverse, then the plain ADMM), counts zeroed
   before each run and read after: 100 ``box_admm`` launches, then 0.
   Gates: everything finite, |u| <= 4 per channel, x >= 0, kernel vs plain
   route over the first 16 steps in float64, the float32 batch-mean
   control quality of x2, and pump 2 carrying the load over the last 50
   steps (mean |u2| > mean |u1|). Prints the x2 tail means before and
   after the switch, both routes' warm wall time in turns and peak device
   memory;
12. drive the general-inequality path (the plain ADMM with extra rows,
   on either route, so 0 launches) at 8192 scenarios, f32, 30 steps: the
   tank bench with its applied window as explicit rows (|du| <= 0.5 and
   |u| <= 8 up to one f32 rounding) and the flagship with the state box
   |x| <= 1.05 over the horizon (|u| <= 2), each on both routes, with
   its warm ms/step and quality printed beside the box formulation of
   the same config (not gated);
13. drive the Van der Pol lifted-tracking loop, the JAX package's
   ``BENCH_PRESET=vanderpol`` workload (``koopmanx_torch.configs.
   vdp_bench_config``: 8192 scenarios with x0 ~ U[-2, 2]^2, param_scale
   0.15, the shipped encoder ``artifacts/vanderpol_kmae_encoder.mat``
   normalized, nlift 8, the QP tracking the lifted reference with C = I,
   N = 20, square-root RLS with 1e5 priors, f32; cut to 100 steps, the
   switch at step 50), through the kernel route and the plain route,
   counts zeroed before each run and read after: 100 ``box_admm`` launches, then 0.
   Gates: u finite and |u| <= 6, the model and the estimator finite in
   every scenario, at most 2 % of the scenarios escaped (their x
   non-finite: the plant's RK4 leaves its stability region past |x1| ~
   2.4, in the JAX package too), kernel vs plain route over 16 float64
   steps at 256 scenarios (each scenario and step within 1e-8 or ten times
   the plain route's own one-ulp floor there), and the float32 batch-mean
   control quality of x1 against r = [1, 0] over the scenarios finite on
   both routes. Prints each route's ms/step, warm, in turns;
14. drive the remaining estimators and references at 8192 scenarios for
   60 steps through the kernel route, counts zeroed before each run and
   read after: ``vdp_rbf_bench_config`` (the storage method: two batched
   pseudo-inverses a step), the flagship with ``update='rls_chol'`` and
   ``reset_mult=4``, the flagship with ``update='rls'`` in float64, and
   the VDP bench with ``reference='sine'``. Gates: 60 launches each, u
   finite within the preset's box, the model and estimator finite, x
   finite but for scenarios escaped as in phase 13, and the float64 kernel
   vs plain gate of phase 13 on each;
15. drive the Revise_2 loops, the per-step DARE terminal synthesis with
   its certificate guard and monitor series, at 8192 scenarios, f32,
   through the kernel route and the plain route, counts zeroed before
   each run and read after: ``revise2_duffing_bench_config`` (the JAX
   bench's ``BENCH_PRESET=revise2_duffing``: N = 20, the SM RLS
   warm-started from the batch Grams, the MATLAB RK4, the fallback
   encoder with the state, nlift 10; cut from the bench's 200 steps to 50,
   the switch at 25: 50 ``box_admm`` launches, then 0),
   ``revise2_vdp_bench_config`` (lifted tracking, the full P injected; cut
   to 16 steps, the switch at 8) and ``toy1d_bench_config`` (the
   one-state plant, no
   synthesis; cut to 40 steps, the switch at 20, where its parameters do
   not change). Gates: u finite within the preset's box, the model, the
   estimator and the held certificate (P, K, gamma) finite in every
   scenario, x finite but for scenarios escaped as in phase 13, the
   float64 kernel vs plain gate of phase 13 with its floor taken over
   every round-off realization of the plain route (one ulp of x0, one
   ulp of the initial A, the ADMM's sums reassociated; the one-ulp-of-x0
   gate's own count printed beside it), and the float32 batch-mean
   control quality of x1 against the state reference over the scenarios
   finite on both routes within 1 % / 5 %.
   Prints the share of scenario-steps whose certificate passed the
   guard, each route's warm ms/step (one run each, plain first) and
   each run's peak device memory;
16. drive the serving API and the CLI, counts zeroed before each run and
   read after: ``BatchedController`` at 8192 plants of the flagship
   config (phase 3's pipelines and scenarios) for 200 calls against the
   plant stepped outside it (``systems.base.make_step``, phase 3's
   per-scenario parameters and switch schedule), kernel route then plain
   route: 200 ``box_admm`` launches, then 0; x finite, |u| <= 2, the
   float32 x1 MSE and steady-state error within 1 % of phase 3's fused
   loop and within 1 % / 5 % between the routes. In float64 over 16
   steps the fleet equals ``run_batch`` on the same scenarios and route
   (within 1e-12 in x and u). A float64 fleet of the flagship with a sine
   reference and a dither probe (each plant's clock enters its QP) runs
   100 calls; then half the fleet resets (the even plants) and a quarter
   resets in full (plants 1 mod 4), so the clocks differ (the per-plant
   path); over the next 10 calls 4 sampled plants must match single
   Controllers given each plant's state at call 100, its measurements
   and its reset (within 1e-9: a one-row GEMM rounds otherwise than an
   8192-row one), and, within 1e-12, fleets of copies of each with every
   clock equal (the int path at the same width). Then each call's latency (p50, p99, the
   caller's copy of u to the host included), host synchronizations and
   device operations, for the fleet and for one plant (``Controller``)
   on both routes, beside phase 5's ms/step. Last ``cli.main`` in this
   process: ``run --preset duffing --steps 300`` and ``run --preset tank
   --steps 400`` on the card (the kernel route: one launch a step;
   steady-state error below 0.1 and 0.2, |u| within 2 and 8, a finite
   final state) and ``sweep --preset duffing --batch 8192 --steps 200``
   (200 launches, every scenario finite);
17. drive the other control laws at 8192 scenarios, f32, counts zeroed
   before each run and read after: (a) ``revise2_duffing_bench_config``
   with ``terminal_mode='lmi'`` (the Revise_2 LMI certificate each step:
   13 sequential doubling DAREs; cut from the bench's 200 steps to 4),
   scenario 0 started from an initial A with a NaN entry, through the
   kernel route and the plain route: 4 ``box_admm`` launches, then 0;
   every scenario the DARE mode keeps finite stays finite (x, u, the
   held certificate), |u| <= 2, the poisoned scenario's first
   certificate fails the guard with a NaN feasibility; the float64 gate
   of phase 15 at 256 scenarios over 4 steps. Prints ms/step, the share
   of fresh certificates, the share of each branch of the synthesis (the
   DARE point, the detuned pair, the fallback), the largest feasibility
   residual, one step's device operations, host synchronizations and
   idle share, and what ``torch.linalg.eigvalsh`` itself does on the card
   with a NaN entry and with an ill-conditioned float32 batch; (b) the
   flagship with ``controller='lqr'`` for 60 steps: 0 launches, finite,
   |u| <= 2, and a float64 ``BatchedController`` of 64 plants equal to
   ``run_batch`` bit for bit; (c) the local-linearization baseline
   (``run.build_local_linear``: the flagship's plant and weights on
   psi(x) = [x; 1], N = 20) for 200 steps on both routes: 200 launches,
   then 0, finite, |u| <= 2, steady-state error below 0.1, the float64
   routes within 1e-9 at 256 scenarios; (d) ``drift_norm='spectral'`` on
   the flagship for 20 steps, one step at a time, each drift within 1e-4
   of numpy's float64 2-norm of the same model difference, with the host
   synchronizations a step; (e) ``control.shooting.solve_shooting_pgd``
   on phase 3's end-state models, the card against the CPU in float32
   and float64.
18. KMAE training, counts zeroed before each run and read after: (a)
   ``cli train --system duffing`` at its defaults on the card (100 x 100
   snapshots, encoder 2-100-100-100-8, decoder back, horizon 6, 20
   epochs of 36 steps, rec-only past epoch 5; 0 launches): every epoch's
   loss finite, the loss at epoch 5 below epoch 0's, the last epoch's
   l_rec below epoch 0's, the checkpoint reloading to the trained state,
   the exported encoder loading as trained; prints the wall, ms per
   optimizer step, and one step's device operations, host
   synchronizations and idle share; (b) 5 float64 steps from one state on
   the same minibatches, the card against the CPU, within 1e-9 of each
   leaf's largest entry (or ten times the CPU's own spread with the
   snapshot rows summed in other orders, where larger); (c)
   ``duffing_selftrained`` with the trained encoder for 100 steps (cut from
   10000) on both routes: 100 launches, then 0, finite, |u| <= 2, quality
   within 1 % / 5 %, the float64 routes
   within 1e-9 (or ten times the plain route's one-ulp floor) at 256
   scenarios, its steady-state error beside the shipped encoder's; (d)
   the flagship for 30 steps on the kernel route with ``lift.kind``
   hermite, monomial and identity and ``mpc.markov`` doubling and assoc:
   30 launches each, finite, |u| <= 2; each Markov build's F1 and F2 on
   phase 3's end-state models within 1e-5 (float32; or twice the larger
   float32 error of the two builds against float64, where larger) and
   1e-12 (float64) of 'dag''s.
19. the carried and bf16 KKT inverses, the reference's checkpoints and
   hardware in the loop, counts zeroed before each run and read after:
   (a) the flagship with ``qp_kkt_bf16`` (the inverse rounded through
   bfloat16 before B1 on the kernel route, as before the plain ADMM) for
   200 steps on both routes: 200 launches, then 0; finite, |u| <= 2,
   quality within 1 % / 5 % between the routes, the steady-state error
   within twice phase 3's float32 loop's, the float64 routes at 256
   scenarios over 16 steps within 1e-9 (or ten times the plain route's
   one-ulp floor); tests/test_engine.py:355-371's own loop (the shipped
   duffing preset from its x_init, one scenario, 30 float32 steps on the
   kernel route) within 0.05 of its float32 run; the flagship's first 30
   steps against phase 3's loop printed beside the float32 loop's own
   one-ulp-of-x0 spread (not gated); (b) the flagship on the plain route
   with ``qp_kkt_refine=3``, ``qp_kkt_reanchor=16`` for 200 steps: the
   exact inverse at steps 0, 16, ..., 192 only (13 anchors, 187 tracked
   steps, counted), 0 launches, finite, |u| <= 2, the tracking MSE within
   0.5 % of phase 4's exact plain loop and the steady-state error below
   max(2x, 5e-3) of it; the kernel route with refine refused; one
   tracked step, one anchor step and one exact plain step timed, counted
   and profiled (device operations, idle share); (c) the shipped duffing
   encoder and decoder written as a reference-layout ``torch.save(model)``
   checkpoint (and its state_dict, which the port's reader must read as
   ``torch.load(weights_only=True)`` does), then phase 8's preset with
   that ``.pkl`` as its weights: 200 launches, x and u equal to phase 8's
   bit for bit (or within phase 8's own run-to-run spread, measured); (d)
   ``tools/bench_hil_torch.py``'s loop on the card against the native C++
   plant (built by g++ into ``koopmanx_torch/_build/`` in phase 1): the
   ``pendulum`` preset served by one ``Controller`` for 400 periods and
   the ``tank`` preset by a ``BatchedController`` of 8192 plants for 300,
   one launch a period, the (worst plant's) steady-state error below
   0.05, each period's latency p50 / p99 and the plant step's share;
   then every native plant and integrator against the port's RK4 on the
   card in float64 at 8192 random states, within 1e-12 of max(1, |x|);
   (e) a float64 ``BatchedController`` of 256 plants with the carried
   inverse, the even plants reset at call 20 of 40: 4 sampled plants
   against single Controllers (1e-9) and int-path twins (1e-12), as in
   phase 16;
20. several cards on the one card (``koopmanx_torch/parallel``): (a)
   ``make_mesh()`` at world size 1 through NCCL, phase 3's pipeline and
   scenarios through ``sharded_closed_loop(pipe.closed_loop, mesh,
   *shard_batch(...))``: 200 launches, x and u bit for bit phase 3's,
   ms/step beside phase 5's; ``distributed_edmd_fit`` on the flagship's
   50 x 50 data in float64 within 1e-10 of ``edmd_fit(method='solve')``;
   ``psum_mean(arange(16)) = 7.5``; one data-parallel KMAE step at the
   reference's width (hidden 100, 10,000 snapshots, 256 windows) bit for
   bit the plain step; (b) two ranks sharing the card on gloo (NCCL
   refuses two ranks on one GPU), each this script with
   ``--two-rank-worker`` and 4096 scenarios on the card: the float64
   flagship loop over 16 steps gathered against the whole batch, each
   scenario and step within 1e-8 or ten times the whole batch's own
   divergence from one ulp of x0, the distributed fit and ``psum_mean``
   on CUDA tensors; a rank that fails fails the phase; (c)
   ``eval/plots.py::eigenfunction_grid`` on the card (the flagship's
   dictionary in float64, phase 3's end-state model) against the CPU
   within 1e-10 of max(1, |phi|). The rest of ``eval/plots.py`` draws
   with matplotlib, which the card's machine lacks: it is held to the JAX
   package's in ``tests/test_torch_plots.py`` only;
21. the measuring entry points: (a) ``python -m koopmanx_torch.bench`` as
   a process of its own at its defaults (the flagship, 8192 scenarios x
   200 steps, best of 3 timed runs after a warm-up, the kernel route):
   one JSON line, value = batch x steps / wall, 600 launches in the timed
   runs, its tracking MSE and steady-state error within 1 % / 5 % of
   phase 3's (the same workload); (b) ``koopmanx_torch.bench.run_bench``
   on the plain route (one timed run): no launch, quality within 1 % / 5
   % of (a); (c) ``run_bench`` on every other preset of the JAX bench
   (``tank``, ``duffing_rbf128``, ``tank_mimo``, ``vanderpol``,
   ``vanderpol_rbf``, ``revise2_duffing``, ``revise2_vdp``, ``toy1d``) at
   8192 scenarios over 20 steps, 20 launches each, a finite value;
   (d) ``tools/bench_serving_torch.py`` over fleets of 1, 256 and 8192
   (20 calls each) and its curve (10 calls a variant): finite latencies,
   one launch a call, device operations a call ordered full > lean >
   empty dispatch, the p50s beside phase 16's; (e)
   ``tools/validate_scale_torch.py`` on ``vanderpol`` at its reference
   length of 1000 steps: finite, |u| within the preset's box, 1000
   launches;
22. gradients through the closed loop (the plain route, as ``jax.grad``
   in the JAX package) and the four examples: (a) one value-and-grad of
   the flagship's batch-mean settled tracking cost (x1 against r1 over
   the second half) w.r.t. a shared log r at full width (8192 scenarios,
   200 steps, f32) under ``EngineConfig.remat``: the forward's and the
   value-and-grad's ms, the peak device memory, device operations a step,
   a finite, non-zero gradient; then 512 scenarios over 20 steps with and
   without remat, each scenario with its own log r, both peaks and the
   spread of the per-scenario derivatives; (b) float64 at 64 scenarios
   over 16 and 40 steps on one pipeline built on the CPU and moved: the
   card's gradient against the CPU's (1e-9 or ten times the CPU's own
   one-ulp floor: the largest change from one ulp of x0, of the initial
   A or of r), remat against the stored graph (1e-12), both against
   a central difference where the gradient is well conditioned; (c)
   three Adam steps of ``examples/tune_weights_torch.py::tune`` at 100
   steps, finite; (d) the flagship on the kernel route with a log r that
   requires grad raises ``ValueError`` and launches nothing; (e) the
   compute functions of ``examples/duffing_comparison_torch.py`` (600
   steps x 2 loops), ``local_linear_comparison_torch.py`` (400 x 2) and
   ``tank_delta_u_torch.py`` (1200) as a user calls them on the card
   (float32, the kernel route): one launch a step, finite metrics,
   printed; then each loop of each example through its own ``config``
   in float64 on both routes over the same steps, each step within 1e-8
   or ten times the plain route's own round-off floor (phase 15's rule:
   one ulp of x_init, one ulp of the initial A, the plain ADMM with its
   sums reassociated), its tracking MSE and steady-state error within
   1 % / 5 % of the plain route's. (a) runs alone, for its times; (b)
   and (e)'s float64 gates (one process for each example) then run in
   processes of their own (this script with ``--phase22-part``) beside
   (c), (d) and (e)'s float32 runs: each step is host-bound, so each
   process keeps one core busy.

Run with no arguments it needs one card. Prints the kernels JSON line, a
slice timing JSON line, a tank timing JSON line, an rbf128 timing JSON
line, a tank_mimo timing JSON line, a VDP JSON line, a Revise_2 JSON
line, a serving JSON line (phase 16's latencies), a control-laws JSON
line (phase 17), a training JSON line (phase 18), a phase 19 JSON line,
a phase 20 JSON line, a phase 21 JSON line, a phase 22 JSON line, the
card line
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and, as
the last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH, STEPS, HORIZON = 8192, 200, 20
ITERS, SIGMA, ALPHA = 60, 1e-6, 1.6
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# non-tensor-core FMA rates the kernel's scalar arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# kernel vs plain, max |diff| over xt, z, y, relative to max(1, |ref|):
# both run the same iteration; only the order of the nx-term dot products
# (four interleaved FMA chains in the kernel for nx <= 32, one above;
# cuBLAS's reduction in the plain version) and y * (1 / rho) against
# y / rho (one ulp) differ, a few ulps per iteration through 60
# contracting iterations
TOL = {"float32": 1e-5, "float64": 1e-12}
# box_admm's widths beyond the main path's nx = 20, one for each end of
# each compiled family: registers (nx rounded up to 8, up to 32), then
# shared memory (up to 128)
BOX_WIDTHS = (5, 32, 33, 128)
# the shipped duffing preset's nx = N*m = 10 (phase 8; register instance 16)
PRESET_NX = 10
# plain vs kernel closed loop, identical but for that reassociation. During
# the scratch-RLS warm-up the loop amplifies a round-off seed by many orders
# of magnitude (tests/test_kkt_refine.py:53-59 documents it for the JAX
# package), so the tight early gate runs in float64, where the seed is
# ~1e-16; the float32 runs are held to batch-mean control quality, as in
# that test. Phase 4 prints the float32 floor (one ulp of x0) beside it.
LOOP_EARLY_STEPS, LOOP_EARLY_TOL = 16, 1e-4
QUALITY_RTOL = {"tracking MSE": 1e-2, "steady-state error": 5e-2}
# the fused-QP kernels at the flagship's shapes (FusedQPConfig's defaults):
# nz = 8 lifted states, m = 1 input, py = 2 tracked outputs, 16
# Newton-Schulz steps
NZ, M_IN, PY, SCHULZ = 8, 1, 2, 16
# fused kernel vs plain, max |diff| of u where both are finite (|u| <= 2,
# so absolute): the same arithmetic in another summation order, but the
# QPs are ill-conditioned (cond(K) up to ~200) and 16 Newton-Schulz steps
# leave K's inverse unconverged, so round-off reaches u amplified. Phase 2
# prints beside each check the float32 floor: the plain version in
# float32 against itself in float64 on the same inputs
FUSED_TOL = {"float32": 5e-3, "float64": 1e-9}
# tests/test_pallas.py:46-61: at convergence both kernels come within 5e-3
# of the general solver (float64, N = 10, 24 Newton-Schulz steps)
CONVERGED = {"horizon": 10, "iters": 800, "schulz_iters": 24, "tol": 5e-3}
# phase 7: the tank bench (tank_bench_config) cut from the preset's 3000
# steps to 400, which still cover the switch (step 200) and ~100 steps of
# the refit cadence past the 300-step warm-up; its bounds
TANK_STEPS, DU_MAX, APPLIED_MAX, BOUND_SLACK = 400, 0.5, 8.0, 1e-6
# phase 8: the shipped duffing preset
PRESET_STEPS = 200
# phases 9 and 10: the rbf128 bench and the duffing_rff preset, cut from
# the bench's 200 steps to 60 for the script's time (the presets run 3000
# and 10000), the switch at 30
RBF128_STEPS = 60
# phase 11: the tank_mimo bench (tank_mimo_bench_config), cut from the
# bench's 200 steps to 100 (the preset runs 3000), the switch at 50, after
# which pump 2 carries the load as it does at 200; its input box per
# channel; the KKT width N*m = 40 that B1 runs there (shared-memory
# instance), also checked in phase 2
MIMO_STEPS, MIMO_U_MAX, MIMO_NX = 100, 4.0, 40
# phase 12: the general-inequality path (the tank's applied window as
# rows, the flagship's state box), a short run
GENERAL_STEPS, STATE_BOX = 30, (-1.05, 1.05)
# phase 13: the VDP lifted-tracking bench (vdp_bench_config), cut from the
# bench's 200 steps to 100 (the preset runs 10000), the switch at 50,
# |u| <= 6. The
# plant's RK4 at h = 0.05 leaves its stability region where h |c| x1^2
# passes ~2.8 (c = -10: |x1| > ~2.4), and a scenario the controller drives
# there goes non-finite in the JAX package too (0.44 % of 2048 on the CPU,
# f32, 200 steps); the guard must hold its model and estimator, and at most
# ESCAPE_SHARE of the batch may escape
VDP_STEPS, VDP_U_MAX, ESCAPE_SHARE = 100, 6.0, 0.02
# phase 14: the estimators and references at full width, a short run
ESTIMATOR_STEPS = 60
# phases 13-14: kernel vs plain route over LOOP_EARLY_STEPS float64 steps
# at EARLY_BATCH scenarios, each scenario and step held to EARLY_TOL or to
# ten times the plain route's own divergence from one ulp of x0 (up or
# down) there, where that is larger: from a 1e5 scratch-RLS prior and a
# bang-bang first input the VDP loop moves by up to ~1e-2 in 16 float64
# steps from one ulp of x0 (CPU rehearsal at B = 256), as the JAX
# package's own loop does (tests/test_torch_vdp.py)
EARLY_BATCH, EARLY_TOL = 256, 1e-8
# phase 15: the Revise_2 benches, cut from the bench's 200 steps:
# revise2_duffing to 50, revise2_vdp to 16, toy1d to 40 (each step's DARE
# synthesis is ~6,500 eager operations, ~94 ms a step on the card: the
# script's phases 1-19 must fit in half its time limit). The f64 gate's
# floor there also takes the
# plain route's divergence from one ulp of the initial model's A and from
# its ADMM sums reassociated: the lifted revise2_vdp loop, with the DARE's
# P (trace up to ~1e6) in Qbar, moves the plain route under its own
# reassociation 3.7 times past ten times its one-ulp-of-x0 floor (B = 256,
# 16 f64 steps, H100), so that floor alone cannot bound any kernel
REVISE2_STEPS = {"revise2_duffing": 50, "revise2_vdp": 16, "toy1d": 40}
# phase 16: the serving API. The fleet runs phase 3's 200 steps as 200
# calls against the plant stepped outside it; in float64 it must equal the
# fused loop, which runs the same eager operations in the same order. The
# masked reset runs a float64 fleet of the flagship with a sine reference
# and a dither probe (so that each plant's clock enters its QP): at call
# RESET_AT half the fleet resets (the even plants) and a quarter of it
# resets in full (plants 1 mod 4); SAMPLED plants (soft, full, soft,
# untouched) are held for RESET_CHECK calls against single Controllers
# given each plant's state at RESET_AT, its measurements and its reset
# (to SINGLE_TOL), and against fleets of BATCH copies of each with every
# clock at its own, the int path at the same width (to SERVE_TOL). The
# single Controller's one-row GEMMs (the MLP lift's F.linear) round
# otherwise than the fleet's 8192-row ones (H100: 2.88e-12 in u over the
# 10 calls, while the same-width twin agrees bit for bit), so a single
# plant is held to the JAX package's own fleet-against-single tolerance
# (tests/test_controller_equiv.py:191), the twin to 1e-12.
# Latency: p50 and p99 of a call, the caller's copy of u to the host
# included, after LATENCY_WARMUP calls
SERVE_CALLS, SERVE_TOL, SINGLE_TOL = STEPS, 1e-12, 1e-9
RESET_AT, RESET_CHECK, SAMPLED = 100, 10, (0, 1, 2, 3)
LATENCY_CALLS, LATENCY_WARMUP = {"fleet": 60, "single": 100}, 5
# the CLI runs of the verify skill: (preset, steps, steady-state error
# bound, |u| bound). Duffing's bound is the port's own healthy range (its
# pipeline draws its training data with torch's generator, not JAX's PRNG:
# 0.0835 at 300 float32 steps on the CPU, still converging; on the JAX
# package's own pipeline the port gives 0.0106 against JAX's 0.0124), the
# tank's the JAX package's
CLI_RUNS = (("duffing", 300, 0.1, 2.0), ("tank", 400, 0.2, 8.0))
SWEEP_BATCH, SWEEP_STEPS = BATCH, STEPS
# phase 17: the other control laws at 8192 scenarios, f32. (a) the
# revise2_duffing bench with the LMI terminal, cut from 200 steps to
# LMI_STEPS: each step's synthesis is 13 sequential doubling DAREs (the
# DARE point and the 12 grid points as one batched DARE, then 12
# bisection points), ~80,000 eager operations a step; scenario POISONED
# starts from an initial A with a NaN entry (its first certificate must
# fail the guard, through the masked eigenvalues); the float64 gate of
# phase 15 at EARLY_BATCH scenarios over LMI_F64_STEPS steps. (b) the
# flagship with the LQR law over LQR_STEPS (no QP: no launch); its fleet
# equals run_batch bit for bit at LQR_F64_BATCH over LQR_F64_CALLS in
# float64. (c) the
# local-linearization baseline on the flagship's plant and weights over
# LOCAL_STEPS on both routes, each tracking r = 1 to a steady-state error
# below LOCAL_SSE_MAX (the JAX package's own bound,
# tests/test_local_linear.py; ~0.003 on an H100 in float32 at 8192
# scenarios), their float64 gap at EARLY_BATCH over LOCAL_F64_STEPS within
# LOCAL_F64_TOL. (d) drift_norm='spectral' on the flagship over
# DRIFT_STEPS, each step's three drifts within DRIFT_RTOL of numpy's
# float64 2-norm of the same model differences on the host. (e) the
# shooting PGD on phase 3's end-state models, the card against the CPU,
# each dtype within PGD_TOL or, where that does not hold, within ten times
# the CPU's own change when A moves by one ulp (the flagship's models
# amplify round-off through the 200 projected steps: one ulp of A moves
# the float32 result past 1e-3 on the CPU)
LMI_STEPS, LMI_F64_STEPS, POISONED = 4, 4, 0
LQR_STEPS, LQR_F64_BATCH, LQR_F64_CALLS = 60, 64, 20
LOCAL_STEPS, LOCAL_F64_STEPS, LOCAL_F64_TOL, LOCAL_SSE_MAX = (
    STEPS, 60, 1e-9, 0.1)
DRIFT_STEPS, DRIFT_RTOL = 20, 1e-4
PGD_TOL = {"float32": 1e-4, "float64": 1e-9}
# the CPU reference of (e) runs the first PGD_CPU_BATCH of the 8192
# scenarios (they do not mix: the card's values there are the whole
# call's), its autograd on the host being the phase's slowest part
PGD_CPU_BATCH = 256
# phase 18: KMAE training at the reference's width through the CLI's
# defaults (100 x 100 snapshots, 2-100-100-100-8 and back, horizon 6, 20
# epochs with rec-only past epoch 5, 256 windows a batch: 36 steps an
# epoch); (b) the card against the CPU in float64 over TRAIN_CHECK_STEPS
# steps (steps 3 and 4 rec-only), within TRAIN_F64_RTOL of each leaf's
# largest entry, or ten times the CPU's own spread when the snapshot rows
# are summed in other orders, where that is larger: the same arithmetic
# but cuBLAS's and the CPU's summation orders over the 10,000 rows (a
# first H100 run: 5.2e-9 on one leaf, 8.4e-11 in the losses); (c)
# duffing_selftrained with the phase's encoder, cut from the preset's
# 10000 steps to SELFTRAINED_STEPS as phase 8 is, on both routes, then the
# same loop on the shipped encoder; its float64 routes within
# SELFTRAINED_F64_TOL (or ten times the plain route's one-ulp-of-x0 floor,
# where that is larger) at EARLY_BATCH; (d) the flagship with each L7
# option over L7_STEPS, and each Markov build's F1 and F2 on phase 3's
# end-state models within MARKOV_RTOL of 'dag''s (relative to each
# scenario's largest entry; in float32, or twice 'dag''s own float32
# error, where larger: see markov_check)
TRAIN_ARGV = ["train", "--system", "duffing"]
TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH, TRAIN_HIDDEN = 20, 36, 100
TRAIN_TIMED_STEPS = 20
TRAIN_CHECK_STEPS, TRAIN_F64_RTOL = 5, 1e-9
SELFTRAINED_STEPS, SELFTRAINED_F64_TOL = 100, 1e-9
L7_STEPS = 30
L7_RUNS = (("lift.kind", "hermite"), ("lift.kind", "monomial"),
           ("lift.kind", "identity"), ("mpc.markov", "doubling"),
           ("mpc.markov", "assoc"))
MARKOV_RTOL = {"float32": 1e-5, "float64": 1e-12}
# phase 19: the carried and bf16 KKT inverses, the reference's .pkl
# checkpoint, hardware-in-the-loop serving. (a) the flagship with
# qp_kkt_bf16 on both routes over STEPS, its steady-state error within
# BF16_SSE_FACTOR of phase 3's float32 loop, the float64 routes at
# EARLY_BATCH over LOOP_EARLY_STEPS within BF16_F64_TOL (or ten times the
# plain route's one-ulp floor); tests/test_engine.py:355-371's own loop
# (the shipped duffing preset from its x_init, nominal parameters, one
# scenario) over BF16_X_STEPS within BF16_X_TOL of its float32 run, that
# test's bound. Over the flagship's 8192 scenarios the same head is
# printed, not gated: the float32 loop moves itself by up to ~0.94 there
# from one ulp of x0 (a CPU rehearsal at 2048 scenarios), so no per-
# scenario 0.05 can hold. (b) the flagship on the plain route with REFINE
# Newton-Schulz steps re-anchored every REANCHOR steps: the exact inverse
# at steps 0, 16, ..., 192 and nowhere else; the tracking MSE within
# REFINE_MSE_RTOL of phase 4's exact plain loop and the steady-state error
# below max(2x, REFINE_SSE_FLOOR) of it (tests/test_kkt_refine.py:87-88).
# (c) the shipped duffing encoder and decoder as a reference-layout
# full-model checkpoint, read back by the port's loader through phase 8's
# preset: phase 8's x and u bit for bit, or within phase 8's own
# run-to-run spread. (d) HIL_RUNS: (preset, periods, plants; 0 = one
# Controller) served against the native plant, the steady-state error
# (worst plant) below HIL_SSE_MAX (the verify skill's healthy bound); the
# native plant against the port's RK4 in float64 on BATCH random states
# within NATIVE_RTOL of max(1, |x|). (e) a float64 BatchedController of
# SERVE_REFINE["batch"] plants with the carried inverse over
# SERVE_REFINE["calls"] calls, the even plants reset at
# SERVE_REFINE["reset_at"]: the SAMPLED plants against single
# Controllers (SINGLE_TOL) and int-path twins (SERVE_TOL), as phase 16
BF16_X_STEPS, BF16_X_TOL, BF16_SSE_FACTOR, BF16_F64_TOL = 30, 0.05, 2.0, 1e-9
REFINE, REANCHOR = 3, 16
REFINE_MSE_RTOL, REFINE_SSE_FLOOR = 5e-3, 5e-3
HIL_RUNS = (("pendulum", 400, 0), ("tank", 300, BATCH))
HIL_SSE_MAX, NATIVE_RTOL = 0.05, 1e-12
SERVE_REFINE = {"batch": 256, "calls": 40, "reset_at": 20}
# phase 20: several cards on one. (a) world size 1 through NCCL: phase 3's
# loop through sharded_closed_loop (the same program on the same batch:
# x and u bit for bit), the distributed fit on the flagship's 50 x 50
# float64 data within FIT_TOL of edmd_fit(method='solve') (the JAX
# package's own bound, tests/test_parallel.py:40), psum_mean, one
# data-parallel KMAE step at the reference's width bit for bit the plain
# step. (b) two ranks sharing the card on gloo, 4096 scenarios each, the
# float64 loop over LOOP_EARLY_STEPS gathered against the whole batch to
# EARLY_TOL or ten times its one-ulp-of-x0 floor (phase 13's gate); each
# rank within TWO_RANK_TIMEOUT seconds. (c) eigenfunction_grid on the card
# against the CPU in float64, within EIGFUN_TOL of max(1, |phi|)
FIT_TOL, TWO_RANK_TIMEOUT, EIGFUN_TOL = 1e-10, 300, 1e-10


# phase 21: the JAX bench's other presets at full width, cut from 200
# steps to BENCH_OTHER_STEPS for the script's time (each is one warm-up
# and one timed run); the serving tool's fleets and reps, its curve's
# reps; the validation tool's preset at its reference length (the
# closed loop of vanderpol.py)
BENCH_OTHER = ("tank", "duffing_rbf128", "tank_mimo", "vanderpol",
               "vanderpol_rbf", "revise2_duffing", "revise2_vdp", "toy1d")
BENCH_OTHER_STEPS = 20
SERVING_ARGV = ["--batches", f"1,256,{BATCH}", "--reps", "20"]
CURVE_ARGV = ["--curve", "--reps", "10"]
VALIDATE_ENV = {"PRESET": "vanderpol", "STEPS": "1000"}
BENCH_TIMEOUT = 600  # seconds for the bench's own process
# phase 22: gradients through the closed loop and the four examples. (a)
# the flagship at full width under remat, one value-and-grad of the
# batch-mean settled cost w.r.t. a shared log r; then GRAD_SMALL_BATCH
# scenarios with and without remat over GRAD_SMALL_STEPS (cut from 200 for
# the script's time: the backward pass is host-bound, ~45 s at 200 steps),
# each scenario with its own log r so that the spread of the per-scenario
# derivatives shows (without remat the full width would keep every step's
# activations: tens of GB); device operations counted over GRAD_OPS_STEPS
# steps. (b) float64 at GRAD_F64_BATCH scenarios over each of
# GRAD_F64_STEPS, on one pipeline built on the CPU and moved: the card
# against the CPU within GRAD_F64_RTOL or ten times the CPU's own change
# from one ulp (the largest of every x0, the initial model's A and r moved
# up by one ulp: one ulp of x0 alone left a card run 1.06e-9 from the CPU
# at 16 steps, over ten times its 5.7e-11; the card reassociates sums at
# every step; at 40 steps the floor is ~1 % of the gradient, so that gate
# is loose), remat
# against the stored graph within GRAD_REMAT_RTOL, both against a central
# difference of the forward cost (step FD_STEP in log r) within FD_RTOL or
# ten times the cost's own one-ulp change over the step (at 16 steps the
# derivative is ~3e-6 of the cost: its round-off alone moves the
# difference by ~3e-4), where the gradient is well conditioned (the CPU's
# one-ulp change under FD_COND relative; a CPU rehearsal at 40 steps: two
# of 64 scenarios near an active-set change carry the shared derivative,
# 1.3 % of which moves with one ulp of x0, and a central difference at 1e-4
# is 39 % away); printed elsewhere. (c) TUNE_ITERS Adam steps of
# examples/tune_weights_torch.py, cut from its 200 steps to TUNE_STEPS for
# the script's time. (e) the three comparison examples at their default
# steps: as a user calls them (float32, the kernel route), then in float64
# on both routes over EXAMPLE_ROWS scenarios (the example's own start, x0
# and the initial A each moved one ulp up and down), each step held to
# phase 15's rule (EARLY_TOL or ten times the plain route's own round-off
# floor) and the metrics to QUALITY_RTOL. The float32 runs are not held
# to each other: one float32 scenario's steady-state error moves by tens
# of per cent under round-off alone (the duffing example's online loop on
# an H100 at 700 W: 0.0034 on the kernel route, 0.0022 on the plain one;
# 0.00175-0.0029 on the CPU over six ulps of x_init)
GRAD_SMALL_BATCH, GRAD_SMALL_STEPS, GRAD_OPS_STEPS = 512, 20, 2
GRAD_F64_BATCH, GRAD_F64_STEPS = 64, (16, 40)
GRAD_F64_RTOL, GRAD_REMAT_RTOL, FD_STEP, FD_RTOL = 1e-9, 1e-12, 1e-4, 1e-4
FD_COND = 1e-8
TUNE_STEPS, TUNE_ITERS = 100, 3
EXAMPLE_ROWS = 5
# (b) and (e)'s float64 gates run in processes of their own beside the
# rest of phase 22; the CPU gradients of (b) on PART_B_THREADS threads
PART_B_THREADS, PART_TIMEOUT = 4, 600


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, by
    CUDA events, with the calls queued behind a spin kernel
    (``torch.cuda._sleep``) so that the host's time to launch them does not
    show between them. Fails if the spin ended before the last call was
    queued, after a few tries with longer spins."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10 ** 8  # ~50 ms at 2 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail("could not queue the timed calls ahead of the device")


def ptxas_registers(log: str):
    """``{mangled kernel name: registers per thread}`` from the
    ``nvcc -Xptxas -v`` report of one build."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def box_admm_ptxas_registers(regs, dtype: str, nx: int):
    """ptxas's registers for the register instance that ``nx`` launches
    (``box_admm_regs<T, NXP>``, NXP = nx rounded up to 8), or None."""
    nxp = -(-nx // 8) * 8
    key = f"box_admm_regsI{'f' if dtype == 'float32' else 'd'}Li{nxp}E"
    found = [n for name, n in regs.items() if key in name]
    return found[0] if len(found) == 1 else None


def folded_bounds(batch: int, nx: int, gen):
    """The tank path's per-scenario bounds (m = 1): the du box on every
    move, its first move intersected with the applied window
    [-8 - u_prev, 8 - u_prev], lo0 = min(lo0, hi0), as
    engine/core.py folds it. u_prev ~ U[-9, 9] covers both sides of the
    window; pinned values give lo0 > -DU_MAX (u_prev < -7.5), hi0 = 0
    (u_prev = 8) and lo0 = hi0 (|u_prev| > 8.5)."""
    import torch

    u_prev = 18.0 * torch.rand((batch, 1), generator=gen,
                               dtype=torch.float64) - 9.0
    pinned = torch.tensor([8.0, -8.0, 8.5, -8.5, 8.75, -8.75, 7.75, -7.75,
                           -7.5, 0.0], dtype=torch.float64)
    u_prev[:len(pinned), 0] = pinned
    lo = torch.full((batch, nx), -DU_MAX, dtype=torch.float64)
    hi = -lo
    lo0 = torch.clamp(-APPLIED_MAX - u_prev, min=-DU_MAX)
    hi0 = torch.clamp(APPLIED_MAX - u_prev, max=DU_MAX)
    lo[:, :1] = torch.minimum(lo0, hi0)
    hi[:, :1] = hi0
    return lo, hi


def box_inputs(batch: int, nx: int, dtype, device, seed: int,
               folded: bool = False):
    """SPD box QPs built like tests/test_pallas.py:74-84, with the KKT
    inverse and rho the solver computes (block-8 elimination); one
    +-1.5 box for every scenario, or ``folded``: the tank path's
    per-scenario bounds (:func:`folded_bounds`)."""
    import torch
    from koopmanx_torch.control.qp import ADMMConfig, _effective_rho, box_kkt
    from koopmanx_torch.ops.linalg import spd_inverse

    g = torch.Generator().manual_seed(seed)
    mm = 0.3 * torch.randn((batch, nx, nx), generator=g, dtype=torch.float64)
    p = mm @ mm.transpose(-1, -2) + 0.5 * torch.eye(nx, dtype=torch.float64)
    q = torch.randn((batch, nx), generator=g, dtype=torch.float64)
    x0 = 0.1 * torch.randn((batch, nx), generator=g, dtype=torch.float64)
    p, q, x0 = (t.to(device=device, dtype=dtype) for t in (p, q, x0))
    cfg = ADMMConfig(iters=ITERS, rho=0.1, kkt_block=8)
    rho = _effective_rho(p, cfg)
    minv = spd_inverse(box_kkt(p, cfg), block=8)
    if folded:
        lo, hi = (b.to(device=device, dtype=dtype)
                  for b in folded_bounds(batch, nx, g))
    else:
        lo = torch.full_like(q, -1.5)
        hi = -lo
    return (minv.contiguous(), q, lo, hi, x0, torch.zeros_like(q), rho)


def tank_mimo_step0_inputs(device, dtype: str):
    """B1's arguments at the tank_mimo bench loop's first step (kernel
    route, 8192 scenarios): the engine's own dense 40 x 40 KKT inverse,
    rho, q and the per-channel box, captured on their way into
    :func:`box_admm` during a one-step run."""
    from koopmanx_torch.control import qp

    captured = []
    real = qp.box_admm

    def capture(*args, **kw):
        captured.append(args)
        return real(*args, **kw)

    qp.box_admm = capture
    try:
        mimo_loop("pallas", device, steps=1, dtype=dtype)()
    finally:
        qp.box_admm = real
    if len(captured) != 1 or captured[0][0].shape[-1] != MIMO_NX:
        fail(f"tank_mimo step 0 gave {len(captured)} box-ADMM calls")
    return captured[0]


def box_admm_reassociated(minv, q, lo, hi, x0, y0, rho, iters, sigma,
                          alpha):
    """The plain version's iteration with its products summed in another
    order (an elementwise product summed from the last column) and
    y * (1 / rho): its distance from ``box_admm_reference`` is the
    round-off floor of the comparison on these inputs."""
    from koopmanx_torch.ops.box_admm import BoxADMMOut

    rho_c = rho[:, None]
    x, y = x0, y0
    z = lo.maximum(x).minimum(hi)
    for _ in range(iters):
        rhs = sigma * x - q + rho_c * z - y
        xt = (minv * rhs[:, None, :]).flip(-1).sum(-1)
        x_mid = alpha * xt + (1.0 - alpha) * z
        z_new = lo.maximum(x_mid + y * (1.0 / rho_c)).minimum(hi)
        y = y + rho_c * (x_mid - z_new)
        x, z = xt, z_new
    return BoxADMMOut(xt=x, z=z, y=y)


def box_admm_bound_ms(batch: int, nx: int, iters: int, dtype: str):
    """Least time for the same work on an H100 SXM: bytes (each input read
    once, each output written once) over HBM rate vs operations over the
    dtype's peak."""
    item = 4 if dtype == "float32" else 8
    nbytes = batch * (nx * nx + 6 * nx + 1 + 3 * nx) * item
    flops = batch * iters * (2 * nx * nx + 12 * nx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_inputs(batch: int, dtype, device, seed: int,
                 horizon: int = HORIZON, poison: bool = True, m: int = M_IN):
    """Models built like tests/test_pallas.py:18-43 (A = 0.8 I + noise,
    random B, CyC and z0, yr = [1, 0] over the horizon) and a warm start
    off zero, made in float64 from a seed. With ``poison``, five scenarios
    carry a non-finite entry (NaN or inf in A, z0, B or CyC). Returns the
    inputs and the poisoned indices."""
    import torch

    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    a = (0.1 * torch.randn((batch, NZ, NZ), **f64)
         + 0.8 * torch.eye(NZ, dtype=torch.float64))
    b = 0.3 * torch.randn((batch, NZ, m), **f64)
    cyc = 0.5 * torch.randn((batch, PY, NZ), **f64)
    z0 = torch.randn((batch, NZ), **f64)
    yr = torch.tensor([1.0, 0.0], dtype=torch.float64).repeat(batch, horizon)
    warm = 0.1 * torch.randn((batch, horizon * m), **f64)
    bad = []
    if poison:
        bad = [1, batch // 7, batch // 3, batch // 2, batch - 2]
        a[bad[0], 0, 0] = float("nan")
        a[bad[1], 3, 4] = float("inf")
        z0[bad[2], 0] = float("inf")
        b[bad[3], 2, 0] = -float("inf")  # the Markov clamp keeps it finite
        cyc[bad[4], 0, 0] = float("nan")
    return [t.to(device=device, dtype=dtype).contiguous()
            for t in (a, b, cyc, z0, yr, warm)], bad


def compare_fused(out, ref):
    """``(max |out - ref| where both are finite, same NaN/inf pattern)``."""
    import torch

    same = bool((out.isnan() == ref.isnan()).all()
                and (out.isinf() == ref.isinf()).all())
    both = torch.isfinite(out) & torch.isfinite(ref)
    err = float((out - ref)[both].abs().max()) if bool(both.any()) else 0.0
    return err, same


def fused_qp_bound_ms(batch: int, nz: int, m: int, py: int, horizon: int,
                      iters: int, schulz: int, dtype: str):
    """Least time for the fused QP on an H100 SXM: bytes (A, B, CyC, z0,
    yr, warm read once, u written once) over HBM rate vs operations over
    the dtype's peak. Operations as the kernels do them per scenario
    (an FMA counts 2):
      Markov recursion, N x 2 (py nz m + py nz^2 + nz^2 + py nz);
      weighted error 2 N py;
      H from the blocks, skipping F2's structural zeros:
        3 py m^2 sum_{k<N} (N - k)(2k + 1), plus q, 2 py m N(N + 1)/2;
      trace, shift, norms and seed, 2 nx + 5 nx^2;
      Newton-Schulz, schulz x (4 nx^3 + nx^2);
      ADMM, iters x (2 nx^2 + 12 nx) (as box_admm's bound)."""
    nx, item = horizon * m, (4 if dtype == "float32" else 8)
    nbytes = batch * item * (nz * nz + nz * m + py * nz + nz + horizon * py
                             + 2 * horizon * m)
    toeplitz = sum((horizon - k) * (2 * k + 1) for k in range(horizon))
    per = (horizon * 2 * (py * nz * m + py * nz * nz + nz * nz + py * nz)
           + 2 * horizon * py
           + 3 * py * m * m * toeplitz + py * m * horizon * (horizon + 1)
           + 2 * nx + 5 * nx * nx
           + schulz * (4 * nx ** 3 + nx * nx)
           + iters * (2 * nx * nx + 12 * nx))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = batch * per / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_qp_soa_ptxas_registers(regs, dtype: str, shape):
    """ptxas's registers for the SoA instance that ``shape``
    (:func:`koopmanx_torch.ops.fused_qp_soa.launch_shape`) names, or None."""
    t = "f" if dtype == "float32" else "d"
    if shape.instance == "shared":  # fused_qp_soa_smem<T, NXP, R, S>
        key = f"fused_qp_soa_smemI{t}Li{shape.nxp}E"
    else:
        key = f"fused_qp_soa_globalI{t}E"
    found = [n for name, n in regs.items() if key in name]
    return found[0] if len(found) == 1 else None


def ptxas_stack_and_spills(log: str):
    """``[(kernel, stack bytes, spill store bytes, spill load bytes)]`` from
    the ``nvcc -Xptxas -v`` report of one build."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            out.append((entry, *map(int, m.groups())))
            entry = None
    return out


def fused_qp_ptxas_registers(regs, dtype: str, shape, nx: int):
    """ptxas's registers for the AoS instance that ``shape``
    (:func:`koopmanx_torch.ops.fused_qp.aos_launch_shape`) names, or None."""
    t = "f" if dtype == "float32" else "d"
    if shape.instance == "regs":  # fused_qp_regs<T, NXP>
        key = f"fused_qp_regsI{t}Li{shape.nxp}E"
    else:  # fused_qp_generic<T, ROWS>, ROWS = 1, 2 or 4
        rows = -(-nx // 32)
        key = f"fused_qp_genericI{t}Li{1 if rows == 1 else 2 if rows == 2 else 4}E"
    found = [n for name, n in regs.items() if key in name]
    return found[0] if len(found) == 1 else None


# Cases beyond the three both fused kernels run, one for each edge of their
# designs: (dtype, batch, horizon, m). N = 10 is the convergence gate's
# shape (B3's shared instance and B2's register instance, NXP = 12 both);
# m = 2 gives N*m = 40, past both (B3's global instance, B2's first
# design); N = 8, m = 4 gives N*m = 32, B2's widest register instance (two
# 4 x 4 tiles on every lane). B = 1000 is no multiple of 32 (nor of the
# global instance's 64, nor of 8 warps a block)
SOA_EDGES = (("float32", 1000, 10, 1), ("float64", 1000, 10, 1),
             ("float32", 1000, HORIZON, 2), ("float64", 1000, HORIZON, 2))
AOS_EDGES = (("float32", 1000, 8, 4), ("float64", 1000, 8, 4))


def parent_fused_qp(path: str):
    """``fused_qp_solve``'s launch through another build of the AoS kernel
    (``path``, a ``libfused_qp.so`` with the same C interface), counted
    nowhere."""
    import torch
    from koopmanx_torch.ops.fused_qp import KernelLib

    lib = KernelLib("fused_qp", n_ptrs=7, path=os.path.abspath(path))

    def solve(a, b, cyc, z0, yr, warm, cfg):
        u = torch.empty_like(warm)
        lib.launch([t.data_ptr() for t in (a, b, cyc, z0, yr, warm, u)],
                   [a.shape[0], a.shape[-1], b.shape[-1], cyc.shape[-2],
                    cfg.horizon], cfg, a.dtype, a.device)
        return u

    return solve


def phase_fused_checks(device, ptxas=None, names=("fused_qp", "fused_qp_soa"),
                       parent_lib=None):
    """The fused kernels in ``names`` vs the plain version on the card, with
    poisoned scenarios (float32 at B=8192 and 1000, float64 at 1000), then
    at ``SOA_EDGES`` (both) and ``AOS_EDGES`` (B2); every case with its
    instance and launch shape. Returns their kernels-line entries (float32,
    B=8192). ``ptxas`` maps a kernel's name to :func:`ptxas_registers` of
    phase 1's build of it. ``parent_lib``: see ``--parent-fused-qp``."""
    import torch
    from koopmanx_torch.ops import FusedQPConfig, fused_qp_solve, fused_qp_solve_soa
    from koopmanx_torch.ops.fused_qp import aos_launch_shape, fused_qp_reference
    from koopmanx_torch.ops.fused_qp_soa import launch_shape as soa_launch_shape

    kernels = {"fused_qp": (fused_qp_solve, "koopmanx_torch/csrc/fused_qp.cu",
                            "koopmanx/ops/qp_pallas.py:214 (fused_qp_solve;"
                            " pallas_call at :246)"),
               "fused_qp_soa": (fused_qp_solve_soa,
                                "koopmanx_torch/csrc/fused_qp_soa.cu",
                                "koopmanx/ops/qp_pallas_soa.py:189"
                                " (fused_qp_solve_soa; pallas_call at :227)")}
    ptxas = ptxas or {}
    runs = [(d, b, HORIZON, M_IN, tuple(kernels))
            for d, b in (("float32", BATCH), ("float32", 1000),
                         ("float64", 1000))]
    runs += [(*edge, tuple(kernels)) for edge in SOA_EDGES]
    runs += [(*edge, ("fused_qp",)) for edge in AOS_EDGES]
    entries = {}
    for dname, batch, horizon, m, case_names in runs:
        case_names = [n for n in case_names if n in names]
        if not case_names:
            continue
        dtype = getattr(torch, dname)
        cfg = FusedQPConfig(horizon=horizon, iters=ITERS, schulz_iters=SCHULZ)
        args, bad = fused_inputs(batch, dtype, device, seed=batch, m=m,
                                 horizon=horizon)
        ref = fused_qp_reference(*args, cfg)
        floor = compare_fused(
            ref.double(), fused_qp_reference(*(t.double() for t in args), cfg))[0]
        clean = torch.ones(batch, dtype=torch.bool, device=device)
        clean[bad] = False
        for name in case_names:
            fn, source, replaces = kernels[name]
            out = fn(*args, cfg)
            torch.cuda.synchronize()
            err, same = compare_fused(out, ref)
            case = {"dtype": dname, "batch": batch, "horizon": horizon, "m": m,
                    "iters": ITERS, "schulz_iters": SCHULZ,
                    "max_abs_err": err, "tol": FUSED_TOL[dname],
                    "nan_inf_pattern_same": same, "poisoned": len(bad),
                    "poisoned_all_nan": int(out[bad].isnan().all(-1).sum()),
                    "clean_finite": bool(torch.isfinite(out[clean]).all()),
                    "floor_plain_f32_vs_f64": floor}
            if name == "fused_qp_soa":
                shape = soa_launch_shape(dtype, batch, NZ, m, PY, cfg)
                regs = fused_qp_soa_ptxas_registers(ptxas.get(name, {}),
                                                    dname, shape)
            else:
                shape = aos_launch_shape(dtype, batch, NZ, m, PY, cfg)
                regs = fused_qp_ptxas_registers(ptxas.get(name, {}), dname,
                                                shape, horizon * m)
            case["launch"] = {**shape._asdict(), "registers_from": "runtime"}
            if regs is not None:
                case["launch"].update(registers=regs, registers_from="ptxas")
            shape_note = (f"; instance {shape.instance} (NXP {shape.nxp}), "
                          f"{case['launch']['registers']} registers, "
                          f"{shape.shared_bytes} shared bytes/block, "
                          f"{shape.warps_per_block} warps/block, "
                          f"{shape.resident_warps_per_sm} resident "
                          f"warps/SM, {shape.waves} waves")
            print(f"kernel {name} {dname} B={batch} N={horizon} m={m}: "
                  f"max|kernel-plain| = {err:.3e} (tol {case['tol']:.0e}), "
                  f"NaN/inf pattern same {same}, poisoned all-NaN "
                  f"{case['poisoned_all_nan']}/{len(bad)}, plain f32-vs-f64 "
                  f"floor {floor:.3e}{shape_note}", flush=True)
            if (tuple(out.shape) != tuple(args[5].shape) or not same
                    or not case["clean_finite"] or not err <= case["tol"]):
                fail(f"{name} disagrees with its plain version: {case}")
            if name not in entries:  # float32 at the path's shape
                ms = device_ms(lambda: fn(*args, cfg), reps=20)
                back_to_back = cuda_ms(lambda: fn(*args, cfg), reps=50)
                plain_ms = cuda_ms(lambda: fused_qp_reference(*args, cfg),
                                   reps=5)
                bound, bound_by = fused_qp_bound_ms(
                    batch, NZ, m, PY, horizon, ITERS, SCHULZ, dname)
                entries[name] = {
                    "name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": err, "tol": case["tol"], "ms": ms,
                    "ms_back_to_back": back_to_back, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": None,  # no single PyTorch call computes it
                    **case.get("launch", {}),
                    "shape": {"batch": batch, "nz": NZ, "m": m, "py": PY,
                              "horizon": horizon, "iters": ITERS,
                              "schulz_iters": SCHULZ, "dtype": dname},
                    "checks": []}
                if name == "fused_qp" and parent_lib:
                    entries[name]["parent"] = compare_parent(
                        parent_fused_qp(parent_lib), args, cfg, out)
            entries[name]["checks"].append(case)
    return entries


def compare_parent(parent, args, cfg, out):
    """Not gated: max |kernel - parent kernel| on the same inputs (where
    both are finite; the NaN/inf patterns beside it), and both kernels'
    device times in turns: parent, this, this, parent."""
    from koopmanx_torch.ops import fused_qp_solve

    ref = parent(*args, cfg)
    err, same = compare_fused(out, ref)
    turns = [device_ms(lambda f=f: f(*args, cfg), reps=20)
             for f in (parent, fused_qp_solve, fused_qp_solve, parent)]
    report = {"max_abs_diff": err, "nan_inf_pattern_same": same,
              "parent_ms": [turns[0], turns[3]], "ms": turns[1:3]}
    print(f"kernel fused_qp vs parent: max|kernel-parent| = {err:.3e}, "
          f"NaN/inf pattern same {same}; device ms parent {turns[0]:.5f}, "
          f"this {turns[1]:.5f}, this {turns[2]:.5f}, parent {turns[3]:.5f}",
          flush=True)
    return report


def kernel_counters():
    """Every kernel wrapper of the port, by kernel name."""
    from koopmanx_torch.ops import fused_qp_solve, fused_qp_solve_soa
    from koopmanx_torch.ops.box_admm import box_admm

    return {"box_admm": box_admm, "fused_qp": fused_qp_solve,
            "fused_qp_soa": fused_qp_solve_soa}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def fused_config(pipe, py: int, m: int):
    """FusedQPConfig from the flagship RunConfig and its engine config:
    horizon, ADMM iterations, rho, sigma, alpha and f_clamp, the stage
    weights and the input box per channel (Newton-Schulz steps: the
    config's default, 16)."""
    from koopmanx_torch.ops import FusedQPConfig

    mc, ec = pipe.config.mpc, pipe.engine_cfg
    return FusedQPConfig(
        horizon=mc.horizon, iters=mc.qp_iters, rho=mc.qp_rho,
        sigma=ec.qp_sigma, alpha=ec.qp_alpha, f_clamp=ec.f_clamp,
        qdiag=(mc.q_weight,) * py, rdiag=(mc.r_weight,) * m,
        u_lo=(mc.u_min,) * m, u_hi=(mc.u_max,) * m)


def phase_fused_path(pipe, carry, device):
    """Phase 6: the fused entry points on the flagship loop's end state.
    Returns the launch counts of that run."""
    import torch
    from koopmanx_torch import ops
    from koopmanx_torch.engine.core import make_control_solver
    from koopmanx_torch.ops.fused_qp import (
        fused_qp_reference,
        fused_qp_terms,
        newton_schulz_kkt_inverse,
    )
    from koopmanx_torch.run import ref_fn_for, replicate

    params, model = pipe.params, carry.model
    py, m = params.q_block.shape[0], model.B.shape[-1]
    z = pipe.dictionary(carry.x)
    cyc = model.C if params.cy is None else params.cy @ model.C
    ref_fn = ref_fn_for(pipe.config, py, device)
    yr = ref_fn(STEPS).reshape(-1).expand(BATCH, -1)
    args = [t.contiguous() for t in (model.A, model.B, cyc, z, yr,
                                     carry.warm_x)]
    cfg = fused_config(pipe, py, m)

    zero_counts()
    u_aos, s_aos = timed(lambda: ops.fused_qp_solve(*args, cfg))
    u_soa, s_soa = timed(lambda: ops.fused_qp_solve_soa(*args, cfg))
    counts = read_counts()

    ref = fused_qp_reference(*args, cfg)
    err_aos, same_aos = compare_fused(u_aos, ref)
    err_soa, same_soa = compare_fused(u_soa, ref)
    err_pair, same_pair = compare_fused(u_aos, u_soa)
    control_solve = make_control_solver(pipe.engine_cfg, ref_fn, m)
    dec, s_engine = timed(lambda: control_solve(
        replicate(params, BATCH), model, z, carry.u_applied, carry.warm_x,
        carry.warm_y, STEPS))
    gap = (u_aos[:, :m] - dec.u_applied).abs().amax(-1)
    p_mat, _ = fused_qp_terms(*args[:5], cfg)
    kkt, x_inv, _ = newton_schulz_kkt_inverse(p_mat, cfg)
    eye = torch.eye(kkt.shape[-1], dtype=kkt.dtype, device=device)
    ns_res = torch.linalg.matrix_norm(eye - kkt @ x_inv)
    converged = ns_res <= 1e-3
    tol = FUSED_TOL["float32"]
    report = {
        "batch": BATCH, "horizon": cfg.horizon, "m": m, "py": py,
        "nz": model.A.shape[-1], "iters": cfg.iters,
        "schulz_iters": cfg.schulz_iters, "launches": counts,
        "fused_qp_vs_plain": err_aos, "fused_qp_soa_vs_plain": err_soa,
        "fused_qp_vs_soa": err_pair, "tol": tol,
        "finite_share": float(torch.isfinite(u_aos).all(-1).float().mean()),
        "fused_qp_s": s_aos, "fused_qp_soa_s": s_soa,
        "first_move_gap_to_engine": {"max": float(gap.max()),
                                     "median": float(gap.median()),
                                     "max_where_ns_residual_le_1e-3":
                                         float(gap[converged].max())
                                         if bool(converged.any()) else None,
                                     "engine_control_solve_s": s_engine},
        "newton_schulz_residual_fro": {
            "median": float(ns_res.median()), "max": float(ns_res.max()),
            "share_le_1e-3": float(converged.float().mean())}}
    print("phase 6 fused path " + json.dumps(report), flush=True)
    if counts["fused_qp"] != 1 or counts["fused_qp_soa"] != 1:
        fail(f"the fused entry points launched {counts}, not once each")
    for label, err, same, limit in (("fused_qp", err_aos, same_aos, tol),
                                    ("fused_qp_soa", err_soa, same_soa, tol),
                                    ("fused_qp vs soa", err_pair, same_pair,
                                     2 * tol)):
        if not same or not err <= limit:
            fail(f"phase 6 {label}: max diff {err} (tol {limit}), NaN/inf "
                 f"pattern same {same}")
    if tuple(u_aos.shape) != (BATCH, cfg.horizon * m):
        fail(f"phase 6 fused_qp shape {tuple(u_aos.shape)}")
    if not bool((u_aos.abs() <= 2.0).all()):
        fail("phase 6 fused_qp: non-finite u or |u| > 2")
    return counts


def phase_convergence(device):
    """tests/test_pallas.py:46-61 at B=8192: both kernels at convergence
    against the port's general solve_qp on the same condensed QPs."""
    import torch
    from koopmanx_torch import ops
    from koopmanx_torch.control import condensed as tc
    from koopmanx_torch.control.qp import ADMMConfig, solve_qp
    from koopmanx_torch.types import LinearModel, QPData

    n_h, f64 = CONVERGED["horizon"], torch.float64
    args, _ = fused_inputs(BATCH, f64, device, seed=7, horizon=n_h,
                           poison=False)
    a, b, cyc, z0, yr, warm = args
    warm = torch.zeros_like(warm)  # the fixture's cold start
    cfg = ops.FusedQPConfig(horizon=n_h, iters=CONVERGED["iters"],
                            schulz_iters=CONVERGED["schulz_iters"])
    eye = lambda k: torch.eye(k, dtype=f64, device=device).expand(BATCH, k, k)
    pred = tc.prediction_matrices(LinearModel(a, b, cyc), n_h)
    lo = torch.full((BATCH, n_h * M_IN), -2.0, dtype=f64, device=device)
    box = tc.condensed_qp(pred, z0, yr, tc.weight_bar(100.0 * eye(PY), n_h),
                          1e-4 * eye(n_h * M_IN), lo, -lo)
    qp = QPData(box.P, box.q, eye(n_h * M_IN), box.l, box.u)
    admm = ADMMConfig(iters=CONVERGED["iters"], rho=0.1)
    ref = solve_qp(qp, admm).x
    f32 = [t.float() for t in (a, b, cyc, z0, yr, warm)]
    gaps, gaps_f32 = {}, {}
    for name, fn in (("fused_qp", ops.fused_qp_solve),
                     ("fused_qp_soa", ops.fused_qp_solve_soa)):
        gaps[name] = float((fn(a, b, cyc, z0, yr, warm, cfg) - ref).abs().max())
        gaps_f32[name] = float((fn(*f32, cfg).double() - ref).abs().max())
    # the general solver itself in float32 (block-1 Gauss-Jordan KKT inverse)
    ref32 = solve_qp(QPData(*(t.float() for t in qp)), admm).x.double()
    off32 = (ref32 - ref).abs().amax(-1)
    print("phase 6 convergence " + json.dumps(
        {"batch": BATCH, **CONVERGED, "max_gap_to_solve_qp_f64": gaps,
         "not gated": {"float32_kernels_vs_f64_solve_qp": gaps_f32,
                       "solve_qp_f32_vs_f64": float(off32.max()),
                       "solve_qp_f32_qps_off_by_over_5e-3":
                           int((off32 > CONVERGED["tol"]).sum())}}),
        flush=True)
    for name, gap in gaps.items():
        if not gap <= CONVERGED["tol"]:
            fail(f"{name} at convergence is {gap} from solve_qp "
                 f"(tol {CONVERGED['tol']})")


def phase_kernel_checks(device, ptxas_regs=None):
    """Kernel vs plain version on the card, at the main path's width and at
    every compiled instance's (``BOX_WIDTHS``); returns the kernels-line
    entry for the main path's shape and every case checked. ``ptxas_regs``
    is :func:`ptxas_registers` of phase 1's build of the kernel."""
    import torch
    from koopmanx_torch.ops.box_admm import (
        box_admm,
        box_admm_reference,
        launch_shape,
    )

    f32, f64 = torch.float32, torch.float64
    runs = [(f32, BATCH, HORIZON, "shared"), (f32, 1000, HORIZON, "shared"),
            (f64, 1000, HORIZON, "shared")]
    runs += [(dtype, 1000, nx, "shared") for nx in BOX_WIDTHS
             for dtype in (f32, f64)]
    # the shipped duffing preset's width, the tank path's folded
    # per-scenario bounds at its width, and tank_mimo's N*m = 40 (the
    # shared-memory instance; synthetic, then the loop's own first step),
    # all at the paths' batch
    runs += [(dtype, BATCH, nx, bounds)
             for nx, bounds in ((PRESET_NX, "shared"), (HORIZON, "folded"),
                                (MIMO_NX, "shared"),
                                (MIMO_NX, "tank_mimo step 0"))
             for dtype in (f32, f64)]
    cases = []
    main = None
    for dtype, batch, nx, bounds in runs:
        name = str(dtype).replace("torch.", "")
        if bounds == "tank_mimo step 0":
            args = tank_mimo_step0_inputs(device, name)
        else:
            args = box_inputs(batch, nx, dtype, device, seed=batch,
                              folded=bounds == "folded")
        kw = dict(iters=ITERS, sigma=SIGMA, alpha=ALPHA)
        out = box_admm(*args, **kw)
        ref = box_admm_reference(*args, **kw)
        torch.cuda.synchronize()
        dist = lambda a, b: max(float((o - r).abs().max())
                                for o, r in zip(a, b))
        err = dist(out, ref)
        scale = max(1.0, max(float(r.abs().max()) for r in ref))
        finite = all(bool(torch.isfinite(o).all()) for o in out)
        shape = launch_shape(dtype, batch, nx)
        case = {"dtype": name, "batch": batch, "nx": nx, "iters": ITERS,
                "bounds": bounds, "max_abs_err": err,
                "tol": TOL[name] * scale, "launch": shape._asdict()}
        if bounds == "tank_mimo step 0":
            # the loop's own KKT inverse (condition number 106, the same in
            # every scenario) lifts the float32 round-off floor above TOL:
            # the plain version summed in another order moves by 3.4e-4 on
            # these inputs (CPU). The kernel is held to twice that floor,
            # measured here on the same inputs; in float64 TOL is larger
            case["floor"] = dist(box_admm_reassociated(*args, **kw), ref)
            case["tol"] = max(case["tol"], 2.0 * case["floor"])
        timing = ""
        if nx == MIMO_NX and bounds == "shared":
            # tank_mimo's width: device time against the bound
            case["ms"] = device_ms(lambda: box_admm(*args, **kw), reps=50)
            case["bound_ms"], case["bound_by"] = box_admm_bound_ms(
                batch, nx, ITERS, name)
            case["bound_share"] = case["bound_ms"] / case["ms"]
            timing = (f"; {case['ms']:.5f} ms device, bound "
                      f"{case['bound_ms']:.5f} ms ({case['bound_by']}), "
                      f"{100 * case['bound_share']:.1f} % of it")
        cases.append(case)
        floor = (f", plain reassociated {case['floor']:.3e}"
                 if "floor" in case else "")
        print(f"kernel box_admm {name} B={batch} nx={nx} {bounds} "
              f"bounds: max|kernel-plain| ="
              f" {err:.3e} (tol {case['tol']:.1e}{floor}); {shape.registers} "
              f"registers, {shape.warps_per_block} warps/block, "
              f"{shape.resident_warps_per_sm} resident warps/SM, "
              f"{shape.waves} waves{timing}", flush=True)
        if not finite or not err <= case["tol"]:
            fail(f"box_admm disagrees with its plain version: {case}")
        if main is None:  # float32 at the main path's shape
            ms = device_ms(lambda: box_admm(*args, **kw), reps=50)
            back_to_back = cuda_ms(lambda: box_admm(*args, **kw), reps=50)
            plain_ms = cuda_ms(lambda: box_admm_reference(*args, **kw), reps=5)
            bound, bound_by = box_admm_bound_ms(batch, HORIZON, ITERS, name)
            regs = box_admm_ptxas_registers(ptxas_regs or {}, name, nx)
            main = {
                "name": "box_admm",
                "route": "cuda",
                "source": "koopmanx_torch/csrc/box_admm.cu",
                "replaces": "koopmanx/ops/qp_pallas_box.py:131 (box_admm_pallas;"
                            " pallas_call at :188)",
                "launches": None,
                "max_abs_err": err,
                "tol": case["tol"],
                "ms": ms,
                "ms_back_to_back": back_to_back,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes it
                # ptxas's count from phase 1, else the runtime's (same
                # number) when the library was built before this run
                "registers": shape.registers if regs is None else regs,
                "registers_from": "runtime" if regs is None else "ptxas",
                "resident_warps_per_sm": shape.resident_warps_per_sm,
                "warps_per_block": shape.warps_per_block,
                "waves": shape.waves,
                "shape": {"batch": batch, "nx": HORIZON, "iters": ITERS,
                          "dtype": name},
            }
    main["checks"] = cases
    return main


def quality(log, tail: int = 50):
    """Batch-mean tracking MSE and steady-state error of x1 against r1."""
    err = log.x[..., 0] - log.r[..., 0]
    mse = float((err ** 2).mean())
    sse = float(err[:, -tail:].abs().mean())
    return mse, sse


def run_loop(backend: str, device, steps: int = STEPS, dtype: str = "float32",
             nudge: bool = False):
    """The flagship loop as a thunk; ``nudge`` moves every x0 up by one
    ulp (the round-off floor of the comparison)."""
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_pipeline, run_scenarios
    from koopmanx_torch.systems.library import get_system

    cfg = flagship_config(steps=steps, horizon=HORIZON, qp_backend=backend)
    cfg.dtype = dtype
    pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), BATCH,
                          param_scale=0.15, dtype=getattr(torch, dtype),
                          device=device)
    if nudge:
        sc = sc._replace(x0=torch.nextafter(sc.x0, torch.full_like(sc.x0, 9.0)))

    def run():
        return run_scenarios(pipe, sc)

    run.pipe, run.batch = pipe, sc
    return run


def timed(fn):
    """``(fn(), seconds)``, timed by CUDA events around the call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def check_loop(carry, log, name: str, steps: int = STEPS):
    import torch

    for label, t in (("x", log.x), ("u", log.u), ("final x", carry.x)):
        if not bool(torch.isfinite(t).all()):
            fail(f"{name} loop: non-finite {label}")
    u_max = float(log.u.abs().max())
    if u_max > 2.0:
        fail(f"{name} loop: |u| = {u_max} > 2")
    if tuple(log.x.shape) != (BATCH, steps, 2):
        fail(f"{name} loop: log.x shape {tuple(log.x.shape)}")


def quality_x2(log, tail: int = 50):
    """Batch-mean tracking MSE and steady-state error of the tank's tracked
    level x2 against its reference (the single output channel)."""
    err = log.x[..., 1] - log.r[..., 0]
    return float((err ** 2).mean()), float(err[:, -tail:].abs().mean())


def tank_loop(backend: str, device, steps: int = TANK_STEPS,
              dtype: str = "float32"):
    """The tank bench loop as a thunk (x0 ~ U[0, 2]^2)."""
    from koopmanx_torch.configs import tank_bench_config

    return config_loop(tank_bench_config(steps=steps, qp_backend=backend),
                       device, dtype, x0_range=(0.0, 2.0))


def check_tank_loop(carry, log, name: str, steps: int = TANK_STEPS):
    """Finite logs and final carry (ring and model included), the du box
    per step (from u = 0), the applied window, x >= 0, the shapes."""
    import torch

    leaves = [log.x, log.u, carry.x, carry.u_applied, carry.warm_x,
              *carry.model, *(t for t in carry.rls if t is not None)]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail(f"tank {name} loop: non-finite logs or final carry")
    u = torch.cat([torch.zeros_like(log.u[:, :1]), log.u], dim=1)
    du = float((u[:, 1:] - u[:, :-1]).abs().max())
    u_max, x_min = float(log.u.abs().max()), float(log.x.min())
    if du > DU_MAX + BOUND_SLACK or u_max > APPLIED_MAX + BOUND_SLACK:
        fail(f"tank {name} loop: |du| = {du}, |u| = {u_max}")
    if x_min < 0.0 or float(carry.x.min()) < 0.0:
        fail(f"tank {name} loop: x = {x_min} < 0")
    if tuple(log.x.shape) != (BATCH, steps, 2):
        fail(f"tank {name} loop: log.x shape {tuple(log.x.shape)}")
    return {"du_max": du, "u_abs_max": u_max, "x_min": x_min}


def phase_tank(device, card: str):
    """Phase 7: the tank path through both routes, with its gates. Returns
    the kernel route's launch counts."""
    import torch
    from koopmanx_torch.ops.box_admm import box_admm

    run_kernel = tank_loop("pallas", device)
    zero_counts()
    (carry_k, log_k), cold_k = timed(run_kernel)
    counts = read_counts()
    print(f"phase 7 tank path (pallas): {cold_k:.2f} s cold, launches "
          f"{counts}", flush=True)
    if counts != {"box_admm": TANK_STEPS, "fused_qp": 0, "fused_qp_soa": 0}:
        fail(f"the tank path launched {counts} in {TANK_STEPS} steps")
    bounds_k = check_tank_loop(carry_k, log_k, "pallas")

    run_plain = tank_loop("xla", device)
    box_admm.launches = 0
    (carry_p, log_p), cold_p = timed(run_plain)
    if box_admm.launches != 0:
        fail("the tank plain route launched the kernel")
    bounds_p = check_tank_loop(carry_p, log_p, "xla")
    early = {}
    for backend in ("pallas", "xla"):
        carry, log = tank_loop(backend, device, LOOP_EARLY_STEPS, "float64")()
        check_tank_loop(carry, log, f"{backend} float64", LOOP_EARLY_STEPS)
        early[backend] = log.x
    dx64 = float((early["pallas"] - early["xla"]).abs().max())
    (mse_k, sse_k), (mse_p, sse_p) = quality_x2(log_k), quality_x2(log_p)
    gate = {"dx_first16_f64": dx64, "dx_first16_f64_tol": LOOP_EARLY_TOL,
            "dx_first16_f32": float((log_k.x[:, :LOOP_EARLY_STEPS]
                                     - log_p.x[:, :LOOP_EARLY_STEPS])
                                    .abs().max()),
            "mse_x2_kernel": mse_k, "mse_x2_plain": mse_p,
            "sse_x2_kernel": sse_k, "sse_x2_plain": sse_p,
            "quality_rtol": QUALITY_RTOL, "bounds_kernel": bounds_k,
            "bounds_plain": bounds_p, "bound_slack": BOUND_SLACK}
    print("phase 7 gate " + json.dumps(gate), flush=True)
    if not dx64 <= LOOP_EARLY_TOL:
        fail(f"float64 tank kernel and plain loops differ by {dx64} in the "
             f"first {LOOP_EARLY_STEPS} steps")
    for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                       (sse_k, sse_p, "steady-state error")):
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"tank x2 {what}: kernel {a} vs plain {b}")

    walls = {run_plain: [], run_kernel: []}
    for fn in (run_plain, run_kernel, run_kernel, run_plain):
        walls[fn].append(timed(fn)[1])
    switch = run_kernel.pipe.config.switch_step
    x2 = log_k.x[..., 1]
    route = lambda runs: {"runs_s": runs,
                          "ms_per_step": sum(runs) / 2 / TANK_STEPS * 1e3,
                          "solves_per_s": BATCH * TANK_STEPS * 2 / sum(runs)}
    line = {"slice": "tank bench loop, koopmanx_torch", "batch": BATCH,
            "steps": TANK_STEPS, "switch_step": switch, "horizon": HORIZON,
            "dtype": "float32",
            "kernel_route": {**route(walls[run_kernel]), "cold_wall_s": cold_k},
            "plain_route": {**route(walls[run_plain]), "cold_wall_s": cold_p},
            "x2_tail_mean_pre_switch": float(x2[:, switch - 50:switch].mean()),
            "x2_tail_mean_post_switch": float(x2[:, -50:].mean()),
            "card": card}
    print(json.dumps(line), flush=True)
    return counts


def phase_duffing_preset(device, flagship_quality):
    """Phase 8: the shipped duffing preset (its .mat weights, normalized
    lift, horizon 10) through the kernel route. Returns the launches, the
    log and the run's thunk (for phase 19 (c))."""
    import torch
    from koopmanx_torch.configs import duffing_nn_preset
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_pipeline, resolve_weights_path, run_scenarios
    from koopmanx_torch.systems.library import get_system

    cfg = duffing_nn_preset()
    cfg.steps = PRESET_STEPS
    cfg.mpc.qp_backend = "pallas"
    weights = resolve_weights_path(cfg.lift.weights_path, cfg.system)
    artifact = os.path.join(ROOT, "artifacts", "duffing_kmae_encoder.mat")
    if weights != artifact:
        fail(f"the duffing preset resolves its weights to {weights}, not the "
             f"in-repo {artifact}")
    pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), BATCH,
                          param_scale=0.15, device=device)
    run = lambda: run_scenarios(pipe, sc)
    zero_counts()
    (carry, log), wall = timed(run)
    counts = read_counts()
    mse, sse = quality(log)
    report = {"weights": os.path.relpath(weights, ROOT), "batch": BATCH,
              "steps": PRESET_STEPS, "horizon": cfg.mpc.horizon,
              "launches": counts, "wall_s_cold": wall,
              "u_abs_max": float(log.u.abs().max()),
              "mse_x1": mse, "sse_x1": sse,
              "flagship_random_init_mse_x1": flagship_quality[0],
              "flagship_random_init_sse_x1": flagship_quality[1]}
    print("phase 8 duffing preset " + json.dumps(report), flush=True)
    if counts["box_admm"] != PRESET_STEPS:
        fail(f"the duffing preset launched {counts} in {PRESET_STEPS} steps")
    check_loop(carry, log, "duffing preset", PRESET_STEPS)
    return counts, log, run


def config_loop(cfg, device, dtype: str = "float32",
                x0_range=(-2.0, 2.0), batch: int = BATCH):
    """The loop of ``cfg`` as a thunk through the user entry points, over
    the bench's scenarios (x0 ~ U[x0_range]^2, param_scale 0.15); the
    thunk takes another x0 for the same scenarios."""
    import torch
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_pipeline, run_scenarios
    from koopmanx_torch.systems.library import get_system

    cfg.dtype = dtype
    pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), batch,
                          x0_range=x0_range, param_scale=0.15,
                          dtype=getattr(torch, dtype), device=device)

    def run(x0=None):
        return run_scenarios(pipe, sc if x0 is None else sc._replace(x0=x0))

    run.pipe, run.x0, run.batch = pipe, sc.x0, sc
    return run


def rbf128_loop(backend: str, device, steps: int = RBF128_STEPS,
                dtype: str = "float32", store: str = "float32"):
    from koopmanx_torch.configs import rbf128_bench_config

    cfg = rbf128_bench_config(steps=steps, qp_backend=backend)
    cfg.update.window_store = store
    return config_loop(cfg, device, dtype)


def check_woodbury_loop(carry, log, name: str, steps: int = RBF128_STEPS):
    """Finite logs and final carry (model, rings and carried statistics
    included), |u| <= 2, the shapes."""
    import torch

    leaves = [log.x, log.u, carry.x, carry.u_applied, carry.warm_x,
              *carry.model, *(t for t in carry.rls if t is not None)]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail(f"{name} loop: non-finite logs or final carry")
    if carry.rls.g is None:
        fail(f"{name} loop: no carried statistics")
    check_loop(carry, log, name, steps)


def run_with_memory(fn):
    """``(fn(), seconds, peak device bytes)``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, wall = timed(fn)
    return out, wall, torch.cuda.max_memory_allocated()


def phase_rbf128(device, card: str):
    """Phase 9: the rbf128 bench loop through both routes, with its gates.
    Returns the kernel route's launch counts and a report for phase 10."""
    from koopmanx_torch.ops.box_admm import box_admm

    run_kernel = rbf128_loop("pallas", device)
    zero_counts()
    (carry_k, log_k), cold_k, mem_k = run_with_memory(run_kernel)
    counts = read_counts()
    print(f"phase 9 rbf128 path (pallas): {cold_k:.2f} s cold, launches "
          f"{counts}, peak {mem_k / 2**30:.2f} GiB", flush=True)
    if counts != {"box_admm": RBF128_STEPS, "fused_qp": 0, "fused_qp_soa": 0}:
        fail(f"the rbf128 path launched {counts} in {RBF128_STEPS} steps")
    check_woodbury_loop(carry_k, log_k, "rbf128 pallas")

    run_plain = rbf128_loop("xla", device)
    box_admm.launches = 0
    (carry_p, log_p), cold_p, mem_p = run_with_memory(run_plain)
    if box_admm.launches != 0:
        fail("the rbf128 plain route launched the kernel")
    check_woodbury_loop(carry_p, log_p, "rbf128 xla")
    early, mem64 = {}, {}
    for backend in ("pallas", "xla"):
        (carry, log), _, mem64[backend] = run_with_memory(rbf128_loop(
            backend, device, LOOP_EARLY_STEPS, "float64"))
        check_woodbury_loop(carry, log, f"rbf128 {backend} float64",
                            LOOP_EARLY_STEPS)
        early[backend] = log.x
    dx64 = float((early["pallas"] - early["xla"]).abs().max())
    (mse_k, sse_k), (mse_p, sse_p) = quality(log_k), quality(log_p)
    gate = {"batch": BATCH, "nlift": run_kernel.pipe.dictionary.nlift,
            "dx_first16_f64": dx64, "dx_first16_f64_tol": LOOP_EARLY_TOL,
            "dx_first16_f32": float((log_k.x[:, :LOOP_EARLY_STEPS]
                                     - log_p.x[:, :LOOP_EARLY_STEPS])
                                    .abs().max()),
            "mse_kernel": mse_k, "mse_plain": mse_p,
            "sse_kernel": sse_k, "sse_plain": sse_p,
            "quality_rtol": QUALITY_RTOL,
            "u_abs_max": float(log_k.u.abs().max()),
            "peak_gib": {"float32 kernel": mem_k / 2**30,
                         "float32 plain": mem_p / 2**30,
                         "float64 kernel, 16 steps": mem64["pallas"] / 2**30,
                         "float64 plain, 16 steps": mem64["xla"] / 2**30}}
    print("phase 9 gate " + json.dumps(gate), flush=True)
    if not dx64 <= LOOP_EARLY_TOL:
        fail(f"float64 rbf128 kernel and plain loops differ by {dx64} in the "
             f"first {LOOP_EARLY_STEPS} steps")
    for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                       (sse_k, sse_p, "steady-state error")):
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"rbf128 x1 {what}: kernel {a} vs plain {b}")

    # one warm run a route (plain, then kernel): the device-bound rbf128
    # runs are among the longest of the script, which must stay well
    # within its time limit
    walls = {run_plain: [], run_kernel: []}
    for fn in (run_plain, run_kernel):
        walls[fn].append(timed(fn)[1])
    switch = run_kernel.pipe.config.switch_step
    x1 = log_k.x[..., 0]
    route = lambda runs: {"runs_s": runs,
                          "ms_per_step": sum(runs) / len(runs)
                          / RBF128_STEPS * 1e3,
                          "solves_per_s": BATCH * RBF128_STEPS * len(runs)
                          / sum(runs)}
    line = {"slice": "rbf128 bench loop, koopmanx_torch", "batch": BATCH,
            "steps": RBF128_STEPS, "switch_step": switch, "horizon": HORIZON,
            "nlift": run_kernel.pipe.dictionary.nlift, "dtype": "float32",
            "kernel_route": {**route(walls[run_kernel]), "cold_wall_s": cold_k,
                             "peak_gib": mem_k / 2**30},
            "plain_route": {**route(walls[run_plain]), "cold_wall_s": cold_p,
                            "peak_gib": mem_p / 2**30},
            "x1_tail_mean_pre_switch": float(
                x1[:, max(switch - 50, 0):switch].mean()),
            "x1_tail_mean_post_switch": float(x1[:, -50:].mean()),
            "card": card}
    print(json.dumps(line), flush=True)
    return counts, {"mse_x1": mse_k, "sse_x1": sse_k,
                    "peak_gib": mem_k / 2**30}


def phase_rff_and_bf16(device, rbf128_report):
    """Phase 10: the duffing_rff preset and the rbf128 bench with a bf16
    ring, kernel route. Returns both runs' launch counts."""
    from koopmanx_torch.configs import duffing_rff_preset

    cfg = duffing_rff_preset()
    cfg.steps = RBF128_STEPS
    cfg.mpc.qp_backend = "pallas"
    runs = {"duffing_rff": config_loop(cfg, device),
            "rbf128 bf16 ring": rbf128_loop("pallas", device,
                                            store="bfloat16")}
    counts, report = {}, {"rbf128 f32 ring (phase 9)": rbf128_report}
    for name, run in runs.items():
        zero_counts()
        (carry, log), wall, mem = run_with_memory(run)
        counts[name] = read_counts()
        mse, sse = quality(log)
        report[name] = {
            "nlift": run.pipe.dictionary.nlift,
            "horizon": run.pipe.config.mpc.horizon,
            "ring_dtype": str(carry.rls.zx.dtype).replace("torch.", ""),
            "launches": counts[name], "wall_s_cold": wall,
            "peak_gib": mem / 2**30, "u_abs_max": float(log.u.abs().max()),
            "mse_x1": mse, "sse_x1": sse}
        if counts[name]["box_admm"] != RBF128_STEPS:
            fail(f"{name} launched {counts[name]} in {RBF128_STEPS} steps")
        check_woodbury_loop(carry, log, name)
    print("phase 10 " + json.dumps({"batch": BATCH, "steps": RBF128_STEPS,
                                    **report}), flush=True)
    return counts["duffing_rff"], counts["rbf128 bf16 ring"]


def mimo_loop(backend: str, device, steps: int = MIMO_STEPS,
              dtype: str = "float32"):
    """The tank_mimo bench loop as a thunk (x0 ~ U[0, 2]^2)."""
    from koopmanx_torch.configs import tank_mimo_bench_config

    return config_loop(tank_mimo_bench_config(steps=steps, qp_backend=backend),
                       device, dtype, x0_range=(0.0, 2.0))


def check_mimo_loop(carry, log, name: str, steps: int = MIMO_STEPS):
    """Finite logs and final carry (ring and model included), |u| <= 4
    per channel (the first move is clamped exactly), x >= 0, the shapes."""
    import torch

    leaves = [log.x, log.u, carry.x, carry.u_applied, carry.warm_x,
              *carry.model, *(t for t in carry.rls if t is not None)]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail(f"tank_mimo {name} loop: non-finite logs or final carry")
    u_max = log.u.abs().amax((0, 1)).tolist()
    x_min = float(log.x.min())
    if max(u_max) > MIMO_U_MAX:
        fail(f"tank_mimo {name} loop: |u| per channel {u_max} > {MIMO_U_MAX}")
    if x_min < 0.0 or float(carry.x.min()) < 0.0:
        fail(f"tank_mimo {name} loop: x = {x_min} < 0")
    if (tuple(log.x.shape) != (BATCH, steps, 2)
            or tuple(log.u.shape) != (BATCH, steps, 2)):
        fail(f"tank_mimo {name} loop: shapes {tuple(log.x.shape)}, "
             f"{tuple(log.u.shape)}")
    return {"u_abs_max_per_channel": u_max, "x_min": x_min}


def pump_means(log, tail: int = 50):
    """Mean |u1| and |u2| over the last ``tail`` steps, batch-wide."""
    return log.u[:, -tail:].abs().mean((0, 1)).tolist()


def phase_tank_mimo(device, card: str):
    """Phase 11: the tank_mimo bench through both routes, with its gates.
    Returns the kernel route's launch counts."""
    run_kernel = mimo_loop("pallas", device)
    zero_counts()
    (carry_k, log_k), cold_k, mem_k = run_with_memory(run_kernel)
    counts = read_counts()
    print(f"phase 11 tank_mimo path (pallas): {cold_k:.2f} s cold, launches "
          f"{counts}, peak {mem_k / 2**30:.2f} GiB", flush=True)
    if counts != {"box_admm": MIMO_STEPS, "fused_qp": 0, "fused_qp_soa": 0}:
        fail(f"the tank_mimo path launched {counts} in {MIMO_STEPS} steps")
    bounds_k = check_mimo_loop(carry_k, log_k, "pallas")

    run_plain = mimo_loop("xla", device)
    zero_counts()
    (carry_p, log_p), cold_p, mem_p = run_with_memory(run_plain)
    counts_p = read_counts()
    if any(counts_p.values()):
        fail(f"the tank_mimo plain route launched {counts_p}")
    bounds_p = check_mimo_loop(carry_p, log_p, "xla")
    early = {}
    for backend in ("pallas", "xla"):
        carry, log = mimo_loop(backend, device, LOOP_EARLY_STEPS, "float64")()
        check_mimo_loop(carry, log, f"{backend} float64", LOOP_EARLY_STEPS)
        early[backend] = log.x
    dx64 = float((early["pallas"] - early["xla"]).abs().max())
    (mse_k, sse_k), (mse_p, sse_p) = quality_x2(log_k), quality_x2(log_p)
    pumps = {"kernel": pump_means(log_k), "plain": pump_means(log_p)}
    gate = {"batch": BATCH, "nx": MIMO_NX,
            "dx_first16_f64": dx64, "dx_first16_f64_tol": LOOP_EARLY_TOL,
            "dx_first16_f32": float((log_k.x[:, :LOOP_EARLY_STEPS]
                                     - log_p.x[:, :LOOP_EARLY_STEPS])
                                    .abs().max()),
            "mse_x2_kernel": mse_k, "mse_x2_plain": mse_p,
            "sse_x2_kernel": sse_k, "sse_x2_plain": sse_p,
            "quality_rtol": QUALITY_RTOL, "bounds_kernel": bounds_k,
            "bounds_plain": bounds_p,
            "mean_abs_u1_u2_last50": pumps,
            "peak_gib": {"float32 kernel": mem_k / 2**30,
                         "float32 plain": mem_p / 2**30}}
    print("phase 11 gate " + json.dumps(gate), flush=True)
    if not dx64 <= LOOP_EARLY_TOL:
        fail(f"float64 tank_mimo kernel and plain loops differ by {dx64} in "
             f"the first {LOOP_EARLY_STEPS} steps")
    for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                       (sse_k, sse_p, "steady-state error")):
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"tank_mimo x2 {what}: kernel {a} vs plain {b}")
    for route, (u1, u2) in pumps.items():
        if not u2 > u1:
            fail(f"tank_mimo {route} route: pump 2 does not carry the load "
                 f"over the last 50 steps (mean |u1| {u1}, |u2| {u2})")

    walls = {run_plain: [], run_kernel: []}
    for fn in (run_plain, run_kernel, run_kernel, run_plain):
        walls[fn].append(timed(fn)[1])
    switch = run_kernel.pipe.config.switch_step
    x2 = log_k.x[..., 1]
    route = lambda runs: {"runs_s": runs,
                          "ms_per_step": sum(runs) / 2 / MIMO_STEPS * 1e3,
                          "solves_per_s": BATCH * MIMO_STEPS * 2 / sum(runs)}
    line = {"slice": "tank_mimo bench loop, koopmanx_torch", "batch": BATCH,
            "steps": MIMO_STEPS, "switch_step": switch, "horizon": HORIZON,
            "nx": MIMO_NX, "dtype": "float32",
            "kernel_route": {**route(walls[run_kernel]), "cold_wall_s": cold_k,
                             "peak_gib": mem_k / 2**30},
            "plain_route": {**route(walls[run_plain]), "cold_wall_s": cold_p,
                            "peak_gib": mem_p / 2**30},
            "x2_tail_mean_pre_switch": float(x2[:, switch - 50:switch].mean()),
            "x2_tail_mean_post_switch": float(x2[:, -50:].mean()),
            "card": card}
    print(json.dumps(line), flush=True)
    return counts


def phase_general(device, card: str):
    """Phase 12: the general-inequality path (the plain ADMM on either
    route, so no kernel launch) at 8192 scenarios, f32, GENERAL_STEPS
    steps: the tank bench with its applied window as rows, the flagship
    with the state box |x| <= 1.05 over the horizon. Each run's warm
    ms/step and quality beside the box formulation of the same config
    (kernel route); the gap is not gated: fixed-iteration ADMM on two
    splittings gives other iterates."""
    from koopmanx_torch.configs import flagship_config, tank_bench_config

    def tank(backend, general):
        cfg = tank_bench_config(steps=GENERAL_STEPS, qp_backend=backend)
        if general:
            cfg.mpc.applied_bounds = "rows"
        return config_loop(cfg, device, x0_range=(0.0, 2.0))

    def flagship(backend, general):
        cfg = flagship_config(steps=GENERAL_STEPS, horizon=HORIZON,
                              qp_backend=backend)
        if general:
            cfg.mpc.state_bounds = STATE_BOX
        return config_loop(cfg, device)

    def flagship_check(carry, log, name, steps):
        check_loop(carry, log, name, steps)
        return {"u_abs_max": float(log.u.abs().max())}

    report = {}
    for name, make, check, qual in (
            ("tank, applied window as rows", tank, check_tank_loop,
             quality_x2),
            ("flagship, state box", flagship, flagship_check, quality)):
        runs = {}
        for label, backend, general in (("general, pallas", "pallas", True),
                                        ("general, xla", "xla", True),
                                        ("box formulation, pallas",
                                         "pallas", False)):
            run = make(backend, general)
            zero_counts()
            (carry, log), cold = timed(run)
            counts = read_counts()
            if general and any(counts.values()):
                fail(f"phase 12 {name} ({label}) launched {counts}")
            bounds = check(carry, log, f"phase 12 {name} ({label})",
                           GENERAL_STEPS)
            _, warm = timed(run)
            mse, sse = qual(log, tail=20)
            runs[label] = {"launches": counts,
                           "ms_per_step": warm / GENERAL_STEPS * 1e3,
                           "ms_per_step_cold": cold / GENERAL_STEPS * 1e3,
                           "mse": mse, "sse_last20": sse, **bounds}
        report[name] = runs
    print("phase 12 general-inequality path " + json.dumps(
        {"batch": BATCH, "steps": GENERAL_STEPS, "state_box": STATE_BOX,
         **report, "card": card}), flush=True)


def early_f64_gate(make_cfg, device, name: str, full_floor: bool = False,
                   tol: float = EARLY_TOL):
    """Kernel vs plain route of ``make_cfg(backend, steps)`` over
    LOOP_EARLY_STEPS float64 steps at EARLY_BATCH scenarios: each scenario
    and step within ``tol``, or within ten times the plain route's own
    divergence from one ulp of x0 (up, then down) in that scenario up to
    that step where that is larger. ``full_floor`` (phase 15) widens the
    floor to every round-off realization of the plain route it tries: one
    ulp of x0, one ulp of the initial model's A (up, then down) and the
    plain ADMM with its sums reassociated (``box_admm_reassociated``, the
    kernel's own kind of difference); the report keeps the one-ulp-of-x0
    gate's violations beside it. Returns the gate's report."""
    import torch
    from koopmanx_torch.control import qp
    from koopmanx_torch.run import run_scenarios

    logs, floors = {}, {}
    real = qp.box_admm
    routes = [("pallas", "pallas", real), ("xla", "xla", real)]
    if full_floor:
        routes.insert(1, ("reassociated", "pallas", box_admm_reassociated))
    try:
        for label, backend, solver in routes:
            qp.box_admm = solver
            run = config_loop(make_cfg(backend, LOOP_EARLY_STEPS), device,
                              "float64", batch=EARLY_BATCH)
            logs[label] = run()[1].x
    finally:
        qp.box_admm = real
    diff = lambda x: (x - logs["xla"]).abs().amax(-1)  # (B, T)
    for target in (9.0, -9.0):
        x0 = torch.nextafter(run.x0, torch.full_like(run.x0, target))
        floors[f"x0 {target:+}"] = diff(run(x0)[1].x)
        if full_floor:
            a0 = run.pipe.model0.A
            a0 = torch.nextafter(a0, torch.full_like(a0, target))
            pipe = run.pipe._replace(model0=run.pipe.model0._replace(A=a0))
            floors[f"A0 {target:+}"] = diff(run_scenarios(pipe,
                                                          run.batch)[1].x)
    if full_floor:
        floors["reassociated"] = diff(logs["reassociated"])
    dx = diff(logs["pallas"])
    stack = lambda keys: torch.stack([floors[k] for k in keys]).amax(0)
    floor = stack(floors).cummax(dim=1).values
    bound = torch.clamp(10.0 * floor, min=tol)
    tight = bound == tol
    report = {"batch": EARLY_BATCH, "steps": LOOP_EARLY_STEPS,
              "dx_f64": float(dx.max()), "floor_f64": float(floor.max()),
              "tol": tol, "share_held_at_tol": float(
                  tight.double().mean()),
              "dx_f64_where_held_at_tol": float(dx[tight].max())
              if bool(tight.any()) else None}
    if full_floor:
        x0_floor = stack(["x0 +9.0", "x0 -9.0"]).cummax(dim=1).values
        x0_bound = torch.clamp(10.0 * x0_floor, min=tol)
        report.update({
            "floor_f64_by_realization": {k: float(v.max())
                                         for k, v in floors.items()},
            "entries": dx.numel(),
            "entries_past_x0_only_bound": int((dx > x0_bound).sum()),
            "worst_ratio_to_x0_only_bound": float((dx / x0_bound).max()),
            # the plain route against itself, its ADMM sums reassociated
            "reassociated_worst_ratio_to_x0_only_bound": float(
                (floors["reassociated"] / x0_bound).max()),
            "worst_ratio_to_bound": float((dx / bound).max())})
    if not bool((dx <= bound).all()):
        fail(f"{name}: float64 kernel and plain loops differ by more than "
             f"max({tol}, 10 x the round-off floor): {report}")
    return report


def check_estimator_loop(carry, log, name: str, steps: int, u_max: float):
    """u finite within the box, the final model and estimator finite in
    every scenario (the guard holds an escaped scenario's), the shapes;
    returns the scenarios whose x went non-finite and the largest
    |x1| each reached before."""
    import torch

    if not bool(torch.isfinite(log.u).all()):
        fail(f"{name}: non-finite u")
    top = float(log.u.abs().max())
    if top > u_max:
        fail(f"{name}: |u| = {top} > {u_max}")
    leaves = [carry.u_applied, carry.warm_x, *carry.model, *carry.rls]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail(f"{name}: non-finite model or estimator state")
    if tuple(log.x.shape[:2]) != (BATCH, steps):
        fail(f"{name}: log.x shape {tuple(log.x.shape)}")
    escaped = ~torch.isfinite(log.x).all(-1).all(-1)
    x1 = torch.nan_to_num(log.x[escaped, :, 0].abs(), nan=0.0, posinf=0.0)
    return escaped, x1.amax(-1).tolist() if x1.numel() else []


def escape_report(escaped, x1_max, name: str):
    share = float(escaped.float().mean())
    if share > ESCAPE_SHARE:
        fail(f"{name}: {int(escaped.sum())} of {BATCH} scenarios escaped "
             f"(share {share} > {ESCAPE_SHARE})")
    return {"escaped": int(escaped.sum()), "share": share,
            "x1_abs_max_before_escape_min": min(x1_max, default=None)}


def quality_on(log, keep, tail: int = 50):
    """Batch-mean tracking MSE and steady-state error of x1 against r = 1
    (the state reference's first channel) over the scenarios ``keep``."""
    err = log.x[keep, :, 0] - 1.0
    return float((err ** 2).mean()), float(err[:, -tail:].abs().mean())


def phase_vdp(device, card: str):
    """Phase 13: the VDP lifted-tracking bench through both routes, with
    its gates. Returns the kernel route's launch counts."""
    from koopmanx_torch.configs import vdp_bench_config
    from koopmanx_torch.run import resolve_weights_path

    runs, logs, escapes = {}, {}, {}
    for backend in ("pallas", "xla"):
        run = runs[backend] = config_loop(
            vdp_bench_config(VDP_STEPS, backend), device)
        zero_counts()
        (carry, log), cold, mem = run_with_memory(run)
        counts = read_counts()
        want = VDP_STEPS if backend == "pallas" else 0
        print(f"phase 13 vdp path ({backend}): {cold:.2f} s cold, launches "
              f"{counts}, peak {mem / 2**30:.2f} GiB", flush=True)
        if counts != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"the vdp {backend} route launched {counts} in {VDP_STEPS} "
                 "steps")
        if backend == "pallas":
            counts_k, pipe = counts, run.pipe
        escaped, x1_max = check_estimator_loop(carry, log, f"vdp {backend}",
                                               VDP_STEPS, VDP_U_MAX)
        escapes[backend] = {**escape_report(escaped, x1_max, f"vdp {backend}"),
                            "cold_wall_s": cold, "peak_gib": mem / 2**30}
        logs[backend] = (log, escaped)
    nlift = pipe.dictionary.nlift
    if pipe.params.q_block.shape[-1] != nlift or logs["pallas"][0].r.shape[
            -1] != nlift:
        fail("the vdp loop does not track the lifted reference")
    early = early_f64_gate(
        lambda backend, steps: vdp_bench_config(steps, backend), device,
        "vdp")
    keep = ~(logs["pallas"][1] | logs["xla"][1])
    (mse_k, sse_k), (mse_p, sse_p) = (quality_on(logs[b][0], keep)
                                      for b in ("pallas", "xla"))
    gate = {"batch": BATCH, "nlift": nlift,
            "weights": os.path.relpath(resolve_weights_path(
                pipe.config.lift.weights_path, "vanderpol"), ROOT),
            "early_f64": early, "escaped": escapes,
            "mse_x1_kernel": mse_k, "mse_x1_plain": mse_p,
            "sse_x1_kernel": sse_k, "sse_x1_plain": sse_p,
            "scenarios_in_quality": int(keep.sum()),
            "quality_rtol": QUALITY_RTOL}
    print("phase 13 gate " + json.dumps(gate), flush=True)
    for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                       (sse_k, sse_p, "steady-state error")):
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"vdp x1 {what}: kernel {a} vs plain {b}")

    walls = {runs["xla"]: [], runs["pallas"]: []}
    for fn in (runs["xla"], runs["pallas"], runs["pallas"], runs["xla"]):
        walls[fn].append(timed(fn)[1])
    switch = pipe.config.switch_step
    x1 = logs["pallas"][0].x[keep, :, 0]
    route = lambda r: {"runs_s": walls[r],
                       "ms_per_step": sum(walls[r]) / 2 / VDP_STEPS * 1e3,
                       "solves_per_s": BATCH * VDP_STEPS * 2 / sum(walls[r])}
    line = {"slice": "vdp lifted-tracking bench loop, koopmanx_torch",
            "batch": BATCH, "steps": VDP_STEPS, "switch_step": switch,
            "horizon": HORIZON, "nlift": nlift, "dtype": "float32",
            "kernel_route": route(runs["pallas"]),
            "plain_route": route(runs["xla"]),
            "x1_tail_mean_pre_switch": float(x1[:, switch - 50:switch].mean()),
            "x1_tail_mean_post_switch": float(x1[:, -50:].mean()),
            "card": card}
    print(json.dumps(line), flush=True)
    return counts_k


def phase_estimators(device, card: str):
    """Phase 14: the storage method, the Gram-carry RLS with its reset,
    the SM RLS in float64 and the sine reference, each at 8192 scenarios
    for ESTIMATOR_STEPS steps through the kernel route, with the float64
    kernel vs plain gate. Returns the launch counts by run."""
    from koopmanx_torch.configs import (
        flagship_config,
        vdp_bench_config,
        vdp_rbf_bench_config,
    )

    def flagship(mode, **update):
        def make(backend, steps):
            cfg = flagship_config(steps=steps, horizon=HORIZON,
                                  qp_backend=backend)
            cfg.update.mode = mode
            for k, v in update.items():
                setattr(cfg.update, k, v)
            return cfg
        return make

    def vdp_sine(backend, steps):
        cfg = vdp_bench_config(steps, backend)
        cfg.reference = "sine"
        return cfg

    cases = {
        "vdp_rbf storage": (lambda b, s: vdp_rbf_bench_config(s, b),
                            "float32"),
        "flagship rls_chol, reset_mult 4": (
            flagship("rls_chol", ridge=1e-2, reset_mult=4.0), "float32"),
        "flagship rls, float64": (flagship("rls"), "float64"),
        "vdp sine reference": (vdp_sine, "float32"),
    }
    counts, report = {}, {}
    for name, (make, dtype) in cases.items():
        t0 = time.perf_counter()
        run = config_loop(make("pallas", ESTIMATOR_STEPS), device, dtype)
        cfg = run.pipe.config
        zero_counts()
        (carry, log), wall, mem = run_with_memory(run)
        counts[name] = read_counts()
        if counts[name] != {"box_admm": ESTIMATOR_STEPS, "fused_qp": 0,
                            "fused_qp_soa": 0}:
            fail(f"{name} launched {counts[name]} in {ESTIMATOR_STEPS} steps")
        escaped, x1_max = check_estimator_loop(
            carry, log, name, ESTIMATOR_STEPS, cfg.mpc.u_max)
        resets = None
        if cfg.update.reset_mult > 0:
            resets = int(replay_resets(log.residual, cfg.update.reset_mult))
            if resets == 0:
                fail(f"{name}: no reset triggered in {ESTIMATOR_STEPS} steps")
        mse, sse = (quality_on(log, ~escaped, tail=20)
                    if cfg.reference == "constant" else (None, None))
        report[name] = {
            "estimator": type(carry.rls).__name__, "dtype": dtype,
            "nlift": run.pipe.dictionary.nlift, "reference": cfg.reference,
            "launches": counts[name], "wall_s_cold": wall,
            "ms_per_step_cold": wall / ESTIMATOR_STEPS * 1e3,
            "peak_gib": mem / 2**30, "u_abs_max": float(log.u.abs().max()),
            "resets": resets, "mse_x1_vs_1": mse, "sse_x1_vs_1_last20": sse,
            **escape_report(escaped, x1_max, name),
            "early_f64": early_f64_gate(make, device, name),
            "phase_s": time.perf_counter() - t0}
    print("phase 14 estimators " + json.dumps(
        {"batch": BATCH, "steps": ESTIMATOR_STEPS, **report, "card": card}),
        flush=True)
    return counts


def state_reference(cfg) -> float:
    """The first state channel's reference of a constant-reference run."""
    return (cfg.reference_state[0] if cfg.reference_state is not None
            else cfg.reference_value)


def phase_revise2(device, card: str):
    """Phase 15: the Revise_2 benches through both routes, with their
    gates. Returns the kernel route's launch counts by run."""
    import torch
    from koopmanx_torch.configs import (
        revise2_duffing_bench_config,
        revise2_vdp_bench_config,
        toy1d_bench_config,
    )

    makes = {"revise2_duffing": revise2_duffing_bench_config,
             "revise2_vdp": revise2_vdp_bench_config,
             "toy1d": toy1d_bench_config}
    counts, lines = {}, {}
    for name, make in makes.items():
        t0 = time.perf_counter()
        steps = REVISE2_STEPS[name]
        runs, logs, report = {}, {}, {}
        for backend in ("pallas", "xla"):
            run = runs[backend] = config_loop(make(steps, backend), device)
            cfg = run.pipe.config
            zero_counts()
            (carry, log), cold, mem = run_with_memory(run)
            got = read_counts()
            want = steps if backend == "pallas" else 0
            print(f"phase 15 {name} ({backend}): {cold:.2f} s cold, "
                  f"launches {got}, peak {mem / 2**30:.3f} GiB", flush=True)
            if got != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
                fail(f"{name} {backend} launched {got} in {steps} steps")
            if backend == "pallas":
                counts[name] = got
            escaped, x1_max = check_estimator_loop(
                carry, log, f"{name} {backend}", steps, cfg.mpc.u_max)
            synth = cfg.mpc.terminal_synthesis
            if synth and not all(bool(torch.isfinite(t).all())
                                 for t in carry.cert):
                fail(f"{name} {backend}: non-finite held certificate")
            if synth != (len(carry.cert) == 3):
                fail(f"{name} {backend}: certificate {len(carry.cert)} "
                     "leaves")
            report[backend] = {
                **escape_report(escaped, x1_max, f"{name} {backend}"),
                "cold_wall_s": cold, "peak_gib": mem / 2**30,
                "cert_fresh_share": float(log.cert_fresh.float().mean()),
                "u_abs_max": float(log.u.abs().max())}
            logs[backend] = (log, escaped)
        early = early_f64_gate(lambda b, st: make(st, b), device, name,
                               full_floor=True)
        keep = ~(logs["pallas"][1] | logs["xla"][1])
        ref1 = state_reference(cfg)
        (mse_k, sse_k), (mse_p, sse_p) = (
            quality_vs(logs[b][0], keep, ref1) for b in ("pallas", "xla"))
        for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                           (sse_k, sse_p, "steady-state error")):
            if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
                fail(f"{name} x1 {what}: kernel {a} vs plain {b}")
        # one warm run a route (plain, then kernel): the synthesis's
        # eager steps make these the longest runs of the script
        walls = {runs["xla"]: [], runs["pallas"]: []}
        for fn in (runs["xla"], runs["pallas"]):
            walls[fn].append(timed(fn)[1])
        route = lambda r: {"runs_s": walls[r],
                           "ms_per_step": sum(walls[r]) / len(walls[r])
                           / steps * 1e3}
        lines[name] = {
            "steps": steps, "switch_step": cfg.switch_step,
            "nlift": run.pipe.dictionary.nlift,
            "terminal_synthesis": cfg.mpc.terminal_synthesis,
            "track_lifted": cfg.mpc.track_lifted,
            "estimator": type(carry.rls).__name__, "x1_reference": ref1,
            "kernel_route": {**route(runs["pallas"]), **report["pallas"]},
            "plain_route": {**route(runs["xla"]), **report["xla"]},
            "early_f64": early, "scenarios_in_quality": int(keep.sum()),
            "mse_x1_kernel": mse_k, "mse_x1_plain": mse_p,
            "sse_x1_kernel": sse_k, "sse_x1_plain": sse_p,
            "phase_s": time.perf_counter() - t0}
        print(f"phase 15 {name} " + json.dumps(lines[name]), flush=True)
    print(json.dumps({"slice": "Revise_2 bench loops, koopmanx_torch",
                      "batch": BATCH, "horizon": HORIZON, "dtype": "float32",
                      "quality_rtol": QUALITY_RTOL, **{
                          name: {k: line[k] for k in (
                              "steps", "kernel_route", "plain_route")}
                          for name, line in lines.items()},
                      "card": card}), flush=True)
    return counts


def quality_vs(log, keep, ref1: float, tail: int = 50):
    """Batch-mean tracking MSE and steady-state error of x1 against the
    state reference ``ref1`` over the scenarios ``keep``."""
    err = log.x[keep, :, 0] - ref1
    return float((err ** 2).mean()), float(err[:, -tail:].abs().mean())


def replay_resets(residual, mult: float, beta: float = 0.98):
    """Reset triggers of ``engine.core.change_reset``, replayed from the
    logged pre-update residuals (B, T)."""
    import torch

    ema = torch.zeros_like(residual[:, 0])
    total = 0
    for t in range(residual.shape[1]):
        r = residual[:, t]
        warmed = ema > 0
        trig = warmed & (r > mult * ema)
        total += int(trig.sum())
        ema = torch.where(trig, ema, beta * ema + (1 - beta) * r)
        ema = torch.where(warmed, ema, r)
    return total


def external_plant(pipe, batch):
    """The pipeline's plant stepped outside the controller, with the
    scenarios' parameters and the loop's switch schedule:
    ``plant(x, u, k)``."""
    from koopmanx_torch.systems.base import make_step, make_switch_schedule
    from koopmanx_torch.systems.library import get_system

    cfg = pipe.engine_cfg
    step = make_step(get_system(pipe.config.system), cfg.h, cfg.integrator)
    sched = make_switch_schedule(batch.theta0, batch.theta1, cfg.switch_step)
    return lambda x, u, k: step(x, u, sched(k))


def one_scenario(batch, i: int):
    """Scenario ``i`` of a ScenarioBatch, as a batch of one."""
    take = lambda th: type(th)(*(v[i:i + 1] for v in th))
    return batch._replace(x0=batch.x0[i:i + 1], theta0=take(batch.theta0),
                          theta1=take(batch.theta1))


def serve(ctrl, plant, x0, calls: int):
    """``calls`` calls of ``ctrl`` against ``plant`` from ``x0``; returns
    the measurements and inputs stacked (B, T, ...) and the last state."""
    import torch

    x, xs, us = x0, [], []
    for k in range(calls):
        xs.append(x)
        u = ctrl.step(x)
        us.append(u)
        x = plant(x, u, k)
    return torch.stack(xs, 1), torch.stack(us, 1), x


def is_sync_warning(w) -> bool:
    """A warning of ``set_sync_debug_mode('warn')`` for a synchronizing
    operation; not its one-time notice that the mode is a prototype (the
    first ``'warn'`` of a process), which names synchronization too."""
    msg = str(w.message)
    return "synchroniz" in msg and "prototype" not in msg


def syncs_per_call(fn, calls: int = 3):
    """Host synchronizations a call of ``fn``, counted by
    ``torch.cuda.set_sync_debug_mode('warn')``, and the source lines that
    raised them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
             for w in caught if is_sync_warning(w)]
    return len(lines) / calls, sorted(set(lines))


def device_ops_per_call(fn, calls: int = 3) -> float:
    """Device operations (kernels, copies, fills) a call of ``fn``, from
    the profiler's device-side events."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("aten::")) / calls


def serve_latency(ctrl, plant, x0, calls: int, single: bool = False):
    """Wall ms of a call of ``ctrl.step`` with the caller's copy of u to
    the host, the device idle at each call's start, over ``calls`` calls
    against ``plant`` (after LATENCY_WARMUP); then host synchronizations
    and device operations a call of ``step`` alone. ``single``: ``ctrl``
    is a Controller (unbatched x and u)."""
    import torch

    lift = (lambda t: t[None]) if single else (lambda t: t)
    x, k, walls = x0[0] if single else x0, 0, []
    for _ in range(LATENCY_WARMUP + calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = ctrl.step(x)
        u.cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
        x = plant(lift(x), lift(u), k)
        x, k = (x[0] if single else x), k + 1
    walls = torch.tensor(walls[LATENCY_WARMUP:], dtype=torch.float64)
    step = lambda: ctrl.step(x)
    syncs, sources = syncs_per_call(step)
    return {"calls": calls, "p50_ms": float(walls.quantile(0.5)),
            "p99_ms": float(walls.quantile(0.99)),
            "mean_ms": float(walls.mean()),
            "host_syncs_per_call_in_step": syncs, "host_sync_sources": sources,
            "device_ops_per_call": device_ops_per_call(step)}


def check_served(xs, us, name: str, calls: int):
    import torch

    if tuple(xs.shape) != (BATCH, calls, 2):
        fail(f"{name}: served x shape {tuple(xs.shape)}")
    for label, t in (("x", xs), ("u", us)):
        if not bool(torch.isfinite(t).all()):
            fail(f"{name}: non-finite {label}")
    u_max = float(us.abs().max())
    if u_max > 2.0:
        fail(f"{name}: |u| = {u_max} > 2")


def served_quality(xs, tail: int = 50):
    """Batch-mean tracking MSE and steady-state error of x1 against the
    flagship's constant r = 1."""
    err = xs[..., 0] - 1.0
    return float((err ** 2).mean()), float(err[:, -tail:].abs().mean())


def cli_json(argv):
    """``koopmanx_torch.cli.main(argv)`` in this process, its standard
    output captured: (the printed JSON, the launch counts of the run)."""
    import contextlib
    import io

    from koopmanx_torch import cli

    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue()), read_counts()


def phase_serving(device, card: str, loops, fused_quality, fused_ms):
    """Phase 16: ``BatchedController`` and ``Controller`` on the card and
    the CLI in process. ``loops`` are phase 3-4's flagship thunks by route
    (their pipelines and scenarios), ``fused_quality`` phase 3's (MSE,
    steady-state error), ``fused_ms`` phase 5's ms/step by route. Returns
    the launch counts by path and the serving report."""
    import numpy as np
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.controller import BatchedController, Controller
    from koopmanx_torch.tree import tree_map

    report, counts = {"batch": BATCH, "calls": SERVE_CALLS}, {}
    # 1. the fleet at full width on both routes, against the plant outside
    served = {}
    for backend, run in loops.items():
        pipe, sc = run.pipe, run.batch
        bc = BatchedController.from_pipeline(pipe, BATCH)
        zero_counts()
        (xs, us, _), wall = timed(lambda: serve(
            bc, external_plant(pipe, sc), sc.x0, SERVE_CALLS))
        got = read_counts()
        want = SERVE_CALLS if backend == "pallas" else 0
        if got != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"phase 16 fleet ({backend}) launched {got}, not {want} "
                 "box_admm launches")
        check_served(xs, us, f"phase 16 fleet ({backend})", SERVE_CALLS)
        served[backend] = served_quality(xs)
        counts[f"serving fleet, {backend} (phase 16)"] = got["box_admm"]
        report[f"fleet_{backend}"] = {
            "launches": got, "wall_s_first_run": wall,
            "mse": served[backend][0], "sse": served[backend][1]}
    for what, i in (("tracking MSE", 0), ("steady-state error", 1)):
        k, p, f = (served["pallas"][i], served["xla"][i], fused_quality[i])
        if not abs(k - f) <= 1e-2 * max(abs(f), 1e-9):
            fail(f"phase 16: served {what} {k} vs the fused loop's {f}")
        if not abs(k - p) <= QUALITY_RTOL[what] * max(abs(p), 1e-9):
            fail(f"phase 16: served {what}, kernel {k} vs plain {p}")
    report["fused_loop_quality"] = list(fused_quality)

    # 2. serving against the fused loop in float64, same scenarios, route
    gaps = {}
    for backend in loops:
        run = run_loop(backend, device, LOOP_EARLY_STEPS, "float64")
        _, log = run()
        bc = BatchedController.from_pipeline(run.pipe, BATCH)
        xs, us, _ = serve(bc, external_plant(run.pipe, run.batch),
                          run.batch.x0, LOOP_EARLY_STEPS)
        gaps[backend] = {"dx": float((xs - log.x).abs().max()),
                         "du": float((us - log.u).abs().max())}
    report["serving_vs_fused_loop_f64"] = {
        "steps": LOOP_EARLY_STEPS, "tol": SERVE_TOL, **gaps}
    if any(g > SERVE_TOL for gap in gaps.values() for g in gap.values()):
        fail(f"phase 16: served float64 loop differs from run_batch: {gaps}")

    # 3. the masked reset, per-plant clocks, float64
    cfg = flagship_config(steps=RESET_AT + RESET_CHECK, horizon=HORIZON)
    cfg.reference, cfg.update.dither = "sine", 0.02
    run = config_loop(cfg, device, "float64", batch=BATCH)
    pipe, sc = run.pipe, run.batch
    plant = external_plant(pipe, sc)
    bc = BatchedController.from_pipeline(pipe, BATCH)
    _, _, x = serve(bc, plant, sc.x0, RESET_AT)
    singles = {}
    for i in SAMPLED:
        single = Controller.from_pipeline(pipe)
        single.state = tree_map(lambda a: a[i:i + 1].clone(), bc.state)
        single._k = bc.clocks[i:i + 1]
        singles[i] = single
    idx = torch.arange(BATCH)
    soft, full = idx % 2 == 0, idx % 4 == 1
    bc.reset(mask=soft)
    bc.reset(full=True, mask=full)
    for i, single in singles.items():
        if bool(soft[i]):
            single.reset()
        elif bool(full[i]):
            single.reset(full=True)
    clocks = bc.clocks
    if len(set(clocks.tolist())) != 2:
        fail(f"phase 16: clocks after the reset {sorted(set(clocks))}")
    # each sampled plant's twin: a fleet of BATCH copies of its state with
    # every clock at its own, which takes the int path at the same width
    twins = {}
    for i in SAMPLED:
        twin = BatchedController.from_pipeline(pipe, BATCH)
        twin.state = tree_map(lambda a: a[i:i + 1].expand_as(a).clone(),
                              bc.state)
        twin._k = np.full(BATCH, clocks[i])
        twins[i] = twin
    worst = dict.fromkeys(("single", "twin"), 0.0)
    for k in range(RESET_AT, RESET_AT + RESET_CHECK):
        u = bc.step(x)
        for i in SAMPLED:
            for name, got in (
                    ("single", singles[i].step(x[i])),
                    ("twin", twins[i].step(x[i:i + 1].expand(BATCH, -1))[0])):
                worst[name] = max(worst[name],
                                  float((got - u[i]).abs().max()))
        x = plant(x, u, k)
    report["masked_reset_f64"] = {
        "reset_at": RESET_AT, "calls": RESET_CHECK, "sampled": list(SAMPLED),
        "soft": int(soft.sum()), "full": int(full.sum()),
        "max_abs_du_vs_single": worst["single"],
        "max_abs_du_vs_int_path_twin": worst["twin"],
        "tol_single": SINGLE_TOL, "tol_twin": SERVE_TOL,
        # the fleet's clocks still differ: the per-plant path
        "host_syncs_per_call_in_step_per_plant_path": syncs_per_call(
            lambda: bc.step(x), calls=6)}
    if not (worst["single"] <= SINGLE_TOL and worst["twin"] <= SERVE_TOL):
        fail(f"phase 16: reset plants differ from single Controllers and "
             f"their int-path twins by {worst} (tol {SINGLE_TOL}, "
             f"{SERVE_TOL})")

    # 4. latency of a call, both routes, fleet and one plant
    for backend, run in loops.items():
        pipe, sc = run.pipe, run.batch
        bc = BatchedController.from_pipeline(pipe, BATCH)
        report[f"latency_fleet_{backend}"] = serve_latency(
            bc, external_plant(pipe, sc), sc.x0, LATENCY_CALLS["fleet"])
        one = one_scenario(sc, 0)
        report[f"latency_single_{backend}"] = serve_latency(
            Controller.from_pipeline(pipe), external_plant(pipe, one),
            one.x0, LATENCY_CALLS["single"], single=True)
    report["fused_loop_ms_per_step"] = fused_ms

    # 5. the CLI in process, on the card
    cli_report = {}
    for preset, steps, sse_max, u_max in CLI_RUNS:
        summary, got = cli_json(["run", "--preset", preset, "--steps",
                                 str(steps)])
        counts[f"CLI run {preset} (phase 16)"] = got["box_admm"]
        cli_report[preset] = {"launches": got, **{
            k: summary[k] for k in ("steady_state_error", "u_abs_max",
                                    "tracking_mse", "final_state")}}
        if got["box_admm"] != steps:
            fail(f"phase 16 CLI run {preset}: {got} launches in {steps} "
                 "steps")
        if not summary["steady_state_error"] < sse_max:
            fail(f"phase 16 CLI run {preset}: steady-state error "
                 f"{summary['steady_state_error']} >= {sse_max}")
        if not summary["u_abs_max"] <= u_max + BOUND_SLACK:
            fail(f"phase 16 CLI run {preset}: |u| {summary['u_abs_max']}")
        if not all(map(math.isfinite, summary["final_state"])):
            fail(f"phase 16 CLI run {preset}: final state "
                 f"{summary['final_state']}")
    summary, got = cli_json(["sweep", "--preset", "duffing", "--batch",
                             str(SWEEP_BATCH), "--steps", str(SWEEP_STEPS)])
    counts["CLI sweep duffing (phase 16)"] = got["box_admm"]
    cli_report["sweep"] = {"launches": got, **summary}
    if got["box_admm"] != SWEEP_STEPS or summary["finite_fraction"] != 1.0:
        fail(f"phase 16 CLI sweep: {got} launches, finite fraction "
             f"{summary['finite_fraction']}")
    report["cli"] = cli_report
    report["card"] = card
    print("phase 16 serving " + json.dumps(report), flush=True)
    return counts, report


def step_report(fn, warm_up: bool = True):
    """Calls of ``fn`` (a one-step loop from a fixed carry), after one
    more unless ``warm_up`` is False: one timed (its wall ms), one with
    its host synchronizations counted, one profiled (the device
    operations, device-busy ms as the union of the kernels' intervals,
    and the device's idle share against the timed call's wall)."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    if warm_up:
        fn()
    wall_ms = timed(fn)[1] * 1e3
    syncs, sources = syncs_per_call(fn, calls=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("aten::"))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return {"wall_ms": wall_ms, "host_syncs": syncs,
            "host_sync_sources": sources, "device_ops": len(spans),
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms}


def one_step_loop(pipe, args, carry, offset: int, **engine):
    """A one-step loop of ``pipe`` (engine fields replaced by ``engine``)
    from ``carry`` at step ``offset``: ``fn() -> (carry, log)``."""
    import dataclasses

    from koopmanx_torch.engine.loop import make_closed_loop
    from koopmanx_torch.run import ref_fn_for
    from koopmanx_torch.systems.library import get_system

    cfg = dataclasses.replace(pipe.engine_cfg, steps=1, **engine)
    loop = make_closed_loop(
        get_system(pipe.config.system), pipe.dictionary, cfg,
        ref_fn_for(pipe.config, pipe.params.q_block.shape[-1], pipe.device,
                   pipe.dictionary))
    return lambda c=carry: loop(*args, carry0=c, step_offset=offset)


def poisoned_loop(run):
    """``run``'s loop with scenario POISONED started from an initial A
    with a NaN entry; ``fn.args`` are the loop's arguments."""
    from koopmanx_torch.engine.loop import run_batch
    from koopmanx_torch.run import replicate

    pipe, sc = run.pipe, run.batch
    b = sc.x0.shape[0]
    model0 = replicate(pipe.model0, b)
    a = model0.A.clone()
    a[POISONED, 0, 0] = float("nan")
    args = (replicate(pipe.params, b), sc.x0, model0._replace(A=a),
            replicate(pipe.rls0, b), sc.theta0, sc.theta1)

    def fn():
        return run_batch(pipe.closed_loop, *args)

    fn.pipe, fn.batch, fn.args = pipe, sc, args
    return fn


def finite_rows(*tensors):
    """Per scenario: every entry of every tensor finite."""
    import torch

    ok = None
    for t in tensors:
        f = torch.isfinite(t).reshape(t.shape[0], -1).all(-1)
        ok = f if ok is None else ok & f
    return ok


def eigvalsh_probe(device):
    """What ``torch.linalg.eigvalsh`` itself does on the card with a NaN
    entry and with an ill-conditioned float32 batch (8192 SPD 31 x 31,
    eigenvalues 1e-8 .. 1e4): the value or the error, never gated (the
    port masks non-finite inputs, ``control/lmi.py::_eigvalsh``)."""
    import torch

    def attempt(m):
        try:
            w = torch.linalg.eigvalsh(m)
            torch.cuda.synchronize()
            return w, None
        except RuntimeError as e:
            return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    nan = torch.eye(4, device=device).repeat(3, 1, 1)
    nan[1, 1, 1] = float("nan")
    w, err = attempt(nan)
    out = {"nan_entry": err or f"returned {w[1].tolist()}"}
    gen = torch.Generator().manual_seed(5)
    q, _ = torch.linalg.qr(torch.randn(BATCH, 31, 31, generator=gen,
                                       dtype=torch.float64))
    lam = torch.logspace(-8, 4, 31, dtype=torch.float64)
    spd = (q * lam) @ q.transpose(-1, -2)
    w, err = attempt(spd.to(device, torch.float32))
    out["ill_conditioned_f32"] = err or {
        "finite": bool(torch.isfinite(w).all()),
        "max_abs_err_vs_f64": float((w.double().cpu() - lam).abs().max())}
    return out


def phase_lmi(device, card: str):
    """Phase 17 (a): revise2_duffing with the LMI terminal on both routes,
    scenario POISONED from a NaN in its initial A; the DARE mode's finite
    scenarios must stay finite; the float64 gate; the step's anatomy.
    Returns the kernel route's launch counts and the report."""
    import torch
    from koopmanx_torch.configs import revise2_duffing_bench_config
    from koopmanx_torch.control.lmi import BRANCH_NAMES
    from koopmanx_torch.engine import core

    def make(backend, steps, mode="lmi"):
        cfg = revise2_duffing_bench_config(steps, backend)
        cfg.mpc.terminal_mode = mode
        return cfg

    # the DARE mode on the same scenarios, the reference of finiteness
    dare = poisoned_loop(config_loop(make("pallas", LMI_STEPS, "dare"),
                                     device))
    carry, log = dare()
    dare_finite = finite_rows(log.x, log.u, *carry.cert)
    report, logs, counts = {"card": card}, {}, {}
    real, record = core.solve_terminal_lmi, []

    def recording(*a, **k):
        res = real(*a, **k)
        record.append((res.branch, res.feasibility))
        return res

    for backend in ("pallas", "xla"):
        run = poisoned_loop(config_loop(make(backend, LMI_STEPS), device))
        zero_counts()
        core.solve_terminal_lmi = recording
        try:
            (carry, log), wall = timed(run)
        finally:
            core.solve_terminal_lmi = real
        got = read_counts()
        want = LMI_STEPS if backend == "pallas" else 0
        print(f"phase 17 lmi ({backend}): {wall:.2f} s, launches {got}",
              flush=True)
        if got != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"lmi {backend} launched {got} in {LMI_STEPS} steps")
        finite = finite_rows(log.x, log.u, *carry.cert)
        lost = dare_finite & ~finite
        if bool(lost.any()):
            fail(f"lmi {backend}: {int(lost.sum())} scenarios finite in "
                 "the DARE mode went non-finite")
        if float(log.u[finite].abs().max()) > 2.0:
            fail(f"lmi {backend}: |u| > 2")
        if bool(log.cert_fresh[POISONED, 0]):
            fail(f"lmi {backend}: the poisoned scenario's first "
                 "certificate passed the guard")
        branch = torch.stack([b for b, _ in record])  # (T, B)
        feas = torch.stack([f for _, f in record])
        record.clear()
        if not bool(torch.isnan(feas[0, POISONED])):
            fail(f"lmi {backend}: the poisoned scenario's first "
                 f"feasibility {float(feas[0, POISONED])}, not NaN")
        logs[backend] = log
        if backend == "pallas":
            counts = got
            run_k, carry_k = run, carry
        report[backend] = {
            "wall_s": wall, "ms_per_step": wall / LMI_STEPS * 1e3,
            "scenarios_finite": int(finite.sum()),
            "scenarios_finite_dare_mode": int(dare_finite.sum()),
            "cert_fresh_share": float(log.cert_fresh.float().mean()),
            "branch_share": {name: float((branch == i).float().mean())
                             for i, name in enumerate(BRANCH_NAMES)},
            "feasibility_max": float(feas[torch.isfinite(feas)].max()),
            "feasibility_nan": int(torch.isnan(feas).sum()),
            "u_abs_max": float(log.u[finite].abs().max())}
    # float64: the kernel route against the plain route, phase 15's gate
    # (EARLY_TOL, or ten times the plain route's one-ulp-of-x0 floor, the
    # floor computed only where the tolerance alone does not hold)
    runs = {b: config_loop(make(b, LMI_F64_STEPS), device, "float64",
                           batch=EARLY_BATCH) for b in ("pallas", "xla")}
    xs = {b: r()[1].x for b, r in runs.items()}
    dx = (xs["pallas"] - xs["xla"]).abs().amax(-1)
    early = {"batch": EARLY_BATCH, "steps": LMI_F64_STEPS,
             "dx_f64": float(dx.max()), "tol": EARLY_TOL}
    if not bool((dx <= EARLY_TOL).all()):
        run = runs["xla"]
        floor = torch.stack([
            (run(torch.nextafter(run.x0, torch.full_like(run.x0, t)))[1].x
             - xs["xla"]).abs().amax(-1) for t in (9.0, -9.0)]).amax(0)
        floor = floor.cummax(dim=1).values
        early["floor_f64"] = float(floor.max())
        if not bool((dx <= torch.clamp(10.0 * floor, min=EARLY_TOL)).all()):
            fail(f"lmi: float64 kernel and plain loops differ: {early}")
    report["early_f64"] = early
    # one step at the end state, kernel route
    step = one_step_loop(run_k.pipe, run_k.args, carry_k, LMI_STEPS)
    report["step"] = step_report(step, warm_up=False)
    report["eigvalsh_on_the_card"] = eigvalsh_probe(device)
    print("phase 17 lmi " + json.dumps(report), flush=True)
    return counts, report


def phase_lqr(device, card: str):
    """Phase 17 (b): the flagship with the LQR law: no launch, finite,
    |u| <= 2; the float64 fleet equals run_batch bit for bit."""
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.controller import BatchedController

    def make(steps):
        cfg = flagship_config(steps, HORIZON, "pallas")
        cfg.mpc.controller = "lqr"
        return cfg

    run = config_loop(make(LQR_STEPS), device)
    zero_counts()
    (carry, log), wall = timed(run)
    got = read_counts()
    if got != {"box_admm": 0, "fused_qp": 0, "fused_qp_soa": 0}:
        fail(f"lqr launched {got}")
    check_loop(carry, log, "lqr", LQR_STEPS)
    mse, sse = quality_vs(log, torch.ones(BATCH, dtype=torch.bool,
                                          device=log.x.device), 1.0)
    run64 = config_loop(make(LQR_F64_CALLS), device, "float64",
                        batch=LQR_F64_BATCH)
    _, log64 = run64()
    fleet = BatchedController.from_pipeline(run64.pipe, LQR_F64_BATCH)
    xs, us, _ = serve(fleet, external_plant(run64.pipe, run64.batch),
                      run64.x0, LQR_F64_CALLS)
    same = torch.equal(xs, log64.x) and torch.equal(us, log64.u)
    if not same:
        fail("lqr: the float64 fleet differs from run_batch: "
             f"dx {float((xs - log64.x).abs().max())}, "
             f"du {float((us - log64.u).abs().max())}")
    report = {"wall_s": wall, "ms_per_step": wall / LQR_STEPS * 1e3,
              "launches": got["box_admm"], "mse_x1": mse, "sse_x1": sse,
              "u_abs_max": float(log.u.abs().max()),
              "fleet_equals_run_batch_f64": same, "card": card}
    print("phase 17 lqr " + json.dumps(report), flush=True)
    return report


def local_linear_run(backend: str, device, dtype: str = "float32",
                     batch: int = BATCH, steps: int = LOCAL_STEPS):
    """The local-linearization loop on the flagship's plant and weights
    (``run.build_local_linear``) over the bench's scenarios, a thunk."""
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_local_linear, replicate
    from koopmanx_torch.systems.library import get_system

    cfg = flagship_config(steps, HORIZON, backend)
    cfg.dtype = dtype
    loop, params = build_local_linear(cfg, device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), batch,
                          param_scale=0.15, dtype=getattr(torch, dtype),
                          device=device)
    args = (replicate(params, batch), sc.x0, sc.theta0, sc.theta1)

    def run():
        return loop(*args)

    run.params, run.batch = params, sc
    return run


def phase_local_linear(device, card: str):
    """Phase 17 (c): the local-linearization baseline on both routes:
    LOCAL_STEPS launches, then 0; finite, |u| <= 2; the float64 gap."""
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.run import build_local_linear, replicate

    report, counts = {"card": card}, {}
    for backend in ("pallas", "xla"):
        run = local_linear_run(backend, device)
        zero_counts()
        (carry, log), wall = timed(run)
        got = read_counts()
        want = LOCAL_STEPS if backend == "pallas" else 0
        print(f"phase 17 local-linear ({backend}): {wall:.2f} s, launches "
              f"{got}", flush=True)
        if got != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"local-linear {backend} launched {got}")
        check_loop(carry, log, f"local-linear {backend}", LOCAL_STEPS)
        mse, sse = quality_vs(log, torch.ones(BATCH, dtype=torch.bool,
                                              device=log.x.device), 1.0)
        report[backend] = {"wall_s": wall,
                           "ms_per_step": wall / LOCAL_STEPS * 1e3,
                           "mse_x1": mse, "sse_x1": sse,
                           "u_abs_mean": float(log.u.abs().mean())}
        if not sse <= LOCAL_SSE_MAX:
            fail(f"local-linear {backend}: steady-state error {sse} > "
                 f"{LOCAL_SSE_MAX}")
        if backend == "pallas":
            counts, end = got, carry
    logs = {b: local_linear_run(b, device, "float64", EARLY_BATCH,
                                LOCAL_F64_STEPS)()[1]
            for b in ("pallas", "xla")}
    gap = {k: float((getattr(logs["pallas"], k)
                     - getattr(logs["xla"], k)).abs().max()) for k in "xu"}
    report["gap_f64"] = {"batch": EARLY_BATCH, "steps": LOCAL_F64_STEPS,
                         **gap,
                         "tol": LOCAL_F64_TOL}
    if not max(gap.values()) <= LOCAL_F64_TOL:
        fail(f"local-linear: float64 routes differ: {gap}")
    # one step from the end state (kernel route)
    loop, params = build_local_linear(flagship_config(1, HORIZON, "pallas"),
                                      device)
    sc = run.batch
    args = (replicate(params, BATCH), end.x, sc.theta0, sc.theta1,
            end.u_applied)
    report["step"] = step_report(lambda: loop(*args))
    print("phase 17 local-linear " + json.dumps(report), flush=True)
    return counts, report


def phase_spectral_drift(device, card: str):
    """Phase 17 (d): drift_norm='spectral' on the flagship, one step at a
    time: each step's drifts against numpy's float64 2-norm of the same
    model differences."""
    import numpy as np
    import torch
    from koopmanx_torch.configs import flagship_config

    run = config_loop(flagship_config(DRIFT_STEPS, HORIZON, "pallas"),
                      device)
    pipe, sc = run.pipe, run.batch
    from koopmanx_torch.run import replicate

    args = (replicate(pipe.params, BATCH), sc.x0,
            replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH),
            sc.theta0, sc.theta1)
    carry, worst = None, 0.0
    for k in range(DRIFT_STEPS):
        old = pipe.model0 if carry is None else carry.model
        fn = one_step_loop(pipe, args, carry, k, drift_norm="spectral")
        carry, log = fn()
        for name, new_m, old_m in zip("abc", carry.model, old):
            d = (new_m - old_m).double().cpu().numpy()
            want = np.linalg.norm(d.reshape((-1,) + d.shape[-2:]), 2,
                                  axis=(-2, -1))
            got = getattr(log, f"drift_{name}")[:, 0].double().cpu().numpy()
            if not np.array_equal(np.isnan(got), np.isnan(want)):
                fail(f"spectral drift {name} step {k}: NaN pattern")
            ok = ~np.isnan(want)
            err = np.abs(got[ok] - want[ok])
            if not (err <= DRIFT_RTOL * want[ok] + 1e-30).all():
                fail(f"spectral drift {name} step {k}: "
                     f"{float((err / np.maximum(want[ok], 1e-30)).max())}")
            worst = max(worst, float((err / np.maximum(want[ok], 1e-30))
                                     .max()) if err.size else 0.0)
    syncs, sources = syncs_per_call(
        one_step_loop(pipe, args, carry, DRIFT_STEPS, drift_norm="spectral"),
        calls=1)
    report = {"steps": DRIFT_STEPS, "worst_rel_err": worst,
              "rtol": DRIFT_RTOL, "host_syncs_per_step": syncs,
              "host_sync_sources": sources, "card": card}
    print("phase 17 spectral drift " + json.dumps(report), flush=True)
    return report


def phase_shooting(device, card: str, pipe, carry):
    """Phase 17 (e): the shooting PGD on phase 3's end-state models (the
    lifted end states, the flagship's reference window, |u| <= 2, N = Np
    = HORIZON, the solver's default 200 steps) on the card, against the
    CPU on its first PGD_CPU_BATCH scenarios, in float32 and float64."""
    import torch
    from koopmanx_torch.control.shooting import solve_shooting_pgd
    from koopmanx_torch.run import ref_fn_for
    from koopmanx_torch.types import LinearModel

    with torch.inference_mode():
        z0 = pipe.dictionary(carry.x)
    r = ref_fn_for(pipe.config, pipe.params.q_block.shape[-1],
                   pipe.device, pipe.dictionary)(0)
    report = {"batch": BATCH, "cpu_batch": PGD_CPU_BATCH, "card": card}
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        model = LinearModel(*(t.to(dt) for t in carry.model))
        k = PGD_CPU_BATCH
        args = lambda m, dev, b=BATCH: (
            LinearModel(*(t[:b].to(dev) for t in m)), z0[:b].to(dev, dt),
            r.to(dev, dt), HORIZON, HORIZON, -2.0, 2.0)
        out, wall = timed(lambda: solve_shooting_pgd(*args(model, device)))
        cpu = solve_shooting_pgd(*args(model, "cpu", k))
        gap = float((out[:k].cpu() - cpu).abs().max())
        floor = 0.0
        if gap > PGD_TOL[dtype]:
            a_up = torch.nextafter(model.A, torch.full_like(model.A, 9.0))
            nudged = solve_shooting_pgd(*args(model._replace(A=a_up), "cpu",
                                              k))
            floor = float((nudged - cpu).abs().max())
        report[dtype] = {"gap_card_vs_cpu": gap, "floor_one_ulp_a": floor,
                         "tol": PGD_TOL[dtype], "card_s": wall,
                         "u_abs_max": float(out.abs().max())}
        if not bool(torch.isfinite(out).all()):
            fail(f"shooting {dtype}: non-finite")
        if not gap <= max(PGD_TOL[dtype], 10.0 * floor):
            fail(f"shooting {dtype}: card vs CPU {report[dtype]}")
    print("phase 17 shooting " + json.dumps(report), flush=True)
    return report


def training_inputs(device, dtype):
    """The CLI's training data (duffing, seed 0, 100 x 100) and its
    windows on ``device`` in ``dtype``."""
    import torch
    from koopmanx_torch.systems.data import collect
    from koopmanx_torch.systems.library import get_system
    from koopmanx_torch.train.kmae import make_windows

    data = collect(get_system("duffing"), torch.Generator().manual_seed(0),
                   n_step=100, n_traj=100)
    snaps = [t.to(device, dtype) for t in data]
    return snaps, make_windows(*snaps, 100, 6)


def train_through_cli(device, tmp: str):
    """Phase 18 (a): ``cli train`` at its defaults on the card, with the
    state and history that ``fit`` returns kept for the gates."""
    import contextlib
    import io

    import torch
    from koopmanx_torch import cli
    from koopmanx_torch.convert import kmae_leaves, kmae_state_to_numpy
    from koopmanx_torch.lifts.io import load_mat_mlp
    from koopmanx_torch.train import trainer
    from koopmanx_torch.train.kmae import KMAEConfig, init_state

    prefix, ckpt = os.path.join(tmp, "duffing"), os.path.join(tmp, "kmae.npz")
    real_fit, kept = trainer.fit, {}

    def fit(*args, **kwargs):
        t0 = time.perf_counter()
        kept["state"], kept["history"] = real_fit(*args, **kwargs)
        torch.cuda.synchronize()
        kept["fit_s"] = time.perf_counter() - t0
        return kept["state"], kept["history"]

    out = io.StringIO()
    trainer.fit = fit
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main([*TRAIN_ARGV, "--export", prefix, "--checkpoint", ckpt])
    finally:
        trainer.fit = real_fit
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = out.getvalue()
    final = json.loads(text[text.index("\n{") + 1:])["final"]
    state, history = kept["state"], kept["history"]
    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    report = {"argv": TRAIN_ARGV, "wall_s": wall, "fit_s": kept["fit_s"],
              "optimizer_steps": steps,
              "ms_per_step_in_fit": kept["fit_s"] / steps * 1e3,
              "launches": counts,
              "epochs": [{k: h[k] for k in ("loss", "l_rec", "l_lin",
                                            "l_pred")} for h in history]}
    if len(history) != TRAIN_EPOCHS or final != history[-1]:
        fail(f"training: {len(history)} epochs, final {final}")
    for h in history:
        if not all(math.isfinite(h[k]) for k in ("loss", "l_rec", "l_lin",
                                                  "l_pred")):
            fail(f"training: non-finite epoch {h}")
    if not history[5]["loss"] < history[0]["loss"]:
        fail("training: the loss at epoch 5 is not below epoch 0's")
    if not history[-1]["l_rec"] < history[0]["l_rec"]:
        fail("training: the last epoch's l_rec is not below epoch 0's")
    # the checkpoint reloads to the returned state, leaf for leaf
    template = init_state(torch.Generator().manual_seed(1), KMAEConfig(),
                          n=2, nlift=8, hidden=TRAIN_HIDDEN, device=device)
    loaded, step = trainer.load_checkpoint(ckpt, template)
    ours = kmae_leaves(kmae_state_to_numpy(state))
    back = kmae_leaves(kmae_state_to_numpy(loaded))
    if step != TRAIN_EPOCHS or any(
            not (a == b).all() for a, b in zip(ours, back)):
        fail(f"training: the checkpoint (step {step}) does not reload to "
             "the trained state")
    enc = load_mat_mlp(prefix + "_encoder.mat")
    for (w, b), (w2, b2) in zip(state.params.encoder.params(), enc):
        if not (torch.equal(w.detach().cpu(), w2)
                and torch.equal(b.detach().cpu(), b2)):
            fail("training: the exported encoder does not load as trained")
    report["encoder_shapes"] = [list(w.shape) for w, _ in enc]
    return state, prefix + "_encoder.mat", report


def train_step_report(device, state):
    """Steady ms per optimizer step over TRAIN_TIMED_STEPS steps on a copy
    of the trained state, then ``step_report`` of one step (device
    operations, host synchronizations, idle share)."""
    import torch
    from koopmanx_torch.convert import (
        kmae_state_from_numpy,
        kmae_state_to_numpy,
    )
    from koopmanx_torch.train.kmae import KMAEConfig, make_train_step

    (x, y, u), (xw, uw) = training_inputs(device, torch.float32)
    step, _ = make_train_step(KMAEConfig())
    box = [kmae_state_from_numpy(kmae_state_to_numpy(state), device=device)]
    idx = torch.arange(256, device=device)

    def one():
        box[0] = step(box[0], x, y, u, xw[idx], uw[idx])[0]

    one()
    ms = timed(lambda: [one() for _ in range(TRAIN_TIMED_STEPS)])[1] * 1e3
    return {"ms_per_step_steady": ms / TRAIN_TIMED_STEPS,
            "one_step": step_report(one)}


def train_card_vs_cpu(device):
    """Phase 18 (b): TRAIN_CHECK_STEPS float64 steps from one state on the
    same minibatches at full width, the card against the CPU, each leaf
    within TRAIN_F64_RTOL of its largest entry or within ten times the
    CPU's own spread there when the 10,000 snapshot rows are summed in
    two other orders, where that is larger: the fit's ridged 9 x 9 Gram
    amplifies a reordered sum, and Adam's step, ~lr g / (|g| + eps),
    amplifies it again where |g| is near eps (the biases, which start
    at 0)."""
    import numpy as np
    import torch
    from koopmanx_torch.convert import (
        kmae_leaves,
        kmae_state_from_numpy,
        kmae_state_to_numpy,
    )
    from koopmanx_torch.train.kmae import (
        KMAEConfig,
        init_state,
        make_train_step,
    )

    f64, cpu = torch.float64, torch.device("cpu")
    start = kmae_state_to_numpy(init_state(
        torch.Generator().manual_seed(2), KMAEConfig(), n=2, nlift=8,
        hidden=100, dtype=f64, device="cpu"))
    perm = torch.randperm(9400, generator=torch.Generator().manual_seed(3))
    step, _ = make_train_step(KMAEConfig())

    def run(dev, rows=None):
        snaps, (xw, uw) = training_inputs(dev, f64)
        if rows is not None:
            snaps = [t[rows.to(dev)] for t in snaps]
        state = kmae_state_from_numpy(start, device=dev, dtype=f64)
        losses = []
        for k in range(TRAIN_CHECK_STEPS):
            idx = perm[k * 256:(k + 1) * 256].to(dev)
            state, loss, _ = step(state, *snaps, xw[idx], uw[idx], k >= 3)
            losses.append(float(loss))
        return kmae_leaves(kmae_state_to_numpy(state)), losses

    rel = lambda a, b: float(np.abs(a - b).max()
                             / max(np.abs(b).max(), 1e-300))
    card, card_losses = run(device)
    cpu_leaves, cpu_losses = run(cpu)
    others = [run(cpu, torch.randperm(
        10000, generator=torch.Generator().manual_seed(10 + k)))
        for k in range(2)]
    worst, worst_ratio, bad = 0.0, 0.0, []
    for i, (a, b) in enumerate(zip(card, cpu_leaves)):
        if b.dtype == np.int32:
            continue
        spread = max(rel(o[0][i], b) for o in others)
        bound = max(TRAIN_F64_RTOL, 10 * spread)
        worst = max(worst, rel(a, b))
        worst_ratio = max(worst_ratio, rel(a, b) / bound)
        if not rel(a, b) <= bound:
            bad.append((i, rel(a, b), spread))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                        cpu_losses))
    loss_spread = max(abs(a - b) / abs(b) for o in others
                      for a, b in zip(o[1], cpu_losses))
    report = {"steps": TRAIN_CHECK_STEPS, "worst_leaf_rel": worst,
              "worst_ratio_to_bound": worst_ratio,
              "worst_loss_rel": loss_gap,
              "cpu_reordered_loss_spread": loss_spread,
              "cpu_reordered_leaf_spread": max(
                  rel(o[0][i], b) for o in others
                  for i, b in enumerate(cpu_leaves) if b.dtype != np.int32),
              "rtol": TRAIN_F64_RTOL, "losses_card": card_losses}
    if bad or not loss_gap <= max(TRAIN_F64_RTOL, 10 * loss_spread):
        fail(f"training float64: the card and the CPU differ: {report}, "
             f"leaves past their bound (index, gap, spread): {bad}")
    return report


def selftrained_config(weights: str, backend: str, steps: int):
    from koopmanx_torch.configs import duffing_selftrained_preset

    cfg = duffing_selftrained_preset()
    cfg.steps, cfg.mpc.qp_backend = steps, backend
    cfg.lift.weights_path = weights
    return cfg


def phase_selftrained(device, encoder: str, flagship_quality):
    """Phase 18 (c): duffing_selftrained with the trained encoder, kernel
    then plain route (SELFTRAINED_STEPS launches, then 0), their quality
    gate and float64 gap, and the kernel route on the shipped encoder."""
    from koopmanx_torch.run import resolve_weights_path

    report, counts = {}, None
    logs = {}
    for backend in ("pallas", "xla"):
        run = config_loop(selftrained_config(encoder, backend,
                                             SELFTRAINED_STEPS), device)
        if resolve_weights_path(run.pipe.config.lift.weights_path,
                                "duffing") != encoder:
            fail("duffing_selftrained does not load the trained encoder")
        zero_counts()
        (carry, log), wall = timed(run)
        got = read_counts()
        want = SELFTRAINED_STEPS if backend == "pallas" else 0
        if got != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"duffing_selftrained {backend} launched {got}")
        check_loop(carry, log, f"duffing_selftrained {backend}",
                   SELFTRAINED_STEPS)
        mse, sse = quality(log)
        report[backend] = {"wall_s_cold": wall, "mse_x1": mse, "sse_x1": sse,
                           "u_abs_max": float(log.u.abs().max())}
        logs[backend] = (mse, sse)
        if backend == "pallas":
            counts = got
    for i, what in enumerate(("tracking MSE", "steady-state error")):
        a, b = logs["pallas"][i], logs["xla"][i]
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"duffing_selftrained {what}: kernel {a} vs plain {b}")
    report["early_f64"] = early_f64_gate(
        lambda backend, steps: selftrained_config(encoder, backend, steps),
        device, "duffing_selftrained", tol=SELFTRAINED_F64_TOL)
    shipped = os.path.join(ROOT, "artifacts",
                           "duffing_kmae_refscale_encoder.mat")
    (_, log), _ = timed(config_loop(selftrained_config(
        shipped, "pallas", SELFTRAINED_STEPS), device))
    mse, sse = quality(log)
    report["shipped_encoder"] = {"weights": os.path.relpath(shipped, ROOT),
                                 "mse_x1": mse, "sse_x1": sse}
    report["flagship_random_init"] = {"mse_x1": flagship_quality[0],
                                      "sse_x1": flagship_quality[1]}
    return counts, report


def markov_check(model):
    """Each log-depth Markov build's F1 and F2 on ``model`` (phase 3's end
    state, HORIZON) against 'dag', float32 and float64: the largest gap
    over scenarios relative to that scenario's largest entry, held to
    MARKOV_RTOL or, in float32, to twice 'dag''s own float32 error (against
    'dag' in float64 on the same models) where that is larger: 'dag'
    itself is ~2e-5 off in float32 on these models (2048 CPU scenarios),
    20 powers of A with spectral radius up to ~1.18, and a build as
    accurate as 'dag' lies within twice that of it. The bound reads no
    number of the build under test."""
    import torch
    from koopmanx_torch.control.condensed import prediction_matrices
    from koopmanx_torch.types import LinearModel

    def gaps(got, ref):
        return [float(((g.double() - r.double()).abs().amax((-2, -1))
                       / r.double().abs().amax((-2, -1)).clamp(min=1e-30))
                      .max()) for g, r in zip(got, ref)]

    exact = prediction_matrices(
        LinearModel(*(t.double() for t in model)), HORIZON, method="dag")
    report = {}
    for dtype, rtol in MARKOV_RTOL.items():
        m = LinearModel(*(t.to(getattr(torch, dtype)) for t in model))
        dag = prediction_matrices(m, HORIZON, method="dag")
        dag_err = gaps(dag, exact)
        for method in ("doubling", "assoc"):
            got = prediction_matrices(m, HORIZON, method=method)
            gap = gaps(got, dag)
            bound = rtol
            if dtype == "float32":
                bound = max(rtol, 2 * max(dag_err))
            report[f"{method} {dtype}"] = {"f1": gap[0], "f2": gap[1],
                                           "bound": bound}
            if not max(gap) <= bound:
                fail(f"markov {method} {dtype}: F1/F2 off 'dag' by {gap}")
        report[f"dag {dtype} vs float64"] = {"f1": dag_err[0],
                                             "f2": dag_err[1]}
    return report


def phase_l7(device, end_model):
    """Phase 18 (d): the flagship over L7_STEPS on the kernel route with
    each L7 option (L7_RUNS): L7_STEPS launches, finite, |u| <= 2; then
    ``markov_check`` on phase 3's end-state models."""
    from koopmanx_torch.cli import _apply_overrides
    from koopmanx_torch.configs import flagship_config

    report, counts = {}, {}
    for key, value in L7_RUNS:
        cfg = _apply_overrides(flagship_config(L7_STEPS, HORIZON, "pallas"),
                               [f"{key}={value}"])
        run = config_loop(cfg, device)
        zero_counts()
        (carry, log), wall = timed(run)
        got = read_counts()
        name = f"{key}={value}"
        if got != {"box_admm": L7_STEPS, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"{name} launched {got}")
        check_loop(carry, log, name, L7_STEPS)
        counts[name] = got["box_admm"]
        report[name] = {"nlift": run.pipe.dictionary.nlift,
                        "wall_s_cold": wall,
                        "ms_per_step_cold": wall / L7_STEPS * 1e3,
                        "u_abs_max": float(log.u.abs().max()),
                        "sse_x1": quality(log, tail=20)[1]}
    report["markov_vs_dag"] = markov_check(end_model)
    return counts, report


def phase_training(device, card: str, end_model, flagship_quality):
    """Phase 18: (a) training through the CLI, (b) the card against the
    CPU, (c) the trained encoder in the loop, (d) the L7 options. Returns
    the B1 launches by path and the report."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kmae_") as tmp:
        state, encoder, train = train_through_cli(device, tmp)
        train.update(train_step_report(device, state))
        print("phase 18 (a) training " + json.dumps(train), flush=True)
        t_a = time.perf_counter() - t0
        check = train_card_vs_cpu(device)
        print("phase 18 (b) card vs CPU " + json.dumps(check), flush=True)
        sel_counts, sel = phase_selftrained(device, encoder, flagship_quality)
        print("phase 18 (c) duffing_selftrained " + json.dumps(sel),
              flush=True)
    l7_counts, l7 = phase_l7(device, end_model)
    print("phase 18 (d) L7 " + json.dumps(l7), flush=True)
    counts = {"duffing_selftrained, trained encoder (phase 18)":
              sel_counts["box_admm"],
              "training (phase 18)": train["launches"]["box_admm"],
              **{f"{k} (phase 18)": v for k, v in l7_counts.items()}}
    report = {"training": train, "training_s": t_a, "card_vs_cpu_f64": check,
              "duffing_selftrained": sel, "l7": l7,
              "phase_s": time.perf_counter() - t0, "card": card}
    return counts, report


def expect_launches(got, want: int, name: str) -> None:
    if got != {"box_admm": want, "fused_qp": 0, "fused_qp_soa": 0}:
        fail(f"{name} launched {got}, not {want} box_admm launches")


def loop_args(run):
    """The loop arguments of ``config_loop``'s thunk ``run`` (its
    pipeline's shared leaves broadcast over its scenarios)."""
    from koopmanx_torch.run import replicate

    pipe, sc = run.pipe, run.batch
    b = sc.x0.shape[0]
    return (replicate(pipe.params, b), sc.x0, replicate(pipe.model0, b),
            replicate(pipe.rls0, b), sc.theta0, sc.theta1)


def bf16_flagship(backend: str, steps: int):
    from koopmanx_torch.configs import flagship_config

    cfg = flagship_config(steps=steps, horizon=HORIZON, qp_backend=backend)
    cfg.mpc.qp_kkt_bf16 = True
    return cfg


def engine_test_loop(device, bf16: bool):
    """tests/test_engine.py:355-371's loop at the port's full size: the
    shipped duffing preset from its x_init with nominal parameters, one
    scenario, BF16_X_STEPS float32 steps on the kernel route."""
    from koopmanx_torch.configs import duffing_nn_preset
    from koopmanx_torch.run import build_pipeline, run_single

    cfg = duffing_nn_preset()
    cfg.steps, cfg.mpc.qp_backend = BF16_X_STEPS, "pallas"
    cfg.mpc.qp_kkt_bf16 = bf16
    pipe = build_pipeline(cfg, device=device)
    zero_counts()
    _, log = run_single(pipe)
    expect_launches(read_counts(), BF16_X_STEPS,
                    f"the engine test's loop (bf16 {bf16})")
    return log


def phase_bf16(device, log_k, log_p, log_n):
    """Phase 19 (a): the bf16 KKT inverse. ``log_k`` and ``log_p`` are
    phase 3's and 4's float32 flagship logs (kernel, plain route),
    ``log_n`` phase 4's plain route from x0 one ulp up. Returns the
    kernel route's launches and the report."""
    import torch

    report, logs, counts = {}, {}, {}
    for backend in ("pallas", "xla"):
        run = config_loop(bf16_flagship(backend, STEPS), device)
        zero_counts()
        (carry, log), wall = timed(run)
        got = read_counts()
        expect_launches(got, STEPS if backend == "pallas" else 0,
                        f"bf16 {backend}")
        check_loop(carry, log, f"bf16 {backend}", STEPS)
        logs[backend], counts[backend] = log, got["box_admm"]
        mse, sse = quality(log)
        report[backend] = {"launches": got, "wall_s_cold": wall,
                           "ms_per_step_cold": wall / STEPS * 1e3,
                           "mse_x1": mse, "sse_x1": sse}
        if backend == "pallas":  # one step from the end state
            report["step_kernel_route"] = step_report(one_step_loop(
                run.pipe, loop_args(run), carry, STEPS))
    for what, key in (("tracking MSE", "mse_x1"),
                      ("steady-state error", "sse_x1")):
        a, b = report["pallas"][key], report["xla"][key]
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"bf16 {what}: kernel {a} vs plain {b}")
    sse32 = quality(log_k)[1]
    report["f32_sse_x1_phase3"] = sse32
    if not report["pallas"]["sse_x1"] <= BF16_SSE_FACTOR * sse32:
        fail(f"bf16 steady-state error {report['pallas']['sse_x1']} past "
             f"{BF16_SSE_FACTOR} x phase 3's {sse32}")
    # the first BF16_X_STEPS steps against the float32 loops, by scenario
    head = lambda a, b: (a.x[:, :BF16_X_STEPS]
                         - b.x[:, :BF16_X_STEPS]).abs().amax((1, 2))
    dx, floor = head(logs["pallas"], log_k), head(log_n, log_p)
    report["flagship_first_steps_vs_f32"] = {
        "steps": BF16_X_STEPS, "max_abs_dx": float(dx.max()),
        "share_within_0.05": float((dx <= BF16_X_TOL).double().mean()),
        "f32_one_ulp_x0_max_abs_dx": float(floor.max()),
        "f32_one_ulp_x0_share_within_0.05": float(
            (floor <= BF16_X_TOL).double().mean())}
    # gated: the engine test's own loop
    x32, x16 = (engine_test_loop(device, b).x for b in (False, True))
    gap = float((x16 - x32).abs().max())
    report["engine_test_loop"] = {"steps": BF16_X_STEPS, "launches":
                                  BF16_X_STEPS, "max_abs_dx": gap,
                                  "tol": BF16_X_TOL}
    if not (bool(torch.isfinite(x16).all()) and gap < BF16_X_TOL):
        fail(f"bf16: the engine test's loop moves {gap} from float32")
    report["early_f64"] = early_f64_gate(
        lambda b, st: bf16_flagship(b, st), device, "bf16",
        tol=BF16_F64_TOL)
    return counts["pallas"], report


def phase_carried(device, log_p, cold_p):
    """Phase 19 (b): the carried KKT inverse on the plain route, against
    phase 4's exact plain loop ``log_p`` (its cold wall ``cold_p``)."""
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine import core
    from koopmanx_torch.run import build_pipeline

    def make(backend, steps, refine=REFINE):
        cfg = flagship_config(steps=steps, horizon=HORIZON,
                              qp_backend=backend)
        cfg.mpc.qp_kkt_refine, cfg.mpc.qp_kkt_reanchor = refine, REANCHOR
        return cfg

    try:
        build_pipeline(make("pallas", 1), device=device)
        fail("the kernel route took qp_kkt_refine")
    except ValueError as e:
        if "qp_kkt_refine" not in str(e):
            raise
    run = config_loop(make("xla", STEPS), device)
    # which steps ran the exact inverse, and how many the tracker
    real = (core.carried_kkt_inverse, core.spd_inverse,
            core.ns_tracking_inverse)
    now, anchors, tracked = [None], [], [0]

    def carried(cfg, kkt, prev, step):
        now[0] = step
        return real[0](cfg, kkt, prev, step)

    def exact(*a, **k):
        anchors.append(now[0])
        return real[1](*a, **k)

    def refine(*a, **k):
        tracked[0] += 1
        return real[2](*a, **k)

    core.carried_kkt_inverse, core.spd_inverse = carried, exact
    core.ns_tracking_inverse = refine
    try:
        zero_counts()
        (carry, log), wall = timed(run)
    finally:
        (core.carried_kkt_inverse, core.spd_inverse,
         core.ns_tracking_inverse) = real
    expect_launches(read_counts(), 0, "the carried inverse (plain route)")
    check_loop(carry, log, "carried inverse", STEPS)
    want = list(range(0, STEPS, REANCHOR))
    if anchors != want or tracked[0] != STEPS - len(want):
        fail(f"carried inverse: exact at steps {anchors}, tracked "
             f"{tracked[0]} steps (want {want})")
    (mse, sse), (mse_p, sse_p) = quality(log), quality(log_p)
    report = {"refine": REFINE, "reanchor": REANCHOR, "anchors": len(anchors),
              "anchor_steps": anchors, "tracked_steps": tracked[0],
              "mse_x1": mse, "sse_x1": sse, "exact_mse_x1": mse_p,
              "exact_sse_x1": sse_p, "wall_s_cold": wall,
              "ms_per_step_cold": wall / STEPS * 1e3,
              "exact_ms_per_step_cold_phase4": cold_p / STEPS * 1e3,
              "kernel_route_refused": True}
    if not (abs(mse - mse_p) <= REFINE_MSE_RTOL * max(mse_p, 1e-9)
            and sse < max(2.0 * sse_p, REFINE_SSE_FLOOR)):
        fail(f"carried inverse quality {mse}, {sse} vs exact {mse_p}, "
             f"{sse_p}")
    # one step from the end state: a tracked step (200 % 16 = 8), an
    # anchor step (208), and the exact plain loop's step
    pipe, args = run.pipe, loop_args(run)
    report["step_tracked"] = step_report(one_step_loop(pipe, args, carry,
                                                       STEPS))
    report["step_anchor"] = step_report(one_step_loop(
        pipe, args, carry, STEPS + REANCHOR - STEPS % REANCHOR))
    report["step_exact_plain"] = step_report(one_step_loop(
        pipe, args, carry._replace(kkt_inv=()), STEPS, qp_kkt_refine=0))
    return report


def reference_checkpoint(tmp: str):
    """The shipped duffing encoder and decoder (``artifacts/duffing_kmae_
    {encoder,decoder}.mat``), cast to float32, as the reference writes its
    ``AutoEncoder_*.pkl``: ``torch.save`` of a module whose ``Encoder`` and
    ``Decoder`` are ReLU ``nn.Sequential``s; also its state_dict. Returns
    (model, checkpoint path, state_dict path)."""
    import torch
    from torch import nn
    from koopmanx_torch.lifts.io import load_mat_mlp

    class AutoEncoder(nn.Module):
        def __init__(self, enc, dec):
            super().__init__()
            self.Encoder, self.Decoder = (nn.Sequential(*[
                m for i, (w, b) in enumerate(layers)
                for m in ((nn.Linear(w.shape[1], w.shape[0]), nn.ReLU())
                          if i < len(layers) - 1 else
                          (nn.Linear(w.shape[1], w.shape[0]),))])
                for layers in (enc, dec))
            with torch.no_grad():
                for seq, layers in ((self.Encoder, enc), (self.Decoder, dec)):
                    linear = [m for m in seq if isinstance(m, nn.Linear)]
                    for lin, (w, b) in zip(linear, layers):
                        lin.weight.copy_(w)
                        lin.bias.copy_(b)

    # pickled by reference, as the reference's training script's class
    AutoEncoder.__qualname__ = "AutoEncoder"
    globals()["AutoEncoder"] = AutoEncoder
    art = os.path.join(ROOT, "artifacts", "duffing_kmae_{}.mat")
    model = AutoEncoder(*(load_mat_mlp(art.format(k), torch.float32)
                          for k in ("encoder", "decoder")))
    path = os.path.join(tmp, "AutoEncoder_duffing.pkl")
    sd_path = os.path.join(tmp, "AutoEncoder_duffing_state_dict.pkl")
    torch.save(model, path)
    torch.save(model.state_dict(), sd_path)
    return model, path, sd_path


def phase_pkl(device, log8, run8):
    """Phase 19 (c): the .pkl lift through phase 8's preset; ``log8`` and
    ``run8`` are phase 8's kernel-route log and thunk. Returns the
    launches and the report."""
    import tempfile

    import torch
    from koopmanx_torch.configs import duffing_nn_preset
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.lifts.io import load_torch_state_dict
    from koopmanx_torch.run import build_pipeline, run_scenarios
    from koopmanx_torch.systems.library import get_system

    with tempfile.TemporaryDirectory(prefix="pkl_") as tmp:
        model, path, sd_path = reference_checkpoint(tmp)
        own = model.state_dict()
        # the state_dict file through torch's own safe loader, the
        # whole-model file against the module: the port's reader agrees
        safe = torch.load(sd_path, weights_only=True)
        for name, ours in ((sd_path, load_torch_state_dict(sd_path)),
                           (path, load_torch_state_dict(path))):
            if sorted(ours) != sorted(own) or not all(
                    torch.equal(torch.from_numpy(ours[k]), safe[k])
                    for k in own):
                fail(f"the port's loader reads {os.path.basename(name)} "
                     "otherwise than torch")
        cfg = duffing_nn_preset()
        cfg.steps, cfg.mpc.qp_backend = PRESET_STEPS, "pallas"
        cfg.lift.weights_path = path
        pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), BATCH,
                          param_scale=0.15, device=device)
    zero_counts()
    (carry, log), wall = timed(lambda: run_scenarios(pipe, sc))
    got = read_counts()
    expect_launches(got, PRESET_STEPS, "the .pkl duffing preset")
    check_loop(carry, log, "the .pkl duffing preset", PRESET_STEPS)
    gap = max(float((log.x - log8.x).abs().max()),
              float((log.u - log8.u).abs().max()))
    report = {"launches": got, "wall_s_cold": wall, "steps": PRESET_STEPS,
              "torch": torch.__version__, "max_abs_gap_to_phase8": gap}
    if gap > 0.0:
        _, again = run8()
        spread = max(float((again.x - log8.x).abs().max()),
                     float((again.u - log8.u).abs().max()))
        report["phase8_run_to_run_spread"] = spread
        if gap > spread:
            fail(f"the .pkl preset differs from phase 8 by {gap}, past "
                 f"phase 8's own spread {spread}")
    return got["box_admm"], report


def native_vs_rk4(device):
    """Every native plant, both integrators, float64 on BATCH random
    states with per-plant parameters, against the port's RK4 on the card:
    the largest error relative to max(1, |x|)."""
    import numpy as np
    import torch
    from koopmanx_torch.systems.base import as_params, make_step
    from koopmanx_torch.systems.library import get_system
    from koopmanx_torch.systems.native import _SYS, native_step_batch

    rng = np.random.default_rng(0)
    worst = {}
    for name in sorted(_SYS):
        system = get_system(name)
        for integ in ("rk4", "rk4_matlab"):
            x = rng.uniform(0.1, 2.0, (BATCH, system.n))
            u = rng.uniform(-1.0, 1.0, (BATCH, system.m))
            theta = type(system.theta0)(*(
                v * rng.uniform(0.9, 1.1, BATCH) for v in system.theta0))
            got = native_step_batch(system, x, u, theta, 0.05, integ,
                                    per_plant_theta=True)
            ref = make_step(system, 0.05, integ)(
                torch.tensor(x, device=device), torch.tensor(u, device=device),
                as_params(theta, torch.float64, device)).cpu().numpy()
            err = float((np.abs(got - ref) / np.maximum(1, np.abs(ref))).max())
            worst[f"{name} {integ}"] = err
            if not err <= NATIVE_RTOL:
                fail(f"native {name} {integ} differs from the port's RK4 by "
                     f"{err}")
    return worst


def phase_hil(device, card: str):
    """Phase 19 (d): hardware in the loop through
    ``tools/bench_hil_torch.py``'s functions on the card. Returns the
    launches by run and the report."""
    from koopmanx_torch.ops import native

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_hil_torch

    t0 = time.perf_counter()
    native.load()  # builds the library; NativeUnavailable fails the run
    report = {"native_build_s": time.perf_counter() - t0,
              "native_library": os.path.relpath(str(native.LIB_PATH), ROOT)}
    counts = {}
    for preset, periods, fleet in HIL_RUNS:
        cfg, pipe = bench_hil_torch.build(preset, periods, cpu=False)
        zero = lambda k: zero_counts() if k == 0 else None
        run = bench_hil_torch.serve(cfg, pipe, periods, fleet, on_period=zero)
        got = read_counts()
        expect_launches(got, periods, f"HIL {preset}")
        out = bench_hil_torch.report(cfg, run, preset, fleet)
        tr = out["tracking"]
        sse = tr.get("steady_state_error",
                     tr.get("worst_plant_steady_state_error"))
        name = f"HIL {preset}, " + (f"fleet of {fleet}" if fleet else
                                    "one Controller")
        counts[f"{name} (phase 19)"] = got["box_admm"]
        report[name] = {"launches": got, **out, "card": card}
        if not (tr["finite"] and sse < HIL_SSE_MAX):
            fail(f"{name}: steady-state error {sse} (finite {tr['finite']})")
    report["native_vs_rk4_f64_rel"] = native_vs_rk4(device)
    return counts, report


def phase_serving_refine(device):
    """Phase 19 (e): a float64 fleet with the carried inverse, the even
    plants reset mid-run; the sampled plants against single Controllers
    and int-path twins."""
    import numpy as np
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.controller import BatchedController, Controller
    from koopmanx_torch.tree import tree_map

    batch, calls, reset_at = (SERVE_REFINE[k] for k in ("batch", "calls",
                                                         "reset_at"))
    cfg = flagship_config(steps=calls, horizon=HORIZON, qp_backend="xla")
    cfg.mpc.qp_kkt_refine, cfg.mpc.qp_kkt_reanchor = REFINE, REANCHOR
    run = config_loop(cfg, device, "float64", batch=batch)
    pipe, sc = run.pipe, run.batch
    plant = external_plant(pipe, sc)
    bc = BatchedController.from_pipeline(pipe, batch)
    _, _, x = serve(bc, plant, sc.x0, reset_at)
    singles = {}
    for i in SAMPLED:
        single = Controller.from_pipeline(pipe)
        single.state = tree_map(lambda a: a[i:i + 1].clone(), bc.state)
        single._k = bc.clocks[i:i + 1]
        singles[i] = single
    soft = torch.arange(batch) % 2 == 0
    bc.reset(mask=soft)
    for i, single in singles.items():
        if bool(soft[i]):
            single.reset()
    if bool(bc.state.kkt_inv[soft.to(device)].abs().max() != 0):
        fail("phase 19 (e): a reset plant kept its carried inverse")
    clocks = bc.clocks
    twins = {}
    for i in SAMPLED:
        twin = BatchedController.from_pipeline(pipe, batch)
        twin.state = tree_map(lambda a: a[i:i + 1].expand_as(a).clone(),
                              bc.state)
        twin._k = np.full(batch, clocks[i])
        twins[i] = twin
    worst = dict.fromkeys(("single", "twin"), 0.0)
    zero_counts()
    for k in range(reset_at, calls):
        u = bc.step(x)
        for i in SAMPLED:
            for name, got in (
                    ("single", singles[i].step(x[i])),
                    ("twin", twins[i].step(x[i:i + 1].expand(batch, -1))[0])):
                worst[name] = max(worst[name],
                                  float((got - u[i]).abs().max()))
        x = plant(x, u, k)
    expect_launches(read_counts(), 0, "phase 19 (e) (plain route)")
    report = {"batch": batch, "calls": calls, "reset_at": reset_at,
              "reset": int(soft.sum()), "sampled": list(SAMPLED),
              "clocks_after_reset": sorted(set(clocks.tolist())),
              "max_abs_du_vs_single": worst["single"],
              "max_abs_du_vs_int_path_twin": worst["twin"],
              "tol_single": SINGLE_TOL, "tol_twin": SERVE_TOL}
    if not (worst["single"] <= SINGLE_TOL and worst["twin"] <= SERVE_TOL):
        fail(f"phase 19 (e): reset plants differ: {report}")
    return report


def phase_l3_pkl_hil(device, card: str, flagship, log8, run8):
    """Phase 19: (a)-(e). ``flagship`` holds phase 3-4's float32 logs
    (kernel, plain, plain from x0 one ulp up) and the plain route's cold
    wall. Returns the launches by path and the report."""
    t0 = time.perf_counter()
    log_k, log_p, log_n, cold_p = flagship
    counts, report = {}, {"card": card}
    t = time.perf_counter()
    counts["flagship, bf16 KKT inverse (phase 19)"], report["bf16"] = (
        phase_bf16(device, log_k, log_p, log_n))
    counts["engine test loop, bf16 KKT inverse (phase 19)"] = BF16_X_STEPS
    report["bf16"]["phase_s"] = time.perf_counter() - t
    print("phase 19 (a) bf16 " + json.dumps(report["bf16"]), flush=True)
    t = time.perf_counter()
    report["carried"] = phase_carried(device, log_p, cold_p)
    counts["flagship, carried KKT inverse (phase 19)"] = 0
    report["carried"]["phase_s"] = time.perf_counter() - t
    print("phase 19 (b) carried " + json.dumps(report["carried"]), flush=True)
    t = time.perf_counter()
    counts["duffing preset from .pkl (phase 19)"], report["pkl"] = phase_pkl(
        device, log8, run8)
    report["pkl"]["phase_s"] = time.perf_counter() - t
    print("phase 19 (c) pkl " + json.dumps(report["pkl"]), flush=True)
    t = time.perf_counter()
    hil_counts, report["hil"] = phase_hil(device, card)
    counts.update(hil_counts)
    report["hil"]["phase_s"] = time.perf_counter() - t
    print("phase 19 (d) HIL " + json.dumps(report["hil"]), flush=True)
    t = time.perf_counter()
    report["serving_refine"] = phase_serving_refine(device)
    report["serving_refine"]["phase_s"] = time.perf_counter() - t
    print("phase 19 (e) serving, carried inverse "
          + json.dumps(report["serving_refine"]), flush=True)
    report["phase_s"] = time.perf_counter() - t0
    return counts, report


def flagship_pipeline_f64(device, steps: int = LOOP_EARLY_STEPS):
    """The flagship's loop (kernel route) in float64 over ``steps`` at
    BATCH scenarios, as a ``config_loop`` thunk."""
    from koopmanx_torch.configs import flagship_config

    return config_loop(flagship_config(steps=steps, horizon=HORIZON,
                                       qp_backend="pallas"),
                       device, "float64")


def max_gap(a, b) -> float:
    return max(float((p - q).abs().max()) for p, q in zip(a, b))


def phase_mesh_one(device, card: str, run_kernel, log_k, fused_ms: float):
    """Phase 20 (a): world size 1 through NCCL at the flagship's width:
    ``make_mesh()``, phase 3's pipeline and scenarios through
    ``sharded_closed_loop`` (STEPS launches; x and u bit for bit phase
    3's), the distributed fit on the flagship's 50 x 50 data in float64
    against ``edmd_fit(method='solve')``, ``psum_mean``, and one
    data-parallel KMAE step at the reference's width against the plain
    step, bit for bit. Returns the launches and the report."""
    import torch
    import torch.distributed as dist
    from koopmanx_torch.convert import kmae_leaves, kmae_state_to_numpy
    from koopmanx_torch.edmd.batch import edmd_fit
    from koopmanx_torch.parallel import (
        distributed_edmd_fit,
        make_mesh,
        psum_mean,
        shard_batch,
        sharded_closed_loop,
    )
    from koopmanx_torch.train.kmae import KMAEConfig, init_state, make_train_step

    mesh = make_mesh()
    report = {"backend": dist.get_backend(), "world": mesh.size(),
              "card": card}
    pipe = run_kernel.pipe
    shards = shard_batch(loop_args(run_kernel), mesh)
    zero_counts()
    (carry, log), wall = timed(lambda: sharded_closed_loop(
        pipe.closed_loop, mesh, *shards))
    counts = read_counts()
    report.update({"launches": counts, "ms_per_step": wall / STEPS * 1e3,
                   "phase5_fused_loop_ms_per_step": fused_ms})
    if counts != {"box_admm": STEPS, "fused_qp": 0, "fused_qp_soa": 0}:
        fail(f"phase 20 (a): the sharded loop launched {counts}")
    check_loop(carry, log, "phase 20 (a) sharded", STEPS)
    report["x_u_equal_phase3"] = (torch.equal(log.x, log_k.x)
                                  and torch.equal(log.u, log_k.u))
    if not report["x_u_equal_phase3"]:
        fail(f"phase 20 (a): the sharded loop differs from phase 3's: x "
             f"{float((log.x - log_k.x).abs().max())}, u "
             f"{float((log.u - log_k.u).abs().max())}")

    pipe64 = flagship_pipeline_f64(device, 1).pipe
    data = pipe64.data
    with torch.no_grad():
        fit = distributed_edmd_fit(pipe64.dictionary, shard_batch(data, mesh),
                                   mesh)
        whole = edmd_fit(pipe64.dictionary, data, method="solve")
    report["fit"] = {"snapshots": int(data.x.shape[0]), "dtype": "float64",
                     "max_gap": max_gap(fit, whole), "tol": FIT_TOL}
    if not report["fit"]["max_gap"] <= FIT_TOL:
        fail(f"phase 20 (a): distributed fit {report['fit']}")
    mean = psum_mean(shard_batch(torch.arange(
        16.0, dtype=torch.float64, device=device), mesh), mesh)
    report["psum_mean_arange16"] = float(mean)
    if float(mean) != 7.5:
        fail(f"phase 20 (a): psum_mean(arange(16)) = {float(mean)}")

    cfg = KMAEConfig()
    (x, y, u), (xw, uw) = training_inputs(device, torch.float32)
    idx = torch.arange(256, device=device)
    steps = {"plain": make_train_step(cfg)[0],
             "data-parallel": make_train_step(
                 cfg, group=mesh.get_group("data"))[0]}
    out = {}
    for name, step in steps.items():
        state = init_state(torch.Generator().manual_seed(0), cfg, 2, 8,
                           hidden=TRAIN_HIDDEN, device=device)
        args = (x, y, u, xw[idx], uw[idx])
        if name != "plain":
            args = shard_batch(args, mesh)
        state, loss, _ = step(state, *args)
        out[name] = (kmae_leaves(kmae_state_to_numpy(state)), float(loss))
    equal = out["plain"][1] == out["data-parallel"][1] and all(
        (p == q).all() for p, q in zip(out["plain"][0], out["data-parallel"][0]))
    report["kmae_step"] = {"hidden": TRAIN_HIDDEN, "snapshots": int(x.shape[0]),
                           "windows": int(idx.numel()),
                           "loss": out["plain"][1], "bit_for_bit": equal}
    if not equal:
        fail(f"phase 20 (a): the data-parallel KMAE step differs from the "
             f"plain step: {report['kmae_step']}")
    dist.destroy_process_group()
    return {"sharded flagship, world size 1 (phase 20)": counts["box_admm"]}, \
        report


def two_rank_worker(rank: int, port: int, out_path: str) -> int:
    """One of phase 20 (b)'s two ranks sharing the card (gloo: NCCL
    refuses two ranks on one GPU): its half of the float64 flagship loop
    over LOOP_EARLY_STEPS through ``sharded_closed_loop``, the distributed
    fit against the whole-data fit and ``psum_mean``, on CUDA tensors."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from koopmanx_torch.edmd.batch import edmd_fit
    from koopmanx_torch.parallel import (
        distributed_edmd_fit,
        initialize_multihost,
        make_mesh,
        psum_mean,
        shard_batch,
        sharded_closed_loop,
    )

    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = make_mesh("cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    run = flagship_pipeline_f64(device)
    pipe = run.pipe
    zero_counts()
    carry, log = sharded_closed_loop(pipe.closed_loop, mesh, *shard_batch(
        loop_args(run), mesh))
    launches = read_counts()["box_admm"]
    with torch.no_grad():
        fit = distributed_edmd_fit(pipe.dictionary,
                                   shard_batch(pipe.data, mesh), mesh)
        whole = edmd_fit(pipe.dictionary, pipe.data, method="solve")
    mean = psum_mean(shard_batch(torch.arange(
        16.0, dtype=torch.float64, device=device), mesh), mesh)
    torch.save({"x": log.x.cpu(), "u": log.u.cpu(), "launches": launches,
                "rows": int(log.x.shape[0]), "device": str(log.x.device),
                "backend": dist.get_backend(), "world": mesh.size(),
                "fit_gap": max_gap(fit, whole), "psum_mean": float(mean)},
               out_path)
    dist.destroy_process_group()
    return 0


def phase_two_ranks(device, tmp: str):
    """Phase 20 (b): two ranks of ``two_rank_worker`` on the card, started
    together; meanwhile the whole batch's float64 loop here and its
    one-ulp-of-x0 floor (up, then down). The gathered shards are held per
    scenario and step to EARLY_TOL or ten times that floor (phase 13's
    gate), the fit to FIT_TOL, ``psum_mean`` to 7.5. A rank that fails
    fails the phase with its error."""
    import socket

    import torch
    from koopmanx_torch.run import run_scenarios

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--two-rank-worker",
         str(r), str(port), outs[r]], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        run = flagship_pipeline_f64(device)
        whole = run()[1].x
        floors = [run_scenarios(run.pipe, run.batch._replace(
            x0=torch.nextafter(run.x0, torch.full_like(run.x0, t))))[1].x
            for t in (9.0, -9.0)]
        for p in procs:
            p.wait(timeout=TWO_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            fail(f"phase 20 (b): rank {r} exited {p.returncode}:\n"
                 f"{text[-4000:]}")
    ranks = [torch.load(o) for o in outs]
    x = torch.cat([o["x"] for o in ranks]).to(device)
    diff = lambda a: (a - whole).abs().amax(-1)  # (B, T)
    floor = torch.stack([diff(f) for f in floors]).amax(0).cummax(1).values
    bound = torch.clamp(10.0 * floor, min=EARLY_TOL)
    dx = diff(x)
    report = {
        "ranks": [{k: o[k] for k in ("rows", "device", "backend", "world",
                                     "launches", "fit_gap", "psum_mean")}
                  for o in ranks],
        "batch": BATCH, "steps": LOOP_EARLY_STEPS, "dtype": "float64",
        "dx_f64": float(dx.max()), "floor_f64": float(floor.max()),
        "tol": EARLY_TOL, "bit_for_bit": bool((dx == 0).all()),
        "share_held_at_tol": float((bound == EARLY_TOL).double().mean()),
        "worst_ratio_to_bound": float((dx / bound).max())}
    if not bool((dx <= bound).all()):
        fail(f"phase 20 (b): the two ranks' loop differs from the whole "
             f"batch's: {report}")
    for r, o in enumerate(ranks):
        if (o["rows"] != BATCH // 2 or o["launches"] != LOOP_EARLY_STEPS
                or not o["fit_gap"] <= FIT_TOL or o["psum_mean"] != 7.5
                or o["world"] != 2 or not o["device"].startswith("cuda")):
            fail(f"phase 20 (b): rank {r}: {report['ranks'][r]}")
    return {"two ranks sharing the card, float64 (phase 20)":
            sum(o["launches"] for o in ranks)}, report


def phase_eigenfunctions(pipe, end_model, h: float):
    """Phase 20 (c): ``eval/plots.py::eigenfunction_grid`` on the card,
    with the flagship's dictionary in float64 and scenario 0's end-state
    model of phase 3, against the same dictionary on the CPU (the rest of
    ``plots`` draws with matplotlib, which the card's machine lacks)."""
    import copy

    import torch
    from koopmanx_torch.eval.modes import spectral_decomposition
    from koopmanx_torch.eval.plots import eigenfunction_grid
    from koopmanx_torch.tree import tree_map

    spec = spectral_decomposition(tree_map(lambda t: t[0], end_model), h)
    d64 = copy.deepcopy(pipe.dictionary).to(torch.float64)
    pts, phi = eigenfunction_grid(spec, d64)
    pts_c, phi_c = eigenfunction_grid(spec, copy.deepcopy(d64).cpu())
    scale = max(1.0, float(abs(phi_c).max()))
    report = {"grid": list(phi.shape), "device": str(
        next(d64.parameters()).device), "max_abs_phi": float(abs(phi_c).max()),
        "max_gap": float(abs(phi - phi_c).max()), "tol": EIGFUN_TOL,
        "points_equal": bool((pts == pts_c).all())}
    if not (report["points_equal"]
            and report["max_gap"] <= EIGFUN_TOL * scale):
        fail(f"phase 20 (c): eigenfunction_grid on the card vs the CPU "
             f"{report}")
    return report


def phase_parallel(device, card: str, run_kernel, log_k, carry_k,
                   fused_ms: float):
    """Phase 20: (a)-(c). Returns the launches by path and the report."""
    import tempfile

    t0 = time.perf_counter()
    counts, report = {}, {"card": card}
    t = time.perf_counter()
    got, report["mesh_one"] = phase_mesh_one(device, card, run_kernel, log_k,
                                             fused_ms)
    counts.update(got)
    report["mesh_one"]["phase_s"] = time.perf_counter() - t
    print("phase 20 (a) world size 1 " + json.dumps(report["mesh_one"]),
          flush=True)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got, report["two_ranks"] = phase_two_ranks(device, tmp)
    counts.update(got)
    report["two_ranks"]["phase_s"] = time.perf_counter() - t
    print("phase 20 (b) two ranks " + json.dumps(report["two_ranks"]),
          flush=True)
    t = time.perf_counter()
    report["eigenfunctions"] = phase_eigenfunctions(
        run_kernel.pipe, carry_k.model, run_kernel.pipe.config.data.h)
    report["eigenfunctions"]["phase_s"] = time.perf_counter() - t
    print("phase 20 (c) eigenfunction_grid "
          + json.dumps(report["eigenfunctions"]), flush=True)
    report["phase_s"] = time.perf_counter() - t0
    return counts, report


def tool_module(name: str):
    """``tools/<name>.py`` as a module."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    return importlib.import_module(name)


def quietly(fn, *args):
    """``fn(*args)`` with its standard output captured (the tools print
    their JSON lines; this script prints its own)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def check_bench_line(out: dict, name: str, launches: int):
    """A bench record: value = batch x steps / best wall (rounded to 0.1 as
    bench.py rounds it), ``launches`` box-ADMM launches, finite."""
    d = out["detail"]
    want = round(d["batch"] * d["steps"] / d["wall_s"], 1)
    if out["value"] != want or not math.isfinite(out["value"]):
        fail(f"{name}: value {out['value']} against batch x steps / wall "
             f"{want}")
    if d["box_admm_launches"] != launches:
        fail(f"{name}: {d['box_admm_launches']} launches, want {launches}")
    if "vs_baseline" in out:
        fail(f"{name}: a vs_baseline against the TPU baseline")


def within_quality(got, ref, name: str):
    """(MSE, steady-state error) within QUALITY_RTOL of ``ref``."""
    for a, b, what in ((got[0], ref[0], "tracking MSE"),
                       (got[1], ref[1], "steady-state error")):
        if not (math.isfinite(a)
                and abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9)):
            fail(f"{name}: {what} {a} against {b}")


def phase_bench(card: str, run_kernel, log_k, serving):
    """Phase 21: the bench, the serving tool and the validation tool.
    ``run_kernel`` and ``log_k`` are phase 3's loop and log, ``serving``
    phase 16's report. Returns the launch counts by path and the phase's
    report."""
    import gc

    import torch
    from koopmanx_torch import bench

    t0 = time.perf_counter()
    report, counts = {"card": card}, {}
    # (a) the module alone, at its defaults, in a process of its own
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "koopmanx_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"python -m koopmanx_torch.bench: exit {proc.returncode}, "
             f"{len(lines)} lines; {proc.stderr[-2000:]}")
    head = json.loads(lines[0])
    d = head["detail"]
    check_bench_line(head, "bench (a)", d["reps"] * STEPS)
    if (d["batch"], d["steps"], d["reps"], d["qp_backend"]) != (
            BATCH, STEPS, 3, "pallas"):
        fail(f"bench (a): not the defaults: {d}")
    got = (d["tracking_mse"], d["steady_state_error"])
    # phase 3's log through the bench's own measure (float64 sums)
    ref = bench.tracking_quality(run_kernel.pipe.config, log_k)
    within_quality(got, ref, "bench (a) against phase 3")
    report["a"] = {"line": head, "phase3_quality": list(ref),
                   "gap_to_phase3": [got[0] - ref[0], got[1] - ref[1]]}
    counts["bench flagship, 3 timed runs (phase 21)"] = d["box_admm_launches"]
    print("phase 21 (a) bench " + json.dumps(report["a"]), flush=True)

    # (b) the plain route, in this process
    plain = bench.run_bench({"BENCH_QP_BACKEND": "xla", "BENCH_REPS": "1"})
    check_bench_line(plain, "bench (b)", 0)
    within_quality((plain["detail"]["tracking_mse"],
                    plain["detail"]["steady_state_error"]), got,
                   "bench (b) plain against (a)")
    report["b"] = {
        "ms_per_step_kernel_route": d["per_step_latency_ms"],
        "ms_per_step_plain_route": plain["detail"]["per_step_latency_ms"],
        "value_plain": plain["value"], "value_kernel": head["value"],
        "quality_plain": [plain["detail"]["tracking_mse"],
                          plain["detail"]["steady_state_error"]]}
    counts["bench flagship, plain route (phase 21)"] = (
        plain["detail"]["box_admm_launches"])
    print("phase 21 (b) plain route " + json.dumps(report["b"]), flush=True)

    # (c) the JAX bench's other presets
    report["c"] = {}
    for preset in BENCH_OTHER:
        out = bench.run_bench({"BENCH_PRESET": preset, "BENCH_REPS": "1",
                               "BENCH_STEPS": str(BENCH_OTHER_STEPS)})
        check_bench_line(out, f"bench (c) {preset}", BENCH_OTHER_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        keep = ("wall_s", "per_step_latency_ms", "box_admm_launches",
                "tracking_mse", "steady_state_error")
        report["c"][preset] = {"value": out["value"],
                               **{k: out["detail"][k] for k in keep}}
        counts[f"bench {preset}, {BENCH_OTHER_STEPS} steps (phase 21)"] = (
            out["detail"]["box_admm_launches"])
        print(f"phase 21 (c) {preset} " + json.dumps(report["c"][preset]),
              flush=True)

    # (d) the serving tool: the fleet table, then the curve
    serving_tool = tool_module("bench_serving_torch")
    rows = quietly(serving_tool.main, SERVING_ARGV)
    for row in rows:
        if not all(math.isfinite(row[k])
                   for k in ("best_ms", "mean_ms", "p50_ms")):
            fail(f"serving tool: non-finite latency {row}")
        if row["box_admm_launches"] != row["calls"]:
            fail(f"serving tool: {row['box_admm_launches']} launches in "
                 f"{row['calls']} calls ({row['metric']})")
        counts[f"serving tool, {row['metric']} (phase 21)"] = (
            row["box_admm_launches"])
    curve = quietly(serving_tool.main, CURVE_ARGV)[-1]["curve"]
    ops = {row["variant"]: row["device_ops"] for row in curve}
    if not ops["full"] > ops["lean"] > ops["tiny_identity"]:
        fail(f"serving curve: device operations {ops}")
    if not all(math.isfinite(row["best_ms"]) for row in curve):
        fail(f"serving curve: non-finite latency {curve}")
    single, fleet = rows[0], rows[-1]
    report["d"] = {
        "single_p50_ms": single["p50_ms"],
        "phase16_single_p50_ms": serving["latency_single_pallas"]["p50_ms"],
        "fleet_p50_ms": fleet["p50_ms"],
        "phase16_fleet_p50_ms": serving["latency_fleet_pallas"]["p50_ms"],
        "dispatch_baseline_ms": single["dispatch_baseline_ms"],
        "rows": rows, "curve": curve}
    print("phase 21 (d) serving tool " + json.dumps(report["d"]), flush=True)

    # (e) the validation tool at the VDP closed loop's reference length
    from koopmanx_torch import configs as C

    steps = int(VALIDATE_ENV["STEPS"])
    val = quietly(tool_module("validate_scale_torch").main, VALIDATE_ENV)
    u_max = C.PRESETS[VALIDATE_ENV["PRESET"]]().mpc.u_max
    if not val["finite"] or not val["u_abs_max"] <= u_max:
        fail(f"validate_scale_torch: finite {val['finite']}, |u| "
             f"{val['u_abs_max']} against {u_max}")
    if val["box_admm_launches"] != steps:
        fail(f"validate_scale_torch: {val['box_admm_launches']} launches in "
             f"{steps} steps")
    report["e"] = val
    counts[f"validate_scale {VALIDATE_ENV['PRESET']} {steps} steps "
           "(phase 21)"] = val["box_admm_launches"]
    print("phase 21 (e) validate_scale " + json.dumps(val), flush=True)
    report["phase_s"] = time.perf_counter() - t0
    return counts, report


def settled_cost_grad(pipe, batch, log_r: float = 0.0, grad: bool = True,
                      remat: bool = False, per_scenario: bool = False):
    """The batch-mean settled tracking cost of the flagship's tune (x1
    against r1 over the second half of the run) with ``r_block`` scaled by
    a shared ``exp(log_r)``, and its derivative in ``log_r`` (None without
    ``grad``: the loop then records no graph), through the user entry
    points; ``remat`` checkpoints each step. ``per_scenario`` gives each
    scenario its own log r (all ``log_r``): the derivative is then the
    (B,) vector of B times each scenario's part, whose mean is the shared
    derivative."""
    import torch
    from koopmanx_torch.engine.loop import run_batch
    from koopmanx_torch.run import replicate, with_engine_config

    if remat:
        pipe = with_engine_config(pipe, remat=True)
    b, x0 = batch.x0.shape[0], batch.x0
    lr = torch.full((b,) if per_scenario else (), log_r, dtype=x0.dtype,
                    device=x0.device, requires_grad=grad)
    params = replicate(pipe.params, b)
    scale = torch.exp(lr)[..., None, None] if per_scenario else torch.exp(lr)
    params = params._replace(r_block=scale * params.r_block)
    _, log = run_batch(pipe.closed_loop, params, x0,
                       replicate(pipe.model0, b), replicate(pipe.rls0, b),
                       batch.theta0, batch.theta1)
    err = log.x[..., 0] - log.r[..., 0]
    cost = (err[:, pipe.engine_cfg.steps // 2:] ** 2).mean()
    if not grad:
        return float(cost), None
    (g,) = torch.autograd.grad(cost, lr)
    return float(cost.detach()), (g * b if per_scenario else float(g))


def grad_run(pipe, batch, remat: bool, per_scenario: bool = False):
    """``(cost, grad, seconds, peak GiB)`` of one value-and-grad over
    ``pipe`` and ``batch``, the peak device memory from a reset just
    before."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (cost, g), secs = timed(lambda: settled_cost_grad(
        pipe, batch, remat=remat, per_scenario=per_scenario))
    return cost, g, secs, torch.cuda.max_memory_allocated() / 2**30


def spread_report(g):
    """The shared derivative (the mean) of per-scenario ones and their
    spread: quantiles of |g_b|, and how many pass 1."""
    import torch

    a = g.abs().double()
    q = torch.quantile(a, torch.tensor([0.5, 0.9, 0.99, 1.0],
                                       dtype=a.dtype, device=a.device))
    return {"shared": float(g.double().mean()),
            "abs_p50_p90_p99_max": [float(v) for v in q],
            "count_abs_above_1": int((a > 1.0).sum()),
            "finite": bool(torch.isfinite(g).all())}


def phase_grad_full_width(device):
    """Phase 22 (a): the flagship on the plain route (B = BATCH, STEPS,
    f32) under remat, forward alone and forward + backward, its peak and
    device operations a step; then GRAD_SMALL_BATCH x GRAD_SMALL_STEPS
    with and without remat, per-scenario log r."""
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.run import with_engine_config

    run = config_loop(flagship_config(STEPS, HORIZON, "xla"), device)
    _, fwd_s = timed(lambda: settled_cost_grad(run.pipe, run.batch,
                                               grad=False))
    cost, g, secs, peak = grad_run(run.pipe, run.batch, remat=True)
    short = with_engine_config(run.pipe, steps=GRAD_OPS_STEPS)
    ops = device_ops_per_call(lambda: settled_cost_grad(
        short, run.batch, remat=True), calls=1) / GRAD_OPS_STEPS
    report = {"batch": BATCH, "steps": STEPS, "remat": True,
              "cost": cost, "grad": g, "forward_ms": fwd_s * 1e3,
              "value_and_grad_ms": secs * 1e3,
              "value_and_grad_over_forward": secs / fwd_s,
              "peak_gib": peak, "device_ops_per_step": ops}
    if not (math.isfinite(g) and g != 0.0 and math.isfinite(cost)):
        fail(f"full-width gradient {g} (cost {cost})")
    small = config_loop(flagship_config(GRAD_SMALL_STEPS, HORIZON, "xla"),
                        device, batch=GRAD_SMALL_BATCH)
    report["small"] = {"batch": GRAD_SMALL_BATCH, "steps": GRAD_SMALL_STEPS}
    for remat in (True, False):
        c, gs, t, pk = grad_run(small.pipe, small.batch, remat,
                                per_scenario=True)
        spread = spread_report(gs)
        report["small"]["remat" if remat else "stored"] = {
            "cost": c, "grad": spread, "value_and_grad_ms": t * 1e3,
            "peak_gib": pk}
        if not (spread["finite"] and spread["shared"] != 0.0):
            fail(f"gradient at B = {GRAD_SMALL_BATCH}, remat {remat}: "
                 f"{spread}")
    print("phase 22 (a) full-width gradient " + json.dumps(report),
          flush=True)
    return report


def phase_grad_f64(device):
    """Phase 22 (b): float64 at GRAD_F64_BATCH scenarios over each of
    GRAD_F64_STEPS, one pipeline built on the CPU and moved to the card:
    the card's gradient against the CPU's, remat against the stored
    graph, both against a central difference where the gradient is well
    conditioned."""
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy
    from koopmanx_torch.tree import tree_map

    up = lambda t: torch.nextafter(t, torch.full_like(t, math.inf))
    rel = lambda a, b: abs(a - b) / abs(b)
    reports, fd_gated = {}, 0
    for steps in GRAD_F64_STEPS:
        cfg = flagship_config(steps, HORIZON, "xla")
        cpu = config_loop(cfg, "cpu", "float64", batch=GRAD_F64_BATCH)
        pipe = pipeline_from_numpy(pipeline_to_numpy(cpu.pipe), cfg,
                                   device=device, dtype=torch.float64)
        batch = tree_map(lambda t: t.to(device), cpu.batch)
        c_cpu, g_cpu = settled_cost_grad(cpu.pipe, cpu.batch)
        _, g = settled_cost_grad(pipe, batch)
        # the CPU's own floor: every x0, the initial model's A, or r
        # (exp(log r) = 1 + eps) moved up by one ulp
        nudged = {
            "x0": lambda: settled_cost_grad(cpu.pipe, cpu.batch._replace(
                x0=up(cpu.batch.x0))),
            "A": lambda: settled_cost_grad(cpu.pipe._replace(
                model0=cpu.pipe.model0._replace(A=up(cpu.pipe.model0.A))),
                cpu.batch),
            "r": lambda: settled_cost_grad(cpu.pipe, cpu.batch, log_r=float(
                torch.finfo(torch.float64).eps))}
        nudged = {name: realize() for name, realize in nudged.items()}
        floor = max(abs(gn - g_cpu) for _, gn in nudged.values())
        cost_floor = max(abs(cn - c_cpu) for cn, _ in nudged.values())
        tol = max(GRAD_F64_RTOL * abs(g_cpu), 10.0 * floor)
        _, g_remat = settled_cost_grad(pipe, batch, remat=True)
        c_hi, _ = settled_cost_grad(pipe, batch, FD_STEP, grad=False)
        c_lo, _ = settled_cost_grad(pipe, batch, -FD_STEP, grad=False)
        fd = (c_hi - c_lo) / (2.0 * FD_STEP)
        # a central difference resolves no better than the cost's own
        # round-off over the step
        fd_tol = max(FD_RTOL * abs(g), 10.0 * cost_floor / FD_STEP)
        conditioned = floor <= FD_COND * abs(g_cpu)
        report = {"batch": GRAD_F64_BATCH, "steps": steps, "cost": c_cpu,
                  "grad_card": g, "grad_card_remat": g_remat,
                  "grad_cpu": g_cpu, "card_vs_cpu_rel": rel(g, g_cpu),
                  "tol_rel": tol / abs(g_cpu),
                  "cpu_floor_rel": {k: rel(gn, g_cpu)
                                    for k, (_, gn) in nudged.items()},
                  "remat_vs_stored_rel": rel(g_remat, g),
                  "central_difference": fd, "fd_rel": rel(fd, g),
                  "fd_tol_rel": fd_tol / abs(g), "fd_gated": conditioned}
        reports[str(steps)] = report
        print("phase 22 (b) f64 gradient " + json.dumps(report), flush=True)
        if not (math.isfinite(g) and g != 0.0 and abs(g - g_cpu) <= tol):
            fail(f"f64 gradient at {steps} steps: card {g} against the "
                 f"CPU's {g_cpu} (tol {tol})")
        if not abs(g_remat - g) <= GRAD_REMAT_RTOL * abs(g):
            fail(f"f64 gradient at {steps} steps: remat {g_remat} "
                 f"against {g}")
        if conditioned:
            fd_gated += 1
            for name, v in (("stored", g), ("remat", g_remat)):
                if not abs(fd - v) <= fd_tol:
                    fail(f"f64 gradient ({name}) at {steps} steps: {v} "
                         f"against the central difference {fd} (tol "
                         f"{fd_tol})")
    if not fd_gated:
        fail("no f64 gradient was well conditioned enough for the "
             "central-difference gate")
    return reports


def example_module(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_tune(device):
    """Phase 22 (c): TUNE_ITERS Adam steps of
    ``tune_weights_torch.tune`` on the card at TUNE_STEPS."""
    tune_mod = example_module("tune_weights_torch")
    cfg = tune_mod.tune_config(TUNE_STEPS)
    trajectory = tune_mod.tune(cfg, TUNE_ITERS, device=device)
    for rec in trajectory:
        print(f"phase 22 (c) tune step {rec['iter']}: r={rec['r']:.6e} "
              f"cost={rec['cost']:.6e} grad={rec['grad']:+.6e} "
              f"{rec['ms']:.1f} ms", flush=True)
        if not all(math.isfinite(rec[k]) for k in ("r", "cost", "grad")):
            fail(f"tune step {rec['iter']}: {rec}")
    return {"steps": TUNE_STEPS, "trajectory": trajectory}


def phase_kernel_refuses(device):
    """Phase 22 (d): a flagship loop on the kernel route given a log r
    that requires grad raises ValueError, and B1 never launched."""
    from koopmanx_torch.configs import flagship_config

    run = config_loop(flagship_config(STEPS, HORIZON, "pallas"), device)
    zero_counts()
    try:
        settled_cost_grad(run.pipe, run.batch)
    except ValueError as err:
        message = str(err)
    else:
        fail("the kernel route returned under autograd")
    counts = read_counts()
    if counts["box_admm"] != 0:
        fail(f"the refused kernel route launched {counts}")
    report = {"raised": "ValueError", "message": message, "launches": counts}
    print("phase 22 (d) kernel route " + json.dumps(report), flush=True)
    return report


EXAMPLES = {
    "duffing_comparison": ("duffing_comparison_torch", "compare", 1200, {
        "off": ("koopman", {"mode": "off"}),
        "rls_sqrt": ("koopman", {"mode": "rls_sqrt"})}),
    "local_linear_comparison": ("local_linear_comparison_torch", "compare",
                                800, {"koopman": ("koopman", {}),
                                      "local_linear": ("local_linear", {})}),
    "tank_delta_u": ("tank_delta_u_torch", "run", 1200, {
        "loop": ("koopman", {})})}


def example_loop_f64(module, kind: str, changes: dict, backend: str, device):
    """One loop of an example in float64 through its own ``config`` on
    ``backend``: a batch of EXAMPLE_ROWS scenarios, x_init and the initial
    model's A as the example has them in row 0, x_init moved one ulp up and
    down in rows 1-2, A in rows 3-4 (the local-linear loop has no A).
    Returns its log (EXAMPLE_ROWS, T, ...)."""
    import torch
    from koopmanx_torch.engine.local_linear import run_local_linear_batch
    from koopmanx_torch.engine.loop import run_batch
    from koopmanx_torch.run import build_local_linear, build_pipeline, replicate

    def rows(t, at):
        out = [t] * EXAMPLE_ROWS
        for i, target in zip(at, (9.0, -9.0)):
            out[i] = torch.nextafter(t, torch.full_like(t, target))
        return torch.stack(out)

    cfg = module.config(qp_backend=backend, **changes)
    cfg.dtype = "float64"
    pipe = build_pipeline(cfg, device=device)
    x0 = rows(pipe.x_init, (1, 2))
    if kind == "local_linear":
        loop, params = build_local_linear(cfg, device=device)
        return run_local_linear_batch(loop, replicate(params, EXAMPLE_ROWS),
                                      x0)[1]
    model0 = replicate(pipe.model0, EXAMPLE_ROWS)
    model0 = model0._replace(A=rows(pipe.model0.A, (3, 4)))
    return run_batch(pipe.closed_loop, replicate(pipe.params, EXAMPLE_ROWS),
                     x0, model0, replicate(pipe.rls0, EXAMPLE_ROWS))[1]


def example_f64_gate(name: str, device):
    """Phase 22 (e), float64: each loop of example ``name`` on the kernel
    route against the plain route (:func:`example_loop_f64`, scenario 0),
    each step within EARLY_TOL or ten times the plain route's own round-off
    floor up to that step (rows 1-4 and the plain ADMM with its sums
    reassociated: phase 15's rule), and its tracking MSE and steady-state
    error within QUALITY_RTOL of the plain route's or ten times the same
    realizations' change of that metric, where that is larger. Returns the
    report."""
    import torch
    from koopmanx_torch.control import qp

    module_name, _, _, loops = EXAMPLES[name]
    module = example_module(module_name)
    row = lambda log, i=0: type(log)(*(t[i] for t in log))
    real = qp.box_admm
    report = {}
    for loop, (kind, changes) in loops.items():
        logs = {}
        try:
            for label, backend, solver in (
                    ("kernel", "pallas", real),
                    ("reassociated", "pallas", box_admm_reassociated),
                    ("plain", "xla", real)):
                qp.box_admm = solver
                (logs[label], secs) = timed(lambda: example_loop_f64(
                    module, kind, changes, backend, device))
                logs[label + "_s"] = secs
        finally:
            qp.box_admm = real
        plain = logs["plain"].x
        diff = lambda x: (x - plain[0]).abs().amax(-1)  # (T,)
        floors = {"x0 +": diff(plain[1]), "x0 -": diff(plain[2]),
                  "A0 +": diff(plain[3]), "A0 -": diff(plain[4]),
                  "reassociated": diff(logs["reassociated"].x[0])}
        floor = torch.stack(list(floors.values())).amax(0).cummax(0).values
        bound = torch.clamp(10.0 * floor, min=EARLY_TOL)
        dx = diff(logs["kernel"].x[0])
        got, ref = (module.loop_metrics(row(logs[k]))
                    for k in ("kernel", "plain"))
        realized = [module.loop_metrics(row(logs["plain"], i))
                    for i in range(1, EXAMPLE_ROWS)]
        realized.append(module.loop_metrics(row(logs["reassociated"])))
        quality = {}
        for key, what in (("mse", "tracking MSE"),
                          ("sse", "steady-state error")):
            metric_floor = max(abs(m[key] - ref[key]) for m in realized)
            quality[key] = {
                "gap": abs(got[key] - ref[key]), "floor": metric_floor,
                "tol": max(QUALITY_RTOL[what] * max(abs(ref[key]), 1e-9),
                           10.0 * metric_floor)}
        out = {"steps": dx.numel(), "dx_f64": float(dx.max()),
               "floor_f64": float(floor.max()), "tol": EARLY_TOL,
               "floor_f64_by_realization": {k: float(v.max())
                                            for k, v in floors.items()},
               "share_held_at_tol": float((bound == EARLY_TOL)
                                          .double().mean()),
               "steps_held_at_tol": int((bound == EARLY_TOL).sum()),
               "worst_ratio_to_bound": float((dx / bound).max()),
               "kernel_metrics": got, "plain_metrics": ref,
               "quality": quality,
               "s": {k: logs[k + "_s"]
                     for k in ("kernel", "reassociated", "plain")}}
        report[loop] = out
        finite = all(math.isfinite(v) for v in [*got.values(),
                                                *ref.values()])
        if not (finite and bool(torch.isfinite(logs["kernel"].x).all())):
            fail(f"{name} {loop} float64: not finite ({out})")
        if not bool((dx <= bound).all()):
            fail(f"{name} {loop}: float64 kernel and plain loops differ by "
                 f"more than max({EARLY_TOL}, 10 x the round-off floor): "
                 f"{out}")
        for key, q in quality.items():
            if not q["gap"] <= q["tol"]:
                fail(f"{name} {loop} float64: {key} {got[key]} against the "
                     f"plain route's {ref[key]} ({q})")
    print(f"phase 22 (e) {name} float64 routes " + json.dumps(report),
          flush=True)
    return report


def example_kernel_routes(device):
    """Phase 22 (e), float32: each comparison example's compute function
    as a user calls it on the card (the kernel route) at its default
    steps, one launch a step (counted from 0 around each run), its metrics
    finite."""
    out = {}
    for name, (module, fn_name, launches, _) in EXAMPLES.items():
        fn = getattr(example_module(module), fn_name)
        zero_counts()
        result, secs = timed(lambda: fn(device=device))
        got = read_counts()
        if got != {"box_admm": launches, "fused_qp": 0, "fused_qp_soa": 0}:
            fail(f"{name} launched {got}, want {launches}")
        metrics = result["metrics"]
        metrics = metrics if "mse" not in metrics else {"loop": metrics}
        if not all(math.isfinite(v) for m in metrics.values()
                   for v in m.values()):
            fail(f"{name}: {metrics}")
        out[name] = {"s": secs, "launches": launches, "metrics": metrics}
        print(f"phase 22 (e) {name} " + json.dumps(out[name]), flush=True)
    return out


def phase22_part(part: str, out_path: str) -> int:
    """One part of phase 22 in a process of its own, which the script
    starts beside its own work (``--phase22-part``): 'b'
    (``phase_grad_f64``, its CPU gradients on PART_B_THREADS threads) or
    the name of a comparison example (its ``example_f64_gate``); writes
    the report to ``out_path`` as JSON."""
    import torch
    from koopmanx_torch.device import resolve_device

    device = resolve_device(None)
    if part == "b":
        torch.set_num_threads(PART_B_THREADS)
        result = phase_grad_f64(device)
    else:
        torch.set_num_threads(1)
        result = example_f64_gate(part, device)
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def phase_gradients(device, card: str):
    """Phase 22: gradients through the closed loop and the examples. (a)
    runs alone, for its times; then (b) and (e)'s float64 gates (one
    process for each example) run in processes of their own beside (c),
    (d) and (e)'s float32 runs here (the steps are host-bound: each
    process keeps a core busy)."""
    import tempfile

    t0 = time.perf_counter()
    zero_counts()
    report = {"a": phase_grad_full_width(device)}
    parts = ["b", *EXAMPLES]
    with tempfile.TemporaryDirectory() as tmp:
        outs = {p: os.path.join(tmp, f"part_{p}.json") for p in parts}
        logs = {p: open(os.path.join(tmp, f"part_{p}.log"), "w+")
                for p in parts}
        procs = {p: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase22-part",
             p, outs[p]], stdout=logs[p], stderr=subprocess.STDOUT)
            for p in parts}
        try:
            report["c"] = phase_tune(device)
            plain = read_counts()
            if plain["box_admm"] != 0:
                fail(f"the plain-route gradients launched {plain}")
            report["d"] = phase_kernel_refuses(device)
            kernel = example_kernel_routes(device)
            for p in procs.values():
                p.wait(timeout=PART_TIMEOUT)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = {}
        for p, proc in procs.items():
            logs[p].seek(0)
            text = logs[p].read()
            logs[p].close()
            sys.stdout.write(text)
            if proc.returncode != 0:
                fail(f"phase 22 part ({p}) exited {proc.returncode}")
            with open(outs[p]) as f:
                results[p] = json.load(f)
    report["b"] = results["b"]
    report["e"] = {name: {"kernel_route_f32": k,
                          "routes_f64": results[name]}
                   for name, k in kernel.items()}
    counts = {f"{name} example (phase 22)": k["launches"]
              for name, k in kernel.items()}
    counts["gradients and tune_weights example, plain route (phase 22)"] = (
        plain["box_admm"])
    report["phase_s"] = time.perf_counter() - t0
    report["card"] = card
    return counts, report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent-fused-qp", metavar="LIB",
                        help="libfused_qp.so of another checkout, held "
                             "against this one's (not gated)")
    parser.add_argument("--two-rank-worker", nargs=3,
                        metavar=("RANK", "PORT", "OUT"),
                        help="run one rank of phase 20 (b) (the script "
                             "starts both itself)")
    parser.add_argument("--phase22-part", nargs=2, metavar=("PART", "OUT"),
                        help="run part b of phase 22 or the float64 gate "
                             "of the comparison example PART (the script "
                             "starts them itself)")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "koopmanx_torch")):
        print("chip_smoke: koopmanx_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    if opts.two_rank_worker:
        rank, port, out = opts.two_rank_worker
        return two_rank_worker(int(rank), int(port), out)
    if opts.phase22_part:
        return phase22_part(*opts.phase22_part)
    from koopmanx_torch.device import resolve_device
    import threading

    from koopmanx_torch.ops import build, native
    from koopmanx_torch.ops.box_admm import box_admm

    device = resolve_device(None)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build: the CUDA kernels, and the native plant beside them ----
    t_start = t0 = time.perf_counter()
    native_s = []
    native_build = threading.Thread(target=lambda: (
        native.load(), native_s.append(time.perf_counter() - t0)))
    native_build.start()
    reports = build.build_all()
    native_build.join()
    native.load()  # raises NativeUnavailable where the thread's build failed
    build_s = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if any(k in line.lower() for k in ("compiling entry", "registers",
                                                "spill", "error")):
                print(f"nvcc {name}: {line.strip()}", flush=True)
    print(f"phase 1 build: {sorted(reports)} in {build_s:.1f} s; the native "
          f"plant {os.path.relpath(str(native.LIB_PATH), ROOT)} in "
          f"{native_s[0]:.1f} s", flush=True)
    for name in ("fused_qp", "fused_qp_soa"):
        for kernel, stack, spill_st, spill_ld in ptxas_stack_and_spills(
                reports.get(name, "")):
            if stack or spill_st or spill_ld:
                fail(f"ptxas gives {kernel} {stack} bytes of stack, "
                     f"{spill_st}/{spill_ld} bytes of spill stores/loads")
    card = card_line()

    # ---- 2. kernels vs plain versions ----
    t2 = time.perf_counter()
    entry = phase_kernel_checks(
        device, ptxas_registers(reports.get("box_admm", "")))
    fused_entries = phase_fused_checks(
        device, {name: ptxas_registers(reports.get(name, ""))
                 for name in ("fused_qp", "fused_qp_soa")},
        parent_lib=opts.parent_fused_qp)
    print(f"phase 2: {time.perf_counter() - t2:.1f} s", flush=True)
    t3 = time.perf_counter()

    # ---- 3. the main path through the kernel ----
    run_kernel = run_loop("pallas", device)
    zero_counts()
    (carry_k, log_k), cold_k = timed(run_kernel)
    counts = read_counts()
    launches = counts["box_admm"]
    entry["launches"] = launches
    print(f"phase 3 main path (pallas): {cold_k:.2f} s cold, launches "
          f"{counts}", flush=True)
    if launches != STEPS:
        fail(f"box_admm launched {launches} times in {STEPS} steps")
    check_loop(carry_k, log_k, "pallas")

    # ---- 4. the plain route, and the gate between the two ----
    run_plain = run_loop("xla", device)
    box_admm.launches = 0
    (carry_p, log_p), cold_p = timed(run_plain)
    if box_admm.launches != 0:
        fail("the plain route launched the kernel")
    check_loop(carry_p, log_p, "xla")
    early = {}
    for backend in ("pallas", "xla"):
        carry, log = run_loop(backend, device, LOOP_EARLY_STEPS, "float64")()
        check_loop(carry, log, f"{backend} float64", LOOP_EARLY_STEPS)
        early[backend] = log.x
    dx64 = float((early["pallas"] - early["xla"]).abs().max())
    _, log_n = run_loop("xla", device, nudge=True)()  # the float32 floor
    early_dx = lambda a, b: (a.x[:, :LOOP_EARLY_STEPS]
                             - b.x[:, :LOOP_EARLY_STEPS]).abs().amax((1, 2))
    dx32, dx_floor = early_dx(log_k, log_p), early_dx(log_n, log_p)
    (mse_k, sse_k), (mse_p, sse_p) = quality(log_k), quality(log_p)
    mse_n, sse_n = quality(log_n)
    gate = {"dx_first16_f64": dx64, "dx_first16_f64_tol": LOOP_EARLY_TOL,
            "dx_first16_f32": float(dx32.max()),
            "share_within_1e-4_f32": float((dx32 <= 1e-4).float().mean()),
            "dx_all_steps_f32": float((log_k.x - log_p.x).abs().max()),
            "mse_kernel": mse_k, "mse_plain": mse_p,
            "sse_kernel": sse_k, "sse_plain": sse_p,
            "quality_rtol": QUALITY_RTOL,
            "floor_one_ulp_x0_f32": {
                "dx_first16": float(dx_floor.max()),
                "share_within_1e-4": float((dx_floor <= 1e-4).float().mean()),
                "mse": mse_n, "sse": sse_n}}
    print("phase 4 gate " + json.dumps(gate), flush=True)
    if not dx64 <= LOOP_EARLY_TOL:
        fail(f"float64 kernel and plain loops differ by {dx64} in the first "
             f"{LOOP_EARLY_STEPS} steps")
    for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                       (sse_k, sse_p, "steady-state error")):
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"{what}: kernel {a} vs plain {b}")

    print(f"phases 3-4: {time.perf_counter() - t3:.1f} s", flush=True)
    flagship = (log_k, log_p, log_n, cold_p)

    # ---- 5. warm timing, in turns: plain, kernel, kernel, plain ----
    t5 = time.perf_counter()
    walls = {run_plain: [], run_kernel: []}
    for fn in (run_plain, run_kernel, run_kernel, run_plain):
        walls[fn].append(timed(fn)[1])
    wall_k = sum(walls[run_kernel]) / 2
    wall_p = sum(walls[run_plain]) / 2
    solves = BATCH * STEPS
    slice_line = {
        "slice": "duffing flagship loop, koopmanx_torch",
        "batch": BATCH, "steps": STEPS, "horizon": HORIZON,
        "dtype": "float32",
        "kernel_route": {"wall_s": wall_k, "runs_s": walls[run_kernel],
                         "solves_per_s": solves / wall_k,
                         "ms_per_step": wall_k / STEPS * 1e3,
                         "box_admm_share": entry["ms"] * STEPS / (wall_k * 1e3),
                         "cold_wall_s": cold_k},
        "plain_route": {"wall_s": wall_p, "runs_s": walls[run_plain],
                        "solves_per_s": solves / wall_p,
                        "ms_per_step": wall_p / STEPS * 1e3,
                        "cold_wall_s": cold_p},
        "build_s": build_s,
        "card": card,
    }
    print(json.dumps(slice_line), flush=True)

    # ---- 6. the fused path on the flagship loop's own models ----
    with torch.inference_mode():
        counts = phase_fused_path(run_kernel.pipe, carry_k, device)
        phase_convergence(device)
    for name, fused in fused_entries.items():
        fused["launches"] = counts[name]
    print(f"phases 5-6: {time.perf_counter() - t5:.1f} s", flush=True)

    # ---- 7. the tank path; 8. the shipped duffing preset ----
    t7 = time.perf_counter()
    tank_counts = phase_tank(device, card)
    print(f"phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
    t8 = time.perf_counter()
    preset_counts, log8, run8 = phase_duffing_preset(device, (mse_k, sse_k))
    print(f"phase 8: {time.perf_counter() - t8:.1f} s", flush=True)

    # ---- 9. the large-lift path; 10. duffing_rff and the bf16 ring ----
    t9 = time.perf_counter()
    rbf_counts, rbf_report = phase_rbf128(device, card)
    rff_counts, bf16_counts = phase_rff_and_bf16(device, rbf_report)
    print(f"phases 9-10: {time.perf_counter() - t9:.1f} s", flush=True)

    # ---- 11. tank_mimo (B1 at nx = 40); 12. the general-inequality path ----
    t11 = time.perf_counter()
    mimo_counts = phase_tank_mimo(device, card)
    phase_general(device, card)
    print(f"phases 11-12: {time.perf_counter() - t11:.1f} s", flush=True)

    # ---- 13. the VDP lifted-tracking path; 14. the other estimators ----
    t13 = time.perf_counter()
    vdp_counts = phase_vdp(device, card)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    t14 = time.perf_counter()
    estimator_counts = phase_estimators(device, card)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # ---- 15. the Revise_2 loops (per-step DARE terminal synthesis) ----
    t15 = time.perf_counter()
    revise2_counts = phase_revise2(device, card)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)

    # ---- 16. the serving API and the CLI ----
    t16 = time.perf_counter()
    serving_counts, serving = phase_serving(
        device, card, {"pallas": run_kernel, "xla": run_plain},
        (mse_k, sse_k), {"pallas": slice_line["kernel_route"]["ms_per_step"],
                         "xla": slice_line["plain_route"]["ms_per_step"]})
    print(json.dumps({"serving": {
        k: serving[k] for k in serving
        if k.startswith("latency") or k == "fused_loop_ms_per_step"},
        "card": card}), flush=True)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)

    # ---- 17. the other control laws: the LMI terminal, LQR, the
    # local-linearization baseline, the spectral drift, the shooting PGD
    t17 = time.perf_counter()
    lmi_counts, lmi = phase_lmi(device, card)
    lqr = phase_lqr(device, card)
    local_counts, local = phase_local_linear(device, card)
    drift = phase_spectral_drift(device, card)
    shooting = phase_shooting(device, card, run_kernel.pipe, carry_k)
    print(json.dumps({"control_laws": {
        "lmi": {k: lmi[k] for k in ("pallas", "xla", "early_f64", "step")},
        "lqr": lqr, "local_linear": local, "spectral_drift": drift,
        "shooting": shooting}, "card": card}), flush=True)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)

    # ---- 18. KMAE training, the trained encoder in the loop, L7 ----
    training_counts, training = phase_training(
        device, card, carry_k.model, (mse_k, sse_k))
    print(json.dumps({"training": training}), flush=True)
    print(f"phase 18: {training['phase_s']:.1f} s", flush=True)

    # ---- 19. the carried and bf16 KKT inverses, the .pkl lift, HIL ----
    l3_counts, l3 = phase_l3_pkl_hil(device, card, flagship, log8, run8)
    print(json.dumps({"l3_pkl_hil": {
        "bf16": {k: l3["bf16"][k] for k in (
            "pallas", "xla", "engine_test_loop", "f32_sse_x1_phase3",
            "step_kernel_route")},
        "carried": {k: l3["carried"][k] for k in (
            "anchors", "mse_x1", "sse_x1", "exact_mse_x1", "exact_sse_x1",
            "ms_per_step_cold", "step_tracked", "step_anchor",
            "step_exact_plain")},
        "hil": {k: v for k, v in l3["hil"].items() if k.startswith("HIL")},
        "card": card}}), flush=True)
    print(f"phase 19: {l3['phase_s']:.1f} s", flush=True)

    # ---- 20. several cards: the mesh at world size 1 (NCCL), two ranks
    # sharing the card (gloo), eigenfunction_grid on the card
    parallel_counts, parallel = phase_parallel(
        device, card, run_kernel, log_k, carry_k,
        slice_line["kernel_route"]["ms_per_step"])
    print(json.dumps({"parallel": {
        "world_size_1": {k: parallel["mesh_one"][k] for k in (
            "backend", "ms_per_step", "phase5_fused_loop_ms_per_step",
            "x_u_equal_phase3", "fit", "kmae_step")},
        "two_ranks": {k: parallel["two_ranks"][k] for k in (
            "dx_f64", "floor_f64", "bit_for_bit", "worst_ratio_to_bound")},
        "eigenfunction_grid": parallel["eigenfunctions"], "card": card}}),
        flush=True)
    print(f"phase 20: {parallel['phase_s']:.1f} s; phases 1-20: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 21. the measuring entry points: the bench, the serving and the
    # validation tools
    bench_counts, bench_report = phase_bench(card, run_kernel, log_k,
                                             serving)
    print(json.dumps({"bench": {
        "a": bench_report["a"]["line"], "b": bench_report["b"],
        "c": bench_report["c"],
        "d": {k: v for k, v in bench_report["d"].items() if k != "rows"},
        "e": bench_report["e"]}, "card": card}), flush=True)
    print(f"phase 21: {bench_report['phase_s']:.1f} s; phases 1-21: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 22. gradients through the closed loop; the four examples ----
    grad_counts, grad = phase_gradients(device, card)
    print(json.dumps({"gradients": {
        "a": {k: v for k, v in grad["a"].items() if k != "small"},
        "a_small": grad["a"]["small"], "b": grad["b"],
        "c": [{k: rec[k] for k in ("iter", "r", "cost", "grad", "ms")}
              for rec in grad["c"]["trajectory"]],
        "e": {name: {"kernel_route_s": v["kernel_route_f32"]["s"],
                     "launches": v["kernel_route_f32"]["launches"],
                     "f64": {loop: {k: r[k] for k in (
                         "dx_f64", "floor_f64", "steps_held_at_tol",
                         "worst_ratio_to_bound")}
                         for loop, r in v["routes_f64"].items()}}
              for name, v in grad["e"].items()}},
        "card": card}), flush=True)
    print(f"phase 22: {grad['phase_s']:.1f} s; phases 1-22: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    entry["launches_by_path"] = {
        "flagship (phase 3)": launches,
        "tank (phase 7)": tank_counts["box_admm"],
        "duffing preset (phase 8)": preset_counts["box_admm"],
        "rbf128 bench (phase 9)": rbf_counts["box_admm"],
        "duffing_rff preset (phase 10)": rff_counts["box_admm"],
        "rbf128 bench, bf16 ring (phase 10)": bf16_counts["box_admm"],
        "tank_mimo bench (phase 11)": mimo_counts["box_admm"],
        "vdp bench (phase 13)": vdp_counts["box_admm"],
        **{f"{name} (phase 14)": c["box_admm"]
           for name, c in estimator_counts.items()},
        **{f"{name} bench (phase 15)": c["box_admm"]
           for name, c in revise2_counts.items()},
        **serving_counts,
        "revise2_duffing, LMI terminal (phase 17)": lmi_counts["box_admm"],
        "LQR (phase 17)": lqr["launches"],
        "local-linear (phase 17)": local_counts["box_admm"],
        **training_counts,
        **l3_counts,
        **parallel_counts,
        **bench_counts,
        **grad_counts}
    print(json.dumps({"kernels": [entry, *fused_entries.values()]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
