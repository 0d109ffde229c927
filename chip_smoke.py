#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trajopt_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build the CUDA kernels from trajopt_torch/csrc (nvcc, sm_90a, in parallel);
3. hold each kernel K1-K4 against its plain PyTorch version on the same
   inputs (made with numpy from a fixed seed): float64 at a small shape with a
   batch that is not a multiple of 32 and saturated actions, and K1-K4 again
   at T=45, N=50 (neither a whole number of their 16-step chunks nor of
   their 16-instance groups), K1/K4 for both reg values, K2/K3 for 11 and 3
   α candidates (K2 takes 6 a block); K2/K3 in float32 bit for bit against
   their plain versions on the CPU, in a normal-range case and with
   numerators below 2^-100 (residue on the goal, where ChainOps' quotient
   hands the chunk to ExactChainOps'); float32 at the main path's shape
   (N=2048, T=1000), K1 on Cartpole v0 and v1;
4. the main path: make_ilqr_solver_batched on Cartpole-TO-v0, T=1000,
   N=2048, 10 iterations, backward="cuda-fused", rollout="cuda", float32, from
   the benchmark's x0; it must go through K1, K2 and K3, give finite returns
   no higher than the initial ones, and agree with the scan engines (plain
   PyTorch, no kernel) on the mean final return; then backward="cuda" (K4);
5. timings with CUDA events after a warm-up: ms per batch-iteration and
   instance-iterations/s of the main path; per kernel ms per launch (device
   time with launches queued back to back, and the time per call as
   call_ms), launches per iteration, the plain version's
   ms and the least time the card could take (bound) from this run's bytes
   and operations;
6. kernel K5 (the parallel-in-time backward) against its plain version:
   float64 at (T, dx, du) = (19, 3, 2), (130, 2, 1) and (2500, 4, 2) with
   λ ∈ {0, 0.6}; float32 on the SPD problem of tests/test_tpu.py at
   T ∈ {60, 333, 1000}, dx=4, du=2; a non-PD action Hessian (equal flags,
   finite outputs); float32 on the first backward inputs of the replan path
   (T=100) and of the MPC path (horizon 25);
7. the replan path: make_ilqr_solver on Pendulum-TO-v0, dt=0.05, T=100,
   3 iterations, float32, backward="cuda-pscan"; it must launch K5 at least
   twice in every iteration that works, improve on the initial return and
   land within 1e-4 of backward="pscan" (plain PyTorch);
8. the MPC path: make_mpc_runner on Pendulum-TO-v0 (examples/ilqr/mpc/
   pendulum.py: horizon 25, 100 control steps, 10 iterations), cuda-pscan,
   noise from a seeded generator; finite states, the pendulum upright at the
   end (|wrap(θ)| < 0.6), K5 launched; then the timings of the replan (three
   engines, and one cuda-pscan replan under torch.profiler: device busy time
   and host calls), of MPC control steps and of K5 at two shapes: its device
   time per launch (torch.profiler) and the wrapper's time per call;
9. kernels K6 and K7 (the GPS dual chain) against their plain versions:
   float64 at N=50, T=48 for (dx, du) = (2, 1) and (4, 2) with
   α ∈ {1e-16, 1, 1e16}; a non-PD −Quu (equal flags, finite outputs);
   float32 at the dual chain's benchmark shape (T=1000, N=4096, dx=4, du=2,
   α=10) and on the solver path's first dual operands; K6 and K7 there bit
   for bit (the first 64 instances, α ∈ {1e-16, 1, 1e16}, against their
   plain versions on the card; K6's c₀ and K7's KL sum within 1e-5);
10. the GPS solver path: make_mbgps_solver_batched on Pendulum-TO-v0,
   dt=0.05, T=100, N=4096, 10 iterations of 64 bisection steps, float32,
   engine="cuda"; exactly 640 launches each of K6 and K7, finite traces, no
   final return above its initial one, and the scan engine on the first 64
   instances for 2 iterations within rtol/atol 1e-4; ms per outer iteration
   and per dual evaluation, a torch.profiler split of one iteration, and
   K6's and K7's device time on each of that iteration's 64 launches
   (operands kept, launches replayed back to back);
11. the GPS-MPC farm: run_gps_mpc_batch (batched, engine="cuda") on
   Pendulum-TO-v0, 50 episodes, horizon 20, 25 steps, 3 iterations; finite
   costs, the first 4 episodes' first 2 steps against the scan engine on the
   same draws; control steps/s; then K6/K7's times at the solver path's and
   the benchmark's shapes;
12. kernel K8 (the belief-value backward) against its plain version:
   float64 at N=37, T=9 for (b, a) = (2, 2) and (4, 2), reg ∈ {1, 2}, λ
   alternating 0 and 3.7, instance 0 not positive definite (flags equal,
   non-finite places equal); float32 at bench.py:511's shape (LightDark's
   dims, T=25, N=4096) and on the batched solver's first backward operands,
   there also bit for bit on the first 64 instances for reg ∈ {1, 2}
   (against its plain version on the card);
13. the batched BSP solver: make_bsp_solver_batched on LightDark-TO-v0,
   T=25, N=4096, 10 iterations, engine="cuda": one K8 launch per λ trial the
   solver ran, finite
   traces, the scan engine on the first 64 instances within rtol/atol 1e-4;
   ms per outer iteration; K8's device time, bound and plain time, and its
   device time on each of the solve's own launches (operands kept,
   launches replayed back to back);
14. kernel K9 (a whole BSP-iLQR solve in one launch) against its plain
   version, float64 and float32, horizon 25, 10 iterations, for the default,
   reg=2 and goal weights mu_w=(-2, -2); then make_cuda_bsp_solve as a user
   calls it: one K9 launch, a decreasing trace, its device time and bound;
15. the light-dark MPC episode: K10 against its plain version and the scan
   runner on the same normals, float64, 3 steps; the scan runner's control
   steps/s over 3 steps (float32); bench.py:447's episode (horizon 25, 50
   steps, 10 iterations, float32) with engine="auto", which must resolve to
   K10, agree with K10's plain version on the same normals over all 50 steps
   and end with the belief mean within 0.1 of the goal; K10's control
   steps/s, device time, bound and plain time;
16. the eLQR kernels K11-K14 (the sweeps and the whole solve) against their
   plain versions: float64 at N=50, T=16 on the second iteration's operands
   of Cartpole v0 and v1 and on random operands, K14 over 3 iterations
   (1e-9); float32 K11-K13 on the streamed engine's first-iteration operands
   (N=1024, T=100); the main path, make_elqr_solver_batched on
   Cartpole-TO-v0 (bench.py:390-420: T=100, 10 iterations, engine="auto") at
   N=64 and N=1 (one K14 launch each) and N=1024 (K11 and K12 10 launches
   each, K13 12), finite; the timed float32 K14 solve held to its plain
   version over all 10 iterations; both kernel engines held to the scan
   engine in float64 on 8 instances over 2 iterations (trace rtol/atol
   1e-8) and to each other over 10; K14 in float32 where its division
   scales numerators below 2^-99 and where a sine argument past 105615
   sends its RK4 back to the library's operations, held to its plain
   version, and there the streamed engine held to the fused one bit for bit,
   as at the N=64 solve; ms per solve and instance-iterations/s
   at N=64, 1024 and 1, the scan engine's ms for one iteration at N=64, and
   each kernel's device time, bound and plain time, K11-K13's also on each
   launch of the N=1024 solve;
17. the robust-GPS kernels K15-K16 (the adversary's MatrixNormal sweep and
   the cubature-KL step) against their plain versions: float64 at dims 2/1
   (p = 8, N=3, T=5) and 4/2 (p = 28, N=8, T=16), each with a non-PD case
   (flags equal, non-finite entries in the same places; 1e-9); float32
   exactly (equal where finite) at the two main-path shapes (N=1: T=60, dims
   2/1; T=50, dims 4/2), in a non-PD case (N=3, T=16, dims 4/2) and with
   β+η scaled so that the pivots leave [2^-100, 2^100); float32 at
   bench.py:669's shape (T=100, dims 4/2, N=8 and 64), one trip and the
   damped fixed point from staggered marginals (capped at 4 trips); the
   two main-path configurations with fp_engine="auto" (LQR-TO-v1 lr, T=60,
   2 iterations, bench.py:834; Robot-TO-v0 mb, T=50, 2 iterations,
   examples/rgps/mb_robot.py): K15 and K16 launched once per fixed-point
   trip, one host sync per trip and one per fixed point, finite
   non-increasing traces within 1e-5 of trajopt_tpu's float64 traces
   (frozen in tests/torch_refs/test_torch_rgps.npz), ms per outer iteration, and the share of it
   that K15/K16's device time takes (both timed at the configuration's own
   shape); each held to fp_engine="scan" in float64 over one iteration with the
   searches cut; run_rgps_batch on 64 LQR-TO-v1 problems (1 iteration);
   K15/K16's device time, bound and plain time;
18. the kernels line (K1-K16) and, last, the device line.

A line "[t s] phase" marks the start of the later phases.

Exits nonzero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the tensor
# cores (both at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

T_MAIN, N_MAIN, NB_ITER = 1000, 2048, 10
N_SMALL, T_SMALL = 50, 48
# K1-K4 stage 16 steps of 16 instances at a time: a horizon that is not a
# whole number of chunks and a batch that is not a whole number of groups
N_RAGGED, T_RAGGED = 50, 45

# Operations per time step and rollout (or instance), counted from the CUDA
# sources at Cartpole's dims (dx=4, du=1), one per add, multiply, divide,
# compare or transcendental call:
#   ODE 24; RK4 step with clips 4·24 + 56 = 152; stage cost 20; tracking
#   action 16; finite checks 4  -> rollout step 192.
#   Dual RK4 step over 5 tangents about 1250; feature Jacobian and closed-form
#   cost blocks about 260; backward step (bwd_step.cuh) about 520
#   -> fused step about 2030; stream backward step 520.
OPS_PER_STEP = {"K1": 2030, "K2": 192, "K3": 192, "K4": 520}

# K2/K3 held bit for bit (equal, NaN in the same places) in float32 to their
# plain versions run on the CPU, where PyTorch divides by a scalar as a / b
# (its CUDA kernel multiplies by RN(1/b)) and where, as in ChainOps, a sine
# or cosine of an angle below 3e-5 is the angle or 1: a normal-range case
# (states, references, feed-forward of order 1e-7), then the same shape near
# the goal with them of order 1e-38, so that the ODE's numerators fall in
# [2^-135, 2^-100), below the range of ChainOps' quotient (csrc/envs.cuh),
# around 2^-128, where Markstein's quotient misses a / b most often (up to a
# fifth of numerators; tests/test_torch_chain_division.py) and ChainOps'
# vote sends the chunk to ExactChainOps' division.  (label, scale)
ROLLOUT_EXACT_CASES = (("normal range", 1e-7), ("residue", 1e-38))
N_ROLLOUT_EXACT, T_ROLLOUT_EXACT = 32, 20

# The replan path (bench.py's mpc_batch1_replan_ms row), timed over 3 replans
# for each backward, and the MPC example.  The timed replans, the GPS-MPC
# farm and the scan-engine comparisons of the GPS, belief and eLQR paths
# below are kept short to hold the script well inside its 1200 s.
T_REPLAN, ITER_REPLAN, REPLANS = 100, 3, 3
MPC_HORIZON, MPC_STEPS, MPC_ITER = 25, 100, 10

# The GPS paths: the batched swing-up solver at the GPS example's horizon
# (BASELINE.md:18) over 4096 instances, held against the scan engine on its
# first 64 for 2 iterations; the GPS-MPC farm of
# examples/gps/analytical/mpc/mb_pendulum_parallel.py (50 jobs, 25 of its 50
# steps), held against the scan engine on 4 episodes for 2 steps (the first
# replan and a warm-started one); the dual chain's benchmark shape
# (bench.py's gps_dual_eval_tps row: T=1000, batch 4096, dx=4, du=2).
GPS_KW = dict(kl_bound=2.0, action_penalty=1e-5)
T_GPS, N_GPS, GPS_ITER, GPS_BISECT = 100, 4096, 10, 64
N_GPS_SCAN, GPS_ITER_SCAN = 64, 2
GPS_MPC_EPISODES, GPS_MPC_HORIZON, GPS_MPC_STEPS, GPS_MPC_ITER = 50, 20, 25, 3
GPS_MPC_CHECK_EPISODES, GPS_MPC_CHECK_STEPS = 4, 2
T_DUAL, N_DUAL = 1000, 4096
# K6 held bit for bit in float32 to its plain version on the card (the same
# IEEE operations in the same order; the −Quu pivots' square roots and
# reciprocals are sqrtf's and 1/d's bits) on the solver path's first dual
# operands, the first 64 instances, α across the bisection's box; c₀ sums
# logf, held to a tolerance.  Not on the CPU: PyTorch's CPU square root
# (MKL's vector math) misses the correctly rounded root by an ulp on about 1%
# of arguments, and the card's is correctly rounded (PERF.md).
K6_EXACT_N, K6_EXACT_ALPHAS, K6_EXACT_C0_TOL = 64, (1e-16, 1.0, 1e16), 1e-5
# K7 the same way on K6's controller there: μ_T and Σ_T (products and sums
# only) equal, the KL sum, which sums logf, within K7_EXACT_KL_TOL of the
# largest entry.
K7_EXACT_KL_TOL = 1e-5

# The belief paths: K8 at bench.py's backward row (bench.py:511: LightDark's
# dims, T=25, batch 4096) and the batched solver at that shape, 10
# iterations, held against the scan engine on its first 64 instances; K9's
# solve and K10's light-dark episode at bench.py:447's configuration
# (horizon 25, 50 control steps, 10 iterations), K10 held against its plain
# version and the scan runner over the first 3 steps in float64.
T_BSP, N_BSP, BSP_ITER, BSP_STEPS = 25, 4096, 10, 50
# K8 held bit for bit in float32 to its plain version on the card (the same
# IEEE operations in the same order: the pivots' sqrtf and 1/d are correctly
# rounded there as in the kernel) on the first K8_EXACT_N instances of the
# batched solver's first backward operands, reg 1 and 2: K, kff, S, s, τ and
# dS equal (NaN in the same places), the flags equal.
K8_EXACT_N = 64
N_BSP_SCAN, BSP_CHECK_STEPS = 64, 3

# The eLQR paths: bench.py:390-420 (Cartpole-TO-v0, T=100, 10 iterations, batch
# 64 through the single-launch solve K14 and batch 1024 through the streamed
# sweeps K11-K13) and bench.py:1055's batch 1; float64 checks at N=50, T=16;
# the kernel engines held to the scan engine on 8 instances over 2 iterations
# and the scan engine timed over 1 (its torch.func steps take about 11 s an
# iteration at T=100, so 10 would take minutes).
T_ELQR, ELQR_ITER, N_ELQR_FUSED, N_ELQR_STREAM = 100, 10, 64, 1024
N_ELQR_SMALL, T_ELQR_SMALL, ELQR_SMALL_ITER = 50, 16, 3
N_ELQR_SCAN, ELQR_SCAN_ITER, ELQR_SCAN_TIMED_ITER = 8, 2, 1
# float32 tolerances, of the largest entry: one sweep at T=100 (K11, K12, and
# K13's returns; read up to 3.0e-5), K13's states and actions (a closed loop
# of 100 steps under the gains of order 1e3 that K12 returns carries the
# rounding from step to step: read 4.7e-3), and the 10-iteration solve (K14;
# read 3.3e-5 on NVIDIA H100 80GB HBM3, 700.00 W)
ELQR_F32_TOL, ELQR_F32_TRAJ_TOL, ELQR_F32_SOLVE_TOL = 1e-3, 1e-2, 1e-3
# K14's float32 RK4s divide with PivotOps::div_moderate and take ChainOps'
# sines (csrc/envs.cuh ExactChainOps), the step taken again with the
# library's operations where a sine's argument passes 105615: held to the
# plain version where the initial kff is of order 1e-33 from the zero state
# (numerators and tangents below 2^-99, the division's scaled path) and
# where the angle starts past 105615 (the retake; rollouts only, as the
# sweeps from there turn NaN in the plain version too), so that both run on
# the card every time.  (label, θ₀, step, kff scale, nb_iter)
ELQR_EXACT_CASES = (("tiny numerators", 0.0, 0.0, 1e-33, 2), ("wide angles", 2e5, 1.0, 1.0, 0))
N_ELQR_EXACT, T_ELQR_EXACT = 4, 10
# The float sweeps K11/K12 run K14's steps (csrc/elqr.cu), so the streamed
# engine (K11-K13) equals the fused one (K14) bit for bit in float32: held at
# the main path's N=64 solve over 10 iterations and on ELQR_EXACT_CASES.

# The robust-GPS paths: K15/K16 at bench.py:669's fixed-point shape (T=100,
# dims 4/2, batch 8 and 64, float32); the main path at the two configurations
# of ROADMAP row 13: bench.py:834's solve (LQR-TO-v1, lr, T=60, 2 iterations)
# and examples/rgps/mb_robot.py's problem (Robot-TO-v0, sigma_scale=1e-4, mb,
# T=50; 2 of its 10 iterations), both with fp_engine="auto"; each held to the
# scan engine in float64 over one iteration with the β-bisection, the fixed
# point and the α-bisection cut short (the scan engine's p = 28 chains run
# step by step); run_rgps_batch on 64 perturbed LQR-TO-v1 problems (1 of
# the solve's 2 iterations).
T_RGPS_FP, N_RGPS_FP = 100, (8, 64)
T_RGPS_LQR, T_RGPS_ROBOT, N_RGPS_BATCH = 60, 50, 64
RGPS_LQR = dict(variant="lr", nb_iter=2, init_action_sigma=10.0, policy_kl_bound=0.25,
                param_nominal_kl_bound=50.0, nominal_variance=1e-8)
RGPS_ROBOT = dict(variant="mb", nb_iter=2, init_action_sigma=1.0, policy_kl_bound=1.0,
                  param_nominal_kl_bound=50.0, nominal_variance=1e-8)
RGPS_SCAN_CUT = dict(nb_iter=1, beta_iters=3, fp_iters=6, alpha_bisect_iters=8)
# K15/K16 held exactly to their plain versions in float32 (the plain versions
# repeat the kernels' arithmetic in the kernels' order, each operation rounded
# once): the two main-path shapes, one row each, a non-PD case, and β+η
# scaled by 1e36 and 1e-32 so that W's pivots fall below 2^-100 and reach
# 2^100 or more, where the pivots' square root scales its argument (csrc/
# pivot.cuh).  (label, N, T, (dx, du), non-PD, the scale of β+η)
RGPS_EXACT_CASES = (("LQR-TO-v1 path", 1, T_RGPS_LQR, (2, 1), False, 1.0),
                    ("Robot-TO-v0 path", 1, T_RGPS_ROBOT, (4, 2), False, 1.0),
                    ("non-PD", 3, 16, (4, 2), True, 1.0),
                    ("tiny pivots", 2, 6, (4, 2), False, 1e36),
                    ("huge pivots", 2, 6, (4, 2), False, 1e-32))
RGPS_BATCH_ITER = 1
# the whole fixed point of the f32 check, from staggered marginals, capped
# at 4 trips: the plain versions take 4.5-6.5 s a trip at T=100, dims 4/2
RGPS_FP_CHECK_ITERS = 4
# float32 tolerances of the largest entry: one trip at T=100, and the whole
# fixed point; float64 engines held to each other over the cut solve
RGPS_F32_TRIP_TOL, RGPS_F32_FP_TOL, RGPS_F64_ENGINE_TOL = 1e-3, 1e-2, 1e-6
# the main path's float32 trace against trajopt_tpu's float64 one (frozen in
# tests/torch_refs/test_torch_rgps.npz; read 3.4e-7 on NVIDIA H100 80GB HBM3,
# 700.00 W, PERF.md): two iterations of bisections in float32
RGPS_TRACE_TOL = 1e-5


def _mm_ops(n, k, m):
    """Operations of an (n, k) by (k, m) product."""
    return n * m * (2 * k - 1)


def _chol_ops(n):
    """Operations of an n×n Cholesky factorization with its guard."""
    return sum(2 * j + 5 + (n - 1 - j) * (2 * j + 1) for j in range(n))


def k5_operations(T, dx, du):
    """Operations of one K5 call, counted from csrc/pscan_backward.cu (one per
    add, multiply, divide, compare, select, square root or negation): the
    element of each of the T steps, ⌈log₂(T+1)⌉ levels of T+1 combines, the
    gains and dV of each step."""
    mm, chol = _mm_ops, _chol_ops
    solve = 2 * du * du
    gj = sum(3 * (dx - 1 - k) + 4 * dx * (dx - 1 - k) + 1 + 2 * dx + 4 * dx * (dx - 1)
             for k in range(dx))
    combine = 8 * mm(dx, dx, dx) + 4 * mm(dx, dx, 1) + 5 * dx + 6 * dx * dx + gj
    element = (chol(du) + (2 * dx + 1) * solve + 3 * mm(dx, du, dx) + 2 * mm(dx, du, 1)
               + 5 * dx * dx + 3 * dx)
    gains = (2 * mm(du, dx, dx) + mm(du, dx, du) + du * du + chol(du) + (dx + 1) * solve
             + 2 * dx * du + mm(du, dx, 1) + mm(du, du, 1) + 4 * du + 2 * (2 * du - 1) + 4)
    levels = max(1, T.bit_length())        # ⌈log₂(T+1)⌉
    return T * (element + gains) + levels * (T + 1) * combine


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def errors(name, got, ref, tol, floor=0.0):
    """Max abs error and error relative to the reference's largest entry or,
    where that is larger, to ``floor``: the natural scale of a stream that
    is rounding residue of an exact zero."""
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), floor, 1e-30)
    log(f"  {name}: max_abs_err={err:.3e} max_rel_err={err / scale:.3e} (tol {tol:.0e})")
    if not err / scale <= tol:
        fail(f"{name}: relative error {err / scale:.3e} above {tol:.0e}")
    return err


def same_flags(name, got, ref):
    if not torch.equal(got, ref):
        fail(f"{name}: flags differ in {(got != ref).sum().item()} lanes")


def same_bits(name, got, ref):
    """Fail unless ``got`` equals ``ref`` (torch.equal) with NaN in the same
    places."""
    got, ref = got.cpu(), ref.cpu()
    if got.is_floating_point():
        nan = torch.isnan(got)
        if not torch.equal(nan, torch.isnan(ref)):
            fail(f"{name}: NaN in other places")
        got, ref = got[~nan], ref[~nan]
    if not torch.equal(got, ref):
        fail(f"{name}: differs in {(got != ref).sum().item()} of {got.numel()} entries")
    log(f"  {name}: equal")


def trajectory(env, N, T, seed, dtype, device):
    """Seeded actions (every third step of half the instances exactly at
    ±umax) rolled out from seeded states with the env's dynamics, float64."""
    rng = np.random.default_rng(seed)
    umax = env.umax[0]
    us = np.clip(4.0 * rng.standard_normal((N, T, env.dm_act)), -umax, umax)
    us[: N // 2, ::3, 0] = np.where(rng.random((N // 2, len(range(0, T, 3)))) < 0.5, umax, -umax)
    x = torch.as_tensor(np.asarray(env.x0) + 0.3 * rng.standard_normal((N, env.dm_state)),
                        device=device)
    u = torch.as_tensor(us, device=device)
    xs = [x]
    for t in range(T):
        x = env.dynamics(x, u[:, t])
        xs.append(x)
    return torch.stack(xs, dim=1).to(dtype), u.to(dtype)


def kernel_inputs(env, N, T, seed, dtype, device):
    from trajopt_torch.core.cuda_lqr import lane_pad, pack_lanes, pad_lanes, to_soa
    from trajopt_torch.core.diff import linearize_dynamics_delta, quadratize_cost_delta
    from trajopt_torch.solvers.common import make_weighting

    xref, uref = trajectory(env, N, T, seed, dtype, device)
    n_pad = lane_pad(N)
    w = make_weighting(T, None, device=device, dtype=dtype)
    A, B = linearize_dynamics_delta(env.dynamics, xref[:, :T], uref)
    cost = quadratize_cost_delta(env.cost, xref, uref, w)
    rng = np.random.default_rng(seed + 1)
    lam = torch.as_tensor(rng.uniform(0.01, 1.0, N), dtype=dtype, device=device)
    ulast = torch.cat([torch.zeros_like(uref[:, :1]), uref[:, :-1]], dim=1)
    return dict(
        N=N, n_pad=n_pad, w=w, lam=pad_lanes(lam, n_pad),
        packed=pack_lanes(cost, A, B, n_pad),
        xr=to_soa(xref[:, :T], n_pad), ur=to_soa(uref, n_pad), ul=to_soa(ulast, n_pad),
        xT=to_soa(xref[:, T:], n_pad)[0],
    )


def main_path_streams(env, x0):
    """The first iteration's line-search inputs on the main path: the initial
    trajectory of the bench's x0 and the gains of the plain fused backward at
    λ = 1 on it."""
    from trajopt_torch.core.cuda_fused import fused_backward_plain
    from trajopt_torch.core.cuda_lqr import lane_pad, to_soa
    from trajopt_torch.parallel.mpc import make_ilqr_solver_batched
    from trajopt_torch.solvers.common import make_weighting

    solve = make_ilqr_solver_batched(env, T_MAIN, backward="cuda-fused", rollout="cuda",
                                     device=x0.device, dtype=x0.dtype)
    state = solve.init(x0)
    n_pad = lane_pad(x0.shape[0])
    w = make_weighting(T_MAIN, None, device=x0.device, dtype=x0.dtype)
    ulast = torch.cat([torch.zeros_like(state.uref[:, :1]), state.uref[:, :-1]], dim=1)
    xr, ur = to_soa(state.xref[:, :T_MAIN], n_pad), to_soa(state.uref, n_pad)
    K, kff, _, _ = fused_backward_plain(
        env, xr, ur, to_soa(ulast, n_pad), to_soa(state.xref[:, T_MAIN:], n_pad)[0], w,
        torch.ones(n_pad, dtype=x0.dtype, device=x0.device), 1,
    )
    return (K, kff, xr, ur), w


def check_backwards(env_v0, env_v1, N, T, dtype, tol, device, reg_modes):
    """Hold K4 and K1 (Cartpole v0 and v1) against their plain versions for
    each ``reg``: gains and dV within ``tol`` of the largest entry, flags
    equal.  Returns the max abs error of each kernel's K on v0 and v0's
    inputs."""
    from trajopt_torch.core import cuda_fused, cuda_lqr

    log(f"backward checks: {dtype}, N={N}, T={T}")
    inp = kernel_inputs(env_v0, N, T, 0, dtype, device)
    errs = {}
    for reg in reg_modes:
        K, kff, dV, bad = cuda_lqr.cuda_ilqr_backward_packed(inp["packed"], inp["lam"], reg)
        Kp, kffp, dVp, badp = cuda_lqr._ilqr_backward_plain(inp["packed"], inp["lam"], reg)
        torch.cuda.synchronize()
        errs["K4"] = errors(f"K4 reg={reg} K", K, Kp, tol)
        errors(f"K4 reg={reg} kff", kff, kffp, tol)
        errors(f"K4 reg={reg} dV", dV, dVp, tol)
        same_flags(f"K4 reg={reg} bad", bad, badp)

    for name, env, seed in (("v0", env_v0, 0), ("v1", env_v1, 2)):
        e = inp if seed == 0 else kernel_inputs(env, N, T, seed, dtype, device)
        for reg in reg_modes:
            args = (env, e["xr"], e["ur"], e["ul"], e["xT"], e["w"], e["lam"], reg)
            K, kff, dV, bad = cuda_fused.cuda_ilqr_backward_fused(*args)
            Kp, kffp, dVp, badp = cuda_fused.fused_backward_plain(*args)
            torch.cuda.synchronize()
            err = errors(f"K1 {name} reg={reg} K", K, Kp, tol)
            if name == "v0":
                errs["K1"] = err
            errors(f"K1 {name} reg={reg} kff", kff, kffp, tol)
            errors(f"K1 {name} reg={reg} dV", dV, dVp, tol)
            same_flags(f"K1 {name} reg={reg} bad", bad, badp)
    return errs, inp


def check_kernels(env_v0, env_v1, N, T, dtype, tol, device, reg_modes, rollout_inputs=None):
    """Hold K1-K4 against their plain versions; returns the max abs error of
    each kernel's main output and the inputs, for the timings.  The rollouts
    run on ``rollout_inputs`` (streams, weighting) when given, else under the
    gains of the plain backward on the backward's own trajectory."""
    from trajopt_torch.core import cuda_lqr
    from trajopt_torch.solvers.common import DEFAULT_ALPHAS

    errs, inp = check_backwards(env_v0, env_v1, N, T, dtype, tol, device, reg_modes)
    if rollout_inputs is None:
        Kp, kffp, _, _ = cuda_lqr._ilqr_backward_plain(inp["packed"], inp["lam"], 1)
        streams, w = (Kp, kffp, inp["xr"], inp["ur"]), inp["w"]
    else:
        streams, w = rollout_inputs
    alphas = torch.tensor(DEFAULT_ALPHAS, dtype=dtype, device=device)
    errs.update(check_rollouts(env_v0, streams, w, alphas, tol))
    pick = torch.arange(streams[0].shape[2], device=device) % alphas.shape[0]
    alpha_l = alphas[pick].contiguous()
    inp.update(streams=streams, w_roll=w, alphas=alphas, alpha_l=alpha_l, env=env_v0)
    return errs, inp


def check_rollouts(env, streams, w, alphas, tol, label=""):
    """Hold K2 (every α of ``alphas``) and K3 (instance n at α number n mod
    nA) against their plain versions on the same streams: outputs within
    ``tol`` of the largest entry, ``ok`` flags equal.  Returns each kernel's
    max abs error (K2's returns, K3's states)."""
    from trajopt_torch.core import cuda_rollout

    errs = {}
    ret, ok = cuda_rollout.cuda_rollout_returns(env, *streams, w, alphas)
    retp, okp = cuda_rollout.rollout_returns_plain(env, *streams, w, alphas)
    torch.cuda.synchronize()
    errs["K2"] = errors(f"K2{label} returns", ret, retp, tol)
    same_flags(f"K2{label} ok", ok, okp)
    pick = torch.arange(streams[0].shape[2], device=alphas.device) % alphas.shape[0]
    alpha_l = alphas[pick].contiguous()
    outs = cuda_rollout.cuda_rollout_selected(env, *streams, w, alpha_l)
    outsp = cuda_rollout.rollout_selected_plain(env, *streams, w, alpha_l)
    torch.cuda.synchronize()
    errs["K3"] = errors(f"K3{label} states", outs[0], outsp[0], tol)
    for i, part in enumerate(("actions", "terminal state", "returns")):
        errors(f"K3{label} {part}", outs[i + 1], outsp[i + 1], tol)
    return errs


def check_rollout_exact(env, device):
    """ROLLOUT_EXACT_CASES: K2 (11 α) and K3 on the card against their plain
    versions on the CPU, bit for bit; K = 10·N(0, 1), the start state, the
    references and kff scaled N(0, 1)."""
    from trajopt_torch.core import cuda_rollout
    from trajopt_torch.solvers.common import DEFAULT_ALPHAS

    N, T = N_ROLLOUT_EXACT, T_ROLLOUT_EXACT
    alphas = torch.tensor(DEFAULT_ALPHAS, dtype=torch.float32, device=device)
    alpha_l = alphas[torch.arange(N, device=device) % alphas.shape[0]].contiguous()
    for label, scale in ROLLOUT_EXACT_CASES:
        rng = np.random.default_rng(21)
        K = 10.0 * rng.standard_normal((T, 4, N))
        kff, xref, uref = (scale * rng.standard_normal(shape)
                           for shape in ((T, 1, N), (T, 4, N), (T, 1, N)))
        streams = [torch.as_tensor(a, dtype=torch.float32, device=device)
                   for a in (K, kff, xref, uref)]
        w = torch.ones(T + 1, dtype=torch.float32, device=device)
        cpu = [t.cpu() for t in (*streams, w)]
        log(f"K2/K3 check: float32, {label} (scale {scale:.0e}), N={N}, T={T}, bit for bit "
            "against the plain versions on the CPU")
        got = cuda_rollout.cuda_rollout_returns(env, *streams, w, alphas)
        ref = cuda_rollout.rollout_returns_plain(env, *cpu, alphas.cpu())
        for part, g, r in zip(("returns", "ok"), got, ref):
            same_bits(f"K2 {label} {part}", g, r)
        got = cuda_rollout.cuda_rollout_selected(env, *streams, w, alpha_l)
        ref = cuda_rollout.rollout_selected_plain(env, *cpu, alpha_l.cpu())
        nonzero = ref[0][ref[0] != 0].abs()
        log(f"  {label}: states from {nonzero.min().item():.2e} to {nonzero.max().item():.2e}")
        for part, g, r in zip(("states", "actions", "terminal state", "returns"), got, ref):
            same_bits(f"K3 {label} {part}", g, r)


def pscan_problem(T, dx, du, dtype, device, seed=0, non_pd=False):
    """The SPD problem of tests/test_tpu.py:93-110 (seed 0 there), with one
    negative-definite action Hessian at T/2 when ``non_pd``."""
    from trajopt_torch.core.types import QuadraticCost

    rng = np.random.default_rng(seed)

    def spd(d, n, s):
        M = rng.standard_normal((n, d, d))
        return s * np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    Cxx, cx = spd(dx, T + 1, 0.1), rng.standard_normal((T + 1, dx))
    Cuu, cu = spd(du, T, 1.0), rng.standard_normal((T, du))
    Cxu = 0.01 * rng.standard_normal((T, dx, du))
    A = np.eye(dx) + 0.01 * rng.standard_normal((T, dx, dx))
    B = 0.1 * rng.standard_normal((T, dx, du))
    if non_pd:
        Cuu[T // 2] = -4.0 * np.eye(du)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    return QuadraticCost(t(Cxx), t(cx), t(Cuu), t(cu), t(Cxu), t(np.zeros(T + 1))), t(A), t(B)


def with_lambda(cost, lam):
    """λ folded into the action Hessian, as cuda_pilqr_backward_reg does."""
    du = cost.Cuu.shape[-1]
    return cost._replace(Cuu=cost.Cuu + lam * torch.eye(du, dtype=cost.Cuu.dtype,
                                                         device=cost.Cuu.device))


def check_k5_case(label, cost, A, B, tol):
    """K5 against its plain version on the same inputs; returns the max abs
    error of K and whether both flag divergence alike."""
    from trajopt_torch.core.cuda_pscan import cuda_pilqr_backward, pilqr_backward_plain

    pol, val, dV = cuda_pilqr_backward(cost, A, B)
    ppol, pval, pdV = pilqr_backward_plain(cost, A, B)
    torch.cuda.synchronize()
    err = errors(f"K5 {label} K", pol.K, ppol.K, tol)
    errors(f"K5 {label} kff", pol.kff, ppol.kff, tol)
    errors(f"K5 {label} V", val.V, pval.V, tol)
    errors(f"K5 {label} v", val.v, pval.v, tol)
    errors(f"K5 {label} dV", dV, pdV, tol)
    flag = lambda p, v: bool(~(torch.isfinite(p.K).all() & torch.isfinite(p.kff).all()  # noqa: E731
                               & torch.isfinite(v.V).all()))
    if flag(pol, val) != flag(ppol, pval):
        fail(f"K5 {label}: divergence flags differ")
    return err


def check_k5(device):
    """Phase 6 but the replan-path case (which needs the solver)."""
    log("K5 checks: float64, tolerance 1e-9 of the largest entry")
    for T, dx, du in ((19, 3, 2), (130, 2, 1), (2500, 4, 2)):
        cost, A, B = pscan_problem(T, dx, du, torch.float64, device, seed=T)
        for lam in (0.0, 0.6):
            check_k5_case(f"f64 T={T} dx={dx} du={du} lam={lam}", with_lambda(cost, lam),
                          A, B, 1e-9)
    # float32: log₂(T+1) levels of Gauss–Jordan inverses in another order
    # than the reference's; the JAX package's own device tolerance
    # (tests/test_tpu.py:114-117)
    log("K5 checks: float32 on the SPD problem of tests/test_tpu.py, tolerance 2e-3")
    for T in (60, 333, 1000):
        check_k5_case(f"f32 T={T} dx=4 du=2", *pscan_problem(T, 4, 2, torch.float32, device),
                      2e-3)
    cost, A, B = pscan_problem(130, 2, 1, torch.float64, device, non_pd=True)
    check_k5_case("f64 non-PD Cuu at T/2", cost, A, B, 1e-9)


def replan_inputs(env, x0, T):
    """The first backward inputs of a single-problem solve over T steps from
    ``x0``: the expansion of the initial trajectory (zero actions, the
    solver's first α candidate; the MPC runner's first warm start is zero
    too) and λ = 1.  Also returns the initial return."""
    from trajopt_torch.core.diff import linearize_dynamics_delta, quadratize_cost_delta
    from trajopt_torch.core.types import LinearPolicy
    from trajopt_torch.solvers.common import make_weighting, rollout_tracking

    dx, du = env.dm_state, env.dm_act
    w = make_weighting(T, None, device=x0.device, dtype=x0.dtype)
    kw = dict(dtype=x0.dtype, device=x0.device)
    xref0 = torch.zeros(T + 1, dx, **kw)
    xref0[0] = x0
    pol0 = LinearPolicy(K=torch.zeros(T, du, dx, **kw), kff=torch.zeros(T, du, **kw))
    xs, us, costs = rollout_tracking(env, pol0, 1.0, x0, xref0, torch.zeros(T, du, **kw), w)
    A, B = linearize_dynamics_delta(env.dynamics, xs[:T], us)
    cost = quadratize_cost_delta(env.cost, xs, us, w)
    return with_lambda(cost, 1.0), A, B, costs.sum()


def time_cuda(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_per_launch(fn, reps, kernel):
    """Device time per launch of the CUDA kernels whose name holds ``kernel``,
    from torch.profiler over ``reps`` calls of ``fn`` after one warm-up: the
    mean over the launches the profiler recorded (it may miss a few as it
    starts), and their count.  Used for K5, whose wrapper launches small
    copies beside its kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in hits)
    if not 0 < count <= reps:
        fail(f"the profiler saw {count} launches of {kernel} in {reps} calls")
    return sum(e.self_device_time_total for e in hits) / 1e3 / count, count


def device_ms_back_to_back(fn, reps, sleep_cycles=int(2e8)):
    """Device time per call of ``fn`` with its launches queued back to back:
    a sleep kernel of ``sleep_cycles`` holds the stream while the host
    enqueues ``reps`` calls, so the CUDA events bracket the device's work
    alone and not the host's time between launches.  Used for K1-K4 and
    K6-K16, whose wrappers launch nothing but the kernel (the profiler
    recorded only 1-2 of 20 of K6/K7's launches).  Where the host stalled and
    its enqueue outran the sleep, the launches are timed again behind a sleep
    ten times as long.  Returns (ms per call, the host's enqueue ms, the
    sleep's ms)."""
    fn()
    torch.cuda.synchronize()
    for sleep in (sleep_cycles, 10 * sleep_cycles):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(sleep)
        s1.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        sleep_ms = s0.elapsed_time(s1)
        if enqueue_ms < sleep_ms:
            return start.elapsed_time(end) / reps, enqueue_ms, sleep_ms
    fail(f"the host took {enqueue_ms:.1f} ms to enqueue, longer than the "
         f"{sleep_ms:.1f} ms sleep: the launches did not queue back to back")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kept_launches(targets, run):
    """Run ``run()`` with the kernel wrappers ``targets`` ({key: (module,
    attribute)}, the name through which the path calls each) replaced by ones
    that keep every call's arguments and call the original (whose launch
    count goes on counting).  Returns ({key: [(args, kwargs), ...]},
    {key: original})."""
    originals = {k: getattr(mod, name) for k, (mod, name) in targets.items()}
    kept = {k: [] for k in targets}

    def keeping(k):
        def call(*args, **kwargs):
            kept[k].append((args, kwargs))
            return originals[k](*args, **kwargs)
        call.launches = 0
        return call

    try:
        for k, (mod, name) in targets.items():
            setattr(mod, name, keeping(k))
        run()
        torch.cuda.synchronize()
    finally:
        for k, (mod, name) in targets.items():
            setattr(mod, name, originals[k])
    return kept, originals


def replay_ms(kept, originals, reps=5):
    """Device ms of each kept launch, replayed ``reps`` times back to back
    (a sleep of 2e7 cycles holds the stream while so few are enqueued)."""
    return {k: [device_ms_back_to_back(lambda: originals[k](*a, **kw), reps, int(2e7))[0]
                for a, kw in calls] for k, calls in kept.items()}


def spread(ms):
    """min, median, max and sum of a list of ms per launch."""
    ms_sorted = sorted(ms)
    return {"launches": len(ms), "min": ms_sorted[0], "median": ms_sorted[len(ms) // 2],
            "max": ms_sorted[-1], "sum": sum(ms)}


# --------------------------------------------------------------------------------------
# GPS: kernels K6 and K7, the batched solver, the GPS-MPC farm
# --------------------------------------------------------------------------------------


def k6_operations(T, dx, du):
    """Operations of one K6 launch, counted from csrc/gps.cu (one per add,
    multiply, divide, compare, square root or log): per step, the KL
    augmentation (a du×du Cholesky, its inverse, the old policy's products),
    the Q blocks, the factor of −Quu with its solves, and the value update."""
    mv = lambda n, k: _mm_ops(n, k, 1)  # noqa: E731
    dot = lambda n: 2 * n - 1  # noqa: E731
    solve, inv = 2 * du * du, 2 * du ** 3
    augment = (2 * du * du + _chol_ops(du) + inv + 2 * du + _mm_ops(du, du, dx) + mv(du, du)
               + _mm_ops(dx, du, dx) + mv(dx, du) + 2 * dx * dx + 2 * dx * du + 2 * dx
               + 2 * du * du + 2 * du + dot(du) + 6)
    q = (2 * _mm_ops(dx, dx, dx) + 2 * _mm_ops(dx, dx, du) + _mm_ops(du, dx, du) + mv(dx, dx)
         + 2 * dx * dx + 2 * dx * du + 2 * du * du + 2 * mv(du, dx) + 2 * mv(dx, dx)
         + 4 * du + 4 * dx + 2 * dot(dx) + 2 * dx * dx + 5)
    policy = 3 * du * du + _chol_ops(du) + (dx + 1) * solve + du + inv + du * du + 2
    value = _mm_ops(dx, du, dx) + 4 * dx * dx + mv(dx, du) + 3 * dx + 2 * du + dot(du) + 8
    return T * (augment + q + policy + value)


def k7_operations(T, dx, du):
    """Operations of one K7 launch, counted from csrc/gps.cu: per step, the
    policy KL (two du×du Cholesky factors, one inverse, the gain-difference
    products) and the propagation of (μ, Σ)."""
    mv = lambda n, k: _mm_ops(n, k, 1)  # noqa: E731
    kl = (4 * du * du + 2 * _chol_ops(du) + 2 * du ** 3 + dx * du + du + _mm_ops(du, du, dx)
          + _mm_ops(dx, du, dx) + mv(du, du) + mv(dx, du) + mv(dx, dx) + 4 * du
          + 2 * du * du + 2 * dx * dx + 4 * dx + 2 * du + 12)
    prop = (mv(du, dx) + du + _mm_ops(du, dx, dx) + _mm_ops(du, dx, du) + du * du + mv(dx, dx)
            + mv(dx, du) + 2 * _mm_ops(dx, dx, dx) + _mm_ops(dx, dx, du)
            + 2 * _mm_ops(dx, du, dx) + _mm_ops(dx, du, du) + 2 * dx + 6 * dx * dx)
    return T * (kl + prop)


def gps_problem(N, T, dx, du, seed, dtype, device, alphas, non_pd_at=None):
    """Random dual-chain operands made with numpy (the recipe of
    tests/test_torch_gps_kernels.py): SPD cost, noise and old-policy
    covariance blocks, a contracting A; α per instance from ``alphas`` in
    turn; with ``non_pd_at``, an action cost of −50·I at that step makes −Quu
    indefinite.  Returns (cost, dyn, old, α, μ₀, Σ₀), batch-leading."""
    from trajopt_torch.core.types import (
        LinearGaussianDynamics,
        LinearGaussianPolicy,
        QuadraticCost,
    )

    rng = np.random.default_rng(seed)

    def spd(d, n, s=1.0):
        M = rng.standard_normal((N, n, d, d))
        return s * (np.einsum("bnij,bnkj->bnik", M, M) + d * np.eye(d))

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    Cuu = spd(du, T + 1)
    if non_pd_at is not None:
        Cuu[:, non_pd_at] = -50.0 * np.eye(du)
    cost = QuadraticCost(t(spd(dx, T + 1)), t(rng.standard_normal((N, T + 1, dx))), t(Cuu),
                         t(rng.standard_normal((N, T + 1, du))),
                         t(0.1 * rng.standard_normal((N, T + 1, dx, du))),
                         t(0.1 * rng.standard_normal((N, T + 1))))
    dyn = LinearGaussianDynamics(t(0.9 * (np.eye(dx) + 0.1 * rng.standard_normal((N, T, dx, dx)))),
                                 t(0.5 * rng.standard_normal((N, T, dx, du))),
                                 t(0.1 * rng.standard_normal((N, T, dx))), t(spd(dx, T, 0.01)))
    old = LinearGaussianPolicy(t(0.1 * rng.standard_normal((N, T, du, dx))),
                               t(0.1 * rng.standard_normal((N, T, du))), t(spd(du, T, 0.5)))
    alpha = t(np.asarray(alphas)[np.arange(N) % len(alphas)][:, None] * np.ones((1, T)))
    return cost, dyn, old, alpha, t(rng.standard_normal((N, dx))), t(spd(dx, 1, 0.1)[:, 0])


def gps_dual_operands(T, dx, du, N, device):
    """float32 operands built the way bench.py::_gps_dual_operands builds them:
    one instance of bench.py's ``_problem`` (numpy, seed 0) broadcast over the
    batch, cx decorrelated by 0.01·N(0, 1), Σ_dyn = 1e-4·I, the old policy's
    K and kff 0.1·N(0, 1) with Σ = I, μ₀ = 0, Σ₀ = 0.1·I; the batch draws come
    from a seeded torch generator where the bench draws with JAX."""
    from trajopt_torch.core.types import (
        LinearGaussianDynamics,
        LinearGaussianPolicy,
        QuadraticCost,
    )

    rng = np.random.default_rng(0)

    def spd(d, n):
        M = rng.standard_normal((n, d, d))
        return np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    A = 0.97 * (np.eye(dx) + 0.05 * rng.standard_normal((T, dx, dx)))
    B = 0.1 * rng.standard_normal((T, dx, du))
    one = dict(A=A, B=B, Cxx=spd(dx, T + 1), cx=rng.standard_normal((T + 1, dx)),
               Cuu=spd(du, T + 1), cu=rng.standard_normal((T + 1, du)),
               Cxu=0.1 * rng.standard_normal((T + 1, dx, du)), c0=np.zeros(T + 1),
               c=0.01 * rng.standard_normal((T, dx)))
    kw = dict(dtype=torch.float32, device=device)
    b = {k: torch.as_tensor(v, **kw).expand(N, *v.shape).contiguous() for k, v in one.items()}
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, **kw)

    cost = QuadraticCost(b["Cxx"], b["cx"] + 0.01 * normal(N, T + 1, dx), b["Cuu"], b["cu"],
                         b["Cxu"], b["c0"])
    dyn = LinearGaussianDynamics(b["A"], b["B"], b["c"],
                                 (1e-4 * torch.eye(dx, **kw)).expand(N, T, dx, dx))
    old = LinearGaussianPolicy(0.1 * normal(N, T, du, dx), 0.1 * normal(N, T, du),
                               torch.eye(du, **kw).expand(N, T, du, du))
    return (cost, dyn, old, torch.full((N, T), 10.0, **kw), torch.zeros(N, dx, **kw),
            (0.1 * torch.eye(dx, **kw)).expand(N, dx, dx))


def check_gps_case(label, packed, alpha_l, tol):
    """K6 and K7 against their plain versions on the same packed operands
    (K7 on K6's controller); returns the max abs error of K6's gains and of
    K7's KL sum, K6's flags and the plain versions' ms ({"K6", "K7"}: one
    call each, the rows' plain time)."""
    from trajopt_torch.core import cuda_gps

    k6 = cuda_gps.cuda_gps_backward_packed(packed, alpha_l)
    p6, ms6 = timed(lambda: cuda_gps.gps_backward_plain(packed, alpha_l))
    k7 = cuda_gps.cuda_gps_forward_kl_packed(packed, *k6[:3])
    p7, ms7 = timed(lambda: cuda_gps.gps_forward_kl_plain(packed, *k6[:3]))
    errs = [errors(f"K6 {label} {name}", a, b, tol)
            for name, a, b in zip(("K", "kff", "sigma_ctl", "V0", "v0", "c0"), k6, p6)]
    same_flags(f"K6 {label} bad", k6[6], p6[6])
    errs7 = [errors(f"K7 {label} {name}", a, b, tol)
             for name, a, b in zip(("kl_sum", "muT", "sigmaT"), k7, p7)]
    return errs[0], errs7[0], k6[6], {"K6": ms6, "K7": ms7}


def check_gps_kernels(device):
    """K6/K7 against their plain versions: float64 with α spanning the
    bisection's box, a divergence case, float32 at the benchmark shape."""
    from trajopt_torch.core.cuda_gps import pack_gps, pack_gps_alpha

    # float64: the kernels and the plain versions do the same IEEE operations
    # in the same order (-fmad=false), so they agree to rounding even at
    # α = 1e16, where V is mostly cancellation
    log("K6/K7 checks: float64, N=50, T=48, α ∈ {1e-16, 1, 1e16}, tolerance 1e-12")
    for dx, du in ((2, 1), (4, 2)):
        cost, dyn, old, alpha, mu0, sig0 = gps_problem(50, 48, dx, du, 7, torch.float64, device,
                                                       (1e-16, 1.0, 1e16))
        bad = check_gps_case(f"f64 dx={dx} du={du}", pack_gps(cost, dyn, old, mu0, sig0),
                                   pack_gps_alpha(alpha), 1e-12)[2]
        if bool(bad.any()):
            fail(f"K6 flagged {int(bad.sum())} instances of a positive-definite problem")
    # −Quu indefinite at t = 1: the guard (a bad pivot becomes 1) keeps the
    # outputs finite (errors() fails on a non-finite one) and the flag is set
    for dx, du in ((2, 1), (4, 2)):
        cost, dyn, old, alpha, mu0, sig0 = gps_problem(50, 48, dx, du, 8, torch.float64, device,
                                                       (1.0,), non_pd_at=1)
        bad = check_gps_case(f"f64 non-PD dx={dx} du={du}",
                             pack_gps(cost, dyn, old, mu0, sig0), pack_gps_alpha(alpha), 1e-12)[2]
        if not bool(bad.any()):
            fail(f"K6 flagged no instance with −Quu indefinite (dx={dx} du={du})")
    # float32 at the dual chain's benchmark shape: the same operations in the
    # same order as the plain version; 1e-4 of the largest entry, the f32
    # tolerance of K1-K4 over T=1000
    log(f"K6/K7 checks: float32, T={T_DUAL}, N={N_DUAL}, dx=4, du=2, α=10, tolerance 1e-4")
    cost, dyn, old, alpha, mu0, sig0 = gps_dual_operands(T_DUAL, 4, 2, N_DUAL, device)
    packed, alpha_l = pack_gps(cost, dyn, old, mu0, sig0), pack_gps_alpha(alpha)
    errs = check_gps_case(f"f32 T={T_DUAL} dx=4 du=2", packed, alpha_l, 1e-4)
    return packed, alpha_l, errs


def gps_kernel_rows(label, packed, alpha_l, launches, checked, card, path_ms=None):
    """Device time per launch (back to back), the wrappers' time per call,
    bytes and bound of K6 and K7 on ``packed``, with the errors and the plain
    versions' time from ``checked`` (check_gps_case on the same operands);
    with ``path_ms``, each kernel's device ms on the solver path's own
    launches beside them."""
    from trajopt_torch.core import cuda_gps

    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    k6 = cuda_gps.cuda_gps_backward_packed(packed, alpha_l)
    k7 = cuda_gps.cuda_gps_forward_kl_packed(packed, *k6[:3])
    ins6 = [packed[k] for k in ("cxx", "cx", "cuu", "cu", "cxu", "c0", "A", "B", "c", "sigd", "Ko",
                                "ko", "sigo", "vT", "vvT", "v0T")] + [alpha_l]
    ins7 = [packed[k] for k in ("A", "B", "c", "sigd", "Ko", "ko", "sigo", "mu0", "sig0")]
    specs = {
        "K6": ("K6 gps_backward", "trajopt_tpu/core/pallas_gps.py:82",
               nbytes(*ins6, *k6), k6_operations(T, dx, du),
               lambda: cuda_gps.cuda_gps_backward_packed(packed, alpha_l)),
        "K7": ("K7 gps_forward_kl", "trajopt_tpu/core/pallas_gps.py:205",
               nbytes(*ins7, *k6[:3], *k7), k7_operations(T, dx, du),
               lambda: cuda_gps.cuda_gps_forward_kl_packed(packed, *k6[:3])),
    }
    rows = {}
    errs = dict(zip(("K6", "K7"), checked[:2]))
    for key, (name, replaces, moved, ops, call) in specs.items():
        device_ms, enqueue_ms, _ = device_ms_back_to_back(call, 20)
        bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / F32_OPS_PER_S
        row = {
            "name": name, "route": "cuda", "source": "trajopt_torch/csrc/gps.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": errs[key],
            # the kernel's own device time; call_ms adds the wrapper's host work
            "ms": device_ms, "call_ms": time_cuda(call, 20), "plain_ms": checked[3][key],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a soft-Riccati recursion or a
            # Gaussian propagation under a linear-Gaussian controller
            "library_ms": None,
        }
        if path_ms is not None:
            row["ms_main_path"] = spread(path_ms[key])
        log(json.dumps({"metric": "kernel", "shape": f"{label}, T={T} N={N} dx={dx} du={du}",
                        **row, "enqueue_ms_per_call": enqueue_ms / 20, "bytes": moved,
                        "operations": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                        "gpu": card}))
        rows[key] = row
    return rows


def gps_path(device):
    """The GPS solver path's problem: Pendulum-TO-v0 (dt=0.05) from seeded
    initial means, Σ₀ = 1e-2·I, seeded initial kff; returns (solver(engine,
    nb_iter), μ₀s, Σ₀s, kff0), float32 on ``device``."""
    import trajopt_torch
    from trajopt_torch.parallel.gps import make_mbgps_solver_batched

    env = trajopt_torch.make("Pendulum-TO-v0", dt=0.05)
    kw = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(5)
    mu0s = torch.as_tensor(np.asarray(env.x0) + 0.1 * rng.standard_normal((N_GPS, 2)), **kw)
    sigma0s = (1e-2 * torch.eye(2, **kw)).expand(N_GPS, 2, 2)
    gen = torch.Generator(device=device).manual_seed(0)
    kff0 = 1e-4 * torch.randn(N_GPS, T_GPS, 1, generator=gen, **kw)

    def solver(engine, nb_iter):
        return make_mbgps_solver_batched(env, T_GPS, nb_iter=nb_iter, bisect_iters=GPS_BISECT,
                                         engine=engine, **GPS_KW, **kw)

    return solver, mu0s, sigma0s, kff0


def gps_solver_phase(device, card, wrappers):
    """The solver path: make_mbgps_solver_batched with engine="cuda" at full
    width; launch counts, finite traces no higher at the end than at the
    start, the scan engine on the first instances; then its timings, a
    torch.profiler split of one outer iteration and K6/K7's device time on
    that iteration's own launches."""
    from trajopt_torch.core.cuda_gps import pack_gps, pack_gps_alpha

    kw = dict(dtype=torch.float32, device=device)
    solver, mu0s, sigma0s, kff0 = gps_path(device)
    solve = solver("cuda", GPS_ITER)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    state, traces = solve(mu0s, sigma0s, kff_init=kff0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    log(json.dumps({"gps_solver_launches": launches, "first_solve_s": first_s}))
    for k in ("K6", "K7"):
        if launches[k] != GPS_ITER * GPS_BISECT:
            fail(f"the GPS solver launched {k} {launches[k]} times, not "
                 f"{GPS_ITER} x {GPS_BISECT}")
    if not bool(torch.isfinite(traces).all()):
        fail("non-finite GPS traces")
    higher = int((traces[:, -1] > traces[:, 0]).sum())
    if higher:
        fail(f"{higher} GPS final returns above their initial value")

    # the scan engine on the first instances: instances are independent in the
    # lockstep batch, so the first iterations of the full run are theirs; the
    # JAX package's own device tolerance (tests/test_tpu.py:62)
    for w in wrappers.values():
        w.launches = 0
    _, scan_traces = solver("scan", GPS_ITER_SCAN)(mu0s[:N_GPS_SCAN], sigma0s[:N_GPS_SCAN],
                                                     kff_init=kff0[:N_GPS_SCAN])
    torch.cuda.synchronize()
    if any(w.launches for w in wrappers.values()):
        fail("the scan engine launched a kernel")
    got, want = traces[:N_GPS_SCAN, :GPS_ITER_SCAN + 1].double(), scan_traces.double()
    excess = ((got - want).abs() - (1e-4 + 1e-4 * want.abs())).max().item()
    rel = ((got - want).abs() / want.abs()).max().item()
    accepted = (traces[:, 1:] != traces[:, :-1]).double().mean().item()
    log(json.dumps({"gps_mean_initial_return": traces[:, 0].double().mean().item(),
                    "gps_mean_final_return": traces[:, -1].double().mean().item(),
                    "accepted_share": accepted, "cuda_vs_scan_max_rel": rel,
                    "tol": "rtol 1e-4, atol 1e-4"}))
    if excess > 0:
        fail(f"GPS cuda and scan traces differ beyond rtol/atol 1e-4 (rel {rel:.3e})")

    # timings: one outer iteration from the initial state, one dual evaluation
    # (the α plane, K6, K7) on that state's packed operands
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    init_ms = time_cuda(lambda: solve.init(mu0s, sigma0s, kff_init=kff0), 2)
    iter_ms = time_cuda(lambda: solve.iteration(state0), 3)
    packed = pack_gps(state0.cost, state0.dyn, state0.ctl, mu0s, sigma0s)
    mid = torch.zeros(N_GPS, **kw)

    def dual_eval():
        from trajopt_torch.core.cuda_gps import (
            cuda_gps_backward_packed,
            cuda_gps_forward_kl_packed,
        )

        alpha_l = pack_gps_alpha((10.0 ** mid)[:, None].expand(N_GPS, T_GPS))
        K_l, kff_l, sigc_l, *_ = cuda_gps_backward_packed(packed, alpha_l)
        return cuda_gps_forward_kl_packed(packed, K_l, kff_l, sigc_l)

    dual_ms = time_cuda(dual_eval, 50)

    # K6 and K7 on the path's own launches: the 64 of each in one outer
    # iteration from the initial state, kept and replayed back to back
    import trajopt_torch.parallel.gps as gps_module

    kept, originals = kept_launches(
        {"K6": (gps_module, "cuda_gps_backward_packed"),
         "K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    for k in ("K6", "K7"):
        if len(kept[k]) != GPS_BISECT:
            fail(f"one GPS outer iteration launched {k} {len(kept[k])} times, not {GPS_BISECT}")
    path_ms = replay_ms(kept, originals)
    del kept
    log(json.dumps({"metric": "gps_kernels_solver_path", "config": "one outer iteration from "
                    f"the initial state, T={T_GPS} N={N_GPS} dx=2 du=1 float32",
                    "spread": {k: spread(v) for k, v in path_ms.items()},
                    "ms_per_launch": path_ms, "gpu": card}))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve.iteration(state0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # the solver's phase annotations show on the device timeline too: count
    # kernels and copies only
    on_device = [e for e in events
                 if e.device_type == DeviceType.CUDA and not e.key.startswith("gps.")]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    kern_ms = {k: sum(e.self_device_time_total for e in on_device if name in e.key) / 1e3
               for k, name in (("K6", "gps_backward_kernel"), ("K7", "gps_forward_kl_kernel"))}
    calls = {name: sum(e.count for e in events if e.key == name)
             for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    spans = {e.key: e.cpu_time_total / 1e3 for e in events
             if e.key.startswith("gps.") and e.device_type == DeviceType.CPU}
    log(json.dumps({
        "metric": "gps_solver", "config": f"Pendulum-TO-v0 dt=0.05 T={T_GPS} N={N_GPS} "
        f"nb_iter={GPS_ITER} bisect_iters={GPS_BISECT} kl_bound=2.0 action_penalty=1e-5 "
        "engine=cuda float32",
        "ms_per_outer_iteration": iter_ms, "ms_init": init_ms, "ms_per_dual_evaluation": dual_ms,
        "dual_evaluations_per_s": 1e3 / dual_ms,
        "instance_iterations_per_s": N_GPS * 1e3 / iter_ms,
        "launches_per_outer_iteration": {k: launches[k] / GPS_ITER for k in ("K6", "K7")},
        "first_solve_s": first_s, "gpu": card}))
    log(json.dumps({
        "metric": "gps_iteration_profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "k6_device_ms": kern_ms["K6"],
        "k7_device_ms": kern_ms["K7"],
        "host_or_other_ms": wall_ms - kern_ms["K6"] - kern_ms["K7"],
        "device_events": sum(e.count for e in on_device), "host_calls": calls,
        "host_ms_by_phase": spans,
        "top_self_cpu_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top],
        "gpu": card}))
    alpha_l = pack_gps_alpha(torch.ones(N_GPS, T_GPS, **kw))
    return packed, alpha_l, launches, path_ms


def check_k6_exact(packed):
    """K6 in float32 on the first K6_EXACT_N instances of the solver path's
    first dual operands, α ∈ K6_EXACT_ALPHAS in turn, against its plain
    version on the same card: K, kff, Σ_ctl, V₀ and v₀ equal (NaN in the same
    places), the flags equal, and c₀ within K6_EXACT_C0_TOL of the largest
    entry."""
    from trajopt_torch.core import cuda_gps

    n = K6_EXACT_N
    part = {k: v[..., :n].contiguous() for k, v in packed.items()}
    T = part["cx"].shape[0]
    alphas = torch.tensor(K6_EXACT_ALPHAS, dtype=torch.float32)
    alpha_l = cuda_gps.pack_gps_alpha(alphas[torch.arange(n) % len(alphas)][:, None]
                                      .expand(n, T).contiguous()).to(part["cx"].device)
    log(f"K6 check: float32, exact, the solver path's first dual operands, N={n}, T={T}, "
        f"α ∈ {K6_EXACT_ALPHAS}, against the plain version")
    got = [t.cpu() for t in cuda_gps.cuda_gps_backward_packed(part, alpha_l)]
    ref = [t.cpu() for t in cuda_gps.gps_backward_plain(part, alpha_l)]
    for name, g, r in zip(("K", "kff", "sigma_ctl", "V0", "v0"), got, ref):
        same_bits(f"K6 exact {name}", g, r)
    same_flags("K6 exact bad", got[6], ref[6])
    g, r = got[5].double(), ref[5].double()
    if not torch.equal(torch.isfinite(g), torch.isfinite(r)):
        fail("K6 exact c0: non-finite entries in other places")
    fin = torch.isfinite(r)
    err = (g[fin] - r[fin]).abs().max().item() if bool(fin.any()) else 0.0
    scale = max(r[fin].abs().max().item() if bool(fin.any()) else 0.0, 1e-30)
    log(f"  K6 exact c0: max_abs_err={err:.3e} max_rel_err={err / scale:.3e} "
        f"(tol {K6_EXACT_C0_TOL:.0e}), {int(ref[6].sum())} of {n} flagged")
    if not err / scale <= K6_EXACT_C0_TOL:
        fail(f"K6 exact c0: relative error {err / scale:.3e} above {K6_EXACT_C0_TOL:.0e}")


def check_k7_exact(packed):
    """K7 in float32 on the first K6_EXACT_N instances of the solver path's
    first dual operands, on K6's controller there (α ∈ K6_EXACT_ALPHAS in
    turn), against its plain version on the same card: μ_T and Σ_T equal
    (NaN in the same places), the KL sum within K7_EXACT_KL_TOL of the
    largest entry, non-finite in the same places."""
    from trajopt_torch.core import cuda_gps

    n = K6_EXACT_N
    part = {k: v[..., :n].contiguous() for k, v in packed.items()}
    T = part["cx"].shape[0]
    alphas = torch.tensor(K6_EXACT_ALPHAS, dtype=torch.float32)
    alpha_l = cuda_gps.pack_gps_alpha(alphas[torch.arange(n) % len(alphas)][:, None]
                                      .expand(n, T).contiguous()).to(part["cx"].device)
    log(f"K7 check: float32, exact, the solver path's first dual operands, N={n}, T={T}, "
        f"α ∈ {K6_EXACT_ALPHAS}, on K6's controller, against the plain version")
    ctl = cuda_gps.cuda_gps_backward_packed(part, alpha_l)[:3]
    got = [t.cpu() for t in cuda_gps.cuda_gps_forward_kl_packed(part, *ctl)]
    ref = [t.cpu() for t in cuda_gps.gps_forward_kl_plain(part, *ctl)]
    for name, g, r in zip(("muT", "sigmaT"), got[1:], ref[1:]):
        same_bits(f"K7 exact {name}", g, r)
    g, r = got[0].double(), ref[0].double()
    if not torch.equal(torch.isfinite(g), torch.isfinite(r)):
        fail("K7 exact kl: non-finite entries in other places")
    fin = torch.isfinite(r)
    err = (g[fin] - r[fin]).abs().max().item() if bool(fin.any()) else 0.0
    scale = max(r[fin].abs().max().item() if bool(fin.any()) else 0.0, 1e-30)
    log(f"  K7 exact kl: max_abs_err={err:.3e} max_rel_err={err / scale:.3e} "
        f"(tol {K7_EXACT_KL_TOL:.0e}), {int((~fin).sum())} of {n} not finite")
    if not err / scale <= K7_EXACT_KL_TOL:
        fail(f"K7 exact kl: relative error {err / scale:.3e} above {K7_EXACT_KL_TOL:.0e}")


def gps_mpc_phase(device, card, wrappers):
    """The GPS-MPC farm through run_gps_mpc_batch (batched, engine="cuda"):
    finite costs, K6/K7 launched; the first episodes' first steps against the
    scan engine on the same draws; control steps/s."""
    import trajopt_torch
    from trajopt_torch.parallel.gps import (
        gps_mpc_draws,
        make_gps_mpc_runner_batched,
        run_gps_mpc_batch,
    )

    env = trajopt_torch.make("Pendulum-TO-v0", dt=0.05)
    kw = dict(dtype=torch.float32, device=device)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    data = run_gps_mpc_batch(env, torch.Generator(device=device).manual_seed(0),
                             GPS_MPC_EPISODES, GPS_MPC_HORIZON, GPS_MPC_STEPS,
                             nb_iter=GPS_MPC_ITER, bisect_iters=GPS_BISECT, batched=True,
                             engine="cuda", **GPS_KW, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    per_step = GPS_MPC_ITER * GPS_BISECT
    log(json.dumps({"gps_mpc_launches": launches, "per_control_step": per_step}))
    for k in ("K6", "K7"):
        if launches[k] != GPS_MPC_STEPS * per_step:
            fail(f"the GPS-MPC farm launched {k} {launches[k]} times, not "
                 f"{GPS_MPC_STEPS} x {per_step}")
    if not (bool(torch.isfinite(data["c"]).all()) and bool(torch.isfinite(data["x"]).all())):
        fail("non-finite GPS-MPC states or costs")

    x0s, kff, noise = gps_mpc_draws(env, torch.Generator(device=device).manual_seed(0),
                                    GPS_MPC_EPISODES, GPS_MPC_HORIZON, GPS_MPC_STEPS, **kw)
    if not torch.equal(x0s, data["x"][:, 0]):
        fail("the GPS-MPC draws were not reproduced")
    E, S = GPS_MPC_CHECK_EPISODES, GPS_MPC_CHECK_STEPS
    run = make_gps_mpc_runner_batched(env, GPS_MPC_HORIZON, S, nb_iter=GPS_MPC_ITER,
                                      bisect_iters=GPS_BISECT, engine="scan", **GPS_KW, **kw)
    states, actions, costs = run(x0s[:E], kff_init=kff[:E, :S], noise=noise[:E, :S])
    torch.cuda.synchronize()
    # float32 through the closed loop: the bisection of either engine may
    # settle a few ulps apart; the solver path's tolerance
    worst = 0.0
    for name, a, b in (("states", data["x"][:E, :S + 1], states),
                       ("actions", data["u"][:E, :S], actions),
                       ("costs", data["c"][:E, :S], costs)):
        a, b = a.double(), b.double()
        excess = ((a - b).abs() - (1e-4 + 1e-4 * b.abs())).max().item()
        worst = max(worst, ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item())
        if excess > 0:
            fail(f"GPS-MPC {name}: cuda and scan differ beyond rtol/atol 1e-4")
    returns = data["c"].double().sum(dim=1)
    log(json.dumps({
        "metric": "gps_mpc", "config": f"Pendulum-TO-v0 dt=0.05 episodes={GPS_MPC_EPISODES} "
        f"horizon={GPS_MPC_HORIZON} steps={GPS_MPC_STEPS} nb_iter={GPS_MPC_ITER} kl_bound=2.0 "
        "action_penalty=1e-5 batched=True engine=cuda float32",
        "control_steps_per_s": GPS_MPC_STEPS / secs,
        "episode_steps_per_s": GPS_MPC_EPISODES * GPS_MPC_STEPS / secs, "seconds": secs,
        "mean_return": returns.mean().item(), "std_return": returns.std().item(),
        "cuda_vs_scan_max_rel": worst, "checked": f"{E} episodes x {S} steps",
        "gpu": card}))


# --------------------------------------------------------------------------------------
# Belief space: kernels K8 (belief backward), K9 (single-launch solve) and
# K10 (single-launch episode), the batched solver, the belief-MPC episode
# --------------------------------------------------------------------------------------


def k8_operations(T, b, a, reg):
    """Operations of one K8 launch for one instance, counted from
    csrc/belief.cu (one per add, multiply, divide, compare, square root or
    negation): per step the value blocks (SF, SG, C, D, Eᵀ), the three
    linear channels (c, d, e: the b²-row blocks against τ and vec S), the
    regularization, the guarded a×a Cholesky with its b+1 solves, dS and the
    value update (s, S)."""
    mv = lambda n, k: _mm_ops(n, k, 1)  # noqa: E731
    bb = b * b
    blocks = (2 * _mm_ops(b, b, b) + 2 * _mm_ops(b, b, a) + _mm_ops(a, b, a)
              + b * b + b * a + a * a)
    channels = (mv(b, b) + 2 * mv(b, bb) + 4 * b + mv(a, b) + 2 * mv(a, bb) + 4 * a
                + 2 * mv(bb, bb) + 3 * bb)
    regularize = a if reg == 1 else 2 * b * a + _mm_ops(a, b, a) + _mm_ops(b, b, a) + a * a
    factor = 2 * a * a + _chol_ops(a) + (b + 1) * (2 * a * a + a)
    value = (mv(a, a) + 4 * a + 3 * mv(b, a) + 3 * b + _mm_ops(a, a, b)
             + 2 * _mm_ops(b, a, b) + 5 * bb)
    return T * (blocks + channels + regularize + factor + value)


# Operations per step of K9/K10 at LightDark's dims (b = a = 2, one
# observation of 2), counted from csrc/bsp.cu as above: the scalar EKF step
# about 276 (dynamics with its Jacobian 44, the predicted covariance 34, the
# innovation and its inverse 64, gain and W 48, the Joseph update 82); the
# expansion differentiates it over 8 tangents, an add 9 and a multiply 25
# operations on such a dual, so about 7,000 per step with the dynamics' inner
# Jacobian; a ladder trial's backward step about 400; a rollout step about 310
# (the tracking action, the cost, the EKF step); the decisions between phases
# about 300 per iteration; the episode's own noisy step and EKF update about
# 600 per control step.
BSP_OPS = dict(ekf=276, expand=7000, trial=400, rollout=310, decide=300, episode_step=600)


def k9_operations(T, nA, solves, worked):
    """Operations of ``solves`` solves (K9; K10 adds its own step): the
    initial rollouts of each and the ``worked`` iterations (those that ran
    before a solve was done), the 16 ladder trials in each."""
    from trajopt_torch.core.cuda_bsp import NL

    o = BSP_OPS
    rollouts = nA * (T + 1) * o["rollout"]
    return solves * rollouts + worked * (T * o["expand"] + NL * T * o["trial"] + rollouts
                                         + o["decide"])


def belief_problem(N, T, b, a, seed, dtype, device, bad=False):
    """Random batched belief expansions (the recipe of
    tests/belief_fixtures.py): SPD Q and R, near-identity F, Y, U; with
    ``bad``, instance 0's R negated so its regularized action Hessian is not
    positive definite."""
    from trajopt_torch.core.belief import BeliefCostExpansion, BeliefDynamicsExpansion

    rng = np.random.default_rng(seed)
    bb = b * b

    def spd(d, shape, s):
        M = rng.standard_normal(shape + (d, d))
        return s * np.einsum("...ij,...kj->...ik", M, M) + d * np.eye(d)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    R = spd(a, (N, T + 1), 1.0)
    if bad:
        R[0] = -R[0]
    n = rng.standard_normal
    cost = BeliefCostExpansion(Q=t(spd(b, (N, T + 1), 0.1)), q=t(n((N, T + 1, b))), R=t(R),
                               r=t(n((N, T + 1, a))), P=t(0.01 * n((N, T + 1, b, a))),
                               p=t(n((N, T + 1, bb))))
    dyn = BeliefDynamicsExpansion(
        F=t(np.eye(b) + 0.05 * n((N, T, b, b))), G=t(0.2 * n((N, T, b, a))),
        X=t(0.05 * n((N, T, bb, b))), Y=t(0.9 * np.eye(bb) + 0.02 * n((N, T, bb, bb))),
        Z=t(0.05 * n((N, T, bb, a))), T=t(0.05 * n((N, T, bb, b))),
        U=t(0.8 * np.eye(bb) + 0.02 * n((N, T, bb, bb))), V=t(0.05 * n((N, T, bb, a))))
    return cost, dyn


def bench_belief_problem(T, N, device):
    """float32 operands built the way bench.py::bench_bsp_backward_batched
    builds them: one problem of bench.py::_belief_problem (numpy, seed 5)
    broadcast over the batch, q decorrelated by 0.01·N(0, 1) (a seeded torch
    generator where the bench draws with JAX), λ = 0.1."""
    from trajopt_torch.core.belief import BeliefCostExpansion, BeliefDynamicsExpansion

    rng = np.random.default_rng(5)
    b = a = 2

    def spd(d, n, s=1.0):
        M = rng.standard_normal((n, d, d))
        return s * np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    n = rng.standard_normal
    one_cost = dict(Q=spd(b, T + 1), q=n((T + 1, b)), R=spd(a, T + 1, 0.5), r=n((T + 1, a)),
                    P=0.1 * n((T + 1, b, a)), p=n((T + 1, b * b)))
    one_dyn = dict(F=np.eye(b) + 0.05 * n((T, b, b)), G=0.1 * n((T, b, a)),
                   X=0.01 * n((T, b * b, b)), Y=0.01 * n((T, b * b, b * b)),
                   Z=0.01 * n((T, b * b, a)), T=0.01 * n((T, b * b, b)),
                   U=0.01 * n((T, b * b, b * b)), V=0.01 * n((T, b * b, a)))
    kw = dict(dtype=torch.float32, device=device)

    def batch(x):
        return torch.as_tensor(x, **kw).expand(N, *x.shape).contiguous()

    gen = torch.Generator(device=device).manual_seed(0)
    cost = {k: batch(v) for k, v in one_cost.items()}
    cost["q"] = cost["q"] + 0.01 * torch.randn(cost["q"].shape, generator=gen, **kw)
    return (BeliefCostExpansion(**cost), BeliefDynamicsExpansion(**{k: batch(v) for k, v in
                                                                     one_dyn.items()}),
            torch.full((N,), 0.1, **kw))


def check_k8_case(label, packed, lam, reg, tol, flagged):
    """K8 against its plain version: the instances the guard never touched
    within ``tol`` of the largest entry, the flags equal (and ``flagged`` of
    them set, when given), the flagged instances' finite entries in the same
    places."""
    from trajopt_torch.core import cuda_belief

    out = cuda_belief.cuda_bsp_backward_packed(packed, lam, reg)
    ref = cuda_belief.bsp_backward_plain(packed, lam, reg)
    torch.cuda.synchronize()
    same_flags(f"K8 {label} diverged", out[6], ref[6])
    if flagged is not None and int(out[6].sum()) != flagged:
        fail(f"K8 {label}: {int(out[6].sum())} instances flagged, not {flagged}")
    good = ~out[6]
    errs = []
    for name, a, b in zip(("K", "kff", "S", "s", "tau", "dS"), out, ref):
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            fail(f"K8 {label} {name}: non-finite entries in other places")
        errs.append(errors(f"K8 {label} {name}", a[..., good], b[..., good], tol))
    return errs[0]


def check_k8_exact(packed, lam):
    """K8 in float32 on the first K8_EXACT_N instances of ``packed`` with
    their λ, reg 1 and 2, against its plain version on the same card:
    every output equal (NaN in the same places), the flags equal."""
    from trajopt_torch.core import cuda_belief

    n = K8_EXACT_N
    part = {k: v[..., :n].contiguous() for k, v in packed.items()}
    lam = lam[:n].contiguous()
    for reg in (1, 2):
        log(f"K8 check: float32, exact, the batched solver's first backward operands, N={n}, "
            f"T={part['q'].shape[0]}, reg={reg}, against the plain version")
        got = [t.cpu() for t in cuda_belief.cuda_bsp_backward_packed(part, lam, reg)]
        ref = [t.cpu() for t in cuda_belief.bsp_backward_plain(part, lam, reg)]
        for name, g, r in zip(("K", "kff", "S", "s", "tau", "dS"), got, ref):
            same_bits(f"K8 exact reg={reg} {name}", g, r)
        same_flags(f"K8 exact reg={reg} diverged", got[6], ref[6])


def check_k8(device):
    """K8 against its plain version: float64 at small sizes for (b, a) = (2,
    2) and (4, 2), reg ∈ {1, 2}, λ alternating 0 and 3.7, instance 0 not
    positive definite; float32 at the bench's backward shape."""
    from trajopt_torch.core.cuda_belief import pack_belief

    # the same IEEE operations in the same order (-fmad=false): rounding only
    log("K8 checks: float64, N=37, T=9, (b, a) ∈ {(2, 2), (4, 2)}, λ ∈ {0, 3.7}, tolerance 1e-12")
    lam = torch.as_tensor(np.where(np.arange(37) % 2, 3.7, 0.0), dtype=torch.float64,
                          device=device)
    for b in (2, 4):
        for reg in (1, 2):
            cost, dyn = belief_problem(37, 9, b, 2, b + reg, torch.float64, device, bad=True)
            check_k8_case(f"f64 b={b} reg={reg}", pack_belief(cost, dyn), lam, reg, 1e-12, 1)
    log(f"K8 checks: float32 at the bench's shape, T={T_BSP}, N={N_BSP}, b=a=2, λ=0.1, "
        "tolerance 1e-4")
    cost, dyn, lam = bench_belief_problem(T_BSP, N_BSP, device)
    packed = pack_belief(cost, dyn)
    err = check_k8_case(f"f32 T={T_BSP} N={N_BSP}", packed, lam, 1, 1e-4, 0)
    return packed, lam, err


def k8_row(label, packed, lam, launches, err, card, path_ms=None):
    from trajopt_torch.core import cuda_belief

    T, b, N = packed["q"].shape
    a = packed["r"].shape[1]
    out = cuda_belief.cuda_bsp_backward_packed(packed, lam, 1)
    moved = nbytes(*packed.values(), lam, *out)
    ops = N * k8_operations(T, b, a, 1)
    call = lambda: cuda_belief.cuda_bsp_backward_packed(packed, lam, 1)  # noqa: E731
    device_ms, enqueue_ms, _ = device_ms_back_to_back(call, 20)
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    row = {
        "name": "K8 bsp_backward", "route": "cuda", "source": "trajopt_torch/csrc/belief.cu",
        "replaces": "trajopt_tpu/core/pallas_belief.py:54", "launches": launches,
        "max_abs_err": err, "ms": device_ms, "call_ms": time_cuda(call, 20),
        "plain_ms": time_cuda(lambda: cuda_belief.bsp_backward_plain(packed, lam, 1), 1),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # no single PyTorch call computes a belief-value recursion
        "library_ms": None,
    }
    if path_ms is not None:
        row["ms_main_path"] = spread(path_ms)
    log(json.dumps({"metric": "kernel", "shape": f"{label}, T={T} N={N} b={b} a={a}", **row,
                    "enqueue_ms_per_call": enqueue_ms / 20, "bytes": moved, "operations": ops,
                    "bytes_ms": bytes_ms, "ops_ms": ops_ms, "gpu": card}))
    return row


def bsp_path(device):
    """The batched BSP solver path's problem: LightDark-TO-v0 from seeded
    initial means, the env's Σ₀; returns (env, solver(engine), μ₀s, Σ₀s),
    float32 on ``device``, BSP_ITER iterations at T_BSP, N_BSP."""
    import trajopt_torch
    from trajopt_torch.parallel.bsp import make_bsp_solver_batched

    env = trajopt_torch.make("LightDark-TO-v0")
    kw = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(9)
    mu0, sigma0 = env.init()
    mu0s = torch.as_tensor(mu0.numpy() + 0.5 * rng.standard_normal((N_BSP, 2)), **kw)
    sigma0s = sigma0.to(**kw).expand(N_BSP, 2, 2).contiguous()

    def solver(engine):
        return make_bsp_solver_batched(env, T_BSP, nb_iter=BSP_ITER, engine=engine, **kw)

    return env, solver, mu0s, sigma0s


def bsp_solver_phase(device, card, wrappers):
    """make_bsp_solver_batched with engine="cuda" on LightDark at N=4096,
    T=25, 10 iterations: the K8 launches, finite traces, the scan engine on
    the first 64 instances; ms per outer iteration; the first iteration's K8
    operands."""
    import trajopt_torch.parallel.bsp as bsp_module
    from trajopt_torch.core.cuda_belief import pack_belief

    env, solver, mu0s, sigma0s = bsp_path(device)
    solve = solver("cuda")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    # the solve's own K8 launches, kept (operands by reference) to be replayed
    out = []
    kept, originals = kept_launches({"K8": (bsp_module, "cuda_bsp_backward_packed")},
                                    lambda: out.append(solve(mu0s, sigma0s)))
    first_s = time.perf_counter() - t0
    state, trace = out[0]
    launches = {k: w.launches for k, w in wrappers.items()}
    log(json.dumps({"bsp_solver_launches": launches, "lambda_trials": solve.trials,
                    "first_solve_s": first_s}))
    if launches["K8"] != solve.trials or solve.trials < BSP_ITER:
        fail(f"the batched BSP solver launched K8 {launches['K8']} times for its "
             f"{solve.trials} λ trials in {BSP_ITER} iterations")
    if any(v for k, v in launches.items() if k != "K8"):
        fail("the batched BSP solver launched another kernel than K8")
    if not bool(torch.isfinite(trace).all()):
        fail("non-finite batched BSP traces")

    # the scan engine (no kernel) on the first instances: instances are
    # independent, so the full run's first 64 are theirs; the JAX package's
    # own device tolerance (tests/test_tpu.py:62)
    for w in wrappers.values():
        w.launches = 0
    _, scan_trace = solver("scan")(mu0s[:N_BSP_SCAN], sigma0s[:N_BSP_SCAN])
    torch.cuda.synchronize()
    if any(w.launches for w in wrappers.values()):
        fail("the scan engine launched a kernel")
    got, want = trace[:, :N_BSP_SCAN].double(), scan_trace.double()
    excess = ((got - want).abs() - (1e-4 + 1e-4 * want.abs())).max().item()
    rel = ((got - want).abs() / want.abs()).max().item()
    ret0 = solve.init(mu0s, sigma0s).last_return
    log(json.dumps({"bsp_mean_initial_return": ret0.double().mean().item(),
                    "bsp_mean_final_return": trace[-1].double().mean().item(),
                    "done": int(state.done.sum()), "cuda_vs_scan_max_rel": rel,
                    "tol": "rtol 1e-4, atol 1e-4"}))
    if excess > 0:
        fail(f"batched BSP cuda and scan traces differ beyond rtol/atol 1e-4 (rel {rel:.3e})")

    state0 = solve.init(mu0s, sigma0s)
    iter_ms = time_cuda(lambda: solve.iteration(state0), 3)
    log(json.dumps({
        "metric": "bsp_solver", "config": f"LightDark-TO-v0 T={T_BSP} N={N_BSP} "
        f"nb_iter={BSP_ITER} engine=cuda float32", "ms_per_outer_iteration": iter_ms,
        "instance_iterations_per_s": N_BSP * 1e3 / iter_ms,
        "k8_launches_per_outer_iteration": launches["K8"] / BSP_ITER,
        "first_solve_s": first_s, "gpu": card}))
    path_ms = replay_ms(kept, originals)["K8"]
    del kept
    log(json.dumps({"metric": "bsp_kernel_solver_path", "config": f"one solve, {BSP_ITER} "
                    f"iterations, T={T_BSP} N={N_BSP} b=a=2 float32", "spread": spread(path_ms),
                    "ms_per_launch": path_ms, "gpu": card}))
    from trajopt_torch.core.belief import belief_cost_expansion, belief_dynamics_expansion

    dyn = belief_dynamics_expansion(env, state0.bref_mu[:, :T_BSP], state0.bref_sigma[:, :T_BSP],
                                    state0.uref)
    cost = belief_cost_expansion(env, state0.bref_mu, state0.bref_sigma, state0.uref)
    return pack_belief(cost, dyn), state0.lmbda.contiguous(), launches["K8"], path_ms


class PlainBSP:
    """K9's plain version (parallel/bsp's solver with the ladder engine, a
    batch of one), counting the iterations that ran before each solve was
    done: the work the bound counts."""

    def __init__(self, env, cfg, device, dtype):
        from trajopt_torch.core.cuda_bsp import plain_solver

        self.solver = plain_solver(env, cfg, device, dtype)
        self.nb_iter, self.worked = cfg.nb_iter, 0

    def __call__(self, mu0, sigma0):
        from trajopt_torch.parallel.bsp import BSPState

        state = self.solver.init(mu0[None], sigma0[None])
        trace = []
        for _ in range(self.nb_iter):
            if not bool(state.done.all()):
                state = self.solver.iteration(state)
                self.worked += 1
            trace.append(state.last_return)
        return BSPState(*(x[0] for x in state)), torch.stack(trace)[:, 0]


def check_k9(device):
    """K9 against its plain version at horizon 25, 10 iterations: the
    default, reg=2 and goal weights mu_w=(-2, -2) (an indefinite value that
    drives the λ ladder), float64 and float32."""
    import trajopt_torch
    from trajopt_torch.core.cuda_bsp import bsp_config, cuda_bsp_solve

    out = {}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        # float64: the kernel's expansion (dual numbers) and the plain
        # version's (torch.func) round differently, 10 iterations of it;
        # float32: the same, and the jitters and the ladder's first-success
        # choice make the solve sensitive to rounding (observed 4e-5)
        log(f"K9 checks: {dtype}, T={T_BSP}, nb_iter={BSP_ITER}, tolerance {tol:.0e}")
        for label, env_kw, kw in (("default", {}, {}), ("reg=2", {}, {"reg": 2}),
                                  ("mu_w=(-2,-2)", {"mu_w": (-2.0, -2.0)}, {})):
            env = trajopt_torch.make("LightDark-TO-v0", **env_kw)
            cfg = bsp_config(env, T_BSP, BSP_ITER, **kw)
            mu0, sigma0 = (v.to(dtype=dtype, device=device) for v in env.init())
            state, trace = cuda_bsp_solve(env, cfg, mu0, sigma0)
            plain = PlainBSP(env, cfg, device, dtype)
            t0 = time.perf_counter()
            pstate, ptrace = plain(mu0, sigma0)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            errs = [errors(f"K9 {dtype} {label} {f}", getattr(state, f), getattr(pstate, f), tol)
                    for f in ("bref_mu", "bref_sigma", "uref", "K", "kff", "lmbda", "dlmbda",
                              "last_return")]
            errors(f"K9 {dtype} {label} trace", trace, ptrace, tol)
            if bool(state.done) != bool(pstate.done):
                fail(f"K9 {dtype} {label}: done differs")
            out[(dtype, label)] = dict(err=errs[2], plain_ms=plain_ms, worked=plain.worked,
                                       cfg=cfg, env=env, mu0=mu0, sigma0=sigma0)
    return out


def k9_phase(device, card, wrappers, checks):
    """The single-launch solve as a user calls it (make_cuda_bsp_solve from
    the env's initial belief, float32, horizon 25, 10 iterations): the K9
    launch, its device time and bound."""
    import trajopt_torch
    from trajopt_torch.core.cuda_bsp import make_cuda_bsp_solve

    env = trajopt_torch.make("LightDark-TO-v0")
    solve = make_cuda_bsp_solve(env, T_BSP, BSP_ITER)
    mu0, sigma0 = (v.to(dtype=torch.float32, device=device) for v in env.init())
    for w in wrappers.values():
        w.launches = 0
    state, trace = solve(mu0, sigma0)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    if launches["K9"] != 1 or any(v for k, v in launches.items() if k != "K9"):
        fail(f"make_cuda_bsp_solve launched {launches}, not K9 once")
    if not bool(torch.isfinite(trace).all()) or not trace[-1] < trace[0]:
        fail(f"K9 trace {trace.tolist()} is not finite and decreasing")
    c = checks[(torch.float32, "default")]
    nA = len(c["cfg"].alphas)
    call = lambda: solve(mu0, sigma0)  # noqa: E731
    device_ms, enqueue_ms, _ = device_ms_back_to_back(call, 20)
    ops = k9_operations(T_BSP, nA, 1, c["worked"])
    moved = nbytes(mu0, sigma0, *state[:5], trace) + 4 * 4
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    row = {
        "name": "K9 bsp_solve", "route": "cuda", "source": "trajopt_torch/csrc/bsp.cu",
        "replaces": "trajopt_tpu/core/pallas_bsp.py:982", "launches": launches["K9"],
        "max_abs_err": c["err"], "ms": device_ms, "call_ms": time_cuda(call, 20),
        "plain_ms": c["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # no single PyTorch call computes a BSP-iLQR solve
        "library_ms": None,
    }
    log(json.dumps({"metric": "kernel", "shape": f"LightDark T={T_BSP} nb_iter={BSP_ITER} "
                    f"(iterations worked {c['worked']}) batch 1, one block of 128 threads",
                    **row, "enqueue_ms_per_call": enqueue_ms / 20, "bytes": moved,
                    "operations": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                    "final_return": trace[-1].item(), "gpu": card}))
    return row


def bsp_episode_phase(device, card, wrappers):
    """The light-dark MPC episode: K10 against its plain version and the scan
    runner on the same normals in float64 over 3 steps; the scan runner's
    rate in float32 over 3 steps; then bench.py:447's episode (horizon 25, 50
    steps, 10 iterations, float32) with engine="auto", which must resolve to
    K10, held against its plain version over all 50 steps; its rate, device
    time and bound."""
    import trajopt_torch
    from trajopt_torch.core import cuda_bsp
    from trajopt_torch.parallel.bsp import (
        bsp_episode_normals,
        make_bsp_mpc_runner,
        run_bsp_episode,
    )

    env = trajopt_torch.make("LightDark-TO-v0")
    S = BSP_CHECK_STEPS
    k64 = dict(dtype=torch.float64, device=device)
    x0 = env.reset_state().to(**k64)
    normals = bsp_episode_normals(env, torch.Generator(device=device).manual_seed(1), S, **k64)
    out = make_bsp_mpc_runner(env, T_BSP, S, nb_iter=BSP_ITER, engine="cuda", **k64)(
        x0, normals=normals)
    cfg = cuda_bsp.bsp_config(env, T_BSP, BSP_ITER, S)
    plain = cuda_bsp.bsp_episode_plain(env, cfg, x0, *normals)
    scan = make_bsp_mpc_runner(env, T_BSP, S, nb_iter=BSP_ITER, engine="scan", **k64)(
        x0, normals=normals)
    torch.cuda.synchronize()
    # float64: the kernel's and the plain version's expansions round
    # differently (1e-15); the scan runner's λ while-loop against the ladder
    # likewise
    log(f"K10 checks: float64, horizon {T_BSP}, {S} steps, nb_iter={BSP_ITER}, tolerance 1e-9")
    for name, a, p_, s in zip(("states", "belief means", "belief covariances", "actions",
                               "costs"), out, plain, scan):
        errors(f"K10 {name} vs plain", a, p_, 1e-9)
        errors(f"K10 {name} vs scan runner", a, s, 1e-9)

    kw = dict(dtype=torch.float32, device=device)
    x0 = env.init()[0].to(**kw)            # bench.py:447 starts the true state at μ₀
    run_scan = make_bsp_mpc_runner(env, T_BSP, S, nb_iter=BSP_ITER, engine="scan", **kw)
    short = bsp_episode_normals(env, torch.Generator(device=device).manual_seed(2), S, **kw)
    t0 = time.perf_counter()
    scan32 = run_scan(x0, normals=short)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0

    run = make_bsp_mpc_runner(env, T_BSP, BSP_STEPS, nb_iter=BSP_ITER, engine="auto", **kw)
    if run.engine != "cuda":
        fail(f"engine='auto' resolved to {run.engine!r} on the card, not 'cuda'")
    full = bsp_episode_normals(env, torch.Generator(device=device).manual_seed(2), BSP_STEPS,
                               **kw)
    for w in wrappers.values():
        w.launches = 0
    xs, mus, sigmas, us, cs = run(x0, normals=full)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    if launches["K10"] != 1 or any(v for k, v in launches.items() if k != "K10"):
        fail(f"the episode launched {launches}, not K10 once")
    if not all(bool(torch.isfinite(t).all()) for t in (xs, mus, sigmas, us, cs)):
        fail("non-finite belief-MPC episode")
    mu_end = mus[-1].abs().max().item()
    if not mu_end < 0.1:
        fail(f"the belief mean ended {mu_end:.3f} from the goal")
    # float32 through a closed loop, the first steps against the scan runner:
    # reported, not gated (the plain episode below holds the kernel)
    f32_rel = max(((a[:b.shape[0]].double() - b.double()).abs().max()
                   / b.double().abs().max().clamp(min=1e-30)).item()
                  for a, b in zip((xs, mus, us), (scan32[0], scan32[1], scan32[3])))

    # the same episode through K10's plain version, on the same x0 and
    # normals: the kernel's expansion (dual numbers) and the plain one
    # (torch.func) round differently, and the closed loop carries that from
    # step to step; 1e-3 of the largest entry, as for K9 in float32 (the
    # differences read are of order 1e-5 and die out between replans, no
    # ladder choice flipped)
    cfg32 = cuda_bsp.bsp_config(env, T_BSP, BSP_ITER, BSP_STEPS)
    plain32 = PlainBSP(env, cfg32, device, torch.float32)
    t0 = time.perf_counter()
    ref32 = run_bsp_episode(env, plain32, x0, full)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    log(f"K10 checks: float32, horizon {T_BSP}, {BSP_STEPS} steps, nb_iter={BSP_ITER}, "
        "tolerance 1e-3")
    err = [errors(f"K10 f32 {name} vs plain", a, p_, 1e-3)
           for name, a, p_ in zip(("states", "belief means", "belief covariances", "actions",
                                   "costs"), (xs, mus, sigmas, us, cs), ref32)][3]

    call = lambda: run(x0, normals=full)  # noqa: E731
    device_ms, enqueue_ms, _ = device_ms_back_to_back(call, 5)
    nA = len(cfg32.alphas)
    ops = (k9_operations(T_BSP, nA, BSP_STEPS, plain32.worked)
           + BSP_STEPS * BSP_OPS["episode_step"])
    moved = nbytes(x0, *full, xs, mus, sigmas, us, cs)
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    row = {
        "name": "K10 bsp_episode", "route": "cuda", "source": "trajopt_torch/csrc/bsp.cu",
        "replaces": "trajopt_tpu/core/pallas_bsp.py:1054", "launches": launches["K10"],
        "max_abs_err": err, "ms": device_ms, "call_ms": time_cuda(call, 3),
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # no single PyTorch call computes a belief-MPC episode
        "library_ms": None,
    }
    log(json.dumps({"metric": "kernel", "shape": f"LightDark horizon={T_BSP} steps={BSP_STEPS} "
                    f"nb_iter={BSP_ITER} (solver iterations worked {plain32.worked} of "
                    f"{BSP_STEPS * BSP_ITER}) batch 1", **row,
                    "enqueue_ms_per_call": enqueue_ms / 5, "bytes": moved, "operations": ops,
                    "bytes_ms": bytes_ms, "ops_ms": ops_ms, "gpu": card}))
    log(json.dumps({
        "metric": "bsp_mpc", "config": f"LightDark-TO-v0 horizon={T_BSP} steps={BSP_STEPS} "
        f"nb_iter={BSP_ITER} engine=auto->cuda float32 x0=mu0",
        "control_steps_per_s": BSP_STEPS / (device_ms / 1e3),
        "episode_ms": device_ms, "scan_runner_control_steps_per_s": S / scan_s,
        "scan_runner_steps_timed": S, "final_belief_mean": mus[-1].tolist(),
        "final_state": xs[-1].tolist(), "belief_cost_sum": cs.double().sum().item(),
        "f32_first_steps_vs_scan_max_rel": f32_rel, "gpu": card}))
    return row


# --------------------------------------------------------------------------------------
# eLQR: kernels K11-K14, the batched solver
# --------------------------------------------------------------------------------------

# Operations of the eLQR kernels, counted from csrc/elqr.cu at Cartpole's
# dims (dx=4, du=1), one per add, multiply, divide, compare, select or
# transcendental call, as OPS_PER_STEP: a sweep step is the action (9), one
# plain RK4 step (152), a dual RK4 step over 5 tangents (about 1250) and its
# affine term (40), the closed-form quadratization (about 350) and the value
# algebra with its two Gauss-Jordan inverses (about 880): about 2680; the
# terminal step is a quadratization and a re-choice (about 750); a rollout
# step the action, the stage cost and one RK4 step (182), and its end one
# stage cost (20).
ELQR_OPS = dict(step=2680, terminal=750, rollout_step=182, rollout_end=20)


def k11_operations(T, N):
    return N * T * ELQR_OPS["step"]


def k12_operations(T, N):
    return N * (T * ELQR_OPS["step"] + ELQR_OPS["terminal"])


def k13_operations(T, N):
    return N * (T * ELQR_OPS["rollout_step"] + ELQR_OPS["rollout_end"])


def k14_operations(T, N, nb_iter):
    return (nb_iter * (k11_operations(T, N) + k12_operations(T, N))
            + (nb_iter + 2) * k13_operations(T, N))


def elqr_inputs(N, T, seed, dtype, device, theta0=0.0, step=0.001):
    """bench.py:406-407's start (zero state, θ = θ₀ + step·i) and seeded
    N(0, 1) initial kff: batch-leading x0s (N, 4), kff0 (N, T, 1)."""
    x0s = torch.zeros(N, 4, dtype=dtype, device=device)
    x0s[:, 1] = theta0 + step * torch.arange(N, dtype=dtype, device=device)
    kff0 = np.random.default_rng(seed).standard_normal((N, T, 1))
    return x0s, torch.as_tensor(kff0, dtype=dtype, device=device)


def timed(fn):
    """``fn()`` and its wall ms, from an idle card to its last kernel's end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def check_elqr_sweeps(label, env, K, kff, goV, gov, x, x0, tol, traj_tol=None):
    """K11 on (K, kff, goV, gov) from the states x, K12 on K11's outputs, K13
    (stored) on K12's controller from x0, each against its plain version on
    the same operands; K13's states and actions at ``traj_tol`` when given.
    Floors: kff at umax; v, v0 and x at |V|·s, |V|·s² and s, s the largest
    |x0| (at least 1)."""
    from trajopt_torch.core import cuda_elqr as ce

    s = max(x0.abs().max().item(), 1.0)
    umax = float(env.umax[0])
    out, plain_ms, errs = {}, {}, {}
    f = ce.cuda_elqr_forward(env, K, kff, goV, gov, x)
    pf, plain_ms["K11"] = timed(lambda: ce.elqr_forward_plain(env, K, kff, goV, gov, x))
    V = pf[2].abs().max().item()
    for name, g, r, fl in zip(("iK", "ikff", "comeV", "comev", "comev0", "x_out"), f, pf,
                              (0.0, umax, 0.0, V * s, V * s * s, s)):
        errs.setdefault("K11", []).append(errors(f"K11 {label} {name}", g, r, tol, fl))
    b = ce.cuda_elqr_backward(env, f[0], f[1], f[2], f[3], f[5])
    pb, plain_ms["K12"] = timed(lambda: ce.elqr_backward_plain(env, f[0], f[1], f[2], f[3], f[5]))
    V = pb[2].abs().max().item()
    for name, g, r, fl in zip(("K", "kff", "goV", "gov", "gov0", "x_out"), b, pb,
                              (0.0, umax, 0.0, V * s, V * s * s, s)):
        errs.setdefault("K12", []).append(errors(f"K12 {label} {name}", g, r, tol, fl))
    r = ce.cuda_elqr_rollout(env, b[0], b[1], x0, store=True)
    pr, plain_ms["K13"] = timed(lambda: ce.elqr_rollout_plain(env, b[0], b[1], x0, store=True))
    log(f"  {label}: {int((pr[2].abs() >= umax).sum())} of {pr[2].numel()} rollout actions "
        "at or past ±umax")
    traj_tol = traj_tol or tol
    for name, g, p_, t in zip(("returns", "xs", "us"), r, pr, (tol, traj_tol, traj_tol)):
        errs.setdefault("K13", []).append(errors(f"K13 {label} {name}", g, p_, t))
    if not torch.equal(ce.cuda_elqr_rollout(env, b[0], b[1], x0), r[0]):
        fail(f"K13 {label}: the returns differ with and without storing")
    out["K11"] = (K, kff, goV, gov, x), f
    out["K12"] = (f[0], f[1], f[2], f[3], f[5]), b
    out["K13"] = (b[0], b[1], x0), (r[0],)
    return out, {k: max(v) for k, v in errs.items()}, plain_ms


def check_k14(label, env, kff0, x0, nb_iter, tol):
    """K14 against its plain version on the same kff0 (T, 1, N) and x0 (4,
    N); the returns' error per iteration shows where the two part."""
    from trajopt_torch.core import cuda_elqr as ce

    out = ce.cuda_elqr_solve(env, kff0, x0, nb_iter)
    ref, plain_ms = timed(lambda: ce.elqr_solve_plain(env, kff0, x0, nb_iter))
    per_iter = ((out[4] - ref[4]).abs().max(1).values
                / ref[4].abs().max(1).values.clamp(min=1e-30)).tolist()
    log(f"  K14 {label} returns' relative error per iteration: "
        f"{[float(f'{e:.2e}') for e in per_iter]}")
    umax = float(env.umax[0])
    errs = [errors(f"K14 {label} {name}", g, r, tol, fl)
            for name, g, r, fl in zip(("K", "kff", "xs", "us", "returns"), out, ref,
                                      (0.0, umax, 0.0, 0.0, 0.0))]
    return out, max(errs), plain_ms


def check_elqr_f64(device):
    """float64, N=50, T=16: K11-K13 on the second iteration's operands
    (goV ≠ 0, saturated actions) for Cartpole v0 (from the hanging start)
    and v1 (from θ = 0.3, as tests/test_torch_elqr_kernels.py), and on
    random O(1) operands for v0 (goV positive definite, |kff| ~ 8 so that
    actions saturate); K14 over 3 iterations.  1e-9 of the largest entry:
    the kernels and the plain versions do the same operations in the same
    order (-fmad=false), only the card's and the host's sin/cos may differ."""
    import trajopt_torch
    from trajopt_torch.core import cuda_elqr as ce
    from trajopt_torch.core.cuda_lqr import to_soa

    N, T = N_ELQR_SMALL, T_ELQR_SMALL
    k64 = dict(dtype=torch.float64, device=device)
    log(f"K11-K14 checks: float64, N={N}, T={T}, tolerance 1e-9")
    for name, theta0 in (("Cartpole-TO-v0", math.pi), ("Cartpole-TO-v1", 0.3)):
        env = trajopt_torch.make(name)
        x0s, kff0 = elqr_inputs(N, T, 7, torch.float64, device, theta0, 0.02)
        x0, kff = x0s.T.contiguous(), to_soa(kff0, N)
        K = torch.zeros(T, 4, N, **k64)
        goV, gov = torch.zeros(T + 1, 16, N, **k64), torch.zeros(T + 1, 4, N, **k64)
        f = ce.cuda_elqr_forward(env, K, kff, goV, gov, x0)
        b = ce.cuda_elqr_backward(env, f[0], f[1], f[2], f[3], f[5])
        log(f"  {name}: the second iteration's operands, from the kernels' first")
        check_elqr_sweeps(f"f64 {name} it2", env, b[0], b[1], b[2], b[3], b[5], x0, 1e-9)
        check_k14(f"f64 {name} nb_iter={ELQR_SMALL_ITER}", env, kff, x0, ELQR_SMALL_ITER, 1e-9)
    env = trajopt_torch.make("Cartpole-TO-v0")
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(np.stack([rng.uniform(-2, 2, N), np.pi + rng.uniform(-1, 1, N),
                                   rng.normal(size=N), rng.normal(size=N)]), **k64)
    K = torch.as_tensor(0.5 * rng.standard_normal((T, 4, N)), **k64)
    kff = torch.as_tensor(8.0 * rng.standard_normal((T, 1, N)), **k64)
    G = rng.standard_normal((T + 1, N, 4, 4))
    G = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(4)
    goV = torch.as_tensor(np.moveaxis(G.reshape(T + 1, N, 16), 1, 2).copy(), **k64)
    gov = torch.as_tensor(rng.standard_normal((T + 1, 4, N)), **k64)
    check_elqr_sweeps("f64 Cartpole-TO-v0 random operands", env, K, kff, goV, gov, x0, x0, 1e-9)


def same_solves(label, got, ref):
    """Two make_elqr_solver_batched results equal bit for bit: K, kff, xs, us
    and the trace."""
    for name, g, r in zip(("K", "kff", "xs", "us", "trace"),
                          (got[0].K, got[0].kff, *got[1:]), (ref[0].K, ref[0].kff, *ref[1:])):
        same_bits(f"{label} {name}", g, r)


def elqr_main_path_launch_ms(solve, x0s, kff0):
    """Device ms of each K11, K12 and K13 launch of one main-path solve: each
    launch's operands are kept and the launch replayed, back to back."""
    from trajopt_torch.core import cuda_elqr as ce

    kept, originals = kept_launches(
        {"K11": (ce, "cuda_elqr_forward"), "K12": (ce, "cuda_elqr_backward"),
         "K13": (ce, "cuda_elqr_rollout")}, lambda: solve(x0s, kff_init=kff0))
    return replay_ms(kept, originals)


def elqr_kernel_rows(card, launches, errs, plain_ms, operands, k14, main_ms):
    """Device time per launch (queued back to back behind a sleep), bytes,
    operations and bound of K11-K13 at the streamed engine's first-iteration
    operands (N=1024, T=100) and of K14 at the timed solve (N=64, T=100, 10
    iterations); K11/K12's device time on each launch of the main path's
    solve beside them (``main_ms``)."""
    import trajopt_torch
    from trajopt_torch.core import cuda_elqr as ce

    env = trajopt_torch.make("Cartpole-TO-v0")
    T, N = T_ELQR, N_ELQR_STREAM
    calls = {
        "K11": (lambda: ce.cuda_elqr_forward(env, *operands["K11"][0]), k11_operations(T, N)),
        "K12": (lambda: ce.cuda_elqr_backward(env, *operands["K12"][0]), k12_operations(T, N)),
        "K13": (lambda: ce.cuda_elqr_rollout(env, *operands["K13"][0]), k13_operations(T, N)),
        "K14": (lambda: ce.cuda_elqr_solve(env, *k14[0], ELQR_ITER),
                k14_operations(T, N_ELQR_FUSED, ELQR_ITER)),
    }
    moved = {k: nbytes(*ins, *outs) for k, (ins, outs) in operands.items()}
    moved["K14"] = nbytes(*k14[0], *k14[1])
    meta = {"K11": ("K11 elqr_forward", 279, f"T={T} N={N}"),
            "K12": ("K12 elqr_backward", 342, f"T={T} N={N}"),
            "K13": ("K13 elqr_rollout", 413, f"T={T} N={N}"),
            "K14": ("K14 elqr_solve", 607, f"T={T} N={N_ELQR_FUSED} nb_iter={ELQR_ITER}, "
                    f"{N_ELQR_FUSED // 4} blocks of one warp, eight lanes an instance")}
    rows = []
    for k, (call, ops) in calls.items():
        reps = 5 if k == "K14" else 20
        device_ms, enqueue_ms, _ = device_ms_back_to_back(call, reps)
        bytes_ms, ops_ms = 1e3 * moved[k] / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        name, line, shape = meta[k]
        row = {
            "name": name, "route": "cuda", "source": "trajopt_torch/csrc/elqr.cu",
            "replaces": f"trajopt_tpu/core/pallas_elqr.py:{line}", "launches": launches[k],
            "max_abs_err": errs[k], "ms": device_ms, "call_ms": time_cuda(call, reps),
            "plain_ms": plain_ms[k], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes an eLQR sweep or solve
            "library_ms": None,
        }
        if k in main_ms:
            row["ms_main_path_mean"] = sum(main_ms[k]) / len(main_ms[k])
            row["ms_main_path"] = main_ms[k]
        rows.append(row)
        log(json.dumps({"metric": "kernel", "shape": f"Cartpole-TO-v0 {shape} float32", **row,
                        "enqueue_ms_per_call": enqueue_ms / reps, "bytes": moved[k],
                        "operations": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                        "gpu": card}))
    return rows


def elqr_phases(device, card, wrappers):
    """The eLQR phases: f64 checks, f32 checks of K11-K13 at the streamed
    engine's first-iteration operands (N=1024, T=100), the main path
    (make_elqr_solver_batched, engine="auto", at N=64, 1 and 1024) with its
    launch counts, the timed f32 K14 solve held to its plain version over all
    10 iterations, both kernel engines held to the scan engine in float64,
    the timings; returns the K11-K14 rows."""
    import trajopt_torch
    from trajopt_torch.core import cuda_elqr as ce
    from trajopt_torch.core.cuda_lqr import to_soa
    from trajopt_torch.parallel.elqr import make_elqr_solver_batched

    wrappers.update(K11=ce.cuda_elqr_forward, K12=ce.cuda_elqr_backward,
                    K13=ce.cuda_elqr_rollout, K14=ce.cuda_elqr_solve)
    env = trajopt_torch.make("Cartpole-TO-v0")
    T, it = T_ELQR, ELQR_ITER
    f32 = dict(dtype=torch.float32, device=device)
    check_elqr_f64(device)

    # f32 at the streamed engine's first-iteration operands (K = 0, goV = 0)
    N = N_ELQR_STREAM
    x0s_s, kff0_s = elqr_inputs(N, T, 11, torch.float32, device)
    x0 = x0s_s.T.contiguous()
    tol32 = ELQR_F32_TOL
    log(f"K11-K13 checks: float32, first iteration at N={N}, T={T}, tolerance {tol32:.0e} "
        f"(K13's states and actions {ELQR_F32_TRAJ_TOL:.0e})")
    operands, errs, plain_ms = check_elqr_sweeps(
        "f32 first iteration", env, torch.zeros(T, 4, N, **f32), to_soa(kff0_s, N),
        torch.zeros(T + 1, 16, N, **f32), torch.zeros(T + 1, 4, N, **f32), x0, x0, tol32,
        ELQR_F32_TRAJ_TOL)

    # the main path: engine="auto" at N=64 (K14), N=1 (K14) and N=1024 (K11-K13)
    solve = make_elqr_solver_batched(env, T, it, engine="auto", **f32)
    x0s_f, kff0_f = elqr_inputs(N_ELQR_FUSED, T, 12, torch.float32, device)
    x0s_1, kff0_1 = elqr_inputs(1, T, 13, torch.float32, device)
    runs = {}
    expect = {N_ELQR_FUSED: {"K14": 1}, 1: {"K14": 1},
              N_ELQR_STREAM: {"K11": it, "K12": it, "K13": it + 2}}
    for n, (x0s, kff0) in ((N_ELQR_FUSED, (x0s_f, kff0_f)), (1, (x0s_1, kff0_1)),
                           (N_ELQR_STREAM, (x0s_s, kff0_s))):
        for w in wrappers.values():
            w.launches = 0
        out = solve(x0s, kff_init=kff0)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"eLQR main path N={n} launches: {json.dumps(launches)}")
        want = {k: expect[n].get(k, 0) for k in wrappers}
        if launches != want:
            fail(f"eLQR at N={n} launched {launches}, not {want}")
        if not all(bool(torch.isfinite(t).all()) for t in (out[0].K, out[0].kff, *out[1:])):
            fail(f"non-finite eLQR results at N={n}")
        runs[n] = (x0s, kff0, out, launches)
    main_launches = {**runs[N_ELQR_STREAM][3], "K14": runs[N_ELQR_FUSED][3]["K14"]}

    # the timed f32 K14 solve against its plain version over all 10 iterations
    log(f"K14 check: float32, the main path's solve, N={N_ELQR_FUSED}, T={T}, nb_iter={it}, "
        f"tolerance {ELQR_F32_SOLVE_TOL:.0e}")
    x0s, kff0, out, _ = runs[N_ELQR_FUSED]
    k14_in = (to_soa(kff0, N_ELQR_FUSED), x0s.T.contiguous())
    ref, plain_ms["K14"] = timed(lambda: ce.elqr_solve_plain(env, *k14_in, it))
    per_iter = ((out[3].T - ref[4]).abs().max(1).values
                / ref[4].abs().max(1).values.clamp(min=1e-30)).tolist()
    log(f"  K14 f32 returns' relative error per iteration: "
        f"{[float(f'{e:.2e}') for e in per_iter]}")
    umax = float(env.umax[0])
    errs["K14"] = max(
        errors(f"K14 f32 main path {name}", g, r, ELQR_F32_SOLVE_TOL, fl)
        for name, g, r, fl in zip(
            ("K", "kff", "xs", "us", "returns"),
            (to_soa(out[0].K, N_ELQR_FUSED), to_soa(out[0].kff, N_ELQR_FUSED),
             to_soa(out[1], N_ELQR_FUSED), to_soa(out[2], N_ELQR_FUSED), out[3].T.contiguous()),
            ref, (0.0, umax, 0.0, 0.0, 0.0)))

    # K14's exact-range cases, float32, against the plain version
    for label, theta0, step, scale, nb_iter in ELQR_EXACT_CASES:
        x0s, kff0 = elqr_inputs(N_ELQR_EXACT, T_ELQR_EXACT, 15, torch.float32, device, theta0,
                                step)
        log(f"K14 check: float32, {label}, N={N_ELQR_EXACT}, T={T_ELQR_EXACT}, "
            f"nb_iter={nb_iter}, tolerance {ELQR_F32_SOLVE_TOL:.0e}")
        check_k14(f"f32 {label}", env, to_soa(scale * kff0, N_ELQR_EXACT), x0s.T.contiguous(),
                  nb_iter, ELQR_F32_SOLVE_TOL)
        log(f"eLQR engines: float32, {label}, cuda (K11-K13) against cuda-fused (K14)")
        got, ref = (make_elqr_solver_batched(env, T_ELQR_EXACT, nb_iter, engine=e, **f32)(
            x0s, kff_init=scale * kff0) for e in ("cuda", "cuda-fused"))
        same_solves(f"f32 {label} cuda vs cuda-fused", got, ref)

    # the streamed engine against the fused one on the main path's N=64 solve
    log(f"eLQR engines: float32, N={N_ELQR_FUSED}, T={T}, nb_iter={it}, cuda (K11-K13) "
        "against cuda-fused (K14), bit for bit")
    x0s, kff0, fused, _ = runs[N_ELQR_FUSED]
    streamed = make_elqr_solver_batched(env, T, it, engine="cuda", **f32)(x0s, kff_init=kff0)
    same_solves(f"f32 N={N_ELQR_FUSED} cuda vs cuda-fused", streamed, fused)

    # both kernel engines against the scan engine in float64
    n8 = N_ELQR_SCAN
    x8, kff8 = elqr_inputs(n8, T, 14, torch.float64, device)
    k64 = dict(dtype=torch.float64, device=device)
    res = {e: make_elqr_solver_batched(env, T, ELQR_SCAN_ITER, engine=e, **k64)(x8, kff_init=kff8)
           for e in ("cuda", "cuda-fused", "scan")}
    for e in ("cuda", "cuda-fused"):
        diff = (res[e][3] - res["scan"][3]).abs()
        bound = 1e-8 + 1e-8 * res["scan"][3].abs()
        log(f"  eLQR f64 {e} vs scan, N={n8}, T={T}, nb_iter={ELQR_SCAN_ITER}: trace "
            f"max_abs_err={diff.max().item():.3e}, max err/(1e-8 + 1e-8|scan|)="
            f"{(diff / bound).max().item():.3e}")
        if not bool((diff <= bound).all()):
            fail(f"eLQR f64 engine {e} and scan traces differ beyond rtol/atol 1e-8")
    full = {e: make_elqr_solver_batched(env, T, it, engine=e, **k64)(x8, kff_init=kff8)
            for e in ("cuda", "cuda-fused")}
    same = errors(f"eLQR f64 cuda vs cuda-fused, nb_iter={it}, trace", full["cuda"][3],
                       full["cuda-fused"][3], 1e-12)
    log(json.dumps({"elqr_f64_engines_vs_each_other_trace_abs_err": same}))

    # timings: ms per solve of the main path at N=64, 1024 and 1, and the scan engine
    for n in (N_ELQR_FUSED, N_ELQR_STREAM, 1):
        x0s, kff0 = runs[n][:2]
        ms = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            solve(x0s, kff_init=kff0)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        med = sorted(ms)[1]
        log(json.dumps({"metric": "elqr", "config": f"Cartpole-TO-v0 T={T} nb_iter={it} N={n} "
                        f"engine=auto->{'cuda' if n > 128 else 'cuda-fused'} float32",
                        "ms_per_solve": med, "ms_runs": ms,
                        "instance_iters_per_s": n * it / (med / 1e3), "gpu": card}))
    x0s, kff0 = runs[N_ELQR_FUSED][:2]
    scan = make_elqr_solver_batched(env, T, ELQR_SCAN_TIMED_ITER, engine="scan", **f32)
    _, scan_ms = timed(lambda: scan(x0s, kff_init=kff0))
    log(json.dumps({"metric": "elqr_scan", "config": f"Cartpole-TO-v0 T={T} "
                    f"nb_iter={ELQR_SCAN_TIMED_ITER} N={N_ELQR_FUSED} engine=scan float32",
                    "ms_per_solve": scan_ms, "ms_per_iteration_with_rollouts":
                    scan_ms / ELQR_SCAN_TIMED_ITER, "gpu": card}))
    main_ms = elqr_main_path_launch_ms(solve, *runs[N_ELQR_STREAM][:2])
    log(json.dumps({"metric": "elqr_kernels_main_path", "config": f"Cartpole-TO-v0 T={T} "
                    f"nb_iter={it} N={N_ELQR_STREAM} engine=auto->cuda float32",
                    "ms_per_launch": main_ms,
                    "spread": {k: spread(v) for k, v in main_ms.items()}, "gpu": card}))
    return elqr_kernel_rows(card, main_launches, errs, plain_ms, operands,
                            (k14_in, ce.cuda_elqr_solve(env, *k14_in, it)), main_ms)


# --------------------------------------------------------------------------------------
# Robust GPS: kernels K15 and K16, the two main-path configurations, the batch
# --------------------------------------------------------------------------------------


def k15_operations(T, N, dx, du):
    """Operations of one K15 launch, counted from csrc/rgps.cu per row-step:
    the moments (about 4·p1² + 60), W and w (8p² + 3p), the left-looking
    Cholesky, the triangular inverse and MᵀM (p³/3 multiply-adds each, so
    p³ in all, with p square roots and 2p divides), μθ* (2p²), the correction
    blocks (2·dx²·p1²) and k15_value's recursion of V' and v' (A + BK, c +
    Bkff, Kᵀ(−Cuu + Puu), V'(A + BK), V'c and the sums of V and v: 768 at dims
    4/2).  The value carry's constant term is not counted: the kernel leaves
    it out, since no output reads it."""
    p1 = dx + du + 1
    p = dx * p1
    value = dx * dx * (7 * du + 4 * dx + 3) + dx * (11 * du + 6 * dx + 4) + dx * du * (3 * du - 1)
    return T * N * (4 * p1 * p1 + 60 + 8 * p * p + 3 * p + p ** 3 + 3 * p + 2 * p * p
                    + 2 * dx * dx * p1 * p1 + value)


# K15 leaves c0, Cuu at t + 1 (cuun), Σd (sigd) and v0T unread: they feed
# only the value carry's constant term, which no output reads.
K15_UNREAD = ("c0", "cuun", "sigd")


def k15_reads(packed, qmu, qsig):
    """The tensors one K15 launch reads, each once (the marginal q at steps
    0 … T − 1)."""
    from trajopt_torch.core import cuda_rgps as cr

    T = packed["cx"].shape[0]
    return [packed[k] for k in cr._BACKWARD_KEYS if k not in K15_UNREAD] + [
        qmu[:T], qsig[:T], packed["bpe"], packed["vT"], packed["vvT"]]


def k16_operations(T, N, dx, du):
    """Operations of one K16 launch, counted from csrc/rgps.cu per row-step:
    the central form Zm and Qmu (2·p1²·dx² + 2·p1·dx²), the (x, u) point
    pairs k (Bk 2(nxu−k)dx², Qk 2(nxu−k)(nxu−k+1)dx², a dx-Cholesky and its
    row sums, about 120), the other points (2dx² each), the ordered mean and
    covariance (3·n_pts·dx²), and the KL with the interpolation (three dx-
    Cholesky factors and inverses, about 400)."""
    nxu, p1 = dx + du, dx + du + 1
    n_pts = 2 * (nxu + 1 + dx)
    pairs = sum(2 * (2 * m * dx * dx + 2 * m * (m + 1) * dx * dx + 120)
                for m in range(1, nxu + 1))
    return (T + 1) * N * 400 + T * N * (2 * p1 * p1 * dx * dx + 2 * p1 * dx * dx + pairs
                                        + (n_pts - 2 * nxu) * 2 * dx * dx
                                        + 3 * n_pts * dx * dx)


def rgps_problem(N, T, dx, du, seed, dtype, device, non_pd=False, kick=False):
    """Seeded fixed-point operands (tests/test_pallas_rgps.py's problem): SPD
    cost blocks, a nominal near 0.9·I, β = 200; ``non_pd`` shrinks the KL
    anchor by 1e-12 so W ≈ 2 kron(Mz, V')/β inherits V' = −Cxx_T's negative
    definiteness; ``kick`` starts the rows' marginals 0, 0.5 or 2 units
    (cycled) away from the cubature's, so they converge after different trip
    counts (tests/test_pallas_rgps.py:224).  Returns (packed streams, q μ,
    q Σ)."""
    from trajopt_torch.core import cuda_rgps as cr
    from trajopt_torch.core import types as tt
    from trajopt_torch.core.cubature import cubature_forward_pass, parameter_augment_cost

    p = dx * (dx + du + 1)
    rng = np.random.default_rng(seed)

    def spd(d, n, s=1.0):
        M = rng.standard_normal((N, n, d, d))
        return s * (np.einsum("bnij,bnkj->bnik", M, M) + d * np.eye(d))

    def t(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=torch.float64, device=device)

    cost = tt.QuadraticCost(
        Cxx=t(spd(dx, T + 1)), cx=t(rng.standard_normal((N, T + 1, dx))),
        Cuu=t(spd(du, T + 1)), cu=t(rng.standard_normal((N, T + 1, du))),
        Cxu=t(0.1 * rng.standard_normal((N, T + 1, dx, du))),
        c0=t(0.1 * rng.standard_normal((N, T + 1))))
    A = 0.9 * (np.eye(dx) + 0.1 * rng.standard_normal((N, T, dx, dx)))
    B = 0.5 * rng.standard_normal((N, T, dx, du))
    c = 0.1 * rng.standard_normal((N, T, dx))
    nominal = tt.MatrixNormalParams(
        mu=tt.vec_from_matrices(t(A), t(B), t(c)),
        sigma=t(np.broadcast_to(1e-4 * np.eye(p), (N, T, p, p))))
    ctl = tt.LinearGaussianPolicy(
        K=t(0.1 * rng.standard_normal((N, T, du, dx))),
        kff=t(0.1 * rng.standard_normal((N, T, du))),
        sigma=t(np.broadcast_to(np.eye(du), (N, T, du, du))))
    noise = t(np.broadcast_to(1e-4 * np.eye(dx), (N, T, dx, dx)))
    mu0 = t(0.3 * rng.standard_normal((N, dx)))
    sigma0 = t(np.broadcast_to(0.01 * np.eye(dx), (N, dx, dx)))
    beta = torch.full((N,), 200.0, dtype=torch.float64, device=device)
    agCpp, agcp, _ = parameter_augment_cost(nominal, beta)
    if non_pd:
        agCpp, agcp = 1e-12 * agCpp, 1e-12 * agcp
    xdist0, _, _ = cubature_forward_pass(mu0, sigma0, nominal, noise, ctl)
    if kick:
        k = torch.tensor([0.0, 0.5, 2.0], dtype=torch.float64, device=device).repeat(N)[:N]
        xdist0 = tt.GaussianSequence(mu=xdist0.mu + 0.3 * k[:, None, None],
                                     sigma=xdist0.sigma * (1.0 + k[:, None, None, None]))
    packed = cr.pack_rgps_problem(cost, ctl, noise, agCpp, agcp, beta, mu0, sigma0)
    packed = {k: v.to(dtype) for k, v in packed.items()}
    qmu, qsig = cr.pack_rgps_xdist(xdist0)
    return packed, qmu.to(dtype), qsig.to(dtype)


def errors_where_finite(name, got, ref, tol, floor=0.0):
    """``errors`` on the entries the reference has finite, after requiring
    the non-finite entries (NaN, ±inf) to sit in the same places."""
    got, ref = got.double(), ref.double()
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not torch.equal(
            torch.isfinite(got), fin):
        fail(f"{name}: non-finite entries in other places than the plain version's")
    if not bool(fin.all()):
        log(f"  {name}: {int((~fin).sum())} non-finite entries, in the same places")
    return errors(name, got[fin], ref[fin], tol, floor)


def check_rgps_case(label, packed, qmu, qsig, tol, expect_bad=None):
    """K15 then K16 against their plain versions on the same operands (K16 on
    the plain θ*, so each kernel is held alone); returns the errors."""
    from trajopt_torch.core import cuda_rgps as cr

    mo, so, bad = cr.cuda_rgps_param_backward(packed, qmu, qsig)
    mo_p, so_p, bad_p = cr.param_backward_plain(packed, qmu, qsig)
    same_flags(f"K15 {label} flags", bad, bad_p)
    if expect_bad is not None and bool(bad.all()) != expect_bad:
        fail(f"K15 {label}: flags {bad.tolist()}, expected all {expect_bad}")
    e15 = max(errors_where_finite(f"K15 {label} mu_opt", mo, mo_p, tol),
              errors_where_finite(f"K15 {label} sigma_opt", so, so_p, tol))
    kl, qm, qs = cr.cuda_rgps_cubature_kl(packed, mo_p, so_p, qmu, qsig)
    kl_p, qm_p, qs_p = cr.cubature_kl_plain(packed, mo_p, so_p, qmu, qsig)
    # the KL of two nearly equal Gaussians is a difference of O(1) terms:
    # held against the scale of those terms (1), not its own
    e16 = max(errors_where_finite(f"K16 {label} kl", kl, kl_p, tol, floor=1.0),
              errors_where_finite(f"K16 {label} q_new mu", qm, qm_p, tol),
              errors_where_finite(f"K16 {label} q_new sigma", qs, qs_p, tol))
    return e15, e16


def check_rgps_kernels(device):
    """float64 at p = 8 and 28 with a non-PD case; float32 at bench.py:669's
    fixed-point shape, one trip and the whole fixed point."""
    from trajopt_torch.core import cuda_rgps as cr

    log("K15/K16 checks: float64, tolerance 1e-9 of the largest entry")
    for (dx, du), N, T in (((2, 1), 3, 5), ((4, 2), 8, 16)):
        for non_pd in (False, True):
            label = f"f64 dims {dx}/{du} N={N} T={T}{' non-PD' if non_pd else ''}"
            check_rgps_case(label, *rgps_problem(N, T, dx, du, 20 + dx, torch.float64, device,
                                                 non_pd), 1e-9, expect_bad=non_pd)
    log("K15/K16 checks: float32 at the main path's shapes, a non-PD case and pivots out of "
        "[2^-100, 2^100), equal to the plain versions where finite (flags and non-finite "
        "places equal)")
    t0 = time.perf_counter()
    for label, N, T, (dx, du), non_pd, scale in RGPS_EXACT_CASES:
        packed, qmu, qsig = rgps_problem(N, T, dx, du, 50 + dx, torch.float32, device, non_pd)
        packed["bpe"] = packed["bpe"] * scale
        # a scaled β+η may leave W indefinite at later steps: the flags are
        # held to the plain version's alone
        check_rgps_case(f"f32 {label} N={N} T={T} dims {dx}/{du}", packed, qmu, qsig, 0.0,
                        expect_bad=non_pd if scale == 1.0 else None)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    log(f"K15/K16 checks: float32 at T={T_RGPS_FP}, dims 4/2, one trip (tolerance "
        f"{RGPS_F32_TRIP_TOL:.0e}) and the whole fixed point from staggered marginals, "
        f"fp_iters={RGPS_FP_CHECK_ITERS} (tolerance {RGPS_F32_FP_TOL:.0e})")
    errs, operands = {}, {}
    for N in N_RGPS_FP:
        packed, qmu, qsig = rgps_problem(N, T_RGPS_FP, 4, 2, 30 + N, torch.float32, device)
        operands[N] = (packed, qmu, qsig)
        errs[N] = check_rgps_case(f"f32 T={T_RGPS_FP} N={N}", packed, qmu, qsig,
                                  RGPS_F32_TRIP_TOL)
        packed, qmu, qsig = rgps_problem(N, T_RGPS_FP, 4, 2, 30 + N, torch.float32, device,
                                         kick=True)
        got = cr.rgps_fixed_point_packed(packed, qmu, qsig, fp_iters=RGPS_FP_CHECK_ITERS)
        ref = cr.rgps_fixed_point_packed(packed, qmu, qsig, fp_iters=RGPS_FP_CHECK_ITERS,
                                         backward=cr.param_backward_plain,
                                         cubature=cr.cubature_kl_plain)
        log(f"  fixed point N={N}: trips {got[5]} (plain {ref[5]}), syncs {got[6]}")
        same_flags(f"fixed point N={N} diverged", got[4], ref[4])
        for name, g, r in zip(("q mu", "q sigma", "mu_opt", "sigma_opt"), got[:4], ref[:4]):
            errors(f"fixed point N={N} {name}", g, r, RGPS_F32_FP_TOL)
    return errs, operands


def jax_reference_trace(cfg):
    """trajopt_tpu's float64 trace at a main-path configuration, frozen in
    tests/torch_refs/test_torch_rgps.npz (tests/test_torch_rgps.py computes
    it; numpy reads it here, no JAX)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from make_torch_refs import frozen

    def missing():
        fail(f"no frozen JAX trace for the {cfg} configuration")

    return np.asarray(frozen("test_torch_rgps.py", f"_jax_main_path_trace-{cfg}", missing))


def rgps_config(name):
    import trajopt_torch

    if name == "lqr":
        return trajopt_torch.make("LQR-TO-v1"), T_RGPS_LQR, RGPS_LQR
    return trajopt_torch.make("Robot-TO-v0", sigma_scale=1e-4), T_RGPS_ROBOT, RGPS_ROBOT


def rgps_phases(device, card, wrappers):
    """The robust-GPS phases: K15/K16 checks, both main-path configurations
    with fp_engine="auto" (counts, ms per outer iteration, trace), each held
    to the scan engine in float64 at a cut depth, run_rgps_batch at N=64, the
    kernels' timings; returns the K15/K16 rows."""
    from trajopt_torch.core import cuda_rgps as cr
    from trajopt_torch.parallel.rgps import make_rgps_solver, run_rgps_batch

    wrappers.update(K15=cr.cuda_rgps_param_backward, K16=cr.cuda_rgps_cubature_kl)
    errs, operands = check_rgps_kernels(device)
    f32 = dict(dtype=torch.float32, device=device)

    def counters():
        return {"K15": cr.cuda_rgps_param_backward.launches,
                "K16": cr.cuda_rgps_cubature_kl.launches,
                "trips": cr.cuda_rgps_fixed_point.trips, "syncs": cr.cuda_rgps_fixed_point.syncs}

    def reset():
        for w in wrappers.values():
            w.launches = 0
        cr.cuda_rgps_fixed_point.trips = cr.cuda_rgps_fixed_point.syncs = 0

    main = {}
    for cfg in ("lqr", "robot"):
        env, T, kw = rgps_config(cfg)
        solve = make_rgps_solver(env, T, fp_engine="auto", **kw, **f32)
        inner = solve.batched
        if inner.fp_engine != "cuda":
            fail(f"fp_engine='auto' resolved to {inner.fp_engine!r} on the card")
        mu0, sigma0 = (x.to(**f32) for x in env.init())
        reset()
        state = inner.init(mu0[None], sigma0[None])
        trace, ms, counts = [state.last_return.item()], [], []
        for _ in range(kw["nb_iter"]):
            before = dict(counters(), fixed_points=inner.fixed_points)
            t0 = time.perf_counter()
            state = inner.iteration(state)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            trace.append(state.last_return.item())
            after = dict(counters(), fixed_points=inner.fixed_points)
            counts.append({k: after[k] - before[k] for k in after})
        launches = {k: w.launches for k, w in wrappers.items()}
        total = counters()
        log(json.dumps({"rgps_main_path": cfg, "launches": launches,
                        "per_iteration": counts}))
        others = {k: v for k, v in launches.items() if k not in ("K15", "K16") and v}
        if others:
            fail(f"RGPS {cfg} launched other kernels: {others}")
        if not (total["K15"] == total["K16"] == total["trips"] > 0):
            fail(f"RGPS {cfg}: K15 {total['K15']}, K16 {total['K16']} launches for "
                 f"{total['trips']} trips")
        for c in counts:
            if c["syncs"] != c["trips"] + c["fixed_points"]:
                fail(f"RGPS {cfg}: {c['syncs']} host syncs for {c['trips']} trips of "
                     f"{c['fixed_points']} fixed points")
        if not all(math.isfinite(x) for x in trace):
            fail(f"RGPS {cfg}: non-finite trace {trace}")
        if not all(b <= a for a, b in zip(trace, trace[1:])):
            fail(f"RGPS {cfg}: the trace {trace} increases")
        want = jax_reference_trace(cfg)
        rel = float(np.max(np.abs(np.asarray(trace) - want) / np.abs(want)))
        log(json.dumps({"rgps_trace_vs_jax_f64": cfg, "jax": want.tolist(), "card": trace,
                        "max_rel_err": rel, "tol": RGPS_TRACE_TOL}))
        if not rel <= RGPS_TRACE_TOL:
            fail(f"RGPS {cfg}: the trace {trace} is {rel:.2e} from JAX's {want.tolist()}")
        main[cfg] = dict(total, fixed_points=inner.fixed_points,
                         per_iteration={"counts": counts, "ms": ms})
        log(json.dumps({"metric": "rgps_solve", "config": f"{env.__class__.__name__} T={T} "
                        f"{json.dumps(kw)} fp_engine=auto->cuda float32",
                        "ms_per_outer_iteration": ms, "trace": trace,
                        "launches_per_iteration": [c["K15"] for c in counts],
                        "trips_per_iteration": [c["trips"] for c in counts],
                        "syncs_per_iteration": [c["syncs"] for c in counts],
                        "fixed_points_per_iteration": [c["fixed_points"] for c in counts],
                        "gpu": card}))

    # the kernels' share of an outer iteration: K15 and K16 at each
    # configuration's own shape (N=1; seeded operands, the same work per
    # step), their device time per launch times the launches per iteration,
    # over the iteration's wall time (torch.profiler over one iteration took
    # longer than the whole script's limit)
    for cfg, (dx, du) in (("lqr", (2, 1)), ("robot", (4, 2))):
        T = rgps_config(cfg)[1]
        packed, qmu, qsig = rgps_problem(1, T, dx, du, 40, torch.float32, device)
        mo, so, bad = cr.cuda_rgps_param_backward(packed, qmu, qsig)
        kl, qm, qs = cr.cuda_rgps_cubature_kl(packed, mo, so, qmu, qsig)
        k15_ms = device_ms_back_to_back(lambda: cr.cuda_rgps_param_backward(packed, qmu, qsig),
                                        20)[0]
        k16_ms = device_ms_back_to_back(
            lambda: cr.cuda_rgps_cubature_kl(packed, mo, so, qmu, qsig), 20)[0]
        # the least time for this shape's work, as the kernel rows count it
        bound = {}
        for k, moved, ops in (
                ("k15", nbytes(*k15_reads(packed, qmu, qsig), mo, so, bad),
                 k15_operations(T, 1, dx, du)),
                ("k16", nbytes(mo, so, *[packed[k] for k in ("sigd", "K", "kff", "sigc", "mu0",
                                                               "sig0")], qmu, qsig, kl, qm, qs),
                 k16_operations(T, 1, dx, du))):
            bound[f"{k}_bound_ms"] = max(1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S)
            bound[f"{k}_bound_by"] = ("bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                                      else "operations")
        per_it = main[cfg]["per_iteration"]
        log(json.dumps({"metric": "rgps_kernel_share", "config": cfg, "T": T, "N": 1,
                        "k15_ms": k15_ms, "k16_ms": k16_ms, **bound,
                        "kernel_ms_per_iteration": [c["K15"] * (k15_ms + k16_ms)
                                                    for c in per_it["counts"]],
                        "share_of_wall": [c["K15"] * (k15_ms + k16_ms) / w
                                          for c, w in zip(per_it["counts"], per_it["ms"])],
                        "gpu": card}))

    # each configuration held to the scan engine in float64 at a cut depth
    k64 = dict(dtype=torch.float64, device=device)
    for cfg in ("lqr", "robot"):
        env, T, kw = rgps_config(cfg)
        kw = dict(kw, **RGPS_SCAN_CUT)
        mu0, sigma0 = (x.to(**k64) for x in env.init())
        res = {}
        for e in ("cuda", "scan"):
            (st, tr), sec = timed(lambda: make_rgps_solver(env, T, fp_engine=e, **kw, **k64)(
                mu0, sigma0))
            res[e] = (st, tr, sec)
        for name, g, r in (("trace", res["cuda"][1], res["scan"][1]),
                           ("K", res["cuda"][0].ctl.K, res["scan"][0].ctl.K),
                           ("kff", res["cuda"][0].ctl.kff, res["scan"][0].ctl.kff),
                           ("beta", res["cuda"][0].beta, res["scan"][0].beta)):
            errors(f"RGPS {cfg} f64 cuda vs scan {name} ({json.dumps(RGPS_SCAN_CUT)})", g, r,
                   RGPS_F64_ENGINE_TOL)
        log(json.dumps({"rgps_f64_engines": cfg, "seconds_cuda": res["cuda"][2] / 1e3,
                        "seconds_scan": res["scan"][2] / 1e3}))

    # run_rgps_batch at N=64 on LQR-TO-v1
    env, T, kw = rgps_config("lqr")
    reset()
    kw = dict(kw, nb_iter=RGPS_BATCH_ITER)
    out, batch_ms = timed(lambda: run_rgps_batch(
        env, torch.Generator(device=device).manual_seed(0), N_RGPS_BATCH, T, **kw, **f32))
    batch_counts = counters()
    if not bool(torch.isfinite(out["trace"]).all()):
        fail("run_rgps_batch: non-finite traces")
    if not (batch_counts["K15"] == batch_counts["K16"] == batch_counts["trips"] > 0):
        fail(f"run_rgps_batch counts {batch_counts}")
    log(json.dumps({"metric": "rgps_batch", "config": f"LQR-TO-v1 T={T} N={N_RGPS_BATCH} "
                    f"{json.dumps(kw)} float32", "ms": batch_ms,
                    "ms_per_outer_iteration": batch_ms / kw["nb_iter"],
                    "instance_iterations_per_s": N_RGPS_BATCH * kw["nb_iter"] / batch_ms * 1e3,
                    "counts": batch_counts, "final_trace_mean": out["trace"][:, -1].mean().item(),
                    "gpu": card}))

    # the kernels' timings at bench.py:669's shape (T=100, dims 4/2, N=64)
    packed, qmu, qsig = operands[N_RGPS_FP[-1]]
    N, T = qmu.shape[-1], T_RGPS_FP
    mo, so, bad = cr.cuda_rgps_param_backward(packed, qmu, qsig)
    kl, qm, qs = cr.cuda_rgps_cubature_kl(packed, mo, so, qmu, qsig)
    k15_in = k15_reads(packed, qmu, qsig)
    k16_in = [mo, so] + [packed[k] for k in ("sigd", "K", "kff", "sigc", "mu0", "sig0")] + [
        qmu, qsig]
    calls = {
        "K15": (lambda: cr.cuda_rgps_param_backward(packed, qmu, qsig),
                lambda: cr.param_backward_plain(packed, qmu, qsig),
                nbytes(*k15_in, mo, so, bad), k15_operations(T, N, 4, 2),
                ("K15 rgps_param_backward", 151)),
        "K16": (lambda: cr.cuda_rgps_cubature_kl(packed, mo, so, qmu, qsig),
                lambda: cr.cubature_kl_plain(packed, mo, so, qmu, qsig),
                nbytes(*k16_in, kl, qm, qs), k16_operations(T, N, 4, 2),
                ("K16 rgps_cubature_kl", 534)),
    }
    rows = []
    for k, (call, plain, moved, ops, (name, line)) in calls.items():
        device_ms, enqueue_ms, _ = device_ms_back_to_back(call, 20)
        _, plain_ms = timed(plain)
        bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        row = {
            "name": name, "route": "cuda", "source": "trajopt_torch/csrc/rgps.cu",
            "replaces": f"trajopt_tpu/core/pallas_rgps.py:{line}",
            "launches": main["lqr"][k] + main["robot"][k],
            "max_abs_err": max(e[0 if k == "K15" else 1] for e in errs.values()),
            "ms": device_ms, "call_ms": time_cuda(call, 20), "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes an adversary MatrixNormal sweep
            # or a cubature-KL step
            "library_ms": None,
        }
        rows.append(row)
        log(json.dumps({"metric": "kernel", "shape": f"T={T} N={N} dims 4/2 float32 "
                        "(bench.py:669)", **row, "launches_lqr": main["lqr"][k],
                        "launches_robot": main["robot"][k],
                        "enqueue_ms_per_call": enqueue_ms / 20, "bytes": moved,
                        "operations": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                        "gpu": card}))
    return rows


def main():
    global torch
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import trajopt_torch
        from trajopt_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the trajopt_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 3
    from trajopt_torch.core.cuda_fused import cuda_ilqr_backward_fused
    from trajopt_torch.core.cuda_lqr import cuda_ilqr_backward_packed
    from trajopt_torch.core.cuda_rollout import cuda_rollout_returns, cuda_rollout_selected
    from trajopt_torch.parallel.mpc import make_ilqr_solver_batched

    wrappers = {"K1": cuda_ilqr_backward_fused, "K2": cuda_rollout_returns,
                "K3": cuda_rollout_selected, "K4": cuda_ilqr_backward_packed}
    dev = torch.device("cuda")

    # 1. the card
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                    "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)}))

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            line = line.strip()
            spills = "spill" in line and not line.endswith("0 bytes spill stores, 0 bytes spill loads")
            if "entry function" in line or "registers" in line or spills:
                log(f"  {src}: {line}")

    # 3. kernel checks.  float64 at a small shape: the kernels and the plain
    # versions do the same arithmetic with each product and sum rounded once
    # (-fmad=false), only in other orders; 1e-9 of the largest entry leaves
    # room for T steps of such rounding.  float32 at the main shape: T=1000
    # dependent steps of rounding in another order, and the values span
    # several decades (Cartpole's goal weights run from 1 to 1e4); 2e-3 of the
    # largest entry.
    env_v0 = trajopt_torch.make("Cartpole-TO-v0")
    env_v1 = trajopt_torch.make("Cartpole-TO-v1")
    x0 = torch.zeros(N_MAIN, env_v0.dm_state, device=dev)
    x0[:, 0] = 0.01 * torch.arange(N_MAIN, device=dev, dtype=torch.float32)
    check_kernels(env_v0, env_v1, N_SMALL, T_SMALL, torch.float64, 1e-9, dev, (1, 2))
    _, rag = check_backwards(env_v0, env_v1, N_RAGGED, T_RAGGED, torch.float64, 1e-9, dev,
                             (1, 2))
    # K2 and K3 stage 16 steps of 16 instances too, K2 6 α candidates a block
    from trajopt_torch.core.cuda_lqr import _ilqr_backward_plain
    from trajopt_torch.solvers.common import DEFAULT_ALPHAS

    rag_K, rag_kff, _, _ = _ilqr_backward_plain(rag["packed"], rag["lam"], 1)
    log(f"rollout checks: torch.float64, N={N_RAGGED} (lanes {rag['n_pad']}), T={T_RAGGED}")
    for nA, picked in ((11, DEFAULT_ALPHAS), (3, DEFAULT_ALPHAS[::5])):
        check_rollouts(env_v0, (rag_K, rag_kff, rag["xr"], rag["ur"]), rag["w"],
                       torch.tensor(picked, dtype=torch.float64, device=dev), 1e-9,
                       f" nA={nA}")
    check_rollout_exact(env_v0, dev)
    errs, inp = check_kernels(env_v0, env_v1, N_MAIN, T_MAIN, torch.float32, 2e-3, dev, (1,),
                              main_path_streams(env_v0, x0))

    # 4. the main path

    def solver(backward, rollout):
        return make_ilqr_solver_batched(env_v0, T_MAIN, nb_iter=NB_ITER, backward=backward,
                                        rollout=rollout, time_chunk=8, device=dev,
                                        dtype=torch.float32)

    def counted_solve(solve):
        for w in wrappers.values():
            w.launches = 0
        state, trace = solve(x0)
        torch.cuda.synchronize()
        return state, trace, {k: w.launches for k, w in wrappers.items()}

    main_solve = solver("cuda-fused", "cuda")
    ret0 = main_solve.init(x0).last_return
    state, trace, launches = counted_solve(main_solve)
    log(f"main path launches: {json.dumps(launches)}")
    for k in ("K1", "K2", "K3"):
        if launches[k] == 0:
            fail(f"the main path did not launch {k}")
    ret = state.last_return
    if not bool(torch.isfinite(ret).all()):
        fail("non-finite final returns on the main path")
    if not bool((ret <= ret0).all()):
        fail(f"{int((ret > ret0).sum())} final returns above their initial value")
    mean_main = ret.double().mean().item()

    scan_state, _, scan_launches = counted_solve(solver("scan", "scan"))
    if any(scan_launches.values()):
        fail(f"the scan engines launched kernels: {scan_launches}")
    mean_scan = scan_state.last_return.double().mean().item()
    # float32 over 10 iterations of accept/reject: a few instances may take
    # another α or λ branch; the mean over 2048 instances stays within 1e-2
    rel = abs(mean_main - mean_scan) / abs(mean_scan)
    log(json.dumps({"mean_initial_return": ret0.double().mean().item(),
                    "mean_final_return_cuda_fused": mean_main,
                    "mean_final_return_scan": mean_scan, "rel_diff": rel, "tol": 1e-2,
                    "done": int(state.done.sum()), "done_scan": int(scan_state.done.sum())}))
    if not rel <= 1e-2:
        fail(f"cuda-fused and scan mean final returns differ by {rel:.3e}")

    k4_state, _, k4_launches = counted_solve(solver("cuda", "cuda"))
    log(f"backward='cuda' launches: {json.dumps(k4_launches)}")
    if k4_launches["K4"] == 0:
        fail("backward='cuda' did not launch K4")
    mean_k4 = k4_state.last_return.double().mean().item()
    rel4 = abs(mean_k4 - mean_scan) / abs(mean_scan)
    log(json.dumps({"mean_final_return_cuda": mean_k4, "rel_diff_vs_scan": rel4}))
    if not rel4 <= 1e-2:
        fail(f"cuda and scan mean final returns differ by {rel4:.3e}")

    # 5. timings
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        main_solve(x0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = sorted(secs)[1]
    log(json.dumps({"metric": "main_path", "config": "Cartpole-TO-v0 T=1000 N=2048 "
                    "nb_iter=10 backward=cuda-fused rollout=cuda float32",
                    "ms_per_batch_iter": 1e3 * sec / NB_ITER,
                    "ms_per_batch_iter_runs": [1e3 * s / NB_ITER for s in secs],
                    "instance_iters_per_s": N_MAIN * NB_ITER / sec, "gpu": card}))

    from trajopt_torch.core import cuda_fused, cuda_lqr, cuda_rollout

    env, w, lam, pk = inp["env"], inp["w"], inp["lam"], inp["packed"]
    fused_args = (env, inp["xr"], inp["ur"], inp["ul"], inp["xT"], w, lam, 1)
    k_out = cuda_fused.cuda_ilqr_backward_fused(*fused_args)
    k4_out = cuda_lqr.cuda_ilqr_backward_packed(pk, lam, 1)
    wr = inp["w_roll"]
    rA = cuda_rollout.cuda_rollout_returns(env, *inp["streams"], wr, inp["alphas"])
    rB = cuda_rollout.cuda_rollout_selected(env, *inp["streams"], wr, inp["alpha_l"])
    nA = inp["alphas"].shape[0]
    steps = {"K1": T_MAIN * N_MAIN, "K2": T_MAIN * N_MAIN * nA, "K3": T_MAIN * N_MAIN,
             "K4": T_MAIN * N_MAIN}
    moved = {
        "K1": nbytes(inp["xr"], inp["ur"], inp["ul"], inp["xT"], w, lam, *k_out),
        "K2": nbytes(*inp["streams"], wr, inp["alphas"], *rA),
        "K3": nbytes(*inp["streams"], wr, inp["alpha_l"], *rB),
        "K4": nbytes(*pk.values(), lam, *k4_out),
    }
    calls = {
        "K1": (lambda: cuda_fused.cuda_ilqr_backward_fused(*fused_args),
               lambda: cuda_fused.fused_backward_plain(*fused_args)),
        "K2": (lambda: cuda_rollout.cuda_rollout_returns(env, *inp["streams"], wr, inp["alphas"]),
               lambda: cuda_rollout.rollout_returns_plain(env, *inp["streams"], wr,
                                                          inp["alphas"])),
        "K3": (lambda: cuda_rollout.cuda_rollout_selected(env, *inp["streams"], wr,
                                                          inp["alpha_l"]),
               lambda: cuda_rollout.rollout_selected_plain(env, *inp["streams"], wr,
                                                           inp["alpha_l"])),
        "K4": (lambda: cuda_lqr.cuda_ilqr_backward_packed(pk, lam, 1),
               lambda: cuda_lqr._ilqr_backward_plain(pk, lam, 1)),
    }
    meta = {
        "K1": ("K1 fused_backward", "trajopt_torch/csrc/fused_backward.cu",
               "trajopt_tpu/core/pallas_fused.py:122"),
        "K2": ("K2 rollout_returns", "trajopt_torch/csrc/rollout.cu",
               "trajopt_tpu/core/pallas_rollout.py:130"),
        "K3": ("K3 rollout_selected", "trajopt_torch/csrc/rollout.cu",
               "trajopt_tpu/core/pallas_rollout.py:186"),
        "K4": ("K4 ilqr_backward", "trajopt_torch/csrc/ilqr_backward.cu",
               "trajopt_tpu/core/pallas_lqr.py:199"),
    }
    rows = []
    for k in ("K1", "K2", "K3", "K4"):
        kernel, plain = calls[k]
        # the kernel's device time with launches queued back to back (about
        # 0.5 ms each, so a call's host work would show), and the time per
        # call beside it
        call_ms = time_cuda(kernel, 10)
        ms = device_ms_back_to_back(kernel, 10)[0]
        # one call: the checks above ran the plain version at this shape
        plain_ms = timed(plain)[1]
        bytes_ms = 1e3 * moved[k] / HBM_BYTES_PER_S
        ops_ms = 1e3 * OPS_PER_STEP[k] * steps[k] / F32_OPS_PER_S
        count = launches[k] if k != "K4" else k4_launches[k]
        name, source, replaces = meta[k]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count, "max_abs_err": errs[k], "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a batched Riccati recursion or a
            # closed-loop rollout
            "library_ms": None,
        }
        rows.append(row)
        log(json.dumps({"metric": "kernel", **row, "launches_per_iter": count / NB_ITER,
                        "bytes": moved[k], "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                        "gpu": card}))

    log(f"[{time.perf_counter() - t_start:.0f} s] K5 and the single-problem paths")
    # 6. K5 against its plain version
    from trajopt_torch.core.cuda_pscan import cuda_pilqr_backward, pilqr_backward_plain
    from trajopt_torch.envs.base import wrap_angle
    from trajopt_torch.parallel.mpc import make_ilqr_solver, make_mpc_runner

    wrappers["K5"] = cuda_pilqr_backward
    check_k5(dev)
    pend = trajopt_torch.make("Pendulum-TO-v0", dt=0.05)
    env_mpc = pend.replace(uw=(1e-5,))
    x0_p = torch.tensor(pend.x0, dtype=torch.float32, device=dev)
    k5_cost, k5_A, k5_B, ret0 = replan_inputs(pend, x0_p, T_REPLAN)
    errs["K5"] = check_k5_case("f32 replan path T=100 dx=2 du=1 lam=1", k5_cost, k5_A, k5_B,
                               2e-3)
    check_k5_case(f"f32 MPC path T={MPC_HORIZON} dx=2 du=1 lam=1",
                  *replan_inputs(env_mpc, x0_p, MPC_HORIZON)[:3], 2e-3)

    # 7. the replan path
    def replanner(backward, metrics=False):
        return make_ilqr_solver(pend, T_REPLAN, nb_iter=ITER_REPLAN, backward=backward,
                                metrics=metrics, device=dev, dtype=torch.float32)

    for w in wrappers.values():
        w.launches = 0
    state, m = replanner("cuda-pscan", metrics=True)(x0_p)
    torch.cuda.synchronize()
    replan_launches = {k: w.launches for k, w in wrappers.items()}
    worked = 1 + int((~m.done[:-1]).sum())      # iterations that started not done
    ret = state.last_return.item()
    pscan_ret = replanner("pscan")(x0_p)[0].last_return.item()
    rel = abs(ret - pscan_ret) / abs(pscan_ret)
    log(json.dumps({"replan_launches": replan_launches, "iterations_worked": worked,
                    "initial_return": ret0.item(), "final_return_cuda_pscan": ret,
                    "final_return_pscan": pscan_ret, "rel_diff": rel, "tol": 1e-4}))
    if replan_launches["K5"] < 2 * worked:
        fail(f"the replan launched K5 {replan_launches['K5']} times in {worked} iterations")
    if not math.isfinite(ret) or not ret <= ret0.item():
        fail(f"replan final return {ret} is not finite or above the initial {ret0.item()}")
    if not rel <= 1e-4:
        fail(f"cuda-pscan and pscan replan returns differ by {rel:.3e}")

    # 8. the MPC example path, then the timings of phases 6-8
    run_mpc = make_mpc_runner(env_mpc, MPC_HORIZON, MPC_STEPS, nb_iter=MPC_ITER,
                              backward="cuda-pscan", device=dev, dtype=torch.float32)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    xs, _, _ = run_mpc(x0_p, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    mpc_s = time.perf_counter() - t0
    mpc_launches = {k: w.launches for k, w in wrappers.items()}
    th_end = wrap_angle(xs[-1, 0]).abs().item()
    log(json.dumps({"mpc_launches": mpc_launches, "final_state": xs[-1].tolist(),
                    "abs_wrapped_theta_end": th_end, "tol": 0.6}))
    if not bool(torch.isfinite(xs).all()):
        fail("non-finite MPC states")
    if not th_end < 0.6:
        fail(f"MPC ended {th_end:.3f} rad from upright")
    if mpc_launches["K5"] == 0:
        fail("the MPC path did not launch K5")
    log(json.dumps({"metric": "mpc", "config": "Pendulum-TO-v0 dt=0.05 uw=1e-5 horizon=25 "
                    f"steps={MPC_STEPS} nb_iter=10 backward=cuda-pscan float32",
                    "control_steps_per_s": MPC_STEPS / mpc_s, "seconds": mpc_s,
                    "k5_launches_per_step": mpc_launches["K5"] / MPC_STEPS, "gpu": card}))

    for backward in ("cuda-pscan", "pscan", "scan"):
        solve = replanner(backward)
        solve(x0_p)
        runs = []
        for _ in range(REPLANS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            solve(x0_p)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        log(json.dumps({"metric": "replan", "backward": backward,
                        "config": "Pendulum-TO-v0 dt=0.05 T=100 nb_iter=3 batch=1 float32",
                        "ms_median": sorted(runs)[REPLANS // 2], "ms_runs": runs, "gpu": card}))

    # where a replan's time goes: one cuda-pscan replan under torch.profiler
    # (whose own overhead lengthens the wall time)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve = replanner("cuda-pscan")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(x0_p)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    k5_ms = sum(e.self_device_time_total for e in on_device if "pscan_backward" in e.key) / 1e3
    calls = {name: sum(e.count for e in events if e.key == name)
             for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    log(json.dumps({"metric": "replan_profile", "backward": "cuda-pscan", "wall_ms": wall_ms,
                    "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                    "k5_device_ms": k5_ms,
                    "device_events": sum(e.count for e in on_device), "host_calls": calls,
                    "top_self_cpu_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top],
                    "gpu": card}))

    k5_shapes = (("replan path, T=100 dx=2 du=1", (k5_cost, k5_A, k5_B)),
                 ("SPD problem, T=1000 dx=4 du=2", pscan_problem(1000, 4, 2, torch.float32, dev)))
    for label, (cost, A, B) in k5_shapes:
        T, dx, du = A.shape[0], A.shape[-1], B.shape[-1]
        pol, val, dV = cuda_pilqr_backward(cost, A, B)
        moved = nbytes(cost.Cxx, cost.cx, cost.Cuu[:T], cost.cu[:T], cost.Cxu[:T], A, B,
                       pol.K, pol.kff, val.V, val.v, dV)
        bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
        ops_ms = 1e3 * k5_operations(T, dx, du) / F32_OPS_PER_S
        call = lambda: cuda_pilqr_backward(cost, A, B)  # noqa: E731
        device_ms, profiled = device_ms_per_launch(call, 50, "pscan_backward")
        row = {
            "name": "K5 pscan_backward", "route": "cuda",
            "source": "trajopt_torch/csrc/pscan_backward.cu",
            "replaces": "trajopt_tpu/core/pallas_pscan.py:266",
            "launches": replan_launches["K5"], "max_abs_err": errs["K5"],
            # the kernel's own device time; a call back to back (call_ms) is
            # mostly the wrapper's host work at these sizes
            "ms": device_ms,
            "call_ms": time_cuda(call, 50),
            "plain_ms": time_cuda(lambda: pilqr_backward_plain(cost, A, B), 1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a parallel Riccati scan
            "library_ms": None,
        }
        log(json.dumps({"metric": "kernel", "shape": label, **row,
                        "profiled_launches": profiled, "bytes": moved,
                        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "gpu": card}))
        if T == T_REPLAN:
            rows.append(row)

    log(f"[{time.perf_counter() - t_start:.0f} s] GPS phases")
    # 9-11. GPS: K6/K7 against their plain versions, the solver path, the
    # GPS-MPC farm, the kernels' timings
    from trajopt_torch.core.cuda_gps import cuda_gps_backward_packed, cuda_gps_forward_kl_packed

    wrappers.update(K6=cuda_gps_backward_packed, K7=cuda_gps_forward_kl_packed)
    dual_packed, dual_alpha, dual_checked = check_gps_kernels(dev)
    solver_packed, solver_alpha, gps_launches, gps_path_ms = gps_solver_phase(dev, card,
                                                                                wrappers)
    log("K6/K7 checks: float32 on the solver path's first dual operands, tolerance 1e-4")
    solver_checked = check_gps_case(f"f32 solver path T={T_GPS} dx=2 du=1", solver_packed,
                                    solver_alpha, 1e-4)
    check_k6_exact(solver_packed)
    check_k7_exact(solver_packed)
    gps_mpc_phase(dev, card, wrappers)
    gps_rows = gps_kernel_rows("solver path", solver_packed, solver_alpha, gps_launches,
                               solver_checked, card, gps_path_ms)
    gps_kernel_rows("dual chain benchmark shape", dual_packed, dual_alpha, gps_launches,
                    dual_checked, card)
    rows += [gps_rows["K6"], gps_rows["K7"]]

    # 12-15. belief space: K8 against its plain version, the batched solver
    # path, K9 against its plain version and as a user calls it, the
    # belief-MPC episode through K10
    from trajopt_torch.core.cuda_belief import cuda_bsp_backward_packed
    from trajopt_torch.core.cuda_bsp import cuda_bsp_episode, cuda_bsp_solve

    wrappers.update(K8=cuda_bsp_backward_packed, K9=cuda_bsp_solve, K10=cuda_bsp_episode)
    log(f"[{time.perf_counter() - t_start:.0f} s] belief phases")
    bench_packed, bench_lam, k8_err = check_k8(dev)
    solver_packed, solver_lam, k8_launches, k8_path_ms = bsp_solver_phase(dev, card, wrappers)
    log("K8 checks: float32 on the batched solver's first backward operands, tolerance 1e-4")
    solver_err = check_k8_case(f"f32 solver path T={T_BSP} N={N_BSP}", solver_packed,
                               solver_lam, 1, 1e-4, None)
    check_k8_exact(solver_packed, solver_lam)
    k8_row("bench backward shape (bench.py:511)", bench_packed, bench_lam, k8_launches, k8_err,
           card)
    rows.append(k8_row("batched solver's first backward", solver_packed, solver_lam,
                       k8_launches, solver_err, card, k8_path_ms))
    log(f"[{time.perf_counter() - t_start:.0f} s] K9 checks")
    rows.append(k9_phase(dev, card, wrappers, check_k9(dev)))
    log(f"[{time.perf_counter() - t_start:.0f} s] belief-MPC episode")
    rows.append(bsp_episode_phase(dev, card, wrappers))
    log(f"[{time.perf_counter() - t_start:.0f} s] eLQR phases")
    rows += elqr_phases(dev, card, wrappers)
    log(f"[{time.perf_counter() - t_start:.0f} s] robust-GPS phases")
    rows += rgps_phases(dev, card, wrappers)
    log(f"[{time.perf_counter() - t_start:.0f} s] done")

    # 17. the kernels line, then the device line last
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
