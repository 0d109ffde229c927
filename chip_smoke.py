#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trajopt_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build the CUDA kernels from trajopt_torch/csrc (nvcc, sm_90a, in parallel);
3. hold each kernel K1-K4 against its plain PyTorch version on the same
   inputs (made with numpy from a fixed seed): float64 at a small shape with a
   batch that is not a multiple of 32 and saturated actions, float32 at the
   main path's shape (N=2048, T=1000), K1 on Cartpole v0 and v1;
4. the main path: make_ilqr_solver_batched on Cartpole-TO-v0, T=1000,
   N=2048, 10 iterations, backward="cuda-fused", rollout="cuda", float32, from
   the benchmark's x0; it must go through K1, K2 and K3, give finite returns
   no higher than the initial ones, and agree with the scan engines (plain
   PyTorch, no kernel) on the mean final return; then backward="cuda" (K4);
5. timings with CUDA events after a warm-up: ms per batch-iteration and
   instance-iterations/s of the main path; per kernel ms per launch, launches
   per iteration, the plain version's ms and the least time the card could
   take (bound) from this run's bytes and operations;
6. the kernels line and, last, the device line.

Exits nonzero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import json
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

# Operations per time step and rollout (or instance), counted from the CUDA
# sources at Cartpole's dims (dx=4, du=1), one per add, multiply, divide,
# compare or transcendental call:
#   ODE 24; RK4 step with clips 4·24 + 56 = 152; stage cost 20; tracking
#   action 16; finite checks 4  -> rollout step 192.
#   Dual RK4 step over 5 tangents about 1250; feature Jacobian and closed-form
#   cost blocks about 260; backward step (bwd_step.cuh) about 520
#   -> fused step about 2030; stream backward step 520.
OPS_PER_STEP = {"K1": 2030, "K2": 192, "K3": 192, "K4": 520}


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


def errors(name, got, ref, tol):
    """Max abs error and error relative to the reference's largest entry."""
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1e-30)
    log(f"  {name}: max_abs_err={err:.3e} max_rel_err={err / scale:.3e} (tol {tol:.0e})")
    if not err / scale <= tol:
        fail(f"{name}: relative error {err / scale:.3e} above {tol:.0e}")
    return err


def same_flags(name, got, ref):
    if not torch.equal(got, ref):
        fail(f"{name}: flags differ in {(got != ref).sum().item()} lanes")


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


def check_kernels(env_v0, env_v1, N, T, dtype, tol, device, reg_modes, rollout_inputs=None):
    """Hold K1-K4 against their plain versions; returns the max abs error of
    each kernel's main output and the inputs, for the timings.  The rollouts
    run on ``rollout_inputs`` (streams, weighting) when given, else under the
    gains of the plain backward on the backward's own trajectory."""
    from trajopt_torch.core import cuda_fused, cuda_lqr, cuda_rollout
    from trajopt_torch.solvers.common import DEFAULT_ALPHAS

    log(f"kernel checks: {dtype}, N={N}, T={T}")
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

    if rollout_inputs is None:
        Kp, kffp, _, _ = cuda_lqr._ilqr_backward_plain(inp["packed"], inp["lam"], 1)
        streams, w = (Kp, kffp, inp["xr"], inp["ur"]), inp["w"]
    else:
        streams, w = rollout_inputs
    alphas = torch.tensor(DEFAULT_ALPHAS, dtype=dtype, device=device)
    ret, ok = cuda_rollout.cuda_rollout_returns(env_v0, *streams, w, alphas)
    retp, okp = cuda_rollout.rollout_returns_plain(env_v0, *streams, w, alphas)
    torch.cuda.synchronize()
    errs["K2"] = errors("K2 returns", ret, retp, tol)
    same_flags("K2 ok", ok, okp)
    pick = torch.arange(streams[0].shape[2], device=device) % alphas.shape[0]
    alpha_l = alphas[pick].contiguous()
    outs = cuda_rollout.cuda_rollout_selected(env_v0, *streams, w, alpha_l)
    outsp = cuda_rollout.rollout_selected_plain(env_v0, *streams, w, alpha_l)
    torch.cuda.synchronize()
    errs["K3"] = errors("K3 states", outs[0], outsp[0], tol)
    for i, part in enumerate(("actions", "terminal state", "returns")):
        errors(f"K3 {part}", outs[i + 1], outsp[i + 1], tol)
    inp.update(streams=streams, w_roll=w, alphas=alphas, alpha_l=alpha_l, env=env_v0)
    return errs, inp


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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
        ms = time_cuda(kernel, 10)
        plain_ms = time_cuda(plain, 1)
        bytes_ms = 1e3 * moved[k] / HBM_BYTES_PER_S
        ops_ms = 1e3 * OPS_PER_STEP[k] * steps[k] / F32_OPS_PER_S
        count = launches[k] if k != "K4" else k4_launches[k]
        name, source, replaces = meta[k]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count, "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a batched Riccati recursion or a
            # closed-loop rollout
            "library_ms": None,
        }
        rows.append(row)
        log(json.dumps({"metric": "kernel", **row, "launches_per_iter": count / NB_ITER,
                        "bytes": moved[k], "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                        "gpu": card}))

    # 6. the kernels line, then the device line last
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
