"""Step 0 of a redesign, on the parent's kernels, before any prediction.

``--kernels K11,K12,K2,K3`` (the eLQR sweeps and K2/K3's quotient):
K11/K12's device ms at the first-iteration operands (N=1024, T=100, K = 0,
goV = 0) and on each launch of one ``make_elqr_solver_batched(...,
engine="cuda")`` solve; that solve's ms and its device time under
torch.profiler; clock64 stamps of the sweep steps at the first and the last
iteration; K2/K3 against their plain versions on the card (normal range,
residue) and, over one iLQR main-path solve (Cartpole, N=2048, T=1000, 10
iterations), the count of K2/K3 divisions whose numerator is nonzero and
outside [2^-99, 2^99).

``--kernels K6,K7,K13`` (the GPS backward and the eLQR evaluation rollout):
K6's and K7's device ms on each of the 64 launches of one outer iteration of
chip_smoke.py's GPS solver path (Pendulum-TO-v0, T=100, N=4096), at its
seeded operands (α = 1) and at the dual chain's shape (T=1000, N=4096, dims
4/2); the outer iteration's ms; chip_smoke.py's exact K6 case on the
parent's K6; K11-K13's device ms on each launch of one N=1024 eLQR solve and
the solve's ms; clock64 stamps of K6's step at dims 2/1 (the path's first
and last launch) and of K13's step (a solve's first and last launches); the
registers and spills of every K6, K7 and K13 build.

``--kernels K7,K8`` (the GPS forward KL and the belief-value backward): K7's
device ms on each of the 64 launches of one GPS outer iteration (kept and
replayed), at the solver path's first dual with α = 1 and at the dual
chain's shape; K8's on every launch of one batched BSP solve
(LightDark-TO-v0, T=25, N=4096, 10 iterations), at bench.py:511's seeded
operands and at Car's dims (4, 2); the GPS and BSP outer iterations' ms;
clock64 stamps of K7's step at the fastest and the slowest path launch, at
α = 1 and at the dual chain, and of K8's step; the registers and spills of
every K7 and K8 build.

``--kernels K5`` (the parallel-in-time backward): the parent's K5 (one
block, the elements in a global scratch) on each of the 6 launches of
chip_smoke.py's replan (Pendulum-TO-v0, dt=0.05, T=100, 3 iterations,
backward="cuda-pscan"; operands kept, each launch replayed, device ms from
torch.profiler) and on chip_smoke.py's seeded SPD problem at T=1000, dims
4/2; the replan's ms; clock64 stamps at both shapes (cycles a level, split
into the loads, the combine, the stores and the barrier, and the element
build, the gains and the dV reduction); the registers and spills of every
(dtype, dx, du) build.

See common.py for how to run it."""
import ctypes
import json
import time

import numpy as np

import common as C
from common import log, torch
from patches import DIV_COUNT, K5_GLOBAL_STAMPS, K6_STAMPS, K6_STAMP_NAMES, K7_STAMPS, K7_STAMP_NAMES, K8_STAMPS, \
    K8_STAMP_NAMES, K13_STAMPS, K13_STAMP_NAMES, k5_stamp_report, stamp_report, stamps_per_step, \
    sweep_stamps

import chip_smoke
import trajopt_torch
import trajopt_torch.parallel.bsp as bsp_module
import trajopt_torch.parallel.gps as gps_module
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_belief as cb, cuda_elqr as ce, cuda_gps as cg, \
    cuda_pscan as cp, cuda_rollout as cr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel.elqr import make_elqr_solver_batched
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched
from trajopt_torch.solvers.common import DEFAULT_ALPHAS

chip_smoke.torch = torch
dev = torch.device("cuda")
f32 = dict(dtype=torch.float32, device=dev)


def solve_ms(fn, runs=3):
    """CUDA-event ms of ``runs`` calls of ``fn``, each on its own."""
    ms = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return ms


def stamp_buffer(label, entry):
    """The stamp entry point of library ``label`` and its 20 counters, reset."""
    fn = getattr(C.libs[label], entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 20)()
    fn(buf, 1)
    return fn, buf


def sweeps(opts, res):
    par = opts.parent
    stamped = C.patched_copy(par, sweep_stamps((par / "elqr.cu").read_text()), "step0_stamped")
    counted = C.patched_copy(par, DIV_COUNT, "step0_divcount")
    C._build.build(("fused_backward.cu",))
    C.build_variants({"elqr": par / "elqr.cu", "elqr_stamped": stamped / "elqr.cu",
                      "rollout": par / "rollout.cu", "rollout_counted": counted / "rollout.cu"})
    C.use("elqr.cu", "elqr")
    C.use("rollout.cu", "rollout")
    env = trajopt_torch.make("Cartpole-TO-v0")
    T, N, IT = 100, 1024, 10
    x0s = torch.zeros(N, 4, **f32)
    x0s[:, 1] = 0.001 * torch.arange(N, **f32)
    kff0 = torch.as_tensor(np.random.default_rng(11).standard_normal((N, T, 1)), **f32)
    first = (torch.zeros(T, 4, N, **f32), to_soa(kff0, N), torch.zeros(T + 1, 16, N, **f32),
             torch.zeros(T + 1, 4, N, **f32), x0s.T.contiguous())
    f = ce.cuda_elqr_forward(env, *first)
    k12_first = (f[0], f[1], f[2], f[3], f[5])
    res["first_iteration_ms"] = {
        "K11": [C.back_to_back(lambda: ce.cuda_elqr_forward(env, *first), 20) for _ in range(3)],
        "K12": [C.back_to_back(lambda: ce.cuda_elqr_backward(env, *k12_first), 20)
                for _ in range(3)]}
    log(json.dumps(res["first_iteration_ms"]))

    solve = make_elqr_solver_batched(env, T, IT, engine="cuda", **f32)
    solve(x0s, kff_init=kff0)
    names = ("cuda_elqr_forward", "cuda_elqr_backward", "cuda_elqr_rollout")
    kept = C.capture([ce], names, lambda: solve(x0s, kff_init=kff0))
    fns = {n: getattr(ce, n) for n in names}
    res["main_path_ms_per_launch"] = {n: [C.back_to_back(lambda: fns[n](*a), 10) for a in kept[n]]
                                      for n in names}
    log(json.dumps(res["main_path_ms_per_launch"]))
    ms = solve_ms(lambda: solve(x0s, kff_init=kff0))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(x0s, kff_init=kff0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    res["solve"] = {"ms_runs": ms, "profiled_wall_ms": wall,
                    "device_busy_ms": sum(e.self_device_time_total for e in ev) / 1e3,
                    "by_kernel": [[e.key[:40], e.count, e.self_device_time_total / 1e3] for e in ev]}
    log(json.dumps(res["solve"]))

    stamp, buf = stamp_buffer("elqr_stamped", "elqr_stamps")
    C.use("elqr.cu", "elqr_stamped")
    res["stamps"] = {}
    for it in (0, IT - 1):
        for n in names[:2]:
            fns[n](*kept[n][it])
            stamp(buf, 1)
            res["stamps"][f"{n} iteration {it + 1}"] = stamp_report(list(buf))
    C.use("elqr.cu", "elqr")
    log(json.dumps(res["stamps"]))

    # K2/K3 on the card against their plain versions on the card, and the
    # numerators out of range
    alphas = torch.tensor(DEFAULT_ALPHAS, **f32)
    cl = C.libs["rollout_counted"]
    cl.rollout_divs.argtypes = [ctypes.c_void_p, ctypes.c_int]
    b2 = (ctypes.c_ulonglong * 2)()
    res["rollout_cases"] = {}
    for label, scale in (("normal", 1.0), ("residue 1e-33", 1e-33), ("residue 1e-36", 1e-36)):
        rng = np.random.default_rng(3)
        K = torch.as_tensor(10.0 * rng.standard_normal((20, 4, 32)), **f32)
        kff, xref, uref = (torch.as_tensor(scale * rng.standard_normal(s), **f32)
                           for s in ((20, 1, 32), (20, 4, 32), (20, 1, 32)))
        streams, w = (K, kff, xref, uref), torch.ones(21, **f32)
        al = alphas[torch.arange(32, device=dev) % 11].contiguous()
        out = {"K2 returns, ok": [torch.equal(a, b) for a, b in zip(
            cr.cuda_rollout_returns(env, *streams, w, alphas),
            cr.rollout_returns_plain(env, *streams, w, alphas))],
            "K3 states, actions, terminal, returns": [int((a != b).sum()) for a, b in zip(
                cr.cuda_rollout_selected(env, *streams, w, al),
                cr.rollout_selected_plain(env, *streams, w, al))]}
        C.use("rollout.cu", "rollout_counted")
        cl.rollout_divs(b2, 1)
        cr.cuda_rollout_returns(env, *streams, w, alphas)
        cl.rollout_divs(b2, 1)
        C.use("rollout.cu", "rollout")
        out["K2 divisions [all, out of range]"] = list(b2)
        res["rollout_cases"][label] = out
        log(label, json.dumps(out))

    xm = torch.zeros(2048, 4, **f32)
    xm[:, 0] = 0.01 * torch.arange(2048, **f32)
    msolve = make_ilqr_solver_batched(env, 1000, nb_iter=10, backward="cuda-fused",
                                      rollout="cuda", time_chunk=8, **f32)
    rnames = ("cuda_rollout_returns", "cuda_rollout_selected")
    rk = C.capture([cr, mpcmod], rnames, lambda: msolve(xm))
    rfns = {n: getattr(cr, n) for n in rnames}
    C.use("rollout.cu", "rollout_counted")
    cl.rollout_divs(b2, 1)
    divs = {}
    for n in rnames:
        divs[n] = []
        for a in rk[n]:
            rfns[n](*a)
            cl.rollout_divs(b2, 1)
            divs[n].append(list(b2))
    C.use("rollout.cu", "rollout")
    res["main_path_divisions [all, out of range]"] = divs
    log(json.dumps(divs))


def gps_k13(opts, res):
    par = opts.parent
    C.build_variants({
        "gps": par / "gps.cu", "gps stamped": C.patched_copy(par, K6_STAMPS, "s0_gps") / "gps.cu",
        "elqr": par / "elqr.cu",
        "elqr stamped": C.patched_copy(par, K13_STAMPS, "s0_elqr") / "elqr.cu"})
    res["ptxas"] = {k: {n: v for n, v in r.items() if "gps" in n or "rollout" in n}
                    for k, r in C.reports.items()}
    log(json.dumps(res["ptxas"]))
    C.use("gps.cu", "gps")
    C.use("elqr.cu", "elqr")

    # GPS: the solver path's own launches, seeded operands, the dual chain's shape
    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    solve.iteration(state0)
    kept, originals = chip_smoke.kept_launches(
        {"K6": (gps_module, "cuda_gps_backward_packed"),
         "K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    path = chip_smoke.replay_ms(kept, originals)
    res["gps_path_ms"] = {k: chip_smoke.spread(v) for k, v in path.items()}
    res["gps_path_ms_each"] = path
    log(json.dumps(res["gps_path_ms"]))
    res["gps_outer_iteration_ms"] = [chip_smoke.time_cuda(lambda: solve.iteration(state0), 1)
                                     for _ in range(3)]
    log(json.dumps({"gps_outer_iteration_ms": res["gps_outer_iteration_ms"]}))
    packed = cg.pack_gps(state0.cost, state0.dyn, state0.ctl, mu0s, sigma0s)
    alpha1 = cg.pack_gps_alpha(torch.ones(chip_smoke.N_GPS, chip_smoke.T_GPS, **f32))
    k6 = cg.cuda_gps_backward_packed(packed, alpha1)
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(
        chip_smoke.T_DUAL, 4, 2, chip_smoke.N_DUAL, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)
    k6d = cg.cuda_gps_backward_packed(dual, dual_alpha)
    res["gps_seeded_ms"] = {
        "K6 solver path, α = 1": [
            C.back_to_back(lambda: cg.cuda_gps_backward_packed(packed, alpha1), 20)
            for _ in range(3)],
        "K7 solver path, α = 1": [
            C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(packed, *k6[:3]), 20)
            for _ in range(3)],
        "K6 dual chain T=1000 4/2": [
            C.back_to_back(lambda: cg.cuda_gps_backward_packed(dual, dual_alpha), 5)
            for _ in range(3)],
        "K7 dual chain T=1000 4/2": [
            C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3]), 5)
            for _ in range(3)]}
    log(json.dumps(res["gps_seeded_ms"]))
    del dual, k6d
    try:
        chip_smoke.check_k6_exact(packed)
        res["k6_exact_case"] = "pass"
    except SystemExit as e:
        res["k6_exact_case"] = f"FAIL {e}"
    log("k6_exact_case", res["k6_exact_case"])

    stamp6, b6 = stamp_buffer("gps stamped", "gps_stamps")
    C.use("gps.cu", "gps stamped")
    res["k6_stamps"] = {}
    for i in (0, len(kept["K6"]) - 1):
        a, kw = kept["K6"][i]
        originals["K6"](*a, **kw)
        stamp6(b6, 1)
        res["k6_stamps"][f"launch {i + 1}"] = stamps_per_step(list(b6), K6_STAMP_NAMES, 7)
    C.use("gps.cu", "gps")
    log(json.dumps(res["k6_stamps"]))
    del kept, originals, path

    # eLQR at N=1024: each launch of a solve, the solve's ms, K13's stamps
    env = trajopt_torch.make("Cartpole-TO-v0")
    x0s, kff0 = chip_smoke.elqr_inputs(1024, 100, 11, torch.float32, dev)
    esolve = make_elqr_solver_batched(env, 100, 10, engine="cuda", **f32)
    esolve(x0s, kff_init=kff0)
    main = chip_smoke.elqr_main_path_launch_ms(esolve, x0s, kff0)
    res["elqr_path_ms_each"] = main
    res["elqr_path_ms"] = {k: chip_smoke.spread(v) for k, v in main.items()}
    log(json.dumps(main))
    res["elqr_solve_ms"] = solve_ms(lambda: esolve(x0s, kff_init=kff0))
    log(json.dumps({"elqr_solve_ms": res["elqr_solve_ms"]}))
    kept, originals = chip_smoke.kept_launches({"K13": (ce, "cuda_elqr_rollout")},
                                               lambda: esolve(x0s, kff_init=kff0))
    stamp13, b13 = stamp_buffer("elqr stamped", "elqr_stamps")
    C.use("elqr.cu", "elqr stamped")
    res["k13_stamps"] = {}
    for i in (0, 3, len(kept["K13"]) - 2, len(kept["K13"]) - 1):
        a, kw = kept["K13"][i]
        originals["K13"](*a, **kw)
        stamp13(b13, 1)
        res["k13_stamps"][f"launch {i + 1}"] = stamps_per_step(list(b13), K13_STAMP_NAMES, 4)
    C.use("elqr.cu", "elqr")
    log(json.dumps(res["k13_stamps"]))


def ms_each(kept, originals, key):
    """Each kept launch of ``key`` replayed back to back: its ms, and the
    spread."""
    ms = chip_smoke.replay_ms({key: kept[key]}, originals)[key]
    return ms, chip_smoke.spread(ms)


def kl_belief(opts, res):
    par = opts.parent
    C.build_variants({
        "gps": par / "gps.cu", "gps stamped": C.patched_copy(par, K7_STAMPS, "s0_k7") / "gps.cu",
        "belief": par / "belief.cu",
        "belief stamped": C.patched_copy(par, K8_STAMPS, "s0_k8") / "belief.cu"})
    res["ptxas"] = {k: {n: v for n, v in r.items() if "forward_kl" in n or "bsp_backward" in n}
                    for k, r in C.reports.items()}
    log(json.dumps(res["ptxas"]))
    C.use("gps.cu", "gps")
    C.use("belief.cu", "belief")

    # K7: the GPS solver path's 64 launches, α = 1, the dual chain's shape
    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    solve.iteration(state0)
    kept, originals = chip_smoke.kept_launches(
        {"K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    k7_ms, res["K7 GPS path"] = ms_each(kept, originals, "K7")
    res["K7 GPS path, each"] = k7_ms
    log(json.dumps(res["K7 GPS path"]))
    res["gps_outer_iteration_ms"] = [chip_smoke.time_cuda(lambda: solve.iteration(state0), 1)
                                     for _ in range(3)]
    packed = cg.pack_gps(state0.cost, state0.dyn, state0.ctl, mu0s, sigma0s)
    alpha1 = cg.pack_gps_alpha(torch.ones(chip_smoke.N_GPS, chip_smoke.T_GPS, **f32))
    k6 = cg.cuda_gps_backward_packed(packed, alpha1)
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(
        chip_smoke.T_DUAL, 4, 2, chip_smoke.N_DUAL, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)
    k6d = cg.cuda_gps_backward_packed(dual, dual_alpha)
    res["K7 seeded"] = {
        "solver path, α = 1": [
            C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(packed, *k6[:3]), 20)
            for _ in range(3)],
        "dual chain T=1000 4/2": [
            C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3]), 5)
            for _ in range(3)]}
    log(json.dumps(res["K7 seeded"]))

    # K7's stamps at the fastest and the slowest path launch, α = 1, the dual chain
    stamp, buf = stamp_buffer("gps stamped", "gps_stamps")
    C.use("gps.cu", "gps stamped")
    order = sorted(range(len(k7_ms)), key=k7_ms.__getitem__)
    res["K7 stamps"] = {}
    for label, call in ((f"fastest path launch ({order[0] + 1})",
                         lambda: originals["K7"](*kept["K7"][order[0]][0], **kept["K7"][order[0]][1])),
                        (f"slowest path launch ({order[-1] + 1})",
                         lambda: originals["K7"](*kept["K7"][order[-1]][0], **kept["K7"][order[-1]][1])),
                        ("α = 1", lambda: cg.cuda_gps_forward_kl_packed(packed, *k6[:3])),
                        ("dual chain", lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3]))):
        call()
        stamp(buf, 1)
        res["K7 stamps"][label] = stamps_per_step(list(buf), K7_STAMP_NAMES, 5)
    C.use("gps.cu", "gps")
    log(json.dumps(res["K7 stamps"]))
    del kept, originals, dual, k6d

    # K8: every launch of the batched BSP solver (LightDark, T=25, N=4096,
    # 10 iterations), bench.py:511's seeded operands, Car's (4, 2)
    _, bsolver, bmu0s, bsigma0s = chip_smoke.bsp_path(dev)
    bsolve = bsolver("cuda")
    bsolve(bmu0s, bsigma0s)
    trials0 = bsolve.trials
    kept, originals = chip_smoke.kept_launches({"K8": (bsp_module, "cuda_bsp_backward_packed")},
                                               lambda: bsolve(bmu0s, bsigma0s))
    k8_ms, res["K8 BSP path"] = ms_each(kept, originals, "K8")
    res["K8 BSP path, each"] = k8_ms
    res["K8 BSP path, trials"] = bsolve.trials - trials0
    log(json.dumps(res["K8 BSP path"]))
    state0 = bsolve.init(bmu0s, bsigma0s)
    res["bsp_outer_iteration_ms"] = [chip_smoke.time_cuda(lambda: bsolve.iteration(state0), 1)
                                     for _ in range(3)]
    bcost, bdyn, blam = chip_smoke.bench_belief_problem(chip_smoke.T_BSP, chip_smoke.N_BSP, dev)
    bench = cb.pack_belief(bcost, bdyn)
    car = cb.pack_belief(*chip_smoke.belief_problem(chip_smoke.N_BSP, chip_smoke.T_BSP, 4, 2, 3,
                                                    torch.float32, dev))
    lam_car = torch.full((chip_smoke.N_BSP,), 0.1, **f32)
    res["K8 seeded"] = {
        "bench.py:511 (2, 2)": [C.back_to_back(lambda: cb.cuda_bsp_backward_packed(bench, blam, 1), 20)
                                for _ in range(3)],
        "Car (4, 2) T=25 N=4096": [
            C.back_to_back(lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1), 20)
            for _ in range(3)]}
    log(json.dumps(res["K8 seeded"]))
    stamp, buf = stamp_buffer("belief stamped", "belief_stamps")
    C.use("belief.cu", "belief stamped")
    res["K8 stamps"] = {}
    for label, call in (("path launch 1", lambda: originals["K8"](*kept["K8"][0][0], **kept["K8"][0][1])),
                        ("bench.py:511", lambda: cb.cuda_bsp_backward_packed(bench, blam, 1)),
                        ("Car (4, 2)", lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1))):
        call()
        stamp(buf, 1)
        res["K8 stamps"][label] = stamps_per_step(list(buf), K8_STAMP_NAMES, 6)
    C.use("belief.cu", "belief")
    log(json.dumps(res["K8 stamps"]))


def k5_replan(wrapper):
    """chip_smoke.py's replan with ``cuda_pscan.cuda_pilqr_backward`` replaced
    by ``wrapper``: its launches' operands (kept) and the replan's ms."""
    pend = trajopt_torch.make("Pendulum-TO-v0", dt=0.05)
    x0 = torch.tensor(pend.x0, **f32)
    solve = mpcmod.make_ilqr_solver(pend, chip_smoke.T_REPLAN, nb_iter=chip_smoke.ITER_REPLAN,
                                    backward="cuda-pscan", device=dev, dtype=torch.float32)
    saved = cp.cuda_pilqr_backward
    cp.cuda_pilqr_backward = wrapper
    try:
        kept = C.capture([cp], ["cuda_pilqr_backward"], lambda: solve(x0))["cuda_pilqr_backward"]
        ms = solve_ms(lambda: solve(x0))
    finally:
        cp.cuda_pilqr_backward = saved
    return kept, ms


def k5_problems(kept):
    """K5's problems of the A/B scripts: the replan's kept launches, the
    seeded SPD problem at T=1000 dims 4/2 (float32 and float64), the MPC
    path's first backward (T=25) and chip_smoke.py's float64 and non-PD
    checks."""
    out = {f"replan launch {i + 1}": a for i, a in enumerate(kept)}
    out["SPD T=1000 4/2"] = chip_smoke.pscan_problem(1000, 4, 2, torch.float32, dev)
    pend = trajopt_torch.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    x0 = torch.tensor(pend.x0, **f32)
    out["MPC T=25 2/1"] = chip_smoke.replan_inputs(pend, x0, chip_smoke.MPC_HORIZON)[:3]
    for T in (60, 333):
        out[f"SPD T={T} 4/2"] = chip_smoke.pscan_problem(T, 4, 2, torch.float32, dev)
    for T, dx, du in ((19, 3, 2), (130, 2, 1), (1000, 4, 2), (2500, 4, 2)):
        cost, A, B = chip_smoke.pscan_problem(T, dx, du, torch.float64, dev, seed=T)
        for lam in (0.0, 0.6):
            out[f"f64 T={T} {dx}/{du} λ={lam}"] = (chip_smoke.with_lambda(cost, lam), A, B)
    out["f64 non-PD T=130 2/1"] = chip_smoke.pscan_problem(130, 2, 1, torch.float64, dev,
                                                           non_pd=True)
    return out


def k5(opts, res):
    par = opts.parent
    stamped = C.patched_copy(par, K5_GLOBAL_STAMPS, "s0_k5")
    C.build_variants({"k5 par": par / "pscan_backward.cu",
                      "k5 par stamped": stamped / "pscan_backward.cu"})
    res["ptxas"] = C.reports
    log(json.dumps(res["ptxas"]))
    kept, res["replan_ms"] = k5_replan(C.k5_wrapper("k5 par"))
    log(f"replan: {len(kept)} K5 launches, ms {res['replan_ms']}")
    spd = chip_smoke.pscan_problem(1000, 4, 2, torch.float32, dev)
    shapes = {f"replan launch {i + 1}": a for i, a in enumerate(kept)}
    shapes["SPD T=1000 4/2"] = spd
    res["ms"] = {}
    for key, a in shapes.items():
        res["ms"][key] = [chip_smoke.device_ms_per_launch(
            lambda: C.k5_call("k5 par", *a), 50, "pscan_backward")[0] for _ in range(2)]
    log(json.dumps(res["ms"]))
    fn, buf = stamp_buffer("k5 par stamped", "k5_stamps")
    res["stamps"] = {}
    for key in ("replan launch 1", "SPD T=1000 4/2"):
        C.k5_call("k5 par stamped", *shapes[key])
        fn(buf, 1)
        res["stamps"][key] = k5_stamp_report(list(buf))
    log(json.dumps(res["stamps"]))


if __name__ == "__main__":
    C.run({"K11,K12,K2,K3": sweeps, "K6,K7,K13": gps_k13, "K7,K8": kl_belief, "K5": k5})
