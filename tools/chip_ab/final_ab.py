"""The parent's kernels against this tree's, in one process on one card.

``--kernels K2,K3,K11,K12,K14`` (the eLQR sweeps and K2/K3's quotient): the
outputs bit for bit (eLQR solves through the streamed and the fused engine
at N = 1024, 64, 3, 129 in float32 and N=50 in float64, the streamed engine
against the fused one at N=64, ELQR_EXACT_CASES through both engines; K2/K3
on every call of one iLQR main-path solve), chip_smoke.py's exact K2/K3
cases and float64 eLQR checks; in turns (parent, tree, tree, parent)
K11/K12's device ms at the first-iteration operands and on each launch of
the N=1024 solve, K14's at N=64 and N=1, the N=1024 solve's ms, K2/K3's on
the main path's first and last call and the main path's ms per
batch-iteration; the N=1024 solve under torch.profiler; the share of K2/K3
chunks retaken; clock64 stamps of this tree's sweep steps.

``--kernels K6,K7,K13,K14`` (the GPS backward and the eLQR rollout): bit
for bit (every output's SHA-256, NaNs made canonical) K6 on each of the 64
launches of one GPS outer iteration (Pendulum, T=100, N=4096), at the dual
chain's shape (T=1000, N=4096, dims 4/2), in float32 and float64 at dims
2/1, 4/1 and 4/2 with α ∈ {1e-16, 1, 1e16}, N=50 and a ragged N=3, and
with −Quu indefinite; the eLQR solves through the streamed and the fused
engine at N = 1024, 64, 3, 129 (float32) and N=50 (float64), and this
tree's K13 without its gain prefetch.  Then chip_smoke.py's exact K6 case
on both builds, its K6/K7 and float64 eLQR checks and the streamed engine
against the fused one on this tree; in turns (parent, tree, tree, parent)
K6/K7 on the GPS path's launches, at α = 1 and at the dual chain's shape,
the GPS outer iteration, K11-K13 on the eLQR path's launches, K13 at the
first-iteration operands, K14 at N=64 and N=1 and the N=1024 solve; the
N=1024 solve and a GPS outer iteration under torch.profiler; clock64 stamps
of this tree's K6 and K13; registers and spills.

``--kernels K1,K4,K5,K6,K7,K8`` (the kernels that factor through
bwd_step.cuh's guarded Cholesky; this tree against the parent and against
this tree with ``chol``'s ``Pivot`` flag on for every caller): bit for bit
K1 and K4 at chip_smoke.py's
main-path shape (Cartpole, N=2048, T=1000, float32, reg 1 and 2) and small
(N=50, T=45, float64) and K1 on each of its 20 launches of one main-path
solve; K5 on the replan's first backward (Pendulum, T=100), the T=1000
4/2 problem and chip_smoke.py's float64 and non-PD problems; K6 and K7 on
the GPS path's 64 launches each, at the dual chain's shape and on small
float32/float64 problems at dims 2/1, 4/1, 4/2 with α ∈ {1e-16, 1, 1e16};
K8 at the bench's backward shape (T=25, N=4096), at Car's (4, 2), on each
launch of one batched BSP solve and on chip_smoke.py's float64 problems
with a non-PD instance.  Then in turns (tree, PivotOps everywhere, the
same, tree) each kernel's device ms there (K1, K6, K7 and K8 also on their
paths' launches, K5 from torch.profiler), and the iLQR main path's ms per
batch-iteration; registers and spills.

``--kernels K7,K8`` (the GPS forward KL and the belief-value backward):
bit for bit K6 and K7 on each of the 64 launches of one GPS outer iteration,
K7 at α = 1, both at the dual chain's shape and on the small float32/float64
problems (dims 2/1, 4/1, 4/2, α ∈ {1e-16, 1, 1e16}, N = 50, 3 and 4096,
non-PD); K8 on every launch of one batched BSP solve (LightDark, T=25,
N=4096, 10 iterations), at bench.py:511's shape and Car's (4, 2) for reg 1
and 2, and on chip_smoke.py's float32/float64 problems at (2, 2) and (4, 2)
(N=37, reg 1 and 2, λ 0 and 3.7, instance 0 non-PD).  Then chip_smoke.py's
exact K6, K7 and K8 cases on both builds and its K6/K7 and K8 checks on this
tree; in turns (parent, tree, tree, parent) K6/K7 on the GPS path's
launches, K7 at α = 1, K6/K7 at the dual chain, K8 on the BSP path's
launches, at bench.py:511 and at Car's (4, 2), the GPS and BSP outer
iterations; a GPS outer iteration under torch.profiler; clock64 stamps of
this tree's K6, K7 and K8 walks; registers and spills.

``--kernels K5`` (the parallel-in-time backward): this tree's K5 (the
cluster route k5_route picks, and the global route) bit for bit against the
parent's (the one-block global-scratch kernel) on each of the 6 launches of
chip_smoke.py's replan (kept under the parent's kernel), at T=1000 dims 4/2,
the MPC path's first backward, T=60 and 333, and chip_smoke.py's float64
(λ 0 and 0.6) and non-PD problems; the replan's outputs with the parent's
and this tree's wrappers; chip_smoke.py's K5 checks on this tree; in turns
(parent, tree, tree, parent) K5's device ms (torch.profiler) on each replan
launch and at T=1000 4/2 (and the global route at both), and the replan's
ms; clock64 stamps of this tree's cluster kernel at both shapes; registers
and spills.

Every failed check or unequal output is listed under ``failures``.  See
common.py for how to run it."""
import ctypes
import json
import time

import numpy as np

import common as C
from common import log, torch
from patches import K5_CLUSTER_STAMPS, k5_stamp_report
from patches import ALWAYS_PIVOT, BELIEF_WALK_STAMPS, CHUNK_COUNT, DIV_COUNT, GPS_WALK_STAMPS, K13_NO_PREFETCH, \
    K13_STAMP_NAMES, NEW_K6_STAMPS, WALK_K6_NAMES, WALK_K7_NAMES, WALK_K8_NAMES, k13_stamps, \
    new_k6_report, stamp_report, stamps_per_step, sweep_stamps, walk_report

import chip_smoke
import trajopt_torch
import trajopt_torch.parallel.bsp as bsp_module
import trajopt_torch.parallel.gps as gps_module
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_belief as cb, cuda_elqr as ce, cuda_fused as cf, \
    cuda_gps as cg, cuda_lqr as cl, cuda_pscan as cp, cuda_rollout as cr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel.elqr import make_elqr_solver_batched
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched
from trajopt_torch.solvers.common import DEFAULT_ALPHAS

chip_smoke.torch = torch
dev = torch.device("cuda")
f32 = dict(dtype=torch.float32, device=dev)


def check(res, label, fn):
    """Run chip_smoke.py's check ``fn``; a failure goes to res["failures"]."""
    try:
        fn()
        log(f"PASS {label}")
    except SystemExit as e:
        log(f"FAIL {label}: {e}")
        res["failures"].append(f"{label}: {e}")


def equal(res, key, table, value):
    """Record ``table[key] = value``; a False (or any False in a list) goes
    to res["failures"]."""
    table[key] = value
    if not all(value if isinstance(value, list) else [value]):
        res["failures"].append(f"{key}: outputs differ from the parent's")


def same_bits(source, labels, call):
    """Whether ``call()``'s outputs have the same bits with each library of
    ``labels``."""
    out = []
    for lab in labels:
        C.use(source, lab)
        out.append(C.digest(call()))
    return len(set(out)) == 1


def run_solve(env, lab, n, seed=11, it=10, engine="cuda", dtype=torch.float32):
    C.use("elqr.cu", f"elqr {lab}")
    x0s, k0 = chip_smoke.elqr_inputs(n, 100, seed, dtype, dev)
    out = make_elqr_solver_batched(env, 100, it, engine=engine, dtype=dtype, device=dev)(
        x0s, kff_init=k0)
    return C.digest([out[0].K, out[0].kff, *out[1:]])


def exact_engines(env):
    for label, theta0, step, scale, nb_iter in chip_smoke.ELQR_EXACT_CASES:
        x0s, k0 = chip_smoke.elqr_inputs(4, 10, 15, torch.float32, dev, theta0, step)
        got, ref = (make_elqr_solver_batched(env, 10, nb_iter, engine=e, **f32)(
            x0s, kff_init=scale * k0) for e in ("cuda", "cuda-fused"))
        chip_smoke.same_solves(label, got, ref)


def events_ms(fn, runs=3):
    """CUDA-event ms of ``runs`` calls of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return out


def wall_ms_per_iter(fn, runs, iters):
    """Wall ms per iteration of ``runs`` calls of ``fn`` (``iters`` iterations
    each) after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / iters)
    return out


def profiled(fn, skip=()):
    """One call of ``fn`` under torch.profiler: its wall ms, the card's busy
    ms and idle share, and the six kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.key.startswith(skip)]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "by_kernel": [[e.key[:40], e.count, e.self_device_time_total / 1e3] for e in top]}


def main_path_solver(env):
    """The iLQR main path (Cartpole, N=2048, T=1000, 10 iterations) and its x0."""
    xm = torch.zeros(2048, 4, **f32)
    xm[:, 0] = 0.01 * torch.arange(2048, **f32)
    return make_ilqr_solver_batched(env, 1000, nb_iter=10, backward="cuda-fused",
                                    rollout="cuda", time_chunk=8, **f32), xm


def sweeps(opts, res):
    par = opts.parent
    res["failures"] = []
    C._build.build(("fused_backward.cu",))
    C.build_variants({
        "elqr par": par / "elqr.cu", "elqr new": C.NEW / "elqr.cu",
        "elqr stamped": C.patched_copy(C.NEW, sweep_stamps((C.NEW / "elqr.cu").read_text()),
                                       "f_stamped") / "elqr.cu",
        "roll par": par / "rollout.cu", "roll new": C.NEW / "rollout.cu",
        "roll chunks": C.patched_copy(C.NEW, CHUNK_COUNT, "f_chunks") / "rollout.cu",
        "roll divs": C.patched_copy(par, DIV_COUNT, "f_divs") / "rollout.cu"})
    env = trajopt_torch.make("Cartpole-TO-v0")

    # K2/K3's exact cases on both builds; the residue case's shares
    for lab in ("par", "new"):
        C.use("rollout.cu", f"roll {lab}")
        check(res, f"K2/K3 exact cases, {lab}", lambda: chip_smoke.check_rollout_exact(env, dev))
    N, T = chip_smoke.N_ROLLOUT_EXACT, chip_smoke.T_ROLLOUT_EXACT
    alphas = torch.tensor(DEFAULT_ALPHAS, **f32)
    dl, cl_ = C.libs["roll divs"], C.libs["roll chunks"]
    dl.rollout_divs.argtypes = cl_.rollout_chunks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    b2, b3 = (ctypes.c_ulonglong * 2)(), (ctypes.c_ulonglong * 3)()
    res["exact_case_shares"] = {}
    for label, scale in chip_smoke.ROLLOUT_EXACT_CASES:
        rng = np.random.default_rng(21)
        K = 10.0 * rng.standard_normal((T, 4, N))
        kff, xref, uref = (scale * rng.standard_normal(s) for s in ((T, 1, N), (T, 4, N), (T, 1, N)))
        streams = [torch.as_tensor(a, **f32) for a in (K, kff, xref, uref)]
        w = torch.ones(T + 1, **f32)
        for lib, fn, buf in (("roll divs", dl.rollout_divs, b2),
                             ("roll chunks", cl_.rollout_chunks, b3)):
            C.use("rollout.cu", lib)
            fn(buf, 1)
            cr.cuda_rollout_returns(env, *streams, w, alphas)
            fn(buf, 1)
        res["exact_case_shares"][label] = {
            "K2 divisions [all, out of range] (parent)": list(b2),
            "K2 warp-chunks [all, exact retakes, library retakes]": list(b3)}
    log(json.dumps(res["exact_case_shares"]))

    bits = {}
    for n in (1024, 64, 3, 129):
        equal(res, f"cuda N={n} f32", bits, run_solve(env, "par", n) == run_solve(env, "new", n))
    equal(res, "cuda N=50 f64", bits,
          run_solve(env, "par", 50, it=3, dtype=torch.float64)
          == run_solve(env, "new", 50, it=3, dtype=torch.float64))
    for n in (64, 1):
        equal(res, f"cuda-fused N={n} f32", bits, run_solve(env, "par", n, engine="cuda-fused")
              == run_solve(env, "new", n, engine="cuda-fused"))
    for lab in ("par", "new"):
        equal(res, f"{lab}: cuda == cuda-fused, N=64", bits, run_solve(env, lab, 64, 12)
              == run_solve(env, lab, 64, 12, engine="cuda-fused"))
    res["elqr_bits_equal_parent"] = bits
    log(json.dumps(bits))
    C.use("elqr.cu", "elqr new")
    check(res, "float64 eLQR checks", lambda: chip_smoke.check_elqr_f64(dev))
    for lab in ("par", "new"):
        C.use("elqr.cu", f"elqr {lab}")
        check(res, f"ELQR_EXACT_CASES through both engines, {lab}", lambda: exact_engines(env))

    # eLQR in turns
    x0s, kff0 = chip_smoke.elqr_inputs(1024, 100, 11, torch.float32, dev)
    first = (torch.zeros(100, 4, 1024, **f32), to_soa(kff0, 1024), torch.zeros(101, 16, 1024, **f32),
             torch.zeros(101, 4, 1024, **f32), x0s.T.contiguous())
    C.use("elqr.cu", "elqr new")
    fo = ce.cuda_elqr_forward(env, *first)
    k12_first = (fo[0], fo[1], fo[2], fo[3], fo[5])
    solve = make_elqr_solver_batched(env, 100, 10, engine="cuda", **f32)
    k14 = {}
    for n, seed in ((64, 12), (1, 13)):
        x, k = chip_smoke.elqr_inputs(n, 100, seed, torch.float32, dev)
        k14[n] = (to_soa(k, n), x.T.contiguous())
    res["elqr_ms"] = {}
    for lab in ("par", "new", "new", "par"):
        C.use("elqr.cu", f"elqr {lab}")
        d = {"K11 first iteration": C.back_to_back(lambda: ce.cuda_elqr_forward(env, *first), 20),
             "K12 first iteration": C.back_to_back(lambda: ce.cuda_elqr_backward(env, *k12_first), 20),
             "K11/K12 main path": chip_smoke.elqr_main_path_launch_ms(solve, x0s, kff0),
             "K14 N=64": C.back_to_back(lambda: ce.cuda_elqr_solve(env, *k14[64], 10), 5),
             "K14 N=1": C.back_to_back(lambda: ce.cuda_elqr_solve(env, *k14[1], 10), 5),
             "solve N=1024": events_ms(lambda: solve(x0s, kff_init=kff0))}
        res["elqr_ms"].setdefault(lab, []).append(d)
        log(lab, json.dumps(d))
    for lab in ("par", "new"):
        C.use("elqr.cu", f"elqr {lab}")
        res[f"solve N=1024 profile, {lab}"] = profiled(lambda: solve(x0s, kff_init=kff0))
        log(json.dumps(res[f"solve N=1024 profile, {lab}"]))

    # stamps of this tree's sweep steps at the first and last iteration
    C.use("elqr.cu", "elqr new")
    names = ("cuda_elqr_forward", "cuda_elqr_backward")
    kept = C.capture([ce], names, lambda: solve(x0s, kff_init=kff0))
    fns = {n: getattr(ce, n) for n in names}
    lib = C.libs["elqr stamped"]
    lib.elqr_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 20)()
    C.use("elqr.cu", "elqr stamped")
    lib.elqr_stamps(buf, 1)
    res["stamps"] = {}
    for it in (0, 9):
        for n in names:
            fns[n](*kept[n][it])
            lib.elqr_stamps(buf, 1)
            res["stamps"][f"{n} iteration {it + 1}"] = stamp_report(list(buf))
    log(json.dumps(res["stamps"]))

    # the iLQR main path
    msolve, xm = main_path_solver(env)
    C.use("rollout.cu", "roll new")
    rnames = ("cuda_rollout_returns", "cuda_rollout_selected")
    rk = C.capture([cr, mpcmod], rnames, lambda: msolve(xm))
    rfns = {n: getattr(cr, n) for n in rnames}
    same, chunks = {}, {}
    for n in rnames:
        for i, a in enumerate(rk[n]):
            equal(res, f"{n} call {i}", same, same_bits("rollout.cu", ("roll par", "roll new"),
                                                         lambda: rfns[n](*a)))
        C.use("rollout.cu", "roll chunks")
        cl_.rollout_chunks(b3, 1)
        tot = [0, 0, 0]
        for a in rk[n]:
            rfns[n](*a)
            cl_.rollout_chunks(b3, 1)
            tot = [x + y for x, y in zip(tot, b3)]
        chunks[n] = tot
    res["main_path_rollout_bits_equal_parent"] = same
    res["main_path_warp_chunks [all, exact retakes, library retakes]"] = chunks
    log(json.dumps(same))
    log(json.dumps(chunks))
    res["rollout_ms [first call, last call]"], res["main_path_ms_per_batch_iter"] = {}, {}
    for lab in ("par", "new", "new", "par"):
        C.use("rollout.cu", f"roll {lab}")
        res["rollout_ms [first call, last call]"].setdefault(lab, []).append(
            {n: [C.back_to_back(lambda: rfns[n](*rk[n][i]), 10) for i in (0, len(rk[n]) - 1)]
             for n in rnames})
        res["main_path_ms_per_batch_iter"].setdefault(lab, []).append(
            wall_ms_per_iter(lambda: msolve(xm), 5, 10))
    log(json.dumps(res["rollout_ms [first call, last call]"]))
    log(json.dumps(res["main_path_ms_per_batch_iter"]))


def gps_k13(opts, res):
    par = opts.parent
    res["failures"] = []
    C.build_variants({"gps par": par / "gps.cu", "gps new": C.NEW / "gps.cu",
                      "elqr par": par / "elqr.cu", "elqr new": C.NEW / "elqr.cu",
                      "elqr noprefetch": C.patched_copy(C.NEW, K13_NO_PREFETCH, "ab_np") / "elqr.cu"})
    try:
        C.build_variants({
            "gps stamped": C.patched_copy(C.NEW, NEW_K6_STAMPS, "ab_gps_st") / "gps.cu",
            "elqr stamped": C.patched_copy(C.NEW, k13_stamps((C.NEW / "elqr.cu").read_text()),
                                           "ab_elqr_st") / "elqr.cu"})
    except RuntimeError as e:
        log(f"stamped builds failed: {e}")
    res["ptxas"] = {k: {n: v for n, v in r.items() if "gps" in n or "rollout" in n}
                    for k, r in C.reports.items()}
    log(json.dumps(res["ptxas"]))
    gps = ("gps par", "gps new")

    # K6 bit for bit
    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    C.use("gps.cu", "gps new")
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    kept, originals = chip_smoke.kept_launches(
        {"K6": (gps_module, "cuda_gps_backward_packed"),
         "K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    same = {}
    equal(res, "K6 GPS path launches (64)", same,
          [same_bits("gps.cu", gps, lambda: originals["K6"](*a, **kw)) for a, kw in kept["K6"]])
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(chip_smoke.T_DUAL, 4, 2,
                                                                     chip_smoke.N_DUAL, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)
    equal(res, "K6 dual chain T=1000 N=4096 4/2", same,
          same_bits("gps.cu", gps, lambda: cg.cuda_gps_backward_packed(dual, dual_alpha)))
    for key, packed, al in small_gps_problems(with_4096=True):
        equal(res, f"K6 {key}", same,
              same_bits("gps.cu", gps, lambda: cg.cuda_gps_backward_packed(packed, al)))
    log(json.dumps(same))
    res["k6_bits_equal_parent"] = same
    packed = cg.pack_gps(state0.cost, state0.dyn, state0.ctl, mu0s, sigma0s)
    for lab in ("par", "new"):
        C.use("gps.cu", f"gps {lab}")
        check(res, f"K6 exact case (plain version on the card), {lab}",
              lambda: chip_smoke.check_k6_exact(packed))
    C.use("gps.cu", "gps new")
    check(res, "K6/K7 checks against the plain versions, new",
          lambda: chip_smoke.check_gps_kernels(dev))

    # eLQR bit for bit
    env = trajopt_torch.make("Cartpole-TO-v0")
    eb = {}
    for n in (1024, 64, 3, 129):
        h = [run_solve(env, lab, n) for lab in ("par", "new", "noprefetch")]
        equal(res, f"cuda N={n} f32 [new, no prefetch] == parent", eb, [h[1] == h[0], h[2] == h[0]])
    h = [run_solve(env, lab, 50, it=3, dtype=torch.float64) for lab in ("par", "new")]
    equal(res, "cuda N=50 f64 == parent", eb, h[0] == h[1])
    for n in (64, 1):
        h = [run_solve(env, lab, n, engine="cuda-fused") for lab in ("par", "new")]
        equal(res, f"cuda-fused N={n} f32 == parent", eb, h[0] == h[1])
    equal(res, "new: cuda == cuda-fused, N=64", eb,
          run_solve(env, "new", 64, 12) == run_solve(env, "new", 64, 12, engine="cuda-fused"))
    res["elqr_bits"] = eb
    log(json.dumps(eb))
    C.use("elqr.cu", "elqr new")
    check(res, "float64 eLQR checks, new", lambda: chip_smoke.check_elqr_f64(dev))
    check(res, "ELQR_EXACT_CASES through both engines, new", lambda: exact_engines(env))

    # in turns
    alpha1 = cg.pack_gps_alpha(torch.ones(chip_smoke.N_GPS, chip_smoke.T_GPS, **f32))
    k6_first = cg.cuda_gps_backward_packed(packed, alpha1)
    x0s, k0 = chip_smoke.elqr_inputs(1024, 100, 11, torch.float32, dev)
    esolve = make_elqr_solver_batched(env, 100, 10, engine="cuda", **f32)
    k13_first = (torch.zeros(100, 4, 1024, **f32), to_soa(k0, 1024), x0s.T.contiguous())
    k14 = {}
    for n, seed in ((64, 12), (1, 13)):
        x, k = chip_smoke.elqr_inputs(n, 100, seed, torch.float32, dev)
        k14[n] = (to_soa(k, n), x.T.contiguous())
    res["turns"] = {}
    for lab in ("par", "new", "new", "par"):
        C.use("gps.cu", f"gps {lab}")
        C.use("elqr.cu", f"elqr {lab}")
        path = chip_smoke.replay_ms(kept, originals)
        main = chip_smoke.elqr_main_path_launch_ms(esolve, x0s, k0)
        d = {"K6 GPS path": chip_smoke.spread(path["K6"]),
             "K7 GPS path": chip_smoke.spread(path["K7"]),
             "K6 α=1": C.back_to_back(lambda: cg.cuda_gps_backward_packed(packed, alpha1), 20),
             "K7 α=1": C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(packed, *k6_first[:3]), 20),
             "K6 dual chain": C.back_to_back(lambda: cg.cuda_gps_backward_packed(dual, dual_alpha), 5),
             "GPS outer iteration": events_ms(lambda: solve.iteration(state0)),
             "K13 eLQR path": main["K13"], "K11 eLQR path": chip_smoke.spread(main["K11"]),
             "K12 eLQR path": chip_smoke.spread(main["K12"]),
             "K13 first-iteration operands": C.back_to_back(
                 lambda: ce.cuda_elqr_rollout(env, *k13_first), 20),
             "K14 N=64": C.back_to_back(lambda: ce.cuda_elqr_solve(env, *k14[64], 10), 5),
             "K14 N=1": C.back_to_back(lambda: ce.cuda_elqr_solve(env, *k14[1], 10), 5),
             "eLQR solve N=1024": events_ms(lambda: esolve(x0s, kff_init=k0))}
        res["turns"].setdefault(lab, []).append(d)
        log(lab, json.dumps(d))
        if lab == "new":
            C.use("elqr.cu", "elqr noprefetch")
            m = chip_smoke.elqr_main_path_launch_ms(esolve, x0s, k0)["K13"]
            res.setdefault("K13 eLQR path, no prefetch", []).append(m)
            log("no prefetch", json.dumps(m))
    for lab in ("par", "new"):
        C.use("gps.cu", f"gps {lab}")
        C.use("elqr.cu", f"elqr {lab}")
        for name, fn in (("eLQR solve N=1024", lambda: esolve(x0s, kff_init=k0)),
                         ("GPS outer iteration", lambda: solve.iteration(state0))):
            res[f"profile {name}, {lab}"] = profiled(fn, skip=("gps.",))
            log(json.dumps(res[f"profile {name}, {lab}"]))

    # stamps of this tree's K6 and K13
    res["stamps"] = {}
    if "gps stamped" in C.libs:
        fn = C.libs["gps stamped"].gps_stamps
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * 20)()
        C.use("gps.cu", "gps stamped")
        fn(buf, 1)
        for label, call in (("K6 path launch 1", lambda: originals["K6"](*kept["K6"][0][0])),
                            ("K6 path launch 64", lambda: originals["K6"](*kept["K6"][-1][0])),
                            ("K6 dual chain", lambda: cg.cuda_gps_backward_packed(dual, dual_alpha))):
            call()
            fn(buf, 1)
            res["stamps"][label] = new_k6_report(list(buf))
    if "elqr stamped" in C.libs:
        C.use("elqr.cu", "elqr new")
        k13 = chip_smoke.kept_launches({"K13": (ce, "cuda_elqr_rollout")},
                                       lambda: esolve(x0s, kff_init=k0))[0]["K13"]
        fn = C.libs["elqr stamped"].elqr_stamps
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * 20)()
        C.use("elqr.cu", "elqr stamped")
        fn(buf, 1)
        for i in (0, 3, len(k13) - 2, len(k13) - 1):
            ce.cuda_elqr_rollout(*k13[i][0], **k13[i][1])
            fn(buf, 1)
            res["stamps"][f"K13 launch {i + 1}"] = stamps_per_step(list(buf), K13_STAMP_NAMES, 4)
    log(json.dumps(res["stamps"]))


def small_gps_problems(with_4096=False):
    """(label, packed, packed α) of K6's small cases: float32 and float64 at
    dims 2/1, 4/1, 4/2, T=48, N=50 and a ragged N=3 with α ∈ {1e-16, 1,
    1e16}, N=50 with −Quu indefinite at step 1 (α = 1), and, in float32 with
    ``with_4096``, N=4096."""
    for dt in (torch.float32, torch.float64):
        for dx, du in ((2, 1), (4, 1), (4, 2)):
            for n, non_pd in ((50, None), (3, None), (50, 1), (4096, None)):
                if n == 4096 and (dt == torch.float64 or not with_4096):
                    continue
                problem = chip_smoke.gps_problem(n, 48, dx, du, 7, dt, dev,
                                                 (1e-16, 1.0, 1e16) if non_pd is None else (1.0,),
                                                 non_pd_at=non_pd)
                key = f"{str(dt)[6:]} {dx}/{du} N={n}" + (" non-PD" if non_pd else "")
                yield key, cg.pack_gps(*problem[:3], *problem[4:]), cg.pack_gps_alpha(problem[3])


def pivots(opts, res):
    par = opts.parent
    res["failures"] = []
    sources = {"fused_backward.cu": "K1", "ilqr_backward.cu": "K4", "pscan_backward.cu": "K5",
               "gps.cu": "K6/K7", "belief.cu": "K8"}
    piv = C.patched_copy(C.NEW, ALWAYS_PIVOT, "ab_pivot")
    C.build_variants({f"{src} {lab}": d / src for src in sources
                      for lab, d in (("par", par), ("new", C.NEW), ("pivot", piv))})
    res["ptxas"] = C.reports

    def use(lab):
        for src in sources:
            C.use(src, f"{src} {lab}")

    def bits(call):
        out = []
        for lab in ("par", "new", "pivot"):
            use(lab)
            out.append(C.digest(call()))
        return len(set(out)) == 1

    same, calls = {}, {}
    # K1 and K4: the main-path shape (float32) and a small float64 one
    env = trajopt_torch.make("Cartpole-TO-v0")
    for N, T, dt in ((chip_smoke.N_MAIN, chip_smoke.T_MAIN, torch.float32),
                     (chip_smoke.N_RAGGED, chip_smoke.T_RAGGED, torch.float64)):
        inp = chip_smoke.kernel_inputs(env, N, T, 0, dt, dev)
        for reg in (1, 2):
            k1 = (env, inp["xr"], inp["ur"], inp["ul"], inp["xT"], inp["w"], inp["lam"], reg)
            k4 = (inp["packed"], inp["lam"], reg)
            key = f"{str(dt)[6:]} N={N} T={T} reg={reg}"
            equal(res, f"K1 {key}", same, bits(lambda: cf.cuda_ilqr_backward_fused(*k1)))
            equal(res, f"K4 {key}", same, bits(lambda: cl.cuda_ilqr_backward_packed(*k4)))
            if dt == torch.float32 and reg == 1:
                calls["K1"] = lambda a=k1: cf.cuda_ilqr_backward_fused(*a)
                calls["K4"] = lambda a=k4: cl.cuda_ilqr_backward_packed(*a)
    msolve, xm = main_path_solver(env)
    use("new")
    k1_kept, k1_orig = chip_smoke.kept_launches({"K1": (mpcmod, "cuda_ilqr_backward_fused")},
                                                lambda: msolve(xm))
    equal(res, "K1 main-path launches (20)", same,
          [bits(lambda: k1_orig["K1"](*a, **kw)) for a, kw in k1_kept["K1"]])

    # K5: the replan's first backward, the T=1000 4/2 problem, f64 and non-PD
    pend = trajopt_torch.make("Pendulum-TO-v0", dt=0.05)
    x0_p = torch.tensor(pend.x0, dtype=torch.float32, device=dev)
    k5 = {"replan T=100 2/1": chip_smoke.replan_inputs(pend, x0_p, chip_smoke.T_REPLAN)[:3],
          "SPD T=1000 4/2": chip_smoke.pscan_problem(1000, 4, 2, torch.float32, dev)}
    for T, dx, du in ((19, 3, 2), (130, 2, 1), (2500, 4, 2)):
        cost, A, B = chip_smoke.pscan_problem(T, dx, du, torch.float64, dev, seed=T)
        k5[f"f64 T={T} {dx}/{du} λ=0.6"] = (chip_smoke.with_lambda(cost, 0.6), A, B)
    k5["f64 non-PD T=130 2/1"] = chip_smoke.pscan_problem(130, 2, 1, torch.float64, dev, non_pd=True)
    for key, a in k5.items():
        equal(res, f"K5 {key}", same, bits(lambda: cp.cuda_pilqr_backward(*a)))

    # K6 and K7: the GPS path's launches, the dual chain, the small problems
    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    use("new")
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    kept, originals = chip_smoke.kept_launches(
        {"K6": (gps_module, "cuda_gps_backward_packed"),
         "K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    for k in ("K6", "K7"):
        equal(res, f"{k} GPS path launches (64)", same,
              [bits(lambda: originals[k](*a, **kw)) for a, kw in kept[k]])
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(chip_smoke.T_DUAL, 4, 2,
                                                                     chip_smoke.N_DUAL, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)
    use("par")
    k6d = cg.cuda_gps_backward_packed(dual, dual_alpha)
    equal(res, "K6 dual chain T=1000 N=4096 4/2", same,
          bits(lambda: cg.cuda_gps_backward_packed(dual, dual_alpha)))
    equal(res, "K7 dual chain T=1000 N=4096 4/2", same,
          bits(lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3])))
    for key, packed, al in small_gps_problems():
        use("par")
        k6s = cg.cuda_gps_backward_packed(packed, al)
        equal(res, f"K6 {key}", same, bits(lambda: cg.cuda_gps_backward_packed(packed, al)))
        equal(res, f"K7 {key}", same, bits(lambda: cg.cuda_gps_forward_kl_packed(packed, *k6s[:3])))
    calls["K6 dual chain"] = lambda: cg.cuda_gps_backward_packed(dual, dual_alpha)
    calls["K7 dual chain"] = lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3])

    # K8: the bench's backward shape, chip_smoke.py's float64 problems
    bcost, bdyn, blam = chip_smoke.bench_belief_problem(chip_smoke.T_BSP, chip_smoke.N_BSP, dev)
    bpacked = cb.pack_belief(bcost, bdyn)
    equal(res, f"K8 f32 T={chip_smoke.T_BSP} N={chip_smoke.N_BSP}", same,
          bits(lambda: cb.cuda_bsp_backward_packed(bpacked, blam, 1)))
    calls["K8"] = lambda: cb.cuda_bsp_backward_packed(bpacked, blam, 1)
    car = cb.pack_belief(*chip_smoke.belief_problem(chip_smoke.N_BSP, chip_smoke.T_BSP, 4, 2, 3,
                                                    torch.float32, dev))
    lam_car = torch.full((chip_smoke.N_BSP,), 0.1, **f32)
    equal(res, "K8 Car (4, 2) f32 T=25 N=4096", same,
          bits(lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1)))
    calls["K8 Car (4, 2)"] = lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1)
    _, bsolver, bmu0s, bsigma0s = chip_smoke.bsp_path(dev)
    use("new")
    bkept, boriginals = chip_smoke.kept_launches(
        {"K8": (bsp_module, "cuda_bsp_backward_packed")}, lambda: bsolver("cuda")(bmu0s, bsigma0s))
    equal(res, f"K8 BSP path launches ({len(bkept['K8'])})", same,
          [bits(lambda: boriginals["K8"](*a, **kw)) for a, kw in bkept["K8"]])
    lam64 = torch.as_tensor(np.where(np.arange(37) % 2, 3.7, 0.0), dtype=torch.float64, device=dev)
    for b in (2, 4):
        for reg in (1, 2):
            p = cb.pack_belief(*chip_smoke.belief_problem(37, 9, b, 2, b + reg, torch.float64, dev,
                                                          bad=True))
            equal(res, f"K8 f64 b={b} reg={reg} non-PD", same,
                  bits(lambda: cb.cuda_bsp_backward_packed(p, lam64, reg)))
    res["bits_equal_parent"] = same
    log(json.dumps(same))

    # in turns: this tree and this tree with PivotOps in every chol
    res["turns"] = {}
    for lab in ("new", "pivot", "pivot", "new"):
        use(lab)
        path = chip_smoke.replay_ms({**kept, **k1_kept, **bkept}, {**originals, **k1_orig, **boriginals})
        d = {k: C.back_to_back(fn, 5 if "dual" in k else 20) for k, fn in calls.items()}
        d.update({f"{k} path": chip_smoke.spread(v) for k, v in path.items()})
        d.update({f"K5 {key}": chip_smoke.device_ms_per_launch(
            lambda: cp.cuda_pilqr_backward(*k5[key]), 50, "pscan_backward")[0]
            for key in ("replan T=100 2/1", "SPD T=1000 4/2")})
        d["iLQR main path ms per batch-iteration"] = wall_ms_per_iter(lambda: msolve(xm), 3, 10)
        res["turns"].setdefault(lab, []).append(d)
        log(lab, json.dumps(d))


def belief_problems():
    """(label, packed, λ, reg) of K8's small cases: float32 and float64 at
    (b, a) = (2, 2) and (4, 2), N=37, T=9, reg 1 and 2, λ alternating 0 and
    3.7, instance 0 not positive definite."""
    for dt in (torch.float32, torch.float64):
        lam = torch.as_tensor(np.where(np.arange(37) % 2, 3.7, 0.0), dtype=dt, device=dev)
        for b in (2, 4):
            for reg in (1, 2):
                p = cb.pack_belief(*chip_smoke.belief_problem(37, 9, b, 2, b + reg, dt, dev, bad=True))
                yield f"{str(dt)[6:]} b={b} reg={reg} N=37 non-PD", p, lam, reg


def kl_belief(opts, res):
    par = opts.parent
    res["failures"] = []
    C.build_variants({"gps par": par / "gps.cu", "gps new": C.NEW / "gps.cu",
                      "belief par": par / "belief.cu", "belief new": C.NEW / "belief.cu"})
    try:
        C.build_variants({
            "gps stamped": C.patched_copy(C.NEW, GPS_WALK_STAMPS, "ab_gps_walk") / "gps.cu",
            "belief stamped": C.patched_copy(C.NEW, BELIEF_WALK_STAMPS, "ab_belief_walk") / "belief.cu"})
    except RuntimeError as e:
        log(f"stamped builds failed: {e}")
    res["ptxas"] = {k: {n: v for n, v in r.items() if "gps" in n or "bsp" in n}
                    for k, r in C.reports.items()}
    log(json.dumps(res["ptxas"]))
    gps, bel = ("gps par", "gps new"), ("belief par", "belief new")
    same = {}

    # K6 and K7 bit for bit: the GPS path's launches, α = 1, the dual chain, small problems
    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    C.use("gps.cu", "gps new")
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    kept, originals = chip_smoke.kept_launches(
        {"K6": (gps_module, "cuda_gps_backward_packed"),
         "K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    for k in ("K6", "K7"):
        equal(res, f"{k} GPS path launches (64)", same,
              [same_bits("gps.cu", gps, lambda: originals[k](*a, **kw)) for a, kw in kept[k]])
    packed = cg.pack_gps(state0.cost, state0.dyn, state0.ctl, mu0s, sigma0s)
    alpha1 = cg.pack_gps_alpha(torch.ones(chip_smoke.N_GPS, chip_smoke.T_GPS, **f32))
    k6_first = cg.cuda_gps_backward_packed(packed, alpha1)
    equal(res, "K7 solver path α = 1", same,
          same_bits("gps.cu", gps, lambda: cg.cuda_gps_forward_kl_packed(packed, *k6_first[:3])))
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(chip_smoke.T_DUAL, 4, 2,
                                                                     chip_smoke.N_DUAL, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)
    k6d = cg.cuda_gps_backward_packed(dual, dual_alpha)
    equal(res, "K6 dual chain T=1000 N=4096 4/2", same,
          same_bits("gps.cu", gps, lambda: cg.cuda_gps_backward_packed(dual, dual_alpha)))
    equal(res, "K7 dual chain T=1000 N=4096 4/2", same,
          same_bits("gps.cu", gps, lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3])))
    for key, p, al in small_gps_problems(with_4096=True):
        C.use("gps.cu", "gps par")
        k6s = cg.cuda_gps_backward_packed(p, al)
        equal(res, f"K6 {key}", same, same_bits("gps.cu", gps, lambda: cg.cuda_gps_backward_packed(p, al)))
        equal(res, f"K7 {key}", same,
              same_bits("gps.cu", gps, lambda: cg.cuda_gps_forward_kl_packed(p, *k6s[:3])))

    # K8 bit for bit: the BSP solve's launches, bench.py:511, Car's (4, 2), small problems
    _, bsolver, bmu0s, bsigma0s = chip_smoke.bsp_path(dev)
    bsolve = bsolver("cuda")
    C.use("belief.cu", "belief new")
    bkept, boriginals = chip_smoke.kept_launches({"K8": (bsp_module, "cuda_bsp_backward_packed")},
                                                 lambda: bsolve(bmu0s, bsigma0s))
    equal(res, f"K8 BSP path launches ({len(bkept['K8'])})", same,
          [same_bits("belief.cu", bel, lambda: boriginals["K8"](*a, **kw)) for a, kw in bkept["K8"]])
    bcost, bdyn, blam = chip_smoke.bench_belief_problem(chip_smoke.T_BSP, chip_smoke.N_BSP, dev)
    bench = cb.pack_belief(bcost, bdyn)
    car = cb.pack_belief(*chip_smoke.belief_problem(chip_smoke.N_BSP, chip_smoke.T_BSP, 4, 2, 3,
                                                    torch.float32, dev))
    lam_car = torch.full((chip_smoke.N_BSP,), 0.1, **f32)
    for reg in (1, 2):
        equal(res, f"K8 bench.py:511 reg={reg}", same,
              same_bits("belief.cu", bel, lambda: cb.cuda_bsp_backward_packed(bench, blam, reg)))
        equal(res, f"K8 Car (4, 2) T=25 N=4096 reg={reg}", same,
              same_bits("belief.cu", bel, lambda: cb.cuda_bsp_backward_packed(car, lam_car, reg)))
    for key, p, lam, reg in belief_problems():
        equal(res, f"K8 {key}", same,
              same_bits("belief.cu", bel, lambda: cb.cuda_bsp_backward_packed(p, lam, reg)))
    res["bits_equal_parent"] = same
    log(json.dumps(same))

    # chip_smoke.py's checks: the exact cases on both builds, the tolerance checks on this tree's
    bstate0 = bsolve.init(bmu0s, bsigma0s)
    from trajopt_torch.core.belief import belief_cost_expansion, belief_dynamics_expansion
    env_ld = trajopt_torch.make("LightDark-TO-v0")
    T_b = chip_smoke.T_BSP
    first_b = cb.pack_belief(
        belief_cost_expansion(env_ld, bstate0.bref_mu, bstate0.bref_sigma, bstate0.uref),
        belief_dynamics_expansion(env_ld, bstate0.bref_mu[:, :T_b], bstate0.bref_sigma[:, :T_b],
                                  bstate0.uref))
    for lab in ("par", "new"):
        C.use("gps.cu", f"gps {lab}")
        C.use("belief.cu", f"belief {lab}")
        check(res, f"K6 exact case, {lab}", lambda: chip_smoke.check_k6_exact(packed))
        check(res, f"K7 exact case, {lab}", lambda: chip_smoke.check_k7_exact(packed))
        check(res, f"K8 exact case, {lab}",
              lambda: chip_smoke.check_k8_exact(first_b, bstate0.lmbda.contiguous()))
    check(res, "K6/K7 checks against the plain versions, new", lambda: chip_smoke.check_gps_kernels(dev))
    check(res, "K8 checks against the plain version, new", lambda: chip_smoke.check_k8(dev))

    # in turns
    res["turns"] = {}
    for lab in ("par", "new", "new", "par"):
        C.use("gps.cu", f"gps {lab}")
        C.use("belief.cu", f"belief {lab}")
        path = chip_smoke.replay_ms(kept, originals)
        bpath = chip_smoke.replay_ms(bkept, boriginals)
        d = {"K6 GPS path": chip_smoke.spread(path["K6"]),
             "K7 GPS path": chip_smoke.spread(path["K7"]),
             "K7 α=1": C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(packed, *k6_first[:3]), 20),
             "K7 dual chain": C.back_to_back(lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3]), 5),
             "K6 dual chain": C.back_to_back(lambda: cg.cuda_gps_backward_packed(dual, dual_alpha), 5),
             "K8 BSP path": chip_smoke.spread(bpath["K8"]),
             "K8 bench.py:511": C.back_to_back(lambda: cb.cuda_bsp_backward_packed(bench, blam, 1), 20),
             "K8 Car (4, 2)": C.back_to_back(lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1), 20),
             "GPS outer iteration": events_ms(lambda: solve.iteration(state0)),
             "BSP outer iteration": events_ms(lambda: bsolve.iteration(bstate0))}
        res["turns"].setdefault(lab, []).append(d)
        res.setdefault("K7 GPS path, each", {}).setdefault(lab, []).append(path["K7"])
        res.setdefault("K8 BSP path, each", {}).setdefault(lab, []).append(bpath["K8"])
        log(lab, json.dumps(d))
    for lab in ("par", "new"):
        C.use("gps.cu", f"gps {lab}")
        res[f"profile GPS outer iteration, {lab}"] = profiled(lambda: solve.iteration(state0),
                                                              skip=("gps.",))
        log(json.dumps(res[f"profile GPS outer iteration, {lab}"]))

    # stamps of this tree's K6, K7 and K8
    res["stamps"] = {}
    for lib, src, entry, calls in (
            ("gps stamped", "gps.cu", "gps_stamps",
             (("K6 path launch 1", WALK_K6_NAMES, lambda: originals["K6"](*kept["K6"][0][0])),
              ("K7 path launch 1", WALK_K7_NAMES, lambda: originals["K7"](*kept["K7"][0][0])),
              ("K7 α=1", WALK_K7_NAMES, lambda: cg.cuda_gps_forward_kl_packed(packed, *k6_first[:3])),
              ("K7 dual chain", WALK_K7_NAMES, lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3])))),
            ("belief stamped", "belief.cu", "belief_stamps",
             (("K8 path launch 1", WALK_K8_NAMES, lambda: boriginals["K8"](*bkept["K8"][0][0])),
              ("K8 bench.py:511", WALK_K8_NAMES, lambda: cb.cuda_bsp_backward_packed(bench, blam, 1)),
              ("K8 Car (4, 2)", WALK_K8_NAMES, lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1))))):
        if lib not in C.libs:
            continue
        fn = getattr(C.libs[lib], entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * 20)()
        C.use(src, lib)
        fn(buf, 1)
        for label, names, call in calls:
            call()
            fn(buf, 1)
            res["stamps"][label] = walk_report(list(buf), names)
        C.use(src, src.split(".")[0] + " new")
    log(json.dumps(res["stamps"]))


def k5(opts, res):
    from step0 import k5_problems, k5_replan, solve_ms, stamp_buffer

    res["failures"] = []
    stamped = C.patched_copy(C.NEW, K5_CLUSTER_STAMPS, "ab_k5_stamped")
    C.build_variants({"k5 par": opts.parent / "pscan_backward.cu",
                      "k5 new": C.NEW / "pscan_backward.cu",
                      "k5 new stamped": stamped / "pscan_backward.cu"})
    res["ptxas"] = C.reports
    log(json.dumps(res["ptxas"]))
    kept, _ = k5_replan(C.k5_wrapper("k5 par"))
    problems = k5_problems(kept)
    same = res["bits_equal_parent"] = {}
    res["routes"] = {}
    for key, a in problems.items():
        T, dx = a[1].shape[0], a[1].shape[-1]
        route = cp.k5_route(T, dx, a[1].dtype)
        res["routes"][key] = route
        ref = C.digest(C.k5_call("k5 par", *a))
        got = [C.digest(C.k5_call("k5 new", *a, cluster=c)) for c in {route[1], 0}]
        equal(res, f"K5 {key} ({route[0]} route and global)", same, [g == ref for g in got])
    # the replan itself, through this tree's wrapper, against the parent's
    C.use("pscan_backward.cu", "k5 new")
    kept_new, _ = k5_replan(cp.cuda_pilqr_backward)
    equal(res, "K5 replan launches through this tree's wrapper", same,
          [C.digest(list(x)) == C.digest(list(y)) for x, y in zip(kept_new, kept)]
          + [len(kept_new) == len(kept) == 6])
    log(json.dumps(same))
    check(res, "chip_smoke check_k5 on this tree", lambda: chip_smoke.check_k5(dev))

    timed_keys = [k for k in problems if k.startswith("replan")] + ["SPD T=1000 4/2"]
    res["turns"] = {}
    for lab in ("par", "new", "new", "par"):
        d = {}
        for key in timed_keys:
            a = problems[key]
            runs = [(lab, None)] if lab == "par" else [
                ("new", cp.k5_route(a[1].shape[0], a[1].shape[-1], a[1].dtype)[1]),
                ("new global", 0)]
            for name, c in runs:
                d[f"{key} {name}"] = chip_smoke.device_ms_per_launch(
                    lambda: C.k5_call(f"k5 {lab}", *a, cluster=c), 50, "pscan_backward")[0]
        wrapper = C.k5_wrapper("k5 par") if lab == "par" else cp.cuda_pilqr_backward
        d["replan ms"] = k5_replan(wrapper)[1]
        res["turns"].setdefault(lab, []).append(d)
        log(lab, json.dumps(d))
    fn, buf = stamp_buffer("k5 new stamped", "k5_stamps")
    res["stamps"] = {}
    for key in ("replan launch 1", "SPD T=1000 4/2"):
        a = problems[key]
        C.k5_call("k5 new stamped", *a, cluster=cp.k5_route(a[1].shape[0], a[1].shape[-1],
                                                               a[1].dtype)[1])
        fn(buf, 1)
        res["stamps"][key] = k5_stamp_report(list(buf))
    log(json.dumps(res["stamps"]))


if __name__ == "__main__":
    C.run({"K2,K3,K11,K12,K14": sweeps, "K6,K7,K13,K14": gps_k13, "K1,K4,K5,K6,K7,K8": pivots,
           "K7,K8": kl_belief, "K5": k5})
