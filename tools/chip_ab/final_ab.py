"""The parent's eLQR and rollout kernels against this tree's, in one process
on one card: the outputs bit for bit (eLQR solves through the streamed and
the fused engine at N = 1024, 64, 3, 129 in float32 and N=50 in float64, the
streamed engine against the fused one at N=64, ELQR_EXACT_CASES through both
engines; K2/K3 on every call of one iLQR main-path solve), chip_smoke.py's
exact K2/K3 cases and float64 eLQR checks; in turns (parent, tree, tree,
parent) K11/K12's device ms at the first-iteration operands and on each
launch of the N=1024 solve, K14's at N=64 and N=1, the N=1024 solve's ms,
K2/K3's on the main path's first and last call and the main path's ms per
batch-iteration; the N=1024 solve under torch.profiler; the share of K2/K3
chunks retaken; clock64 stamps of this tree's sweep steps.  See common.py
for how to run it."""
import ctypes
import json
import time

import numpy as np

import common as C
from common import log, torch
from patches import CHUNK_COUNT, DIV_COUNT, stamp_report, sweep_stamps

import chip_smoke
import trajopt_torch
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_elqr as ce, cuda_rollout as cr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel.elqr import make_elqr_solver_batched
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched
from trajopt_torch.solvers.common import DEFAULT_ALPHAS

chip_smoke.torch = torch
opts = C.args()
par = opts.parent
dev = torch.device("cuda")
f32 = dict(dtype=torch.float32, device=dev)
res = {"card": C.card()}
log(res["card"])
C._build.build(("fused_backward.cu",))
C.build_variants({
    "elqr par": par / "elqr.cu", "elqr new": C.NEW / "elqr.cu",
    "elqr stamped": C.patched_copy(C.NEW, sweep_stamps((C.NEW / "elqr.cu").read_text()),
                                   "f_stamped") / "elqr.cu",
    "roll par": par / "rollout.cu", "roll new": C.NEW / "rollout.cu",
    "roll chunks": C.patched_copy(C.NEW, CHUNK_COUNT, "f_chunks") / "rollout.cu",
    "roll divs": C.patched_copy(par, DIV_COUNT, "f_divs") / "rollout.cu"})
env = trajopt_torch.make("Cartpole-TO-v0")
failures = []


def check(label, fn):
    try:
        fn()
        log(f"PASS {label}")
    except SystemExit as e:
        log(f"FAIL {label}: {e}")
        failures.append(f"{label}: {e}")


# K2/K3's exact cases on both builds; the residue case's shares
for lab in ("par", "new"):
    C.use("rollout.cu", f"roll {lab}")
    check(f"K2/K3 exact cases, {lab}", lambda: chip_smoke.check_rollout_exact(env, dev))
N, T = chip_smoke.N_ROLLOUT_EXACT, chip_smoke.T_ROLLOUT_EXACT
alphas = torch.tensor(DEFAULT_ALPHAS, **f32)
dl, cl = C.libs["roll divs"], C.libs["roll chunks"]
dl.rollout_divs.argtypes = cl.rollout_chunks.argtypes = [ctypes.c_void_p, ctypes.c_int]
b2, b3 = (ctypes.c_ulonglong * 2)(), (ctypes.c_ulonglong * 3)()
res["exact_case_shares"] = {}
for label, scale in chip_smoke.ROLLOUT_EXACT_CASES:
    rng = np.random.default_rng(21)
    K = 10.0 * rng.standard_normal((T, 4, N))
    kff, xref, uref = (scale * rng.standard_normal(s) for s in ((T, 1, N), (T, 4, N), (T, 1, N)))
    streams = [torch.as_tensor(a, **f32) for a in (K, kff, xref, uref)]
    w = torch.ones(T + 1, **f32)
    for lib, fn, buf in (("roll divs", dl.rollout_divs, b2), ("roll chunks", cl.rollout_chunks, b3)):
        C.use("rollout.cu", lib)
        fn(buf, 1)
        cr.cuda_rollout_returns(env, *streams, w, alphas)
        fn(buf, 1)
    res["exact_case_shares"][label] = {"K2 divisions [all, out of range] (parent)": list(b2),
                                       "K2 warp-chunks [all, exact retakes, library retakes]": list(b3)}
log(json.dumps(res["exact_case_shares"]))


def run_solve(lab, n, seed=11, it=10, engine="cuda", dtype=torch.float32):
    C.use("elqr.cu", f"elqr {lab}")
    x0s, kff0 = chip_smoke.elqr_inputs(n, 100, seed, dtype, dev)
    out = make_elqr_solver_batched(env, 100, it, engine=engine, dtype=dtype, device=dev)(x0s, kff_init=kff0)
    return C.digest([out[0].K, out[0].kff, *out[1:]])


bits = {f"cuda N={n} f32": run_solve("par", n) == run_solve("new", n) for n in (1024, 64, 3, 129)}
bits["cuda N=50 f64"] = (run_solve("par", 50, it=3, dtype=torch.float64)
                         == run_solve("new", 50, it=3, dtype=torch.float64))
bits.update({f"cuda-fused N={n} f32": run_solve("par", n, engine="cuda-fused")
             == run_solve("new", n, engine="cuda-fused") for n in (64, 1)})
bits.update({f"{lab}: cuda == cuda-fused, N=64": run_solve(lab, 64, 12)
             == run_solve(lab, 64, 12, engine="cuda-fused") for lab in ("par", "new")})
res["elqr_bits_equal_parent"] = bits
log(json.dumps(bits))
C.use("elqr.cu", "elqr new")
check("float64 eLQR checks", lambda: chip_smoke.check_elqr_f64(dev))


def exact_engines():
    for label, theta0, step, scale, nb_iter in chip_smoke.ELQR_EXACT_CASES:
        x0s, kff0 = chip_smoke.elqr_inputs(4, 10, 15, torch.float32, dev, theta0, step)
        got, ref = (make_elqr_solver_batched(env, 10, nb_iter, engine=e, **f32)(x0s, kff_init=scale * kff0)
                    for e in ("cuda", "cuda-fused"))
        chip_smoke.same_solves(label, got, ref)


for lab in ("par", "new"):
    C.use("elqr.cu", f"elqr {lab}")
    check(f"ELQR_EXACT_CASES through both engines, {lab}", exact_engines)

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
         "K14 N=1": C.back_to_back(lambda: ce.cuda_elqr_solve(env, *k14[1], 10), 5)}
    solve(x0s, kff_init=kff0)
    d["solve N=1024"] = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        solve(x0s, kff_init=kff0)
        e.record()
        torch.cuda.synchronize()
        d["solve N=1024"].append(s.elapsed_time(e))
    res["elqr_ms"].setdefault(lab, []).append(d)
    log(lab, json.dumps(d))
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

for lab in ("par", "new"):
    C.use("elqr.cu", f"elqr {lab}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(x0s, kff_init=kff0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    res[f"solve N=1024 profile, {lab}"] = {
        "wall_ms": wall, "device_busy_ms": sum(e.self_device_time_total for e in ev) / 1e3,
        "by_kernel": [[e.key[:40], e.count, e.self_device_time_total / 1e3] for e in ev]}
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
xm = torch.zeros(2048, 4, **f32)
xm[:, 0] = 0.01 * torch.arange(2048, **f32)
msolve = make_ilqr_solver_batched(env, 1000, nb_iter=10, backward="cuda-fused", rollout="cuda",
                                  time_chunk=8, **f32)
C.use("rollout.cu", "roll new")
rnames = ("cuda_rollout_returns", "cuda_rollout_selected")
rk = C.capture([cr, mpcmod], rnames, lambda: msolve(xm))
rfns = {n: getattr(cr, n) for n in rnames}
same, chunks = {}, {}
for n in rnames:
    for i, a in enumerate(rk[n]):
        h = []
        for lab in ("par", "new"):
            C.use("rollout.cu", f"roll {lab}")
            h.append(C.digest(rfns[n](*a)))
        same[f"{n} call {i}"] = h[0] == h[1]
    C.use("rollout.cu", "roll chunks")
    cl.rollout_chunks(b3, 1)
    tot = [0, 0, 0]
    for a in rk[n]:
        rfns[n](*a)
        cl.rollout_chunks(b3, 1)
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
    msolve(xm)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        msolve(xm)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / 10)
    res["main_path_ms_per_batch_iter"].setdefault(lab, []).append(runs)
log(json.dumps(res["rollout_ms [first call, last call]"]))
log(json.dumps(res["main_path_ms_per_batch_iter"]))
res["failures"] = failures
res["card_end"] = C.card()
C.dump(opts.out, res)
log("done; failed:", failures)
