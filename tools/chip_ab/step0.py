"""Step 0 on the parent's kernels, before a redesign of the eLQR sweeps K11/K12
and a repair of K2/K3's quotient: K11/K12's device ms at the first-iteration
operands (N=1024, T=100, K = 0, goV = 0) and on each launch of one
``make_elqr_solver_batched(..., engine="cuda")`` solve; that solve's ms and
its device time under torch.profiler; clock64 stamps of the sweep steps at
the first and the last iteration; K2/K3 against their plain versions on the
card (normal range, residue) and, over one iLQR main-path solve (Cartpole,
N=2048, T=1000, 10 iterations), the count of K2/K3 divisions whose numerator
is nonzero and outside [2^-99, 2^99).  See common.py for how to run it."""
import ctypes
import json
import time

import numpy as np

import common as C
from common import log, torch
from patches import DIV_COUNT, sweep_stamps, stamp_report

import trajopt_torch
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_elqr as ce, cuda_rollout as cr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel.elqr import make_elqr_solver_batched
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched
from trajopt_torch.solvers.common import DEFAULT_ALPHAS

opts = C.args()
par = opts.parent
dev = torch.device("cuda")
f32 = dict(dtype=torch.float32, device=dev)
res = {"card": C.card()}
log(res["card"])
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
    "K12": [C.back_to_back(lambda: ce.cuda_elqr_backward(env, *k12_first), 20) for _ in range(3)]}
log(json.dumps(res["first_iteration_ms"]))

solve = make_elqr_solver_batched(env, T, IT, engine="cuda", **f32)
solve(x0s, kff_init=kff0)
names = ("cuda_elqr_forward", "cuda_elqr_backward", "cuda_elqr_rollout")
kept = C.capture([ce], names, lambda: solve(x0s, kff_init=kff0))
fns = {n: getattr(ce, n) for n in names}
res["main_path_ms_per_launch"] = {n: [C.back_to_back(lambda: fns[n](*a), 10) for a in kept[n]]
                                  for n in names}
log(json.dumps(res["main_path_ms_per_launch"]))
ms = []
for _ in range(3):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    solve(x0s, kff_init=kff0)
    e.record()
    torch.cuda.synchronize()
    ms.append(s.elapsed_time(e))
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

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

lib = C.libs["elqr_stamped"]
lib.elqr_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
buf = (ctypes.c_ulonglong * 20)()
C.use("elqr.cu", "elqr_stamped")
lib.elqr_stamps(buf, 1)
res["stamps"] = {}
for it in (0, IT - 1):
    for n in names[:2]:
        fns[n](*kept[n][it])
        lib.elqr_stamps(buf, 1)
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
        cr.cuda_rollout_returns(env, *streams, w, alphas), cr.rollout_returns_plain(env, *streams, w, alphas))],
        "K3 states, actions, terminal, returns": [int((a != b).sum()) for a, b in zip(
            cr.cuda_rollout_selected(env, *streams, w, al), cr.rollout_selected_plain(env, *streams, w, al))]}
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
msolve = make_ilqr_solver_batched(env, 1000, nb_iter=10, backward="cuda-fused", rollout="cuda",
                                  time_chunk=8, **f32)
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
res["card_end"] = C.card()
C.dump(opts.out, res)
log("done")
