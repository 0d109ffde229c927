"""K2/K3's range vote, form against form, and the eLQR sweeps' block size.

Rollout builds (each a patch of this tree's sources or of the parent's, see
patches.py): the parent, the parent with a bitwise sine flag, this tree
(the integer least/largest numerator), this tree with a short-circuit sine
flag, the three per-division flag forms with either sine flag, and design
(b), ExactChainOps' division on the chain.  Each is held to the plain
versions on chip_smoke.py's exact K2/K3 cases; over one iLQR main-path solve
(Cartpole, N=2048, T=1000, 10 iterations) each must equal the parent's
outputs bit for bit on every K2/K3 call, and K2/K3's device ms on the first
and last call and the main path's ms per batch-iteration are read in turns
(the builds in order, then in reverse).  eLQR: K11/K12 at the
first-iteration operands (N=1024, T=100) with blocks of 32, 64 and 128
threads, bit for bit.  See common.py for how to run it."""
import json
import time

import common as C
from common import log, torch
from patches import EXACT_ON_CHAIN, WIDE_BIT_ON_PARENT, WIDE_OR_ON_KEPT, threads, vote

import chip_smoke
import trajopt_torch
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_elqr as ce, cuda_rollout as cr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel.elqr import make_elqr_solver_batched
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched

chip_smoke.torch = torch
opts = C.args()
par = opts.parent
dev = torch.device("cuda")
f32 = dict(dtype=torch.float32, device=dev)
res = {"card": C.card()}
log(res["card"])
dirs = {"parent": par, "parent, bitwise sine flag": C.patched_copy(par, WIDE_BIT_ON_PARENT, "v_pw"),
        "kept": C.NEW, "kept, short-circuit sine flag": C.patched_copy(C.NEW, WIDE_OR_ON_KEPT, "v_kw"),
        "design (b)": C.patched_copy(C.NEW, EXACT_ON_CHAIN, "v_b")}
for form in ("or", "bitwise", "int"):
    for wide_or in (True, False):
        label = f"flag '{form}', {'short-circuit' if wide_or else 'bitwise'} sine flag"
        dirs[label] = C.patched_copy(C.NEW, vote(form, wide_or), f"v_{form}_{int(wide_or)}")
labels = list(dirs)
C._build.build(("fused_backward.cu",))
C.build_variants({**{f"roll {i}": d / "rollout.cu" for i, d in enumerate(dirs.values())},
                  "elqr 32": C.NEW / "elqr.cu",
                  "elqr 64": C.patched_copy(C.NEW, threads(64), "v_t64") / "elqr.cu",
                  "elqr 128": C.patched_copy(C.NEW, threads(128), "v_t128") / "elqr.cu"})
env = trajopt_torch.make("Cartpole-TO-v0")


def use_roll(label):
    C.use("rollout.cu", f"roll {labels.index(label)}")


res["exact_cases"] = {}
for label in labels:
    use_roll(label)
    try:
        chip_smoke.check_rollout_exact(env, dev)
        res["exact_cases"][label] = "equal"
    except SystemExit as e:
        res["exact_cases"][label] = str(e)
log(json.dumps(res["exact_cases"]))

xm = torch.zeros(2048, 4, **f32)
xm[:, 0] = 0.01 * torch.arange(2048, **f32)
msolve = make_ilqr_solver_batched(env, 1000, nb_iter=10, backward="cuda-fused", rollout="cuda",
                                  time_chunk=8, **f32)
use_roll("parent")
names = ("cuda_rollout_returns", "cuda_rollout_selected")
kept = C.capture([cr, mpcmod], names, lambda: msolve(xm))
fns = {n: getattr(cr, n) for n in names}
same = {}
for n in names:
    for i, a in enumerate(kept[n]):
        hashes = {}
        for label in labels:
            use_roll(label)
            hashes[label] = C.digest(fns[n](*a))
        same[f"{n} call {i}"] = all(h == hashes["parent"] for h in hashes.values())
res["bits_equal_parent"] = same
log(json.dumps(same))
times, main = {}, {}
for label in labels + labels[::-1]:
    use_roll(label)
    times.setdefault(label, []).append(
        {n: [C.back_to_back(lambda: fns[n](*kept[n][i]), 10) for i in (0, len(kept[n]) - 1)]
         for n in names})
    msolve(xm)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        msolve(xm)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0) / 10)
    main.setdefault(label, []).append(runs)
res["rollout_ms [first call, last call]"] = times
res["main_path_ms_per_batch_iter"] = main
log(json.dumps(times))
log(json.dumps(main))

T, N = 100, 1024
x0s, kff0 = chip_smoke.elqr_inputs(N, T, 11, torch.float32, dev)
first = (torch.zeros(T, 4, N, **f32), to_soa(kff0, N), torch.zeros(T + 1, 16, N, **f32),
         torch.zeros(T + 1, 4, N, **f32), x0s.T.contiguous())
C.use("elqr.cu", "elqr 32")
fo = ce.cuda_elqr_forward(env, *first)
k12_first = (fo[0], fo[1], fo[2], fo[3], fo[5])
solve = make_elqr_solver_batched(env, T, 10, engine="cuda", **f32)
blocks, ref = {}, None
for lab in ("elqr 32", "elqr 64", "elqr 128", "elqr 128", "elqr 64", "elqr 32"):
    C.use("elqr.cu", lab)
    out = solve(x0s, kff_init=kff0)
    h = C.digest([out[0].K, out[0].kff, *out[1:]])
    ref = ref or h
    blocks.setdefault(lab, []).append({
        "K11": C.back_to_back(lambda: ce.cuda_elqr_forward(env, *first), 20),
        "K12": C.back_to_back(lambda: ce.cuda_elqr_backward(env, *k12_first), 20),
        "bits_equal_32": h == ref})
res["elqr_block_sizes"] = blocks
log(json.dumps(blocks))
res["card_end"] = C.card()
C.dump(opts.out, res)
log("done")
