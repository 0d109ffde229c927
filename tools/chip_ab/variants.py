"""Variants of a redesign timed against each other on one card.

``--kernels K2,K3,K11,K12``: K2/K3's range vote, form against form, and the
eLQR sweeps' block size.  Rollout builds (each a patch of this tree's
sources or of the parent's, see patches.py): the parent, the parent with a
bitwise sine flag, this tree (the integer least/largest numerator), this
tree with a short-circuit sine flag, the three per-division flag forms with
either sine flag, and design (b), ExactChainOps' division on the chain.
Each is held to the plain versions on chip_smoke.py's exact K2/K3 cases;
over one iLQR main-path solve (Cartpole, N=2048, T=1000, 10 iterations)
each must equal the parent's outputs bit for bit on every K2/K3 call, and
K2/K3's device ms on the first and last call and the main path's ms per
batch-iteration are read in turns (the builds in order, then in reverse).
eLQR: K11/K12 at the first-iteration operands (N=1024, T=100) with blocks
of 32, 64 and 128 threads, bit for bit.

``--kernels K6``: K6's block shape against the parent's K6: ring stages,
instances a block, producer warps, the shared-memory budget a block and the
largest chunk (``VARIANTS``), each build held to the parent bit for bit on
the GPS path's 64 launches and at the dual chain's shape, and timed there in
turns (the parent and the builds in order, then in reverse); clock64 stamps
of the kept shape.

See common.py for how to run it."""
import ctypes
import json
import time

import common as C
from common import log, torch
from patches import EXACT_ON_CHAIN, NEW_K6_STAMPS, WIDE_BIT_ON_PARENT, WIDE_OR_ON_KEPT, \
    k6_variant, new_k6_report, threads, vote

import chip_smoke
import trajopt_torch
import trajopt_torch.parallel.gps as gps_module
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_elqr as ce, cuda_gps as cg, cuda_rollout as cr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel.elqr import make_elqr_solver_batched
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched

chip_smoke.torch = torch
dev = torch.device("cuda")
f32 = dict(dtype=torch.float32, device=dev)

# K6's shapes: S stages, G instances a block, P producer warps (float), the
# shared memory budget a block, the largest chunk (16 unless said); the
# first is the kept one.
VARIANTS = {
    "S3 G32 P12 227KB": {},
    "S3 G32 P3 227KB": dict(producers=3), "S3 G32 P6 227KB": dict(producers=6),
    "S3 G32 P8 227KB": dict(producers=8), "S3 G32 P16 227KB": dict(producers=16),
    "S3 G32 P12 220KB": dict(budget_kb=220), "S3 G32 P12 227KB chunk<=8": dict(max_chunk=8),
    "S2 G32 P12 227KB": dict(stages=2), "S4 G32 P12 227KB": dict(stages=4),
    "S3 G16 P6 113KB": dict(group=16, producers=6, budget_kb=113),
    "S3 G16 P8 113KB": dict(group=16, producers=8, budget_kb=113),
    "S3 G16 P12 113KB": dict(group=16, producers=12, budget_kb=113),
    "S3 G8 P6 56KB": dict(group=8, producers=6, budget_kb=56)}
STAMPED = ("S3 G32 P12 227KB",)


def rollout_vote_and_blocks(opts, res):
    par = opts.parent
    dirs = {"parent": par,
            "parent, bitwise sine flag": C.patched_copy(par, WIDE_BIT_ON_PARENT, "v_pw"),
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
    msolve = make_ilqr_solver_batched(env, 1000, nb_iter=10, backward="cuda-fused",
                                      rollout="cuda", time_chunk=8, **f32)
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


def k6_shape(opts, res):
    specs = {"par": opts.parent / "gps.cu"}
    for i, (k, v) in enumerate(VARIANTS.items()):
        specs[k] = C.patched_copy(C.NEW, k6_variant(**v), f"v6_{i}") / "gps.cu"
    for i, k in enumerate(STAMPED):
        specs[k + " stamped"] = C.patched_copy(
            C.NEW, {"gps.cu": k6_variant(**VARIANTS[k])["gps.cu"] + NEW_K6_STAMPS["gps.cu"]},
            f"v6s_{i}") / "gps.cu"
    C.build_variants(specs)
    res["ptxas"] = {k: {n[:40]: x for n, x in r.items() if "backward" in n}
                    for k, r in C.reports.items()}
    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    C.use("gps.cu", "par")
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    kept, originals = chip_smoke.kept_launches({"K6": (gps_module, "cuda_gps_backward_packed")},
                                               lambda: solve.iteration(state0))
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(1000, 4, 2, 4096, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)

    def digests():
        return ([C.digest(originals["K6"](*a, **kw)) for a, kw in kept["K6"]]
                + [C.digest(cg.cuda_gps_backward_packed(dual, dual_alpha))])

    ref = digests()
    res["bits_equal_parent"] = {}
    res["failures"] = []
    for lab in VARIANTS:
        C.use("gps.cu", lab)
        res["bits_equal_parent"][lab] = digests() == ref
        if not res["bits_equal_parent"][lab]:
            res["failures"].append(f"{lab}: outputs differ from the parent's")
    log(json.dumps(res["bits_equal_parent"]))
    res["ms"] = {}
    for turn in range(2):
        for lab in ["par", *VARIANTS] if turn == 0 else [*reversed(VARIANTS), "par"]:
            C.use("gps.cu", lab)
            path = chip_smoke.replay_ms(kept, originals)["K6"]
            d = {"path": chip_smoke.spread(path),
                 "dual chain": C.back_to_back(lambda: cg.cuda_gps_backward_packed(dual, dual_alpha), 5)}
            res["ms"].setdefault(lab, []).append(d)
            log(lab, json.dumps(d))
    res["stamps"] = {}
    for k in STAMPED:
        lab = k + " stamped"
        fn = C.libs[lab].gps_stamps
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * 20)()
        C.use("gps.cu", lab)
        fn(buf, 1)
        for name, call in (("path launch 1", lambda: originals["K6"](*kept["K6"][0][0])),
                           ("dual chain", lambda: cg.cuda_gps_backward_packed(dual, dual_alpha))):
            call()
            fn(buf, 1)
            res["stamps"][f"{k}, {name}"] = new_k6_report(list(buf))
    log(json.dumps(res["stamps"]))


if __name__ == "__main__":
    C.run({"K2,K3,K11,K12": rollout_vote_and_blocks, "K6": k6_shape})
