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

``--kernels K7,K8``: the GPS walk's shape (producer warps, stages, largest
and first chunk; K6 and K7 share it), K7's producers factoring with
PivotOps, K7's three carry terms taken on the producers
(``KL_ON_PRODUCERS``), and K8's shape (instances a block, producer warps,
stages, first chunk; ``K8_VARIANTS``), each build held to the kept one bit
for bit (K6/K7 on every eighth GPS path launch and at the dual chain's
shape, K8 on every BSP path launch and at Car's (4, 2) for reg 1 and 2) and
timed there in turns (the builds in order, then in reverse); clock64 stamps
of the kept K8.

See common.py for how to run it."""
import ctypes
import json
import time

import common as C
from common import log, torch
from patches import BELIEF_WALK_STAMPS, EXACT_ON_CHAIN, K7_21_P12, K7_LIBRARY_FACTORS, \
    K8_LIBRARY_FACTOR, KL_ON_PRODUCERS, NEW_K6_STAMPS, \
    WALK_K8_NAMES, WIDE_BIT_ON_PARENT, WIDE_OR_ON_KEPT, k6_variant, k8_variant, merge, walk_first, \
    new_k6_report, threads, vote, walk_report

import chip_smoke
import trajopt_torch
import trajopt_torch.parallel.bsp as bsp_module
import trajopt_torch.parallel.gps as gps_module
import trajopt_torch.parallel.mpc as mpcmod
from trajopt_torch.core import cuda_belief as cb, cuda_elqr as ce, cuda_gps as cg, \
    cuda_rollout as cr
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
            C.NEW, merge(k6_variant(**VARIANTS[k]), NEW_K6_STAMPS), f"v6s_{i}") / "gps.cu"
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


# The GPS walk's (K6's and K7's) shapes and K7's alternatives, each a patch
# of this tree's gps.cu; the first is the kept one ("P8", "P16" set K6's
# and K7's float producer warps at every dims but K7's 2/1, which "K7 2/1
# P12" sets).
K7_VARIANTS = {
    "kept": {},
    "K7 2x1 P12": K7_21_P12, "K7 library factors": K7_LIBRARY_FACTORS,
    "K7 2x1 P12, library factors": merge(K7_21_P12, K7_LIBRARY_FACTORS),
    "P8": k6_variant(producers=8), "P16": k6_variant(producers=16),
    "S2": k6_variant(stages=2), "S4": k6_variant(stages=4),
    "chunk<=8": k6_variant(max_chunk=8),
    "first 4": walk_first(4), "first 2": walk_first(2),
    "K7 KL terms on the producers": KL_ON_PRODUCERS}
# K8's shapes (k8_variant: instances, producer warps and budget for b = 2
# float, b = 2 double, b = 4 float, b = 4 double; stages for b = 2, 4; the
# first chunk); the first is the kept one, "S3 P4, wide G32" the first build
# (with the library's factor, as "library factor"; the others take
# PivotOps').
_S3 = dict(group=(32, 32, 32, 16), stages=(3, 2), budget_kb=(227, 227, 227, 227))
K8_VARIANTS = {
    "kept": {}, "library factor": K8_LIBRARY_FACTOR,
    "S3 P4, wide G32": merge(k8_variant(producers=(4, 4, 4, 4), **_S3), K8_LIBRARY_FACTOR),
    "S3 P8, wide G32 P8": k8_variant(producers=(8, 6, 8, 4), **_S3),
    "S3 P12, wide G32 P8": k8_variant(producers=(12, 6, 8, 4), **_S3),
    "S3 P16, wide G32 P8": k8_variant(producers=(16, 6, 8, 4), **_S3),
    "S3 P4, wide G32 P2": k8_variant(producers=(4, 4, 2, 2), **_S3),
    "S3 P12 first 1": merge(k8_variant(producers=(12, 6, 8, 4), **_S3), walk_first(1)),
    "S3 P12 first 2": merge(k8_variant(producers=(12, 6, 8, 4), **_S3), walk_first(2)),
    "S2 P12": k8_variant(stages=(2, 2)),
    "G16 P6 113KB, wide G16 P4": k8_variant(group=(16, 16, 16, 8), producers=(6, 4, 4, 4),
                                             stages=(3, 2), budget_kb=(113, 113, 113, 113)),
    "S3 P4, wide G16 S3": k8_variant(group=(32, 32, 16, 8), stages=(3, 3),
                                     producers=(4, 4, 4, 4), budget_kb=(227, 227, 227, 227))}


def k7_k8_shapes(opts, res):
    specs = {}
    for i, (k, v) in enumerate(K7_VARIANTS.items()):
        specs[f"gps {k}"] = C.patched_copy(C.NEW, v, f"v7_{i}") / "gps.cu"
    for i, (k, v) in enumerate(K8_VARIANTS.items()):
        specs[f"belief {k}"] = C.patched_copy(C.NEW, v, f"v8_{i}") / "belief.cu"
    specs["belief kept stamped"] = C.patched_copy(C.NEW, BELIEF_WALK_STAMPS, "v8s") / "belief.cu"
    C.build_variants(specs)
    res["ptxas"] = {k: {n[4:40]: x for n, x in r.items() if "forward_kl" in n or "bsp" in n}
                    for k, r in C.reports.items()}
    res["failures"] = []

    solver, mu0s, sigma0s, kff0 = chip_smoke.gps_path(dev)
    solve = solver("cuda", 1)
    C.use("gps.cu", "gps kept")
    state0 = solve.init(mu0s, sigma0s, kff_init=kff0)
    kept, originals = chip_smoke.kept_launches(
        {"K6": (gps_module, "cuda_gps_backward_packed"),
         "K7": (gps_module, "cuda_gps_forward_kl_packed")}, lambda: solve.iteration(state0))
    cost, dyn, old, alpha, mu0, sig0 = chip_smoke.gps_dual_operands(1000, 4, 2, 4096, dev)
    dual, dual_alpha = cg.pack_gps(cost, dyn, old, mu0, sig0), cg.pack_gps_alpha(alpha)
    k6d = cg.cuda_gps_backward_packed(dual, dual_alpha)
    _, bsolver, bmu0s, bsigma0s = chip_smoke.bsp_path(dev)
    bsolve = bsolver("cuda")
    C.use("belief.cu", "belief kept")
    bkept, boriginals = chip_smoke.kept_launches({"K8": (bsp_module, "cuda_bsp_backward_packed")},
                                                 lambda: bsolve(bmu0s, bsigma0s))
    car = cb.pack_belief(*chip_smoke.belief_problem(4096, 25, 4, 2, 3, torch.float32, dev))
    lam_car = torch.full((4096,), 0.1, **f32)

    def gps_digests():
        return ([C.digest(originals[k](*a, **kw)) for k in ("K6", "K7") for a, kw in kept[k][::8]]
                + [C.digest(cg.cuda_gps_backward_packed(dual, dual_alpha)),
                   C.digest(cg.cuda_gps_forward_kl_packed(dual, *k6d[:3]))])

    def bsp_digests():
        return ([C.digest(boriginals["K8"](*a, **kw)) for a, kw in bkept["K8"]]
                + [C.digest(cb.cuda_bsp_backward_packed(car, lam_car, r)) for r in (1, 2)])

    res["bits_equal_kept"] = {}
    for src, variants, digests in (("gps", K7_VARIANTS, gps_digests), ("belief", K8_VARIANTS, bsp_digests)):
        ref = None
        for lab in variants:
            C.use(f"{src}.cu", f"{src} {lab}")
            d = digests()
            ref = ref or d
            res["bits_equal_kept"][f"{src} {lab}"] = d == ref
            if d != ref:
                res["failures"].append(f"{src} {lab}: outputs differ from the kept build's")
    log(json.dumps(res["bits_equal_kept"]))
    res["ms"] = {}
    for turn in range(2):
        for src, variants in (("gps", K7_VARIANTS), ("belief", K8_VARIANTS)):
            for lab in (list(variants) if turn == 0 else list(variants)[::-1]):
                C.use(f"{src}.cu", f"{src} {lab}")
                if src == "gps":
                    path = chip_smoke.replay_ms(kept, originals)
                    d = {"K7 path": chip_smoke.spread(path["K7"]), "K6 path": chip_smoke.spread(path["K6"]),
                         "K7 dual chain": C.back_to_back(
                             lambda: cg.cuda_gps_forward_kl_packed(dual, *k6d[:3]), 5),
                         "K6 dual chain": C.back_to_back(
                             lambda: cg.cuda_gps_backward_packed(dual, dual_alpha), 5)}
                else:
                    d = {"K8 path": chip_smoke.spread(chip_smoke.replay_ms(bkept, boriginals)["K8"]),
                         "K8 Car (4, 2)": C.back_to_back(
                             lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1), 20)}
                res["ms"].setdefault(f"{src} {lab}", []).append(d)
                log(src, lab, json.dumps(d))
    fn = C.libs["belief kept stamped"].belief_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 20)()
    C.use("belief.cu", "belief kept stamped")
    fn(buf, 1)
    res["stamps"] = {}
    for name, call in (("kept, path launch 1", lambda: boriginals["K8"](*bkept["K8"][0][0])),
                       ("kept, Car (4, 2)", lambda: cb.cuda_bsp_backward_packed(car, lam_car, 1))):
        call()
        fn(buf, 1)
        res["stamps"][name] = walk_report(list(buf), WALK_K8_NAMES)
    log(json.dumps(res["stamps"]))


if __name__ == "__main__":
    C.run({"K2,K3,K11,K12": rollout_vote_and_blocks, "K6": k6_shape, "K7,K8": k7_k8_shapes})
