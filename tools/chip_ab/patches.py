"""Source patches for the A/B scripts: clock64 stamps in the eLQR sweep
steps, counters of K2/K3's out-of-range numerators and retaken chunks, and
the variants of K2/K3's range vote and of the eLQR sweeps' block size that
were timed against each other (PERF.md).  Each is ``{file name: [(old, new,
count)]}`` for ``common.patched_copy``."""

def stamp_header(entry):
    """clock64 stamps of thread 0 of block 0 into 20 device counters, read
    (and reset) through the added C entry point ``entry``; TOUCH(values...)
    makes the next stamp wait until the values are in (a compare of their
    bits ORed together and a volatile store that never happens)."""
    return r'''
__device__ unsigned long long g_stamp[20];
__device__ volatile unsigned g_touch;
#define STAMP_BEGIN long long _st = clock64();
#define STAMP_RESET _st = clock64();
#define STAMP(i) { long long _s1 = clock64(); if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[i] += _s1 - _st; _st = _s1; }
#define STAMP_COUNT(i) { if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[i] += 1; }
__device__ __forceinline__ unsigned touch_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned touch_bits(double x) { return (unsigned)__double_as_longlong(x); }
template <typename S> __device__ __forceinline__ void touch_acc(unsigned& a, const S& x) { a |= touch_bits(x); }
template <typename S, int N> __device__ __forceinline__ void touch_acc(unsigned& a, const S (&x)[N]) {
  for (int i = 0; i < N; ++i) touch_acc(a, x[i]);
}
template <typename... X> __device__ __forceinline__ void touch_all(unsigned& a, const X&... x) { (touch_acc(a, x), ...); }
#define TOUCH(...) { unsigned _ta = 0u; touch_all(_ta, __VA_ARGS__); if (_ta == 0x7fbadbadu) g_touch = 1u; }
extern "C" int ENTRY(unsigned long long* out, int reset) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (reset) { unsigned long long z[20] = {}; cudaMemcpyToSymbol(g_stamp, z, sizeof(z)); }
  return (int)cudaGetLastError();
}
'''.replace("ENTRY", entry)


STAMP_HEADER = stamp_header("elqr_stamps")

# Stamp slots, thread 0 of block 0: fwd 0 value rk4, 1 dual rk4 (lin), 2 quad, 3 Q algebra, 4 gains, 5 rechoose,
# 6 loads, 7 stores, 14 steps; bwd 8..13 same order, 16 loads, 17 stores, 15 steps
ELQR_STAMPS = {"elqr.cu": [
    ('#include "gj_inv.cuh"\n', '#include "gj_inv.cuh"\n' + STAMP_HEADER, 1),
    ("  S u[DU], xn[DX];\n", "  S u[DU], xn[DX];\n  STAMP_BEGIN\n", 1),
    ("  rk4<Env, false, Fast>(p, x, u, xn);\n  S A[DX]",
     "  rk4<Env, false, Fast>(p, x, u, xn);\n  STAMP(0)\n  S A[DX]", 1),
    ("  lin_about<Env, true, Fast>(p, xn, u, A, B, c);\n",
     "  lin_about<Env, true, Fast>(p, xn, u, A, B, c);\n  STAMP(1)\n", 1),
    ("  quad_cost<Env>(p, x, u, Cxx, cx, c0);\n", "  quad_cost<Env>(p, x, u, Cxx, cx, c0);\n  STAMP(2)\n", 1),
    ("  gains_and_value(Qxx, Quu, Qux, qx, qu, q0, iK, ikff, V, v, v0);\n  rechoose(goVn, V, govn, v, x);\n",
     "  STAMP(3)\n  gains_and_value(Qxx, Quu, Qux, qx, qu, q0, iK, ikff, V, v, v0);\n  STAMP(4)\n"
     "  rechoose(goVn, V, govn, v, x);\n  STAMP(5)\n", 1),
    ("  S u[DU], xp[DX];\n", "  S u[DU], xp[DX];\n  STAMP_BEGIN\n", 1),
    ("  rk4<Env, true, Fast>(p, x, u, xp);\n", "  rk4<Env, true, Fast>(p, x, u, xp);\n  STAMP(8)\n", 1),
    ("  lin_about<Env, false, Fast>(p, xp, u, A, B, c);\n",
     "  lin_about<Env, false, Fast>(p, xp, u, A, B, c);\n  STAMP(9)\n", 1),
    ("  quad_cost<Env>(p, xp, u, Cxx, cx, c0);\n", "  quad_cost<Env>(p, xp, u, Cxx, cx, c0);\n  STAMP(10)\n", 1),
    ("  gains_and_value(Qxx, Quu, Qux, qx, qu, q0, K, kff, V, v, v0);\n  rechoose(V, comeV, v, comev, x);\n",
     "  STAMP(11)\n  gains_and_value(Qxx, Quu, Qux, qx, qu, q0, K, kff, V, v, v0);\n  STAMP(12)\n"
     "  rechoose(V, comeV, v, comev, x);\n  STAMP(13)\n", 1),
    ("    load_mat(K, t, np, n, Kt);\n    load_vec(kff, t, np, n, kt);\n    load_mat(goV",
     "    STAMP_BEGIN\n    load_mat(K, t, np, n, Kt);\n    load_vec(kff, t, np, n, kt);\n    load_mat(goV", 1),
    ("    load_vec(gov, t + 1, np, n, govn);\n", "    load_vec(gov, t + 1, np, n, govn);\n    STAMP(6)\n", 1),
    ("    store_mat(iK, t, np, n, iKt);\n", "    STAMP_RESET\n    store_mat(iK, t, np, n, iKt);\n", 1),
    ("    if (comev0) AT(comev0, t + 1, 1, 0) = v0;\n",
     "    if (comev0) AT(comev0, t + 1, 1, 0) = v0;\n    STAMP(7)\n    STAMP_COUNT(14)\n", 1),
    ("    load_mat(iK, t, np, n, iKt);\n", "    STAMP_BEGIN\n    load_mat(iK, t, np, n, iKt);\n", 1),
    ("    load_vec(comev, t, np, n, cv);\n    backward_step",
     "    load_vec(comev, t, np, n, cv);\n    STAMP(16)\n    backward_step", 1),
    ("    store_mat(K, t, np, n, Kt);\n", "    STAMP_RESET\n    store_mat(K, t, np, n, Kt);\n", 1),
    ("    if (gov0) AT(gov0, t, 1, 0) = v0;\n",
     "    if (gov0) AT(gov0, t, 1, 0) = v0;\n    STAMP(17)\n    STAMP_COUNT(15)\n", 1),
]}

STAMP_NAMES = {0: "value_rk4", 1: "dual_rk4", 2: "quad", 3: "Q_algebra", 4: "gains", 5: "rechoose",
               6: "loads", 7: "stores"}


def stamp_report(raw):
    out = {}
    for side, base, loads, stores, count in (("forward", 0, 6, 7, 14), ("backward", 8, 16, 17, 15)):
        n = max(raw[count], 1)
        d = {"steps": raw[count]}
        for k, name in STAMP_NAMES.items():
            idx = base + k if k < 6 else (loads if k == 6 else stores)
            d[name] = raw[idx] / n
        d["total"] = sum(v for k, v in d.items() if k != "steps")
        out[side] = d
    return out




def sweep_stamps(text):
    """ELQR_STAMPS for an elqr.cu whose sweep steps take no Fast flag (the
    steps of K11, K12 and K14 are one code)."""
    if "forward_step<Env, Fast>" in text:
        return ELQR_STAMPS
    out = []
    for old, new, c in ELQR_STAMPS["elqr.cu"]:
        if old.startswith("  rk4<Env, false, Fast>"):
            old, new = old.replace("Fast", "true"), new.replace("Fast", "true")
        for a, b in (("lin_about<Env, true, Fast>", "lin_about<Env, true>"),
                     ("rk4<Env, true, Fast>", "rk4<Env, true, true>"),
                     ("lin_about<Env, false, Fast>", "lin_about<Env, false>")):
            old, new = old.replace(a, b), new.replace(a, b)
        out.append((old, new, c))
    return {"elqr.cu": out}


# Count, in the parent's static ChainOps::div (K2/K3), the float divisions whose numerator is
# nonzero and outside [2^-99, 2^99), and all float divisions.
DIV_COUNT = {
    "envs.cuh": [
        ("struct ChainOps : LibOps {",
         "__device__ unsigned long long g_divs[2];\nstruct ChainOps : LibOps {", 1),
        ("  __device__ static __forceinline__ float div(float a, float b) {\n    const float y = __frcp_rn(b);",
         "  __device__ static __forceinline__ float div(float a, float b) {\n"
         "    atomicAdd(&g_divs[0], 1ull);\n"
         "    if (a != 0.0f && !(fabsf(a) >= 0x1p-99f && fabsf(a) < 0x1p99f)) atomicAdd(&g_divs[1], 1ull);\n"
         "    const float y = __frcp_rn(b);", 1),
    ],
    "rollout.cu": [
        ('#include "ring.cuh"\n', '#include "ring.cuh"\n'
         'extern "C" int rollout_divs(unsigned long long* out, int reset) {\n'
         '  cudaDeviceSynchronize();\n  cudaMemcpyFromSymbol(out, g_divs, sizeof(g_divs));\n'
         '  if (reset) { unsigned long long z[2] = {}; cudaMemcpyToSymbol(g_divs, z, sizeof(z)); }\n'
         '  return (int)cudaGetLastError();\n}\n', 1),
    ],
}


# Count a K2/K3 warp's chunks, those retaken with ExactChainOps and those
# retaken with LibOps.
CHUNK_COUNT = {"rollout.cu": [
    ('#include "ring.cuh"\n', '#include "ring.cuh"\n'
     '__device__ unsigned long long g_chunks[3];\n'
     'extern "C" int rollout_chunks(unsigned long long* out, int reset) {\n'
     '  cudaDeviceSynchronize();\n  cudaMemcpyFromSymbol(out, g_chunks, sizeof(g_chunks));\n'
     '  if (reset) { unsigned long long z[3] = {}; cudaMemcpyToSymbol(g_chunks, z, sizeof(z)); }\n'
     '  return (int)cudaGetLastError();\n}\n', 1),
    ("      bool wide = __any_sync(lanes, fast.wide);\n",
     "      bool wide = __any_sync(lanes, fast.wide);\n      bool retook = false;\n", 1),
    ("          ExactChainOps exact;\n", "          retook = true;\n          ExactChainOps exact;\n", 1),
    ("      if (wide) {\n        roll = start;\n        LibOps lib;",
     "      if ((threadIdx.x & 31) == __ffs(lanes) - 1) { atomicAdd(&g_chunks[0], 1ull);"
     " if (retook) atomicAdd(&g_chunks[1], 1ull); if (wide) atomicAdd(&g_chunks[2], 1ull); }\n"
     "      if (wide) {\n        roll = start;\n        LibOps lib;", 1),
]}

# Design (b): ExactChainOps' division on the chain, no vote.
EXACT_ON_CHAIN = {"rollout.cu": [
    ("      ChainOps fast;\n      chunk(fast);", "      ExactChainOps fast;\n      chunk(fast);", 1),
]}



# The vote as this tree keeps it (integer least/largest numerator) and three
# other forms of it, each setting a flag per division.
VOTE_KEPT = [("  unsigned low = ~0u, high = 0u;\n", "  bool far_ = false;\n", 1),
             ("    return low < (28u << 24) - 1u || high >= (226u << 24);\n", "    return far_;\n", 1)]
VOTE_DIV = ("    const unsigned m = __float_as_uint(a) << 1;\n    low = min(low, m - 1u);\n"
            "    high = max(high, m);\n")
VOTES = {
    "or": "    const float fa = fabsf(a);\n"
          "    far_ = far_ || (a != 0.0f && (fa < 0x1p-99f || fa >= 0x1p99f));\n",
    "bitwise": "    const float fa = fabsf(a);\n"
               "    far_ |= (a != 0.0f) & ((fa < 0x1p-99f) | (fa >= 0x1p99f));\n",
    "int": "    const unsigned m = __float_as_uint(a) << 1;\n"
           "    far_ |= (m != 0u) & ((m - (28u << 24)) >= (198u << 24));\n",
}
# The sine's range flag with a short-circuit OR (the parent's form) or a
# bitwise one (this tree's).
WIDE_OR = ("    wide = wide || fabsf(a) >= 105615.0f;\n", 1)
WIDE_BIT = ("    wide |= fabsf(a) >= 105615.0f;\n", 1)


def vote(form, wide_or):
    """This tree's envs.cuh with the vote ``form`` and the sine flag's OR."""
    subs = list(VOTE_KEPT) + [(VOTE_DIV, VOTES[form], 1)]
    if wide_or:
        subs.append((WIDE_BIT[0], WIDE_OR[0], 1))
    return {"envs.cuh": subs}


WIDE_OR_ON_KEPT = {"envs.cuh": [(WIDE_BIT[0], WIDE_OR[0], 1)]}
WIDE_BIT_ON_PARENT = {"envs.cuh": [(WIDE_OR[0], WIDE_BIT[0], 1)]}


def threads(n):
    """The eLQR kernels with blocks of ``n`` threads."""
    return {"elqr.cu": [("constexpr int ELQR_THREADS = 32;", f"constexpr int ELQR_THREADS = {n};", 1)]}


# Stamps of K6's step (slots 0 loads, 1 KL augmentation, 2 −1/α, 3 Q blocks,
# 4 factor of −Quu and its solves, 5 value update, 6 stores; 7 steps) in a
# gps.cu of one thread an instance (the parent's).
K6_STAMPS = {"gps.cu": [
    ('#include "bwd_step.cuh"\n', '#include "bwd_step.cuh"\n' + stamp_header("gps_stamps"), 1),
    ("  for (int t = T - 1; t >= 0; --t) {\n    S Cxx[DX][DX]",
     "  for (int t = T - 1; t >= 0; --t) {\n    STAMP_BEGIN\n    S Cxx[DX][DX]", 1),
    ("    const S a = alpha_s[(size_t)t * np + n];\n",
     "    const S a = alpha_s[(size_t)t * np + n];\n"
     "    TOUCH(Cxx, cx_t, Cuu, cu_t, Cxu, c0, A, B, c, sigd, Ko, ko, sigo, a)\n    STAMP(0)\n", 1),
    ("    const S agc0 = c0 + ha * (S(DU * LOG_2PI) + logdet_sigo) + ha * dot(ko, lamko);\n",
     "    const S agc0 = c0 + ha * (S(DU * LOG_2PI) + logdet_sigo) + ha * dot(ko, lamko);\n"
     "    TOUCH(agc0, agCxx, agCxu, agcx, agCuu, agcu)\n    STAMP(1)\n", 1),
    ("    const S nia = S(-1) / a;\n", "    const S nia = S(-1) / a;\n    TOUCH(nia)\n    STAMP(2)\n", 1),
    ("    const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));\n",
     "    const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));\n"
     "    TOUCH(q0, Qxx, QuxT, Quu, qu, qx)\n    STAMP(3)\n", 1),
    ("    const S na = -a;\n", "    TOUCH(K, kff, sigc)\n    STAMP(4)\n    const S na = -a;\n", 1),
    ("    v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));\n",
     "    v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));\n"
     "    TOUCH(V, v, v0)\n    STAMP(5)\n", 1),
    ("    store(sigc_out, t, n, np, sigc);\n  }\n",
     "    store(sigc_out, t, n, np, sigc);\n    STAMP(6)\n    STAMP_COUNT(7)\n  }\n", 1),
]}
K6_STAMP_NAMES = ("loads", "augmentation", "neg_inv_alpha", "Q_blocks", "factor_and_solves",
                  "value_update", "stores")

# Stamps of K13's step (slots 0 loads of K and kff, 1 u = kff + Kx, 2 stage
# cost, 3 RK4 (and the stores of a storing rollout); 4 steps) in the
# evaluation rollout of elqr.cu.
K13_STAMPS = {"elqr.cu": [
    ('#include "gj_inv.cuh"\n', '#include "gj_inv.cuh"\n' + stamp_header("elqr_stamps"), 1),
    ("    S Kt[DU][DX], kt[DU], Kx[DU], u[DU], xn[DX];\n",
     "    S Kt[DU][DX], kt[DU], Kx[DU], u[DU], xn[DX];\n    STAMP_BEGIN\n", 1),
    ("    load_vec(kff, t, np, n, kt);\n    mv(Kt, x, Kx);\n",
     "    load_vec(kff, t, np, n, kt);\n    TOUCH(Kt, kt)\n    STAMP(0)\n    mv(Kt, x, Kx);\n", 1),
    ("    ret = ret + stage_cost<Env>(p, x, u, zero, S(1));\n",
     "    TOUCH(u)\n    STAMP(1)\n    ret = ret + stage_cost<Env>(p, x, u, zero, S(1));\n"
     "    TOUCH(ret)\n    STAMP(2)\n", 1),
    ("    rk4<Env, false, Fast>(p, x, u, xn);\n#pragma unroll\n    for (int i = 0; i < DX; ++i) x[i] = xn[i];\n",
     "    rk4<Env, false, Fast>(p, x, u, xn);\n    TOUCH(xn)\n    STAMP(3)\n    STAMP_COUNT(4)\n"
     "#pragma unroll\n    for (int i = 0; i < DX; ++i) x[i] = xn[i];\n", 1),
]}
K13_STAMP_NAMES = ("loads", "action", "stage_cost", "rk4")


def stamps_per_step(raw, names, count_slot):
    """Cycles a step by phase from the raw counters, and their total."""
    n = max(raw[count_slot], 1)
    d = {"steps": raw[count_slot], **{name: raw[i] / n for i, name in enumerate(names)}}
    d["total"] = sum(raw[i] for i in range(len(names))) / n
    return d


def k13_stamps(text):
    """K13_STAMPS for an elqr.cu whose rollout loads each step's gains a step
    ahead (this tree's) or in the step (the parent's)."""
    if "load_vec(kff, tn, np, n, kn);" not in text:
        return K13_STAMPS
    out = []
    for old, new, c in K13_STAMPS["elqr.cu"]:
        old, new = (x.replace("load_vec(kff, t, np, n, kt);", "load_vec(kff, tn, np, n, kn);")
                    .replace("rk4<Env, false, Fast>", "rk4<Env, false, true>") for x in (old, new))
        out.append((old, new, c))
    return {"elqr.cu": out}


# K13 with the gains loaded in the step they are used (this tree's ExactChainOps
# rollout without the prefetch).
K13_NO_PREFETCH = {"elqr.cu": [(
    "#pragma unroll\n    for (int j = 0; j < DU; ++j) {\n#pragma unroll\n"
    "      for (int i = 0; i < DX; ++i) Kt[j][i] = Kn[j][i];\n      kt[j] = kn[j];\n    }\n"
    "    const int tn = t + 1 < T ? t + 1 : t;   // the last step loads its own row again\n"
    "    load_mat(K, tn, np, n, Kn);\n    load_vec(kff, tn, np, n, kn);\n",
    "    load_mat(K, t, np, n, Kt);\n    load_vec(kff, t, np, n, kt);\n", 1)]}

def k6_variant(group=32, producers=12, budget_kb=227, max_chunk=16, stages=3):
    """This tree's gps.cu with the GPS walk's (K6's and K7's) instances a
    block, producer warps (float), shared memory budget a block, largest
    chunk and ring stages changed."""
    subs = []
    if stages != 3:
        subs.append(("constexpr int kGpsStages = 3;", f"constexpr int kGpsStages = {stages};", 1))
    if group != 32:
        subs.append(("constexpr int kGpsGroup = 32;", f"constexpr int kGpsGroup = {group};", 1))
    if producers != 12:
        subs.append(("kGpsProducersFloat = 12,", f"kGpsProducersFloat = {producers},", 1))
    if budget_kb != 227:
        subs.append(("constexpr int kGpsBudget = 227 * 1024;", f"constexpr int kGpsBudget = {budget_kb} * 1024;", 1))
    if max_chunk != 16:
        subs.append(("  static constexpr int kChunk = walk_chunk<S, kGpsGroup, kGpsStages, E_, R_>(kGpsBudget);\n",
                     "  static constexpr int kChunk = walk_chunk<S, kGpsGroup, kGpsStages, E_, R_>(kGpsBudget) > "
                     f"{max_chunk} ? {max_chunk} : walk_chunk<S, kGpsGroup, kGpsStages, E_, R_>(kGpsBudget);\n", 1))
    return {"gps.cu": subs}


def merge(*patches):
    """One {file: subs} of several, the subs of a file in order."""
    out = {}
    for p in patches:
        for f, subs in p.items():
            out.setdefault(f, []).extend(subs)
    return out


# Stamps of K7's step (slots 0 loads, 1 the two factors and Λ_old, 2 the KL's
# carry-free part, 3 its three carry terms and the sum, 4 the propagation;
# 5 steps) in a gps.cu whose K7 runs one thread an instance (its first design).
K7_STAMPS = {"gps.cu": [
    ('#include "bwd_step.cuh"\n', '#include "bwd_step.cuh"\n' + stamp_header("gps_stamps"), 1),
    ("  for (int t = 0; t < T; ++t) {\n    S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX];\n",
     "  for (int t = 0; t < T; ++t) {\n    STAMP_BEGIN\n    S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX];\n", 1),
    ("    load(sigo_s, t, n, np, sigo);\n",
     "    load(sigo_s, t, n, np, sigo);\n    TOUCH(A, B, c, sigd, K, kff, sigc, Ko, ko, sigo)\n    STAMP(0)\n", 1),
    ("    chol(sc, Lc, inv_dc);\n",
     "    chol(sc, Lc, inv_dc);\n    TOUCH(Lo, inv_do, lam, Lc, inv_dc)\n    STAMP(1)\n", 1),
    ("    mv(diff_K, mu, dKmu);\n"
     "    const S kl_t = S(0.5) * (logdet_from_chol(Lo) - logdet_from_chol(Lc)) +\n"
     "                   S(0.5) * trace_prod(lam, sigc) - S(0.5 * DU) +\n"
     "                   S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -\n"
     "                   dot(mu, diff_crs) + S(0.5) * dot(dk, lam_dk);\n"
     "    kl = kl + kl_t;\n",
     "    const S h_ = S(0.5) * (logdet_from_chol(Lo) - logdet_from_chol(Lc)) +\n"
     "                 S(0.5) * trace_prod(lam, sigc) - S(0.5 * DU);\n"
     "    const S g_ = S(0.5) * dot(dk, lam_dk);\n"
     "    TOUCH(h_, g_, diff_K, diff_crs)\n    STAMP(2)\n"
     "    mv(diff_K, mu, dKmu);\n"
     "    const S kl_t = h_ + S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -\n"
     "                   dot(mu, diff_crs) + g_;\n"
     "    kl = kl + kl_t;\n    TOUCH(kl)\n    STAMP(3)\n", 1),
    ("    sym(Sn, Sx);\n  }\n  kl_out[n] = kl;\n",
     "    sym(Sn, Sx);\n    TOUCH(mu, Sx)\n    STAMP(4)\n    STAMP_COUNT(5)\n  }\n  kl_out[n] = kl;\n", 1),
]}
K7_STAMP_NAMES = ("loads", "factors", "kl_carry_free", "kl_carry_terms", "propagation")

# Stamps of K8's step (slots 0 loads of the b- and a-sized blocks, 1 the value
# blocks SF, SG, C, D, Eᵀ, 2 the channels c, d, e (the b²-row blocks read
# inside their matvecs against τ and vec S), 3 the regularization, the
# factor of D_reg and its solves, 4 the value update, 5 the stores; 6 steps)
# in a belief.cu of one thread an instance (its first design).
K8_STAMPS = {"belief.cu": [
    ('#include "bwd_step.cuh"\n', '#include "bwd_step.cuh"\n' + stamp_header("belief_stamps"), 1),
    ("  for (int t = T - 1; t >= 0; --t) {\n    S Q[B][B],",
     "  for (int t = T - 1; t >= 0; --t) {\n    STAMP_BEGIN\n    S Q[B][B],", 1),
    ("    load(Gs, t, n, np, G);\n",
     "    load(Gs, t, n, np, G);\n    TOUCH(Q, q, R, r, P, F, G)\n    STAMP(0)\n", 1),
    ("        for (int j = 0; j < A; ++j) D[i][j] = R[i][j] + GtSG[i][j];\n    }\n",
     "        for (int j = 0; j < A; ++j) D[i][j] = R[i][j] + GtSG[i][j];\n    }\n"
     "    TOUCH(C, D, ET, SF, SG)\n    STAMP(1)\n", 1),
    ("      for (int i = 0; i < BB; ++i) e[i] = p[i] + Ut[i] + S(0.5) * Yv[i];\n    }\n",
     "      for (int i = 0; i < BB; ++i) e[i] = p[i] + Ut[i] + S(0.5) * Yv[i];\n    }\n"
     "    TOUCH(c, d, e)\n    STAMP(2)\n", 1),
    ("      for (int i = 0; i < A; ++i) kff[i] = -x[i];\n    }\n",
     "      for (int i = 0; i < A; ++i) kff[i] = -x[i];\n    }\n    TOUCH(K, kff)\n    STAMP(3)\n", 1),
    ("      sym(Sn, Sv);\n    }\n",
     "      sym(Sn, Sv);\n    }\n    TOUCH(Sv, sv, tau, ds0, ds1)\n    STAMP(4)\n", 1),
    ("    store(tau_out, t, n, np, tau);\n  }\n",
     "    store(tau_out, t, n, np, tau);\n    STAMP(5)\n    STAMP_COUNT(6)\n  }\n", 1),
]}
K8_STAMP_NAMES = ("loads", "value_blocks", "channels", "factor_and_solves", "value_update",
                  "stores")


# Stamps of the staged walk (staged_walk.cuh; K6 and K7 in gps.cu, K8 in
# belief.cu): the consumer's waits for a filled stage (slot 8) and its whole
# walk (9); the first producer thread's chunk: the next chunk's copies issued
# and this chunk's landed (10), the producers' barrier (11), the carry-free
# part (12), chunks (13).  Each kernel's step fills slots 0-6 and counts its
# steps in 7.
WALK_STAMPS = [
    ("    typename W::Carry carry;\n",
     "    const long long walk0 = clock64();\n    typename W::Carry carry;\n", 1),
    ("      ring_acquire<B, NS>(k);\n",
     "      const long long w0 = clock64();\n      ring_acquire<B, NS>(k);\n"
     "      if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[8] += clock64() - w0;\n", 1),
    ("    if (live) w.finish(carry, n);\n",
     "    if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[9] += clock64() - walk0;\n"
     "    if (live) w.finish(carry, n);\n", 1),
    ("    for (int k = 0; k < chunks; ++k) {\n      if (k + 1 < chunks) {\n",
     "    for (int k = 0; k < chunks; ++k) {\n      const long long p0 = clock64();\n      if (k + 1 < chunks) {\n", 1),
    ("      if constexpr (W::kAugments) {\n        named_sync<P>(Sh::kProducerBarrier);   // chunk k's copies have landed\n",
     "      const long long p1 = clock64();\n      PSTAMP(10, p0, p1)\n      long long p2 = p1;\n"
     "      if constexpr (W::kAugments) {\n        named_sync<P>(Sh::kProducerBarrier);   // chunk k's copies have landed\n"
     "        p2 = clock64();\n        PSTAMP(11, p1, p2)\n", 1),
    ("      ring_publish<B, NS>(k);\n",
     "      PSTAMP(12, p2, clock64())\n      if (blockIdx.x == 0 && threadIdx.x == 32) g_stamp[13] += 1;\n"
     "      ring_publish<B, NS>(k);\n", 1),
]
PSTAMP = "#define PSTAMP(i, a, b) { if (blockIdx.x == 0 && threadIdx.x == 32) g_stamp[i] += (b) - (a); }\n"


def walk_stamps(cu, entry, steps):
    """{file: subs} stamping the walk and, in ``cu``, the steps ``steps``."""
    return {cu: [('#include "bwd_step.cuh"\n', '#include "bwd_step.cuh"\n' + stamp_header(entry) + PSTAMP, 1)]
            + steps, "staged_walk.cuh": WALK_STAMPS}


# K6's step on the walk (slots 0 stage reads, 1 Q blocks, 2 factor of −Quu
# and its solves, 3 value update, 4 stores).
WALK_K6_STEP = [
    ("                                               S (&sigc)[DU][DU]) {\n  using L = GpsSlot<DX, DU>;\n",
     "                                               S (&sigc)[DU][DU]) {\n  STAMP_BEGIN\n  using L = GpsSlot<DX, DU>;\n", 1),
    ("  const bool bad_o = op[L::BAD * G] != S(0);\n",
     "  const bool bad_o = op[L::BAD * G] != S(0);\n"
     "  TOUCH(A, B, c, sigd, agCxx, agCxu, agcx, agCuu, agcu, agc0, nia, na)\n  STAMP(0)\n", 1),
    ("  const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));\n",
     "  const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));\n"
     "  TOUCH(q0, Qxx, QuxT, Quu, qu, qx)\n  STAMP(1)\n", 1),
    ("  {\n    S QuxTK[DX][DX], Vn[DX][DX];\n",
     "  TOUCH(K, kff, sigc)\n  STAMP(2)\n  {\n    S QuxTK[DX][DX], Vn[DX][DX];\n", 1),
    ("  v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));\n}\n",
     "  v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));\n"
     "  TOUCH(V, v, v0)\n  STAMP(3)\n}\n", 1),
    ("    gps_chain_step<S, DX, DU>(op, k.V, k.v, k.v0, k.bad, Kt, kff, sigc);\n",
     "    gps_chain_step<S, DX, DU>(op, k.V, k.v, k.v0, k.bad, Kt, kff, sigc);\n    STAMP_BEGIN\n", 1),
    ("    store(sigc_out, t, n, np, sigc);\n",
     "    store(sigc_out, t, n, np, sigc);\n    STAMP(4)\n    STAMP_COUNT(7)\n", 1),
]
WALK_K6_NAMES = ("stage_reads", "Q_blocks", "factor_and_solves", "value_update", "stores")

# K7's consumer step (slots 0 stage reads, 1 the three carry terms and the
# sum, 2 the propagation).
WALK_K7_STEP = [
    ("    using L = KlSlot<DX, DU>;\n    constexpr int G = kGpsGroup;\n    S A_[DX][DX]",
     "    STAMP_BEGIN\n    using L = KlSlot<DX, DU>;\n    constexpr int G = kGpsGroup;\n    S A_[DX][DX]", 1),
    ("    const S h = op[L::H * G], tail = op[L::TAIL * G];\n",
     "    const S h = op[L::H * G], tail = op[L::TAIL * G];\n"
     "    TOUCH(A_, B_, c_, sigd_, Kt, kt, sc, diff_K, diff_crs, h, tail)\n    STAMP(0)\n", 1),
    ("    k.kl = k.kl + kl_t;\n", "    k.kl = k.kl + kl_t;\n    TOUCH(k.kl)\n    STAMP(1)\n", 1),
    ("    sym(Sn, Sx);\n  }\n",
     "    sym(Sn, Sx);\n    TOUCH(k.mu, k.Sx)\n    STAMP(2)\n    STAMP_COUNT(7)\n  }\n", 1),
]
WALK_K7_NAMES = ("stage_reads", "kl_carry_terms", "propagation")

# K8's consumer step (slots 0 stage reads of the b- and a-sized blocks, 1 the
# value blocks, 2 the channels with their b²-row reads, 3 regularization,
# factor and solves, 4 value update, 5 stores).
WALK_K8_STEP = [
    ("    const S lam = k.lam;\n", "    const S lam = k.lam;\n    STAMP_BEGIN\n", 1),
    ("    slot_get<Gr>(op, L::G, G);\n",
     "    slot_get<Gr>(op, L::G, G);\n    TOUCH(Q, q, R_, r, P, F, G)\n    STAMP(0)\n", 1),
    ("        for (int j = 0; j < A; ++j) D[i][j] = R_[i][j] + GtSG[i][j];\n    }\n",
     "        for (int j = 0; j < A; ++j) D[i][j] = R_[i][j] + GtSG[i][j];\n    }\n"
     "    TOUCH(C, D, ET, SF, SG)\n    STAMP(1)\n", 1),
    ("      for (int i = 0; i < BB; ++i) e[i] = p[i] + Ut[i] + S(0.5) * Yv[i];\n    }\n",
     "      for (int i = 0; i < BB; ++i) e[i] = p[i] + Ut[i] + S(0.5) * Yv[i];\n    }\n"
     "    TOUCH(c, d, e)\n    STAMP(2)\n", 1),
    ("      for (int i = 0; i < A; ++i) kff[i] = -x[i];\n    }\n",
     "      for (int i = 0; i < A; ++i) kff[i] = -x[i];\n    }\n    TOUCH(K, kff)\n    STAMP(3)\n", 1),
    ("      sym(Sn, Sv);\n    }\n",
     "      sym(Sn, Sv);\n    }\n    TOUCH(Sv, sv, tau, k.ds0, k.ds1)\n    STAMP(4)\n", 1),
    ("    store(tau_out, t, n, np, tau);\n  }\n",
     "    store(tau_out, t, n, np, tau);\n    STAMP(5)\n    STAMP_COUNT(7)\n  }\n", 1),
]
WALK_K8_NAMES = ("stage_reads", "value_blocks", "channels", "factor_and_solves", "value_update",
                 "stores")
GPS_WALK_STAMPS = walk_stamps("gps.cu", "gps_stamps", WALK_K6_STEP + WALK_K7_STEP)
BELIEF_WALK_STAMPS = walk_stamps("belief.cu", "belief_stamps", WALK_K8_STEP)


def walk_report(raw, names):
    """Cycles a consumer step by phase, its waits and its walk, and the first
    producer thread's cycles a chunk, from the raw counters of WALK_STAMPS."""
    d = stamps_per_step(raw, names, 7)
    chunks = max(raw[13], 1)
    d.update({"acquire_wait_per_step": raw[8] / max(raw[7], 1),
              "walk_per_step": raw[9] / max(raw[7], 1),
              "producer_chunks": raw[13], "producer_copy_wait_per_chunk": raw[10] / chunks,
              "producer_barrier_per_chunk": raw[11] / chunks,
              "producer_augment_per_chunk": raw[12] / chunks})
    return d


# K6's step and walk stamps on this tree (variants.py, final_ab.py).
NEW_K6_STAMPS = walk_stamps("gps.cu", "gps_stamps", WALK_K6_STEP)


def new_k6_report(raw):
    return walk_report(raw, WALK_K6_NAMES)


# K7's measured alternative: the consumer hands (μ_t, Σ_t) back into its
# stage slot (over c and A, which it has read) and producer warp 0 takes the
# three carry terms and sums the KL in t order once the consumer has
# released the chunk (before the chunk's stage is refilled; the last
# kStages chunks after the consumer's walk, behind one more barrier).
KL_ON_PRODUCERS = {
    "staged_walk.cuh": [
        ("        const S* stage = ring + (k % NS) * Sh::STAGE + g;\n",
         "        S* stage = ring + (k % NS) * Sh::STAGE + g;\n", 1),
        ("    if (live) w.finish(carry, n);\n",
         "    if constexpr (W::kTail) named_arrive<64>(Sh::kProducerBarrier + 1);\n"
         "    if (live) w.finish(carry, n);\n", 1),
        ("    int t0, steps;\n    walk_span<W>(0, T, t0, steps);\n    ring_reserve<B, NS>(0);\n",
         "    int t0, steps;\n    typename W::Tail acc{};\n"
         "    const bool tail_lane = W::kTail && tid < G && n0 + tid < N;\n"
         "    auto tail_of = [&](int c) {\n"
         "      int c0, cs;\n      walk_span<W>(c, T, c0, cs);\n"
         "      const S* st = ring + (c % NS) * Sh::STAGE + tid;\n"
         "      if constexpr (W::kTail)\n        for (int s = 0; s < cs; ++s) w.tail(st + s * E * G, acc);\n    };\n"
         "    walk_span<W>(0, T, t0, steps);\n    ring_reserve<B, NS>(0);\n", 1),
        ("        ring_reserve<B, NS>(k + 1);\n        walk_copy(",
         "        ring_reserve<B, NS>(k + 1);\n"
         "        if (W::kTail && k + 1 >= NS) {\n          if (tail_lane) tail_of(k + 1 - NS);\n"
         "          named_sync<P>(Sh::kProducerBarrier);   // read before it is refilled\n        }\n"
         "        walk_copy(", 1),
        ("      ring_publish<B, NS>(k);\n    }\n  }\n}\n",
         "      ring_publish<B, NS>(k);\n    }\n"
         "    if constexpr (W::kTail) {\n      if (tid < 32) {\n"
         "        named_sync<64>(Sh::kProducerBarrier + 1);\n"
         "        if (tail_lane) {\n"
         "          for (int c = chunks > NS ? chunks - NS : 0; c < chunks; ++c) tail_of(c);\n"
         "          w.finish_tail(acc, n0 + tid);\n        }\n      }\n    }\n  }\n}\n", 1),
    ],
    "gps.cu": [
        ("  static constexpr bool kAugments = true;\n};\n",
         "  static constexpr bool kAugments = true;\n  static constexpr bool kTail = false;\n  struct Tail {};\n};\n", 1),
        ("  static constexpr bool kForward = true;\n  static constexpr int COPIED = KlSlot<DX, DU>::COPIED;\n",
         "  static constexpr bool kForward = true;\n  static constexpr int COPIED = KlSlot<DX, DU>::COPIED;\n"
         "  static constexpr bool kTail = true;\n  struct Tail { S kl; };\n"
         "  __device__ __forceinline__ void tail(const S* op, Tail& acc) const {\n"
         "    using L = KlSlot<DX, DU>;\n    constexpr int G = kGpsGroup;\n"
         "    S mu[DX], Sx[DX][DX], diff_K[DX][DX], diff_crs[DX];\n"
         "    slot_get<G>(op, L::C, mu);\n    slot_get<G>(op, L::A, Sx);\n"
         "    slot_get<G>(op, L::DIFFK, diff_K);\n    slot_get<G>(op, L::DIFFCRS, diff_crs);\n"
         "    const S h = op[L::H * G], tail = op[L::TAIL * G];\n"
         "    S dKmu[DX];\n    mv(diff_K, mu, dKmu);\n"
         "    const S kl_t = h + S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -\n"
         "                   dot(mu, diff_crs) + tail;\n    acc.kl = acc.kl + kl_t;\n  }\n"
         "  __device__ __forceinline__ void finish_tail(const Tail& acc, int n) const { kl_out[n] = acc.kl; }\n", 1),
        ("  __device__ __forceinline__ void step(const S* op, Carry& k, int, int) const {\n",
         "  __device__ __forceinline__ void step(S* op, Carry& k, int, int) const {\n", 1),
        ("    // ---- the KL terms that read (μ_t, Σ_t) ----------------------------------------\n"
         "    S dKmu[DX];\n    mv(diff_K, mu, dKmu);\n"
         "    const S kl_t = h + S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -\n"
         "                   dot(mu, diff_crs) + tail;\n    k.kl = k.kl + kl_t;\n",
         "    (void)h; (void)tail;\n    slot_put<G>(op, L::C, mu);\n    slot_put<G>(op, L::A, Sx);\n", 1),
        ("  __device__ __forceinline__ void finish(const Carry& k, int n) const {\n    kl_out[n] = k.kl;\n",
         "  __device__ __forceinline__ void finish(const Carry& k, int n) const {\n", 1),
    ],
}


BSP_SHAPE = ("  static constexpr int kGroup = kWide ? 16 : 32;\n"
             "  static constexpr int kStages = kWide ? 2 : 4;\n"
             "  static constexpr int kProducers = kWide ? 4 : sizeof(S) == 4 ? 12 : 6;\n"
             "  // float (4, 2): two blocks an SM (99.6 KB each)\n"
             "  static constexpr int kBudget = (kWide && sizeof(S) == 4 ? 113 : 227) * 1024;\n"
             "  static constexpr int kChunk = walk_chunk<S, kGroup, kStages, E, 0>(kBudget);\n")


def k8_variant(group=(32, 32, 16, 16), stages=(4, 2), producers=(12, 6, 4, 4),
               budget_kb=(227, 227, 113, 227)):
    """This tree's belief.cu with K8's walk shape changed: instances a block,
    producer warps and the shared memory budget a block for (b = 2 float,
    b = 2 double, b = 4 float, b = 4 double) and stages for (b = 2, b = 4)
    (the defaults are this tree's)."""
    def pick(v):
        return (f"(kWide ? (sizeof(S) == 4 ? {v[2]} : {v[3]}) : (sizeof(S) == 4 ? {v[0]} : {v[1]}))")
    return {"belief.cu": [(BSP_SHAPE,
        f"  static constexpr int kGroup = {pick(group)};\n"
        f"  static constexpr int kStages = kWide ? {stages[1]} : {stages[0]};\n"
        f"  static constexpr int kProducers = {pick(producers)};\n"
        f"  static constexpr int kBudget = {pick(budget_kb)} * 1024;\n"
        f"  static constexpr int kChunk = walk_chunk<S, kGroup, kStages, E, 0>(kBudget);\n", 1)]}


def walk_first(first):
    """This tree's staged_walk.cuh with every walk's first chunk at most
    ``first`` steps, the others kChunk."""
    f = f"(W::kChunk < {first} ? W::kChunk : {first})"
    return {"staged_walk.cuh": [
        ("  const int done = k * W::kChunk;   // steps before chunk k\n"
         "  steps = T - done < W::kChunk ? T - done : W::kChunk;\n",
         f"  const int done = k == 0 ? 0 : {f} + (k - 1) * W::kChunk;\n"
         f"  const int len = k == 0 ? {f} : W::kChunk;\n"
         "  steps = T - done < len ? T - done : len;\n", 1),
        ("__device__ __forceinline__ int walk_chunks(int T) { return (T + W::kChunk - 1) / W::kChunk; }",
         f"__device__ __forceinline__ int walk_chunks(int T) {{\n"
         f"  return T <= 0 ? 0 : T <= {f} ? 1 : 1 + (T - {f} + W::kChunk - 1) / W::kChunk;\n}}", 1)]}


# K7's producers factor Σ_old and Σ_ctl with the library's root and
# reciprocal (this tree's take PivotOps').
K7_LIBRARY_FACTORS = {"gps.cu": [
    ("    chol<S, DU, true>(so, Lo, inv_do);\n", "    chol(so, Lo, inv_do);\n", 1),
    ("    chol<S, DU, true>(sc, Lc, inv_dc);\n", "    chol(sc, Lc, inv_dc);\n", 1)]}
# K7 at 2/1 in float with the other builds' producer warps (this tree's: 16).
K7_21_P12 = {"gps.cu": [("sizeof(S) == 4 ? (DX == 2 ? 16 : kGpsProducersFloat)",
                         "sizeof(S) == 4 ? (DX == 2 ? kGpsProducersFloat : kGpsProducersFloat)", 1)]}


# bwd_step.cuh's chol with PivotOps' root and reciprocal for every caller
# (K1, K4, K5, K8 and K7's producers as well as K6).
ALWAYS_PIVOT = {"bwd_step.cuh": [("template <typename S, int N, bool Pivot = false>",
                                  "template <typename S, int N, bool Pivot = true>", 1)]}

# K8 factoring D_reg with the library's root and reciprocal (this tree's
# takes PivotOps').
K8_LIBRARY_FACTOR = {"belief.cu": [("    k.bad = chol<S, A, true>(Ds, Lf, inv_d) || k.bad;\n",
                                    "    k.bad = chol(Ds, Lf, inv_d) || k.bad;\n", 1)]}
