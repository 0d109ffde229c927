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

# Stamps of the staged K6 (this tree's): the consumer's step (slots 0 operand
# reads from the stage, 1 Q blocks, 2 factor of −Quu and its solves, 3 value
# update, 4 stores; 7 steps), its waits for a filled stage (8) and its whole
# walk (9); the first producer thread's chunk: the next chunk's copies issued
# and this chunk's landed (10), the producers' barrier (11), the
# augmentation (12), chunks (13).
NEW_K6_STAMPS = {"gps.cu": [
    ('#include "bwd_step.cuh"\n', '#include "bwd_step.cuh"\n' + stamp_header("gps_stamps")
     + "#define PSTAMP(i, a, b) { if (blockIdx.x == 0 && threadIdx.x == 32) g_stamp[i] += (b) - (a); }\n", 1),
    ("                                               S (&sigc)[DU][DU]) {\n  using L = GpsSlot<DX, DU>;\n",
     "                                               S (&sigc)[DU][DU]) {\n  STAMP_BEGIN\n  using L = GpsSlot<DX, DU>;\n", 1),
    ("  const bool bad_o = op[L::BAD * kGpsGroup] != S(0);\n",
     "  const bool bad_o = op[L::BAD * kGpsGroup] != S(0);\n"
     "  TOUCH(A, B, c, sigd, agCxx, agCxu, agcx, agCuu, agcu, agc0, nia, na)\n  STAMP(0)\n", 1),
    ("  const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));\n",
     "  const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));\n"
     "  TOUCH(q0, Qxx, QuxT, Quu, qu, qx)\n  STAMP(1)\n", 1),
    ("  {\n    S QuxTK[DX][DX], Vn[DX][DX];\n",
     "  TOUCH(K, kff, sigc)\n  STAMP(2)\n  {\n    S QuxTK[DX][DX], Vn[DX][DX];\n", 1),
    ("  v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));\n}\n",
     "  v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));\n"
     "  TOUCH(V, v, v0)\n  STAMP(3)\n}\n", 1),
    ("          gps_chain_step<S, DX, DU>(stage + s * E * G, V, v, v0, bad, Kt, kff, sigc);\n",
     "          gps_chain_step<S, DX, DU>(stage + s * E * G, V, v, v0, bad, Kt, kff, sigc);\n"
     "          STAMP_BEGIN\n", 1),
    ("          store(sigc_out, t, n, np, sigc);\n",
     "          store(sigc_out, t, n, np, sigc);\n          STAMP(4)\n          STAMP_COUNT(7)\n", 1),
    ("      ring_acquire<B, NS>(k);\n",
     "      const long long w0 = clock64();\n      ring_acquire<B, NS>(k);\n"
     "      if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[8] += clock64() - w0;\n", 1),
    ("    S V[DX][DX], v[DX], v0 = S(0);\n    bool bad = false;\n",
     "    const long long walk0 = clock64();\n    S V[DX][DX], v[DX], v0 = S(0);\n    bool bad = false;\n", 1),
    ("    if (live) {\n      store(V0_out, 0, n, np, V);\n",
     "    if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[9] += clock64() - walk0;\n"
     "    if (live) {\n      store(V0_out, 0, n, np, V);\n", 1),
    ("    for (int k = 0; k < chunks; ++k) {\n      if (k + 1 < chunks) {\n",
     "    for (int k = 0; k < chunks; ++k) {\n      const long long p0 = clock64();\n      if (k + 1 < chunks) {\n", 1),
    ("      named_sync<P>(kGpsProducerBarrier);   // chunk k's copies have landed\n",
     "      const long long p1 = clock64();\n      PSTAMP(10, p0, p1)\n"
     "      named_sync<P>(kGpsProducerBarrier);   // chunk k's copies have landed\n"
     "      const long long p2 = clock64();\n      PSTAMP(11, p1, p2)\n", 1),
    ("      ring_publish<B, NS>(k);\n",
     "      PSTAMP(12, p2, clock64())\n      if (blockIdx.x == 0 && threadIdx.x == 32) g_stamp[13] += 1;\n"
     "      ring_publish<B, NS>(k);\n", 1),
]}
NEW_K6_STEP_NAMES = ("stage_reads", "Q_blocks", "factor_and_solves", "value_update", "stores")


def new_k6_report(raw):
    d = stamps_per_step(raw, NEW_K6_STEP_NAMES, 7)
    chunks = max(raw[13], 1)
    d.update({"acquire_wait_per_step": raw[8] / max(raw[7], 1),
              "walk_per_step": raw[9] / max(raw[7], 1),
              "producer_chunks": raw[13], "producer_copy_wait_per_chunk": raw[10] / chunks,
              "producer_barrier_per_chunk": raw[11] / chunks,
              "producer_augment_per_chunk": raw[12] / chunks})
    return d


def k6_variant(group=32, producers=12, budget_kb=227, max_chunk=16, stages=3):
    """This tree's gps.cu with K6's instances a block, producer warps (float),
    shared memory budget a block, largest chunk and ring stages changed."""
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
        subs.append(("gps_bytes<S, DX, DU>(16) <= kGpsBudget  ? 16", "gps_bytes<S, DX, DU>(16) < 0 ? 16", 1))
    return {"gps.cu": subs}
