"""Source patches for the A/B scripts: clock64 stamps in the eLQR sweep
steps, counters of K2/K3's out-of-range numerators and retaken chunks, and
the variants of K2/K3's range vote and of the eLQR sweeps' block size that
were timed against each other (PERF.md).  Each is ``{file name: [(old, new,
count)]}`` for ``common.patched_copy``."""

STAMP_HEADER = r'''
__device__ unsigned long long g_stamp[20];
#define STAMP_BEGIN long long _st = clock64();
#define STAMP_RESET _st = clock64();
#define STAMP(i) { long long _s1 = clock64(); if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[i] += _s1 - _st; _st = _s1; }
#define STAMP_COUNT(i) { if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[i] += 1; }
extern "C" int elqr_stamps(unsigned long long* out, int reset) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (reset) { unsigned long long z[20] = {}; cudaMemcpyToSymbol(g_stamp, z, sizeof(z)); }
  return (int)cudaGetLastError();
}
'''

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
