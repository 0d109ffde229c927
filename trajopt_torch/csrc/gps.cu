// K6 and K7: the two launches of one GPS dual evaluation, batched over
// problem instances.
//
// K6 replaces trajopt_tpu/core/pallas_gps.py::_gps_backward_kernel (wrappers
// pallas_gps_backward / pallas_gps_backward_packed): the KL augmentation of
// the absolute-convention cost by the old policy (Λ_old from a guarded
// Cholesky, log det Σ_old) fused into the −1/α-scaled soft-Riccati step.  It
// writes the controller (K, kff, Σ_ctl) of every step, the t = 0 value
// (V₀, v₀, c₀) and a per-instance flag (Σ_old or −Quu not positive definite).
//
// K7 replaces pallas_gps.py::_gps_forward_kl_kernel (wrappers
// pallas_gps_forward_kl_packed / pallas_gps_forward_kl): the policy
// KL(new‖old) under the state marginal N(μ_t, Σ_t), summed over t, fused with
// the exact propagation of (μ, Σ) through x' = Ax + Bu + c, u ~ N(Kx + kff,
// Σ_ctl).  It takes the KL at (μ_t, Σ_t) before propagating them.
//
// What bounds them on the H100: each instance is a chain of T dependent
// steps of small-matrix algebra.  The bytes (K6 reads 94 and writes 14
// scalars per instance-step at dx=4, du=2, 28 and 4 at 2/1; K7 reads 72) are
// the floor only when each step's latency is hidden.  K6's first design ran
// one thread per instance in one-warp blocks (at N=4096, one warp an SM) and
// took 2,560 cycles a step at 2/1, half of it waiting on the step's 28 loads
// from device memory and most of the rest on the KL augmentation and −1/α,
// which do not depend on the value carry at all (PERF.md).
//
// K6's design: the chain alone on the consumer.  A block takes kGpsGroup (32)
// instances; warp 0 is the consumer, one lane per instance, and walks t =
// T−1 … 0 with (V, v, v0, flag) in registers, doing only what depends on
// them (V·A, V·B, V·c, the Q blocks, the factor of −Quu with PivotOps' root
// and reciprocal (pivot.cuh: sqrtf's and 1/d's bits without the slow-path
// branch), K, kff, Σ_ctl, the value update), every operand read from shared
// memory.  Producer warps (12 in float, 6 in double) fill a ring of
// kGpsStages (3) stages, a chunk of steps each: they copy chunk k + 1's rows
// of the streams (cp.async, 16 bytes a copy where N and the addresses allow,
// else an entry), A, B, c and Σ_dyn straight into its stage and the rest into
// one of two buffers of their own, while they compute chunk k's carry-free
// part of each step (Σ_old's factor, Λ_old, log det Σ_old, the augmented
// cost blocks, −1/α and −α) from the other buffer into its stage.  A chunk
// is 16 steps where the ring and the buffers fit a block's shared memory,
// else 8, 4 or 2 (float32 4/2: 4; float64 4/2: 2); at N=4096, 128 blocks
// take one SM each.  Lanes past N neither read nor write, so any N ≥ 1 runs.
// K6 shares ring.cuh's roles, barriers and copies and bwd_step.cuh's
// chunk_span, algebra and guarded Cholesky with K1 and K4, but not
// staged_backward's block body, whose assumptions it breaks: that body takes
// whole groups of 16 instances (launch_staged refuses any other N), K6 any N
// with a masked tail; its producers fill a chunk and return once the copies
// have landed, K6's copy chunk k + 1 into a buffer of their own while they
// compute chunk k, so no producer waits on a chunk's copies; its ring is
// kStages (2) stages of kChunk (16) steps, K6's three stages of a chunk sized
// to the dtype and dims; its consumer writes K, kff and dV, K6's Σ_ctl, V₀,
// v₀ and c₀ as well.
// The operations and their order are the first design's, so the outputs are
// the same to the bit.  What bounds it now: at 2/1 the consumer's step
// (about 500 cycles, its instructions issued in order by one warp) and the
// first chunk's copies before the walk can start; at 4/2 the consumer's
// step, which is three times as long (PERF.md).
//
// K7 keeps the first design: one thread per instance walks the horizon with
// its carry (μ, Σ, the KL sum) in registers, in one-warp blocks.
//
// Operands are structure of arrays (T, entries, N) with instances
// contiguous, so a warp's loads of one entry coalesce; K6 writes (K, kff,
// Σ_ctl) in exactly the layout K7 reads, so nothing is relaid between the
// two launches.  Sums run in the TPU kernels' order and the build uses
// -fmad=false, so the float64 build equals the plain PyTorch versions
// (core/cuda_gps.py) to rounding.
#include <cuda_runtime.h>

#include "bwd_step.cuh"

namespace {

constexpr double LOG_2PI = 1.8378770664093453;
constexpr double LOG_2 = 0.6931471805599453;

__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// Entry e of step t of a (T, entries, N) stream, instance n.
template <typename S, int R, int C>
__device__ __forceinline__ void load(const S* __restrict__ p, int t, int n, size_t np,
                                     S (&M)[R][C]) {
  const size_t base = (size_t)t * R * C;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) M[i][j] = p[(base + i * C + j) * np + n];
}

template <typename S, int R>
__device__ __forceinline__ void load(const S* __restrict__ p, int t, int n, size_t np,
                                     S (&x)[R]) {
  const size_t base = (size_t)t * R;
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = p[(base + i) * np + n];
}

template <typename S, int R, int C>
__device__ __forceinline__ void store(S* __restrict__ p, int t, int n, size_t np,
                                      const S (&M)[R][C]) {
  const size_t base = (size_t)t * R * C;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) p[(base + i * C + j) * np + n] = M[i][j];
}

template <typename S, int R>
__device__ __forceinline__ void store(S* __restrict__ p, int t, int n, size_t np,
                                      const S (&x)[R]) {
  const size_t base = (size_t)t * R;
#pragma unroll
  for (int i = 0; i < R; ++i) p[(base + i) * np + n] = x[i];
}

// C = A Bᵀ for A (n, k), B (m, k).
template <typename S, int N, int K, int M>
__device__ __forceinline__ void mm_nt(const S (&A)[N][K], const S (&B)[M][K], S (&C)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      S s = A[i][0] * B[j][0];
#pragma unroll
      for (int l = 1; l < K; ++l) s = s + A[i][l] * B[j][l];
      C[i][j] = s;
    }
}

// (L Lᵀ)⁻¹ by solves against the columns of the identity.
template <typename S, int N>
__device__ __forceinline__ void chol_inv(const S (&L)[N][N], const S (&inv_d)[N],
                                         S (&X)[N][N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    S e[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = i == c ? S(1) : S(0);
    chol_solve(L, inv_d, e, x);
#pragma unroll
    for (int i = 0; i < N; ++i) X[i][c] = x[i];
  }
}

template <typename S, int N>
__device__ __forceinline__ S logdet_from_chol(const S (&L)[N][N]) {
  S s = log_(L[0][0]);
#pragma unroll
  for (int j = 1; j < N; ++j) s = s + log_(L[j][j]);
  return S(2) * s;
}

// tr(M Nm) = Σᵢⱼ Mᵢⱼ Nmⱼᵢ, i outer.
template <typename S, int R, int C>
__device__ __forceinline__ S trace_prod(const S (&M)[R][C], const S (&Nm)[C][R]) {
  S s = M[0][0] * Nm[0][0];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (i > 0 || j > 0) s = s + M[i][j] * Nm[j][i];
  return s;
}

}  // namespace

// ---- K6: the staged backward ----------------------------------------------------

constexpr int kGpsGroup = 32;       // instances a block, one consumer lane each
constexpr int kGpsStages = 3;       // stages of the ring
constexpr int kGpsBudget = 227 * 1024;   // shared memory a block (N=4096: 128 blocks)
constexpr int kGpsProducerBarrier = 1 + 2 * kGpsStages;   // after the ring's
// Producer warps: in float as many as keep the consumer fed; in double
// fewer, so that a thread keeps the registers its wider step needs.
constexpr int kGpsProducersFloat = 12, kGpsProducersDouble = 6;

// A step's slot in a stage, what the chain reads: A, B, c and Σ_dyn as the
// streams hold them, then what the producers compute off the chain (the
// augmented cost blocks, −1/α, −α and Σ_old's flag).  Entry e of step slot
// s of lane g sits at [(s·E + e)·kGpsGroup + g].
template <int DX, int DU>
struct GpsSlot {
  static constexpr int A = 0, B = A + DX * DX, C = B + DX * DU, SIGD = C + DX,
                       CXX = SIGD + DX * DX, CXU = CXX + DX * DX, CX = CXU + DX * DU,
                       CUU = CX + DX, CU = CUU + DU * DU, C0 = CU + DU, NIA = C0 + 1,
                       NA = NIA + 1, BAD = NA + 1, E = BAD + 1;
  static constexpr int COPIED = CXX;   // entries copied straight from the streams
};

// A step's slot in the producers' own buffers (two, so that one chunk's
// copies land while the chunk before is augmented): the streams the
// augmentation reads, laid out as a stage.
template <int DX, int DU>
struct GpsRaw {
  static constexpr int CXX = 0, CX = CXX + DX * DX, CUU = CX + DX, CU = CUU + DU * DU,
                       CXU = CU + DU, C0 = CXU + DX * DU, KO = C0 + 1, KOF = KO + DU * DX,
                       SIGO = KOF + DU, ALPHA = SIGO + DU * DU, E = ALPHA + 1;
};

// The chunk (steps a stage) and the shared memory of a block: the ring of
// kGpsStages stages and the producers' two buffers, 16 steps where that fits
// the budget, else 8, 4 or 2.
template <typename S, int DX, int DU>
constexpr int gps_bytes(int chunk) {
  return (int)sizeof(S) * chunk * kGpsGroup *
         (kGpsStages * GpsSlot<DX, DU>::E + 2 * GpsRaw<DX, DU>::E);
}
template <typename S, int DX, int DU>
struct GpsShape {
  static constexpr int E = GpsSlot<DX, DU>::E, R = GpsRaw<DX, DU>::E;
  static constexpr int kProducers = sizeof(S) == 4 ? kGpsProducersFloat : kGpsProducersDouble;
  using Roles = WarpRoles<1, kProducers>;
  static constexpr int kChunk =
      gps_bytes<S, DX, DU>(16) <= kGpsBudget  ? 16
      : gps_bytes<S, DX, DU>(8) <= kGpsBudget ? 8
      : gps_bytes<S, DX, DU>(4) <= kGpsBudget ? 4 : 2;
  static constexpr int STAGE = kChunk * E * kGpsGroup, RAW = kChunk * R * kGpsGroup,
                       BYTES = gps_bytes<S, DX, DU>(kChunk);
  static_assert(BYTES <= kGpsBudget, "a block's shared memory");
};

template <typename S>
struct GpsStreams {
  const S *cxx, *cx, *cuu, *cu, *cxu, *c0, *A, *B, *c, *sigd, *Ko, *ko, *sigo, *alpha;
  size_t np;

  // The row (all N instances) of copied entry e (e < COPIED) or of raw entry
  // e − COPIED, at step t.
  template <int DX, int DU>
  __device__ __forceinline__ const S* row(int e, size_t t) const {
    using L = GpsSlot<DX, DU>;
    using W = GpsRaw<DX, DU>;
    if (e < L::B) return A + (t * DX * DX + e) * np;
    if (e < L::C) return B + (t * DX * DU + e - L::B) * np;
    if (e < L::SIGD) return c + (t * DX + e - L::C) * np;
    if (e < L::COPIED) return sigd + (t * DX * DX + e - L::SIGD) * np;
    e -= L::COPIED;
    if (e < W::CX) return cxx + (t * DX * DX + e) * np;
    if (e < W::CUU) return cx + (t * DX + e - W::CX) * np;
    if (e < W::CU) return cuu + (t * DU * DU + e - W::CUU) * np;
    if (e < W::CXU) return cu + (t * DU + e - W::CU) * np;
    if (e < W::C0) return cxu + (t * DX * DU + e - W::CXU) * np;
    if (e < W::KO) return c0 + t * np;
    if (e < W::KOF) return Ko + (t * DU * DX + e - W::KO) * np;
    if (e < W::SIGO) return ko + (t * DU + e - W::KOF) * np;
    if (e < W::ALPHA) return sigo + (t * DU * DU + e - W::SIGO) * np;
    return alpha + t * np;
  }
};

// Read entry `at` onwards of a stage slot (lane stride kGpsGroup) into M / x,
// or write them there.
template <typename S, int R, int C>
__device__ __forceinline__ void slot_get(const S* op, int at, S (&M)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) M[i][j] = op[(at + i * C + j) * kGpsGroup];
}
template <typename S, int R>
__device__ __forceinline__ void slot_get(const S* op, int at, S (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = op[(at + i) * kGpsGroup];
}
template <typename S, int R, int C>
__device__ __forceinline__ void slot_put(S* op, int at, const S (&M)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) op[(at + i * C + j) * kGpsGroup] = M[i][j];
}
template <typename S, int R>
__device__ __forceinline__ void slot_put(S* op, int at, const S (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) op[(at + i) * kGpsGroup] = x[i];
}

// The carry-free part of a step (gps/src/util.cpp:136-193), on a producer
// thread: Σ_old's guarded Cholesky, Λ_old, log det Σ_old, the old policy's
// products and the augmented cost blocks, −1/α and −α, from the raw slot
// `raw` into the stage slot `op`.  The factor's root and reciprocal and the
// quotient −1/α are PivotOps' (the library's bits, without its slow-path
// branches).
template <typename S, int DX, int DU>
__device__ __forceinline__ void gps_augment(const S* raw, S* op) {
  using L = GpsSlot<DX, DU>;
  using W = GpsRaw<DX, DU>;
  S Cxx[DX][DX], cx_t[DX], Cuu[DU][DU], cu_t[DU], Cxu[DX][DU], Ko[DU][DX], ko[DU], sigo[DU][DU];
  slot_get(raw, W::CXX, Cxx);
  slot_get(raw, W::CX, cx_t);
  slot_get(raw, W::CUU, Cuu);
  slot_get(raw, W::CU, cu_t);
  slot_get(raw, W::CXU, Cxu);
  slot_get(raw, W::KO, Ko);
  slot_get(raw, W::KOF, ko);
  slot_get(raw, W::SIGO, sigo);
  const S c0 = raw[W::C0 * kGpsGroup], a = raw[W::ALPHA * kGpsGroup];

  S so[DU][DU], Lo[DU][DU], inv_do[DU], lam[DU][DU];
  sym(sigo, so);
  const bool bad_o = chol<S, DU, true>(so, Lo, inv_do);
  chol_inv(Lo, inv_do, lam);
  const S logdet_sigo = logdet_from_chol(Lo);
  S lamKo[DU][DX], lamko[DU];
  mm(lam, Ko, lamKo);
  mv(lam, ko, lamko);
  const S ha = S(0.5) * a;

  S agCxx[DX][DX], agCxu[DX][DU], agcx[DX], agCuu[DU][DU], agcu[DU];
  {
    S KtLK[DX][DX], KtLk[DX];
    mm_tn(Ko, lamKo, KtLK);
    mv_tn(Ko, lamko, KtLk);
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) agCxx[i][j] = Cxx[i][j] + ha * KtLK[i][j];
#pragma unroll
      for (int j = 0; j < DU; ++j) agCxu[i][j] = Cxu[i][j] - ha * lamKo[j][i];
      agcx[i] = cx_t[i] + a * KtLk[i];
    }
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DU; ++j) agCuu[i][j] = Cuu[i][j] + ha * lam[i][j];
      agcu[i] = cu_t[i] - a * lamko[i];
    }
  }
  slot_put(op, L::CXX, agCxx);
  slot_put(op, L::CXU, agCxu);
  slot_put(op, L::CX, agcx);
  slot_put(op, L::CUU, agCuu);
  slot_put(op, L::CU, agcu);
  op[L::C0 * kGpsGroup] = c0 + ha * (S(DU * LOG_2PI) + logdet_sigo) + ha * dot(ko, lamko);
  op[L::NIA * kGpsGroup] = PivotOps::div(S(-1), a);
  op[L::NA * kGpsGroup] = -a;
  op[L::BAD * kGpsGroup] = bad_o ? S(1) : S(0);
}

// The carry-dependent part of a step (gps/src/util.cpp:272-374), on the
// consumer lane: the −1/α-scaled soft-Riccati step from the staged slot
// `op`, the pivots of −Quu through PivotOps; updates (V, v, v0, bad) and
// gives the step's (K, kff, Σ_ctl).
template <typename S, int DX, int DU>
__device__ __forceinline__ void gps_chain_step(const S* op, S (&V)[DX][DX], S (&v)[DX], S& v0,
                                               bool& bad, S (&K)[DU][DX], S (&kff)[DU],
                                               S (&sigc)[DU][DU]) {
  using L = GpsSlot<DX, DU>;
  S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX];
  S agCxx[DX][DX], agCxu[DX][DU], agcx[DX], agCuu[DU][DU], agcu[DU];
  slot_get(op, L::A, A);
  slot_get(op, L::B, B);
  slot_get(op, L::C, c);
  slot_get(op, L::SIGD, sigd);
  slot_get(op, L::CXX, agCxx);
  slot_get(op, L::CXU, agCxu);
  slot_get(op, L::CX, agcx);
  slot_get(op, L::CUU, agCuu);
  slot_get(op, L::CU, agcu);
  const S agc0 = op[L::C0 * kGpsGroup], nia = op[L::NIA * kGpsGroup],
          na = op[L::NA * kGpsGroup];
  const bool bad_o = op[L::BAD * kGpsGroup] != S(0);

  S VA[DX][DX], VB[DX][DU], Vc[DX];
  mm(V, A, VA);
  mm(V, B, VB);
  mv(V, c, Vc);

  S Qxx[DX][DX], Quu[DU][DU], QuxT[DX][DU], qu[DU], qx[DX];
  {
    S t_xx[DX][DX], t_uu[DU][DU], t_xu[DX][DU];
    mm_tn(A, VA, t_xx);
    mm_tn(B, VB, t_uu);
    mm_tn(A, VB, t_xu);
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) Qxx[i][j] = nia * (agCxx[i][j] + t_xx[i][j]);
#pragma unroll
      for (int j = 0; j < DU; ++j) QuxT[i][j] = nia * (agCxu[i][j] + t_xu[i][j]);
    }
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) Quu[i][j] = nia * (agCuu[i][j] + t_uu[i][j]);
    S BtVc[DU], Btv[DU], AtVc[DX], Atv[DX];
    mv_tn(B, Vc, BtVc);
    mv_tn(B, v, Btv);
    mv_tn(A, Vc, AtVc);
    mv_tn(A, v, Atv);
#pragma unroll
    for (int i = 0; i < DU; ++i) qu[i] = nia * (agcu[i] + S(2) * BtVc[i] + Btv[i]);
#pragma unroll
    for (int i = 0; i < DX; ++i) qx[i] = nia * (agcx[i] + S(2) * AtVc[i] + Atv[i]);
  }
  const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));

  S negQuu[DU][DU], nq[DU][DU], Ln[DU][DU], inv_dn[DU];
#pragma unroll
  for (int i = 0; i < DU; ++i)
#pragma unroll
    for (int j = 0; j < DU; ++j) negQuu[i][j] = -Quu[i][j];
  sym(negQuu, nq);
  const bool bad_n = chol<S, DU, true>(nq, Ln, inv_dn);
  bad = bad || bad_o || bad_n;

  // K = (−Quu)⁻¹ Qux column by column of Quxᵀ; kff = ½(−Quu)⁻¹qu; Σ_ctl = ½(−Quu)⁻¹.
#pragma unroll
  for (int col = 0; col < DX; ++col) {
    S b[DU], x[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) b[i] = QuxT[col][i];
    chol_solve(Ln, inv_dn, b, x);
#pragma unroll
    for (int i = 0; i < DU; ++i) K[i][col] = x[i];
  }
  {
    S x[DU];
    chol_solve(Ln, inv_dn, qu, x);
#pragma unroll
    for (int i = 0; i < DU; ++i) kff[i] = S(0.5) * x[i];
    S inv[DU][DU];
    chol_inv(Ln, inv_dn, inv);
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) sigc[i][j] = S(0.5) * inv[i][j];
  }

  {
    S QuxTK[DX][DX], Vn[DX][DX];
    mm(QuxT, K, QuxTK);
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DX; ++j) Vn[i][j] = na * (Qxx[i][j] + QuxTK[i][j]);
    sym(Vn, V);
  }
  {
    S Quxkff[DX];
    mv(QuxT, kff, Quxkff);
#pragma unroll
    for (int i = 0; i < DX; ++i) v[i] = na * (qx[i] + S(2) * Quxkff[i]);
  }
  const S logdet_m2Quu = S(DU * LOG_2) + logdet_from_chol(Ln);
  v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));
}

// Chunk k's rows into the stage `stage` (A, B, c, Σ_dyn) and the buffer
// `raw` (the rest), as producer thread tid: 16 bytes a copy where `vec`
// (N and every stream's address allow it), else an entry; lanes past N are
// not read.
template <typename S, int DX, int DU>
__device__ __forceinline__ void gps_copy_chunk(const GpsStreams<S>& in, S* stage, S* raw,
                                               int t_hi, int steps, int n0, int N, bool vec,
                                               int tid) {
  using L = GpsSlot<DX, DU>;
  constexpr int G = kGpsGroup, E = L::E, R = GpsRaw<DX, DU>::E;
  constexpr int P = 32 * GpsShape<S, DX, DU>::kProducers, VEC = 16 / sizeof(S),
                PIECES = G / VEC;
  constexpr int ROWS = L::COPIED + R;   // rows a step: copied, then raw
  if (vec) {
    for (int q = tid; q < steps * ROWS * PIECES; q += P) {
      const int piece = q % PIECES, se = q / PIECES, e = se % ROWS, s = se / ROWS;
      const int g = piece * VEC;
      if (n0 + g >= N) continue;
      S* dst = e < L::COPIED ? stage + (s * E + e) * G + g : raw + (s * R + e - L::COPIED) * G + g;
      cp_async16(dst, in.template row<DX, DU>(e, t_hi - s) + n0 + g);
    }
  } else {
    for (int q = tid; q < steps * ROWS * G; q += P) {
      const int g = q % G, se = q / G, e = se % ROWS, s = se / ROWS;
      if (n0 + g >= N) continue;
      S* dst = e < L::COPIED ? stage + (s * E + e) * G + g : raw + (s * R + e - L::COPIED) * G + g;
      cp_async_elem(dst, in.template row<DX, DU>(e, t_hi - s) + n0 + g);
    }
  }
}

// Block b takes instances kGpsGroup·b …; warp 0 is the consumer (lanes past
// kGpsGroup or past N idle).  The producers copy chunk k + 1 while they
// augment chunk k, and the consumer walks chunk k − 1 or k.
template <typename S, int DX, int DU>
__global__ void __launch_bounds__(GpsShape<S, DX, DU>::Roles::kThreads, 1) gps_backward_kernel(
    GpsStreams<S> in, const S* __restrict__ vT, const S* __restrict__ vvT,
    const S* __restrict__ v0T, S* __restrict__ K_out, S* __restrict__ kff_out,
    S* __restrict__ sigc_out, S* __restrict__ V0_out, S* __restrict__ vv0_out,
    S* __restrict__ c0_out, unsigned char* __restrict__ bad_out, int T, int N, bool vec) {
  using Sh = GpsShape<S, DX, DU>;
  constexpr int CH = Sh::kChunk, G = kGpsGroup, E = Sh::E, R = Sh::R, NS = kGpsStages;
  using Roles = typename Sh::Roles;
  constexpr int B = Roles::kBarrier;
  extern __shared__ __align__(16) unsigned char gps_smem[];
  S* ring = reinterpret_cast<S*>(gps_smem);
  S* raw = ring + NS * Sh::STAGE;   // two buffers of Sh::RAW
  const int n0 = blockIdx.x * G;
  const int chunks = (T + CH - 1) / CH;
  const size_t np = N;
  const int warp = threadIdx.x / 32;

  if (warp == 0) {
    const int g = threadIdx.x, n = n0 + g;
    const bool live = g < G && n < N;
    S V[DX][DX], v[DX], v0 = S(0);
    bool bad = false;
    if (live) {
      load(vT, 0, n, np, V);
      load(vvT, 0, n, np, v);
      v0 = v0T[n];
    }
    for (int k = 0; k < chunks; ++k) {
      int t_hi, steps;
      chunk_span<CH>(k, T, t_hi, steps);
      ring_acquire<B, NS>(k);
      if (live) {
        const S* stage = ring + (k % NS) * Sh::STAGE + g;
        for (int s = 0; s < steps; ++s) {
          S Kt[DU][DX], kff[DU], sigc[DU][DU];
          gps_chain_step<S, DX, DU>(stage + s * E * G, V, v, v0, bad, Kt, kff, sigc);
          const int t = t_hi - s;
          store(K_out, t, n, np, Kt);
          store(kff_out, t, n, np, kff);
          store(sigc_out, t, n, np, sigc);
        }
      }
      ring_release<B, NS>(k, chunks);
    }
    if (live) {
      store(V0_out, 0, n, np, V);
      store(vv0_out, 0, n, np, v);
      c0_out[n] = v0;
      bad_out[n] = bad ? 1 : 0;
    }
  } else {
    if (Roles::idle(warp)) return;
    constexpr int P = 32 * Sh::kProducers;
    const int tid = Roles::producer(warp) * 32 + threadIdx.x % 32;
    int t_hi, steps;
    chunk_span<CH>(0, T, t_hi, steps);
    ring_reserve<B, NS>(0);
    gps_copy_chunk<S, DX, DU>(in, ring, raw, t_hi, steps, n0, N, vec, tid);
    cp_async_commit();
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        int t_next, steps_next;
        chunk_span<CH>(k + 1, T, t_next, steps_next);
        if (k > 0) named_sync<P>(kGpsProducerBarrier);   // chunk k − 1's buffer is read
        ring_reserve<B, NS>(k + 1);
        gps_copy_chunk<S, DX, DU>(in, ring + ((k + 1) % NS) * Sh::STAGE,
                                  raw + ((k + 1) % 2) * Sh::RAW, t_next, steps_next, n0, N, vec,
                                  tid);
        cp_async_commit();
        cp_async_wait_but_newest();
      } else {
        cp_async_wait_all();
      }
      named_sync<P>(kGpsProducerBarrier);   // chunk k's copies have landed
      chunk_span<CH>(k, T, t_hi, steps);
      S* stage = ring + (k % NS) * Sh::STAGE;
      const S* buf = raw + (k % 2) * Sh::RAW;
      for (int q = tid; q < steps * G; q += P) {
        const int g = q % G, s = q / G;
        if (n0 + g < N) gps_augment<S, DX, DU>(buf + s * R * G + g, stage + s * E * G + g);
      }
      ring_publish<B, NS>(k);
    }
  }
}

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(32) gps_forward_kl_kernel(
    const S* __restrict__ A_s, const S* __restrict__ B_s, const S* __restrict__ c_s,
    const S* __restrict__ sigd_s, const S* __restrict__ K_s, const S* __restrict__ kff_s,
    const S* __restrict__ sigc_s, const S* __restrict__ Ko_s, const S* __restrict__ ko_s,
    const S* __restrict__ sigo_s, const S* __restrict__ mu0, const S* __restrict__ sig0,
    S* __restrict__ kl_out, S* __restrict__ muT_out, S* __restrict__ sigT_out, int T, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t np = N;

  S mu[DX], Sx[DX][DX];
  load(mu0, 0, n, np, mu);
  load(sig0, 0, n, np, Sx);
  S kl = S(0);

  for (int t = 0; t < T; ++t) {
    S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX];
    S K[DU][DX], kff[DU], sigc[DU][DU], Ko[DU][DX], ko[DU], sigo[DU][DU];
    load(A_s, t, n, np, A);
    load(B_s, t, n, np, B);
    load(c_s, t, n, np, c);
    load(sigd_s, t, n, np, sigd);
    load(K_s, t, n, np, K);
    load(kff_s, t, n, np, kff);
    load(sigc_s, t, n, np, sigc);
    load(Ko_s, t, n, np, Ko);
    load(ko_s, t, n, np, ko);
    load(sigo_s, t, n, np, sigo);

    // ---- per-step KL(new‖old) under N(μ, Σ) (gps/src/util.cpp:83-121) ---------
    S so[DU][DU], Lo[DU][DU], inv_do[DU], lam[DU][DU], sc[DU][DU], Lc[DU][DU], inv_dc[DU];
    sym(sigo, so);
    chol(so, Lo, inv_do);
    chol_inv(Lo, inv_do, lam);
    sym(sigc, sc);
    chol(sc, Lc, inv_dc);
    S dK[DU][DX], dk[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) dK[i][j] = Ko[i][j] - K[i][j];
      dk[i] = kff[i] - ko[i];
    }
    S lam_dK[DU][DX], diff_K[DX][DX], lam_dk[DU], diff_crs[DX], dKmu[DX];
    mm(lam, dK, lam_dK);
    mm_tn(dK, lam_dK, diff_K);
    mv(lam, dk, lam_dk);
    mv_tn(dK, lam_dk, diff_crs);
    mv(diff_K, mu, dKmu);
    const S kl_t = S(0.5) * (logdet_from_chol(Lo) - logdet_from_chol(Lc)) +
                   S(0.5) * trace_prod(lam, sigc) - S(0.5 * DU) +
                   S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -
                   dot(mu, diff_crs) + S(0.5) * dot(dk, lam_dk);
    kl = kl + kl_t;

    // ---- exact Gaussian propagation (gps/src/util.cpp:195-269) -----------------
    S mu_u[DU], KS[DU][DX], KSKt[DU][DU], sigma_u[DU][DU];
    mv(K, mu, mu_u);
#pragma unroll
    for (int i = 0; i < DU; ++i) mu_u[i] = mu_u[i] + kff[i];
    mm(K, Sx, KS);
    mm_nt(KS, K, KSKt);
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) sigma_u[i][j] = sigc[i][j] + KSKt[i][j];

    S Amu[DX], Bmu[DX];
    mv(A, mu, Amu);
    mv(B, mu_u, Bmu);
    S AS[DX][DX], ASAt[DX][DX], Acr[DX][DU], AcrBt[DX][DX], BSu[DX][DU], BSuBt[DX][DX];
    mm(A, Sx, AS);
    mm_nt(AS, A, ASAt);
    mm_nt(A, KS, Acr);  // A (Σ Kᵀ) = A (K Σ)ᵀ
    mm_nt(Acr, B, AcrBt);
    mm(B, sigma_u, BSu);
    mm_nt(BSu, B, BSuBt);
    S Sn[DX][DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      mu[i] = Amu[i] + Bmu[i] + c[i];
#pragma unroll
      for (int j = 0; j < DX; ++j)
        Sn[i][j] = sigd[i][j] + ASAt[i][j] + AcrBt[i][j] + AcrBt[j][i] + BSuBt[i][j];
    }
    sym(Sn, Sx);
  }
  kl_out[n] = kl;
#pragma unroll
  for (int i = 0; i < DX; ++i) muT_out[i * np + n] = mu[i];
  store(sigT_out, 0, n, np, Sx);
}

namespace {

constexpr int THREADS = 32;

template <typename S, int DX, int DU>
int launch_backward(const void* const* in, void* const* out, int T, int N, cudaStream_t s) {
  const S* const* p = reinterpret_cast<const S* const*>(in);
  const GpsStreams<S> streams{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9],
                              p[10], p[11], p[12], p[13], (size_t)N};
  bool vec = N % (16 / (int)sizeof(S)) == 0;
  for (int i = 0; i < 14; ++i) vec = vec && (size_t)in[i] % 16 == 0;
  using Sh = GpsShape<S, DX, DU>;
  return launch_ring(gps_backward_kernel<S, DX, DU>, dim3((N + kGpsGroup - 1) / kGpsGroup),
                     Sh::Roles::kThreads, Sh::BYTES, s, streams, p[14], p[15], p[16], (S*)out[0],
                     (S*)out[1], (S*)out[2], (S*)out[3], (S*)out[4], (S*)out[5],
                     (unsigned char*)out[6], T, N, vec);
}

template <typename S, int DX, int DU>
int launch_forward_kl(const void* const* in, void* const* out, int T, int N, cudaStream_t s) {
  const int blocks = (N + THREADS - 1) / THREADS;
  gps_forward_kl_kernel<S, DX, DU><<<blocks, THREADS, 0, s>>>(
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9],
      (const S*)in[10], (const S*)in[11], (S*)out[0], (S*)out[1], (S*)out[2], T, N);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void* const*, void* const*, int, int, cudaStream_t);

// The instantiated (dx, du): Pendulum and LQR (2, 1), Cartpole (4, 1), and
// the dual chain's benchmark shape (4, 2); float32 and float64 each.
template <bool Backward>
Launch pick(int dtype, int dx, int du) {
#define TRAJOPT_GPS_CASE(DX, DU)                                                   \
  if (dx == DX && du == DU) {                                                      \
    if (dtype == 0) return Backward ? launch_backward<float, DX, DU>               \
                                    : launch_forward_kl<float, DX, DU>;            \
    if (dtype == 1) return Backward ? launch_backward<double, DX, DU>              \
                                    : launch_forward_kl<double, DX, DU>;           \
  }
  TRAJOPT_GPS_CASE(2, 1)
  TRAJOPT_GPS_CASE(4, 1)
  TRAJOPT_GPS_CASE(4, 2)
#undef TRAJOPT_GPS_CASE
  return nullptr;
}

}  // namespace

// C entry points.  dtype: 0 float32, 1 float64.  Each returns the CUDA error
// of its launch, or -1 when no kernel is instantiated for (dtype, dx, du).
extern "C" int trajopt_gps_backward(
    int dtype, int dx, int du, const void* cxx, const void* cx, const void* cuu,
    const void* cu, const void* cxu, const void* c0, const void* A, const void* B,
    const void* c, const void* sigd, const void* Ko, const void* ko, const void* sigo,
    const void* alpha, const void* vT, const void* vvT, const void* v0T, void* K, void* kff,
    void* sigc, void* V0, void* vv0, void* c0_out, void* bad, int T, int N, void* stream) {
  const Launch f = pick<true>(dtype, dx, du);
  if (f == nullptr) return -1;
  const void* in[17] = {cxx, cx, cuu, cu, cxu, c0, A, B, c, sigd, Ko, ko, sigo, alpha,
                        vT, vvT, v0T};
  void* out[7] = {K, kff, sigc, V0, vv0, c0_out, bad};
  return f(in, out, T, N, (cudaStream_t)stream);
}

extern "C" int trajopt_gps_forward_kl(
    int dtype, int dx, int du, const void* A, const void* B, const void* c,
    const void* sigd, const void* K, const void* kff, const void* sigc, const void* Ko,
    const void* ko, const void* sigo, const void* mu0, const void* sig0, void* kl,
    void* muT, void* sigT, int T, int N, void* stream) {
  const Launch f = pick<false>(dtype, dx, du);
  if (f == nullptr) return -1;
  const void* in[12] = {A, B, c, sigd, K, kff, sigc, Ko, ko, sigo, mu0, sig0};
  void* out[3] = {kl, muT, sigT};
  return f(in, out, T, N, (cudaStream_t)stream);
}
