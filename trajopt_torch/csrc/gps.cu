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
// the floor only when each step's latency is hidden.  Their first design ran
// one thread per instance in one-warp blocks (at N=4096, one warp an SM):
// K6 took 2,560 cycles a step at 2/1, half of it waiting on the step's 28
// loads from device memory and most of the rest on the KL augmentation and
// −1/α, which do not depend on the value carry at all; K7 2,020–2,150, of
// which the loads 1,040–1,150, the factors of Σ_old and Σ_ctl and the KL's
// terms that do not read (μ_t, Σ_t) another 680 (PERF.md).
//
// The design of both: the chain alone on the consumer (staged_walk.cuh, the
// block body they share with K8).  A block takes kGpsGroup (32) instances;
// warp 0 is the consumer, one lane per instance, and does only what depends
// on the carry, every operand read from shared memory; producer warps (12
// in float, 16 for K7 at 2/1, 6 in double) fill a ring of kGpsStages (3)
// stages, a chunk of steps each, copying chunk k + 1's rows with cp.async
// while they compute chunk k's carry-free part into its stage.  A chunk is
// 16 steps where the ring and the producers' buffers fit a block's shared
// memory, else 8, 4 or 2; at N=4096, 128 blocks take one SM each.
//   K6 walks t = T−1 … 0 with (V, v, v0, flag): V·A, V·B, V·c, the Q blocks,
// the factor of −Quu with PivotOps' root and reciprocal (pivot.cuh: sqrtf's
// and 1/d's bits without the slow-path branch), K, kff, Σ_ctl, the value
// update.  Its producers copy A, B, c and Σ_dyn into the stage and the cost,
// the old policy and α into their buffer, and augment: Σ_old's factor,
// Λ_old, log det Σ_old, the augmented cost blocks, −1/α and −α.  Chunks:
// float32 4/2 4 steps, float64 4/2 2.
//   K7 walks t = 0 … T−1 with (μ, Σ, the KL sum): the three KL terms that
// read (μ_t, Σ_t), ½tr(diff_K Σ), ½μᵀdiff_Kμ and μᵀdiff_crs, and the
// propagation, which is products and sums only.  Its producers copy A, B,
// c, Σ_dyn and the new controller into the stage and the old policy into
// their buffer, and compute the rest of the step's KL: the factors of Σ_old
// and Σ_ctl (PivotOps' roots and reciprocals, the library's bits), Λ_old,
// both log-determinants, tr(Λ_old Σ_ctl), dK, dk, diff_K = dKᵀΛ_old dK,
// diff_crs = dKᵀΛ_old dk, the head h and the tail g, which the consumer adds
// in the first design's order.  Chunks: float32 4/2 4 steps, float64 4/2 2.
// The operations and their order are the first designs', so every output is
// the same to the bit.  What bounds them now: the consumer's step (issued
// in order by one warp) and the first chunk's copies before the walk can
// start (PERF.md).
//
// Operands are structure of arrays (T, entries, N) with instances
// contiguous, so a warp's loads of one entry coalesce; K6 writes (K, kff,
// Σ_ctl) in exactly the layout K7 reads, so nothing is relaid between the
// two launches.  Sums run in the TPU kernels' order and the build uses
// -fmad=false, so the float64 build equals the plain PyTorch versions
// (core/cuda_gps.py) to rounding.
#include <cuda_runtime.h>

#include "bwd_step.cuh"
#include "staged_walk.cuh"

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

// ---- K6 and K7 on the staged walk (staged_walk.cuh) ------------------------------

constexpr int kGpsGroup = 32;       // instances a block, one consumer lane each
constexpr int kGpsStages = 3;       // stages of the ring
constexpr int kGpsBudget = 227 * 1024;   // shared memory a block (N=4096: 128 blocks)
// Producer warps: in float as many as keep the consumer fed; in double
// fewer, so that a thread keeps the registers its wider step needs.
constexpr int kGpsProducersFloat = 12, kGpsProducersDouble = 6;

// K6's step slot in a stage, what the chain reads: A, B, c and Σ_dyn as the
// streams hold them, then what the producers compute off the chain (the
// augmented cost blocks, −1/α, −α and Σ_old's flag).
template <int DX, int DU>
struct GpsSlot {
  static constexpr int A = 0, B = A + DX * DX, C = B + DX * DU, SIGD = C + DX,
                       CXX = SIGD + DX * DX, CXU = CXX + DX * DX, CX = CXU + DX * DU,
                       CUU = CX + DX, CU = CUU + DU * DU, C0 = CU + DU, NIA = C0 + 1,
                       NA = NIA + 1, BAD = NA + 1, E = BAD + 1;
  static constexpr int COPIED = CXX;   // entries copied straight from the streams
};

// K6's step slot in the producers' own buffers: the streams the augmentation
// reads, laid out as a stage.
template <int DX, int DU>
struct GpsRaw {
  static constexpr int CXX = 0, CX = CXX + DX * DX, CUU = CX + DX, CU = CUU + DU * DU,
                       CXU = CU + DU, C0 = CXU + DX * DU, KO = C0 + 1, KOF = KO + DU * DX,
                       SIGO = KOF + DU, ALPHA = SIGO + DU * DU, E = ALPHA + 1;
};

// The shape of a GPS walk with step slots of E entries and raw slots of R:
// 32 instances, three stages, P_ producer warps (by default by dtype), and
// the chunk (steps a stage) of 16 steps where the ring and the buffers fit
// the budget, else 8, 4 or 2.
template <typename S, int E_, int R_, int P_ = sizeof(S) == 4 ? kGpsProducersFloat
                                                                : kGpsProducersDouble>
struct GpsWalk {
  using Scalar = S;
  static constexpr int kGroup = kGpsGroup, kStages = kGpsStages, E = E_, R = R_;
  static constexpr int kProducers = P_;
  static constexpr int kChunk = walk_chunk<S, kGpsGroup, kGpsStages, E_, R_>(kGpsBudget);
  static constexpr bool kAugments = true;
};

// The carry-free part of a K6 step (gps/src/util.cpp:136-193), on a producer
// thread: Σ_old's guarded Cholesky, Λ_old, log det Σ_old, the old policy's
// products and the augmented cost blocks, −1/α and −α, from the raw slot
// `raw` into the stage slot `op`.  The factor's root and reciprocal and the
// quotient −1/α are PivotOps' (the library's bits, without its slow-path
// branches).
template <typename S, int DX, int DU>
__device__ __forceinline__ void gps_augment(const S* raw, S* op) {
  using L = GpsSlot<DX, DU>;
  using W = GpsRaw<DX, DU>;
  constexpr int G = kGpsGroup;
  S Cxx[DX][DX], cx_t[DX], Cuu[DU][DU], cu_t[DU], Cxu[DX][DU], Ko[DU][DX], ko[DU], sigo[DU][DU];
  slot_get<G>(raw, W::CXX, Cxx);
  slot_get<G>(raw, W::CX, cx_t);
  slot_get<G>(raw, W::CUU, Cuu);
  slot_get<G>(raw, W::CU, cu_t);
  slot_get<G>(raw, W::CXU, Cxu);
  slot_get<G>(raw, W::KO, Ko);
  slot_get<G>(raw, W::KOF, ko);
  slot_get<G>(raw, W::SIGO, sigo);
  const S c0 = raw[W::C0 * G], a = raw[W::ALPHA * G];

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
  slot_put<G>(op, L::CXX, agCxx);
  slot_put<G>(op, L::CXU, agCxu);
  slot_put<G>(op, L::CX, agcx);
  slot_put<G>(op, L::CUU, agCuu);
  slot_put<G>(op, L::CU, agcu);
  op[L::C0 * G] = c0 + ha * (S(DU * LOG_2PI) + logdet_sigo) + ha * dot(ko, lamko);
  op[L::NIA * G] = PivotOps::div(S(-1), a);
  op[L::NA * G] = -a;
  op[L::BAD * G] = bad_o ? S(1) : S(0);
}

// The carry-dependent part of a K6 step (gps/src/util.cpp:272-374), on the
// consumer lane: the −1/α-scaled soft-Riccati step from the staged slot
// `op`, the pivots of −Quu through PivotOps; updates (V, v, v0, bad) and
// gives the step's (K, kff, Σ_ctl).
template <typename S, int DX, int DU>
__device__ __forceinline__ void gps_chain_step(const S* op, S (&V)[DX][DX], S (&v)[DX], S& v0,
                                               bool& bad, S (&K)[DU][DX], S (&kff)[DU],
                                               S (&sigc)[DU][DU]) {
  using L = GpsSlot<DX, DU>;
  constexpr int G = kGpsGroup;
  S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX];
  S agCxx[DX][DX], agCxu[DX][DU], agcx[DX], agCuu[DU][DU], agcu[DU];
  slot_get<G>(op, L::A, A);
  slot_get<G>(op, L::B, B);
  slot_get<G>(op, L::C, c);
  slot_get<G>(op, L::SIGD, sigd);
  slot_get<G>(op, L::CXX, agCxx);
  slot_get<G>(op, L::CXU, agCxu);
  slot_get<G>(op, L::CX, agcx);
  slot_get<G>(op, L::CUU, agCuu);
  slot_get<G>(op, L::CU, agcu);
  const S agc0 = op[L::C0 * G], nia = op[L::NIA * G], na = op[L::NA * G];
  const bool bad_o = op[L::BAD * G] != S(0);

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

// K6 as a walk backward in time: copies A, B, c and Σ_dyn into the stage and
// the cost, the old policy and α into the producers' buffers; the consumer
// runs gps_chain_step and writes each step's controller, then V₀, v₀, c₀ and
// the flag.
template <typename S, int DX, int DU>
struct GpsBackward : GpsWalk<S, GpsSlot<DX, DU>::E, GpsRaw<DX, DU>::E> {
  static constexpr bool kForward = false;
  static constexpr int COPIED = GpsSlot<DX, DU>::COPIED;
  const S *cxx, *cx, *cuu, *cu, *cxu, *c0, *A, *B, *c, *sigd, *Ko, *ko, *sigo, *alpha;
  const S *vT, *vvT, *v0T;
  S *K_out, *kff_out, *sigc_out, *V0_out, *vv0_out, *c0_out;
  unsigned char* bad_out;
  size_t np;

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
  __device__ __forceinline__ void augment(const S* raw, S* op) const {
    gps_augment<S, DX, DU>(raw, op);
  }

  struct Carry {
    S V[DX][DX], v[DX], v0;
    bool bad;
  };
  __device__ __forceinline__ void begin(Carry& k, int n) const {
    load(vT, 0, n, np, k.V);
    load(vvT, 0, n, np, k.v);
    k.v0 = v0T[n];
    k.bad = false;
  }
  __device__ __forceinline__ void step(const S* op, Carry& k, int t, int n) const {
    S Kt[DU][DX], kff[DU], sigc[DU][DU];
    gps_chain_step<S, DX, DU>(op, k.V, k.v, k.v0, k.bad, Kt, kff, sigc);
    store(K_out, t, n, np, Kt);
    store(kff_out, t, n, np, kff);
    store(sigc_out, t, n, np, sigc);
  }
  __device__ __forceinline__ void finish(const Carry& k, int n) const {
    store(V0_out, 0, n, np, k.V);
    store(vv0_out, 0, n, np, k.v);
    c0_out[n] = k.v0;
    bad_out[n] = k.bad ? 1 : 0;
  }
};

// K7's step slot in a stage: A, B, c, Σ_dyn and the new controller (K, kff,
// Σ_ctl) as the streams hold them, then the KL's carry-free part that the
// producers compute: diff_K = dKᵀΛ_old dK, diff_crs = dKᵀΛ_old dk, the head
// h = (½(log det Σ_old − log det Σ_ctl) + ½tr(Λ_old Σ_ctl)) − ½du and the
// tail g = ½dkᵀΛ_old dk (dK = K_old − K, dk = kff − kff_old).
template <int DX, int DU>
struct KlSlot {
  static constexpr int A = 0, B = A + DX * DX, C = B + DX * DU, SIGD = C + DX,
                       K = SIGD + DX * DX, KFF = K + DU * DX, SIGC = KFF + DU,
                       COPIED = SIGC + DU * DU, DIFFK = COPIED, DIFFCRS = DIFFK + DX * DX,
                       H = DIFFCRS + DX, TAIL = H + 1, E = TAIL + 1;
};

// K7's step slot in the producers' own buffers: the old policy.
template <int DX, int DU>
struct KlRaw {
  static constexpr int KO = 0, KOF = KO + DU * DX, SIGO = KOF + DU, E = SIGO + DU * DU;
};

// K7 as a walk forward in time.  Producers: the factors of Σ_old and Σ_ctl
// and every term of the step's KL(new‖old) (gps/src/util.cpp:83-121) that
// does not read (μ_t, Σ_t).  Consumer: the three terms that do, summed in
// the order of the first design, kl_t = (((h + ½tr(diff_K Σ)) + ½μᵀdiff_Kμ)
// − μᵀdiff_crs) + g, and the exact propagation of (μ, Σ)
// (gps/src/util.cpp:195-269), so every output keeps its bits.
// At 2/1 in float its producers are 16 warps, which keep its short consumer
// step fed (0.0208 against 0.0227 ms with 12; at 4/2 16 read slower).
template <typename S, int DX, int DU>
struct GpsForwardKl
    : GpsWalk<S, KlSlot<DX, DU>::E, KlRaw<DX, DU>::E,
              sizeof(S) == 4 ? (DX == 2 ? 16 : kGpsProducersFloat) : kGpsProducersDouble> {
  static constexpr bool kForward = true;
  static constexpr int COPIED = KlSlot<DX, DU>::COPIED;
  const S *A, *B, *c, *sigd, *K, *kff, *sigc, *Ko, *ko, *sigo, *mu0, *sig0;
  S *kl_out, *muT_out, *sigT_out;
  size_t np;

  __device__ __forceinline__ const S* row(int e, size_t t) const {
    using L = KlSlot<DX, DU>;
    using W = KlRaw<DX, DU>;
    if (e < L::B) return A + (t * DX * DX + e) * np;
    if (e < L::C) return B + (t * DX * DU + e - L::B) * np;
    if (e < L::SIGD) return c + (t * DX + e - L::C) * np;
    if (e < L::K) return sigd + (t * DX * DX + e - L::SIGD) * np;
    if (e < L::KFF) return K + (t * DU * DX + e - L::K) * np;
    if (e < L::SIGC) return kff + (t * DU + e - L::KFF) * np;
    if (e < L::COPIED) return sigc + (t * DU * DU + e - L::SIGC) * np;
    e -= L::COPIED;
    if (e < W::KOF) return Ko + (t * DU * DX + e) * np;
    if (e < W::SIGO) return ko + (t * DU + e - W::KOF) * np;
    return sigo + (t * DU * DU + e - W::SIGO) * np;
  }

  __device__ __forceinline__ void augment(const S* raw, S* op) const {
    using L = KlSlot<DX, DU>;
    using W = KlRaw<DX, DU>;
    constexpr int G = kGpsGroup;
    S Kn[DU][DX], kn[DU], sc_[DU][DU], Ko_[DU][DX], ko_[DU], so_[DU][DU];
    slot_get<G>(op, L::K, Kn);
    slot_get<G>(op, L::KFF, kn);
    slot_get<G>(op, L::SIGC, sc_);
    slot_get<G>(raw, W::KO, Ko_);
    slot_get<G>(raw, W::KOF, ko_);
    slot_get<G>(raw, W::SIGO, so_);
    S so[DU][DU], Lo[DU][DU], inv_do[DU], lam[DU][DU], sc[DU][DU], Lc[DU][DU], inv_dc[DU];
    sym(so_, so);
    chol<S, DU, true>(so, Lo, inv_do);
    chol_inv(Lo, inv_do, lam);
    sym(sc_, sc);
    chol<S, DU, true>(sc, Lc, inv_dc);
    S dK[DU][DX], dk[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) dK[i][j] = Ko_[i][j] - Kn[i][j];
      dk[i] = kn[i] - ko_[i];
    }
    S lam_dK[DU][DX], diff_K[DX][DX], lam_dk[DU], diff_crs[DX];
    mm(lam, dK, lam_dK);
    mm_tn(dK, lam_dK, diff_K);
    mv(lam, dk, lam_dk);
    mv_tn(dK, lam_dk, diff_crs);
    slot_put<G>(op, L::DIFFK, diff_K);
    slot_put<G>(op, L::DIFFCRS, diff_crs);
    op[L::H * G] = S(0.5) * (logdet_from_chol(Lo) - logdet_from_chol(Lc)) +
                   S(0.5) * trace_prod(lam, sc_) - S(0.5 * DU);
    op[L::TAIL * G] = S(0.5) * dot(dk, lam_dk);
  }

  struct Carry {
    S mu[DX], Sx[DX][DX], kl;
  };
  __device__ __forceinline__ void begin(Carry& k, int n) const {
    load(mu0, 0, n, np, k.mu);
    load(sig0, 0, n, np, k.Sx);
    k.kl = S(0);
  }
  __device__ __forceinline__ void step(const S* op, Carry& k, int, int) const {
    using L = KlSlot<DX, DU>;
    constexpr int G = kGpsGroup;
    S A_[DX][DX], B_[DX][DU], c_[DX], sigd_[DX][DX], Kt[DU][DX], kt[DU], sc[DU][DU];
    S diff_K[DX][DX], diff_crs[DX];
    slot_get<G>(op, L::A, A_);
    slot_get<G>(op, L::B, B_);
    slot_get<G>(op, L::C, c_);
    slot_get<G>(op, L::SIGD, sigd_);
    slot_get<G>(op, L::K, Kt);
    slot_get<G>(op, L::KFF, kt);
    slot_get<G>(op, L::SIGC, sc);
    slot_get<G>(op, L::DIFFK, diff_K);
    slot_get<G>(op, L::DIFFCRS, diff_crs);
    const S h = op[L::H * G], tail = op[L::TAIL * G];
    S (&mu)[DX] = k.mu;
    S (&Sx)[DX][DX] = k.Sx;

    // ---- the KL terms that read (μ_t, Σ_t) ----------------------------------------
    S dKmu[DX];
    mv(diff_K, mu, dKmu);
    const S kl_t = h + S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -
                   dot(mu, diff_crs) + tail;
    k.kl = k.kl + kl_t;

    // ---- exact Gaussian propagation (gps/src/util.cpp:195-269) -----------------
    S mu_u[DU], KS[DU][DX], KSKt[DU][DU], sigma_u[DU][DU];
    mv(Kt, mu, mu_u);
#pragma unroll
    for (int i = 0; i < DU; ++i) mu_u[i] = mu_u[i] + kt[i];
    mm(Kt, Sx, KS);
    mm_nt(KS, Kt, KSKt);
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) sigma_u[i][j] = sc[i][j] + KSKt[i][j];

    S Amu[DX], Bmu[DX];
    mv(A_, mu, Amu);
    mv(B_, mu_u, Bmu);
    S AS[DX][DX], ASAt[DX][DX], Acr[DX][DU], AcrBt[DX][DX], BSu[DX][DU], BSuBt[DX][DX];
    mm(A_, Sx, AS);
    mm_nt(AS, A_, ASAt);
    mm_nt(A_, KS, Acr);  // A (Σ Kᵀ) = A (K Σ)ᵀ
    mm_nt(Acr, B_, AcrBt);
    mm(B_, sigma_u, BSu);
    mm_nt(BSu, B_, BSuBt);
    S Sn[DX][DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      mu[i] = Amu[i] + Bmu[i] + c_[i];
#pragma unroll
      for (int j = 0; j < DX; ++j)
        Sn[i][j] = sigd_[i][j] + ASAt[i][j] + AcrBt[i][j] + AcrBt[j][i] + BSuBt[i][j];
    }
    sym(Sn, Sx);
  }
  __device__ __forceinline__ void finish(const Carry& k, int n) const {
    kl_out[n] = k.kl;
#pragma unroll
    for (int i = 0; i < DX; ++i) muT_out[i * np + n] = k.mu[i];
    store(sigT_out, 0, n, np, k.Sx);
  }
};

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(WalkShape<GpsBackward<S, DX, DU>>::Roles::kThreads, 1)
    gps_backward_kernel(GpsBackward<S, DX, DU> w, int T, int N, bool vec) {
  staged_walk(w, T, N, vec);
}

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(WalkShape<GpsForwardKl<S, DX, DU>>::Roles::kThreads, 1)
    gps_forward_kl_kernel(GpsForwardKl<S, DX, DU> w, int T, int N, bool vec) {
  staged_walk(w, T, N, vec);
}

namespace {

// 16-byte copies where N is a whole number of them and every stream is
// 16-byte aligned.
bool vectorized(const void* const* in, int streams, int N, int bytes) {
  bool vec = N % (16 / bytes) == 0;
  for (int i = 0; i < streams; ++i) vec = vec && (size_t)in[i] % 16 == 0;
  return vec;
}

template <typename S, int DX, int DU>
int launch_backward(const void* const* in, void* const* out, int T, int N, cudaStream_t s) {
  const S* const* p = reinterpret_cast<const S* const*>(in);
  const GpsBackward<S, DX, DU> w{
      {}, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], p[12], p[13],
      p[14], p[15], p[16], (S*)out[0], (S*)out[1], (S*)out[2], (S*)out[3], (S*)out[4],
      (S*)out[5], (unsigned char*)out[6], (size_t)N};
  return launch_walk(gps_backward_kernel<S, DX, DU>, w, T, N, vectorized(in, 14, N, sizeof(S)), s);
}

template <typename S, int DX, int DU>
int launch_forward_kl(const void* const* in, void* const* out, int T, int N, cudaStream_t s) {
  const S* const* p = reinterpret_cast<const S* const*>(in);
  const GpsForwardKl<S, DX, DU> w{
      {}, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11],
      (S*)out[0], (S*)out[1], (S*)out[2], (size_t)N};
  return launch_walk(gps_forward_kl_kernel<S, DX, DU>, w, T, N, vectorized(in, 10, N, sizeof(S)),
                     s);
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
