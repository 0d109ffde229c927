// K8: the batched belief-value backward of BSP-iLQR.
//
// Replaces trajopt_tpu/core/pallas_belief.py::_belief_kernel (wrapper
// pallas_bsp_backward).  For every problem instance it runs the (S, s, τ)
// recursion of core/belief.bsp_backward backward in time: the μ-quadratic
// value S, the μ-linear s and the vec(Σ)-linear τ (with the τ-index fix: the
// step contracts the next step's τ), per-instance λ with reg ∈ {1, 2}
// (λ on the action Hessian, or on the value Hessian), the expected
// improvement dS and the TPU kernel's guarded Cholesky (a pivot that is not
// positive or not finite becomes 1 and flags the instance).
//
// What bounds it on the H100: each instance is a chain of T dependent steps
// of small-matrix algebra.  At b = 2, a = 2 a step reads 92 scalars and
// writes 16; at b = 4 it reads 778, most of them the b²×b² blocks Y and U,
// and writes 46.  Its first design ran one thread per instance with the
// carry in registers and read every operand from device memory inside the
// walk: 7,100–7,500 cycles a step at (2, 2), 5,000 of them in the channels
// whose b²-row blocks it read inside their products, and 72,000 at (4, 2),
// where it spilled 4–6 KB a thread (PERF.md).
//
// Design: the staged walk of K6 and K7 (staged_walk.cuh), walking t = T−1
// … 0.  Warp 0 is the consumer, one lane per instance, with the carry (S, s,
// τ, dS, flag) in registers; it reads every operand of a step from shared
// memory and reads no stream from device memory inside the walk.  The
// producers only copy the step rows of the next chunk (cp.async) into the
// ring: every operation of a step reads the carry or the factor of D_reg,
// so nothing can leave the chain without changing the bits.  The walk and
// not staged_backward (bwd_step.cuh), because the walk runs any N with
// masked lanes and sizes its group, producers, stages and chunk per
// (b, a, dtype) (BspBackward below).  The b²-row blocks X, Y, Z, T, U, V only ever meet a
// vector from the left (Xᵀ·vec S, Uᵀ·τ, ...), so they are read entry by
// entry inside those products and never held whole in registers.  Sums run
// in the TPU kernel's order and the build uses -fmad=false, so the float64
// build equals the plain PyTorch version (core/cuda_belief.py) to rounding
// and every output keeps the first design's bits; the factor's pivots take
// PivotOps' root and reciprocal (pivot.cuh: the library's bits without its
// slow-path branches).
#include <cuda_runtime.h>

#include "bwd_step.cuh"
#include "staged_walk.cuh"

namespace {

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

// y = Mᵀ x for the (R, C) block at entry `at` of a stage slot (lane stride
// G), read entry by entry.
template <int G, typename S, int R, int C>
__device__ __forceinline__ void mv_tn_slot(const S* op, int at, const S (&x)[R], S (&y)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    S s = op[(at + i) * G] * x[0];
#pragma unroll
    for (int l = 1; l < R; ++l) s = s + op[(at + l * C + i) * G] * x[l];
    y[i] = s;
  }
}

}  // namespace

// A step's slot in a stage: the 14 streams in the order of the C entry
// point (Q, q, R, r, P, p, F, G, X, Y, Z, T, U, V).
template <int B, int A>
struct BspSlot {
  static constexpr int BB = B * B;
  static constexpr int Q = 0, QV = Q + B * B, R = QV + B, RV = R + A * A, P = RV + A,
                       PV = P + B * A, F = PV + BB, G = F + B * B, X = G + B * A, Y = X + BB * B,
                       Z = Y + BB * BB, T = Z + BB * A, U = T + BB * B, V = U + BB * BB,
                       E = V + BB * A;
  // the entries of each stream a step, in the slot's order
  __host__ __device__ static constexpr int size(int i) {
    constexpr int sizes[14] = {B * B, B, A * A, A, B * A, BB, B * B, B * A,
                               BB * B, BB * BB, BB * A, BB * B, BB * BB, BB * A};
    return sizes[i];
  }
};

// K8 as a walk backward in time (staged_walk.cuh).  The producers only copy:
// every operation of a step reads the carry (S, s, τ) or the factor of
// D_reg, which does, so nothing can leave the chain without changing the
// bits.  Its shape (tools/chip_ab/variants.py, PERF.md): at b = 2, 32
// instances a block, 12 producer warps in float (6 in double, whose
// consumer needs 162 registers) and four stages of a chunk sized to a
// block's shared memory (float: 4 steps, double: 2); a step at b = 4 is 778
// entries, so there 16 instances a block, 4 producer warps and two stages
// of one step (float: 99.6 KB, two blocks an SM; double: 199 KB).
template <typename S, int B, int A>
struct BspBackward {
  using Scalar = S;
  using L = BspSlot<B, A>;
  static constexpr int BB = B * B;
  static constexpr int E = L::E, R = 0, COPIED = L::E;
  static constexpr bool kWide = B > 2;   // 778 entries a step
  static constexpr int kGroup = kWide ? 16 : 32;
  static constexpr int kStages = kWide ? 2 : 4;
  static constexpr int kProducers = kWide ? 4 : sizeof(S) == 4 ? 12 : 6;
  // float (4, 2): two blocks an SM (99.6 KB each)
  static constexpr int kBudget = (kWide && sizeof(S) == 4 ? 113 : 227) * 1024;
  static constexpr int kChunk = walk_chunk<S, kGroup, kStages, E, 0>(kBudget);
  static constexpr bool kForward = false, kAugments = false;
  const S* streams[14];
  const S *QT, *qT, *pT, *lam_s;
  S *K_out, *kff_out, *S_out, *s_out, *tau_out, *ds_out;
  unsigned char* bad_out;
  size_t np;
  int reg;

  __device__ __forceinline__ const S* row(int e, size_t t) const {
    const S* p = streams[0];
    int at = 0, size = L::size(0);
#pragma unroll
    for (int j = 1; j < 14; ++j)
      if (e >= at + size) {
        at += size;
        size = L::size(j);
        p = streams[j];
      }
    return p + (t * size + e - at) * np;
  }

  struct Carry {
    S Sv[B][B], sv[B], tau[BB], ds0, ds1, lam;
    bool bad;
  };
  __device__ __forceinline__ void begin(Carry& k, int n) const {
    k.lam = lam_s[n];
    load(QT, 0, n, np, k.Sv);
    load(qT, 0, n, np, k.sv);
    load(pT, 0, n, np, k.tau);
    k.ds0 = S(0);
    k.ds1 = S(0);
    k.bad = false;
  }
  __device__ __forceinline__ void finish(const Carry& k, int n) const {
    ds_out[n] = k.ds0;
    ds_out[np + n] = k.ds1;
    bad_out[n] = k.bad ? 1 : 0;
  }

  // Step t of the (S, s, τ) recursion from the staged slot `op`.
  __device__ __forceinline__ void step(const S* op, Carry& k, int t, int n) const {
    constexpr int Gr = kGroup;
    S (&Sv)[B][B] = k.Sv;
    S (&sv)[B] = k.sv;
    S (&tau)[BB] = k.tau;
    const S lam = k.lam;
    S Q[B][B], q[B], R_[A][A], r[A], P[B][A], F[B][B], G[B][A];
    slot_get<Gr>(op, L::Q, Q);
    slot_get<Gr>(op, L::QV, q);
    slot_get<Gr>(op, L::R, R_);
    slot_get<Gr>(op, L::RV, r);
    slot_get<Gr>(op, L::P, P);
    slot_get<Gr>(op, L::F, F);
    slot_get<Gr>(op, L::G, G);

    S SF[B][B], SG[B][A], C[B][B], D[A][A], ET[B][A];
    mm(Sv, F, SF);
    mm(Sv, G, SG);
    {
      S FtSF[B][B], GtSG[A][A], FtSG[B][A];
      mm_tn(F, SF, FtSF);
      mm_tn(G, SG, GtSG);
      mm_tn(F, SG, FtSG);
#pragma unroll
      for (int i = 0; i < B; ++i) {
#pragma unroll
        for (int j = 0; j < B; ++j) C[i][j] = Q[i][j] + FtSF[i][j];
#pragma unroll
        for (int j = 0; j < A; ++j) ET[i][j] = P[i][j] + FtSG[i][j];
      }
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) D[i][j] = R_[i][j] + GtSG[i][j];
    }

    // c = q + Fᵀs + Tᵀτ + ½Xᵀ vec S;  d = r + Gᵀs + Vᵀτ + ½Zᵀ vec S;
    // e = p + Uᵀτ + ½Yᵀ vec S  (vec S in C order).
    S vecS[BB];
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j) vecS[i * B + j] = Sv[i][j];
    S c[B], d[A], e[BB];
    {
      S Fs_[B], Tt[B], Xv[B];
      mv_tn(F, sv, Fs_);
      mv_tn_slot<Gr, S, BB, B>(op, L::T, tau, Tt);
      mv_tn_slot<Gr, S, BB, B>(op, L::X, vecS, Xv);
#pragma unroll
      for (int i = 0; i < B; ++i) c[i] = q[i] + Fs_[i] + Tt[i] + S(0.5) * Xv[i];
    }
    {
      S Gs_[A], Vt[A], Zv[A];
      mv_tn(G, sv, Gs_);
      mv_tn_slot<Gr, S, BB, A>(op, L::V, tau, Vt);
      mv_tn_slot<Gr, S, BB, A>(op, L::Z, vecS, Zv);
#pragma unroll
      for (int i = 0; i < A; ++i) d[i] = r[i] + Gs_[i] + Vt[i] + S(0.5) * Zv[i];
    }
    {
      S p[BB], Ut[BB], Yv[BB];
      slot_get<Gr>(op, L::PV, p);
      mv_tn_slot<Gr, S, BB, BB>(op, L::U, tau, Ut);
      mv_tn_slot<Gr, S, BB, BB>(op, L::Y, vecS, Yv);
#pragma unroll
      for (int i = 0; i < BB; ++i) e[i] = p[i] + Ut[i] + S(0.5) * Yv[i];
    }

    // λ on the value Hessian (S + λI gives SG + λG) or on the action Hessian.
    S D_reg[A][A], E_reg[A][B];
    if (reg == 2) {
      S SG_r[B][A], GtSGr[A][A], FtSGr[B][A];
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) SG_r[i][j] = SG[i][j] + lam * G[i][j];
      mm_tn(G, SG_r, GtSGr);
      mm_tn(F, SG_r, FtSGr);
#pragma unroll
      for (int i = 0; i < A; ++i) {
#pragma unroll
        for (int j = 0; j < A; ++j) D_reg[i][j] = R_[i][j] + GtSGr[i][j];
#pragma unroll
        for (int j = 0; j < B; ++j) E_reg[i][j] = P[j][i] + FtSGr[j][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < A; ++i) {
#pragma unroll
        for (int j = 0; j < A; ++j) D_reg[i][j] = i == j ? D[i][j] + lam : D[i][j];
#pragma unroll
        for (int j = 0; j < B; ++j) E_reg[i][j] = ET[j][i];
      }
    }

    S Ds[A][A], Lf[A][A], inv_d[A];
    sym(D_reg, Ds);
    k.bad = chol<S, A, true>(Ds, Lf, inv_d) || k.bad;

    S K[A][B], kff[A];
#pragma unroll
    for (int col = 0; col < B; ++col) {
      S bcol[A], x[A];
#pragma unroll
      for (int i = 0; i < A; ++i) bcol[i] = E_reg[i][col];
      chol_solve(Lf, inv_d, bcol, x);
#pragma unroll
      for (int i = 0; i < A; ++i) K[i][col] = -x[i];
    }
    {
      S x[A];
      chol_solve(Lf, inv_d, d, x);
#pragma unroll
      for (int i = 0; i < A; ++i) kff[i] = -x[i];
    }

    S D_kff[A];
    mv(D, kff, D_kff);
    k.ds0 = k.ds0 + dot(kff, d);
    k.ds1 = k.ds1 + S(0.5) * dot(kff, D_kff);

#pragma unroll
    for (int i = 0; i < BB; ++i) tau[i] = e[i];
    {
      S KtDk[B], Ktd[B], Etk[B];
      mv_tn(K, D_kff, KtDk);
      mv_tn(K, d, Ktd);
      // Eᵀ kff with E = ETᵀ: (Eᵀ kff)_i = Σ_l ET[i][l] kff[l]
      mv(ET, kff, Etk);
#pragma unroll
      for (int i = 0; i < B; ++i) sv[i] = c[i] + KtDk[i] + Ktd[i] + Etk[i];
    }
    {
      S DK[A][B], KtDK[B][B], KtE[B][B], Sn[B][B];
      mm(D, K, DK);
      mm_tn(K, DK, KtDK);
      // Kᵀ E: (KᵀE)_ij = Σ_l K[l][i] ET[j][l]
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) {
          S s = K[0][i] * ET[j][0];
#pragma unroll
          for (int l = 1; l < A; ++l) s = s + K[l][i] * ET[j][l];
          KtE[i][j] = s;
        }
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) Sn[i][j] = C[i][j] + KtDK[i][j] + KtE[i][j] + KtE[j][i];
      sym(Sn, Sv);
    }

    store(K_out, t, n, np, K);
    store(kff_out, t, n, np, kff);
    store(S_out, t, n, np, Sv);
    store(s_out, t, n, np, sv);
    store(tau_out, t, n, np, tau);
  }
};

template <typename S, int B, int A>
__global__ void __launch_bounds__(WalkShape<BspBackward<S, B, A>>::Roles::kThreads, 1)
    bsp_backward_kernel(BspBackward<S, B, A> w, int T, int N, bool vec) {
  staged_walk(w, T, N, vec);
}

namespace {

template <typename S, int B, int A>
int launch(const void* const* in, void* const* out, int T, int N, int reg, cudaStream_t s) {
  BspBackward<S, B, A> w{};
  bool vec = N % (16 / (int)sizeof(S)) == 0;
  for (int i = 0; i < 14; ++i) {
    w.streams[i] = (const S*)in[i];
    vec = vec && (size_t)in[i] % 16 == 0;
  }
  w.QT = (const S*)in[14];
  w.qT = (const S*)in[15];
  w.pT = (const S*)in[16];
  w.lam_s = (const S*)in[17];
  w.K_out = (S*)out[0];
  w.kff_out = (S*)out[1];
  w.S_out = (S*)out[2];
  w.s_out = (S*)out[3];
  w.tau_out = (S*)out[4];
  w.ds_out = (S*)out[5];
  w.bad_out = (unsigned char*)out[6];
  w.np = N;
  w.reg = reg;
  return launch_walk(bsp_backward_kernel<S, B, A>, w, T, N, vec, s);
}

using Launch = int (*)(const void* const*, void* const*, int, int, int, cudaStream_t);

// The instantiated (b, a): LightDark (2, 2) and Car (4, 2); float32 and
// float64 each.
Launch pick(int dtype, int b, int a) {
#define TRAJOPT_BELIEF_CASE(B_, A_)                                    \
  if (b == B_ && a == A_) {                                            \
    if (dtype == 0) return launch<float, B_, A_>;                      \
    if (dtype == 1) return launch<double, B_, A_>;                     \
  }
  TRAJOPT_BELIEF_CASE(2, 2)
  TRAJOPT_BELIEF_CASE(4, 2)
#undef TRAJOPT_BELIEF_CASE
  return nullptr;
}

}  // namespace

// C entry point.  dtype: 0 float32, 1 float64.  Returns the CUDA error of the
// launch, or -1 when no kernel is instantiated for (dtype, b, a).
extern "C" int trajopt_bsp_backward(
    int dtype, int b, int a, const void* Q, const void* q, const void* R, const void* r,
    const void* P, const void* p, const void* F, const void* G, const void* X, const void* Y,
    const void* Z, const void* Tm, const void* U, const void* V, const void* QT,
    const void* qT, const void* pT, const void* lam, void* K, void* kff, void* S_out,
    void* s_out, void* tau_out, void* ds, void* bad, int T, int N, int reg, void* stream) {
  const Launch f = pick(dtype, b, a);
  if (f == nullptr) return -1;
  const void* in[18] = {Q, q, R, r, P, p, F, G, X, Y, Z, Tm, U, V, QT, qT, pT, lam};
  void* out[7] = {K, kff, S_out, s_out, tau_out, ds, bad};
  return f(in, out, T, N, reg, (cudaStream_t)stream);
}
