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
// and writes 46, so the bytes are the floor when enough instances run.
//
// Design: one thread per instance walks the horizon with the carry (S, s, τ,
// dS, flag) in registers, in place of the TPU kernel's reverse time grid with
// its VMEM scratch.  Operands are structure of arrays (T, entries, N) with
// instances contiguous, so a warp's loads of one entry coalesce.  The b²-row
// blocks X, Y, Z, T, U, V only ever meet a vector from the left (Xᵀ·vec S,
// Uᵀ·τ, ...), so they are read entry by entry inside those products and never
// held whole in registers.  Sums run in the TPU kernel's order and the build
// uses -fmad=false, so the float64 build equals the plain PyTorch version
// (core/cuda_belief.py) to rounding.
#include <cuda_runtime.h>

#include "bwd_step.cuh"

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

// y = Mᵀ x for the (R, C) block of step t of a stream, read entry by entry.
template <typename S, int R, int C>
__device__ __forceinline__ void mv_tn_stream(const S* __restrict__ p, int t, int n, size_t np,
                                             const S (&x)[R], S (&y)[C]) {
  const size_t base = (size_t)t * R * C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    S s = p[(base + i) * np + n] * x[0];
#pragma unroll
    for (int l = 1; l < R; ++l) s = s + p[(base + l * C + i) * np + n] * x[l];
    y[i] = s;
  }
}

}  // namespace

template <typename S, int B, int A>
__global__ void __launch_bounds__(32) bsp_backward_kernel(
    const S* __restrict__ Qs, const S* __restrict__ qs, const S* __restrict__ Rs,
    const S* __restrict__ rs, const S* __restrict__ Ps, const S* __restrict__ ps,
    const S* __restrict__ Fs, const S* __restrict__ Gs, const S* __restrict__ Xs,
    const S* __restrict__ Ys, const S* __restrict__ Zs, const S* __restrict__ Ts,
    const S* __restrict__ Us, const S* __restrict__ Vs, const S* __restrict__ QT,
    const S* __restrict__ qT, const S* __restrict__ pT, const S* __restrict__ lam_s,
    S* __restrict__ K_out, S* __restrict__ kff_out, S* __restrict__ S_out,
    S* __restrict__ s_out, S* __restrict__ tau_out, S* __restrict__ ds_out,
    unsigned char* __restrict__ bad_out, int T, int N, int reg) {
  constexpr int BB = B * B;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t np = N;
  const S lam = lam_s[n];

  S Sv[B][B], sv[B], tau[BB];
  load(QT, 0, n, np, Sv);
  load(qT, 0, n, np, sv);
  load(pT, 0, n, np, tau);
  S ds0 = S(0), ds1 = S(0);
  bool bad = false;

  for (int t = T - 1; t >= 0; --t) {
    S Q[B][B], q[B], R[A][A], r[A], P[B][A], F[B][B], G[B][A];
    load(Qs, t, n, np, Q);
    load(qs, t, n, np, q);
    load(Rs, t, n, np, R);
    load(rs, t, n, np, r);
    load(Ps, t, n, np, P);
    load(Fs, t, n, np, F);
    load(Gs, t, n, np, G);

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
        for (int j = 0; j < A; ++j) D[i][j] = R[i][j] + GtSG[i][j];
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
      mv_tn_stream<S, BB, B>(Ts, t, n, np, tau, Tt);
      mv_tn_stream<S, BB, B>(Xs, t, n, np, vecS, Xv);
#pragma unroll
      for (int i = 0; i < B; ++i) c[i] = q[i] + Fs_[i] + Tt[i] + S(0.5) * Xv[i];
    }
    {
      S Gs_[A], Vt[A], Zv[A];
      mv_tn(G, sv, Gs_);
      mv_tn_stream<S, BB, A>(Vs, t, n, np, tau, Vt);
      mv_tn_stream<S, BB, A>(Zs, t, n, np, vecS, Zv);
#pragma unroll
      for (int i = 0; i < A; ++i) d[i] = r[i] + Gs_[i] + Vt[i] + S(0.5) * Zv[i];
    }
    {
      S p[BB], Ut[BB], Yv[BB];
      load(ps, t, n, np, p);
      mv_tn_stream<S, BB, BB>(Us, t, n, np, tau, Ut);
      mv_tn_stream<S, BB, BB>(Ys, t, n, np, vecS, Yv);
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
        for (int j = 0; j < A; ++j) D_reg[i][j] = R[i][j] + GtSGr[i][j];
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

    S Ds[A][A], L[A][A], inv_d[A];
    sym(D_reg, Ds);
    bad = chol(Ds, L, inv_d) || bad;

    S K[A][B], kff[A];
#pragma unroll
    for (int col = 0; col < B; ++col) {
      S bcol[A], x[A];
#pragma unroll
      for (int i = 0; i < A; ++i) bcol[i] = E_reg[i][col];
      chol_solve(L, inv_d, bcol, x);
#pragma unroll
      for (int i = 0; i < A; ++i) K[i][col] = -x[i];
    }
    {
      S x[A];
      chol_solve(L, inv_d, d, x);
#pragma unroll
      for (int i = 0; i < A; ++i) kff[i] = -x[i];
    }

    S D_kff[A];
    mv(D, kff, D_kff);
    ds0 = ds0 + dot(kff, d);
    ds1 = ds1 + S(0.5) * dot(kff, D_kff);

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
  ds_out[n] = ds0;
  ds_out[np + n] = ds1;
  bad_out[n] = bad ? 1 : 0;
}

namespace {

constexpr int THREADS = 32;

template <typename S, int B, int A>
int launch(const void* const* in, void* const* out, int T, int N, int reg, cudaStream_t s) {
  const int blocks = (N + THREADS - 1) / THREADS;
  bsp_backward_kernel<S, B, A><<<blocks, THREADS, 0, s>>>(
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9],
      (const S*)in[10], (const S*)in[11], (const S*)in[12], (const S*)in[13],
      (const S*)in[14], (const S*)in[15], (const S*)in[16], (const S*)in[17], (S*)out[0],
      (S*)out[1], (S*)out[2], (S*)out[3], (S*)out[4], (S*)out[5], (unsigned char*)out[6], T,
      N, reg);
  return (int)cudaGetLastError();
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
