// One regularized iLQR backward step for one instance, unrolled in registers
// (the body of ilqr/src/util.cpp:83-182; counterpart of _bwd_step in
// trajopt_tpu/core/pallas_lqr.py:149).  Shared by the stream backward (K4,
// ilqr_backward.cu) and the fused backward (K1, fused_backward.cu).
//
// Sums run in the order of the JAX kernel (index 0 first) so that the f64
// build agrees with the plain versions to rounding.
#pragma once

#include <math.h>

#include "scalar.cuh"

// C = A B for A (n, k), B (k, m).
template <typename S, int N, int K, int M>
__device__ __forceinline__ void mm(const S (&A)[N][K], const S (&B)[K][M], S (&C)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      S s = A[i][0] * B[0][j];
#pragma unroll
      for (int l = 1; l < K; ++l) s = s + A[i][l] * B[l][j];
      C[i][j] = s;
    }
}

// C = Aᵀ B for A (k, n), B (k, m).
template <typename S, int K, int N, int M>
__device__ __forceinline__ void mm_tn(const S (&A)[K][N], const S (&B)[K][M], S (&C)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      S s = A[0][i] * B[0][j];
#pragma unroll
      for (int l = 1; l < K; ++l) s = s + A[l][i] * B[l][j];
      C[i][j] = s;
    }
}

// y = A x for A (n, k).
template <typename S, int N, int K>
__device__ __forceinline__ void mv(const S (&A)[N][K], const S (&x)[K], S (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s = A[i][0] * x[0];
#pragma unroll
    for (int l = 1; l < K; ++l) s = s + A[i][l] * x[l];
    y[i] = s;
  }
}

// y = Aᵀ x for A (k, n).
template <typename S, int K, int N>
__device__ __forceinline__ void mv_tn(const S (&A)[K][N], const S (&x)[K], S (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s = A[0][i] * x[0];
#pragma unroll
    for (int l = 1; l < K; ++l) s = s + A[l][i] * x[l];
    y[i] = s;
  }
}

template <typename S, int N>
__device__ __forceinline__ S dot(const S (&x)[N], const S (&y)[N]) {
  S s = x[0] * y[0];
#pragma unroll
  for (int i = 1; i < N; ++i) s = s + x[i] * y[i];
  return s;
}

// 0.5 (A + Aᵀ).
template <typename S, int N>
__device__ __forceinline__ void sym(const S (&A)[N][N], S (&B)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) B[i][j] = S(0.5) * (A[i][j] + A[j][i]);
}

// Cholesky–Banachiewicz of a symmetric (n, n).  A pivot that is non-positive
// or non-finite flags the instance, which continues with a unit pivot so the
// arithmetic after it stays finite (pallas_lqr.py:99-120).
template <typename S, int N>
__device__ __forceinline__ bool chol(const S (&A)[N][N], S (&L)[N][N], S (&inv_d)[N]) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    S s = A[j][j];
    if (j > 0) {
      S acc = L[j][0] * L[j][0];
#pragma unroll
      for (int k = 1; k < j; ++k) acc = acc + L[j][k] * L[j][k];
      s = s - acc;
    }
    const bool good = (s > S(0)) && finite_(s);
    bad = bad || !good;
    L[j][j] = sqrt_(good ? s : S(1));
    inv_d[j] = S(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      S r = A[i][j];
      if (j > 0) {
        S acc = L[i][0] * L[j][0];
#pragma unroll
        for (int k = 1; k < j; ++k) acc = acc + L[i][k] * L[j][k];
        r = r - acc;
      }
      L[i][j] = r * inv_d[j];
    }
  }
  return bad;
}

// Solve (L Lᵀ) x = b by forward and back substitution.
template <typename S, int N>
__device__ __forceinline__ void chol_solve(const S (&L)[N][N], const S (&inv_d)[N],
                                           const S (&b)[N], S (&x)[N]) {
  S y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S r = b[i];
    if (i > 0) {
      S acc = L[i][0] * y[0];
#pragma unroll
      for (int k = 1; k < i; ++k) acc = acc + L[i][k] * y[k];
      r = r - acc;
    }
    y[i] = r * inv_d[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    S r = y[i];
    if (i + 1 < N) {
      S acc = L[i + 1][i] * x[i + 1];
#pragma unroll
      for (int k = i + 2; k < N; ++k) acc = acc + L[k][i] * x[k];
      r = r - acc;
    }
    x[i] = r * inv_d[i];
  }
}

// The step.  Inputs: the stage's cost blocks (Cxx, cx, Cuu, cu, Cxu) and
// dynamics (A, B); the carry (V, v, dv0, dv1, bad) is updated in place.
// Outputs the gains K (du, dx) and kff (du).
template <typename S, int DX, int DU>
__device__ __forceinline__ void bwd_step(
    const S (&Cxx)[DX][DX], const S (&cx)[DX], const S (&Cuu)[DU][DU], const S (&cu)[DU],
    const S (&Cxu)[DX][DU], const S (&A)[DX][DX], const S (&B)[DX][DU],
    S (&V)[DX][DX], S (&v)[DX], S& dv0, S& dv1, bool& bad, S lam, int reg,
    S (&K)[DU][DX], S (&kff)[DU]) {
  S VA[DX][DX], VB[DX][DU];
  mm(V, A, VA);
  mm(V, B, VB);

  S Qxx[DX][DX], Quu[DU][DU], QuxT[DX][DU], qx[DX], qu[DU];
  {
    S t_xx[DX][DX], t_uu[DU][DU], t_xu[DX][DU], t_x[DX], t_u[DU];
    mm_tn(A, VA, t_xx);
    mm_tn(B, VB, t_uu);
    mm_tn(A, VB, t_xu);
    mv_tn(A, v, t_x);
    mv_tn(B, v, t_u);
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) Qxx[i][j] = Cxx[i][j] + t_xx[i][j];
#pragma unroll
      for (int j = 0; j < DU; ++j) QuxT[i][j] = Cxu[i][j] + t_xu[i][j];
      qx[i] = cx[i] + t_x[i];
    }
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DU; ++j) Quu[i][j] = Cuu[i][j] + t_uu[i][j];
      qu[i] = cu[i] + t_u[i];
    }
  }

  // λ on Quu only (reg 1), or on the value Hessian (reg 2): V + λI gives
  // VB + λB, and the regularized blocks are formed from it.
  S QuxT_r[DX][DU], Quu_r[DU][DU];
  if (reg == 1) {
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) QuxT_r[i][j] = QuxT[i][j];
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) Quu_r[i][j] = i == j ? Quu[i][j] + lam : Quu[i][j];
  } else {
    S VB_r[DX][DU], t_xu[DX][DU], t_uu[DU][DU];
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) VB_r[i][j] = VB[i][j] + lam * B[i][j];
    mm_tn(A, VB_r, t_xu);
    mm_tn(B, VB_r, t_uu);
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) QuxT_r[i][j] = Cxu[i][j] + t_xu[i][j];
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) Quu_r[i][j] = Cuu[i][j] + t_uu[i][j];
  }

  S Qs[DU][DU], L[DU][DU], inv_d[DU];
  sym(Quu_r, Qs);
  bad = chol(Qs, L, inv_d) || bad;

  // K = −Quu_r⁻¹ Qux_r, column by column of Qux_rᵀ; kff = −Quu_r⁻¹ qu.
#pragma unroll
  for (int c = 0; c < DX; ++c) {
    S b[DU], x[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) b[i] = QuxT_r[c][i];
    chol_solve(L, inv_d, b, x);
#pragma unroll
    for (int i = 0; i < DU; ++i) K[i][c] = -x[i];
  }
  {
    S x[DU];
    chol_solve(L, inv_d, qu, x);
#pragma unroll
    for (int i = 0; i < DU; ++i) kff[i] = -x[i];
  }

  S Quu_kff[DU];
  mv(Quu, kff, Quu_kff);
  dv0 = dv0 + dot(kff, qu);
  dv1 = dv1 + S(0.5) * dot(kff, Quu_kff);

  {
    S a[DX], b[DX], c[DX];
    mv_tn(K, Quu_kff, a);
    mv_tn(K, qu, b);
    mv(QuxT, kff, c);
#pragma unroll
    for (int i = 0; i < DX; ++i) v[i] = qx[i] + a[i] + b[i] + c[i];
  }

  // V = sym(Qxx + Kᵀ Quu K) + P + Pᵀ with P = Kᵀ Qux.
  S QuuK[DU][DX], KtQK[DX][DX], M[DX][DX], P[DX][DX];
  mm(Quu, K, QuuK);
  mm_tn(K, QuuK, KtQK);
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) KtQK[i][j] = Qxx[i][j] + KtQK[i][j];
  sym(KtQK, M);
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      S s = K[0][i] * QuxT[j][0];
#pragma unroll
      for (int l = 1; l < DU; ++l) s = s + K[l][i] * QuxT[j][l];
      P[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) V[i][j] = M[i][j] + P[i][j] + P[j][i];
}
