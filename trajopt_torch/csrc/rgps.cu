// K15 and K16: the two launches of one trip of robust GPS's adversary fixed
// point, batched over rows (problem instances, or instances × β-candidates).
//
// K15 replaces trajopt_tpu/core/pallas_rgps.py::_rgps_param_backward_kernel
// (wrapper rgps_param_backward_packed): the adversary's optimal MatrixNormal
// per step (rgps/src/util.cpp:626-798).  Walking the horizon backwards it
// forms the joint (x, u, 1) moments under the carried marginal q, the
// Kronecker-lifted precision W = 2(agCpp + kron(Mz, V'))/(β+η) (p × p,
// p = dx(dx+du+1)), factors W by an unguarded Cholesky, sanitizes the factor
// entrywise (a non-finite entry becomes the identity's, and the row's flag is
// set), inverts it as Σθ* = L⁻ᵀL⁻¹, sets μθ* = Σθ* w, and runs the
// maximizing player's value recursion through A + BK.
//
// K16 replaces pallas_rgps.py::_rgps_cubature_kl_kernel (wrapper
// rgps_cubature_kl_packed): cubature propagation of the state marginal
// through the uncertain dynamics (util.cpp:232-361) over 2·daug points,
// daug = 2dx+du+1, with the quadratic forms z Σθ zᵀ expanded around the
// central point, fused with the per-step KL(p‖q) and the geodesic damping
// q ← interp_KL(q, p; a).  Zero-weight points add 0·(row sum of their own
// factor), so a failed factorization reaches the mean as NaN (IEEE 0·NaN).
//
// Design: one thread block per row, the horizon walked inside the block.
// K15 keeps W (factored in place), L⁻¹ and Σθ* in shared memory, 3p² entries
// (19 KB in float64 at p = 28), and the value carry (V', v', v0') there
// across the reversed time loop.  The Cholesky is left-looking: per column
// one thread takes the pivot and the threads of the rows below take their
// entries; the triangular inverse runs a column per thread and Σθ*'s
// entries, μθ* and the correction blocks P are spread over the block.  The
// small per-step algebra (moments, value recursion) runs on thread 0.  K16
// gives each cubature point a thread (its dx × dx covariance, factor and
// output); thread 0 forms the moments, reduces the points in order and does
// the dx-sized KL and interpolation.  sqrt of a negative pivot gives NaN and
// nothing guards it.  Sums run in the TPU kernels' order and the build uses
// -fmad=false, so the float64 build equals the plain PyTorch versions
// (core/cuda_rgps.py) to rounding.
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace {

__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// Lower Cholesky factor of the n × n matrix A, left-looking, NaN from a
// non-PD pivot on, zeros above the diagonal; inv_d holds 1/diag.
template <typename S, int n>
__device__ void chol_nan(const S (&A)[n][n], S (&L)[n][n], S (&inv_d)[n]) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) L[i][j] = S(0);
  for (int j = 0; j < n; ++j) {
    for (int i = j; i < n; ++i) {
      S s = A[i][j];
      if (j > 0) {
        S acc = L[i][0] * L[j][0];
        for (int k = 1; k < j; ++k) acc = acc + L[i][k] * L[j][k];
        s = s - acc;
      }
      if (i == j) {
        L[j][j] = sqrt_(s);
        inv_d[j] = S(1) / L[j][j];
      } else {
        L[i][j] = s * inv_d[j];
      }
    }
  }
}

// (L Lᵀ)⁻¹ = MᵀM with M = L⁻¹.
template <typename S, int n>
__device__ void inv_from_chol(const S (&L)[n][n], const S (&inv_d)[n], S (&out)[n][n]) {
  S M[n][n];
  for (int j = 0; j < n; ++j) {
    M[j][j] = inv_d[j];
    for (int i = j + 1; i < n; ++i) {
      S acc = L[i][j] * M[j][j];
      for (int k = j + 1; k < i; ++k) acc = acc + L[i][k] * M[k][j];
      M[i][j] = -acc * inv_d[i];
    }
  }
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j) {
      S acc = M[j][i] * M[j][j];
      for (int k = j + 1; k < n; ++k) acc = acc + M[k][i] * M[k][j];
      out[i][j] = acc;
      out[j][i] = acc;
    }
}

template <typename S, int n>
__device__ S logdet(const S (&L)[n][n]) {
  S acc = log_(L[0][0]);
  for (int j = 1; j < n; ++j) acc = acc + log_(L[j][j]);
  return S(2) * acc;
}

// KL(N(mu, Sg) ‖ N(qm, qs)) and interp_KL(q, p; a) → (mu_n, S_n).
template <typename S, int DX>
__device__ S kl_interp(const S (&mu)[DX], const S (&Sg)[DX][DX], const S (&qm)[DX],
                       const S (&qs)[DX][DX], double a, S (&mu_n)[DX], S (&S_n)[DX][DX]) {
  S Lq[DX][DX], idq[DX], lam_q[DX][DX], Lp[DX][DX], idp[DX], lam_p[DX][DX];
  chol_nan<S, DX>(qs, Lq, idq);
  inv_from_chol<S, DX>(Lq, idq, lam_q);
  chol_nan<S, DX>(Sg, Lp, idp);
  inv_from_chol<S, DX>(Lp, idp, lam_p);
  S diff[DX];
  for (int i = 0; i < DX; ++i) diff[i] = qm[i] - mu[i];
  S tp = lam_q[0][0] * Sg[0][0];
  for (int e = 1; e < DX * DX; ++e) tp = tp + lam_q[e / DX][e % DX] * Sg[e % DX][e / DX];
  S lq_d[DX];
  for (int i = 0; i < DX; ++i) {
    S acc = lam_q[i][0] * diff[0];
    for (int j = 1; j < DX; ++j) acc = acc + lam_q[i][j] * diff[j];
    lq_d[i] = acc;
  }
  S quad = diff[0] * lq_d[0];
  for (int i = 1; i < DX; ++i) quad = quad + diff[i] * lq_d[i];
  const S kl = S(0.5) * ((((tp + quad) + logdet<S, DX>(Lq)) - logdet<S, DX>(Lp)) - S(DX));

  const S ca = S(a), cb = S(1.0 - a);
  S Mm[DX][DX], Lm[DX][DX], idm[DX];
  for (int i = 0; i < DX; ++i)
    for (int j = 0; j < DX; ++j) Mm[i][j] = ca * lam_p[i][j] + cb * lam_q[i][j];
  chol_nan<S, DX>(Mm, Lm, idm);
  inv_from_chol<S, DX>(Lm, idm, S_n);
  S rhs[DX];
  for (int i = 0; i < DX; ++i) {
    S ap = lam_p[i][0] * mu[0], aq = lam_q[i][0] * qm[0];
    for (int j = 1; j < DX; ++j) {
      ap = ap + lam_p[i][j] * mu[j];
      aq = aq + lam_q[i][j] * qm[j];
    }
    rhs[i] = ca * ap + cb * aq;
  }
  for (int i = 0; i < DX; ++i) {
    S acc = S_n[i][0] * rhs[0];
    for (int j = 1; j < DX; ++j) acc = acc + S_n[i][j] * rhs[j];
    mu_n[i] = acc;
  }
  return kl;
}

// The action moments and the symmetrized, jittered covariance of (x, u) (and,
// with ONE, the constant slot): Sz of K15, Σxu of K16.
template <typename S, int DX, int DU, int NZ>
__device__ void joint_moments(const S (&mu)[DX], const S (&Sx)[DX][DX], const S (&K)[DU][DX],
                              const S (&kff)[DU], const S (&Sc)[DU][DU], S (&mu_u)[DU],
                              S (&Sz)[NZ][NZ]) {
  for (int a = 0; a < DU; ++a) {
    S acc = K[a][0] * mu[0];
    for (int j = 1; j < DX; ++j) acc = acc + K[a][j] * mu[j];
    mu_u[a] = acc + kff[a];
  }
  S KS[DU][DX], Su[DU][DU], cross[DX][DU];
  for (int a = 0; a < DU; ++a)
    for (int j = 0; j < DX; ++j) {
      S acc = K[a][0] * Sx[0][j];
      for (int k = 1; k < DX; ++k) acc = acc + K[a][k] * Sx[k][j];
      KS[a][j] = acc;
    }
  S raw[DU][DU];
  for (int a = 0; a < DU; ++a)
    for (int b = 0; b < DU; ++b) {
      S acc = KS[a][0] * K[b][0];
      for (int k = 1; k < DX; ++k) acc = acc + KS[a][k] * K[b][k];
      raw[a][b] = Sc[a][b] + acc;
    }
  for (int a = 0; a < DU; ++a)
    for (int b = 0; b < DU; ++b)
      Su[a][b] = S(0.5) * (raw[a][b] + raw[b][a]) + (a == b ? S(1e-8) : S(0));
  for (int i = 0; i < DX; ++i)
    for (int a = 0; a < DU; ++a) {
      S acc = Sx[i][0] * K[a][0];
      for (int k = 1; k < DX; ++k) acc = acc + Sx[i][k] * K[a][k];
      cross[i][a] = acc;
    }
  S Z[NZ][NZ];
  for (int i = 0; i < NZ; ++i)
    for (int j = 0; j < NZ; ++j) Z[i][j] = S(0);
  for (int i = 0; i < DX; ++i) {
    for (int j = 0; j < DX; ++j) Z[i][j] = Sx[i][j];
    for (int a = 0; a < DU; ++a) {
      Z[i][DX + a] = cross[i][a];
      Z[DX + a][i] = cross[i][a];
    }
  }
  for (int a = 0; a < DU; ++a)
    for (int b = 0; b < DU; ++b) Z[DX + a][DX + b] = Su[a][b];
  for (int i = 0; i < NZ; ++i)
    for (int j = 0; j < NZ; ++j)
      Sz[i][j] = S(0.5) * (Z[i][j] + Z[j][i]) + (i == j ? S(1e-8) : S(0));
}

// Entry e of step t of a (steps, entries, N) stream, row n.
template <typename S>
__device__ __forceinline__ S at(const S* __restrict__ p, int t, int entries, int e, int n,
                                int N) {
  return p[((size_t)t * entries + e) * N + n];
}

template <typename S, int R, int C>
__device__ __forceinline__ void load(const S* __restrict__ p, int t, int n, int N,
                                     S (&M)[R][C]) {
  for (int i = 0; i < R; ++i)
    for (int j = 0; j < C; ++j) M[i][j] = at(p, t, R * C, i * C + j, n, N);
}

template <typename S, int R>
__device__ __forceinline__ void load(const S* __restrict__ p, int t, int n, int N,
                                     S (&x)[R]) {
  for (int i = 0; i < R; ++i) x[i] = at(p, t, R, i, n, N);
}

constexpr int THREADS_K15 = 128;
constexpr int THREADS_K16 = 32;

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(THREADS_K15) rgps_param_backward_kernel(
    const S* __restrict__ cxx, const S* __restrict__ cx, const S* __restrict__ cuu,
    const S* __restrict__ cu, const S* __restrict__ cxu, const S* __restrict__ c0,
    const S* __restrict__ cuun, const S* __restrict__ acpp, const S* __restrict__ acp,
    const S* __restrict__ sigd, const S* __restrict__ Kp, const S* __restrict__ kffp,
    const S* __restrict__ sigc, const S* __restrict__ qmu, const S* __restrict__ qsig,
    const S* __restrict__ bpe, const S* __restrict__ vT, const S* __restrict__ vvT,
    const S* __restrict__ v0T, S* __restrict__ muopt, S* __restrict__ sigopt,
    unsigned char* __restrict__ bad_out, int T, int N) {
  constexpr int P1 = DX + DU + 1;
  constexpr int P = DX * P1;
  __shared__ S W[P][P];      // W, factored in place (lower triangle)
  __shared__ S Mi[P][P];     // L⁻¹ (lower triangle)
  __shared__ S Sg[P][P];     // Σθ*
  __shared__ S w[P], mu_opt[P], invd[P];
  __shared__ S Mz[P1][P1], mu_z[P1], Pc[P1][P1];
  __shared__ S V[DX][DX], v[DX], v0;
  __shared__ int bad_step;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const S inv_bpe = S(1) / bpe[n];
  if (tid == 0) {
    for (int i = 0; i < DX; ++i) {
      for (int j = 0; j < DX; ++j) V[i][j] = vT[(i * DX + j) * N + n];
      v[i] = vvT[i * N + n];
    }
    v0 = v0T[n];
  }
  bool bad = false;  // thread 0's running flag
  // thread 0's per-step blocks, read again by the value recursion
  S Cxx[DX][DX], cxv[DX], Cuu[DU][DU], cuv[DU], Cxu[DX][DU], Cuun[DU][DU], sd[DX][DX];
  S K[DU][DX], kff[DU], Sc[DU][DU];
  S c0v = S(0);

  for (int t = T - 1; t >= 0; --t) {
    if (tid == 0) {
      load(cxx, t, n, N, Cxx);
      load(cx, t, n, N, cxv);
      load(cuu, t, n, N, Cuu);
      load(cu, t, n, N, cuv);
      load(cxu, t, n, N, Cxu);
      c0v = at(c0, t, 1, 0, n, N);
      load(cuun, t, n, N, Cuun);
      load(sigd, t, n, N, sd);
      load(Kp, t, n, N, K);
      load(kffp, t, n, N, kff);
      load(sigc, t, n, N, Sc);
      S mu_x[DX], Sx[DX][DX], mu_u[DU], Sz[P1][P1];
      load(qmu, t, n, N, mu_x);
      load(qsig, t, n, N, Sx);
      joint_moments<S, DX, DU, P1>(mu_x, Sx, K, kff, Sc, mu_u, Sz);
      for (int i = 0; i < DX; ++i) mu_z[i] = mu_x[i];
      for (int a = 0; a < DU; ++a) mu_z[DX + a] = mu_u[a];
      mu_z[P1 - 1] = S(1);
      for (int a = 0; a < P1; ++a)
        for (int b = 0; b < P1; ++b) Mz[a][b] = mu_z[a] * mu_z[b] + Sz[a][b];
      bad_step = 0;
    }
    __syncthreads();

    // W = ½(X + Xᵀ), X = 2(agCpp + kron(Mz, V'))/(β+η); w = −(agcp + kron(μz, v'))/(β+η)
    for (int e = tid; e < P * P; e += blockDim.x) {
      const int r = e / P, c = e % P;
      const int a = r / DX, ii = r % DX, b = c / DX, jj = c % DX;
      const S xrc = S(2) * (at(acpp, t, P * P, r * P + c, n, N) + Mz[a][b] * V[ii][jj]) * inv_bpe;
      const S xcr = S(2) * (at(acpp, t, P * P, c * P + r, n, N) + Mz[b][a] * V[jj][ii]) * inv_bpe;
      W[r][c] = S(0.5) * (xrc + xcr);
    }
    for (int r = tid; r < P; r += blockDim.x)
      w[r] = -(at(acp, t, P, r, n, N) + mu_z[r / DX] * v[r % DX]) * inv_bpe;
    __syncthreads();

    // left-looking Cholesky, in place: row i on thread i
    for (int j = 0; j < P; ++j) {
      S s = S(0);
      const int i = tid;
      if (i >= j && i < P) {
        s = W[i][j];
        if (j > 0) {
          S acc = W[i][0] * W[j][0];
          for (int k = 1; k < j; ++k) acc = acc + W[i][k] * W[j][k];
          s = s - acc;
        }
        if (i == j) {
          const S d = sqrt_(s);
          W[j][j] = d;
          invd[j] = S(1) / d;
        }
      }
      __syncthreads();
      if (i > j && i < P) W[i][j] = s * invd[j];
      __syncthreads();
    }

    // entrywise sanitize of the lower triangle, then 1/diag
    for (int e = tid; e < P * P; e += blockDim.x) {
      const int r = e / P, c = e % P;
      if (c <= r && !finite_(W[r][c])) {
        W[r][c] = (r == c) ? S(1) : S(0);
        bad_step = 1;
      }
    }
    __syncthreads();
    for (int j = tid; j < P; j += blockDim.x) invd[j] = S(1) / W[j][j];
    __syncthreads();

    // M = L⁻¹, a column per thread
    for (int j = tid; j < P; j += blockDim.x) {
      Mi[j][j] = invd[j];
      for (int i = j + 1; i < P; ++i) {
        S acc = W[i][j] * Mi[j][j];
        for (int k = j + 1; k < i; ++k) acc = acc + W[i][k] * Mi[k][j];
        Mi[i][j] = -acc * invd[i];
      }
    }
    __syncthreads();

    // Σθ* = MᵀM
    for (int e = tid; e < P * P; e += blockDim.x) {
      const int i = e / P, j = e % P;
      if (i <= j) {
        S acc = Mi[j][i] * Mi[j][j];
        for (int k = j + 1; k < P; ++k) acc = acc + Mi[k][i] * Mi[k][j];
        Sg[i][j] = acc;
        Sg[j][i] = acc;
      }
    }
    __syncthreads();

    for (int r = tid; r < P; r += blockDim.x) {
      S acc = Sg[r][0] * w[0];
      for (int c = 1; c < P; ++c) acc = acc + Sg[r][c] * w[c];
      mu_opt[r] = acc;
      muopt[((size_t)t * P + r) * N + n] = acc;
    }
    // correction blocks P[a][b] = tr(Σθ*_block[a, b] V')
    for (int e = tid; e < P1 * P1; e += blockDim.x) {
      const int a = e / P1, b = e % P1;
      S acc = Sg[a * DX][b * DX] * V[0][0];
      for (int q = 1; q < DX * DX; ++q) {
        const int ii = q / DX, jj = q % DX;
        acc = acc + Sg[a * DX + ii][b * DX + jj] * V[jj][ii];
      }
      Pc[a][b] = acc;
    }
    for (int e = tid; e < P * P; e += blockDim.x)
      sigopt[((size_t)t * P * P + e) * N + n] = Sg[e / P][e % P];
    __syncthreads();

    if (tid == 0) {
      S A[DX][DX], B[DX][DU], cvec[DX];
      for (int ii = 0; ii < DX; ++ii) {
        for (int a = 0; a < DX; ++a) A[ii][a] = mu_opt[a * DX + ii];
        for (int b = 0; b < DU; ++b) B[ii][b] = mu_opt[(DX + b) * DX + ii];
        cvec[ii] = mu_opt[(DX + DU) * DX + ii];
      }
      S Acl[DX][DX], ccl[DX];
      for (int i = 0; i < DX; ++i) {
        for (int j = 0; j < DX; ++j) {
          S acc = B[i][0] * K[0][j];
          for (int q = 1; q < DU; ++q) acc = acc + B[i][q] * K[q][j];
          Acl[i][j] = A[i][j] + acc;
        }
        S acc = B[i][0] * kff[0];
        for (int q = 1; q < DU; ++q) acc = acc + B[i][q] * kff[q];
        ccl[i] = cvec[i] + acc;
      }
      // kron(σ_block, V') contractions (σ_block: the control block only)
      S Vblk[DU][DX];
      for (int b = 0; b < DU; ++b)
        for (int i = 0; i < DX; ++i) {
          S acc = B[0][b] * V[i][0];
          for (int j = 1; j < DX; ++j) acc = acc + B[j][b] * V[i][j];
          Vblk[b][i] = acc;
        }
      S mu_kv = S(0), tr_kv = S(0);
      for (int a = 0; a < DU; ++a)
        for (int b = 0; b < DU; ++b) {
          S d = B[0][a] * Vblk[b][0];
          for (int i = 1; i < DX; ++i) d = d + B[i][a] * Vblk[b][i];
          const S m = Sc[a][b] * d;
          S tr = V[0][0] * Sg[(DX + b) * DX][(DX + a) * DX];
          for (int q = 1; q < DX * DX; ++q) {
            const int ii = q / DX, jj = q % DX;
            tr = tr + V[ii][jj] * Sg[(DX + b) * DX + jj][(DX + a) * DX + ii];
          }
          tr = Sc[a][b] * tr;
          const bool first = (a == 0 && b == 0);
          mu_kv = first ? m : mu_kv + m;
          tr_kv = first ? tr : tr_kv + tr;
        }
      S mCuuP[DU][DU], mCxuP[DX][DU], mcu[DU];
      for (int a = 0; a < DU; ++a) {
        for (int b = 0; b < DU; ++b) mCuuP[a][b] = -Cuu[a][b] + Pc[DX + a][DX + b];
        mcu[a] = -cuv[a] + S(2) * Pc[DX + a][P1 - 1];
      }
      for (int i = 0; i < DX; ++i)
        for (int b = 0; b < DU; ++b) mCxuP[i][b] = -Cxu[i][b] + Pc[i][DX + b];
      S KtmC[DX][DU];
      for (int i = 0; i < DX; ++i)
        for (int q = 0; q < DU; ++q) {
          S acc = K[0][i] * mCuuP[0][q];
          for (int r = 1; r < DU; ++r) acc = acc + K[r][i] * mCuuP[r][q];
          KtmC[i][q] = acc;
        }
      S VAcl[DX][DX], Vraw[DX][DX];
      for (int i = 0; i < DX; ++i)
        for (int j = 0; j < DX; ++j) {
          S acc = V[i][0] * Acl[0][j];
          for (int q = 1; q < DX; ++q) acc = acc + V[i][q] * Acl[q][j];
          VAcl[i][j] = acc;
        }
      for (int a = 0; a < DX; ++a)
        for (int b = 0; b < DX; ++b) {
          S k1 = KtmC[a][0] * K[0][b];
          for (int q = 1; q < DU; ++q) k1 = k1 + KtmC[a][q] * K[q][b];
          S k2 = Acl[0][a] * VAcl[0][b];
          for (int q = 1; q < DX; ++q) k2 = k2 + Acl[q][a] * VAcl[q][b];
          S k3 = mCxuP[a][0] * K[0][b];
          for (int q = 1; q < DU; ++q) k3 = k3 + mCxuP[a][q] * K[q][b];
          Vraw[a][b] = (((-Cxx[a][b] + Pc[a][b]) + k1) + k2) + S(2) * k3;
        }
      S Vc[DX];
      for (int i = 0; i < DX; ++i) {
        S acc = V[i][0] * ccl[0];
        for (int j = 1; j < DX; ++j) acc = acc + V[i][j] * ccl[j];
        Vc[i] = acc;
      }
      S vn[DX];
      for (int a = 0; a < DX; ++a) {
        S k1 = KtmC[a][0] * kff[0], k2 = mCxuP[a][0] * kff[0];
        for (int q = 1; q < DU; ++q) {
          k1 = k1 + KtmC[a][q] * kff[q];
          k2 = k2 + mCxuP[a][q] * kff[q];
        }
        S k3 = K[0][a] * mcu[0];
        for (int q = 1; q < DU; ++q) k3 = k3 + K[q][a] * mcu[q];
        S k4 = Acl[0][a] * Vc[0], k5 = Acl[0][a] * v[0];
        for (int q = 1; q < DX; ++q) {
          k4 = k4 + Acl[q][a] * Vc[q];
          k5 = k5 + Acl[q][a] * v[q];
        }
        vn[a] = (((((-cxv[a] + S(2) * Pc[a][P1 - 1]) + S(2) * k1) + S(2) * k2) + k3) +
                 S(2) * k4) + k5;
      }
      S mk[DU];
      for (int a = 0; a < DU; ++a) {
        S acc = mCuuP[a][0] * kff[0];
        for (int b = 1; b < DU; ++b) acc = acc + mCuuP[a][b] * kff[b];
        mk[a] = acc;
      }
      S d1 = kff[0] * mk[0], d2 = kff[0] * mcu[0];
      for (int a = 1; a < DU; ++a) {
        d1 = d1 + kff[a] * mk[a];
        d2 = d2 + kff[a] * mcu[a];
      }
      S tc = Cuun[0][0] * Sc[0][0];
      for (int e = 1; e < DU * DU; ++e) tc = tc + Cuun[e / DU][e % DU] * Sc[e % DU][e / DU];
      S ts = V[0][0] * sd[0][0];
      for (int e = 1; e < DX * DX; ++e) ts = ts + V[e / DX][e % DX] * sd[e % DX][e / DX];
      S d3 = ccl[0] * Vc[0], d4 = ccl[0] * v[0];
      for (int i = 1; i < DX; ++i) {
        d3 = d3 + ccl[i] * Vc[i];
        d4 = d4 + ccl[i] * v[i];
      }
      const S v0n = ((((((((((-c0v + Pc[P1 - 1][P1 - 1]) + d1) + d2) - tc) + v0) + ts) + mu_kv) +
                      tr_kv) + d3) + d4);
      for (int a = 0; a < DX; ++a)
        for (int b = 0; b < DX; ++b) V[a][b] = S(0.5) * (Vraw[a][b] + Vraw[b][a]);
      for (int a = 0; a < DX; ++a) v[a] = vn[a];
      v0 = v0n;
      bad = bad || (bad_step != 0);
    }
    __syncthreads();
  }
  if (tid == 0) bad_out[n] = bad ? 1 : 0;
}

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(THREADS_K16) rgps_cubature_kl_kernel(
    const S* __restrict__ muopt, const S* __restrict__ sigopt, const S* __restrict__ sigd,
    const S* __restrict__ Kp, const S* __restrict__ kffp, const S* __restrict__ sigc,
    const S* __restrict__ qmu, const S* __restrict__ qsig, const S* __restrict__ mu0,
    const S* __restrict__ sig0, S* __restrict__ kl_out, S* __restrict__ qnmu,
    S* __restrict__ qnsig, double a_interp, int T, int N) {
  constexpr int NXU = DX + DU;
  constexpr int P1 = NXU + 1;
  constexpr int P = DX * P1;
  constexpr int DAUG = NXU + 1 + DX;
  constexpr int NPTS = 2 * DAUG;
  __shared__ S S4[P * P];                  // Σθ*, (a, i, b, j) at (a·DX+i)·P + b·DX+j
  __shared__ S Zm[P1][DX][DX], Qmu[DX][DX], LcC[DX][DX], Lxu[NXU][NXU];
  __shared__ S mu_z[P1], f_c[DX], A[DX][DX], B[DX][DU], sd[DX][DX], rowsumC[DX];
  __shared__ S outs[NPTS][DX];
  __shared__ S mu[DX], Sg[DX][DX];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const double s = sqrt((double)DAUG);
  const S ss = S(s * s), inv_pts = S(1.0 / NPTS);

  if (tid == 0) {
    for (int i = 0; i < DX; ++i) {
      mu[i] = mu0[i * N + n];
      for (int j = 0; j < DX; ++j) Sg[i][j] = sig0[(i * DX + j) * N + n];
    }
  }
  __syncthreads();

  for (int t = 0; t <= T; ++t) {
    if (tid == 0) {
      S m[DX], Sx[DX][DX], qm[DX], qs[DX][DX], mn[DX], Sn[DX][DX];
      for (int i = 0; i < DX; ++i) {
        m[i] = mu[i];
        for (int j = 0; j < DX; ++j) Sx[i][j] = Sg[i][j];
      }
      load(qmu, t, n, N, qm);
      load(qsig, t, n, N, qs);
      kl_out[(size_t)t * N + n] = kl_interp<S, DX>(m, Sx, qm, qs, a_interp, mn, Sn);
      for (int i = 0; i < DX; ++i) {
        qnmu[((size_t)t * DX + i) * N + n] = mn[i];
        for (int j = 0; j < DX; ++j) qnsig[((size_t)t * DX * DX + i * DX + j) * N + n] = Sn[i][j];
      }
      if (t < T) {
        S K[DU][DX], kff[DU], Sc[DU][DU], mu_u[DU], Sxu[NXU][NXU], L[NXU][NXU], idl[NXU];
        load(Kp, t, n, N, K);
        load(kffp, t, n, N, kff);
        load(sigc, t, n, N, Sc);
        load(sigd, t, n, N, sd);
        joint_moments<S, DX, DU, NXU>(m, Sx, K, kff, Sc, mu_u, Sxu);
        chol_nan<S, NXU>(Sxu, L, idl);
        for (int i = 0; i < NXU; ++i)
          for (int j = 0; j < NXU; ++j) Lxu[i][j] = L[i][j];
        for (int i = 0; i < DX; ++i) mu_z[i] = m[i];
        for (int a = 0; a < DU; ++a) mu_z[DX + a] = mu_u[a];
        mu_z[P1 - 1] = S(1);
        S cvec[DX];
        for (int ii = 0; ii < DX; ++ii) {
          for (int a = 0; a < DX; ++a) A[ii][a] = at(muopt, t, P, a * DX + ii, n, N);
          for (int b = 0; b < DU; ++b) B[ii][b] = at(muopt, t, P, (DX + b) * DX + ii, n, N);
          cvec[ii] = at(muopt, t, P, (DX + DU) * DX + ii, n, N);
        }
        for (int ii = 0; ii < DX; ++ii) {
          S a1 = A[ii][0] * m[0];
          for (int j = 1; j < DX; ++j) a1 = a1 + A[ii][j] * m[j];
          S a2 = B[ii][0] * mu_u[0];
          for (int j = 1; j < DU; ++j) a2 = a2 + B[ii][j] * mu_u[j];
          f_c[ii] = (a1 + a2) + cvec[ii];
        }
      }
    }
    if (t == T) break;  // uniform across the block
    for (int e = tid; e < P * P; e += blockDim.x) S4[e] = at(sigopt, t, P * P, e, n, N);
    __syncthreads();

    // central quadratic form Zm[a][i][j] = Σ_b μz_b S4[a, i, b, j]
    for (int e = tid; e < P1 * DX * DX; e += blockDim.x) {
      const int a = e / (DX * DX), ii = (e / DX) % DX, jj = e % DX;
      S acc = mu_z[0] * S4[(a * DX + ii) * P + jj];
      for (int b = 1; b < P1; ++b) acc = acc + mu_z[b] * S4[(a * DX + ii) * P + b * DX + jj];
      Zm[a][ii][jj] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      S cov[DX][DX], L[DX][DX], idl[DX];
      for (int ii = 0; ii < DX; ++ii)
        for (int jj = 0; jj < DX; ++jj) {
          S acc = mu_z[0] * Zm[0][ii][jj];
          for (int a = 1; a < P1; ++a) acc = acc + mu_z[a] * Zm[a][ii][jj];
          Qmu[ii][jj] = acc;
        }
      for (int ii = 0; ii < DX; ++ii)
        for (int jj = 0; jj < DX; ++jj)
          cov[ii][jj] = S(0.5) * ((sd[ii][jj] + Qmu[ii][jj]) + (sd[jj][ii] + Qmu[jj][ii]));
      chol_nan<S, DX>(cov, L, idl);
      for (int ii = 0; ii < DX; ++ii) {
        S acc = L[ii][0];
        for (int jj = 1; jj < DX; ++jj) acc = acc + L[ii][jj];
        rowsumC[ii] = acc;
        for (int jj = 0; jj < DX; ++jj) LcC[ii][jj] = L[ii][jj];
      }
    }
    __syncthreads();

    // one cubature point per thread
    if (tid < NPTS) {
      const int pt = tid;
      S out[DX];
      if (pt < 2 * NXU) {
        const int k = pt / 2;
        const double sg = (pt % 2 == 0) ? 1.0 : -1.0;
        S Bk[DX][DX], Qk[DX][DX], dfk[DX];
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj) {
            S bk = Lxu[k][k] * Zm[k][ii][jj];
            for (int a = k + 1; a < NXU; ++a) bk = bk + Lxu[a][k] * Zm[a][ii][jj];
            Bk[ii][jj] = bk;
            S qk = S(0);
            for (int b = k; b < NXU; ++b) {
              S yk = Lxu[k][k] * S4[(k * DX + ii) * P + b * DX + jj];
              for (int a = k + 1; a < NXU; ++a)
                yk = yk + Lxu[a][k] * S4[(a * DX + ii) * P + b * DX + jj];
              qk = (b == k) ? Lxu[k][k] * yk : qk + Lxu[b][k] * yk;
            }
            Qk[ii][jj] = qk;
          }
        for (int ii = 0; ii < DX; ++ii) {
          S head = S(0), tail = S(0);
          bool has_head = false;
          for (int r = k; r < (NXU < DX ? NXU : DX); ++r) {
            const S term = A[ii][r] * Lxu[r][k];
            head = has_head ? head + term : term;
            has_head = true;
          }
          for (int r = (k > DX ? k : DX); r < NXU; ++r) {
            const S term = B[ii][r - DX] * Lxu[r][k];
            tail = (r == (k > DX ? k : DX)) ? term : tail + term;
          }
          dfk[ii] = has_head ? head + tail : tail;
        }
        S craw[DX][DX], cov[DX][DX], L[DX][DX], idl[DX];
        const S cs = S(sg * s);
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj)
            craw[ii][jj] = ((sd[ii][jj] + Qmu[ii][jj]) + ss * Qk[ii][jj]) +
                           cs * (Bk[ii][jj] + Bk[jj][ii]);
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj) cov[ii][jj] = S(0.5) * (craw[ii][jj] + craw[jj][ii]);
        chol_nan<S, DX>(cov, L, idl);
        for (int ii = 0; ii < DX; ++ii) {
          S rows = L[ii][0];
          for (int jj = 1; jj < DX; ++jj) rows = rows + L[ii][jj];
          out[ii] = (f_c[ii] + cs * dfk[ii]) + S(0) * rows;
        }
      } else if (pt < 2 * NXU + 2) {
        for (int ii = 0; ii < DX; ++ii) out[ii] = f_c[ii] + S(0) * rowsumC[ii];
      } else {
        const int j = (pt - 2 * NXU - 2) / 2;
        const S cs = S(((pt - 2 * NXU - 2) % 2 == 0 ? 1.0 : -1.0) * s);
        for (int ii = 0; ii < DX; ++ii) out[ii] = f_c[ii] + cs * LcC[ii][j];
      }
      for (int ii = 0; ii < DX; ++ii) outs[pt][ii] = out[ii];
    }
    __syncthreads();

    if (tid == 0) {
      S mn[DX];
      for (int ii = 0; ii < DX; ++ii) {
        S acc = outs[0][ii];
        for (int q = 1; q < NPTS; ++q) acc = acc + outs[q][ii];
        mn[ii] = acc * inv_pts;
      }
      for (int ii = 0; ii < DX; ++ii)
        for (int jj = 0; jj < DX; ++jj) {
          S acc = (outs[0][ii] - mn[ii]) * (outs[0][jj] - mn[jj]);
          for (int q = 1; q < NPTS; ++q) acc = acc + (outs[q][ii] - mn[ii]) * (outs[q][jj] - mn[jj]);
          Sg[ii][jj] = acc * inv_pts;
        }
      for (int ii = 0; ii < DX; ++ii) mu[ii] = mn[ii];
    }
    __syncthreads();
  }
}

template <typename S, int DX, int DU>
int launch_param_backward(const void* const* in, void* const* out, double, int T, int N,
                          cudaStream_t s) {
  rgps_param_backward_kernel<S, DX, DU><<<N, THREADS_K15, 0, s>>>((const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4], (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9], (const S*)in[10], (const S*)in[11], (const S*)in[12], (const S*)in[13], (const S*)in[14], (const S*)in[15], (const S*)in[16], (const S*)in[17], (const S*)in[18], (S*)out[0], (S*)out[1], (unsigned char*)out[2], T, N);
  return (int)cudaGetLastError();
}

template <typename S, int DX, int DU>
int launch_cubature_kl(const void* const* in, void* const* out, double a, int T, int N,
                       cudaStream_t s) {
  rgps_cubature_kl_kernel<S, DX, DU><<<N, THREADS_K16, 0, s>>>((const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4], (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9], (S*)out[0], (S*)out[1], (S*)out[2], a, T, N);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void* const*, void* const*, double, int, int, cudaStream_t);

// The instantiated (dx, du): LQR and Pendulum (2, 1), the pinned fixtures'
// (3, 2) and Robot (4, 2); float32 and float64 each.
template <bool Backward>
Launch pick(int dtype, int dx, int du) {
#define TRAJOPT_RGPS_CASE(DX, DU)                                                  \
  if (dx == DX && du == DU) {                                                      \
    if (dtype == 0) return Backward ? launch_param_backward<float, DX, DU>         \
                                    : launch_cubature_kl<float, DX, DU>;           \
    if (dtype == 1) return Backward ? launch_param_backward<double, DX, DU>        \
                                    : launch_cubature_kl<double, DX, DU>;          \
  }
  TRAJOPT_RGPS_CASE(2, 1)
  TRAJOPT_RGPS_CASE(3, 2)
  TRAJOPT_RGPS_CASE(4, 2)
#undef TRAJOPT_RGPS_CASE
  return nullptr;
}

}  // namespace

// C entry points.  dtype: 0 float32, 1 float64.  Each returns the CUDA error
// of its launch, or -1 when no kernel is instantiated for (dtype, dx, du).
extern "C" int trajopt_rgps_param_backward(
    int dtype, int dx, int du, const void* cxx, const void* cx, const void* cuu,
    const void* cu, const void* cxu, const void* c0, const void* cuun, const void* acpp,
    const void* acp, const void* sigd, const void* K, const void* kff, const void* sigc,
    const void* qmu, const void* qsig, const void* bpe, const void* vT, const void* vvT,
    const void* v0T, void* muopt, void* sigopt, void* bad, int T, int N, void* stream) {
  const Launch f = pick<true>(dtype, dx, du);
  if (f == nullptr) return -1;
  const void* in[19] = {cxx, cx,  cuu, cu,   cxu,  c0,  cuun, acpp, acp, sigd,
                        K,   kff, sigc, qmu, qsig, bpe, vT,   vvT,  v0T};
  void* out[3] = {muopt, sigopt, bad};
  return f(in, out, 0.0, T, N, (cudaStream_t)stream);
}

extern "C" int trajopt_rgps_cubature_kl(
    int dtype, int dx, int du, const void* muopt, const void* sigopt, const void* sigd,
    const void* K, const void* kff, const void* sigc, const void* qmu, const void* qsig,
    const void* mu0, const void* sig0, void* kl, void* qnmu, void* qnsig, double a_interp,
    int T, int N, void* stream) {
  const Launch f = pick<false>(dtype, dx, du);
  if (f == nullptr) return -1;
  const void* in[10] = {muopt, sigopt, sigd, K, kff, sigc, qmu, qsig, mu0, sig0};
  void* out[3] = {kl, qnmu, qnsig};
  return f(in, out, a_interp, T, N, (cudaStream_t)stream);
}
