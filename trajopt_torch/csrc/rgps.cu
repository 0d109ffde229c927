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
// What bounds them on the H100: one row is one block, and the main path runs
// one row, so a launch takes as long as the chain of dependent operations
// through its T steps; the bytes (Σθ*, p² entries a step) and the operations
// are orders of magnitude below it.  The design shortens each step's chain:
//   - K15 factors W in one warp, row i on lane i, each entry's dot product
//     accumulated in order k = 0 … j−1 as its columns finish; every lane
//     takes each pivot itself from operands broadcast a column ahead, so a
//     column costs the pivot's last product, its square root and reciprocal
//     (PivotOps, pivot.cuh: the library's bits without its slow-path
//     branches).  The factor stays in registers until it is sanitized; L⁻¹
//     runs a lane per column with that column in registers, MᵀM a lane per
//     column over four warps, μθ* a lane per row, the correction blocks a
//     lane per block, the value recursion a lane per entry.
//   - The other three warps form W (an entry a lane) once the value carry
//     is in, then stage the streams two steps ahead (cp.async into a
//     three-stage ring in shared memory) and form the next step's joint
//     moments while warp 0 factors.
//   - The constant term v0 of the value carry, and the sums only it reads,
//     are dropped: no output reads it.
//   - K16 carries only (μ, Σ) from step to step.  The 6 × 6 factor of the
//     (x, u) covariance (warp 0) runs beside the central form Zm, Qmu and
//     its dx factor (warps 1–3); Bk and Qk take a lane per (point, i, j),
//     each point's factor a lane, the reduction a lane per output entry in
//     the order 0 … 2·daug−1.  Warps 2–3 stage Σθ* two steps ahead once
//     their share of the central form is done (issued by warp 0, the copies
//     held up its moments by about 1,700 cycles a step on the H100).  The
//     per-step KL and interpolation run after the walk, a thread per step,
//     on the carries the walk left in the q_new outputs.
// Sums run in the TPU kernels' order and the build uses -fmad=false, so the
// float64 build equals the plain PyTorch versions (core/cuda_rgps.py) to
// rounding and the float32 build equals them exactly at the main path's
// shapes (chip_smoke.py holds both).
#include <cuda_runtime.h>

#include "pivot.cuh"
#include "ring.cuh"
#include "scalar.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
        L[j][j] = PivotOps::sqrt(s);
        inv_d[j] = PivotOps::rcp(L[j][j]);
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

// Shared-memory block views as matrices.
template <typename S, int R, int C>
__device__ __forceinline__ void read(const S* p, S (&M)[R][C]) {
  for (int i = 0; i < R; ++i)
    for (int j = 0; j < C; ++j) M[i][j] = p[i * C + j];
}
template <typename S, int R>
__device__ __forceinline__ void read(const S* p, S (&x)[R]) {
  for (int i = 0; i < R; ++i) x[i] = p[i];
}

// An element copy from device memory to shared memory (cp.async, 4 or 8
// bytes: a row's entries of a (steps, entries, N) stream are N apart).
template <typename S>
__device__ __forceinline__ void cp_async_elem(S* dst, const S* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(sizeof(S))
               : "memory");
}

// Close this thread's group of copies; wait until all its groups but the
// newest have landed.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Step t of a (steps, entries, N) stream, row n, into dst (16-byte aligned),
// by `count` threads from thread `first` on: 16 bytes a copy where the step's
// entries lie together (N = 1) and fill whole 16-byte pieces, else an entry.
template <typename S>
__device__ __forceinline__ void stage_stream(S* dst, const S* __restrict__ p, int t, int entries,
                                             int n, int N, int first, int count) {
  constexpr int V = 16 / sizeof(S);
  const S* src = p + (size_t)t * entries * N + n;
  if (N == 1 && entries % V == 0 && (size_t)src % 16 == 0) {
    for (int e = first * V; e < entries; e += count * V) cp_async16(dst + e, src + e);
  } else {
    for (int e = first; e < entries; e += count) cp_async_elem(dst + e, src + (size_t)e * N);
  }
}

constexpr int THREADS_K15 = 128;
constexpr int THREADS_K16 = 128;
constexpr int kK15Stages = 3;

// One step's operands of K15 in shared memory: the streams, and the joint
// moments formed from them.
template <typename S, int DX, int DU>
struct K15Stage {
  static constexpr int P1 = DX + DU + 1, P = DX * P1;
  alignas(16) S acpp[P * P];
  alignas(16) S acp[P];
  alignas(16) S Cxx[DX * DX];
  alignas(16) S cx[DX];
  alignas(16) S Cuu[DU * DU];
  alignas(16) S cu[DU];
  alignas(16) S Cxu[DX * DU];
  alignas(16) S K[DU * DX];
  alignas(16) S kff[DU];
  alignas(16) S Sc[DU * DU];
  alignas(16) S qmu[DX];
  alignas(16) S qsig[DX * DX];
  S Mz[P1 * P1], mu_z[P1];
};

// Stage step t's streams (the ones K15 reads): issue the copies.
template <typename S, int DX, int DU>
__device__ void k15_stage(K15Stage<S, DX, DU>& st, const S* cxx, const S* cx, const S* cuu,
                          const S* cu, const S* cxu, const S* acpp, const S* acp, const S* Kp,
                          const S* kffp, const S* sigc, const S* qmu, const S* qsig, int t,
                          int n, int N, int first, int count) {
  constexpr int P = K15Stage<S, DX, DU>::P;
  stage_stream(st.acpp, acpp, t, P * P, n, N, first, count);
  stage_stream(st.acp, acp, t, P, n, N, first, count);
  stage_stream(st.Cxx, cxx, t, DX * DX, n, N, first, count);
  stage_stream(st.cx, cx, t, DX, n, N, first, count);
  stage_stream(st.Cuu, cuu, t, DU * DU, n, N, first, count);
  stage_stream(st.cu, cu, t, DU, n, N, first, count);
  stage_stream(st.Cxu, cxu, t, DX * DU, n, N, first, count);
  stage_stream(st.K, Kp, t, DU * DX, n, N, first, count);
  stage_stream(st.kff, kffp, t, DU, n, N, first, count);
  stage_stream(st.Sc, sigc, t, DU * DU, n, N, first, count);
  stage_stream(st.qmu, qmu, t, DX, n, N, first, count);
  stage_stream(st.qsig, qsig, t, DX * DX, n, N, first, count);
}

// Mz = μz μzᵀ + Sz and μz from a staged step (one thread).
template <typename S, int DX, int DU>
__device__ void k15_moments(K15Stage<S, DX, DU>& st) {
  constexpr int P1 = DX + DU + 1;
  S mu_x[DX], Sx[DX][DX], K[DU][DX], kff[DU], Sc[DU][DU], mu_u[DU], Sz[P1][P1];
  read(st.qmu, mu_x);
  read(st.qsig, Sx);
  read(st.K, K);
  read(st.kff, kff);
  read(st.Sc, Sc);
  joint_moments<S, DX, DU, P1>(mu_x, Sx, K, kff, Sc, mu_u, Sz);
  S mu_z[P1];
  for (int i = 0; i < DX; ++i) mu_z[i] = mu_x[i];
  for (int a = 0; a < DU; ++a) mu_z[DX + a] = mu_u[a];
  mu_z[P1 - 1] = S(1);
  for (int a = 0; a < P1; ++a) {
    st.mu_z[a] = mu_z[a];
    for (int b = 0; b < P1; ++b) st.Mz[a * P1 + b] = mu_z[a] * mu_z[b] + Sz[a][b];
  }
}

// W = ½(X + Xᵀ), X = 2(agCpp + kron(Mz, V'))/(β+η): its lower triangle into
// Wsh (rows of P + 1), an entry a lane of warps 1–3, while warp 0 waits.
template <typename S, int DX, int DU, int COUNT>
__device__ void k15_precision(const K15Stage<S, DX, DU>& st, const S* V, S inv_bpe, S* Wsh,
                              int first) {
  constexpr int P1 = DX + DU + 1, P = DX * P1;
#pragma unroll
  for (int it = 0; it < (P * P + COUNT - 1) / COUNT; ++it) {
    const int e = first + it * COUNT;
    const int r = e / P, c = e % P;
    if (e < P * P && c <= r) {
      const int a = r / DX, ii = r % DX, b = c / DX, jj = c % DX;
      const S xrc = S(2) * (st.acpp[r * P + c] + st.Mz[a * P1 + b] * V[ii * DX + jj]) * inv_bpe;
      const S xcr = S(2) * (st.acpp[c * P + r] + st.Mz[b * P1 + a] * V[jj * DX + ii]) * inv_bpe;
      Wsh[r * (P + 1) + c] = S(0.5) * (xrc + xcr);
    }
  }
}

// The Cholesky factor of W (Wsh), row i on lane i in registers (L, and its
// diagonal entry in diag).  Column j: lane i takes L[i][j] = s·(1/d_j) from
// s = W[i][j] less its dot product, publishes it, and adds L[i][j]·L[k][j] to
// the dot products of the entries k > j still to come, in the order j = 0,
// 1, ….  Every lane takes each pivot d_j itself, from row j's partial sum of
// squares and its entry (j, j − 1) less its dot product, broadcast from lane
// j a column ahead; the pivot of column j + 1 and the updates of column j
// form one stretch of independent work between two warp synchronisations.
template <typename S, int P>
__device__ __forceinline__ void k15_cholesky(const S* Wsh, int lane, S* col, S (&L)[P], S& diag) {
  constexpr int WS = P + 1;
  const int i = lane < P ? lane : P - 1;   // lanes past P repeat row P − 1
  const S* Wi = Wsh + i * WS;
  S acc[P], accd = S(0);
  S s = Wi[0];                             // entry (i, j) less its dot product
  S dj = PivotOps::sqrt(Wsh[0]);           // the pivot of column j
  S invj = PivotOps::rcp(dj);
  S an = S(0), bn = __shfl_sync(kFull, s, 1);   // row j + 1's partial sum and entry (j + 1, j)
  diag = S(0);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const S l = i > j ? s * invj : (i == j ? dj : S(0));
    diag = i == j ? dj : diag;
    L[j] = l;
    col[j * 32 + lane] = l;
    __syncwarp();
    S dn = S(0), invn = S(0);
    if (j + 1 < P) {
      const S ln = bn * invj;
      const S sq = ln * ln;
      const S sp = Wsh[(j + 1) * (WS + 1)] - (j == 0 ? sq : an + sq);
      dn = PivotOps::sqrt(sp);
      invn = PivotOps::rcp(dn);
    }
    const S sq = l * l;
    accd = j == 0 ? sq : accd + sq;
#pragma unroll
    for (int k = j + 1; k < P; ++k) {
      const S pr = l * col[j * 32 + k];
      acc[k] = j == 0 ? pr : acc[k] + pr;
    }
    if (j + 1 < P) s = Wi[j + 1] - acc[j + 1];
    if (j + 2 < P) {
      an = __shfl_sync(kFull, accd, j + 2);
      bn = __shfl_sync(kFull, s, j + 2);
    }
    dj = dn;
    invj = invn;
  }
}

// K15's dependent chain, warp 0: the factor, the entrywise sanitize, and
// L⁻¹ a column a lane.  Writes L⁻¹ (Msh, rows of P) and w (wsh); returns
// whether any entry was sanitized.
template <typename S, int DX, int DU>
__device__ bool k15_factor(const K15Stage<S, DX, DU>& st, S* Wsh, const S* v, S inv_bpe,
                           int lane, S* invs, S* Msh, S* col, S* wsh) {
  constexpr int P1 = DX + DU + 1, P = DX * P1;
  const int i = lane < P ? lane : P - 1;
  if (lane < P) wsh[i] = -(st.acp[i] + st.mu_z[i / DX] * v[i % DX]) * inv_bpe;

  S L[P], diag;
  k15_cholesky<S, P>(Wsh, lane, col, L, diag);
  __syncwarp();
  S* Lsh = Wsh;

  // entrywise sanitize of row i, then the factor and 1/diag into shared
  // memory (Lsh: rows of P, over W, which is done with)
  bool bad = false;
#pragma unroll
  for (int c = 0; c < P; ++c)
    if (c <= i && !finite_(L[c])) {
      L[c] = c == i ? S(1) : S(0);
      bad = true;
    }
  bad = __any_sync(kFull, bad && lane < P);
  if (lane < P) {
    invs[i] = PivotOps::rcp(finite_(diag) ? diag : S(1));
#pragma unroll
    for (int c = 0; c < P; ++c) Lsh[i * P + c] = L[c];
  }
  __syncwarp();

  // M = L⁻¹, column j on lane j: Mc[e] = M[j + e][j] (rows past P − 1 are
  // read at row P − 1 and dropped)
  const int j = i;
  S Mc[P];
  Mc[0] = invs[j];
#pragma unroll
  for (int dd = 0; dd < P - 1; ++dd) {
    const int r = j + 1 + dd < P ? j + 1 + dd : P - 1;
    const S* Lr = Lsh + r * P + j;   // L[j + 1 + dd][j + e]
    S m = Lr[0] * Mc[0];
#pragma unroll
    for (int e = 1; e <= dd; ++e) m = m + Lr[e] * Mc[e];
    Mc[dd + 1] = -m * invs[r];
  }
  if (lane < P) {
#pragma unroll
    for (int e = 0; e < P; ++e)
      if (j + e < P) Msh[(j + e) * P + j] = Mc[e];
  }
  return bad;
}

// Σθ* = MᵀM for the columns j ≡ J0 (mod NW): lane i holds column i of M, and
// entry (i, j ≥ i) sums M[k][i]·M[k][j] over k = j … P − 1.  Into Sg (rows of
// P + 1).
template <int J0, int NW, typename S, int P>
__device__ __forceinline__ void k15_mtm(const S* Msh, S* Sg, int lane) {
  const int i = lane < P ? lane : P - 1;
  S Mcol[P];
#pragma unroll
  for (int k = 0; k < P; ++k) Mcol[k] = Msh[k * P + i];
#pragma unroll
  for (int j = J0; j < P; j += NW) {
    S acc = Mcol[j] * Msh[j * P + j];
#pragma unroll
    for (int k = j + 1; k < P; ++k) acc = acc + Mcol[k] * Msh[k * P + j];
    if (lane <= j) {
      Sg[lane * (P + 1) + j] = acc;
      Sg[j * (P + 1) + lane] = acc;
    }
  }
}

// K15's value recursion on warp 0, a lane per entry: V', v' of the step
// before from A, B, c (μθ*), the correction blocks Pc and the staged blocks.
// The constant term is left out: no output reads it.
template <typename S, int DX, int DU>
__device__ void k15_value(const K15Stage<S, DX, DU>& st, const S* mu_opt, const S* Pc, S* V,
                          S* v, S* scr, int lane) {
  constexpr int P1 = DX + DU + 1;
  S* Acl = scr;                     // DX × DX
  S* ccl = Acl + DX * DX;           // DX
  S* KtmC = ccl + DX;               // DX × DU
  S* VAcl = KtmC + DX * DU;         // DX × DX
  S* Vc = VAcl + DX * DX;           // DX
  S* Vraw = Vc + DX;                // DX × DX
  S* vn = Vraw + DX * DX;           // DX
  auto A = [&](int r, int c) { return mu_opt[c * DX + r]; };
  auto B = [&](int r, int c) { return mu_opt[(DX + c) * DX + r]; };
  auto K = [&](int r, int c) { return st.K[r * DX + c]; };
  auto mCxuP = [&](int r, int c) { return -st.Cxu[r * DU + c] + Pc[r * P1 + DX + c]; };

  if (lane < DX * DX) {
    const int r = lane / DX, c = lane % DX;
    S acc = B(r, 0) * K(0, c);
    for (int q = 1; q < DU; ++q) acc = acc + B(r, q) * K(q, c);
    Acl[lane] = A(r, c) + acc;
  } else if (lane < DX * DX + DX) {
    const int r = lane - DX * DX;
    S acc = B(r, 0) * st.kff[0];
    for (int q = 1; q < DU; ++q) acc = acc + B(r, q) * st.kff[q];
    ccl[r] = mu_opt[(DX + DU) * DX + r] + acc;
  } else if (lane < DX * DX + DX + DX * DU) {
    const int e = lane - DX * DX - DX, r = e / DU, q = e % DU;
    auto mCuuP = [&](int x, int y) { return -st.Cuu[x * DU + y] + Pc[(DX + x) * P1 + DX + y]; };
    S acc = K(0, r) * mCuuP(0, q);
    for (int x = 1; x < DU; ++x) acc = acc + K(x, r) * mCuuP(x, q);
    KtmC[e] = acc;
  }
  __syncwarp();
  if (lane < DX * DX) {
    const int r = lane / DX, c = lane % DX;
    S acc = V[r * DX] * Acl[c];
    for (int q = 1; q < DX; ++q) acc = acc + V[r * DX + q] * Acl[q * DX + c];
    VAcl[lane] = acc;
  } else if (lane < DX * DX + DX) {
    const int r = lane - DX * DX;
    S acc = V[r * DX] * ccl[0];
    for (int q = 1; q < DX; ++q) acc = acc + V[r * DX + q] * ccl[q];
    Vc[r] = acc;
  }
  __syncwarp();
  if (lane < DX * DX) {
    const int r = lane / DX, c = lane % DX;
    S k1 = KtmC[r * DU] * K(0, c);
    for (int q = 1; q < DU; ++q) k1 = k1 + KtmC[r * DU + q] * K(q, c);
    S k2 = Acl[r] * VAcl[c];
    for (int q = 1; q < DX; ++q) k2 = k2 + Acl[q * DX + r] * VAcl[q * DX + c];
    S k3 = mCxuP(r, 0) * K(0, c);
    for (int q = 1; q < DU; ++q) k3 = k3 + mCxuP(r, q) * K(q, c);
    Vraw[lane] = (((-st.Cxx[lane] + Pc[r * P1 + c]) + k1) + k2) + S(2) * k3;
  } else if (lane < DX * DX + DX) {
    const int r = lane - DX * DX;
    auto mcu = [&](int q) { return -st.cu[q] + S(2) * Pc[(DX + q) * P1 + P1 - 1]; };
    S k1 = KtmC[r * DU] * st.kff[0], k2 = mCxuP(r, 0) * st.kff[0];
    for (int q = 1; q < DU; ++q) {
      k1 = k1 + KtmC[r * DU + q] * st.kff[q];
      k2 = k2 + mCxuP(r, q) * st.kff[q];
    }
    S k3 = K(0, r) * mcu(0);
    for (int q = 1; q < DU; ++q) k3 = k3 + K(q, r) * mcu(q);
    S k4 = Acl[r] * Vc[0], k5 = Acl[r] * v[0];
    for (int q = 1; q < DX; ++q) {
      k4 = k4 + Acl[q * DX + r] * Vc[q];
      k5 = k5 + Acl[q * DX + r] * v[q];
    }
    vn[r] = (((((-st.cx[r] + S(2) * Pc[r * P1 + P1 - 1]) + S(2) * k1) + S(2) * k2) + k3) +
             S(2) * k4) + k5;
  }
  __syncwarp();
  if (lane < DX * DX) {
    const int r = lane / DX, c = lane % DX;
    V[lane] = S(0.5) * (Vraw[lane] + Vraw[c * DX + r]);
  } else if (lane < DX * DX + DX) {
    v[lane - DX * DX] = vn[lane - DX * DX];
  }
  __syncwarp();
}

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
  // c0, cuun, sigd and v0T feed only the value carry's constant term, which
  // no output reads: they stay in the interface and are not read.
  constexpr int P1 = DX + DU + 1;
  constexpr int P = DX * P1;
  constexpr int SS = P + 1;   // Σθ*'s row stride
  constexpr int PRODUCERS = THREADS_K15 - 32;
  using Stage = K15Stage<S, DX, DU>;
  // Named barriers: 1 the producers, 2 warps 0 and 1 (the correction
  // blocks), 3 V' ready and the last step's slot free (warp 0 arrives, the
  // producers wait), 4 W ready (the producers arrive, warp 0 waits).
  __shared__ Stage stage[kK15Stages];
  __shared__ S Wsh[P * SS];                  // W, the factor, then Σθ*
  __shared__ S Msh[P * (P > 32 ? P : 32)];   // the factor's columns, then L⁻¹
  __shared__ S invs[P], wsh[P], mu_opt[P], Pc[P1 * P1];
  __shared__ S V[DX * DX], v[DX], scr[3 * DX * DX + 3 * DX + DX * DU];
  S* Sg = Wsh;
  S* col = Msh;

  const int n = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const S inv_bpe = S(1) / bpe[n];
  if (T <= 0) {
    if (tid == 0) bad_out[n] = 0;
    return;
  }
  // steps T − 1 and T − 2 staged before the walk; step t − 2 once step t + 1
  // is done with its slot
  for (int t = T - 1; t >= 0 && t >= T - 2; --t)
    k15_stage(stage[t % kK15Stages], cxx, cx, cuu, cu, cxu, acpp, acp, Kp, kffp, sigc, qmu, qsig,
              t, n, N, tid, THREADS_K15);
  cp_async_wait_all();
  if (tid == 0) {
    for (int e = 0; e < DX * DX; ++e) V[e] = vT[e * N + n];
    for (int e = 0; e < DX; ++e) v[e] = vvT[e * N + n];
  }
  __syncthreads();
  if (tid == 0) k15_moments(stage[(T - 1) % kK15Stages]);
  __syncthreads();

  bool bad = false;   // warp 0's running flag
  if (warp == 0) named_arrive<THREADS_K15>(3);
  for (int t = T - 1; t >= 0; --t) {
    const Stage& st = stage[t % kK15Stages];
    if (warp == 0) {
      named_sync<THREADS_K15>(4);
      bad = k15_factor<S, DX, DU>(st, Wsh, v, inv_bpe, lane, invs, Msh, col, wsh) || bad;
    } else {
      // the producers: W, then step t − 2's streams and step t − 1's moments
      named_sync<THREADS_K15>(3);
      k15_precision<S, DX, DU, PRODUCERS>(st, V, inv_bpe, Wsh, tid - 32);
      named_arrive<THREADS_K15>(4);
      if (t >= 2)
        k15_stage(stage[(t - 2) % kK15Stages], cxx, cx, cuu, cu, cxu, acpp, acp, Kp, kffp, sigc,
                  qmu, qsig, t - 2, n, N, tid - 32, PRODUCERS);
      cp_async_commit();
      if (t >= 1) {
        cp_async_wait_but_newest();
        named_sync<PRODUCERS>(1);
        if (tid == 32) k15_moments(stage[(t - 1) % kK15Stages]);
      }
    }
    __syncthreads();

    // Σθ* = MᵀM, warp w the columns j ≡ w (mod 4)
    static_assert(THREADS_K15 == 128, "MᵀM takes four warps");
    if (warp == 0) k15_mtm<0, 4, S, P>(Msh, Sg, lane);
    else if (warp == 1) k15_mtm<1, 4, S, P>(Msh, Sg, lane);
    else if (warp == 2) k15_mtm<2, 4, S, P>(Msh, Sg, lane);
    else k15_mtm<3, 4, S, P>(Msh, Sg, lane);
    __syncthreads();

    if (warp == 0) {
      if (lane < P) {   // μθ* = Σθ* w (Σθ* symmetric: row r read as column r)
        S acc = Sg[lane] * wsh[0];
        for (int c = 1; c < P; ++c) acc = acc + Sg[c * SS + lane] * wsh[c];
        mu_opt[lane] = acc;
        muopt[((size_t)t * P + lane) * N + n] = acc;
      }
    } else if (warp == 1) {
      // correction blocks Pc[a][b] = tr(Σθ*_block[a, b] V')
      for (int e = lane; e < P1 * P1; e += 32) {
        const int a = e / P1, b = e % P1;
        S acc = Sg[(a * DX) * SS + b * DX] * V[0];
        for (int q = 1; q < DX * DX; ++q) {
          const int ii = q / DX, jj = q % DX;
          acc = acc + Sg[(a * DX + ii) * SS + b * DX + jj] * V[jj * DX + ii];
        }
        Pc[e] = acc;
      }
    } else {
      // the step's Σθ* stream, off the chain
      S* so = sigopt + (size_t)t * P * P * N + n;
      for (int e = tid - 64; e < P * P; e += THREADS_K15 - 64)
        so[(size_t)e * N] = Sg[(e / P) * SS + e % P];
    }
    if (warp < 2) named_sync<64>(2);
    if (warp == 0) {
      k15_value<S, DX, DU>(st, mu_opt, Pc, V, v, scr, lane);
      if (t > 0) named_arrive<THREADS_K15>(3);
    }
  }
  if (tid == 0) bad_out[n] = bad ? 1 : 0;
}

// One step's operands of K16 in shared memory.
template <typename S, int DX, int DU>
struct K16Stage {
  static constexpr int P = DX * (DX + DU + 1);
  alignas(16) S S4[P * P];   // Σθ*, (a, i, b, j) at (a·DX+i)·P + b·DX+j
  alignas(16) S th[P];
  alignas(16) S sd[DX * DX];
  alignas(16) S K[DU * DX];
  alignas(16) S kff[DU];
  alignas(16) S Sc[DU * DU];
};

template <typename S, int DX, int DU>
__device__ void k16_stage(K16Stage<S, DX, DU>& st, const S* muopt, const S* sigopt,
                          const S* sigd, const S* Kp, const S* kffp, const S* sigc, int t, int n,
                          int N, int first, int count) {
  constexpr int P = K16Stage<S, DX, DU>::P;
  stage_stream(st.S4, sigopt, t, P * P, n, N, first, count);
  stage_stream(st.th, muopt, t, P, n, N, first, count);
  stage_stream(st.sd, sigd, t, DX * DX, n, N, first, count);
  stage_stream(st.K, Kp, t, DU * DX, n, N, first, count);
  stage_stream(st.kff, kffp, t, DU, n, N, first, count);
  stage_stream(st.Sc, sigc, t, DU * DU, n, N, first, count);
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
  constexpr int D2 = DX * DX;
  using Stage = K16Stage<S, DX, DU>;
  __shared__ Stage stage[3];
  __shared__ S mu[DX], Sg[D2];                    // the carry
  __shared__ S Lxu[NXU * NXU], mu_z[P1], f_c[DX];
  __shared__ S Zm[P1 * D2], Qmu[D2], LcC[D2], rowsumC[DX];
  __shared__ S Bk[NXU * D2], Qk[NXU * D2], dfk[NXU * DX];
  __shared__ S outs[NPTS * DX];

  const int n = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32;
  const double s = sqrt((double)DAUG);
  const S ss = S(s * s), inv_pts = S(1.0 / NPTS);

  if (tid < DX) {
    mu[tid] = mu0[tid * N + n];
    qnmu[tid * N + n] = mu[tid];
  }
  if (tid < D2) {
    Sg[tid] = sig0[tid * N + n];
    qnsig[tid * N + n] = Sg[tid];
  }
  // steps 0 and 1 staged before the walk, step t + 2 during step t
  for (int t = 0; t < T && t < 2; ++t)
    k16_stage(stage[t], muopt, sigopt, sigd, Kp, kffp, sigc, t, n, N, tid, THREADS_K16);
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const Stage& st = stage[t % 3];

    if (warp == 0) {
      if (tid == 0) {
        // the (x, u) moments, their 6 × 6 factor, μz and the central mean
        S m[DX], Sx[DX][DX], K[DU][DX], kff[DU], Sc[DU][DU], mu_u[DU], Sxu[NXU][NXU];
        S L[NXU][NXU], idl[NXU];
        read(mu, m);
        read(Sg, Sx);
        read(st.K, K);
        read(st.kff, kff);
        read(st.Sc, Sc);
        joint_moments<S, DX, DU, NXU>(m, Sx, K, kff, Sc, mu_u, Sxu);
        chol_nan<S, NXU>(Sxu, L, idl);
        for (int i = 0; i < NXU; ++i)
          for (int j = 0; j < NXU; ++j) Lxu[i * NXU + j] = L[i][j];
        for (int i = 0; i < DX; ++i) mu_z[i] = m[i];
        for (int a = 0; a < DU; ++a) mu_z[DX + a] = mu_u[a];
        mu_z[P1 - 1] = S(1);
        for (int ii = 0; ii < DX; ++ii) {
          S a1 = st.th[ii] * m[0];
          for (int j = 1; j < DX; ++j) a1 = a1 + st.th[j * DX + ii] * m[j];
          S a2 = st.th[DX * DX + ii] * mu_u[0];
          for (int j = 1; j < DU; ++j) a2 = a2 + st.th[(DX + j) * DX + ii] * mu_u[j];
          f_c[ii] = (a1 + a2) + st.th[(DX + DU) * DX + ii];
        }
      }
    } else {
      // the central quadratic form Zm[a][i][j] = Σ_b μz_b S4[a, i, b, j]
      S mz[P1];
      for (int i = 0; i < DX; ++i) mz[i] = mu[i];
      for (int a = 0; a < DU; ++a) {
        S acc = st.K[a * DX] * mu[0];
        for (int j = 1; j < DX; ++j) acc = acc + st.K[a * DX + j] * mu[j];
        mz[DX + a] = acc + st.kff[a];
      }
      mz[P1 - 1] = S(1);
      for (int e = tid - 32; e < P1 * D2; e += THREADS_K16 - 32) {
        const int a = e / D2, ii = (e / DX) % DX, jj = e % DX;
        const S* row = st.S4 + (a * DX + ii) * P + jj;
        S acc = mz[0] * row[0];
        for (int b = 1; b < P1; ++b) acc = acc + mz[b] * row[b * DX];
        Zm[e] = acc;
      }
      named_sync<THREADS_K16 - 32>(1);
      // step t + 2's streams, into the slot step t − 1 is done with
      if (warp >= 2 && t + 2 < T)
        k16_stage(stage[(t + 2) % 3], muopt, sigopt, sigd, Kp, kffp, sigc, t + 2, n, N, tid - 64,
                  THREADS_K16 - 64);
      if (tid == 32) {
        S cov[DX][DX], L[DX][DX], idl[DX], Qm[DX][DX];
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj) {
            S acc = mz[0] * Zm[ii * DX + jj];
            for (int a = 1; a < P1; ++a) acc = acc + mz[a] * Zm[a * D2 + ii * DX + jj];
            Qm[ii][jj] = acc;
            Qmu[ii * DX + jj] = acc;
          }
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj)
            cov[ii][jj] = S(0.5) * ((st.sd[ii * DX + jj] + Qm[ii][jj]) +
                                    (st.sd[jj * DX + ii] + Qm[jj][ii]));
        chol_nan<S, DX>(cov, L, idl);
        for (int ii = 0; ii < DX; ++ii) {
          S acc = L[ii][0];
          for (int jj = 1; jj < DX; ++jj) acc = acc + L[ii][jj];
          rowsumC[ii] = acc;
          for (int jj = 0; jj < DX; ++jj) LcC[ii * DX + jj] = L[ii][jj];
        }
      }
    }
    __syncthreads();

    // Bk, Qk a lane per (k, i, j), each sum from index k on in order (the
    // terms before k skipped by selects, so every loop unrolls); dfk a lane
    // per (k, i)
    if (tid < NXU * D2) {
      const int k = tid / D2, ij = tid % D2, ii = ij / DX, jj = ij % DX;
      const S* lk = Lxu + k;   // lk[a·NXU] = L[a][k]
      S bk = S(0);
#pragma unroll
      for (int a = 0; a < NXU; ++a) {
        const S term = lk[a * NXU] * Zm[a * D2 + ij];
        bk = a == k ? term : (a > k ? bk + term : bk);
      }
      Bk[tid] = bk;
      S qk = S(0);
#pragma unroll
      for (int b = 0; b < NXU; ++b) {
        S yk = S(0);
#pragma unroll
        for (int a = 0; a < NXU; ++a) {
          const S term = lk[a * NXU] * st.S4[(a * DX + ii) * P + b * DX + jj];
          yk = a == k ? term : (a > k ? yk + term : yk);
        }
        const S term = lk[b * NXU] * yk;
        qk = b == k ? term : (b > k ? qk + term : qk);
      }
      Qk[tid] = qk;
    } else if (tid < NXU * D2 + NXU * DX) {
      const int e = tid - NXU * D2, k = e / DX, ii = e % DX;
      S head = S(0), tail = S(0);
      bool has_head = false;
      for (int r = k; r < (NXU < DX ? NXU : DX); ++r) {
        const S term = st.th[r * DX + ii] * Lxu[r * NXU + k];
        head = has_head ? head + term : term;
        has_head = true;
      }
      for (int r = (k > DX ? k : DX); r < NXU; ++r) {
        const S term = st.th[r * DX + ii] * Lxu[r * NXU + k];
        tail = (r == (k > DX ? k : DX)) ? term : tail + term;
      }
      dfk[e] = has_head ? head + tail : tail;
    }
    __syncthreads();

    // one cubature point a lane
    if (tid < NPTS) {
      const int pt = tid;
      S out[DX];
      if (pt < 2 * NXU) {
        const int k = pt / 2;
        const double sg = (pt % 2 == 0) ? 1.0 : -1.0;
        const S* bk = Bk + k * D2;
        const S* qk = Qk + k * D2;
        S craw[DX][DX], cov[DX][DX], L[DX][DX], idl[DX];
        const S cs = S(sg * s);
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj)
            craw[ii][jj] = ((st.sd[ii * DX + jj] + Qmu[ii * DX + jj]) + ss * qk[ii * DX + jj]) +
                           cs * (bk[ii * DX + jj] + bk[jj * DX + ii]);
        for (int ii = 0; ii < DX; ++ii)
          for (int jj = 0; jj < DX; ++jj) cov[ii][jj] = S(0.5) * (craw[ii][jj] + craw[jj][ii]);
        chol_nan<S, DX>(cov, L, idl);
        for (int ii = 0; ii < DX; ++ii) {
          S rows = L[ii][0];
          for (int jj = 1; jj < DX; ++jj) rows = rows + L[ii][jj];
          out[ii] = (f_c[ii] + cs * dfk[k * DX + ii]) + S(0) * rows;
        }
      } else if (pt < 2 * NXU + 2) {
        for (int ii = 0; ii < DX; ++ii) out[ii] = f_c[ii] + S(0) * rowsumC[ii];
      } else {
        const int j = (pt - 2 * NXU - 2) / 2;
        const S cs = S(((pt - 2 * NXU - 2) % 2 == 0 ? 1.0 : -1.0) * s);
        for (int ii = 0; ii < DX; ++ii) out[ii] = f_c[ii] + cs * LcC[ii * DX + j];
      }
      for (int ii = 0; ii < DX; ++ii) outs[pt * DX + ii] = out[ii];
    }
    __syncthreads();

    // the ordered mean and covariance, a lane per entry: the next carry
    if (tid < D2) {
      const int ii = tid / DX, jj = tid % DX;
      S ai = outs[ii], aj = outs[jj];
      for (int q = 1; q < NPTS; ++q) {
        ai = ai + outs[q * DX + ii];
        aj = aj + outs[q * DX + jj];
      }
      const S mi = ai * inv_pts, mj = aj * inv_pts;
      S acc = (outs[ii] - mi) * (outs[jj] - mj);
      for (int q = 1; q < NPTS; ++q) acc = acc + (outs[q * DX + ii] - mi) * (outs[q * DX + jj] - mj);
      Sg[tid] = acc * inv_pts;
      qnsig[((size_t)(t + 1) * D2 + tid) * N + n] = Sg[tid];
      if (jj == 0) {
        mu[ii] = mi;
        qnmu[((size_t)(t + 1) * DX + ii) * N + n] = mi;
      }
    }
    cp_async_commit();
    cp_async_wait_but_newest();
    __syncthreads();
  }

  // KL(p_t ‖ q_t) and q_new at every step, a thread per step, from the
  // carries the walk left in q_new
  for (int t = tid; t <= T; t += THREADS_K16) {
    S m[DX], Sx[DX][DX], qm[DX], qs[DX][DX], mn[DX], Sn[DX][DX];
    for (int i = 0; i < DX; ++i) {
      m[i] = qnmu[((size_t)t * DX + i) * N + n];
      qm[i] = qmu[((size_t)t * DX + i) * N + n];
      for (int j = 0; j < DX; ++j) {
        Sx[i][j] = qnsig[((size_t)t * D2 + i * DX + j) * N + n];
        qs[i][j] = qsig[((size_t)t * D2 + i * DX + j) * N + n];
      }
    }
    kl_out[(size_t)t * N + n] = kl_interp<S, DX>(m, Sx, qm, qs, a_interp, mn, Sn);
    for (int i = 0; i < DX; ++i) {
      qnmu[((size_t)t * DX + i) * N + n] = mn[i];
      for (int j = 0; j < DX; ++j) qnsig[((size_t)t * D2 + i * DX + j) * N + n] = Sn[i][j];
    }
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
