// One regularized iLQR backward step for one instance, unrolled in registers
// (the body of ilqr/src/util.cpp:83-182; counterpart of _bwd_step in
// trajopt_tpu/core/pallas_lqr.py:149), and the staged backward that K4
// (ilqr_backward.cu) and K1 (fused_backward.cu) both run around it.
//
// Sums run in the order of the JAX kernel (index 0 first) so that the f64
// build agrees with the plain versions to rounding.
//
// The staged design.  Only the value carry (V, v, dV, flag) depends on the
// step before; a step's operands (the cost blocks and A, B) do not.  So each
// block takes a group of kGroup instances and splits its warps (ring.cuh):
// warp 0 is the consumer, one lane per instance, and walks t = T−1 … 0
// through staged_chain, reading every operand from shared memory; the
// producer warps run ahead and fill the ring of stages, a chunk of steps
// each (K4 copies its streams with cp.async, K1 computes the linearization
// and the cost blocks there).
// kGroup = 16 makes a batch of 2048 128 blocks on the H100's 132 SMs.  The
// consumer's warp keeps its SM sub-partition's scheduler to itself (the
// producers take the other three), because the chain, about 520 dependent
// operations a step with little to overlap, is what bounds both kernels:
// about 0.41 µs a step on the H100, the same for 8, 16 or 32 lanes.
#pragma once

#include <math.h>

#include <cuda_runtime.h>

#include "pivot.cuh"
#include "ring.cuh"
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
// arithmetic after it stays finite (pallas_lqr.py:99-120).  Pivot: the
// square root and reciprocal of PivotOps (pivot.cuh), the library's bits for
// every pivot without its slow-path branches, for K6's and K8's factors and
// K7's producers'.  K1, K4 (through bwd_step) and K5 keep the library's:
// with PivotOps K1 read 0.17 % slower on its main path's launches and K5
// 0.3–1.9 % at T=1000, though K4 read 7 % and K8 5 % faster (PERF.md).
template <typename S, int N, bool Pivot = false>
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
    if constexpr (Pivot) {
      L[j][j] = PivotOps::sqrt(good ? s : S(1));
      inv_d[j] = PivotOps::rcp(L[j][j]);
    } else {
      L[j][j] = sqrt_(good ? s : S(1));
      inv_d[j] = S(1) / L[j][j];
    }
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

// --------------------------------------------------------------------------------------
// The staged backward (K1, K4)
// --------------------------------------------------------------------------------------

constexpr int kGroup = 16;   // instances per block, one consumer lane each
constexpr int kChunk = 16;   // steps per stage

// Entry offsets of one step's operands in a stage.  A stage holds kChunk
// steps; entry e of step slot s of lane g sits at [(s·E + e)·kGroup + g], so
// the consumer's 16 lanes read 16 neighbouring words.
template <int DX, int DU>
struct StepSlot {
  static constexpr int A = 0, B = A + DX * DX, CXX = B + DX * DU, CX = CXX + DX * DX,
                       CUU = CX + DX, CU = CUU + DU * DU, CXU = CU + DU, E = CXU + DX * DU;
};

// The block of a staged backward whose producer runs kWarps producer warps:
// warp 0 is the consumer, and the producers leave its sub-partition to it.
template <class Producer>
using Staged = WarpRoles<1, Producer::kWarps>;

// Chunk k (of kChunk steps) of a horizon of T steps walked backward: its
// first (latest) step and its length.
__device__ __forceinline__ void chunk_span(int k, int T, int& t_hi, int& steps) {
  t_hi = T - 1 - k * kChunk;
  steps = t_hi + 1 < kChunk ? t_hi + 1 : kChunk;
}

// The carry-dependent chain over one staged chunk, for the instance of lane
// g: steps t_hi, t_hi − 1, …, t_hi − steps + 1, each reading its operands
// from the stage and writing K (T, du·dx, Np) and kff (T, du, Np).
template <typename S, int DX, int DU>
__device__ __forceinline__ void staged_chain(
    const S* __restrict__ stage, int g, int t_hi, int steps, S (&V)[DX][DX], S (&v)[DX],
    S& dv0, S& dv1, bool& bad, S lam, int reg, S* __restrict__ K_out,
    S* __restrict__ kff_out, size_t np, int n) {
  using L = StepSlot<DX, DU>;
  for (int s = 0; s < steps; ++s) {
    const S* op = stage + s * L::E * kGroup + g;
    S Cxx[DX][DX], cx[DX], Cuu[DU][DU], cu[DU], Cxu[DX][DU], A[DX][DX], B[DX][DU];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) {
        A[i][j] = op[(L::A + i * DX + j) * kGroup];
        Cxx[i][j] = op[(L::CXX + i * DX + j) * kGroup];
      }
#pragma unroll
      for (int j = 0; j < DU; ++j) {
        B[i][j] = op[(L::B + i * DU + j) * kGroup];
        Cxu[i][j] = op[(L::CXU + i * DU + j) * kGroup];
      }
      cx[i] = op[(L::CX + i) * kGroup];
    }
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DU; ++j) Cuu[i][j] = op[(L::CUU + i * DU + j) * kGroup];
      cu[i] = op[(L::CU + i) * kGroup];
    }

    S K[DU][DX], kff[DU];
    bwd_step<S, DX, DU>(Cxx, cx, Cuu, cu, Cxu, A, B, V, v, dv0, dv1, bad, lam, reg, K, kff);

    const size_t t = t_hi - s;
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) K_out[(t * DU * DX + i * DX + j) * np + n] = K[i][j];
      kff_out[(t * DU + i) * np + n] = kff[i];
    }
  }
}

// The block body of K1 and K4: block b takes instances kGroup·b … kGroup·b +
// kGroup − 1 (Np is a multiple of kGroup).  Producer supplies kWarps and
//   terminal(n, V, v)  the value at T for instance n (consumer lane);
//   fill(stage, t_hi, steps, n0, tid)  stage a chunk's operands, as producer
//     thread tid of 32·kWarps; they must have landed when fill returns.
template <typename S, int DX, int DU, class Producer>
__device__ __forceinline__ void staged_backward(
    const Producer& prod, const S* __restrict__ lam, S* __restrict__ K_out,
    S* __restrict__ kff_out, S* __restrict__ dV, unsigned char* __restrict__ bad_out, int T,
    int Np, int reg) {
  using G = Staged<Producer>;
  constexpr int STAGE = kChunk * StepSlot<DX, DU>::E * kGroup;   // elements
  extern __shared__ __align__(16) unsigned char staged_smem[];
  S* ring = reinterpret_cast<S*>(staged_smem);
  const int n0 = blockIdx.x * kGroup;
  const int chunks = (T + kChunk - 1) / kChunk;
  const size_t np = Np;
  const int warp = threadIdx.x / 32;

  if (warp == 0) {
    const int g = threadIdx.x;
    const bool live = g < kGroup;
    const int n = n0 + g;
    S V[DX][DX], v[DX], dv0 = S(0), dv1 = S(0), l = S(0);
    bool bad = false;
    if (live) {
      prod.terminal(n, V, v);
      l = lam[n];
    }
    for (int k = 0; k < chunks; ++k) {
      const int st = k % kStages;
      int t_hi, steps;
      chunk_span(k, T, t_hi, steps);
      ring_acquire<G::kBarrier>(k);
      if (live)
        staged_chain<S, DX, DU>(ring + st * STAGE, g, t_hi, steps, V, v, dv0, dv1, bad, l, reg,
                                K_out, kff_out, np, n);
      ring_release<G::kBarrier>(k, chunks);
    }
    if (live) {
      dV[n] = dv0;
      dV[np + n] = dv1;
      bad_out[n] = bad ? 1 : 0;
    }
  } else {
    if (G::idle(warp)) return;   // warp 0's sub-partition stays the consumer's
    const int tid = G::producer(warp) * 32 + threadIdx.x % 32;
    for (int k = 0; k < chunks; ++k) {
      const int st = k % kStages;
      int t_hi, steps;
      chunk_span(k, T, t_hi, steps);
      ring_reserve<G::kBarrier>(k);
      prod.fill(ring + st * STAGE, t_hi, steps, n0, tid);
      ring_publish<G::kBarrier>(k);
    }
  }
}

// Launch a staged backward over Np instances (the CUDA error, or −1 when Np
// is not a whole number of groups).
template <typename S, int DX, int DU, class Producer, typename Kernel, typename... Args>
__host__ int launch_staged(Kernel kernel, int Np, cudaStream_t stream, Args... args) {
  if (Np % kGroup != 0) return -1;
  const int bytes = (int)sizeof(S) * kStages * kChunk * StepSlot<DX, DU>::E * kGroup;
  return launch_ring(kernel, dim3(Np / kGroup), Staged<Producer>::kThreads, bytes, stream,
                     args...);
}
