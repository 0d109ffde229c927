// K5: single-problem parallel-in-time iLQR backward pass (λ folded into Cuu
// by the caller), in one launch.
//
// Replaces trajopt_tpu/core/pallas_pscan.py::_pscan_kernel (wrappers
// pallas_pilqr_backward / pallas_pilqr_backward_reg).  It computes that
// kernel's _pscan_compute: the Särkkä/García-Fernández value elements of all
// T+1 positions (terminal element at T), ⌈log₂(T+1)⌉ doubling levels
// S_t ← S_t ⊗ S_{t+d} of the suffix scan (core/pscan_lqr.py's combine, with a
// partial-pivoting Gauss–Jordan inverse, gj_inv.cuh), then the gains from the value one
// step later and the dV pair.  The (8, C) time tiles, lane rolls and sublane
// selects of the TPU kernel are Mosaic plumbing and are not carried over.
//
// What bounds it on the H100: latency, not bytes or operations.  At T=1000,
// dx=4, du=2, float32 it moves about 0.36 MB (inputs read once, gains and
// value written once: ≈ 0.11 µs at 3.35 TB/s) and does about 2·10⁷
// operations (element construction ≈ 600, each of 10 levels ≈ 1400 per
// position, gains ≈ 300: ≈ 0.3 µs at 67 TFLOP/s), both below one launch's
// own latency.  The time is the chain of ⌈log₂(T+1)⌉ dependent levels, each
// a combine (a Gauss–Jordan chain of dx divides and about nine dx×dx
// products) and the exchange of elements between levels.
//
// Two routes, chosen by the wrapper from (T, dx, dtype) alone
// (core/cuda_pscan.py k5_route):
//
// "cluster" (every shape chip_smoke.py and the solvers run): one
// thread-block cluster of C ≤ 16 blocks (launched with cudaLaunchKernelEx;
// 16 is the non-portable size) holds the problem.  Block r owns positions
// r·P … r·P + P − 1, one thread a position (P = ⌈(T+1)/C⌉ ≤ 256), and keeps
// their elements in shared memory, two copies of 3dx² + 2dx entries a
// position (entry-major, so a warp's accesses are consecutive), ping-pong
// between levels.  A thread keeps its own element in registers across the
// levels; at each level it reads its partner t + d from whichever block
// holds it (another block's through distributed shared memory,
// cluster.map_shared_rank), combines, writes its result to the other copy
// and meets the cluster's barrier: no global scratch and no L2 round trip,
// one barrier a level.  The gains read the value at t + 1 the same way.  A
// cluster barrier costs about 850 cycles on the H100 against 128 for a
// block's, and a partner read over DSMEM about 1,000 (PERF.md), so the
// wrapper takes a cluster of one block, which meets __syncthreads() and
// reads its own shared memory, up to 128 positions (the replan, T=100) and
// spreads larger problems over the largest cluster, 16 blocks (a combine
// runs faster beside fewer warps: each larger cluster ran faster at T=200,
// 333 and 1000).  dV is reduced in the order of the one-block kernel below
// (the per-position terms summed by 256 virtual threads as that kernel's
// threads sum them, then its warp and block trees; a cluster of one block
// is that kernel's block), so the outputs are bit for bit those of the
// "global" route.  Every block ends behind a cluster barrier after the last
// remote access.
//
// "global" (shapes past the cluster's capacity): one block of at most 256
// threads; thread tid owns positions tid, tid + blockDim, …, so any T works.
// The elements live in a ping-pong scratch in global memory that the wrapper
// allocates (3dx² + 2dx entries per position, entry-major so a warp's loads
// are coalesced), with __syncthreads() between levels; dV is a block
// reduction.
//
// Blocks are at most 256 threads so that the unrolled combine keeps up to
// 255 registers a thread.  Every small product sums in the order of the JAX
// kernel (index 0 first) and the build uses -fmad=false, so the float64
// build agrees with the plain version (cuda_pscan.pilqr_backward_plain) to
// rounding, and both routes compute the same operations in the same order.
// The pivots' reciprocals (gj_inv's 1 / M[k][k], the element's Cholesky)
// stay the library's: PivotOps::rcp is exact only on the roots of floats and
// on [1, 2), and these pivots meet any float.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bwd_step.cuh"
#include "gj_inv.cuh"

// Threads of a block, either route (so that the combine keeps up to 255
// registers a thread), and so the positions of a cluster route's block.
constexpr int K5_MAX_THREADS = 256;
// The cluster route's largest cluster (8 is the portable size) and a block's
// shared memory (227 KB on the H100).
constexpr int K5_MAX_CLUSTER = 16;
constexpr size_t K5_SMEM_BYTES = 232448;

template <typename S, int DX>
struct Elem {
  S A[DX][DX], b[DX], C[DX][DX], eta[DX], J[DX][DX];
};

template <int DX>
__host__ __device__ constexpr int elem_entries() { return 3 * DX * DX + 2 * DX; }

// Scratch layout: entry k of position t at buf[k * n + t]; entries in the
// order A, b, C, η, J, each row-major.
template <typename S, int DX>
__device__ __forceinline__ void load_elem(const S* __restrict__ buf, int n, int t,
                                          Elem<S, DX>& e) {
  const S* p = buf + t;
  const size_t s = n;
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) e.A[i][j] = p[(i * DX + j) * s];
  p += DX * DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i) e.b[i] = p[i * s];
  p += DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) e.C[i][j] = p[(i * DX + j) * s];
  p += DX * DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i) e.eta[i] = p[i * s];
  p += DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) e.J[i][j] = p[(i * DX + j) * s];
}

template <typename S, int DX>
__device__ __forceinline__ void store_elem(S* __restrict__ buf, int n, int t,
                                           const Elem<S, DX>& e) {
  S* p = buf + t;
  const size_t s = n;
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) p[(i * DX + j) * s] = e.A[i][j];
  p += DX * DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i) p[i * s] = e.b[i];
  p += DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) p[(i * DX + j) * s] = e.C[i][j];
  p += DX * DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i) p[i * s] = e.eta[i];
  p += DX * s;
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) p[(i * DX + j) * s] = e.J[i][j];
}

// The composition identity: A = I, everything else 0.
template <typename S, int DX>
__device__ __forceinline__ void identity_elem(Elem<S, DX>& e) {
#pragma unroll
  for (int i = 0; i < DX; ++i) {
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      e.A[i][j] = i == j ? S(1) : S(0);
      e.C[i][j] = S(0);
      e.J[i][j] = S(0);
    }
    e.b[i] = S(0);
    e.eta[i] = S(0);
  }
}

// o = e1 ⊗ e2, e1 the earlier element (pallas_pscan.py _combine_planes).
template <typename S, int DX>
__device__ __forceinline__ void combine(const Elem<S, DX>& e1, const Elem<S, DX>& e2,
                                        Elem<S, DX>& o) {
  S G[DX][DX], A2G[DX][DX];
  {
    S M[DX][DX];
    mm(e1.C, e2.J, M);
#pragma unroll
    for (int i = 0; i < DX; ++i) M[i][i] = M[i][i] + S(1);
    gj_inv(M, G);
  }
  mm(e2.A, G, A2G);
  mm(A2G, e1.A, o.A);
  {
    S Cn[DX], t[DX], y[DX];
    mv(e1.C, e2.eta, Cn);
#pragma unroll
    for (int k = 0; k < DX; ++k) t[k] = e1.b[k] + Cn[k];
    mv(A2G, t, y);
#pragma unroll
    for (int i = 0; i < DX; ++i) o.b[i] = y[i] + e2.b[i];
  }
  {
    S X[DX][DX], Y[DX][DX];
    mm(A2G, e1.C, X);
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DX; ++j) {
        S s = X[i][0] * e2.A[j][0];
#pragma unroll
        for (int l = 1; l < DX; ++l) s = s + X[i][l] * e2.A[j][l];
        Y[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DX; ++j) o.C[i][j] = S(0.5) * (Y[i][j] + Y[j][i]) + e2.C[i][j];
  }
  {
    S AtGt[DX][DX];  // A1ᵀ Gᵀ
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DX; ++j) {
        S s = e1.A[0][i] * G[j][0];
#pragma unroll
        for (int l = 1; l < DX; ++l) s = s + e1.A[l][i] * G[j][l];
        AtGt[i][j] = s;
      }
    S Jb[DX], t[DX], y[DX];
    mv(e2.J, e1.b, Jb);
#pragma unroll
    for (int k = 0; k < DX; ++k) t[k] = e2.eta[k] - Jb[k];
    mv(AtGt, t, y);
#pragma unroll
    for (int i = 0; i < DX; ++i) o.eta[i] = y[i] + e1.eta[i];
    S X[DX][DX], Y[DX][DX];
    mm(AtGt, e2.J, X);
    mm(X, e1.A, Y);
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DX; ++j) o.J[i][j] = S(0.5) * (Y[i][j] + Y[j][i]) + e1.J[i][j];
  }
}

template <typename S, int N, int M>
__device__ __forceinline__ void load_block(const S* __restrict__ p, S (&X)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) X[i][j] = p[i * M + j];
}

template <typename S, int N>
__device__ __forceinline__ void load_vec(const S* __restrict__ p, S (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = p[i];
}

// The element of step t < T (pallas_pscan.py:185-200; c = 0, delta convention).
template <typename S, int DX, int DU>
__device__ __forceinline__ void make_element(
    const S* __restrict__ Cxx, const S* __restrict__ cx, const S* __restrict__ Cuu,
    const S* __restrict__ cu, const S* __restrict__ Cxu, const S* __restrict__ A_s,
    const S* __restrict__ B_s, int t, Elem<S, DX>& e) {
  S R[DU][DU], r[DU], M[DX][DU], L[DX][DU];
  load_block(Cuu + (size_t)t * DU * DU, R);
  load_vec(cu + (size_t)t * DU, r);
  load_block(Cxu + (size_t)t * DX * DU, M);
  load_block(B_s + (size_t)t * DX * DU, L);

  S Lr[DU][DU], inv_d[DU];
  chol(R, Lr, inv_d);  // K5's guard: a pivot s ≤ 0 or non-finite becomes 1
  S RiMt[DU][DX], RiLt[DU][DX], Rir[DU];
#pragma unroll
  for (int j = 0; j < DX; ++j) {
    S bm[DU], bl[DU], xm[DU], xl[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) {
      bm[i] = M[j][i];
      bl[i] = L[j][i];
    }
    chol_solve(Lr, inv_d, bm, xm);
    chol_solve(Lr, inv_d, bl, xl);
#pragma unroll
    for (int i = 0; i < DU; ++i) {
      RiMt[i][j] = xm[i];
      RiLt[i][j] = xl[i];
    }
  }
  chol_solve(Lr, inv_d, r, Rir);

  S P[DX][DX], p[DX];
  load_block(A_s + (size_t)t * DX * DX, e.A);
  mm(L, RiMt, P);
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) e.A[i][j] = e.A[i][j] - P[i][j];
  mv(L, Rir, p);
#pragma unroll
  for (int i = 0; i < DX; ++i) e.b[i] = -p[i];
  mm(L, RiLt, P);
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) e.C[i][j] = S(0.5) * (P[i][j] + P[j][i]);
  load_block(Cxx + (size_t)t * DX * DX, e.J);
  mm(M, RiMt, P);
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) e.J[i][j] = e.J[i][j] - P[i][j];
  S q[DX];
  load_vec(cx + (size_t)t * DX, q);
  mv(M, Rir, p);
#pragma unroll
  for (int i = 0; i < DX; ++i) e.eta[i] = -(q[i] - p[i]);
}

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // the sum, in lane 0
}

template <typename S>
__device__ __forceinline__ S block_sum(S v, S* __restrict__ sh) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = S(0);
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = sh[lane];
    v = warp_sum(v);
  }
  __syncthreads();
  return v;  // the sum, in thread 0
}

// The operands of one launch.
template <typename S>
struct PscanArgs {
  const S *Cxx, *cx, *Cuu, *cu, *Cxu, *A, *B;
  S *K, *kff, *S_out, *s_out, *dV;
  int T;
};

// The element of position t ≤ T; position T is the terminal element (A = b =
// C = 0, η = −q_T, J = Q_T).
template <typename S, int DX, int DU>
__device__ __forceinline__ void element_at(const PscanArgs<S>& a, int t, Elem<S, DX>& e) {
  if (t < a.T) {
    make_element<S, DX, DU>(a.Cxx, a.cx, a.Cuu, a.cu, a.Cxu, a.A, a.B, t, e);
  } else {
    identity_elem(e);
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      e.A[i][i] = S(0);
      e.eta[i] = -a.cx[(size_t)a.T * DX + i];
#pragma unroll
      for (int j = 0; j < DX; ++j) e.J[i][j] = a.Cxx[((size_t)a.T * DX + i) * DX + j];
    }
  }
}

// The value at t (S = J, s = −η of the scanned element) into S_out and s_out.
template <typename S, int DX>
__device__ __forceinline__ void store_value(const PscanArgs<S>& a, int t, const S (&J)[DX][DX],
                                            const S (&eta)[DX]) {
#pragma unroll
  for (int i = 0; i < DX; ++i) {
#pragma unroll
    for (int j = 0; j < DX; ++j) a.S_out[((size_t)t * DX + i) * DX + j] = J[i][j];
    a.s_out[(size_t)t * DX + i] = -eta[i];
  }
}

// The gains of step t < T from the value (Sn, sn) at t + 1, and the step's
// dV pair (dot(kff, qu), ½·dot(kff, Quu·kff)) (pallas_pscan.py:228-256).
template <typename S, int DX, int DU>
__device__ __forceinline__ void gains_at(const PscanArgs<S>& a, int t, const S (&Sn)[DX][DX],
                                         const S (&sn)[DX], S& term0, S& term1) {
  S R[DU][DU], r[DU], M[DX][DU], F[DX][DX], L[DX][DU];
  load_block(a.Cuu + (size_t)t * DU * DU, R);
  load_vec(a.cu + (size_t)t * DU, r);
  load_block(a.Cxu + (size_t)t * DX * DU, M);
  load_block(a.A + (size_t)t * DX * DX, F);
  load_block(a.B + (size_t)t * DX * DU, L);

  S LtS[DU][DX], Quu[DU][DU], rhs[DU][DX];
  mm_tn(L, Sn, LtS);
  mm(LtS, L, Quu);
#pragma unroll
  for (int i = 0; i < DU; ++i)
#pragma unroll
    for (int j = 0; j < DU; ++j) Quu[i][j] = R[i][j] + Quu[i][j];
  S Lq[DU][DU], inv_q[DU];
  chol(Quu, Lq, inv_q);
  mm(LtS, F, rhs);
#pragma unroll
  for (int j = 0; j < DX; ++j) {
    S b[DU], x[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) b[i] = rhs[i][j] + M[j][i];
    chol_solve(Lq, inv_q, b, x);
#pragma unroll
    for (int i = 0; i < DU; ++i) a.K[((size_t)t * DU + i) * DX + j] = -x[i];
  }
  S Lts[DU], b[DU], x[DU], kff[DU], qu[DU], Qk[DU];
  mv_tn(L, sn, Lts);
#pragma unroll
  for (int i = 0; i < DU; ++i) b[i] = Lts[i] + r[i];
  chol_solve(Lq, inv_q, b, x);
#pragma unroll
  for (int i = 0; i < DU; ++i) {
    kff[i] = -x[i];
    a.kff[(size_t)t * DU + i] = kff[i];
    qu[i] = r[i] + Lts[i];
  }
  mv(Quu, kff, Qk);
  term0 = dot(kff, qu);
  term1 = S(0.5) * dot(kff, Qk);
}

// The threads of the one-block kernel (the "global" route) for T + 1
// positions; the cluster route reduces dV in their order.
__host__ __device__ __forceinline__ int global_threads(int n) {
  return n >= K5_MAX_THREADS ? K5_MAX_THREADS : ((n + 31) / 32) * 32;
}

// Entry offsets of η and J in an element (A, b and C precede η).
template <int DX>
__host__ __device__ constexpr int eta_entry() { return 2 * DX * DX + DX; }

// ---------------------------------------------------------------------------
// Route "global": one block, the elements in a global ping-pong scratch.
// ---------------------------------------------------------------------------

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(K5_MAX_THREADS) pscan_backward_kernel(
    PscanArgs<S> a, S* __restrict__ buf0, S* __restrict__ buf1) {
  const int T = a.T, n = T + 1;

  // 1. elements
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    Elem<S, DX> e;
    element_at<S, DX, DU>(a, t, e);
    store_elem(buf0, n, t, e);
  }
  __syncthreads();

  // 2. the suffix scan: S_t ← S_t ⊗ S_{t+d}; a partner past T is the identity
  S* src = buf0;
  S* dst = buf1;
  for (int d = 1; d < n; d *= 2) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      Elem<S, DX> e1, e2, o;
      load_elem(src, n, t, e1);
      if (t + d < n) load_elem(src, n, t + d, e2);
      else identity_elem(e2);
      combine(e1, e2, o);
      store_elem(dst, n, t, o);
    }
    __syncthreads();
    S* tmp = src;
    src = dst;
    dst = tmp;
  }

  // 3. the value and, for t < T, the gains from the value at t + 1 and the
  // step's dV pair
  const size_t ns = n;
  const S* etap = src + (size_t)eta_entry<DX>() * ns;
  const S* Jp = etap + (size_t)DX * ns;
  S dv0 = S(0), dv1 = S(0);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    S J[DX][DX], eta[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) J[i][j] = Jp[(i * DX + j) * ns + t];
      eta[i] = etap[i * ns + t];
    }
    store_value(a, t, J, eta);
    if (t >= T) continue;

    S Sn[DX][DX], sn[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) Sn[i][j] = Jp[(i * DX + j) * ns + t + 1];
      sn[i] = -etap[i * ns + t + 1];
    }
    S term0, term1;
    gains_at<S, DX, DU>(a, t, Sn, sn, term0, term1);
    dv0 = dv0 + term0;
    dv1 = dv1 + term1;
  }

  __shared__ S red[K5_MAX_THREADS / 32];
  dv0 = block_sum(dv0, red);
  dv1 = block_sum(dv1, red);
  if (threadIdx.x == 0) {
    a.dV[0] = dv0;
    a.dV[1] = dv1;
  }
}

// ---------------------------------------------------------------------------
// Route "cluster": one cluster, the elements in the blocks' shared memory.
// ---------------------------------------------------------------------------

// A block's dynamic shared memory: two copies of its P elements, its
// positions' dV terms (2P) and the virtual warps' sums (2 × 8, used in
// block 0).
template <typename S, int DX>
static size_t cluster_bytes(int P) {
  return sizeof(S) * ((size_t)2 * elem_entries<DX>() * P + 2 * P + 2 * (K5_MAX_THREADS / 32));
}

// The cluster's barrier; a cluster of one block meets __syncthreads()
// (bar.sync), a fraction of barrier.cluster's cost.
__device__ __forceinline__ void cluster_barrier(const cooperative_groups::cluster_group& cluster,
                                                int C) {
  if (C == 1) __syncthreads();
  else cluster.sync();
}

// ptr in the shared memory of block r of the cluster: the block's own
// through its local address, another's through distributed shared memory.
// Either way a generic address; a cluster of one block reads its own
// __shared__ pointer instead, and its loads stay shared-memory loads (7 %
// of a launch at T=100; PERF.md).
template <typename T>
__device__ __forceinline__ T* in_block(const cooperative_groups::cluster_group& cluster, T* ptr,
                                       int r, int rank) {
  return r == rank ? ptr : cluster.map_shared_rank(ptr, r);
}

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(K5_MAX_THREADS) pscan_backward_cluster_kernel(
    PscanArgs<S> a, int P) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char k5_smem[];
  constexpr int E = elem_entries<DX>(), W = K5_MAX_THREADS / 32;
  S* buf[2] = {reinterpret_cast<S*>(k5_smem), reinterpret_cast<S*>(k5_smem) + E * P};
  S* terms = buf[1] + E * P;   // term0 of local position l at [l], term1 at [P + l]
  S* red = terms + 2 * P;      // block 0: virtual warp w's sums at [w] and [W + w]
  const int T = a.T, n = T + 1;
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int l = threadIdx.x, t = rank * P + l;
  const bool live = l < P && t < n;

  // 1. the element of this thread's position, kept in registers
  Elem<S, DX> e;
  if (live) {
    element_at<S, DX, DU>(a, t, e);
    store_elem(buf[0], P, l, e);
  }
  cluster_barrier(cluster, C);

  // 2. the suffix scan; the partner t + d lies in block (t + d) / P
  int cur = 0;
  for (int d = 1; d < n; d *= 2) {
    if (live) {
      Elem<S, DX> e2, o;
      const int u = t + d;
      if (u >= n) identity_elem(e2);
      else if (C == 1) load_elem(buf[cur], P, u, e2);
      else load_elem(in_block(cluster, buf[cur], u / P, rank), P, u % P, e2);
      combine(e, e2, o);
      e = o;
      store_elem(buf[cur ^ 1], P, l, e);
    }
    cluster_barrier(cluster, C);
    cur ^= 1;
  }

  // 3. the value and the gains from the value at t + 1 (block (t + 1) / P)
  if (live) {
    store_value(a, t, e.J, e.eta);
    if (t < T) {
      const int u = t + 1;
      const S* src = C == 1 ? buf[cur] : in_block(cluster, buf[cur], u / P, rank);
      const S* etap = src + eta_entry<DX>() * P + u % P;
      const S* Jp = etap + DX * P;
      S Sn[DX][DX], sn[DX];
#pragma unroll
      for (int i = 0; i < DX; ++i) {
#pragma unroll
        for (int j = 0; j < DX; ++j) Sn[i][j] = Jp[(i * DX + j) * P];
        sn[i] = -etap[i * P];
      }
      gains_at<S, DX, DU>(a, t, Sn, sn, terms[l], terms[P + l]);
    }
  }

  // 4. dV in the one-block kernel's order.  A cluster of one block is that
  // kernel's block (the same threads, one position each): each thread's own
  // terms, then block_sum.
  if (C == 1) {
    S dv0 = S(0), dv1 = S(0);
    if (live && t < T) {
      dv0 = dv0 + terms[l];
      dv1 = dv1 + terms[P + l];
    }
    dv0 = block_sum(dv0, red);
    dv1 = block_sum(dv1, red);
    if (threadIdx.x == 0) {
      a.dV[0] = dv0;
      a.dV[1] = dv1;
    }
    return;
  }
  cluster_barrier(cluster, C);

  // Larger clusters: the one-block kernel's thread v (of global_threads(n))
  // sums the terms of positions v, v + that count, … below T; its warp w runs
  // here as warp w / C of block w % C, which always exists.
  const int V = global_threads(n), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp * C + rank;
  if (w < V / 32) {
    S dv0 = S(0), dv1 = S(0);
    for (int s = w * 32 + lane; s < T; s += V) {
      const S* tm = in_block(cluster, terms, s / P, rank);
      dv0 = dv0 + tm[s % P];
      dv1 = dv1 + tm[P + s % P];
    }
    dv0 = warp_sum(dv0);
    dv1 = warp_sum(dv1);
    if (lane == 0) {
      S* red0 = in_block(cluster, red, 0, rank);
      red0[w] = dv0;
      red0[W + w] = dv1;
    }
  }
  cluster_barrier(cluster, C);   // no block reads another's shared memory after this
  if (rank == 0 && warp == 0) {
    S dv0 = lane < V / 32 ? red[lane] : S(0);
    S dv1 = lane < V / 32 ? red[W + lane] : S(0);
    dv0 = warp_sum(dv0);
    dv1 = warp_sum(dv1);
    if (lane == 0) {
      a.dV[0] = dv0;
      a.dV[1] = dv1;
    }
  }
}

// The cluster route's block: positions and threads for a cluster of C blocks
// (false when a position count or the shared memory is past a block's).
template <typename S, int DX>
static bool cluster_shape(int T, int C, int& P, int& threads, size_t& bytes) {
  if (C < 1 || C > K5_MAX_CLUSTER) return false;
  const int n = T + 1;
  P = (n + C - 1) / C;
  threads = ((P + 31) / 32) * 32;
  bytes = cluster_bytes<S, DX>(P);
  return P <= K5_MAX_THREADS && bytes <= K5_SMEM_BYTES;
}

template <typename S, int DX, int DU>
static cudaError_t cluster_config(int T, int C, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                                  int& P) {
  int threads;
  size_t bytes;
  if (!cluster_shape<S, DX>(T, C, P, threads, bytes)) return cudaErrorInvalidValue;
  auto kernel = pscan_backward_cluster_kernel<S, DX, DU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

template <typename S, int DX, int DU>
static int launch(const void* const* in, void* const* out, void* scratch, int T, int cluster,
                  cudaStream_t stream) {
  const PscanArgs<S> a{(const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3],
                       (const S*)in[4], (const S*)in[5], (const S*)in[6], (S*)out[0],
                       (S*)out[1], (S*)out[2], (S*)out[3], (S*)out[4], T};
  const int n = T + 1;
  if (cluster == 0) {
    S* buf0 = (S*)scratch;
    S* buf1 = buf0 + (size_t)elem_entries<DX>() * n;
    pscan_backward_kernel<S, DX, DU><<<1, global_threads(n), 0, stream>>>(a, buf0, buf1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int P;
  cudaError_t err = cluster_config<S, DX, DU>(T, cluster, cfg, attr, P);
  if (err == cudaErrorInvalidValue) return -1;
  if (err != cudaSuccess) return (int)err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, pscan_backward_cluster_kernel<S, DX, DU>, a, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename S, int DX, int DU>
static int max_clusters(int T, int cluster, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int P;
  cudaError_t err = cluster_config<S, DX, DU>(T, cluster, cfg, attr, P);
  if (err == cudaErrorInvalidValue) return -1;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, pscan_backward_cluster_kernel<S, DX, DU>, &cfg);
}

#define K5_DISPATCH(S, CALL, ...)                                   \
  do {                                                              \
    if (dx == 2 && du == 1) return CALL<S, 2, 1>(__VA_ARGS__);      \
    if (dx == 3 && du == 2) return CALL<S, 3, 2>(__VA_ARGS__);      \
    if (dx == 4 && du == 1) return CALL<S, 4, 1>(__VA_ARGS__);      \
    if (dx == 4 && du == 2) return CALL<S, 4, 2>(__VA_ARGS__);      \
  } while (0)

// C entry point.  dtype: 0 float32, 1 float64.  Inputs: Cxx (T+1, dx, dx),
// cx (T+1, dx), Cuu (≥T, du, du), cu (≥T, du), Cxu (≥T, dx, du), A (T, dx, dx),
// B (T, dx, du); outputs K (T, du, dx), kff (T, du), S (T+1, dx, dx),
// s (T+1, dx), dV (2,).  cluster: 0 takes the "global" route, whose scratch
// holds 2·(3dx² + 2dx)·(T+1) values; C ≥ 1 the "cluster" route over C blocks
// (scratch unused).  Returns the CUDA error of the launch, or -1 when no
// kernel is instantiated for (dtype, dx, du) or the cluster cannot hold T.
extern "C" int trajopt_pscan_backward(
    int dtype, int dx, int du, const void* Cxx, const void* cx, const void* Cuu,
    const void* cu, const void* Cxu, const void* A, const void* B, void* K, void* kff,
    void* S, void* s, void* dV, void* scratch, int T, int cluster, void* stream) {
  const void* in[7] = {Cxx, cx, Cuu, cu, Cxu, A, B};
  void* out[5] = {K, kff, S, s, dV};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) K5_DISPATCH(float, launch, in, out, scratch, T, cluster, st);
  if (dtype == 1) K5_DISPATCH(double, launch, in, out, scratch, T, cluster, st);
  return -1;
}

// cudaOccupancyMaxActiveClusters of the cluster route's launch at (dtype, dx,
// du, T, cluster) into *out: how many such clusters the card can hold at once
// (0: the launch would be refused).  Returns the CUDA error, or -1 as above.
extern "C" int trajopt_pscan_max_clusters(int dtype, int dx, int du, int T, int cluster,
                                          int* out) {
  if (dtype == 0) K5_DISPATCH(float, max_clusters, T, cluster, out);
  if (dtype == 1) K5_DISPATCH(double, max_clusters, T, cluster, out);
  return -1;
}
