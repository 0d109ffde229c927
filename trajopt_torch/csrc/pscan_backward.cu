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
// a round trip through the L2 cache and a Gauss–Jordan chain of dx divides.
//
// Design, right first: one thread block per problem (the solver launches
// one).  Thread tid owns positions tid, tid + blockDim, …, so any T works.
// The elements live in a ping-pong scratch in global memory that the wrapper
// allocates (3dx² + 2dx entries per position, entry-major so a warp's loads
// are coalesced; two float32 copies at T=1000, dx=4 take 0.45 MB and stay in
// L2), with __syncthreads() between levels.  Shared memory could not hold
// two copies (one float32 copy at T=1001, dx=4 is 219 KB).  Blocks are at
// most 256 threads so that the unrolled combine keeps up to 255 registers a
// thread.  dV is a block reduction.  Every small product sums in the order
// of the JAX kernel (index 0 first) and the build uses -fmad=false, so the
// float64 build agrees with the plain version (cuda_pscan.pilqr_backward_plain)
// to rounding.
#include <cuda_runtime.h>

#include "bwd_step.cuh"
#include "gj_inv.cuh"

constexpr int K5_MAX_THREADS = 256;

template <typename S, int DX>
struct Elem {
  S A[DX][DX], b[DX], C[DX][DX], eta[DX], J[DX][DX];
};

template <int DX>
constexpr int elem_entries() { return 3 * DX * DX + 2 * DX; }

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
__device__ __forceinline__ S block_sum(S v, S* __restrict__ sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = S(0);
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = sh[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;  // the sum, in thread 0
}

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(K5_MAX_THREADS) pscan_backward_kernel(
    const S* __restrict__ Cxx, const S* __restrict__ cx, const S* __restrict__ Cuu,
    const S* __restrict__ cu, const S* __restrict__ Cxu, const S* __restrict__ A_s,
    const S* __restrict__ B_s, S* __restrict__ K_out, S* __restrict__ kff_out,
    S* __restrict__ S_out, S* __restrict__ s_out, S* __restrict__ dV,
    S* __restrict__ buf0, S* __restrict__ buf1, int T) {
  const int n = T + 1;

  // 1. elements; position T is the terminal element (A = b = C = 0, η = −q_T,
  // J = Q_T)
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    Elem<S, DX> e;
    if (t < T) {
      make_element<S, DX, DU>(Cxx, cx, Cuu, cu, Cxu, A_s, B_s, t, e);
    } else {
      identity_elem(e);
#pragma unroll
      for (int i = 0; i < DX; ++i) {
        e.A[i][i] = S(0);
        e.eta[i] = -cx[(size_t)T * DX + i];
#pragma unroll
        for (int j = 0; j < DX; ++j) e.J[i][j] = Cxx[((size_t)T * DX + i) * DX + j];
      }
    }
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

  // 3. the value (S = J, s = −η) and, for t < T, the gains from the value at
  // t + 1 and the step's dV pair (pallas_pscan.py:228-256)
  const size_t ns = n;
  const S* etap = src + (size_t)(2 * DX * DX + DX) * ns;  // entries A, b, C precede η
  const S* Jp = etap + (size_t)DX * ns;
  S dv0 = S(0), dv1 = S(0);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) S_out[((size_t)t * DX + i) * DX + j] = Jp[(i * DX + j) * ns + t];
      s_out[(size_t)t * DX + i] = -etap[i * ns + t];
    }
    if (t >= T) continue;

    S Sn[DX][DX], sn[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) Sn[i][j] = Jp[(i * DX + j) * ns + t + 1];
      sn[i] = -etap[i * ns + t + 1];
    }
    S R[DU][DU], r[DU], M[DX][DU], F[DX][DX], L[DX][DU];
    load_block(Cuu + (size_t)t * DU * DU, R);
    load_vec(cu + (size_t)t * DU, r);
    load_block(Cxu + (size_t)t * DX * DU, M);
    load_block(A_s + (size_t)t * DX * DX, F);
    load_block(B_s + (size_t)t * DX * DU, L);

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
      for (int i = 0; i < DU; ++i) K_out[((size_t)t * DU + i) * DX + j] = -x[i];
    }
    S Lts[DU], b[DU], x[DU], kff[DU], qu[DU], Qk[DU];
    mv_tn(L, sn, Lts);
#pragma unroll
    for (int i = 0; i < DU; ++i) b[i] = Lts[i] + r[i];
    chol_solve(Lq, inv_q, b, x);
#pragma unroll
    for (int i = 0; i < DU; ++i) {
      kff[i] = -x[i];
      kff_out[(size_t)t * DU + i] = kff[i];
      qu[i] = r[i] + Lts[i];
    }
    mv(Quu, kff, Qk);
    dv0 = dv0 + dot(kff, qu);
    dv1 = dv1 + S(0.5) * dot(kff, Qk);
  }

  __shared__ S red[K5_MAX_THREADS / 32];
  dv0 = block_sum(dv0, red);
  dv1 = block_sum(dv1, red);
  if (threadIdx.x == 0) {
    dV[0] = dv0;
    dV[1] = dv1;
  }
}

template <typename S, int DX, int DU>
static int launch(const void* const* in, void* const* out, void* scratch, int T,
                  cudaStream_t stream) {
  const int n = T + 1;
  const int threads = n >= K5_MAX_THREADS ? K5_MAX_THREADS : ((n + 31) / 32) * 32;
  S* buf0 = (S*)scratch;
  S* buf1 = buf0 + (size_t)elem_entries<DX>() * n;
  pscan_backward_kernel<S, DX, DU><<<1, threads, 0, stream>>>(
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (S*)out[0], (S*)out[1], (S*)out[2], (S*)out[3],
      (S*)out[4], buf0, buf1, T);
  return (int)cudaGetLastError();
}

template <typename S>
static int dispatch(int dx, int du, const void* const* in, void* const* out, void* scratch,
                    int T, cudaStream_t s) {
  if (dx == 2 && du == 1) return launch<S, 2, 1>(in, out, scratch, T, s);
  if (dx == 3 && du == 2) return launch<S, 3, 2>(in, out, scratch, T, s);
  if (dx == 4 && du == 1) return launch<S, 4, 1>(in, out, scratch, T, s);
  if (dx == 4 && du == 2) return launch<S, 4, 2>(in, out, scratch, T, s);
  return -1;
}

// C entry point.  dtype: 0 float32, 1 float64.  Inputs: Cxx (T+1, dx, dx),
// cx (T+1, dx), Cuu (≥T, du, du), cu (≥T, du), Cxu (≥T, dx, du), A (T, dx, dx),
// B (T, dx, du); outputs K (T, du, dx), kff (T, du), S (T+1, dx, dx),
// s (T+1, dx), dV (2,); scratch holds 2·(3dx² + 2dx)·(T+1) values.  Returns
// the CUDA error of the launch, or -1 when no kernel is instantiated for
// (dtype, dx, du).
extern "C" int trajopt_pscan_backward(
    int dtype, int dx, int du, const void* Cxx, const void* cx, const void* Cuu,
    const void* cu, const void* Cxu, const void* A, const void* B, void* K, void* kff,
    void* S, void* s, void* dV, void* scratch, int T, void* stream) {
  const void* in[7] = {Cxx, cx, Cuu, cu, Cxu, A, B};
  void* out[5] = {K, kff, S, s, dV};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(dx, du, in, out, scratch, T, st);
  if (dtype == 1) return dispatch<double>(dx, du, in, out, scratch, T, st);
  return -1;
}
