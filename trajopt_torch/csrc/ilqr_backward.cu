// K4: batched regularized iLQR backward pass on precomputed cost and dynamics
// streams.
//
// Replaces trajopt_tpu/core/pallas_lqr.py::_ilqr_kernel (wrappers
// pallas_ilqr_backward / pallas_ilqr_backward_packed).
//
// What bounds it on the H100: not bandwidth.  Each instance is a chain of T
// dependent steps (one Cholesky, two small solves and a dozen tiny products
// per step), and with one thread per instance a batch of 2048 fills only 64
// warps on 132 SMs, so the time is T times one step's dependent latency.
// The bytes (the seven streams, ≈ 44 floats per step at Cartpole's 4×1 dims,
// read once; the gains written once) are the floor only at far larger batches.
//
// Design: one thread per instance runs the whole time loop; the value carry
// (V, v, dV, flag) stays in registers across it, replacing the sequential
// grid axis and VMEM scratch of the TPU kernel.  Streams are structure of
// arrays (T, entries, Np) with instances contiguous, so a warp's loads of one
// entry are one coalesced 128-byte line.  Blocks are one warp each, spreading
// the few warps over as many SMs as possible.  All small-matrix algebra is
// unrolled at compile time from bwd_step.cuh, templated on <S, DX, DU>.
#include <cuda_runtime.h>

#include "bwd_step.cuh"

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(32) ilqr_backward_kernel(
    const S* __restrict__ cxx, const S* __restrict__ cx, const S* __restrict__ cuu,
    const S* __restrict__ cu, const S* __restrict__ cxu, const S* __restrict__ A_s,
    const S* __restrict__ B_s, const S* __restrict__ vT, const S* __restrict__ vvT,
    const S* __restrict__ lam, S* __restrict__ K_out, S* __restrict__ kff_out,
    S* __restrict__ dV, unsigned char* __restrict__ bad_out, int T, int Np, int reg) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= Np) return;
  const size_t np = Np;

  S V[DX][DX], v[DX];
#pragma unroll
  for (int i = 0; i < DX; ++i) {
#pragma unroll
    for (int j = 0; j < DX; ++j) V[i][j] = vT[(i * DX + j) * np + n];
    v[i] = vvT[i * np + n];
  }
  S dv0 = S(0), dv1 = S(0);
  bool bad = false;
  const S l = lam[n];

  for (int t = T - 1; t >= 0; --t) {
    S Cxx[DX][DX], cx_t[DX], Cuu[DU][DU], cu_t[DU], Cxu[DX][DU], A[DX][DX], B[DX][DU];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) {
        Cxx[i][j] = cxx[((size_t)t * DX * DX + i * DX + j) * np + n];
        A[i][j] = A_s[((size_t)t * DX * DX + i * DX + j) * np + n];
      }
#pragma unroll
      for (int j = 0; j < DU; ++j) {
        Cxu[i][j] = cxu[((size_t)t * DX * DU + i * DU + j) * np + n];
        B[i][j] = B_s[((size_t)t * DX * DU + i * DU + j) * np + n];
      }
      cx_t[i] = cx[((size_t)t * DX + i) * np + n];
    }
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DU; ++j) Cuu[i][j] = cuu[((size_t)t * DU * DU + i * DU + j) * np + n];
      cu_t[i] = cu[((size_t)t * DU + i) * np + n];
    }

    S K[DU][DX], kff[DU];
    bwd_step<S, DX, DU>(Cxx, cx_t, Cuu, cu_t, Cxu, A, B, V, v, dv0, dv1, bad, l, reg, K, kff);

#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) K_out[((size_t)t * DU * DX + i * DX + j) * np + n] = K[i][j];
      kff_out[((size_t)t * DU + i) * np + n] = kff[i];
    }
  }
  dV[n] = dv0;
  dV[np + n] = dv1;
  bad_out[n] = bad ? 1 : 0;
}

template <typename S, int DX, int DU>
static int launch(const void* const* in, void* const* out, int T, int Np, int reg,
                  cudaStream_t stream) {
  const int threads = 32;
  const int blocks = (Np + threads - 1) / threads;
  ilqr_backward_kernel<S, DX, DU><<<blocks, threads, 0, stream>>>(
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9],
      (S*)out[0], (S*)out[1], (S*)out[2], (unsigned char*)out[3], T, Np, reg);
  return (int)cudaGetLastError();
}

// C entry point.  dtype: 0 float32, 1 float64.  Returns the CUDA error of the
// launch, or -1 when no kernel is instantiated for (dtype, dx, du).
extern "C" int trajopt_ilqr_backward(
    int dtype, int dx, int du, const void* cxx, const void* cx, const void* cuu,
    const void* cu, const void* cxu, const void* A, const void* B, const void* vT,
    const void* vvT, const void* lam, void* K, void* kff, void* dV, void* bad, int T,
    int Np, int reg, void* stream) {
  const void* in[10] = {cxx, cx, cuu, cu, cxu, A, B, vT, vvT, lam};
  void* out[4] = {K, kff, dV, bad};
  cudaStream_t s = (cudaStream_t)stream;
  if (dx == 4 && du == 1) {
    if (dtype == 0) return launch<float, 4, 1>(in, out, T, Np, reg, s);
    if (dtype == 1) return launch<double, 4, 1>(in, out, T, Np, reg, s);
  }
  return -1;
}
