// K4: batched regularized iLQR backward pass on precomputed cost and dynamics
// streams.
//
// Replaces trajopt_tpu/core/pallas_lqr.py::_ilqr_kernel (wrappers
// pallas_ilqr_backward / pallas_ilqr_backward_packed).
//
// What bounds it on the H100: the dependent chain of one instance, T steps
// of one Cholesky, two small solves and a dozen tiny products, as issued by
// one warp.  The bytes (the seven streams, 46 values per step at Cartpole's
// 4×1 dims, read once; the gains written once) are the floor only at far
// larger batches.  The first version ran one thread per instance in one-warp
// blocks and loaded each step's 46 operands from device memory inside the
// chain: 64 warps on 132 SMs, each waiting out a round trip to HBM per step.
//
// Design: the staged backward of bwd_step.cuh.  A block takes 16 instances;
// its consumer warp walks the value recursion (V, v, dV, flag in registers)
// reading each step's operands from shared memory, while three producer
// warps copy the next chunk of the seven streams into the other stage of the
// ring with cp.async, 16 bytes a thread, so the chain never waits on device
// memory.  Streams are structure of arrays (T, entries, Np) with instances
// contiguous: a group's row of one entry is 64 bytes (f32) in one line.  All
// small-matrix algebra is unrolled at compile time from bwd_step.cuh,
// templated on <S, DX, DU>.
#include <cuda_runtime.h>

#include "bwd_step.cuh"

// The producer of the staged backward: copies the streams' rows of a chunk.
template <typename S, int DX, int DU>
struct StreamProducer {
  static constexpr int kWarps = 3;
  const S *cxx, *cx, *cuu, *cu, *cxu, *A, *B, *vT, *vvT;
  size_t np;

  __device__ __forceinline__ void terminal(int n, S (&V)[DX][DX], S (&v)[DX]) const {
#pragma unroll
    for (int i = 0; i < DX; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) V[i][j] = vT[(i * DX + j) * np + n];
      v[i] = vvT[i * np + n];
    }
  }

  // The row (all Np instances) of slot entry e at step t.
  __device__ __forceinline__ const S* row(int e, size_t t) const {
    using L = StepSlot<DX, DU>;
    if (e < L::B) return A + (t * DX * DX + e) * np;
    if (e < L::CXX) return B + (t * DX * DU + e - L::B) * np;
    if (e < L::CX) return cxx + (t * DX * DX + e - L::CXX) * np;
    if (e < L::CUU) return cx + (t * DX + e - L::CX) * np;
    if (e < L::CU) return cuu + (t * DU * DU + e - L::CUU) * np;
    if (e < L::CXU) return cu + (t * DU + e - L::CU) * np;
    return cxu + (t * DX * DU + e - L::CXU) * np;
  }

  __device__ __forceinline__ void fill(S* stage, int t_hi, int steps, int n0, int tid) const {
    using L = StepSlot<DX, DU>;
    constexpr int VEC = 16 / sizeof(S), PIECES = kGroup / VEC;   // per row of a group
    const int total = steps * L::E * PIECES;
    for (int q = tid; q < total; q += 32 * kWarps) {
      const int c = q % PIECES, se = q / PIECES, e = se % L::E, s = se / L::E;
      cp_async16(stage + (s * L::E + e) * kGroup + c * VEC, row(e, t_hi - s) + n0 + c * VEC);
    }
    cp_async_wait_all();
  }
};

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(Staged<StreamProducer<S, DX, DU>>::kThreads, 1)
ilqr_backward_kernel(
    StreamProducer<S, DX, DU> prod, const S* __restrict__ lam, S* __restrict__ K_out,
    S* __restrict__ kff_out, S* __restrict__ dV, unsigned char* __restrict__ bad_out, int T,
    int Np, int reg) {
  staged_backward<S, DX, DU>(prod, lam, K_out, kff_out, dV, bad_out, T, Np, reg);
}

template <typename S, int DX, int DU>
static int launch(const void* const* in, void* const* out, int T, int Np, int reg,
                  cudaStream_t stream) {
  const StreamProducer<S, DX, DU> prod{
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (size_t)Np};
  return launch_staged<S, DX, DU, StreamProducer<S, DX, DU>>(
      ilqr_backward_kernel<S, DX, DU>, Np, stream, prod, (const S*)in[9], (S*)out[0],
      (S*)out[1], (S*)out[2], (unsigned char*)out[3], T, Np, reg);
}

// C entry point.  dtype: 0 float32, 1 float64.  Returns the CUDA error of the
// launch, or -1 when no kernel is instantiated for (dtype, dx, du) or Np is
// not a multiple of the group (16).  The streams must be 16-byte aligned.
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
