// K2 and K3: the two phases of the iLQR line search.
//
// K2 replaces trajopt_tpu/core/pallas_rollout.py::_returns_kernel (wrapper
// pallas_rollout_returns): every α candidate rolled out under the tracking
// controller u = ur + α·kff + K(x − xr), clipped, with the stage cost on the
// previous action and RK4, returning only each candidate's return and its
// x < 1e8 flag (NaN clears it).
// K3 replaces pallas_rollout.py::_selected_kernel (wrapper
// pallas_rollout_selected): each instance rolls out again under its own
// selected α and writes states, actions, the terminal state and the return.
//
// What bounds them on the H100: the sequential chain of T RK4 steps per
// rollout, not bandwidth.  K2 reads the gain and reference streams (10 values
// per step at Cartpole's dims) and writes two values per candidate; K3 also
// writes 5 values per step.  With one thread per rollout the time is T times
// one step's dependent latency (action, clip, cost, four ODE stages).
//
// Design: K2 runs one thread per (α, instance), nA·Np threads, 11× the
// parallelism of one thread per instance; threads of the same instance and
// different α read the same stream addresses, which L1/L2 serve after the
// first.  Consecutive threads are consecutive instances of one α, so each
// warp's loads are coalesced.  K3 runs one thread per instance.  The state
// and the previous action stay in registers across the time loop.
#include <cuda_runtime.h>

#include "envs.cuh"

// One tracking step: action, clip, stage cost, next state.
template <class Env, typename S>
__device__ __forceinline__ S track_step(const EnvParams& p, const S* __restrict__ K,
                                        const S* __restrict__ kff, const S* __restrict__ xref,
                                        const S* __restrict__ uref, int t, size_t np, int n,
                                        S alpha, S w, S (&x)[Env::DX], S (&uprev)[Env::DU]) {
  constexpr int DX = Env::DX, DU = Env::DU;
  S xr[DX], u[DU];
#pragma unroll
  for (int c = 0; c < DX; ++c) xr[c] = xref[((size_t)t * DX + c) * np + n];
#pragma unroll
  for (int j = 0; j < DU; ++j) {
    S fb = K[((size_t)t * DU * DX + j * DX) * np + n] * (x[0] - xr[0]);
#pragma unroll
    for (int c = 1; c < DX; ++c) fb = fb + K[((size_t)t * DU * DX + j * DX + c) * np + n] * (x[c] - xr[c]);
    const S ff = uref[((size_t)t * DU + j) * np + n] + alpha * kff[((size_t)t * DU + j) * np + n];
    u[j] = clip_(ff + fb, S(-p.umax[j]), S(p.umax[j]));
  }
  const S c = stage_cost<Env>(p, x, u, uprev, w);
  S xn[DX];
  dynamics<Env>(p, x, u, xn);
#pragma unroll
  for (int i = 0; i < DX; ++i) x[i] = xn[i];
#pragma unroll
  for (int j = 0; j < DU; ++j) uprev[j] = u[j];
  return c;
}

template <class Env, typename S>
__device__ __forceinline__ bool below_1e8(const S (&x)[Env::DX]) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < Env::DX; ++c) ok = ok && (x[c] < S(1e8));
  return ok;
}

template <typename S, class Env>
__global__ void __launch_bounds__(64) rollout_returns_kernel(
    EnvParams p, const S* __restrict__ K, const S* __restrict__ kff,
    const S* __restrict__ xref, const S* __restrict__ uref, const S* __restrict__ w,
    const S* __restrict__ alphas, S* __restrict__ ret, unsigned char* __restrict__ ok_out,
    int T, int Np, int nA) {
  constexpr int DX = Env::DX, DU = Env::DU;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int a = (int)(idx / Np);
  const int n = (int)(idx - (long)a * Np);
  if (a >= nA) return;
  const size_t np = Np;
  const S alpha = alphas[a];

  S x[DX], uprev[DU];
#pragma unroll
  for (int c = 0; c < DX; ++c) x[c] = xref[c * np + n];
#pragma unroll
  for (int j = 0; j < DU; ++j) uprev[j] = S(0);
  S r = S(0);
  bool ok = true;
  for (int t = 0; t < T; ++t) {
    ok = below_1e8<Env>(x) && ok;
    r = r + track_step<Env>(p, K, kff, xref, uref, t, np, n, alpha, w[t], x, uprev);
  }
  S zeros[DU];
#pragma unroll
  for (int j = 0; j < DU; ++j) zeros[j] = S(0);
  r = r + stage_cost<Env>(p, x, zeros, zeros, w[T]);
  ok = below_1e8<Env>(x) && ok;
  ret[(size_t)a * np + n] = r;
  ok_out[(size_t)a * np + n] = ok ? 1 : 0;
}

template <typename S, class Env>
__global__ void __launch_bounds__(32) rollout_selected_kernel(
    EnvParams p, const S* __restrict__ K, const S* __restrict__ kff,
    const S* __restrict__ xref, const S* __restrict__ uref, const S* __restrict__ w,
    const S* __restrict__ alpha_l, S* __restrict__ xs, S* __restrict__ us,
    S* __restrict__ xT, S* __restrict__ ret, int T, int Np) {
  constexpr int DX = Env::DX, DU = Env::DU;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= Np) return;
  const size_t np = Np;
  const S alpha = alpha_l[n];

  S x[DX], uprev[DU];
#pragma unroll
  for (int c = 0; c < DX; ++c) x[c] = xref[c * np + n];
#pragma unroll
  for (int j = 0; j < DU; ++j) uprev[j] = S(0);
  S r = S(0);
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int c = 0; c < DX; ++c) xs[((size_t)t * DX + c) * np + n] = x[c];
    r = r + track_step<Env>(p, K, kff, xref, uref, t, np, n, alpha, w[t], x, uprev);
#pragma unroll
    for (int j = 0; j < DU; ++j) us[((size_t)t * DU + j) * np + n] = uprev[j];
  }
  S zeros[DU];
#pragma unroll
  for (int j = 0; j < DU; ++j) zeros[j] = S(0);
  r = r + stage_cost<Env>(p, x, zeros, zeros, w[T]);
#pragma unroll
  for (int c = 0; c < DX; ++c) xT[c * np + n] = x[c];
  ret[n] = r;
}

template <typename S, class Env>
static int launch_returns(const EnvParams& p, const void* const* in, void* const* out, int T,
                          int Np, int nA, cudaStream_t s) {
  const int threads = 64;
  const long total = (long)nA * Np;
  const int blocks = (int)((total + threads - 1) / threads);
  rollout_returns_kernel<S, Env><<<blocks, threads, 0, s>>>(
      p, (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (S*)out[0], (unsigned char*)out[1], T, Np, nA);
  return (int)cudaGetLastError();
}

template <typename S, class Env>
static int launch_selected(const EnvParams& p, const void* const* in, void* const* out, int T,
                           int Np, cudaStream_t s) {
  const int threads = 32;
  const int blocks = (Np + threads - 1) / threads;
  rollout_selected_kernel<S, Env><<<blocks, threads, 0, s>>>(
      p, (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (S*)out[0], (S*)out[1], (S*)out[2], (S*)out[3], T, Np);
  return (int)cudaGetLastError();
}

// C entry points.  dtype: 0 float32, 1 float64; kind: 0 Cartpole, 1 Cartpole
// with the Cartesian cost.  Each returns the CUDA error of the launch, or -1
// for an unsupported (dtype, kind).
extern "C" int trajopt_rollout_returns(int dtype, int kind, const EnvParams* params,
                                       const void* K, const void* kff, const void* xref,
                                       const void* uref, const void* w, const void* alphas,
                                       void* ret, void* ok, int T, int Np, int nA,
                                       void* stream) {
  const void* in[6] = {K, kff, xref, uref, w, alphas};
  void* out[2] = {ret, ok};
  cudaStream_t s = (cudaStream_t)stream;
  const EnvParams& p = *params;
  if (dtype == 0 && kind == 0) return launch_returns<float, Cartpole>(p, in, out, T, Np, nA, s);
  if (dtype == 0 && kind == 1) return launch_returns<float, CartpoleCartesian>(p, in, out, T, Np, nA, s);
  if (dtype == 1 && kind == 0) return launch_returns<double, Cartpole>(p, in, out, T, Np, nA, s);
  if (dtype == 1 && kind == 1) return launch_returns<double, CartpoleCartesian>(p, in, out, T, Np, nA, s);
  return -1;
}

extern "C" int trajopt_rollout_selected(int dtype, int kind, const EnvParams* params,
                                        const void* K, const void* kff, const void* xref,
                                        const void* uref, const void* w, const void* alpha_l,
                                        void* xs, void* us, void* xT, void* ret, int T, int Np,
                                        void* stream) {
  const void* in[6] = {K, kff, xref, uref, w, alpha_l};
  void* out[4] = {xs, us, xT, ret};
  cudaStream_t s = (cudaStream_t)stream;
  const EnvParams& p = *params;
  if (dtype == 0 && kind == 0) return launch_selected<float, Cartpole>(p, in, out, T, Np, s);
  if (dtype == 0 && kind == 1) return launch_selected<float, CartpoleCartesian>(p, in, out, T, Np, s);
  if (dtype == 1 && kind == 0) return launch_selected<double, Cartpole>(p, in, out, T, Np, s);
  if (dtype == 1 && kind == 1) return launch_selected<double, CartpoleCartesian>(p, in, out, T, Np, s);
  return -1;
}
