// K1: fused linearize → quadratize → regularized iLQR backward pass.
//
// Replaces trajopt_tpu/core/pallas_fused.py::_fused_kernel (wrapper
// pallas_ilqr_backward_fused).
//
// What bounds it on the H100: the dependent chain, not bandwidth.  It reads
// only the trajectory streams (xref, uref, u_last: 6 values per step at
// Cartpole's dims) and writes the gains (5 per step), about 11 values per step
// and instance, so the bytes alone would take microseconds.  But each
// instance is T dependent steps, and each step evaluates the RK4 step on dual
// numbers (dx + du tangents), the feature Jacobian, and the backward step of
// bwd_step.cuh; with one thread per instance a batch of 2048 is 64 warps on
// 132 SMs, so the time is T times one step's latency.
//
// Design: one thread per instance walks t = T−1 … 0 with the value carry in
// registers.  A and B are the tangents of one dual evaluation of the env's
// dynamics (envs.cuh) — action clip, RK4, state clip — with JAX's tie rule at
// the clip bounds, so saturated actions give the same halved B as the
// reference.  The cost blocks are closed form for the base feature-goal cost:
// Cxx = 2w·JᵀGJ, cx = 2w·JᵀG(z₀ − g), Cuu = 2·diag(uw), cu = 2·uw·u (slew:
// u − u_last), Cxu = 0, with J from a dual evaluation of the features.  The
// env's fields arrive as a launch argument (EnvParams).  Streams are
// structure of arrays (T, entries, Np), coalesced across instances.
#include <cuda_runtime.h>

#include "bwd_step.cuh"
#include "envs.cuh"

// A = ∂f/∂x, B = ∂f/∂u of the dynamics at (x, u).
template <class Env, typename S>
__device__ __forceinline__ void linearize(const EnvParams& p, const S (&x)[Env::DX],
                                          const S (&u)[Env::DU], S (&A)[Env::DX][Env::DX],
                                          S (&B)[Env::DX][Env::DU]) {
  constexpr int DX = Env::DX, DU = Env::DU, NT = DX + DU;
  using D = Dual<S, NT>;
  D xd[DX], ud[DU], xn[DX];
#pragma unroll
  for (int i = 0; i < DX; ++i) { xd[i] = D(x[i]); xd[i].d[i] = S(1); }
#pragma unroll
  for (int j = 0; j < DU; ++j) { ud[j] = D(u[j]); ud[j].d[DX + j] = S(1); }
  dynamics<Env>(p, xd, ud, xn);
#pragma unroll
  for (int i = 0; i < DX; ++i) {
#pragma unroll
    for (int k = 0; k < DX; ++k) A[i][k] = xn[i].d[k];
#pragma unroll
    for (int j = 0; j < DU; ++j) B[i][j] = xn[i].d[DX + j];
  }
}

// Cxx = 2w·JᵀGJ and cx = 2w·JᵀG(z₀ − g) of the activation-weighted goal cost.
template <class Env, typename S>
__device__ __forceinline__ void goal_quad(const EnvParams& p, const S (&x)[Env::DX], S w,
                                          S (&Cxx)[Env::DX][Env::DX], S (&cx)[Env::DX]) {
  constexpr int DX = Env::DX, NZ = Env::NZ;
  using D = Dual<S, DX>;
  S y[DX];
  Env::periodic(p, x, y);
  D yd[DX], zd[NZ];
#pragma unroll
  for (int i = 0; i < DX; ++i) { yd[i] = D(y[i]); yd[i].d[i] = S(1); }
  Env::features(yd, zd);
  const S two_w = S(2.0) * w;
#pragma unroll
  for (int i = 0; i < DX; ++i) {
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      S s = S(p.gw[0]) * zd[0].d[i] * zd[0].d[j];
#pragma unroll
      for (int k = 1; k < NZ; ++k) s = s + S(p.gw[k]) * zd[k].d[i] * zd[k].d[j];
      Cxx[i][j] = two_w * s;
    }
    S s = S(p.gw[0]) * (zd[0].v - S(p.g[0])) * zd[0].d[i];
#pragma unroll
    for (int k = 1; k < NZ; ++k) s = s + S(p.gw[k]) * (zd[k].v - S(p.g[k])) * zd[k].d[i];
    cx[i] = two_w * s;
  }
}

template <typename S, class Env>
__global__ void __launch_bounds__(32) fused_backward_kernel(
    EnvParams p, const S* __restrict__ xref, const S* __restrict__ uref,
    const S* __restrict__ ulast, const S* __restrict__ xT, const S* __restrict__ w,
    const S* __restrict__ lam, S* __restrict__ K_out, S* __restrict__ kff_out,
    S* __restrict__ dV, unsigned char* __restrict__ bad_out, int T, int Np, int reg) {
  constexpr int DX = Env::DX, DU = Env::DU;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= Np) return;
  const size_t np = Np;

  S V[DX][DX], v[DX];
  {
    S x[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) x[i] = xT[i * np + n];
    goal_quad<Env>(p, x, w[T], V, v);
  }
  S dv0 = S(0), dv1 = S(0);
  bool bad = false;
  const S l = lam[n];

  for (int t = T - 1; t >= 0; --t) {
    S x[DX], u[DU], ul[DU];
#pragma unroll
    for (int i = 0; i < DX; ++i) x[i] = xref[((size_t)t * DX + i) * np + n];
#pragma unroll
    for (int j = 0; j < DU; ++j) {
      u[j] = uref[((size_t)t * DU + j) * np + n];
      ul[j] = ulast[((size_t)t * DU + j) * np + n];
    }

    S A[DX][DX], B[DX][DU], Cxx[DX][DX], cx[DX], Cuu[DU][DU], cu[DU], Cxu[DX][DU];
    linearize<Env>(p, x, u, A, B);
    goal_quad<Env>(p, x, w[t], Cxx, cx);
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DU; ++j) Cuu[i][j] = i == j ? S(2.0 * p.uw[i]) : S(0);
      cu[i] = S(2.0 * p.uw[i]) * (p.slew_rate ? u[i] - ul[i] : u[i]);
    }
#pragma unroll
    for (int i = 0; i < DX; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) Cxu[i][j] = S(0);

    S K[DU][DX], kff[DU];
    bwd_step<S, DX, DU>(Cxx, cx, Cuu, cu, Cxu, A, B, V, v, dv0, dv1, bad, l, reg, K, kff);

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

template <typename S, class Env>
static int launch(const EnvParams& p, const void* const* in, void* const* out, int T, int Np,
                  int reg, cudaStream_t stream) {
  const int threads = 32;
  const int blocks = (Np + threads - 1) / threads;
  fused_backward_kernel<S, Env><<<blocks, threads, 0, stream>>>(
      p, (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (S*)out[0], (S*)out[1], (S*)out[2], (unsigned char*)out[3], T, Np, reg);
  return (int)cudaGetLastError();
}

template <typename S>
static int dispatch_env(int kind, const EnvParams& p, const void* const* in, void* const* out,
                        int T, int Np, int reg, cudaStream_t s) {
  if (kind == 0) return launch<S, Cartpole>(p, in, out, T, Np, reg, s);
  if (kind == 1) return launch<S, CartpoleCartesian>(p, in, out, T, Np, reg, s);
  return -1;
}

// C entry point.  dtype: 0 float32, 1 float64; kind: 0 Cartpole, 1 Cartpole
// with the Cartesian cost.  Returns the CUDA error of the launch, or -1 for an
// unsupported (dtype, kind).
extern "C" int trajopt_fused_backward(
    int dtype, int kind, const EnvParams* params, const void* xref, const void* uref,
    const void* ulast, const void* xT, const void* w, const void* lam, void* K, void* kff,
    void* dV, void* bad, int T, int Np, int reg, void* stream) {
  const void* in[6] = {xref, uref, ulast, xT, w, lam};
  void* out[4] = {K, kff, dV, bad};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_env<float>(kind, *params, in, out, T, Np, reg, s);
  if (dtype == 1) return dispatch_env<double>(kind, *params, in, out, T, Np, reg, s);
  return -1;
}
