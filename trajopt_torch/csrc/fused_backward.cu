// K1: fused linearize → quadratize → regularized iLQR backward pass.
//
// Replaces trajopt_tpu/core/pallas_fused.py::_fused_kernel (wrapper
// pallas_ilqr_backward_fused).
//
// What bounds it on the H100: the dependent chain of the backward step, as
// issued by one warp, not bandwidth.  It reads only the trajectory streams
// (xref, uref, u_last: 6 values per step at Cartpole's dims) and writes the
// gains (5 per step), so the bytes alone would take microseconds.  Each step
// also evaluates the RK4 step on dual numbers (dx + du tangents) and the
// feature Jacobian, three quarters of its operations, but those depend only
// on the trajectory, not on the value carry.  The first version ran all of it
// in one thread per instance (64 one-warp blocks for a batch of 2048), the
// linearization and an HBM round trip inside the chain of every step.
//
// Design: the staged backward of bwd_step.cuh.  A block takes 16 instances;
// nine producer warps compute a chunk of 16 steps × 16 instances of
// operands, one (t, n) per thread — A and B as the tangents of one dual
// evaluation of the env's dynamics (envs.cuh: action clip, RK4, state clip,
// with JAX's tie rule at the clip bounds, so saturated actions give the same
// halved B as the reference), and the closed-form cost blocks of the base
// feature-goal cost: Cxx = 2w·JᵀGJ, cx = 2w·JᵀG(z₀ − g), Cuu = 2·diag(uw),
// cu = 2·uw·u (slew: u − u_last), Cxu = 0, with J from a dual evaluation of
// the features — into a ring in shared memory, while the consumer warp walks
// the value recursion over the stage before.  The linearization is T·N-way
// parallel work beside the chain and never touches HBM.  The env's fields
// arrive as a launch argument (EnvParams).  Streams are structure of arrays
// (T, entries, Np), coalesced across instances.
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

// The producer of the staged backward: the linearization and the cost blocks
// of each (t, n) of a chunk, one per producer thread.
template <typename S, class Env>
struct LinearizeProducer {
  static constexpr int DX = Env::DX, DU = Env::DU;
  // In f32 nine warps (three on each sub-partition beside the consumer's)
  // fill a chunk of 16 × 16 (t, n) in one round: the dual-number steps have
  // little ILP, and it takes that many to stay ahead of the chain.  An f64
  // thread needs over 200 registers, and twelve warps of those exceed an
  // SM's 64K: three.
  static constexpr int kWarps = sizeof(S) == 4 ? 9 : 3;
  EnvParams p;
  const S *xref, *uref, *ulast, *xT, *w;
  size_t np;
  int T;

  __device__ __forceinline__ void terminal(int n, S (&V)[DX][DX], S (&v)[DX]) const {
    S x[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) x[i] = xT[i * np + n];
    goal_quad<Env>(p, x, w[T], V, v);
  }

  __device__ __forceinline__ void fill(S* stage, int t_hi, int steps, int n0, int tid) const {
    using L = StepSlot<DX, DU>;
    for (int q = tid; q < steps * kGroup; q += 32 * kWarps) {
      const int s = q / kGroup, g = q % kGroup, n = n0 + g;
      const size_t t = t_hi - s;
      S x[DX], u[DU], ul[DU];
#pragma unroll
      for (int i = 0; i < DX; ++i) x[i] = xref[(t * DX + i) * np + n];
#pragma unroll
      for (int j = 0; j < DU; ++j) {
        u[j] = uref[(t * DU + j) * np + n];
        ul[j] = ulast[(t * DU + j) * np + n];
      }

      S A[DX][DX], B[DX][DU], Cxx[DX][DX], cx[DX];
      linearize<Env>(p, x, u, A, B);
      goal_quad<Env>(p, x, w[t], Cxx, cx);

      S* op = stage + s * L::E * kGroup + g;
#pragma unroll
      for (int i = 0; i < DX; ++i) {
#pragma unroll
        for (int j = 0; j < DX; ++j) {
          op[(L::A + i * DX + j) * kGroup] = A[i][j];
          op[(L::CXX + i * DX + j) * kGroup] = Cxx[i][j];
        }
#pragma unroll
        for (int j = 0; j < DU; ++j) {
          op[(L::B + i * DU + j) * kGroup] = B[i][j];
          op[(L::CXU + i * DU + j) * kGroup] = S(0);
        }
        op[(L::CX + i) * kGroup] = cx[i];
      }
#pragma unroll
      for (int i = 0; i < DU; ++i) {
#pragma unroll
        for (int j = 0; j < DU; ++j)
          op[(L::CUU + i * DU + j) * kGroup] = i == j ? S(2.0 * p.uw[i]) : S(0);
        op[(L::CU + i) * kGroup] = S(2.0 * p.uw[i]) * (p.slew_rate ? u[i] - ul[i] : u[i]);
      }
    }
  }
};

template <typename S, class Env>
__global__ void __launch_bounds__(Staged<LinearizeProducer<S, Env>>::kThreads, 1)
fused_backward_kernel(
    LinearizeProducer<S, Env> prod, const S* __restrict__ lam, S* __restrict__ K_out,
    S* __restrict__ kff_out, S* __restrict__ dV, unsigned char* __restrict__ bad_out, int T,
    int Np, int reg) {
  staged_backward<S, Env::DX, Env::DU>(prod, lam, K_out, kff_out, dV, bad_out, T, Np, reg);
}

template <typename S, class Env>
static int launch(const EnvParams& p, const void* const* in, void* const* out, int T, int Np,
                  int reg, cudaStream_t stream) {
  const LinearizeProducer<S, Env> prod{
      p, (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (size_t)Np, T};
  return launch_staged<S, Env::DX, Env::DU, LinearizeProducer<S, Env>>(
      fused_backward_kernel<S, Env>, Np, stream, prod, (const S*)in[5], (S*)out[0],
      (S*)out[1], (S*)out[2], (unsigned char*)out[3], T, Np, reg);
}

template <typename S>
static int dispatch_env(int kind, const EnvParams& p, const void* const* in, void* const* out,
                        int T, int Np, int reg, cudaStream_t s) {
  return with_env(kind, [&](auto env) {
    return launch<S, decltype(env)>(p, in, out, T, Np, reg, s);
  });
}

// C entry point.  dtype: 0 float32, 1 float64; kind: envs.cuh's with_env
// (Cartpole and Pendulum, each with its Cartesian-cost variant).  Returns the CUDA error of the launch, or -1 for an
// unsupported (dtype, kind) or an Np that is not a multiple of the group (16).
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
