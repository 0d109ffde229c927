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
// rollout (action, clip, cost, four ODE stages), not bandwidth.  K2 reads the
// gain and reference streams (10 values per step at Cartpole's dims) and
// writes two values per candidate; K3 also writes 5 values per step.  The
// first version ran one thread per rollout and loaded each step's operands
// from device memory, and took 2.9 µs a step; so did the chain alone with
// every operand already in shared memory.  Its length was the float IEEE
// division and sinf/cosf: each puts a branch to a slow path, in a
// convergence region, on the chain (about 500 cycles a division, twelve a
// step; PERF.md).
//
// Design: the step runs the env's physics with ChainOps (envs.cuh), which
// gives the same float quotients, sines and cosines without those branches;
// a chunk in which any lane's sine argument left ChainOps' range (a rollout
// past |θ| = 105615) is taken again by the warp with the library's, and one
// in which a lane's numerator left the range of ChainOps' quotient (below
// 2^-99: residue on the goal) with ExactChainOps' quotient.  The
// kernels stage their operands with the ring of ring.cuh, walked forward in
// time.  A block takes kRollGroup instances; a producer warp
// copies the next chunk of the four streams and the weighting into shared
// memory with cp.async, 16 bytes a thread, while the consumer lanes walk the
// chain over the chunk before.  K3 has one consumer lane per instance and
// stores each step's state and action directly (fire-and-forget, off the
// chain); K2 has one lane per (α, instance) for kAlphaBlock candidates a block
// (a second grid dimension covers more), and the α lanes of one instance read
// the same staged words as a broadcast.  The state and the previous action
// stay in registers across the time loop.  The operations and their order are
// those of the first version, so the outputs are the same to the bit, in
// float too.
#include <cuda_runtime.h>

#include <type_traits>

#include "envs.cuh"
#include "ring.cuh"

constexpr int kRollGroup = 16;    // instances per block
constexpr int kRollChunk = 16;    // steps per stage
constexpr int kAlphaBlock = 6;    // α candidates per K2 block
constexpr int kRollProducers = 1;

// A stage: entry e of step slot s of lane g at [(s·E + e)·kRollGroup + g],
// then the weighting of the chunk's kRollChunk steps.
template <int DX, int DU>
struct RollSlot {
  static constexpr int K = 0, KFF = K + DU * DX, XR = KFF + DU, UR = XR + DX, E = UR + DU;
  static constexpr int W = kRollChunk * E * kRollGroup;   // the weighting's offset
  static constexpr int STAGE = W + kRollChunk;            // elements
};

// The operand streams (T, entries, Np) and the weighting (T + 1,).
template <typename S, int DX, int DU>
struct RollStreams {
  const S *K, *kff, *xref, *uref, *w;
  size_t np;
  int T;

  // The row (all Np instances) of slot entry e at step t.
  __device__ __forceinline__ const S* row(int e, size_t t) const {
    using L = RollSlot<DX, DU>;
    if (e < L::KFF) return K + (t * DU * DX + e) * np;
    if (e < L::XR) return kff + (t * DU + e - L::KFF) * np;
    if (e < L::UR) return xref + (t * DX + e - L::XR) * np;
    return uref + (t * DU + e - L::UR) * np;
  }

  // Stage chunk k (steps k·kRollChunk …) of the instances n0 … n0 + kRollGroup − 1,
  // as producer thread tid of `threads`; the copies have landed on return.
  __device__ __forceinline__ void fill(S* stage, int k, int n0, int tid, int threads) const {
    using L = RollSlot<DX, DU>;
    constexpr int VEC = 16 / sizeof(S), PIECES = kRollGroup / VEC;   // per row of a group
    const int t0 = k * kRollChunk;
    const int steps = T - t0 < kRollChunk ? T - t0 : kRollChunk;
    const int total = steps * L::E * PIECES;
    for (int q = tid; q < total; q += threads) {
      const int c = q % PIECES, se = q / PIECES, e = se % L::E, s = se / L::E;
      cp_async16(stage + (s * L::E + e) * kRollGroup + c * VEC, row(e, t0 + s) + n0 + c * VEC);
    }
    for (int s = tid; s < steps; s += threads) stage[L::W + s] = w[t0 + s];
    cp_async_wait_all();
  }

  // The producer warps' loop over the chunks.
  template <class Roles>
  __device__ __forceinline__ void produce(S* ring, int n0, int warp) const {
    const int chunks = (T + kRollChunk - 1) / kRollChunk;
    const int tid = Roles::producer(warp) * 32 + threadIdx.x % 32;
    for (int k = 0; k < chunks; ++k) {
      ring_reserve<Roles::kBarrier>(k);
      fill(ring + (k % kStages) * RollSlot<DX, DU>::STAGE, k, n0, tid, 32 * Roles::kProducers);
      ring_publish<Roles::kBarrier>(k);
    }
  }
};

// One tracking step from a staged slot `op` (entry e at op[e·kRollGroup]):
// action, clip, stage cost, next state (the physics through `ops`).
template <class Env, typename S, class Ops>
__device__ __forceinline__ S track_step(const EnvParams& p, const S* __restrict__ op, S alpha,
                                        S w, S (&x)[Env::DX], S (&uprev)[Env::DU], Ops& ops) {
  constexpr int DX = Env::DX, DU = Env::DU, G = kRollGroup;
  using L = RollSlot<DX, DU>;
  S xr[DX], u[DU];
#pragma unroll
  for (int c = 0; c < DX; ++c) xr[c] = op[(L::XR + c) * G];
#pragma unroll
  for (int j = 0; j < DU; ++j) {
    S fb = op[(L::K + j * DX) * G] * (x[0] - xr[0]);
#pragma unroll
    for (int c = 1; c < DX; ++c) fb = fb + op[(L::K + j * DX + c) * G] * (x[c] - xr[c]);
    const S ff = op[(L::UR + j) * G] + alpha * op[(L::KFF + j) * G];
    u[j] = clip_(ff + fb, S(-p.umax[j]), S(p.umax[j]));
  }
  const S c = stage_cost<Env>(p, x, u, uprev, w);
  S xn[DX];
  dynamics<Env>(p, x, u, xn, ops);
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

// A rollout's carry from step to step: the state, the previous action, the
// return so far and the x < 1e8 flag.
template <class Env, typename S>
struct Rollout {
  S x[Env::DX], uprev[Env::DU], r;
  bool ok;

  // From the start state of instance n; the actions before it are zero.
  __device__ __forceinline__ Rollout(const S* __restrict__ xref, size_t np, int n, bool live)
      : r(S(0)), ok(true) {
#pragma unroll
    for (int c = 0; c < Env::DX; ++c) x[c] = live ? xref[c * np + n] : S(0);
#pragma unroll
    for (int j = 0; j < Env::DU; ++j) uprev[j] = S(0);
  }

  // Add the final stage cost (zero action) at the terminal state.
  __device__ __forceinline__ void finish(const EnvParams& p, S w) {
    S zeros[Env::DU];
#pragma unroll
    for (int j = 0; j < Env::DU; ++j) zeros[j] = S(0);
    r = r + stage_cost<Env>(p, x, zeros, zeros, w);
  }
};

// The consumer lanes' walk over the staged chunks: step(roll, op, w, t, ops)
// for every step t in order, op the lane's slot of the step in the stage.  A
// chunk runs with ChainOps; if any lane's numerator left the range of
// ChainOps' quotient there, the warp takes the chunk again from its start
// with ExactChainOps, and if any lane's sine argument left ChainOps' range,
// with LibOps.
template <class Roles, typename S, int DX, int DU, class Roll, class Step>
__device__ __forceinline__ void walk(const RollStreams<S, DX, DU>& in, const S* ring, int g,
                                     bool live, Roll& roll, Step&& step) {
  using L = RollSlot<DX, DU>;
  const int chunks = (in.T + kRollChunk - 1) / kRollChunk;
  for (int k = 0; k < chunks; ++k) {
    const S* stage = ring + (k % kStages) * L::STAGE;
    const int t0 = k * kRollChunk;
    const int steps = in.T - t0 < kRollChunk ? in.T - t0 : kRollChunk;
    ring_acquire<Roles::kBarrier>(k);
    if (live) {
      auto chunk = [&](auto& ops) {
        for (int s = 0; s < steps; ++s)
          step(roll, stage + s * L::E * kRollGroup + g, stage[L::W + s], t0 + s, ops);
      };
      const Roll start = roll;
      const unsigned lanes = __activemask();
      ChainOps fast;
      chunk(fast);
      bool wide = __any_sync(lanes, fast.wide);
      if constexpr (std::is_same<S, float>::value) {
        if (!wide && __any_sync(lanes, fast.far())) {
          roll = start;
          ExactChainOps exact;
          chunk(exact);
          wide = __any_sync(lanes, exact.wide);
        }
      }
      if (wide) {
        roll = start;
        LibOps lib;
        chunk(lib);
      }
    }
    ring_release<Roles::kBarrier>(k, chunks);
  }
}

// K2's block: consumer lane L rolls instance n0 + L mod kRollGroup out under
// candidate blockIdx.y·kAlphaBlock + L / kRollGroup.
using ReturnsRoles =
    WarpRoles<(kRollGroup * kAlphaBlock + 31) / 32, kRollProducers>;
// K3's block: consumer lane g < kRollGroup rolls instance n0 + g.
using SelectedRoles = WarpRoles<(kRollGroup + 31) / 32, kRollProducers>;

template <typename S, class Env>
__global__ void __launch_bounds__(ReturnsRoles::kThreads, 1) rollout_returns_kernel(
    EnvParams p, RollStreams<S, Env::DX, Env::DU> in, const S* __restrict__ alphas,
    S* __restrict__ ret, unsigned char* __restrict__ ok_out, int nA) {
  using R = ReturnsRoles;
  extern __shared__ __align__(16) unsigned char roll_smem[];
  S* ring = reinterpret_cast<S*>(roll_smem);
  const int n0 = blockIdx.x * kRollGroup;
  const int warp = threadIdx.x / 32;
  if (warp >= R::kConsumers) {
    if (!R::idle(warp)) in.template produce<R>(ring, n0, warp);
    return;
  }
  const int g = threadIdx.x % kRollGroup;
  const int a = blockIdx.y * kAlphaBlock + threadIdx.x / kRollGroup;
  const bool live = threadIdx.x < kRollGroup * kAlphaBlock && a < nA;
  const int n = n0 + g;
  const S alpha = live ? alphas[a] : S(0);
  Rollout<Env, S> roll(in.xref, in.np, n, live);
  walk<R>(in, ring, g, live, roll, [&](auto& ro, const S* op, S w, int, auto& ops) {
    ro.ok = below_1e8<Env>(ro.x) && ro.ok;
    ro.r = ro.r + track_step<Env>(p, op, alpha, w, ro.x, ro.uprev, ops);
  });
  if (!live) return;
  roll.finish(p, in.w[in.T]);
  ret[(size_t)a * in.np + n] = roll.r;
  ok_out[(size_t)a * in.np + n] = below_1e8<Env>(roll.x) && roll.ok ? 1 : 0;
}

template <typename S, class Env>
__global__ void __launch_bounds__(SelectedRoles::kThreads, 1) rollout_selected_kernel(
    EnvParams p, RollStreams<S, Env::DX, Env::DU> in, const S* __restrict__ alpha_l,
    S* __restrict__ xs, S* __restrict__ us, S* __restrict__ xT, S* __restrict__ ret) {
  constexpr int DX = Env::DX, DU = Env::DU;
  using R = SelectedRoles;
  extern __shared__ __align__(16) unsigned char roll_smem[];
  S* ring = reinterpret_cast<S*>(roll_smem);
  const int n0 = blockIdx.x * kRollGroup;
  const int warp = threadIdx.x / 32;
  if (warp >= R::kConsumers) {
    if (!R::idle(warp)) in.template produce<R>(ring, n0, warp);
    return;
  }
  const int g = threadIdx.x;
  const bool live = g < kRollGroup;
  const int n = n0 + g;
  const size_t np = in.np;
  const S alpha = live ? alpha_l[n] : S(0);
  Rollout<Env, S> roll(in.xref, np, n, live);
  walk<R>(in, ring, g, live, roll, [&](auto& ro, const S* op, S w, int t, auto& ops) {
#pragma unroll
    for (int c = 0; c < DX; ++c) xs[((size_t)t * DX + c) * np + n] = ro.x[c];
    ro.r = ro.r + track_step<Env>(p, op, alpha, w, ro.x, ro.uprev, ops);
#pragma unroll
    for (int j = 0; j < DU; ++j) us[((size_t)t * DU + j) * np + n] = ro.uprev[j];
  });
  if (!live) return;
  roll.finish(p, in.w[in.T]);
#pragma unroll
  for (int c = 0; c < DX; ++c) xT[c * np + n] = roll.x[c];
  ret[n] = roll.r;
}

template <typename S, class Env>
static RollStreams<S, Env::DX, Env::DU> streams(const void* const* in, int T, int Np) {
  return {(const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
          (size_t)Np, T};
}

template <typename S, class Env>
static int bytes() {
  return (int)sizeof(S) * kStages * RollSlot<Env::DX, Env::DU>::STAGE;
}

template <typename S, class Env>
static int launch_returns(const EnvParams& p, const void* const* in, void* const* out, int T,
                          int Np, int nA, cudaStream_t s) {
  if (Np % kRollGroup != 0) return -1;
  const dim3 grid(Np / kRollGroup, (nA + kAlphaBlock - 1) / kAlphaBlock);
  return launch_ring(rollout_returns_kernel<S, Env>, grid, ReturnsRoles::kThreads,
                     bytes<S, Env>(), s, p, streams<S, Env>(in, T, Np), (const S*)in[5],
                     (S*)out[0], (unsigned char*)out[1], nA);
}

template <typename S, class Env>
static int launch_selected(const EnvParams& p, const void* const* in, void* const* out, int T,
                           int Np, cudaStream_t s) {
  if (Np % kRollGroup != 0) return -1;
  return launch_ring(rollout_selected_kernel<S, Env>, dim3(Np / kRollGroup),
                     SelectedRoles::kThreads, bytes<S, Env>(), s, p,
                     streams<S, Env>(in, T, Np), (const S*)in[5], (S*)out[0], (S*)out[1],
                     (S*)out[2], (S*)out[3]);
}

// C entry points.  dtype: 0 float32, 1 float64; kind: envs.cuh's with_env
// (Cartpole and Pendulum, each with its Cartesian-cost variant).  Each returns the CUDA error of the launch, or -1
// for an unsupported (dtype, kind) or an Np that is not a multiple of the
// group (16).  The four streams must be 16-byte aligned.
extern "C" int trajopt_rollout_returns(int dtype, int kind, const EnvParams* params,
                                       const void* K, const void* kff, const void* xref,
                                       const void* uref, const void* w, const void* alphas,
                                       void* ret, void* ok, int T, int Np, int nA,
                                       void* stream) {
  const void* in[6] = {K, kff, xref, uref, w, alphas};
  void* out[2] = {ret, ok};
  cudaStream_t s = (cudaStream_t)stream;
  const EnvParams& p = *params;
  return with_env(kind, [&](auto env) {
    using Env = decltype(env);
    if (dtype == 0) return launch_returns<float, Env>(p, in, out, T, Np, nA, s);
    if (dtype == 1) return launch_returns<double, Env>(p, in, out, T, Np, nA, s);
    return -1;
  });
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
  return with_env(kind, [&](auto env) {
    using Env = decltype(env);
    if (dtype == 0) return launch_selected<float, Env>(p, in, out, T, Np, s);
    if (dtype == 1) return launch_selected<double, Env>(p, in, out, T, Np, s);
    return -1;
  });
}
