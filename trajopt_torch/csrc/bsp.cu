// K9 and K10: single-launch belief-space iLQR.
//
// K9 replaces trajopt_tpu/core/pallas_bsp.py::pallas_bsp_solve (kernel body
// :982): one whole BSP-iLQR solve, nb_iter iterations of
//   1. the expansion of the belief dynamics (the Jacobian of one EKF step
//      with respect to (μ, vec Σ, u)) and of the belief cost at every step;
//   2. the λ-escalated (S, s, τ) backward pass: the λ while-loop's trials
//      form a ladder that depends only on (λ, Δλ), so all 16 run at once and
//      the trial the loop would stop at is taken;
//   3. the belief rollouts of every α of the line search;
//   4. accept/reject, the λ update and the convergence test,
// with parallel/bsp.make_bsp_solver's semantics (dense value form).
// K10 replaces pallas_bsp.py::pallas_bsp_episode (kernel body :1054): one
// whole light-dark MPC episode, K9's solve at every control step from the
// current belief, the true noisy step and observation drawn from handed-in
// standard normals as mean + chol(cov)·ε, and a Joseph-form EKF update.
//
// What bounds them on the H100: latency.  A solve is a chain of nb_iter
// dependent iterations, each four dependent phases; the bytes (a few KB) and
// the operations (about 4 M per solve at T = 25, 10 iterations) are far below
// what the card could do in the time, and one block uses one of the 132 SMs.
//
// Design: one thread block per solve or episode (batch 1, as on the TPU),
// 128 threads.  The TPU kernel runs each phase on its 128 lanes; here each
// phase runs on the block's threads: thread t expands step t, thread k runs
// ladder trial k over the whole horizon, thread j rolls α_j out; between
// phases the ladder's choice and g_norm (a quotient a lane, max_'s NaN rule
// over the warp) and the accept test (an α a lane, the first acceptable one
// by ballot) run on warp 0.  The phases hand over through a scratch in the
// block's shared memory (dynamic, sized from T and the number of α; a
// configuration too large for it keeps the wrapper's device buffer) and
// scalars in static shared memory, with __syncthreads() between them.  The
// expansion differentiates the EKF step with nested dual numbers (dual.cuh):
// tangents over (μ, vec Σ, u) outside, and inside them the Jacobians of the
// dynamics and the observation model that the EKF step takes.  The belief
// cost is the quadratic form of every belief env, so its expansion is
// written in closed form (the values autodiff gives exactly).  In float the
// phases divide and take square roots with PivotOps (pivot.cuh: the
// library's bits without its slow paths; an operand outside [2^-100, 2^100)
// goes to an exact out-of-line division), f32_floor's tr/2 is tr·0.5; thread
// 0's once-a-step filter keeps the library's operations.  Measured first
// (PERF.md): the ladder and the rollouts were 89 % of an iteration;
// the outputs are bit for bit those of the kernel that divided with the
// library and kept its scratch in device memory.
#include <cuda_runtime.h>

#include <type_traits>

#include "bwd_step.cuh"
#include "dual.cuh"
#include "pivot.cuh"

namespace {

constexpr int NL = 16;          // λ-ladder trials
constexpr int THREADS = 128;    // ≥ T + 1, ≥ NL, ≥ the number of α
constexpr int MAX_ALPHAS = 128;
// The most dynamic shared memory the scratch may take (of the 227 KB a
// block can have, beside the static Shared); a larger one stays in device
// memory.
constexpr size_t SMEM_MAX = 224 * 1024;

}  // namespace

// The env's and the solve's parameters, passed by value (core/cuda_bsp.py
// _Params).  Unused tail entries are zero.
struct BSPParams {
  double dt;
  double xmax[4];
  double umax[2];
  double goal[4];
  double mu_w[4];
  double sigma_w[4];
  double act_w[2];
  double dyn_sigma;
  double obs_sigma;
  double mu_init[4];    // the env's initial belief (env.init()), for K10
  double sig_init[16];
  double lmbda, min_lmbda, max_lmbda, mult_lmbda, tolfun, tolgrad, min_imp;
  double alphas[MAX_ALPHAS];
  int T, nb_iter, nA, reg;
};

// Light-dark (envs/lightdark.py): clipped single integrator, identity
// observation, noise ½(5 − x₀)² on the first channel over a floor.
struct LightDark {
  static constexpr int B = 2, A = 2, DO = 2;

  template <typename T>
  __device__ static __forceinline__ void dynamics(const BSPParams& p, const T (&x)[B],
                                                  const T (&u)[A], T (&xn)[B]) {
    using R = typename RealOf<T>::type;
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const T ui = clip_(u[i], R(-p.umax[i]), R(p.umax[i]));
      xn[i] = clip_(x[i] + R(p.dt) * ui, R(-p.xmax[i]), R(p.xmax[i]));
    }
  }

  template <typename T>
  __device__ static __forceinline__ void observe(const T (&x)[B], T (&y)[DO]) {
#pragma unroll
    for (int i = 0; i < DO; ++i) y[i] = x[i];
  }

  template <typename T>
  __device__ static __forceinline__ void obs_noise(const BSPParams& p, const T (&x)[B],
                                                   T (&Rn)[DO][DO]) {
    using R = typename RealOf<T>::type;
    const T d = R(5) - x[0];
    Rn[0][0] = R(p.obs_sigma) + R(0.5) * (d * d);
    Rn[0][1] = T(R(0));
    Rn[1][0] = T(R(0));
    Rn[1][1] = T(R(p.obs_sigma));
  }
};

namespace {

// ---- how the kernels divide and take square roots ---------------------------------

// The library's operations: float64, and thread 0's once-a-step filter.
struct LibDiv {
  template <typename T>
  __device__ static __forceinline__ T div(const T& a, const T& b) { return a / b; }
  template <typename T>
  __device__ static __forceinline__ T sqrt(const T& a) { return sqrt_(a); }
};

// float on the chain: the same bits without the slow-path branches.
//   - a / b: PivotOps::div, a / b's bits for every pair of floats; a dual's
//     quotient keeps dual.cuh's tangents (a.d − q·b.d) · (1/b.v) with 1/b.v
//     a PivotOps quotient too.
//   - sqrt: PivotOps::sqrt, sqrtf's bits for every float; a dual's
//     derivative factor 0.5/√a as 0.5 · PivotOps::rcp(√a), exact for every
//     root of a float (no underflow or overflow).
struct FastDiv {
  __device__ static __forceinline__ float div(float a, float b) { return PivotOps::div(a, b); }
  template <int N>
  __device__ static __forceinline__ Dual<float, N> div(const Dual<float, N>& a,
                                                       const Dual<float, N>& b) {
    Dual<float, N> r;
    r.v = PivotOps::div(a.v, b.v);
    const float inv = PivotOps::div(1.0f, b.v);
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
    return r;
  }
  __device__ static __forceinline__ float sqrt(float a) { return PivotOps::sqrt(a); }
  template <int N>
  __device__ static __forceinline__ Dual<float, N> sqrt(const Dual<float, N>& a) {
    Dual<float, N> r;
    r.v = PivotOps::sqrt(a.v);
    const float h = 0.5f * PivotOps::rcp(r.v);
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * h;
    return r;
  }
};

// The operations of a phase: FastDiv in float, the library's in float64.
template <typename S>
using PhaseOps = typename std::conditional<std::is_same<S, float>::value, FastDiv, LibDiv>::type;

// ---- small linear algebra on (possibly dual) scalars --------------------------------

// C = A Bᵀ for A (n, k), B (m, k).
template <typename T, int N, int K, int M>
__device__ __forceinline__ void mm_nt(const T (&A)[N][K], const T (&B)[M][K], T (&C)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T s = A[i][0] * B[j][0];
#pragma unroll
      for (int l = 1; l < K; ++l) s = s + A[i][l] * B[j][l];
      C[i][j] = s;
    }
}

// Unguarded Cholesky (pallas_bsp.py _chol_t): NaN entries for a non-PD input,
// as jnp.linalg.cholesky flags it.
template <class Ops, typename T, int N>
__device__ __forceinline__ void chol_t(const T (&M)[N][N], T (&L)[N][N], Ops& ops) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T d = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k];
    L[j][j] = ops.sqrt(d);
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T r = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = r - L[i][k] * L[j][k];
      L[i][j] = ops.div(r, L[j][j]);
    }
#pragma unroll
    for (int i = 0; i < j; ++i) L[i][j] = T(typename RealOf<T>::type(0));
  }
}

// Solve (L Lᵀ) x = v by forward and back substitution with divisions
// (pallas_bsp.py _chol_solve_vec).
template <class Ops, typename T, int N>
__device__ __forceinline__ void chol_solve_t(const T (&L)[N][N], const T (&v)[N], T (&x)[N],
                                             Ops& ops) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T r = v[i];
#pragma unroll
    for (int k = 0; k < i; ++k) r = r - L[i][k] * y[k];
    y[i] = ops.div(r, L[i][i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T r = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) r = r - L[k][i] * x[k];
    x[i] = ops.div(r, L[i][i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void symmetrize(T (&M)[N][N]) {
  using R = typename RealOf<T>::type;
  T out[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i][j] = R(0.5) * (M[i][j] + M[j][i]);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) M[i][j] = out[i][j];
}

// The float32-only relative diagonal floor of core/ekf._psd_floor and
// _inv: M + 1e-5 (tr M / n + 1e-12) I; nothing in float64.  For n a power
// of two tr / n is tr · (1/n), the same bits for every float.
template <class Ops, typename T, int N>
__device__ __forceinline__ void f32_floor(T (&M)[N][N], Ops& ops) {
  using R = typename RealOf<T>::type;
  if (sizeof(R) != 4) return;
  T tr = M[0][0];
#pragma unroll
  for (int i = 1; i < N; ++i) tr = tr + M[i][i];
  T scale;
  if constexpr ((N & (N - 1)) == 0)
    scale = tr * R(1.0 / N) + R(1e-12);
  else
    scale = ops.div(tr, T(R(N))) + R(1e-12);
  const T jit = R(1e-5) * scale;
#pragma unroll
  for (int i = 0; i < N; ++i) M[i][i] = M[i][i] + jit;
}

// core/ekf._inv: symmetrize, the float32 jitter, inverse through Cholesky.
template <class Ops, typename T, int N>
__device__ __forceinline__ void inv_psd(const T (&S_in)[N][N], T (&X)[N][N], Ops& ops) {
  using R = typename RealOf<T>::type;
  T S[N][N], L[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) S[i][j] = S_in[i][j];
  symmetrize(S);
  f32_floor(S, ops);
  chol_t(S, L, ops);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    T e[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = T(R(i == c ? 1 : 0));
    chol_solve_t(L, e, x, ops);
#pragma unroll
    for (int i = 0; i < N; ++i) X[i][c] = x[i];
  }
}

// The dynamics, its value and its Jacobian in x, through one more dual level.
template <class Env, typename T>
__device__ __forceinline__ void dynamics_jac(const BSPParams& p, const T (&x)[Env::B],
                                             const T (&u)[Env::A], T (&f)[Env::B],
                                             T (&J)[Env::B][Env::B]) {
  using R = typename RealOf<T>::type;
  using D = Dual<T, Env::B>;
  D xd[Env::B], ud[Env::A], fd[Env::B];
#pragma unroll
  for (int i = 0; i < Env::B; ++i) {
    xd[i] = D(x[i]);
    xd[i].d[i] = T(R(1));
  }
#pragma unroll
  for (int j = 0; j < Env::A; ++j) ud[j] = D(u[j]);
  Env::dynamics(p, xd, ud, fd);
#pragma unroll
  for (int i = 0; i < Env::B; ++i) {
    f[i] = fd[i].v;
#pragma unroll
    for (int k = 0; k < Env::B; ++k) J[i][k] = fd[i].d[k];
  }
}

// The observation model's value and Jacobian.
template <class Env, typename T>
__device__ __forceinline__ void observe_jac(const T (&x)[Env::B], T (&y)[Env::DO],
                                            T (&H)[Env::DO][Env::B]) {
  using R = typename RealOf<T>::type;
  using D = Dual<T, Env::B>;
  D xd[Env::B], yd[Env::DO];
#pragma unroll
  for (int i = 0; i < Env::B; ++i) {
    xd[i] = D(x[i]);
    xd[i].d[i] = T(R(1));
  }
  Env::observe(xd, yd);
#pragma unroll
  for (int i = 0; i < Env::DO; ++i) {
    y[i] = yd[i].v;
#pragma unroll
    for (int k = 0; k < Env::B; ++k) H[i][k] = yd[i].d[k];
  }
}

// Joseph-form update (I − KH) P (I − KH)ᵀ + K R Kᵀ, symmetrized and floored.
template <class Ops, typename T, int B, int DO>
__device__ __forceinline__ void joseph(const T (&P)[B][B], const T (&K)[B][DO],
                                       const T (&H)[DO][B], const T (&Rn)[DO][DO],
                                       T (&out)[B][B], Ops& ops) {
  using R = typename RealOf<T>::type;
  T KH[B][B], I_KH[B][B], IP[B][B], IPI[B][B], KR[B][DO], KRK[B][B];
  mm(K, H, KH);
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) I_KH[i][j] = T(R(i == j ? 1 : 0)) - KH[i][j];
  mm(I_KH, P, IP);
  mm_nt(IP, I_KH, IPI);
  mm(K, Rn, KR);
  mm_nt(KR, K, KRK);
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) out[i][j] = IPI[i][j] + KRK[i][j];
  symmetrize(out);
  f32_floor(out, ops);
}

// core/ekf.belief_ekf_step: (f, W, Φ) of one EKF predict and gain step.
template <class Env, class Ops, typename T>
__device__ __forceinline__ void ekf_step(const BSPParams& p, const T (&mu)[Env::B],
                                         const T (&sig)[Env::B][Env::B], const T (&u)[Env::A],
                                         T (&f)[Env::B], T (&W)[Env::B][Env::B],
                                         T (&phi)[Env::B][Env::B], Ops& ops) {
  using R = typename RealOf<T>::type;
  constexpr int B = Env::B, DO = Env::DO;
  T Am[B][B], y[DO], H[DO][B], Rn[DO][DO];
  dynamics_jac<Env>(p, mu, u, f, Am);
  observe_jac<Env>(f, y, H);
  Env::obs_noise(p, f, Rn);

  T AS[B][B], ASA[B][B], D[B][B];
  mm(Am, sig, AS);
  mm_nt(AS, Am, ASA);
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) D[i][j] = i == j ? ASA[i][j] + R(p.dyn_sigma) : ASA[i][j];
  symmetrize(D);

  T HD[DO][B], Sm[DO][DO], Sinv[DO][DO], DH[B][DO], K[B][DO], KH[B][B];
  mm(H, D, HD);
  mm_nt(HD, H, Sm);
#pragma unroll
  for (int i = 0; i < DO; ++i)
#pragma unroll
    for (int j = 0; j < DO; ++j) Sm[i][j] = Sm[i][j] + Rn[i][j];
  inv_psd(Sm, Sinv, ops);
  mm_nt(D, H, DH);
  mm(DH, Sinv, K);
  mm(K, H, KH);
  mm(KH, D, W);
  joseph(D, K, H, Rn, phi, ops);
}

// core/ekf.EKF.innovate against the observation z.
template <class Env, typename S>
__device__ __forceinline__ void ekf_innovate(const BSPParams& p, S (&mu)[Env::B],
                                             S (&cov)[Env::B][Env::B], const S (&z)[Env::DO]) {
  constexpr int B = Env::B, DO = Env::DO;
  S y[DO], H[DO][B], Rn[DO][DO];
  observe_jac<Env>(mu, y, H);
  Env::obs_noise(p, mu, Rn);
  S HC[DO][B], Sm[DO][DO], Sinv[DO][DO], CH[B][DO], K[B][DO], innov[DO], Ki[B];
  mm(H, cov, HC);
  mm_nt(HC, H, Sm);
#pragma unroll
  for (int i = 0; i < DO; ++i)
#pragma unroll
    for (int j = 0; j < DO; ++j) Sm[i][j] = Sm[i][j] + Rn[i][j];
  LibDiv lib;
  inv_psd(Sm, Sinv, lib);
  mm_nt(cov, H, CH);
  mm(CH, Sinv, K);
#pragma unroll
  for (int i = 0; i < DO; ++i) innov[i] = z[i] - y[i];
  mv(K, innov, Ki);
#pragma unroll
  for (int i = 0; i < B; ++i) mu[i] = mu[i] + Ki[i];
  S out[B][B];
  joseph(cov, K, H, Rn, out, lib);
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) cov[i][j] = out[i][j];
}

// mean + chol(cov) ε (pallas_bsp.py _noisy).
template <typename S, int N>
__device__ __forceinline__ void noisy(const S (&mean)[N], S (&cov)[N][N], const S* eps,
                                      S (&out)[N]) {
  S L[N][N];
  symmetrize(cov);
  LibDiv lib;
  chol_t(cov, L, lib);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s = L[i][0] * eps[0];
#pragma unroll
    for (int k = 1; k <= i; ++k) s = s + L[i][k] * eps[k];
    out[i] = mean[i] + s;
  }
}

// The belief cost Σ μw (μ − g)² + Σ Σw Σᵢᵢ + Σ Rw u² (belief_cost_parts).
template <class Env, typename S>
__device__ __forceinline__ S belief_cost(const BSPParams& p, const S (&mu)[Env::B],
                                         const S* sig, const S (&u)[Env::A]) {
  S c = S(0);
#pragma unroll
  for (int i = 0; i < Env::B; ++i) {
    const S d = mu[i] - S(p.goal[i]);
    c = c + S(p.mu_w[i]) * (d * d);
  }
  S cs = S(0);
#pragma unroll
  for (int i = 0; i < Env::B; ++i) cs = cs + S(p.sigma_w[i]) * sig[i * Env::B + i];
  S cu = S(0);
#pragma unroll
  for (int j = 0; j < Env::A; ++j) cu = cu + S(p.act_w[j]) * u[j] * u[j];
  return c + cs + cu;
}

template <typename S>
__device__ __forceinline__ S max_(S a, S b) { return (a != a || a > b) ? a : b; }
template <typename S>
__device__ __forceinline__ S min_(S a, S b) { return (a != a || a < b) ? a : b; }

// Views of the scratch (core/cuda_bsp.py _scratch_size): the block's
// shared memory where it fits, else the wrapper's buffer in device memory.
template <class Env, typename S>
struct Scratch {
  static constexpr int B = Env::B, A = Env::A, BB = B * B;
  S *Q, *q, *R, *r, *P, *p, *F, *G, *X, *Y, *Z, *Tm, *U, *V;  // expansion, per step
  S *Ktr, *kfftr;                                              // [NL][T] ladder gains
  S *rmu, *rsig, *ru;                                          // [nA][T+1] rollouts
  S *mu, *sig, *u, *K, *kff;                                   // the solve's state

  __device__ Scratch(S* base, int T, int nA) {
    const int T1 = T + 1;
    S* e = base;
    auto take = [&e](int n) { S* out = e; e += n; return out; };
    Q = take(T1 * B * B); q = take(T1 * B); R = take(T1 * A * A); r = take(T1 * A);
    P = take(T1 * B * A); p = take(T1 * BB); F = take(T1 * B * B); G = take(T1 * B * A);
    X = take(T1 * BB * B); Y = take(T1 * BB * BB); Z = take(T1 * BB * A);
    Tm = take(T1 * BB * B); U = take(T1 * BB * BB); V = take(T1 * BB * A);
    Ktr = take(NL * T * A * B); kfftr = take(NL * T * A);
    rmu = take(nA * T1 * B); rsig = take(nA * T1 * BB); ru = take(nA * T1 * A);
    mu = take(T1 * B); sig = take(T1 * BB); u = take(T * A); K = take(T * A * B);
    kff = take(T * A);
  }

  // Scalars in all, as the constructor takes them.
  static size_t size(int T, int nA) {
    const size_t T1 = T + 1;
    return T1 * (B * B + B + A * A + A + B * A + BB + B * B + B * A + 2 * BB * B + 2 * BB * BB +
                 2 * BB * A) +
           (size_t)NL * T * (A * B + A) + (size_t)nA * T1 * (B + BB + A) + T1 * (B + BB) +
           (size_t)T * (A + A * B + A);
  }
};

// The solve's scalars, in shared memory.
template <typename S>
struct Shared {
  S lam, dlam, last_return;
  int done;
  S ds0[NL], ds1[NL];
  int bad[NL];
  S ret[MAX_ALPHAS];
  int fin[MAX_ALPHAS];
  int trial, alpha, take, div, grad_done;
  S lam_out, dl_out, dS0, dS1;
};

// ---- phase 1: the expansion of step t (thread t) -----------------------------------

template <class Env, class Ops, typename S>
__device__ void expand_step(const BSPParams& p, const Scratch<Env, S>& sc, int t, int T,
                            Ops& ops) {
  constexpr int B = Env::B, A = Env::A, BB = B * B, NZ = B + BB + A;
  // the belief cost's closed-form expansion (u = 0 at t = T)
  {
    S uu[A];
#pragma unroll
    for (int j = 0; j < A; ++j) uu[j] = t < T ? sc.u[t * A + j] : S(0);
#pragma unroll
    for (int i = 0; i < B; ++i) {
#pragma unroll
      for (int j = 0; j < B; ++j) sc.Q[(t * B + i) * B + j] = i == j ? S(2) * S(p.mu_w[i]) : S(0);
      sc.q[t * B + i] = S(2) * (S(p.mu_w[i]) * (sc.mu[t * B + i] - S(p.goal[i])));
#pragma unroll
      for (int j = 0; j < A; ++j) sc.P[(t * B + i) * A + j] = S(0);
#pragma unroll
      for (int j = 0; j < B; ++j) sc.p[t * BB + i * B + j] = i == j ? S(p.sigma_w[i]) : S(0);
    }
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j < A; ++j) sc.R[(t * A + i) * A + j] = i == j ? S(2) * S(p.act_w[i]) : S(0);
      sc.r[t * A + i] = S(2) * (S(p.act_w[i]) * uu[i]);
    }
  }
  if (t >= T) return;

  using E = Dual<S, NZ>;
  E m[B], sg[B][B], uu[A], f[B], W[B][B], phi[B][B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    m[i] = E(sc.mu[t * B + i]);
    m[i].d[i] = S(1);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      sg[i][j] = E(sc.sig[t * BB + i * B + j]);
      sg[i][j].d[B + i * B + j] = S(1);
    }
  }
#pragma unroll
  for (int j = 0; j < A; ++j) {
    uu[j] = E(sc.u[t * A + j]);
    uu[j].d[B + BB + j] = S(1);
  }
  ekf_step<Env>(p, m, sg, uu, f, W, phi, ops);
#pragma unroll
  for (int i = 0; i < B; ++i) {
#pragma unroll
    for (int k = 0; k < B; ++k) sc.F[(t * B + i) * B + k] = f[i].d[k];
#pragma unroll
    for (int k = 0; k < A; ++k) sc.G[(t * B + i) * A + k] = f[i].d[B + BB + k];
  }
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int row = t * BB + i * B + j;
#pragma unroll
      for (int k = 0; k < B; ++k) {
        sc.X[row * B + k] = W[i][j].d[k];
        sc.Tm[row * B + k] = phi[i][j].d[k];
      }
#pragma unroll
      for (int k = 0; k < BB; ++k) {
        sc.Y[row * BB + k] = W[i][j].d[B + k];
        sc.U[row * BB + k] = phi[i][j].d[B + k];
      }
#pragma unroll
      for (int k = 0; k < A; ++k) {
        sc.Z[row * A + k] = W[i][j].d[B + BB + k];
        sc.V[row * A + k] = phi[i][j].d[B + BB + k];
      }
    }
}

// ---- phase 2: ladder trial k over the horizon (thread k) ---------------------------

template <typename S>
__device__ __forceinline__ void ladder(const BSPParams& p, S lam, S dlam, int k, S& lam_k,
                                       S& dl_k) {
  for (int i = 0; i < k; ++i) {
    dlam = max_(dlam * S(p.mult_lmbda), S(p.mult_lmbda));
    lam = max_(lam * dlam, S(p.min_lmbda));
  }
  lam_k = lam;
  dl_k = dlam;
}

// y = Mᵀ x for an (R, C) block stored row-major.
template <typename S, int R, int C>
__device__ __forceinline__ void mv_tn_ptr(const S* M, const S (&x)[R], S (&y)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    S s = M[i] * x[0];
#pragma unroll
    for (int l = 1; l < R; ++l) s = s + M[l * C + i] * x[l];
    y[i] = s;
  }
}

template <typename S, int R, int C>
__device__ __forceinline__ void load_mat(const S* M, S (&out)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) out[i][j] = M[i * C + j];
}

// The (S, s, τ) recursion at λ (pallas_bsp.py _ladder_backward, one trial).
template <class Env, class Ops, typename S>
__device__ void trial(const BSPParams& p, const Scratch<Env, S>& sc, Shared<S>& sh, int k,
                      int T, Ops& ops) {
  constexpr int B = Env::B, A = Env::A, BB = B * B;
  S lam, dl_unused;
  ladder(p, sh.lam, sh.dlam, k, lam, dl_unused);
  S Sv[B][B], sv[B], tau[BB];
  load_mat(sc.Q + T * B * B, Sv);
#pragma unroll
  for (int i = 0; i < B; ++i) sv[i] = sc.q[T * B + i];
#pragma unroll
  for (int i = 0; i < BB; ++i) tau[i] = sc.p[T * BB + i];
  S ds0 = S(0), ds1 = S(0);
  bool bad = false;

  for (int t = T - 1; t >= 0; --t) {
    S Q[B][B], Rm[A][A], P[B][A], F[B][B], G[B][A];
    load_mat(sc.Q + t * B * B, Q);
    load_mat(sc.R + t * A * A, Rm);
    load_mat(sc.P + t * B * A, P);
    load_mat(sc.F + t * B * B, F);
    load_mat(sc.G + t * B * A, G);

    S FtS[B][B], GtS[A][B], D[A][A], E[A][B];
    mm_tn(F, Sv, FtS);
    mm_tn(G, Sv, GtS);
    {
      S GtSG[A][A], FtSG[B][A];
      mm(GtS, G, GtSG);
      mm(FtS, G, FtSG);
#pragma unroll
      for (int i = 0; i < A; ++i) {
#pragma unroll
        for (int j = 0; j < A; ++j) D[i][j] = Rm[i][j] + GtSG[i][j];
#pragma unroll
        for (int j = 0; j < B; ++j) E[i][j] = P[j][i] + FtSG[j][i];
      }
    }
    S vecS[BB];
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j) vecS[i * B + j] = Sv[i][j];

    S c[B], d[A], e[BB];
    {
      S a1[B], a2[B], a3[B];
      mv_tn(F, sv, a1);
      mv_tn_ptr<S, BB, B>(sc.Tm + t * BB * B, tau, a2);
      mv_tn_ptr<S, BB, B>(sc.X + t * BB * B, vecS, a3);
#pragma unroll
      for (int i = 0; i < B; ++i) c[i] = sc.q[t * B + i] + a1[i] + a2[i] + S(0.5) * a3[i];
    }
    {
      S a1[A], a2[A], a3[A];
      mv_tn(G, sv, a1);
      mv_tn_ptr<S, BB, A>(sc.V + t * BB * A, tau, a2);
      mv_tn_ptr<S, BB, A>(sc.Z + t * BB * A, vecS, a3);
#pragma unroll
      for (int i = 0; i < A; ++i) d[i] = sc.r[t * A + i] + a1[i] + a2[i] + S(0.5) * a3[i];
    }
    {
      S a2[BB], a3[BB];
      mv_tn_ptr<S, BB, BB>(sc.U + t * BB * BB, tau, a2);
      mv_tn_ptr<S, BB, BB>(sc.Y + t * BB * BB, vecS, a3);
#pragma unroll
      for (int i = 0; i < BB; ++i) e[i] = sc.p[t * BB + i] + a2[i] + S(0.5) * a3[i];
    }

    S D_reg[A][A], E_reg[A][B];
    if (p.reg == 2) {
      S Sr[B][B], FtSr[B][B], GtSr[A][B], FtSrG[B][A], GtSrG[A][A];
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) Sr[i][j] = i == j ? Sv[i][j] + lam : Sv[i][j];
      mm_tn(F, Sr, FtSr);
      mm(FtSr, G, FtSrG);
      mm_tn(G, Sr, GtSr);
      mm(GtSr, G, GtSrG);
#pragma unroll
      for (int i = 0; i < A; ++i) {
#pragma unroll
        for (int j = 0; j < B; ++j) E_reg[i][j] = P[j][i] + FtSrG[j][i];
#pragma unroll
        for (int j = 0; j < A; ++j) D_reg[i][j] = Rm[i][j] + GtSrG[i][j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < A; ++i) {
#pragma unroll
        for (int j = 0; j < B; ++j) E_reg[i][j] = E[i][j];
#pragma unroll
        for (int j = 0; j < A; ++j) D_reg[i][j] = i == j ? D[i][j] + lam : D[i][j];
      }
    }
    symmetrize(D_reg);
    S L[A][A];
    chol_t(D_reg, L, ops);
    // a failed factorization: entry by entry, the identity's (bsp_backward's
    // where(isfinite(chol), chol, I))
    bool ok = true;
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        if (!finite_(L[i][j])) {
          ok = false;
          L[i][j] = i == j ? S(1) : S(0);
        }
      }
    bad = bad || !ok;

    S K[A][B], kff[A];
#pragma unroll
    for (int col = 0; col < B; ++col) {
      S v[A], x[A];
#pragma unroll
      for (int i = 0; i < A; ++i) v[i] = E_reg[i][col];
      chol_solve_t(L, v, x, ops);
#pragma unroll
      for (int i = 0; i < A; ++i) K[i][col] = -x[i];
    }
    {
      S x[A];
      chol_solve_t(L, d, x, ops);
#pragma unroll
      for (int i = 0; i < A; ++i) kff[i] = -x[i];
    }

    S Dk[A];
    mv(D, kff, Dk);
    ds0 = ds0 + dot(kff, d);
    ds1 = ds1 + S(0.5) * dot(kff, Dk);

    S KtD[B][A];
    mm_tn(K, D, KtD);
    {
      S a1[B], a2[B], a3[B];
      mv(KtD, kff, a1);
      mv_tn(K, d, a2);
      mv_tn(E, kff, a3);
#pragma unroll
      for (int i = 0; i < B; ++i) sv[i] = c[i] + a1[i] + a2[i] + a3[i];
    }
    {
      S FtSF[B][B], KtDK[B][B], KtE[B][B], EtK[B][B];
      mm(FtS, F, FtSF);
      mm(KtD, K, KtDK);
      mm_tn(K, E, KtE);
      mm_tn(E, K, EtK);
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j)
          Sv[i][j] = ((Q[i][j] + FtSF[i][j]) + KtDK[i][j]) + (KtE[i][j] + EtK[i][j]);
      symmetrize(Sv);
    }
#pragma unroll
    for (int i = 0; i < BB; ++i) tau[i] = e[i];

    S* Kt = sc.Ktr + ((size_t)k * T + t) * A * B;
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j < B; ++j) Kt[i * B + j] = K[i][j];
      sc.kfftr[((size_t)k * T + t) * A + i] = kff[i];
    }
  }
  sh.ds0[k] = ds0;
  sh.ds1[k] = ds1;
  sh.bad[k] = bad ? 1 : 0;
}

// ---- phase 3: the belief rollout of α_j (thread j) ---------------------------------

template <class Env, class Ops, typename S>
__device__ void rollout(const BSPParams& p, const Scratch<Env, S>& sc, Shared<S>& sh, int j,
                        int T, const S* Kg, const S* kffg, const S* mu0, const S* sig0,
                        Ops& ops) {
  constexpr int B = Env::B, A = Env::A, BB = B * B;
  const S alpha = S(p.alphas[j]);
  S mu[B], sig[B][B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    mu[i] = mu0[i];
#pragma unroll
    for (int l = 0; l < B; ++l) sig[i][l] = sig0[i * B + l];
  }
  S ret = S(0);
  bool fin = true;
  S* rmu = sc.rmu + (size_t)j * (T + 1) * B;
  S* rsig = sc.rsig + (size_t)j * (T + 1) * BB;
  S* ru = sc.ru + (size_t)j * (T + 1) * A;
  for (int t = 0; t <= T; ++t) {
    S u[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      if (t == T) {
        u[i] = S(0);
        continue;
      }
      S fb = Kg[(t * A + i) * B] * (mu[0] - sc.mu[t * B]);
#pragma unroll
      for (int c = 1; c < B; ++c) fb = fb + Kg[(t * A + i) * B + c] * (mu[c] - sc.mu[t * B + c]);
      u[i] = (sc.u[t * A + i] + alpha * kffg[t * A + i]) + fb;
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      rmu[t * B + i] = mu[i];
      fin = fin && (mu[i] < S(1e8));
#pragma unroll
      for (int l = 0; l < B; ++l) rsig[t * BB + i * B + l] = sig[i][l];
    }
#pragma unroll
    for (int i = 0; i < A; ++i) ru[t * A + i] = u[i];
    ret = ret + belief_cost<Env>(p, mu, rsig + t * BB, u);
    if (t == T) break;
    S f[B], W[B][B], phi[B][B];
    ekf_step<Env>(p, mu, sig, u, f, W, phi, ops);
#pragma unroll
    for (int i = 0; i < B; ++i) {
      mu[i] = f[i];
#pragma unroll
      for (int l = 0; l < B; ++l) sig[i][l] = phi[i][l];
    }
  }
  sh.ret[j] = ret;
  sh.fin[j] = fin ? 1 : 0;
}

// Copy rollout j into the solve's reference (all threads).
template <class Env, typename S>
__device__ void take_rollout(const Scratch<Env, S>& sc, int j, int T) {
  constexpr int B = Env::B, A = Env::A, BB = B * B;
  const int tid = threadIdx.x;
  for (int i = tid; i < (T + 1) * B; i += blockDim.x) sc.mu[i] = sc.rmu[(size_t)j * (T + 1) * B + i];
  for (int i = tid; i < (T + 1) * BB; i += blockDim.x)
    sc.sig[i] = sc.rsig[(size_t)j * (T + 1) * BB + i];
  for (int i = tid; i < T * A; i += blockDim.x) sc.u[i] = sc.ru[(size_t)j * (T + 1) * A + i];
}

// ---- the solve (all threads of the block) ------------------------------------------

// max_'s rule over warp 0's lanes: NaN where any lane holds NaN, else the
// largest, whatever the order.
template <typename S>
__device__ __forceinline__ S warp_max(S m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const S o = __shfl_xor_sync(0xffffffffu, m, off);
    m = m != m ? m : max_(o, m);
  }
  return m;
}

template <class Env, typename S>
__device__ void solve_core(const BSPParams& p, const Scratch<Env, S>& sc, Shared<S>& sh,
                           const S* mu0, const S* sig0, S* trace) {
  constexpr int B = Env::B, A = Env::A;
  const int tid = threadIdx.x, lane = tid & 31, T = p.T, nA = p.nA;

  // the initial trajectory: zero gains and kff, reference mean μ₀ at t = 0
  for (int i = tid; i < (T + 1) * B; i += blockDim.x) sc.mu[i] = i < B ? mu0[i] : S(0);
  for (int i = tid; i < T * A; i += blockDim.x) {
    sc.u[i] = S(0);
    sc.kff[i] = S(0);
  }
  for (int i = tid; i < T * A * B; i += blockDim.x) sc.K[i] = S(0);
  __syncthreads();
  PhaseOps<S> ops;
  if (tid < nA) rollout<Env>(p, sc, sh, tid, T, sc.K, sc.kff, mu0, sig0, ops);
  __syncthreads();
  if (tid == 0) {
    int idx = 0;
    for (int j = nA - 1; j >= 0; --j)
      if (sh.fin[j]) idx = j;
    sh.alpha = idx;
    sh.last_return = sh.ret[idx];
    sh.lam = S(p.lmbda);
    sh.dlam = S(1);
    sh.done = 0;
  }
  __syncthreads();
  take_rollout(sc, sh.alpha, T);
  __syncthreads();

  for (int it = 0; it < p.nb_iter; ++it) {
    if (sh.done) {
      if (tid == 0 && trace != nullptr) trace[it] = sh.last_return;
      continue;
    }
    // 1. expansion
    if (tid <= T) expand_step<Env>(p, sc, tid, T, ops);
    __syncthreads();
    // 2. the λ ladder
    if (tid < NL) trial<Env>(p, sc, sh, tid, T, ops);
    __syncthreads();
    // the ladder's choice on every lane of warp 0, g_norm a quotient a lane
    if (tid < 32) {
      S lams[NL + 1], dls[NL + 1];
      lams[0] = sh.lam;
      dls[0] = sh.dlam;
      for (int k = 0; k < NL; ++k) {
        dls[k + 1] = max_(dls[k] * S(p.mult_lmbda), S(p.mult_lmbda));
        lams[k + 1] = max_(lams[k] * dls[k + 1], S(p.min_lmbda));
      }
      int idx = NL - 1;
      for (int k = NL - 1; k >= 0; --k)
        if (!sh.bad[k] || lams[k + 1] > S(p.max_lmbda)) idx = k;
      const bool div = sh.bad[idx] && lams[idx] <= S(p.max_lmbda);
      const S lam_out = div ? lams[idx + 1] : lams[idx];
      // g_norm = mean_j max_t |kff| / (|uref| + 1)
      const S* kff = sc.kfftr + (size_t)idx * T * A;
      S g = S(0);
      for (int j = 0; j < A; ++j) {
        S m = -INFINITY;
        for (int t = lane; t < T; t += 32)
          m = max_(fabs(kff[t * A + j]) / (fabs(sc.u[t * A + j]) + S(1)), m);
        g = g + warp_max(m);
      }
      g = g / S(A);
      if (lane == 0) {
        sh.trial = idx;
        sh.div = div;
        sh.lam_out = lam_out;
        sh.dl_out = div ? dls[idx + 1] : dls[idx];
        sh.dS0 = sh.ds0[idx];
        sh.dS1 = sh.ds1[idx];
        sh.grad_done = (g < S(p.tolgrad)) && (lam_out < S(1e-5));
      }
    }
    __syncthreads();
    // 3. rollouts from the reference's first belief under the trial's gains
    const S* Kg = sc.Ktr + (size_t)sh.trial * T * A * B;
    const S* kffg = sc.kfftr + (size_t)sh.trial * T * A;
    if (tid < nA) rollout<Env>(p, sc, sh, tid, T, Kg, kffg, sc.mu, sc.sig, ops);
    __syncthreads();
    // 4. accept or reject: the first acceptable α (a candidate a lane, the
    // smallest j by ballot), then lane 0 decides
    if (tid < 32) {
      int idx = -1;
      for (int j0 = 0; j0 < nA && idx < 0; j0 += 32) {
        const int j = j0 + lane;
        bool ok = false;
        if (j < nA) {
          const S al = S(p.alphas[j]);
          const S expected = (S(-1) * al) * (sh.dS0 + al * sh.dS1);
          const S imp = (sh.last_return - sh.ret[j]) / expected;
          ok = imp > S(p.min_imp) && !sh.div && finite_(sh.ret[j]);
        }
        const unsigned hit = __ballot_sync(0xffffffffu, ok);
        if (hit) idx = j0 + __ffs(hit) - 1;
      }
      if (lane == 0) {
        const bool any_ok = idx >= 0;
        if (!any_ok) idx = 0;
        const S ret_idx = sh.ret[idx];
        const S dret_idx = sh.last_return - ret_idx;
        const S mult = S(p.mult_lmbda);
        const S dl_acc = min_(sh.dl_out / mult, S(1) / mult);
        const S lam_acc = sh.lam_out * dl_acc * (sh.lam_out > S(p.min_lmbda) ? S(1) : S(0));
        const S dl_rej = max_(sh.dl_out * mult, mult);
        const S lam_rej = max_(sh.lam_out * dl_rej, S(p.min_lmbda));
        const bool take = any_ok && !sh.grad_done;
        sh.take = take;
        sh.alpha = idx;
        sh.lam = take ? lam_acc : lam_rej;
        sh.dlam = take ? dl_acc : dl_rej;
        if (take) sh.last_return = ret_idx;
        sh.done = sh.grad_done || (take && dret_idx < S(p.tolfun)) ||
                  (!any_ok && lam_rej > S(p.max_lmbda));
        if (trace != nullptr) trace[it] = sh.last_return;
      }
    }
    __syncthreads();
    if (sh.take) {
      take_rollout(sc, sh.alpha, T);
      for (int i = tid; i < T * A * B; i += blockDim.x) sc.K[i] = Kg[i];
      for (int i = tid; i < T * A; i += blockDim.x) sc.kff[i] = kffg[i];
    }
    __syncthreads();
  }
}

}  // namespace

template <class Env, typename S>
__global__ void __launch_bounds__(THREADS) bsp_solve_kernel(
    BSPParams p, const S* __restrict__ mu0, const S* __restrict__ sig0, S* __restrict__ mu_out,
    S* __restrict__ sig_out, S* __restrict__ u_out, S* __restrict__ K_out,
    S* __restrict__ kff_out, S* __restrict__ misc, S* __restrict__ trace, S* scratch,
    int in_smem) {
  constexpr int B = Env::B, A = Env::A, BB = B * B;
  extern __shared__ __align__(16) unsigned char bsp_smem[];
  __shared__ Shared<S> sh;
  const Scratch<Env, S> sc(in_smem ? reinterpret_cast<S*>(bsp_smem) : scratch, p.T, p.nA);
  solve_core(p, sc, sh, mu0, sig0, trace);
  const int tid = threadIdx.x, T = p.T;
  for (int i = tid; i < (T + 1) * B; i += blockDim.x) mu_out[i] = sc.mu[i];
  for (int i = tid; i < (T + 1) * BB; i += blockDim.x) sig_out[i] = sc.sig[i];
  for (int i = tid; i < T * A; i += blockDim.x) {
    u_out[i] = sc.u[i];
    kff_out[i] = sc.kff[i];
  }
  for (int i = tid; i < T * A * B; i += blockDim.x) K_out[i] = sc.K[i];
  if (tid == 0) {
    misc[0] = sh.lam;
    misc[1] = sh.dlam;
    misc[2] = sh.last_return;
    misc[3] = sh.done ? S(1) : S(0);
  }
}

template <class Env, typename S>
__global__ void __launch_bounds__(THREADS) bsp_episode_kernel(
    BSPParams p, const S* __restrict__ x0, const S* __restrict__ eps0,
    const S* __restrict__ eps_dyn, const S* __restrict__ eps_obs, S* __restrict__ xs,
    S* __restrict__ mus, S* __restrict__ sigmas, S* __restrict__ us, S* __restrict__ cs,
    S* scratch, int steps, int in_smem) {
  constexpr int B = Env::B, A = Env::A, BB = B * B, DO = Env::DO;
  extern __shared__ __align__(16) unsigned char bsp_smem[];
  __shared__ Shared<S> sh;
  __shared__ S x[B], mu_b[B], cov_b[BB];
  const Scratch<Env, S> sc(in_smem ? reinterpret_cast<S*>(bsp_smem) : scratch, p.T, p.nA);
  const int tid = threadIdx.x;

  if (tid == 0) {
    // the first observation and its EKF update of the initial belief
    S xv[B], y[DO], H[DO][B], Rn[DO][DO], z[DO], m[B], c[B][B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      xv[i] = x0[i];
      x[i] = x0[i];
      m[i] = S(p.mu_init[i]);
#pragma unroll
      for (int j = 0; j < B; ++j) c[i][j] = S(p.sig_init[i * B + j]);
    }
    observe_jac<Env>(xv, y, H);
    Env::obs_noise(p, xv, Rn);
    noisy(y, Rn, eps0, z);
    ekf_innovate<Env>(p, m, c, z);
#pragma unroll
    for (int i = 0; i < B; ++i) {
      mu_b[i] = m[i];
#pragma unroll
      for (int j = 0; j < B; ++j) cov_b[i * B + j] = c[i][j];
    }
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    solve_core(p, sc, sh, mu_b, cov_b, (S*)nullptr);
    if (tid == 0) {
      S u[A], xv[B], m[B], c[B][B];
#pragma unroll
      for (int j = 0; j < A; ++j) u[j] = sc.u[j];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        xv[i] = x[i];
        m[i] = mu_b[i];
#pragma unroll
        for (int j = 0; j < B; ++j) c[i][j] = cov_b[i * B + j];
      }
      cs[s] = belief_cost<Env>(p, m, cov_b, u);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        xs[s * B + i] = xv[i];
        mus[s * B + i] = m[i];
#pragma unroll
        for (int j = 0; j < B; ++j) sigmas[s * BB + i * B + j] = c[i][j];
      }
#pragma unroll
      for (int j = 0; j < A; ++j) us[s * A + j] = u[j];

      // the true noisy step and its observation
      S mean[B], J[B][B], Sd[B][B], xn[B], y[DO], H[DO][B], Rn[DO][DO], z[DO];
      dynamics_jac<Env>(p, xv, u, mean, J);
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) Sd[i][j] = i == j ? S(p.dyn_sigma) : S(0);
      noisy(mean, Sd, eps_dyn + s * B, xn);
      observe_jac<Env>(xn, y, H);
      Env::obs_noise(p, xn, Rn);
      noisy(y, Rn, eps_obs + s * DO, z);

      // EKF predict at (μ, u), then innovate against z
      S mp[B], Am[B][B], AC[B][B], cp[B][B];
      dynamics_jac<Env>(p, m, u, mp, Am);
      mm(Am, c, AC);
      mm_nt(AC, Am, cp);
#pragma unroll
      for (int i = 0; i < B; ++i) cp[i][i] = cp[i][i] + S(p.dyn_sigma);
      symmetrize(cp);
      ekf_innovate<Env>(p, mp, cp, z);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        x[i] = xn[i];
        mu_b[i] = mp[i];
#pragma unroll
        for (int j = 0; j < B; ++j) cov_b[i * B + j] = cp[i][j];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      xs[steps * B + i] = x[i];
      mus[steps * B + i] = mu_b[i];
#pragma unroll
      for (int j = 0; j < B; ++j) sigmas[steps * BB + i * B + j] = cov_b[i * B + j];
    }
  }
}

namespace {

// The scratch's bytes in dynamic shared memory, with the kernel's limit
// raised to them, or 0 (the device-memory scratch) where it does not fit.
template <class Env, typename S, typename Kernel>
int scratch_smem(Kernel kernel, const BSPParams& p, size_t& bytes) {
  bytes = Scratch<Env, S>::size(p.T, p.nA) * sizeof(S);
  if (bytes > SMEM_MAX) bytes = 0;
  if (bytes == 0) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <class Env, typename S>
int launch_solve(const BSPParams& p, const void* const* in, void* const* out, void* scratch,
                 cudaStream_t s) {
  size_t bytes;
  const int err = scratch_smem<Env, S>(bsp_solve_kernel<Env, S>, p, bytes);
  if (err) return err;
  bsp_solve_kernel<Env, S><<<1, THREADS, bytes, s>>>(
      p, (const S*)in[0], (const S*)in[1], (S*)out[0], (S*)out[1], (S*)out[2], (S*)out[3],
      (S*)out[4], (S*)out[5], (S*)out[6], (S*)scratch, bytes > 0);
  return (int)cudaGetLastError();
}

template <class Env, typename S>
int launch_episode(const BSPParams& p, const void* const* in, void* const* out, void* scratch,
                   int steps, cudaStream_t s) {
  size_t bytes;
  const int err = scratch_smem<Env, S>(bsp_episode_kernel<Env, S>, p, bytes);
  if (err) return err;
  bsp_episode_kernel<Env, S><<<1, THREADS, bytes, s>>>(
      p, (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (S*)out[0],
      (S*)out[1], (S*)out[2], (S*)out[3], (S*)out[4], (S*)scratch, steps, bytes > 0);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points.  dtype: 0 float32, 1 float64.  Each returns the CUDA error
// of its launch, or -1 when no kernel is instantiated (LightDark only:
// (b, a) = (2, 2)) or the shapes are out of range.
extern "C" int trajopt_bsp_solve(int dtype, BSPParams p, const void* mu0, const void* sig0,
                                 void* mu_out, void* sig_out, void* u_out, void* K_out,
                                 void* kff_out, void* misc, void* trace, void* scratch,
                                 void* stream) {
  if (p.T + 1 > THREADS || p.nA > THREADS || p.nA < 1 || p.T < 1) return -1;
  const void* in[2] = {mu0, sig0};
  void* out[7] = {mu_out, sig_out, u_out, K_out, kff_out, misc, trace};
  if (dtype == 0) return launch_solve<LightDark, float>(p, in, out, scratch, (cudaStream_t)stream);
  if (dtype == 1) return launch_solve<LightDark, double>(p, in, out, scratch, (cudaStream_t)stream);
  return -1;
}

extern "C" int trajopt_bsp_episode(int dtype, BSPParams p, const void* x0, const void* eps0,
                                   const void* eps_dyn, const void* eps_obs, void* xs,
                                   void* mus, void* sigmas, void* us, void* cs, void* scratch,
                                   int steps, void* stream) {
  if (p.T + 1 > THREADS || p.nA > THREADS || p.nA < 1 || p.T < 1 || steps < 1) return -1;
  const void* in[4] = {x0, eps0, eps_dyn, eps_obs};
  void* out[5] = {xs, mus, sigmas, us, cs};
  if (dtype == 0)
    return launch_episode<LightDark, float>(p, in, out, scratch, steps, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_episode<LightDark, double>(p, in, out, scratch, steps, (cudaStream_t)stream);
  return -1;
}
