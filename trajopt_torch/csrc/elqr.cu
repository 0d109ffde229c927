// K11–K14: extended LQR (eLQR) sweeps and the whole eLQR solve.
//
// Replaces trajopt_tpu/core/pallas_elqr.py:
//   K11 _forward_kernel  (wrapper elqr_forward_pallas):  cost-to-come sweep;
//   K12 _backward_kernel (wrapper elqr_backward_pallas): terminal step, then
//       the cost-to-go sweep in reverse time;
//   K13 _rollout_kernel  (wrapper elqr_rollout_pallas):  evaluation rollout;
//   K14 _solve_kernel    (wrapper elqr_solve_fused_pallas): the whole solve,
//       nb_iter × (K11's sweep, terminal step, K12's sweep, K13's rollout)
//       and the final stored rollout, in one launch.
// Each step follows the TPU kernels' shared _forward_step, _backward_step,
// _terminal_step and _stage_cost_tiles (pallas_elqr.py:168-271), so the
// streamed and the fused engines compute the same steps in the same order.
//
// What bounds it on the H100: the dependent chain, not bytes or operations.
// At Cartpole's dims (dx=4, du=1) a sweep step reads about 25 and writes
// about 26 values per instance (K11 at T=100, N=1024, float32: about 21 MB,
// 6 µs at 3.35 TB/s) and does about 2,500 operations (a dual-number RK4 over
// five tangents, the feature Jacobian, the value algebra, two Gauss–Jordan
// inverses: 4 µs at 67 TFLOP/s).  Each instance is T dependent steps, each a
// chain of thousands of dependent instructions, so the time is T times one
// step's latency, as for K1.  Of a float step, the two RK4s were the most
// (PERF.md): chains of library divisions and sines, and the
// trajectories settle on the goal, where the ODE's numerators are rounding
// residue down to subnormals and every such division takes the library's
// slow path (about 500 cycles against 45).  The sweeps' steps took twice as
// long from the fourth iteration on as at the first.
//
// Design.  Streams are structure of arrays with time leading, (T(+1),
// entries, N), coalesced across instances; the come and go values keep
// their boundary rows in place (comeV₀ = 1e-16·I at row 0, the terminal go
// values at row T).  The value carry stays in registers.  A, B and c of the
// inverse RK4 (K11) and the forward RK4 (K12) are the tangents of a
// dual-number evaluation (dual.cuh), which carries jnp.clip's ½ slope at a
// bound.  The cost quadratization is closed form for the base feature-goal
// cost at u_last = 0, a = 1 (pallas_elqr.py:99-143): Cxx = JᵀGJ, cx =
// 2JᵀG(z₀−g) − 2Cxx·x, Cuu = diag(uw), Cxu = cu = 0, J from a dual
// evaluation of the features.  Inverses are partial-pivoting Gauss–Jordan
// (gj_inv.cuh); comeV and goV are symmetrized as in the TPU kernels.  The
// solve keeps its (T+1)-row working streams in a device scratch that the
// wrapper allocates.  Every small sum runs in the order of the TPU kernel
// (index 0 first) and the build uses -fmad=false, so the float64 build
// agrees with the plain versions (core/cuda_elqr.py) to rounding.
//
// The float builds of the sweeps (K11, K12) and of the solve (K14) share one
// step, and the evaluation rollout (K13) its RK4: the ODE divides with
// PivotOps::div_moderate (pivot.cuh: a / b's bits for every float numerator
// over the ODE's divisors, without a branch) and takes ChainOps' sines (a
// step whose angle passes 105615 is taken again with the library's
// operations); in the sweeps and the solve the linearization's five tangents
// go over the lanes: a group of eight lanes per instance, four instances a
// warp, one warp a block (K11/K12 at N=1024: 256 warps on the 132 SMs),
// lane k evaluating the value and tangent k alone (the same operations as
// tangent k of the five-tangent dual), the Jacobian's columns gathered by
// shuffles.  Everything else runs on every lane of the group alike, which
// writes the same values to the same places; lanes past the last instance
// repeat it.  The outputs are bit for bit those of the one-thread,
// library-operation kernels (PERF.md).  The float64 build keeps one thread
// an instance and the library's operations.  K13 keeps one thread an
// instance (its chain has no tangents to spread); its float RK4 is the
// sweeps', and each step's gains are loaded a step ahead, so neither the
// library division's slow path on the residue numerators nor the gains'
// trip to memory sits on its chain.
#include <cuda_runtime.h>

#include <type_traits>

#include "bwd_step.cuh"
#include "envs.cuh"
#include "gj_inv.cuh"

constexpr int ELQR_THREADS = 32;
// The float builds of K11, K12 and K14: the lanes of a group share one
// instance, lane k carrying the linearization's tangent k (k ≥ dx + du: a
// zero tangent).
constexpr int ELQR_GROUP = 8;

// The lanes given to one instance of K11, K12 and K14.
template <typename S>
__host__ __device__ constexpr int group_lanes() {
  return std::is_same<S, float>::value ? ELQR_GROUP : 1;
}

// The instance of this thread in a kernel that gives each instance a group
// of group_lanes<S>() lanes: in float the lanes past the last instance repeat
// it (every lane joins the shuffles), and the lanes of a group write the same
// values to the same places; with one lane an instance, −1 past the last.
template <typename S>
__device__ __forceinline__ int group_instance(int N) {
  constexpr int G = group_lanes<S>();
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (n < N) return n;
  return G == 1 ? -1 : N - 1;
}

// Element (t, e) of a (rows, E, N) stream for instance n.
#define AT(ptr, t, E, e) (ptr)[((size_t)(t) * (E) + (e)) * np + n]

// One RK4 step of the ODE (Backward: the inverse dynamics) on plain or dual
// scalars.  Fast (every float step: the sweeps, the rollouts of K13 and
// K14): ExactChainOps (envs.cuh), the step taken again with the library's
// operations where a sine's argument left ChainOps' range, so the bits are
// the library's either way; otherwise (float64) the library's operations.
template <class Env, bool Backward, bool Fast, typename T>
__device__ __forceinline__ void rk4(const EnvParams& p, const T (&x)[Env::DX],
                                    const T (&u)[Env::DU], T (&xn)[Env::DX]) {
  if constexpr (Fast && std::is_same<typename RealOf<T>::type, float>::value) {
    ExactChainOps fast;
    rk4_step<Env, Backward>(p, x, u, xn, fast);
    if (!fast.wide) return;
  }
  LibOps lib;
  rk4_step<Env, Backward>(p, x, u, xn, lib);
}

// The affine model f(ξ, ν) ≈ Aξ + Bν + c about (x, u) of the dynamics
// (Inverse false) or the inverse dynamics (Inverse true):
// c = (f(x, u) − Ax) − Bu (pallas_elqr.py _tile_lin).
// In float (K11, K12, K14) the tangents go over the lanes of the instance's
// group: lane k evaluates the value and tangent k alone (Dual<S, 1>, the
// same operations as tangent k of the five-tangent dual, value likewise), and
// the columns come back by shuffles; every lane of the warp takes part.
template <class Env, bool Inverse, typename S>
__device__ __forceinline__ void lin_about(const EnvParams& p, const S (&x)[Env::DX],
                                          const S (&u)[Env::DU], S (&A)[Env::DX][Env::DX],
                                          S (&B)[Env::DX][Env::DU], S (&c)[Env::DX]) {
  constexpr int DX = Env::DX, DU = Env::DU, NT = DX + DU;
  S f[DX];
  if constexpr (group_lanes<S>() > 1) {
    static_assert(NT <= ELQR_GROUP, "one lane per tangent");
    using D = Dual<S, 1>;
    const int k = threadIdx.x % ELQR_GROUP, base = threadIdx.x - k;
    D xd[DX], ud[DU], fd[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) { xd[i] = D(x[i]); xd[i].d[0] = k == i ? S(1) : S(0); }
#pragma unroll
    for (int j = 0; j < DU; ++j) { ud[j] = D(u[j]); ud[j].d[0] = k == DX + j ? S(1) : S(0); }
    rk4<Env, Inverse, true>(p, xd, ud, fd);
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      f[i] = fd[i].v;
#pragma unroll
      for (int kk = 0; kk < DX; ++kk) A[i][kk] = __shfl_sync(0xffffffffu, fd[i].d[0], base + kk);
#pragma unroll
      for (int j = 0; j < DU; ++j) B[i][j] = __shfl_sync(0xffffffffu, fd[i].d[0], base + DX + j);
    }
  } else {
    using D = Dual<S, NT>;
    D xd[DX], ud[DU], fd[DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) { xd[i] = D(x[i]); xd[i].d[i] = S(1); }
#pragma unroll
    for (int j = 0; j < DU; ++j) { ud[j] = D(u[j]); ud[j].d[DX + j] = S(1); }
    rk4<Env, Inverse, false>(p, xd, ud, fd);
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      f[i] = fd[i].v;
#pragma unroll
      for (int kk = 0; kk < DX; ++kk) A[i][kk] = fd[i].d[kk];
#pragma unroll
      for (int j = 0; j < DU; ++j) B[i][j] = fd[i].d[DX + j];
    }
  }
#pragma unroll
  for (int i = 0; i < DX; ++i) {
    S ax = A[i][0] * x[0];
#pragma unroll
    for (int k = 1; k < DX; ++k) ax = ax + A[i][k] * x[k];
    S bu = B[i][0] * u[0];
#pragma unroll
    for (int j = 1; j < DU; ++j) bu = bu + B[i][j] * u[j];
    c[i] = (f[i] - ax) - bu;
  }
}

// The closed-form eLQR quadratization at (x, u): the state blocks Cxx, cx and
// the constant c0 that closes cost = xᵀCxx x + uᵀdiag(uw)u + cxᵀx + c0.
template <class Env, typename S>
__device__ __forceinline__ void quad_cost(const EnvParams& p, const S (&x)[Env::DX],
                                          const S (&u)[Env::DU], S (&Cxx)[Env::DX][Env::DX],
                                          S (&cx)[Env::DX], S& c0) {
  constexpr int DX = Env::DX, DU = Env::DU, NZ = Env::NZ;
  using D = Dual<S, DX>;
  S y[DX];
  Env::periodic(p, x, y);
  D yd[DX], zd[NZ];
#pragma unroll
  for (int i = 0; i < DX; ++i) { yd[i] = D(y[i]); yd[i].d[i] = S(1); }
  Env::features(yd, zd);
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      S s = S(p.gw[0]) * zd[0].d[i] * zd[0].d[j];
#pragma unroll
      for (int k = 1; k < NZ; ++k) s = s + S(p.gw[k]) * zd[k].d[i] * zd[k].d[j];
      Cxx[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < DX; ++i) {
    S g = S(p.gw[0]) * (zd[0].v - S(p.g[0])) * zd[0].d[i];
#pragma unroll
    for (int k = 1; k < NZ; ++k) g = g + S(p.gw[k]) * (zd[k].v - S(p.g[k])) * zd[k].d[i];
    S cxx = Cxx[i][0] * x[0];
#pragma unroll
    for (int j = 1; j < DX; ++j) cxx = cxx + Cxx[i][j] * x[j];
    cx[i] = S(2.0) * g - S(2.0) * cxx;
  }
  S uu = S(p.uw[0]) * u[0] * u[0];
#pragma unroll
  for (int j = 1; j < DU; ++j) uu = uu + S(p.uw[j]) * u[j] * u[j];
  S goal;
#pragma unroll
  for (int k = 0; k < NZ; ++k) {
    const S d = zd[k].v - S(p.g[k]);
    const S term = S(p.gw[k]) * (d * d);
    goal = k == 0 ? term : goal + term;
  }
  S xcx = x[0] * Cxx[0][0] * x[0];
#pragma unroll
  for (int i = 0; i < DX; ++i)
#pragma unroll
    for (int j = 0; j < DX; ++j)
      if (i + j > 0) xcx = xcx + x[i] * Cxx[i][j] * x[j];
  S cxx_ = cx[0] * x[0];
#pragma unroll
  for (int i = 1; i < DX; ++i) cxx_ = cxx_ + cx[i] * x[i];
  c0 = (((uu + goal) - xcx) - uu) - cxx_;
}

// x_new = −(goV + comeV)⁻¹ (gov + comev): the state re-chosen as the
// minimizer of the summed quadratics.
template <typename S, int DX>
__device__ __forceinline__ void rechoose(const S (&Va)[DX][DX], const S (&Vb)[DX][DX],
                                         const S (&va)[DX], const S (&vb)[DX], S (&x)[DX]) {
  S Sm[DX][DX], Si[DX][DX], r[DX], y[DX];
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) Sm[a][b] = Va[a][b] + Vb[a][b];
    r[a] = va[a] + vb[a];
  }
  gj_inv(Sm, Si);
  mv(Si, r, y);
#pragma unroll
  for (int a = 0; a < DX; ++a) x[a] = -y[a];
}

// The value update shared by both sweeps: gains from (Quu, Qux, qu), then
// V = sym(Qxx + Quxᵀ K), v = qx + Quxᵀ kff, v0 = q0 + ½ quᵀ kff.
template <typename S, int DX, int DU>
__device__ __forceinline__ void gains_and_value(const S (&Qxx)[DX][DX], const S (&Quu)[DU][DU],
                                                const S (&Qux)[DU][DX], const S (&qx)[DX],
                                                const S (&qu)[DU], S q0, S (&K)[DU][DX],
                                                S (&kff)[DU], S (&V)[DX][DX], S (&v)[DX],
                                                S& v0) {
  S Qiu[DU][DU];
  {
    S Q[DU][DU];
#pragma unroll
    for (int a = 0; a < DU; ++a)
#pragma unroll
      for (int b = 0; b < DU; ++b) Q[a][b] = Quu[a][b];
    gj_inv(Q, Qiu);
  }
  S t[DU][DX], tq[DU];
  mm(Qiu, Qux, t);
  mv(Qiu, qu, tq);
#pragma unroll
  for (int a = 0; a < DU; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) K[a][b] = -t[a][b];
    kff[a] = -tq[a];
  }
  S X[DX][DX], R[DX][DX], w[DX];
  mm_tn(Qux, K, X);
#pragma unroll
  for (int a = 0; a < DX; ++a)
#pragma unroll
    for (int b = 0; b < DX; ++b) R[a][b] = Qxx[a][b] + X[a][b];
  sym(R, V);
  mv_tn(Qux, kff, w);
#pragma unroll
  for (int a = 0; a < DX; ++a) v[a] = qx[a] + w[a];
  v0 = q0 + S(0.5) * dot(qu, kff);
}

// One cost-to-come step (pallas_elqr.py _forward_step).  In: the controller
// row (K, kff), the go values one step later (goVn, govn); carry: the state
// x and the come value (V, v, v0) at t, replaced by those at t+1.  Out: the
// inverse controller (iK, ikff).
template <class Env, typename S>
__device__ __forceinline__ void forward_step(
    const EnvParams& p, const S (&K)[Env::DU][Env::DX], const S (&kff)[Env::DU],
    const S (&goVn)[Env::DX][Env::DX], const S (&govn)[Env::DX], S (&x)[Env::DX],
    S (&V)[Env::DX][Env::DX], S (&v)[Env::DX], S& v0, S (&iK)[Env::DU][Env::DX],
    S (&ikff)[Env::DU]) {
  constexpr int DX = Env::DX, DU = Env::DU;
  S u[DU], xn[DX];
  {
    S Kx[DU];
    mv(K, x, Kx);
#pragma unroll
    for (int j = 0; j < DU; ++j) u[j] = kff[j] + Kx[j];
  }
  rk4<Env, false, true>(p, x, u, xn);
  S A[DX][DX], B[DX][DU], c[DX], Cxx[DX][DX], cx[DX], c0;
  lin_about<Env, true>(p, xn, u, A, B, c);
  quad_cost<Env>(p, x, u, Cxx, cx, c0);

  S M[DX][DX];
#pragma unroll
  for (int a = 0; a < DX; ++a)
#pragma unroll
    for (int b = 0; b < DX; ++b) M[a][b] = Cxx[a][b] + V[a][b];
  S Qxx[DX][DX], Quu[DU][DU], Qux[DU][DX], qx[DX], qu[DU];
  {
    S AtM[DX][DX];
    mm_tn(A, M, AtM);
    mm(AtM, A, Qxx);
  }
  {
    S BtM[DU][DX], BtMB[DU][DU];
    mm_tn(B, M, BtM);
    mm(BtM, B, BtMB);
#pragma unroll
    for (int a = 0; a < DU; ++a)
#pragma unroll
      for (int b = 0; b < DU; ++b) Quu[a][b] = BtMB[a][b] + (a == b ? S(p.uw[a]) : S(0));
    mm(BtM, A, Qux);
  }
  S q0;
  {
    S Mc[DX], vec[DX], cv[DX];
    mv(M, c, Mc);
#pragma unroll
    for (int k = 0; k < DX; ++k) {
      vec[k] = (Mc[k] + cx[k]) + v[k];
      cv[k] = cx[k] + v[k];
    }
    mv_tn(A, vec, qx);
    mv_tn(B, vec, qu);
    q0 = ((S(0.5) * dot(c, Mc) + dot(c, cv)) + c0) + v0;
  }
  gains_and_value(Qxx, Quu, Qux, qx, qu, q0, iK, ikff, V, v, v0);
  rechoose(goVn, V, govn, v, x);
}

// One cost-to-go step (pallas_elqr.py _backward_step).  In: the inverse
// controller row (iK, ikff), the come values at t (comeV, comev); carry: the
// state x and the go value (V, v, v0) at t+1, replaced by those at t.  Out:
// the controller (K, kff).
template <class Env, typename S>
__device__ __forceinline__ void backward_step(
    const EnvParams& p, const S (&iK)[Env::DU][Env::DX], const S (&ikff)[Env::DU],
    const S (&comeV)[Env::DX][Env::DX], const S (&comev)[Env::DX], S (&x)[Env::DX],
    S (&V)[Env::DX][Env::DX], S (&v)[Env::DX], S& v0, S (&K)[Env::DU][Env::DX],
    S (&kff)[Env::DU]) {
  constexpr int DX = Env::DX, DU = Env::DU;
  S u[DU], xp[DX];
  {
    S Kx[DU];
    mv(iK, x, Kx);
#pragma unroll
    for (int j = 0; j < DU; ++j) u[j] = ikff[j] + Kx[j];
  }
  rk4<Env, true, true>(p, x, u, xp);
  S A[DX][DX], B[DX][DU], c[DX], Cxx[DX][DX], cx[DX], c0;
  lin_about<Env, false>(p, xp, u, A, B, c);
  quad_cost<Env>(p, xp, u, Cxx, cx, c0);

  S Qxx[DX][DX], Quu[DU][DU], Qux[DU][DX], qx[DX], qu[DU];
  {
    S AtV[DX][DX], X[DX][DX];
    mm_tn(A, V, AtV);
    mm(AtV, A, X);
#pragma unroll
    for (int a = 0; a < DX; ++a)
#pragma unroll
      for (int b = 0; b < DX; ++b) Qxx[a][b] = Cxx[a][b] + X[a][b];
  }
  {
    S BtV[DU][DX], BtVB[DU][DU];
    mm_tn(B, V, BtV);
    mm(BtV, B, BtVB);
#pragma unroll
    for (int a = 0; a < DU; ++a)
#pragma unroll
      for (int b = 0; b < DU; ++b) Quu[a][b] = (a == b ? S(p.uw[a]) : S(0)) + BtVB[a][b];
    mm(BtV, A, Qux);
  }
  S q0;
  {
    S Vc[DX], vec[DX], Av[DX];
    mv(V, c, Vc);
#pragma unroll
    for (int k = 0; k < DX; ++k) vec[k] = Vc[k] + v[k];
    mv_tn(A, vec, Av);
#pragma unroll
    for (int a = 0; a < DX; ++a) qx[a] = cx[a] + Av[a];
    mv_tn(B, vec, qu);
    q0 = ((c0 + v0) + S(0.5) * dot(c, Vc)) + dot(c, v);
  }
  gains_and_value(Qxx, Quu, Qux, qx, qu, q0, K, kff, V, v, v0);
  rechoose(V, comeV, v, comev, x);
}

// The terminal step (pallas_elqr.py _terminal_step): the go value quadratized
// at (x, 0), and x re-chosen against the come value at T.
template <class Env, typename S>
__device__ __forceinline__ void terminal_step(const EnvParams& p,
                                              const S (&comeV)[Env::DX][Env::DX],
                                              const S (&comev)[Env::DX], S (&x)[Env::DX],
                                              S (&V)[Env::DX][Env::DX], S (&v)[Env::DX],
                                              S& v0) {
  S zero[Env::DU];
#pragma unroll
  for (int j = 0; j < Env::DU; ++j) zero[j] = S(0);
  quad_cost<Env>(p, x, zero, V, v, v0);
  rechoose(V, comeV, v, comev, x);
}

template <typename S, int R, int C>
__device__ __forceinline__ void load_mat(const S* __restrict__ s, int t, size_t np, int n,
                                         S (&M)[R][C]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) M[a][b] = AT(s, t, R * C, a * C + b);
}

template <typename S, int R, int C>
__device__ __forceinline__ void store_mat(S* __restrict__ s, int t, size_t np, int n,
                                          const S (&M)[R][C]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) AT(s, t, R * C, a * C + b) = M[a][b];
}

template <typename S, int E>
__device__ __forceinline__ void load_vec(const S* __restrict__ s, int t, size_t np, int n,
                                         S (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = AT(s, t, E, e);
}

template <typename S, int E>
__device__ __forceinline__ void store_vec(S* __restrict__ s, int t, size_t np, int n,
                                          const S (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) AT(s, t, E, e) = v[e];
}

// The forward sweep over t = 0 … T−1 from the state x: reads K, kff (rows t)
// and goV, gov (rows t+1); writes iK, ikff (rows t) and comeV, comev (rows
// 0 … T, row 0 the initial 1e-16·I and 0), comev0 when given.
template <class Env, typename S>
__device__ __forceinline__ void forward_sweep(const EnvParams& p, const S* K, const S* kff,
                                              const S* goV, const S* gov, S* iK, S* ikff,
                                              S* comeV, S* comev, S* comev0, S (&x)[Env::DX],
                                              int T, size_t np, int n) {
  constexpr int DX = Env::DX, DU = Env::DU;
  S V[DX][DX], v[DX], v0 = S(0);
#pragma unroll
  for (int a = 0; a < DX; ++a) {
#pragma unroll
    for (int b = 0; b < DX; ++b) V[a][b] = a == b ? S(1e-16) : S(0);
    v[a] = S(0);
  }
  store_mat(comeV, 0, np, n, V);
  store_vec(comev, 0, np, n, v);
  if (comev0) AT(comev0, 0, 1, 0) = v0;
  for (int t = 0; t < T; ++t) {
    S Kt[DU][DX], kt[DU], goVn[DX][DX], govn[DX], iKt[DU][DX], ikt[DU];
    load_mat(K, t, np, n, Kt);
    load_vec(kff, t, np, n, kt);
    load_mat(goV, t + 1, np, n, goVn);
    load_vec(gov, t + 1, np, n, govn);
    forward_step<Env>(p, Kt, kt, goVn, govn, x, V, v, v0, iKt, ikt);
    store_mat(iK, t, np, n, iKt);
    store_vec(ikff, t, np, n, ikt);
    store_mat(comeV, t + 1, np, n, V);
    store_vec(comev, t + 1, np, n, v);
    if (comev0) AT(comev0, t + 1, 1, 0) = v0;
  }
}

// The terminal step and the backward sweep over t = T−1 … 0 from the state x:
// reads iK, ikff (rows t) and comeV, comev (rows 0 … T); writes K, kff (rows
// t) and goV, gov (rows 0 … T, row T the terminal value), gov0 when given.
template <class Env, typename S>
__device__ __forceinline__ void backward_sweep(const EnvParams& p, const S* iK, const S* ikff,
                                               const S* comeV, const S* comev, S* K, S* kff,
                                               S* goV, S* gov, S* gov0, S (&x)[Env::DX],
                                               int T, size_t np, int n) {
  constexpr int DX = Env::DX, DU = Env::DU;
  S V[DX][DX], v[DX], v0;
  {
    S cV[DX][DX], cv[DX];
    load_mat(comeV, T, np, n, cV);
    load_vec(comev, T, np, n, cv);
    terminal_step<Env>(p, cV, cv, x, V, v, v0);
  }
  store_mat(goV, T, np, n, V);
  store_vec(gov, T, np, n, v);
  if (gov0) AT(gov0, T, 1, 0) = v0;
  for (int t = T - 1; t >= 0; --t) {
    S iKt[DU][DX], ikt[DU], cV[DX][DX], cv[DX], Kt[DU][DX], kt[DU];
    load_mat(iK, t, np, n, iKt);
    load_vec(ikff, t, np, n, ikt);
    load_mat(comeV, t, np, n, cV);
    load_vec(comev, t, np, n, cv);
    backward_step<Env>(p, iKt, ikt, cV, cv, x, V, v, v0, Kt, kt);
    store_mat(K, t, np, n, Kt);
    store_vec(kff, t, np, n, kt);
    store_mat(goV, t, np, n, V);
    store_vec(gov, t, np, n, v);
    if (gov0) AT(gov0, t, 1, 0) = v0;
  }
}

// The evaluation rollout u = kff + Kx from x0 (pallas_elqr.py
// _rollout_kernel): the stage cost on the raw action (u_last = 0, a = 1),
// the dynamics clip inside; stores the states and actions when xs is given.
// The gains do not depend on the state: step t + 1's are loaded into
// registers while step t runs, so their trip to memory is off the chain.
template <class Env, typename S>
__device__ __forceinline__ S rollout(const EnvParams& p, const S* K, const S* kff,
                                     const S (&x0)[Env::DX], S* xs, S* us, int T, size_t np,
                                     int n) {
  constexpr int DX = Env::DX, DU = Env::DU;
  S x[DX], ret = S(0);
#pragma unroll
  for (int i = 0; i < DX; ++i) x[i] = x0[i];
  const S zero[DU] = {};
  S Kn[DU][DX], kn[DU];
  if (T > 0) {
    load_mat(K, 0, np, n, Kn);
    load_vec(kff, 0, np, n, kn);
  }
  for (int t = 0; t < T; ++t) {
    S Kt[DU][DX], kt[DU], Kx[DU], u[DU], xn[DX];
#pragma unroll
    for (int j = 0; j < DU; ++j) {
#pragma unroll
      for (int i = 0; i < DX; ++i) Kt[j][i] = Kn[j][i];
      kt[j] = kn[j];
    }
    const int tn = t + 1 < T ? t + 1 : t;   // the last step loads its own row again
    load_mat(K, tn, np, n, Kn);
    load_vec(kff, tn, np, n, kn);
    mv(Kt, x, Kx);
#pragma unroll
    for (int j = 0; j < DU; ++j) u[j] = kt[j] + Kx[j];
    ret = ret + stage_cost<Env>(p, x, u, zero, S(1));
    if (xs) {
      store_vec(xs, t, np, n, x);
      store_vec(us, t, np, n, u);
    }
    rk4<Env, false, true>(p, x, u, xn);
#pragma unroll
    for (int i = 0; i < DX; ++i) x[i] = xn[i];
  }
  ret = ret + stage_cost<Env>(p, x, zero, zero, S(1));
  if (xs) store_vec(xs, T, np, n, x);
  return ret;
}

template <typename S, class Env>
__global__ void __launch_bounds__(ELQR_THREADS) elqr_forward_kernel(
    EnvParams p, const S* __restrict__ K, const S* __restrict__ kff, const S* __restrict__ goV,
    const S* __restrict__ gov, const S* __restrict__ x0, S* __restrict__ iK,
    S* __restrict__ ikff, S* __restrict__ comeV, S* __restrict__ comev, S* __restrict__ comev0,
    S* __restrict__ xout, int T, int N) {
  const int n = group_instance<S>(N);
  if (n < 0) return;
  const size_t np = N;
  S x[Env::DX];
  load_vec(x0, 0, np, n, x);
  forward_sweep<Env>(p, K, kff, goV, gov, iK, ikff, comeV, comev, comev0, x, T, np, n);
  store_vec(xout, 0, np, n, x);
}

template <typename S, class Env>
__global__ void __launch_bounds__(ELQR_THREADS) elqr_backward_kernel(
    EnvParams p, const S* __restrict__ iK, const S* __restrict__ ikff,
    const S* __restrict__ comeV, const S* __restrict__ comev, const S* __restrict__ xin,
    S* __restrict__ K, S* __restrict__ kff, S* __restrict__ goV, S* __restrict__ gov,
    S* __restrict__ gov0, S* __restrict__ xout, int T, int N) {
  const int n = group_instance<S>(N);
  if (n < 0) return;
  const size_t np = N;
  S x[Env::DX];
  load_vec(xin, 0, np, n, x);
  backward_sweep<Env>(p, iK, ikff, comeV, comev, K, kff, goV, gov, gov0, x, T, np, n);
  store_vec(xout, 0, np, n, x);
}

template <typename S, class Env>
__global__ void __launch_bounds__(ELQR_THREADS) elqr_rollout_kernel(
    EnvParams p, const S* __restrict__ K, const S* __restrict__ kff, const S* __restrict__ x0,
    S* __restrict__ ret, S* __restrict__ xs, S* __restrict__ us, int T, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t np = N;
  S x[Env::DX];
  load_vec(x0, 0, np, n, x);
  ret[n] = rollout<Env>(p, K, kff, x, xs, us, T, np, n);
}

// The whole solve (pallas_elqr.py _solve_kernel): K = 0 and kff = kff0, the
// go values 0; the initial rollout's return, then per iteration the forward
// sweep from the current state, the terminal step and the backward sweep,
// and the rollout's return; last the stored rollout.  K and kff are worked
// on in their output streams; scratch holds iK, ikff (T rows), comeV, comev,
// goV, gov (T+1 rows), each (rows, entries, N).
template <typename S, class Env>
__global__ void __launch_bounds__(ELQR_THREADS) elqr_solve_kernel(
    EnvParams p, const S* __restrict__ kff0, const S* __restrict__ x0, S* __restrict__ K,
    S* __restrict__ kff, S* __restrict__ xs, S* __restrict__ us, S* __restrict__ rets,
    S* __restrict__ scratch, int T, int N, int nb_iter) {
  constexpr int DX = Env::DX, DU = Env::DU;
  const int n = group_instance<S>(N);
  if (n < 0) return;
  const size_t np = N;
  S* iK = scratch;
  S* ikff = iK + (size_t)T * DU * DX * np;
  S* comeV = ikff + (size_t)T * DU * np;
  S* comev = comeV + (size_t)(T + 1) * DX * DX * np;
  S* goV = comev + (size_t)(T + 1) * DX * np;
  S* gov = goV + (size_t)(T + 1) * DX * DX * np;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int e = 0; e < DU * DX; ++e) AT(K, t, DU * DX, e) = S(0);
#pragma unroll
    for (int e = 0; e < DU; ++e) AT(kff, t, DU, e) = AT(kff0, t, DU, e);
  }
  for (int t = 0; t <= T; ++t) {
#pragma unroll
    for (int e = 0; e < DX * DX; ++e) AT(goV, t, DX * DX, e) = S(0);
#pragma unroll
    for (int e = 0; e < DX; ++e) AT(gov, t, DX, e) = S(0);
  }
  S xinit[DX], x[DX];
  load_vec(x0, 0, np, n, xinit);
  AT(rets, 0, 1, 0) = rollout<Env>(p, K, kff, xinit, (S*)nullptr, (S*)nullptr, T, np, n);
#pragma unroll
  for (int i = 0; i < DX; ++i) x[i] = xinit[i];
  for (int it = 0; it < nb_iter; ++it) {
    forward_sweep<Env>(p, K, kff, goV, gov, iK, ikff, comeV, comev, (S*)nullptr, x, T, np, n);
    backward_sweep<Env>(p, iK, ikff, comeV, comev, K, kff, goV, gov, (S*)nullptr, x, T, np, n);
    AT(rets, it + 1, 1, 0) =
        rollout<Env>(p, K, kff, xinit, (S*)nullptr, (S*)nullptr, T, np, n);
  }
  rollout<Env>(p, K, kff, xinit, xs, us, T, np, n);
}

#undef AT

static int blocks_of(int N, int threads) { return (N + threads - 1) / threads; }

template <typename S, class Env>
static int launch(int which, const EnvParams& p, const void* const* a, const int* ints,
                  cudaStream_t s) {
  const int T = ints[0], N = ints[1];
  // one warp a block, 32 / G instances a warp in the sweeps and the solve, so
  // that the chains of a batch run on separate SMs
  const int threads = ELQR_THREADS, groups = blocks_of(N * group_lanes<S>(), threads);
  if (which == 0) {
    elqr_forward_kernel<S, Env><<<groups, threads, 0, s>>>(
        p, (const S*)a[0], (const S*)a[1], (const S*)a[2], (const S*)a[3], (const S*)a[4],
        (S*)a[5], (S*)a[6], (S*)a[7], (S*)a[8], (S*)a[9], (S*)a[10], T, N);
  } else if (which == 1) {
    elqr_backward_kernel<S, Env><<<groups, threads, 0, s>>>(
        p, (const S*)a[0], (const S*)a[1], (const S*)a[2], (const S*)a[3], (const S*)a[4],
        (S*)a[5], (S*)a[6], (S*)a[7], (S*)a[8], (S*)a[9], (S*)a[10], T, N);
  } else if (which == 2) {
    elqr_rollout_kernel<S, Env><<<blocks_of(N, threads), threads, 0, s>>>(
        p, (const S*)a[0], (const S*)a[1], (const S*)a[2], (S*)a[3], (S*)a[4], (S*)a[5], T, N);
  } else {
    elqr_solve_kernel<S, Env><<<groups, threads, 0, s>>>(
        p, (const S*)a[0], (const S*)a[1], (S*)a[2], (S*)a[3], (S*)a[4], (S*)a[5], (S*)a[6],
        (S*)a[7], T, N, ints[2]);
  }
  return (int)cudaGetLastError();
}

template <typename S>
static int dispatch_env(int which, int kind, const EnvParams& p, const void* const* a,
                        const int* ints, cudaStream_t s) {
  if (kind == 0) return launch<S, Cartpole>(which, p, a, ints, s);
  if (kind == 1) return launch<S, CartpoleCartesian>(which, p, a, ints, s);
  return -1;
}

static int dispatch(int which, int dtype, int kind, const EnvParams* p, const void* const* a,
                    const int* ints, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_env<float>(which, kind, *p, a, ints, s);
  if (dtype == 1) return dispatch_env<double>(which, kind, *p, a, ints, s);
  return -1;
}

// C entry points.  dtype: 0 float32, 1 float64; kind: 0 Cartpole, 1 Cartpole
// with the Cartesian cost.  Streams (rows, entries, N), x vectors (dx, N).
// Each returns the CUDA error of the launch, or -1 for an unsupported (dtype,
// kind).  comev0 and gov0 may be null; xs and us are null for a rollout that
// stores nothing.
extern "C" int trajopt_elqr_forward(int dtype, int kind, const EnvParams* p, const void* K,
                                    const void* kff, const void* goV, const void* gov,
                                    const void* x0, void* iK, void* ikff, void* comeV,
                                    void* comev, void* comev0, void* xout, int T, int N,
                                    void* stream) {
  const void* a[11] = {K, kff, goV, gov, x0, iK, ikff, comeV, comev, comev0, xout};
  const int ints[2] = {T, N};
  return dispatch(0, dtype, kind, p, a, ints, stream);
}

extern "C" int trajopt_elqr_backward(int dtype, int kind, const EnvParams* p, const void* iK,
                                     const void* ikff, const void* comeV, const void* comev,
                                     const void* xin, void* K, void* kff, void* goV, void* gov,
                                     void* gov0, void* xout, int T, int N, void* stream) {
  const void* a[11] = {iK, ikff, comeV, comev, xin, K, kff, goV, gov, gov0, xout};
  const int ints[2] = {T, N};
  return dispatch(1, dtype, kind, p, a, ints, stream);
}

extern "C" int trajopt_elqr_rollout(int dtype, int kind, const EnvParams* p, const void* K,
                                    const void* kff, const void* x0, void* ret, void* xs,
                                    void* us, int T, int N, void* stream) {
  const void* a[6] = {K, kff, x0, ret, xs, us};
  const int ints[2] = {T, N};
  return dispatch(2, dtype, kind, p, a, ints, stream);
}

extern "C" int trajopt_elqr_solve(int dtype, int kind, const EnvParams* p, const void* kff0,
                                  const void* x0, void* K, void* kff, void* xs, void* us,
                                  void* rets, void* scratch, int T, int N, int nb_iter,
                                  void* stream) {
  const void* a[8] = {kff0, x0, K, kff, xs, us, rets, scratch};
  const int ints[3] = {T, N, nb_iter};
  return dispatch(3, dtype, kind, p, a, ints, stream);
}
