// K6 and K7: the two launches of one GPS dual evaluation, batched over
// problem instances.
//
// K6 replaces trajopt_tpu/core/pallas_gps.py::_gps_backward_kernel (wrappers
// pallas_gps_backward / pallas_gps_backward_packed): the KL augmentation of
// the absolute-convention cost by the old policy (Λ_old from a guarded
// Cholesky, log det Σ_old) fused into the −1/α-scaled soft-Riccati step.  It
// writes the controller (K, kff, Σ_ctl) of every step, the t = 0 value
// (V₀, v₀, c₀) and a per-instance flag (Σ_old or −Quu not positive definite).
//
// K7 replaces pallas_gps.py::_gps_forward_kl_kernel (wrappers
// pallas_gps_forward_kl_packed / pallas_gps_forward_kl): the policy
// KL(new‖old) under the state marginal N(μ_t, Σ_t), summed over t, fused with
// the exact propagation of (μ, Σ) through x' = Ax + Bu + c, u ~ N(Kx + kff,
// Σ_ctl).  It takes the KL at (μ_t, Σ_t) before propagating them.
//
// What bounds them on the H100: each instance is a chain of T dependent
// steps of small-matrix algebra (two 2×2 Cholesky factorizations, their
// solves, a few dozen tiny products); the bytes (K6 reads 94 and writes 14
// scalars per instance-step at dx=4, du=2; K7 reads 72) are the floor only
// when enough instances run to hide each step's latency.
//
// Design: one thread per instance walks the whole horizon with its carry in
// registers (K6: V, v, v0 and the flag; K7: μ, Σ and the KL sum), replacing
// the sequential time grid and VMEM scratch of the TPU kernels.  Operands are
// structure of arrays (T, entries, N) with instances contiguous, so a warp's
// loads of one entry coalesce; K6 writes (K, kff, Σ_ctl) in exactly the
// layout K7 reads, so nothing is relaid between the two launches.  Blocks are
// one warp each to spread the warps over the SMs.  Sums run in the TPU
// kernels' order and the build uses -fmad=false, so the float64 build equals
// the plain PyTorch versions (core/cuda_gps.py) to rounding.
#include <cuda_runtime.h>

#include "bwd_step.cuh"

namespace {

constexpr double LOG_2PI = 1.8378770664093453;
constexpr double LOG_2 = 0.6931471805599453;

__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// Entry e of step t of a (T, entries, N) stream, instance n.
template <typename S, int R, int C>
__device__ __forceinline__ void load(const S* __restrict__ p, int t, int n, size_t np,
                                     S (&M)[R][C]) {
  const size_t base = (size_t)t * R * C;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) M[i][j] = p[(base + i * C + j) * np + n];
}

template <typename S, int R>
__device__ __forceinline__ void load(const S* __restrict__ p, int t, int n, size_t np,
                                     S (&x)[R]) {
  const size_t base = (size_t)t * R;
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = p[(base + i) * np + n];
}

template <typename S, int R, int C>
__device__ __forceinline__ void store(S* __restrict__ p, int t, int n, size_t np,
                                      const S (&M)[R][C]) {
  const size_t base = (size_t)t * R * C;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) p[(base + i * C + j) * np + n] = M[i][j];
}

// C = A Bᵀ for A (n, k), B (m, k).
template <typename S, int N, int K, int M>
__device__ __forceinline__ void mm_nt(const S (&A)[N][K], const S (&B)[M][K], S (&C)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      S s = A[i][0] * B[j][0];
#pragma unroll
      for (int l = 1; l < K; ++l) s = s + A[i][l] * B[j][l];
      C[i][j] = s;
    }
}

// (L Lᵀ)⁻¹ by solves against the columns of the identity.
template <typename S, int N>
__device__ __forceinline__ void chol_inv(const S (&L)[N][N], const S (&inv_d)[N],
                                         S (&X)[N][N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    S e[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = i == c ? S(1) : S(0);
    chol_solve(L, inv_d, e, x);
#pragma unroll
    for (int i = 0; i < N; ++i) X[i][c] = x[i];
  }
}

template <typename S, int N>
__device__ __forceinline__ S logdet_from_chol(const S (&L)[N][N]) {
  S s = log_(L[0][0]);
#pragma unroll
  for (int j = 1; j < N; ++j) s = s + log_(L[j][j]);
  return S(2) * s;
}

// tr(M Nm) = Σᵢⱼ Mᵢⱼ Nmⱼᵢ, i outer.
template <typename S, int R, int C>
__device__ __forceinline__ S trace_prod(const S (&M)[R][C], const S (&Nm)[C][R]) {
  S s = M[0][0] * Nm[0][0];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (i > 0 || j > 0) s = s + M[i][j] * Nm[j][i];
  return s;
}

}  // namespace

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(32) gps_backward_kernel(
    const S* __restrict__ cxx, const S* __restrict__ cx, const S* __restrict__ cuu,
    const S* __restrict__ cu, const S* __restrict__ cxu, const S* __restrict__ c0s,
    const S* __restrict__ A_s, const S* __restrict__ B_s, const S* __restrict__ c_s,
    const S* __restrict__ sigd_s, const S* __restrict__ Ko_s, const S* __restrict__ ko_s,
    const S* __restrict__ sigo_s, const S* __restrict__ alpha_s, const S* __restrict__ vT,
    const S* __restrict__ vvT, const S* __restrict__ v0T, S* __restrict__ K_out,
    S* __restrict__ kff_out, S* __restrict__ sigc_out, S* __restrict__ V0_out,
    S* __restrict__ vv0_out, S* __restrict__ c0_out, unsigned char* __restrict__ bad_out,
    int T, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t np = N;

  S V[DX][DX], v[DX], v0;
  load(vT, 0, n, np, V);
  load(vvT, 0, n, np, v);
  v0 = v0T[n];
  bool bad = false;

  for (int t = T - 1; t >= 0; --t) {
    S Cxx[DX][DX], cx_t[DX], Cuu[DU][DU], cu_t[DU], Cxu[DX][DU];
    S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX], Ko[DU][DX], ko[DU], sigo[DU][DU];
    load(cxx, t, n, np, Cxx);
    load(cx, t, n, np, cx_t);
    load(cuu, t, n, np, Cuu);
    load(cu, t, n, np, cu_t);
    load(cxu, t, n, np, Cxu);
    const S c0 = c0s[(size_t)t * np + n];
    load(A_s, t, n, np, A);
    load(B_s, t, n, np, B);
    load(c_s, t, n, np, c);
    load(sigd_s, t, n, np, sigd);
    load(Ko_s, t, n, np, Ko);
    load(ko_s, t, n, np, ko);
    load(sigo_s, t, n, np, sigo);
    const S a = alpha_s[(size_t)t * np + n];

    // ---- KL augmentation (gps/src/util.cpp:136-193) ----------------------------
    S so[DU][DU], Lo[DU][DU], inv_do[DU], lam[DU][DU];
    sym(sigo, so);
    const bool bad_o = chol(so, Lo, inv_do);
    chol_inv(Lo, inv_do, lam);
    const S logdet_sigo = logdet_from_chol(Lo);
    S lamKo[DU][DX], lamko[DU];
    mm(lam, Ko, lamKo);
    mv(lam, ko, lamko);
    const S ha = S(0.5) * a;

    S agCxx[DX][DX], agCxu[DX][DU], agcx[DX], agCuu[DU][DU], agcu[DU];
    {
      S KtLK[DX][DX], KtLk[DX];
      mm_tn(Ko, lamKo, KtLK);
      mv_tn(Ko, lamko, KtLk);
#pragma unroll
      for (int i = 0; i < DX; ++i) {
#pragma unroll
        for (int j = 0; j < DX; ++j) agCxx[i][j] = Cxx[i][j] + ha * KtLK[i][j];
#pragma unroll
        for (int j = 0; j < DU; ++j) agCxu[i][j] = Cxu[i][j] - ha * lamKo[j][i];
        agcx[i] = cx_t[i] + a * KtLk[i];
      }
#pragma unroll
      for (int i = 0; i < DU; ++i) {
#pragma unroll
        for (int j = 0; j < DU; ++j) agCuu[i][j] = Cuu[i][j] + ha * lam[i][j];
        agcu[i] = cu_t[i] - a * lamko[i];
      }
    }
    const S agc0 = c0 + ha * (S(DU * LOG_2PI) + logdet_sigo) + ha * dot(ko, lamko);

    // ---- −1/α-scaled soft-Riccati step (gps/src/util.cpp:272-374) --------------
    const S nia = S(-1) / a;
    S VA[DX][DX], VB[DX][DU], Vc[DX];
    mm(V, A, VA);
    mm(V, B, VB);
    mv(V, c, Vc);

    S Qxx[DX][DX], Quu[DU][DU], QuxT[DX][DU], qu[DU], qx[DX];
    {
      S t_xx[DX][DX], t_uu[DU][DU], t_xu[DX][DU];
      mm_tn(A, VA, t_xx);
      mm_tn(B, VB, t_uu);
      mm_tn(A, VB, t_xu);
#pragma unroll
      for (int i = 0; i < DX; ++i) {
#pragma unroll
        for (int j = 0; j < DX; ++j) Qxx[i][j] = nia * (agCxx[i][j] + t_xx[i][j]);
#pragma unroll
        for (int j = 0; j < DU; ++j) QuxT[i][j] = nia * (agCxu[i][j] + t_xu[i][j]);
      }
#pragma unroll
      for (int i = 0; i < DU; ++i)
#pragma unroll
        for (int j = 0; j < DU; ++j) Quu[i][j] = nia * (agCuu[i][j] + t_uu[i][j]);
      S BtVc[DU], Btv[DU], AtVc[DX], Atv[DX];
      mv_tn(B, Vc, BtVc);
      mv_tn(B, v, Btv);
      mv_tn(A, Vc, AtVc);
      mv_tn(A, v, Atv);
#pragma unroll
      for (int i = 0; i < DU; ++i) qu[i] = nia * (agcu[i] + S(2) * BtVc[i] + Btv[i]);
#pragma unroll
      for (int i = 0; i < DX; ++i) qx[i] = nia * (agcx[i] + S(2) * AtVc[i] + Atv[i]);
    }
    const S q0 = nia * (agc0 + v0 + dot(c, Vc) + trace_prod(V, sigd) + dot(v, c));

    S negQuu[DU][DU], nq[DU][DU], Ln[DU][DU], inv_dn[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) negQuu[i][j] = -Quu[i][j];
    sym(negQuu, nq);
    const bool bad_n = chol(nq, Ln, inv_dn);
    bad = bad || bad_o || bad_n;

    // K = (−Quu)⁻¹ Qux column by column of Quxᵀ; kff = ½(−Quu)⁻¹qu; Σ_ctl = ½(−Quu)⁻¹.
    S K[DU][DX], kff[DU], sigc[DU][DU];
#pragma unroll
    for (int col = 0; col < DX; ++col) {
      S b[DU], x[DU];
#pragma unroll
      for (int i = 0; i < DU; ++i) b[i] = QuxT[col][i];
      chol_solve(Ln, inv_dn, b, x);
#pragma unroll
      for (int i = 0; i < DU; ++i) K[i][col] = x[i];
    }
    {
      S x[DU];
      chol_solve(Ln, inv_dn, qu, x);
#pragma unroll
      for (int i = 0; i < DU; ++i) kff[i] = S(0.5) * x[i];
      S inv[DU][DU];
      chol_inv(Ln, inv_dn, inv);
#pragma unroll
      for (int i = 0; i < DU; ++i)
#pragma unroll
        for (int j = 0; j < DU; ++j) sigc[i][j] = S(0.5) * inv[i][j];
    }

    const S na = -a;
    {
      S QuxTK[DX][DX], Vn[DX][DX];
      mm(QuxT, K, QuxTK);
#pragma unroll
      for (int i = 0; i < DX; ++i)
#pragma unroll
        for (int j = 0; j < DX; ++j) Vn[i][j] = na * (Qxx[i][j] + QuxTK[i][j]);
      sym(Vn, V);
    }
    {
      S Quxkff[DX];
      mv(QuxT, kff, Quxkff);
#pragma unroll
      for (int i = 0; i < DX; ++i) v[i] = na * (qx[i] + S(2) * Quxkff[i]);
    }
    const S logdet_m2Quu = S(DU * LOG_2) + logdet_from_chol(Ln);
    v0 = na * (S(0.5) * dot(qu, kff) + q0 + S(0.5) * (S(DU * LOG_2PI) - logdet_m2Quu));

    store(K_out, t, n, np, K);
#pragma unroll
    for (int i = 0; i < DU; ++i) kff_out[((size_t)t * DU + i) * np + n] = kff[i];
    store(sigc_out, t, n, np, sigc);
  }
  store(V0_out, 0, n, np, V);
#pragma unroll
  for (int i = 0; i < DX; ++i) vv0_out[i * np + n] = v[i];
  c0_out[n] = v0;
  bad_out[n] = bad ? 1 : 0;
}

template <typename S, int DX, int DU>
__global__ void __launch_bounds__(32) gps_forward_kl_kernel(
    const S* __restrict__ A_s, const S* __restrict__ B_s, const S* __restrict__ c_s,
    const S* __restrict__ sigd_s, const S* __restrict__ K_s, const S* __restrict__ kff_s,
    const S* __restrict__ sigc_s, const S* __restrict__ Ko_s, const S* __restrict__ ko_s,
    const S* __restrict__ sigo_s, const S* __restrict__ mu0, const S* __restrict__ sig0,
    S* __restrict__ kl_out, S* __restrict__ muT_out, S* __restrict__ sigT_out, int T, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t np = N;

  S mu[DX], Sx[DX][DX];
  load(mu0, 0, n, np, mu);
  load(sig0, 0, n, np, Sx);
  S kl = S(0);

  for (int t = 0; t < T; ++t) {
    S A[DX][DX], B[DX][DU], c[DX], sigd[DX][DX];
    S K[DU][DX], kff[DU], sigc[DU][DU], Ko[DU][DX], ko[DU], sigo[DU][DU];
    load(A_s, t, n, np, A);
    load(B_s, t, n, np, B);
    load(c_s, t, n, np, c);
    load(sigd_s, t, n, np, sigd);
    load(K_s, t, n, np, K);
    load(kff_s, t, n, np, kff);
    load(sigc_s, t, n, np, sigc);
    load(Ko_s, t, n, np, Ko);
    load(ko_s, t, n, np, ko);
    load(sigo_s, t, n, np, sigo);

    // ---- per-step KL(new‖old) under N(μ, Σ) (gps/src/util.cpp:83-121) ---------
    S so[DU][DU], Lo[DU][DU], inv_do[DU], lam[DU][DU], sc[DU][DU], Lc[DU][DU], inv_dc[DU];
    sym(sigo, so);
    chol(so, Lo, inv_do);
    chol_inv(Lo, inv_do, lam);
    sym(sigc, sc);
    chol(sc, Lc, inv_dc);
    S dK[DU][DX], dk[DU];
#pragma unroll
    for (int i = 0; i < DU; ++i) {
#pragma unroll
      for (int j = 0; j < DX; ++j) dK[i][j] = Ko[i][j] - K[i][j];
      dk[i] = kff[i] - ko[i];
    }
    S lam_dK[DU][DX], diff_K[DX][DX], lam_dk[DU], diff_crs[DX], dKmu[DX];
    mm(lam, dK, lam_dK);
    mm_tn(dK, lam_dK, diff_K);
    mv(lam, dk, lam_dk);
    mv_tn(dK, lam_dk, diff_crs);
    mv(diff_K, mu, dKmu);
    const S kl_t = S(0.5) * (logdet_from_chol(Lo) - logdet_from_chol(Lc)) +
                   S(0.5) * trace_prod(lam, sigc) - S(0.5 * DU) +
                   S(0.5) * trace_prod(diff_K, Sx) + S(0.5) * dot(mu, dKmu) -
                   dot(mu, diff_crs) + S(0.5) * dot(dk, lam_dk);
    kl = kl + kl_t;

    // ---- exact Gaussian propagation (gps/src/util.cpp:195-269) -----------------
    S mu_u[DU], KS[DU][DX], KSKt[DU][DU], sigma_u[DU][DU];
    mv(K, mu, mu_u);
#pragma unroll
    for (int i = 0; i < DU; ++i) mu_u[i] = mu_u[i] + kff[i];
    mm(K, Sx, KS);
    mm_nt(KS, K, KSKt);
#pragma unroll
    for (int i = 0; i < DU; ++i)
#pragma unroll
      for (int j = 0; j < DU; ++j) sigma_u[i][j] = sigc[i][j] + KSKt[i][j];

    S Amu[DX], Bmu[DX];
    mv(A, mu, Amu);
    mv(B, mu_u, Bmu);
    S AS[DX][DX], ASAt[DX][DX], Acr[DX][DU], AcrBt[DX][DX], BSu[DX][DU], BSuBt[DX][DX];
    mm(A, Sx, AS);
    mm_nt(AS, A, ASAt);
    mm_nt(A, KS, Acr);  // A (Σ Kᵀ) = A (K Σ)ᵀ
    mm_nt(Acr, B, AcrBt);
    mm(B, sigma_u, BSu);
    mm_nt(BSu, B, BSuBt);
    S Sn[DX][DX];
#pragma unroll
    for (int i = 0; i < DX; ++i) {
      mu[i] = Amu[i] + Bmu[i] + c[i];
#pragma unroll
      for (int j = 0; j < DX; ++j)
        Sn[i][j] = sigd[i][j] + ASAt[i][j] + AcrBt[i][j] + AcrBt[j][i] + BSuBt[i][j];
    }
    sym(Sn, Sx);
  }
  kl_out[n] = kl;
#pragma unroll
  for (int i = 0; i < DX; ++i) muT_out[i * np + n] = mu[i];
  store(sigT_out, 0, n, np, Sx);
}

namespace {

constexpr int THREADS = 32;

template <typename S, int DX, int DU>
int launch_backward(const void* const* in, void* const* out, int T, int N, cudaStream_t s) {
  const int blocks = (N + THREADS - 1) / THREADS;
  gps_backward_kernel<S, DX, DU><<<blocks, THREADS, 0, s>>>(
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9],
      (const S*)in[10], (const S*)in[11], (const S*)in[12], (const S*)in[13],
      (const S*)in[14], (const S*)in[15], (const S*)in[16], (S*)out[0], (S*)out[1],
      (S*)out[2], (S*)out[3], (S*)out[4], (S*)out[5], (unsigned char*)out[6], T, N);
  return (int)cudaGetLastError();
}

template <typename S, int DX, int DU>
int launch_forward_kl(const void* const* in, void* const* out, int T, int N, cudaStream_t s) {
  const int blocks = (N + THREADS - 1) / THREADS;
  gps_forward_kl_kernel<S, DX, DU><<<blocks, THREADS, 0, s>>>(
      (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3], (const S*)in[4],
      (const S*)in[5], (const S*)in[6], (const S*)in[7], (const S*)in[8], (const S*)in[9],
      (const S*)in[10], (const S*)in[11], (S*)out[0], (S*)out[1], (S*)out[2], T, N);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void* const*, void* const*, int, int, cudaStream_t);

// The instantiated (dx, du): Pendulum and LQR (2, 1), Cartpole (4, 1), and
// the dual chain's benchmark shape (4, 2); float32 and float64 each.
template <bool Backward>
Launch pick(int dtype, int dx, int du) {
#define TRAJOPT_GPS_CASE(DX, DU)                                                   \
  if (dx == DX && du == DU) {                                                      \
    if (dtype == 0) return Backward ? launch_backward<float, DX, DU>               \
                                    : launch_forward_kl<float, DX, DU>;            \
    if (dtype == 1) return Backward ? launch_backward<double, DX, DU>              \
                                    : launch_forward_kl<double, DX, DU>;           \
  }
  TRAJOPT_GPS_CASE(2, 1)
  TRAJOPT_GPS_CASE(4, 1)
  TRAJOPT_GPS_CASE(4, 2)
#undef TRAJOPT_GPS_CASE
  return nullptr;
}

}  // namespace

// C entry points.  dtype: 0 float32, 1 float64.  Each returns the CUDA error
// of its launch, or -1 when no kernel is instantiated for (dtype, dx, du).
extern "C" int trajopt_gps_backward(
    int dtype, int dx, int du, const void* cxx, const void* cx, const void* cuu,
    const void* cu, const void* cxu, const void* c0, const void* A, const void* B,
    const void* c, const void* sigd, const void* Ko, const void* ko, const void* sigo,
    const void* alpha, const void* vT, const void* vvT, const void* v0T, void* K, void* kff,
    void* sigc, void* V0, void* vv0, void* c0_out, void* bad, int T, int N, void* stream) {
  const Launch f = pick<true>(dtype, dx, du);
  if (f == nullptr) return -1;
  const void* in[17] = {cxx, cx, cuu, cu, cxu, c0, A, B, c, sigd, Ko, ko, sigo, alpha,
                        vT, vvT, v0T};
  void* out[7] = {K, kff, sigc, V0, vv0, c0_out, bad};
  return f(in, out, T, N, (cudaStream_t)stream);
}

extern "C" int trajopt_gps_forward_kl(
    int dtype, int dx, int du, const void* A, const void* B, const void* c,
    const void* sigd, const void* K, const void* kff, const void* sigc, const void* Ko,
    const void* ko, const void* sigo, const void* mu0, const void* sig0, void* kl,
    void* muT, void* sigT, int T, int N, void* stream) {
  const Launch f = pick<false>(dtype, dx, du);
  if (f == nullptr) return -1;
  const void* in[12] = {A, B, c, sigd, K, kff, sigc, Ko, ko, sigo, mu0, sig0};
  void* out[3] = {kl, muT, sigT};
  return f(in, out, T, N, (cudaStream_t)stream);
}
