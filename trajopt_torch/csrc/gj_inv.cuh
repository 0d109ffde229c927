// Gauss–Jordan inverse with partial pivoting of a small matrix in registers,
// shared by the parallel-in-time backward (K5, pscan_backward.cu) and the
// eLQR sweeps (K11–K14, elqr.cu).  Counterpart of _gj_inv in
// trajopt_tpu/core/pscan_lqr.py and trajopt_torch/core/pscan_lqr.py: each
// step compare-swaps the pivot row against every later row (a running
// maximum, so partial pivoting); a pivot-free elimination is wrong on valid
// PSD inputs.
#pragma once

#include <math.h>

__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// G = M⁻¹; M is destroyed.
template <typename S, int N>
__device__ __forceinline__ void gj_inv(S (&M)[N][N], S (&G)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) G[i][j] = i == j ? S(1) : S(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const bool swap = abs_(M[i][k]) > abs_(M[k][k]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const S mk = M[k][j], mi = M[i][j];
        M[k][j] = swap ? mi : mk;
        M[i][j] = swap ? mk : mi;
        const S gk = G[k][j], gi = G[i][j];
        G[k][j] = swap ? gi : gk;
        G[i][j] = swap ? gk : gi;
      }
    }
    const S piv = S(1) / M[k][k];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M[k][j] = M[k][j] * piv;
      G[k][j] = G[k][j] * piv;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const S f = M[i][k];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        M[i][j] = M[i][j] - f * M[k][j];
        G[i][j] = G[i][j] - f * G[k][j];
      }
    }
  }
}
