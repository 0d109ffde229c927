// Forward-mode dual numbers for in-kernel Jacobians: a value and N tangents,
// so one evaluation of a function gives all N columns of its Jacobian at once
// (the counterpart of jax.linearize over the tile code of the TPU kernels).
// K1 (fused_backward.cu) differentiates the env's RK4 step over dx + du
// tangents.  Duals nest: Dual<Dual<S, M>, N> carries second derivatives, as
// the BSP kernels (bsp.cu) need for the Jacobian of an EKF step, which itself
// holds the Jacobians of the dynamics and the observation model.
#pragma once

#include <math.h>

#include "scalar.cuh"

template <typename S, int N>
struct Dual {
  S v;
  S d[N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(S value) : v(value) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = S(0);
  }
};

// The real type under a (possibly nested) dual scalar type.
template <typename T> struct RealOf { using type = T; };
template <typename S, int N> struct RealOf<Dual<S, N>> { using type = typename RealOf<S>::type; };

// The real value of a (possibly nested) dual, for comparisons.
template <typename S>
__device__ __forceinline__ S value_of(S x) { return x; }
template <typename S, int N>
__device__ __forceinline__ typename RealOf<S>::type value_of(const Dual<S, N>& a) {
  return value_of(a.v);
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator/(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v / b.v;
  const S inv = S(1) / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

// Mixed with a plain constant (the env's and the integrator's coefficients);
// the constant is of the real type under any nesting.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(typename RealOf<S>::type c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c * a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * a.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(const Dual<S, N>& a, typename RealOf<S>::type c) {
  Dual<S, N> r;
  r.v = a.v * c;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator/(const Dual<S, N>& a, typename RealOf<S>::type c) {
  Dual<S, N> r;
  r.v = a.v / c;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(typename RealOf<S>::type c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c - a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a, typename RealOf<S>::type c) {
  Dual<S, N> r = a;
  r.v = a.v - c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(const Dual<S, N>& a, typename RealOf<S>::type c) {
  Dual<S, N> r = a;
  r.v = a.v + c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(typename RealOf<S>::type c, const Dual<S, N>& a) {
  Dual<S, N> r = a;
  r.v = c + a.v;
  return r;
}

// Elementary functions, overloaded for plain and dual scalars.
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> sin_(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = sin_(a.v);
  const S c = cos_(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> cos_(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = cos_(a.v);
  const S s = -sin_(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * s;
  return r;
}

// √a with d√a = da · (½ / √a), jax.lax.sqrt's derivative.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> sqrt_(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = sqrt_(a.v);
  const S h = S(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * h;
  return r;
}

// jnp.clip's value (NaN passes through) ...
template <typename S>
__device__ __forceinline__ S clip_(S x, S lo, S hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ... and its derivative under JAX's tie rule: max/min split a tie evenly, so
// the slope is 1 strictly inside, 0.5 exactly at a bound and 0 outside.  The
// slope is constant in x, so nested tangents see the same rule at every
// level.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> clip_(const Dual<S, N>& a, typename RealOf<S>::type lo,
                                            typename RealOf<S>::type hi) {
  using R = typename RealOf<S>::type;
  Dual<S, N> r;
  r.v = clip_(a.v, lo, hi);
  const R x = value_of(a);
  const R slope = (x > lo && x < hi) ? R(1) : ((x == lo || x == hi) ? R(0.5) : R(0));
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * slope;
  return r;
}

// JAX's floored `%` for the angle wrap: fmod, then shift a negative remainder
// by the divisor; the derivative passes through unchanged.
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }

constexpr double kPi = 3.141592653589793;

template <typename S>
__device__ __forceinline__ S wrap_angle_(S x) {
  const S two_pi = S(2.0 * kPi);
  S r = fmod_(x + S(kPi), two_pi);
  if (r < S(0)) r = r + two_pi;
  return r - S(kPi);
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> wrap_angle_(const Dual<S, N>& a) {
  Dual<S, N> r = a;
  r.v = wrap_angle_(a.v);
  return r;
}
