// Forward-mode dual numbers for the in-kernel Jacobians of the fused iLQR
// backward (K1): a value and N tangents, so one evaluation of the env's RK4
// step gives all dx + du columns of A and B at once (the counterpart of
// jax.linearize over the tile dynamics in trajopt_tpu/core/pallas_fused.py).
#pragma once

#include <math.h>

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

// The real type under a (possibly dual) scalar type.
template <typename T> struct RealOf { using type = T; };
template <typename S, int N> struct RealOf<Dual<S, N>> { using type = S; };

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

// Mixed with a plain constant (the env's and the integrator's coefficients).
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(S c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c * a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * a.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator/(const Dual<S, N>& a, S c) {
  Dual<S, N> r;
  r.v = a.v / c;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(S c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c - a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a, S c) {
  Dual<S, N> r = a;
  r.v = a.v - c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(const Dual<S, N>& a, S c) {
  Dual<S, N> r = a;
  r.v = a.v + c;
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

// jnp.clip's value (NaN passes through) ...
template <typename S>
__device__ __forceinline__ S clip_(S x, S lo, S hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ... and its derivative under JAX's tie rule: max/min split a tie evenly, so
// the slope is 1 strictly inside, 0.5 exactly at a bound and 0 outside.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> clip_(const Dual<S, N>& a, S lo, S hi) {
  Dual<S, N> r;
  r.v = clip_(a.v, lo, hi);
  const S slope = (a.v > lo && a.v < hi) ? S(1) : ((a.v == lo || a.v == hi) ? S(0.5) : S(0));
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
