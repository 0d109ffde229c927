// Elementary functions of the plain scalar types, overloaded for float and
// double, shared by the dual numbers (dual.cuh) and the backward steps
// (bwd_step.cuh).
#pragma once

#include <math.h>

template <typename S> __device__ __forceinline__ bool finite_(S x) { return isfinite(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
