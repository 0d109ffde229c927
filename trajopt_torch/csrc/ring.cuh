// The ring of stages in shared memory that the staged kernels share: K4
// (ilqr_backward.cu) and K1 (fused_backward.cu) through bwd_step.cuh's
// staged backward, which walks its chunks backward in time, K2 and K3
// (rollout.cu), which walk them forward, and the staged walk
// (staged_walk.cuh) of K6, K7 (gps.cu) and K8 (belief.cu), whose rings have
// three or four stages.
//
// A block splits its warps into consumers, which walk a chain that depends on
// the step before, one lane per instance (or per α and instance), reading
// every operand of a step from shared memory, and producers, which fill the
// next stage of a ring of kStages stages, one chunk of steps each, while the
// consumers work through the stage before.  Named barriers hand the stages
// over: a producer waits on EMPTY(s) before refilling stage s and arrives on
// FULL(s) once it is filled; a consumer waits on FULL(s) and arrives on
// EMPTY(s) when it is done with it.
#pragma once

#include <cuda_runtime.h>

constexpr int kStages = 2;   // stages in the ring

// The warp roles of a block with C consumer warps (0 … C − 1) and P producer
// warps.  Warp w issues from SM sub-partition w mod 4.  While the consumers
// leave sub-partitions free, no producer takes one of theirs: a warp that
// would land there is launched but exits at once, so the producers share the
// free sub-partitions' schedulers and each consumer chain keeps its own.
__host__ __device__ constexpr bool warp_idle(int C, int w) { return w >= C && C < 4 && w % 4 < C; }
__host__ __device__ constexpr int warps_launched(int C, int P) {
  int w = C;
  for (int p = 0; p < P; ++w)
    if (!warp_idle(C, w)) ++p;
  return w;
}

template <int C, int P>
struct WarpRoles {
  static constexpr int kConsumers = C, kProducers = P;
  static constexpr int kWarps = warps_launched(C, P);   // idle ones too
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBarrier = 32 * (C + P);         // threads at the barriers
  __device__ static __forceinline__ bool idle(int w) { return warp_idle(C, w); }
  // The rank of producer warp w among the producers: w less the consumers
  // and the idle warps before it, C in each four from warp 4 on (w itself
  // is not idle, so w mod 4 ≥ C).
  __device__ static __forceinline__ int producer(int w) {
    return C >= 4 ? w - C : w - C - w / 4 * C;
  }
};

// Named barriers 1 … 2·S (0 is __syncthreads') over N threads.  Each
// helper first reconverges the warp: bar is warp-aligned.
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(N) : "memory");
}
// S is the ring's number of stages (kStages unless a kernel sizes its own).
__device__ __forceinline__ int full_barrier(int stage) { return 1 + stage; }
template <int S = kStages>
__device__ __forceinline__ int empty_barrier(int stage) { return 1 + S + stage; }

// The four hand-overs of chunk k (of `chunks`), in stage k mod S.
// Consumers: wait until it is filled, and free it once consumed (the last
// S chunks are never refilled, so nobody waits for them).
template <int N, int S = kStages>
__device__ __forceinline__ void ring_acquire(int k) { named_sync<N>(full_barrier(k % S)); }
template <int N, int S = kStages>
__device__ __forceinline__ void ring_release(int k, int chunks) {
  if (k + S < chunks) named_arrive<N>(empty_barrier<S>(k % S));
}
// Producers: wait until the stage is free, and publish it once filled.
template <int N, int S = kStages>
__device__ __forceinline__ void ring_reserve(int k) {
  if (k >= S) named_sync<N>(empty_barrier<S>(k % S));
}
template <int N, int S = kStages>
__device__ __forceinline__ void ring_publish(int k) { named_arrive<N>(full_barrier(k % S)); }

// A 16-byte copy from device memory to shared memory that bypasses L1, and
// the wait for all of this thread's copies to land.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
// An element copy from device memory to shared memory (cp.async, 4 or 8
// bytes: a row's entries of a (steps, entries, N) stream are N apart).
template <typename S>
__device__ __forceinline__ void cp_async_elem(S* dst, const S* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(sizeof(S))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}
// Close this thread's group of copies; wait until all its groups but the
// newest have landed.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Launch a staged kernel: raise its dynamic shared memory limit to the
// ring's `bytes`, launch, and return the CUDA error.
template <typename Kernel, typename... Args>
__host__ int launch_ring(Kernel kernel, dim3 grid, int threads, int bytes, cudaStream_t stream,
                         Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0 || grid.y == 0) return 0;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}
