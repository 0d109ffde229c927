// The staged walk that K6, K7 (gps.cu) and K8 (belief.cu) share: one block
// body for a batch of instances, each a chain of T dependent steps whose
// operands do not depend on the carry.
//
// A block takes W::kGroup instances (at most 32).  Warp 0 is the consumer,
// one lane per instance: it walks the horizon (backward in time for K6 and
// K8, forward for K7) with the instance's carry in registers, doing only
// the work that depends on the carry and reading every operand of a step
// from shared memory.  W::kProducers producer warps fill a ring of
// W::kStages stages (ring.cuh), a chunk of steps each: they copy chunk
// k + 1's rows of the streams with cp.async (16 bytes a copy where N and
// the streams' addresses allow, else an entry), the rows the consumer reads
// straight into its stage and the rows that only they read (W::R entries a
// step) into one of two buffers of their own, while they compute chunk k's
// carry-free part of each step (W::augment, where W::kAugments) from the
// other buffer and the stage into the stage.  So no producer waits on a
// chunk's copies before the chunk is due.  Lanes past N neither read nor
// write, so any N ≥ 1 runs.
//
// The walk cannot start before the first chunk's copies land (a shorter
// first chunk did not start it sooner; PERF.md).  A step's slot in a stage
// holds W::E entries; entry e of step slot s of lane g sits at
// [(s·E + e)·kGroup + g], so the consumer's lanes read neighbouring words.
//
// W supplies, besides those constants and its scalar type S:
//   row(e, t)               the row (all N instances) of step t of entry
//                           e < COPIED (a stage entry) or of raw entry
//                           e − COPIED;
//   augment(raw, op)        a producer's carry-free part of one lane-step,
//                           from its raw slot and stage slot into the stage
//                           slot (lane stride kGroup);
//   begin(c, n), step(op, c, t, n), finish(c, n)
//                           the consumer lane's carry c of instance n: its
//                           start, step t from the stage slot op, its end.
#pragma once

#include "ring.cuh"

// Read entry `at` onwards of a stage slot (lane stride G) into M / x, or
// write them there.
template <int G, typename S, int R, int C>
__device__ __forceinline__ void slot_get(const S* op, int at, S (&M)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) M[i][j] = op[(at + i * C + j) * G];
}
template <int G, typename S, int R>
__device__ __forceinline__ void slot_get(const S* op, int at, S (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = op[(at + i) * G];
}
template <int G, typename S, int R, int C>
__device__ __forceinline__ void slot_put(S* op, int at, const S (&M)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) op[(at + i * C + j) * G] = M[i][j];
}
template <int G, typename S, int R>
__device__ __forceinline__ void slot_put(S* op, int at, const S (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) op[(at + i) * G] = x[i];
}

// Shared memory of a block: kStages stages and two raw buffers of `chunk`
// steps.
template <typename S, int G, int NS, int E, int R>
constexpr int walk_bytes(int chunk) {
  return (int)sizeof(S) * chunk * G * (NS * E + 2 * R);
}
// The longest chunk of 16, 8, 4, 2 or 1 steps whose block fits `budget`
// bytes (0: none fits).
template <typename S, int G, int NS, int E, int R>
constexpr int walk_chunk(int budget) {
  return walk_bytes<S, G, NS, E, R>(16) <= budget  ? 16
         : walk_bytes<S, G, NS, E, R>(8) <= budget ? 8
         : walk_bytes<S, G, NS, E, R>(4) <= budget ? 4
         : walk_bytes<S, G, NS, E, R>(2) <= budget ? 2
         : walk_bytes<S, G, NS, E, R>(1) <= budget ? 1 : 0;
}

template <class W>
struct WalkShape {
  using Roles = WarpRoles<1, W::kProducers>;
  static constexpr int STAGE = W::kChunk * W::E * W::kGroup;   // elements
  static constexpr int RAW = W::kChunk * W::R * W::kGroup;
  static constexpr int BYTES = walk_bytes<typename W::Scalar, W::kGroup, W::kStages, W::E, W::R>(
      W::kChunk);
  static constexpr int kProducerBarrier = 1 + 2 * W::kStages;   // after the ring's
  static_assert(W::kGroup <= 32 && W::kChunk >= 1, "a walk's shape");
  static_assert(BYTES <= 227 * 1024, "a block's shared memory");
};

// Chunk k of a walk over T steps: the step it starts at and its length; step
// s of the chunk is walk_t<W>(t0, s).
template <class W>
__device__ __forceinline__ void walk_span(int k, int T, int& t0, int& steps) {
  const int done = k * W::kChunk;   // steps before chunk k
  steps = T - done < W::kChunk ? T - done : W::kChunk;
  t0 = W::kForward ? done : T - 1 - done;
}
template <class W>
__device__ __forceinline__ int walk_t(int t0, int s) { return W::kForward ? t0 + s : t0 - s; }
template <class W>
__device__ __forceinline__ int walk_chunks(int T) { return (T + W::kChunk - 1) / W::kChunk; }

// Chunk k's rows into the stage `stage` (entries below COPIED) and the
// buffer `raw` (the rest), as producer thread tid: 16 bytes a copy where
// `vec` (N and every stream's address allow it), else an entry; lanes past
// N are not read.
template <class W, typename S>
__device__ __forceinline__ void walk_copy(const W& w, S* stage, S* raw, int t0, int steps,
                                          int n0, int N, bool vec, int tid) {
  constexpr int G = W::kGroup, E = W::E, R = W::R, COPIED = W::COPIED;
  constexpr int P = 32 * W::kProducers, VEC = 16 / sizeof(S), PIECES = G / VEC;
  constexpr int ROWS = COPIED + R;   // rows a step: copied, then raw
  if (vec) {
    for (int q = tid; q < steps * ROWS * PIECES; q += P) {
      const int piece = q % PIECES, se = q / PIECES, e = se % ROWS, s = se / ROWS;
      const int g = piece * VEC;
      if (n0 + g >= N) continue;
      S* dst = e < COPIED ? stage + (s * E + e) * G + g : raw + (s * R + e - COPIED) * G + g;
      cp_async16(dst, w.row(e, walk_t<W>(t0, s)) + n0 + g);
    }
  } else {
    for (int q = tid; q < steps * ROWS * G; q += P) {
      const int g = q % G, se = q / G, e = se % ROWS, s = se / ROWS;
      if (n0 + g >= N) continue;
      S* dst = e < COPIED ? stage + (s * E + e) * G + g : raw + (s * R + e - COPIED) * G + g;
      cp_async_elem(dst, w.row(e, walk_t<W>(t0, s)) + n0 + g);
    }
  }
}

// The block body: block b takes instances kGroup·b …; warp 0 is the consumer
// (lanes past kGroup or past N idle).  The producers copy chunk k + 1 while
// they augment chunk k, and the consumer walks chunk k − 1 or k.
template <class W>
__device__ __forceinline__ void staged_walk(const W& w, int T, int N, bool vec) {
  using S = typename W::Scalar;
  using Sh = WalkShape<W>;
  using Roles = typename Sh::Roles;
  constexpr int G = W::kGroup, E = W::E, R = W::R, NS = W::kStages, B = Roles::kBarrier;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  S* ring = reinterpret_cast<S*>(walk_smem);
  S* raw = ring + NS * Sh::STAGE;   // two buffers of Sh::RAW
  const int n0 = blockIdx.x * G;
  const int chunks = walk_chunks<W>(T);
  const int warp = threadIdx.x / 32;

  if (warp == 0) {
    const int g = threadIdx.x, n = n0 + g;
    const bool live = g < G && n < N;
    typename W::Carry carry;
    if (live) w.begin(carry, n);
    for (int k = 0; k < chunks; ++k) {
      int t0, steps;
      walk_span<W>(k, T, t0, steps);
      ring_acquire<B, NS>(k);
      if (live) {
        const S* stage = ring + (k % NS) * Sh::STAGE + g;
        for (int s = 0; s < steps; ++s) w.step(stage + s * E * G, carry, walk_t<W>(t0, s), n);
      }
      ring_release<B, NS>(k, chunks);
    }
    if (live) w.finish(carry, n);
  } else {
    if (Roles::idle(warp)) return;   // warp 0's sub-partition stays the consumer's
    constexpr int P = 32 * W::kProducers;
    const int tid = Roles::producer(warp) * 32 + threadIdx.x % 32;
    int t0, steps;
    walk_span<W>(0, T, t0, steps);
    ring_reserve<B, NS>(0);
    walk_copy(w, ring, raw, t0, steps, n0, N, vec, tid);
    cp_async_commit();
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        int t_next, steps_next;
        walk_span<W>(k + 1, T, t_next, steps_next);
        if constexpr (W::kAugments)
          if (k > 0) named_sync<P>(Sh::kProducerBarrier);   // chunk k − 1's buffer is read
        ring_reserve<B, NS>(k + 1);
        walk_copy(w, ring + ((k + 1) % NS) * Sh::STAGE, raw + ((k + 1) % 2) * Sh::RAW, t_next,
                  steps_next, n0, N, vec, tid);
        cp_async_commit();
        cp_async_wait_but_newest();
      } else {
        cp_async_wait_all();
      }
      if constexpr (W::kAugments) {
        named_sync<P>(Sh::kProducerBarrier);   // chunk k's copies have landed
        walk_span<W>(k, T, t0, steps);
        S* stage = ring + (k % NS) * Sh::STAGE;
        const S* buf = raw + (k % 2) * Sh::RAW;
        for (int q = tid; q < steps * G; q += P) {
          const int g = q % G, s = q / G;
          if (n0 + g < N) w.augment(buf + s * R * G + g, stage + s * E * G + g);
        }
      }
      ring_publish<B, NS>(k);
    }
  }
}

// Launch a walk over N instances: raise the kernel's dynamic shared memory
// limit to the block's, launch one block a group, return the CUDA error.
template <class W, typename Kernel>
__host__ int launch_walk(Kernel kernel, const W& w, int T, int N, bool vec,
                         cudaStream_t stream) {
  using Sh = WalkShape<W>;
  return launch_ring(kernel, dim3((N + W::kGroup - 1) / W::kGroup), Sh::Roles::kThreads, Sh::BYTES,
                     stream, w, T, N, vec);
}
