// S3: the speculative pipeline's query, result and size check, fused.
//
// Replaces no TPU kernel: the JAX pipeline (huffmandecoderongpus_tpu/ops/
// speculative.py speculative_decode_xla :142-173) runs these stages as XLA
// gathers over `size` outputs.  Output index i starts at bit 0 and, for
// every set bit k of i from the top level down, jumps by the level-k span
// at its position: a kept (even) level is read, an odd one composed from
// the kept level below with the doubling's validity rule (delta_at,
// :142-152).  Then result[i] = sym[pos], and found_size = size if the last
// codeword ends exactly at `bits` and no taken span was -1, else -1.
//
// Every index is clamped into the stream as XLA's mode="clip" gathers are:
// a position may reach `bits` itself.  A taken -1 span counts as 0 for
// the position and sets the `bad` flag, an OR over every output's walk
// (:166).  The last codeword's end, pos + its code length, is read from
// kept level 0 (step0): where step0 is -1 the length runs past `bits` and
// the end cannot equal it, so the test is the JAX one.  The last block to
// finish (a ticket in state[2], after a fence) writes found_size from
// state[0] (bad) and state[1] (the end test).  The launcher zeroes the
// three state words.
//
// Kept levels arrive as up to 16 pointers (levels 0, 2, 4, ...) with a mask
// of the int32 ones; the others are int16, sign-extended on load.
//
// What bounds it on the H100: each output's walk is a chain of dependent
// gathers, ~17 on a kjv-sized stream, but outputs that share the high bits
// of their index share that part of the walk.  The design walks each
// shared part once, as a tree:
//  - node n (an index) has position P(n), the walk of n's set bits; the
//    walk of n + 2^k, where n's bits below k + 1 are zero, is P(n) and
//    then one more jump, the level-k span at P(n): one kept load, two
//    where k is odd.  That jump is the "edge into" n + 2^k; every output's
//    walk is the chain of edges into its prefixes;
//  - a block owns the 2^B outputs from base = blockIdx * 2^B and keeps
//    their positions in shared memory.  Thread 0 walks base's bits >= B
//    (the prefix, levels - B levels at most), then warp 0 expands the tree
//    SHUF levels by shuffles (lane l the node base + l 2^(B-SHUF)) and
//    stores its 32 positions;
//  - the other levels go one a round over the whole block, a barrier
//    each: at level k the nodes (2m + 1) 2^k, m = thread, thread +
//    THREADS, ..., from their parents 2m 2^k.  Neighbouring threads take
//    neighbouring nodes, whose positions are neighbouring codewords, so a
//    warp's gathers fall in few lines at the low levels, where most nodes
//    are.  A thread loads all its parents, then makes all its jumps (their
//    loads independent, an odd level's second load made whatever the
//    first gave), then stores;
//  - then a thread an output reads the symbol and stores the byte: a
//    warp's 32 symbols lie within ~150 bytes, its stores are one stretch;
//  - a node at or past `size` makes no jump: no output past `size` exists,
//    and every node under it is past it too.  So the edge into each node
//    n < size (n > 0) is read once in the whole grid, or once a block that
//    shares it where n is a multiple of 2^B (a prefix); a taken -1 span
//    flags `bad` exactly where some output takes it, since the node n that
//    the edge leads to is an output itself (the edges of a prefix lead to
//    nodes <= base < size);
//  - the dependent chain of a block is its prefix and B jumps, against
//    every output's ~17 in a walk a thread; 16 blocks of 128 threads an SM
//    hide it behind each other.
// The kept loads are then the entries that chip_smoke.py spec_query_moved
// counts (one a distinct (level, node), two where the level is odd), and
// the prefixes, a few a block.  Those entries lie one a codeword in kept
// level 0 and in sym, and every few codewords in kept level 2, so the
// lines the card reads cover most of those three (bits x 5 bytes) and more
// than the entries alone: the card time stays ~10 x the entries' bound.
// PERF.md gives the other layouts timed against this one (S3).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int B = 10;         // a block's outputs, 2^B
constexpr int THREADS = 128;  // a block's threads
constexpr int SHUF = 5;       // warp 0's shuffle levels, B-1 .. B-SHUF
static_assert(B >= SHUF && THREADS >= 32, "warp 0's levels");
constexpr int MAX_KEPT = 16;  // levels 0, 2, ..., 30: sizes below 2^31
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Kept {
  const void* p[MAX_KEPT];
};

__device__ __forceinline__ int load_level(const Kept& kept, unsigned wide,
                                          int j, int at) {
  return (wide >> j) & 1u ? __ldg((const int32_t*)kept.p[j] + at)
                          : (int)__ldg((const int16_t*)kept.p[j] + at);
}

// The position after the level-k span at pos: pos + the span, or pos where
// the span is -1 (then `bad`).  Odd levels are composed from kept level
// k - 1 as the doubling does; the second load is made whatever the first
// gave (at a clamped offset, its value then unused), so a thread's jumps
// carry no branch on their values.
__device__ __forceinline__ int jump(const Kept& kept, unsigned wide, int k,
                                    int pos, int bits, bool& bad) {
  const int at = min(pos, bits - 1);
  int delta;
  if (!(k & 1)) {
    delta = load_level(kept, wide, k >> 1, at);
  } else {
    const int j = k >> 1;
    const int d1 = load_level(kept, wide, j, at);
    const long long t = (long long)pos + d1;
    const int d2 = load_level(kept, wide, j, (int)min(max(t, 0LL),
                                                      (long long)bits - 1));
    const bool ok = d1 != -1 && t < bits && d2 != -1 &&
                    t + d2 <= (long long)bits;
    delta = ok ? d1 + d2 : -1;
  }
  bad |= delta == -1;
  return delta == -1 ? pos : pos + delta;
}

// Level K over the block, then the levels below: node (2m + 1) 2^K from
// (2m) 2^K for m = thread + THREADS u, all parents loaded first.
template <int K>
__device__ __forceinline__ void rounds(int* __restrict__ pos,
                                       const Kept& kept, unsigned wide,
                                       long long base, int size, int bits,
                                       bool& bad) {
  constexpr int NODES = 1 << (B - 1 - K);
  constexpr int PER = NODES > THREADS ? NODES / THREADS : 1;
  int p[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int m = threadIdx.x + u * THREADS;
    p[u] = m < NODES ? pos[(2 * m) << K] : 0;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int m = threadIdx.x + u * THREADS;
    if (m < NODES && base + ((2 * m + 1) << K) < size)
      p[u] = jump(kept, wide, K, p[u], bits, bad);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int m = threadIdx.x + u * THREADS;
    if (m < NODES && base + ((2 * m + 1) << K) < size)
      pos[(2 * m + 1) << K] = p[u];
  }
  __syncthreads();
  if constexpr (K > 0) rounds<K - 1>(pos, kept, wide, base, size, bits, bad);
}

// __grid_constant__: the pointers are indexed in place in the parameter
// space, with no copy to a local stack
__global__ void __launch_bounds__(THREADS) spec_query_kernel(
    const __grid_constant__ Kept kept, unsigned wide,
    const uint8_t* __restrict__ sym,
    uint8_t* __restrict__ result, int* __restrict__ state,
    int* __restrict__ found, int bits, int size, int levels) {
  __shared__ int pos[1 << B];  // P(base + i)
  __shared__ int block_bad;
  const long long base = (long long)blockIdx.x << B;
  bool bad = false;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int p = 0;
    if (lane == 0) {
      block_bad = 0;
      for (int k = levels - 1; k >= B; --k)
        if ((base >> k) & 1) p = jump(kept, wide, k, p, bits, bad);
    }
    p = __shfl_sync(FULL, p, 0);
    // levels B-1 .. B-SHUF: at level B-1-r the lanes l whose low bits end
    // in 1 << b (b = SHUF-1-r) take the node of lane l - 2^b and jump
#pragma unroll
    for (int r = 0; r < SHUF; ++r) {
      const int b = SHUF - 1 - r;
      const int from = __shfl_sync(FULL, p, lane & ~((2 << b) - 1));
      if ((lane & ((2 << b) - 1)) == (1 << b) &&
          base + ((long long)lane << (B - SHUF)) < size)
        p = jump(kept, wide, B - 1 - r, from, bits, bad);
    }
    pos[lane << (B - SHUF)] = p;
  }
  __syncthreads();
  if constexpr (B > SHUF)
    rounds<B - SHUF - 1>(pos, kept, wide, base, size, bits, bad);
  const int last = bits - 1;
  for (int i = threadIdx.x; i < (1 << B) && base + i < size; i += THREADS) {
    const int at = min(pos[i], last);
    result[base + i] = __ldg(sym + at);
    if (base + i == (long long)size - 1) {
      const int ln = load_level(kept, wide, 0, at);
      state[1] = ln != -1 && (long long)pos[i] + ln == (long long)bits;
      __threadfence();
    }
  }
  if (bad) block_bad = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_bad) state[0] = 1;
    __threadfence();
    if (atomicAdd((unsigned*)&state[2], 1u) == gridDim.x - 1) {
      __threadfence();
      const volatile int* v = state;
      *found = v[1] && !v[0] ? size : -1;
    }
  }
}

}  // namespace

// level_ptrs: a host array of n_kept device pointers, kept levels 0, 2, ...
// (bits,) each, int32 where bit j of wide_mask is set, else int16; sym
// (bits,) uint8; result (size,) uint8; state (3,) int32 scratch; found
// (1,) int32.  Positions stay below bits + 32, so bits is at most
// 2^31 - 33.
extern "C" int ws_spec_query(const long long* level_ptrs, int n_kept,
                             int wide_mask, const uint8_t* sym,
                             uint8_t* result, int* state, int* found,
                             int bits, int size, int levels,
                             cudaStream_t stream) {
  if (bits <= 0 || bits > 0x7FFFFFFF - 32 || size <= 0 || levels < 0 ||
      levels > 31 || n_kept != (levels + 1) / 2 + (levels == 0) ||
      n_kept > MAX_KEPT)
    return (int)cudaErrorInvalidValue;
  Kept kept{};
  for (int j = 0; j < n_kept; ++j)
    kept.p[j] = (const void*)(uintptr_t)level_ptrs[j];
  const cudaError_t e = cudaMemsetAsync(state, 0, 3 * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(((long long)size + (1 << B) - 1) >> B);
  spec_query_kernel<<<blocks, THREADS, 0, stream>>>(
      kept, (unsigned)wide_mask, sym, result, state, found, bits, size,
      levels);
  return (int)cudaGetLastError();
}
