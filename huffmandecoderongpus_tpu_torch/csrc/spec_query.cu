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
// the position and sets the `bad` flag, which is an OR over the whole grid
// (:166): each block ORs its threads' flags in shared memory and thread 0
// stores 1 to state[0].  The last codeword's end, pos + its code length,
// is read from kept level 0 (step0): where step0 is -1 the length runs past
// `bits` and the end cannot equal it, so the test is the JAX one.  The last
// block to finish (a ticket in state[2], after a fence) writes found_size
// from state[0] and state[1].  The launcher zeroes the three state words.
//
// Kept levels arrive as up to 16 pointers (levels 0, 2, 4, ...) with a mask
// of the int32 ones; the others are int16, sign-extended on load.
//
// What bounds it on the H100: its gathers.  Output i's position rises with
// i, and above level 5 a warp's 32 walks share their position (one
// broadcast load a level), below it they read nearby addresses.  The bytes
// it must move: the result, the symbol at each output's position, and each
// kept entry the walks read, once for each distinct (level, position)
// pair: at level k the outputs i = (2m + 1) 2^k, two entries where k is
// odd (chip_smoke.py spec_query_moved).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KEPT = 16;  // levels 0, 2, ..., 30: sizes below 2^31

struct Kept {
  const void* p[MAX_KEPT];
};

__device__ __forceinline__ int load_level(const Kept& kept, unsigned wide,
                                          int j, long long at) {
  return (wide >> j) & 1u ? __ldg((const int32_t*)kept.p[j] + at)
                          : (int)__ldg((const int16_t*)kept.p[j] + at);
}

// __grid_constant__: the pointers are indexed in place in the parameter
// space, with no copy to a local stack
__global__ void __launch_bounds__(THREADS) spec_query_kernel(
    const __grid_constant__ Kept kept, unsigned wide,
    const uint8_t* __restrict__ sym,
    uint8_t* __restrict__ result, int* __restrict__ state,
    int* __restrict__ found, int bits, int size, int levels) {
  __shared__ int block_bad;
  if (threadIdx.x == 0) block_bad = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long last = (long long)bits - 1;
  if (i < size) {
    long long pos = 0;
    bool bad = false;
    for (int k = levels - 1; k >= 0; --k) {
      if (!((i >> k) & 1)) continue;
      int delta;
      if (k % 2 == 0) {
        delta = load_level(kept, wide, k / 2, min(pos, last));
      } else {  // composed from kept level k - 1
        const int j = (k - 1) / 2;
        const int d1 = load_level(kept, wide, j, min(pos, last));
        const long long t = pos + d1;
        delta = -1;
        if (d1 != -1 && t < bits) {
          const int d2 = load_level(kept, wide, j, max(t, 0ll));
          if (d2 != -1 && t + d2 <= (long long)bits) delta = d1 + d2;
        }
      }
      if (delta == -1)
        bad = true;
      else
        pos += delta;
    }
    const long long at = min(pos, last);
    result[i] = __ldg(sym + at);
    if (bad) block_bad = 1;
    if (i == (long long)size - 1) {
      const int ln = load_level(kept, wide, 0, at);
      state[1] = ln != -1 && pos + ln == (long long)bits;
      __threadfence();
    }
  }
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
// (bits,) uint8; result (size,) uint8; state (3,) int32 scratch; found (1,)
// int32
extern "C" int ws_spec_query(const long long* level_ptrs, int n_kept,
                             int wide_mask, const uint8_t* sym,
                             uint8_t* result, int* state, int* found,
                             int bits, int size, int levels,
                             cudaStream_t stream) {
  if (bits <= 0 || size <= 0 || levels < 0 || levels > 31 ||
      n_kept != (levels + 1) / 2 + (levels == 0) || n_kept > MAX_KEPT)
    return (int)cudaErrorInvalidValue;
  Kept kept{};
  for (int j = 0; j < n_kept; ++j)
    kept.p[j] = (const void*)(uintptr_t)level_ptrs[j];
  const cudaError_t e = cudaMemsetAsync(state, 0, 3 * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks =
      (unsigned)(((long long)size + THREADS - 1) / THREADS);
  spec_query_kernel<<<blocks, THREADS, 0, stream>>>(
      kept, (unsigned)wide_mask, sym, result, state, found, bits, size,
      levels);
  return (int)cudaGetLastError();
}
