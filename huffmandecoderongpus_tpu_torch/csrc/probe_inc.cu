// P1: the launch-cost probe, out = x + 1, and its gridded mode with scratch.
//
// Replaces the trivial Pallas kernels of the hardware probes:
// scripts/hw_dispatch.py:52 and scripts/hw_k1fixed.py:57 `triv` (x + 1 on
// an (8, 128) int32 tile), :69 `triv5` (five of them chained: five launches
// here), and scripts/hw_k1fixed.py:95 `grid` (grid_k :79-89, a (1, 4) grid
// over (4, 32, 128) int32 blocks of (1, 32, 128) with four int32 scratch
// buffers, (32, 128), (14, 32, 128), (12, 32, 128) and (12, 32, 128),
// zeroed at grid step 0; out = x + s1[0, 0]).
//
// probe_inc: one thread an element, int32 arithmetic on the bit pattern
// (wrapping, as JAX and torch do).
//
// probe_grid: one block a grid step.  The Pallas grid runs its steps in
// order on one core and its scratch persists between them, so zeroing at
// step 0 serves all four; CUDA blocks run at once and share nothing, so
// every block zeroes the s1 it reads before reading it.  The four buffers
// take 638,976 bytes, more than a block's shared memory (227 KB at the
// opt-in limit): s1 lives in each block's shared memory, and s2-s4 in a
// global workspace of (14 + 12 + 12) blocks that the wrapper allocates and
// the blocks zero, each block its own contiguous quarter.  What this
// probe measures on the card is then one launch of S blocks, a zeroed
// 16 KB of shared memory a block, 622,592 bytes of zeros written to device
// memory, and the (S, R, C) copy with its one add.
//
// What bounds them on the H100: bytes, and below a few MB the launch
// itself, which is what the probe is for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) probe_inc_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)((uint32_t)x[i] + 1u);
}

__global__ void __launch_bounds__(256) probe_grid_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out,
    int32_t* __restrict__ work, int block_words, long long work_words) {
  extern __shared__ int32_t s1[];
  for (int i = threadIdx.x; i < block_words; i += blockDim.x) s1[i] = 0;
  // block b zeroes words [lo, hi) of the workspace
  const long long per = (work_words + gridDim.x - 1) / gridDim.x;
  const long long lo = per * blockIdx.x;
  const long long hi = min(work_words, lo + per);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) work[i] = 0;
  __syncthreads();
  const int32_t add = s1[0];
  const long long base = (long long)blockIdx.x * block_words;
  for (int i = threadIdx.x; i < block_words; i += blockDim.x)
    out[base + i] = (int32_t)((uint32_t)x[base + i] + (uint32_t)add);
}

}  // namespace

extern "C" int ws_probe_inc(const int32_t* x, int32_t* out, long long n,
                            cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  probe_inc_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// x, out (steps, block_words) int32; work (work_words,) int32
extern "C" int ws_probe_grid(const int32_t* x, int32_t* out, int32_t* work,
                             int steps, int block_words, long long work_words,
                             cudaStream_t stream) {
  if (steps <= 0 || block_words <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)block_words * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_grid_kernel<<<steps, 256, smem, stream>>>(x, out, work, block_words,
                                                  work_words);
  return (int)cudaGetLastError();
}
