// E2: per-lane compaction of E1's granule rows into dense rows.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_encode.py e2_compact /
// _e2_kernel.  Row g of out (G, ORP) int32 holds lane g's valid granules
// (gval != 0) in row order; ranks at or past ORP are dropped (the caller
// checks the counts and runs E2 again with a larger ORP) and the rest of
// the row is zero.
//
// The TPU kernel transposes the rows to (G, rows_p) and resolves every
// output rank by packed popcount prefixes and a binary search, because
// Mosaic has no scatter.  Here one thread owns one lane and walks its rows
// in order with a running rank, reading E1's (2K, G) layout as it is: a
// row's reads are coalesced across a warp's lanes, so no transpose pass is
// needed.
//
// What bounds it on the H100: memory traffic and latency.  Every row of
// gran and gval is read once (coalesced, loads issued UNROLL rows ahead);
// the dense writes are 4-byte stores ORP words apart between lanes, which
// the L2 merges into whole sectors before they reach memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS) e2_compact_kernel(
    const int32_t* __restrict__ gran, const uint8_t* __restrict__ gval,
    int32_t* __restrict__ out, int rows, int G, int ORP) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int32_t* row = out + (size_t)g * ORP;
  int rank = 0;
  for (int r0 = 0; r0 < rows; r0 += UNROLL) {
    uint8_t v[UNROLL];
    int32_t x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = r0 + u < rows;
      const size_t o = (size_t)(r0 + u) * G + g;
      v[u] = in ? gval[o] : 0;
      x[u] = in ? gran[o] : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v[u]) {
        if (rank < ORP) row[rank] = x[u];
        ++rank;
      }
    }
  }
  for (int i = rank; i < ORP; ++i) row[i] = 0;
}

}  // namespace

extern "C" int ws_e2_compact(const int32_t* gran, const uint8_t* gval,
                             int32_t* out, int rows, int G, int ORP,
                             cudaStream_t stream) {
  if (rows < 1 || G < 1 || ORP < 1) return (int)cudaErrorInvalidValue;
  e2_compact_kernel<<<(G + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      gran, gval, out, rows, G, ORP);
  return (int)cudaGetLastError();
}
