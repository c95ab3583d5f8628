// Dense lane decode of the lane-DFA chain: scan and per-lane compaction.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// lane_decode_dense_pallas_tiled, two Mosaic kernels: _main_kernel_cum (the
// lane scan writing each row's symbol and the lane's running emission count
// to (steps, G) arrays) and _compact_tiled_kernel (a binary search over
// that count per output row, since Mosaic has no scatter).  Here one thread
// owns one lane and walks its B+H rows under the lane scan's rules
// (lane_scan.cu); it knows each emission's rank, so it writes the symbol
// straight to dense[rank, g] while rank < out_rows, then zeroes the lane's
// rows from its count on.  One launch, and neither the per-row symbols nor
// the count array reach device memory.  counts[g] is the lane's total
// emissions, not clipped to out_rows, as in the reference.
//
// What bounds it on the H100: a dependent lookup chain per lane over B+H
// rows (latency), with G lanes of threads; the bit reads are coalesced
// across the lanes of a warp, the dense writes are not (lanes of a warp
// sit at different ranks).

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) lane_decode_dense_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ start, uint8_t* __restrict__ dense,
    int32_t* __restrict__ counts, int G, int B, int H, int N, int out_rows,
    int tab_words) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  for (int i = threadIdx.x; i < tab_words; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  // rows at or past the stream end (N - g*B) are inactive
  const long long lim = (long long)N - (long long)g * B;
  const int end = (int)max(0LL, min(lim, (long long)(B + H)));
  int node = 0, n = 0;
  for (int j = max(start[g], 0); j < end; ++j) {
    const int e = tab_s[node * 2 + bits[(size_t)j * G + g]];
    node = e & STATE_MASK;
    if (e & EMIT_BIT) {
      if (n < out_rows) dense[(size_t)n * G + g] = (uint8_t)(e >> 16);
      ++n;
      if (j + 1 >= B) break;  // the lane's last codeword
    }
  }
  for (int r = n; r < out_rows; ++r) dense[(size_t)r * G + g] = 0;
  counts[g] = n;
}

}  // namespace

extern "C" int ws_lane_decode_dense(const uint8_t* bits, const int32_t* tab,
                                    const int32_t* start, uint8_t* dense,
                                    int32_t* counts, int G, int B, int H,
                                    int N, int out_rows, int tab_words,
                                    cudaStream_t stream) {
  if (tab_words > LANEDFA_TAB_WORDS) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  lane_decode_dense_kernel<<<(G + threads - 1) / threads, threads, 0,
                             stream>>>(bits, tab, start, dense, counts, G, B,
                                       H, N, out_rows, tab_words);
  return (int)cudaGetLastError();
}
