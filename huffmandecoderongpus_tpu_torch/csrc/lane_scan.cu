// Lane scan of the lane-DFA chain: each lane from its true entry offset.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// lane_scan_pallas_tiled / _main_kernel.  The TPU kernel steps one
// 1024-lane tile per grid step as an (8, 128) vector state; here one thread
// owns one lane and walks its rows (B+H, or the first `rows` of them: the
// fix scan of the self-synchronizing discovery, lanedfa_sync.py _fix_scan),
// staging the fused table (at most 2048 int32) in shared memory.  A row is active from the lane's entry
// offset while it is below the stream end (N - g*B) and the lane has not
// finished (its first emission at a row j with j + 1 >= B is its last).
// Every row is written: sym is the symbol field of the row's table entry
// (what the TPU kernel stores), valid marks the active rows that emit.
//
// What bounds it on the H100: a dependent lookup chain per lane over B+H
// rows (latency), with G lanes of threads; the bit reads and the two byte
// stores per row are coalesced across the lanes of a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) lane_scan_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ start, uint8_t* __restrict__ sym,
    uint8_t* __restrict__ valid, int G, int B, int rows, int N,
    int tab_words) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  for (int i = threadIdx.x; i < tab_words; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int j0 = start[g];
  const long long lim = (long long)N - (long long)g * B;
  int node = 0;
  bool done = false;
  for (int j = 0; j < rows; ++j) {
    const size_t o = (size_t)j * G + g;
    const int e = tab_s[node * 2 + bits[o]];
    const bool active = j >= j0 && !done && j < lim;
    const bool emit = active && (e & EMIT_BIT);
    if (active) node = e & STATE_MASK;
    if (emit && j + 1 >= B) done = true;
    sym[o] = (uint8_t)(e >> 16);
    valid[o] = emit;
  }
}

}  // namespace

extern "C" int ws_lane_scan(const uint8_t* bits, const int32_t* tab,
                            const int32_t* start, uint8_t* sym,
                            uint8_t* valid, int G, int B, int rows, int N,
                            int tab_words, cudaStream_t stream) {
  if (tab_words > LANEDFA_TAB_WORDS) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  lane_scan_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      bits, tab, start, sym, valid, G, B, rows, N, tab_words);
  return (int)cudaGetLastError();
}
