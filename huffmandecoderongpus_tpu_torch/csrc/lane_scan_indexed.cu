// Lane scan over index-defined lanes (the .huffidx sidecar decode).
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// lane_scan_indexed_pallas / _indexed_kernel (and computes what the XLA
// _lane_scan_indexed of ops/lanedfa.py computes).  Lane g is one index
// block: it starts at the root on a codeword boundary at row 0 and is
// active while j < lane_len[g], its exact bit length.  The TPU kernel steps
// one 1024-lane tile per grid step as an (8, 128) vector state; here one
// thread owns one lane and walks its B rows, with the fused table (at most
// 2048 int32) in shared memory, as lane_scan.cu does.  Every row is
// written: sym is the symbol field of the row's table entry, valid marks
// the active rows that emit.
//
// What bounds it on the H100: a dependent lookup chain per lane over B
// rows (latency), one thread a lane; the bit reads and the two byte stores
// per row are coalesced across a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) lane_scan_indexed_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ lane_len, uint8_t* __restrict__ sym,
    uint8_t* __restrict__ valid, int G, int B, int tab_words) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  for (int i = threadIdx.x; i < tab_words; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int len = lane_len[g];
  int node = 0;
  for (int j = 0; j < B; ++j) {
    const size_t o = (size_t)j * G + g;
    const int e = tab_s[node * 2 + bits[o]];
    const bool active = j < len;
    if (active) node = e & STATE_MASK;
    sym[o] = (uint8_t)(e >> 16);
    valid[o] = active && (e & EMIT_BIT);
  }
}

}  // namespace

extern "C" int ws_lane_scan_indexed(const uint8_t* bits, const int32_t* tab,
                                    const int32_t* lane_len, uint8_t* sym,
                                    uint8_t* valid, int G, int B,
                                    int tab_words, cudaStream_t stream) {
  if (tab_words > LANEDFA_TAB_WORDS) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  lane_scan_indexed_kernel<<<(G + threads - 1) / threads, threads, 0,
                             stream>>>(bits, tab, lane_len, sym, valid, G, B,
                                       tab_words);
  return (int)cudaGetLastError();
}
