// K4: per-lane compaction of cell-packed emissions into dense bytes.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k4_compact /
// _k4_kernel (its timing-only `probes` knob is not ported).  The TPU
// kernel transposes lanes onto sublanes and resolves every output rank by a
// binary search over per-window popcount prefixes, because Mosaic has no
// scatter.  Here one thread owns one lane: it walks the lane's cells in
// order (a running prefix over the valid nibbles), packs the valid bytes
// four at a time and stores whole 32-bit words of its dense row.  Ranks at
// or past ORP are dropped (the caller checks the counts); the rest of the
// row is zeroed.
//
// What bounds it on the H100: memory traffic.  Cell reads are coalesced
// across a warp's lanes; the row writes are 4-byte stores ORP bytes apart,
// which the L2 merges into full sectors only partly.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k4_compact_kernel(
    const int32_t* __restrict__ sym, const uint8_t* __restrict__ val,
    uint8_t* __restrict__ out, int G, int cells_p, int ORP) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  uint32_t* row = reinterpret_cast<uint32_t*>(out + (size_t)g * ORP);
  const int nw = ORP / 4;
  uint32_t acc = 0;
  int fill = 0, w = 0;
  for (int c = 0; c < cells_p && w < nw; ++c) {
    const uint32_t nib = val[(size_t)c * G + g];
    if (!nib) continue;
    const uint32_t s = (uint32_t)sym[(size_t)c * G + g];
    for (int b = 0; b < CELL; ++b) {
      if (!((nib >> b) & 1)) continue;
      acc |= ((s >> (8 * b)) & 0xFFu) << (8 * fill);
      if (++fill == 4) {
        row[w++] = acc;
        acc = 0;
        fill = 0;
        if (w == nw) break;
      }
    }
  }
  if (fill) row[w++] = acc;
  for (; w < nw; ++w) row[w] = 0;
}

}  // namespace

extern "C" int ws_k4_compact(const int32_t* sym, const uint8_t* val,
                             uint8_t* out, int G, int cells_p, int ORP,
                             cudaStream_t stream) {
  if (ORP % 128) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k4_compact_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      sym, val, out, G, cells_p, ORP);
  return (int)cudaGetLastError();
}
