// K3: fix scan + splice for lanes entered mid-codeword.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k3_fix2 /
// _k3_kernel2.  A lane with entry ent > 0 re-decodes from bit ent (an odd
// entry is a root step on the chunk's second bit) and its slots below
// cut_slot replace the main scan's; the cell holding cut_slot is spliced
// under a byte/bit mask.  No stream-limit mask: the splice bounds what is
// used.  sym/val are updated IN PLACE (the TPU kernel aliases them to its
// outputs).  The TPU gates per row group and segment on the largest cut;
// here each lane stops at its first cell that keeps every slot, after which
// nothing it would compute is used.
//
// The per-lane body is k3_fix2_lane (widescan.cuh); the fused one-shot
// kernel runs the same rules on its step table (oneshot.cu k3_lane).
//
// What bounds it on the H100: a dependent table-lookup chain per fixed lane
// (latency); most lanes merge within a few dozen bits, so the work is the
// tail of the slowest lanes.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k3_fix2_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ ent, const int32_t* __restrict__ cut,
    const int32_t* __restrict__ cutsl, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int SEG,
    int md, int C0, int C1, int NS) {
  __shared__ uint32_t tab_s[TAB_WORDS];
  load_table(tab_s, tab, NS);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  k3_fix2_lane(WmatWords{wmat, G, steps_w}, tab_s, ent[g], cut[g], cutsl[g],
               sym, val, G, g, steps_p, SEG, md, C0, C1, NS);
}

}  // namespace

extern "C" int ws_k3_fix2(const int32_t* wmat, const uint32_t* tab,
                          const int32_t* ent, const int32_t* cut,
                          const int32_t* cutsl, int32_t* sym, uint8_t* val,
                          int G, int steps_w, int steps_p, int SEG, int md,
                          int C0, int C1, int NS, cudaStream_t stream) {
  if (NS > MAX_NS || md < 2 || SEG % (md * CELL) || steps_p % SEG)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k3_fix2_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      wmat, tab, ent, cut, cutsl, sym, val, G, steps_w, steps_p, SEG, md, C0,
      C1, NS);
  return (int)cudaGetLastError();
}
