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
// A thread a lane (the fix chain is serial from the entry, and K3 has no
// candidate chains to split over a team), walking the step table
// (widescan.cuh stage_step_table, C0/C1 in its wide entries) staged in
// shared memory at launch: a 2-bit chunk is lookup, one LOP3, lookup.  The
// per-lane body is k3_fix2_lane (widescan.cuh), templated on md (with_md):
// a cell's chunks unroll, the lane's words come a word ahead of the walk,
// and every cell below the one that holds cut_slot is stored whole without
// reading it.  The fused one-shot kernel runs the same rules (oneshot.cu
// k3_lane).
//
// What bounds it on the H100: a dependent lookup chain a fixed lane
// (latency); most lanes merge within a few dozen bits, so the time is the
// longest cut's chain, about 40 cycles a 2-bit chunk.

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int K3_THREADS = 128;

__global__ void __launch_bounds__(K3_THREADS) k3_fix2_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ ent, const int32_t* __restrict__ cut,
    const int32_t* __restrict__ cutsl, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int SEG,
    int md, int C0, int C1, int NS) {
  __shared__ int32_t step[MAX_NS * 128 * 4];  // 16 KB at NS 8
  stage_step_table(step, tab, NS, C0, C1);
  __syncthreads();
  const int g = blockIdx.x * K3_THREADS + threadIdx.x;
  if (g >= G) return;
  const WmatWords words{wmat, G, steps_w};
  const int e0 = ent[g], ct = cut[g], cs = cutsl[g];
  with_md(md, [&](auto m) {
    k3_fix2_lane<decltype(m)::value>(words, step, e0, ct, cs, sym, val, G,
                                     g, steps_p, SEG, C0, C1);
  });
}

}  // namespace

extern "C" int ws_k3_fix2(const int32_t* wmat, const uint32_t* tab,
                          const int32_t* ent, const int32_t* cut,
                          const int32_t* cutsl, int32_t* sym, uint8_t* val,
                          int G, int steps_w, int steps_p, int SEG, int md,
                          int C0, int C1, int NS, cudaStream_t stream) {
  if (G < 1 || NS < 1 || NS > MAX_NS || md < 2 || md > 8 ||
      SEG % (md * CELL) || SEG > 32 || steps_p % SEG)
    return (int)cudaErrorInvalidValue;
  k3_fix2_kernel<<<(G + K3_THREADS - 1) / K3_THREADS, K3_THREADS, 0,
                   stream>>>(wmat, tab, ent, cut, cutsl, sym, val, G, steps_w,
                             steps_p, SEG, md, C0, C1, NS);
  return (int)cudaGetLastError();
}
