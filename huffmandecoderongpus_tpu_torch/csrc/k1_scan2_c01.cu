// K1 of the batched multi-stream decode: per-stream tables, per-lane root
// children.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py
// _k1_kernel2_c01 with k1_scan2's tab_bounds (the table BlockSpec whose
// index map picks each row group's own (2, 128) compact quad table).  Every
// stream of a batch owns whole 1024-lane ranges, so each block of 128 lanes
// lies inside one stream: the block reads its stream from bstream[block]
// and stages that stream's table (NS = 1) in shared memory.  Each lane
// reads its tree's root children C0 | C1 << 16 from c01 (the compact
// layout needs them only where a candidate chain starts mid-chunk).  The
// lane body is K1's (k1_scan2_lane, widescan.cuh), with everything else as
// in k1_scan2.cu.
//
// What bounds it on the H100: as k1_scan2.cu, a dependent lookup chain per
// lane and chain (latency); pad lanes and the common-B tails of the
// shorter streams end at their limit and only write zero cells.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k1_scan2_c01_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tabs,
    const int32_t* __restrict__ lim2, const int32_t* __restrict__ c01,
    const int32_t* __restrict__ bstream, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int32_t* __restrict__ cntmap,
    int32_t* __restrict__ exmap, int32_t* __restrict__ mrowmap, int G,
    int steps_w, int B, int H, int steps, int steps_p, int SEG, int md) {
  __shared__ uint32_t tab_s[2 * 128];
  load_table(tab_s, tabs + (size_t)bstream[blockIdx.x] * 2 * 128, 1);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const uint32_t rc = (uint32_t)c01[g];
  k1_scan2_lane(WmatWords{wmat, G, steps_w}, tab_s, lim2[g], sym, val,
                cntmap, exmap, mrowmap, G, g, B, H, steps, steps_p, SEG, md,
                (int)(rc & 0xFFFFu), (int)(rc >> 16), 1);
}

}  // namespace

extern "C" int ws_k1_scan2_c01(const int32_t* wmat, const uint32_t* tabs,
                               const int32_t* lim2, const int32_t* c01,
                               const int32_t* bstream, int32_t* sym,
                               uint8_t* val, int32_t* cntmap, int32_t* exmap,
                               int32_t* mrowmap, int G, int steps_w, int B,
                               int H, int steps, int steps_p, int SEG, int md,
                               cudaStream_t stream) {
  const int threads = 128;
  if (SEG / 2 > MAX_SEGH || md > MAX_NL || md < 2 || H - 1 > MAX_CH ||
      SEG % (md * CELL) || steps_p % SEG || G % threads)
    return (int)cudaErrorInvalidValue;
  k1_scan2_c01_kernel<<<G / threads, threads, 0, stream>>>(
      wmat, tabs, lim2, c01, bstream, sym, val, cntmap, exmap, mrowmap, G,
      steps_w, B, H, steps, steps_p, SEG, md);
  return (int)cudaGetLastError();
}
