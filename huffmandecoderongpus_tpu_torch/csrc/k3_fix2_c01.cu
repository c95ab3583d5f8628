// K3 of the batched multi-stream decode: per-stream tables, per-lane root
// children.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py
// _k3_kernel2_c01 with k3_fix2's tab_bounds.  As in k1_scan2_c01.cu, each
// block of 128 lanes lies inside one stream: it stages that stream's
// compact quad table (NS = 1) from bstream[block], and each lane takes its
// root children C0 | C1 << 16 from c01 for an odd entry (a root step on
// the chunk's second bit).  The lane body is K3's (k3_fix2_lane,
// widescan.cuh): re-decode from the entry and splice the slots below the
// cut slot into sym/val IN PLACE.
//
// What bounds it on the H100: as k3_fix2.cu, the dependent lookup chain of
// the slowest fixed lane (latency).

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k3_fix2_c01_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tabs,
    const int32_t* __restrict__ ent, const int32_t* __restrict__ cut,
    const int32_t* __restrict__ cutsl, const int32_t* __restrict__ c01,
    const int32_t* __restrict__ bstream, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int SEG,
    int md) {
  __shared__ uint32_t tab_s[2 * 128];
  load_table(tab_s, tabs + (size_t)bstream[blockIdx.x] * 2 * 128, 1);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const uint32_t rc = (uint32_t)c01[g];
  k3_fix2_lane(WmatWords{wmat, G, steps_w}, tab_s, ent[g], cut[g], cutsl[g],
               sym, val, G, g, steps_p, SEG, md, (int)(rc & 0xFFFFu),
               (int)(rc >> 16), 1);
}

}  // namespace

extern "C" int ws_k3_fix2_c01(const int32_t* wmat, const uint32_t* tabs,
                              const int32_t* ent, const int32_t* cut,
                              const int32_t* cutsl, const int32_t* c01,
                              const int32_t* bstream, int32_t* sym,
                              uint8_t* val, int G, int steps_w, int steps_p,
                              int SEG, int md, cudaStream_t stream) {
  const int threads = 128;
  if (md < 2 || SEG % (md * CELL) || steps_p % SEG || G % threads)
    return (int)cudaErrorInvalidValue;
  k3_fix2_c01_kernel<<<G / threads, threads, 0, stream>>>(
      wmat, tabs, ent, cut, cutsl, c01, bstream, sym, val, G, steps_w,
      steps_p, SEG, md);
  return (int)cudaGetLastError();
}
