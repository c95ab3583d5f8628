// K3 of the batched multi-stream decode: per-stream tables, per-lane root
// children.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py
// _k3_kernel2_c01 with k3_fix2's tab_bounds.  As in k1_scan2_c01.cu, each
// block lies inside one 128-lane entry of the stream map: it stages the
// step table of that stream's compact quad table (NS = 1) from
// bstream[entry], which holds its post-chunk states itself and so does not
// depend on C0/C1, and each lane takes its root children C0 | C1 << 16
// from c01 for an odd entry (a root step on the chunk's second bit).  The
// lane body is K3's (k3_fix2_lane, widescan.cuh): re-decode from the entry
// on the step table and splice the slots below the cut slot into sym/val
// IN PLACE, every cell below the cut cell stored whole.
//
// What bounds it on the H100: as k3_fix2.cu, the dependent lookup chain of
// the slowest fixed lane (latency).

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int K3_THREADS = 128;
constexpr int BLOCK = 128;  // lanes of one stream-map entry

__global__ void __launch_bounds__(K3_THREADS) k3_fix2_c01_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tabs,
    const int32_t* __restrict__ ent, const int32_t* __restrict__ cut,
    const int32_t* __restrict__ cutsl, const int32_t* __restrict__ c01,
    const int32_t* __restrict__ bstream, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int SEG,
    int md) {
  __shared__ int32_t step[128 * 4];  // step_bytes(1)
  const int g0 = blockIdx.x * K3_THREADS;
  stage_step_table(step, tabs + (size_t)bstream[g0 / BLOCK] * 2 * 128, 1, 0,
                   0);
  __syncthreads();
  const int g = g0 + threadIdx.x;
  const WmatWords words{wmat, G, steps_w};
  const int e0 = ent[g], ct = cut[g], cs = cutsl[g];
  const uint32_t rc = (uint32_t)c01[g];
  with_md(md, [&](auto m) {
    k3_fix2_lane<decltype(m)::value>(words, step, e0, ct, cs, sym, val, G,
                                     g, steps_p, SEG, (int)(rc & 0xFFFFu),
                                     (int)(rc >> 16));
  });
}

}  // namespace

extern "C" int ws_k3_fix2_c01(const int32_t* wmat, const uint32_t* tabs,
                              const int32_t* ent, const int32_t* cut,
                              const int32_t* cutsl, const int32_t* c01,
                              const int32_t* bstream, int32_t* sym,
                              uint8_t* val, int G, int steps_w, int steps_p,
                              int SEG, int md, cudaStream_t stream) {
  if (G < 1 || md < 2 || md > 8 || SEG % (md * CELL) || SEG > 32 ||
      steps_p % SEG || G % BLOCK)
    return (int)cudaErrorInvalidValue;
  k3_fix2_c01_kernel<<<G / K3_THREADS, K3_THREADS, 0, stream>>>(
      wmat, tabs, ent, cut, cutsl, c01, bstream, sym, val, G, steps_w,
      steps_p, SEG, md);
  return (int)cudaGetLastError();
}
