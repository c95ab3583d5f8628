// K2: compose per-lane exit maps into each lane's true entry offset.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k2_compose /
// _k2_kernel.  entry[0] = start, entry[l + 1] = exmap[entry[l], l]: the TPU
// kernel composes sqrt(G) x sqrt(G) with 128-wide lane gathers and
// prefix doubling over sublane rolls.  Here three launches on one stream:
//   (1) k2_groups: one thread per (group of L lanes, entry offset e < 128)
//       composes the group's map at e;
//   (2) k2_scan: one block walks the NGp <= 256 group maps, staged in
//       shared memory, for all 128 lane-0 entries at once; the thread of
//       entry `start` records each group's first-lane entry, and the final
//       states are the block's composite map `tot`;
//   (3) k2_apply: one thread per group re-walks its lanes from that entry.
// An entry offset at or past the map rows (HP) reads 0, as the TPU
// kernel's zero padding to 128 does.
//
// The steps' bodies are k2_group_map, k2_scan_block and k2_apply_group
// (widescan.cuh), which the fused one-shot kernel runs too.
//
// What bounds it on the H100: chains of dependent loads (L per thread in
// steps 1 and 3, NGp shared-memory reads in step 2); it moves a few MB at
// most and is latency-bound.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void k2_groups(const int32_t* __restrict__ exmap,
                          uint8_t* __restrict__ gmap, int G, int HP, int L,
                          int NGp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NGp * K2_NE) return;
  gmap[idx] = (uint8_t)k2_group_map(exmap, G, HP, L, idx / K2_NE,
                                    idx % K2_NE);
}

__global__ void k2_scan(const uint8_t* __restrict__ gmap,
                        int32_t* __restrict__ goff, uint8_t* __restrict__ tot,
                        int NGp, int start) {
  __shared__ uint8_t gm[K2_MAX_GROUPS * K2_NE];
  k2_scan_block(gm, gmap, goff, tot, NGp, start);
}

__global__ void k2_apply(const int32_t* __restrict__ exmap,
                         const int32_t* __restrict__ goff,
                         int32_t* __restrict__ entry, int G, int HP, int L,
                         int NGp) {
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (grp >= NGp) return;
  k2_apply_group(exmap, goff, entry, G, HP, L, grp);
}

}  // namespace

extern "C" int ws_k2_compose(const int32_t* exmap, int32_t* entry,
                             uint8_t* tot, uint8_t* gmap, int32_t* goff, int G,
                             int HP, int start, int L, int NGp,
                             cudaStream_t stream) {
  if (NGp > K2_MAX_GROUPS || NGp * L != G || HP > K2_NE || start < 0 ||
      start >= K2_NE)
    return (int)cudaErrorInvalidValue;
  k2_groups<<<(NGp * K2_NE + 255) / 256, 256, 0, stream>>>(exmap, gmap, G,
                                                            HP, L, NGp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_scan<<<1, K2_NE, 0, stream>>>(gmap, goff, tot, NGp, start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_apply<<<(NGp + 127) / 128, 128, 0, stream>>>(exmap, goff, entry, G, HP,
                                                  L, NGp);
  return (int)cudaGetLastError();
}
