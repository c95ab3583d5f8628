// K4: per-lane compaction of cell-packed emissions into dense bytes.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k4_compact /
// _k4_kernel (its timing-only `probes` knob is not ported).  The TPU
// kernel transposes lanes onto sublanes and resolves every output rank by a
// binary search over per-window popcount prefixes, because Mosaic has no
// scatter.  Here a block owns up to 32 neighbouring lanes and all of their
// cells (widescan.cuh k4_block): its threads count the valid nibbles of
// their chunk of cells with coalesced loads, take a prefix over each lane's
// chunks, place every valid byte at its rank in the lane's row staged in
// shared memory, and write the rows out as 16-byte stores with the zero
// fill.  Ranks at or past ORP are dropped (the caller checks the counts).
// The launch plan is ops/k4_compact.py k4_plan; the launcher refuses any
// other (k4_plan_ok).
//
// What bounds it on the H100: memory traffic, sym + val read once (val
// twice, the second time from L2) and the rows written once.  The one
// thread a lane it replaces walked its cells as a chain of dependent loads
// with 2-4 warps an SM; here every thread has a chunk of independent loads.
// The one-shot kernel (oneshot.cu) runs the same body over its blocks'
// lanes.

#include "widescan.cuh"

using namespace ws;

namespace {

struct KeepAll {
  int ORP;
  __device__ __forceinline__ int operator()(int) const { return ORP; }
};

__global__ void k4_compact_kernel(const int32_t* __restrict__ sym,
                                  const uint8_t* __restrict__ val,
                                  uint8_t* __restrict__ out, int G,
                                  int cells_p, int ORP, K4Tile p) {
  extern __shared__ __align__(16) uint8_t k4_smem[];
  const int g0 = blockIdx.x * p.LB;
  k4_block<true>(sym, val, out, G, cells_p, ORP, g0, min(p.LB, G - g0), p,
                 k4_smem, KeepAll{ORP});
}

}  // namespace

extern "C" int ws_k4_compact(const int32_t* sym, const uint8_t* val,
                             uint8_t* out, int G, int cells_p, int ORP,
                             int LB, int vec, int nch, int W, int threads,
                             int shared, cudaStream_t stream) {
  const K4Tile p{LB, vec, nch, W};
  if (cells_p < 0 || !k4_plan_ok(sym, val, G, ORP, p, threads, shared) ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  k4_compact_kernel<<<(G + LB - 1) / LB, threads, shared, stream>>>(
      sym, val, out, G, cells_p, ORP, p);
  return (int)cudaGetLastError();
}
