// E3: place every lane's phase-shifted granules into the payload.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_encode.py e3_place /
// _e3_kernel.  Lane g's phase-shifted granule row (shifted, G x ORP int32
// of u16 values) lands at global granule word_off[g]; only its first
// occ[g] granules carry bits (occ = ((a + L - 1) >> 4) + 1 for L > 0 code
// bits at phase a, else 0).  out (the caller zeroes it) holds the payload's
// u16 granules, one per int32.
//
// The TPU kernel ORs each lane's whole (ORPW + 1, 128) window into the
// resident output, which is race-free only because its grid runs in order.
// Here lanes run in parallel, and neighbouring lanes share granules: a
// lane's first granule may hold the end of the lane before it, its last
// the start of the lane after it, and a lane of a few bits can share one
// granule with both.  So the launch is 2-D over (granule chunk, lane); a
// thread writes one granule i < min(occ, ORP) of its lane and nothing past
// the occupancy (a stored zero there would erase a neighbour's bits).  The
// first and the last occupied granule go in with atomicOr: the lanes' bit
// ranges in a shared granule are disjoint, so the result is exact whatever
// the order.  The interior granules belong to the lane alone and are plain
// stores.  A lane whose count reached ORP is clamped to its row (its
// result is thrown away and E2 and E3 run again with a larger ORP).
//
// What bounds it on the H100: memory traffic.  Reads of a lane's row and
// writes of its granules are contiguous across a block's threads; the
// bytes moved are the occupied granules read once and written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) e3_place_kernel(
    const int32_t* __restrict__ shifted, const int32_t* __restrict__ word_off,
    const int32_t* __restrict__ occ, int32_t* __restrict__ out, int ORP,
    long long n_out) {
  const int g = blockIdx.y;
  const int n = min(occ[g], ORP);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long dst = (long long)word_off[g] + i;
  if (dst < 0 || dst >= n_out) return;
  const int32_t v = shifted[(size_t)g * ORP + i];
  if (i == 0 || i == n - 1) {
    if (v) atomicOr(out + dst, v);
  } else {
    out[dst] = v;
  }
}

}  // namespace

extern "C" int ws_e3_place(const int32_t* shifted, const int32_t* word_off,
                           const int32_t* occ, int32_t* out, int G, int ORP,
                           long long n_out, cudaStream_t stream) {
  if (G < 1 || G > 65535 || ORP < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((ORP + THREADS - 1) / THREADS, G);
  e3_place_kernel<<<grid, THREADS, 0, stream>>>(shifted, word_off, occ, out,
                                                ORP, n_out);
  return (int)cudaGetLastError();
}
