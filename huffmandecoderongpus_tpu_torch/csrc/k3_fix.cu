// K3': 1-bit fix scan + splice for lanes entered mid-codeword (md = 1).
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k3_fix /
// _k3_kernel.  A lane with entry ent > 0 re-decodes through the pair table
// from the root at bit ent (bits before it read a zero entry, which keeps
// the walk at the root) and its slots below cut_slot replace the main
// scan's; the cell holding cut_slot is spliced under a byte/bit mask.  No
// stream-limit mask: the splice bounds what is used.  sym/val are updated
// IN PLACE (the TPU kernel aliases them to its outputs).  As k3_fix2.cu,
// each lane stops at its first cell that keeps every slot.
//
// What bounds it on the H100: a dependent table-lookup chain per fixed lane
// (latency); most lanes merge within a few dozen bits, so the work is the
// tail of the slowest lanes.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k3_fix_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ ent, const int32_t* __restrict__ cut,
    const int32_t* __restrict__ cutsl, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int NS) {
  __shared__ uint32_t tab_s[MAX_NS * 128];
  for (int i = threadIdx.x; i < NS * 128; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int e0 = ent[g], ct = cut[g], cs = cutsl[g];
  if (ct <= 0) return;
  // the TPU kernel runs 32-bit segments while the cut reaches them
  const int nseg = min((ct + 31) / 32, steps_p / 32);
  const int ncell = nseg * (32 / CELL);
  int node = 0;
  uint32_t word = 0;
  for (int c = 0; c < ncell && c * CELL < cs; ++c) {
    if ((c & 7) == 0) {  // a new word every 8 cells of 4 bits
      const int w = c >> 3;
      word = w < steps_w ? (uint32_t)wmat[(size_t)w * G + g] : 0u;
    }
    uint32_t cacc = 0, nacc = 0;
    for (int k = 0; k < CELL; ++k) {
      const int j = c * CELL + k;
      const uint32_t e =
          j >= e0 ? pair_entry(tab_s, node, (word >> (j & 31)) & 1) : 0u;
      const Bit st = e1_fields(e, NS);
      node = st.node;
      if (st.emit) {
        cacc |= (uint32_t)st.sym << (8 * k);
        nacc |= 1u << k;
      }
    }
    const int kk = min(cs - c * CELL, CELL);  // > 0 by the loop bound
    const uint32_t vmask = (1u << kk) - 1u;
    const uint32_t smask = kk >= CELL ? 0xFFFFFFFFu : (1u << (8 * kk)) - 1u;
    const size_t o = (size_t)c * G + g;
    sym[o] = (int32_t)((cacc & smask) | ((uint32_t)sym[o] & ~smask));
    val[o] = (uint8_t)((nacc & vmask) | ((uint32_t)val[o] & ~vmask));
  }
}

}  // namespace

extern "C" int ws_k3_fix(const int32_t* wmat, const uint32_t* tab,
                         const int32_t* ent, const int32_t* cut,
                         const int32_t* cutsl, int32_t* sym, uint8_t* val,
                         int G, int steps_w, int steps_p, int NS,
                         cudaStream_t stream) {
  if (NS > MAX_NS || steps_p % 32) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k3_fix_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      wmat, tab, ent, cut, cutsl, sym, val, G, steps_w, steps_p, NS);
  return (int)cudaGetLastError();
}
