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
  const int e0 = ent[g], ct = cut[g], cs = cutsl[g];
  if (ct <= 0) return;
  // the TPU kernel runs segments while the cut reaches them
  const int S = steps_p / SEG;
  const int nseg = min((ct + SEG - 1) / SEG, S);
  const int ncell = nseg * (SEG / (md * CELL));
  int node = 0;
  int wcur = -1;
  uint32_t word = 0;
  for (int c = 0; c < ncell && c * CELL < cs; ++c) {
    uint32_t cacc = 0, nacc = 0;
    for (int k = 0; k < 2 * md; ++k) {
      const int jbit = c * CELL * md + 2 * k;
      if ((jbit >> 5) != wcur) {
        wcur = jbit >> 5;
        word = wcur < steps_w ? (uint32_t)wmat[(size_t)wcur * G + g] : 0u;
      }
      const int b0 = (word >> (jbit & 31)) & 1;
      const int b1 = (word >> ((jbit & 31) + 1)) & 1;
      const int rc = b1 ? C1 : C0;
      const bool started = jbit >= e0;
      const uint32_t e = started ? quad_entry(tab_s, NS, node, b0, b1) : 0u;
      const Step st = decode_entry(e, NS, rc);
      if (started) node = st.node;
      if (e0 == jbit + 1) node = rc;
      if (st.emit) {
        const int sl = (2 * k + st.pos) / md;
        cacc |= (uint32_t)st.sym << (8 * sl);
        nacc |= 1u << sl;
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
