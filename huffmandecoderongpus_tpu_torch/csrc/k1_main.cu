// K1 without discovery: the chunked main scan of the indexed decode.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan2 /
// _k1_kernel2 with discover=False (md >= 2).  Every lane is one .huffidx
// block, starting at the DFA root on a codeword boundary, so only the main
// chain runs: no candidate chains, no maps, no exit.  The TPU kernel walks
// SEG-bit segments as a sequential grid dimension, SEG = lcm(4*md, 32) (96
// for md 3 and 6, 160 for md 5, 224 for md 7), carrying the lane state in
// scratch; here one thread owns one lane and walks it one cell (4*md bits,
// 2*md chunks) at a time, so the segment length does not appear at all and
// K1's SEG <= 32 bound (k1_scan2.cu) does not apply.  A chunk at or past
// the lane's limit reads entry 0: no emission, the root as its state.  A
// lane stops walking at its limit and zeroes the rest of its cells.
//
// What bounds it on the H100: a dependent chain of shared-memory table
// lookups per lane (latency): steps_p / 2 chunk steps for the longest
// block, one thread a lane, G / 128 blocks of 128 threads.  Word reads
// (lane-minor rows) and cell writes are coalesced across a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k1_main_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int md,
    int C0, int C1, int NS) {
  __shared__ uint32_t tab_s[TAB_WORDS];
  load_table(tab_s, tab, NS);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const WmatWords words{wmat, G, steps_w};
  const int lim = lim2[g];
  const int cells_p = steps_p / (md * CELL);
  int node = 0, wcur = -1;
  uint32_t word = 0;
  for (int c = 0; c < cells_p; ++c) {
    const int base = c * CELL * md;
    uint32_t cacc = 0, nacc = 0;
    if (base < lim) {
      for (int k = 0; k < 2 * md; ++k) {
        const int jbit = base + 2 * k;
        if ((jbit >> 5) != wcur) {
          wcur = jbit >> 5;
          word = words(wcur, g);
        }
        const int b0 = (word >> (jbit & 31)) & 1;
        const int b1 = (word >> ((jbit & 31) + 1)) & 1;
        const uint32_t e =
            jbit < lim ? quad_entry(tab_s, NS, node, b0, b1) : 0u;
        const Step st = decode_entry(e, NS, b1 ? C1 : C0);
        node = st.node;
        if (st.emit) {  // slot (jbit + pos) / md, counted from the cell start
          const int sl = (2 * k + st.pos) / md;
          cacc |= (uint32_t)st.sym << (8 * sl);
          nacc |= 1u << sl;
        }
      }
    }
    sym[(size_t)c * G + g] = (int32_t)cacc;
    val[(size_t)c * G + g] = (uint8_t)nacc;
  }
}

}  // namespace

extern "C" int ws_k1_main(const int32_t* wmat, const uint32_t* tab,
                          const int32_t* lim2, int32_t* sym, uint8_t* val,
                          int G, int steps_w, int steps_p, int md, int C0,
                          int C1, int NS, cudaStream_t stream) {
  if (md < 2 || NS > MAX_NS || steps_p % (md * CELL) ||
      steps_w * 32 < steps_p)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k1_main_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      wmat, tab, lim2, sym, val, G, steps_w, steps_p, md, C0, C1, NS);
  return (int)cudaGetLastError();
}
