// K3': 1-bit fix scan + splice for lanes entered mid-codeword (md = 1).
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k3_fix /
// _k3_kernel.  A lane with entry ent > 0 re-decodes from the root at bit
// ent (bits before it read entry 0, which keeps the walk at the root) and
// its slots below cut_slot replace the main scan's, the cell holding
// cut_slot under a byte/bit mask.  No stream-limit mask: the splice bounds
// what is used.  sym/val are updated IN PLACE (the TPU kernel aliases them
// to its outputs).  As k3_fix2.cu, each lane stops at its first cell that
// keeps every slot.
//
// A thread a lane, walking the 1-bit step table (widescan.cuh
// stage_step_table1) staged in shared memory at launch: a bit is lookup,
// one LOP3, lookup.  Every cell below the one that holds cut_slot is
// stored whole, without reading the old cell, so that only that one cell
// is read, modified and written; the lane's words are loaded a word ahead
// of the walk.
//
// What bounds it on the H100: a dependent lookup chain a fixed lane
// (latency); most lanes merge within a few dozen bits, so the time is the
// longest cut's chain, about 40 cycles a bit.

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int K3_THREADS = 128;

__global__ void __launch_bounds__(K3_THREADS) k3_fix_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ ent, const int32_t* __restrict__ cut,
    const int32_t* __restrict__ cutsl, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int G, int steps_w, int steps_p, int NS) {
  __shared__ int32_t step[MAX_NS * 256];
  stage_step_table1(step, tab, NS);
  __syncthreads();
  const int g = blockIdx.x * K3_THREADS + threadIdx.x;
  if (g >= G) return;
  const int e0 = ent[g], ct = cut[g], cs = cutsl[g];
  if (ct <= 0) return;
  // the TPU kernel runs 32-bit segments while the cut reaches them; a cell
  // c is fixed while it holds a slot below cs
  const int nseg = min((ct + 31) / 32, steps_p / 32);
  const int ncell = min(nseg * (32 / CELL), (cs + CELL - 1) / CELL);
  const WmatWords words{wmat, G, steps_w};
  int node = 0;
  uint32_t ahead = words(0, g);
  for (int w = 0; w * 8 < ncell; ++w) {  // a word: 8 cells of 4 bits
    const uint32_t word = ahead;
    ahead = words(w + 1, g);
    const bool pre = w * 32 < e0;  // bits before the entry read entry 0
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = w * 8 + q;
      if (c >= ncell) break;
      uint32_t cacc = 0, nacc = 0;
#pragma unroll
      for (int k = 0; k < CELL; ++k) {
        const int b = q * CELL + k;
        uint32_t e =
            (uint32_t)step_at(step, node | (((word >> b) & 1) << 2));
        if (pre && w * 32 + b < e0) e = 0u;
        node = (int)e & STEP1_NODE;
        cacc |= (e >> 16) << (8 * k);
        nacc |= ((e >> 15) & 1u) << k;
      }
      const size_t o = (size_t)c * G + g;
      const int kk = cs - c * CELL;  // > 0 by the loop bound
      if (kk >= CELL) {  // every slot of the cell is the fix scan's
        sym[o] = (int32_t)cacc;
        val[o] = (uint8_t)nacc;
      } else {  // the cell holding cut_slot: its slots from kk on stay
        const uint32_t vmask = (1u << kk) - 1u;
        const uint32_t smask = (1u << (8 * kk)) - 1u;
        sym[o] = (int32_t)((cacc & smask) | ((uint32_t)sym[o] & ~smask));
        val[o] = (uint8_t)((nacc & vmask) | ((uint32_t)val[o] & ~vmask));
      }
    }
  }
}

}  // namespace

extern "C" int ws_k3_fix(const int32_t* wmat, const uint32_t* tab,
                         const int32_t* ent, const int32_t* cut,
                         const int32_t* cutsl, int32_t* sym, uint8_t* val,
                         int G, int steps_w, int steps_p, int NS,
                         cudaStream_t stream) {
  if (G < 1 || NS < 1 || NS > MAX_NS || steps_p % 32 || steps_w < 1 ||
      steps_w * 32 < steps_p)
    return (int)cudaErrorInvalidValue;
  k3_fix_kernel<<<(G + K3_THREADS - 1) / K3_THREADS, K3_THREADS, 0,
                  stream>>>(wmat, tab, ent, cut, cutsl, sym, val, G, steps_w,
                            steps_p, NS);
  return (int)cudaGetLastError();
}
