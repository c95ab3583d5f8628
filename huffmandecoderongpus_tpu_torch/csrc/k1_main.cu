// K1 without discovery: the chunked main scan of the indexed decode.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan2 /
// _k1_kernel2 with discover=False (md >= 2).  Every lane is one .huffidx
// block, starting at the DFA root on a codeword boundary, so only the main
// chain runs: no candidate chains, no maps, no exit.  The TPU kernel walks
// SEG-bit segments as a sequential grid dimension, SEG = lcm(4*md, 32) (96
// for md 3 and 6, 160 for md 5, 224 for md 7), carrying the lane state in
// scratch.  Here one thread owns one lane and walks it by the segments of
// the team body (widescan.cuh Seg<MD>: 32 bits for md 2, 4 and 8, 24 for 3
// and 6, 20 for 5, 28 for 7), which divide the indexed SEG, so no lane ends
// in part of a segment of its own.  The walk is k1_team's "main chains go on
// alone" loop without the team: the step table in shared memory (state as
// a byte offset: lookup, one LOP3, lookup; C0/C1 baked into the wide
// layout's entries), main_fast for a segment wholly below the lane's limit,
// team_walk's main-chain body for the segment that holds it (a chunk at or
// past the limit reads entry 0: no emission, the root as its state), and
// zero cells past it; each segment's bits loaded a segment ahead
// (segment_bits on the word matrix, which has no halo rows: words past it
// read 0).  The body is templated on md (with_md).  The main chain's exit
// row is set past every row (NO_EXIT), so no emission is ever cut.
//
// The plan (ops/k1_main.py k1_main_plan) gives a block 128 threads: on an
// H100 that beat or tied 64 and 32, within 8 % (PERF.md), though they
// spread the indexed (a)'s lanes over all 132 SMs where 128 fill 88: their
// blocks stage the step table with fewer threads.  The launcher refuses
// any other plan (k1_main_plan_ok).  The step table takes at most 16 KB
// (NS 8), under the 48 KB a block has without opting in.
//
// What bounds it on the H100: each lane's chain of dependent step-table
// lookups, one a 2-bit chunk (the chain floor: the longest lane's chunks x
// about 40 cycles).  Word reads (lane-minor rows, a segment ahead) and cell
// writes are coalesced across a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

// an exit row no lane reaches: the indexed lanes have none
constexpr int NO_EXIT = 1 << 30;

template <int MD>
__device__ __forceinline__ void k1_main_lane(const K1Args& a,
                                             const WmatWords& words, int lim,
                                             const int32_t* step, int g) {
  using SG = Seg<MD>;
  const int S = a.steps_p / SG::SEG;
  Chain m{0, 0, 0, 0};
  uint32_t next = segment_bits(words, 0, S, SG::SEG, g);
  for (int seg = 0; seg < S; ++seg) {
    const uint32_t bits = next;
    const int base = seg * SG::SEG;
    if (lim <= base) {  // the block ended before this segment
      zero_cells(a, seg, SG::CELLS, g);
      continue;
    }
    next = segment_bits(words, seg + 1, S, SG::SEG, g);
    if (base + SG::SEG <= lim)
      main_fast<MD>(m, bits, step, a, seg * SG::CELLS, g);
    else
      team_walk<MD, true>(m, 0, true, false, 0, 0, base, bits, lim, step, a,
                          nullptr, nullptr, 0, seg * SG::CELLS, g);
  }
}

__global__ void __launch_bounds__(128) k1_main_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, K1Args a, int steps_w, int md,
    int NS) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* step = reinterpret_cast<int32_t*>(smem);
  stage_step_table(step, tab, NS, a.C0, a.C1);
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.G) return;
  const WmatWords words{wmat, a.G, steps_w};
  const int lim = lim2[g];
  with_md(md, [&](auto m) {
    k1_main_lane<decltype(m)::value>(a, words, lim, step, g);
  });
}

// The launcher's check of a plan (rules in ops/k1_main.py k1_main_plan).
bool k1_main_plan_ok(int G, int md, int NS, int threads, int shared) {
  return G >= 1 && md >= 2 && md <= 8 && NS >= 1 && NS <= MAX_NS &&
         threads == 128 && shared == step_bytes(NS);
}

}  // namespace

extern "C" int ws_k1_main(const int32_t* wmat, const uint32_t* tab,
                          const int32_t* lim2, int32_t* sym, uint8_t* val,
                          int G, int steps_w, int steps_p, int md, int C0,
                          int C1, int NS, int threads, int shared,
                          cudaStream_t stream) {
  if (!k1_main_plan_ok(G, md, NS, threads, shared) ||
      steps_p % seg_bits(md) || steps_w * 32 < steps_p)
    return (int)cudaErrorInvalidValue;
  const K1Args a{sym, val, nullptr, nullptr, nullptr, G, NO_EXIT, steps_p,
                 steps_p, C0, C1};
  k1_main_kernel<<<(G + threads - 1) / threads, threads, shared, stream>>>(
      wmat, tab, lim2, a, steps_w, md, NS);
  return (int)cudaGetLastError();
}
