// Candidate scan of the lane-DFA chain: H chains per lane.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// candidate_scan_pallas_tiled / _candidate_kernel.  The TPU kernel carries
// all H chains of a 1024-lane tile as one (H, 8, 128) vector state and
// steps every row of the lane; here one thread owns one (chain, lane) pair
// and stops at the chain's exit or the stream end, past which the TPU
// kernel's rows change nothing.  Chain o starts at the root at row o and
// walks one bit per row through the fused table (staged in shared memory,
// at most 2048 int32); its first emission at a row j with j + 1 >= B ends
// it.
//
// What bounds it on the H100: each chain is a serial walk of up to B+H
// dependent steps, e = tab[node*2 + bit], node = e & STATE_MASK: one
// shared-memory lookup and two integer ops, about 40 cycles a row by the
// probes (PERF.md), not the bytes (one byte a row a lane).  The design
// keeps everything else off that path:
// - A block owns L lanes (32 where G allows) and all H chains of each,
//   laid out chain-major, so the 32 threads of a warp are 32 neighbouring
//   lanes of one chain; the H chains of a lane share one staged copy of its
//   bits (widescan.cuh BitRing: tiles of R rows in a ring of three, the
//   next two in flight while one is scanned).  A warp's bit reads are 32
//   neighbouring bytes of one tile row: conflict-free.  Before, every row
//   paid a device-memory load on the dependent path.
// - The table is staged with each next state as its byte offset
//   (widescan.cuh stage_offset_table), and a thread reads its next eight
//   bits into registers before it walks them: between two lookups the
//   dependent path is two LOP3s.  Tiles that lie wholly between the
//   chain's start row and row B-1 (no exit possible) take a loop with no
//   masks (on an H100, 0.19 against 0.30 ms on a kjv-sized stream;
//   PERF.md).
// - Finished chains idle; the block leaves its tile loop once no chain in
//   it has rows left (__syncthreads_or), so lanes past the stream end and
//   the rows after the exits cost no copies.
// - At G = 4096 that is 128 blocks for the 132 SMs.  Trees taller than 32
//   shrink L (ops/lanedfa.py tile_plan) so that L*H stays <= 1024 threads.
// Left out: multi-bit steps.  A table indexed by 2 or 4 bits a step would
// shorten the chain 2-4 times, but each entry must then carry several
// emissions and where within the step the exit rule fires (ROADMAP
// lever G).

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(1024) candidate_scan_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    int32_t* __restrict__ cnt, int32_t* __restrict__ ex, int G, int B, int H,
    int N, int tab_words, int L, int R, int vec) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  extern __shared__ __align__(16) uint8_t ring_s[];
  const int g0 = blockIdx.x * L;
  const BitRing ring{ring_s, bits, G, g0, min(L, G - g0), L, R, B + H, vec};
  ring.begin();
  stage_offset_table(tab_s, tab, tab_words);
  const int o = threadIdx.x / L, l = threadIdx.x - o * L, g = g0 + l;
  const bool real = l < ring.w;
  // rows at or past the stream end (N - g*B) and past B+H are inactive
  const long long lim = (long long)N - (long long)g * B;
  const int end = real ? (int)max(0LL, min(lim, (long long)(B + H))) : 0;
  // below row B-1 no emission can end the chain
  const int plain_end = min(end, B - 1);
  int off = 0, n = 0, x = 0;  // off: the state's byte offset (0: the root)
  bool live = o < end;        // the chain has rows and has not exited
  const int T = ring.tiles();
  for (int t = 0; t < T; ++t) {
    const int r0 = t * R;
    ring.wait();
    if (!__syncthreads_or(live && r0 < end)) break;
    ring.issue(t + BIT_STAGES - 1);
    if (!live || r0 >= end || r0 + R <= o) continue;
    const uint8_t* col = ring.tile(t) + l;
    if (r0 >= o && r0 + R <= plain_end) {  // the whole tile walks
      for (int k0 = 0; k0 < R; k0 += 8) {
        int b4[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) b4[k] = (col[(k0 + k) * L] & 1) << 2;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = offset_lookup(tab_s, off | b4[k]);
          off = e & OFF_MASK;
          n += (e >> 15) & 1;
        }
      }
      continue;
    }
    const int nr = min(R, end - r0);
    for (int k0 = 0; k0 < nr; k0 += 8) {  // R is a multiple of 8
      int b4[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) b4[k] = (col[(k0 + k) * L] & 1) << 2;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = r0 + k0 + k;
        const int e = offset_lookup(tab_s, off | b4[k]);
        // the root until the chain's start row; after its exit or end the
        // state is never read
        off = e & (j >= o ? OFF_MASK : 0);
        const bool emit = live && j >= o && j < end && (e & OFF_EMIT);
        n += emit;
        if (emit && j + 1 >= B) {  // the first boundary in the next lane
          x = j + 1 - B;
          live = false;
        }
      }
    }
  }
  cp_async_wait_all();
  if (real) {
    cnt[(size_t)o * G + g] = n;
    ex[(size_t)o * G + g] = x;
  }
}

}  // namespace

extern "C" int ws_candidate_scan(const uint8_t* bits, const int32_t* tab,
                                 int32_t* cnt, int32_t* ex, int G, int B,
                                 int H, int N, int tab_words, int L, int R,
                                 int vec, int shared, cudaStream_t stream) {
  const long long threads = (long long)L * H;
  if (tab_words > LANEDFA_TAB_WORDS || H < 1 || threads > 1024 ||
      !bit_plan_ok(bits, G, L, R, vec, (int)threads, shared))
    return (int)cudaErrorInvalidValue;
  candidate_scan_kernel<<<(G + L - 1) / L, (int)threads, shared, stream>>>(
      bits, tab, cnt, ex, G, B, H, N, tab_words, L, R, vec);
  return (int)cudaGetLastError();
}
