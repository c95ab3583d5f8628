// Short candidate scan of the self-synchronizing lane-DFA discovery.
//
// Replaces huffmandecoderongpus_tpu/ops/lanedfa_sync.py
// _short_candidate_scan, an XLA lax.scan that carries all H chains of every
// lane as (H, G) state for W rows.  Chain o of lane g starts at the root at
// row o and walks one bit per row through the fused table for rows below W
// and the lane's stream end (N - g*B).  It stops at its first emission on a
// row where the 0-chain (the lane scanned from offset 0) also emitted: it
// has merged, and the row is recorded.  Otherwise it stops at its first
// emission at a row j with j + 1 >= B: it has exited into lane g+1 at
// offset j + 1 - B.  An emission that is both is a merge, as in the
// reference (merge_now is tested before exit_now).  cnt counts the chain's
// emissions through the one that resolved it.  Outputs a chain never set
// stay 0, as the reference's carry starts.
//
// What bounds it on the H100: each chain is a serial walk of dependent
// lookups, short where chains merge soon (latency, not bytes).  The design
// is candidate_scan.cu's:
// - A block owns L lanes (32 where G allows) and all H chains of each,
//   laid out chain-major, so a warp is 32 neighbouring lanes of one chain.
//   The lanes' bit rows and the 0-chain's emission rows come through two
//   rings of staged tiles under one plan (widescan.cuh BitRing2: R rows,
//   three stages, a tile of each in one commit group), shared by the H
//   chains of a lane.  Before, a thread a chain loaded every row's bit, and
//   every emission's valid0 byte, from device memory on its dependent path,
//   and the H chains of a lane loaded the same bytes each.
// - The table is staged with each next state as its byte offset
//   (stage_offset_table) and a thread reads its next eight bits and eight
//   valid0 bytes into registers before it walks them.  The walk of eight
//   rows keeps nothing on the dependent path but the lookups: their emit
//   bits gather into a mask, and the chain's first emission on a merge or
//   exit row is found from the masks after the eight (the state past it is
//   never read).
// - A warp leaves its tile once none of its chains has rows left
//   (__any_sync every eight rows), and the block its tile loop once none
//   of its chains has (__syncthreads_or), so the rows after the chains
//   resolve cost neither lookups nor copies.
// - Trees taller than 32 shrink L (ops/lanedfa.py tile_plan) so that L*H
//   stays <= 1024 threads.
// At W <= R (the first round's W = 128 at L = 32) the ring holds one tile.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(1024) short_candidate_scan_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const uint8_t* __restrict__ valid0, uint8_t* __restrict__ merged,
    uint8_t* __restrict__ exited, int32_t* __restrict__ mrow,
    int32_t* __restrict__ cnt, int32_t* __restrict__ ex, int G, int B, int H,
    int N, int W, int tab_words, int L, int R, int vec) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  extern __shared__ __align__(16) uint8_t smem[];
  const int g0 = blockIdx.x * L, w = min(L, G - g0);
  const BitRing2 ring{
      BitRing{smem, bits, G, g0, w, L, R, W, vec},
      BitRing{smem + BIT_STAGES * R * L, valid0, G, g0, w, L, R, W, vec}};
  ring.begin();
  stage_offset_table(tab_s, tab, tab_words);
  const int o = threadIdx.x / L, l = threadIdx.x - o * L, g = g0 + l;
  const bool real = l < w;
  // this thread's warp (the last may be partial)
  const int wb = threadIdx.x & ~31;
  const unsigned warp =
      blockDim.x - wb >= 32 ? 0xFFFFFFFFu : (1u << (blockDim.x - wb)) - 1;
  // rows at or past the stream end (N - g*B) and past W are inactive
  const long long lim = (long long)N - (long long)g * B;
  const int end = real ? (int)max(0LL, min(lim, (long long)W)) : 0;
  int off = 0, n = 0, mr = 0, x = 0;  // off: the state's byte offset
  bool is_merged = false, is_exited = false;
  bool live = o < end;  // the chain has rows and has not resolved
  const int T = ring.tiles();
  for (int t = 0; t < T; ++t) {
    const int r0 = t * R;
    ring.wait();
    if (!__syncthreads_or(live && r0 < end)) break;
    ring.issue(t + BIT_STAGES - 1);
    const uint8_t* col = ring.a.tile(t) + l;
    const uint8_t* vcol = ring.b.tile(t) + l;
    const int nr = min(R, W - r0);
    for (int k0 = 0; k0 < nr; k0 += 8) {  // R is a multiple of 16
      const int j0 = r0 + k0;
      if (!__any_sync(warp, live && j0 < end)) break;
      int b4[8], v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        b4[k] = (col[(k0 + k) * L] & 1) << 2;
        v[k] = vcol[(k0 + k) * L];
      }
      int em = 0;  // bit k: row j0 + k emitted
      if (j0 >= o) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = offset_lookup(tab_s, off | b4[k]);
          off = e & OFF_MASK;
          em |= ((e & OFF_EMIT) >> 15) << k;
        }
      } else {  // the root until the chain's start row
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = offset_lookup(tab_s, off | b4[k]);
          off = e & (j0 + k >= o ? OFF_MASK : 0);
          em |= ((e & OFF_EMIT) >> 15) << k;
        }
      }
      // the chain's rows among the eight: [o, end)
      const int lo = max(o - j0, 0), hi = min(end - j0, 8);
      em &= live && hi > lo ? (0xFF >> (8 - hi)) & (0xFF << lo) : 0;
      if (!em) continue;
      int vm = 0;  // rows where the 0-chain emitted
#pragma unroll
      for (int k = 0; k < 8; ++k) vm |= (v[k] != 0) << k;
      // rows j with j + 1 >= B, where an emission exits
      const int xs = B - 1 - j0;
      const int xm = xs <= 0 ? 0xFF : xs >= 8 ? 0 : (0xFF << xs) & 0xFF;
      const int stop = em & (vm | xm);
      if (!stop) {
        n += __popc(em);
        continue;
      }
      const int f = __ffs(stop) - 1;  // the first resolving row
      n += __popc(em & ((2 << f) - 1));
      live = false;
      if ((vm >> f) & 1) {  // on a boundary of the 0-chain: merged
        is_merged = true;
        mr = j0 + f;
      } else {  // the chain's first boundary in the next lane
        is_exited = true;
        x = j0 + f + 1 - B;
      }
    }
  }
  cp_async_wait_all();
  if (real) {
    const size_t at = (size_t)o * G + g;
    merged[at] = is_merged;
    exited[at] = is_exited;
    mrow[at] = mr;
    cnt[at] = n;
    ex[at] = x;
  }
}

}  // namespace

extern "C" int ws_short_candidate_scan(
    const uint8_t* bits, const int32_t* tab, const uint8_t* valid0,
    uint8_t* merged, uint8_t* exited, int32_t* mrow, int32_t* cnt,
    int32_t* ex, int G, int B, int H, int N, int W, int tab_words, int L,
    int R, int vec, int shared, cudaStream_t stream) {
  // vec must suit both staged matrices' pointers
  const uintptr_t ptrs = (uintptr_t)bits | (uintptr_t)valid0;
  const long long threads = (long long)L * H;
  if (tab_words > LANEDFA_TAB_WORDS || H < 1 || W < 0 || threads > 1024 ||
      !bit_plan_ok((const void*)ptrs, G, L, R, vec, (int)threads, shared) ||
      shared < 2 * BIT_STAGES * R * L)
    return (int)cudaErrorInvalidValue;
  short_candidate_scan_kernel<<<(G + L - 1) / L, (int)threads, shared,
                                stream>>>(bits, tab, valid0, merged, exited,
                                          mrow, cnt, ex, G, B, H, N, W,
                                          tab_words, L, R, vec);
  return (int)cudaGetLastError();
}
