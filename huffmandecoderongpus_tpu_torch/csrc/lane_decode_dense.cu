// Dense lane decode of the lane-DFA chain: scan and per-lane compaction.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// lane_decode_dense_pallas_tiled, two Mosaic kernels: _main_kernel_cum (the
// lane scan writing each row's symbol and the lane's running emission count
// to (steps, G) arrays) and _compact_tiled_kernel (a binary search over
// that count per output row, since Mosaic has no scatter).  Here a thread
// owns a lane and walks its B+H rows under the lane scan's rules
// (lane_scan.cu): active from its entry offset, below the stream end
// (N - g*B), up to its first emission at a row j with j + 1 >= B.  It knows
// each emission's rank, so the i-th symbol goes to dense[i, g] for i <
// out_rows, and the rows from the lane's count on are zero.  One launch;
// neither the per-row symbols nor the count array reach device memory.
// counts[g] is the lane's total emissions, not clipped to out_rows, as in
// the reference.
//
// What bounds it on the H100: each lane is a chain of dependent lookups
// over its rows, about 40 cycles a row (PERF.md), not the bytes.  The
// design is lane_scan.cu's, with the dense rows written through a window:
// - A block owns L lanes (32 where G allows), one warp: 128 blocks at
//   G = 4096.  Its bits come through the ring of staged tiles (widescan.cuh
//   BitRing) and a thread reads its next eight bits into registers; the
//   table is staged with each next state as its byte offset
//   (stage_offset_table).  Before, 128-thread blocks (32 at G = 4096)
//   loaded every row's bit from device memory on the dependent path.
// - An emission of rank n goes to a window in shared memory, W ranks of
//   the block's lanes at (n mod W, lane), 32 bytes a rank.  In a run of
//   eight rows that are all active and hold no last codeword, with room
//   for eight ranks, a row stores its symbol field at its lane's next slot
//   and moves the slot on where it emits: no test or count on the chain,
//   as lane_scan stores every row's symbol.  After each tile, the rows
//   every lane has passed (the least count of the lanes that can still
//   emit; a lane that cannot, done or past its last row, has passed every
//   row) go out whole, 4 lanes a store where G and the pointer allow:
//   the symbol below a lane's count, zero from it on.  So the rows past a
//   lane's count are written in the same stores, and no zeroing loop is
//   left.  Before, each emission and each zero was a byte store at another
//   row for every thread of a warp.
// - A lane far ahead of the block's flushed rows would reach a slot whose
//   rank is not flushed yet.  So after each tile's flush a lane writes out
//   itself, a byte at its own row each, its staged ranks below n + R - W
//   (n its count, R the rows a tile can emit): the next tile finds every
//   slot it writes free, the walk has no test of the window, and the
//   flushes skip those rows of that lane.  Only lanes more than W - R
//   ranks ahead write out; `ahead` counts their bytes (the numpy emulation
//   in tests/test_torch_dense_plan.py counts the same).
// The plan is ops/lane_decode_dense.py dense_plan: tile_plan's ring with
// the window beside it; the launcher refuses any other (bit_plan_ok).

#include <climits>

#include "widescan.cuh"

using namespace ws;

namespace {

// bytes a rank of the window takes: a byte a lane, 32 whatever the lanes
// (a power of two: a slot's address is one mask of a running offset)
constexpr int WIN_STRIDE = 32;
static_assert((OFF_EMIT >> 10) == WIN_STRIDE, "an emission moves a slot");

__global__ void __launch_bounds__(32) lane_decode_dense_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ start, uint8_t* __restrict__ dense,
    int32_t* __restrict__ counts, int* __restrict__ ahead, int G, int B,
    int rows, int N, int out_rows, int tab_words, int L, int R, int vec,
    int W, int fv) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  __shared__ int cnt_s[32], ev_s[32];
  extern __shared__ __align__(16) uint8_t smem[];
  const int g0 = blockIdx.x * L;
  const BitRing ring{smem, bits, G, g0, min(L, G - g0), L, R, rows, vec};
  uint8_t* win = smem + BIT_STAGES * R * L;  // W ranks x WIN_STRIDE
  ring.begin();
  stage_offset_table(tab_s, tab, tab_words);
  const int l = threadIdx.x, g = g0 + l;
  const bool real = l < ring.w;
  const int j0 = real ? start[g] : 0;
  const long long lim = (long long)N - (long long)g * B;
  const int jend = real ? (int)max(0LL, min(lim, (long long)rows)) : 0;
  int off = 0;     // the state's byte offset (0: the root)
  int n = 0;       // emissions so far
  int ev = 0;      // this lane's ranks below it are written out
  int stored = 0;  // symbols written out by eviction
  bool done = false;
  int base = 0;  // rows below it are flushed (the same in every thread)
  auto slot = [&](int r) -> uint8_t& {
    return win[(r & (W - 1)) * WIN_STRIDE + l];
  };

  // rows [lo, hi) of the block's lanes to dense: the staged symbol below a
  // lane's count (below its eviction frontier already written), zero from
  // the count on
  auto flush = [&](int lo, int hi) {
    cnt_s[l] = n;
    ev_s[l] = ev;
    __syncwarp();
    if (fv == 4) {  // L == 32: 8 threads a row, 4 lanes each
      const int q = (l & 7) * 4;
      for (int r = lo + (l >> 3); r < hi; r += 4) {
        uint32_t word = *reinterpret_cast<const uint32_t*>(
            win + (r & (W - 1)) * WIN_STRIDE + q);
        unsigned skip = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r >= cnt_s[q + i]) word &= ~(0xFFu << (8 * i));
          else if (r < ev_s[q + i]) skip |= 1u << i;
        }
        if (q >= ring.w) continue;
        uint8_t* to = dense + (size_t)r * G + g0 + q;
        if (!skip) {
          *reinterpret_cast<uint32_t*>(to) = word;
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!(skip >> i & 1)) to[i] = (uint8_t)(word >> (8 * i));
      }
    } else if (real) {
      for (int r = lo; r < hi; ++r) {
        uint8_t* to = dense + (size_t)r * G + g;
        if (r >= n) *to = 0;
        else if (r >= ev) *to = slot(r);
      }
    }
    __syncwarp();
  };

  const int T = ring.tiles();
  for (int t = 0; t < T; ++t) {
    const int r0 = t * R;
    ring.wait();
    __syncthreads();
    ring.issue(t + BIT_STAGES - 1);
    const int nr = min(R, rows - r0);
    if (real && !done && r0 < jend) {
      const uint8_t* col = ring.tile(t) + l;
      for (int k0 = 0; k0 < nr; k0 += 8) {  // R is a multiple of 8
        const int j = r0 + k0;
        int b4[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) b4[k] = (col[(k0 + k) * L] & 1) << 2;
        if (j >= j0 && j + 8 <= jend && j + 8 < B && !done &&
            n + 8 <= out_rows) {
          // eight active rows, none the last codeword's, every rank below
          // out_rows: a row stores its symbol field at the lane's next
          // slot and moves on a slot where it emits (a row that does not
          // emit leaves a byte the next emission overwrites, or one past
          // the lane's count, flushed as zero)
          int cur = n * WIN_STRIDE + l;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int e = offset_lookup(tab_s, off | b4[k]);
            off = e & OFF_MASK;
            win[cur & (W * WIN_STRIDE - 1)] = (uint8_t)(e >> 16);
            cur += (e & OFF_EMIT) >> 10;  // WIN_STRIDE where it emits
          }
          n = cur / WIN_STRIDE;
          continue;
        }
        // the rows of the lane's entry, end or last codeword, or its last
        // ranks before out_rows: lane_scan's tests a row
        int e[8];
        bool emit[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          e[k] = offset_lookup(tab_s, off | b4[k]);
          const bool active = j + k >= j0 && !done && j + k < jend;
          emit[k] = active && (e[k] & OFF_EMIT);
          if (active) off = e[k] & OFF_MASK;
          if (emit[k] && j + k + 1 >= B) done = true;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!emit[k]) continue;
          if (n < out_rows) slot(n) = (uint8_t)(e[k] >> 16);
          ++n;
        }
      }
    }
    // the rows every lane of the block has passed
    const bool passed = !real || done || jend <= r0 + nr;
    const int least = __reduce_min_sync(~0u, passed ? INT_MAX : n);
    const int hi = min(least, out_rows);
    flush(base, hi);
    base = hi;
    // a lane whose slots the next tile may reach before the block's rows
    // are flushed writes its ranks below n + R - W out itself (a byte a
    // rank, at its own rows)
    const int to_ev = min(n + R - W, out_rows);
    for (int r = max(ev, base); r < to_ev; ++r) {
      dense[(size_t)r * G + g] = slot(r);
      ++stored;
    }
    ev = max(ev, to_ev);
    __syncwarp();
  }
  if (T == 0) flush(0, out_rows);  // no rows: every lane's count is 0
  cp_async_wait_all();
  if (real) counts[g] = n;
  if (stored && ahead) atomicAdd(ahead, stored);
}

}  // namespace

extern "C" int ws_lane_decode_dense(const uint8_t* bits, const int32_t* tab,
                                    const int32_t* start, uint8_t* dense,
                                    int32_t* counts, int* ahead, int G,
                                    int B, int rows, int N, int out_rows,
                                    int tab_words, int L, int R, int vec,
                                    int W, int fv, int shared,
                                    cudaStream_t stream) {
  if (tab_words > LANEDFA_TAB_WORDS || rows < 0 || out_rows < 0 ||
      !bit_plan_ok(bits, G, L, R, vec, 32, shared) || W < 16 ||
      (W & (W - 1)) || 2 * R > W ||
      shared < BIT_STAGES * R * L + W * WIN_STRIDE ||
      !(fv == 1 || (fv == 4 && L == 32 && G % 4 == 0 &&
                    (uintptr_t)dense % 4 == 0)))
    return (int)cudaErrorInvalidValue;
  lane_decode_dense_kernel<<<(G + L - 1) / L, 32, shared, stream>>>(
      bits, tab, start, dense, counts, ahead, G, B, rows, N, out_rows,
      tab_words, L, R, vec, W, fv);
  return (int)cudaGetLastError();
}
