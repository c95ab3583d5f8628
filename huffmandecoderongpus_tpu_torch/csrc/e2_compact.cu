// E2: per-lane compaction of E1's granule rows into dense rows.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_encode.py e2_compact /
// _e2_kernel.  Row g of out (G, ORP) int32 holds lane g's valid granules
// (gval != 0) in row order; ranks at or past ORP are dropped (the caller
// checks the counts and runs E2 again with a larger ORP) and the rest of
// the row is zero.
//
// The TPU kernel transposes the rows to (G, rows_p) and resolves every
// output rank by packed popcount prefixes and a binary search, because
// Mosaic has no scatter.  Here a block-wide compaction in K4's design
// (widescan.cuh k4_block) reads E1's (2K, G) layout as it is.  A block owns
// a tile of LB <= 32 neighbouring lanes and a range of RB rows of them,
// taken by ticket:
//
//   1. its threads count the valid flags of each (chunk, lane), a chunk
//      being a run of the block's rows, with coalesced loads (4 lanes a
//      thread where the plan allows: one 4-byte gval and one 16-byte gran
//      load a row), ROW_UNROLL rows in flight;
//   2. a warp a lane takes the prefix over the chunks: each chunk's first
//      rank in the block and the lane's count; a warp takes the lanes'
//      counts before the block from a decoupled look-back over the tile's
//      earlier row blocks (lookback.cuh), and each lane's span of its row
//      that the block writes: [min(base, ORP), min(base + count, ORP)), up
//      to ORP for the last row block, whose span takes the zeros past the
//      count;
//   3. each thread places its valid granules at their ranks in the lane's
//      span, staged in shared memory W ranks at a time (spans wider than W
//      take more rounds), dropping ranks at or past ORP;
//   4. a warp a lane writes the staged span out, 32 neighbouring words a
//      store.
//
// The row blocks of a tile write disjoint spans that cover [0, ORP).
// ops/e2_compact.py e2_plan picks LB, vec, the chunks, RB and W; the
// launcher refuses any other plan (e2_plan_ok).
//
// What bounds it on the H100: bytes, gran and gval read once (gval twice,
// the second time from L2) and the dense rows written once.  The thread a
// lane it replaces read its lane's rows in series (at most 8,192 threads)
// and wrote 4 bytes a store ORP words apart between a warp's lanes; here
// every thread has a chunk of independent loads, the grid fills the card
// at G = 512, and a warp's stores are 128 bytes of one row.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

using lookback::carry;
using lookback::take_ticket;

namespace {

constexpr int MAX_LANES = 32;
constexpr int MAX_CHUNKS = 32;
// dynamic shared bytes a block may take without opting in: 48 KB less room
// for the kernel's static words (its ticket and epoch)
constexpr int SHARED_MAX = 48 * 1024 - 256;

// The block's plan: LB lanes, vec of them a thread, nch chunks of the
// block's RB rows, S row blocks a tile, W ranks staged a lane a round.
struct E2Tile {
  int LB, vec, nch, RB, S, W;
  // shared bytes: the staged spans, then the (chunk, lane) counts, then
  // each lane's count, its count before the block and its span
  __host__ __device__ static int bytes(int LB, int nch, int W) {
    return 4 * (LB * W + nch * LB + 4 * LB);
  }
  __host__ __device__ int threads() const {
    return (LB / vec * nch + 31) / 32 * 32;
  }
};

constexpr int ROW_UNROLL = 8;    // a chunk's flag rows a thread has in flight
constexpr int PLACE_UNROLL = 4;  // and its flag and granule rows

__device__ __forceinline__ void count_rows(const uint8_t* __restrict__ gval,
                                           int G, int g, int vec, int r0,
                                           int r1, int* n) {
  for (int r = r0; r < r1; r += ROW_UNROLL) {
    uint32_t v[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const uint8_t* at = gval + (size_t)(r + u) * G + g;
      v[u] = r + u >= r1 ? 0u
             : vec == 4  ? __ldg(reinterpret_cast<const uint32_t*>(at))
                         : (uint32_t)__ldg(at);
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) n[i] += ((v[u] >> (8 * i)) & 0xFFu) != 0;
  }
}

__global__ void __launch_bounds__(1024) e2_compact_kernel(
    const int32_t* __restrict__ gran, const uint8_t* __restrict__ gval,
    int32_t* __restrict__ out, int* state, int cap, int rows, int G, int ORP,
    E2Tile p) {
  extern __shared__ __align__(16) int32_t e2_smem[];
  __shared__ int work_s;
  __shared__ unsigned epoch_s;
  int32_t* stage = e2_smem;
  int* own_s = e2_smem + p.LB * p.W;  // [nch][LB]: then chunk ranks
  int* tot_s = own_s + p.nch * p.LB;  // [LB]
  int* pre_s = tot_s + p.LB;          // [LB]
  int* lo_s = pre_s + p.LB;           // [LB]
  int* hi_s = lo_s + p.LB;            // [LB]
  const lookback::State st = lookback::state_of(state, cap);
  const int t = threadIdx.x;
  if (t == 0) take_ticket(st, gridDim.x, &work_s, &epoch_s);
  __syncthreads();
  const int work = work_s, tile = work / p.S, jb = work - tile * p.S;
  const int g0 = tile * p.LB, w = min(p.LB, G - g0);
  const int r0 = jb * p.RB, r1 = min(r0 + p.RB, rows);
  const bool last = r1 == rows;
  const int rt = p.LB / p.vec;  // threads a row
  const bool active = t < rt * p.nch;
  const int ch = t / rt, l0 = (t - ch * rt) * p.vec;
  const bool mine = active && l0 < w;  // w % vec == 0 where vec == 4
  const int per = (r1 - r0 + p.nch - 1) / p.nch;
  const int c0 = min(r0 + ch * per, r1), c1 = min(c0 + per, r1);

  // 1. valid flags of my chunk
  int own[4] = {0, 0, 0, 0};
  if (mine) count_rows(gval, G, g0 + l0, p.vec, c0, c1, own);
  if (active)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < p.vec) own_s[ch * p.LB + l0 + i] = own[i];
  __syncthreads();

  // 2. a warp a lane: each chunk's first rank in the block, the lane's
  // count; then a warp: the lanes' counts before the block, from the
  // look-back over the tile's earlier row blocks, and their spans
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  for (int l = warp; l < p.LB; l += nwarps) {
    const int x = lane < p.nch ? own_s[lane * p.LB + l] : 0;
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane < p.nch) own_s[lane * p.LB + l] = inc - x;
    if (lane == 31) tot_s[l] = inc;
  }
  __syncthreads();
  if (warp == 0) {
    const int n = lane < p.LB ? tot_s[lane] : 0;
    const int base = carry(st, tile * p.S, work, n, lane, epoch_s);
    if (lane < p.LB) {
      const bool in = lane < w;
      pre_s[lane] = base;
      lo_s[lane] = in ? min(base, ORP) : 0;
      hi_s[lane] = in ? (last ? ORP : min(base + n, ORP)) : 0;
    }
  }
  __syncthreads();
  int r[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
  if (mine)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < p.vec) {
        r[i] = own_s[ch * p.LB + l0 + i] + pre_s[l0 + i];
        lo[i] = lo_s[l0 + i];
        hi[i] = hi_s[l0 + i];
      }
  int span = 0;  // the widest span of the block's lanes
  for (int l = 0; l < w; ++l) span = max(span, hi_s[l] - lo_s[l]);

  for (int w0 = 0; w0 < span; w0 += p.W) {
    // zero the staged spans' first min(W, span - w0) ranks (16-byte
    // stores; W % 4 == 0)
    const int q = (min(p.W, span - w0) + 3) / 4;
    for (int i = t; i < p.LB * q; i += blockDim.x) {
      const int l = i / q;
      reinterpret_cast<int4*>(stage + l * p.W)[i - l * q] =
          make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    // 3. place this chunk's valid granules whose span offsets fall in
    // [w0, w0 + W), below hi
    if (mine) {
      bool any = false;  // a rank of this chunk may fall in the window
#pragma unroll
      for (int i = 0; i < 4; ++i)
        any |= i < p.vec && r[i] < min(hi[i], lo[i] + w0 + p.W) &&
               r[i] + own[i] > lo[i] + w0;
      int q[4] = {r[0], r[1], r[2], r[3]};
      const int c_end = any ? c1 : c0;
      for (int cb = c0; cb < c_end; cb += PLACE_UNROLL) {
        uint32_t v4[PLACE_UNROLL];
        int4 x4[PLACE_UNROLL];
#pragma unroll
        for (int u = 0; u < PLACE_UNROLL; ++u) {
          const size_t o = (size_t)(cb + u) * G + g0 + l0;
          const bool in = cb + u < c_end;
          if (p.vec == 4) {
            v4[u] = in ? __ldg(reinterpret_cast<const uint32_t*>(gval + o))
                       : 0u;
            x4[u] = in ? __ldg(reinterpret_cast<const int4*>(gran + o))
                       : make_int4(0, 0, 0, 0);
          } else {
            v4[u] = in ? __ldg(gval + o) : 0u;
            x4[u].x = v4[u] ? __ldg(gran + o) : 0;
          }
        }
#pragma unroll
        for (int u = 0; u < PLACE_UNROLL; ++u) {
          const int32_t x[4] = {x4[u].x, x4[u].y, x4[u].z, x4[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i >= p.vec) break;
            if (!((v4[u] >> (8 * i)) & 0xFFu)) continue;
            const int s = q[i] - lo[i] - w0;  // offset in this window
            if (s >= 0 && s < p.W && q[i] < hi[i])
              stage[(l0 + i) * p.W + s] = x[i];
            ++q[i];
          }
        }
      }
    }
    __syncthreads();
    // 4. each lane's part of the window, 32 neighbouring words a store
    for (int l = warp; l < w; l += nwarps) {
      const int n = min(p.W, hi_s[l] - lo_s[l] - w0);
      int32_t* row = out + (size_t)(g0 + l) * ORP + lo_s[l] + w0;
      for (int i = lane; i < n; i += 32) row[i] = stage[l * p.W + i];
    }
    __syncthreads();
  }
}

// The launcher's check of an E2 plan (rules in ops/e2_compact.py e2_plan),
// and a look-back state for at least its blocks.
bool e2_plan_ok(const void* gran, const void* gval, const int* state,
                int cap, int rows, int G, int ORP, E2Tile p, int threads,
                int shared, int blocks) {
  if (rows < 1 || G < 1 || ORP < 1 || p.LB < 1 || p.LB > MAX_LANES ||
      p.LB > G || (p.vec != 1 && p.vec != 4) || p.nch < 1 ||
      p.nch > MAX_CHUNKS || p.RB < 1 || p.S < 1 || p.W < 4 || p.W % 4 ||
      (uintptr_t)state % 8)
    return false;
  if (p.vec == 4 && (p.LB % 4 || G % 4 || (uintptr_t)gval % 4 ||
                     (uintptr_t)gran % 16))
    return false;
  const long long tiles = (G + p.LB - 1) / p.LB;
  return (long long)(p.S - 1) * p.RB < rows &&
         (long long)p.S * p.RB >= rows && tiles * p.S == blocks &&
         blocks <= cap && threads == p.threads() && threads <= 1024 &&
         p.W < ORP + 4 && shared == E2Tile::bytes(p.LB, p.nch, p.W) &&
         shared <= SHARED_MAX;
}

}  // namespace

extern "C" int ws_e2_compact(const int32_t* gran, const uint8_t* gval,
                             int32_t* out, int* state, int cap, int rows,
                             int G, int ORP, int LB, int vec, int nch, int RB,
                             int S, int W, int threads, int shared,
                             int blocks, cudaStream_t stream) {
  const E2Tile p{LB, vec, nch, RB, S, W};
  if (!e2_plan_ok(gran, gval, state, cap, rows, G, ORP, p, threads, shared,
                  blocks))
    return (int)cudaErrorInvalidValue;
  e2_compact_kernel<<<blocks, threads, shared, stream>>>(
      gran, gval, out, state, cap, rows, G, ORP, p);
  return (int)cudaGetLastError();
}
