// Per-column compaction of padded lane-DFA emissions to dense rows.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py compact_pallas /
// _compact_kernel, which finds, for every output row i of a column, the row
// of the column's (i+1)-th emission by a branchless binary search over the
// inclusive emission count `cum` (Mosaic has no scatter, and its gathers
// need operand and indices of one shape, so the search runs at the full
// (steps, 1024) shape).  Here the count itself is the emission's rank: row
// r of a column emits where cum[r] > cum[r-1] (cum[-1] = 0), its symbol to
// output row cum[r] - 1 while that is below out_rows, and rows at or past
// the column's count cum[steps-1] are zero.
//
// Contract: `cum` is cumsum(valid, 0) of a 0/1 `valid`, so it rises by 0 or
// 1 a row, and a chunk of R rows of one column emits at most R ranks, the
// ranks [base, end) from the count before the chunk to the count after it.
// (A larger step would skip ranks; such ranks are dropped, never written out
// of bounds.)
//
// A block owns a tile of W = 32 columns (an output row of the tile is one
// 32-byte sector) by a chunk of R = 1024 input rows.  Its threads read the
// chunk a batch of rows at a time, a thread VEC columns (4, as one 16-byte
// cum load and one 4-byte sym load a row, where G and the addresses allow;
// else 1, byte loads) over RS = 4 consecutive rows with the row before them,
// the next batch's loads in flight while this one is staged.  Each emission
// is staged in shared memory at (rank - the column's base, column), at most
// R x W bytes.  The block then writes the chunk's ranks out row by row over
// the union of its columns' rank ranges [min base, max end), clipped to
// out_rows: each output row one store across the tile's columns, 4 bytes a
// thread where all four columns hold that rank, masked bytes where some do
// not.  With chunks this tall the rows where every column of the tile holds
// the rank, written as whole sectors, are most of the union; only the rows
// at the chunk's ends, where the columns' ranks differ (far at the blank
// run's edges of (d)), are shared with the neighbouring chunks, a byte each.
// No two blocks write one byte: an output row's rank of a column lies in
// exactly one chunk's [base, end).
//
// The zero fill: rows [count, out_rows) of each column, with count read once
// a block.  Chunk k of a tile owns the output rows [k Z, (k+1) Z), Z =
// ceil(out_rows / chunks), and zeroes those at or past each column's count
// in coalesced row stores, so the fill is spread over the tile's chunks.
// The launch plan is ops/compact.py compact_plan; the launcher refuses any
// other (compact_plan_ok).  With `stats`, the kernel adds the blocks whose
// union is wider than 2R, the rows those unions span, those blocks' cycles
// and all blocks' cycles (clock64, block start to end, thread 0).
//
// What bounds it on the H100: bytes, cum and sym read once and the output
// written once.  The one cell a thread it replaces read cum's last row and
// cum[r-1] again in every thread, and stored each emission a byte at its
// own rank and each zero a byte.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;         // columns a tile: an output row a sector
constexpr int R = 1024;       // rows a chunk
constexpr int THREADS = 256;  // a block
constexpr int RS = 4;         // rows a row group loads a batch
constexpr int SHARED = R * W + 3 * W * 4;

template <int VEC>
struct Cols {
  int v[VEC];
};

template <int VEC>
__device__ __forceinline__ Cols<VEC> load_cum(const int32_t* __restrict__ p) {
  Cols<VEC> c;
  if constexpr (VEC == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    c.v[0] = x.x, c.v[1] = x.y, c.v[2] = x.z, c.v[3] = x.w;
  } else {
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ uint32_t load_sym(const uint8_t* __restrict__ p) {
  if constexpr (VEC == 4)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  else
    return __ldg(p);
}

// stores `word` (VEC bytes) at p where `keep` has the byte's bit
template <int VEC>
__device__ __forceinline__ void store_masked(uint8_t* p, uint32_t word,
                                             unsigned keep) {
  if (VEC == 4 && keep == 0xFu) {
    *reinterpret_cast<uint32_t*>(p) = word;
    return;
  }
#pragma unroll
  for (int b = 0; b < VEC; ++b)
    if ((keep >> b) & 1u) p[b] = (uint8_t)(word >> (8 * b));
}

// a row group's batch of rows: the row before them, and RS rows
template <int VEC>
struct Batch {
  Cols<VEC> prev, c[RS];
  uint32_t s[RS];
};

template <int VEC>
__global__ void __launch_bounds__(THREADS, 3) lanedfa_compact_kernel(
    const int32_t* __restrict__ cum, const uint8_t* __restrict__ sym,
    uint8_t* __restrict__ out, int steps, int G, int out_rows, int tiles,
    int zrows, unsigned long long* stats) {
  constexpr int TPR = W / VEC;         // threads a row
  constexpr int NRG = THREADS / TPR;   // row groups
  constexpr int ROWS = NRG * RS;       // rows a batch
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = smem;                              // R x W bytes
  int* base_s = reinterpret_cast<int*>(smem + R * W);  // W each
  int* end_s = base_s + W;
  int* count_s = end_s + W;
  __shared__ int lo_s, hi_s;
  const long long t_start = clock64();

  const int t = threadIdx.x, lt = t % TPR, rg = t / TPR;
  const int tile = blockIdx.x % tiles, chunk = blockIdx.x / tiles;
  const int g0 = tile * W, w = min(W, G - g0);
  const int r0 = chunk * R, r1 = min(r0 + R, steps);
  const int c0 = lt * VEC;
  const bool mine = c0 < w;  // w % 4 == 0 where VEC == 4
  const size_t col = (size_t)g0 + c0;

  // 1. the chunk's base (the count before it), end and the column's count
  Cols<VEC> base{};
  if (mine) {
    if (r0 > 0) base = load_cum<VEC>(cum + (size_t)(r0 - 1) * G + col);
    if (rg == 0) {
      const Cols<VEC> end =
          r1 > r0 ? load_cum<VEC>(cum + (size_t)(r1 - 1) * G + col) : base;
      const Cols<VEC> cnt =
          steps ? load_cum<VEC>(cum + (size_t)(steps - 1) * G + col)
                : Cols<VEC>{};
#pragma unroll
      for (int b = 0; b < VEC; ++b) {
        base_s[c0 + b] = base.v[b];
        end_s[c0 + b] = end.v[b];
        count_s[c0 + b] = cnt.v[b];
      }
    }
  }

  // 2. the chunk's rows a batch at a time, the next batch's loads in
  // flight while this one is staged: each emission at (rank - base, column)
  auto load = [&](Batch<VEC>& a, int b0) {
    const int ra = b0 + rg * RS;
    a.prev = Cols<VEC>{};
    if (mine && ra > 0 && ra < r1)
      a.prev = load_cum<VEC>(cum + (size_t)(ra - 1) * G + col);
#pragma unroll
    for (int k = 0; k < RS; ++k)
      if (mine && ra + k < r1) {
        const size_t o = (size_t)(ra + k) * G + col;
        a.c[k] = load_cum<VEC>(cum + o);
        a.s[k] = load_sym<VEC>(sym + o);
      }
  };
  Batch<VEC> cur, nxt;
  load(cur, r0);
  for (int b0 = r0; b0 < r1; b0 += ROWS) {
    if (b0 + ROWS < r1) load(nxt, b0 + ROWS);
    const int ra = b0 + rg * RS;
    Cols<VEC> prev = cur.prev;
#pragma unroll
    for (int k = 0; k < RS; ++k)
      if (mine && ra + k < r1) {
#pragma unroll
        for (int b = 0; b < VEC; ++b) {
          const int c = cur.c[k].v[b];
          const unsigned at = (unsigned)(c - 1 - base.v[b]);
          if (c > prev.v[b] && at < (unsigned)R)
            stage[at * W + c0 + b] = (uint8_t)(cur.s[k] >> (8 * b));
        }
        prev = cur.c[k];
      }
    cur = nxt;
  }
  __syncthreads();
  // the union of the tile's rank ranges, clipped to out_rows
  if (t < 32) {
    int lo = t < w ? base_s[t] : INT_MAX, hi = t < w ? end_s[t] : INT_MIN;
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    if (t == 0) lo_s = max(lo, 0), hi_s = min(hi, out_rows);
  }
  __syncthreads();
  const int lo = lo_s, hi = hi_s;
  int mb[VEC], me[VEC], mc[VEC], least = INT_MAX;
#pragma unroll
  for (int b = 0; b < VEC; ++b) {  // at most R ranks staged a column
    mb[b] = mine ? base_s[c0 + b] : INT_MAX;
    me[b] = mine ? min(end_s[c0 + b], mb[b] + R) : INT_MIN;
    mc[b] = mine ? count_s[c0 + b] : INT_MAX;
    least = min(least, mc[b]);
  }

  // 3. the chunk's ranks, a row group an output row: where every column of
  // the tile holds that rank (all but the chunk's first and last rows of
  // ranks), one 32-byte sector a row
  for (int o = lo + rg; o < hi; o += NRG) {
    unsigned keep = 0;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < VEC; ++b)
      if (o >= mb[b] && o < me[b]) {
        keep |= 1u << b;
        word |= (uint32_t)stage[(o - mb[b]) * W + c0 + b] << (8 * b);
      }
    if (keep) store_masked<VEC>(out + (size_t)o * G + col, word, keep);
  }

  // 4. the zero fill of this chunk's share of the output rows, from the
  // least count of my columns on
  const int z0 = chunk * zrows, z1 = min(z0 + zrows, out_rows);
  int o = z0 + rg;
  if (mine && least > o) o += (least - o + NRG - 1) / NRG * NRG;
  for (; mine && o < z1; o += NRG) {
    unsigned keep = 0;
#pragma unroll
    for (int b = 0; b < VEC; ++b)
      if (o >= mc[b]) keep |= 1u << b;
    store_masked<VEC>(out + (size_t)o * G + col, 0u, keep);
  }

  if (stats && t == 0) {
    const unsigned long long cycles = clock64() - t_start;
    if (hi - lo > 2 * R) {
      atomicAdd(stats, 1ull);
      atomicAdd(stats + 1, (unsigned long long)(hi - lo));
      atomicAdd(stats + 2, cycles);
    }
    atomicAdd(stats + 3, cycles);
  }
}

}  // namespace

extern "C" int ws_compact(const int32_t* cum, const uint8_t* sym,
                          uint8_t* out, unsigned long long* stats, int steps,
                          int G, int out_rows, int tile_cols, int chunk_rows,
                          int vec, int threads, int shared, int tiles,
                          int chunks, int zrows, cudaStream_t stream) {
  if (G < 0 || steps < 0 || out_rows < 0) return (int)cudaErrorInvalidValue;
  const int want_tiles = (G + W - 1) / W;
  const int want_chunks = max(1, (steps + R - 1) / R);
  const bool vec_ok =
      vec == 1 || (vec == 4 && G % 4 == 0 && (uintptr_t)cum % 16 == 0 &&
                   (uintptr_t)sym % 4 == 0 && (uintptr_t)out % 4 == 0);
  if (tile_cols != W || chunk_rows != R || threads != THREADS ||
      shared != SHARED || !vec_ok || tiles != want_tiles ||
      chunks != want_chunks ||
      zrows != (out_rows + want_chunks - 1) / want_chunks)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || out_rows == 0) return (int)cudaSuccess;
  const long long blocks = (long long)tiles * chunks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (vec == 4)
    lanedfa_compact_kernel<4><<<(unsigned)blocks, THREADS, SHARED, stream>>>(
        cum, sym, out, steps, G, out_rows, tiles, zrows, stats);
  else
    lanedfa_compact_kernel<1><<<(unsigned)blocks, THREADS, SHARED, stream>>>(
        cum, sym, out, steps, G, out_rows, tiles, zrows, stats);
  return (int)cudaGetLastError();
}
