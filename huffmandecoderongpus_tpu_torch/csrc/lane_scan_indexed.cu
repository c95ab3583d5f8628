// Lane scan over index-defined lanes (the .huffidx sidecar decode).
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// lane_scan_indexed_pallas / _indexed_kernel (and computes what the XLA
// _lane_scan_indexed of ops/lanedfa.py computes).  Lane g is one index
// block: it starts at the root on a codeword boundary at row 0 and is
// active while j < lane_len[g], its exact bit length.  The TPU kernel steps
// one 1024-lane tile per grid step as an (8, 128) vector state; here one
// thread owns one lane and walks its B rows.  Every row is written: sym is
// the symbol field of the row's table entry (past the lane's length, the
// entry read from the state the lane ended in), valid marks the active rows
// that emit.
//
// What bounds it on the H100: each lane is a chain of dependent lookups
// over its active rows (latency), and the three bytes a row a lane it
// reads and writes.  The design is lane_scan.cu's ring of staged tiles,
// with these changes:
// - A block owns L lanes (32 where G allows): one warp walks them, three
//   more copy.  The copy warps stage the lanes' bit rows in a ring of three
//   tiles of R rows (cp.async of 16 or 4 bytes; the next two tiles in
//   flight) and write the walked tile's sym and valid out of two
//   alternating output tiles (16-byte stores where G and the pointers
//   allow).  The walking warp reads its next eight bits into registers
//   and touches shared memory only.  Before, a thread a lane loaded every
//   row's bit from device memory on the dependent path and stored two
//   bytes a row to device memory.
// - Where G or an address allows only byte copies (lane_dfa's geometry
//   has a lane an index block, so G is any count), each copy thread keeps
//   eight byte loads in flight.  A warp that copied its own tiles a byte
//   at a time, or loaded and stored its own rows' bytes in device memory,
//   lost more to those copies than the walk costs (PERF.md).
// - A lane's active rows are known at launch (0 .. len - 1; no entry
//   offset, no exit rule), so its chain needs no test a row: it walks
//   them two bits a lookup on the 2-bit step table (widescan.cuh
//   stage_step_table2, built in shared memory from the staged 1-bit
//   table at launch), halving the chain.  The group of eight rows that
//   holds the lane's end takes one bit a step on the 1-bit table
//   (stage_offset_table), and the rows after it are lookups from the
//   state the lane ended in, independent of each other.
// The plan is ops/lanedfa.py indexed_plan: tile_plan's for lane_scan with
// the 2-bit table's bytes beside the tiles, INDEXED_THREADS a block; the
// launcher refuses any other (bit_plan_ok).

#include "widescan.cuh"

using namespace ws;

namespace {

// The block: one warp that walks L lanes, and COPY_WARPS warps that stage
// its bit tiles and write its output tiles out (ops/lanedfa.py
// INDEXED_THREADS).
constexpr int COPY_WARPS = 3;
constexpr int INDEXED_THREADS = 32 * (1 + COPY_WARPS);

// Copy thread h of nh: chunk c of a tile row, rows p, p + np, ...: the rows'
// `chunks` chunks spread over every copy thread, set once a block.
struct Copier {
  int h, nh, c, p, np;
  __device__ __forceinline__ Copier(int h_, int nh_, int chunks)
      : h(h_), nh(nh_), c(h_ % chunks), p(h_ / chunks), np(nh_ / chunks) {}
};

// `n` items from item i = q.h on in steps of q.nh, eight loads in flight:
// get(i) loads item i, put(i, v) stores it (byte copies: a copy of one
// load and one store would wait out each load in turn).
template <class Get, class Put>
__device__ __forceinline__ void copy8(int first, int n, int step, Get get,
                                      Put put) {
  for (int i0 = first; i0 < n; i0 += 8 * step) {
    uint8_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * step;
      v[k] = i < n ? get(i) : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * step;
      if (i < n) put(i, v[k]);
    }
  }
}

// Rows [r0, r0 + nr) of lanes [g0, g0 + w) of the bit matrix into `tile`
// (row stride L) by the copy threads: cp.async chunks of `vec` bytes
// (committed by the caller), or bytes eight a thread in flight; where one
// block holds every lane (L == G) the rows are one run of bytes.
__device__ __forceinline__ void copy_in(const Copier& q, uint8_t* tile,
                                        const uint8_t* bits, int G, int g0,
                                        int w, int L, int r0, int nr,
                                        int vec) {
  const uint8_t* src = bits + (size_t)r0 * G + g0;
  if (L == G) {
    const int n = nr * G, body = vec > 1 ? n - n % vec : 0;
    for (int i = q.h * vec; i < body; i += q.nh * vec)
      StageBytes()(tile + i, src + i, vec);
    copy8(body + q.h, n, q.nh, [&](int i) { return __ldg(src + i); },
          [&](int i, uint8_t v) { tile[i] = v; });
    return;
  }
  if (q.p >= q.np) return;
  const int c = q.c * vec;
  if (vec > 1) {
    for (int r = q.p; r < nr; r += q.np)
      StageBytes()(tile + r * L + c, src + (size_t)r * G + c, vec);
    return;
  }
  copy8(q.p, nr, q.np, [&](int r) { return __ldg(src + (size_t)r * G + c); },
        [&](int r, uint8_t v) { tile[r * L + c] = v; });
}

// Rows [r0, r0 + nr) of the staged sym and valid tiles (src, then src +
// R*L) to lanes [g0, g0 + w) of the (B, G) outputs by the copy threads,
// in the layout and widths of copy_in.
__device__ __forceinline__ void copy_out(const Copier& q, const uint8_t* src,
                                         uint8_t* sym, uint8_t* valid, int G,
                                         int g0, int w, int L, int R, int r0,
                                         int nr, int vec) {
  for (int which = 0; which < 2; ++which) {
    const uint8_t* s = src + which * R * L;
    uint8_t* d = (which ? valid : sym) + (size_t)r0 * G + g0;
    if (L == G) {
      const int n = nr * G, body = vec > 1 ? n - n % vec : 0;
      for (int i = q.h * vec; i < body; i += q.nh * vec)
        StoreBytes()(d + i, s + i, vec);
      copy8(body + q.h, n, q.nh, [&](int i) { return s[i]; },
            [&](int i, uint8_t v) { d[i] = v; });
      continue;
    }
    if (q.p >= q.np) continue;
    const int c = q.c * vec;
    if (vec > 1) {
      for (int r = q.p; r < nr; r += q.np)
        StoreBytes()(d + (size_t)r * G + c, s + r * L + c, vec);
      continue;
    }
    copy8(q.p, nr, q.np, [&](int r) { return s[r * L + c]; },
          [&](int r, uint8_t v) { d[(size_t)r * G + c] = v; });
  }
}

// Eight rows of one lane from row j0: its bits b, its chain state `off` (the
// state's byte offset in the 2-bit table), its length `len`; put(k, sym,
// valid) stores row j0 + k.  Four 2-bit steps where all eight rows are
// active, lookups from the state the lane ended in where none is, and one
// bit a step in the group that holds the lane's end.
template <class Put>
__device__ __forceinline__ void walk8(const int32_t* step_s,
                                      const int32_t* tab_s, const int* b,
                                      int j0, int len, int& off, Put put) {
  if (j0 + 8 <= len) {
#pragma unroll
    for (int m = 0; m < 8; m += 2) {
      const int e = step_at(step_s, off | b[m] << 3 | b[m + 1] << 2);
      off = e & STEP2_NODE;
      put(m, e >> 16, (e >> 14) & 1);
      put(m + 1, (int)((uint32_t)e >> 24), (e >> 15) & 1);
    }
  } else if (j0 >= len) {
    const int f = off >> 1;  // the same state in the 1-bit table
#pragma unroll
    for (int k = 0; k < 8; ++k)
      put(k, offset_lookup(tab_s, f | b[k] << 2) >> 16, 0);
  } else {
    int f = off >> 1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = offset_lookup(tab_s, f | b[k] << 2);
      const bool active = j0 + k < len;
      put(k, e >> 16, active && (e & OFF_EMIT));
      if (active) f = e & OFF_MASK;
    }
    off = f << 1;
  }
}

__global__ void __launch_bounds__(INDEXED_THREADS) lane_scan_indexed_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ lane_len, uint8_t* __restrict__ sym,
    uint8_t* __restrict__ valid, int G, int B, int tab_words, int L, int R,
    int vec) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  extern __shared__ __align__(16) uint8_t smem[];
  const int g0 = blockIdx.x * L, w = min(L, G - g0);
  // three bit tiles, two output stages (each the sym tile then the valid
  // tile), the 2-bit step table
  uint8_t* out_s = smem + BIT_STAGES * R * L;
  int32_t* step_s = reinterpret_cast<int32_t*>(out_s + 4 * R * L);
  auto tile = [&](int t) { return smem + (t % BIT_STAGES) * R * L; };
  const int T = (B + R - 1) / R;
  const bool walker = threadIdx.x < 32;
  const Copier q((int)threadIdx.x - 32, (int)blockDim.x - 32,
                 L == G ? 1 : w / vec);
  // the copy threads stage tiles t < BIT_STAGES - 1, a commit group each
  auto stage = [&](int t) {
    if (t < T) copy_in(q, tile(t), bits, G, g0, w, L, t * R, min(R, B - t * R),
                       vec);
    cp_async_commit();
  };
  if (!walker)
    for (int t = 0; t < BIT_STAGES - 1; ++t) stage(t);
  stage_offset_table(tab_s, tab, tab_words);
  const int l = threadIdx.x, g = g0 + l;
  const bool real = walker && l < w;
  const int len = real ? min(max(lane_len[g], 0), B) : 0;
  __syncthreads();
  stage_step_table2(step_s, tab_s, tab_words);  // published by the tile loop
  int off = 0;  // the state's byte offset in the 2-bit table (0: the root)
  for (int t = 0; t < T; ++t) {
    const int r0 = t * R;
    if (!walker) cp_async_wait<BIT_STAGES - 2>();
    __syncthreads();
    if (!walker) {  // tile t - 1's outputs out, tile t + 2 in
      if (t > 0)
        copy_out(q, out_s + ((t - 1) & 1) * 2 * R * L, sym, valid, G, g0, w,
                 L, R, r0 - R, R, vec);
      stage(t + BIT_STAGES - 1);
      continue;
    }
    if (!real) continue;
    const uint8_t* col = tile(t) + l;
    uint8_t* os = out_s + (t & 1) * 2 * R * L + l;
    uint8_t* ov = os + R * L;
    const int nr = min(R, B - r0);
    for (int k0 = 0; k0 < nr; k0 += 8) {  // R is a multiple of 16
      int b[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) b[k] = col[(k0 + k) * L] & 1;
      walk8(step_s, tab_s, b, r0 + k0, len, off, [&](int k, int sv, int vv) {
        os[(k0 + k) * L] = (uint8_t)sv;
        ov[(k0 + k) * L] = (uint8_t)vv;
      });
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!walker && T > 0)
    copy_out(q, out_s + ((T - 1) & 1) * 2 * R * L, sym, valid, G, g0, w, L,
             R, (T - 1) * R, B - (T - 1) * R, vec);
}

}  // namespace

extern "C" int ws_lane_scan_indexed(const uint8_t* bits, const int32_t* tab,
                                    const int32_t* lane_len, uint8_t* sym,
                                    uint8_t* valid, int G, int B,
                                    int tab_words, int L, int R, int vec,
                                    int shared, cudaStream_t stream) {
  // vec must suit the outputs' pointers as it suits the bits'
  const uintptr_t ptrs = (uintptr_t)bits | (uintptr_t)sym | (uintptr_t)valid;
  if (tab_words < 1 || tab_words > LANEDFA_TAB_WORDS || B < 0 ||
      !bit_plan_ok((const void*)ptrs, G, L, R, vec, INDEXED_THREADS, shared) ||
      shared < (BIT_STAGES + 4) * R * L + step2_bytes(tab_words))
    return (int)cudaErrorInvalidValue;
  lane_scan_indexed_kernel<<<(G + L - 1) / L, INDEXED_THREADS, shared,
                             stream>>>(
      bits, tab, lane_len, sym, valid, G, B, tab_words, L, R, vec);
  return (int)cudaGetLastError();
}
