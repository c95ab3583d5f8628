// Lane scan of the lane-DFA chain: each lane from its true entry offset.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// lane_scan_pallas_tiled / _main_kernel.  The TPU kernel steps one
// 1024-lane tile per grid step as an (8, 128) vector state; here one thread
// owns one lane and walks its rows (B+H, or the first `rows` of them: the
// fix scan of the self-synchronizing discovery, lanedfa_sync.py _fix_scan),
// with the fused table (at most 2048 int32) in shared memory.  A row is
// active from the lane's entry offset while it is below the stream end
// (N - g*B) and the lane has not finished (its first emission at a row j
// with j + 1 >= B is its last).  Every row is written: sym is the symbol
// field of the row's table entry (what the TPU kernel stores), valid marks
// the active rows that emit.
//
// What bounds it on the H100: each lane is a serial walk of every row,
// e = tab[node*2 + bit], node = e & STATE_MASK: one shared-memory lookup
// and a few integer ops, about 40 cycles a row by the probes (PERF.md), not
// the bytes.  The design keeps everything else off that path:
// - A block owns L lanes (32 where G allows), one warp: 128 blocks at
//   G = 4096 for the 132 SMs (before, 32 blocks of 128 lanes).
// - Its bits come through the ring of staged tiles (widescan.cuh BitRing:
//   R rows, three stages, the next two in flight), and a thread reads its
//   next eight bits into registers before it walks them.  Before, every
//   row paid a load from device memory (L2) on the dependent path.
// - The table is staged with each next state as its byte offset
//   (widescan.cuh stage_offset_table): between two lookups the dependent
//   path is two LOP3s, the step's masks beside it.  An unmasked loop for
//   the inner tiles, as candidate_scan has, made this kernel slower on an
//   H100 (137 against 97 cycles a row; PERF.md), so it has none.
// - sym and valid go to a tile in shared memory (two, alternating) and
//   leave it a tile at a time, 16-byte stores where G and the pointers
//   allow: on an H100 about 6 % faster than a byte store a row from the
//   scan loop (PERF.md).
// Left out: multi-bit steps (see candidate_scan.cu).

#include "widescan.cuh"

using namespace ws;

namespace {

// Rows [r0, r0 + nr) of the staged sym and valid tiles (src, then src +
// R*L) to lanes [g0, g0 + w) of the (rows, G) outputs, `vec` bytes a store
// (whole runs of rows where one block holds every lane, as stage_bit_tile).
__device__ __forceinline__ void write_tiles(const uint8_t* src, uint8_t* sym,
                                            uint8_t* valid, int G, int g0,
                                            int w, int L, int R, int r0,
                                            int nr, int vec) {
  for (int which = 0; which < 2; ++which) {
    const uint8_t* s = src + which * R * L;
    uint8_t* d = (which ? valid : sym) + (size_t)r0 * G + g0;
    if (L == G) {
      copy_run(d, s, nr * G, vec, StoreBytes());
      continue;
    }
    for (TileWalk it(w / vec); it.r < nr; it.next()) {
      const int c = it.c * vec;
      StoreBytes()(d + (size_t)it.r * G + c, s + it.r * L + c, vec);
    }
  }
}

__global__ void __launch_bounds__(32) lane_scan_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ start, uint8_t* __restrict__ sym,
    uint8_t* __restrict__ valid, int G, int B, int rows, int N,
    int tab_words, int L, int R, int vec) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  extern __shared__ __align__(16) uint8_t smem[];
  const int g0 = blockIdx.x * L;
  const BitRing ring{smem, bits, G, g0, min(L, G - g0), L, R, rows, vec};
  // two output stages, each the sym tile then the valid tile
  uint8_t* out_s = smem + BIT_STAGES * R * L;
  ring.begin();
  stage_offset_table(tab_s, tab, tab_words);
  const int l = threadIdx.x, g = g0 + l;
  const bool real = l < ring.w;
  const int j0 = real ? start[g] : 0;
  const long long lim = (long long)N - (long long)g * B;
  const int jend = (int)max(0LL, min(lim, (long long)rows));
  int off = 0;  // the state's byte offset (0: the root)
  bool done = false;
  const int T = ring.tiles();
  for (int t = 0; t < T; ++t) {
    const int r0 = t * R;
    ring.wait();
    __syncthreads();
    if (t > 0)
      write_tiles(out_s + ((t - 1) & 1) * 2 * R * L, sym, valid, G, g0,
                  ring.w, L, R, r0 - R, R, vec);
    ring.issue(t + BIT_STAGES - 1);
    if (!real) continue;
    const uint8_t* col = ring.tile(t) + l;
    uint8_t* os = out_s + (t & 1) * 2 * R * L + l;
    uint8_t* ov = os + R * L;
    const int nr = min(R, rows - r0);
    for (int k0 = 0; k0 < nr; k0 += 8) {  // R is a multiple of 8
      int b4[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) b4[k] = (col[(k0 + k) * L] & 1) << 2;
      int e[8];
      bool emit[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = r0 + k0 + k;
        e[k] = offset_lookup(tab_s, off | b4[k]);
        const bool active = j >= j0 && !done && j < jend;
        emit[k] = active && (e[k] & OFF_EMIT);
        if (active) off = e[k] & OFF_MASK;
        if (emit[k] && j + 1 >= B) done = true;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        os[(k0 + k) * L] = (uint8_t)(e[k] >> 16);
        ov[(k0 + k) * L] = emit[k];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (T > 0)
    write_tiles(out_s + ((T - 1) & 1) * 2 * R * L, sym, valid, G, g0, ring.w,
                L, R, (T - 1) * R, rows - (T - 1) * R, vec);
}

}  // namespace

extern "C" int ws_lane_scan(const uint8_t* bits, const int32_t* tab,
                            const int32_t* start, uint8_t* sym,
                            uint8_t* valid, int G, int B, int rows, int N,
                            int tab_words, int L, int R, int vec, int shared,
                            cudaStream_t stream) {
  // vec must suit the outputs' pointers as it suits the bits'
  const uintptr_t ptrs = (uintptr_t)bits | (uintptr_t)sym | (uintptr_t)valid;
  if (tab_words > LANEDFA_TAB_WORDS || rows < 0 ||
      !bit_plan_ok((const void*)ptrs, G, L, R, vec, 32, shared) ||
      shared < (BIT_STAGES + 4) * R * L)
    return (int)cudaErrorInvalidValue;
  lane_scan_kernel<<<(G + L - 1) / L, 32, shared, stream>>>(
      bits, tab, start, sym, valid, G, B, rows, N, tab_words, L, R, vec);
  return (int)cudaGetLastError();
}
