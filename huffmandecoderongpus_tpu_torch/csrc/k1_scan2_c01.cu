// K1 of the batched multi-stream decode: per-stream tables, per-lane root
// children.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py
// _k1_kernel2_c01 with k1_scan2's tab_bounds (the table BlockSpec whose
// index map picks each row group's own (2, 128) compact quad table).  Every
// stream of a batch owns whole 128-lane ranges (bstream maps each to its
// stream), and a block's K1_THREADS / T lanes lie inside one of them: the
// block stages that stream's step table (NS = 1) in shared memory.  The
// compact layout's entries hold their post-chunk states, so the table does
// not depend on the root children; each lane reads its tree's C0 | C1 << 16
// from c01, which a candidate chain starting mid-chunk takes.  The lane
// body is K1's team body (k1_team, widescan.cuh), planned and launched as
// in k1_scan2.cu.
//
// What bounds it on the H100: as k1_scan2.cu, each lane's main chain of
// dependent lookups, and a row of the team body for every role while
// candidate chains live; pad lanes and the common-B tails of the shorter
// streams end at their limit and only write zero cells.

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int MIN_BLOCKS = 4;  // an SM's blocks the registers allow
constexpr int STREAM_LANES = 128;  // lanes of one stream-map entry

__global__ void __launch_bounds__(K1_THREADS, MIN_BLOCKS) k1_scan2_c01_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tabs,
    const int32_t* __restrict__ lim2, const int32_t* __restrict__ c01,
    const int32_t* __restrict__ bstream, K1Args a, int steps_w, int H,
    int md, int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* step = reinterpret_cast<int32_t*>(smem);
  const int lanes = K1_THREADS / T;
  const int stream = bstream[blockIdx.x * lanes / STREAM_LANES];
  stage_step_table(step, tabs + (size_t)stream * 2 * 128, 1, 0, 0);
  __syncthreads();
  const int gt = blockIdx.x * K1_THREADS + threadIdx.x;
  const int g = gt / T, j = gt & (T - 1);  // T divides 32
  const uint32_t rc = (uint32_t)c01[g];
  a.C0 = (int)(rc & 0xFFFFu);
  a.C1 = (int)(rc >> 16);
  const Team tm = Team::of(smem + step_bytes(1), H, md, seg_bits(md), T);
  const unsigned mask = team_mask(T);
  const WmatWords words{wmat, a.G, steps_w};
  with_md(md, [&](auto m) {
    k1_team<decltype(m)::value>(a, words, lim2, step, tm, g, j, T, mask);
  });
}

std::atomic<unsigned> opted_in{0};

}  // namespace

extern "C" int ws_k1_scan2_c01(const int32_t* wmat, const uint32_t* tabs,
                               const int32_t* lim2, const int32_t* c01,
                               const int32_t* bstream, int32_t* sym,
                               uint8_t* val, int32_t* cntmap, int32_t* exmap,
                               int32_t* mrowmap, int G, int steps_w, int B,
                               int H, int steps, int steps_p, int SEG, int md,
                               int T, int shared, cudaStream_t stream) {
  if (!k1_plan_ok(G, H, md, SEG, 1, T, shared) || G % STREAM_LANES ||
      steps_p % SEG || steps_w * 32 < steps_p)
    return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = allow_shared((const void*)k1_scan2_c01_kernel,
                                         opted_in);
    if (err != cudaSuccess) return (int)err;
  }
  const K1Args a{sym, val, cntmap, exmap, mrowmap, G, B, steps, steps_p,
                 0, 0};
  k1_scan2_c01_kernel<<<G * T / K1_THREADS, K1_THREADS, shared, stream>>>(
      wmat, tabs, lim2, c01, bstream, a, steps_w, H, md, T);
  return (int)cudaGetLastError();
}
