// K1: chunked main scan + self-synchronizing candidate discovery.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan2 /
// _k1_kernel2 (md >= 2).  The TPU kernel makes every step one all-lanes
// vector op and walks segments as a sequential grid dimension, carrying the
// chains' state in scratch from one grid step to the next.  Here each lane
// has a team of T threads of one warp that walks every segment of it: the
// main chain, the md leaders and the followers side by side, as a pipeline
// over segments (k1_team, widescan.cuh: the body the one-shot kernel runs
// too).  A block of K1_THREADS holds K1_THREADS / T lanes and stages the
// step table of the quad table (NS table chunks, up to 16 KB) and its
// teams' rings in dynamic shared memory; ops/k1_scan2.py k1_plan picks T
// and the bytes, and the launcher refuses any other plan (k1_plan_ok).
// Liveness is a warp vote, so the grid is exactly G * T threads.  The
// TPU's follower groups (GROUP_W chains gated together) are not ported: a
// resolved follower is frozen on its own.
//
// Each lane's words come from the halo'd (steps_w, G) word matrix
// (WmatWords), which K3 reads too; thread 0 of a team reads them, a segment
// ahead of its walk.
//
// What bounds it on the H100: each lane's main chain of dependent table
// lookups (one a 2-bit chunk, in shared memory), and while candidate chains
// live a row of the team body for every role.  Once a warp's chains have
// resolved, its 32 / T main chains go on alone, and a row costs more the
// more warps an SM issues for; so k1_plan gives long lanes on a busy grid
// the smallest team (a thread a leader) and every other launch a thread a
// chain.  At 128 registers (4 blocks an SM) a grid may take more than one
// wave, each a whole chain.  Word reads (thread 0 of a team, a segment
// ahead) and cell writes are a few MB and stay in L2.

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int MIN_BLOCKS = 4;  // an SM's blocks the registers allow

__global__ void __launch_bounds__(K1_THREADS, MIN_BLOCKS) k1_scan2_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, K1Args a, int steps_w, int H, int md,
    int NS, int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* step = reinterpret_cast<int32_t*>(smem);
  stage_step_table(step, tab, NS, a.C0, a.C1);
  __syncthreads();
  const int gt = blockIdx.x * K1_THREADS + threadIdx.x;
  const int g = gt / T, j = gt & (T - 1);  // T divides 32
  const Team tm = Team::of(smem + step_bytes(NS), H, md, seg_bits(md), T);
  const unsigned mask = team_mask(T);
  const WmatWords words{wmat, a.G, steps_w};
  with_md(md, [&](auto m) {
    k1_team<decltype(m)::value>(a, words, lim2, step, tm, g, j, T, mask);
  });
}

std::atomic<unsigned> opted_in{0};

}  // namespace

extern "C" const char* ws_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int ws_k1_scan2(const int32_t* wmat, const uint32_t* tab,
                           const int32_t* lim2, int32_t* sym, uint8_t* val,
                           int32_t* cntmap, int32_t* exmap, int32_t* mrowmap,
                           int G, int steps_w, int B, int H, int steps,
                           int steps_p, int SEG, int md, int C0, int C1,
                           int NS, int T, int shared, cudaStream_t stream) {
  if (!k1_plan_ok(G, H, md, SEG, NS, T, shared) || steps_p % SEG ||
      steps_w * 32 < steps_p)
    return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = allow_shared((const void*)k1_scan2_kernel,
                                         opted_in);
    if (err != cudaSuccess) return (int)err;
  }
  const K1Args a{sym, val, cntmap, exmap, mrowmap, G, B, steps, steps_p,
                 C0, C1};
  k1_scan2_kernel<<<(int)((long long)G * T / K1_THREADS), K1_THREADS, shared,
                    stream>>>(wmat, tab, lim2, a, steps_w, H, md, NS, T);
  return (int)cudaGetLastError();
}
