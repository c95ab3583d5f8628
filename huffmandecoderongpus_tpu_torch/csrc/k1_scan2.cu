// K1: chunked main scan + self-synchronizing candidate discovery.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan2 /
// _k1_kernel2 (md >= 2).  The TPU kernel makes every step one all-lanes
// vector op and walks segments as a sequential grid dimension, carrying the
// chains' state in scratch from one grid step to the next.  Here one thread
// owns one lane and walks every segment of it: per segment the main chain
// (publishing its per-row state and count), then the md leaders
// (publishing theirs), then the live followers, which read both.  The
// per-segment scratch is SEG/2 <= 16 rows per lane.  Liveness is decided
// per lane instead of per row group, which changes no output: a resolved
// follower is frozen, leaders walk whenever any chain of their lane is
// live, and a lane whose stream has ended writes zero cells.  The TPU's
// follower groups (GROUP_W chains gated together) are not ported: a thread
// skips each resolved follower on its own.
//
// The per-lane body is k1_scan2_lane (widescan.cuh), which the fused
// one-shot kernel runs too.
//
// What bounds it on the H100: each lane is a chain of dependent table
// lookups (the quad table sits in shared memory), and the plan's G lanes
// (1K-16K) give at most a few warps per SM, so the kernel is latency-bound,
// not bandwidth-bound.  Word reads (lane-minor rows) and cell writes are
// coalesced across the lanes of a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k1_scan2_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int32_t* __restrict__ cntmap,
    int32_t* __restrict__ exmap, int32_t* __restrict__ mrowmap, int G,
    int steps_w, int B, int H, int steps, int steps_p, int SEG, int md,
    int C0, int C1, int NS) {
  __shared__ uint32_t tab_s[TAB_WORDS];
  load_table(tab_s, tab, NS);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  k1_scan2_lane(WmatWords{wmat, G, steps_w}, tab_s, lim2[g], sym, val,
                cntmap, exmap, mrowmap, G, g, B, H, steps, steps_p, SEG, md,
                C0, C1, NS);
}

}  // namespace

extern "C" const char* ws_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int ws_k1_scan2(const int32_t* wmat, const uint32_t* tab,
                           const int32_t* lim2, int32_t* sym, uint8_t* val,
                           int32_t* cntmap, int32_t* exmap, int32_t* mrowmap,
                           int G, int steps_w, int B, int H, int steps,
                           int steps_p, int SEG, int md, int C0, int C1,
                           int NS, cudaStream_t stream) {
  if (SEG / 2 > MAX_SEGH || md > MAX_NL || md < 2 || H - 1 > MAX_CH ||
      NS > MAX_NS || SEG % (md * CELL) || steps_p % SEG)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k1_scan2_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      wmat, tab, lim2, sym, val, cntmap, exmap, mrowmap, G, steps_w, B, H,
      steps, steps_p, SEG, md, C0, C1, NS);
  return (int)cudaGetLastError();
}
