// Short candidate scan of the self-synchronizing lane-DFA discovery.
//
// Replaces huffmandecoderongpus_tpu/ops/lanedfa_sync.py
// _short_candidate_scan, an XLA lax.scan that carries all H chains of every
// lane as (H, G) state for W rows.  Here one thread owns one (chain, lane)
// pair, G*H threads in all, as in candidate_scan.cu.  Chain o starts at the
// root at row o of its lane and walks one bit per row through the fused
// table (staged in shared memory, at most 2048 int32) for rows below W and
// the lane's stream end (N - g*B).  It stops at its first emission on a row
// where the 0-chain (the lane scanned from offset 0) also emitted: it has
// merged, and the row is recorded.  Otherwise it stops at its first
// emission at a row j with j + 1 >= B: it has exited into lane g+1 at
// offset j + 1 - B.  An emission that is both is a merge, as in the
// reference (merge_now is tested before exit_now).  cnt counts the chain's
// emissions through the one that resolved it.  Outputs a chain never set
// stay 0, as the reference's carry starts.
//
// What bounds it on the H100: each thread is a chain of dependent lookups,
// short where chains merge soon (latency, not bytes); the bit and valid0
// reads are one byte a row each, coalesced across the lanes of a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(256) short_candidate_scan_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    const uint8_t* __restrict__ valid0, uint8_t* __restrict__ merged,
    uint8_t* __restrict__ exited, int32_t* __restrict__ mrow,
    int32_t* __restrict__ cnt, int32_t* __restrict__ ex, int G, int B, int H,
    int N, int W, int tab_words) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  for (int i = threadIdx.x; i < tab_words; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= G * H) return;
  const int o = t / G, g = t % G;
  // rows at or past the stream end (N - g*B) and past W are inactive
  const long long lim = (long long)N - (long long)g * B;
  const int end = (int)max(0LL, min(lim, (long long)W));
  int node = 0, n = 0, x = 0, mr = 0;
  bool is_merged = false, is_exited = false;
  for (int j = o; j < end; ++j) {
    const size_t at = (size_t)j * G + g;
    const int e = tab_s[node * 2 + bits[at]];
    node = e & STATE_MASK;
    if (e & EMIT_BIT) {
      ++n;
      if (valid0[at]) {  // on a boundary of the 0-chain: merged
        is_merged = true;
        mr = j;
        break;
      }
      if (j + 1 >= B) {  // the chain's first boundary in the next lane
        is_exited = true;
        x = j + 1 - B;
        break;
      }
    }
  }
  const size_t out = (size_t)o * G + g;
  merged[out] = is_merged;
  exited[out] = is_exited;
  mrow[out] = mr;
  cnt[out] = n;
  ex[out] = x;
}

}  // namespace

extern "C" int ws_short_candidate_scan(
    const uint8_t* bits, const int32_t* tab, const uint8_t* valid0,
    uint8_t* merged, uint8_t* exited, int32_t* mrow, int32_t* cnt,
    int32_t* ex, int G, int B, int H, int N, int W, int tab_words,
    cudaStream_t stream) {
  if (tab_words > LANEDFA_TAB_WORDS || (long long)G * H > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  short_candidate_scan_kernel<<<(G * H + threads - 1) / threads, threads, 0,
                                stream>>>(bits, tab, valid0, merged, exited,
                                          mrow, cnt, ex, G, B, H, N, W,
                                          tab_words);
  return (int)cudaGetLastError();
}
