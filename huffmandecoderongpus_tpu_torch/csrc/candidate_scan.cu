// Candidate scan of the lane-DFA chain: H chains per lane.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py
// candidate_scan_pallas_tiled / _candidate_kernel.  The TPU kernel carries
// all H chains of a 1024-lane tile as one (H, 8, 128) vector state and
// steps every row of the lane; here one thread owns one (chain, lane) pair,
// G*H threads in all, and stops at the chain's exit or the stream end, past
// which the TPU kernel's rows change nothing.  Chain o starts at the root at
// row o and walks one bit per row through the fused table (staged in shared
// memory, at most 2048 int32); its first emission at a row j with j + 1 >= B
// ends it.
//
// What bounds it on the H100: each thread is a chain of dependent lookups
// over up to B+H rows (latency); the bit matrix is read one byte per row,
// coalesced across the lanes of a warp (lanes are minor, threads of one
// chain take neighbouring lanes).

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(256) candidate_scan_kernel(
    const uint8_t* __restrict__ bits, const int32_t* __restrict__ tab,
    int32_t* __restrict__ cnt, int32_t* __restrict__ ex, int G, int B, int H,
    int N, int tab_words) {
  __shared__ int32_t tab_s[LANEDFA_TAB_WORDS];
  for (int i = threadIdx.x; i < tab_words; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= G * H) return;
  const int o = t / G, g = t % G;
  // rows at or past the stream end (N - g*B) and past B+H are inactive
  const long long lim = (long long)N - (long long)g * B;
  const int end = (int)max(0LL, min(lim, (long long)(B + H)));
  int node = 0, n = 0, x = 0;
  for (int j = o; j < end; ++j) {
    const int e = tab_s[node * 2 + bits[(size_t)j * G + g]];
    node = e & STATE_MASK;
    if (e & EMIT_BIT) {
      ++n;
      if (j + 1 >= B) {  // the chain's first boundary in the next lane
        x = j + 1 - B;
        break;
      }
    }
  }
  cnt[(size_t)o * G + g] = n;
  ex[(size_t)o * G + g] = x;
}

}  // namespace

extern "C" int ws_candidate_scan(const uint8_t* bits, const int32_t* tab,
                                 int32_t* cnt, int32_t* ex, int G, int B,
                                 int H, int N, int tab_words,
                                 cudaStream_t stream) {
  if (tab_words > LANEDFA_TAB_WORDS || (long long)G * H > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  candidate_scan_kernel<<<(G * H + threads - 1) / threads, threads, 0,
                          stream>>>(bits, tab, cnt, ex, G, B, H, N,
                                    tab_words);
  return (int)cudaGetLastError();
}
