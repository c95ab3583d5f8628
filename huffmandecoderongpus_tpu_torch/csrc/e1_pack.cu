// E1: each lane packs its symbols' codes into 16-bit granules.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_encode.py e1_pack /
// _e1_kernel.  Lane g's symbols are column g of data (K, G): row k is the
// lane's k-th symbol, and rows at or past nval[g] pack zero bits (padding is
// positional, not a pad symbol, so a full 256-symbol alphabet encodes here).
// Every symbol appends its two half-codes (lo, hi tables: code bits in the
// low 13 bits, their count above) to a 16-bit granule accumulator; after
// each half, sub-step row r = 2k + half records acc & 0xFFFF in gran and
// whether a granule completed (then it leaves the accumulator) in gval.
// Every row is written, emitting or not, as the TPU kernel writes it.  The
// last row (2K-1), which carries no emission because K >= K_real + 1,
// takes the residual granule; cnt counts a lane's granules and bits its
// code bits.
//
// The TPU kernel runs K/SEG sequential grid steps over all lanes at once,
// carrying acc/nb/cnt/bits across steps in VMEM scratch.  On the GPU no
// state carries between blocks, so one thread owns one lane and runs all
// 2K sub-steps in registers; the two 256-entry tables sit in shared memory.
//
// What bounds it on the H100: latency.  A lane is 2K dependent sub-steps
// (1,376 for a kjv-sized stream at G = 8192) and G <= 8192 lanes are few
// threads for 132 SMs, so the kernel runs far below the memory rate its
// bytes (mostly the (2K, G) gran rows) would allow.  Blocks of 64 lanes
// spread those threads over twice as many SMs as blocks of 128, and the
// symbol loads are issued UNROLL rows ahead of the accumulator chain.  The
// symbol reads and both row writes are coalesced across a warp's lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GRAN = 16;
constexpr int HALF = 13;
constexpr uint32_t HALF_MASK = (1u << HALF) - 1;
constexpr int THREADS = 64;
constexpr int UNROLL = 8;

struct Acc {
  uint32_t acc = 0, nb = 0, cnt = 0, bits = 0;

  // append one half-code table entry; write sub-step row `o`
  __device__ __forceinline__ void append(uint32_t ent, int32_t* gran,
                                         uint8_t* gval, size_t o) {
    acc |= (ent & HALF_MASK) << nb;
    nb += ent >> HALF;
    bits += ent >> HALF;
    const bool emit = nb >= GRAN;  // nb < 16 before, <= 28 after
    gran[o] = (int32_t)(acc & 0xFFFFu);
    gval[o] = emit;
    if (emit) {
      acc >>= GRAN;
      nb -= GRAN;
      ++cnt;
    }
  }
};

__global__ void __launch_bounds__(THREADS) e1_pack_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ nval,
    int32_t* __restrict__ gran, uint8_t* __restrict__ gval,
    int32_t* __restrict__ cnt, int32_t* __restrict__ bits, int K, int G) {
  __shared__ uint32_t lo_s[256], hi_s[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    lo_s[i] = (uint32_t)lo[i];
    hi_s[i] = (uint32_t)hi[i];
  }
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int nv = nval[g];
  Acc a;
  for (int k0 = 0; k0 < K; k0 += UNROLL) {
    uint8_t sym[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      sym[u] = k0 + u < K ? data[(size_t)(k0 + u) * G + g] : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u;
      if (k >= K) break;
      const bool valid = k < nv;
      const size_t o = (size_t)(2 * k) * G + g;
      a.append(valid ? lo_s[sym[u]] : 0u, gran, gval, o);
      a.append(valid ? hi_s[sym[u]] : 0u, gran, gval, o + G);
    }
  }
  // flush: the residual bits (nb < 16) overwrite the last row
  const size_t last = (size_t)(2 * K - 1) * G + g;
  gran[last] = (int32_t)(a.acc & 0xFFFFu);
  gval[last] = a.nb > 0;
  cnt[g] = (int32_t)(a.cnt + (a.nb > 0));
  bits[g] = (int32_t)a.bits;
}

}  // namespace

extern "C" int ws_e1_pack(const uint8_t* data, const int32_t* lo,
                          const int32_t* hi, const int32_t* nval,
                          int32_t* gran, uint8_t* gval, int32_t* cnt,
                          int32_t* bits, int K, int G, cudaStream_t stream) {
  if (K < 1 || G < 1) return (int)cudaErrorInvalidValue;
  e1_pack_kernel<<<(G + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      data, lo, hi, nval, gran, gval, cnt, bits, K, G);
  return (int)cudaGetLastError();
}
