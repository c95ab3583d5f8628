// S1: the speculative pipeline's first stage, a decode from every bit offset.
//
// Replaces no TPU kernel: the JAX pipeline (huffmandecoderongpus_tpu/ops/
// speculative.py speculative_decode_xla :105-111) runs this stage as XLA
// ops, window extraction (extract_windows :63-75) and two LUT gathers.  The
// reference's own backend for it is a CUDA kernel (fastgpu.cu's
// decodeAllBits).  For every bit offset b < bits: the height-bit window
// starting at b (LSB-first), its first symbol and code length from the
// full-height table, and step0[b] = the length, or -1 where the code would
// run past the stream (b + len > bits).
//
// step0 is stored as int16: its values are -1..height (<= 22), and the
// JAX pipeline keeps level 0 as int16 too (speculative.py :129-135), so the
// doubling (spec_double.cu) and the query (spec_query.cu) read it as kept
// level 0 with no int32 copy.
//
// The window: words[b / 32] and words[b / 32 + 1] through a funnel shift,
// which is right for every shift 0..31 (x << 32 is undefined in C++ as in
// XLA, where extract_windows masks the r == 0 case).  The caller's pad
// word keeps words[b / 32 + 1] in bounds for b < bits.
//
// What bounds it on the H100: bytes, the words read once (a warp's 32
// offsets share a word) and 3 bytes written an offset; the table is read
// through L1 (a few KB at height 9) or L2 (5.2 MB at height 20).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) spec_all_bits_kernel(
    const uint32_t* __restrict__ words, const uint8_t* __restrict__ lut_sym,
    const int32_t* __restrict__ lut_len, int16_t* __restrict__ step0,
    uint8_t* __restrict__ sym, int bits, uint32_t mask) {
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (b >= bits) return;
  const long long q = b >> 5;
  const uint32_t win =
      __funnelshift_r(__ldg(words + q), __ldg(words + q + 1), (uint32_t)b) &
      mask;
  const int ln = __ldg(lut_len + win);
  step0[b] = (int16_t)(b + ln <= (long long)bits ? ln : -1);
  sym[b] = __ldg(lut_sym + win);
}

}  // namespace

// words (bits / 32 + 2,) uint32; lut_sym (2^height,) uint8; lut_len
// (2^height,) int32; step0 (bits,) int16 and sym (bits,) uint8 written
extern "C" int ws_spec_all_bits(const uint32_t* words, const uint8_t* lut_sym,
                                const int32_t* lut_len, int16_t* step0,
                                uint8_t* sym, int bits, int height,
                                cudaStream_t stream) {
  if (bits <= 0 || height < 1 || height > 22)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)(((long long)bits + THREADS - 1) / THREADS);
  spec_all_bits_kernel<<<blocks, THREADS, 0, stream>>>(
      words, lut_sym, lut_len, step0, sym, bits, (1u << height) - 1u);
  return (int)cudaGetLastError();
}
