// S4: the serial decode in one thread, <<<1, 1>>>.
//
// Replaces no TPU kernel: the JAX package runs this walk as a
// lax.while_loop on one scalar unit (huffmandecoderongpus_tpu/models/
// onethread.py _onethread_decode :23-36), the role of the reference's
// one-thread CUDA decoder (onethread.cu:13-52), a sanity baseline of one
// core's speed.  From pos = 0 while pos < bits: the height-bit window at
// pos (a funnel shift of two words), its symbol and code length from the
// full-height table, out[n] = symbol, pos += length, n += 1.
//
// As the JAX walk: a write past `size` is dropped while n keeps counting
// (out.at[n].set), so a header that says fewer symbols than the payload
// holds gives n > size and the caller raises; the walk stops on pos alone.
// The bytes the walk did not reach stay 0 (the JAX output starts zeroed):
// the thread writes them after the walk.
//
// What bounds it on the H100: one dependent chain a symbol, the window's
// word loads then the length lookup (L1 hits), about 40 cycles at best;
// nothing else runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void onethread_kernel(const uint32_t* __restrict__ words,
                                 const uint8_t* __restrict__ lut_sym,
                                 const int32_t* __restrict__ lut_len,
                                 uint8_t* __restrict__ out,
                                 int* __restrict__ n_out, int bits, int size,
                                 uint32_t mask) {
  int pos = 0, n = 0;
  while (pos < bits) {
    const int q = pos >> 5;
    const uint32_t win = __funnelshift_r(__ldg(words + q),
                                         __ldg(words + q + 1),
                                         (uint32_t)pos) & mask;
    if (n < size) out[n] = __ldg(lut_sym + win);
    pos += __ldg(lut_len + win);
    ++n;
  }
  for (int j = n; j < size; ++j) out[j] = 0;
  *n_out = n;
}

}  // namespace

// words (bits / 32 + 2,) uint32; lut_sym (2^height,) uint8; lut_len
// (2^height,) int32; out (size,) uint8; n (1,) int32
extern "C" int ws_onethread(const uint32_t* words, const uint8_t* lut_sym,
                            const int32_t* lut_len, uint8_t* out, int* n,
                            int bits, int size, int height,
                            cudaStream_t stream) {
  if (bits < 0 || size < 0 || height < 1 || height > 22)
    return (int)cudaErrorInvalidValue;
  onethread_kernel<<<1, 1, 0, stream>>>(words, lut_sym, lut_len, out, n,
                                        bits, size, (1u << height) - 1u);
  return (int)cudaGetLastError();
}
