// S2: one pointer-doubling level of the speculative pipeline.
//
// Replaces no TPU kernel: the JAX pipeline (huffmandecoderongpus_tpu/ops/
// speculative.py speculative_decode_xla) runs `double` (:122-127) as XLA
// ops, once a level, and keeps every even level (:129-140).  For every
// bit offset b, with s the level below (the span of 2^(k-1) codewords from
// b, or -1):
//
//   t = b + s[b];  w = s[t]  (t clamped to the stream, as XLA's clip)
//   s'[b] = s[b] + w  if s[b] != -1, t < bits, w != -1 and t + w <= bits
//         = -1        otherwise
//
// The level is read from one buffer and written to another: s[t] of a
// later offset would otherwise be read after its thread overwrote it.
// Each level is written once, in the type its spans fit: int16 where
// 2^k * height <= 32767 (the JAX rule for a kept level, :131), else int32.
// An even level's buffer is its kept copy, an odd level's a scratch that
// only the next level reads, so no level is written twice.  The launcher
// takes the input and output element sizes: 2 -> 2, 2 -> 4 and 4 -> 4.
// An int16 -1 reads back as -1 (sign extension).
//
// What bounds it on the H100: bytes.  A level reads s once, coalesced,
// and s[t] once more, a gather whose addresses rise with b (t - b is at
// most 2^k * height bits), so neighbouring threads share sectors; the
// output is written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) spec_double_kernel(
    const TI* __restrict__ s, TO* __restrict__ out, int bits) {
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (b >= bits) return;
  const int sb = s[b];
  int r = -1;
  if (sb != -1) {
    const long long t = b + sb;
    if (t < bits) {
      const int w = s[t];
      if (w != -1 && t + w <= (long long)bits) r = sb + w;
    }
  }
  out[b] = (TO)r;
}

template <typename TI, typename TO>
void launch(const void* s, void* out, int bits, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)(((long long)bits + THREADS - 1) / THREADS);
  spec_double_kernel<TI, TO><<<blocks, THREADS, 0, stream>>>(
      (const TI*)s, (TO*)out, bits);
}

}  // namespace

// s (bits,) of in_bytes (2 or 4) a span; out (bits,) of out_bytes
extern "C" int ws_spec_double(const void* s, void* out, int bits,
                              int in_bytes, int out_bytes,
                              cudaStream_t stream) {
  if (bits <= 0) return (int)cudaErrorInvalidValue;
  if (in_bytes == 2 && out_bytes == 2)
    launch<int16_t, int16_t>(s, out, bits, stream);
  else if (in_bytes == 2 && out_bytes == 4)
    launch<int16_t, int32_t>(s, out, bits, stream);
  else if (in_bytes == 4 && out_bytes == 4)
    launch<int32_t, int32_t>(s, out, bits, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
