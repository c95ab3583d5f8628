// S2, the high levels: kept level 2j + 2 from kept level 2j, two doubling
// levels a launch, the odd level between them never written.
//
// Replaces no TPU kernel: the JAX pipeline (huffmandecoderongpus_tpu/ops/
// speculative.py speculative_decode_xla) runs `double` (:122-127) as XLA
// ops, once a level, and keeps every even level (:129-140).  With K the
// kept level 2j, the odd level is, at any offset x,
//
//   o(x) = K[x] + K[x + K[x]]  if K[x] != -1, x + K[x] < bits,
//                                 K[x + K[x]] != -1 and the sum's end <= bits
//        = -1                  otherwise
//
// and the next kept level at b is o(b) + o(t1), t1 = b + o(b), by the same
// rule.  A thread computes it from four loads of K: K[b] (coalesced), then
// three dependent gathers K[b + K[b]], K[t1], K[t1 + K[t1]] whose addresses
// rise with b.  Each thread takes PER offsets, a stage of all of them at a
// time, so PER loads of a stage are in flight together.  The level is
// written once, in the type its spans fit: 2 -> 2, 2 -> 4 or 4 -> 4 bytes
// (ops/spec_double.py level_dtype).  An int16 -1 reads back as -1.
//
// What bounds it on the H100: bytes, K read once and the new level written
// once; the gathers land 1, 2 and 3 spans of level 2j past b, sectors that
// the launch's coalesced reads bring through the 50 MB L2 anyway while the
// spans are short.  At the top levels of a large stream three spans pass
// most of the L2 (60 MB of int32 at level 20 of a kjv-sized stream), and a
// block's gathers would miss: there the plan gives `seg`, the blocks in a
// span, and the blocks run in an order that takes blocks a span apart
// together (physical block p is block (p % nseg) * seg + p / nseg), so a
// block's gathers land where other running blocks read.  At shorter spans
// the gathers hit the L2 in the plain order, which keeps each block's
// coalesced reads next to its neighbours'.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) spec_pair_kernel(
    const TI* __restrict__ s, TO* __restrict__ out, int bits, int seg,
    int nseg) {
  const long long p = blockIdx.x;
  const long long block = (p % nseg) * seg + p / nseg;
  const long long base = block * (THREADS * PER) + threadIdx.x;
  const long long n = bits;
  long long b[PER], t1[PER];
  int a[PER], c[PER], o1[PER], d[PER], e[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    b[u] = base + (long long)u * THREADS;
    a[u] = b[u] < n ? (int)s[b[u]] : -1;
  }
  // the odd level at b
#pragma unroll
  for (int u = 0; u < PER; ++u)
    c[u] = (a[u] != -1 && b[u] + a[u] < n) ? (int)__ldg(s + b[u] + a[u])
                                           : -1;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const long long t = b[u] + a[u];
    o1[u] = (a[u] != -1 && t < n && c[u] != -1 && t + c[u] <= n)
                ? a[u] + c[u]
                : -1;
    t1[u] = b[u] + o1[u];
    d[u] = (o1[u] != -1 && t1[u] < n) ? (int)__ldg(s + t1[u]) : -1;
  }
  // the odd level at t1
#pragma unroll
  for (int u = 0; u < PER; ++u)
    e[u] = (d[u] != -1 && t1[u] + d[u] < n) ? (int)__ldg(s + t1[u] + d[u])
                                            : -1;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const long long t2 = t1[u] + d[u];
    const int o2 = (d[u] != -1 && t2 < n && e[u] != -1 && t2 + e[u] <= n)
                       ? d[u] + e[u]
                       : -1;
    const int r = (o1[u] != -1 && t1[u] < n && o2 != -1 && t1[u] + o2 <= n)
                      ? o1[u] + o2
                      : -1;
    if (b[u] < n) out[b[u]] = (TO)r;
  }
}

template <typename TI, typename TO>
void launch(const void* s, void* out, int bits, int seg,
            cudaStream_t stream) {
  const long long blocks =
      ((long long)bits + THREADS * PER - 1) / (THREADS * PER);
  const int nseg = (int)((blocks + seg - 1) / seg);
  spec_pair_kernel<TI, TO><<<(unsigned)((long long)nseg * seg), THREADS, 0,
                             stream>>>((const TI*)s, (TO*)out, bits, seg,
                                       nseg);
}

}  // namespace

// s (bits,) of in_bytes (2 or 4) a span, kept level 2j; out (bits,) of
// out_bytes, kept level 2j + 2; seg the blocks a span apart that run
// together (1: in order)
extern "C" int ws_spec_pair(const void* s, void* out, int bits, int in_bytes,
                            int out_bytes, int seg, cudaStream_t stream) {
  if (bits <= 0 || seg < 1 ||
      seg > ((long long)bits + THREADS * PER - 1) / (THREADS * PER))
    return (int)cudaErrorInvalidValue;
  if (in_bytes == 2 && out_bytes == 2)
    launch<int16_t, int16_t>(s, out, bits, seg, stream);
  else if (in_bytes == 2 && out_bytes == 4)
    launch<int16_t, int32_t>(s, out, bits, seg, stream);
  else if (in_bytes == 4 && out_bytes == 4)
    launch<int32_t, int32_t>(s, out, bits, seg, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
