// S4: the serial decode in one thread, <<<1, 1>>>.
//
// Replaces no TPU kernel: the JAX package runs this walk as a
// lax.while_loop on one scalar unit (huffmandecoderongpus_tpu/models/
// onethread.py _onethread_decode :23-36), the role of the reference's
// one-thread CUDA decoder (onethread.cu:13-52), a sanity baseline of one
// core's speed.  From pos = 0 while pos < bits: the height-bit window at
// pos, its symbol and code length from the full-height table, out[n] =
// symbol, pos += length, n += 1.
//
// As the JAX walk: a write past `size` is dropped while n keeps counting
// (out.at[n].set), so a header that says fewer symbols than the payload
// holds gives n > size and the caller raises; the walk stops on pos alone.
// The bytes the walk did not reach stay 0 (the JAX output starts zeroed):
// the thread writes them after the walk.
//
// What bounds it on the H100: one dependent chain a symbol, nothing else
// runs.  The design keeps one load on that chain:
//  - the table is packed (ops/onethread.py pack_table): one 16-bit entry a
//    window, (symbol << 5) | (length - 1), so one load gives both;
//  - the bits sit in a 96-bit buffer of three registers (b0 the lowest):
//    the next entry's byte offset is one funnel shift of b0:b1 by the
//    entry itself (the shift takes its low 5 bits, length - 1, which puts
//    the window one bit up) and one AND, so the chain is load, shift, AND,
//    load;
//  - an outer loop adds a word (loaded a word ahead, so no word load is on
//    the chain) whenever the buffer holds fewer than 2 * height bits, and
//    an inner loop walks two symbols a trip while it holds more: no refill
//    test sits between a load and the next, and the entries alternate
//    between two registers.  Topping the buffer up within each step, even
//    without a branch, let the compiler put the refill's chain (and a copy
//    of the new entry, which waits on its load) ahead of the next lookup.
// The table sits in shared memory where it fits (height <= 16: 2^h x 2
// bytes, staged by the thread 16 bytes a load), else it is read through
// L1 from device memory, still one load a symbol.

#include <cstdint>
#include <cuda_runtime.h>

#include "widescan.cuh"

namespace {

// tables up to this height are staged in shared memory
constexpr int SHARED_HEIGHT = 16;

std::atomic<unsigned> opted_in{0};

extern __shared__ uint4 stage[];

// The walk's registers: the 96-bit buffer b0:b1:b2 (b0 the stream's next
// bits, zeros past the `avail` it holds), the word it takes next (its
// index), the bit position and the symbols decoded.
struct Walk {
  uint32_t b0, b1, b2, nxt;
  int next, avail, pos, n;
};

// the entry at byte offset `at` (twice the window)
template <bool SHARED>
__device__ __forceinline__ uint32_t entry(const uint16_t* __restrict__ tab,
                                          uint32_t at) {
  if (SHARED)
    return *reinterpret_cast<const uint16_t*>(
        reinterpret_cast<const char*>(stage) + at);
  return __ldg(reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const char*>(tab) + at));
}

// One symbol, the entry `e` of the window at pos: loads the next window's
// entry into `f` first (the buffer shifted by length - 1, which the funnel
// shift takes from e's low 5 bits, and masked; the buffer holds 2h bits,
// so the next window is in it), then consumes the length and stores the
// symbol.
template <bool SHARED>
__device__ __forceinline__ void step(Walk& w, uint32_t e, uint32_t& f,
                                     const uint16_t* __restrict__ tab,
                                     uint32_t mask2,
                                     uint8_t* __restrict__ out, int size) {
  f = entry<SHARED>(tab, __funnelshift_r(w.b0, w.b1, e) & mask2);
  const uint32_t len = (e & 31u) + 1u;
  w.b0 = __funnelshift_r(w.b0, w.b1, len);
  w.b1 = __funnelshift_r(w.b1, w.b2, len);
  w.b2 >>= len;
  w.avail -= (int)len;
  w.pos += (int)len;
  if (w.n < size) out[w.n] = (uint8_t)(e >> 5);
  ++w.n;
}

template <bool SHARED>
__global__ void __launch_bounds__(1) onethread_kernel(
    const uint32_t* __restrict__ words, const uint16_t* __restrict__ tab,
    uint8_t* __restrict__ out, int* __restrict__ n_out, int n_words,
    int bits, int size, int height) {
  if (SHARED) {
    const int vecs = ((1 << height) + 7) >> 3;  // 8 entries a load
    const uint4* src = reinterpret_cast<const uint4*>(tab);
#pragma unroll 16
    for (int i = 0; i < vecs; ++i) stage[i] = __ldg(src + i);
  }
  const uint32_t mask2 = ((1u << height) - 1u) << 1;  // the window, 1 up
  const int last = n_words - 1;
  const int two = 2 * height;  // bits of the current and the next window
  Walk w;
  w.b0 = __ldg(words + min(0, last));
  w.b1 = __ldg(words + min(1, last));
  w.b2 = 0;
  w.next = 2;
  w.nxt = __ldg(words + min(2, last));
  w.avail = 64;
  w.pos = 0;
  w.n = 0;
  uint32_t e = entry<SHARED>(tab, (w.b0 << 1) & mask2), f;
  while (w.pos < bits) {
    // a word in at bit avail (under 2h, or 64 at the start); past the pad
    // word the buffer takes it again: those bits lie past every window
    const uint32_t a = (uint32_t)w.avail;
    if (a < 32) {
      w.b0 |= __funnelshift_lc(0u, w.nxt, a);
      w.b1 |= __funnelshift_lc(w.nxt, 0u, a);
    } else {
      w.b1 |= __funnelshift_lc(0u, w.nxt, a - 32);
      w.b2 |= __funnelshift_lc(w.nxt, 0u, a - 32);
    }
    w.avail += 32;
    w.nxt = __ldg(words + min(++w.next, last));
    // symbols while the buffer holds two windows, two a trip: the entries
    // alternate between e and f, so no copy waits on a load
    for (;;) {
      if (w.avail < two || w.pos >= bits) break;
      step<SHARED>(w, e, f, tab, mask2, out, size);
      if (w.avail < two || w.pos >= bits) {
        e = f;
        break;
      }
      step<SHARED>(w, f, e, tab, mask2, out, size);
    }
  }
  for (int j = w.n; j < size; ++j) out[j] = 0;
  *n_out = w.n;
}

}  // namespace

// words (n_words,) uint32, the payload with a zero pad word; tab
// (2^height rounded up to 8,) uint16, the packed table; out (size,) uint8;
// n (1,) int32
extern "C" int ws_onethread(const uint32_t* words, const uint16_t* tab,
                            uint8_t* out, int* n, int n_words, int bits,
                            int size, int height, cudaStream_t stream) {
  if (bits < 0 || size < 0 || height < 1 || height > 22 ||
      (long long)n_words * 32 < (long long)bits + 32 ||
      reinterpret_cast<uintptr_t>(tab) % 16)
    return (int)cudaErrorInvalidValue;
  if (height <= SHARED_HEIGHT) {
    const int shared = (((1 << height) + 7) >> 3) * 16;
    if (shared > 48 * 1024) {
      const cudaError_t err =
          ws::allow_shared((const void*)onethread_kernel<true>, opted_in);
      if (err != cudaSuccess) return (int)err;
    }
    onethread_kernel<true><<<1, 1, shared, stream>>>(
        words, tab, out, n, n_words, bits, size, height);
  } else {
    onethread_kernel<false><<<1, 1, 0, stream>>>(
        words, tab, out, n, n_words, bits, size, height);
  }
  return (int)cudaGetLastError();
}
