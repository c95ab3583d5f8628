// S2, the low levels: doubling levels 1..m of a tile in shared memory, in
// one launch, writing only the kept (even) levels 2, 4, ..., m.
//
// Replaces no TPU kernel: the JAX pipeline (huffmandecoderongpus_tpu/ops/
// speculative.py speculative_decode_xla) runs `double` (:122-127) as XLA
// ops, once a level, and keeps every even level (:129-140).  For every bit
// offset b, with s the level below (the span of 2^(k-1) codewords from b,
// or -1):
//
//   t = b + s[b];  w = s[t]
//   s'[b] = s[b] + w  if s[b] != -1, t < bits, w != -1 and t + w <= bits
//         = -1        otherwise
//
// A block owns the offsets [lo, lo + tile).  Level j at b reads level j - 1
// at b and at t, and t - b is at most the span of 2^(j-1) codewords of at
// most `height` bits (step0 <= height, S1's table), so level j over the
// first n_j = tile + (2^m - 2^j) * height offsets needs level j - 1 over
// n_(j-1): the block stages step0 over tile + (2^m - 1) * height offsets
// (the tile and its right halo, cut at `bits`) and doubles m times in
// shared memory, the range shrinking level by level to the tile itself at
// level m.  Two int16 buffers of the span rounded up to 8 offsets, read
// one and written the other a level, one barrier a level.  Every level j < m past the tile is scratch that no one
// writes out: only the even levels' tile part goes to device memory, each
// output offset written by one block.  Each level is int16 in shared
// memory and out: the plan takes m with 2^m * height <= 32767, so every
// level up to m fits (the JAX keep() rule, :131).
//
// The launch plan (ops/spec_tile.py s2_plan, mirrored by spec_tile_plan_ok
// here) takes the largest even m below the top kept level whose halo is
// at most a quarter of the tile (the halo's recompute, summed over the
// levels, then costs at most a quarter of the tile's work), the tile that
// fills half an SM's shared memory (two blocks of 512 threads an SM, so
// that one block's barriers and staging overlap the other's levels) cut
// to even waves on the card's SMs; the launcher refuses any other plan.
// With one block of 1,024 threads an SM on the whole 227 KB (m 10 at
// height 9) every barrier and the staging left the SM idle, which cost
// more than the pair launch that the smaller m adds.
//
// What bounds it on the H100: bytes, step0 read once (and the halo again)
// and m / 2 int16 levels written once; the doubling itself is shared
// memory traffic (a coalesced read, a gather whose addresses rise with b,
// a write) and a barrier a level.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "widescan.cuh"

namespace {

constexpr int THREADS = 512;
// blocks an SM: one block's barriers overlap the other's work
constexpr int BLOCKS_AN_SM = 2;
// pairs of offsets a thread has in flight
constexpr int U = 2;
// kept levels a launch writes: 2, 4, ..., 2 * MAX_OUT
constexpr int MAX_OUT = 8;

struct Outs {
  int16_t* p[MAX_OUT];
};

std::atomic<unsigned> opted_in{0};

inline long long round8(long long x) {
  return (x + 7) & ~7LL;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) spec_tile_kernel(
    const int16_t* __restrict__ step0, Outs outs, int bits, int height,
    int m, int tile, int span) {
  extern __shared__ __align__(16) int16_t buf[];
  int16_t* src = buf;
  int16_t* dst = buf + span;
  const long long lo = (long long)blockIdx.x * tile;
  const long long rest = bits - lo;  // offsets from lo to the stream's end
  const int halo = ((1 << m) - 1) * height;
  const int n0 = (int)min((long long)tile + halo, rest);
  const int16_t* in = step0 + lo;
  if ((reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    const int nv = n0 >> 3;
    for (int i = threadIdx.x; i < nv; i += THREADS)
      reinterpret_cast<uint4*>(src)[i] =
          __ldg(reinterpret_cast<const uint4*>(in) + i);
    for (int i = nv * 8 + threadIdx.x; i < n0; i += THREADS) src[i] = in[i];
  } else {
    for (int i = threadIdx.x; i < n0; i += THREADS) src[i] = in[i];
  }
  __syncthreads();
  const int keep = (int)min((long long)tile, rest);
  int n_prev = n0;
  for (int j = 1; j <= m; ++j) {
    const int n =
        (int)min((long long)tile + ((1 << m) - (1 << j)) * height, rest);
    int16_t* out = (j & 1) ? nullptr : outs.p[j / 2 - 1] + lo;
    // a thread takes two adjacent offsets (one 4-byte read and write),
    // U pairs a trip with all their reads before any write.  An offset at
    // or past n is taken as -1 (so t never leaves [0, n_prev)) and writes
    // -1 that nothing reads: where n is odd, src[n] was never staged or
    // computed, and holds whatever the shared memory held (the buffers
    // hold span >= n + 1, span being a multiple of 8)
    for (int i0 = 2 * threadIdx.x; i0 < n; i0 += 2 * THREADS * U) {
      int s[2 * U], r[2 * U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 2 * THREADS * u;
        uint32_t x =
            i < n ? *reinterpret_cast<const uint32_t*>(src + i) : ~0u;
        if (i + 1 >= n) x |= 0xFFFF0000u;
        s[2 * u] = (int16_t)(x & 0xFFFFu);
        s[2 * u + 1] = (int16_t)(x >> 16);
      }
#pragma unroll
      for (int k = 0; k < 2 * U; ++k) {
        const int i = i0 + 2 * THREADS * (k / 2) + (k & 1);
        const int t = i + s[k];  // < n_prev while step0 <= height
        const bool read = s[k] != -1 && t < rest;
        const int w = read ? src[min(t, n_prev - 1)] : -1;
        r[k] = (read && w != -1 && t + w <= rest) ? s[k] + w : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 2 * THREADS * u;
        if (i >= n) break;
        const uint32_t y = (uint32_t)(uint16_t)r[2 * u] |
                           ((uint32_t)(uint16_t)r[2 * u + 1] << 16);
        *reinterpret_cast<uint32_t*>(dst + i) = y;
        if (out != nullptr) {
          if (i + 1 < keep)
            *reinterpret_cast<uint32_t*>(out + i) = y;
          else if (i < keep)
            out[i] = (int16_t)r[2 * u];
        }
      }
    }
    __syncthreads();
    int16_t* x = src;
    src = dst;
    dst = x;
    n_prev = n;
  }
}

}  // namespace

// The plan's rules (ops/spec_tile.py s2_plan_ok mirrors them).
static bool spec_tile_plan_ok(int bits, int height, int m, int tile,
                              int threads, int shared) {
  if (bits < 1 || height < 1 || height > 22 || m < 2 || m % 2 ||
      m > 2 * MAX_OUT || (1LL << m) * height > 32767 || tile < 8 ||
      tile % 8 || threads != THREADS)
    return false;
  const long long halo = ((1LL << m) - 1) * height;
  const long long span = round8(std::min((long long)tile + halo,
                                         (long long)bits));
  return 4 * halo <= tile && shared == 4 * span &&
         shared <= (228 * 1024) / BLOCKS_AN_SM - 1024;
}

// step0 (bits,) int16; outs: a host array of the m / 2 kept levels' device
// pointers (levels 2, 4, ..., m), each (bits,) int16
extern "C" int ws_spec_tile(const int16_t* step0, const long long* outs,
                            int n_out, int bits, int height, int m, int tile,
                            int threads, int shared, cudaStream_t stream) {
  if (!spec_tile_plan_ok(bits, height, m, tile, threads, shared) ||
      n_out != m / 2)
    return (int)cudaErrorInvalidValue;
  Outs o{};
  for (int i = 0; i < n_out; ++i)
    o.p[i] = reinterpret_cast<int16_t*>(outs[i]);
  if (shared > 48 * 1024) {
    const cudaError_t err =
        ws::allow_shared((const void*)spec_tile_kernel, opted_in);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)(((long long)bits + tile - 1) / tile);
  spec_tile_kernel<<<blocks, THREADS, shared, stream>>>(
      step0, o, bits, height, m, tile, shared / 4);
  return (int)cudaGetLastError();
}
