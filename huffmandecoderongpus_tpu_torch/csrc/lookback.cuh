// A decoupled look-back over the row blocks of a tile of lanes, for the
// encoder's E1 (e1_pack.cu) and E2 (e2_compact.cu).
//
// A block owns a tile of up to 32 lanes and a range of their rows, and
// needs, for each lane, a sum over the rows before its range: E1 the code
// bits, E2 the valid flags.  Each block publishes its own sums (an
// aggregate), reads its predecessors' (the blocks of the same tile with
// the rows before), a window of 32 at a time, up to the nearest one that
// has published an inclusive sum, and publishes its own inclusive sum:
// nothing before its rows is read again.
//
// Blocks take their work from an atomic ticket, tile-major: tile b / S,
// row block b % S.  A block waits only on blocks of earlier tickets, which
// have started, so the look-back always progresses, co-resident or not.
// The state is one int32 buffer: a 64-bit word (the call's epoch above, its
// tickets below), a flag a block, and an aggregate and an inclusive sum a
// (block, lane).  A flag holds the epoch of the call that wrote it, so an
// older call's flags read as not ready, and the block that takes a call's
// last ticket advances the epoch and clears the tickets in the same word:
// the next call needs no reset and no other launch (K2's scheme,
// k2_compose.cu).  The wrappers hold a state per device and stream, zeroed
// once (ops/lookback.py).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr int LANES = 32;
enum : int { NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

struct State {
  unsigned long long* ticket;
  int* flags;  // [cap]
  int* agg;    // [cap][LANES]
  int* inc;    // [cap][LANES]
};

// The state in `buf`, laid out for `cap` blocks (ops/lookback.py
// state_words: 2 + cap + 2 * LANES * cap int32 words, 8-byte aligned).
__device__ __forceinline__ State state_of(int* buf, int cap) {
  return State{reinterpret_cast<unsigned long long*>(buf), buf + 2,
               buf + 2 + cap, buf + 2 + cap + (size_t)cap * LANES};
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A flag: the epoch of the call that wrote it (mod 2^30), then its status.
__device__ __forceinline__ int flag_of(unsigned epoch, int status) {
  return (int)((epoch & 0x3FFFFFFFu) << 2) | status;
}

// One thread: this block's ticket (its work) and the call's epoch; the
// block that takes the last of `blocks` tickets starts the next epoch.
__device__ __forceinline__ void take_ticket(State s, int blocks, int* work,
                                            unsigned* epoch) {
  const unsigned long long v = atomicAdd(s.ticket, 1ull);
  *epoch = (unsigned)(v >> 32);
  *work = (int)(unsigned)v;
  if (*work == blocks - 1)
    atomicExch(s.ticket, (unsigned long long)(*epoch + 1) << 32);
}

// One warp: publish lane `lane`'s value `v` for block `b` with `status`.
__device__ __forceinline__ void publish(State s, int b, int v, int lane,
                                        unsigned epoch, int status) {
  (status == INCLUSIVE ? s.inc : s.agg)[(size_t)b * LANES + lane] = v;
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(&s.flags[b], flag_of(epoch, status));
}

// One warp: lane `lane`'s sum over blocks [first, b) (its predecessors in
// the tile), read back from b - 1 in windows of 32 up to the nearest
// inclusive sum.
__device__ __forceinline__ int look_back(State s, int first, int b, int lane,
                                         unsigned epoch) {
  int sum = 0;
  for (int hi = b - 1; hi >= first; hi -= 32) {
    const int jj = hi - lane;
    int f;
    do {  // every predecessor in the window has published something
      f = INCLUSIVE;  // a lane before the tile's first block stops the walk
      if (jj >= first) {
        const int w = ld_acquire(&s.flags[jj]);
        f = (w & ~3) == flag_of(epoch, 0) ? (w & 3) : NOT_READY;
      }
    } while (__any_sync(0xFFFFFFFFu, f == NOT_READY));
    const unsigned inc = __ballot_sync(0xFFFFFFFFu, f == INCLUSIVE);
    const int n = inc ? __ffs(inc) : 32;  // up to and with the inclusive
    for (int q = 0; q < n && hi - q >= first; ++q) {
      const int* src = (inc >> q) & 1u ? s.inc : s.agg;
      sum += __ldcg(src + (size_t)(hi - q) * LANES + lane);
    }
    if (inc) break;
  }
  return sum;
}

// One warp: block b (row block j of the tile whose first block is `first`)
// publishes its lane values `v`, looks back, and publishes its inclusive
// sums; returns lane `lane`'s sum over the rows before the block.
__device__ __forceinline__ int carry(State s, int first, int b, int v,
                                     int lane, unsigned epoch) {
  if (b == first) {
    publish(s, b, v, lane, epoch, INCLUSIVE);
    return 0;
  }
  publish(s, b, v, lane, epoch, AGGREGATE);
  const int before = look_back(s, first, b, lane, epoch);
  publish(s, b, before + v, lane, epoch, INCLUSIVE);
  return before;
}

}  // namespace lookback
