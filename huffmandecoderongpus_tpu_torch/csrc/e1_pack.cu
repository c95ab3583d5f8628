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
// carrying the accumulators across steps in VMEM scratch.  Here a sub-step
// depends on the ones before it only through P, the lane's bits so far:
// its accumulator holds bits [16 * floor(P / 16), P) of the lane's stream.
// So a lane's rows are cut into pieces and each piece starts from P alone:
//
//   a block owns a tile of 32 lanes (a warp's lane each: a warp's row store
//   is 128 bytes of gran and 32 of gval) and a range of RB symbol rows,
//   cut into NC chunks of RB / NC rows, one warp a chunk;
//   0. the block stages its RB rows in shared memory, 16 lanes a load
//      where the plan allows (one round of loads in flight, not one a row);
//   0'. the block takes its (tile, row block) by an atomic ticket,
//      tile-major, so that it waits only on blocks that have started;
//   1. each thread sums the code lengths of its chunk (a table lookup a
//      symbol, all independent); a warp takes the lanes' bits before the
//      block from a decoupled look-back over the tile's earlier row blocks
//      (lookback.cuh: each block publishes its own sums, then its
//      inclusive ones);
//   2. a scan over the chunks gives each chunk's P;
//   3. the chunk's first granule is rebuilt from P & 15 and the codes of
//      the last real symbols before the chunk (at most 15 of them: a real
//      symbol's code has at least 1 bit; pad rows have none);
//   4. the chunk's 2 * RB / NC sub-steps run as in the TPU kernel, in
//      registers on the staged rows, writing every row; the chunk that
//      holds row K-1 flushes.
//
// ops/e1_pack.py e1_plan picks the load width, NC and RB from the lanes, K
// and the card's SM count, so that the grid fills the card at G = 512 as
// at G = 8192; the launcher refuses any other plan (e1_plan_ok).
//
// What bounds it on the H100: bytes, the (2K, G) gran and gval rows it
// writes (5 bytes a sub-step, 11 times the symbols it reads).  The thread a
// lane it replaces ran 2K dependent sub-steps with at most 8,192 threads
// (2 warps an SM at G = 8192, 8 SMs busy at G = 512), each row's symbol a
// load on the chain.  Here a thread's chain is 2 * RB / NC sub-steps on
// shared memory and the grid holds about two blocks of 8 warps an SM.  On
// small inputs (G = 512) what remains is latency: a block's rounds of
// loads (tables, rows, the look-back's sums, the symbols before a chunk)
// in series.  A block re-reading its lanes' earlier rows in place of the
// look-back was timed as a variant and was no faster.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

using lookback::carry;
using lookback::take_ticket;

namespace {

constexpr int GRAN = 16;
constexpr int HALF = 13;
constexpr uint32_t HALF_MASK = (1u << HALF) - 1;
constexpr int LANES = 32;       // a tile: one lane a thread of each warp
constexpr int MAX_CHUNKS = 32;  // warps a block
constexpr int MAX_ROWS = 1024;  // symbol rows a block stages (32 KB)
constexpr int UNROLL = 4;       // vector loads a thread has in flight

struct Acc {
  uint32_t acc, nb;

  // append one half-code table entry; write sub-step row `o`
  __device__ __forceinline__ void append(uint32_t ent, int32_t* gran,
                                         uint8_t* gval, size_t o) {
    acc |= (ent & HALF_MASK) << nb;
    nb += ent >> HALF;
    const bool emit = nb >= GRAN;  // nb < 16 before, <= 28 after
    gran[o] = (int32_t)(acc & 0xFFFFu);
    gval[o] = emit;
    if (emit) {
      acc >>= GRAN;
      nb -= GRAN;
    }
  }
};

// Symbol s's code length, from the lengths packed a byte each four to a
// word (64 words over 32 banks: a warp's lookups conflict at most 2-way).
// A code is at most 26 bits (the pack tables' halves are at most 13).
__device__ __forceinline__ int code_len(const uint32_t* len4, uint32_t s) {
  return (len4[s >> 2] >> (8 * (s & 3))) & 0xFFu;
}

// V neighbouring symbols of a row (V = 16, 4 or 1), one load, zero when
// `in` is false.
template <int V>
__device__ __forceinline__ uint4 load_row(const uint8_t* p, bool in) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (in) {
    if constexpr (V == 16)
      r = __ldg(reinterpret_cast<const uint4*>(p));
    else if constexpr (V == 4)
      r.x = __ldg(reinterpret_cast<const uint32_t*>(p));
    else
      r.x = __ldg(p);
  }
  return r;
}

// Stage the tile's rows [k0, k0 + rows) in sym_s (32 bytes a row): the
// whole block, V lanes of a row a load, UNROLL loads a thread in flight.
// Lanes at or past G are staged as 0 (G % V == 0: a load is all in or
// all out).
template <int V>
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ data,
                                           int G, int g0, int k0, int rows,
                                           uint8_t* sym_s) {
  constexpr int RPV = LANES / V;  // loads a row
  const int items = rows * RPV;
  for (int i0 = threadIdx.x; i0 < items; i0 += UNROLL * blockDim.x) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x, r = i / RPV, col = (i % RPV) * V;
      v[u] = load_row<V>(data + (size_t)(k0 + r) * G + g0 + col,
                         i < items && g0 + col < G);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= items) break;
      uint8_t* at = sym_s + (i / RPV) * LANES + (i % RPV) * V;
      if constexpr (V == 16)
        *reinterpret_cast<uint4*>(at) = v[u];
      else if constexpr (V == 4)
        *reinterpret_cast<uint32_t*>(at) = v[u].x;
      else
        *at = (uint8_t)v[u].x;
    }
  }
}

// A block's shared memory besides its staged rows.
struct E1Shared {
  uint32_t lo[256], hi[256], len4[64];
  int pre[LANES], nv[LANES], own[MAX_CHUNKS][LANES];
  int work;
  unsigned epoch;
};

template <int V>
__device__ __forceinline__ void e1_block(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ nval,
    int32_t* __restrict__ gran, uint8_t* __restrict__ gval,
    int32_t* __restrict__ cnt, int32_t* __restrict__ bits,
    lookback::State state, int K, int G, int NC, int RB, int S,
    uint8_t* sym_s, E1Shared& sh) {
  const uint32_t* lo_s = sh.lo;
  const uint32_t* hi_s = sh.hi;
  const uint32_t* len4 = sh.len4;
  const int t = threadIdx.x;
  const int l = t & (LANES - 1), c = t / LANES;

  // 0. the block's work by ticket; the tables; its rows in shared memory
  if (t == 0) take_ticket(state, gridDim.x, &sh.work, &sh.epoch);
  for (int i = t; i < 256; i += blockDim.x) {
    sh.lo[i] = (uint32_t)lo[i];
    sh.hi[i] = (uint32_t)hi[i];
  }
  if (t < 64) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w |= (((uint32_t)lo[4 * t + b] >> HALF) +
            ((uint32_t)hi[4 * t + b] >> HALF))
           << (8 * b);
    sh.len4[t] = w;
  }
  __syncthreads();
  const int work = sh.work, tile = work / S, j = work - tile * S;
  const int g0 = tile * LANES, g = g0 + l;
  const bool live = g < G;
  const int k0 = j * RB, RC = RB / NC;
  const int kc = min(k0 + c * RC, K), ke = min(kc + RC, K);
  stage_rows<V>(data, G, g0, k0, min(RB, K - k0), sym_s);
  if (t < LANES) sh.nv[t] = g0 + t < G ? nval[g0 + t] : 0;
  __syncthreads();
  const int nv = sh.nv[l];

  // 1. my chunk's code bits; then, a warp, the lanes' bits before the
  // block from the look-back over the tile's earlier row blocks
  int own = 0;
  for (int k = kc; k < min(ke, nv); ++k)
    own += code_len(len4, sym_s[(k - k0) * LANES + l]);
  sh.own[c][l] = own;
  __syncthreads();
  if (c == 0) {
    int sum = 0;
    for (int q = 0; q < NC; ++q) sum += sh.own[q][l];
    sh.pre[l] = carry(state, tile * S, work, sum, l, sh.epoch);
  }
  __syncthreads();
  if (!live) return;

  // 2. my chunk's first bit
  int P = sh.pre[l];
  for (int q = 0; q < c; ++q) P += sh.own[q][l];

  // 3. the partial granule before it: bits [P - need, P), from the codes of
  // the last real symbols before the chunk, earliest in the low bits (rows
  // of the block from shared memory, earlier ones from device memory)
  const uint32_t need = P & (GRAN - 1);
  uint32_t acc = 0;
  if (need) {
    uint64_t w = 0;
    uint32_t have = 0;
    for (int k = min(kc, nv) - 1; have < need && k >= 0; k -= 4) {
      uint8_t sym[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = k - u;
        sym[u] = kk >= k0  ? sym_s[(kk - k0) * LANES + l]
                 : kk >= 0 ? __ldg(&data[(size_t)kk * G + g])
                           : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (have >= need || k - u < 0) break;
        const uint32_t a = lo_s[sym[u]], b = hi_s[sym[u]];
        const uint32_t la = a >> HALF, n = la + (b >> HALF);
        w = (w << n) | (a & HALF_MASK) | ((uint64_t)(b & HALF_MASK) << la);
        have += n;
      }
    }
    acc = (uint32_t)(w >> (have - need));
  }

  // 4. the chunk's sub-steps, every row written
  Acc a{acc, need};
  for (int k = kc; k < ke; ++k) {
    const uint32_t sym = sym_s[(k - k0) * LANES + l];
    const bool valid = k < nv;
    const size_t o = (size_t)(2 * k) * G + g;
    a.append(valid ? lo_s[sym] : 0u, gran, gval, o);
    a.append(valid ? hi_s[sym] : 0u, gran, gval, o + G);
  }
  if (ke == K && kc < ke) {
    // flush: the residual bits (nb < 16) overwrite the last row
    const size_t last = (size_t)(2 * K - 1) * G + g;
    const int total = P + own;
    gran[last] = (int32_t)(a.acc & 0xFFFFu);
    gval[last] = a.nb > 0;
    cnt[g] = (total + GRAN - 1) / GRAN;
    bits[g] = total;
  }
}

__global__ void __launch_bounds__(LANES* MAX_CHUNKS) e1_pack_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ nval,
    int32_t* __restrict__ gran, uint8_t* __restrict__ gval,
    int32_t* __restrict__ cnt, int32_t* __restrict__ bits, int* state,
    int cap, int K, int G, int vec, int NC, int RB, int S) {
  extern __shared__ __align__(16) uint8_t e1_sym[];
  __shared__ E1Shared sh;
  const lookback::State st = lookback::state_of(state, cap);
  if (vec == 16)
    e1_block<16>(data, lo, hi, nval, gran, gval, cnt, bits, st, K, G, NC, RB,
                 S, e1_sym, sh);
  else if (vec == 4)
    e1_block<4>(data, lo, hi, nval, gran, gval, cnt, bits, st, K, G, NC, RB,
                S, e1_sym, sh);
  else
    e1_block<1>(data, lo, hi, nval, gran, gval, cnt, bits, st, K, G, NC, RB,
                S, e1_sym, sh);
}

}  // namespace

// The launcher's check of an E1 plan (rules in ops/e1_pack.py e1_plan): a
// tile of 32 lanes read 16, 4 or 1 of them a load (G and the symbols'
// address a multiple of it), NC chunks of RB / NC rows (a warp each), at
// most MAX_ROWS rows staged (RB bytes a lane of dynamic shared memory), S
// row blocks that cover K, a grid of ceil(G / 32) * S blocks, and a
// look-back state for at least as many.
static bool e1_plan_ok(const void* data, const int* state, int cap, int K,
                       int G, int lanes, int vec, int NC, int RB, int S,
                       int threads, int shared, int blocks) {
  if (K < 1 || G < 1 || lanes != LANES || NC < 1 || NC > MAX_CHUNKS ||
      threads != LANES * NC || RB < NC || RB % NC || RB > MAX_ROWS ||
      S < 1 || shared != RB * LANES ||
      (vec != 1 && vec != 4 && vec != 16) || G % vec ||
      (uintptr_t)data % vec || (uintptr_t)state % 8)
    return false;
  const long long tiles = (G + LANES - 1) / LANES;
  return (long long)(S - 1) * RB < K && (long long)S * RB >= K &&
         tiles * S == blocks && blocks <= cap;
}

extern "C" int ws_e1_pack(const uint8_t* data, const int32_t* lo,
                          const int32_t* hi, const int32_t* nval,
                          int32_t* gran, uint8_t* gval, int32_t* cnt,
                          int32_t* bits, int* state, int cap, int K, int G,
                          int lanes, int vec, int NC, int RB, int S,
                          int threads, int shared, int blocks,
                          cudaStream_t stream) {
  if (!e1_plan_ok(data, state, cap, K, G, lanes, vec, NC, RB, S, threads,
                  shared, blocks))
    return (int)cudaErrorInvalidValue;
  e1_pack_kernel<<<blocks, threads, shared, stream>>>(
      data, lo, hi, nval, gran, gval, cnt, bits, state, cap, K, G, vec, NC,
      RB, S);
  return (int)cudaGetLastError();
}
