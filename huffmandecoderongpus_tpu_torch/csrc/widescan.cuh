// Shared device helpers for the chunked wide-lane kernels (K1, K3).
//
// The quad table (2*NS rows of 128 uint32 words, see
// ops/widescan.py pack_quad_tables) is staged in shared memory: row
// b0*NS + (node >> 7), column node & 127, 16-bit half b1 is the entry for
// the 2-bit chunk (b0, b1) read in state `node`.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ws {

constexpr int CELL = 4;           // md-slots per int32 cell / u8 nibble
constexpr int MAX_NS = 8;         // 1023 states / 128
constexpr int TAB_WORDS = 2 * MAX_NS * 128;
constexpr int MAX_SEGH = 16;      // chunk rows per segment: SEG <= 32
constexpr int MAX_NL = 8;         // leaders: one per residue mod md, md <= 8
constexpr int MAX_CH = 127;       // candidate chains: HP <= 128

struct Step {
  int emit;  // a codeword completed in this chunk
  int pos;   // on its second bit
  int sym;   // the symbol (0 unless emit)
  int node;  // post-chunk state
};

// 16-bit entry of state `node` for chunk bits (b0, b1).
__device__ __forceinline__ uint32_t quad_entry(const uint32_t* tab, int NS,
                                               int node, int b0, int b1) {
  uint32_t w = tab[(b0 * NS + (node >> 7)) * 128 + (node & 127)];
  return (w >> (b1 << 4)) & 0xFFFFu;
}

// Decode an entry: compact layout (NS == 1) sym<<8 | emit<<7 | post_state,
// wide layout (NS > 1) emit<<15 | sym<<1 | pos, or the bare state.  `rc` is
// the root child of the chunk's second bit (the wide layout's post state
// after an emission on the first bit).
__device__ __forceinline__ Step decode_entry(uint32_t e, int NS, int rc) {
  Step s;
  if (NS > 1) {
    s.emit = (e >> 15) & 1;
    s.pos = e & 1;
    s.sym = s.emit ? (int)((e >> 1) & 0xFF) : 0;
    s.node = s.emit ? (1 - s.pos) * rc : (int)(e & 0x7FFF);
  } else {
    s.emit = (e >> 7) & 1;
    s.node = e & 127;
    s.sym = (int)(e >> 8);
    s.pos = s.node == 0 ? s.emit : 0;
  }
  return s;
}

// Stage the quad table into shared memory (all threads of the block).
__device__ __forceinline__ void load_table(uint32_t* tab_s,
                                           const uint32_t* tab, int NS) {
  for (int i = threadIdx.x; i < 2 * NS * 128; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
}

// Bits [base, base + 64) of lane g from the halo'd word matrix
// wmat (steps_w, G), with base a multiple of 32; rows past the matrix are 0.
__device__ __forceinline__ uint64_t load_bits64(const int32_t* wmat, int G,
                                                int steps_w, int base, int g) {
  int w = base >> 5;
  uint64_t lo = w < steps_w ? (uint32_t)wmat[(size_t)w * G + g] : 0u;
  uint64_t hi = w + 1 < steps_w ? (uint32_t)wmat[(size_t)(w + 1) * G + g] : 0u;
  return lo | (hi << 32);
}

}  // namespace ws

extern "C" const char* ws_error_string(int code);
