// Shared device helpers for the wide-lane kernels (K1, K3 and their 1-bit
// versions) and the lane-DFA scans.
//
// The quad table (2*NS rows of 128 uint32 words, see
// ops/widescan.py pack_quad_tables) is staged in shared memory: row
// b0*NS + (node >> 7), column node & 127, 16-bit half b1 is the entry for
// the 2-bit chunk (b0, b1) read in state `node`.  The 1-bit kernels' pair
// table (NS rows, pack_pair_table) holds one word per state: word `node`,
// 16-bit half b is the entry for bit b.
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
// the lane-DFA scans' fused table (ops/lanedfa.py LaneDFA.entry, padded)
constexpr int EMIT_BIT = 1 << 10;
constexpr int STATE_MASK = (1 << 10) - 1;
constexpr int LANEDFA_TAB_WORDS = 2048;  // 1023 states, two entries each

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

struct Bit {
  int emit;  // a codeword completed on this bit
  int sym;   // the symbol (0 unless emit)
  int node;  // state after the bit (the root after an emission)
};

// 16-bit pair-table entry of state `node` for bit b.
__device__ __forceinline__ uint32_t pair_entry(const uint32_t* tab, int node,
                                               int b) {
  return (tab[node] >> (b << 4)) & 0xFFFFu;
}

// Decode a pair entry: compact layout (NS == 1) sym<<8 | emit<<7 | next,
// wide layout (NS > 1) emit<<15 | sym<<1, or the bare state.
__device__ __forceinline__ Bit e1_fields(uint32_t e, int NS) {
  Bit s;
  if (NS > 1) {
    s.emit = (e >> 15) & 1;
    s.sym = s.emit ? (int)((e >> 1) & 0xFF) : 0;
    s.node = s.emit ? 0 : (int)(e & 0x7FFF);
  } else {
    s.emit = (e >> 7) & 1;
    s.sym = (int)(e >> 8);
    s.node = e & 127;
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

// K1's epilogue, shared by both K1 kernels: lane g's rows of the
// (HP, G) cnt/exit/merge-row maps.  Row 0 is the main chain (count cnt0,
// exit exit0); row r = c + 1 is candidate chain c, with its raw count
// ccnt[c], its record crec[c] (row << 3 | kind << 1 | resolved; kind 0
// late exit or stream end, 1 merged with the main chain, 2 merged with
// its leader) and ccum[c].  Leaders are chains c < NL; follower row r
// composes through leader (r - 1) % md.  Rows past CH are padding.
__device__ __forceinline__ void write_maps(
    int32_t* cntmap, int32_t* exmap, int32_t* mrowmap, int G, int g,
    int cnt0, int exit0, const int* ccnt, const int* crec, const int* ccum,
    int CH, int NL, int HP, int md, int B, int steps) {
  cntmap[g] = cnt0;
  exmap[g] = exit0;
  mrowmap[g] = -1;
  int Ltot[MAX_NL], Lex[MAX_NL], Lmrow[MAX_NL];
  for (int l = 0; l < NL; ++l) {
    const int rec = crec[l], res = rec & 1, mrg = (rec >> 1) & 1;
    const int mrow = rec >> 3;
    Ltot[l] = res ? (mrg ? cnt0 - ccum[l] : ccum[l]) : ccnt[l];
    Lex[l] = res ? (mrg ? exit0 : mrow + 1 - B) : 0;
    Lmrow[l] = (res && mrg) ? mrow : steps;
    const size_t o = (size_t)(l + 1) * G + g;
    cntmap[o] = Ltot[l];
    exmap[o] = Lex[l];
    mrowmap[o] = Lmrow[l];
  }
  for (int r = NL + 1; r <= CH; ++r) {
    const int c = r - 1, lp = (r - 1) % md;
    const int rec = crec[c], kind = (rec >> 1) & 3, mrow = rec >> 3;
    int tot, ex, mro;
    if (!(rec & 1)) {  // unresolved: the raw count
      tot = ccnt[c];
      ex = 0;
      mro = steps;
    } else if (kind == 1) {  // merged with the main chain
      tot = cnt0 - ccum[c];
      ex = exit0;
      mro = mrow;
    } else if (kind == 2) {  // merged with its leader
      tot = Ltot[lp] - ccum[c];
      ex = Lex[lp];
      mro = mrow > Lmrow[lp] ? mrow : Lmrow[lp];
    } else {  // late exit or stream end
      tot = ccum[c];
      ex = mrow + 1 - B;
      mro = steps;
    }
    const size_t o = (size_t)r * G + g;
    cntmap[o] = tot;
    exmap[o] = ex;
    mrowmap[o] = mro;
  }
  for (int r = CH + 1; r < HP; ++r) {
    const size_t o = (size_t)r * G + g;
    cntmap[o] = 0;
    exmap[o] = 0;
    mrowmap[o] = steps;
  }
}

}  // namespace ws

extern "C" const char* ws_error_string(int code);
