// Shared device helpers for the wide-lane kernels (K1, K3 and their 1-bit
// versions) and the lane-DFA scans: the per-lane bodies of K1
// (k1_scan2_lane) and K3 (k3_fix2_lane), which the separate kernels run,
// and K2's three steps and K4's block-wide body (k4_block), which the
// fused one-shot kernel (oneshot.cu) runs too.
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
constexpr int K2_NE = 128;        // K2: entry offsets per map
constexpr int K2_MAX_GROUPS = 256;  // K2: group maps its scan step stages
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

// Word w of lane g's halo'd bits (bit j of the lane is bit j % 32 of word
// j / 32), from the halo'd word matrix wmat (steps_w, G); words past the
// matrix are 0.  Both word sources are read-only for the whole launch.
struct WmatWords {
  const int32_t* wmat;
  int G, steps_w;
  __device__ __forceinline__ uint32_t operator()(int w, int g) const {
    return w < steps_w ? (uint32_t)__ldg(&wmat[(size_t)w * G + g]) : 0u;
  }
};

// The same words straight from the (G, BW) lane words: word w >= BW is
// word w % BW of lane g + w / BW (0 past the last lane), which is what
// ops/widescan.py words_matrix puts in row w.
struct LaneWords {
  const int32_t* words;
  int G, BW, steps_w;
  __device__ __forceinline__ uint32_t operator()(int w, int g) const {
    if (w >= steps_w) return 0u;
    const int lane = g + w / BW;
    return lane < G ? (uint32_t)__ldg(&words[(size_t)lane * BW + w % BW])
                    : 0u;
  }
};

// Bits [base, base + 64) of lane g, with base a multiple of 32.
template <class Words>
__device__ __forceinline__ uint64_t load_bits64(const Words& words, int base,
                                                int g) {
  const int w = base >> 5;
  return (uint64_t)words(w, g) | ((uint64_t)words(w + 1, g) << 32);
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

// K1 (k1_scan2.cu) for lane g, whose stream limit is `lim`: walks every
// segment of the lane, writes its (cells_p, G) sym/val cells and its rows
// of the (HP, G) maps.  tab_s is the quad table in shared memory.
template <class Words>
__device__ __forceinline__ void k1_scan2_lane(
    const Words& words, const uint32_t* tab_s, int lim, int32_t* sym,
    uint8_t* val, int32_t* cntmap, int32_t* exmap, int32_t* mrowmap, int G,
    int g, int B, int H, int steps, int steps_p, int SEG, int md, int C0,
    int C1, int NS) {
  const int CH = H - 1 > 1 ? H - 1 : 1;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const int NL = md < CH ? md : CH;
  const int SEGH = SEG / 2;
  const int cells_seg = SEG / (md * CELL);
  const int S = steps_p / SEG;

  // main chain (entry offset 0)
  int node0 = 0, cnt0 = 0, done0 = 0, exit0 = 0;
  // candidate chain of entry offset r lives at index r - 1: leaders are
  // offsets 1..NL, followers NL+1..CH
  int cnode[MAX_CH], ccnt[MAX_CH], crec[MAX_CH], ccum[MAX_CH];
  for (int c = 0; c < CH; ++c) cnode[c] = ccnt[c] = crec[c] = ccum[c] = 0;
  int unresolved = CH;
  // per-segment scratch: chunk bits, the main chain's post-chunk state (-1
  // once it has exited) and count, the leaders' state (-1 once stopped)
  // and count
  int chunk[MAX_SEGH], nscr[MAX_SEGH], cscr[MAX_SEGH];
  int ldr[MAX_SEGH][MAX_NL], lcn[MAX_SEGH][MAX_NL];

  for (int s = 0; s < S; ++s) {
    const int base = s * SEG;
    const int cell0 = s * cells_seg;
    if (lim <= base) {  // the lane's stream ended before this segment
      for (int c = 0; c < cells_seg; ++c) {
        sym[(size_t)(cell0 + c) * G + g] = 0;
        val[(size_t)(cell0 + c) * G + g] = 0;
      }
      continue;
    }
    const int wb = base & ~31;
    const uint64_t bits = load_bits64(words, wb, g);
    for (int i = 0; i < SEGH; ++i)
      chunk[i] = (int)((bits >> (base - wb + 2 * i)) & 3);
    const bool live = unresolved > 0;

    // ---- main chain: cell-packed emissions, exit offset ----------------
    for (int cc = 0; cc < cells_seg; ++cc) {
      uint32_t cacc = 0, nacc = 0;
      for (int k = 0; k < 2 * md; ++k) {
        const int i = cc * 2 * md + k;
        const int jbit = base + 2 * i;
        const int b0 = chunk[i] & 1, b1 = chunk[i] >> 1;
        const int rc = b1 ? C1 : C0;
        const uint32_t e =
            lim > jbit ? quad_entry(tab_s, NS, node0, b0, b1) : 0u;
        const Step st = decode_entry(e, NS, rc);
        node0 = st.node;
        const int emit = done0 ? 0 : st.emit;
        if (emit && jbit + st.pos + 1 >= B) {
          exit0 = jbit + st.pos + 1 - B;
          done0 = 1;
        }
        cnt0 += emit;
        if (live) {
          nscr[i] = done0 ? -1 : node0;
          cscr[i] = cnt0;
        }
        if (emit) {  // slot (jbit + pos) / md, counted from the cell start
          const int sl = (2 * k + st.pos) / md;
          cacc |= (uint32_t)st.sym << (8 * sl);
          nacc |= 1u << sl;
        }
      }
      sym[(size_t)(cell0 + cc) * G + g] = (int32_t)cacc;
      val[(size_t)(cell0 + cc) * G + g] = (uint8_t)nacc;
    }
    if (!live) continue;

    // ---- leaders: walk past their own resolution, publish per row ------
    for (int l = 0; l < NL; ++l) {
      const int srow = l + 1;
      int node = cnode[l], cnt = ccnt[l], rec = crec[l], cum = ccum[l];
      for (int i = 0; i < SEGH; ++i) {
        const int jbit = base + 2 * i;
        const int b0 = chunk[i] & 1, b1 = chunk[i] >> 1;
        const int rc = b1 ? C1 : C0;
        const bool valid = lim > jbit;
        const uint32_t e = valid ? quad_entry(tab_s, NS, node, b0, b1) : 0u;
        const Step st = decode_entry(e, NS, rc);
        const bool alive = !(rec & 1);
        const bool started = jbit >= srow;
        if (started) node = st.node;
        if (srow == jbit + 1 && valid) node = rc;  // mid-chunk start
        const int em = started ? st.emit : 0;
        cnt += em;
        const int nz = nscr[i];
        // a leader that resolved without merging (late exit or stream end)
        // walks on spuriously; past the main chain's exit it tracks the
        // halo: publish -1 in both cases
        const bool lstop = (rec & 1) && !((rec >> 1) & 1);
        ldr[i][l] = (lstop || nz == -1) ? -1 : node;
        lcn[i][l] = cnt;
        if (alive && started) {
          if (valid && node == nz) {  // state-merged with the main chain
            rec = ((jbit + 1) << 3) | 3;
            cum = cscr[i] - cnt;
          } else if (em && jbit + st.pos + 1 >= B) {  // late exit
            rec = ((jbit + st.pos) << 3) | 1;
            cum = cnt;
          } else if (!valid) {  // stream end: a late exit at row B-1
            rec = ((B - 1) << 3) | 1;
            cum = cnt;
          }
          if (rec & 1) --unresolved;
        }
      }
      cnode[l] = node;
      ccnt[l] = cnt;
      crec[l] = rec;
      ccum[l] = cum;
    }

    // ---- followers: merge with the main chain or the residue leader -----
    for (int r = NL + 1; r <= CH; ++r) {
      const int c = r - 1;
      if (crec[c] & 1) continue;  // resolved: frozen
      const int lp = (r - 1) % md;
      int node = cnode[c], cnt = ccnt[c], rec = 0, cum = ccum[c];
      for (int i = 0; i < SEGH; ++i) {
        const int jbit = base + 2 * i;
        if (jbit + 1 < r) continue;  // not started, not the start chunk
        const int b0 = chunk[i] & 1, b1 = chunk[i] >> 1;
        const int rc = b1 ? C1 : C0;
        const bool valid = lim > jbit;
        if (jbit + 1 == r) {  // odd start: a root step on the second bit
          if (valid) node = rc;
          continue;
        }
        const uint32_t e = valid ? quad_entry(tab_s, NS, node, b0, b1) : 0u;
        const Step st = decode_entry(e, NS, rc);
        node = st.node;
        cnt += st.emit;
        if (valid && node == nscr[i]) {
          rec = ((jbit + 1) << 3) | 3;
          cum = cscr[i] - cnt;
        } else if (valid && node == ldr[i][lp]) {
          rec = ((jbit + 1) << 3) | 5;
          cum = lcn[i][lp] - cnt;
        } else if (st.emit && jbit + st.pos + 1 >= B) {
          rec = ((jbit + st.pos) << 3) | 1;
          cum = cnt;
        } else if (!valid) {
          rec = ((B - 1) << 3) | 1;
          cum = cnt;
        }
        if (rec & 1) {
          --unresolved;
          break;
        }
      }
      cnode[c] = node;
      ccnt[c] = cnt;
      crec[c] = rec;
      ccum[c] = cum;
    }
  }

  // ---- epilogue: leaders first, followers compose through them ----------
  write_maps(cntmap, exmap, mrowmap, G, g, cnt0, exit0, ccnt, crec, ccum, CH,
             NL, HP, md, B, steps);
}

// K2 (k2_compose.cu): exmap[state, lane], or 0 for an entry offset at or
// past the map rows (HP), as the TPU kernel's zero padding to 128 reads.
__device__ __forceinline__ int k2_ex_at(const int32_t* exmap, int G, int HP,
                                        int state, int lane) {
  return (state >= 0 && state < HP) ? exmap[(size_t)state * G + lane] : 0;
}

// K2 step (1): group grp's composite map (L lanes) at entry offset e.
__device__ __forceinline__ int k2_group_map(const int32_t* exmap, int G,
                                            int HP, int L, int grp, int e) {
  int st = e;
  for (int l = 0; l < L; ++l) st = k2_ex_at(exmap, G, HP, st, grp * L + l);
  return st;
}

// K2 step (2), for one block of K2_NE threads: stage the NGp group maps in
// shared memory `gm`, walk them for all K2_NE lane-0 entries at once; the
// thread of entry `start` records each group's first-lane entry in goff,
// and the final states are the composite map `tot`.
__device__ __forceinline__ void k2_scan_block(uint8_t* gm,
                                              const uint8_t* gmap,
                                              int32_t* goff, uint8_t* tot,
                                              int NGp, int start) {
  for (int i = threadIdx.x; i < NGp * K2_NE; i += blockDim.x) gm[i] = gmap[i];
  __syncthreads();
  const int e = threadIdx.x;
  int st = e;
  for (int grp = 0; grp < NGp; ++grp) {
    if (e == start) goff[grp] = st;
    st = gm[grp * K2_NE + st];
  }
  tot[e] = (uint8_t)st;
}

// K2 step (3): group grp re-walks its L lanes from its first-lane entry.
__device__ __forceinline__ void k2_apply_group(const int32_t* exmap,
                                               const int32_t* goff,
                                               int32_t* entry, int G, int HP,
                                               int L, int grp) {
  int st = goff[grp];
  for (int l = 0; l < L; ++l) {
    const int lane = grp * L + l;
    entry[lane] = st;
    st = k2_ex_at(exmap, G, HP, st, lane);
  }
}

// K3 (k3_fix2.cu) for lane g, entered at e0 with cut row ct and cut slot
// cs: re-decode from e0 and splice the slots below cs into sym/val in
// place.  Stops at its first cell that keeps every slot.
template <class Words>
__device__ __forceinline__ void k3_fix2_lane(
    const Words& words, const uint32_t* tab_s, int e0, int ct, int cs,
    int32_t* sym, uint8_t* val, int G, int g, int steps_p, int SEG, int md,
    int C0, int C1, int NS) {
  if (ct <= 0) return;
  // the TPU kernel runs segments while the cut reaches them
  const int S = steps_p / SEG;
  const int nseg = min((ct + SEG - 1) / SEG, S);
  const int ncell = nseg * (SEG / (md * CELL));
  int node = 0;
  int wcur = -1;
  uint32_t word = 0;
  for (int c = 0; c < ncell && c * CELL < cs; ++c) {
    uint32_t cacc = 0, nacc = 0;
    for (int k = 0; k < 2 * md; ++k) {
      const int jbit = c * CELL * md + 2 * k;
      if ((jbit >> 5) != wcur) {
        wcur = jbit >> 5;
        word = words(wcur, g);
      }
      const int b0 = (word >> (jbit & 31)) & 1;
      const int b1 = (word >> ((jbit & 31) + 1)) & 1;
      const int rc = b1 ? C1 : C0;
      const bool started = jbit >= e0;
      const uint32_t e = started ? quad_entry(tab_s, NS, node, b0, b1) : 0u;
      const Step st = decode_entry(e, NS, rc);
      if (started) node = st.node;
      if (e0 == jbit + 1) node = rc;
      if (st.emit) {
        const int sl = (2 * k + st.pos) / md;
        cacc |= (uint32_t)st.sym << (8 * sl);
        nacc |= 1u << sl;
      }
    }
    const int kk = min(cs - c * CELL, CELL);  // > 0 by the loop bound
    const uint32_t vmask = (1u << kk) - 1u;
    const uint32_t smask = kk >= CELL ? 0xFFFFFFFFu : (1u << (8 * kk)) - 1u;
    const size_t o = (size_t)c * G + g;
    sym[o] = (int32_t)((cacc & smask) | ((uint32_t)sym[o] & ~smask));
    val[o] = (uint8_t)((nacc & vmask) | ((uint32_t)val[o] & ~vmask));
  }
}

// ---- K4: a block-wide compaction -------------------------------------------
// A block owns the lanes [g0, g0 + w), w <= LB, and every cell of them
// (k4_compact.cu, and the one-shot's last phase).  Its threads split each
// lane's cells into `nch` chunks of consecutive cells; a thread owns one
// chunk of `vec` neighbouring lanes (1, or 4 read as one 4-byte val word and
// one 16-byte sym vector), so a warp's loads of a cell row are coalesced and
// every thread has its whole chunk's loads to put in flight.
//   1. popcount the valid nibbles of each (chunk, lane) into `ccount`
//   2. exclusive prefix over each lane's chunks (a warp scan)
//   3. each thread places its valid bytes at their ranks in the lane's row,
//      staged in shared memory (row stride W + 16 bytes, so that rows start
//      on other banks), dropping ranks at or past the lane's `keep`
//   4. the rows go out as 16-byte stores, zeros past the placed bytes.
// Ranks come in windows of W: a row wider than the staging area takes
// ceil(ORP / W) rounds of steps 3-4.  ops/k4_compact.py k4_plan picks LB,
// vec, nch and W, and the launcher refuses any other plan.
struct K4Tile {
  int LB, vec, nch, W;
  // bytes of shared memory: the staged rows, then the chunk counts
  __host__ __device__ static int stage_bytes(int LB, int W) {
    return LB * (W + 16);
  }
  __host__ __device__ static int bytes(int LB, int nch, int W) {
    return stage_bytes(LB, W) + nch * LB * 4;
  }
  // threads with a chunk; a block has this rounded up to whole warps
  __host__ __device__ int threads() const { return LB / vec * nch; }
};

// K4 over the lanes [g0, g0 + w) by the whole block (blockDim.x a multiple
// of 32, at least p.threads()): their first keep(l) <= ORP valid slot
// bytes, in slot order, into rows g0 + l of out (G, ORP), zeros after.
// `smem` holds K4Tile::bytes, 16-byte aligned.
template <bool NC, class T>
__device__ __forceinline__ T k4_load(const T* p) {
  if constexpr (NC)
    return __ldg(p);
  else
    return __ldcg(p);
}

// NC: the cells are read-only for the whole launch (__ldg); else they were
// written earlier in the same launch and are read through L2 (__ldcg).
template <bool NC, class Keep>
__device__ __forceinline__ void k4_block(const int32_t* __restrict__ sym,
                                         const uint8_t* __restrict__ val,
                                         uint8_t* __restrict__ out, int G,
                                         int cells_p, int ORP, int g0, int w,
                                         K4Tile p, uint8_t* smem, Keep keep) {
  const int stride = p.W + 16;
  int* ccount = reinterpret_cast<int*>(smem + K4Tile::stage_bytes(p.LB, p.W));
  const int rt = p.LB / p.vec;  // threads a cell row
  const int t = threadIdx.x;
  const bool active = t < rt * p.nch;
  const int ch = t / rt, l0 = (t - ch * rt) * p.vec;
  const int per = (cells_p + p.nch - 1) / p.nch;
  const int c0 = min(ch * per, cells_p), c1 = min(c0 + per, cells_p);
  const bool mine = active && l0 < w;  // w % vec == 0 where vec == 4

  // 1. valid slots of this chunk, each of my lanes
  int cnt[4] = {0, 0, 0, 0};
  if (mine) {
    if (p.vec == 4) {
      for (int c = c0; c < c1; ++c) {
        const uint32_t v = k4_load<NC>(reinterpret_cast<const uint32_t*>(
            val + (size_t)c * G + g0 + l0));
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[j] += __popc((v >> (8 * j)) & 0xFu);
      }
    } else {
      for (int c = c0; c < c1; ++c)
        cnt[0] += __popc(k4_load<NC>(val + (size_t)c * G + g0 + l0) & 0xFu);
    }
  }
  // (loops over a thread's lanes run 4 times, unrolled, so that these
  // arrays stay in registers)
  if (active)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < p.vec) ccount[ch * p.LB + l0 + j] = cnt[j];
  __syncthreads();

  // 2. exclusive prefix over each lane's chunks, a warp a lane (nch <= 32)
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  for (int l = warp; l < p.LB; l += nwarps) {
    const int x = lane < p.nch ? ccount[lane * p.LB + l] : 0;
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane < p.nch) ccount[lane * p.LB + l] = inc - x;
  }
  __syncthreads();
  int base[4] = {0, 0, 0, 0}, kp[4] = {0, 0, 0, 0};
  if (mine)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < p.vec) {
        base[j] = ccount[ch * p.LB + l0 + j];
        kp[j] = min(keep(l0 + j), ORP);
      }

  for (int w0 = 0; w0 < ORP; w0 += p.W) {
    const int ww = min(p.W, ORP - w0);
    // zero the staged rows (16-byte stores)
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = t; i < p.LB * stride / 16; i += blockDim.x)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // 3. place this chunk's valid bytes of rank [w0, w0 + ww) below keep
    if (mine) {
      bool any = false;  // a rank of this chunk may fall in the window
#pragma unroll
      for (int j = 0; j < 4; ++j)
        any |= j < p.vec && base[j] < min(kp[j], w0 + ww);
      int r[4] = {base[0], base[1], base[2], base[3]};
      // no early exit once every rank is placed: a branch on loaded data
      // would keep the next cells' loads from being in flight together
      const int c_end = any ? c1 : c0;
#pragma unroll 4
      for (int c = c0; c < c_end; ++c) {
        uint32_t v4, s4[4] = {0u, 0u, 0u, 0u};
        if (p.vec == 4) {
          const size_t o = (size_t)c * G + g0 + l0;
          v4 = k4_load<NC>(reinterpret_cast<const uint32_t*>(val + o));
          const int4 s = k4_load<NC>(reinterpret_cast<const int4*>(sym + o));
          s4[0] = s.x, s4[1] = s.y, s4[2] = s.z, s4[3] = s.w;
        } else {
          const size_t o = (size_t)c * G + g0 + l0;
          v4 = k4_load<NC>(val + o);
          s4[0] = (v4 & 0xFu) ? (uint32_t)k4_load<NC>(sym + o) : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= p.vec) break;
          const uint32_t nib = (v4 >> (8 * j)) & 0xFu;
          const int lim = min(kp[j], w0 + ww);
          if (r[j] + __popc(nib) <= w0 || r[j] >= lim) {
            r[j] += __popc(nib);
            continue;
          }
          uint8_t* row = smem + (l0 + j) * stride;
          for (int b = 0; b < CELL; ++b) {
            if (!((nib >> b) & 1u)) continue;
            if (r[j] >= w0 && r[j] < lim)
              row[r[j] - w0] = (uint8_t)(s4[j] >> (8 * b));
            ++r[j];
          }
        }
      }
    }
    __syncthreads();
    // 4. the window of each row, 16 bytes a store
    const int q = ww / 16;
    for (int i = t; i < w * q; i += blockDim.x) {
      const int l = i / q, k = i - l * q;
      *reinterpret_cast<uint4*>(out + (size_t)(g0 + l) * ORP + w0 + 16 * k) =
          *reinterpret_cast<const uint4*>(smem + l * stride + 16 * k);
    }
    __syncthreads();
  }
}

// The launchers' check of a K4 plan (rules in ops/k4_compact.py k4_plan).
inline bool k4_plan_ok(const void* sym, const void* val, int G, int ORP,
                       K4Tile p, int threads, int shared) {
  return G >= 1 && ORP >= 128 && ORP % 128 == 0 && p.LB >= 1 &&
         p.LB <= 32 && p.LB <= G && (p.vec == 1 || p.vec == 4) &&
         (p.vec == 1 ||
          (p.LB % 4 == 0 && G % 4 == 0 && (uintptr_t)val % 4 == 0 &&
           (uintptr_t)sym % 16 == 0)) &&
         p.nch >= 1 && p.nch <= 32 &&
         threads == (p.threads() + 31) / 32 * 32 && threads <= 1024 &&
         p.W >= 16 && p.W % 16 == 0 && p.W <= ORP &&
         shared == K4Tile::bytes(p.LB, p.nch, p.W) && shared <= 48 * 1024;
}

// ---- bit tiles of the lane-DFA scans ---------------------------------------
// The scans walk each lane's column of the (rows, G) uint8 bit matrix one
// row a step.  A block owns L neighbouring lanes and stages their rows R at
// a time in a ring of BIT_STAGES tiles (R x L bytes, row stride L) in shared
// memory, the copies of the next tiles in flight while the current one is
// scanned (ops/lanedfa.py tile_plan picks L, R and the copy width `vec`).
// lane_scan_indexed, short_candidate_scan and lane_decode_dense walk the
// same column layout and can take this staging up.
constexpr int BIT_STAGES = 3;

// The fused table as the scans stage it: entry e (next state in bits 0-9,
// emit bit 10, symbol in bits 16-23) becomes sym << 16 | emit << 15 |
// state << 3, the state's byte offset in the staged table.  A step's
// lookup is then at byte offset (e & OFF_MASK) | bit << 2: two LOP3s
// between two lookups, no multiply or shift on the dependent path.
constexpr int OFF_MASK = STATE_MASK << 3;
constexpr int OFF_EMIT = EMIT_BIT << 5;

__device__ __forceinline__ void stage_offset_table(int32_t* tab_s,
                                                   const int32_t* tab,
                                                   int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int32_t e = tab[i];
    tab_s[i] = (e & ~0xFFFF) | ((e & EMIT_BIT) << 5) |
               ((e & STATE_MASK) << 3);
  }
}

// The staged entry at byte offset `off`.
__device__ __forceinline__ int32_t offset_lookup(const int32_t* tab_s,
                                                 int off) {
  return *reinterpret_cast<const int32_t*>(
      reinterpret_cast<const char*>(tab_s) + off);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The chunks (row r, chunk c) of a tile of per_row >= 1 chunks a row that
// this thread of the block copies, row-major from chunk threadIdx.x in
// steps of blockDim.x, with no division a step: lane_scan's one warp
// copies between its scan steps, and a division each chunk cost it about
// a quarter of its time.
struct TileWalk {
  int per_row, q, rem, r, c;
  __device__ __forceinline__ explicit TileWalk(int per_row_)
      : per_row(per_row_),
        q(blockDim.x / per_row_),
        rem(blockDim.x - q * per_row_),
        r(threadIdx.x / per_row_),
        c(threadIdx.x - r * per_row_) {}
  __device__ __forceinline__ void next() {
    r += q;
    c += rem;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
};

// One copy of `vec` bytes into shared memory: 16 or 4 are cp.async copies
// (the caller commits and waits), 1 a plain load and store.
struct StageBytes {
  __device__ __forceinline__ void operator()(uint8_t* dst, const uint8_t* src,
                                             int vec) const {
    if (vec == 16)
      cp_async16(dst, src);
    else if (vec == 4)
      cp_async4(dst, src);
    else
      *dst = __ldg(src);
  }
};

// `n` bytes from src to dst by all threads of the block, `vec` at a time
// and the last n % vec one by one; copy(dst, src, width) moves them.
template <class Copy>
__device__ __forceinline__ void copy_run(uint8_t* dst, const uint8_t* src,
                                         int n, int vec, Copy copy) {
  const int body = n - n % vec;
  for (int i = threadIdx.x * vec; i < body; i += blockDim.x * vec)
    copy(dst + i, src + i, vec);
  for (int i = body + threadIdx.x; i < n; i += blockDim.x)
    copy(dst + i, src + i, 1);
}

// Rows [r0, r0 + nr) of lanes [g0, g0 + w) of the bit matrix into `tile`,
// by all threads of the block, `vec` bytes a copy.  Where one block holds
// every lane (L == G) the rows are one run of bytes in both, copied whole;
// else vec divides L, G and g0, so it divides w.  Either way r0 is a
// multiple of 16 and every address stays aligned.
__device__ __forceinline__ void stage_bit_tile(uint8_t* tile,
                                               const uint8_t* bits, int G,
                                               int g0, int w, int L, int r0,
                                               int nr, int vec) {
  const uint8_t* src0 = bits + (size_t)r0 * G + g0;
  if (L == G) {
    copy_run(tile, src0, nr * G, vec, StageBytes());
    return;
  }
  for (TileWalk it(w / vec); it.r < nr; it.next()) {
    const int c = it.c * vec;
    StageBytes()(tile + it.r * L + c, src0 + (size_t)it.r * G + c, vec);
  }
}

// The ring of one block.  At tile t: wait(), a block barrier (which
// publishes tile t and frees the stage tile t - 1 used), issue(t +
// BIT_STAGES - 1), then scan tile(t).
struct BitRing {
  uint8_t* smem;
  const uint8_t* bits;
  int G, g0, w, L, R, rows, vec;
  __device__ __forceinline__ int tiles() const { return (rows + R - 1) / R; }
  __device__ __forceinline__ uint8_t* tile(int t) const {
    return smem + (t % BIT_STAGES) * R * L;
  }
  // copy tile t, if there is one, and commit a group either way, so that
  // wait() always leaves the same number of groups in flight
  __device__ __forceinline__ void issue(int t) const {
    if (t < tiles())
      stage_bit_tile(tile(t), bits, G, g0, w, L, t * R, min(R, rows - t * R),
                     vec);
    cp_async_commit();
  }
  __device__ __forceinline__ void begin() const {
    for (int t = 0; t < BIT_STAGES - 1; ++t) issue(t);
  }
  // this thread's copies of the oldest tile in flight have landed
  __device__ __forceinline__ void wait() const {
    cp_async_wait<BIT_STAGES - 2>();
  }
};

// Most dynamic shared memory a scan takes without opting in: 48 KB less
// the staged table.
constexpr int BIT_SHARED_MAX = 48 * 1024 - LANEDFA_TAB_WORDS * 4;

// The launchers' check of a tile plan (rules in ops/lanedfa.py tile_plan):
// false refuses the launch.
inline bool bit_plan_ok(const void* bits, int G, int L, int R, int vec,
                        int threads, int shared) {
  return G >= 1 && L >= 1 && L <= 32 && R >= 16 && R % 16 == 0 &&
         (vec == 1 || vec == 4 || vec == 16) &&
         (L == G || (L % vec == 0 && G % vec == 0)) &&
         (uintptr_t)bits % vec == 0 && threads >= L &&
         threads <= 1024 && shared >= BIT_STAGES * R * L &&
         shared <= BIT_SHARED_MAX;
}

}  // namespace ws

extern "C" const char* ws_error_string(int code);
