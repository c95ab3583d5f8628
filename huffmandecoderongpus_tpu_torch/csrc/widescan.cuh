// Shared device helpers for the wide-lane kernels (K1, K3 and their 1-bit
// versions) and the lane-DFA scans: K1's team body (k1_team, a team of
// threads a lane), which k1_scan2.cu, k1_scan2_c01.cu and the fused
// one-shot kernel (oneshot.cu) all run and whose main-chain walks
// (main_fast, team_walk) k1_main.cu runs a thread a lane, K3's per-lane
// body (k3_fix2_lane, which k3_fix2.cu and k3_fix2_c01.cu run), and K4's
// block-wide body (k4_block), which the separate kernels and the one-shot
// share.  K2 is one launch of its own (k2_compose.cu: tiles composed in
// shared memory, chained by a look-back); the one-shot keeps a three-step
// K2 between its grid barriers (oneshot.cu).
//
// The quad table (2*NS rows of 128 uint32 words, see
// ops/widescan.py pack_quad_tables), which every 2-bit kernel rewrites into
// a step table in shared memory (stage_step_table): row b0*NS + (node >>
// 7), column node & 127, 16-bit half b1 is the entry for the 2-bit chunk
// (b0, b1) read in state `node`.  The 1-bit kernels' pair
// table (NS rows, pack_pair_table) holds one word per state: word `node`,
// 16-bit half b is the entry for bit b.
#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace ws {

constexpr int CELL = 4;           // md-slots per int32 cell / u8 nibble
constexpr int MAX_NS = 8;         // 1023 states / 128
constexpr int MAX_SEGH = 16;      // chunk rows per segment: SEG <= 32
constexpr int MAX_NL = 8;         // leaders: one per residue mod md, md <= 8
constexpr int MAX_CH = 127;       // candidate chains: HP <= 128
constexpr int K2_NE = 128;        // K2: entry offsets per map
constexpr int K2_MAX_GROUPS = 256;  // the one-shot's K2: group maps it stages
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

// ---- K1 as a team of threads a lane ----------------------------------------
// K1 (k1_scan2.cu, k1_scan2_c01.cu, and the one-shot's first phase) gives
// each lane a team of T threads of one warp (T a power of two from 4 to 32;
// ops/k1_scan2.py k1_plan and ops/oneshot.py oneshot_plan pick it): thread
// 0 walks the main chain, which writes the cells, and threads 1.. the NL
// leaders and the followers, chain c on thread 1 + c % (T - 1).  The team
// runs them at once, as a pipeline over segments: at step t thread 0 walks
// segment t of the main chain, the leaders segment t - 1 and the followers
// segment t - 2, each reading what the chains before it published for that
// segment through a ring in shared memory (the main chain's post-chunk
// state and count a row and the segment's bits, three slots; the leaders'
// state and count a row, two slots), with one __syncwarp a step.  A thread
// with more than one chain (CH + 1 > T) walks them in turn, each chain's
// state loaded from shared memory into registers for its walk.  Every role
// walks its rows by one body (team_walk), branch-free but for a merge, so
// that a warp's threads issue the same instructions whatever their role.
// Once every chain of every team of a warp is resolved, its main chains go
// on alone (main_fast where a segment lies inside the lane).  Liveness is a
// warp vote (__ballot_sync over all 32 threads), so every thread of a warp
// runs the team body: the launchers require G * T to fill whole blocks.
//
// Exactness.  The chains resolve and record by the TPU kernel's rules (a
// merge with the main chain or the residue leader at the first valid row
// where the states agree, a late exit past row B - 1, or the stream end).
// The pipeline walks a chain only on segments that start below the lane's
// stream limit.  It walks the leaders a segment ahead of the followers, so
// a leader may walk past the segment in which its lane's last chain
// resolved; it records nothing there that the maps read (a resolved leader
// publishes -1, or the main chain's state once merged with it, and a
// resolved follower is frozen).  A lane whose stream ends before a segment
// writes zero cells there, and a
// chain that never reaches its start row reports what a stream-end
// resolution reports (its count 0, exit 0, no merge row).  The walks are
// templated on md (2-8), so a segment's rows unroll, and step through a
// step table built in shared memory at launch (state as a byte offset:
// lookup, one LOP3, lookup), which the one-shot's K3 walks too.
//
// What bounds it on the H100: the main chain's dependent table lookups, one
// a 2-bit chunk of its lane (the chain floor, about 40 cycles), and while
// candidate chains live, a row of the team body for every role.

constexpr int K1_THREADS = 128;  // a block of the K1 kernels

// int32 words of one team's shared memory: the chains' state (node, count,
// record, cumulative count), the main chain's count and exit, the ring of
// three main-chain slots (the segment's bits, then a row's state and
// count) and the ring of two leader slots (a row's state and count of each
// leader).  A multiple of 4, so that every team starts 16-byte aligned.
__host__ __device__ inline int team_words(int CH, int NL, int SEGH) {
  const int n = 4 * CH + 2 + 3 * (1 + 2 * SEGH) + 2 * (2 * SEGH * NL);
  return (n + 3) / 4 * 4;
}

// What K1 writes, and the geometry its walks read.  C0/C1 are the root's
// children, the state of a chain that starts on a chunk's second bit.
struct K1Args {
  int32_t* sym;      // (cells_p, G) cell-packed symbols
  uint8_t* val;      // (cells_p, G) valid nibbles
  int32_t* cntmap;   // (HP, G) symbols a lane emits from each entry offset
  int32_t* exmap;    // (HP, G) the next lane's entry offset
  int32_t* mrowmap;  // (HP, G) merge row
  int G, B, steps, steps_p, C0, C1;
};

// One team's shared memory.
struct Team {
  int* base;
  int CH, NL, SEGH;
  // team threadIdx.x / T of a block whose teams start at `smem`
  __device__ static Team of(uint8_t* smem, int H, int md, int SEG, int T) {
    const int CH = H - 1 > 1 ? H - 1 : 1, NL = md < CH ? md : CH;
    return Team{reinterpret_cast<int*>(smem) + (int)(threadIdx.x / T) *
                                                   team_words(CH, NL, SEG / 2),
                CH, NL, SEG / 2};
  }
  __device__ int* node() const { return base; }
  __device__ int* cnt() const { return base + CH; }
  __device__ int* rec() const { return base + 2 * CH; }
  __device__ int* cum() const { return base + 3 * CH; }
  __device__ int* mainv() const { return base + 4 * CH; }
  // segment seg's main-chain slot: [0] its bits, [1, 1 + SEGH) the state
  // after each row (-1 once exited), then the count after each row
  __device__ int* slot_a(int seg) const {
    return base + 4 * CH + 2 + (seg % 3) * (1 + 2 * SEGH);
  }
  // segment seg's leader slot: (SEGH, NL) states (-1 once stopped), then
  // (SEGH, NL) counts
  __device__ int* slot_b(int seg) const {
    return base + 4 * CH + 2 + 3 * (1 + 2 * SEGH) + (seg & 1) * 2 * SEGH * NL;
  }
};

// The warp's threads of this thread's team (T divides 32).
__device__ __forceinline__ unsigned team_mask(int T) {
  const int sub = (threadIdx.x & 31) & ~(T - 1);
  return T == 32 ? 0xFFFFFFFFu : ((1u << T) - 1u) << sub;
}

struct Chain {
  int node, cnt, rec, cum;  // the main chain: rec bit 0 = exited, cum = exit
};

// The step table: K1's quad table rewritten as one 32-bit entry a (state,
// 2-bit chunk), at byte offset state * 16 + chunk * 4: the post-chunk
// state's byte offset (state * 16, bits 4-13), emit (bit 14), pos (bit 15)
// and the symbol (bits 16-23).  A chain carries its state as that byte
// offset, so a step is lookup, one LOP3, lookup: no multiply, shift or
// select on the dependent path (the scans' byte offsets, stage_offset_table).
// Entry 0 (an invalid row) is the root with no emission.  The compact
// layout (NS == 1) holds its post-chunk states itself, so its table does not
// depend on C0/C1.
constexpr int STEP_NODE = 0x3FF0;
constexpr int STEP_EMIT = 1 << 14;
constexpr int STEP_POS = 15;

__host__ __device__ constexpr int step_bytes(int NS) { return NS * 128 * 16; }

// The step table of quad table `tab` (2 * NS, 128) into shared memory, by
// all threads of the block.
__device__ __forceinline__ void stage_step_table(int32_t* step,
                                                 const uint32_t* tab, int NS,
                                                 int C0, int C1) {
  for (int i = threadIdx.x; i < NS * 128 * 4; i += blockDim.x) {
    const int s = i >> 2, b0 = i & 1, b1 = (i >> 1) & 1;
    const uint32_t w = __ldg(&tab[(b0 * NS + (s >> 7)) * 128 + (s & 127)]);
    const Step st = decode_entry((w >> (b1 << 4)) & 0xFFFFu, NS,
                                 b1 ? C1 : C0);
    step[i] = st.node << 4 | st.emit << 14 | st.pos << STEP_POS |
              st.sym << 16;
  }
}

__device__ __forceinline__ int32_t step_at(const int32_t* step, int off) {
  return *reinterpret_cast<const int32_t*>(
      reinterpret_cast<const char*>(step) + off);
}

// The 1-bit step table (k1_scan.cu, k3_fix.cu: md = 1): the pair table
// rewritten as one 32-bit entry a (state, bit), at byte offset state * 8 +
// bit * 4: the post-bit state's byte offset (state * 8, bits 3-12), emit
// (bit 15) and the symbol (bits 16-23, zero unless emit).  A chain carries
// its state as that byte offset, so a step is lookup, one LOP3 (offset |
// bit << 2), lookup.  Entry 0 (an invalid row) is the root with no
// emission.  Both pair-table layouts decode through e1_fields (compact at
// NS 1, wide past it); at NS 8 the table is 8 KB.
constexpr int STEP1_NODE = 0x1FF8;
constexpr int STEP1_EMIT = 1 << 15;

__host__ __device__ constexpr int step1_bytes(int NS) { return NS * 128 * 8; }

// The 1-bit step table of pair table `tab` (NS, 128) into shared memory, by
// all threads of the block.
__device__ __forceinline__ void stage_step_table1(int32_t* step,
                                                  const uint32_t* tab,
                                                  int NS) {
  for (int i = threadIdx.x; i < NS * 256; i += blockDim.x) {
    const uint32_t w = __ldg(&tab[i >> 1]);
    const Bit st = e1_fields((w >> ((i & 1) << 4)) & 0xFFFFu, NS);
    step[i] = st.node << 3 | st.emit << 15 | (st.emit ? st.sym : 0) << 16;
  }
}

// The segment geometry of min code length MD, as ops/widescan.py _plan
// makes it: SEG bits, SEGH 2-bit chunks, CELLS cells of 2 * MD chunks.
template <int MD>
struct Seg {
  static constexpr int UNROLL = 4 * MD;
  static constexpr int SEG = UNROLL * (32 / UNROLL > 1 ? 32 / UNROLL : 1);
  static constexpr int SEGH = SEG / 2;
  static constexpr int CELLS = SEG / (MD * CELL);
};

// SEG of min code length md (Seg<md>::SEG).
__host__ __device__ constexpr int seg_bits(int md) {
  return 4 * md * (32 / (4 * md) > 1 ? 32 / (4 * md) : 1);
}

// The bits [seg * SEG, seg * SEG + SEG) of lane g (SEG <= 32), or 0 past
// the last segment.
template <class Words>
__device__ __forceinline__ uint32_t segment_bits(const Words& words, int seg,
                                                 int S, int SEG, int g) {
  if (seg >= S) return 0u;
  const int base = seg * SEG, wb = base & ~31;
  return (uint32_t)(load_bits64(words, wb, g) >> (base - wb));
}

// One chain's walk over the SEGH rows of a segment starting at bit `base`
// (states as step-table byte offsets): kind 0 the main chain (writes the
// cells from cell0 on and, with `record`, its state and count a row into
// slot a), 1 a leader (start row srow, publishes into slot b as leader
// `li`), 2 a follower (start row srow, merges with the main chain or leader
// `li`, frozen once resolved).  `on` false walks nothing.  MAIN_ONLY drops
// the candidates' logic.  The rows are unrolled, so that a row's
// bookkeeping fills the next lookup's latency.  Returns whether a candidate
// resolved.
template <int MD, bool MAIN_ONLY>
__device__ __forceinline__ bool team_walk(
    Chain& ch, int kind, bool on, bool record, int srow, int li, int base,
    uint32_t bits, int lim, const int32_t* step, const K1Args& a, int* sa,
    int* sb, int NL, int cell0, int g) {
  using SG = Seg<MD>;
  const bool is_main = MAIN_ONLY || kind == 0;
  const bool is_fol = !MAIN_ONLY && kind == 2;
  int node = ch.node, cnt = ch.cnt, rec = ch.rec, cum = ch.cum;
  bool frozen = !on || (is_fol && (rec & 1));
  const bool was = rec & 1;
  const int C0 = a.C0 << 4, C1 = a.C1 << 4, B = a.B;
  // a candidate's comparands for every row, loaded before its walk so that
  // no shared-memory load waits on the chain: the main chain's state and,
  // for a follower, its leader's (the counts are read on a merge only)
  int nzr[SG::SEGH], ldr[SG::SEGH];
  const bool cand = !MAIN_ONLY && !is_main && !frozen;
#pragma unroll
  for (int i = 0; i < SG::SEGH; ++i) {
    nzr[i] = cand ? sa[1 + i] : -1;
    ldr[i] = cand && is_fol ? sb[i * NL + li] : -1;
  }
#pragma unroll
  for (int cc = 0; cc < SG::CELLS; ++cc) {
    uint32_t cacc = 0, nacc = 0;
#pragma unroll
    for (int k = 0; k < 2 * MD; ++k) {
      const int i = cc * 2 * MD + k;
      const int jbit = base + 2 * i;
      const int chunk4 = ((bits >> (2 * i)) & 3) << 2;
      const bool valid = lim > jbit;
      const int e = valid && !frozen ? step_at(step, node | chunk4) : 0;
      const bool started = MAIN_ONLY || jbit >= srow;
      const bool upd = started && !frozen;
      if (upd) node = e & STEP_NODE;
      if (!MAIN_ONLY && !frozen && srow == jbit + 1 && valid)
        node = (chunk4 & 8) ? C1 : C0;  // a start on the chunk's second bit
      const int pos = (e >> STEP_POS) & 1;
      int em = upd && (e & STEP_EMIT) ? 1 : 0;
      if (is_main) {
        if (rec & 1) em = 0;  // past the exit: no more emissions
        if (em && jbit + pos + 1 >= B) {
          cum = jbit + pos + 1 - B;
          rec |= 1;
        }
      }
      cnt += em;
      if (!MAIN_ONLY) {
        // one store pair for every role, and the resolution as selects: the
        // main chain's and the candidates' rows are one instruction stream,
        // so that a warp does not run them one after the other
        const int nz = nzr[i];
        const bool lstop = (rec & 1) && !((rec >> 1) & 1);
        const bool pub = on && (is_main ? record : kind == 1 && !frozen);
        int* ws = is_main ? sa + 1 + i : sb + i * NL + li;
        int* wc = is_main ? sa + 1 + SG::SEGH + i
                          : sb + SG::SEGH * NL + i * NL + li;
        const bool gone = is_main ? (rec & 1) : (lstop || nz == -1);
        if (pub) {
          *ws = gone ? -1 : node;
          *wc = cnt;
        }
        const bool chk = !is_main && !frozen && !(rec & 1) && upd;
        const bool m1 = chk && valid && node == nz;  // merged, main chain
        const bool m2 = chk && !m1 && is_fol && valid && node == ldr[i];
        const bool lx = chk && !m1 && !m2 && em && jbit + pos + 1 >= B;
        const bool se = chk && !m1 && !m2 && !lx && !valid;  // stream end
        if (m1 | m2) {  // the merge partner's count on this row
          cum = (m1 ? sa[1 + SG::SEGH + i]
                    : sb[SG::SEGH * NL + i * NL + li]) - cnt;
          rec = ((jbit + 1) << 3) | (m1 ? 3 : 5);
        }
        cum = lx | se ? cnt : cum;
        rec = lx ? ((jbit + pos) << 3) | 1 : se ? ((B - 1) << 3) | 1 : rec;
        frozen = frozen || (is_fol && (rec & 1));
      }
      if (is_main && em) {  // slot (jbit + pos) / md, from the cell start
        const int sl = (2 * k + pos) / MD;
        cacc |= (uint32_t)((e >> 16) & 0xFF) << (8 * sl);
        nacc |= 1u << sl;
      }
    }
    if (is_main && on) {
      const size_t o = (size_t)(cell0 + cc) * a.G + g;
      a.sym[o] = (int32_t)cacc;
      a.val[o] = (uint8_t)nacc;
    }
  }
  if (on) ch = Chain{node, cnt, rec, cum};
  return !is_main && on && !was && (rec & 1);
}

// The main chain alone over a segment that lies below both the lane's
// stream limit and row B - 1 (so every row is valid and no emission can
// be the exit): the lookups of a cell first, each on the last one's state,
// then its emissions packed, which the next cell's lookups overlap.
template <int MD>
__device__ __forceinline__ void main_fast(Chain& m, uint32_t bits,
                                          const int32_t* step,
                                          const K1Args& a, int cell0, int g) {
  using SG = Seg<MD>;
  int node = m.node, cnt = m.cnt;
#pragma unroll
  for (int cc = 0; cc < SG::CELLS; ++cc) {
    int es[2 * MD];
#pragma unroll
    for (int k = 0; k < 2 * MD; ++k) {
      const int i = cc * 2 * MD + k;
      es[k] = step_at(step, node | (((bits >> (2 * i)) & 3) << 2));
      node = es[k] & STEP_NODE;
    }
    uint32_t cacc = 0, nacc = 0;
#pragma unroll
    for (int k = 0; k < 2 * MD; ++k) {
      const int e = es[k];
      const uint32_t em = (e >> 14) & 1;
      const int sl = (2 * k + ((e >> STEP_POS) & 1)) / MD;
      cacc |= (em * ((e >> 16) & 0xFF)) << (8 * sl);
      nacc |= em << sl;
      cnt += em;
    }
    const size_t o = (size_t)(cell0 + cc) * a.G + g;
    a.sym[o] = (int32_t)cacc;
    a.val[o] = (uint8_t)nacc;
  }
  m.node = node;
  m.cnt = cnt;
}

// The (count, exit, merge row) of leader l's map row (write_maps).
__device__ __forceinline__ void leader_row(const Team& tm, int l, int cnt0,
                                           int exit0, int B, int steps,
                                           int& tot, int& ex, int& mro) {
  const int rec = tm.rec()[l], res = rec & 1, mrg = (rec >> 1) & 1;
  const int mrow = rec >> 3, cum = tm.cum()[l];
  tot = res ? (mrg ? cnt0 - cum : cum) : tm.cnt()[l];
  ex = res ? (mrg ? exit0 : mrow + 1 - B) : 0;
  mro = (res && mrg) ? mrow : steps;
}

// The cells of segment seg of a lane whose stream ended before it.
__device__ __forceinline__ void zero_cells(const K1Args& a, int seg,
                                           int cells_seg, int g) {
  for (int q = 0; q < cells_seg; ++q) {
    const size_t o = (size_t)(seg * cells_seg + q) * a.G + g;
    a.sym[o] = 0;
    a.val[o] = 0;
  }
}

// K1 of lane g, whose stream limit is lims[g], by its team: thread j of T,
// `team_mask` the team's threads in the warp.  Writes the lane's cells and
// its rows of the maps.  Every thread of the warp must call it.
template <int MD, class Words>
__device__ __forceinline__ void k1_team(const K1Args& a, const Words& words,
                                        const int32_t* lims,
                                        const int32_t* step,
                                        const Team& tm, int g, int j, int T,
                                        unsigned team_mask) {
  using SG = Seg<MD>;
  const int CH = tm.CH, NL = tm.NL, SEG = SG::SEG;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const int cells_seg = SG::CELLS;
  const int S = a.steps_p / SEG;
  const int lim = lims[g];
  const int per = T - 1;  // chain threads
  const int kmax = (CH + per - 1) / per;
  Chain m{0, 0, 0, 0};
  int unres = 0;  // this thread's unresolved chains
  if (j > 0)
    for (int c = j - 1; c < CH; c += per) {
      tm.node()[c] = tm.cnt()[c] = tm.rec()[c] = tm.cum()[c] = 0;
      ++unres;
    }
  uint32_t next = j == 0 ? segment_bits(words, 0, S, SEG, g) : 0u;
  __syncwarp();

  int it = 0;
  for (; it < S + 2; ++it) {
    const bool mine = unres > 0 && lim > max(it - 2, 0) * SEG;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, mine);
    if (!ball) break;  // every chain of the warp's teams resolved
    const bool live = (ball & team_mask) != 0;
    for (int k = 0; k < kmax; ++k) {
      int kind = 0, seg = it, c = 0;
      bool on;
      uint32_t bits;
      Chain ch;
      if (j == 0) {
        on = k == 0 && seg < S;
        bits = next;
        if (on) next = segment_bits(words, seg + 1, S, SEG, g);
        ch = m;
      } else {
        c = j - 1 + k * per;
        kind = c < NL ? 1 : 2;
        seg = it - kind;
        on = live && c < CH && seg >= 0 && seg < S && lim > seg * SEG;
        bits = on ? (uint32_t)tm.slot_a(seg)[0] : 0u;
        ch = on ? Chain{tm.node()[c], tm.cnt()[c], tm.rec()[c], tm.cum()[c]}
                : Chain{0, 0, 0, 0};
      }
      const int base = seg * SEG;
      if (j == 0 && on && lim <= base) {  // the stream ended before it
        zero_cells(a, seg, cells_seg, g);
        on = false;
      }
      int* sa = tm.slot_a(seg < 0 ? 0 : seg);
      if (j == 0 && on && live) sa[0] = (int)bits;
      const int srow = kind == 0 ? 0 : c + 1;
      const int li = kind == 1 ? c : c % MD;
      if (team_walk<MD, false>(ch, kind, on, live, srow, li, base, bits, lim,
                               step, a, sa, tm.slot_b(seg < 0 ? 0 : seg), NL,
                               seg * cells_seg, g))
        --unres;
      if (j == 0) {
        m = ch;
      } else if (on) {
        tm.node()[c] = ch.node;
        tm.cnt()[c] = ch.cnt;
        tm.rec()[c] = ch.rec;
        tm.cum()[c] = ch.cum;
      }
    }
    __syncwarp();
  }
  // the main chains go on alone over the segments left
  if (j == 0)
    for (int seg = it; seg < S; ++seg) {
      const uint32_t bits = next;
      next = segment_bits(words, seg + 1, S, SEG, g);
      const int base = seg * SEG;
      if (lim <= base) {
        zero_cells(a, seg, cells_seg, g);
        continue;
      }
      if (base + SEG <= lim && base + SEG < a.B)
        main_fast<MD>(m, bits, step, a, seg * cells_seg, g);
      else
        team_walk<MD, true>(m, 0, true, false, 0, 0, base, bits, lim, step,
                            a, nullptr, nullptr, NL, seg * cells_seg, g);
    }
  if (j == 0) {
    tm.mainv()[0] = m.cnt;
    tm.mainv()[1] = m.cum;
  }
  __syncwarp();

  // ---- the maps: leaders first, followers compose through them ----------
  const int cnt0 = tm.mainv()[0], exit0 = tm.mainv()[1];
  const int G = a.G;
  for (int r = j; r < HP; r += T) {
    int tot, ex, mro;
    if (r == 0) {
      tot = cnt0, ex = exit0, mro = -1;
    } else if (r <= NL) {
      leader_row(tm, r - 1, cnt0, exit0, a.B, a.steps, tot, ex, mro);
    } else if (r <= CH) {
      const int c = r - 1, rec = tm.rec()[c], kind = (rec >> 1) & 3;
      const int mrow = rec >> 3, cum = tm.cum()[c];
      if (!(rec & 1)) {  // unresolved: the raw count
        tot = tm.cnt()[c], ex = 0, mro = a.steps;
      } else if (kind == 1) {  // merged with the main chain
        tot = cnt0 - cum, ex = exit0, mro = mrow;
      } else if (kind == 2) {  // merged with its leader
        int lt, le, lm;
        leader_row(tm, (r - 1) % MD, cnt0, exit0, a.B, a.steps, lt, le, lm);
        tot = lt - cum, ex = le, mro = mrow > lm ? mrow : lm;
      } else {  // late exit or stream end
        tot = cum, ex = mrow + 1 - a.B, mro = a.steps;
      }
    } else {
      tot = 0, ex = 0, mro = a.steps;
    }
    const size_t o = (size_t)r * G + g;
    a.cntmap[o] = tot;
    a.exmap[o] = ex;
    a.mrowmap[o] = mro;
  }
}

// f(std::integral_constant<int, md>) for md in 2..8.
template <class F>
__device__ __forceinline__ void with_md(int md, F f) {
  switch (md) {
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

// The K1 launchers' check of a team plan (rules in ops/k1_scan2.py
// k1_plan): T threads a lane, `shared` dynamic bytes a block of
// K1_THREADS (the step table, then the teams).
inline bool k1_plan_ok(int G, int H, int md, int SEG, int NS, int T,
                       int shared) {
  if (md < 2 || md > MAX_NL || H - 1 > MAX_CH || NS < 1 || NS > MAX_NS ||
      SEG != seg_bits(md) || T < 4 || T > 32 || (T & (T - 1)))
    return false;
  const int CH = H - 1 > 1 ? H - 1 : 1, NL = md < CH ? md : CH;
  const int lanes = K1_THREADS / T;
  return T >= NL + 1 && G >= 1 && (long long)G * T % K1_THREADS == 0 &&
         shared % 16 == 0 &&
         shared >= step_bytes(NS) + 4 * lanes * team_words(CH, NL, SEG / 2) &&
         shared <= 227 * 1024;
}

// Let `kernel` take up to 227 KB of dynamic shared memory (past 48 KB a
// launch needs it), once per device: `done` holds a bit a device.
inline cudaError_t allow_shared(const void* kernel,
                                std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---- K3: the fix scan of a lane entered mid-codeword ----------------------
// K3 (k3_fix2.cu, k3_fix2_c01.cu) for lane g, entered at e0 with cut row ct
// and cut slot cs: re-decode from bit e0 and splice the slots below cs into
// sym/val in place.  The lane stops at its first cell that keeps every
// slot: cell min(nseg * cells a segment, ceil(cs / CELL)), nseg the
// segments its cut reaches (the TPU kernel runs a segment while a cut
// reaches it).
//
// The walk is the step table's (stage_step_table; C0/C1, the root's
// children, as byte offsets): a 2-bit chunk is lookup, one LOP3, lookup.
// The LOP3 takes the next lookup's offset from the entry, a mask and the
// next chunk's bits: the mask keeps the post-chunk state from the entry's
// chunk on, and zero (the root) before it, where the entry's emissions are
// dropped; an odd entry e0 sets the chunk holding bit e0 - 1 to the root
// child of bit e0 (a root step on the chunk's second bit).  Both depend on
// the cell and e0 alone, so they stay off the dependent path.  Each chunk
// issues the next chunk's lookup before it packs its own emission, and the
// last chunk of a cell the next cell's first before the cell is stored, so
// that the stores and the loop's own work wait on no lookup.  MD makes a
// cell's 2 * MD chunks unroll and each slot a division by a constant.  The
// lane's bits come through a 64-bit window of two words, the word after
// them loaded when the window moves, a word ahead of the walk.  Every cell
// below the one holding cs is stored whole, without reading it; that cell,
// the only one read, is loaded when the lane starts and stored spliced
// under its byte and bit masks.
template <int MD, class Words>
__device__ __forceinline__ void k3_fix2_lane(const Words& words,
                                             const int32_t* step, int e0,
                                             int ct, int cs, int32_t* sym,
                                             uint8_t* val, int G, int g,
                                             int steps_p, int SEG, int C0,
                                             int C1) {
  constexpr int BITS = CELL * MD;  // a cell's bits: at most 32
  if (ct <= 0) return;
  const int nseg = min((ct + SEG - 1) / SEG, steps_p / SEG);
  const int nc = min(nseg * (SEG / BITS), (cs + CELL - 1) / CELL);
  if (nc <= 0) return;
  // the cut cell, when it keeps some of its slots: cell cs / CELL = nc - 1
  const bool spliced = cs % CELL != 0 && cs / CELL < nc;
  const size_t ocut = (size_t)(nc - 1) * G + g;
  const uint32_t old_s = spliced ? (uint32_t)sym[ocut] : 0u;
  const uint32_t old_v = spliced ? (uint32_t)val[ocut] : 0u;
  const int c0 = C0 << 4, c1 = C1 << 4;
  // words [w, w + 1] of the lane, and word w + 2 on its way
  uint64_t win = (uint64_t)words(0, g) | (uint64_t)words(1, g) << 32;
  uint32_t ahead = words(2, g);
  int w = 0;
  uint32_t bits = (uint32_t)win;  // the cell's bits
  int e = step_at(step, (int)(bits & 3u) << 2);  // the chunk's entry
  for (int c = 0; c < nc; ++c) {
    // the next cell's bits, for the LOP3 of this cell's last chunk
    const int nb = (c + 1) * BITS;
    if ((nb >> 5) != w) {
      win = (win >> 32) | (uint64_t)ahead << 32;
      ++w;
      ahead = words(w + 2, g);
    }
    const uint32_t next = (uint32_t)(win >> (nb & 31));
    const int rel = e0 - c * BITS;  // the entry bit, from the cell's start
    uint32_t cacc = 0, nacc = 0;
#pragma unroll
    for (int k = 0; k < 2 * MD; ++k) {
      const int ek = e;
      const bool on = 2 * k >= rel;  // the chunk is at or past the entry
      const int rc = (bits >> (2 * k + 1)) & 1u ? c1 : c0;
      const int root = rel == 2 * k + 1 ? rc : 0;
      const uint32_t nx = k + 1 < 2 * MD ? bits >> (2 * k + 2) : next;
      // the next chunk's lookup (the next cell's first after the last
      // chunk), in flight while this one's emission is packed and the
      // cell is stored
      e = step_at(step, (ek & (on ? STEP_NODE : 0)) |
                            (root | (int)(nx & 3u) << 2));
      const uint32_t em = on ? ((uint32_t)ek >> 14) & 1u : 0u;
      // one division by the constant MD: a select of two quotients lets
      // the compiler fold them into a division by a selected divisor,
      // which it calls out of line
      const int sl = (2 * k + ((ek >> STEP_POS) & 1)) / MD;
      cacc |= (em * (((uint32_t)ek >> 16) & 0xFFu)) << (8 * sl);
      nacc |= em << sl;
    }
    const size_t o = (size_t)c * G + g;
    if (spliced && c == nc - 1) {  // its slots from cs % CELL on stay
      const int kk = cs % CELL;
      const uint32_t vmask = (1u << kk) - 1u;
      const uint32_t smask = (1u << (8 * kk)) - 1u;
      sym[o] = (int32_t)((cacc & smask) | (old_s & ~smask));
      val[o] = (uint8_t)((nacc & vmask) | (old_v & ~vmask));
    } else {
      sym[o] = (int32_t)cacc;
      val[o] = (uint8_t)nacc;
    }
    bits = next;
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
// lane_scan stages one matrix this way, short_candidate_scan two
// (BitRing2); lane_scan_indexed's copy warps stage the same tiles
// (lane_scan_indexed.cu); lane_decode_dense walks the same column layout
// and can take this staging up.
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
  // the copies of tile t (t < tiles()), not committed
  __device__ __forceinline__ void stage(int t) const {
    stage_bit_tile(tile(t), bits, G, g0, w, L, t * R, min(R, rows - t * R),
                   vec);
  }
  // copy tile t, if there is one, and commit a group either way, so that
  // wait() always leaves the same number of groups in flight
  __device__ __forceinline__ void issue(int t) const {
    if (t < tiles()) stage(t);
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

// Two matrices of one (rows, G) layout (short_candidate_scan: the bits and
// the 0-chain's emissions) in two rings under one plan, a tile of each in
// one commit group, so wait() keeps the same groups in flight as BitRing.
struct BitRing2 {
  BitRing a, b;
  __device__ __forceinline__ int tiles() const { return a.tiles(); }
  __device__ __forceinline__ void issue(int t) const {
    if (t < tiles()) {
      a.stage(t);
      b.stage(t);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void begin() const {
    for (int t = 0; t < BIT_STAGES - 1; ++t) issue(t);
  }
  __device__ __forceinline__ void wait() const {
    cp_async_wait<BIT_STAGES - 2>();
  }
};

// One store of `vec` bytes from shared memory (lane_scan's and
// lane_scan_indexed's output tiles).
struct StoreBytes {
  __device__ __forceinline__ void operator()(uint8_t* to, const uint8_t* from,
                                             int vec) const {
    if (vec == 16)
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    else if (vec == 4)
      *reinterpret_cast<uint32_t*>(to) =
          *reinterpret_cast<const uint32_t*>(from);
    else
      *to = *from;
  }
};

// The 2-bit step table of lane_scan_indexed: one 32-bit entry a (state, two
// bits b0 b1) at byte offset state * 16 + b0 * 8 + b1 * 4, holding the state
// after both bits as its byte offset in this table (state * 16, bits 4-13),
// the first bit's emit (bit 14) and the second's (bit 15), and the symbol
// fields of both bits' fused entries (bits 16-23 and 24-31).  A step of two
// rows is then lookup, one LOP3 (offset | b0 << 3 | b1 << 2), lookup, as
// the 1-bit table's step of one row.  16 bytes a state: 4 KB at 255 states,
// 16 KB for a table of 16 chunks (ops/lanedfa.py step2_table builds the
// same entries on the host).
constexpr int STEP2_NODE = STATE_MASK << 4;

__host__ __device__ constexpr int step2_bytes(int tab_words) {
  return (tab_words + 1) / 2 * 16;
}

// The 2-bit step table of the staged 1-bit table `tab_s`
// (stage_offset_table, after a block barrier) into shared memory, by all
// threads of the block.
__device__ __forceinline__ void stage_step_table2(int32_t* step,
                                                  const int32_t* tab_s,
                                                  int tab_words) {
  for (int i = threadIdx.x; i < step2_bytes(tab_words) / 4;
       i += blockDim.x) {
    const int e0 = offset_lookup(tab_s, (i >> 2) << 3 | (i & 2) << 1);
    const int e1 = offset_lookup(tab_s, (e0 & OFF_MASK) | (i & 1) << 2);
    step[i] = (int32_t)((uint32_t)(e1 & OFF_MASK) << 1 |
                        (uint32_t)(e0 & OFF_EMIT) >> 1 |
                        (uint32_t)(e1 & OFF_EMIT) |
                        ((uint32_t)e0 >> 16 & 0xFFu) << 16 |
                        ((uint32_t)e1 >> 16 & 0xFFu) << 24);
  }
}

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
