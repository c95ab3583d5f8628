// The one-shot decode: the whole wide-lane program in one cooperative
// launch.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_oneshot.py oneshot_program /
// _oneshot_kernel.  The TPU kernel walks a (phase, segment) grid with the
// working set in VMEM, builds the halo'd word matrix in-kernel by
// transposes, and composes the exit maps lane-transposed, all for Mosaic's
// layouts.  None of that is carried over.  Here each lane has a team of T
// threads of one warp (ops/oneshot.py oneshot_plan picks T), and K2's three
// steps are phases of the same launch, between grid-wide barriers:
//
//   K1       the team's chains: thread 0 the main chain, which writes the
//            cells; threads 1.. the NL leaders and the followers
//   --- grid.sync()
//   K2 (1)   every group's composite map (grid-stride over groups x 128)
//   --- grid.sync()
//   K2 (2)   block 0 stages the group maps (16-byte loads) and scans them
//   --- grid.sync()
//   K2 (3)   one thread per group walks its lanes -> every lane's entry
//   --- grid.sync()
//   thread 0 of each team: the lane's count and cut rows (select_h /
//            fix_rows) and K3 (k3_lane: k3_fix2_lane's rules on the step
//            table); then, after a block barrier, the
//            block's lanes compacted by K4's block-wide body (k4_block) up
//            to each count, and the total (one atomic per warp)
//
// K1 as a team.  In the four-kernel K1 (k1_scan2_lane) one thread walks
// the main chain over a segment, then each of the NL leaders, then each
// live follower, one after another.  Here the team runs them at once, as
// a pipeline over segments: at step t thread 0 walks segment t of the main
// chain, the leaders segment t - 1 and the followers segment t - 2, each
// reading what the chains before it published for that segment through a
// ring in shared memory (the main chain's post-chunk state and count a row
// and the segment's bits, three slots; the leaders' state and count a row,
// two slots), with one __syncwarp a step.  A thread with more than one
// chain (CH + 1 > T) walks them in turn, each chain's state loaded from
// shared memory into registers for its walk.  Every role walks its rows by
// one body (team_walk), branch-free but for a merge, so that a warp's
// threads issue the same instructions whatever their role.  Once every
// chain of every team of a warp is resolved, its main chains go on alone
// (main_fast where a segment lies inside the lane).  Chains resolve and
// record exactly as in k1_scan2_lane; chains walked past the point where
// the serial body stops (it stops a segment early once nothing is live)
// record nothing that the maps read.  The walks are templated on md
// (2-8), so a segment's rows unroll, and step through a step table built
// in shared memory at launch (state as a byte offset: lookup, one LOP3,
// lookup), which K3 walks too.
//
// Each lane reads its words, and the halo words of lane g+1, straight from
// the (G, BW) lane words (LaneWords): no word matrix is built.  The wrapper
// allocates the scratch as one buffer cut by the plan; the kernel allocates
// nothing.  The dense rows are zero past each lane's count: K4 alone
// zeroes only past a lane's valid slots, and a lane that K3 replays to its
// end keeps the halo's symbols past its count.
//
// A grid barrier needs every block resident at once: the launcher refuses a
// plan outside its rules (oneshot_plan_ok), asks the occupancy calculator
// once per (device, shared bytes), and returns
// cudaErrorCooperativeLaunchTooLarge, without launching, when the grid does
// not fit the card's SMs.
//
// `stamps`, when not null, receives the device clock (%globaltimer, ns) at
// the start of block 0 and after each grid barrier, then the latest end of
// K3 and of K4 over all warps: the split of the launch by phase, which no
// profiler gives for one kernel.
//
// What bounds it on the H100: the main chain's dependent table lookups,
// one a 2-bit chunk of its lane (the chain floor), and while candidate
// chains live, a row of the team body for every role; its inputs and
// outputs are well under 1 MB a stream and stay in the 50 MB L2.

#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "widescan.cuh"

namespace cg = cooperative_groups;
using namespace ws;

namespace {

constexpr int THREADS = 128;   // a block
constexpr int MIN_BLOCKS = 4;  // an SM's blocks the registers allow

// int32 words of one team's shared memory: the chains' state (node, count,
// record, cumulative count), the main chain's count and exit, the ring of
// three main-chain slots (the segment's bits, then a row's state and
// count) and the ring of two leader slots (a row's state and count of each
// leader).  A multiple of 4, so that every team starts 16-byte aligned.
__host__ __device__ inline int team_words(int CH, int NL, int SEGH) {
  const int n = 4 * CH + 2 + 3 * (1 + 2 * SEGH) + 2 * (2 * SEGH * NL);
  return (n + 3) / 4 * 4;
}

struct Oneshot {
  const int32_t* words;  // (G, BW) lane words
  const uint32_t* tab;   // (2 * NS, 128) quad table
  const int32_t* lim;    // (G,) per-lane stream limits
  uint8_t* out;          // (G, ORP) dense rows
  int32_t* n;            // (G,) per-lane counts
  unsigned long long* total;  // () all counts
  // scratch
  int32_t* sym;      // (cells_p, G)
  uint8_t* val;      // (cells_p, G)
  int32_t* cntmap;   // (HP, G)
  int32_t* exmap;    // (HP, G)
  int32_t* mrowmap;  // (HP, G)
  uint8_t* gmap;     // (NGp, 128)
  int32_t* goff;     // (NGp,)
  uint8_t* tot;      // (128,)
  int32_t* entry;    // (G,)
  unsigned long long* stamps;  // (7,) phase clock, or null
  int G, BW, B, H, steps, steps_p, SEG, md, C0, C1, NS, ORP, L, NGp;
  int T;       // threads a lane
  K4Tile k4;   // K4's plan over a block's lanes
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One team's shared memory.
struct Team {
  int* base;
  int CH, NL, SEGH;
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

struct Chain {
  int node, cnt, rec, cum;  // the main chain: rec bit 0 = exited, cum = exit
};

// The step table: K1's quad table rewritten as one 32-bit entry a (state,
// 2-bit chunk), at byte offset state * 16 + chunk * 4: the post-chunk
// state's byte offset (state * 16, bits 4-13), emit (bit 14), pos (bit 15)
// and the symbol (bits 16-23).  A chain carries its state as that byte
// offset, so a step is lookup, one LOP3, lookup: no multiply, shift or
// select on the dependent path (the scans' byte offsets, stage_offset_table).
// Entry 0 (an invalid row) is the root with no emission, as in
// k1_scan2_lane.
constexpr int STEP_NODE = 0x3FF0;
constexpr int STEP_EMIT = 1 << 14;
constexpr int STEP_POS = 15;

__host__ __device__ constexpr int step_bytes(int NS) { return NS * 128 * 16; }

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

// The segment geometry of min code length MD, as ops/widescan.py _plan
// makes it: SEG bits, SEGH 2-bit chunks, CELLS cells of 2 * MD chunks.
template <int MD>
struct Seg {
  static constexpr int UNROLL = 4 * MD;
  static constexpr int SEG = UNROLL * (32 / UNROLL > 1 ? 32 / UNROLL : 1);
  static constexpr int SEGH = SEG / 2;
  static constexpr int CELLS = SEG / (MD * CELL);
};

// The bits [seg * SEG, seg * SEG + SEG) of lane g (SEG <= 32), or 0 past
// the last segment.
__device__ __forceinline__ uint32_t segment_bits(const LaneWords& words,
                                                 int seg, int S, int SEG,
                                                 int g) {
  if (seg >= S) return 0u;
  const int base = seg * SEG, wb = base & ~31;
  return (uint32_t)(load_bits64(words, wb, g) >> (base - wb));
}

// One chain's walk over the SEGH rows of a segment starting at bit `base`
// (K1's rules, k1_scan2_lane; states as step-table byte offsets): kind 0
// the main chain (writes the cells from cell0 on and, with `record`, its
// state and count a row into slot a), 1 a leader (start row srow,
// publishes into slot b as leader `li`), 2 a follower (start row srow,
// merges with the main chain or leader `li`, frozen once resolved).  `on`
// false walks nothing.  MAIN_ONLY drops the candidates' logic.  The rows
// are unrolled, so that a row's bookkeeping fills the next lookup's
// latency.  Returns whether a candidate resolved.
template <int MD, bool MAIN_ONLY>
__device__ __forceinline__ bool team_walk(
    Chain& ch, int kind, bool on, bool record, int srow, int li, int base,
    uint32_t bits, int lim, const int32_t* step, const Oneshot& a, int* sa,
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
                                          const Oneshot& a, int cell0,
                                          int g) {
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
__device__ __forceinline__ void zero_cells(const Oneshot& a, int seg,
                                           int cells_seg, int g) {
  for (int q = 0; q < cells_seg; ++q) {
    const size_t o = (size_t)(seg * cells_seg + q) * a.G + g;
    a.sym[o] = 0;
    a.val[o] = 0;
  }
}

// K1 of lane g by its team: thread j of T.
template <int MD>
__device__ __forceinline__ void k1_team(const Oneshot& a,
                                        const LaneWords& words,
                                        const int32_t* step, const Team& tm,
                                        int g, int j, int T,
                                        unsigned team_mask) {
  using SG = Seg<MD>;
  const int CH = tm.CH, NL = tm.NL, SEG = SG::SEG;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const int cells_seg = SG::CELLS;
  const int S = a.steps_p / SEG;
  const int lim = a.lim[g];
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

// K3 of lane g (k3_fix2_lane's rules on the step table): entered at e0 with
// cut row ct and cut slot cs, re-decode from e0 and splice the slots below
// cs into sym/val in place.
template <int MD>
__device__ __forceinline__ void k3_lane(const Oneshot& a,
                                        const LaneWords& words,
                                        const int32_t* step, int e0, int ct,
                                        int cs, int g) {
  using SG = Seg<MD>;
  if (ct <= 0) return;
  const int S = a.steps_p / SG::SEG;
  const int nseg = min((ct + SG::SEG - 1) / SG::SEG, S);
  const int ncell = nseg * SG::CELLS;
  const int C0 = a.C0 << 4, C1 = a.C1 << 4;
  int node = 0, wcur = -1;
  uint32_t word = 0;
  for (int c = 0; c < ncell && c * CELL < cs; ++c) {
    uint32_t cacc = 0, nacc = 0;
#pragma unroll
    for (int k = 0; k < 2 * MD; ++k) {
      const int jbit = c * CELL * MD + 2 * k;
      if ((jbit >> 5) != wcur) {
        wcur = jbit >> 5;
        word = words(wcur, g);
      }
      const int chunk4 = ((word >> (jbit & 31)) & 3) << 2;
      const bool started = jbit >= e0;
      const int e = started ? step_at(step, node | chunk4) : 0;
      if (started) node = e & STEP_NODE;
      if (e0 == jbit + 1) node = (chunk4 & 8) ? C1 : C0;
      if (e & STEP_EMIT) {
        const int sl = (2 * k + ((e >> STEP_POS) & 1)) / MD;
        cacc |= (uint32_t)((e >> 16) & 0xFF) << (8 * sl);
        nacc |= 1u << sl;
      }
    }
    const int kk = min(cs - c * CELL, CELL);  // > 0 by the loop bound
    const uint32_t vmask = (1u << kk) - 1u;
    const uint32_t smask = kk >= CELL ? 0xFFFFFFFFu : (1u << (8 * kk)) - 1u;
    const size_t o = (size_t)c * a.G + g;
    a.sym[o] = (int32_t)((cacc & smask) | ((uint32_t)a.sym[o] & ~smask));
    a.val[o] = (uint8_t)((nacc & vmask) | ((uint32_t)a.val[o] & ~vmask));
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

struct KeepArr {
  const int* keep;
  __device__ __forceinline__ int operator()(int l) const { return keep[l]; }
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    oneshot_kernel(Oneshot a) {
  extern __shared__ __align__(16) uint8_t smem_all[];
  cg::grid_group grid = cg::this_grid();
  int32_t* step = reinterpret_cast<int32_t*>(smem_all);
  uint8_t* smem = smem_all + step_bytes(a.NS);  // the phases' own space
  stage_step_table(step, a.tab, a.NS, a.C0, a.C1);
  __syncthreads();
  const int G = a.G, T = a.T;
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int nthreads = gridDim.x * THREADS;
  const int g = gt / T, j = gt & (T - 1);  // T divides 32
  const int CH = a.H - 1 > 1 ? a.H - 1 : 1;
  const int NL = a.md < CH ? a.md : CH;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const int SEGH = a.SEG / 2;
  const int team = threadIdx.x / T, lanes = THREADS / T;
  const LaneWords words{a.words, G, a.BW, (a.steps_p + 31) / 32};
  const bool lead = a.stamps && gt == 0;
  const bool warp_lead = a.stamps && (threadIdx.x & 31) == 0;
  if (gt == 0) *a.total = 0;
  if (lead) {
    a.stamps[0] = globaltimer();
    a.stamps[5] = a.stamps[6] = 0;
  }
  const Team tm{reinterpret_cast<int*>(smem) +
                    team * team_words(CH, NL, SEGH),
                CH, NL, SEGH};
  const int sub = (threadIdx.x & 31) & ~(T - 1);
  const unsigned team_mask =
      T == 32 ? 0xFFFFFFFFu : ((1u << T) - 1u) << sub;

  with_md(a.md, [&](auto md) {
    k1_team<decltype(md)::value>(a, words, step, tm, g, j, T, team_mask);
  });
  grid.sync();
  if (lead) a.stamps[1] = globaltimer();
  for (int idx = gt; idx < a.NGp * K2_NE; idx += nthreads)
    a.gmap[idx] = (uint8_t)k2_group_map(a.exmap, G, HP, a.L, idx / K2_NE,
                                        idx % K2_NE);
  grid.sync();
  if (lead) a.stamps[2] = globaltimer();
  if (blockIdx.x == 0) {  // stage the group maps, then K2's scan step
    uint4* gm4 = reinterpret_cast<uint4*>(smem);
    const uint4* src = reinterpret_cast<const uint4*>(a.gmap);
    for (int i = threadIdx.x; i < a.NGp * K2_NE / 16; i += THREADS)
      gm4[i] = __ldcg(src + i);
    __syncthreads();
    int st = threadIdx.x;  // THREADS == K2_NE entries
    for (int grp = 0; grp < a.NGp; ++grp) {
      if (threadIdx.x == 0) a.goff[grp] = st;
      st = smem[grp * K2_NE + st];
    }
    a.tot[threadIdx.x] = (uint8_t)st;
  }
  grid.sync();
  if (lead) a.stamps[3] = globaltimer();
  if (gt < a.NGp) k2_apply_group(a.exmap, a.goff, a.entry, G, HP, a.L, gt);
  grid.sync();
  if (lead) a.stamps[4] = globaltimer();

  // select_h / fix_rows: an entry outside [0, H) selects row 0
  int* keep = reinterpret_cast<int*>(
      smem + K4Tile::bytes(a.k4.LB, a.k4.nch, a.k4.W));
  int cnt = 0;
  if (j == 0) {
    const int e0 = a.entry[g];
    const size_t o = (size_t)(e0 >= 0 && e0 < a.H ? e0 : 0) * G + g;
    cnt = a.cntmap[o];
    int cut = e0 == 0 ? 0 : a.mrowmap[o] + 1;
    if (a.lim[g] <= 0) cut = 0;
    const int cut_slot = cut > 0 ? (cut - 1) / a.md + 1 : 0;
    a.n[g] = cnt;
    keep[team] = min(cnt, a.ORP);
    with_md(a.md, [&](auto md) {
      k3_lane<decltype(md)::value>(a, words, step, e0, cut, cut_slot, g);
    });
  }
  if (warp_lead) atomicMax(&a.stamps[5], globaltimer());
  __syncthreads();  // K3 wrote only its lanes' columns: the block's cells
  const int g0 = blockIdx.x * lanes;
  for (int s = 0; s < lanes; s += a.k4.LB)
    k4_block<false>(a.sym, a.val, a.out, G, a.steps_p / a.md / CELL, a.ORP,
                    g0 + s, a.k4.LB, a.k4, smem, KeepArr{keep + s});
  if (warp_lead) atomicMax(&a.stamps[6], globaltimer());
  const unsigned warp_sum = __reduce_add_sync(0xFFFFFFFFu, (unsigned)cnt);
  if ((threadIdx.x & 31) == 0)
    atomicAdd(a.total, (unsigned long long)warp_sum);
}

// The launcher's check of a plan (rules in ops/oneshot.py oneshot_plan).
bool oneshot_plan_ok(int G, int H, int md, int SEG, int NS, int ORP,
                     int NGp, int T, const K4Tile& k4, int shared) {
  const int CH = H - 1 > 1 ? H - 1 : 1, NL = md < CH ? md : CH;
  const int lanes = THREADS / (T > 0 ? T : 1);
  const int k4_need = K4Tile::bytes(k4.LB, k4.nch, k4.W) + 4 * lanes;
  const int phases = shared - step_bytes(NS);  // after the step table
  const int seg = 4 * md * (32 / (4 * md) > 1 ? 32 / (4 * md) : 1);
  return SEG == seg && T >= 4 && T <= 32 && (T & (T - 1)) == 0 &&
         T >= NL + 1 && G % lanes == 0 && shared % 16 == 0 &&
         phases >= 4 * lanes * team_words(CH, NL, SEG / 2) &&
         phases >= NGp * K2_NE && phases >= k4_need &&
         shared <= 227 * 1024 && k4.vec == 4 &&
         k4.LB >= 4 && lanes % k4.LB == 0 && k4.nch >= 1 &&
         k4.nch <= 32 && k4.threads() <= THREADS && k4.W >= 16 &&
         k4.W % 16 == 0 && k4.W <= ORP;
}

// The card's cooperative-launch facts, asked once per (device, shared
// bytes): whether it can, its SMs, and the blocks an SM holds.
struct Fit {
  int dev, shared, coop, sms, per_sm;
};
std::mutex fit_lock;
Fit fits[16];
int n_fits = 0;

cudaError_t fit(int shared, Fit& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(fit_lock);
  for (int i = 0; i < n_fits; ++i)
    if (fits[i].dev == dev && fits[i].shared == shared) {
      out = fits[i];
      return cudaSuccess;
    }
  Fit f{dev, shared, 0, 0, 0};
  err = cudaFuncSetAttribute(oneshot_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&f.coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &f.per_sm, oneshot_kernel, THREADS, shared);
  if (err != cudaSuccess) return err;
  if (n_fits < 16) fits[n_fits++] = f;
  out = f;
  return cudaSuccess;
}

}  // namespace

extern "C" int ws_oneshot(const int32_t* words, const uint32_t* tab,
                          const int32_t* lim, uint8_t* out, int32_t* n,
                          unsigned long long* total, uint8_t* scratch,
                          const long long* offsets, long long scratch_bytes,
                          unsigned long long* stamps, int G, int BW, int B,
                          int H, int steps, int steps_p, int SEG, int md,
                          int C0, int C1, int NS, int ORP, int L, int NGp,
                          int T, int k4_lanes, int k4_vec, int k4_chunks,
                          int k4_window, int shared, cudaStream_t stream) {
  const K4Tile k4{k4_lanes, k4_vec, k4_chunks, k4_window};
  if (G % 128 || BW * 32 != B || SEG / 2 > MAX_SEGH || SEG > 32 ||
      md > MAX_NL || md < 2 || H - 1 > MAX_CH || NS > MAX_NS ||
      SEG % (md * CELL) || steps_p % SEG || ORP % 128 ||
      NGp > K2_MAX_GROUPS || NGp * L != G || (uintptr_t)out % 16 ||
      (uintptr_t)scratch % 256 ||
      !oneshot_plan_ok(G, H, md, SEG, NS, ORP, NGp, T, k4, shared))
    return (int)cudaErrorInvalidValue;
  // the scratch cut: sym, val, the three maps, group maps, group entries,
  // composite map, entries, each 256-byte aligned and inside the buffer
  const long long cells_p = steps_p / md / CELL;
  const long long HP = ((H - 1 > 1 ? H - 1 : 1) + 1 + 7) / 8 * 8;
  const long long sizes[9] = {cells_p * G * 4, cells_p * G, HP * G * 4,
                              HP * G * 4,      HP * G * 4,  NGp * K2_NE,
                              NGp * 4,         K2_NE,       4LL * G};
  for (int i = 0; i < 9; ++i)
    if (offsets[i] % 256 || (i && offsets[i] < offsets[i - 1] + sizes[i - 1])
        || offsets[i] + sizes[i] > scratch_bytes)
      return (int)cudaErrorInvalidValue;
  Fit f;
  cudaError_t err = fit(shared, f);
  if (err != cudaSuccess) return (int)err;
  if (!f.coop) return (int)cudaErrorNotSupported;
  const int blocks = G * T / THREADS;
  if (f.per_sm * f.sms < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  Oneshot a{words,
            tab,
            lim,
            out,
            n,
            total,
            reinterpret_cast<int32_t*>(scratch + offsets[0]),
            scratch + offsets[1],
            reinterpret_cast<int32_t*>(scratch + offsets[2]),
            reinterpret_cast<int32_t*>(scratch + offsets[3]),
            reinterpret_cast<int32_t*>(scratch + offsets[4]),
            scratch + offsets[5],
            reinterpret_cast<int32_t*>(scratch + offsets[6]),
            scratch + offsets[7],
            reinterpret_cast<int32_t*>(scratch + offsets[8]),
            stamps,
            G, BW, B, H, steps, steps_p, SEG, md, C0, C1, NS, ORP, L, NGp,
            T, k4};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)oneshot_kernel,
                                          dim3(blocks), dim3(THREADS), args,
                                          shared, stream);
}
