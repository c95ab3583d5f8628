// K1': 1-bit main scan + self-synchronizing candidate discovery (md = 1).
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan /
// _k1_kernel.  The design of K1 (widescan.cuh k1_team) on rows of one bit:
// each lane has a team of T threads of one warp (ops/k1_scan.py
// k1_scan_plan picks T, and the launcher refuses any other plan): thread 0
// walks the main chain, which writes the cells, thread 1 first the leader
// (entry offset 1; md = 1 has one residue class), and the followers
// (offsets 2..CH) share threads 1.., chain c on thread 1 + c % (T - 1).
// The team runs them as a pipeline over 32-bit segments (one payload word
// each): at step t thread 0 walks segment t of the main chain, the leader
// segment t - 1 and the followers segment t - 2, each reading what the
// chains before it published for that segment through rings in shared
// memory (the main chain's state and count a bit and the segment's word,
// three slots; the leader's state and count a bit, two slots), with one
// __syncwarp a step.  A step walks each thread's chains still unresolved in
// passes, as many as the most any thread of the warp has, so that a
// thread's resolved chains cost nothing; a resolved leader is walked no
// more and publishes -1.  A segment inside the lane (below the stream limit
// and row B - 1) goes through fast1, one instruction stream for every role
// with nothing checked on a bit: a candidate compares its state with the
// main chain's (and a follower with the leader's) at the segment's end
// only, and walks the segment again to find the merge bit once it has
// merged (merged1); the lane's other segments go through walk1.  Liveness
// is a warp vote, so every thread of a warp runs the body: the grid is
// G * T threads rounded up to whole blocks, and the threads past the last
// lane walk nothing.  Once every chain of a warp's teams has resolved, its
// main chains go on alone, two bits a lookup where a segment lies inside
// the lane (main_fast2 on a 2-bit step table).  Every other step is one
// lookup in the 1-bit step table (widescan.cuh stage_step_table1); both
// tables are staged in shared memory at launch, and a step is lookup, one
// LOP3, lookup.
//
// Exactness, by the TPU kernel's rules: a chain that starts
// at offset r walks from bit r; a merge, a late exit or the stream end is
// recorded at the bit itself (the chunked kernels record a chunk's second
// bit); a leader that stopped without merging, or that runs past the main
// chain's exit, publishes -1 (a leader merged with the main chain would
// publish the main chain's state, which a follower meets first as the main
// chain's, so -1 is the same to the followers); a stream end is recorded
// at row B - 1; a lane past its stream end writes zero cells; write_maps
// writes the maps.  A chain walks only segments that start below its
// lane's stream limit, so one whose lane ends on a segment boundary can
// stay unresolved, which write_maps reports as it reports a stream end
// (the raw count, exit 0, no merge row).
//
// What bounds it on the H100: the main chain's dependent lookups, one a bit
// (the chain floor, about 40 cycles a bit) while the candidates live, one
// a 2-bit chunk after; while candidates live, a pass of the team body a
// step, which issues for every role.

#include <climits>

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int SEG1 = 32;             // bits a segment: one word
constexpr int CELLS1 = SEG1 / CELL;  // md = 1: a slot a bit
constexpr int MIN_BLOCKS = 4;        // an SM's blocks the registers allow

// The main chain's 2-bit step table: one entry a (state, 2-bit chunk), at
// byte offset state * 16 + chunk * 4: the post-chunk state's byte offset in
// this table (state * 16, bits 4-13), the emission flags of the chunk's
// first and second bit (bits 14 and 15), and the symbols of both bits'
// slots (bits 16-23 and 24-31, zero where nothing is emitted).  Two
// emissions in one chunk end a code on its first bit and a 1-bit code on
// its second, so both fit: a cell of 4 bits is two lookups, and its
// symbols one LOP3.
constexpr int STEP2_NODE = 0x3FF0;

__host__ __device__ constexpr int step2_bytes(int NS) {
  return NS * 128 * 16;
}

// The 2-bit step table of pair table `tab` (NS, 128) into shared memory, by
// all threads of the block.
__device__ __forceinline__ void stage_step_table2(int32_t* step2,
                                                  const uint32_t* tab,
                                                  int NS) {
  for (int i = threadIdx.x; i < NS * 512; i += blockDim.x) {
    const int b0 = i & 1, b1 = (i >> 1) & 1;
    const Bit f = e1_fields((__ldg(&tab[i >> 2]) >> (b0 << 4)) & 0xFFFFu, NS);
    const Bit t = e1_fields((__ldg(&tab[f.node]) >> (b1 << 4)) & 0xFFFFu, NS);
    step2[i] = t.node << 4 | f.emit << 14 | t.emit << 15 |
               (f.emit ? f.sym : 0) << 16 | (t.emit ? t.sym : 0) << 24;
  }
}

// Lane g's word `seg` (its bits [32 seg, 32 seg + 32)), 0 past the last
// segment.
__device__ __forceinline__ uint32_t seg_word(const WmatWords& words, int seg,
                                             int S, int g) {
  return seg < S ? words(seg, g) : 0u;
}

// One chain's walk over the 32 bits of a segment starting at bit `base`
// (states as step-table byte offsets), with every check of a bit: kind 0
// the main chain (writes the cells from cell0 on and, with `record`, its
// state and count a bit into slot a), 1 the unresolved leader (publishes
// its state and count a bit into slot b), 2 an unresolved follower (merges
// with the main chain or the leader, frozen once resolved); a candidate
// starts at bit srow.  MAIN_ONLY drops the candidates' logic.  The bits are
// unrolled, every role one instruction stream but for a merge.  Returns
// whether a candidate resolved.
template <bool MAIN_ONLY>
__device__ __forceinline__ bool walk1(Chain& ch, int kind, bool record,
                                      int srow, int base,
                                      uint32_t bits, int lim,
                                      const int32_t* step, const K1Args& a,
                                      int* sa, int* sb, int cell0, int g) {
  const bool is_main = MAIN_ONLY || kind == 0;
  const bool is_fol = !MAIN_ONLY && kind == 2;
  int node = ch.node, cnt = ch.cnt, rec = ch.rec, cum = ch.cum;
  bool frozen = false;
  const int B = a.B;
#pragma unroll
  for (int cc = 0; cc < CELLS1; ++cc) {
    uint32_t cacc = 0, nacc = 0;
#pragma unroll
    for (int k = 0; k < CELL; ++k) {
      const int i = cc * CELL + k;
      const int j = base + i;
      const bool valid = lim > j;
      const int e = valid && !frozen
                        ? step_at(step, node | (((bits >> i) & 1) << 2))
                        : 0;
      const bool upd = (MAIN_ONLY || j >= srow) && !frozen;
      if (upd) node = e & STEP1_NODE;
      int em = upd && (e & STEP1_EMIT) ? 1 : 0;
      if (is_main) {
        if (rec & 1) em = 0;  // past the exit: no more emissions
        if (em && j + 1 >= B) {
          cum = j + 1 - B;
          rec |= 1;
        }
      }
      cnt += em;
      if (!MAIN_ONLY) {
        // slot a: [1 + i] the main chain's state after bit i (-1 once it
        // has exited), [1 + SEG1 + i] its count; slot b: [i] the leader's
        // state (-1 once stopped), [SEG1 + i] its count
        const int nz = sa[1 + i];
        const bool lstop = (rec & 1) && !((rec >> 1) & 1);
        if (is_main ? record : kind == 1) {
          int* pst = is_main ? sa + 1 + i : sb + i;
          const bool gone = is_main ? (rec & 1) : (lstop || nz == -1);
          pst[0] = gone ? -1 : node;
          pst[SEG1] = cnt;
        }
        const bool chk = !is_main && !frozen && !(rec & 1) && upd;
        const bool m1 = chk && valid && node == nz;  // merged, main chain
        const bool m2 = chk && !m1 && is_fol && valid && node == sb[i];
        const bool lx = chk && !m1 && !m2 && em && j + 1 >= B;
        const bool se = chk && !m1 && !m2 && !lx && !valid;  // stream end
        if (m1 | m2) {  // the merge partner's count on this bit
          cum = (m1 ? sa[1 + SEG1 + i] : sb[SEG1 + i]) - cnt;
          rec = (j << 3) | (m1 ? 3 : 5);
        }
        cum = lx | se ? cnt : cum;
        rec = lx ? (j << 3) | 1 : se ? ((B - 1) << 3) | 1 : rec;
        frozen = frozen || (is_fol && (rec & 1));
      }
      if (is_main && em) {
        cacc |= ((uint32_t)e >> 16) << (8 * k);
        nacc |= 1u << k;
      }
    }
    if (is_main) {
      const size_t o = (size_t)(cell0 + cc) * a.G + g;
      a.sym[o] = (int32_t)cacc;
      a.val[o] = (uint8_t)nacc;
    }
  }
  ch = Chain{node, cnt, rec, cum};
  return !is_main && (rec & 1);
}

// The walks over a segment inside the lane: below the lane's stream limit
// and row B - 1, so that every bit is valid and no emission is the main
// chain's exit or a late exit.  There they do what walk1 does, with nothing
// else on a bit.

// The main chain alone, two bits a lookup in the 2-bit step table: a
// cell's two lookups, then its symbols one LOP3 and its valid nibble, which
// the next cell's lookups overlap.  The chain's state is carried as a
// 1-bit table offset (state * 8) and doubled for the walk.
__device__ __forceinline__ void main_fast2(Chain& m, uint32_t bits,
                                           const int32_t* step2,
                                           const K1Args& a, int cell0,
                                           int g) {
  int node = m.node << 1, cnt = m.cnt;
#pragma unroll
  for (int cc = 0; cc < CELLS1; ++cc) {
    const uint32_t ea = (uint32_t)step_at(
        step2, node | (((bits >> (cc * CELL)) & 3) << 2));
    node = (int)ea & STEP2_NODE;
    const uint32_t eb = (uint32_t)step_at(
        step2, node | (((bits >> (cc * CELL + 2)) & 3) << 2));
    node = (int)eb & STEP2_NODE;
    const uint32_t nacc = ((ea >> 14) & 3u) | ((eb >> 12) & 0xCu);
    cnt += __popc(nacc);
    const size_t o = (size_t)(cell0 + cc) * a.G + g;
    a.sym[o] = (int32_t)((ea >> 16) | (eb & 0xFFFF0000u));
    a.val[o] = (uint8_t)nacc;
  }
  m.node = node >> 1;
  m.cnt = cnt;
}

// Any role in the team's pass, its chain's state and count carried in
// `node` and `cnt`: the main chain (writes its cells from cell0 on), the
// leader and the followers, with no check on a bit; with `pub` it
// publishes its state and count a bit at pst[i] and pst[SEG1 + i] (the
// main chain into slot a, the leader into slot b).  One instruction stream
// for every role, so that a warp walks the main chains and the candidates
// at once.  START: the candidate starts inside the segment, at bit srow,
// and the bits before it change nothing.
template <bool START>
__device__ __forceinline__ void fast1(int& node, int& cnt, bool is_main,
                                      bool pub, int srow, int base,
                                      uint32_t bits, const int32_t* step,
                                      const K1Args& a, int* pst, int cell0,
                                      int g) {
#pragma unroll
  for (int cc = 0; cc < CELLS1; ++cc) {
    uint32_t cacc = 0, nacc = 0;
#pragma unroll
    for (int k = 0; k < CELL; ++k) {
      const int i = cc * CELL + k;
      const int e = step_at(step, node | (((bits >> i) & 1) << 2));
      const bool act = !START || base + i >= srow;
      const int em = act ? (e >> 15) & 1 : 0;
      node = act ? e & STEP1_NODE : node;
      cnt += em;
      cacc |= ((uint32_t)e >> 16) << (8 * k);
      nacc |= (uint32_t)em << k;
      if (pub) {
        pst[i] = node;
        pst[SEG1 + i] = cnt;
      }
    }
    if (is_main) {
      const size_t o = (size_t)(cell0 + cc) * a.G + g;
      a.sym[o] = (int32_t)cacc;
      a.val[o] = (uint8_t)nacc;
    }
  }
}

// After a candidate's fast walk of a segment from (node0, cnt0): whether
// it merged there.  Two states that agree once agree on every later bit, so
// it merged in this segment if and only if its state at the segment's end
// is the main chain's, or (a follower) the leader's; only then is the
// segment walked again to find the merge bit (the first where its state is
// the main chain's, else the leader's) and the partner's count there.  A
// follower stops at its merge; the leader walks on (its state and count are
// the walk's).
__device__ __forceinline__ bool merged1(Chain& ch, int kind, int node0,
                                        int cnt0, int srow, int base,
                                        uint32_t bits, const int32_t* step,
                                        const int* sa, const int* sb) {
  const bool is_fol = kind == 2;
  if (ch.node != sa[SEG1] && !(is_fol && ch.node == sb[SEG1 - 1]))
    return false;
  int node = node0, cnt = cnt0;
  for (int i = 0; i < SEG1; ++i) {
    if (base + i < srow) continue;
    const int e = step_at(step, node | (((bits >> i) & 1) << 2));
    node = e & STEP1_NODE;
    cnt += (e >> 15) & 1;
    const bool m1 = node == sa[1 + i];
    if (m1 || (is_fol && node == sb[i])) {
      ch.cum = (m1 ? sa[1 + SEG1 + i] : sb[SEG1 + i]) - cnt;
      ch.rec = ((base + i) << 3) | (m1 ? 3 : 5);
      if (is_fol) {
        ch.node = node;
        ch.cnt = cnt;
      }
      return true;
    }
  }
  return false;  // not reached: the states agree at the segment's end
}

__global__ void __launch_bounds__(K1_THREADS, MIN_BLOCKS) k1_scan_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, K1Args a, int steps_w, int H, int NS,
    int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* step = reinterpret_cast<int32_t*>(smem);
  int32_t* step2 = reinterpret_cast<int32_t*>(smem + step1_bytes(NS));
  stage_step_table1(step, tab, NS);
  stage_step_table2(step2, tab, NS);
  __syncthreads();
  const int gt = blockIdx.x * K1_THREADS + threadIdx.x;
  const int g = gt / T, j = gt & (T - 1);  // T divides 32
  const bool real = g < a.G;               // else a thread past the lanes
  const int CH = H - 1 > 1 ? H - 1 : 1;
  const Team tm{reinterpret_cast<int*>(smem + step1_bytes(NS) +
                                       step2_bytes(NS)) +
                    (int)(threadIdx.x / T) * team_words(CH, 1, SEG1),
                CH, 1, SEG1};
  const unsigned tmask = team_mask(T);
  const WmatWords words{wmat, a.G, steps_w};
  const int S = a.steps_p / SEG1;
  const int lim = real ? lim2[g] : INT_MIN;
  const int per = T - 1;  // chain threads
  const int kmax = (CH + per - 1) / per;
  Chain m{0, 0, 0, 0};
  int unres = 0;  // this thread's unresolved chains
  if (j > 0)
    for (int c = j - 1; c < CH; c += per) {
      tm.node()[c] = tm.cnt()[c] = tm.rec()[c] = tm.cum()[c] = 0;
      ++unres;
    }
  uint32_t next = j == 0 && real ? seg_word(words, 0, S, g) : 0u;
  __syncwarp();

  int it = 0;
  for (; it < S + 2; ++it) {
    const bool mine = unres > 0 && lim > max(it - 2, 0) * SEG1;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, mine);
    if (!ball) break;  // every chain of the warp's teams resolved
    const bool live = (ball & tmask) != 0;
    // a resolved leader is walked no more: its state could only repeat the
    // main chain's (merged) or be -1 (stopped), and a follower merges with
    // the main chain first, so it publishes -1 for the followers
    if (j == 1 && live && it >= 1 && it - 1 < S && (tm.rec()[0] & 1)) {
      int* sb = tm.slot_b(it - 1);
      for (int i = 0; i < SEG1; ++i) sb[i] = -1;
    }
    // this thread's chains to walk this step (bit k: chain j - 1 + k * per),
    // walked in passes: pass p takes each thread's p-th, so that a step
    // costs the most any thread has, not the most it could have
    uint64_t todo = 0;
    if (j > 0 && live)
      for (int k = 0; k < kmax; ++k) {
        const int c = j - 1 + k * per, seg = it - (c < 1 ? 1 : 2);
        if (c < CH && seg >= 0 && seg < S && lim > seg * SEG1 &&
            !(tm.rec()[c] & 1))
          todo |= 1ull << k;
      }
    const int passes = (int)__reduce_max_sync(
        0xFFFFFFFFu, j == 0 ? (it < S ? 1u : 0u) : (unsigned)__popcll(todo));
    for (int pass = 0; pass < passes; ++pass) {
      int kind = 0, seg = it, c = 0;
      bool on;
      uint32_t bits;
      Chain ch;
      if (j == 0) {
        on = pass == 0 && seg < S;
        bits = next;
        if (on && real) next = seg_word(words, seg + 1, S, g);
        ch = m;
      } else {
        on = todo != 0;
        const int k = on ? __ffsll((long long)todo) - 1 : 0;
        todo &= todo - 1;
        c = j - 1 + k * per;
        kind = c < 1 ? 1 : 2;
        seg = it - kind;
        bits = on ? (uint32_t)tm.slot_a(seg)[0] : 0u;
        ch = on ? Chain{tm.node()[c], tm.cnt()[c], tm.rec()[c], tm.cum()[c]}
                : Chain{0, 0, 0, 0};
      }
      const int base = seg * SEG1;
      const int srow = kind == 0 ? 0 : c + 1;
      // inside the lane: every bit valid, no exit
      const bool fast = base + SEG1 <= lim && base + SEG1 < a.B;
      int* sa = tm.slot_a(seg < 0 ? 0 : seg);
      int* sb = tm.slot_b(seg < 0 ? 0 : seg);
      if (j == 0 && on && lim <= base) {  // the stream ended before it
        if (real) zero_cells(a, seg, CELLS1, g);
        on = false;
      }
      if (on && srow >= base + SEG1) on = false;  // not started: a no-op
      if (j == 0 && on && live) sa[0] = (int)bits;
      bool res = false;
      if (on && fast) {
        const int node0 = ch.node, cnt0 = ch.cnt;
        int* pst = kind == 0 ? sa + 1 : sb;
        const bool pub = kind == 0 ? live : kind == 1;
        if (base < srow)
          fast1<true>(ch.node, ch.cnt, kind == 0, pub, srow, base, bits,
                      step, a, pst, seg * CELLS1, g);
        else
          fast1<false>(ch.node, ch.cnt, kind == 0, pub, srow, base, bits,
                       step, a, pst, seg * CELLS1, g);
        if (kind != 0)
          res = merged1(ch, kind, node0, cnt0, srow, base, bits, step, sa,
                        sb);
      } else if (on) {
        res = walk1<false>(ch, kind, live, srow, base, bits, lim, step, a,
                           sa, sb, seg * CELLS1, g);
      }
      if (res) --unres;
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
  if (j == 0 && real)
    for (int seg = it; seg < S; ++seg) {
      const uint32_t bits = next;
      next = seg_word(words, seg + 1, S, g);
      const int base = seg * SEG1;
      if (lim <= base) {
        zero_cells(a, seg, CELLS1, g);
        continue;
      }
      if (base + SEG1 <= lim && base + SEG1 < a.B)
        main_fast2(m, bits, step2, a, seg * CELLS1, g);
      else
        walk1<true>(m, 0, false, 0, base, bits, lim, step, a, nullptr,
                    nullptr, seg * CELLS1, g);
    }
  __syncwarp();
  // ---- the maps: the leader first, followers compose through it ----------
  if (j == 0 && real)
    write_maps(a.cntmap, a.exmap, a.mrowmap, a.G, g, m.cnt, m.cum, tm.cnt(),
               tm.rec(), tm.cum(), CH, 1, (CH + 1 + 7) / 8 * 8, 1, a.B,
               a.steps);
}

// The launcher's check of a plan (rules in ops/k1_scan.py k1_scan_plan): T
// threads a lane, `shared` dynamic bytes a block of K1_THREADS (the step
// table, then the teams).
bool k1_scan_plan_ok(int G, int H, int NS, int T, int shared) {
  if (H - 1 > MAX_CH || NS < 1 || NS > MAX_NS || T < 4 || T > 32 ||
      (T & (T - 1)))
    return false;
  const int CH = H - 1 > 1 ? H - 1 : 1;
  return G >= 1 && shared % 16 == 0 &&
         shared >= step1_bytes(NS) + step2_bytes(NS) +
                       4 * (K1_THREADS / T) * team_words(CH, 1, SEG1) &&
         shared <= 227 * 1024;
}

std::atomic<unsigned> opted_in{0};

}  // namespace

extern "C" int ws_k1_scan(const int32_t* wmat, const uint32_t* tab,
                          const int32_t* lim2, int32_t* sym, uint8_t* val,
                          int32_t* cntmap, int32_t* exmap, int32_t* mrowmap,
                          int G, int steps_w, int B, int H, int steps,
                          int steps_p, int NS, int T, int shared,
                          cudaStream_t stream) {
  if (!k1_scan_plan_ok(G, H, NS, T, shared) || steps_p % SEG1 ||
      steps_w * 32 < steps_p)
    return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = allow_shared((const void*)k1_scan_kernel,
                                         opted_in);
    if (err != cudaSuccess) return (int)err;
  }
  const K1Args a{sym, val, cntmap, exmap, mrowmap, G, B, steps, steps_p,
                 0, 0};
  const long long threads = (long long)G * T;
  k1_scan_kernel<<<(int)((threads + K1_THREADS - 1) / K1_THREADS),
                   K1_THREADS, shared, stream>>>(wmat, tab, lim2, a, steps_w,
                                                 H, NS, T);
  return (int)cudaGetLastError();
}
