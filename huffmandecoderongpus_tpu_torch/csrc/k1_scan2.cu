// K1: chunked main scan + self-synchronizing candidate discovery.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan2 /
// _k1_kernel2 (md >= 2).  The TPU kernel makes every step one all-lanes
// vector op and walks segments as a sequential grid dimension, carrying the
// chains' state in scratch from one grid step to the next.  Here one thread
// owns one lane and walks every segment of it: per segment the main chain
// (publishing its per-row state and count), then the md leaders
// (publishing theirs), then the live followers, which read both.  The
// per-segment scratch is SEG/2 <= 16 rows per lane.  Liveness is decided
// per lane instead of per row group, which changes no output: a resolved
// follower is frozen, leaders walk whenever any chain of their lane is
// live, and a lane whose stream has ended writes zero cells.  The TPU's
// follower groups (GROUP_W chains gated together) are not ported: a thread
// skips each resolved follower on its own.
//
// What bounds it on the H100: each lane is a chain of dependent table
// lookups (the quad table sits in shared memory), and the plan's G lanes
// (1K-16K) give at most a few warps per SM, so the kernel is latency-bound,
// not bandwidth-bound.  Word reads (lane-minor rows) and cell writes are
// coalesced across the lanes of a warp.

#include "widescan.cuh"

using namespace ws;

namespace {

__global__ void __launch_bounds__(128) k1_scan2_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int32_t* __restrict__ cntmap,
    int32_t* __restrict__ exmap, int32_t* __restrict__ mrowmap, int G,
    int steps_w, int B, int H, int steps, int steps_p, int SEG, int md,
    int C0, int C1, int NS) {
  __shared__ uint32_t tab_s[TAB_WORDS];
  load_table(tab_s, tab, NS);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;

  const int lim = lim2[g];
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
    const uint64_t bits = load_bits64(wmat, G, steps_w, wb, g);
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

}  // namespace

extern "C" const char* ws_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int ws_k1_scan2(const int32_t* wmat, const uint32_t* tab,
                           const int32_t* lim2, int32_t* sym, uint8_t* val,
                           int32_t* cntmap, int32_t* exmap, int32_t* mrowmap,
                           int G, int steps_w, int B, int H, int steps,
                           int steps_p, int SEG, int md, int C0, int C1,
                           int NS, cudaStream_t stream) {
  if (SEG / 2 > MAX_SEGH || md > MAX_NL || md < 2 || H - 1 > MAX_CH ||
      NS > MAX_NS || SEG % (md * CELL) || steps_p % SEG)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k1_scan2_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      wmat, tab, lim2, sym, val, cntmap, exmap, mrowmap, G, steps_w, B, H,
      steps, steps_p, SEG, md, C0, C1, NS);
  return (int)cudaGetLastError();
}
