// K1': 1-bit main scan + self-synchronizing candidate discovery (md = 1).
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k1_scan /
// _k1_kernel.  The design of k1_scan2.cu, one bit per step through the pair
// table: one thread owns one lane and walks its 32-bit segments (one
// payload word each) in order; per segment the main chain (publishing its
// per-bit state and count), then the leader (entry offset 1; md = 1 has one
// residue class), then the live followers, which read both.  The
// per-segment scratch is 32 rows, one per bit.  A chain starting at offset
// r walks from bit r and records a merge, a late exit or the stream end at
// the bit itself, where the chunked kernel records the chunk's second bit.
// Liveness is decided per lane, which changes no output (see k1_scan2.cu).
//
// What bounds it on the H100: as K1, each lane is a chain of dependent
// table lookups (the pair table, at most 8 rows of 128 words, sits in
// shared memory), so the kernel is latency-bound with a few warps per SM;
// md = 1 lanes walk one bit per lookup, half the bits per step of K1.

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int SEG1 = 32;                 // bits per segment: one word
constexpr int CELLS_SEG = SEG1 / CELL;   // md = 1: one slot per bit

__global__ void __launch_bounds__(128) k1_scan_kernel(
    const int32_t* __restrict__ wmat, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ lim2, int32_t* __restrict__ sym,
    uint8_t* __restrict__ val, int32_t* __restrict__ cntmap,
    int32_t* __restrict__ exmap, int32_t* __restrict__ mrowmap, int G,
    int steps_w, int B, int H, int steps, int steps_p, int NS) {
  __shared__ uint32_t tab_s[MAX_NS * 128];
  for (int i = threadIdx.x; i < NS * 128; i += blockDim.x) tab_s[i] = tab[i];
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;

  const int lim = lim2[g];
  const int CH = H - 1 > 1 ? H - 1 : 1;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const int S = steps_p / SEG1;

  // main chain (entry offset 0)
  int node0 = 0, cnt0 = 0, done0 = 0, exit0 = 0;
  // candidate chain of entry offset r lives at index r - 1: the leader is
  // offset 1, followers 2..CH
  int cnode[MAX_CH], ccnt[MAX_CH], crec[MAX_CH], ccum[MAX_CH];
  for (int c = 0; c < CH; ++c) cnode[c] = ccnt[c] = crec[c] = ccum[c] = 0;
  int unresolved = CH;
  // per-segment scratch, one row per bit: the main chain's state (-1 once
  // it has exited) and count, the leader's state (-1 once stopped) and
  // count
  int nscr[SEG1], cscr[SEG1], ldr[SEG1], lcn[SEG1];

  for (int s = 0; s < S; ++s) {
    const int base = s * SEG1;
    const int cell0 = s * CELLS_SEG;
    if (lim <= base) {  // the lane's stream ended before this segment
      for (int c = 0; c < CELLS_SEG; ++c) {
        sym[(size_t)(cell0 + c) * G + g] = 0;
        val[(size_t)(cell0 + c) * G + g] = 0;
      }
      continue;
    }
    const uint32_t word = s < steps_w ? (uint32_t)wmat[(size_t)s * G + g] : 0u;
    const bool live = unresolved > 0;

    // ---- main chain: one slot per bit, exit offset ----------------------
    for (int cc = 0; cc < CELLS_SEG; ++cc) {
      uint32_t cacc = 0, nacc = 0;
      for (int k = 0; k < CELL; ++k) {
        const int i = cc * CELL + k;
        const int j = base + i;
        const uint32_t e =
            lim > j ? pair_entry(tab_s, node0, (word >> i) & 1) : 0u;
        const Bit st = e1_fields(e, NS);
        node0 = st.node;
        const int emit = done0 ? 0 : st.emit;
        if (emit && j + 1 >= B) {
          exit0 = j + 1 - B;
          done0 = 1;
        }
        cnt0 += emit;
        if (live) {
          nscr[i] = done0 ? -1 : node0;
          cscr[i] = cnt0;
        }
        if (emit) {
          cacc |= (uint32_t)st.sym << (8 * k);
          nacc |= 1u << k;
        }
      }
      sym[(size_t)(cell0 + cc) * G + g] = (int32_t)cacc;
      val[(size_t)(cell0 + cc) * G + g] = (uint8_t)nacc;
    }
    if (!live) continue;

    // ---- leader (offset 1): walks past its own resolution, publishes ----
    {
      int node = cnode[0], cnt = ccnt[0], rec = crec[0], cum = ccum[0];
      for (int i = 0; i < SEG1; ++i) {
        const int j = base + i;
        const bool valid = lim > j;
        const uint32_t e =
            valid ? pair_entry(tab_s, node, (word >> i) & 1) : 0u;
        const Bit st = e1_fields(e, NS);
        const bool alive = !(rec & 1);
        const bool started = j >= 1;
        if (started) node = st.node;
        const int em = started ? st.emit : 0;
        cnt += em;
        const int nz = nscr[i];
        // a leader that resolved without merging walks on spuriously; past
        // the main chain's exit it tracks the halo, where md = 1 emits the
        // 1-bit symbol on every zero bit: publish -1 in both cases
        const bool lstop = (rec & 1) && !((rec >> 1) & 1);
        ldr[i] = (lstop || nz == -1) ? -1 : node;
        lcn[i] = cnt;
        if (alive && started) {
          if (valid && node == nz) {  // state-merged with the main chain
            rec = (j << 3) | 3;
            cum = cscr[i] - cnt;
          } else if (em && j + 1 >= B) {  // late exit
            rec = (j << 3) | 1;
            cum = cnt;
          } else if (!valid) {  // stream end: a late exit at row B-1
            rec = ((B - 1) << 3) | 1;
            cum = cnt;
          }
          if (rec & 1) --unresolved;
        }
      }
      cnode[0] = node;
      ccnt[0] = cnt;
      crec[0] = rec;
      ccum[0] = cum;
    }

    // ---- followers: merge with the main chain or the leader -------------
    for (int r = 2; r <= CH; ++r) {
      const int c = r - 1;
      if (crec[c] & 1) continue;  // resolved: frozen
      int node = cnode[c], cnt = ccnt[c], rec = 0, cum = ccum[c];
      for (int i = 0; i < SEG1; ++i) {
        const int j = base + i;
        if (j < r) continue;  // not started
        const bool valid = lim > j;
        const uint32_t e =
            valid ? pair_entry(tab_s, node, (word >> i) & 1) : 0u;
        const Bit st = e1_fields(e, NS);
        node = st.node;
        cnt += st.emit;
        if (valid && node == nscr[i]) {
          rec = (j << 3) | 3;
          cum = cscr[i] - cnt;
        } else if (valid && node == ldr[i]) {
          rec = (j << 3) | 5;
          cum = lcn[i] - cnt;
        } else if (st.emit && j + 1 >= B) {
          rec = (j << 3) | 1;
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

  // ---- epilogue: the leader first, followers compose through it ----------
  write_maps(cntmap, exmap, mrowmap, G, g, cnt0, exit0, ccnt, crec, ccum, CH,
             1, HP, 1, B, steps);
}

}  // namespace

extern "C" int ws_k1_scan(const int32_t* wmat, const uint32_t* tab,
                          const int32_t* lim2, int32_t* sym, uint8_t* val,
                          int32_t* cntmap, int32_t* exmap, int32_t* mrowmap,
                          int G, int steps_w, int B, int H, int steps,
                          int steps_p, int NS, cudaStream_t stream) {
  if (H - 1 > MAX_CH || NS > MAX_NS || steps_p % SEG1)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  k1_scan_kernel<<<(G + threads - 1) / threads, threads, 0, stream>>>(
      wmat, tab, lim2, sym, val, cntmap, exmap, mrowmap, G, steps_w, B, H,
      steps, steps_p, NS);
  return (int)cudaGetLastError();
}
