// E3: every lane's dense granules, shifted to its phase, into the payload.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_encode.py e3_place /
// _e3_kernel, and with it the two steps before it in encode_program: the
// lanes' exclusive bit offsets P (a cumsum; phase a = P & 15, granule
// offset W = P >> 4) and shift_lanes (:295-305).  Lane g's shifted granule
// i is (d[i] << a & 0xFFFF) | d[i-1] >> (16 - a), d its dense row of
// denseT (G, ORP) masked to cnt[g] granules; its first min(occ, ORP)
// granules, occ = ((a + L - 1) >> 4) + 1 for L = bits[g] > 0 code bits
// (else 0), land at payload granules W + i.  out (NROWS, 128) int32 holds
// the payload's u16 granules, zero past the last code bit.  A lane whose
// count reached ORP keeps ORP granules (encode_lanes then runs E2 and E3
// again with a larger ORP).  Where lanes share a granule their bit ranges
// are disjoint, and the plain version adds their values (ADD equals OR on
// disjoint bits); the kernel adds them too, so it matches on any input.
//
// The TPU kernel ORs each lane's whole (ORPW + 1, 128) window into the
// resident output in grid order.  Here every output granule is written
// once, with no atomic and no memset before the launch.  Granule k belongs
// to the lane whose bit range holds its first bit 16k: the last lane with
// P <= 16k (that lane has bits whenever 16k < the total; P is
// nondecreasing and equal across empty lanes).  Its value is that lane's
// shifted granule k - W (zero past min(occ, ORP)) plus the first granules
// of the lanes after it that start inside the granule (P < 16k + 16):
// lanes of fewer than 16 bits, empty lanes and the short last lane make
// that any number of lanes.  Granules from ceil(total / 16) to the end of
// out have no owner and are written as zero.
//
// A block owns a tile of LT neighbouring lanes and writes the granules its
// lanes own, [ceil(P[g0] / 16), ceil(P[g0 + LT] / 16)), the last tile also
// the slack up to NROWS * 128, so the tiles cover out once:
//   1. its threads sum bits[0, g0) (16-byte loads where aligned; at most G
//      int32 a block, from L2): the tile's first offset, with no look-back
//      chain between blocks and no cumsum launch;
//   2. the block scans the bits of the tile's lanes and of EXTRA lanes
//      after it into offsets in shared memory, with their counts and each
//      one's first shifted granule (what it adds to a shared granule);
//   3. a warp takes a lane at a time and writes the granules it owns,
//      [ceil(P / 16), ceil(Pn / 16)) for the next lane's offset Pn, a
//      granule a thread and UNROLL chunks of 32 in flight: its dense word
//      from the row (coalesced), d[i-1] from the neighbour thread by a
//      shuffle, the shifted granule shift_lanes gives ((d[i] << a) &
//      0xFFFF | d[i-1] >> (16 - a), d masked to the count, d[-1] = 0, the
//      right shift arithmetic; zero from ORP on), and at the lane's last
//      granule the followers' first granules from shared memory (past the
//      staged lanes, from device memory); one coalesced store a granule.
//      The last tile also writes the zeros after the last code bit.
//
// What bounds it on the H100: bytes, each lane's counted granules read
// once (the word before a granule is the neighbour thread's, from L1), the
// payload written once, bits and cnt.  Before, the torch passes of the
// offsets and shift_lanes read and wrote (G, ORP) int32 about eight times,
// a memset zeroed the payload, and a thread a granule slot (1.6 times the
// mean count) wrote with atomicOr at a lane's two ends.  The plan
// (ops/e3_place.py e3_plan: LT, threads) is checked by the launcher
// (e3_plan_ok).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LANES = 256;  // lanes a tile, at most a thread each
constexpr int EXTRA = 32;       // lanes after the tile staged for followers
constexpr int UNROLL = 4;       // chunks of 32 granules a warp has in flight
constexpr int STAGED = MAX_LANES + EXTRA;  // at most two rounds
static_assert(STAGED <= 2 * THREADS, "two rounds of staged lanes");

// A follower's part of a shared granule: its first shifted granule.
__device__ __forceinline__ int32_t first_granule(
    const int32_t* __restrict__ dense, const int32_t* __restrict__ cnt,
    int g, int ORP, long long P) {
  return cnt[g] > 0 ? (int32_t)(((uint32_t)__ldg(dense + (size_t)g * ORP)
                                 << (int)(P & 15)) & 0xFFFFu)
                    : 0;
}

__global__ void __launch_bounds__(THREADS) e3_place_kernel(
    const int32_t* __restrict__ dense, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ bits, int32_t* __restrict__ out,
    int G, int ORP, long long n_out, int LT) {
  __shared__ long long P_s[STAGED + 1];  // offsets, then the end of the last
  __shared__ int C_s[STAGED];            // counts
  __shared__ int32_t F_s[STAGED];        // first shifted granules (L > 0)
  __shared__ long long part_s[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g0 = blockIdx.x * LT, g1 = min(g0 + LT, G);
  const int ns = min(LT + EXTRA, G - g0);  // lanes staged

  // the staged lanes' bits, counts and first dense words (at most two
  // rounds of THREADS lanes), loaded beside the sum below
  int Lr[2], Cr[2];
  int32_t Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = r * THREADS + t;
    const bool in = l < ns;
    Lr[r] = in ? __ldg(bits + g0 + l) : 0;
    Cr[r] = in ? __ldg(cnt + g0 + l) : 0;
    Dr[r] = in ? __ldg(dense + (size_t)(g0 + l) * ORP) : 0;
  }

  // 1. the tile's first offset
  long long before = 0;
  {
    long long s = 0;
    int i = t;
    if ((uintptr_t)bits % 16 == 0) {
      const int4* b4 = reinterpret_cast<const int4*>(bits);
#pragma unroll 4
      for (; 4 * i + 3 < g0; i += THREADS) {
        const int4 v = __ldg(b4 + i);
        s += (long long)v.x + v.y + v.z + v.w;
      }
      i = (g0 & ~3) + t;
    }
    for (; i < g0; i += THREADS) s += __ldg(bits + i);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) s += __shfl_xor_sync(~0u, s, d);
    if (lane == 0) part_s[warp] = s;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) before += part_s[w];
    __syncthreads();  // part_s is reused below
  }

  // 2. offsets of the staged lanes, a round of THREADS lanes at a time
  long long carry = before;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r > 0 && THREADS >= ns) continue;  // the same in every thread
    const int l = r * THREADS + t;
    const int L = Lr[r];
    long long x = L;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(~0u, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) part_s[warp] = x;
    __syncthreads();
    long long pre = carry;
    for (int w = 0; w < warp; ++w) pre += part_s[w];
    const long long P = pre + x - L;
    if (l < ns) {
      P_s[l] = P;
      C_s[l] = Cr[r];
      // what the lane adds to a granule it starts inside: its first
      // shifted granule
      F_s[l] = L > 0 && Cr[r] > 0
                   ? (int32_t)(((uint32_t)Dr[r] << (int)(P & 15)) & 0xFFFFu)
                   : 0;
      if (l == ns - 1) P_s[ns] = P + L;
    }
    for (int w = 0; w < THREADS / 32; ++w) carry += part_s[w];
    __syncthreads();
  }
  const int nt = g1 - g0;  // the tile's lanes

  // 3. a warp a lane: the granules lane l owns, [ceil(P / 16), ceil(Pn /
  // 16)), 32 * UNROLL at a time, a granule a thread, its dense words in
  // flight together; d[i - 1] is the neighbour thread's (the previous
  // chunk's last for thread 0)
  for (int l = warp; l < nt; l += THREADS / 32) {
    const long long P = P_s[l], Pn = P_s[l + 1];
    if (Pn == P) continue;  // an empty lane owns no granule
    const int a = (int)(P & 15);
    const long long W = P >> 4;
    const long long k_end = min((Pn + 15) >> 4, n_out);  // past its last
    const long long k_last = (Pn - 1) >> 4;  // its last code bit's granule
    const int c = min(C_s[l], ORP);  // counted words in the row
    const int32_t* row = dense + (size_t)(g0 + l) * ORP;
    const int i0 = a > 0;  // a lane starting mid-granule does not own it
    int32_t carry = i0 && c > 0 ? __ldg(row) : 0;  // d[i0 - 1]
    for (long long kb = W + i0; kb < k_end; kb += 32 * UNROLL) {
      const int ib = (int)(kb - W) + lane;
      int32_t d[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        d[u] = ib + 32 * u < c ? __ldg(row + ib + 32 * u) : 0;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        int32_t prev = __shfl_up_sync(~0u, d[u], 1);
        if (lane == 0) prev = carry;
        carry = __shfl_sync(~0u, d[u], 31);
        const int i = ib + 32 * u;
        const long long k = W + i;
        if (k >= k_end) continue;
        uint32_t v = i < ORP ? (((uint32_t)d[u] << a) & 0xFFFFu) |
                                   (uint32_t)(a > 0 ? prev >> (16 - a) : 0)
                             : 0u;
        // lanes starting inside its last granule: staged, then from device
        // memory
        if (k == k_last && Pn < 16 * k + 16) {
          int f = l + 1;
          for (; f < ns && P_s[f] < 16 * k + 16; ++f) v += (uint32_t)F_s[f];
          if (f == ns) {
            long long Pf = P_s[ns];
            for (int g = g0 + ns; g < G && Pf < 16 * k + 16; ++g) {
              const int L = __ldg(bits + g);
              if (L > 0) v += (uint32_t)first_granule(dense, cnt, g, ORP, Pf);
              Pf += L;
            }
          }
        }
        out[k] = (int32_t)v;  // lanes' parts add mod 2^32, as the plain
                              // version's
      }
    }
  }
  // the last tile: the granules past the last code bit, zero
  if (g1 == G)
    for (long long k = min((P_s[nt] + 15) >> 4, n_out) + t; k < n_out;
         k += THREADS)
      out[k] = 0;
}

// The launcher's check of an E3 plan (rules in ops/e3_place.py e3_plan).
bool e3_plan_ok(int G, int ORP, long long n_out, int LT, int threads,
                int blocks) {
  return G >= 1 && ORP >= 1 && n_out >= 1 && LT >= 1 && LT <= MAX_LANES &&
         threads == THREADS && blocks == (G + LT - 1) / LT;
}

}  // namespace

extern "C" int ws_e3_place(const int32_t* dense, const int32_t* cnt,
                           const int32_t* bits, int32_t* out, int G, int ORP,
                           long long n_out, int LT, int threads, int blocks,
                           cudaStream_t stream) {
  if (!e3_plan_ok(G, ORP, n_out, LT, threads, blocks))
    return (int)cudaErrorInvalidValue;
  e3_place_kernel<<<blocks, THREADS, 0, stream>>>(dense, cnt, bits, out, G,
                                                  ORP, n_out, LT);
  return (int)cudaGetLastError();
}
