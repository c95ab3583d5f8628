// K2: compose per-lane exit maps into each lane's true entry offset, in one
// launch.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_widescan.py k2_compose /
// _k2_kernel.  entry[0] = start, entry[l + 1] = exmap[entry[l], l], where an
// entry at or past the map rows (HP) reads 0; tot is the composite map over
// every lane-0 entry below 128.  The TPU kernel composes sqrt(G) x sqrt(G)
// with 128-wide lane gathers and prefix doubling over sublane rolls.  Here
// one launch, a single pass over tiles of TL consecutive lanes chained by a
// decoupled look-back:
//
//   1. a block takes the next tile from an atomic ticket and stages its
//      lanes' map rows as bytes in shared memory (int32 reads, lane-minor:
//      coalesced);
//   2. its threads split the tile into sub-tiles of SL lanes and each walks
//      one sub-tile from one entry class, in shared memory; a log-depth
//      scan of compositions then gives every sub-tile's inclusive map, the
//      last of which is the tile's aggregate;
//   3. the tile publishes its aggregate (flag 1), looks back over its
//      predecessors' flags, a warp at a time, composing their aggregates up
//      to the nearest inclusive map (flag 2), and publishes its own
//      inclusive map;
//   4. each sub-tile's incoming entry comes from the tile's incoming entry
//      through the sub-tile scan, and one thread a sub-tile walks its lanes
//      from it (SL shared-memory steps), staging the entries for one
//      coalesced store; the last tile writes tot.
//
// A map is evaluated at HP + 1 entry classes: e < HP, and one class for
// every entry at or past HP (they all lead to 0 on the next lane).  Its
// values are the exact entries (below 128, or below 256 in the bytes it is
// staged as), so a composition (B after A)[c] = B[min(A[c], HP)] keeps them
// exact.  The look-back's state (a 64-bit word of the call's epoch and its
// tickets, a flag and two maps a tile) is a buffer the wrapper holds per
// device and stream, zeroed once when made.  A flag holds the epoch of the
// call that wrote it, so an older call's flags read as not ready; the
// block that takes a call's last ticket advances the epoch and clears the
// tickets in the same word, so the next call needs no reset and no other
// launch.  A call captured in a CUDA graph has a state of its own, which
// the graph zeroes before each replay.  A block spins only on tiles of
// earlier tickets, which are already running, so the look-back always
// progresses.  A look-back and not a cooperative grid: G has no bound,
// and the tiles of a large G (1,200 and more) are not all co-resident.
//
// ops/k2_compose.py k2_plan picks TL, SL and the block; the launcher
// refuses any other plan (k2_plan_ok).  The one-shot kernel keeps its own
// three-step K2 (oneshot.cu).
//
// What bounds it on the H100: round trips, not bytes (the HP x G int32
// maps are read once, 1.5 MB at most on the decode path): the ticket, the
// rows' loads, the sub-tile walks (SL dependent shared-memory reads,
// twice), and the look-back's flag, map and publish round trips through
// L2, one window of 32 tiles at a time.

#include "widescan.cuh"

using namespace ws;

namespace {

constexpr int LOOKBACK = 32;  // predecessors a look-back step reads (a warp)
constexpr int MAP_BYTES = 256;  // a published map's stride (HP + 1 <= 129)
constexpr int STAGE = 8;        // row loads a thread has in flight
enum : int { NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

// The dynamic shared memory of a block of `threads`: the staged rows (HP x
// TL bytes), the entries (TL int32), two buffers of the sub-tile maps and
// two of a look-back window's maps, and the look-back's composite, each
// 16-byte aligned.
struct K2Smem {
  int ex, ent, t0, t1, w0, w1, acc, bytes;
  __host__ __device__ static int up16(int n) { return (n + 15) / 16 * 16; }
  __host__ __device__ K2Smem(int HP, int TL, int threads) {
    const int NC = HP + 1, S = threads / NC;
    ex = 0;
    ent = up16(HP * TL);
    t0 = ent + 4 * TL;
    t1 = t0 + up16(S * NC);
    w0 = t1 + up16(S * NC);
    w1 = w0 + up16(LOOKBACK * NC);
    acc = w1 + up16(LOOKBACK * NC);
    bytes = acc + up16(NC);
  }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A flag: the epoch of the call that wrote it (mod 2^30), then its status.
__device__ __forceinline__ int flag_of(unsigned epoch, int status) {
  return (int)((epoch & 0x3FFFFFFFu) << 2) | status;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Inclusive scan of the n maps in `a` (map i of NC classes at a + i * NC,
// map i applied after map i - 1) by prefix doubling, with `b` as the other
// buffer; every thread of the block calls it.  Returns the buffer that
// holds the result: map i becomes maps i, i - 1, ..., 0 composed.
__device__ __forceinline__ uint8_t* scan_maps(uint8_t* a, uint8_t* b, int n,
                                              int NC, int HP) {
  for (int d = 1; d < n; d <<= 1) {
    for (int i = threadIdx.x; i < n * NC; i += blockDim.x) {
      const int s = i / NC, c = i - s * NC;
      b[i] = s >= d ? a[s * NC + min((int)a[(s - d) * NC + c], HP)] : a[i];
    }
    __syncthreads();
    uint8_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

__global__ void k2_compose_kernel(const int32_t* __restrict__ exmap,
                                  int32_t* __restrict__ entry,
                                  uint8_t* __restrict__ tot,
                                  unsigned long long* ticket, int* flags,
                                  uint8_t* maps, int G, int HP, int start,
                                  int TL, int SL, int NT) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int tile_s, n_s, found_s;
  __shared__ unsigned epoch_s;
  const K2Smem lay(HP, TL, blockDim.x);
  uint8_t* ex = smem + lay.ex;
  int32_t* ent = reinterpret_cast<int32_t*>(smem + lay.ent);
  uint8_t* acc = smem + lay.acc;
  const int NC = HP + 1;
  const int tid = threadIdx.x;
  uint8_t* agg_maps = maps;
  uint8_t* inc_maps = maps + (size_t)NT * MAP_BYTES;

  // ---- 1. a tile by ticket, its rows staged as bytes ---------------------
  if (tid == 0) {
    const unsigned long long v = atomicAdd(ticket, 1ull);
    epoch_s = (unsigned)(v >> 32);
    tile_s = (int)(unsigned)v;
    if (tile_s == NT - 1)  // every ticket is taken: the next call's epoch
      atomicExch(ticket, (unsigned long long)(epoch_s + 1) << 32);
  }
  __syncthreads();
  const int t = tile_s;
  const unsigned epoch = epoch_s;
  const int g0 = t * TL, TLt = min(TL, G - g0);
  // STAGE loads of each thread in flight before their stores
  for (int i0 = tid; i0 < HP * TL; i0 += STAGE * blockDim.x) {
    int v[STAGE];
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int i = i0 + k * blockDim.x, r = i / TL, l = i - r * TL;
      v[k] = r < HP && l < TLt ? __ldg(&exmap[(size_t)r * G + g0 + l]) : 0;
    }
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < HP * TL) ex[i] = (uint8_t)v[k];
    }
  }
  __syncthreads();

  // ---- 2. sub-tile maps, then their inclusive scan -----------------------
  const int S = (TLt + SL - 1) / SL;  // sub-tiles, none empty
  uint8_t* sub = smem + lay.t0;
  for (int i = tid; i < S * NC; i += blockDim.x) {
    const int s = i / NC, c = i - s * NC;
    const int l1 = min(s * SL + SL, TLt);
    int v = c;  // class HP: any entry at or past HP
    for (int l = s * SL; l < l1; ++l) v = v < HP ? ex[v * TL + l] : 0;
    sub[i] = (uint8_t)v;
  }
  __syncthreads();
  sub = scan_maps(sub, smem + lay.t1, S, NC, HP);
  const uint8_t* aggr = sub + (S - 1) * NC;  // the tile's aggregate

  // ---- 3. publish, look back, publish the inclusive map ------------------
  if (t > 0) {
    for (int c = tid; c < NC; c += blockDim.x) {
      agg_maps[(size_t)t * MAP_BYTES + c] = aggr[c];
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) st_release(&flags[t], flag_of(epoch, AGGREGATE));
    int hi = t - 1;  // the nearest predecessor not yet composed
    bool have = false, found = false;
    while (!found) {
      if (tid < 32) {  // a warp reads the flags of tiles hi, hi - 1, ...
        const int j = hi - tid;
        int f = INCLUSIVE;
        do {
          f = INCLUSIVE;
          if (j >= 0) {
            const int w = ld_acquire(&flags[j]);
            f = (w & ~3) == flag_of(epoch, 0) ? w & 3 : NOT_READY;
          }
        } while (__any_sync(0xFFFFFFFFu, f == NOT_READY));
        const unsigned inc = __ballot_sync(0xFFFFFFFFu, f == INCLUSIVE);
        if (tid == 0) {  // tile 0 publishes its inclusive map alone
          n_s = __ffs(inc);  // inc != 0 once hi < 32
          found_s = inc != 0;
          if (!inc) n_s = LOOKBACK;
        }
        __threadfence();
      }
      __syncthreads();
      const int n = n_s;
      found = found_s;
      // the window's maps, farthest first: an inclusive one, if found, then
      // aggregates up to tile hi
      uint8_t* win = smem + lay.w0;
      for (int i = tid; i < n * NC; i += blockDim.x) {
        const int q = i / NC, c = i - q * NC, j = hi - n + 1 + q;
        const uint8_t* src = (found && q == 0 ? inc_maps : agg_maps) +
                             (size_t)j * MAP_BYTES;
        win[i] = __ldcg(src + c);
      }
      __syncthreads();
      win = scan_maps(win, smem + lay.w1, n, NC, HP);
      const uint8_t* w = win + (n - 1) * NC;  // the window composed
      int v = 0;
      if (tid < NC) v = have ? acc[min((int)w[tid], HP)] : w[tid];
      __syncthreads();
      if (tid < NC) acc[tid] = (uint8_t)v;
      __syncthreads();
      have = true;
      hi -= n;
    }
    for (int c = tid; c < NC; c += blockDim.x) {
      inc_maps[(size_t)t * MAP_BYTES + c] = aggr[min((int)acc[c], HP)];
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) st_release(&flags[t], flag_of(epoch, INCLUSIVE));
  } else {
    for (int c = tid; c < NC; c += blockDim.x) {
      inc_maps[c] = aggr[c];
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) st_release(&flags[0], flag_of(epoch, INCLUSIVE));
  }

  // ---- 4. every lane's entry; the composite map ---------------------------
  const int x = t > 0 ? acc[min(start, HP)] : start;  // the tile's entry
  for (int s = tid; s < S; s += blockDim.x) {
    int v = s > 0 ? sub[(s - 1) * NC + min(x, HP)] : x;
    const int l1 = min(s * SL + SL, TLt);
    for (int l = s * SL; l < l1; ++l) {
      ent[l] = v;
      v = v < HP ? ex[v * TL + l] : 0;
    }
  }
  __syncthreads();
  for (int l = tid; l < TLt; l += blockDim.x) entry[g0 + l] = ent[l];
  if (t == NT - 1)
    for (int e = tid; e < K2_NE; e += blockDim.x) {
      const int c = min(e, HP);
      tot[e] = t > 0 ? aggr[min((int)acc[c], HP)] : aggr[c];
    }
}

// The launcher's check of a plan (rules in ops/k2_compose.py k2_plan).
bool k2_plan_ok(int G, int HP, int TL, int SL, int threads, int shared,
                int cap) {
  const int NC = HP + 1, S = threads / (NC > 0 ? NC : 1);
  return G >= 1 && HP >= 1 && HP <= K2_NE && threads >= 128 &&
         threads <= 1024 && threads % 32 == 0 && S >= 1 && TL >= 16 &&
         TL % 16 == 0 && SL == (TL + S - 1) / S &&
         shared == K2Smem(HP, TL, threads).bytes && shared <= 48 * 1024 &&
         (G + TL - 1) / TL <= cap;
}

}  // namespace

extern "C" int ws_k2_compose(const int32_t* exmap, int32_t* entry,
                             uint8_t* tot, int* state, int cap, int G, int HP,
                             int start, int TL, int SL, int threads,
                             int shared, cudaStream_t stream) {
  if (!k2_plan_ok(G, HP, TL, SL, threads, shared, cap) || start < 0 ||
      start >= K2_NE)
    return (int)cudaErrorInvalidValue;
  // the state: the epoch and ticket word, cap flags, then the aggregate and
  // inclusive maps of cap tiles (MAP_BYTES each)
  if ((uintptr_t)state % 8) return (int)cudaErrorInvalidValue;
  const int NT = (G + TL - 1) / TL;
  int* flags = state + 2;
  uint8_t* maps = reinterpret_cast<uint8_t*>(state + 2 + cap);
  k2_compose_kernel<<<NT, threads, shared, stream>>>(
      exmap, entry, tot, reinterpret_cast<unsigned long long*>(state), flags,
      maps, G, HP, start, TL, SL, NT);
  return (int)cudaGetLastError();
}
