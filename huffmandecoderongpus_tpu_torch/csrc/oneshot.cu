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
// K1 is the team body of widescan.cuh (k1_team, which the four-kernel K1s
// run too), on the step table this kernel stages at launch.
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

#include "widescan.cuh"

namespace cg = cooperative_groups;
using namespace ws;

namespace {

constexpr int THREADS = 128;   // a block
constexpr int MIN_BLOCKS = 4;  // an SM's blocks the registers allow

struct Oneshot {
  const int32_t* words;  // (G, BW) lane words
  const uint32_t* tab;   // (2 * NS, 128) quad table
  const int32_t* lim;    // (G,) per-lane stream limits
  uint8_t* out;          // (G, ORP) dense rows
  int32_t* n;            // (G,) per-lane counts
  unsigned long long* total;  // () all counts
  // K1's outputs in scratch ((cells_p, G) sym/val, (HP, G) maps) and the
  // geometry (G, B, steps, steps_p, C0, C1), which the later phases read
  K1Args k1;
  // scratch
  uint8_t* gmap;     // (NGp, 128)
  int32_t* goff;     // (NGp,)
  uint8_t* tot;      // (128,)
  int32_t* entry;    // (G,)
  unsigned long long* stamps;  // (7,) phase clock, or null
  int BW, H, SEG, md, NS, ORP, L, NGp;
  int T;       // threads a lane
  K4Tile k4;   // K4's plan over a block's lanes
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K3 of lane g (k3_fix2_lane's rules on the step table): entered at e0 with
// cut row ct and cut slot cs, re-decode from e0 and splice the slots below
// cs into sym/val in place.
template <int MD>
__device__ __forceinline__ void k3_lane(const K1Args& a,
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

// K2's steps (1) and (3) of the one-shot (k2_compose.cu is one launch of
// another design): exmap[state, lane], or 0 for an entry offset at or past
// the map rows (HP), as the TPU kernel's zero padding to 128 reads.
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
  stage_step_table(step, a.tab, a.NS, a.k1.C0, a.k1.C1);
  __syncthreads();
  const int G = a.k1.G, T = a.T;
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int nthreads = gridDim.x * THREADS;
  const int g = gt / T, j = gt & (T - 1);  // T divides 32
  const int CH = a.H - 1 > 1 ? a.H - 1 : 1;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const int team = threadIdx.x / T, lanes = THREADS / T;
  const LaneWords words{a.words, G, a.BW, (a.k1.steps_p + 31) / 32};
  const bool lead = a.stamps && gt == 0;
  const bool warp_lead = a.stamps && (threadIdx.x & 31) == 0;
  if (gt == 0) *a.total = 0;
  if (lead) {
    a.stamps[0] = globaltimer();
    a.stamps[5] = a.stamps[6] = 0;
  }
  // the team set up here, not by Team::of: nvcc schedules the K1 phase
  // 5-8 % faster on md 2 streams this way (measured on an H100; PERF.md)
  const int NL = a.md < CH ? a.md : CH;
  const int SEGH = a.SEG / 2;
  const Team tm{reinterpret_cast<int*>(smem) +
                    team * team_words(CH, NL, SEGH),
                CH, NL, SEGH};
  const int sub = (threadIdx.x & 31) & ~(T - 1);
  const unsigned mask =
      T == 32 ? 0xFFFFFFFFu : ((1u << T) - 1u) << sub;

  with_md(a.md, [&](auto md) {
    k1_team<decltype(md)::value>(a.k1, words, a.lim, step, tm, g, j, T,
                                 mask);
  });
  grid.sync();
  if (lead) a.stamps[1] = globaltimer();
  for (int idx = gt; idx < a.NGp * K2_NE; idx += nthreads)
    a.gmap[idx] = (uint8_t)k2_group_map(a.k1.exmap, G, HP, a.L,
                                        idx / K2_NE, idx % K2_NE);
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
  if (gt < a.NGp)
    k2_apply_group(a.k1.exmap, a.goff, a.entry, G, HP, a.L, gt);
  grid.sync();
  if (lead) a.stamps[4] = globaltimer();

  // select_h / fix_rows: an entry outside [0, H) selects row 0
  int* keep = reinterpret_cast<int*>(
      smem + K4Tile::bytes(a.k4.LB, a.k4.nch, a.k4.W));
  int cnt = 0;
  if (j == 0) {
    const int e0 = a.entry[g];
    const size_t o = (size_t)(e0 >= 0 && e0 < a.H ? e0 : 0) * G + g;
    cnt = a.k1.cntmap[o];
    int cut = e0 == 0 ? 0 : a.k1.mrowmap[o] + 1;
    if (a.lim[g] <= 0) cut = 0;
    const int cut_slot = cut > 0 ? (cut - 1) / a.md + 1 : 0;
    a.n[g] = cnt;
    keep[team] = min(cnt, a.ORP);
    with_md(a.md, [&](auto md) {
      k3_lane<decltype(md)::value>(a.k1, words, step, e0, cut, cut_slot,
                                   g);
    });
  }
  if (warp_lead) atomicMax(&a.stamps[5], globaltimer());
  __syncthreads();  // K3 wrote only its lanes' columns: the block's cells
  const int g0 = blockIdx.x * lanes;
  for (int s = 0; s < lanes; s += a.k4.LB)
    k4_block<false>(a.k1.sym, a.k1.val, a.out, G,
                    a.k1.steps_p / a.md / CELL, a.ORP, g0 + s, a.k4.LB, a.k4,
                    smem, KeepArr{keep + s});
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
  return SEG == seg_bits(md) && T >= 4 && T <= 32 && (T & (T - 1)) == 0 &&
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
  const K1Args k1{reinterpret_cast<int32_t*>(scratch + offsets[0]),
                  scratch + offsets[1],
                  reinterpret_cast<int32_t*>(scratch + offsets[2]),
                  reinterpret_cast<int32_t*>(scratch + offsets[3]),
                  reinterpret_cast<int32_t*>(scratch + offsets[4]),
                  G, B, steps, steps_p, C0, C1};
  Oneshot a{words,
            tab,
            lim,
            out,
            n,
            total,
            k1,
            scratch + offsets[5],
            reinterpret_cast<int32_t*>(scratch + offsets[6]),
            scratch + offsets[7],
            reinterpret_cast<int32_t*>(scratch + offsets[8]),
            stamps,
            BW, H, SEG, md, NS, ORP, L, NGp, T, k4};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)oneshot_kernel,
                                          dim3(blocks), dim3(THREADS), args,
                                          shared, stream);
}
