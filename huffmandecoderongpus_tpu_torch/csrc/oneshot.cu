// The one-shot decode: the whole wide-lane program in one cooperative
// launch.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_oneshot.py oneshot_program /
// _oneshot_kernel.  The TPU kernel walks a (phase, segment) grid with the
// working set in VMEM, builds the halo'd word matrix in-kernel by
// transposes, and composes the exit maps lane-transposed, all for Mosaic's
// layouts.  None of that is carried over.  Here one thread owns one lane, as
// in the four separate kernels, and runs their per-lane bodies
// (widescan.cuh); only the composition needs other lanes, so K2's three
// steps are phases of the same launch, separated by grid-wide barriers:
//
//   K1       k1_scan2_lane: main scan + candidate chains -> cells, maps
//   --- grid.sync()
//   K2 (1)   every group's composite map (grid-stride over groups x 128)
//   --- grid.sync()
//   K2 (2)   block 0 scans the group maps -> each group's first entry
//   --- grid.sync()
//   K2 (3)   one thread per group walks its lanes -> every lane's entry
//   --- grid.sync()
//   per lane its count and cut rows (select_h / fix_rows), k3_fix2_lane,
//            k4_compact_lane up to the count, and the total (one atomic
//            per warp)
//
// Each lane reads its words, and the halo words of lane g+1, straight from
// the (G, BW) lane words (LaneWords): no word matrix is built.  The wrapper
// allocates the cells, maps, group maps and entries; the kernel allocates
// nothing.  The dense rows are zero past each lane's count: K4 alone
// zeroes only past a lane's valid slots, and a lane that K3 replays to its
// end keeps the halo's symbols past its count.
//
// A grid barrier needs every block resident at once: the launcher checks
// that the occupancy calculator fits G/128 <= 32 blocks of 128 threads on
// the card's SMs and returns cudaErrorCooperativeLaunchTooLarge otherwise,
// without launching.
//
// `stamps`, when not null, receives the device clock (%globaltimer, ns) at
// the start of block 0 and after each grid barrier, then the latest end of
// K3 and of K4 over all warps: the split of the launch by phase, which no
// profiler gives for one kernel.
//
// What bounds it on the H100: K1's dependent table-lookup chain per lane,
// as in the separate kernels (its inputs and outputs are well under 1 MB a
// stream); with G <= 4096 lanes it fills at most 32 of 132 SMs.  The
// scratch stays in the 50 MB L2.

#include <cooperative_groups.h>

#include "widescan.cuh"

namespace cg = cooperative_groups;
using namespace ws;

namespace {

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
  unsigned long long* stamps;  // (STAMPS,) phase clock, or null
  int G, BW, B, H, steps, steps_p, SEG, md, C0, C1, NS, ORP, L, NGp;
};

constexpr int STAMPS = 7;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(128) oneshot_kernel(Oneshot a) {
  __shared__ uint32_t tab_s[TAB_WORDS];
  __shared__ uint8_t gm[K2_MAX_GROUPS * K2_NE];
  cg::grid_group grid = cg::this_grid();
  load_table(tab_s, a.tab, a.NS);
  const int G = a.G;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;  // G % 128 == 0
  const int nthreads = gridDim.x * blockDim.x;
  const int CH = a.H - 1 > 1 ? a.H - 1 : 1;
  const int HP = (CH + 1 + 7) / 8 * 8;
  const LaneWords words{a.words, G, a.BW, (a.steps_p + 31) / 32};
  const bool lead = a.stamps && g == 0;
  const bool warp_lead = a.stamps && (threadIdx.x & 31) == 0;
  if (g == 0) *a.total = 0;
  if (lead) {
    a.stamps[0] = globaltimer();
    a.stamps[5] = a.stamps[6] = 0;
  }

  k1_scan2_lane(words, tab_s, a.lim[g], a.sym, a.val, a.cntmap, a.exmap,
                a.mrowmap, G, g, a.B, a.H, a.steps, a.steps_p, a.SEG, a.md,
                a.C0, a.C1, a.NS);
  grid.sync();
  if (lead) a.stamps[1] = globaltimer();
  for (int idx = g; idx < a.NGp * K2_NE; idx += nthreads)
    a.gmap[idx] = (uint8_t)k2_group_map(a.exmap, G, HP, a.L, idx / K2_NE,
                                        idx % K2_NE);
  grid.sync();
  if (lead) a.stamps[2] = globaltimer();
  if (blockIdx.x == 0) k2_scan_block(gm, a.gmap, a.goff, a.tot, a.NGp, 0);
  grid.sync();
  if (lead) a.stamps[3] = globaltimer();
  if (g < a.NGp) k2_apply_group(a.exmap, a.goff, a.entry, G, HP, a.L, g);
  grid.sync();
  if (lead) a.stamps[4] = globaltimer();

  // select_h / fix_rows: an entry outside [0, H) selects row 0
  const int e0 = a.entry[g];
  const size_t o = (size_t)(e0 >= 0 && e0 < a.H ? e0 : 0) * G + g;
  const int cnt = a.cntmap[o];
  int cut = e0 == 0 ? 0 : a.mrowmap[o] + 1;
  if (a.lim[g] <= 0) cut = 0;
  const int cut_slot = cut > 0 ? (cut - 1) / a.md + 1 : 0;
  a.n[g] = cnt;
  k3_fix2_lane(words, tab_s, e0, cut, cut_slot, a.sym, a.val, G, g,
               a.steps_p, a.SEG, a.md, a.C0, a.C1, a.NS);
  if (warp_lead) atomicMax(&a.stamps[5], globaltimer());
  k4_compact_lane(a.sym, a.val, a.out, G, a.steps_p / a.md / CELL, a.ORP,
                  min(cnt, a.ORP), g);
  if (warp_lead) atomicMax(&a.stamps[6], globaltimer());
  const unsigned warp_sum = __reduce_add_sync(0xFFFFFFFFu, (unsigned)cnt);
  if ((threadIdx.x & 31) == 0)
    atomicAdd(a.total, (unsigned long long)warp_sum);
}

}  // namespace

extern "C" int ws_oneshot(const int32_t* words, const uint32_t* tab,
                          const int32_t* lim, uint8_t* out, int32_t* n,
                          unsigned long long* total, int32_t* sym,
                          uint8_t* val, int32_t* cntmap, int32_t* exmap,
                          int32_t* mrowmap, uint8_t* gmap, int32_t* goff,
                          uint8_t* tot, int32_t* entry,
                          unsigned long long* stamps, int G, int BW, int B,
                          int H, int steps, int steps_p, int SEG, int md,
                          int C0, int C1, int NS, int ORP, int L, int NGp,
                          cudaStream_t stream) {
  if (G % 128 || BW * 32 != B || SEG / 2 > MAX_SEGH || md > MAX_NL ||
      md < 2 || H - 1 > MAX_CH || NS > MAX_NS || SEG % (md * CELL) ||
      steps_p % SEG || ORP % 128 || NGp > K2_MAX_GROUPS || NGp * L != G)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, oneshot_kernel, 128, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int blocks = G / 128;
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  Oneshot a{words, tab,  lim,   out,     n,   total,  sym,   val,
            cntmap, exmap, mrowmap, gmap, goff, tot, entry, stamps,
            G, BW, B, H, steps, steps_p, SEG, md, C0, C1, NS, ORP, L, NGp};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)oneshot_kernel,
                                          dim3(blocks), dim3(128), args, 0,
                                          stream);
}
