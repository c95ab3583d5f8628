// S1: the speculative pipeline's first stage, a decode from every bit offset.
//
// Replaces no TPU kernel: the JAX pipeline (huffmandecoderongpus_tpu/ops/
// speculative.py speculative_decode_xla :105-111) runs this stage as XLA
// ops, window extraction (extract_windows :63-75) and two LUT gathers.  The
// reference's own backend for it is a CUDA kernel (fastgpu.cu's
// decodeAllBits).  For every bit offset b < bits: the height-bit window
// starting at b (LSB-first), its first symbol and code length from the
// full-height table, and step0[b] = the length, or -1 where the code would
// run past the stream (b + len > bits).
//
// step0 is stored as int16: its values are -1..height (<= 22), and the
// JAX pipeline keeps level 0 as int16 too (speculative.py :129-135), so the
// doubling (spec_tile.cu, spec_pair.cu) and the query (spec_query.cu) read
// it as kept level 0 with no int32 copy.
//
// What bounds it on the H100: bytes, the words read once and 3 bytes
// written an offset.  The design keeps the table off that path:
//  - one lookup is one load of a packed 16-bit entry, (symbol << 5) |
//    ((length - 1) & 31), the entry of ops/onethread.py pack_table: a
//    length of 0 (a window that matches no code) packs as 31, which no
//    length 1..22 takes, and unpacks as ((e & 31) + 1) & 31, so the
//    symbol bits stay whole;
//  - the packing is this launch's own work: each block packs the table
//    into shared memory from lut_sym and lut_len where it fits (height up
//    to SHARED_HEIGHT, 2^h x 2 bytes).  Above that the grid first packs
//    the whole table into `packed` (2^h x 2 bytes of device memory, 2 MB
//    at height 20), meets at one grid barrier (a cooperative launch, every
//    block resident), and each block stages the table's first
//    2^SHARED_HEIGHT entries from it: a two-level table.  A window whose
//    first-level entry has a length 1..SHARED_HEIGHT takes it, since
//    build_decode_lut writes a code of length L at every window that
//    agrees with it in the low L bits (ops/lut.py :57-62), so the low
//    SHARED_HEIGHT bits decide it; every other window (a longer code, or
//    no code, length 0) loads its entry from `packed`;
//  - a thread takes a run of RUN = 8 consecutive offsets from one 64-bit
//    funnel window (the run starts at a multiple of 8, so its shifts are
//    0..31 and its windows end at bit 31 + 22 < 64 of words[q]:words[q+1],
//    q = b0 / 32; words[q + 1] is the caller's pad word at most, so in
//    bounds for b0 < bits), and stores its 8 step0 as one 16-byte store and
//    its 8 symbols as one 8-byte store (a warp's stores are whole 512- and
//    256-byte stretches); the run that ends past `bits` stores its offsets
//    below it one at a time;
//  - the blocks are persistent, as many as the SMs hold, and take runs
//    grid-stride, so a block's staging serves tens of thousands of
//    offsets.
// The funnel shift is right for every shift 0..31 (x << 32 is undefined
// in C++ as in XLA, where extract_windows masks the r == 0 case).
// The first level pays at height 20: every window from the packed table in
// device memory took 0.479 ms on an 8 MiB full-alphabet stream against
// 0.0866 with it on an H100 (PERF.md, S1).

#include <cooperative_groups.h>

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 512;
constexpr int RUN = 8;  // offsets a thread takes from one funnel window
// tables up to this height sit whole in shared memory; a taller one's
// first level takes its low SHARED_HEIGHT bits
constexpr int SHARED_HEIGHT = 14;

__device__ __forceinline__ uint16_t pack(const uint8_t* __restrict__ lut_sym,
                                         const int32_t* __restrict__ lut_len,
                                         int i) {
  return (uint16_t)(((uint32_t)__ldg(lut_sym + i) << 5) |
                    ((uint32_t)(__ldg(lut_len + i) - 1) & 31u));
}

// TWO: the table is taller than SHARED_HEIGHT (the grid packs it into
// `packed` first; launched cooperatively)
template <bool TWO>
__global__ void __launch_bounds__(THREADS, 2) spec_all_bits_kernel(
    const uint32_t* __restrict__ words, const uint8_t* __restrict__ lut_sym,
    const int32_t* __restrict__ lut_len, uint16_t* __restrict__ packed,
    int16_t* __restrict__ step0, uint8_t* __restrict__ sym, int bits,
    int height) {
  extern __shared__ uint4 stage[];
  uint16_t* first = reinterpret_cast<uint16_t*>(stage);
  const int F = TWO ? SHARED_HEIGHT : height;
  if (TWO) {
    const int n = 1 << height;
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
         i += gridDim.x * THREADS)
      packed[i] = pack(lut_sym, lut_len, i);
    cg::this_grid().sync();
    // written in this launch: read through L2 (__ldcg), not the
    // read-only path
    const uint4* src = reinterpret_cast<const uint4*>(packed);
    for (int i = threadIdx.x; i < (1 << F) / 8; i += THREADS)
      stage[i] = __ldcg(src + i);
  } else {
    for (int i = threadIdx.x; i < (1 << F); i += THREADS)
      first[i] = pack(lut_sym, lut_len, i);
  }
  __syncthreads();
  const uint32_t mask = (1u << height) - 1u;
  const uint32_t fmask = (1u << F) - 1u;
  const long long runs = ((long long)bits + RUN - 1) / RUN;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < runs;
       r += (long long)gridDim.x * THREADS) {
    const long long b0 = r * RUN;
    const long long q = b0 >> 5;
    const uint32_t lo = __ldg(words + q), hi = __ldg(words + q + 1);
    const uint32_t s0 = (uint32_t)b0 & 31u;
    uint32_t st[RUN / 2], sy[RUN / 4];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const uint32_t win = __funnelshift_r(lo, hi, s0 + j) & mask;
      uint32_t e = first[win & fmask];
      if (TWO && (e & 31u) >= (uint32_t)SHARED_HEIGHT)
        e = __ldcg(packed + win);
      const int len = (int)(((e & 31u) + 1u) & 31u);
      const uint32_t s = b0 + j + len <= (long long)bits ? (uint32_t)len
                                                         : 0xFFFFu;
      const uint32_t c = (e >> 5) & 0xFFu;
      if (j % 2 == 0)
        st[j / 2] = s;
      else
        st[j / 2] |= s << 16;
      if (j % 4 == 0)
        sy[j / 4] = c;
      else
        sy[j / 4] |= c << (8 * (j % 4));
    }
    if (b0 + RUN <= (long long)bits) {
      *reinterpret_cast<uint4*>(step0 + b0) =
          make_uint4(st[0], st[1], st[2], st[3]);
      *reinterpret_cast<uint2*>(sym + b0) = make_uint2(sy[0], sy[1]);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (b0 + j < (long long)bits) {
          step0[b0 + j] = (int16_t)(st[j / 2] >> (16 * (j % 2)));
          sym[b0 + j] = (uint8_t)(sy[j / 4] >> (8 * (j % 4)));
        }
    }
  }
}

// The blocks an SM holds of each kernel, asked once a device.
struct Fit {
  int dev, sms, per_sm[2];
};
std::mutex fit_lock;
Fit fits[16];
int n_fits = 0;

template <bool TWO>
cudaError_t per_sm(int shared, int& out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out, spec_all_bits_kernel<TWO>, THREADS, shared);
}

cudaError_t fit(Fit& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(fit_lock);
  for (int i = 0; i < n_fits; ++i)
    if (fits[i].dev == dev) {
      out = fits[i];
      return cudaSuccess;
    }
  Fit f{dev, 0, {0, 0}};
  int coop = 0;
  err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  // the most shared memory each takes: a table of SHARED_HEIGHT
  if (err == cudaSuccess)
    err = per_sm<false>(2 << SHARED_HEIGHT, f.per_sm[0]);
  if (err == cudaSuccess)
    err = per_sm<true>(2 << SHARED_HEIGHT, f.per_sm[1]);
  if (err != cudaSuccess) return err;
  if (!coop) f.per_sm[1] = 0;
  if (n_fits < 16) fits[n_fits++] = f;
  out = f;
  return cudaSuccess;
}

}  // namespace

// words (bits / 32 + 2,) uint32; lut_sym (2^height,) uint8; lut_len
// (2^height,) int32; packed (2^height,) uint16 scratch, written where
// height > SHARED_HEIGHT (else unused, may be null), 16-byte aligned;
// step0 (bits,) int16 and sym (bits,) uint8 written, 16- and 8-byte
// aligned
extern "C" int ws_spec_all_bits(const uint32_t* words, const uint8_t* lut_sym,
                                const int32_t* lut_len, uint16_t* packed,
                                int16_t* step0, uint8_t* sym, int bits,
                                int height, cudaStream_t stream) {
  const bool two = height > SHARED_HEIGHT;
  if (bits <= 0 || height < 1 || height > 22 ||
      reinterpret_cast<uintptr_t>(step0) % 16 ||
      reinterpret_cast<uintptr_t>(sym) % 8 ||
      (two && (packed == nullptr ||
               reinterpret_cast<uintptr_t>(packed) % 16)))
    return (int)cudaErrorInvalidValue;
  Fit f;
  const cudaError_t err = fit(f);
  if (err != cudaSuccess) return (int)err;
  const int shared = 2 << (two ? SHARED_HEIGHT : height);
  const long long runs = ((long long)bits + RUN - 1) / RUN;
  const long long want = (runs + THREADS - 1) / THREADS;
  const int most = f.sms * f.per_sm[two];
  if (most < 1) return (int)cudaErrorNotSupported;
  const int blocks = (int)(want < most ? want : most);
  if (!two) {
    spec_all_bits_kernel<false><<<blocks, THREADS, shared, stream>>>(
        words, lut_sym, lut_len, packed, step0, sym, bits, height);
    return (int)cudaGetLastError();
  }
  void* args[] = {&words, &lut_sym, &lut_len, &packed,
                  &step0, &sym,     &bits,    &height};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)spec_all_bits_kernel<true>, dim3(blocks), dim3(THREADS),
      args, shared, stream);
}
