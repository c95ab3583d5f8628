// P4: K4 cut down to one of its stages, to see where K4's time goes.
//
// Replaces scripts/hw_k4probe.py:120 (_k4_stripped :42-78), which times K4's
// transpose alone and its transpose with the per-window popcount prefix,
// over cells padded to cells_pp = ceil(cells_p / 128) * 128 with zeros and
// walked in windows w of 128 cells:
//   transpose  acc[j] = XOR_w (sym[w*128 + j] ^ nib[w*128 + j]);
//              out[g, j] = acc[j] & 0xFF
//   prefix     c2 = popcount(nib & 0xF), cum its inclusive prefix over j
//              in the window; acc[j] ^= cum[j] ^ sym[w*128 + j];
//              wpre += cum[127]; out[g, j] = (acc[j] + wpre) & 0xFF
// Columns 128 and up of the (G, ORP) uint8 output are zero.  The inputs are
// the port's K4 layout, sym (cells_p, G) int32 and nib (cells_p, G) uint8.
//
// Two facts make it parallel.  The windows are independent (the prefix
// starts again at 0 in each, and acc[j] is an XOR over them), and only the
// low 8 bits of acc[j] and wpre reach the output, so four lanes' bytes
// share one 32-bit word: XOR does not carry, and the sums are added a byte
// at a time (add8).
//
// A block owns LB = 32 lanes.  A thread owns a range of JR window columns j
// for VEC neighbouring lanes (4, as one 16-byte sym load and one 4-byte nib
// load a cell, where G and both addresses allow; else 1, byte loads) and
// walks every window, its next window's loads in flight while it works on
// this one, so that no load waits on another.  It keeps acc[j] in
// registers, four lanes a word.  In the prefix stage each thread's
// popcounts over its j range are summed a byte a lane, and an exclusive
// scan over the block's j ranges in shared memory (one barrier a window)
// gives each range its carry; padded cells load nothing but keep their
// term, the window's running prefix.  wpre is the sum of the windows'
// totals.  The result goes to shared memory as rows of 128 bytes a lane,
// and the block writes its lanes' ORP-byte rows as one contiguous stretch,
// 16 bytes a store where ORP and the address allow (else 4), zeros past
// column 127.  The launch plan is ops/k4_stripped.py p4_plan; the launcher
// refuses any other (p4_plan_ok).
//
// What bounds it on the H100: bytes (sym and nib read once, the output
// written once).  The one thread a lane it replaces walked its lane's cells
// as one chain of loads with 64 threads an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 128;
constexpr int LB = 32;                // lanes a block
constexpr int STRIDE = WIN + 16;      // bytes of a staged row

// j columns a thread: 8 with 4 lanes a thread, 16 with one
template <int VEC>
__host__ __device__ constexpr int jr_of() { return VEC == 4 ? 8 : 16; }
template <int VEC>
__host__ __device__ constexpr int threads_of() {
  return LB / VEC * (WIN / jr_of<VEC>());
}

// a + b a byte at a time, each byte mod 256
__device__ __forceinline__ uint32_t add8(uint32_t a, uint32_t b) {
  return ((a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu)) ^ ((a ^ b) & 0x80808080u);
}

// popcount of each byte's low nibble, a byte each (at most 4)
__device__ __forceinline__ uint32_t pop4(uint32_t v) {
  uint32_t x = v & 0x0F0F0F0Fu;
  x = (x & 0x05050505u) + ((x >> 1) & 0x05050505u);
  return (x & 0x03030303u) + ((x >> 2) & 0x03030303u);
}

struct Cell {
  uint32_t s, v;  // sym's low bytes and nib, a byte a lane
};

template <int VEC>
__device__ __forceinline__ Cell load_cell(const int32_t* __restrict__ sym,
                                          const uint8_t* __restrict__ nib,
                                          size_t o) {
  if constexpr (VEC == 4) {
    const int4 s = __ldg(reinterpret_cast<const int4*>(sym + o));
    const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(nib + o));
    const uint32_t lo = __byte_perm((uint32_t)s.x, (uint32_t)s.y, 0x0040u);
    const uint32_t hi = __byte_perm((uint32_t)s.z, (uint32_t)s.w, 0x0040u);
    return {__byte_perm(lo, hi, 0x5410u), v};
  } else {
    return {(uint32_t)__ldg(sym + o) & 0xFFu, (uint32_t)__ldg(nib + o)};
  }
}

template <int VEC, bool PREFIX>
__global__ void __launch_bounds__(threads_of<VEC>()) k4_stripped_kernel(
    const int32_t* __restrict__ sym, const uint8_t* __restrict__ nib,
    uint8_t* __restrict__ out, int G, int cells_p, int ORP, int store16) {
  constexpr int JR = jr_of<VEC>();
  constexpr int LG = LB / VEC;   // threads a cell row
  constexpr int NJ = WIN / JR;   // j ranges
  __shared__ __align__(16) uint8_t rows[LB * STRIDE];
  __shared__ uint32_t sums[2][NJ][LG];
  const int t = threadIdx.x;
  const int lg = t % LG, jr = t / LG;
  const int g0 = blockIdx.x * LB, l0 = lg * VEC, j0 = jr * JR;
  const int windows = (cells_p + WIN - 1) / WIN;

  uint32_t acc[JR], wpre = 0;
  Cell cur[JR], nxt[JR];
#pragma unroll
  for (int k = 0; k < JR; ++k) acc[k] = 0;
  auto load = [&](Cell* c, int w) {
#pragma unroll
    for (int k = 0; k < JR; ++k) {
      const int cell = w * WIN + j0 + k;
      c[k] = cell < cells_p
                 ? load_cell<VEC>(sym, nib, (size_t)cell * G + g0 + l0)
                 : Cell{0u, 0u};
    }
  };
  if (windows) load(cur, 0);
  for (int w = 0; w < windows; ++w) {
    if (w + 1 < windows) load(nxt, w + 1);
    if constexpr (PREFIX) {
      // this range's running popcount a byte a lane (at most 4 * JR)
      uint32_t loc[JR], run = 0;
#pragma unroll
      for (int k = 0; k < JR; ++k) loc[k] = run += pop4(cur[k].v);
      sums[w & 1][jr][lg] = run;
      __syncthreads();
      // the ranges before this one give its carry; all of them the window's
      // total (the other buffer is free: every thread passed this barrier)
      uint32_t carry = 0, total = 0;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const uint32_t x = sums[w & 1][i][lg];
        if (i < jr) carry = add8(carry, x);
        total = add8(total, x);
      }
      wpre = add8(wpre, total);
#pragma unroll
      for (int k = 0; k < JR; ++k) acc[k] ^= add8(carry, loc[k]) ^ cur[k].s;
    } else {
#pragma unroll
      for (int k = 0; k < JR; ++k) acc[k] ^= cur[k].s ^ cur[k].v;
    }
#pragma unroll
    for (int k = 0; k < JR; ++k) cur[k] = nxt[k];
  }

  // the staged rows: lane l0 + b's bytes j0 .. j0 + JR - 1
#pragma unroll
  for (int k = 0; k < JR; ++k) acc[k] = add8(acc[k], wpre);
#pragma unroll
  for (int q = 0; q < JR / 4; ++q) {
    const uint32_t a0 = acc[4 * q], a1 = acc[4 * q + 1];
    const uint32_t a2 = acc[4 * q + 2], a3 = acc[4 * q + 3];
    uint32_t* at = reinterpret_cast<uint32_t*>(rows + l0 * STRIDE + j0 +
                                               4 * q);
    if constexpr (VEC == 4) {
      // a 4 x 4 transpose of bytes: word b holds lane b's four columns
      const uint32_t t0 = __byte_perm(a0, a1, 0x5140u);
      const uint32_t t1 = __byte_perm(a2, a3, 0x5140u);
      const uint32_t t2 = __byte_perm(a0, a1, 0x7362u);
      const uint32_t t3 = __byte_perm(a2, a3, 0x7362u);
      at[0] = __byte_perm(t0, t1, 0x5410u);
      at[STRIDE / 4] = __byte_perm(t0, t1, 0x7632u);
      at[2 * STRIDE / 4] = __byte_perm(t2, t3, 0x5410u);
      at[3 * STRIDE / 4] = __byte_perm(t2, t3, 0x7632u);
    } else {
      at[0] = __byte_perm(__byte_perm(a0, a1, 0x0040u),
                          __byte_perm(a2, a3, 0x0040u), 0x5410u);
    }
  }
  __syncthreads();
  // the block's rows are LB * ORP contiguous bytes of the output
  uint8_t* base = out + (size_t)g0 * ORP;
  if (store16) {
    const int q = ORP / 16;
    for (int i = t; i < LB * q; i += blockDim.x) {
      const int l = i / q, col = 16 * (i - l * q);
      reinterpret_cast<uint4*>(base)[i] =
          col < WIN ? *reinterpret_cast<const uint4*>(rows + l * STRIDE + col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int q = ORP / 4;
    for (int i = t; i < LB * q; i += blockDim.x) {
      const int l = i / q, col = 4 * (i - l * q);
      reinterpret_cast<uint32_t*>(base)[i] =
          col < WIN ? *reinterpret_cast<const uint32_t*>(rows + l * STRIDE +
                                                         col)
                    : 0u;
    }
  }
}

template <int VEC>
int launch(const int32_t* sym, const uint8_t* nib, uint8_t* out, int G,
           int cells_p, int ORP, int prefix, int store16,
           cudaStream_t stream) {
  const dim3 grid(G / LB), block(threads_of<VEC>());
  if (prefix)
    k4_stripped_kernel<VEC, true><<<grid, block, 0, stream>>>(
        sym, nib, out, G, cells_p, ORP, store16);
  else
    k4_stripped_kernel<VEC, false><<<grid, block, 0, stream>>>(
        sym, nib, out, G, cells_p, ORP, store16);
  return (int)cudaGetLastError();
}

// The launcher's check of a plan (rules in ops/k4_stripped.py p4_plan).
template <int VEC>
bool p4_plan_ok(int lanes, int jr, int threads, int shared) {
  return lanes == LB && jr == jr_of<VEC>() && threads == threads_of<VEC>() &&
         shared == LB * STRIDE + 2 * (WIN / jr_of<VEC>()) * (LB / VEC) * 4;
}

}  // namespace

extern "C" int ws_k4_stripped(const int32_t* sym, const uint8_t* nib,
                              uint8_t* out, int G, int cells_p, int ORP,
                              int prefix, int lanes, int vec, int jr,
                              int threads, int shared, int store16,
                              cudaStream_t stream) {
  const bool vec_ok =
      vec == 1 ? p4_plan_ok<1>(lanes, jr, threads, shared)
               : vec == 4 && G % 4 == 0 && (uintptr_t)sym % 16 == 0 &&
                     (uintptr_t)nib % 4 == 0 &&
                     p4_plan_ok<4>(lanes, jr, threads, shared);
  const bool store_ok =
      store16 ? ORP % 16 == 0 && (uintptr_t)out % 16 == 0
              : store16 == 0 && (uintptr_t)out % 4 == 0;
  if (G < 0 || G % 64 || ORP < WIN || ORP % 4 || cells_p < 0 || !vec_ok ||
      !store_ok)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  return vec == 4 ? launch<4>(sym, nib, out, G, cells_p, ORP, prefix, store16,
                              stream)
                  : launch<1>(sym, nib, out, G, cells_p, ORP, prefix, store16,
                              stream);
}
