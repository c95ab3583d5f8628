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
// One thread a lane, 64 lanes a block: each thread walks its lane's cells in
// order, reads coalesced across the block's lanes, runs the window prefix
// as a running sum (the Pallas kernel's log-step roll-and-add over lanes
// has no counterpart in one thread), and keeps acc[j] in shared memory as
// bytes: only the low 8 bits of an XOR and of the final sum reach the
// output.  The block then writes its 64 contiguous output rows with 4-byte
// stores, zeros past column 127.
//
// What bounds it on the H100: bytes (sym and nib read once, the output
// written once); with 64 lanes a block, (a)'s 8,192 lanes fill 128 blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 64;
constexpr int WIN = 128;

__global__ void __launch_bounds__(LANES) k4_stripped_kernel(
    const int32_t* __restrict__ sym, const uint8_t* __restrict__ nib,
    uint8_t* __restrict__ out, int G, int cells_p, int ORP, int prefix) {
  __shared__ uint8_t acc[WIN][LANES];
  __shared__ uint32_t wpre[LANES];
  const int t = threadIdx.x;
  const int g = blockIdx.x * LANES + t;
  const int cells_pp = (cells_p + WIN - 1) / WIN * WIN;
  for (int j = 0; j < WIN; ++j) acc[j][t] = 0;
  uint32_t total = 0;
  for (int w = 0; w < cells_pp; w += WIN) {
    uint32_t cum = 0;
#pragma unroll 8
    for (int j = 0; j < WIN; ++j) {
      const int cell = w + j;
      uint32_t s = 0, v = 0;
      if (cell < cells_p) {
        s = (uint32_t)sym[(long long)cell * G + g];
        v = nib[(long long)cell * G + g];
      }
      if (prefix) {
        cum += __popc(v & 0xFu);
        acc[j][t] ^= (uint8_t)(cum ^ s);
      } else {
        acc[j][t] ^= (uint8_t)(s ^ v);
      }
    }
    total += cum;
  }
  wpre[t] = prefix ? total : 0u;
  __syncthreads();
  // the block's rows are LANES * ORP contiguous bytes of the output
  uint32_t* rows = reinterpret_cast<uint32_t*>(out + (long long)blockIdx.x *
                                               LANES * ORP);
  const int words = LANES * ORP / 4;
  for (int q = t; q < words; q += LANES) {
    const int row = q * 4 / ORP;
    const int col = q * 4 % ORP;
    uint32_t word = 0;
    if (col < WIN) {
      const uint32_t add = wpre[row];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= ((acc[col + b][row] + add) & 0xFFu) << (8 * b);
    }
    rows[q] = word;
  }
}

}  // namespace

extern "C" int ws_k4_stripped(const int32_t* sym, const uint8_t* nib,
                              uint8_t* out, int G, int cells_p, int ORP,
                              int prefix, cudaStream_t stream) {
  if (G % LANES || ORP < WIN || ORP % 4 || cells_p < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  k4_stripped_kernel<<<G / LANES, LANES, 0, stream>>>(sym, nib, out, G,
                                                      cells_p, ORP, prefix);
  return (int)cudaGetLastError();
}
