// P3: the gather probes: a one-shot gather along either axis, and chains of
// dependent gathers through a row staged in shared memory.
//
// Replaces the gather and roll Pallas kernels of the hardware probes:
//   one-shot  scripts/probe_gather.py:26 probe (take_along_axis axis 1,
//             (S, W) int32 up to (256, 1536)) and :58 (axis 0, (16, 128)
//             int32 and (8, 128) uint8); scripts/probe_vpu.py:104
//             probe_i16_gather (axis 1, (16, 128) int16 and uint16) and
//             :129 probe_roll (pltpu.roll, here this gather with the index
//             (j - s) mod W that the wrapper builds)
//   chained   scripts/probe_vpu2.py:88 make_gather (:71-94): P chains
//             c = (x + i) & 127, then S steps of c = x[r, c & 127]; out =
//             sum c; scripts/probe_vpu.py:78 probe_gather (:65-92): one
//             chain from idx through row 0 of an (8, 128) table broadcast
//             to every row
//
// One-shot: one thread an output element, out[r, j] = tab[r, idx[r, j]]
// (axis 1) or tab[idx[r, j], j] (axis 0), for 1-, 2- and 4-byte elements;
// an index outside the table's axis reads its nearest end.  Bound: bytes.
//
// Chained: one block a row, one thread a column (C a power of two up to
// 1024).  The block stages its table row (or row 0) in shared memory, and
// every step of a chain is one dependent shared-memory load, the inner
// loop of K1 and of the lane-DFA scans.  Bound: shared-memory loads (32 an
// SM a clock); at P = 1 the time is the load's latency times S.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256) gather_kernel(
    const T* __restrict__ tab, const int32_t* __restrict__ idx,
    T* __restrict__ out, int R, int W, int Rt, int Wt, int axis) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)R * W) return;
  const int r = (int)(t / W);
  const int j = (int)(t % W);
  const int n = axis == 1 ? Wt : Rt;
  const int k = min(max(idx[t], 0), n - 1);
  out[t] = axis == 1 ? tab[(long long)r * Wt + k] : tab[(long long)k * Wt + j];
}

template <int P>
__global__ void gather_chain_kernel(const int32_t* __restrict__ tab,
                                    const int32_t* __restrict__ init,
                                    int32_t* __restrict__ out, int C, int S,
                                    int broadcast) {
  extern __shared__ int32_t row[];
  const int r = blockIdx.x;
  const int j = threadIdx.x;
  row[j] = tab[(long long)(broadcast ? 0 : r) * C + j];
  __syncthreads();
  const uint32_t mask = (uint32_t)C - 1u;
  const uint32_t x0 = (uint32_t)init[(long long)r * C + j];
  uint32_t c[P];
#pragma unroll
  for (int i = 0; i < P; ++i) c[i] = (x0 + (uint32_t)i) & mask;
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < P; ++i) c[i] = (uint32_t)row[c[i] & mask];
  }
  uint32_t acc = c[0];
#pragma unroll
  for (int i = 1; i < P; ++i) acc += c[i];
  out[(long long)r * C + j] = (int32_t)acc;
}

}  // namespace

// tab (Rt, Wt), idx and out (R, W); elements of `elem` bytes
extern "C" int ws_probe_gather(const void* tab, const int32_t* idx, void* out,
                               int R, int W, int Rt, int Wt, int axis,
                               int elem, cudaStream_t stream) {
  if ((axis != 0 && axis != 1) || Rt <= 0 || Wt <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * W;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  switch (elem) {
    case 1:
      gather_kernel<uint8_t><<<blocks, threads, 0, stream>>>(
          static_cast<const uint8_t*>(tab), idx, static_cast<uint8_t*>(out),
          R, W, Rt, Wt, axis);
      break;
    case 2:
      gather_kernel<uint16_t><<<blocks, threads, 0, stream>>>(
          static_cast<const uint16_t*>(tab), idx, static_cast<uint16_t*>(out),
          R, W, Rt, Wt, axis);
      break;
    case 4:
      gather_kernel<uint32_t><<<blocks, threads, 0, stream>>>(
          static_cast<const uint32_t*>(tab), idx, static_cast<uint32_t*>(out),
          R, W, Rt, Wt, axis);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tab (Rt, C) int32 (row 0 read by every row when broadcast, else Rt = R);
// init and out (R, C) int32
extern "C" int ws_probe_gather_chain(const int32_t* tab, const int32_t* init,
                                     int32_t* out, int R, int C, int P, int S,
                                     int broadcast, cudaStream_t stream) {
  if (C <= 0 || C > 1024 || (C & (C - 1)) || S < 0)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)C * sizeof(int32_t);
  switch (P) {
    case 1: gather_chain_kernel<1><<<R, C, smem, stream>>>(tab, init, out, C, S, broadcast); break;
    case 4: gather_chain_kernel<4><<<R, C, smem, stream>>>(tab, init, out, C, S, broadcast); break;
    case 8: gather_chain_kernel<8><<<R, C, smem, stream>>>(tab, init, out, C, S, broadcast); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
