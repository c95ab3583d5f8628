// P3: the gather probes: a one-shot gather or roll along either axis, and
// chains of dependent gathers through a row staged in shared memory.
//
// Replaces the gather and roll Pallas kernels of the hardware probes:
//   one-shot  scripts/probe_gather.py:26 probe (take_along_axis axis 1,
//             (S, W) int32 up to (256, 1536)) and :58 (axis 0, (16, 128)
//             int32 and (8, 128) uint8); scripts/probe_vpu.py:104
//             probe_i16_gather (axis 1, (16, 128) int16 and uint16 tables
//             and indices) and :129 probe_roll (pltpu.roll: the roll mode)
//   chained   scripts/probe_vpu2.py:88 make_gather (:71-94): P chains
//             c = (x + i) & 127, then S steps of c = x[r, c & 127]; out =
//             sum c; scripts/probe_vpu.py:78 probe_gather (:65-92): one
//             chain from idx through row 0 of an (8, 128) table broadcast
//             to every row
//
// One-shot: out[r, j] = tab[r, k] (axis 1) or tab[k, j] (axis 0), for 1-,
// 2- and 4-byte elements.  k is idx[r, j] (int32, int16 or uint16, read as
// given) clamped to the axis: a negative index reads element 0, one past
// the axis the last.  In the roll mode there is no index: k is
// (j - shift) mod W (axis 1) or (r - shift) mod R (axis 0), computed here,
// so a roll is one launch that reads x once.  Bound: bytes (tab, idx and
// out once each; x and out for a roll).  What the design does about it:
//   - one block a row (blockIdx.y, looping past 65,535 rows), its threads
//     over the row's columns: no division an element;
//   - axis 1: the block stages its table row in shared memory (16-byte
//     loads, up to STAGE_BYTES), so the row is read from device memory once
//     and coalesced, and each element's lookup is one shared-memory load;
//     each thread loads its first idx vector before staging, so the two
//     reads from device memory overlap.  A wider row is read from device
//     memory directly;
//   - axis 0: the index picks rows, so the reads stay in device memory,
//     neighbouring threads on neighbouring columns; a roll copies one whole
//     source row, 16 bytes a load where it is aligned;
//   - idx and out move as 16-byte vectors (V elements of the wider of the
//     two types) where the pointers allow; each row's unaligned head and
//     tail go element by element.
//
// Chained: one block a row, one thread a column (C a power of two up to
// 1024).  The block stages its table row (or row 0) in shared memory, and
// every step of a chain is one dependent shared-memory load, the inner
// loop of K1 and of the lane-DFA scans.  Bound: shared-memory loads (32 an
// SM a clock); at P = 1 the time is the load's latency times S.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Bytes of its table row a block stages (axis 1): the shared memory a block
// has without opting in, 12,288 int32, 24,576 16-bit or 49,152 8-bit
// elements.  A wider row is read from device memory.
constexpr int STAGE_BYTES = 48 * 1024;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_GRID_Y = 65535;

template <typename E, int V>
struct alignas(sizeof(E) * V) Pack {
  E v[V];
};

template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load_pack(const E* p) {
  return *reinterpret_cast<const Pack<E, V>*>(p);
}

// elements a vector: 16 bytes of the wider of the element and index types
template <typename T, typename I, bool ROLL>
__host__ __device__ constexpr int vec_width() {
  return 16 / (ROLL || sizeof(T) >= sizeof(I) ? sizeof(T) : sizeof(I));
}

// row[0, n) = src[0, n), 16 bytes a load where src is aligned
template <typename T>
__device__ __forceinline__ void stage_row(T* row, const T* __restrict__ src,
                                          int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int E = 16 / sizeof(T);
    const int nv = n / E;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(row);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
    done = nv * E;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) row[i] = src[i];
}

// idx and out (R, W); tab (Rt, Wt): Rt = R on axis 1, Wt = W on axis 0, and
// both for a roll (tab is x, 0 <= shift < its axis).  vec: idx, out (and x
// for a roll) are aligned to their vectors; stage: axis 1 stages its row.
template <typename T, typename I, int AXIS, bool ROLL>
__global__ void __launch_bounds__(MAX_THREADS) gather_kernel(
    const T* __restrict__ tab, const I* __restrict__ idx, T* __restrict__ out,
    int R, int W, int Rt, int Wt, int shift, int vec, int stage) {
  constexpr int V = vec_width<T, I, ROLL>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* staged = reinterpret_cast<T*>(smem);
  const int n = AXIS == 1 ? Wt : Rt;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const long long base = (long long)r * W;
    const I* irow = ROLL ? nullptr : idx + base;
    T* orow = out + base;
    const int head = vec ? min((int)(-base & (V - 1)), W) : W;
    const int nvec = (W - head) / V;
    const int tail = head + nvec * V;
    const T* grow = tab + (long long)r * Wt;  // axis 1: the table row
    int rsrc = r - shift;                     // axis 0 roll: the source row
    if (rsrc < 0) rsrc += Rt;
    const bool src_vec = vec && ((long long)(rsrc - r) * W & (V - 1)) == 0;

    const int v0 = threadIdx.x;
    Pack<I, V> first{};
    if constexpr (!ROLL) {
      if (v0 < nvec) first = load_pack<I, V>(irow + head + v0 * V);
    }
    if (AXIS == 1 && stage) {
      stage_row(staged, grow, Wt);
      __syncthreads();
    }
    const T* row = AXIS == 1 && stage ? staged : grow;

    // element j of the row, from the index value i (unused in a roll)
    auto element = [&](int j, int i) -> T {
      int k;
      if constexpr (ROLL) {
        if constexpr (AXIS == 1) {
          k = j - shift;
          k += k < 0 ? W : 0;
        } else {
          k = rsrc;
        }
      } else {
        k = min(max(i, 0), n - 1);
      }
      return AXIS == 1 ? row[k] : tab[(long long)k * Wt + j];
    };
    auto index = [&](int j) -> int {
      if constexpr (ROLL) return 0;
      else return (int)irow[j];
    };

    for (int j = threadIdx.x; j < head; j += blockDim.x)
      orow[j] = element(j, index(j));
    for (int j = tail + threadIdx.x; j < W; j += blockDim.x)
      orow[j] = element(j, index(j));
    for (int v = v0; v < nvec; v += blockDim.x) {
      const int j0 = head + v * V;
      Pack<T, V> o;
      if constexpr (ROLL && AXIS == 0) {
        if (src_vec) {
          o = load_pack<T, V>(tab + (long long)rsrc * Wt + j0);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) o.v[e] = element(j0 + e, 0);
        }
      } else if constexpr (ROLL) {
#pragma unroll
        for (int e = 0; e < V; ++e) o.v[e] = element(j0 + e, 0);
      } else {
        const Pack<I, V> iv = v == v0 ? first : load_pack<I, V>(irow + j0);
#pragma unroll
        for (int e = 0; e < V; ++e) o.v[e] = element(j0 + e, (int)iv.v[e]);
      }
      *reinterpret_cast<Pack<T, V>*>(orow + j0) = o;
    }
    if (AXIS == 1 && stage) __syncthreads();  // before the next row stages
  }
}

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, typename I, int AXIS, bool ROLL>
int launch(const void* tab, const void* idx, void* out, int R, int W, int Rt,
           int Wt, int shift, cudaStream_t stream) {
  constexpr int V = vec_width<T, I, ROLL>();
  const bool vec = (ROLL ? aligned(tab, V * sizeof(T))
                         : aligned(idx, V * sizeof(I))) &&
                   aligned(out, V * sizeof(T));
  const int lanes = vec ? (W + V - 1) / V : W;
  const int threads = std::min(MAX_THREADS, std::max(32, (lanes + 31) / 32 * 32));
  const bool stage = AXIS == 1 && (size_t)Wt * sizeof(T) <= STAGE_BYTES;
  const size_t smem = stage ? (size_t)Wt * sizeof(T) : 0;
  gather_kernel<T, I, AXIS, ROLL>
      <<<dim3(1, std::min(R, MAX_GRID_Y)), threads, smem, stream>>>(
          static_cast<const T*>(tab), static_cast<const I*>(idx),
          static_cast<T*>(out), R, W, Rt, Wt, shift, (int)vec, (int)stage);
  return (int)cudaGetLastError();
}

template <typename I, bool ROLL>
int dispatch(const void* tab, const void* idx, void* out, int R, int W,
             int Rt, int Wt, int axis, int elem, int shift,
             cudaStream_t stream) {
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  if (R <= 0 || W <= 0) return (int)cudaSuccess;
  if (Rt <= 0 || Wt <= 0) return (int)cudaErrorInvalidValue;
#define WS_AXES(T)                                                          \
  return axis == 1                                                          \
             ? launch<T, I, 1, ROLL>(tab, idx, out, R, W, Rt, Wt, shift,    \
                                     stream)                                \
             : launch<T, I, 0, ROLL>(tab, idx, out, R, W, Rt, Wt, shift,    \
                                     stream)
  switch (elem) {
    case 1: WS_AXES(uint8_t);
    case 2: WS_AXES(uint16_t);
    case 4: WS_AXES(uint32_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WS_AXES
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

// tab (Rt, Wt), idx and out (R, W); elements of `elem` bytes; the index
// type: 0 int32, 1 int16, 2 uint16
extern "C" int ws_probe_gather(const void* tab, const void* idx, void* out,
                               int R, int W, int Rt, int Wt, int axis,
                               int elem, int index, cudaStream_t stream) {
  switch (index) {
    case 0:
      return dispatch<int32_t, false>(tab, idx, out, R, W, Rt, Wt, axis,
                                      elem, 0, stream);
    case 1:
      return dispatch<int16_t, false>(tab, idx, out, R, W, Rt, Wt, axis,
                                      elem, 0, stream);
    case 2:
      return dispatch<uint16_t, false>(tab, idx, out, R, W, Rt, Wt, axis,
                                       elem, 0, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x and out (R, W), elements of `elem` bytes; out = roll(x, shift, axis),
// 0 <= shift < the axis' length
extern "C" int ws_probe_roll(const void* x, void* out, int R, int W, int axis,
                             int elem, int shift, cudaStream_t stream) {
  const int n = axis == 1 ? W : R;
  if (n > 0 && (shift < 0 || shift >= n)) return (int)cudaErrorInvalidValue;
  return dispatch<int32_t, true>(x, nullptr, out, R, W, R, W, axis, elem,
                                 shift, stream);
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
