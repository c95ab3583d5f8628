// P2: integer-latency probe, P dependent chains a thread for S steps.
//
// Replaces the arithmetic Pallas kernels of the hardware probes:
//   body xor3   scripts/probe_vpu2.py:62 make_arith (:47-68): P chains
//               c = x + i, then S steps of c = c + (c ^ 3); out = sum c
//   body addxor scripts/probe_vpu.py:48 probe_arith (:33-62): a = x,
//               b = x + 1, then S steps of 4 x {a = a + b; b = b ^ a};
//               out = a + b; int32 or int16
//   body mul3   scripts/hw_dispatch.py:67 med (med_k :58-61): S steps of
//               a = a * 3 + i; out = a
//
// One thread an element, its chains in registers (P and the body are
// template parameters, S a run-time count, so the loop cannot be folded).
// The chains overflow within about 30 steps: JAX and torch wrap, signed
// overflow in C++ is undefined, so every chain is a uint32_t and, for
// int16, is cut to 16 bits after every add.  An empty asm statement after
// each step keeps the compiler from merging steps algebraically: each step
// costs the ops it is written with.
//
// What bounds it on the H100: operations (the body's integer ops, 64 INT32
// lanes an SM a clock), but at one thread an element a (128, 128) tile is
// 4 warps an SM, so P = 1 exposes the dependent latency of an op and P = 4
// or 8 shows how far independent chains hide it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Body { XOR3 = 0, ADDXOR = 1, MUL3 = 2 };

__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)); }

template <int P>
__global__ void __launch_bounds__(128) arith_xor3_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int n, int S) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const uint32_t x0 = (uint32_t)x[t];
  uint32_t c[P];
#pragma unroll
  for (int i = 0; i < P; ++i) c[i] = x0 + (uint32_t)i;
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      c[i] = c[i] + (c[i] ^ 3u);
      keep(c[i]);
    }
  }
  uint32_t acc = c[0];
#pragma unroll
  for (int i = 1; i < P; ++i) acc += c[i];
  out[t] = (int32_t)acc;
}

template <typename T>
__global__ void __launch_bounds__(128) arith_addxor_kernel(
    const T* __restrict__ x, T* __restrict__ out, int n, int S) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  constexpr uint32_t M = sizeof(T) == 2 ? 0xFFFFu : 0xFFFFFFFFu;
  uint32_t a = (uint32_t)x[t] & M;
  uint32_t b = (a + 1u) & M;
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a = (a + b) & M;
      b = b ^ a;
    }
    keep(a);
    keep(b);
  }
  out[t] = (T)((a + b) & M);
}

__global__ void __launch_bounds__(128) arith_mul3_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int n, int S) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint32_t a = (uint32_t)x[t];
  for (int s = 0; s < S; ++s) {
    a = a * 3u + (uint32_t)s;
    keep(a);
  }
  out[t] = (int32_t)a;
}

}  // namespace

// x, out: n elements of 4 bytes (2 for bits = 16, addxor only)
extern "C" int ws_probe_arith(const void* x, void* out, int n, int S,
                              int body, int P, int bits, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (S < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* oi = static_cast<int32_t*>(out);
  if (body == XOR3 && bits == 32) {
    switch (P) {
      case 1: arith_xor3_kernel<1><<<blocks, threads, 0, stream>>>(xi, oi, n, S); break;
      case 4: arith_xor3_kernel<4><<<blocks, threads, 0, stream>>>(xi, oi, n, S); break;
      case 8: arith_xor3_kernel<8><<<blocks, threads, 0, stream>>>(xi, oi, n, S); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (body == ADDXOR && P == 1 && bits == 32) {
    arith_addxor_kernel<int32_t><<<blocks, threads, 0, stream>>>(xi, oi, n, S);
  } else if (body == ADDXOR && P == 1 && bits == 16) {
    arith_addxor_kernel<int16_t><<<blocks, threads, 0, stream>>>(
        static_cast<const int16_t*>(x), static_cast<int16_t*>(out), n, S);
  } else if (body == MUL3 && P == 1 && bits == 32) {
    arith_mul3_kernel<<<blocks, threads, 0, stream>>>(xi, oi, n, S);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
