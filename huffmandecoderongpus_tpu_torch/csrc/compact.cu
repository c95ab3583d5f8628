// Per-column compaction of padded lane-DFA emissions to dense rows.
//
// Replaces huffmandecoderongpus_tpu/ops/pallas_lanedfa.py compact_pallas /
// _compact_kernel, which finds, for every output row i of a column, the row
// of the column's (i+1)-th emission by a branchless binary search over the
// inclusive emission count `cum` (Mosaic has no scatter, and its gathers
// need operand and indices of one shape, so the search runs at the full
// (steps, 1024) shape).  Here the count itself is the emission's rank, so
// no search is needed: one thread owns one (row, column) cell, row r emits
// where cum[r] > cum[r-1] (cum[-1] = 0), and its symbol goes to row
// cum[r] - 1 while that is below out_rows; the same thread zeroes output row
// r when it is at or past the column's count cum[steps-1].  No two threads
// write one byte.  Any number of columns.
//
// What bounds it on the H100: bytes.  Each cum and sym cell is read by its
// thread (cum[r-1] again by the next row's, mostly from cache), coalesced
// across the columns of a warp; the dense writes land at each column's own
// rank, so a warp's writes scatter.

#include "widescan.cuh"

namespace {

__global__ void __launch_bounds__(128) lanedfa_compact_kernel(
    const int32_t* __restrict__ cum, const uint8_t* __restrict__ sym,
    uint8_t* __restrict__ out, int steps, int G, int out_rows) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int count = steps ? cum[(size_t)(steps - 1) * G + g] : 0;
  const int rows = max(steps, out_rows);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t at = (size_t)r * G + g;
    if (r < steps) {
      const int c = cum[at];
      const int prev = r ? cum[at - G] : 0;
      if (c > prev && c - 1 < out_rows) out[(size_t)(c - 1) * G + g] = sym[at];
    }
    if (r < out_rows && r >= count) out[at] = 0;
  }
}

}  // namespace

extern "C" int ws_compact(const int32_t* cum, const uint8_t* sym,
                          uint8_t* out, int steps, int G, int out_rows,
                          cudaStream_t stream) {
  const int threads = 128;
  const int rows = max(steps, out_rows);
  if (G <= 0 || rows <= 0) return (int)cudaSuccess;
  const dim3 grid((G + threads - 1) / threads, min(rows, 65535));
  lanedfa_compact_kernel<<<grid, threads, 0, stream>>>(cum, sym, out, steps,
                                                       G, out_rows);
  return (int)cudaGetLastError();
}
