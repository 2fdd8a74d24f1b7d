// The split of a (slot, row)'s cache columns into segments, shared by the
// slot kernel (fairkv_decode.cu) and the paged body (paged_decode.cuh).
// The segment size and the segments' merge are defined once, here, so the
// two kernels take the same boundaries and merge in the same operations:
// "slot == paged, bitwise" holds at every length by construction.
#pragma once

namespace colseg {

// columns per segment: fixed, so a boundary depends on the column index
// alone (never on B, S, the grid or the SM count)
constexpr int SEG = 4096;

// the segments that n columns span (0 for n <= 0)
__host__ __device__ constexpr int n_segments(int n) { return n > 0 ? (n + SEG - 1) / SEG : 0; }

// one term of the segments' merge, taken in segment order: x_0 g_0, then
// sum + x_s g_s.  The first is a product, not an fma onto +0, so that a
// -0 stays -0 and one segment through this merge keeps its own values.
__device__ __forceinline__ float fold(int s, float x, float g, float sum) {
  return s == 0 ? __fmul_rn(x, g) : __fmaf_rn(x, g, sum);
}

}  // namespace colseg
