// Helpers shared by the scans' backward kernels (csrc/mamba2_scan_bwd.cu,
// csrc/rwkv6_scan_bwd.cu): loads and stores that widen to and round from
// float32, and the reductions over the 16 state rows of a half-warp.
//
// Both kernels lay a block's threads out as tid = lane * ROWS + row with
// ROWS = 16: the 16 rows of one group of state columns sit in one
// half-warp, so a sum over the rows is 4 shuffle steps and a sum over the
// column groups goes through shared memory.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace scan_bwd {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
// rounded once, to nearest even (torch's .to(bfloat16))
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// Reduce-scatter of v[0 .. NV) (NV a power of two, at most 16) over the 16
// rows of a half-warp: at each of log2(NV) steps a row keeps half of its
// values and sends the other half to the row `off` away, which does the
// opposite, so NV values cost NV - 1 shuffles rather than 4 NV; the
// remaining steps sum the one value left.  Returns the sum over the 16
// rows of v[rows_index<NV>(row)]; every row with the same bits at the
// offsets 8, 4, ... (NV / 2 of them) holds the same sum.
template <int NV>
__device__ __forceinline__ float rows_sum(const float (&v)[NV], int row) {
  static_assert(NV >= 1 && NV <= 16 && (NV & (NV - 1)) == 0, "NV");
  float a[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) a[i] = v[i];
#pragma unroll
  for (int n = NV, off = 8; n > 1; n >>= 1, off >>= 1) {
    const bool up = row & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? a[i] : a[i + n / 2];
      const float keep = up ? a[i + n / 2] : a[i];
      a[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
#pragma unroll
  for (int off = 8 / NV; off > 0; off >>= 1)
    a[0] += __shfl_xor_sync(FULL, a[0], off);
  return a[0];
}

// which of the NV values rows_sum leaves in `row`
template <int NV>
__device__ __forceinline__ int rows_index(int row) {
  int idx = 0;
#pragma unroll
  for (int n = NV, off = 8; n > 1; n >>= 1, off >>= 1)
    if (row & off) idx += n / 2;
  return idx;
}

// the row of each group of 16 / NV rows holding the same sum that writes it
template <int NV>
__device__ __forceinline__ bool rows_writer(int row) {
  return (row & (16 / NV - 1)) == 0;
}

// sum over the 16 rows of a half-warp, every row holding the result
__device__ __forceinline__ float half_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

}  // namespace scan_bwd
