// Tensor-core helpers shared by the bf16 kernels (csrc/flash_attention.cu,
// csrc/flash_backward.cu, csrc/paged_prefill.cu, csrc/mamba2_scan.cu,
// csrc/rwkv6_scan.cu): inline PTX for cp.async staging, ldmatrix fragment
// loads and the bf16 mma.sync tile, the lane arithmetic that places a 16 x
// 16 or 16 x 8 fragment, tile loads and the split of fp32 values into two
// bf16 parts.
//
// The tile is mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: A is 16 x 16
// bf16 (4 registers), B is 16 x 8 bf16 (2 registers), C / D are 16 x 8
// fp32 (4 registers).  Lane l holds, with g = l / 4 and t = l % 4:
//   A  a0: (row g,     cols 2t, 2t+1)   a1: (row g + 8, cols 2t, 2t+1)
//      a2: (row g,     cols 2t+8, +9)   a3: (row g + 8, cols 2t+8, +9)
//   B  b0: (k 2t, 2t+1; col n = g)      b1: (k 2t+8, 2t+9; col n = g)
//   C  c0, c1: (row g, cols 2t, 2t+1)   c2, c3: (row g + 8, cols 2t, 2t+1)
// so the accumulators of two neighbouring 8-column tiles, rounded to bf16
// and packed in pairs, are the A operand of the next product over those
// 16 columns (FA-2's register reuse: no trip through shared memory).
//
// Shared-memory tiles are row-major bf16 with rows padded by 8 elements
// (16 bytes): a row of 64, 80, 128 or 256 elements is then 36, 44, 68 or
// 132 words, and the 8 row addresses of one ldmatrix 8 x 8 matrix fall in
// 8 distinct 4-bank groups - no bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace mma_bf16 {

constexpr int PAD = 8;   // elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; live == false zero-fills the
// destination and reads nothing (src must still be an address of the
// tensor's allocation)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous, zero-filled when !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every committed group of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b for one 16 x 8 tile, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even, as torch's .to(bf16)),
// lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step `ks` (16 columns) from the fp32 accumulators of
// its two 8-column tiles c[2 ks], c[2 ks + 1], rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int ks) {
  a[0] = pack(c[2 * ks][0], c[2 * ks][1]);
  a[1] = pack(c[2 * ks][2], c[2 * ks][3]);
  a[2] = pack(c[2 * ks + 1][0], c[2 * ks + 1][1]);
  a[3] = pack(c[2 * ks + 1][2], c[2 * ks + 1][3]);
}

// Lane addresses for ldmatrix.x4 over a row-major tile with row stride ld
// (elements).  Each returns the element offset this lane supplies.
//
// A fragment of the 16 x 16 block at (row0, col0):
__device__ __forceinline__ int a_offset(int lane, int ld, int row0,
                                        int col0) {
  return (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
// B fragments of two 8-column tiles (n0 .. n0 + 15) over k-step k0 .. k0 +
// 15, from a tile stored [n][k] (the operand's columns are its rows, as K
// in q . k^T): r0, r1 = b0, b1 of tile n0; r2, r3 = b0, b1 of tile n0 + 8.
__device__ __forceinline__ int b_offset(int lane, int ld, int n0, int k0) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// The same two B fragments from a tile stored [k][n] (as V in p . v),
// loaded with ldmatrix_x4_trans.
__device__ __forceinline__ int bt_offset(int lane, int ld, int k0, int n0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// max / sum over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a (rows x COLS) bf16 tile of a row-major global array (row stride
// gstride) into shared memory (row stride ld) by NTH threads, rows at or
// past nrows and columns at or past ncols zero; vec: 16-byte cp.async
// chunks (every pointer 16-byte aligned, ncols and gstride multiples of
// 8), else element by element
template <int COLS, int NTH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long gstride, int rows,
                                          int nrows, int ncols, bool vec,
                                          int tid) {
  constexpr int CPR = COLS / 8;       // 16-byte chunks per row
  for (int i = tid; i < rows * CPR; i += NTH) {
    const int r = i / CPR, c = i - r * CPR;
    __nv_bfloat16* d = dst + r * ld + c * 8;
    const bool live = r < nrows && c * 8 < ncols;
    if (vec) {
      cp_async16(d, live ? src + r * gstride + c * 8 : src, live);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = r < nrows && c * 8 + j < ncols ? src[r * gstride + c * 8 + j]
                                              : __float2bfloat16(0.f);
    }
  }
}

// two fp32 values as two bf16 parts, hi = bf16(v) and lo = bf16(v - hi)
// (the remainder is exact in fp32), each pair packed for an mma operand
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(v0 - __low2float(h), v1 - __high2float(h));
}

// host side: every bf16 operand 16-byte aligned (cp.async moves 16 bytes,
// the epilogues store 4), else the entry point refuses the launch
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

}  // namespace mma_bf16
