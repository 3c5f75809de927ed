// Paged flash-decode for Hopper (sm_90a): one query token per sequence
// against its KV pages, reached through a block table.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::paged_flash_decode
// (body _paged_decode_kernel, online softmax in _online_softmax_step /
// _online_merge).  Same function: for sequence b and KV head h, the G query
// heads of the group attend to positions [max(0, len - window), len) of the
// sequence, fp32 math, exp2-form online softmax with the NEG_INF / m_safe
// guards, optional logit softcap; a sequence with len 0 comes out exactly 0.
//
// How: the split-KV kernel of csrc/split_decode.cuh (its note says what
// bounds it and how it is laid out), with positions resolved through the
// block table.  The table is walked a tile ahead: 64 threads turn tile j +
// 2's positions into pool offsets while tile j is computed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_decode.cuh"

namespace paged_decode {

// position pos of sequence b: page table[b][pos / ps], row pos % ps of
// the (P, ps, Hkv, D) pool
struct Pages {
  static constexpr bool kTable = true;
  int n_pos;                 // n_max * ps: positions the table addresses
  const int* table;
  int n_max, ps;
  long long tok;             // Hkv * D: elements per pool row
  __device__ __forceinline__ long long row(int b, int pos) const {
    return (long long)table[(size_t)b * n_max + pos / ps] * ps * tok +
           (long long)(pos % ps) * tok;
  }
};

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lens, void* out, void* scratch, int B, int Hkv, int G,
           int ps, int n_max, int split, int window, float scale,
           float softcap, cudaStream_t stream) {
  const Pages addr{n_max * ps, static_cast<const int*>(table), n_max, ps,
                   (long long)Hkv * D};
  return split_kv::launch<T, D>(q, kp, vp, lens, out, scratch, addr, B, Hkv,
                                G, split, window, scale, softcap, stream);
}

}  // namespace paged_decode

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// scratch: fp32, B * Hkv * n_split * G * (D + 2) elements with n_split =
// ceil(n_max * page_size / split), from the caller's allocator; split: the
// positions a block owns, a positive multiple of 64.  Element type: is_bf16
// = 1 for bfloat16, 0 for float32; every pointer but the tables 16-byte
// aligned (the loads are 16-byte cp.async), else cudaErrorMisalignedAddress.
// Head dim 64, 128 or 256; at most 16 query heads per KV head.  Anything else
// returns cudaErrorInvalidValue without launching (the Python wrapper
// checks first).
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_table,
                                   const void* cache_len, void* out,
                                   void* scratch, int B, int Hkv, int G,
                                   int D, int page_size, int n_max,
                                   int split, int window, float scale,
                                   float softcap, int is_bf16, void* stream) {
  using split_kv::GMAX;
  using split_kv::TILE;
  if (G < 1 || G > GMAX || page_size < 1 || n_max < 1 || split < TILE ||
      split % TILE || (long long)n_max * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_DECODE_CASE(T, HD)                                          \
  return paged_decode::launch<T, HD>(q, k_pages, v_pages, block_table,    \
                                     cache_len, out, scratch, B, Hkv, G,  \
                                     page_size, n_max, split, window,     \
                                     scale, softcap, s)
  if (is_bf16) {
    if (D == 64) PAGED_DECODE_CASE(__nv_bfloat16, 64);
    if (D == 128) PAGED_DECODE_CASE(__nv_bfloat16, 128);
    if (D == 256) PAGED_DECODE_CASE(__nv_bfloat16, 256);
  } else {
    if (D == 64) PAGED_DECODE_CASE(float, 64);
    if (D == 128) PAGED_DECODE_CASE(float, 128);
    if (D == 256) PAGED_DECODE_CASE(float, 256);
  }
#undef PAGED_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
