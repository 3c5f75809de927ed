// Dense flash-decode for Hopper (sm_90a): one query token per sequence
// against its contiguous KV cache strip.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode (body
// _decode_kernel, online softmax in _online_softmax_step / _online_merge).
// Same function as its plain version (kernels/ref.py flash_decode): for
// sequence b and KV head h, the G query heads of the group attend to
// positions [max(0, len - window), min(len, S)) of the sequence's (S, Hkv,
// D) strip, len read per lane from device memory; fp32 math, exp2-form
// online softmax with the NEG_INF / m_safe guards, optional logit softcap;
// a lane with len 0 comes out exactly 0.
//
// What bounds it on this card: bytes (each visible K/V position is read
// once and used by G query heads, about 1 FLOP a byte at G = 4), and at
// serving sizes the latency of a few MB spread over too few blocks.  So it
// is the split-KV kernel of csrc/split_decode.cuh, the paged decode K2's
// own, with the strip as its address space: position t of sequence b is
// the row (b S + t) Hkv D, no table to walk.  The grid is (B, Hkv,
// ceil(S / SPLIT)) - 1024 blocks of at most two 64-position tiles at the
// dense serving shape (8 strips of 2048, 8 KV heads), so no block walks a
// whole strip - each tile copied with 16-byte cp.async two buffers deep,
// the fp32 partials merged in split order by a second kernel.  Head dims
// 64, 80 (zamba2's shared attention block: a bf16 row of 160 B is 10
// chunks of 16 B), 128 and 256 (gemma3-4b; one K/V buffer in float32,
// split_kv::kv_stages); at G < 4 (zamba2 decodes at G = 1, gemma3-4b at
// G = 2) every warp scores positions, so no warp idles through the scores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_decode.cuh"

namespace dense_decode {

// position pos of sequence b: row (b * S + pos) of the (B, S, Hkv, D) cache
struct Strip {
  static constexpr bool kTable = false;
  int n_pos;                 // S
  long long tok;             // Hkv * D: elements per cache row
  __device__ __forceinline__ long long row(int b, int pos) const {
    return ((long long)b * n_pos + pos) * tok;
  }
};

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* lens,
           void* out, void* scratch, int B, int S, int Hkv, int G, int split,
           int window, float scale, float softcap, cudaStream_t stream) {
  const Strip addr{S, (long long)Hkv * D};
  return split_kv::launch<T, D>(q, kc, vc, lens, out, scratch, addr, B, Hkv,
                                G, split, window, scale, softcap, stream);
}

}  // namespace dense_decode

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// scratch: fp32, B * Hkv * n_split * G * (D + 2) elements with n_split =
// ceil(S / split), from the caller's allocator; split: the positions a
// block owns, a positive multiple of 64.  Element type: is_bf16 = 1 for
// bfloat16, 0 for float32; q, the caches, out and scratch 16-byte aligned
// (the loads are 16-byte cp.async), else cudaErrorMisalignedAddress.  Head
// dim 64, 80, 128 or 256; at most 16 query heads per KV head.  Anything else
// returns cudaErrorInvalidValue without launching (the Python wrapper
// checks first).
extern "C" int dense_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache,
                                   const void* cache_len, void* out,
                                   void* scratch, int B, int S, int Hkv,
                                   int G, int D, int split, int window,
                                   float scale, float softcap, int is_bf16,
                                   void* stream) {
  using split_kv::GMAX;
  using split_kv::TILE;
  if (G < 1 || G > GMAX || S < 0 || split < TILE || split % TILE)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DENSE_DECODE_CASE(T, HD)                                           \
  return dense_decode::launch<T, HD>(q, k_cache, v_cache, cache_len, out,  \
                                     scratch, B, S, Hkv, G, split, window, \
                                     scale, softcap, s)
  if (is_bf16) {
    if (D == 64) DENSE_DECODE_CASE(__nv_bfloat16, 64);
    if (D == 80) DENSE_DECODE_CASE(__nv_bfloat16, 80);
    if (D == 128) DENSE_DECODE_CASE(__nv_bfloat16, 128);
    if (D == 256) DENSE_DECODE_CASE(__nv_bfloat16, 256);
  } else {
    if (D == 64) DENSE_DECODE_CASE(float, 64);
    if (D == 80) DENSE_DECODE_CASE(float, 80);
    if (D == 128) DENSE_DECODE_CASE(float, 128);
    if (D == 256) DENSE_DECODE_CASE(float, 256);
  }
#undef DENSE_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
