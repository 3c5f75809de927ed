// Split-KV flash-decode shared by the paged decode K2 (csrc/paged_decode.cu)
// and the dense decode K3 (csrc/dense_decode.cu): one query token per
// sequence against its KV positions, however a position becomes an
// address.  Each kernel source defines an addressing policy and calls
// split_kv::launch with it:
//
//   struct Addr {
//     static constexpr bool kTable;  // positions resolved through a table:
//                                    // offsets staged a tile ahead
//     int n_pos;                     // positions the cache can address
//     // element offset of sequence b's position pos, KV head 0
//     __device__ long long row(int b, int pos) const;
//   };
//
// Function: for sequence b and KV head h, the G query heads of the group
// attend to positions [max(0, len - window), min(len, n_pos)) of the
// sequence, len read from device memory; fp32 math, exp2-form online
// softmax with the NEG_INF / m_safe guards, optional logit softcap; a
// sequence with len 0 comes out exactly 0.
//
// What bounds it on this card: bytes.  Each K/V position is read once and
// used by G query heads for 4*G*D FLOPs against 4*D bytes (bf16 K and V):
// about 1 FLOP per byte at G = 4, far below the ~295 FLOP/byte where an
// H100 stops being memory bound.  So the math stays fp32 on the CUDA cores
// in both dtypes, and the design is about parallelism across the sequence
// and bytes in flight:
//
//  * Split-KV.  The grid is (sequence b, KV head h, split), n_split =
//    ceil(n_pos / split): a block owns the absolute positions [split_i *
//    split, (split_i + 1) * split) of its sequence and walks only the part
//    inside [lo, hi), lo = max(0, len - window), hi = min(len, n_pos).  A
//    block whose part is empty writes an empty partial (m = NEG_INF, l = 0)
//    and returns.  `split` is a fixed number of positions the wrapper
//    passes (kernels/flash_decode.py SPLIT); n_split follows from shapes the
//    host knows, so no length is read on the host.  Since the split does
//    not depend on the batch, the number of KV heads or the card, a
//    sequence's output bits depend only on its own q, K/V and length: the
//    same alone as inside any batch, and from call to call.
//  * Bytes in flight.  A block loads its part in tiles of 64 positions,
//    every position's head row (D elements, contiguous) as 16-byte
//    cp.async chunks into shared memory (rows padded by 16 bytes), two
//    buffers deep: the whole of tile j + 1 is in flight while tile j is
//    computed.  With a table, 64 threads turn a tile's positions into
//    offsets a tile ahead of its load; without one, a chunk's address is
//    computed where it is loaded.  All G query heads of the group use each
//    K/V row from shared memory.
//  * Scores.  With G >= 4, warp w scores the heads g = w, w + 4, ... against
//    the tile (a lane two positions, K read as 16-byte vectors, q
//    pre-scaled in shared memory) and runs their online softmax with warp
//    shuffles.  With G < 4 that would leave warps idle (zamba2's shared
//    block decodes at G = 1), so every thread scores (head, position) pairs
//    into shared memory first and warp g then runs head g's softmax; each
//    score is the same chain of FMAs in both layouts, so the layout does
//    not change a bit of the result.  Then every thread updates its pairs
//    of the G x D fp32 accumulators with the weights and V from shared
//    memory.  Two barriers a tile (three with G < 4).
//  * Combine.  Each block writes its unnormalised o (G x D), m and l (G)
//    to fp32 scratch the wrapper allocates; a second kernel, one block per
//    (b, h), merges the partials in fixed split order as
//    combine_partial_softmax does (repro/kernels/ref.py; the port's copy in
//    kernels/ref.py): m = max m_i, the m_safe guard, alpha_i = 0 for an
//    empty partial, then o / max(l, 1e-20) in the output dtype.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace split_kv {

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int TILE = 64;         // KV positions per tile
constexpr int TPL = TILE / 32;   // positions per lane in the softmax
constexpr int GMAX = 16;         // most query heads per KV head
constexpr int RPW = GMAX / NWARP;  // most heads per warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte chunk of shared memory as fp32 values
__device__ __forceinline__ void chunk_to_f(float (&f)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void chunk_to_f(float (&f)[8],
                                           const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    f[2 * i] = __low2float(b);
    f[2 * i + 1] = __high2float(b);
  }
}
// two neighbouring elements as fp32
__device__ __forceinline__ float2 pair_to_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_to_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q_s[0:D] . K row, one FMA chain from 0 in element order (both score
// layouts use it, so both give the same bits)
template <typename T, int D>
__device__ __forceinline__ float score(const float* qr, const T* kr) {
  constexpr int EPC = 16 / sizeof(T);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / EPC; ++c) {
    float kf[EPC];
    chunk_to_f(kf, kr + c * EPC);
#pragma unroll
    for (int x = 0; x < EPC; x += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + c * EPC + x);
      s = fmaf(qv.x, kf[x], s);
      s = fmaf(qv.y, kf[x + 1], s);
      s = fmaf(qv.z, kf[x + 2], s);
      s = fmaf(qv.w, kf[x + 3], s);
    }
  }
  return s;
}

// One head's online-softmax step over a tile, run by one warp: the lane's
// raw scores sc (positions t0 + lane + 32 i) get the softcap and the mask
// (positions at or past e), the weights go to pr[lane + 32 i], the running
// max / sum are updated, and the rescale factor of the old accumulator is
// written to *alpha_out by lane 0.
__device__ __forceinline__ void softmax_step(float (&sc)[TPL], float* pr,
                                             float* alpha_out, float& m_run,
                                             float& l_run, int lane, int t0,
                                             int e, float softcap) {
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < TPL; ++i) {
    float x = sc[i];
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    x = t0 + lane + 32 * i < e ? x : NEG_INF;
    sc[i] = x;
    mx = fmaxf(mx, x);
  }
  mx = warp_max(mx);
  const float m_new = fmaxf(m_run, mx);
  const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < TPL; ++i) {
    const float p = t0 + lane + 32 * i < e
                        ? exp2f((sc[i] - m_safe) * LOG2E)
                        : 0.f;
    pr[lane + 32 * i] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  const float alpha = m_run <= NEG_INF / 2
                          ? 0.f
                          : exp2f((m_run - m_new) * LOG2E);
  l_run = l_run * alpha + sum;
  m_run = m_new;
  if (lane == 0) *alpha_out = alpha;
}

// Scratch layout (fp32), P = B * Hkv * n_split partials, partial index
// ((b * Hkv + h) * n_split + i): o at [P][G][D], then m at [P][G], then l
// at [P][G].
template <typename T, int D, class Addr>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ lens,
    float* __restrict__ scratch, const Addr addr, int Hkv, int G, int split,
    int window, float scale, float softcap) {
  constexpr int EPC = 16 / sizeof(T);      // elements per 16-byte chunk
  constexpr int CH = D / EPC;              // chunks per head row
  constexpr int LD = D + EPC;              // padded shared-memory row
  constexpr int NP = GMAX * D / 2 / NT;    // accumulator pairs per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);        // 2 x (K, V) x TILE x LD
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * TILE * LD);  // G x D
  float* p_s = q_s + G * D;                        // G x TILE weights
  float* a_s = p_s + G * TILE;                     // G rescale factors
  // with a table: offsets (elements) of the positions of two tiles, -1
  // past the part
  long long* pos_s = reinterpret_cast<long long*>(a_s + ((G + 1) & ~1));

  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int L = lens[b];
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int hi = min(L, addr.n_pos);
  const int a = max(lo, sp * split), e = min(hi, (sp + 1) * split);
  const size_t P = (size_t)gridDim.x * gridDim.y * n_split;
  const size_t part = ((size_t)b * Hkv + h) * n_split + sp;
  float* o_part = scratch + part * G * D;
  float* m_part = scratch + P * G * D + part * G;
  float* l_part = m_part + P * G;
  if (a >= e) {
    if (tid < G) {
      m_part[tid] = NEG_INF;
      l_part[tid] = 0.f;
    }
    return;
  }
  const int n_tiles = (e - a + TILE - 1) / TILE;
  const long long head = (long long)h * D;

  auto fill_offsets = [&](int j) {
    if constexpr (Addr::kTable) {
      if (tid < TILE) {
        const int pos = a + j * TILE + tid;
        pos_s[(j & 1) * TILE + tid] =
            pos < e ? addr.row(b, pos) + head : -1;
      }
    }
  };
  auto load_kv = [&](int j) {
    T* ks = kv_s + (j & 1) * 2 * TILE * LD;
    T* vs = ks + TILE * LD;
    for (int i = tid; i < TILE * CH; i += NT) {
      const int rr = i / CH, c = i % CH;
      long long o;
      if constexpr (Addr::kTable) {
        o = pos_s[(j & 1) * TILE + rr];
      } else {
        const int pos = a + j * TILE + rr;
        o = pos < e ? addr.row(b, pos) + head : -1;
      }
      const bool live = o >= 0;
      const long long src = live ? o + c * EPC : 0;
      mma_bf16::cp_async16(ks + rr * LD + c * EPC, kc + src, live);
      mma_bf16::cp_async16(vs + rr * LD + c * EPC, vc + src, live);
    }
  };

  fill_offsets(0);
  fill_offsets(1);
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = to_f(qb[i]) * scale;
  __syncthreads();       // the offsets of tiles 0 and 1, q_s
  load_kv(0);
  mma_bf16::cp_async_commit();

  // row statistics: warp w owns query heads g = w, w + NWARP, ...
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    m_run[k] = NEG_INF;
    l_run[k] = 0.f;
  }
  // accumulator pairs: thread tid owns pairs tid + NT * u of the G x D / 2
  float acc[NP][2];
#pragma unroll
  for (int u = 0; u < NP; ++u) acc[u][0] = acc[u][1] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = a + j * TILE;
    mma_bf16::cp_async_wait_all();
    __syncthreads();     // tile j landed; every thread is done with j - 1
    if (j + 1 < n_tiles) load_kv(j + 1);
    mma_bf16::cp_async_commit();
    fill_offsets(j + 2);   // tile j's buffer: its load was issued before
    const T* ks = kv_s + (j & 1) * 2 * TILE * LD;
    const T* vs = ks + TILE * LD;

    if (G >= NWARP) {
      // scores of this warp's heads: lane owns positions lane + 32 i
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int g = warp + NWARP * k;
        if (g >= G) continue;
        float sc[TPL];
#pragma unroll
        for (int i = 0; i < TPL; ++i)
          sc[i] = score<T, D>(q_s + g * D, ks + (lane + 32 * i) * LD);
        softmax_step(sc, p_s + g * TILE, a_s + g, m_run[k], l_run[k], lane,
                     t0, e, softcap);
      }
    } else {
      // fewer heads than warps: every thread scores (head, position) pairs
      for (int i = tid; i < G * TILE; i += NT) {
        const int g = i / TILE, t = i - g * TILE;
        p_s[i] = score<T, D>(q_s + g * D, ks + t * LD);
      }
      __syncthreads();   // every raw score of the tile
      if (warp < G) {
        float sc[TPL];
#pragma unroll
        for (int i = 0; i < TPL; ++i) sc[i] = p_s[warp * TILE + lane + 32 * i];
        softmax_step(sc, p_s + warp * TILE, a_s + warp, m_run[0], l_run[0],
                     lane, t0, e, softcap);
      }
    }
    __syncthreads();     // weights and rescale factors of every head

    // o += p v over the tile (positions past the part have p = 0 and a
    // zero-filled V row)
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int e2 = 2 * (tid + NT * u);
      if (e2 < G * D) {
        const int g = e2 / D, d = e2 - g * D;
        const float* pr = p_s + g * TILE;
        const float al = a_s[g];
        float o0 = acc[u][0] * al, o1 = acc[u][1] * al;
#pragma unroll 8
        for (int t = 0; t < TILE; ++t) {
          const float p = pr[t];
          const float2 vv = pair_to_f(vs + t * LD + d);
          o0 = fmaf(p, vv.x, o0);
          o1 = fmaf(p, vv.y, o1);
        }
        acc[u][0] = o0;
        acc[u][1] = o1;
      }
    }
  }
  mma_bf16::cp_async_wait_all();

#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int g = warp + NWARP * k;
    if (g < G && lane == 0) {
      m_part[g] = m_run[k];
      l_part[g] = l_run[k];
    }
  }
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const int e2 = 2 * (tid + NT * u);
    if (e2 < G * D)
      *reinterpret_cast<float2*>(o_part + e2) =
          make_float2(acc[u][0], acc[u][1]);
  }
}

// One block per (b, h): the n_split partials merged in split order.  (Addr
// only names the instantiation after the kernel that launches it.)
template <typename T, int D, class Addr>
__global__ void __launch_bounds__(NT) decode_combine_kernel(
    const float* __restrict__ scratch, T* __restrict__ out, int Hkv, int G,
    int n_split) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t P = (size_t)gridDim.x * gridDim.y * n_split;
  const size_t p0 = ((size_t)b * Hkv + h) * n_split;
  const float* m_all = scratch + P * G * D;
  const float* l_all = m_all + P * G;
  T* ob = out + ((size_t)b * Hkv * G + (size_t)h * G) * D;
  for (int e2 = 2 * threadIdx.x; e2 < G * D; e2 += 2 * NT) {
    const int g = e2 / D;
    float m = NEG_INF;
    for (int i = 0; i < n_split; ++i)
      m = fmaxf(m, m_all[(p0 + i) * G + g]);
    const float m_safe = m <= NEG_INF / 2 ? 0.f : m;
    float l = 0.f, o0 = 0.f, o1 = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float mi = m_all[(p0 + i) * G + g];
      if (mi <= NEG_INF / 2) continue;        // empty partial: alpha = 0
      const float alpha = exp2f((mi - m_safe) * LOG2E);
      const float2 oi =
          *reinterpret_cast<const float2*>(scratch + ((p0 + i) * G) * D + e2);
      l += l_all[(p0 + i) * G + g] * alpha;
      o0 += oi.x * alpha;
      o1 += oi.y * alpha;
    }
    const float inv = 1.f / fmaxf(l, 1e-20f);
    ob[e2] = from_f<T>(o0 * inv);
    ob[e2 + 1] = from_f<T>(o1 * inv);
  }
}

// Both kernels on `stream`.  scratch: fp32, B * Hkv * n_split * G * (D + 2)
// elements, n_split = ceil(addr.n_pos / split); split a positive multiple
// of TILE, G in [1, GMAX] (the entry points check both).  Returns a
// cudaError_t.
template <typename T, int D, class Addr>
int launch(const void* q, const void* kc, const void* vc, const void* lens,
           void* out, void* scratch, const Addr& addr, int B, int Hkv, int G,
           int split, int window, float scale, float softcap,
           cudaStream_t stream) {
  constexpr int LD = D + 16 / (int)sizeof(T);
  const long long n_split = ((long long)addr.n_pos + split - 1) / split;
  if (n_split > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (!mma_bf16::aligned16({q, kc, vc, out, scratch}))
    return (int)cudaErrorMisalignedAddress;
  if (n_split > 0) {
    const size_t smem = sizeof(T) * 4 * TILE * LD +
                        sizeof(float) * ((size_t)G * D + (size_t)G * TILE +
                                         ((G + 1) & ~1)) +
                        (Addr::kTable ? sizeof(long long) * 2 * TILE : 0);
    auto kern = decode_split_kernel<T, D, Addr>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(B, Hkv, (unsigned)n_split), NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const int*>(lens),
        static_cast<float*>(scratch), addr, Hkv, G, split, window, scale,
        softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  decode_combine_kernel<T, D, Addr><<<dim3(B, Hkv), NT, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(out), Hkv, G,
      (int)n_split);
  return (int)cudaGetLastError();
}

}  // namespace split_kv
