// Ragged batched paged chunk prefill for Hopper (sm_90a): K query chunks of
// K sequences, each at its own absolute offset, attending through its own
// block-table row into one global page pool.
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py::
// batched_paged_prefill_attention (body _chunk_kernel; its K=1 wrapper
// paged_prefill_attention calls the same launch).  Same function: row k's
// query r sits at absolute position off[k] + r and attends to columns
// c <= off[k] + r with c < true_len[k] (and c > off[k] + r - window when a
// window is set), fp32 math, exp2-form online softmax with the NEG_INF /
// m_safe guards, optional logit softcap.  Query lanes at or past q_len[k]
// come out exactly zero, and so does every lane of a dead row
// (true_len == 0).
//
// What bounds it on this card: at the serving shapes (chunks of 256 tokens
// over prefixes of up to 2k tokens, G = 4 query heads per KV head) the work
// is S*G rows x prefix columns x 4*D FLOPs against one read of the prefix's
// K/V pages, several hundred FLOPs per byte: operations, not bytes.  This
// first version does its products in fp32 on the CUDA cores (the tensor
// cores would need wgmma / mma tiles, which is a later PR's work); what it
// does about the bound is to reuse every operand many times from on-chip
// memory.  A block holds 64 flattened query rows (the S*G rows of one KV
// head, as the TPU kernel flattens them) in shared memory, loads 64 KV
// positions at a time through the block table into shared memory, and each
// thread computes an 8 x 4 register tile of scores and an 8 x D/16 tile of
// the output accumulators, so every value loaded from shared memory feeds
// several FMAs.
//
// Grid: one block per (row k, KV head h, tile of 64 flattened query rows).
// The KV range a block walks is cut before the loop: nothing at or past
// true_len, nothing past the tile's last live causal column, nothing left
// of the tile's first column inside the window.  Rows past q_len do no work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block: 8 row groups x 16 columns
constexpr int BR = 64;       // flattened query rows per block
constexpr int TILE = 64;     // KV positions per tile
constexpr int RI = BR / 8;   // rows per thread
constexpr int CI = TILE / 16;  // score columns per thread
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

// reductions over the 16 lanes that share a row group (one half-warp)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ offs, const int* __restrict__ tls,
    const int* __restrict__ qls, T* __restrict__ out, int S, int Hkv, int G,
    int ps, int n_max, int window, float scale, float softcap) {
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // BR x (D + 1)
  float* k_s = q_s + BR * (D + 1);      // TILE x (D + 1)
  float* v_s = k_s + TILE * (D + 1);    // TILE x D
  float* p_s = v_s + TILE * D;          // BR x (TILE + 1)

  const int row_k = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * BR;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int Hq = Hkv * G, R = S * G;
  const int off = offs[row_k], tl = tls[row_k], ql = qls[row_k];
  const size_t tok_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)ps * tok_stride;
  const int* trow = tables + (size_t)row_k * n_max;

  // KV range of this block: live query indices s_first .. s_live
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BR, R) - 1) / G;
  const int s_live = min(s_last, ql - 1);
  const int kv_lo = window > 0 ? max(0, off + s_first - window + 1) : 0;
  int kv_hi = min(min(tl, off + s_live + 1), n_max * ps);
  if (s_live < s_first || tl <= 0) kv_hi = 0;

  for (int i = tid; i < BR * D; i += NT) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr;
    float v = 0.f;
    if (r < R) {
      const int s = r / G, g = r - s * G;
      v = to_f(q[(((size_t)row_k * S + s) * Hq + (size_t)h * G + g) * D + d]) *
          scale;
    }
    q_s[rr * (D + 1) + d] = v;
  }

  // this thread's rows: r0 + tr + 8 * i; their absolute query positions
  int qpos[RI];
  bool rlive[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    const int s = r / G;
    qpos[i] = off + s;
    rlive[i] = r < R && s < ql;
  }
  float acc[RI][DC], m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += TILE) {
    __syncthreads();   // q_s written / previous tile fully consumed
    for (int i = tid; i < TILE * D; i += NT) {
      const int t = i / D, d = i - t * D;
      const int kpos = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (kpos < kv_hi) {
        const size_t o = (size_t)trow[kpos / ps] * page_stride +
                         (size_t)(kpos % ps) * tok_stride + (size_t)h * D + d;
        kv = to_f(kp[o]);
        vv = to_f(vp[o]);
      }
      k_s[t * (D + 1) + d] = kv;
      v_s[t * D + d] = vv;
    }
    __syncthreads();

    float sc[RI][CI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CI; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(tr + 8 * i) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < CI; ++c) kv[c] = k_s[(tc + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CI; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      bool valid[CI];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const int kpos = t0 + tc + 16 * c;
        valid[c] = rlive[i] && kpos < kv_hi && kpos <= qpos[i] &&
                   (window <= 0 || kpos > qpos[i] - window);
        float s = sc[i][c];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s = valid[c] ? s : NEG_INF;
        sc[i][c] = s;
        mx = fmaxf(mx, s);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m_run[i], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const float p = valid[c] ? exp2f((sc[i][c] - m_safe) * LOG2E) : 0.f;
        p_s[(tr + 8 * i) * (TILE + 1) + tc + 16 * c] = p;
        sum += p;
      }
      sum = half_sum(sum);
      const float alpha =
          m_run[i] <= NEG_INF / 2 ? 0.f : exp2f((m_run[i] - m_new) * LOG2E);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < TILE; ++t) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[t * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(tr + 8 * i) * (TILE + 1) + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    if (r >= R) continue;
    const int s = r / G, g = r - s * G;
    const float inv = 1.f / fmaxf(l_run[i], 1e-20f);
    T* o = out + (((size_t)row_k * S + s) * Hq + (size_t)h * G + g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[tc + 16 * c] = from_f<T>(rlive[i] ? acc[i][c] * inv : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* offs, const void* tls, const void* qls, void* out,
           int K, int S, int Hkv, int G, int ps, int n_max, int window,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BR * (D + 1) + (size_t)TILE * (D + 1) +
                       (size_t)TILE * D + (size_t)BR * (TILE + 1));
  auto kern = paged_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K, Hkv, (S * G + BR - 1) / BR);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(offs), static_cast<const int*>(tls),
      static_cast<const int*>(qls), static_cast<T*>(out), S, Hkv, G, ps,
      n_max, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// Element type: is_bf16 = 1 for bfloat16, 0 for float32; head dim 64 or
// 128.  Anything else returns cudaErrorInvalidValue without launching (the
// Python wrapper checks first).
extern "C" int paged_prefill_launch(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* page_tables,
                                    const void* q_offsets,
                                    const void* true_lens,
                                    const void* q_lens, void* out, int K,
                                    int S, int Hkv, int G, int D,
                                    int page_size, int n_max, int window,
                                    float scale, float softcap, int is_bf16,
                                    void* stream) {
  if (G < 1 || page_size < 1 || n_max < 1) return (int)cudaErrorInvalidValue;
  if (K == 0 || S == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, page_tables,
                                       q_offsets, true_lens, q_lens, out, K,
                                       S, Hkv, G, page_size, n_max, window,
                                       scale, softcap, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, page_tables,
                                        q_offsets, true_lens, q_lens, out, K,
                                        S, Hkv, G, page_size, n_max, window,
                                        scale, softcap, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k_pages, v_pages, page_tables, q_offsets,
                               true_lens, q_lens, out, K, S, Hkv, G,
                               page_size, n_max, window, scale, softcap, s);
    if (D == 128)
      return launch<float, 128>(q, k_pages, v_pages, page_tables, q_offsets,
                                true_lens, q_lens, out, K, S, Hkv, G,
                                page_size, n_max, window, scale, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
