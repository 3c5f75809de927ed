// FlashAttention-2 forward for Hopper (sm_90a) over contiguous K/V: the
// monolithic prefill of the serving path and Model.forward.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (body _fa_kernel).  Same function as its plain
// version (kernels/ref.py flash_attention): q (B, Sq, Hq, D) against k, v
// (B, Skv, Hkv, D) with GQA (query head j reads KV head j / G); scores
// (q . k) * scale in fp32, optional logit softcap; a causal mask aligned at
// the top left (k_pos <= q_pos, q_pos counted from 0 even when Sq != Skv);
// window > 0 keeps k_pos > q_pos - window and implies the causal mask;
// exp2-form online softmax with the NEG_INF / m_safe guards.  The weights
// are rounded to the input dtype before the PV product (the plain
// version's p.astype(q.dtype)); their row sum l is taken unrounded.  Beside
// o it writes lse = m + ln(max(l, 1e-20)) in fp32, (B, Sq, Hq), which the
// FA-2 backward will read.
//
// What bounds it on this card: operations.  A prompt of S tokens does
// about 4 * D * Hq * S^2 / 2 FLOPs causal against one read of q, K, V and
// one write of o, thousands of FLOPs per byte at S = 1904 - far above the
// ~295 FLOP/byte where an H100 stops being memory bound.  This first
// version does its products in fp32 on the CUDA cores (a tensor-core tile,
// mma.sync or wgmma, is a later PR's work); what it does about the bound is
// to reuse every operand many times from on-chip memory and to skip the
// work the mask removes.  It is K1's tile (csrc/paged_prefill.cu) with the
// block table replaced by contiguous addressing: a block holds 64 flattened
// query rows (row r = s * G + g, the G query heads of one KV head side by
// side, as the TPU kernel's GQA index map groups them) in shared memory,
// loads 64 KV positions at a time into shared memory, and each thread
// computes an 8 x 4 register tile of scores and an 8 x D/16 tile of the
// output accumulators.
//
// Grid: one block per (sequence b, KV head h, tile of 64 flattened query
// rows).  The KV range a block walks is cut before the loop: nothing past
// Skv, nothing past the tile's last query position when masked (above the
// diagonal), nothing left of the tile's first query position's window.
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
// a weight as the PV product takes it: rounded to the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Skv, int Hkv, int G, int causal, int window, float scale,
    float softcap) {
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // BR x (D + 1)
  float* k_s = q_s + BR * (D + 1);      // TILE x (D + 1)
  float* v_s = k_s + TILE * (D + 1);    // TILE x D
  float* p_s = v_s + TILE * D;          // BR x (TILE + 1)

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * BR;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int Hq = Hkv * G, R = Sq * G;
  const bool masked = causal || window > 0;
  const size_t tok_stride = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * Skv * tok_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * Skv * tok_stride + (size_t)h * D;

  // KV range of this block: query positions s_first .. s_last
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BR, R) - 1) / G;
  const int kv_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int kv_hi = masked ? min(Skv, s_last + 1) : Skv;

  for (int i = tid; i < BR * D; i += NT) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr;
    float x = 0.f;
    if (r < R) {
      const int s = r / G, g = r - s * G;
      x = to_f(q[(((size_t)b * Sq + s) * Hq + (size_t)h * G + g) * D + d]);
    }
    q_s[rr * (D + 1) + d] = x;
  }

  // this thread's rows: r0 + tr + 8 * i; their query positions
  int qpos[RI];
  bool rlive[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    qpos[i] = r / G;
    rlive[i] = r < R;
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
      float kx = 0.f, vx = 0.f;
      if (kpos < kv_hi) {
        const size_t o = (size_t)kpos * tok_stride + d;
        kx = to_f(kb[o]);
        vx = to_f(vb[o]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
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
        valid[c] = rlive[i] && kpos < kv_hi &&
                   (!masked || kpos <= qpos[i]) &&
                   (window <= 0 || kpos > qpos[i] - window);
        float s = sc[i][c] * scale;
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
        p_s[(tr + 8 * i) * (TILE + 1) + tc + 16 * c] = round_to<T>(p);
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
    if (!rlive[i]) continue;
    const int r = r0 + tr + 8 * i;
    const int s = r / G, g = r - s * G;
    const float l = fmaxf(l_run[i], 1e-20f);
    const float inv = 1.f / l;
    const size_t row = ((size_t)b * Sq + s) * Hq + (size_t)h * G + g;
    T* o = out + row * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tc + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tc == 0) lse[row] = m_run[i] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Skv, int Hkv, int G, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BR * (D + 1) + (size_t)TILE * (D + 1) +
                       (size_t)TILE * D + (size_t)BR * (TILE + 1));
  const long long tiles = ((long long)Sq * G + BR - 1) / BR;
  if (tiles > 65535 || Hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, Hkv, (unsigned)tiles);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, Hkv, G, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// Element type: is_bf16 = 1 for bfloat16, 0 for float32 (lse is always
// float32); head dim 64, 80 (zamba2's shared attention block) or 128.
// Anything else returns cudaErrorInvalidValue without launching (the Python
// wrapper checks first).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Skv, int Hkv, int G,
                                      int D, int causal, int window,
                                      float scale, float softcap,
                                      int is_bf16, void* stream) {
  if (G < 1 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, Sq, Skv, Hkv,
                                       G, causal, window, scale, softcap, s);
    if (D == 80)
      return launch<__nv_bfloat16, 80>(q, k, v, out, lse, B, Sq, Skv, Hkv,
                                       G, causal, window, scale, softcap, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, Sq, Skv, Hkv,
                                        G, causal, window, scale, softcap, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, out, lse, B, Sq, Skv, Hkv, G, causal,
                               window, scale, softcap, s);
    if (D == 80)
      return launch<float, 80>(q, k, v, out, lse, B, Sq, Skv, Hkv, G, causal,
                               window, scale, softcap, s);
    if (D == 128)
      return launch<float, 128>(q, k, v, out, lse, B, Sq, Skv, Hkv, G,
                                causal, window, scale, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
