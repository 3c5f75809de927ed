// Dense flash-decode for Hopper (sm_90a): one query token per sequence
// against its contiguous KV cache strip.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode (body
// _decode_kernel, online softmax in _online_softmax_step / _online_merge).
// Same function as its plain version (kernels/ref.py flash_decode): for
// sequence b and KV head h, the G query heads of the group attend to
// positions [max(0, len - window), len) of the sequence's (S, Hkv, D)
// strip, len read per lane from device memory; fp32 math, exp2-form
// online softmax with the NEG_INF / m_safe guards, optional logit softcap;
// a lane with len 0 comes out exactly 0.
//
// What bounds it on this card: bytes.  Each K/V position is read once and
// used by G query heads for 4*G*D FLOPs against 4*D bytes (bf16 K and V):
// about 4 FLOPs per byte at G = 4, far below the ~295 FLOP/byte where an
// H100 stops being memory bound.  The design therefore reads every visible
// position of the group exactly once from device memory into shared memory
// and lets all G query heads use it there (the TPU kernel's "G heads share
// one block read"), converting to fp32 on the load, and walks only the
// visible range: nothing at or past len, nothing left of the window.
//
// Grid: one block per (sequence, KV head), 128 threads.  The block walks
// its range in tiles of 64 positions.  Per tile: scores G x 64 in shared
// memory, one warp per query head for the max / sum reductions, then every
// thread updates its share of the G x D fp32 accumulators held in
// registers.  At the serving shape (8 sequences x 8 KV heads) that is 64
// blocks for 132 SMs, each a serial chain of tiles; splitting the sequence
// across blocks (split-KV, merged with the partial-softmax combine, as K2
// does in csrc/paged_decode.cu) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int TILE = 64;         // KV positions per tile
constexpr int GMAX = 16;         // most query heads per KV head
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dense_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ lens,
    T* __restrict__ out, int S, int Hkv, int G, int window, float scale,
    float softcap) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // G x D, pre-scaled
  float* k_s = q_s + G * D;             // TILE x (D + 1), padded rows
  float* v_s = k_s + TILE * (D + 1);    // TILE x D
  float* p_s = v_s + TILE * D;          // G x TILE scores, then weights
  float* a_s = p_s + G * TILE;          // G: per-row rescale, then 1 / l

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int L = lens[b];
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int hi = min(L, S);
  const size_t tok_stride = (size_t)Hkv * D;
  const T* kb = kc + (size_t)b * S * tok_stride + (size_t)h * D;
  const T* vb = vc + (size_t)b * S * tok_stride + (size_t)h * D;

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = to_f(qb[i]) * scale;

  constexpr int ACC = GMAX * D / NT;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  // row statistics: warp w owns query heads g = w, w + NWARP, ...
  constexpr int RPW = GMAX / NWARP;
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    m_run[k] = NEG_INF;
    l_run[k] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    __syncthreads();   // q_s written / previous tile fully consumed
    for (int i = tid; i < TILE * D; i += NT) {
      const int t = i / D, d = i - t * D;
      const int kpos = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (kpos < hi) {
        const size_t o = (size_t)kpos * tok_stride + d;
        kx = to_f(kb[o]);
        vx = to_f(vb[o]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * TILE; i += NT) {
      const int g = i / TILE, t = i - g * TILE;
      float s = NEG_INF;
      if (t0 + t < hi) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * (D + 1);
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        if (softcap > 0.f) a = softcap * tanhf(a / softcap);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int g = warp + k * NWARP;
      if (g < G) {
        float* pr = p_s + g * TILE;
        float mx = NEG_INF;
        for (int t = lane; t < TILE; t += 32) mx = fmaxf(mx, pr[t]);
        mx = warp_max(mx);
        const float m_new = fmaxf(m_run[k], mx);
        const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
        float sum = 0.f;
        for (int t = lane; t < TILE; t += 32) {
          const float p =
              t0 + t < hi ? exp2f((pr[t] - m_safe) * LOG2E) : 0.f;
          pr[t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        const float alpha = m_run[k] <= NEG_INF / 2
                                ? 0.f
                                : exp2f((m_run[k] - m_new) * LOG2E);
        l_run[k] = l_run[k] * alpha + sum;
        m_run[k] = m_new;
        if (lane == 0) a_s[g] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * NT;
      if (e < G * D) {
        const int g = e / D, d = e - g * D;
        const float* pr = p_s + g * TILE;
        float a = acc[i] * a_s[g];
#pragma unroll 8
        for (int t = 0; t < TILE; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
        acc[i] = a;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int g = warp + k * NWARP;
    if (g < G && lane == 0) a_s[g] = 1.f / fmaxf(l_run[k], 1e-20f);
  }
  __syncthreads();
  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * NT;
    if (e < G * D) ob[e] = from_f<T>(acc[i] * a_s[e / D]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* lens,
           void* out, int B, int S, int Hkv, int G, int window, float scale,
           float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)TILE * (D + 1) +
                       (size_t)TILE * D + (size_t)G * TILE + G);
  if (Hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kern = dense_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, Hkv), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(lens),
      static_cast<T*>(out), S, Hkv, G, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// Element type: is_bf16 = 1 for bfloat16, 0 for float32.  Head dim 64, 80
// (zamba2's shared attention block) or 128; at most 16 query heads per KV
// head.  Anything else returns cudaErrorInvalidValue without launching (the
// Python wrapper checks first).
extern "C" int dense_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache,
                                   const void* cache_len, void* out, int B,
                                   int S, int Hkv, int G, int D, int window,
                                   float scale, float softcap, int is_bf16,
                                   void* stream) {
  if (G < 1 || G > GMAX || S < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, cache_len, out,
                                       B, S, Hkv, G, window, scale, softcap,
                                       s);
    if (D == 80)
      return launch<__nv_bfloat16, 80>(q, k_cache, v_cache, cache_len, out,
                                       B, S, Hkv, G, window, scale, softcap,
                                       s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, cache_len, out,
                                        B, S, Hkv, G, window, scale, softcap,
                                        s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k_cache, v_cache, cache_len, out, B, S,
                               Hkv, G, window, scale, softcap, s);
    if (D == 80)
      return launch<float, 80>(q, k_cache, v_cache, cache_len, out, B, S,
                               Hkv, G, window, scale, softcap, s);
    if (D == 128)
      return launch<float, 128>(q, k_cache, v_cache, cache_len, out, B, S,
                                Hkv, G, window, scale, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
