// FlashAttention-2 backward for Hopper (sm_90a) over contiguous K/V: the
// attention gradient of the training path, the backward of
// csrc/flash_attention.cu (K4).
//
// Replaces the TPU kernels repro/kernels/flash_backward.py::
// flash_attention_bwd (bodies _dq_kernel and _dkv_kernel).  Same function as
// its plain version (kernels/ref.py flash_attention_bwd): from q, do, o
// (B, Sq, Hq, D), k, v (B, Skv, Hkv, D) and K4's lse (B, Sq, Hq, fp32,
// natural log) it recomputes, per (query, key) pair under the mask,
//   s = (q . k) * scale, under a softcap s = softcap * t, t = tanh(s / cap)
//   p = exp2((s - lse) * LOG2E)
//   dp = do . v,  ds = p * (dp - delta) [* (1 - t^2)]
// with delta = rowsum(do . o), and sums
//   dq = scale * sum_k ds k,  dk = scale * sum_q ds q,  dv = sum_q p do
// in fp32, dk and dv over the G query heads of each KV head (GQA: query
// head j reads KV head j / G).  Masks as K4: top-left causal (k_pos <=
// q_pos), window > 0 keeps k_pos > q_pos - window and implies causal.  p
// and ds are rounded to the input dtype before their products, as the plain
// version (the JAX oracle's pb / dsb) does; the TPU kernel keeps them fp32.
//
// What bounds it on this card: operations.  Five products of 2 * D FLOPs
// per (query head, attended key) pair against one read of q, k, v, o, do,
// lse and one write of dq, dk, dv: at the training shape (B 4, S 2048, 32 /
// 8 heads of 64, causal) ~1.7e11 FLOPs over ~170 MB, a thousand FLOPs per
// byte.  This first version does its products in fp32 on the CUDA cores (a
// tensor-core tile is a later PR's work), with K4's tiling: operands staged
// once per tile in shared memory and reused from there, register tiles of
// accumulators, and the work the mask removes cut before each loop.
//
// Two kernels, the TPU kernel's split, each writing its outputs once with
// no atomics, so the result is the same bits from run to run:
//  * dq kernel: one block per (b, KV head, tile of 64 flattened query rows,
//    row r = s * G + g as K4 groups them).  It first computes the tile's
//    delta = rowsum(do . o) and writes it to a scratch (B, Sq, Hq) buffer
//    for the dk/dv kernel, then walks the KV tiles the mask leaves,
//    recomputes s, p, dp and ds, and accumulates dq in registers.
//  * dk/dv kernel (launched after it on the same stream): one block per
//    (b, KV head, tile of 64 KV positions).  It walks the flattened query
//    rows that see the tile - all G heads of its KV head side by side -
//    recomputes p and ds transposed, and accumulates dk and dv in
//    registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;       // flattened query rows per tile
constexpr int TILE = 64;     // KV positions per tile
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
// a factor as the products take it: rounded to the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (p, ds) of one (query row, key) pair from its raw dot products
__device__ __forceinline__ void p_and_ds(float qk, float dp, float lse,
                                         float delta, bool valid, float scale,
                                         float softcap, float* p, float* ds) {
  float s = qk * scale, t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(s / softcap);
    s = softcap * t;
  }
  const float pp = valid ? exp2f((s - lse) * LOG2E) : 0.f;
  float d = pp * (dp - delta);
  if (softcap > 0.f) d *= 1.f - t * t;
  *p = pp;
  *ds = d;
}

// ---------------------------------------------------------------------------
// dq kernel: 128 threads = 8 row groups x 16 columns; each thread holds 8
// rows x 4 score columns and 8 rows x D/16 columns of dq.
// ---------------------------------------------------------------------------
constexpr int NT_Q = 128;
constexpr int RI = BR / 8;
constexpr int CI = TILE / 16;

template <typename T, int D>
__global__ void __launch_bounds__(NT_Q) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const float* __restrict__ lse,
    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
    int Sq, int Skv, int Hkv, int G, int causal, int window, float scale,
    float softcap) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                     // BR x (D + 1)
  float* do_s = q_s + BR * (D + 1);      // BR x (D + 1)
  float* k_s = do_s + BR * (D + 1);      // TILE x (D + 1)
  float* v_s = k_s + TILE * (D + 1);     // TILE x (D + 1)
  float* ds_s = v_s + TILE * (D + 1);    // BR x (TILE + 1)

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * BR;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int Hq = Hkv * G, R = Sq * G;
  const bool masked = causal || window > 0;
  const size_t tok_stride = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * Skv * tok_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * Skv * tok_stride + (size_t)h * D;

  const int s_first = r0 / G;
  const int s_last = (min(r0 + BR, R) - 1) / G;
  const int kv_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int kv_hi = masked ? min(Skv, s_last + 1) : Skv;

  for (int i = tid; i < BR * D; i += NT_Q) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr;
    float qx = 0.f, dx = 0.f;
    if (r < R) {
      const int s = r / G, g = r - s * G;
      const size_t idx = (((size_t)b * Sq + s) * Hq + (size_t)h * G + g) * D + d;
      qx = to_f(q[idx]);
      dx = to_f(dout[idx]);
    }
    q_s[rr * (D + 1) + d] = qx;
    do_s[rr * (D + 1) + d] = dx;
  }
  __syncthreads();

  int qpos[RI];
  bool rlive[RI];
  float lse_r[RI], delta_r[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int rr = tr + 8 * i, r = r0 + rr;
    const int s = r / G, g = r - s * G;
    const size_t row = ((size_t)b * Sq + s) * Hq + (size_t)h * G + g;
    qpos[i] = s;
    rlive[i] = r < R;
    // delta = rowsum(do . o): 16 lanes of a half-warp split the row
    float part = 0.f;
    if (rlive[i]) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
        part += do_s[rr * (D + 1) + tc + 16 * c] *
                to_f(o[row * D + tc + 16 * c]);
    }
    delta_r[i] = half_sum(part);
    lse_r[i] = rlive[i] ? lse[row] : 0.f;
    if (rlive[i] && tc == 0) delta[row] = delta_r[i];
  }

  float acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += TILE) {
    __syncthreads();   // previous tile fully consumed
    for (int i = tid; i < TILE * D; i += NT_Q) {
      const int t = i / D, d = i - t * D;
      const int kpos = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (kpos < kv_hi) {
        const size_t off = (size_t)kpos * tok_stride + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * (D + 1) + d] = vx;
    }
    __syncthreads();

    float sc[RI][CI], dp[RI][CI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CI; ++c) sc[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RI], dv[RI], kv[CI], vv[CI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = q_s[(tr + 8 * i) * (D + 1) + d];
        dv[i] = do_s[(tr + 8 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        kv[c] = k_s[(tc + 16 * c) * (D + 1) + d];
        vv[c] = v_s[(tc + 16 * c) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
          dp[i][c] = fmaf(dv[i], vv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const int kpos = t0 + tc + 16 * c;
        const bool valid = rlive[i] && kpos < kv_hi &&
                           (!masked || kpos <= qpos[i]) &&
                           (window <= 0 || kpos > qpos[i] - window);
        float p, ds;
        p_and_ds(sc[i][c], dp[i][c], lse_r[i], delta_r[i], valid, scale,
                 softcap, &p, &ds);
        ds_s[(tr + 8 * i) * (TILE + 1) + tc + 16 * c] = round_to<T>(ds);
      }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < TILE; ++t) {
      float kk[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = k_s[t * (D + 1) + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float d = ds_s[(tr + 8 * i) * (TILE + 1) + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(d, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (!rlive[i]) continue;
    const int r = r0 + tr + 8 * i;
    const int s = r / G, g = r - s * G;
    T* out = dq + (((size_t)b * Sq + s) * Hq + (size_t)h * G + g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[tc + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv kernel: 256 threads = 16 KV-row groups x 16 columns; each thread
// holds 4 KV rows x 4 query-row columns of the transposed scores and 4 KV
// rows x D/16 columns of dk and of dv.
// ---------------------------------------------------------------------------
constexpr int NT_KV = 256;
constexpr int KI = TILE / 16;
constexpr int QJ = BR / 16;

template <typename T, int D>
__global__ void __launch_bounds__(NT_KV) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const T* __restrict__ dout,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Skv, int Hkv, int G, int causal, int window, float scale,
    float softcap) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                     // TILE x (D + 1)
  float* v_s = k_s + TILE * (D + 1);     // TILE x (D + 1)
  float* q_s = v_s + TILE * (D + 1);     // BR x (D + 1)
  float* do_s = q_s + BR * (D + 1);      // BR x (D + 1)
  float* p_s = do_s + BR * (D + 1);      // TILE x (BR + 1)
  float* ds_s = p_s + TILE * (BR + 1);   // TILE x (BR + 1)
  float* lse_s = ds_s + TILE * (BR + 1); // BR
  float* delta_s = lse_s + BR;           // BR

  const int b = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * TILE;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int Hq = Hkv * G;
  const bool masked = causal || window > 0;
  const size_t tok_stride = (size_t)Hkv * D;
  const int kv_end = min(t0 + TILE, Skv);

  for (int i = tid; i < TILE * D; i += NT_KV) {
    const int t = i / D, d = i - t * D;
    const int kpos = t0 + t;
    float kx = 0.f, vx = 0.f;
    if (kpos < kv_end) {
      const size_t off = ((size_t)b * Skv + kpos) * tok_stride +
                         (size_t)h * D + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    k_s[t * (D + 1) + d] = kx;
    v_s[t * (D + 1) + d] = vx;
  }

  // query positions that see a key of this tile: [s_lo, s_hi)
  const int s_lo = masked ? min(t0, Sq) : 0;
  const int s_hi = window > 0 ? min(Sq, kv_end - 1 + window) : Sq;
  const int r_hi = s_hi * G;

  float acc_k[KI][DC], acc_v[KI][DC];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int r0 = s_lo * G; r0 < r_hi; r0 += BR) {
    __syncthreads();   // K/V staged / previous rows fully consumed
    for (int i = tid; i < BR * D; i += NT_KV) {
      const int rr = i / D, d = i - rr * D;
      const int r = r0 + rr;
      float qx = 0.f, dx = 0.f;
      if (r < r_hi) {
        const int s = r / G, g = r - s * G;
        const size_t idx =
            (((size_t)b * Sq + s) * Hq + (size_t)h * G + g) * D + d;
        qx = to_f(q[idx]);
        dx = to_f(dout[idx]);
      }
      q_s[rr * (D + 1) + d] = qx;
      do_s[rr * (D + 1) + d] = dx;
    }
    if (tid < BR) {
      const int r = r0 + tid;
      float l = 0.f, de = 0.f;
      if (r < r_hi) {
        const int s = r / G, g = r - s * G;
        const size_t row = ((size_t)b * Sq + s) * Hq + (size_t)h * G + g;
        l = lse[row];
        de = delta[row];
      }
      lse_s[tid] = l;
      delta_s[tid] = de;
    }
    __syncthreads();

    float sc[KI][QJ], dp[KI][QJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[KI], vv[KI], qq[QJ], dd[QJ];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kk[i] = k_s[(tr + 16 * i) * (D + 1) + d];
        vv[i] = v_s[(tr + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        qq[j] = q_s[(tc + 16 * j) * (D + 1) + d];
        dd[j] = do_s[(tc + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          sc[i][j] = fmaf(kk[i], qq[j], sc[i][j]);
          dp[i][j] = fmaf(vv[i], dd[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int kpos = t0 + tr + 16 * i;
        const int rr = tc + 16 * j, r = r0 + rr;
        const int s = r / G;
        const bool valid = r < r_hi && kpos < kv_end &&
                           (!masked || kpos <= s) &&
                           (window <= 0 || kpos > s - window);
        float p, ds;
        p_and_ds(sc[i][j], dp[i][j], lse_s[rr], delta_s[rr], valid, scale,
                 softcap, &p, &ds);
        p_s[(tr + 16 * i) * (BR + 1) + rr] = round_to<T>(p);
        ds_s[(tr + 16 * i) * (BR + 1) + rr] = round_to<T>(ds);
      }
    __syncthreads();

#pragma unroll 2
    for (int rr = 0; rr < BR; ++rr) {
      float qv[DC], dov[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = q_s[rr * (D + 1) + tc + 16 * c];
        dov[c] = do_s[rr * (D + 1) + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const float p = p_s[(tr + 16 * i) * (BR + 1) + rr];
        const float ds = ds_s[(tr + 16 * i) * (BR + 1) + rr];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[i][c] = fmaf(p, dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds, qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kpos = t0 + tr + 16 * i;
    if (kpos >= kv_end) continue;
    const size_t off = ((size_t)b * Skv + kpos) * tok_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tc + 16 * c] = from_f<T>(acc_k[i][c] * scale);
      dv[off + tc + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int Sq, int Skv, int Hkv, int G, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  const long long q_tiles = ((long long)Sq * G + BR - 1) / BR;
  const long long kv_tiles = ((long long)Skv + TILE - 1) / TILE;
  if (q_tiles > 65535 || kv_tiles > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  float* deltaf = static_cast<float*>(delta);
  cudaError_t err;
  // dq first: it writes delta, which the dk/dv kernel reads
  if (Sq > 0) {
    const size_t smem = sizeof(float) * (2 * (size_t)BR * (D + 1) +
                                         2 * (size_t)TILE * (D + 1) +
                                         (size_t)BR * (TILE + 1));
    auto kern = flash_bwd_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(B, Hkv, (unsigned)q_tiles), NT_Q, smem, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), lsef, dot, static_cast<T*>(dq),
        deltaf, Sq, Skv, Hkv, G, causal, window, scale, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Skv > 0) {
    const size_t smem = sizeof(float) * (2 * (size_t)TILE * (D + 1) +
                                         2 * (size_t)BR * (D + 1) +
                                         2 * (size_t)TILE * (BR + 1) + 2 * BR);
    auto kern = flash_bwd_dkv_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(B, Hkv, (unsigned)kv_tiles), NT_KV, smem, stream>>>(
        qt, kt, vt, lsef, dot, deltaf, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, Hkv, G, causal, window, scale, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// C entry point bound through ctypes: the dq kernel, then the dk/dv kernel,
// on `stream`.  delta is a (B, Sq, Hq) float32 scratch buffer.  Returns a
// cudaError_t (0 = both launched).  Element type: is_bf16 = 1 for
// bfloat16, 0 for float32 (lse and delta are always float32); head dim 64
// or 128.  Anything else returns cudaErrorInvalidValue without launching
// (the Python wrapper checks first).
extern "C" int flash_backward_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     void* dq, void* dk, void* dv,
                                     void* delta, int B, int Sq, int Skv,
                                     int Hkv, int G, int D, int causal,
                                     int window, float scale, float softcap,
                                     int is_bf16, void* stream) {
  if (G < 1 || Sq < 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, dout, dq, dk, dv,
                                       delta, B, Sq, Skv, Hkv, G, causal,
                                       window, scale, softcap, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, dout, dq, dk, dv,
                                        delta, B, Sq, Skv, Hkv, G, causal,
                                        window, scale, softcap, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                               Sq, Skv, Hkv, G, causal, window, scale,
                               softcap, s);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                                Sq, Skv, Hkv, G, causal, window, scale,
                                softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
