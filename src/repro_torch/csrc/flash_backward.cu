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
// byte.  So the products have to run on the tensor cores.
//
// Two kernels, the TPU kernel's split, each writing its outputs once with
// no atomics, so the result is the same bits from run to run (remat and
// resume rely on it).  The price: both kernels compute s and dp, seven
// products per pair where five would do with an atomic dq (7/5 of the
// necessary operations).
//  * dq kernel: one block per (b, KV head, tile of 64 flattened query
//    rows, row r = s * G + g as K4 groups them).  It first computes the
//    tile's delta = rowsum(do . o) and writes it to a scratch (B, Sq, Hq)
//    buffer for the dk/dv kernel, then walks the KV tiles the mask leaves,
//    recomputes s, p, dp and ds, and accumulates dq.
//  * dk/dv kernel (launched after it on the same stream): one block per
//    (b, KV head, tile of 64 KV positions).  It walks the flattened query
//    rows that see the tile - all G heads of its KV head side by side - 32
//    at a time, recomputes p and ds transposed, and accumulates dk and dv.
//
// The C entry point dispatches on the dtype:
//  * bfloat16 runs on the tensor cores (csrc/mma_bf16.cuh): every product
//    is an mma.sync m16n8k16 bf16 tile with fp32 accumulators, one warp
//    per 16 rows of a 64-row block, three blocks an SM at head dim 64.
//    Tiles stay bf16 in shared memory, rows padded by 16 bytes so ldmatrix
//    meets no bank conflict, and arrive by cp.async into two buffers: the
//    load of the next K/V tile (dq kernel) or q/do tile (dk/dv kernel)
//    overlaps the products on this one.
//    The dq kernel takes s = q k^T and dp = do v^T with K and V as B as
//    they lie, computes ds on the accumulator fragments, rounds it to bf16
//    and feeds it straight back as the A operand of dq += ds k, K through
//    ldmatrix.trans.  It takes delta on the tensor cores too, as the
//    diagonal of do o^T: the same products as dp, so a row that attends
//    one key (o = v, ds = 0 in exact arithmetic) gets dp - delta = 0
//    exactly rather than fp32 rounding noise.
//    The dk/dv kernel takes s^T = k q^T and dp^T = v do^T with the KV rows
//    as M, so p^T and ds^T land in accumulator layout, rounds them to bf16
//    and feeds them as A to dv += p^T do and dk += ds^T q, do and q through
//    ldmatrix.trans; lse, delta and the query position of each query
//    column come from shared memory.
//    Both mask only a tile that crosses an edge, and the longest walks
//    start first (the last query tiles, the first KV tiles).  What still
//    bounds them: mma.sync issues per warp, synchronously, and every warp
//    reads its B fragments from shared memory for only 16 rows of A (wgmma
//    over a 64-row warpgroup would read each once), and the 7/5 recompute.
//  * float32 runs on the CUDA cores in fp32 FMAs, since the tensor cores'
//    fp32 input is TF32, which would miss the float32 bar of 1e-5: K4's
//    tiling with operands widened to fp32 in shared memory, register tiles
//    of accumulators, the work the mask removes cut before each loop.  It
//    is what the tight float32 checks run, not a fallback: a bf16 launch
//    that fails returns its error.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BR = 64;       // flattened query rows per tile
constexpr int TILE = 64;     // KV positions per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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
// float32 dq kernel: 128 threads = 8 row groups x 16 columns; each thread holds 8
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
// float32 dk/dv kernel: 256 threads = 16 KV-row groups x 16 columns; each thread
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

// ---------------------------------------------------------------------------
// bfloat16 kernels on the tensor cores: each warp owns 16 rows of its block
// (query rows in the dq kernel, KV rows in the dk/dv kernel).
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int NW = 4;            // warps per block
constexpr int NT_TC = 32 * NW;
constexpr int BM = 16 * NW;      // rows a block owns
constexpr int BN = 64;           // KV positions per tile of the dq kernel
constexpr int BQ = 32;           // query rows per tile of the dk/dv kernel
// blocks an SM holds at once: at head dim 64 ptxas keeps each kernel
// within 168 registers, so three blocks (12 warps) fit an SM - 12% faster
// at the training shape than two, with no spills
template <int D> constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;

template <int D>
__global__ void __launch_bounds__(NT_TC, MIN_BLOCKS<D>) dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Skv,
    int Hkv, int G, int causal, int window, float scale, float softcap) {
  using namespace mma_bf16;
  constexpr int LD = D + PAD, KS = D / 16, ND = D / 8, NC = BN / 8,
                CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BM x LD
  bf16* do_s = q_s + BM * LD;                       // BM x LD
  bf16* o_s = do_s + BM * LD;                       // BM x LD
  bf16* kv_s = o_s + BM * LD;                       // 2 x (K, V) x BN x LD

  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BM;   // diagonal tiles first
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int Hq = Hkv * G, R = Sq * G;
  const bool masked = causal || window > 0;
  const size_t tok = (size_t)Hkv * D;
  const bf16* kb = k + (size_t)b * Skv * tok + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Skv * tok + (size_t)h * D;
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BM, R) - 1) / G;
  const int kv_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int kv_hi = masked ? min(Skv, s_last + 1) : Skv;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;
  // (b, s, head) row of the flattened query row r = s * G + g
  auto row_of = [&](int r) -> size_t {
    const int s = r / G;
    return ((size_t)b * Sq + s) * Hq + (size_t)h * G + (r - s * G);
  };
  auto load_kv = [&](int t0, int stage) {
    bf16* ks = kv_s + stage * 2 * BN * LD;
    bf16* vs = ks + BN * LD;
    for (int i = tid; i < BN * CH; i += NT_TC) {
      const int rr = i / CH, c = i % CH, kpos = t0 + rr;
      const bool live = kpos < kv_hi;
      const size_t off = (size_t)(live ? kpos : kv_lo) * tok + c * 8;
      cp_async16(ks + rr * LD + c * 8, kb + off, live);
      cp_async16(vs + rr * LD + c * 8, vb + off, live);
    }
  };

  for (int i = tid; i < BM * CH; i += NT_TC) {
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const bool live = r < R;
    const size_t off = row_of(live ? r : r0) * D + c * 8;
    cp_async16(q_s + rr * LD + c * 8, q + off, live);
    cp_async16(do_s + rr * LD + c * 8, dout + off, live);
    cp_async16(o_s + rr * LD + c * 8, o + off, live);
  }
  if (n_tiles > 0) load_kv(kv_lo, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // delta = rowsum(do . o) on the tensor cores: the diagonal of this warp's
  // 16 x 16 block of do o^T, the same products in the same order as dp =
  // do v^T.  Where a row attends one key, o is that key's v, and dp - delta
  // comes out exactly 0, as in exact arithmetic, not as rounding noise.
  float dd[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t da[4], of[4];
    ldmatrix_x4(da, do_s + a_offset(lane, LD, wr, kk * 16));
    ldmatrix_x4(of, o_s + b_offset(lane, LD, wr, kk * 16));
    mma(dd[0], da, of[0], of[1]);
    mma(dd[1], da, of[2], of[3]);
  }
  // this lane's two rows: wr + g4 and wr + g4 + 8; lane 4 g + g / 2 holds
  // the diagonal entries of rows g (tile 0) and g + 8 (tile 1)
  int qpos[2];
  float lse_r[2], delta_r[2];
  const int diag = 4 * g4 + (g4 >> 1);
  delta_r[0] = __shfl_sync(0xffffffffu, g4 & 1 ? dd[0][1] : dd[0][0], diag);
  delta_r[1] = __shfl_sync(0xffffffffu, g4 & 1 ? dd[1][3] : dd[1][2], diag);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + wr + g4 + 8 * h2;
    qpos[h2] = r / G;
    lse_r[h2] = r < R ? lse[row_of(r)] : 0.f;
    if (r < R && t4 == 0) delta[row_of(r)] = delta_r[h2];
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = kv_lo + j * BN;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();   // tile j landed; every warp is done with j - 1
    }
    if (j + 1 < n_tiles) load_kv(t0 + BN, (j + 1) & 1);
    cp_async_commit();
    const bf16* ks = kv_s + (j & 1) * 2 * BN * LD;
    const bf16* vs = ks + BN * LD;

    // s = q k^T and dp = do v^T, 16 rows x BN keys per warp
    float sc[NC][4], dp[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, q_s + a_offset(lane, LD, wr, kk * 16));
      ldmatrix_x4(da, do_s + a_offset(lane, LD, wr, kk * 16));
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, ks + b_offset(lane, LD, np * 16, kk * 16));
        ldmatrix_x4(vf, vs + b_offset(lane, LD, np * 16, kk * 16));
        mma(sc[2 * np], qa, kf[0], kf[1]);
        mma(sc[2 * np + 1], qa, kf[2], kf[3]);
        mma(dp[2 * np], da, vf[0], vf[1]);
        mma(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }

    // ds on the fragments; the mask only where the tile crosses an edge
    const bool edge = !(t0 + BN <= kv_hi &&
                        (!masked || t0 + BN - 1 <= s_first) &&
                        (window <= 0 || t0 > s_last - window));
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = t0 + n * 8 + 2 * t4 + (e & 1), qp = qpos[e >> 1];
        const bool valid = !edge || (kpos < kv_hi &&
                                     (!masked || kpos <= qp) &&
                                     (window <= 0 || kpos > qp - window));
        float p, ds;
        p_and_ds(sc[n][e], dp[n][e], lse_r[e >> 1], delta_r[e >> 1], valid,
                 scale, softcap, &p, &ds);
        dp[n][e] = ds;
      }

    // dq += ds k: ds rounded to bf16 as the A operand, K through .trans
#pragma unroll
    for (int kk = 0; kk < NC / 2; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, dp, kk);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, ks + bt_offset(lane, LD, kk * 16, np * 16));
        mma(acc[2 * np], sa, kf[0], kf[1]);
        mma(acc[2 * np + 1], sa, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + wr + g4 + 8 * h2;
    if (r >= R) continue;
    bf16* out = dq + row_of(r) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * h2] * scale, acc[n][2 * h2 + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_TC, MIN_BLOCKS<D>) dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ lse,
    const bf16* __restrict__ dout, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hkv,
    int G, int causal, int window, float scale, float softcap) {
  using namespace mma_bf16;
  constexpr int LD = D + PAD, KS = D / 16, ND = D / 8, NQ = BQ / 8,
                CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // BM x LD
  bf16* v_s = k_s + BM * LD;                        // BM x LD
  bf16* qd_s = v_s + BM * LD;                       // 2 x (q, do) x BQ x LD
  float* lse_s = reinterpret_cast<float*>(qd_s + 4 * BQ * LD);   // 2 x BQ
  float* delta_s = lse_s + 2 * BQ;                                // 2 x BQ
  int* qpos_s = reinterpret_cast<int*>(delta_s + 2 * BQ);        // 2 x BQ

  const int b = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * BM;
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int Hq = Hkv * G;
  const bool masked = causal || window > 0;
  const size_t tok = (size_t)Hkv * D;
  const int kv_end = min(t0 + BM, Skv);
  // flattened query rows that see a key of this tile: [r_lo, r_hi)
  const int s_lo = masked ? min(t0, Sq) : 0;
  const int s_hi = window > 0 ? min(Sq, kv_end - 1 + window) : Sq;
  const int r_lo = s_lo * G, r_hi = s_hi * G;
  const int n_tiles = r_hi > r_lo ? (r_hi - r_lo + BQ - 1) / BQ : 0;
  auto row_of = [&](int r) -> size_t {
    const int s = r / G;
    return ((size_t)b * Sq + s) * Hq + (size_t)h * G + (r - s * G);
  };
  auto load_q = [&](int r0, int stage) {
    bf16* qs = qd_s + stage * 2 * BQ * LD;
    bf16* ds = qs + BQ * LD;
    for (int i = tid; i < BQ * CH; i += NT_TC) {
      const int rr = i / CH, c = i % CH, r = r0 + rr;
      const bool live = r < r_hi;
      const size_t off = row_of(live ? r : r_lo) * D + c * 8;
      cp_async16(qs + rr * LD + c * 8, q + off, live);
      cp_async16(ds + rr * LD + c * 8, dout + off, live);
    }
    if (tid < BQ) {
      const int r = r0 + tid;
      const bool live = r < r_hi;
      const size_t row = row_of(live ? r : r_lo);
      cp_async4(lse_s + stage * BQ + tid, lse + row, live);
      cp_async4(delta_s + stage * BQ + tid, delta + row, live);
      qpos_s[stage * BQ + tid] = r / G;
    }
  };

  for (int i = tid; i < BM * CH; i += NT_TC) {
    const int rr = i / CH, c = i % CH, kpos = t0 + rr;
    const bool live = kpos < kv_end;
    const size_t off =
        ((size_t)b * Skv + (live ? kpos : t0)) * tok + (size_t)h * D + c * 8;
    cp_async16(k_s + rr * LD + c * 8, k + off, live);
    cp_async16(v_s + rr * LD + c * 8, v + off, live);
  }
  if (n_tiles > 0) load_q(r_lo, 0);
  cp_async_commit();

  int kpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) kpos[h2] = t0 + wr + g4 + 8 * h2;
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int r0 = r_lo + j * BQ;
    cp_async_wait_all();
    __syncthreads();     // tile j landed; every warp is done with j - 1
    if (j + 1 < n_tiles) load_q(r0 + BQ, (j + 1) & 1);
    cp_async_commit();
    const bf16* qs = qd_s + (j & 1) * 2 * BQ * LD;
    const bf16* dos = qs + BQ * LD;
    const float* lses = lse_s + (j & 1) * BQ;
    const float* deltas = delta_s + (j & 1) * BQ;
    const int* qps = qpos_s + (j & 1) * BQ;

    // s^T = k q^T and dp^T = v do^T: 16 KV rows x BQ query columns a warp
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, k_s + a_offset(lane, LD, wr, kk * 16));
      ldmatrix_x4(va, v_s + a_offset(lane, LD, wr, kk * 16));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qf[4], df[4];
        ldmatrix_x4(qf, qs + b_offset(lane, LD, np * 16, kk * 16));
        ldmatrix_x4(df, dos + b_offset(lane, LD, np * 16, kk * 16));
        mma(st[2 * np], ka, qf[0], qf[1]);
        mma(st[2 * np + 1], ka, qf[2], qf[3]);
        mma(dpt[2 * np], va, df[0], df[1]);
        mma(dpt[2 * np + 1], va, df[2], df[3]);
      }
    }

    // p^T and ds^T on the fragments; the mask only at an edge
    const bool edge = !(t0 + BM <= Skv && r0 + BQ <= r_hi &&
                        (!masked || t0 + BM - 1 <= r0 / G) &&
                        (window <= 0 || t0 > (r0 + BQ - 1) / G - window));
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1), kp = kpos[e >> 1];
        bool valid = true;
        if (edge) {
          const int qp = qps[c];
          valid = r0 + c < r_hi && kp < kv_end && (!masked || kp <= qp) &&
                  (window <= 0 || kp > qp - window);
        }
        float p, ds;
        p_and_ds(st[n][e], dpt[n][e], lses[c], deltas[c], valid, scale,
                 softcap, &p, &ds);
        st[n][e] = p;
        dpt[n][e] = ds;
      }

    // dv += p^T do and dk += ds^T q: p^T, ds^T rounded to bf16 as A
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st, kk);
      acc_to_a(sa, dpt, kk);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t df[4], qf[4];
        ldmatrix_x4_trans(df, dos + bt_offset(lane, LD, kk * 16, np * 16));
        ldmatrix_x4_trans(qf, qs + bt_offset(lane, LD, kk * 16, np * 16));
        mma(acc_v[2 * np], pa, df[0], df[1]);
        mma(acc_v[2 * np + 1], pa, df[2], df[3]);
        mma(acc_k[2 * np], sa, qf[0], qf[1]);
        mma(acc_k[2 * np + 1], sa, qf[2], qf[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (kpos[h2] >= kv_end) continue;
    const size_t off = ((size_t)b * Skv + kpos[h2]) * tok + (size_t)h * D +
                       2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(acc_k[n][2 * h2] * scale,
                                acc_k[n][2 * h2 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(acc_v[n][2 * h2], acc_v[n][2 * h2 + 1]);
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

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* delta, int B, int Sq, int Skv, int Hkv, int G,
                int causal, int window, float scale, float softcap,
                cudaStream_t stream) {
  const long long q_tiles = ((long long)Sq * G + BM - 1) / BM;
  const long long kv_tiles = ((long long)Skv + BM - 1) / BM;
  if (q_tiles > 65535 || kv_tiles > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (!mma_bf16::aligned16({q, k, v, o, dout, dq, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  float* deltaf = static_cast<float*>(delta);
  const size_t row = sizeof(bf16) * (D + mma_bf16::PAD);
  cudaError_t err;
  // dq first: it writes delta, which the dk/dv kernel reads
  if (Sq > 0) {
    const size_t smem = row * (3 * BM + 4 * BN);
    auto kern = dq_bf16_kernel<D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(B, Hkv, (unsigned)q_tiles), NT_TC, smem, stream>>>(
        qt, kt, vt, static_cast<const bf16*>(o), lsef, dot,
        static_cast<bf16*>(dq), deltaf, Sq, Skv, Hkv, G, causal, window,
        scale, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Skv > 0) {
    const size_t smem = row * (2 * BM + 4 * BQ) + sizeof(float) * 6 * BQ;
    auto kern = dkv_bf16_kernel<D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(B, Hkv, (unsigned)kv_tiles), NT_TC, smem, stream>>>(
        qt, kt, vt, lsef, dot, deltaf, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Skv, Hkv, G, causal, window, scale,
        softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// C entry point bound through ctypes: the dq kernel, then the dk/dv kernel,
// on `stream`.  delta is a (B, Sq, Hq) float32 scratch buffer.  Returns a
// cudaError_t (0 = both launched).  Element type: is_bf16 = 1 for
// bfloat16 (the tensor-core kernels; every bf16 pointer 16-byte aligned,
// else cudaErrorMisalignedAddress), 0 for float32 (the CUDA-core kernels);
// lse and delta are always float32; head dim 64 or 128.  Anything else
// returns cudaErrorInvalidValue without launching (the Python wrapper
// checks first).
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
      return launch_bf16<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,
                             Skv, Hkv, G, causal, window, scale, softcap, s);
    if (D == 128)
      return launch_bf16<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                              Sq, Skv, Hkv, G, causal, window, scale,
                              softcap, s);
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
