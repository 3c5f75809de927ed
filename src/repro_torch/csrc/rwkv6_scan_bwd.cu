// RWKV6 (Finch) WKV scan backward for Hopper (sm_90a): the gradient of K7
// (csrc/rwkv6_scan.cu) on the training path of the ssm family.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward for the
// scan (src/repro/kernels/rwkv6_scan.py:83 rwkv6_scan is forward only) and
// differentiates its plain chunked scan instead (src/repro/kernels/ops.py
// rwkv6_scan off the TPU).  This kernel computes that gradient, the same
// function as its plain version (kernels/ref.py rwkv6_scan_bwd:
// torch.autograd.grad through rwkv6_scan_chunked).  For sequence b and
// head h, with S_t = diag(w_t) S_{t-1} + k_t^T v_t (K x V, fp32, S_{-1} =
// 0), y_t = r_t (S_{t-1} + diag(u) k_t^T v_t), and the adjoint G_t =
// dL/dS_t, G_{t-1} = diag(w_t) G_t + r_t^T dy_t (G_{S-1} = 0):
//
//   dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)     dw_t = diag(S_{t-1} G_t^T)
//   dk_t = G_t v_t + r_t u (v_t . dy_t)          du   = sum_{b,t} r k (v . dy)
//   dv_t = G_t^T k_t + (r_t u . k_t) dy_t
//
// r, k, v, dy (and dr, dk, dv) in float32 or bfloat16, w, u (dw, du)
// float32; every sum in float32, each output rounded once.  The recurrence
// multiplies by w and never exponentiates, so every factor stays in [0, 1]
// for any w in (0, 1]: nothing overflows, unlike the chunked form's
// e^{-cw} (the JAX _rwkv6_chunked's 32-step chunks rely on the model's
// clip of w >= 0.12).
//
// The recurrence on the CUDA cores, three launches (one launch count):
//  1. grid (block of ROWS = 16 key channels, head, sequence), ROWS x V / 4
//     threads, each holding EPT = 4 state elements (one key channel, four
//     value columns) in registers.  It walks the sequence forward, saving
//     the state at every TS = 16th step to fp32 scratch (ckpt), then
//     backward, 16 steps at a time: the stretch's states recomputed from
//     its saved one into registers, then the steps in reverse with G in
//     registers.  Sums over a key channel's value columns (dr, dk, dw) go
//     through shared memory once a stretch; the sum over the block's key
//     channels (dv) is a reduce-scatter over the half-warp
//     (csrc/scan_bwd.cuh), written as per-key-block partials to fp32
//     scratch, and du's sum over the sequence as per-sequence partials.
//  2. dv: the K / 16 key blocks' partials summed in a fixed order.
//  3. du: the B sequences' partials summed in a fixed order.
// No atomics, so every run gives the same bits.
//
// What bounds it: at rwkv6's training shape (B 4, S 2048, H 32, K = V =
// 64, bf16) the function must move ~369 MB (~110 us at 3.35 TB/s): r, k,
// v and dy read and dr, dk, dv written in bf16, w read and dw written in
// float32 - and the recurrence does ~17 GFLOP (launch/cost.py
// k7_bwd_work), bytes first.
// This first kernel also writes and reads ~0.27 GB of saved states and
// ~0.27 GB of dv partials, and walks 2048 steps in order in every block:
// the serial chain holds it (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scan_bwd;

constexpr int ROWS = 16;   // key channels (state rows) a block owns
constexpr int EPT = 4;     // value columns a thread owns
constexpr int TS = 16;     // steps between saved states: a stretch
constexpr int NT_RED = 256;

template <typename T, int V>
__global__ void __launch_bounds__(ROWS * V / EPT) rwkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const T* __restrict__ dy, T* __restrict__ dr, T* __restrict__ dk,
    float* __restrict__ dw, float* __restrict__ ckpt,
    float* __restrict__ part_v, float* __restrict__ part_u, int S, int H,
    int K) {
  constexpr int LANES = V / EPT, NT = ROWS * LANES, LH = LANES / 2;
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;                    // TS x V
  float* dy_s = v_s + TS * V;           // TS x V
  float* r_s = dy_s + TS * V;           // TS x ROWS
  float* k_s = r_s + TS * ROWS;         // TS x ROWS
  float* w_s = k_s + TS * ROWS;         // TS x ROWS
  float* vdy_s = w_s + TS * ROWS;       // TS: v_t . dy_t
  float* rr_s = vdy_s + TS;             // TS x LH x ROWS: S_{t-1} dy
  float* rk_s = rr_s + TS * LH * ROWS;  // TS x LH x ROWS: G v
  float* rw_s = rk_s + TS * LH * ROWS;  // TS x LH x ROWS: S_{t-1} . G
  float* du_s = rw_s + TS * LH * ROWS;  // NT

  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nkb = gridDim.x;
  const int tid = threadIdx.x, row = tid % ROWS, lane = tid / ROWS;
  const int n0 = lane * EPT, k0 = kb * ROWS;
  const int nck = (S + TS - 1) / TS;
  float* ck = ckpt + ((((size_t)b * H + h) * nkb + kb) * nck) * (NT * EPT);

  // a stretch's inputs into shared memory, zero past its tn steps (and w
  // 1 there: a no-op step)
  auto load = [&](int t0, int tn, bool back) {
    for (int i = tid; i < TS * V; i += NT) {
      const int j = i / V, c = i - j * V;
      const bool live = j < tn;
      const size_t o = (((size_t)b * S + t0 + j) * H + h) * V + c;
      v_s[i] = live ? ld(v, o) : 0.f;
      if (back) dy_s[i] = live ? ld(dy, o) : 0.f;
    }
    for (int i = tid; i < TS * ROWS; i += NT) {
      const int j = i / ROWS, q = i - j * ROWS;
      const bool live = j < tn;
      const size_t o = (((size_t)b * S + t0 + j) * H + h) * K + k0 + q;
      k_s[i] = live ? ld(k, o) : 0.f;
      w_s[i] = live ? w[o] : 1.f;
      if (back) r_s[i] = live ? ld(r, o) : 0.f;
    }
  };

  // 1. forward: the state at the start of every stretch
  float sv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) sv[e] = 0.f;
  for (int c = 0; c < nck; ++c) {
    const int t0 = c * TS, tn = min(TS, S - t0);
#pragma unroll
    for (int e = 0; e < EPT; ++e) ck[((size_t)c * EPT + e) * NT + tid] = sv[e];
    if (c == nck - 1) break;
    __syncthreads();   // the previous stretch is consumed
    load(t0, tn, false);
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const float ww = w_s[j * ROWS + row], kk = k_s[j * ROWS + row];
      const float4 vq = *reinterpret_cast<const float4*>(v_s + j * V + n0);
      sv[0] = fmaf(sv[0], ww, kk * vq.x);
      sv[1] = fmaf(sv[1], ww, kk * vq.y);
      sv[2] = fmaf(sv[2], ww, kk * vq.z);
      sv[3] = fmaf(sv[3], ww, kk * vq.w);
    }
  }

  // 2. backward, a stretch at a time from the last
  const float u_r = u[(size_t)h * K + k0 + row];
  float G[EPT];      // dL/dS_t, carried into step t
  float du_acc = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) G[e] = 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * TS, tn = min(TS, S - t0);
    __syncthreads();   // the previous stretch and its sums are consumed
    load(t0, tn, true);
    float hist[TS][EPT];   // S_{t0 - 1 + j}
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      hist[0][e] = ck[((size_t)c * EPT + e) * NT + tid];
    __syncthreads();
    for (int j = tid; j < TS; j += NT) {
      float s = 0.f;
      for (int q = 0; q < V; ++q) s = fmaf(v_s[j * V + q], dy_s[j * V + q], s);
      vdy_s[j] = s;
    }
#pragma unroll
    for (int j = 0; j + 1 < TS; ++j) {   // past tn: w 1, k 0, a copy
      const float ww = w_s[j * ROWS + row], kk = k_s[j * ROWS + row];
      const float4 vq = *reinterpret_cast<const float4*>(v_s + j * V + n0);
      hist[j + 1][0] = fmaf(hist[j][0], ww, kk * vq.x);
      hist[j + 1][1] = fmaf(hist[j][1], ww, kk * vq.y);
      hist[j + 1][2] = fmaf(hist[j][2], ww, kk * vq.z);
      hist[j + 1][3] = fmaf(hist[j][3], ww, kk * vq.w);
    }
    __syncthreads();   // vdy_s
#pragma unroll
    for (int j = TS - 1; j >= 0; --j) {
      if (j >= tn) continue;   // the same for the whole block
      const int t = t0 + j;
      const float rr = r_s[j * ROWS + row], kk = k_s[j * ROWS + row];
      const float ww = w_s[j * ROWS + row], ru = rr * u_r;
      const float4 vq = *reinterpret_cast<const float4*>(v_s + j * V + n0);
      const float4 dq = *reinterpret_cast<const float4*>(dy_s + j * V + n0);
      const float vv[EPT] = {vq.x, vq.y, vq.z, vq.w};
      const float dd[EPT] = {dq.x, dq.y, dq.z, dq.w};
      float part[EPT], sr = 0.f, sk = 0.f, sw = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        sr = fmaf(hist[j][e], dd[e], sr);
        sk = fmaf(G[e], vv[e], sk);
        sw = fmaf(hist[j][e], G[e], sw);
        part[e] = kk * fmaf(ru, dd[e], G[e]);   // dv terms
        G[e] = fmaf(ww, G[e], rr * dd[e]);      // G_{t-1}
      }
      const float tot = rows_sum<EPT>(part, row);
      if (rows_writer<EPT>(row))
        part_v[((((size_t)b * S + t) * H + h) * nkb + kb) * V + n0 +
               rows_index<EPT>(row)] = tot;
      sr += __shfl_xor_sync(FULL, sr, 16);   // the warp's two lanes
      sk += __shfl_xor_sync(FULL, sk, 16);
      sw += __shfl_xor_sync(FULL, sw, 16);
      if ((lane & 1) == 0) {
        const int o = (j * LH + lane / 2) * ROWS + row;
        rr_s[o] = sr;
        rk_s[o] = sk;
        rw_s[o] = sw;
      }
    }
    __syncthreads();
    // per (step, key channel): the sums over its value columns
    for (int i = tid; i < TS * ROWS; i += NT) {
      const int j = i / ROWS, q = i - j * ROWS;
      if (j >= tn) continue;
      float sr = 0.f, sk = 0.f, sw = 0.f;
#pragma unroll
      for (int l = 0; l < LH; ++l) {
        const int o = (j * LH + l) * ROWS + q;
        sr += rr_s[o];
        sk += rk_s[o];
        sw += rw_s[o];
      }
      const float rq = r_s[j * ROWS + q], kq = k_s[j * ROWS + q];
      const float uq = u[(size_t)h * K + k0 + q], vdy = vdy_s[j];
      const size_t o = (((size_t)b * S + t0 + j) * H + h) * K + k0 + q;
      st(dr, o, fmaf(uq * kq, vdy, sr));
      st(dk, o, fmaf(rq * uq, vdy, sk));
      dw[o] = sw;
      du_acc = fmaf(rq * kq, vdy, du_acc);
    }
  }
  // du's partial for this sequence: each thread's steps of key channel
  // tid % 16, summed over the threads in a fixed order
  du_s[tid] = du_acc;
  __syncthreads();
  if (tid < ROWS) {
    float s = 0.f;
    for (int i = tid; i < min(NT, TS * ROWS); i += ROWS) s += du_s[i];
    part_u[((size_t)b * H + h) * K + k0 + tid] = s;
  }
}

// dv: the key blocks' partials of every (b, t, h, column), fixed order
template <typename T>
__global__ void __launch_bounds__(NT_RED) rwkv6_bwd_dv_kernel(
    const float* __restrict__ part_v, T* __restrict__ dv, size_t n, int V,
    int nkb) {
  for (size_t i = (size_t)blockIdx.x * NT_RED + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NT_RED) {
    const size_t bth = i / V, c = i - bth * V;
    float s = 0.f;
    for (int q = 0; q < nkb; ++q) s += part_v[(bth * nkb + q) * V + c];
    st(dv, i, s);
  }
}

// du[h, k]: the sequences' partials, fixed order
__global__ void __launch_bounds__(NT_RED) rwkv6_bwd_du_kernel(
    const float* __restrict__ part_u, float* __restrict__ du, int B,
    int HK) {
  const int i = blockIdx.x * NT_RED + threadIdx.x;
  if (i >= HK) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part_u[(size_t)b * HK + i];
  du[i] = s;
}

template <typename T, int V>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* dr, void* dk, void* dv,
           void* dw, void* du, void* ckpt, void* part_v, void* part_u,
           int B, int S, int H, int K, cudaStream_t stream) {
  constexpr int NT = ROWS * V / EPT, LH = V / EPT / 2;
  const int nkb = K / ROWS;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (2 * TS * V + 3 * TS * ROWS + TS +
                                       3 * TS * LH * ROWS + NT);
  auto k1 = rwkv6_bwd_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3(nkb, H, B), NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dy),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<float*>(dw),
      static_cast<float*>(ckpt), static_cast<float*>(part_v),
      static_cast<float*>(part_u), S, H, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * S * H * V;
  size_t blocks = (n + NT_RED - 1) / NT_RED;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past 16 an SM
  rwkv6_bwd_dv_kernel<T><<<(unsigned)blocks, NT_RED, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<T*>(dv), n, V, nkb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_du_kernel<<<(H * K + NT_RED - 1) / NT_RED, NT_RED, 0, stream>>>(
      static_cast<const float*>(part_u), static_cast<float*>(du), B, H * K);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes: the three launches above on
// `stream`.  Returns a cudaError_t (0 = launched).  r, k, v, dy, dr, dk,
// dv: is_bf16 = 1 for bfloat16, 0 for float32; w, u, dw, du float32.
// Scratch, float32 from the caller's allocator, with nck = ceil(S / 16):
// ckpt B * H * nck * K * V, part_v B * S * H * (K / 16) * V, part_u B * H
// * K elements.  Key size K 16, 32 or 64, value size V 16, 32 or 64;
// anything else returns cudaErrorInvalidValue without launching (the
// Python wrapper checks first).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dy, void* dr, void* dk, void* dv, void* dw,
    void* du, void* ckpt, void* part_v, void* part_u, int B, int S, int H,
    int K, int V, int is_bf16, void* stream) {
  if (B < 0 || S < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (K != 16 && K != 32 && K != 64) return (int)cudaErrorInvalidValue;
  if (V != 16 && V != 32 && V != 64) return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0)   // no step: du is 0, every other gradient empty
    return (int)cudaMemsetAsync(du, 0, (size_t)H * K * sizeof(float), s);
#define RWKV6_BWD_CASE(VV)                                                  \
  case VV:                                                                  \
    return is_bf16                                                          \
               ? launch<bf16, VV>(r, k, v, w, u, dy, dr, dk, dv, dw, du,    \
                                  ckpt, part_v, part_u, B, S, H, K, s)      \
               : launch<float, VV>(r, k, v, w, u, dy, dr, dk, dv, dw, du,   \
                                   ckpt, part_v, part_u, B, S, H, K, s)
  switch (V) {
    RWKV6_BWD_CASE(16);
    RWKV6_BWD_CASE(32);
    RWKV6_BWD_CASE(64);
  }
#undef RWKV6_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
