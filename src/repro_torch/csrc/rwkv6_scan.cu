// RWKV6 (Finch) WKV scan for Hopper (sm_90a): the time-mix recurrence of
// every RWKV6 layer of Model.forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:83 rwkv6_scan
// (body _wkv_kernel).  Same function as its plain version (kernels/ref.py
// rwkv6_scan_chunked): for sequence b and head h, with a (K, V) float32
// state S_0 = 0,
//
//   y_t = r_t (S_{t-1} + diag(u_h) k_t^T v_t),   S_t = diag(w_t) S_{t-1}
//                                                      + k_t^T v_t
//
// r, k (B, S, H, K) and v (B, S, H, V) in float32 or bfloat16, the decay
// w (B, S, H, K) in (0, 1] and the bonus u (H, K) float32 (never rounded:
// a rounded w would shift every decay), y (B, S, H, V) in r's dtype, all
// sums in float32.
//
// bfloat16: the chunked matrix form on the tensor cores.  The TPU kernel
// walks 32-step chunks in order with the (K, V) state in scratch and forms
// its intra-chunk weights as (r e^{cw_{t-1}}) . (k e^{-cw}), cw the
// cumulative log decay - a factor e^{-cw} that reaches 2.6e29 at the
// model's clamp and overflows float32 below it.  Here the chunk is T = 64
// steps, and every decay is a product of w over a span that starts after
// its own left end: a prefix or suffix product inside a 16-step sub-chunk
// (or 8-step segment), times whole sub-chunks' (segments') products - an
// e^{difference of cw}, never above 1, formed without an exp (the plain
// form kernels/ref.py rwkv6_scan_chunk_parallel writes the same weights as
// exps of cw differences).  Two launches, one launch count, whose code is
// csrc/rwkv6_chunk.cuh (K7_bwd runs both on the reversed sequence):
//
//  1. state scan, grid (16 key channels x 64 value columns, head,
//     sequence), serial over the chunks only, two chunks a step: per chunk
//     its contribution dS = k_out^T v, k_out_s = k_s e^{cw_last - cw_s}, a
//     (16 x T) . (T x 64) product on the tensor cores, and S_c =
//     diag(e^{cw_last}) S_{c-1} + dS with S in fp32 registers - 16 steps
//     of a (16, 64) slice of the state at rwkv6's shape in place of 2048.
//     The key channels are rows of S that never mix, so splitting them
//     over blocks costs nothing: 256 blocks at rwkv6's shape.  Each
//     chunk's carry-in S_{c-1} goes to scratch as two bf16 parts.
//  2. output, grid (chunk, head, sequence), every chunk in parallel, two
//     warps on each 16-step sub-chunk i (the secondary chunking of GLA,
//     arXiv:2312.06635):
//       y_t = (r_t e^{cw_{t-1}}) S_{c-1}                        carry-in
//           + sum_{j<i} [(r_t e^{cw_{t-1} - b_i}) . (k_s e^{b_i - cw_s})]
//                       v_s                        between sub-chunks
//           + sum_{s in i, s<t} D[t, s] v_s + (r_t u . k_t) v_t   inside,
//     b_i the cw just before sub-chunk i, D[t, s] = sum_c r_tc k_sc
//     prod_{m=s+1}^{t-1} w_mc as running products on the CUDA cores (with
//     the bonus on its diagonal), everything else on the tensor cores.
//
// The products run on mma.sync m16n8k16 bf16 tiles with fp32 accumulators
// (csrc/mma_bf16.cuh).  r, k and v are bf16 inputs, so a product with one
// of them on one side is exact; the fp32 operands - the decayed r and k,
// the weights of the products between and inside sub-chunks, the carry-in
// S and k_out - enter as two bf16 parts (hi, then bf16 of the exact
// remainder: ~2^-16 of the operand; fp32 x fp32 products as hi.hi + hi.lo
// + lo.hi), which keeps the result within 1e-6 of the largest term past
// the output's rounding, 10x inside the card bar (tests/
// test_torch_rwkv6_parts.py, which also shows that one part of any of the
// six misses it).  Value heads wider than 64 are walked in blocks of 64 columns.
// Each output element is one fixed chain of operations (no atomics), so
// every run gives the same bits.
//
// What bounds it: at rwkv6's forward shape (B 2, S 2048, H 32, K = V = 64)
// the function must move ~101 MB - r, k, v and y in bf16, w in float32 -
// ~30.0 us at 3.35 TB/s; the chunked form's products are ~3.2 GFLOP (~3 us
// at 989 TFLOP/s), ~8 GFLOP of mma.sync with the parts and the padding of
// the tiles.  So bytes bound it.  The design adds ~34 MB of carry-in
// states (written once, read once: half what 32-step chunks would need),
// and launch 1 reads k, v and w once more.  On the card neither bound is
// what holds it (PERF.md, by launch): launch 2 runs its loads and its
// compute one after the other (two blocks of ~108 KB of shared memory an
// SM), launch 1 is a latency-bound chain of small products.
//
// float32 keeps the recurrence on the CUDA cores (TF32 products would miss
// the 1e-5 float32 bar): a block owns COLS state columns of one (b, h) and
// walks the whole sequence with them in registers, LANES = K / EPT threads
// sharing a column, each holding EPT = 8 state elements, reducing y_t[v] =
// sum_k r_t[k] S[k, v] with warp shuffles; grid (ceil(V / COLS), H, B).
// The sequence is walked in stages of TC = 32 steps loaded into shared
// memory; the diagonal term is the scalar (r_t u . k_t) times v_t.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "rwkv6_chunk.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

// ---------------------------------------------------------------------------
// float32: the recurrence on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT_F32 = 64;  // threads per block
constexpr int NWARP = NT_F32 / 32;
constexpr int EPT = 8;      // state elements per thread
constexpr int TC = 32;      // time steps per shared-memory stage

template <int K>
__global__ void __launch_bounds__(NT_F32) rwkv6_scan_f32_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ y, int S, int H,
    int V) {
  constexpr int LANES = K / EPT;      // threads per state column
  constexpr int COLS = NT_F32 / LANES;  // state columns per block
  __shared__ __align__(16) float r_s[TC * K];
  __shared__ __align__(16) float k_s[TC * K];
  __shared__ __align__(16) float w_s[TC * K];
  __shared__ float v_s[TC * COLS];
  __shared__ float y_s[TC * COLS];
  __shared__ float d_s[TC];           // r_t u . k_t

  const int c0 = blockIdx.x * COLS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int col = tid / LANES, lane = tid - col * LANES;
  const float* uh = u + (size_t)h * K;
  float st[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) st[j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tn = min(TC, S - t0);
    __syncthreads();   // the previous stage is consumed and stored
    for (int i = tid; i < tn * K; i += NT_F32) {
      const int t = i / K, c = i - t * K;
      const size_t o = (((size_t)b * S + t0 + t) * H + h) * K + c;
      r_s[i] = r[o];
      k_s[i] = k[o];
      w_s[i] = w[o];
    }
    for (int i = tid; i < tn * COLS; i += NT_F32) {
      const int t = i / COLS, c = i - t * COLS;
      const int vc = c0 + c;
      const size_t o = (((size_t)b * S + t0 + t) * H + h) * V + vc;
      v_s[i] = vc < V ? v[o] : 0.f;
    }
    __syncthreads();
    // the diagonal scalars: one warp per step, lanes over K
    for (int t = warp; t < tn; t += NWARP) {
      float s = 0.f;
      for (int c = wl; c < K; c += 32)
        s = fmaf(r_s[t * K + c] * uh[c], k_s[t * K + c], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (wl == 0) d_s[t] = s;
    }
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < tn; ++t) {
      const float vv = v_s[t * COLS + col];
      const float4* rv = reinterpret_cast<const float4*>(
          r_s + t * K + lane * EPT);
      const float4* kv = reinterpret_cast<const float4*>(
          k_s + t * K + lane * EPT);
      const float4* wv = reinterpret_cast<const float4*>(
          w_s + t * K + lane * EPT);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < EPT / 4; ++q) {
        const float4 rq = rv[q], kq = kv[q], wq = wv[q];
        acc[0] = fmaf(rq.x, st[4 * q + 0], acc[0]);
        acc[1] = fmaf(rq.y, st[4 * q + 1], acc[1]);
        acc[2] = fmaf(rq.z, st[4 * q + 2], acc[2]);
        acc[3] = fmaf(rq.w, st[4 * q + 3], acc[3]);
        st[4 * q + 0] = fmaf(st[4 * q + 0], wq.x, kq.x * vv);
        st[4 * q + 1] = fmaf(st[4 * q + 1], wq.y, kq.y * vv);
        st[4 * q + 2] = fmaf(st[4 * q + 2], wq.z, kq.z * vv);
        st[4 * q + 3] = fmaf(st[4 * q + 3], wq.w, kq.w * vv);
      }
      float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) y_s[t * COLS + col] = fmaf(d_s[t], vv, s);
    }
    __syncthreads();
    for (int i = tid; i < tn * COLS; i += NT_F32) {
      const int t = i / COLS, c = i - t * COLS;
      const int vc = c0 + c;
      if (vc < V) y[(((size_t)b * S + t0 + t) * H + h) * V + vc] = y_s[i];
    }
  }
}

template <int K>
int launch_f32(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* y, int B, int S, int H, int V,
               cudaStream_t stream) {
  constexpr int COLS = NT_F32 / (K / EPT);
  const dim3 grid((V + COLS - 1) / COLS, H, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  rwkv6_scan_f32_kernel<K><<<grid, NT_F32, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y), S, H, V);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the chunk-parallel form on the tensor cores (csrc/rwkv6_chunk.cuh)
// ---------------------------------------------------------------------------

namespace rc = rwkv6_chunk;

// Launch 1, the state scan: grid ((K / 16) x ceil(V / 64), H, B),
// rwkv6_chunk.cuh state_scan - each chunk's carry-in S_{c-1} to scratch as
// two bf16 parts.
__global__ void __launch_bounds__(rc::NT1) rwkv6_scan_state_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, bf16* __restrict__ sparts, int S, int H,
    int K, int V, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rc::state_scan<false>(k, v, w, sparts, S, H, K, V, vec, blockIdx.x,
                        blockIdx.y, blockIdx.z, smem_raw);
}

// Launch 2, the output: grid (nc, H, B), rwkv6_chunk.cuh chunk_out.
template <int K>
__global__ void __launch_bounds__(rc::NT2, 2) rwkv6_scan_chunk_out_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const bf16* __restrict__ sparts,
    bf16* __restrict__ y, int S, int H, int V, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rc::chunk_out<K, false>(r, k, v, w, u, sparts, y, S, H, V, vec, smem_raw);
}

template <int K>
int launch_bf16(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, void* scratch, int B, int S, int H,
                int V, cudaStream_t stream) {
  const int nc = (S + rc::T - 1) / rc::T;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!aligned16({scratch})) return (int)cudaErrorMisalignedAddress;
  const int vec = V % 8 == 0 && aligned16({r, k, v, w, y});
  const size_t smem1 = rc::state_smem(), smem2 = rc::out_smem<K>();
  auto k1 = rwkv6_scan_state_kernel;
  auto k2 = rwkv6_scan_chunk_out_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  if (nc > 1) {
    k1<<<dim3(K / rc::KB * ((V + rc::VB - 1) / rc::VB), H, B), rc::NT1,
         smem1, stream>>>(
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(w), static_cast<bf16*>(scratch), S, H, K,
        V, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k2<<<dim3(nc, H, B), rc::NT2, smem2, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const bf16*>(scratch),
      static_cast<bf16*>(y), S, H, V, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// r, k, v, y: is_bf16 = 1 for bfloat16, 0 for float32; w and u float32.
// scratch (bfloat16 only; float32 ignores it): bf16, B * H * nc * 2 * K *
// V elements with nc = ceil(S / 64), 16-byte aligned, from the caller's
// allocator.  Key size K 16, 32 or 64 (a float32 stage of r, k, w at K =
// 128 would pass the 48 KB of static shared memory); anything else returns
// cudaErrorInvalidValue without launching (the Python wrapper checks
// first).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 void* scratch, int B, int S, int H, int K,
                                 int V, int is_bf16, void* stream) {
  if (B < 0 || S < 0 || H < 0 || V < 0) return (int)cudaErrorInvalidValue;
  if (K != 16 && K != 32 && K != 64) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RWKV6_CASE(KK)                                                      \
  case KK:                                                                  \
    return is_bf16 ? launch_bf16<KK>(r, k, v, w, u, y, scratch, B, S, H, V, \
                                     s)                                     \
                   : launch_f32<KK>(r, k, v, w, u, y, B, S, H, V, s)
  switch (K) {
    RWKV6_CASE(16);
    RWKV6_CASE(32);
    RWKV6_CASE(64);
  }
#undef RWKV6_CASE
  return (int)cudaErrorInvalidValue;
}
