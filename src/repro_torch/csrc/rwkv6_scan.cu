// RWKV6 (Finch) WKV scan for Hopper (sm_90a): the time-mix recurrence of
// every RWKV6 layer of Model.forward.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (body
// _wkv_kernel).  Same function as its plain version (kernels/ref.py
// rwkv6_scan_chunked): for sequence b and head h, with a (K, V) float32
// state S_0 = 0,
//
//   y_t = r_t (S_{t-1} + diag(u_h) k_t^T v_t),   S_t = diag(w_t) S_{t-1}
//                                                      + k_t^T v_t
//
// r, k (B, S, H, K) and v (B, S, H, V) in float32 or bfloat16, the decay
// w (B, S, H, K) and the bonus u (H, K) float32 (never rounded: the TPU
// kernel sums log w over a chunk, and a rounded w would shift every
// decay), y (B, S, H, V) in r's dtype, all math in float32.
//
// What bounds it on this card: bytes.  At rwkv6's forward shape (B 2, S
// 2048, H 32, K = V = 64) the call must read r, k, v and the float32 w and
// write y, ~101 MB (~30 us at 3.35 TB/s); the TPU kernel's chunked form
// would do ~3.2 GFLOP on tensor cores (~3 us).  The chunked form exists to
// put the work on a matrix unit, and it pays for that with e^{-cw} factors
// that reach 2.6e29 at the decay clamp: this first version runs on the
// CUDA cores and applies the recurrence itself, step by step, which needs
// no rescaling at all - 3 float32 operations per state element and step
// (0.54 G element-steps at that shape).  The diagonal term is computed
// once per step as the scalar (r_t u . k_t) times v_t.  As for K6, the
// serial walk over S steps, with few warps per SM, is what holds this
// version back (PERF.md has its time); tensor cores and the chunked form
// are a later PR's work.
//
// Layout.  The columns v of the state are independent of each other (r_t,
// k_t, w_t are shared), so a block owns COLS columns of one (b, h) and
// walks the whole sequence with those columns' state in registers: LANES
// = K / EPT threads share a column, each holding EPT = 8 state elements,
// and reduce y_t[v] = sum_k r_t[k] S[k, v] with warp shuffles.  Grid
// (ceil(V / COLS), H, B): at rwkv6's shape 8 x 32 x 2 = 512 blocks of 64
// threads (about 4 per SM on 132 SMs).  The sequence is walked in stages of
// TC = 32 steps (the TPU kernel's chunk): a stage's r_t, k_t, w_t, v_t and
// the diagonal scalars are loaded into shared memory with neighbouring
// threads on neighbouring addresses, its y_t are collected in shared
// memory and stored the same way.  Each output element is computed by one
// fixed chain of operations, so every run gives the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;      // threads per block
constexpr int NWARP = NT / 32;
constexpr int EPT = 8;      // state elements per thread
constexpr int TC = 32;      // time steps per shared-memory stage

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

template <typename T, int K>
__global__ void __launch_bounds__(NT) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, T* __restrict__ y, int S, int H, int V) {
  constexpr int LANES = K / EPT;      // threads per state column
  constexpr int COLS = NT / LANES;    // state columns per block
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
    for (int i = tid; i < tn * K; i += NT) {
      const int t = i / K, c = i - t * K;
      const size_t o = (((size_t)b * S + t0 + t) * H + h) * K + c;
      r_s[i] = to_f(r[o]);
      k_s[i] = to_f(k[o]);
      w_s[i] = w[o];
    }
    for (int i = tid; i < tn * COLS; i += NT) {
      const int t = i / COLS, c = i - t * COLS;
      const int vc = c0 + c;
      const size_t o = (((size_t)b * S + t0 + t) * H + h) * V + vc;
      v_s[i] = vc < V ? to_f(v[o]) : 0.f;
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
    for (int i = tid; i < tn * COLS; i += NT) {
      const int t = i / COLS, c = i - t * COLS;
      const int vc = c0 + c;
      if (vc < V)
        y[(((size_t)b * S + t0 + t) * H + h) * V + vc] = from_f<T>(y_s[i]);
    }
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, int B, int S, int H, int V,
           cudaStream_t stream) {
  constexpr int COLS = NT / (K / EPT);
  const dim3 grid((V + COLS - 1) / COLS, H, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  rwkv6_scan_kernel<T, K><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y), S, H, V);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, int B, int S, int H, int K, int V,
             cudaStream_t s) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, B, S, H, V, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, B, S, H, V, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, B, S, H, V, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// r, k, v, y: is_bf16 = 1 for bfloat16, 0 for float32; w and u float32.
// Key size K 16, 32 or 64 (a stage of r, k, w at K = 128 would pass the
// 48 KB of static shared memory); anything else returns cudaErrorInvalidValue
// without launching (the Python wrapper checks first).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 int B, int S, int H, int K, int V,
                                 int is_bf16, void* stream) {
  if (B < 0 || S < 0 || H < 0 || V < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, y, B, S, H, K, V, s);
  return dispatch<float>(r, k, v, w, u, y, B, S, H, K, V, s);
}
