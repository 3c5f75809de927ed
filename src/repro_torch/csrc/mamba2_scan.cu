// Mamba2 (SSD) selective scan for Hopper (sm_90a): the scan of every
// Mamba2 layer of Model.forward.
//
// Replaces the TPU kernel repro/kernels/mamba2_scan.py::mamba2_scan (body
// _ssd_kernel).  Same function as its plain version (kernels/ref.py
// mamba2_scan_chunked): for sequence b and head h, with a (P, N) float32
// state h_0 = 0,
//
//   h_t = exp(-dt_t * A_h) h_{t-1} + (dt_t x_t) outer B_t,   y_t = h_t C_t
//
// x (B, S, H, P) and Bm / Cm (B, S, N) in float32 or bfloat16, dt (B, S, H)
// and A (H,) float32 (never rounded: dt enters an exponent), y (B, S, H, P)
// in x's dtype, all math in float32.
//
// What bounds it on this card: bytes, in principle.  At zamba2's forward
// shape (B 2, S 2048, H 80, P 64, N 64) the call must read x, dt, B, C and
// write y, ~86 MB (~26 us at 3.35 TB/s); the TPU kernel's chunked matrix
// form (C B^T masked by the decay, times dt x, per 128-step chunk) would do
// ~16 GFLOP on tensor cores (~16 us at 989 TFLOP/s).  This first version
// runs on the CUDA cores in float32, where the chunked form would do twice
// the multiply-adds of the plain recurrence (T (N + P) / 2 + 2 P N per step
// against 2 P N), so it runs the recurrence itself: 3 float32 operations
// per state element and step, 1.34 G element-steps at that shape.  What
// holds this version back is latency: every block walks all S steps in
// series, each step a chain of shared loads, FMAs and a shuffle
// reduction, with few warps per SM to hide it (PERF.md has its time).
// Moving the intra-chunk products onto the tensor cores (mma.sync /
// wgmma, where the chunked form pays) is a later PR's work.
//
// Layout.  The rows p of the state are independent of each other (B_t,
// C_t, dt_t are shared), so a block owns ROWS rows of one (b, h) and walks
// the whole sequence with those rows' state in registers: LANES = N / EPT
// threads share a row, each holding EPT = 16 state elements, and reduce
// y_t = sum_n h[p, n] C_t[n] with warp shuffles.  Grid (ceil(P / ROWS), H,
// B): at zamba2's shape 4 x 80 x 2 = 640 blocks of 64 threads (about 5
// per SM on 132 SMs).  The sequence is walked in stages of TC steps: a
// stage's B_t, C_t, dt_t x_t and exp(-dt_t A) are loaded into shared
// memory with neighbouring threads on neighbouring addresses, its y_t are
// collected in shared memory and stored the same way.  The C B^T product
// and the decays are shared by all heads and recomputed per block, as the
// TPU kernel recomputes them per head.  Each output element is computed by
// one fixed chain of operations, so every run gives the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;      // threads per block
constexpr int EPT = 16;     // state elements per thread

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

template <typename T, int N>
__global__ void __launch_bounds__(NT) mamba2_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, int S, int H, int P) {
  constexpr int LANES = N / EPT;      // threads per state row
  constexpr int ROWS = NT / LANES;    // state rows per block
  // time steps per shared-memory stage: B_t and C_t of a stage take 32 KB
  // at N = 64 and 128, below the 48 KB of static shared memory a block has
  constexpr int TC = N > 64 ? 32 : 64;
  __shared__ __align__(16) float b_s[TC * N];
  __shared__ __align__(16) float c_s[TC * N];
  __shared__ float dx_s[TC * ROWS];   // dt_t * x_t[p]
  __shared__ float y_s[TC * ROWS];
  __shared__ float dec_s[TC];         // exp(-dt_t * A)

  const int p0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid - row * LANES;
  const float a = A[h];
  float st[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) st[j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tn = min(TC, S - t0);
    __syncthreads();   // the previous stage is consumed and stored
    const size_t bc0 = ((size_t)b * S + t0) * N;
    for (int i = tid; i < tn * N; i += NT) {
      b_s[i] = to_f(Bm[bc0 + i]);
      c_s[i] = to_f(Cm[bc0 + i]);
    }
    for (int i = tid; i < tn * ROWS; i += NT) {
      const int t = i / ROWS, r = i - t * ROWS;
      const size_t bth = ((size_t)b * S + t0 + t) * H + h;
      const int p = p0 + r;
      dx_s[i] = p < P ? dt[bth] * to_f(x[bth * P + p]) : 0.f;
    }
    for (int t = tid; t < tn; t += NT)
      dec_s[t] = expf(-dt[((size_t)b * S + t0 + t) * H + h] * a);
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < tn; ++t) {
      const float dec = dec_s[t];
      const float dx = dx_s[t * ROWS + row];
      const float4* bv = reinterpret_cast<const float4*>(
          b_s + t * N + lane * EPT);
      const float4* cv = reinterpret_cast<const float4*>(
          c_s + t * N + lane * EPT);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < EPT / 4; ++q) {
        const float4 bq = bv[q], cq = cv[q];
        st[4 * q + 0] = fmaf(st[4 * q + 0], dec, dx * bq.x);
        st[4 * q + 1] = fmaf(st[4 * q + 1], dec, dx * bq.y);
        st[4 * q + 2] = fmaf(st[4 * q + 2], dec, dx * bq.z);
        st[4 * q + 3] = fmaf(st[4 * q + 3], dec, dx * bq.w);
        acc[0] = fmaf(st[4 * q + 0], cq.x, acc[0]);
        acc[1] = fmaf(st[4 * q + 1], cq.y, acc[1]);
        acc[2] = fmaf(st[4 * q + 2], cq.z, acc[2]);
        acc[3] = fmaf(st[4 * q + 3], cq.w, acc[3]);
      }
      float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) y_s[t * ROWS + row] = s;
    }
    __syncthreads();
    for (int i = tid; i < tn * ROWS; i += NT) {
      const int t = i / ROWS, r = i - t * ROWS;
      const int p = p0 + r;
      if (p < P)
        y[(((size_t)b * S + t0 + t) * H + h) * P + p] = from_f<T>(y_s[i]);
    }
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, int P,
           cudaStream_t stream) {
  constexpr int ROWS = NT / (N / EPT);
  const dim3 grid((P + ROWS - 1) / ROWS, H, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  mamba2_scan_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H, P);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, int B, int S, int H, int P, int N,
             cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, y, B, S, H, P, s);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, y, B, S, H, P, s);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, y, B, S, H, P, s);
    case 128: return launch<T, 128>(x, dt, A, Bm, Cm, y, B, S, H, P, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// x, Bm, Cm, y: is_bf16 = 1 for bfloat16, 0 for float32; dt and A float32.
// State size N 16, 32, 64 or 128; anything else returns
// cudaErrorInvalidValue without launching (the Python wrapper checks first).
extern "C" int mamba2_scan_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, void* y, int B, int S,
                                  int H, int P, int N, int is_bf16,
                                  void* stream) {
  if (B < 0 || S < 0 || H < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, s);
  return dispatch<float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, s);
}
