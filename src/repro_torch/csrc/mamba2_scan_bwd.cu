// Mamba2 (SSD) scan backward for Hopper (sm_90a): the gradient of K6
// (csrc/mamba2_scan.cu) on the training path of the hybrid family.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward for the
// scan (src/repro/kernels/mamba2_scan.py:72 mamba2_scan is forward only)
// and differentiates its plain chunked scan instead
// (src/repro/kernels/ops.py mamba2_scan off the TPU).  This kernel computes
// that gradient, the same function as its plain version (kernels/ref.py
// mamba2_scan_bwd: torch.autograd.grad through mamba2_scan_chunked).  For
// sequence b and head h, with h_t = a_t h_{t-1} + dt_t x_t B_t^T (P x N,
// fp32, h_{-1} = 0), a_t = exp(-dt_t A_h), y_t = h_t C_t, and the adjoint
// g_t = dL/dh_t = dy_t C_t^T + a_{t+1} g_{t+1}:
//
//   dx_t  = dt_t g_t B_t                    dB_t = sum_h dt_t g_t^T x_t
//   dC_t  = sum_h h_t^T dy_t                dA_h = -sum_{b,t} dt_t a_t <h_{t-1}, g_t>
//   ddt_t = x_t^T g_t B_t - A_h a_t <h_{t-1}, g_t>
//
// x, Bm, Cm, dy (and dx, dBm, dCm) in float32 or bfloat16, dt, A (ddt,
// dA) float32; every sum in float32, each output rounded once.
//
// The recurrence on the CUDA cores, three launches (one launch count):
//  1. grid (block of ROWS = 16 state rows p, head, sequence), ROWS x N / 4
//     threads, each holding EPT = 4 state elements (one row, four columns)
//     in registers.  It walks the sequence forward, saving the state at
//     every TS = 16th step to fp32 scratch (ckpt), then backward, 16 steps
//     at a time: the 16 states of the stretch recomputed from its saved
//     one into registers, then the steps in reverse with the adjoint g in
//     registers.  Sums over a row's columns (dx, and <h_{t-1}, g> and
//     x^T g B for ddt) go through shared memory once a stretch; sums over
//     the block's rows (dB, dC) are a reduce-scatter over the half-warp
//     (csrc/scan_bwd.cuh), written as per-(head, row block) partials to
//     fp32 scratch, as are ddt's two terms per row block.
//  2. dB and dC: the partials of the H x P / 16 (head, row block) pairs
//     summed per (b, t), in a fixed order.
//  3. ddt and dA: per head, ddt's terms summed over the row blocks and dA
//     over (b, t), in a fixed order.
// No atomics, so every run gives the same bits.  Keeping the forward's
// carry-in states instead of recomputing them would not remove the
// per-step recompute - the backward needs h at every step, and 16 steps
// of a 16 x N slice is what a block keeps in registers - so the kernel
// saves its own, at the spacing its registers set.
//
// What bounds it: at zamba2's training shape (B 4, S 2048, H 80, P 64, N
// 64, bf16) the function must move ~260 MB (~78 us at 3.35 TB/s), and the
// recurrence does ~38 GFLOP (launch/cost.py k6_bwd_work), bytes first.
// This first kernel also writes and reads ~0.7 GB of saved states and
// ~1.3 GB of dB / dC partials (one row block's per step), and walks 2048
// steps in order in every block: the serial chain, not bytes or FLOPs,
// holds it (PERF.md).  The chunked form on the tensor cores, with the
// partials summed inside a cluster, is the way on.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scan_bwd;

constexpr int ROWS = 16;   // state rows (of P) a block owns
constexpr int EPT = 4;     // state columns (of N) a thread owns
constexpr int TS = 16;     // steps between saved states: a stretch
constexpr int NT_RED = 256;

template <typename T, int N>
__global__ void __launch_bounds__(ROWS * N / EPT) mamba2_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ ckpt, float* __restrict__ part_bc,
    float* __restrict__ part_t, int S, int H, int P) {
  constexpr int LANES = N / EPT, NT = ROWS * LANES, LH = LANES / 2;
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                    // TS x N
  float* c_s = b_s + TS * N;            // TS x N
  float* x_s = c_s + TS * N;            // TS x ROWS
  float* dy_s = x_s + TS * ROWS;        // TS x ROWS
  float* dt_s = dy_s + TS * ROWS;       // TS
  float* dec_s = dt_s + TS;             // TS: a_t
  float* rx_s = dec_s + TS;             // TS x LH x ROWS: sum_n g B
  float* rd_s = rx_s + TS * LH * ROWS;  // TS x LH x ROWS: <h_{t-1}, g>

  const int pb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int npb = gridDim.x, Bsz = gridDim.z;
  const int tid = threadIdx.x, row = tid % ROWS, lane = tid / ROWS;
  const int n0 = lane * EPT, p0 = pb * ROWS;
  const int HQ = H * npb;           // partials per (b, t)
  const float a_h = A[h];
  const int nck = (S + TS - 1) / TS;
  float* ck = ckpt + ((((size_t)b * H + h) * npb + pb) * nck) * (NT * EPT);
  const size_t half_bc = (size_t)Bsz * S * HQ * N;
  const size_t half_t = (size_t)Bsz * S * HQ;

  // a stretch's inputs into shared memory, zero past its tn steps and past
  // P (a zero x and dy keep a dead row's state and adjoint at 0)
  auto load = [&](int t0, int tn, bool back) {
    for (int i = tid; i < TS * N; i += NT) {
      const int j = i / N;
      const bool live = j < tn;
      const size_t o = ((size_t)b * S + t0) * N + i;
      b_s[i] = live ? ld(Bm, o) : 0.f;
      if (back) c_s[i] = live ? ld(Cm, o) : 0.f;
    }
    for (int i = tid; i < TS * ROWS; i += NT) {
      const int j = i / ROWS, r = i - j * ROWS;
      const bool live = j < tn && p0 + r < P;
      const size_t o = (((size_t)b * S + t0 + j) * H + h) * P + p0 + r;
      x_s[i] = live ? ld(x, o) : 0.f;
      if (back) dy_s[i] = live ? ld(dy, o) : 0.f;
    }
    for (int j = tid; j < TS; j += NT) {
      const float d = j < tn ? dt[((size_t)b * S + t0 + j) * H + h] : 0.f;
      dt_s[j] = d;
      dec_s[j] = expf(-d * a_h);
    }
  };

  // 1. forward: the state at the start of every stretch
  float hs[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) hs[e] = 0.f;
  for (int k = 0; k < nck; ++k) {
    const int t0 = k * TS, tn = min(TS, S - t0);
#pragma unroll
    for (int e = 0; e < EPT; ++e) ck[((size_t)k * EPT + e) * NT + tid] = hs[e];
    if (k == nck - 1) break;
    __syncthreads();   // the previous stretch is consumed
    load(t0, tn, false);
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const float dec = dec_s[j], u = dt_s[j] * x_s[j * ROWS + row];
      const float4 bq = *reinterpret_cast<const float4*>(b_s + j * N + n0);
      hs[0] = fmaf(hs[0], dec, u * bq.x);
      hs[1] = fmaf(hs[1], dec, u * bq.y);
      hs[2] = fmaf(hs[2], dec, u * bq.z);
      hs[3] = fmaf(hs[3], dec, u * bq.w);
    }
  }

  // 2. backward, a stretch at a time from the last
  float g[EPT];      // a_{t+1} g_{t+1}: the adjoint carried into step t
#pragma unroll
  for (int e = 0; e < EPT; ++e) g[e] = 0.f;
  for (int k = nck - 1; k >= 0; --k) {
    const int t0 = k * TS, tn = min(TS, S - t0);
    __syncthreads();   // the previous stretch and its sums are consumed
    load(t0, tn, true);
    float hist[TS + 1][EPT];   // h_{t0 - 1 + j}
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      hist[0][e] = ck[((size_t)k * EPT + e) * NT + tid];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TS; ++j) {   // past tn: dec 1, u 0, a copy
      const float dec = dec_s[j], u = dt_s[j] * x_s[j * ROWS + row];
      const float4 bq = *reinterpret_cast<const float4*>(b_s + j * N + n0);
      hist[j + 1][0] = fmaf(hist[j][0], dec, u * bq.x);
      hist[j + 1][1] = fmaf(hist[j][1], dec, u * bq.y);
      hist[j + 1][2] = fmaf(hist[j][2], dec, u * bq.z);
      hist[j + 1][3] = fmaf(hist[j][3], dec, u * bq.w);
    }
#pragma unroll
    for (int j = TS - 1; j >= 0; --j) {
      if (j >= tn) continue;   // the same for the whole block
      const int t = t0 + j;
      const float dyp = dy_s[j * ROWS + row];
      const float xd = dt_s[j] * x_s[j * ROWS + row];
      const float4 bq = *reinterpret_cast<const float4*>(b_s + j * N + n0);
      const float4 cq = *reinterpret_cast<const float4*>(c_s + j * N + n0);
      const float bv[EPT] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[EPT] = {cq.x, cq.y, cq.z, cq.w};
      float gg[EPT], part[2 * EPT], sx = 0.f, sd = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        gg[e] = fmaf(cv[e], dyp, g[e]);          // g_t
        part[e] = xd * gg[e];                    // dB_t terms
        part[EPT + e] = hist[j + 1][e] * dyp;    // dC_t terms
        sx = fmaf(gg[e], bv[e], sx);
        sd = fmaf(hist[j][e], gg[e], sd);
        g[e] = gg[e] * dec_s[j];
      }
      const float tot = rows_sum<2 * EPT>(part, row);
      if (rows_writer<2 * EPT>(row)) {
        const int idx = rows_index<2 * EPT>(row);
        part_bc[(idx < EPT ? 0 : half_bc) +
                (((size_t)b * S + t) * HQ + (size_t)h * npb + pb) * N + n0 +
                (idx & (EPT - 1))] = tot;
      }
      sx += __shfl_xor_sync(FULL, sx, 16);   // the warp's two lanes
      sd += __shfl_xor_sync(FULL, sd, 16);
      if ((lane & 1) == 0) {
        rx_s[(j * LH + lane / 2) * ROWS + row] = sx;
        rd_s[(j * LH + lane / 2) * ROWS + row] = sd;
      }
    }
    __syncthreads();
    // per (step, row): the sums over the row's columns; the 16 rows of a
    // step are one half-warp
    for (int i = tid; i < TS * ROWS; i += NT) {
      const int j = i / ROWS, r = i - j * ROWS;
      float sx = 0.f, sd = 0.f;
#pragma unroll
      for (int l = 0; l < LH; ++l) {
        sx += rx_s[(j * LH + l) * ROWS + r];
        sd += rd_s[(j * LH + l) * ROWS + r];
      }
      const bool live = j < tn;
      if (live && p0 + r < P)
        st(dx, (((size_t)b * S + t0 + j) * H + h) * P + p0 + r, dt_s[j] * sx);
      const float vx = half_sum16(x_s[j * ROWS + r] * sx);
      sd = half_sum16(sd);
      if (r == 0 && live) {
        const size_t o = (((size_t)b * S + t0 + j) * H + h) * npb + pb;
        part_t[o] = vx;
        part_t[half_t + o] = sd;
      }
    }
  }
}

// dB and dC of step t of sequence b: the HQ partials summed in a fixed
// order, NT_RED / N threads a column
template <typename T, int N>
__global__ void __launch_bounds__(NT_RED) mamba2_bwd_bc_kernel(
    const float* __restrict__ part_bc, T* __restrict__ dB,
    T* __restrict__ dC, int S, int HQ) {
  constexpr int G = NT_RED / N;
  __shared__ float sb[NT_RED], sc[NT_RED];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n = tid % N, gi = tid / N;
  const size_t half = (size_t)gridDim.y * S * HQ * N;
  const float* src = part_bc + ((size_t)b * S + t) * HQ * N;
  float vb = 0.f, vc = 0.f;
  for (int q = gi; q < HQ; q += G) {
    vb += src[(size_t)q * N + n];
    vc += src[half + (size_t)q * N + n];
  }
  sb[tid] = vb;
  sc[tid] = vc;
  __syncthreads();
  if (tid < N) {
    float tb = 0.f, tc = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      tb += sb[i * N + tid];
      tc += sc[i * N + tid];
    }
    st(dB, ((size_t)b * S + t) * N + tid, tb);
    st(dC, ((size_t)b * S + t) * N + tid, tc);
  }
}

// head h: ddt over every (b, t), and dA, summed in a fixed order
__global__ void __launch_bounds__(NT_RED) mamba2_bwd_dt_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ part_t, float* __restrict__ ddt,
    float* __restrict__ dA, int BS, int H, int npb) {
  __shared__ float red[NT_RED];
  const int h = blockIdx.x, tid = threadIdx.x;
  const float a_h = A[h];
  const size_t half = (size_t)BS * H * npb;
  float acc = 0.f;
  for (int i = tid; i < BS; i += NT_RED) {
    const size_t bth = (size_t)i * H + h;
    float sx = 0.f, sd = 0.f;
    for (int q = 0; q < npb; ++q) {
      sx += part_t[bth * npb + q];
      sd += part_t[half + bth * npb + q];
    }
    const float d = dt[bth], a = expf(-d * a_h);
    ddt[bth] = sx - a_h * a * sd;
    acc = fmaf(-d * a, sd, acc);
  }
  red[tid] = acc;
  __syncthreads();
  for (int s = NT_RED / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) dA[h] = red[0];
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, void* dx, void* ddt, void* dA,
           void* dB, void* dC, void* ckpt, void* part_bc, void* part_t,
           int B, int S, int H, int P, cudaStream_t stream) {
  constexpr int NT = ROWS * N / EPT, LH = N / EPT / 2;
  const int npb = (P + ROWS - 1) / ROWS;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) *
                      (2 * TS * N + 2 * TS * ROWS + 2 * TS + 2 * TS * LH * ROWS);
  auto k1 = mamba2_bwd_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3(npb, H, B), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(ckpt),
      static_cast<float*>(part_bc), static_cast<float*>(part_t), S, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mamba2_bwd_bc_kernel<T, N><<<dim3(S, B), NT_RED, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<T*>(dB),
      static_cast<T*>(dC), S, H * npb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mamba2_bwd_dt_kernel<<<H, NT_RED, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(part_t), static_cast<float*>(ddt),
      static_cast<float*>(dA), B * S, H, npb);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes: the four launches above on `stream`.
// Returns a cudaError_t (0 = launched).  x, Bm, Cm, dy, dx, dBm, dCm:
// is_bf16 = 1 for bfloat16, 0 for float32; dt, A, ddt, dA float32.
// Scratch, float32 from the caller's allocator, with npb = ceil(P / 16)
// and nck = ceil(S / 16): ckpt B * H * npb * nck * 16 * N, part_bc 2 * B *
// S * H * npb * N, part_t 2 * B * S * H * npb elements.  State size N 16,
// 32, 64 or 128; anything else returns cudaErrorInvalidValue without
// launching (the Python wrapper checks first).
extern "C" int mamba2_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* ckpt, void* part_bc, void* part_t, int B, int S, int H,
    int P, int N, int is_bf16, void* stream) {
  if (B < 0 || S < 0 || H < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (N != 16 && N != 32 && N != 64 && N != 128)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || P == 0) {   // no state: every gradient is 0
    const size_t es = is_bf16 ? sizeof(bf16) : sizeof(float);
    const size_t bs = (size_t)B * S;
    cudaError_t err = cudaMemsetAsync(dA, 0, H * sizeof(float), s);
    if (err == cudaSuccess && bs)
      err = cudaMemsetAsync(ddt, 0, bs * H * sizeof(float), s);
    if (err == cudaSuccess && bs) err = cudaMemsetAsync(dB, 0, bs * N * es, s);
    if (err == cudaSuccess && bs) err = cudaMemsetAsync(dC, 0, bs * N * es, s);
    return (int)err;
  }
#define MAMBA2_BWD_CASE(NN)                                                 \
  case NN:                                                                  \
    return is_bf16                                                          \
               ? launch<bf16, NN>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB,    \
                                  dC, ckpt, part_bc, part_t, B, S, H, P, s) \
               : launch<float, NN>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB,   \
                                   dC, ckpt, part_bc, part_t, B, S, H, P, s)
  switch (N) {
    MAMBA2_BWD_CASE(16);
    MAMBA2_BWD_CASE(32);
    MAMBA2_BWD_CASE(64);
    MAMBA2_BWD_CASE(128);
  }
#undef MAMBA2_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
