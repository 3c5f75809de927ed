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
// bfloat16: the chunked (SSD) backward on the tensor cores, three launches
// (one launch count), in chunks of T = 128 steps - K6's own, so that the
// carries come from K6's state scan (csrc/mamba2_chunk.cuh) and the serial
// chain is 16 chunk steps at zamba2's S 2048.  With csum the inclusive
// cumulative sum of -dt A within a chunk (only differences of it are
// exponentiated, each masked before the exp, so nothing overflows), H_{c-1}
// the state carried into chunk c and G_c the adjoint at its end from the
// later chunks:
//  1. carries, grid (64-row block of P, head, 2 B): K6's state scan
//     forward (each chunk's H_{c-1}) beside the adjoint scan in reverse,
//     G_{c-1} = e_c G_c + sum_t (dy_t exp(csum_t)) outer C_t, a (P x T) .
//     (T x N) product a chunk on the tensor cores with G in fp32
//     registers; each carry to bf16 scratch as two parts.
//  2. every chunk at once, grid (chunk, group of 10 heads, sequence), 8
//     warps each owning 16 rows of every product (mamba2_bwd_chunk_kernel
//     below): dx, the gradients' intra-chunk T x T products and the carry
//     terms, dB and dC summed over the group's heads in registers into
//     fp32 partials per group, ddt, dA's partial per (sequence, chunk,
//     head).  The decay term X_t = a_t <h_{t-1}, g_t> of ddt and dA is
//     never the difference of two sums that grow over the chunk (the
//     autograd form's d csum -> reverse cumsum, which in float32 puts dA
//     4e-4 of its largest element off at dt A ~6): it is the sum of M[t',
//     s] = Q[t', s] (C_t' . B_s) over the pairs s < t <= t' - a suffix over
//     t' of each row of M^T in registers, then a sum over the rows s < t -
//     plus the carry terms.  Within a chunk csum is kept as two float32
//     parts (a compensated sum), since one float32 sum ~-800 deep at dt A
//     ~6 a step puts each exp(csum_t - csum_s) ~1e-4 off.
//  3. dB and dC: the groups' partials summed in a fixed order; dA: its
//     partials summed in a fixed order.
// The fp32 operands of the products (W'^T = B C^T exp(.), Q = dy x^T
// exp(.) dt and Q^T, H, G, and the carries' x w and dy exp(csum)) enter the
// tensor cores as two bf16 parts, as in K6 (mma.sync m16n8k16, csrc/
// mma_bf16.cuh); x, dy, B and C enter as they are.  No atomics: every run
// gives the same bits.  Heads wider than 64 are walked in blocks of 64
// columns: every output is a sum over the blocks.  dB and dC in registers
// take N / 2 + N / 2 of a thread's registers: at N 128 launch 2 sits at
// 255 and spills a few bytes (ptxas -v), at N 64 225 with none.
//
// What bounds it: at zamba2's training shape (B 4, S 2048, H 80, P 64, N
// 64, bf16) the function must move ~261 MB (~78 us at 3.35 TB/s; launch/
// cost.py k6_bwd_work), bytes first.  The chunked form adds ~168 MB of
// carries as bf16 parts (written by launch 1, read by launch 2) and ~34
// MB of dB / dC partials, and does ~87 GFLOP of mma.sync (the parts and
// the causal tiles' waste included).  On the card (PERF.md: H100 80GB
// HBM3, 700 W) it takes ~0.95 ms: launch 1 ~0.19 (640 blocks, each
// walking 16 chunk steps, ~0.5 GB through memory and L2), launch 2 ~0.71
// (~123 TFLOP/s of mma.sync - one block of 8 warps an SM at 225
// registers, chains of small products, warp 0's 8 column tiles against
// warp 7's one, each head's operands loaded with no product in flight),
// launch 3 ~0.014.  PR 33's first kernel - the fp32 recurrence on the
// CUDA cores, every block walking all 2048 steps in order, ~0.7 GB of
// saved states and ~1.3 GB of per-step dB / dC partials through memory -
// took 6.5-6.7 ms there: the serial chain is now 16 chunk steps and the
// scratch 201 MB.  The way on: each head's loads under the previous
// head's products, the warps' column tiles balanced, wgmma.
//
// float32 keeps that recurrence (TF32 products would miss the 1e-5 float32
// bar), three launches:
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mamba2_chunk.cuh"
#include "mma_bf16.cuh"
#include "scan_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scan_bwd;

// ---------------------------------------------------------------------------
// float32: the recurrence on the CUDA cores
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bfloat16: the chunked (SSD) backward on the tensor cores
// ---------------------------------------------------------------------------

namespace mc = mamba2_chunk;
using mma_bf16::PAD;

constexpr int NT_CHUNK = 256;   // threads of the chunk kernel: 8 warps
constexpr int NW_CHUNK = NT_CHUNK / 32;
constexpr int HEADS = 10;       // heads a chunk block sums dB and dC over
constexpr int NT_SUM = 256;

// a + b = s + e exactly (Knuth's TwoSum)
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = a + b;
  const float bp = s - a;
  e = (a - (s - bp)) + (b - bp);
}

// One warp: the inclusive cumulative sum of -dt * a over a chunk's T steps
// as two parts, hi_s + lo_s: hi the running float32 sum, lo the running
// sum of its rounding errors, each exact by TwoSum (lane l's steps 4l ..
// 4l + 3 in order, then a shuffle scan of the lanes' totals; the plain
// form is kernels/ref.py _csum_pairs).  Each exponent is then taken as
// (hi_t - hi_s) + (lo_t - lo_s), exact to float32's rounding of the
// difference where one float32 sum ~-800 deep in the chunk would lose it.
__device__ __forceinline__ void warp_csum2(const float* dt_s, float a,
                                           int lane, float* hi_s,
                                           float* lo_s) {
  constexpr int Q = mc::T / 32;
  float h[Q], l[Q], hi = 0.f, lo = 0.f;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float s, e;
    two_sum(hi, -dt_s[lane * Q + i] * a, s, e);
    hi = s;
    lo += e;
    h[i] = hi;
    l[i] = lo;
  }
  float th = hi, tl = lo;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float uh = __shfl_up_sync(FULL, th, o);
    const float ul = __shfl_up_sync(FULL, tl, o);
    if (lane >= o) {
      float s, e;
      two_sum(uh, th, s, e);
      th = s;
      tl = (ul + tl) + e;
    }
  }
  float bh = __shfl_up_sync(FULL, th, 1), bl = __shfl_up_sync(FULL, tl, 1);
  if (lane == 0) bh = bl = 0.f;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float s, e;
    two_sum(bh, h[i], s, e);
    hi_s[lane * Q + i] = s;
    lo_s[lane * Q + i] = (bl + l[i]) + e;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Launch 1, the carries: grid (ceil(P / PB), H, 2 B), csrc/mamba2_chunk.cuh
// state_scan - blocks z < B the forward state scan of sequence z (each
// chunk's carry-in H_{c-1}, K6's launch 1), blocks z >= B the adjoint scan
// of sequence z - B in reverse (each chunk's G_c).  The two are
// independent, so they run side by side.
template <int N>
__global__ void __launch_bounds__(mc::NT_STATE) mamba2_bwd_states_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    bf16* __restrict__ hparts, bf16* __restrict__ gparts, int B, int S,
    int H, int P, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pb = blockIdx.x * mc::PB, h = blockIdx.y, z = blockIdx.z;
  if (z < B)
    mc::state_scan<N, false>(x, dt, A, Bm, hparts, S, H, P, vec, pb, h, z,
                             smem_raw);
  else
    mc::state_scan<N, true>(dy, dt, A, Cm, gparts, S, H, P, vec, pb, h,
                            z - B, smem_raw);
}

// Shared memory of the chunk kernel, bytes.
template <int N>
constexpr size_t chunk_smem() {
  return sizeof(bf16) * (2 * mc::T * (N + PAD) + 2 * mc::T * mc::LDX +
                         4 * mc::PB * (N + PAD)) +
         sizeof(float) * (6 * mc::T + NW_CHUNK * mc::T + NW_CHUNK);
}

// Launch 2, every chunk at once: grid (chunk c, group of HEADS heads,
// sequence b), 8 warps; warp r owns rows 16r .. 16r + 15 of every T-row
// product, lane (g, tq) rows ta = 16r + g and ta + 8.  Per head and
// 64-column block of P (every output is a sum over the blocks of P, so a
// head wider than 64 is walked block by block):
//  - carries: gB = e'_t B_t G^T (e'_t = exp(csum_last - csum_t)), and into
//    dB, dC: w_t x_t G and exp(csum_t) dy_t H, w_t = e'_t dt_t, 16 columns
//    of N at a time, with u_t and v_t (their dot products with B_t, C_t);
//  - column tiles t' >= the row tile, last first: B C^T and x dy^T, W'^T =
//    B C^T exp(csum_t' - csum_t) and Q^T = x dy^T exp(csum_t' - csum_t)
//    dt_t (masked before the exp), gB += W'^T dy, dB += Q^T C, and M^T =
//    Q^T (B C^T), whose running suffix over t' summed over the rows s < t
//    gives the warp's share of the decay term's pairs;
//  - column tiles s <= the row tile: Q = dy x^T exp(csum_t - csum_s) dt_s,
//    dC += Q B;
//  - dx = dt gB, and ddt's first term x . gB.
// W'^T, Q^T, Q, H and G enter the products as two bf16 parts.  dB and dC
// sum over the block's heads in registers and go to fp32 partials per
// group; ddt, the group's dA partial (sequence, chunk, head) and dx are
// written directly.
template <int N>
__global__ void __launch_bounds__(NT_CHUNK, 1) mamba2_bwd_chunk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const bf16* __restrict__ hparts, const bf16* __restrict__ gparts,
    bf16* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ part_bc, float* __restrict__ part_a, int S, int H,
    int P, int vec) {
  using namespace mma_bf16;
  constexpr int T = mc::T, PB = mc::PB, LDX = mc::LDX, LDB = N + PAD;
  constexpr int NW = NW_CHUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);   // T x LDB
  bf16* b_s = c_s + T * LDB;                       // T x LDB
  bf16* x_s = b_s + T * LDB;                       // T x LDX
  bf16* y_s = x_s + T * LDX;                       // T x LDX: dy
  bf16* hh_s = y_s + T * LDX;        // PB x LDB: H_{c-1} [p][n], hi part
  bf16* hl_s = hh_s + PB * LDB;      //   and lo part
  bf16* gh_s = hl_s + PB * LDB;      // PB x LDB: G_c, hi
  bf16* gl_s = gh_s + PB * LDB;      //   and lo
  float* dt_s = reinterpret_cast<float*>(gl_s + PB * LDB);   // T
  float* chi_s = dt_s + T;           // csum as two parts
  float* clo_s = chi_s + T;
  float* u_s = clo_s + T;            // per row: u_t, v_t, x . gB
  float* v_s = u_s + T;
  float* t1_s = v_s + T;
  float* col_s = t1_s + T;           // NW x T: the warps' pair sums
  float* red_s = col_s + NW * T;     // NW: the warps' <H, G>

  const int c = blockIdx.x, hgrp = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Bsz = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * T, tn = min(T, S - t0);
  const size_t bt0 = (size_t)b * S + t0;
  const size_t PN = (size_t)P * N;
  const int h0 = hgrp * HEADS, h1 = min(H, h0 + HEADS);
  const int r0 = 16 * warp, ta = r0 + g, tb = ta + 8;
  const bool live = r0 < tn;         // else the warp's rows are padding
  const int kend = (tn - 1) / 16;    // the last column tile with a step
  const bool has_h = c > 0, has_g = c < nc - 1;

  load_tile<N, NT_CHUNK>(c_s, LDB, Cm + bt0 * N, N, T, tn, N, vec, tid);
  load_tile<N, NT_CHUNK>(b_s, LDB, Bm + bt0 * N, N, T, tn, N, vec, tid);
  // (committed with the first head's loads)

  float dbt[N / 8][4], dct[N / 8][4];   // dB, dC of the warp's rows
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbt[n][e] = dct[n][e] = 0.f;

  for (int h = h0; h < h1; ++h) {
    const float a_h = A[h];
    __syncthreads();   // the previous head's last warp-0 sums are done
    for (int t = tid; t < T; t += NT_CHUNK)
      dt_s[t] = t < tn ? dt[(bt0 + t) * H + h] : 0.f;
    for (int i = tid; i < NW * T; i += NT_CHUNK) col_s[i] = 0.f;
    __syncthreads();
    if (warp == 0) warp_csum2(dt_s, a_h, lane, chi_s, clo_s);
    float t1[2] = {0.f, 0.f}, uu[2] = {0.f, 0.f}, vv[2] = {0.f, 0.f};
    float kacc = 0.f;
    for (int pb = 0; pb < P; pb += PB) {
      const int pw = min(PB, P - pb);
      __syncthreads();   // every warp is done with x_s, y_s and the parts
      const size_t xo = bt0 * H * P + (size_t)h * P + pb;
      load_tile<PB, NT_CHUNK>(x_s, LDX, x + xo, (long long)H * P, T, tn, pw,
                              vec, tid);
      load_tile<PB, NT_CHUNK>(y_s, LDX, dy + xo, (long long)H * P, T, tn,
                              pw, vec, tid);
      const size_t po = (((size_t)b * H + h) * nc + c) * 2 * PN +
                        (size_t)pb * N;
      if (has_h) {
        load_tile<N, NT_CHUNK>(hh_s, LDB, hparts + po, N, PB, pw, N, true,
                               tid);
        load_tile<N, NT_CHUNK>(hl_s, LDB, hparts + po + PN, N, PB, pw, N,
                               true, tid);
      }
      if (has_g) {
        load_tile<N, NT_CHUNK>(gh_s, LDB, gparts + po, N, PB, pw, N, true,
                               tid);
        load_tile<N, NT_CHUNK>(gl_s, LDB, gparts + po + PN, N, PB, pw, N,
                               true, tid);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // the operands and csum are in place

      if (has_h && has_g) {   // <H, G> over this block of P
        float kp = 0.f;
        for (int i = tid; i < PB * N; i += NT_CHUNK) {
          const int o = (i / N) * LDB + i % N;
          kp = fmaf(__bfloat162float(hh_s[o]) + __bfloat162float(hl_s[o]),
                    __bfloat162float(gh_s[o]) + __bfloat162float(gl_s[o]),
                    kp);
        }
        kacc += warp_sum(kp);
      }
      if (!live) continue;

      const float chL = chi_s[T - 1], clL = clo_s[T - 1];
      const float ch[2] = {chi_s[ta], chi_s[tb]};
      const float cl[2] = {clo_s[ta], clo_s[tb]};
      const float dtr[2] = {dt_s[ta], dt_s[tb]};
      float gb[PB / 8][4];              // gB of the warp's rows
#pragma unroll
      for (int n = 0; n < PB / 8; ++n)
        gb[n][0] = gb[n][1] = gb[n][2] = gb[n][3] = 0.f;

      // ---- carries ----
      if (has_g) {
        // gB = e'_t B_t G^T: B's rows over N against G [p][n]
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, b_s + a_offset(lane, LDB, r0, 16 * kk));
#pragma unroll
          for (int pp = 0; pp < PB / 16; ++pp) {
            uint32_t hf[4], lf[4];
            ldmatrix_x4(hf, gh_s + b_offset(lane, LDB, 16 * pp, 16 * kk));
            ldmatrix_x4(lf, gl_s + b_offset(lane, LDB, 16 * pp, 16 * kk));
            mma(gb[2 * pp], af, hf[0], hf[1]);
            mma(gb[2 * pp + 1], af, hf[2], hf[3]);
            mma(gb[2 * pp], af, lf[0], lf[1]);
            mma(gb[2 * pp + 1], af, lf[2], lf[3]);
          }
        }
        float ee[2], ww[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          ee[hr] = expf((chL - ch[hr]) + (clL - cl[hr]));
          ww[hr] = ee[hr] * dtr[hr];
        }
#pragma unroll
        for (int n = 0; n < PB / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) gb[n][e] *= ee[e >> 1];
        // dB += w_t x_t G, and u_t = B_t . (that term)
        uint32_t xa[PB / 16][4];
#pragma unroll
        for (int kp = 0; kp < PB / 16; ++kp)
          ldmatrix_x4(xa[kp], x_s + a_offset(lane, LDX, r0, 16 * kp));
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kp = 0; kp < PB / 16; ++kp) {
            uint32_t hf[4], lf[4];
            ldmatrix_x4_trans(hf, gh_s + bt_offset(lane, LDB, 16 * kp,
                                                   16 * np));
            ldmatrix_x4_trans(lf, gl_s + bt_offset(lane, LDB, 16 * kp,
                                                   16 * np));
            mma(tmp[0], xa[kp], hf[0], hf[1]);
            mma(tmp[1], xa[kp], hf[2], hf[3]);
            mma(tmp[0], xa[kp], lf[0], lf[1]);
            mma(tmp[1], xa[kp], lf[2], lf[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hr = e >> 1, n = 16 * np + 8 * j + 2 * tq + (e & 1);
              const float v = tmp[j][e] * ww[hr];
              dbt[2 * np + j][e] += v;
              uu[hr] = fmaf(v, __bfloat162float(b_s[(ta + 8 * hr) * LDB + n]),
                            uu[hr]);
            }
        }
      }
      if (has_h) {
        // dC += exp(csum_t) dy_t H, and v_t = C_t . (that term)
        float ec[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) ec[hr] = expf(ch[hr] + cl[hr]);
        uint32_t ya[PB / 16][4];
#pragma unroll
        for (int kp = 0; kp < PB / 16; ++kp)
          ldmatrix_x4(ya[kp], y_s + a_offset(lane, LDX, r0, 16 * kp));
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kp = 0; kp < PB / 16; ++kp) {
            uint32_t hf[4], lf[4];
            ldmatrix_x4_trans(hf, hh_s + bt_offset(lane, LDB, 16 * kp,
                                                   16 * np));
            ldmatrix_x4_trans(lf, hl_s + bt_offset(lane, LDB, 16 * kp,
                                                   16 * np));
            mma(tmp[0], ya[kp], hf[0], hf[1]);
            mma(tmp[1], ya[kp], hf[2], hf[3]);
            mma(tmp[0], ya[kp], lf[0], lf[1]);
            mma(tmp[1], ya[kp], lf[2], lf[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hr = e >> 1, n = 16 * np + 8 * j + 2 * tq + (e & 1);
              const float v = tmp[j][e] * ec[hr];
              dct[2 * np + j][e] += v;
              vv[hr] = fmaf(v, __bfloat162float(c_s[(ta + 8 * hr) * LDB + n]),
                            vv[hr]);
            }
        }
      }

      // ---- column tiles t' >= the row tile, the last first ----
      float run[2] = {0.f, 0.f};        // M^T's suffix sums of rows ta, tb
      for (int k = kend; k >= warp; --k) {
        const int c0 = 16 * k;
        float sbc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float sd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {   // B C^T
          uint32_t af[4], f[4];
          ldmatrix_x4(af, b_s + a_offset(lane, LDB, r0, 16 * kk));
          ldmatrix_x4(f, c_s + b_offset(lane, LDB, c0, 16 * kk));
          mma(sbc[0], af, f[0], f[1]);
          mma(sbc[1], af, f[2], f[3]);
        }
#pragma unroll
        for (int kp = 0; kp < PB / 16; ++kp) {  // x dy^T
          uint32_t af[4], f[4];
          ldmatrix_x4(af, x_s + a_offset(lane, LDX, r0, 16 * kp));
          ldmatrix_x4(f, y_s + b_offset(lane, LDX, c0, 16 * kp));
          mma(sd[0], af, f[0], f[1]);
          mma(sd[1], af, f[2], f[3]);
        }
        float wv[2][4], qv[2][4], mv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, t = ta + 8 * hr;
            const int tc = c0 + 8 * j + 2 * tq + (e & 1);
            const float d = tc >= t ? expf((chi_s[tc] - ch[hr]) +
                                           (clo_s[tc] - cl[hr]))
                                    : 0.f;
            wv[j][e] = sbc[j][e] * d;
            qv[j][e] = sd[j][e] * d * dtr[hr];
            mv[j][e] = qv[j][e] * sbc[j][e];
          }
        uint32_t whi[4], wlo[4], qhi[4], qlo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = i >> 1, hr = i & 1;
          split2(wv[j][2 * hr], wv[j][2 * hr + 1], whi[i], wlo[i]);
          split2(qv[j][2 * hr], qv[j][2 * hr + 1], qhi[i], qlo[i]);
        }
#pragma unroll
        for (int pp = 0; pp < PB / 16; ++pp) {  // gB += W'^T dy
          uint32_t f[4];
          ldmatrix_x4_trans(f, y_s + bt_offset(lane, LDX, c0, 16 * pp));
          mma(gb[2 * pp], whi, f[0], f[1]);
          mma(gb[2 * pp + 1], whi, f[2], f[3]);
          mma(gb[2 * pp], wlo, f[0], f[1]);
          mma(gb[2 * pp + 1], wlo, f[2], f[3]);
        }
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {   // dB += Q^T C
          uint32_t f[4];
          ldmatrix_x4_trans(f, c_s + bt_offset(lane, LDB, c0, 16 * np));
          mma(dbt[2 * np], qhi, f[0], f[1]);
          mma(dbt[2 * np + 1], qhi, f[2], f[3]);
          mma(dbt[2 * np], qlo, f[0], f[1]);
          mma(dbt[2 * np + 1], qlo, f[2], f[3]);
        }
        // the suffix over t' of M^T's rows: in the lane (its two
        // columns), over the quad (columns 2tq of each 8-column half),
        // over the halves, then the tiles already walked (run)
        float col[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float excl[2], tot[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float s = mv[j][2 * hr] + mv[j][2 * hr + 1];
            float o = __shfl_down_sync(FULL, s, 1);
            if (tq < 3) s += o;
            o = __shfl_down_sync(FULL, s, 2);
            if (tq < 2) s += o;       // s: the quad's suffix from tq
            o = __shfl_down_sync(FULL, s, 1);
            excl[j] = tq < 3 ? o : 0.f;
            tot[j] = __shfl_sync(FULL, s, lane & ~3);
          }
          const float base[2] = {run[hr] + tot[1], run[hr]};
          const int s_row = ta + 8 * hr;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float s1 = base[j] + excl[j] + mv[j][2 * hr + 1];
            const float s0 = s1 + mv[j][2 * hr];
            const int tc = c0 + 8 * j + 2 * tq;
            col[j][0] += s_row < tc ? s0 : 0.f;
            col[j][1] += s_row < tc + 1 ? s1 : 0.f;
          }
          run[hr] = base[0] + tot[0];
        }
        // the sum over the warp's 16 rows, into the warp's column sums
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = col[j][e];
            v += __shfl_xor_sync(FULL, v, 4);
            v += __shfl_xor_sync(FULL, v, 8);
            v += __shfl_xor_sync(FULL, v, 16);
            if (g == 0) col_s[warp * T + c0 + 8 * j + 2 * tq + e] += v;
          }
      }

      // ---- column tiles s <= the row tile: dC += Q B ----
      for (int k = 0; k <= warp; ++k) {
        const int c0 = 16 * k;
        float sd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kp = 0; kp < PB / 16; ++kp) {  // dy x^T
          uint32_t af[4], f[4];
          ldmatrix_x4(af, y_s + a_offset(lane, LDX, r0, 16 * kp));
          ldmatrix_x4(f, x_s + b_offset(lane, LDX, c0, 16 * kp));
          mma(sd[0], af, f[0], f[1]);
          mma(sd[1], af, f[2], f[3]);
        }
        uint32_t qhi[4], qlo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = i >> 1, hr = i & 1, t = ta + 8 * hr;
          float q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = c0 + 8 * j + 2 * tq + e;
            q[e] = s <= t ? sd[j][2 * hr + e] *
                                expf((ch[hr] - chi_s[s]) + (cl[hr] - clo_s[s])) *
                                dt_s[s]
                          : 0.f;
          }
          split2(q[0], q[1], qhi[i], qlo[i]);
        }
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, b_s + bt_offset(lane, LDB, c0, 16 * np));
          mma(dct[2 * np], qhi, f[0], f[1]);
          mma(dct[2 * np + 1], qhi, f[2], f[3]);
          mma(dct[2 * np], qlo, f[0], f[1]);
          mma(dct[2 * np + 1], qlo, f[2], f[3]);
        }
      }

      // ---- dx = dt gB, and x . gB ----
#pragma unroll
      for (int n = 0; n < PB / 8; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = ta + 8 * hr, col = 8 * n + 2 * tq;
          const float g0 = gb[n][2 * hr], g1 = gb[n][2 * hr + 1];
          t1[hr] = fmaf(__bfloat162float(x_s[t * LDX + col]), g0, t1[hr]);
          t1[hr] = fmaf(__bfloat162float(x_s[t * LDX + col + 1]), g1, t1[hr]);
          if (t >= tn) continue;
          bf16* o = dx + ((bt0 + t) * H + h) * P + pb + col;
          if (vec) {
            if (col < pw)
              *reinterpret_cast<uint32_t*>(o) =
                  pack(dtr[hr] * g0, dtr[hr] * g1);
          } else {
            if (col < pw) o[0] = __float2bfloat16(dtr[hr] * g0);
            if (col + 1 < pw) o[1] = __float2bfloat16(dtr[hr] * g1);
          }
        }
    }

    // ---- the head's ddt and dA partial ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      t1[hr] = quad_sum(t1[hr]);
      uu[hr] = quad_sum(uu[hr]);
      vv[hr] = quad_sum(vv[hr]);
      if (tq == 0) {
        t1_s[ta + 8 * hr] = t1[hr];
        u_s[ta + 8 * hr] = uu[hr];
        v_s[ta + 8 * hr] = vv[hr];
      }
    }
    if (lane == 0) red_s[warp] = kacc;
    __syncthreads();
    if (warp == 0) {
      // X_t = the pairs s < t <= t' (the warps' column sums) + sum_{s <
      // t} u_s + sum_{t' >= t} v_t' + exp(csum_last) <H, G>; lane l's
      // steps 4l .. 4l + 3
      constexpr int Q = T / 32;
      float K = 0.f;
      if (has_h && has_g) {
#pragma unroll
        for (int w = 0; w < NW; ++w) K += red_s[w];
        K *= expf(chi_s[T - 1] + clo_s[T - 1]);
      }
      float ub[Q], vs[Q], ru = 0.f, rv = 0.f;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        ub[i] = ru;
        ru += u_s[lane * Q + i];
      }
#pragma unroll
      for (int i = Q - 1; i >= 0; --i) {
        rv += v_s[lane * Q + i];
        vs[i] = rv;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {   // inclusive scans of the totals
        const float pu = __shfl_up_sync(FULL, ru, o);
        const float pv = __shfl_down_sync(FULL, rv, o);
        if (lane >= o) ru += pu;
        if (lane + o < 32) rv += pv;
      }
      float before = __shfl_up_sync(FULL, ru, 1);
      float after = __shfl_down_sync(FULL, rv, 1);
      if (lane == 0) before = 0.f;
      if (lane == 31) after = 0.f;
      float da = 0.f;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int t = lane * Q + i;
        float pairs = 0.f;
        for (int w = 0; w <= t / 16; ++w) pairs += col_s[w * T + t];
        const float X = pairs + (before + ub[i]) + (after + vs[i]) + K;
        if (t < tn) ddt[(bt0 + t) * H + h] = t1_s[t] - a_h * X;
        da = fmaf(dt_s[t], X, da);
      }
      da = warp_sum(da);
      if (lane == 0) part_a[((size_t)b * nc + c) * H + h] = -da;
    }
  }

  // ---- the group's dB and dC partials ----
  if (!live) return;
  const size_t half = (size_t)gridDim.y * Bsz * S * N;
  float* pbo = part_bc + ((size_t)hgrp * Bsz + b) * S * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = ta + 8 * hr;
      if (t >= tn) continue;
      const size_t o = (size_t)(t0 + t) * N + 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(pbo + o) =
          make_float2(dbt[n][2 * hr], dbt[n][2 * hr + 1]);
      *reinterpret_cast<float2*>(pbo + half + o) =
          make_float2(dct[n][2 * hr], dct[n][2 * hr + 1]);
    }
}

// Launch 3: dB and dC, the groups' partials summed in order (blocks below
// nbc, an element a thread), and dA, the (sequence, chunk) partials of
// each head summed in order (the blocks after).
__global__ void __launch_bounds__(NT_SUM) mamba2_bwd_sum_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    bf16* __restrict__ dB, bf16* __restrict__ dC, float* __restrict__ dA,
    int groups, int nbc, int H, int BC) {
  const size_t BSN = (size_t)nbc;   // elements of dB
  if (blockIdx.x * NT_SUM < BSN) {
    const size_t i = (size_t)blockIdx.x * NT_SUM + threadIdx.x;
    if (i >= BSN) return;
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < groups; ++q) {
      sb += part_bc[q * BSN + i];
      sc += part_bc[(groups + q) * BSN + i];
    }
    dB[i] = __float2bfloat16(sb);
    dC[i] = __float2bfloat16(sc);
    return;
  }
  const int h = (blockIdx.x - (nbc + NT_SUM - 1) / NT_SUM) * NT_SUM +
                threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int q = 0; q < BC; ++q) s += part_a[(size_t)q * H + h];
  dA[h] = s;
}

template <int N>
int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* dy, void* dx, void* ddt,
                void* dA, void* dB, void* dC, void* parts, void* part_bc,
                void* part_a, int B, int S, int H, int P,
                cudaStream_t stream) {
  const int nc = (S + mc::T - 1) / mc::T;
  const int groups = (H + HEADS - 1) / HEADS;
  if (H > 65535 || 2 * B > 65535 || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (!mma_bf16::aligned16({parts})) return (int)cudaErrorMisalignedAddress;
  const int vec = P % 8 == 0 && mma_bf16::aligned16({x, Bm, Cm, dy, dx});
  bf16* hparts = static_cast<bf16*>(parts);
  bf16* gparts = hparts + (size_t)B * H * nc * 2 * P * N;
  const size_t smem1 = mc::state_smem<N>(), smem2 = chunk_smem<N>();
  auto k1 = mamba2_bwd_states_kernel<N>;
  auto k2 = mamba2_bwd_chunk_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3((P + mc::PB - 1) / mc::PB, H, 2 * B), mc::NT_STATE, smem1,
       stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                 static_cast<const float*>(dt), static_cast<const float*>(A),
                 static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
                 hparts, gparts, B, S, H, P, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3(nc, groups, B), NT_CHUNK, smem2, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy), hparts,
      gparts, static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(part_bc), static_cast<float*>(part_a), S, H, P,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nbc = B * S * N;
  const int blocks = (nbc + NT_SUM - 1) / NT_SUM + (H + NT_SUM - 1) / NT_SUM;
  mamba2_bwd_sum_kernel<<<blocks, NT_SUM, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dA), groups, nbc, H, B * nc);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes: the launches above on `stream`.
// Returns a cudaError_t (0 = launched).  x, Bm, Cm, dy, dx, dBm, dCm:
// is_bf16 = 1 for bfloat16, 0 for float32; dt, A, ddt, dA float32.
// Scratch from the caller's allocator, with nc = ceil(S / 128) and groups
// = ceil(H / 10):
//   bfloat16: s1 bf16, 2 * B * H * nc * 2 * P * N elements (the chunks'
//     carry-in states, then their adjoint carries, each as two parts),
//     16-byte aligned; s2 float32, 2 * groups * B * S * N (the head
//     groups' dB, then dC); s3 float32, B * nc * H (dA's partials).
//   float32, with npb = ceil(P / 16) and nck = ceil(S / 16): s1 float32,
//     B * H * npb * nck * 16 * N (the saved states); s2 float32, 2 * B * S
//     * H * npb * N (dB / dC partials); s3 float32, 2 * B * S * H * npb
//     (ddt's partials).
// State size N 16, 32, 64 or 128; anything else returns
// cudaErrorInvalidValue without launching (the Python wrapper checks
// first).
extern "C" int mamba2_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* s1, void* s2, void* s3, int B, int S, int H, int P,
    int N, int is_bf16, void* stream) {
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
               ? launch_bf16<NN>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, \
                                 s1, s2, s3, B, S, H, P, s)                 \
               : launch<float, NN>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB,   \
                                   dC, s1, s2, s3, B, S, H, P, s)
  switch (N) {
    MAMBA2_BWD_CASE(16);
    MAMBA2_BWD_CASE(32);
    MAMBA2_BWD_CASE(64);
    MAMBA2_BWD_CASE(128);
  }
#undef MAMBA2_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
