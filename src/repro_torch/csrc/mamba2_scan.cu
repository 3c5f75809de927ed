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
// in x's dtype, all sums in float32.
//
// bfloat16: the chunked matrix form on the tensor cores.  The TPU kernel
// walks 128-step chunks in order, carrying the (P, N) state in scratch.
// On this card the heavy part - each chunk's intra-chunk products - need
// not wait for the earlier chunks, which reach it only through its
// carry-in state.  So two launches (one launch count), with csum the
// inclusive cumulative sum of -dt A within a chunk of T = 128 steps and
// only differences of csum ever exponentiated (exp(-csum) alone overflows
// at dt A ~10 a step):
//
//  1. state scan, grid (64-row block of P, head, sequence), serial over the
//     chunks only: per chunk its contribution dH = sum_s (x_s w_s) outer
//     B_s, w_s = exp(csum_last - csum_s) dt_s, a (P x T) . (T x N) product
//     on the tensor cores, and H_c = exp(csum_last) H_{c-1} + dH_c with H
//     in fp32 registers - 16 steps of a (64, 64) state at zamba2's shape in
//     place of 2048 steps.  Each chunk's carry-in H_{c-1} goes to scratch
//     as two bf16 parts.  (Computing the contributions in parallel and the
//     recurrence in a launch of its own sends every dH through memory and
//     back, which costs more than this serial walk: PERF.md.)
//  2. output, grid (chunk, head, sequence), every chunk in parallel: y = W
//     x + exp(csum_t) C_t H_{c-1}, W[t, s] = (C_t . B_s) exp(csum_t -
//     csum_s) dt_s for s <= t (masked before the exp), rounded to bf16
//     once.
//
// The products run on mma.sync m16n8k16 bf16 tiles with fp32 accumulators
// (csrc/mma_bf16.cuh).  C B^T, and every product with x or C on one side,
// is exact; the fp32 operands x w, W and H enter as two bf16 parts (hi,
// then bf16 of the exact remainder: ~2^-16 of the operand), which keeps
// the result ~2e-6 of the largest term from the plain version, 5x inside
// the card bar (tests/test_torch_mamba2_parts.py shows one part misses
// it).  A warp owns 16 rows of an output tile; in launch 2 warp w takes
// the 16-row tiles w and 7 - w of the chunk, whose causal halves sum to
// the same 9 k-steps for every warp.  Heads wider than 64 are walked in
// blocks of 64 columns.  Each output element is one fixed chain of
// operations (no atomics), so every run gives the same bits.
//
// What bounds it: at zamba2's forward shape (B 2, S 2048, H 80, P 64, N
// 64) the function must move ~86 MB (~26 us at 3.35 TB/s) and the chunked
// form's products are ~11 GFLOP (~11 us at 989 TFLOP/s).  With the parts
// and the causal tiles' waste the tensor cores do ~20 GFLOP of mma.sync,
// and the carry-in states add ~84 MB of traffic (written once, read
// once).  Neither bound is what holds it on the card (PERF.md, by launch):
// launch 1 is 160 blocks each walking 16 chunks, a chunk step a few us of
// load latency and of a dependent chain of small products; launch 2 runs
// at ~0.15 mma.sync a cycle an SM.  Both are latency-bound chains of
// small tensor-core products; wgmma with deeper pipelines is the way on.
//
// float32 keeps the recurrence on the CUDA cores (TF32 products would miss
// the 1e-5 float32 bar, and the chunked form in fp32 FMAs does twice the
// recurrence's work): LANES = N / 16 threads share a state row, each
// holding 16 state elements in registers, and a block of 64 threads walks
// the whole sequence for its rows in stages of shared-memory inputs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

// ---------------------------------------------------------------------------
// float32: the recurrence on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT_F32 = 64;      // threads per block
constexpr int EPT = 16;         // state elements per thread

template <int N>
__global__ void __launch_bounds__(NT_F32) mamba2_scan_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, int S, int H,
    int P) {
  constexpr int LANES = N / EPT;      // threads per state row
  constexpr int ROWS = NT_F32 / LANES;  // state rows per block
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
    for (int i = tid; i < tn * N; i += NT_F32) {
      b_s[i] = Bm[bc0 + i];
      c_s[i] = Cm[bc0 + i];
    }
    for (int i = tid; i < tn * ROWS; i += NT_F32) {
      const int t = i / ROWS, r = i - t * ROWS;
      const size_t bth = ((size_t)b * S + t0 + t) * H + h;
      const int p = p0 + r;
      dx_s[i] = p < P ? dt[bth] * x[bth * P + p] : 0.f;
    }
    for (int t = tid; t < tn; t += NT_F32)
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
    for (int i = tid; i < tn * ROWS; i += NT_F32) {
      const int t = i / ROWS, r = i - t * ROWS;
      const int p = p0 + r;
      if (p < P) y[(((size_t)b * S + t0 + t) * H + h) * P + p] = y_s[i];
    }
  }
}

template <int N>
int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, int B, int S, int H, int P,
               cudaStream_t stream) {
  constexpr int ROWS = NT_F32 / (N / EPT);
  const dim3 grid((P + ROWS - 1) / ROWS, H, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  mamba2_scan_f32_kernel<N><<<grid, NT_F32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), S, H, P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the chunk-parallel form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int T = 128;          // chunk: time steps
constexpr int PB = 64;          // head columns p per block of work
constexpr int NT = 128;         // threads of the output kernel: 4 warps
constexpr int NT_STATE = 256;   // of the state kernel: 8 warps
constexpr int LDX = PB + PAD;   // padded shared-memory rows of x
constexpr int CG = 16;          // chunks whose weights the state kernel
                                // computes at once

// Scratch (bf16): each chunk's carry-in state H_{c-1} as two parts at
// [B][H][nc][2][P][N] (hi, then lo); chunk 0's slot (a zero state) is
// neither written nor read.

// One warp: the inclusive cumulative sum of -dt * a over a chunk's T steps
// (dt_s, 0 past the sequence), lane l's steps 4l .. 4l + 3 into cs (in
// order, then a shuffle scan of the lanes' totals: a fixed order, so both
// kernels get the same bits).  Returns the sum over the chunk, csum_last.
__device__ __forceinline__ float warp_csum(const float* dt_s, float a,
                                           int lane, float (&cs)[T / 32]) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) {
    run += -dt_s[lane * (T / 32) + i] * a;
    cs[i] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += u;
  }
  float before = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) cs[i] += before;
  return __shfl_sync(0xffffffffu, cs[T / 32 - 1], 31);
}

// Launch 1, the state scan: grid (ceil(P / PB), H, B), 8 warps.  The block
// walks the chunks of its (sequence, head) in order, keeping its rows of
// the running fp32 state H in registers: warp w owns the 16 rows p of
// m-tile w % 4 and every other 16-column pair of N from w / 4.  So that a
// chunk's step is one barrier and a chain of products, the weights come
// first: for CG chunks at a time, warp k computes chunk k's csum, w_s =
// exp(csum_last - csum_s) dt_s and exp(csum_last) into shared memory.
// Then per chunk, the next chunk's x and B in flight (cp.async, two
// buffers): each warp stores its part of H (the chunk's carry-in) as two
// bf16 parts - staged in its own shared-memory rows so that the stores are
// whole 32-byte sectors - computes dH = (x w)^T B with A = (x w)^T built
// in registers as two parts (hi and lo products in separate accumulators,
// two short chains in place of one long one) and B through
// ldmatrix.trans, and updates H = exp(csum_last) H + dH.
template <int N>
__global__ void __launch_bounds__(NT_STATE) mamba2_scan_state_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    bf16* __restrict__ hparts, int S, int H, int P, int vec) {
  constexpr int LDB = N + PAD;
  constexpr int NW = NT_STATE / 32;
  constexpr int NPAIR = N / 16;          // 16-column pairs of n-tiles
  constexpr int MYP = (NPAIR + 1) / 2;   // most pairs a warp owns
  constexpr int LDH = 16 * MYP + PAD;    // a warp's staging rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);            // 2 x T x LDX
  bf16* b_s = x_s + 2 * T * LDX;                            // 2 x T x LDB
  bf16* hs_s = b_s + 2 * T * LDB;        // per warp: 2 x 16 x LDH
  float* w_s = reinterpret_cast<float*>(hs_s + NW * 2 * 16 * LDH);
  float* e_s = w_s + CG * T;             // CG decays

  const int pb = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + T - 1) / T, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), grp = warp >> 2;
  const int pw = min(PB, P - pb);        // live rows of this block
  const bool mine = m0 < pw && grp < NPAIR;
  const float a = A[h];
  const size_t PN = (size_t)P * N;
  bf16* my_s = hs_s + warp * 2 * 16 * LDH;

  auto load = [&](int c) {
    const int buf = c & 1, t0 = c * T, tn = min(T, S - t0);
    const size_t bt0 = (size_t)b * S + t0;
    load_tile<PB, NT_STATE>(x_s + buf * T * LDX, LDX,
                            x + bt0 * H * P + (size_t)h * P + pb,
                            (long long)H * P, T, tn, pw, vec, tid);
    load_tile<N, NT_STATE>(b_s + buf * T * LDB, LDB, Bm + bt0 * N, N, T, tn,
                           N, vec, tid);
  };

  float st[MYP][2][4];                   // this warp's part of H
#pragma unroll
  for (int i = 0; i < MYP; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      st[i][j][0] = st[i][j][1] = st[i][j][2] = st[i][j][3] = 0.f;
  load(0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, tn = min(T, S - c * T), cw = c % CG;
    if (cw == 0) {       // the weights of chunks c .. c + CG - 1
      __syncthreads();   // every warp is done with the previous group's
      for (int k = warp; k < CG && c + k < nc; k += NW) {
        const int t0 = (c + k) * T, kn = min(T, S - t0);
        float* wk = w_s + k * T;
#pragma unroll
        for (int i = 0; i < T / 32; ++i) {
          const int t = lane * (T / 32) + i;
          wk[t] = t < kn ? dt[((size_t)b * S + t0 + t) * H + h] : 0.f;
        }
        __syncwarp();
        float cs[T / 32];
        const float last = warp_csum(wk, a, lane, cs);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < T / 32; ++i) {
          const int t = lane * (T / 32) + i;
          wk[t] = expf(last - cs[i]) * wk[t];
        }
        if (lane == 0) e_s[k] = expf(last);
      }
    }
    cp_async_wait_all();
    __syncthreads();     // chunk c (and its weights) landed; every warp is
                         // done with chunk c - 1's buffer
    if (c + 1 < nc) load(c + 1);
    cp_async_commit();
    if (!mine) continue;
    if (c > 0) {         // the chunk's carry-in H, as two bf16 parts
#pragma unroll
      for (int i = 0; i < MYP; ++i) {
        if (grp + 2 * i >= NPAIR) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int o = (g + 8 * hr) * LDH + 16 * i + 8 * j + 2 * tq;
            split2(st[i][j][2 * hr], st[i][j][2 * hr + 1],
                   *reinterpret_cast<uint32_t*>(my_s + o),
                   *reinterpret_cast<uint32_t*>(my_s + 16 * LDH + o));
          }
      }
      __syncwarp();
      // 16-byte stores: 2 parts x 16 rows x 2 per pair
      bf16* dst = hparts + (((size_t)b * H + h) * nc + c) * 2 * PN +
                  (size_t)(pb + m0) * N;
      for (int k = lane; k < 2 * 16 * 2 * MYP; k += 32) {
        const int part = k / (32 * MYP), r = (k / (2 * MYP)) % 16;
        const int i = (k % (2 * MYP)) / 2, half = k & 1;
        const int np = grp + 2 * i;
        if (np < NPAIR && pb + m0 + r < P)
          *reinterpret_cast<uint4*>(dst + part * PN + (size_t)r * N +
                                    16 * np + 8 * half) =
              *reinterpret_cast<const uint4*>(my_s + part * 16 * LDH +
                                              r * LDH + 16 * i + 8 * half);
      }
    }
    float dh[MYP][2][4], dl[MYP][2][4];  // hi and lo parts' products
#pragma unroll
    for (int i = 0; i < MYP; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) dh[i][j][k] = dl[i][j][k] = 0.f;
    const bf16* xs = x_s + buf * T * LDX;
    const bf16* bs = b_s + buf * T * LDB;
    const float* ws = w_s + cw * T;
#pragma unroll
    for (int ks = 0; ks < T / 16; ++ks) {
      if (16 * ks >= tn) break;
      const int s0 = 16 * ks;
      // A[p][s] = x[s][p] w[s]: a0 (g, 2tq..+1), a1 (g + 8, 2tq..+1),
      // a2 (g, 2tq + 8..+9), a3 (g + 8, 2tq + 8..+9)
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pr = m0 + g + 8 * (i & 1);
        const int sc = s0 + 2 * tq + 8 * (i >> 1);
        split2(__bfloat162float(xs[sc * LDX + pr]) * ws[sc],
               __bfloat162float(xs[(sc + 1) * LDX + pr]) * ws[sc + 1],
               ahi[i], alo[i]);
      }
#pragma unroll
      for (int i = 0; i < MYP; ++i) {
        const int np = grp + 2 * i;
        if (np >= NPAIR) continue;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bs + bt_offset(lane, LDB, s0, 16 * np));
        mma(dh[i][0], ahi, bf[0], bf[1]);
        mma(dh[i][1], ahi, bf[2], bf[3]);
        mma(dl[i][0], alo, bf[0], bf[1]);
        mma(dl[i][1], alo, bf[2], bf[3]);
      }
    }
    const float e = e_s[cw];
#pragma unroll
    for (int i = 0; i < MYP; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          st[i][j][k] = fmaf(e, st[i][j][k], dh[i][j][k] + dl[i][j][k]);
  }
  cp_async_wait_all();
}

// One k-step (the 16 positions s from s0) of launch 2's intra-chunk
// product for the warp's tiles that DO0 / DO1 select (rows r0[0], r0[1]):
// C B^T, the weights W = C B^T exp(csum_t - csum_s) dt_s for s <= t, else
// 0 (masked before the exp), as two bf16 parts in the A layout, and acc +=
// W x; the B and x fragments are loaded once for both tiles.
template <int N, bool DO0, bool DO1>
__device__ __forceinline__ void out_kstep(
    float (&acc)[2][PB / 8][4], const uint32_t (&cf)[2][N / 16][4],
    const bf16* b_s, const bf16* x_s, const float* cs_s, const float* dt_s,
    const int (&r0)[2], int s0, int lane) {
  constexpr int LDB = N + PAD;
  constexpr bool DO[2] = {DO0, DO1};
  const int g = lane >> 2, tq = lane & 3;
  float sc[2][2][4];                 // C B^T, rows r0.., columns s0..
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sc[hf][j][0] = sc[hf][j][1] = sc[hf][j][2] = sc[hf][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t bf[4];
    ldmatrix_x4(bf, b_s + b_offset(lane, LDB, s0, 16 * kk));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!DO[hf]) continue;
      mma(sc[hf][0], cf[hf][kk], bf[0], bf[1]);
      mma(sc[hf][1], cf[hf][kk], bf[2], bf[3]);
    }
  }
  uint32_t whi[2][4], wlo[2][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!DO[hf]) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1, hr = i & 1;          // column tile, row half
      const int t = r0[hf] + g + 8 * hr, s = s0 + 8 * j + 2 * tq;
      const float ct = cs_s[t];
      const float w0 = s <= t ? sc[hf][j][2 * hr] * expf(ct - cs_s[s]) *
                                    dt_s[s]
                              : 0.f;
      const float w1 = s + 1 <= t ? sc[hf][j][2 * hr + 1] *
                                        expf(ct - cs_s[s + 1]) * dt_s[s + 1]
                                  : 0.f;
      split2(w0, w1, whi[hf][i], wlo[hf][i]);
    }
  }
#pragma unroll
  for (int pp = 0; pp < PB / 16; ++pp) {
    uint32_t xf[4];
    ldmatrix_x4_trans(xf, x_s + bt_offset(lane, LDX, s0, 16 * pp));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!DO[hf]) continue;
      mma(acc[hf][2 * pp], whi[hf], xf[0], xf[1]);
      mma(acc[hf][2 * pp + 1], whi[hf], xf[2], xf[3]);
      mma(acc[hf][2 * pp], wlo[hf], xf[0], xf[1]);
      mma(acc[hf][2 * pp + 1], wlo[hf], xf[2], xf[3]);
    }
  }
}

// Launch 2, the output: grid (nc, H, B), 4 warps, three blocks an SM.  y =
// W x + exp(csum_t) C H_in, W = C B^T * exp(csum_t - csum_s) * dt_s on the
// causal half.  Warp w takes the 16-row tiles w and 7 - w of the chunk,
// whose causal halves sum to 9 k-steps for every warp, and runs their two
// chains of products interleaved (out_kstep).
template <int N>
__global__ void __launch_bounds__(NT, N > 64 ? 2 : 3)
    mamba2_scan_chunk_out_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ hparts,
    bf16* __restrict__ y, int S, int H, int P, int vec) {
  constexpr int LDB = N + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);            // T x LDB
  bf16* b_s = c_s + T * LDB;                                // T x LDB
  bf16* x_s = b_s + T * LDB;                                // T x LDX
  bf16* hh_s = x_s + T * LDX;       // carry-in hi part, PB x LDB ([p][n])
  bf16* hl_s = hh_s + PB * LDB;     // and lo part
  float* dt_s = reinterpret_cast<float*>(hl_s + PB * LDB);  // T
  float* cs_s = dt_s + T;                                   // T

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * T, tn = min(T, S - t0);
  const size_t bt0 = (size_t)b * S + t0;
  const size_t PN = (size_t)P * N;

  load_tile<N, NT>(c_s, LDB, Cm + bt0 * N, N, T, tn, N, vec, tid);
  load_tile<N, NT>(b_s, LDB, Bm + bt0 * N, N, T, tn, N, vec, tid);
  cp_async_commit();
  for (int t = tid; t < T; t += NT)
    dt_s[t] = t < tn ? dt[(bt0 + t) * H + h] : 0.f;
  __syncthreads();
  if (warp == 0) {
    float cs[T / 32];
    warp_csum(dt_s, A[h], lane, cs);
#pragma unroll
    for (int i = 0; i < T / 32; ++i) cs_s[lane * (T / 32) + i] = cs[i];
  }
  const bf16* h_in = hparts + (((size_t)b * H + h) * nc + c) * 2 * PN;

  for (int pb = 0; pb < P; pb += PB) {
    const int pw = min(PB, P - pb);  // live columns of this block
    if (pb > 0) __syncthreads();     // every warp is done with x_s, h*_s
    load_tile<PB, NT>(x_s, LDX, x + bt0 * H * P + (size_t)h * P + pb,
                      (long long)H * P, T, tn, pw, vec, tid);
    if (c > 0) {                     // the carry-in's two parts
      load_tile<N, NT>(hh_s, LDB, h_in + (size_t)pb * N, N, PB, pw, N, true,
                       tid);
      load_tile<N, NT>(hl_s, LDB, h_in + PN + (size_t)pb * N, N, PB, pw, N,
                       true, tid);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();                 // c_s, b_s, x_s, h*_s, cs_s

    // the warp's two 16-row tiles of y, rows r0[0] and r0[1], and the last
    // k-step of each (-1: the tile lies past the sequence)
    const int r0[2] = {16 * warp, 16 * (7 - warp)};
    const int e0 = r0[0] < tn ? warp : -1, e1 = r0[1] < tn ? 7 - warp : -1;
    float acc[2][PB / 8][4];
    uint32_t cf[2][N / 16][4];       // C rows of each tile, all of N
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int n = 0; n < PB / 8; ++n)
        acc[hf][n][0] = acc[hf][n][1] = acc[hf][n][2] = acc[hf][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        ldmatrix_x4(cf[hf][kk], c_s + a_offset(lane, LDB, r0[hf], 16 * kk));
    }
    if (c > 0) {
      // carry-in: C H_in^T over N, H as [p][n] = the B operand's [n][k];
      // each H fragment serves both tiles
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int pp = 0; pp < PB / 16; ++pp) {
          uint32_t hf4[4], lf4[4];
          ldmatrix_x4(hf4, hh_s + b_offset(lane, LDB, 16 * pp, 16 * kk));
          ldmatrix_x4(lf4, hl_s + b_offset(lane, LDB, 16 * pp, 16 * kk));
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            mma(acc[hf][2 * pp], cf[hf][kk], hf4[0], hf4[1]);
            mma(acc[hf][2 * pp + 1], cf[hf][kk], hf4[2], hf4[3]);
            mma(acc[hf][2 * pp], cf[hf][kk], lf4[0], lf4[1]);
            mma(acc[hf][2 * pp + 1], cf[hf][kk], lf4[2], lf4[3]);
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float f0 = expf(cs_s[r0[hf] + g]);
        const float f1 = expf(cs_s[r0[hf] + g + 8]);
#pragma unroll
        for (int n = 0; n < PB / 8; ++n) {
          acc[hf][n][0] *= f0;
          acc[hf][n][1] *= f0;
          acc[hf][n][2] *= f1;
          acc[hf][n][3] *= f1;
        }
      }
    }
    // intra-chunk: k-steps of 16 positions s up to each tile's diagonal,
    // the two tiles' chains interleaved while both run
    int ks = 0;
    for (; ks <= min(e0, e1); ++ks)
      out_kstep<N, true, true>(acc, cf, b_s, x_s, cs_s, dt_s, r0, 16 * ks,
                               lane);
    for (int k = ks; k <= e0; ++k)
      out_kstep<N, true, false>(acc, cf, b_s, x_s, cs_s, dt_s, r0, 16 * k,
                                lane);
    for (int k = ks; k <= e1; ++k)
      out_kstep<N, false, true>(acc, cf, b_s, x_s, cs_s, dt_s, r0, 16 * k,
                                lane);
    // y rounded to bf16 once, staged in x_s (the warp's own 32 rows), then
    // stored as whole rows, 16 bytes a lane
    __syncthreads();                 // every warp is done reading x_s
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < PB / 8; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(x_s + (r0[hf] + g + 8 * hr) * LDX +
                                       8 * n + 2 * tq) =
              pack(acc[hf][n][2 * hr], acc[hf][n][2 * hr + 1]);
    __syncwarp();
    for (int i = lane; i < 32 * (PB / 8); i += 32) {
      const int rr = i / (PB / 8), ch = i - rr * (PB / 8);
      const int t = 16 * (rr < 16 ? warp : 7 - warp) + (rr & 15);
      if (t >= tn) continue;
      bf16* yr = y + ((bt0 + t) * H + h) * P + pb + 8 * ch;
      const bf16* src = x_s + t * LDX + 8 * ch;
      if (vec) {
        if (8 * ch < pw)
          *reinterpret_cast<uint4*>(yr) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * ch + j < pw) yr[j] = src[j];
      }
    }
  }
}

template <int N>
int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* scratch, int B, int S, int H,
                int P, cudaStream_t stream) {
  constexpr int LDB = N + PAD;
  const int nc = (S + T - 1) / T;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!aligned16({scratch})) return (int)cudaErrorMisalignedAddress;
  const int vec = P % 8 == 0 && aligned16({x, Bm, Cm, y});
  const size_t smem1 =
      sizeof(bf16) * (2 * T * (LDX + LDB) + NT_STATE / 32 * 2 * 16 *
                                                (16 * ((N / 16 + 1) / 2) +
                                                 PAD)) +
      sizeof(float) * (CG * T + CG);
  const size_t smem2 = sizeof(bf16) * (2 * T * LDB + T * LDX + 2 * PB * LDB) +
                       sizeof(float) * 2 * T;
  auto k1 = mamba2_scan_state_kernel<N>;
  auto k2 = mamba2_scan_chunk_out_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3((P + PB - 1) / PB, H, B), NT_STATE, smem1, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<bf16*>(scratch), S, H, P, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3(nc, H, B), NT, smem2, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(scratch),
      static_cast<bf16*>(y), S, H, P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// x, Bm, Cm, y: is_bf16 = 1 for bfloat16, 0 for float32; dt and A float32.
// scratch (bfloat16 only; float32 ignores it): bf16, B * H * nc * 2 * P *
// N elements with nc = ceil(S / 128), 16-byte aligned, from the caller's
// allocator.  State size N 16, 32, 64 or 128; anything else
// returns cudaErrorInvalidValue without launching (the Python wrapper
// checks first).
extern "C" int mamba2_scan_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, void* y, void* scratch,
                                  int B, int S, int H, int P, int N,
                                  int is_bf16, void* stream) {
  if (B < 0 || S < 0 || H < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (N != 16 && N != 32 && N != 64 && N != 128)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MAMBA2_CASE(NN)                                                     \
  case NN:                                                                  \
    return is_bf16 ? launch_bf16<NN>(x, dt, A, Bm, Cm, y, scratch, B, S, H, \
                                     P, s)                                  \
                   : launch_f32<NN>(x, dt, A, Bm, Cm, y, B, S, H, P, s)
  switch (N) {
    MAMBA2_CASE(16);
    MAMBA2_CASE(32);
    MAMBA2_CASE(64);
    MAMBA2_CASE(128);
  }
#undef MAMBA2_CASE
  return (int)cudaErrorInvalidValue;
}
