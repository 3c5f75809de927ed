// The chunked Mamba2 (SSD) state scan shared by K6's bf16 forward
// (csrc/mamba2_scan.cu) and its backward (csrc/mamba2_scan_bwd.cu): the
// inclusive cumulative sum of the log decays over a chunk, and the scan
// serial over the chunks that leaves each chunk's carry as two bf16 parts.
//
// Forward (REV = false): the carry-in state of chunk c, H_{c-1}, with
// H_c = e_c H_{c-1} + sum_s (x_s w_s) outer B_s, w_s = exp(csum_last -
// csum_s) dt_s, e_c = exp(csum_last), H_{-1} = 0.
// Reverse (REV = true, the backward's adjoint): the adjoint at chunk c's
// end from the later chunks, G_c, with G_{c-1} = e_c G_c + sum_t (dy_t
// exp(csum_t)) outer C_t, G_last = 0 - the same product with x -> dy, B ->
// C and other weights, walked from the last chunk.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mamba2_chunk {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int T = 128;          // chunk: time steps
constexpr int PB = 64;          // head columns p per block of work
constexpr int NT_STATE = 256;   // threads of the state scan: 8 warps
constexpr int LDX = PB + PAD;   // padded shared-memory rows of x
constexpr int CG = 16;          // chunks whose weights the state scan
                                // computes at once

// One warp: the inclusive cumulative sum of -dt * a over a chunk's T steps
// (dt_s, 0 past the sequence), lane l's steps 4l .. 4l + 3 into cs (in
// order, then a shuffle scan of the lanes' totals: a fixed order, so every
// kernel gets the same bits).  Returns the sum over the chunk, csum_last.
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

// Shared memory of state_scan<N>, bytes.
template <int N>
constexpr size_t state_smem() {
  return sizeof(bf16) * (2 * T * (LDX + N + PAD) +
                         NT_STATE / 32 * 2 * 16 * (16 * ((N / 16 + 1) / 2) +
                                                   PAD)) +
         sizeof(float) * (CG * T + CG);
}

// The scan of one (64-row block pb of P, head h, sequence b), NT_STATE
// threads.  xs: x (forward) or dy (reverse), (B, S, H, P); bs: B or C, (B,
// S, N); parts: [B][H][nc][2][P][N] bf16, each chunk's carry (hi, then lo;
// the first chunk walked - chunk 0 forward, the last in reverse - has a
// zero carry, neither written nor read).
//
// The block walks the chunks in order, keeping its rows of the running
// fp32 carry in registers: warp w owns the 16 rows p of m-tile w % 4 and
// every other 16-column pair of N from w / 4.  So that a chunk's step is
// one barrier and a chain of products, the weights come first: for CG
// chunks at a time, warp k computes chunk k's csum, its weights and
// exp(csum_last) into shared memory.  Then per chunk, the next chunk's
// operands in flight (cp.async, two buffers): each warp stores its part of
// the carry as two bf16 parts - staged in its own shared-memory rows so
// that the stores are whole 32-byte sectors - computes the chunk's
// contribution (xs w)^T bs with A = (xs w)^T built in registers as two
// parts (hi and lo products in separate accumulators, two short chains in
// place of one long one) and bs through ldmatrix.trans, and updates the
// carry = exp(csum_last) carry + contribution.
template <int N, bool REV>
__device__ __forceinline__ void state_scan(
    const bf16* __restrict__ xs, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ bs_g,
    bf16* __restrict__ parts, int S, int H, int P, int vec, int pb, int h,
    int b, unsigned char* smem_raw) {
  constexpr int LDB = N + PAD;
  constexpr int NW = NT_STATE / 32;
  constexpr int NPAIR = N / 16;          // 16-column pairs of n-tiles
  constexpr int MYP = (NPAIR + 1) / 2;   // most pairs a warp owns
  constexpr int LDH = 16 * MYP + PAD;    // a warp's staging rows
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);            // 2 x T x LDX
  bf16* b_s = x_s + 2 * T * LDX;                            // 2 x T x LDB
  bf16* hs_s = b_s + 2 * T * LDB;        // per warp: 2 x 16 x LDH
  float* w_s = reinterpret_cast<float*>(hs_s + NW * 2 * 16 * LDH);
  float* e_s = w_s + CG * T;             // CG decays

  const int nc = (S + T - 1) / T, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), grp = warp >> 2;
  const int pw = min(PB, P - pb);        // live rows of this block
  const bool mine = m0 < pw && grp < NPAIR;
  const float a = A[h];
  const size_t PN = (size_t)P * N;
  bf16* my_s = hs_s + warp * 2 * 16 * LDH;
  // the chunk walked at step i
  auto chunk = [&](int i) { return REV ? nc - 1 - i : i; };

  auto load = [&](int i) {
    const int buf = i & 1, t0 = chunk(i) * T, tn = min(T, S - t0);
    const size_t bt0 = (size_t)b * S + t0;
    load_tile<PB, NT_STATE>(x_s + buf * T * LDX, LDX,
                            xs + bt0 * H * P + (size_t)h * P + pb,
                            (long long)H * P, T, tn, pw, vec, tid);
    load_tile<N, NT_STATE>(b_s + buf * T * LDB, LDB, bs_g + bt0 * N, N, T,
                           tn, N, vec, tid);
  };

  float st[MYP][2][4];                   // this warp's part of the carry
#pragma unroll
  for (int i = 0; i < MYP; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      st[i][j][0] = st[i][j][1] = st[i][j][2] = st[i][j][3] = 0.f;
  load(0);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    const int c = chunk(i);
    const int buf = i & 1, tn = min(T, S - c * T), cw = i % CG;
    if (cw == 0) {       // the weights of steps i .. i + CG - 1
      __syncthreads();   // every warp is done with the previous group's
      for (int k = warp; k < CG && i + k < nc; k += NW) {
        const int t0 = chunk(i + k) * T, kn = min(T, S - t0);
        float* wk = w_s + k * T;
#pragma unroll
        for (int q = 0; q < T / 32; ++q) {
          const int t = lane * (T / 32) + q;
          wk[t] = t < kn ? dt[((size_t)b * S + t0 + t) * H + h] : 0.f;
        }
        __syncwarp();
        float cs[T / 32];
        const float last = warp_csum(wk, a, lane, cs);
        __syncwarp();
#pragma unroll
        for (int q = 0; q < T / 32; ++q) {
          const int t = lane * (T / 32) + q;
          wk[t] = REV ? (t < kn ? expf(cs[q]) : 0.f)
                      : expf(last - cs[q]) * wk[t];
        }
        if (lane == 0) e_s[k] = expf(last);
      }
    }
    cp_async_wait_all();
    __syncthreads();     // step i (and its weights) landed; every warp is
                         // done with step i - 1's buffer
    if (i + 1 < nc) load(i + 1);
    cp_async_commit();
    if (!mine) continue;
    if (i > 0) {         // the chunk's carry, as two bf16 parts
#pragma unroll
      for (int q = 0; q < MYP; ++q) {
        if (grp + 2 * q >= NPAIR) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int o = (g + 8 * hr) * LDH + 16 * q + 8 * j + 2 * tq;
            split2(st[q][j][2 * hr], st[q][j][2 * hr + 1],
                   *reinterpret_cast<uint32_t*>(my_s + o),
                   *reinterpret_cast<uint32_t*>(my_s + 16 * LDH + o));
          }
      }
      __syncwarp();
      // 16-byte stores: 2 parts x 16 rows x 2 per pair
      bf16* dst = parts + (((size_t)b * H + h) * nc + c) * 2 * PN +
                  (size_t)(pb + m0) * N;
      for (int k = lane; k < 2 * 16 * 2 * MYP; k += 32) {
        const int part = k / (32 * MYP), r = (k / (2 * MYP)) % 16;
        const int q = (k % (2 * MYP)) / 2, half = k & 1;
        const int np = grp + 2 * q;
        if (np < NPAIR && pb + m0 + r < P)
          *reinterpret_cast<uint4*>(dst + part * PN + (size_t)r * N +
                                    16 * np + 8 * half) =
              *reinterpret_cast<const uint4*>(my_s + part * 16 * LDH +
                                              r * LDH + 16 * q + 8 * half);
      }
    }
    float dh[MYP][2][4], dl[MYP][2][4];  // hi and lo parts' products
#pragma unroll
    for (int q = 0; q < MYP; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) dh[q][j][k] = dl[q][j][k] = 0.f;
    const bf16* xb = x_s + buf * T * LDX;
    const bf16* bb = b_s + buf * T * LDB;
    const float* ws = w_s + cw * T;
#pragma unroll
    for (int ks = 0; ks < T / 16; ++ks) {
      if (16 * ks >= tn) break;
      const int s0 = 16 * ks;
      // A[p][s] = xs[s][p] w[s]: a0 (g, 2tq..+1), a1 (g + 8, 2tq..+1),
      // a2 (g, 2tq + 8..+9), a3 (g + 8, 2tq + 8..+9)
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pr = m0 + g + 8 * (q & 1);
        const int sc = s0 + 2 * tq + 8 * (q >> 1);
        split2(__bfloat162float(xb[sc * LDX + pr]) * ws[sc],
               __bfloat162float(xb[(sc + 1) * LDX + pr]) * ws[sc + 1],
               ahi[q], alo[q]);
      }
#pragma unroll
      for (int q = 0; q < MYP; ++q) {
        const int np = grp + 2 * q;
        if (np >= NPAIR) continue;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bb + bt_offset(lane, LDB, s0, 16 * np));
        mma(dh[q][0], ahi, bf[0], bf[1]);
        mma(dh[q][1], ahi, bf[2], bf[3]);
        mma(dl[q][0], alo, bf[0], bf[1]);
        mma(dl[q][1], alo, bf[2], bf[3]);
      }
    }
    const float e = e_s[cw];
#pragma unroll
    for (int q = 0; q < MYP; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          st[q][j][k] = fmaf(e, st[q][j][k], dh[q][j][k] + dl[q][j][k]);
  }
  cp_async_wait_all();
}

}  // namespace mamba2_chunk
