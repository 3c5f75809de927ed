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
// float32; every sum in float32, each output rounded once.  Every decay
// below is a product of w over a span of steps, never an exponential of a
// cumulative sum and never a quotient, so every factor stays in [0, 1]
// for any w in (0, 1]: nothing overflows (the chunked form's e^{-cw}, the
// JAX _rwkv6_chunked's, needs the model's clip of w >= 0.12) and nothing
// cancels.
//
// bfloat16: the chunked backward, in K7's own chunks of T = 64 steps, four
// launches (one launch count):
//  1. carries, grid (16 key channels x 64 value columns, head, 2 B): K7's
//     state scan (csrc/rwkv6_chunk.cuh state_scan) forward for blocks z <
//     B - each chunk's carry-in S_in = S_{c-1} - and in reverse for the
//     others: G_out, the adjoint at each chunk's last step from the later
//     chunks, G_out(c - 1) = diag(e^{cw_last}) G_out(c) + sum_t (r_t
//     e^{cw_{t-1}})^T dy_t, the same (16 x T) . (T x 64) product a chunk
//     with r and the prefix products of w in place of k and the suffix
//     products, dy in place of v.  Serial over the 32 chunks at S 2048.
//     Both carries go to bf16 scratch as two parts each.
//  2. dv, grid (chunk, head, sequence): the adjoint recurrence is the
//     forward one read backward with k -> r, v -> dy, so dv is K7's output
//     launch (rwkv6_chunk.cuh chunk_out) on the reversed chunk with r and
//     k swapped, dy as v and G_out as the carry-in: A^T dy between and
//     inside the sub-chunks, (k_s e^{cw_last - cw_s}) G_out, the bonus -
//     K7's arithmetic, its six fp32 operands as two bf16 parts.
//  3. dr, dk, dw and du's partials, grid (chunk, head, sequence), 8 warps
//     (rwkv6_bwd_chunk_kernel below).  On the tensor cores: P[m][t'] =
//     v_m . dy_t' (bf16 inputs, exact products), X = dy S_in^T and Y = v
//     G_out^T (the carries as two parts).  Then on the CUDA cores, per key
//     channel c, H_t'(m) = (S_{m-1} dy_t')[c] for every pair m <= t':
//     H(0) = X, H(m + 1) = w_m H(m) + k_m P[m][.]; dr_m = H_m(m) + bonus,
//       dw_m = sum_{t' > m} E_t'(m) r_t' H_t'(m) + e_m (S_{m-1} . G_out)
//       dk_m = sum_{t' > m} E_t'(m) r_t' P[m][t'] + e_m Y_m + bonus,
//     E_t'(m) = prod_{q=m+1}^{t'-1} w_q, e_m = prod_{q>m} w_q: dw_m is
//     S_{m-1}[c] . G_m[c] summed pair by pair (s < m < t', each a product
//     of w over a span that leaves w_m out), not GLA's d log w - the
//     reverse cumulative sum of r dr - k dk, divided by w - whose
//     difference of two sums growing over the chunk loses float32 digits,
//     ~1000x at w = 1e-3 (tests/test_torch_rwkv6_bwd_parts.py).  Warps 2j,
//     2j + 1 own the steps t' of the chunk's 16-step block j and 32 key
//     channels, a lane one channel with H, r, w of its 16 steps in
//     registers; the m steps go in four groups of 16: in group i < j a
//     warp adds its block whole (a dot over its 16 steps, the decay from
//     the block's start), in group j the pairs inside the block (Horner
//     sums from step m + 1 up), and after each group the blocks' sums meet
//     in a fixed order, scaled by the products of w between them.
//  4. du: the (sequence, chunk) partials summed in a fixed order.
// The kernel's arithmetic is kernels/ref.py rwkv6_scan_bwd_chunk_parallel.
// No atomics: every run gives the same bits.
//
// What bounds it: at rwkv6's training shape (B 4, S 2048, H 32, K = V =
// 64, bf16) the function must move ~369 MB (~110 us at 3.35 TB/s): r, k,
// v and dy read and dr, dk, dv written in bf16, w read and dw written in
// float32 (launch/cost.py k7_bwd_work), bytes first.  The design adds 134
// MB of carries (written by launch 1, read by launches 2 and 3) and reads
// r, k, w and dy twice; launch 3's pair sums are ~3-4 GFLOP on the CUDA
// cores, launches 1-3 ~35 GFLOP of mma.sync with the parts.  On the card
// (PERF.md: H100 80GB HBM3, 700 W) it takes ~0.94 ms, 8.6x its bound:
// launch 1 ~0.22 (K7's state scan, twice, a latency-bound chain of 16
// steps a block), launch 2 ~0.18 (K7's output launch at B 4), launch 3
// ~0.49 - one block an SM (127 KB of shared memory), its ~80 KB of loads
// a block with no work in flight (~0.15 ms), its pair sums on the CUDA
// cores ~0.27.  The float32 path's design, once this kernel's for both
// dtypes - every block walking all 2048 steps in order, with ~0.5 GB of
// saved states and dv partials - took 2.5-2.6 ms there.  The way on: launch
// 3's whole-block dots and each block's starting H as tensor-core
// products, leaving the CUDA cores the sums inside a block, and its loads
// under another block's work.
//
// float32 keeps that recurrence on the CUDA cores (TF32 products would
// miss the 1e-5 float32 bar), three launches (one launch count):
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "rwkv6_chunk.cuh"
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


// ---------------------------------------------------------------------------
// bfloat16: the chunked backward on the tensor cores and the CUDA cores
// ---------------------------------------------------------------------------

namespace rc = rwkv6_chunk;
using mma_bf16::PAD;

constexpr int NT_CHUNK = 256;   // threads of launch 3: 8 warps
constexpr int NB = rc::NSUB;    // 16-step blocks of a chunk

// Launch 1, the carries: grid ((K / 16) x ceil(V / 64), H, 2 B) - blocks z
// < B the forward state scan of sequence z (each chunk's S_in, K7's launch
// 1), blocks z >= B the adjoint's scan of sequence z - B, in reverse (each
// chunk's G_out).  The two are independent, so they run side by side.
__global__ void __launch_bounds__(rc::NT1) rwkv6_bwd_states_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ w,
    const bf16* __restrict__ dy, bf16* __restrict__ sparts,
    bf16* __restrict__ gparts, int B, int S, int H, int K, int V, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  if (z < B)
    rc::state_scan<false>(k, v, w, sparts, S, H, K, V, vec, blockIdx.x,
                          blockIdx.y, z, smem_raw);
  else
    rc::state_scan<true>(r, dy, w, gparts, S, H, K, V, vec, blockIdx.x,
                         blockIdx.y, z - B, smem_raw);
}

// Launch 2, dv: grid (nc, H, B), K7's output launch on the reversed chunk
// (rwkv6_chunk.cuh chunk_out<K, true>) with r and k swapped, dy as v and
// G_out as the carry-in.
template <int K>
__global__ void __launch_bounds__(rc::NT2, 2) rwkv6_bwd_dv_chunk_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ u,
    const bf16* __restrict__ dy, const bf16* __restrict__ gparts,
    bf16* __restrict__ dv, int S, int H, int V, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rc::chunk_out<K, true>(k, r, dy, w, u, gparts, dv, S, H, V, vec, smem_raw);
}

// Shared memory of launch 3, bytes.
template <int K>
constexpr size_t chunk_smem() {
  return sizeof(bf16) * (2 * rc::T * (K + PAD) + 2 * rc::T * rc::LDV +
                         4 * K * rc::LDV) +
         sizeof(float) * (rc::T * (K + 8) + rc::T * (rc::T + 4) +
                          rc::T * (K + 4) + 2 * NB * K + 3 * K);
}

// Launch 3: grid (chunk c, head h, sequence b), 8 warps.  The block loads
// the chunk's r, k, v, dy, w, u and its carries S_in, G_out (two parts
// each), then:
//  - tensor cores, warp (row tile rt = warp / 2, column half): P[m][t'] =
//    v_m . dy_t' for the blocks t' >= m, X = dy S_in^T and Y = v G_out^T
//    (hi and lo products into one accumulator), and on the CUDA cores
//    Z[c] = S_in[c] . G_out[c];
//  - CUDA cores, warp (block jb = warp / 2, channels 32 (warp % 2) + lane):
//    the lane holds r, w and H_t' of its channel and the block's 16 steps
//    t' in registers (H from X).  The steps m go in groups of 16, one per
//    block; in group i:
//      jb > i: the block whole - dkf = sum_t' coef_t' P[m][t'] with coef_t'
//        = r_t' prod_{q=16 jb}^{t'-1} w_q, and dwf(m) = sum_t' coef_t'
//        H_t'(m), carried as dwf(m + 1) = w_m dwf(m) + k_m dkf(m) - each
//        times the products of the whole blocks between i and jb;
//      jb = i: the pairs inside the block, t' > m, as Horner sums, plus
//        the carry terms e_m (S_{m-1} . G_out) (its own recurrence from
//        Z) and e_m Y_m, the bonuses, dr_m = H_m(m) + u k_m P[m][m], and
//        du's partial;
//    then H(m + 1) = w_m H(m) + k_m P[m][.].  After the group, dw_m and
//    dk_m are the block's own sum plus prod_{q=m+1}^{end of i} w_q times
//    the later blocks' sums, added in a fixed order.
// A padded step (past S) has r = k = v = dy = 0 and w = 0: it reaches only
// terms that multiply a zero.
template <int K>
__global__ void __launch_bounds__(NT_CHUNK, 1) rwkv6_bwd_chunk_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const bf16* __restrict__ dy,
    const bf16* __restrict__ sparts, const bf16* __restrict__ gparts,
    bf16* __restrict__ dr, bf16* __restrict__ dk, float* __restrict__ dw,
    float* __restrict__ part_u, int S, int H, int V, int vec) {
  using namespace mma_bf16;
  constexpr int T = rc::T, SUB = rc::SUB, LDV = rc::LDV;
  constexpr int LDK = K + PAD;     // bf16 rows of r, k
  constexpr int LDF = K + 8;       // fp32 rows of w
  constexpr int LDX = K + 4;       // fp32 rows of X, Y
  constexpr int LDP = T + 4;       // fp32 rows of P
  static_assert(T * LDX * sizeof(float) <= 2 * T * LDV * sizeof(bf16),
                "X over v and dy");
  static_assert((2 * SUB * NB + SUB) * K * sizeof(float) <=
                    4 * K * LDV * sizeof(bf16),
                "the groups' sums over the carries");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* r_s = reinterpret_cast<bf16*>(smem_raw);   // T x LDK
  bf16* k_s = r_s + T * LDK;                       // T x LDK
  bf16* v_s = k_s + T * LDK;                       // T x LDV
  bf16* y_s = v_s + T * LDV;                       // T x LDV: dy
  bf16* sh_s = y_s + T * LDV;      // K x LDV: S_in [c][v], hi part
  bf16* sl_s = sh_s + K * LDV;     //   and lo part
  bf16* gh_s = sl_s + K * LDV;     // K x LDV: G_out, hi
  bf16* gl_s = gh_s + K * LDV;     //   and lo
  float* w_s = reinterpret_cast<float*>(gl_s + K * LDV);   // T x LDF
  float* p_s = w_s + T * LDF;      // T x LDP: P[m][t'] = v_m . dy_t'
  float* yy_s = p_s + T * LDP;     // T x LDX: Y[s][c] = (G_out v_s)[c]
  float* wt_s = yy_s + T * LDX;    // NB x K: each block's product of w
  float* du_s = wt_s + NB * K;     // NB x K: du's sums, per group
  float* u_s = du_s + NB * K;      // K
  float* z_s = u_s + K;            // K: Z = S_in . G_out
  float* hg_s = z_s + K;           // K: S_{m-1} . G_out, between groups
  // after the products: X over v and dy, the groups' sums over the carries
  float* x_s = reinterpret_cast<float*>(v_s);      // T x LDX: X[t'][c]
  float* sdw = reinterpret_cast<float*>(sh_s);     // SUB x NB x K
  float* sdk = sdw + SUB * NB * K;                 // SUB x NB x K
  float* sqx = sdk + SUB * NB * K;                 // SUB x K

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * T, tn = min(T, S - t0);
  const size_t bt0 = (size_t)b * S + t0;
  const size_t KV = (size_t)K * V;
  const long long HK = (long long)H * K, HV = (long long)H * V;
  const bool has_h = c > 0, has_g = c < nc - 1;
  const size_t po = (((size_t)b * H + h) * nc + c) * 2 * KV;

  load_tile<K, NT_CHUNK>(r_s, LDK, r + (bt0 * H + h) * K, HK, T, tn, K, vec,
                         tid);
  load_tile<K, NT_CHUNK>(k_s, LDK, k + (bt0 * H + h) * K, HK, T, tn, K, vec,
                         tid);
  load_tile<rc::VB, NT_CHUNK>(v_s, LDV, v + (bt0 * H + h) * V, HV, T, tn, V,
                              vec, tid);
  load_tile<rc::VB, NT_CHUNK>(y_s, LDV, dy + (bt0 * H + h) * V, HV, T, tn,
                              V, vec, tid);
  rc::load_rows_f32<K, NT_CHUNK, false>(w_s, LDF, w + (bt0 * H + h) * K,
                                        w + (bt0 * H + h) * K, HK, T, 0, tn,
                                        vec, tid);
  if (has_h) {
    load_tile<rc::VB, NT_CHUNK>(sh_s, LDV, sparts + po, V, K, K, V, vec, tid);
    load_tile<rc::VB, NT_CHUNK>(sl_s, LDV, sparts + po + KV, V, K, K, V, vec,
                                tid);
  }
  if (has_g) {
    load_tile<rc::VB, NT_CHUNK>(gh_s, LDV, gparts + po, V, K, K, V, vec, tid);
    load_tile<rc::VB, NT_CHUNK>(gl_s, LDV, gparts + po + KV, V, K, K, V, vec,
                                tid);
  }
  cp_async_commit();
  for (int i = tid; i < K; i += NT_CHUNK) u_s[i] = u[(size_t)h * K + i];
  cp_async_wait_all();
  __syncthreads();

  // ---- tensor cores: P, X, Y; Z on the CUDA cores ----
  const int rt = warp >> 1, half = warp & 1, r0 = 16 * rt;
  float xx[4][4], yy[4][4], px[2][2][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) xx[n][e] = yy[n][e] = 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) px[q][j][e] = 0.f;
  for (int ks = 0; ks < V / 16; ++ks) {
    uint32_t ad[4], av[4];
    ldmatrix_x4(ad, y_s + a_offset(lane, LDV, r0, 16 * ks));
    ldmatrix_x4(av, v_s + a_offset(lane, LDV, r0, 16 * ks));
#pragma unroll
    for (int np = 0; np < 2; ++np) {       // the warp's 16-channel pairs
      const int n0 = 32 * half + 16 * np;
      if (n0 >= K) break;
      if (has_h) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, sh_s + b_offset(lane, LDV, n0, 16 * ks));
        ldmatrix_x4(bl, sl_s + b_offset(lane, LDV, n0, 16 * ks));
        mma(xx[2 * np], ad, bh[0], bh[1]);
        mma(xx[2 * np + 1], ad, bh[2], bh[3]);
        mma(xx[2 * np], ad, bl[0], bl[1]);
        mma(xx[2 * np + 1], ad, bl[2], bl[3]);
      }
      if (has_g) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, gh_s + b_offset(lane, LDV, n0, 16 * ks));
        ldmatrix_x4(bl, gl_s + b_offset(lane, LDV, n0, 16 * ks));
        mma(yy[2 * np], av, bh[0], bh[1]);
        mma(yy[2 * np + 1], av, bh[2], bh[3]);
        mma(yy[2 * np], av, bl[0], bl[1]);
        mma(yy[2 * np + 1], av, bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {          // P's blocks tb >= rt
      const int tb = rt + half + 2 * q;
      if (tb >= NB) break;
      uint32_t bf[4];
      ldmatrix_x4(bf, y_s + b_offset(lane, LDV, 16 * tb, 16 * ks));
      mma(px[q][0], av, bf[0], bf[1]);
      mma(px[q][1], av, bf[2], bf[3]);
    }
  }
  {                                        // Z: 4 threads a channel
    const int ch = tid >> 2, qv = tid & 3;
    float zp = 0.f;
    if (has_h && has_g && ch < K) {
      for (int j = qv * (V / 4); j < (qv + 1) * (V / 4); ++j) {
        const int o = ch * LDV + j;
        zp = fmaf(__bfloat162float(sh_s[o]) + __bfloat162float(sl_s[o]),
                  __bfloat162float(gh_s[o]) + __bfloat162float(gl_s[o]), zp);
      }
    }
    zp += __shfl_xor_sync(0xffffffffu, zp, 1);
    zp += __shfl_xor_sync(0xffffffffu, zp, 2);
    if (qv == 0 && ch < K) z_s[ch] = zp;
  }
  __syncthreads();                         // v, dy and the carries are read
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = 32 * half + 8 * n + 2 * tq;
    if (col >= K) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = r0 + g + 8 * hr;
      *reinterpret_cast<float2*>(x_s + t * LDX + col) =
          make_float2(xx[n][2 * hr], xx[n][2 * hr + 1]);
      *reinterpret_cast<float2*>(yy_s + t * LDX + col) =
          make_float2(yy[n][2 * hr], yy[n][2 * hr + 1]);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int tb = rt + half + 2 * q;
    if (tb >= NB) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(p_s + (r0 + g + 8 * hr) * LDP + 16 * tb +
                                   8 * j + 2 * tq) =
            make_float2(px[q][j][2 * hr], px[q][j][2 * hr + 1]);
  }
  for (int i = tid; i < NB * K; i += NT_CHUNK) {   // each block's product
    const int ch = i % K, j = i / K;
    float pw = 1.f;
#pragma unroll
    for (int m = 0; m < SUB; ++m) pw *= w_s[(SUB * j + m) * LDF + ch];
    wt_s[j * K + ch] = pw;
  }
  __syncthreads();                         // X, Y, P, the products of w

  // ---- CUDA cores: the pairs ----
  const int jb = warp >> 1, ch = 32 * (warp & 1) + lane;
  const bool live_c = ch < K;
  const bool any = 32 * (warp & 1) < K;    // the warp has a live channel
  const int cc = live_c ? ch : 0;          // dead lanes read channel 0
  float rr[SUB], ww[SUB], hh[SUB], coef[SUB];
  float dwf = 0.f;                         // sum_t' coef_t' H_t'(m)
  {
    float run = 1.f;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = SUB * jb + i;
      rr[i] = __bfloat162float(r_s[t * LDK + cc]);
      ww[i] = w_s[t * LDF + cc];
      hh[i] = x_s[t * LDX + cc];
      coef[i] = rr[i] * run;
      run *= ww[i];
      dwf = fmaf(coef[i], hh[i], dwf);
    }
  }
  const float uc = u_s[cc];
  const int ngroups = (tn + SUB - 1) / SUB;
  for (int mb = 0; mb < ngroups; ++mb) {
    if (any && jb > mb) {
      // the blocks between mb and jb, whole
      float pwf = 1.f;
      for (int j = mb + 1; j < jb; ++j) pwf *= wt_s[j * K + cc];
#pragma unroll 2
      for (int i = 0; i < SUB; ++i) {
        const int m = SUB * mb + i;
        const float km = __bfloat162float(k_s[m * LDK + cc]);
        const float wm = w_s[m * LDF + cc];
        float p[SUB];
        rc::lds_f32(p, p_s + m * LDP + SUB * jb);
        float dkf = 0.f;
#pragma unroll
        for (int q = 0; q < SUB; ++q) dkf = fmaf(coef[q], p[q], dkf);
        if (live_c) {
          sdw[(i * NB + jb) * K + ch] = pwf * dwf;
          sdk[(i * NB + jb) * K + ch] = pwf * dkf;
        }
        dwf = fmaf(wm, dwf, km * dkf);
#pragma unroll
        for (int q = 0; q < SUB; ++q) hh[q] = fmaf(wm, hh[q], km * p[q]);
      }
    } else if (any && jb == mb) {
      // the blocks after mb, whole, for the carry terms
      float pw4 = 1.f;
      for (int j = mb + 1; j < NB; ++j) pw4 *= wt_s[j * K + cc];
      float hg = mb == 0 ? z_s[cc] : hg_s[cc];   // S_{m-1} . G_out
      float du = 0.f;
#pragma unroll
      for (int i0 = 0; i0 < SUB; ++i0) {
        const int m = SUB * mb + i0;
        const float km = __bfloat162float(k_s[m * LDK + cc]);
        const float wm = w_s[m * LDF + cc];
        const float ym = yy_s[m * LDX + cc];
        float p[SUB];
        rc::lds_f32(p, p_s + m * LDP + SUB * jb);
        const float vdy = p[i0];            // v_m . dy_m
        // the pairs inside the block, t' = m + 1 .. its end, and the
        // product of w over them
        float adw = 0.f, adk = 0.f, qx = 1.f;
#pragma unroll
        for (int i = SUB - 1; i > i0; --i) {
          adw = fmaf(ww[i], adw, rr[i] * hh[i]);
          adk = fmaf(ww[i], adk, rr[i] * p[i]);
          qx *= ww[i];
        }
        const float e = qx * pw4;           // prod_{q > m} w_q
        if (live_c) {
          sdw[(i0 * NB + jb) * K + ch] = fmaf(e, hg, adw);
          sdk[(i0 * NB + jb) * K + ch] =
              fmaf(e, ym, fmaf(rr[i0] * uc, vdy, adk));
          sqx[i0 * K + ch] = qx;
          if (m < tn)
            dr[((bt0 + m) * H + h) * K + ch] =
                __float2bfloat16(fmaf(uc * km, vdy, hh[i0]));
        }
        du = fmaf(rr[i0] * km, vdy, du);
        hg = fmaf(wm, hg, km * ym);
#pragma unroll
        for (int i = i0 + 1; i < SUB; ++i) hh[i] = fmaf(wm, hh[i], km * p[i]);
      }
      if (live_c) {
        hg_s[ch] = hg;
        du_s[mb * K + ch] = du;
      }
    }
    __syncthreads();                       // the group's sums
    // dw_m, dk_m: the block's own sum, then prod_{q=m+1}^{end of mb} w_q
    // times the later blocks' sums, in order
    for (int x = tid; x < SUB * K; x += NT_CHUNK) {
      const int i = x / K, cx = x - i * K, m = SUB * mb + i;
      if (m >= tn) continue;
      float sw = 0.f, sk = 0.f;
      for (int j = mb + 1; j < NB; ++j) {
        sw += sdw[(i * NB + j) * K + cx];
        sk += sdk[(i * NB + j) * K + cx];
      }
      const float qx = sqx[i * K + cx];
      const size_t o = ((bt0 + m) * H + h) * K + cx;
      dw[o] = fmaf(qx, sw, sdw[(i * NB + mb) * K + cx]);
      dk[o] = __float2bfloat16(fmaf(qx, sk, sdk[(i * NB + mb) * K + cx]));
    }
    __syncthreads();                       // the sums are read
  }
  // du's partial of the chunk, per channel
  for (int i = tid; i < K; i += NT_CHUNK) {
    float s = 0.f;
    for (int mb = 0; mb < ngroups; ++mb) s += du_s[mb * K + i];
    part_u[(((size_t)b * nc + c) * H + h) * K + i] = s;
  }
}

template <int K>
int launch_bf16(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* dy, void* dr, void* dk, void* dv,
                void* dw, void* du, void* carries, void* part_u, int B,
                int S, int H, int V, cudaStream_t stream) {
  const int nc = (S + rc::T - 1) / rc::T;
  if (H > 65535 || 2 * B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!mma_bf16::aligned16({carries})) return (int)cudaErrorMisalignedAddress;
  const int vec = V % 8 == 0 && mma_bf16::aligned16({r, k, v, w, dy, dv});
  bf16* sparts = static_cast<bf16*>(carries);
  bf16* gparts = sparts + (size_t)B * H * nc * 2 * K * V;
  const size_t smem1 = rc::state_smem(), smem2 = rc::out_smem<K>();
  const size_t smem3 = chunk_smem<K>();
  auto k1 = rwkv6_bwd_states_kernel;
  auto k2 = rwkv6_bwd_dv_chunk_kernel<K>;
  auto k3 = rwkv6_bwd_chunk_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  if (nc > 1) {
    k1<<<dim3(K / rc::KB * ((V + rc::VB - 1) / rc::VB), H, 2 * B), rc::NT1,
         smem1, stream>>>(
        static_cast<const bf16*>(r), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(w),
        static_cast<const bf16*>(dy), sparts, gparts, B, S, H, K, V, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k2<<<dim3(nc, H, B), rc::NT2, smem2, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const bf16*>(dy), gparts, static_cast<bf16*>(dv), S, H, V,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3<<<dim3(nc, H, B), NT_CHUNK, smem3, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const bf16*>(dy), sparts,
      gparts, static_cast<bf16*>(dr), static_cast<bf16*>(dk),
      static_cast<float*>(dw), static_cast<float*>(part_u), S, H, V, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_du_kernel<<<(H * K + NT_RED - 1) / NT_RED, NT_RED, 0, stream>>>(
      static_cast<const float*>(part_u), static_cast<float*>(du), B * nc,
      H * K);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes: the launches above on `stream`.
// Returns a cudaError_t (0 = launched).  r, k, v, dy, dr, dk, dv: is_bf16
// = 1 for bfloat16, 0 for float32; w, u, dw, du float32.  Scratch from the
// caller's allocator (kernels/rwkv6_scan.py bwd_scratch):
//   bfloat16, with nc = ceil(S / 64): ckpt bf16, 2 * B * H * nc * 2 * K *
//     V elements (each chunk's S_in, then its G_out, each as two parts),
//     16-byte aligned; part_v unused; part_u float32, B * nc * H * K (du's
//     partials per sequence and chunk).
//   float32, with nck = ceil(S / 16): ckpt float32, B * H * nck * K * V
//     (the saved states); part_v float32, B * S * H * (K / 16) * V (dv's
//     partials per key block); part_u float32, B * H * K (du's partials
//     per sequence).
// Key size K 16, 32 or 64, value size V 16, 32 or 64; anything else
// returns cudaErrorInvalidValue without launching (the Python wrapper
// checks first).
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
  if (is_bf16) {
#define RWKV6_BWD_BF16(KK)                                                  \
  case KK:                                                                  \
    return launch_bf16<KK>(r, k, v, w, u, dy, dr, dk, dv, dw, du, ckpt,     \
                           part_u, B, S, H, V, s)
    switch (K) {
      RWKV6_BWD_BF16(16);
      RWKV6_BWD_BF16(32);
      RWKV6_BWD_BF16(64);
    }
#undef RWKV6_BWD_BF16
    return (int)cudaErrorInvalidValue;
  }
#define RWKV6_BWD_F32(VV)                                                   \
  case VV:                                                                  \
    return launch<float, VV>(r, k, v, w, u, dy, dr, dk, dv, dw, du, ckpt,   \
                             part_v, part_u, B, S, H, K, s)
  switch (V) {
    RWKV6_BWD_F32(16);
    RWKV6_BWD_F32(32);
    RWKV6_BWD_F32(64);
  }
#undef RWKV6_BWD_F32
  return (int)cudaErrorInvalidValue;
}
