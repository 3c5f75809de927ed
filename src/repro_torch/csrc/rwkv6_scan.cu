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
// exps of cw differences).  Two launches, one launch count:
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
// bfloat16: the chunk-parallel form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int T = 64;           // chunk: time steps
constexpr int SUB = 16;         // sub-chunk: time steps (one m-tile)
constexpr int NSUB = T / SUB;   // sub-chunks of a chunk
constexpr int NPAIR = NSUB * (NSUB - 1) / 2;  // sub-chunk pairs j < i
constexpr int VB = 64;          // value columns per block of work
constexpr int LDV = VB + PAD;   // padded shared-memory rows of v and S
constexpr int NT1 = 128;        // threads of the state scan: 4 warps
constexpr int NT2 = 256;        // of the output: 8 warps, 2 a sub-chunk
constexpr int KB = 16;          // key channels per state-scan block
constexpr int LDKB = KB + PAD;  // its padded bf16 rows of k
constexpr int LDWB = KB + 4;    // and fp32 rows of w and the decays
constexpr int SEG = 8;          // time steps of a suffix-product segment
constexpr int CPS = 2;          // chunks a state-scan step
constexpr int NSTAGE = 2;       // the state scan's cp.async buffers
constexpr int LDA = SUB + 8;    // fp32 rows of a diagonal block
static_assert(NT1 == KB * (T / SEG), "a state-scan thread per segment");
static_assert(NSUB == 4, "the output kernel's warps and pairs assume 4");

// two neighbouring bf16 / fp32 values of a shared-memory row as floats
// (an even element offset: one 4- or 8-byte load)
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// N neighbouring bf16 / fp32 values of a shared-memory row as floats, in
// 16-byte loads where N allows (p aligned to the load)
template <int N>
__device__ __forceinline__ void lds_bf16(float (&o)[N], const bf16* p) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[j]));
        o[8 * i + 2 * j] = f.x;
        o[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = ld_bf2(p + 2 * i);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void lds_f32(float (&o)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = f.x;
      o[4 * i + 1] = f.y;
      o[4 * i + 2] = f.z;
      o[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = ld_f2(p + 2 * i);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// wait until at most N committed cp.async groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Scratch (bf16): each chunk's carry-in state S_{c-1} as two parts at
// [B][H][nc][2][K][V] (hi, then lo); chunk 0's slot (a zero state) is
// neither written nor read.

// a (rows x COLS) fp32 tile of a row-major global array into shared
// memory, as load_tile (csrc/mma_bf16.cuh) does for bf16: 4 values per
// 16-byte chunk
template <int COLS, int NTH>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src,
                                              long long gstride, int rows,
                                              int nrows, bool vec, int tid) {
  constexpr int CPR = COLS / 4;
  for (int i = tid; i < rows * CPR; i += NTH) {
    const int r = i / CPR, c = i - r * CPR;
    float* d = dst + r * ld + c * 4;
    const bool live = r < nrows;
    if (vec) {
      cp_async16(d, live ? src + r * gstride + c * 4 : src, live);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = live ? src[r * gstride + c * 4 + j] : 0.f;
    }
  }
}

// Launch 1, the state scan: grid ((K / 16) x ceil(V / 64), H, B), 4 warps.
// The block owns key channels c0 .. c0 + 15 and value columns vb .. vb +
// 63 of one (sequence, head) and walks the chunks in order, CPS chunks a
// step, warp w holding columns vb + 16 w .. + 15 of the running fp32 state
// in registers.  Per step (k, w and v of its chunks in two cp.async
// buffers, the next step in flight): thread (channel, 8-step segment)
// forms its segments' suffix products and totals; each warp computes the
// step's contributions dS = k_out^T v, k_out = k times the suffix product
// times the later segments' totals, with A = k_out^T built in registers as
// two parts and v through ldmatrix.trans (hi and lo products in separate
// accumulators; the chunks' chains independent), and then, chunk by
// chunk, stages its part of S (the chunk's carry-in) as two bf16 parts
// and updates S = e^{cw_last} S + dS; the staged states go out as whole
// rows after the next barrier.  The last chunk's contribution is never
// read, so its inputs are not loaded.
__global__ void __launch_bounds__(NT1) rwkv6_scan_state_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, bf16* __restrict__ sparts, int S, int H,
    int K, int V, int vec) {
  constexpr int NSEG = T / SEG;
  constexpr int ST = CPS * T;            // time steps of a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);      // NSTAGE x ST x LDKB
  bf16* v_s = k_s + NSTAGE * ST * LDKB;               // NSTAGE x ST x LDV
  bf16* o_s = v_s + NSTAGE * ST * LDV;   // (CPS + 1) x 2 x KB x LDV:
                                         // staged carry-ins
  float* w_s = reinterpret_cast<float*>(o_s + (CPS + 1) * 2 * KB * LDV);
  float* q_s = w_s + NSTAGE * ST * LDWB;  // ST x LDWB: segment suffixes
  float* wt_s = q_s + ST * LDWB;          // CPS x NSEG x KB: their totals

  const int nkb = K / KB;
  const int c0 = (blockIdx.x % nkb) * KB, vb = (blockIdx.x / nkb) * VB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + T - 1) / T, tid = threadIdx.x;
  const int nwork = nc - 1;              // chunks whose contribution is read
  const int nstep = (nwork + CPS - 1) / CPS;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = 16 * warp;              // the warp's columns, from vb
  const int vw = min(VB, V - vb);        // live columns of this block
  const bool mine = n0 < vw;
  const size_t KV = (size_t)K * V;
  const long long HK = (long long)H * K;
  bf16* dst0 = sparts + ((size_t)b * H + h) * nc * 2 * KV + (size_t)c0 * V +
               vb;

  auto load = [&](int m) {               // the work chunks of step m
    const int buf = m % NSTAGE, cn = min(CPS, nwork - CPS * m);
    const size_t bt0 = (size_t)b * S + (size_t)m * ST;
    load_tile<KB, NT1>(k_s + buf * ST * LDKB, LDKB,
                       k + (bt0 * H + h) * K + c0, HK, ST, cn * T, KB, vec,
                       tid);
    load_tile_f32<KB, NT1>(w_s + buf * ST * LDWB, LDWB,
                           w + (bt0 * H + h) * K + c0, HK, ST, cn * T, vec,
                           tid);
    load_tile<VB, NT1>(v_s + buf * ST * LDV, LDV, v + (bt0 * H + h) * V + vb,
                       (long long)H * V, ST, cn * T, vw, vec, tid);
  };
  // the staged carry-ins of chunks c .. c + n - 1 to scratch, whole rows
  auto store = [&](int c, int n) {
    for (int i = tid; i < n * 2 * KB * (VB / 8); i += NT1) {
      const int cp = i / (KB * (VB / 8)), row = (i / (VB / 8)) % KB;
      const int col = 8 * (i % (VB / 8));
      if (col >= vw) continue;
      const bf16* src = o_s + cp * KB * LDV + row * LDV + col;
      bf16* d = dst0 + (size_t)(c + cp / 2) * 2 * KV + (cp & 1) * KV +
                (size_t)row * V + col;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (col + x < vw) d[x] = src[x];
      }
    }
  };

  float st[2][4];                        // S: 16 channels x 16 columns
#pragma unroll
  for (int j = 0; j < 2; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
  // one commit group per step, empty or not
#pragma unroll
  for (int m = 0; m < NSTAGE - 1; ++m) {
    if (m < nstep) load(m);
    cp_async_commit();
  }
  // the carry-ins staged in o_s, of chunks first .. first + staged - 1
  int first = 1, staged = 0;
  for (int m = 0; m < nstep; ++m) {
    const int buf = m % NSTAGE, cn = min(CPS, nwork - CPS * m);
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();       // step m landed; every warp is done with step
                           // m - 1 (its buffer, q_s and wt_s); o_s staged
    if (staged) store(first, staged);
    if (m + NSTAGE - 1 < nstep) load(m + NSTAGE - 1);
    cp_async_commit();
    const bf16* ks = k_s + buf * ST * LDKB;
    const float* ws = w_s + buf * ST * LDWB;
    const bf16* vs = v_s + buf * ST * LDV;
    {                      // thread (channel, segment): suffix products
      const int ch = tid % KB, sg = tid / KB;
#pragma unroll
      for (int j = 0; j < CPS; ++j) {
        float q = 1.f;
#pragma unroll
        for (int i = SEG - 1; i >= 0; --i) {
          const int t = j * T + SEG * sg + i;
          q_s[t * LDWB + ch] = q;
          q *= ws[t * LDWB + ch];
        }
        wt_s[(j * NSEG + sg) * KB + ch] = q;
      }
    }
    __syncthreads();       // q_s, wt_s
    // this step stages the carry-ins of its chunks past chunk 0
    first = max(CPS * m, 1);
    staged = CPS * m + cn - first;
    if (!mine) continue;
    float dh[CPS][2][4], dl[CPS][2][4], e[CPS][2];
#pragma unroll
    for (int j = 0; j < CPS; ++j) {
      // the later segments' totals G[sg] = prod_{sg' > sg} W[sg'] of the
      // lane's channels g, g + 8, and the chunk's decay e^{cw_last}
      float gs[NSEG][2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float run = 1.f;
#pragma unroll
        for (int sg = NSEG - 1; sg >= 0; --sg) {
          gs[sg][hr] = run;
          run *= wt_s[(j * NSEG + sg) * KB + g + 8 * hr];
        }
        e[j][hr] = run;
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[j][x][i] = dl[j][x][i] = 0.f;
#pragma unroll
      for (int kt = 0; kt < T / 16; ++kt) {
        // A[ch][s] = k_out[s][ch]: a0 (g, 2tq..+1), a1 (g + 8, 2tq..+1),
        // a2 (g, 2tq + 8..+9), a3 (g + 8, 2tq + 8..+9)
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hr = i & 1, ch = g + 8 * hr;
          const int s = j * T + 16 * kt + 2 * tq + 8 * (i >> 1);
          const float f = gs[2 * kt + (i >> 1)][hr];   // s's segment
          split2(__bfloat162float(ks[s * LDKB + ch]) * q_s[s * LDWB + ch] *
                     f,
                 __bfloat162float(ks[(s + 1) * LDKB + ch]) *
                     q_s[(s + 1) * LDWB + ch] * f,
                 ahi[i], alo[i]);
        }
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + bt_offset(lane, LDV, j * T + 16 * kt,
                                             n0));
        mma(dh[j][0], ahi, bf[0], bf[1]);
        mma(dh[j][1], ahi, bf[2], bf[3]);
        mma(dl[j][0], alo, bf[0], bf[1]);
        mma(dl[j][1], alo, bf[2], bf[3]);
      }
    }
    // chunk by chunk: stage the carry-in, then S = e^{cw_last} S + dS
#pragma unroll
    for (int j = 0; j < CPS; ++j) {
      if (j >= cn) break;
      if (CPS * m + j > 0) {
        bf16* os = o_s + (CPS * m + j - first) * 2 * KB * LDV;
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int o = (g + 8 * hr) * LDV + n0 + 8 * x + 2 * tq;
            split2(st[x][2 * hr], st[x][2 * hr + 1],
                   *reinterpret_cast<uint32_t*>(os + o),
                   *reinterpret_cast<uint32_t*>(os + KB * LDV + o));
          }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        st[x][0] = fmaf(e[j][0], st[x][0], dh[j][x][0] + dl[j][x][0]);
        st[x][1] = fmaf(e[j][0], st[x][1], dh[j][x][1] + dl[j][x][1]);
        st[x][2] = fmaf(e[j][1], st[x][2], dh[j][x][2] + dl[j][x][2]);
        st[x][3] = fmaf(e[j][1], st[x][3], dh[j][x][3] + dl[j][x][3]);
      }
    }
  }
  // the last chunk's carry-in (and whatever the last step staged)
  if (nc > 1) {
    if (mine) {
      bf16* os = o_s + staged * 2 * KB * LDV;
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int o = (g + 8 * hr) * LDV + n0 + 8 * x + 2 * tq;
          split2(st[x][2 * hr], st[x][2 * hr + 1],
                 *reinterpret_cast<uint32_t*>(os + o),
                 *reinterpret_cast<uint32_t*>(os + KB * LDV + o));
        }
    }
    if (!staged) first = nc - 1;
    __syncthreads();
    store(first, staged + 1);
  }
  cp_async_wait<0>();
}

// The between-sub-chunk block A = (r P) . (k Q G)^T of rows of sub-chunk i
// and columns of sub-chunk j < i over the K channels: r P as two parts in
// the A layout (rows i, a0 (g, 2tq..+1), a1 (g + 8, 2tq..+1), a2 (g, 2tq +
// 8..+9), a3 (g + 8, 2tq + 8..+9)), k Q G as two parts in the B layout
// (B[ch][s], s = SUB j + 8 nt + g; b0 channels 2tq..+1, b1 2tq + 8..+9), G
// = W_{j+1} .. W_{i-1}; hi.hi + hi.lo + lo.hi into a (two 8-column tiles).
template <int K, int LDK, int LDF>
__device__ __forceinline__ void pair_block(float (&a)[2][4], const bf16* r_s,
                                           const bf16* k_s, const float* p_s,
                                           const float* q_s,
                                           const float* wt_s, int i, int j,
                                           int lane) {
  constexpr int KS = K / 16;
  const int g = lane >> 2, tq = lane & 3;
  float2 gv[KS][2];                // G of the lane's channels
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) gv[kk][hf] = make_float2(1.f, 1.f);
  for (int m = j + 1; m < i; ++m) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 wt = ld_f2(wt_s + m * K + 16 * kk + 2 * tq + 8 * hf);
        gv[kk][hf].x *= wt.x;
        gv[kk][hf].y *= wt.y;
      }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) a[nt][0] = a[nt][1] = a[nt][2] = a[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = SUB * i + g + 8 * (x & 1);
      const int ch = 16 * kk + 2 * tq + 8 * (x >> 1);
      const float2 rv = ld_bf2(r_s + t * LDK + ch);
      const float2 pv = ld_f2(p_s + t * LDF + ch);
      split2(rv.x * pv.x, rv.y * pv.y, ah[x], al[x]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int s = SUB * j + 8 * nt + g;
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ch = 16 * kk + 2 * tq + 8 * hf;
        const float2 kv = ld_bf2(k_s + s * LDK + ch);
        const float2 qv = ld_f2(q_s + s * LDF + ch);
        split2(kv.x * qv.x * gv[kk][hf].x, kv.y * qv.y * gv[kk][hf].y,
               bh[hf], bl[hf]);
      }
      mma(a[nt], ah, bh[0], bh[1]);
      mma(a[nt], ah, bl[0], bl[1]);
      mma(a[nt], al, bh[0], bh[1]);
    }
  }
}

// acc (16 rows x 32 columns: four 8-column tiles) += the 16 x 16 weights
// whose two bf16 parts are ah, al (A layout), times the 16 rows of v_s
// from row0, columns n0 .. n0 + 31; tiles at or past vw are skipped
__device__ __forceinline__ void weights_v(float (&acc)[4][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const bf16* v_s, int row0, int n0,
                                          int vw, int lane) {
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    if (n0 + 16 * pp >= vw) break;
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, v_s + bt_offset(lane, LDV, row0, n0 + 16 * pp));
    mma(acc[2 * pp], ah, vf[0], vf[1]);
    mma(acc[2 * pp + 1], ah, vf[2], vf[3]);
    mma(acc[2 * pp], al, vf[0], vf[1]);
    mma(acc[2 * pp + 1], al, vf[2], vf[3]);
  }
}

// Launch 2, the output: grid (nc, H, B), 8 warps; warps 2i and 2i + 1 own
// the 16 rows of sub-chunk i, value columns 0 .. 31 and 32 .. 63 of each
// block of 64.  The block loads the chunk's r, k, w, u and the carry-in
// S_{c-1} (then v, in a second cp.async group), and per sub-chunk and
// channel forms the prefix products P_t = prod_{m=start}^{t-1} w_m, the
// suffix products Q_s = prod_{m=s+1}^{end} w_m and the total W.  Then, so
// that the CUDA-core and the tensor-core work overlap across warps, every
// warp in one phase: the odd warps form the between-sub-chunk blocks of
// the 6 pairs (pair_block) as two bf16 parts; warp 2i forms the diagonal
// block D of sub-chunk i (running products of w), with the bonus on its
// diagonal; and each warp accumulates its 16 x 32 of y's carry-in (r P
// E_i, E_i = W_0 .. W_{i-1}, against S_{c-1}).  After one barrier each
// warp adds the earlier sub-chunks (A v_j) and its own (D v_i); y is
// rounded to bf16 once, staged in v_s and stored as whole 16-byte pieces of
// rows.  Value heads wider than 64 repeat the carry-in and the products
// with v per block of 64 columns.
template <int K>
__global__ void __launch_bounds__(NT2, 2) rwkv6_scan_chunk_out_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const bf16* __restrict__ sparts,
    bf16* __restrict__ y, int S, int H, int V, int vec) {
  constexpr int LDK = K + PAD;     // bf16 rows of r, k
  constexpr int LDF = K + 8;       // fp32 rows of w, P, Q
  constexpr int KS = K / 16;       // k-steps over the key channels
  constexpr int QC = K / 8;        // channels of a lane in the diagonal
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* r_s = reinterpret_cast<bf16*>(smem_raw);            // T x LDK
  bf16* k_s = r_s + T * LDK;                                // T x LDK
  bf16* v_s = k_s + T * LDK;                                // T x LDV
  bf16* sh_s = v_s + T * LDV;       // carry-in hi part, K x LDV ([k][v])
  bf16* sl_s = sh_s + K * LDV;      // and lo part
  bf16* a_s = sl_s + K * LDV;       // pair blocks: NPAIR x 2 x SUB x SUB
  float* w_s = reinterpret_cast<float*>(a_s + NPAIR * 2 * SUB * SUB);
  float* p_s = w_s + T * LDF;                               // T x LDF
  float* q_s = p_s + T * LDF;       // (T - SUB) x LDF: the last sub-chunk's
                                    // Q is never used
  float* wt_s = q_s + (T - SUB) * LDF;  // NSUB x K: sub-chunk totals W
  float* u_s = wt_s + NSUB * K;     // K
  float* d_s = u_s + K;             // per sub-chunk: SUB x LDA

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int sc = warp >> 1, n0 = 32 * (warp & 1);  // sub-chunk, columns
  const int t0 = c * T, tn = min(T, S - t0);
  const int row0 = SUB * sc;       // the warp's rows
  const bool live = row0 < tn;
  const size_t bt0 = (size_t)b * S + t0;
  const size_t KV = (size_t)K * V;
  const long long HK = (long long)H * K, HV = (long long)H * V;
  const bf16* s_in = sparts + (((size_t)b * H + h) * nc + c) * 2 * KV;

  auto load_s = [&](int vb) {       // the carry-in of columns vb ..
    if (c > 0) {
      const int vw = min(VB, V - vb);
      load_tile<VB, NT2>(sh_s, LDV, s_in + vb, V, K, K, vw, vec, tid);
      load_tile<VB, NT2>(sl_s, LDV, s_in + KV + vb, V, K, K, vw, vec, tid);
    }
  };
  auto load_v = [&](int vb) {
    load_tile<VB, NT2>(v_s, LDV, v + (bt0 * H + h) * V + vb, HV, T, tn,
                       min(VB, V - vb), vec, tid);
  };
  // the carry-in (r P E_i) S_{c-1} of the warp's rows and columns, S as
  // [k][v] = the B operand's [k][n]
  auto carry_in = [&](float (&acc)[4][4], int vw) {
    float2 e[KS][2];                // E_i of the lane's channels 16 kk + 2
                                    // tq + 8 hf + {0, 1}
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) e[kk][hf] = make_float2(1.f, 1.f);
    for (int j = 0; j < sc; ++j) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 wt = ld_f2(wt_s + j * K + 16 * kk + 2 * tq + 8 * hf);
          e[kk][hf].x *= wt.x;
          e[kk][hf].y *= wt.y;
        }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = row0 + g + 8 * (x & 1);
        const int ch = 16 * kk + 2 * tq + 8 * (x >> 1);
        const float2 rv = ld_bf2(r_s + t * LDK + ch);
        const float2 pv = ld_f2(p_s + t * LDF + ch);
        split2(rv.x * pv.x * e[kk][x >> 1].x, rv.y * pv.y * e[kk][x >> 1].y,
               ah[x], al[x]);
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        if (n0 + 16 * pp >= vw) break;
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, sh_s + bt_offset(lane, LDV, 16 * kk,
                                               n0 + 16 * pp));
        ldmatrix_x4_trans(bl, sl_s + bt_offset(lane, LDV, 16 * kk,
                                               n0 + 16 * pp));
        mma(acc[2 * pp], ah, bh[0], bh[1]);
        mma(acc[2 * pp + 1], ah, bh[2], bh[3]);
        mma(acc[2 * pp], ah, bl[0], bl[1]);
        mma(acc[2 * pp + 1], ah, bl[2], bl[3]);
        mma(acc[2 * pp], al, bh[0], bh[1]);
        mma(acc[2 * pp + 1], al, bh[2], bh[3]);
      }
    }
  };

  load_tile<K, NT2>(r_s, LDK, r + (bt0 * H + h) * K, HK, T, tn, K, vec, tid);
  load_tile<K, NT2>(k_s, LDK, k + (bt0 * H + h) * K, HK, T, tn, K, vec, tid);
  load_tile_f32<K, NT2>(w_s, LDF, w + (bt0 * H + h) * K, HK, T, tn, vec,
                        tid);
  load_s(0);
  cp_async_commit();
  load_v(0);                        // needed only after the next phases
  cp_async_commit();
  for (int i = tid; i < K; i += NT2) u_s[i] = u[(size_t)h * K + i];
  cp_async_wait<1>();
  __syncthreads();                  // r, k, w, u, S_in of block 0

  // P, Q and W per (sub-chunk, channel); w past the sequence is 0, which
  // reaches only rows past it
  for (int i = tid; i < NSUB * K; i += NT2) {
    const int ch = i % K, j = i / K;
    float wv[SUB];
#pragma unroll
    for (int m = 0; m < SUB; ++m) wv[m] = w_s[(SUB * j + m) * LDF + ch];
    float pp = 1.f, qq = 1.f;
#pragma unroll
    for (int m = 0; m < SUB; ++m) {
      p_s[(SUB * j + m) * LDF + ch] = pp;
      pp *= wv[m];
    }
    if (j < NSUB - 1) {
#pragma unroll
      for (int m = SUB - 1; m >= 0; --m) {
        q_s[(SUB * j + m) * LDF + ch] = qq;
        qq *= wv[m];
      }
    }
    wt_s[j * K + ch] = pp;
  }
  __syncthreads();                  // p_s, q_s, wt_s

  float* dw = d_s + sc * SUB * LDA;  // the sub-chunk's diagonal block
  if (warp & 1) {
    // pairs p = (i, j), p = i (i - 1) / 2 + j: warp 2 x + 1 takes x and x
    // + 4
    for (int p = warp >> 1; p < NPAIR; p += 4) {
      const int i = p < 1 ? 1 : p < 3 ? 2 : 3, j = p - i * (i - 1) / 2;
      if (SUB * i >= tn) continue;
      float a[2][4];
      pair_block<K, LDK, LDF>(a, r_s, k_s, p_s, q_s, wt_s, i, j, lane);
      bf16* ah = a_s + p * 2 * SUB * SUB;        // [part][16][16]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int o = (g + 8 * hr) * SUB + 8 * nt + 2 * tq;
          split2(a[nt][2 * hr], a[nt][2 * hr + 1],
                 *reinterpret_cast<uint32_t*>(ah + o),
                 *reinterpret_cast<uint32_t*>(ah + SUB * SUB + o));
        }
    }
  } else if (live) {
    // the diagonal block D[t][s] of sub-chunk sc, s <= t (0 above), with
    // the bonus on its diagonal.  Lane (rg, cg) holds rows rg, 7 - rg, 8 +
    // rg and 15 - rg (30 row-steps for every lane) and channels cg QC ..
    // + QC - 1, and walks s = 14 .. 0: at each step the 8 lanes of a row
    // group read one k and one w row of the channels together (a
    // broadcast to the 4 row groups), and their 4 partial sums meet in 4
    // shuffles (a reduce-scatter over the 8 lanes).
    const int rg = lane >> 3, cg = lane & 7, cb = cg * QC;
    const int rows[4] = {rg, 7 - rg, 8 + rg, 15 - rg};
    // the row this lane's reduce-scatter ends with: rows[2 (cg / 4 % 2) +
    // cg / 2 % 2]
    const int mine = 2 * ((cg >> 2) & 1) + ((cg >> 1) & 1);
    const int row = mine == 0 ? rg : mine == 1 ? 7 - rg : mine == 2 ? 8 + rg
                                                                   : 15 - rg;
    auto reduce = [&](float (&v4)[4]) {
      const bool h4 = cg & 4, h2 = cg & 2;
      float k0 = h4 ? v4[2] : v4[0], k1 = h4 ? v4[3] : v4[1];
      k0 += __shfl_xor_sync(0xffffffffu, h4 ? v4[0] : v4[2], 4);
      k1 += __shfl_xor_sync(0xffffffffu, h4 ? v4[1] : v4[3], 4);
      float kp = h2 ? k1 : k0;
      kp += __shfl_xor_sync(0xffffffffu, h2 ? k0 : k1, 2);
      return kp + __shfl_xor_sync(0xffffffffu, kp, 1);
    };
    for (int x = lane; x < SUB * SUB; x += 32) dw[(x >> 4) * LDA + (x & 15)] = 0.f;
    __syncwarp();
    float part[4], pr[4][QC];       // pr: r_t prod_{m=s+1}^{t-1} w_m
    float uv[QC], kv[QC], wv[QC];
    lds_f32(uv, u_s + cb);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      lds_bf16(pr[rr], r_s + (row0 + rows[rr]) * LDK + cb);
      lds_bf16(kv, k_s + (row0 + rows[rr]) * LDK + cb);
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < QC; ++j) a = fmaf(pr[rr][j] * uv[j], kv[j], a);
      part[rr] = a;
    }
    const float bonus = reduce(part);
    if (!(cg & 1)) dw[row * LDA + row] = bonus;
#pragma unroll 1
    for (int s = SUB - 2; s >= 0; --s) {
      lds_bf16(kv, k_s + (row0 + s) * LDK + cb);
      lds_f32(wv, w_s + (row0 + s) * LDF + cb);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        part[rr] = 0.f;             // pr[rr] holds r_t until the row starts
        if (rows[rr] > s) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int j = 0; j < QC; j += 2) {
            a0 = fmaf(pr[rr][j], kv[j], a0);
            a1 = fmaf(pr[rr][j + 1], kv[j + 1], a1);
            pr[rr][j] *= wv[j];
            pr[rr][j + 1] *= wv[j + 1];
          }
          part[rr] = a0 + a1;
        }
      }
      const float d = reduce(part);
      if (!(cg & 1) && row > s) dw[row * LDA + s] = d;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (live && c > 0 && n0 < min(VB, V)) carry_in(acc, min(VB, V));
  cp_async_wait<0>();
  __syncthreads();                  // a_s, d_s; v of block 0

  for (int vb = 0; vb < V; vb += VB) {
    const int vw = min(VB, V - vb);
    if (vb > 0) {
      __syncthreads();              // every warp is done with v_s, s*_s
      load_s(vb);
      load_v(vb);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int n = 0; n < 4; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      if (live && c > 0 && n0 < vw) carry_in(acc, vw);
    }
    if (live && n0 < vw) {
      // the earlier sub-chunks, then the warp's own
      for (int j = 0; j < sc; ++j) {
        const bf16* ap = a_s + (sc * (sc - 1) / 2 + j) * 2 * SUB * SUB;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int o = (g + 8 * (x & 1)) * SUB + 2 * tq + 8 * (x >> 1);
          ah[x] = *reinterpret_cast<const uint32_t*>(ap + o);
          al[x] = *reinterpret_cast<const uint32_t*>(ap + SUB * SUB + o);
        }
        weights_v(acc, ah, al, v_s, SUB * j, n0, vw, lane);
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 dv = ld_f2(dw + (g + 8 * (x & 1)) * LDA + 2 * tq +
                                8 * (x >> 1));
        split2(dv.x, dv.y, ah[x], al[x]);
      }
      weights_v(acc, ah, al, v_s, row0, n0, vw, lane);
    }
    // y rounded to bf16 once, staged in the warp's rows and columns of v_s,
    // then stored as whole 16-byte pieces of rows
    __syncthreads();                // every warp is done reading v_s
    if (!live || n0 >= vw) continue;
    bf16* ys = v_s + row0 * LDV + n0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(ys + (g + 8 * hr) * LDV + 8 * n +
                                     2 * tq) =
            pack(acc[n][2 * hr], acc[n][2 * hr + 1]);
    __syncwarp();
    for (int i = lane; i < SUB * 4; i += 32) {
      const int rr = i >> 2, col = n0 + 8 * (i & 3);
      if (row0 + rr >= tn || col >= vw) continue;
      bf16* yr = y + ((bt0 + row0 + rr) * H + h) * V + vb + col;
      const bf16* src = ys + rr * LDV + col - n0;
      if (vec) {
        *reinterpret_cast<uint4*>(yr) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col + j < vw) yr[j] = src[j];
      }
    }
  }
}

template <int K>
int launch_bf16(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, void* scratch, int B, int S, int H,
                int V, cudaStream_t stream) {
  constexpr int LDK = K + PAD, LDF = K + 8;
  const int nc = (S + T - 1) / T;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!aligned16({scratch})) return (int)cudaErrorMisalignedAddress;
  const int vec = V % 8 == 0 && aligned16({r, k, v, w, y});
  const size_t smem1 =
      sizeof(bf16) * (NSTAGE * CPS * T * (LDKB + LDV) +
                      (CPS + 1) * 2 * KB * LDV) +
      sizeof(float) * ((NSTAGE + 1) * CPS * T * LDWB + CPS * T / SEG * KB);
  const size_t smem2 =
      sizeof(bf16) * (2 * T * LDK + T * LDV + 2 * K * LDV +
                      NPAIR * 2 * SUB * SUB) +
      sizeof(float) * ((3 * T - SUB) * LDF + NSUB * K + K + NSUB * SUB * LDA);
  auto k1 = rwkv6_scan_state_kernel;
  auto k2 = rwkv6_scan_chunk_out_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  if (nc > 1) {
    k1<<<dim3(K / KB * ((V + VB - 1) / VB), H, B), NT1, smem1, stream>>>(
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(w), static_cast<bf16*>(scratch), S, H, K,
        V, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k2<<<dim3(nc, H, B), NT2, smem2, stream>>>(
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
