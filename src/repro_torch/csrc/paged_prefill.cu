// Ragged batched paged chunk prefill for Hopper (sm_90a): K query chunks of
// K sequences, each at its own absolute offset, attending through its own
// block-table row into one global page pool.
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py::
// batched_paged_prefill_attention (body _chunk_kernel; its K=1 wrapper
// paged_prefill_attention calls the same launch).  Same function: row k's
// query r sits at absolute position off[k] + r and attends to columns
// c <= off[k] + r with c < true_len[k] (and c > off[k] + r - window when a
// window is set), fp32 math, exp2-form online softmax with the NEG_INF /
// m_safe guards, optional logit softcap; the softmax weights enter the PV
// product unrounded, as in the TPU kernel and the plain version.  Query
// lanes at or past q_len[k] come out exactly zero, and so does every lane
// of a dead row (true_len == 0).
//
// What bounds it on this card: operations.  At the serving shapes (chunks
// of 256 tokens over prefixes of up to 2k tokens, G = 4 query heads per KV
// head) the work is S*G rows x prefix columns x 4*D FLOPs against one read
// of the prefix's K/V pages, several hundred FLOPs per byte.  Grid: one
// block per (row k, KV head h, tile of 64 flattened query rows r = s * G +
// g, the G query heads of one KV head side by side as the TPU kernel
// flattens them, so one K/V tile serves all G heads).  The KV range a block
// walks is cut before the loop: nothing at or past true_len, nothing past
// the tile's last live causal column, nothing left of the tile's first
// column inside the window.  Rows past q_len do no work of their own.
//
// The C entry point dispatches on the dtype:
//  * bfloat16 runs on the tensor cores (csrc/mma_bf16.cuh), K4's FA-2 tile
//    (csrc/flash_attention.cu) over the page pool: 4 warps of 16 rows read
//    q's mma.sync A fragments from shared memory at each k-step; K/V
//    tiles of 64 positions stay bf16 in shared memory (rows padded by 16
//    bytes) and arrive by cp.async into
//    two buffers, tile j + 1 loading under the products on tile j.  Each
//    position of a tile has its own page, tables[k][pos / ps], slot pos %
//    ps: 64 threads turn the tile's positions into pool offsets once, a
//    tile ahead of its load, and every position's head row (D x 2 bytes,
//    contiguous) moves as aligned 16-byte chunks.  The mask runs only on a
//    tile that crosses an edge; the last row tiles, whose causal walks are
//    the longest, are launched first.  Unlike K4, whose plain version
//    rounds the weights to bf16 before PV, K1's keeps them in fp32: a
//    bf16 weight would miss its bar of 2^-7 relative where the terms
//    cancel, and so would p_hi + p_lo (tests/test_torch_prefill_parts.py
//    emulates both on the existing test cases).  So each weight goes in as three
//    bf16 parts, p = p_hi + p_mid + p_lo, each taken from the remainder of
//    the one before (exact in fp32), three products into one fp32
//    accumulator: the weight is carried to ~2^-24, as in fp32.  A tile is
//    one product for s = q k^T and three for o += p v; the parts are
//    formed 16 columns at a time, just before their products.
//  * float32 runs on the CUDA cores in fp32 FMAs, since the tensor cores'
//    fp32 input is TF32, which would miss the float32 bar of 1e-5: a block
//    holds its 64 query rows and each K/V tile in shared memory as fp32,
//    each thread an 8 x 4 register tile of scores and an 8 x D/16 tile of
//    the output, so every value loaded from shared memory feeds several
//    FMAs.  It is what the tight float32 checks run, not a fallback: a
//    bf16 launch that fails returns its error.
// Head dim 256 (gemma3-4b) keeps the bf16 tile's shape, (256 + 8) x (64 +
// 4 x 64) x 2 B + 1 KB of offsets = 170 KB of shared memory, one block an
// SM, but not its registers: o's 128 fp32 accumulators a thread, the
// scores' 32 and the 12 of a k-step's three weight parts, beside q's
// fragments read from shared memory, left 255 registers and 224 bytes of
// spills.  So two warps share each 16-row slab, each holding o for 128
// of its columns (o_split): both score the slab and run its softmax, the
// same instructions on the same data, so the same bits - the scores'
// product is done twice, 8 warps a block.
// The float32 kernel takes 32 rows a block there, 4 a thread, in 172 KB of
// shared memory (f32_rows).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int NT = 128;      // threads per block: 8 row groups x 16 columns
constexpr int TILE = 64;     // KV positions per tile
constexpr int CI = TILE / 16;  // score columns per thread
// flattened query rows per block of the float32 kernel: 64, 8 a thread;
// at head dim 256 a thread's 8 x 16 fp32 output tile would not fit its
// registers beside the scores, so 32 rows, 4 a thread
__host__ __device__ constexpr int f32_rows(int D) {
  return D > 128 ? 32 : 64;
}
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// reductions over the 16 lanes that share a row group (one half-warp)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ offs, const int* __restrict__ tls,
    const int* __restrict__ qls, T* __restrict__ out, int S, int Hkv, int G,
    int ps, int n_max, int window, float scale, float softcap) {
  constexpr int DC = D / 16;   // output columns per thread
  constexpr int BR = f32_rows(D), RI = BR / 8;   // rows: per block, a thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // BR x (D + 1)
  float* k_s = q_s + BR * (D + 1);      // TILE x (D + 1)
  float* v_s = k_s + TILE * (D + 1);    // TILE x D
  float* p_s = v_s + TILE * D;          // BR x (TILE + 1)

  const int row_k = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * BR;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int Hq = Hkv * G, R = S * G;
  const int off = offs[row_k], tl = tls[row_k], ql = qls[row_k];
  const size_t tok_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)ps * tok_stride;
  const int* trow = tables + (size_t)row_k * n_max;

  // KV range of this block: live query indices s_first .. s_live
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BR, R) - 1) / G;
  const int s_live = min(s_last, ql - 1);
  const int kv_lo = window > 0 ? max(0, off + s_first - window + 1) : 0;
  int kv_hi = min(min(tl, off + s_live + 1), n_max * ps);
  if (s_live < s_first || tl <= 0) kv_hi = 0;

  for (int i = tid; i < BR * D; i += NT) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr;
    float v = 0.f;
    if (r < R) {
      const int s = r / G, g = r - s * G;
      v = to_f(q[(((size_t)row_k * S + s) * Hq + (size_t)h * G + g) * D + d]) *
          scale;
    }
    q_s[rr * (D + 1) + d] = v;
  }

  // this thread's rows: r0 + tr + 8 * i; their absolute query positions
  int qpos[RI];
  bool rlive[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    const int s = r / G;
    qpos[i] = off + s;
    rlive[i] = r < R && s < ql;
  }
  float acc[RI][DC], m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += TILE) {
    __syncthreads();   // q_s written / previous tile fully consumed
    for (int i = tid; i < TILE * D; i += NT) {
      const int t = i / D, d = i - t * D;
      const int kpos = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (kpos < kv_hi) {
        const size_t o = (size_t)trow[kpos / ps] * page_stride +
                         (size_t)(kpos % ps) * tok_stride + (size_t)h * D + d;
        kv = to_f(kp[o]);
        vv = to_f(vp[o]);
      }
      k_s[t * (D + 1) + d] = kv;
      v_s[t * D + d] = vv;
    }
    __syncthreads();

    float sc[RI][CI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CI; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(tr + 8 * i) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < CI; ++c) kv[c] = k_s[(tc + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CI; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      bool valid[CI];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const int kpos = t0 + tc + 16 * c;
        valid[c] = rlive[i] && kpos < kv_hi && kpos <= qpos[i] &&
                   (window <= 0 || kpos > qpos[i] - window);
        float s = sc[i][c];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s = valid[c] ? s : NEG_INF;
        sc[i][c] = s;
        mx = fmaxf(mx, s);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m_run[i], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const float p = valid[c] ? exp2f((sc[i][c] - m_safe) * LOG2E) : 0.f;
        p_s[(tr + 8 * i) * (TILE + 1) + tc + 16 * c] = p;
        sum += p;
      }
      sum = half_sum(sum);
      const float alpha =
          m_run[i] <= NEG_INF / 2 ? 0.f : exp2f((m_run[i] - m_new) * LOG2E);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < TILE; ++t) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[t * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(tr + 8 * i) * (TILE + 1) + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    if (r >= R) continue;
    const int s = r / G, g = r - s * G;
    const float inv = 1.f / fmaxf(l_run[i], 1e-20f);
    T* o = out + (((size_t)row_k * S + s) * Hq + (size_t)h * G + g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[tc + 16 * c] = from_f<T>(rlive[i] ? acc[i][c] * inv : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* offs, const void* tls, const void* qls, void* out,
           int K, int S, int Hkv, int G, int ps, int n_max, int window,
           float scale, float softcap, cudaStream_t stream) {
  constexpr int BR = f32_rows(D);
  const size_t smem =
      sizeof(float) * ((size_t)BR * (D + 1) + (size_t)TILE * (D + 1) +
                       (size_t)TILE * D + (size_t)BR * (TILE + 1));
  auto kern = paged_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K, Hkv, (S * G + BR - 1) / BR);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(offs), static_cast<const int*>(tls),
      static_cast<const int*>(qls), static_cast<T*>(out), S, Hkv, G, ps,
      n_max, window, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 kernel on the tensor cores: 4 warps (8 at head dim 256), each
// owning 16 of the block's 64 flattened query rows.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int NW = 4;            // warps per block
constexpr int NT_TC = 32 * NW;
constexpr int BM = 16 * NW;      // flattened query rows per block
constexpr int BN = 64;           // KV positions per tile
// warps that share each 16-row slab of the block's rows, each holding o
// for D / o_split(D) of its columns: two at head dim 256 (the note at the
// top), one below
__host__ __device__ constexpr int o_split(int D) { return D > 128 ? 2 : 1; }

// The A operands of k-step `ks` (16 key columns) from the fp32 weights of
// its two 8-column tiles, as three bf16 parts whose sum carries each weight
// to ~2^-24 relative: hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
// mid); both remainders are exact in fp32.
template <int N>
__device__ __forceinline__ void weights_to_a3(uint32_t (&hi)[4],
                                              uint32_t (&mid)[4],
                                              uint32_t (&lo)[4],
                                              const float (&c)[N][4],
                                              int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r0 = c[2 * ks + (i >> 1)][2 * (i & 1)];
    float r1 = c[2 * ks + (i >> 1)][2 * (i & 1) + 1];
    __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
    r0 -= __low2float(h);
    r1 -= __high2float(h);
    __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    r0 -= __low2float(m);
    r1 -= __high2float(m);
    __nv_bfloat162 l = __floats2bfloat162_rn(r0, r1);
    hi[i] = *reinterpret_cast<uint32_t*>(&h);
    mid[i] = *reinterpret_cast<uint32_t*>(&m);
    lo[i] = *reinterpret_cast<uint32_t*>(&l);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_TC * o_split(D))
    paged_prefill_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ offs, const int* __restrict__ tls,
    const int* __restrict__ qls, bf16* __restrict__ out, int S, int Hkv,
    int G, int ps, int n_max, int window, float scale, float softcap) {
  using namespace mma_bf16;
  // DO: the columns of o a warp holds, ND / 2 16-column steps of them
  constexpr int NTH = NT_TC * o_split(D), DO = D / o_split(D);
  constexpr int LD = D + PAD, KS = D / 16, ND = DO / 8, NC = BN / 8,
                CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BM x LD
  bf16* kv_s = q_s + BM * LD;                       // 2 x (K, V) x BN x LD
  // pool offsets (elements) of the positions of two tiles, -1 past kv_hi
  long long* pos_s = reinterpret_cast<long long*>(kv_s + 4 * BN * LD);

  const int row_k = blockIdx.x, h = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BM;   // longest walks first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this warp's 16 rows and its columns d0 .. d0 + DO of o
  const int wr = (warp % NW) * 16, d0 = (warp / NW) * DO;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int Hq = Hkv * G, R = S * G;
  const int off = offs[row_k], tl = tls[row_k], ql = qls[row_k];
  const long long tok = (long long)Hkv * D;
  const long long page_stride = (long long)ps * tok;
  const int* trow = tables + (size_t)row_k * n_max;

  // KV range of this block: live query indices s_first .. s_live
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BM, R) - 1) / G;
  const int s_live = min(s_last, ql - 1);
  const int kv_lo = window > 0 ? max(0, off + s_first - window + 1) : 0;
  int kv_hi = min(min(tl, off + s_live + 1), n_max * ps);
  if (s_live < s_first || tl <= 0) kv_hi = 0;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  auto row_of = [&](int r) -> size_t {
    const int s = r / G;
    return ((size_t)row_k * S + s) * Hq + (size_t)h * G + (r - s * G);
  };
  // tile j's positions -> pool offsets, one thread a position
  auto fill_offsets = [&](int j) {
    if (tid < BN) {
      const int pos = kv_lo + j * BN + tid;
      pos_s[(j & 1) * BN + tid] =
          pos < kv_hi ? (long long)trow[pos / ps] * page_stride +
                            (long long)(pos % ps) * tok + (long long)h * D
                      : -1;
    }
  };
  auto load_kv = [&](int j) {
    const long long* po = pos_s + (j & 1) * BN;
    bf16* ks = kv_s + (j & 1) * 2 * BN * LD;
    bf16* vs = ks + BN * LD;
    for (int i = tid; i < BN * CH; i += NTH) {
      const int rr = i / CH, c = i % CH;
      const long long o = po[rr];
      const bool live = o >= 0;
      const long long src = live ? o + c * 8 : 0;
      cp_async16(ks + rr * LD + c * 8, kp + src, live);
      cp_async16(vs + rr * LD + c * 8, vp + src, live);
    }
  };

  fill_offsets(0);
  fill_offsets(1);
  for (int i = tid; i < BM * CH; i += NTH) {
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const bool live = r < R;
    cp_async16(q_s + rr * LD + c * 8, q + row_of(live ? r : r0) * D + c * 8,
               live);
  }
  __syncthreads();       // the offsets of tiles 0 and 1
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // this lane's two rows: wr + g4 and wr + g4 + 8
  int qpos[2];
  bool rlive[2];
  float m_run[2], l_run[2];   // l_run: this lane's share of the row sum
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + wr + g4 + 8 * h2, s = r / G;
    qpos[h2] = off + s;
    rlive[h2] = r < R && s < ql;
    m_run[h2] = NEG_INF;
    l_run[h2] = 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = kv_lo + j * BN;
    cp_async_wait_all();
    __syncthreads();     // tile j landed; every warp is done with j - 1
    if (j + 1 < n_tiles) load_kv(j + 1);
    cp_async_commit();
    fill_offsets(j + 2);   // tile j's buffer: its load was issued before
    const bf16* ks = kv_s + (j & 1) * 2 * BN * LD;
    const bf16* vs = ks + BN * LD;

    // s = q k^T: 16 rows x BN keys per warp
    float sc[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4];   // q stays in shared memory for the whole walk
      ldmatrix_x4(qf, q_s + a_offset(lane, LD, wr, kk * 16));
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + b_offset(lane, LD, np * 16, kk * 16));
        mma(sc[2 * np], qf, kf[0], kf[1]);
        mma(sc[2 * np + 1], qf, kf[2], kf[3]);
      }
    }

    // scale, softcap and the mask (only where the tile crosses an edge:
    // past kv_hi, above the first row's diagonal, left of the last live
    // row's window; rows past q_len are zeroed at the end)
    const bool edge = !(t0 + BN <= kv_hi && t0 + BN - 1 <= off + s_first &&
                        (window <= 0 || t0 > off + s_live - window));
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int kpos = t0 + n * 8 + 2 * t4 + (e & 1), qp = qpos[e >> 1];
          const bool valid = rlive[e >> 1] && kpos < kv_hi && kpos <= qp &&
                             (window <= 0 || kpos > qp - window);
          x = valid ? x : NEG_INF;
        }
        sc[n][e] = x;
      }

    // online softmax per row; a masked score gives exp2(-1e30 ...) = 0
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * h2], sc[n][2 * h2 + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m_run[h2], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m_run[h2] <= NEG_INF / 2
                              ? 0.f
                              : exp2f((m_run[h2] - m_new) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
          const float p = exp2f((sc[n][e] - m_safe) * LOG2E);
          sc[n][e] = p;
          sum += p;
        }
      l_run[h2] = l_run[h2] * alpha + sum;
      m_run[h2] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * h2] *= alpha;
        acc[n][2 * h2 + 1] *= alpha;
      }
    }

    // o += p v: the fp32 weights as three bf16 parts, V through .trans
#pragma unroll
    for (int kk = 0; kk < NC / 2; ++kk) {
      uint32_t ph[4], pm[4], pl[4];
      weights_to_a3(ph, pm, pl, sc, kk);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf,
                          vs + bt_offset(lane, LD, kk * 16, d0 + np * 16));
        mma(acc[2 * np], ph, vf[0], vf[1]);
        mma(acc[2 * np + 1], ph, vf[2], vf[3]);
        mma(acc[2 * np], pm, vf[0], vf[1]);
        mma(acc[2 * np + 1], pm, vf[2], vf[3]);
        mma(acc[2 * np], pl, vf[0], vf[1]);
        mma(acc[2 * np + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float l = fmaxf(quad_sum(l_run[h2]), 1e-20f);
    const int r = r0 + wr + g4 + 8 * h2;
    if (r >= R) continue;
    const float inv = 1.f / l;
    bf16* o = out + row_of(r) * D + d0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) = __floats2bfloat162_rn(
          rlive[h2] ? acc[n][2 * h2] * inv : 0.f,
          rlive[h2] ? acc[n][2 * h2 + 1] * inv : 0.f);
  }
}

template <int D>
int launch_bf16(const void* q, const void* kp, const void* vp,
                const void* tables, const void* offs, const void* tls,
                const void* qls, void* out, int K, int S, int Hkv, int G,
                int ps, int n_max, int window, float scale, float softcap,
                cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (D + mma_bf16::PAD) * (BM + 4 * BN) +
                      sizeof(long long) * 2 * BN;
  const long long tiles = ((long long)S * G + BM - 1) / BM;
  if (tiles > 65535 || Hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!mma_bf16::aligned16({q, kp, vp, out}))
    return (int)cudaErrorMisalignedAddress;
  auto kern = paged_prefill_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(K, Hkv, (unsigned)tiles), NT_TC * o_split(D), smem,
         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(offs), static_cast<const int*>(tls),
      static_cast<const int*>(qls), static_cast<bf16*>(out), S, Hkv, G, ps,
      n_max, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// Element type: is_bf16 = 1 for bfloat16 (the tensor-core kernel; q, the
// pools and out 16-byte aligned, else cudaErrorMisalignedAddress), 0 for
// float32 (the CUDA-core kernel); head dim 64, 128 or 256.  Anything else
// returns cudaErrorInvalidValue without launching (the Python wrapper
// checks first).
extern "C" int paged_prefill_launch(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* page_tables,
                                    const void* q_offsets,
                                    const void* true_lens,
                                    const void* q_lens, void* out, int K,
                                    int S, int Hkv, int G, int D,
                                    int page_size, int n_max, int window,
                                    float scale, float softcap, int is_bf16,
                                    void* stream) {
  if (G < 1 || page_size < 1 || n_max < 1) return (int)cudaErrorInvalidValue;
  if (K == 0 || S == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch_bf16<64>(q, k_pages, v_pages, page_tables, q_offsets,
                             true_lens, q_lens, out, K, S, Hkv, G, page_size,
                             n_max, window, scale, softcap, s);
    if (D == 128)
      return launch_bf16<128>(q, k_pages, v_pages, page_tables, q_offsets,
                              true_lens, q_lens, out, K, S, Hkv, G,
                              page_size, n_max, window, scale, softcap, s);
    if (D == 256)
      return launch_bf16<256>(q, k_pages, v_pages, page_tables, q_offsets,
                              true_lens, q_lens, out, K, S, Hkv, G,
                              page_size, n_max, window, scale, softcap, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k_pages, v_pages, page_tables, q_offsets,
                               true_lens, q_lens, out, K, S, Hkv, G,
                               page_size, n_max, window, scale, softcap, s);
    if (D == 128)
      return launch<float, 128>(q, k_pages, v_pages, page_tables, q_offsets,
                                true_lens, q_lens, out, K, S, Hkv, G,
                                page_size, n_max, window, scale, softcap, s);
    if (D == 256)
      return launch<float, 256>(q, k_pages, v_pages, page_tables, q_offsets,
                                true_lens, q_lens, out, K, S, Hkv, G,
                                page_size, n_max, window, scale, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
