// FlashAttention-2 forward for Hopper (sm_90a) over contiguous K/V: the
// monolithic prefill of the serving path and Model.forward.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (body _fa_kernel).  Same function as its plain
// version (kernels/ref.py flash_attention): q (B, Sq, Hq, D) against k, v
// (B, Skv, Hkv, D) with GQA (query head j reads KV head j / G); scores
// (q . k) * scale in fp32, optional logit softcap; a causal mask aligned at
// the top left (k_pos <= q_pos, q_pos counted from 0 even when Sq != Skv);
// window > 0 keeps k_pos > q_pos - window and implies the causal mask;
// exp2-form online softmax with the NEG_INF / m_safe guards.  The weights
// are rounded to the input dtype before the PV product (the plain
// version's p.astype(q.dtype)); their row sum l is taken unrounded.  Beside
// o it writes lse = m + ln(max(l, 1e-20)) in fp32, (B, Sq, Hq), which the
// FA-2 backward will read.
//
// What bounds it on this card: operations.  A prompt of S tokens does
// about 4 * D * Hq * S^2 / 2 FLOPs causal against one read of q, K, V and
// one write of o, thousands of FLOPs per byte at S = 1904 - far above the
// ~295 FLOP/byte where an H100 stops being memory bound.  So the products
// have to run on the tensor cores, and the work the mask removes is cut:
// a block holds BM flattened query rows (row r = s * G + g, the G query
// heads of one KV head side by side, as the TPU kernel's GQA index map
// groups them, so one K/V tile serves all G heads) and walks the KV range
// its rows can see - nothing past Skv, nothing past the tile's last query
// position when masked (above the diagonal), nothing left of the tile's
// first query position's window - in tiles of BN positions.  Grid: one
// block per (sequence b, KV head h, tile of rows).
//
// The tile (BM, BN) of the bf16 kernel is a template parameter, three
// instantiations a head dim, chosen by the caller: the TPU kernel sizes
// its blocks with the paper's latency-balanced chooser
// (core/tpu_mapping.py), and the port's wrapper asks the Hopper
// counterpart (repro_torch/core/hopper_mapping.py choose_block_config,
// whose K4_TILES lists the instantiations below) when it is given no
// tile.  A tile that is not instantiated is refused, never replaced.
//
// The C entry point dispatches on the dtype:
//  * bfloat16 runs on the tensor cores (csrc/mma_bf16.cuh), FA-2 style:
//    BM / 16 warps, each owning 16 rows, read q's mma.sync A fragments by
//    ldmatrix from shared memory, where q stays for the whole walk, at
//    each k-step of every tile (fewer registers than holding them; the
//    A/B times are in PERF.md); K and V tiles stay bf16 in shared memory
//    (rows padded by 16 bytes, so ldmatrix meets no bank conflict) and
//    arrive by cp.async into two buffers, the load of tile j + 1
//    overlapping the products on tile j.  s = q k^T accumulates in fp32
//    fragments (K as B, as it lies); scale, softcap, the mask (only on a
//    tile that crosses an edge) and the online softmax run on the
//    fragments, the row max and sum over the 4 lanes that share a row, l
//    from the unrounded p; p is rounded to
//    bf16 and used in place as the A operand of o += p v (V through
//    ldmatrix.trans).  What still bounds it: mma.sync issues per warp,
//    synchronously, and every warp reads the whole K/V tile from shared
//    memory for its 16 rows (wgmma over a 64-row warpgroup would read each
//    B once).  The last row tiles, whose walks are the longest under the
//    causal mask, are launched first, so the short ones fill the tail.
//  * float32 runs on the CUDA cores in fp32 FMAs, since the tensor cores'
//    fp32 input is TF32, which would miss the float32 bar of 1e-5: K1's
//    tile (csrc/paged_prefill.cu) with contiguous addressing - q and each
//    K/V tile widened to fp32 in shared memory, each thread an 8 x 4
//    register tile of scores and an 8 x D/16 tile of the output.  It is
//    what the tight float32 checks run (the recurrent float32 forward at
//    head dim 80 among them), not a fallback: a bf16 launch that fails
//    returns its error.
// Head dim 256 (gemma3-4b): the (64, 64) tile takes (256 + 8) x (64 + 4 x
// 64) x 2 B = 169 KB of shared memory, one block an SM: o's 128 fp32
// accumulators a thread and the scores' 32 fit in the 255 registers a
// thread may have because q is not held in registers at any head dim; a
// KV tile of 128 (64 score registers) would not fit, so 256 takes 32 or
// 64.
// The float32 kernel takes 32 rows a block there, 4 a thread, in 172 KB
// of shared memory (f32_rows).
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
// a weight as the PV product takes it: rounded to the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Skv, int Hkv, int G, int causal, int window, float scale,
    float softcap) {
  constexpr int DC = D / 16;   // output columns per thread
  constexpr int BR = f32_rows(D), RI = BR / 8;   // rows: per block, a thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // BR x (D + 1)
  float* k_s = q_s + BR * (D + 1);      // TILE x (D + 1)
  float* v_s = k_s + TILE * (D + 1);    // TILE x D
  float* p_s = v_s + TILE * D;          // BR x (TILE + 1)

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * BR;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int Hq = Hkv * G, R = Sq * G;
  const bool masked = causal || window > 0;
  const size_t tok_stride = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * Skv * tok_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * Skv * tok_stride + (size_t)h * D;

  // KV range of this block: query positions s_first .. s_last
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BR, R) - 1) / G;
  const int kv_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int kv_hi = masked ? min(Skv, s_last + 1) : Skv;

  for (int i = tid; i < BR * D; i += NT) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr;
    float x = 0.f;
    if (r < R) {
      const int s = r / G, g = r - s * G;
      x = to_f(q[(((size_t)b * Sq + s) * Hq + (size_t)h * G + g) * D + d]);
    }
    q_s[rr * (D + 1) + d] = x;
  }

  // this thread's rows: r0 + tr + 8 * i; their query positions
  int qpos[RI];
  bool rlive[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    qpos[i] = r / G;
    rlive[i] = r < R;
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
      float kx = 0.f, vx = 0.f;
      if (kpos < kv_hi) {
        const size_t o = (size_t)kpos * tok_stride + d;
        kx = to_f(kb[o]);
        vx = to_f(vb[o]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
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
        valid[c] = rlive[i] && kpos < kv_hi &&
                   (!masked || kpos <= qpos[i]) &&
                   (window <= 0 || kpos > qpos[i] - window);
        float s = sc[i][c] * scale;
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
        p_s[(tr + 8 * i) * (TILE + 1) + tc + 16 * c] = round_to<T>(p);
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
    if (!rlive[i]) continue;
    const int r = r0 + tr + 8 * i;
    const int s = r / G, g = r - s * G;
    const float l = fmaxf(l_run[i], 1e-20f);
    const float inv = 1.f / l;
    const size_t row = ((size_t)b * Sq + s) * Hq + (size_t)h * G + g;
    T* o = out + row * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tc + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tc == 0) lse[row] = m_run[i] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 kernel on the tensor cores: NW warps, each owning 16 of the
// block's BM = 16 NW flattened query rows, over KV tiles of BN positions.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

template <int D, int NW, int BN>
__global__ void __launch_bounds__(32 * NW) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int Hkv, int G, int causal,
    int window, float scale, float softcap) {
  using namespace mma_bf16;
  constexpr int NT_TC = 32 * NW, BM = 16 * NW;
  constexpr int LD = D + PAD, KS = D / 16, ND = D / 8, NC = BN / 8,
                CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BM x LD
  bf16* kv_s = q_s + BM * LD;                       // 2 x (K, V) x BN x LD

  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BM;   // longest walks first
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int Hq = Hkv * G, R = Sq * G;
  const bool masked = causal || window > 0;
  const size_t tok = (size_t)Hkv * D;
  const bf16* kb = k + (size_t)b * Skv * tok + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Skv * tok + (size_t)h * D;
  // KV range of this block: query positions s_first .. s_last
  const int s_first = r0 / G;
  const int s_last = (min(r0 + BM, R) - 1) / G;
  const int kv_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int kv_hi = masked ? min(Skv, s_last + 1) : Skv;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;
  // (b, s, head) row of the flattened query row r = s * G + g
  auto row_of = [&](int r) -> size_t {
    const int s = r / G;
    return ((size_t)b * Sq + s) * Hq + (size_t)h * G + (r - s * G);
  };
  auto load_kv = [&](int t0, int stage) {
    bf16* ks = kv_s + stage * 2 * BN * LD;
    bf16* vs = ks + BN * LD;
    for (int i = tid; i < BN * CH; i += NT_TC) {
      const int rr = i / CH, c = i % CH, kpos = t0 + rr;
      const bool live = kpos < kv_hi;
      const size_t off = (size_t)(live ? kpos : kv_lo) * tok + c * 8;
      cp_async16(ks + rr * LD + c * 8, kb + off, live);
      cp_async16(vs + rr * LD + c * 8, vb + off, live);
    }
  };

  for (int i = tid; i < BM * CH; i += NT_TC) {
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const bool live = r < R;
    cp_async16(q_s + rr * LD + c * 8, q + row_of(live ? r : r0) * D + c * 8,
               live);
  }
  if (n_tiles > 0) load_kv(kv_lo, 0);
  cp_async_commit();

  // this lane's two rows: wr + g4 and wr + g4 + 8
  int qpos[2];
  float m_run[2], l_run[2];   // l_run: this lane's share of the row sum
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    qpos[h2] = (r0 + wr + g4 + 8 * h2) / G;
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
    if (j + 1 < n_tiles) load_kv(t0 + BN, (j + 1) & 1);
    cp_async_commit();
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

    // scale, softcap and the mask (only where the tile crosses an edge)
    const bool edge = !(t0 + BN <= kv_hi &&
                        (!masked || t0 + BN - 1 <= s_first) &&
                        (window <= 0 || t0 > s_last - window));
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int kpos = t0 + n * 8 + 2 * t4 + (e & 1), qp = qpos[e >> 1];
          const bool valid = kpos < kv_hi && (!masked || kpos <= qp) &&
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

    // o += p v: p rounded to bf16 as the A operand, V through .trans
#pragma unroll
    for (int kk = 0; kk < NC / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, sc, kk);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + bt_offset(lane, LD, kk * 16, np * 16));
        mma(acc[2 * np], pa, vf[0], vf[1]);
        mma(acc[2 * np + 1], pa, vf[2], vf[3]);
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
    const size_t row = row_of(r);
    bf16* o = out + row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * h2] * inv, acc[n][2 * h2 + 1] * inv);
    if (t4 == 0) lse[row] = m_run[h2] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Skv, int Hkv, int G, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int BR = f32_rows(D);
  const size_t smem =
      sizeof(float) * ((size_t)BR * (D + 1) + (size_t)TILE * (D + 1) +
                       (size_t)TILE * D + (size_t)BR * (TILE + 1));
  const long long tiles = ((long long)Sq * G + BR - 1) / BR;
  if (tiles > 65535 || Hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, Hkv, (unsigned)tiles);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, Hkv, G, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <int D, int BM, int BN>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Sq, int Skv, int Hkv, int G, int causal,
                int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int NW = BM / 16;
  const size_t smem = sizeof(bf16) * (D + mma_bf16::PAD) * (BM + 4 * BN);
  const long long tiles = ((long long)Sq * G + BM - 1) / BM;
  if (tiles > 65535 || Hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!mma_bf16::aligned16({q, k, v, out}))
    return (int)cudaErrorMisalignedAddress;
  auto kern = flash_attention_bf16_kernel<D, NW, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, Hkv, (unsigned)tiles), 32 * NW, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Skv, Hkv, G, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound through ctypes.  Returns a cudaError_t (0 = launched).
// Element type: is_bf16 = 1 for bfloat16 (the tensor-core kernel; q, k, v
// and out 16-byte aligned, else cudaErrorMisalignedAddress), 0 for float32
// (the CUDA-core kernel); lse is always float32; head dim 64, 80 (zamba2's
// shared attention block), 128 or 256 (gemma3-4b).  (block_q, block_kv):
// the tile - for bfloat16 one of the three instantiated at the head dim
// below (hopper_mapping.K4_TILES), for float32 the kernel's one tile
// (f32_rows(D), 64).  Anything else returns cudaErrorInvalidValue without
// launching (the Python wrapper checks first).
#define K4_TILE(d, bq, bkv)                                                  \
  if (D == d && block_q == bq && block_kv == bkv)                           \
    return launch_bf16<d, bq, bkv>(q, k, v, out, lse, B, Sq, Skv, Hkv, G,    \
                                   causal, window, scale, softcap, s);
#define K4_F32(d)                                                            \
  if (D == d && block_q == f32_rows(d) && block_kv == TILE)                 \
    return launch<float, d>(q, k, v, out, lse, B, Sq, Skv, Hkv, G, causal,   \
                            window, scale, softcap, s);
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Skv, int Hkv, int G,
                                      int D, int causal, int window,
                                      int block_q, int block_kv, float scale,
                                      float softcap, int is_bf16,
                                      void* stream) {
  if (G < 1 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    K4_TILE(64, 64, 64) K4_TILE(64, 128, 32) K4_TILE(64, 128, 64)
    K4_TILE(80, 64, 64) K4_TILE(80, 128, 32) K4_TILE(80, 128, 64)
    K4_TILE(128, 64, 64) K4_TILE(128, 128, 128) K4_TILE(128, 128, 64)
    K4_TILE(256, 64, 64) K4_TILE(256, 128, 64) K4_TILE(256, 64, 32)
  } else {
    K4_F32(64) K4_F32(80) K4_F32(128) K4_F32(256)
  }
  return (int)cudaErrorInvalidValue;
}
