// Splash (block-sparse flash) attention forward and backward for training,
// for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of dstack_tpu/workloads/kernels/splash.py:
//   - splash_fwd_launch     -> `_splash_fwd_kernel` (through `_splash_fwd_3d`):
//     the online-softmax forward over the live KV tiles, o and lse;
//   - splash_bwd_dq_launch  -> `_splash_bwd_dq_kernel` (through
//     `_splash_bwd_3d`): dq over the same live KV tiles;
//   - splash_bwd_dkv_launch -> `_splash_bwd_dkv_kernel` (through
//     `_splash_bwd_3d`): dk and dv of one KV tile over the transposed band
//     of q tiles, summed over the n_rep query heads of its KV head.
//
// What they compute (the Pallas kernels' semantics): flash attention
// (csrc/flash_attention.cu: layouts, GQA, scale, NEG_INF guards, fp32 out)
// under the mask causal (key <= query) AND window (key > query - window,
// window 0 = none) AND same document (docq[b, query] == dock[b, key], only
// when document planes are given). The doc row of q row r is batch r / H,
// that of KV row g batch g / Kh. A row that sees no key has o = 0, lse =
// -1e30 and zero gradients.
//
// Two instantiations, chosen at compile time per (type, D) by
// TensorCore<T, D> and by_head_dim, never as a path taken when a launch
// fails:
//   - bf16 q/k/v at D = 32, 64 and 128: all three run on tensor cores
//     (splash_fwd_mma_kernel, splash_bwd_dq_mma_kernel,
//     splash_bwd_dkv_mma_kernel), on the bodies that flash's tensor-core
//     kernels run (attention_mma_kernels.cuh) under BandMask, with and
//     without document planes (DOCS, a template argument picked by whether
//     docq is given);
//   - fp32 inputs and the other head dims run the CUDA-core kernels below
//     (splash_fwd_kernel, splash_bwd_dq_kernel, splash_bwd_dkv_kernel) on
//     attention_cuda_core.cuh's 256-thread tiles, products and sums in fp32
//     FMAs.
//
// Block sparsity. The causal and window bounds are loop bounds at each
// kernel's own row and key tile edges (not the TPU kernel's block):
//   - fwd and dq: q tile [q0, q0 + ROWS) walks KV tiles [lo, hi) of KEYS
//     keys, lo = max(0, q0 - (window - 1)) / KEYS (clamped before dividing:
//     C division truncates toward zero, the reference floors), hi = the tile
//     after the one holding the key of the tile's last row (causal). Tensor
//     cores: 64 rows over 64 keys (fwd) or 32 keys (dq); CUDA cores: TILE x
//     TILE;
//   - dk/dv: KV tile [k0, k0 + KEYS) walks q tiles [k0 / ROWS, hi) of ROWS
//     rows, hi = the tile after the one holding row last_key + window - 1,
//     from the farthest (hi - 1) toward the diagonal, the n_rep heads
//     interleaved per q tile (the CUDA-core kernel also takes each tile's
//     queries last to first): the fp32 sums into dk and dv then meet the
//     small terms first, while the sums are still small. Tensor cores: 64
//     keys, 32 rows; CUDA cores: TILE x TILE.
// Those are the tensor-core tiles of the default menu pair; a launch takes
// its kernel's tile edge as flash_attention.cu's do (kernels/flash.py's
// TILE_MENU names them), and each bound is computed at the launch's tiles.
// Only tiles that cross the causal diagonal, the window's edge or the ragged
// end pay for element compares on the tensor-core path; with document planes
// every tile compares: document ids are element masks, as on the TPU (a tile
// wholly across documents is still read). The document ids of the KV tile
// (fwd, dq) or q tile (dk/dv) come into shared memory beside the tile (on
// the tensor-core path through the cp.async ring); the rows' or keys' own
// stay in registers. One block owns one output tile: no atomics, the result
// is deterministic.
//
// Bound at the train shapes (llama3_1b: B 2, H 16, Kh 8, D 128, T = S =
// 8192, bf16, window 4096): 25,167,872 live (query, key) pairs per head;
// the forward needs 4 D operations a pair, 4.1e11 in all (0.42 ms at 989
// TFLOP/s bf16), against 0.27 GB moved once (0.08 ms at 3.35 TB/s): bound by
// operations, as are dq (6 D a pair, 0.63 ms) and dk/dv (8 D, 0.83 ms). The
// tensor-core kernels split each fp32 operand into three bf16 terms, so the
// forward does 4 units of D multiply-adds a live pair (2x a plain bf16
// kernel), dq 7 (5 on a do of bf16 values, as in training) and dk/dv 13 (8
// on such a do), through mma.sync, which reaches a fraction of the dense
// rate that wgmma does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_cuda_core.cuh"
#include "attention_mma.cuh"
#include "attention_mma_kernels.cuh"

namespace {

using namespace attn_cc;
using attn_mma::NEG_INF;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on sm_90

// Shared memory of the largest kernel (dk/dv) at a tile edge: K, V and Q
// tiles of T, a do tile and two score tiles of floats, lse, delta and the q
// tile's document ids.
template <typename T, int D>
constexpr size_t dkv_smem_bytes(int tile) {
  return 3u * tile * (D + Pad<T>::value) * sizeof(T) + static_cast<size_t>(tile) * (D + 1) * 4 +
         2u * tile * (tile + 1) * 4 + 3u * tile * 4;
}

// Tile geometry for inputs of type T and head dim D.
template <typename T, int D>
struct Geo {
  static constexpr int LD = D + Pad<T>::value;  // a q/k/v tile row, elements of T
  static constexpr int LDF = D + 1;             // a do tile row, floats
  static constexpr int TILE = dkv_smem_bytes<T, D>(64) <= SMEM_LIMIT ? 64 : 32;
  static constexpr int R = TILE / 16;   // rows (and columns) of a thread's score sub-tile
  static constexpr int LDS = TILE + 1;  // a score tile row, floats
  static constexpr int NJ = D / 16;     // output columns a thread owns
};

// Document ids [pos0, pos0 + TILE) of one row of a doc plane into shared
// memory (0 past n; callers mask those positions anyway).
template <int TILE>
__device__ __forceinline__ void load_docs(int* dst, const int* __restrict__ row, int pos0, int n) {
  for (int c = threadIdx.x; c < TILE; c += THREADS) dst[c] = pos0 + c < n ? row[pos0 + c] : 0;
}

// The CUDA-core kernels take the band (lengths, causal, window, heads) as
// BandMask<false> and compare documents themselves, where docq is given.
using attn_mma::BandMask;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ docq, const int* __restrict__ dock,
                      float* __restrict__ o, float* __restrict__ lse, BandMask<false> bd,
                      float scale) {
  using G = Geo<T, D>;
  constexpr int TILE = G::TILE, R = G::R, NJ = G::NJ, LD = G::LD, LDS = G::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + TILE * LD;
  T* v_s = k_s + TILE * LD;
  float* p_s = reinterpret_cast<float*>(v_s + TILE * LD);
  int* dk_s = reinterpret_cast<int*>(p_s + TILE * LDS);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_q = (bd.t_len + TILE - 1) / TILE;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * TILE;
  const int bh = blockIdx.y;
  const int batch = bh / bd.heads, n_rep = bd.heads / bd.kv_heads;
  const T* qb = q + static_cast<size_t>(bh) * bd.t_len * D;
  const T* kb = k + static_cast<size_t>(bh / n_rep) * bd.s_len * D;
  const T* vb = v + static_cast<size_t>(bh / n_rep) * bd.s_len * D;
  const bool docs = docq != nullptr;
  const int lo = bd.kv_lo<TILE, TILE>(q0), hi = bd.kv_hi<TILE, TILE>(q0);

  load_tile<T, D, LD, TILE>(q_s, qb, q0, bd.t_len);
  float m[R], l[R], acc[R][NJ];
  int doc_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    doc_r[i] = docs && qp < bd.t_len ? docq[static_cast<size_t>(batch) * bd.t_len + qp] : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int jk = lo; jk < hi; ++jk) {
    const int k0 = jk * TILE;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D, LD, TILE>(k_s, kb, k0, bd.s_len);
    load_tile<T, D, LD, TILE>(v_s, vb, k0, bd.s_len);
    if (docs) load_docs<TILE>(dk_s, dock + static_cast<size_t>(batch) * bd.s_len, k0, bd.s_len);
    __syncthreads();
    float s[R][R];
    dot_rows<R, D>(s, q_s, LD, k_s, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
      bool ok[R];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        ok[j] = bd.sees(qp, k0 + c, 0, 0) && (!docs || doc_r[i] == dk_s[c]);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float safe_m = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - safe_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - safe_m) : 0.f;
        sum += p;
        p_s[(ty * R + i) * LDS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    add_pv<R, NJ, TILE>(acc, p_s, LDS, v_s, LD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= bd.t_len) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
    float* orow = o + (static_cast<size_t>(bh) * bd.t_len + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = acc[i][jj] / l_safe;
    if (tx == 0)
      lse[static_cast<size_t>(bh) * bd.t_len + qp] =
          (m[i] == NEG_INF ? NEG_INF : m[i]) + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    splash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ docq, const int* __restrict__ dock,
                         float* __restrict__ dq, BandMask<false> bd, float scale) {
  using G = Geo<T, D>;
  constexpr int TILE = G::TILE, R = G::R, NJ = G::NJ, LD = G::LD, LDF = G::LDF, LDS = G::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + TILE * LD;
  T* v_s = k_s + TILE * LD;
  float* do_s = reinterpret_cast<float*>(v_s + TILE * LD);
  float* ds_s = do_s + TILE * LDF;
  int* dk_s = reinterpret_cast<int*>(ds_s + TILE * LDS);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_q = (bd.t_len + TILE - 1) / TILE;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * TILE;
  const int bh = blockIdx.y;
  const int batch = bh / bd.heads, n_rep = bd.heads / bd.kv_heads;
  const size_t row_base = static_cast<size_t>(bh) * bd.t_len;
  const T* kb = k + static_cast<size_t>(bh / n_rep) * bd.s_len * D;
  const T* vb = v + static_cast<size_t>(bh / n_rep) * bd.s_len * D;
  const bool docs = docq != nullptr;
  const int lo = bd.kv_lo<TILE, TILE>(q0), hi = bd.kv_hi<TILE, TILE>(q0);

  load_tile<T, D, LD, TILE>(q_s, q + row_base * D, q0, bd.t_len);
  load_tile<float, D, LDF, TILE>(do_s, dout + row_base * D, q0, bd.t_len);
  float lse_r[R], delta_r[R], acc[R][NJ];
  int doc_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    const bool in = qp < bd.t_len;
    lse_r[i] = in ? lse[row_base + qp] : NEG_INF;
    delta_r[i] = in ? delta[row_base + qp] : 0.f;
    doc_r[i] = docs && in ? docq[static_cast<size_t>(batch) * bd.t_len + qp] : 0;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int jk = lo; jk < hi; ++jk) {
    const int k0 = jk * TILE;
    __syncthreads();
    load_tile<T, D, LD, TILE>(k_s, kb, k0, bd.s_len);
    load_tile<T, D, LD, TILE>(v_s, vb, k0, bd.s_len);
    if (docs) load_docs<TILE>(dk_s, dock + static_cast<size_t>(batch) * bd.s_len, k0, bd.s_len);
    __syncthreads();
    float s[R][R], dp[R][R];
    dot_rows<R, D>(s, q_s, LD, k_s, LD, ty, tx);
    dot_rows<R, D>(dp, do_s, LDF, v_s, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const bool ok = bd.sees(qp, k0 + c, 0, 0) && (!docs || doc_r[i] == dk_s[c]) &&
                        lse_r[i] != NEG_INF;
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(ty * R + i) * LDS + c] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    add_pv<R, NJ, TILE>(acc, ds_s, LDS, k_s, LD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= bd.t_len) continue;
    float* row = dq + (row_base + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) row[tx + 16 * jj] = acc[i][jj];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    splash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ docq, const int* __restrict__ dock,
                          float* __restrict__ dk, float* __restrict__ dv, BandMask<false> bd,
                          float scale) {
  using G = Geo<T, D>;
  constexpr int TILE = G::TILE, R = G::R, NJ = G::NJ, LD = G::LD, LDF = G::LDF, LDS = G::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + TILE * LD;
  T* q_s = v_s + TILE * LD;
  float* do_s = reinterpret_cast<float*>(q_s + TILE * LD);
  float* p_s = do_s + TILE * LDF;
  float* ds_s = p_s + TILE * LDS;
  float* lse_s = ds_s + TILE * LDS;
  float* delta_s = lse_s + TILE;
  int* dq_s = reinterpret_cast<int*>(delta_s + TILE);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * TILE;
  const int bkh = blockIdx.y;
  // Every q row of this KV row (bkh * n_rep + rep) lies in its batch.
  const int batch = bkh / bd.kv_heads, n_rep = bd.heads / bd.kv_heads;
  const bool docs = docq != nullptr;
  const int iq_lo = bd.q_lo<TILE, TILE>(k0), iq_hi = bd.q_hi<TILE, TILE>(k0);

  load_tile<T, D, LD, TILE>(k_s, k + static_cast<size_t>(bkh) * bd.s_len * D, k0, bd.s_len);
  load_tile<T, D, LD, TILE>(v_s, v + static_cast<size_t>(bkh) * bd.s_len * D, k0, bd.s_len);
  float dk_acc[R][NJ], dv_acc[R][NJ];
  int doc_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty * R + i;
    doc_r[i] = docs && kp < bd.s_len ? dock[static_cast<size_t>(batch) * bd.s_len + kp] : 0;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;
  }

  // From the farthest q tile of the band toward the diagonal, the heads
  // interleaved (see the note at the top).
  for (int iq = iq_hi - 1; iq >= iq_lo; --iq) {
    const int q0 = iq * TILE;
    for (int rep = 0; rep < n_rep; ++rep) {
      const size_t row_base = (static_cast<size_t>(bkh) * n_rep + rep) * bd.t_len;
      __syncthreads();
      load_tile<T, D, LD, TILE>(q_s, q + row_base * D, q0, bd.t_len);
      load_tile<float, D, LDF, TILE>(do_s, dout + row_base * D, q0, bd.t_len);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        const bool in = q0 + r < bd.t_len;
        lse_s[r] = in ? lse[row_base + q0 + r] : NEG_INF;
        delta_s[r] = in ? delta[row_base + q0 + r] : 0.f;
      }
      if (docs) load_docs<TILE>(dq_s, docq + static_cast<size_t>(batch) * bd.t_len, q0, bd.t_len);
      __syncthreads();
      // Transposed scores: rows are this block's keys, columns the queries.
      float st[R][R], dpt[R][R];
      dot_rows<R, D>(st, k_s, LD, q_s, LD, ty, tx);
      dot_rows<R, D>(dpt, v_s, LD, do_s, LDF, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          const int qp = q0 + c;
          const float l = lse_s[c];
          const bool ok = qp < bd.t_len && bd.sees(qp, kp, 0, 0) && (!docs || dq_s[c] == doc_r[i]) &&
                          l != NEG_INF;
          const float p = ok ? expf(st[i][j] * scale - l) : 0.f;
          p_s[(ty * R + i) * LDS + c] = p;
          ds_s[(ty * R + i) * LDS + c] = p * (dpt[i][j] - delta_s[c]) * scale;
        }
      }
      __syncthreads();
      add_pv<R, NJ, TILE, true>(dv_acc, p_s, LDS, do_s, LDF, ty, tx);
      add_pv<R, NJ, TILE, true>(dk_acc, ds_s, LDS, q_s, LD, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty * R + i;
    if (kp >= bd.s_len) continue;
    const size_t off = (static_cast<size_t>(bkh) * bd.s_len + kp) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      dk[off + tx + 16 * jj] = dk_acc[i][jj];
      dv[off + tx + 16 * jj] = dv_acc[i][jj];
    }
  }
}

// -- tensor-core kernels (bf16, D = 32, 64, 128) --------------------------------

using bf16 = __nv_bfloat16;
using attn_mma::by_tile;
using attn_mma::DKV_KEYS;
using attn_mma::DQ_ROWS;
using attn_mma::FWD_ROWS;
using attn_mma::MMA_THREADS;
using attn_mma::TensorCore;

// The forward under the band (and, with DOCS, the documents):
// attention_mma_kernels.cuh's body, which flash shares; KEYS keys a K/V
// tile.
template <int D, bool DOCS, int KEYS>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    splash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int n_rep, float scale, BandMask<DOCS> mask) {
  attn_mma::fwd_mma_body<D, KEYS>(q, k, v, o, lse, n_rep, scale, mask);
}

// dq under the same mask; KEYS keys a K/V tile.
template <int D, bool DOCS, int KEYS>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    splash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int n_rep, float scale,
                             BandMask<DOCS> mask) {
  attn_mma::dq_mma_body<D, KEYS>(q, k, v, dout, lse, delta, dq, n_rep, scale, mask);
}

// dk/dv under the same mask; ROWS q rows a step.
template <int D, bool DOCS, int ROWS>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    splash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int n_rep,
                              float scale, BandMask<DOCS> mask) {
  attn_mma::dkv_mma_body<D, ROWS>(q, k, v, dout, lse, delta, dk, dv, n_rep, scale, mask);
}

// tile: the tensor-core kernel's tile edge (fwd and dq: keys of the K/V
// tile; dk/dv: q rows a step); the CUDA-core kernels ignore it.
struct Shape {
  int b, bh, bkh, t_len, s_len, causal, window;
  float scale;
  cudaStream_t stream;
  int tile;
  template <bool DOCS>
  BandMask<DOCS> mask(const int* docq, const int* dock) const {
    return BandMask<DOCS>{t_len, s_len, causal, window, docq, dock, bh / b, bkh / b};
  }
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct FwdArgs {
  const void *q, *k, *v;
  const int *docq, *dock;
  float *o, *lse;
  Shape sh;

  template <int D, bool DOCS>
  cudaError_t launch_mma() const {
    return by_tile<32, 64>(sh.tile, [&](auto tile) {
      constexpr int KEYS = decltype(tile)::value;
      constexpr size_t smem = attn_mma::fwd_mma_smem_bytes<D, KEYS, BandMask<DOCS>>();
      static_assert(smem <= SMEM_LIMIT, "splash fwd: shared memory");
      auto kernel = splash_fwd_mma_kernel<D, DOCS, KEYS>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.t_len + FWD_ROWS - 1) / FWD_ROWS, sh.bh);
      kernel<<<grid, MMA_THREADS, smem, sh.stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          o, lse, sh.bh / sh.bkh, sh.scale, sh.mask<DOCS>(docq, dock));
      return cudaGetLastError();
    });
  }

  template <typename T, int D>
  cudaError_t launch() const {
    if constexpr (TensorCore<T, D>::value) {
      return docq ? launch_mma<D, true>() : launch_mma<D, false>();
    } else {
      using G = Geo<T, D>;
      const size_t smem =
          3u * G::TILE * G::LD * sizeof(T) + G::TILE * G::LDS * 4u + G::TILE * 4u;
      auto kernel = splash_fwd_kernel<T, D>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.t_len + G::TILE - 1) / G::TILE, sh.bh);
      kernel<<<grid, THREADS, smem, sh.stream>>>(static_cast<const T*>(q),
                                                 static_cast<const T*>(k),
                                                 static_cast<const T*>(v), docq, dock, o, lse,
                                                 sh.mask<false>(nullptr, nullptr), sh.scale);
      return cudaGetLastError();
    }
  }
};

struct DqArgs {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  const int *docq, *dock;
  float* dq;
  Shape sh;

  template <int D, bool DOCS>
  cudaError_t launch_mma() const {
    return by_tile<16, 32, 64>(sh.tile, [&](auto tile) {
      constexpr int KEYS = decltype(tile)::value;
      constexpr size_t smem = attn_mma::dq_mma_smem_bytes<D, KEYS, BandMask<DOCS>>();
      static_assert(smem <= SMEM_LIMIT, "splash dq: shared memory");
      auto kernel = splash_bwd_dq_mma_kernel<D, DOCS, KEYS>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.t_len + DQ_ROWS - 1) / DQ_ROWS, sh.bh);
      kernel<<<grid, MMA_THREADS, smem, sh.stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          dout, lse, delta, dq, sh.bh / sh.bkh, sh.scale, sh.mask<DOCS>(docq, dock));
      return cudaGetLastError();
    });
  }

  template <typename T, int D>
  cudaError_t launch() const {
    if constexpr (TensorCore<T, D>::value) {
      return docq ? launch_mma<D, true>() : launch_mma<D, false>();
    } else {
      using G = Geo<T, D>;
      const size_t smem = 3u * G::TILE * G::LD * sizeof(T) + G::TILE * G::LDF * 4u +
                          G::TILE * G::LDS * 4u + G::TILE * 4u;
      auto kernel = splash_bwd_dq_kernel<T, D>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.t_len + G::TILE - 1) / G::TILE, sh.bh);
      kernel<<<grid, THREADS, smem, sh.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), dout, lse,
          delta, docq, dock, dq, sh.mask<false>(nullptr, nullptr), sh.scale);
      return cudaGetLastError();
    }
  }
};

struct DkvArgs {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  const int *docq, *dock;
  float *dk, *dv;
  Shape sh;

  template <int D, bool DOCS>
  cudaError_t launch_mma() const {
    return by_tile<16, 32, 64>(sh.tile, [&](auto tile) {
      constexpr int ROWS = decltype(tile)::value;
      constexpr size_t smem = attn_mma::dkv_mma_smem_bytes<D, ROWS, BandMask<DOCS>>();
      static_assert(smem <= SMEM_LIMIT, "splash dk/dv: shared memory");
      auto kernel = splash_bwd_dkv_mma_kernel<D, DOCS, ROWS>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.s_len + DKV_KEYS - 1) / DKV_KEYS, sh.bkh);
      kernel<<<grid, MMA_THREADS, smem, sh.stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          dout, lse, delta, dk, dv, sh.bh / sh.bkh, sh.scale, sh.mask<DOCS>(docq, dock));
      return cudaGetLastError();
    });
  }

  template <typename T, int D>
  cudaError_t launch() const {
    if constexpr (TensorCore<T, D>::value) {
      return docq ? launch_mma<D, true>() : launch_mma<D, false>();
    } else {
      using G = Geo<T, D>;
      const size_t smem = dkv_smem_bytes<T, D>(G::TILE);
      auto kernel = splash_bwd_dkv_kernel<T, D>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.s_len + G::TILE - 1) / G::TILE, sh.bkh);
      kernel<<<grid, THREADS, smem, sh.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), dout, lse,
          delta, docq, dock, dk, dv, sh.mask<false>(nullptr, nullptr), sh.scale);
      return cudaGetLastError();
    }
  }
};

// args.launch<T, D>() for the runtime dtype code (0 = float32, 1 = bfloat16)
// and head dim D = 32, 64, ..., 256. Before it, the shape is validated and an
// error left by an earlier call of this library (a refused
// cudaFuncSetAttribute, say) is cleared, so a launch reports only its own.
template <typename T, typename Args>
cudaError_t by_head_dim(int D, const Args& args) {
  switch (D) {
    case 32: return args.template launch<T, 32>();
    case 64: return args.template launch<T, 64>();
    case 96: return args.template launch<T, 96>();
    case 128: return args.template launch<T, 128>();
    case 160: return args.template launch<T, 160>();
    case 192: return args.template launch<T, 192>();
    case 224: return args.template launch<T, 224>();
    case 256: return args.template launch<T, 256>();
    default: return cudaErrorInvalidValue;
  }
}

// What splash_fwd_launch (kernel 0), splash_bwd_dq_launch (1) and
// splash_bwd_dkv_launch (2) run for inputs of type T and head dim D, with
// their mma work in units of D multiply-adds a live (query, key) pair.
template <typename T, int D>
const char* describe(int kernel) {
  if (!TensorCore<T, D>::value)
    return kernel == 0   ? "CUDA cores, fp32 FMAs (splash_fwd_kernel)"
           : kernel == 1 ? "CUDA cores, fp32 FMAs (splash_bwd_dq_kernel)"
                         : "CUDA cores, fp32 FMAs (splash_bwd_dkv_kernel)";
  if (kernel == 0)
    return "bf16 tensor cores (splash_fwd_mma_kernel: flash's forward body under the band"
           " mask, mma.sync m16n8k16 + cp.async ring), P in 3 bf16 terms; mma work 4 units a"
           " live pair (QK 1 + PV 3) against a plain bf16 kernel's 2";
  if (kernel == 1)
    return "bf16 tensor cores (splash_bwd_dq_mma_kernel: flash's dq body under the band mask,"
           " mma.sync m16n8k16 + cp.async ring of 32-key tiles), do in 3 bf16 planes, dS in 3"
           " terms; mma work 7 units a live pair (QK 1 + dOV 3 + dSK 3) against a plain bf16"
           " kernel's 3, 5 on tiles whose do holds bf16 values";
  return "bf16 tensor cores (splash_bwd_dkv_mma_kernel: flash's dk/dv body under the band"
         " mask, mma.sync m16n8k16 + cp.async), do in 3 bf16 planes, P and dS in 3 terms; mma"
         " work 13 units a live pair (KQ 1 + VdO 3 + PdO 6 + dSQ 3) against a plain kernel's 4,"
         " 8 on tiles whose do holds bf16 values";
}

struct DescribeArgs {
  int kernel;
  const char** out;
  template <typename T, int D>
  cudaError_t launch() const {
    *out = describe<T, D>(kernel);
    return cudaSuccess;
  }
};

template <typename Args>
int dispatch(int dtype, int D, const Args& args) {
  (void)cudaGetLastError();
  const Shape& sh = args.sh;
  if (sh.b <= 0 || sh.bkh <= 0 || sh.bh % sh.bkh != 0 || sh.bh % sh.b != 0 ||
      sh.bkh % sh.b != 0 || sh.t_len < 0 || sh.s_len < 0 || sh.window < 0 ||
      (args.docq == nullptr) != (args.dock == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sh.bh == 0 || sh.t_len == 0 || sh.s_len == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0) return static_cast<int>(by_head_dim<float>(D, args));
  if (dtype == 1) return static_cast<int>(by_head_dim<__nv_bfloat16>(D, args));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). q [BH, T, D],
// k/v [BKh, S, D]; docq [B, T] and dock [B, S] int32, or both null (no
// document mask; B is then 1); o [BH, T, D] and lse [BH, T] fp32. window 0
// means no window. tile: the tensor-core kernel's tile edge (32 or 64 keys);
// any other returns cudaErrorInvalidValue.
int splash_fwd_launch(int dtype, const void* q, const void* k, const void* v, const int* docq,
                      const int* dock, float* o, float* lse, int B, int BH, int BKh, int T, int S,
                      int D, int causal, int window, float scale, int tile, void* stream) {
  const Shape sh{B, BH, BKh, T, S, causal, window, scale, static_cast<cudaStream_t>(stream),
                 tile};
  return dispatch(dtype, D, FwdArgs{q, k, v, docq, dock, o, lse, sh});
}

// do [BH, T, D], lse and delta [BH, T], all fp32; dq [BH, T, D] fp32. tile:
// keys of the K/V tile, 16, 32 or 64.
int splash_bwd_dq_launch(int dtype, const void* q, const void* k, const void* v,
                         const float* dout, const float* lse, const float* delta,
                         const int* docq, const int* dock, float* dq, int B, int BH, int BKh,
                         int T, int S, int D, int causal, int window, float scale, int tile,
                         void* stream) {
  const Shape sh{B, BH, BKh, T, S, causal, window, scale, static_cast<cudaStream_t>(stream),
                 tile};
  return dispatch(dtype, D, DqArgs{q, k, v, dout, lse, delta, docq, dock, dq, sh});
}

// As dq; dk, dv [BKh, S, D] fp32. tile: q rows a step, 16, 32 or 64.
int splash_bwd_dkv_launch(int dtype, const void* q, const void* k, const void* v,
                          const float* dout, const float* lse, const float* delta,
                          const int* docq, const int* dock, float* dk, float* dv, int B, int BH,
                          int BKh, int T, int S, int D, int causal, int window, float scale,
                          int tile, void* stream) {
  const Shape sh{B, BH, BKh, T, S, causal, window, scale, static_cast<cudaStream_t>(stream),
                 tile};
  return dispatch(dtype, D, DkvArgs{q, k, v, dout, lse, delta, docq, dock, dk, dv, sh});
}

// The instantiation that a launch of kernel 0 (fwd), 1 (dq) or 2 (dk/dv)
// runs for this dtype code and head dim; null where none does.
const char* splash_instantiation(int kernel, int dtype, int D) {
  const char* out = nullptr;
  if (kernel < 0 || kernel > 2) return out;
  const DescribeArgs args{kernel, &out};
  if (dtype == 0) (void)by_head_dim<float>(D, args);
  if (dtype == 1) (void)by_head_dim<__nv_bfloat16>(D, args);
  return out;
}

const char* splash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
