// Flash attention forward and backward for training, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of dstack_tpu/workloads/kernels/flash.py:
//   - flash_fwd_launch      -> `_fwd_kernel` (through `_flash_fwd_3d`): the
//     online-softmax forward, o and the logsumexp residual lse;
//   - flash_bwd_dq_launch   -> `_bwd_dq_kernel` (through `_flash_bwd_3d`): dq
//     from lse and delta = rowsum(do * o);
//   - flash_bwd_dkv_launch  -> `_bwd_dkv_kernel` (through `_flash_bwd_3d`):
//     dk and dv of one KV tile, summed over the n_rep query heads that share
//     the KV head.
//
// What they compute (the Pallas kernels' semantics): q [BH, T, D] and k, v
// [BKh, S, D] of float32 or bfloat16; query row b reads KV row b / n_rep
// (GQA without copies). Scale 1/sqrt(D); under causal masking key j is seen
// by query i when j <= i (both counted from 0); masked scores are -1e30; the
// running max is NEG_INF-safe; o = acc / max(l, 1e-20) and lse = m +
// log(max(l, 1e-20)) in fp32, lse = -1e30 on a row that sees nothing, whose
// gradients are then zero. Sums are fp32 and every product is exact in
// fp32 (as the Pallas kernels' fp32 dots); do is fp32.
//
// Two instantiations. bf16 q/k/v at D = 32, 64 and 128 (the head dims of
// every preset: `test` 32, `gpt2_125m` 64, llama3_1b/llama3_8b 128) run all
// three kernels on tensor cores (flash_fwd_mma_kernel,
// flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel); fp32 inputs and the
// other head dims run the CUDA-core kernels (flash_fwd_kernel,
// flash_bwd_dq_kernel, flash_bwd_dkv_kernel). The choice is made at compile
// time per (type, D) in TensorCore<T, D> and by_head_dim, never as a path
// taken when a launch fails.
//
// Tensor-core design (attention_mma.cuh has the warp-level pieces and the
// numerics). Products are mma.sync.m16n8k16 bf16 -> fp32; the fp32 operands
// (p, ds, do) are split into three bf16 terms, so every product is exact.
// The card's mma truncates its fp32 result toward zero and drops addend
// bits below 2^-25 of the largest addend (one mma on crafted tiles, on an
// H100), so no long sum runs inside the tensor cores: a score tile takes
// its D / 16 mma in place, and every other sum runs its mma in short
// stretches (16 dims, or 16 to 64 keys or queries, with their split terms)
// into a zeroed register tile that one fp32 add, rounded to nearest, puts
// into the running sum.
//   - the bodies in attention_mma_kernels.cuh (which states their designs),
//     shared with splash, under CausalMask: only tiles that cross the causal
//     diagonal or the ragged end pay for the mask compares. fwd: a block of 4
//     warps owns 64 q rows; 64-key K/V tiles stream through a 2-stage
//     cp.async ring; S, the online softmax and P stay in registers; O += P_i
//     V with P in 3 bf16 terms. mma work a live (query, key) pair: 1 (QK) + 3
//     (PV) = 4 units of D multiply-adds, against a plain bf16 kernel's 2.
//     dq: the forward's walk over 32-key K/V tiles, do split once into three
//     bf16 planes, dQ += dS K with dS in 3 terms; mma work a pair 1 + 3 + 3 =
//     7 units against a plain bf16 kernel's 3, 5 when do holds bf16 values
//     (training). dk/dv: one block per (64-key KV tile, BKh row) owns its dk
//     and dv in registers and walks 32-row q tiles from the farthest to the
//     causal diagonal, the n_rep heads interleaved; mma work a pair 1 + 3 + 6
//     + 3 = 13 units against a plain kernel's 4, 8 when do holds bf16 values.
//
// Tiles. The tile sizes above are the default menu pair's, (64, 64). Each
// launch function takes its tensor-core kernel's tile edge (the forward's
// and dq's K/V tile, dk/dv's q step; kernels/flash.py's TILE_MENU maps a
// (block_q, block_kv) pair to them): each kernel is instantiated at the
// edges its by_tile lists, and any other edge returns
// cudaErrorInvalidValue. The CUDA-core kernels keep their own tiles.
//
// CUDA-core design (fp32, other D): attention_cuda_core.cuh's 256-thread
// tiles (TILE = 64, or 32 where 64 does not fit shared memory: fp32 with D >
// 192), products and sums in fp32 FMAs. The forward and dq kernels take one
// block per (q tile, BH row) and walk the KV tiles the last row can see;
// dk/dv takes one block per (KV tile, BKh row) and walks its q tiles as the
// tensor-core kernel does.
// Blocks with the most causal work start first (the last q tile for fwd/dq,
// the first KV tile for dk/dv). Rows and keys past T or S are masked, so a
// ragged last tile is right.
//
// Bound at the train shapes (llama3_1b: B 2, H 16, Kh 8, D 128, T = S = 8192,
// bf16, causal): the forward does 4*B*H*D*T*T/2 = 5.5e11 flop (0.56 ms at
// 989 TFLOP/s) and moves q, k, v in bf16 and o, lse in fp32 once, 0.27 GB
// (0.08 ms at 3.35 TB/s): bound by operations, as are dq (1.5x the forward's
// flop, 0.8339 ms) and dk/dv (2x, 1.11 ms). The split doubles the forward's
// mma work, multiplies dq's by 2.33 (1.67 with bf16-valued do) and dk/dv's
// by 3.25 (2), and mma.sync reaches a fraction of the dense rate that wgmma
// does, so these kernels stay above the bound by more than that factor.
//
// Left for later: wgmma (64-row warpgroup tiles, B from swizzled shared
// memory through descriptors) with TMA loads and mbarriers, a producer warp
// and a deeper ring; splitting a long causal row's KV walk across blocks.

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
// tiles of T, a do tile and two score tiles of floats, lse and delta.
template <typename T, int D>
constexpr size_t dkv_smem_bytes(int tile) {
  return 3u * tile * (D + Pad<T>::value) * sizeof(T) + static_cast<size_t>(tile) * (D + 1) * 4 +
         2u * tile * (tile + 1) * 4 + 2u * tile * 4;
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

using attn_mma::CausalMask;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int T_len, int S_len,
                     int n_rep, int causal, float scale) {
  using G = Geo<T, D>;
  constexpr int TILE = G::TILE, R = G::R, NJ = G::NJ, LD = G::LD, LDS = G::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + TILE * LD;
  T* v_s = k_s + TILE * LD;
  float* p_s = reinterpret_cast<float*>(v_s + TILE * LD);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_q = (T_len + TILE - 1) / TILE;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * TILE;
  const int bh = blockIdx.y;
  const T* qb = q + static_cast<size_t>(bh) * T_len * D;
  const T* kb = k + static_cast<size_t>(bh / n_rep) * S_len * D;
  const T* vb = v + static_cast<size_t>(bh / n_rep) * S_len * D;
  const int hi = CausalMask{T_len, S_len, causal}.kv_hi<TILE, TILE>(q0);

  load_tile<T, D, LD, TILE>(q_s, qb, q0, T_len);
  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int jk = 0; jk < hi; ++jk) {
    const int k0 = jk * TILE;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D, LD, TILE>(k_s, kb, k0, S_len);
    load_tile<T, D, LD, TILE>(v_s, vb, k0, S_len);
    __syncthreads();
    float s[R][R];
    dot_rows<R, D>(s, q_s, LD, k_s, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S_len && (!causal || kp <= qp);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float safe_m = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - safe_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S_len && (!causal || kp <= qp);
        const float p = ok ? expf(s[i][j] - safe_m) : 0.f;
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
    if (qp >= T_len) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
    float* orow = o + (static_cast<size_t>(bh) * T_len + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = acc[i][jj] / l_safe;
    if (tx == 0)
      lse[static_cast<size_t>(bh) * T_len + qp] = (m[i] == NEG_INF ? NEG_INF : m[i]) + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int T_len,
                        int S_len, int n_rep, int causal, float scale) {
  using G = Geo<T, D>;
  constexpr int TILE = G::TILE, R = G::R, NJ = G::NJ, LD = G::LD, LDF = G::LDF, LDS = G::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + TILE * LD;
  T* v_s = k_s + TILE * LD;
  float* do_s = reinterpret_cast<float*>(v_s + TILE * LD);
  float* ds_s = do_s + TILE * LDF;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_q = (T_len + TILE - 1) / TILE;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * TILE;
  const int bh = blockIdx.y;
  const size_t row_base = static_cast<size_t>(bh) * T_len;
  const T* kb = k + static_cast<size_t>(bh / n_rep) * S_len * D;
  const T* vb = v + static_cast<size_t>(bh / n_rep) * S_len * D;
  const int hi = CausalMask{T_len, S_len, causal}.kv_hi<TILE, TILE>(q0);

  load_tile<T, D, LD, TILE>(q_s, q + row_base * D, q0, T_len);
  load_tile<float, D, LDF, TILE>(do_s, dout + row_base * D, q0, T_len);
  float lse_r[R], delta_r[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    lse_r[i] = qp < T_len ? lse[row_base + qp] : NEG_INF;
    delta_r[i] = qp < T_len ? delta[row_base + qp] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int jk = 0; jk < hi; ++jk) {
    const int k0 = jk * TILE;
    __syncthreads();
    load_tile<T, D, LD, TILE>(k_s, kb, k0, S_len);
    load_tile<T, D, LD, TILE>(v_s, vb, k0, S_len);
    __syncthreads();
    float s[R][R], dp[R][R];
    dot_rows<R, D>(s, q_s, LD, k_s, LD, ty, tx);
    dot_rows<R, D>(dp, do_s, LDF, v_s, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S_len && (!causal || kp <= qp) && lse_r[i] != NEG_INF;
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(ty * R + i) * LDS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    add_pv<R, NJ, TILE>(acc, ds_s, LDS, k_s, LD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= T_len) continue;
    float* row = dq + (row_base + qp) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) row[tx + 16 * jj] = acc[i][jj];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int T_len, int S_len,
                         int n_rep, int causal, float scale) {
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

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * TILE;
  const int bkh = blockIdx.y;
  const int n_q = (T_len + TILE - 1) / TILE;
  // q tiles strictly before this KV tile see none of it under causal masking.
  const int iq_lo = causal ? k0 / TILE : 0;

  load_tile<T, D, LD, TILE>(k_s, k + static_cast<size_t>(bkh) * S_len * D, k0, S_len);
  load_tile<T, D, LD, TILE>(v_s, v + static_cast<size_t>(bkh) * S_len * D, k0, S_len);
  float dk_acc[R][NJ], dv_acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  // From the last q tile toward the diagonal, the heads interleaved and each
  // tile's queries last to first, as the tensor-core kernel walks (the small
  // terms meet the fp32 sums first).
  for (int iq = n_q - 1; iq >= iq_lo; --iq) {
    const int q0 = iq * TILE;
    for (int rep = 0; rep < n_rep; ++rep) {
      const size_t row_base = (static_cast<size_t>(bkh) * n_rep + rep) * T_len;
      __syncthreads();
      load_tile<T, D, LD, TILE>(q_s, q + row_base * D, q0, T_len);
      load_tile<float, D, LDF, TILE>(do_s, dout + row_base * D, q0, T_len);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        const bool in = q0 + r < T_len;
        lse_s[r] = in ? lse[row_base + q0 + r] : NEG_INF;
        delta_s[r] = in ? delta[row_base + q0 + r] : 0.f;
      }
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
          const bool ok = qp < T_len && kp < S_len && (!causal || kp <= qp) && l != NEG_INF;
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
    if (kp >= S_len) continue;
    const size_t off = (static_cast<size_t>(bkh) * S_len + kp) * D;
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

// The forward under causal (or no) masking: attention_mma_kernels.cuh's
// body, whose mask policy folds to flash's bounds; KEYS keys a K/V tile.
template <int D, int KEYS>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int T_len, int S_len, int n_rep, int causal,
                         float scale) {
  attn_mma::fwd_mma_body<D, KEYS>(q, k, v, o, lse, n_rep, scale, CausalMask{T_len, S_len, causal});
}

// dq under causal (or no) masking: attention_mma_kernels.cuh's body; KEYS
// keys a K/V tile.
template <int D, int KEYS>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int T_len, int S_len, int n_rep, int causal,
                            float scale) {
  attn_mma::dq_mma_body<D, KEYS>(q, k, v, dout, lse, delta, dq, n_rep, scale,
                           CausalMask{T_len, S_len, causal});
}

// dk/dv under causal (or no) masking: attention_mma_kernels.cuh's body;
// ROWS q rows a step.
template <int D, int ROWS>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int T_len,
                             int S_len, int n_rep, int causal, float scale) {
  attn_mma::dkv_mma_body<D, ROWS>(q, k, v, dout, lse, delta, dk, dv, n_rep, scale,
                            CausalMask{T_len, S_len, causal});
}

// tile: the tensor-core kernel's tile edge (fwd and dq: keys of the K/V
// tile; dk/dv: q rows a step); the CUDA-core kernels ignore it.
struct Shape {
  int bh, bkh, t_len, s_len, causal;
  float scale;
  cudaStream_t stream;
  int tile;
  int n_rep() const { return bh / bkh; }
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct FwdArgs {
  const void *q, *k, *v;
  float *o, *lse;
  Shape sh;

  template <typename T, int D>
  cudaError_t launch() const {
    if constexpr (TensorCore<T, D>::value) {
      return by_tile<32, 64>(sh.tile, [&](auto tile) {
        constexpr int KEYS = decltype(tile)::value;
        constexpr size_t smem = attn_mma::fwd_mma_smem_bytes<D, KEYS, CausalMask>();
        static_assert(smem <= SMEM_LIMIT, "flash fwd: shared memory");
        auto kernel = flash_fwd_mma_kernel<D, KEYS>;
        const cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid((sh.t_len + FWD_ROWS - 1) / FWD_ROWS, sh.bh);
        kernel<<<grid, MMA_THREADS, smem, sh.stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), o, lse, sh.t_len, sh.s_len, sh.n_rep(), sh.causal,
            sh.scale);
        return cudaGetLastError();
      });
    } else {
      using G = Geo<T, D>;
      const size_t smem = 3u * G::TILE * G::LD * sizeof(T) + G::TILE * G::LDS * 4u;
      auto kernel = flash_fwd_kernel<T, D>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.t_len + G::TILE - 1) / G::TILE, sh.bh);
      kernel<<<grid, THREADS, smem, sh.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, lse,
          sh.t_len, sh.s_len, sh.n_rep(), sh.causal, sh.scale);
      return cudaGetLastError();
    }
  }
};

struct DqArgs {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  float* dq;
  Shape sh;

  template <typename T, int D>
  cudaError_t launch() const {
    if constexpr (TensorCore<T, D>::value) {
      return by_tile<16, 32, 64>(sh.tile, [&](auto tile) {
        constexpr int KEYS = decltype(tile)::value;
        constexpr size_t smem = attn_mma::dq_mma_smem_bytes<D, KEYS, CausalMask>();
        static_assert(smem <= SMEM_LIMIT, "flash dq: shared memory");
        auto kernel = flash_bwd_dq_mma_kernel<D, KEYS>;
        const cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid((sh.t_len + DQ_ROWS - 1) / DQ_ROWS, sh.bh);
        kernel<<<grid, MMA_THREADS, smem, sh.stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), dout, lse, delta, dq, sh.t_len, sh.s_len, sh.n_rep(),
            sh.causal, sh.scale);
        return cudaGetLastError();
      });
    } else {
      using G = Geo<T, D>;
      const size_t smem = 3u * G::TILE * G::LD * sizeof(T) + G::TILE * G::LDF * 4u +
                          G::TILE * G::LDS * 4u;
      auto kernel = flash_bwd_dq_kernel<T, D>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.t_len + G::TILE - 1) / G::TILE, sh.bh);
      kernel<<<grid, THREADS, smem, sh.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), dout, lse,
          delta, dq, sh.t_len, sh.s_len, sh.n_rep(), sh.causal, sh.scale);
      return cudaGetLastError();
    }
  }
};

struct DkvArgs {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  float *dk, *dv;
  Shape sh;

  template <typename T, int D>
  cudaError_t launch() const {
    if constexpr (TensorCore<T, D>::value) {
      return by_tile<16, 32, 64>(sh.tile, [&](auto tile) {
        constexpr int ROWS = decltype(tile)::value;
        constexpr size_t smem = attn_mma::dkv_mma_smem_bytes<D, ROWS, CausalMask>();
        static_assert(smem <= SMEM_LIMIT, "flash dk/dv: shared memory");
        auto kernel = flash_bwd_dkv_mma_kernel<D, ROWS>;
        const cudaError_t err = prepare(kernel, smem);
        if (err != cudaSuccess) return err;
        const dim3 grid((sh.s_len + DKV_KEYS - 1) / DKV_KEYS, sh.bkh);
        kernel<<<grid, MMA_THREADS, smem, sh.stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), dout, lse, delta, dk, dv, sh.t_len, sh.s_len,
            sh.n_rep(), sh.causal, sh.scale);
        return cudaGetLastError();
      });
    } else {
      using G = Geo<T, D>;
      const size_t smem = dkv_smem_bytes<T, D>(G::TILE);
      auto kernel = flash_bwd_dkv_kernel<T, D>;
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sh.s_len + G::TILE - 1) / G::TILE, sh.bkh);
      kernel<<<grid, THREADS, smem, sh.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), dout, lse,
          delta, dk, dv, sh.t_len, sh.s_len, sh.n_rep(), sh.causal, sh.scale);
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

// What flash_fwd_launch (kernel 0), flash_bwd_dq_launch (1) and
// flash_bwd_dkv_launch (2) run for inputs of type T and head dim D, with
// their mma work in units of D multiply-adds a live (query, key) pair.
template <typename T, int D>
const char* describe(int kernel) {
  if (!TensorCore<T, D>::value)
    return "CUDA cores, fp32 FMAs (flash_fwd_kernel / flash_bwd_dq_kernel / flash_bwd_dkv_kernel)";
  if (kernel == 0)
    return "bf16 tensor cores (flash_fwd_mma_kernel: mma.sync m16n8k16 + cp.async ring),"
           " P in 3 bf16 terms; mma work 4 units a pair (QK 1 + PV 3) against a plain bf16"
           " kernel's 2";
  if (kernel == 1)
    return "bf16 tensor cores (flash_bwd_dq_mma_kernel: mma.sync m16n8k16 + cp.async ring),"
           " do in 3 bf16 planes, dS in 3 terms; mma work 7 units a pair (QK 1 + dOV 3 + dSK 3)"
           " against a plain bf16 kernel's 3, 5 on tiles whose do holds bf16 values";
  return "bf16 tensor cores (flash_bwd_dkv_mma_kernel: mma.sync m16n8k16 + cp.async),"
         " do in 3 bf16 planes, P and dS in 3 terms; mma work 13 units a pair (KQ 1 + VdO 3 +"
         " PdO 6 + dSQ 3) against a plain kernel's 4, 8 on tiles whose do holds bf16 values";
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
  if (sh.bkh <= 0 || sh.bh % sh.bkh != 0 || sh.t_len < 0 || sh.s_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sh.bh == 0 || sh.t_len == 0 || sh.s_len == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0) return static_cast<int>(by_head_dim<float>(D, args));
  if (dtype == 1) return static_cast<int>(by_head_dim<__nv_bfloat16>(D, args));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). q [BH, T, D],
// k/v [BKh, S, D]; o [BH, T, D] and lse [BH, T] fp32. tile: the tensor-core
// kernel's tile edge (32 or 64 keys); any other returns cudaErrorInvalidValue.
int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, float* o, float* lse,
                     int BH, int BKh, int T, int S, int D, int causal, float scale, int tile,
                     void* stream) {
  const Shape sh{BH, BKh, T, S, causal, scale, static_cast<cudaStream_t>(stream), tile};
  return dispatch(dtype, D, FwdArgs{q, k, v, o, lse, sh});
}

// do [BH, T, D], lse and delta [BH, T], all fp32; dq [BH, T, D] fp32. tile:
// keys of the K/V tile, 16, 32 or 64.
int flash_bwd_dq_launch(int dtype, const void* q, const void* k, const void* v,
                        const float* dout, const float* lse, const float* delta, float* dq,
                        int BH, int BKh, int T, int S, int D, int causal, float scale,
                        int tile, void* stream) {
  const Shape sh{BH, BKh, T, S, causal, scale, static_cast<cudaStream_t>(stream), tile};
  return dispatch(dtype, D, DqArgs{q, k, v, dout, lse, delta, dq, sh});
}

// As dq; dk, dv [BKh, S, D] fp32. tile: q rows a step, 16, 32 or 64.
int flash_bwd_dkv_launch(int dtype, const void* q, const void* k, const void* v,
                         const float* dout, const float* lse, const float* delta, float* dk,
                         float* dv, int BH, int BKh, int T, int S, int D, int causal,
                         float scale, int tile, void* stream) {
  const Shape sh{BH, BKh, T, S, causal, scale, static_cast<cudaStream_t>(stream), tile};
  return dispatch(dtype, D, DkvArgs{q, k, v, dout, lse, delta, dk, dv, sh});
}

// The instantiation that a launch of kernel 0 (fwd), 1 (dq) or 2 (dk/dv)
// runs for this dtype code and head dim; null where none does.
const char* flash_instantiation(int kernel, int dtype, int D) {
  const char* out = nullptr;
  if (kernel < 0 || kernel > 2) return out;
  const DescribeArgs args{kernel, &out};
  if (dtype == 0) (void)by_head_dim<float>(D, args);
  if (dtype == 1) (void)by_head_dim<__nv_bfloat16>(D, args);
  return out;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
