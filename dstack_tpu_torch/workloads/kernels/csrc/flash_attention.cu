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
// gradients are then zero. All products and sums are fp32; do is fp32.
//
// Design. A block is 256 threads, a 16 x 16 grid (ty, tx), over a TILE x TILE
// tile of scores (TILE = 64, or 32 where 64 does not fit shared memory: fp32
// with D > 192). Thread (ty, tx) owns rows ty*R .. ty*R+R-1 (R = TILE/16) and
// columns tx, tx+16, ..: the 16 threads of a row are one half of a warp, so a
// row's max and sum are 4 shuffles. Tiles sit in shared memory row-major with
// a padded row (an odd number of 32-bit words), so the 16 rows a half-warp
// reads at one column fall in 16 different banks.
//   - fwd: one block per (q tile, BH row). The q tile stays in shared memory;
//     each K/V tile read from device memory serves all TILE query rows. The
//     block walks the KV tiles its last row can see (causal bound `hi`), runs
//     the online softmax per tile, stages p in shared memory and adds p @ V
//     into registers (R x D/16 fp32 a thread).
//   - dq: the same grid and walk; p = exp(s - lse), ds = p (dp - delta) scale,
//     staged in shared memory, dq += ds @ K in registers.
//   - dk/dv: one block per (KV tile, BKh row); it owns its dk and dv tile in
//     registers and walks the n_rep query heads and, per head, the q tiles
//     from the first one a causal mask leaves live. Blocks own disjoint
//     outputs, so there are no atomics and the result is deterministic.
// Blocks with the most causal work start first (the last q tile for fwd/dq,
// the first KV tile for dk/dv). Rows and keys past T or S are masked, so a
// ragged last tile is right.
//
// Bound at the train shapes (llama3_1b: B 2, H 16, Kh 8, D 128, T = S = 8192,
// bf16, causal): the forward does 4*B*H*D*T*T/2 = 5.5e11 flop (0.56 ms at
// 989 TFLOP/s) and moves q, k, v in bf16 and o, lse in fp32 once, 0.27 GB
// (0.08 ms at 3.35 TB/s): bound by operations, as are dq (1.5x the forward's
// flop) and dk/dv (2x). This design does its products on CUDA cores in fp32
// (67 TFLOP/s peak), so it cannot come near that bound.
//
// Left for later: tensor-core products (mma.sync, then wgmma with a
// warpgroup per 64 rows) for bf16 inputs; TMA loads into a ring of tiles with
// mbarriers, overlapping the next K/V tile's load with this tile's math
// (today a block loads, syncs, computes); splitting a long causal row's KV
// walk across blocks to even out the work of the q tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;  // 16 x 16
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Elements p[0], p[1] as floats (p at an even element of a padded row).
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Reductions over the 16 lanes (one half-warp) that share a row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// Row padding in elements that makes a row an odd number of 32-bit words.
template <typename T>
struct Pad {
  static constexpr int value = 1;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 2;
};

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

// Copy rows [row0, row0 + TILE) of a row-major [n_rows, D] matrix into a
// shared tile of rows of LD elements, 32-bit words at a time; rows past
// n_rows are zero.
template <typename T, int D, int LD, int TILE>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int WPR = D * static_cast<int>(sizeof(T)) / 4;
  constexpr int LDW = LD * static_cast<int>(sizeof(T)) / 4;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int i = threadIdx.x; i < TILE * WPR; i += THREADS) {
    const int r = i / WPR;
    const int c = i % WPR;
    const int g = row0 + r;
    d[r * LDW + c] = g < n_rows ? s[static_cast<size_t>(g) * WPR + c] : 0u;
  }
}

// acc[i][j] = sum_d A[ty*R + i][d] * B[tx + 16 j][d] over shared tiles.
template <int R, int D, typename TA, typename TB>
__device__ __forceinline__ void dot_rows(float (&acc)[R][R], const TA* A, int lda, const TB* B,
                                         int ldb, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = load2(A + (ty * R + i) * lda + d);
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = load2(B + (tx + 16 * j) * ldb + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      }
  }
}

// out[i][jj] += sum_c P[ty*R + i][c] * V[c][tx + 16 jj]: P a float score
// tile, V a shared tile whose rows past the valid ones are zero.
template <int R, int NJ, int TILE, typename TV>
__device__ __forceinline__ void add_pv(float (&out)[R][NJ], const float* P, int ldp,
                                       const TV* V, int ldv, int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < TILE; ++c) {
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = P[(ty * R + i) * ldp + c];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float v = to_float(V[c * ldv + tx + 16 * jj]);
#pragma unroll
      for (int i = 0; i < R; ++i) out[i][jj] = fmaf(p[i], v, out[i][jj]);
    }
  }
}

// Last KV tile (exclusive) that rows [q0, q0 + TILE) of a causal walk see.
__device__ __forceinline__ int causal_hi(int q0, int tile, int T_len, int n_kv) {
  return min(n_kv, (min(T_len, q0 + tile) - 1) / tile + 1);
}

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
  const int n_kv = (S_len + TILE - 1) / TILE;
  const int hi = causal ? causal_hi(q0, TILE, T_len, n_kv) : n_kv;

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
  const int n_kv = (S_len + TILE - 1) / TILE;
  const int hi = causal ? causal_hi(q0, TILE, T_len, n_kv) : n_kv;

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

  for (int rep = 0; rep < n_rep; ++rep) {
    const size_t row_base = (static_cast<size_t>(bkh) * n_rep + rep) * T_len;
    for (int iq = iq_lo; iq < n_q; ++iq) {
      const int q0 = iq * TILE;
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
      add_pv<R, NJ, TILE>(dv_acc, p_s, LDS, do_s, LDF, ty, tx);
      add_pv<R, NJ, TILE>(dk_acc, ds_s, LDS, q_s, LD, ty, tx);
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

struct Shape {
  int bh, bkh, t_len, s_len, causal;
  float scale;
  cudaStream_t stream;
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
};

struct DqArgs {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  float* dq;
  Shape sh;

  template <typename T, int D>
  cudaError_t launch() const {
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
};

struct DkvArgs {
  const void *q, *k, *v;
  const float *dout, *lse, *delta;
  float *dk, *dv;
  Shape sh;

  template <typename T, int D>
  cudaError_t launch() const {
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
// k/v [BKh, S, D]; o [BH, T, D] and lse [BH, T] fp32.
int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, float* o, float* lse,
                     int BH, int BKh, int T, int S, int D, int causal, float scale,
                     void* stream) {
  const Shape sh{BH, BKh, T, S, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, FwdArgs{q, k, v, o, lse, sh});
}

// do [BH, T, D], lse and delta [BH, T], all fp32; dq [BH, T, D] fp32.
int flash_bwd_dq_launch(int dtype, const void* q, const void* k, const void* v,
                        const float* dout, const float* lse, const float* delta, float* dq,
                        int BH, int BKh, int T, int S, int D, int causal, float scale,
                        void* stream) {
  const Shape sh{BH, BKh, T, S, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, DqArgs{q, k, v, dout, lse, delta, dq, sh});
}

// As dq; dk, dv [BKh, S, D] fp32.
int flash_bwd_dkv_launch(int dtype, const void* q, const void* k, const void* v,
                         const float* dout, const float* lse, const float* delta, float* dk,
                         float* dv, int BH, int BKh, int T, int S, int D, int causal,
                         float scale, void* stream) {
  const Shape sh{BH, BKh, T, S, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, DkvArgs{q, k, v, dout, lse, delta, dk, dv, sh});
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
