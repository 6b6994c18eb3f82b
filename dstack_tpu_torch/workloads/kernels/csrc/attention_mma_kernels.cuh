// The tensor-core forward, dq and dk/dv bodies of the training attention
// kernels for Hopper (sm_90a), shared by flash and splash and templated on a
// compile-time mask policy:
//   - flash_attention.cu's flash_fwd_mma_kernel, flash_bwd_dq_mma_kernel and
//     flash_bwd_dkv_mma_kernel (the Pallas `_fwd_kernel`, `_bwd_dq_kernel`
//     and `_bwd_dkv_kernel`, dstack_tpu/workloads/kernels/flash.py) run them
//     under CausalMask;
//   - splash_attention.cu's splash_fwd_mma_kernel, splash_bwd_dq_mma_kernel
//     and splash_bwd_dkv_mma_kernel (the Pallas `_splash_fwd_kernel`,
//     `_splash_bwd_dq_kernel` and `_splash_bwd_dkv_kernel`,
//     dstack_tpu/workloads/kernels/splash.py) run them under BandMask:
//     causal, a local window and document ids.
// Those sources state each kernel's bound on this card; attention_mma.cuh has
// the warp-level pieces and the numerics (mma.sync m16n8k16 bf16 -> fp32,
// fp32 operands split into three bf16 terms, long sums out of the tensor
// cores through zeroed tiles).
//
// A mask policy gives, at the kernel's own row and key tile edges:
//   - kv_lo/kv_hi: the KV tiles [lo, hi) a q tile walks (the forward, dq);
//   - q_lo/q_hi: the q tiles [lo, hi) that see some key of a KV tile (dk/dv);
//   - edge: whether a (q tile, KV tile) pair needs element compares; every
//     other tile of the walk is wholly live, so the interior path carries no
//     compare and no register for the mask;
//   - sees: whether query qp sees key kp (doc ids dq, dk, read only when the
//     policy has DOCS).
// CausalMask folds to the bounds the flash kernels had before the bodies
// were shared, so flash keeps its results.
//
// The tile sizes below are the default menu pair's (kernels/flash.py
// TILE_MENU); the forward's and dq's K/V tile and dk/dv's q step are
// template arguments of the bodies.
//
// Forward: a block of 4 warps owns 64 q rows, 16 a warp. K/V tiles of 64
// keys stream through a 2-stage cp.async ring (with the tile's doc ids under
// DOCS), so the next tile's load overlaps this tile's math; the q fragments
// are read from shared memory per tile (ldmatrix). S = Q K^T, the online
// softmax (a row's max and sum over the 4 lanes of a quad) and P stay in
// registers; P goes from its C fragments to A fragments in 3 bf16 terms, and
// O += P_i V for each term with V through ldmatrix.trans, the 64 keys of a
// tile summed in a zeroed tile per 16 output columns. mma work a live (query,
// key) pair: 1 (QK) + 3 (PV) = 4 units of D multiply-adds.
//
// dq: the forward's walk. A block of 4 warps owns 64 q rows, 16 a warp, the
// last q tile first; Q loads once (bf16) and fp32 do loads once and is split
// once into three bf16 planes in shared memory, planes that are zero over
// the block skipped (exactly: they add nothing); lse, delta (and under DOCS
// the rows' doc ids) stay in registers; K/V tiles of 32 keys (with their doc
// ids under DOCS) stream through the 2-stage cp.async ring (64-key tiles
// would take 136 KB of shared memory at D 128 and leave one block an SM).
// Per tile and warp: S = Q K^T (in place over D / 16); P = exp(S scale -
// lse); dP = dO V^T over the planes, V read as K is, one 16-dim step of the
// planes in a zeroed tile; dS = P (dP - delta) scale in registers; dQ += dS
// K with dS in 3 terms (c_to_a_split) and K through ldmatrix.trans, the
// tile's 32 keys summed in a zeroed tile per 16 dq columns. The Q and do
// fragments are read from shared memory per k-step. mma work a live pair: 1
// + 3 + 3 = 7 units of D multiply-adds; 5 when do holds bf16 values (as in
// training).
//
// dk/dv: one block per (64-key KV tile, BKh row), 4 warps of 16 keys, owns
// its dk and dv in registers (no atomics, deterministic). K and V stay
// resident in shared memory; the block walks 32-row q tiles from the farthest
// one (q_hi - 1) to the nearest (q_lo), the n_rep heads interleaved (p, and
// so each tile's share of dk and dv, grows toward the diagonal: the small
// shares meet the fp32 sums first), bringing Q, fp32 do, lse, delta (and the
// q tile's doc ids under DOCS) of the next tile in by cp.async
// (double-buffered) while this one computes. do is split once per tile into
// three bf16 planes in shared memory. From registers, 16 queries at a time:
// S^T = K Q^T; P^T = exp(S^T scale - lse); dP^T = V dO^T over the planes;
// dS^T = P^T (dP^T - delta) scale; dV += P^T dO with P^T in 3 terms and the
// 6 products of terms i + j < 3; dK += dS^T Q with dS^T in 3 terms. mma work
// a pair: 1 + 3 + 6 + 3 = 13 units; planes that are zero over a whole tile
// are skipped (exactly: they add nothing), so a do of bf16 values, as in
// training, costs 1 + 1 + 3 + 3 = 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace attn_mma {

constexpr float NEG_INF = -1e30f;
constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int FWD_ROWS = 64;      // q rows of a forward block, 16 a warp
constexpr int FWD_STAGES = 2;     // K/V ring depth
constexpr int DKV_KEYS = 64;      // keys of a dk/dv block, 16 a warp
constexpr int DQ_ROWS = 64;       // q rows of a dq block, 16 a warp
constexpr int DQ_STAGES = 2;      // dq's K/V ring depth
constexpr int DO_TERMS = 3;       // bf16 planes of do (split_to_planes) and terms of p, ds

// -- tiles ----------------------------------------------------------------------

// Each body takes one tile edge as a template argument: the forward's
// streamed K/V tile (FWD_ROWS rows over KEYS keys), dq's (DQ_ROWS rows over
// KEYS keys) and dk/dv's q step (ROWS rows a step over a block of DKV_KEYS
// keys). Forward and dq blocks own 64 q rows and dk/dv blocks 64 keys at
// every tile (4 warps of 16). Each launch function takes its kernel's edge
// as an int and instantiates the tensor-core kernel at the edges by_tile
// lists; kernels/flash.py's TILE_MENU names the edges of each (block_q,
// block_kv) pair. The CUDA-core kernels ignore the edge.

// f(std::integral_constant<int, n>{}) for the runtime tile n, one of the
// tiles Ns that a kernel is built at; cudaErrorInvalidValue for any other.
template <int... Ns, typename F>
cudaError_t by_tile(int n, const F& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((n == Ns ? (err = f(std::integral_constant<int, Ns>{}), true) : false) || ...);
  return err;
}

// -- mask policies ---------------------------------------------------------------

// Causal (key <= query) or full attention: flash.
struct CausalMask {
  static constexpr bool DOCS = false;
  int t_len, s_len, causal;

  template <int ROWS, int KEYS>
  __device__ __forceinline__ int kv_lo(int) const {
    return 0;
  }
  // The tile after the one that holds the key of the q tile's last row.
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int kv_hi(int q0) const {
    const int n_kv = (s_len + KEYS - 1) / KEYS;
    return causal ? min(n_kv, (min(t_len, q0 + ROWS) - 1) / KEYS + 1) : n_kv;
  }
  // q tiles that end before the KV tile starts see none of it.
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int q_lo(int k0) const {
    return causal ? min(k0 / ROWS, (t_len + ROWS - 1) / ROWS) : 0;
  }
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int q_hi(int) const {
    return (t_len + ROWS - 1) / ROWS;
  }
  // The tile crosses the causal diagonal or the ragged key end.
  template <int ROWS, int KEYS>
  __device__ __forceinline__ bool edge(int q0, int k0) const {
    return (causal && k0 + KEYS - 1 > q0) || k0 + KEYS > s_len;
  }
  __device__ __forceinline__ bool sees(int qp, int kp, int, int) const {
    return kp < s_len && (!causal || kp <= qp);
  }
};

// Causal AND a local window (key > query - window; 0 = none) AND, with
// DOCS, the same document (docq[b, query] == dock[b, key]; q row bh is batch
// bh / heads, KV row g batch g / kv_heads): splash. Its CUDA-core kernels
// take BandMask<false> for the band at their one tile edge and compare
// documents themselves.
template <bool HAS_DOCS>
struct BandMask {
  static constexpr bool DOCS = HAS_DOCS;
  int t_len, s_len, causal, window;
  const int* docq;  // [B, T], DOCS only
  const int* dock;  // [B, S], DOCS only
  int heads, kv_heads;

  // The tile that holds the first key of the q tile's first row, clamped
  // before dividing (C division truncates toward zero).
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int kv_lo(int q0) const {
    return window ? max(0, q0 - (window - 1)) / KEYS : 0;
  }
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int kv_hi(int q0) const {
    const int n_kv = (s_len + KEYS - 1) / KEYS;
    return causal ? min(n_kv, (min(t_len, q0 + ROWS) - 1) / KEYS + 1) : n_kv;
  }
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int q_lo(int k0) const {
    return causal ? min(k0 / ROWS, (t_len + ROWS - 1) / ROWS) : 0;
  }
  // The tile after the one that holds the last row whose window reaches the
  // KV tile's last key.
  template <int ROWS, int KEYS>
  __device__ __forceinline__ int q_hi(int k0) const {
    const int n_q = (t_len + ROWS - 1) / ROWS;
    const int last_key = min(s_len, k0 + KEYS) - 1;
    return window ? min(n_q, (last_key + window - 1) / ROWS + 1) : n_q;
  }
  // The tile crosses the causal diagonal, the window's edge (some key <=
  // some row - window) or the ragged key end; with documents every tile
  // compares (doc ids are element masks, as on the TPU).
  template <int ROWS, int KEYS>
  __device__ __forceinline__ bool edge(int q0, int k0) const {
    return DOCS || (causal && k0 + KEYS - 1 > q0) ||
           (window && k0 + window <= q0 + ROWS - 1) || k0 + KEYS > s_len;
  }
  __device__ __forceinline__ bool sees(int qp, int kp, int dq, int dk) const {
    return kp < s_len && (!causal || kp <= qp) && (window == 0 || kp > qp - window) &&
           (!DOCS || dq == dk);
  }
};

// -- shared memory ---------------------------------------------------------------

// Q; the K/V ring; with documents, the ring's doc ids.
template <int D, int FWD_KEYS, typename Mask>
constexpr size_t fwd_mma_smem_bytes() {
  return static_cast<size_t>(FWD_ROWS + 2 * FWD_STAGES * FWD_KEYS) * padded(D) *
             sizeof(__nv_bfloat16) +
         (Mask::DOCS ? static_cast<size_t>(FWD_STAGES) * FWD_KEYS * 4 : 0);
}

// K, V; Q x 2 buffers; the do planes; the fp32 do staging tile; lse and
// delta x 2 buffers; with documents, the q tile's doc ids x 2 buffers.
template <int D, int DKV_ROWS, typename Mask>
constexpr size_t dkv_mma_smem_bytes() {
  return static_cast<size_t>(2 * DKV_KEYS + 2 * DKV_ROWS + DO_TERMS * DKV_ROWS) * padded(D) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(DKV_ROWS) * D * 4 + 4u * DKV_ROWS * 4 +
         (Mask::DOCS ? 2u * DKV_ROWS * 4 : 0);
}

// Q, the do planes, the K/V ring; with documents, the ring's doc ids.
template <int D, int DQ_KEYS, typename Mask>
constexpr size_t dq_mma_smem_bytes() {
  return static_cast<size_t>((1 + DO_TERMS) * DQ_ROWS + 2 * DQ_STAGES * DQ_KEYS) * padded(D) *
             sizeof(__nv_bfloat16) +
         (Mask::DOCS ? static_cast<size_t>(DQ_STAGES) * DQ_KEYS * 4 : 0);
}

// -- the forward -----------------------------------------------------------------

// o [BH, T, D] and lse [BH, T] (fp32) of q [BH, T, D] and k, v [BKh, S, D]
// (bf16) under `mask`; one block per (q tile, BH row), the last q tile first.
// Launched with MMA_THREADS threads and fwd_mma_smem_bytes<D, FWD_KEYS, Mask>()
// bytes.
template <int D, int FWD_KEYS, typename Mask>
__device__ __forceinline__ void fwd_mma_body(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             float* __restrict__ o, float* __restrict__ lse,
                                             int n_rep, float scale, const Mask& mask) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = padded(D);
  constexpr int KD = D / 16;          // k-steps of Q K^T
  constexpr int NK = FWD_KEYS / 8;    // score n-tiles
  constexpr int ND = D / 8;           // output n-tiles
  static_assert(FWD_KEYS % 16 == 0 && FWD_KEYS <= MMA_THREADS, "whole 16-key steps, one doc id a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + FWD_ROWS * LD;              // [FWD_STAGES][FWD_KEYS][LD]
  bf16* v_s = k_s + FWD_STAGES * FWD_KEYS * LD;
  int* kd_s = reinterpret_cast<int*>(v_s + FWD_STAGES * FWD_KEYS * LD);  // [FWD_STAGES][FWD_KEYS]

  const int T_len = mask.t_len, S_len = mask.s_len;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const LaneOffsets lo(lane);
  const int n_q = (T_len + FWD_ROWS - 1) / FWD_ROWS;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * FWD_ROWS;
  const int bh = blockIdx.y;
  const bf16* kb = k + static_cast<size_t>(bh / n_rep) * S_len * D;
  const bf16* vb = v + static_cast<size_t>(bh / n_rep) * S_len * D;
  const int jk_lo = mask.template kv_lo<FWD_ROWS, FWD_KEYS>(q0);
  const int jk_hi = mask.template kv_hi<FWD_ROWS, FWD_KEYS>(q0);
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  // Documents: this lane's rows keep their ids in registers; each KV tile's
  // ride the ring beside K and V.
  const int* kdoc = nullptr;
  int rdoc[2] = {0, 0};
  if constexpr (Mask::DOCS) {
    const int batch = bh / mask.heads;
    kdoc = mask.dock + static_cast<size_t>(batch) * S_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      rdoc[r] = qp < T_len ? mask.docq[static_cast<size_t>(batch) * T_len + qp] : 0;
    }
  }
  auto fetch = [&](int jk) {
    const int st = jk % FWD_STAGES;
    cp_async_tile<bf16, FWD_KEYS, D, LD, MMA_THREADS>(k_s + st * FWD_KEYS * LD, kb,
                                                      jk * FWD_KEYS, S_len);
    cp_async_tile<bf16, FWD_KEYS, D, LD, MMA_THREADS>(v_s + st * FWD_KEYS * LD, vb,
                                                      jk * FWD_KEYS, S_len);
    if constexpr (Mask::DOCS) {
      const int c = threadIdx.x, kp = jk * FWD_KEYS + c;
      const bool in = kp < S_len;
      if (c < FWD_KEYS) cp_async4(kd_s + st * FWD_KEYS + c, kdoc + (in ? kp : 0), in);
    }
  };

  cp_async_tile<bf16, FWD_ROWS, D, LD, MMA_THREADS>(q_s, q + static_cast<size_t>(bh) * T_len * D,
                                                    q0, T_len);
  if (jk_lo < jk_hi) fetch(jk_lo);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int jk = jk_lo; jk < jk_hi; ++jk) {
    cp_async_wait<0>();
    __syncthreads();  // tile jk has landed; every warp is done with tile jk - 1
    // The q fragments, read again per tile: held in registers for the whole
    // walk they added to the register pressure that spills at D 128, and
    // the kernel ran slower.
    uint32_t qf[KD][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldmatrix_x4(qf[kd], q_s + (warp * 16 + lo.row_a) * LD + kd * 16 + lo.col_a);
    if (jk + 1 < jk_hi) {
      fetch(jk + 1);
      cp_async_commit();
    }
    const int st = jk % FWD_STAGES;
    const bf16* ks = k_s + st * FWD_KEYS * LD;
    const bf16* vs = v_s + st * FWD_KEYS * LD;

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (np * 16 + lo.row_b) * LD + kd * 16 + lo.col_b);
        mma_pair(s[2 * np], s[2 * np + 1], qf[kd], b);
      }

    // Scale, mask (only an edge tile of the mask), and the online softmax of
    // rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3).
    const int k0 = jk * FWD_KEYS;
    const bool edge = mask.template edge<FWD_ROWS, FWD_KEYS>(q0, k0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int c = j * 8 + 2 * tq + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          int dk = 0;
          if constexpr (Mask::DOCS) dk = kd_s[st * FWD_KEYS + c];
          x = mask.sees(qp, k0 + c, rdoc[e >> 1], dk) ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float safe_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      safe_m[r] = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m[r] == NEG_INF ? 0.f : expf(m[r] - safe_m[r]);
      m[r] = m_new;
      l[r] *= corr;  // a lane's partial row sum; the quad's are added at the end
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
    // Masked scores are NEG_INF, so their exp is exactly 0.
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - safe_m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O += P V. P goes from its C fragments to A fragments in DO_TERMS bf16
    // terms; per 16 output columns the 64 keys' terms meet in a zeroed tile
    // that one rounded add puts into acc (add_tile).
    uint32_t pa[NK / 2][DO_TERMS][4];
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) c_to_a_split<DO_TERMS>(s[2 * kk], s[2 * kk + 1], pa[kk]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + lo.row_a) * LD + dn * 16 + lo.col_a);
#pragma unroll
        for (int i = DO_TERMS - 1; i >= 0; --i) mma_pair(t0, t1, pa[kk][i], b);
      }
      add_tile(acc[2 * dn], t0);
      add_tile(acc[2 * dn + 1], t1);
    }
  }

  // A row that saw no key keeps m = NEG_INF and l = 0: o = 0, lse = -1e30.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-20f);
    const int qp = row0 + 8 * r;
    if (qp >= T_len) continue;
    float* orow = o + (static_cast<size_t>(bh) * T_len + qp) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    if (tq == 0)
      lse[static_cast<size_t>(bh) * T_len + qp] = (m[r] == NEG_INF ? NEG_INF : m[r]) + logf(l_safe);
  }
}

// -- dq ------------------------------------------------------------------------

// dq [BH, T, D] (fp32) from q [BH, T, D], k, v [BKh, S, D] (bf16), do [BH, T,
// D], lse and delta [BH, T] (fp32) under `mask`; one block per (q tile, BH
// row), the last q tile first. Launched with MMA_THREADS threads and
// dq_mma_smem_bytes<D, DQ_KEYS, Mask>() bytes.
template <int D, int DQ_KEYS, typename Mask>
__device__ __forceinline__ void dq_mma_body(const __nv_bfloat16* __restrict__ q,
                                            const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v,
                                            const float* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            float* __restrict__ dq, int n_rep, float scale,
                                            const Mask& mask) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = padded(D);
  constexpr int KD = D / 16;        // k-steps over D
  constexpr int NK = DQ_KEYS / 8;   // score n-tiles
  constexpr int ND = D / 8;         // dq n-tiles
  constexpr int PLANE = DQ_ROWS * LD;
  static_assert(DQ_ROWS * D % (4 * MMA_THREADS) == 0, "do splits in whole float4 steps");
  static_assert(DQ_KEYS % 16 == 0 && DQ_KEYS <= MMA_THREADS, "whole 16-key steps, one doc id a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [DQ_ROWS][LD]
  bf16* pl_s = q_s + PLANE;                       // [DO_TERMS][DQ_ROWS][LD]
  bf16* k_s = pl_s + DO_TERMS * PLANE;            // [DQ_STAGES][DQ_KEYS][LD]
  bf16* v_s = k_s + DQ_STAGES * DQ_KEYS * LD;
  int* kd_s = reinterpret_cast<int*>(v_s + DQ_STAGES * DQ_KEYS * LD);  // [DQ_STAGES][DQ_KEYS]

  const int T_len = mask.t_len, S_len = mask.s_len;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const LaneOffsets lo(lane);
  const int n_q = (T_len + DQ_ROWS - 1) / DQ_ROWS;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * DQ_ROWS;
  const int bh = blockIdx.y;
  const size_t row_base = static_cast<size_t>(bh) * T_len;
  const bf16* kb = k + static_cast<size_t>(bh / n_rep) * S_len * D;
  const bf16* vb = v + static_cast<size_t>(bh / n_rep) * S_len * D;
  const int jk_lo = mask.template kv_lo<DQ_ROWS, DQ_KEYS>(q0);
  const int jk_hi = mask.template kv_hi<DQ_ROWS, DQ_KEYS>(q0);
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  // Documents: this lane's rows keep their ids in registers; each KV tile's
  // ride the ring beside K and V.
  const int* kdoc = nullptr;
  int rdoc[2] = {0, 0};
  if constexpr (Mask::DOCS) {
    const int batch = bh / mask.heads;
    kdoc = mask.dock + static_cast<size_t>(batch) * S_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      rdoc[r] = qp < T_len ? mask.docq[static_cast<size_t>(batch) * T_len + qp] : 0;
    }
  }
  auto fetch = [&](int jk) {
    const int st = jk % DQ_STAGES;
    cp_async_tile<bf16, DQ_KEYS, D, LD, MMA_THREADS>(k_s + st * DQ_KEYS * LD, kb, jk * DQ_KEYS,
                                                     S_len);
    cp_async_tile<bf16, DQ_KEYS, D, LD, MMA_THREADS>(v_s + st * DQ_KEYS * LD, vb, jk * DQ_KEYS,
                                                     S_len);
    if constexpr (Mask::DOCS) {
      const int c = threadIdx.x, kp = jk * DQ_KEYS + c;
      const bool in = kp < S_len;
      if (c < DQ_KEYS) cp_async4(kd_s + st * DQ_KEYS + c, kdoc + (in ? kp : 0), in);
    }
  };

  cp_async_tile<bf16, DQ_ROWS, D, LD, MMA_THREADS>(q_s, q + row_base * D, q0, T_len);
  if (jk_lo < jk_hi) fetch(jk_lo);
  cp_async_commit();

  // While those land: split the fp32 do tile into DO_TERMS bf16 planes
  // (rows past T zero) and note which low planes hold anything.
  bool nz[2] = {false, false};
#pragma unroll 4
  for (int it = 0; it < DQ_ROWS * D / (4 * MMA_THREADS); ++it) {
    const int i = (it * MMA_THREADS + static_cast<int>(threadIdx.x)) * 4;
    const int r = i / D, c = i % D;
    const float4 x = q0 + r < T_len
                         ? *reinterpret_cast<const float4*>(dout + (row_base + q0 + r) * D + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    split_to_planes(x, pl_s, PLANE, r * LD + c, nz);
  }
  const int n_do = live_planes(nz);

  // lse (NEG_INF past T: such a row's p is 0) and delta of this lane's rows.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    lse_r[r] = qp < T_len ? lse[row_base + qp] : NEG_INF;
    delta_r[r] = qp < T_len ? delta[row_base + qp] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jk = jk_lo; jk < jk_hi; ++jk) {
    cp_async_wait<0>();
    __syncthreads();  // tile jk has landed; every warp is done with tile jk - 1
    if (jk + 1 < jk_hi) {
      fetch(jk + 1);
      cp_async_commit();
    }
    const int st = jk % DQ_STAGES;
    const bf16* ks = k_s + st * DQ_KEYS * LD;
    const bf16* vs = v_s + st * DQ_KEYS * LD;

    // S = Q K^T, its D / 16 mma in place; the q fragments are read from
    // shared memory per k-step (held for the walk they would spill).
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + lo.row_a) * LD + kd * 16 + lo.col_a);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (np * 16 + lo.row_b) * LD + kd * 16 + lo.col_b);
        mma_pair(s[2 * np], s[2 * np + 1], a, b);
      }
    }
    // P = exp(S scale - lse), zero on masked keys (only an edge tile of the
    // mask pays for the compares) and on rows whose lse is NEG_INF.
    const int k0 = jk * DQ_KEYS;
    const bool edge = mask.template edge<DQ_ROWS, DQ_KEYS>(q0, k0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = lse_r[e >> 1];
        float p = lq == NEG_INF ? 0.f : expf(s[j][e] * scale - lq);
        if (edge) {
          const int c = j * 8 + 2 * tq + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          int dk = 0;
          if constexpr (Mask::DOCS) dk = kd_s[st * DQ_KEYS + c];
          p = mask.sees(qp, k0 + c, rdoc[e >> 1], dk) ? p : 0.f;
        }
        s[j][e] = p;
      }

    // dP = dO V^T over the planes that hold anything, V read as K is; one
    // 16-dim step of the planes in a zeroed tile, added into dp.
    float dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[DO_TERMS][4];
#pragma unroll
      for (int p = 0; p < DO_TERMS; ++p)
        if (p < n_do)
          ldmatrix_x4(a[p], pl_s + p * PLANE + (warp * 16 + lo.row_a) * LD + kd * 16 + lo.col_a);
      float t[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, vs + (np * 16 + lo.row_b) * LD + kd * 16 + lo.col_b);
#pragma unroll
        for (int p = DO_TERMS - 1; p >= 0; --p)
          if (p < n_do) mma_pair(t[2 * np], t[2 * np + 1], a[p], b);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) add_tile(dp[j], t[j]);
    }
    // dS = P (dP - delta) scale, in place of dP.
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - delta_r[e >> 1]) * scale;

    // dQ += dS K: dS from its C fragments to A fragments in DO_TERMS terms,
    // K through ldmatrix.trans (as the forward reads V); per 16 dq columns
    // the tile's keys meet in a zeroed tile that add_tile puts into acc.
    uint32_t sa[NK / 2][DO_TERMS][4];
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) c_to_a_split<DO_TERMS>(dp[2 * kk], dp[2 * kk + 1], sa[kk]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ks + (kk * 16 + lo.row_a) * LD + dn * 16 + lo.col_a);
#pragma unroll
        for (int i = DO_TERMS - 1; i >= 0; --i) mma_pair(t0, t1, sa[kk][i], b);
      }
      add_tile(acc[2 * dn], t0);
      add_tile(acc[2 * dn + 1], t1);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= T_len) continue;
    float* row = dq + (row_base + qp) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + 2 * tq) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// -- dk/dv ---------------------------------------------------------------------

// dk, dv [BKh, S, D] (fp32) from q [BH, T, D], k, v [BKh, S, D] (bf16), do
// [BH, T, D], lse and delta [BH, T] (fp32) under `mask`; one block per (KV
// tile, BKh row). Launched with MMA_THREADS threads and
// dkv_mma_smem_bytes<D, DKV_ROWS, Mask>() bytes.
template <int D, int DKV_ROWS, typename Mask>
__device__ __forceinline__ void dkv_mma_body(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ dk, float* __restrict__ dv,
                                             int n_rep, float scale, const Mask& mask) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = padded(D);
  constexpr int KD = D / 16;          // k-steps over D
  constexpr int ND = D / 8;           // dk/dv n-tiles
  constexpr int PLANE = DKV_ROWS * LD;
  static_assert(DKV_ROWS % 16 == 0 && DKV_ROWS * D % (4 * MMA_THREADS) == 0,
                "whole 16-query steps; do splits in whole float4 steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + DKV_KEYS * LD;
  bf16* q_s = v_s + DKV_KEYS * LD;           // [2][DKV_ROWS][LD]
  bf16* pl_s = q_s + 2 * PLANE;              // [DO_TERMS][DKV_ROWS][LD]
  float* do_s = reinterpret_cast<float*>(pl_s + DO_TERMS * PLANE);  // [DKV_ROWS][D]
  float* lse_s = do_s + DKV_ROWS * D;        // [2][DKV_ROWS]
  float* delta_s = lse_s + 2 * DKV_ROWS;     // [2][DKV_ROWS]
  int* qd_s = reinterpret_cast<int*>(delta_s + 2 * DKV_ROWS);  // [2][DKV_ROWS], DOCS only

  const int T_len = mask.t_len, S_len = mask.s_len;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const LaneOffsets lo(lane);
  const int k0 = blockIdx.x * DKV_KEYS;
  const int bkh = blockIdx.y;
  const int iq_lo = mask.template q_lo<DKV_ROWS, DKV_KEYS>(k0);
  const int iq_hi = mask.template q_hi<DKV_ROWS, DKV_KEYS>(k0);
  const int n_steps = n_rep * (iq_hi - iq_lo);
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8

  // Documents: this lane's keys keep their ids in registers; each q tile's
  // ride the fetch beside lse and delta. Every q row of this KV row (bkh *
  // n_rep + rep) lies in its batch.
  const int* qdoc = nullptr;
  int kdoc[2] = {0, 0};
  if constexpr (Mask::DOCS) {
    const int batch = bkh / mask.kv_heads;
    qdoc = mask.docq + static_cast<size_t>(batch) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = key0 + 8 * r;
      kdoc[r] = kp < S_len ? mask.dock[static_cast<size_t>(batch) * S_len + kp] : 0;
    }
  }

  // Step j: q tile iq_hi - 1 - j / n_rep of head j % n_rep of the KV row. The
  // walk runs from the farthest q tile to the nearest, the heads
  // interleaved: p (and so each step's share of dk and dv) grows toward the
  // diagonal, and adding the small shares first, while the fp32 sums are
  // still small, rounds them less.
  auto step_q0 = [&](int j) { return (iq_hi - 1 - j / n_rep) * DKV_ROWS; };
  auto fetch = [&](int j, int buf) {
    const size_t row_base = (static_cast<size_t>(bkh) * n_rep + j % n_rep) * T_len;
    const int q0 = step_q0(j);
    cp_async_tile<bf16, DKV_ROWS, D, LD, MMA_THREADS>(q_s + buf * PLANE, q + row_base * D, q0,
                                                      T_len);
    cp_async_tile<float, DKV_ROWS, D, D, MMA_THREADS>(do_s, dout + row_base * D, q0, T_len);
    // lse, delta and (under DOCS) the doc ids of the tile's rows; a step of
    // 64 rows has more of them than the block has threads.
    constexpr int N_ROW_LOADS = (Mask::DOCS ? 3 : 2) * DKV_ROWS;
    for (int i = threadIdx.x; i < N_ROW_LOADS; i += MMA_THREADS) {
      const int which = i / DKV_ROWS, r = i % DKV_ROWS;
      const bool in = q0 + r < T_len;
      const int src = in ? q0 + r : 0;
      if (which == 0) cp_async4(lse_s + buf * DKV_ROWS + r, lse + row_base + src, in);
      else if (which == 1) cp_async4(delta_s + buf * DKV_ROWS + r, delta + row_base + src, in);
      else cp_async4(qd_s + buf * DKV_ROWS + r, qdoc + src, in);
    }
    cp_async_commit();
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (n_steps > 0) {
    cp_async_tile<bf16, DKV_KEYS, D, LD, MMA_THREADS>(k_s, k + static_cast<size_t>(bkh) * S_len * D,
                                                      k0, S_len);
    cp_async_tile<bf16, DKV_KEYS, D, LD, MMA_THREADS>(v_s, v + static_cast<size_t>(bkh) * S_len * D,
                                                      k0, S_len);
    fetch(0, 0);
  }

  for (int j = 0; j < n_steps; ++j) {
    const int buf = j & 1;
    const int q0 = step_q0(j);
    cp_async_wait<0>();
    __syncthreads();  // step j has landed; every warp is done with step j - 1

    // Split the fp32 do tile into DO_TERMS bf16 planes; note which low
    // planes hold anything.
    bool nz[2] = {false, false};
#pragma unroll
    for (int it = 0; it < DKV_ROWS * D / (4 * MMA_THREADS); ++it) {
      const int i = (it * MMA_THREADS + static_cast<int>(threadIdx.x)) * 4;
      split_to_planes(*reinterpret_cast<const float4*>(do_s + i), pl_s, PLANE,
                      (i / D) * LD + i % D, nz);
    }
    // Barriers: the planes are ready and do_s is free for the next fetch.
    const int n_do = live_planes(nz);
    if (j + 1 < n_steps) fetch(j + 1, buf ^ 1);

    const bf16* qs = q_s + buf * PLANE;
    const float* ls = lse_s + buf * DKV_ROWS;
    const float* dls = delta_s + buf * DKV_ROWS;
    // Rows past T were zero-filled (lse 0, not NEG_INF): the ragged q tile
    // compares too.
    const bool edge = mask.template edge<DKV_ROWS, DKV_KEYS>(q0, k0) || q0 + DKV_ROWS > T_len;

    // 16 of the tile's queries at a time: the score tiles of a warp are then
    // 16 keys x 16 queries (two n-tiles), which keeps dk and dv in registers.
    // S^T runs its D / 16 mma in place, as the forward's S does; the longer
    // sums go through zeroed tiles that add_tile puts into their sum: one
    // 16-dim step of dP^T (its planes), one 16-query step of dV and dK.
#pragma unroll 1
    for (int c0 = 0; c0 < DKV_ROWS; c0 += 16) {
      float st[2][4], dp[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) st[0][e] = st[1][e] = dp[0][e] = dp[1][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T (over the planes that hold anything).
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, k_s + (warp * 16 + lo.row_a) * LD + kd * 16 + lo.col_a);
        ldmatrix_x4(b, qs + (c0 + lo.row_b) * LD + kd * 16 + lo.col_b);
        mma_pair(st[0], st[1], a, b);
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        ldmatrix_x4(a, v_s + (warp * 16 + lo.row_a) * LD + kd * 16 + lo.col_a);
#pragma unroll
        for (int p = DO_TERMS - 1; p >= 0; --p) {
          if (p >= n_do) continue;
          uint32_t b[4];
          ldmatrix_x4(b, pl_s + p * PLANE + (c0 + lo.row_b) * LD + kd * 16 + lo.col_b);
          mma_pair(t0, t1, a, b);
        }
        add_tile(dp[0], t0);
        add_tile(dp[1], t1);
      }
      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale. A
      // query whose lse is NEG_INF saw nothing: its p is 0.
#pragma unroll
      for (int jq = 0; jq < 2; ++jq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + jq * 8 + 2 * tq + (e & 1);
          const float lq = ls[c];
          float p = lq == NEG_INF ? 0.f : expf(st[jq][e] * scale - lq);
          if (edge) {
            const int qp = q0 + c;
            int dq = 0;
            if constexpr (Mask::DOCS) dq = qd_s[buf * DKV_ROWS + c];
            p = qp < T_len && mask.sees(qp, key0 + (e >> 1) * 8, dq, kdoc[e >> 1]) ? p : 0.f;
          }
          st[jq][e] = p;
          dp[jq][e] = p * (dp[jq][e] - dls[c]) * scale;
        }

      // dV += P^T dO: terms i of P^T and planes p with i + p < 3.
      uint32_t pa[DO_TERMS][4];
      c_to_a_split<DO_TERMS>(st[0], st[1], pa);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = DO_TERMS - 1; p >= 0; --p) {
          if (p >= n_do) continue;
          uint32_t b[4];
          ldmatrix_x4_trans(b, pl_s + p * PLANE + (c0 + lo.row_a) * LD + dn * 16 + lo.col_a);
#pragma unroll
          for (int i = DO_TERMS - 1 - p; i >= 0; --i) mma_pair(t0, t1, pa[i], b);
        }
        add_tile(dv_acc[2 * dn], t0);
        add_tile(dv_acc[2 * dn + 1], t1);
      }
      // dK += dS^T Q: terms i of dS^T.
      uint32_t sa[DO_TERMS][4];
      c_to_a_split<DO_TERMS>(dp[0], dp[1], sa);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, qs + (c0 + lo.row_a) * LD + dn * 16 + lo.col_a);
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = DO_TERMS - 1; i >= 0; --i) mma_pair(t0, t1, sa[i], b);
        add_tile(dk_acc[2 * dn], t0);
        add_tile(dk_acc[2 * dn + 1], t1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    if (kp >= S_len) continue;
    const size_t off = (static_cast<size_t>(bkh) * S_len + kp) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + off + n * 8 + 2 * tq) =
          make_float2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + off + n * 8 + 2 * tq) =
          make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

}  // namespace attn_mma
