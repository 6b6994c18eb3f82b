// Paged attention over a page-pooled KV cache, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the serving engine:
//   - paged_decode_attention_launch -> dstack_tpu/workloads/kernels/paged.py
//     `_paged_kernel` (paged_decode_attention_pallas): one query per slot;
//   - paged_chunk_attention_launch  -> dstack_tpu/workloads/kernels/paged.py
//     `_paged_chunk_kernel` (paged_chunk_attention_pallas): C queries per slot
//     at positions starts[s] + i.
//
// What they compute (the Pallas kernels' semantics): query row i of slot s,
// head h attends over positions pos < min(kv_len, start + i + 1) of its KV
// head h / n_rep, reading the slot's pages in page-table order. Accumulation
// is fp32: scale 1/sqrt(D), masked scores -1e30, online softmax with the
// NEG_INF-safe max, output o / max(l, 1e-20) in fp32 (zeros when a row sees
// no position, e.g. kv_len == 0). Rows past a slot's valid chunk tokens
// still attend all kv_len positions, as the Pallas kernel's rows do.
//
// Three kernels, chosen at compile time, never as a path taken when a launch
// fails:
//   - decode, at every type and D, runs paged_decode_split_kernel and
//     paged_decode_combine_kernel (split-KV, CUDA cores);
//   - the chunk entry point on bf16 q and pages at D = 32, 64, 128 runs
//     paged_chunk_mma_kernel on the tensor cores (TensorCore<T, D>);
//   - the chunk entry point on fp32 or at other head dims runs
//     paged_attention_kernel on CUDA cores.
//
// paged_decode_split_kernel. Bound: decode is memory-bound. One position of
// one layer's K+V at llama3_8b geometry (8 KV heads x 128 x bf16, K and V)
// is 4 KB, against 4 x 128 multiply-adds a query head: a step's least time
// is the K/V bytes of the slots' live positions over the card's memory rate
// (3.35 TB/s on an H100 SXM): 0.0327 ms at chip_smoke.py's 16 slots of up to
// 8192 positions. So the design keeps many positions' bytes in flight on
// every SM and spends few instructions a position:
//   - split-KV: one block per (split of `split` positions, KV head, slot);
//     the number of splits comes from the page-table width (P * page /
//     split; the wrapper's split is 256 positions, doubled until at most 32
//     splits cover the table), with no read of kv_len on the host; a split
//     that starts past the slot's kv_len exits at once. A few long slots then fill the card
//     with blocks: 16 slots at KV_LENS and split 256 give 896 working blocks
//     on 132 SMs;
//   - all n_rep query heads of the KV head in the block (q in fp32 in shared
//     memory), so each K/V byte is read from device memory once;
//   - K/V tiles of 32 positions gathered row by row through the page table
//     by 16-byte cp.async, zero-filled past the split's end, in a ring of 2
//     to 4 stages (as many as fit in 64 KB; 3 at bf16 D 128, with 4 blocks
//     an SM): the next tiles' gathers overlap this tile's math, and every
//     page size runs one path;
//   - scores: lane j holds position j, warp w a quarter of D; each thread
//     reads its K values once and dots them with every head's q (shared
//     memory, broadcast reads), the warps' quarters meet in shared memory;
//     the online softmax takes one warp max and one warp sum per head and
//     tile, not per key row; O += P V with warp w owning heads w, w + 4,
//     ... and lane t D / 32 output values of each (at n_rep < 4 a warp has
//     no head and waits);
//   - arithmetic in fp32 FMAs on values that are exact in fp32 (bf16 K, V
//     and q upcast), as the Pallas kernel's;
//   - each split writes its unnormalised o and its (max, sum) per head to an
//     fp32 workspace; paged_decode_combine_kernel joins them as one online
//     softmax would (m = max m_i, l = sum l_i exp(m_i - m), o = sum o_i
//     exp(m_i - m) / max(l, 1e-20)), zeros at kv_len 0.
//
// paged_chunk_mma_kernel. Bound: at the serving example's chunk (16 slots x
// C 512, llama3_8b: H 32, Kh 8, D 128, bf16) the score and PV products of the
// live pairs take 0.2171 ms at the card's bf16 rate and the K/V, q and out
// bytes less (chip_smoke.kernel_bounds): bound by operations. The CUDA-core
// walk above it ran those products as 32-lane shuffled dot products and
// re-read every visible page once per 4 chunk rows (128 times a slot at C
// 512). Design (flash_attention.cu's flash_fwd_mma_kernel, whose numerics
// attention_mma.cuh states):
//   - GQA fold: a block owns 64 folded rows of one (slot, KV head), 16 a
//     warp; folded row r is chunk row r / n_rep of head kh * n_rep + r %
//     n_rep, as the Pallas kernel folds them. At llama3_8b (n_rep 4) a block
//     holds 16 chunk rows x 4 heads and one K/V tile serves all four heads:
//     32 reads of each visible position per (slot, KV head) at C 512, not
//     128. (128 folded rows over 8 warps would halve that again, at twice
//     the shared memory and one block an SM; not taken.)
//   - K/V tiles of 64 keys gathered row by row through the page table (key
//     pos lives at page page_table[s][pos / page], row pos % page), 16-byte
//     cp.async copies zero-filled past the tile's last visible position, in
//     a 2-stage ring: the next tile's gather overlaps this tile's math. The
//     address is computed per row, so every page size runs this path.
//   - S = Q K^T in place over D / 16 mma (bf16 products are exact in fp32);
//     the online softmax per row over a quad; P from its C fragments to A
//     fragments in 3 bf16 terms (c_to_a_split) and O += P_i V with V through
//     ldmatrix.trans, the tile's 64 keys summed in a zeroed tile that
//     add_tile puts into O. mma work a live pair: 1 + 3 = 4 units of D
//     multiply-adds, against a plain bf16 kernel's 2.
//   - Masks: folded row r sees pos < min(kv_len, start + r / n_rep + 1);
//     only tiles that cross the block's first row's limit pay for the
//     compares, and the walk ends at the last position the block's last
//     row sees. Blocks of the last rows, which see the most, start first.
//
// paged_attention_kernel (CUDA cores, the chunk entry point on fp32 or other
// D): one block per (slot, KV head, tile of query rows), one warp per (query
// row, head of the GQA group). Each lane holds D/32 elements of its query and
// of the accumulator. The block walks the pages that the tile's last row can
// see; each page's K and V rows of this KV head are staged in shared memory
// with cp.async, double-buffered so page p+1 loads while page p computes.
// Scores come from warp reductions; lane t keeps the score of page row t, so
// the softmax max and sum are warp reductions too.
//
// Left for later: TMA page loads for decode; wgmma for the chunk walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Stage page `pid`'s rows of KV head `kh` (K and V, [page, D] each) into
// buffer `buf` of the shared-memory ring, 16 bytes per cp.async.
template <typename T, int D>
__device__ __forceinline__ void stage_page(T* k_s, T* v_s, const T* __restrict__ k_pages,
                                           const T* __restrict__ v_pages, int pid, int kh,
                                           int Kh, int page, int buf) {
  constexpr int VEC_PER_ROW = D * static_cast<int>(sizeof(T)) / 16;
  const int vecs = page * VEC_PER_ROW;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int t = i / VEC_PER_ROW;
    const int c = i % VEC_PER_ROW;
    const size_t g = ((static_cast<size_t>(pid) * page + t) * Kh + kh) * D;
    const size_t s = (static_cast<size_t>(buf) * page + t) * D;
    cp_async16(reinterpret_cast<char*>(k_s + s) + c * 16,
               reinterpret_cast<const char*>(k_pages + g) + c * 16);
    cp_async16(reinterpret_cast<char*>(v_s + s) + c * 16,
               reinterpret_cast<const char*>(v_pages + g) + c * 16);
  }
}

// EPT = elements of D per lane (D = 32 * EPT).
template <typename T, int EPT>
__global__ void paged_attention_kernel(const T* __restrict__ q,           // [S, C, H, D]
                                       const T* __restrict__ k_pages,     // [N, page, Kh, D]
                                       const T* __restrict__ v_pages,     // [N, page, Kh, D]
                                       const int* __restrict__ page_table,  // [S, P]
                                       const int* __restrict__ starts,    // [S]
                                       const int* __restrict__ kv_lens,   // [S]
                                       float* __restrict__ out,           // [S, C, H, D]
                                       int C, int H, int Kh, int page, int P, int tile_rows,
                                       float scale) {
  constexpr int D = 32 * EPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [2][page][D]
  T* v_s = k_s + 2 * page * D;              // [2][page][D]

  const int slot = blockIdx.x;
  const int kh = blockIdx.y;
  const int n_rep = H / Kh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.z * tile_rows + warp / n_rep;
  const int head = kh * n_rep + warp % n_rep;
  const bool active = row < C;

  const int kv_len = kv_lens[slot];
  const int start = starts[slot];
  // Row `row` attends pos <= start + row and pos < kv_len.
  const int limit = min(kv_len, start + row + 1);
  // The page walk ends at the last page the tile's last row can see.
  const int last_row = min(C, static_cast<int>(blockIdx.z + 1) * tile_rows) - 1;
  const int visible = min(kv_len, start + last_row + 1);
  const int n_pages = visible > 0 ? min((visible + page - 1) / page, P) : 0;

  float qv[EPT];
  float acc[EPT];
  const size_t q_off = ((static_cast<size_t>(slot) * C + (active ? row : 0)) * H + head) * D;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    qv[e] = active ? to_float(q[q_off + lane * EPT + e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  const int* table = page_table + static_cast<size_t>(slot) * P;
  if (n_pages > 0) stage_page<T, D>(k_s, v_s, k_pages, v_pages, table[0], kh, Kh, page, 0);
  cp_async_commit();

  for (int p = 0; p < n_pages; ++p) {
    const int buf = p & 1;
    if (p + 1 < n_pages)
      stage_page<T, D>(k_s, v_s, k_pages, v_pages, table[p + 1], kh, Kh, page, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // page p has landed (page p + 1 may still be in flight)
    __syncthreads();

    const T* kb = k_s + static_cast<size_t>(buf) * page * D;
    const T* vb = v_s + static_cast<size_t>(buf) * page * D;
    // Pages longer than a warp go in sub-tiles of 32 rows; lane t owns row t.
    for (int t0 = 0; t0 < page; t0 += 32) {
      const int rows = min(32, page - t0);
      float s_mine = NEG_INF;
      for (int t = 0; t < rows; ++t) {
        const T* kr = kb + (t0 + t) * D + lane * EPT;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) part += qv[e] * to_float(kr[e]);
        part = warp_sum(part);
        if (lane == t) s_mine = part * scale;
      }
      const int pos = p * page + t0 + lane;
      const bool valid = active && lane < rows && pos < limit;
      const float s = valid ? s_mine : NEG_INF;
      const float m_new = fmaxf(m, warp_max(s));
      const float safe_m = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m == NEG_INF ? 0.f : expf(m - safe_m);
      const float prob = valid ? expf(s - safe_m) : 0.f;
      l = l * corr + warp_sum(prob);
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[e] *= corr;
      for (int t = 0; t < rows; ++t) {
        const float pt = __shfl_sync(FULL_MASK, prob, t);
        const T* vr = vb + (t0 + t) * D + lane * EPT;
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[e] += pt * to_float(vr[e]);
      }
      m = m_new;
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  if (active) {
    const float denom = fmaxf(l, 1e-20f);
    float* o = out + ((static_cast<size_t>(slot) * C + row) * H + head) * D + lane * EPT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) o[e] = acc[e] / denom;
  }
}

// -- the split-KV decode kernel (every type and D) ------------------------------

constexpr int DEC_THREADS = 128;  // 4 warps
constexpr int DEC_WARPS = 4;
constexpr int DEC_KEYS = 32;      // positions of a gathered K/V tile, one a lane
constexpr int DEC_MAX_HEADS = 8;  // heads of a warp: n_rep <= 32

// A K/V tile row of T at head dim D, padded by 16 bytes: the 32 rows one
// 16-byte load reads across a warp fall in distinct bank groups.
template <typename T, int D>
__host__ __device__ constexpr int dec_ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Ring depth: as many K/V tile pairs as fit in 64 KB, 2 to 4. At bf16 D 128
// that is 3 stages and 56 KB a block, so 4 blocks share an SM: more resident
// warps hide the gather's latency, where a deeper ring would leave room for
// fewer blocks.
template <typename T, int D>
__host__ __device__ constexpr int dec_stages() {
  constexpr int budget = 65536;
  constexpr int stage = 2 * DEC_KEYS * dec_ld<T, D>() * static_cast<int>(sizeof(T));
  return budget / stage > 4 ? 4 : (budget / stage < 2 ? 2 : budget / stage);
}

// The K/V ring; q of the block's heads in fp32; the warps' partial scores
// (then p); each head's running max, sum and last correction.
template <typename T, int D>
size_t dec_smem_bytes(int n_rep) {
  return static_cast<size_t>(2 * dec_stages<T, D>() * DEC_KEYS * dec_ld<T, D>()) * sizeof(T) +
         static_cast<size_t>(n_rep) * (D + DEC_WARPS * DEC_KEYS + 3) * 4;
}

// One 32-bit word of T values into out[i..]: bf16 -> fp32 is exact (the
// bf16 bits are the high half of the float's).
template <typename T, int N>
__device__ __forceinline__ void put_word(float (&out)[N], int i, uint32_t w) {
  if constexpr (sizeof(T) == 2) {
    out[i] = __uint_as_float(w << 16);
    out[i + 1] = __uint_as_float(w & 0xffff0000u);
  } else {
    out[i] = __uint_as_float(w);
  }
}

// N values of T at p as floats, in the widest loads that N * sizeof(T)
// allows (p is aligned to that width).
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int EPW = 4 / static_cast<int>(sizeof(T));  // values a 32-bit word
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      put_word<T>(out, (4 * c) * EPW, u.x);
      put_word<T>(out, (4 * c + 1) * EPW, u.y);
      put_word<T>(out, (4 * c + 2) * EPW, u.z);
      put_word<T>(out, (4 * c + 3) * EPW, u.w);
    }
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int c = 0; c < BYTES / 8; ++c) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[c];
      put_word<T>(out, (2 * c) * EPW, u.x);
      put_word<T>(out, (2 * c + 1) * EPW, u.y);
    }
  } else if constexpr (BYTES % 4 == 0) {
#pragma unroll
    for (int c = 0; c < BYTES / 4; ++c)
      put_word<T>(out, c * EPW, reinterpret_cast<const uint32_t*>(p)[c]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_float(p[e]);
  }
}

// One block per (split, KV head, slot): positions [s0, s1) of the slot, s0 =
// split_i * split, s1 = min(s0 + split, kv_len, P * page), for the n_rep query
// heads of the KV head. Writes the split's unnormalised o and its (max, sum)
// per head; a split that starts at or past s1 writes nothing.
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_split_kernel(const T* __restrict__ q,            // [S, H, D]
                              const T* __restrict__ k_pages,      // [N, page, Kh, D]
                              const T* __restrict__ v_pages,      // [N, page, Kh, D]
                              const int* __restrict__ page_table, // [S, P]
                              const int* __restrict__ kv_lens,    // [S]
                              float* __restrict__ o_part,         // [S, Kh, NS, n_rep, D]
                              float* __restrict__ ml_part,        // [S, Kh, NS, n_rep, 2]
                              int H, int Kh, int page, int P, int split, float scale) {
  constexpr int LD = dec_ld<T, D>();
  constexpr int STAGES = dec_stages<T, D>();
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // values a 16-byte copy
  constexpr int CPR = D / PER;                            // copies a row
  constexpr int QD = D / DEC_WARPS;  // the D slice of a warp's partial scores
  constexpr int EPT = D / 32;        // output values of a lane
  static_assert(DEC_KEYS * CPR % DEC_THREADS == 0, "every thread issues the same copies");
  static_assert(QD % PER == 0 && QD % 4 == 0, "a warp's D slice is whole 16-byte loads");
  const int split_i = blockIdx.x, kh = blockIdx.y, slot = blockIdx.z;
  const int s0 = split_i * split;
  const int end = min(kv_lens[slot], P * page);
  if (s0 >= end) return;
  const int s1 = min(end, s0 + split);
  const int n_tiles = (s1 - s0 + DEC_KEYS - 1) / DEC_KEYS;
  const int n_rep = H / Kh;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [STAGES][DEC_KEYS][LD]
  T* v_s = k_s + STAGES * DEC_KEYS * LD;
  float* q_s = reinterpret_cast<float*>(v_s + STAGES * DEC_KEYS * LD);  // [n_rep][D]
  float* sc_s = q_s + n_rep * D;              // [DEC_WARPS][n_rep][DEC_KEYS]
  float* m_s = sc_s + DEC_WARPS * n_rep * DEC_KEYS;  // [n_rep]
  float* l_s = m_s + n_rep;
  float* corr_s = l_s + n_rep;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int* table = page_table + static_cast<size_t>(slot) * P;
  const float inv_page = 1.f / static_cast<float>(page);
  // Tile jt into its ring stage, gathered row by row through the page table
  // (position pos is row pos % page of page table[pos / page], the quotient
  // from a float product corrected to the exact one: no integer division);
  // rows from s1 on are zero-filled and never read. Past the last tile the
  // group is empty, which keeps the count of committed groups.
  auto fetch = [&](int jt) {
    if (jt < n_tiles) {
      T* kt = k_s + (jt % STAGES) * DEC_KEYS * LD;
      T* vt = v_s + (jt % STAGES) * DEC_KEYS * LD;
#pragma unroll
      for (int it = 0; it < DEC_KEYS * CPR / DEC_THREADS; ++it) {
        const int i = it * DEC_THREADS + static_cast<int>(threadIdx.x);
        const int r = i / CPR, c = (i % CPR) * PER;
        const int pos = s0 + jt * DEC_KEYS + r;
        const bool valid = pos < s1;
        int pg = static_cast<int>(static_cast<float>(pos) * inv_page);
        int row = pos - pg * page;
        while (row < 0) --pg, row += page;
        while (row >= page) ++pg, row -= page;
        const size_t src =
            valid ? ((static_cast<size_t>(table[pg]) * page + row) * Kh + kh) * D + c : 0;
        attn_mma::cp_async16(kt + r * LD + c, k_pages + src, valid);
        attn_mma::cp_async16(vt + r * LD + c, v_pages + src, valid);
      }
    }
    attn_mma::cp_async_commit();
  };
#pragma unroll
  for (int jt = 0; jt < STAGES - 1; ++jt) fetch(jt);

  const T* qh = q + (static_cast<size_t>(slot) * H + kh * n_rep) * D;
  for (int i = threadIdx.x; i < n_rep * D; i += DEC_THREADS) q_s[i] = to_float(qh[i]);
  for (int r = threadIdx.x; r < n_rep; r += DEC_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // acc[i]: output values [lane EPT, (lane + 1) EPT) of head warp + 4 i.
  float acc[DEC_MAX_HEADS][EPT];
#pragma unroll
  for (int ii = 0; ii < DEC_MAX_HEADS; ++ii)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[ii][e] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    attn_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile jt has landed; every warp is done with tile jt - 1
    fetch(jt + STAGES - 1);
    const T* kt = k_s + (jt % STAGES) * DEC_KEYS * LD;
    const T* vt = v_s + (jt % STAGES) * DEC_KEYS * LD;

    // Partial scores: lane j's position against every head, over warp w's
    // slice of D; the position's K values are read once for all heads.
    {
      float kf[QD];
      load_floats<T, QD>(kt + lane * LD + warp * QD, kf);
      for (int r = 0; r < n_rep; ++r) {
        const float* qr = q_s + r * D + warp * QD;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains
#pragma unroll
        for (int e = 0; e < QD; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          dot[0] = fmaf(kf[e], qv.x, dot[0]);
          dot[1] = fmaf(kf[e + 1], qv.y, dot[1]);
          dot[2] = fmaf(kf[e + 2], qv.z, dot[2]);
          dot[3] = fmaf(kf[e + 3], qv.w, dot[3]);
        }
        sc_s[(warp * n_rep + r) * DEC_KEYS + lane] = (dot[0] + dot[1]) + (dot[2] + dot[3]);
      }
    }
    __syncthreads();

    // The online softmax: warp w owns heads w, w + 4, ..., lane j position
    // j; one max and one sum over the warp per head and tile. p replaces
    // the head's partial row of warp 0, which only this lane reads.
    const int pos = s0 + jt * DEC_KEYS + lane;
    for (int r = warp; r < n_rep; r += DEC_WARPS) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) x += sc_s[(w * n_rep + r) * DEC_KEYS + lane];
      x = pos < s1 ? x * scale : NEG_INF;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float safe_m = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m_old == NEG_INF ? 0.f : expf(m_old - safe_m);
      const float p = pos < s1 ? expf(x - safe_m) : 0.f;
      const float l_new = l_s[r] * corr + warp_sum(p);
      sc_s[r * DEC_KEYS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // O += P V: warp w owns heads w, w + 4, ...; lane t the output values
    // [t EPT, (t + 1) EPT) of its heads. The tile's even and odd positions
    // sum apart (two independent chains), then into acc. The position loop
    // is unrolled by 2 only: a full unroll takes 221 registers at bf16 D
    // 128, which leaves room for 2 blocks an SM where 127 leave room for 4.
#pragma unroll
    for (int ii = 0; ii < DEC_MAX_HEADS; ++ii) {
      const int r = warp + ii * DEC_WARPS;
      if (r >= n_rep) break;
      const float* pr = sc_s + r * DEC_KEYS;
      float t[2][EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) t[0][e] = t[1][e] = 0.f;
#pragma unroll 2
      for (int j = 0; j < DEC_KEYS; j += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float vf[EPT];
          load_floats<T, EPT>(vt + (j + h) * LD + lane * EPT, vf);
#pragma unroll
          for (int e = 0; e < EPT; ++e) t[h][e] = fmaf(pr[j + h], vf[e], t[h][e]);
        }
      }
      const float corr = corr_s[r];
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[ii][e] = acc[ii][e] * corr + (t[0][e] + t[1][e]);
    }
  }

  // The split's rows of heads in the workspace: head r at (base + r).
  const size_t base = ((static_cast<size_t>(slot) * Kh + kh) * gridDim.x + split_i) * n_rep;
  for (int r = threadIdx.x; r < n_rep; r += DEC_THREADS) {
    ml_part[(base + r) * 2] = m_s[r];
    ml_part[(base + r) * 2 + 1] = l_s[r];
  }
#pragma unroll
  for (int ii = 0; ii < DEC_MAX_HEADS; ++ii) {
    const int r = warp + ii * DEC_WARPS;
    if (r >= n_rep) break;
    float* dst = o_part + (base + r) * D + lane * EPT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) dst[e] = acc[ii][e];
  }
}

// out [S, H, D] from the splits of paged_decode_split_kernel, as one online
// softmax over all of a slot's positions would give it: m = max m_i, l =
// sum l_i exp(m_i - m), o = sum o_i exp(m_i - m) / max(l, 1e-20). Only the
// splits that start before the slot's end wrote; a slot with kv_len 0 has
// none and gives zeros. One block per (head, slot); the first warp finds m,
// the weights exp(m_i - m) (into shared memory, n_split + 1 floats) and l.
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                                const int* __restrict__ kv_lens, float* __restrict__ out, int H,
                                int Kh, int D, int page, int P, int split, int n_split) {
  extern __shared__ float w_s[];  // [n_split] weights, then the denominator
  const int h = blockIdx.x, slot = blockIdx.y;
  const int n_rep = H / Kh;
  const int end = min(kv_lens[slot], P * page);
  const int n_live = end > 0 ? (end + split - 1) / split : 0;
  // Split i's row of head h: (base + i * n_rep).
  const size_t base = (static_cast<size_t>(slot) * Kh + h / n_rep) * n_split * n_rep + h % n_rep;
  if (threadIdx.x < 32) {
    float m = NEG_INF;
    for (int i = threadIdx.x; i < n_live; i += 32) m = fmaxf(m, ml_part[(base + i * n_rep) * 2]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = threadIdx.x; i < n_live; i += 32) {
      const size_t row = base + i * n_rep;
      const float w = expf(ml_part[row * 2] - m);
      w_s[i] = w;
      l += ml_part[row * 2 + 1] * w;
    }
    l = warp_sum(l);
    if (threadIdx.x == 0) w_s[n_split] = fmaxf(l, 1e-20f);
  }
  __syncthreads();
  const float denom = w_s[n_split];
  for (int e = threadIdx.x; e < D; e += DEC_THREADS) {
    float o = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_live; ++i) o = fmaf(o_part[(base + i * n_rep) * D + e], w_s[i], o);
    out[(static_cast<size_t>(slot) * H + h) * D + e] = o / denom;
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k_pages, const void* v_pages,
                          const int* page_table, const int* kv_lens, float* out, float* o_part,
                          float* ml_part, int S, int H, int Kh, int page, int P, int split,
                          float scale, cudaStream_t stream) {
  const size_t smem = dec_smem_bytes<T, D>(H / Kh);
  auto kernel = paged_decode_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_split = (P * page + split - 1) / split;
  kernel<<<dim3(n_split, Kh, S), DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      page_table, kv_lens, o_part, ml_part, H, Kh, page, P, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t weights = (n_split + 1) * sizeof(float);
  paged_decode_combine_kernel<<<dim3(H, S), DEC_THREADS, weights, stream>>>(
      o_part, ml_part, kv_lens, out, H, Kh, D, page, P, split, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_typed(const void* q, const void* k_pages, const void* v_pages,
                                const int* page_table, const int* kv_lens, float* out,
                                float* o_part, float* ml_part, int S, int H, int Kh, int D,
                                int page, int P, int split, float scale, cudaStream_t stream) {
#define DECODE_CASE(DIM)                                                                         \
  case DIM:                                                                                      \
    return launch_decode<T, DIM>(q, k_pages, v_pages, page_table, kv_lens, out, o_part, ml_part, \
                                 S, H, Kh, page, P, split, scale, stream);
  switch (D) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(96)
    DECODE_CASE(128)
    DECODE_CASE(160)
    DECODE_CASE(192)
    DECODE_CASE(224)
    DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

// -- the tensor-core chunk walk (bf16, D = 32, 64, 128) ------------------------

using bf16 = __nv_bfloat16;

using attn_mma::TensorCore;

constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int CHUNK_ROWS = 64;    // folded rows of a block, 16 a warp
constexpr int CHUNK_KEYS = 64;    // keys of a gathered K/V tile
constexpr int CHUNK_STAGES = 2;   // K/V ring depth
constexpr int P_TERMS = 3;        // bf16 terms of P

template <int D>
constexpr size_t chunk_mma_smem_bytes() {
  return static_cast<size_t>(CHUNK_ROWS + 2 * CHUNK_STAGES * CHUNK_KEYS) * attn_mma::padded(D) *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    paged_chunk_mma_kernel(const bf16* __restrict__ q,           // [S, C, H, D]
                           const bf16* __restrict__ k_pages,     // [N, page, Kh, D]
                           const bf16* __restrict__ v_pages,     // [N, page, Kh, D]
                           const int* __restrict__ page_table,   // [S, P]
                           const int* __restrict__ starts,       // [S]
                           const int* __restrict__ kv_lens,      // [S]
                           float* __restrict__ out,              // [S, C, H, D]
                           int C, int H, int Kh, int page, int P, float scale) {
  // cp_async16 and cp_async_commit are named in both namespaces: qualified.
  using namespace attn_mma;
  constexpr int LD = padded(D);
  constexpr int KD = D / 16;          // k-steps of Q K^T
  constexpr int NK = CHUNK_KEYS / 8;  // score n-tiles
  constexpr int ND = D / 8;           // output n-tiles
  constexpr int CPR = D / 8;          // 16-byte copies a row
  static_assert(CHUNK_ROWS * CPR % MMA_THREADS == 0 && CHUNK_KEYS * CPR % MMA_THREADS == 0,
                "every thread issues the same number of copies");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [CHUNK_ROWS][LD]
  bf16* k_s = q_s + CHUNK_ROWS * LD;              // [CHUNK_STAGES][CHUNK_KEYS][LD]
  bf16* v_s = k_s + CHUNK_STAGES * CHUNK_KEYS * LD;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const LaneOffsets lo(lane);
  const int n_rep = H / Kh;
  const int rows = C * n_rep;  // folded rows of this (slot, KV head)
  const int n_tiles = (rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * CHUNK_ROWS;
  const int kh = blockIdx.y;
  const int slot = blockIdx.z;
  // The walk reads no position past the page table's P pages.
  const int kv_end = min(kv_lens[slot], P * page);
  const int start = starts[slot];
  // Folded row r sees pos < limit(r); the limit grows with r.
  auto limit = [&](int r) { return max(0, min(kv_end, start + r / n_rep + 1)); };
  const int first_limit = limit(r0);
  const int visible = limit(min(rows, r0 + CHUNK_ROWS) - 1);
  const int n_kv = (visible + CHUNK_KEYS - 1) / CHUNK_KEYS;
  const int* table = page_table + static_cast<size_t>(slot) * P;
  // Element offset of folded row r's query row, and of its output row.
  auto row_offset = [&](int r) {
    return ((static_cast<size_t>(slot) * C + r / n_rep) * H + kh * n_rep + r % n_rep) * D;
  };
  // K/V tile jk into ring stage st, gathered row by row through the page
  // table; positions from `visible` on are zero-filled and never read.
  auto fetch = [&](int jk, int st) {
    bf16* kt = k_s + st * CHUNK_KEYS * LD;
    bf16* vt = v_s + st * CHUNK_KEYS * LD;
#pragma unroll
    for (int it = 0; it < CHUNK_KEYS * CPR / MMA_THREADS; ++it) {
      const int i = it * MMA_THREADS + static_cast<int>(threadIdx.x);
      const int r = i / CPR, c = (i % CPR) * 8;
      const int pos = jk * CHUNK_KEYS + r;
      const bool valid = pos < visible;
      const size_t src =
          valid ? ((static_cast<size_t>(table[pos / page]) * page + pos % page) * Kh + kh) * D + c
                : 0;
      attn_mma::cp_async16(kt + r * LD + c, k_pages + src, valid);
      attn_mma::cp_async16(vt + r * LD + c, v_pages + src, valid);
    }
  };

  if (n_kv > 0) {
#pragma unroll
    for (int it = 0; it < CHUNK_ROWS * CPR / MMA_THREADS; ++it) {
      const int i = it * MMA_THREADS + static_cast<int>(threadIdx.x);
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool valid = r0 + r < rows;
      attn_mma::cp_async16(q_s + r * LD + c, q + (valid ? row_offset(r0 + r) + c : 0), valid);
    }
    fetch(0, 0);
    attn_mma::cp_async_commit();
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row = r0 + warp * 16 + g;  // this lane's folded rows: row, row + 8
  const int lim[2] = {limit(row), limit(row + 8)};

  for (int jk = 0; jk < n_kv; ++jk) {
    cp_async_wait<0>();
    __syncthreads();  // tile jk has landed; every warp is done with tile jk - 1
    // The q fragments, read again per tile, as the flash forward does.
    uint32_t qf[KD][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldmatrix_x4(qf[kd], q_s + (warp * 16 + lo.row_a) * LD + kd * 16 + lo.col_a);
    if (jk + 1 < n_kv) {
      fetch(jk + 1, (jk + 1) % CHUNK_STAGES);
      attn_mma::cp_async_commit();
    }
    const bf16* ks = k_s + (jk % CHUNK_STAGES) * CHUNK_KEYS * LD;
    const bf16* vs = v_s + (jk % CHUNK_STAGES) * CHUNK_KEYS * LD;

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

    // Scale, mask (only a tile that crosses the block's first row's limit),
    // and the online softmax of rows `row` (e = 0, 1) and `row + 8` (e = 2, 3).
    const int k0 = jk * CHUNK_KEYS;
    const bool edge = k0 + CHUNK_KEYS > first_limit;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) x = k0 + j * 8 + 2 * tq + (e & 1) < lim[e >> 1] ? x : NEG_INF;
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
        const float pv = expf(s[j][e] - safe_m[e >> 1]);
        s[j][e] = pv;
        l[e >> 1] += pv;
      }

    // O += P V: P in P_TERMS bf16 terms; per 16 output columns the tile's
    // 64 keys meet in a zeroed tile that add_tile puts into acc.
    uint32_t pa[NK / 2][P_TERMS][4];
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) c_to_a_split<P_TERMS>(s[2 * kk], s[2 * kk + 1], pa[kk]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + lo.row_a) * LD + dn * 16 + lo.col_a);
#pragma unroll
        for (int i = P_TERMS - 1; i >= 0; --i) mma_pair(t0, t1, pa[kk][i], b);
      }
      add_tile(acc[2 * dn], t0);
      add_tile(acc[2 * dn + 1], t1);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-20f);
    const int fr = row + 8 * r;
    if (fr >= rows) continue;
    float* orow = out + row_offset(fr);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
  }
}

template <int D>
cudaError_t launch_chunk_mma(const void* q, const void* k_pages, const void* v_pages,
                             const int* page_table, const int* starts, const int* kv_lens,
                             float* out, int S, int C, int H, int Kh, int page, int P,
                             float scale, cudaStream_t stream) {
  constexpr size_t smem = chunk_mma_smem_bytes<D>();
  auto kernel = paged_chunk_mma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = C * (H / Kh);
  const dim3 grid((rows + CHUNK_ROWS - 1) / CHUNK_ROWS, Kh, S);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), page_table, starts, kv_lens, out, C, H, Kh, page, P,
      scale);
  return cudaGetLastError();
}

template <typename T, int EPT>
cudaError_t launch_ept(const void* q, const void* k_pages, const void* v_pages,
                       const int* page_table, const int* starts, const int* kv_lens, float* out,
                       int S, int C, int H, int Kh, int page, int P, int tile_rows, float scale,
                       cudaStream_t stream) {
  constexpr int D = 32 * EPT;
  if constexpr (TensorCore<T, D>::value)
    return launch_chunk_mma<D>(q, k_pages, v_pages, page_table, starts, kv_lens, out, S, C, H, Kh,
                               page, P, scale, stream);
  const int n_rep = H / Kh;
  const size_t smem = 2 * 2 * static_cast<size_t>(page) * D * sizeof(T);
  auto kernel = paged_attention_kernel<T, EPT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(S, Kh, (C + tile_rows - 1) / tile_rows);
  const dim3 block(32 * n_rep * tile_rows);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      page_table, starts, kv_lens, out, C, H, Kh, page, P, tile_rows, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k_pages, const void* v_pages,
                         const int* page_table, const int* starts, const int* kv_lens,
                         float* out, int S, int C, int H, int Kh, int D, int page, int P,
                         int tile_rows, float scale, cudaStream_t stream) {
#define PAGED_CASE(EPT)                                                                    \
  case 32 * EPT:                                                                           \
    return launch_ept<T, EPT>(q, k_pages, v_pages, page_table, starts, kv_lens, out, S, C, \
                              H, Kh, page, P, tile_rows, scale, stream);
  switch (D) {
    PAGED_CASE(1)
    PAGED_CASE(2)
    PAGED_CASE(3)
    PAGED_CASE(4)
    PAGED_CASE(5)
    PAGED_CASE(6)
    PAGED_CASE(7)
    PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

// The chunk entry point. dtype: 0 = float32, 1 = bfloat16 (q and pages
// share it).
cudaError_t launch_chunk(int dtype, const void* q, const void* k_pages, const void* v_pages,
                         const int* page_table, const int* starts, const int* kv_lens, float* out,
                         int S, int C, int H, int Kh, int D, int page, int P, int tile_rows,
                         float scale, void* stream) {
  // Clear an error left by an earlier call of this library (a refused
  // cudaFuncSetAttribute, say), so the launch below reports only its own.
  (void)cudaGetLastError();
  if (S == 0 || C == 0) return cudaSuccess;
  if (Kh <= 0 || H % Kh != 0 || H / Kh > 32 || H / Kh * tile_rows > 32 || page <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k_pages, v_pages, page_table, starts, kv_lens, out, S, C, H,
                               Kh, D, page, P, tile_rows, scale, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k_pages, v_pages, page_table, starts, kv_lens, out, S,
                                       C, H, Kh, D, page, P, tile_rows, scale, st);
  return cudaErrorInvalidValue;
}

// What paged_decode_attention_launch (kernel 0) and
// paged_chunk_attention_launch (1) run for inputs of type T and head dim D.
template <typename T, int D>
const char* describe(int kernel) {
  if (kernel == 0)
    return "CUDA cores, fp32 FMAs, split-KV (paged_decode_split_kernel: a block per (split of"
           " positions, KV head, slot) with the KV head's n_rep query heads, 32-position K/V tiles"
           " gathered through the page table by cp.async into a 2-4 stage ring; the splits joined"
           " by paged_decode_combine_kernel)";
  if (TensorCore<T, D>::value)
    return "bf16 tensor cores (paged_chunk_mma_kernel: mma.sync m16n8k16 + cp.async page-table"
           " gather, 64 folded GQA rows a block), P in 3 bf16 terms; mma work 4 units a pair"
           " (QK 1 + PV 3) against a plain bf16 kernel's 2";
  return "CUDA cores, fp32 FMAs and warp reductions (paged_attention_kernel)";
}

template <typename T>
const char* describe_typed(int kernel, int D) {
  switch (D) {
    case 32: return describe<T, 32>(kernel);
    case 64: return describe<T, 64>(kernel);
    case 96: return describe<T, 96>(kernel);
    case 128: return describe<T, 128>(kernel);
    case 160: return describe<T, 160>(kernel);
    case 192: return describe<T, 192>(kernel);
    case 224: return describe<T, 224>(kernel);
    case 256: return describe<T, 256>(kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Decode: q [S, H, D], one query per slot at position kv_lens[s] - 1. Each
// block walks `split` positions; o_part holds S * ceil(P * page / split) * H
// * D floats and ml_part S * ceil(P * page / split) * H * 2 (fp32
// workspace, written before it is read).
int paged_decode_attention_launch(int dtype, const void* q, const void* k_pages,
                                  const void* v_pages, const int* page_table,
                                  const int* kv_lens, float* out, float* o_part, float* ml_part,
                                  int S, int H, int Kh, int D, int page, int P, int split,
                                  float scale, void* stream) {
  (void)cudaGetLastError();
  if (S == 0) return static_cast<int>(cudaSuccess);
  if (Kh <= 0 || H % Kh != 0 || H / Kh > 32 || page <= 0 || P <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_decode_typed<float>(q, k_pages, v_pages, page_table, kv_lens,
                                                       out, o_part, ml_part, S, H, Kh, D, page,
                                                       P, split, scale, st));
  if (dtype == 1)
    return static_cast<int>(launch_decode_typed<__nv_bfloat16>(
        q, k_pages, v_pages, page_table, kv_lens, out, o_part, ml_part, S, H, Kh, D, page, P,
        split, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Chunk: q [S, C, H, D], query i of slot s at position starts[s] + i. The
// CUDA-core walk takes a tile of `tile_rows` query rows per block (tile_rows *
// H / Kh <= 32 warps); the tensor-core walk its own 64 folded rows.
int paged_chunk_attention_launch(int dtype, const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table, const int* starts,
                                 const int* kv_lens, float* out, int S, int C, int H, int Kh,
                                 int D, int page, int P, int tile_rows, float scale,
                                 void* stream) {
  return static_cast<int>(launch_chunk(dtype, q, k_pages, v_pages, page_table, starts, kv_lens,
                                       out, S, C, H, Kh, D, page, P, tile_rows, scale, stream));
}

// The instantiation that a launch of kernel 0 (decode) or 1 (chunk) runs for
// this dtype code and head dim; null where none does.
const char* paged_instantiation(int kernel, int dtype, int D) {
  if (kernel < 0 || kernel > 1) return nullptr;
  if (dtype == 0) return describe_typed<float>(kernel, D);
  if (dtype == 1) return describe_typed<__nv_bfloat16>(kernel, D);
  return nullptr;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
