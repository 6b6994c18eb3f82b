// Paged attention over a page-pooled KV cache, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the serving engine:
//   - paged_decode_attention_launch -> dstack_tpu/workloads/kernels/paged.py
//     `_paged_kernel` (paged_decode_attention_pallas): one query per slot;
//   - paged_chunk_attention_launch  -> dstack_tpu/workloads/kernels/paged.py
//     `_paged_chunk_kernel` (paged_chunk_attention_pallas): C queries per slot
//     at positions starts[s] + i.
// Decode is the C == 1 case of the chunk walk (start = kv_len - 1), so both
// entry points launch the same kernel body.
//
// What it computes (the Pallas kernels' semantics): query row i of slot s,
// head h attends over positions pos < min(kv_len, start + i + 1) of its KV
// head h / n_rep, reading the slot's pages in page-table order. Accumulation
// is fp32: scale 1/sqrt(D), masked scores -1e30, online softmax per page with
// the NEG_INF-safe max, output o / max(l, 1e-20) in fp32 (zeros when a row
// sees no position, e.g. kv_len == 0).
//
// Design: one block per (slot, KV head, tile of query rows), one warp per
// (query row, head of the GQA group). Each lane holds D/32 elements of its
// query and of the accumulator. The block walks the pages that the tile's
// last row can see; each page's K and V rows of this KV head are staged in
// shared memory with cp.async, double-buffered so page p+1 loads while page p
// computes. Scores come from warp reductions; lane t keeps the score of page
// row t, so the softmax max and sum are warp reductions too.
//
// Bound: the kernels are memory-bound at decode. One token of one layer's
// K+V at llama3_8b geometry (8 KV heads x 128 x bf16, K and V) is 4 KB, so a
// decode step's least time is the K/V bytes of the slots' live positions
// over the card's memory rate (3.35 TB/s on an H100 SXM). The chunk walk at
// C = 512 does enough score work to be bound by operations instead.
//
// Left for later: split-KV across blocks (one long slot is one block per KV
// head today, so a batch of few long slots leaves SMs idle); TMA page loads;
// tensor-core (mma / wgmma) score and PV products for the chunk walk, whose
// blocks today re-read every visible page once per tile of rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                                       const int* __restrict__ starts,    // [S], or null: decode
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
  const int start = starts != nullptr ? starts[slot] : kv_len - 1;
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

template <typename T, int EPT>
cudaError_t launch_ept(const void* q, const void* k_pages, const void* v_pages,
                       const int* page_table, const int* starts, const int* kv_lens, float* out,
                       int S, int C, int H, int Kh, int page, int P, int tile_rows, float scale,
                       cudaStream_t stream) {
  constexpr int D = 32 * EPT;
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

// dtype: 0 = float32, 1 = bfloat16 (q and pages share it).
cudaError_t launch(int dtype, const void* q, const void* k_pages, const void* v_pages,
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

}  // namespace

extern "C" {

// Decode: q [S, H, D], one query per slot at position kv_lens[s] - 1.
int paged_decode_attention_launch(int dtype, const void* q, const void* k_pages,
                                  const void* v_pages, const int* page_table,
                                  const int* kv_lens, float* out, int S, int H, int Kh, int D,
                                  int page, int P, float scale, void* stream) {
  return static_cast<int>(launch(dtype, q, k_pages, v_pages, page_table, nullptr, kv_lens, out,
                                 S, 1, H, Kh, D, page, P, 1, scale, stream));
}

// Chunk: q [S, C, H, D], query i of slot s at position starts[s] + i; a tile
// of `tile_rows` query rows per block (tile_rows * H / Kh <= 32 warps).
int paged_chunk_attention_launch(int dtype, const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table, const int* starts,
                                 const int* kv_lens, float* out, int S, int C, int H, int Kh,
                                 int D, int page, int P, int tile_rows, float scale,
                                 void* stream) {
  return static_cast<int>(launch(dtype, q, k_pages, v_pages, page_table, starts, kv_lens, out,
                                 S, C, H, Kh, D, page, P, tile_rows, scale, stream));
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
