// Warp-level tensor-core pieces of the attention kernels for Hopper (sm_90a):
// ldmatrix and mma.sync wrappers, the lane geometry of m16n8k16 fragments,
// fragment conversions, the split of fp32 values into bf16 terms, and the
// cp.async copies that fill a ring of shared-memory tiles. Used by
// flash_attention.cu's flash_fwd_mma_kernel, flash_bwd_dq_mma_kernel and
// flash_bwd_dkv_mma_kernel, which replace the Pallas `_fwd_kernel`,
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (dstack_tpu/workloads/kernels/
// flash.py), and by paged_attention.cu's paged_chunk_mma_kernel, which
// replaces `_paged_chunk_kernel` (dstack_tpu/workloads/kernels/paged.py);
// those sources state their bounds on this card and their designs.
//
// The kernels that include it keep the fp32 contract of the Pallas kernels
// they replace (which upcast q, k, v, p and ds to fp32 before every dot) on
// bf16 tensor cores:
//   - bf16 inputs lose nothing when upcast, so a product of two bf16 tiles
//     with fp32 accumulation (mma.sync ... .f32.bf16.bf16.f32) is exact in
//     its products and differs from an fp32 dot in the order of the sums;
//   - an fp32 operand (p, ds, an fp32 do) is written as a sum of bf16 terms,
//     x = t0 + t1 + t2 with t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x -
//     t0 - t1) (exact for normal fp32: three 8-bit significands cover 24),
//     and the product takes one mma per term (per pair of terms where both
//     operands are split, keeping those with i + j < 3).
//
// m16n8k16 fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"): lane =
// 4 g + t (g = lane / 4, t = lane % 4).
//   A 16x16 (row major), 4 registers of 2 bf16: a[0] = (g, 2t..2t+1),
//     a[1] = (g+8, 2t..), a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..);
//   B 16x8, 2 registers: b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g);
//   C 16x8 fp32: c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).
// The C fragments of two adjacent 8-column tiles therefore hold, lane by
// lane, the A fragment of the 16x16 tile they form: a score tile computed by
// one mma feeds the next mma's A side from registers, with no trip through
// shared memory (c_to_a_split).
//
// Shared tiles are row major with rows padded by 16 bytes (LD = cols + 8
// bf16), so the eight 16-byte rows one ldmatrix phase reads fall in eight
// different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_mma {

constexpr unsigned FULL_MASK = 0xffffffffu;

// The (input type, head dim) pairs whose kernels run on the tensor cores:
// bf16 at D = 32, 64 and 128 (every preset's head dim). A source picks its
// tensor-core or CUDA-core kernel from this at compile time.
template <typename T, int D>
struct TensorCore {
  static constexpr bool value = false;
};
template <>
struct TensorCore<__nv_bfloat16, 32> {
  static constexpr bool value = true;
};
template <>
struct TensorCore<__nv_bfloat16, 64> {
  static constexpr bool value = true;
};
template <>
struct TensorCore<__nv_bfloat16, 128> {
  static constexpr bool value = true;
};

// Padded row of a shared bf16 tile with `cols` columns, in elements.
__host__ __device__ constexpr int padded(int cols) { return cols + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- ldmatrix ------------------------------------------------------------------
//
// x4 loads four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i in fragment order. Lane offsets
// (row, col) inside a 16x16 tile at which each lane points:
//   lane_a: an A fragment of a row-major [m][k] tile, or (with .trans) the B
//           fragments of the two 8-column n-tiles of a row-major [k][n] tile:
//           r[0..1] for n 0..7, r[2..3] for n 8..15;
//   lane_b: the B fragments of two n-tiles of a row-major [n][k] tile (a
//           K^T operand): r[0..1] for n 0..7, r[2..3] for n 8..15.
struct LaneOffsets {
  int row_a, col_a, row_b, col_b;
  __device__ __forceinline__ explicit LaneOffsets(int lane)
      : row_a(lane % 16),
        col_a((lane / 16) * 8),
        row_b(lane % 8 + (lane / 16) * 8),
        col_b(((lane / 8) % 2) * 8) {}
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// -- mma -----------------------------------------------------------------------

// c += a * b on one 16x8x16 tile, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += t in fp32 on the CUDA cores, rounded to nearest. The tensor cores'
// fp32 accumulation is not: an mma truncates its result toward zero and
// drops the bits of each addend (C included) below 2^-25 of the largest one
// (one mma on crafted tiles shows both on an H100), so the error of a long
// sum that runs inside the tensor cores grows with every mma. So a long sum
// runs its mma over a short stretch (a 16-wide k step or a few, with their
// split terms) into a zeroed tile t, whose own dropped bits are small beside
// it, and adds t to the long-lived accumulator here.
__device__ __forceinline__ void add_tile(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// c0 += a * (n-tile 0 of b), c1 += a * (n-tile 1 of b), b from one x4 load.
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// -- the bf16 split ------------------------------------------------------------

// The N leading bf16 terms of (x, y), packed as bf16x2 (x in the low half):
// t[0] = bf16(x), t[1] = bf16(x - t[0]), ...; each residual is exact in fp32.
template <int N>
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[i] = bits(h);
    if (i + 1 < N) {
      const float2 f = __bfloat1622float2(h);
      x -= f.x;
      y -= f.y;
    }
  }
}

// The A fragments (one per term) of the 16x16 tile held by the C fragments
// c0 (columns 0..7) and c1 (columns 8..15).
template <int N>
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&a)[N][4]) {
  uint32_t t[4][N];
  split_bf16x2<N>(c0[0], c0[1], t[0]);
  split_bf16x2<N>(c0[2], c0[3], t[1]);
  split_bf16x2<N>(c1[0], c1[1], t[2]);
  split_bf16x2<N>(c1[2], c1[3], t[3]);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = t[r][i];
}

// Four fp32 values (a float4 at element `off` of a tile) into the 3 bf16
// planes of a shared tile, planes `stride` elements apart; nz[0] and nz[1]
// note a nonzero in plane 1 and plane 2 (sign bits ignored).
__device__ __forceinline__ void split_to_planes(float4 x, __nv_bfloat16* planes, int stride,
                                                int off, bool (&nz)[2]) {
  uint32_t t01[3], t23[3];
  split_bf16x2<3>(x.x, x.y, t01);
  split_bf16x2<3>(x.z, x.w, t23);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint2*>(planes + p * stride + off) = make_uint2(t01[p], t23[p]);
  nz[0] |= ((t01[1] | t23[1]) & 0x7fff7fffu) != 0;
  nz[1] |= ((t01[2] | t23[2]) & 0x7fff7fffu) != 0;
}

// How many leading planes hold anything over the whole block, from every
// thread's split_to_planes flags; a barrier (every thread must call it),
// after which the planes are visible to the block.
__device__ __forceinline__ int live_planes(const bool (&nz)[2]) {
  return __syncthreads_or(nz[1]) ? 3 : (__syncthreads_or(nz[0]) ? 2 : 1);
}

// -- row reductions over the 4 lanes (one quad) that share a fragment row ------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// -- cp.async: the ring of tiles -----------------------------------------------
//
// A kernel keeps STAGES buffers of each streamed tile; step j reads buffer
// j % STAGES while the copies of step j + 1 fill the next one. Per step:
// cp_async_wait<0>() and __syncthreads() (step j's tile has landed for every
// thread and every warp is done with the buffer about to be refilled), then
// the copies of step j + 1 and cp_async_commit(), then step j's math.

// 16 bytes global -> shared; zero-filled (no read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled (no read) when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a row-major [n_rows, COLS] matrix of T into a
// shared tile of rows of LD elements, 16 bytes a copy over THREADS threads;
// rows past n_rows are zero. COLS * sizeof(T) and LD * sizeof(T) are
// multiples of 16, and src is 16-byte aligned.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* __restrict__ src, int row0,
                                              int n_rows) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int CHUNKS = COLS / PER;                      // copies a row
  constexpr int COPIES = ROWS * CHUNKS;
  static_assert(COLS % PER == 0 && LD % PER == 0, "rows must be whole 16-byte chunks");
#pragma unroll
  for (int it = 0; it < (COPIES + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + static_cast<int>(threadIdx.x);
    if (COPIES % THREADS != 0 && i >= COPIES) break;
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * PER;
    const int g = row0 + r;
    const bool valid = g < n_rows;
    cp_async16(dst + r * LD + c, src + static_cast<size_t>(valid ? g : 0) * COLS + c, valid);
  }
}

}  // namespace attn_mma
