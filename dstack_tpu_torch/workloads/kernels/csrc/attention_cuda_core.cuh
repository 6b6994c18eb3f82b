// CUDA-core tile helpers of the attention kernels for Hopper (sm_90a): the
// fp32 (and bf16-input) kernels of flash_attention.cu and splash_attention.cu
// that run where the tensor-core kernels do not (fp32 inputs, head dims other
// than 32, 64 and 128, and splash dq).
//
// Their design: a block is 256 threads, a 16 x 16 grid (ty, tx), over a
// TILE x TILE tile of scores. Thread (ty, tx) owns rows ty*R .. ty*R+R-1
// (R = TILE/16) and columns tx, tx+16, ..: the 16 threads of a row are one
// half of a warp, so a row's max and sum are 4 shuffles. Tiles sit in shared
// memory row-major with a padded row (an odd number of 32-bit words), so the
// 16 threads of a half-warp that read one column read 16 banks. Products and
// sums are fp32 FMAs. Each source keeps its own tile geometry (Geo), since
// the shared memory its kernels take differs.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_cc {

constexpr int THREADS = 256;  // 16 x 16

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
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
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
// tile, V a shared tile whose rows past the valid ones are zero. With
// LAST_FIRST the columns run from c = TILE - 1 down to 0 (the dk/dv kernels'
// far-to-near walk: the small terms meet the fp32 sums first).
template <int R, int NJ, int TILE, bool LAST_FIRST = false, typename TV>
__device__ __forceinline__ void add_pv(float (&out)[R][NJ], const float* P, int ldp,
                                       const TV* V, int ldv, int ty, int tx) {
#pragma unroll 2
  for (int cc = 0; cc < TILE; ++cc) {
    const int c = LAST_FIRST ? TILE - 1 - cc : cc;
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

}  // namespace attn_cc
