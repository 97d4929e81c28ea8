// WMMA tile helpers shared by the bf16 attention kernels K2a/K2b
// (flash_attn_bwd.cu) and K3a/K3b (attn_train.cu), head dim 64.
//
// A block of 4 warps works on 64-row tiles in shared memory; each warp owns
// 16 rows. Row strides are padded past the 128-byte bank period (K1's
// 3.4x) and kept multiples of 16 bytes, as WMMA needs. Products are WMMA
// (mma.sync bf16 fragments, fp32 accumulation). Included by one .cu file
// each: everything here has internal linkage. kernels/build.py hashes this
// header into every library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int D = 64;
constexpr int DH = D / 2;              // fp32 variants: dims per thread of a pair
constexpr int BR = 64;                 // rows a block owns (queries or keys)
constexpr int BC = 64;                 // rows of the other side per tile
constexpr int WARPS = BR / 16;         // each warp owns 16 rows
constexpr int THREADS = WARPS * 32;
constexpr int LD = D + 8;              // bf16 operand tiles
constexpr int S_LD = BC + 4;           // fp32 score tiles
constexpr int P_LD = BC + 8;           // bf16 probability / dS tiles
constexpr int TILE_BF16 = BR * LD * 2;
constexpr int TILE_F32 = BR * S_LD * 4;
constexpr int TILE_P = BR * P_LD * 2;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [row0, row0 + rows) of a row-major [n, D] bf16 matrix -> shared
// memory, 16 bytes per thread and step; rows past n are zero-filled
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int rows, int n) {
  constexpr int CHUNKS_PER_ROW = D / 8;
  for (int c = threadIdx.x; c < rows * CHUNKS_PER_ROW; c += blockDim.x) {
    const int r = c / CHUNKS_PER_ROW;
    const int col = (c % CHUNKS_PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// C_w (16 x BC, fp32, shared) = A_w (16 rows of a) . B^T, B = BC rows of b
__device__ __forceinline__ void warp_abt(float* c, const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < BC / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + d * 16, LD);
      wmma::load_matrix_sync(fb, b + j * 16 * LD + d * 16, LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, S_LD, wmma::mem_row_major);
  }
}

// acc[j] (16 x D in four fragments) += A_w (16 x BC, row stride P_LD) . B
// (BC x D rows of b, row stride LD)
__device__ __forceinline__ void warp_ab_acc(FragC (&acc)[D / 16],
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      FragA fa;
      FragBr fb;
      wmma::load_matrix_sync(fa, a + kk * 16, P_LD);
      wmma::load_matrix_sync(fb, b + kk * 16 * LD + j * 16, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// the warp's 16 x D accumulator -> scaled bf16 rows of dst (row-major
// [n, D]) for rows row0 + wrow + r < n; `stage` is the warp's 16-row slice
// of an fp32 shared tile
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* stage,
                                           __nv_bfloat16* dst, int row0,
                                           int wrow, int n, float mul) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage + j * 16, acc[j], S_LD, wmma::mem_row_major);
  }
  __syncwarp();
  const int lane = threadIdx.x % 32;
  const int r = lane / 2;
  const int half = lane % 2;
  if (row0 + wrow + r < n) {
    const float* src = stage + r * S_LD + half;
    __nv_bfloat16* out = dst + (size_t)(row0 + wrow + r) * D + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) out[2 * c] = __float2bfloat16(__fmul_rn(src[2 * c], mul));
  }
  __syncwarp();
}

// the sum of x over a pair of neighbouring lanes
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

}  // namespace
