// Flash-attention forward for Hopper (sm_90a), head dim 64.
//
// Replaces the TPU kernel vista_slam_tpu/ops/pallas/flash.py:_attn_kernel
// (launched by _fwd_impl). Same function: per (batch*head, query row)
//   S   = Q K^T * scale                  fp32
//   S[:, key >= nk] = -inf
//   out = (exp(S - max) rounded to the input dtype) V / rowsum   in q's dtype
//   lse = max + log(rowsum)                                      fp32 [BH, Nq]
//
// What bounds it on the card, and what the design does about it:
// The TPU kernel keeps one head's whole K and V resident in VMEM and scores
// a 256-row query block against all keys in one pass. A Hopper block has at
// most 227 KB of shared memory and far fewer registers than VMEM, so this
// kernel tiles over keys with an online softmax instead: one block per
// (batch*head, 64-row query tile) walks 64-key tiles of K and V held in
// shared memory, carrying the running row max, row sum and the fp32 output
// accumulator across tiles. At the path's shapes (N = 768/769, D = 64) one
// head does 4*N*N*D flops on 8*N*D bytes of bf16 Q/K/V/O, about N/2 flops per
// byte, so the kernel is bound by tensor-core work, not by device memory.
// This first version issues the two products with WMMA (mma.sync bf16
// fragments, fp32 accumulation) and passes S, P and the accumulator through
// shared memory between them; the shared-memory round trips and the
// __syncthreads per key tile are what bound it now. wgmma, TMA and warp
// specialisation are later work. The fp32 variant (tests and parity checks)
// uses plain FMA, one query row per thread, because the tensor cores' fp32
// path (TF32) would not hold fp32 accuracy.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int D = 64;

// ---- bf16: WMMA tiles ------------------------------------------------------
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int WARPS = BQ / 16;         // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
// shared-memory row strides, padded past the 128-byte bank period so that
// the rows a warp touches at once fall in different banks (WMMA needs the
// strides to stay multiples of 16 bytes)
constexpr int QKV_LD = D + 8;          // bf16
constexpr int S_LD = BK + 4;           // fp32
constexpr int P_LD = BK + 8;           // bf16
constexpr int O_LD = D + 4;            // fp32
constexpr int SMEM_BF16 = BQ * QKV_LD * 2   // Q
                        + BK * QKV_LD * 2   // K
                        + BK * QKV_LD * 2   // V
                        + BQ * S_LD * 4     // S (fp32 scores)
                        + BQ * P_LD * 2     // P (probabilities, bf16)
                        + BQ * O_LD * 4;    // O (fp32 accumulator)

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
    *reinterpret_cast<uint4*>(dst + r * QKV_LD + col) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int nq, int nk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * QKV_LD;
  __nv_bfloat16* Vs = Ks + BK * QKV_LD;
  float* Ss = reinterpret_cast<float*>(Vs + BK * QKV_LD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BQ * S_LD);
  float* Os = reinterpret_cast<float*>(Ps + BQ * P_LD);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + (size_t)bh * nq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // the warp's first row in the tile
  // softmax work split: two lanes per row, interleaved columns half + 2c
  const int r = wrow + lane / 2;
  const int half = lane % 2;

  load_tile_bf16(Qs, qb, q0, BQ, nq);
  for (int i = threadIdx.x; i < BQ * O_LD; i += THREADS) Os[i] = 0.f;

  float m = -INFINITY;  // running row max (both lanes of a row hold it)
  float l = 0.f;        // running row sum

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile_bf16(Ks, kb, k0, BK, nk);
    load_tile_bf16(Vs, vb, k0, BK, nk);
    __syncthreads();

    // S_w = Q_w K^T (16 x BK per warp)
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + wrow * QKV_LD + d * 16, QKV_LD);
        wmma::load_matrix_sync(b, Ks + j * 16 * QKV_LD + d * 16, QKV_LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + wrow * S_LD + j * 16, acc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's rows
    const float* srow = Ss + r * S_LD + half;
    const int valid = nk - k0 - half;  // column half + 2c is a real key iff 2c < valid
    float s[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      s[c] = 2 * c < valid ? srow[2 * c] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    // every tile holds at least one real key, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float tsum = 0.f;
    __nv_bfloat16* prow = Ps + r * P_LD + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(s[c] - m_new);
      tsum += p;
      prow[2 * c] = __float2bfloat16(p);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * alpha + tsum;
    m = m_new;
    float* orow = Os + r * O_LD + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) orow[2 * c] *= alpha;
    __syncwarp();

    // O_w += P_w V (16 x D per warp)
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + wrow * O_LD + j * 16, O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + wrow * P_LD + kk * 16, P_LD);
        wmma::load_matrix_sync(b, Vs + kk * 16 * QKV_LD + j * 16, QKV_LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + wrow * O_LD + j * 16, acc, O_LD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q0 + r < nq) {
    const float* orow = Os + r * O_LD + half;
    __nv_bfloat16* dst = out + ((size_t)bh * nq + q0 + r) * D + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[2 * c] = __float2bfloat16(orow[2 * c] / l);
    if (half == 0) lse[(size_t)bh * nq + q0 + r] = m + logf(l);
  }
}

// ---- fp32: plain FMA, one query row per thread ----------------------------
constexpr int F_BQ = 64;
constexpr int F_BK = 32;

__global__ void __launch_bounds__(F_BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int nq, int nk, float scale) {
  __shared__ float Ks[F_BK * D];
  __shared__ float Vs[F_BK * D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * F_BQ + threadIdx.x;
  const bool live = row < nq;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  float qr[D];
  float o[D];
  const float* qrow = q + ((size_t)bh * nq + (live ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qrow[d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < nk; k0 += F_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += F_BQ) {
      const int kr = k0 + i / D;
      Ks[i] = kr < nk ? kb[(size_t)kr * D + i % D] : 0.f;
      Vs[i] = kr < nk ? vb[(size_t)kr * D + i % D] : 0.f;
    }
    __syncthreads();

    float s[F_BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], Ks[j * D + d], acc);
      s[j] = k0 + j < nk ? acc * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
    float tsum = 0.f;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      const float p = expf(s[j] - m_new);
      tsum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(p, Vs[j * D + d], o[d]);
    }
    l = l * alpha + tsum;
    m = m_new;
  }

  if (live) {
    float* dst = out + ((size_t)bh * nq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = o[d] / l;
    lse[(size_t)bh * nq + row] = m + logf(l);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [bh, nq, 64], k/v [bh, nk, 64],
// out like q, lse [bh, nq] fp32; all contiguous on the current device.
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* out, float* lse, int bh,
                              int nq, int nk, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || nq < 1 || nk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (err != cudaSuccess) return err;
    dim3 grid((nq + BQ - 1) / BQ, bh);
    flash_fwd_bf16<<<grid, THREADS, SMEM_BF16, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        lse, nq, nk, scale);
  } else if (dtype == 0) {
    dim3 grid((nq + F_BQ - 1) / F_BQ, bh);
    flash_fwd_f32<<<grid, F_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, nq, nk,
        scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
