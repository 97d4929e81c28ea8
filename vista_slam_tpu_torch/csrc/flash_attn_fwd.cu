// Flash-attention forward for Hopper (sm_90a), head dim 64: kernel K1.
//
// Replaces the TPU kernel vista_slam_tpu/ops/pallas/flash.py:_attn_kernel
// (launched at flash.py:115 by _fwd_impl). Same function: per (batch*head,
// query row)
//   S   = Q K^T * scale                  fp32
//   S[:, key >= nk] = -inf
//   out = (exp(S - max) rounded to the input dtype) V / rowsum   in q's dtype
//   lse = max + log(rowsum)                     fp32 [BH, Nq], natural log
//
// What bounds it on the card. One head at Nq = Nk = N, D = 64 does 4 N^2 D
// flops of products on 8 N D bytes of bf16 Q, K, V and O: N / 2 flops per
// byte, above the H100's ~295 once N > 590, so the products bound it, not
// device memory (at q [16,12,769,64]: 29.1 GFLOP, 0.0294 ms at 989
// TFLOP/s, against 75.6 MB, 0.0226 ms at 3.35 TB/s). The softmax is a
// second ceiling as high: N^2 exponentials per head (1.1e8 at that shape)
// at 16 per clock per SM take about as long as the products at D = 64, so
// a warpgroup that runs its softmax between its two products cannot beat
// twice the bound alone; other warpgroups on the SM fill the gaps.
//
// What the design does:
// - One block is one warpgroup (4 warps) and owns 64 query rows; at 93
//   registers a thread and 41 KB of shared memory, five blocks share an
//   SM, so while one warpgroup runs its softmax others keep the tensor
//   cores busy. 64-row blocks fill the card at every shape of the paths
//   (192 blocks for the SLAM encoder's q [1,16,768,64] on 132 SMs).
// - S = Q K^T by wgmma.m64n64k16 with Q and K in shared memory (both
//   K-major, as stored). The scores come out in accumulator registers; the
//   scores are scaled by scale log2(e) in place, the row max is taken by
//   quad shuffles and P = exp2(S - m) by one ex2.approx per score, in
//   registers, so any scale works, as in the TPU kernel. The accumulator
//   layout of two n8 column tiles is the A-fragment layout of a k16 step,
//   so P, rounded to bf16, is the register A operand of O += P V
//   (wgmma.m64n64k16, V from shared memory with the transpose bit: V is
//   MN-major as stored). O is an fp32 register accumulator rescaled in
//   place. Only bf16 Q, K and V pass through shared memory.
// - 64-key K and V tiles are copied by cp.async into two stages each, one
//   tile ahead of the products, laid out with the 128-byte XOR swizzle
//   that the wgmma descriptors read (no bank conflicts on either side);
//   one __syncthreads per key tile.
// - Only the last key tile (nk % 64 != 0) applies the -inf mask; only the
//   store of the last query tile is guarded. At nk = 769 the last tile
//   holds one key, and its full-width products and exponentials are 1/13
//   of the work: kept, for one loop body.
// - Epilogue: O / l in registers, staged through the Q tile's shared
//   memory and written with 16-byte coalesced stores; lse = (m + log2 l)
//   ln 2, in natural log (m is kept in the log2 domain).
// The fp32 variant (tests and parity checks) uses plain FMA, one query row
// per thread, because the tensor cores' fp32 path (TF32) would not hold
// fp32 accuracy.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the cudaError_t of the launch.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

// ---- bf16: wgmma, scores and output in registers ---------------------------
// Q, two K and two V tiles, and slack to align them to 1024 bytes
constexpr int SMEM_BF16 = 5 * TILE_BYTES + 1024;

// One warpgroup's online softmax over a 64-key tile of raw scores s: scales
// them by scale log2(e) in place, updates the row max m (of the scaled
// scores), this thread's part of the row sum l, rescales o, and leaves
// P = exp2(s - m) as bf16 pairs in p, in the A-fragment order of the PV
// steps (the accumulator layout of hopper_tiles.cuh). valid < 64 masks
// keys >= valid.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&o)[32], uint32_t (&p)[16],
                                             float scale_log2, int valid) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
  if (valid < TILE) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * i + 2 * t + e >= valid) s[4 * i + e] = s[4 * i + 2 + e] = -INFINITY;
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds a real key, so mx is finite; alpha is 0 on tile 0
  const float alpha0 = ex2(m[0] - mx0);
  const float alpha1 = ex2(m[1] - mx1);
  m[0] = mx0;
  m[1] = mx1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p0 = ex2(s[4 * i] - mx0);
    const float p1 = ex2(s[4 * i + 1] - mx0);
    const float p2 = ex2(s[4 * i + 2] - mx1);
    const float p3 = ex2(s[4 * i + 3] - mx1);
    ls0 += p0 + p1;
    ls1 += p2 + p3;
    p[2 * i] = pack_bf16(p0, p1);
    p[2 * i + 1] = pack_bf16(p2, p3);
  }
  l[0] = l[0] * alpha0 + ls0;
  l[1] = l[1] * alpha1 + ls1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[4 * i] *= alpha0;
    o[4 * i + 1] *= alpha0;
    o[4 * i + 2] *= alpha1;
    o[4 * i + 3] *= alpha1;
  }
}

// S = Q K^T into s, started and committed, not waited for; a k16 step is 32
// bytes further along the swizzled rows
__device__ __forceinline__ void start_scores(float (&s)[32], uint64_t dq, uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
}

// O += P V, started and committed; key step kk is 16 rows (2048 bytes)
// further into the V tile
__device__ __forceinline__ void start_pv(float (&o)[32], const uint32_t (&p)[16],
                                         uint64_t dv) {
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             dv + kk * (2048 >> 4));
  wgmma_commit();
}

// One block is one warpgroup and owns 64 query rows. Shared memory: the Q
// tile, two K stages and two V stages; K and V are copied one tile ahead of
// the products. The warpgroup scores tile j, runs its softmax, then
// multiplies; other blocks on the SM fill the tensor cores meanwhile. One
// __syncthreads per key tile.
__global__ void __launch_bounds__(WG_THREADS, 5)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int nq, int nk, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q, then the output tile
  const uint32_t sk = sq + TILE_BYTES;          // K stages 0, 1
  const uint32_t sv = sk + 2 * TILE_BYTES;      // V stages 0, 1
  unsigned char* const sq_ptr = smem_raw + (sq - raw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const __nv_bfloat16* qb = q + (size_t)bh * nq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * D;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int ntiles = (nk + TILE - 1) / TILE;

  auto kstage = [&](int j) { return sk + (j & 1) * TILE_BYTES; };
  auto vstage = [&](int j) { return sv + (j & 1) * TILE_BYTES; };
  auto copy_k = [&](int j) {
    if (j < ntiles) copy_tile(kstage(j), kb, j * TILE, nk);
  };
  auto copy_v = [&](int j) {
    if (j < ntiles) copy_tile(vstage(j), vb, j * TILE, nk);
  };

  copy_tile(sq, qb, q0, nq);
  copy_k(0);
  copy_v(0);
  cp_async_commit();

  const uint64_t dq = desc128(sq, 16);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled row scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  uint32_t p[16];
  float s[32];

  for (int j = 0; j < ntiles; ++j) {
    // K and V tile j have landed, and the products of tile j - 1 are done:
    // stage j + 1 of K and V is free
    cp_async_wait<0>();
    __syncthreads();
    copy_k(j + 1);
    copy_v(j + 1);
    cp_async_commit();
    start_scores(s, dq, desc128(kstage(j), 16));
    wgmma_wait<0>();
    reg_fence(s);
    softmax_tile(s, m, l, o, p, scale_log2, nk - j * TILE);
    start_pv(o, p, desc128(vstage(j), 1024));
    wgmma_wait<0>();
    reg_fence(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // no product reads the Q tile any more
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint32_t*>(sq_ptr + swz(r0, i) + 4 * t) =
        pack_bf16(o[4 * i] / l[0], o[4 * i + 1] / l[0]);
    *reinterpret_cast<uint32_t*>(sq_ptr + swz(r0 + 8, i) + 4 * t) =
        pack_bf16(o[4 * i + 2] / l[1], o[4 * i + 3] / l[1]);
  }
  // lse = (m + log2 l) ln 2, in natural log as the plain version
  const int row = q0 + r0;
  if (t == 0 && row < nq) lse[(size_t)bh * nq + row] = (m[0] + log2f(l[0])) * LN2;
  if (t == 0 && row + 8 < nq) lse[(size_t)bh * nq + row + 8] = (m[1] + log2f(l[1])) * LN2;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE * 8 / WG_THREADS; ++i) {
    const int c = threadIdx.x + i * WG_THREADS;
    const int r = c >> 3, ch = c & 7;
    if (q0 + r < nq) {
      *reinterpret_cast<uint4*>(out + ((size_t)bh * nq + q0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(sq_ptr + swz(r, ch));
    }
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
// out like q, lse [bh, nq] fp32; all contiguous, 16-byte aligned, on the
// current device.
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* out, float* lse, int bh,
                              int nq, int nk, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || nq < 1 || nk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (err != cudaSuccess) return err;
    dim3 grid((nq + TILE - 1) / TILE, bh);
    flash_fwd_bf16<<<grid, WG_THREADS, SMEM_BF16, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
        nq, nk, scale * LOG2E);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    dim3 grid((nq + F_BQ - 1) / F_BQ, bh);
    flash_fwd_f32<<<grid, F_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, nq, nk,
        scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
