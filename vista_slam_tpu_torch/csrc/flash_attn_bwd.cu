// Flash-attention backward for Hopper (sm_90a), head dim 64: kernels K2a
// (delta and dq) and K2b (dk, dv).
//
// Replace the TPU kernels vista_slam_tpu/ops/pallas/flash.py:_bwd_dq_kernel
// and :_bwd_dkv_kernel (launched by _flash_bwd, which forms delta at
// flash.py:221). Same function, per (batch*head), with lse from the forward
// (K1), for any scale (negative and 0 included):
//   delta = rowsum(dO * O)                              fp32 (K2a, written out)
//   S  = Q K^T * scale (fp32), keys >= nk masked;       P = exp(S - lse)
//   dP = dO V^T (fp32);                                  dS = P * (dP - delta)
//   dQ = (dS rounded to K's dtype) K * scale             (K2a)
//   dV = (P rounded to dO's dtype)^T dO                  (K2b)
//   dK = (dS rounded to Q's dtype)^T Q * scale           (K2b)
// with fp32 accumulation and the scale applied after it, as the TPU kernels
// round. Query rows >= nq contribute nothing (masked here; the TPU kernel
// relies on zero-padded dO and delta).
//
// What bounds them on the card. Per head at Nq = Nk = N the two kernels do
// 6 + 8 = 14 N^2 D flops of products (K2b recomputes S and dP) on ~24 N D
// bytes of bf16 inputs and outputs: 0.6 N flops per byte, above the H100's
// ~295 at the path's N = 768/769, so the tensor cores bound them, not device
// memory (at q [12,12,769,64]: 0.0331 ms for K2a and 0.0441 for K2b at 989
// TFLOP/s). The N^2 exponentials per head in each kernel take about as long
// as two products at D = 64 (K1's header), less than the three or four here.
//
// What the design does (the structure of K1 and K3b, hopper_tiles.cuh):
// - Every bf16 product is a wgmma.mma_async (m64n64k16, m64n16k16 for the
//   16-wide tails) from 128-byte-swizzled tiles, with fp32 accumulators in
//   registers: S, dP, P and dS never touch shared memory. Their
//   accumulator layout is the register A-fragment layout of the next
//   product, so P and dS are packed to bf16 in place and multiplied from
//   registers, the B operand (K, dO or Q) read MN-major through the
//   transpose bit, as K1's PV product reads V.
// - One block is one warpgroup and owns 64 rows (queries in K2a, keys in
//   K2b): the other side's tiles are copied by cp.async into two stages
//   each, one tile ahead of the products, with one __syncthreads per tile.
//   Several blocks share an SM and fill the tensor cores while one runs
//   its exponentials (as in K1, where that beat pipelining inside a
//   block): K2a at 126 registers and 49 KB of shared memory runs four
//   blocks an SM; K2b is held to 168 registers (launch bounds) so that
//   three fit, with no spills.
// - K2a (one block per (batch*head, 64 query rows)): Q and dO are copied
//   once; the prologue reads the block's 64 rows of O and dO, forms delta
//   in fp32 (each thread 16 columns of its two rows, a quad shuffle), keeps
//   it in registers and writes it to the [BH, Nq] buffer K2b reads. For each
//   64-key tile of K and V: S = Q K^T and dP = dO V^T by wgmma into
//   registers; P = exp2(S scale log2(e) - lse log2(e)) in place (one
//   ex2.approx a score); dS = P (dP - delta), packed to bf16; dQ += dS K.
//   dQ stays in registers across the walk, is scaled once and written
//   through the Q tile's shared memory with 16-byte stores.
// - K2b (one block per (batch*head, 64 keys)), transposed so that P and dS
//   come out with keys as rows and feed dV and dK as A operands: K and V
//   stay resident; Q, dO and the tile's 64 values of lse and delta (4-byte
//   cp.async: rows of [BH, Nq] start on no 16-byte boundary when Nq % 4 !=
//   0) are streamed. For each query tile: S^T = K Q^T and dP^T = V dO^T by
//   wgmma; P^T with lse per column from shared memory, columns >= nq set to
//   0; dS^T = P^T (dP^T - delta_col); dV += bf16(P^T) dO and dK += bf16(dS^T)
//   Q. dK and dV stay in registers (64 a thread together) and are written
//   once, as in K2a.
// - Tails: at nk = 769 (K2a) or nq = 769 (K2b) the last tile holds one
//   token. A last tile of at most 16 real tokens is scored m64n16 and
//   multiplied in one k16 step, a quarter of a full tile's work, as K3 does
//   at 197 tokens. Key rows past nk in K2b and query rows past nq in K2a
//   are zero-filled and reach only rows that are never stored.
// - Every output tile is written by one block: no atomics, and two calls
//   are bit-identical. One fused kernel per key tile would save K2a's
//   recomputed S and dP (10 instead of 14 N^2 D flops) but must sum dQ
//   across key tiles, on chip or in a fixed order; not done here.
// The fp32 variants (parity checks and the fp32 tests) use plain FMA with
// two threads per row, because the tensor cores' fp32 path (TF32) would not
// hold fp32 accuracy; K2a's forms delta in its prologue too.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// caller's stream and returns the cudaError_t of the launch.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

// ---- bf16: wgmma, every score in registers ----------------------------------
// K2a: Q, dO, two K and two V stages, and slack to align them to 1024 bytes
constexpr int SMEM_DQ = 6 * TILE_BYTES + 1024;
// K2b: K, V, two Q and two dO stages, two stages of lse and delta (64 fp32
// each), slack
constexpr int STATS_BYTES = 2 * TILE * 4;
constexpr int SMEM_DKV = 6 * TILE_BYTES + 2 * STATS_BYTES + 1024;

// 4 bytes global -> shared, asynchronously; src-size 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// sum of x over the quad of lanes that share a row of the accumulator
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the dot product, in fp32, of two 16-byte chunks of 8 bf16 each
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// K2a's work on one key tile: dQ += dS K. KN: keys scored, 64, or 16 for a
// last tile of at most 16 real keys; valid: real keys of the tile. lse2 and
// dl: this thread's two rows' lse log2(e) and delta.
template <int KN>
__device__ __forceinline__ void dq_tile(float (&acc)[32], uint64_t dq_desc, uint64_t ddo_desc,
                                        uint32_t sk, uint32_t sv, const float (&lse2)[2],
                                        const float (&dl)[2], float scale_log2, int valid) {
  const int t = threadIdx.x % 4;
  float s[KN / 2], dp[KN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, dq_desc + 2 * kk, desc128(sk, 16) + 2 * kk, kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(dp, ddo_desc + 2 * kk, desc128(sv, 16) + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait<1>();  // S is in; dP may still be running
  reg_fence(s);
  // P = exp2(S scale log2(e) - lse log2(e)), 0 at keys past the tile's real ones
#pragma unroll
  for (int i = 0; i < KN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = 8 * i + 2 * t + e < valid;
      s[4 * i + e] = in ? ex2(fmaf(s[4 * i + e], scale_log2, -lse2[0])) : 0.f;
      s[4 * i + 2 + e] = in ? ex2(fmaf(s[4 * i + 2 + e], scale_log2, -lse2[1])) : 0.f;
    }
  }
  wgmma_wait<0>();  // dP is in
  reg_fence(dp);
  // dS = P (dP - delta), rounded to bf16: the A operand of dQ += dS K
  uint32_t ds[KN / 4];
#pragma unroll
  for (int i = 0; i < KN / 8; ++i) {
    ds[2 * i] = pack_bf16(s[4 * i] * (dp[4 * i] - dl[0]), s[4 * i + 1] * (dp[4 * i + 1] - dl[0]));
    ds[2 * i + 1] =
        pack_bf16(s[4 * i + 2] * (dp[4 * i + 2] - dl[1]), s[4 * i + 3] * (dp[4 * i + 3] - dl[1]));
  }
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk)  // key step kk: 16 rows (2048 bytes) into K
    wgmma_rs(acc, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
             desc128(sk, 1024) + kk * (2048 >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
}

// K2a: one block per (batch*head, 64 query rows); delta [bh, nq] is written
__global__ void __launch_bounds__(WG_THREADS, 4)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int nq, int nk, float scale,
                  float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q, then the dQ staging tile
  const uint32_t sdo = sq + TILE_BYTES;         // dO
  const uint32_t sk = sdo + TILE_BYTES;         // K stages 0, 1
  const uint32_t sv = sk + 2 * TILE_BYTES;      // V stages 0, 1

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const size_t qbase = (size_t)bh * nq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * D;
  const int tid = threadIdx.x;
  const int t = tid % 4;
  const int r0 = tid / 32 * 16 + (tid % 32) / 4;  // this thread's rows: r0, r0 + 8
  const int ntiles = (nk + TILE - 1) / TILE;
  const int last_valid = nk - (ntiles - 1) * TILE;  // real keys of the last tile

  auto copy_kv = [&](int j) {
    if (j < ntiles) {
      copy_tile(sk + (j & 1) * TILE_BYTES, kb, j * TILE, nk);
      copy_tile(sv + (j & 1) * TILE_BYTES, vb, j * TILE, nk);
    }
  };
  copy_tile(sq, q + qbase, q0, nq);
  copy_tile(sdo, dout + qbase, q0, nq);
  copy_kv(0);
  cp_async_commit();

  // delta = rowsum(dO * O) in fp32 for rows r0, r0 + 8: this thread's 16
  // columns (chunks 2t, 2t + 1), summed over the quad; while the copies fly
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    float part = 0.f;
    if (row < nq) {
      const uint4* o4 = reinterpret_cast<const uint4*>(out + qbase + (size_t)row * D) + 2 * t;
      const uint4* d4 = reinterpret_cast<const uint4*>(dout + qbase + (size_t)row * D) + 2 * t;
      part = dot8(__ldg(d4), __ldg(o4)) + dot8(__ldg(d4 + 1), __ldg(o4 + 1));
    }
    dl[h] = quad_sum(part);
    // rows past nq: Q and dO are zero-filled, so S = dP = 0, and with lse =
    // delta = 0 their dS is exactly 0
    lse2[h] = row < nq ? lse[(size_t)bh * nq + row] * LOG2E : 0.f;
    if (t == 0 && row < nq) delta[(size_t)bh * nq + row] = dl[h];
  }

  const uint64_t dq_desc = desc128(sq, 16), ddo_desc = desc128(sdo, 16);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    // K and V tile j have landed, and tile j - 1's products are done: its
    // stage is free for tile j + 1
    cp_async_wait<0>();
    __syncthreads();
    copy_kv(j + 1);
    cp_async_commit();
    const uint32_t skj = sk + (j & 1) * TILE_BYTES, svj = sv + (j & 1) * TILE_BYTES;
    if (j == ntiles - 1 && last_valid <= 16)
      dq_tile<16>(acc, dq_desc, ddo_desc, skj, svj, lse2, dl, scale_log2, last_valid);
    else
      dq_tile<TILE>(acc, dq_desc, ddo_desc, skj, svj, lse2, dl, scale_log2, nk - j * TILE);
  }

  __syncthreads();  // no product reads the Q tile any more
  store_acc(acc, scale, smem_raw + (sq - raw), dq + qbase, q0, nq, tid, 1);
}

// K2b's work on one query tile: dV += P^T dO, dK += dS^T Q. QN: queries
// scored, 64, or 16 for a last tile of at most 16 real queries; valid: real
// queries of the tile; lse_s, dl_s: the tile's 64 values of lse and delta.
template <int QN>
__device__ __forceinline__ void dkv_tile(float (&dk)[32], float (&dv)[32], uint32_t sk,
                                         uint32_t sv, uint32_t sq, uint32_t sdo,
                                         const float2* lse_s, const float2* dl_s,
                                         float scale_log2, int valid) {
  const int t = threadIdx.x % 4;
  float s[QN / 2], dp[QN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc128(sk, 16) + 2 * kk, desc128(sq, 16) + 2 * kk, kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(dp, desc128(sv, 16) + 2 * kk, desc128(sdo, 16) + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait<1>();  // S^T is in; dP^T may still be running
  reg_fence(s);
  // P^T = exp2(S^T scale log2(e) - lse log2(e)) by column (query), 0 past
  // the tile's real queries; packed to bf16 as the A operand of dV += P^T dO
  uint32_t pp[QN / 4];
#pragma unroll
  for (int i = 0; i < QN / 8; ++i) {
    const float2 l = lse_s[4 * i + t];  // columns 8i + 2t, 8i + 2t + 1
    const bool in0 = 8 * i + 2 * t < valid, in1 = 8 * i + 2 * t + 1 < valid;
    s[4 * i] = in0 ? ex2(fmaf(s[4 * i], scale_log2, -l.x * LOG2E)) : 0.f;
    s[4 * i + 1] = in1 ? ex2(fmaf(s[4 * i + 1], scale_log2, -l.y * LOG2E)) : 0.f;
    s[4 * i + 2] = in0 ? ex2(fmaf(s[4 * i + 2], scale_log2, -l.x * LOG2E)) : 0.f;
    s[4 * i + 3] = in1 ? ex2(fmaf(s[4 * i + 3], scale_log2, -l.y * LOG2E)) : 0.f;
    pp[2 * i] = pack_bf16(s[4 * i], s[4 * i + 1]);
    pp[2 * i + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
  wgmma_wait<0>();  // dP^T is in
  reg_fence(dp);
  reg_fence(dv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QN / 16; ++kk)  // query step kk: 16 rows (2048 bytes) into dO
    wgmma_rs(dv, pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3],
             desc128(sdo, 1024) + kk * (2048 >> 4));
  wgmma_commit();
  // dS^T = P^T (dP^T - delta) by column, rounded: the A operand of dK += dS^T Q
  uint32_t pds[QN / 4];
#pragma unroll
  for (int i = 0; i < QN / 8; ++i) {
    const float2 d = dl_s[4 * i + t];
    pds[2 * i] = pack_bf16(s[4 * i] * (dp[4 * i] - d.x), s[4 * i + 1] * (dp[4 * i + 1] - d.y));
    pds[2 * i + 1] =
        pack_bf16(s[4 * i + 2] * (dp[4 * i + 2] - d.x), s[4 * i + 3] * (dp[4 * i + 3] - d.y));
  }
  reg_fence(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QN / 16; ++kk)
    wgmma_rs(dk, pds[4 * kk], pds[4 * kk + 1], pds[4 * kk + 2], pds[4 * kk + 3],
             desc128(sq, 1024) + kk * (2048 >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(dv);
  reg_fence(dk);
}

// K2b: one block per (batch*head, 64 keys)
__global__ void __launch_bounds__(WG_THREADS, 3)
flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   int nq, int nk, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;  // K, then the dV/dK staging tile
  const uint32_t sv = sk + TILE_BYTES;          // V
  const uint32_t sq = sv + TILE_BYTES;          // Q stages 0, 1
  const uint32_t sdo = sq + 2 * TILE_BYTES;     // dO stages 0, 1
  const uint32_t sst = sdo + 2 * TILE_BYTES;    // stages 0, 1 of lse[64], delta[64]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const size_t kbase = (size_t)bh * nk * D;
  const __nv_bfloat16* qb = q + (size_t)bh * nq * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * nq * D;
  const float* lse_b = lse + (size_t)bh * nq;
  const float* delta_b = delta + (size_t)bh * nq;
  const int tid = threadIdx.x;
  const int ntiles = (nq + TILE - 1) / TILE;
  const int last_valid = nq - (ntiles - 1) * TILE;  // real queries of the last tile

  auto copy_q = [&](int i) {
    if (i < ntiles) {
      const int s = i & 1, row = i * TILE + tid % TILE;
      copy_tile(sq + s * TILE_BYTES, qb, i * TILE, nq);
      copy_tile(sdo + s * TILE_BYTES, dob, i * TILE, nq);
      // threads 0-63 copy lse, 64-127 delta, one value each
      const float* src = tid < TILE ? lse_b : delta_b;
      cp_async4(sst + s * STATS_BYTES + tid * 4, src + (row < nq ? row : 0), row < nq);
    }
  };
  copy_tile(sk, k + kbase, k0, nk);
  copy_tile(sv, v + kbase, k0, nk);
  copy_q(0);
  cp_async_commit();

  float dkr[32], dvr[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkr[i] = dvr[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    // Q, dO, lse and delta of tile i have landed, and tile i - 1's products
    // are done: its stage is free for tile i + 1
    cp_async_wait<0>();
    __syncthreads();
    copy_q(i + 1);
    cp_async_commit();
    const int s = i & 1;
    const float2* stats =
        reinterpret_cast<const float2*>(smem_raw + (sst - raw) + s * STATS_BYTES);
    const uint32_t sqi = sq + s * TILE_BYTES, sdoi = sdo + s * TILE_BYTES;
    if (i == ntiles - 1 && last_valid <= 16)
      dkv_tile<16>(dkr, dvr, sk, sv, sqi, sdoi, stats, stats + TILE / 2, scale_log2,
                   last_valid);
    else
      dkv_tile<TILE>(dkr, dvr, sk, sv, sqi, sdoi, stats, stats + TILE / 2, scale_log2,
                     nq - i * TILE);
  }

  __syncthreads();  // no product reads the K tile any more
  unsigned char* const stage = smem_raw + (sk - raw);
  store_acc(dvr, 1.f, stage, dv + kbase, k0, nk, tid, 1);
  store_acc(dkr, scale, stage, dk + kbase, k0, nk, tid, 1);
}

// ---- fp32: plain FMA, two threads per row (interleaved dims 2i + half) -----
constexpr int DH = D / 2;              // dims per thread of a pair
constexpr int F_BR = 64;               // rows per block
constexpr int F_BC = 32;               // rows of the other side per tile
constexpr int F_THREADS = 2 * F_BR;

// the sum of x over a pair of neighbouring lanes
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ out,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int nq, int nk,
                 float scale) {
  __shared__ float Ks[F_BC * D];
  __shared__ float Vs[F_BC * D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * F_BR + threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const bool live = row < nq;
  const size_t base = ((size_t)bh * nq + (live ? row : 0)) * D;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  float qr[DH], dor[DH], acc[DH];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = live ? q[base + 2 * i + half] : 0.f;
    dor[i] = live ? dout[base + 2 * i + half] : 0.f;
    part = fmaf(dor[i], live ? out[base + 2 * i + half] : 0.f, part);
    acc[i] = 0.f;
  }
  const float lse_r = live ? lse[(size_t)bh * nq + row] : 0.f;
  const float delta_r = pair_sum(part);  // rowsum(dO * O)
  if (live && half == 0) delta[(size_t)bh * nq + row] = delta_r;

  for (int k0 = 0; k0 < nk; k0 += F_BC) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BC * D; i += F_THREADS) {
      const int kr = k0 + i / D;
      Ks[i] = kr < nk ? kb[(size_t)kr * D + i % D] : 0.f;
      Vs[i] = kr < nk ? vb[(size_t)kr * D + i % D] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F_BC; ++j) {
      const float* kj = Ks + j * D + half;
      const float* vj = Vs + j * D + half;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        s = fmaf(qr[i], kj[2 * i], s);
        dp = fmaf(dor[i], vj[2 * i], dp);
      }
      s = pair_sum(s);
      dp = pair_sum(dp);
      const float p = (live && k0 + j < nk) ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(ds, kj[2 * i], acc[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DH; ++i) dq[base + 2 * i + half] = acc[i] * scale;
  }
}

__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int nq, int nk,
                  float scale) {
  __shared__ float Qs[F_BC * D];
  __shared__ float dOs[F_BC * D];
  __shared__ float lse_s[F_BC];
  __shared__ float delta_s[F_BC];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * F_BR + threadIdx.x / 2;  // key row
  const int half = threadIdx.x % 2;
  const bool live = row < nk;
  const size_t base = ((size_t)bh * nk + (live ? row : 0)) * D;
  const float* qb = q + (size_t)bh * nq * D;
  const float* dob = dout + (size_t)bh * nq * D;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    kr[i] = live ? k[base + 2 * i + half] : 0.f;
    vr[i] = live ? v[base + 2 * i + half] : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += F_BC) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BC * D; i += F_THREADS) {
      const int qi = q0 + i / D;
      Qs[i] = qi < nq ? qb[(size_t)qi * D + i % D] : 0.f;
      dOs[i] = qi < nq ? dob[(size_t)qi * D + i % D] : 0.f;
    }
    for (int i = threadIdx.x; i < F_BC; i += F_THREADS) {
      const bool in = q0 + i < nq;
      lse_s[i] = in ? lse[(size_t)bh * nq + q0 + i] : 0.f;
      delta_s[i] = in ? delta[(size_t)bh * nq + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F_BC; ++j) {
      const float* qj = Qs + j * D + half;
      const float* dj = dOs + j * D + half;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        s = fmaf(kr[i], qj[2 * i], s);
        dp = fmaf(vr[i], dj[2 * i], dp);
      }
      s = pair_sum(s);
      dp = pair_sum(dp);
      const float p = (live && q0 + j < nq) ? expf(s * scale - lse_s[j]) : 0.f;
      const float ds = p * (dp - delta_s[j]);
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        dvr[i] = fmaf(p, dj[2 * i], dvr[i]);
        dkr[i] = fmaf(ds, qj[2 * i], dkr[i]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dk[base + 2 * i + half] = dkr[i] * scale;
      dv[base + 2 * i + half] = dvr[i];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out/dout/dq [bh, nq, 64], k/v [bh,
// nk, 64], lse [bh, nq] fp32 in, delta [bh, nq] fp32 out; all contiguous,
// 16-byte aligned, on the current device.
extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* out, const void* dout,
                                 const float* lse, float* delta, void* dq, int bh,
                                 int nq, int nk, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || nq < 1 || nk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
    if (err != cudaSuccess) return err;
    dim3 grid((nq + TILE - 1) / TILE, bh);
    flash_bwd_dq_bf16<<<grid, WG_THREADS, SMEM_DQ, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), nq, nk, scale, scale * LOG2E);
  } else if (dtype == 0) {
    dim3 grid((nq + F_BR - 1) / F_BR, bh);
    flash_bwd_dq_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), nq, nk,
        scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// q/dout [bh, nq, 64], k/v/dk/dv [bh, nk, 64], lse/delta [bh, nq] fp32 (delta
// from flash_attn_bwd_dq); all contiguous, 16-byte aligned.
extern "C" int flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv, int bh, int nq, int nk,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || nq < 1 || nk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
    if (err != cudaSuccess) return err;
    dim3 grid((nk + TILE - 1) / TILE, bh);
    flash_bwd_dkv_bf16<<<grid, WG_THREADS, SMEM_DKV, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), nq,
        nk, scale, scale * LOG2E);
  } else if (dtype == 0) {
    dim3 grid((nk + F_BR - 1) / F_BR, bh);
    flash_bwd_dkv_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), nq, nk, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
