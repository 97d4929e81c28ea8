// Fused short-sequence attention for training, for Hopper (sm_90a), head dim
// 64: kernels K3a (forward) and K3b (backward, dq/dk/dv in one kernel).
//
// Replace the TPU kernels vista_slam_tpu/ops/pallas/attn_train.py:_fwd_kernel
// (launched by _fwd_impl) and :_bwd_kernel (launched by _fa_bwd). Same
// function, per (batch*head) slice of N <= 1024 tokens (N_q == N_kv), for
// any scale (negative and 0 included):
//   S  = Q K^T * scale (fp32), keys >= N masked
//   K3a: m = rowmax(S), P = exp(S - m), l = rowsum(P)
//        out = (P rounded to V's dtype) V / l      in q's dtype
//        lse = m + log(l)                           fp32 [BH, N]
//   K3b: P = exp(S - lse), dP = dO V^T (fp32), dS = P * (dP - delta)
//        dV = (P rounded to dO's dtype)^T dO
//        dQ = (dS rounded to Q's dtype) K * scale
//        dK = (dS rounded to Q's dtype)^T Q * scale
// with delta = rowsum(dO * O) fp32 from the caller, fp32 accumulation and the
// scale applied after it, as the TPU kernels round. Keys and queries at or
// past N get P = 0 explicitly.
//
// What bounds them on the card. At the training step's N = 196/197 one
// slice does 4 N^2 D = 10 MFLOP forward (10 N^2 D = 25 MFLOP backward) on
// 8 N D = 200 KB of bf16 panels (14 N D backward): ~50 flops per byte
// against the H100's ~295, so by the roofline device memory bounds both
// (at [48,12,197,64]: 0.0175 ms forward, 0.0306 ms backward at 3.35 TB/s).
// In practice latency sets the pace: each warpgroup's chain of products,
// exponentials and the next products, with few warps resident because the
// scores and sums live in registers. The TPU kernels hold a group of 8
// slices' whole [N, N] problem in VMEM; here tiles live in shared memory
// and every score, probability and sum in registers.
//
// Every bf16 product is a wgmma.mma_async (m64n64k16, or m64n16k16 for the
// 16-wide tails) through hopper_tiles.cuh, with fp32 accumulators in
// registers.
//
// K3a: one block is one warpgroup and owns 64 query rows of one slice
// (4 blocks a slice at N = 197, 2,304 at the decoder's 576 slices).
//   * Up to 256 keys (every call on the path) it makes one pass: Q, K and V
//     tiles are copied by cp.async in two groups (Q and K, then V); the
//     scores S = Q K^T of all keys are computed by wgmma into accumulator
//     registers (4 x 32 fp32 a thread), scaled by scale log2(e) in place,
//     and the exact row max is taken in registers (quad shuffles).
//     P = exp2(S - m) by ex2.approx is packed to bf16 in the score
//     registers themselves and fed as the register A operand of O += P V
//     (wgmma, V MN-major through the transpose bit); one key tile's
//     products run while the next tile's exponentials are taken. The TPU
//     kernel's rounding points are kept: P against the exact max, rounded
//     before PV, the row sum of unrounded P.
//   * When the last key tile holds at most 16 real keys (N = 196, 197) it
//     is scored m64n16 and multiplied in one k16 step: 8 score registers
//     instead of 32, a quarter less work, and 168 registers a thread, so
//     three blocks share an SM (two otherwise, at 210).
//   * Past 256 keys, a max-only pass over 256-key chunks comes first, then
//     the pass above chunk by chunk against that exact max.
//   * Epilogue as K1's: O / l staged through the Q tile, 16-byte stores.
//
// K3b: one block owns a whole slice, with two consumer warpgroups, one per
// 64-key tile of a group of two; the block walks the key groups. Each
// warpgroup keeps its dK and dV accumulators in registers while it visits
// the query tiles, which, with an fp32 dQ sum per query tile, are resident
// in shared memory (four query tiles, 256 queries, at once). Warpgroup w
// visits query tile (w + t) mod 4 at step t, so the two never add into the
// same dQ tile at once, and the order of every sum is fixed. For one
// (key tile, query tile) pair:
//   * S^T = K Q^T and dP^T = V dO^T by wgmma from the swizzled tiles, into
//     registers; P^T = exp2(S^T scale log2(e) - lse log2(e)) by ex2, with
//     the scale folded in; dS^T = P^T (dP^T - delta).
//   * P^T and dS^T, packed to bf16 in place, are the register A operands of
//     dV += P^T dO and dK += dS^T Q (dO and Q MN-major).
//   * dS^T is staged in the warpgroup's own swizzled tile and read back as
//     the MN-major A operand of dQ += dS K (K MN-major), which adds into
//     the query tile's fp32 sum in shared memory (kept in accumulator
//     order: conflict-free 16-byte accesses).
//   * A last query tile of at most 16 real queries (N = 196, 197) is scored
//     16 wide: its S^T, dP^T, dV and dK products are a quarter of the work.
// Up to 256 tokens (every call on the path) dQ never leaves the chip until
// it is written. Past them, the dQ sums of a group of query tiles are
// carried from one key group to the next through a block-owned fp32
// scratch, once per (key group, query tile). Every output is written once
// by one block, scaled and rounded once, staged through a swizzled tile and
// stored 16 bytes a thread: no atomics, and two calls are bit-identical.
// Two warpgroups (8 warps an SM, 244 registers, 177 KB of shared memory)
// and not four: at 512 threads a thread may hold 128 registers, less than
// the dK, dV, S^T and dP^T accumulators, their bf16 copies and the
// addresses need (four warpgroups spilled even on 16- and 32-query slabs).
//
// The fp32 variants (parity checks and the fp32 tests) use plain FMA,
// because the tensor cores' fp32 path (TF32) would not hold fp32 accuracy.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// caller's stream and returns the cudaError_t of the launch.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int MAX_N = 1024;

// ---- K3a: bf16 forward -------------------------------------------------------
constexpr int FWD_CHUNK = 4;  // key tiles held at once (256 keys)
// Q, FWD_CHUNK K and V tiles, and slack to align them to 1024 bytes
constexpr int SMEM_FWD = (1 + 2 * FWD_CHUNK) * TILE_BYTES + 1024;

// TAIL16: one chunk holds every key and the last key tile holds at most 16
// real keys; that tile is scored and multiplied 16 keys wide (st)
template <bool TAIL16>
__global__ void __launch_bounds__(WG_THREADS, TAIL16 ? 3 : 2)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int n,
              float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;       // Q, then the output tile
  const uint32_t sk = sq + TILE_BYTES;              // FWD_CHUNK K tiles
  const uint32_t sv = sk + FWD_CHUNK * TILE_BYTES;  // FWD_CHUNK V tiles
  unsigned char* const stage = smem_raw + (sq - raw);

  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * n * D;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int ntiles = (n + TILE - 1) / TILE;
  const int nchunks = (ntiles + FWD_CHUNK - 1) / FWD_CHUNK;
  const int q0 = blockIdx.x * TILE;

  copy_tile(sq, q + base, q0, n);
  const uint64_t dq = desc128(sq, 16);
  // full-width score tiles; with TAIL16 the last tile is st instead
  constexpr int FULL = TAIL16 ? FWD_CHUNK - 1 : FWD_CHUNK;
  float s[FULL][32];
  float st[8];
  float o[32];
  float m[2] = {-INFINITY, -INFINITY};  // row max of the scaled scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum

  // pass 0 (past one chunk only): the exact row max; pass 1: P = exp2(S -
  // m), its row sum and O += P V, with the max taken here when one chunk
  // holds every key
  for (int pass = nchunks > 1 ? 0 : 1; pass < 2; ++pass) {
    for (int c = 0; c < nchunks; ++c) {
      const int j0 = c * FWD_CHUNK;
      const int nc = min(FWD_CHUNK, ntiles - j0);
      __syncthreads();  // the previous chunk's products are done
      for (int jj = 0; jj < nc; ++jj)
        copy_tile(sk + jj * TILE_BYTES, k + base, (j0 + jj) * TILE, n);
      cp_async_commit();
      if (pass == 1) {
        for (int jj = 0; jj < nc; ++jj)
          copy_tile(sv + jj * TILE_BYTES, v + base, (j0 + jj) * TILE, n);
      }
      cp_async_commit();
      cp_async_wait<1>();  // Q and K have landed; V may still be on its way
      __syncthreads();

      const int nfull = TAIL16 ? nc - 1 : nc;  // full-width tiles of the chunk
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < FULL; ++jj) {
        if (jj < nfull) {
          const uint64_t dk = desc128(sk + jj * TILE_BYTES, 16);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s[jj], dq + 2 * kk, dk + 2 * kk, kk);
        }
      }
      if (TAIL16) {
        const uint64_t dk = desc128(sk + nfull * TILE_BYTES, 16);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(st, dq + 2 * kk, dk + 2 * kk, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      const bool take_max = pass == 0 || nchunks == 1;
      // scale by scale log2(e) in place, -inf past the real keys, row max
      auto scale_tile = [&](auto& x, int valid) {
#pragma unroll
        for (int e4 = 0; e4 < (int)(sizeof(x) / sizeof(x[0])); ++e4) {
          const bool in = 8 * (e4 / 4) + 2 * t + e4 % 2 < valid;
          x[e4] = in ? x[e4] * scale_log2 : -INFINITY;
          if (take_max) m[(e4 / 2) % 2] = fmaxf(m[(e4 / 2) % 2], x[e4]);
        }
      };
#pragma unroll
      for (int jj = 0; jj < FULL; ++jj) {
        reg_fence(s[jj]);
        if (jj < nfull) scale_tile(s[jj], n - (j0 + jj) * TILE);
      }
      if (TAIL16) {
        reg_fence(st);
        scale_tile(st, n - (j0 + nfull) * TILE);
      }
      if (take_max) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
        }
      }
      if (pass == 0) continue;

      cp_async_wait<0>();
      __syncthreads();  // V has landed
      if (c == 0) {
#pragma unroll
        for (int e4 = 0; e4 < 32; ++e4) o[e4] = 0.f;
      }
      // (no fence on o between the products below: that would be a use of
      // registers an earlier product is still adding into, and ptxas would
      // wait for it, serialising the exponentials and the products)
      // P = exp2(S - m) (0 at padded keys), packed to bf16 pairs in the
      // score registers, in the A-fragment order of the PV steps; each
      // tile's products run while the next tile's exponentials are taken
      auto exp_pack = [&](auto& p) {
#pragma unroll
        for (int e = 0; e < (int)(sizeof(p) / sizeof(p[0])) / 4; ++e) {
          const float p0 = ex2(p[4 * e] - m[0]);
          const float p1 = ex2(p[4 * e + 1] - m[0]);
          const float p2 = ex2(p[4 * e + 2] - m[1]);
          const float p3 = ex2(p[4 * e + 3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          p[2 * e] = __uint_as_float(pack_bf16(p0, p1));
          p[2 * e + 1] = __uint_as_float(pack_bf16(p2, p3));
        }
      };
#pragma unroll
      for (int jj = 0; jj < FULL; ++jj) {
        if (jj < nfull) {
          float (&p)[32] = s[jj];
          exp_pack(p);
          const uint64_t dv = desc128(sv + jj * TILE_BYTES, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk)
            wgmma_rs(o, __float_as_uint(p[4 * kk]), __float_as_uint(p[4 * kk + 1]),
                     __float_as_uint(p[4 * kk + 2]), __float_as_uint(p[4 * kk + 3]),
                     dv + kk * (2048 >> 4));
          wgmma_commit();
        }
      }
      if (TAIL16) {
        exp_pack(st);
        wgmma_fence();
        wgmma_rs(o, __float_as_uint(st[0]), __float_as_uint(st[1]), __float_as_uint(st[2]),
                 __float_as_uint(st[3]), desc128(sv + nfull * TILE_BYTES, 1024));
        wgmma_commit();
      }
      wgmma_wait<0>();
      reg_fence(o);
    }
  }

  // epilogue: O / l staged through the Q tile, 16-byte stores; lse =
  // (m + log2 l) ln 2, in natural log as the plain version
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // no product reads the Q tile any more
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    *reinterpret_cast<uint32_t*>(stage + swz(r0, e) + 4 * t) =
        pack_bf16(o[4 * e] / l[0], o[4 * e + 1] / l[0]);
    *reinterpret_cast<uint32_t*>(stage + swz(r0 + 8, e) + 4 * t) =
        pack_bf16(o[4 * e + 2] / l[1], o[4 * e + 3] / l[1]);
  }
  const int row = q0 + r0;
  if (t == 0 && row < n) lse[(size_t)bh * n + row] = (m[0] + log2f(l[0])) * LN2;
  if (t == 0 && row + 8 < n) lse[(size_t)bh * n + row + 8] = (m[1] + log2f(l[1])) * LN2;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < TILE * 8 / WG_THREADS; ++e) {
    const int c = threadIdx.x + e * WG_THREADS;
    const int r = c >> 3, ch = c & 7;
    if (q0 + r < n) {
      *reinterpret_cast<uint4*>(out + base + (size_t)(q0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, ch));
    }
  }
}

// ---- K3b: bf16 backward ------------------------------------------------------
constexpr int BWD_WG = 2;                 // consumer warpgroups: key tiles per group
constexpr int BWD_QG = 4;                 // query tiles resident at once
constexpr int DQ_TILE_F4 = TILE * D / 4;  // float4s of one fp32 dQ tile
// K, V and dS^T staging for each warpgroup, BWD_QG Q and dO tiles, BWD_QG
// fp32 dQ tiles, slack to align them to 1024 bytes
constexpr int SMEM_BWD =
    (3 * BWD_WG + 2 * BWD_QG) * TILE_BYTES + BWD_QG * TILE * D * 4 + 1024;

// One warpgroup's work on one (key tile, query tile) pair: dK and dV
// accumulate in registers, dS K is added into the query tile's fp32 dQ sum
// (accumulator order, at sdq). kvalid: real keys of the tile; q0: the
// query tile's first row; lse and delta: the slice's rows. QN: the query
// columns scored, 64, or 16 for a last tile of at most 16 real queries
// (N = 196, 197), whose S^T, dP^T, dV and dK products are a quarter wide;
// the staged dS^T then holds stale columns past 16, which reach only dQ
// rows past N, never stored.
template <int QN>
__device__ __forceinline__ void bwd_pair(float (&dk)[32], float (&dv)[32], uint32_t sk,
                                         uint32_t sv, uint32_t sq, uint32_t sdo,
                                         uint32_t sds, unsigned char* sds_ptr,
                                         float4* sdq, const float* __restrict__ lse,
                                         const float* __restrict__ delta, int kvalid,
                                         int q0, int n, float scale_log2, int tid,
                                         int bar) {
  const int t = tid % 4;
  const int r0 = tid / 32 * 16 + (tid % 32) / 4;  // this thread's keys: r0, r0 + 8
  const bool live0 = r0 < kvalid, live1 = r0 + 8 < kvalid;
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
  // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 at padded keys and
  // queries; packed to bf16 as the A operand of dV += P^T dO
  uint32_t pp[QN / 4];
#pragma unroll
  for (int i = 0; i < QN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = q0 + 8 * i + 2 * t + e;
      const bool in = col < n;
      const float l2 = in ? __ldg(lse + col) * LOG2E : 0.f;
      s[4 * i + e] = live0 && in ? ex2(fmaf(s[4 * i + e], scale_log2, -l2)) : 0.f;
      s[4 * i + 2 + e] = live1 && in ? ex2(fmaf(s[4 * i + 2 + e], scale_log2, -l2)) : 0.f;
    }
    pp[2 * i] = pack_bf16(s[4 * i], s[4 * i + 1]);
    pp[2 * i + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
  wgmma_wait<0>();  // dP^T is in
  reg_fence(dp);
  reg_fence(dv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QN / 16; ++kk)
    wgmma_rs(dv, pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3],
             desc128(sdo, 1024) + kk * (2048 >> 4));
  wgmma_commit();
  // dS^T = P^T (dP^T - delta), rounded: the A operand of dK += dS^T Q
  uint32_t pds[QN / 4];
#pragma unroll
  for (int i = 0; i < QN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = q0 + 8 * i + 2 * t + e;
      const float dl = col < n ? __ldg(delta + col) : 0.f;
      dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - dl);
      dp[4 * i + 2 + e] = s[4 * i + 2 + e] * (dp[4 * i + 2 + e] - dl);
    }
    pds[2 * i] = pack_bf16(dp[4 * i], dp[4 * i + 1]);
    pds[2 * i + 1] = pack_bf16(dp[4 * i + 2], dp[4 * i + 3]);
  }
  reg_fence(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QN / 16; ++kk)
    wgmma_rs(dk, pds[4 * kk], pds[4 * kk + 1], pds[4 * kk + 2], pds[4 * kk + 3],
             desc128(sq, 1024) + kk * (2048 >> 4));
  wgmma_commit();
  // dS^T staged for dQ: rows are keys, columns queries
#pragma unroll
  for (int i = 0; i < QN / 8; ++i) {
    *reinterpret_cast<uint32_t*>(sds_ptr + swz(r0, i) + 4 * t) = pds[2 * i];
    *reinterpret_cast<uint32_t*>(sds_ptr + swz(r0 + 8, i) + 4 * t) = pds[2 * i + 1];
  }
  wgmma_wait<0>();
  reg_fence(dv);
  reg_fence(dk);
  // dQ += dS K: the staged dS^T is dS MN-major, K is MN-major as stored
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_barrier(bar);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = sdq[i * WG_THREADS + tid];
    acc[4 * i] = x.x;
    acc[4 * i + 1] = x.y;
    acc[4 * i + 2] = x.z;
    acc[4 * i + 3] = x.w;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wgmma_ss_mn(acc, desc128(sds, 1024) + kk * (2048 >> 4),
                desc128(sk, 1024) + kk * (2048 >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    sdq[i * WG_THREADS + tid] =
        make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

// K3b: one block per slice. dq_part: fp32 [bh, tiles, 64 * 64] scratch,
// used only past BWD_QG tiles (256 tokens).
__global__ void __launch_bounds__(BWD_WG * WG_THREADS, 1)
attn_bwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_part, int n,
              float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;       // BWD_WG K tiles
  const uint32_t sV = sK + BWD_WG * TILE_BYTES;     // BWD_WG V tiles
  const uint32_t sdS = sV + BWD_WG * TILE_BYTES;    // BWD_WG dS^T staging tiles
  const uint32_t sQ = sdS + BWD_WG * TILE_BYTES;    // BWD_QG Q tiles
  const uint32_t sdO = sQ + BWD_QG * TILE_BYTES;    // BWD_QG dO tiles
  const uint32_t sdQ = sdO + BWD_QG * TILE_BYTES;   // BWD_QG fp32 dQ tiles
  float4* const sdq_ptr = reinterpret_cast<float4*>(smem_raw + (sdQ - raw));

  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * n * D;
  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  const int bar = 1 + wg;  // the warpgroup's named barrier
  const int nt = (n + TILE - 1) / TILE;
  const int nkg = (nt + BWD_WG - 1) / BWD_WG;  // key groups
  const int nqg = (nt + BWD_QG - 1) / BWD_QG;  // query groups
  const uint32_t sk = sK + wg * TILE_BYTES, sv = sV + wg * TILE_BYTES;
  const uint32_t sds = sdS + wg * TILE_BYTES;
  unsigned char* const sds_ptr = smem_raw + (sds - raw);
  const float* lse_b = lse + (size_t)bh * n;
  const float* delta_b = delta + (size_t)bh * n;
  float4* const part_b = dq_part == nullptr
                             ? nullptr
                             : reinterpret_cast<float4*>(dq_part) + (size_t)bh * nt * DQ_TILE_F4;

  for (int gk = 0; gk < nkg; ++gk) {
    const int kt = gk * BWD_WG + wg;  // this warpgroup's key tile
    float dkr[32], dvr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dkr[i] = dvr[i] = 0.f;
    for (int gq = 0; gq < nqg; ++gq) {
      const int nq = min(BWD_QG, nt - gq * BWD_QG);
      // with one query group, Q, dO and the dQ sums stay for every key group
      const bool reload = nqg > 1 || gk == 0;
      __syncthreads();  // every read of the tiles about to be replaced is done
      if (gq == 0) {
        copy_tile(sk, k + base, kt * TILE, n, tid);
        copy_tile(sv, v + base, kt * TILE, n, tid);
      }
      if (reload) {
        for (int jl = wg; jl < BWD_QG; jl += BWD_WG) {
          const int row0 = (gq * BWD_QG + jl) * TILE;
          copy_tile(sQ + jl * TILE_BYTES, q + base, row0, n, tid);
          copy_tile(sdO + jl * TILE_BYTES, dout + base, row0, n, tid);
          float4* acc = sdq_ptr + jl * DQ_TILE_F4;
          if (gk == 0 || jl >= nq) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i * WG_THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            const float4* src = part_b + (size_t)(gq * BWD_QG + jl) * DQ_TILE_F4;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              cp_async16(smem_u32(acc + i * WG_THREADS + tid), src + i * WG_THREADS + tid, true);
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      for (int st = 0; st < BWD_QG; ++st) {
        const int jl = (wg + st) % BWD_QG;
        const int q0 = (gq * BWD_QG + jl) * TILE;
        if (kt < nt && jl < nq) {
          if (n - q0 <= 16) {
            bwd_pair<16>(dkr, dvr, sk, sv, sQ + jl * TILE_BYTES, sdO + jl * TILE_BYTES, sds,
                         sds_ptr, sdq_ptr + jl * DQ_TILE_F4, lse_b, delta_b, n - kt * TILE,
                         q0, n, scale_log2, tid, bar);
          } else {
            bwd_pair<TILE>(dkr, dvr, sk, sv, sQ + jl * TILE_BYTES, sdO + jl * TILE_BYTES, sds,
                           sds_ptr, sdq_ptr + jl * DQ_TILE_F4, lse_b, delta_b, n - kt * TILE,
                           q0, n, scale_log2, tid, bar);
          }
        }
        __syncthreads();  // this step's dQ sums are in before the next step's
      }

      // the query group's dQ: final after the last key group, else its
      // partial sums carried to the next key group
      for (int jl = wg; jl < nq; jl += BWD_WG) {
        const float4* acc = sdq_ptr + jl * DQ_TILE_F4;
        const int j = gq * BWD_QG + jl;
        if (gk == nkg - 1) {
          float a[32];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 x = acc[i * WG_THREADS + tid];
            a[4 * i] = x.x;
            a[4 * i + 1] = x.y;
            a[4 * i + 2] = x.z;
            a[4 * i + 3] = x.w;
          }
          store_acc(a, scale, sds_ptr, dq + base, j * TILE, n, tid, bar);
        } else if (nqg > 1) {
          float4* dst = part_b + (size_t)j * DQ_TILE_F4;
#pragma unroll
          for (int i = 0; i < 8; ++i) dst[i * WG_THREADS + tid] = acc[i * WG_THREADS + tid];
        }
      }
    }
    if (kt < nt) {
      store_acc(dvr, 1.f, sds_ptr, dv + base, kt * TILE, n, tid, bar);
      store_acc(dkr, scale, sds_ptr, dk + base, kt * TILE, n, tid, bar);
    }
  }
}

// ---- fp32: plain FMA --------------------------------------------------------
constexpr int F_BQ = 64;               // K3a: query rows per block, one per thread
constexpr int F_BK = 32;               // K3a: keys per shared tile
constexpr int FB_KEYS = 64;            // K3b: keys per pass, two threads per key
constexpr int FB_QT = 32;              // K3b: queries per shared tile
constexpr int FB_THREADS = 2 * FB_KEYS;
constexpr int DH = D / 2;              // K3b: dims per thread of a pair

// the sum of x over a pair of neighbouring lanes
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

__global__ void __launch_bounds__(F_BQ)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int n, float scale) {
  __shared__ float Ks[F_BK * D];
  __shared__ float Vs[F_BK * D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * F_BQ + threadIdx.x;
  const bool live = row < n;
  const size_t base = (size_t)bh * n * D;

  float qr[D];
  const float* qrow = q + base + (size_t)(live ? row : 0) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? qrow[d] : 0.f;

  // pass 1: the exact row max
  float m = -INFINITY;
  for (int k0 = 0; k0 < n; k0 += F_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += F_BQ) {
      const int kr = k0 + i / D;
      Ks[i] = kr < n ? k[base + (size_t)kr * D + i % D] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F_BK && k0 + j < n; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], Ks[j * D + d], acc);
      m = fmaxf(m, __fmul_rn(acc, scale));
    }
  }

  // pass 2: P, its row sum, and P V
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  float l = 0.f;
  for (int k0 = 0; k0 < n; k0 += F_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += F_BQ) {
      const int kr = k0 + i / D;
      Ks[i] = kr < n ? k[base + (size_t)kr * D + i % D] : 0.f;
      Vs[i] = kr < n ? v[base + (size_t)kr * D + i % D] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F_BK && k0 + j < n; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], Ks[j * D + d], acc);
      const float p = expf(__fmul_rn(acc, scale) - m);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(p, Vs[j * D + d], o[d]);
    }
  }

  if (live) {
    float* dst = out + base + (size_t)row * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = o[d] / l;
    lse[(size_t)bh * n + row] = m + logf(l);
  }
}

// K3b fp32: one block per slice. Two threads per key (interleaved dims
// 2i + half) hold K, V, dK, dV of 64 keys in registers and walk 32-query
// tiles; dS goes through shared memory, and the dQ rows of each tile are
// summed into dq itself (thread t always owns query t / 4 of a tile, dims
// 16 (t % 4) ..), scaled at the end.
__global__ void __launch_bounds__(FB_THREADS)
attn_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, float* __restrict__ dk,
             float* __restrict__ dv, int n, float scale) {
  __shared__ float Qs[FB_QT * D];
  __shared__ float dOs[FB_QT * D];
  __shared__ float Kt[FB_KEYS * D];
  __shared__ float dSs[FB_QT * (FB_KEYS + 1)];  // [query][key]
  __shared__ float lse_s[FB_QT];
  __shared__ float delta_s[FB_QT];

  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * n * D;
  const int key = threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const int qj = threadIdx.x / 4;          // dQ work: query of the tile
  const int d0 = (threadIdx.x % 4) * 16;   // and its 16 dims

  for (int k0 = 0; k0 < n; k0 += FB_KEYS) {
    __syncthreads();  // the previous pass's reads of Kt are done
    const int row = k0 + key;
    const bool live = row < n;
    float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      kr[i] = live ? k[base + (size_t)row * D + 2 * i + half] : 0.f;
      vr[i] = live ? v[base + (size_t)row * D + 2 * i + half] : 0.f;
      dkr[i] = 0.f;
      dvr[i] = 0.f;
    }
    for (int i = threadIdx.x; i < FB_KEYS * D; i += FB_THREADS) {
      const int kk = k0 + i / D;
      Kt[i] = kk < n ? k[base + (size_t)kk * D + i % D] : 0.f;
    }

    for (int q0 = 0; q0 < n; q0 += FB_QT) {
      __syncthreads();  // the previous tile's reads of Qs/dOs/dSs are done
      for (int i = threadIdx.x; i < FB_QT * D; i += FB_THREADS) {
        const int qi = q0 + i / D;
        Qs[i] = qi < n ? q[base + (size_t)qi * D + i % D] : 0.f;
        dOs[i] = qi < n ? dout[base + (size_t)qi * D + i % D] : 0.f;
      }
      for (int i = threadIdx.x; i < FB_QT; i += FB_THREADS) {
        const bool in = q0 + i < n;
        lse_s[i] = in ? lse[(size_t)bh * n + q0 + i] : 0.f;
        delta_s[i] = in ? delta[(size_t)bh * n + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < FB_QT; ++j) {
        const float* qrow = Qs + j * D + half;
        const float* drow = dOs + j * D + half;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          s = fmaf(kr[i], qrow[2 * i], s);
          dp = fmaf(vr[i], drow[2 * i], dp);
        }
        s = pair_sum(s);
        dp = pair_sum(dp);
        const float p = (live && q0 + j < n) ? expf(__fmul_rn(s, scale) - lse_s[j]) : 0.f;
        const float ds = p * (dp - delta_s[j]);
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          dvr[i] = fmaf(p, drow[2 * i], dvr[i]);
          dkr[i] = fmaf(ds, qrow[2 * i], dkr[i]);
        }
        if (half == 0) dSs[j * (FB_KEYS + 1) + key] = ds;
      }
      __syncthreads();  // dS of the tile is complete
      if (q0 + qj < n) {
        float* dst = dq + base + (size_t)(q0 + qj) * D + d0;
        float acc[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = k0 == 0 ? 0.f : dst[e];
        for (int kk = 0; kk < FB_KEYS; ++kk) {
          const float w = dSs[qj * (FB_KEYS + 1) + kk];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = fmaf(w, Kt[kk * D + d0 + e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = acc[e];
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        dk[base + (size_t)row * D + 2 * i + half] = dkr[i] * scale;
        dv[base + (size_t)row * D + 2 * i + half] = dvr[i];
      }
    }
  }
  for (int q0 = 0; q0 < n; q0 += FB_QT) {  // the same threads own the same rows
    if (q0 + qj < n) {
      float* dst = dq + base + (size_t)(q0 + qj) * D + d0;
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[e] *= scale;
    }
  }
}

}  // namespace

namespace {

template <bool TAIL16>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                            float* lse, int bh, int n, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<TAIL16>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  if (err != cudaSuccess) return err;
  dim3 grid((n + TILE - 1) / TILE, bh);
  attn_fwd_bf16<TAIL16><<<grid, WG_THREADS, SMEM_FWD, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, n,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out [bh, n, 64], lse [bh, n] fp32;
// all contiguous, 16-byte aligned, on the current device.
extern "C" int attn_train_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* out, float* lse, int bh,
                              int n, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || bh > 65535 || n < 1 || n > MAX_N) return cudaErrorInvalidValue;
  if (dtype == 1) {
    const int tail = n % TILE;  // real keys of the last tile, when not 64
    if (n <= FWD_CHUNK * TILE && tail >= 1 && tail <= 16)
      return launch_fwd_bf16<true>(q, k, v, out, lse, bh, n, scale, st);
    return launch_fwd_bf16<false>(q, k, v, out, lse, bh, n, scale, st);
  }
  if (dtype == 0) {
    dim3 grid((n + F_BQ - 1) / F_BQ, bh);
    attn_fwd_f32<<<grid, F_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, n, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// Tokens up to which bf16 K3b sums dQ on chip; past them it needs the
// dq_part scratch of attn_train_bwd.
extern "C" int attn_train_bwd_scratch_tokens() { return BWD_QG * TILE; }

// q/k/v/dout/dq/dk/dv [bh, n, 64], lse/delta [bh, n] fp32, all contiguous,
// 16-byte aligned; dq_part fp32 [bh, ceil(n / 64) * 64 * 64] scratch for
// bf16 past attn_train_bwd_scratch_tokens() tokens (else unused, may be
// null).
extern "C" int attn_train_bwd(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq,
                              void* dk, void* dv, float* dq_part, int bh, int n,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || n < 1 || n > MAX_N) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (n > BWD_QG * TILE && dq_part == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BWD);
    if (err != cudaSuccess) return err;
    attn_bwd_bf16<<<bh, BWD_WG * WG_THREADS, SMEM_BWD, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), dq_part, n, scale, scale * LOG2E);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    attn_bwd_f32<<<bh, FB_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), n, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
