// Fused short-sequence attention for training, for Hopper (sm_90a), head dim
// 64: kernels K3a (forward) and K3b (backward, dq/dk/dv in one kernel).
//
// Replace the TPU kernels vista_slam_tpu/ops/pallas/attn_train.py:_fwd_kernel
// (launched by _fwd_impl) and :_bwd_kernel (launched by _fa_bwd). Same
// function, per (batch*head) slice of N <= 1024 tokens (N_q == N_kv):
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
// What bounds it on the card, and what the design does about it:
// At the training step's N = 196/197 one slice does 4 N^2 D = 10 MFLOP
// forward (16 backward) on 8 N D = 200 KB of bf16 panels (14 N D backward),
// ~50 flops per byte against the card's ~295: by the roofline these kernels
// are bound by device memory. The TPU kernels hold a group of 8 slices' whole
// [N, N] problem in VMEM, grouping to amortise the TPU's per-grid-step
// overhead; Hopper has no such overhead and 227 KB of shared memory a block,
// so neither the grouping nor the VMEM sizing is carried over. Instead:
//   * K3a gives one block to 64 query rows of one slice (4 blocks per slice
//     at N = 197: 2,304 blocks at the decoder's 576 slices) and walks 64-key
//     tiles twice, first for the exact row max, then for P, l and P V. The
//     softmax is exact, as the TPU kernel's one pass over the whole row, for
//     every N up to the cap, at the price of computing S twice (the second
//     read of K comes from L2).
//   * K3b gives one block to a whole slice. It walks 64-key tiles; for each
//     it keeps dK and dV in WMMA accumulator fragments while it walks the
//     64-row query tiles, and adds dS K into an fp32 dQ scratch [N_pad, 64]
//     in device memory that only this block touches (L2-resident at these
//     sizes); dQ is scaled and rounded once at the end. Each output is
//     written by one block: no atomics, results are deterministic.
// The products use WMMA (mma.sync bf16 fragments, fp32 accumulation) with
// S, dP, P and dS through shared memory whose row strides are padded past
// the 128-byte bank period (K1's 3.4x). The fp32 variants (parity checks and
// the fp32 tests) use plain FMA, because the tensor cores' fp32 path (TF32)
// would not hold fp32 accuracy. Register-resident softmax, wgmma and TMA are
// later work.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// caller's stream and returns the cudaError_t of the launch.

#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr int MAX_N = 1024;

// K3a: Q, K, V | S | P
constexpr int SMEM_FWD = 3 * TILE_BF16 + TILE_F32 + TILE_P;
// K3b: K, V, Q, dO | S^T, dP^T | P^T, dS^T | lse, delta
constexpr int SMEM_BWD = 4 * TILE_BF16 + 2 * TILE_F32 + 2 * TILE_P + 2 * BR * 4;

// K3a: one block per (batch*head, 64 query rows)
__global__ void __launch_bounds__(THREADS)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int n,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BR * LD;
  __nv_bfloat16* Vs = Ks + BR * LD;
  float* Ss = reinterpret_cast<float*>(Vs + BR * LD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BR * S_LD);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const size_t base = (size_t)bh * n * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // the warp's first row in the tile
  const int r = wrow + lane / 2;       // softmax work: two lanes per row,
  const int half = lane % 2;           // interleaved columns half + 2c
  const float* srow = Ss + r * S_LD + half;

  load_tile_bf16(Qs, q + base, q0, BR, n);

  // pass 1: the exact row max over all N keys
  float m = -INFINITY;
  for (int k0 = 0; k0 < n; k0 += BR) {
    __syncthreads();  // the previous tile's K reads are done
    load_tile_bf16(Ks, k + base, k0, BR, n);
    __syncthreads();
    warp_abt(Ss + wrow * S_LD, Qs + wrow * LD, Ks);  // S_w = Q_w K^T
    __syncwarp();
    const int valid = n - k0 - half;  // column half + 2c is a real key iff 2c < valid
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if (2 * c < valid) m = fmaxf(m, __fmul_rn(srow[2 * c], scale));
    }
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // finite: n >= 1

  // pass 2: P = exp(S - m), its row sum, and P V
  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  float l = 0.f;
  __nv_bfloat16* prow = Ps + r * P_LD + half;
  for (int k0 = 0; k0 < n; k0 += BR) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile_bf16(Ks, k + base, k0, BR, n);
    load_tile_bf16(Vs, v + base, k0, BR, n);
    __syncthreads();
    warp_abt(Ss + wrow * S_LD, Qs + wrow * LD, Ks);
    __syncwarp();
    const int valid = n - k0 - half;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = 2 * c < valid ? expf(__fmul_rn(srow[2 * c], scale) - m) : 0.f;
      l += p;
      prow[2 * c] = __float2bfloat16(p);
    }
    __syncwarp();
    warp_ab_acc(acc, Ps + wrow * P_LD, Vs);  // O_w += P_w V
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // out = O / l: the accumulator staged through the warp's rows of S
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(Ss + wrow * S_LD + j * 16, acc[j], S_LD, wmma::mem_row_major);
  }
  __syncwarp();
  if (q0 + r < n) {
    __nv_bfloat16* dst = out + base + (size_t)(q0 + r) * D + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[2 * c] = __float2bfloat16(srow[2 * c] / l);
    if (half == 0) lse[(size_t)bh * n + q0 + r] = m + logf(l);
  }
}

// K3b: one block per batch*head slice
__global__ void __launch_bounds__(THREADS)
attn_bwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc, int n,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BR * LD;
  __nv_bfloat16* Qs = Vs + BR * LD;
  __nv_bfloat16* dOs = Qs + BR * LD;
  float* STs = reinterpret_cast<float*>(dOs + BR * LD);
  float* dPTs = STs + BR * S_LD;
  __nv_bfloat16* PTs = reinterpret_cast<__nv_bfloat16*>(dPTs + BR * S_LD);
  __nv_bfloat16* dSTs = PTs + BR * P_LD;
  float* lse_s = reinterpret_cast<float*>(dSTs + BR * P_LD);
  float* delta_s = lse_s + BR;

  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * n * D;
  const int n_pad = (n + BR - 1) / BR * BR;
  float* acc_q = dq_acc + (size_t)bh * n_pad * D;  // this block's dQ sums

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;
  const int r = wrow + lane / 2;       // key row of this lane's elementwise work
  const int half = lane % 2;           // query columns half + 2c

  for (int k0 = 0; k0 < n; k0 += BR) {
    __syncthreads();  // the previous key tile's K/V reads are done
    load_tile_bf16(Ks, k + base, k0, BR, n);
    load_tile_bf16(Vs, v + base, k0, BR, n);
    const bool live = k0 + r < n;

    FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fill_fragment(acc_dk[j], 0.f);
      wmma::fill_fragment(acc_dv[j], 0.f);
    }

    for (int q0 = 0; q0 < n; q0 += BR) {
      __syncthreads();  // the previous query tile's Q/dO/dS reads are done
      load_tile_bf16(Qs, q + base, q0, BR, n);
      load_tile_bf16(dOs, dout + base, q0, BR, n);
      for (int i = threadIdx.x; i < BR; i += THREADS) {
        const bool in = q0 + i < n;
        lse_s[i] = in ? lse[(size_t)bh * n + q0 + i] : 0.f;
        delta_s[i] = in ? delta[(size_t)bh * n + q0 + i] : 0.f;
      }
      __syncthreads();

      warp_abt(STs + wrow * S_LD, Ks + wrow * LD, Qs);    // S^T_w  = K_w Q^T
      warp_abt(dPTs + wrow * S_LD, Vs + wrow * LD, dOs);  // dP^T_w = V_w dO^T
      __syncwarp();

      const float* srow = STs + r * S_LD + half;
      const float* dprow = dPTs + r * S_LD + half;
      __nv_bfloat16* prow = PTs + r * P_LD + half;
      __nv_bfloat16* dsrow = dSTs + r * P_LD + half;
      const int valid = n - q0 - half;  // column half + 2c is a real query iff 2c < valid
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = half + 2 * c;
        const float p = (live && 2 * c < valid)
                            ? expf(__fmul_rn(srow[2 * c], scale) - lse_s[col]) : 0.f;
        prow[2 * c] = __float2bfloat16(p);
        dsrow[2 * c] = __float2bfloat16(p * (dprow[2 * c] - delta_s[col]));
      }
      __syncwarp();

      warp_ab_acc(acc_dv, PTs + wrow * P_LD, dOs);   // dV_w += P^T_w dO
      warp_ab_acc(acc_dk, dSTs + wrow * P_LD, Qs);   // dK_w += dS^T_w Q
      __syncthreads();  // every warp's rows of dS^T are written

      // dQ rows q0 + wrow .. + 16 (this warp's) += dS[rows, tile keys] K:
      // dS is read transposed out of dS^T (a column-major A operand)
      float* acc_rows = acc_q + (size_t)(q0 + wrow) * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragC c;
        if (k0 == 0) {
          wmma::fill_fragment(c, 0.f);
        } else {
          wmma::load_matrix_sync(c, acc_rows + j * 16, D, wmma::mem_row_major);
        }
#pragma unroll
        for (int kk = 0; kk < BR / 16; ++kk) {
          FragAc fa;
          FragBr fb;
          wmma::load_matrix_sync(fa, dSTs + kk * 16 * P_LD + wrow, P_LD);
          wmma::load_matrix_sync(fb, Ks + kk * 16 * LD + j * 16, LD);
          wmma::mma_sync(c, fa, fb, c);
        }
        wmma::store_matrix_sync(acc_rows + j * 16, c, D, wmma::mem_row_major);
      }
    }
    // dV and dK of this key tile (staged through the warp's rows of S^T)
    store_rows(acc_dv, STs + wrow * S_LD, dv + base, k0, wrow, n, 1.f);
    store_rows(acc_dk, STs + wrow * S_LD, dk + base, k0, wrow, n, scale);
  }

  // dQ = (its fp32 sum) * scale, rounded once; each warp reads back the rows
  // it wrote
  __syncthreads();
  for (int q0 = 0; q0 < n; q0 += BR) {
    FragC c[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::load_matrix_sync(c[j], acc_q + (size_t)(q0 + wrow) * D + j * 16, D,
                             wmma::mem_row_major);
    }
    store_rows(c, STs + wrow * S_LD, dq + base, q0, wrow, n, scale);
  }
}

// ---- fp32: plain FMA --------------------------------------------------------
constexpr int F_BQ = 64;               // K3a: query rows per block, one per thread
constexpr int F_BK = 32;               // K3a: keys per shared tile
constexpr int FB_KEYS = 64;            // K3b: keys per pass, two threads per key
constexpr int FB_QT = 32;              // K3b: queries per shared tile
constexpr int FB_THREADS = 2 * FB_KEYS;

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

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out [bh, n, 64], lse [bh, n] fp32;
// all contiguous on the current device.
extern "C" int attn_train_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* out, float* lse, int bh,
                              int n, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || bh > 65535 || n < 1 || n > MAX_N) return cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
    if (err != cudaSuccess) return err;
    dim3 grid((n + BR - 1) / BR, bh);
    attn_fwd_bf16<<<grid, THREADS, SMEM_FWD, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        lse, n, scale);
  } else if (dtype == 0) {
    dim3 grid((n + F_BQ - 1) / F_BQ, bh);
    attn_fwd_f32<<<grid, F_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, n, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// q/k/v/dout/dq/dk/dv [bh, n, 64], lse/delta [bh, n] fp32; dq_acc fp32
// [bh, n rounded up to 64, 64] scratch for bf16 (unused for fp32).
extern "C" int attn_train_bwd(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq,
                              void* dk, void* dv, float* dq_acc, int bh, int n,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || n < 1 || n > MAX_N) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (dq_acc == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BWD);
    if (err != cudaSuccess) return err;
    attn_bwd_bf16<<<bh, THREADS, SMEM_BWD, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), dq_acc, n, scale);
  } else if (dtype == 0) {
    attn_bwd_f32<<<bh, FB_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), n, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
