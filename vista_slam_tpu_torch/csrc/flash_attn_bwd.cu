// Flash-attention backward for Hopper (sm_90a), head dim 64: kernels K2a
// (dq) and K2b (dk, dv).
//
// Replace the TPU kernels vista_slam_tpu/ops/pallas/flash.py:_bwd_dq_kernel
// and :_bwd_dkv_kernel (launched by _flash_bwd). Same function, per
// (batch*head), with lse from the forward (K1) and delta = rowsum(dO * O)
// computed by the caller in fp32:
//   S  = Q K^T * scale (fp32), keys >= nk masked;   P = exp(S - lse)
//   dP = dO V^T (fp32);                              dS = P * (dP - delta)
//   dQ = (dS rounded to K's dtype) K * scale          (K2a)
//   dV = (P rounded to dO's dtype)^T dO               (K2b)
//   dK = (dS rounded to Q's dtype)^T Q * scale        (K2b)
// with fp32 accumulation and the scale applied after it, as the TPU kernels
// round. Query rows >= nq contribute nothing (masked here; the TPU kernel
// relies on zero-padded dO and delta).
//
// What bounds it on the card, and what the design does about it:
// The TPU kernels hold a whole K/V panel (dq) or Q/dO panel (dk/dv) of one
// head in VMEM and score a 256-row block against it in one pass. A Hopper
// block has at most 227 KB of shared memory, so both kernels here tile the
// other side instead: K2a gives one block to 64 query rows and walks 64-key
// tiles of K and V, keeping dQ in WMMA accumulator fragments (registers)
// across the walk; K2b gives one block to 64 keys and walks 64-query tiles
// of Q, dO, lse and delta, keeping dK and dV in registers. Each output tile
// is written once by one block: no atomics, so results are deterministic.
// Per head the two kernels do 4 + 6 = 10 N^2 D flops on ~12 N D bytes of bf16
// operands (N = 768/769, D = 64), so they are bound by tensor-core work, not
// by device memory. This first version passes S, dP, P and dS through
// shared memory between the WMMA products (mma.sync bf16 fragments, fp32
// accumulation); the shared-memory round trips and the per-tile
// __syncthreads bound it now, and wgmma, TMA and register-resident
// softmax are later work. Row strides are padded past the 128-byte bank
// period, as in K1. The fp32 variants (parity checks and the fp32 tests)
// use plain FMA with two threads per row, because the tensor cores' fp32
// path (TF32) would not hold fp32 accuracy.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// caller's stream and returns the cudaError_t of the launch.

#include <math.h>

#include "attn_tiles.cuh"

namespace {

// K2a: Q, dO, K, V | S, dP | dS
constexpr int SMEM_DQ = 4 * TILE_BF16 + 2 * TILE_F32 + TILE_P;
// K2b: K, V, Q, dO | S^T, dP^T | P^T, dS^T | lse, delta
constexpr int SMEM_DKV = 4 * TILE_BF16 + 2 * TILE_F32 + 2 * TILE_P + 2 * BC * 4;

// K2a: one block per (batch*head, 64 query rows)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int nq, int nk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BR * LD;
  __nv_bfloat16* Ks = dOs + BR * LD;
  __nv_bfloat16* Vs = Ks + BC * LD;
  float* Ss = reinterpret_cast<float*>(Vs + BC * LD);
  float* dPs = Ss + BR * S_LD;
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(dPs + BR * S_LD);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;
  const int r = wrow + lane / 2;       // the row this lane's softmax work is on
  const int half = lane % 2;           // columns half + 2c
  const bool live = q0 + r < nq;
  const float lse_r = live ? lse[(size_t)bh * nq + q0 + r] : 0.f;
  const float delta_r = live ? delta[(size_t)bh * nq + q0 + r] : 0.f;

  load_tile_bf16(Qs, q + (size_t)bh * nq * D, q0, BR, nq);
  load_tile_bf16(dOs, dout + (size_t)bh * nq * D, q0, BR, nq);

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < nk; k0 += BC) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile_bf16(Ks, kb, k0, BC, nk);
    load_tile_bf16(Vs, vb, k0, BC, nk);
    __syncthreads();

    warp_abt(Ss + wrow * S_LD, Qs + wrow * LD, Ks);    // S_w  = Q_w K^T
    warp_abt(dPs + wrow * S_LD, dOs + wrow * LD, Vs);  // dP_w = dO_w V^T
    __syncwarp();

    const float* srow = Ss + r * S_LD + half;
    const float* dprow = dPs + r * S_LD + half;
    __nv_bfloat16* dsrow = dSs + r * P_LD + half;
    const int valid = nk - k0 - half;  // column half + 2c is a real key iff 2c < valid
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = (live && 2 * c < valid) ? expf(srow[2 * c] * scale - lse_r) : 0.f;
      dsrow[2 * c] = __float2bfloat16(p * (dprow[2 * c] - delta_r));
    }
    __syncwarp();

    warp_ab_acc(acc, dSs + wrow * P_LD, Ks);           // dQ_w += dS_w K
  }
  store_rows(acc, Ss + wrow * S_LD, dq + (size_t)bh * nq * D, q0, wrow, nq, scale);
}

// K2b: one block per (batch*head, 64 keys)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   int nq, int nk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BR * LD;
  __nv_bfloat16* Qs = Vs + BR * LD;
  __nv_bfloat16* dOs = Qs + BC * LD;
  float* STs = reinterpret_cast<float*>(dOs + BC * LD);
  float* dPTs = STs + BR * S_LD;
  __nv_bfloat16* PTs = reinterpret_cast<__nv_bfloat16*>(dPTs + BR * S_LD);
  __nv_bfloat16* dSTs = PTs + BR * P_LD;
  float* lse_s = reinterpret_cast<float*>(dSTs + BR * P_LD);
  float* delta_s = lse_s + BC;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BR;
  const __nv_bfloat16* qb = q + (size_t)bh * nq * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * nq * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;
  const int r = wrow + lane / 2;       // key row of this lane's elementwise work
  const int half = lane % 2;           // query columns half + 2c
  const bool live = k0 + r < nk;

  load_tile_bf16(Ks, k + (size_t)bh * nk * D, k0, BR, nk);
  load_tile_bf16(Vs, v + (size_t)bh * nk * D, k0, BR, nk);

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  for (int q0 = 0; q0 < nq; q0 += BC) {
    __syncthreads();  // the previous tile's Q/dO/lse/delta reads are done
    load_tile_bf16(Qs, qb, q0, BC, nq);
    load_tile_bf16(dOs, dob, q0, BC, nq);
    for (int i = threadIdx.x; i < BC; i += THREADS) {
      const bool in = q0 + i < nq;
      lse_s[i] = in ? lse[(size_t)bh * nq + q0 + i] : 0.f;
      delta_s[i] = in ? delta[(size_t)bh * nq + q0 + i] : 0.f;
    }
    __syncthreads();

    warp_abt(STs + wrow * S_LD, Ks + wrow * LD, Qs);    // S^T_w  = K_w Q^T
    warp_abt(dPTs + wrow * S_LD, Vs + wrow * LD, dOs);  // dP^T_w = V_w dO^T
    __syncwarp();

    const float* srow = STs + r * S_LD + half;
    const float* dprow = dPTs + r * S_LD + half;
    __nv_bfloat16* prow = PTs + r * P_LD + half;
    __nv_bfloat16* dsrow = dSTs + r * P_LD + half;
    const int valid = nq - q0 - half;  // column half + 2c is a real query iff 2c < valid
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half + 2 * c;
      const float p = (live && 2 * c < valid)
                          ? expf(srow[2 * c] * scale - lse_s[col]) : 0.f;
      prow[2 * c] = __float2bfloat16(p);
      dsrow[2 * c] = __float2bfloat16(p * (dprow[2 * c] - delta_s[col]));
    }
    __syncwarp();

    warp_ab_acc(acc_dv, PTs + wrow * P_LD, dOs);   // dV_w += P^T_w dO
    warp_ab_acc(acc_dk, dSTs + wrow * P_LD, Qs);   // dK_w += dS^T_w Q
  }
  store_rows(acc_dv, STs + wrow * S_LD, dv + (size_t)bh * nk * D, k0, wrow, nk, 1.f);
  __syncwarp();
  store_rows(acc_dk, STs + wrow * S_LD, dk + (size_t)bh * nk * D, k0, wrow, nk, scale);
}

// ---- fp32: plain FMA, two threads per row (interleaved dims 2i + half) -----
constexpr int F_BR = 64;               // rows per block
constexpr int F_BC = 32;               // rows of the other side per tile
constexpr int F_THREADS = 2 * F_BR;

__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int nq, int nk, float scale) {
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
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = live ? q[base + 2 * i + half] : 0.f;
    dor[i] = live ? dout[base + 2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  const float lse_r = live ? lse[(size_t)bh * nq + row] : 0.f;
  const float delta_r = live ? delta[(size_t)bh * nq + row] : 0.f;

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

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq [bh, nq, 64], k/v [bh, nk, 64],
// lse/delta [bh, nq] fp32; all contiguous on the current device.
extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq,
                                 int bh, int nq, int nk, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || nq < 1 || nk < 1 || bh > 65535) return cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
    if (err != cudaSuccess) return err;
    dim3 grid((nq + BR - 1) / BR, bh);
    flash_bwd_dq_bf16<<<grid, THREADS, SMEM_DQ, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dq), nq, nk, scale);
  } else if (dtype == 0) {
    dim3 grid((nq + F_BR - 1) / F_BR, bh);
    flash_bwd_dq_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), nq, nk, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

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
    dim3 grid((nk + BR - 1) / BR, bh);
    flash_bwd_dkv_bf16<<<grid, THREADS, SMEM_DKV, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), nq, nk, scale);
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
