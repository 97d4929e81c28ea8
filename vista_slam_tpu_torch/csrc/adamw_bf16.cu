// Fused clipped AdamW step with bf16 moments, for Hopper (sm_90a): kernel K5.
//
// Replaces the TPU kernel vista_slam_tpu/ops/pallas/adam8.py:_adam_kernel_bf16
// (launched by fused_adamw_bf16). Same function, elementwise over one
// parameter leaf, with scalars = (clip coefficient, lr, 1 - b1^t, 1 - b2^t)
// read from device memory:
//   g  = g * coef
//   mu = b1 * mu + (1 - b1) * g                (fp32 math, stored bf16)
//   nu = b2 * nu + (1 - b2) * g * g            (fp32 math, stored bf16)
//   u  = (mu / c1) / (sqrt(nu / c2) + eps)     (optax's exact denominator)
//   p  = p - lr * (u + wd * p)
// p, mu and nu are updated in place.
//
// What bounds it on the card, and what the design does about it: the step
// reads g, p, mu, nu and writes p, mu, nu once each, 20 bytes per parameter
// for ~15 flops, far below the card's ~295 flops per byte: it is bound by
// device memory. One thread per element streams each array once, with
// consecutive threads on consecutive addresses. The four scalars are read
// from device memory, so the host never waits for the gradient norm. The
// products and sums use the round-to-nearest intrinsics (never contracted
// into FMAs), so the kernel rounds at the same points as the plain PyTorch
// version and agrees with it bit for bit.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
adamw_bf16_kernel(float* __restrict__ p, const float* __restrict__ g,
                  __nv_bfloat16* __restrict__ mu, __nv_bfloat16* __restrict__ nu,
                  const float* __restrict__ scalars, int64_t n, float b1,
                  float one_minus_b1, float b2, float one_minus_b2, float eps,
                  float wd) {
  const float coef = scalars[0];
  const float lr = scalars[1];
  const float c1 = scalars[2];
  const float c2 = scalars[3];
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const float gi = __fmul_rn(g[i], coef);
    const float m = __fadd_rn(__fmul_rn(b1, __bfloat162float(mu[i])),
                              __fmul_rn(one_minus_b1, gi));
    const float v = __fadd_rn(__fmul_rn(b2, __bfloat162float(nu[i])),
                              __fmul_rn(__fmul_rn(one_minus_b2, gi), gi));
    const float u = __fdiv_rn(__fdiv_rn(m, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
    const float pi = p[i];
    p[i] = __fsub_rn(pi, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, pi))));
    mu[i] = __float2bfloat16_rn(m);
    nu[i] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// p/g fp32 [n], mu/nu bf16 [n], scalars fp32 [4]; all contiguous on the
// current device.
extern "C" int adamw_bf16(void* p, const void* g, void* mu, void* nu,
                          const void* scalars, long long n, float b1,
                          float one_minus_b1, float b2, float one_minus_b2,
                          float eps, float wd, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 65535LL * 16 ? want : 65535LL * 16);
  adamw_bf16_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu),
      static_cast<const float*>(scalars), (int64_t)n, b1, one_minus_b1, b2,
      one_minus_b2, eps, wd);
  return cudaGetLastError();
}
