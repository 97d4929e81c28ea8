// Fused clipped AdamW step with int8 moments, for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel vista_slam_tpu/ops/pallas/adam8.py:_adam_kernel_int8
// (launched by fused_adamw_int8). Same function over one parameter leaf taken
// in the JAX package's layout and cut into rows of QBLOCK = 1024 elements of
// its row-major flatten; each row keeps two fp32 scales. With scalars =
// (clip coefficient, lr, 1 - b1^t, 1 - b2^t) read from device memory and
// k = ln(1e6) / 126:
//   g  = g * coef
//   mu = mu_q * mu_s                                 (int8 codes, absmax/127 scale)
//   nu = nu_q > 0 ? nu_s * exp((nu_q - 127) k) : 0    (log-domain codes, max scale)
//   mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g * g
//   u  = (mu / c1) / (sqrt(nu / c2) + eps)           (optax's exact denominator)
//   p  = p - lr * (u + wd * p)
//   mu_s = max(max|mu|, 1e-10) / 127;  mu_q = round(mu / mu_s)
//   nu_s = max(max nu, 1e-30);  nu_q = clip(round(127 + log(max(nu, 1e-38) / nu_s) / k), 1, 127)
// p, the codes and the scales are updated in place.
//
// What bounds it on the card, and what the design does about it: the step
// reads g and p (8 bytes) and the two codes (2 bytes) and writes p and the
// codes (6 bytes), 16 bytes per parameter for ~40 flops, far below the
// card's ~295 flops per byte: it is bound by device memory. One block of 256
// threads owns one 1024-element row (4 elements a thread): it dequantizes,
// updates and writes p, takes the two row maxima with warp shuffles and a
// shared-memory step, and requantizes both moments, so each array is read
// and written once. The block addresses p and g through the leaf's
// JAX-layout view (sizes and strides from the caller, up to 4 dims), so its
// rows are the JAX package's blocks; for a transposed leaf (a Linear
// weight's [in, out] view of a torch [out, in] tensor) neighbouring threads
// then read addresses a row apart, and those loads are not coalesced. The
// products and sums use the round-to-nearest intrinsics (never contracted
// into FMAs), rintf rounds half to even as jnp.round does, and expf, logf,
// sqrt and division are the IEEE-rounded functions (no fast math), so the
// kernel rounds where the plain PyTorch version rounds.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 1024;
constexpr int THREADS = 256;
constexpr int PER_THREAD = QBLOCK / THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DIMS = 4;

struct View {  // a strided view, padded in front with size-1 dims
  uint32_t size[MAX_DIMS];
  int64_t stride[MAX_DIMS];
};

// element offset of the i-th element of the view's row-major flatten
__device__ __forceinline__ int64_t view_offset(const View& v, uint32_t i) {
  int64_t off = 0;
#pragma unroll
  for (int d = MAX_DIMS - 1; d >= 0; --d) {
    off += (int64_t)(i % v.size[d]) * v.stride[d];
    i /= v.size[d];
  }
  return off;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__global__ void __launch_bounds__(THREADS)
adamw_int8_kernel(float* __restrict__ p, const float* __restrict__ g, View view,
                  int8_t* __restrict__ mu_q, float* __restrict__ mu_s,
                  int8_t* __restrict__ nu_q, float* __restrict__ nu_s,
                  const float* __restrict__ scalars, float b1, float one_minus_b1,
                  float b2, float one_minus_b2, float eps, float wd, float k) {
  __shared__ float red[2][WARPS];
  const float coef = scalars[0];
  const float lr = scalars[1];
  const float c1 = scalars[2];
  const float c2 = scalars[3];
  const uint32_t row = blockIdx.x;
  const float mscale = mu_s[row];
  const float nscale = nu_s[row];
  int8_t* mq = mu_q + (size_t)row * QBLOCK;
  int8_t* nq = nu_q + (size_t)row * QBLOCK;

  float mu[PER_THREAD], nu[PER_THREAD];
  float amax = 0.f, nmax = 0.f;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int j = threadIdx.x + e * THREADS;
    const int64_t off = view_offset(view, row * QBLOCK + j);
    const float gi = __fmul_rn(g[off], coef);
    const float m0 = __fmul_rn((float)mq[j], mscale);
    const float nc = (float)nq[j];
    const float v0 = nc > 0.f ? __fmul_rn(nscale, expf(__fmul_rn(__fsub_rn(nc, 127.f), k)))
                              : 0.f;
    const float m = __fadd_rn(__fmul_rn(b1, m0), __fmul_rn(one_minus_b1, gi));
    const float v = __fadd_rn(__fmul_rn(b2, v0), __fmul_rn(__fmul_rn(one_minus_b2, gi), gi));
    const float u = __fdiv_rn(__fdiv_rn(m, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
    const float pi = p[off];
    p[off] = __fsub_rn(pi, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, pi))));
    mu[e] = m;
    nu[e] = v;
    amax = fmaxf(amax, fabsf(m));
    nmax = fmaxf(nmax, v);
  }

  // the row's two maxima: warp shuffles, then one value per warp in shared
  amax = warp_max(amax);
  nmax = warp_max(nmax);
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = amax;
    red[1][threadIdx.x / 32] = nmax;
  }
  __syncthreads();
  amax = red[0][0];
  nmax = red[1][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    amax = fmaxf(amax, red[0][w]);
    nmax = fmaxf(nmax, red[1][w]);
  }
  const float ms = __fdiv_rn(fmaxf(amax, 1e-10f), 127.f);
  const float ss = fmaxf(nmax, 1e-30f);

#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int j = threadIdx.x + e * THREADS;
    mq[j] = (int8_t)rintf(__fdiv_rn(mu[e], ms));
    const float logc = __fadd_rn(127.f, __fdiv_rn(logf(__fdiv_rn(fmaxf(nu[e], 1e-38f), ss)), k));
    nq[j] = (int8_t)fminf(fmaxf(rintf(logc), 1.f), 127.f);
  }
  if (threadIdx.x == 0) {
    mu_s[row] = ms;
    nu_s[row] = ss;
  }
}

}  // namespace

// p/g fp32 addressed through one strided view of ndim <= 4 dims (sizes,
// strides in elements) whose row-major flatten has rows * 1024 elements;
// mu_q/nu_q int8 [rows, 1024], mu_s/nu_s fp32 [rows], scalars fp32 [4]; all
// on the current device.
extern "C" int adamw_int8(void* p, const void* g, int ndim, const long long* sizes,
                          const long long* strides, void* mu_q, void* mu_s,
                          void* nu_q, void* nu_s, const void* scalars, int rows,
                          float b1, float one_minus_b1, float b2,
                          float one_minus_b2, float eps, float wd, float k,
                          void* stream) {
  if (rows < 1 || ndim < 1 || ndim > MAX_DIMS) return cudaErrorInvalidValue;
  if ((long long)rows * QBLOCK > 0x7fffffffLL) return cudaErrorInvalidValue;
  View view;
  long long numel = 1;
  for (int d = 0; d < MAX_DIMS; ++d) {
    const int src = d - (MAX_DIMS - ndim);
    view.size[d] = src < 0 ? 1u : (uint32_t)sizes[src];
    view.stride[d] = src < 0 ? 0 : (int64_t)strides[src];
    numel *= view.size[d];
  }
  if (numel != (long long)rows * QBLOCK) return cudaErrorInvalidValue;
  adamw_int8_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), view,
      static_cast<int8_t*>(mu_q), static_cast<float*>(mu_s),
      static_cast<int8_t*>(nu_q), static_cast<float*>(nu_s),
      static_cast<const float*>(scalars), b1, one_minus_b1, b2, one_minus_b2,
      eps, wd, k);
  return cudaGetLastError();
}
