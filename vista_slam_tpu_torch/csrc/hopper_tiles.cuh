// Hopper (sm_90a) building blocks of the bf16 attention kernels K1
// (flash_attn_fwd.cu), K2a/K2b (flash_attn_bwd.cu) and K3a/K3b
// (attn_train.cu), head dim 64.
//
// Tiles are [64, 64] bf16: one 128-byte row per token, laid out with the
// 128-byte XOR swizzle (16-byte chunk index XOR row index mod 8) that the
// wgmma shared-memory descriptors read, on 1024-byte boundaries. They are
// filled by cp.async, 16 bytes per thread and step, by one warpgroup.
// Products are wgmma.m64nNk16 (bf16 in, fp32 accumulators in registers).
//
// Accumulator layout of m64nN (N = 16, 64): warp w of the warpgroup
// holds rows 16w + g and 16w + g + 8 (g = lane / 4); register 4i + e (e <
// 2) is row 16w + g, column 8i + 2(lane % 4) + e, and 4i + 2 + e the same
// column of row 16w + g + 8. Columns 16kk .. 16kk + 15 (n8 tiles 2kk,
// 2kk + 1) in that layout, packed to bf16 pairs, are the register A
// fragment of k16 step kk of a following product.
//
// Included by one .cu file each: everything here has internal linkage.
// kernels/build.py hashes this header into every library's name, so an
// edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int TILE = 64;                  // rows of a tile (queries or keys)
constexpr int TILE_BYTES = TILE * D * 2;  // one 128-byte row per token
constexpr int WG_THREADS = 128;           // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk ch of row r in a [rows, 64] bf16 tile with
// the 128-byte swizzle (chunk index XOR row index mod 8). Tiles start on
// 1024-byte boundaries, as the swizzle of the wgmma descriptors assumes.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 writes zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's N newest copy groups have landed and are visible
// to the async proxy (wgmma reads shared memory through it); a barrier
// must follow
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a row-major [n, 64] bf16 matrix -> a swizzled
// tile at dst, 16 bytes per thread and step, by the warpgroup's thread tid
// (0 .. 127); rows past n are zero-filled
__device__ __forceinline__ void copy_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int row0, int n, int tid) {
#pragma unroll
  for (int i = 0; i < TILE * 8 / WG_THREADS; ++i) {
    const int c = tid + i * WG_THREADS;
    const int r = c >> 3, ch = c & 7;
    const bool valid = row0 + r < n;
    cp_async16(dst + swz(r, ch), src + (size_t)(valid ? row0 + r : 0) * D + ch * 8, valid);
  }
}

// the same for a block that is one warpgroup
__device__ __forceinline__ void copy_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int row0, int n) {
  copy_tile(dst, src, row0, n, threadIdx.x);
}

// wgmma shared-memory descriptor of a swizzled tile (layout type 1, the
// 128-byte swizzle): start address, leading byte offset, stride byte
// offset 1024 (the next group of 8 rows), all in 16-byte units. The
// leading offset is not read for K-major swizzled operands; for an
// MN-major tile (rows along K) it is the step to the next 64 columns,
// which a 64-wide operand never takes. A k16 step is +32 bytes along the
// rows of a K-major tile (+2 in the descriptor) and +2048 bytes (16 rows,
// +128) down an MN-major one.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of d across an async product
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7])
#define ACC32(d)                                                              \
  ACC8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),     \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),        \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),        \
      "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ACC8_LIST "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define ACC32_LIST                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A B over one k16 step, m64nN (N = 16, 64 by d's size), bf16
// in, fp32 accumulate; A and B from shared memory, both K-major.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " ACC8_LIST
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B over one k16 step, m64n64, both operands from shared memory
// MN-major (transpose bits set): A's rows and B's rows run along K
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A B over one k16 step, m64n64: A from registers (each warp's 16
// rows in the m16n8k16 A-fragment layout), B from shared memory MN-major
// (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// named barrier id over one warpgroup's 128 threads (id 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG_THREADS) : "memory");
}

// The warpgroup's m64n64 accumulator a * mul, rounded to bf16 -> rows
// [row0, row0 + 64) of a row-major [n, 64] matrix (rows < n only), staged
// through the warpgroup's swizzled tile at stage and stored 16 bytes a
// thread; tid: the thread's index in the warpgroup, bar: its named barrier
__device__ __forceinline__ void store_acc(const float (&a)[32], float mul,
                                          unsigned char* stage, __nv_bfloat16* dst,
                                          int row0, int n, int tid, int bar) {
  const int t = tid % 4;
  const int r0 = tid / 32 * 16 + (tid % 32) / 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint32_t*>(stage + swz(r0, i) + 4 * t) =
        pack_bf16(a[4 * i] * mul, a[4 * i + 1] * mul);
    *reinterpret_cast<uint32_t*>(stage + swz(r0 + 8, i) + 4 * t) =
        pack_bf16(a[4 * i + 2] * mul, a[4 * i + 3] * mul);
  }
  wg_barrier(bar);
#pragma unroll
  for (int i = 0; i < TILE * 8 / WG_THREADS; ++i) {
    const int c = tid + i * WG_THREADS;
    const int r = c >> 3, ch = c & 7;
    if (row0 + r < n) {
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, ch));
    }
  }
  wg_barrier(bar);  // the stage may be written again
}

}  // namespace
