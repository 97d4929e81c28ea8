// Fused clipped AdamW step with int8 moments, for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel vista_slam_tpu/ops/pallas/adam8.py:_adam_kernel_int8
// (launched by fused_adamw_int8). Same function over each parameter leaf
// taken in the JAX package's layout and cut into rows of QBLOCK = 1024
// elements of its row-major flatten; each row keeps two fp32 scales. With
// scalars = (clip coefficient, lr, 1 - b1^t, 1 - b2^t) read from device
// memory and k = ln(1e6) / 126:
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
// What bounds it on the card: the step reads g and p (8 bytes) and the two
// codes (2 bytes) and writes p and the codes (6 bytes), 16 bytes per
// parameter for ~40 flops, far below the card's ~295 flops per byte: it is
// bound by device memory, and every array has to be read in full 32-byte
// sectors. The codes follow the JAX layout, whose last dim o (a weight's
// output channel) is contiguous; p and g follow torch's, whose innermost
// run r (in * kh * kw of a Linear or conv weight, k * k of a transposed
// conv's) is contiguous. Each leaf is described as
//   torch offset (b, o, r) = (b * O + o) * R + r
//   JAX index    (b, o, r) = (b * R + (r % KK) * (R / KK) + r / KK) * O + o
// (B = 1 but for a transposed conv's in-channels; KK = kh * kw for a conv,
// else 1; an identity-layout leaf is O = numel, R = 1).
//
// The design: a block takes a tile of TO o x TR r of one leaf (TR = 16, or
// 8 for a shorter run, 1 for R = 1; TO * TR = 4096). It copies g (and p)
// into shared memory along r with cp.async (64-byte runs, padded against
// bank conflicts) and the codes along o (256-byte runs, 4 bytes a copy);
// updates each element in JAX order from shared memory; and writes p back
// along r. (Tiles of 32 or more along r were no faster on the card.) The
// blocks are persistent (as many as fit the card at once) and keep two
// stages of shared memory: each starts the copies of its next tile before
// it computes the current one, so its copies overlap its own arithmetic,
// which with IEEE division, square root and log is about as long as the
// copies. exp((c - 127) k) takes one of 128 values, so a shared table
// (made with expf) stands in for it.
//
// What still holds it back (PERF.md): over a whole step it runs at about
// 3x its bound; pass 2 is bound by its arithmetic (three IEEE divisions
// and a log an element), pass 1 by how fast the scattered 64-byte runs
// come back with one tile in flight per block.
//
// A JAX row straddles tiles, so the row maxima that requantize the moments
// need every tile of the row, hence two passes over each leaf:
//   pass 1: dequantize with the old scales, update m and v, write p; the
//           maxima of |m| and v over the tile's share of each row go to a
//           per-row scratch by atomicMax on the fp32 bit pattern (both are
//           >= 0, so the unsigned order is the float order: exact and
//           order-free, hence deterministic). A warp walks runs of one
//           column whose 32 lanes hold consecutive JAX elements, so a run
//           spans at most two rows: each lane keeps both rows' maxima, one
//           warp-wide max (redux) a run, a shared atomicMax, then one
//           global atomicMax a row and tile;
//   pass 2: recompute m and v from g, the old codes and the old scales with
//           the same operations (bit-identical to pass 1), requantize
//           against the new maxima and write the codes;
//   finish: the new scales into mu_s and nu_s, and the scratch back to 0.
// Every tile of a row reads the row's old scales in both passes, so they
// are replaced only by the third, tiny launch. Pass 2 re-reads g and the
// codes (6 bytes) rather than storing fp32 m and v (16): 22 bytes a
// parameter in all, 1.375x the function's 16.
//
// All the leaves of a step go in one launch per pass: the leaf table
// (pointers, layout, tile and row offsets, weight decay) is a kernel
// parameter (__grid_constant__, up to 32,764 bytes from CUDA 12.1), so a
// launch needs no copy to the device and can be captured in a CUDA graph.
// Every call passes the whole CAP-leaf table, however few leaves it holds,
// so a one-leaf call runs the same kernels as the optimizer's step.
// A block finds its first leaf by binary search and steps from there; a
// tile computes its columns' JAX bases once (one div/mod a column), and
// its elements step from those.
//
// The products and sums use the round-to-nearest intrinsics (never
// contracted into FMAs), rintf rounds half to even as jnp.round does, and
// expf, logf, sqrt and division are the IEEE-rounded functions (no fast
// math), so the kernel rounds where the plain PyTorch version rounds.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int QBLOCK = 1024;
constexpr int THREADS = 256;
constexpr int LG_TILE = 12;
constexpr int TILE = 1 << LG_TILE;            // elements of one tile
constexpr int PER_THREAD = TILE / THREADS;
constexpr int MAX_LG_TR = 4;                  // the tile's extent along r: at most 16
constexpr int MAX_TR = 1 << MAX_LG_TR;
constexpr int SMEM_FLOATS = TILE / 8 * 9;    // max over TR of TO * (TR + 1), TR = 1 or >= 8
constexpr int MAX_SLOTS = 2 * MAX_TR;         // max over TR of TR * slots a column
constexpr int CAP = 360;                      // leaves a launch takes (88 bytes each)

struct Leaf {
  float* p;            // the parameter, torch layout
  const float* g;      // its gradient, laid out as p
  int8_t* mu_q;        // [rows, 1024] codes and [rows] scales, JAX order
  float* mu_s;
  int8_t* nu_q;
  float* nu_s;
  int O, R, KK;        // the layout (header)
  int lg_tr;           // log2 of the tile's extent along r
  int tiles_r;         // tiles along r
  int tiles_b;         // tiles of one b (tiles along o x tiles_r)
  int tile0;           // the leaf's first block in the launch
  int row0;            // the leaf's first row in the scratch
  int rows;            // numel / 1024
  float wd;
};
static_assert(sizeof(Leaf) == 88, "the ctypes mirror in kernels/adamw.py");

struct Table {
  Leaf leaf[CAP];
  int n;
};

struct Hyper {
  const float* scalars;  // coef, lr, 1 - b1^t, 1 - b2^t
  unsigned* amax;        // per-row scratch: max |m| and max v as fp32 bits
  unsigned* nmax;
  float b1, one_minus_b1, b2, one_minus_b2, eps, k;
};
static_assert(sizeof(Table) + sizeof(Hyper) + sizeof(int) <= 32764,
              "kernel parameters of at most 32,764 bytes");

__device__ __forceinline__ int find_leaf(const Table& t, int key, bool by_row) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((by_row ? t.leaf[mid].row0 : t.leaf[mid].tile0) <= key) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

// exp((c - 127) k) for every nu code c, as the plain version computes it:
// a table in shared memory stands in for expf in both passes
__device__ __forceinline__ void exp_table(float* ex, float k) {
  if (threadIdx.x < 128) ex[threadIdx.x] = expf(__fmul_rn(__fsub_rn((float)threadIdx.x, 127.f), k));
}

// dequantize and update one element's moments (the same code in both
// passes); exq = exp((nq - 127) k) from the table
__device__ __forceinline__ void moments(float gi, int8_t mq, int8_t nq, float exq,
                                        float mscale, float nscale, const Hyper& h,
                                        float& m, float& v) {
  const float m0 = __fmul_rn((float)mq, mscale);
  const float v0 = nq > 0 ? __fmul_rn(nscale, exq) : 0.f;
  m = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.one_minus_b1, gi));
  v = __fadd_rn(__fmul_rn(h.b2, v0), __fmul_rn(__fmul_rn(h.one_minus_b2, gi), gi));
}

__device__ __forceinline__ float mu_scale(unsigned amax) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax), 1e-10f), 127.f);
}

__device__ __forceinline__ float nu_scale(unsigned nmax) {
  return fmaxf(__uint_as_float(nmax), 1e-30f);
}

// What a block knows of its tile.
struct Tile {
  int leaf, b, o0, r0, n_o, n_r, lg_tr, lg_to, ld, ns;
  int64_t tbase;  // torch offset of (b, o0, r0)
};

// Tile ``tile`` of the launch; ``leaf`` is a leaf at or before its own (the
// blocks walk the tiles upwards, so the search is a step or two).
__device__ __forceinline__ Tile tile_of(const Table& t, int tile, int leaf) {
  Tile x;
  while (leaf + 1 < t.n && t.leaf[leaf + 1].tile0 <= tile) ++leaf;
  x.leaf = leaf;
  const Leaf& L = t.leaf[leaf];
  const int i = tile - L.tile0;
  x.b = i / L.tiles_b;
  const int rem = i - x.b * L.tiles_b;
  const int to = rem / L.tiles_r;
  const int tr = rem - to * L.tiles_r;
  x.lg_tr = L.lg_tr;
  x.lg_to = LG_TILE - x.lg_tr;
  const int TR = 1 << x.lg_tr, TO = 1 << x.lg_to;
  x.o0 = to * TO;
  x.r0 = tr * TR;
  x.n_o = min(TO, L.O - x.o0);
  x.n_r = min(TR, L.R - x.r0);
  x.ld = TR > 1 ? TR + 1 : 1;  // odd stride: a warp along o hits 32 banks
  x.ns = TO >= QBLOCK ? TO / QBLOCK + 1 : 2;  // rows one column can touch
  x.tbase = ((int64_t)x.b * L.O + x.o0) * L.R + x.r0;
  return x;
}

// Per tile, in shared memory: g (and, in pass 1, p) as [TO][ld] along r;
// the two codes as [TR][TO] along o (the code of element e = rl * TO + ol
// of the JAX-order walk is sq[.][e]); the columns' JAX bases and first
// rows; and per slot (column, row the column touches) the old scales, the
// new scales (pass 2, first as the scratch's bits) and the maxima (pass 1).
struct Cols {
  int jb[MAX_TR];
  int rowlo[MAX_TR];
  float old_s[2][MAX_SLOTS];
  float new_s[2][MAX_SLOTS];
  unsigned mx[2][MAX_SLOTS];
};

template <bool P1>
struct alignas(16) Stage {
  float sg[SMEM_FLOATS];
  float sp[P1 ? SMEM_FLOATS : 1];
  int8_t sq[2][TILE];
  Cols c;
};

// The first half of a tile's copies (one cp.async group per thread): g
// (and p) along r; the columns' JAX bases (one div/mod a column); the
// maxima zeroed (pass 1).
template <bool P1>
__device__ __forceinline__ void prefetch_a(const Table& t, const Tile& x, Stage<P1>& s) {
  const Leaf& L = t.leaf[x.leaf];
  const int TR = 1 << x.lg_tr;
  const float* const g = L.g;
  const float* const p = L.p;
  const int R = L.R;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int ol = e >> x.lg_tr, rl = e & (TR - 1);
    if (ol < x.n_o && rl < x.n_r) {
      const int64_t src = x.tbase + (int64_t)ol * R + rl;
      cp_async4(s.sg + ol * x.ld + rl, g + src);
      if (P1) cp_async4(s.sp + ol * x.ld + rl, p + src);
    }
  }
  if (threadIdx.x < TR) {
    const int rl = threadIdx.x, r = x.r0 + rl;
    const int jb = rl < x.n_r ? (x.b * R + (r % L.KK) * (R / L.KK) + r / L.KK) * L.O : 0;
    s.c.jb[rl] = jb;
    s.c.rowlo[rl] = (jb + x.o0) / QBLOCK;
  }
  if (P1)
    for (int i = threadIdx.x; i < 2 * MAX_SLOTS; i += THREADS) s.c.mx[i / MAX_SLOTS][i % MAX_SLOTS] = 0u;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The second half, once the columns are visible (one more group): the
// codes along o (4 bytes a copy where O allows, else one byte a load), the
// old scales of the rows the columns touch and, in pass 2, the new row
// maxima.
template <bool P1>
__device__ __forceinline__ void prefetch_b(const Table& t, const Hyper& h, const Tile& x,
                                           Stage<P1>& s) {
  const Leaf& L = t.leaf[x.leaf];
  const int TR = 1 << x.lg_tr, TO = 1 << x.lg_to;
  const int8_t* const mu_q = L.mu_q;
  const int8_t* const nu_q = L.nu_q;
  if (L.O % 4 == 0) {  // then n_o is a multiple of 4 and every copy aligned
#pragma unroll
    for (int i = 0; i < TILE / 4 / THREADS; ++i) {
      const int e = 4 * (threadIdx.x + i * THREADS);
      const int ol = e & (TO - 1), rl = e >> x.lg_to;
      if (ol < x.n_o && rl < x.n_r) {
        const int j = s.c.jb[rl] + x.o0 + ol;
        cp_async4(reinterpret_cast<float*>(&s.sq[0][e]), reinterpret_cast<const float*>(mu_q + j));
        cp_async4(reinterpret_cast<float*>(&s.sq[1][e]), reinterpret_cast<const float*>(nu_q + j));
      }
    }
  } else {
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int ol = e & (TO - 1), rl = e >> x.lg_to;
      if (ol < x.n_o && rl < x.n_r) {
        const int j = s.c.jb[rl] + x.o0 + ol;
        s.sq[0][e] = mu_q[j];
        s.sq[1][e] = nu_q[j];
      }
    }
  }
  if (threadIdx.x < TR * x.ns) {
    const int col = threadIdx.x / x.ns, row = s.c.rowlo[col] + threadIdx.x % x.ns;
    if (col < x.n_r && row < L.rows) {
      cp_async4(&s.c.old_s[0][threadIdx.x], L.mu_s + row);
      cp_async4(&s.c.old_s[1][threadIdx.x], L.nu_s + row);
      if (!P1) {
        const int at = L.row0 + row;
        cp_async4(&s.c.new_s[0][threadIdx.x], reinterpret_cast<const float*>(h.amax + at));
        cp_async4(&s.c.new_s[1][threadIdx.x], reinterpret_cast<const float*>(h.nmax + at));
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The blocks are persistent: block k takes tiles k, k + grid, ... and keeps
// two stages. Per tile: start the next tile's first copies; wait for the
// current tile's (all but the newest group) and meet at a barrier; start
// the next tile's second copies; then the caller computes the current
// tile while both are in flight.
template <bool P1>
__device__ __forceinline__ void next_stage(const Table& t, const Hyper& h, int tile,
                                           int tiles, Tile& x, Tile& xn, Stage<P1>& sn) {
  const int tn = tile + (int)gridDim.x;
  if (tn < tiles) {
    xn = tile_of(t, tn, x.leaf);
    prefetch_a(t, xn, sn);
  } else {
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // keeps the group count
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  if (tn < tiles) prefetch_b(t, h, xn, sn);
  else asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool P1>
__device__ __forceinline__ Tile first_tile(const Table& t, const Hyper& h, Stage<P1>& s,
                                           float* ex) {
  const Tile x = tile_of(t, blockIdx.x, find_leaf(t, blockIdx.x, false));
  prefetch_a(t, x, s);
  exp_table(ex, h.k);
  __syncthreads();
  prefetch_b(t, h, x, s);
  return x;
}

// The JAX-order walk: warp w takes elements e = 32 (PER_THREAD w + q) + lane
// of the tile (q < PER_THREAD), in segments within one column; a
// segment spans at most two rows (the first and the next, from o = split
// on), whose scales it holds in registers.
struct Segment {
  int rl, ol0, n, slot, split;
};

__device__ __forceinline__ bool segment(const Tile& x, const Cols& c, int q0, int seg,
                                        Segment& g) {
  const int e0 = 32 * PER_THREAD * (threadIdx.x >> 5) + 32 * q0;
  g.rl = e0 >> x.lg_to;
  g.ol0 = e0 & ((1 << x.lg_to) - 1);
  if (g.rl >= x.n_r || g.ol0 >= x.n_o) return false;
  g.n = seg;
  const int jb = c.jb[g.rl] + x.o0;      // JAX index of (rl, o0)
  const int rb = (jb + g.ol0) / QBLOCK;  // the segment's first row
  g.slot = g.rl * x.ns + rb - c.rowlo[g.rl];
  g.split = (rb + 1) * QBLOCK - jb;
  return true;
}

// blocks of a pass that fit an SM's 227 KB of shared memory (at most 4)
constexpr int fitting(int stage_bytes) {
  return 232448 / (2 * stage_bytes + 1024) < 4 ? 232448 / (2 * stage_bytes + 1024) : 4;
}

__global__ void __launch_bounds__(THREADS, fitting(sizeof(Stage<true>)))
adamw_int8_pass1(const __grid_constant__ Table t, const Hyper h, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<true>* const st = reinterpret_cast<Stage<true>*>(smem);
  __shared__ float ex[128];
  int tile = blockIdx.x;
  if (tile >= tiles) return;
  Tile x = first_tile(t, h, st[0], ex), xn;
  const float coef = h.scalars[0], lr = h.scalars[1], c1 = h.scalars[2], c2 = h.scalars[3];
  const int lane = threadIdx.x & 31;
  for (int k = 0; tile < tiles; tile += gridDim.x, ++k, x = xn) {
    Stage<true>& s = st[k & 1];
    next_stage(t, h, tile, tiles, x, xn, st[(k + 1) & 1]);
    const Leaf& L = t.leaf[x.leaf];
    const float wd = L.wd;
    const int TR = 1 << x.lg_tr, TO = 1 << x.lg_to;
    const int seg = min(PER_THREAD, TO / 32);
    for (int q0 = 0; q0 < PER_THREAD; q0 += seg) {
      Segment g;
      if (!segment(x, s.c, q0, seg, g)) continue;  // warp-uniform
      const int hi_slot = min(g.slot + 1, MAX_SLOTS - 1);
      const float ms0 = s.c.old_s[0][g.slot], ns0 = s.c.old_s[1][g.slot];
      const float ms1 = s.c.old_s[0][hi_slot], ns1 = s.c.old_s[1][hi_slot];
      float a0 = 0.f, v0 = 0.f, a1 = 0.f, v1 = 0.f;
#pragma unroll 4
      for (int q = 0; q < g.n; ++q) {
        const int ol = g.ol0 + 32 * q + lane;
        if (ol >= x.n_o) continue;
        const int e = (g.rl << x.lg_to) + ol;
        const bool up = ol >= g.split;
        const float gi = __fmul_rn(s.sg[ol * x.ld + g.rl], coef);
        float m, v;
        const int8_t nq = s.sq[1][e];
        moments(gi, s.sq[0][e], nq, ex[nq & 127], up ? ms1 : ms0, up ? ns1 : ns0, h, m, v);
        const float u =
            __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
        float& pi = s.sp[ol * x.ld + g.rl];
        pi = __fsub_rn(pi, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, pi))));
        if (up) {
          a1 = fmaxf(a1, fabsf(m));
          v1 = fmaxf(v1, v);
        } else {
          a0 = fmaxf(a0, fabsf(m));
          v0 = fmaxf(v0, v);
        }
      }
      // |m| and v are >= 0: their bits order as the floats do
      const unsigned A0 = __reduce_max_sync(0xffffffffu, __float_as_uint(a0));
      const unsigned V0 = __reduce_max_sync(0xffffffffu, __float_as_uint(v0));
      const unsigned A1 = __reduce_max_sync(0xffffffffu, __float_as_uint(a1));
      const unsigned V1 = __reduce_max_sync(0xffffffffu, __float_as_uint(v1));
      if (lane == 0) {
        atomicMax(&s.c.mx[0][g.slot], A0);
        atomicMax(&s.c.mx[1][g.slot], V0);
        if (A1 | V1) {
          atomicMax(&s.c.mx[0][g.slot + 1], A1);
          atomicMax(&s.c.mx[1][g.slot + 1], V1);
        }
      }
    }
    __syncthreads();

    // p back along r; the tile's row maxima into the scratch
    float* const p = L.p;
    const int R = L.R;
#pragma unroll 4
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int ol = e >> x.lg_tr, rl = e & (TR - 1);
      if (ol < x.n_o && rl < x.n_r) p[x.tbase + (int64_t)ol * R + rl] = s.sp[ol * x.ld + rl];
    }
    if (threadIdx.x < TR * x.ns) {
      const int col = threadIdx.x / x.ns, row = s.c.rowlo[col] + threadIdx.x % x.ns;
      const unsigned a = s.c.mx[0][threadIdx.x], v = s.c.mx[1][threadIdx.x];
      // 0 is the scratch's own value: a slot no element reached stays 0
      if (col < x.n_r && row < L.rows) {
        if (a) atomicMax(h.amax + L.row0 + row, a);
        if (v) atomicMax(h.nmax + L.row0 + row, v);
      }
    }
    __syncthreads();  // before the stage is refilled
  }
}

__global__ void __launch_bounds__(THREADS, fitting(sizeof(Stage<false>)))
adamw_int8_pass2(const __grid_constant__ Table t, const Hyper h, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<false>* const st = reinterpret_cast<Stage<false>*>(smem);
  __shared__ float ex[128];
  int tile = blockIdx.x;
  if (tile >= tiles) return;
  Tile x = first_tile(t, h, st[0], ex), xn;
  const float coef = h.scalars[0];
  const int lane = threadIdx.x & 31;
  for (int k = 0; tile < tiles; tile += gridDim.x, ++k, x = xn) {
    Stage<false>& s = st[k & 1];
    next_stage(t, h, tile, tiles, x, xn, st[(k + 1) & 1]);
    const Leaf& L = t.leaf[x.leaf];
    const int TR = 1 << x.lg_tr, TO = 1 << x.lg_to;
    if (threadIdx.x < TR * x.ns) {  // the new maxima's bits into scales
      float* const ms = &s.c.new_s[0][threadIdx.x];
      float* const ss = &s.c.new_s[1][threadIdx.x];
      *ms = mu_scale(__float_as_uint(*ms));
      *ss = nu_scale(__float_as_uint(*ss));
    }
    __syncthreads();
    int8_t* const mu_q = L.mu_q;
    int8_t* const nu_q = L.nu_q;
    const int seg = min(PER_THREAD, TO / 32);
    for (int q0 = 0; q0 < PER_THREAD; q0 += seg) {
      Segment g;
      if (!segment(x, s.c, q0, seg, g)) continue;  // warp-uniform
      const int hi_slot = min(g.slot + 1, MAX_SLOTS - 1);
      const float ms0 = s.c.old_s[0][g.slot], ns0 = s.c.old_s[1][g.slot];
      const float ms1 = s.c.old_s[0][hi_slot], ns1 = s.c.old_s[1][hi_slot];
      const float qm0 = s.c.new_s[0][g.slot], qn0 = s.c.new_s[1][g.slot];
      const float qm1 = s.c.new_s[0][hi_slot], qn1 = s.c.new_s[1][hi_slot];
      const int jb = s.c.jb[g.rl] + x.o0;
#pragma unroll 4
      for (int q = 0; q < g.n; ++q) {
        const int ol = g.ol0 + 32 * q + lane;
        if (ol >= x.n_o) continue;
        const int e = (g.rl << x.lg_to) + ol;
        const bool up = ol >= g.split;
        const float gi = __fmul_rn(s.sg[ol * x.ld + g.rl], coef);
        float m, v;
        const int8_t nq = s.sq[1][e];
        moments(gi, s.sq[0][e], nq, ex[nq & 127], up ? ms1 : ms0, up ? ns1 : ns0, h, m, v);
        mu_q[jb + ol] = (int8_t)rintf(__fdiv_rn(m, up ? qm1 : qm0));
        const float logc = __fadd_rn(
            127.f, __fdiv_rn(logf(__fdiv_rn(fmaxf(v, 1e-38f), up ? qn1 : qn0)), h.k));
        nu_q[jb + ol] = (int8_t)fminf(fmaxf(rintf(logc), 1.f), 127.f);
      }
    }
    __syncthreads();  // before the stage is refilled
  }
}

// The new scales into mu_s / nu_s, the scratch back to 0: one thread a row.
__global__ void __launch_bounds__(THREADS)
adamw_int8_finish(const __grid_constant__ Table t, const Hyper h, int total_rows) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= total_rows) return;
  const Leaf& L = t.leaf[find_leaf(t, row, true)];
  const int r = row - L.row0;
  if (r >= L.rows) return;
  L.mu_s[r] = mu_scale(h.amax[row]);
  L.nu_s[r] = nu_scale(h.nmax[row]);
  h.amax[row] = 0u;
  h.nmax[row] = 0u;
}

// Per device: the blocks of each persistent pass that fit an SM at once,
// times the SMs (dynamic shared memory opted in on first use).
struct Grid {
  int pass1, pass2;
};

cudaError_t grid_of(Grid& g) {
  static Grid grids[64];
  static bool ready[64];
  int dev = 0, sms = 0, b1 = 0, b2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err ? err : cudaErrorInvalidDevice;
  if (!ready[dev]) {
    const int s1 = 2 * sizeof(Stage<true>), s2 = 2 * sizeof(Stage<false>);
    if ((err = cudaFuncSetAttribute(adamw_int8_pass1,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, s1)) ||
        (err = cudaFuncSetAttribute(adamw_int8_pass2,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, s2)) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b1, adamw_int8_pass1,
                                                             THREADS, s1)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b2, adamw_int8_pass2,
                                                             THREADS, s2)))
      return err;
    if (b1 < 1 || b2 < 1) return cudaErrorInvalidConfiguration;
    grids[dev] = {b1 * sms, b2 * sms};
    ready[dev] = true;
  }
  g = grids[dev];
  return cudaSuccess;
}

int launch(const Leaf* leaves, int n, int tiles, int total_rows, const Hyper& h,
           cudaStream_t stream) {
  Grid g;
  cudaError_t err = grid_of(g);
  if (err != cudaSuccess) return err;
  Table t;
  memcpy(t.leaf, leaves, n * sizeof(Leaf));
  t.n = n;
  adamw_int8_pass1<<<min(tiles, g.pass1), THREADS, 2 * sizeof(Stage<true>), stream>>>(
      t, h, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  adamw_int8_pass2<<<min(tiles, g.pass2), THREADS, 2 * sizeof(Stage<false>), stream>>>(
      t, h, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  adamw_int8_finish<<<(total_rows + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      t, h, total_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int adamw_int8_leaf_bytes() { return (int)sizeof(Leaf); }
extern "C" int adamw_int8_max_leaves() { return CAP; }
extern "C" int adamw_int8_tile() { return TILE; }
extern "C" int adamw_int8_max_lg_tr() { return MAX_LG_TR; }

// One step over n leaves (1 <= n <= adamw_int8_max_leaves()) whose tables
// the caller filled (tile0/row0 prefix sums from 0; rows = numel / 1024);
// amax/nmax: uint32 [total_rows] scratch, all 0, left all 0; scalars fp32
// [4]; all on the current device. Three launches on ``stream``.
extern "C" int adamw_int8_many(const void* table, int n, int tiles, int total_rows,
                               void* amax, void* nmax, const void* scalars, float b1,
                               float one_minus_b1, float b2, float one_minus_b2,
                               float eps, float k, void* stream) {
  if (n < 1 || n > CAP || tiles < 1 || total_rows < 1) return cudaErrorInvalidValue;
  // (a void pointer: a parameter of the unnamed namespace's type would give
  // this function internal linkage)
  const Leaf* leaves = static_cast<const Leaf*>(table);
  int64_t tile = 0, row = 0;  // the table must tile every leaf exactly once
  for (int i = 0; i < n; ++i) {
    const Leaf& L = leaves[i];
    if (!(L.lg_tr == 0 || (L.lg_tr >= 3 && L.lg_tr <= MAX_LG_TR)) || L.O < 1 || L.R < 1 || L.KK < 1 || L.R % L.KK ||
        L.rows < 1 || L.tile0 != tile || L.row0 != row)
      return cudaErrorInvalidValue;
    const int64_t numel = (int64_t)L.rows * QBLOCK, TR = 1 << L.lg_tr, TO = TILE / TR;
    if (numel % ((int64_t)L.O * L.R) || numel > 0x7fffffffLL ||
        L.tiles_r != (L.R + TR - 1) / TR || L.tiles_b != (L.O + TO - 1) / TO * L.tiles_r)
      return cudaErrorInvalidValue;
    tile += numel / ((int64_t)L.O * L.R) * L.tiles_b;
    row += L.rows;
  }
  if (tile != tiles || row != total_rows) return cudaErrorInvalidValue;
  const Hyper h{static_cast<const float*>(scalars), static_cast<unsigned*>(amax),
                static_cast<unsigned*>(nmax), b1, one_minus_b1, b2, one_minus_b2, eps, k};
  const auto s = static_cast<cudaStream_t>(stream);
  return launch(leaves, n, tiles, total_rows, h, s);
}
