// Multi-scale deformable attention, forward and backward, for Hopper (sm_90a).
// The backward kernel, ms_deform_attn_bwd_kernel, is described where it is defined.
//
// The forward replaces the TPU kernel `_pallas_level_gather` in
// odise_tpu/ops/pallas/ms_deform_attn_kernel.py (body `_make_level_kernel`,
// driven by `_pallas_forward`, exported as `ms_deform_attn_pallas`), together
// with the one-hot matmul that served the small levels there
// (odise_tpu/ops/ms_deform_attn.py `_matmul_level`). This kernel covers every
// level in one launch.
//
//   out[b, q, h, c] = sum_l sum_p a[b,q,h,l,p] * bilinear(value_l[b, :, :, h, c], loc[b,q,h,l,p])
//
// with zero padding outside each level (grid_sample, align_corners=False).
//
// What bounds it on an H100. At the main path's shapes (levels 32^2, 64^2,
// 128^2; 21504 queries, 8 heads of 32 channels, 4 points, bf16 values and
// weights, f32 locations) one call must move about 43 MB through device
// memory: value 11.0 MB, locations 16.5 MB, attention 4.1 MB, output 11.0 MB,
// about 13 us at 3.35 TB/s. Its arithmetic (about 0.5 GFLOP of f32 fused
// multiply-adds over the corners) is about 8 us at 67 TFLOP/s. So the floor
// is memory traffic. In practice the gathers decide: about 8.3 M corner rows
// of 64 B (0.53 GB) are read at data-dependent addresses. The 11 MB value
// table fits in the 50 MB L2 but no head's slice of the 64^2 or 128^2 level
// fits in a block's 227 KB of shared memory, so the TPU kernel's
// VMEM-resident quad table does not carry over: the kernel gathers from
// L1/L2, and is bound by how many independent gathers it keeps in flight and
// how many bytes each one moves.
//
// What the design does about it.
//  - One thread owns one 16 B chunk of one head's channels (8 bf16 or
//    4 f32) of one query. At head_dim 32 in bf16 a head is 4 threads and a
//    warp is one query's 8 heads, so a corner read is one 16 B load per
//    thread (one warp-wide load fetches 8 corner rows) and the output store
//    is 512 contiguous bytes. Threads run over (b, q, head, chunk) in that
//    order, so a block's queries are neighbours in raster order and sample
//    neighbouring pixels that L1 serves again.
//  - Corners are branch-free: each corner's row and column are clamped into
//    the level, so every load is in bounds, and a corner outside the level
//    is dropped by selects (its weight and its loaded bits set to 0), so it
//    adds exactly +0 whatever the location (huge, infinite or NaN). The
//    location is clamped before its conversion to int. The P points of a
//    level (a template parameter, 4 on the main path) issue their 4P loads
//    together before any multiply-add. With the main path's counts (3 levels
//    of 4 points) known at compile time the level loop unrolls and the next
//    level's locations load early. Other counts take the generic variant,
//    which issues one point's loads at a time; chip_smoke.py times both on
//    the main path's inputs (PERF.md).
//  - Registers are capped at 85 so that an SM holds 24 warps (6 blocks of
//    128 threads); the main-path variant fits in 80 without spilling.
//  - Locations (2P f32) and attention weights (P values) of a level are read
//    with 16 B and 8 B vector loads where the chunk is 16 B; the wrapper then
//    checks that all three inputs are 16 B aligned.
//  - A head whose width is not a multiple of 16 B takes one-element chunks:
//    the same kernel with scalar loads.
// The sum runs over levels, points, then corners (y0,x0), (y0,x1), (y1,x0),
// (y1,x1), each as fma(w, v, acc) in f32 with w = bilinear * attention, and
// is written once in the value's type.
//
// What limits it now is a hypothesis, not a measurement: on the main path it
// takes as long as with its inputs held in L2 by back-to-back calls, so
// device memory does not limit it. Whether L1/L2 gather throughput, load
// latency or instruction issue does was not measured (no memory-unit or
// stall counters were read). For scale, 0.53 GB of corner rows in 0.065 ms
// would be about 8 TB/s of L1/L2 traffic (arithmetic, not a reading).
//
// The launch (chunk width, variant, blocks and block size) is decided by the
// wrapper's launch_plan() (odise_torch/ops/ms_deform_attn.py) and passed in;
// the entry point launches exactly that or refuses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxLevels = 8;
// The most threads a block may have (the launch plan uses 128), and the blocks
// of that size an SM must hold: at most 85 registers a thread, 24 warps.
constexpr int kBlockThreads = 128;
constexpr int kMinBlocksPerSM = 6;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 bf16x2(unsigned bits) {
  __nv_bfloat162 v;
  *reinterpret_cast<unsigned*>(&v) = bits;
  return __bfloat1622float2(v);
}

__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// VEC consecutive elements of T: one load, a select to zero, VEC f32
// multiply-adds, one store.
template <typename T, int VEC>
struct Chunk;

template <>
struct Chunk<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw load_shared(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ Raw keep(bool k, Raw r) {
    return k ? r : make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void fma(float w, Raw r, float* acc) {
    acc[0] = fmaf(w, __uint_as_float(r.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(r.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(r.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(r.w), acc[3]);
  }
  static __device__ __forceinline__ void store(float* o, const float* acc) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw load_shared(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ Raw keep(bool k, Raw r) {
    return k ? r : make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void fma(float w, Raw r, float* acc) {
    const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf16x2(words[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* o, const float* acc) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(bf16x2_bits(acc[0], acc[1]), bf16x2_bits(acc[2], acc[3]),
                   bf16x2_bits(acc[4], acc[5]), bf16x2_bits(acc[6], acc[7]));
  }
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = bf16x2(words[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

template <typename T>
struct Chunk<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return to_f32(*p); }
  static __device__ __forceinline__ Raw load_shared(const T* p) { return to_f32(*p); }
  static __device__ __forceinline__ Raw keep(bool k, Raw r) { return k ? r : 0.f; }
  static __device__ __forceinline__ void fma(float w, Raw r, float* acc) {
    acc[0] = fmaf(w, r, acc[0]);
  }
  static __device__ __forceinline__ void store(T* o, const float* acc) {
    o[0] = from_f32<T>(acc[0]);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* f) { f[0] = r; }
};

// The G points' (x, y) and attention weights from position s0 on.
template <int G, bool VEC_IN>
__device__ __forceinline__ void load_xy(const float* p, float* xy) {
  if constexpr (VEC_IN && (2 * G) % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2 * G; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      xy[i] = v.x; xy[i + 1] = v.y; xy[i + 2] = v.z; xy[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) xy[i] = __ldg(p + i);
  }
}

template <int G, bool VEC_IN>
__device__ __forceinline__ void load_attn(const float* p, float* a) {
  if constexpr (VEC_IN && G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) a[i] = __ldg(p + i);
  }
}

template <int G, bool VEC_IN>
__device__ __forceinline__ void load_attn(const __nv_bfloat16* p, float* a) {
  if constexpr (VEC_IN && G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i));
      const float2 lo = bf16x2(v.x), hi = bf16x2(v.y);
      a[i] = lo.x; a[i + 1] = lo.y; a[i + 2] = hi.x; a[i + 3] = hi.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) a[i] = to_f32(p[i]);
  }
}

// VEC: elements per chunk (16 B worth, or 1). LT, PT: levels and points per
// level when they are known at compile time (the main path's 3 and 4), else
// 0 and `lv.n`, `P` are read. Known counts let the level loop unroll, so the
// next level's locations are loaded while this level's gathers are in flight.
template <typename T, int VEC, int LT, int PT>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksPerSM)
ms_deform_attn_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const T* __restrict__ attn, T* __restrict__ out,
                          int64_t n_threads, int Lv, int Lq, int H, int D,
                          int P_arg, Levels lv) {
  using C = Chunk<T, VEC>;
  constexpr int G = PT > 0 ? PT : 1;  // points whose loads are issued together
  constexpr bool VEC_IN = PT > 0 && VEC > 1;  // inputs are 16 B aligned
  const int P = PT > 0 ? PT : P_arg;
  const int n_levels = LT > 0 ? LT : lv.n;

  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  // t = ((b * Lq + q) * H + h) * chunks + c
  const int chunks = D / VEC;
  const int64_t qh = t / chunks;
  const int c = (int)(t - qh * chunks);
  const int h = (int)(qh % H);
  const int64_t b = qh / H / Lq;
  const int n_samples = n_levels * P;
  const float* loc_q = loc + qh * n_samples * 2;
  const T* attn_q = attn + qh * n_samples;
  const int64_t row_stride = (int64_t)H * D;  // elements between value rows
  const T* value_bhc = value + b * Lv * row_stride + (int64_t)h * D + c * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

#pragma unroll(LT > 0 ? LT : 1)
  for (int l = 0; l < n_levels; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const T* v_l = value_bhc + (int64_t)lv.start[l] * row_stride;
    for (int p0 = 0; p0 < P; p0 += G) {
      const int s0 = l * P + p0;
      float xy[2 * G];
      float a[G];
      load_xy<G, VEC_IN>(loc_q + 2 * s0, xy);
      load_attn<G, VEC_IN>(attn_q + s0, a);
      typename C::Raw raw[G][4];
      float wt[G][4];
      bool in[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float x = xy[2 * g] * (float)wl - 0.5f;
        const float y = xy[2 * g + 1] * (float)hl - 0.5f;
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        // some corner lies inside the level; false for NaN and for values
        // too large for an int, which are then never converted
        const bool near = x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
                          y0f <= (float)(hl - 1);
        const int x0 = (int)(near ? x0f : 0.f);
        const int y0 = (int)(near ? y0f : 0.f);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const bool x0_in = near && x0 >= 0;
        const bool x1_in = near && x0 + 1 <= wl - 1;
        const bool y0_in = near && y0 >= 0;
        const bool y1_in = near && y0 + 1 <= hl - 1;
        const int64_t cx0 = (int64_t)max(x0, 0) * row_stride;
        const int64_t cx1 = (int64_t)min(x0 + 1, wl - 1) * row_stride;
        const T* r0 = v_l + (int64_t)max(y0, 0) * wl * row_stride;
        const T* r1 = v_l + (int64_t)min(y0 + 1, hl - 1) * wl * row_stride;
        raw[g][0] = C::load(r0 + cx0);
        raw[g][1] = C::load(r0 + cx1);
        raw[g][2] = C::load(r1 + cx0);
        raw[g][3] = C::load(r1 + cx1);
        in[g][0] = y0_in && x0_in;
        in[g][1] = y0_in && x1_in;
        in[g][2] = y1_in && x0_in;
        in[g][3] = y1_in && x1_in;
        wt[g][0] = in[g][0] ? (1.f - fx) * (1.f - fy) * a[g] : 0.f;
        wt[g][1] = in[g][1] ? fx * (1.f - fy) * a[g] : 0.f;
        wt[g][2] = in[g][2] ? (1.f - fx) * fy * a[g] : 0.f;
        wt[g][3] = in[g][3] ? fx * fy * a[g] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < 4; ++k) C::fma(wt[g][k], C::keep(in[g][k], raw[g][k]), acc);
      }
    }
  }

  C::store(out + t * VEC, acc);
}

// Backward. Replaces the VJP of the TPU kernel's custom_vjp,
// `_bwd` in odise_tpu/ops/pallas/ms_deform_attn_kernel.py:285 (jax.vjp of
// the XLA `_hybrid_impl`). For the forward's out[b,q,h,c] it computes, from
// grad_out g[b,q,h,c]:
//   grad_value[b, corner, h, c]  += a * w_corner * g
//   grad_attn[b,q,h,l,p]          = sum_c g * bilinear(value_l, loc)
//   grad_loc[b,q,h,l,p,(x, y)]    = a * (w_l, h_l) * sum_c g * d bilinear / d(fx, fy)
// where fx = x - floor(x), x = loc_x * w_l - 0.5 (so d/d loc_x carries w_l),
// and a corner outside the level is a zero value: it adds exactly 0 to
// every gradient, as in the forward.
//
// What bounds it on an H100. At the training path's shapes (B = 2, 21504
// queries, 8 heads of 32 bf16 channels, levels 32^2, 64^2, 128^2 of 4
// points) it must read value, locations, weights and grad_out once and
// write the three gradients once: 148.6 MB, 0.0444 ms at 3.35 TB/s. Its
// float32 arithmetic is less (2.06 GFLOP, 0.031 ms at 67 TFLOP/s;
// chip_smoke.py's backward_bound_ms counts both on the run's own inputs).
// So the floor is bytes. But grad_value is a scatter: each of the 4.13 M
// samples adds 32 float32 values to each of its 4 corner rows. Done in
// device memory with one red.global.add.v4.f32 per 4 channels, that is
// 132.1 M reductions into a 44 MB float32 scratch, and per head and level
// the 344,064 corner hits land on 1,024, 4,096 and 16,384 rows of the
// 32^2, 64^2 and 128^2 levels: 336, 84 and 21 reductions on each row, which
// L2 serialises. A kernel that did so took 1.53 ms in place, 36x the bound,
// and its time followed the count of reductions (a quarter of the
// instructions, scalar atomics to v4, made it 4x faster).
//
// The design: sum the value gradient on chip, so that global reductions
// are only a flush.
//  - A block owns one (batch, head) and a run of `queries` consecutive
//    queries (256 on the main path), and first copies the run's grad_out of
//    that head into shared memory. A thread owns a 16 B chunk (or one
//    element) of the head, as in the forward, and walks the run in passes
//    of blockDim / lanes queries. Per sample it forms the four corners' dot
//    products with grad_out over its chunk (4 FMAs a channel); a head's
//    chunks, padded to a power of two lanes of one warp, sum them by
//    __shfl_xor_sync, and the weight and location gradients follow from
//    the four sums (the bound's 8 operations a sample and channel).
//  - The block takes the box (rows and columns) of every corner of its
//    run's samples that lies inside each level, in one pass over the
//    locations before the first level: a min/max, __reduce_*_sync per warp,
//    shared atomics across warps. So the window is right for any query
//    order and any offsets. Then levels go one after another, each in three
//    steps between barriers. (1) The block empties the lists of a window of
//    at most `window_rows` rows over the level's box (6,880 on the main
//    path, as many as leave an SM room for 3 blocks: the 32^2 and 64^2
//    levels fit whole); a box larger than that is cut to its first rows
//    (or, wider than the window, to its first columns of its first row).
//    (2) For each corner in the window one of the query's lanes links
//    (query, a * w) into that row's list, in the entry the sample and
//    corner own: one native integer atomicExch on the row's head, no float
//    atomic. A corner outside the window goes straight to the float32
//    scratch with a global vector reduction: one path, no fallback.
//    (3) One thread per chunk of each touched row walks the row's list,
//    sums a * w * g in registers (g from shared memory) and adds the sum to
//    the scratch once: one red.global.add.v4.f32 per 4 channels.
//    In the encoder a run of queries is a strip of pixels of one level and
//    its samples lie within a few pixels of the strip at each level
//    (reference points at pixel centres, offsets initialised on rings of 1
//    to 4 pixels), so the box is small, and a row takes one reduction from
//    each block whose window it is in instead of one for each corner.
//  - Why lists and not a window of float sums: sm_90 has no shared-memory
//    float add; atomicAdd on a shared float compiles to a compare-and-swap
//    loop (ATOMS.CAST.SPIN), 32 of them per corner, run one after another.
//    A first version summed that way and was no faster than reducing every
//    corner in device memory, though its global reductions fell 8x.
//  - Two points issue their 8 corner loads together (an odd last point
//    masks the other); at most 85 registers a thread, so that an SM holds
//    3 blocks of 256 threads. Locations are tested in float before any int
//    conversion, so far-out or NaN samples add exactly 0 and never reach
//    the box.
//  - Rows written by several blocks need a reduction, so the value
//    gradient stays a float32 scratch, cast once by the wrapper.
//  - Tensor cores and TMA have no role: there is no matrix product, and the
//    gathers are not the limit (the forward does the same ones in 0.128 ms).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 8;
// PERF.md). On the training path's inputs: 13.9 M global reductions instead
// of 125.0 M (every level summed on chip), 0.48 ms a launch in place in a
// train step against 1.53 ms in the same run for the kernel that reduced
// every corner in device memory, 11x the bound.
//
// The counting instantiation (kCount) adds up what it did with the value
// gradient: list links, corners reduced in global memory and rows flushed
// per level, and global reductions. chip_smoke.py and the card tests hold
// these to the host's count (backward_counts in
// odise_torch/ops/ms_deform_attn.py), which takes the box from the same
// float32 pixel coordinates, rounded the same way.
//
// Launch: blocks = B * ceil(Lq / queries) * H, head fastest; the plan
// (backward_plan) gives block size, queries a block, window rows and the
// dynamic shared memory, and the entry point refuses a plan it cannot run.

// The most threads a block may have, and the blocks of that size an SM must
// hold: at most 85 registers a thread, 24 warps.
constexpr int kBwdMaxThreads = 256;
constexpr int kBwdMinBlocksPerSM = 3;
// the shared memory a block may have on sm_90 (227 KB)
constexpr int kMaxSharedBytes = 232448;
// a list entry packs the next entry and the query into 16 bits each
constexpr int kNoEntry = 0xffff;
constexpr int kMaxEntries = kNoEntry;

// loc * size - 0.5, each step rounded (never contracted into one fma), as
// the host computes it in float32
__device__ __forceinline__ float pixel_coord(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

// a run's list entries at one level: one for each corner of each sample,
// entry ((query in the run * P + point) * 4 + corner)
__host__ __device__ inline int64_t bwd_entries(int queries, int P) {
  return (int64_t)queries * P * 4;
}

// the run's grad_out of one head (D elements of `elem` bytes a query)
__host__ __device__ inline int64_t bwd_grad_bytes(int queries, int D, int elem) {
  return ((int64_t)queries * D * elem + 15) / 16 * 16;
}

// a box of each level, the run's grad_out, the rows' list heads (padded to
// 8 B), the entries
__host__ __device__ inline int64_t bwd_smem_bytes(int window_rows, int queries, int P, int D,
                                                  int elem) {
  return 4 * kMaxLevels * (int64_t)sizeof(int) + bwd_grad_bytes(queries, D, elem) +
         (int64_t)((window_rows + 1) & ~1) * sizeof(int) +
         bwd_entries(queries, P) * (int64_t)sizeof(int2);
}

// kCount: the same kernel that also adds to `counts` what it did with the
// value gradient: [0] global reduction instructions, then for each level
// the corners linked into lists, the corners reduced in global memory and
// the rows flushed (kBwdCounts). The production instantiation has
// kCount = false and takes no such count.
constexpr int kBwdCounts = 1 + 3 * kMaxLevels;

template <typename T, int VEC, bool kCount>
__global__ void __launch_bounds__(kBwdMaxThreads, kBwdMinBlocksPerSM)
ms_deform_attn_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const T* __restrict__ attn, const T* __restrict__ grad_out,
                          float* __restrict__ grad_value, float* __restrict__ grad_loc,
                          float* __restrict__ grad_attn, int B, int Lv, int Lq, int H, int D,
                          int P, int lanes, int queries, int window_rows, Levels lv,
                          unsigned long long* __restrict__ counts) {
  using C = Chunk<T, VEC>;
  // reduction instructions a thread issues for a chunk of one row
  constexpr int kReds = VEC % 4 == 0 ? VEC / 4 : VEC;
  constexpr int G = 2;  // points whose corner loads are issued together
  extern __shared__ int4 smem[];
  int* boxes = reinterpret_cast<int*>(smem);  // (ylo, yhi, xlo, xhi) of each level
  T* grad_s = reinterpret_cast<T*>(boxes + 4 * kMaxLevels);  // [queries, D]
  int* heads = reinterpret_cast<int*>(reinterpret_cast<char*>(grad_s) +
                                      bwd_grad_bytes(queries, D, sizeof(T)));
  // a window row's first entry, kNoEntry: none. entry: (next entry << 16 |
  // query in the run, a * w as float bits)
  int2* entries = reinterpret_cast<int2*>(heads + ((window_rows + 1) & ~1));

  const int n_runs = (Lq + queries - 1) / queries;
  const int h = blockIdx.x % H;
  const int run = blockIdx.x / H;
  const int b = run / n_runs;
  if (b >= B) return;  // a whole block past the plan's: no barrier is left waiting
  const int q_first = (run - b * n_runs) * queries;
  const int q_end = min(q_first + queries, Lq);
  const int per_pass = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int chunks = D / VEC;  // a head's chunks, no more than `lanes`
  const int c = lane < chunks ? lane : 0;
  const int n_samples = lv.n * P;
  const int64_t row_stride = (int64_t)H * D;  // elements between value rows
  const int64_t head_off = (int64_t)b * Lv * row_stride + (int64_t)h * D;
  // grad_out of the run's first query, this head
  const T* grad_out_run = grad_out + ((int64_t)b * Lq + q_first) * row_stride + (int64_t)h * D;

  if (threadIdx.x < 4 * kMaxLevels) boxes[threadIdx.x] = (threadIdx.x & 1) ? INT_MIN : INT_MAX;
  // the run's grad_out of this head into shared memory, read again by the
  // passes and the flush
  for (int i = threadIdx.x; i < (q_end - q_first) * chunks; i += blockDim.x) {
    const int q = i / chunks;
    const int64_t off = (int64_t)q * row_stride + (i - q * chunks) * VEC;
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(grad_s + q * D + (i - q * chunks) * VEC) =
          C::load(grad_out_run + off);
    } else {
      grad_s[i] = grad_out_run[off];
    }
  }
  __syncthreads();

  // the box (rows and columns) of the run's corners inside each level
  {
    int bx[kMaxLevels][4];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      bx[l][0] = bx[l][2] = INT_MAX;
      bx[l][1] = bx[l][3] = INT_MIN;
    }
    for (int i = threadIdx.x; i < (q_end - q_first) * P; i += blockDim.x) {
      const int q = q_first + i / P;
      const float* lp = loc + ((((int64_t)b * Lq + q) * H + h) * n_samples + i % P) * 2;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l >= lv.n) break;
        const int hl = lv.h[l], wl = lv.w[l];
        const float x0f = floorf(pixel_coord(__ldg(lp + 2 * l * P), wl));
        const float y0f = floorf(pixel_coord(__ldg(lp + 2 * l * P + 1), hl));
        if (x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f && y0f <= (float)(hl - 1)) {
          const int x0 = (int)x0f, y0 = (int)y0f;
          bx[l][0] = min(bx[l][0], max(y0, 0));
          bx[l][1] = max(bx[l][1], min(y0 + 1, hl - 1));
          bx[l][2] = min(bx[l][2], max(x0, 0));
          bx[l][3] = max(bx[l][3], min(x0 + 1, wl - 1));
        }
      }
    }
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= lv.n) break;
      const int ylo = __reduce_min_sync(0xffffffffu, bx[l][0]);
      const int yhi = __reduce_max_sync(0xffffffffu, bx[l][1]);
      const int xlo = __reduce_min_sync(0xffffffffu, bx[l][2]);
      const int xhi = __reduce_max_sync(0xffffffffu, bx[l][3]);
      if ((threadIdx.x & 31) == 0) {
        atomicMin(boxes + 4 * l, ylo);
        atomicMax(boxes + 4 * l + 1, yhi);
        atomicMin(boxes + 4 * l + 2, xlo);
        atomicMax(boxes + 4 * l + 3, xhi);
      }
    }
  }
  __syncthreads();

  for (int l = 0; l < lv.n; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int64_t level_row = (int64_t)b * Lv + lv.start[l];
    // this thread's counts at this level (kCount only)
    unsigned long long n_red = 0, n_linked = 0, n_direct = 0, n_rows = 0;
    const int* box = boxes + 4 * l;
    const int wy = box[0], wx = box[2];
    const int bh = box[1] >= box[0] ? box[1] - box[0] + 1 : 0;
    const int bw = box[3] >= box[2] ? box[3] - box[2] + 1 : 0;
    const int ww = min(bw, window_rows);
    const int wh = ww > 0 ? min(bh, window_rows / ww) : 0;
    const int rows = wh * ww;

    // (1) empty the window's lists
    for (int i = threadIdx.x; i < rows; i += blockDim.x) heads[i] = kNoEntry;
    __syncthreads();

    // (2) the samples of this level
    for (int q0 = q_first; q0 < q_end; q0 += per_pass) {
      const int q = q0 + (int)threadIdx.x / lanes;
      const bool active = q < q_end && lane < chunks;
      // inactive lanes read the run's first query and add nothing
      const int q_run = active ? q - q_first : 0;
      const int64_t qh = ((int64_t)b * Lq + q_first + q_run) * H + h;
      float g[VEC];
      C::unpack(C::keep(active, C::load_shared(grad_s + q_run * D + c * VEC)), g);
      const float* loc_q = loc + qh * n_samples * 2;
      const T* attn_q = attn + qh * n_samples;
      const T* v_l = value + head_off + lv.start[l] * row_stride + c * VEC;

      for (int p0 = 0; p0 < P; p0 += G) {
        int y0[G], x0[G];
        float fx[G], fy[G], a[G];
        float d_attn[G], d_x[G], d_y[G];  // the points' weight and location gradients
        bool near[G];
        typename C::Raw raw[G][4];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const bool real = p0 + k < P;
          const int s = l * P + (real ? p0 + k : 0);
          const float x = pixel_coord(__ldg(loc_q + 2 * s), wl);
          const float y = pixel_coord(__ldg(loc_q + 2 * s + 1), hl);
          a[k] = to_f32(attn_q[s]);
          const float x0f = floorf(x);
          const float y0f = floorf(y);
          near[k] = active && real && x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
                    y0f <= (float)(hl - 1);
          x0[k] = (int)(near[k] ? x0f : 0.f);
          y0[k] = (int)(near[k] ? y0f : 0.f);
          // 0 far out, so that no infinity or NaN of a location reaches a sum
          fx[k] = near[k] ? x - x0f : 0.f;
          fy[k] = near[k] ? y - y0f : 0.f;
          const int64_t cx0 = (int64_t)max(x0[k], 0) * row_stride;
          const int64_t cx1 = (int64_t)min(x0[k] + 1, wl - 1) * row_stride;
          const T* r0 = v_l + (int64_t)max(y0[k], 0) * wl * row_stride;
          const T* r1 = v_l + (int64_t)min(y0[k] + 1, hl - 1) * wl * row_stride;
          raw[k][0] = C::load(r0 + cx0);
          raw[k][1] = C::load(r0 + cx1);
          raw[k][2] = C::load(r1 + cx0);
          raw[k][3] = C::load(r1 + cx1);
        }
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const bool x0_in = near[k] && x0[k] >= 0;
          const bool x1_in = near[k] && x0[k] + 1 <= wl - 1;
          const bool y0_in = near[k] && y0[k] >= 0;
          const bool y1_in = near[k] && y0[k] + 1 <= hl - 1;
          const bool in[4] = {y0_in && x0_in, y0_in && x1_in, y1_in && x0_in, y1_in && x1_in};
          const float w[4] = {(1.f - fx[k]) * (1.f - fy[k]), fx[k] * (1.f - fy[k]),
                              (1.f - fx[k]) * fy[k], fx[k] * fy[k]};
          // the corners' dot products with grad_out over this chunk; the
          // weight and location gradients are sums of them
          float dot[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v[VEC];
            C::unpack(C::keep(in[j], raw[k][j]), v);
            dot[j] = 0.f;
#pragma unroll
            for (int i = 0; i < VEC; ++i) dot[j] = fmaf(g[i], v[i], dot[j]);
          }
          // corners in the window: a list entry each, corner j linked by lane
          // j % lanes of the query; the others: this chunk's global reduction
          int in_window = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (!in[j]) continue;
            const int cy = y0[k] + (j >> 1);
            const int cx = x0[k] + (j & 1);
            if ((unsigned)(cy - wy) < (unsigned)wh && (unsigned)(cx - wx) < (unsigned)ww) {
              in_window |= 1 << j;
              continue;
            }
            if constexpr (kCount) {
              n_red += kReds;
              n_direct += lane == 0;
            }
            const float wa = w[j] * a[k];
            float* dst = grad_value + ((level_row + (int64_t)cy * wl + cx) * H + h) * D + c * VEC;
#pragma unroll
            for (int i = 0; i < VEC; i += (VEC % 4 == 0 ? 4 : 1)) {
              if constexpr (VEC % 4 == 0) {
                // one vector reduction for 4 channels (sm_90); the scratch
                // row and the chunk start on 16-byte boundaries
                asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst + i),
                             "f"(wa * g[i]), "f"(wa * g[i + 1]), "f"(wa * g[i + 2]),
                             "f"(wa * g[i + 3])
                             : "memory");
              } else {
                atomicAdd(dst + i, wa * g[i]);
              }
            }
          }
          if (lane < 4) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // j % chunks: an active lane (with 3 chunks, lane 3 pads)
              if (!(in_window >> j & 1) || j % chunks != lane) continue;
              if constexpr (kCount) ++n_linked;
              const int r = (y0[k] + (j >> 1) - wy) * ww + x0[k] + (j & 1) - wx;
              const int e = (q_run * P + p0 + k) * 4 + j;
              const int next = atomicExch(heads + r, e);
              entries[e] = make_int2((int)((unsigned)next << 16 | (unsigned)q_run),
                                     __float_as_int(w[j] * a[k]));
            }
          }
          for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int j = 0; j < 4; ++j) dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
          }
          d_attn[k] = w[0] * dot[0] + w[1] * dot[1] + w[2] * dot[2] + w[3] * dot[3];
          d_x[k] = a[k] * (float)wl *
                   ((1.f - fy[k]) * (dot[1] - dot[0]) + fy[k] * (dot[3] - dot[2]));
          d_y[k] = a[k] * (float)hl *
                   ((1.f - fx[k]) * (dot[2] - dot[0]) + fx[k] * (dot[3] - dot[1]));
        }
        if (active && lane == 0) {
          const int64_t out = qh * n_samples + l * P + p0;
          if (P % 2 == 0) {  // out is even: 8 and 16 B aligned
            *reinterpret_cast<float2*>(grad_attn + out) = make_float2(d_attn[0], d_attn[1]);
            *reinterpret_cast<float4*>(grad_loc + 2 * out) =
                make_float4(d_x[0], d_y[0], d_x[1], d_y[1]);
          } else {
#pragma unroll
            for (int k = 0; k < G; ++k) {
              if (p0 + k >= P) break;
              grad_attn[out + k] = d_attn[k];
              grad_loc[2 * (out + k)] = d_x[k];
              grad_loc[2 * (out + k) + 1] = d_y[k];
            }
          }
        }
      }
    }
    __syncthreads();

    // (3) flush: each chunk of each touched row summed once, then added to
    // the float32 scratch
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks;
      int e = heads[r];
      if (e == kNoEntry) continue;
      const int cc = i - r * chunks;
      float acc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      // the next entry is loaded while this one's grad_out is read
      int2 entry = entries[e];
      while (true) {
        e = (unsigned)entry.x >> 16;
        const int2 next = entries[e == kNoEntry ? 0 : e];
        float gq[VEC];
        C::unpack(C::load_shared(grad_s + (entry.x & 0xffff) * D + cc * VEC), gq);
        const float wa = __int_as_float(entry.y);
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[t] = fmaf(wa, gq[t], acc[t]);
        if (e == kNoEntry) break;
        entry = next;
      }
      if constexpr (kCount) {
        n_red += kReds;
        n_rows += cc == 0;
      }
      const int64_t row = level_row + (int64_t)(wy + r / ww) * wl + wx + r % ww;
      float* dst = grad_value + (row * H + h) * D + cc * VEC;
#pragma unroll
      for (int t = 0; t < VEC; t += (VEC % 4 == 0 ? 4 : 1)) {
        if constexpr (VEC % 4 == 0) {
          asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst + t),
                       "f"(acc[t]), "f"(acc[t + 1]), "f"(acc[t + 2]), "f"(acc[t + 3])
                       : "memory");
        } else {
          atomicAdd(dst + t, acc[t]);
        }
      }
    }
    if constexpr (kCount) {
      const unsigned long long n[4] = {n_red, n_linked, n_direct, n_rows};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n[i]) atomicAdd(counts + (i == 0 ? 0 : 1 + 3 * l + i - 1), n[i]);
    }
    __syncthreads();
  }
}

template <typename T, int VEC>
const void* bwd_variant(bool counted) {
  return counted ? (const void*)ms_deform_attn_bwd_kernel<T, VEC, true>
                 : (const void*)ms_deform_attn_bwd_kernel<T, VEC, false>;
}

// The backward kernel for a dtype and a chunk width, counting or not, or
// null if there is none.
const void* bwd_kernel_for(int dtype, int vec, bool counted) {
  if (dtype == 0 && vec == 1) return bwd_variant<float, 1>(counted);
  if (dtype == 0 && vec == 4) return bwd_variant<float, 4>(counted);
  if (dtype == 1 && vec == 1) return bwd_variant<__nv_bfloat16, 1>(counted);
  if (dtype == 1 && vec == 8) return bwd_variant<__nv_bfloat16, 8>(counted);
  return nullptr;
}

// A head's lanes: its chunk count rounded up to a power of two, or 0 where
// that exceeds a warp.
int bwd_lanes(int chunks) {
  int lanes = 1;
  while (lanes < chunks) lanes *= 2;
  return lanes <= 32 ? lanes : 0;
}

template <typename T, int VEC>
const void* variant(int specialised) {
  return specialised ? (const void*)ms_deform_attn_fwd_kernel<T, VEC, 3, 4>
                     : (const void*)ms_deform_attn_fwd_kernel<T, VEC, 0, 0>;
}

// The kernel for a dtype (0 float32, 1 bfloat16), a chunk width in elements
// and a variant (1: 3 levels of 4 points at compile time, 0: any counts), or
// null if there is none.
const void* kernel_for(int dtype, int vec, int specialised) {
  if (dtype == 0 && vec == 1) return variant<float, 1>(specialised);
  if (dtype == 0 && vec == 4) return variant<float, 4>(specialised);
  if (dtype == 1 && vec == 1) return variant<__nv_bfloat16, 1>(specialised);
  if (dtype == 1 && vec == 8) return variant<__nv_bfloat16, 8>(specialised);
  return nullptr;
}

}  // namespace

// C entry points, loaded with ctypes. They return a cudaError_t.
//
// ms_deform_attn_forward launches the kernel on `stream` as the wrapper's
// launch plan says: `vec` elements a chunk (16 bytes' worth, then value, loc
// and attn must be 16 B aligned, or 1), the `specialised` variant (only for 3
// levels of 4 points) or the generic one, `blocks` blocks of `block_threads`.
// It refuses a plan that does not cover the output or that the kernel was not
// compiled for. Pointers are device pointers except `level_hws`, a host array
// of 3 * n_levels ints: (h, w, start row) per level. `dtype` is 0 for float32
// and 1 for bfloat16 (value, attention and output share it; locations are
// always float32).
extern "C" int ms_deform_attn_forward(const void* value, const void* loc,
                                      const void* attn, void* out, int B,
                                      int Lv, int Lq, int H, int D,
                                      int n_levels, int P,
                                      const void* level_hws, int dtype, int vec,
                                      int specialised, int blocks,
                                      int block_threads, void* stream) {
  const void* kernel = kernel_for(dtype, vec, specialised);
  if (kernel == nullptr || n_levels < 1 || n_levels > kMaxLevels || P < 1 ||
      (specialised && (n_levels != 3 || P != 4)) || D % vec != 0 ||
      block_threads < 1 || block_threads > kBlockThreads)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  const int* hws = static_cast<const int*>(level_hws);
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hws[3 * l];
    lv.w[l] = hws[3 * l + 1];
    lv.start[l] = hws[3 * l + 2];
  }
  int64_t n_threads = (int64_t)B * Lq * H * (D / vec);
  if (n_threads == 0) return (int)cudaSuccess;
  if (blocks < 1 || (int64_t)blocks * block_threads < n_threads)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&value, &loc, &attn, &out, &n_threads, &Lv, &Lq, &H, &D, &P, &lv};
  cudaGetLastError();  // clear an earlier, unrelated error
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3((unsigned)block_threads),
                               args, 0, static_cast<cudaStream_t>(stream));
}

// ms_deform_attn_backward launches the backward kernel on `stream`:
// `grad_out` is [B, Lq, H * D] in the value's dtype, 16 B aligned with value
// for `vec` > 1; `grad_value` is a zeroed float32
// [B, Lv, H, D] scratch, `grad_loc` float32 [B, Lq, H, L, P, 2] and
// `grad_attn` float32 [B, Lq, H, L, P], which it overwrites. A head takes
// D / vec chunks rounded up to a power of two lanes, which must be no more
// than 32. A block of `block_threads` (whole warps, at most kBwdMaxThreads)
// takes `queries` consecutive queries of one head, a multiple of the
// block_threads / lanes it takes in one pass, with lists for a window of
// `window_rows` rows and 4 entries a sample in dynamic shared memory (no
// more than kMaxEntries entries and kMaxSharedBytes in all); `blocks` must
// cover B * ceil(Lq / queries) * H.
// `counts`: null, or a zeroed device array of kBwdCounts uint64 to which the
// counting instantiation adds what it did (see the kernel).
// Other arguments as for the forward.
extern "C" int ms_deform_attn_backward(const void* value, const void* loc,
                                       const void* attn, const void* grad_out,
                                       void* grad_value, void* grad_loc, void* grad_attn,
                                       int B, int Lv, int Lq, int H, int D, int n_levels,
                                       int P, const void* level_hws, int dtype, int vec,
                                       int queries, int window_rows, int blocks,
                                       int block_threads, void* counts, void* stream) {
  const void* kernel = bwd_kernel_for(dtype, vec, counts != nullptr);
  if (kernel == nullptr || n_levels < 1 || n_levels > kMaxLevels || P < 1 || D % vec != 0 ||
      block_threads < 32 || block_threads > kBwdMaxThreads || block_threads % 32 != 0 ||
      window_rows < 1)
    return (int)cudaErrorInvalidValue;
  int lanes = bwd_lanes(D / vec);
  if (lanes == 0 || queries < 1 || queries % (block_threads / lanes) != 0 ||
      bwd_entries(queries, P) > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = bwd_smem_bytes(window_rows, queries, P, D, dtype == 0 ? 4 : 2);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  const int* hws = static_cast<const int*>(level_hws);
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hws[3 * l];
    lv.w[l] = hws[3 * l + 1];
    lv.start[l] = hws[3 * l + 2];
  }
  if ((int64_t)B * Lq * H == 0) return (int)cudaSuccess;
  if (blocks < (int64_t)B * ((Lq + queries - 1) / queries) * H) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier, unrelated error
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&value, &loc,     &attn, &grad_out, &grad_value, &grad_loc,    &grad_attn, &B,
                  &Lv,    &Lq,      &H,    &D,        &P,          &lanes,       &queries,
                  &window_rows, &lv, &counts};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3((unsigned)block_threads),
                               args, (size_t)smem, static_cast<cudaStream_t>(stream));
}

// ms_deform_attn_backward_occupancy: as ms_deform_attn_occupancy, for the
// backward kernel of a dtype and chunk width with the dynamic shared memory
// of a plan's window rows and queries a block at P points a level.
extern "C" int ms_deform_attn_backward_occupancy(int dtype, int vec, int D, int window_rows,
                                                 int queries, int P, int block_threads,
                                                 int* blocks_per_sm) {
  const void* kernel = bwd_kernel_for(dtype, vec, false);
  const int64_t smem = bwd_smem_bytes(window_rows, queries, P, D, dtype == 0 ? 4 : 2);
  if (kernel == nullptr || block_threads < 1 || block_threads > kBwdMaxThreads ||
      window_rows < 1 || bwd_entries(queries, P) > kMaxEntries || smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                            block_threads, (size_t)smem);
}

// ms_deform_attn_occupancy writes to `blocks_per_sm` how many blocks of
// `block_threads` threads of a variant an SM of the current device holds.
extern "C" int ms_deform_attn_occupancy(int dtype, int vec, int specialised,
                                        int block_threads, int* blocks_per_sm) {
  const void* kernel = kernel_for(dtype, vec, specialised);
  if (kernel == nullptr || block_threads < 1 || block_threads > kBlockThreads)
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                            block_threads, 0);
}
