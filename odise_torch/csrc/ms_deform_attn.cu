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

// Backward. Replaces the VJP of the TPU kernel's custom_vjp
// (odise_tpu/ops/pallas/ms_deform_attn_kernel.py `_bwd`, which is jax.vjp of
// the XLA `_hybrid_impl`). For the forward's out[b,q,h,c] it computes, from
// grad_out g[b,q,h,c]:
//   grad_value[b, corner, h, c]  += a * w_corner * g            (atomics)
//   grad_attn[b,q,h,l,p]          = sum_c g * bilinear(value_l, loc)
//   grad_loc[b,q,h,l,p,(x, y)]    = a * (w_l, h_l) * sum_c g * d bilinear / d(fx, fy)
// where fx = x - floor(x), x = loc_x * w_l - 0.5 (so d/d loc_x carries w_l),
// and a corner outside the level is a zero value: it adds exactly 0 to
// every gradient, as in the forward.
//
// What bounds it on an H100. At the main path's shapes (B = 2, 21504
// queries, 8 heads of 32 bf16 channels, 3 levels of 4 points) it must read
// value, locations, weights and grad_out once and write the three gradients
// once, about 149 MB, 0.044 ms at 3.35 TB/s. Its float32 arithmetic is less:
// the weight gradient and both location sums follow from the four corner
// dot products sum_c g_c v_kc (8 operations per sample and channel), and
// the value gradient takes a multiply and an add per inside corner and
// channel, about 2.1 GFLOP or 0.031 ms at 67 TFLOP/s (chip_smoke.py's
// backward_bound_ms counts both on the run's own inputs). So the floor is
// memory traffic. But grad_value is a scatter: each of the
// 2 * 21504 * 8 * 12 samples adds to 4 corner rows of 32 channels, about
// 0.53 G float32 atomic adds into a 22 MB scratch that L2 holds, so the
// atomics' throughput in L2, not device memory, is expected to decide; one
// red.global.add.v4.f32 per 4 channels instead of one scalar atomicAdd per
// channel cut the kernel's warm time 3.7x on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 8 before and after; PERF.md), which points the
// same way.
//
// Design (simple first). The forward's thread layout: one thread per 16 B
// chunk (or one element) of one head of one query; the thread loads its
// chunk of grad_out once, then walks the samples one at a time. Per sample
// it loads the 4 corner chunks (clamped rows and columns, outside corners
// zeroed by a select, as in the forward), forms its chunk's partial sums
// for the weight and the two location gradients and adds a * w_corner * g
// into the float32 scratch of each inside corner, 4 channels to one vector
// reduction where the chunk holds a multiple of 4 (else one atomicAdd per
// element). A head owns `lanes` consecutive threads of one warp, its chunk
// count rounded up to a power of two (4 for bf16 at head_dim 32, no more
// than 32); the three partial sums reduce over them with __shfl_xor_sync
// and the head's first thread stores them. Lanes past a head's last chunk,
// and past the last head, take part in the shuffles with zeros.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
ms_deform_attn_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const T* __restrict__ attn, const T* __restrict__ grad_out,
                          float* __restrict__ grad_value, float* __restrict__ grad_loc,
                          float* __restrict__ grad_attn, int64_t n_threads, int Lv,
                          int Lq, int H, int D, int P, int lanes, Levels lv) {
  using C = Chunk<T, VEC>;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = D / VEC;  // a head's chunks, no more than `lanes`
  const int64_t head = t / lanes;
  const int lane = (int)(t - head * lanes);
  const bool active = t < n_threads && lane < chunks;
  // inactive lanes read (b, q, head, chunk) = 0's inputs and add nothing
  const int64_t qh = active ? head : 0;
  const int c = active ? lane : 0;
  const int h = (int)(qh % H);
  const int64_t b = qh / H / Lq;
  const int n_samples = lv.n * P;
  const float* loc_q = loc + qh * n_samples * 2;
  const T* attn_q = attn + qh * n_samples;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_off = b * Lv * row_stride + (int64_t)h * D + c * VEC;
  const T* value_bhc = value + head_off;
  float* grad_value_bhc = grad_value + head_off;

  float g[VEC];
  C::unpack(C::keep(active, C::load(grad_out + qh * D + c * VEC)), g);

  for (int l = 0; l < lv.n; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int64_t level_off = (int64_t)lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      const float x = __ldg(loc_q + 2 * s) * (float)wl - 0.5f;
      const float y = __ldg(loc_q + 2 * s + 1) * (float)hl - 0.5f;
      const float a = to_f32(attn_q[s]);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const bool near = active && x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
                        y0f <= (float)(hl - 1);
      const int x0 = (int)(near ? x0f : 0.f);
      const int y0 = (int)(near ? y0f : 0.f);
      // 0 far out, so that no infinity or NaN of a location reaches a sum
      const float fx = near ? x - x0f : 0.f;
      const float fy = near ? y - y0f : 0.f;
      const bool x0_in = near && x0 >= 0;
      const bool x1_in = near && x0 + 1 <= wl - 1;
      const bool y0_in = near && y0 >= 0;
      const bool y1_in = near && y0 + 1 <= hl - 1;
      const int64_t cx0 = (int64_t)max(x0, 0) * row_stride;
      const int64_t cx1 = (int64_t)min(x0 + 1, wl - 1) * row_stride;
      const int64_t ry0 = level_off + (int64_t)max(y0, 0) * wl * row_stride;
      const int64_t ry1 = level_off + (int64_t)min(y0 + 1, hl - 1) * wl * row_stride;
      const int64_t off[4] = {ry0 + cx0, ry0 + cx1, ry1 + cx0, ry1 + cx1};
      const bool in[4] = {y0_in && x0_in, y0_in && x1_in, y1_in && x0_in, y1_in && x1_in};
      float v[4][VEC];
#pragma unroll
      for (int k = 0; k < 4; ++k) C::unpack(C::keep(in[k], C::load(value_bhc + off[k])), v[k]);
      const float w[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy), (1.f - fx) * fy, fx * fy};

      float part_a = 0.f, part_x = 0.f, part_y = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float sampled = w[0] * v[0][i] + w[1] * v[1][i] + w[2] * v[2][i] + w[3] * v[3][i];
        const float d_fx = (1.f - fy) * (v[1][i] - v[0][i]) + fy * (v[3][i] - v[2][i]);
        const float d_fy = (1.f - fx) * (v[2][i] - v[0][i]) + fx * (v[3][i] - v[1][i]);
        part_a = fmaf(g[i], sampled, part_a);
        part_x = fmaf(g[i], d_fx, part_x);
        part_y = fmaf(g[i], d_fy, part_y);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (in[k]) {
          float* dst = grad_value_bhc + off[k];
          const float wa = w[k] * a;
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
      }
      for (int o = lanes / 2; o > 0; o >>= 1) {
        part_a += __shfl_xor_sync(0xffffffffu, part_a, o);
        part_x += __shfl_xor_sync(0xffffffffu, part_x, o);
        part_y += __shfl_xor_sync(0xffffffffu, part_y, o);
      }
      if (active && c == 0) {
        const int64_t out = qh * n_samples + s;
        grad_attn[out] = part_a;
        grad_loc[2 * out] = a * (float)wl * part_x;
        grad_loc[2 * out + 1] = a * (float)hl * part_y;
      }
    }
  }
}

// The backward kernel for a dtype and a chunk width, or null if there is none.
const void* bwd_kernel_for(int dtype, int vec) {
  if (dtype == 0 && vec == 1) return (const void*)ms_deform_attn_bwd_kernel<float, 1>;
  if (dtype == 0 && vec == 4) return (const void*)ms_deform_attn_bwd_kernel<float, 4>;
  if (dtype == 1 && vec == 1) return (const void*)ms_deform_attn_bwd_kernel<__nv_bfloat16, 1>;
  if (dtype == 1 && vec == 8) return (const void*)ms_deform_attn_bwd_kernel<__nv_bfloat16, 8>;
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
// for `vec` > 1; `grad_value` is a zeroed float32 [B, Lv, H, D] scratch,
// `grad_loc` float32 [B, Lq, H, L, P, 2] and `grad_attn` float32
// [B, Lq, H, L, P], which it overwrites. A head takes D / vec chunks rounded
// up to a power of two lanes, which must be no more than 32; blocks are
// whole warps and cover B * Lq * H heads of such lanes. Other arguments as
// for the forward.
extern "C" int ms_deform_attn_backward(const void* value, const void* loc,
                                       const void* attn, const void* grad_out,
                                       void* grad_value, void* grad_loc, void* grad_attn,
                                       int B, int Lv, int Lq, int H, int D, int n_levels,
                                       int P, const void* level_hws, int dtype, int vec,
                                       int blocks, int block_threads, void* stream) {
  const void* kernel = bwd_kernel_for(dtype, vec);
  if (kernel == nullptr || n_levels < 1 || n_levels > kMaxLevels || P < 1 || D % vec != 0 ||
      block_threads < 1 || block_threads > kBlockThreads || block_threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int lanes = bwd_lanes(D / vec);
  if (lanes == 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  const int* hws = static_cast<const int*>(level_hws);
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hws[3 * l];
    lv.w[l] = hws[3 * l + 1];
    lv.start[l] = hws[3 * l + 2];
  }
  int64_t n_threads = (int64_t)B * Lq * H * lanes;
  if (n_threads == 0) return (int)cudaSuccess;
  if (blocks < 1 || (int64_t)blocks * block_threads < n_threads)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&value, &loc, &attn, &grad_out, &grad_value, &grad_loc, &grad_attn,
                  &n_threads, &Lv, &Lq, &H, &D, &P, &lanes, &lv};
  cudaGetLastError();  // clear an earlier, unrelated error
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3((unsigned)block_threads),
                               args, 0, static_cast<cudaStream_t>(stream));
}

// ms_deform_attn_backward_occupancy: as ms_deform_attn_occupancy, for the
// backward kernel of a dtype and chunk width.
extern "C" int ms_deform_attn_backward_occupancy(int dtype, int vec, int block_threads,
                                                 int* blocks_per_sm) {
  const void* kernel = bwd_kernel_for(dtype, vec);
  if (kernel == nullptr || block_threads < 1 || block_threads > kBlockThreads)
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                            block_threads, 0);
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
