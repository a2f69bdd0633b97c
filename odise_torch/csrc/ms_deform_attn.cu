// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_level_gather` in
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
// What bounds it on an H100. At the main path's shapes (levels 128^2, 64^2,
// 32^2; 21504 queries, 8 heads of 32 channels, 4 points, bf16 values and
// weights, f32 locations) one call must move about 43 MB through device
// memory: value 11.0 MB, locations 16.5 MB, attention 4.1 MB, output 11.0 MB,
// about 13 us at 3.35 TB/s. Its arithmetic (12 samples x 4 corners x 32
// channels of f32 fused multiply-adds per query and head, about 0.53 GFLOP)
// is about 8 us at the 67 TFLOP/s of f32 outside the tensor cores. So the
// floor is memory traffic. In practice the gathers decide: about 8.3 M corner
// rows of 64 B (0.53 GB) are read at data-dependent addresses. The 11 MB value
// table fits in the 50 MB L2, so most of those reads should hit L2, and the
// kernel is bound by L2 gather throughput and by the latency of dependent
// loads rather than by HBM.
//
// What this first design does about it. One warp per (b, q, head); lane c
// owns channel c (a loop covers head_dim other than 32), so each bilinear
// corner is one coalesced 64 B row read (bf16) by the warp. Every lane
// computes the corner weights itself from the same broadcast location load,
// in f32, with the same formulas as `_level_idx_w4`; a sample whose corners
// all fall outside its level is skipped before any value load. The sum is
// kept in f32 and written once in the value's type. Nothing is staged in
// shared memory, loads are 2 or 4 B per lane, and each warp walks its 12
// samples in order; shared-memory staging, 16 B vector loads and several
// queries per warp are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;

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

template <typename T>
__global__ void ms_deform_attn_fwd_kernel(const T* __restrict__ value,
                                          const float* __restrict__ loc,
                                          const T* __restrict__ attn,
                                          T* __restrict__ out, int64_t n_warps,
                                          int Lv, int Lq, int H, int D, int P,
                                          Levels lv) {
  const int64_t warp =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;

  // warp = (b * Lq + q) * H + h
  const int h = (int)(warp % H);
  const int64_t b = warp / H / Lq;
  const int n_samples = lv.n * P;
  const float* loc_w = loc + warp * n_samples * 2;
  const T* attn_w = attn + warp * n_samples;
  const int64_t row_stride = (int64_t)H * D;  // elements between value rows
  const T* value_bh = value + b * Lv * row_stride + (int64_t)h * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < D;
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const T* v_l = value_bh + (int64_t)lv.start[l] * row_stride + c;
      for (int p = 0; p < P; ++p) {
        const int s = l * P + p;
        const float x = loc_w[2 * s] * (float)wl - 0.5f;
        const float y = loc_w[2 * s + 1] * (float)hl - 0.5f;
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        // all four corners outside the level (this also rejects NaN and
        // values too large for an int)
        if (!(x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
              y0f <= (float)(hl - 1)))
          continue;
        const float a = to_f32(attn_w[s]);
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const float fx = x - x0f;
        const float fy = y - y0f;
        const bool x0_in = x0 >= 0;
        const bool x1_in = x0 + 1 <= wl - 1;
        const bool y0_in = y0 >= 0;
        const bool y1_in = y0 + 1 <= hl - 1;
        if (!live) continue;
        if (y0_in) {
          const T* row = v_l + (int64_t)y0 * wl * row_stride;
          if (x0_in)
            acc += (1.f - fx) * (1.f - fy) * a * to_f32(row[(int64_t)x0 * row_stride]);
          if (x1_in)
            acc += fx * (1.f - fy) * a * to_f32(row[(int64_t)(x0 + 1) * row_stride]);
        }
        if (y1_in) {
          const T* row = v_l + (int64_t)(y0 + 1) * wl * row_stride;
          if (x0_in)
            acc += (1.f - fx) * fy * a * to_f32(row[(int64_t)x0 * row_stride]);
          if (x1_in)
            acc += fx * fy * a * to_f32(row[(int64_t)(x0 + 1) * row_stride]);
        }
      }
    }
    if (live) out[warp * D + c] = from_f32<T>(acc);
  }
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers except
// `level_hws`, a host array of 3 * n_levels ints: (h, w, start row) per
// level. `dtype` is 0 for float32 and 1 for bfloat16 (value, attention and
// output share it; locations are always float32). Returns the
// cudaGetLastError() of the launch.
extern "C" int ms_deform_attn_forward(const void* value, const void* loc,
                                      const void* attn, void* out, int B,
                                      int Lv, int Lq, int H, int D,
                                      int n_levels, int P,
                                      const void* level_hws, int dtype,
                                      void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  const int* hws = static_cast<const int*>(level_hws);
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hws[3 * l];
    lv.w[l] = hws[3 * l + 1];
    lv.start[l] = hws[3 * l + 2];
  }
  const int64_t n_warps = (int64_t)B * Lq * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_warps + (threads / 32) - 1) / (threads / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an earlier, unrelated error
  if (dtype == 0) {
    ms_deform_attn_fwd_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float*>(out), n_warps, Lv,
        Lq, H, D, P, lv);
  } else if (dtype == 1) {
    ms_deform_attn_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const __nv_bfloat16*>(attn),
        static_cast<__nv_bfloat16*>(out), n_warps, Lv, Lq, H, D, P, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
