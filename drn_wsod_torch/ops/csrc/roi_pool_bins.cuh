// Bin arithmetic and element types shared by the RoIPool kernels
// (roi_pool.cu, roi_pool_image.cu), so that the two cannot drift apart.
//
// Semantics (torchvision RoIPool, bit for bit with the JAX package's
// drn_wsod_tpu/ops/roi_align.py:roi_pool and its Pallas kernels):
//   * map coordinates are round_half_even(box * spatial_scale)
//     (__float2int_rn after a correctly rounded product, never roundf);
//   * roi_w = max(x2 - x1 + 1, 1), likewise roi_h;
//   * bin i spans [floor(i*roi/R) + start, ceil((i+1)*roi/R) + start): the
//     divisions run on non-negative operands, ceil as ((i+1)*roi + R-1)/R,
//     and a negative start is added after them;
//   * both edges are clamped to [0, size]; a bin with hi <= lo is empty.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drn_roi {

constexpr int kMaxRes = 16;

// Edges of the R bins of one RoI along y and x, written to the arrays given
// (each of at least R entries).
__device__ __forceinline__ void bin_edges(const float* box, float spatial_scale,
                                          int H, int W, int R, int* lo_y,
                                          int* hi_y, int* lo_x, int* hi_x) {
  const int x1 = __float2int_rn(__fmul_rn(box[0], spatial_scale));
  const int y1 = __float2int_rn(__fmul_rn(box[1], spatial_scale));
  const int x2 = __float2int_rn(__fmul_rn(box[2], spatial_scale));
  const int y2 = __float2int_rn(__fmul_rn(box[3], spatial_scale));
  const int roi_w = max(x2 - x1 + 1, 1);
  const int roi_h = max(y2 - y1 + 1, 1);
  for (int i = 0; i < R; ++i) {
    lo_y[i] = min(max(i * roi_h / R + y1, 0), H);
    hi_y[i] = min(max(((i + 1) * roi_h + R - 1) / R + y1, 0), H);
    lo_x[i] = min(max(i * roi_w / R + x1, 0), W);
    hi_x[i] = min(max(((i + 1) * roi_w + R - 1) / R + x1, 0), W);
  }
}

// max that propagates NaN, as jnp.maximum and torch.maximum do
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

struct F32 {
  typedef float T;
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ static float load(const T* p, int i) { return p[i]; }
  __device__ static T store(float v) { return v; }
  // a float32 value in the map's dtype, as a float
  __device__ static float cast(float s) { return s; }
};

struct BF16 {
  typedef uint16_t T;
  static constexpr int kVec = 8;
  __device__ static float load(const T* p, int i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
  }
  __device__ static T store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static float cast(float s) {
    return __bfloat162float(__float2bfloat16_rn(s));
  }
};

}  // namespace drn_roi
