// Bin arithmetic, element types and the per-bin max shared by the RoIPool
// kernels (roi_pool.cu, roi_pool_image.cu, roi_pool_banded.cu), so that they
// cannot drift apart.
//
// Semantics (torchvision RoIPool, bit for bit with the JAX package's
// drn_wsod_tpu/ops/roi_align.py:roi_pool and its Pallas kernels):
//   * map coordinates are round_half_even(box * spatial_scale)
//     (__float2int_rn after a correctly rounded product, never roundf);
//   * roi_w = max(x2 - x1 + 1, 1), likewise roi_h;
//   * bin i spans [floor(i*roi/R) + start, ceil((i+1)*roi/R) + start): the
//     divisions run on non-negative operands, ceil as ((i+1)*roi + R-1)/R,
//     and a negative start is added after them;
//   * both edges are clamped to [0, size]; a bin with hi <= lo is empty;
//   * a bin's max propagates NaN and is 0 when the bin is empty.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drn_roi {

constexpr int kMaxRes = 16;

// A RoI in map cells: its first column and row and its width and height.
struct Cells {
  int x1, y1, w, h;
};

__device__ __forceinline__ Cells roi_cells(const float* box,
                                           float spatial_scale) {
  const int x1 = __float2int_rn(__fmul_rn(box[0], spatial_scale));
  const int y1 = __float2int_rn(__fmul_rn(box[1], spatial_scale));
  const int x2 = __float2int_rn(__fmul_rn(box[2], spatial_scale));
  const int y2 = __float2int_rn(__fmul_rn(box[3], spatial_scale));
  return Cells{x1, y1, max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)};
}

// Edges [lo, hi) of bin i of R along an axis of `size` cells, for a RoI
// that starts at cell `start` and spans `roi` cells.
__device__ __forceinline__ void bin_range(int start, int roi, int i, int R,
                                          int size, int* lo, int* hi) {
  *lo = min(max(i * roi / R + start, 0), size);
  *hi = min(max(((i + 1) * roi + R - 1) / R + start, 0), size);
}

// Edges of the R bins of one RoI along y and x, written to the arrays given
// (each of at least R entries).
__device__ __forceinline__ void bin_edges(const float* box, float spatial_scale,
                                          int H, int W, int R, int* lo_y,
                                          int* hi_y, int* lo_x, int* hi_x) {
  const Cells r = roi_cells(box, spatial_scale);
  for (int i = 0; i < R; ++i) {
    bin_range(r.y1, r.h, i, R, H, lo_y + i, hi_y + i);
    bin_range(r.x1, r.w, i, R, W, lo_x + i, hi_x + i);
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

// One bin of one 16-byte channel vector: the max over rows [lo_y, hi_y) and
// columns [lo_x, hi_x) of the vector at src + y * row_pitch + x * col_pitch
// (global memory or a staged band in shared memory), times `scale` (a value
// of the map's dtype, as a float), stored as 16 bytes at dst.
template <typename D>
__device__ __forceinline__ void pool_bin(const typename D::T* src,
                                         long row_pitch, int col_pitch,
                                         int lo_y, int hi_y, int lo_x,
                                         int hi_x, float scale,
                                         typename D::T* dst) {
  typedef typename D::T T;
  constexpr int V = D::kVec;
  const float kNegInf = -__int_as_float(0x7f800000);
  const bool empty = hi_y <= lo_y || hi_x <= lo_x;
  float m[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = empty ? 0.f : kNegInf;
  for (int y = lo_y; y < hi_y; ++y) {
    for (int x = lo_x; x < hi_x; ++x) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + y * row_pitch + static_cast<long>(x) * col_pitch);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = nan_max(m[j], D::load(v, j));
    }
  }
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = D::store(m[j] * scale);
  *reinterpret_cast<uint4*>(dst) = packed;
}

// Batched RoIPool from global memory: one block per (roi, image), the image
// as the slowest grid index; out = dtype(max * dtype(roi_scale)). A RoI
// whose `skip` entry is nonzero is left to another launch (skip may be
// null). K1 (roi_pool.cu) launches it with no skip list, K3's rest launch
// (roi_pool_banded.cu) with the band launch's RoIs skipped.
template <typename D>
__global__ void batched_kernel(const typename D::T* __restrict__ features,
                               const float* __restrict__ boxes,
                               const float* __restrict__ roi_scale,
                               const uint8_t* __restrict__ skip,
                               typename D::T* __restrict__ out, int H, int W,
                               int C, int P, int R, float spatial_scale) {
  constexpr int V = D::kVec;
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const long roi = static_cast<long>(b) * P + p;
  if (skip != nullptr && skip[roi]) return;

  __shared__ int lo_y[kMaxRes], hi_y[kMaxRes], lo_x[kMaxRes], hi_x[kMaxRes];
  __shared__ float s_scale;
  if (threadIdx.x == 0) {
    bin_edges(boxes + roi * 4, spatial_scale, H, W, R, lo_y, hi_y, lo_x,
              hi_x);
    // roi_scale cast to the map's dtype before the multiply
    s_scale = D::cast(roi_scale[roi]);
  }
  __syncthreads();

  const typename D::T* map = features + static_cast<long>(b) * H * W * C;
  typename D::T* dst = out + roi * R * R * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    for (int ph = 0; ph < R; ++ph) {
      for (int pw = 0; pw < R; ++pw) {
        pool_bin<D>(map + c, static_cast<long>(W) * C, C, lo_y[ph], hi_y[ph],
                    lo_x[pw], hi_x[pw], s_scale, dst + (ph * R + pw) * C + c);
      }
    }
  }
}

}  // namespace drn_roi
