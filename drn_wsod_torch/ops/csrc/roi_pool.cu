// Exact RoIPool forward for Hopper (sm_90a), with the per-RoI scale fused
// into the epilogue.
//
// Replaces: drn_wsod_tpu/ops/roi_pool_pallas.py:roi_pool_pallas_grid (the
// batch-in-grid Pallas kernel the detect path launches at
// drn_wsod_tpu/models/meta_arch.py:221-225). It computes what that kernel
// computes, not how: the TPU kernel's sparse range-max tables, 16-sublane
// windows and per-RoI tiers exist to feed VMEM tiles and have no
// counterpart here.
//
// Semantics (torchvision RoIPool, bit for bit with the JAX package):
//   * map coordinates are round_half_even(box * spatial_scale)
//     (__float2int_rn, never roundf);
//   * roi_w = max(x2 - x1 + 1, 1), likewise roi_h;
//   * bin i spans [floor(i*roi/R) + start, ceil((i+1)*roi/R) + start),
//     clamped to [0, size]; a bin with hi <= lo is empty and pools to 0;
//   * out = dtype(max * dtype(roi_scale)), one rounding: the product of two
//     bf16 values is exact in float32.
//   * max propagates NaN, as jnp.maximum and torch.maximum do.
//
// Design: one block per (roi, image), the image as the slowest grid index,
// so one image's map (87*87*2048*2 B ~ 31 MB at the flagship shape) stays
// in the 50 MB L2 while its RoIs run. Each thread owns 16 bytes of
// consecutive channels (8 bf16 or 4 float32) and moves them with 16-byte
// loads and stores; neighbouring threads read neighbouring addresses. The
// bin edges are computed once per block into shared memory.
//
// Bound at the flagship shape (B=2, P=4096, 87x87x2048 bf16): writing the
// (2, 4096, 49, 2048) bf16 output is 1.64 GB, ~0.49 ms at 3.35 TB/s;
// reading the maps adds ~62 MB. So the kernel is bound by bytes written.
// What this simple design leaves on the table: each bin's cells are
// re-read from L2 by every RoI that covers them (no separable row max, no
// shared-memory staging), and there is no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxRes = 16;

struct F32 {
  typedef float T;
  static constexpr int kVec = 4;
  __device__ static float load(const T* p, int i) { return p[i]; }
  __device__ static T store(float v) { return v; }
  __device__ static float scale(float s) { return s; }
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
  // roi_scale cast to the map's dtype before the multiply
  __device__ static float scale(float s) {
    return __bfloat162float(__float2bfloat16_rn(s));
  }
};

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

template <typename D>
__global__ void roi_pool_kernel(const typename D::T* __restrict__ features,
                                const float* __restrict__ boxes,
                                const float* __restrict__ roi_scale,
                                typename D::T* __restrict__ out, int H, int W,
                                int C, int P, int R, float spatial_scale) {
  typedef typename D::T T;
  constexpr int V = D::kVec;
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const long roi = static_cast<long>(b) * P + p;

  __shared__ int lo_y[kMaxRes], hi_y[kMaxRes], lo_x[kMaxRes], hi_x[kMaxRes];
  __shared__ float s_scale;
  if (threadIdx.x == 0) {
    const float* bx = boxes + roi * 4;
    const int x1 = __float2int_rn(__fmul_rn(bx[0], spatial_scale));
    const int y1 = __float2int_rn(__fmul_rn(bx[1], spatial_scale));
    const int x2 = __float2int_rn(__fmul_rn(bx[2], spatial_scale));
    const int y2 = __float2int_rn(__fmul_rn(bx[3], spatial_scale));
    const int roi_w = max(x2 - x1 + 1, 1);
    const int roi_h = max(y2 - y1 + 1, 1);
    for (int i = 0; i < R; ++i) {
      lo_y[i] = min(max(i * roi_h / R + y1, 0), H);
      hi_y[i] = min(max(((i + 1) * roi_h + R - 1) / R + y1, 0), H);
      lo_x[i] = min(max(i * roi_w / R + x1, 0), W);
      hi_x[i] = min(max(((i + 1) * roi_w + R - 1) / R + x1, 0), W);
    }
    s_scale = D::scale(roi_scale[roi]);
  }
  __syncthreads();

  const T* map = features + static_cast<long>(b) * H * W * C;
  T* dst = out + roi * R * R * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    for (int ph = 0; ph < R; ++ph) {
      for (int pw = 0; pw < R; ++pw) {
        const float kNegInf = -__int_as_float(0x7f800000);
        float m[V];
        const bool empty = hi_y[ph] <= lo_y[ph] || hi_x[pw] <= lo_x[pw];
#pragma unroll
        for (int j = 0; j < V; ++j) m[j] = empty ? 0.f : kNegInf;
        for (int y = lo_y[ph]; y < hi_y[ph]; ++y) {
          for (int x = lo_x[pw]; x < hi_x[pw]; ++x) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                map + (static_cast<long>(y) * W + x) * C + c);
            const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < V; ++j) m[j] = nan_max(m[j], D::load(v, j));
          }
        }
        uint4 packed;
        T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = D::store(m[j] * s_scale);
        *reinterpret_cast<uint4*>(dst + (ph * R + pw) * C + c) = packed;
      }
    }
  }
}

template <typename D>
int launch(const void* features, const float* boxes, const float* roi_scale,
           void* out, int B, int H, int W, int C, int P, int R,
           float spatial_scale, cudaStream_t stream) {
  const int threads = std::min(C / D::kVec, 256);
  roi_pool_kernel<D><<<dim3(P, B), threads, 0, stream>>>(
      static_cast<const typename D::T*>(features), boxes, roi_scale,
      static_cast<typename D::T*>(out), H, W, C, P, R, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// features (B, H, W, C), boxes (B, P, 4) float32, roi_scale (B, P) float32,
// out (B, P, R, R, C); all contiguous on one device. dtype: 0 = float32,
// 1 = bfloat16. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int drn_roi_pool_forward(const void* features, const void* boxes,
                                    const void* roi_scale, void* out, int B,
                                    int H, int W, int C, int P, int R,
                                    float spatial_scale, int dtype,
                                    void* stream) {
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<BF16>(features, bx, sc, out, B, H, W, C, P, R,
                            spatial_scale, s)
             : launch<F32>(features, bx, sc, out, B, H, W, C, P, R,
                           spatial_scale, s);
}
