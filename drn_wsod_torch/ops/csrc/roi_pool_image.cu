// Exact single-image RoIPool forward for Hopper (sm_90a), in two modes.
//
// Replaces: drn_wsod_tpu/ops/roi_pool_pallas.py:roi_pool_pallas (the
// single-image Pallas kernel, looped per image by roi_pool_pallas_batched
// and by the train-step ablation tool, tools/ablate_bench.py:115-124),
// including its quantize_int8 option, which the TPU compiler never lowered.
// It computes what that kernel computes, not how: the range-max tables,
// 16-sublane windows, mask tables and VMEM-sized channel tiles have no
// counterpart here.
//
// Semantics: the bin arithmetic of roi_pool_bins.cuh (shared with K1 and K3;
// float mode takes its per-bin max, pool_bin, too), then
// per bin scale = roi_scale * (bin nonempty), in float32, and
//   * float mode (bf16 or float32 map): out = dtype(max * dtype(bin_scale)),
//     one rounding: the product of two bf16 values is exact in float32;
//   * int8 mode: the map arrives quantized per channel (q, ch_scale, made by
//     torch ops outside the kernel, as XLA makes them outside the Pallas
//     call); the max runs on int8, and
//     out = dtype((float(max) * ch_scale[c]) * bin_scale): two float32
//     multiplies in that order, then one round to nearest even.
// An empty bin's max is 0 in both modes.
//
// Design: one block per RoI. Each thread owns 16 bytes of consecutive
// channels of the map (8 bf16, 4 float32, or 16 int8 in int8 mode) and
// moves them with 16-byte loads; neighbouring threads read neighbouring
// addresses. In int8 mode the max of a 16-byte vector is four __vmaxs4 on
// packed words, and each thread writes its 16 channels as 32 (bf16) or 64
// (float32) bytes. Bin edges and bin scales are computed once per block
// into shared memory. The whole map (87*87*2048 at the flagship shape: 31 MB
// in bf16, 15.5 MB in int8) stays in the 50 MB L2 while the RoIs run.
//
// Bound at the flagship shape (P=4096, 87x87x2048 bf16, one image): writing
// the (4096, 49, 2048) bf16 output is 822 MB, ~0.25 ms at 3.35 TB/s; the
// map adds 31 MB. Bytes written bound it in both modes. Left on the table:
// each bin's cells are re-read from L2 by every RoI and bin that covers
// them (K1's body, roi_pool_bins.cuh:batched_kernel, reads each RoI cell
// once), no shared-memory staging, no TMA.

#include <algorithm>

#include "roi_pool_bins.cuh"

namespace {

using drn_roi::BF16;
using drn_roi::F32;
using drn_roi::kMaxRes;

// Bin edges of RoI p and its per-bin float32 scale roi_scale * nonempty,
// cast by Cast (the map's dtype in float mode, float32 in int8 mode).
template <typename Cast>
__device__ __forceinline__ void block_bins(const float* boxes,
                                           const float* roi_scale, int p,
                                           float spatial_scale, int H, int W,
                                           int R, int* lo_y, int* hi_y,
                                           int* lo_x, int* hi_x,
                                           float* bin_scale) {
  if (threadIdx.x == 0) {
    drn_roi::bin_edges(boxes + static_cast<long>(p) * 4, spatial_scale, H, W,
                       R, lo_y, hi_y, lo_x, hi_x);
    const float s = roi_scale[p];
    for (int ph = 0; ph < R; ++ph) {
      for (int pw = 0; pw < R; ++pw) {
        const bool empty = hi_y[ph] <= lo_y[ph] || hi_x[pw] <= lo_x[pw];
        bin_scale[ph * R + pw] = Cast::cast(__fmul_rn(s, empty ? 0.f : 1.f));
      }
    }
  }
  __syncthreads();
}

template <typename D>
__global__ void roi_pool_image_kernel(const typename D::T* __restrict__ map,
                                      const float* __restrict__ boxes,
                                      const float* __restrict__ roi_scale,
                                      typename D::T* __restrict__ out, int H,
                                      int W, int C, int R,
                                      float spatial_scale) {
  constexpr int V = D::kVec;
  const int p = blockIdx.x;
  __shared__ int lo_y[kMaxRes], hi_y[kMaxRes], lo_x[kMaxRes], hi_x[kMaxRes];
  __shared__ float bin_scale[kMaxRes * kMaxRes];
  block_bins<D>(boxes, roi_scale, p, spatial_scale, H, W, R, lo_y, hi_y, lo_x,
                hi_x, bin_scale);

  typename D::T* dst = out + static_cast<long>(p) * R * R * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    for (int ph = 0; ph < R; ++ph) {
      for (int pw = 0; pw < R; ++pw) {
        drn_roi::pool_bin<D>(map + c, static_cast<long>(W) * C, C, lo_y[ph],
                             hi_y[ph], lo_x[pw], hi_x[pw],
                             bin_scale[ph * R + pw],
                             dst + (ph * R + pw) * C + c);
      }
    }
  }
}

// signed byte k of a packed word, sign-extended
__device__ __forceinline__ int byte_at(uint32_t w, int k) {
  return static_cast<int>(w << (24 - 8 * k)) >> 24;
}

template <typename D>
__global__ void roi_pool_image_int8_kernel(const int8_t* __restrict__ map,
                                           const float* __restrict__ ch_scale,
                                           const float* __restrict__ boxes,
                                           const float* __restrict__ roi_scale,
                                           typename D::T* __restrict__ out,
                                           int H, int W, int C, int R,
                                           float spatial_scale) {
  typedef typename D::T T;
  constexpr int kStores = 16 * sizeof(T) / 16;  // uint4 stores per 16 chans
  const int p = blockIdx.x;
  __shared__ int lo_y[kMaxRes], hi_y[kMaxRes], lo_x[kMaxRes], hi_x[kMaxRes];
  __shared__ float bin_scale[kMaxRes * kMaxRes];
  block_bins<F32>(boxes, roi_scale, p, spatial_scale, H, W, R, lo_y, hi_y,
                  lo_x, hi_x, bin_scale);

  T* dst = out + static_cast<long>(p) * R * R * C;
  for (int c = threadIdx.x * 16; c < C; c += blockDim.x * 16) {
    float chs[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(ch_scale + c + 4 * k);
      chs[4 * k] = f.x;
      chs[4 * k + 1] = f.y;
      chs[4 * k + 2] = f.z;
      chs[4 * k + 3] = f.w;
    }
    for (int ph = 0; ph < R; ++ph) {
      for (int pw = 0; pw < R; ++pw) {
        const bool empty = hi_y[ph] <= lo_y[ph] || hi_x[pw] <= lo_x[pw];
        // -128 lies below every quantized value (they are clipped to
        // [-127, 127]); an empty bin is 0
        const uint32_t init = empty ? 0u : 0x80808080u;
        uint32_t m[4] = {init, init, init, init};
        for (int y = lo_y[ph]; y < hi_y[ph]; ++y) {
          for (int x = lo_x[pw]; x < hi_x[pw]; ++x) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                map + (static_cast<long>(y) * W + x) * C + c);
            m[0] = __vmaxs4(m[0], raw.x);
            m[1] = __vmaxs4(m[1], raw.y);
            m[2] = __vmaxs4(m[2], raw.z);
            m[3] = __vmaxs4(m[3], raw.w);
          }
        }
        const float s = bin_scale[ph * R + pw];
        union {
          uint4 vec[kStores];
          T val[16];
        } o;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float v = static_cast<float>(byte_at(m[j / 4], j % 4));
          o.val[j] = D::store(__fmul_rn(__fmul_rn(v, chs[j]), s));
        }
        uint4* d = reinterpret_cast<uint4*>(dst + (ph * R + pw) * C + c);
#pragma unroll
        for (int k = 0; k < kStores; ++k) d[k] = o.vec[k];
      }
    }
  }
}

}  // namespace

// features (H, W, C), boxes (P, 4) float32, roi_scale (P,) float32,
// out (P, R, R, C); all contiguous on one device. dtype: 0 = float32,
// 1 = bfloat16. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int drn_roi_pool_image_forward(const void* features,
                                          const void* boxes,
                                          const void* roi_scale, void* out,
                                          int H, int W, int C, int P, int R,
                                          float spatial_scale, int dtype,
                                          void* stream) {
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    roi_pool_image_kernel<BF16><<<P, std::min(C / BF16::kVec, 256), 0, s>>>(
        static_cast<const BF16::T*>(features), bx, sc,
        static_cast<BF16::T*>(out), H, W, C, R, spatial_scale);
  } else {
    roi_pool_image_kernel<F32><<<P, std::min(C / F32::kVec, 256), 0, s>>>(
        static_cast<const F32::T*>(features), bx, sc,
        static_cast<F32::T*>(out), H, W, C, R, spatial_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (H, W, C) int8, ch_scale (C,) float32, boxes (P, 4) float32,
// roi_scale (P,) float32, out (P, R, R, C) in out_dtype (0 = float32,
// 1 = bfloat16); all contiguous on one device, C a multiple of 16.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int drn_roi_pool_image_int8_forward(
    const void* q, const void* ch_scale, const void* boxes,
    const void* roi_scale, void* out, int H, int W, int C, int P, int R,
    float spatial_scale, int out_dtype, void* stream) {
  if (R < 1 || R > kMaxRes || (out_dtype != 0 && out_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* map = static_cast<const int8_t*>(q);
  const float* cs = static_cast<const float*>(ch_scale);
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = std::min(C / 16, 256);
  if (out_dtype == 1) {
    roi_pool_image_int8_kernel<BF16><<<P, threads, 0, s>>>(
        map, cs, bx, sc, static_cast<BF16::T*>(out), H, W, C, R,
        spatial_scale);
  } else {
    roi_pool_image_int8_kernel<F32><<<P, threads, 0, s>>>(
        map, cs, bx, sc, static_cast<F32::T*>(out), H, W, C, R,
        spatial_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
