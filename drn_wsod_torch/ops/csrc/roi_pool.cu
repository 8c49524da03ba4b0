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
// Semantics: the bin arithmetic and per-bin max of roi_pool_bins.cuh
// (shared with K2 and K3), then out = dtype(max * dtype(roi_scale)), one
// rounding: the product of two bf16 values is exact in float32. The kernel
// body is roi_pool_bins.cuh:batched_kernel, which K3's rest launch shares.
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

#include <algorithm>

#include "roi_pool_bins.cuh"

namespace {

using drn_roi::BF16;
using drn_roi::F32;
using drn_roi::kMaxRes;

template <typename D>
int launch(const void* features, const float* boxes, const float* roi_scale,
           void* out, int B, int H, int W, int C, int P, int R,
           float spatial_scale, cudaStream_t stream) {
  const int threads = std::min(C / D::kVec, 256);
  drn_roi::batched_kernel<D><<<dim3(P, B), threads, 0, stream>>>(
      static_cast<const typename D::T*>(features), boxes, roi_scale, nullptr,
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
