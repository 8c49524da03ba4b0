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
// Semantics: the bin arithmetic of roi_pool_bins.cuh (shared with K2 and
// K3), then out = dtype(max * dtype(roi_scale)), one rounding: the product
// of two bf16 values is exact in float32. The kernel body is
// roi_pool_bins.cuh:batched_kernel, which K3's rest launch and K2 share.
//
// Bound at the flagship shape (B=2, P=4096, 87x87x2048 bf16): writing the
// (2, 4096, 49, 2048) bf16 output is 1.64 GB, ~0.49 ms at 3.35 TB/s;
// reading the maps once adds ~62 MB. But the work is the cells: an exact
// pool reads each RoI's cells at least once per channel, 12.2 GB at that
// shape (the synthetic boxes), which one image's map (31 MB) serves from
// the 50 MB L2. So the L2 reads bind this kernel: on an H100 it reads
// 5.3-6.1 GB/ms of cells at every shape chip_smoke.py times, about L2's
// rate, against the 0.49 ms of the bytes bound.
//
// Design: one block per (roi, image), the image as the slowest grid index,
// so one image's map stays in L2 while its RoIs run. Each thread owns 16
// bytes of consecutive channels (8 bf16 or 4 float32) and moves them with
// 16-byte loads and stores; neighbouring threads read neighbouring
// addresses. Against the reads:
//   * each cell of a RoI is read once, not once per bin that holds it: the
//     walk in roi_pool_bins.cuh keeps the edge cell two x-bins share and the
//     row-bin maxima of the row two y-bins share (19.7 GB of reads at the
//     flagship shape became 12.2 GB);
//   * a bin's cells are loaded in batches of four, so the loads are in
//     flight together;
//   * the max runs in the map's dtype (bf16x2 __hmax2_nan, two elements per
//     instruction); only the epilogue widens to float32;
//   * blocks take each image's RoIs in the order of their top edge (`order`,
//     computed on the card by ops/roi_pool.py:top_row_order), so the RoIs
//     that run together share map rows, and where a map outgrows L2 (the
//     eval buckets above 704 px) their rows stay in L2 while they run: on
//     an H100 about twice as fast there as RoI order.
// Left on the table: cells that overlapping RoIs share are still read once
// per RoI, and there is no TMA or shared-memory staging.

#include "roi_pool_bins.cuh"

using drn_roi::BF16;
using drn_roi::F32;
using drn_roi::kMaxRes;

// features (B, H, W, C), boxes (B, P, 4) float32, roi_scale (B, P) float32,
// order (B, P) int32, each row a permutation of 0..P-1, out (B, P, R, R, C);
// all contiguous on one device. dtype: 0 = float32, 1 = bfloat16. Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int drn_roi_pool_forward(const void* features, const void* boxes,
                                    const void* roi_scale, const void* order,
                                    void* out, int B, int H, int W, int C,
                                    int P, int R, float spatial_scale,
                                    int dtype, void* stream) {
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1) ||
      order == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  const int* ord = static_cast<const int*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? drn_roi::launch_batched<BF16>(features, bx, sc, ord, nullptr,
                                             out, B, H, W, C, P, R,
                                             spatial_scale, s)
             : drn_roi::launch_batched<F32>(features, bx, sc, ord, nullptr,
                                            out, B, H, W, C, P, R,
                                            spatial_scale, s);
}
