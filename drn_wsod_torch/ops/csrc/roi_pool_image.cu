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
// Semantics: the bin arithmetic of roi_pool_bins.cuh (shared with K1 and
// K3), then per bin scale = roi_scale * (bin nonempty), in float32, and
//   * float mode (bf16 or float32 map): out = dtype(max * dtype(bin_scale)),
//     one rounding: the product of two bf16 values is exact in float32;
//   * int8 mode: the map arrives quantized per channel (q, ch_scale, made by
//     torch ops outside the kernel, as XLA makes them outside the Pallas
//     call); the max runs on int8, and
//     out = dtype((float(max) * ch_scale[c]) * bin_scale): two float32
//     multiplies in that order, then one round to nearest even.
// An empty bin's max is 0 in both modes.
//
// Design: both modes run K1's body (roi_pool_bins.cuh:batched_kernel) with
// B = 1, so each cell of a RoI is read once per 16-byte channel vector, a
// bin's cells four loads at a time, and the blocks take the RoIs in the
// order of their top edge as K1's do (ops/roi_pool.py:top_row_order). The
// body zeroes an empty bin's max and multiplies by roi_scale itself; that
// equals the bin scale above by value (on an empty bin both are 0 times a
// factor whose sign, or NaN, follows roi_scale).
//   * Float mode is K1's launch at B = 1: 8 bf16 or 4 float32 channels a
//     thread, the max in bf16 pairs, K1's epilogue.
//   * Int8 mode walks the int8 map, 16 channels a thread (the I8 element
//     type: __vmaxs4 on packed words; 8-byte lanes, 256 threads a block,
//     were slower on an H100), and ends in Dequant below: each thread keeps
//     its channels' ch_scale in registers and writes each bin's 16 values
//     in the output's dtype as 16-byte stores.
// The wrapper (ops/roi_pool.py:roi_pool_looped) writes each image's launch
// into its slice of one batched output: no stacking copy.
//
// Bound at the ablation tool's shape (P=4096, 88x88x2048 bf16, one image):
// writing the (4096, 49, 2048) bf16 output is 822 MB, 0.255 ms at 3.35
// TB/s; the map adds 32 MB. Bytes written bound it in both modes. But like
// K1 it reads each RoI cell once per channel from L2, and L2's rate sets
// its time (PERF.md). Left on the table: cells that overlapping RoIs share
// are read once per RoI; int8 mode's quantization runs as torch ops outside
// the kernel (per image, as the JAX package quantizes inside each
// single-image call), and its 16-channel lanes store a bin as two or four
// 16-byte halves of 32-byte sectors; no TMA or shared-memory staging.

#include "roi_pool_bins.cuh"

namespace {

using drn_roi::BF16;
using drn_roi::F32;
using drn_roi::I8;
using drn_roi::kMaxRes;

// word i of a vector (i a constant once unrolled)
__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Int8 mode's epilogue for batched_kernel (see drn_roi::Scaled): the bin's
// int8 max of the 16 channels 16c ... 16c + 15 (0 where the bin is empty)
// becomes Out((float(max) * ch_scale) * roi_scale), two float32 multiplies
// and one rounding, written as kStores 16-byte vectors. The roi_scale is
// float32, uncast. Conversions run at an eighth of the multiplies' rate on
// an H100, so an int8 value becomes a float by integer ops and one
// subtraction, and bf16 outputs round two per conversion.
template <typename Out>
struct Dequant {
  static constexpr int kStores = 16 / Out::kVec;
  const float* ch_scale;
  struct Lane {
    float s[16];  // ch_scale of the thread's 16 channels
  };
  __device__ static float factor(float s) { return s; }
  __device__ Lane lane(int c) const {
    Lane l;
    const float4* p = reinterpret_cast<const float4*>(ch_scale) + 4 * c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = __ldg(p + k);
      l.s[4 * k] = f.x;
      l.s[4 * k + 1] = f.y;
      l.s[4 * k + 2] = f.z;
      l.s[4 * k + 3] = f.w;
    }
    return l;
  }
  __device__ static void store(uint4* dst, uint4 m, float scale, bool empty,
                               const Lane& l) {
    float x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // byte j biased by 128 (its sign bit flipped) is the low byte of the
      // float 2^23 + (v + 128), exactly; less 2^23 + 128 it is v
      const uint32_t biased = word(m, j / 4) ^ 0x80808080u;
      const float v = __fsub_rn(
          __uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7650 | (j % 4))),
          8388736.f);
      x[j] = __fmul_rn(__fmul_rn(empty ? 0.f : v, l.s[j]), scale);
    }
#pragma unroll
    for (int k = 0; k < kStores; ++k) dst[k] = Out::pack(x + k * Out::kVec);
  }
};

}  // namespace

// features (H, W, C), boxes (P, 4) float32, roi_scale (P,) float32, order
// (P,) int32, a permutation of 0..P-1 (the order the blocks take the RoIs
// in), out (P, R, R, C); all contiguous on one device, C a whole number of
// 16-byte vectors. dtype: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int drn_roi_pool_image_forward(const void* features,
                                          const void* boxes,
                                          const void* roi_scale,
                                          const void* order, void* out,
                                          int H, int W, int C, int P, int R,
                                          float spatial_scale, int dtype,
                                          void* stream) {
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
                                             out, 1, H, W, C, P, R,
                                             spatial_scale, s)
             : drn_roi::launch_batched<F32>(features, bx, sc, ord, nullptr,
                                            out, 1, H, W, C, P, R,
                                            spatial_scale, s);
}

// q (H, W, C) int8, ch_scale (C,) float32, boxes (P, 4) float32,
// roi_scale (P,) float32, order (P,) int32 as above, out (P, R, R, C) in
// out_dtype (0 = float32, 1 = bfloat16); all contiguous on one device, C a
// multiple of 16. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int drn_roi_pool_image_int8_forward(
    const void* q, const void* ch_scale, const void* boxes,
    const void* roi_scale, const void* order, void* out, int H, int W, int C,
    int P, int R, float spatial_scale, int out_dtype, void* stream) {
  if (R < 1 || R > kMaxRes || (out_dtype != 0 && out_dtype != 1) ||
      order == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* cs = static_cast<const float*>(ch_scale);
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  const int* ord = static_cast<const int*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 1
             ? drn_roi::launch_batched<I8>(q, bx, sc, ord, nullptr, out, 1, H,
                                           W, C, P, R, spatial_scale, s,
                                           Dequant<BF16>{cs})
             : drn_roi::launch_batched<I8>(q, bx, sc, ord, nullptr, out, 1, H,
                                           W, C, P, R, spatial_scale, s,
                                           Dequant<F32>{cs});
}
