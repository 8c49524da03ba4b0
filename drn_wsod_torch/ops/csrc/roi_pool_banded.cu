// Exact RoIPool forward for Hopper (sm_90a), banded: the function of K1
// (roi_pool.cu) in two launches, short RoIs pooled from a band of map rows
// staged in shared memory.
//
// Replaces: drn_wsod_tpu/ops/roi_pool_pallas.py:roi_pool_pallas_banded (its
// _banded_launch pallas_call, reached from roi_pool_pallas_grid with
// allow_banded=True). The TPU kernel packs short RoIs into band-pure slot
// runs, pools them against band-local range-max tables at a wide channel
// tile, pools the rest against the full tables, and merges the two P-slot
// outputs by a gather. Here both launches write straight into out[b, p]:
// no slots, no tables, no merge.
//
// The partition (drn_wsod_torch/ops/roi_pool.py:band_partition, torch ops
// on the device) gives each short RoI a band k of `band_rows` rows starting
// at bs = min(k * stride, max(H - band_rows, 0)), stride = band_rows -
// small_h, that holds all of its nonempty bins; `order` lists the short
// RoIs (flat index b * P + p) grouped by (image, band), and run g = b * NB +
// k is order[run_start[g] : run_start[g + 1]].
//
// Band launch: one block per (channel tile, band, image). It reads its run's
// bounds from device memory (the number of short RoIs per band is known
// only on the card, so the grid is fixed and a block with an empty run
// exits), stages rows [bs, bs + rows) x W x CT channels of the map into
// dynamic shared memory once, and pools every bin of every RoI of the run
// from there: threads walk (RoI, bin, 16-byte vector) work items. The bin
// edges are computed band-locally (start y1 - bs, rows clamped to the band,
// rows = min(band_rows, H)), as the plain version
// roi_pool.py:roi_pool_banded_plain computes them.
// Rest launch: roi_pool_bins.cuh:batched_kernel (K1's body) with the short
// RoIs skipped.
//
// Semantics as K1 (roi_pool_bins.cuh): round-half-even coordinates, max
// propagating NaN, 0 for an empty bin, out = dtype(max * dtype(roi_scale)).
//
// Bound: as K1, the output (B, P, R, R, C) written once; at the probe's
// 1536 bucket (B=1, P=4096, 192x192x2048 bf16) 822 MB plus the 151 MB map,
// ~0.29 ms at 3.35 TB/s. The band launch reads each band once per channel
// tile, about (band_rows / stride) = 2x the map. Left on the table: 16-byte
// global reads at a C-element stride when staging (CT is 8-16 bf16 channels
// at these widths), scattered 16-byte output stores, no TMA, and one block
// per SM when a band takes more than half the shared memory.

#include <algorithm>

#include "roi_pool_bins.cuh"

namespace {

using drn_roi::BF16;
using drn_roi::F32;
using drn_roi::kMaxRes;

constexpr int kThreads = 256;

template <typename D>
__global__ void band_kernel(const typename D::T* __restrict__ features,
                            const float* __restrict__ boxes,
                            const float* __restrict__ roi_scale,
                            const int* __restrict__ order,
                            const int* __restrict__ run_start,
                            typename D::T* __restrict__ out, int H, int W,
                            int C, int R, int NB, int stride, int band_rows,
                            int CT, float spatial_scale) {
  typedef typename D::T T;
  constexpr int V = D::kVec;
  extern __shared__ uint4 band_vec[];  // (rows, W, CT / V) 16-byte vectors
  const int n_ct = C / CT;
  const int c0 = (blockIdx.x % n_ct) * CT;
  const int k = blockIdx.x / n_ct;
  const int b = blockIdx.y;
  const int first = run_start[b * NB + k];
  const int last = run_start[b * NB + k + 1];
  if (first == last) return;

  const int rows = min(band_rows, H);
  const int bs = min(k * stride, max(H - band_rows, 0));
  const int nv = CT / V;
  const T* src = features + (static_cast<long>(b) * H + bs) * W * C;
  for (int i = threadIdx.x; i < rows * W * nv; i += blockDim.x) {
    band_vec[i] = *reinterpret_cast<const uint4*>(
        src + static_cast<long>(i / nv) * C + c0 + (i % nv) * V);
  }
  __syncthreads();

  const T* band = reinterpret_cast<const T*>(band_vec);
  const int per_roi = R * R * nv;
  const int work = (last - first) * per_roi;
  for (int w = threadIdx.x; w < work; w += blockDim.x) {
    const int roi = order[first + w / per_roi];
    const int bin = (w % per_roi) / nv;
    const int v = w % nv;
    const drn_roi::Cells r =
        drn_roi::roi_cells(boxes + static_cast<long>(roi) * 4, spatial_scale);
    int lo_y, hi_y, lo_x, hi_x;
    drn_roi::bin_range(r.y1 - bs, r.h, bin / R, R, rows, &lo_y, &hi_y);
    drn_roi::bin_range(r.x1, r.w, bin % R, R, W, &lo_x, &hi_x);
    drn_roi::pool_bin<D>(
        band + v * V, static_cast<long>(W) * CT, CT, lo_y, hi_y, lo_x, hi_x,
        D::cast(roi_scale[roi]),
        out + (static_cast<long>(roi) * R * R + bin) * C + c0 + v * V);
  }
}

template <typename D>
int launch_band(const void* features, const float* boxes,
                const float* roi_scale, const int* order,
                const int* run_start, void* out, int B, int H, int W, int C,
                int R, int NB, int stride, int band_rows, int CT,
                float spatial_scale, cudaStream_t stream) {
  const long smem = static_cast<long>(std::min(band_rows, H)) * W * CT *
                    sizeof(typename D::T);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(band_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_kernel<D><<<dim3(NB * (C / CT), B), kThreads, smem, stream>>>(
      static_cast<const typename D::T*>(features), boxes, roi_scale, order,
      run_start, static_cast<typename D::T*>(out), H, W, C, R, NB, stride,
      band_rows, CT, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
int launch_rest(const void* features, const float* boxes,
                const float* roi_scale, const uint8_t* is_short, void* out,
                int B, int H, int W, int C, int P, int R, float spatial_scale,
                cudaStream_t stream) {
  drn_roi::batched_kernel<D>
      <<<dim3(P, B), std::min(C / D::kVec, 256), 0, stream>>>(
          static_cast<const typename D::T*>(features), boxes, roi_scale,
          is_short, static_cast<typename D::T*>(out), H, W, C, P, R,
          spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Band launch. features (B, H, W, C), boxes (B, P, 4) float32, roi_scale
// (B, P) float32, order (B * P,) int32, run_start (B * NB + 1,) int32,
// out (B, P, R, R, C); all contiguous on one device. CT divides C and is a
// multiple of the 16-byte vector; the band (min(band_rows, H), W, CT) must
// fit the device's shared memory per block. dtype: 0 = float32,
// 1 = bfloat16. Returns a CUDA error code (0 on success).
extern "C" int drn_roi_pool_banded_forward(
    const void* features, const void* boxes, const void* roi_scale,
    const void* order, const void* run_start, void* out, int B, int H, int W,
    int C, int P, int R, int NB, int stride, int band_rows, int CT,
    float spatial_scale, int dtype, void* stream) {
  const int vec = dtype == 1 ? BF16::kVec : F32::kVec;
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1) || P < 1 ||
      stride < 1 || band_rows < 1 || CT < vec || CT % vec || C % CT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  const int* ord = static_cast<const int*>(order);
  const int* runs = static_cast<const int*>(run_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_band<BF16>(features, bx, sc, ord, runs, out, B, H, W, C,
                                 R, NB, stride, band_rows, CT, spatial_scale,
                                 s)
             : launch_band<F32>(features, bx, sc, ord, runs, out, B, H, W, C,
                                R, NB, stride, band_rows, CT, spatial_scale,
                                s);
}

// Rest launch: every RoI whose is_short (B, P) uint8 entry is 0, from the
// full map; the other arguments as drn_roi_pool_forward (roi_pool.cu).
extern "C" int drn_roi_pool_banded_rest_forward(
    const void* features, const void* boxes, const void* roi_scale,
    const void* is_short, void* out, int B, int H, int W, int C, int P, int R,
    float spatial_scale, int dtype, void* stream) {
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  const uint8_t* skip = static_cast<const uint8_t*>(is_short);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_rest<BF16>(features, bx, sc, skip, out, B, H, W,
                                        C, P, R, spatial_scale, s)
                    : launch_rest<F32>(features, bx, sc, skip, out, B, H, W,
                                       C, P, R, spatial_scale, s);
}
