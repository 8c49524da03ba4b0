// Bin arithmetic, element types and the batched body shared by the RoIPool
// kernels (roi_pool.cu, roi_pool_image.cu, roi_pool_banded.cu), so that they
// cannot drift apart. The body walks each RoI cell once (below); K1, K3's
// rest launch and both modes of K2 run it, each with its own epilogue
// (Scaled here, roi_pool_image.cu's Dequant for K2's int8 mode). Its bound
// is the output's bytes (0.255 ms an image at the ablation tool's 822 MB of
// bf16 output, at 3.35 TB/s), but it reads each RoI cell once per channel
// from L2 and that read rate sets its time; what is left on the table is
// reading the cells that overlapping RoIs share once, not once per RoI.
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

// Element types of a map. Each names its element T, the elements kVec in
// the 16-byte vector a thread moves per cell, -inf in every lane of a
// 32-bit word, and vmax, the lane-wise max of two vectors.
struct F32 {
  typedef float T;
  static constexpr int kVec = 4;  // elements per 16-byte vector
  static constexpr uint32_t kNegInfWord = 0xff800000u;  // -inf
  // a float32 value in the map's dtype, as a float
  __device__ static float cast(float s) { return s; }
  // kVec float32 values as one 16-byte vector
  __device__ static uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
  // lane-wise max of two 16-byte vectors, NaN propagating
  __device__ static uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(lane_max(a.x, b.x), lane_max(a.y, b.y),
                      lane_max(a.z, b.z), lane_max(a.w, b.w));
  }
  // the epilogue: each lane (0 where the bin is empty) times `scale`
  __device__ static uint4 scaled(uint4 m, float scale, bool empty) {
    return make_uint4(scaled_lane(m.x, scale, empty),
                      scaled_lane(m.y, scale, empty),
                      scaled_lane(m.z, scale, empty),
                      scaled_lane(m.w, scale, empty));
  }

 private:
  __device__ static uint32_t lane_max(uint32_t a, uint32_t b) {
    return __float_as_uint(nan_max(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t scaled_lane(uint32_t m, float scale,
                                         bool empty) {
    return __float_as_uint((empty ? 0.f : __uint_as_float(m)) * scale);
  }
};

struct BF16 {
  typedef uint16_t T;
  static constexpr int kVec = 8;
  static constexpr uint32_t kNegInfWord = 0xff80ff80u;  // two bf16 -inf
  __device__ static float cast(float s) {
    return __bfloat162float(__float2bfloat16_rn(s));
  }
  // kVec float32 values as one 16-byte vector, each rounded to nearest
  // even, two per conversion
  __device__ static uint4 pack(const float* x) {
    return make_uint4(pair(x[0], x[1]), pair(x[2], x[3]), pair(x[4], x[5]),
                      pair(x[6], x[7]));
  }
  // lane-wise max of two 16-byte vectors in bf16 itself, two lanes per
  // instruction (__hmax2_nan: NaN propagating); a max needs no widening
  __device__ static uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(pair_max(a.x, b.x), pair_max(a.y, b.y),
                      pair_max(a.z, b.z), pair_max(a.w, b.w));
  }
  // the epilogue: each lane widened to float32 (0 where the bin is empty)
  // times `scale` (a bf16 value, so the product is exact), rounded once
  __device__ static uint4 scaled(uint4 m, float scale, bool empty) {
    return make_uint4(scaled_pair(m.x, scale, empty),
                      scaled_pair(m.y, scale, empty),
                      scaled_pair(m.z, scale, empty),
                      scaled_pair(m.w, scale, empty));
  }

 private:
  __device__ static uint32_t pair_max(uint32_t a, uint32_t b) {
    const __nv_bfloat162 r =
        __hmax2_nan(reinterpret_cast<const __nv_bfloat162&>(a),
                    reinterpret_cast<const __nv_bfloat162&>(b));
    return reinterpret_cast<const uint32_t&>(r);
  }
  __device__ static uint32_t scaled_pair(uint32_t m, float scale,
                                         bool empty) {
    const float lo = empty ? 0.f : __uint_as_float(m << 16);
    const float hi = empty ? 0.f : __uint_as_float(m & 0xffff0000u);
    return pair(lo * scale, hi * scale);
  }
  __device__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return reinterpret_cast<const uint32_t&>(r);
  }
};

// A map quantized to int8 (K2's int8 mode): 16 values per 16-byte vector.
// -128 stands for -inf: it lies below every quantized value, which are
// clipped to [-127, 127]. The epilogue is the caller's (roi_pool_image.cu).
struct I8 {
  typedef int8_t T;
  static constexpr int kVec = 16;
  static constexpr uint32_t kNegInfWord = 0x80808080u;
  __device__ static uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(max8(a.x, b.x), max8(a.y, b.y), max8(a.z, b.z),
                      max8(a.w, b.w));
  }

 private:
  __device__ static uint32_t max16(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // signed max of four packed bytes from two native 16-bit-pair maxes (sm_90
  // has no byte-wise max: __vmaxs4 compiles to a longer integer sequence,
  // which made K2's int8 launch 18% slower on an H100). The high byte of a 16-bit lane decides its
  // max whatever the low byte holds: the odd bytes in place, the even ones
  // shifted up a byte, then one byte permute takes the four high bytes.
  __device__ static uint32_t max8(uint32_t a, uint32_t b) {
    return __byte_perm(max16(a << 8, b << 8), max16(a, b), 0x7351);
  }
};

// ---------------------------------------------------------------------------
// The batched body (K1, K3's rest launch, and both modes of K2): each cell
// of a RoI read once per 16-byte channel vector.
//
// Consecutive bins overlap by at most one cell: bin i+1 starts no earlier
// than the last cell of bin i (floor((i+1)r/R) >= ceil((i+1)r/R) - 1, and
// clamping keeps it), and neither edge ever decreases with i. So a walk over
// the bins in order meets a cell it has read before only as the last cell
// it read: along x the row walk keeps the last vector it loaded, along y
// the bin walk keeps the last row's R row-bin maxima (4 * RMax 32-bit
// registers), and nothing is read twice.
// ---------------------------------------------------------------------------

// -inf in every lane of a 16-byte vector of D's elements
template <typename D>
__device__ __forceinline__ uint4 lowest() {
  const uint32_t w = D::kNegInfWord;
  return make_uint4(w, w, w, w);
}

// Cells a bin loads at once: its loads go out together (predicated off past
// the bin's end), so a bin of a few cells waits on memory once, not once
// per cell. Four was the fastest at the flagship shape on an H100 against
// batches of 6 and 8 and a loop unrolled by 4 or 8 (PERF.md).
constexpr int kLoadBatch = 4;

// The row-bin maxima of one map row: rm[pw] = the max over the row's cells
// [lo_x[pw], hi_x[pw]) of the vector at row[x * pitch], -inf where the bin
// is empty. Each cell is loaded once: a cell shared by two x-bins is the
// last one the previous bin loaded.
template <typename D, int RMax>
__device__ __forceinline__ void row_bin_max(const uint4* row, int pitch,
                                            int R, const int* lo_x,
                                            const int* hi_x, uint4 (&rm)[RMax]) {
  uint4 last = lowest<D>();
  int last_x = -1;
#pragma unroll
  for (int pw = 0; pw < RMax; ++pw) {
    if (pw >= R) break;
    int x = lo_x[pw];
    const int hi = hi_x[pw];
    uint4 m = lowest<D>();
    if (x < hi) {
      if (x == last_x) {
        m = last;
        ++x;
      }
      for (; x < hi; x += kLoadBatch) {
        uint4 v[kLoadBatch];
#pragma unroll
        for (int j = 0; j < kLoadBatch; ++j) {
          v[j] = x + j < hi ? row[(x + j) * pitch] : lowest<D>();
        }
#pragma unroll
        for (int j = 0; j < kLoadBatch; ++j) {
          m = D::vmax(m, v[j]);
          if (x + j == hi - 1) last = v[j];
        }
      }
      last_x = hi - 1;
    }
    rm[pw] = m;
  }
}

// An epilogue of batched_kernel says what a bin's max becomes. It names
// kStores, the 16-byte stores per input vector; factor(roi_scale), the
// RoI's scale as the epilogue takes it (once per block); lane(c), what a
// thread keeps for its vector c; and store(dst, m, scale, empty, lane),
// which writes the kStores vectors at dst (m is -inf where the bin is
// empty). Scaled is K1's: out = dtype(max * dtype(roi_scale)), the max 0
// where the bin is empty, in the map's dtype. roi_pool_image.cu holds K2's
// int8 epilogue.
template <typename D>
struct Scaled {
  static constexpr int kStores = 1;
  struct Lane {};
  // roi_scale cast to the map's dtype before the multiply
  __device__ static float factor(float s) { return D::cast(s); }
  __device__ Lane lane(int) const { return Lane(); }
  __device__ static void store(uint4* dst, uint4 m, float scale, bool empty,
                               Lane) {
    *dst = D::scaled(m, scale, empty);
  }
};

// Batched RoIPool from global memory: one block per (RoI, image), the image
// as the slowest grid index. Block (i, b) pools RoI p = order[b * P + i] of
// image b into out[b, p], through the epilogue `epi`. A RoI
// whose `skip` entry (flat index b * P + p) is
// nonzero is left to another launch (skip may be null). Each thread owns
// 16-byte channel vectors c, c + blockDim.x, ... and walks the y-bins in
// order, each y-bin's rows in order and each row's x-bins in order (the
// header comment above); the y-bin's R bin maxima and the kept row's R
// row-bin maxima stay in registers, and no register cap is set: more
// blocks per SM, fewer loads in flight each, was slower. R <= RMax; K1
// (roi_pool.cu) launches it with the top-row order and no skip list, K3's
// rest launch (roi_pool_banded.cu) with the same order and the band
// launch's RoIs skipped, K2 (roi_pool_image.cu) with B = 1.
template <typename D, int RMax, typename Epi>
__global__ void __launch_bounds__(256)
    batched_kernel(const uint4* __restrict__ features,
                   const float* __restrict__ boxes,
                   const float* __restrict__ roi_scale,
                   const int* __restrict__ order,
                   const uint8_t* __restrict__ skip,
                   uint4* __restrict__ out, int H, int W, int nvec, int P,
                   int R, float spatial_scale, Epi epi) {
  const int b = blockIdx.y;
  const int p = order[static_cast<long>(b) * P + blockIdx.x];
  const long roi = static_cast<long>(b) * P + p;
  if (skip != nullptr && skip[roi]) return;

  __shared__ int lo_y[RMax], hi_y[RMax], lo_x[RMax], hi_x[RMax];
  __shared__ float s_scale;
  if (threadIdx.x == 0) {
    bin_edges(boxes + roi * 4, spatial_scale, H, W, R, lo_y, hi_y, lo_x,
              hi_x);
    s_scale = Epi::factor(roi_scale[roi]);
  }
  __syncthreads();
  const float scale = s_scale;

  const uint4* map = features + static_cast<long>(b) * H * W * nvec;
  const long row_pitch = static_cast<long>(W) * nvec;
  uint4* dst = out + roi * R * R * nvec * Epi::kStores;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    const typename Epi::Lane lane = epi.lane(c);
    uint4 keep[RMax];     // row-bin maxima of row kept_y
    int kept_y = -1;
    for (int ph = 0; ph < R; ++ph) {
      int y = lo_y[ph];
      const int hi = hi_y[ph];
      uint4 acc[RMax];
#pragma unroll
      for (int pw = 0; pw < RMax; ++pw) acc[pw] = lowest<D>();
      if (y < hi && y == kept_y) {
#pragma unroll
        for (int pw = 0; pw < RMax; ++pw) acc[pw] = keep[pw];
        ++y;
      }
      for (; y < hi; ++y) {
        row_bin_max<D, RMax>(map + y * row_pitch + c, nvec, R, lo_x, hi_x,
                             keep);
#pragma unroll
        for (int pw = 0; pw < RMax; ++pw) acc[pw] = D::vmax(acc[pw], keep[pw]);
        kept_y = y;
      }
      const bool empty_y = hi_y[ph] <= lo_y[ph];
#pragma unroll
      for (int pw = 0; pw < RMax; ++pw) {
        if (pw >= R) break;
        Epi::store(dst + ((ph * R + pw) * nvec + c) * Epi::kStores, acc[pw],
                   scale, empty_y || hi_x[pw] <= lo_x[pw], lane);
      }
    }
  }
}

// Launches batched_kernel for R <= kMaxRes: the register arrays are sized
// 7 for R <= 7 (the box head's resolution) and kMaxRes above. C is a whole
// number of 16-byte vectors; `out` takes Epi::kStores 16-byte vectors per
// input vector. Returns the launch's cudaGetLastError().
template <typename D, typename Epi = Scaled<D>>
int launch_batched(const void* features, const float* boxes,
                   const float* roi_scale, const int* order,
                   const uint8_t* skip, void* out, int B, int H, int W, int C,
                   int P, int R, float spatial_scale, cudaStream_t stream,
                   Epi epi = Epi()) {
  const int nvec = C / D::kVec;
  const dim3 grid(P, B);
  const int threads = nvec < 256 ? nvec : 256;
  const uint4* f = static_cast<const uint4*>(features);
  uint4* o = static_cast<uint4*>(out);
  if (R <= 7) {
    batched_kernel<D, 7, Epi><<<grid, threads, 0, stream>>>(
        f, boxes, roi_scale, order, skip, o, H, W, nvec, P, R, spatial_scale,
        epi);
  } else {
    batched_kernel<D, kMaxRes, Epi><<<grid, threads, 0, stream>>>(
        f, boxes, roi_scale, order, skip, o, H, W, nvec, P, R, spatial_scale,
        epi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace drn_roi
