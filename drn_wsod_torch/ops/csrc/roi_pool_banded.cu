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
// Band launch: one block per (channel tile, band, image), 1024 threads
// (one block fills an SM's shared memory, so it brings all the warps the SM
// runs). It reads its run's bounds from device memory (the number of short
// RoIs per band is known only on the card, so the grid is fixed and a block
// with an empty run exits), then stages rows [bs, bs + rows) x W x CT
// channels of the map into dynamic shared memory once, each thread keeping
// kStageBatch 16-byte loads in flight before it stores them; a staged row
// is padded to band_pitch() vectors. Behind the band it keeps a RoI table:
// per RoI its flat output index, its scale cast to the map's dtype, and its
// R band-local y-bins and R x-bins as int16 (lo, hi) pairs, written once
// (one thread per RoI; the first chunk's while the staging loads are in
// flight), after which the walk makes no global load. A run longer than
// `chunk` RoIs is taken a chunk at a time.
// The walk: each warp takes kGrab RoIs at a time from a counter in shared
// memory, and its lanes take their (RoI, bin, 16-byte vector) items, the
// vector fastest, then the y-bin, then the x-bin: two neighbouring lanes
// write one 32-byte sector, so no store leaves a sector half written where
// the channel tile holds two vectors or more (half sectors cost the card a
// read of the sector first), and the lanes of one x-bin walk one x-range
// on different rows (the pitch puts those rows on different banks). A lane
// reads its bin's cells row by row; where its y-bin's first row is the
// last row of y-bin ph - 1, it takes that row's maximum from the lane nv
// below, which walked it (a warp shuffle), so that row is read once. The
// epilogue and empty flags are K1's. Bin edges are band-local in y (start
// y1 - bs, clamped to rows = min(band_rows, H)), as the plain version
// roi_pool.py:roi_pool_banded_plain computes them.
// Rest launch: K1's launch (roi_pool_bins.cuh:batched_kernel, which reads
// each cell of a RoI once, its blocks taking the RoIs in the top-row order)
// with the short RoIs skipped.
//
// Semantics as K1 (roi_pool_bins.cuh): round-half-even coordinates, max
// propagating NaN, 0 for an empty bin, out = dtype(max * dtype(roi_scale)).
//
// Bound of the band launch alone: the short RoIs' outputs written once plus
// the staged bands read once, at 3.35 TB/s. At the pool probe's buckets
// (B=1, P=4096, bf16, 2048 channels) that is 615 / 453 / 407 / 334 MB of
// outputs and 69 / 160 / 220 / 302 MB of bands from the 704 to the 1536
// bucket, 0.18-0.20 ms at each. What holds it above (PERF.md): the walk's
// instruction issue (a bin of a short RoI holds a few cells, so each item
// pays its edges, shuffle and epilogue for little work), staging that does
// not overlap the walk (no cp.async or TMA, one block per SM), and, where
// the channel tile is one 16-byte vector (the 1280 and 1536 buckets), output
// stores that fill half a sector each.

#include <algorithm>

#include "roi_pool_bins.cuh"

namespace {

using drn_roi::BF16;
using drn_roi::F32;
using drn_roi::kMaxRes;

constexpr int kThreads = 1024;
// 16-byte loads each thread keeps in flight while it stages the band
// (larger batches spill within 1024 threads' 64 registers)
constexpr int kStageBatch = 8;
// RoIs a warp takes at once: a RoI's items fill its last 32-lane round
// partly, three RoIs' items leave fewer lanes idle
constexpr int kGrab = 3;

// 16-byte vectors per staged band row: W * nv padded to nv modulo 8, so
// that the rows the lanes of one x-bin read (nv lanes apart) start on
// different 16-byte bank groups. roi_pool.py:band_pitch mirrors it.
__host__ __device__ int band_pitch(int W, int nv) {
  return W * nv + ((nv - W * nv) % 8 + 8) % 8;
}

// bytes of the RoI table for n RoIs: 2R int16 (lo, hi) bin pairs, the
// output index and the scale of each, and the warps' counter.
// roi_pool.py:table_bytes mirrors it.
__host__ __device__ long table_bytes(int R, int n) {
  return static_cast<long>(n) * (8 * R + 8) + 16;
}

// The table entry of RoI `roi` (a flat index b * P + p), by one thread.
template <typename D>
__device__ __forceinline__ void table_entry(int roi, const float* boxes,
                                            const float* roi_scale,
                                            float spatial_scale, int R,
                                            int bs, int rows, int W,
                                            short2* edges, int* index,
                                            float* scale) {
  const drn_roi::Cells r =
      drn_roi::roi_cells(boxes + static_cast<long>(roi) * 4, spatial_scale);
  *index = roi;
  *scale = D::cast(roi_scale[roi]);
  for (int i = 0; i < R; ++i) {
    int lo, hi;
    drn_roi::bin_range(r.y1 - bs, r.h, i, R, rows, &lo, &hi);
    edges[i] = make_short2(lo, hi);
    drn_roi::bin_range(r.x1, r.w, i, R, W, &lo, &hi);
    edges[R + i] = make_short2(lo, hi);
  }
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
    band_kernel(const typename D::T* __restrict__ features,
                const float* __restrict__ boxes,
                const float* __restrict__ roi_scale,
                const int* __restrict__ order,
                const int* __restrict__ run_start, uint4* __restrict__ out,
                int H, int W, int C, int R, int NB, int stride,
                int band_rows, int CT, int chunk, float spatial_scale) {
  typedef typename D::T T;
  constexpr int V = D::kVec;
  // the band, (rows, pitch) 16-byte vectors, then the RoI table
  extern __shared__ uint4 band_vec[];
  const int n_ct = C / CT;
  const int tile = blockIdx.x % n_ct;
  const int k = blockIdx.x / n_ct;
  const int b = blockIdx.y;
  const int first = run_start[b * NB + k];
  const int last = run_start[b * NB + k + 1];
  if (first == last) return;

  const int rows = min(band_rows, H);
  const int bs = min(k * stride, max(H - band_rows, 0));
  const int nv = CT / V;
  const int wv = W * nv;
  const int pitch = band_pitch(W, nv);
  short2* t_edges = reinterpret_cast<short2*>(band_vec + rows * pitch);
  int* t_roi = reinterpret_cast<int*>(t_edges + 2 * R * chunk);
  float* t_scale = reinterpret_cast<float*>(t_roi + chunk);
  int* next = reinterpret_cast<int*>(t_scale + chunk);

  const T* src = features + (static_cast<long>(b) * H + bs) * W * C +
                 tile * CT;
  const int n_stage = rows * wv;
  const int n_first = min(chunk, last - first);
  for (int i0 = threadIdx.x; i0 < n_stage; i0 += kStageBatch * blockDim.x) {
    uint4 v[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n_stage) {
        v[j] = *reinterpret_cast<const uint4*>(
            src + static_cast<long>(i / nv) * C + (i % nv) * V);
      }
    }
    if (i0 == threadIdx.x) {  // the first chunk's table, loads in flight
      for (int j = threadIdx.x; j < n_first; j += blockDim.x) {
        table_entry<D>(order[first + j], boxes, roi_scale, spatial_scale, R,
                       bs, rows, W, t_edges + j * 2 * R, t_roi + j,
                       t_scale + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n_stage) band_vec[(i / wv) * pitch + i % wv] = v[j];
    }
  }
  if (threadIdx.x >= n_stage) {  // a thread that staged nothing
    for (int j = threadIdx.x; j < n_first; j += blockDim.x) {
      table_entry<D>(order[first + j], boxes, roi_scale, spatial_scale, R, bs,
                     rows, W, t_edges + j * 2 * R, t_roi + j, t_scale + j);
    }
  }

  const int nvec = C / V;
  const int out_v = tile * nv;
  const int bins = R * R;
  const int per_roi = bins * nv;
  const int lg_nv = __ffs(nv) - 1;  // nv is a power of two
  // bin / R == bin * div_r >> 16 for bin < 256 (R <= 16), and w / per_roi
  // == w * div_roi >> 40 while w * per_roi < 2^40 (w < kGrab * per_roi,
  // per_roi <= 2^19: launch_band checks it)
  const int div_r = (65536 + R - 1) / R;
  const unsigned long long div_roi = ((1ull << 40) + per_roi - 1) / per_roi;
  const int lane = threadIdx.x & 31;
  for (int c = first; c < last; c += chunk) {
    const int n = min(chunk, last - c);
    if (c != first) {
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        table_entry<D>(order[c + j], boxes, roi_scale, spatial_scale, R, bs,
                       rows, W, t_edges + j * 2 * R, t_roi + j, t_scale + j);
      }
    }
    if (threadIdx.x == 0) *next = 0;
    __syncthreads();  // the band (first chunk), the table and the counter

    for (;;) {
      int j0 = 0;
      if (lane == 0) j0 = atomicAdd(next, kGrab);
      j0 = __shfl_sync(0xffffffffu, j0, 0);
      if (j0 >= n) break;
      const int items = min(kGrab, n - j0) * per_roi;
      for (int w = lane; w < items; w += 32) {
        const int left = items - (w - lane);
        const unsigned mask = left >= 32 ? 0xffffffffu : (1u << left) - 1;
        const int jj = static_cast<int>(
            (static_cast<unsigned long long>(w) * div_roi) >> 40);
        const int u = w - jj * per_roi;
        const int j = j0 + jj;
        const int bin = u >> lg_nv;
        const int pw = (bin * div_r) >> 16;
        const int ph = bin - pw * R;
        const int v = u & (nv - 1);
        const short2* ey = t_edges + j * 2 * R;
        const short2 y = ey[ph], x = ey[R + pw];
        const bool empty = y.y <= y.x || x.y <= x.x;
        // the lane nv below walks y-bin ph - 1 of the same x-bin and vector
        bool shared_row = false;
        if (ph > 0 && lane >= nv && !empty) {
          const short2 yp = ey[ph - 1];
          shared_row = y.x == yp.y - 1 && yp.y - yp.x >= 2;
        }
        uint4 m = drn_roi::lowest<D>(), last_row = drn_roi::lowest<D>();
        for (int yy = y.x + shared_row; yy < y.y; ++yy) {
          const uint4* row = band_vec + yy * pitch + v;
          uint4 r = drn_roi::lowest<D>();
#pragma unroll 4
          for (int xx = x.x; xx < x.y; ++xx) r = D::vmax(r, row[xx * nv]);
          m = D::vmax(m, r);
          last_row = r;
        }
        uint4 above;
        above.x = __shfl_up_sync(mask, last_row.x, nv);
        above.y = __shfl_up_sync(mask, last_row.y, nv);
        above.z = __shfl_up_sync(mask, last_row.z, nv);
        above.w = __shfl_up_sync(mask, last_row.w, nv);
        if (shared_row) m = D::vmax(m, above);
        out[(static_cast<long>(t_roi[j]) * bins + ph * R + pw) * nvec +
            out_v + v] = D::scaled(m, t_scale[j], empty);
      }
    }
    __syncthreads();  // the table is read before the next chunk's is written
  }
}

template <typename D>
int launch_band(const void* features, const float* boxes,
                const float* roi_scale, const int* order,
                const int* run_start, void* out, int B, int H, int W, int C,
                int R, int NB, int stride, int band_rows, int CT, int chunk,
                float spatial_scale, cudaStream_t stream) {
  const int nv = CT / D::kVec;
  if (nv & (nv - 1) || static_cast<long>(R) * R * nv > (1L << 19)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long smem = static_cast<long>(std::min(band_rows, H)) *
                        band_pitch(W, nv) * 16 +
                    table_bytes(R, chunk);
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
      run_start, static_cast<uint4*>(out), H, W, C, R, NB, stride, band_rows,
      CT, chunk, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Band launch. features (B, H, W, C), boxes (B, P, 4) float32, roi_scale
// (B, P) float32, order (B * P,) int32, run_start (B * NB + 1,) int32,
// out (B, P, R, R, C); all contiguous on one device. CT divides C and is a
// power-of-two multiple of the 16-byte vector; a block takes its run
// `chunk` RoIs at a time, and the band (min(band_rows, H) rows of
// band_pitch vectors) plus the table of `chunk` RoIs must fit the device's
// shared memory per block (roi_pool.py:band_tile picks both). dtype: 0 = float32, 1 = bfloat16.
// Returns a CUDA error code (0 on success).
extern "C" int drn_roi_pool_banded_forward(
    const void* features, const void* boxes, const void* roi_scale,
    const void* order, const void* run_start, void* out, int B, int H, int W,
    int C, int P, int R, int NB, int stride, int band_rows, int CT, int chunk,
    float spatial_scale, int dtype, void* stream) {
  const int vec = dtype == 1 ? BF16::kVec : F32::kVec;
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1) || P < 1 ||
      stride < 1 || band_rows < 1 || CT < vec || CT % vec || C % CT ||
      chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  const int* ord = static_cast<const int*>(order);
  const int* runs = static_cast<const int*>(run_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_band<BF16>(features, bx, sc, ord, runs, out, B, H, W, C,
                                 R, NB, stride, band_rows, CT, chunk,
                                 spatial_scale, s)
             : launch_band<F32>(features, bx, sc, ord, runs, out, B, H, W, C,
                                R, NB, stride, band_rows, CT, chunk,
                                spatial_scale, s);
}

// Rest launch: every RoI whose is_short (B, P) uint8 entry is 0, from the
// full map, its blocks taking the RoIs in `order`; the other arguments as
// drn_roi_pool_forward (roi_pool.cu).
extern "C" int drn_roi_pool_banded_rest_forward(
    const void* features, const void* boxes, const void* roi_scale,
    const void* order, const void* is_short, void* out, int B, int H, int W,
    int C, int P, int R, float spatial_scale, int dtype, void* stream) {
  if (R < 1 || R > kMaxRes || (dtype != 0 && dtype != 1) ||
      order == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(roi_scale);
  const int* ord = static_cast<const int*>(order);
  const uint8_t* skip = static_cast<const uint8_t*>(is_short);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? drn_roi::launch_batched<BF16>(features, bx, sc, ord, skip, out,
                                             B, H, W, C, P, R, spatial_scale,
                                             s)
             : drn_roi::launch_batched<F32>(features, bx, sc, ord, skip, out,
                                            B, H, W, C, P, R, spatial_scale,
                                            s);
}
