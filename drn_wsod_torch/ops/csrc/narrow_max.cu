// Elementwise max of the two halves of a narrow-dtype array, for Hopper
// (sm_90a): out[i] = max(in[i], in[n + i]), n elements a half.
//
// Replaces: tools/mosaic_dtype_probe.py:probe, the Pallas kernel that took
// the max of rows 0-7 and rows 8-15 of a (16, 512) array to learn which
// narrow dtypes the TPU compiler lowers. On Hopper it probes that nvcc for
// sm_90a builds and runs the same max in each of them.
//
// One template over the element type: each thread owns one 16-byte vector
// of each half (8 bf16, 16 int8 / uint8 / fp8, 32 int4) and takes the max
// lane by lane on the lanes' bits. Element types:
//   * bf16, float8 e4m3fn and e5m2 (cuda_fp8.h) compare as floats; a NaN
//     operand wins (the first if both are), as jnp.maximum propagates NaN;
//     of two equal values the result is their bitwise AND, so max(-0, +0)
//     is +0 in either order, as jnp.maximum gives it;
//   * int8 and uint8 compare as signed and unsigned bytes;
//   * int4 is stored two to a byte, element 2j in the low nibble and 2j + 1
//     in the high one, and compares sign-extended.
// The result is always one operand's bits (or their AND), so it is exact.
//
// Bound: bytes. The probe's (16, 512) input and (8, 512) output move 24 KB
// in bf16, 12 KB in the byte types and 6 KB in int4: a few nanoseconds at
// 3.35 TB/s against a launch of some microseconds. So the launch is the
// cost, and most of it is the host's: the wrapper's checks, its output
// allocation and the call into this library take longer than the card
// takes to run the kernel.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a float compare on lane bits, per the rules above
template <typename ToFloat>
__device__ __forceinline__ uint32_t float_max(uint32_t a, uint32_t b) {
  const float fa = ToFloat::f(a);
  const float fb = ToFloat::f(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  if (fb > fa) return b;
  if (fa > fb) return a;
  return a & b;
}

struct Bf16 {
  static constexpr int kBits = 16;
  __device__ static float f(uint32_t v) { return __uint_as_float(v << 16); }
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    return float_max<Bf16>(a, b);
  }
};

struct Fp8E4M3 {
  static constexpr int kBits = 8;
  __device__ static float f(uint32_t v) {
    __nv_fp8_e4m3 x;
    x.__x = static_cast<__nv_fp8_storage_t>(v);
    return static_cast<float>(x);
  }
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    return float_max<Fp8E4M3>(a, b);
  }
};

struct Fp8E5M2 {
  static constexpr int kBits = 8;
  __device__ static float f(uint32_t v) {
    __nv_fp8_e5m2 x;
    x.__x = static_cast<__nv_fp8_storage_t>(v);
    return static_cast<float>(x);
  }
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    return float_max<Fp8E5M2>(a, b);
  }
};

// a signed compare of `Bits`-wide lanes, sign-extended
template <int Bits>
struct SignedInt {
  static constexpr int kBits = Bits;
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    const int sa = static_cast<int>(a << (32 - Bits)) >> (32 - Bits);
    const int sb = static_cast<int>(b << (32 - Bits)) >> (32 - Bits);
    return sb > sa ? b : a;
  }
};

struct Uint8 {
  static constexpr int kBits = 8;
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    return b > a ? b : a;
  }
};

template <typename E>
__device__ __forceinline__ uint32_t word_max(uint32_t a, uint32_t b) {
  constexpr uint32_t kMask = (1u << E::kBits) - 1u;
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 32; s += E::kBits) {
    out |= E::max((a >> s) & kMask, (b >> s) & kMask) << s;
  }
  return out;
}

template <typename E>
__global__ void narrow_max_kernel(const uint4* __restrict__ in,
                                  uint4* __restrict__ out, int n_vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const uint4 a = in[i];
  const uint4 b = in[n_vec + i];
  out[i] = make_uint4(word_max<E>(a.x, b.x), word_max<E>(a.y, b.y),
                      word_max<E>(a.z, b.z), word_max<E>(a.w, b.w));
}

// cudaLaunchKernel itself, whose result is the launch's error: one runtime
// call per launch (the launch is all this kernel's time costs, so the host
// path is kept short: see ops/narrow_max.py)
template <typename E>
int launch(const void* in, void* out, int n_vec, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const uint4* src = static_cast<const uint4*>(in);
  uint4* dst = static_cast<uint4*>(out);
  void* args[] = {&src, &dst, &n_vec};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(&narrow_max_kernel<E>),
      dim3((n_vec + kThreads - 1) / kThreads), dim3(kThreads), args, 0,
      stream));
}

}  // namespace

// in: 2 * half_bytes contiguous bytes (the two halves), out: half_bytes;
// both 16-byte aligned on one device, half_bytes a positive multiple of 16.
// kind: 0 bfloat16, 1 int8, 2 uint8, 3 float8_e4m3fn, 4 float8_e5m2,
// 5 int4 (two per byte). Returns a CUDA error code (0 on success).
extern "C" int drn_narrow_max(const void* in, void* out, int half_bytes,
                              int kind, void* stream) {
  if (half_bytes < 16 || half_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_vec = half_bytes / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<Bf16>(in, out, n_vec, s);
    case 1: return launch<SignedInt<8>>(in, out, n_vec, s);
    case 2: return launch<Uint8>(in, out, n_vec, s);
    case 3: return launch<Fp8E4M3>(in, out, n_vec, s);
    case 4: return launch<Fp8E5M2>(in, out, n_vec, s);
    case 5: return launch<SignedInt<4>>(in, out, n_vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
