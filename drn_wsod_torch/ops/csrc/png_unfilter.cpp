// PNG row unfiltering on the host (data/png.py): the inflated IDAT stream
// of a non-interlaced image -> its raw scanlines.
//
// Each scanline is one filter-type byte and `stride` bytes. Filters 0-4
// are None, Sub, Up, Average and Paeth (PNG specification, section 9):
// each byte adds a predictor from the byte `bpp` to its left (a), the byte
// above (b) and the one above-left (c), modulo 256; bytes left of the row
// and the row above the first are 0. Average and Paeth depend on the byte
// just decoded, so they run one byte at a time; data/png.py holds the numpy
// twin that tests compare this with.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// Returns 0, -1 when `in_len` holds fewer than height * (stride + 1)
// bytes, or -(10 + t) for a row of unknown filter type t.
extern "C" int png_unfilter(const uint8_t* in, size_t in_len, uint8_t* out,
                            int height, int stride, int bpp) {
  const size_t row = static_cast<size_t>(stride) + 1;
  if (in_len < row * static_cast<size_t>(height)) return -1;
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + row * y;
    const int type = src[0];
    ++src;
    uint8_t* dst = out + static_cast<size_t>(stride) * y;
    switch (type) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return -(10 + type);
    }
    prev = dst;
  }
  return 0;
}
