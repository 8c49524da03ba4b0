// A self-contained baseline JPEG encoder for the host: 8-bit RGB in, the
// bytes of Pillow's default `Image.save(path)` out (quality 75, 4:2:0, the
// standard Huffman tables, no optimisation, a JFIF 1.01 header with a 1:1
// aspect and no density unit). It is the inverse of jpeg_decode.cpp and
// follows libjpeg-turbo's own code, file by file:
//   jcparam.c    the Annex K tables scaled to quality 75, force_baseline
//   jcmarker.c   SOI, APP0 (JFIF), one DQT and one DHT marker a table,
//                SOF0, SOS, EOI
//   jccolor.c    RGB -> YCbCr in 16-bit fixed point (rgb_ycc_convert)
//   jcprepct.c   the bottom edge: the last row repeated to a row group,
//                then the last downsampled row to a whole iMCU row
//   jcsample.c   the right edge repeated (expand_right_edge), Y copied,
//                Cb / Cr by h2v2_downsample (2x2 sums, bias 1, 2, 1, ...)
//   jfdctint.c   jpeg_fdct_islow
//   jcdctmgr.c   quantisation by reciprocal (compute_reciprocal,
//                quantize) of quantval << 3
//   jccoefct.c   dummy blocks past the right and bottom edges of an MCU:
//                zero AC, the previous block's quantised DC
//   jchuff.c     Huffman coding, 0xFF stuffing, ones to fill the last byte
// It keeps no state between calls and needs no library but the C++ one.
//
// C API (ctypes, see drn_wsod_torch/native.py):
//   jpeg_encode(rgb, width, height, out, cap, &out_len) -> 0 on success,
//     -1 for a size outside 1-65500, -3 where `cap` bytes do not hold
//     the file.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// bits[1..16] (bits[0] unused) and values of the four standard tables
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* values;
  int count;
  unsigned code[256];
  int size[256];
};

// jchuff.c:jpeg_make_c_derived_tbl, canonical codes from the bit counts
void derive(HuffTable* t) {
  std::memset(t->size, 0, sizeof(t->size));
  unsigned code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < t->bits[len]; ++i, ++k) {
      t->code[t->values[k]] = code++;
      t->size[t->values[k]] = len;
    }
    code <<= 1;
  }
}

// the quantisation table of quality 75 (scale 50), natural order
void quant_table(const int* basic, int* out) {
  for (int i = 0; i < 64; ++i) {
    long v = (static_cast<long>(basic[i]) * 50 + 50) / 100;
    out[i] = v <= 0 ? 1 : (v > 255 ? 255 : static_cast<int>(v));
  }
}

// jcdctmgr.c:compute_reciprocal with 16-bit DCTELEM (libjpeg-turbo's SIMD
// build): q(x) = sign(x) * (((|x| + corr) * recip) >> shift)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t{1} << r) / divisor;
  uint64_t fr = (uint64_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

// jfdctint.c:jpeg_fdct_islow on a block of level-shifted samples
void fdct_islow(int* data) {
  const int kConst = 13, kPass1 = 2;
  auto descale = [](int64_t x, int n) {
    return static_cast<int>((x + (int64_t{1} << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; ++pass) {
    for (int ctr = 0; ctr < 8; ++ctr) {
      int* p = pass == 0 ? data + ctr * 8 : data + ctr;
      int s = pass == 0 ? 1 : 8;
      int64_t tmp0 = p[0] + p[7 * s], tmp7 = p[0] - p[7 * s];
      int64_t tmp1 = p[s] + p[6 * s], tmp6 = p[s] - p[6 * s];
      int64_t tmp2 = p[2 * s] + p[5 * s], tmp5 = p[2 * s] - p[5 * s];
      int64_t tmp3 = p[3 * s] + p[4 * s], tmp4 = p[3 * s] - p[4 * s];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int even_shift = pass == 0 ? kConst - kPass1 : kConst + kPass1;
      if (pass == 0) {
        p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1));
        p[4 * s] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1));
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1);
        p[4 * s] = descale(tmp10 - tmp11, kPass1);
      }
      int64_t z1 = (tmp12 + tmp13) * 4433;
      p[2 * s] = descale(z1 + tmp13 * 6270, even_shift);
      p[6 * s] = descale(z1 + tmp12 * -15137, even_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * 9633;
      tmp4 *= 2446;
      tmp5 *= 16819;
      tmp6 *= 25172;
      tmp7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 *= -16069;
      z4 *= -3196;
      z3 += z5;
      z4 += z5;
      p[7 * s] = descale(tmp4 + z1 + z3, even_shift);
      p[5 * s] = descale(tmp5 + z2 + z4, even_shift);
      p[3 * s] = descale(tmp6 + z2 + z3, even_shift);
      p[s] = descale(tmp7 + z1 + z4, even_shift);
    }
  }
}

struct Writer {
  uint8_t* out;
  size_t cap, pos = 0;
  bool overflow = false;
  uint64_t acc = 0;
  int nbits = 0;

  void byte(int b) {
    if (pos < cap) out[pos] = static_cast<uint8_t>(b);
    else overflow = true;
    ++pos;
  }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xff);
  }
  void bits(unsigned code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      int b = static_cast<int>((acc >> (nbits - 8)) & 0xff);
      byte(b);
      if (b == 0xff) byte(0);
      nbits -= 8;
    }
  }
  void flush() { bits(0x7f, 7), nbits = 0, acc = 0; }
};

void write_dqt(Writer& w, const int* table, int index) {
  w.word(0xffdb);
  w.word(67);
  w.byte(index);
  for (int k = 0; k < 64; ++k) w.byte(table[kNatural[k]]);
}

void write_dht(Writer& w, const HuffTable& t, int index) {
  w.word(0xffc4);
  w.word(2 + 1 + 16 + t.count);
  w.byte(index);
  for (int i = 1; i <= 16; ++i) w.byte(t.bits[i]);
  for (int i = 0; i < t.count; ++i) w.byte(t.values[i]);
}

int bit_length(int v) {
  int n = 0;
  while (v) ++n, v >>= 1;
  return n;
}

void encode_block(Writer& w, const int* coef, int* last_dc,
                  const HuffTable& dc, const HuffTable& ac) {
  int temp = coef[0] - *last_dc, temp2 = temp;
  *last_dc = coef[0];
  if (temp < 0) temp = -temp, --temp2;
  int n = bit_length(temp);
  w.bits(dc.code[n], dc.size[n]);
  if (n) w.bits(static_cast<unsigned>(temp2), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = coef[kNatural[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xf0], ac.size[0xf0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) temp = -temp, --temp2;
    n = bit_length(temp);
    int sym = (run << 4) + n;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(static_cast<unsigned>(temp2), n);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

// A component plane padded to whole blocks, and its quantised blocks.
struct Plane {
  int width, height;  // padded to whole blocks (8 samples)
  std::vector<uint8_t> samples;
};

void quantize_block(const Plane& p, int bx, int by, const Divisor* div,
                    int* coef) {
  int ws[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      ws[y * 8 + x] = p.samples[(by * 8 + y) * p.width + bx * 8 + x] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int t = ws[i];
    bool neg = t < 0;
    uint64_t a = static_cast<uint64_t>(neg ? -t : t);
    int q = static_cast<int>(((a + div[i].corr) * div[i].recip)
                             >> div[i].shift);
    coef[i] = neg ? -q : q;
  }
}

}  // namespace

extern "C" int jpeg_encode(const uint8_t* rgb, int width, int height,
                           uint8_t* out, size_t cap, size_t* out_len) {
  if (width < 1 || height < 1 || width > 65500 || height > 65500) return -1;
  const int W = width, H = height;
  // the blocks of each component; Y is 2x2 per MCU, Cb and Cr 1x1
  const int yw = (W + 7) / 8, yh = (H + 7) / 8;
  const int cw = (W + 15) / 16, ch = (H + 15) / 16;
  const int mcux = cw, mcuy = ch;

  // jccolor.c:rgb_ycc_convert tables, SCALEBITS 16
  auto fix = [](double x) {
    return static_cast<int32_t>(x * 65536.0 + 0.5);
  };
  const int32_t half = 1 << 15, offset = 128 << 16;
  std::vector<uint8_t> Y(static_cast<size_t>(W) * H), Cb(Y.size()),
      Cr(Y.size());
  for (size_t i = 0; i < Y.size(); ++i) {
    int32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    Y[i] = static_cast<uint8_t>((fix(0.29900) * r + fix(0.58700) * g +
                                 fix(0.11400) * b + half) >> 16);
    Cb[i] = static_cast<uint8_t>((-fix(0.16874) * r - fix(0.33126) * g +
                                  fix(0.5) * b + offset + half - 1) >> 16);
    Cr[i] = static_cast<uint8_t>((fix(0.5) * r - fix(0.41869) * g -
                                  fix(0.08131) * b + offset + half - 1) >> 16);
  }

  // Y: the edges repeated to whole blocks
  Plane py{yw * 8, yh * 8, {}};
  py.samples.resize(static_cast<size_t>(py.width) * py.height);
  for (int y = 0; y < py.height; ++y)
    for (int x = 0; x < py.width; ++x)
      py.samples[static_cast<size_t>(y) * py.width + x] =
          Y[static_cast<size_t>(y < H ? y : H - 1) * W + (x < W ? x : W - 1)];

  // Cb, Cr: the input repeated to 16 * cw columns and an even row count,
  // 2x2 sums with the alternating bias, then the last row repeated
  Plane pc[2] = {{cw * 8, ch * 8, {}}, {cw * 8, ch * 8, {}}};
  const std::vector<uint8_t>* src[2] = {&Cb, &Cr};
  const int rows = (H + 1) / 2;
  for (int c = 0; c < 2; ++c) {
    Plane& p = pc[c];
    p.samples.resize(static_cast<size_t>(p.width) * p.height);
    const std::vector<uint8_t>& s = *src[c];
    for (int y = 0; y < p.height; ++y) {
      int oy = y < rows ? y : rows - 1;
      int y0 = 2 * oy, y1 = 2 * oy + 1 < H ? 2 * oy + 1 : H - 1;
      int bias = 1;
      for (int x = 0; x < p.width; ++x) {
        int x0 = 2 * x < W ? 2 * x : W - 1;
        int x1 = 2 * x + 1 < W ? 2 * x + 1 : W - 1;
        int sum = s[static_cast<size_t>(y0) * W + x0] +
                  s[static_cast<size_t>(y0) * W + x1] +
                  s[static_cast<size_t>(y1) * W + x0] +
                  s[static_cast<size_t>(y1) * W + x1];
        p.samples[static_cast<size_t>(y) * p.width + x] =
            static_cast<uint8_t>((sum + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  int qluma[64], qchroma[64];
  quant_table(kLumaQuant, qluma);
  quant_table(kChromaQuant, qchroma);
  Divisor dluma[64], dchroma[64];
  for (int i = 0; i < 64; ++i) {
    dluma[i] = reciprocal(static_cast<unsigned>(qluma[i]) << 3);
    dchroma[i] = reciprocal(static_cast<unsigned>(qchroma[i]) << 3);
  }
  HuffTable dcl{kDcLumaBits, kDcValues, 12, {}, {}};
  HuffTable acl{kAcLumaBits, kAcLumaValues, 162, {}, {}};
  HuffTable dcc{kDcChromaBits, kDcValues, 12, {}, {}};
  HuffTable acc{kAcChromaBits, kAcChromaValues, 162, {}, {}};
  derive(&dcl);
  derive(&acl);
  derive(&dcc);
  derive(&acc);

  Writer w{out, cap};
  w.word(0xffd8);
  w.word(0xffe0);  // JFIF 1.01, no unit, density 1:1, no thumbnail
  w.word(16);
  for (char ch0 : {'J', 'F', 'I', 'F', '\0'}) w.byte(ch0);
  w.byte(1);
  w.byte(1);
  w.byte(0);
  w.word(1);
  w.word(1);
  w.byte(0);
  w.byte(0);
  write_dqt(w, qluma, 0);
  write_dqt(w, qchroma, 1);
  w.word(0xffc0);
  w.word(8 + 3 * 3);
  w.byte(8);
  w.word(H);
  w.word(W);
  w.byte(3);
  const int sampling[3] = {0x22, 0x11, 0x11};
  for (int c = 0; c < 3; ++c) {
    w.byte(c + 1);
    w.byte(sampling[c]);
    w.byte(c == 0 ? 0 : 1);
  }
  write_dht(w, dcl, 0x00);
  write_dht(w, acl, 0x10);
  write_dht(w, dcc, 0x01);
  write_dht(w, acc, 0x11);
  w.word(0xffda);
  w.word(6 + 2 * 3);
  w.byte(3);
  for (int c = 0; c < 3; ++c) {
    w.byte(c + 1);
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int last_dc[3] = {0, 0, 0};
  int blocks[4][64], cb[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // Y: real blocks inside the component, dummies past its edges
      for (int j = 0; j < 2; ++j) {
        int by = 2 * my + j;
        for (int i = 0; i < 2; ++i) {
          int bx = 2 * mx + i;
          int* blk = blocks[2 * j + i];
          if (by < yh && bx < yw) {
            quantize_block(py, bx, by, dluma, blk);
          } else {
            std::memset(blk, 0, sizeof(int) * 64);
            // a row past the bottom copies the last block of the row
            // above; a block past the right edge the block before it
            blk[0] = by < yh ? blocks[2 * j + i - 1][0] : blocks[1][0];
          }
        }
      }
      for (int b = 0; b < 4; ++b)
        encode_block(w, blocks[b], &last_dc[0], dcl, acl);
      for (int c = 0; c < 2; ++c) {
        quantize_block(pc[c], mx, my, dchroma, cb);
        encode_block(w, cb, &last_dc[c + 1], dcc, acc);
      }
    }
  }
  w.flush();
  w.word(0xffd9);
  *out_len = w.pos;
  return w.overflow ? -3 : 0;
}
