// A self-contained JPEG decoder for the host data path: every file that
// libjpeg-turbo (the JAX package's binding, native/jpeg_decode.cpp) or
// Pillow decodes, with a DCT-domain prescale of scale_num/8 (scale_num
// 1-8) where libjpeg takes the file.
//
// Where libjpeg-turbo 2.1 takes a file (baseline, extended and
// progressive, Huffman or arithmetic coded, 8-bit, one or three
// components, cut short or whole), the output equals its JDCT_ISLOW,
// fancy-upsampled JCS_RGB decode bit for bit, block smoothing included,
// which is what Pillow and the binding return. Where only Pillow takes a
// file (four components: CMYK and YCCK; lossless SOF3 at 8 bits), the
// output equals Pillow 12's decode: its mode array (L, RGB, or CMYK
// inverted as its "CMYK;I" raw mode does) or its convert("RGB"), at
// scale_num 8, the only scale it decodes. It follows libjpeg's own code,
// file by file:
//   jdmarker.c   markers, tables, DAC conditioning, JFIF / Adobe hints
//   jdhuff.c     sequential Huffman decoding, zero bits past the data's end
//   jdphuff.c    progressive DC/AC first and refinement scans, EOB runs
//   jdarith.c    the QM decoder, sequential and progressive scans
//   jdlhuff.c,   lossless differences, predictors 1-7, point transform
//   jddiffct.c,
//   jdlossls.c
//   jdcoefct.c   block smoothing of progressive files whose scans stopped
//                short (decompress_smooth_data, coef_bits latched per scan)
//   jddctmgr.c   the IDCT chosen by each component's scaled DCT size
//   jidctint.c   jpeg_idct_islow (8x8) and the 3x3/5x5/6x6/7x7 and
//                10x10/12x12/14x14 IDCTs
//   jidctred.c   jpeg_idct_1x1, 2x2, 4x4
//   jdmaster.c   output size and each component's scaled DCT size
//   jdsample.c   fancy (triangle) and box upsampling
//   jdcolor.c    YCbCr -> RGB, gray -> RGB, YCCK -> CMYK
// and Pillow's JpegDecode.c (out_color_space per mode), Unpack.c
// ("CMYK;I") and Convert.c (cmyk2rgb). It keeps no state between calls
// and needs no library but the C++ one.
//
// Files neither reference decodes return a negative code (see `Status`):
// the caller names the feature and raises.
//
// C API (ctypes, see drn_wsod_torch/native.py):
//   jpeg_decode_info(data, len, &w, &h)            -> 0 once a frame
//                                                     header parsed
//   jpeg_decode(data, len, scale_num, native, out, cap,
//               &out_w, &out_h, &channels)         -> 0 on success; RGB8,
//     or with `native` set Pillow's mode array: 1 (L), 3 (RGB) or 4
//     (CMYK) channels. The output is ceil(dim * scale_num / 8); `cap` is
//     out's size in bytes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kCorrupt = -1,          // a header or table that does not parse
  kBadScale = -2,         // scale_num outside 1-8
  kCapacity = -3,         // the output buffer is too small
  kLossless = -5,         // lossless in YCbCr or YCCK, or arithmetic coded
  kPrecision = -6,        // sample precision other than 8 bits (12-bit)
  kTruncated = -8,        // CMYK, YCCK or lossless, cut short
  kSampling = -9,         // sampling factors libjpeg cannot upsample
  kHierarchical = -10,    // SOF5-SOF7, SOF13-SOF15: differential coding
  kComponents = -11,      // 2 components, or more than 4
  kPillowScale = -12,     // CMYK, YCCK or lossless at scale_num below 8
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// zigzag index -> natural index, with libjpeg's 16 guard entries
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of ITU T.81 Annex K.3, which libjpeg installs for a
// table a scan names but no DHT defined (Motion-JPEG)
const uint8_t kStdBitsDcLuma[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                    0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdBitsDcChroma[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                      1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdBitsAcLuma[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5,
                                    5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdValsAcLuma[162] = {
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
const uint8_t kStdBitsAcChroma[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7,
                                      5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdValsAcChroma[162] = {
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

// ------------------------------------------------------------ Huffman tables

constexpr int kLookahead = 8;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  // jpeg_make_d_derived_tbl's decoding tables
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t lookup[1 << kLookahead] = {};  // (code length << 8) | symbol
};

// jdhuff.c jpeg_make_d_derived_tbl; a DC table's symbols are at most
// `max_dc` (15, and 16 in lossless files)
void derive(HuffTable* t, bool is_dc, int max_dc) {
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t->bits[l];
    if (p + i > 256) fail(kCorrupt);
    while (i--) huffsize[p++] = static_cast<char>(l);
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (static_cast<int64_t>(code) >= (int64_t{1} << si)) fail(kCorrupt);
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t->bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t->bits[l];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  for (int i = 0; i < (1 << kLookahead); i++)
    t->lookup[i] = (kLookahead + 1) << kLookahead;
  p = 0;
  for (int l = 1; l <= kLookahead; l++) {
    for (int i = 1; i <= t->bits[l]; i++, p++) {
      int look = static_cast<int>(huffcode[p]) << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; ctr--)
        t->lookup[look++] = static_cast<uint16_t>((l << kLookahead) |
                                                  t->vals[p]);
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++)
      if (t->vals[i] > max_dc) fail(kCorrupt);
  }
}

void install_std(HuffTable* t, bool is_dc, int index) {
  const uint8_t* bits;
  const uint8_t* vals;
  if (index == 0) {
    bits = is_dc ? kStdBitsDcLuma : kStdBitsAcLuma;
    vals = is_dc ? kStdValsDc : kStdValsAcLuma;
  } else if (index == 1) {
    bits = is_dc ? kStdBitsDcChroma : kStdBitsAcChroma;
    vals = is_dc ? kStdValsDc : kStdValsAcChroma;
  } else {
    fail(kCorrupt);
  }
  int count = 0;
  for (int l = 1; l <= 16; l++) count += bits[l];
  std::memcpy(t->bits, bits, 17);
  std::memset(t->vals, 0, sizeof(t->vals));
  std::memcpy(t->vals, vals, count);
  t->defined = true;
}

// ----------------------------------------------------------------- the image

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int index = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int bw = 0, bh = 0;               // allocated blocks: whole MCUs
  std::vector<int16_t> coef;        // bh * bw blocks of 64, natural order
  bool latched = false;             // its quantisation table, latched at
  uint16_t quant[64] = {};          // its first scan (jdinput.c)
  int coef_bits[64];                // progressive: -1 until a scan sent it
  int prev_coef_bits[64];           // coef_bits before its latest scan
  int dc_tbl = 0, ac_tbl = 0;
  // lossless: a sample a data unit, bw x bh of them (whole MCUs)
  std::vector<int32_t> diff;        // the decoded differences, then each
                                    // row undifferenced in place
  std::vector<uint8_t> samples;     // undifferenced, point transform undone
  int16_t* block(int row, int col) {
    return coef.data() + (static_cast<size_t>(row) * bw + col) * 64;
  }
};

constexpr int kArithTables = 16;

// jaricom.c: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS (T.81 Table D.3), and state 113, the fixed
// probability 0.5
#define V(i, qe, nlps, nmps, sw) \
  ((int64_t{qe} << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),     V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),     V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),   V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),   V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),   V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),   V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),   V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),   V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),   V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),   V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),   V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),   V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),   V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),   V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),   V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),   V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),  V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;

  // header state
  bool saw_sof = false, progressive = false, arithmetic = false,
       lossless = false;
  int precision = 8, width = 0, height = 0;
  std::vector<Component> comps;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  uint16_t qtables[4][64] = {};
  bool qdefined[4] = {};
  HuffTable dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  // DAC conditioning (jdmarker.c get_soi's defaults)
  uint8_t arith_dc_L[kArithTables], arith_dc_U[kArithTables],
      arith_ac_K[kArithTables];

  // scan state
  int unread_marker = 0;
  uint64_t buf = 0;
  int bits = 0;
  bool insufficient = false;
  int insufficient_row = -1;        // the iMCU row where the data ran out
  bool hit_end = false;             // a read past the data's last byte
  int next_restart = 0;
  int restarts_to_go = 0;
  int last_dc[4] = {};
  unsigned eobrun = 0;
  std::vector<Component*> scan;
  int ss = 0, se = 63, ah = 0, al = 0;
  int input_scan_number = 0;
  // block smoothing: the iMCU row of the MCU being decoded, and the last
  // iMCU row that the latest scan decoded from data (jdcoefct.c)
  int cur_imcu_row = 0, last_good_imcu_row = 0;

  // jdarith.c's decoder
  int64_t ac_c = 0, ac_a = 0;
  int ac_ct = 0;
  int dc_context[4] = {};
  uint8_t dc_stats[kArithTables][64], ac_stats[kArithTables][256];
  uint8_t fixed_bin = 113;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    for (int i = 0; i < kArithTables; i++) {
      arith_dc_L[i] = 0;
      arith_dc_U[i] = 1;
      arith_ac_K[i] = 5;
    }
  }

  // ---------------------------------------------------------------- bytes
  // Past the end the source yields FF D9 FF D9 ..., as jpeg_mem_src's
  // fill_input_buffer inserts a fake EOI marker each time it runs dry;
  // a header cut short reads those bytes as its own.
  int byte() {
    if (pos < len) return data[pos++];
    hit_end = true;
    return (pos++ - len) % 2 ? 0xD9 : 0xFF;
  }

  int header_byte() { return byte(); }

  int header_u16() {
    int hi = header_byte();
    return (hi << 8) | header_byte();
  }

  // jdmarker.c next_marker: skip to the next FF xx (xx not 00 or FF)
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // ----------------------------------------------------------------- bits
  // jdhuff.c jpeg_fill_bit_buffer: load bytes up to a marker; a request for
  // more bits than remain before it is met with zero bits and marks the
  // segment's data as insufficient.
  static constexpr int kMinGetBits = 57;

  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bits < kMinGetBits) {
        int c = byte();
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            break;
          }
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        bits += 8;
      }
    }
    if (unread_marker != 0 && nbits > bits) {
      if (!insufficient) insufficient_row = cur_imcu_row;
      insufficient = true;
      buf <<= kMinGetBits - bits;
      bits = kMinGetBits;
    }
  }

  int get_bits(int n) {
    if (bits < n) fill(n);
    bits -= n;
    return static_cast<int>((buf >> bits) & ((uint64_t{1} << n) - 1));
  }

  int decode_huff(const HuffTable& t) {
    int l, code;
    if (bits < kLookahead) fill(0);
    if (bits >= kLookahead) {
      int look = static_cast<int>((buf >> (bits - kLookahead)) &
                                  ((1 << kLookahead) - 1));
      int nb = t.lookup[look] >> kLookahead;
      if (nb <= kLookahead) {
        bits -= nb;
        return t.lookup[look] & 0xFF;
      }
      l = nb;
    } else {
      l = 1;
    }
    code = get_bits(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      l++;
    }
    if (l > 16) return 0;  // a bad code: libjpeg fakes a zero symbol
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + static_cast<int>((~0u << s) + 1u) : r;
  }

  // ------------------------------------------------------------- restarts
  // jdmarker.c jpeg_resync_to_restart, the default recovery
  void resync(int desired) {
    int marker = unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker = 0;
        return;
      }
      if (action == 3) return;
      marker = unread_marker = next_marker();
    }
  }

  // jdhuff.c / jdarith.c process_restart: past the RSTn marker, the
  // predictions and (arithmetic) the statistics reset
  void process_restart() {
    bits = 0;
    if (unread_marker == 0) unread_marker = next_marker();
    if (unread_marker == 0xD0 + next_restart)
      unread_marker = 0;
    else
      resync(next_restart);
    next_restart = (next_restart + 1) & 7;
    for (int& dc : last_dc) dc = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (arithmetic) {
      reset_arith_stats();
      return;
    }
    if (unread_marker == 0) insufficient = false;
  }

  // ----------------------------------------------------------- arithmetic
  // jdarith.c start_pass / process_restart: the statistics of the scan's
  // tables zeroed, the predictions and the coder reset
  void reset_arith_stats() {
    for (size_t i = 0; i < scan.size(); i++) {
      const Component* c = scan[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        if (c->dc_tbl >= kArithTables) fail(kCorrupt);
        std::memset(dc_stats[c->dc_tbl], 0, sizeof(dc_stats[0]));
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || ss) {
        if (c->ac_tbl >= kArithTables) fail(kCorrupt);
        std::memset(ac_stats[c->ac_tbl], 0, sizeof(ac_stats[0]));
      }
    }
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;  // read two bytes into C first
  }

  // jdarith.c arith_decode: one binary decision with the bin `st`. At a
  // marker, and past the data's end, the coder reads zero bytes.
  int arith_decode(uint8_t* st) {
    while (ac_a < 0x8000) {
      if (--ac_ct < 0) {
        int v = 0;
        if (!unread_marker) {
          v = byte();
          if (v == 0xFF) {
            do {
              v = byte();
            } while (v == 0xFF);
            if (v == 0) {
              v = 0xFF;
            } else {
              unread_marker = v;
              v = 0;
            }
          }
        }
        ac_c = (ac_c << 8) | v;
        if ((ac_ct += 8) < 0 && ++ac_ct == 0) ac_a = 0x8000;
      }
      ac_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {  // conditional LPS exchange
        ac_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {  // conditional MPS exchange
      if (ac_a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Figures F.19-F.24: the DC difference of scan component `ci` into
  // *diff; false (the coder in its error state) on a magnitude overflow
  bool arith_dc_diff(int ci, int tbl, int* diff) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    *diff = 0;
    if (arith_decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // Table F.4: X1 = 20
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ac_ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << arith_dc_L[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > static_cast<int>((1L << arith_dc_U[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // Figure F.20 over k = ss_..se_, each value shifted left by `shift`
  // (jdarith.c decode_mcu's AC part, decode_mcu_AC_first)
  void arith_ac(int16_t* blk, int tbl, int ss_, int se_, int shift) {
    for (int k = ss_; k <= se_; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se_) {
          ac_ct = -1;  // spectral overflow
          return;
        }
      }
      const int sign = arith_decode(&fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m != 0 && arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ac_ct = -1;
            return;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] =
          static_cast<int16_t>(static_cast<unsigned>(v) << shift);
    }
  }

  // jdarith.c decode_mcu_AC_refine
  void arith_ac_refine(int16_t* blk, int tbl) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // previously nonzero
          if (arith_decode(st + 2))
            *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ac_ct = -1;
          return;
        }
      }
    }
  }

  // -------------------------------------------------------------- markers
  void skip_variable() {
    int length = header_u16();
    if (length < 2) fail(kCorrupt);
    pos += length - 2;
    if (pos > len) hit_end = true;
  }

  void read_app(int marker) {
    int length = header_u16() - 2;
    if (length < 0) fail(kCorrupt);
    size_t start = pos;
    int n = length < 14 ? length : 14;
    uint8_t b[14];
    for (int i = 0; i < n; i++) b[i] = static_cast<uint8_t>(byte());
    if (marker == 0xE0 && n >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    pos = start + length;
    if (pos > len) hit_end = true;
  }

  void read_dqt() {
    int length = header_u16() - 2;
    while (length > 0) {
      int n = header_byte();
      int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) fail(kCorrupt);
      for (int i = 0; i < 64; i++) {
        int v = prec ? header_u16() : header_byte();
        qtables[n][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qdefined[n] = true;
      length -= 65 + (prec ? 64 : 0);
    }
    if (length != 0) fail(kCorrupt);
  }

  void read_dht() {
    int length = header_u16() - 2;
    while (length > 16) {
      int index = header_byte();
      uint8_t bits_[17] = {};
      int count = 0;
      for (int l = 1; l <= 16; l++) {
        bits_[l] = static_cast<uint8_t>(header_byte());
        count += bits_[l];
      }
      length -= 17;
      if (count > 256 || count > length) fail(kCorrupt);
      uint8_t vals[256] = {};
      for (int i = 0; i < count; i++)
        vals[i] = static_cast<uint8_t>(header_byte());
      length -= count;
      bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index >= 4) fail(kCorrupt);
      HuffTable& t = is_ac ? ac_tables[index] : dc_tables[index];
      std::memcpy(t.bits, bits_, 17);
      std::memcpy(t.vals, vals, 256);
      t.defined = true;
    }
    if (length != 0) fail(kCorrupt);
  }

  // jdmarker.c get_dac
  void read_dac() {
    int length = header_u16() - 2;
    while (length > 0) {
      int index = header_byte();
      int val = header_byte();
      length -= 2;
      if (index >= 2 * kArithTables) fail(kCorrupt);
      if (index >= kArithTables) {
        arith_ac_K[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        arith_dc_L[index] = static_cast<uint8_t>(val & 0x0F);
        arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail(kCorrupt);
      }
    }
    if (length != 0) fail(kCorrupt);
  }

  void read_dri() {
    if (header_u16() != 4) fail(kCorrupt);
    restart_interval = header_u16();
  }

  // SOF0-SOF2, SOF9, SOF10 and SOF3: the frame header
  void read_sof(bool is_progressive, bool is_arithmetic = false,
                bool is_lossless = false) {
    if (saw_sof) fail(kCorrupt);
    saw_sof = true;
    progressive = is_progressive;
    arithmetic = is_arithmetic;
    lossless = is_lossless;
    int length = header_u16();
    precision = header_byte();
    height = header_u16();
    width = header_u16();
    int n = header_byte();
    if (length - 8 != n * 3) fail(kCorrupt);
    if (height <= 0 || width <= 0 || n <= 0) fail(kCorrupt);
    comps.resize(n);
    for (int i = 0; i < n; i++) {
      Component& c = comps[i];
      c.index = i;
      c.id = header_byte();
      int hv = header_byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = header_byte();
    }
  }

  // jdinput.c initial_setup, after the frame header
  void setup_frame() {
    if (precision != 8) fail(kPrecision);
    if (width > 65500 || height > 65500) fail(kCorrupt);
    int n = static_cast<int>(comps.size());
    if (n != 1 && n != 3 && n != 4) fail(kComponents);
    max_h = max_v = 1;
    for (const Component& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(kCorrupt);
      if (c.tq > 3) fail(kCorrupt);
      max_h = c.h > max_h ? c.h : max_h;
      max_v = c.v > max_v ? c.v : max_v;
    }
    // a data unit is a block of 8 x 8, or a sample in lossless files
    const int du = lossless ? 1 : 8;
    mcus_x = (width + du * max_h - 1) / (du * max_h);
    mcus_y = (height + du * max_v - 1) / (du * max_v);
    for (Component& c : comps) {
      c.width_in_blocks = static_cast<int>(
          (static_cast<int64_t>(width) * c.h + du * max_h - 1) /
          (du * max_h));
      c.height_in_blocks = static_cast<int>(
          (static_cast<int64_t>(height) * c.v + du * max_v - 1) /
          (du * max_v));
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      if (lossless) {
        c.diff.assign(static_cast<size_t>(c.bw) * c.bh, 0);
        c.samples.assign(static_cast<size_t>(c.bw) * c.bh, 0);
      } else {
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      }
      for (int& b : c.coef_bits) b = -1;
      for (int& b : c.prev_coef_bits) b = -1;
    }
  }

  // Reads markers up to the next SOS (true) or EOI (false).
  bool read_markers(bool first) {
    for (;;) {
      int marker;
      if (first) {
        if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt);
        pos = 2;
        first = false;
        continue;
      }
      if (unread_marker) {
        marker = unread_marker;
        unread_marker = 0;
      } else {
        marker = next_marker();
      }
      switch (marker) {
        case 0xC0:
        case 0xC1:
          read_sof(false);
          setup_frame();
          break;
        case 0xC2:
          read_sof(true);
          setup_frame();
          break;
        case 0xC3:
          read_sof(false, false, true);
          setup_frame();
          break;
        case 0xC9:
          read_sof(false, true);
          setup_frame();
          break;
        case 0xCA:
          read_sof(true, true);
          setup_frame();
          break;
        case 0xCB:  // lossless, arithmetic coded: no reference decodes it
          fail(kLossless);
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(kHierarchical);
        case 0xC4:
          read_dht();
          break;
        case 0xCC:
          read_dac();
          break;
        case 0xD8:
          fail(kCorrupt);  // a second SOI
        case 0xD9:
          return false;
        case 0xDA:
          if (!saw_sof) fail(kCorrupt);
          return true;
        case 0xDB:
          read_dqt();
          break;
        case 0xDC:  // DNL: ignored, as libjpeg does
          skip_variable();
          break;
        case 0xDD:
          read_dri();
          break;
        case 0xFE:
          skip_variable();
          break;
        case 0x01:
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:
          break;  // parameterless markers
        default:
          if (marker >= 0xE0 && marker <= 0xEF) {
            read_app(marker);
            break;
          }
          fail(kCorrupt);  // DHP, EXP, JPGn, RESn
      }
    }
  }

  void read_sos() {
    int length = header_u16();
    int n = header_byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) fail(kCorrupt);
    scan.clear();
    for (int i = 0; i < n; i++) {
      int id = header_byte();
      int tables = header_byte();
      Component* found = nullptr;
      for (Component& c : comps)
        if (c.id == id) {
          found = &c;
          break;
        }
      if (!found) fail(kCorrupt);
      for (Component* prev : scan)
        if (prev == found) fail(kCorrupt);
      found->dc_tbl = tables >> 4;
      found->ac_tbl = tables & 15;
      scan.push_back(found);
    }
    ss = header_byte();
    se = header_byte();
    int a = header_byte();
    ah = a >> 4;
    al = a & 15;
    next_restart = 0;
    input_scan_number++;
  }

  HuffTable& table(bool is_dc, int index) {
    if (index < 0 || index >= 4) fail(kCorrupt);
    HuffTable& t = is_dc ? dc_tables[index] : ac_tables[index];
    if (!t.defined) install_std(&t, is_dc, index);
    derive(&t, is_dc, lossless ? 16 : 15);
    return t;
  }

  // ---------------------------------------------------------------- scans
  void start_scan() {
    for (Component* c : scan) {
      if (c->latched || lossless) continue;
      if (!qdefined[c->tq]) fail(kCorrupt);
      std::memcpy(c->quant, qtables[c->tq], sizeof(c->quant));
      c->latched = true;
    }
    int blocks = 0;
    for (Component* c : scan) blocks += scan.size() == 1 ? 1 : c->h * c->v;
    if (blocks > 10) fail(kCorrupt);
    bits = 0;
    buf = 0;
    insufficient = false;
    insufficient_row = -1;
    eobrun = 0;
    for (int& dc : last_dc) dc = 0;
    restarts_to_go = restart_interval;
  }

  // Calls mcu(blocks, n) for each MCU of the scan in order, with the
  // restart handling of decode_mcu around it; `unit` gives a data unit's
  // address in its component.
  template <typename U, typename F>
  void for_each_mcu(U&& unit, F&& mcu) {
    decltype(unit(scan[0], 0, 0)) units[10];
    if (scan.size() == 1) {
      Component* c = scan[0];
      for (int row = 0; row < c->height_in_blocks; row++)
        for (int col = 0; col < c->width_in_blocks; col++) {
          if (restart_interval && restarts_to_go == 0) process_restart();
          cur_imcu_row = row / c->v;
          units[0] = unit(c, row, col);
          mcu(units, 1);
          if (restart_interval) restarts_to_go--;
        }
      return;
    }
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval && restarts_to_go == 0) process_restart();
        cur_imcu_row = my;
        int n = 0;
        for (Component* c : scan)
          for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++)
              units[n++] = unit(c, my * c->v + y, mx * c->h + x);
        mcu(units, n);
        if (restart_interval) restarts_to_go--;
      }
  }

  template <typename F>
  void for_each_block_mcu(F&& mcu) {
    for_each_mcu([](Component* c, int row, int col) {
      return c->block(row, col);
    }, mcu);
  }

  // The scan component of each block of an MCU
  std::vector<int> membership() const {
    std::vector<int> m;
    for (size_t ci = 0; ci < scan.size(); ci++) {
      int nb = scan.size() == 1 ? 1 : scan[ci]->h * scan[ci]->v;
      for (int b = 0; b < nb; b++) m.push_back(static_cast<int>(ci));
    }
    return m;
  }

  // jdhuff.c decode_mcu, jdarith.c decode_mcu
  void sequential_scan() {
    const std::vector<int> member = membership();
    if (arithmetic) {
      reset_arith_stats();
      for_each_block_mcu([&](int16_t** blocks, int n) {
        if (ac_ct == -1) return;  // the coder's error state
        for (int b = 0; b < n; b++) {
          const int ci = member[b];
          int v;
          if (!arith_dc_diff(ci, scan[ci]->dc_tbl, &v)) return;
          last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
          blocks[b][0] = static_cast<int16_t>(last_dc[ci]);
          arith_ac(blocks[b], scan[ci]->ac_tbl, 1, 63, 0);
          if (ac_ct == -1) return;
        }
      });
      return;
    }
    std::vector<const HuffTable*> dct, act;
    for (Component* c : scan) {
      dct.push_back(&table(true, c->dc_tbl));
      act.push_back(&table(false, c->ac_tbl));
    }
    for_each_block_mcu([&](int16_t** blocks, int n) {
      if (insufficient) return;
      for (int b = 0; b < n; b++) {
        const int ci = member[b];
        int16_t* blk = blocks[b];
        int s = decode_huff(*dct[ci]);
        if (s) s = extend(get_bits(s), s);
        last_dc[ci] = static_cast<int>(static_cast<unsigned>(s) +
                                       static_cast<unsigned>(last_dc[ci]));
        blk[0] = static_cast<int16_t>(last_dc[ci]);
        for (int k = 1; k < 64; k++) {
          s = decode_huff(*act[ci]);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            s = extend(get_bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(s);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      }
    });
  }

  // jdphuff.c / jdarith.c start_pass: validate and record the progression
  // (coef_bits, and the coef_bits before this scan for block smoothing)
  void progressive_scan() {
    bool bad = false;
    const bool dc_band = ss == 0;
    if (dc_band) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se >= 64) bad = true;
      if (scan.size() != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail(kCorrupt);
    for (Component* c : scan) {
      for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); k++)
        c->prev_coef_bits[k] = input_scan_number > 1 ? c->coef_bits[k] : 0;
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    }
    if (arithmetic) {
      arith_progressive_scan();
      return;
    }
    if (dc_band) {
      std::vector<const HuffTable*> dct;
      if (ah == 0)
        for (Component* c : scan) dct.push_back(&table(true, c->dc_tbl));
      const std::vector<int> member = membership();
      if (ah == 0) {
        for_each_block_mcu([&](int16_t** blocks, int n) {
          if (insufficient) return;
          for (int b = 0; b < n; b++) {
            const int ci = member[b];
            int s = decode_huff(*dct[ci]);
            if (s) s = extend(get_bits(s), s);
            last_dc[ci] = static_cast<int>(static_cast<unsigned>(s) +
                                           static_cast<unsigned>(last_dc[ci]));
            blocks[b][0] = static_cast<int16_t>(
                static_cast<unsigned>(last_dc[ci]) << al);
          }
        });
      } else {
        const int p1 = 1 << al;
        for_each_block_mcu([&](int16_t** blocks, int n) {
          for (int b = 0; b < n; b++)
            if (get_bits(1)) blocks[b][0] |= static_cast<int16_t>(p1);
        });
      }
      return;
    }
    const HuffTable& act = table(false, scan[0]->ac_tbl);
    if (ah == 0) {
      for_each_block_mcu([&](int16_t** blocks, int) {
        if (insufficient) return;
        if (eobrun > 0) {
          eobrun--;
          return;
        }
        int16_t* blk = blocks[0];
        for (int k = ss; k <= se; k++) {
          int s = decode_huff(act);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            s = extend(get_bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<unsigned>(s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1u << r;
            if (r) eobrun += static_cast<unsigned>(get_bits(r));
            eobrun--;
            break;
          }
        }
      });
      return;
    }
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    for_each_block_mcu([&](int16_t** blocks, int) {
      if (insufficient) return;
      int16_t* blk = blocks[0];
      int k = ss;
      auto refine = [&](int16_t* coef) {
        if (get_bits(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      };
      if (eobrun == 0) {
        for (; k <= se; k++) {
          int s = decode_huff(act);
          int r = s >> 4;
          s &= 15;
          if (s) {
            s = get_bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1u << r;
            if (r) eobrun += static_cast<unsigned>(get_bits(r));
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              refine(coef);
            } else {
              if (--r < 0) break;
            }
            k++;
          } while (k <= se);
          if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; k++) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) refine(coef);
        }
        eobrun--;
      }
    });
  }

  // jdarith.c decode_mcu_DC_first, _AC_first, _DC_refine, _AC_refine
  void arith_progressive_scan() {
    reset_arith_stats();
    const std::vector<int> member = membership();
    for_each_block_mcu([&](int16_t** blocks, int n) {
      if (ac_ct == -1) return;
      if (ss == 0 && ah == 0) {
        for (int b = 0; b < n; b++) {
          const int ci = member[b];
          int v;
          if (!arith_dc_diff(ci, scan[ci]->dc_tbl, &v)) return;
          last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
          blocks[b][0] = static_cast<int16_t>(
              static_cast<unsigned>(last_dc[ci]) << al);
        }
      } else if (ss == 0) {
        for (int b = 0; b < n; b++)
          if (arith_decode(&fixed_bin))
            blocks[b][0] = static_cast<int16_t>(blocks[b][0] | (1 << al));
      } else if (ah == 0) {
        arith_ac(blocks[0], scan[0]->ac_tbl, ss, se, al);
      } else {
        arith_ac_refine(blocks[0], scan[0]->ac_tbl);
      }
    });
  }

  // jdlhuff.c decode_mcus, jddiffct.c and jdlossls.c: each sample's
  // difference, then each component's rows undifferenced (T.81 Table
  // H.1's predictor `ss`, the first row of the scan and of each restart
  // interval predicted from its left neighbour) and the point transform
  // `al` undone
  void lossless_scan() {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision)
      fail(kCorrupt);
    const int per_row = scan.size() == 1 ? scan[0]->width_in_blocks : mcus_x;
    if (restart_interval % per_row) fail(kCorrupt);
    std::vector<const HuffTable*> dct;
    for (Component* c : scan) dct.push_back(&table(true, c->dc_tbl));
    const std::vector<int> member = membership();
    std::vector<bool> first_row(scan.size(), true);
    std::vector<int> next_row(scan.size(), 0);
    int mcu = 0;
    auto undifference = [&](size_t i, int row) {
      Component* c = scan[i];
      int32_t* cur = c->diff.data() + static_cast<size_t>(row) * c->bw;
      const int32_t* prev = cur - c->bw;
      const int w = c->width_in_blocks;
      int ra;
      if (first_row[i]) {
        ra = (cur[0] + (1 << (precision - al - 1))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; x++) cur[x] = ra = (cur[x] + ra) & 0xFFFF;
        first_row[i] = false;
      } else {
        int rb = prev[0], rc;
        cur[0] = ra = (cur[0] + rb) & 0xFFFF;
        for (int x = 1; x < w; x++) {
          rc = rb;
          rb = prev[x];
          int64_t pred;
          switch (ss) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = int64_t{ra} + rb - rc; break;
            case 5: pred = ra + ((int64_t{rb} - rc) >> 1); break;
            case 6: pred = rb + ((int64_t{ra} - rc) >> 1); break;
            default: pred = (int64_t{ra} + rb) >> 1; break;
          }
          cur[x] = ra = static_cast<int>((cur[x] + pred) & 0xFFFF);
        }
      }
      uint8_t* out = c->samples.data() + static_cast<size_t>(row) * c->bw;
      for (int x = 0; x < w; x++)
        out[x] = static_cast<uint8_t>(static_cast<unsigned>(cur[x]) << al);
    };
    for_each_mcu([](Component* c, int row, int col) {
      return c->diff.data() + static_cast<size_t>(row) * c->bw + col;
    }, [&](int32_t** units, int n) {
      if (restart_interval && restarts_to_go == restart_interval &&
          mcu > 0) {
        // process_restart ran before this MCU row: start_pass_lossless
        for (size_t i = 0; i < scan.size(); i++) first_row[i] = true;
      }
      for (int b = 0; b < n; b++) {
        int s = 0;
        if (!insufficient) {
          s = decode_huff(*dct[member[b]]);
          if (s == 16)
            s = 32768;
          else if (s)
            s = extend(get_bits(s), s);
        }
        *units[b] = s;
      }
      if (++mcu % per_row) return;
      // an MCU row is in: undifference its rows of each component
      for (size_t i = 0; i < scan.size(); i++) {
        Component* c = scan[i];
        const int rows = scan.size() == 1 ? 1 : c->v;
        for (int r = 0; r < rows && next_row[i] < c->height_in_blocks; r++)
          undifference(i, next_row[i]++);
      }
    });
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // file whose first AC coefficients some scan left unsent or unrefined
  bool smoothing_ok() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component& c : comps) {
      if (!c.latched) return false;
      for (int p : kPos)
        if (c.quant[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void decode_all() {
    if (!read_markers(true)) fail(kCorrupt);  // EOI before any scan
    for (;;) {
      read_sos();
      start_scan();
      if (lossless)
        lossless_scan();
      else if (progressive)
        progressive_scan();
      else
        sequential_scan();
      // the iMCU rows after the one where the data ran out hold what the
      // scans before this one sent
      last_good_imcu_row =
          insufficient_row < 0 ? mcus_y - 1 : insufficient_row;
      if (!read_markers(false)) break;
    }
  }
};

// ---------------------------------------------------------------- the IDCTs

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = static_cast<uint8_t>(i < 128 ? i + 128
                                  : i < 512 ? 255
                                  : i < 896 ? 0
                                            : i - 896);
  }
};
const RangeLimit kLimit;

inline uint8_t limit(int64_t v) { return kLimit.t[static_cast<int>(v) & 1023]; }
inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}
inline int64_t fix(double x) {
  return static_cast<int64_t>(x * (1 << kConstBits) + 0.5);
}
inline int64_t dq(const int16_t* in, const int16_t* q, int i) {
  return static_cast<int64_t>(in[i]) * q[i];
}

#define FIX_0_298631336 int64_t{2446}
#define FIX_0_390180644 int64_t{3196}
#define FIX_0_541196100 int64_t{4433}
#define FIX_0_765366865 int64_t{6270}
#define FIX_0_899976223 int64_t{7373}
#define FIX_1_175875602 int64_t{9633}
#define FIX_1_501321110 int64_t{12299}
#define FIX_1_847759065 int64_t{15137}
#define FIX_1_961570560 int64_t{16069}
#define FIX_2_053119869 int64_t{16819}
#define FIX_2_562915447 int64_t{20995}
#define FIX_3_072711026 int64_t{25172}

// jidctint.c jpeg_idct_islow
void idct_8x8(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
    int64_t tmp10, tmp11, tmp12, tmp13;
    z2 = dq(in, q, 16 + c);
    z3 = dq(in, q, 48 + c);
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(in, q, c);
    z3 = dq(in, q, 32 + c);
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = dq(in, q, 56 + c);
    tmp1 = dq(in, q, 40 + c);
    tmp2 = dq(in, q, 24 + c);
    tmp3 = dq(in, q, 8 + c);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>(descale(tmp10 + tmp3, sh));
    ws[56 + c] = static_cast<int>(descale(tmp10 - tmp3, sh));
    ws[8 + c] = static_cast<int>(descale(tmp11 + tmp2, sh));
    ws[48 + c] = static_cast<int>(descale(tmp11 - tmp2, sh));
    ws[16 + c] = static_cast<int>(descale(tmp12 + tmp1, sh));
    ws[40 + c] = static_cast<int>(descale(tmp12 - tmp1, sh));
    ws[24 + c] = static_cast<int>(descale(tmp13 + tmp0, sh));
    ws[32 + c] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
    int64_t tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (int64_t{w[0]} + w[4]) * (1 << kConstBits);
    tmp1 = (int64_t{w[0]} - w[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit(descale(tmp10 + tmp3, sh));
    o[7] = limit(descale(tmp10 - tmp3, sh));
    o[1] = limit(descale(tmp11 + tmp2, sh));
    o[6] = limit(descale(tmp11 - tmp2, sh));
    o[2] = limit(descale(tmp12 + tmp1, sh));
    o[5] = limit(descale(tmp12 - tmp1, sh));
    o[3] = limit(descale(tmp13 + tmp0, sh));
    o[4] = limit(descale(tmp13 - tmp0, sh));
  }
}

// jidctred.c jpeg_idct_1x1
void idct_1x1(const int16_t* in, const int16_t* q, uint8_t* out, int) {
  int dc = static_cast<int>(dq(in, q, 0));
  out[0] = limit(descale(dc, 3));
}

// jidctred.c jpeg_idct_2x2
void idct_2x2(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[16];
  for (int c = 0; c < 8; c++) {
    if (c == 2 || c == 4 || c == 6) continue;
    int64_t tmp10 = dq(in, q, c) * (int64_t{1} << (kConstBits + 2));
    int64_t tmp0 = dq(in, q, 56 + c) * -fix(0.720959822) +
                   dq(in, q, 40 + c) * fix(0.850430095) +
                   dq(in, q, 24 + c) * -fix(1.272758580) +
                   dq(in, q, 8 + c) * fix(3.624509785);
    const int sh = kConstBits - kPass1Bits + 2;
    ws[c] = static_cast<int>(descale(tmp10 + tmp0, sh));
    ws[8 + c] = static_cast<int>(descale(tmp10 - tmp0, sh));
  }
  for (int r = 0; r < 2; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t tmp10 = int64_t{w[0]} * (int64_t{1} << (kConstBits + 2));
    int64_t tmp0 = int64_t{w[7]} * -fix(0.720959822) +
                   int64_t{w[5]} * fix(0.850430095) +
                   int64_t{w[3]} * -fix(1.272758580) +
                   int64_t{w[1]} * fix(3.624509785);
    const int sh = kConstBits + kPass1Bits + 3 + 2;
    o[0] = limit(descale(tmp10 + tmp0, sh));
    o[1] = limit(descale(tmp10 - tmp0, sh));
  }
}

// jidctred.c jpeg_idct_4x4
void idct_4x4(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[32];
  for (int c = 0; c < 8; c++) {
    if (c == 4) continue;
    int64_t tmp0 = dq(in, q, c) * (int64_t{1} << (kConstBits + 1));
    int64_t z2 = dq(in, q, 16 + c);
    int64_t z3 = dq(in, q, 48 + c);
    int64_t tmp2 = z2 * FIX_1_847759065 + z3 * -FIX_0_765366865;
    int64_t tmp10 = tmp0 + tmp2;
    int64_t tmp12 = tmp0 - tmp2;
    int64_t z1 = dq(in, q, 56 + c);
    z2 = dq(in, q, 40 + c);
    z3 = dq(in, q, 24 + c);
    int64_t z4 = dq(in, q, 8 + c);
    tmp0 = z1 * -fix(0.211164243) + z2 * fix(1.451774981) +
           z3 * -fix(2.172734803) + z4 * fix(1.061594337);
    tmp2 = z1 * -fix(0.509795579) + z2 * -fix(0.601344887) +
           z3 * fix(0.899976223) + z4 * fix(2.562915447);
    const int sh = kConstBits - kPass1Bits + 1;
    ws[c] = static_cast<int>(descale(tmp10 + tmp2, sh));
    ws[24 + c] = static_cast<int>(descale(tmp10 - tmp2, sh));
    ws[8 + c] = static_cast<int>(descale(tmp12 + tmp0, sh));
    ws[16 + c] = static_cast<int>(descale(tmp12 - tmp0, sh));
  }
  for (int r = 0; r < 4; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t tmp0 = int64_t{w[0]} * (int64_t{1} << (kConstBits + 1));
    int64_t tmp2 = int64_t{w[2]} * FIX_1_847759065 +
                   int64_t{w[6]} * -FIX_0_765366865;
    int64_t tmp10 = tmp0 + tmp2;
    int64_t tmp12 = tmp0 - tmp2;
    int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = z1 * -fix(0.211164243) + z2 * fix(1.451774981) +
           z3 * -fix(2.172734803) + z4 * fix(1.061594337);
    tmp2 = z1 * -fix(0.509795579) + z2 * -fix(0.601344887) +
           z3 * fix(0.899976223) + z4 * fix(2.562915447);
    const int sh = kConstBits + kPass1Bits + 3 + 1;
    o[0] = limit(descale(tmp10 + tmp2, sh));
    o[3] = limit(descale(tmp10 - tmp2, sh));
    o[1] = limit(descale(tmp12 + tmp0, sh));
    o[2] = limit(descale(tmp12 - tmp0, sh));
  }
}

// jidctint.c jpeg_idct_3x3
void idct_3x3(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[9];
  for (int c = 0; c < 3; c++) {
    int64_t tmp0 = dq(in, q, c) * (1 << kConstBits);
    tmp0 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t tmp12 = dq(in, q, 16 + c) * fix(0.707106781);
    int64_t tmp10 = tmp0 + tmp12;
    int64_t tmp2 = tmp0 - tmp12 - tmp12;
    tmp0 = dq(in, q, 8 + c) * fix(1.224744871);
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp10 + tmp0) >> sh);
    ws[6 + c] = static_cast<int>((tmp10 - tmp0) >> sh);
    ws[3 + c] = static_cast<int>(tmp2 >> sh);
  }
  for (int r = 0; r < 3; r++) {
    const int* w = ws + 3 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t tmp0 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                   (1 << kConstBits);
    int64_t tmp12 = int64_t{w[2]} * fix(0.707106781);
    int64_t tmp10 = tmp0 + tmp12;
    int64_t tmp2 = tmp0 - tmp12 - tmp12;
    tmp0 = int64_t{w[1]} * fix(1.224744871);
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp10 + tmp0) >> sh);
    o[2] = limit((tmp10 - tmp0) >> sh);
    o[1] = limit(tmp2 >> sh);
  }
}

// jidctint.c jpeg_idct_5x5
void idct_5x5(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[25];
  for (int c = 0; c < 5; c++) {
    int64_t tmp12 = dq(in, q, c) * (1 << kConstBits);
    tmp12 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t tmp0 = dq(in, q, 16 + c);
    int64_t tmp1 = dq(in, q, 32 + c);
    int64_t z1 = (tmp0 + tmp1) * fix(0.790569415);
    int64_t z2 = (tmp0 - tmp1) * fix(0.353553391);
    int64_t z3 = tmp12 + z2;
    int64_t tmp10 = z3 + z1;
    int64_t tmp11 = z3 - z1;
    tmp12 -= z2 * 4;
    z2 = dq(in, q, 8 + c);
    z3 = dq(in, q, 24 + c);
    z1 = (z2 + z3) * fix(0.831253876);
    tmp0 = z1 + z2 * fix(0.513743148);
    tmp1 = z1 - z3 * fix(2.176250899);
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp10 + tmp0) >> sh);
    ws[20 + c] = static_cast<int>((tmp10 - tmp0) >> sh);
    ws[5 + c] = static_cast<int>((tmp11 + tmp1) >> sh);
    ws[15 + c] = static_cast<int>((tmp11 - tmp1) >> sh);
    ws[10 + c] = static_cast<int>(tmp12 >> sh);
  }
  for (int r = 0; r < 5; r++) {
    const int* w = ws + 5 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t tmp12 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                    (1 << kConstBits);
    int64_t tmp0 = w[2];
    int64_t tmp1 = w[4];
    int64_t z1 = (tmp0 + tmp1) * fix(0.790569415);
    int64_t z2 = (tmp0 - tmp1) * fix(0.353553391);
    int64_t z3 = tmp12 + z2;
    int64_t tmp10 = z3 + z1;
    int64_t tmp11 = z3 - z1;
    tmp12 -= z2 * 4;
    z2 = w[1];
    z3 = w[3];
    z1 = (z2 + z3) * fix(0.831253876);
    tmp0 = z1 + z2 * fix(0.513743148);
    tmp1 = z1 - z3 * fix(2.176250899);
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp10 + tmp0) >> sh);
    o[4] = limit((tmp10 - tmp0) >> sh);
    o[1] = limit((tmp11 + tmp1) >> sh);
    o[3] = limit((tmp11 - tmp1) >> sh);
    o[2] = limit(tmp12 >> sh);
  }
}

// jidctint.c jpeg_idct_6x6
void idct_6x6(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[36];
  for (int c = 0; c < 6; c++) {
    int64_t tmp0 = dq(in, q, c) * (1 << kConstBits);
    tmp0 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t tmp2 = dq(in, q, 32 + c);
    int64_t tmp10 = tmp2 * fix(0.707106781);
    int64_t tmp1 = tmp0 + tmp10;
    int64_t tmp11 = (tmp0 - tmp10 - tmp10) >> (kConstBits - kPass1Bits);
    tmp10 = dq(in, q, 16 + c);
    tmp0 = tmp10 * fix(1.224744871);
    tmp10 = tmp1 + tmp0;
    int64_t tmp12 = tmp1 - tmp0;
    int64_t z1 = dq(in, q, 8 + c);
    int64_t z2 = dq(in, q, 24 + c);
    int64_t z3 = dq(in, q, 40 + c);
    tmp1 = (z1 + z3) * fix(0.366025404);
    tmp0 = tmp1 + (z1 + z2) * (1 << kConstBits);
    tmp2 = tmp1 + (z3 - z2) * (1 << kConstBits);
    tmp1 = (z1 - z2 - z3) * (1 << kPass1Bits);
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp10 + tmp0) >> sh);
    ws[30 + c] = static_cast<int>((tmp10 - tmp0) >> sh);
    ws[6 + c] = static_cast<int>(tmp11 + tmp1);
    ws[24 + c] = static_cast<int>(tmp11 - tmp1);
    ws[12 + c] = static_cast<int>((tmp12 + tmp2) >> sh);
    ws[18 + c] = static_cast<int>((tmp12 - tmp2) >> sh);
  }
  for (int r = 0; r < 6; r++) {
    const int* w = ws + 6 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t tmp0 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                   (1 << kConstBits);
    int64_t tmp2 = w[4];
    int64_t tmp10 = tmp2 * fix(0.707106781);
    int64_t tmp1 = tmp0 + tmp10;
    int64_t tmp11 = tmp0 - tmp10 - tmp10;
    tmp10 = w[2];
    tmp0 = tmp10 * fix(1.224744871);
    tmp10 = tmp1 + tmp0;
    int64_t tmp12 = tmp1 - tmp0;
    int64_t z1 = w[1], z2 = w[3], z3 = w[5];
    tmp1 = (z1 + z3) * fix(0.366025404);
    tmp0 = tmp1 + (z1 + z2) * (1 << kConstBits);
    tmp2 = tmp1 + (z3 - z2) * (1 << kConstBits);
    tmp1 = (z1 - z2 - z3) * (1 << kConstBits);
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp10 + tmp0) >> sh);
    o[5] = limit((tmp10 - tmp0) >> sh);
    o[1] = limit((tmp11 + tmp1) >> sh);
    o[4] = limit((tmp11 - tmp1) >> sh);
    o[2] = limit((tmp12 + tmp2) >> sh);
    o[3] = limit((tmp12 - tmp2) >> sh);
  }
}

// jidctint.c jpeg_idct_7x7
void idct_7x7(const int16_t* in, const int16_t* q, uint8_t* out,
              int stride) {
  int ws[49];
  for (int c = 0; c < 7; c++) {
    int64_t tmp13 = dq(in, q, c) * (1 << kConstBits);
    tmp13 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t z1 = dq(in, q, 16 + c);
    int64_t z2 = dq(in, q, 32 + c);
    int64_t z3 = dq(in, q, 48 + c);
    int64_t tmp10 = (z2 - z3) * fix(0.881747734);
    int64_t tmp12 = (z1 - z2) * fix(0.314692123);
    int64_t tmp11 = tmp10 + tmp12 + tmp13 - z2 * fix(1.841218003);
    int64_t tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = tmp0 * fix(1.274162392) + tmp13;
    tmp10 += tmp0 - z3 * fix(0.077722536);
    tmp12 += tmp0 - z1 * fix(2.470602249);
    tmp13 += z2 * fix(1.414213562);
    z1 = dq(in, q, 8 + c);
    z2 = dq(in, q, 24 + c);
    z3 = dq(in, q, 40 + c);
    int64_t tmp1 = (z1 + z2) * fix(0.935414347);
    int64_t tmp2 = (z1 - z2) * fix(0.170262339);
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = (z2 + z3) * -fix(1.378756276);
    tmp1 += tmp2;
    z2 = (z1 + z3) * fix(0.613604268);
    tmp0 += z2;
    tmp2 += z2 + z3 * fix(1.870828693);
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp10 + tmp0) >> sh);
    ws[42 + c] = static_cast<int>((tmp10 - tmp0) >> sh);
    ws[7 + c] = static_cast<int>((tmp11 + tmp1) >> sh);
    ws[35 + c] = static_cast<int>((tmp11 - tmp1) >> sh);
    ws[14 + c] = static_cast<int>((tmp12 + tmp2) >> sh);
    ws[28 + c] = static_cast<int>((tmp12 - tmp2) >> sh);
    ws[21 + c] = static_cast<int>(tmp13 >> sh);
  }
  for (int r = 0; r < 7; r++) {
    const int* w = ws + 7 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t tmp13 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                    (1 << kConstBits);
    int64_t z1 = w[2], z2 = w[4], z3 = w[6];
    int64_t tmp10 = (z2 - z3) * fix(0.881747734);
    int64_t tmp12 = (z1 - z2) * fix(0.314692123);
    int64_t tmp11 = tmp10 + tmp12 + tmp13 - z2 * fix(1.841218003);
    int64_t tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = tmp0 * fix(1.274162392) + tmp13;
    tmp10 += tmp0 - z3 * fix(0.077722536);
    tmp12 += tmp0 - z1 * fix(2.470602249);
    tmp13 += z2 * fix(1.414213562);
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    int64_t tmp1 = (z1 + z2) * fix(0.935414347);
    int64_t tmp2 = (z1 - z2) * fix(0.170262339);
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = (z2 + z3) * -fix(1.378756276);
    tmp1 += tmp2;
    z2 = (z1 + z3) * fix(0.613604268);
    tmp0 += z2;
    tmp2 += z2 + z3 * fix(1.870828693);
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp10 + tmp0) >> sh);
    o[6] = limit((tmp10 - tmp0) >> sh);
    o[1] = limit((tmp11 + tmp1) >> sh);
    o[5] = limit((tmp11 - tmp1) >> sh);
    o[2] = limit((tmp12 + tmp2) >> sh);
    o[4] = limit((tmp12 - tmp2) >> sh);
    o[3] = limit(tmp13 >> sh);
  }
}

// jidctint.c jpeg_idct_10x10: a chroma block upscaled at 5/8 on 4:2:0
void idct_10x10(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[80];
  for (int c = 0; c < 8; c++) {
    int64_t z3 = dq(in, q, c) * (1 << kConstBits);
    z3 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t z4 = dq(in, q, 32 + c);
    int64_t z1 = z4 * fix(1.144122806);
    int64_t z2 = z4 * fix(0.437016024);
    int64_t tmp10 = z3 + z1;
    int64_t tmp11 = z3 - z2;
    int64_t tmp22 = (z3 - (z1 - z2) * 2) >> (kConstBits - kPass1Bits);
    z2 = dq(in, q, 16 + c);
    z3 = dq(in, q, 48 + c);
    z1 = (z2 + z3) * fix(0.831253876);
    int64_t tmp12 = z1 + z2 * fix(0.513743148);
    int64_t tmp13 = z1 - z3 * fix(2.176250899);
    int64_t tmp20 = tmp10 + tmp12;
    int64_t tmp24 = tmp10 - tmp12;
    int64_t tmp21 = tmp11 + tmp13;
    int64_t tmp23 = tmp11 - tmp13;
    z1 = dq(in, q, 8 + c);
    z2 = dq(in, q, 24 + c);
    z3 = dq(in, q, 40 + c);
    z4 = dq(in, q, 56 + c);
    tmp11 = z2 + z4;
    tmp13 = z2 - z4;
    tmp12 = tmp13 * fix(0.309016994);
    int64_t z5 = z3 * (1 << kConstBits);
    z2 = tmp11 * fix(0.951056516);
    z4 = z5 + tmp12;
    tmp10 = z1 * fix(1.396802247) + z2 + z4;
    int64_t tmp14 = z1 * fix(0.221231742) - z2 + z4;
    z2 = tmp11 * fix(0.587785252);
    z4 = z5 - tmp12 - tmp13 * (1 << (kConstBits - 1));
    tmp12 = (z1 - tmp13 - z3) * (1 << kPass1Bits);
    tmp11 = z1 * fix(1.260073511) - z2 - z4;
    tmp13 = z1 * fix(0.642039522) - z2 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp20 + tmp10) >> sh);
    ws[72 + c] = static_cast<int>((tmp20 - tmp10) >> sh);
    ws[8 + c] = static_cast<int>((tmp21 + tmp11) >> sh);
    ws[64 + c] = static_cast<int>((tmp21 - tmp11) >> sh);
    ws[16 + c] = static_cast<int>(tmp22 + tmp12);
    ws[56 + c] = static_cast<int>(tmp22 - tmp12);
    ws[24 + c] = static_cast<int>((tmp23 + tmp13) >> sh);
    ws[48 + c] = static_cast<int>((tmp23 - tmp13) >> sh);
    ws[32 + c] = static_cast<int>((tmp24 + tmp14) >> sh);
    ws[40 + c] = static_cast<int>((tmp24 - tmp14) >> sh);
  }
  for (int r = 0; r < 10; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t z3 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                 (1 << kConstBits);
    int64_t z4 = w[4];
    int64_t z1 = z4 * fix(1.144122806);
    int64_t z2 = z4 * fix(0.437016024);
    int64_t tmp10 = z3 + z1;
    int64_t tmp11 = z3 - z2;
    int64_t tmp22 = z3 - (z1 - z2) * 2;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * fix(0.831253876);
    int64_t tmp12 = z1 + z2 * fix(0.513743148);
    int64_t tmp13 = z1 - z3 * fix(2.176250899);
    int64_t tmp20 = tmp10 + tmp12;
    int64_t tmp24 = tmp10 - tmp12;
    int64_t tmp21 = tmp11 + tmp13;
    int64_t tmp23 = tmp11 - tmp13;
    z1 = w[1];
    z2 = w[3];
    z3 = int64_t{w[5]} * (1 << kConstBits);
    z4 = w[7];
    tmp11 = z2 + z4;
    tmp13 = z2 - z4;
    tmp12 = tmp13 * fix(0.309016994);
    z2 = tmp11 * fix(0.951056516);
    z4 = z3 + tmp12;
    tmp10 = z1 * fix(1.396802247) + z2 + z4;
    int64_t tmp14 = z1 * fix(0.221231742) - z2 + z4;
    z2 = tmp11 * fix(0.587785252);
    z4 = z3 - tmp12 - tmp13 * (1 << (kConstBits - 1));
    tmp12 = (z1 - tmp13) * (1 << kConstBits) - z3;
    tmp11 = z1 * fix(1.260073511) - z2 - z4;
    tmp13 = z1 * fix(0.642039522) - z2 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp20 + tmp10) >> sh);
    o[9] = limit((tmp20 - tmp10) >> sh);
    o[1] = limit((tmp21 + tmp11) >> sh);
    o[8] = limit((tmp21 - tmp11) >> sh);
    o[2] = limit((tmp22 + tmp12) >> sh);
    o[7] = limit((tmp22 - tmp12) >> sh);
    o[3] = limit((tmp23 + tmp13) >> sh);
    o[6] = limit((tmp23 - tmp13) >> sh);
    o[4] = limit((tmp24 + tmp14) >> sh);
    o[5] = limit((tmp24 - tmp14) >> sh);
  }
}

// jidctint.c jpeg_idct_12x12: a chroma block upscaled at 6/8 on 4:2:0
void idct_12x12(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[96];
  for (int c = 0; c < 8; c++) {
    int64_t z3 = dq(in, q, c) * (1 << kConstBits);
    z3 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t z4 = dq(in, q, 32 + c) * fix(1.224744871);
    int64_t tmp10 = z3 + z4;
    int64_t tmp11 = z3 - z4;
    int64_t z1 = dq(in, q, 16 + c);
    z4 = z1 * fix(1.366025404);
    z1 *= 1 << kConstBits;
    int64_t z2 = dq(in, q, 48 + c) * (1 << kConstBits);
    int64_t tmp12 = z1 - z2;
    int64_t tmp21 = z3 + tmp12;
    int64_t tmp24 = z3 - tmp12;
    tmp12 = z4 + z2;
    int64_t tmp20 = tmp10 + tmp12;
    int64_t tmp25 = tmp10 - tmp12;
    tmp12 = z4 - z1 - z2;
    int64_t tmp22 = tmp11 + tmp12;
    int64_t tmp23 = tmp11 - tmp12;
    z1 = dq(in, q, 8 + c);
    z2 = dq(in, q, 24 + c);
    z3 = dq(in, q, 40 + c);
    z4 = dq(in, q, 56 + c);
    tmp11 = z2 * fix(1.306562965);
    int64_t tmp14 = z2 * -FIX_0_541196100;
    tmp10 = z1 + z3;
    int64_t tmp15 = (tmp10 + z4) * fix(0.860918669);
    tmp12 = tmp15 + tmp10 * fix(0.261052384);
    tmp10 = tmp12 + tmp11 + z1 * fix(0.280143716);
    int64_t tmp13 = (z3 + z4) * -fix(1.045510580);
    tmp12 += tmp13 + tmp14 - z3 * fix(1.478575242);
    tmp13 += tmp15 - tmp11 + z4 * fix(1.586706681);
    tmp15 += tmp14 - z1 * fix(0.676326758) - z4 * fix(1.982889723);
    z1 -= z4;
    z2 -= z3;
    z3 = (z1 + z2) * FIX_0_541196100;
    tmp11 = z3 + z1 * FIX_0_765366865;
    tmp14 = z3 - z2 * FIX_1_847759065;
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp20 + tmp10) >> sh);
    ws[88 + c] = static_cast<int>((tmp20 - tmp10) >> sh);
    ws[8 + c] = static_cast<int>((tmp21 + tmp11) >> sh);
    ws[80 + c] = static_cast<int>((tmp21 - tmp11) >> sh);
    ws[16 + c] = static_cast<int>((tmp22 + tmp12) >> sh);
    ws[72 + c] = static_cast<int>((tmp22 - tmp12) >> sh);
    ws[24 + c] = static_cast<int>((tmp23 + tmp13) >> sh);
    ws[64 + c] = static_cast<int>((tmp23 - tmp13) >> sh);
    ws[32 + c] = static_cast<int>((tmp24 + tmp14) >> sh);
    ws[56 + c] = static_cast<int>((tmp24 - tmp14) >> sh);
    ws[40 + c] = static_cast<int>((tmp25 + tmp15) >> sh);
    ws[48 + c] = static_cast<int>((tmp25 - tmp15) >> sh);
  }
  for (int r = 0; r < 12; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t z3 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                 (1 << kConstBits);
    int64_t z4 = int64_t{w[4]} * fix(1.224744871);
    int64_t tmp10 = z3 + z4;
    int64_t tmp11 = z3 - z4;
    int64_t z1 = w[2];
    z4 = z1 * fix(1.366025404);
    z1 *= 1 << kConstBits;
    int64_t z2 = int64_t{w[6]} * (1 << kConstBits);
    int64_t tmp12 = z1 - z2;
    int64_t tmp21 = z3 + tmp12;
    int64_t tmp24 = z3 - tmp12;
    tmp12 = z4 + z2;
    int64_t tmp20 = tmp10 + tmp12;
    int64_t tmp25 = tmp10 - tmp12;
    tmp12 = z4 - z1 - z2;
    int64_t tmp22 = tmp11 + tmp12;
    int64_t tmp23 = tmp11 - tmp12;
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    z4 = w[7];
    tmp11 = z2 * fix(1.306562965);
    int64_t tmp14 = z2 * -FIX_0_541196100;
    tmp10 = z1 + z3;
    int64_t tmp15 = (tmp10 + z4) * fix(0.860918669);
    tmp12 = tmp15 + tmp10 * fix(0.261052384);
    tmp10 = tmp12 + tmp11 + z1 * fix(0.280143716);
    int64_t tmp13 = (z3 + z4) * -fix(1.045510580);
    tmp12 += tmp13 + tmp14 - z3 * fix(1.478575242);
    tmp13 += tmp15 - tmp11 + z4 * fix(1.586706681);
    tmp15 += tmp14 - z1 * fix(0.676326758) - z4 * fix(1.982889723);
    z1 -= z4;
    z2 -= z3;
    z3 = (z1 + z2) * FIX_0_541196100;
    tmp11 = z3 + z1 * FIX_0_765366865;
    tmp14 = z3 - z2 * FIX_1_847759065;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp20 + tmp10) >> sh);
    o[11] = limit((tmp20 - tmp10) >> sh);
    o[1] = limit((tmp21 + tmp11) >> sh);
    o[10] = limit((tmp21 - tmp11) >> sh);
    o[2] = limit((tmp22 + tmp12) >> sh);
    o[9] = limit((tmp22 - tmp12) >> sh);
    o[3] = limit((tmp23 + tmp13) >> sh);
    o[8] = limit((tmp23 - tmp13) >> sh);
    o[4] = limit((tmp24 + tmp14) >> sh);
    o[7] = limit((tmp24 - tmp14) >> sh);
    o[5] = limit((tmp25 + tmp15) >> sh);
    o[6] = limit((tmp25 - tmp15) >> sh);
  }
}

// jidctint.c jpeg_idct_14x14: a chroma block upscaled at 7/8 on 4:2:0
void idct_14x14(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[112];
  for (int c = 0; c < 8; c++) {
    int64_t z1 = dq(in, q, c) * (1 << kConstBits);
    z1 += int64_t{1} << (kConstBits - kPass1Bits - 1);
    int64_t z4 = dq(in, q, 32 + c);
    int64_t z2 = z4 * fix(1.274162392);
    int64_t z3 = z4 * fix(0.314692123);
    z4 = z4 * fix(0.881747734);
    int64_t tmp10 = z1 + z2;
    int64_t tmp11 = z1 + z3;
    int64_t tmp12 = z1 - z4;
    int64_t tmp23 = (z1 - (z2 + z3 - z4) * 2) >> (kConstBits - kPass1Bits);
    z1 = dq(in, q, 16 + c);
    z2 = dq(in, q, 48 + c);
    z3 = (z1 + z2) * fix(1.105676686);
    int64_t tmp13 = z3 + z1 * fix(0.273079590);
    int64_t tmp14 = z3 - z2 * fix(1.719280954);
    int64_t tmp15 = z1 * fix(0.613604268) - z2 * fix(1.378756276);
    int64_t tmp20 = tmp10 + tmp13;
    int64_t tmp26 = tmp10 - tmp13;
    int64_t tmp21 = tmp11 + tmp14;
    int64_t tmp25 = tmp11 - tmp14;
    int64_t tmp22 = tmp12 + tmp15;
    int64_t tmp24 = tmp12 - tmp15;
    z1 = dq(in, q, 8 + c);
    z2 = dq(in, q, 24 + c);
    z3 = dq(in, q, 40 + c);
    z4 = dq(in, q, 56 + c);
    tmp13 = z4 * (1 << kConstBits);
    tmp14 = z1 + z3;
    tmp11 = (z1 + z2) * fix(1.334852607);
    tmp12 = tmp14 * fix(1.197448846);
    tmp10 = tmp11 + tmp12 + tmp13 - z1 * fix(1.126980169);
    tmp14 = tmp14 * fix(0.752406978);
    int64_t tmp16 = tmp14 - z1 * fix(1.061150426);
    z1 -= z2;
    tmp15 = z1 * fix(0.467085129) - tmp13;
    tmp16 += tmp15;
    z1 += z4;
    z4 = (z2 + z3) * -fix(0.158341681) - tmp13;
    tmp11 += z4 - z2 * fix(0.424103948);
    tmp12 += z4 - z3 * fix(2.373959773);
    z4 = (z3 - z2) * fix(1.405321284);
    tmp14 += z4 + tmp13 - z3 * fix(1.6906431334);
    tmp15 += z4 + z2 * fix(0.674957567);
    tmp13 = (z1 - z3) * (1 << kPass1Bits);
    const int sh = kConstBits - kPass1Bits;
    ws[c] = static_cast<int>((tmp20 + tmp10) >> sh);
    ws[104 + c] = static_cast<int>((tmp20 - tmp10) >> sh);
    ws[8 + c] = static_cast<int>((tmp21 + tmp11) >> sh);
    ws[96 + c] = static_cast<int>((tmp21 - tmp11) >> sh);
    ws[16 + c] = static_cast<int>((tmp22 + tmp12) >> sh);
    ws[88 + c] = static_cast<int>((tmp22 - tmp12) >> sh);
    ws[24 + c] = static_cast<int>(tmp23 + tmp13);
    ws[80 + c] = static_cast<int>(tmp23 - tmp13);
    ws[32 + c] = static_cast<int>((tmp24 + tmp14) >> sh);
    ws[72 + c] = static_cast<int>((tmp24 - tmp14) >> sh);
    ws[40 + c] = static_cast<int>((tmp25 + tmp15) >> sh);
    ws[64 + c] = static_cast<int>((tmp25 - tmp15) >> sh);
    ws[48 + c] = static_cast<int>((tmp26 + tmp16) >> sh);
    ws[56 + c] = static_cast<int>((tmp26 - tmp16) >> sh);
  }
  for (int r = 0; r < 14; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t z1 = (int64_t{w[0]} + (1 << (kPass1Bits + 2))) *
                 (1 << kConstBits);
    int64_t z4 = w[4];
    int64_t z2 = z4 * fix(1.274162392);
    int64_t z3 = z4 * fix(0.314692123);
    z4 = z4 * fix(0.881747734);
    int64_t tmp10 = z1 + z2;
    int64_t tmp11 = z1 + z3;
    int64_t tmp12 = z1 - z4;
    int64_t tmp23 = z1 - (z2 + z3 - z4) * 2;
    z1 = w[2];
    z2 = w[6];
    z3 = (z1 + z2) * fix(1.105676686);
    int64_t tmp13 = z3 + z1 * fix(0.273079590);
    int64_t tmp14 = z3 - z2 * fix(1.719280954);
    int64_t tmp15 = z1 * fix(0.613604268) - z2 * fix(1.378756276);
    int64_t tmp20 = tmp10 + tmp13;
    int64_t tmp26 = tmp10 - tmp13;
    int64_t tmp21 = tmp11 + tmp14;
    int64_t tmp25 = tmp11 - tmp14;
    int64_t tmp22 = tmp12 + tmp15;
    int64_t tmp24 = tmp12 - tmp15;
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    z4 = int64_t{w[7]} * (1 << kConstBits);
    tmp14 = z1 + z3;
    tmp11 = (z1 + z2) * fix(1.334852607);
    tmp12 = tmp14 * fix(1.197448846);
    tmp10 = tmp11 + tmp12 + z4 - z1 * fix(1.126980169);
    tmp14 = tmp14 * fix(0.752406978);
    int64_t tmp16 = tmp14 - z1 * fix(1.061150426);
    z1 -= z2;
    tmp15 = z1 * fix(0.467085129) - z4;
    tmp16 += tmp15;
    tmp13 = (z2 + z3) * -fix(0.158341681) - z4;
    tmp11 += tmp13 - z2 * fix(0.424103948);
    tmp12 += tmp13 - z3 * fix(2.373959773);
    tmp13 = (z3 - z2) * fix(1.405321284);
    tmp14 += tmp13 + z4 - z3 * fix(1.6906431334);
    tmp15 += tmp13 + z2 * fix(0.674957567);
    tmp13 = (z1 - z3) * (1 << kConstBits) + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit((tmp20 + tmp10) >> sh);
    o[13] = limit((tmp20 - tmp10) >> sh);
    o[1] = limit((tmp21 + tmp11) >> sh);
    o[12] = limit((tmp21 - tmp11) >> sh);
    o[2] = limit((tmp22 + tmp12) >> sh);
    o[11] = limit((tmp22 - tmp12) >> sh);
    o[3] = limit((tmp23 + tmp13) >> sh);
    o[10] = limit((tmp23 - tmp13) >> sh);
    o[4] = limit((tmp24 + tmp14) >> sh);
    o[9] = limit((tmp24 - tmp14) >> sh);
    o[5] = limit((tmp25 + tmp15) >> sh);
    o[8] = limit((tmp25 - tmp15) >> sh);
    o[6] = limit((tmp26 + tmp16) >> sh);
    o[7] = limit((tmp26 - tmp16) >> sh);
  }
}

using IdctFn = void (*)(const int16_t*, const int16_t*, uint8_t*, int);

IdctFn idct_for(int size) {
  switch (size) {
    case 1: return idct_1x1;
    case 2: return idct_2x2;
    case 3: return idct_3x3;
    case 4: return idct_4x4;
    case 5: return idct_5x5;
    case 6: return idct_6x6;
    case 7: return idct_7x7;
    case 8: return idct_8x8;
    case 10: return idct_10x10;
    case 12: return idct_12x12;
    case 14: return idct_14x14;
    default: fail(kSampling);
  }
}

// ------------------------------------------------------------- upsampling

inline int64_t div_round_up(int64_t a, int64_t b) { return (a + b - 1) / b; }

// One component at output resolution: its IDCT plane (dw x dh samples of
// its `pw`-wide plane are real) upsampled as jdsample.c's method for its
// ratio does, into `out` (ow x oh).
void upsample(const std::vector<uint8_t>& plane, int pw, int dw, int dh,
              int h_in, int v_in, int h_out, int v_out, bool fancy,
              std::vector<uint8_t>* out, int ow, int oh) {
  out->assign(static_cast<size_t>(ow) * oh, 0);
  uint8_t* o = out->data();
  auto row = [&](int r) -> const uint8_t* {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return plane.data() + static_cast<size_t>(r) * pw;
  };
  if (h_in == h_out && v_in == v_out) {  // fullsize_upsample
    for (int y = 0; y < oh; y++)
      std::memcpy(o + static_cast<size_t>(y) * ow,
                  plane.data() + static_cast<size_t>(y) * pw, ow);
    return;
  }
  std::vector<uint8_t> line(2 * static_cast<size_t>(dw) + 2);
  // h2v1_fancy_upsample of one input row into `line`
  auto h2v1_fancy = [&](const uint8_t* in) {
    uint8_t* p = line.data();
    int invalue = in[0];
    *p++ = static_cast<uint8_t>(invalue);
    *p++ = static_cast<uint8_t>((invalue * 3 + in[1] + 2) >> 2);
    for (int col = 1; col < dw - 1; col++) {
      invalue = in[col] * 3;
      *p++ = static_cast<uint8_t>((invalue + in[col - 1] + 1) >> 2);
      *p++ = static_cast<uint8_t>((invalue + in[col + 1] + 2) >> 2);
    }
    invalue = in[dw - 1];
    *p++ = static_cast<uint8_t>((invalue * 3 + in[dw - 2] + 1) >> 2);
    *p++ = static_cast<uint8_t>(invalue);
  };
  if (h_in * 2 == h_out && v_in == v_out) {
    for (int y = 0; y < oh; y++) {
      const uint8_t* in = plane.data() + static_cast<size_t>(y) * pw;
      uint8_t* dst = o + static_cast<size_t>(y) * ow;
      if (fancy && dw > 2) {
        h2v1_fancy(in);
        std::memcpy(dst, line.data(), ow);
      } else {
        for (int x = 0; x < ow; x++) dst[x] = in[x >> 1];
      }
    }
    return;
  }
  if (h_in == h_out && v_in * 2 == v_out && fancy) {  // h1v2_fancy_upsample
    for (int y = 0; y < oh; y++) {
      const int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* dst = o + static_cast<size_t>(y) * ow;
      for (int x = 0; x < ow; x++)
        dst[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  if (h_in * 2 == h_out && v_in * 2 == v_out) {
    if (fancy && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> sum(dw);
      for (int y = 0; y < oh; y++) {
        const int r = y >> 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
        for (int x = 0; x < dw; x++) sum[x] = in0[x] * 3 + in1[x];
        uint8_t* p = line.data();
        int thiscolsum = sum[0], nextcolsum = sum[1], lastcolsum;
        *p++ = static_cast<uint8_t>((thiscolsum * 4 + 8) >> 4);
        *p++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
        for (int col = 2; col < dw; col++) {
          nextcolsum = sum[col];
          *p++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
          *p++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
          lastcolsum = thiscolsum;
          thiscolsum = nextcolsum;
        }
        *p++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
        *p++ = static_cast<uint8_t>((thiscolsum * 4 + 7) >> 4);
        std::memcpy(o + static_cast<size_t>(y) * ow, line.data(), ow);
      }
    } else {  // h2v2_upsample
      for (int y = 0; y < oh; y++) {
        const uint8_t* in = plane.data() + static_cast<size_t>(y >> 1) * pw;
        uint8_t* dst = o + static_cast<size_t>(y) * ow;
        for (int x = 0; x < ow; x++) dst[x] = in[x >> 1];
      }
    }
    return;
  }
  if (h_out % h_in == 0 && v_out % v_in == 0) {  // int_upsample
    const int he = h_out / h_in, ve = v_out / v_in;
    for (int y = 0; y < oh; y++) {
      const uint8_t* in = plane.data() + static_cast<size_t>(y / ve) * pw;
      uint8_t* dst = o + static_cast<size_t>(y) * ow;
      for (int x = 0; x < ow; x++) dst[x] = in[x / he];
    }
    return;
  }
  fail(kSampling);
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScaleBits = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScaleBits - 1);
    auto fix16 = [](double x) {
      return static_cast<int64_t>(x * (int64_t{1} << kScaleBits) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix16(1.40200) * x + kHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix16(1.77200) * x + kHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jdcoefct.c decompress_smooth_data for one component: each block's
// first nine AC coefficients, where still zero and not known to full
// precision, estimated from the DC values of its 5 x 5 neighbourhood
// (and, where no AC coefficient was sent at all, its DC too), then the
// IDCT. The coef_bits of an iMCU row after `last_good` are those from
// before the latest scan.
void smooth_idct(const Decoder& d, Component& c, const int* cur_bits,
                 const int* prev_bits, const int16_t* q, IdctFn idct,
                 int ssize, uint8_t* plane, int pw) {
  const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8],
                Q20 = c.quant[16], Q11 = c.quant[9], Q02 = c.quant[2],
                Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17],
                Q30 = c.quant[24];
  const int V = c.v, T = d.mcus_y;
  const int last_col = c.width_in_blocks - 1;
  int16_t ws[64];
  for (int R = 0; R < T; R++) {
    int block_rows = V;
    if (R == T - 1) {
      block_rows = c.height_in_blocks % V;
      if (block_rows == 0) block_rows = V;
    }
    const int* bits = R > d.last_good_imcu_row ? prev_bits : cur_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; k++)
      if (bits[k] != -1) change_dc = false;
    for (int br = 0; br < block_rows; br++) {
      // the rows above and below as libjpeg-turbo 2.1 picks them: by the
      // block row within the iMCU row and the iMCU row's place
      const int row = R * V + br;
      const int prow = br > 0 || R > 0 ? row - 1 : row;
      const int pprow = br > 1 || R > 1 ? row - 2 : prow;
      const int nrow = br < block_rows - 1 || R < T - 1 ? row + 1 : row;
      const int nnrow =
          br < block_rows - 2 || R + 1 < T - 1 ? row + 2 : nrow;
      auto dc = [&](int r, int col) { return int{c.block(r, col)[0]}; };
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
          DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
          DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = dc(pprow, 0);
      DC06 = DC07 = DC08 = DC09 = DC10 = dc(prow, 0);
      DC11 = DC12 = DC13 = DC14 = DC15 = dc(row, 0);
      DC16 = DC17 = DC18 = DC19 = DC20 = dc(nrow, 0);
      DC21 = DC22 = DC23 = DC24 = DC25 = dc(nnrow, 0);
      for (int bn = 0; bn <= last_col; bn++) {
        std::memcpy(ws, c.block(row, bn), sizeof(ws));
        if (bn == 0 && bn < last_col) {
          DC04 = DC05 = dc(pprow, 1);
          DC09 = DC10 = dc(prow, 1);
          DC14 = DC15 = dc(row, 1);
          DC19 = DC20 = dc(nrow, 1);
          DC24 = DC25 = dc(nnrow, 1);
        }
        if (bn + 1 < last_col) {
          DC05 = dc(pprow, bn + 2);
          DC10 = dc(prow, bn + 2);
          DC15 = dc(row, bn + 2);
          DC20 = dc(nrow, bn + 2);
          DC25 = dc(nnrow, bn + 2);
        }
        // pred = round(num / (Q << 8)), limited below 2^Al where Al > 0
        auto estimate = [](int64_t num, int64_t q, int al, bool limit) {
          int pred;
          if (num >= 0) {
            pred = static_cast<int>(((q << 7) + num) / (q << 8));
            if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          } else {
            pred = static_cast<int>(((q << 7) - num) / (q << 8));
            if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
          }
          return static_cast<int16_t>(pred);
        };
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          const int64_t num =
              Q00 * (change_dc
                         ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                            13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                            38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                            13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                            DC24 + DC25)
                         : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = estimate(num, Q01, al, true);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          const int64_t num =
              Q00 * (change_dc
                         ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                            DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                            DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                            DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                         : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = estimate(num, Q10, al, true);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          const int64_t num =
              Q00 * (change_dc
                         ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                            5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                            7 * DC18 + 2 * DC19 + DC23)
                         : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                            DC23));
          ws[16] = estimate(num, Q20, al, true);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          const int64_t num =
              Q00 * (change_dc
                         ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                            9 * DC19 + DC21 - DC25)
                         : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                            DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                            10 * DC09));
          ws[9] = estimate(num, Q11, al, true);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          const int64_t num =
              Q00 * (change_dc
                         ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                            7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                            2 * DC17 - 5 * DC18 + 2 * DC19)
                         : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                            DC15));
          ws[2] = estimate(num, Q02, al, true);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                    DC17 - DC19),
                             Q03, al, true);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                     3 * DC18 - DC19),
                              Q12, al, true);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                     DC17 - DC19),
                              Q21, al, true);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                     2 * DC18 - DC19),
                              Q30, al, true);
          ws[0] = estimate(
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                     6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                     8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                     8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25),
              Q00, 0, false);
        }
        idct(ws, q, plane + static_cast<size_t>(row) * ssize * pw +
                        static_cast<size_t>(bn) * ssize,
             pw);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// The colour space libjpeg reads (jdapimin.c default_decompress_parms;
// libjpeg-turbo 3's for lossless files, whose three components are RGB
// unless a JFIF or an Adobe segment says YCbCr)
enum ColourSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

ColourSpace colour_space(const Decoder& d) {
  const int n = static_cast<int>(d.comps.size());
  if (n == 1) return kGray;
  if (n == 4) {
    if (d.saw_adobe && d.adobe_transform != 0) return kYCCK;
    return kCMYK;
  }
  if (d.saw_jfif) return kYCbCr;
  if (d.saw_adobe) return d.adobe_transform == 0 ? kRGB : kYCbCr;
  if (d.lossless) return kRGB;
  const bool rgb_ids = d.comps[0].id == 'R' && d.comps[1].id == 'G' &&
                       d.comps[2].id == 'B';
  return rgb_ids ? kRGB : kYCbCr;
}

int decode(const uint8_t* data, size_t len, int scale_num, bool native,
           uint8_t* out, size_t cap, int* out_w, int* out_h, int* channels) {
  if (scale_num < 1 || scale_num > 8) return kBadScale;
  Decoder d(data, len);
  d.decode_all();
  const int n = static_cast<int>(d.comps.size());
  const ColourSpace space = colour_space(d);
  // libjpeg-turbo 2.1 decodes neither CMYK/YCCK to RGB nor lossless
  // files; Pillow decodes them whole, at full size, and converts no
  // colour in a lossless file
  const bool pillow_only = n == 4 || d.lossless;
  if (d.lossless && (space == kYCbCr || space == kYCCK)) return kLossless;
  if (pillow_only && d.hit_end) return kTruncated;
  if (pillow_only && scale_num != 8) return kPillowScale;
  const int nout = native ? (n == 4 ? 4 : n == 1 ? 1 : 3) : 3;

  // jdmaster.c: output size and each component's scaled DCT size
  const int min_size = scale_num;
  const int ow = static_cast<int>(div_round_up(int64_t{d.width} * min_size, 8));
  const int oh = static_cast<int>(div_round_up(int64_t{d.height} * min_size, 8));
  if (cap < static_cast<size_t>(ow) * oh * nout) return kCapacity;
  const bool smooth = d.smoothing_ok();
  std::vector<std::vector<uint8_t>> full(n);
  for (int ci = 0; ci < n; ci++) {
    Component& c = d.comps[ci];
    if (d.lossless) {  // one sample a data unit, box upsampling
      upsample(c.samples, c.bw, c.width_in_blocks, c.height_in_blocks, c.h,
               c.v, d.max_h, d.max_v, false, &full[ci], ow, oh);
      continue;
    }
    int ssize = min_size;
    while (ssize < 8 && (d.max_h * min_size) % (c.h * ssize * 2) == 0 &&
           (d.max_v * min_size) % (c.v * ssize * 2) == 0)
      ssize *= 2;
    const int dw = static_cast<int>(div_round_up(
        int64_t{d.width} * c.h * ssize, int64_t{d.max_h} * 8));
    const int dh = static_cast<int>(div_round_up(
        int64_t{d.height} * c.v * ssize, int64_t{d.max_v} * 8));
    const int pw = c.width_in_blocks * ssize;
    const int ph = c.height_in_blocks * ssize;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    int16_t q[64];
    for (int i = 0; i < 64; i++) q[i] = static_cast<int16_t>(c.quant[i]);
    IdctFn idct = idct_for(ssize);
    if (smooth) {
      int prev_bits[10];
      for (int k = 1; k < 10; k++)
        prev_bits[k] = d.input_scan_number > 1 ? c.prev_coef_bits[k] : -1;
      smooth_idct(d, c, c.coef_bits, prev_bits, q, idct, ssize,
                  plane.data(), pw);
    } else {
      for (int by = 0; by < c.height_in_blocks; by++)
        for (int bx = 0; bx < c.width_in_blocks; bx++)
          idct(c.block(by, bx), q,
               plane.data() + static_cast<size_t>(by) * ssize * pw +
                   static_cast<size_t>(bx) * ssize,
               pw);
    }
    const int h_in = c.h * ssize / min_size;
    const int v_in = c.v * ssize / min_size;
    upsample(plane, pw, dw, dh, h_in, v_in, d.max_h, d.max_v, min_size > 1,
             &full[ci], ow, oh);
  }

  const size_t npix = static_cast<size_t>(ow) * oh;
  if (n == 1) {
    const uint8_t* g = full[0].data();
    for (size_t i = 0; i < npix; i++)
      for (int k = 0; k < nout; k++) out[nout * i + k] = g[i];
  } else if (space == kRGB) {
    for (size_t i = 0; i < npix; i++)
      for (int k = 0; k < 3; k++) out[3 * i + k] = full[k][i];
  } else if (space == kYCbCr) {
    const uint8_t *yp = full[0].data(), *cbp = full[1].data(),
                  *crp = full[2].data();
    for (size_t i = 0; i < npix; i++) {
      const int y = yp[i], cb = cbp[i], cr = crp[i];
      out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
      out[3 * i + 1] = clamp255(
          y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
  } else {
    // libjpeg's CMYK (jdcolor.c ycck_cmyk_convert for YCCK), inverted by
    // Pillow's "CMYK;I" unpacker; as RGB, Convert.c cmyk2rgb
    for (size_t i = 0; i < npix; i++) {
      int cmyk[4];
      if (space == kYCCK) {
        const int y = full[0][i], cb = full[1][i], cr = full[2][i];
        cmyk[0] = clamp255(255 - (y + kYcc.cr_r[cr]));
        cmyk[1] = clamp255(255 - (y + static_cast<int>(
                                          (kYcc.cb_g[cb] + kYcc.cr_g[cr]) >>
                                          16)));
        cmyk[2] = clamp255(255 - (y + kYcc.cb_b[cb]));
      } else {
        for (int k = 0; k < 3; k++) cmyk[k] = full[k][i];
      }
      cmyk[3] = full[3][i];
      for (int& v : cmyk) v = 255 - v;
      if (nout == 4) {
        for (int k = 0; k < 4; k++)
          out[4 * i + k] = static_cast<uint8_t>(cmyk[k]);
        continue;
      }
      const int nk = 255 - cmyk[3];
      for (int k = 0; k < 3; k++) {
        const int tmp = cmyk[k] * nk + 128;
        out[3 * i + k] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
      }
    }
  }
  *out_w = ow;
  *out_h = oh;
  *channels = nout;
  return kOk;
}

}  // namespace

extern "C" int jpeg_decode_info(const uint8_t* data, size_t len, int* width,
                                int* height) {
  try {
    Decoder d(data, len);
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
    d.pos = 2;
    for (;;) {
      int marker = d.next_marker();
      if (marker == 0xD9 || marker == 0xDA) return kCorrupt;
      if ((marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        d.read_sof(marker == 0xC2);
        *width = d.width;
        *height = d.height;
        return kOk;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (marker == 0xD8) return kCorrupt;
      d.skip_variable();
    }
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return kCorrupt;
  }
}

extern "C" int jpeg_decode(const uint8_t* data, size_t len, int scale_num,
                           int native, uint8_t* out, size_t out_capacity,
                           int* out_width, int* out_height, int* channels) {
  try {
    return decode(data, len, scale_num, native != 0, out, out_capacity,
                  out_width, out_height, channels);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return kCorrupt;
  }
}

