// A self-contained JPEG decoder for the host data path: baseline and
// progressive Huffman-coded files, 8-bit, grayscale or three components,
// with a DCT-domain prescale of scale_num/8 (scale_num 1-8).
//
// Its output equals libjpeg-turbo's with JDCT_ISLOW, do_fancy_upsampling
// and JCS_RGB bit for bit, which is what Pillow and the JAX package's
// libjpeg binding (native/jpeg_decode.cpp) return. It follows libjpeg's
// own code, file by file:
//   jdmarker.c   markers, tables, JFIF / Adobe colour-space hints
//   jdhuff.c     sequential Huffman decoding, zero bits past the data's end
//   jdphuff.c    progressive DC/AC first and refinement scans, EOB runs
//   jddctmgr.c   the IDCT chosen by each component's scaled DCT size
//   jidctint.c   jpeg_idct_islow (8x8) and the 3x3/5x5/6x6/7x7 and
//                10x10/12x12/14x14 IDCTs
//   jidctred.c   jpeg_idct_1x1, 2x2, 4x4
//   jdmaster.c   output size and each component's scaled DCT size
//   jdsample.c   fancy (triangle) and box upsampling
//   jdcolor.c    YCbCr -> RGB, gray -> RGB
// It keeps no state between calls and needs no library but the C++ one.
//
// Files it does not decode return a negative code (see `Status`): the
// caller names the feature and falls back to another decoder or raises.
//
// C API (ctypes, see drn_wsod_torch/native.py):
//   jpeg_decode_info(data, len, &w, &h)            -> 0 once a frame
//                                                     header parsed
//   jpeg_decode(data, len, scale_num, out, cap,
//               &out_w, &out_h)                    -> 0 on success; RGB8
//     output is ceil(dim * scale_num / 8); `cap` is out's size in bytes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kCorrupt = -1,          // a header or table that does not parse
  kBadScale = -2,         // scale_num outside 1-8
  kCapacity = -3,         // the output buffer is too small
  kArithmetic = -4,       // SOF9-SOF15: arithmetic coding
  kLossless = -5,         // SOF3: lossless coding
  kPrecision = -6,        // sample precision other than 8 bits (12-bit)
  kFourComponents = -7,   // CMYK or YCCK
  kTruncatedProgressive = -8,  // libjpeg would apply block smoothing
  kSampling = -9,         // sampling factors libjpeg cannot upsample
  kHierarchical = -10,    // SOF5-SOF7: differential (hierarchical) coding
  kComponents = -11,      // 2 components, or more than 4
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

void derive(HuffTable* t, bool is_dc) {
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
      if (t->vals[i] > 15) fail(kCorrupt);
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
  int dc_tbl = 0, ac_tbl = 0;
  int16_t* block(int row, int col) {
    return coef.data() + (static_cast<size_t>(row) * bw + col) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;

  // header state
  bool saw_sof = false, progressive = false;
  int precision = 8, width = 0, height = 0;
  std::vector<Component> comps;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  uint16_t qtables[4][64] = {};
  bool qdefined[4] = {};
  HuffTable dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;

  // scan state
  int unread_marker = 0;
  uint64_t buf = 0;
  int bits = 0;
  bool insufficient = false;
  int next_restart = 0;
  int restarts_to_go = 0;
  int last_dc[4] = {};
  unsigned eobrun = 0;
  std::vector<Component*> scan;
  int ss = 0, se = 63, ah = 0, al = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}

  // ---------------------------------------------------------------- bytes
  // Past the end the source yields an EOI marker, as jpeg_mem_src's fake
  // FF D9 does.
  int byte() { return pos < len ? data[pos++] : -1; }

  int header_byte() {
    if (pos >= len) fail(kCorrupt);
    return data[pos++];
  }

  int header_u16() {
    int hi = header_byte();
    return (hi << 8) | header_byte();
  }

  // jdmarker.c next_marker: skip to the next FF xx (xx not 00 or FF)
  int next_marker() {
    for (;;) {
      int c = byte();
      if (c < 0) return 0xD9;
      while (c != 0xFF) {
        c = byte();
        if (c < 0) return 0xD9;
      }
      do {
        c = byte();
      } while (c == 0xFF);
      if (c < 0) return 0xD9;
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
        if (c < 0) {
          unread_marker = 0xD9;
          break;
        }
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c < 0) {
            unread_marker = 0xD9;
            break;
          }
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
    if (unread_marker == 0) insufficient = false;
  }

  // -------------------------------------------------------------- markers
  void skip_variable() {
    int length = header_u16();
    if (length < 2) fail(kCorrupt);
    pos += length - 2;
    if (pos > len) pos = len;
  }

  void read_app(int marker) {
    int length = header_u16() - 2;
    if (length < 0) fail(kCorrupt);
    size_t start = pos;
    int n = length < 14 ? length : 14;
    if (start + n > len) n = static_cast<int>(len - start);
    const uint8_t* b = data + start;
    if (marker == 0xE0 && n >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    pos = start + length;
    if (pos > len) pos = len;
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

  void read_dri() {
    if (header_u16() != 4) fail(kCorrupt);
    restart_interval = header_u16();
  }

  void read_sof(bool is_progressive) {
    if (saw_sof) fail(kCorrupt);
    saw_sof = true;
    progressive = is_progressive;
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
    if (n == 4) fail(kFourComponents);
    if (n != 1 && n != 3) fail(kComponents);
    max_h = max_v = 1;
    for (const Component& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(kCorrupt);
      if (c.tq > 3) fail(kCorrupt);
      max_h = c.h > max_h ? c.h : max_h;
      max_v = c.v > max_v ? c.v : max_v;
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (Component& c : comps) {
      c.width_in_blocks = static_cast<int>(
          (static_cast<int64_t>(width) * c.h + 8 * max_h - 1) / (8 * max_h));
      c.height_in_blocks = static_cast<int>(
          (static_cast<int64_t>(height) * c.v + 8 * max_v - 1) /
          (8 * max_v));
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int& b : c.coef_bits) b = -1;
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
          fail(kLossless);
        case 0xC5:
        case 0xC6:
        case 0xC7:
          fail(kHierarchical);
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(kArithmetic);
        case 0xC4:
          read_dht();
          break;
        case 0xCC:  // DAC: arithmetic conditioning, unused by Huffman
          skip_variable();
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
  }

  HuffTable& table(bool is_dc, int index) {
    if (index < 0 || index >= 4) fail(kCorrupt);
    HuffTable& t = is_dc ? dc_tables[index] : ac_tables[index];
    if (!t.defined) install_std(&t, is_dc, index);
    derive(&t, is_dc);
    return t;
  }

  // ---------------------------------------------------------------- scans
  void start_scan() {
    for (Component* c : scan) {
      if (c->latched) continue;
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
    eobrun = 0;
    for (int& dc : last_dc) dc = 0;
    restarts_to_go = restart_interval;
  }

  // Calls mcu(blocks) for each MCU of the scan in order, with the restart
  // handling of decode_mcu around it.
  template <typename F>
  void for_each_mcu(F&& mcu) {
    int16_t* blocks[10];
    if (scan.size() == 1) {
      Component* c = scan[0];
      for (int row = 0; row < c->height_in_blocks; row++)
        for (int col = 0; col < c->width_in_blocks; col++) {
          if (restart_interval && restarts_to_go == 0) process_restart();
          blocks[0] = c->block(row, col);
          mcu(blocks, 1);
          if (restart_interval) restarts_to_go--;
        }
      return;
    }
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval && restarts_to_go == 0) process_restart();
        int n = 0;
        for (Component* c : scan)
          for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++)
              blocks[n++] = c->block(my * c->v + y, mx * c->h + x);
        mcu(blocks, n);
        if (restart_interval) restarts_to_go--;
      }
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

  // jdhuff.c decode_mcu
  void sequential_scan() {
    std::vector<const HuffTable*> dct, act;
    for (Component* c : scan) {
      dct.push_back(&table(true, c->dc_tbl));
      act.push_back(&table(false, c->ac_tbl));
    }
    const std::vector<int> member = membership();
    for_each_mcu([&](int16_t** blocks, int n) {
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

  // jdphuff.c start_pass_phuff_decoder: validate and record the progression
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
    for (Component* c : scan)
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;

    if (dc_band) {
      std::vector<const HuffTable*> dct;
      if (ah == 0)
        for (Component* c : scan) dct.push_back(&table(true, c->dc_tbl));
      const std::vector<int> member = membership();
      if (ah == 0) {
        for_each_mcu([&](int16_t** blocks, int n) {
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
        for_each_mcu([&](int16_t** blocks, int n) {
          for (int b = 0; b < n; b++)
            if (get_bits(1)) blocks[b][0] |= static_cast<int16_t>(p1);
        });
      }
      return;
    }
    const HuffTable& act = table(false, scan[0]->ac_tbl);
    if (ah == 0) {
      for_each_mcu([&](int16_t** blocks, int) {
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
    for_each_mcu([&](int16_t** blocks, int) {
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

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // file whose first AC coefficients some scan left unsent or unrefined
  bool would_smooth() const {
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
      if (progressive)
        progressive_scan();
      else
        sequential_scan();
      if (!read_markers(false)) break;
    }
    if (would_smooth()) fail(kTruncatedProgressive);
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

int decode(const uint8_t* data, size_t len, int scale_num, uint8_t* out,
           size_t cap, int* out_w, int* out_h) {
  if (scale_num < 1 || scale_num > 8) return kBadScale;
  Decoder d(data, len);
  d.decode_all();

  // jdmaster.c: output size and each component's scaled DCT size
  const int min_size = scale_num;
  const int ow = static_cast<int>(div_round_up(int64_t{d.width} * min_size, 8));
  const int oh = static_cast<int>(div_round_up(int64_t{d.height} * min_size, 8));
  if (cap < static_cast<size_t>(ow) * oh * 3) return kCapacity;
  const bool fancy = min_size > 1;
  const int n = static_cast<int>(d.comps.size());
  std::vector<std::vector<uint8_t>> full(n);
  for (int ci = 0; ci < n; ci++) {
    Component& c = d.comps[ci];
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
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++)
        idct(c.block(by, bx), q,
             plane.data() + static_cast<size_t>(by) * ssize * pw +
                 static_cast<size_t>(bx) * ssize,
             pw);
    const int h_in = c.h * ssize / min_size;
    const int v_in = c.v * ssize / min_size;
    upsample(plane, pw, dw, dh, h_in, v_in, d.max_h, d.max_v, fancy,
             &full[ci], ow, oh);
  }

  // jdapimin.c default_decompress_parms: the colour space
  bool rgb_as_stored = false;
  if (n == 3 && !d.saw_jfif) {
    if (d.saw_adobe)
      rgb_as_stored = d.adobe_transform == 0;
    else
      rgb_as_stored = d.comps[0].id == 'R' && d.comps[1].id == 'G' &&
                      d.comps[2].id == 'B';
  }
  const size_t npix = static_cast<size_t>(ow) * oh;
  if (n == 1) {
    const uint8_t* g = full[0].data();
    for (size_t i = 0; i < npix; i++)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
  } else if (rgb_as_stored) {
    for (size_t i = 0; i < npix; i++)
      for (int k = 0; k < 3; k++) out[3 * i + k] = full[k][i];
  } else {
    const uint8_t *yp = full[0].data(), *cbp = full[1].data(),
                  *crp = full[2].data();
    for (size_t i = 0; i < npix; i++) {
      const int y = yp[i], cb = cbp[i], cr = crp[i];
      out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
      out[3 * i + 1] = clamp255(
          y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
  }
  *out_w = ow;
  *out_h = oh;
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
                           uint8_t* out, size_t out_capacity, int* out_width,
                           int* out_height) {
  try {
    return decode(data, len, scale_num, out, out_capacity, out_width,
                  out_height);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return kCorrupt;
  }
}
