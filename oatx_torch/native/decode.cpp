// decode.cpp — the port's first-party JPEG / MJPEG-in-AVI reader and writer.
//
// oatx reads clips through FFmpeg (oatx/native/oatx_decode.cpp). This library
// is the port's own decoder for JPEG-coded media, in C++17 with nothing
// beyond the C++ standard library, so it builds with the host compiler alone
// wherever the port runs. It reads:
//   * MJPEG in an AVI (RIFF) container: the frames are the video stream's
//     `NNdc` / `NNdb` chunks, from `idx1` when present, else by walking
//     `movi`; frame rate from `strh` (dwRate / dwScale). The frame count is
//     the count of non-empty video chunks (oatx's count_frames_by_packets).
//   * a bare JPEG still (starts with FF D8): one frame at 25 fps, as FFmpeg's
//     image demuxer reports it.
// The container is sniffed from the content, never from the file name. Every
// frame is intra-coded, so only the requested chunks are read and
// entropy-decoded; indices past the end clamp to the last frame (the lax
// semantics of oatx's reader). H.264 in an mp4 / mov is demuxed by mp4.cpp
// and decoded by h264.h's decoder (one a handle, made at its first decode)
// to NV12, which the caller turns RGB (oatxt_h264_decode).
//
// JPEG: baseline and extended-sequential 8-bit Huffman (SOF0 / SOF1), DQT,
// DHT (the Annex K tables when a stream carries none, as AVI1 MJPEG does),
// DRI with restart markers, interleaved and single-component scans, 1 or 3
// components at 4:4:4, 4:2:2, 4:4:0 or 4:2:0. Progressive, lossless,
// hierarchical, arithmetic-coded and 12-bit JPEG, other subsamplings and any
// non-JPEG codec return kUnsupported.
//
// Colour and size follow what oatx's reader returns (FFmpeg's MJPEG decoder
// → yuvj4xxp planes → swscale to RGB24, SWS_BILINEAR): full-range BT.601
// through swscale's yuv2rgb tables; at the native size, 4:2:0 / 4:2:2 chroma
// repeated per 2×2 / 2×1 block (the unscaled yuv2rgb path); a short-side
// resize through swscale's bilinear filters (initFilter's coefficients, the
// 15-bit horizontal and 12-bit vertical fixed point, one chroma sample per
// two output pixels) and its output size rule (compute_out_size).
//
// The writer reproduces oatx_write_test_video_ex's YUV planes (seed 0's
// historical pattern, the golden-angle chroma of other seeds, the frame-index
// stamp in the top-left 8×8 luma block) and codes them as baseline 4:2:0 JPEG
// with the Annex K tables at quality 90 (FFmpeg's qscale 2 is similar), in an
// AVI with `idx1`, or one frame as a bare JPEG still.
//
// C ABI for ctypes (oatx_torch/data/video_reader.py); errors are negative
// return codes with a per-thread message (oatxt_last_error). No global state
// but constant tables: one handle per thread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <vector>

#include <sys/types.h>

#include "h264.h"
#include "mp4.h"

namespace {

enum : int {
  kOk = 0,
  kOpenFailed = -1,    // the file cannot be opened or read
  kCorrupt = -2,       // truncated or malformed container / JPEG data
  kUnsupported = -3,   // media this decoder does not read
  kBadBuffer = -100,   // the caller sized the output buffer wrong
};

thread_local std::string g_error;

int fail(int code, const std::string& msg) {
  g_error = msg;
  return code;
}

// ------------------------------------------------------------------ tables

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.3 Huffman tables: code counts per length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

// Annex K.1 quantization tables, natural (row-major) order
const uint8_t kQuantLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kQuantChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const int kWriterQuality = 90;
const int64_t kMaxPixels = 1LL << 28;  // a frame header asking for more is refused

// kDct[x][u] = C(u)/2 · cos((2x+1)uπ/16): the orthonormal 8-point DCT basis
struct DctBasis {
  float m[8][8];
  DctBasis() {
    for (int x = 0; x < 8; x++)
      for (int u = 0; u < 8; u++)
        m[x][u] = (float)((u == 0 ? std::sqrt(0.5) : 1.0) / 2.0 *
                          std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0));
  }
};
const DctBasis kDct;

// swscale's full-range BT.601 yuv → RGB offsets (ff_yuv2rgb_c_init_tables
// with ff_yuv2rgb_coeffs[SWS_CS_DEFAULT] scaled by 224/255, then by cy=1<<16
// with its +0x8000 rounding): channel = clip(Y + table[U or V])
struct ColorTables {
  int rv[256], gu[256], gv[256], bu[256];
  ColorTables() {
    const int64_t crv = 91881, cbu = 116129, cgu = -22552, cgv = -46800;
    for (int i = 0; i < 256; i++) {
      rv[i] = (int)(((int64_t)i * crv) >> 16) - (int)(crv >> 9);
      bu[i] = (int)(((int64_t)i * cbu) >> 16) - (int)(cbu >> 9);
      gu[i] = (int)(((int64_t)i * cgu) >> 16) - (int)(cgu >> 9);
      gv[i] = (int)(((int64_t)i * cgv) >> 16) - (int)(cgv >> 9);
    }
  }
};
const ColorTables kColor;

// The unscaled yuv420p / yuv422p → rgb24 converter FFmpeg runs on x86
// (yuv_2_rgb.asm): 16-bit fixed point, (U − 128)·8 and (V − 128)·8 times
// the same coefficients rounded to 13 fractional bits, each product's high
// 16 bits (pmulhw, floored).
struct SimdColorTables {
  int rv[256], gu[256], gv[256], bu[256];
  SimdColorTables() {
    const int vr = 11485, ub = 14516, ug = -2819, vg = -5850;
    for (int i = 0; i < 256; i++) {
      const int c = (i - 128) * 8;
      rv[i] = (c * vr) >> 16;
      bu[i] = (c * ub) >> 16;
      gu[i] = (c * ug) >> 16;
      gv[i] = (c * vg) >> 16;
    }
  }
};
const SimdColorTables kColorUnscaled;

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// clip to 0..255 by lookup: y in 0..255 plus a chroma offset in ±(227 + 135)
struct ClipTable {
  uint8_t t[1024];
  ClipTable() {
    for (int i = 0; i < 1024; i++) t[i] = clip8(i - 384);
  }
  uint8_t operator()(int v) const { return t[v + 384]; }
};
const ClipTable kClip;

// RGB24 of one row: pixels 2k and 2k+1 share chroma sample k (or each has
// its own with `full`); y, u, v already in 0..255
template <typename Tables>
void rgb_row(const Tables& tb, const int* y, const int* u, const int* v, int w, bool full,
             uint8_t* d) {
  for (int x = 0; x < w; x++) {
    const int ci = full ? x : x >> 1;
    const int r = tb.rv[v[ci]], g = tb.gu[u[ci]] + tb.gv[v[ci]], b = tb.bu[u[ci]];
    d[3 * x] = kClip(y[x] + r);
    d[3 * x + 1] = kClip(y[x] + g);
    d[3 * x + 2] = kClip(y[x] + b);
  }
}

// ------------------------------------------------------------ JPEG decoder

struct Huffman {
  bool present = false;
  uint8_t fast_len[512];   // 9-bit lookahead: code length (0 = longer code)
  uint8_t fast_val[512];
  int maxcode[18];         // per length, the largest code (-1 if none)
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];

  bool build(const uint8_t bits[16], const uint8_t* v, int nvals) {
    int total = 0;
    for (int i = 0; i < 16; i++) total += bits[i];
    if (total != nvals || total > 256) return false;
    std::memcpy(vals, v, nvals);
    std::memset(fast_len, 0, sizeof fast_len);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < bits[len - 1]; i++, k++, code++) {
        if (code >= (1 << len)) return false;  // over-subscribed
        if (len <= 9) {
          int shift = 9 - len;
          for (int f = 0; f < (1 << shift); f++) {
            fast_len[(code << shift) | f] = (uint8_t)len;
            fast_val[(code << shift) | f] = vals[k];
          }
        }
      }
      maxcode[len] = bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
    return true;
  }
};

// Entropy-coded segment reader: unstuffs FF 00, stops at a marker (then
// feeds zero bits) so restart markers can be consumed between intervals.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;

  BitReader(const uint8_t* b, const uint8_t* e) : p(b), end(e) {}

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
          } else {
            at_marker = true;  // leave p on the marker
          }
        } else {
          byte = *p++;
        }
      }
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int n) {
    if (bits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return (int)v;
  }
  // between restart intervals: drop the padding bits, consume RSTn
  void restart() {
    buf = 0;
    bits = 0;
    // the interval's padding byte may not have been read yet
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00)) p += p[0] == 0xFF ? 2 : 1;
    if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      at_marker = false;
    }
  }
  // where the scan's data ended (the next marker)
  const uint8_t* data_end() const {
    const uint8_t* q = p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      q++;
    return q;
  }
};

inline int decode_huff(BitReader& br, const Huffman& h) {
  uint32_t look = br.peek(9);
  int len = h.fast_len[look];
  if (len) {
    br.skip(len);
    return h.fast_val[look];
  }
  uint32_t code16 = br.peek(16);
  for (int l = 10; l <= 16; l++) {
    int c = (int)(code16 >> (16 - l));
    if (c <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[h.valptr[l] + c - h.mincode[l]];
    }
  }
  return -1;
}

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;            // Huffman table selectors of the current scan
  int pred = 0;                  // DC predictor
  int bw = 0, bh = 0;            // blocks in the (MCU-padded) plane
  int stride = 0;
  int width = 0, height = 0;     // the component's own sample size
  std::vector<uint8_t> plane;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool have_sof = false;
  uint16_t qt[4][64];            // zigzag order
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
};

// One 8×8 block: IDCT of dequantized natural-order coefficients into dst.
void idct_put(const float* coef, bool ac_zero, uint8_t* dst, int stride) {
  if (ac_zero) {
    uint8_t v = clip8((int)std::lrint(coef[0] / 8.0f) + 128);
    for (int y = 0; y < 8; y++) std::memset(dst + y * stride, v, 8);
    return;
  }
  float tmp[64];
  for (int v = 0; v < 8; v++) {
    const float* row = coef + v * 8;
    bool zero = true;
    for (int u = 0; u < 8; u++) zero = zero && row[u] == 0.0f;
    for (int x = 0; x < 8; x++) {
      float s = 0.0f;
      if (!zero)
        for (int u = 0; u < 8; u++) s += kDct.m[x][u] * row[u];
      tmp[v * 8 + x] = s;
    }
  }
  for (int x = 0; x < 8; x++) {
    for (int y = 0; y < 8; y++) {
      float s = 0.0f;
      for (int v = 0; v < 8; v++) s += kDct.m[y][v] * tmp[v * 8 + x];
      dst[y * stride + x] = clip8((int)std::lrint(s) + 128);
    }
  }
}

int decode_block(BitReader& br, Jpeg& j, Component& c, uint8_t* dst) {
  const Huffman& dch = j.dc[c.td];
  const Huffman& ach = j.ac[c.ta];
  const uint16_t* q = j.qt[c.tq];
  float coef[64] = {0};
  int t = decode_huff(br, dch);
  if (t < 0 || t > 11) return fail(kCorrupt, "bad DC Huffman code");
  int diff = t ? extend(br.get(t), t) : 0;
  c.pred += diff;
  coef[0] = (float)c.pred * (float)q[0];
  bool ac_zero = true;
  for (int k = 1; k < 64;) {
    int rs = decode_huff(br, ach);
    if (rs < 0) return fail(kCorrupt, "bad AC Huffman code");
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r != 15) break;  // EOB
      k += 16;
      continue;
    }
    k += r;
    if (k > 63) return fail(kCorrupt, "AC run past the block");
    coef[kZigzag[k]] = (float)extend(br.get(s), s) * (float)q[k];
    ac_zero = false;
    k++;
  }
  idct_put(coef, ac_zero, dst, c.stride);
  return kOk;
}

int parse_sof(Jpeg& j, const uint8_t* p, int len, bool progressive_etc) {
  if (progressive_etc)
    return fail(kUnsupported, "progressive, lossless, hierarchical or arithmetic-coded "
                              "JPEG is not supported (baseline / extended sequential only)");
  if (len < 6) return fail(kCorrupt, "short SOF");
  if (p[0] != 8) return fail(kUnsupported, std::to_string(p[0]) + "-bit JPEG is not supported");
  j.height = (p[1] << 8) | p[2];
  j.width = (p[3] << 8) | p[4];
  j.ncomp = p[5];
  if (j.width <= 0 || j.height <= 0) return fail(kCorrupt, "JPEG with a zero dimension");
  if ((int64_t)j.width * j.height > kMaxPixels)
    return fail(kUnsupported, "JPEG larger than " + std::to_string(kMaxPixels) + " pixels");
  if (j.ncomp != 1 && j.ncomp != 3)
    return fail(kUnsupported, std::to_string(j.ncomp) + "-component JPEG is not supported");
  if (len < 6 + 3 * j.ncomp) return fail(kCorrupt, "short SOF");
  j.hmax = j.vmax = 1;
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return fail(kCorrupt, "bad sampling factor");
    j.hmax = std::max(j.hmax, c.h);
    j.vmax = std::max(j.vmax, c.v);
  }
  if (j.ncomp == 1) {
    j.comp[0].h = j.comp[0].v = j.hmax = j.vmax = 1;
  } else {
    if (j.comp[0].h != j.hmax || j.comp[0].v != j.vmax)
      return fail(kUnsupported, "JPEG whose luma is not the densest component");
    for (int i = 1; i < 3; i++) {
      int fh = j.hmax / j.comp[i].h, fv = j.vmax / j.comp[i].v;
      if (j.hmax % j.comp[i].h || j.vmax % j.comp[i].v || fh > 2 || fv > 2 ||
          j.comp[i].h != j.comp[1].h || j.comp[i].v != j.comp[1].v)
        return fail(kUnsupported, "JPEG chroma subsampling other than 4:4:4, 4:2:2, "
                                  "4:4:0 or 4:2:0 is not supported");
    }
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    c.bw = j.mcux * c.h;
    c.bh = j.mcuy * c.v;
    c.stride = c.bw * 8;
    c.width = (j.width * c.h + j.hmax - 1) / j.hmax;
    c.height = (j.height * c.v + j.vmax - 1) / j.vmax;
  }
  j.have_sof = true;
  return kOk;
}

int decode_scan(Jpeg& j, const uint8_t* hdr, int len, const uint8_t* data,
                const uint8_t* end, const uint8_t** scan_end) {
  if (!j.have_sof) return fail(kCorrupt, "SOS before SOF");
  if (len < 1) return fail(kCorrupt, "short SOS");
  int ns = hdr[0];
  if (ns < 1 || ns > j.ncomp || len < 4 + 2 * ns) return fail(kCorrupt, "bad SOS");
  Component* sc[3];
  for (int i = 0; i < ns; i++) {
    int cid = hdr[1 + 2 * i];
    Component* found = nullptr;
    for (int k = 0; k < j.ncomp; k++)
      if (j.comp[k].id == cid) found = &j.comp[k];
    if (!found) return fail(kCorrupt, "SOS names an unknown component");
    found->td = hdr[2 + 2 * i] >> 4;
    found->ta = hdr[2 + 2 * i] & 15;
    if (found->td > 3 || found->ta > 3) return fail(kCorrupt, "bad Huffman selector");
    if (!j.dc[found->td].present || !j.ac[found->ta].present)
      return fail(kCorrupt, "scan uses an undefined Huffman table");
    if (!j.qt_present[found->tq]) return fail(kCorrupt, "undefined quantization table");
    if (found->plane.empty()) found->plane.assign((size_t)found->stride * found->bh * 8, 0);
    found->pred = 0;
    sc[i] = found;
  }
  int ss = hdr[1 + 2 * ns], se = hdr[2 + 2 * ns], ahl = hdr[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahl != 0)
    return fail(kUnsupported, "a spectral-selection / successive-approximation scan "
                              "(progressive JPEG) is not supported");
  BitReader br(data, end);
  int restart = j.restart_interval, todo = restart;
  auto maybe_restart = [&]() {
    if (restart && --todo == 0) {
      br.restart();
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      todo = restart;
    }
  };
  if (ns == 1) {  // non-interleaved: the component's own blocks in raster order
    Component& c = *sc[0];
    int bx_n = (c.width + 7) / 8, by_n = (c.height + 7) / 8;
    for (int by = 0; by < by_n; by++)
      for (int bx = 0; bx < bx_n; bx++) {
        int rc = decode_block(br, j, c, c.plane.data() + (size_t)by * 8 * c.stride + bx * 8);
        if (rc) return rc;
        maybe_restart();
      }
  } else {
    for (int my = 0; my < j.mcuy; my++)
      for (int mx = 0; mx < j.mcux; mx++) {
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++) {
              int bx = mx * c.h + h, by = my * c.v + v;
              int rc = decode_block(br, j, c,
                                    c.plane.data() + (size_t)by * 8 * c.stride + bx * 8);
              if (rc) return rc;
            }
        }
        maybe_restart();
      }
  }
  *scan_end = br.data_end();
  return kOk;
}

void install_default_huffman(Jpeg& j) {
  j.dc[0].build(kDcLumaBits, kDcVals, 12);
  j.dc[1].build(kDcChromaBits, kDcVals, 12);
  j.ac[0].build(kAcLumaBits, kAcLumaVals, 162);
  j.ac[1].build(kAcChromaBits, kAcChromaVals, 162);
}

// Parse (and with decode, entropy-decode) one JPEG image in memory.
int jpeg_read(const uint8_t* data, size_t n, Jpeg& j, bool decode) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return fail(kCorrupt, "not a JPEG (no SOI)");
  install_default_huffman(j);
  const uint8_t* p = data + 2;
  const uint8_t* end = data + n;
  bool scanned = false;
  while (p < end) {
    if (*p != 0xFF) {  // garbage between segments: resync
      p++;
      continue;
    }
    while (p < end && *p == 0xFF) p++;
    if (p >= end) break;
    int m = *p++;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) break;  // EOI
    if (p + 2 > end) return fail(kCorrupt, "truncated JPEG marker");
    int len = (p[0] << 8) | p[1];
    if (len < 2 || p + len > end) return fail(kCorrupt, "truncated JPEG segment");
    const uint8_t* s = p + 2;
    int slen = len - 2;
    p += len;
    switch (m) {
      case 0xC0:
      case 0xC1: {
        int rc = parse_sof(j, s, slen, false);
        if (rc) return rc;
        if (!decode) return kOk;
        break;
      }
      case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
      case 0xCC:
        return parse_sof(j, s, slen, true);
      case 0xC4: {
        const uint8_t* q = s;
        while (q < s + slen) {
          if (q + 17 > s + slen) return fail(kCorrupt, "short DHT");
          int tc = q[0] >> 4, th = q[0] & 15;
          if (tc > 1 || th > 3) return fail(kCorrupt, "bad DHT class / id");
          int total = 0;
          for (int i = 0; i < 16; i++) total += q[1 + i];
          if (q + 17 + total > s + slen) return fail(kCorrupt, "short DHT");
          Huffman& h = tc ? j.ac[th] : j.dc[th];
          if (!h.build(q + 1, q + 17, total)) return fail(kCorrupt, "bad Huffman table");
          q += 17 + total;
        }
        break;
      }
      case 0xDB: {
        const uint8_t* q = s;
        while (q < s + slen) {
          int pq = q[0] >> 4, tq = q[0] & 15;
          if (tq > 3 || pq > 1) return fail(kCorrupt, "bad DQT");
          if (q + 1 + 64 * (pq + 1) > s + slen) return fail(kCorrupt, "short DQT");
          for (int k = 0; k < 64; k++)
            j.qt[tq][k] = pq ? (uint16_t)((q[1 + 2 * k] << 8) | q[2 + 2 * k]) : q[1 + k];
          j.qt_present[tq] = true;
          q += 1 + 64 * (pq + 1);
        }
        break;
      }
      case 0xDD:
        if (slen < 2) return fail(kCorrupt, "short DRI");
        j.restart_interval = (s[0] << 8) | s[1];
        break;
      case 0xDA: {
        if (!decode) return fail(kCorrupt, "SOS before SOF");
        const uint8_t* scan_end = end;
        int rc = decode_scan(j, s, slen, p, end, &scan_end);
        if (rc) return rc;
        scanned = true;
        p = scan_end;
        break;
      }
      default:
        break;  // APPn, COM and the rest: skipped
    }
  }
  if (!j.have_sof) return fail(kCorrupt, "JPEG without a frame header");
  if (decode) {
    if (!scanned) return fail(kCorrupt, "JPEG without image data");
    for (int i = 0; i < j.ncomp; i++)
      if (j.comp[i].plane.empty()) return fail(kCorrupt, "a JPEG component has no scan");
  }
  return kOk;
}

// ---------------------------------------------- colour conversion + resize

int compute_out_size(int w, int h, int short_side, int* ow, int* oh) {
  if (short_side <= 0) {
    *ow = w;
    *oh = h;
    return 0;
  }
  if (w <= h) {
    *ow = short_side;
    *oh = (int)((int64_t)h * short_side / w);
  } else {
    *oh = short_side;
    *ow = (int)((int64_t)w * short_side / h);
  }
  *ow &= ~1;
  *oh &= ~1;
  if (*ow == 0) *ow = 2;
  if (*oh == 0) *oh = 2;
  return 0;
}

// swscale's initFilter for SWS_BILINEAR (both positions 128: sample centres
// aligned) → per output sample the first source index and `size` integer
// coefficients summing to `one`.
struct Filter {
  int size = 1;        // coefficients per output sample (swscale's, aligned)
  int taps = 1;        // the leading ones that are ever non-zero
  std::vector<int> pos;
  std::vector<int> coef;
};

Filter make_filter(int src, int dst, int one, int align) {
  Filter f;
  const int64_t inc = (((int64_t)src << 16) + (dst >> 1)) / dst;
  if (std::llabs(inc - 0x10000) < 10) {  // unscaled
    f.size = 1;
    f.pos.resize(dst);
    f.coef.assign(dst, one);
    for (int i = 0; i < dst; i++) f.pos[i] = i;
    return f;
  }
  int fs = inc <= (1 << 16) ? 1 + 2 : 1 + (2 * src + dst - 1) / dst;
  fs = std::max(std::min(fs, src - 2), 1);
  int ratio = src / dst, lg = 0;
  while (ratio > 1) {
    ratio >>= 1;
    lg++;
  }
  const int64_t fone = 1LL << (54 - std::min(lg, 8));
  std::vector<int64_t> filt((size_t)dst * fs);
  std::vector<int> pos(dst);
  int64_t x_in_src = ((128 * inc) >> 7) - ((128 * 0x10000LL) >> 7);
  for (int i = 0; i < dst; i++) {
    int64_t xx = (x_in_src - (int64_t)(fs - 2) * (1LL << 16)) / (1 << 17);
    pos[i] = (int)xx;
    for (int j = 0; j < fs; j++) {
      int64_t d = std::llabs(xx * (1LL << 17) - x_in_src) << 13;
      if (inc > 1 << 16) d = d * dst / src;
      int64_t c = (1LL << 30) - d;
      if (c < 0) c = 0;
      filt[(size_t)i * fs + j] = c * (fone >> 30);
      xx++;
    }
    x_in_src += 2 * inc;
  }
  // reduce: drop near-zero leading taps, find the widest non-negligible span
  const double cut = 0.002 * (double)fone;
  int min_size = 0;
  for (int i = dst - 1; i >= 0; i--) {
    int64_t* row = &filt[(size_t)i * fs];
    int mn = fs;
    int64_t acc = 0;
    for (int j = 0; j < fs; j++) {
      acc += std::llabs(row[0]);
      if ((double)acc > cut) break;
      if (i < dst - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < fs; k++) row[k - 1] = row[k];
      row[fs - 1] = 0;
      pos[i]++;
    }
    acc = 0;
    for (int j = fs - 1; j > 0; j--) {
      acc += std::llabs(row[j]);
      if ((double)acc > cut) break;
      mn--;
    }
    min_size = std::max(min_size, mn);
  }
  if (min_size == 1 && align == 2) align = 1;
  int size = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> out((size_t)dst * size, 0);
  for (int i = 0; i < dst; i++)
    for (int j = 0; j < size && j < fs; j++) out[(size_t)i * size + j] = filt[(size_t)i * fs + j];
  // borders: fold taps outside [0, src) onto the edge samples
  for (int i = 0; i < dst; i++) {
    int64_t* row = &out[(size_t)i * size];
    if (pos[i] < 0) {
      for (int j = 1; j < size; j++) {
        int left = std::max(j + pos[i], 0);
        row[left] += row[j];
        row[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + size > src) {
      int shift = pos[i] + std::min(size - src, 0);
      int64_t acc = 0;
      for (int j = size - 1; j >= 0; j--)
        if (pos[i] + j >= src) {
          acc += row[j];
          row[j] = 0;
        }
      for (int j = size - 1; j >= 0; j--) row[j] = j < shift ? 0 : row[j - shift];
      pos[i] -= shift;
      row[src - 1 - pos[i]] += acc;
    }
  }
  // normalize to `one` with error diffusion
  f.size = size;
  f.pos = pos;
  f.coef.resize((size_t)dst * size);
  for (int i = 0; i < dst; i++) {
    int64_t sum = 0, err = 0;
    for (int j = 0; j < size; j++) sum += out[(size_t)i * size + j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < size; j++) {
      int64_t v = out[(size_t)i * size + j] + err;
      int64_t iv = v >= 0 ? (v + (sum >> 1)) / sum : (v - (sum >> 1)) / sum;
      f.coef[(size_t)i * size + j] = (int)iv;
      err = v - iv * sum;
      if (iv) f.taps = std::max(f.taps, j + 1);
    }
  }
  return f;
}

// a decoded frame's planes, as FFmpeg's yuvj4xxp / gray frame holds them
struct Planes {
  int w, h;                     // luma
  int cw, ch;                   // chroma plane size
  int sx, sy;                   // chroma subsampling shifts
  bool gray;
  const uint8_t *y, *u, *v;
  int ys, cs;
};

Planes planes_of(const Jpeg& j) {
  Planes p;
  p.w = j.width;
  p.h = j.height;
  p.gray = j.ncomp == 1;
  p.y = j.comp[0].plane.data();
  p.ys = j.comp[0].stride;
  if (p.gray) {
    p.cw = p.ch = 0;
    p.sx = p.sy = 0;
    p.u = p.v = nullptr;
    p.cs = 0;
  } else {
    p.sx = j.hmax / j.comp[1].h == 2 ? 1 : 0;
    p.sy = j.vmax / j.comp[1].v == 2 ? 1 : 0;
    p.cw = j.comp[1].width;
    p.ch = j.comp[1].height;
    p.u = j.comp[1].plane.data();
    p.v = j.comp[2].plane.data();
    p.cs = j.comp[1].stride;
  }
  return p;
}

template <int kTaps>
void hscale_n(const uint8_t* src, const Filter& f, int dst_w, int16_t* dst) {
  const int* pos = f.pos.data();
  const int* coef = f.coef.data();
  const int size = f.size;
  for (int i = 0; i < dst_w; i++) {
    const uint8_t* s = src + pos[i];
    const int* c = coef + (size_t)i * size;
    int val = 0;
    for (int j = 0; j < kTaps; j++) val += s[j] * c[j];
    dst[i] = (int16_t)std::min(val >> 7, (1 << 15) - 1);
  }
}

// swscale's hScale8To15: 14-bit taps, 15-bit output (trailing zero taps of
// the aligned filter skipped: they add nothing)
void hscale(const uint8_t* src, const Filter& f, int dst_w, int16_t* dst) {
  switch (f.taps) {
    case 1: return hscale_n<1>(src, f, dst_w, dst);
    case 2: return hscale_n<2>(src, f, dst_w, dst);
    case 3: return hscale_n<3>(src, f, dst_w, dst);
    case 4: return hscale_n<4>(src, f, dst_w, dst);
    case 5: return hscale_n<5>(src, f, dst_w, dst);
    case 6: return hscale_n<6>(src, f, dst_w, dst);
    default: break;
  }
  for (int i = 0; i < dst_w; i++) {
    const uint8_t* s = src + f.pos[i];
    const int* c = &f.coef[(size_t)i * f.size];
    int val = 0;
    for (int j = 0; j < f.taps; j++) val += s[j] * c[j];
    dst[i] = (int16_t)std::min(val >> 7, (1 << 15) - 1);
  }
}

// Planes → packed RGB24 (ow, oh), as swscale(SWS_BILINEAR) to RGB24 does.
void to_rgb(const Planes& p, int ow, int oh, uint8_t* out) {
  if (p.gray) {  // gray8 → rgb: the luma, resized as the luma plane below
    if (ow == p.w && oh == p.h) {
      for (int y = 0; y < oh; y++)
        for (int x = 0; x < ow; x++) {
          uint8_t v = p.y[(size_t)y * p.ys + x];
          uint8_t* d = out + ((size_t)y * ow + x) * 3;
          d[0] = d[1] = d[2] = v;
        }
      return;
    }
  }
  if (!p.gray && p.sx == 1 && ow == p.w && oh == p.h) {
    // the unscaled yuv420p / yuv422p → rgb24 converter: one chroma sample
    // per 2×2 (2×1) block
    std::vector<int> yi(ow), ui((ow + 1) >> 1), vi((ow + 1) >> 1);
    for (int y = 0; y < oh; y++) {
      const uint8_t* yr = p.y + (size_t)y * p.ys;
      const uint8_t* ur = p.u + (size_t)(y >> p.sy) * p.cs;
      const uint8_t* vr = p.v + (size_t)(y >> p.sy) * p.cs;
      for (int x = 0; x < ow; x++) yi[x] = yr[x];
      for (int x = 0; x < (ow + 1) >> 1; x++) {
        ui[x] = ur[x];
        vi[x] = vr[x];
      }
      rgb_row(kColorUnscaled, yi.data(), ui.data(), vi.data(), ow, false,
              out + (size_t)y * ow * 3);
    }
    return;
  }
  // the scaler: horizontal filter per plane to 15 bits, vertical filter and
  // RGB per output row; one chroma sample per output pair unless the chroma
  // is not subsampled (FFmpeg then forces full horizontal chroma)
  const bool full_chroma = !p.gray && p.sx == 0 && p.sy == 0;
  const int cow = full_chroma ? ow : (ow + 1) >> 1;
  Filter hl = make_filter(p.w, ow, 1 << 14, 4);
  Filter vl = make_filter(p.h, oh, 1 << 12, 2);
  std::vector<int16_t> lum((size_t)p.h * ow);
  for (int y = 0; y < p.h; y++) hscale(p.y + (size_t)y * p.ys, hl, ow, &lum[(size_t)y * ow]);
  Filter hc, vc;
  std::vector<int16_t> cu, cv;
  if (!p.gray) {
    hc = make_filter(p.cw, cow, 1 << 14, 4);
    vc = make_filter(p.ch, oh, 1 << 12, 2);
    cu.resize((size_t)p.ch * cow);
    cv.resize((size_t)p.ch * cow);
    for (int y = 0; y < p.ch; y++) {
      hscale(p.u + (size_t)y * p.cs, hc, cow, &cu[(size_t)y * cow]);
      hscale(p.v + (size_t)y * p.cs, hc, cow, &cv[(size_t)y * cow]);
    }
  }
  std::vector<int> yrow(ow), urow(cow, 128), vrow(cow, 128);
  for (int oy = 0; oy < oh; oy++) {
    const int* lc = &vl.coef[(size_t)oy * vl.size];
    const int16_t* l0 = &lum[(size_t)vl.pos[oy] * ow];
    const bool l1 = vl.size == 1;
    const bool l2 = vl.size == 2 && lc[0] + lc[1] == 4096;
    int csz = 0;
    const int* cc = nullptr;
    if (!p.gray) {
      csz = vc.size;
      cc = &vc.coef[(size_t)oy * vc.size];
    }
    const bool c1 = csz == 1, c2 = csz == 2 && cc[0] + cc[1] == 4096;
    if (l1 && (p.gray || c1 || c2)) {  // yuv2packed1
      for (int x = 0; x < ow; x++) yrow[x] = (l0[x] + 64) >> 7;
      if (!p.gray) {
        const int16_t* u0 = &cu[(size_t)vc.pos[oy] * cow];
        const int16_t* v0 = &cv[(size_t)vc.pos[oy] * cow];
        if (c1 || cc[1] < 2048) {
          for (int x = 0; x < cow; x++) {
            urow[x] = (u0[x] + 64) >> 7;
            vrow[x] = (v0[x] + 64) >> 7;
          }
        } else {
          const int16_t* u1 = u0 + cow;
          const int16_t* v1 = v0 + cow;
          for (int x = 0; x < cow; x++) {
            urow[x] = (u0[x] + u1[x] + 128) >> 8;
            vrow[x] = (v0[x] + v1[x] + 128) >> 8;
          }
        }
      }
    } else if (l2 && (p.gray || c2)) {  // yuv2packed2: bilinear, truncating
      const int a = lc[1], a1 = 4096 - a;
      const int16_t* l1r = l0 + ow;
      for (int x = 0; x < ow; x++) yrow[x] = (l0[x] * a1 + l1r[x] * a) >> 19;
      if (!p.gray) {
        const int ca = cc[1], ca1 = 4096 - ca;
        const int16_t* u0 = &cu[(size_t)vc.pos[oy] * cow];
        const int16_t* v0 = &cv[(size_t)vc.pos[oy] * cow];
        for (int x = 0; x < cow; x++) {
          urow[x] = (u0[x] * ca1 + u0[x + cow] * ca) >> 19;
          vrow[x] = (v0[x] * ca1 + v0[x + cow] * ca) >> 19;
        }
      }
    } else {  // yuv2packedX: rounded
      for (int x = 0; x < ow; x++) {
        int acc = 1 << 18;
        for (int j = 0; j < vl.taps; j++) acc += l0[(size_t)j * ow + x] * lc[j];
        yrow[x] = acc >> 19;
      }
      if (!p.gray) {
        const int16_t* u0 = &cu[(size_t)vc.pos[oy] * cow];
        const int16_t* v0 = &cv[(size_t)vc.pos[oy] * cow];
        for (int x = 0; x < cow; x++) {
          int au = 1 << 18, av = 1 << 18;
          for (int j = 0; j < vc.taps; j++) {
            au += u0[(size_t)j * cow + x] * cc[j];
            av += v0[(size_t)j * cow + x] * cc[j];
          }
          urow[x] = au >> 19;
          vrow[x] = av >> 19;
        }
      }
    }
    uint8_t* d = out + (size_t)oy * ow * 3;
    for (int x = 0; x < ow; x++) yrow[x] = clip8(yrow[x]);
    if (p.gray) {
      for (int x = 0; x < ow; x++) d[3 * x] = d[3 * x + 1] = d[3 * x + 2] = (uint8_t)yrow[x];
    } else {
      for (int x = 0; x < cow; x++) {
        urow[x] = clip8(urow[x]);
        vrow[x] = clip8(vrow[x]);
      }
      rgb_row(kColor, yrow.data(), urow.data(), vrow.data(), ow, full_chroma, d);
    }
  }
}

// ---------------------------------------------------------------- container

inline uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline bool fourcc(const uint8_t* p, const char* s) { return std::memcmp(p, s, 4) == 0; }

struct FrameRef {
  uint64_t offset;
  uint32_t size;
};

struct Media {
  std::string path;
  FILE* f = nullptr;
  uint64_t file_size = 0;
  std::vector<FrameRef> frames;
  std::unique_ptr<oatxt::H264Track> h264;  // an H.264 mp4: samples, not JPEG frames
  std::unique_ptr<oatxt::h264::Decoder> h264_decoder;  // made at the first decode
  double fps = 0.0;
  int width = 0, height = 0;

  int64_t frame_count() const {
    return h264 ? (int64_t)h264->samples.size() : (int64_t)frames.size();
  }
  oatxt::ReadAt reader() {
    return [this](uint64_t off, void* dst, size_t n) { return read_at(off, dst, n); };
  }

  ~Media() {
    if (f) std::fclose(f);
  }

  bool read_at(uint64_t off, void* dst, size_t n) {
    if (off + n > file_size) return false;
    if (fseeko(f, (off_t)off, SEEK_SET) != 0) return false;
    return std::fread(dst, 1, n, f) == n;
  }
};

struct AviScan {
  int video_stream = -1;
  int stream_count = 0;
  bool in_video_strl = false;
  uint32_t scale = 0, rate = 0, us_per_frame = 0;
  bool mjpeg = false;
  uint32_t compression = 0;
  uint64_t movi_start = 0, movi_end = 0;  // movi_start: offset of the 'movi' fourcc
  uint64_t idx1_pos = 0, idx1_size = 0;
};

bool is_video_chunk(const uint8_t* id, int stream) {
  if (id[0] < '0' || id[0] > '9' || id[1] < '0' || id[1] > '9') return false;
  if ((id[0] - '0') * 10 + (id[1] - '0') != stream) return false;
  return (id[2] == 'd' && (id[3] == 'c' || id[3] == 'b'));
}

int avi_walk_list(Media& m, AviScan& s, uint64_t pos, uint64_t end, int depth) {
  uint8_t hdr[12];
  while (pos + 8 <= end) {
    if (!m.read_at(pos, hdr, 8)) return fail(kCorrupt, "truncated AVI chunk header");
    uint32_t size = rd32(hdr + 4);
    uint64_t next = pos + 8 + size + (size & 1);
    if (fourcc(hdr, "LIST")) {
      if (!m.read_at(pos + 8, hdr + 8, 4)) return fail(kCorrupt, "truncated AVI LIST");
      const uint8_t* type = hdr + 8;
      if (fourcc(type, "movi")) {
        s.movi_start = pos + 8;
        s.movi_end = std::min<uint64_t>(pos + 8 + size, m.file_size);
      } else if ((fourcc(type, "hdrl") || fourcc(type, "strl")) && depth < 4) {
        if (fourcc(type, "strl")) s.in_video_strl = false;
        int rc = avi_walk_list(m, s, pos + 12, std::min<uint64_t>(pos + 8 + size, end), depth + 1);
        if (rc) return rc;
      }
    } else if (fourcc(hdr, "avih")) {
      uint8_t b[4];
      if (size >= 4 && m.read_at(pos + 8, b, 4)) s.us_per_frame = rd32(b);
    } else if (fourcc(hdr, "strh")) {
      uint8_t b[36];
      if (size < 36 || !m.read_at(pos + 8, b, 36)) return fail(kCorrupt, "short strh");
      int idx = s.stream_count++;
      s.in_video_strl = false;
      if (fourcc(b, "vids") && s.video_stream < 0) {
        s.video_stream = idx;
        s.in_video_strl = true;
        s.scale = rd32(b + 20);
        s.rate = rd32(b + 24);
      }
    } else if (fourcc(hdr, "strf")) {
      if (s.in_video_strl) {
        uint8_t b[20];
        if (size < 20 || !m.read_at(pos + 8, b, 20)) return fail(kCorrupt, "short strf");
        s.compression = rd32(b + 16);
        const uint8_t* c = b + 16;
        s.mjpeg = fourcc(c, "MJPG") || fourcc(c, "mjpg") || fourcc(c, "AVRn") ||
                  fourcc(c, "JPEG") || fourcc(c, "jpeg") || fourcc(c, "IJPG") ||
                  fourcc(c, "dmb1") || fourcc(c, "AVDJ");
      }
    } else if (fourcc(hdr, "idx1")) {
      s.idx1_pos = pos + 8;
      s.idx1_size = std::min<uint64_t>(size, m.file_size - (pos + 8));
    }
    if (next <= pos) break;
    pos = next;
  }
  return kOk;
}

int avi_walk_movi(Media& m, const AviScan& s, uint64_t pos, uint64_t end, int depth) {
  uint8_t hdr[12];
  while (pos + 8 <= end) {
    if (!m.read_at(pos, hdr, 8)) break;  // truncated file: keep what was found
    uint32_t size = rd32(hdr + 4);
    if (fourcc(hdr, "LIST") && depth < 2) {
      int rc = avi_walk_movi(m, s, pos + 12, std::min<uint64_t>(pos + 8 + size, end), depth + 1);
      if (rc) return rc;
    } else if (is_video_chunk(hdr, s.video_stream) && size > 0 &&
               pos + 8 + size <= m.file_size) {
      m.frames.push_back({pos + 8, size});
    }
    uint64_t next = pos + 8 + size + (size & 1);
    if (next <= pos) break;
    pos = next;
  }
  return kOk;
}

int avi_index(Media& m, const AviScan& s) {
  if (s.idx1_size >= 16) {
    std::vector<uint8_t> idx(s.idx1_size);
    if (m.read_at(s.idx1_pos, idx.data(), idx.size())) {
      // offsets are relative to the 'movi' fourcc (usual) or absolute: take
      // whichever lands on a chunk header carrying the entry's id
      int64_t base = -1;
      for (size_t e = 0; e + 16 <= idx.size() && base < 0; e += 16) {
        const uint8_t* ent = &idx[e];
        if (!is_video_chunk(ent, s.video_stream)) continue;
        uint64_t off = rd32(ent + 8);
        uint8_t h[4];
        for (uint64_t cand : {(uint64_t)s.movi_start, (uint64_t)0}) {
          if (m.read_at(cand + off, h, 4) && std::memcmp(h, ent, 4) == 0) {
            base = (int64_t)cand;
            break;
          }
        }
        if (base < 0) break;
      }
      if (base >= 0) {
        for (size_t e = 0; e + 16 <= idx.size(); e += 16) {
          const uint8_t* ent = &idx[e];
          uint32_t size = rd32(ent + 12);
          if (!is_video_chunk(ent, s.video_stream) || size == 0) continue;
          uint64_t off = (uint64_t)base + rd32(ent + 8) + 8;
          if (off + size > m.file_size) continue;
          m.frames.push_back({off, size});
        }
        return kOk;
      }
    }
  }
  m.frames.clear();
  return avi_walk_movi(m, s, s.movi_start + 4, s.movi_end, 0);
}

int read_frame_bytes(Media& m, int64_t i, std::vector<uint8_t>& buf) {
  const FrameRef& r = m.frames[(size_t)i];
  buf.resize(r.size);
  if (!m.read_at(r.offset, buf.data(), r.size))
    return fail(kCorrupt, "truncated frame " + std::to_string(i) + ": " + m.path);
  return kOk;
}

int open_media(const char* path, Media& m) {
  m.path = path;
  m.f = std::fopen(path, "rb");
  if (!m.f) return fail(kOpenFailed, std::string("cannot open ") + path);
  if (fseeko(m.f, 0, SEEK_END) != 0) return fail(kOpenFailed, std::string("cannot seek ") + path);
  m.file_size = (uint64_t)ftello(m.f);
  uint8_t head[12] = {0};
  if (m.file_size < 4 || !m.read_at(0, head, std::min<uint64_t>(12, m.file_size)))
    return fail(kCorrupt, std::string("empty or truncated file: ") + path);
  if (head[0] == 0xFF && head[1] == 0xD8) {  // a bare JPEG still
    m.frames.push_back({0, (uint32_t)m.file_size});
    m.fps = 25.0;
  } else if (fourcc(head, "RIFF") && fourcc(head + 8, "AVI ")) {
    AviScan s;
    uint64_t riff_end = std::min<uint64_t>(8 + (uint64_t)rd32(head + 4), m.file_size);
    int rc = avi_walk_list(m, s, 12, riff_end, 0);
    if (rc) return rc;
    if (s.video_stream < 0) return fail(kCorrupt, std::string("AVI without a video stream: ") + path);
    if (!s.mjpeg) {
      char cc[5] = {0};
      std::memcpy(cc, &s.compression, 4);
      return fail(kUnsupported, std::string("AVI video codec '") + cc +
                                    "' is not MJPEG; this decoder reads JPEG-coded media "
                                    "only (remux to MJPEG): " + path);
    }
    if (!s.movi_start) return fail(kCorrupt, std::string("AVI without a movi list: ") + path);
    rc = avi_index(m, s);
    if (rc) return rc;
    if (s.scale > 0 && s.rate > 0) {
      m.fps = (double)s.rate / (double)s.scale;
    } else if (s.us_per_frame > 0) {
      m.fps = 1e6 / (double)s.us_per_frame;
    }
  } else if (fourcc(head + 4, "ftyp") || fourcc(head + 4, "moov") || fourcc(head + 4, "mdat") ||
             fourcc(head + 4, "free") || fourcc(head + 4, "wide") || fourcc(head + 4, "skip")) {
    m.h264.reset(new oatxt::H264Track());
    std::string err;
    int rc = oatxt::read_mp4(m.reader(), m.file_size, *m.h264, err);
    if (rc) return fail(rc, err + ": " + path);
    m.width = m.h264->width;
    m.height = m.h264->height;
    m.fps = m.h264->fps;
    return kOk;
  } else {
    return fail(kUnsupported, std::string("not an MJPEG AVI or a JPEG still: ") + path);
  }
  if (m.frames.empty()) return fail(kCorrupt, std::string("no video frames: ") + path);
  // the first frame's header gives the size (and rejects unsupported JPEG)
  std::vector<uint8_t> buf;
  int rc = read_frame_bytes(m, 0, buf);
  if (rc) return rc;
  Jpeg j;
  rc = jpeg_read(buf.data(), buf.size(), j, false);
  if (rc) {
    g_error += ": " + m.path;
    return rc;
  }
  m.width = j.width;
  m.height = j.height;
  return kOk;
}

int decode_core(Media& m, const int64_t* indices, int n, int short_side, uint8_t* out,
                int out_w, int out_h) {
  if (n <= 0) return 0;
  if (m.h264)
    return fail(kBadBuffer, "H.264 decodes through oatxt_h264_decode: " + m.path);
  int ow, oh;
  compute_out_size(m.width, m.height, short_side, &ow, &oh);
  if (ow != out_w || oh != out_h) return fail(kBadBuffer, "output buffer has the wrong size");
  const int64_t last = (int64_t)m.frames.size() - 1;
  std::vector<int64_t> want(n);
  for (int i = 0; i < n; i++) want[i] = std::min(std::max<int64_t>(indices[i], 0), last);
  std::vector<int64_t> uniq(want);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  const size_t frame_bytes = (size_t)ow * oh * 3;
  std::vector<uint8_t> buf, rgb(frame_bytes);
  for (int64_t idx : uniq) {
    int rc = read_frame_bytes(m, idx, buf);
    if (rc) return rc;
    Jpeg j;
    rc = jpeg_read(buf.data(), buf.size(), j, true);
    if (rc) {
      g_error += " (frame " + std::to_string(idx) + " of " + m.path + ")";
      return rc;
    }
    if (j.width != m.width || j.height != m.height)
      return fail(kCorrupt, "frame " + std::to_string(idx) + " changes size: " + m.path);
    to_rgb(planes_of(j), ow, oh, rgb.data());
    for (int i = 0; i < n; i++)
      if (want[i] == idx) std::memcpy(out + (size_t)i * frame_bytes, rgb.data(), frame_bytes);
  }
  return n;
}

// ------------------------------------------------------------ JPEG encoder

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
  HuffEnc(const uint8_t bits[16], const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    int c = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < bits[len - 1]; i++, k++) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int len) {
    while (len > 0) {
      int take = std::min(len, 8);
      len -= take;
      acc = (acc << take) | ((v >> len) & ((1u << take) - 1));
      n += take;
      while (n >= 8) {
        uint8_t b = (uint8_t)(acc >> (n - 8));
        out.push_back(b);
        if (b == 0xFF) out.push_back(0x00);
        n -= 8;
      }
      acc &= (1u << n) - 1;
    }
  }
  void flush() {
    if (n > 0) put((1u << (8 - n)) - 1, 8 - n);  // pad with 1 bits
  }
};

void scaled_quant(const uint8_t base[64], int quality, uint8_t out_zz[64]) {
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int k = 0; k < 64; k++) {
    int v = (base[kZigzag[k]] * scale + 50) / 100;
    out_zz[k] = (uint8_t)std::min(std::max(v, 1), 255);
  }
}

void encode_block(BitWriter& bw, const uint8_t* src, int stride, const uint8_t qzz[64],
                  const HuffEnc& dc, const HuffEnc& ac, int& pred) {
  float f[64], tmp[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) f[y * 8 + x] = (float)src[y * stride + x] - 128.0f;
  for (int y = 0; y < 8; y++)  // rows: over x → u
    for (int u = 0; u < 8; u++) {
      float s = 0.0f;
      for (int x = 0; x < 8; x++) s += kDct.m[x][u] * f[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  int q[64];
  for (int u = 0; u < 8; u++)
    for (int v = 0; v < 8; v++) {
      float s = 0.0f;
      for (int y = 0; y < 8; y++) s += kDct.m[y][v] * tmp[y * 8 + u];
      f[v * 8 + u] = s;
    }
  for (int k = 0; k < 64; k++) q[k] = (int)std::lrint(f[kZigzag[k]] / (float)qzz[k]);
  auto nbits = [](int v) {
    v = v < 0 ? -v : v;
    int b = 0;
    while (v) {
      b++;
      v >>= 1;
    }
    return b;
  };
  int diff = q[0] - pred;
  pred = q[0];
  int nb = nbits(diff);
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << nb) - 1), nb);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    if (q[k] == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int v = q[k];
    nb = nbits(v);
    int sym = (run << 4) | nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
    run = 0;
  }
  if (run) bw.put(ac.code[0x00], ac.size[0x00]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

// Baseline 4:2:0 JPEG of full-range planes: y (w×h), u / v ((w+1)/2 × (h+1)/2).
std::vector<uint8_t> encode_jpeg420(int w, int h, const std::vector<uint8_t>& yp,
                                    const std::vector<uint8_t>& up,
                                    const std::vector<uint8_t>& vp, int quality) {
  static const HuffEnc dcl(kDcLumaBits, kDcVals), dcc(kDcChromaBits, kDcVals);
  static const HuffEnc acl(kAcLumaBits, kAcLumaVals), acc(kAcChromaBits, kAcChromaVals);
  uint8_t ql[64], qc[64];
  scaled_quant(kQuantLuma, quality, ql);
  scaled_quant(kQuantChroma, quality, qc);
  std::vector<uint8_t> o;
  o.reserve((size_t)w * h / 2 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t jfif[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), jfif, jfif + sizeof jfif);
  for (int t = 0; t < 2; t++) {  // DQT
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back((uint8_t)t);
    const uint8_t* q = t ? qc : ql;
    o.insert(o.end(), q, q + 64);
  }
  o.push_back(0xFF);  // SOF0
  o.push_back(0xC0);
  put16(o, 17);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  struct {
    int cls_id;
    const uint8_t* bits;
    const uint8_t* vals;
    int nv;
  } dht[4] = {{0x00, kDcLumaBits, kDcVals, 12}, {0x10, kAcLumaBits, kAcLumaVals, 162},
              {0x01, kDcChromaBits, kDcVals, 12}, {0x11, kAcChromaBits, kAcChromaVals, 162}};
  for (auto& t : dht) {
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 2 + 1 + 16 + t.nv);
    o.push_back((uint8_t)t.cls_id);
    o.insert(o.end(), t.bits, t.bits + 16);
    o.insert(o.end(), t.vals, t.vals + t.nv);
  }
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof sos);
  // MCU-padded planes by edge replication
  const int mw = (w + 15) / 16, mh = (h + 15) / 16;
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  auto padded = [](const std::vector<uint8_t>& src, int sw, int sh, int pw, int ph) {
    std::vector<uint8_t> d((size_t)pw * ph);
    for (int y = 0; y < ph; y++)
      for (int x = 0; x < pw; x++)
        d[(size_t)y * pw + x] = src[(size_t)std::min(y, sh - 1) * sw + std::min(x, sw - 1)];
    return d;
  };
  std::vector<uint8_t> Y = padded(yp, w, h, mw * 16, mh * 16);
  std::vector<uint8_t> U = padded(up, cw, ch, mw * 8, mh * 8);
  std::vector<uint8_t> V = padded(vp, cw, ch, mw * 8, mh * 8);
  BitWriter bw(o);
  int py = 0, pu = 0, pv = 0;
  for (int my = 0; my < mh; my++)
    for (int mx = 0; mx < mw; mx++) {
      for (int b = 0; b < 4; b++) {
        int bx = mx * 16 + (b & 1) * 8, by = my * 16 + (b >> 1) * 8;
        encode_block(bw, &Y[(size_t)by * mw * 16 + bx], mw * 16, ql, dcl, acl, py);
      }
      encode_block(bw, &U[(size_t)my * 8 * mw * 8 + mx * 8], mw * 8, qc, dcc, acc, pu);
      encode_block(bw, &V[(size_t)my * 8 * mw * 8 + mx * 8], mw * 8, qc, dcc, acc, pv);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// oatx_write_test_video_ex's YUV planes of frame i (oatx_decode.cpp:589-717)
void test_planes(int width, int height, int i, unsigned seed, std::vector<uint8_t>& yp,
                 std::vector<uint8_t>& up, std::vector<uint8_t>& vp) {
  unsigned s = seed * 2654435761u;
  const int phase = (int)(s & 0xFFu);
  const int fx = 1 + (int)((s >> 8) & 3u);
  const int fy = 1 + (int)((s >> 10) & 3u);
  int cu, cv;
  if (seed != 0) {
    const double ang = (double)seed * 2.39996322972865332;
    cu = 128 + (int)std::lround(90.0 * std::cos(ang));
    cv = 128 + (int)std::lround(90.0 * std::sin(ang));
  } else {
    cu = 128 + (int)((s >> 12) & 0x3Fu) - 32;
    cv = 128 + (int)((s >> 18) & 0x3Fu) - 32;
  }
  const int band_luma = (int)(20u + ((s >> 24) * 131u) % 216u);
  yp.assign((size_t)width * height, 0);
  for (int y = 0; y < height; y++)
    for (int x = 0; x < width; x++)
      yp[(size_t)y * width + x] = (seed != 0 && y >= height / 3 && y < 2 * height / 3)
                                      ? (uint8_t)band_luma
                                      : (uint8_t)((x * fx + y * fy + i * 16 + phase) & 0xFF);
  for (int y = 0; y < 8 && y < height; y++)
    for (int x = 0; x < 8 && x < width; x++)
      yp[(size_t)y * width + x] = (uint8_t)std::min(255, 16 + i * 8);
  const int cw = (width + 1) / 2, ch = (height + 1) / 2;
  up.assign((size_t)cw * ch, 0);
  vp.assign((size_t)cw * ch, 0);
  for (int y = 0; y < ch; y++)
    for (int x = 0; x < cw; x++) {
      const bool stamp = seed != 0 && y < 4 && x < 4;
      up[(size_t)y * cw + x] = (uint8_t)(stamp ? 128 : cu);
      vp[(size_t)y * cw + x] = (uint8_t)(stamp ? 128 : cv);
    }
}

void put_le32(std::vector<uint8_t>& o, uint32_t v) {
  for (int k = 0; k < 4; k++) o.push_back((uint8_t)(v >> (8 * k)));
}
void put_le16(std::vector<uint8_t>& o, uint16_t v) {
  o.push_back((uint8_t)v);
  o.push_back((uint8_t)(v >> 8));
}
void put_cc(std::vector<uint8_t>& o, const char* s) { o.insert(o.end(), s, s + 4); }
void set_le32(std::vector<uint8_t>& o, size_t at, uint32_t v) {
  for (int k = 0; k < 4; k++) o[at + k] = (uint8_t)(v >> (8 * k));
}

int write_file(const char* path, const std::vector<uint8_t>& data) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return fail(kOpenFailed, std::string("cannot write ") + path);
  bool ok = std::fwrite(data.data(), 1, data.size(), f) == data.size();
  ok = std::fclose(f) == 0 && ok;
  return ok ? kOk : fail(kOpenFailed, std::string("short write: ") + path);
}

// One MJPEG video stream in an AVI: hdrl (avih, strl: strh + strf), movi, idx1.
std::vector<uint8_t> mux_avi(int w, int h, int fps, const std::vector<std::vector<uint8_t>>& jpegs) {
  uint32_t max_size = 0;
  for (auto& j : jpegs) max_size = std::max<uint32_t>(max_size, (uint32_t)j.size());
  const uint32_t n = (uint32_t)jpegs.size();
  std::vector<uint8_t> o;
  put_cc(o, "RIFF");
  put_le32(o, 0);  // patched
  put_cc(o, "AVI ");
  put_cc(o, "LIST");
  put_le32(o, 4 + (8 + 56) + (12 + (8 + 56) + (8 + 40)));
  put_cc(o, "hdrl");
  put_cc(o, "avih");
  put_le32(o, 56);
  put_le32(o, (uint32_t)(1000000 / std::max(fps, 1)));  // dwMicroSecPerFrame
  put_le32(o, max_size * (uint32_t)fps);               // dwMaxBytesPerSec
  put_le32(o, 0);                                      // dwPaddingGranularity
  put_le32(o, 0x10 | 0x100);                           // AVIF_HASINDEX | AVIF_ISINTERLEAVED
  put_le32(o, n);                                      // dwTotalFrames
  put_le32(o, 0);                                      // dwInitialFrames
  put_le32(o, 1);                                      // dwStreams
  put_le32(o, max_size + 8);                           // dwSuggestedBufferSize
  put_le32(o, (uint32_t)w);
  put_le32(o, (uint32_t)h);
  for (int k = 0; k < 4; k++) put_le32(o, 0);
  put_cc(o, "LIST");
  put_le32(o, 4 + (8 + 56) + (8 + 40));
  put_cc(o, "strl");
  put_cc(o, "strh");
  put_le32(o, 56);
  put_cc(o, "vids");
  put_cc(o, "MJPG");
  put_le32(o, 0);  // dwFlags
  put_le16(o, 0);  // wPriority
  put_le16(o, 0);  // wLanguage
  put_le32(o, 0);  // dwInitialFrames
  put_le32(o, 1);  // dwScale
  put_le32(o, (uint32_t)fps);  // dwRate
  put_le32(o, 0);  // dwStart
  put_le32(o, n);  // dwLength
  put_le32(o, max_size + 8);
  put_le32(o, 0xFFFFFFFFu);  // dwQuality
  put_le32(o, 0);            // dwSampleSize
  put_le16(o, 0);
  put_le16(o, 0);
  put_le16(o, (uint16_t)w);
  put_le16(o, (uint16_t)h);
  put_cc(o, "strf");
  put_le32(o, 40);
  put_le32(o, 40);
  put_le32(o, (uint32_t)w);
  put_le32(o, (uint32_t)h);
  put_le16(o, 1);
  put_le16(o, 24);
  put_cc(o, "MJPG");
  put_le32(o, (uint32_t)(w * h * 3));
  for (int k = 0; k < 4; k++) put_le32(o, 0);
  put_cc(o, "LIST");
  size_t movi_size_at = o.size();
  put_le32(o, 0);  // patched
  size_t movi_fourcc = o.size();
  put_cc(o, "movi");
  std::vector<uint32_t> offsets;
  for (auto& j : jpegs) {
    offsets.push_back((uint32_t)(o.size() - movi_fourcc));
    put_cc(o, "00dc");
    put_le32(o, (uint32_t)j.size());
    o.insert(o.end(), j.begin(), j.end());
    if (j.size() & 1) o.push_back(0);
  }
  set_le32(o, movi_size_at, (uint32_t)(o.size() - movi_fourcc));
  put_cc(o, "idx1");
  put_le32(o, 16 * n);
  for (uint32_t i = 0; i < n; i++) {
    put_cc(o, "00dc");
    put_le32(o, 0x10);  // AVIIF_KEYFRAME
    put_le32(o, offsets[i]);
    put_le32(o, (uint32_t)jpegs[i].size());
  }
  set_le32(o, 4, (uint32_t)(o.size() - 8));
  return o;
}

// Every entry returns a code: nothing thrown crosses the C ABI.
template <typename F>
int guarded(F&& f) {
  try {
    return f();
  } catch (const std::bad_alloc&) {
    return fail(kCorrupt, "out of memory");
  } catch (...) {
    return fail(kCorrupt, "internal error");
  }
}

}  // namespace

extern "C" {

const char* oatxt_last_error() { return g_error.c_str(); }

const char* oatxt_version() {
  return "oatx_torch decode 1.3 (first-party: baseline/extended JPEG, MJPEG in AVI; "
         "H.264 in mp4 / mov: CAVLC and CABAC, I, P and B slices decoded here)";
}

// ------------------------------------------------------------- handle API

void* oatxt_open(const char* path, int* rc) {
  Media* m = nullptr;
  *rc = guarded([&] {
    m = new Media();
    return open_media(path, *m);
  });
  if (*rc != kOk) {
    delete m;
    return nullptr;
  }
  return m;
}

void oatxt_close(void* h) { delete (Media*)h; }

int oatxt_handle_info(void* h, int64_t* nframes, double* fps, int* width, int* height) {
  Media* m = (Media*)h;
  *nframes = m->frame_count();
  *fps = m->fps;
  *width = m->width;
  *height = m->height;
  return kOk;
}

int oatxt_handle_out_size(void* h, int short_side, int* out_w, int* out_h) {
  Media* m = (Media*)h;
  return compute_out_size(m->width, m->height, short_side, out_w, out_h);
}

// Decode frames `indices` (any order, duplicates allowed; past the end →
// the last frame) into out (n × out_h × out_w × 3, RGB24). Returns n or <0.
int oatxt_handle_decode(void* h, const int64_t* indices, int n, int short_side, uint8_t* out,
                        int out_w, int out_h) {
  return guarded(
      [&] { return decode_core(*(Media*)h, indices, n, short_side, out, out_w, out_h); });
}

// Path-based probe: → 0 and (nframes, fps, width, height), or <0.
int oatxt_probe(const char* path, int64_t* nframes, double* fps, int* width, int* height) {
  return guarded([&] {
    Media m;
    int rc = open_media(path, m);
    return rc ? rc : oatxt_handle_info(&m, nframes, fps, width, height);
  });
}

// ------------------------------------------------------------ H.264 in mp4

// 0: JPEG-coded media (oatxt_handle_decode), 1: H.264 in mp4 / mov
// (oatxt_h264_decode)
int oatxt_handle_kind(void* h) { return ((Media*)h)->h264 ? 1 : 0; }

// The coded size (whole macroblocks), the SPS's video_full_range_flag and
// profile_idc of an H.264 handle.
int oatxt_h264_info(void* h, int* coded_w, int* coded_h, int* full_range, int* profile) {
  Media* m = (Media*)h;
  if (!m->h264) return fail(kUnsupported, "not an H.264 mp4: " + m->path);
  *coded_w = m->h264->coded_width;
  *coded_h = m->h264->coded_height;
  *full_range = m->h264->full_range;
  *profile = m->h264->profile_idc;
  return kOk;
}

// The Annex B plan (mp4.h) for display indices `indices` (any order,
// duplicates allowed; past the end → the last frame, as oatx's reader):
// a plan object read with oatxt_plan_* and freed with oatxt_plan_free.
void* oatxt_h264_plan(void* h, const int64_t* indices, int n, int* rc) {
  Media* m = (Media*)h;
  oatxt::H264Plan* p = nullptr;
  *rc = guarded([&] {
    if (!m->h264) return fail(kUnsupported, "not an H.264 mp4: " + m->path);
    if (n <= 0) return fail(kBadBuffer, "no frame indices");
    const int64_t last = m->frame_count() - 1;
    std::vector<int64_t> want(indices, indices + n);
    for (auto& i : want) i = std::min(std::max<int64_t>(i, 0), last);
    std::sort(want.begin(), want.end());
    want.erase(std::unique(want.begin(), want.end()), want.end());
    p = new oatxt::H264Plan();
    std::string err;
    int r = oatxt::plan_h264(m->reader(), *m->h264, want, *p, err);
    return r ? fail(r, err + ": " + m->path) : (int)kOk;
  });
  if (*rc != kOk) {
    delete p;
    return nullptr;
  }
  return p;
}

// Decode display indices `indices` (any order, duplicates allowed; past the
// end → the last frame) of an H.264 handle with the first-party decoder
// (h264.h): the picture of each distinct index, in ascending order, as NV12
// cropped to the container's size (height · 3 / 2 rows of width bytes)
// into out (out_size bytes). Returns the number of pictures, or <0:
// kUnsupported for a tool the decoder refuses, -4 for CABAC / B slices.
int oatxt_h264_decode(void* h, const int64_t* indices, int n, uint8_t* out, int64_t out_size) {
  Media* m = (Media*)h;
  return guarded([&] {
    if (!m->h264) return fail(kUnsupported, "not an H.264 mp4: " + m->path);
    if (n <= 0) return fail(kBadBuffer, "no frame indices");
    const int64_t last = m->frame_count() - 1;
    std::vector<int64_t> want(indices, indices + n);
    for (auto& i : want) i = std::min(std::max<int64_t>(i, 0), last);
    std::sort(want.begin(), want.end());
    want.erase(std::unique(want.begin(), want.end()), want.end());
    const int64_t frame = (int64_t)m->width * m->height * 3 / 2;
    if (out_size != frame * (int64_t)want.size())
      return fail(kBadBuffer, "NV12 buffer of " + std::to_string(out_size) + " bytes for " +
                                  std::to_string(want.size()) + " frames of " +
                                  std::to_string(m->width) + "x" + std::to_string(m->height));
    oatxt::H264Plan p;
    std::string err;
    int r = oatxt::plan_h264(m->reader(), *m->h264, want, p, err);
    if (r) return fail(r, err + ": " + m->path);
    if (!m->h264_decoder) m->h264_decoder.reset(new oatxt::h264::Decoder());
    r = oatxt::h264::decode_plan(*m->h264_decoder, p, m->width, m->height, out, err);
    return r ? fail(r, err + ": " + m->path) : (int)want.size();
  });
}

// Decode an Annex B plan given as mp4.h's arrays (a hand-made stream) with
// a fresh decoder: as oatxt_h264_decode, `wanted` sorted and unique; its
// tool counters (kStatCount of them) into `stats` when it is not null.
int oatxt_h264_decode_stream(const uint8_t* bytes, int64_t n_bytes, const int64_t* pkt_end,
                             const int64_t* pkt_ts, int n_pkt, const int32_t* seg_end,
                             int n_seg, const int64_t* wanted, int n_wanted, int width,
                             int height, uint8_t* out, int64_t* stats) {
  return guarded([&] {
    oatxt::H264Plan p;
    p.bytes.assign(bytes, bytes + n_bytes);
    p.pkt_end.assign(pkt_end, pkt_end + n_pkt);
    p.pkt_ts.assign(pkt_ts, pkt_ts + n_pkt);
    p.seg_end.assign(seg_end, seg_end + n_seg);
    p.wanted.assign(wanted, wanted + n_wanted);
    for (int i = 0; i < n_pkt; i++)
      if (pkt_end[i] < (i ? pkt_end[i - 1] : 0) || pkt_end[i] > n_bytes)
        return fail(kBadBuffer, "packet ends out of order");
    for (int s = 0; s < n_seg; s++)
      if (seg_end[s] < (s ? seg_end[s - 1] : 0) || seg_end[s] > n_pkt)
        return fail(kBadBuffer, "segment ends out of order");
    oatxt::h264::Decoder d;
    std::string err;
    const int r = oatxt::h264::decode_plan(d, p, width, height, out, err);
    if (stats) std::copy(d.stats, d.stats + oatxt::h264::kStatCount, stats);
    return r ? fail(r, err) : n_wanted;
  });
}

// ue(v) / se(v) / a CAVLC residual block read from `data` (h264.h
// read_syntax): the tests' spot checks of the code tables.
int oatxt_h264_read_syntax(int kind, const uint8_t* data, int64_t n_bytes, int arg, int n,
                           int32_t* out) {
  return guarded([&] {
    std::string err;
    const int r = oatxt::h264::read_syntax(kind, data, (size_t)n_bytes, arg, n, out, err);
    return r < 0 ? fail(r, err) : r;
  });
}

// The decoder's tool counters (h264.h kStatNames; names comma-separated by
// oatxt_h264_stat_names) since the handle opened: copies min(n, count) and
// returns the count.
int oatxt_h264_stats(void* h, int64_t* out, int n) {
  Media* m = (Media*)h;
  const int count = oatxt::h264::kStatCount;
  for (int i = 0; i < std::min(n, count); i++)
    out[i] = m->h264_decoder ? m->h264_decoder->stats[i] : 0;
  return count;
}

const char* oatxt_h264_stat_names() {
  static const std::string names = [] {
    std::string s;
    for (int i = 0; i < oatxt::h264::kStatCount; i++)
      s += (i ? "," : "") + std::string(oatxt::h264::kStatNames[i]);
    return s;
  }();
  return names.c_str();
}

void oatxt_plan_sizes(void* plan, int64_t* n_bytes, int* n_packets, int* n_segments,
                      int* n_wanted) {
  auto* p = (oatxt::H264Plan*)plan;
  *n_bytes = (int64_t)p->bytes.size();
  *n_packets = (int)p->pkt_end.size();
  *n_segments = (int)p->seg_end.size();
  *n_wanted = (int)p->wanted.size();
}
const uint8_t* oatxt_plan_bytes(void* plan) { return ((oatxt::H264Plan*)plan)->bytes.data(); }
const int64_t* oatxt_plan_pkt_end(void* plan) { return ((oatxt::H264Plan*)plan)->pkt_end.data(); }
const int64_t* oatxt_plan_pkt_ts(void* plan) { return ((oatxt::H264Plan*)plan)->pkt_ts.data(); }
const int32_t* oatxt_plan_seg_end(void* plan) { return ((oatxt::H264Plan*)plan)->seg_end.data(); }
const int64_t* oatxt_plan_wanted(void* plan) { return ((oatxt::H264Plan*)plan)->wanted.data(); }
void oatxt_plan_free(void* plan) { delete (oatxt::H264Plan*)plan; }

// swscale's SWS_BILINEAR filter from `src` to `dst` samples (make_filter:
// coefficients summing to `one`, the size rounded up to `align`): pos (dst)
// and coef (dst × size) when size <= cap; returns size, or <0.
int oatxt_bilinear_filter(int src, int dst, int one, int align, int* pos, int* coef, int cap) {
  if (src <= 0 || dst <= 0) return fail(kBadBuffer, "bad filter geometry");
  return guarded([&] {
    Filter f = make_filter(src, dst, one, align);
    if (f.size > cap) return fail(kBadBuffer, "filter wider than the buffer");
    std::copy(f.pos.begin(), f.pos.end(), pos);
    std::copy(f.coef.begin(), f.coef.end(), coef);
    return f.size;
  });
}

// ------------------------------------------------------- JPEG in memory

int oatxt_jpeg_bytes_info(const uint8_t* data, int64_t n, int* width, int* height) {
  return guarded([&] {
    Jpeg j;
    int rc = jpeg_read(data, (size_t)n, j, false);
    if (rc) return rc;
    *width = j.width;
    *height = j.height;
    return (int)kOk;
  });
}

// One JPEG in memory → RGB24 at its native size (out_w × out_h).
int oatxt_decode_jpeg_bytes(const uint8_t* data, int64_t n, uint8_t* out, int out_w,
                            int out_h) {
  return guarded([&] {
    Jpeg j;
    int rc = jpeg_read(data, (size_t)n, j, true);
    if (rc) return rc;
    if (j.width != out_w || j.height != out_h)
      return fail(kBadBuffer, "output buffer has the wrong size");
    to_rgb(planes_of(j), out_w, out_h, out);
    return (int)kOk;
  });
}

// ------------------------------------------------------------ test writer

// oatx_write_test_video_ex's clip (same planes; seeds as there), coded as
// MJPEG in an AVI. Other codecs return kUnsupported.
int oatxt_write_test_video_ex(const char* path, int width, int height, int n, int fps,
                              unsigned seed, const char* codec, int gop) {
  (void)gop;
  if (codec && std::strcmp(codec, "mjpeg") != 0)
    return fail(kUnsupported, std::string("codec '") + codec +
                                  "': the writer codes MJPEG only (inter-coded video needs "
                                  "an encoder the port does not have)");
  if (width <= 0 || height <= 0 || n <= 0 || fps <= 0 || width > 65535 || height > 65535)
    return fail(kCorrupt, "bad test video geometry");
  return guarded([&] {
    std::vector<std::vector<uint8_t>> jpegs(n);
    std::vector<uint8_t> yp, up, vp;
    for (int i = 0; i < n; i++) {
      test_planes(width, height, i, seed, yp, up, vp);
      jpegs[i] = encode_jpeg420(width, height, yp, up, vp, kWriterQuality);
    }
    return write_file(path, mux_avi(width, height, fps, jpegs));
  });
}

// Frame `frame_index` of the same pattern as a bare JPEG still.
int oatxt_write_test_image(const char* path, int width, int height, unsigned seed,
                           int frame_index) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
    return fail(kCorrupt, "bad test image geometry");
  return guarded([&] {
    std::vector<uint8_t> yp, up, vp;
    test_planes(width, height, frame_index, seed, yp, up, vp);
    return write_file(path, encode_jpeg420(width, height, yp, up, vp, kWriterQuality));
  });
}

}  // extern "C"
