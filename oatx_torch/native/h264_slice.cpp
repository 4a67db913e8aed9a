// h264_slice.cpp — the H.264 decoder's syntax half (h264.h): NAL units and
// the RBSP bit reader, SPS / PPS, slice headers, picture order counts,
// reference lists and marking, CAVLC residual blocks and the macroblock
// layer of I and P slices, and the picture loop over an mp4.h plan.
// Clause numbers are ITU-T H.264's.

#include <algorithm>
#include <array>
#include <cstring>
#include <memory>
#include <string>
#include <utility>

#include "h264.h"

namespace oatxt {
namespace h264 {

void raise(int code, const std::string& msg) { throw Error{code, msg}; }

const char* const kStatNames[kStatCount] = {
#define OATXT_STAT_NAME(name) #name,
    OATXT_H264_STATS(OATXT_STAT_NAME)
#undef OATXT_STAT_NAME
};

const uint8_t kZigzag4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kZigzag8[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kBlkX[16] = {0, 4, 0, 4, 8, 12, 8, 12, 0, 4, 0, 4, 8, 12, 8, 12};
const uint8_t kBlkY[16] = {0, 0, 4, 4, 0, 0, 4, 4, 8, 8, 12, 12, 8, 8, 12, 12};

int chroma_qp(int qp, int offset) {  // Table 8-15
  static const uint8_t kQpc[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                                   36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
  const int q = std::min(std::max(qp + offset, 0), 51);
  return q < 30 ? q : kQpc[q - 30];
}

Decoder::Decoder() {
  std::memset(stats, 0, sizeof(stats));
}

void Decoder::reset() {
  dpb.clear();
  max_long_term_idx = -1;
  prev_poc_msb = prev_poc_lsb = prev_frame_num = prev_frame_num_offset = 0;
  prev_mmco5 = false;
  have_prev = false;
}

namespace {

// ------------------------------------------------------------- bit reader

struct Bits {
  std::vector<uint8_t> buf;  // the RBSP, with 8 zero bytes of padding
  size_t pos = 0, end = 0;   // end: the rbsp_stop_one_bit's position

  void load(const uint8_t* p, size_t n) {  // emulation prevention removed (7.4.1)
    buf.clear();
    buf.reserve(n + 8);
    int zeros = 0;
    for (size_t i = 0; i < n; i++) {
      if (zeros >= 2 && p[i] == 3) {
        zeros = 0;
        continue;
      }
      zeros = p[i] ? 0 : zeros + 1;
      buf.push_back(p[i]);
    }
    size_t last = buf.size();
    while (last > 0 && buf[last - 1] == 0) last--;  // cabac_zero_words, trailing zeros
    end = 0;
    if (last > 0) {
      int tz = 0;
      while (!((buf[last - 1] >> tz) & 1)) tz++;
      end = last * 8 - (size_t)tz - 1;
    }
    buf.resize(buf.size() + 8, 0);
    pos = 0;
  }
  uint32_t peek32() const {
    const size_t byte = pos >> 3;
    if (byte + 8 > buf.size()) return 0;
    uint64_t v = 0;
    for (int k = 0; k < 8; k++) v = v << 8 | buf[byte + (size_t)k];
    return (uint32_t)((v << (pos & 7)) >> 32);
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek32() >> (32 - n);
    pos += (size_t)n;
    return v;
  }
  bool flag() { return u(1) != 0; }
  void skip(int n) { pos += (size_t)n; }
  // codeNum, up to 2^32 - 2: compared as unsigned, never cast to int
  uint32_t ue() {  // 9.1
    const uint32_t v = peek32();
    if (!v) raise(kCorrupt, "exp-Golomb code longer than 32 bits");
    const int lz = __builtin_clz(v);
    pos += (size_t)lz + 1;
    return ((1u << lz) - 1) + u(lz);
  }
  // an unsigned syntax element whose range (7.4) ends at `max`
  int ue(uint32_t max, const char* what) {
    const uint32_t v = ue();
    if (v > max) raise(kCorrupt, std::string(what) + " out of range");
    return (int)v;
  }
  int se() {
    const uint32_t k = ue();
    return (k & 1) ? (int)((k + 1) / 2) : -(int)(k / 2);
  }
  int te(int range) { return range > 1 ? ue((uint32_t)range, "ref_idx") : !flag(); }
  bool more_rbsp_data() const { return pos < end; }
  void check() const {
    if (pos > end) raise(kCorrupt, "slice data past the end of its NAL unit");
  }
};

// ------------------------------------------------------------ VLC tables

// A prefix code: (length, code) per value, matched shortest first.
struct Vlc {
  struct Entry {
    uint8_t len;
    uint16_t code;
    uint16_t value;
  };
  std::vector<Entry> e;
  Vlc(const uint8_t* len, const uint8_t* code, int n) {
    for (int v = 0; v < n; v++)
      if (len[v]) e.push_back({len[v], code[v], (uint16_t)v});
    std::stable_sort(e.begin(), e.end(),
                     [](const Entry& a, const Entry& b) { return a.len < b.len; });
  }
  int read(Bits& b) const {
    const uint32_t v = b.peek32();
    for (const Entry& x : e)
      if ((v >> (32 - x.len)) == x.code) {
        b.skip(x.len);
        return x.value;
      }
    raise(kCorrupt, "invalid CAVLC code");
  }
};

// coeff_token (Table 9-5): value 4 · TotalCoeff + TrailingOnes
const uint8_t kCoeffTokenLen[4][68] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6,
     11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10,
     14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14,
     16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4,
     8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7,
     12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12,
     13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4,
     7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5,
     8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8,
     10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7}};  // nC == -1
const uint8_t kCoeffTokenCode[4][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3,
     7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4,
     15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8,
     15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4,
     4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4,
     15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12,
     11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11,
     11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13,
     11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8,
     13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2},
    {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0}};

// total_zeros (Tables 9-7, 9-8) by TotalCoeff 1..15; chroma DC 2×2 (9-9a)
const uint8_t kTotalZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},       {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},             {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},                   {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},                         {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},                               {4, 4, 2, 1, 3},
    {3, 3, 1, 2},                                     {2, 2, 1},
    {1, 1}};
const uint8_t kTotalZerosCode[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},       {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},             {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},                   {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},                         {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},                               {0, 1, 1, 1, 1},
    {0, 1, 1, 1},                                     {0, 1, 1},
    {0, 1}};
const uint8_t kTotalZerosDcLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2}, {1, 1}};
const uint8_t kTotalZerosDcCode[3][4] = {{1, 1, 1, 0}, {1, 1, 0}, {1, 0}};

// run_before (Table 9-10) by zerosLeft 1..6, > 6
const uint8_t kRunLen[7][16] = {{1, 1},          {1, 2, 2},          {2, 2, 2, 2},
                                {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
                                {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const uint8_t kRunCode[7][16] = {{1, 0},          {1, 1, 0},          {3, 2, 1, 0},
                                 {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
                                 {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

struct Tables {
  std::vector<Vlc> coeff_token, total_zeros, total_zeros_dc, run;
  Tables() {
    for (int t = 0; t < 4; t++)
      coeff_token.emplace_back(kCoeffTokenLen[t], kCoeffTokenCode[t], t == 3 ? 20 : 68);
    for (int t = 0; t < 15; t++)
      total_zeros.emplace_back(kTotalZerosLen[t], kTotalZerosCode[t], 16);
    for (int t = 0; t < 3; t++)
      total_zeros_dc.emplace_back(kTotalZerosDcLen[t], kTotalZerosDcCode[t], 4);
    for (int t = 0; t < 7; t++) run.emplace_back(kRunLen[t], kRunCode[t], 16);
  }
};

const Tables& tables() {
  static const Tables t;  // constant once built
  return t;
}

// coded_block_pattern's me(v) mapping (Table 9-4, ChromaArrayType 1)
const uint8_t kCbpIntra[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                               16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                               8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kCbpInter[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                               14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                               17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// ------------------------------------------------------------ scaling lists

const uint8_t kDefault4[2][16] = {
    {6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42},
    {10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34}};
const uint8_t kDefault8[2][64] = {
    {6,  10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23, 23, 23, 23, 25,
     25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31,
     31, 31, 31, 31, 31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42},
    {9,  13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21, 21, 21, 21, 22,
     22, 22, 22, 22, 22, 22, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27,
     27, 27, 27, 27, 27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35}};

// 7.3.2.1.1.1: → 0 list read, 1 not present (fall back), 2 use the default
int scaling_list(Bits& b, uint8_t* list, int size, int64_t* stats) {
  if (!b.flag()) return 1;
  int last = 8, next = 8;
  for (int j = 0; j < size; j++) {
    if (next != 0) {
      const int delta = b.se();
      if (delta < -128 || delta > 127) raise(kCorrupt, "delta_scale out of range");
      next = (last + delta + 256) % 256;
      if (j == 0 && next == 0) {
        stats[kStat_scaling_use_default]++;
        return 2;
      }
    }
    list[j] = (uint8_t)(next == 0 ? last : next);
    last = list[j];
  }
  stats[kStat_scaling_explicit]++;
  return 0;
}

// The scaling lists of an SPS or a PPS with fall-back rule A (no SPS
// matrix, or the SPS itself) or B (the SPS's lists), Table 7-2.
void scaling_matrices(Bits& b, int n8, uint8_t s4[6][16], uint8_t s8[2][64], const Sps* rule_b,
                      int64_t* stats) {
  for (int i = 0; i < 6; i++) {
    const int r = scaling_list(b, s4[i], 16, stats);
    const int inter = i >= 3;
    if (r == 2) {
      std::memcpy(s4[i], kDefault4[inter], 16);
    } else if (r == 1) {
      if (i == 0 || i == 3) {
        if (rule_b) {
          std::memcpy(s4[i], rule_b->scaling4[i], 16);
          stats[kStat_scaling_fallback_b]++;
        } else {
          std::memcpy(s4[i], kDefault4[inter], 16);
          stats[kStat_scaling_fallback_a]++;
        }
      } else {
        std::memcpy(s4[i], s4[i - 1], 16);
        stats[rule_b ? kStat_scaling_fallback_b : kStat_scaling_fallback_a]++;
      }
    }
  }
  for (int i = 0; i < 2; i++) {
    if (i >= n8) {  // absent with transform_8x8_mode_flag 0: rule of a missing list
      std::memcpy(s8[i], rule_b ? rule_b->scaling8[i] : kDefault8[i], 64);
      continue;
    }
    const int r = scaling_list(b, s8[i], 64, stats);
    if (r == 2) {
      std::memcpy(s8[i], kDefault8[i], 64);
    } else if (r == 1) {
      std::memcpy(s8[i], rule_b ? rule_b->scaling8[i] : kDefault8[i], 64);
      stats[rule_b ? kStat_scaling_fallback_b : kStat_scaling_fallback_a]++;
    }
  }
}

void flat_matrices(uint8_t s4[6][16], uint8_t s8[2][64]) {
  std::memset(s4, 16, 6 * 16);
  std::memset(s8, 16, 2 * 64);
}

// ----------------------------------------------------------- parameter sets

void parse_sps(Decoder& d, Bits& b) {  // 7.3.2.1.1
  Sps s;
  s.profile_idc = (int)b.u(8);
  b.skip(16);  // constraint flags, reserved, level_idc
  const uint32_t id = b.ue();
  if (id > 31) raise(kCorrupt, "seq_parameter_set_id out of range");
  flat_matrices(s.scaling4, s.scaling8);
  if (s.profile_idc == 100 || s.profile_idc == 110 || s.profile_idc == 122 ||
      s.profile_idc == 244 || s.profile_idc == 44 || s.profile_idc == 83 ||
      s.profile_idc == 86 || s.profile_idc == 118 || s.profile_idc == 128 ||
      s.profile_idc == 138 || s.profile_idc == 139 || s.profile_idc == 134 ||
      s.profile_idc == 135) {
    s.chroma_format_idc = b.ue(3, "chroma_format_idc");
    if (s.chroma_format_idc == 3) b.skip(1);  // separate_colour_plane_flag
    const uint32_t bd_luma = b.ue(), bd_chroma = b.ue();
    if (bd_luma || bd_chroma)
      raise(kUnsupported, "H.264 bit depth above 8 (only 8-bit 4:2:0 is read)");
    if (b.flag())
      raise(kUnsupported, "H.264 lossless coding (qpprime_y_zero_transform_bypass_flag)");
    s.scaling_matrix_present = b.flag();
    if (s.scaling_matrix_present) {
      d.stats[kStat_sps_scaling_matrix]++;
      scaling_matrices(b, s.chroma_format_idc == 3 ? 6 : 2, s.scaling4, s.scaling8, nullptr,
                       d.stats);
    }
  }
  if (s.chroma_format_idc != 1)
    raise(kUnsupported, "H.264 chroma format " + std::to_string(s.chroma_format_idc) +
                            " (only 4:2:0 is read)");
  s.log2_max_frame_num = b.ue(12, "log2_max_frame_num_minus4") + 4;  // 7.4.2.1.1
  s.poc_type = b.ue(2, "pic_order_cnt_type");
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = b.ue(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.flag();
    s.offset_for_non_ref_pic = b.se();
    s.offset_for_top_to_bottom_field = b.se();
    const uint32_t n = b.ue();
    if (n > 255) raise(kCorrupt, "num_ref_frames_in_pic_order_cnt_cycle out of range");
    for (uint32_t i = 0; i < n; i++) s.offset_for_ref_frame.push_back(b.se());
  }
  s.max_num_ref_frames = b.ue(16, "max_num_ref_frames");
  b.skip(1);  // gaps_in_frame_num_value_allowed_flag: a gap is refused where it occurs
  s.mb_width = b.ue(1023, "SPS picture size") + 1;
  s.mb_height = b.ue(1023, "SPS picture size") + 1;
  if (!b.flag()) raise(kUnsupported, "interlaced H.264 (frame_mbs_only_flag 0)");
  s.direct_8x8_inference = b.flag();
  if (b.flag()) {  // frame_cropping_flag: CropUnitX = CropUnitY = 2 for 4:2:0 frames
    s.crop_left = 2 * b.ue(8 * 1024, "SPS picture size");
    s.crop_right = 2 * b.ue(8 * 1024, "SPS picture size");
    s.crop_top = 2 * b.ue(8 * 1024, "SPS picture size");
    s.crop_bottom = 2 * b.ue(8 * 1024, "SPS picture size");
  }
  // vui_parameters_present_flag and the VUI follow; nothing after them is
  // read, and the VUI's colour description is ignored as oatx ignores it
  if (s.crop_left + s.crop_right >= 16 * s.mb_width ||
      s.crop_top + s.crop_bottom >= 16 * s.mb_height)
    raise(kCorrupt, "SPS picture size out of range");
  s.valid = true;
  d.sps[id] = s;
}

void parse_pps(Decoder& d, Bits& b) {  // 7.3.2.2
  Pps p;
  const uint32_t id = b.ue();
  if (id > 255) raise(kCorrupt, "pic_parameter_set_id out of range");
  const uint32_t sps_id = b.ue();
  if (sps_id > 31 || !d.sps[sps_id].valid) raise(kCorrupt, "PPS names a missing SPS");
  p.sps_id = (int)sps_id;
  const Sps& s = d.sps[p.sps_id];
  p.cabac = b.flag();
  p.bottom_field_pic_order_present = b.flag();
  if (b.ue() > 0)
    raise(kUnsupported, "H.264 flexible macroblock ordering (num_slice_groups_minus1 > 0)");
  p.num_ref_idx_default[0] = b.ue(31, "num_ref_idx_l0_default_active_minus1") + 1;
  p.num_ref_idx_default[1] = b.ue(31, "num_ref_idx_l1_default_active_minus1") + 1;
  p.weighted_pred = b.flag();
  p.weighted_bipred_idc = (int)b.u(2);
  if (p.weighted_bipred_idc == 3) raise(kCorrupt, "weighted_bipred_idc out of range");
  p.pic_init_qp = 26 + b.se();
  b.se();  // pic_init_qs (SP / SI only)
  p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
  p.deblocking_filter_control_present = b.flag();
  p.constrained_intra_pred = b.flag();
  if (b.flag()) raise(kUnsupported, "H.264 redundant pictures (redundant_pic_cnt_present_flag)");
  std::memcpy(p.scaling4, s.scaling4, sizeof(p.scaling4));
  std::memcpy(p.scaling8, s.scaling8, sizeof(p.scaling8));
  if (b.more_rbsp_data()) {
    p.transform_8x8_mode = b.flag();
    p.scaling_matrix_present = b.flag();
    if (p.scaling_matrix_present) {
      d.stats[kStat_pps_scaling_matrix]++;
      scaling_matrices(b, p.transform_8x8_mode ? 2 : 0, p.scaling4, p.scaling8,
                       s.scaling_matrix_present ? &s : nullptr, d.stats);
    }
    p.chroma_qp_offset[1] = b.se();
  }
  if (p.pic_init_qp < 0 ||
      p.pic_init_qp > 51 || std::abs(p.chroma_qp_offset[0]) > 12 ||
      std::abs(p.chroma_qp_offset[1]) > 12)
    raise(kCorrupt, "PPS value out of range");
  p.valid = true;
  d.pps[id] = p;
}

// LevelScale (8.5.9) times 2^(qP / 6), by zigzag position: residual
// coefficients are then (c · t + 8) >> 4 (4×4) and (c · t + 32) >> 6 (8×8).
struct Dequant {
  int32_t dq4[6][52][16];
  int32_t dq8[2][52][64];
};

void make_dequant(const Pps& p, Dequant& q) {
  static const int kNorm4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                                   {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
  static const int kNorm8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                                   {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                                   {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
  for (int qp = 0; qp < 52; qp++) {
    const int m = qp % 6, sh = qp / 6;
    for (int k = 0; k < 16; k++) {
      const int r = kZigzag4[k], i = r >> 2, j = r & 3;
      const int v = (i % 2 == 0 && j % 2 == 0) ? kNorm4[m][0]
                    : (i % 2 == 1 && j % 2 == 1) ? kNorm4[m][1] : kNorm4[m][2];
      for (int l = 0; l < 6; l++) q.dq4[l][qp][k] = (p.scaling4[l][k] * v) << sh;
    }
    for (int k = 0; k < 64; k++) {
      const int r = kZigzag8[k], i = r >> 3, j = r & 7;
      int v;
      if (i % 4 == 0 && j % 4 == 0) v = kNorm8[m][0];
      else if (i % 2 == 1 && j % 2 == 1) v = kNorm8[m][1];
      else if (i % 4 == 2 && j % 4 == 2) v = kNorm8[m][2];
      else if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) v = kNorm8[m][3];
      else if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) v = kNorm8[m][4];
      else v = kNorm8[m][5];
      for (int l = 0; l < 2; l++) q.dq8[l][qp][k] = (p.scaling8[l][k] * v) << sh;
    }
  }
}

// ------------------------------------------------------------ slice header

void pred_weight_table(Bits& b, SliceHeader& h, int64_t* stats) {  // 7.3.3.2
  PredWeight& w = h.pw;
  w.luma_log2 = b.ue(7, "weight denominator");
  w.chroma_log2 = b.ue(7, "weight denominator");
  auto weight = [&]() {  // luma_weight / offset and their chroma kin: -128..127 (7.4.3.2)
    const int v = b.se();
    if (v < -128 || v > 127) raise(kCorrupt, "prediction weight or offset out of range");
    return v;
  };
  for (int list = 0; list < (h.type == 1 ? 2 : 1); list++)
    for (int i = 0; i < h.num_ref_idx_active[list]; i++) {
      w.luma_w[list][i] = 1 << w.luma_log2;
      w.luma_o[list][i] = 0;
      if (b.flag()) {
        w.luma_w[list][i] = weight();
        w.luma_o[list][i] = weight();
        stats[kStat_weighted_luma_refs]++;
      }
      for (int c = 0; c < 2; c++) {
        w.chroma_w[list][i][c] = 1 << w.chroma_log2;
        w.chroma_o[list][i][c] = 0;
      }
      if (b.flag()) {
        stats[kStat_weighted_chroma_refs]++;
        for (int c = 0; c < 2; c++) {
          w.chroma_w[list][i][c] = weight();
          w.chroma_o[list][i][c] = weight();
        }
      }
    }
}

struct ListMod {
  int idc, value;
};

void slice_header(Decoder& d, Bits& b, int nal_type, int nal_ref_idc, SliceHeader& h,
                  std::vector<ListMod> mods[2]) {  // 7.3.3
  h.first_mb = b.ue(1 << 20, "first_mb_in_slice");  // slice_data checks it against the SPS
  const uint32_t type = b.ue();
  if (type > 9) raise(kCorrupt, "slice_type out of range");
  const int t = (int)(type % 5);
  if (t == 3 || t == 4) raise(kUnsupported, "H.264 SP / SI slices");
  h.type = t;
  const uint32_t pps_id = b.ue();
  if (pps_id > 255 || !d.pps[pps_id].valid) raise(kCorrupt, "slice names a missing PPS");
  h.pps_id = (int)pps_id;
  const Pps& p = d.pps[h.pps_id];
  const Sps& s = d.sps[p.sps_id];
  h.idr = nal_type == 5;
  h.nal_ref_idc = nal_ref_idc;
  if (h.idr && t != 2) raise(kCorrupt, "IDR picture with a P or B slice");
  h.frame_num = (int)b.u(s.log2_max_frame_num);
  if (h.idr) b.ue();  // idr_pic_id
  if (s.poc_type == 0) {
    h.poc_lsb = (int)b.u(s.log2_max_poc_lsb);
    if (p.bottom_field_pic_order_present) h.delta_poc_bottom = b.se();
  }
  if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
    h.delta_poc[0] = b.se();
    if (p.bottom_field_pic_order_present) h.delta_poc[1] = b.se();
  }
  if (t == 1) h.direct_spatial = b.flag();
  h.num_ref_idx_active[0] = p.num_ref_idx_default[0];
  h.num_ref_idx_active[1] = t == 1 ? p.num_ref_idx_default[1] : 0;
  mods[0].clear();
  mods[1].clear();
  if (t != 2) {
    if (b.flag()) {  // num_ref_idx_active_override_flag
      h.num_ref_idx_active[0] = b.ue(15, "num_ref_idx_l0_active_minus1") + 1;
      if (t == 1) h.num_ref_idx_active[1] = b.ue(15, "num_ref_idx_l1_active_minus1") + 1;
    }
    if (h.num_ref_idx_active[0] > 16) raise(kCorrupt, "num_ref_idx_l0_active out of range");
    if (h.num_ref_idx_active[1] > 16) raise(kCorrupt, "num_ref_idx_l1_active out of range");
    for (int list = 0; list < (t == 1 ? 2 : 1); list++) {
      if (!b.flag()) continue;  // ref_pic_list_modification_flag_lX (7.3.3.1)
      for (;;) {
        const uint32_t idc = b.ue();
        if (idc == 3) break;
        if (idc > 2 || mods[list].size() > 64)
          raise(kCorrupt, "bad modification_of_pic_nums_idc");
        mods[list].push_back(
            {(int)idc, b.ue(65535, "abs_diff_pic_num_minus1 / long_term_pic_num")});
      }
    }
    if ((p.weighted_pred && t == 0) || (p.weighted_bipred_idc == 1 && t == 1)) {
      d.stats[t == 0 ? kStat_weighted_slices : kStat_weighted_bipred_explicit]++;
      pred_weight_table(b, h, d.stats);
    }
  }
  h.mmco.clear();
  h.long_term_reference_flag = h.adaptive_marking = false;
  if (nal_ref_idc) {  // dec_ref_pic_marking (7.3.3.3)
    if (h.idr) {
      b.flag();  // no_output_of_prior_pics_flag
      h.long_term_reference_flag = b.flag();
    } else {
      h.adaptive_marking = b.flag();
      if (h.adaptive_marking) {
        for (;;) {
          const uint32_t op = b.ue();
          if (op == 0) break;
          if (op > 6 || h.mmco.size() > 3 * 66) raise(kCorrupt, "bad MMCO");
          int a = 0, c = 0;
          if (op == 1 || op == 3) a = b.ue(65535, "difference_of_pic_nums_minus1");
          if (op == 2) a = b.ue(65535, "long_term_pic_num");
          if (op == 3 || op == 6) c = b.ue(15, "long_term_frame_idx");
          if (op == 4) a = b.ue(16, "max_long_term_frame_idx_plus1");
          h.mmco.insert(h.mmco.end(), {(int)op, a, c});
        }
      }
    }
  }
  if (p.cabac && t != 2) {
    h.cabac_init_idc = b.ue(2, "cabac_init_idc");
    if (h.cabac_init_idc == 1 && p.transform_8x8_mode)
      raise(kUnsupported, "H.264 cabac_init_idc 1 with the 8x8 transform (its context "
                          "initialisation for ctxIdx 399-435 is not verified)");
  }
  h.qp = p.pic_init_qp + b.se();
  if (h.qp < 0 || h.qp > 51) raise(kCorrupt, "slice QP out of range");
  h.disable_deblocking = 0;
  h.filter_offset_a = h.filter_offset_b = 0;
  if (p.deblocking_filter_control_present) {
    h.disable_deblocking = b.ue(2, "disable_deblocking_filter_idc");
    if (h.disable_deblocking != 1) {
      h.filter_offset_a = 2 * b.se();
      h.filter_offset_b = 2 * b.se();
      if (std::abs(h.filter_offset_a) > 12 || std::abs(h.filter_offset_b) > 12)
        raise(kCorrupt, "deblocking filter offset out of range");
    }
  }
}

// --------------------------------------------------- CAVLC residual blocks

// residual_block_cavlc (7.3.5.3.2, 9.2): coefficient levels by index
// 0..max-1 into `level`; returns TotalCoeff.
int residual_block(Bits& b, int nc, int max, int32_t* level, int64_t* stats) {
  const Tables& tb = tables();
  int table;
  if (nc == -1) {
    table = 3;
    stats[kStat_nc_chroma_dc]++;
  } else if (nc < 2) {
    table = 0;
    stats[kStat_nc_0_2]++;
  } else if (nc < 4) {
    table = 1;
    stats[kStat_nc_2_4]++;
  } else if (nc < 8) {
    table = 2;
    stats[kStat_nc_4_8]++;
  } else {
    table = 4;
    stats[kStat_nc_8_up]++;
  }
  int total, t1;
  if (table == 4) {  // 6-bit fixed length
    const int v = (int)b.u(6);
    if (v == 3) {
      total = t1 = 0;
    } else {
      total = (v >> 2) + 1;
      t1 = v & 3;
      if (t1 > total) raise(kCorrupt, "invalid coeff_token");
    }
  } else {
    const int v = tb.coeff_token[(size_t)table].read(b);
    total = v >> 2;
    t1 = v & 3;
  }
  for (int i = 0; i < max; i++) level[i] = 0;
  if (total == 0) return 0;
  if (total > max) raise(kCorrupt, "TotalCoeff above the block's size");
  int lv[16];
  int suffix_len = (total > 10 && t1 < 3) ? 1 : 0;
  for (int i = 0; i < total; i++) {
    if (i < t1) {
      lv[i] = b.flag() ? -1 : 1;
      continue;
    }
    int prefix = 0;  // level_prefix (9.2.2.1)
    while (!b.flag()) {
      if (++prefix > 31) raise(kCorrupt, "level_prefix too long");
    }
    if (prefix >= 14)
      stats[prefix == 14 ? kStat_level_prefix_14
                         : prefix == 15 ? kStat_level_prefix_15 : kStat_level_prefix_16]++;
    int code = std::min(15, prefix) << suffix_len;
    if (suffix_len > 0 || prefix >= 14) {
      const int size = (prefix == 14 && suffix_len == 0) ? 4
                       : prefix >= 15 ? prefix - 3 : suffix_len;
      if (size > 0) code += (int)b.u(size);
    }
    if (prefix >= 15 && suffix_len == 0) code += 15;
    if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
    if (i == t1 && t1 < 3) code += 2;
    lv[i] = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
    if (suffix_len == 0) suffix_len = 1;
    if (std::abs(lv[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
  }
  int zeros = 0;
  if (total < max) {
    zeros = (max == 4) ? tb.total_zeros_dc[(size_t)total - 1].read(b)
                       : tb.total_zeros[(size_t)total - 1].read(b);
    if (total + zeros > max) raise(kCorrupt, "total_zeros past the block's end");
  }
  int pos = total + zeros - 1;  // coefficient index of the highest-frequency level
  for (int i = 0; i < total; i++) {
    level[pos] = lv[i];
    if (i == total - 1) break;
    int run = 0;
    if (zeros > 0) {
      run = tb.run[(size_t)std::min(zeros, 7) - 1].read(b);
      if (run > zeros) raise(kCorrupt, "run_before above zerosLeft");
      zeros -= run;
    }
    pos -= run + 1;
  }
  return total;
}

// ----------------------------------------------------- macroblock decoding

struct MbCoeffs {  // one macroblock's dequantized coefficients, raster order
  int32_t luma[16][16];      // per 4×4 (raster)
  int32_t luma8[4][64];      // per 8×8 under the 8×8 transform
  int32_t chroma[2][4][16];  // per chroma 4×4 (raster in the 8×8)
  uint16_t luma_coded = 0;   // 4×4 blocks (raster) with any coefficient
  uint8_t chroma_coded[2] = {0, 0};
};

struct Neighbour {
  const MbInfo* mb = nullptr;
  int x = 0, y = 0;  // the location inside mb (luma samples)
};

// B macroblock types 1-21 (Table 7-14): the prediction of each partition
// (1 Pred_L0, 2 Pred_L1, 3 BiPred)
const uint8_t kBPred[22][2] = {{0, 0}, {1, 0}, {2, 0}, {3, 0}, {1, 1}, {1, 1}, {2, 2}, {2, 2},
                               {1, 2}, {1, 2}, {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},
                               {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3}};
// B sub_mb_type 1-12 (Table 7-18): prediction, and the shape as P's
// sub_mb_type numbers it (0 8×8, 1 8×4, 2 4×8, 3 4×4); 0 is B_Direct_8x8
const uint8_t kBSubPred[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
const uint8_t kBSubShape[13] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 3, 3};
const int kSubParts[4] = {1, 2, 2, 4}, kSubW[4] = {8, 8, 4, 4}, kSubH[4] = {8, 4, 8, 4};

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int min_positive(int a, int b) { return a >= 0 && b >= 0 ? std::min(a, b) : std::max(a, b); }

// DistScaleFactor (8.4.1.2.3) of the current picture at POC cur between
// pic0 and pic1, whose POCs differ
int dist_scale_factor(int cur, const Picture& p0, const Picture& p1) {
  const int tb = clip3(-128, 127, cur - p0.poc), td = clip3(-128, 127, p1.poc - p0.poc);
  const int tx = (16384 + std::abs(td / 2)) / td;
  return clip3(-1024, 1023, (tb * tx + 32) >> 6);
}

struct MbDecoder {
  SliceCtx& s;
  Decoder& d;
  Bits& b;
  Cabac* cab;  // nullptr: CAVLC
  int mbx = 0, mby = 0, addr = 0;
  MbInfo* cur = nullptr;
  MbCoeffs c;
  uint16_t mv_done = 0;  // 4×4 blocks of the current macroblock already predicted
  bool eight_ok = true;  // noSubMbPartSizeLessThan8x8Flag
  bool prev_qp_delta = false;  // the previous macroblock's mb_qp_delta was not 0 (CABAC)
  // spatial direct (8.4.1.2.2): the macroblock's references and predictors
  bool spatial_done = false, spatial_zero = false;
  int spatial_ref[2] = {0, 0};
  int spatial_mv[2][2] = {{0, 0}, {0, 0}};

  MbDecoder(SliceCtx& s_, Bits& b_, Cabac* c_) : s(s_), d(*s_.d), b(b_), cab(c_) {}

  const MbInfo* mb_at(int x, int y) const {  // an available macroblock of this slice
    if (x < 0 || y < 0 || x >= s.sps->mb_width || y >= s.sps->mb_height) return nullptr;
    const MbInfo& m = d.mbs[(size_t)(y * s.sps->mb_width + x)];
    return m.slice == s.slice_num ? &m : nullptr;
  }
  const MbInfo* mb_a() const { return mb_at(mbx - 1, mby); }
  const MbInfo* mb_b() const { return mb_at(mbx, mby - 1); }

  // 6.4.12: the macroblock and location covering luma (xN, yN) of the current
  // macroblock; mb == cur for the current one, nullptr when unavailable
  Neighbour locate(int xn, int yn) const {
    Neighbour n;
    if (yn > 15 || (xn > 15 && yn >= 0)) return n;
    const int dx = xn < 0 ? -1 : xn > 15 ? 1 : 0, dy = yn < 0 ? -1 : 0;
    n.mb = (dx == 0 && dy == 0) ? cur : mb_at(mbx + dx, mby + dy);
    n.x = (xn + 16) & 15;
    n.y = (yn + 16) & 15;
    return n;
  }

  // the state a macroblock starts from before its syntax is read
  void reset_mb() {
    cur->t8x8 = false;
    cur->nz_filter = 0;
    cur->cbf_dc = cur->cbp = cur->direct = 0;
    cur->chroma_mode = 0;
    std::memset(cur->intra4, -1, sizeof(cur->intra4));
    std::memset(cur->nc, 0, sizeof(cur->nc));
    std::memset(cur->ref, -1, sizeof(cur->ref));
    std::memset(cur->ref_pic, -1, sizeof(cur->ref_pic));
    std::memset(cur->mv, 0, sizeof(cur->mv));
    std::memset(cur->mvd, 0, sizeof(cur->mvd));
    mv_done = 0;
    eight_ok = true;
    spatial_done = false;
  }

  // ------------------------------------------------------------- nC (9.2.1)
  int luma_nc(int bx, int by) {  // bx, by: the block's luma position
    const Neighbour a = locate(bx - 1, by), bb = locate(bx, by - 1);
    const bool ha = a.mb != nullptr, hb = bb.mb != nullptr;
    const int na = ha ? a.mb->nc[(a.x >> 2) + 4 * (a.y >> 2)] : 0;
    const int nb = hb ? bb.mb->nc[(bb.x >> 2) + 4 * (bb.y >> 2)] : 0;
    return ha && hb ? (na + nb + 1) >> 1 : na + nb;
  }
  // the count of chroma 4×4 `blk` (raster in the 8×8) of `comp` at chroma
  // (x, y) relative to the block's macroblock, and whether it exists
  const MbInfo* chroma_mb(int x, int y) const {
    if (y >= 8 || (x >= 8 && y >= 0)) return nullptr;
    const int dx = x < 0 ? -1 : 0, dy = y < 0 ? -1 : 0;
    return (dx == 0 && dy == 0) ? cur : mb_at(mbx + dx, mby + dy);
  }
  static int chroma_idx(int comp, int x, int y) {
    return 16 + 4 * comp + (((x + 8) & 7) >> 2) + 2 * (((y + 8) & 7) >> 2);
  }
  int chroma_nc(int comp, int blk) {
    const int bx = (blk & 1) * 4, by = (blk >> 1) * 4;
    const MbInfo *a = chroma_mb(bx - 1, by), *t = chroma_mb(bx, by - 1);
    const int na = a ? a->nc[chroma_idx(comp, bx - 1, by)] : 0;
    const int nb = t ? t->nc[chroma_idx(comp, bx, by - 1)] : 0;
    return a && t ? (na + nb + 1) >> 1 : na + nb;
  }

  // ---------------------------- coded_block_flag's ctxIdxInc (9.3.3.1.1.9)
  // condTermFlagN: an unavailable neighbour counts 1 for an intra macroblock
  // and 0 for an inter one; I_PCM counts 1 (its nc and cbf_dc are all set);
  // else the flag of the neighbouring block (0 where its 8×8 or chroma is
  // not coded, since nc and cbf_dc are then 0)
  int cbf_unavail() const { return is_intra(cur->kind) ? 1 : 0; }
  int cbf_dc_inc(int bit) const {
    const MbInfo *a = mb_a(), *t = mb_b();
    return (a ? (a->cbf_dc >> bit) & 1 : cbf_unavail()) +
           2 * (t ? (t->cbf_dc >> bit) & 1 : cbf_unavail());
  }
  int cbf_luma_inc(int bx, int by) const {
    auto cond = [&](const Neighbour& n) {
      return n.mb ? (n.mb->nc[(n.x >> 2) + 4 * (n.y >> 2)] != 0) : cbf_unavail();
    };
    return cond(locate(bx - 1, by)) + 2 * cond(locate(bx, by - 1));
  }
  int cbf_chroma_inc(int comp, int blk) const {
    const int bx = (blk & 1) * 4, by = (blk >> 1) * 4;
    const MbInfo *a = chroma_mb(bx - 1, by), *t = chroma_mb(bx, by - 1);
    return (a ? a->nc[chroma_idx(comp, bx - 1, by)] != 0 : cbf_unavail()) +
           2 * (t ? t->nc[chroma_idx(comp, bx, by - 1)] != 0 : cbf_unavail());
  }

  // ---------------------------------------------------- intra modes (8.3.1.1)
  int pred_intra_mode(int bx, int by) {
    const Neighbour a = locate(bx - 1, by), bb = locate(bx, by - 1);
    const bool cip = s.pps->constrained_intra_pred;
    auto mode = [&](const Neighbour& n, bool& dc) {
      if (!n.mb || (cip && !is_intra(n.mb->kind))) {
        if (n.mb) d.stats[kStat_cip_neighbour_refused]++;
        dc = true;
        return 2;
      }
      const int m = n.mb->intra4[(n.x >> 2) + 4 * (n.y >> 2)];
      return m < 0 ? 2 : m;
    };
    bool dc = false;
    const int ma = mode(a, dc), mb = mode(bb, dc);
    return dc ? 2 : std::min(ma, mb);
  }
  int read_intra_mode(int bx, int by) {
    const int pred = pred_intra_mode(bx, by);
    int rem;
    if (cab) {
      rem = cab->intra_mode();
      if (rem < 0) return pred;
    } else {
      if (b.flag()) return pred;
      rem = (int)b.u(3);
    }
    return rem < pred ? rem : rem + 1;
  }
  int read_chroma_mode() {
    if (!cab) return b.ue(3, "intra_chroma_pred_mode");
    auto cond = [](const MbInfo* n) {
      return n && is_intra(n->kind) && n->kind != kIPCM && n->chroma_mode != 0 ? 1 : 0;
    };
    return cab->chroma_pred_mode(cond(mb_a()) + cond(mb_b()));
  }
  bool read_t8x8() {
    if (!cab) return b.flag();
    auto cond = [](const MbInfo* n) { return n && n->t8x8 ? 1 : 0; };
    return cab->transform_8x8(cond(mb_a()) + cond(mb_b())) != 0;
  }
  int read_cbp() {
    if (!cab) {
      const uint32_t code = b.ue();
      if (code > 47) raise(kCorrupt, "coded_block_pattern out of range");
      return is_intra(cur->kind) ? kCbpIntra[code] : kCbpInter[code];
    }
    // 9.3.3.1.1.4: a luma 8×8 of an available macroblock counts 1 where it
    // is not coded (I_PCM's cbp has every bit set, a skipped one none)
    const MbInfo *a = mb_a(), *t = mb_b();
    auto luma = [](const MbInfo* n, int b8) { return n ? !((n->cbp >> b8) & 1) : 0; };
    auto chroma = [](const MbInfo* n, int bin) {
      return n ? (bin ? (n->cbp >> 4) == 2 : (n->cbp >> 4) != 0) : 0;
    };
    const int ca[4] = {luma(a, 1), -1, luma(a, 3), -1}, cb[4] = {luma(t, 2), luma(t, 3), -1, -1};
    return cab->cbp(ca, cb, chroma(a, 0), chroma(t, 0), chroma(a, 1), chroma(t, 1));
  }
  int read_qp_delta() {
    const int delta = cab ? cab->qp_delta(prev_qp_delta) : b.se();
    if (delta < -26 || delta > 25) raise(kCorrupt, "mb_qp_delta out of range");
    prev_qp_delta = delta != 0;
    if (cab && delta) d.stats[kStat_cabac_qp_delta_nonzero]++;
    return delta;
  }

  // --------------------------------------------------- mv prediction (8.4.1.3)
  struct Mvn {
    bool avail;
    int ref;
    int mv[2];
  };
  Mvn mv_neighbour(int list, int xn, int yn) const {
    Mvn r{false, -1, {0, 0}};
    const Neighbour n = locate(xn, yn);
    if (!n.mb) return r;
    const int blk = (n.x >> 2) + 4 * (n.y >> 2);
    if (n.mb == cur && !((mv_done >> blk) & 1)) return r;  // not yet decoded
    r.avail = true;
    if (is_intra(n.mb->kind)) return r;
    r.ref = n.mb->ref[list][(n.x >> 3) + 2 * (n.y >> 3)];
    if (r.ref < 0) return r;
    r.mv[0] = n.mb->mv[list][blk][0];
    r.mv[1] = n.mb->mv[list][blk][1];
    return r;
  }
  // shape: 0 any, 1 16x8 upper, 2 16x8 lower, 3 8x16 left, 4 8x16 right
  void mv_pred(int list, int x, int y, int w, int ref, int shape, int out[2]) {
    Mvn a = mv_neighbour(list, x - 1, y), bb = mv_neighbour(list, x, y - 1),
        cc = mv_neighbour(list, x + w, y - 1);
    if (!cc.avail) {
      cc = mv_neighbour(list, x - 1, y - 1);
      d.stats[kStat_mv_c_from_d]++;
    }
    const Mvn* dir = nullptr;
    if (shape == 1 && bb.ref == ref) dir = &bb;
    if (shape == 2 && a.ref == ref) dir = &a;
    if (shape == 3 && a.ref == ref) dir = &a;
    if (shape == 4 && cc.ref == ref) dir = &cc;
    if (dir) {
      d.stats[shape <= 2 ? kStat_mv_dir_16x8 : kStat_mv_dir_8x16]++;
      out[0] = dir->mv[0];
      out[1] = dir->mv[1];
      return;
    }
    if (!bb.avail && !cc.avail && a.avail) bb = cc = a;
    const int match = (a.ref == ref) + (bb.ref == ref) + (cc.ref == ref);
    if (match == 1) {
      const Mvn& m = a.ref == ref ? a : bb.ref == ref ? bb : cc;
      out[0] = m.mv[0];
      out[1] = m.mv[1];
      return;
    }
    for (int k = 0; k < 2; k++) {
      const int p = a.mv[k], q = bb.mv[k], r = cc.mv[k];
      out[k] = std::max(std::min(p, q), std::min(std::max(p, q), r));
    }
  }
  void set_mv(int list, int x, int y, int w, int h, const int mv[2]) {
    if (mv[0] < -32768 || mv[0] > 32767 || mv[1] < -32768 || mv[1] > 32767)
      raise(kCorrupt, "motion vector out of range");
    for (int j = y; j < y + h; j += 4)
      for (int i = x; i < x + w; i += 4) {
        const int blk = (i >> 2) + 4 * (j >> 2);
        cur->mv[list][blk][0] = (int16_t)mv[0];
        cur->mv[list][blk][1] = (int16_t)mv[1];
      }
  }
  void done(int x, int y, int w, int h) {
    for (int j = y; j < y + h; j += 4)
      for (int i = x; i < x + w; i += 4) mv_done |= (uint16_t)(1u << ((i >> 2) + 4 * (j >> 2)));
  }
  void set_ref(int list, int b8, int ref) {
    const std::vector<Picture*>& l = s.ref_list[list];
    if (ref < 0 || ref >= (int)l.size() || !l[(size_t)ref])
      raise(kCorrupt, "ref_idx names no reference picture");
    cur->ref[list][b8] = (int8_t)ref;
    cur->ref_pic[list][b8] = l[(size_t)ref]->id;
    if (ref > 0) d.stats[kStat_ref_idx_nonzero]++;
  }
  void set_ref_area(int list, int x, int y, int w, int h, int ref) {
    for (int k = 0; k < 4; k++) {
      const int kx = (k & 1) * 8, ky = (k >> 1) * 8;
      if (kx >= x && kx < x + w && ky >= y && ky < y + h) set_ref(list, k, ref);
    }
  }

  // ref_idx_lX of the partition whose top-left sample is (x, y)
  int read_ref(int list, int x, int y) {
    const int n = s.sh.num_ref_idx_active[list];
    if (!cab) return b.te(n - 1);
    auto cond = [&](const Neighbour& nb) {  // 9.3.3.1.1.6
      if (!nb.mb || is_skip(nb.mb->kind) || is_intra(nb.mb->kind)) return 0;
      const int b8 = (nb.x >> 3) + 2 * (nb.y >> 3);
      if ((nb.mb->direct >> b8) & 1) return 0;
      return nb.mb->ref[list][b8] > 0 ? 1 : 0;
    };
    return cab->ref_idx(cond(locate(x - 1, y)) + 2 * cond(locate(x, y - 1)), n - 1);
  }
  // mvd_lX of a w×h partition at (x, y), its absolute values kept for CABAC
  void read_mvd(int list, int x, int y, int w, int h, int out[2]) {
    if (!cab) {
      out[0] = b.se();
      out[1] = b.se();
    } else {
      const Neighbour a = locate(x - 1, y), t = locate(x, y - 1);  // 9.3.3.1.1.7
      for (int comp = 0; comp < 2; comp++) {
        int sum = 0;
        if (a.mb) sum += a.mb->mvd[list][(a.x >> 2) + 4 * (a.y >> 2)][comp];
        if (t.mb) sum += t.mb->mvd[list][(t.x >> 2) + 4 * (t.y >> 2)][comp];
        out[comp] = cab->mvd(comp, sum);
      }
    }
    for (int comp = 0; comp < 2; comp++)
      if (out[comp] < -32768 || out[comp] > 32767) raise(kCorrupt, "mvd out of range");
    const uint8_t ax = (uint8_t)std::min(std::abs(out[0]), 64);
    const uint8_t ay = (uint8_t)std::min(std::abs(out[1]), 64);
    for (int j = y; j < y + h; j += 4)
      for (int i = x; i < x + w; i += 4) {
        cur->mvd[list][(i >> 2) + 4 * (j >> 2)][0] = ax;
        cur->mvd[list][(i >> 2) + 4 * (j >> 2)][1] = ay;
      }
  }

  void p_skip() {  // 8.4.1.1
    cur->kind = kPSkip;
    d.stats[kStat_mb_pskip]++;
    for (int k = 0; k < 4; k++) set_ref(0, k, 0);
    int mv[2] = {0, 0};
    const Mvn a = mv_neighbour(0, -1, 0), bb = mv_neighbour(0, 0, -1);
    if (!a.avail || !bb.avail || (a.ref == 0 && !a.mv[0] && !a.mv[1]) ||
        (bb.ref == 0 && !bb.mv[0] && !bb.mv[1])) {
      d.stats[kStat_pskip_zero_mv]++;
    } else {
      mv_pred(0, 0, 0, 16, 0, 0, mv);
      d.stats[kStat_pskip_pred_mv]++;
    }
    set_mv(0, 0, 0, 16, 16, mv);
    done(0, 0, 16, 16);
  }
  void b_skip() {
    cur->kind = kBSkip;
    d.stats[kStat_mb_bskip]++;
    for (int k = 0; k < 4; k++) direct_8x8(k);
  }

  // ------------------------------------------------ direct prediction (8.4.1.2)
  void spatial_setup() {  // 8.4.1.2.2: refIdxL0 / L1 and the predictors, once a macroblock
    spatial_done = true;
    for (int list = 0; list < 2; list++) {
      const Mvn a = mv_neighbour(list, -1, 0), bb = mv_neighbour(list, 0, -1);
      Mvn cc = mv_neighbour(list, 16, -1);
      if (!cc.avail) cc = mv_neighbour(list, -1, -1);
      spatial_ref[list] = min_positive(a.ref, min_positive(bb.ref, cc.ref));
    }
    spatial_zero = spatial_ref[0] < 0 && spatial_ref[1] < 0;
    if (spatial_zero) {
      spatial_ref[0] = spatial_ref[1] = 0;
      d.stats[kStat_direct_zero_refs]++;
    }
    for (int list = 0; list < 2; list++) {
      spatial_mv[list][0] = spatial_mv[list][1] = 0;
      if (!spatial_zero && spatial_ref[list] >= 0)
        mv_pred(list, 0, 0, 16, spatial_ref[list], 0, spatial_mv[list]);
    }
  }
  // 8.4.1.2.3: the lowest index of RefPicList0 that holds the co-located
  // block's reference; one the list lacks (a stream the standard does not
  // allow) maps to 0, as FFmpeg maps it
  int map_col_to_list0(int pic_id) {
    const std::vector<Picture*>& l = s.ref_list[0];
    for (size_t i = 0; i < l.size(); i++)
      if (l[i] && l[i]->id == pic_id) {
        if (l[i]->long_ref) d.stats[kStat_direct_long_term]++;
        return (int)i;
      }
    return 0;
  }
  void direct_8x8(int b8) {  // the motion of one 8×8 predicted in direct mode
    cur->direct |= (uint8_t)(1 << b8);
    const std::vector<Picture*>& l1 = s.ref_list[1];
    if (l1.empty() || !l1[0]) raise(kCorrupt, "direct prediction without RefPicList1[0]");
    const Picture& col_pic = *l1[0];
    if (col_pic.motion.size() != d.mbs.size())
      raise(kCorrupt, "direct prediction: the co-located picture has no motion field");
    const MbInfo& col = col_pic.motion[(size_t)addr];  // 8.4.1.2.1, frames: the same address
    const bool infer = s.sps->direct_8x8_inference;
    d.stats[infer ? kStat_direct_8x8_inference : kStat_direct_4x4]++;
    const bool spatial = s.sh.direct_spatial;
    d.stats[spatial ? kStat_direct_spatial : kStat_direct_temporal]++;
    if (spatial && !spatial_done) spatial_setup();
    int ref[2] = {-1, -1};
    for (int k = 0; k < 4; k++) {
      const int x = (b8 & 1) * 8 + (k & 1) * 4, y = (b8 >> 1) * 8 + (k >> 1) * 4;
      const int cx = infer ? (b8 & 1) * 12 : x, cy = infer ? (b8 >> 1) * 12 : y;
      const int cblk = (cx >> 2) + 4 * (cy >> 2), cb8 = (cx >> 3) + 2 * (cy >> 3);
      int ref_col = -1, ref_col_pic = -1, mv_col[2] = {0, 0};
      if (is_intra(col.kind)) {
        d.stats[kStat_direct_col_intra]++;
      } else {
        const int lc = col.ref[0][cb8] >= 0 ? 0 : 1;
        ref_col = col.ref[lc][cb8];
        ref_col_pic = col.ref_pic[lc][cb8];
        mv_col[0] = col.mv[lc][cblk][0];
        mv_col[1] = col.mv[lc][cblk][1];
      }
      int mv[2][2] = {{0, 0}, {0, 0}};
      if (spatial) {
        const bool col_zero = !col_pic.long_ref && ref_col == 0 && std::abs(mv_col[0]) <= 1 &&
                              std::abs(mv_col[1]) <= 1;
        if (col_zero) d.stats[kStat_direct_col_zero]++;
        for (int list = 0; list < 2; list++) {
          ref[list] = spatial_ref[list];
          if (spatial_zero || ref[list] < 0 || (ref[list] == 0 && col_zero)) continue;
          mv[list][0] = spatial_mv[list][0];
          mv[list][1] = spatial_mv[list][1];
        }
      } else {
        ref[0] = ref_col < 0 ? 0 : map_col_to_list0(ref_col_pic);
        ref[1] = 0;
        if (ref[0] >= (int)s.ref_list[0].size() || !s.ref_list[0][(size_t)ref[0]])
          raise(kCorrupt, "temporal direct: RefPicList0 has no such entry");
        const Picture& p0 = *s.ref_list[0][(size_t)ref[0]];
        if (p0.long_ref || col_pic.poc == p0.poc) {
          if (col_pic.poc == p0.poc) d.stats[kStat_direct_td_zero]++;
          mv[0][0] = mv_col[0];
          mv[0][1] = mv_col[1];
        } else {
          const int dsf = dist_scale_factor(d.cur.poc, p0, col_pic);
          for (int comp = 0; comp < 2; comp++) {
            mv[0][comp] = (dsf * mv_col[comp] + 128) >> 8;
            mv[1][comp] = mv[0][comp] - mv_col[comp];
          }
        }
      }
      for (int list = 0; list < 2; list++)
        if (ref[list] >= 0) set_mv(list, x, y, 4, 4, mv[list]);
    }
    for (int list = 0; list < 2; list++)
      if (ref[list] >= 0) set_ref(list, b8, ref[list]);
    count_pred(ref[0] >= 0, ref[1] >= 0);
    done((b8 & 1) * 8, (b8 >> 1) * 8, 8, 8);
  }
  void count_pred(bool l0, bool l1) {
    d.stats[l0 && l1 ? kStat_part_bi : l0 ? kStat_part_l0 : kStat_part_l1]++;
  }

  // ---------------------------------------------------------------- residual
  // one 4×4 luma block (ctxBlockCat 1 or 2) at (bx, by): levels by scan index
  int luma_block(int cat, int bx, int by, int max, int32_t* lv) {
    if (!cab) return residual_block(b, luma_nc(bx, by), max, lv, d.stats);
    return cab->residual(cat, cbf_luma_inc(bx, by), max, lv);
  }
  // 7.3.5.3: coefficients dequantized into c (8.5)
  void residual(int cbp, bool i16, int qp) {
    const bool intra = is_intra(cur->kind);
    const int l4 = intra ? 0 : 3, l8 = intra ? 0 : 1;
    int32_t lv[64];
    c.luma_coded = 0;
    if (!cur->t8x8) std::memset(c.luma, 0, sizeof(c.luma));
    if (i16) {  // Intra16x16DCLevel, then AC
      const int n = cab ? cab->residual(0, cbf_dc_inc(0), 16, lv)
                        : residual_block(b, luma_nc(0, 0), 16, lv, d.stats);
      if (n) {
        cur->cbf_dc |= 1;
        int32_t m[16];
        for (int k = 0; k < 16; k++) m[kZigzag4[k]] = lv[k];
        luma_dc(m, s.dq4[l4][qp][0]);
        c.luma_coded = 0xFFFF;
      }
    }
    for (int b8 = 0; b8 < 4; b8++) {
      const int x8 = (b8 & 1) * 8, y8 = (b8 >> 1) * 8;
      if (!((cbp >> b8) & 1)) continue;  // nc stays 0
      if (cur->t8x8) {
        int32_t* out = c.luma8[b8];
        std::memset(out, 0, sizeof(c.luma8[b8]));
        int any = 0;
        if (cab) {  // one 64-coefficient block (ctxBlockCat 5)
          any = cab->residual(5, 0, 64, lv);
          for (int k = 0; k < 4; k++)
            cur->nc[(x8 >> 2) + (k & 1) + 4 * ((y8 >> 2) + (k >> 1))] = (uint8_t)any;
          for (int i = 0; i < 64; i++)
            if (lv[i]) out[kZigzag8[i]] = (lv[i] * s.dq8[l8][qp][i] + 32) >> 6;
        } else {
          for (int k = 0; k < 4; k++) {  // four interleaved 4×4 blocks
            const int bx = x8 + (k & 1) * 4, by = y8 + (k >> 1) * 4;
            const int n = residual_block(b, luma_nc(bx, by), 16, lv, d.stats);
            cur->nc[(bx >> 2) + 4 * (by >> 2)] = (uint8_t)n;
            any |= n;
            for (int i = 0; i < 16; i++)
              if (lv[i]) {
                const int zz = 4 * i + k;
                out[kZigzag8[zz]] = (lv[i] * s.dq8[l8][qp][zz] + 32) >> 6;
              }
          }
        }
        if (any) {
          const int bits = (1 << ((x8 >> 2) + 4 * (y8 >> 2))) * 0x33;  // its four 4×4
          c.luma_coded |= (uint16_t)bits;
          cur->nz_filter |= (uint16_t)bits;
        }
        continue;
      }
      for (int k = 0; k < 4; k++) {
        const int bx = x8 + (k & 1) * 4, by = y8 + (k >> 1) * 4, r = (bx >> 2) + 4 * (by >> 2);
        int32_t* out = c.luma[r];
        const int start = i16 ? 1 : 0;
        const int n = luma_block(i16 ? 1 : 2, bx, by, 16 - start, lv);
        cur->nc[r] = (uint8_t)n;
        if (!n) continue;
        c.luma_coded |= (uint16_t)(1u << r);
        cur->nz_filter |= (uint16_t)(1u << r);
        for (int i = 0; i < 16 - start; i++)
          if (lv[i]) {
            const int zz = i + start;
            out[kZigzag4[zz]] = (lv[i] * s.dq4[l4][qp][zz] + 8) >> 4;
          }
      }
    }
    // chroma (4:2:0): DC of Cb and Cr, then AC
    const int cbp_c = cbp >> 4;
    c.chroma_coded[0] = c.chroma_coded[1] = 0;
    for (int comp = 0; comp < 2; comp++)
      for (int k = 0; k < 4; k++) std::memset(c.chroma[comp][k], 0, sizeof(c.chroma[comp][k]));
    if (!cbp_c) return;
    int qpc[2];
    for (int comp = 0; comp < 2; comp++) {
      qpc[comp] = chroma_qp(qp, s.pps->chroma_qp_offset[comp]);
      const int n = cab ? cab->residual(3, cbf_dc_inc(1 + comp), 4, lv)
                        : residual_block(b, -1, 4, lv, d.stats);
      if (!n) continue;
      cur->cbf_dc |= (uint8_t)(2 << comp);
      // 8.5.11: f = [[1,1],[1,-1]] c [[1,1],[1,-1]], then ((f · LS) << (qP/6)) >> 5
      const int32_t t = s.dq4[(intra ? 1 : 4) + comp][qpc[comp]][0];
      const int32_t a0 = lv[0] + lv[1], a1 = lv[0] - lv[1], a2 = lv[2] + lv[3], a3 = lv[2] - lv[3];
      const int32_t f[4] = {a0 + a2, a1 + a3, a0 - a2, a1 - a3};
      for (int k = 0; k < 4; k++) {
        c.chroma[comp][k][0] = (f[k] * t) >> 5;
        if (c.chroma[comp][k][0]) c.chroma_coded[comp] |= (uint8_t)(1 << k);
      }
    }
    if (!(cbp_c & 2)) return;
    for (int comp = 0; comp < 2; comp++) {
      const int list = (intra ? 1 : 4) + comp;
      for (int k = 0; k < 4; k++) {
        const int n = cab ? cab->residual(4, cbf_chroma_inc(comp, k), 15, lv)
                          : residual_block(b, chroma_nc(comp, k), 15, lv, d.stats);
        cur->nc[16 + 4 * comp + k] = (uint8_t)n;
        if (!n) continue;
        c.chroma_coded[comp] |= (uint8_t)(1 << k);
        for (int i = 0; i < 15; i++)
          if (lv[i]) {
            const int zz = i + 1;
            c.chroma[comp][k][kZigzag4[zz]] = (lv[i] * s.dq4[list][qpc[comp]][zz] + 8) >> 4;
          }
      }
    }
  }

  // 8.5.10: the Intra16x16 DC's Hadamard transform and scaling
  void luma_dc(const int32_t* m, int32_t t) {
    int32_t f[16], g[16];
    for (int i = 0; i < 4; i++) {  // rows
      const int32_t* r = m + 4 * i;
      const int32_t a = r[0] + r[1], bq = r[0] - r[1], cq = r[2] + r[3], dq = r[2] - r[3];
      f[4 * i + 0] = a + cq;
      f[4 * i + 1] = a - cq;
      f[4 * i + 2] = bq - dq;
      f[4 * i + 3] = bq + dq;
    }
    for (int j = 0; j < 4; j++) {  // columns
      const int32_t a = f[j] + f[4 + j], bq = f[j] - f[4 + j], cq = f[8 + j] + f[12 + j],
                    dq = f[8 + j] - f[12 + j];
      g[j] = a + cq;
      g[4 + j] = a - cq;
      g[8 + j] = bq - dq;
      g[12 + j] = bq + dq;
    }
    for (int k = 0; k < 16; k++) c.luma[k][0] = (g[k] * t + 32) >> 6;
  }

  // ---------------------------------------------------------- the macroblock
  // 7.3.5, mb_type already read: P 0-4 inter and 5-30 intra, B 0-22 inter
  // and 23-48 intra, I 0-25
  void decode(int mb_type, int& qp) {
    const int st = s.sh.type;
    reset_mb();
    int cbp = 0;
    bool i16 = false;
    int i16_mode = 0, chroma_mode = 0;
    const int n_inter = st == 0 ? 5 : st == 1 ? 23 : 0;
    if (mb_type < n_inter) {
      if (st == 0) inter_p(mb_type);
      else inter_b(mb_type);
    } else {
      mb_type -= n_inter;
      if (st != 2) d.stats[st == 0 ? kStat_intra_in_p : kStat_intra_in_b]++;
      if (mb_type == 25) {
        pcm();
        prev_qp_delta = false;
        return;
      }
      if (mb_type == 0) {
        cur->kind = kI4x4;
        if (s.pps->transform_8x8_mode && read_t8x8()) cur->kind = kI8x8, cur->t8x8 = true;
        if (cur->kind == kI4x4) {
          d.stats[kStat_mb_i4x4]++;
          for (int k = 0; k < 16; k++) {
            const int m = read_intra_mode(kBlkX[k], kBlkY[k]);
            cur->intra4[(kBlkX[k] >> 2) + kBlkY[k]] = (int8_t)m;
            d.stats[kStat_i4x4_mode0 + m]++;
          }
        } else {
          d.stats[kStat_mb_i8x8]++;
          for (int k = 0; k < 4; k++) {
            const int x = (k & 1) * 8, y = (k >> 1) * 8;
            const int m = read_intra_mode(x, y);
            for (int j = 0; j < 4; j++)
              cur->intra4[(x >> 2) + (j & 1) + 4 * ((y >> 2) + (j >> 1))] = (int8_t)m;
            d.stats[kStat_i8x8_mode0 + m]++;
          }
        }
      } else {
        cur->kind = kI16x16;
        d.stats[kStat_mb_i16x16]++;
        i16 = true;
        i16_mode = (mb_type - 1) % 4;
        cbp = (((mb_type - 1) / 4) % 3) << 4 | (mb_type >= 13 ? 15 : 0);
        d.stats[kStat_i16_mode0 + i16_mode]++;
      }
      chroma_mode = read_chroma_mode();
      cur->chroma_mode = (int8_t)chroma_mode;
      d.stats[kStat_chroma_mode0 + chroma_mode]++;
    }
    if (!i16) {
      cbp = read_cbp();
      if ((cbp & 15) && s.pps->transform_8x8_mode && !is_intra(cur->kind) && eight_ok &&
          (cur->kind != kBDirect16x16 || s.sps->direct_8x8_inference)) {
        cur->t8x8 = read_t8x8();
        if (cur->t8x8) d.stats[kStat_inter_t8x8]++;
      }
    }
    cur->cbp = (uint8_t)cbp;
    if (cbp || i16) {
      const int delta = read_qp_delta();
      if (qp + delta < 0 || qp + delta > 51) d.stats[kStat_qp_delta_wrap]++;
      qp = (qp + delta + 52) % 52;
    } else {
      prev_qp_delta = false;
    }
    cur->qp_filter = (int8_t)qp;
    if (cbp || i16) {
      residual(cbp, i16, qp);
    } else {
      c.luma_coded = 0;
      c.chroma_coded[0] = c.chroma_coded[1] = 0;
    }
    if (!cab) b.check();
    reconstruct(i16_mode, chroma_mode, i16);
  }

  // mb_pred of the inter macroblocks of one or two partitions: shape 0
  // 16×16, 1 16×8, 2 8×16; pred: each partition's lists (1 L0, 2 L1, 3 both)
  void partitions(int shape, const uint8_t pred[2]) {
    const int parts = shape ? 2 : 1;
    int ref[2][2] = {{0, 0}, {0, 0}}, mvd[2][2][2];
    int gx[2], gy[2], gw[2], gh[2];
    for (int p = 0; p < parts; p++) {
      gx[p] = shape == 2 ? 8 * p : 0;
      gy[p] = shape == 1 ? 8 * p : 0;
      gw[p] = shape == 2 ? 8 : 16;
      gh[p] = shape == 1 ? 8 : 16;
    }
    for (int list = 0; list < 2; list++)
      for (int p = 0; p < parts; p++) {
        if (!((pred[p] >> list) & 1)) continue;
        if (s.sh.num_ref_idx_active[list] > 1) ref[list][p] = read_ref(list, gx[p], gy[p]);
        set_ref_area(list, gx[p], gy[p], gw[p], gh[p], ref[list][p]);
      }
    for (int list = 0; list < 2; list++)
      for (int p = 0; p < parts; p++)
        if ((pred[p] >> list) & 1) read_mvd(list, gx[p], gy[p], gw[p], gh[p], mvd[list][p]);
    for (int p = 0; p < parts; p++) {
      for (int list = 0; list < 2; list++) {
        if (!((pred[p] >> list) & 1)) continue;
        int mv[2];
        mv_pred(list, gx[p], gy[p], gw[p], ref[list][p], shape ? 2 * shape - 1 + p : 0, mv);
        mv[0] += mvd[list][p][0];
        mv[1] += mvd[list][p][1];
        set_mv(list, gx[p], gy[p], gw[p], gh[p], mv);
      }
      if (s.sh.type == 1) count_pred(pred[p] & 1, pred[p] & 2);
      done(gx[p], gy[p], gw[p], gh[p]);
    }
  }

  // sub_mb_pred of P_8x8, P_8x8ref0 and B_8x8: each 8×8's shape and lists
  // (B_Direct_8x8 where `direct` has its bit)
  void sub_partitions(const int shape[4], const uint8_t pred[4], bool ref0) {
    int ref[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}}, mvd[2][16][2];
    for (int list = 0; list < 2; list++)
      for (int k = 0; k < 4; k++) {
        if (((cur->direct >> k) & 1) || !((pred[k] >> list) & 1)) continue;
        if (!ref0 && s.sh.num_ref_idx_active[list] > 1)
          ref[list][k] = read_ref(list, (k & 1) * 8, (k >> 1) * 8);
        set_ref(list, k, ref[list][k]);
      }
    auto part = [&](int k, int p, int& x, int& y) {
      const int t = shape[k], w = kSubW[t], h = kSubH[t];
      x = (k & 1) * 8 + (w == 4 ? 4 * (p & 1) : 0);
      y = (k >> 1) * 8 + (h == 4 ? 4 * (w == 4 ? p >> 1 : p) : 0);
    };
    for (int list = 0; list < 2; list++)
      for (int k = 0; k < 4; k++) {
        if (((cur->direct >> k) & 1) || !((pred[k] >> list) & 1)) continue;
        for (int p = 0; p < kSubParts[shape[k]]; p++) {
          int x, y;
          part(k, p, x, y);
          read_mvd(list, x, y, kSubW[shape[k]], kSubH[shape[k]], mvd[list][4 * k + p]);
        }
      }
    for (int k = 0; k < 4; k++) {
      if ((cur->direct >> k) & 1) {
        direct_8x8(k);
        continue;
      }
      const int t = shape[k], w = kSubW[t], h = kSubH[t];
      for (int p = 0; p < kSubParts[t]; p++) {
        int x, y;
        part(k, p, x, y);
        for (int list = 0; list < 2; list++) {
          if (!((pred[k] >> list) & 1)) continue;
          int mv[2];
          mv_pred(list, x, y, w, ref[list][k], 0, mv);
          mv[0] += mvd[list][4 * k + p][0];
          mv[1] += mvd[list][4 * k + p][1];
          set_mv(list, x, y, w, h, mv);
        }
        done(x, y, w, h);
      }
      if (s.sh.type == 1) count_pred(pred[k] & 1, pred[k] & 2);
    }
  }

  void inter_p(int mb_type) {  // P_L0_16x16 .. P_8x8ref0 (Table 7-13)
    static const MbKind kKinds[5] = {kP16x16, kP16x8, kP8x16, kP8x8, kP8x8ref0};
    cur->kind = kKinds[mb_type];
    d.stats[kStat_mb_p16x16 + mb_type]++;
    if (mb_type < 3) {
      static const uint8_t kL0[2] = {1, 1};
      partitions(mb_type, kL0);
      return;
    }
    int shape[4];
    const uint8_t pred[4] = {1, 1, 1, 1};
    for (int k = 0; k < 4; k++) {
      shape[k] = cab ? cab->sub_mb_type_p() : b.ue(3, "sub_mb_type");
      if (shape[k]) eight_ok = false;
      d.stats[kStat_sub_8x8 + shape[k]]++;
    }
    sub_partitions(shape, pred, mb_type == 4);
  }

  void inter_b(int mb_type) {  // B_Direct_16x16 .. B_8x8 (Table 7-14)
    if (mb_type == 0) {
      cur->kind = kBDirect16x16;
      d.stats[kStat_mb_bdirect16x16]++;
      for (int k = 0; k < 4; k++) direct_8x8(k);
      return;
    }
    if (mb_type < 22) {
      const int shape = mb_type < 4 ? 0 : (mb_type & 1) ? 2 : 1;
      cur->kind = shape == 0 ? kB16x16 : shape == 1 ? kB16x8 : kB8x16;
      d.stats[kStat_mb_b16x16 + shape]++;
      partitions(shape, kBPred[mb_type]);
      return;
    }
    cur->kind = kB8x8;
    d.stats[kStat_mb_b8x8]++;
    int shape[4];
    uint8_t pred[4];
    for (int k = 0; k < 4; k++) {
      const int t = cab ? cab->sub_mb_type_b() : b.ue(12, "sub_mb_type");
      shape[k] = kBSubShape[t];
      pred[k] = kBSubPred[t];
      if (t == 0) {
        cur->direct |= (uint8_t)(1 << k);
        if (!s.sps->direct_8x8_inference) eight_ok = false;
        d.stats[kStat_sub_bdirect]++;
      } else {
        if (shape[k]) eight_ok = false;
        d.stats[kStat_sub_b8x8 + shape[k]]++;
      }
    }
    sub_partitions(shape, pred, false);
  }

  void pcm() {  // I_PCM (7.3.5): the samples themselves
    cur->kind = kIPCM;
    d.stats[kStat_mb_pcm]++;
    size_t& pos = cab ? cab->pos : b.pos;
    pos = (pos + 7) & ~(size_t)7;  // pcm_alignment_zero_bit
    if (pos / 8 + 384 > b.buf.size()) raise(kCorrupt, "I_PCM samples past the end of the slice");
    const uint8_t* p = b.buf.data() + pos / 8;
    Picture& pic = d.cur;
    for (int y = 0; y < 16; y++)
      std::memcpy(&pic.y[(size_t)((mby * 16 + y) * pic.width + mbx * 16)], p + 16 * y, 16);
    const int cw = pic.width / 2;
    for (int comp = 0; comp < 2; comp++) {
      std::vector<uint8_t>& pl = comp ? pic.v : pic.u;
      for (int y = 0; y < 8; y++)
        std::memcpy(&pl[(size_t)((mby * 8 + y) * cw + mbx * 8)], p + 256 + 64 * comp + 8 * y, 8);
    }
    pos += 384 * 8;
    std::memset(cur->nc, 16, sizeof(cur->nc));
    cur->cbf_dc = 7;
    cur->cbp = 0x2F;
    cur->qp_filter = 0;  // QP_Y,PRED of the next macroblock stays the running QP
    cur->nz_filter = 0xFFFF;
    if (cab) {
      d.stats[kStat_cabac_pcm]++;
      cab->start(cab->buf, pos, cab->end);  // 9.3.1.2 after the samples
    } else {
      b.check();
    }
  }

  void reconstruct(int i16_mode, int chroma_mode, bool i16) {
    Picture& pic = d.cur;
    const int stride = pic.width;
    uint8_t* luma = pic.y.data() + (size_t)(mby * 16 * stride + mbx * 16);
    if (cur->kind == kI4x4) {
      for (int k = 0; k < 16; k++) {
        const int x = kBlkX[k], y = kBlkY[k], r = (x >> 2) + y;
        intra_pred_4x4(s, mbx, mby, k, cur->intra4[r]);
        if ((c.luma_coded >> r) & 1) add_residual_4x4(luma + y * stride + x, stride, c.luma[r]);
      }
    } else if (cur->kind == kI8x8) {
      for (int k = 0; k < 4; k++) {
        const int x = (k & 1) * 8, y = (k >> 1) * 8;
        intra_pred_8x8(s, mbx, mby, k, cur->intra4[(x >> 2) + y]);
        if ((c.luma_coded >> ((x >> 2) + y)) & 1)
          add_residual_8x8(luma + y * stride + x, stride, c.luma8[k]);
      }
    } else {
      if (i16) intra_pred_16x16(s, mbx, mby, i16_mode);
      else inter_pred(s, mbx, mby, *cur);
      for (int r = 0; r < 16; r++) {
        const int x = (r & 3) * 4, y = (r >> 2) * 4;
        if (cur->t8x8) {
          if ((r & 5) == 0 && ((c.luma_coded >> r) & 1))
            add_residual_8x8(luma + y * stride + x, stride, c.luma8[(x >> 3) + 2 * (y >> 3)]);
        } else if ((c.luma_coded >> r) & 1) {
          add_residual_4x4(luma + y * stride + x, stride, c.luma[r]);
        }
      }
    }
    if (is_intra(cur->kind)) intra_pred_chroma(s, mbx, mby, chroma_mode);
    const int cs = stride / 2;
    for (int comp = 0; comp < 2; comp++) {
      if (!c.chroma_coded[comp]) continue;
      uint8_t* base = (comp ? pic.v : pic.u).data() + (size_t)(mby * 8 * cs + mbx * 8);
      for (int k = 0; k < 4; k++)
        if ((c.chroma_coded[comp] >> k) & 1)
          add_residual_4x4(base + (k >> 1) * 4 * cs + (k & 1) * 4, cs, c.chroma[comp][k]);
    }
  }
};

// ------------------------------------------------------------- slice data

void slice_data(SliceCtx& s, Bits& b) {  // 7.3.4
  Decoder& d = *s.d;
  const int mbs = s.sps->mb_width * s.sps->mb_height;
  const int st = s.sh.type;
  int addr = s.sh.first_mb, qp = s.sh.qp;
  if (addr >= mbs) raise(kCorrupt, "first_mb_in_slice past the picture");
  Cabac cab;
  if (s.pps->cabac) {
    b.pos = (b.pos + 7) & ~(size_t)7;  // cabac_alignment_one_bit
    cab.init_contexts(st, s.sh.cabac_init_idc, s.sh.qp);
    cab.start(b.buf.data(), b.pos, b.buf.size() * 8);
    cab.stats = d.stats;
  }
  MbDecoder m(s, b, s.pps->cabac ? &cab : nullptr);
  auto begin = [&](int a) {
    if (a >= mbs) raise(kCorrupt, "slice runs past the picture's last macroblock");
    MbInfo& mb = d.mbs[(size_t)a];
    if (mb.slice >= 0) raise(kCorrupt, "macroblock decoded twice");
    mb.slice = s.slice_num;
    m.addr = a;
    m.mbx = a % s.sps->mb_width;
    m.mby = a / s.sps->mb_width;
    m.cur = &mb;
  };
  auto skipped = [&] {  // P_Skip / B_Skip: no residual
    m.reset_mb();
    m.cur->qp_filter = (int8_t)qp;
    m.prev_qp_delta = false;
    if (st == 0) m.p_skip();
    else m.b_skip();
    inter_pred(s, m.mbx, m.mby, *m.cur);
  };
  if (!s.pps->cabac) {
    bool more = true;
    while (more) {
      if (st != 2) {
        const uint32_t run = b.ue();
        if (run > (uint32_t)(mbs - addr)) raise(kCorrupt, "mb_skip_run past the picture");
        for (uint32_t i = 0; i < run; i++, addr++) {
          begin(addr);
          skipped();
        }
        if (run > 0 && !b.more_rbsp_data()) break;
      }
      begin(addr);
      m.decode(b.ue(st == 0 ? 30 : st == 1 ? 48 : 25, "mb_type"), qp);  // Tables 7-11, 7-13, 7-14
      more = b.more_rbsp_data();
      addr++;
    }
    return;
  }
  d.stats[kStat_cabac_slices]++;
  d.stats[kStat_cabac_init_idc0 + s.sh.cabac_init_idc] += st != 2;
  for (;;) {
    begin(addr);
    // ctxIdxInc of mb_skip_flag and mb_type (9.3.3.1.1.1, 9.3.3.1.1.3): the
    // available neighbours A and B whose kind passes `f`
    const MbInfo *a = m.mb_a(), *t = m.mb_b();
    auto count = [&](auto f) { return (a && f(a->kind) ? 1 : 0) + (t && f(t->kind) ? 1 : 0); };
    const bool skip = st != 2 && cab.skip_flag(st == 1, count([](int k) { return !is_skip(k); }));
    if (skip) {
      skipped();
    } else if (st == 2) {
      m.decode(cab.mb_type_i(3, count([](int k) { return k != kI4x4 && k != kI8x8; })), qp);
    } else if (st == 0) {
      m.decode(cab.mb_type_p(), qp);
    } else {
      m.decode(cab.mb_type_b(count([](int k) { return k != kBSkip && k != kBDirect16x16; })), qp);
    }
    addr++;
    if (cab.terminate()) break;  // end_of_slice_flag
  }
  if (cab.pos > b.end + 1) raise(kCorrupt, "slice data past the end of its NAL unit");
}

// ------------------------------------------------------- reference lists

int max_frame_num(const Sps& s) { return 1 << s.log2_max_frame_num; }

// 8.2.4.3: modification of one list, already cut to num_ref_idx_active
void modify_ref_list(SliceCtx& s, std::vector<Picture*>& list, const std::vector<ListMod>& mods,
                     const std::vector<Picture*>& st, const std::vector<Picture*>& lt) {
  Decoder& d = *s.d;
  const int max_fn = max_frame_num(*s.sps), cur_fn = s.sh.frame_num;
  const int n = (int)list.size();
  list.resize((size_t)n + 1, nullptr);  // one spare entry for the modification
  int pred = cur_fn, idx = 0;
  for (const ListMod& m : mods) {
    d.stats[kStat_list_mod_idc0 + m.idc]++;
    if (idx >= n) raise(kCorrupt, "too many ref_pic_list_modification operations");
    Picture* pic = nullptr;
    if (m.idc < 2) {
      const int abs_diff = m.value + 1;
      if (abs_diff > max_fn) raise(kCorrupt, "abs_diff_pic_num out of range");
      int no_wrap = m.idc == 0 ? pred - abs_diff : pred + abs_diff;
      if (no_wrap < 0) no_wrap += max_fn;
      if (no_wrap >= max_fn) no_wrap -= max_fn;
      pred = no_wrap;
      const int num = no_wrap > cur_fn ? no_wrap - max_fn : no_wrap;
      for (Picture* p : st)
        if (p->frame_num_wrap == num) pic = p;
    } else {
      for (Picture* p : lt)
        if (p->long_term_idx == m.value) pic = p;
    }
    if (!pic) raise(kCorrupt, "ref_pic_list_modification names no reference picture");
    for (int c = n; c > idx; c--) list[(size_t)c] = list[(size_t)c - 1];
    list[(size_t)idx++] = pic;
    int k = idx;
    for (int c = idx; c <= n; c++)
      if (list[(size_t)c] != pic) list[(size_t)k++] = list[(size_t)c];
  }
  list.resize((size_t)n);
}

// 8.2.4: RefPicList0 (P and B slices) and RefPicList1 (B slices)
void init_ref_lists(SliceCtx& s, const std::vector<ListMod> mods[2]) {
  Decoder& d = *s.d;
  const int max_fn = max_frame_num(*s.sps), cur_fn = s.sh.frame_num;
  std::vector<Picture*> st, lt;
  for (Picture& p : d.dpb) {
    if (p.short_ref) {
      p.frame_num_wrap = p.frame_num > cur_fn ? p.frame_num - max_fn : p.frame_num;
      st.push_back(&p);
    } else if (p.long_ref) {
      lt.push_back(&p);
    }
  }
  std::sort(lt.begin(), lt.end(),
            [](Picture* a, Picture* b) { return a->long_term_idx < b->long_term_idx; });
  std::vector<Picture*> init[2];
  if (s.sh.type == 0) {  // 8.2.4.2.1: short-term by descending PicNum, then long-term
    std::sort(st.begin(), st.end(),
              [](Picture* a, Picture* b) { return a->frame_num_wrap > b->frame_num_wrap; });
    init[0] = st;
    init[0].insert(init[0].end(), lt.begin(), lt.end());
  } else {  // 8.2.4.2.3: by POC, those before the current picture first in list 0
    std::vector<Picture*> before, after;
    for (Picture* p : st) (p->poc < d.cur.poc ? before : after).push_back(p);
    std::sort(before.begin(), before.end(), [](Picture* a, Picture* b) { return a->poc > b->poc; });
    std::sort(after.begin(), after.end(), [](Picture* a, Picture* b) { return a->poc < b->poc; });
    init[0] = before;
    init[0].insert(init[0].end(), after.begin(), after.end());
    init[1] = after;
    init[1].insert(init[1].end(), before.begin(), before.end());
    for (int l = 0; l < 2; l++) init[l].insert(init[l].end(), lt.begin(), lt.end());
    if (!lt.empty()) d.stats[kStat_long_term_in_b]++;
    if (init[1].size() > 1 && init[1] == init[0]) {
      std::swap(init[1][0], init[1][1]);
      d.stats[kStat_list1_swapped]++;
    }
  }
  for (int l = 0; l < (s.sh.type == 1 ? 2 : 1); l++) {
    std::vector<Picture*>& list = init[l];
    list.resize((size_t)s.sh.num_ref_idx_active[l], nullptr);
    if (!mods[l].empty()) {
      if (l == 1) d.stats[kStat_list1_mods]++;
      modify_ref_list(s, list, mods[l], st, lt);
    }
    s.ref_list[l] = list;
  }
}

// 8.4.2.3.1: the implicit bi-prediction weights of a B slice
void implicit_weights(SliceCtx& s) {
  Decoder& d = *s.d;
  for (size_t i = 0; i < s.ref_list[0].size(); i++)
    for (size_t j = 0; j < s.ref_list[1].size(); j++) {
      const Picture *p0 = s.ref_list[0][i], *p1 = s.ref_list[1][j];
      int w0 = 32;
      if (p0 && p1) {
        const int dsf = p1->poc == p0->poc || p0->long_ref || p1->long_ref
                            ? 1 << 10
                            : dist_scale_factor(d.cur.poc, *p0, *p1) >> 2;
        if (dsf < -64 || dsf > 128) d.stats[kStat_implicit_default_weights]++;
        else w0 = 64 - dsf;
      }
      s.implicit_w0[i][j] = (int16_t)w0;
    }
}

// 8.2.5: marking after the current picture is decoded
void mark_references(Decoder& d, const SliceHeader& h) {
  const Sps& sps = *d.cur_sps;
  Picture& cur = d.cur;
  const int max_fn = max_frame_num(sps);
  bool cur_long = false;
  if (h.idr) {
    d.dpb.clear();
    if (h.long_term_reference_flag) {
      cur_long = true;
      cur.long_term_idx = 0;
      d.max_long_term_idx = 0;
      d.stats[kStat_long_term_refs]++;
    } else {
      d.max_long_term_idx = -1;
    }
  } else if (h.adaptive_marking) {
    for (size_t i = 0; i < h.mmco.size(); i += 3) {
      const int op = h.mmco[i], a = h.mmco[i + 1], c = h.mmco[i + 2];
      d.stats[kStat_mmco1 + op - 1]++;
      auto short_with = [&](int pic_num) -> Picture* {
        for (Picture& p : d.dpb) {
          if (!p.short_ref) continue;
          const int wrap = p.frame_num > h.frame_num ? p.frame_num - max_fn : p.frame_num;
          if (wrap == pic_num) return &p;
        }
        return nullptr;
      };
      auto drop_long = [&](int idx) {
        for (Picture& p : d.dpb)
          if (p.long_ref && p.long_term_idx == idx) p.long_ref = false;
      };
      if (op == 1) {
        if (Picture* p = short_with(h.frame_num - (a + 1))) p->short_ref = false;
      } else if (op == 2) {
        drop_long(a);
      } else if (op == 3) {
        if (Picture* p = short_with(h.frame_num - (a + 1))) {
          drop_long(c);
          p->short_ref = false;
          p->long_ref = true;
          p->long_term_idx = c;
          d.stats[kStat_long_term_refs]++;
        }
      } else if (op == 4) {
        d.max_long_term_idx = a - 1;
        for (Picture& p : d.dpb)
          if (p.long_ref && p.long_term_idx > d.max_long_term_idx) p.long_ref = false;
      } else if (op == 5) {
        for (Picture& p : d.dpb) p.short_ref = p.long_ref = false;
        d.max_long_term_idx = -1;
      } else if (op == 6) {
        drop_long(c);
        cur_long = true;
        cur.long_term_idx = c;
        d.stats[kStat_long_term_refs]++;
      }
    }
  } else {  // sliding window (8.2.5.3)
    int n_short = 0, n_long = 0;
    for (Picture& p : d.dpb) n_short += p.short_ref, n_long += p.long_ref;
    if (n_short + n_long >= std::max(sps.max_num_ref_frames, 1) && n_short > 0) {
      Picture* oldest = nullptr;
      for (Picture& p : d.dpb) {
        if (!p.short_ref) continue;
        const int wrap = p.frame_num > h.frame_num ? p.frame_num - max_fn : p.frame_num;
        p.frame_num_wrap = wrap;
        if (!oldest || wrap < oldest->frame_num_wrap) oldest = &p;
      }
      oldest->short_ref = false;
      d.stats[kStat_sliding_window]++;
    }
  }
  d.dpb.erase(std::remove_if(d.dpb.begin(), d.dpb.end(),
                             [](const Picture& p) { return !p.short_ref && !p.long_ref; }),
              d.dpb.end());
  cur.short_ref = !cur_long;
  cur.long_ref = cur_long;
  int n = 0;
  for (Picture& p : d.dpb) n += p.short_ref || p.long_ref;
  if (n >= std::max(sps.max_num_ref_frames, 1) + 1)
    raise(kCorrupt, "more reference frames than max_num_ref_frames");
}

// 8.2.1: the picture order count of the current picture
int picture_order_count(Decoder& d, const SliceHeader& h) {
  const Sps& s = *d.cur_sps;
  const int max_fn = max_frame_num(s);
  d.stats[kStat_poc_type0 + s.poc_type]++;
  if (s.poc_type == 0) {
    if (h.idr) d.prev_poc_msb = d.prev_poc_lsb = 0;
    const int max_lsb = 1 << s.log2_max_poc_lsb;
    int msb = d.prev_poc_msb;
    if (h.poc_lsb < d.prev_poc_lsb && d.prev_poc_lsb - h.poc_lsb >= max_lsb / 2) msb += max_lsb;
    else if (h.poc_lsb > d.prev_poc_lsb && h.poc_lsb - d.prev_poc_lsb > max_lsb / 2) msb -= max_lsb;
    const int top = msb + h.poc_lsb, bottom = top + h.delta_poc_bottom;
    if (h.nal_ref_idc) {
      d.prev_poc_msb = msb;
      d.prev_poc_lsb = h.poc_lsb;
    }
    return std::min(top, bottom);
  }
  int offset = 0;
  if (!h.idr) {
    offset = d.prev_mmco5 ? 0 : d.prev_frame_num_offset;
    if (d.prev_frame_num > h.frame_num) offset += max_fn;
  }
  int top, bottom;
  if (s.poc_type == 1) {
    const int cycle = (int)s.offset_for_ref_frame.size();
    int abs_fn = cycle ? offset + h.frame_num : 0;
    if (!h.nal_ref_idc && abs_fn > 0) abs_fn--;
    int expected = 0;
    if (abs_fn > 0) {
      int per_cycle = 0;
      for (int v : s.offset_for_ref_frame) per_cycle += v;
      const int cnt = (abs_fn - 1) / cycle, in_cycle = (abs_fn - 1) % cycle;
      expected = cnt * per_cycle;
      for (int i = 0; i <= in_cycle; i++) expected += s.offset_for_ref_frame[(size_t)i];
    }
    if (!h.nal_ref_idc) expected += s.offset_for_non_ref_pic;
    top = expected + h.delta_poc[0];
    bottom = top + s.offset_for_top_to_bottom_field + h.delta_poc[1];
  } else {
    top = bottom = h.idr ? 0 : h.nal_ref_idc ? 2 * (offset + h.frame_num)
                                             : 2 * (offset + h.frame_num) - 1;
  }
  d.prev_frame_num_offset = offset;
  return std::min(top, bottom);
}

bool has_mmco5(const SliceHeader& h) {
  for (size_t i = 0; i < h.mmco.size(); i += 3)
    if (h.mmco[i] == 5) return true;
  return false;
}

// ----------------------------------------------------------- access units

struct Nal {
  const uint8_t* p;
  size_t n;
};

void split_nals(const uint8_t* p, size_t n, std::vector<Nal>& out) {  // Annex B
  out.clear();
  size_t i = 0, start = SIZE_MAX;
  while (i + 2 < n) {
    if (p[i] == 0 && p[i + 1] == 0 && p[i + 2] == 1) {
      if (start != SIZE_MAX) {
        size_t e = i;
        while (e > start && p[e - 1] == 0) e--;
        out.push_back({p + start, e - start});
      }
      i += 3;
      start = i;
    } else {
      i++;
    }
  }
  if (start != SIZE_MAX && start < n) out.push_back({p + start, n - start});
}

struct Pictures {
  std::vector<SliceHeader> headers;
  std::vector<const Pps*> pps;
  std::vector<std::unique_ptr<Dequant>> dequant;  // by PPS id, made at first use
};

// Decode one access unit (one packet: one picture). Returns false where
// the picture is a non-reference one that is not wanted (skipped after
// its header).
bool decode_access_unit(Decoder& d, const uint8_t* p, size_t n, bool wanted, Pictures& work,
                        Bits& b, std::vector<Nal>& nals) {
  split_nals(p, n, nals);
  bool started = false;
  int slice_num = 0;
  work.headers.clear();
  work.pps.clear();
  std::vector<ListMod> mods[2];
  for (const Nal& nal : nals) {
    if (nal.n == 0) continue;
    if (nal.p[0] & 0x80) raise(kCorrupt, "forbidden_zero_bit set");
    const int type = nal.p[0] & 31, ref_idc = (nal.p[0] >> 5) & 3;
    if (type == 7 || type == 8) {
      b.load(nal.p + 1, nal.n - 1);
      if (type == 7) {
        parse_sps(d, b);
      } else {
        parse_pps(d, b);
        for (auto& q : work.dequant) q.reset();  // a PPS may be replaced
      }
      continue;
    }
    if (type >= 2 && type <= 4) raise(kUnsupported, "H.264 data partitioning (NAL type 2-4)");
    if (type != 1 && type != 5) continue;  // SEI, AUD, filler, end of sequence, ...
    b.load(nal.p + 1, nal.n - 1);
    SliceHeader h;
    slice_header(d, b, type, ref_idc, h, mods);
    const Pps& pps = d.pps[h.pps_id];
    const Sps& sps = d.sps[pps.sps_id];
    if (!started) {
      started = true;
      if (h.idr) d.reset();
      else if (!d.have_prev)  // a sync sample that is a recovery point (x264's open_gop)
        raise(kUnsupported, "H.264 open GOP: the stream opens on a picture that is not an "
                            "IDR picture");
      if (d.cur_sps != &sps || d.cur.width != sps.mb_width * 16 ||
          d.cur.height != sps.mb_height * 16) {
        if (!h.idr) raise(kCorrupt, "the picture size changes without an IDR picture");
        d.cur_sps = &sps;
      }
      if (!h.idr && h.frame_num != d.prev_ref_frame_num &&
          h.frame_num != (d.prev_ref_frame_num + 1) % max_frame_num(sps))
        raise(kUnsupported, "H.264 gaps in frame_num (gaps_in_frame_num_value_allowed_flag)");
      d.cur.poc = picture_order_count(d, h);
      d.prev_frame_num = h.frame_num;
      d.stats[kStat_pictures]++;
      if (h.idr) d.stats[kStat_idr_pictures]++;
      if (!ref_idc) d.stats[kStat_non_ref_pictures]++;
      if (pps.constrained_intra_pred) d.stats[kStat_cip_pictures]++;
      if (pps.transform_8x8_mode) d.stats[kStat_transform_8x8_pps]++;
      if (pps.chroma_qp_offset[0]) d.stats[kStat_chroma_qp_offset]++;
      if (pps.chroma_qp_offset[1] != pps.chroma_qp_offset[0])
        d.stats[kStat_second_chroma_qp_offset]++;
      if (!ref_idc && !wanted) {  // nothing reads it
        d.stats[kStat_non_ref_skipped]++;
        d.prev_mmco5 = false;
        return false;
      }
      if (h.type == 1 && ref_idc) d.stats[kStat_b_ref_pictures]++;
      Picture& c = d.cur;
      c.width = sps.mb_width * 16;
      c.height = sps.mb_height * 16;
      c.y.assign((size_t)c.width * c.height, 0);
      c.u.assign((size_t)c.width * c.height / 4, 0);
      c.v.assign((size_t)c.width * c.height / 4, 0);
      c.id = d.next_id++;
      c.frame_num = h.frame_num;
      c.short_ref = c.long_ref = false;
      d.mbs.assign((size_t)sps.mb_width * sps.mb_height, MbInfo());
    } else if (&sps != d.cur_sps || h.frame_num != d.cur.frame_num ||
               h.idr != work.headers[0].idr) {
      raise(kCorrupt, "slices of one picture disagree");
    }
    d.stats[kStat_slices]++;
    d.stats[kStat_deblock_idc0 + h.disable_deblocking]++;
    if (h.filter_offset_a || h.filter_offset_b) d.stats[kStat_deblock_offsets]++;
    if (work.dequant.size() < 256) work.dequant.resize(256);
    auto& dq = work.dequant[(size_t)h.pps_id];
    if (!dq) {
      dq.reset(new Dequant());
      make_dequant(pps, *dq);
    }
    SliceCtx s;
    s.d = &d;
    s.sps = &sps;
    s.pps = &pps;
    s.sh = h;
    s.slice_num = slice_num++;
    s.dq4 = dq->dq4;
    s.dq8 = dq->dq8;
    if (h.type != 2) init_ref_lists(s, mods);
    if (h.type == 1) {
      d.stats[kStat_b_slices]++;
      if (pps.weighted_bipred_idc == 2) {
        d.stats[kStat_weighted_bipred_implicit]++;
        implicit_weights(s);
      }
    }
    slice_data(s, b);
    work.headers.push_back(s.sh);
    work.pps.push_back(&pps);
  }
  if (!started) raise(kCorrupt, "a packet without a picture");
  if (slice_num > 1) d.stats[kStat_multi_slice_pictures]++;
  for (const MbInfo& m : d.mbs)
    if (m.slice < 0) raise(kCorrupt, "a picture with macroblocks no slice covers");
  deblock_picture(d, work.headers, work.pps);
  const SliceHeader& h = work.headers[0];
  if (h.nal_ref_idc) {
    mark_references(d, h);
    d.dpb.push_back(d.cur);
    d.dpb.back().motion.swap(d.mbs);  // for temporal direct; mbs is made anew per picture
  }
  d.prev_mmco5 = has_mmco5(h);
  if (h.nal_ref_idc) d.prev_ref_frame_num = d.prev_mmco5 ? 0 : h.frame_num;
  if (d.prev_mmco5) {  // 8.2.1: the picture counts as frame_num 0, POC 0 after it
    d.prev_frame_num = 0;
    d.prev_poc_msb = d.prev_poc_lsb = 0;
  }
  d.have_prev = true;
  return true;
}

void write_nv12(const Decoder& d, int width, int height, uint8_t* out) {
  const Picture& p = d.cur;
  const Sps& s = *d.cur_sps;
  const int x0 = s.crop_left, y0 = s.crop_top;
  for (int y = 0; y < height; y++)
    std::memcpy(out + (size_t)y * width, p.y.data() + (size_t)(y0 + y) * p.width + x0,
                (size_t)width);
  const int cw = p.width / 2;
  uint8_t* uv = out + (size_t)width * height;
  for (int y = 0; y < height / 2; y++) {
    const uint8_t* u = p.u.data() + (size_t)(y0 / 2 + y) * cw + x0 / 2;
    const uint8_t* v = p.v.data() + (size_t)(y0 / 2 + y) * cw + x0 / 2;
    uint8_t* row = uv + (size_t)y * width;
    for (int x = 0; x < width / 2; x++) {
      row[2 * x] = u[x];
      row[2 * x + 1] = v[x];
    }
  }
}

}  // namespace

int decode_plan(Decoder& d, const H264Plan& p, int width, int height, uint8_t* out,
                std::string& err) {
  try {
    Pictures work;
    Bits b;
    std::vector<Nal> nals;
    const size_t frame = (size_t)width * height * 3 / 2;
    std::vector<char> done(p.wanted.size(), 0);
    size_t pkt = 0;
    for (size_t seg = 0; seg < p.seg_end.size(); seg++) {
      d.reset();
      d.cur_sps = nullptr;
      d.cur.width = d.cur.height = 0;
      for (; pkt < (size_t)p.seg_end[seg]; pkt++) {
        const int64_t b0 = pkt ? p.pkt_end[pkt - 1] : 0, b1 = p.pkt_end[pkt];
        const int64_t ts = p.pkt_ts[pkt];
        auto it = std::lower_bound(p.wanted.begin(), p.wanted.end(), ts);
        const bool wanted = it != p.wanted.end() && *it == ts;
        if (!decode_access_unit(d, p.bytes.data() + b0, (size_t)(b1 - b0), wanted, work, b, nals))
          continue;
        if (!wanted) continue;
        const Sps& s = *d.cur_sps;
        if (d.cur.width - s.crop_left - s.crop_right != width ||
            d.cur.height - s.crop_top - s.crop_bottom != height)
          raise(kCorrupt, "the SPS's cropped size disagrees with the container's");
        const size_t k = (size_t)(it - p.wanted.begin());
        write_nv12(d, width, height, out + k * frame);
        done[k] = 1;
      }
    }
    for (char c : done)
      if (!c) raise(kCorrupt, "a wanted frame was not decoded");
    return 0;
  } catch (const Error& e) {
    err = e.msg;
    return e.code;
  }
}

int read_syntax(int kind, const uint8_t* data, size_t n_bytes, int arg, int n, int32_t* out,
                std::string& err) {
  try {
    Bits b;
    b.buf.assign(data, data + n_bytes);
    b.end = n_bytes * 8;
    b.buf.resize(n_bytes + 8, 0);
    if (kind == 0 || kind == 1) {
      for (int i = 0; i < n; i++) out[i] = kind == 0 ? (int32_t)b.ue() : b.se();
    } else if (kind == 3 || kind == 4) {
      cabac_table_rows(kind, arg, n, out);
    } else {
      int64_t stats[kStatCount] = {};
      out[n] = residual_block(b, arg, n, out, stats);
    }
    return (int)b.pos;
  } catch (const Error& e) {
    err = e.msg;
    return e.code;
  }
}

}  // namespace h264
}  // namespace oatxt
