// h264.h — the port's first-party H.264 decoder (CAVLC and CABAC; I, P and
// B slices).
//
// oatx decodes H.264 on the host through FFmpeg (oatx/native/oatx_decode.cpp:
// decode_seek_stepping over avcodec_send_packet / avcodec_receive_frame).
// The port decodes it on the host too, written from ITU-T H.264 (clause 7
// syntax, clause 8 decoding, clause 9 parsing): progressive 8-bit 4:2:0,
// CAVLC or CABAC, I, P and B slices, with every tool x264 writes — I_NxN
// (4×4 and 8×8 transform), I16x16, I_PCM, every P and B partition and
// sub-partition, P_Skip, B_Skip, spatial and temporal direct prediction,
// several reference frames in both lists with list modification, explicit
// and implicit weighted prediction, scaling matrices, several slices per
// picture and the deblocking filter. The decoder's output is exact (the
// standard specifies every sample), so its pictures equal FFmpeg's bit for
// bit.
//
// Refused with kUnsupported naming the tool: FMO, redundant pictures,
// SP / SI slices, data partitioning, gaps in frame_num, lossless transform
// bypass, interlace (field pictures, MBAFF), a stream that opens on a
// picture other than an IDR one (open GOP), cabac_init_idc 1 with the 8×8
// transform (h264_cabac.cpp lacks that column of ctxIdx 399-435) and any
// format but 8-bit 4:2:0.
//
// Design as decode.cpp: no global state but constant tables, one decoder
// per handle, errors as return codes with a message (thrown inside, caught at
// the C entry).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "mp4.h"

namespace oatxt {
namespace h264 {

constexpr int kCorrupt = -2;
constexpr int kUnsupported = -3;

struct Error {
  int code;
  std::string msg;
};
[[noreturn]] void raise(int code, const std::string& msg);

// Counters of the tools a decode met (oatxt_h264_stats: the census of
// what the fixtures exercise). Names in kStatNames, same order.
#define OATXT_H264_STATS(X)                                                              \
  X(pictures) X(idr_pictures) X(slices) X(multi_slice_pictures) X(non_ref_pictures)      \
  X(poc_type0) X(poc_type1) X(poc_type2)                                                 \
  X(mb_i4x4) X(mb_i8x8) X(mb_i16x16) X(mb_pcm) X(mb_p16x16) X(mb_p16x8) X(mb_p8x16)     \
  X(mb_p8x8) X(mb_p8x8ref0) X(mb_pskip) X(sub_8x8) X(sub_8x4) X(sub_4x8) X(sub_4x4)      \
  X(intra_in_p) X(inter_t8x8) X(i4x4_mode0) X(i4x4_mode1) X(i4x4_mode2) X(i4x4_mode3)    \
  X(i4x4_mode4) X(i4x4_mode5) X(i4x4_mode6) X(i4x4_mode7) X(i4x4_mode8)                  \
  X(i8x8_mode0) X(i8x8_mode1) X(i8x8_mode2) X(i8x8_mode3) X(i8x8_mode4) X(i8x8_mode5)    \
  X(i8x8_mode6) X(i8x8_mode7) X(i8x8_mode8) X(i16_mode0) X(i16_mode1) X(i16_mode2)       \
  X(i16_mode3) X(chroma_mode0) X(chroma_mode1) X(chroma_mode2) X(chroma_mode3)           \
  X(top_right_substituted) X(cip_neighbour_refused) X(cip_pictures)                       \
  X(ref_idx_nonzero) X(list_mod_idc0) X(list_mod_idc1) X(list_mod_idc2)                   \
  X(weighted_slices) X(weighted_luma_refs) X(weighted_chroma_refs) X(weighted_blocks)    \
  X(pskip_zero_mv) X(pskip_pred_mv) X(mv_dir_16x8) X(mv_dir_8x16) X(mv_c_from_d)          \
  X(luma_qpel) X(luma_center_j) X(chroma_frac) X(ref_outside_picture)                    \
  X(mmco1) X(mmco2) X(mmco3) X(mmco4) X(mmco5) X(mmco6) X(long_term_refs)                \
  X(sliding_window) X(sps_scaling_matrix) X(pps_scaling_matrix) X(scaling_fallback_a)    \
  X(scaling_fallback_b) X(scaling_use_default) X(scaling_explicit) X(transform_8x8_pps)  \
  X(chroma_qp_offset) X(second_chroma_qp_offset) X(qp_delta_wrap)                        \
  X(nc_chroma_dc) X(nc_0_2) X(nc_2_4) X(nc_4_8) X(nc_8_up) X(level_prefix_14)            \
  X(level_prefix_15) X(level_prefix_16)                                                  \
  X(deblock_idc0) X(deblock_idc1) X(deblock_idc2) X(deblock_offsets) X(slice_edge_kept)  \
  X(bs1) X(bs2) X(bs3) X(bs4) X(bs2_8x8)                                                 \
  X(cabac_slices) X(cabac_init_idc0) X(cabac_init_idc1) X(cabac_init_idc2)               \
  X(cabac_pcm) X(cabac_mvd_suffix) X(cabac_level_suffix) X(cabac_qp_delta_nonzero)        \
  X(b_slices) X(b_ref_pictures) X(non_ref_skipped) X(mb_bskip) X(mb_bdirect16x16)        \
  X(mb_b16x16) X(mb_b16x8) X(mb_b8x16) X(mb_b8x8) X(intra_in_b) X(part_l0) X(part_l1)     \
  X(part_bi) X(sub_bdirect) X(sub_b8x8) X(sub_b8x4) X(sub_b4x8) X(sub_b4x4)              \
  X(direct_spatial) X(direct_temporal) X(direct_8x8_inference) X(direct_4x4)             \
  X(direct_col_zero) X(direct_zero_refs) X(direct_col_intra) X(direct_long_term)         \
  X(direct_td_zero) X(list1_swapped) X(list1_mods) X(long_term_in_b)                     \
  X(weighted_bipred_explicit) X(weighted_bipred_implicit) X(implicit_default_weights)   \
  X(bipred_blocks) X(bs_two_refs) X(bs_same_two_refs) X(bs_mv_count_differs)

enum Stat : int {
#define OATXT_STAT_ENUM(name) kStat_##name,
  OATXT_H264_STATS(OATXT_STAT_ENUM)
#undef OATXT_STAT_ENUM
  kStatCount
};
extern const char* const kStatNames[kStatCount];

struct Sps {
  bool valid = false;
  int profile_idc = 0;
  int chroma_format_idc = 1;
  int log2_max_frame_num = 4;
  int poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0;
  int mb_width = 0, mb_height = 0;
  bool direct_8x8_inference = false;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // luma samples
  bool scaling_matrix_present = false;
  uint8_t scaling4[6][16];  // zigzag order
  uint8_t scaling8[2][64];
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool cabac = false;
  bool bottom_field_pic_order_present = false;
  int num_ref_idx_default[2] = {1, 1};  // of lists 0 and 1
  bool weighted_pred = false;
  int weighted_bipred_idc = 0;
  int pic_init_qp = 26;
  int chroma_qp_offset[2] = {0, 0};
  bool deblocking_filter_control_present = false;
  bool constrained_intra_pred = false;
  bool transform_8x8_mode = false;
  bool scaling_matrix_present = false;
  uint8_t scaling4[6][16];
  uint8_t scaling8[2][64];
};

enum MbKind : int8_t {
  kI4x4, kI8x8, kI16x16, kIPCM,  // intra
  kP16x16, kP16x8, kP8x16, kP8x8, kP8x8ref0, kPSkip,
  kBDirect16x16, kB16x16, kB16x8, kB8x16, kB8x8, kBSkip
};
inline bool is_intra(int k) { return k <= kIPCM; }
inline bool is_skip(int k) { return k == kPSkip || k == kBSkip; }

// What later macroblocks, the deblocking filter and (through the picture's
// motion field) temporal direct prediction read of a macroblock. 4×4
// blocks are indexed in raster order (x / 4 + 4 · (y / 4)); lists 0 and 1.
struct MbInfo {
  int slice = -1;  // slice number within the picture; -1 not decoded
  int8_t kind = kI16x16;
  bool t8x8 = false;
  int8_t qp_filter = 0;      // QP_Y for deblocking (0 for I_PCM)
  int8_t intra4[16];         // Intra4x4 / Intra8x8 modes per 4×4; -1 none
  uint8_t nc[16 + 8];        // TotalCoeff of luma 4×4, Cb 4×4 (16..19), Cr (20..23)
  uint8_t cbf_dc = 0;        // CABAC coded_block_flag of the DC blocks: 1 luma, 2 Cb, 4 Cr
  uint8_t cbp = 0;           // coded_block_pattern: luma bits 0-3, chroma · 16
  int8_t chroma_mode = 0;    // intra_chroma_pred_mode (0 for inter)
  uint8_t direct = 0;        // 8×8 blocks predicted in direct mode, a bit each
  uint16_t nz_filter = 0;    // luma 4×4 blocks with coefficients, as bS 2 reads them
  int8_t ref[2][4];          // refIdxL0 / L1 per 8×8 (-1: intra or that list unused)
  int ref_pic[2][4];         // that reference's Picture::id (-1)
  int16_t mv[2][16][2];
  uint8_t mvd[2][16][2];     // |mvd| per 4×4, up to 64 (CABAC's ctxIdxInc)
};

// A decoded frame at the coded size (whole macroblocks), planes unpadded.
struct Picture {
  int id = -1;  // unique per decoder: what deblocking and direct prediction compare
  int width = 0, height = 0;
  std::vector<uint8_t> y, u, v;
  int frame_num = 0, frame_num_wrap = 0, long_term_idx = 0;
  bool short_ref = false, long_ref = false;
  int poc = 0;
  std::vector<MbInfo> motion;  // its macroblocks, kept for temporal direct (8.4.1.2.3)
};

struct PredWeight {  // pred_weight_table (7.3.3.2), lists 0 and 1
  int luma_log2 = 0, chroma_log2 = 0;
  int luma_w[2][32], luma_o[2][32];
  int chroma_w[2][32][2], chroma_o[2][32][2];
};

struct SliceHeader {
  int first_mb = 0;
  int type = 0;  // 0 P, 1 B, 2 I
  int pps_id = 0;
  int frame_num = 0;
  bool idr = false;
  int nal_ref_idc = 0;
  int poc_lsb = 0, delta_poc_bottom = 0, delta_poc[2] = {0, 0};
  bool direct_spatial = false;
  int num_ref_idx_active[2] = {0, 0};
  int cabac_init_idc = 0;
  bool long_term_reference_flag = false;
  bool adaptive_marking = false;
  std::vector<int> mmco;  // (op, a, b) triples
  int qp = 26;
  int disable_deblocking = 0;
  int filter_offset_a = 0, filter_offset_b = 0;
  PredWeight pw;
};

// The per-handle decoder; everything lives here.
struct Decoder {
  Sps sps[32];
  Pps pps[256];
  const Sps* cur_sps = nullptr;
  std::vector<Picture> dpb;  // reference frames (short and long term)
  Picture cur;
  std::vector<MbInfo> mbs;
  int next_id = 0;
  int max_long_term_idx = -1;  // "no long-term frame indices"
  // POC state
  int prev_poc_msb = 0, prev_poc_lsb = 0, prev_frame_num = 0, prev_frame_num_offset = 0;
  int prev_ref_frame_num = 0;
  bool prev_mmco5 = false;
  bool have_prev = false;
  int64_t stats[kStatCount];

  Decoder();
  void reset();
};

// Decode plan `p` (mp4.h) and write the picture of each wanted display index
// wanted[k], cropped to width × height, as NV12 (height · 3 / 2 rows of
// width bytes) at out + k · width · height · 3 / 2. Returns 0 or a negative
// code with a message in err.
int decode_plan(Decoder& d, const H264Plan& p, int width, int height, uint8_t* out,
                std::string& err);

// The parsing primitives on their own (the tests' spot checks of the code
// tables): kind 0 reads n ue(v), 1 n se(v), 2 one CAVLC residual block with
// nC = arg and maxNumCoeff = n (its levels into out[0..n), TotalCoeff into
// out[n]). Kind 3 replaces each ctxIdx out[0..n) by its CABAC context state
// 2 · pStateIdx + valMPS after the initialisation (9.3.1.1) of slice kind
// arg / 64 (0 I, 1-3 cabac_init_idc 0-2) at SliceQPY arg % 64 (-1 where the
// kind has no such context); kind 4 replaces each pStateIdx out[0..n) by
// its rangeTabLPS row (four bytes, qCodIRangeIdx 0 the highest) and writes
// transIdxLPS into out[n..2n). Returns the bits read, or a negative code.
int read_syntax(int kind, const uint8_t* data, size_t n_bytes, int arg, int n, int32_t* out,
                std::string& err);

// ---------------------------------------------------------------- internals

// The working state of one slice (h264_slice.cpp parses, h264_recon.cpp
// reconstructs and filters).
struct SliceCtx {
  Decoder* d;
  const Sps* sps;
  const Pps* pps;
  SliceHeader sh;
  int slice_num = 0;
  std::vector<Picture*> ref_list[2];  // RefPicList0, RefPicList1
  // implicit bi-prediction weights w0 by (refIdxL0, refIdxL1) (8.4.2.3.1; w1 = 64 - w0)
  int16_t implicit_w0[32][32];
  // the dequantization tables of the PPS: [list][qp][zigzag position]
  const int32_t (*dq4)[52][16];
  const int32_t (*dq8)[52][64];
};

// CABAC (9.3, h264_cabac.cpp): the arithmetic decoding engine over one
// slice's data and its context variables, and the binarizations of the
// syntax elements. Context index increments that read neighbouring
// macroblocks come from the caller.
struct Cabac {
  static constexpr int kContexts = 460;
  const uint8_t* buf = nullptr;
  size_t pos = 0, end = 0;  // bit position in buf, and buf's length in bits
  uint32_t range = 0, offset = 0;
  uint8_t state[kContexts];  // pStateIdx · 2 + valMPS
  int64_t* stats = nullptr;  // the decoder's counters, when given

  void init_contexts(int slice_type, int cabac_init_idc, int slice_qp);
  void start(const uint8_t* data, size_t bit_pos, size_t end_bits);
  int decision(int ctx);
  int bypass();
  int terminate();
  uint32_t read(int n);

  int skip_flag(bool b_slice, int inc);
  int mb_type_i(int offset, int inc0);  // I numbering: 0 I_NxN, 1-24 I_16x16, 25 I_PCM
  int mb_type_p();                      // 0-4, 5 + the I numbering for intra
  int mb_type_b(int inc0);              // 0-22, 23 + the I numbering for intra
  int sub_mb_type_p();
  int sub_mb_type_b();
  int ref_idx(int inc0, int max);
  int mvd(int comp, int abs_sum);
  int qp_delta(bool prev_nonzero);
  int chroma_pred_mode(int inc0);
  int intra_mode();  // -1: the predicted mode; else rem_intra*_pred_mode
  int cbp(const int cond_a[4], const int cond_b[4], int chroma_a, int chroma_b, int chroma2_a,
          int chroma2_b);
  int transform_8x8(int inc);
  int residual(int cat, int cbf_inc, int max, int32_t* level);
};
void cabac_table_rows(int kind, int arg, int n, int32_t* out);

// h264_recon.cpp
void intra_pred_4x4(SliceCtx& s, int mbx, int mby, int blk, int mode);
void intra_pred_8x8(SliceCtx& s, int mbx, int mby, int b8, int mode);
void intra_pred_16x16(SliceCtx& s, int mbx, int mby, int mode);
void intra_pred_chroma(SliceCtx& s, int mbx, int mby, int mode);
void inter_pred(SliceCtx& s, int mbx, int mby, const MbInfo& mb);
void add_residual_4x4(uint8_t* dst, int stride, int32_t* d);
void add_residual_8x8(uint8_t* dst, int stride, int32_t* d);
void deblock_picture(Decoder& d, const std::vector<SliceHeader>& slices,
                     const std::vector<const Pps*>& slice_pps);
// whether intra prediction may read macroblock (mbx, mby) from the current one
bool intra_avail(SliceCtx& s, int mbx, int mby);

extern const uint8_t kZigzag4[16];
extern const uint8_t kZigzag8[64];
extern const uint8_t kBlkX[16], kBlkY[16];  // luma4x4BlkIdx → position in the macroblock
int chroma_qp(int qp, int offset);

}  // namespace h264
}  // namespace oatxt
