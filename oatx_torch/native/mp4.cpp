// mp4.cpp — see mp4.h. Built into the same library as decode.cpp.
//
// The box walk follows ISO/IEC 14496-12: top-level boxes by offset (32-bit
// sizes, 64-bit `size == 1`, `size == 0` to the end of the file, `moov`
// before or after `mdat`), then `moov` in memory: the first track whose
// handler is 'vide', its `mdhd` timescale, `edts/elst`, and the sample
// tables (`stsd` with `avc1` / `avc3` and `avcC`, `stts`, `ctts` v0/v1,
// `stss`, `stsc`, `stsz`, `stco` / `co64`). The frame count is the sample
// count (FFmpeg's nb_frames) and the frame rate FFmpeg's avg_frame_rate:
// timescale × samples / the sum of the `stts` durations. A frame's index is
// its rank in composition order, which for constant-rate closed-GOP streams
// is oatx's round(pts · fps) (oatx_decode.cpp, decode_seek_stepping).

#include "mp4.h"

#include <algorithm>
#include <numeric>

namespace oatxt {
namespace {

inline uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
inline uint64_t be64(const uint8_t* p) { return (uint64_t)be32(p) << 32 | be32(p + 4); }
inline uint32_t cc(const char* s) { return be32((const uint8_t*)s); }

std::string fourcc_str(uint32_t t) {
  std::string s;
  for (int k = 3; k >= 0; k--) {
    char c = (char)(t >> (8 * k));
    s += (c >= 32 && c < 127) ? c : '?';
  }
  return s;
}

struct Span {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  size_t size() const { return (size_t)(end - p); }
  bool empty() const { return p == nullptr; }
};

// the first child box of `type` inside `in` (a sequence of boxes)
Span child(Span in, uint32_t type) {
  const uint8_t* p = in.p;
  while (p && p + 8 <= in.end) {
    uint64_t size = be32(p);
    size_t hdr = 8;
    if (size == 1) {
      if (p + 16 > in.end) break;
      size = be64(p + 8);
      hdr = 16;
    } else if (size == 0) {
      size = (uint64_t)(in.end - p);
    }
    if (size < hdr || size > (uint64_t)(in.end - p)) break;
    if (be32(p + 4) == type) return {p + hdr, p + size};
    p += size;
  }
  return {};
}

Span path(Span in, std::initializer_list<const char*> types) {
  for (const char* t : types) {
    if (in.empty()) return in;
    in = child(in, cc(t));
  }
  return in;
}

// the H.264 RBSP bit reader (emulation prevention bytes removed first)
struct Bits {
  std::vector<uint8_t> b;
  size_t pos = 0;
  bool over = false;
  explicit Bits(const std::vector<uint8_t>& nal) {
    int zeros = 0;
    for (uint8_t c : nal) {  // 00 00 03 → 00 00
      if (zeros >= 2 && c == 3) {
        zeros = 0;
        continue;
      }
      b.push_back(c);
      zeros = c == 0 ? zeros + 1 : 0;
    }
  }
  uint32_t u(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      if (pos >= b.size() * 8) {
        over = true;
        return v;
      }
      v = v << 1 | ((b[pos >> 3] >> (7 - (pos & 7))) & 1);
      pos++;
    }
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (u(1) == 0 && !over && zeros < 32) zeros++;
    if (zeros >= 32) {
      over = true;
      return 0;
    }
    return ((1u << zeros) - 1) + u(zeros);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
};

const char* profile_name(int p) {
  switch (p) {
    case 66: return "Baseline";
    case 77: return "Main";
    case 88: return "Extended";
    case 100: return "High";
    case 110: return "High 10";
    case 122: return "High 4:2:2";
    case 244: return "High 4:4:4 Predictive";
    case 44: return "CAVLC 4:4:4 Intra";
    case 83: case 86: return "Scalable (SVC)";
    case 118: case 128: case 134: return "Multiview (MVC)";
    default: return "unknown";
  }
}

// seq_parameter_set_rbsp up to the VUI's video_full_range_flag (H.264 7.3.2.1.1, E.1.1)
int parse_sps(const std::vector<uint8_t>& nal, H264Track& t, std::string& err) {
  if (nal.size() < 4 || (nal[0] & 0x1F) != 7) {
    err = "avcC holds no sequence parameter set";
    return kMp4Corrupt;
  }
  Bits r(nal);
  r.u(8);  // NAL header
  const int profile = (int)r.u(8);
  r.u(8);  // constraint flags
  r.u(8);  // level
  r.ue();  // seq_parameter_set_id
  int chroma = 1, depth_y = 8, depth_c = 8, frame_mbs_only = 1;
  if (profile == 100 || profile == 110 || profile == 122 || profile == 244 || profile == 44 ||
      profile == 83 || profile == 86 || profile == 118 || profile == 128 || profile == 138 ||
      profile == 139 || profile == 134 || profile == 135) {
    chroma = (int)r.ue();
    if (chroma == 3) r.u(1);  // separate_colour_plane_flag
    depth_y = 8 + (int)std::min(r.ue(), 64u);
    depth_c = 8 + (int)std::min(r.ue(), 64u);
    r.u(1);  // qpprime_y_zero_transform_bypass_flag
    if (r.u(1)) {  // seq_scaling_matrix_present_flag: skip the lists
      for (int i = 0; i < (chroma != 3 ? 8 : 12); i++) {
        if (!r.u(1)) continue;
        const int n = i < 6 ? 16 : 64;
        int last = 8, next = 8;
        for (int j = 0; j < n && !r.over; j++) {
          if (next != 0) next = (last + r.se() + 256) % 256;
          last = next == 0 ? last : next;
        }
      }
    }
  }
  r.ue();  // log2_max_frame_num_minus4
  const uint32_t poc_type = r.ue();
  if (poc_type == 0) {
    r.ue();
  } else if (poc_type == 1) {
    r.u(1);
    r.se();
    r.se();
    const uint32_t cycle = r.ue();
    for (uint32_t i = 0; i < cycle && i < 256 && !r.over; i++) r.se();
  }
  r.ue();  // max_num_ref_frames
  r.u(1);  // gaps_in_frame_num_value_allowed_flag
  const uint32_t mbs_w = r.ue() + 1, map_h = r.ue() + 1;
  frame_mbs_only = (int)r.u(1);
  if (!frame_mbs_only) r.u(1);  // mb_adaptive_frame_field_flag
  r.u(1);  // direct_8x8_inference_flag
  uint32_t crop[4] = {0, 0, 0, 0};  // left, right, top, bottom
  if (r.u(1))
    for (auto& c : crop) c = r.ue();
  bool full_range = false;
  if (r.u(1)) {  // vui_parameters_present_flag
    if (r.u(1) && r.u(8) == 255) r.u(32);  // aspect_ratio_idc, Extended_SAR
    if (r.u(1)) r.u(1);                    // overscan
    if (r.u(1)) {                          // video_signal_type_present_flag
      r.u(3);
      full_range = r.u(1) != 0;
    }
  }
  if (r.over || mbs_w > 1024 || map_h > 1024 || *std::max_element(crop, crop + 4) > 8192) {
    err = "truncated or malformed sequence parameter set";
    return kMp4Corrupt;
  }
  t.profile_idc = profile;
  const std::string name = std::string("H.264 ") + profile_name(profile) + " profile (" +
                           std::to_string(profile) + ")";
  if (chroma != 1) {
    const char* fmt[] = {"4:0:0", "4:2:0", "4:2:2", "4:4:4"};
    err = name + " at chroma " + fmt[chroma & 3] + ": the port reads 8-bit 4:2:0 only";
    return kMp4Unsupported;
  }
  if (depth_y != 8 || depth_c != 8) {
    err = name + " at " + std::to_string(depth_y) + " bits: the port reads 8-bit 4:2:0 only";
    return kMp4Unsupported;
  }
  if (!frame_mbs_only) {
    err = "interlaced " + name + " (field or MBAFF coding) is not read";
    return kMp4Unsupported;
  }
  t.coded_width = (int)mbs_w * 16;
  t.coded_height = (int)map_h * 16;
  t.width = t.coded_width - 2 * (int)(crop[0] + crop[1]);   // 4:2:0: CropUnitX = 2
  t.height = t.coded_height - 2 * (int)(crop[2] + crop[3]);  // CropUnitY = 2 (frames)
  if (t.width <= 0 || t.height <= 0) {
    err = "the sequence parameter set crops the picture away";
    return kMp4Corrupt;
  }
  t.full_range = full_range;
  return 0;
}

std::string codec_name(uint32_t type) {
  switch (type) {
    case 0x6d703476: return "MPEG-4 Part 2 (mp4v)";
    case 0x68766331: case 0x68657631: return "HEVC (" + fourcc_str(type) + ")";
    case 0x61763031: return "AV1 (av01)";
    case 0x76703039: return "VP9 (vp09)";
    case 0x656e6376: return "encrypted video (encv)";
    default: return "'" + fourcc_str(type) + "'";
  }
}

int read_avcc(Span avcc, H264Track& t, std::string& err) {
  const uint8_t* p = avcc.p;
  if (avcc.size() < 7 || p[0] != 1) {
    err = "malformed avcC";
    return kMp4Corrupt;
  }
  t.nal_length = (p[4] & 3) + 1;
  const uint8_t* q = p + 5;
  for (int kind = 0; kind < 2; kind++) {
    if (q >= avcc.end) break;
    int n = kind == 0 ? (*q & 0x1F) : *q;
    q++;
    for (int i = 0; i < n; i++) {
      if (q + 2 > avcc.end || q + 2 + be16(q) > avcc.end) {
        err = "truncated avcC";
        return kMp4Corrupt;
      }
      const size_t len = be16(q);
      (kind == 0 ? t.sps : t.pps).emplace_back(q + 2, q + 2 + len);
      q += 2 + len;
    }
  }
  if (t.sps.empty() || t.pps.empty()) {
    err = "avcC without a sequence or picture parameter set";
    return kMp4Corrupt;
  }
  return parse_sps(t.sps[0], t, err);
}

// a full box's entry table: entry_count at body + 4, entries after it
bool table(Span box, size_t entry, size_t head, uint32_t* count, const uint8_t** first) {
  if (box.empty() || box.size() < head + 4) return false;
  *count = be32(box.p + head);
  *first = box.p + head + 4;
  return (uint64_t)*count * entry <= (uint64_t)(box.end - *first);
}

int read_track(Span trak, uint64_t file_size, H264Track& t, std::string& err) {
  auto corrupt = [&](const char* what) {
    err = std::string("mp4 sample table: ") + what;
    return kMp4Corrupt;
  };
  Span mdhd = path(trak, {"mdia", "mdhd"});
  if (mdhd.empty() || mdhd.size() < 24) return corrupt("no mdhd");
  const uint32_t timescale = mdhd.p[0] == 1 ? be32(mdhd.p + 20) : be32(mdhd.p + 12);
  if (timescale == 0) return corrupt("zero timescale");
  Span stbl = path(trak, {"mdia", "minf", "stbl"});
  if (stbl.empty()) return corrupt("no stbl");
  Span stsd = child(stbl, cc("stsd"));
  if (stsd.size() < 16) return corrupt("no stsd");
  const uint8_t* e = stsd.p + 8;
  const uint32_t esize = be32(e), etype = be32(e + 4);
  if (esize < 8 + 78 || e + esize > stsd.end) return corrupt("short sample entry");
  if (etype != cc("avc1") && etype != cc("avc3")) {
    err = "mp4 video codec " + codec_name(etype) +
          " is not read: this reader takes H.264 (avc1 / avc3) in mp4 / mov and MJPEG in AVI";
    return kMp4Unsupported;
  }
  Span avcc = child({e + 8 + 78, e + esize}, cc("avcC"));
  if (avcc.empty()) return corrupt("H.264 sample entry without avcC");
  int rc = read_avcc(avcc, t, err);
  if (rc) return rc;

  uint32_t n = 0, fixed = 0;
  const uint8_t* sz = nullptr;
  Span stsz = child(stbl, cc("stsz"));
  if (stsz.empty() || stsz.size() < 12) {
    if (!child(stbl, cc("stz2")).empty()) {
      err = "compact sample sizes (stz2) are not read";
      return kMp4Unsupported;
    }
    return corrupt("no stsz");
  }
  fixed = be32(stsz.p + 4);
  n = be32(stsz.p + 8);
  sz = stsz.p + 12;
  if (!fixed && (uint64_t)n * 4 > stsz.size() - 12) return corrupt("short stsz");
  if (n == 0) {
    err = "an mp4 with no samples in its moov (a fragmented mp4?) is not read";
    return kMp4Unsupported;
  }
  t.samples.assign(n, Mp4Sample{0, 0, 0, false});
  for (uint32_t i = 0; i < n; i++) t.samples[i].size = fixed ? fixed : be32(sz + 4 * i);

  // chunk offsets, then samples through stsc
  std::vector<uint64_t> chunks;
  uint32_t cnt;
  const uint8_t* q;
  if (table(child(stbl, cc("stco")), 4, 4, &cnt, &q)) {
    for (uint32_t i = 0; i < cnt; i++) chunks.push_back(be32(q + 4 * i));
  } else if (table(child(stbl, cc("co64")), 8, 4, &cnt, &q)) {
    for (uint32_t i = 0; i < cnt; i++) chunks.push_back(be64(q + 8 * i));
  } else {
    return corrupt("no stco / co64");
  }
  if (!table(child(stbl, cc("stsc")), 12, 4, &cnt, &q) || cnt == 0) return corrupt("no stsc");
  uint32_t s = 0;
  for (uint32_t i = 0; i < cnt && s < n; i++) {
    const uint32_t first = be32(q + 12 * i), per = be32(q + 12 * i + 4);
    const uint32_t last = i + 1 < cnt ? be32(q + 12 * (i + 1)) - 1 : (uint32_t)chunks.size();
    if (first == 0 || last > chunks.size()) return corrupt("stsc names a missing chunk");
    for (uint32_t c = first; c <= last && s < n; c++) {
      uint64_t off = chunks[c - 1];
      for (uint32_t k = 0; k < per && s < n; k++, s++) {
        t.samples[s].offset = off;
        off += t.samples[s].size;
      }
    }
  }
  if (s < n) return corrupt("stsc covers fewer samples than stsz");
  for (auto& m : t.samples)
    if (m.offset + m.size > file_size) return corrupt("a sample lies past the end of the file");

  // decode times (stts), composition offsets (ctts), the edit list's start
  if (!table(child(stbl, cc("stts")), 8, 4, &cnt, &q) || cnt == 0) return corrupt("no stts");
  int64_t dts = 0, duration = 0, counted = 0;
  uint32_t last_delta = 0;
  s = 0;
  for (uint32_t i = 0; i < cnt; i++) {
    const uint32_t count = be32(q + 8 * i), delta = be32(q + 8 * i + 4);
    duration += (int64_t)count * delta;
    counted += count;
    last_delta = delta;
    for (uint32_t k = 0; k < count && s < n; k++, s++) {
      t.samples[s].cts = dts;
      dts += delta;
    }
  }
  for (; s < n; s++) {
    t.samples[s].cts = dts;
    dts += last_delta;
  }
  if (table(child(stbl, cc("ctts")), 8, 4, &cnt, &q)) {
    s = 0;
    for (uint32_t i = 0; i < cnt && s < n; i++) {
      const uint32_t count = be32(q + 8 * i);
      const int32_t off = (int32_t)be32(q + 8 * i + 4);  // v0 and v1 alike, as FFmpeg
      for (uint32_t k = 0; k < count && s < n; k++, s++) t.samples[s].cts += off;
    }
  }
  Span elst = path(trak, {"edts", "elst"});
  uint32_t ecnt = 0;
  if (!elst.empty() && elst.size() >= 8) {
    const bool v1 = elst.p[0] == 1;
    const size_t esz = v1 ? 20 : 12;
    if (table(elst, esz, 4, &ecnt, &q)) {
      for (uint32_t i = 0; i < ecnt; i++) {
        const int64_t media = v1 ? (int64_t)be64(q + esz * i + 8) : (int32_t)be32(q + esz * i + 4);
        if (media == -1) continue;  // an empty edit: a delay, no shift of the media
        for (auto& m : t.samples) m.cts -= media;
        break;
      }
    }
  }
  if (table(child(stbl, cc("stss")), 4, 4, &cnt, &q)) {
    for (uint32_t i = 0; i < cnt; i++) {
      const uint32_t k = be32(q + 4 * i);
      if (k >= 1 && k <= n) t.samples[k - 1].sync = true;
    }
  } else {
    for (auto& m : t.samples) m.sync = true;  // no stss: every sample is a sync sample
  }

  // display order: rank by composition time, ties in decode order
  t.by_display.resize(n);
  std::iota(t.by_display.begin(), t.by_display.end(), 0);
  std::stable_sort(t.by_display.begin(), t.by_display.end(),
                   [&](int32_t a, int32_t b) { return t.samples[a].cts < t.samples[b].cts; });
  t.display.resize(n);
  for (uint32_t d = 0; d < n; d++) t.display[t.by_display[d]] = (int32_t)d;
  t.sync_at.resize(n);
  int32_t sync = 0;
  for (uint32_t i = 0; i < n; i++) {
    if (t.samples[i].sync) sync = (int32_t)i;
    t.sync_at[i] = sync;
  }
  // FFmpeg's avg_frame_rate: timescale · samples / Σ stts durations
  if (duration > 0 && counted > 0) t.fps = (double)timescale * (double)counted / (double)duration;
  return 0;
}

}  // namespace

int read_mp4(const ReadAt& read_at, uint64_t file_size, H264Track& t, std::string& err) {
  uint64_t pos = 0, moov_at = 0, moov_len = 0;
  while (pos + 8 <= file_size) {
    uint8_t h[16];
    if (!read_at(pos, h, 8)) break;
    uint64_t size = be32(h);
    uint64_t hdr = 8;
    if (size == 1) {
      if (!read_at(pos + 8, h + 8, 8)) break;
      size = be64(h + 8);
      hdr = 16;
    } else if (size == 0) {
      size = file_size - pos;
    }
    if (size < hdr) {
      err = "malformed mp4 box header";
      return kMp4Corrupt;
    }
    if (be32(h + 4) == cc("moov")) {
      moov_at = pos + hdr;
      moov_len = std::min(size, file_size - pos) - hdr;
    }
    if (size > file_size - pos) break;
    pos += size;
  }
  if (!moov_at) {
    err = "mp4 without a moov box (truncated?)";
    return kMp4Corrupt;
  }
  if (moov_len > (1u << 30)) {
    err = "mp4 moov box over 1 GiB";
    return kMp4Corrupt;
  }
  std::vector<uint8_t> moov(moov_len);
  if (!read_at(moov_at, moov.data(), moov.size())) {
    err = "truncated mp4 moov box";
    return kMp4Corrupt;
  }
  Span in{moov.data(), moov.data() + moov.size()};
  // every track, the first with a 'vide' handler
  const uint8_t* p = in.p;
  while (p + 8 <= in.end) {
    Span rest{p, in.end};
    Span trak = child(rest, cc("trak"));
    if (trak.empty()) break;
    Span hdlr = path(trak, {"mdia", "hdlr"});
    if (hdlr.size() >= 12 && be32(hdlr.p + 8) == cc("vide")) {
      return read_track(trak, file_size, t, err);
    }
    p = trak.end;
  }
  err = "mp4 without a video track";
  return kMp4Corrupt;
}

int plan_h264(const ReadAt& read_at, const H264Track& t, const std::vector<int64_t>& wanted,
              H264Plan& p, std::string& err) {
  // whether sample i opens with an IDR picture: its first slice NAL unit's type
  std::vector<uint8_t> buf;
  auto idr = [&](int32_t i) {
    const Mp4Sample& m = t.samples[(size_t)i];
    buf.resize(m.size);
    if (!read_at(m.offset, buf.data(), m.size)) return true;  // the copy below reports it
    for (size_t q = 0; q + (size_t)t.nal_length < buf.size();) {
      size_t len = 0;
      for (int k = 0; k < t.nal_length; k++) len = len << 8 | buf[q + (size_t)k];
      q += (size_t)t.nal_length;
      const int type = buf[q] & 31;
      if (type == 1 || type == 5) return type == 5;
      q += len;
    }
    return true;
  };
  // the sample a run decodes from: the sync sample at or before s, and past
  // sync samples that are recovery points (x264's open_gop: an I picture
  // whose leading B pictures reference the group before) back to an IDR
  // picture, so every picture decodes as it does from the stream's start
  // (oatx's answer: FFmpeg's seek lands past a leading picture and oatx then
  // decodes the clip in sequence)
  auto start = [&](int32_t s) {
    int32_t k = t.sync_at[(size_t)s];
    while (k > 0 && !idr(k)) k = t.sync_at[(size_t)k - 1];
    return k;
  };
  // runs of samples in decode order: [start sample, last wanted sample]
  std::vector<std::pair<int32_t, int32_t>> segs;
  for (int64_t d : wanted) {
    const int32_t s = t.by_display[(size_t)d], k = start(s);
    if (!segs.empty() && k >= segs.back().first && k <= segs.back().second + 1) {
      segs.back().second = std::max(segs.back().second, s);
    } else {
      segs.push_back({k, s});
    }
  }
  p = H264Plan();
  p.wanted = wanted;
  static const uint8_t kStart[4] = {0, 0, 0, 1};
  auto put_nal = [&](const uint8_t* nal, size_t len) {
    p.bytes.insert(p.bytes.end(), kStart, kStart + 4);
    p.bytes.insert(p.bytes.end(), nal, nal + len);
  };
  for (auto& seg : segs) {
    for (int32_t i = seg.first; i <= seg.second; i++) {
      const Mp4Sample& m = t.samples[(size_t)i];
      if (i == seg.first) {
        for (auto& n : t.sps) put_nal(n.data(), n.size());
        for (auto& n : t.pps) put_nal(n.data(), n.size());
      }
      buf.resize(m.size);
      if (!read_at(m.offset, buf.data(), m.size)) {
        err = "truncated sample " + std::to_string(i);
        return kMp4Corrupt;
      }
      size_t q = 0;
      while (q + (size_t)t.nal_length <= buf.size()) {
        size_t len = 0;
        for (int k = 0; k < t.nal_length; k++) len = len << 8 | buf[q + k];
        q += (size_t)t.nal_length;
        if (len > buf.size() - q) {
          err = "sample " + std::to_string(i) + " has a NAL unit past its end";
          return kMp4Corrupt;
        }
        if (len) put_nal(buf.data() + q, len);
        q += len;
      }
      p.pkt_end.push_back((int64_t)p.bytes.size());
      p.pkt_ts.push_back(t.display[(size_t)i]);
    }
    p.seg_end.push_back((int32_t)p.pkt_end.size());
  }
  return 0;
}

}  // namespace oatxt
