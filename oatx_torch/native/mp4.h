// mp4.h — the port's ISO BMFF (mp4 / mov) demuxer for H.264 video.
//
// oatx opens mp4 clips through FFmpeg (oatx/native/oatx_decode.cpp:
// open_decoder, oatx_handle_info). The port reads the container itself on
// the host and hands its H.264 decoder (h264.h) an Annex B elementary
// stream; nothing here parses below the sequence parameter set, which is
// read only for the picture size, the chroma format, the bit depth and the
// range flag.
#pragma once

#include <cstdint>
#include <functional>
#include <string>
#include <vector>

namespace oatxt {

constexpr int kMp4Corrupt = -2;      // decode.cpp's kCorrupt
constexpr int kMp4Unsupported = -3;  // decode.cpp's kUnsupported

// reads n bytes at a file offset; false past the end or on an I/O error
using ReadAt = std::function<bool(uint64_t, void*, size_t)>;

struct Mp4Sample {  // one access unit, in decode order
  uint64_t offset;
  uint32_t size;
  int64_t cts;  // composition time after the edit list, in the track's timescale
  bool sync;
};

struct H264Track {
  std::vector<Mp4Sample> samples;   // decode order
  std::vector<int32_t> display;     // sample → display index (rank in composition order)
  std::vector<int32_t> by_display;  // display index → sample
  std::vector<int32_t> sync_at;     // sample → the last sync sample at or before it
  std::vector<std::vector<uint8_t>> sps, pps;  // from avcC, without start codes
  int nal_length = 4;               // bytes of each NAL unit's length prefix
  int width = 0, height = 0;        // the SPS's picture size after cropping
  int coded_width = 0, coded_height = 0;  // in whole macroblocks
  int profile_idc = 0;
  bool full_range = false;          // the SPS's video_full_range_flag
  double fps = 0.0;                 // FFmpeg's avg_frame_rate
};

// The first video track of an ISO BMFF file. Returns 0, or kMp4Corrupt /
// kMp4Unsupported with a message in `err`.
int read_mp4(const ReadAt& read_at, uint64_t file_size, H264Track& t, std::string& err);

// The Annex B stream that decodes the display indices `wanted` (sorted,
// unique, each in range): one segment a run of samples from a sync sample
// on, the SPS and PPS before its first sample, every packet one sample.
struct H264Plan {
  std::vector<uint8_t> bytes;
  std::vector<int64_t> pkt_end;   // packet i is bytes[pkt_end[i - 1], pkt_end[i])
  std::vector<int64_t> pkt_ts;    // its display index
  std::vector<int32_t> seg_end;   // segment s is packets [seg_end[s - 1], seg_end[s])
  std::vector<int64_t> wanted;
};

int plan_h264(const ReadAt& read_at, const H264Track& t, const std::vector<int64_t>& wanted,
              H264Plan& p, std::string& err);

}  // namespace oatxt
