// encode.cpp — writes an H.264 mp4 fixture through libavcodec's libx264
// with an x264-params string, for tests/torch_h264/make_fixtures.py (which
// builds it with the host compiler against FFmpeg's libraries, into a
// temporary directory):
//
//   encode OUT.mp4 WIDTH HEIGHT FRAMES FPS PROFILE CRF SEED X264_PARAMS [noise]
//
// The content is made to reach the decoder's tools while the clips stay
// small: a value-noise background that steps now and then, boxes (stripes,
// a shaded disc, a ramp) moving at fractional speeds across the picture's
// edges (sub-sample motion, every partition), a fade down and up again
// (weighted prediction, reference list reordering) and a noise patch; with
// `noise`, every sample is noise (at a low qp x264 then codes I_PCM).
// Everything is integer arithmetic on the seed, so a rerun writes the same
// frames.
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

static uint32_t hash(uint32_t x, uint32_t y, uint32_t s) {
  uint32_t h = x * 374761393u + y * 668265263u + s * 2246822519u;
  h = (h ^ (h >> 13)) * 1274126177u;
  return h ^ (h >> 16);
}

static int sq(int v) { return v * v; }

// value noise on a grid of `cell` samples, bilinear, at quarter-sample
// position (x4, y4): 0..255
static int noise(int x4, int y4, int cell, uint32_t s) {
  const int c4 = cell * 4;
  const int gx = (x4 >= 0 ? x4 : x4 - c4 + 1) / c4, gy = (y4 >= 0 ? y4 : y4 - c4 + 1) / c4;
  const int fx = x4 - gx * c4, fy = y4 - gy * c4;
  const int a = hash(gx, gy, s) & 255, b = hash(gx + 1, gy, s) & 255;
  const int c = hash(gx, gy + 1, s) & 255, d = hash(gx + 1, gy + 1, s) & 255;
  const int top = a * (c4 - fx) + b * fx, bot = c * (c4 - fx) + d * fx;
  return (top * (c4 - fy) + bot * fy) / (c4 * c4);
}

static void noise_planes(int w, int h, int i, uint32_t seed, AVFrame* f) {
  for (int p = 0; p < 3; p++)
    for (int y = 0; y < (p ? h / 2 : h); y++)
      for (int x = 0; x < (p ? w / 2 : w); x++)
        f->data[p][y * f->linesize[p] + x] = (uint8_t)(hash(x, y + 64 * p, seed + i) & 255);
}

static void frame_planes(int w, int h, int i, int n, uint32_t seed, AVFrame* f) {
  // fade: full brightness, down to 35 % over frames [n/5, n/5 + 3), back up in 3 more
  const int a = n / 5, b = a + 3, c = a + 6;
  int gain = 256;
  if (i >= a && i < b) gain = 256 - (i - a) * 166 / (b - a);
  else if (i >= b && i < c) gain = 90 + (i - b) * 166 / (c - b);
  const int panx = (i / 8) * 8, pany = 0;  // the background steps by 2 samples now and then
  for (int y = 0; y < h; y++) {
    uint8_t* row = f->data[0] + y * f->linesize[0];
    for (int x = 0; x < w; x++) {
      int v = 40 + noise(4 * x + panx, 4 * y + pany, 40, seed) * 5 / 8;
      for (int k = 0; k < 3; k++) {  // boxes, each with its own texture and speed
        const int bw = w / 8 + 8 * k, bh = h / 6 + 6 * k;
        const int step4 = k == 0 ? 16 : 13 + 7 * k;  // quarter samples a frame; stripes whole
        const int bx = (int)((k * w / 3 + i * step4 / 4) % (w + bw)) - bw / 2;
        const int by = (k * h / 4 + i * (3 - k) * 5 / 4 + h) % h - bh / 4;
        if (x >= bx && x < bx + bw && y >= by && y < by + bh) {
          const int tx = x - bx, ty = y - by;
          v = k == 0 ? 30 + ((tx / 3 + ty / 5) & 1) * 180          // stripes
              : k == 1 ? 200 - (sq(tx - bw / 2) + sq(ty - bh / 2)) / 16  // disc
                       : 60 + (tx * 255) / bw;                     // ramp
        }
      }
      if (x >= w - w / 16 && y < h / 12) v = hash(x, y, seed + 3) & 255;  // noise patch
      row[x] = (uint8_t)std::min(255, std::max(0, v * gain / 256));
    }
  }
  for (int y = 0; y < h / 2; y++) {
    uint8_t* u = f->data[1] + y * f->linesize[1];
    uint8_t* v = f->data[2] + y * f->linesize[2];
    for (int x = 0; x < w / 2; x++) {
      const int cu = 128 + (noise(8 * x + panx, 8 * y + pany, 20, seed + 11) - 128) / 2;
      const int cv = 128 + (noise(8 * x + panx, 8 * y + pany, 30, seed + 12) - 128) / 2;
      u[x] = (uint8_t)(128 + (cu - 128) * gain / 256);
      v[x] = (uint8_t)(128 + (cv - 128) * gain / 256);
    }
  }
}

int main(int argc, char** argv) {
  if (argc != 10 && argc != 11) {
    std::fprintf(stderr, "usage: encode OUT W H FRAMES FPS PROFILE CRF SEED X264_PARAMS [noise]\n");
    return 2;
  }
  const char* path = argv[1];
  const int w = std::atoi(argv[2]), h = std::atoi(argv[3]), n = std::atoi(argv[4]),
            fps = std::atoi(argv[5]);
  const uint32_t seed = (uint32_t)std::atoi(argv[8]);
  const AVCodec* enc = avcodec_find_encoder_by_name("libx264");
  if (!enc) return 3;
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, "mp4", path) < 0) return 4;
  AVStream* st = avformat_new_stream(fmt, enc);
  AVCodecContext* c = avcodec_alloc_context3(enc);
  c->width = w;
  c->height = h;
  c->time_base = {1, fps};
  c->framerate = {fps, 1};
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->thread_count = 1;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER) c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  av_opt_set(c->priv_data, "preset", "medium", 0);
  av_opt_set(c->priv_data, "profile", argv[6], 0);
  av_opt_set(c->priv_data, "crf", argv[7], 0);
  av_opt_set(c->priv_data, "x264-params", argv[9], 0);
  if (avcodec_open2(c, enc, nullptr) < 0) return 5;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return 6;
  if (avformat_write_header(fmt, nullptr) < 0) return 7;
  AVFrame* f = av_frame_alloc();
  f->format = c->pix_fmt;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 0);
  AVPacket* pkt = av_packet_alloc();
  auto drain = [&] {
    while (avcodec_receive_packet(c, pkt) == 0) {
      pkt->duration = 1;
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  };
  for (int i = 0; i < n; i++) {
    av_frame_make_writable(f);
    if (argc == 11) noise_planes(w, h, i, seed, f);
    else frame_planes(w, h, i, n, seed, f);
    f->pts = i;
    if (avcodec_send_frame(c, f) == 0) drain();
  }
  avcodec_send_frame(c, nullptr);
  drain();
  av_write_trailer(fmt);
  av_packet_free(&pkt);
  av_frame_free(&f);
  avcodec_free_context(&c);
  avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}
