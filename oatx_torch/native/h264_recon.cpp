// h264_recon.cpp — the H.264 decoder's sample half (h264.h): intra
// prediction (8.3), inter prediction with fractional-sample interpolation,
// bi-prediction and default, explicit and implicit weights (8.4.2), the
// inverse transforms (8.5.12, 8.5.13) and the deblocking filter (8.7).
// Clause numbers are ITU-T H.264's.

#include <algorithm>
#include <cstdlib>
#include <cstring>

#include "h264.h"

namespace oatxt {
namespace h264 {

namespace {

inline int clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int clamp(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// The neighbouring samples of an intra block and which of them exist.
struct Edge {
  int top[16 + 1] = {};  // top[0] = p[-1, -1], top[1 + x] = p[x, -1]
  int left[16] = {};     // p[-1, y]
  bool has_top = false, has_left = false, has_tl = false, has_tr = false;
  int tl() const { return top[0]; }
  int t(int x) const { return top[1 + x]; }
};

// Gather the samples around an n×n block at (bx, by) in macroblock
// (mbx, mby) of a plane; tr_inside: whether the top-right block inside the
// macroblock precedes this one (only asked when it lies inside).
void gather(SliceCtx& s, const uint8_t* plane, int stride, int mb_size, int mbx, int mby, int bx,
            int by, int n, int tr_n, bool tr_inside, Edge& e) {
  auto mb_ok = [&](int dx, int dy) { return intra_avail(s, mbx + dx, mby + dy); };
  e.has_left = bx > 0 || mb_ok(-1, 0);
  e.has_top = by > 0 || mb_ok(0, -1);
  if (bx > 0 && by > 0) e.has_tl = true;
  else if (bx > 0) e.has_tl = mb_ok(0, -1);
  else if (by > 0) e.has_tl = mb_ok(-1, 0);
  else e.has_tl = mb_ok(-1, -1);
  if (by > 0) e.has_tr = bx + n < mb_size && tr_inside;
  else if (bx + n < mb_size) e.has_tr = mb_ok(0, -1);
  else e.has_tr = mb_ok(1, -1);
  const uint8_t* p = plane + (size_t)(mby * mb_size + by) * stride + mbx * mb_size + bx;
  if (e.has_top) {
    for (int x = 0; x < n; x++) e.top[1 + x] = p[x - stride];
    if (tr_n) {
      if (e.has_tr) {
        for (int x = n; x < n + tr_n; x++) e.top[1 + x] = p[x - stride];
      } else {
        for (int x = n; x < n + tr_n; x++) e.top[1 + x] = e.top[n];
        s.d->stats[kStat_top_right_substituted]++;
      }
    }
  }
  if (e.has_left)
    for (int y = 0; y < n; y++) e.left[y] = p[y * stride - 1];
  if (e.has_tl) e.top[0] = p[-stride - 1];
}

// whether 4×4 block k2 (luma4x4BlkIdx) is decoded before block k
inline int blk_at(int x, int y) {  // luma4x4BlkIdx of the 4×4 at (x, y) in the macroblock
  return ((y >> 3) << 3) | ((x >> 3) << 2) | (((y >> 2) & 1) << 1) | ((x >> 2) & 1);
}

}  // namespace

bool intra_avail(SliceCtx& s, int mbx, int mby) {
  if (mbx < 0 || mby < 0 || mbx >= s.sps->mb_width || mby >= s.sps->mb_height) return false;
  const MbInfo& m = s.d->mbs[(size_t)(mby * s.sps->mb_width + mbx)];
  if (m.slice != s.slice_num) return false;
  if (s.pps->constrained_intra_pred && !is_intra(m.kind)) {
    s.d->stats[kStat_cip_neighbour_refused]++;
    return false;
  }
  return true;
}

// ------------------------------------------------------------ intra 4×4

void intra_pred_4x4(SliceCtx& s, int mbx, int mby, int blk, int mode) {  // 8.3.1.2
  Picture& pic = s.d->cur;
  const int stride = pic.width, bx = kBlkX[blk], by = kBlkY[blk];
  const bool tr_inside = by > 0 && bx + 4 < 16 && blk_at(bx + 4, by - 4) < blk;
  Edge e;
  gather(s, pic.y.data(), stride, 16, mbx, mby, bx, by, 4, 4, tr_inside, e);
  uint8_t* dst = pic.y.data() + (size_t)(mby * 16 + by) * stride + mbx * 16 + bx;
  auto P = [&](int x, int y) -> int {  // p[x, y], x or y == -1
    return y < 0 ? (x < 0 ? e.tl() : e.t(x)) : e.left[y];
  };
  int pred[4][4];
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) {
      int v = 0;
      switch (mode) {
        case 0: v = P(x, -1); break;
        case 1: v = P(-1, y); break;
        case 2: {
          if (e.has_top && e.has_left) {
            int sum = 4;
            for (int k = 0; k < 4; k++) sum += P(k, -1) + P(-1, k);
            v = sum >> 3;
          } else if (e.has_left) {
            v = (P(-1, 0) + P(-1, 1) + P(-1, 2) + P(-1, 3) + 2) >> 2;
          } else if (e.has_top) {
            v = (P(0, -1) + P(1, -1) + P(2, -1) + P(3, -1) + 2) >> 2;
          } else {
            v = 128;
          }
          break;
        }
        case 3:
          v = (x == 3 && y == 3) ? (P(6, -1) + 3 * P(7, -1) + 2) >> 2
                                 : avg3(P(x + y, -1), P(x + y + 1, -1), P(x + y + 2, -1));
          break;
        case 4:
          if (x > y) v = avg3(P(x - y - 2, -1), P(x - y - 1, -1), P(x - y, -1));
          else if (x < y) v = avg3(P(-1, y - x - 2), P(-1, y - x - 1), P(-1, y - x));
          else v = avg3(P(0, -1), P(-1, -1), P(-1, 0));
          break;
        case 5: {
          const int z = 2 * x - y, k = x - (y >> 1);
          if (z >= 0 && !(z & 1)) v = avg2(P(k - 1, -1), P(k, -1));
          else if (z >= 0) v = avg3(P(k - 2, -1), P(k - 1, -1), P(k, -1));
          else if (z == -1) v = avg3(P(-1, 0), P(-1, -1), P(0, -1));
          else v = avg3(P(-1, y - 1), P(-1, y - 2), P(-1, y - 3));
          break;
        }
        case 6: {
          const int z = 2 * y - x, k = y - (x >> 1);
          if (z >= 0 && !(z & 1)) v = avg2(P(-1, k - 1), P(-1, k));
          else if (z >= 0) v = avg3(P(-1, k - 2), P(-1, k - 1), P(-1, k));
          else if (z == -1) v = avg3(P(-1, 0), P(-1, -1), P(0, -1));
          else v = avg3(P(x - 1, -1), P(x - 2, -1), P(x - 3, -1));
          break;
        }
        case 7: {
          const int k = x + (y >> 1);
          v = (y & 1) ? avg3(P(k, -1), P(k + 1, -1), P(k + 2, -1)) : avg2(P(k, -1), P(k + 1, -1));
          break;
        }
        default: {
          const int z = x + 2 * y, k = y + (x >> 1);
          if (z > 5) v = P(-1, 3);
          else if (z == 5) v = (P(-1, 2) + 3 * P(-1, 3) + 2) >> 2;
          else if (!(z & 1)) v = avg2(P(-1, k), P(-1, k + 1));
          else v = avg3(P(-1, k), P(-1, k + 1), P(-1, k + 2));
        }
      }
      pred[y][x] = v;
    }
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) dst[y * stride + x] = (uint8_t)pred[y][x];
}

// ------------------------------------------------------------ intra 8×8

void intra_pred_8x8(SliceCtx& s, int mbx, int mby, int b8, int mode) {  // 8.3.2.2
  Picture& pic = s.d->cur;
  const int stride = pic.width, bx = (b8 & 1) * 8, by = (b8 >> 1) * 8;
  Edge e;
  gather(s, pic.y.data(), stride, 16, mbx, mby, bx, by, 8, 8, b8 == 2, e);
  // the reference sample filter (8.3.2.2.1)
  int t[16] = {}, l[8] = {}, tl = 0;
  if (e.has_top) {
    t[0] = e.has_tl ? (e.tl() + 2 * e.t(0) + e.t(1) + 2) >> 2 : (3 * e.t(0) + e.t(1) + 2) >> 2;
    for (int x = 1; x < 15; x++) t[x] = (e.t(x - 1) + 2 * e.t(x) + e.t(x + 1) + 2) >> 2;
    t[15] = (e.t(14) + 3 * e.t(15) + 2) >> 2;
  }
  if (e.has_tl) {
    if (e.has_top && e.has_left) tl = (e.t(0) + 2 * e.tl() + e.left[0] + 2) >> 2;
    else if (e.has_top) tl = (3 * e.tl() + e.t(0) + 2) >> 2;
    else if (e.has_left) tl = (3 * e.tl() + e.left[0] + 2) >> 2;
    else tl = e.tl();
  }
  if (e.has_left) {
    l[0] = e.has_tl ? (e.tl() + 2 * e.left[0] + e.left[1] + 2) >> 2
                    : (3 * e.left[0] + e.left[1] + 2) >> 2;
    for (int y = 1; y < 7; y++) l[y] = (e.left[y - 1] + 2 * e.left[y] + e.left[y + 1] + 2) >> 2;
    l[7] = (e.left[6] + 3 * e.left[7] + 2) >> 2;
  }
  auto P = [&](int x, int y) -> int { return y < 0 ? (x < 0 ? tl : t[x]) : l[y]; };
  uint8_t* dst = pic.y.data() + (size_t)(mby * 16 + by) * stride + mbx * 16 + bx;
  int dc = 128;
  if (mode == 2) {
    int sum = 0;
    if (e.has_top && e.has_left) {
      for (int k = 0; k < 8; k++) sum += t[k] + l[k];
      dc = (sum + 8) >> 4;
    } else if (e.has_left) {
      for (int k = 0; k < 8; k++) sum += l[k];
      dc = (sum + 4) >> 3;
    } else if (e.has_top) {
      for (int k = 0; k < 8; k++) sum += t[k];
      dc = (sum + 4) >> 3;
    }
  }
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) {
      int v = 0;
      switch (mode) {
        case 0: v = P(x, -1); break;
        case 1: v = P(-1, y); break;
        case 2: v = dc; break;
        case 3:
          v = (x == 7 && y == 7) ? (P(14, -1) + 3 * P(15, -1) + 2) >> 2
                                 : avg3(P(x + y, -1), P(x + y + 1, -1), P(x + y + 2, -1));
          break;
        case 4:
          if (x > y) v = avg3(P(x - y - 2, -1), P(x - y - 1, -1), P(x - y, -1));
          else if (x < y) v = avg3(P(-1, y - x - 2), P(-1, y - x - 1), P(-1, y - x));
          else v = avg3(P(0, -1), P(-1, -1), P(-1, 0));
          break;
        case 5: {
          const int z = 2 * x - y, k = x - (y >> 1);
          if (z >= 0 && !(z & 1)) v = avg2(P(k - 1, -1), P(k, -1));
          else if (z >= 0) v = avg3(P(k - 2, -1), P(k - 1, -1), P(k, -1));
          else if (z == -1) v = avg3(P(-1, 0), P(-1, -1), P(0, -1));
          else v = avg3(P(-1, y - 2 * x - 1), P(-1, y - 2 * x - 2), P(-1, y - 2 * x - 3));
          break;
        }
        case 6: {
          const int z = 2 * y - x, k = y - (x >> 1);
          if (z >= 0 && !(z & 1)) v = avg2(P(-1, k - 1), P(-1, k));
          else if (z >= 0) v = avg3(P(-1, k - 2), P(-1, k - 1), P(-1, k));
          else if (z == -1) v = avg3(P(-1, 0), P(-1, -1), P(0, -1));
          else v = avg3(P(x - 2 * y - 1, -1), P(x - 2 * y - 2, -1), P(x - 2 * y - 3, -1));
          break;
        }
        case 7: {
          const int k = x + (y >> 1);
          v = (y & 1) ? avg3(P(k, -1), P(k + 1, -1), P(k + 2, -1)) : avg2(P(k, -1), P(k + 1, -1));
          break;
        }
        default: {
          const int z = x + 2 * y, k = y + (x >> 1);
          if (z > 13) v = P(-1, 7);
          else if (z == 13) v = (P(-1, 6) + 3 * P(-1, 7) + 2) >> 2;
          else if (!(z & 1)) v = avg2(P(-1, k), P(-1, k + 1));
          else v = avg3(P(-1, k), P(-1, k + 1), P(-1, k + 2));
        }
      }
      dst[y * stride + x] = (uint8_t)v;
    }
}

// ------------------------------------------------ intra 16×16 and chroma

void intra_pred_16x16(SliceCtx& s, int mbx, int mby, int mode) {  // 8.3.3
  Picture& pic = s.d->cur;
  const int stride = pic.width;
  Edge e;
  gather(s, pic.y.data(), stride, 16, mbx, mby, 0, 0, 16, 0, false, e);
  uint8_t* dst = pic.y.data() + (size_t)mby * 16 * stride + mbx * 16;
  if (mode == 3) {  // plane
    int hh = 0, vv = 0;
    for (int k = 0; k < 8; k++) {
      hh += (k + 1) * (e.t(8 + k) - (k == 7 ? e.tl() : e.t(6 - k)));
      vv += (k + 1) * (e.left[8 + k] - (k == 7 ? e.tl() : e.left[6 - k]));
    }
    const int a = 16 * (e.left[15] + e.t(15)), b = (5 * hh + 32) >> 6, c = (5 * vv + 32) >> 6;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++)
        dst[y * stride + x] = (uint8_t)clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
    return;
  }
  int dc = 128;
  if (mode == 2) {
    int sum = 0;
    if (e.has_top && e.has_left) {
      for (int k = 0; k < 16; k++) sum += e.t(k) + e.left[k];
      dc = (sum + 16) >> 5;
    } else if (e.has_left) {
      for (int k = 0; k < 16; k++) sum += e.left[k];
      dc = (sum + 8) >> 4;
    } else if (e.has_top) {
      for (int k = 0; k < 16; k++) sum += e.t(k);
      dc = (sum + 8) >> 4;
    }
  }
  for (int y = 0; y < 16; y++)
    for (int x = 0; x < 16; x++)
      dst[y * stride + x] = (uint8_t)(mode == 0 ? e.t(x) : mode == 1 ? e.left[y] : dc);
}

void intra_pred_chroma(SliceCtx& s, int mbx, int mby, int mode) {  // 8.3.4, 4:2:0
  Picture& pic = s.d->cur;
  const int stride = pic.width / 2;
  for (int comp = 0; comp < 2; comp++) {
    uint8_t* plane = (comp ? pic.v : pic.u).data();
    Edge e;
    gather(s, plane, stride, 8, mbx, mby, 0, 0, 8, 0, false, e);
    uint8_t* dst = plane + (size_t)mby * 8 * stride + mbx * 8;
    if (mode == 3) {  // plane
      int hh = 0, vv = 0;
      for (int k = 0; k < 4; k++) {
        hh += (k + 1) * (e.t(4 + k) - (k == 3 ? e.tl() : e.t(2 - k)));
        vv += (k + 1) * (e.left[4 + k] - (k == 3 ? e.tl() : e.left[2 - k]));
      }
      const int a = 16 * (e.left[7] + e.t(7)), b = (34 * hh + 32) >> 6, c = (34 * vv + 32) >> 6;
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++)
          dst[y * stride + x] = (uint8_t)clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
      continue;
    }
    for (int blk = 0; blk < 4; blk++) {
      const int xo = (blk & 1) * 4, yo = (blk >> 1) * 4;
      int dc = 128;
      if (mode == 0) {
        int st = 0, sl = 0;
        for (int k = 0; k < 4; k++) {
          if (e.has_top) st += e.t(xo + k);
          if (e.has_left) sl += e.left[yo + k];
        }
        const bool corner = xo == yo;  // blocks 0 and 3 use both edges
        if (corner && e.has_top && e.has_left) dc = (st + sl + 4) >> 3;
        else if (corner && e.has_left) dc = (sl + 2) >> 2;
        else if (corner && e.has_top) dc = (st + 2) >> 2;
        else if (!corner && xo > 0 && e.has_top) dc = (st + 2) >> 2;
        else if (!corner && xo > 0 && e.has_left) dc = (sl + 2) >> 2;
        else if (!corner && yo > 0 && e.has_left) dc = (sl + 2) >> 2;
        else if (!corner && yo > 0 && e.has_top) dc = (st + 2) >> 2;
      }
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          dst[(yo + y) * stride + xo + x] =
              (uint8_t)(mode == 0 ? dc : mode == 1 ? e.left[yo + y] : e.t(xo + x));
    }
  }
}

// ------------------------------------------------------ inter prediction

namespace {

inline int tap(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// 8.4.2.2.1: a w×h luma block whose top-left integer sample in the reference
// is (x0, y0), at quarter-sample fraction (fx, fy)
void mc_luma(SliceCtx& s, const Picture& ref, int x0, int y0, int fx, int fy, int w, int h,
             uint8_t* dst, int stride) {
  int win[21][21];  // rows y0-2..y0+h+2, columns x0-2..x0+w+2
  const int ww = w + 5, wh = h + 5;
  const bool inside = x0 - 2 >= 0 && y0 - 2 >= 0 && x0 + w + 2 < ref.width &&
                      y0 + h + 2 < ref.height;
  if (!inside) s.d->stats[kStat_ref_outside_picture]++;
  for (int r = 0; r < wh; r++) {
    const int yy = clamp(y0 - 2 + r, 0, ref.height - 1);
    const uint8_t* row = ref.y.data() + (size_t)yy * ref.width;
    for (int c = 0; c < ww; c++)
      win[r][c] = row[clamp(x0 - 2 + c, 0, ref.width - 1)];
  }
  if (fx == 0 && fy == 0) {
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) dst[r * stride + c] = (uint8_t)win[r + 2][c + 2];
    return;
  }
  s.d->stats[kStat_luma_qpel]++;
  if (fx == 2 && fy == 2) s.d->stats[kStat_luma_center_j]++;
  // horizontal 6-tap sums (b1) of rows -2..h+2 at columns 0..w-1
  int hs[21][16];
  for (int r = 0; r < wh; r++)
    for (int c = 0; c < w; c++)
      hs[r][c] = tap(win[r][c], win[r][c + 1], win[r][c + 2], win[r][c + 3], win[r][c + 4],
                     win[r][c + 5]);
  auto G = [&](int r, int c) { return win[r + 2][c + 2]; };
  auto B = [&](int r, int c) { return clip1((hs[r + 2][c] + 16) >> 5); };  // b (row r)
  auto H = [&](int r, int c) {  // h (column c, between rows r and r + 1)
    return clip1((tap(win[r][c + 2], win[r + 1][c + 2], win[r + 2][c + 2], win[r + 3][c + 2],
                      win[r + 4][c + 2], win[r + 5][c + 2]) + 16) >> 5);
  };
  auto J = [&](int r, int c) {
    return clip1((tap(hs[r][c], hs[r + 1][c], hs[r + 2][c], hs[r + 3][c], hs[r + 4][c],
                      hs[r + 5][c]) + 512) >> 10);
  };
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      int v;
      switch (fy * 4 + fx) {
        case 1: v = (G(r, c) + B(r, c) + 1) >> 1; break;                  // a
        case 2: v = B(r, c); break;                                       // b
        case 3: v = (G(r, c + 1) + B(r, c) + 1) >> 1; break;              // c
        case 4: v = (G(r, c) + H(r, c) + 1) >> 1; break;                  // d
        case 5: v = (B(r, c) + H(r, c) + 1) >> 1; break;                  // e
        case 6: v = (B(r, c) + J(r, c) + 1) >> 1; break;                  // f
        case 7: v = (B(r, c) + H(r, c + 1) + 1) >> 1; break;              // g
        case 8: v = H(r, c); break;                                       // h
        case 9: v = (H(r, c) + J(r, c) + 1) >> 1; break;                  // i
        case 10: v = J(r, c); break;                                      // j
        case 11: v = (J(r, c) + H(r, c + 1) + 1) >> 1; break;             // k
        case 12: v = (G(r + 1, c) + H(r, c) + 1) >> 1; break;             // n
        case 13: v = (H(r, c) + B(r + 1, c) + 1) >> 1; break;             // p
        case 14: v = (J(r, c) + B(r + 1, c) + 1) >> 1; break;             // q
        default: v = (H(r, c + 1) + B(r + 1, c) + 1) >> 1; break;         // r
      }
      dst[r * stride + c] = (uint8_t)v;
    }
}

// 8.4.2.2.2: a w×h chroma block at chroma position (xc, yc) of the
// partition, motion vector mv in eighth chroma samples (4:2:0 frames)
void mc_chroma(SliceCtx& s, const std::vector<uint8_t>& plane, int pw, int ph, int xc, int yc,
               const int16_t* mv, int w, int h, uint8_t* dst, int stride) {
  const int x0 = xc + (mv[0] >> 3), y0 = yc + (mv[1] >> 3), fx = mv[0] & 7, fy = mv[1] & 7;
  if (fx || fy) s.d->stats[kStat_chroma_frac]++;
  for (int r = 0; r < h; r++) {
    const int ya = clamp(y0 + r, 0, ph - 1), yb = clamp(y0 + r + 1, 0, ph - 1);
    for (int c = 0; c < w; c++) {
      const int xa = clamp(x0 + c, 0, pw - 1), xb = clamp(x0 + c + 1, 0, pw - 1);
      const int A = plane[(size_t)ya * pw + xa], B = plane[(size_t)ya * pw + xb];
      const int C = plane[(size_t)yb * pw + xa], D = plane[(size_t)yb * pw + xb];
      dst[r * stride + c] = (uint8_t)(((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
                                       (8 - fx) * fy * C + fx * fy * D + 32) >> 6);
    }
  }
}

// 8.4.2.3.2: explicit weighted sample prediction of one list
void weight(uint8_t* dst, int stride, int w, int h, int log_wd, int wt, int off) {
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      const int p = dst[r * stride + c];
      dst[r * stride + c] = (uint8_t)(log_wd >= 1
                                          ? clip1(((p * wt + (1 << (log_wd - 1))) >> log_wd) + off)
                                          : clip1(p * wt + off));
    }
}

// 8.4.2.3: two lists' predictions a and b (w×h, stride w) into dst: the
// default average (w0 = w1 = 1, log_wd = 0, off = 0), or explicit / implicit
// weights
void combine(uint8_t* dst, int stride, const uint8_t* a, const uint8_t* b, int w, int h,
             int log_wd, int w0, int w1, int off) {
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++)
      dst[r * stride + c] = (uint8_t)clip1(
          ((a[r * w + c] * w0 + b[r * w + c] * w1 + (1 << log_wd)) >> (log_wd + 1)) + off);
}

// one list's prediction of the w×h block at luma (lx, ly): luma into py
// (stride ys), chroma into pu / pv (stride cs)
void predict_list(SliceCtx& s, const Picture& ref, const int16_t* mv, int lx, int ly, int w, int h,
                  uint8_t* py, int ys, uint8_t* pu, uint8_t* pv, int cs) {
  mc_luma(s, ref, lx + (mv[0] >> 2), ly + (mv[1] >> 2), mv[0] & 3, mv[1] & 3, w, h, py, ys);
  const int cw = ref.width / 2, ch = ref.height / 2;
  mc_chroma(s, ref.u, cw, ch, lx / 2, ly / 2, mv, w / 2, h / 2, pu, cs);
  mc_chroma(s, ref.v, cw, ch, lx / 2, ly / 2, mv, w / 2, h / 2, pv, cs);
}

void predict_block(SliceCtx& s, int mbx, int mby, const MbInfo& mb, int x, int y, int w, int h) {
  const int b8 = (x >> 3) + 2 * (y >> 3), blk = (x >> 2) + 4 * (y >> 2);
  const int r0 = mb.ref[0][b8], r1 = mb.ref[1][b8];
  Picture& pic = s.d->cur;
  const int lx = mbx * 16 + x, ly = mby * 16 + y, cw = pic.width / 2;
  uint8_t* dy = pic.y.data() + (size_t)ly * pic.width + lx;
  const size_t co = (size_t)(ly / 2) * cw + lx / 2;
  uint8_t *du = pic.u.data() + co, *dv = pic.v.data() + co;
  const bool b_slice = s.sh.type == 1;
  // 0 default, 1 explicit, 2 implicit (8.4.2.3)
  const int mode = b_slice ? s.pps->weighted_bipred_idc : s.pps->weighted_pred ? 1 : 0;
  const PredWeight& pw = s.sh.pw;
  if (r0 < 0 || r1 < 0) {  // one list
    const int list = r0 >= 0 ? 0 : 1, ri = r0 >= 0 ? r0 : r1;
    predict_list(s, *s.ref_list[list][(size_t)ri], mb.mv[list][blk], lx, ly, w, h, dy, pic.width,
                 du, dv, cw);
    if (mode == 1) {
      s.d->stats[kStat_weighted_blocks]++;
      weight(dy, pic.width, w, h, pw.luma_log2, pw.luma_w[list][ri], pw.luma_o[list][ri]);
      weight(du, cw, w / 2, h / 2, pw.chroma_log2, pw.chroma_w[list][ri][0],
             pw.chroma_o[list][ri][0]);
      weight(dv, cw, w / 2, h / 2, pw.chroma_log2, pw.chroma_w[list][ri][1],
             pw.chroma_o[list][ri][1]);
    }
    return;
  }
  s.d->stats[kStat_bipred_blocks]++;
  uint8_t ly0[256], ly1[256], lu[2][64], lv[2][64];
  predict_list(s, *s.ref_list[0][(size_t)r0], mb.mv[0][blk], lx, ly, w, h, ly0, w, lu[0], lv[0],
               w / 2);
  predict_list(s, *s.ref_list[1][(size_t)r1], mb.mv[1][blk], lx, ly, w, h, ly1, w, lu[1], lv[1],
               w / 2);
  if (mode == 0) {
    combine(dy, pic.width, ly0, ly1, w, h, 0, 1, 1, 0);
    combine(du, cw, lu[0], lu[1], w / 2, h / 2, 0, 1, 1, 0);
    combine(dv, cw, lv[0], lv[1], w / 2, h / 2, 0, 1, 1, 0);
  } else if (mode == 1) {
    s.d->stats[kStat_weighted_blocks]++;
    combine(dy, pic.width, ly0, ly1, w, h, pw.luma_log2, pw.luma_w[0][r0], pw.luma_w[1][r1],
            (pw.luma_o[0][r0] + pw.luma_o[1][r1] + 1) >> 1);
    for (int c = 0; c < 2; c++)
      combine(c ? dv : du, cw, c ? lv[0] : lu[0], c ? lv[1] : lu[1], w / 2, h / 2,
              pw.chroma_log2, pw.chroma_w[0][r0][c], pw.chroma_w[1][r1][c],
              (pw.chroma_o[0][r0][c] + pw.chroma_o[1][r1][c] + 1) >> 1);
  } else {
    const int w0 = s.implicit_w0[r0][r1];
    combine(dy, pic.width, ly0, ly1, w, h, 5, w0, 64 - w0, 0);
    combine(du, cw, lu[0], lu[1], w / 2, h / 2, 5, w0, 64 - w0, 0);
    combine(dv, cw, lv[0], lv[1], w / 2, h / 2, 5, w0, 64 - w0, 0);
  }
}

bool same_motion(const MbInfo& mb, int x, int y, int w, int h) {
  const int b0 = (x >> 2) + 4 * (y >> 2), r0 = (x >> 3) + 2 * (y >> 3);
  for (int j = y; j < y + h; j += 4)
    for (int i = x; i < x + w; i += 4) {
      const int b = (i >> 2) + 4 * (j >> 2), r = (i >> 3) + 2 * (j >> 3);
      for (int l = 0; l < 2; l++)
        if (mb.ref[l][r] != mb.ref[l][r0] ||
            (mb.ref[l][r0] >= 0 &&
             (mb.mv[l][b][0] != mb.mv[l][b0][0] || mb.mv[l][b][1] != mb.mv[l][b0][1])))
          return false;
    }
  return true;
}

}  // namespace

// The prediction of an inter macroblock: each region of one motion vector
// and one reference predicted at once (the samples do not depend on how
// the macroblock is cut into blocks).
void inter_pred(SliceCtx& s, int mbx, int mby, const MbInfo& mb) {
  if (same_motion(mb, 0, 0, 16, 16)) {
    predict_block(s, mbx, mby, mb, 0, 0, 16, 16);
    return;
  }
  for (int b8 = 0; b8 < 4; b8++) {
    const int x = (b8 & 1) * 8, y = (b8 >> 1) * 8;
    if (same_motion(mb, x, y, 8, 8)) {
      predict_block(s, mbx, mby, mb, x, y, 8, 8);
      continue;
    }
    for (int k = 0; k < 4; k++)
      predict_block(s, mbx, mby, mb, x + (k & 1) * 4, y + (k >> 1) * 4, 4, 4);
  }
}

// ----------------------------------------------------------- transforms

void add_residual_4x4(uint8_t* dst, int stride, int32_t* d) {  // 8.5.12.2
  int32_t f[16];
  for (int i = 0; i < 4; i++) {
    const int32_t* r = d + 4 * i;
    const int32_t e0 = r[0] + r[2], e1 = r[0] - r[2], e2 = (r[1] >> 1) - r[3],
                  e3 = r[1] + (r[3] >> 1);
    f[4 * i] = e0 + e3;
    f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2;
    f[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; j++) {
    const int32_t g0 = f[j] + f[8 + j], g1 = f[j] - f[8 + j], g2 = (f[4 + j] >> 1) - f[12 + j],
                  g3 = f[4 + j] + (f[12 + j] >> 1);
    const int32_t h[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
    for (int i = 0; i < 4; i++)
      dst[i * stride + j] = (uint8_t)clip1(dst[i * stride + j] + ((h[i] + 32) >> 6));
  }
}

namespace {
inline void idct8_1d(const int32_t* in, int step, int32_t* out, int ostep) {  // 8.5.13.2
  const int32_t d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step],
                d4 = in[4 * step], d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
  const int32_t e0 = d0 + d4, e1 = -d3 + d5 - d7 - (d7 >> 1), e2 = d0 - d4,
                e3 = d1 + d7 - d3 - (d3 >> 1), e4 = (d2 >> 1) - d6, e5 = -d1 + d7 + d5 + (d5 >> 1),
                e6 = d2 + (d6 >> 1), e7 = d3 + d5 + d1 + (d1 >> 1);
  const int32_t f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2),
                f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  out[0] = f0 + f7;
  out[ostep] = f2 + f5;
  out[2 * ostep] = f4 + f3;
  out[3 * ostep] = f6 + f1;
  out[4 * ostep] = f6 - f1;
  out[5 * ostep] = f4 - f3;
  out[6 * ostep] = f2 - f5;
  out[7 * ostep] = f0 - f7;
}
}  // namespace

void add_residual_8x8(uint8_t* dst, int stride, int32_t* d) {
  int32_t g[64], m[64];
  for (int i = 0; i < 8; i++) idct8_1d(d + 8 * i, 1, g + 8 * i, 1);  // rows
  for (int j = 0; j < 8; j++) idct8_1d(g + j, 8, m + j, 8);          // columns
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++)
      dst[i * stride + j] = (uint8_t)clip1(dst[i * stride + j] + ((m[8 * i + j] + 32) >> 6));
}

// ------------------------------------------------------------- deblocking

namespace {

const uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,
                            0,  0,  4,  4,  5,  6,  7,  8,  9,   10,  12,  13,  15,  17,
                            20, 22, 25, 28, 32, 36, 40, 45, 50,  56,  63,  71,  80,  90,
                            101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  2,  2,
                           2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7,  7,  8,  8,  9,  9,  10, 10,
                           11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 0, 1},
    {0, 1, 1}, {0, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2},
    {1, 1, 2}, {1, 1, 2}, {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4},
    {2, 3, 4}, {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14}, {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// Filter `n` lines across an edge: q0 of line k at q + k · along, the
// samples across the edge `across` apart (8.7.2.3, 8.7.2.4).
void filter_lines(uint8_t* q, int across, int along, int n, int bs, int index_a, int index_b,
                  bool chroma) {
  const int alpha = kAlpha[index_a], beta = kBeta[index_b];
  if (!alpha || !beta) return;
  const int tc0 = bs < 4 ? kTc0[index_a][bs - 1] : 0;
  for (int k = 0; k < n; k++, q += along) {
    const int p0 = q[-across], p1 = q[-2 * across], q0 = q[0], q1 = q[across];
    if (std::abs(p0 - q0) >= alpha || std::abs(p1 - p0) >= beta || std::abs(q1 - q0) >= beta)
      continue;
    if (chroma) {
      if (bs < 4) {
        const int tc = tc0 + 1;
        const int delta = clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
        q[-across] = (uint8_t)clip1(p0 + delta);
        q[0] = (uint8_t)clip1(q0 - delta);
      } else {
        q[-across] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      }
      continue;
    }
    const int p2 = q[-3 * across], q2 = q[2 * across];
    const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    if (bs < 4) {
      const int tc = tc0 + (ap < beta) + (aq < beta);
      const int delta = clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
      q[-across] = (uint8_t)clip1(p0 + delta);
      q[0] = (uint8_t)clip1(q0 - delta);
      const int mid = (p0 + q0 + 1) >> 1;
      if (ap < beta) q[-2 * across] = (uint8_t)(p1 + clamp((p2 + mid - (p1 << 1)) >> 1, -tc0, tc0));
      if (aq < beta) q[across] = (uint8_t)(q1 + clamp((q2 + mid - (q1 << 1)) >> 1, -tc0, tc0));
      continue;
    }
    const int p3 = q[-4 * across], q3 = q[3 * across];
    const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap < beta && strong) {
      q[-across] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      q[-2 * across] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
      q[-3 * across] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      q[-across] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (aq < beta && strong) {
      q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
      q[across] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
      q[2 * across] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }
}

// 8.7.2.1: bS between 4×4 block bp of macroblock p and bq of q
int strength(const MbInfo& p, int bp, const MbInfo& q, int bq, bool mb_edge, int64_t* stats) {
  if (is_intra(p.kind) || is_intra(q.kind)) return mb_edge ? 4 : 3;
  if (((p.nz_filter >> bp) & 1) || ((q.nz_filter >> bq) & 1)) {
    if (p.t8x8 || q.t8x8) stats[kStat_bs2_8x8]++;
    return 2;
  }
  // the reference pictures and motion vectors of each block, whichever list
  const int p8 = ((bp & 3) >> 1) + 2 * (bp >> 3), q8 = ((bq & 3) >> 1) + 2 * (bq >> 3);
  int pr[2], qr[2], np = 0, nq = 0;
  const int16_t *pm[2], *qm[2];
  for (int l = 0; l < 2; l++) {
    if (p.ref[l][p8] >= 0) pr[np] = p.ref_pic[l][p8], pm[np++] = p.mv[l][bp];
    if (q.ref[l][q8] >= 0) qr[nq] = q.ref_pic[l][q8], qm[nq++] = q.mv[l][bq];
  }
  auto far = [](const int16_t* a, const int16_t* b) {
    return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
  };
  if (np != nq) {
    stats[kStat_bs_mv_count_differs]++;
    return 1;
  }
  if (np == 1) return pr[0] != qr[0] || far(pm[0], qm[0]) ? 1 : 0;
  if (!((pr[0] == qr[0] && pr[1] == qr[1]) || (pr[0] == qr[1] && pr[1] == qr[0]))) return 1;
  if (pr[0] != pr[1]) {  // two different pictures: each vector against its picture's
    stats[kStat_bs_two_refs]++;
    if (pr[0] == qr[0]) return far(pm[0], qm[0]) || far(pm[1], qm[1]) ? 1 : 0;
    return far(pm[0], qm[1]) || far(pm[1], qm[0]) ? 1 : 0;
  }
  stats[kStat_bs_same_two_refs]++;  // both vectors of each block from one picture
  return (far(pm[0], qm[0]) || far(pm[1], qm[1])) && (far(pm[0], qm[1]) || far(pm[1], qm[0]))
             ? 1 : 0;
}

}  // namespace

void deblock_picture(Decoder& d, const std::vector<SliceHeader>& slices,
                     const std::vector<const Pps*>& slice_pps) {  // 8.7
  Picture& pic = d.cur;
  const int mw = pic.width / 16, mh = pic.height / 16, ys = pic.width, cs = pic.width / 2;
  for (int mby = 0; mby < mh; mby++)
    for (int mbx = 0; mbx < mw; mbx++) {
      const MbInfo& q = d.mbs[(size_t)(mby * mw + mbx)];
      const SliceHeader& sh = slices[(size_t)q.slice];
      const Pps& pps = *slice_pps[(size_t)q.slice];
      if (sh.disable_deblocking == 1) continue;
      for (int dir = 0; dir < 2; dir++) {  // 0: vertical edges, 1: horizontal
        const bool has_mb = dir == 0 ? mbx > 0 : mby > 0;
        const MbInfo* nb = has_mb ? &d.mbs[(size_t)((mby - dir) * mw + mbx - (1 - dir))] : nullptr;
        const bool mb_edge = nb && (sh.disable_deblocking != 2 || nb->slice == q.slice);
        if (nb && !mb_edge) d.stats[kStat_slice_edge_kept]++;
        int bs[4][4];  // [edge][segment]
        for (int e = 0; e < 4; e++)
          for (int k = 0; k < 4; k++) {
            bs[e][k] = 0;
            if (e == 0 && !mb_edge) continue;
            if (e > 0 && q.t8x8 && (e & 1)) continue;
            const int bq = dir == 0 ? e + 4 * k : k + 4 * e;
            if (e == 0) {
              const int bp = dir == 0 ? 3 + 4 * k : k + 12;
              bs[e][k] = strength(*nb, bp, q, bq, true, d.stats);
            } else {
              const int bp = dir == 0 ? bq - 1 : bq - 4;
              bs[e][k] = strength(q, bp, q, bq, false, d.stats);
            }
            if (bs[e][k]) d.stats[kStat_bs1 + bs[e][k] - 1]++;
          }
        const int qa = sh.filter_offset_a, qb = sh.filter_offset_b;
        for (int e = mb_edge ? 0 : 1; e < 4; e++) {  // luma
          const MbInfo& p = e == 0 ? *nb : q;
          const int qp = (p.qp_filter + q.qp_filter + 1) >> 1;
          const int ia = clamp(qp + qa, 0, 51), ib = clamp(qp + qb, 0, 51);
          for (int k = 0; k < 4; k++) {
            if (!bs[e][k]) continue;
            uint8_t* at = pic.y.data() + (size_t)(mby * 16) * ys + mbx * 16 +
                          (dir == 0 ? 4 * e + 4 * k * ys : 4 * e * ys + 4 * k);
            filter_lines(at, dir == 0 ? 1 : ys, dir == 0 ? ys : 1, 4, bs[e][k], ia, ib, false);
          }
        }
        for (int comp = 0; comp < 2; comp++) {  // chroma edges 0 and 4: luma edges 0 and 2
          uint8_t* plane = (comp ? pic.v : pic.u).data();
          for (int e = mb_edge ? 0 : 2; e < 4; e += 2) {
            const MbInfo& p = e == 0 ? *nb : q;
            const int off = pps.chroma_qp_offset[comp];
            const int qp = (chroma_qp(p.qp_filter, off) + chroma_qp(q.qp_filter, off) + 1) >> 1;
            const int ia = clamp(qp + qa, 0, 51), ib = clamp(qp + qb, 0, 51);
            for (int k = 0; k < 4; k++) {
              if (!bs[e][k]) continue;
              const int ce = 2 * e;  // chroma sample offset of the edge
              uint8_t* at = plane + (size_t)(mby * 8) * cs + mbx * 8 +
                            (dir == 0 ? ce + 2 * k * cs : ce * cs + 2 * k);
              filter_lines(at, dir == 0 ? 1 : cs, dir == 0 ? cs : 1, 2, bs[e][k], ia, ib, true);
            }
          }
        }
      }
    }
}

}  // namespace h264
}  // namespace oatxt
