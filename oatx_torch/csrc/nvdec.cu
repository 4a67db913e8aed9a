// nvdec.cu — H.264 decode on the card's NVDEC, and the NV12 → RGB24 kernel.
//
// Replaces the H.264 path of oatx's FFmpeg reader (oatx/native/
// oatx_decode.cpp: decode_seek_stepping, IndexDecode). The host demuxer
// (native/mp4.cpp) hands this library an Annex B stream in segments, each
// from a sync sample on, every packet one access unit stamped with its
// display index. NVIDIA's own bitstream parser in libnvcuvid reads the SPS,
// PPS and slice headers and calls back with ready picture parameters; this
// file holds the callbacks, one decoder per open handle, and a copy of each
// wanted frame's NV12 surface (cropped to the display area) into a packed
// buffer that `nv12_rgb_kernel` then converts in one launch for all frames
// (ops/kernels/nv12_rgb.py says what it computes and what bounds it).
//
// No NVIDIA video header is needed: the subset of the NVCUVID C API called
// here is declared below from the Video Codec SDK's published interface
// (nvcuvid.h, cuviddec.h), reserved fields included, and libnvcuvid.so.1
// (the driver's) is dlopen'ed at first use. Layout errors show on the card
// as a failed or unsupported caps query, a coded size unlike the demuxer's,
// or wrong frames: chip_smoke.py's decode phase checks all three.
//
// UNVERIFIED: the decoder glue (the parser's callbacks, the decoder's
// lifecycle, the surface copies) has never run. The only card this was
// tried on sits in a container without the driver's video capability, and
// there cuvidGetDecoderCaps itself fails (CUDA_ERROR_OUT_OF_MEMORY); the
// struct sizes are held only by the static_asserts below. The first machine
// that grants the capability runs it through chip_smoke.py --only-decode.
// nv12_rgb_kernel is checked on the card against its plain version.
//
// Context: every entry retains the device's primary context (torch's) and
// pushes it for its NVCUVID calls; loader threads call in with handles of
// their own, each decoder with its own context lock, and the frames are
// copied on the caller's stream (the reader's per-thread stream), so
// handles on different threads do not wait for each other here.
//
// C ABI for ctypes; each entry returns 0 or a negative code with a
// per-thread message (oatx_nvdec_error):
//   -1 the driver may withhold NVDEC: libnvcuvid.so.1 does not load, or the
//      caps query returns CUDA_ERROR_OUT_OF_MEMORY (what a container without
//      the driver's video capability gave). data/nvdec.py calls it a refusal
//      only where NVIDIA_DRIVER_CAPABILITIES withholds 'video'.
//   -2 a fault of this port or of the card: any other caps result, caps that
//      do not support 8-bit 4:2:0 H.264, a failed CUDA / NVCUVID call (the
//      decoder's creation included), NVDEC's parser disagreeing with the
//      demuxer, a wanted frame never displayed.
//   -3 NVDEC's parser rejected the bitstream (cuvidParseVideoData).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

// ------------------------------------------------ the NVCUVID subset (SDK)

typedef void* CUvideodecoder;
typedef void* CUvideoparser;
typedef void* CUvideoctxlock;
typedef long long CUvideotimestamp;

enum { kCodecH264 = 4 };                  // cudaVideoCodec_H264
enum { kChroma420 = 1 };                  // cudaVideoChromaFormat_420
enum { kSurfaceNV12 = 0 };                // cudaVideoSurfaceFormat_NV12
enum { kDeinterlaceWeave = 0 };           // cudaVideoDeinterlaceMode_Weave
enum { kCreatePreferCUVID = 4 };          // cudaVideoCreate_PreferCUVID
enum { kPktEndOfStream = 1, kPktTimestamp = 2 };  // CUVID_PKT_*

struct CUVIDEOFORMAT {
  int codec;
  struct {
    unsigned int numerator, denominator;
  } frame_rate;
  unsigned char progressive_sequence;
  unsigned char bit_depth_luma_minus8;
  unsigned char bit_depth_chroma_minus8;
  unsigned char min_num_decode_surfaces;
  unsigned int coded_width;
  unsigned int coded_height;
  struct {
    int left, top, right, bottom;
  } display_area;
  int chroma_format;
  unsigned int bitrate;
  struct {
    int x, y;
  } display_aspect_ratio;
  struct {
    unsigned char video_format : 3;
    unsigned char video_full_range_flag : 1;
    unsigned char reserved_zero_bits : 4;
    unsigned char color_primaries;
    unsigned char transfer_characteristics;
    unsigned char matrix_coefficients;
  } video_signal_description;
  unsigned int seqhdr_data_length;
};

struct CUVIDPARSERDISPINFO {
  int picture_index;
  int progressive_frame;
  int top_field_first;
  int repeat_first_field;
  CUvideotimestamp timestamp;
};

typedef int (*PFNVIDSEQUENCECALLBACK)(void*, CUVIDEOFORMAT*);
typedef int (*PFNVIDDECODECALLBACK)(void*, void* /* CUVIDPICPARAMS */);
typedef int (*PFNVIDDISPLAYCALLBACK)(void*, CUVIDPARSERDISPINFO*);

struct CUVIDPARSERPARAMS {
  int CodecType;
  unsigned int ulMaxNumDecodeSurfaces;
  unsigned int ulClockRate;
  unsigned int ulErrorThreshold;
  unsigned int ulMaxDisplayDelay;
  unsigned int uFlags;  // bAnnexb : 1, bMemoryOptimize : 1, uReserved : 30
  unsigned int uReserved1[4];
  void* pUserData;
  PFNVIDSEQUENCECALLBACK pfnSequenceCallback;
  PFNVIDDECODECALLBACK pfnDecodePicture;
  PFNVIDDISPLAYCALLBACK pfnDisplayPicture;
  void* pfnGetOperatingPoint;
  void* pfnGetSEIMsg;
  void* pvReserved2[5];
  void* pExtVideoInfo;
};

struct CUVIDSOURCEDATAPACKET {
  unsigned long flags;
  unsigned long payload_size;
  const unsigned char* payload;
  CUvideotimestamp timestamp;
};

struct CUVIDDECODECREATEINFO {
  unsigned long ulWidth;
  unsigned long ulHeight;
  unsigned long ulNumDecodeSurfaces;
  int CodecType;
  int ChromaFormat;
  unsigned long ulCreationFlags;
  unsigned long bitDepthMinus8;
  unsigned long ulIntraDecodeOnly;
  unsigned long ulMaxWidth;
  unsigned long ulMaxHeight;
  unsigned long Reserved1;
  struct {
    short left, top, right, bottom;
  } display_area;
  int OutputFormat;
  int DeinterlaceMode;
  unsigned long ulTargetWidth;
  unsigned long ulTargetHeight;
  unsigned long ulNumOutputSurfaces;
  CUvideoctxlock vidLock;
  struct {
    short left, top, right, bottom;
  } target_rect;
  unsigned long enableHistogram;
  unsigned long Reserved2[4];
};

struct CUVIDPROCPARAMS {
  int progressive_frame;
  int second_field;
  int top_field_first;
  int unpaired_field;
  unsigned int reserved_flags;
  unsigned int reserved_zero;
  unsigned long long raw_input_dptr;
  unsigned int raw_input_pitch;
  unsigned int raw_input_format;
  unsigned long long raw_output_dptr;
  unsigned int raw_output_pitch;
  unsigned int Reserved1;
  CUstream output_stream;
  unsigned int Reserved[46];
  unsigned long long* histogram_dptr;
  void* Reserved2[1];
};

struct CUVIDDECODECAPS {
  int eCodecType;
  int eChromaFormat;
  unsigned int nBitDepthMinus8;
  unsigned int reserved1[3];
  unsigned char bIsSupported;
  unsigned char nNumNVDECs;
  unsigned short nOutputFormatMask;
  unsigned int nMaxWidth;
  unsigned int nMaxHeight;
  unsigned int nMaxMBCount;
  unsigned short nMinWidth;
  unsigned short nMinHeight;
  unsigned char bIsHistogramSupported;
  unsigned char nCounterBitDepth;
  unsigned short nMaxHistogramBins;
  unsigned int reserved3[10];
};

static_assert(sizeof(CUVIDEOFORMAT) == 64, "CUVIDEOFORMAT layout");
static_assert(sizeof(CUVIDPARSERPARAMS) == 136, "CUVIDPARSERPARAMS layout");
static_assert(sizeof(CUVIDSOURCEDATAPACKET) == 32, "CUVIDSOURCEDATAPACKET layout");
static_assert(sizeof(CUVIDPARSERDISPINFO) == 24, "CUVIDPARSERDISPINFO layout");
static_assert(sizeof(CUVIDDECODECREATEINFO) == 176, "CUVIDDECODECREATEINFO layout");
static_assert(offsetof(CUVIDPROCPARAMS, output_stream) == 56, "CUVIDPROCPARAMS layout");
static_assert(sizeof(CUVIDDECODECAPS) == 88, "CUVIDDECODECAPS layout");

namespace {

struct Api {
  CUresult (*GetDecoderCaps)(CUVIDDECODECAPS*);
  CUresult (*CreateDecoder)(CUvideodecoder*, CUVIDDECODECREATEINFO*);
  CUresult (*DestroyDecoder)(CUvideodecoder);
  CUresult (*DecodePicture)(CUvideodecoder, void*);
  CUresult (*MapVideoFrame64)(CUvideodecoder, int, unsigned long long*, unsigned int*,
                              CUVIDPROCPARAMS*);
  CUresult (*UnmapVideoFrame64)(CUvideodecoder, unsigned long long);
  CUresult (*CtxLockCreate)(CUvideoctxlock*, CUcontext);
  CUresult (*CtxLockDestroy)(CUvideoctxlock);
  CUresult (*CreateVideoParser)(CUvideoparser*, CUVIDPARSERPARAMS*);
  CUresult (*ParseVideoData)(CUvideoparser, CUVIDSOURCEDATAPACKET*);
  CUresult (*DestroyVideoParser)(CUvideoparser);
};

Api g_api;
std::string g_api_error;
int g_api_rc = 0;  // -1 libnvcuvid.so.1 did not load, -2 it lacks an entry
std::once_flag g_api_once;
thread_local std::string g_err;

int fail(int code, const std::string& msg) {
  g_err = msg;
  return code;
}

bool load_api() {
  std::call_once(g_api_once, [] {
    void* h = dlopen("libnvcuvid.so.1", RTLD_NOW | RTLD_LOCAL);
    if (!h) {
      const char* e = dlerror();
      g_api_error = std::string("dlopen(\"libnvcuvid.so.1\") failed: ") + (e ? e : "?");
      g_api_rc = -1;
      return;
    }
    struct {
      const char* name;
      void** slot;
    } syms[] = {{"cuvidGetDecoderCaps", (void**)&g_api.GetDecoderCaps},
                {"cuvidCreateDecoder", (void**)&g_api.CreateDecoder},
                {"cuvidDestroyDecoder", (void**)&g_api.DestroyDecoder},
                {"cuvidDecodePicture", (void**)&g_api.DecodePicture},
                {"cuvidMapVideoFrame64", (void**)&g_api.MapVideoFrame64},
                {"cuvidUnmapVideoFrame64", (void**)&g_api.UnmapVideoFrame64},
                {"cuvidCtxLockCreate", (void**)&g_api.CtxLockCreate},
                {"cuvidCtxLockDestroy", (void**)&g_api.CtxLockDestroy},
                {"cuvidCreateVideoParser", (void**)&g_api.CreateVideoParser},
                {"cuvidParseVideoData", (void**)&g_api.ParseVideoData},
                {"cuvidDestroyVideoParser", (void**)&g_api.DestroyVideoParser}};
    for (auto& s : syms) {
      *s.slot = dlsym(h, s.name);
      if (!*s.slot) {
        g_api_error = std::string("libnvcuvid.so.1 lacks ") + s.name;
        g_api_rc = -2;
        return;
      }
    }
  });
  if (!g_api_error.empty()) g_err = g_api_error;
  return g_api_error.empty();
}

std::string cu_msg(const char* what, CUresult r) {
  const char* name = nullptr;
  const char* text = nullptr;
  cuGetErrorName(r, &name);
  cuGetErrorString(r, &text);
  return std::string(what) + " failed: " + std::to_string((int)r) + " " + (name ? name : "") +
         " (" + (text ? text : "") + ")";
}

#define CU_TRY(call)                                          \
  do {                                                        \
    CUresult r_ = (call);                                     \
    if (r_ != CUDA_SUCCESS) return fail(-2, cu_msg(#call, r_)); \
  } while (0)

// the primary context pushed for the scope of an entry
struct Pushed {
  bool ok;
  explicit Pushed(CUcontext c) : ok(cuCtxPushCurrent(c) == CUDA_SUCCESS) {}
  ~Pushed() {
    CUcontext tmp;
    if (ok) cuCtxPopCurrent(&tmp);
  }
};

struct Decoder {
  CUdevice dev = 0;
  CUcontext ctx = nullptr;
  CUvideoctxlock lock = nullptr;
  CUvideodecoder dec = nullptr;
  CUVIDDECODECREATEINFO made;  // the decoder's creation parameters
  CUVIDEOFORMAT fmt;           // the last sequence callback's format
  // one decode call
  int want_coded_w = 0, want_coded_h = 0, want_w = 0, want_h = 0;
  const int64_t* wanted = nullptr;
  int n_wanted = 0;
  std::vector<char> filled;
  CUdeviceptr out = 0;
  CUstream stream = nullptr;  // the caller's
  int err = 0;
  std::string msg;
  std::vector<int64_t> shown;  // the display callback's timestamps, in its order

  int error(int code, const std::string& m) {
    if (!err) {
      err = code;
      msg = m;
    }
    return 0;  // stops the parser
  }
};

int sequence_cb(void* user, CUVIDEOFORMAT* f) {
  Decoder* d = (Decoder*)user;
  d->fmt = *f;
  const int w = f->display_area.right - f->display_area.left;
  const int h = f->display_area.bottom - f->display_area.top;
  if (f->codec != kCodecH264 || f->chroma_format != kChroma420 || f->bit_depth_luma_minus8 ||
      f->bit_depth_chroma_minus8)
    return d->error(-2, "NVDEC's parser reports codec " + std::to_string(f->codec) + ", chroma " +
                            std::to_string(f->chroma_format) + ", luma bits 8+" +
                            std::to_string(f->bit_depth_luma_minus8) +
                            ": not the 8-bit 4:2:0 H.264 the demuxer read");
  if ((int)f->coded_width != d->want_coded_w || (int)f->coded_height != d->want_coded_h ||
      w != d->want_w || h != d->want_h)
    return d->error(-2, "NVDEC's parser reports coded " + std::to_string(f->coded_width) + "x" +
                            std::to_string(f->coded_height) + ", display " + std::to_string(w) +
                            "x" + std::to_string(h) + "; the demuxer's SPS says coded " +
                            std::to_string(d->want_coded_w) + "x" +
                            std::to_string(d->want_coded_h) + ", display " +
                            std::to_string(d->want_w) + "x" + std::to_string(d->want_h));
  const int surfaces = std::max<int>(f->min_num_decode_surfaces, 1);
  if (d->dec) {
    if ((int)d->made.ulWidth == (int)f->coded_width &&
        (int)d->made.ulHeight == (int)f->coded_height &&
        (int)d->made.ulNumDecodeSurfaces >= surfaces)
      return (int)d->made.ulNumDecodeSurfaces;
    g_api.DestroyDecoder(d->dec);
    d->dec = nullptr;
  }
  CUVIDDECODECREATEINFO ci;
  std::memset(&ci, 0, sizeof ci);
  ci.ulWidth = f->coded_width;
  ci.ulHeight = f->coded_height;
  ci.ulNumDecodeSurfaces = (unsigned long)surfaces;
  ci.CodecType = kCodecH264;
  ci.ChromaFormat = kChroma420;
  ci.ulCreationFlags = kCreatePreferCUVID;
  ci.bitDepthMinus8 = 0;
  ci.ulMaxWidth = f->coded_width;
  ci.ulMaxHeight = f->coded_height;
  ci.display_area.left = (short)f->display_area.left;
  ci.display_area.top = (short)f->display_area.top;
  ci.display_area.right = (short)f->display_area.right;
  ci.display_area.bottom = (short)f->display_area.bottom;
  ci.OutputFormat = kSurfaceNV12;
  ci.DeinterlaceMode = kDeinterlaceWeave;
  ci.ulTargetWidth = (unsigned long)w;
  ci.ulTargetHeight = (unsigned long)h;
  ci.ulNumOutputSurfaces = 2;
  ci.vidLock = d->lock;
  CUresult r = g_api.CreateDecoder(&d->dec, &ci);
  if (r != CUDA_SUCCESS) {
    d->dec = nullptr;
    return d->error(-2, cu_msg("cuvidCreateDecoder", r));
  }
  d->made = ci;
  return surfaces;
}

int decode_cb(void* user, void* pic) {
  Decoder* d = (Decoder*)user;
  if (!d->dec) return d->error(-2, "a picture before any sequence header");
  CUresult r = g_api.DecodePicture(d->dec, pic);
  return r == CUDA_SUCCESS ? 1 : d->error(-2, cu_msg("cuvidDecodePicture", r));
}

int display_cb(void* user, CUVIDPARSERDISPINFO* info) {
  Decoder* d = (Decoder*)user;
  if (!info) return 1;  // end of stream
  d->shown.push_back(info->timestamp);
  const int64_t* at = std::lower_bound(d->wanted, d->wanted + d->n_wanted, info->timestamp);
  if (at == d->wanted + d->n_wanted || *at != info->timestamp) return 1;  // not wanted
  const size_t slot = (size_t)(at - d->wanted);
  if (d->filled[slot]) return 1;
  CUVIDPROCPARAMS vpp;
  std::memset(&vpp, 0, sizeof vpp);
  vpp.progressive_frame = info->progressive_frame;
  vpp.top_field_first = info->top_field_first;
  vpp.second_field = info->repeat_first_field + 1;
  vpp.unpaired_field = info->repeat_first_field < 0;
  vpp.output_stream = d->stream;
  unsigned long long src = 0;
  unsigned int pitch = 0;
  CUresult r = g_api.MapVideoFrame64(d->dec, info->picture_index, &src, &pitch, &vpp);
  if (r != CUDA_SUCCESS) return d->error(-2, cu_msg("cuvidMapVideoFrame64", r));
  const size_t w = (size_t)d->want_w, h = (size_t)d->want_h;
  CUDA_MEMCPY2D m;
  std::memset(&m, 0, sizeof m);
  m.srcMemoryType = CU_MEMORYTYPE_DEVICE;
  m.srcDevice = (CUdeviceptr)src;
  m.srcPitch = pitch;
  m.dstMemoryType = CU_MEMORYTYPE_DEVICE;
  m.dstDevice = d->out + slot * w * h * 3 / 2;
  m.dstPitch = w;
  m.WidthInBytes = w;
  m.Height = h;
  r = cuMemcpy2DAsync(&m, d->stream);
  if (r == CUDA_SUCCESS) {
    // the chroma plane follows the luma's rows, rounded up to even
    m.srcDevice = (CUdeviceptr)(src + (unsigned long long)pitch * ((h + 1) & ~(size_t)1));
    m.dstDevice += w * h;
    m.Height = h / 2;
    r = cuMemcpy2DAsync(&m, d->stream);
  }
  if (r == CUDA_SUCCESS) r = cuStreamSynchronize(d->stream);
  CUresult ru = g_api.UnmapVideoFrame64(d->dec, src);
  if (r != CUDA_SUCCESS) return d->error(-2, cu_msg("copying a decoded frame", r));
  if (ru != CUDA_SUCCESS) return d->error(-2, cu_msg("cuvidUnmapVideoFrame64", ru));
  d->filled[slot] = 1;
  return 1;
}

// ------------------------------------------------------ NV12 → RGB24 kernel

}  // namespace

// the C entry's argument (outside the unnamed namespace: the entry is exported)
struct Nv12Args {
  const uint8_t* src;  // n frames of (h + h/2) rows × pitch bytes
  uint8_t* out;        // n × oh × ow × 3
  const int* hl_pos;
  const int* hl_coef;
  const int* vl_pos;
  const int* vl_coef;
  const int* hc_pos;
  const int* hc_coef;
  const int* vc_pos;
  const int* vc_coef;
  const int* mode;        // per output row: 1 yuv2packed1, 2 yuv2packed2, 0 yuv2packedX
  const int* chroma_pair;  // per output row: yuv2packed1 averages two chroma rows
  int n, w, h, pitch, ow, oh;
  int hl_size, vl_size, hc_size, vc_size;
  int native, simd_w;
  int y_off, y_coef, vr, ub, ug, vg;           // the unscaled converter
  int cy, oy, yoffs, crv, cbu, cgu, cgv;       // the resize path's tables
};

namespace {

__device__ __forceinline__ int clip8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// swscale's hScale8To15 at output sample x of one row (step 2: a plane of NV12's UV)
__device__ __forceinline__ int hscale(const uint8_t* row, int step, const int* pos,
                                      const int* coef, int size, int x) {
  const int p = pos[x];
  const int* c = coef + x * size;
  int v = 0;
  for (int t = 0; t < size; t++) v += (int)row[(p + t) * step] * c[t];
  return min(v >> 7, (1 << 15) - 1);
}

// the vertical pass of one output row at column x: 15-bit rows → 0..255
__device__ __forceinline__ int vscale(const uint8_t* plane, int pitch, int step, const int* hpos,
                                      const int* hcoef, int hsize, int x, const int* vpos,
                                      const int* vcoef, int vsize, int oy, int mode, int pair) {
  const int p = vpos[oy];
  const int* c = vcoef + oy * vsize;
  int v;
  if (mode == 1) {
    const int r0 = hscale(plane + (size_t)p * pitch, step, hpos, hcoef, hsize, x);
    if (pair) {
      const int r1 = hscale(plane + (size_t)(p + 1) * pitch, step, hpos, hcoef, hsize, x);
      v = (r0 + r1 + 128) >> 8;
    } else {
      v = (r0 + 64) >> 7;
    }
  } else if (mode == 2) {
    const int r0 = hscale(plane + (size_t)p * pitch, step, hpos, hcoef, hsize, x);
    const int r1 = hscale(plane + (size_t)(p + 1) * pitch, step, hpos, hcoef, hsize, x);
    v = (r0 * (4096 - c[1]) + r1 * c[1]) >> 19;
  } else {
    int acc = 1 << 18;
    for (int j = 0; j < vsize; j++)
      acc += hscale(plane + (size_t)(p + j) * pitch, step, hpos, hcoef, hsize, x) * c[j];
    v = acc >> 19;
  }
  return clip8(v);
}

__device__ __forceinline__ int table(const Nv12Args& a, int j) {
  return clip8((int)(((long long)j * a.cy - (384LL << 16) - a.oy + 0x8000) >> 16));
}

__device__ __forceinline__ int offset(int c, int k) { return ((c * k) >> 16) - (k >> 9); }

__global__ void nv12_rgb_kernel(Nv12Args a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int f = blockIdx.z;
  if (x >= a.ow || y >= a.oh) return;
  const uint8_t* luma = a.src + (size_t)f * a.pitch * (a.h + a.h / 2);
  const uint8_t* uv = luma + (size_t)a.pitch * a.h;
  uint8_t* d = a.out + (((size_t)f * a.oh + y) * a.ow + x) * 3;
  int r, g, b;
  if (a.native) {  // swscale's unscaled x86 converter, 8-pixel blocks only
    if (x >= a.simd_w) {
      d[0] = d[1] = d[2] = 0;
      return;
    }
    const int Y = luma[(size_t)y * a.pitch + x];
    const uint8_t* c = uv + (size_t)(y >> 1) * a.pitch + (x & ~1);
    const int du = ((int)c[0] - 128) * 8, dv = ((int)c[1] - 128) * 8;
    const int yl = ((Y * 8 - a.y_off) * a.y_coef) >> 16;
    r = clip8(yl + ((dv * a.vr) >> 16));
    g = clip8(yl + ((du * a.ug) >> 16) + ((dv * a.vg) >> 16));
    b = clip8(yl + ((du * a.ub) >> 16));
  } else {  // swscale's bilinear resize, then its yuv2rgb tables
    const int mode = a.mode[y], pair = a.chroma_pair[y];
    const int Y = vscale(luma, a.pitch, 1, a.hl_pos, a.hl_coef, a.hl_size, x, a.vl_pos,
                         a.vl_coef, a.vl_size, y, mode, 0);
    const int cx = x >> 1;
    const int U = vscale(uv, a.pitch, 2, a.hc_pos, a.hc_coef, a.hc_size, cx, a.vc_pos,
                         a.vc_coef, a.vc_size, y, mode, pair);
    const int V = vscale(uv + 1, a.pitch, 2, a.hc_pos, a.hc_coef, a.hc_size, cx, a.vc_pos,
                         a.vc_coef, a.vc_size, y, mode, pair);
    const int base = a.yoffs + Y;
    r = table(a, base + offset(V, a.crv));
    g = table(a, base + offset(U, a.cgu) + offset(V, a.cgv));
    b = table(a, base + offset(U, a.cbu));
  }
  d[0] = (uint8_t)r;
  d[1] = (uint8_t)g;
  d[2] = (uint8_t)b;
}

}  // namespace

extern "C" {

const char* oatx_nvdec_error() { return g_err.c_str(); }

const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// NVDEC's caps for 8-bit 4:2:0 H.264 in the current context; -1 for the
// result a container without the video capability gives, -2 for any other
// failure.
static int h264_caps(CUVIDDECODECAPS* c) {
  std::memset(c, 0, sizeof *c);
  c->eCodecType = kCodecH264;
  c->eChromaFormat = kChroma420;
  c->nBitDepthMinus8 = 0;
  CUresult r = g_api.GetDecoderCaps(c);
  if (r != CUDA_SUCCESS)
    return fail(r == CUDA_ERROR_OUT_OF_MEMORY ? -1 : -2,
                cu_msg("cuvidGetDecoderCaps(H.264, 4:2:0, 8-bit)", r));
  return 0;
}

// Retain device `device`'s primary context (torch's) → 0 and the context.
static int primary(int device, CUdevice* dev, CUcontext* ctx) {
  CU_TRY(cuInit(0));
  CU_TRY(cuDeviceGet(dev, device));
  CU_TRY(cuDevicePrimaryCtxRetain(ctx, *dev));
  return 0;
}

// NVDEC's capabilities for 8-bit 4:2:0 H.264 on `device`: caps[0..7] =
// bIsSupported, nNumNVDECs, nOutputFormatMask, nMaxWidth, nMaxHeight,
// nMaxMBCount, nMinWidth, nMinHeight.
int oatx_nvdec_caps(int device, int* caps) {
  if (!load_api()) return g_api_rc;
  CUdevice dev;
  CUcontext ctx;
  int rc = primary(device, &dev, &ctx);
  if (rc) return rc;
  int out = 0;
  {
    Pushed p(ctx);
    CUVIDDECODECAPS c;
    out = p.ok ? h264_caps(&c) : fail(-2, "cuCtxPushCurrent failed");
    if (!out) {
      const int v[8] = {c.bIsSupported, c.nNumNVDECs, c.nOutputFormatMask, (int)c.nMaxWidth,
                        (int)c.nMaxHeight, (int)c.nMaxMBCount, c.nMinWidth, c.nMinHeight};
      std::copy(v, v + 8, caps);
    }
  }
  cuDevicePrimaryCtxRelease(dev);
  return out;
}

// A decoder on `device` (its context lock; the NVDEC decoder is made by
// the first sequence header) → handle, or NULL with *rc set.
void* oatx_nvdec_open(int device, int* rc) {
  *rc = 0;
  if (!load_api()) {
    *rc = g_api_rc;
    return nullptr;
  }
  Decoder* d = new Decoder();
  *rc = primary(device, &d->dev, &d->ctx);
  if (*rc) {
    delete d;
    return nullptr;
  }
  Pushed p(d->ctx);
  CUVIDDECODECAPS c;
  CUresult r = p.ok ? g_api.CtxLockCreate(&d->lock, d->ctx) : CUDA_ERROR_INVALID_CONTEXT;
  if (r != CUDA_SUCCESS) {
    *rc = fail(-2, cu_msg("cuvidCtxLockCreate", r));
  } else if ((*rc = h264_caps(&c)) == 0 && !c.bIsSupported) {
    *rc = fail(-2, "cuvidGetDecoderCaps succeeded but does not support H.264 8-bit 4:2:0");
  }
  if (*rc) {
    if (d->lock) g_api.CtxLockDestroy(d->lock);
    cuDevicePrimaryCtxRelease(d->dev);
    delete d;
    return nullptr;
  }
  return d;
}

void oatx_nvdec_close(void* h) {
  Decoder* d = (Decoder*)h;
  if (!d) return;
  {
    Pushed p(d->ctx);
    if (d->dec) g_api.DestroyDecoder(d->dec);
  }
  if (d->lock) g_api.CtxLockDestroy(d->lock);
  cuDevicePrimaryCtxRelease(d->dev);
  delete d;
}

// Decode the plan's segments (bytes, pkt_end, pkt_ts, seg_end: mp4.h's
// H264Plan) and copy each of the `n_wanted` display indices `wanted`
// (sorted) as packed NV12 (w × h luma, then w × h/2 interleaved chroma) to
// `out` + slot · w·h·3/2, a device buffer, on `stream` (synchronized before
// each surface is unmapped). geom = coded w, coded h, w, h as the demuxer
// read them. Returns 0 when every wanted frame was copied.
int oatx_nvdec_decode(void* h, const uint8_t* bytes, const int64_t* pkt_end,
                      const int64_t* pkt_ts, int n_pkt, const int32_t* seg_end, int n_seg,
                      const int64_t* wanted, int n_wanted, void* out, const int* geom,
                      void* stream) {
  Decoder* d = (Decoder*)h;
  if (n_seg <= 0 || seg_end[n_seg - 1] != n_pkt) return fail(-2, "a malformed decode plan");
  Pushed p(d->ctx);
  if (!p.ok) return fail(-2, "cuCtxPushCurrent failed");
  d->stream = (CUstream)stream;
  d->want_coded_w = geom[0];
  d->want_coded_h = geom[1];
  d->want_w = geom[2];
  d->want_h = geom[3];
  d->wanted = wanted;
  d->n_wanted = n_wanted;
  d->filled.assign((size_t)n_wanted, 0);
  d->out = (CUdeviceptr)out;
  d->err = 0;
  d->msg.clear();
  d->shown.clear();
  int first = 0;
  for (int s = 0; s < n_seg && !d->err; s++) {
    CUVIDPARSERPARAMS pp;
    std::memset(&pp, 0, sizeof pp);
    pp.CodecType = kCodecH264;
    pp.ulMaxNumDecodeSurfaces = 1;  // raised by the sequence callback's return
    pp.ulMaxDisplayDelay = 0;
    pp.pUserData = d;
    pp.pfnSequenceCallback = sequence_cb;
    pp.pfnDecodePicture = decode_cb;
    pp.pfnDisplayPicture = display_cb;
    CUvideoparser parser = nullptr;
    CUresult r = g_api.CreateVideoParser(&parser, &pp);
    if (r != CUDA_SUCCESS) return fail(-2, cu_msg("cuvidCreateVideoParser", r));
    for (int i = first; i < seg_end[s] && !d->err; i++) {
      const int64_t b0 = i ? pkt_end[i - 1] : 0;
      CUVIDSOURCEDATAPACKET pkt;
      std::memset(&pkt, 0, sizeof pkt);
      pkt.flags = kPktTimestamp;
      pkt.payload = bytes + b0;
      pkt.payload_size = (unsigned long)(pkt_end[i] - b0);
      pkt.timestamp = pkt_ts[i];
      r = g_api.ParseVideoData(parser, &pkt);
      if (r != CUDA_SUCCESS && !d->err) d->error(-3, cu_msg("cuvidParseVideoData", r));
    }
    if (!d->err) {  // drain the reorder queue
      CUVIDSOURCEDATAPACKET eos;
      std::memset(&eos, 0, sizeof eos);
      eos.flags = kPktEndOfStream;
      r = g_api.ParseVideoData(parser, &eos);
      if (r != CUDA_SUCCESS && !d->err) d->error(-3, cu_msg("cuvidParseVideoData (end)", r));
    }
    g_api.DestroyVideoParser(parser);
    first = seg_end[s];
  }
  if (d->err) return fail(d->err, d->msg);
  std::string missing;
  for (int k = 0; k < n_wanted; k++)
    if (!d->filled[(size_t)k]) missing += " " + std::to_string(wanted[k]);
  if (!missing.empty()) {
    std::string shown;
    for (size_t k = 0; k < d->shown.size() && k < 64; k++) shown += " " + std::to_string(d->shown[k]);
    return fail(-2, "NVDEC displayed " + std::to_string(d->shown.size()) + " frames (timestamps" +
                        shown + ") but not the wanted display indices" + missing);
  }
  return 0;
}

// The last sequence header NVDEC's parser reported: info[0..11] = codec,
// coded w, coded h, display left, top, right, bottom, chroma format, luma
// bit depth − 8, video_full_range_flag, min_num_decode_surfaces, and the
// decode surfaces the decoder was made with.
void oatx_nvdec_format(void* h, int* info) {
  Decoder* d = (Decoder*)h;
  const CUVIDEOFORMAT& f = d->fmt;
  const int v[12] = {f.codec, (int)f.coded_width, (int)f.coded_height, f.display_area.left,
                     f.display_area.top, f.display_area.right, f.display_area.bottom,
                     f.chroma_format, f.bit_depth_luma_minus8,
                     f.video_signal_description.video_full_range_flag,
                     f.min_num_decode_surfaces, (int)d->made.ulNumDecodeSurfaces};
  std::copy(v, v + 12, info);
}

// nv12_rgb_kernel over a->n frames on `stream`; → cudaGetLastError().
int oatx_nv12_rgb(const Nv12Args* a, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((a->ow + 31) / 32, (a->oh + 7) / 8, a->n);
  nv12_rgb_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
