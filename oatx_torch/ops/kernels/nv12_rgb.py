"""NV12 → packed RGB24, at the native size or resized, as oatx's reader.

Replaces no TPU kernel: oatx decodes on the host with FFmpeg and converts
with swscale (oatx/native/oatx_decode.cpp, IndexDecode: `sws_getContext(w,
h, yuv420p, ow, oh, AV_PIX_FMT_RGB24, SWS_BILINEAR)`, :130-205). The port
decodes H.264 on the card's NVDEC, whose surfaces are NV12 in device
memory, so the conversion is a kernel of its own (csrc/nvdec.cu,
`nv12_rgb_kernel`), launched once per decode call over every wanted frame.

The arithmetic is swscale's, in integers, as the host decoder already does
it for JPEG (native/decode.cpp `to_rgb`): BT.601 always (oatx never calls
sws_setColorspaceDetails, so the VUI's matrix is ignored), limited range
unless the SPS sets video_full_range_flag (FFmpeg then decodes to
yuvj420p). At the native size, swscale's unscaled x86 converter: 16-bit
fixed point, (Y·8 − yoff)·ycoef and (C − 128)·8·coef, each product's high
16 bits, chroma repeated over each 2×2 block; it converts whole blocks of
8 pixels only, and oatx returns the last w mod 8 columns black
(`simd_width`). Resized: swscale's bilinear
filters (`video_reader.bilinear_filter`, 14-bit horizontal taps to 15-bit
samples, 12-bit vertical taps), the vertical pass chosen per output row as
yuv2packed1 / 2 / X choose it, one chroma sample per two output pixels,
then swscale's yuv2rgb tables (`colour_constants`).

What bounds it on an H100: bytes. A frame reads 1.5 bytes a source pixel
and writes 3 an output pixel; the kernel recomputes the horizontal taps of
every vertical tap in registers, a few integer multiply-adds a byte.
Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6,
chip_smoke.py phase 18): 0.0302 ms for 4 frames of 596×336 to 454×256
(the bound 0.0008 ms: the launch dominates), 0.0525-0.1596 ms for 50
frames at the native size and at short sides 224 / 256 (4-16× the bound).

`nv12_to_rgb_plain` is the same arithmetic in PyTorch (the CPU tests, and
the card's reference in chip_smoke.py). `nv12_to_rgb` launches the kernel
for a CUDA tensor and runs the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import numpy as np
import torch

from oatx_torch.ops.kernels import _build

_count_lock = threading.Lock()

# swscale's BT.601 inverse coefficients (ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]:
# crv, cbu, cgu, cgv at 16 fractional bits) and its luma gain for limited
# range (255 / 219 at 16 bits)
_CRV, _CBU, _CGU, _CGV = 104597, 132201, -25675, -53279
_CY_LIMITED = (65536 * 255) // 219


def _div0(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _round16(x: int) -> int:
    return (x + 32768) >> 16  # swscale's roundToInt16


def colour_constants(full_range: bool) -> Tuple[int, ...]:
    """ff_yuv2rgb_c_init_tables' constants → (y_off, y_coef, vr, ub, ug,
    vg) of the unscaled converter (13-bit coefficients of each product's
    high 16 bits) and (cy, oy, yoffs, crv, cbu, cgu, cgv) of the resize
    path's tables: channel = T(yoffs + Y + off(C)), off(C) = (C·c >> 16) −
    (c >> 9), T(j) = clip((j·cy − 384·2^16 − oy + 2^15) >> 16)."""
    c = [_CRV, _CBU, _CGU, _CGV]
    cy, oy, yoffs = 1 << 16, 0, 384
    if full_range:
        c = [_div0(v * 224, 255) for v in c]
    else:
        cy, oy, yoffs = _CY_LIMITED, 16 << 16, 326
    simd = (_round16(oy * 8), _round16(cy * 8192)) + tuple(_round16(v * 8192) for v in c)
    scaled = (cy, oy, yoffs) + tuple(_div0(v * 65536 + 0x8000, cy) for v in c)
    return simd + scaled


def simd_width(w: int) -> int:
    """The columns swscale's x86 unscaled converter writes: whole blocks of
    8 pixels that fit the row (YUV2RGB_LOOP's h_size). The rest of each row
    is left as oatx's zero-filled scratch buffer holds it: black."""
    return w & ~7


class Filters:
    """The resize's four bilinear filters (luma and chroma, horizontal and
    vertical; pos int32 (dst,), coef int32 (dst, size)) and the vertical
    pass of each output row: 1 yuv2packed1, 2 yuv2packed2, 0 yuv2packedX."""

    def __init__(self, w: int, h: int, ow: int, oh: int):
        from oatx_torch.data.video_reader import bilinear_filter

        cow = (ow + 1) >> 1
        self.hl = bilinear_filter(w, ow, 1 << 14, 4)
        self.vl = bilinear_filter(h, oh, 1 << 12, 2)
        self.hc = bilinear_filter(w // 2, cow, 1 << 14, 4)
        self.vc = bilinear_filter(h // 2, oh, 1 << 12, 2)
        lc, cc = self.vl[1], self.vc[1]
        ls, cs = lc.shape[1], cc.shape[1]
        l2 = (lc[:, 0] + lc[:, 1] == 4096) if ls == 2 else np.zeros(oh, bool)
        c2 = (cc[:, 0] + cc[:, 1] == 4096) if cs == 2 else np.zeros(oh, bool)
        one = (ls == 1) & ((cs == 1) | c2)
        self.mode = np.where(one, 1, np.where(l2 & c2, 2, 0)).astype(np.int32)
        # yuv2packed1's chroma: one row, or the mean of two when the second weighs more
        self.chroma_pair = (cs == 2) & (cc[:, 1] >= 2048) if cs == 2 else np.zeros(oh, bool)

    def arrays(self):
        """(pos, coef) of hl, vl, hc, vc, then mode, chroma_pair, as int32."""
        out = []
        for pos, coef in (self.hl, self.vl, self.hc, self.vc):
            out += [pos, coef]
        return out + [self.mode, self.chroma_pair.astype(np.int32)]


@functools.lru_cache(maxsize=64)
def filters(w: int, h: int, ow: int, oh: int) -> Filters:
    return Filters(w, h, ow, oh)


def _check(nv12: torch.Tensor, out_w: int, out_h: int) -> Tuple[int, int, int]:
    if nv12.dtype != torch.uint8 or nv12.dim() != 3:
        raise ValueError(f"nv12_to_rgb takes uint8 (n, 3·h/2, w), got {nv12.dtype} "
                         f"{tuple(nv12.shape)}")
    n, rows, w = nv12.shape
    h = rows * 2 // 3
    if rows != h * 3 // 2 or h % 2 or w % 2 or h == 0 or w == 0:
        raise ValueError(f"nv12_to_rgb: {tuple(nv12.shape)} is no NV12 frame of even size")
    if out_w <= 0 or out_h <= 0 or out_w % 2 or out_h % 2:
        raise ValueError(f"nv12_to_rgb: output {out_w}×{out_h} is not a positive even size")
    return n, h, w


def _hscale(rows: torch.Tensor, pos, coef) -> torch.Tensor:
    """swscale's hScale8To15 over the last axis: 14-bit taps, 15-bit out."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=rows.device)
    coef = torch.as_tensor(coef, dtype=torch.int32, device=rows.device)
    idx = pos[:, None] + torch.arange(coef.shape[1], device=rows.device)[None]
    taps = rows[..., idx].int()  # (..., dst, size)
    return ((taps * coef).sum(-1) >> 7).clamp_max((1 << 15) - 1)


def _vscale(planes: torch.Tensor, pos, coef, mode, pair) -> torch.Tensor:
    """The vertical pass of yuv2packed1 / 2 / X on 15-bit rows (n, H, W) →
    (n, oh, W) in 0..255; `pair`: yuv2packed1's two-row chroma mean (None
    for luma)."""
    dev = planes.device
    pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
    coef = torch.as_tensor(coef, dtype=torch.int32, device=dev)
    size = coef.shape[1]
    rows = [planes[:, (pos + j).clamp_max(planes.shape[1] - 1)] for j in range(size)]
    w = [coef[:, j, None] for j in range(size)]
    x = (1 << 18) + sum(r * c for r, c in zip(rows, w))
    out = x >> 19
    one = (rows[0] + 64) >> 7
    if pair is not None and size == 2:
        two_rows = (rows[0] + rows[1] + 128) >> 8
        one = torch.where(torch.as_tensor(pair, device=dev)[:, None].bool(), two_rows, one)
    mode = torch.as_tensor(mode, device=dev)[:, None]
    out = torch.where(mode == 1, one, out)
    if size == 2:
        bil = (rows[0] * (4096 - w[1]) + rows[1] * w[1]) >> 19
        out = torch.where(mode == 2, bil, out)
    return out.clamp(0, 255)


def nv12_to_rgb_plain(nv12: torch.Tensor, out_w: int, out_h: int,
                      full_range: bool) -> torch.Tensor:
    """NV12 frames (n, 3·h/2, w) uint8 → RGB24 (n, out_h, out_w, 3) uint8,
    swscale's arithmetic (module docstring)."""
    n, h, w = _check(nv12, out_w, out_h)
    y_off, y_coef, vr, ub, ug, vg, cy, oy, yoffs, crv, cbu, cgu, cgv = \
        colour_constants(full_range)
    y = nv12[:, :h].int()
    uv = nv12[:, h:].int()
    u, v = uv[..., 0::2], uv[..., 1::2]
    if out_w == w and out_h == h:  # the unscaled converter
        u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
        v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
        yl = ((y * 8 - y_off) * y_coef) >> 16
        du, dv = (u - 128) * 8, (v - 128) * 8
        r = yl + ((dv * vr) >> 16)
        g = yl + ((du * ug) >> 16) + ((dv * vg) >> 16)
        b = yl + ((du * ub) >> 16)
        out = torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)
        out[:, :, simd_width(w):] = 0
        return out
    f = filters(w, h, out_w, out_h)
    lum = _vscale(_hscale(y, *f.hl), *f.vl, f.mode, None)
    cu = _vscale(_hscale(u, *f.hc), *f.vc, f.mode, f.chroma_pair)
    cv = _vscale(_hscale(v, *f.hc), *f.vc, f.mode, f.chroma_pair)
    cu = cu.repeat_interleave(2, 2)[..., :out_w]
    cv = cv.repeat_interleave(2, 2)[..., :out_w]

    def off(c, k):
        return ((c * k) >> 16) - (k >> 9)

    def table(j):
        return ((j.long() * cy - (384 << 16) - oy + 0x8000) >> 16).clamp(0, 255)

    base = yoffs + lum
    r = table(base + off(cv, crv))
    g = table(base + off(cu, cgu) + off(cv, cgv))
    b = table(base + off(cu, cbu))
    return torch.stack([r, g, b], -1).to(torch.uint8)


class _Args(ctypes.Structure):
    """csrc/nvdec.cu's Nv12Args."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "src", "out", "hl_pos", "hl_coef", "vl_pos", "vl_coef", "hc_pos", "hc_coef", "vc_pos",
        "vc_coef", "mode", "chroma_pair")]
        + [(k, ctypes.c_int) for k in (
            "n", "w", "h", "pitch", "ow", "oh", "hl_size", "vl_size", "hc_size", "vc_size",
            "native", "simd_w", "y_off", "y_coef", "vr", "ub", "ug", "vg", "cy", "oy", "yoffs",
            "crv", "cbu", "cgu", "cgv")])


def _lib():
    lib = _build.load("nvdec")
    f = lib.oatx_nv12_rgb
    if f.argtypes is None:
        f.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


_device_filters = {}
_device_lock = threading.Lock()


def _filters_on(w: int, h: int, ow: int, oh: int, dev: torch.device):
    """The filters' int32 arrays on `dev`, made once per geometry."""
    key = (w, h, ow, oh, str(dev))
    with _device_lock:
        got = _device_filters.get(key)
        if got is None:
            got = [torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)
                   for a in filters(w, h, ow, oh).arrays()]
            _device_filters[key] = got
        return got


def _launch(nv12: torch.Tensor, out_w: int, out_h: int, full_range: bool) -> torch.Tensor:
    n, h, w = _check(nv12, out_w, out_h)
    nv12 = nv12.contiguous()
    dev = nv12.device
    out = torch.empty((n, out_h, out_w, 3), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    native = out_w == w and out_h == h
    a = _Args(src=nv12.data_ptr(), out=out.data_ptr(), n=n, w=w, h=h, pitch=w, ow=out_w,
              oh=out_h, native=int(native), simd_w=simd_width(w))
    (a.y_off, a.y_coef, a.vr, a.ub, a.ug, a.vg, a.cy, a.oy, a.yoffs, a.crv, a.cbu, a.cgu,
     a.cgv) = colour_constants(full_range)
    if not native:
        arrs = _filters_on(w, h, out_w, out_h, dev)
        names = ("hl_pos", "hl_coef", "vl_pos", "vl_coef", "hc_pos", "hc_coef", "vc_pos",
                 "vc_coef", "mode", "chroma_pair")
        for name, t in zip(names, arrs):
            setattr(a, name, t.data_ptr())
        a.hl_size, a.vl_size, a.hc_size, a.vc_size = (arrs[i].shape[1] for i in (1, 3, 5, 7))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.oatx_nv12_rgb(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "nv12_rgb")
    with _count_lock:
        nv12_to_rgb.launches += 1
    return out


def nv12_to_rgb(nv12: torch.Tensor, out_w: int, out_h: int, full_range: bool) -> torch.Tensor:
    """NV12 frames (n, 3·h/2, w) uint8 → RGB24 (n, out_h, out_w, 3) uint8:
    the kernel on a CUDA tensor (one launch for all n), the plain version on
    a CPU tensor."""
    if nv12.is_cuda:
        return _launch(nv12, out_w, out_h, full_range)
    return nv12_to_rgb_plain(nv12, out_w, out_h, full_range)


nv12_to_rgb.launches = 0
