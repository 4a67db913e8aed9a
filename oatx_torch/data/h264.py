"""H.264 in mp4 / mov: decoded on the host, converted to RGB on the card.

The port of oatx's FFmpeg H.264 path (oatx/native/oatx_decode.cpp,
decode_seek_stepping: avcodec_send_packet / avcodec_receive_frame, then
sws_scale). The host demuxer (native/mp4.cpp) plans the Annex B segments
that decode the wanted display indices (an open GOP's from the IDR picture
before the recovery point, as oatx's sequential read decodes them); the
port's own decoder (native/h264.h: CAVLC and CABAC, I, P and B slices,
written from ITU-T H.264) runs them
in native code with the GIL released and writes each wanted picture as
NV12, cropped to the SPS's window, into a pinned host buffer. One copy
takes it to the card and one launch of the NV12 → RGB kernel
(ops/kernels/nv12_rgb.py) converts every frame, at the native or the
short-side size, on the calling thread's own stream (nvdec._stream), so
the loader's threads do not queue behind the training step. Frames come
back as oatx's reader returns them: uint8 RGB (n, H, W, 3) on the host,
indices past the end standing for the last frame.

`device`: None names the card (oatx_torch.resolve_device; without one it
raises), "cpu" runs the kernel's plain version on the CPU. A tool no x264
stream of this corpus uses (interlace, FMO, redundant pictures, SP / SI
slices, data partitioning, gaps in frame_num, lossless coding, a stream
that opens on a recovery point, cabac_init_idc 1 with the 8×8 transform)
raises `UnsupportedMedia` naming it. Nothing else decodes in their place:
NVDEC (data/nvdec.py) is not tried.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np


def _lib(handle=None):
    from oatx_torch.data.video_reader import _load_lib

    lib = handle._lib if handle is not None else _load_lib()
    if lib.oatxt_h264_decode.argtypes is None:
        i64p, vp = ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p
        for name, res, args in (
                ("oatxt_h264_decode", ctypes.c_int, [vp, i64p, ctypes.c_int, vp, ctypes.c_int64]),
                ("oatxt_h264_stats", ctypes.c_int, [vp, i64p, ctypes.c_int]),
                ("oatxt_h264_stat_names", ctypes.c_char_p, []),
                ("oatxt_h264_decode_stream", ctypes.c_int,
                 [vp, ctypes.c_int64, vp, vp, ctypes.c_int, vp, ctypes.c_int, vp, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, vp, vp]),
                ("oatxt_h264_read_syntax", ctypes.c_int,
                 [ctypes.c_int, vp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    return lib


def _raise(lib, rc: int, what: str):
    from oatx_torch.data.video_reader import DecodeError, UnsupportedMedia

    msg = f"{what}: {lib.oatxt_last_error().decode(errors='replace')}"
    if rc == -3:
        raise UnsupportedMedia(msg)
    raise DecodeError(f"{msg} ({rc})")


def wanted(indices: Sequence[int], vlen: int) -> np.ndarray:
    """The distinct display indices a decode writes, ascending (past the
    end → the last frame), as the native entry orders them."""
    return np.unique(np.clip(np.asarray(indices, np.int64), 0, vlen - 1))


def decode_nv12(handle, indices: Sequence[int], out: np.ndarray) -> np.ndarray:
    """The pictures of `wanted(indices)` as NV12 into `out`, a contiguous
    uint8 (len(wanted), 3·h/2, w) host array (pinned memory through
    torch's `.numpy()` works); → the wanted indices."""
    lib = _lib(handle)
    vlen, _, w, h = handle.info()
    want = wanted(indices, vlen)
    if out.dtype != np.uint8 or out.shape != (len(want), h * 3 // 2, w) or \
            not out.flags.c_contiguous:
        raise ValueError(f"NV12 buffer {out.dtype} {out.shape} for {len(want)} frames of {w}x{h}")
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    rc = lib.oatxt_h264_decode(handle._handle(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                               len(idx), out.ctypes.data, out.nbytes)
    if rc < 0:
        _raise(lib, rc, f"H.264 decode of {handle.path}")
    return want


def decode_stream(plan, width: int, height: int, counters: Dict[str, int] = None) -> np.ndarray:
    """A plan (video_reader.H264Plan, `wanted` sorted and unique), perhaps
    made by hand, decoded by a fresh decoder → NV12 (len(wanted), 3·h/2, w);
    its tool counters (as `stats`) into `counters` when given."""
    lib = _lib()
    out = np.empty((len(plan.wanted), height * 3 // 2, width), np.uint8)
    names = lib.oatxt_h264_stat_names().decode().split(",")
    stats = np.zeros(len(names), np.int64)
    arrs = [np.ascontiguousarray(a, dt) for a, dt in (
        (plan.data, np.uint8), (plan.pkt_end, np.int64), (plan.pkt_ts, np.int64),
        (plan.seg_end, np.int32), (plan.wanted, np.int64))]
    data, pkt_end, pkt_ts, seg_end, want = arrs
    rc = lib.oatxt_h264_decode_stream(data.ctypes.data, len(data), pkt_end.ctypes.data,
                                      pkt_ts.ctypes.data, len(pkt_end), seg_end.ctypes.data,
                                      len(seg_end), want.ctypes.data, len(want), width, height,
                                      out.ctypes.data, stats.ctypes.data)
    if counters is not None:
        counters.update(zip(names, map(int, stats)))
    if rc < 0:
        _raise(lib, rc, "H.264 stream")
    return out


def read_syntax(kind: str, data: bytes, n: int, nc: int = 0, ctx: Sequence[int] = ()):
    """The decoder's parsing primitives on `data` (h264.h read_syntax):
    kind "ue" / "se" → (n values, bits read); "residual" → (the levels of
    one CAVLC block with nC `nc` and maxNumCoeff `n`, TotalCoeff, bits read);
    "cabac_init" → (the CABAC context state 2 · pStateIdx + valMPS of each
    ctxIdx in `ctx` after the initialisation of slice kind nc // 64 (0 I,
    1-3 cabac_init_idc 0-2) at SliceQPY nc % 64, -1 where the kind has no
    such context; bits read); "cabac_range" → (the rangeTabLPS row of each
    pStateIdx in `ctx`, their transIdxLPS)."""
    lib = _lib()
    k = {"ue": 0, "se": 1, "residual": 2, "cabac_init": 3, "cabac_range": 4}[kind]
    out = np.zeros(2 * n + 1, np.int32)
    out[:len(ctx)] = ctx
    rc = lib.oatxt_h264_read_syntax(k, data, len(data), nc, n, out.ctypes.data)
    if rc < 0:
        _raise(lib, rc, f"reading {kind}")
    if kind == "residual":
        return out[:n].tolist(), int(out[n]), rc
    if kind == "cabac_range":
        return [tuple(int(v) >> s & 255 for s in (24, 16, 8, 0)) for v in out[:n]], \
            out[n:2 * n].tolist()
    return out[:n].tolist(), rc


def stats(handle) -> Dict[str, int]:
    """The decoder's tool counters since the handle opened (h264.h)."""
    lib = _lib(handle)
    names = lib.oatxt_h264_stat_names().decode().split(",")
    out = np.zeros(len(names), np.int64)
    lib.oatxt_h264_stats(handle._handle(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         len(names))
    return dict(zip(names, map(int, out)))


def decode(handle, indices: Sequence[int], short_side: int, device=None) -> np.ndarray:
    """Frame `indices` of an H.264 reader handle → uint8 (n, H, W, 3) RGB."""
    import torch

    from oatx_torch import resolve_device
    from oatx_torch.ops.kernels.nv12_rgb import nv12_to_rgb

    dev = resolve_device(device)
    vlen, _, w, h = handle.info()
    ow, oh = handle.out_size(short_side)
    if len(indices) == 0:
        return np.empty((0, oh, ow, 3), np.uint8)
    full_range = handle.h264_info()[2]
    n = len(wanted(indices, vlen))
    host = torch.empty((n, h * 3 // 2, w), dtype=torch.uint8, pin_memory=dev.type == "cuda")
    want = decode_nv12(handle, indices, host.numpy())
    slots = torch.as_tensor(np.searchsorted(want, np.clip(np.asarray(indices, np.int64), 0,
                                                          vlen - 1)))
    if dev.type != "cuda":
        return nv12_to_rgb(host.to(dev), ow, oh, full_range)[slots].cpu().numpy()
    from oatx_torch.data.nvdec import _stream

    stream = _stream(dev.index)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        nv12 = host.to(dev, non_blocking=True)
        rgb = nv12_to_rgb(nv12, ow, oh, full_range)
        out = rgb[slots.to(dev)].cpu().numpy()
    return out
