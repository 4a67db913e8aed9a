"""H.264 in mp4 / mov decoded on the card's NVDEC (csrc/nvdec.cu).

A second route for oatx's FFmpeg H.264 path (oatx/native/oatx_decode.cpp,
decode_seek_stepping and IndexDecode), called directly (`decode(handle,
...)`): the reader decodes H.264 on the host (data/h264.py) and never tries
this one, before or after. The host demuxer (native/mp4.cpp,
through `VideoHandle.h264_plan`) gives the Annex B segments that decode the
wanted display indices; NVDEC's parser and decoder run them, each wanted
frame's NV12 surface is copied into one device buffer, and one launch of
the NV12 → RGB kernel (ops/kernels/nv12_rgb.py) converts them all at the
native or the short-side size. Frames come back as oatx's reader returns
them: uint8 RGB (n, H, W, 3) on the host, indices past the end standing
for the last frame.

UNVERIFIED: the decoder glue here and in csrc/nvdec.cu has never decoded a
frame. The only card it was tried on sits in a container that withholds the
driver's video capability, where cuvidGetDecoderCaps itself fails; only the
NV12 → RGB kernel is checked on a card. `chip_smoke.py --only-decode` runs
the glue where the capability is granted.

Without a card `decode` raises `UnsupportedMedia`. On the card it raises
`UnsupportedMedia` only for a container's refusal: libnvcuvid does not load, or the caps query returns
CUDA_ERROR_OUT_OF_MEMORY, where NVIDIA_DRIVER_CAPABILITIES withholds
'video'. Every other failure of a CUDA or NVCUVID call, of the caps, or of
NVDEC's parser to agree with the demuxer or to display a wanted frame is a
fault of the port or the card and raises `NvdecError` (not a `DecodeError`:
lax loading must not swallow it); a bitstream NVDEC's parser rejects raises
`DecodeError`.

The work of one call runs on a stream of the calling thread's own, so the
loader's threads do not queue behind the training step on the default
stream, and the host copy at the end waits for this call's work alone.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Sequence

import numpy as np

from oatx_torch.ops.kernels import _build

_threads = threading.local()

# what the one refusal seen on a card carried (a container without the
# driver's video capability); chip_smoke.py accepts a refusal only with it
OBSERVED_REFUSAL = ("cuvidGetDecoderCaps", "CUDA_ERROR_OUT_OF_MEMORY",
                    "withholds the driver's video capability")


class NvdecError(RuntimeError):
    """A CUDA or NVCUVID call failed while decoding on the card."""


def _lib():
    lib = _build.load("nvdec")
    if lib.oatx_nvdec_open.argtypes is None:
        vp, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
        intp = ctypes.POINTER(ctypes.c_int)
        for name, res, args in (
                ("oatx_nvdec_error", ctypes.c_char_p, []),
                ("oatx_nvdec_caps", ctypes.c_int, [ctypes.c_int, intp]),
                ("oatx_nvdec_open", vp, [ctypes.c_int, intp]),
                ("oatx_nvdec_close", None, [vp]),
                ("oatx_nvdec_decode", ctypes.c_int,
                 [vp, vp, i64p, i64p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                  ctypes.c_int, i64p, ctypes.c_int, vp, intp, vp]),
                ("oatx_nvdec_format", None, [vp, intp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    return lib


def video_capability_withheld(caps) -> bool:
    """Whether NVIDIA_DRIVER_CAPABILITIES' value `caps` (None where unset)
    names capabilities without 'video' or 'all'."""
    names = {c.strip() for c in (caps or "").split(",")} - {""}
    return bool(names) and not names & {"video", "all"}


def is_observed_refusal(msg: str) -> bool:
    return all(part in msg for part in OBSERVED_REFUSAL)


def _raise(lib, rc: int, what: str):
    from oatx_torch.data.video_reader import DecodeError, UnsupportedMedia

    msg = f"{what}: {lib.oatx_nvdec_error().decode(errors='replace')} ({rc})"
    if rc == -1:
        env = os.environ.get("NVIDIA_DRIVER_CAPABILITIES")
        if video_capability_withheld(env):
            raise UnsupportedMedia(
                f"{msg}; NVDEC cannot be opened here: NVIDIA_DRIVER_CAPABILITIES={env} "
                "withholds the driver's video capability (the reader decodes H.264 on "
                "the host)")
        raise NvdecError(f"{msg}; NVIDIA_DRIVER_CAPABILITIES={env!r} does not withhold the "
                         "driver's video capability, so this is no container's refusal")
    if rc == -3:
        raise DecodeError(msg)
    raise NvdecError(msg)


def caps(device: int = 0) -> Dict[str, int]:
    """NVDEC's capabilities for 8-bit 4:2:0 H.264 on `device`."""
    lib = _lib()
    out = (ctypes.c_int * 8)()
    rc = lib.oatx_nvdec_caps(device, out)
    if rc:
        _raise(lib, rc, "NVDEC caps")
    keys = ("supported", "nvdecs", "output_format_mask", "max_width", "max_height",
            "max_mb_count", "min_width", "min_height")
    return dict(zip(keys, map(int, out)))


class Decoder:
    """One NVDEC decoder (made at the stream's first sequence header) on
    one device; a reader handle holds one."""

    def __init__(self, device: int):
        self._lib = _lib()
        rc = ctypes.c_int(0)
        self._h = self._lib.oatx_nvdec_open(device, ctypes.byref(rc))
        if not self._h:
            _raise(self._lib, rc.value, "NVDEC open")
        self.device = device

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.oatx_nvdec_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def decode(self, plan, geom: Sequence[int], out, stream: int, what: str) -> None:
        """Run `plan` (video_reader.H264Plan) and copy each wanted frame's
        NV12 into `out`, a (len(plan.wanted), 3·h/2, w) uint8 CUDA tensor."""
        i64p = ctypes.POINTER(ctypes.c_int64)
        g = (ctypes.c_int * 4)(*geom)
        rc = self._lib.oatx_nvdec_decode(
            self._h, plan.data.ctypes.data, plan.pkt_end.ctypes.data_as(i64p),
            plan.pkt_ts.ctypes.data_as(i64p), len(plan.pkt_end),
            plan.seg_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(plan.seg_end),
            plan.wanted.ctypes.data_as(i64p), len(plan.wanted), out.data_ptr(), g, stream)
        if rc:
            _raise(self._lib, rc, f"NVDEC decode of {what}")

    def format(self) -> Dict[str, int]:
        """The last sequence header NVDEC's parser reported."""
        v = (ctypes.c_int * 12)()
        self._lib.oatx_nvdec_format(self._h, v)
        keys = ("codec", "coded_width", "coded_height", "left", "top", "right", "bottom",
                "chroma_format", "bit_depth_minus8", "full_range", "min_surfaces",
                "decode_surfaces")
        return dict(zip(keys, map(int, v)))


def _stream(device: int):
    """The calling thread's own stream on `device`."""
    import torch

    streams = getattr(_threads, "streams", None)
    if streams is None:
        streams = _threads.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
    return s


def decode(handle, indices: Sequence[int], short_side: int) -> np.ndarray:
    """Frame `indices` of an H.264 reader handle → uint8 (n, H, W, 3) RGB."""
    import torch

    from oatx_torch.data.video_reader import UnsupportedMedia
    from oatx_torch.ops.kernels.nv12_rgb import nv12_to_rgb

    if not torch.cuda.is_available():
        raise UnsupportedMedia(f"{handle.path}: NVDEC decodes on a card, and this process "
                               "has no CUDA device")
    vlen, _, w, h = handle.info()
    ow, oh = handle.out_size(short_side)
    if len(indices) == 0:
        return np.empty((0, oh, ow, 3), np.uint8)
    coded_w, coded_h, full_range, _ = handle.h264_info()
    plan = handle.h264_plan(indices)
    device = torch.cuda.current_device()
    dec = handle.nvdec_decoder(device)
    stream = _stream(device)
    clamped = np.clip(np.asarray(indices, np.int64), 0, vlen - 1)
    slots = torch.as_tensor(np.searchsorted(plan.wanted, clamped))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        nv12 = torch.empty((len(plan.wanted), h * 3 // 2, w), dtype=torch.uint8,
                           device=f"cuda:{device}")
        dec.decode(plan, (coded_w, coded_h, w, h), nv12, stream.cuda_stream, handle.path)
        rgb = nv12_to_rgb(nv12, ow, oh, full_range)
        return rgb[slots.to(rgb.device)].cpu().numpy()
