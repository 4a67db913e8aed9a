"""Host-side decode: ctypes binding to the port's first-party C++ decoder
(port of oatx/data/video_reader.py over oatx_torch/native/decode.cpp).

oatx reads clips through FFmpeg (oatx/native/oatx_decode.cpp). The port
keeps oatx's API and design: frames come back as packed uint8 RGB HWC,
short-side-resized in native code, and everything after that runs on the
device (oatx_torch.data.transforms). The decode call releases the GIL
(ctypes foreign call), so the loader's thread pool decodes in parallel.

The host decoder reads JPEG-coded media: MJPEG in an AVI (what
`write_test_video` writes and oatx's `tools/remux.py --codec mjpeg` makes)
and bare JPEG stills (CC3M). H.264 in mp4 / mov (WebVid's and MSR-VTT's
codec) is demuxed on the host (native/mp4.cpp) and decoded on the host by
the port's own H.264 decoder (native/h264.h: CAVLC and CABAC, I, P and B
slices), its NV12 pictures converted to RGB on the card (data/h264.py);
`device="cpu"` converts on the CPU instead. The container is sniffed from
the content, not the extension. Anything else (MPEG-4 Part 2, HEVC, H.264
other than 8-bit 4:2:0 progressive, ...) raises `UnsupportedMedia`, which
is not a `DecodeError`, an `OSError` or an `AssertionError`: lax loading
must not swallow it and train on substitute clips.

The library builds at first use (never at import) with the host compiler:
each of native/*.cpp compiled at once in its own process, `c++ -O3 -fPIC
-std=c++17 -c` (-O3: the IDCT and filter loops vectorize), then linked
`-shared` into oatx_torch/_build/, named by a hash of the sources and the
flags, under a file lock. A build failure raises with the compiler's log.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from oatx_torch.data.sampling import sample_frames

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "decode.cpp"
SOURCES = [SOURCE, _PKG / "native" / "mp4.cpp", _PKG / "native" / "h264_slice.cpp",
           _PKG / "native" / "h264_recon.cpp", _PKG / "native" / "h264_cabac.cpp"]
HEADERS = [_PKG / "native" / "mp4.h", _PKG / "native" / "h264.h"]
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_UNSUPPORTED = -3  # decode.cpp's kUnsupported

_lib = None
_lib_lock = threading.Lock()


class DecodeError(RuntimeError):
    """A clip that cannot be read: missing, truncated or corrupt."""


class UnsupportedMedia(Exception):
    """Media the port does not read (neither JPEG-coded nor 8-bit 4:2:0
    H.264 in mp4 / mov, a JPEG variant outside baseline / extended
    sequential 8-bit Huffman, an H.264 tool no x264 stream uses)."""


def library_path() -> Path:
    h = hashlib.sha256()
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + f.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdecode-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler found (set CXX): the decoder is built from "
                       f"{SOURCE.parent} at first use")


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{os.getpid()}.{src.stem}.o") for src in SOURCES]
    compile_flags = [f for f in CXX_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([_compiler(), *compile_flags, "-c", "-o", str(o), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError(f"building {SOURCE.parent} failed:\n" + "".join(logs))
        p = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"linking {SOURCE.parent} failed:\n{p.stdout}{p.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)


def _load_lib():
    """Build (once per source hash, under a cross-process lock) and load."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".decode.lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)
        i64p, dblp, intp = (ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_int))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        sig = {
            "oatxt_last_error": (ctypes.c_char_p, []),
            "oatxt_version": (ctypes.c_char_p, []),
            "oatxt_open": (ctypes.c_void_p, [ctypes.c_char_p, intp]),
            "oatxt_close": (None, [ctypes.c_void_p]),
            "oatxt_handle_info": (ctypes.c_int, [ctypes.c_void_p, i64p, dblp, intp, intp]),
            "oatxt_handle_out_size": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, intp, intp]),
            "oatxt_handle_decode": (ctypes.c_int, [ctypes.c_void_p, i64p, ctypes.c_int,
                                                   ctypes.c_int, u8p, ctypes.c_int,
                                                   ctypes.c_int]),
            "oatxt_probe": (ctypes.c_int, [ctypes.c_char_p, i64p, dblp, intp, intp]),
            "oatxt_jpeg_bytes_info": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, intp,
                                                     intp]),
            "oatxt_decode_jpeg_bytes": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, u8p,
                                                       ctypes.c_int, ctypes.c_int]),
            "oatxt_write_test_video_ex": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                                         ctypes.c_int, ctypes.c_int,
                                                         ctypes.c_int, ctypes.c_uint,
                                                         ctypes.c_char_p, ctypes.c_int]),
            "oatxt_write_test_image": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                                      ctypes.c_int, ctypes.c_uint,
                                                      ctypes.c_int]),
            "oatxt_handle_kind": (ctypes.c_int, [ctypes.c_void_p]),
            "oatxt_h264_info": (ctypes.c_int, [ctypes.c_void_p, intp, intp, intp, intp]),
            "oatxt_h264_plan": (ctypes.c_void_p, [ctypes.c_void_p, i64p, ctypes.c_int, intp]),
            "oatxt_plan_sizes": (None, [ctypes.c_void_p, i64p, intp, intp, intp]),
            "oatxt_plan_bytes": (ctypes.c_void_p, [ctypes.c_void_p]),
            "oatxt_plan_pkt_end": (ctypes.c_void_p, [ctypes.c_void_p]),
            "oatxt_plan_pkt_ts": (ctypes.c_void_p, [ctypes.c_void_p]),
            "oatxt_plan_seg_end": (ctypes.c_void_p, [ctypes.c_void_p]),
            "oatxt_plan_wanted": (ctypes.c_void_p, [ctypes.c_void_p]),
            "oatxt_plan_free": (None, [ctypes.c_void_p]),
            "oatxt_bilinear_filter": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_int, intp, intp, ctypes.c_int]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


def _raise(lib, rc: int, what: str):
    msg = f"{what}: {lib.oatxt_last_error().decode(errors='replace')} ({rc})"
    if rc == _UNSUPPORTED:
        raise UnsupportedMedia(msg)
    raise DecodeError(msg)


class H264Plan(NamedTuple):
    """The Annex B stream that decodes a set of display indices (mp4.h):
    packet i is data[pkt_end[i - 1]:pkt_end[i]], display index pkt_ts[i];
    segment s is packets [seg_end[s - 1], seg_end[s]), each opening with the
    SPS and PPS before a sync sample; `wanted` the sorted, unique, clamped
    display indices."""
    data: np.ndarray
    pkt_end: np.ndarray
    pkt_ts: np.ndarray
    seg_end: np.ndarray
    wanted: np.ndarray


def _array(ptr: int, n: int, dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    return np.frombuffer(ctypes.string_at(ptr, n * dt.itemsize), dt).copy() if n else \
        np.empty(0, dt)


def native_version() -> str:
    return _load_lib().oatxt_version().decode()


class VideoHandle:
    """One open file serving probe + out_size + decode (the dataset path).
    The native object is not thread-safe: one handle per worker thread."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._path = path
        self._h = None
        self._nvdec = None
        rc = ctypes.c_int(0)
        h = self._lib.oatxt_open(os.fsencode(path), ctypes.byref(rc))
        if not h:
            _raise(self._lib, rc.value, f"open failed: {path}")
        self._h = h

    def __enter__(self) -> "VideoHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()

    def close(self) -> None:
        if getattr(self, "_nvdec", None) is not None:
            self._nvdec.close()
            self._nvdec = None
        if getattr(self, "_h", None):
            self._lib.oatxt_close(self._h)
            self._h = None

    @property
    def path(self) -> str:
        return self._path

    def nvdec_decoder(self, device: int):
        """The handle's NVDEC decoder on `device` (one per handle)."""
        from oatx_torch.data import nvdec

        if self._nvdec is None or self._nvdec.device != device:
            if self._nvdec is not None:
                self._nvdec.close()
            self._nvdec = nvdec.Decoder(device)
        return self._nvdec

    def _handle(self):
        if not self._h:  # NULL through ctypes would crash the native code
            raise DecodeError(f"handle is closed: {self._path}")
        return self._h

    def info(self) -> Tuple[int, float, int, int]:
        """→ (num_frames, fps, width, height)."""
        n, fps, w, h = ctypes.c_int64(), ctypes.c_double(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.oatxt_handle_info(self._handle(), ctypes.byref(n), ctypes.byref(fps),
                                         ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            _raise(self._lib, rc, f"probe failed: {self._path}")
        return int(n.value), float(fps.value), int(w.value), int(h.value)

    def out_size(self, short_side: int = 0) -> Tuple[int, int]:
        ow, oh = ctypes.c_int(), ctypes.c_int()
        self._lib.oatxt_handle_out_size(self._handle(), short_side, ctypes.byref(ow),
                                        ctypes.byref(oh))
        return int(ow.value), int(oh.value)

    @property
    def is_h264(self) -> bool:
        """H.264 in mp4 / mov (decoded by data/h264.py)."""
        return self._lib.oatxt_handle_kind(self._handle()) == 1

    def h264_info(self) -> Tuple[int, int, bool, int]:
        """→ (coded width, coded height, full range, profile_idc) of an H.264 mp4."""
        cw, ch, fr, prof = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.oatxt_h264_info(self._handle(), ctypes.byref(cw), ctypes.byref(ch),
                                       ctypes.byref(fr), ctypes.byref(prof))
        if rc != 0:
            _raise(self._lib, rc, f"h264 info: {self._path}")
        return int(cw.value), int(ch.value), bool(fr.value), int(prof.value)

    def h264_plan(self, indices: Sequence[int]) -> H264Plan:
        """The Annex B stream that decodes frame `indices` (indices past the
        end stand for the last frame)."""
        lib = self._lib
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        rc = ctypes.c_int(0)
        plan = lib.oatxt_h264_plan(self._handle(),
                                   idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                   len(idx), ctypes.byref(rc))
        if not plan:
            _raise(lib, rc.value, f"h264 plan: {self._path}")
        try:
            nb, npk, nseg, nw = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            lib.oatxt_plan_sizes(plan, ctypes.byref(nb), ctypes.byref(npk), ctypes.byref(nseg),
                                 ctypes.byref(nw))
            return H264Plan(_array(lib.oatxt_plan_bytes(plan), nb.value, np.uint8),
                            _array(lib.oatxt_plan_pkt_end(plan), npk.value, np.int64),
                            _array(lib.oatxt_plan_pkt_ts(plan), npk.value, np.int64),
                            _array(lib.oatxt_plan_seg_end(plan), nseg.value, np.int32),
                            _array(lib.oatxt_plan_wanted(plan), nw.value, np.int64))
        finally:
            lib.oatxt_plan_free(plan)

    def decode(self, indices: Sequence[int], short_side: int = 0, device=None) -> np.ndarray:
        """Decode frame indices → uint8 (n, H, W, 3) RGB; indices past the
        end give the last frame. H.264 converts its pictures to RGB on
        `device` (data/h264.py: None the card, "cpu" the plain version); the
        other media ignore it."""
        if self.is_h264:
            from oatx_torch.data import h264

            return h264.decode(self, indices, short_side, device)
        ow, oh = self.out_size(short_side)
        n = len(indices)
        out = np.empty((n, oh, ow, 3), dtype=np.uint8)
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        rc = self._lib.oatxt_handle_decode(
            self._handle(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            short_side, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ow, oh)
        if rc < 0:
            _raise(self._lib, rc, f"decode failed: {self._path}")
        return out


def probe(path: str) -> Tuple[int, float, int, int]:
    """→ (num_frames, fps, width, height)."""
    lib = _load_lib()
    n, fps, w, h = ctypes.c_int64(), ctypes.c_double(), ctypes.c_int(), ctypes.c_int()
    rc = lib.oatxt_probe(os.fsencode(path), ctypes.byref(n), ctypes.byref(fps),
                         ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        _raise(lib, rc, f"probe failed: {path}")
    return int(n.value), float(fps.value), int(w.value), int(h.value)


def decode_indices(path: str, indices: Sequence[int], short_side: int = 0,
                   device=None) -> np.ndarray:
    """Decode specific frame indices → uint8 (n, H, W, 3) RGB (`device`:
    VideoHandle.decode)."""
    with VideoHandle(path) as h:
        return h.decode(indices, short_side=short_side, device=device)


def read_frames(path: str, num_frames: int, sample: str = "rand",
                fix_start: Optional[int] = None, rng: Optional[np.random.Generator] = None,
                short_side: int = 256, device=None) -> Tuple[np.ndarray, List[int], int]:
    """Sample + decode: → (uint8 frames (n, H, W, 3), frame_idxs, vlen)
    (`device`: VideoHandle.decode)."""
    with VideoHandle(path) as h:
        vlen, _, _, _ = h.info()
        if vlen <= 0:
            raise DecodeError(f"no frames: {path}")
        idxs = sample_frames(num_frames, vlen, sample=sample, fix_start=fix_start, rng=rng)
        frames = h.decode(idxs, short_side=short_side, device=device)
    return frames, idxs, vlen


def bilinear_filter(src: int, dst: int, one: int, align: int) -> Tuple[np.ndarray, np.ndarray]:
    """swscale's SWS_BILINEAR filter from `src` to `dst` samples, as the
    decoder's resize uses it (decode.cpp make_filter): → (pos (dst,) int32,
    the first source sample of each output; coef (dst, size) int32, summing
    to `one`)."""
    lib = _load_lib()
    cap = 2 * (src // dst + 2) + 8
    pos = np.empty(dst, np.int32)
    coef = np.empty(dst * cap, np.int32)
    ip = ctypes.POINTER(ctypes.c_int)
    size = lib.oatxt_bilinear_filter(src, dst, one, align, pos.ctypes.data_as(ip),
                                     coef.ctypes.data_as(ip), cap)
    if size < 0:
        _raise(lib, size, f"bilinear filter {src} -> {dst}")
    return pos, coef[:dst * size].reshape(dst, size).copy()


def decode_jpeg_bytes(data: bytes) -> np.ndarray:
    """One JPEG image held in memory (a tar member) → uint8 (H, W, 3) RGB at
    its native size."""
    lib = _load_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.oatxt_jpeg_bytes_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        _raise(lib, rc, "in-memory JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.oatxt_decode_jpeg_bytes(data, len(data),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                     w.value, h.value)
    if rc != 0:
        _raise(lib, rc, "in-memory JPEG")
    return out


def write_test_video(path: str, width: int = 128, height: int = 96, num_frames: int = 32,
                     fps: int = 8, seed: int = 0, codec: str = "mjpeg", gop: int = 0) -> None:
    """A fixture clip with oatx's test pattern (seed 0: the historical
    pattern; other seeds: distinct frequency, phase and chroma; the frame
    index stamped into the top-left 8×8 luma block), as MJPEG in an AVI
    whatever the file name. Other codecs raise UnsupportedMedia."""
    lib = _load_lib()
    rc = lib.oatxt_write_test_video_ex(os.fsencode(path), width, height, num_frames, fps,
                                       seed & 0xFFFFFFFF, codec.encode(), gop)
    if rc != 0:
        _raise(lib, rc, f"test video write failed: {path} [{codec}]")


def write_test_image(path: str, width: int = 400, height: int = 300, seed: int = 0,
                     frame_index: int = 0) -> None:
    """Frame `frame_index` of the same pattern as a bare JPEG still."""
    lib = _load_lib()
    rc = lib.oatxt_write_test_image(os.fsencode(path), width, height, seed & 0xFFFFFFFF,
                                    frame_index)
    if rc != 0:
        _raise(lib, rc, f"test image write failed: {path}")


def transcode(in_path: str, out_path: str, codec: str = "libx264", gop: int = 60,
              quality: int = 0) -> int:
    """Not in the port: re-encoding needs an encoder for inter-coded video.
    Remux with oatx's tools/remux.py where FFmpeg exists (ROADMAP)."""
    raise NotImplementedError(
        "transcode is not ported: it needs FFmpeg's encoders; remux the corpus to MJPEG "
        "with oatx's tools/remux.py on a machine with FFmpeg (ROADMAP, queue A)")
