"""PNG files of RGB uint8 arrays, with zlib and struct alone.

oatx saves its panels through `PIL.Image.save`; the port may not import
PIL, so it writes the same pixels itself: 8-bit truecolour, no interlace,
filter 0 (None) on every row, one IDAT chunk. The bytes differ from PIL's
(its encoder picks filters and zlib settings of its own); the decoded
arrays are the same. `read_png` decodes what `write_png` writes, so a
caller can check a file without PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> str:
    """(H, W, 3) uint8 → a PNG at `path`; → path."""
    a = np.ascontiguousarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {a.shape} {a.dtype}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
    return path


def read_png(path: str) -> np.ndarray:
    """A PNG as `write_png` writes it (8-bit RGB, no interlace, filter 0) →
    (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if head is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = head
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}; only 8-bit RGB without interlace is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()
