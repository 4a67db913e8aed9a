"""Host-side frame transforms, in numpy (port of oatx/data/transforms.py:182-270,
plus the bilinear resize oatx's tar path takes from PIL).

  * host_canonicalize — the centre square of short-side-resized frames;
  * host_reference_rrc — torchvision's RandomResizedCrop over the full
    decoded frame, drawn from an explicit numpy Generator, bilinear to out²
    (the `train_crop: reference_full_frame` ablation lane);
  * pil_bilinear_resize — PIL's `Image.resize(..., BILINEAR)`, bit for bit,
    so the port needs no PIL: a triangle filter widened by the downscale
    factor, a horizontal pass, then a vertical pass (Pillow's Resample.c).
    On uint8 RGB the taps are 22-bit fixed point and each pass rounds to
    uint8; on a float32 grid (mode "F", the heatmaps' upsample) the taps
    stay in double and each pass stores float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def tv_random_resized_crop_params(rng: np.random.Generator, height: int, width: int,
                                  scale: Tuple[float, float] = (0.5, 1.0),
                                  ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                                  ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params over an explicit Generator:
    10 attempts (area U(scale)·H·W, aspect exp(U(log ratio))), else the
    ratio-clamped centre crop. → (top, left, crop_h, crop_w)."""
    area = float(height) * float(width)
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = float(np.exp(rng.uniform(log_ratio[0], log_ratio[1])))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    in_ratio = float(width) / float(height)
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def np_bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-centre bilinear (no antialias) over (..., H, W, C) → f32."""
    h, w = img.shape[-3], img.shape[-2]
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).reshape(-1, 1, 1)
    wx = np.clip(xs - x0, 0.0, 1.0).reshape(1, -1, 1)
    f = img.astype(np.float32)
    rows0, rows1 = f[..., y0, :, :], f[..., y1, :, :]
    top = rows0[..., x0, :] * (1 - wx) + rows0[..., x1, :] * wx
    bot = rows1[..., x0, :] * (1 - wx) + rows1[..., x1, :] * wx
    return top * (1 - wy) + bot * wy


def host_reference_rrc(frames_u8: np.ndarray, rng: np.random.Generator, out: int = 224,
                       scale: Tuple[float, float] = (0.5, 1.0),
                       ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)) -> np.ndarray:
    """One RandomResizedCrop box per clip over the full frames, bilinear to
    out². (F, H, W, C) uint8 → (F, out, out, C) uint8."""
    _, h, w, _ = frames_u8.shape
    top, left, ch, cw = tv_random_resized_crop_params(rng, h, w, scale, ratio)
    res = np_bilinear_resize(frames_u8[:, top: top + ch, left: left + cw, :], out, out)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def host_canonicalize(frames_u8: np.ndarray, canon: int = 256) -> np.ndarray:
    """Centre-crop short-side-resized uint8 frames (F, H, W, C) to (F, canon,
    canon, C). The decoder already made min(H, W) == canon."""
    _, h, w, _ = frames_u8.shape
    assert min(h, w) >= canon, f"frames ({h}x{w}) smaller than canon {canon}"
    top, left = (h - canon) // 2, (w - canon) // 2
    return np.ascontiguousarray(frames_u8[:, top: top + canon, left: left + canon, :])


_PRECISION_BITS = 32 - 8 - 2


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear filter (support 1) →
    (first index (out,), taps (out, k) in double, each row summing to 1)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(0.0, 1.0 - np.abs((x + xmin - center + 0.5) * (1.0 / filterscale)))
        ww = w.sum()
        taps[xx, :xmax] = w / ww if ww != 0.0 else w
        first[xx] = xmin
    return first, taps


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One direction of Pillow's resample: uint8 through normalize_coeffs_8bpc's
    fixed-point taps, rounded and clipped; float32 (mode "F") through the
    double taps, the sum in double stored as float32."""
    first, taps = _pil_coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(taps.shape[1]), img.shape[axis] - 1)
    shape = [1] * (img.ndim + 1)
    shape[axis], shape[axis + 1] = taps.shape
    if img.dtype == np.float32:
        src = np.take(img.astype(np.float64), idx, axis=axis)  # axis → (out, k)
        return (src * taps.reshape(shape)).sum(axis=axis + 1).astype(np.float32)
    scaled = taps * (1 << _PRECISION_BITS)
    taps = np.where(scaled < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5)).astype(np.int64)
    src = np.take(img.astype(np.int64), idx, axis=axis)
    acc = (src * taps.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bilinear_resize(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """PIL `Image.resize((out_w, out_h), Image.BILINEAR)` of a uint8 (H, W, 3)
    image, or of a float32 (H, W) one (mode "F")."""
    h, w = img.shape[:2]
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"pil_bilinear_resize takes uint8 or float32, got {img.dtype}")
    if (out_w, out_h) == (w, h):
        return img.copy()
    out = img
    if out_w != w:
        out = _pil_pass(out, out_w, axis=1)
    if out_h != h:
        out = _pil_pass(out, out_h, axis=0)
    return out
