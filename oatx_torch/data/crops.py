"""Multi-crop utilities (port of oatx/data/crops.py; the reference's
utils/custom_transforms.py:17-131): border and center crops and
TwoHoriCrop, numpy slices of HWC frames on the host. Each returns a view
of `frames`, the same slice oatx returns."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def center_crop_np(frames: np.ndarray, size: int) -> np.ndarray:
    """The centred `size`² window of (..., H, W, C) frames, its top-left
    corner at ((H - size) // 2, (W - size) // 2)."""
    h, w = frames.shape[-3], frames.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return frames[..., top: top + size, left: left + size, :]


def border_crops(frames: np.ndarray, size: int) -> List[np.ndarray]:
    """Five-crop: the four corners (top-left, top-right, bottom-left,
    bottom-right), then the center."""
    h, w = frames.shape[-3], frames.shape[-2]
    coords = [(0, 0), (0, w - size), (h - size, 0), (h - size, w - size)]
    crops = [frames[..., t: t + size, l: l + size, :] for t, l in coords]
    crops.append(center_crop_np(frames, size))
    return crops


def two_hori_crop(frames: np.ndarray, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Left and right `size`² crops (the reference's TwoHoriCrop), anchored
    at the left and right edges after vertical centering."""
    h, w = frames.shape[-3], frames.shape[-2]
    top = (h - size) // 2
    return (frames[..., top: top + size, 0: size, :],
            frames[..., top: top + size, w - size: w, :])
