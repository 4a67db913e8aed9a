"""Device-side eval transform (port of oatx/data/transforms.py:51-69,172-179).

The host ships canonical uint8 frames (short side resized and centre-cropped
to `center_crop`²); on the device they become float, are resized bilinearly
to `input_res`² and normalized with the ImageNet statistics — the reference's
val/test chain (short side 256 → centre 256 → bilinear 224 → normalize).
The training augmentations wait for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    input_res: int = 224
    center_crop: int = 256
    norm_mean: Tuple[float, float, float] = IMAGENET_MEAN
    norm_std: Tuple[float, float, float] = IMAGENET_STD


def normalize(x: torch.Tensor, cfg: TransformConfig = TransformConfig()) -> torch.Tensor:
    mean = torch.tensor(cfg.norm_mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(cfg.norm_std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C), half-pixel centres
    (align_corners=False), no antialias — jax.image.resize(..., 'bilinear',
    antialias=False), which oatx uses."""
    *lead, h, w, c = x.shape
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def eval_transform(video_u8: torch.Tensor,
                   cfg: TransformConfig = TransformConfig()) -> torch.Tensor:
    """uint8 frames (..., center_crop, center_crop, C) → normalized f32
    (..., input_res, input_res, C), on the tensor's device."""
    x = video_u8.float() / 255.0
    x = resize_bilinear(x, cfg.input_res, cfg.input_res)
    return normalize(x, cfg)
