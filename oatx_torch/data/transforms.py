"""Device-side batched video transforms (port of oatx/data/transforms.py:36-179).

The host ships canonical uint8 frames (short side resized and centre-cropped
to `center_crop`²); everything after that runs on the tensor's device:

  eval   float → bilinear resize to `input_res`² → ImageNet normalize: the
         reference's val/test chain (short side 256 → centre 256 → bilinear
         224 → normalize);
  train  float → one random resized crop per clip (area ∈ randcrop_scale of
         the canonical square, log-uniform aspect ∈ randcrop_ratio, one clamped
         draw, as oatx does) → random horizontal flip (p = 0.5 per clip) →
         colour jitter (off at the reference's (0, 0, 0)) → normalize. With
         `host_precropped` the frames arrive cropped to `input_res`² and the
         crop is skipped.

Every random draw comes from an explicit `torch.Generator` on the batch's
device (the train step seeds one per step); oatx draws from a JAX key, so the
two packages agree in distribution, not draw for draw. Every draw is per
clip: with `shard` = (r, n), rank r of n draws for the n·B clips of the
global batch and keeps rows [r·B, (r + 1)·B), so n ranks augment exactly as
one process augments their batches concatenated in rank order (oatx
augments the global batch with one key). Given the same boxes,
flip mask and jitter factors, the arithmetic is oatx's: `crop_resize` is its
`_bilinear_crop_resize` (half-pixel centres, clamped corner indices, f32
weights) batched as per-clip index gathers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_YIQ_FROM_RGB = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    input_res: int = 224
    center_crop: int = 256
    randcrop_scale: Tuple[float, float] = (0.5, 1.0)
    randcrop_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    color_jitter: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # brightness, saturation, hue
    norm_mean: Tuple[float, float, float] = IMAGENET_MEAN
    norm_std: Tuple[float, float, float] = IMAGENET_STD
    host_precropped: bool = False  # frames arrive cropped to input_res²


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


def _axis_taps(start: torch.Tensor, extent: torch.Tensor, out: int, size: int):
    """Per clip, the two source indices and the weight of the second for each
    of `out` samples over [start, start + extent) (oatx :80-87)."""
    pos = start[:, None] + (torch.arange(out, device=start.device) + 0.5) \
        * (extent / out)[:, None] - 0.5
    i0 = pos.floor().long().clamp(0, size - 1)
    i1 = (i0 + 1).clamp(max=size - 1)
    return i0, i1, (pos - i0).clamp(0.0, 1.0)


def crop_resize(video: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                ch: torch.Tensor, cw: torch.Tensor, out: int) -> torch.Tensor:
    """video (B, F, H, W, C) float; per clip the box [y0, y0 + ch) × [x0, x0 +
    cw) in float pixels → (B, F, out, out, C), bilinear."""
    b, f, h, w, c = video.shape
    v = video.permute(0, 2, 3, 1, 4)                       # (B, H, W, F, C)
    yi0, yi1, wy = _axis_taps(y0, ch, out, h)
    xi0, xi1, wx = _axis_taps(x0, cw, out, w)
    bi = torch.arange(b, device=video.device)
    rows0, rows1 = v[bi[:, None], yi0], v[bi[:, None], yi1]  # (B, out, W, F, C)
    bb, oo = bi[:, None, None], torch.arange(out, device=video.device)[None, :, None]
    wx = wx[:, None, :, None, None]
    top = rows0[bb, oo, xi0[:, None]] * (1 - wx) + rows0[bb, oo, xi1[:, None]] * wx
    bot = rows1[bb, oo, xi0[:, None]] * (1 - wx) + rows1[bb, oo, xi1[:, None]] * wx
    wy = wy[:, :, None, None, None]
    return (top * (1 - wy) + bot * wy).permute(0, 3, 1, 2, 4)  # (B, F, out, out, C)


Shard = Optional[Tuple[int, int]]  # (rank, world): draw for the global batch


def _uniform(gen: torch.Generator, lead: Tuple[int, ...], b: int, shard: Shard = None):
    """U[0, 1) draws of shape lead + (b,); with `shard` (r, n) drawn for n·b
    clips and cut to the columns of rank r's rows."""
    if shard is None or shard[1] == 1:
        return torch.rand(*lead, b, generator=gen, device=gen.device)
    r, n = shard
    return torch.rand(*lead, n * b, generator=gen, device=gen.device)[..., r * b:(r + 1) * b]


def crop_boxes(gen: torch.Generator, b: int, h: int, w: int, cfg: TransformConfig,
               shard: Shard = None):
    """One box per clip (oatx :99-114): area U(scale)·H·W, aspect
    exp(U(log ratio)), sides clamped to [8, H] and [8, W], corner uniform
    over the room left → (y0, x0, ch, cw), each (B,) f32."""
    u = _uniform(gen, (4,), b, shard)
    lo, hi = cfg.randcrop_scale
    area = (lo + (hi - lo) * u[0]) * (h * w)
    lr0, lr1 = math.log(cfg.randcrop_ratio[0]), math.log(cfg.randcrop_ratio[1])
    ratio = torch.exp(lr0 + (lr1 - lr0) * u[1])
    cw = torch.sqrt(area * ratio).clamp(8.0, w)
    ch = torch.sqrt(area / ratio).clamp(8.0, h)
    return u[2] * (h - ch), u[3] * (w - cw), ch, cw


def random_resized_crop(gen: torch.Generator, video: torch.Tensor,
                        cfg: TransformConfig, shard: Shard = None) -> torch.Tensor:
    """(B, F, H, W, C) float → (B, F, S, S, C); one crop per clip."""
    b, _, h, w, _ = video.shape
    return crop_resize(video, *crop_boxes(gen, b, h, w, cfg, shard), cfg.input_res)


def hflip(video: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the clips where the (B,) bool mask `flip` is set."""
    return torch.where(flip[:, None, None, None, None], video.flip(-2), video)


def random_hflip(gen: torch.Generator, video: torch.Tensor, shard: Shard = None) -> torch.Tensor:
    return hflip(video, _uniform(gen, (), video.shape[0], shard) < 0.5)


def jitter(video: torch.Tensor, brightness: Optional[torch.Tensor] = None,
           saturation: Optional[torch.Tensor] = None,
           hue_theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Colour jitter with per-clip (B,) factors (oatx :122-151): brightness
    scales, saturation blends with the channel mean, hue rotates I/Q in YIQ
    by hue_theta radians; then clamp to [0, 1]."""
    if brightness is not None:
        video = video * brightness[:, None, None, None, None]
    if saturation is not None:
        gray = video.mean(dim=-1, keepdim=True)
        video = gray + (video - gray) * saturation[:, None, None, None, None]
    if hue_theta is not None:
        m = torch.tensor(_YIQ_FROM_RGB, dtype=video.dtype, device=video.device)
        yiq = torch.einsum("...c,dc->...d", video, m)
        th = hue_theta[:, None, None, None]
        cos, sin = torch.cos(th), torch.sin(th)
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], i * cos - q * sin, i * sin + q * cos], dim=-1)
        video = torch.einsum("...c,dc->...d", yiq, torch.linalg.inv(m))
    return video.clamp(0.0, 1.0)


def color_jitter(gen: torch.Generator, video: torch.Tensor,
                 cfg: TransformConfig, shard: Shard = None) -> torch.Tensor:
    """Brightness/saturation/hue jitter per clip; the identity at (0, 0, 0)."""
    bj, sj, hj = cfg.color_jitter
    if bj == 0 and sj == 0 and hj == 0:
        return video
    u = _uniform(gen, (3,), video.shape[0], shard)

    def between(r, lo, hi):
        return lo + (hi - lo) * r

    return jitter(
        video,
        between(u[0], max(0.0, 1 - bj), 1 + bj) if bj > 0 else None,
        between(u[1], max(0.0, 1 - sj), 1 + sj) if sj > 0 else None,
        between(u[2], -hj, hj) * 2 * math.pi if hj > 0 else None)


def train_augment(gen: torch.Generator, video_u8: torch.Tensor,
                  cfg: TransformConfig = TransformConfig(), shard: Shard = None) -> torch.Tensor:
    """uint8 canonical frames (B, F, canon, canon, C) → augmented, normalized
    f32 (B, F, input_res, input_res, C) on the generator's device; `shard`
    (rank, world) draws as for the global batch (module docstring)."""
    x = video_u8.float() / 255.0
    if cfg.host_precropped:
        if x.shape[-2] != cfg.input_res:
            raise ValueError(f"host_precropped expects input_res² frames, got "
                             f"{tuple(x.shape)}")
    else:
        x = random_resized_crop(gen, x, cfg, shard)
    x = random_hflip(gen, x, shard)
    x = color_jitter(gen, x, cfg, shard)
    return normalize(x, cfg)


def eval_transform(video_u8: torch.Tensor,
                   cfg: TransformConfig = TransformConfig()) -> torch.Tensor:
    """uint8 frames (..., center_crop, center_crop, C) → normalized f32
    (..., input_res, input_res, C), on the tensor's device."""
    x = video_u8.float() / 255.0
    x = resize_bilinear(x, cfg.input_res, cfg.input_res)
    return normalize(x, cfg)
