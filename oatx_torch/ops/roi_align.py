"""ROI-align on patch-feature grids (port of oatx/ops/roi_align.py).

Bilinear ROI-align over a ViT patch grid, batched over images and boxes with
tensor indexing: the offline extractor's `roi_backbone` detector pools its
region features with it (data/extraction.py). Plain PyTorch: oatx's version
is XLA gathers and lerps, not a Pallas kernel. oatx's conventions are kept
exactly: s = output_size · samples_per_bin points per axis at the bin centres
(arange(s) + 0.5) / s of each box, half-pixel coordinates x·W − 0.5, floor
indices clamped to [0, W − 1] with the +1 neighbour clamped too, lerp
weights clipped to [0, 1], four gathers, then the mean of each bin's
samples. Differentiable with respect to `features`.
"""

from __future__ import annotations

import torch


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int = 2,
              samples_per_bin: int = 2) -> torch.Tensor:
    """features (B, H, W, C) + normalized boxes (B, K, 4) [x1, y1, x2, y2] in
    [0, 1] → (B, K, output_size, output_size, C), bilinear, half-pixel
    centres."""
    b, h, w, c = features.shape
    k = boxes.shape[1]
    s = output_size * samples_per_bin

    # sampling grid per box: s × s points, bin-centred
    t = (torch.arange(s, device=boxes.device, dtype=boxes.dtype) + 0.5) / s
    x1, y1, x2, y2 = boxes.unbind(-1)                      # (B, K)
    xs = x1[..., None] + (x2 - x1)[..., None] * t         # (B, K, s)
    ys = y1[..., None] + (y2 - y1)[..., None] * t

    # to pixel coordinates (half-pixel convention)
    px = xs * w - 0.5
    py = ys * h - 0.5
    x0 = torch.floor(px).long().clamp(0, w - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    y0 = torch.floor(py).long().clamp(0, h - 1)
    y1i = (y0 + 1).clamp(0, h - 1)
    wx = (px - x0).clamp(0.0, 1.0)[:, :, None, :, None]   # (B, K, 1, s, 1)
    wy = (py - y0).clamp(0.0, 1.0)[:, :, :, None, None]   # (B, K, s, 1, 1)

    # four gathers of (B, K, s_y, s_x, C)
    bi = torch.arange(b, device=features.device)[:, None, None, None]

    def gather(yy, xx):
        return features[bi, yy[:, :, :, None], xx[:, :, None, :]]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1i) * wx
    bot = gather(y1i, x0) * (1 - wx) + gather(y1i, x1i) * wx
    sampled = top * (1 - wy) + bot * wy
    # average pool each bin
    out = sampled.reshape(b, k, output_size, samples_per_bin, output_size, samples_per_bin, c)
    return out.mean(dim=(3, 5))


def roi_pool_patches(patch_tokens: torch.Tensor, boxes: torch.Tensor, grid: int,
                     output_size: int = 1) -> torch.Tensor:
    """(B, grid², C) ViT patch tokens + normalized boxes → ROI-aligned region
    features (B, K, C), the output grid averaged."""
    b, _, c = patch_tokens.shape
    feat = patch_tokens.reshape(b, grid, grid, c)
    out = roi_align(feat, boxes, output_size=max(output_size, 1))
    return out.mean(dim=(2, 3))
