"""Primitive layer ops (port of oatx/ops/layers.py).

Conventions follow oatx's casts, in torch layouts:
  * linear weights are torch (out_features, in_features); the weight is cast
    to x's dtype and the bias is added in x's dtype (oatx/ops/layers.py:29-33);
  * layernorm statistics are f32 whatever the compute dtype, output cast back
    (:36-42);
  * the patch embedding takes NHWC frames and an OIHW conv weight (the torch
    form of oatx's HWIO kernel) and emits row-major tokens (:55-73).

`Linear` and `LayerNorm` are parameter containers whose names follow the
reference state_dict (`weight`, `bias`); their forward is the function here,
not torch's own module forward, so the casts stay oatx's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — torch nn.GELU / HF DistilBERT."""
    return F.gelu(x)


def mlp(x: torch.Tensor, fc1_w, fc1_b, fc2_w, fc2_b) -> torch.Tensor:
    """fc1 → GELU → fc2 with compute-dtype biases (oatx layers.mlp)."""
    return linear(gelu(linear(x, fc1_w, fc1_b)), fc2_w, fc2_b)


def patch_embed_conv(images: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], patch_size: int) -> torch.Tensor:
    """Non-overlapping patch embedding: NHWC images (N, H, W, C) → (N, H/p·W/p, D)
    tokens in row-major (h, w) order. `weight` is OIHW (D, C, p, p)."""
    x = images.permute(0, 3, 1, 2)
    y = F.conv2d(x, weight.to(images.dtype), stride=patch_size)
    y = y.flatten(2).transpose(1, 2)
    if bias is not None:
        y = y + bias.to(images.dtype)
    return y


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), table)


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> torch.Tensor:
    """Truncated normal in (-2σ, 2σ) (oatx/core/module.py:18-20, timm's
    trunc_normal_(std=.02))."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


class Linear(nn.Module):
    """weight (out, in) trunc_normal(0.02), bias zeros — oatx's dense init."""

    def __init__(self, d_in: int, d_out: int, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(trunc_normal_(
            torch.empty(d_out, d_in, device=device), generator))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device: torch.device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
