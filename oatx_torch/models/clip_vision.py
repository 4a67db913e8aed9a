"""CLIP vision transformer, forward (port of oatx/models/clip_vision.py; the
reference's vendored CLIP visual side, `clip/model.py:203-243`, the CLIP
backbone of the visualization sidecar, `main_img.py:12,17-27`).

    patch conv (no bias) over NHWC images, already CLIP-normalized
    → prepend the class embedding → add the positional embedding → ln_pre
    pre-LN blocks (LN eps 1e-5): x += MHA(ln_1(x)), UNMASKED, softmax in
        f32; x += c_proj(QuickGELU(c_fc(ln_2(x))))
    then
        encode_image          ln_post(CLS) @ proj → (B, E), stock CLIP pooling
        encode_image_patches  ln_post(every patch token, CLS dropped) @ proj,
                              L2-normalized → (B, N, E), the vendored viz
                              forward that the heatmaps consume

Casts are explicit, as in ops/layers.py and clip_text.py: LN statistics and
softmax in f32, matmul inputs in `dtype`. No TPU kernel is on this path:
oatx computes the attention with einsum and softmax outside Pallas, kernel
1's exact-erf GELU is not QuickGELU and kernel 2 is divided space
attention, so plain PyTorch is the port here, as in clip_text.py.

Parameter names follow the vendored CLIP's visual side (`conv1`,
`class_embedding`, `positional_embedding`, `ln_pre`,
`transformer.resblocks.N.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_post`, `proj` used as
x @ W), so a `visual.*` state_dict loads strictly once its prefix is taken
off (models/convert.clip_vision_from_torch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.models.clip_text import LN_EPS, Mlp, _normal
from oatx_torch.ops.layers import LayerNorm, Linear, layer_norm, linear, patch_embed_conv


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    heads: int = 12
    layers: int = 12
    output_dim: int = 512
    scan_layers: bool = False

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2


class Attention(nn.Module):
    """torch MultiheadAttention's packed layout (in_proj_weight (3D, D) rows
    [q; k; v], out_proj) without a mask."""

    def __init__(self, cfg: ClipVisionConfig, device, generator):
        super().__init__()
        d = cfg.width
        self.in_proj_weight = _normal((3 * d, d), d ** -0.5, device, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d, device=device))
        self.out_proj = Linear(d, d, device, generator)
        with torch.no_grad():
            self.out_proj.weight.normal_(0.0, (d ** -0.5) * ((2 * cfg.layers) ** -0.5),
                                         generator=generator)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // heads
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias).reshape(b, t, 3, heads, dh)
        q, k, v = qkv[:, :, 0] * (dh ** -0.5), qkv[:, :, 1], qkv[:, :, 2]
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()),
                          dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(x.dtype)
        return self.out_proj(out.reshape(b, t, d))


class ResidualBlock(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, device, generator):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width, LN_EPS, device)
        self.attn = Attention(cfg, device, generator)
        self.ln_2 = LayerNorm(cfg.width, LN_EPS, device)
        self.mlp = Mlp(cfg, device, generator)  # c_fc → QuickGELU → c_proj

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), heads)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, device, generator):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(cfg, device, generator)
                                       for _ in range(cfg.layers))


class _Conv(nn.Module):
    """The patch conv's weight (width, 3, p, p); it has no bias."""

    def __init__(self, cfg: ClipVisionConfig, device, generator):
        super().__init__()
        p = cfg.patch_size
        self.weight = _normal((cfg.width, 3, p, p), 0.02, device, generator)


class ClipVision(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError("ClipVisionConfig.scan_layers is not ported")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        d = cfg.width
        scale = d ** -0.5
        self.conv1 = _Conv(cfg, device, generator)
        self.class_embedding = _normal((d,), scale, device, generator)
        self.positional_embedding = _normal((cfg.num_patches + 1, d), scale, device, generator)
        self.ln_pre = LayerNorm(d, LN_EPS, device)
        self.transformer = Transformer(cfg, device, generator)
        self.ln_post = LayerNorm(d, LN_EPS, device)
        self.proj = _normal((d, cfg.output_dim), scale, device, generator)

    def forward(self, images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, H, W, 3) NHWC images → the final hidden states (B, 1 + N, D)
        in `dtype`, before ln_post (each pooling head norms its own slice)."""
        cfg = self.cfg
        x = patch_embed_conv(images.to(dtype), self.conv1.weight, None, cfg.patch_size)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)[None]
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x, cfg.heads)
        return x

    def apply(self, images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """oatx's name for the hidden states (`forward`). It shadows
        nn.Module.apply, which nothing calls on this model."""
        return self(images, dtype)

    def encode_image(self, images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """ln_post(CLS) @ proj → (B, output_dim)."""
        h = self(images, dtype)
        pooled = layer_norm(h[:, 0], self.ln_post.weight, self.ln_post.bias, LN_EPS)
        return pooled @ self.proj.to(pooled.dtype)

    def encode_image_patches(self, images: torch.Tensor,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """ln_post(every patch token) @ proj, L2-normalized → (B, N, output_dim)."""
        h = self(images, dtype)
        x = layer_norm(h[:, 1:], self.ln_post.weight, self.ln_post.bias, LN_EPS)
        x = x @ self.proj.to(x.dtype)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
