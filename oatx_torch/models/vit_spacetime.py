"""SpaceTimeTransformer — divided space-time ViT video tower
(port of oatx/models/vit_spacetime.py:25-354).

Block wiring (:166-188):
    u = x + time_attn(norm3(x))
    r = x + space_attn(norm1(u))        # residual from x, not u
    out = r + ln_mlp(norm2, r)          # kernel 1 (oatx's fused_mlp default)
Space attention runs kernel 2 (ops/kernels/space_attention.py). With
`fused_qkv=True` each LN→qkv pair runs as kernel 3 (ops/kernels/ln_linear.py,
oatx :168-177); the port's one CLS-first stream is the layout oatx falls back
to under `fused_qkv` (:297-299). Every kernel carries its gradient, so the
tower trains. Parameter
names follow the reference state_dict (`blocks.N.{norm1,norm2,norm3,attn,
timeattn,mlp}.*`, `patch_embed.proj`, `cls_token`, `pos_embed`,
`temporal_embed`, `norm`), so `load_state_dict(strict=True)` is the bridge.

The config accepts every oatx key. The layout knobs (`cls_position`,
`split_cls_stream`) leave outputs unchanged and are ignored: the port has one
token order, CLS first. Remat, scanned blocks, pipeline stages, sequence
parallelism and region taps are not ported yet, and the unfused MLP
(`fused_mlp=False`) is not ported: the tower raises on them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.ops.attention import divided_attention
from oatx_torch.ops.kernels.ln_mlp import ln_mlp
from oatx_torch.ops.layers import LayerNorm, Linear, patch_embed_conv, trunc_normal_

LN_EPS = 1e-6  # reference norm_layer = partial(nn.LayerNorm, eps=1e-6)


@dataclasses.dataclass(frozen=True)
class SpaceTimeViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 4               # maximum frames (temporal embed length)
    time_init: str = "zeros"          # 'zeros' | 'random'
    region_tap_layer: Optional[int] = None
    pooling: str = "cls"              # 'cls' | 'cls_mean_half'
    remat: bool = False
    remat_policy: str = "full"
    scan_blocks: bool = False
    cls_position: str = "last"        # layout only; the port is CLS-first
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    fused_qkv: bool = False
    sequence_parallel: bool = False
    split_cls_stream: bool = True     # layout only; the port keeps one stream
    fused_mlp: bool = True            # LN→fc1→GELU→fc2 through kernel 1, always

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def _unsupported(cfg: SpaceTimeViTConfig) -> Optional[str]:
    if cfg.remat:
        return "remat"
    if cfg.scan_blocks:
        return "scan_blocks"
    if cfg.pipeline_stages != 1:
        return "pipeline_stages"
    if cfg.sequence_parallel:
        return "sequence_parallel"
    if cfg.region_tap_layer is not None:
        return "region_tap_layer"
    if not cfg.fused_mlp:
        return "fused_mlp=False (the port runs kernel 1 in every block)"
    return None


class Attention(nn.Module):
    """VarAttention parameters: fused qkv and the output projection."""

    def __init__(self, dim: int, zeros: bool, device, generator):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, device, generator)
        self.proj = Linear(dim, dim, device, generator)
        if zeros:
            # reference VarAttention initialize='zeros': qkv zeroed, proj
            # weight filled with ONES, proj bias zero (oatx :110-118)
            with torch.no_grad():
                self.qkv.weight.zero_()
                self.proj.weight.fill_(1.0)

    def forward(self, x: torch.Tensor, num_heads: int, num_frames: int,
                mode: str, norm: Optional[LayerNorm] = None) -> torch.Tensor:
        """`norm` given: x is pre-norm and LN→qkv runs as kernel 3."""
        ln = {} if norm is None else dict(ln_w=norm.weight, ln_b=norm.bias,
                                          ln_eps=norm.eps)
        return divided_attention(x, self.qkv.weight, self.qkv.bias,
                                 self.proj.weight, self.proj.bias,
                                 num_heads, num_frames, mode, **ln)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device, generator):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device, generator)
        self.fc2 = Linear(hidden, dim, device, generator)


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: SpaceTimeViTConfig, device, generator):
        super().__init__()
        dim = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = LayerNorm(dim, LN_EPS, device)
        self.norm2 = LayerNorm(dim, LN_EPS, device)
        self.norm3 = LayerNorm(dim, LN_EPS, device)
        self.attn = Attention(dim, False, device, generator)
        self.timeattn = Attention(dim, cfg.time_init == "zeros", device, generator)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), device, generator)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        h = self.cfg.num_heads
        if self.cfg.fused_qkv:
            u = x + self.timeattn(x, h, num_frames, "time", self.norm3)
            r = x + self.attn(u, h, num_frames, "space", self.norm1)
        else:
            u = x + self.timeattn(self.norm3(x), h, num_frames, "time")
            r = x + self.attn(self.norm1(u), h, num_frames, "space")
        m, n2 = self.mlp, self.norm2
        return r + ln_mlp(r, n2.weight, n2.bias, m.fc1.weight, m.fc1.bias,
                          m.fc2.weight, m.fc2.bias, LN_EPS)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SpaceTimeViTConfig, device, generator):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(trunc_normal_(torch.empty(
            cfg.embed_dim, cfg.in_chans, cfg.patch_size, cfg.patch_size,
            device=device), generator))
        self.proj.bias = nn.Parameter(torch.zeros(cfg.embed_dim, device=device))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return patch_embed_conv(frames, self.proj.weight, self.proj.bias,
                                self.patch_size)


class SpaceTimeTransformer(nn.Module):
    def __init__(self, cfg: SpaceTimeViTConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(f"SpaceTimeViTConfig.{bad} is not ported yet")
        if cfg.pooling not in ("cls", "cls_mean_half"):
            raise ValueError(f"unknown pooling {cfg.pooling!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        d, n = cfg.embed_dim, cfg.patches_per_frame
        self.patch_embed = PatchEmbed(cfg, device, generator)
        self.cls_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, d, device=device), generator))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, n + 1, d, device=device), generator))
        self.temporal_embed = nn.Parameter(
            torch.zeros(1, cfg.num_frames, d, device=device))
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, device, generator) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, LN_EPS, device)

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, F, H, W, C) NHWC → tokens (B, 1 + F·N, D), CLS first, with
        the spatial pos-embed tiled per frame and the temporal embed repeated
        per patch (oatx :223-254)."""
        cfg = self.cfg
        b, f, hh, ww, c = video.shape
        if f > cfg.num_frames:
            raise ValueError(f"{f} frames > configured max {cfg.num_frames}")
        n, d, dt = cfg.patches_per_frame, cfg.embed_dim, video.dtype
        tokens = self.patch_embed(video.reshape(b * f, hh, ww, c))
        tokens = tokens.reshape(b, f * n, d)
        pos = self.pos_embed.to(dt)
        tile_pos = pos[:, 1:].repeat(1, cfg.num_frames, 1)
        tile_temporal = self.temporal_embed.to(dt).repeat_interleave(n, dim=1)
        patch_pos = (tile_pos + tile_temporal)[:, : f * n]
        cls = self.cls_token.to(dt).expand(b, 1, d) + pos[:, :1]
        return torch.cat([cls, tokens + patch_pos], dim=1)

    def forward(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """video (B, F, H, W, C) in the compute dtype → dict(cls=(B, D) pooled
        per cfg.pooling, patches=(B, F·N, D) after the final norm)."""
        f = video.shape[1]
        x = self.embed(video)
        for blk in self.blocks:
            x = blk(x, f)
        x = self.norm(x)
        cls, patches = x[:, 0], x[:, 1:]
        if self.cfg.pooling == "cls_mean_half":
            cls = 0.5 * cls + 0.5 * patches.mean(dim=1)
        return {"cls": cls, "patches": patches}
