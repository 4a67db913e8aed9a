"""Dual-tower video-text model, `baseline` variant with a DistilBERT text tower
(port of oatx/models/towers.py:38-187).

    text:  DistilBERT CLS → txt_proj = ReLU → Linear, in f32 (:119-123,166-172)
    video: SpaceTime ViT CLS → vid_proj = Linear, in f32 (:178-187)

Module names follow the reference FrozenInTime state_dict (`video_model.*`,
`text_model.*`, `txt_proj.1`, `vid_proj.0`). The object-aware variants, the
other text families and the object tower are not in this slice and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.models import distilbert as dbert
from oatx_torch.models import vit_spacetime as vst
from oatx_torch.ops.layers import Linear


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    video: vst.SpaceTimeViTConfig = dataclasses.field(default_factory=vst.SpaceTimeViTConfig)
    text: Any = dataclasses.field(default_factory=dbert.DistilBertConfig)
    text_family: str = "distilbert"
    projection_dim: int = 256
    projection: str = "minimal"        # 'minimal' | '' (identity)
    variant: str = "baseline"
    region_embed_dim: int = 512
    compute_dtype: torch.dtype = torch.float32
    object_tower: Optional[Any] = None

    def __post_init__(self):  # oatx TowerConfig.__post_init__ (:53-63)
        if self.variant == "region_mem" and self.video.region_tap_layer is None:
            object.__setattr__(
                self, "video", dataclasses.replace(self.video, region_tap_layer=6))
        if self.variant == "global_local" and self.video.pooling != "cls_mean_half":
            object.__setattr__(
                self, "video", dataclasses.replace(self.video, pooling="cls_mean_half"))


class DualTower(nn.Module):
    def __init__(self, cfg: TowerConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.variant != "baseline":
            raise NotImplementedError(f"variant {cfg.variant!r} is not ported yet")
        if cfg.text_family != "distilbert":
            raise NotImplementedError(
                f"text family {cfg.text_family!r} is not ported yet")
        if cfg.object_tower is not None:
            raise NotImplementedError("the object tower is not ported yet")
        if cfg.projection not in ("minimal", ""):
            raise NotImplementedError(f"projection {cfg.projection!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        self.video_model = vst.SpaceTimeTransformer(cfg.video, device, generator)
        self.text_model = dbert.DistilBert(cfg.text, device, generator)
        if cfg.projection == "minimal":
            self.txt_proj = nn.Sequential(
                nn.ReLU(), Linear(cfg.text.dim, cfg.projection_dim, device, generator))
            self.vid_proj = nn.Sequential(
                Linear(cfg.video.embed_dim, cfg.projection_dim, device, generator))
        else:
            self.txt_proj = self.vid_proj = nn.Identity()

    @property
    def device(self) -> torch.device:
        return self.video_model.pos_embed.device

    def compute_text(self, input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token ids (B, L) → text embedding (B, projection_dim), f32."""
        hidden = self.text_model(input_ids, attention_mask, dtype=self.cfg.compute_dtype)
        return self.txt_proj(hidden[:, 0].float())

    def compute_video(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Normalized frames (B, F, H, W, C) → dict(cls=(B, projection_dim) f32,
        patches=(B, F·N, D) in the compute dtype)."""
        out = self.video_model(video.to(self.cfg.compute_dtype))
        return {"cls": self.vid_proj(out["cls"].float()), "patches": out["patches"]}
