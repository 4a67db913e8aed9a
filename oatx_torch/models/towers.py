"""Dual-tower video-text model with a DistilBERT text tower (port of
oatx/models/towers.py:38-324): the `baseline` variant and the object-aware
`global_local` and `region_mem` variants.

    text:  DistilBERT CLS → txt_proj = ReLU → Linear, in f32 (:119-123,166-172);
           global_local pools CLS + mean of the other positions (:166-168;
           the mean spans padding too, as oatx takes it)
    video: SpaceTime ViT CLS → vid_proj = Linear, in f32 (:178-187)
    global_local (:237-281): caption and caption+tags ("pad_text") through
           the text tower, the clip and its 1-frame object frame through the
           shared video tower; patch-mask-pooled object-frame patches →
           vid_local_proj (Linear), tag-token-pooled pad_text tokens →
           text_local_proj (ReLU → Linear)
    region_mem (:284-314): layer-K region tokens of both video streams
           through the shared vid_proj; video embed = (cls + mean(region)) / 2;
           CLIP memory rows → txt_proj_2 (ReLU → Linear 512 → 256); region
           logits = text rows · object-frame region tokens

The text tower by family (:70-117, 148-175): distilbert pools its CLS
row; bert its tanh pooler (f32, cast to the compute dtype); clip (CLIP's
text transformer) its EOT row @ text_projection, so txt_proj reads
embed_dim features and `return_tokens` runs the tower again for the
normalized per-token projections. global_local pools CLS + mean for the
non-clip families, and clip with global_local raises, as in oatx (:84-90).
With an object tower (`object_tower`, stream 3), `compute_object` maps
(B, K, 2054) BUTD features through it and `obj_proj` (Linear, f32) into the
shared space (:190-202).

Under a model axis (`model_parallel` > 1, parallel/sharding.py calls
`enable_model_parallel`) the baseline variant with the DistilBERT text
tower runs tensor-parallel: the ViT and DistilBERT layers split by
Megatron's rules, the projections replicated. The BERT and CLIP text
towers, the object tower and the object-aware variants raise
NotImplementedError there (ROADMAP A8c); no pod recipe uses them.

Under pipeline stages (`trainer.pipeline`, parallel/sharding.py calls
`enable_pipeline`) the video tower's block stack runs over the model
group's stages (models/vit_spacetime.py) and everything else stays whole
on every stage: every text family, the object tower, and the object-aware
variants without a region tap (global_local: the clip and its object
frame, T = 1 + N, each through the same pipelined tower). region_mem taps
layer K and is refused, as oatx refuses a tap under pipeline stages.

Module names follow the reference state_dict (`video_model.*`,
`text_model.*`, `txt_proj.1`, `vid_proj.0`, `txt_proj_2.1`,
`text_local_proj.1`, `vid_local_proj.0`); the object tower, which the
reference lacks, is `object_tower.*` and `obj_proj`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.models import bert as bert_mod
from oatx_torch.models import clip_text as ct
from oatx_torch.models import distilbert as dbert
from oatx_torch.models import object_tower as objt
from oatx_torch.models import vit_spacetime as vst
from oatx_torch.ops.layers import Linear

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    video: vst.SpaceTimeViTConfig = dataclasses.field(default_factory=vst.SpaceTimeViTConfig)
    text: Any = dataclasses.field(default_factory=dbert.DistilBertConfig)
    text_family: str = "distilbert"
    projection_dim: int = 256
    projection: str = "minimal"        # 'minimal' | '' (identity)
    variant: str = "baseline"          # 'baseline' | 'global_local' | 'region_mem'
    region_embed_dim: int = 512        # CLIP text dim of the region memory rows
    compute_dtype: torch.dtype = torch.float32
    object_tower: Optional[Any] = None

    def __post_init__(self):  # oatx TowerConfig.__post_init__ (:53-63)
        if self.variant == "region_mem" and self.video.region_tap_layer is None:
            object.__setattr__(
                self, "video", dataclasses.replace(self.video, region_tap_layer=6))
        if self.variant == "global_local" and self.video.pooling != "cls_mean_half":
            object.__setattr__(
                self, "video", dataclasses.replace(self.video, pooling="cls_mean_half"))


VARIANTS = ("baseline", "global_local", "region_mem")
TEXT_TOWERS = {"distilbert": dbert.DistilBert, "bert": bert_mod.Bert, "clip": ct.ClipText}


def text_out_dim(cfg: TowerConfig) -> int:
    """Width of the pooled text feature txt_proj reads (oatx :70-75)."""
    return cfg.text.embed_dim if cfg.text_family == "clip" else cfg.text.dim


def tag_token_masks(text_lens: torch.Tensor, tag_end_offsets: torch.Tensor,
                    seq_len: int) -> torch.Tensor:
    """Per-object masks over the pad_text tokens (oatx :214-234): object k's
    tag tokens occupy [text_len − 1 + end_{k−1}, text_len − 1 + end_k) (the
    −1 steps over the caption's [SEP]). text_lens (B,) caption token
    counts, tag_end_offsets (B, O) cumulative token ends → (B, O, seq_len)
    f32."""
    b = tag_end_offsets.shape[0]
    pos = torch.arange(seq_len, device=tag_end_offsets.device)[None, None, :]
    ends = tag_end_offsets.to(torch.int32)
    starts = torch.cat([ends.new_zeros(b, 1), ends[:, :-1]], dim=1)
    base = (text_lens.to(torch.int32) - 1)[:, None, None]
    lo = base + starts[:, :, None]
    hi = base + ends[:, :, None]
    return ((pos >= lo) & (pos < hi)).float()


class DualTower(nn.Module):
    def __init__(self, cfg: TowerConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown variant {cfg.variant!r}")
        if cfg.text_family not in TEXT_TOWERS:
            raise NotImplementedError(f"text family {cfg.text_family!r}")
        if cfg.text_family == "clip" and cfg.variant == "global_local":
            # global_local pools per-token hidden features in the text width;
            # the CLIP tower pools through its projection
            raise NotImplementedError(
                "text_family='clip' supports variants 'baseline'/'region_mem'")
        if cfg.projection not in ("minimal", ""):
            raise NotImplementedError(f"projection {cfg.projection!r}")
        if cfg.variant != "baseline" and cfg.projection != "minimal":
            raise ValueError(f"variant {cfg.variant!r} needs projection 'minimal' "
                             "(its heads project into the shared space)")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        self.video_model = vst.SpaceTimeTransformer(cfg.video, device, generator)
        self.text_model = TEXT_TOWERS[cfg.text_family](cfg.text, device, generator)
        if cfg.projection == "minimal":
            self.txt_proj = nn.Sequential(
                nn.ReLU(), Linear(text_out_dim(cfg), cfg.projection_dim, device, generator))
            self.vid_proj = nn.Sequential(
                Linear(cfg.video.embed_dim, cfg.projection_dim, device, generator))
        else:
            self.txt_proj = self.vid_proj = nn.Identity()
        if cfg.variant == "global_local":
            self.text_local_proj = nn.Sequential(
                nn.ReLU(), Linear(cfg.text.dim, cfg.projection_dim, device, generator))
            self.vid_local_proj = nn.Sequential(
                Linear(cfg.video.embed_dim, cfg.projection_dim, device, generator))
        if cfg.variant == "region_mem":
            self.txt_proj_2 = nn.Sequential(
                nn.ReLU(), Linear(cfg.region_embed_dim, cfg.projection_dim, device,
                                  generator))
        if cfg.object_tower is not None:
            self.object_tower = objt.ObjectTower(cfg.object_tower, device, generator)
            self.obj_proj = Linear(cfg.object_tower.dim, cfg.projection_dim, device,
                                   generator)

    @property
    def device(self) -> torch.device:
        return self.video_model.pos_embed.device

    def enable_model_parallel(self, axis, split) -> None:
        """Run the towers tensor-parallel over `axis` (parallel/tensor.py
        ModelAxis); `split`: the parameter names parallel/sharding.py splits
        over it. Raises for what the port does not split (module docstring)."""
        cfg = self.cfg
        for what, bad in (("the text family " + repr(cfg.text_family),
                           cfg.text_family != "distilbert"),
                          (f"the variant {cfg.variant!r}", cfg.variant != "baseline"),
                          ("the object tower (stream 3)", cfg.object_tower is not None)):
            if bad:
                raise NotImplementedError(
                    f"model_parallel={axis.size} with {what}: the port splits the ViT and "
                    "DistilBERT towers of the baseline variant only (not ported yet: "
                    "ROADMAP A8c)")

        def under(prefix):
            return {n[len(prefix):] for n in split if n.startswith(prefix)}

        self.video_model.enable_model_parallel(axis, under("video_model."))
        self.text_model.enable_model_parallel(axis, under("text_model."))

    def enable_pipeline(self, layout) -> None:
        """Run the video tower's blocks as `layout`'s pipeline stages
        (module docstring)."""
        self.video_model.enable_pipeline(layout)

    def pp_partial_params(self):
        """Under pipeline stages: the parameters whose gradient stage 0
        alone computes (the video embedding's)."""
        return self.video_model.pp_partial_params()

    def tp_partial_params(self):
        """Parameters whose gradient each model rank holds in part."""
        return self.video_model.tp_partial_params() + self.text_model.tp_partial_params()

    def compute_text(self, input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None,
                     return_tokens: bool = False
                     ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Token ids (B, L) → text embedding (B, projection_dim), f32; with
        return_tokens also the hidden states (B, L, dim) in the compute
        dtype (clip: the normalized per-token projections)."""
        dt = self.cfg.compute_dtype
        if self.cfg.text_family == "clip":
            emb = self.txt_proj(self.text_model.encode_text(input_ids, dt).float())
            return (emb, self.text_model.encode_text_tokens(input_ids, dt)) \
                if return_tokens else emb
        if self.cfg.text_family == "bert":
            hidden, pooled = self.text_model(input_ids, attention_mask, dtype=dt)
            pooled = pooled.to(dt)
        else:
            hidden = self.text_model(input_ids, attention_mask, dtype=dt)
            pooled = hidden[:, 0]
        if self.cfg.variant == "global_local":
            pooled = hidden[:, 0] + hidden[:, 1:].mean(dim=1)
        emb = self.txt_proj(pooled.float())
        return (emb, hidden) if return_tokens else emb

    def compute_video(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Normalized frames (B, F, H, W, C) → dict(cls=(B, projection_dim)
        f32, patches=(B, F·N, D) in the compute dtype, and with the region
        tap region=(B, F·N, D))."""
        out = self.video_model(video.to(self.cfg.compute_dtype))
        out["cls"] = self.vid_proj(out["cls"].float())
        return out

    def compute_object(self, objects: torch.Tensor) -> torch.Tensor:
        """BUTD features (B, K, 2054) → object embedding (B, projection_dim),
        f32: the tower in the compute dtype, obj_proj in f32."""
        if self.cfg.object_tower is None:
            raise ValueError("object tower not configured")
        pooled = self.object_tower(objects, dtype=self.cfg.compute_dtype)
        return self.obj_proj(pooled.float())

    def forward_baseline(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(text_embeds, video_embeds)."""
        return (self.compute_text(batch["input_ids"], batch.get("attention_mask")),
                self.compute_video(batch["video"])["cls"])

    def forward_global_local(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """batch: input_ids / attention_mask (caption), pad_input_ids /
        pad_attention_mask (caption + tags), video (B, F, ...), object_frame
        (B, 1, ...), patch_masks (B, O, N) over the object frame's patches,
        object_token_masks (B, O) cumulative tag-token ends."""
        text_embeds = self.compute_text(batch["input_ids"], batch.get("attention_mask"))
        pad_text_embeds, pad_text_tokens = self.compute_text(
            batch["pad_input_ids"], batch.get("pad_attention_mask"), return_tokens=True)
        vout = self.compute_video(batch["video"])
        oout = self.compute_video(batch["object_frame"])
        object_region = oout["patches"]
        # patch-mask pooling of the object frame's patches, in the compute dtype
        patch_masks = batch["patch_masks"].to(object_region.dtype)      # (B, O, N)
        region_feat = torch.einsum("bol,blc->boc", patch_masks, object_region)
        # tag-token pooling over the pad_text tokens
        text_lens = batch["attention_mask"].sum(dim=1)
        tmask = tag_token_masks(text_lens, batch["object_token_masks"],
                                pad_text_tokens.shape[1]).to(pad_text_tokens.dtype)
        tags_feat = torch.einsum("bol,blc->boc", tmask, pad_text_tokens)
        return {
            "text_embeds": text_embeds,
            "pad_text_embeds": pad_text_embeds,
            "video_embeds": vout["cls"],
            "object_img_embeds": oout["cls"],
            "region_feat": self.vid_local_proj(region_feat.float()),
            "tags_feat": self.text_local_proj(tags_feat.float()),
        }

    def forward_region_mem(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """batch: input_ids / attention_mask, video (B, F, ...), object_frame
        (B, 1, ...), text_region_embedding (B, K, region_embed_dim). Returns
        the text and video embeds and region_sim_logits (B, K, N), f32."""
        text_embeds = self.compute_text(batch["input_ids"], batch.get("attention_mask"))
        vout = self.compute_video(batch["video"])
        oout = self.compute_video(batch["object_frame"])
        # layer-K region tokens through the SHARED vid_proj
        object_region = self.vid_proj(oout["region"].float())
        video_region = self.vid_proj(vout["region"].float())
        video_embeds = (vout["cls"] + video_region.mean(dim=1)) / 2.0
        text_region = self.txt_proj_2(batch["text_region_embedding"].float())
        region_sim_logits = torch.einsum("bkf,bnf->bkn", text_region, object_region)
        return {"text_embeds": text_embeds, "video_embeds": video_embeds,
                "region_sim_logits": region_sim_logits}

    def forward(self, batch: Batch):
        """The variant's forward (oatx `forward`, :317-324)."""
        return getattr(self, f"forward_{self.cfg.variant}")(batch)
