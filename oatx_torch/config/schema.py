"""Typed experiment configuration — the part the serving path reads
(port of oatx/config/schema.py).

The same reference-schema JSON files load unchanged: `arch` (video_params,
text_params, object_params, projection, load_checkpoint), `trainer.precision`
and the raw dict (for the `tokenizer` key). `build_tower_config` maps them to
the port's `TowerConfig` with a torch dtype in place of oatx's jnp one
(schema.py:27,457).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def _get(d: Dict[str, Any], key: str, default=None):
    v = d.get(key, default)
    return default if v is None else v


@dataclasses.dataclass
class VideoParamsCfg:
    model: str = "SpaceTimeTransformer"
    arch_config: str = "base_patch16_224"
    num_frames: int = 4
    pretrained: bool = True
    time_init: str = "zeros"
    two_outputs: bool = False
    input_res: int = 224
    embed_dim: Optional[int] = None
    depth: Optional[int] = None
    num_heads: Optional[int] = None
    remat: bool = False
    remat_policy: str = "full"
    sequence_parallel: bool = False
    split_cls_stream: Optional[bool] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VideoParamsCfg":
        return cls(
            model=_get(d, "model", "SpaceTimeTransformer"),
            arch_config=_get(d, "arch_config", "base_patch16_224"),
            num_frames=int(_get(d, "num_frames", 4)),
            pretrained=bool(_get(d, "pretrained", True)),
            time_init=_get(d, "time_init", "zeros"),
            two_outputs=bool(_get(d, "two_outputs", False)),
            input_res=int(_get(d, "input_res", 224)),
            embed_dim=d.get("embed_dim"),
            depth=d.get("depth"),
            num_heads=d.get("num_heads"),
            remat=bool(_get(d, "remat", False)),
            remat_policy=_get(d, "remat_policy", "full"),
            sequence_parallel=bool(_get(d, "sequence_parallel", False)),
            split_cls_stream=d.get("split_cls_stream"),
        )


@dataclasses.dataclass
class TextParamsCfg:
    model: str = "distilbert-base-uncased"
    pretrained: bool = True
    input: str = "text"
    two_outputs: bool = False
    object_tags: bool = False
    vocab_size: Optional[int] = None
    dim: Optional[int] = None
    hidden_dim: Optional[int] = None
    n_layers: Optional[int] = None
    n_heads: Optional[int] = None

    @property
    def family(self) -> str:
        """'distilbert' | 'bert' | 'clip' — by the model name's basename."""
        base = self.model.split("/")[-1]
        for fam in ("distilbert", "bert", "clip"):
            if base.startswith(fam):
                return fam
        return base

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TextParamsCfg":
        return cls(
            model=_get(d, "model", "distilbert-base-uncased"),
            pretrained=bool(_get(d, "pretrained", True)),
            input=_get(d, "input", "text"),
            two_outputs=bool(_get(d, "two_outputs", False)),
            object_tags=bool(_get(d, "object_tags", False)),
            vocab_size=d.get("vocab_size"),
            dim=d.get("dim"),
            hidden_dim=d.get("hidden_dim"),
            n_layers=d.get("n_layers"),
            n_heads=d.get("n_heads"),
        )


@dataclasses.dataclass
class ObjectParamsCfg:
    model: str = ""
    top_k: int = 10

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectParamsCfg":
        return cls(model=_get(d, "model", ""), top_k=int(_get(d, "top_k", 10)))


@dataclasses.dataclass
class ArchCfg:
    type: str = "FrozenInTime"
    variant: str = "baseline"
    stream: int = 2
    video_params: VideoParamsCfg = dataclasses.field(default_factory=VideoParamsCfg)
    text_params: TextParamsCfg = dataclasses.field(default_factory=TextParamsCfg)
    object_params: ObjectParamsCfg = dataclasses.field(default_factory=ObjectParamsCfg)
    projection: str = "minimal"
    projection_dim: int = 256
    load_checkpoint: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ArchCfg":
        args = _get(d, "args", {})
        return cls(
            type=_get(d, "type", "FrozenInTime"),
            variant=_get(d, "variant", "baseline"),
            stream=int(_get(d, "stream", 2)),
            video_params=VideoParamsCfg.from_dict(_get(args, "video_params", {})),
            text_params=TextParamsCfg.from_dict(_get(args, "text_params", {})),
            object_params=ObjectParamsCfg.from_dict(_get(args, "object_params", {})),
            projection=_get(args, "projection", "minimal"),
            projection_dim=int(_get(args, "projection_dim", 256)),
            load_checkpoint=_get(args, "load_checkpoint", "") or "",
        )


@dataclasses.dataclass
class TrainerCfg:
    precision: str = "bf16"   # 'bf16' | 'f32' — the compute dtype

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainerCfg":
        return cls(precision=_get(d, "precision", "bf16"))


@dataclasses.dataclass
class ExperimentCfg:
    name: str = "experiment"
    arch: ArchCfg = dataclasses.field(default_factory=ArchCfg)
    trainer: TrainerCfg = dataclasses.field(default_factory=TrainerCfg)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentCfg":
        return cls(
            name=_get(d, "name", "experiment"),
            arch=ArchCfg.from_dict(_get(d, "arch", {})),
            trainer=TrainerCfg.from_dict(_get(d, "trainer", {})),
            raw=d,
        )

    @classmethod
    def from_json(cls, path: str | Path) -> "ExperimentCfg":
        with open(path) as f:
            return cls.from_dict(json.load(f))


ARCH_TABLE = {  # arch_config → (embed_dim, depth, num_heads, patch)
    "base_patch16_224": (768, 12, 12, 16),
    "small_patch16_224": (384, 12, 6, 16),
    "tiny_patch16_224": (192, 12, 3, 16),
    "large_patch16_224": (1024, 24, 16, 16),
    "huge_patch14_224": (1280, 32, 16, 14),
}

def precision_dtype(precision: str) -> torch.dtype:
    """trainer.precision → compute dtype: bf16 for 'bf16', f32 otherwise
    (oatx/cli/serve.py:87-89)."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def build_tower_config(arch: ArchCfg, compute_dtype: Optional[torch.dtype] = None):
    """ArchCfg → oatx_torch.models.towers.TowerConfig (oatx schema.py:397-475)."""
    from oatx_torch.models import distilbert as dbert
    from oatx_torch.models import towers
    from oatx_torch.models import vit_spacetime as vst

    if arch.video_params.model != "SpaceTimeTransformer":
        raise NotImplementedError(f"video model {arch.video_params.model!r}")
    if arch.text_params.family != "distilbert":
        raise NotImplementedError(
            f"text model family {arch.text_params.family!r} is not ported yet")
    if arch.video_params.arch_config not in ARCH_TABLE:
        raise NotImplementedError(f"arch_config {arch.video_params.arch_config!r}")
    if arch.object_params.model or arch.stream == 3:
        raise NotImplementedError("the object tower is not ported yet")
    embed_dim, depth, heads, patch = ARCH_TABLE[arch.video_params.arch_config]
    vp = arch.video_params
    video = vst.SpaceTimeViTConfig(
        img_size=vp.input_res,
        patch_size=patch,
        embed_dim=vp.embed_dim or embed_dim,
        depth=vp.depth or depth,
        num_heads=vp.num_heads or heads,
        num_frames=vp.num_frames,
        time_init=vp.time_init,
        remat=vp.remat,
        remat_policy=vp.remat_policy,
        sequence_parallel=vp.sequence_parallel,
        **({} if vp.split_cls_stream is None
           else {"split_cls_stream": vp.split_cls_stream}),
    )
    tp = arch.text_params
    text = dbert.DistilBertConfig(
        vocab_size=tp.vocab_size or 30522,
        dim=tp.dim or 768,
        hidden_dim=tp.hidden_dim or 3072,
        n_layers=tp.n_layers or 6,
        n_heads=tp.n_heads or 12,
    )
    return towers.TowerConfig(
        video=video,
        text=text,
        text_family=tp.family,
        projection_dim=arch.projection_dim,
        projection=arch.projection,
        variant=arch.variant,
        compute_dtype=torch.float32 if compute_dtype is None else compute_dtype,
    )
