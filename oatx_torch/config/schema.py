"""Typed experiment configuration (port of oatx/config/schema.py).

The same reference-schema JSON files load unchanged, to the same field values
as oatx's: `arch` (video_params, text_params, object_params, projection,
load_checkpoint), `data_loader` (one dict or a list), `optimizer`, `loss`,
`metrics`, `trainer` (every key oatx reads, including its extensions:
precision, fwd_chunk, ema_decay, len_epoch, ...) and the raw dict (for the
`tokenizer` key). `build_tower_config` maps `arch` to the port's
`TowerConfig` with a torch dtype in place of oatx's jnp one (:27,457).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

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
    input_objects: bool = False
    input_object_bboxs: bool = False
    pseudo_labels: bool = False
    top_k: int = 10

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectParamsCfg":
        return cls(
            model=_get(d, "model", ""),
            input_objects=bool(_get(d, "input_objects", False)),
            input_object_bboxs=bool(_get(d, "input_object_bboxs", False)),
            pseudo_labels=bool(_get(d, "pseudo_labels", False)),
            top_k=int(_get(d, "top_k", 10)),
        )


@dataclasses.dataclass
class ArchCfg:
    type: str = "FrozenInTime"
    variant: str = "baseline"
    object: bool = False
    stream: int = 2
    video_params: VideoParamsCfg = dataclasses.field(default_factory=VideoParamsCfg)
    text_params: TextParamsCfg = dataclasses.field(default_factory=TextParamsCfg)
    object_params: ObjectParamsCfg = dataclasses.field(default_factory=ObjectParamsCfg)
    projection: str = "minimal"
    projection_dim: int = 256
    load_checkpoint: str = ""
    load_temporal_fix: str = "zeros"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ArchCfg":
        args = _get(d, "args", {})
        return cls(
            type=_get(d, "type", "FrozenInTime"),
            variant=_get(d, "variant", "baseline"),
            object=bool(_get(d, "object", False)),
            stream=int(_get(d, "stream", 2)),
            video_params=VideoParamsCfg.from_dict(_get(args, "video_params", {})),
            text_params=TextParamsCfg.from_dict(_get(args, "text_params", {})),
            object_params=ObjectParamsCfg.from_dict(_get(args, "object_params", {})),
            projection=_get(args, "projection", "minimal"),
            projection_dim=int(_get(args, "projection_dim", 256)),
            load_checkpoint=_get(args, "load_checkpoint", "") or "",
            load_temporal_fix=_get(args, "load_temporal_fix", "zeros"),
        )


@dataclasses.dataclass
class DataLoaderCfg:
    type: str = "TextVideoDataLoader"
    dataset_name: str = "MSRVTT"
    data_dir: str = ""
    object_dir: str = ""
    metadata_dir: Optional[str] = None
    reader: str = "cv2"
    shuffle: bool = True
    num_workers: int = 4
    batch_size: int = 16
    split: str = "train"
    cut: Optional[str] = None
    subsample: float = 1      # < 1 keeps that fraction of the metadata
    echo_factor: int = 1      # data echoing: E optimizer steps per decoded batch
    text_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    object_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    video_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def input_res(self) -> int:
        return int(_get(self.video_params, "input_res", 224))

    @property
    def num_frames(self) -> int:
        return int(_get(self.video_params, "num_frames", 4))

    @property
    def loading(self) -> str:
        return _get(self.video_params, "loading", "strict")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataLoaderCfg":
        args = _get(d, "args", {})
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(type=_get(d, "type", "TextVideoDataLoader"),
                   **{k: v for k, v in args.items() if k in fields})


@dataclasses.dataclass
class OptimizerCfg:
    type: str = "AdamW"        # AdamW | Adafactor | Lion | SGD, any case (train/optim.py)
    lr: float = 2e-4
    weight_decay: float = 0.01
    grad_clip: Optional[float] = None
    milestones: List[int] = dataclasses.field(default_factory=lambda: [60, 80])
    gamma: float = 0.1
    schedule: str = "step"     # step (reference) | cosine | constant
    warmup_steps: int = 0      # linear 0 → lr ramp before the schedule
    lr_min: float = 0.0        # cosine floor

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OptimizerCfg":
        args = _get(d, "args", {})
        if isinstance(_get(args, "schedule", "step"), (list, tuple)):
            raise ValueError(
                "optimizer.args.schedule is the schedule KIND "
                "(step|cosine|constant); decay epochs go in "
                "optimizer.args.milestones")
        return cls(
            type=_get(d, "type", "AdamW"),
            lr=float(_get(args, "lr", 2e-4)),
            weight_decay=float(_get(args, "weight_decay", 0.01)),
            grad_clip=args.get("grad_clip"),
            milestones=list(_get(args, "milestones", [60, 80])),
            gamma=float(_get(args, "gamma", 0.1)),
            schedule=str(_get(args, "schedule", "step")),
            warmup_steps=int(_get(args, "warmup_steps", 0)),
            lr_min=float(_get(args, "lr_min", 0.0)),
        )


@dataclasses.dataclass
class LossCfg:
    type: str = "NormSoftmaxLoss"
    temperature: float = 0.05
    margin: float = 1.0
    region_bce_weight: float = 0.1
    chunked: bool = False
    chunk_size: int = 4096
    object_nce_weight: float = 0.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LossCfg":
        args = _get(d, "args", {})
        return cls(
            type=_get(d, "type", "NormSoftmaxLoss"),
            temperature=float(_get(args, "temperature", 0.05)),
            margin=float(_get(args, "margin", 1.0)),
            region_bce_weight=float(_get(args, "region_bce_weight", 0.1)),
            chunked=bool(_get(args, "chunked", False)),
            chunk_size=int(_get(args, "chunk_size", 4096)),
            object_nce_weight=float(_get(args, "object_nce_weight", 0.0)),
        )


@dataclasses.dataclass
class TrainerCfg:
    """The trainer keys (oatx schema.py:263-346). What each layout key does
    with one process and with several (`dp_mode`, `grad_reduce_dtype`,
    `dcn_slices`, `fsdp`, `zero1`, `model_parallel`, `pipeline`) is
    parallel/mesh.py's check_layout and the Trainer's gating."""
    epochs: int = 100
    max_samples_per_epoch: int = 1_000_000
    save_dir: str = "exps"
    save_period: int = 5
    verbosity: int = 2
    monitor: str = "min val_loss_0"
    early_stop: int = 10
    init_val: bool = True
    val_period: int = 1        # validate every N epochs (and at the last)
    neptune: bool = False
    precision: str = "bf16"    # 'bf16' | 'f32' — the compute dtype
    model_parallel: int = 1
    dcn_slices: int = 1
    seed: int = 0
    accum_steps: int = 1       # gradient accumulation micro-steps
    fwd_chunk: int = 0         # > 0: checkpointed tower forwards in chunks, loss
    # over the full batch (train/step.py loss_fn)
    dp_mode: str = "auto"      # 'auto' | 'gspmd' | 'manual'
    grad_reduce_dtype: str = ""
    zero1: bool = False
    fsdp: bool = False
    pipeline: bool = False
    pipeline_microbatches: int = 4
    cycle_shorter: bool = False  # wrap shorter loaders instead of truncating
    skip_nonfinite: bool = False  # a non-finite loss/grad step is a no-op
    ema_decay: float = 0.0     # > 0: a parameter EMA in the optimizer state
    ema_eval: bool = True      # validate (and monitor) the EMA when kept
    profile_epoch: int = 0     # > 0: a torch.profiler trace in this epoch
    profile_start_step: int = 5
    profile_steps: int = 4
    async_checkpoint: bool = False  # periodic/best saves written by a thread
    len_epoch: Optional[int] = None  # iteration-based epochs (cycles per epoch)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainerCfg":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ExperimentCfg:
    name: str = "experiment"
    n_gpu: int = 1
    arch: ArchCfg = dataclasses.field(default_factory=ArchCfg)
    data_loaders: List[DataLoaderCfg] = dataclasses.field(default_factory=list)
    optimizer: OptimizerCfg = dataclasses.field(default_factory=OptimizerCfg)
    loss: LossCfg = dataclasses.field(default_factory=LossCfg)
    metrics: List[str] = dataclasses.field(
        default_factory=lambda: ["t2v_metrics", "v2t_metrics"])
    trainer: TrainerCfg = dataclasses.field(default_factory=TrainerCfg)
    visualizer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentCfg":
        dl = _get(d, "data_loader", [])
        if isinstance(dl, dict):
            dl = [dl]
        return cls(
            name=_get(d, "name", "experiment"),
            n_gpu=int(_get(d, "n_gpu", 1)),
            arch=ArchCfg.from_dict(_get(d, "arch", {})),
            data_loaders=[DataLoaderCfg.from_dict(x) for x in dl],
            optimizer=OptimizerCfg.from_dict(_get(d, "optimizer", {})),
            loss=LossCfg.from_dict(_get(d, "loss", {})),
            metrics=list(_get(d, "metrics", ["t2v_metrics", "v2t_metrics"])),
            trainer=TrainerCfg.from_dict(_get(d, "trainer", {})),
            visualizer=_get(d, "visualizer", {}),
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
    if arch.text_params.family not in ("distilbert", "bert", "clip"):
        raise NotImplementedError(f"text model family {arch.text_params.family!r}")
    if arch.video_params.arch_config not in ARCH_TABLE:
        raise NotImplementedError(f"arch_config {arch.video_params.arch_config!r}")
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
    if tp.family == "clip":
        from oatx_torch.models.clip_text import ClipTextConfig

        # dim → transformer width; the embedding output = width (CLIP ViT-B text)
        text = ClipTextConfig(
            vocab_size=tp.vocab_size or 49408,
            width=tp.dim or 512,
            heads=tp.n_heads or (tp.dim or 512) // 64,
            layers=tp.n_layers or 12,
            embed_dim=tp.dim or 512,
        )
    elif tp.family == "bert":
        from oatx_torch.models.bert import BertConfig

        text = BertConfig(
            vocab_size=tp.vocab_size or 30522,
            dim=tp.dim or 768,
            hidden_dim=tp.hidden_dim or 3072,
            n_layers=tp.n_layers or 12,
            n_heads=tp.n_heads or 12,
        )
    else:
        text = dbert.DistilBertConfig(
            vocab_size=tp.vocab_size or 30522,
            dim=tp.dim or 768,
            hidden_dim=tp.hidden_dim or 3072,
            n_layers=tp.n_layers or 6,
            n_heads=tp.n_heads or 12,
        )
    object_tower = None
    if arch.object_params.model or arch.stream == 3:
        # the reference's stream-3 object branch, oatx's working tower
        from oatx_torch.models.object_tower import ObjectTowerConfig

        object_tower = ObjectTowerConfig(top_k=arch.object_params.top_k)
    return towers.TowerConfig(
        video=video,
        text=text,
        text_family=tp.family,
        projection_dim=arch.projection_dim,
        projection=arch.projection,
        variant=arch.variant,
        compute_dtype=torch.float32 if compute_dtype is None else compute_dtype,
        object_tower=object_tower,
    )
