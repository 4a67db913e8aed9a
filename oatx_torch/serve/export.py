"""Serving artifacts through torch.export (port of oatx/serve/export.py).

Packages the two embedding functions of a DualTower into a directory that a
server runs without the port's model code: only torch, numpy and the
kernels' custom ops (`oatx_torch.ops.kernels`, whose import registers
`oatx_torch::ln_mlp`, `oatx_torch::space_attention` and
`oatx_torch::ln_linear`). The batch dimension is symbolic
(`torch.export.Dim`), so one program serves any batch size.

Artifact layout (a directory):
  video.pt2   torch.export program: uint8 video (b, frames, canon, canon, 3)
              → (b, D) f32 cls embedding, the eval transform included
  text.pt2    torch.export program: int32 ids and mask (b, seq_len) → (b, D)
  meta.json   frames, canon, seq_len, embed_dim, platforms (the device type
              the programs were exported on), raw_dtypes (empty: a program
              keeps its own dtypes) and the int8 report (null at full
              precision)

Each program holds, as its state, the weights its function reads and no
others (the video tower and vid_proj; the text tower and txt_proj). The
kernels are ops in the graphs, so an artifact exported on the card launches
the hand-written kernels, and one exported on the CPU runs their plain
versions. A quantized artifact's state holds the int8 weights and their
scales, with the dequantize in the graph (serve/quant.py).

oatx lowers one artifact for several platforms; a torch.export program
holds the device of its tensors, so `ExportedEmbedder` runs an artifact on
the device type it was exported for and raises on any other, as oatx
raises when explicit platforms are refused.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

# registers the kernels' custom ops, which the programs call
from oatx_torch.ops.kernels import ln_linear, ln_mlp, space_attention  # noqa: F401
from oatx_torch.serve.stats import LatencyStats

EXAMPLE_BATCH = 2  # torch.export specialises a size-1 dimension
MAX_BATCH = 4096


class _Part(nn.Module):
    """The submodules of a DualTower that one function reads, under their
    own names, so the program's state holds those alone."""

    def __init__(self, model: nn.Module, names):
        super().__init__()
        self.cfg = model.cfg
        for n in names:
            setattr(self, n, getattr(model, n))


class _VideoFn(_Part):
    def __init__(self, model, tower_cfg):
        from oatx_torch.train.step import make_augmenter

        super().__init__(model, ("video_model", "vid_proj"))
        self.aug = make_augmenter(train=False, tower_cfg=tower_cfg)

    def forward(self, video_u8: torch.Tensor) -> torch.Tensor:
        from oatx_torch.models.towers import DualTower

        x = self.aug(None, {"video": video_u8})["video"]
        return DualTower.compute_video(self, x)["cls"]


class _TextFn(_Part):
    def __init__(self, model):
        super().__init__(model, ("text_model", "txt_proj"))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        from oatx_torch.models.towers import DualTower

        return DualTower.compute_text(self, input_ids, attention_mask)


def export_embed_fns(model, tower_cfg, *, frames: int, canon: int = 256,
                     seq_len: int = 30):
    """{'video', 'text'}: the two functions exported on the model's device,
    batch symbolic.

    video: (b, frames, canon, canon, 3) uint8 → (b, D) f32, the eval
    transform included (EmbedService's video body without the buckets,
    which the symbolic batch makes unnecessary).
    text: (b, seq_len) int32 ids and mask → (b, D) f32.
    """
    dev = model.device
    model.eval()
    b = torch.export.Dim("b", min=1, max=MAX_BATCH)
    video = torch.zeros((EXAMPLE_BATCH, frames, canon, canon, 3), dtype=torch.uint8,
                        device=dev)
    ids = torch.zeros((EXAMPLE_BATCH, seq_len), dtype=torch.int32, device=dev)
    fns = {"video": (_VideoFn(model, tower_cfg), (video,), ({0: b},)),
           "text": (_TextFn(model), (ids, torch.ones_like(ids)), ({0: b}, {0: b}))}
    out = {}
    for name, (fn, args, dims) in fns.items():
        flags = [p.requires_grad for p in fn.parameters()]
        fn.requires_grad_(False)
        try:
            with torch.no_grad():
                out[name] = torch.export.export(fn, args, dynamic_shapes=dims, strict=False)
        finally:
            for p, f in zip(fn.parameters(), flags):
                p.requires_grad_(f)
    return out


def save_artifact(out_dir, model, tower_cfg, *, frames: int, canon: int = 256,
                  seq_len: int = 30, quantize: Optional[str] = None,
                  quant_min_elems: int = 4096) -> Path:
    """Export and write the artifact directory; returns its path.

    quantize="int8": the weight-only int8 of serve/quant.py, applied to
    `model` in place before the export, so the programs' state holds the
    int8 weights and their graphs the dequantize."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    report = None
    if quantize:
        if quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        from oatx_torch.serve.quant import quantize_model

        report = quantize_model(model, min_elems=quant_min_elems)
    exported = export_embed_fns(model, tower_cfg, frames=frames, canon=canon,
                                seq_len=seq_len)
    for name, ep in exported.items():
        torch.export.save(ep, str(out / f"{name}.pt2"))
    meta = {
        "frames": frames, "canon": canon, "seq_len": seq_len,
        "platforms": [model.device.type],
        "embed_dim": int(tower_cfg.projection_dim),
        "raw_dtypes": {},
        "quantize": report,  # null for full precision
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return out


class ExportedEmbedder:
    """Serve from an exported artifact, with no model code on the import
    path. Mirrors EmbedService's embed_video / embed_text, so the HTTP layer
    can swap backends. `device`: default the device type the artifact was
    exported for (the current card for 'cuda'); another type raises."""

    def __init__(self, artifact_dir, device=None):
        d = Path(artifact_dir)
        self.meta = json.loads((d / "meta.json").read_text())
        platforms = list(self.meta["platforms"])
        dev = torch.device(device if device is not None else platforms[0])
        if dev.type not in platforms:
            raise ValueError(f"artifact {d} was exported for {platforms}, not {dev.type}")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"artifact {d} was exported for CUDA and no card is "
                                   "available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.seq_len = int(self.meta["seq_len"])  # handler contract
        # the programs take a symbolic batch: no bucketing, but the attribute
        # keeps EmbedService's interface (cli.serve's startup banner reads it)
        self.buckets = ()
        self.stats = {"video": LatencyStats(), "text": LatencyStats()}
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            self._video = torch.export.load(str(d / "video.pt2")).module()
            self._text = torch.export.load(str(d / "text.pt2")).module()

    def _run(self, fn, *arrays) -> np.ndarray:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]
        with torch.no_grad():
            return fn(*args).cpu().numpy()

    def embed_video(self, video_u8: np.ndarray) -> np.ndarray:
        expect = (self.meta["frames"], self.meta["canon"], self.meta["canon"], 3)
        if tuple(video_u8.shape[1:]) != expect:
            raise ValueError(f"video shape {video_u8.shape[1:]} != exported {expect}")
        t0 = time.perf_counter()
        out = self._run(self._video, np.asarray(video_u8, np.uint8))
        self.stats["video"].add((time.perf_counter() - t0) * 1e3)
        return out

    def embed_text(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        ids = _pad_or_trim(np.asarray(input_ids, np.int32), self.seq_len)
        mask = _pad_or_trim(np.asarray(attention_mask, np.int32), self.seq_len)
        t0 = time.perf_counter()
        out = self._run(self._text, ids, mask)
        self.stats["text"].add((time.perf_counter() - t0) * 1e3)
        return out

    def latency_summary(self):
        return {k: v.summary() for k, v in self.stats.items()}


def _pad_or_trim(x: np.ndarray, length: int) -> np.ndarray:
    """The exported text programs have a fixed token length (only the batch
    is symbolic): right-pad with zeros or trim to fit, like the service's
    fixed-seq_len tokenizer contract."""
    if x.shape[1] == length:
        return x
    if x.shape[1] > length:
        return x[:, :length]
    pad = np.zeros((x.shape[0], length - x.shape[1]), x.dtype)
    return np.concatenate([x, pad], axis=1)
