"""Weights carried into the port.

`state_dict_from_oatx` maps oatx's parameter tree (nested dicts of numpy
arrays, transformer blocks stacked on a leading depth axis) to the reference
FrozenInTime state_dict that `DualTower` loads with strict=True. It is the
port's own copy of the mapping in oatx/models/convert.py:321-384
(`frozen_in_time_to_torch` with `_export_distilbert_text`): linear kernels
(in, out) → weights (out, in), conv kernels HWIO → OIHW.

`opt_state_from_optax` carries an optax AdamW state (oatx's `make_optimizer`
chain) across through the same key map, so a JAX run can continue in the
port: `AdamW.load_named_state(opt_state_from_optax(...))`.

`load_checkpoint` reads a `.pth` in the {'state_dict', 'epoch'} format that
oatx's `convert.export_torch_checkpoint` writes (and the reference saves).
Positional-embedding inflation on a frame- or patch-count mismatch is not in
this slice: such a checkpoint fails the strict load.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

Params = Dict[str, Any]


def _np(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a))


def _t_out(kernel) -> np.ndarray:
    """(in, out) kernel → torch Linear weight (out, in)."""
    return np.ascontiguousarray(np.asarray(kernel).T)


def _layer(stacked: Params, i: int) -> Params:
    """Layer i of a tree whose leaves are stacked on axis 0."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return np.asarray(stacked)[i]


def _dense(sd, key: str, p: Params) -> None:
    sd[f"{key}.weight"] = _t_out(p["kernel"])
    sd[f"{key}.bias"] = _np(p["bias"])


def _ln(sd, key: str, p: Params) -> None:
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])


def state_dict_from_oatx(params: Params, tower_cfg) -> Dict[str, torch.Tensor]:
    """oatx dual-tower params (baseline, distilbert) → the reference-schema
    state_dict the port loads (CPU f32 tensors)."""
    if tower_cfg.text_family != "distilbert":
        raise NotImplementedError(f"text family {tower_cfg.text_family!r}")
    sd: Dict[str, np.ndarray] = {}
    v = params["video"]
    sd["video_model.patch_embed.proj.weight"] = np.ascontiguousarray(
        np.asarray(v["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd["video_model.patch_embed.proj.bias"] = _np(v["patch_embed"]["bias"])
    for name in ("cls_token", "pos_embed", "temporal_embed"):
        sd[f"video_model.{name}"] = _np(v[name])
    _ln(sd, "video_model.norm", v["norm"])
    if "region_norm" in v:
        _ln(sd, "video_model.region_norm", v["region_norm"])
    for i in range(tower_cfg.video.depth):
        bp = _layer(v["blocks"], i)
        p = f"video_model.blocks.{i}"
        for ln in ("norm1", "norm2", "norm3"):
            _ln(sd, f"{p}.{ln}", bp[ln])
        for attn in ("attn", "timeattn"):
            _dense(sd, f"{p}.{attn}.qkv", bp[attn]["qkv"])
            _dense(sd, f"{p}.{attn}.proj", bp[attn]["proj"])
        _dense(sd, f"{p}.mlp.fc1", bp["mlp"]["fc1"])
        _dense(sd, f"{p}.mlp.fc2", bp["mlp"]["fc2"])

    t = params["text"]
    e = t["embeddings"]
    sd["text_model.embeddings.word_embeddings.weight"] = _np(e["word"])
    sd["text_model.embeddings.position_embeddings.weight"] = _np(e["position"])
    _ln(sd, "text_model.embeddings.LayerNorm", e["ln"])
    for i in range(np.asarray(t["layers"]["sa_ln"]["scale"]).shape[0]):
        lp = _layer(t["layers"], i)
        p = f"text_model.transformer.layer.{i}"
        for src, dst in (("q", "q_lin"), ("k", "k_lin"), ("v", "v_lin"),
                         ("out", "out_lin")):
            _dense(sd, f"{p}.attention.{dst}", lp["attn"][src])
        _ln(sd, f"{p}.sa_layer_norm", lp["sa_ln"])
        _dense(sd, f"{p}.ffn.lin1", lp["ffn"]["lin1"])
        _dense(sd, f"{p}.ffn.lin2", lp["ffn"]["lin2"])
        _ln(sd, f"{p}.output_layer_norm", lp["out_ln"])

    # txt_proj = Sequential(ReLU, Linear) → index 1; vid_proj = Sequential(Linear)
    if "txt_proj" in params:
        _dense(sd, "txt_proj.1", params["txt_proj"])
    if "vid_proj" in params:
        _dense(sd, "vid_proj.0", params["vid_proj"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # writable copies


def _find_state(state, has: str):
    """The first node of a nested optax state (tuples of NamedTuples) that
    has every attribute named in `has`."""
    if all(hasattr(state, a) for a in has.split()):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            hit = _find_state(sub, has)
            if hit is not None:
                return hit
    return None


def opt_state_from_optax(opt_state, tower_cfg) -> Dict[str, Any]:
    """optax AdamW state → {'count', 'mu', 'nu'[, 'ema']} with the moments
    (and the EMA params, when the chain has one) keyed like the port's
    parameters, for `train.optim.AdamW.load_named_state`."""
    adam = _find_state(opt_state, "count mu nu")
    if adam is None:
        raise ValueError("no AdamW (ScaleByAdamState) in the optimizer state")
    out: Dict[str, Any] = {"count": int(np.asarray(adam.count)),
                           "mu": state_dict_from_oatx(adam.mu, tower_cfg),
                           "nu": state_dict_from_oatx(adam.nu, tower_cfg)}
    ema = _find_state(opt_state, "ema")
    if ema is not None:
        out["ema"] = state_dict_from_oatx(ema.ema, tower_cfg)
    return out


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a reference-format `.pth` ({'state_dict': ..., 'epoch': ...} or a
    bare state_dict) into `model` with strict=True."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    sd = {k[len("module."):] if k.startswith("module.") else k: v  # DataParallel
          for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model
