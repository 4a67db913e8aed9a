"""Weights carried into the port.

`state_dict_from_oatx` maps oatx's parameter tree (nested dicts of numpy
arrays, transformer blocks stacked on a leading depth axis) to the reference
FrozenInTime state_dict that `DualTower` loads with strict=True. It is the
port's own copy of the mapping in oatx/models/convert.py:321-384
(`frozen_in_time_to_torch` with `_export_distilbert_text`), variant heads
included: linear kernels (in, out) → weights (out, in), conv kernels
HWIO → OIHW.

`opt_state_from_optax` carries an optax AdamW state (oatx's `make_optimizer`
chain) across through the same key map, so a JAX run can continue in the
port: `AdamW.load_named_state(opt_state_from_optax(...))`.

`load_checkpoint` reads a `.pth` in the {'state_dict', 'epoch'} format that
oatx's `convert.export_torch_checkpoint` writes (and the reference saves),
with any text family (:194-199, 363). A checkpoint with another frame or
patch count has its positional embeddings inflated to the model's
(`inflate_state_dict`, what oatx's `spacetime_vit_overlay_torch` does at
:131-139) before the strict load. The reference schema has no object
tower: a `.pth` without `object_tower.*` / `obj_proj.*` keys leaves the
model's own (fresh) object tower in place. oatx's import drops the object
tower from its params instead (`frozen_in_time_from_torch` returns only
the towers and heads), and its stream-3 forward then fails on the missing
subtree.

`clip_text_from_torch` and `distilbert_from_torch` take an OpenAI CLIP or
HF DistilBERT state_dict (bare or prefixed keys) to the port's tower
(`cli/build_region_memory.py`'s `--clip-ckpt` / `--ckpt`), and
`clip_vision_from_torch` a CLIP state_dict's visual side to the port's
ClipVision (`cli/visualize.py --backbone clip`); `clip_vision_to_torch`
writes that side back under `visual.`.
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


def _distilbert_text(sd, t: Params) -> None:
    """HF DistilBertModel keys under `text_model.` (oatx :229-252)."""
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


def _bert_text(sd, t: Params) -> None:
    """HF BertModel keys under `text_model.` (oatx :254-283)."""
    e = t["embeddings"]
    sd["text_model.embeddings.word_embeddings.weight"] = _np(e["word"])
    sd["text_model.embeddings.position_embeddings.weight"] = _np(e["position"])
    sd["text_model.embeddings.token_type_embeddings.weight"] = _np(e["token_type"])
    _ln(sd, "text_model.embeddings.LayerNorm", e["ln"])
    for i in range(np.asarray(t["layers"]["attn_ln"]["scale"]).shape[0]):
        lp = _layer(t["layers"], i)
        p = f"text_model.encoder.layer.{i}"
        for src, dst in (("q", "attention.self.query"), ("k", "attention.self.key"),
                         ("v", "attention.self.value"), ("out", "attention.output.dense")):
            _dense(sd, f"{p}.{dst}", lp["attn"][src])
        _ln(sd, f"{p}.attention.output.LayerNorm", lp["attn_ln"])
        _dense(sd, f"{p}.intermediate.dense", lp["intermediate"])
        _dense(sd, f"{p}.output.dense", lp["output"])
        _ln(sd, f"{p}.output.LayerNorm", lp["out_ln"])
    _dense(sd, "text_model.pooler.dense", t["pooler"])


def _clip_text(sd, t: Params, prefix: str = "text_model.") -> None:
    """The vendored CLIP's text-side keys (oatx :286-312): the fused (D, 3D)
    qkv kernel is torch MultiheadAttention's in_proj_weight (3D, D);
    text_projection stays (D, E), used as x @ W."""
    sd[f"{prefix}token_embedding.weight"] = _np(t["token_embedding"])
    sd[f"{prefix}positional_embedding"] = _np(t["positional_embedding"])
    for i in range(np.asarray(t["blocks"]["ln_1"]["scale"]).shape[0]):
        bp = _layer(t["blocks"], i)
        p = f"{prefix}transformer.resblocks.{i}"
        _ln(sd, f"{p}.ln_1", bp["ln_1"])
        _ln(sd, f"{p}.ln_2", bp["ln_2"])
        sd[f"{p}.attn.in_proj_weight"] = _t_out(bp["attn"]["qkv"]["kernel"])
        sd[f"{p}.attn.in_proj_bias"] = _np(bp["attn"]["qkv"]["bias"])
        _dense(sd, f"{p}.attn.out_proj", bp["attn"]["out"])
        _dense(sd, f"{p}.mlp.c_fc", bp["mlp"]["fc1"])
        _dense(sd, f"{p}.mlp.c_proj", bp["mlp"]["fc2"])
    _ln(sd, f"{prefix}ln_final", t["ln_final"])
    sd[f"{prefix}text_projection"] = _np(t["text_projection"])


def _object_tower(sd, o: Params) -> None:
    """oatx's object-tower tree under the port's names (`object_tower.*`)."""
    _dense(sd, "object_tower.embed", o["embed"])
    _ln(sd, "object_tower.embed_norm", o["embed_norm"])
    for i in range(np.asarray(o["layers"]["norm1"]["scale"]).shape[0]):
        lp = _layer(o["layers"], i)
        p = f"object_tower.layers.{i}"
        _ln(sd, f"{p}.norm1", lp["norm1"])
        _ln(sd, f"{p}.norm2", lp["norm2"])
        _dense(sd, f"{p}.attn.qkv", lp["attn"]["qkv"])
        _dense(sd, f"{p}.attn.proj", lp["attn"]["proj"])
        _dense(sd, f"{p}.mlp.fc1", lp["mlp"]["fc1"])
        _dense(sd, f"{p}.mlp.fc2", lp["mlp"]["fc2"])
    _ln(sd, "object_tower.norm", o["norm"])
    sd["object_tower.pool_query"] = _np(o["pool_query"])


TEXT_EXPORTS = {"distilbert": _distilbert_text, "bert": _bert_text, "clip": _clip_text}


def state_dict_from_oatx(params: Params, tower_cfg) -> Dict[str, torch.Tensor]:
    """oatx dual-tower params (any text family and variant: `region_norm`,
    `txt_proj_2`, `txt_local_proj`, `vid_local_proj`, `object_tower` and
    `obj_proj` when present) → the state_dict the port loads (CPU f32
    tensors)."""
    if tower_cfg.text_family not in TEXT_EXPORTS:
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

    TEXT_EXPORTS[tower_cfg.text_family](sd, params["text"])
    if "object_tower" in params:
        _object_tower(sd, params["object_tower"])

    # txt_proj = Sequential(ReLU, Linear) → index 1; vid_proj = Sequential(Linear);
    # the variant heads as oatx's converter names them (:375-384)
    for name, key in (("txt_proj", "txt_proj.1"), ("vid_proj", "vid_proj.0"),
                      ("txt_proj_2", "txt_proj_2.1"),
                      ("txt_local_proj", "text_local_proj.1"),
                      ("vid_local_proj", "vid_local_proj.0"), ("obj_proj", "obj_proj")):
        if name in params:
            _dense(sd, key, params[name])
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


def inflate_state_dict(sd: Dict[str, torch.Tensor], video_cfg,
                       temporal_fix: str = "zeros") -> Dict[str, torch.Tensor]:
    """The video tower's pos_embed and temporal_embed resized to `video_cfg`'s
    patch and frame counts (vit_spacetime.inflate_*); other keys unchanged."""
    from oatx_torch.models import vit_spacetime as vst

    out = dict(sd)
    key = "video_model.pos_embed"
    if key in out:
        out[key] = vst.inflate_spatial_embed(out[key], video_cfg.patches_per_frame)
    key = "video_model.temporal_embed"
    if key in out:
        out[key] = vst.inflate_temporal_embed(out[key], video_cfg.num_frames, temporal_fix)
    return out


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth`'s state_dict ({'state_dict': ...} or bare), without a
    DataParallel `module.` prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


OBJECT_KEYS = ("object_tower.", "obj_proj.")


def load_checkpoint(model: nn.Module, path: str, temporal_fix: str = "zeros") -> nn.Module:
    """Load a reference-format `.pth` into a DualTower with strict=True, its
    positional embeddings inflated to the model's geometry first; a model
    with an object tower keeps its own when the file has none (module
    docstring)."""
    sd = inflate_state_dict(load_torch_state(path), model.cfg.video, temporal_fix)
    if not any(k.startswith(OBJECT_KEYS) for k in sd):
        sd.update({k: v for k, v in model.state_dict().items() if k.startswith(OBJECT_KEYS)})
    model.load_state_dict(sd, strict=True)
    return model


def _strip_prefix(sd: Dict[str, Any], prefixes, probe: str) -> Dict[str, Any]:
    """Keys under the first of `prefixes` whose `probe` key exists, with the
    prefix taken off (oatx's converters accept bare and prefixed keys)."""
    for pfx in prefixes:
        if pfx + probe in sd:
            return {k[len(pfx):]: v for k, v in sd.items() if k.startswith(pfx)}
    return sd


def clip_text_from_torch(sd: Dict[str, Any], device=None):
    """An OpenAI / vendored-CLIP state_dict (full, text side only, or under
    `text_model.`) → (ClipText, ClipTextConfig), the geometry inferred as
    oatx's `clip_text_from_torch` infers it (:489-536): heads = width / 64."""
    from oatx_torch.models import clip_text as ct

    sd = _strip_prefix(sd, ("text_model.",), "token_embedding.weight")
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    width = int(sd["ln_final.weight"].shape[0])
    cfg = ct.ClipTextConfig(vocab_size=int(sd["token_embedding.weight"].shape[0]),
                            context_length=int(sd["positional_embedding"].shape[0]),
                            width=width, heads=width // 64, layers=n_layers,
                            embed_dim=int(sd["text_projection"].shape[1]))
    model = ct.ClipText(cfg, device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if not k.startswith("visual.") and k in model.state_dict()},
                          strict=True)
    return model, cfg


def clip_vision_from_torch(sd: Dict[str, Any], device=None):
    """An OpenAI / vendored-CLIP state_dict (full, or its `visual.*` keys, or
    those bare) → (ClipVision, ClipVisionConfig), the geometry inferred as
    oatx's `clip_vision_from_torch` infers it (:403-452): width and patch
    from conv1, the grid from the positional embedding, heads = width / 64."""
    from oatx_torch.models import clip_vision as cv

    sd = _strip_prefix(sd, ("visual.",), "conv1.weight")
    conv1 = sd["conv1.weight"]
    width, patch = int(conv1.shape[0]), int(conv1.shape[-1])
    grid = int(round((sd["positional_embedding"].shape[0] - 1) ** 0.5))
    cfg = cv.ClipVisionConfig(
        input_resolution=grid * patch, patch_size=patch, width=width, heads=width // 64,
        layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        output_dim=int(sd["proj"].shape[1]))
    model = cv.ClipVision(cfg, device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if k in model.state_dict()}, strict=True)
    return model, cfg


def clip_vision_to_torch(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A ClipVision → its `visual.`-prefixed vendored-CLIP state_dict on the
    host (oatx :455-487; round-trips with clip_vision_from_torch)."""
    return {f"visual.{k}": v.detach().cpu() for k, v in model.state_dict().items()}


def distilbert_from_torch(sd: Dict[str, Any], cfg, device=None):
    """An HF DistilBertModel state_dict (bare, `distilbert.` or
    `text_model.` keys) → the port's DistilBert of `cfg`."""
    from oatx_torch.models import distilbert as dbert

    sd = _strip_prefix(sd, ("distilbert.", "text_model."), "embeddings.word_embeddings.weight")
    model = dbert.DistilBert(cfg, device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if k in model.state_dict()}, strict=True)
    return model
