"""Retrieval evaluation (port of oatx/eval/retrieval_eval.py:26-261; the
reference's test.py:57-419).

Embeds the whole eval split with the eval step (`make_eval_step`, chunks of
8), temporal-ensembles sliding-window video embeddings (the mean per video,
the first caption's embedding per video), takes the similarity matrix and
the configured retrieval metrics; `evaluate_multiple_choice` scores
candidate captions per clip (LSMDC_choice) and `evaluate_streams` the four
text / clip / object-frame streams of the global_local variant.

With an object tower (stream 3) and batches that carry 'object' features,
`evaluate` also embeds them (`compute_object`), ensembles them over the same
window groups, and reports the o2v (object ↔ video) and o2t (text ↔ object)
streams when their rows match the videos' (oatx :90-159; the reference's
test.py:287-291). `export_region_maps` writes region_mem's region-grounding
binary maps (visualization/binary_map.py).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.config.registry import METRICS
from oatx_torch.data.loader import ShardedLoader, device_prefetch, padded_batches
from oatx_torch.losses import contrastive as C
from oatx_torch.metrics.retrieval import REQUIRES_QUERY_MASKS
from oatx_torch.train import step as steplib
from oatx_torch.visualization.binary_map import save_binary_map


@dataclasses.dataclass
class EvalResult:
    text_embeds: np.ndarray
    video_embeds: np.ndarray
    sims: np.ndarray
    metrics: Dict[str, Dict[str, float]]
    meta: List[Dict[str, Any]]
    object_streams: Dict[str, Dict[str, Dict[str, float]]] = dataclasses.field(
        default_factory=dict)
    object_embeds: Optional[np.ndarray] = None


def ensemble_windows(text_embeds: np.ndarray, video_embeds: np.ndarray, groups: np.ndarray):
    """Mean video embeddings over each window group, in first-seen order;
    keep the first text embedding per group."""
    uniq, seen = [], {}
    for g in groups:
        if g not in seen:
            seen[g] = len(uniq)
            uniq.append(g)
    v_out = np.zeros((len(uniq), video_embeds.shape[1]), video_embeds.dtype)
    counts = np.zeros(len(uniq))
    first = np.full(len(uniq), -1, np.int64)
    for i, g in enumerate(groups):
        j = seen[g]
        v_out[j] += video_embeds[i]
        counts[j] += 1
        if first[j] < 0:
            first[j] = i
    v_out /= counts[:, None]
    return text_embeds[first], v_out


def _sims(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return C.sim_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _chunk_for(batch_size: int, chunk: Optional[int]) -> Optional[int]:
    """Batches arrive padded to the loader's batch size; a size the chunk
    does not divide runs unchunked."""
    if chunk is None or not (batch_size <= chunk or batch_size % chunk == 0):
        return None
    return chunk


def evaluate(model, tower_cfg, loader: ShardedLoader,
             metric_names: Sequence[str] = ("t2v_metrics", "v2t_metrics"),
             query_masks: Optional[np.ndarray] = None, chunk: Optional[int] = 8,
             device: DeviceLike = None) -> EvalResult:
    dev = resolve_device(device)
    eval_step = steplib.make_eval_step(tower_cfg, chunk=_chunk_for(loader.batch_size, chunk),
                                       device=dev)
    with_objects = getattr(tower_cfg, "object_tower", None) is not None
    texts, vids, objs, metas = [], [], [], []
    for batch, n_valid in device_prefetch(padded_batches(iter(loader), loader.batch_size),
                                          dev):
        meta = batch.pop("meta", [])
        obj_feats = batch.pop("object", None)
        out = eval_step(model, batch)
        texts.append(out["text_embeds"][:n_valid].float().cpu().numpy())
        vids.append(out["video_embeds"][:n_valid].float().cpu().numpy())
        if with_objects and obj_feats is not None:
            with torch.no_grad():
                objs.append(model.compute_object(obj_feats)[:n_valid].cpu().numpy())
        metas.extend(meta[:n_valid])
    text_e = np.concatenate(texts)
    vid_e = np.concatenate(vids)
    obj_e = np.concatenate(objs) if objs else None

    if metas and "window_group" in metas[0]:
        groups = np.asarray([m["window_group"] for m in metas])
        if obj_e is not None:
            _, obj_e = ensemble_windows(text_e, obj_e, groups)
        text_e, vid_e = ensemble_windows(text_e, vid_e, groups)

    if metas and "caption_group" in metas[0]:
        # full-cut protocol: every caption row against one video per group,
        # query masks for the padded caption slots
        groups = np.asarray([m["caption_group"] for m in metas])
        first = np.unique(groups, return_index=True)[1]
        vid_e = vid_e[np.sort(first)]
        if query_masks is None:
            query_masks = np.asarray([m.get("caption_valid", 1) for m in metas])

    sims = _sims(text_e, vid_e)
    results: Dict[str, Dict[str, float]] = {}
    for name in metric_names:
        fn = METRICS.get(name)
        if query_masks is not None:
            results[name] = fn(sims, query_masks)
        elif name in REQUIRES_QUERY_MASKS:
            logging.getLogger("oatx_torch.eval").warning(
                "metric %s needs query_masks (label matrix) — skipped", name)
        else:
            results[name] = fn(sims)

    # the object streams, on the per-row embeds (the full-cut protocol's
    # caption rows do not match the videos' and get none)
    object_streams: Dict[str, Dict[str, Dict[str, float]]] = {}
    if obj_e is not None and obj_e.shape[0] == vid_e.shape[0]:
        for stream, (a, b) in {"o2v": (obj_e, vid_e), "o2t": (text_e, obj_e)}.items():
            s = _sims(a, b)
            object_streams[stream] = {name: METRICS.get(name)(s) for name in metric_names
                                      if name not in REQUIRES_QUERY_MASKS}
    return EvalResult(text_e, vid_e, sims, results, metas, object_streams=object_streams,
                      object_embeds=obj_e)


@torch.no_grad()
def evaluate_multiple_choice(model, tower_cfg, loader: ShardedLoader, tokenizer,
                             device: DeviceLike = None) -> Dict[str, float]:
    """Multiple choice (LSMDC_choice): each sample carries candidate captions
    in meta['choices'] and meta['answer']; each candidate is scored against
    the clip's embedding; accuracy = argmax hits."""
    dev = resolve_device(device)
    aug = steplib.make_augmenter(train=False, tower_cfg=tower_cfg)
    correct = total = 0
    for batch in loader:
        meta = batch.pop("meta", [])
        video = aug(None, {"video": torch.from_numpy(batch["video"]).to(dev)})["video"]
        v_emb = model.compute_video(video)["cls"].float().cpu().numpy()
        for i, m in enumerate(meta):
            choices = m.get("choices")
            if not choices:
                continue
            tok = tokenizer(list(choices), max_length=30)
            t_emb = model.compute_text(
                torch.from_numpy(np.asarray(tok["input_ids"])).to(dev),
                torch.from_numpy(np.asarray(tok["attention_mask"])).to(dev))
            sims = _sims(t_emb.float().cpu().numpy(), v_emb[i: i + 1])
            correct += int(int(np.argmax(sims[:, 0])) == int(m.get("answer", 0)))
            total += 1
    return {"accuracy": 100.0 * correct / max(total, 1), "n": total}


STREAM_KEYS = ("text_embeds", "pad_text_embeds", "video_embeds", "object_img_embeds")


def evaluate_streams(model, tower_cfg, loader: ShardedLoader,
                     metric_names: Sequence[str] = ("t2v_metrics",),
                     device: DeviceLike = None) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The global_local variant's four retrieval streams (the reference's
    test.py:280-374): st2sv short text ↔ clip, lt2sv long text (caption +
    tags) ↔ clip, st2ov / lt2ov the same texts ↔ object frame."""
    dev = resolve_device(device)
    eval_step = steplib.make_eval_step(tower_cfg, chunk=_chunk_for(loader.batch_size, 8),
                                       device=dev)
    acc: Dict[str, List[np.ndarray]] = {k: [] for k in STREAM_KEYS}
    for batch, n_valid in device_prefetch(padded_batches(iter(loader), loader.batch_size),
                                          dev):
        batch.pop("meta", None)
        out = eval_step(model, batch)
        for k in acc:
            acc[k].append(out[k][:n_valid].float().cpu().numpy())
    e = {k: np.concatenate(v) for k, v in acc.items()}
    streams = {
        "st2sv": (e["text_embeds"], e["video_embeds"]),
        "lt2sv": (e["pad_text_embeds"], e["video_embeds"]),
        "st2ov": (e["text_embeds"], e["object_img_embeds"]),
        "lt2ov": (e["pad_text_embeds"], e["object_img_embeds"]),
    }
    return {stream: {name: METRICS.get(name)(_sims(a, b)) for name in metric_names
                     if name not in REQUIRES_QUERY_MASKS}
            for stream, (a, b) in streams.items()}


@torch.no_grad()
def export_region_maps(model, tower_cfg, loader: ShardedLoader, out_dir: str, limit: int = 16,
                       device: DeviceLike = None) -> List[str]:
    """region_mem's region-grounding maps (oatx :264-303; the reference's
    test_region_mem.py:128-170): a forward over each batch in the eval
    transform, the sigmoid of its region_sim_logits, and for each sample
    up to `limit` one PNG `{n}_predict.png` of [raw object frame | GT patch
    mask of the top object | its predicted similarity], labelled with the
    caption's first 40 characters → the paths."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    aug = steplib.make_augmenter(train=False, tower_cfg=tower_cfg)
    paths: List[str] = []
    for batch in loader:
        meta = batch.pop("meta", [])
        out = model.forward_region_mem(aug(None, steplib._to_device(batch, dev)))
        sims = torch.sigmoid(out["region_sim_logits"]).float().cpu().numpy()
        for i in range(sims.shape[0]):
            if len(paths) >= limit:
                return paths
            label = meta[i]["raw_captions"][:40] if i < len(meta) else ""
            paths.append(save_binary_map(os.path.join(out_dir, f"{len(paths)}_predict.png"),
                                         batch["object_frame"][i, 0], batch["patch_masks"][i][0],
                                         sims[i][0], label=label))
    return paths
