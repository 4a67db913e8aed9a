"""Offline BUTD object-feature readers and patch-mask rasterization (the
port's own copy of oatx/data/objects.py; numpy only).

The offline extractor writes one `.npz` per frame with
  x:    (N, 2048) float ROI features
  bbox: (N, 4) float [x1, y1, x2, y2] in image pixels
  info: dict with objects_id (N,), objects_conf (N,), image_w, image_h

The readers keep oatx's semantics: confidence-sorted top-k selection
(optionally unique-by-class, with its index quirk), edge padding when fewer
than k regions exist, the 6-d normalized box geometry [x, y, x+w, y+h, w, h],
the bbox → patch-grid mask rasterizers, the tag-token spans and the region
memory bank. Outputs are fixed-shape arrays ready to batch.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

OBJECT_FEATURE_DIM = 2048
BOX_GEOM_DIM = 6
OBJECT_INPUT_DIM = OBJECT_FEATURE_DIM + BOX_GEOM_DIM  # 2054


def load_object_vocab(path: str) -> List[str]:
    """1599-class BUTD vocab; line format 'name[,alias...]'. Index 0 = __background__."""
    classes = ["__background__"]
    with open(path, "r") as f:
        for line in f.readlines():
            classes.append(line.split(",")[0].lower().strip())
    return classes


_NPZ_CACHE_SIZE = 0
_npz_cache: Optional["OrderedDict[str, tuple]"] = None


def set_npz_cache(size: int) -> None:
    """Enable an LRU cache over object-npz reads (multi-epoch training re-reads
    the same small files every epoch). 0 disables."""
    global _NPZ_CACHE_SIZE, _npz_cache
    _NPZ_CACHE_SIZE = size
    _npz_cache = OrderedDict() if size > 0 else None


def _load_npz(object_path: str):
    """(features, boxes, object_ids, conf, image_w, image_h), or None when the
    file is missing or unreadable. Read-only arrays, safe to cache across
    loader threads."""
    if _npz_cache is not None:
        hit = _npz_cache.get(object_path)
        if hit is not None:
            _npz_cache.move_to_end(object_path)
            return hit
    try:
        data = np.load(object_path, allow_pickle=True)
        info = data["info"].item()
        out = (
            np.asarray(data["x"], dtype=np.float32),
            np.asarray(data["bbox"], dtype=np.float32),
            np.asarray(info["objects_id"]),
            np.asarray(info["objects_conf"], dtype=np.float32),
            float(info["image_w"]),
            float(info["image_h"]),
        )
        for a in out[:4]:
            a.setflags(write=False)
    except (OSError, KeyError, ValueError, EOFError):
        return None
    if _npz_cache is not None:
        _npz_cache[object_path] = out
        while len(_npz_cache) > _NPZ_CACHE_SIZE:
            _npz_cache.popitem(last=False)
    return out


def _conf_sort(conf: np.ndarray) -> np.ndarray:
    """Indices sorting regions by descending confidence (argsort[::-1])."""
    return np.argsort(conf)[::-1]


def _edge_pad_rows(a: np.ndarray, top_k: int) -> np.ndarray:
    """Pad the first axis to top_k by repeating the last row (np.pad 'edge');
    an empty array pads with zeros."""
    if a.shape[0] >= top_k:
        return a[:top_k]
    if a.shape[0] == 0:
        return np.zeros((top_k,) + a.shape[1:], dtype=a.dtype)
    reps = np.repeat(a[-1:], top_k - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def scaled_box_geometry(boxes: np.ndarray, image_w: float, image_h: float) -> np.ndarray:
    """(N,4) pixel boxes → (N,6) normalized [x, y, x+w, y+h, w, h]."""
    boxes = np.asarray(boxes, dtype=np.float32)
    w = (boxes[:, 2] - boxes[:, 0]) / image_w
    h = (boxes[:, 3] - boxes[:, 1]) / image_h
    x = boxes[:, 0] / image_w
    y = boxes[:, 1] / image_h
    return np.stack([x, y, x + w, y + h, w, h], axis=1).astype(np.float32)


def read_object_features(object_path: str, top_k: int = 10,
                         unique_classes: bool = False) -> np.ndarray:
    """Top-k ROI features + box geometry → (top_k, 2054) float32.

    With unique_classes, np.unique runs on the object ids in their file
    order, and its indices are applied to the confidence-sorted rows (oatx's
    and the reference's quirk, kept). A missing or corrupt file gives all
    ones."""
    loaded = _load_npz(object_path)
    if loaded is None:
        return np.full((top_k, OBJECT_INPUT_DIM), 1.0, dtype=np.float32)
    features, boxes, object_ids, conf, image_w, image_h = loaded
    order = _conf_sort(conf)
    boxes, features = boxes[order], features[order]
    if unique_classes:
        _, unique_idx = np.unique(object_ids, return_index=True)
        boxes, features = boxes[unique_idx], features[unique_idx]
    boxes = _edge_pad_rows(boxes, top_k)
    features = _edge_pad_rows(features, top_k)
    geom = scaled_box_geometry(boxes, image_w, image_h)
    return np.concatenate([features, geom], axis=1).astype(np.float32)


def read_object_bboxes(object_path: str, top_k: int = 10,
                       unique_classes: bool = False) -> Optional[np.ndarray]:
    """Top-k normalized 6-d box geometry → (top_k, 6) float32, or None if unreadable."""
    loaded = _load_npz(object_path)
    if loaded is None:
        return None
    _, boxes, object_ids, conf, image_w, image_h = loaded
    boxes = boxes[_conf_sort(conf)]
    if unique_classes:
        _, unique_idx = np.unique(object_ids, return_index=True)
        boxes = boxes[unique_idx]
    boxes = _edge_pad_rows(boxes, top_k)
    return scaled_box_geometry(boxes, image_w, image_h)


def read_object_tags(object_path: str, vocab: Sequence[str], top_k: int = 5) -> str:
    """Space-prefixed tag string of the top-k unique classes. np.unique sorts
    class ids ascending, so tags come out in class-id order, not confidence
    order (the reference's quirk, kept). Missing file → ''."""
    loaded = _load_npz(object_path)
    if loaded is None:
        return ""
    _, _, object_ids, conf, _, _ = loaded
    uniq = np.unique(object_ids[_conf_sort(conf)])
    tags = ""
    for n in range(min(len(uniq), top_k)):
        tags += " " + vocab[int(uniq[n]) + 1]
    return tags


def read_object_labels(object_path: str, top_k: int = 30) -> np.ndarray:
    """Unique class ids (ascending), edge-padded to top_k. Missing file → ones."""
    loaded = _load_npz(object_path)
    if loaded is None:
        return np.ones(top_k)
    _, _, object_ids, conf, _, _ = loaded
    uniq = np.unique(object_ids[_conf_sort(conf)])
    return _edge_pad_rows(np.asarray(uniq), top_k)[:top_k]


def read_bboxes_and_ids(object_path: str, top_k: int = 15
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(top_k, 6) normalized geometry + (top_k,) class ids, confidence-sorted
    and edge-padded (the region-memory variant's reader), or None."""
    loaded = _load_npz(object_path)
    if loaded is None:
        return None
    _, boxes, object_ids, conf, image_w, image_h = loaded
    order = _conf_sort(conf)
    boxes, object_ids = boxes[order], object_ids[order]
    boxes = _edge_pad_rows(boxes, top_k)
    object_ids = _edge_pad_rows(np.asarray(object_ids), top_k)
    return scaled_box_geometry(boxes, image_w, image_h), object_ids[:top_k]


def pseudo_label_vector(object_path: str, num_classes: int = 1601,
                        top_k: int = 30) -> np.ndarray:
    """Multi-hot class vector of the file's unique class ids."""
    out = np.zeros(num_classes, dtype=np.float32)
    for label in read_object_labels(object_path, top_k=top_k):
        out[int(label)] = 1.0
    return out


def patch_masks_from_bboxes(bboxes: np.ndarray, patch_rows: int = 14) -> np.ndarray:
    """Normalized boxes → per-object patch masks (N, patch_rows²) float32:
    boxes scaled by patch_rows, rows [int(y1), ceil(y2)), columns
    [int(x1), ceil(x2)). Only [:4] of the 6-d geometry is used; the input is
    not modified."""
    b = np.asarray(bboxes, dtype=np.float32)[:, :4] * patch_rows
    masks = np.zeros((len(b), patch_rows, patch_rows), dtype=np.float32)
    for i, (x1, y1, x2, y2) in enumerate(b):
        masks[i, int(y1): int(np.ceil(y2)), int(x1): int(np.ceil(x2))] = 1.0
    return masks.reshape(len(b), patch_rows * patch_rows)


def single_patch_mask_from_bboxes(bboxes: np.ndarray, patch_rows: int = 14) -> np.ndarray:
    """Union mask over all boxes → (patch_rows²,) float32, with the
    reference's strict inequalities and its i↔x / j↔y transposition kept."""
    b = np.asarray(bboxes, dtype=np.float32)[:, :4] * patch_rows
    mask = np.zeros((patch_rows, patch_rows), dtype=np.float32)
    ii = np.arange(patch_rows)[:, None]  # i index (compared against x coords)
    jj = np.arange(patch_rows)[None, :]  # j index (compared against y coords)
    for x1, y1, x2, y2 in b:
        mask = np.maximum(mask, ((ii > x1) & (ii < x2) & (jj > y1) & (jj < y2))
                          .astype(np.float32))
    return mask.reshape(patch_rows * patch_rows)


def object_tag_token_spans(token_lens: Sequence[int], class_ids: Sequence[int]
                           ) -> Tuple[np.ndarray, int]:
    """Cumulative token end offsets of each object's tag when the tags are
    concatenated (token_lens[c]: the tokenizer length of class c's tag),
    and the total length."""
    ends = np.zeros(len(class_ids), dtype=np.float32)
    end = 0
    for i, c in enumerate(class_ids):
        end += int(token_lens[int(c)])
        ends[i] = end
    return ends, int(end)


class RegionMemoryBank:
    """CLIP-text embeddings of the BUTD classes, a (num_classes, dim) float32
    array indexed by class id (ids clipped into range)."""

    def __init__(self, embeddings: np.ndarray):
        self.embeddings = np.asarray(embeddings, dtype=np.float32)

    @classmethod
    def load(cls, path: str) -> "RegionMemoryBank":
        return cls(np.load(path))

    def lookup(self, class_ids: Sequence[int]) -> np.ndarray:
        idx = np.clip(np.asarray(class_ids, dtype=np.int64), 0, len(self.embeddings) - 1)
        return self.embeddings[idx]
