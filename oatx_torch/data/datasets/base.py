"""Object-aware sample extras (port of oatx/data/datasets/base.py:36-50
`ObjectOptions` and :276-341 `TextVideoDataset._add_object_extras`).

`ObjectAwareDataset` is the base of a map-style dataset (`__len__`,
`get_sample(index, rng)`) whose samples carry the extras an object-aware
variant reads: the caption with its object tags (`pad_text`,
`tag_class_ids`), ROI features (`object`), per-object patch masks of the
object frame (`patch_masks`, `picked_class_ids`), the object frame itself
(`object_frame`), the region memory rows (`text_region_embedding`) and
pseudo labels. The draws are oatx's, in oatx's order, so given the same
`np.random.Generator` a sample equals oatx's.

A subclass names its object npz (`_get_object_path`) and decodes its object
frame (`_decode_object_frame`). Reading the frame from a video file needs
the decode data plane, which is not ported yet (ROADMAP A2): the base
method raises, and an in-memory dataset overrides it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np

from oatx_torch.data import objects as obj
from oatx_torch.data.sampling import aligned_object_frame_index, sample_frames


@dataclasses.dataclass
class ObjectOptions:
    """What object-aware extras a sample carries (selected by model variant)."""
    tags: bool = False              # append object-tag text → pad_text
    tags_top_k: int = 20
    features: bool = False          # (top_k, 2054) ROI features
    features_top_k: int = 10
    unique_classes: bool = False
    patch_masks: bool = False       # (num_mask_objects, patch_rows²) masks of object frame
    num_mask_objects: int = 5
    patch_rows: int = 14            # model patch grid = input_res // patch_size
    object_frame: bool = False      # decode + emit the aligned extraction frame
    region_memory: Optional[obj.RegionMemoryBank] = None  # CLIP rows per class
    extraction_frames: int = 8      # offline extractor grid size
    pseudo_labels: bool = False


class ObjectAwareDataset:
    """Base of a dataset whose samples carry object-aware extras."""

    def __init__(self, object_options: Optional[ObjectOptions] = None,
                 object_vocab: Optional[Sequence[str]] = None):
        self.opts = object_options or ObjectOptions()
        self.object_vocab = list(object_vocab) if object_vocab else None

    def _get_object_path(self, rec, frame_index: int = 0) -> str:
        """The object npz of extraction-grid slot `frame_index` of `rec`."""
        raise NotImplementedError

    def _decode_object_frame(self, rec, frame_index: int) -> np.ndarray:
        """Frame `frame_index` of `rec`'s video as canonical uint8 (1, canon,
        canon, 3)."""
        raise NotImplementedError(
            "decoding the object frame from a video file needs the decode data "
            "plane, which is not ported yet (ROADMAP A2); an in-memory dataset "
            "overrides _decode_object_frame")

    def _add_object_extras(self, sample: Dict[str, Any], rec, frame_idxs: Sequence[int],
                           vlen: int, rng: np.random.Generator) -> None:
        o = self.opts
        if not (o.tags or o.features or o.patch_masks or o.object_frame or
                o.region_memory is not None or o.pseudo_labels):
            return
        grid_slot = aligned_object_frame_index(frame_idxs, max(vlen, 1), o.extraction_frames)
        object_fp = self._get_object_path(rec, grid_slot)

        if o.object_frame:
            grid = sample_frames(o.extraction_frames, max(vlen, 1), sample="uniform")
            sample["object_frame"] = self._decode_object_frame(rec, grid[grid_slot])

        loaded = obj.read_bboxes_and_ids(object_fp, top_k=o.tags_top_k)
        if loaded is None:
            bboxes = np.zeros((o.tags_top_k, 6), np.float32)
            class_ids = np.zeros((o.tags_top_k,), np.int64)
        else:
            bboxes, class_ids = loaded
            class_ids = class_ids.astype(np.int64)

        if o.tags:
            # np.unique's ascending class-id order is the reference's tag order
            vocab = self.object_vocab or []
            uniq = np.unique(class_ids)[: o.tags_top_k]
            tags = ""
            for cid in uniq:
                name = vocab[int(cid) + 1] if vocab and int(cid) + 1 < len(vocab) else f"obj{cid}"
                tags += " " + name
            sample["pad_text"] = sample["text"] + tags
            # fixed-size id list for the token spans; -1 = padding slot
            padded = np.full((o.tags_top_k,), -1, np.int64)
            padded[: len(uniq)] = uniq
            sample["tag_class_ids"] = padded

        if o.features:
            sample["object"] = obj.read_object_features(
                object_fp, top_k=o.features_top_k, unique_classes=o.unique_classes)

        if o.patch_masks:
            k = o.num_mask_objects
            n_avail = len(bboxes)
            pick = rng.permutation(n_avail)[:k] if n_avail >= k else np.arange(n_avail)
            picked = bboxes[pick]
            if len(picked) < k:
                picked = np.concatenate(
                    [picked, np.zeros((k - len(picked), 6), np.float32)], axis=0)
            sample["patch_masks"] = obj.patch_masks_from_bboxes(picked, patch_rows=o.patch_rows)
            sample["picked_class_ids"] = (
                class_ids[pick] if n_avail >= k else
                np.concatenate([class_ids[pick], np.zeros(k - n_avail, np.int64)]))

        if o.region_memory is not None:
            ids = sample.get("picked_class_ids")
            if ids is None:
                ids = class_ids[: o.num_mask_objects]
            sample["text_region_embedding"] = o.region_memory.lookup(ids)

        if o.pseudo_labels:
            sample["pseudo_labels"] = obj.pseudo_label_vector(object_fp)
