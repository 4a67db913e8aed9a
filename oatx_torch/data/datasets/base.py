"""Dataset base classes (port of oatx/data/datasets/base.py).

  * `ObjectOptions` / `ObjectAwareDataset` (oatx :36-50, :276-341): the
    object-aware extras a sample carries (`pad_text`, `tag_class_ids`,
    `object`, `patch_masks`, `picked_class_ids`, `object_frame`,
    `text_region_embedding`, `pseudo_labels`), drawn in oatx's order, so
    given the same `np.random.Generator` a sample equals oatx's. A subclass
    names its object npz (`_get_object_path`) and decodes its object frame
    (`_decode_object_frame`; an in-memory dataset overrides it).
  * `TextVideoDataset` (oatx :52-273): the file-backed dataset. Subclass
    hooks, as the reference's (base_dataset.py:56-66):
        _load_metadata()            → populate self.metadata (records)
        _get_video_path(rec)        → (abs_path, rel_path)
        _get_caption(rec, rng)      → str
        _get_object_path(rec, idx)  → abs path of the frame-idx object npz
    Clips go through the port's decoder (data/video_reader.py): short side
    to `canon`, centre square (or, under `train_crop: reference_full_frame`,
    torchvision's crop of the full frame on the host). 'lax' loading
    substitutes another item on a DecodeError / OSError / AssertionError
    (never on UnsupportedMedia); 'strict' raises.
  * `TextImageDataset` (oatx :344-353): stills through the same decoder.
  * `TextImageTarDataset` (oatx :356-408): stills packed in tar shards; the
    member's bytes go through the decoder (`decode_jpeg_bytes`) at native
    size, then PIL's bilinear resize to the canonical short side, as oatx
    does with PIL.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from oatx_torch.config.schema import DataLoaderCfg
from oatx_torch.data import objects as obj
from oatx_torch.data import video_reader as vr
from oatx_torch.data.host_transforms import (host_canonicalize, host_reference_rrc,
                                             pil_bilinear_resize)
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
            f"{type(self).__name__} holds no video files: a dataset without them "
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


class TextVideoDataset(ObjectAwareDataset):
    is_video = True

    def __init__(self, cfg: DataLoaderCfg, split: Optional[str] = None,
                 object_options: Optional[ObjectOptions] = None,
                 object_vocab: Optional[Sequence[str]] = None, canon: int = 256,
                 sliding_window_stride: int = -1, seed: int = 0):
        super().__init__(object_options, object_vocab)
        self.cfg = cfg
        self.dataset_name = cfg.dataset_name
        self.data_dir = cfg.data_dir
        self.object_dir = cfg.object_dir
        self.metadata_dir = cfg.metadata_dir or cfg.data_dir
        self.split = split or cfg.split
        self.cut = cfg.cut
        self.subsample = cfg.subsample
        self.text_params = cfg.text_params
        self.object_params = cfg.object_params
        self.video_params = cfg.video_params
        self.num_frames = cfg.num_frames
        self.canon = canon
        # 'device_canonical' (the default: the device crops the canonical
        # square) or 'reference_full_frame' (torchvision's crop of the full
        # decoded frame on the host; input_res² frames are shipped)
        self.train_crop = (cfg.video_params or {}).get("train_crop", "device_canonical")
        assert self.train_crop in ("device_canonical", "reference_full_frame"), \
            f"unknown train_crop {self.train_crop!r}"
        self.train_crop_res = int((cfg.video_params or {}).get("input_res", 224))
        if self.train_crop == "reference_full_frame":
            o = object_options
            assert o is None or not (o.object_frame or o.patch_masks), (
                "train_crop='reference_full_frame' supports the baseline variant only "
                "(object_frame/patch_masks need the canonical crop geometry)")
        self.loading = cfg.loading  # 'strict' | 'lax'
        self.sliding_window_stride = sliding_window_stride
        self.seed = seed
        self.metadata: List[Any] = []
        self._load_metadata()
        if self.subsample < 1 and len(self.metadata):
            rng = np.random.default_rng(seed)
            keep = max(1, int(len(self.metadata) * self.subsample))
            idx = rng.permutation(len(self.metadata))[:keep]
            self.metadata = [self.metadata[i] for i in sorted(idx)]

    # ------------------------------------------------------------- hooks

    def _load_metadata(self):
        raise NotImplementedError

    def _get_video_path(self, rec) -> Tuple[str, str]:
        raise NotImplementedError

    def _get_caption(self, rec, rng: np.random.Generator) -> str:
        raise NotImplementedError

    def _get_object_path(self, rec, frame_index: int = 0) -> str:
        rel = self._get_video_rel_stem(rec)
        return os.path.join(self.object_dir, rel, f"{frame_index}.npz")

    def _get_video_rel_stem(self, rec) -> str:
        _, rel = self._get_video_path(rec)
        return os.path.splitext(rel)[0]

    def _decode_object_frame(self, rec, frame_index: int) -> np.ndarray:
        try:
            of = vr.decode_indices(self._get_video_path(rec)[0], [frame_index],
                                   short_side=self.canon)
            return host_canonicalize(of, self.canon)
        except vr.DecodeError:
            return self._black_frames(1)

    # ------------------------------------------------------------- core

    def __len__(self):
        return len(self.metadata)

    def expand_sliding_windows(self, stride: int) -> None:
        """Each video → fixed-start windows for eval-time temporal ensembling
        (the reference's _fix_temporal_samples, with oatx's interval width
        vlen // F); records gain 'fix_start' and 'window_group'."""
        assert stride > 0
        self.sliding_window_stride = stride
        expanded: List[Any] = []
        for gid, rec in enumerate(self.metadata):
            try:
                vlen, _, _, _ = vr.probe(self._get_video_path(rec)[0])
            except vr.DecodeError:
                vlen = self.num_frames
            width = max(1, vlen // max(1, min(vlen, self.num_frames)))
            for fs in range(0, width, stride):
                r = dict(rec)
                r["fix_start"] = int(fs)
                r["window_group"] = gid
                expanded.append(r)
        self.metadata = expanded

    def expand_eval_captions(self, queries_per_video: Optional[int] = None) -> int:
        """Each multi-caption record → one row per caption slot (the full-cut
        protocol); rows gain caption_group and caption_valid (0 for the padded
        slots of videos with fewer captions). Returns queries_per_video."""
        qpv = queries_per_video or max(
            len(rec.get("captions", [None])) for rec in self.metadata)
        expanded: List[Any] = []
        for gid, rec in enumerate(self.metadata):
            caps = rec.get("captions")
            if caps is None:
                caps = [rec.get("caption", "")]
            for ci in range(qpv):
                r = dict(rec)
                valid = ci < len(caps)
                r["captions"] = [caps[ci] if valid else caps[0]]
                r["caption_group"] = gid
                r["caption_valid"] = int(valid)
                expanded.append(r)
        self.metadata = expanded
        return qpv

    def _frame_sample_mode(self) -> str:
        return "uniform" if self.split == "test" else "rand"

    def _host_rrc_active(self) -> bool:
        return self.train_crop == "reference_full_frame" and self.split == "train"

    def _frame_res(self) -> int:
        return self.train_crop_res if self._host_rrc_active() else self.canon

    def _finalize_frames(self, frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """The host finish of every reader: the full-frame crop under the
        reference_full_frame lane, the canonical square otherwise."""
        if self._host_rrc_active():
            return host_reference_rrc(frames, rng, out=self.train_crop_res)
        return host_canonicalize(frames, self.canon)

    def _black_frames(self, n: int) -> np.ndarray:
        r = self._frame_res()
        return np.zeros((n, r, r, 3), np.uint8)

    def _read_video(self, path: str, rng: np.random.Generator,
                    fix_start: Optional[int] = None):
        frames, idxs, vlen = vr.read_frames(
            path, self.num_frames, sample=self._frame_sample_mode(), fix_start=fix_start,
            rng=rng, short_side=0 if self._host_rrc_active() else self.canon)
        frames = self._finalize_frames(frames, rng)
        if frames.shape[0] < self.num_frames:  # short video → repeat the last frame
            pad = np.repeat(frames[-1:], self.num_frames - frames.shape[0], axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        return frames, idxs, vlen

    def get_sample(self, index: int, rng: Optional[np.random.Generator] = None,
                   _depth: int = 0) -> Dict[str, Any]:
        """One sample. 'lax' loading substitutes another item on a decode
        failure (bounded; black frames after 8 tries); 'strict' raises.
        UnsupportedMedia always raises."""
        if rng is None:
            rng = np.random.default_rng((self.seed, index))
        index = index % len(self.metadata)
        rec = self.metadata[index]
        video_fp, rel_fp = self._get_video_path(rec)
        caption = self._get_caption(rec, rng)

        fix_start = None
        if self.sliding_window_stride != -1 and isinstance(rec, dict):
            fix_start = rec.get("fix_start")

        try:
            frames, idxs, vlen = self._read_video(video_fp, rng, fix_start)
        except (vr.DecodeError, AssertionError, OSError) as e:
            if self.loading == "strict":
                raise ValueError(f"Video loading failed for {video_fp}, strict mode") from e
            if _depth >= 8:
                frames, idxs, vlen = self._black_frames(self.num_frames), \
                    [0] * self.num_frames, 1
            else:
                return self.get_sample(int(rng.integers(0, len(self.metadata))), rng,
                                       _depth + 1)

        sample: Dict[str, Any] = {
            "video": frames,
            "text": caption,
            "meta": {"raw_captions": caption, "paths": rel_fp,
                     "dataset": self.dataset_name, "index": index},
        }
        if isinstance(rec, dict) and "window_group" in rec:
            sample["meta"]["window_group"] = rec["window_group"]
        if isinstance(rec, dict) and "caption_group" in rec:
            sample["meta"]["caption_group"] = rec["caption_group"]
            sample["meta"]["caption_valid"] = rec["caption_valid"]
        self._add_object_extras(sample, rec, idxs, vlen, rng)
        return sample

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.get_sample(index)


class TextImageDataset(TextVideoDataset):
    """Image datasets (CC3M): the 1-frame path through the same decoder."""

    is_video = False

    def _read_video(self, path: str, rng, fix_start=None):
        frames = vr.decode_indices(path, [0],
                                   short_side=0 if self._host_rrc_active() else self.canon)
        return self._finalize_frames(frames, rng), [0], 1


class TextImageTarDataset(TextImageDataset):
    """Images packed in tar shards, members addressed as
    '<shard>.tar/<member>'; tar handles per loader thread."""

    def __init__(self, *args, **kwargs):
        self._tls = threading.local()
        super().__init__(*args, **kwargs)

    def _tar_handle(self, tar_path: str):
        import tarfile

        cache = getattr(self._tls, "tars", None)
        if cache is None:
            cache = self._tls.tars = {}
        if tar_path not in cache:
            cache[tar_path] = tarfile.open(tar_path, "r")
        return cache[tar_path]

    def _read_video(self, path: str, rng, fix_start=None):
        if ".tar/" not in path:
            return super()._read_video(path, rng, fix_start)
        tar_path, member = path.split(".tar/", 1)
        tar_path += ".tar"
        try:
            data = self._tar_handle(tar_path).extractfile(member)
            if data is None:
                raise vr.DecodeError(f"tar member missing: {path}")
            frame = self._decode_image_bytes(data.read())
        except (vr.DecodeError, vr.UnsupportedMedia):
            raise
        except Exception as e:
            raise vr.DecodeError(f"tar read failed: {path}: {e}") from e
        return self._finalize_frames(frame[None], rng), [0], 1

    def _decode_image_bytes(self, data: bytes) -> np.ndarray:
        im = vr.decode_jpeg_bytes(data)
        if not self._host_rrc_active():  # the crop lane wants the native size
            h, w = im.shape[:2]
            scale = self.canon / min(w, h)
            im = pil_bilinear_resize(im, max(self.canon, int(w * scale)),
                                     max(self.canon, int(h * scale)))
        return im
