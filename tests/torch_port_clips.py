"""An in-memory dataset for the port's trainer tests, with no JAX import:
tests/torch_dp_worker.py runs it in processes that import torch and
oatx_torch only (torch_port_helpers re-exports it for the tests that hold
the port against oatx)."""

from __future__ import annotations

import os

import numpy as np

from oatx_torch.data.datasets.base import ObjectAwareDataset
from oatx_torch.data.sampling import sample_frames

OBJECT_SLOTS = 8     # the offline extractor's grid (ObjectOptions.extraction_frames)
OBJECT_VLEN = 16     # source-video length the clip's frame indices are drawn from


def write_object_npz(path: str, rng: np.random.Generator, n_boxes: int,
                     image_w: float = 320.0, image_h: float = 240.0) -> None:
    """A BUTD-layout npz (oatx/data/objects.py:59-88): x (n, 2048) features,
    bbox (n, 4) pixel boxes inside the image, info with objects_id in
    [0, 1600), objects_conf and the image size."""
    x1 = rng.uniform(0, image_w * 0.8, n_boxes)
    y1 = rng.uniform(0, image_h * 0.8, n_boxes)
    x2 = np.minimum(x1 + rng.uniform(4, image_w * 0.6, n_boxes), image_w)
    y2 = np.minimum(y1 + rng.uniform(4, image_h * 0.6, n_boxes), image_h)
    info = {"objects_id": rng.integers(0, 1600, n_boxes),
            "objects_conf": rng.uniform(0.1, 1.0, n_boxes).astype(np.float32),
            "image_w": image_w, "image_h": image_h}
    np.savez(path, x=rng.standard_normal((n_boxes, 2048)).astype(np.float32),
             bbox=np.stack([x1, y1, x2, y2], axis=1).astype(np.float32), info=info)


class MemoryClips(ObjectAwareDataset):
    """A map-style dataset held in memory: n seeded uint8 clips (n, F, canon,
    canon, 3) and a distinct caption each. `get_sample(i, rng)` is the
    loaders' interface; with `roll`, the sample's generator also shifts the
    clip's frames, so a test sees that each sample gets its own generator.

    With `object_dir`, each clip also gets a seeded 1-frame object frame and
    one BUTD npz per extraction slot under object_dir/clip{i}/{slot}.npz
    (clip i has (7·i) mod 23 boxes: empty and short lists included; clip 1
    misses its slot-0 file), and samples carry the extras `object_options`
    selects, through the port's `_add_object_extras` after the clip's frame
    indices are drawn from a 16-frame source (`sample_frames`)."""

    dataset_name = "MemoryClips"

    def __init__(self, n: int = 16, frames: int = 2, canon: int = 32, seed: int = 0,
                 roll: bool = False, object_dir: str = None, object_options=None,
                 object_vocab=None):
        super().__init__(object_options, object_vocab)
        rng = np.random.default_rng(seed)
        self.videos = rng.integers(0, 256, (n, frames, canon, canon, 3), dtype=np.uint8)
        self.captions = [f"clip {i} shows thing{i} and more{i % 3}" for i in range(n)]
        self.roll = roll
        self.object_dir = object_dir
        if object_dir is not None:
            self.object_frames = rng.integers(0, 256, (n, 1, canon, canon, 3), dtype=np.uint8)
            for i in range(n):
                os.makedirs(os.path.join(object_dir, f"clip{i}"), exist_ok=True)
                for slot in range(OBJECT_SLOTS):
                    if (i, slot) != (1, 0):
                        write_object_npz(self._get_object_path(i, slot), rng, (7 * i) % 23)

    def __len__(self) -> int:
        return len(self.captions)

    def _get_object_path(self, rec, frame_index: int = 0) -> str:
        return os.path.join(self.object_dir, f"clip{rec}", f"{frame_index}.npz")

    def _decode_object_frame(self, rec, frame_index: int) -> np.ndarray:
        return self.object_frames[rec]

    def base_sample(self, i: int, rng: np.random.Generator):
        video = self.videos[i]
        if self.roll:
            video = np.roll(video, int(rng.integers(0, video.shape[0])), axis=0)
        return {"video": video, "text": self.captions[i], "meta": {"index": i}}

    def get_sample(self, i: int, rng: np.random.Generator):
        sample = self.base_sample(i, rng)
        if self.object_dir is not None:
            idxs = sample_frames(self.videos.shape[1], OBJECT_VLEN, rng=rng)
            self._add_object_extras(sample, i, idxs, OBJECT_VLEN, rng)
        return sample
