"""Offline object-feature extraction (port of oatx/data/extraction.py).

The reference's ObjectExtractor runs an external BUTD / detectron2 detector
over 8 uniformly sampled frames per clip and writes one `.npz {x, bbox,
info}` per frame, resumably. This module keeps oatx's pipeline (work-list
sharding over a worker pool, the uniform frame grid decoded by the port's
reader, resumable skips, the loss list, the stats) with the same three
detectors:

  * StubDetector         — deterministic synthetic regions from a hash of the
                           frame's pixels, numpy on the host (hermetic).
  * TorchScriptDetector  — any detector exported as TorchScript
                           (torch.jit.load), run on the port's device.
  * RoiBackboneExtractor — proposer boxes pooled by ROI-align
                           (ops/roi_align.py) from the final patch grid of
                           the port's own video tower, one frame at a time;
                           on a card the tower's blocks run kernels 1 and 2.

The output is the contract the training-side readers take
(data/objects.py `_load_npz`). The detectors that use torch run on CUDA
unless the caller names another device; the stub never touches one.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from oatx_torch import resolve_device
from oatx_torch.data import transforms as T
from oatx_torch.data.sampling import sample_frames
from oatx_torch.ops.roi_align import roi_align

Detection = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
# (features (N, 2048), boxes (N, 4) xyxy pixels, class_ids (N,), confidences (N,))


class StubDetector:
    """Deterministic pseudo-detector: features and boxes drawn from a seed
    that hashes the frame's pixels (their uint64 sum mod 2³¹), in oatx's
    order of numpy draws, so the same frame gives oatx's regions exactly."""

    def __init__(self, num_regions: int = 10, num_classes: int = 1600,
                 feature_dim: int = 2048):
        self.num_regions = num_regions
        self.num_classes = num_classes
        self.feature_dim = feature_dim

    def __call__(self, frame_rgb: np.ndarray) -> Detection:
        h, w = frame_rgb.shape[:2]
        seed = int(np.asarray(frame_rgb, np.uint64).sum() % (2**31))
        rng = np.random.default_rng(seed)
        n = self.num_regions
        feats = np.abs(rng.standard_normal((n, self.feature_dim))).astype(np.float32)
        x1 = rng.uniform(0, w * 0.6, n)
        y1 = rng.uniform(0, h * 0.6, n)
        boxes = np.stack([
            x1, y1,
            x1 + rng.uniform(w * 0.2, w * 0.4, n),
            y1 + rng.uniform(h * 0.2, h * 0.4, n),
        ], axis=1).astype(np.float32)
        boxes[:, 2] = np.minimum(boxes[:, 2], w - 1)
        boxes[:, 3] = np.minimum(boxes[:, 3], h - 1)
        ids = rng.integers(0, self.num_classes, n)
        confs = np.sort(rng.uniform(0.3, 1.0, n))[::-1].astype(np.float32)
        return feats, boxes, ids, confs


class TorchScriptDetector:
    """A detector exported as TorchScript, run on `device` (CUDA unless the
    caller names another). Export contract (oatx's): the scripted module maps
    a float32 CHW image in [0, 1] to a 4-tuple (features (N, D), boxes (N, 4)
    xyxy pixels, class_ids (N,), confidences (N,)); the tuple comes back as
    host numpy arrays, features, boxes and confidences float32."""

    def __init__(self, weights_path: str, device=None):
        self.device = resolve_device(device)
        self.module = torch.jit.load(weights_path, map_location=self.device)
        self.module.eval()

    def __call__(self, frame_rgb: np.ndarray) -> Detection:
        img = np.ascontiguousarray(frame_rgb, np.float32) / 255.0
        t = torch.from_numpy(img).to(self.device).permute(2, 0, 1)
        with torch.inference_mode():
            feats, boxes, ids, confs = self.module(t)
        return (feats.cpu().numpy().astype(np.float32),
                boxes.cpu().numpy().astype(np.float32),
                ids.cpu().numpy(),
                confs.cpu().numpy().astype(np.float32))


def load_torch_detector(weights_path: str, device=None) -> TorchScriptDetector:
    """Load a TorchScript detector artifact (see TorchScriptDetector)."""
    return TorchScriptDetector(weights_path, device)


class RoiBackboneExtractor:
    """Region features from proposer boxes and the port's own video tower.

    Each frame is stretch-resized on the host to the tower's square input,
    normalized as data/transforms.py does (uint8 → f32 / 255, ImageNet mean
    and std), cast to the tower's compute dtype and sent through the tower
    as one 1-frame clip under inference mode. Its final patch tokens, in
    f32, form the (g, g) grid that `roi_align` (output_size 2) pools each
    box from; the mean of each box's 2 × 2 bins is its feature, zero-padded
    to the 2048-d slot. Boxes are proposed and stored in the frame's own
    pixels (readers normalize by the stored image_w / image_h).

    `model`: a DualTower (its video_model is used) or a SpaceTimeTransformer,
    whose parameters lie on `device` (CUDA unless the caller names another);
    in bf16 on a card its blocks launch kernels 1 and 2. `proposer(frame) →
    (boxes_xyxy_pixels (K, 4), class_ids (K,), confs (K,))`; by default the
    stub's boxes, ids and confidences. One extractor serves the worker
    threads of `extract_dataset`: a call keeps no state on the object, and a
    lock lets one frame at a time through the tower while the other threads
    decode, resize, propose and write (tower calls of several threads,
    interleaved, contend for the GIL at every launch and slow each other).
    On a card the kernels are built here, before any worker starts."""

    def __init__(self, model, tower_cfg, proposer=None, num_regions: int = 10,
                 output_size: int = 2, feature_pad: int = 2048, device=None):
        self.device = resolve_device(device)
        self.video = getattr(model, "video_model", model)
        held = {p.device for p in self.video.parameters()}
        if held != {self.device}:
            raise ValueError(f"the tower's parameters lie on {sorted(map(str, held))}, "
                             f"not on {self.device}")
        self.dtype = tower_cfg.compute_dtype
        self.num_regions = num_regions
        self.output_size = output_size
        self.feature_pad = feature_pad
        if proposer is None:
            stub = StubDetector(num_regions=num_regions)
            proposer = lambda f: stub(f)[1:]  # noqa: E731  boxes, ids, confs
        self.proposer = proposer
        self.size = tower_cfg.video.img_size
        self.grid = self.size // tower_cfg.video.patch_size
        self._tower = threading.Lock()
        if self.device.type == "cuda":
            from oatx_torch.ops.kernels import _build

            _build.build_all()

    def features(self, frame_sq: np.ndarray, boxes_norm: np.ndarray):
        """(S, S, 3) uint8 frame + (K, 4) normalized xyxy boxes → (K, D) f32
        region features on the device."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(frame_sq)).to(self.device)
            x = T.normalize(x.float() / 255.0, T.TransformConfig(input_res=self.size))
            out = self.video(x[None, None].to(self.dtype))
            patches = out["patches"].float()            # (1, N, D) at F = 1
            fmap = patches.reshape(1, self.grid, self.grid, patches.shape[-1])
            boxes = torch.from_numpy(boxes_norm).to(self.device)[None]
            pooled = roi_align(fmap, boxes, output_size=self.output_size)
            return pooled.mean(dim=(2, 3))[0]

    def __call__(self, frame_rgb: np.ndarray) -> Detection:
        h, w = frame_rgb.shape[:2]
        boxes, ids, confs = self.proposer(frame_rgb)
        boxes = np.asarray(boxes, np.float32)[: self.num_regions]
        norm = boxes / np.asarray([w, h, w, h], np.float32)
        frame_sq = _stretch_resize_u8(frame_rgb, self.size)
        with self._tower:
            feats = self.features(frame_sq, np.clip(norm, 0.0, 1.0)).cpu().numpy()
        if feats.shape[1] < self.feature_pad:
            feats = np.concatenate(
                [feats, np.zeros((feats.shape[0], self.feature_pad - feats.shape[1]),
                                 np.float32)], axis=1)
        return feats.astype(np.float32), boxes, np.asarray(ids), \
            np.asarray(confs, np.float32)


def _stretch_resize_u8(frame: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) uint8 → (size, size, 3) uint8, bilinear, half-pixel
    centres, in numpy on the host."""
    h, w = frame.shape[:2]
    if h == size and w == size:
        return frame
    ys = (np.arange(size) + 0.5) * (h / size) - 0.5
    xs = (np.arange(size) + 0.5) * (w / size) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    f = frame.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return np.clip(top * (1 - wy) + bot * wy + 0.5, 0, 255).astype(np.uint8)


def save_roi_npz(path: str, features, boxes, class_ids, confs,
                 image_w: int, image_h: int) -> None:
    """Write the reference npz format (ObjectExtractor's
    alex_save_roi_features)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    info = {
        "objects_id": np.asarray(class_ids),
        "objects_conf": np.asarray(confs, np.float32),
        "image_w": image_w,
        "image_h": image_h,
    }
    np.savez(path, x=np.asarray(features, np.float32),
             bbox=np.asarray(boxes, np.float32), info=info)


@dataclasses.dataclass
class ExtractionStats:
    processed: int = 0
    skipped: int = 0
    failed: int = 0
    frames: int = 0


def extract_video(
    video_path: str,
    out_dir: str,
    detector: Callable[[np.ndarray], Detection],
    num_extraction_frames: int = 8,
    overwrite: bool = False,
) -> Tuple[int, int]:
    """Extract the uniform frame grid of one clip → out_dir/<slot>.npz.
    Returns (frames_written, frames_skipped). Resumable: a slot whose npz
    exists is skipped unless `overwrite`."""
    from oatx_torch.data import video_reader as vr

    todo = [s for s in range(num_extraction_frames)
            if overwrite or not os.path.exists(os.path.join(out_dir, f"{s}.npz"))]
    if not todo:
        return 0, num_extraction_frames
    with vr.VideoHandle(video_path) as handle:
        vlen, _, w, h = handle.info()
        grid = sample_frames(num_extraction_frames, max(vlen, 1), sample="uniform")
        if len(grid) < num_extraction_frames:
            # a clip shorter than the grid repeats its last frame (the
            # loader's short-video pad); otherwise its later slots never
            # exist and every resumed run retries the clip
            grid = grid + [grid[-1]] * (num_extraction_frames - len(grid))
        frames = handle.decode([grid[s] for s in todo], short_side=0)
    for frame, slot in zip(frames, todo):
        feats, boxes, ids, confs = detector(frame)
        save_roi_npz(os.path.join(out_dir, f"{slot}.npz"),
                     feats, boxes, ids, confs, frame.shape[1], frame.shape[0])
    return len(todo), num_extraction_frames - len(todo)


def _worker(args):
    (worker_id, items, out_root, detector, n_frames, overwrite) = args
    stats = ExtractionStats()
    for video_id, video_path in items:
        try:
            written, skipped = extract_video(
                video_path, os.path.join(out_root, video_id), detector,
                n_frames, overwrite)
            stats.frames += written
            if written:
                stats.processed += 1
            else:
                stats.skipped += 1
        except Exception:
            stats.failed += 1
    return dataclasses.asdict(stats)


def extract_dataset(
    items: Sequence[Tuple[str, str]],
    out_root: str,
    detector: Optional[Callable[[np.ndarray], Detection]] = None,
    num_workers: int = 4,
    num_extraction_frames: int = 8,
    overwrite: bool = False,
    use_processes: bool = False,
) -> Dict:
    """Extract every (video_id, video_path) item with a worker pool: item i
    goes to worker i mod num_workers. Threads by default (the decoder and the
    numpy and torch work release the GIL); use_processes=True runs a `spawn`
    process pool, the reference's model, for a detector that needs process
    isolation. A worker counts a clip that raises under `failed`."""
    detector = detector or StubDetector()
    shards: List[List[Tuple[str, str]]] = [[] for _ in range(num_workers)]
    for i, item in enumerate(items):
        shards[i % num_workers].append(item)
    args = [(w, shard, out_root, detector, num_extraction_frames, overwrite)
            for w, shard in enumerate(shards) if shard]

    t0 = time.time()
    if use_processes:
        with mp.get_context("spawn").Pool(len(args)) as pool:
            results = pool.map(_worker, args)
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(args)) as pool:
            results = list(pool.map(_worker, args))
    total = ExtractionStats()
    for r in results:
        total.processed += r["processed"]
        total.skipped += r["skipped"]
        total.failed += r["failed"]
        total.frames += r["frames"]
    out = dataclasses.asdict(total)
    dt = max(time.time() - t0, 1e-9)
    out["seconds"] = round(dt, 3)
    out["frames_per_sec"] = round(total.frames / dt, 2)
    return out


def missing_items(
    items: Sequence[Tuple[str, str]], out_root: str, num_extraction_frames: int = 8
) -> List[Tuple[str, str]]:
    """The loss list: the items with any per-frame npz missing (the
    reference re-extracts from it)."""
    missing = []
    for video_id, video_path in items:
        d = os.path.join(out_root, video_id)
        if any(not os.path.exists(os.path.join(d, f"{s}.npz"))
               for s in range(num_extraction_frames)):
            missing.append((video_id, video_path))
    return missing
