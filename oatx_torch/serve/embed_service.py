"""Batched video/text → embedding serving path
(port of oatx/serve/embed_service.py:21-254).

Requests are padded up to the nearest batch bucket, and a batch between
buckets may be split into a cheaper plan of smaller buckets (`_chunks`,
unchanged from oatx). uint8 frames go to the device as uint8; the eval
transform and both towers run there; latency is measured to the host copy of
the result (which waits for the device). `MicroBatcher` coalesces concurrent
single-clip requests from its own thread; the kernels launch on that
thread's current CUDA stream.

quantize="int8" serves weight-only int8 towers (serve/quant.py): the model
is quantized in place on the device, its kernels held as int8 and
dequantized where each is used; any other mode raises ValueError, as in
oatx. The exported-artifact backend is serve/export.py's ExportedEmbedder.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.data.transforms import TransformConfig, eval_transform
from oatx_torch.serve.quant import quantize_model
from oatx_torch.serve.stats import LatencyStats


class EmbedService:
    """Dual-tower embedding service over a `DualTower` on one device."""

    def __init__(self, model, tower_cfg, buckets: Sequence[int] = (1, 4, 16),
                 seq_len: int = 30, scan_chunk: int = 8,
                 quantize: Optional[str] = None, quant_min_elems: int = 4096,
                 device: DeviceLike = None):
        if quantize and quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # quant_min_elems mirrors oatx's knob, so small towers can quantize too
        self.quant_report = (quantize_model(self.model, min_elems=quant_min_elems)
                             if quantize else None)
        self.cfg = tower_cfg
        self.buckets = sorted(buckets)
        self.seq_len = seq_len
        self.scan_chunk = scan_chunk
        self.stats = {"video": LatencyStats(), "text": LatencyStats()}
        self.tower_calls = {"video": 0, "text": 0}  # forwards run (observability)
        self._calls_lock = threading.Lock()
        self._tcfg = TransformConfig(input_res=tower_cfg.video.img_size)

    @torch.inference_mode()
    def _video_fn(self, video_u8: np.ndarray) -> np.ndarray:
        v = torch.from_numpy(np.ascontiguousarray(video_u8)).to(self.device)
        n = v.shape[0]
        # buckets divisible by scan_chunk run as a loop over sub-batches with
        # the same outputs (oatx scans them inside one jit, step.py:366-388)
        step = self.scan_chunk if self.scan_chunk and n % self.scan_chunk == 0 else n
        outs = []
        for i in range(0, n, step):
            x = eval_transform(v[i: i + step], self._tcfg)
            outs.append(self.model.compute_video(x)["cls"])
            self._count("video")
        return torch.cat(outs).cpu().numpy()

    @torch.inference_mode()
    def _text_fn(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        ids_t = torch.from_numpy(np.ascontiguousarray(ids)).to(self.device)
        mask_t = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)
        self._count("text")
        return self.model.compute_text(ids_t, mask_t).cpu().numpy()

    def _count(self, tower: str) -> None:
        with self._calls_lock:
            self.tower_calls[tower] += 1

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _chunks(self, n: int):
        """Bucket plan for n rows. Padding straight up to the covering bucket
        wastes compute when the gap is large, so n may split into smaller
        buckets. Plans are compared with a linear cost proxy
        cost(chunk) = F + bucket(chunk) rows, where the per-call fixed cost F
        is one smallest-bucket's worth of rows — this keeps degenerate
        all-unit plans (3 -> 1+1+1) from beating a single padded call."""
        b = self._bucket(n)
        if n == b or b == self.buckets[0]:
            return [n]
        plan, rem = [], n
        for size in reversed(self.buckets):
            while rem >= size:
                plan.append(size)
                rem -= size
        if rem:
            plan.append(rem)  # final partial chunk pads to its own bucket
        fixed = self.buckets[0]
        plan_cost = sum(fixed + self._bucket(c) for c in plan)
        if plan_cost < fixed + b:
            return plan
        return [n]

    def warmup(self, frames: int, canon: int = 256) -> None:
        """Run every bucket once before serving: builds and launches the
        kernels and settles the allocator, so the first request is steady."""
        for b in self.buckets:
            self._video_fn(np.zeros((b, frames, canon, canon, 3), np.uint8))
            ids = np.zeros((b, self.seq_len), np.int32)
            self._text_fn(ids, np.ones_like(ids))

    def embed_video(self, video_u8: np.ndarray) -> np.ndarray:
        """(B, F, canon, canon, 3) uint8 → (B, D) float32; records latency.
        Oversize batches are processed in largest-bucket chunks."""
        n = video_u8.shape[0]
        if n > self.buckets[-1]:
            step = self.buckets[-1]
            return np.concatenate([
                self.embed_video(video_u8[i: i + step])
                for i in range(0, n, step)])
        plan = self._chunks(n)
        if len(plan) > 1:
            outs, i = [], 0
            for size in plan:
                outs.append(self.embed_video(video_u8[i: i + size]))
                i += size
            return np.concatenate(outs)
        b = self._bucket(n)
        if n < b:
            pad = np.repeat(video_u8[-1:], b - n, axis=0)
            video_u8 = np.concatenate([video_u8, pad], axis=0)
        t0 = time.perf_counter()
        out = self._video_fn(video_u8)  # host copy = real latency
        self.stats["video"].add((time.perf_counter() - t0) * 1e3)
        return out[:n]

    def embed_text(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        n = input_ids.shape[0]
        if n > self.buckets[-1]:
            step = self.buckets[-1]
            return np.concatenate([
                self.embed_text(input_ids[i: i + step], attention_mask[i: i + step])
                for i in range(0, n, step)])
        b = self._bucket(n)
        if n < b:
            input_ids = np.concatenate(
                [input_ids, np.repeat(input_ids[-1:], b - n, axis=0)])
            attention_mask = np.concatenate(
                [attention_mask, np.repeat(attention_mask[-1:], b - n, axis=0)])
        t0 = time.perf_counter()
        out = self._text_fn(input_ids, attention_mask)
        self.stats["text"].add((time.perf_counter() - t0) * 1e3)
        return out[:n]

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        return {k: v.summary() for k, v in self.stats.items()}


class MicroBatcher:
    """Coalesces concurrent single requests into service batches (max_batch or
    max_wait_ms, whichever first). Thread-based; submit() blocks until the
    embedding is ready."""

    def __init__(self, service: EmbedService, max_batch: int = 16,
                 max_wait_ms: float = 5.0):
        self.service = service
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[Tuple[np.ndarray, queue.Queue]]" = queue.Queue()
        self._stop = False
        self.batch_sizes: list = []  # realized coalesced sizes (observability)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, video_u8: np.ndarray) -> np.ndarray:
        """One clip (F, canon, canon, 3) → (D,) embedding."""
        done: "queue.Queue" = queue.Queue()
        self._q.put((video_u8, done))
        out = done.get()
        if isinstance(out, Exception):
            raise out
        return out

    def _loop(self) -> None:
        while not self._stop:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                # np.stack INSIDE the try: mismatched clip shapes must fail
                # the waiting requests, not kill the batcher thread (which
                # would deadlock every future submit)
                clips = np.stack([v for v, _ in items])
                self.batch_sizes.append(len(items))
                embeds = self.service.embed_video(clips)
                for (_, done), e in zip(items, embeds):
                    done.put(e)
            except Exception as ex:  # propagate to all waiters
                for _, done in items:
                    done.put(ex)

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=1)
