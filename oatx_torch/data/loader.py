"""Sharded streaming loader, collation and device prefetch (port of
oatx/data/loader.py:29-385, the reference's DataLoader / DistributedSampler
stack, base_data_loader.py:110-130):

  * ShardedLoader — a map-style dataset (`get_sample(index, rng)`, `len`) →
    an epoch-shuffled, shard-sliced index stream (DistributedSampler with
    drop_last), samples fetched by a thread pool and collated into
    fixed-shape numpy batches. Every sample's generator is seeded from
    (seed, epoch, index) and every shuffle from (seed, epoch, wrap), so a
    batch stream is a pure function of its position (mid-epoch resume skips
    by index arithmetic).
  * MultiLoader — round-robin alternation over N loaders (the reference
    trains CC3M and WebVid as alternating per-step batches,
    trainer_dist.py:146-148).
  * device_prefetch — batches copied to the device ahead of use. On a CUDA
    device each batch is staged in pinned host memory and copied on a side
    stream; the consumer's stream waits on the copy's event, and each tensor
    is recorded on the consumer's stream so the caching allocator keeps it
    until that stream is done with it. On the CPU the same API hands over
    CPU tensors.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.data.tokenizer import WordPieceTokenizer


class Collator:
    """Sample dicts → a fixed-shape numpy batch; captions are tokenized here,
    on the host, like the reference's per-step tokenizer call
    (trainer_dist.py:152)."""

    def __init__(
        self,
        tokenizer: WordPieceTokenizer,
        max_text_len: int = 30,
        max_pad_text_len: int = 60,
        tag_token_lens: Optional[np.ndarray] = None,  # per-class token lengths
    ):
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.max_pad_text_len = max_pad_text_len
        self.tag_token_lens = tag_token_lens

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        batch["video"] = np.stack([s["video"] for s in samples])
        tok = self.tokenizer([s["text"] for s in samples], max_length=self.max_text_len)
        batch["input_ids"] = tok["input_ids"]
        batch["attention_mask"] = tok["attention_mask"]

        if "pad_text" in samples[0]:
            ptok = self.tokenizer([s["pad_text"] for s in samples],
                                  max_length=self.max_pad_text_len)
            batch["pad_input_ids"] = ptok["input_ids"]
            batch["pad_attention_mask"] = ptok["attention_mask"]
        if "object_frame" in samples[0]:
            batch["object_frame"] = np.stack([s["object_frame"] for s in samples])
        if "object" in samples[0]:
            batch["object"] = np.stack([s["object"] for s in samples])
        if "patch_masks" in samples[0]:
            batch["patch_masks"] = np.stack([s["patch_masks"] for s in samples])
        if "text_region_embedding" in samples[0]:
            batch["text_region_embedding"] = np.stack(
                [s["text_region_embedding"] for s in samples])
        if "pseudo_labels" in samples[0]:
            batch["pseudo_labels"] = np.stack([s["pseudo_labels"] for s in samples])
        if "tag_class_ids" in samples[0] and self.tag_token_lens is not None:
            ids = np.stack([s["tag_class_ids"] for s in samples])  # (B, O), -1 pad
            lens = np.where(ids >= 0, self.tag_token_lens[np.clip(ids, 0, None)], 0)
            batch["object_token_masks"] = np.cumsum(lens, axis=1).astype(np.int32)
        batch["meta"] = [s["meta"] for s in samples]
        return batch


def build_tag_token_lens(tokenizer: WordPieceTokenizer, vocab_names: Sequence[str]) -> np.ndarray:
    """Token length of each object class tag (' name' as appended to captions) —
    the reference precomputes this as objects_vocab_token_len.txt."""
    return np.asarray([tokenizer.token_length(n) for n in vocab_names], np.int32)


class ShardedLoader:
    """Iterable over collated batches of one shard of a dataset.

    n_samples/batch_size/dataset_name mirror the reference loader attributes the
    trainer reads (base_data_loader.py / data_loader.py facade)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable,
        shuffle: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        prefetch_batches: int = 4,
        echo_factor: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        # data echoing (Choi et al. 2020, arXiv:1907.05550): yield each decoded
        # batch E times in a row, E optimizer steps per decode. Augmentation
        # runs in the step from a per-step generator, so echoes still get
        # fresh crops, flips and jitter. Echoes count as batches everywhere
        # (len(), max_samples_per_epoch, the LR schedule).
        assert echo_factor >= 1, f"echo_factor must be >= 1, got {echo_factor}"
        self.echo_factor = int(echo_factor)
        self.epoch = 0
        self._wrap = 0  # bumped by MultiLoader(cycle_shorter) for fresh reshuffles

    # reference API surface
    @property
    def n_samples(self) -> int:
        return len(self.dataset)

    @property
    def dataset_name(self) -> str:
        return getattr(self.dataset, "dataset_name", type(self.dataset).__name__)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # reset the wrap counter so the epoch's batch stream is a pure function
        # of (seed, epoch) — a resumed process must see the same wraps as the
        # uninterrupted run (sample-exact mid-epoch resume)
        self._wrap = 0

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self.epoch, self._wrap)).permutation(n)
        if self.drop_last:
            per = n // self.num_shards
            order = order[: per * self.num_shards]
        return order[self.shard_id:: self.num_shards]

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        base = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return base * self.echo_factor

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.iter_batches(0)

    def iter_batches(self, start_batch: int = 0) -> Iterator[Dict[str, Any]]:
        """Iterate this epoch's batches starting at `start_batch` — pure index
        arithmetic on the (seed, epoch, wrap)-keyed stream, so a mid-epoch
        resume skips completed batches WITHOUT decoding them (the skipped
        prefix is never fetched). With echo_factor E, `start_batch` indexes the
        ECHOED stream: decoded batch j covers echoed positions [jE, (j+1)E),
        so resume decodes from j0 = start_batch // E and skips the first
        start_batch % E echoes — still decode-free for the completed prefix."""
        if self.echo_factor > 1:
            j0, skip = divmod(start_batch, self.echo_factor)
            for j, batch in enumerate(self._iter_decoded(j0)):
                for _ in range(self.echo_factor - (skip if j == 0 else 0)):
                    yield batch
            return
        yield from self._iter_decoded(start_batch)

    def _iter_decoded(self, start_batch: int = 0) -> Iterator[Dict[str, Any]]:
        idxs = self._epoch_indices()
        if self.drop_last:
            idxs = idxs[: (len(idxs) // self.batch_size) * self.batch_size]
        idxs = idxs[start_batch * self.batch_size:]

        def fetch(i):
            rng = np.random.default_rng((self.seed, self.epoch, int(i)))
            return self.dataset.get_sample(int(i), rng)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.prefetch_batches * self.batch_size
            futures = {}
            out_pos = 0
            submit_pos = 0

            def top_up():
                nonlocal submit_pos
                while submit_pos < len(idxs) and submit_pos - out_pos < window:
                    futures[submit_pos] = pool.submit(fetch, idxs[submit_pos])
                    submit_pos += 1

            top_up()
            batch_buf: List[Dict[str, Any]] = []
            while out_pos < len(idxs):
                sample = futures.pop(out_pos).result()
                out_pos += 1
                top_up()
                batch_buf.append(sample)
                if len(batch_buf) == self.batch_size:
                    yield self.collate(batch_buf)
                    batch_buf = []
            if batch_buf and not self.drop_last:
                yield self.collate(batch_buf)


class MultiLoader:
    """Round-robin alternation over loaders; each yield is (loader_index, batch).

    cycle_shorter=False (default): length = shortest loader × number of loaders
    (the reference's zip semantics, trainer_dist.py:146). cycle_shorter=True:
    exhausted loaders restart with a fresh shuffle (the reference's inf_loop,
    utils/util.py:95-98) and the epoch ends when the LONGEST loader finishes —
    unequal datasets (e.g. CC3M vs WebVid) aren't truncated. endless=True:
    EVERY exhausted loader rewraps forever (the reference's iteration-based
    mode, trainer_dist.py:76-79) — the consumer must bound the epoch (the
    trainer stops at cycles_per_epoch); __len__ is undefined in this mode."""

    def __init__(self, loaders: Sequence[ShardedLoader], cycle_shorter: bool = False,
                 endless: bool = False):
        self.loaders = list(loaders)
        self.cycle_shorter = cycle_shorter or endless
        self.endless = endless

    def set_epoch(self, epoch: int) -> None:
        for l in self.loaders:
            l.set_epoch(epoch)
            l._wrap = 0

    def __len__(self) -> int:
        if self.endless:
            raise TypeError("endless MultiLoader has no length")
        agg = max if self.cycle_shorter else min
        return agg(len(l) for l in self.loaders) * len(self.loaders)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, skip_cycles: int = 0):
        """Iterate cycles starting at `skip_cycles` (mid-epoch resume): each
        loader is positioned by index arithmetic — wrap count and in-epoch
        offset — so no skipped batch is ever decoded. The resumed stream is
        identical to the uninterrupted run's remainder (each wrap reshuffles
        with the (seed, epoch, wrap) key, which is a pure function of the skip
        count)."""
        its = []
        exhausted = []
        for l in self.loaders:
            n = len(l)
            if skip_cycles and self.cycle_shorter:
                l._wrap = skip_cycles // n
                its.append(l.iter_batches(skip_cycles % n))
                exhausted.append(skip_cycles >= n)
            else:
                its.append(l.iter_batches(skip_cycles))
                exhausted.append(False)
        try:
            while True:
                batches = []
                for li, it in enumerate(its):
                    try:
                        batches.append(next(it))
                    except StopIteration:
                        if not self.cycle_shorter:
                            return
                        exhausted[li] = True
                        if all(exhausted) and not self.endless:
                            return
                        self.loaders[li]._wrap += 1  # fresh reshuffle on wrap
                        its[li] = iter(self.loaders[li])
                        batches.append(next(its[li]))
                for i, b in enumerate(batches):
                    yield i, b
        finally:
            for it in its:  # release loader thread pools on early exit
                close = getattr(it, "close", None)
                if close is not None:
                    close()


class GlobalBatches:
    """The global batches of a data-parallel run, on one process: batch j is
    the j-th batch of each of `shards` (ShardedLoaders over shards 0..n-1 of
    one dataset) concatenated in rank order, as the ranks' gathers see them.
    With the augmenter's draws for the global batch (data/transforms.py) one
    process then trains as n ranks do. A loader for MultiLoader and the
    Trainer: batch_size is the sum of the shards'."""

    def __init__(self, shards: Sequence[ShardedLoader]):
        self.shards = list(shards)
        self.batch_size = sum(l.batch_size for l in self.shards)
        self.dataset = self.shards[0].dataset

    @property
    def dataset_name(self) -> str:
        return self.shards[0].dataset_name

    @property
    def _wrap(self) -> int:
        return self.shards[0]._wrap

    @_wrap.setter
    def _wrap(self, value: int) -> None:
        for l in self.shards:
            l._wrap = value

    def set_epoch(self, epoch: int) -> None:
        for l in self.shards:
            l.set_epoch(epoch)

    def __len__(self) -> int:
        return min(len(l) for l in self.shards)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.iter_batches(0)

    def iter_batches(self, start_batch: int = 0) -> Iterator[Dict[str, Any]]:
        its = [l.iter_batches(start_batch) for l in self.shards]
        try:
            for parts in zip(*its):
                yield {k: (np.concatenate([p[k] for p in parts])
                           if isinstance(parts[0][k], np.ndarray)
                           else [x for p in parts for x in p[k]]) for k in parts[0]}
        finally:
            for it in its:  # release the shards' thread pools on early exit
                it.close()


def pad_batch(batch: Dict[str, Any], multiple: int):
    """Pad a ragged batch (the last eval batch) to a multiple by repeating the
    final sample → (padded_batch, n_valid): every eval step keeps one shape."""
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    n = next(iter(arrays.values())).shape[0]
    if multiple <= 1 or n % multiple == 0:
        return batch, n
    pad = multiple - n % multiple
    out = dict(batch)
    for k, v in arrays.items():
        out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
    return out, n


def padded_batches(iterator, multiple: int):
    """Wrap a batch iterator: yields (padded_batch, n_valid)."""
    for batch in iterator:
        yield pad_batch(batch, multiple)


def device_prefetch(iterator, device: DeviceLike = None, depth: int = 2):
    """Copy numpy batches to `device` (CUDA unless the caller names another)
    in a producer thread, `depth` batches ahead; strings and 'meta' stay on
    the host. Items may be batches, (loader_index, batch) or (batch,
    n_valid). An exception in the producer is raised in the consumer.

    Early-exit safe: when the consumer stops iterating (epoch cap,
    preemption) the producer is released, the source iterator closed and the
    thread joined."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        out = {}
        for k, v in batch.items():
            if k != "meta" and isinstance(v, np.ndarray) and v.dtype != object:
                v = torch.from_numpy(v)
                if side is not None:
                    v = v.pin_memory().to(dev, non_blocking=True)
            out[k] = v
        return out

    def prepare(item):
        if isinstance(item, tuple):  # (idx, batch) or (batch, n_valid)
            a, b = item
            return (put(a), b) if isinstance(a, dict) else (a, put(b))
        return put(item)

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()
    stop = threading.Event()

    def enqueue(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if side is not None:
                torch.cuda.set_device(dev)
            for item in iterator:
                if side is None:
                    prepared, ready = prepare(item), None
                else:
                    with torch.cuda.stream(side):
                        prepared = prepare(item)
                        ready = side.record_event()
                if not enqueue((prepared, ready)):
                    break
            else:
                enqueue(END)
        except BaseException as e:  # raised in the consumer
            enqueue(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def tensors(item):
        parts = item if isinstance(item, tuple) else (item,)
        return [v for p in parts if isinstance(p, dict) for v in p.values()
                if isinstance(v, torch.Tensor)]

    t = threading.Thread(target=producer, daemon=True, name="oatx_torch-prefetch")
    t.start()
    try:
        while True:
            got = q.get()
            if got is END:
                return
            if isinstance(got, BaseException):
                raise got
            item, ready = got
            if ready is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for v in tensors(item):
                    v.record_stream(consumer)
            yield item
    finally:
        stop.set()
        while True:  # drain so a blocked producer can observe stop and exit
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
