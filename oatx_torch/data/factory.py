"""Config → datasets and loaders (port of oatx/data/factory.py; the
reference's dataset_loader / dataset_object_loader facades,
data_loader/data_loader.py:11-240).

  * `object_options_for_variant` — the extras each variant's samples carry;
  * `load_object_vocab` — the BUTD class names, when the config names a file;
  * `load_region_bank` — region_mem's CLIP memory bank: a `.npy` when the
    config names one, else oatx's seeded (1600, dim) bank, bit for bit;
  * `tag_token_lens_for` — per-class tag token lengths for global_local's
    collator, with oatx's `obj{cid}` fallback names;
  * `build_dataset` — the registered adapter of a data_loader entry with
    its variant's object options;
  * `build_loaders` — one ShardedLoader + Collator per data_loader entry
    (the trainer alternates them through MultiLoader), each over shard
    `shard_id` of `num_shards` (a rank's share under data parallelism).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from oatx_torch.config.registry import DATASETS
from oatx_torch.config.schema import DataLoaderCfg, ExperimentCfg
from oatx_torch.data import objects as obj
from oatx_torch.data.datasets import adapters as _adapters  # noqa: F401 (registers them)
from oatx_torch.data.datasets.base import ObjectOptions
from oatx_torch.data.loader import Collator, ShardedLoader, build_tag_token_lens
from oatx_torch.data.tokenizer import WordPieceTokenizer


def object_options_for_variant(variant: str, dl: DataLoaderCfg,
                               region_bank: Optional[obj.RegionMemoryBank] = None
                               ) -> ObjectOptions:
    op = dl.object_params
    tp = dl.text_params
    patch_rows = dl.input_res // 16  # model patch grid (ViT-B/16)
    if variant == "global_local":
        return ObjectOptions(
            tags=True, tags_top_k=int(op.get("top_k", 20)),
            patch_masks=True, num_mask_objects=int(op.get("num_mask_objects", 20)),
            patch_rows=patch_rows,
            object_frame=True,
            features=bool(op.get("input_objects", False)),
        )
    if variant == "region_mem":
        return ObjectOptions(
            patch_masks=True, num_mask_objects=int(op.get("num_mask_objects", 5)),
            patch_rows=patch_rows,
            tags_top_k=int(op.get("top_k", 15)),
            object_frame=True,
            region_memory=region_bank,
        )
    # baseline: object extras only if explicitly requested
    return ObjectOptions(
        tags=bool(tp.get("object_tags", False)),
        features=bool(op.get("input_objects", False)),
        features_top_k=int(op.get("top_k", 10)),
        pseudo_labels=bool(op.get("pseudo_labels", False)),
    )


def load_object_vocab(dl: DataLoaderCfg) -> Optional[List[str]]:
    path = dl.object_params.get("vocab_path")
    if path and os.path.exists(path):
        return obj.load_object_vocab(path)
    return None


def load_region_bank(exp: ExperimentCfg, dim: int = 512) -> Optional[obj.RegionMemoryBank]:
    """region_mem's CLIP-text memory bank: the first loader's
    `object_params.region_memory_path` (.npy) that exists, else a seeded
    random bank (N(0, 0.02²), seed 0, as oatx makes it)."""
    if exp.arch.variant != "region_mem":
        return None
    for dl in exp.data_loaders:
        path = dl.object_params.get("region_memory_path")
        if path and os.path.exists(path):
            return obj.RegionMemoryBank.load(path)
    rng = np.random.default_rng(0)
    return obj.RegionMemoryBank(rng.standard_normal((1600, dim)).astype(np.float32) * 0.02)


def tag_token_lens_for(ds, tokenizer) -> np.ndarray:
    """Token length of each class's tag for the global_local collator
    (`Collator(tag_token_lens=...)`): the dataset's vocab without its
    background row, else the names `obj0` … `obj1599`."""
    names = ds.object_vocab[1:] if getattr(ds, "object_vocab", None) else [
        f"obj{i}" for i in range(1600)]
    return build_tag_token_lens(tokenizer, names)


def build_dataset(dl: DataLoaderCfg, variant: str = "baseline", split: Optional[str] = None,
                  region_bank: Optional[obj.RegionMemoryBank] = None,
                  sliding_window_stride: int = -1, seed: int = 0, device=None):
    """`device`: where H.264 clips' pictures turn RGB (None the card, "cpu"
    the plain version; video_reader.VideoHandle.decode)."""
    cls = DATASETS.get(dl.dataset_name)
    opts = object_options_for_variant(variant, dl, region_bank)
    return cls(dl, split=split, object_options=opts, object_vocab=load_object_vocab(dl),
               sliding_window_stride=sliding_window_stride, seed=seed, device=device)


def build_loaders(exp: ExperimentCfg, tokenizer: WordPieceTokenizer,
                  split: Optional[str] = None, shard_id: int = 0, num_shards: int = 1,
                  seed: int = 0, device=None) -> List[ShardedLoader]:
    """One loader per data_loader entry: shuffled, drop_last and echoed on
    the train split, in order otherwise. Each reads shard `shard_id` of
    `num_shards` of its dataset (every num_shards-th sample of the epoch's
    order; oatx feeds them from jax.process_index() / process_count(), the
    port's cli.train from the rank and world size). `batch_size` is per
    shard; `device` is build_dataset's."""
    region_bank = load_region_bank(exp)
    loaders = []
    tag_lens = None
    for dl in exp.data_loaders:
        ds = build_dataset(dl, exp.arch.variant, split, region_bank, seed=seed, device=device)
        if exp.arch.variant == "global_local" and tag_lens is None:
            tag_lens = tag_token_lens_for(ds, tokenizer)
        collate = Collator(tokenizer, tag_token_lens=tag_lens)
        train = (split or dl.split) == "train"
        loaders.append(ShardedLoader(
            ds, batch_size=dl.batch_size, collate=collate,
            shuffle=dl.shuffle if train else False, shard_id=shard_id, num_shards=num_shards,
            drop_last=train, num_workers=dl.num_workers, seed=seed,
            echo_factor=dl.echo_factor if train else 1))
    return loaders
