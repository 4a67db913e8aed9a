"""Build a serving retrieval index from a config's eval split (port of
tools/build_index.py).

    python -m oatx_torch.cli.build_index -c <config.json> [-r <ckpt>] \
        [--split test] [--sliding_window_stride 8] --index-out corpus.npz [--device cpu]

Embeds the split's videos through the eval pipeline that produces the
reported retrieval metrics (eval.retrieval_eval.evaluate: the chunked eval
step, sliding-window ensembling when asked), then saves one L2-normalized
embedding per video keyed by its clip path (serve/retrieval_index.py
`ids_for_result`) as a RetrievalIndex. Runs on CUDA unless --device names
another. Serve it with:

    python -m oatx_torch.cli.serve -c <config.json> [-r <ckpt>] --index corpus.npz
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--index-out", required=True)
    pre.add_argument("--device", default=None,
                     help="torch device (default: the current CUDA device)")
    our, rest = pre.parse_known_args(argv)

    import torch

    from oatx_torch import resolve_device
    from oatx_torch.cli.common import dataset_captions, resolve_tokenizer
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.data.factory import build_dataset, load_region_bank
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.eval.retrieval_eval import evaluate
    from oatx_torch.models.towers import DualTower
    from oatx_torch.serve.retrieval_index import RetrievalIndex, ids_for_result
    from oatx_torch.train import checkpoint as ckptlib
    from oatx_torch.utils.logging import setup_logging

    dev = resolve_device(our.device)
    exp = load_experiment(rest, test=True)
    logger = setup_logging(None, "oatx_torch.build_index", exp.cfg.trainer.verbosity)
    split = exp.args.split or "test"
    tower_cfg = build_tower_config(exp.cfg.arch,
                                   compute_dtype=precision_dtype(exp.cfg.trainer.precision))
    model = DualTower(tower_cfg, dev, torch.Generator(dev).manual_seed(0))
    ckpt = str(exp.resume) if exp.resume else exp.cfg.arch.load_checkpoint
    if ckpt:
        logger.info("loading weights from %s", ckpt)
        ckptlib.import_initial_weights(ckpt, model)
    else:
        logger.warning("no checkpoint given — indexing RANDOM weights")
    model.eval()

    search = [pathlib.Path(ckpt).parent] if ckpt else []
    tokenizer = resolve_tokenizer(
        exp.cfg, corpus=lambda: dataset_captions(exp.cfg, split) or ["a video"],
        search_dirs=search)
    dl = exp.cfg.data_loaders[0]
    ds = build_dataset(dl, exp.cfg.arch.variant, split, load_region_bank(exp.cfg),
                       seed=exp.cfg.trainer.seed)
    stride = exp.args.sliding_window_stride
    if stride != -1:
        logger.info("sliding-window ensembling, stride %d", stride)
        ds.expand_sliding_windows(stride)
    loader = ShardedLoader(ds, batch_size=dl.batch_size, collate=Collator(tokenizer),
                           shuffle=False, drop_last=False, num_workers=dl.num_workers)

    t0 = time.perf_counter()
    result = evaluate(model, tower_cfg, loader, metric_names=(), device=dev)
    index = RetrievalIndex(result.video_embeds, ids_for_result(result), device=dev)
    index.save(our.index_out)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "index": our.index_out, "videos": len(index), "dim": index.dim,
        "dataset": ds.dataset_name, "split": split,
        "clips_per_sec": round(len(index) / dt, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
