"""Retrieval eval entry point (port of oatx/cli/test.py; the reference's
test.py).

    python -m oatx_torch.cli.test -c configs/ft/msrvtt/zsl/normal.json \
        [--sliding_window_stride 8] [--split test] [-r <checkpoint>] [--device cpu]

Weights from -r (a snapshot of this package's trainer) or
arch.load_checkpoint (a reference .pth or a snapshot); the eval split of the
first data_loader entry is embedded, sliding windows are ensembled when
asked, and the t2v / v2t metrics printed, with multiple-choice accuracy for
LSMDC_choice and the four streams of global_local. A stream-3 model also
reports the o2v / o2t streams (metrics `o2v_t2v_metrics`, ...), as oatx's
test.py does. Then the qualitative exports, as oatx's: region_mem's region
binary maps under <web_dir>/region_maps (eval/retrieval_eval.
export_region_maps), and with `visualizer.type` "RetrievalVis" the HTML
ranking gallery <web_dir>/index.html (utils/html_viz.py). Runs on CUDA
unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    import numpy as np
    import torch

    from oatx_torch import resolve_device
    from oatx_torch.cli.common import dataset_captions, resolve_tokenizer
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.data.factory import build_dataset, load_region_bank, tag_token_lens_for
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.eval import retrieval_eval as R
    from oatx_torch.models.towers import DualTower
    from oatx_torch.train import checkpoint as ckptlib
    from oatx_torch.train.trainer import verbose
    from oatx_torch.utils.html_viz import RetrievalVis
    from oatx_torch.utils.logging import setup_logging

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    our, rest = p.parse_known_args(argv)
    dev = resolve_device(our.device)

    exp = load_experiment(rest, test=True)
    logger = setup_logging(None, "oatx_torch.test", exp.cfg.trainer.verbosity)
    split = exp.args.split or "test"
    stride = exp.args.sliding_window_stride

    tower_cfg = build_tower_config(exp.cfg.arch,
                                   compute_dtype=precision_dtype(exp.cfg.trainer.precision))
    model = DualTower(tower_cfg, dev, torch.Generator(dev).manual_seed(0))
    ckpt = str(exp.resume) if exp.resume else exp.cfg.arch.load_checkpoint
    if ckpt:
        use_ema = bool(getattr(exp.args, "ema", False))
        logger.info("loading %sweights from %s", "EMA " if use_ema else "", ckpt)
        ckptlib.import_initial_weights(ckpt, model, prefer_ema=use_ema)
    else:
        logger.warning("no checkpoint given — evaluating RANDOM weights")
    model.eval()

    search = [pathlib.Path(ckpt).parent] if ckpt else []
    tokenizer = resolve_tokenizer(exp.cfg, corpus=lambda: dataset_captions(exp.cfg, split),
                                  search_dirs=search)
    dl = exp.cfg.data_loaders[0]
    ds = build_dataset(dl, exp.cfg.arch.variant, split, load_region_bank(exp.cfg),
                       seed=exp.cfg.trainer.seed, device=dev)
    if stride != -1:
        logger.info("sliding-window ensembling, stride %d", stride)
        ds.expand_sliding_windows(stride)
    if getattr(exp.args, "all_captions", False):
        qpv = ds.expand_eval_captions()
        logger.info("full-cut protocol: %d caption slots per video", qpv)
    tag_lens = tag_token_lens_for(ds, tokenizer) if exp.cfg.arch.variant == "global_local" \
        else None
    loader = ShardedLoader(ds, batch_size=dl.batch_size,
                           collate=Collator(tokenizer, tag_token_lens=tag_lens),
                           shuffle=False, drop_last=False, num_workers=dl.num_workers)

    result = R.evaluate(model, tower_cfg, loader, exp.cfg.metrics, device=dev)
    for name, m in result.metrics.items():
        short = {"t2v_metrics": "t2v", "v2t_metrics": "v2t"}.get(name, name)
        if "R1" in m:
            logger.info(verbose(0, m, ds.dataset_name, short))
        else:
            logger.info("[%s] %s: %s", short, ds.dataset_name,
                        {k: round(float(v), 3) for k, v in m.items()})
    for stream, ms in result.object_streams.items():  # stream 3: o2v / o2t
        for name, m in ms.items():
            logger.info(verbose(0, m, f"{ds.dataset_name}[{stream}]",
                                name.replace("_metrics", "")))
            result.metrics[f"{stream}_{name}"] = m

    if getattr(ds, "is_multiple_choice", False):
        mc = R.evaluate_multiple_choice(model, tower_cfg, loader, tokenizer, device=dev)
        logger.info("[mc] %s accuracy %.2f%% (n=%d)", ds.dataset_name, mc["accuracy"],
                    mc["n"])
        result.metrics["multiple_choice"] = mc

    if exp.cfg.arch.variant == "global_local":
        for stream, ms in R.evaluate_streams(model, tower_cfg, loader, exp.cfg.metrics,
                                             device=dev).items():
            for name, m in ms.items():
                logger.info(verbose(0, m, f"{ds.dataset_name}[{stream}]",
                                    name.replace("_metrics", "")))

    # qualitative exports: region_mem's binary maps, the HTML ranking gallery
    if exp.cfg.arch.variant == "region_mem":
        maps_dir = exp.web_dir / "region_maps"
        paths = R.export_region_maps(model, tower_cfg, loader, str(maps_dir), device=dev)
        logger.info("wrote %d region binary maps → %s", len(paths), maps_dir)
    if exp.cfg.visualizer.get("type") == "RetrievalVis":
        vis = RetrievalVis(str(exp.web_dir), title=exp.cfg.name)
        caps = [m_.get("raw_captions", "") for m_ in result.meta]
        vids = [m_.get("paths", "") for m_ in result.meta]
        if caps and vids and result.sims.shape[0] == len(caps):
            vis.from_sims(result.sims, caps, vids)
            logger.info("wrote retrieval gallery → %s", vis.write())

    if getattr(exp.args, "sims_out", None):
        np.save(exp.args.sims_out, result.sims)
        logger.info("saved sims %s → %s", result.sims.shape, exp.args.sims_out)

    print(json.dumps({n: {k: round(float(v), 3) for k, v in m.items()}
                      for n, m in result.metrics.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
