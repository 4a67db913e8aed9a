"""Training entry point (port of oatx/cli/train.py; the reference's train.py
family unified: the model variant comes from the config's arch.variant).

    python -m oatx_torch.cli.train -c configs/pt/cc3m_webvid/norm.json [--lr ... --bs ...]
    python -m oatx_torch.cli.train -r exps/.../checkpoint-epoch5        # resume
    python -m oatx_torch.cli.train -c <config> --device cpu             # the plain versions

config → tokenizer (a vocab.txt beside the resumed checkpoint, the config's
vocab, or one built from the datasets' captions; written to the run's
directory) → one loader per data_loader entry (build_loaders) → Trainer on
one device, CUDA unless --device names another. Multi-host / multi-GPU
launch (OATX_MULTIHOST=1) is not ported (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from oatx_torch import resolve_device
    from oatx_torch.cli.common import dataset_captions, resolve_tokenizer
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.data.factory import build_loaders
    from oatx_torch.train.trainer import Trainer
    from oatx_torch.utils.logging import setup_logging
    from oatx_torch.utils.tracking import ExperimentTracker

    if os.environ.get("OATX_MULTIHOST") == "1":
        raise NotImplementedError("multi-host / multi-GPU training is not ported yet "
                                  "(ROADMAP A8): the port trains on one device")
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    our, rest = p.parse_known_args(argv)
    dev = resolve_device(our.device)

    exp = load_experiment(rest)
    logger = setup_logging(exp.log_dir, "oatx_torch", exp.cfg.trainer.verbosity)
    logger.info("experiment %s → %s", exp.cfg.name, exp.save_dir)
    logger.info("device: %s", dev)

    search = [exp.resume.parent] if exp.resume else []
    tokenizer = resolve_tokenizer(exp.cfg, corpus=lambda: dataset_captions(exp.cfg),
                                  search_dirs=search)
    # the exact vocab goes with the checkpoints: eval and finetune runs must
    # tokenize identically
    tokenizer.save_vocab(str(exp.save_dir / "vocab.txt"))
    seed = exp.cfg.trainer.seed
    train_loaders = build_loaders(exp.cfg, tokenizer, split="train", seed=seed)
    try:
        valid_loaders = build_loaders(exp.cfg, tokenizer, split="val", seed=seed)
    except Exception as e:  # no validation split available
        logger.info("no validation loaders (%s)", e)
        valid_loaders = []

    track = bool(getattr(exp.args, "observe", False)) or \
        bool(exp.cfg.raw.get("trainer", {}).get("neptune", False))
    with ExperimentTracker(exp.log_dir, exp.cfg.name, config=exp.cfg.raw,
                           enabled=track) as tracker:
        trainer = Trainer(exp.cfg, train_loaders, valid_loaders, save_dir=exp.save_dir,
                          log_dir=exp.log_dir,
                          linear_eval=bool(getattr(exp.args, "linear_eval", False)),
                          resume=str(exp.resume) if exp.resume else None,
                          tracker=tracker, device=dev)
        trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
