"""Training entry point (port of oatx/cli/train.py; the reference's train.py
family unified: the model variant comes from the config's arch.variant).

    python -m oatx_torch.cli.train -c configs/pt/cc3m_webvid/norm.json [--lr ... --bs ...]
    python -m oatx_torch.cli.train -r exps/.../checkpoint-epoch5        # resume
    python -m oatx_torch.cli.train -c <config> --device cpu             # the plain versions

config → tokenizer (a vocab.txt beside the resumed checkpoint, the config's
vocab, or one built from the datasets' captions; written to the run's
directory) → one loader per data_loader entry (build_loaders) → Trainer,
on CUDA unless --device names another.

Data parallelism across processes, one per device (oatx :28-76): with
OATX_MULTIHOST=1 each process joins a torch.distributed group before
anything else. Its address, size and rank come from oatx's variables,
OATX_COORDINATOR (host:port, or a torch init URL such as tcp://host:port or
file:///shared/path), OATX_NUM_PROCESSES and OATX_PROCESS_ID, or without
them from torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK: init_method env://):

    OATX_MULTIHOST=1 OATX_COORDINATOR=node0:29500 OATX_NUM_PROCESSES=8 \\
        OATX_PROCESS_ID=$i python -m oatx_torch.cli.train -c <config>
    OATX_MULTIHOST=1 torchrun --nproc-per-node 8 -m oatx_torch.cli.train -c <config>

The backend is NCCL on CUDA and gloo with --device cpu. Process i uses
cuda:LOCAL_RANK, or cuda:(i mod the visible cards). Every rank loads the
shard of each loader of its data position (batch_size is per process;
with `trainer.model_parallel` mp the mp ranks of a position read the same
rows, parallel/mesh.py, so the global batch is batch_size × world / mp,
whether the model axis splits the weights or, under `trainer.pipeline`,
holds pipeline stages)
and runs the same run directory (rank 0's timestamp); rank 0 alone writes
the vocab and the config and keeps the tracker. The group is torn down at
exit. The pod recipes (configs/pt/cc3m_webvid/*_pod.json, model_parallel
4) run as shipped at a world of 4 × the data positions:

    OATX_MULTIHOST=1 torchrun --nproc-per-node 4 -m oatx_torch.cli.train \
        -c configs/pt/cc3m_webvid/vit_huge_pod.json
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _init_method() -> tuple:
    """(init_method, world size, rank) from oatx's variables or torchrun's."""
    coord = os.environ.get("OATX_COORDINATOR")
    if coord:
        url = coord if "://" in coord else f"tcp://{coord}"
        return url, int(os.environ["OATX_NUM_PROCESSES"]), int(os.environ["OATX_PROCESS_ID"])
    return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])


def init_process_group(device: Optional[str]) -> torch.device:
    """Join the group OATX_MULTIHOST names (module docstring) → this
    process's device."""
    url, world, rank = _init_method()
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("OATX_MULTIHOST=1 on CUDA needs a card; pass --device cpu "
                               "to train the plain versions over gloo")
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else rank % torch.cuda.device_count()
        dev, backend = torch.device("cuda", index), "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=30))
    return dev


def main(argv: Optional[Sequence[str]] = None) -> int:
    if os.environ.get("OATX_MULTIHOST") == "1":
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("--device", default=None)
        dev = init_process_group(p.parse_known_args(argv)[0].device)
        try:
            return _main(argv, str(dev))
        finally:
            dist.destroy_process_group()
    return _main(argv)


def _main(argv: Optional[Sequence[str]], device: Optional[str] = None) -> int:
    from oatx_torch import resolve_device
    from oatx_torch.cli.common import dataset_captions, resolve_tokenizer
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.data.factory import build_loaders
    from oatx_torch.parallel.mesh import check_layout, current_layout
    from oatx_torch.train.trainer import Trainer
    from oatx_torch.utils.logging import setup_logging
    from oatx_torch.utils.tracking import ExperimentTracker

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    our, rest = p.parse_known_args(argv)
    dev = resolve_device(device or our.device)
    layout = current_layout()
    lead = layout.rank == 0

    stamp = [datetime.datetime.now().strftime(r"%m%d_%H%M%S")]
    if layout.spans_processes:  # one run directory: rank 0's
        dist.broadcast_object_list(stamp, src=0)
    exp = load_experiment(rest, timestamp=stamp[0], write_config=lead)
    logger = setup_logging(exp.log_dir, "oatx_torch", exp.cfg.trainer.verbosity, layout.rank)
    logger.info("experiment %s → %s", exp.cfg.name, exp.save_dir)
    logger.info("device: %s, rank %d of %d", dev, layout.rank, layout.world)

    search = [exp.resume.parent] if exp.resume else []
    tokenizer = resolve_tokenizer(exp.cfg, corpus=lambda: dataset_captions(exp.cfg),
                                  search_dirs=search)
    if lead:
        # the exact vocab goes with the checkpoints: eval and finetune runs
        # must tokenize identically
        tokenizer.save_vocab(str(exp.save_dir / "vocab.txt"))
    t = exp.cfg.trainer
    check_layout(t)
    layout = current_layout(t.dcn_slices, t.model_parallel)
    # the ranks of one model group read the same rows: shard by data position
    shards = dict(shard_id=layout.position, num_shards=layout.batch_shards, seed=t.seed)
    train_loaders = build_loaders(exp.cfg, tokenizer, split="train", **shards)
    try:
        valid_loaders = build_loaders(exp.cfg, tokenizer, split="val", **shards)
    except Exception as e:  # no validation split available
        logger.info("no validation loaders (%s)", e)
        valid_loaders = []

    track = bool(getattr(exp.args, "observe", False)) or \
        bool(exp.cfg.raw.get("trainer", {}).get("neptune", False))
    with ExperimentTracker(exp.log_dir, exp.cfg.name, config=exp.cfg.raw,
                           enabled=track and lead) as tracker:
        trainer = Trainer(exp.cfg, train_loaders, valid_loaders, save_dir=exp.save_dir,
                          log_dir=exp.log_dir,
                          linear_eval=bool(getattr(exp.args, "linear_eval", False)),
                          resume=str(exp.resume) if exp.resume else None,
                          tracker=tracker, device=dev)
        trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
