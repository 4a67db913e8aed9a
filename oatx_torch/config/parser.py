"""Experiment bootstrap for the serving path (port of oatx/config/parser.py).

`-c config.json`, or `-r checkpoint` (resume reads the `config.json` snapshot
next to the checkpoint, optionally updated by `-c`) — the reference
ConfigParser behaviour. Serving writes no experiment directories, so the
training overrides and directory layout wait for the training slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

from oatx_torch.config.schema import ExperimentCfg


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="oatx_torch")
    p.add_argument("-c", "--config", default=None, type=str, help="config JSON path")
    p.add_argument("-r", "--resume", default=None, type=str,
                   help="checkpoint (.pth) to load; its directory holds config.json")
    return p


@dataclasses.dataclass
class Experiment:
    cfg: ExperimentCfg
    resume: Optional[Path] = None
    args: Optional[argparse.Namespace] = None


def load_experiment(argv: Optional[Sequence[str]] = None) -> Experiment:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.resume is None:
        if args.config is None:
            parser.error("a config file is required: add '-c config.json'")
        with open(args.config) as f:
            raw = json.load(f)
        resume = None
    else:
        resume = Path(args.resume)
        with open(resume.parent / "config.json") as f:
            raw = json.load(f)
        if args.config is not None:
            with open(args.config) as f:
                raw.update(json.load(f))
    return Experiment(cfg=ExperimentCfg.from_dict(raw), resume=resume, args=args)
