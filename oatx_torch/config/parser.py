"""Experiment bootstrap: config file + CLI overrides + experiment directories
(port of oatx/config/parser.py, the reference ConfigParser behaviour,
parse_config_dist_multi.py:13-71):

  * `-c config.json`, or `-r checkpoint` (resume reads the `config.json`
    snapshot next to the checkpoint, optionally updated by `-c`);
  * CLI overrides declared as (flags, type, key path) tuples, e.g.
    ('--lr', float, ('optimizer', 'args', 'lr'));
  * timestamped experiment directories save_dir/{models,log,web}/<name>/<MMDD_HHMMSS>,
    and the config snapshot written to the models directory.

`test=True` (serving, evaluation) creates no directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from datetime import datetime
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

from oatx_torch.config.schema import ExperimentCfg

CustomArg = Tuple[Sequence[str], type, Sequence[str]]  # (flags, type, key path)


def _schedule_arg(s: str):
    """--schedule takes decay milestones '60,80' (→ optimizer.args.milestones)
    or a schedule kind 'cosine' (→ optimizer.args.schedule)."""
    body = s.replace("[", "").replace("]", "")
    try:
        return [int(x) for x in body.split(",") if x]
    except ValueError:
        return s


DEFAULT_CUSTOM_ARGS: List[CustomArg] = [
    (("--lr", "--learning_rate"), float, ("optimizer", "args", "lr")),
    (("--bs", "--batch_size"), int, ("data_loader", "args", "batch_size")),
    (("--epochs",), int, ("trainer", "epochs")),
    (("--schedule",), _schedule_arg, ("optimizer", "args", "milestones")),
]


def _set_by_path(tree: Any, keys: Sequence[str], value: Any) -> None:
    """tree[k0][k1]... = value; a list node fans the write out to every
    element (batch_size onto every loader of a multi-loader config)."""
    if isinstance(tree, list):
        for item in tree:
            _set_by_path(item, keys, value)
        return
    if len(keys) == 1:
        tree[keys[0]] = value
        return
    _set_by_path(tree.setdefault(keys[0], {}), keys[1:], value)


def build_argparser(custom_args: Sequence[CustomArg] = ()) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="oatx_torch")
    p.add_argument("-c", "--config", default=None, type=str, help="config JSON path")
    p.add_argument("-r", "--resume", default=None, type=str,
                   help="checkpoint to resume; its directory holds config.json")
    p.add_argument("-o", "--observe", action="store_true", help="enable experiment tracking")
    p.add_argument("--linear_eval", action="store_true", help="freeze all but projections")
    p.add_argument("--no_timestamp", action="store_true")
    p.add_argument("--save_dir", default=None, type=str, help="override trainer.save_dir")
    p.add_argument("--sliding_window_stride", default=-1, type=int)
    p.add_argument("--all_captions", action="store_true",
                   help="full-cut eval: every caption as a query")
    p.add_argument("--split", default=None, type=str)
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA parameters of a snapshot")
    p.add_argument("--sims_out", default=None, type=str,
                   help="eval: save the raw similarity matrix to this .npy path")
    for flags, typ, _ in list(custom_args) + DEFAULT_CUSTOM_ARGS:
        p.add_argument(*flags, default=None, type=typ)
    return p


@dataclasses.dataclass
class Experiment:
    cfg: ExperimentCfg
    save_dir: Path
    log_dir: Path
    web_dir: Path
    resume: Optional[Path] = None
    args: Optional[argparse.Namespace] = None


def load_experiment(argv: Optional[Sequence[str]] = None,
                    custom_args: Sequence[CustomArg] = (), test: bool = False,
                    timestamp: bool = True) -> Experiment:
    parser = build_argparser(custom_args)
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

    for flags, _, keypath in list(custom_args) + DEFAULT_CUSTOM_ARGS:
        name = next(f for f in flags if f.startswith("--")).lstrip("-").replace("-", "_")
        value = getattr(args, name, None)
        if value is not None:
            if name == "schedule" and isinstance(value, str):
                keypath = ("optimizer", "args", "schedule")  # a kind, not milestones
            _set_by_path(raw, list(keypath), value)
    if args.save_dir is not None:
        raw.setdefault("trainer", {})["save_dir"] = args.save_dir

    cfg = ExperimentCfg.from_dict(raw)
    ts = (datetime.now().strftime(r"%m%d_%H%M%S")
          if timestamp and not args.no_timestamp else "")
    base = Path(cfg.trainer.save_dir)
    save_dir = base / "models" / cfg.name / ts
    log_dir = base / "log" / cfg.name / ts
    web_dir = base / "web" / cfg.name / ts
    if not test:
        save_dir.mkdir(parents=True, exist_ok=True)
        log_dir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / "config.json", "w") as f:
            json.dump(raw, f, indent=4, sort_keys=False)
    return Experiment(cfg=cfg, save_dir=save_dir, log_dir=log_dir, web_dir=web_dir,
                      resume=resume, args=args)
