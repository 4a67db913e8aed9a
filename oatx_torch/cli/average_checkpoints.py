"""Average the weights of N snapshots into one, model-soup style (port of
oatx's tools/average_checkpoints.py).

    python -m oatx_torch.cli.average_checkpoints --out <dir> <ckpt1> <ckpt2> ... \
        [--ema] [--device cpu]

Each argument is a snapshot directory of this package's trainer
(train/checkpoint.py: `state.pt`). The snapshots are read one at a time and
their model tensors accumulated in float64 on the device (CUDA unless
--device names another), each with weight 1/N; the mean is cast back to
each tensor's dtype. --ema averages each snapshot's EMA parameters (over
its raw ones where the EMA keeps none, as `import_initial_weights
(prefer_ema=True)` reads a snapshot) and exits with 1 where a snapshot kept
no EMA. The output is a snapshot directory holding only the model weights,
which `import_initial_weights` (`-r` / `arch.load_checkpoint` of cli.test,
cli.serve, cli.visualize, ...) reads. The last line printed is oatx's JSON
summary. oatx's Orbax snapshots do not restore here.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    import torch

    from oatx_torch import resolve_device
    from oatx_torch.train import checkpoint as ckptlib

    p = argparse.ArgumentParser()
    p.add_argument("checkpoints", nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--ema", action="store_true",
                   help="average each snapshot's EMA params instead of raw")
    p.add_argument("--device", default=None,
                   help="torch device of the sum (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    acc, dtypes = None, None
    scale = 1.0 / len(args.checkpoints)
    for path in args.checkpoints:
        snap = torch.load(Path(path) / ckptlib.STATE_FILE, map_location="cpu",
                          weights_only=True)
        sd = snap["model"]
        if args.ema:
            ema = snap["optimizer"].get("ema")
            if ema is None:
                print(f"error: {path} carries no EMA state", file=sys.stderr)
                return 1
            sd = {**sd, **ema}
        if acc is None:
            acc, dtypes = {k: 0.0 for k in sd}, {k: v.dtype for k, v in sd.items()}
        acc = {k: acc[k] + sd[k].to(dev, torch.float64) * scale for k in acc}
        del snap, sd

    avg = {k: v.to(dtypes[k]).cpu() for k, v in acc.items()}
    out = Path(args.out).resolve()
    ckptlib._write(out, {"model": avg, "optimizer": {}, "step": 0})
    print(json.dumps({"out": str(out), "averaged": len(args.checkpoints),
                      "param_tensors": len(avg), "source": "ema" if args.ema else "params"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
