"""Export a serving artifact through torch.export (port of
tools/export_serving.py).

    python -m oatx_torch.cli.export_serving -c <config.json> [-r <ckpt>] \
        --out <dir> [--canon 256] [--seq-len 30] [--quantize int8] [--device cpu]

Packages the dual-tower embedding functions and their weights into a
directory (serve/export.py) that a server runs without the model code, with
the batch dimension symbolic. The programs run on the device type they were
exported on: the current card unless `--device` names another (oatx's
`--platforms`). Serve it with:

    python -m oatx_torch.cli.serve -c <config.json> --artifact <dir>

(the config is still read for the tokenizer; the model and checkpoint are
not). Prints one JSON line: the artifact, its platforms, its int8 report
and its bytes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--out", required=True)
    pre.add_argument("--canon", type=int, default=256,
                     help="canonical uint8 frame side the loader ships")
    pre.add_argument("--seq-len", type=int, default=30)
    pre.add_argument("--device", default=None,
                     help="torch device to export on (default: the current CUDA device)")
    pre.add_argument("--quantize", default=None, choices=["int8"],
                     help="weight-only per-channel int8 kernels, the dequantize in the "
                          "programs (oatx_torch.serve.quant)")
    our, rest = pre.parse_known_args(argv)

    import torch

    from oatx_torch import resolve_device
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.models.towers import DualTower
    from oatx_torch.serve.export import save_artifact
    from oatx_torch.train import checkpoint as ckptlib
    from oatx_torch.utils.logging import setup_logging

    dev = resolve_device(our.device)
    exp = load_experiment(rest, test=True)
    logger = setup_logging(None, "oatx_torch.export", exp.cfg.trainer.verbosity)
    tower_cfg = build_tower_config(exp.cfg.arch,
                                   compute_dtype=precision_dtype(exp.cfg.trainer.precision))
    model = DualTower(tower_cfg, dev, torch.Generator(dev).manual_seed(0))
    ckpt = str(exp.resume) if exp.resume else exp.cfg.arch.load_checkpoint
    if ckpt:
        logger.info("importing weights from %s", ckpt)
        ckptlib.import_initial_weights(ckpt, model)
    out = save_artifact(our.out, model, tower_cfg,
                        frames=exp.cfg.arch.video_params.num_frames, canon=our.canon,
                        seq_len=our.seq_len, quantize=our.quantize)
    meta = json.loads((out / "meta.json").read_text())
    sizes = {p.name: p.stat().st_size for p in sorted(out.iterdir())}
    logger.info("artifact at %s platforms=%s quantize=%s files=%s",
                out, meta["platforms"], meta.get("quantize"), sizes)
    print(json.dumps({"artifact": str(out), "platforms": meta["platforms"],
                      "quantize": meta.get("quantize"), "bytes": sum(sizes.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
