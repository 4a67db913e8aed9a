"""Offline object-extraction entry point (port of oatx/cli/extract.py).

    python -m oatx_torch.cli.extract --list items.tsv --out objects/ [--workers 8]
    python -m oatx_torch.cli.extract --list items.tsv --out objects/ --missing-only
    python -m oatx_torch.cli.extract --list items.tsv --out objects/ \\
        --detector torch --detector-weights butd.torchscript [--device cpu]
    python -m oatx_torch.cli.extract --list items.tsv --out objects/ \\
        --detector roi_backbone --detector-config cfg.json [--detector-ckpt ckpt] [--device cpu]

items.tsv: one `video_id<TAB>video_path` per line. Each clip's uniform grid of
--frames slots becomes out/<video_id>/<slot>.npz with `x` (regions, 2048)
float32, `bbox` (regions, 4) xyxy pixels and `info` {objects_id,
objects_conf, image_w, image_h}; existing files are skipped unless
--overwrite. Detectors (oatx_torch.data.extraction):
  stub          deterministic synthetic regions (default; numpy on the host)
  torch         a TorchScript detector artifact (--detector-weights)
  roi_backbone  proposer boxes pooled by ROI-align from the port's own video
                tower's patch grid; --detector-config is an experiment JSON
                for the tower (compute dtype from trainer.precision),
                --detector-ckpt trained weights (a .pth or a port snapshot;
                otherwise the config's arch.load_checkpoint, otherwise
                random weights from seed 0)
`torch` and `roi_backbone` run on CUDA unless --device names another; without
a card and without --device cpu they raise. Stdout's last line is the JSON
stats: processed, skipped, failed, frames, seconds, frames_per_sec.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from oatx_torch import resolve_device
from oatx_torch.data import extraction as ex


def _build_roi_backbone(config_path, ckpt, frames_regions, device):
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.models.towers import DualTower
    from oatx_torch.train import checkpoint as ckptlib

    exp = load_experiment(["-c", str(config_path)], test=True)
    tower_cfg = build_tower_config(exp.cfg.arch,
                                   compute_dtype=precision_dtype(exp.cfg.trainer.precision))
    model = DualTower(tower_cfg, device, torch.Generator(device).manual_seed(0))
    load = ckpt or exp.cfg.arch.load_checkpoint
    if load:
        ckptlib.import_initial_weights(load, model)
    model.eval()
    return ex.RoiBackboneExtractor(model, tower_cfg, num_regions=frames_regions, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--list", required=True, help="TSV of video_id\\tvideo_path")
    p.add_argument("--out", required=True)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--regions", type=int, default=10)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--missing-only", action="store_true",
                   help="print the loss list (items with missing npz) and exit")
    p.add_argument("--processes", action="store_true",
                   help="process pool instead of threads")
    p.add_argument("--detector", default="stub",
                   choices=["stub", "torch", "roi_backbone"])
    p.add_argument("--detector-weights", default=None,
                   help="TorchScript artifact for --detector torch")
    p.add_argument("--detector-config", default=None,
                   help="experiment JSON for --detector roi_backbone")
    p.add_argument("--detector-ckpt", default=None,
                   help="checkpoint for --detector roi_backbone")
    p.add_argument("--device", default=None,
                   help="torch device of the torch and roi_backbone detectors "
                        "(default: the current CUDA device)")
    args = p.parse_args(argv)

    items = []
    with open(args.list) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) != 2:
                p.error(f"{args.list}:{ln}: expected 'video_id<TAB>video_path', got {line!r}")
            items.append((parts[0], parts[1]))

    if args.missing_only:
        missing = ex.missing_items(items, args.out, args.frames)
        for vid, path in missing:
            print(f"{vid}\t{path}")
        print(f"# {len(missing)}/{len(items)} missing", file=sys.stderr)
        return 0

    if args.detector == "torch":
        if not args.detector_weights:
            p.error("--detector torch requires --detector-weights")
        detector = ex.load_torch_detector(args.detector_weights, resolve_device(args.device))
    elif args.detector == "roi_backbone":
        if not args.detector_config:
            p.error("--detector roi_backbone requires --detector-config")
        if args.processes:
            p.error("--detector roi_backbone runs its tower on one device in this "
                    "process; use the (default) thread pool")
        detector = _build_roi_backbone(args.detector_config, args.detector_ckpt,
                                       args.regions, resolve_device(args.device))
    else:
        detector = ex.StubDetector(num_regions=args.regions)
    stats = ex.extract_dataset(
        items, args.out, detector, num_workers=args.workers,
        num_extraction_frames=args.frames, overwrite=args.overwrite,
        use_processes=args.processes)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
