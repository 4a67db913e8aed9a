"""Cross-modality visualization entry point (port of oatx/cli/visualize.py;
the reference Visualization sidecar's main_img / main_video drivers).

    python -m oatx_torch.cli.visualize -c <config.json> [-r <ckpt>] \
        --video clip.avi --caption "a dog runs" --out out_prefix [--device cpu]
    python -m oatx_torch.cli.visualize --backbone clip --clip-ckpt clip.pt \
        --bpe-vocab bpe.txt.gz --video clip.avi --caption "a dog runs" --out out_prefix

Renders one PNG a noun of the caption (`{out}_token_{i}.png`): the
word→patch attention over one frame of the clip (the middle one unless
--frame-index), from the configured towers (`--backbone tower`) or a CLIP
ViT and text tower read from a CLIP state_dict (`--backbone clip`).

The tower path runs the video tower over one 224² frame, so on a card
kernels 1 and 2 launch once a block. The towers compute in
`trainer.precision` (bf16 runs the kernels, which take bf16 only), where
oatx's visualize builds its towers at the default dtype; the patches are
projected in f32 either way. The CLIP path is f32 and plain PyTorch
(models/clip_vision.py). The display frame and CLIP's input are resized as
`jax.image.resize(..., "bilinear")` resizes them: bilinear, antialiased
when it shrinks. Runs on CUDA unless --device names another; without a
card and without --device cpu it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

# CLIP input normalization (the reference clip.py _transform; OpenAI's constants)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bilinear(img, size: int):
    """(H, W, C) float tensor → (size, size, C) f32: jax.image.resize's
    "bilinear", antialiased when it shrinks."""
    import torch.nn.functional as F

    x = img.float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=size < min(img.shape[0], img.shape[1]))
    return x[0].permute(1, 2, 0)


def display_frame(frame_u8: np.ndarray) -> np.ndarray:
    """The 224² frame drawn beside the heatmap, cast to uint8 by truncation
    (oatx's np.asarray(..., np.uint8))."""
    import torch

    return resize_bilinear(torch.from_numpy(frame_u8), 224).numpy().astype(np.uint8)


def read_frame(video: str, frame_index: Optional[int]) -> np.ndarray:
    """The clip's frame `frame_index` (default: the middle one), short side
    256, centre-cropped → (1, 256, 256, 3) uint8."""
    from oatx_torch.data import video_reader as vr
    from oatx_torch.data.host_transforms import host_canonicalize

    vlen = vr.probe(video)[0]
    idx = frame_index if frame_index is not None else vlen // 2
    return host_canonicalize(vr.decode_indices(video, [idx], short_side=256), 256)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--video")
    p.add_argument("--caption")
    p.add_argument("--out", default="heatmap")
    p.add_argument("--frame-index", type=int, default=None,
                   help="absolute frame to visualize (default: middle)")
    p.add_argument("--backbone", choices=["tower", "clip"], default="tower")
    p.add_argument("--clip-ckpt",
                   help="CLIP state_dict .pt/.pth (required for --backbone clip)")
    p.add_argument("--bpe-vocab",
                   help="CLIP BPE vocab file (bpe_simple_vocab_16e6.txt.gz)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    our, rest = p.parse_known_args(argv)
    want_help = "-h" in (rest or []) or "--help" in (rest or [])
    if not want_help:
        if not our.video or not our.caption:
            p.error("--video and --caption are required")
        if our.backbone == "clip" and not our.clip_ckpt:
            p.error("--backbone clip requires --clip-ckpt")
        if our.backbone == "clip":
            return _main_clip(our)
    elif our.backbone == "clip":  # the clip path has no config parser to print help
        p.print_help()
        return 0

    import torch

    from oatx_torch import resolve_device
    from oatx_torch.cli.common import dataset_captions, resolve_tokenizer
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.models.towers import DualTower
    from oatx_torch.train import checkpoint as ckptlib
    from oatx_torch.train.step import make_augmenter
    from oatx_torch.utils.logging import setup_logging
    from oatx_torch.visualization.heatmap import render_caption_heatmaps

    dev = resolve_device(our.device)
    exp = load_experiment(rest, test=True)
    logger = setup_logging(None, "oatx_torch.visualize")
    tower_cfg = build_tower_config(exp.cfg.arch,
                                   compute_dtype=precision_dtype(exp.cfg.trainer.precision))
    model = DualTower(tower_cfg, dev, torch.Generator(dev).manual_seed(0))
    ckpt = str(exp.resume) if exp.resume else exp.cfg.arch.load_checkpoint
    if ckpt:
        ckptlib.import_initial_weights(ckpt, model)
    else:
        logger.warning("no checkpoint — visualizing RANDOM weights")
    model.eval()
    tokenizer = resolve_tokenizer(
        exp.cfg, corpus=lambda: (dataset_captions(exp.cfg) or [our.caption]) + [our.caption])

    frame_u8 = read_frame(our.video, our.frame_index)
    with torch.no_grad():
        # patch embeddings of the frame (a 1-frame tower pass), projected in f32
        aug = make_augmenter(train=False, tower_cfg=tower_cfg)
        video = aug(None, {"video": torch.from_numpy(frame_u8)[None].to(dev)})["video"]
        patches = model.compute_video(video)["patches"][0].float()
        patch_proj = model.vid_proj(patches).cpu().numpy()
        # one text-tower query a word (the reference's visualize.py:150-152)
        word_embeds = []
        for w in our.caption.split(" "):
            tok = tokenizer([w], max_length=8)
            emb = model.compute_text(torch.from_numpy(np.asarray(tok["input_ids"])).to(dev),
                                     torch.from_numpy(np.asarray(tok["attention_mask"])).to(dev))
            word_embeds.append(emb[0].float().cpu().numpy())

    paths = render_caption_heatmaps(our.caption, word_embeds, patch_proj,
                                    display_frame(frame_u8[0]), our.out)
    for path in paths:
        logger.info("wrote %s", path)
    print("\n".join(paths))
    return 0


def _main_clip(our) -> int:
    """--backbone clip: per-noun heatmaps from the CLIP towers (the
    reference's model_se='clip' mode, main_img.py:17-33: per-patch image
    embeddings from the vendored visual forward, one clip.tokenize +
    encode_text query a word), in f32."""
    import torch

    from oatx_torch import resolve_device
    from oatx_torch.data.clip_tokenizer import ClipTokenizer
    from oatx_torch.models import convert
    from oatx_torch.utils.logging import setup_logging
    from oatx_torch.visualization.heatmap import render_caption_heatmaps

    dev = resolve_device(our.device)
    logger = setup_logging(None, "oatx_torch.visualize")
    sd = convert.load_torch_state(our.clip_ckpt)
    vmodel, vcfg = convert.clip_vision_from_torch(sd, dev)
    tmodel, tcfg = convert.clip_text_from_torch(sd, dev)
    tokenizer = ClipTokenizer(our.bpe_vocab) if our.bpe_vocab else ClipTokenizer()

    frame_u8 = read_frame(our.video, our.frame_index)[0]
    with torch.no_grad():
        img = resize_bilinear(torch.from_numpy(frame_u8).to(dev).float() / 255.0,
                              vcfg.input_resolution)
        img = (img - torch.tensor(_CLIP_MEAN, device=dev)) / torch.tensor(_CLIP_STD, device=dev)
        patch_embeds = vmodel.encode_image_patches(img[None])[0].cpu().numpy()
        word_embeds = []
        for w in our.caption.split(" "):
            ids = tokenizer.tokenize([w], context_length=tcfg.context_length)
            word_embeds.append(tmodel.encode_text(torch.from_numpy(ids).to(dev))[0].cpu().numpy())

    paths = render_caption_heatmaps(our.caption, word_embeds, patch_embeds,
                                    display_frame(frame_u8), our.out)
    for path in paths:
        logger.info("wrote %s", path)
    print("\n".join(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
