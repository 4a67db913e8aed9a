"""Build region_mem's region memory bank (port of tools/build_region_memory.py:35-142;
the reference's `clip_objects_tensor.pt`, 512-d CLIP text embeddings of the
1600 BUTD classes, read at base_dataset_region_mem.py:297-305).

    python -m oatx_torch.cli.build_region_memory --vocab objects_vocab.txt \\
        --out region_memory.npy [--backend clip] [--clip-ckpt clip.pth] [--bpe merges.gz] \\
        [--dim 512] [--device cpu]

Each class name (the vocab without its `__background__` row) is encoded as
"a photo of a {name}" and the (classes, dim) float32 array written with
numpy; `object_params.region_memory_path` in region_mem.json reads it
(data/factory.load_region_bank).

Backends:
  clip        the port's CLIP text tower (models/clip_text.py), EOT-pooled @
              text_projection. Random init from seed 0 unless --clip-ckpt (an
              OpenAI / vendored-CLIP state_dict, geometry inferred); labelled
              "(random init!)" then. The BPE merges from --bpe /
              $OATX_CLIP_BPE; without them a synthetic table of 512 merges
              learned from the prompts (allowed with random weights only).
              Ids are clamped to vocab_size − 1.
  distilbert  the port's DistilBERT tower (optionally --ckpt, an HF
              DistilBERT state_dict) over a WordPiece vocab built from the
              names, CLS row.
  torch-clip  needs the external `clip` package and its weights, which the
              port does not use: it raises.
The embedding is cut or zero-padded to --dim. Runs on CUDA unless --device
names another.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

PROMPT = "a photo of a {}"
BATCH = 256


def encode_clip(names: List[str], dim: int, device, clip_ckpt: Optional[str] = None,
                bpe: Optional[str] = None) -> Tuple[np.ndarray, str]:
    from oatx_torch.data import clip_tokenizer as ctok
    from oatx_torch.models import clip_text as ct
    from oatx_torch.models import convert

    random_init = clip_ckpt is None
    if random_init:
        cfg = ct.ClipTextConfig(embed_dim=dim)
        model = ct.ClipText(cfg, device, torch.Generator(device).manual_seed(0))
    else:
        model, cfg = convert.clip_text_from_torch(convert.load_torch_state(clip_ckpt), device)
    bpe_path = bpe or ctok.default_bpe_path()
    if bpe_path:
        tok, tok_src = ctok.ClipTokenizer(bpe_path=bpe_path), "bpe"
    else:
        if not random_init:
            raise SystemExit("--clip-ckpt given but no BPE merges found: real CLIP weights "
                             "need the real tokenizer (pass --bpe or set $OATX_CLIP_BPE)")
        tok = ctok.ClipTokenizer.for_tests([PROMPT.format(n) for n in names],
                                           extra_merges=512)
        tok_src = "synthetic-bpe"
    out = []
    with torch.no_grad():
        for i in range(0, len(names), BATCH):
            ids = tok.tokenize([PROMPT.format(n) for n in names[i: i + BATCH]],
                               context_length=cfg.context_length, truncate=True)
            ids = torch.from_numpy(np.minimum(ids, cfg.vocab_size - 1)).to(device)
            out.append(model.encode_text(ids).float().cpu().numpy())
    src = f"oatx_torch-clip[{tok_src}]" + ("(random init!)" if random_init else "")
    return np.concatenate(out), src


def encode_distilbert(names: List[str], dim: int, device,
                      ckpt: Optional[str] = None) -> Tuple[np.ndarray, str]:
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.models import convert
    from oatx_torch.models import distilbert as dbert

    cfg = dbert.DistilBertConfig()
    if ckpt:
        model = convert.distilbert_from_torch(convert.load_torch_state(ckpt), cfg, device)
    else:
        model = dbert.DistilBert(cfg, device, torch.Generator(device).manual_seed(0))
    tok = WordPieceTokenizer.build_from_corpus(names, vocab_size=8192)
    out = []
    with torch.no_grad():
        for i in range(0, len(names), BATCH):
            t = tok(names[i: i + BATCH], max_length=8)
            h = model(torch.from_numpy(t["input_ids"]).to(device),
                      torch.from_numpy(t["attention_mask"]).to(device))
            out.append(h[:, 0].float().cpu().numpy())
    return np.concatenate(out), "oatx_torch-text-tower" + ("" if ckpt else "(random init!)")


def fit_dim(emb: np.ndarray, dim: int) -> np.ndarray:
    """Zero-pad or cut the rows to `dim` columns."""
    if emb.shape[1] < dim:
        emb = np.pad(emb, ((0, 0), (0, dim - emb.shape[1])))
    return np.ascontiguousarray(emb[:, :dim], dtype=np.float32)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from oatx_torch import resolve_device
    from oatx_torch.data.objects import load_object_vocab

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vocab", required=True, help="objects_vocab.txt path")
    p.add_argument("--out", required=True, help="output .npy")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--backend", default="clip", choices=["clip", "torch-clip", "distilbert"])
    p.add_argument("--clip-ckpt", default=None,
                   help="torch CLIP state_dict (.pth/.pt) for the clip backend")
    p.add_argument("--bpe", default=None, help="bpe_simple_vocab_16e6.txt.gz path")
    p.add_argument("--ckpt", default=None,
                   help="torch DistilBERT state_dict (distilbert backend)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    if args.backend == "torch-clip":
        raise NotImplementedError("--backend torch-clip needs the external `clip` package "
                                  "(OpenAI CLIP) and its weights; use --backend clip with "
                                  "--clip-ckpt and --bpe")
    dev = resolve_device(args.device)

    names = load_object_vocab(args.vocab)[1:]  # drop __background__
    if args.backend == "clip":
        emb, src = encode_clip(names, args.dim, dev, args.clip_ckpt, args.bpe)
    else:
        emb, src = encode_distilbert(names, args.dim, dev, args.ckpt)
    emb = fit_dim(emb, args.dim)
    np.save(args.out, emb)
    print(f"wrote {args.out}: {emb.shape} from {src}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
