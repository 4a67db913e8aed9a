"""Shared CLI wiring: tokenizer resolution and the dataset captions it may
build a vocab from (port of oatx/cli/common.py)."""

from __future__ import annotations

import os
from typing import List, Optional

from oatx_torch.config.schema import ExperimentCfg
from oatx_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer


def resolve_tokenizer(
    exp: ExperimentCfg,
    corpus=None,  # List[str] or a lazy () -> List[str]
    search_dirs: Optional[List[str]] = None,
) -> WordPieceTokenizer:
    """Tokenizer resolution order (oatx's):
      1. a vocab.txt in `search_dirs` (checkpoint dirs);
      2. top-level config key "tokenizer": {"vocab": <path>};
      3. a vocab.txt next to arch.text_params.model (HF-layout dir);
      4. hermetic fallback — a vocab built from `corpus` (deterministic).
    oatx also tries a locally cached HF tokenizer between 3 and 4; the port
    reads vocab files only. bert uses this WordPiece path as distilbert
    does; text family 'clip' resolves a CLIP byte-level BPE tokenizer
    instead: clip_bpe.txt.gz in `search_dirs` → tokenizer.bpe /
    $OATX_CLIP_BPE / assets → synthetic merges from the corpus
    (data/clip_tokenizer.load_clip_batch_tokenizer)."""
    if exp.arch.text_params.family == "clip":
        from oatx_torch.data.clip_tokenizer import load_clip_batch_tokenizer

        return load_clip_batch_tokenizer(search_dirs=search_dirs,
                                         bpe_path=exp.raw.get("tokenizer", {}).get("bpe"),
                                         corpus=corpus)
    for d in search_dirs or []:
        vp = os.path.join(str(d), "vocab.txt")
        if os.path.exists(vp):
            return load_tokenizer(vp)
    tok_cfg = exp.raw.get("tokenizer", {})
    vocab = tok_cfg.get("vocab")
    if vocab and os.path.exists(vocab):
        return load_tokenizer(vocab)
    model_dir = exp.arch.text_params.model
    if os.path.isdir(model_dir) and os.path.exists(os.path.join(model_dir, "vocab.txt")):
        return load_tokenizer(model_dir)
    if callable(corpus):  # lazy: only materialize captions when really needed
        corpus = corpus()
    if corpus:
        if exp.arch.load_checkpoint or exp.arch.text_params.pretrained:
            import logging

            logging.getLogger("oatx_torch").warning(
                "building the tokenizer vocab from a corpus while arch uses "
                "pretrained/imported text weights — token ids will NOT match "
                "the checkpoint's vocab; ship the original vocab.txt "
                "(tokenizer.vocab) for meaningful text embeddings")
        return WordPieceTokenizer.build_from_corpus(
            corpus, vocab_size=int(tok_cfg.get("vocab_size", 30522)))
    raise FileNotFoundError(
        "no tokenizer vocab: set config key tokenizer.vocab or make "
        "arch.text_params.model a directory containing vocab.txt")


def dataset_captions(exp: ExperimentCfg, split: str = "train",
                     limit: int = 200_000) -> List[str]:
    """Captions of the configured datasets (the hermetic tokenizer corpus)."""
    import logging

    import numpy as np

    from oatx_torch.data.factory import build_dataset

    texts: List[str] = []
    for dl in exp.data_loaders:
        try:
            ds = build_dataset(dl, "baseline", split)
        except Exception as e:
            logging.getLogger("oatx_torch").warning(
                "dataset_captions: could not build %s (%s) — corpus may be partial; a "
                "later 'no tokenizer vocab' error originates HERE", dl.dataset_name, e)
            continue
        rng = np.random.default_rng(0)
        for rec in ds.metadata[: limit // max(1, len(exp.data_loaders))]:
            try:
                texts.append(ds._get_caption(rec, rng))
            except (KeyError, IndexError, TypeError):  # a record without a caption
                pass
    return texts
