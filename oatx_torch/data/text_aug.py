"""Text augmentation (port of oatx/data/text_aug.py; the reference's
base_dataset_global_local.py:24-107 and base_augmentation.py:8-47).

EDA operations (swap, delete, insert, synonym replacement), object-tag
shuffling, pseudo-class injection and [MASK]ing, each taking an explicit
numpy Generator and making oatx's draws in oatx's order, so one seed gives
oatx's string. oatx's synonyms come from nltk's WordNet where its data is
installed; the port reads no WordNet (nltk is absent on the card's
machine and its data would be a download), so `_synonym` is oatx's
fallback alone: no synonym, an insertion duplicates its word and a
replacement leaves the caption as it is.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _synonym(word: str) -> Optional[str]:
    """oatx's `_synonym` without WordNet: never a synonym."""
    return None


def random_swap(words: List[str], n: int, rng: np.random.Generator) -> List[str]:
    """`n` swaps of two positions drawn together (a position may meet itself)."""
    words = list(words)
    for _ in range(n):
        if len(words) < 2:
            break
        i, j = rng.integers(0, len(words), 2)
        words[i], words[j] = words[j], words[i]
    return words


def random_delete(words: List[str], p: float, rng: np.random.Generator) -> List[str]:
    """Each word dropped with probability `p`; one random word survives when
    all would go. A caption of one word is kept whole, with no draw."""
    if len(words) <= 1:
        return list(words)
    kept = [w for w in words if rng.uniform() > p]
    return kept or [words[int(rng.integers(0, len(words)))]]


def random_insert(words: List[str], n: int, rng: np.random.Generator) -> List[str]:
    """`n` times: a random word's synonym (here the word itself) inserted at
    a random position."""
    words = list(words)
    for _ in range(n):
        src = words[int(rng.integers(0, len(words)))]
        ins = _synonym(src) or src
        words.insert(int(rng.integers(0, len(words) + 1)), ins)
    return words


def synonym_replace(words: List[str], n: int, rng: np.random.Generator) -> List[str]:
    """Up to `n` words, in a random order, replaced by a synonym (the
    permutation is drawn whether or not any synonym exists)."""
    words = list(words)
    order = rng.permutation(len(words))
    replaced = 0
    for i in order:
        syn = _synonym(words[i])
        if syn:
            words[i] = syn
            replaced += 1
        if replaced >= n:
            break
    return words


def eda(caption: str, rng: Optional[np.random.Generator] = None,
        alpha: float = 0.1) -> str:
    """One EDA operation drawn among synonym / swap / insert / delete,
    applied to max(1, alpha · words) words (delete: each with probability
    alpha). An empty caption comes back unchanged, with no draw."""
    rng = rng or np.random.default_rng()
    words = caption.split()
    if not words:
        return caption
    n = max(1, int(alpha * len(words)))
    op = int(rng.integers(0, 4))
    if op == 0:
        words = synonym_replace(words, n, rng)
    elif op == 1:
        words = random_swap(words, n, rng)
    elif op == 2:
        words = random_insert(words, n, rng)
    else:
        words = random_delete(words, alpha, rng)
    return " ".join(words)


def shuffle_object_tags(tags: str, rng: Optional[np.random.Generator] = None) -> str:
    """The space-separated object tags in a random order."""
    rng = rng or np.random.default_rng()
    words = tags.split()
    return " ".join(words[i] for i in rng.permutation(len(words)))


def add_pseudo_class(tags: str, vocab: Sequence[str], n: int = 1,
                     rng: Optional[np.random.Generator] = None) -> str:
    """`n` random class names of `vocab` inserted among the tags (a
    negative-tag regularizer)."""
    rng = rng or np.random.default_rng()
    words = tags.split()
    for _ in range(n):
        cls = vocab[int(rng.integers(0, len(vocab)))]
        words.insert(int(rng.integers(0, len(words) + 1)), cls)
    return " ".join(words)


def mask_words(caption: str, p: float = 0.15, mask_token: str = "[MASK]",
               rng: Optional[np.random.Generator] = None) -> str:
    """Each word replaced by `mask_token` with probability `p`."""
    rng = rng or np.random.default_rng()
    words = [mask_token if rng.uniform() < p else w for w in caption.split()]
    return " ".join(words)
