"""CLIP byte-level BPE tokenizer, pure Python (port of
oatx/data/clip_tokenizer.py; the reference's vendored
`clip/simple_tokenizer.py:62-132` and `clip/clip.py:192-228`).

    - GPT-2's byte→unicode table, so BPE runs over printable unicode;
    - vocab = 256 byte symbols + their 256 '</w>' variants + the first 48894
      merges of bpe_simple_vocab_16e6.txt.gz + 2 specials → 49408 ids;
    - text is html-unescaped twice, whitespace-collapsed and lowercased;
    - the word split keeps the specials, the contractions 's 't 're 've 'm
      'll 'd (any case), runs of letters, single numerals and runs of other
      non-space characters (oatx :110-113);
    - greedy lowest-rank pair merging, '</w>' fused onto a word's last byte;
    - tokenize() wraps with <|startoftext|> / <|endoftext|>, zero-pads to
      context_length (77), and with truncate=True keeps the end token last.

The word split without `regex`: oatx's pattern uses `regex`'s \\p{L} and
\\p{N}, which the standard `re` lacks (`[^\\W\\d_]` is not \\p{L}: it also
admits No / Nl such as '²', '½', 'Ⅻ'). `_split_words` scans by
`unicodedata.category` instead, with `regex`'s IGNORECASE semantics, which
were checked code point by code point: a letter is category L*, a numeral
N*, and "other" is neither, nor whitespace, nor a character whose simple
case mapping is a letter or numeral (U+0345, which case-folds to ι: `regex`
matches it with no alternative, so it is dropped). For code points that
Python's Unicode database leaves unassigned, `regex`'s newer database may
classify differently.

Text cleaning: oatx runs `ftfy.fix_text` first when ftfy is installed,
which repairs mojibake; the port never does (no ftfy), so where oatx has
ftfy the two can tokenize broken text differently. Well-formed text is
unchanged by ftfy, and oatx without ftfy skips it too.

The merges table is data: pass `bpe_path`, set $OATX_CLIP_BPE, or place
bpe_simple_vocab_16e6.txt.gz under oatx_torch/assets/. Without it
`ClipTokenizer.for_tests(corpus)` learns a small synthetic merge table from
a corpus, with the same mechanics.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import shutil
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77
_N_MERGES = 49152 - 256 - 2  # vocab budget of the published CLIP models
# the pattern's first alternatives, case-insensitive as in oatx ('ſ' is an 's')
_PREFIX = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
                     re.IGNORECASE)


@functools.lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """GPT-2's reversible byte → printable-unicode map: the 188 printable
    latin-1 bytes map to themselves, the rest to U+0100.. in order; the
    values' insertion order seeds vocab ids 0..255."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def default_bpe_path() -> Optional[str]:
    env = os.environ.get("OATX_CLIP_BPE")
    if env and os.path.exists(env):
        return env
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "bpe_simple_vocab_16e6.txt.gz")
    return here if os.path.exists(here) else None


def _clean_text(text: str) -> str:
    """oatx's cleaning without ftfy (module docstring)."""
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


@functools.lru_cache(maxsize=None)
def _char_class(c: str) -> str:
    """'L' letter, 'N' numeral, 'O' other, '' matched by no alternative
    (whitespace, and non-letters whose case mapping is a letter or
    numeral)."""
    cat = unicodedata.category(c)[0]
    if cat in "LN":
        return cat
    if c.isspace():
        return ""
    for v in (c.lower(), c.upper(), c.casefold()):
        if len(v) == 1 and unicodedata.category(v)[0] in "LN":
            return ""
    return "O"


def _split_words(text: str) -> List[str]:
    """findall of oatx's word pattern: at each position the first of
    <|startoftext|>, <|endoftext|>, a contraction, a letter run, one
    numeral, a run of others; a position none matches is skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _PREFIX.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        cls = _char_class(text[i])
        if cls == "N":
            out.append(text[i])
            i += 1
        elif cls:
            j = i + 1
            while j < n and _char_class(text[j]) == cls:
                j += 1
            out.append(text[i:j])
            i = j
        else:
            i += 1
    return out


def _merge_pair(word: Sequence[str], pair: Tuple[str, str]) -> List[str]:
    """Every occurrence of `pair` in `word` merged, left to right."""
    out, i = [], 0
    while i < len(word):
        if i + 1 < len(word) and (word[i], word[i + 1]) == pair:
            out.append(word[i] + word[i + 1])
            i += 2
        else:
            out.append(word[i])
            i += 1
    return out


class ClipTokenizer:
    """encode(str) → List[int]; tokenize() for padded id arrays."""

    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[List[Tuple[str, str]]] = None):
        if merges is None:
            bpe_path = bpe_path or default_bpe_path()
            if bpe_path is None:
                raise FileNotFoundError(
                    "CLIP BPE merges not found: pass bpe_path, set $OATX_CLIP_BPE, or "
                    "place bpe_simple_vocab_16e6.txt.gz under oatx_torch/assets/")
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # line 0 is a version header; cap at the published model's budget
            merges = [tuple(l.split()) for l in lines[1: _N_MERGES + 1] if l.strip()]
        self.byte_encoder = byte_unicode_table()
        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base] + ["".join(m) for m in merges] + [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]

    @classmethod
    def for_tests(cls, corpus: Sequence[str] = (), extra_merges: int = 64) -> "ClipTokenizer":
        """A tokenizer over a synthetic merge table learned from `corpus` by
        pair frequency (ties to the larger pair), as oatx learns it."""
        table = byte_unicode_table()
        vocab_words: Dict[Tuple[str, ...], int] = {}
        for text in corpus:
            for w in _clean_text(text).split():
                sym = [table[b] for b in w.encode("utf-8")]
                sym[-1] += "</w>"
                vocab_words[tuple(sym)] = vocab_words.get(tuple(sym), 0) + 1
        merges: List[Tuple[str, str]] = []
        for _ in range(extra_merges):
            counts: Dict[Tuple[str, str], int] = {}
            for sym, c in vocab_words.items():
                for a, b in zip(sym, sym[1:]):
                    counts[(a, b)] = counts.get((a, b), 0) + c
            if not counts:
                break
            best = max(counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
            merges.append(best)
            merged: Dict[Tuple[str, ...], int] = {}
            for sym, c in vocab_words.items():
                key = tuple(_merge_pair(sym, best))
                merged[key] = merged.get(key, 0) + c
            vocab_words = merged
        return cls(merges=merges)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, word: List[str]) -> List[str]:
        while len(word) > 1:
            ranked = [(self.rank[p], p) for p in zip(word, word[1:]) if p in self.rank]
            if not ranked:
                break
            word = _merge_pair(word, min(ranked)[1])
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _split_words(_clean_text(text)):
            if tok not in self._cache:
                if tok in (SOT, EOT):
                    self._cache[tok] = [tok]
                else:
                    sym = [self.byte_encoder[b] for b in tok.encode("utf-8")]
                    sym[-1] += "</w>"
                    self._cache[tok] = self._bpe(sym)
            ids.extend(self.encoder[s] for s in self._cache[tok])
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH,
                 truncate: bool = False) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"input {t!r} is {len(ids)} tokens > context "
                                     f"{context_length}")
                ids = ids[: context_length - 1] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out

    __call__ = tokenize


class ClipBatchTokenizer:
    """The WordPieceTokenizer interface the data plane calls (Collator:
    `tokenizer(texts, max_length=...)` → {'input_ids', 'attention_mask'};
    cli.train: `save_vocab`) over a ClipTokenizer."""

    def __init__(self, tok: ClipTokenizer, bpe_path: Optional[str] = None):
        self.tok = tok
        self.bpe_path = bpe_path
        self.pad_id = 0
        self.vocab_size = tok.vocab_size

    def __call__(self, texts, max_length: int = CONTEXT_LENGTH):
        ids = self.tok.tokenize(texts, context_length=max_length, truncate=True)
        return {"input_ids": ids, "attention_mask": (ids != self.pad_id).astype(np.int32)}

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        ids = self.tok.encode(text)
        if add_special_tokens:
            ids = [self.tok.sot_id] + ids + [self.tok.eot_id]
        return ids[:max_length] if max_length else ids

    def save_vocab(self, path: str) -> str:
        """Persist the exact merges beside the checkpoints as
        <dir of path>/clip_bpe.txt.gz (a copy of the BPE file, or the
        synthetic table under a version header); → that path."""
        out = os.path.join(os.path.dirname(path), "clip_bpe.txt.gz")
        if self.bpe_path and os.path.exists(self.bpe_path):
            if os.path.abspath(self.bpe_path) != os.path.abspath(out):
                shutil.copyfile(self.bpe_path, out)
        else:
            merges = sorted(self.tok.rank.items(), key=lambda kv: kv[1])
            with gzip.open(out, "wt", encoding="utf-8") as f:
                f.write("#version: oatx-synthetic\n")
                for (a, b), _ in merges:
                    f.write(f"{a} {b}\n")
        return out


def load_clip_batch_tokenizer(search_dirs=None, bpe_path: Optional[str] = None,
                              corpus=None) -> ClipBatchTokenizer:
    """clip_bpe.txt.gz in a checkpoint dir → `bpe_path` / $OATX_CLIP_BPE /
    assets → a synthetic table of 256 merges from `corpus` (a list, or a
    callable returning one)."""
    for d in search_dirs or []:
        p = os.path.join(str(d), "clip_bpe.txt.gz")
        if os.path.exists(p):
            return ClipBatchTokenizer(ClipTokenizer(bpe_path=p), bpe_path=p)
    p = bpe_path or default_bpe_path()
    if p:
        return ClipBatchTokenizer(ClipTokenizer(bpe_path=p), bpe_path=p)
    texts = corpus() if callable(corpus) else (corpus or [])
    return ClipBatchTokenizer(ClipTokenizer.for_tests(texts, extra_merges=256))
