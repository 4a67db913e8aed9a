"""WordPiece tokenizer (pure Python, HF-compatible behaviour).

The port's own copy of oatx/data/tokenizer.py (the port imports nothing of
oatx): BERT-style basic tokenization (lowercase, accent strip, punctuation
split, CJK isolation) + greedy longest-match-first WordPiece with '##'
continuations; given the same vocab.txt it produces the same ids as oatx and
HF. Falls back to building a vocab from a corpus for hermetic runs.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
        0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F or
        0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF or
        0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    # clean: drop control chars, normalize whitespace
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        if ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
            out_chars.append(" ")
        elif _is_cjk(cp):
            out_chars.append(f" {ch} ")
        else:
            out_chars.append(ch)
    text = "".join(out_chars)

    tokens: List[str] = []
    for tok in text.strip().split():
        if lower:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        # split on punctuation
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lower: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lower = lower
        self.max_input_chars_per_word = max_input_chars_per_word
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.mask_id = vocab.get(MASK, self.unk_id)

    # -------------------------------------------------------------- loading

    @classmethod
    def from_vocab_file(cls, path: str, lower: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lower=lower)

    @classmethod
    def build_from_corpus(
        cls, texts: Iterable[str], vocab_size: int = 8192, lower: bool = True
    ) -> "WordPieceTokenizer":
        """Frequency-based whole-word vocab (chars as continuations) — for
        synthetic/hermetic runs, not a trained BPE."""
        from collections import Counter

        counter: Counter = Counter()
        chars: set = set()
        for t in texts:
            for w in basic_tokenize(t, lower):
                counter[w] += 1
                chars.update(w)
        vocab_list = [PAD, UNK, CLS, SEP, MASK]
        vocab_list += sorted(chars)
        vocab_list += [f"##{c}" for c in sorted(chars)]
        seen = set(vocab_list)
        for w, _ in counter.most_common():
            if len(vocab_list) >= vocab_size:
                break
            if w not in seen:
                seen.add(w)
                vocab_list.append(w)
        vocab = {w: i for i, w in enumerate(vocab_list)}
        return cls(vocab, lower=lower)

    def save_vocab(self, path: str) -> str:
        """Write vocab.txt (one token per line, index order) — persisted next to
        checkpoints so eval/finetune runs reuse the exact training vocab."""
        inv = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in inv:
                f.write(tok + "\n")
        return path

    # ---------------------------------------------------------- tokenization

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        out: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for w in basic_tokenize(text, self.lower):
            toks.extend(self.wordpiece(w))
        return toks

    def encode(self, text: str, max_length: Optional[int] = None,
               add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            budget = (max_length - 2) if max_length else None
            if budget is not None:
                ids = ids[:budget]
            ids = [self.cls_id] + ids + [self.sep_id]
        elif max_length:
            ids = ids[:max_length]
        return ids

    def __call__(
        self,
        texts: Sequence[str] | str,
        max_length: int = 30,
        padding: str = "max_length",   # 'max_length' | 'longest'
        return_np: bool = True,
    ):
        """HF-style batch encode → {'input_ids', 'attention_mask'} int32 arrays."""
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t, max_length=max_length) for t in texts]
        if padding == "longest":
            max_length = max(len(e) for e in encoded)
        ids = np.full((len(encoded), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), max_length), np.int32)
        for i, e in enumerate(encoded):
            e = e[:max_length]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        if return_np:
            return {"input_ids": ids, "attention_mask": mask}
        return {"input_ids": ids.tolist(), "attention_mask": mask.tolist()}

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        toks = []
        special = {self.pad_id, self.cls_id, self.sep_id}
        for i in ids:
            if skip_special and int(i) in special:
                continue
            toks.append(self.inv_vocab.get(int(i), UNK))
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out

    def token_length(self, text: str) -> int:
        """Token count without specials — for the object-tag token-length table
        (reference objects_vocab_token_len.txt semantics)."""
        return len(self.tokenize(text))


def load_tokenizer(name_or_path: str) -> WordPieceTokenizer:
    """Resolve a tokenizer: a vocab.txt path or a directory containing
    vocab.txt. (oatx also tries a locally cached HF tokenizer by model name;
    the port reads vocab files only.)"""
    import os

    if os.path.isdir(name_or_path):
        vp = os.path.join(name_or_path, "vocab.txt")
        if os.path.exists(vp):
            return WordPieceTokenizer.from_vocab_file(vp)
    if os.path.isfile(name_or_path):
        return WordPieceTokenizer.from_vocab_file(name_or_path)
    raise FileNotFoundError(
        f"no vocab found for {name_or_path!r}: pass a vocab.txt path or a "
        "directory containing one")
