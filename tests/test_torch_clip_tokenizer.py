"""The port's CLIP tokenizer (oatx_torch.data.clip_tokenizer, standard `re`
and `unicodedata`) against oatx's (oatx.data.clip_tokenizer, `regex`),
token for token: the word split, the ids, padding and truncation, the
synthetic merge table and the persisted merges."""

import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from oatx.data import clip_tokenizer as J
from oatx_torch.data import clip_tokenizer as P

CASES = [
    "a photo of a dog",
    "He's running, isn't he?!",
    "IT'S THEY'RE WE'VE I'M YOU'LL HE'D",
    "'ſ 'S 'Ll",                                  # regex folds ſ to s
    "café naïve résumé",                          # composed accents
    "cafe\u0301 nai\u0308ve",            # combining accents
    "日本語のテキスト 中文 한국어",               # CJK and Hangul
    "x² ½ Ⅻ ⅻ ³⁄₄ ①",                             # No / Nl numerals
    "٣٤٥ and ۱۲۳",                               # Arabic-Indic digits
    "under_scored __init__ a_b_c",
    "emoji \U0001F600\U0001F44D\U0001F3FD ok ❤️",
    "<|startoftext|>hi<|endoftext|> <|ſtartoftext|>",
    "a\u0345b \u0399",                  # U+0345: no alternative matches
    "tab\tand\nnewline  spaces \x1c sep",
    "&amp;lt;b&amp;gt; html &quot;",
    "numbers 123 and 456789, 3.14",
    "Multiple   spaces",
    "",
]
CORPUS = CASES + ["a photo of a cat", "the dog runs", "photos of dogs and cats"]

PATTERN = regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]"
    r"|[^\s\p{L}\p{N}]+", regex.IGNORECASE)  # oatx clip_tokenizer.py:110-113


@pytest.fixture(scope="module")
def toks():
    return P.ClipTokenizer.for_tests(CORPUS, 128), J.ClipTokenizer.for_tests(CORPUS, 128)


def test_synthetic_merges_equal_oatx(toks):
    p, j = toks
    assert p.rank == j.rank
    assert p.encoder == j.encoder and p.vocab_size == j.vocab_size
    assert (p.sot_id, p.eot_id) == (j.sot_id, j.eot_id)


@pytest.mark.parametrize("text", CASES)
def test_encode_matches_oatx(toks, text):
    p, j = toks
    cleaned = P._clean_text(text)
    assert cleaned == J._clean_text(text)
    assert P._split_words(cleaned) == PATTERN.findall(cleaned)
    assert p.encode(text) == j.encode(text)
    assert p.decode(p.encode(text)) == j.decode(j.encode(text))


def test_char_classes_match_regex_everywhere():
    """Every code point Python's Unicode database assigns: the port's class
    against `regex`'s letter, numeral and other alternatives (whitespace is
    collapsed to ' ' before the split, so only ' ' is asked)."""
    letter = regex.compile(r"[\p{L}]", regex.IGNORECASE)
    numeral = regex.compile(r"[\p{N}]", regex.IGNORECASE)
    other = regex.compile(r"[^\s\p{L}\p{N}]", regex.IGNORECASE)
    bad = []
    for cp in range(0x110000):
        if 0xD800 <= cp < 0xE000:
            continue
        c = chr(cp)
        if unicodedata.category(c) == "Cn" or (c.isspace() and c != " "):
            continue
        want = "L" if letter.match(c) else "N" if numeral.match(c) else \
            "O" if other.match(c) else ""
        if P._char_class(c) != want:
            bad.append((hex(cp), want, P._char_class(c)))
    assert not bad, bad[:20]


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=40))
def test_encode_fuzz_matches_oatx(toks, text):
    """Hypothesis over printable unicode (and a few apostrophes and specials
    spliced in): the same words and the same ids."""
    text = "".join(c for c in text if c.isprintable() or c.isspace())
    p, j = toks
    for s in (text, f"{text}'s <|endoftext|>{text.upper()}'LL"):
        assert P._split_words(P._clean_text(s)) == PATTERN.findall(J._clean_text(s))
        assert p.encode(s) == j.encode(s)


def test_tokenize_padding_and_truncation(toks):
    p, j = toks
    texts = ["a photo of a dog", "a " * 90 + "long tail", ""]
    np.testing.assert_array_equal(p.tokenize(texts, truncate=True),
                                  j.tokenize(texts, truncate=True))
    ids = p.tokenize(texts, truncate=True)
    assert ids.shape == (3, 77) and ids.dtype == np.int32
    assert ids[1, -1] == p.eot_id and ids[2, 0] == p.sot_id and ids[2, 1] == p.eot_id
    assert (ids[0, len(p.encode(texts[0])) + 2:] == 0).all()
    np.testing.assert_array_equal(p.tokenize("a cat", context_length=12),
                                  j.tokenize("a cat", context_length=12))
    with pytest.raises(ValueError):
        p.tokenize(texts[1])
    with pytest.raises(ValueError):
        j.tokenize(texts[1])


def test_batch_tokenizer_save_and_load_round_trip(tmp_path, monkeypatch):
    """save_vocab writes clip_bpe.txt.gz beside the checkpoints; both
    packages' loaders resolve it from there to the same ids; without it the
    corpus's synthetic merges (256), as oatx's."""
    monkeypatch.delenv("OATX_CLIP_BPE", raising=False)
    pb = P.load_clip_batch_tokenizer(corpus=lambda: CORPUS)
    jb = J.load_clip_batch_tokenizer(corpus=CORPUS)
    assert pb.tok.rank == jb.tok.rank and len(pb.tok.rank) > 64
    out = pb.save_vocab(str(tmp_path / "vocab.txt"))
    assert out == str(tmp_path / "clip_bpe.txt.gz")
    p2 = P.load_clip_batch_tokenizer(search_dirs=[tmp_path], corpus=["other words"])
    j2 = J.load_clip_batch_tokenizer(search_dirs=[tmp_path], corpus=["other words"])
    assert p2.bpe_path == out and p2.tok.rank == pb.tok.rank
    batch = ["a photo of a dog", "He's running"]
    got, want = p2(batch, max_length=30), j2(batch, max_length=30)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["input_ids"], pb(batch, max_length=30)["input_ids"])
    assert p2.encode("a dog", max_length=3) == j2.encode("a dog", max_length=3)
    # a tokenizer read from a merges file copies that file verbatim
    (tmp_path / "run2").mkdir()
    again = p2.save_vocab(str(tmp_path / "run2" / "vocab.txt"))
    assert open(again, "rb").read() == open(out, "rb").read()
