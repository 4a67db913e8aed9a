"""The port's BERT and CLIP text towers, every DualTower family and
variant, the CoOp prompt learner, the weight bridge, the tokenizer
resolution and the region-memory builder, against oatx on the CPU.

Tiny geometry: the train tests' 2-block ViT (D 32, 2 frames at 32²), BERT
2 layers × 32 (2 heads), CLIP text 2 layers × 32 (2 heads, context 77, a
120-id vocab whose top id is the end token), 16-d projections; inputs from
numpy seeds, oatx params carried over by `state_dict_from_oatx`.

Tolerances (f32): every output within 1e-4 of its largest entry; the
builder's banks within 1e-4 of theirs. bf16 (the compute dtype on the card):
within 5e-2 of scale, which only a wrong cast order would break.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.config.schema import ExperimentCfg as JExp
from oatx.config.schema import build_tower_config as jbuild
from oatx.data import clip_tokenizer as jctok
from oatx.models import bert as jbert
from oatx.models import clip_text as jclip
from oatx.models import convert as jconvert
from oatx.models import distilbert as jdb
from oatx.models import prompt_learner as jpl
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx_torch.cli import common as pcommon
from oatx_torch.config.schema import ExperimentCfg as PExp
from oatx_torch.config.schema import build_tower_config as pbuild
from oatx_torch.data import clip_tokenizer as pctok
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.models import bert as pbert
from oatx_torch.models import clip_text as pclip
from oatx_torch.models import convert as pconvert
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import prompt_learner as ppl
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from torch_port_helpers import TRAIN_TEXT, TRAIN_VIDEO, oatx_params, port_model, t, \
    to_numpy, train_batch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BERT = dict(vocab_size=100, max_position_embeddings=32, dim=32, hidden_dim=64, n_layers=2,
            n_heads=2)
CLIP = dict(vocab_size=120, context_length=77, width=32, heads=2, layers=2, embed_dim=24)
TEXT = {"distilbert": (jdb.DistilBertConfig, pdb.DistilBertConfig, TRAIN_TEXT),
        "bert": (jbert.BertConfig, pbert.BertConfig, BERT),
        "clip": (jclip.ClipTextConfig, pclip.ClipTextConfig, CLIP)}
CASES = [(f, v) for f in TEXT for v in ("baseline", "global_local", "region_mem")]


def cfgs(family, variant="baseline", bf16=False):
    """(oatx TowerConfig, port TowerConfig); region_mem taps after block 1."""
    jc, pc, kw = TEXT[family]
    tap = dict(region_tap_layer=1) if variant == "region_mem" else {}
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**TRAIN_VIDEO, **tap, split_cls_stream=False,
                                      cls_position="first"),
        text=jc(**kw), text_family=family, projection_dim=16, variant=variant,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    p = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**TRAIN_VIDEO, **tap), text=pc(**kw),
        text_family=family, projection_dim=16, variant=variant,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return j, p


def clip_ids(seed, b=4, length=9, vocab=120):
    """<|startoftext|> (vocab − 2), words, <|endoftext|> (vocab − 1) at a
    varying position, zeros after."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, length), np.int32)
    for i in range(b):
        n = int(rng.integers(2, length))
        ids[i, 0], ids[i, n] = vocab - 2, vocab - 1
        ids[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
    return ids


def batch_for(family, variant, seed=0):
    out = train_batch(seed)
    if family == "clip":
        out["input_ids"] = clip_ids(seed)
        out["attention_mask"] = (out["input_ids"] != 0).astype(np.int32)
    rng = np.random.default_rng(seed + 100)
    out["object_frame"] = rng.standard_normal((4, 1, 32, 32, 3)).astype(np.float32)
    out["patch_masks"] = (rng.uniform(size=(4, 3, 4)) > 0.4).astype(np.float32)
    if variant == "global_local":
        out["pad_input_ids"] = rng.integers(0, 100, (4, 12)).astype(np.int32)
        out["pad_attention_mask"] = np.ones((4, 12), np.int32)
        out["pad_attention_mask"][1, 8:] = 0
        out["object_token_masks"] = np.cumsum(rng.integers(0, 3, (4, 3)),
                                              axis=1).astype(np.int32)
    if variant == "region_mem":
        out["text_region_embedding"] = 0.02 * rng.standard_normal((4, 3, 512)).astype(
            np.float32)
    return out


def close(got, want, scale=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max() + 1e-12)


@pytest.fixture(scope="module", params=list(TEXT))
def family_model(request):
    jcfg, pcfg = cfgs(request.param)
    params = oatx_params(jcfg)
    return request.param, jcfg, pcfg, params, port_model(params, pcfg)


# ------------------------------------------------------------------ towers
def test_bert_hidden_and_pooler_match_oatx():
    jcfg, pcfg = cfgs("bert")
    params = oatx_params(jcfg)
    model = port_model(params, pcfg)
    b = train_batch(3)
    types = np.random.default_rng(5).integers(0, 2, b["input_ids"].shape).astype(np.int32)
    hidden, pooled = jbert.apply(params["text"], jcfg.text, jnp.asarray(b["input_ids"]),
                                 jnp.asarray(b["attention_mask"]), jnp.asarray(types))
    with torch.no_grad():
        got_h, got_p = model.text_model(t(b["input_ids"]), t(b["attention_mask"]), t(types))
    close(got_h, hidden)
    close(got_p, pooled)
    assert got_p.dtype == torch.float32


def test_clip_text_matches_oatx():
    """ln_final states, encode_text (EOT row), encode_text_tokens, and a
    forward through inputs_embeds (the CoOp path)."""
    jcfg, pcfg = cfgs("clip")
    params = oatx_params(jcfg)
    tower = port_model(params, pcfg).text_model
    p, ids = params["text"], clip_ids(7)
    emb = np.random.default_rng(8).standard_normal((4, 9, 32)).astype(np.float32) * 0.1
    with torch.no_grad():
        close(tower(t(ids)), jclip.apply(p, jcfg.text, jnp.asarray(ids)))
        close(tower.encode_text(t(ids)), jclip.encode_text(p, jcfg.text, jnp.asarray(ids)))
        close(tower.encode_text_tokens(t(ids)),
              jclip.encode_text_tokens(p, jcfg.text, jnp.asarray(ids)))
        close(tower.encode_text(t(ids), inputs_embeds=t(emb)),
              jclip.encode_text(p, jcfg.text, jnp.asarray(ids), inputs_embeds=jnp.asarray(emb)))


@pytest.mark.parametrize("family,variant", CASES, ids=[f"{f}-{v}" for f, v in CASES])
def test_dual_tower_matches_oatx(family, variant):
    """Every family under every variant: the forward's outputs (clip with
    global_local raises in both packages)."""
    jcfg, pcfg = cfgs(family, variant)
    if family == "clip" and variant == "global_local":
        with pytest.raises(NotImplementedError):
            jtowers.init(jax.random.PRNGKey(0), jcfg)
        with pytest.raises(NotImplementedError):
            ptowers.DualTower(pcfg, device="cpu")
        return
    params = oatx_params(jcfg)
    model = port_model(params, pcfg)
    b = batch_for(family, variant)
    want = jtowers.forward(params, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = model({k: t(v) for k, v in b.items()})
    if variant == "baseline":
        got, want = dict(zip(("text", "video"), got)), dict(zip(("text", "video"), want))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])
    with torch.no_grad():
        emb, tokens = model.compute_text(t(b["input_ids"]), t(b["attention_mask"]),
                                         return_tokens=True)
    jemb, jtokens = jtowers.compute_text(params, jcfg, jnp.asarray(b["input_ids"]),
                                         jnp.asarray(b["attention_mask"]), return_tokens=True)
    close(emb, jemb)
    close(tokens, jtokens)


@pytest.mark.parametrize("family", ["bert", "clip"])
def test_text_towers_bf16_cast_order(family):
    """In bf16 the text embedding follows oatx's casts (bert's pooler in
    f32 then cast, clip's projection in bf16)."""
    jcfg, pcfg = cfgs(family, bf16=True)
    params = oatx_params(jcfg)
    model = port_model(params, pcfg)
    b = batch_for(family, "baseline")
    want = jtowers.compute_text(params, jcfg, jnp.asarray(b["input_ids"]),
                                jnp.asarray(b["attention_mask"]))
    with torch.no_grad():
        got = model.compute_text(t(b["input_ids"]), t(b["attention_mask"]))
    assert got.dtype == torch.float32
    close(got, want, 5e-2)


# ------------------------------------------------------------ weight bridge
@pytest.mark.parametrize("family", ["bert", "clip"])
def test_reference_pth_loads_strict(family, tmp_path):
    """oatx's reference-schema export of a bert / clip dual tower loads
    strictly into the port (convert.load_checkpoint)."""
    jcfg, pcfg = cfgs(family)
    params = oatx_params(jcfg)
    path = str(tmp_path / "w.pth")
    jconvert.export_torch_checkpoint(path, params, jcfg.video, text_family=family)
    model = pconvert.load_checkpoint(ptowers.DualTower(pcfg, device="cpu"), path)
    want = pconvert.state_dict_from_oatx(to_numpy(params), pcfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_build_tower_config_matches_oatx():
    """bert and clip model names in norm.json build the same text configs
    as oatx's build_tower_config."""
    with open(os.path.join(REPO, "configs", "pt", "cc3m_webvid", "norm.json")) as f:
        raw = json.load(f)
    for name, family in (("bert-base-uncased", "bert"),
                         ("openai/clip-vit-base-patch32", "clip")):
        raw["arch"]["args"]["text_params"]["model"] = name
        p, j = pbuild(PExp.from_dict(raw).arch), jbuild(JExp.from_dict(raw).arch)
        assert p.text_family == j.text_family == family
        assert dataclasses.asdict(p.text) == dataclasses.asdict(j.text)
        assert ptowers.text_out_dim(p) == jtowers._text_out_dim(j)
    assert (p.text.width, p.text.heads, p.text.layers, p.text.context_length) == (512, 8, 12, 77)


# ----------------------------------------------------------- prompt learner
def test_prompt_learner_distilbert_matches_oatx():
    jcfg, pcfg = cfgs("distilbert")
    params = oatx_params(jcfg)
    tower = port_model(params, pcfg).text_model
    tok = PTok.build_from_corpus(["red car", "blue sky", "a dog"], vocab_size=100)
    cfg = ppl.PromptConfig(n_ctx=3, max_name_tokens=4)
    names = ppl.encode_class_names(tok, ["red car", "dog", "blue sky"], cfg)
    ctx = np.random.default_rng(2).standard_normal((3, 32)).astype(np.float32) * 0.02
    want = jpl.class_embeddings({"ctx": jnp.asarray(ctx)}, params["text"], jcfg.text,
                                jnp.asarray(names.numpy()), tok.cls_id, tok.pad_id,
                                jpl.PromptConfig(n_ctx=3, max_name_tokens=4))
    with torch.no_grad():
        got = ppl.class_embeddings(t(ctx), tower, names, tok.cls_id, tok.pad_id, cfg)
    close(got, want)
    img = np.random.default_rng(3).standard_normal((2, 32)).astype(np.float32)
    close(ppl.classify(t(img), got), jpl.classify(jnp.asarray(img), want))
    assert ppl.PromptContext(32, cfg, device="cpu").ctx.shape == (3, 32)


def test_prompt_learner_clip_matches_oatx():
    jcfg, pcfg = cfgs("clip")
    params = oatx_params(jcfg)
    tower = port_model(params, pcfg).text_model
    corpus = ["X X a dog", "a red car"]
    ptok, jtok = pctok.ClipTokenizer.for_tests(corpus), jctok.ClipTokenizer.for_tests(corpus)
    ids = ppl.clip_tokenized_prompts(ptok, ["dog", "red car"], n_ctx=2)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jpl.clip_tokenized_prompts(jtok, ["dog", "red car"], 2)))
    ids = torch.minimum(ids, torch.tensor(CLIP["vocab_size"] - 1))  # the tiny vocab
    ctx = np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32) * 0.02
    want = jpl.clip_class_embeddings({"ctx": jnp.asarray(ctx)}, params["text"], jcfg.text,
                                     jnp.asarray(ids.numpy()), 2)
    with torch.no_grad():
        close(ppl.clip_class_embeddings(t(ctx), tower, ids, 2), want)


# ---------------------------------------------------------------- CLI
def test_resolve_tokenizer_per_family_matches_oatx(tmp_path, monkeypatch):
    """clip resolves a CLIP BPE (synthetic merges from the corpus, then the
    checkpoint dir's clip_bpe.txt.gz); bert the WordPiece vocab."""
    from oatx.cli import common as jcommon

    monkeypatch.delenv("OATX_CLIP_BPE", raising=False)
    with open(os.path.join(REPO, "configs", "pt", "cc3m_webvid", "norm.json")) as f:
        raw = json.load(f)
    corpus = ["a photo of a dog", "two cats on a mat", "a red car"]
    raw["arch"]["args"]["text_params"]["model"] = "clip-vit-b-32"
    pt = pcommon.resolve_tokenizer(PExp.from_dict(raw), corpus=lambda: corpus)
    jt = jcommon.resolve_tokenizer(JExp.from_dict(raw), corpus=lambda: corpus)
    assert isinstance(pt, pctok.ClipBatchTokenizer) and pt.tok.rank == jt.tok.rank
    pt.save_vocab(str(tmp_path / "vocab.txt"))
    again = pcommon.resolve_tokenizer(PExp.from_dict(raw), corpus=["else"],
                                      search_dirs=[tmp_path])
    assert again.bpe_path == str(tmp_path / "clip_bpe.txt.gz")
    np.testing.assert_array_equal(again(corpus, max_length=30)["input_ids"],
                                  jt(corpus, max_length=30)["input_ids"])
    raw["arch"]["args"]["text_params"]["model"] = "bert-base-uncased"
    raw["arch"]["args"]["text_params"]["vocab_size"] = 64
    bt = pcommon.resolve_tokenizer(PExp.from_dict(raw), corpus=corpus)
    assert isinstance(bt, PTok)
    assert bt.vocab == jcommon.resolve_tokenizer(JExp.from_dict(raw), corpus=corpus).vocab


def _oatx_builder():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import build_region_memory
    finally:
        sys.path.pop(0)
    return build_region_memory


def _vocab(tmp_path, n=12):
    path = tmp_path / "objects_vocab.txt"
    path.write_text("\n".join(f"thing{i},alias" for i in range(n)) + "\n")
    return str(path), [f"thing{i}" for i in range(n)]


def test_build_region_memory_clip_matches_oatx(tmp_path, monkeypatch):
    """The clip backend on the same CLIP weights (a 2-layer, width-64 text
    state_dict: heads = width / 64) and the same BPE merges: the port's
    bank equals oatx's encode_with_oatx_clip within 1e-4, padded to --dim."""
    from oatx_torch.cli import build_region_memory as pbrm

    monkeypatch.delenv("OATX_CLIP_BPE", raising=False)
    vocab, names = _vocab(tmp_path)
    cfg = jclip.ClipTextConfig(vocab_size=300, width=64, heads=1, layers=2, embed_dim=40)
    sd = jconvert.clip_text_to_torch(jclip.init(jax.random.PRNGKey(3), cfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(tmp_path / "clip.pth"))
    tok = pctok.ClipTokenizer.for_tests([pbrm.PROMPT.format(n) for n in names], 64)
    bpe = pctok.ClipBatchTokenizer(tok).save_vocab(str(tmp_path / "x"))
    out = str(tmp_path / "bank.npy")
    assert pbrm.main(["--vocab", vocab, "--out", out, "--dim", "48", "--device", "cpu",
                      "--clip-ckpt", str(tmp_path / "clip.pth"), "--bpe", bpe]) == 0
    want, src = _oatx_builder().encode_with_oatx_clip(names, 48, str(tmp_path / "clip.pth"),
                                                      bpe)
    got = np.load(out)
    assert got.shape == (12, 48) and got.dtype == np.float32 and src == "oatx-clip[bpe]"
    close(got, want)
    assert not got[:, 40:].any()


def test_build_region_memory_random_init_and_distilbert(tmp_path, monkeypatch):
    """Without --clip-ckpt: CLIP's published text tower at random init over
    synthetic merges, a (names, 512) finite bank with distinct rows; the
    distilbert backend against oatx's on the same weights; torch-clip and a
    missing --device raise."""
    from oatx_torch.cli import build_region_memory as pbrm

    monkeypatch.delenv("OATX_CLIP_BPE", raising=False)
    vocab, names = _vocab(tmp_path, 5)
    out = str(tmp_path / "bank.npy")
    assert pbrm.main(["--vocab", vocab, "--out", out, "--device", "cpu"]) == 0
    bank = np.load(out)
    assert bank.shape == (5, 512) and np.isfinite(bank).all()
    assert np.unique(bank.round(4), axis=0).shape[0] == 5

    cfg = jdb.DistilBertConfig(dim=48, hidden_dim=96, vocab_size=128,
                               max_position_embeddings=16)  # 6 layers, 12 heads
    sd = {}
    jconvert._export_distilbert_text(sd, jdb.init(jax.random.PRNGKey(1), cfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(tmp_path / "db.pth"))
    small = pdb.DistilBertConfig(**dataclasses.asdict(cfg))
    monkeypatch.setattr(pdb, "DistilBertConfig", lambda: small)
    monkeypatch.setattr(jdb, "DistilBertConfig", lambda: cfg)
    assert pbrm.main(["--vocab", vocab, "--out", out, "--device", "cpu", "--dim", "64",
                      "--backend", "distilbert", "--ckpt", str(tmp_path / "db.pth")]) == 0
    want, _ = _oatx_builder().encode_with_oatx_text_tower(names, 64, str(tmp_path / "db.pth"))
    close(np.load(out), want)
    with pytest.raises(NotImplementedError, match="clip"):
        pbrm.main(["--vocab", vocab, "--out", out, "--backend", "torch-clip"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pbrm.main(["--vocab", vocab, "--out", out])
