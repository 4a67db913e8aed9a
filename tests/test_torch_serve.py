"""oatx_torch's serving path against oatx's on the CPU: EmbedService (bucket
plans, padding, sub-batch loop, MicroBatcher), RetrievalIndex (unchunked and
chunked top-k, the .npz format), the tokenizer, the config bridge and the HTTP
handler of `oatx_torch.cli.serve`, all on device="cpu" with numpy-seeded
inputs and the same oatx params on both sides. Embeddings agree at f32
atol 1e-4, as the towers do (tests/test_torch_models.py).
"""

import base64
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.cli import serve as jserve
from oatx.config import schema as jschema
from oatx.data import tokenizer as jtok
from oatx.models import convert as jconvert
from oatx.serve import embed_service as jes
from oatx.serve import retrieval_index as jri
from oatx_torch.cli import serve as pserve
from oatx_torch.config import schema as pschema
from oatx_torch.data import tokenizer as ptok
from oatx_torch.serve import embed_service as pes
from oatx_torch.serve import retrieval_index as pri
from torch_port_helpers import oatx_cfg, oatx_params, port_cfg, port_model

torch.set_num_threads(1)
ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.json"), recursive=True))


@pytest.fixture(scope="module")
def params():
    return oatx_params(oatx_cfg(), seed=2)


@pytest.fixture(scope="module")
def services(params):
    """(oatx service, port service) on the same weights; buckets 1/4 with
    scan_chunk 2, so bucket 4 runs as a loop over two sub-batches."""
    jsvc = jes.EmbedService(params, oatx_cfg(), buckets=(1, 4), seq_len=8, scan_chunk=2)
    psvc = pes.EmbedService(port_model(params), port_cfg(), buckets=(1, 4), seq_len=8,
                            scan_chunk=2, device="cpu")
    return jsvc, psvc


def _clips(n, seed=0, frames=2, canon=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, frames, canon, canon, 3), dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 3, 6])  # exact bucket, padded, split into 4 + pad
def test_embed_video_matches_oatx(services, n):
    jsvc, psvc = services
    clips = _clips(n, seed=n)
    want = jsvc.embed_video(clips)
    got = psvc.embed_video(clips)
    assert got.shape == (n, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_embed_text_matches_oatx(services):
    jsvc, psvc = services
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 100, (5, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 3:] = 0
    np.testing.assert_allclose(psvc.embed_text(ids, mask), jsvc.embed_text(ids, mask),
                               atol=ATOL, rtol=0)
    assert psvc.stats["text"].summary()["count"] >= 2  # 5 rows: bucket 4 + bucket 1


@pytest.mark.parametrize("buckets", [(1, 4, 16), (1, 2, 8, 32), (4, 16), (1,)])
def test_chunk_plans_match_oatx(params, buckets):
    jsvc = jes.EmbedService(params, oatx_cfg(), buckets=buckets)
    psvc = pes.EmbedService(port_model(params), port_cfg(), buckets=buckets, device="cpu")
    for n in range(1, 41):
        assert psvc._chunks(n) == jsvc._chunks(n), n
        assert psvc._bucket(n) == jsvc._bucket(n), n


def test_latency_stats_match_oatx():
    samples = np.random.default_rng(1).exponential(10.0, 257).tolist()
    a, b = jes.LatencyStats(max_samples=100), pes.LatencyStats(max_samples=100)
    assert b.summary() == a.summary()  # empty: nulls, not NaN
    for s in samples:
        a.add(s)
        b.add(s)
    assert b.summary() == a.summary()


def test_tower_calls_count_sub_batches(services):
    _, psvc = services
    before = dict(psvc.tower_calls)
    psvc.embed_video(_clips(4, seed=5))  # bucket 4 = two scan_chunk-2 forwards
    psvc.embed_video(_clips(1, seed=6))
    assert psvc.tower_calls["video"] - before["video"] == 3


def test_micro_batcher_coalesces_and_matches_oatx(services):
    jsvc, psvc = services
    clips = _clips(5, seed=17)
    want = jsvc.embed_video(clips)
    mb = pes.MicroBatcher(psvc, max_batch=4, max_wait_ms=200)
    out = [None] * 5
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, mb.submit(clips[i])))
                   for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert sum(mb.batch_sizes) == 5 and max(mb.batch_sizes) > 1
        np.testing.assert_allclose(np.stack(out), want, atol=ATOL, rtol=0)
        with pytest.raises(ValueError):  # a bad clip fails its waiter only
            mb.submit(np.zeros((2, 3), np.uint8))
        np.testing.assert_allclose(mb.submit(clips[0]), want[0], atol=ATOL, rtol=0)
    finally:
        mb.close()


# ---------------------------------------------------------------- index

@pytest.mark.parametrize("pad_multiple,score_chunk", [(64, 16384), (8, 16)],
                         ids=["unchunked", "chunked"])
def test_retrieval_index_matches_oatx(pad_multiple, score_chunk):
    rng = np.random.default_rng(pad_multiple)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    ids = [f"v{i}" for i in range(50)]
    queries = rng.standard_normal((20, 16)).astype(np.float32)  # > largest bucket
    kw = dict(pad_multiple=pad_multiple, score_chunk=score_chunk)
    jidx = jri.RetrievalIndex(emb, ids, **kw)
    pidx = pri.RetrievalIndex(emb, ids, device="cpu", **kw)
    assert pidx._padded_len() == jidx._padded_len()
    for k in (1, 7, 16):
        want, got = jidx.search(queries, k=k), pidx.search(queries, k=k)
        assert len(got) == 20
        for wrow, grow in zip(want, got):
            assert [h["rank"] for h in grow] == list(range(min(k, 50)))
            ws = np.array([h["score"] for h in wrow])
            gs = np.array([h["score"] for h in grow])
            np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
            assert (np.diff(gs) <= 0).all()
            # ids where the scores are distinct (ties may order differently)
            distinct = np.r_[np.diff(ws) < -1e-5, True] & np.r_[True, np.diff(ws) < -1e-5]
            assert [h["id"] for h, d in zip(grow, distinct) if d] == \
                [h["id"] for h, d in zip(wrow, distinct) if d]
    # k above a score chunk (which oatx refuses) and above the corpus size
    # (clamped): the chunked search returns what one unchunked search does
    whole = pri.RetrievalIndex(emb, ids, pad_multiple=64, device="cpu")
    for k in (30, 80):
        got, want = pidx.search(queries, k=k), whole.search(queries, k=k)
        assert [[h["id"] for h in r] for r in got] == [[h["id"] for h in r] for r in want]
        assert len(got[0]) == min(k, 50)


def test_retrieval_index_npz_format_crosses(tmp_path):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((12, 8)).astype(np.float32)
    ids = [f"clip{i}" for i in range(12)]
    q = rng.standard_normal((2, 8)).astype(np.float32)
    jri.RetrievalIndex(emb, ids, pad_multiple=8, score_chunk=8).save(str(tmp_path / "j.npz"))
    pidx = pri.RetrievalIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert (pidx.pad_multiple, pidx.score_chunk, len(pidx), pidx.dim) == (8, 8, 12, 8)
    pidx.add(emb[:2] * 2, ["extra0", "extra1"])
    pidx.save(str(tmp_path / "p.npz"))
    jidx = jri.RetrievalIndex.load(str(tmp_path / "p.npz"))
    assert jidx.ids == pidx.ids
    want, got = jidx.search(q, 5), pidx.search(q, 5)
    np.testing.assert_allclose([[h["score"] for h in r] for r in got],
                               [[h["score"] for h in r] for r in want], atol=1e-5)
    # the int8 corpus (quantize="int8"): oatx's ranking on the same rows
    q8 = pri.RetrievalIndex(emb, ids, quantize="int8", pad_multiple=8, device="cpu")
    jq8 = jri.RetrievalIndex(emb, ids, quantize="int8", pad_multiple=8)
    for got_row, want_row in zip(q8.search(q, 5), jq8.search(q, 5)):
        assert [h["id"] for h in got_row] == [h["id"] for h in want_row]
        np.testing.assert_allclose([h["score"] for h in got_row],
                                   [h["score"] for h in want_row], atol=1e-5)


# ---------------------------------------------------------- text & configs

CORPUS = ["A man is cooking pasta in a kitchen.", "Two dogs play fetch!",
          "the café's crème brûlée", "un-believable, isn't it?", "東京の夜景 at night",
          "a video of a man playing guitar", "people dancing at a wedding party"]


def test_tokenizer_same_ids_as_oatx(tmp_path):
    jt = jtok.WordPieceTokenizer.build_from_corpus(CORPUS, vocab_size=120)
    pt = ptok.WordPieceTokenizer.build_from_corpus(CORPUS, vocab_size=120)
    assert pt.vocab == jt.vocab
    texts = CORPUS + ["an unseen sentence with zebras", "", "CAFÉ!!"]
    for max_len in (6, 30):
        a, b = jt(texts, max_length=max_len), pt(texts, max_length=max_len)
        np.testing.assert_array_equal(b["input_ids"], a["input_ids"])
        np.testing.assert_array_equal(b["attention_mask"], a["attention_mask"])
    path = jt.save_vocab(str(tmp_path / "vocab.txt"))
    pt2 = ptok.load_tokenizer(str(tmp_path))
    np.testing.assert_array_equal(pt2(texts)["input_ids"], jt(texts)["input_ids"])
    assert pt2.decode(pt2.encode(CORPUS[0])) == jt.decode(jt.encode(CORPUS[0]))
    assert ptok.load_tokenizer(path).vocab == jt.vocab
    with pytest.raises(FileNotFoundError):
        ptok.load_tokenizer(str(tmp_path / "missing"))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_build_tower_config_same_geometry(path):
    jcfg = jschema.build_tower_config(jschema.ExperimentCfg.from_json(path).arch)
    pexp = pschema.ExperimentCfg.from_json(path)
    if jcfg.object_tower is not None or jcfg.text_family != "distilbert":
        with pytest.raises(NotImplementedError):
            pschema.build_tower_config(pexp.arch)
        return
    pcfg = pschema.build_tower_config(pexp.arch)
    assert dataclasses.asdict(pcfg.video) == dataclasses.asdict(jcfg.video)
    assert dataclasses.asdict(pcfg.text) == dataclasses.asdict(jcfg.text)
    for key in ("text_family", "projection_dim", "projection", "variant"):
        assert getattr(pcfg, key) == getattr(jcfg, key), key
    assert pcfg.compute_dtype == torch.float32
    want = jnp.bfloat16 if pexp.trainer.precision == "bf16" else jnp.float32
    assert jnp.dtype(want) == jnp.dtype(
        {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[
            pschema.precision_dtype(pexp.trainer.precision)])


# ------------------------------------------------------------------- CLI

TINY_CONFIG = {
    "name": "tiny-serve",
    "tokenizer": {"vocab_size": 100},
    "arch": {"type": "FrozenInTime", "variant": "baseline", "args": {
        "video_params": {"model": "SpaceTimeTransformer", "arch_config": "base_patch16_224",
                         "num_frames": 2, "input_res": 32, "embed_dim": 64, "depth": 2,
                         "num_heads": 4, "time_init": "zeros", "pretrained": False},
        "object_params": {"model": ""},
        "text_params": {"model": "distilbert-base-uncased", "pretrained": False,
                        "vocab_size": 100, "dim": 64, "hidden_dim": 128, "n_layers": 2,
                        "n_heads": 4},
        "projection": "minimal", "projection_dim": 32, "load_checkpoint": ""}},
    "trainer": {"precision": "f32"},
}


def _npy_b64(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


def _call(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_cli_serves_oatx_checkpoint_like_oatx(tmp_path):
    """`-r` a .pth written by oatx's export_torch_checkpoint (with the
    config.json and vocab.txt beside it), an index saved by oatx; every
    endpoint of the port's server, held against oatx's service and index on
    the same weights."""
    (tmp_path / "config.json").write_text(json.dumps(TINY_CONFIG))
    jcfg = jschema.build_tower_config(
        jschema.ExperimentCfg.from_dict(TINY_CONFIG).arch)
    params = oatx_params(jcfg, seed=4)
    ckpt = str(tmp_path / "model_best.pth")
    jconvert.export_torch_checkpoint(ckpt, params, jcfg.video)
    jt = jtok.WordPieceTokenizer.build_from_corpus(CORPUS, vocab_size=100)
    jt.save_vocab(str(tmp_path / "vocab.txt"))
    jsvc = jes.EmbedService(params, jcfg, buckets=(1, 4), seq_len=30)
    corpus_clips = _clips(6, seed=30, canon=48)
    jidx = jri.RetrievalIndex(jsvc.embed_video(corpus_clips),
                              [f"c{i}" for i in range(6)], pad_multiple=8)
    jidx.save(str(tmp_path / "index.npz"))

    # --quantize int8 --index-quantize int8: oatx's int8 service and corpus
    qsvc, _, qindex, _ = pserve.build_service(
        ["-r", ckpt, "--device", "cpu", "--buckets", "1", "--quantize", "int8",
         "--index-quantize", "int8", "--index", str(tmp_path / "index.npz")])
    jqsvc = jes.EmbedService(params, jcfg, buckets=(1,), seq_len=30, quantize="int8")
    clip = _clips(1, seed=32, canon=48)
    np.testing.assert_allclose(qsvc.embed_video(clip), jqsvc.embed_video(clip),
                               atol=ATOL, rtol=0)
    assert qsvc.quant_report["quantized_kernels"] > 0 and qindex.quantize == "int8"
    assert qindex._corpus()[0].dtype == torch.int8
    svc, tok, index, our = pserve.build_service(
        ["-r", ckpt, "--device", "cpu", "--buckets", "1,4", "--port", "0",
         "--index", str(tmp_path / "index.npz")])
    assert svc.device.type == "cpu" and svc.buckets == [1, 4]
    assert tok.vocab == jt.vocab  # the vocab.txt beside the checkpoint
    assert pserve.startup_banner(svc, index, our) == jserve.startup_banner(svc, index, our)
    server = pserve.make_server(svc, tok, index, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        assert _call(url + "/healthz") == (200, {"status": "ok"})
        clips = _clips(3, seed=31, canon=48)
        code, out = _call(url + "/embed_video", {"video_b64": _npy_b64(clips)})
        assert code == 200
        np.testing.assert_allclose(out["embeddings"], jsvc.embed_video(clips),
                                   atol=ATOL, rtol=0)
        texts = ["a man is cooking", "dogs play fetch"]
        code, out = _call(url + "/embed_text", {"texts": texts})
        enc = jt(texts, max_length=30)
        want_t = jsvc.embed_text(enc["input_ids"], enc["attention_mask"])
        assert code == 200
        np.testing.assert_allclose(out["embeddings"], want_t, atol=ATOL, rtol=0)
        code, out = _call(url + "/search", {"texts": texts, "k": 3})
        assert code == 200
        for grow, wrow in zip(out["results"], jidx.search(want_t, k=3)):
            np.testing.assert_allclose([h["score"] for h in grow],
                                       [h["score"] for h in wrow], atol=ATOL)
            assert [h["rank"] for h in grow] == [0, 1, 2]
        code, out = _call(url + "/index_video", {"video_b64": _npy_b64(clips[:2]),
                                                 "ids": ["n0", "n1"]})
        assert (code, out) == (200, {"indexed": 2, "size": 8})
        code, stats = _call(url + "/stats")
        assert code == 200 and stats["index"] == {"size": 8, "dim": 32}
        assert stats["video"]["count"] >= 2 and stats["text"]["count"] >= 2
        assert _call(url + "/embed_text", {"texts": []})[0] == 400
        assert _call(url + "/embed_video", {"video_b64": _npy_b64(
            np.zeros((1, 2, 8, 8, 3), np.float32))})[0] == 400
        assert _call(url + "/index_video", {"video_b64": _npy_b64(clips), "ids": ["x"]})[0] == 400
        assert _call(url + "/nope")[0] == 404
        assert _call(url + "/nope", {})[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def test_port_imports_no_jax_and_no_oatx():
    """A fresh interpreter (isolated: no site hooks) imports the serving,
    train-step, trainer, data-plane and CLI entry points, every tower and
    the CLIP tokenizer, the visualization and profiling tools without
    pulling in jax or the oatx package, nor pandas, PIL, cv2, nltk,
    matplotlib, sklearn, regex, ftfy or transformers (the card's machine has
    none of them)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import oatx_torch.serve.embed_service, oatx_torch.cli.serve, "
            "oatx_torch.serve.retrieval_index, oatx_torch.models.convert, "
            "oatx_torch.ops.kernels.ln_mlp, oatx_torch.ops.kernels.space_attention, "
            "oatx_torch.ops.kernels.ln_linear, oatx_torch.train.step, "
            "oatx_torch.train.optim, oatx_torch.train.flops, "
            "oatx_torch.losses.contrastive, oatx_torch.train.trainer, "
            "oatx_torch.train.checkpoint, oatx_torch.data.loader, "
            "oatx_torch.data.transforms, oatx_torch.config.parser, "
            "oatx_torch.config.registry, oatx_torch.metrics.retrieval, "
            "oatx_torch.utils.logging, oatx_torch.utils.tb, oatx_torch.utils.tracking, "
            "oatx_torch.utils.watchdog, oatx_torch.cli.train, oatx_torch.cli.test, "
            "oatx_torch.cli.common, oatx_torch.data.datasets.adapters, "
            "oatx_torch.data.factory, oatx_torch.data.video_reader, "
            "oatx_torch.data.host_transforms, oatx_torch.eval.retrieval_eval, "
            "oatx_torch.models.bert, oatx_torch.models.clip_text, "
            "oatx_torch.models.object_tower, oatx_torch.models.prompt_learner, "
            "oatx_torch.data.clip_tokenizer, oatx_torch.cli.build_region_memory, "
            "oatx_torch.serve.quant, oatx_torch.serve.export, oatx_torch.serve.stats, "
            "oatx_torch.cli.export_serving, oatx_torch.cli.build_index, "
            "oatx_torch.ops.roi_align, oatx_torch.data.extraction, "
            "oatx_torch.cli.extract, oatx_torch.cli.visualize, "
            "oatx_torch.cli.average_checkpoints, oatx_torch.models.clip_vision, "
            "oatx_torch.visualization.heatmap, oatx_torch.visualization.binary_map, "
            "oatx_torch.visualization.plots, oatx_torch.visualization.png, "
            "oatx_torch.visualization.font, oatx_torch.utils.html_viz, "
            "oatx_torch.utils.profiler; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'oatx', 'flax', 'optax', 'bench', 'pandas', 'PIL', 'cv2', "
            "'nltk', 'matplotlib', 'sklearn', 'regex', 'ftfy', 'transformers')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-I", "-c", code, REPO], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_serve_vocab_from_dataset_captions_matches_oatx(tmp_path, monkeypatch):
    """With no vocab file, both servers build their tokenizer from the
    config's dataset captions (oatx/cli/serve.py:80): the same vocabulary."""
    from oatx.serve import embed_service as jes_mod
    from oatx_torch.serve import embed_service as pes_mod

    class NoService:
        def __init__(self, *a, **k):
            pass

        def warmup(self, *a, **k):
            pass

    monkeypatch.setattr(jes_mod, "EmbedService", NoService)
    monkeypatch.setattr(pes_mod, "EmbedService", NoService)
    with open(os.path.join(REPO, "configs", "smoke", "synthetic.json")) as f:
        raw = json.load(f)
    raw["data_loader"][0]["args"].update(data_dir=str(tmp_path / "videos"), object_dir="")
    raw["data_loader"][0]["args"]["video_params"]["num_videos"] = 4
    raw["arch"]["args"]["video_params"].update(embed_dim=32, depth=1, num_heads=2)
    raw["arch"]["args"]["text_params"].update(dim=32, hidden_dim=64, n_layers=1, n_heads=2)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(raw))
    vocab = {}
    for name, build, kw in (("oatx", jserve.build_service, {}),
                            ("port", pserve.build_service, {"device": "cpu"})):
        _, tok, _, _ = build(["-c", str(cfg)], **kw)
        vocab[name] = tok.save_vocab(str(tmp_path / f"{name}.txt"))
    got, want = (open(vocab[n]).read() for n in ("port", "oatx"))
    assert got == want and "scene" in got.split()
