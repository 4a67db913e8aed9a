"""The Trainer under pipeline stages (`trainer.pipeline`), on the CPU (gloo).

oatx's own end-to-end pipeline test (tests/test_pipeline.py
`test_trainer_pipeline_mode_e2e`) in both packages: a ViT of embed 32, 2
blocks of 2 heads over 2 frames at 32², a DistilBERT of 1 layer of 32,
projection 8, AdamW at 1e-3 in f32, `model_parallel` 2 with `pipeline` and
2 micro-batches, t2v metrics on validation; here 2 epochs of 2 steps, a
validation and a snapshot after each, both packages from one .pth.

  * 4 gloo ranks (tests/torch_dp_worker.py mode `pp_trainer`: 2 data
    positions × 2 stages, 4 clips a position) run Trainer.train() against
    oatx's Trainer on a 4-device (data 2, model 2) CPU mesh over the same
    global batches of 8 (data/loader.py GlobalBatches over oatx's loaders),
    both with the eval transform in place of train_augment (their
    generators differ): every per-step loss term within 1e-4 relative, and
    each validation's embeddings (oatx's run through its sequential eval
    path) within 1e-4 of their largest entry, rows matched by their token
    ids; the stages of a position embed bitwise alike;
  * the ranks' snapshot has a one-process snapshot's keys and whole shapes;
    one process (pipeline on a model axis of 1: one stage) restores it
    bitwise and repeats epoch 2's loss terms (1e-5), and 4 ranks restore a
    one-process checkpoint-epoch1 bitwise and repeat its epoch 2 (1e-5);
  * a global batch that the micro-batches and batch shards do not divide,
    and pipeline with sequence_parallel, raise oatx's ValueErrors.
"""

from __future__ import annotations

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from oatx.config import schema as jschema
from oatx.data import loader as JL
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx.models import convert as jconvert
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx.train import trainer as jtrainer_mod
from oatx_torch.config import schema as pschema
from oatx_torch.data import loader as PL
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.models.towers import DualTower
from oatx_torch.train import step as pstep
from oatx_torch.train import trainer as ptrainer_mod
from torch_port_helpers import MemoryClips, launch_dp, oatx_params

torch.set_num_threads(1)

BATCH = 4  # a data position's
CLIPS = dict(n=16, frames=2, canon=32)
LAUNCH_TIMEOUT_S = 300


def _raw(init, mp=2, epochs=2, micro=2, **trainer):
    """oatx test_trainer_pipeline_mode_e2e's experiment."""
    return {
        "name": "pp-e2e",
        "arch": {"variant": "baseline", "args": {
            "video_params": {"model": "SpaceTimeTransformer", "num_frames": 2,
                             "input_res": 32, "embed_dim": 32, "depth": 2, "num_heads": 2,
                             "pretrained": False},
            "text_params": {"model": "distilbert-base-uncased", "pretrained": False,
                            "vocab_size": 100, "dim": 32, "hidden_dim": 64, "n_layers": 1,
                            "n_heads": 2},
            "projection_dim": 8, "load_checkpoint": str(init)}},
        "data_loader": [{"type": "x", "args": {"dataset_name": "MemoryClips",
                                               "batch_size": BATCH}}],
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
        "loss": {"type": "NormSoftmaxLoss"},
        "metrics": ["t2v_metrics"],
        "trainer": {"epochs": epochs, "len_epoch": 2, "save_period": 1, "monitor": "off",
                    "init_val": False, "precision": "f32", "verbosity": 1, "seed": 0,
                    "model_parallel": mp, "pipeline": True,
                    "pipeline_microbatches": micro, **trainer}}


def _job(tmp, name, init, resume=None, **kw):
    return {"raw": _raw(init, **kw), "save_dir": str(tmp / name), "resume": resume,
            "valid": True}


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """One .pth both packages start from (oatx params, biases and LN affines
    made non-trivial)."""
    tmp = tmp_path_factory.mktemp("pp_init")
    jcfg = jtrainer_mod.build_tower_config(jschema.ExperimentCfg.from_dict(
        _raw(tmp / "none.pth")).arch)
    path = tmp / "init.pth"
    jconvert.export_torch_checkpoint(str(path), oatx_params(jcfg), jcfg.video)
    return path


def _payload(tmp, jobs):
    return {"jobs": jobs, "clips": CLIPS, "batch": BATCH, "log_dir": str(tmp / "log"),
            "eval_augment": True}


@pytest.fixture(scope="module")
def launches(tmp_path_factory, init):
    """The ranks' run from scratch (after a job whose micro-batches do not
    divide its batch), started in the background; the resume from a
    one-process snapshot is started once that snapshot exists
    (`one_process`)."""
    tmp = tmp_path_factory.mktemp("pp_trainer")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    jobs = [_job(tmp, "indivisible", init, micro=3), _job(tmp, "pp", init)]
    out = {"tmp": tmp, "pool": pool,
           "pp": pool.submit(launch_dp, "pp_trainer", 4, _payload(tmp, jobs), tmp / "a",
                             LAUNCH_TIMEOUT_S)}
    yield out
    pool.shutdown(wait=True)


def _eval_augment(monkeypatch):
    for mod in (jstep, pstep):
        orig = mod.make_augmenter
        monkeypatch.setattr(mod, "make_augmenter",
                            lambda *a, _o=orig, **kw: _o(train=False, tower_cfg=kw["tower_cfg"]))


def _port_one(tmp, init, monkeypatch, name, resume=None):
    """The port's Trainer in this process, pipeline on a model axis of 1,
    over the ranks' global batches: (loss terms per step, the whole state
    once built)."""
    _eval_augment(monkeypatch)
    ds = MemoryClips(**CLIPS)
    col = PL.Collator(PTok.build_from_corpus(ds.captions, vocab_size=100), max_text_len=10)
    exp = pschema.ExperimentCfg.from_dict(_raw(init, mp=1))
    train = [PL.GlobalBatches([PL.ShardedLoader(ds, BATCH, col, seed=0, num_workers=1,
                                                shard_id=p, num_shards=2) for p in range(2)])]
    tr = ptrainer_mod.Trainer(exp, train, [], save_dir=tmp / name, resume=resume,
                              device="cpu")
    assert tr.tower_cfg.video.pipeline_stages == 1
    built = {"model": {k: v.clone() for k, v in tr.state.model.state_dict().items()},
             "optimizer": tr.state.optimizer.named_state(to_host=True)}
    terms, inner = [], tr.train_step

    def recorded(state, b):
        state, m = inner(state, b)
        terms.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
        return state, m

    tr.train_step = recorded
    tr.train()
    return terms, built


@pytest.fixture(scope="module")
def one_process(launches, init):
    """One process from scratch (its checkpoint-epoch1 then restored by 4
    ranks, in the background) → (its terms, its snapshot's path, the
    ranks' future)."""
    mp = pytest.MonkeyPatch()
    try:
        tmp = launches["tmp"]
        terms, _ = _port_one(tmp, init, mp, "one")
    finally:
        mp.undo()
    snap = tmp / "one" / "checkpoint-epoch1"
    fut = launches["pool"].submit(launch_dp, "pp_trainer", 4, _payload(
        tmp, [_job(tmp, "pp_resumed", init, resume=str(snap))]), tmp / "b", LAUNCH_TIMEOUT_S)
    return terms, snap, fut


@functools.lru_cache(maxsize=None)
def _oatx_run(init):
    """oatx's Trainer with pipeline on a (data 2, model 2) CPU mesh over the
    same global batches → (its loss terms per step, every eval step's token
    ids and embeddings)."""
    import tempfile

    mp = pytest.MonkeyPatch()
    _eval_augment(mp)
    mesh = jmesh.make_mesh(n_devices=4, model_parallel=2)
    try:
        ds = MemoryClips(**CLIPS)
        col = JL.Collator(JTok.build_from_corpus(ds.captions, vocab_size=100), max_text_len=10)
        exp = jschema.ExperimentCfg.from_dict(_raw(init))
        train = [PL.GlobalBatches([JL.ShardedLoader(ds, BATCH, col, seed=0, num_workers=1,
                                                    shard_id=p, num_shards=2)
                                   for p in range(2)])]
        valid = [JL.ShardedLoader(ds, BATCH, col, shuffle=False, drop_last=False,
                                  num_workers=1)]
        with tempfile.TemporaryDirectory() as tmp:
            tr = jtrainer_mod.Trainer(exp, train, valid, save_dir=tmp, mesh=mesh)
            assert tr.tower_cfg.video.pipeline_stages == 2
            terms, evals = [], []
            inner, inner_eval = tr.train_step, tr.eval_step

            def recorded(state, b):
                state, m = inner(state, b)
                terms.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
                return state, m

            def recorded_eval(params, b):
                out = inner_eval(params, b)
                evals.append({"input_ids": np.asarray(b["input_ids"]),
                              **{k: np.asarray(v) for k, v in out.items()}})
                return out

            tr.train_step, tr.eval_step = recorded, recorded_eval
            tr.train()
    finally:
        jmesh.set_current_mesh(None)
        mp.undo()
    return terms, evals


def _close_terms(got, want, rtol):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def _by_ids(evals, key):
    """{token ids row: embedding row} over eval steps."""
    out = {}
    for e in evals:
        for ids, row in zip(np.asarray(e["input_ids"]), np.asarray(e[key])):
            k = tuple(int(i) for i in ids)
            assert k not in out
            out[k] = row
    return out


def test_ranks_train_and_validate_as_oatx(launches, init):
    """Every per-step loss term of the 4 ranks against oatx's Trainer on the
    same (data, model) mesh (the ranks agree bitwise), and each validation's
    text and video embeddings of both positions against oatx's sequential
    eval path, rows matched by their token ids."""
    want, want_evals = _oatx_run(init)  # while the ranks run
    ranks = [r[1] for r in launches["pp"].result()]
    assert len(want) == 4
    for rank in ranks:
        assert rank["steps"] == ranks[0]["steps"]
        assert rank["layout"]["pipeline"] and rank["layout"]["model_parallel"] == 2
    _close_terms(ranks[0]["steps"], want, 1e-4)
    assert ranks[0]["hist"][2]["val_loss"] > 0
    half = len(want_evals) // 2
    for stage0, stage1 in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        assert len(stage0["evals"]) == len(stage1["evals"]) == 4
        for a, b in zip(stage0["evals"], stage1["evals"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    for epoch in range(2):
        got = ranks[0]["evals"][2 * epoch:2 * epoch + 2] + \
            ranks[2]["evals"][2 * epoch:2 * epoch + 2]
        oatx = want_evals[half * epoch:half * (epoch + 1)]
        for key in ("text_embeds", "video_embeds"):
            g, w = _by_ids(got, key), _by_ids(oatx, key)
            assert sorted(g) == sorted(w) and len(g) == CLIPS["n"]
            scale = max(float(np.abs(v).max()) for v in w.values())
            for k, v in w.items():
                np.testing.assert_allclose(np.asarray(g[k]), v, rtol=0, atol=1e-4 * scale,
                                           err_msg=key)


def test_indivisible_batch_raises(launches):
    """A global batch of 8 with 3 micro-batches raises oatx's ValueError
    (trainer.py:119-125) on every rank."""
    for rank in launches["pp"].result():
        assert "must be a multiple of pipeline_microbatches (3) x batch shards (2)" in \
            rank[0]["error"]


def test_pipeline_with_sequence_parallel_raises(init):
    """oatx's ValueError (trainer.py:81-85), before any placement."""
    raw = _raw(init)
    raw["arch"]["args"]["video_params"]["sequence_parallel"] = True
    with pytest.raises(ValueError, match="sequence_parallel cannot combine with "
                                         "trainer.pipeline"):
        ptrainer_mod.Trainer(pschema.ExperimentCfg.from_dict(raw), [], device="cpu")


def test_snapshot_resumes_in_one_process(launches, init, monkeypatch):
    """The ranks' checkpoint-epoch1 has a one-process snapshot's keys and
    whole shapes, every block from its stage; one process restores it
    bitwise and repeats epoch 2."""
    tmp = launches["tmp"]
    ranks = launches["pp"].result()
    snap = tmp / "pp" / "checkpoint-epoch1"
    saved = torch.load(snap / "state.pt", weights_only=True)
    assert sorted(saved) == ["model", "optimizer", "step"] and saved["step"] == 2
    with torch.device("meta"):
        cfg = pschema.build_tower_config(pschema.ExperimentCfg.from_dict(_raw(init)).arch)
        model = DualTower(cfg, device="meta", generator=torch.Generator())
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == want
    assert sorted(saved["optimizer"]) == ["count", "mu", "nu"]
    for key in ("mu", "nu"):
        assert {k: tuple(v.shape) for k, v in saved["optimizer"][key].items()} == want
    terms, built = _port_one(tmp, init, monkeypatch, "one_from_pp", resume=str(snap))
    assert all(torch.equal(built["model"][k], v) for k, v in saved["model"].items())
    for key in ("mu", "nu"):
        assert all(torch.equal(built["optimizer"][key][k], v)
                   for k, v in saved["optimizer"][key].items())
    _close_terms(terms, ranks[0][1]["steps"][2:], 1e-5)


def test_one_process_snapshot_resumes_on_stages(one_process):
    """4 ranks on 2 stages restore a one-process checkpoint-epoch1 bitwise
    (parameters and moments, gathered whole again from the stages) and
    repeat its epoch 2."""
    terms, snap, fut = one_process
    saved = torch.load(snap / "state.pt", weights_only=True)
    for rank in fut.result():
        built = rank[0]["built"]
        assert all(torch.equal(built["model"][k], v) for k, v in saved["model"].items())
        for key in ("mu", "nu"):
            assert all(torch.equal(built["optimizer"][key][k], v)
                       for k, v in saved["optimizer"][key].items())
        _close_terms(rank[0]["steps"], terms[2:], 1e-5)
