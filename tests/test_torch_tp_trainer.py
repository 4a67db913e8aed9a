"""The Trainer and cli.train under a model axis, on the CPU (gloo).

A tiny copy of configs/pt/cc3m_webvid/vit_huge_pod.json (arch_config
huge_patch14_224 cut to embed 64, 2 blocks, 4 heads, 2 frames at 28², so
4 patches a frame; DistilBERT 2 layers of 32 with 2 heads) with
`model_parallel` 2 and every other pod key as shipped: sequence_parallel,
remat dots_all, fsdp, accum_steps 2, the chunked NormSoftmax,
skip_nonfinite, async checkpoints and the cosine schedule (warm-up cut to
1 step so the updates move the weights). The port's ranks shard leaves of
256 elements and more under fsdp (FSDP_MIN_SIZE; at its default 2**16 this
geometry would replicate); oatx's Trainer runs at its own min_size, under
which it replicates them: fsdp changes what a rank holds, not the numbers.
(oatx's Trainer with min_size 256 and accum_steps 2 moves step 1's loss by
5e-3 relative, while its step function under the same placement does not:
ROADMAP C3.)

  * 4 gloo ranks (tests/torch_dp_worker.py mode `tp_trainer`: 2 data
    positions × a model group of 2) run Trainer.train() for 2 epochs of 2
    steps at 4 clips a position, against oatx's Trainer on a 4-device
    (data 2, model 2) CPU mesh over the same global batches of 8
    (data/loader.py GlobalBatches over oatx's loaders); both take the eval
    transform in place of train_augment (their generators differ): every
    per-step loss term within 1e-4 relative. A port micro-batch is each
    position's i-th part of its rows (as oatx's manual-DP step splits each
    shard's), oatx's GSPMD step splits the global batch into parts; oatx is
    handed its global batches micro-batch-major (`MicroMajor`), so both
    steps' micro-batches hold the same rows in the same order;
  * the snapshot the ranks write holds a one-process snapshot's keys and
    whole shapes; one process restores it bitwise and repeats epoch 2's
    loss terms (1e-5), and 4 ranks at mp 2 restore a one-process snapshot
    bitwise and repeat its epoch 2 (1e-5);
  * the loaders shard by data position: model peers train on the same
    rows, positions on theirs;
  * `python -m oatx_torch.cli.train` with the same recipe over
    SyntheticVideoText on 4 processes under OATX_MULTIHOST=1: rc 0 on every
    rank, the model axis in every rank's log, the snapshot with the
    one-process schema.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import subprocess
import sys

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
from oatx_torch.parallel import sharding as pshard
from oatx_torch.train import step as pstep
from oatx_torch.train import trainer as ptrainer_mod
from torch_port_helpers import REPO, MemoryClips, launch_dp, oatx_params

torch.set_num_threads(1)

MIN_SIZE = 256
BATCH = 4  # a data position's
CLIPS = dict(n=16, frames=2, canon=32)
LAUNCH_TIMEOUT_S = 300


def _raw(init, mp=2, epochs=2, **trainer):
    with open(os.path.join(REPO, "configs", "pt", "cc3m_webvid", "vit_huge_pod.json")) as f:
        raw = json.load(f)
    args = raw["arch"]["args"]
    args["video_params"].update(input_res=28, num_frames=2, embed_dim=64, depth=2, num_heads=4)
    args["text_params"].update(vocab_size=100, dim=32, hidden_dim=64, n_layers=2, n_heads=2)
    args["projection_dim"] = 16
    args["load_checkpoint"] = str(init)
    raw["optimizer"]["args"]["warmup_steps"] = 1
    raw["trainer"].update(model_parallel=mp, epochs=epochs, len_epoch=2, save_period=1,
                          verbosity=1, init_val=False, precision="f32", seed=0, **trainer)
    return raw


def _job(tmp, name, init, resume=None, mp=2):
    return {"raw": _raw(init, mp), "save_dir": str(tmp / name), "resume": resume,
            "min_size": MIN_SIZE}


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """One .pth both packages start from (oatx params, biases and LN affines
    made non-trivial)."""
    tmp = tmp_path_factory.mktemp("tp_init")
    jcfg = jtrainer_mod.build_tower_config(jschema.ExperimentCfg.from_dict(
        _raw(tmp / "none.pth")).arch)
    path = tmp / "init.pth"
    jconvert.export_torch_checkpoint(str(path), oatx_params(jcfg), jcfg.video)
    return path


def _eval_augment(monkeypatch):
    for mod in (jstep, pstep):
        orig = mod.make_augmenter
        monkeypatch.setattr(mod, "make_augmenter",
                            lambda *a, _o=orig, **kw: _o(train=False, tower_cfg=kw["tower_cfg"]))


def _payload(tmp, jobs):
    return {"jobs": jobs, "clips": CLIPS, "batch": BATCH, "log_dir": str(tmp / "log"),
            "eval_augment": True}


@pytest.fixture(scope="module")
def launches(tmp_path_factory, init):
    """The ranks' launches, started at once in the background: the TP run
    from scratch and the cli run; the resume from a one-process snapshot is
    started once that snapshot exists (`one_process`)."""
    tmp = tmp_path_factory.mktemp("tp_trainer")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    out = {"tmp": tmp, "pool": pool,
           "tp": pool.submit(launch_dp, "tp_trainer", 4,
                             _payload(tmp, [_job(tmp, "tp", init)]), tmp / "a",
                             LAUNCH_TIMEOUT_S),
           "cli": pool.submit(_cli, tmp / "cli")}
    yield out
    pool.shutdown(wait=True)


def _port_one(tmp, init, monkeypatch, name, resume=None, epochs=2):
    """The port's Trainer in this process at mp 1 over the ranks' global
    batches (micro-batch-major, as oatx's): (loss terms per step, the whole
    state once built, the Trainer)."""
    _eval_augment(monkeypatch)
    monkeypatch.setattr(pshard, "FSDP_MIN_SIZE", MIN_SIZE)
    ds = MemoryClips(**CLIPS)
    col = PL.Collator(PTok.build_from_corpus(ds.captions, vocab_size=100), max_text_len=10)
    exp = pschema.ExperimentCfg.from_dict(_raw(init, mp=1, epochs=epochs))
    train = [MicroMajor([PL.ShardedLoader(ds, BATCH, col, seed=0, num_workers=1, shard_id=p,
                                          num_shards=2) for p in range(2)],
                        exp.trainer.accum_steps)]
    tr = ptrainer_mod.Trainer(exp, train, [], save_dir=tmp / name, resume=resume,
                              device="cpu")
    built = {"model": {k: v.clone() for k, v in tr.state.model.state_dict().items()},
             "optimizer": tr.state.optimizer.named_state(to_host=True)}
    terms = []
    inner = tr.train_step

    def recorded(state, b):
        state, m = inner(state, b)
        terms.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
        return state, m

    tr.train_step = recorded
    tr.train()
    return terms, built, tr


@pytest.fixture(scope="module")
def one_process(launches, init):
    """One process from scratch (its checkpoint-epoch1 then restored by 4
    ranks at mp 2, in the background) → (its terms, its snapshot's path,
    the ranks' future)."""
    mp = pytest.MonkeyPatch()
    try:
        tmp = launches["tmp"]
        terms, _, _ = _port_one(tmp, init, mp, "one")
    finally:
        mp.undo()
    snap = tmp / "one" / "checkpoint-epoch1"
    fut = launches["pool"].submit(launch_dp, "tp_trainer", 4, _payload(
        tmp, [_job(tmp, "tp_resumed", init, resume=str(snap))]), tmp / "b", LAUNCH_TIMEOUT_S)
    return terms, snap, fut


class MicroMajor(PL.GlobalBatches):
    """GlobalBatches with each batch's rows reordered micro-batch-major: the
    first positions' first `accum` parts, then their second parts..., so a
    reshape of the batch into `accum` parts gives the port's micro-batches."""

    def __init__(self, shards, accum):
        super().__init__(shards)
        self.accum = accum

    def iter_batches(self, start_batch=0):
        n, a = len(self.shards), self.accum
        for b in super().iter_batches(start_batch):
            yield {k: (np.swapaxes(v.reshape(n, a, -1, *v.shape[1:]), 0, 1).reshape(v.shape)
                       if isinstance(v, np.ndarray) and v.ndim else v)
                   for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _oatx_terms(init):
    """oatx's Trainer on a (data 2, model 2) CPU mesh over the same global
    batches → its loss terms per step."""
    import tempfile

    mp = pytest.MonkeyPatch()
    _eval_augment(mp)
    mesh = jmesh.make_mesh(n_devices=4, model_parallel=2)
    try:
        ds = MemoryClips(**CLIPS)
        col = JL.Collator(JTok.build_from_corpus(ds.captions, vocab_size=100), max_text_len=10)
        exp = jschema.ExperimentCfg.from_dict(_raw(init))
        train = [MicroMajor([JL.ShardedLoader(ds, BATCH, col, seed=0, num_workers=1,
                                              shard_id=p, num_shards=2) for p in range(2)],
                            exp.trainer.accum_steps)]
        with tempfile.TemporaryDirectory() as tmp:
            tr = jtrainer_mod.Trainer(exp, train, [], save_dir=tmp, mesh=mesh)
            terms, inner = [], tr.train_step

            def recorded(state, b):
                state, m = inner(state, b)
                terms.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
                return state, m

            tr.train_step = recorded
            tr.train()
    finally:
        jmesh.set_current_mesh(None)
        mp.undo()
    return terms


def _close_terms(got, want, rtol):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def test_ranks_train_as_oatx(launches, init):
    """Every per-step loss term of the 4 ranks against oatx's Trainer on the
    same (data, model) mesh; the ranks agree bitwise."""
    want = _oatx_terms(init)  # while the ranks run
    ranks = launches["tp"].result()
    assert len(want) == 4
    for rank in ranks:
        assert rank[0]["steps"] == ranks[0][0]["steps"]
    _close_terms(ranks[0][0]["steps"], want, 1e-4)


def test_loaders_shard_by_data_position(launches):
    """Model peers (ranks 0 and 1, 2 and 3) train on the same rows; the two
    positions on different ones."""
    ranks = [r[0] for r in launches["tp"].result()]
    assert [r["position"] for r in ranks] == [0, 0, 1, 1]
    for a, b in ((0, 1), (2, 3)):
        assert all(torch.equal(x, y) for x, y in zip(ranks[a]["input_ids"],
                                                     ranks[b]["input_ids"]))
    assert not all(torch.equal(x, y) for x, y in zip(ranks[0]["input_ids"],
                                                     ranks[2]["input_ids"]))


def test_snapshot_resumes_in_one_process(launches, init, monkeypatch):
    """The ranks' checkpoint-epoch1 has a one-process snapshot's keys and
    whole shapes; one process restores it bitwise and repeats epoch 2."""
    tmp = launches["tmp"]
    ranks = launches["tp"].result()
    snap = tmp / "tp" / "checkpoint-epoch1"
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
    terms, built, _ = _port_one(tmp, init, monkeypatch, "one_from_tp", resume=str(snap))
    assert all(torch.equal(built["model"][k], v) for k, v in saved["model"].items())
    for key in ("mu", "nu"):
        assert all(torch.equal(built["optimizer"][key][k], v)
                   for k, v in saved["optimizer"][key].items())
    _close_terms(terms, ranks[0][0]["steps"][2:], 1e-5)


def test_one_process_snapshot_resumes_at_mp2(one_process):
    """4 ranks at mp 2 restore a one-process checkpoint-epoch1 bitwise
    (parameters and moments, gathered whole again on every rank) and repeat
    its epoch 2."""
    terms, snap, fut = one_process
    saved = torch.load(snap / "state.pt", weights_only=True)
    for rank in fut.result():
        built = rank[0]["built"]
        assert all(torch.equal(built["model"][k], v) for k, v in saved["model"].items())
        for key in ("mu", "nu"):
            assert all(torch.equal(built["optimizer"][key][k], v)
                       for k, v in saved["optimizer"][key].items())
        _close_terms(rank[0]["steps"], terms[2:], 1e-5)


# ----------------------------------------------------------------- cli
def _cli(tmp):
    """`python -m oatx_torch.cli.train` on 4 gloo ranks under
    OATX_MULTIHOST=1 with the tiny vit_huge_pod recipe over SyntheticVideoText
    → each rank's (rc, output) and the run's output directory."""
    from oatx_torch.config.registry import DATASETS
    from oatx_torch.config.schema import DataLoaderCfg
    from oatx_torch.data.datasets import adapters  # noqa: F401 (registers them)

    with open(os.path.join(REPO, "configs", "smoke", "synthetic.json")) as f:
        smoke = json.load(f)
    dl = smoke["data_loader"][0]
    dl["args"].update(data_dir=str(tmp / "videos"), object_dir="", num_workers=1,
                      batch_size=BATCH)
    dl["args"]["video_params"].update(input_res=28, num_frames=2)
    raw = _raw("", epochs=1)
    raw["data_loader"] = [dl]
    raw["tokenizer"] = smoke["tokenizer"]
    raw["arch"]["args"]["text_params"]["vocab_size"] = smoke["tokenizer"]["vocab_size"]
    raw["trainer"].update(save_dir=str(tmp / "out"), max_samples_per_epoch=16)
    raw["trainer"].pop("len_epoch")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "cfg.json").write_text(json.dumps(raw))
    DATASETS.get("SyntheticVideoText")(DataLoaderCfg(
        dataset_name="SyntheticVideoText", data_dir=dl["args"]["data_dir"], num_workers=1,
        video_params=dl["args"]["video_params"], split="train"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("OATX_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", OATX_MULTIHOST="1",
               OATX_COORDINATOR=(tmp / "store").as_uri(), OATX_NUM_PROCESSES="4")
    procs = [subprocess.Popen([sys.executable, "-m", "oatx_torch.cli.train", "-c",
                               str(tmp / "cfg.json"), "--device", "cpu"], cwd=REPO,
                              env={**env, "OATX_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)], tmp / "out"


def test_cli_train_runs_the_pod_recipe(launches):
    """cli.train takes model_parallel 2 (with sequence_parallel, fsdp,
    dots_all, accum_steps 2, the chunked loss) from the recipe alone: every
    rank exits 0 and logs its place on the model axis; rank 0 writes the
    snapshot, whole."""
    ranks, out = launches["cli"].result()
    for r, (rc, log) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{log[-4000:]}"
    [run] = list((out / "models").glob("*/*"))
    assert {"checkpoint-epoch1", "vocab.txt"} <= {p.name for p in run.iterdir()}
    snap = torch.load(run / "checkpoint-epoch1" / "state.pt", weights_only=True)
    qkv = snap["model"]["video_model.blocks.0.attn.qkv.weight"]
    assert tuple(qkv.shape) == (3 * 64, 64)
    [logs] = list((out / "log").glob("*/*"))
    for r in range(4):
        text = (logs / f"info_p{r}.log").read_text()
        assert "tensor parallel over a model axis of 2" in text
        assert f"rank {r % 2} of position {r // 2}" in text
