"""The port's Trainer (oatx_torch.train.trainer) against oatx's, on the CPU
in f32, on one device.

Both Trainers run the same experiment (tiny geometry: a 2-block ViT at 32²,
2 frames, a 2-layer DistilBERT, 16-d projections) on the same in-memory
dataset (tests/torch_port_helpers.py MemoryClips) through their own loader
stacks, from the same initial weights (a reference .pth that oatx exports and
both import): init_val, then 2 epochs of 2 steps (len_epoch) at batch 4,
validation and checkpoints after each. The two packages draw augmentations
from different generators, so both train through the eval transform here
(each Trainer's augment and train step rebuilt with it).

Tolerances: per-step losses and validation losses rtol 1e-4 (the f32 steps
of test_torch_train.py compound over 4 updates, under AdamW and each other
family of `optimizer.type`); retrieval metrics,
the monitor's decisions and the snapshots written are equal.
"""

import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from oatx.config.schema import ExperimentCfg as JExp
from oatx.config.schema import build_tower_config as jbuild
from oatx.data import loader as JL
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx.models import convert as jconvert
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx.train.trainer import Trainer as JTrainer
from oatx_torch.config.schema import ExperimentCfg as PExp
from oatx_torch.data import loader as PL
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.train import step as pstep
from oatx_torch.train.trainer import Trainer as PTrainer
from oatx_torch.utils.profiler import summarize_trace
from torch_port_helpers import MemoryClips, oatx_params

torch.set_num_threads(1)


def _raw(tmp_path, **trainer):
    return {
        "name": "tiny",
        "arch": {"type": "FrozenInTime", "args": {
            "video_params": {"model": "SpaceTimeTransformer",
                             "arch_config": "base_patch16_224", "num_frames": 2,
                             "input_res": 32, "embed_dim": 32, "depth": 2,
                             "num_heads": 2, "time_init": "random"},
            "text_params": {"model": "distilbert-base-uncased", "vocab_size": 100,
                            "dim": 32, "hidden_dim": 64, "n_layers": 2, "n_heads": 2},
            "projection": "minimal", "projection_dim": 16,
            "load_checkpoint": str(tmp_path / "init.pth")}},
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
        "loss": {"type": "NormSoftmaxLoss", "args": {}},
        "metrics": ["t2v_metrics", "v2t_metrics"],
        "trainer": {"epochs": 2, "len_epoch": 2, "save_period": 1, "verbosity": 0,
                    "init_val": True, "precision": "f32", "seed": 0,
                    "monitor": "min val_loss_0", **trainer},
    }


def _init_pth(tmp_path, raw):
    jcfg = jbuild(JExp.from_dict(raw).arch)
    jconvert.export_torch_checkpoint(str(tmp_path / "init.pth"), oatx_params(jcfg),
                                     jcfg.video)


def _loaders(ds, tok_cls, loader_mod):
    tok = tok_cls.build_from_corpus(ds.captions, vocab_size=100)
    col = loader_mod.Collator(tok, max_text_len=10)
    return ([loader_mod.ShardedLoader(ds, 4, col, seed=0, num_workers=2)],
            [loader_mod.ShardedLoader(ds, 8, col, shuffle=False, drop_last=False,
                                      num_workers=2)])


def _record_losses(trainer, out):
    step = trainer.train_step

    def recorded(state, batch):
        state, metrics = step(state, batch)
        out.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recorded


@pytest.fixture
def keep_sigterm():
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    yield
    for s, h in handlers.items():
        signal.signal(s, h)


@pytest.mark.parametrize("kind", ["AdamW", "Adafactor", "Lion", "SGD"])
def test_trainer_matches_oatx(tmp_path, keep_sigterm, kind):
    """Each optimizer family of `optimizer.type` (train/optim.py)."""
    raw = _raw(tmp_path)
    raw["optimizer"]["type"] = kind
    _init_pth(tmp_path, raw)
    ds = MemoryClips(n=16, frames=2, canon=32)
    runs = {}
    mesh = jmesh.make_mesh(n_devices=1)
    try:
        jexp = JExp.from_dict(raw)
        tl, vl = _loaders(ds, JTok, JL)
        jtr = JTrainer(jexp, tl, vl, save_dir=tmp_path / "oatx", mesh=mesh)
        jtr.augment = jstep.make_augmenter(train=False, tower_cfg=jtr.tower_cfg)
        jtr.train_step = jstep.make_train_step(jtr.tower_cfg, jtr.loss_cfg, jtr.optimizer,
                                               augment=jtr.augment,
                                               base_rng=jax.random.PRNGKey(1))
        jlosses = []
        _record_losses(jtr, jlosses)
        runs["oatx"] = (jtr.train(), jlosses, jtr)
    finally:
        jmesh.set_current_mesh(None)
    tl, vl = _loaders(ds, PTok, PL)
    ptr = PTrainer(PExp.from_dict(raw), tl, vl, save_dir=tmp_path / "port", device="cpu")
    ptr.augment = pstep.make_augmenter(train=False, tower_cfg=ptr.tower_cfg)
    ptr.train_step = pstep.make_train_step(ptr.tower_cfg, ptr.loss_cfg, augment=ptr.augment,
                                           device="cpu")
    plosses = []
    _record_losses(ptr, plosses)
    runs["port"] = (ptr.train(), plosses, ptr)

    (jh, jl, jtr), (ph, pl, ptr) = runs["oatx"], runs["port"]
    assert len(pl) == len(jl) == 4
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert sorted(ph) == sorted(jh) == [1, 2]
    for epoch in (1, 2):
        for k, v in jh[epoch].items():
            if k.startswith("loss_") or k.startswith("val_loss"):
                np.testing.assert_allclose(ph[epoch][k], v, rtol=1e-4, err_msg=k)
            elif k.startswith("val_"):
                assert ph[epoch][k] == v, (epoch, k)
        assert sorted(ph[epoch]) == sorted(jh[epoch])
    np.testing.assert_allclose(ptr.monitor_best, jtr.monitor_best, rtol=1e-4)
    assert ptr.not_improved == jtr.not_improved
    assert ptr.init_val_log and ptr.init_val_log["val_0_t2v_R1"] >= 0
    names = {d: sorted(os.listdir(tmp_path / d)) for d in ("oatx", "port")}
    assert names["port"] == names["oatx"]
    for name in names["port"]:
        if name.endswith(".meta.json"):
            got = json.loads((tmp_path / "port" / name).read_text())
            want = json.loads((tmp_path / "oatx" / name).read_text())
            assert sorted(got) == sorted(want)
            assert got["epoch"] == want["epoch"] and got["step"] == want["step"]


def _port_loaders():
    return _loaders(MemoryClips(n=16, frames=2, canon=48), PTok, PL)[0]


def test_sigterm_snapshot_resumes_mid_epoch_to_the_same_parameters(tmp_path, keep_sigterm):
    """Train-time augmentation on (the port's generator), 2 epochs of 3 steps;
    a SIGTERM after the 4th step snapshots mid-epoch, and the resumed run
    ends where the uninterrupted one does."""
    raw = _raw(tmp_path, len_epoch=3, init_val=False)
    _init_pth(tmp_path, raw)
    exp = PExp.from_dict(raw)
    full = PTrainer(exp, _port_loaders(), device="cpu")
    full.train()

    cut = PTrainer(exp, _port_loaders(), save_dir=tmp_path / "run", device="cpu")
    step, calls = cut.train_step, []

    def signalled(state, batch):
        out = step(state, batch)
        calls.append(1)
        if len(calls) == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    cut.train_step = signalled
    cut.train()
    assert len(calls) == 4
    meta = json.loads((tmp_path / "run" / "preempt-epoch2.meta.json").read_text())
    assert meta["cycles_done"] == 1 and meta["epoch"] == 2 and meta["step"] == 4

    resumed = PTrainer(exp, _port_loaders(), resume=str(tmp_path / "run" / "preempt-epoch2"),
                       device="cpu")
    assert (resumed.start_epoch, resumed._resume_cycle, resumed.state.step) == (2, 1, 4)
    resumed.train()
    assert resumed.state.step == full.state.step == 6
    for (n, p), q in zip(full.state.model.named_parameters(),
                         resumed.state.model.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("key,value", [("model_parallel", 2), ("fsdp", True),
                                       ("pipeline", True), ("dp_mode", "manual"),
                                       ("dcn_slices", 2)])
def test_multi_device_modes_raise(tmp_path, key, value):
    """The layouts one process cannot give raise: a model axis of 2,
    `dp_mode: manual` with one batch shard and `dcn_slices` that do not
    divide the processes raise oatx's ValueError (trainer.py:306-309,
    make_mesh). `fsdp` on one process shards over a 1-wide data axis, that
    is, replicates, as oatx's shard_params_fsdp does on a 1-device mesh, and
    `pipeline` on a model axis of 1 is one stage, as oatx's pipeline_stages
    = model_parallel = 1: each Trainer builds and holds the same parameters
    as one without the key."""
    raw = _raw(tmp_path, **{key: value})
    raw["arch"]["args"]["load_checkpoint"] = ""
    if key in ("fsdp", "pipeline"):
        got = PTrainer(PExp.from_dict(raw), [], device="cpu").state.model.state_dict()
        raw["trainer"][key] = False
        want = PTrainer(PExp.from_dict(raw), [], device="cpu").state.model.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        return
    if key in ("dp_mode", "dcn_slices", "model_parallel"):
        with pytest.raises(ValueError, match={
                "dp_mode": "dp_mode='manual'",
                "dcn_slices": "not divisible by model_parallel=1 x dcn_slices=2",
                "model_parallel": "not divisible by model_parallel=2 x dcn_slices=1"}[key]):
            PTrainer(PExp.from_dict(raw), [], device="cpu")
        return


@pytest.mark.parametrize("key,value,error", [
    ("fsdp", True, None), ("zero1", True, None), ("model_parallel", 2, None),
    pytest.param("pipeline", True, None, id="pipeline-True-A8b"),  # the case's name kept
    ("dcn_slices", 2, None), ("dcn_slices", 3, "dcn_slices=3"),
    ("dp_mode", "manual", None), (("fsdp", "dcn_slices"), (True, 2), None),
    (("pipeline", "fsdp"), (True, True), "pipeline and trainer.fsdp"),
    (("dp_mode", "fsdp"), ("manual", True), "dp_mode='manual'")])
def test_layout_checks_across_two_processes(tmp_path, key, value, error):
    """At a world of 2 the sharded modes, a model axis of 2 and pipeline on a
    model axis of 1 (one stage) run (fsdp also inside dcn slices); dcn
    slices must divide the world (oatx's make_mesh); dp_mode 'manual' is
    plain data parallelism; pipeline with fsdp and dp_mode 'manual' with
    fsdp raise ValueError with oatx's wording."""
    from oatx_torch.parallel import mesh as pmesh

    keys = dict(zip(key, value)) if isinstance(key, tuple) else {key: value}
    t = PExp.from_dict(_raw(tmp_path, **keys)).trainer
    if error is None:
        pmesh.check_layout(t, world=2)
        return
    with pytest.raises(ValueError, match=error):
        pmesh.check_layout(t, world=2)


def test_fwd_chunk_with_accum_steps_raises(tmp_path):
    raw = _raw(tmp_path, fwd_chunk=2, accum_steps=2)
    raw["arch"]["args"]["load_checkpoint"] = ""
    with pytest.raises(ValueError, match="mutually exclusive"):
        PTrainer(PExp.from_dict(raw), [], device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
def test_trainer_needs_a_card_unless_told_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PTrainer(PExp.from_dict(_raw(tmp_path)), [])


def test_profile_window_and_ema_validation(tmp_path, keep_sigterm, monkeypatch):
    """profile_epoch writes a torch.profiler trace of the window and logs its
    summarize_trace(top=5) rows as oatx's Trainer logs them; with an EMA
    kept, validation runs on the EMA parameters and the model gets its own
    back afterwards."""
    raw = _raw(tmp_path, len_epoch=3, epochs=1, init_val=False, ema_decay=0.5,
               profile_epoch=1, profile_start_step=1, profile_steps=1)
    raw["arch"]["args"]["load_checkpoint"] = ""
    ds = MemoryClips(n=16, frames=2, canon=48)
    tl, vl = _loaders(ds, PTok, PL)
    tr = PTrainer(PExp.from_dict(raw), tl, vl, log_dir=tmp_path / "log", device="cpu")
    seen = []
    validate = tr._validate

    def recording(epoch):
        seen.append({n: p.detach().clone() for n, p in tr.state.model.named_parameters()})
        return validate(epoch)

    tr._validate = recording
    logged = []
    info = tr.logger.info
    monkeypatch.setattr(tr.logger, "info", lambda msg, *a: (logged.append(msg % a), info(msg, *a)))
    hist = tr.train()
    assert (tmp_path / "log" / "profile" / "trace.json").is_file()
    rows = summarize_trace(str(tmp_path / "log" / "profile"), top=5)
    assert len(rows) == 5
    assert [m for m in logged if m.startswith("  trace: ")] == [
        f"  trace: {r['name'][:48]:<48} {r['total_ms']:9.2f} ms total" for r in rows]
    ema = tr.state.optimizer.named_state()["ema"]
    assert len(seen) == 1 and "val_loss_0" in hist[1]
    for n, p in tr.state.model.named_parameters():
        assert torch.equal(seen[0][n], ema[n]), n
    assert any(not torch.equal(p, ema[n]) for n, p in tr.state.model.named_parameters())
