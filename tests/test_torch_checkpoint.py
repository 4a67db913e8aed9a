"""The port's checkpoints (oatx_torch.train.checkpoint): a save restores
bitwise, keep-GC and the metadata follow oatx's layout, an async save holds
the state of the moment it was called, and importing a reference .pth with
another frame or patch count inflates the embeddings as oatx does."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from oatx.models import convert as jconvert
from oatx.train import checkpoint as jckpt
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.models.towers import DualTower
from oatx_torch.train import checkpoint as pckpt
from oatx_torch.train import step as pstep
from torch_port_helpers import oatx_params, to_numpy, train_batch, train_cfgs, \
    train_port_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return oatx_params(train_cfgs()[0])


def _trained(params, steps=2, **opt_kw):
    _, pcfg = train_cfgs()
    state = train_port_state(params, pcfg, **opt_kw)
    step = pstep.make_train_step(pcfg, pstep.LossConfig(), device="cpu")
    for _ in range(steps):
        state, _ = step(state, train_batch())
    return state, step


def _flat(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.named_state()
    out["count"] = torch.tensor(opt.pop("count"))
    for key, tree in opt.items():
        out.update({f"{key}.{k}": v for k, v in tree.items()})
    return out


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step


def test_save_then_restore_is_bitwise(params, tmp_path):
    state, _ = _trained(params, ema_decay=0.9)
    path = pckpt.save_checkpoint(tmp_path, "checkpoint-epoch3", state, 3, 0.25,
                                 extra_meta={"cycles_done": 5})
    meta = json.loads((tmp_path / "checkpoint-epoch3.meta.json").read_text())
    assert meta == {"epoch": 3, "monitor_best": 0.25, "step": 2, "cycles_done": 5}
    fresh = train_port_state(oatx_params(train_cfgs()[0], seed=9), train_cfgs()[1],
                             ema_decay=0.9)
    restored, rmeta = pckpt.restore_checkpoint(path, fresh, device="cpu")
    _assert_bitwise(restored, state)
    assert {k: rmeta[k] for k in meta} == meta and rmeta["has_meta"]


def test_keep_gc_leaves_the_newest(params, tmp_path):
    state, _ = _trained(params, steps=1)
    (tmp_path / "checkpoint-epoch0.meta.json").write_text("{}")  # an orphaned sidecar
    for epoch in range(1, 6):
        pckpt.save_checkpoint(tmp_path, f"checkpoint-epoch{epoch}", state, epoch, 1.0, keep=3)
    pckpt.save_checkpoint(tmp_path, "model_best", state, 5, 1.0)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"checkpoint-epoch{e}{s}" for e in (3, 4, 5) for s in ("", ".meta.json")]
        + ["model_best", "model_best.meta.json"])


def test_async_save_keeps_the_values_of_its_moment(params, tmp_path):
    state, step = _trained(params, steps=1)
    before = {k: v.clone() for k, v in _flat(state).items()}
    pckpt.save_checkpoint(tmp_path, "checkpoint-epoch1", state, 1, 1.0, async_save=True)
    state, _ = step(state, train_batch(seed=1))  # AdamW updates in place
    assert not torch.equal(_flat(state)["model.vid_proj.0.weight"],
                           before["model.vid_proj.0.weight"])
    pckpt.wait_for_async_saves()
    snap = torch.load(tmp_path / "checkpoint-epoch1" / pckpt.STATE_FILE, weights_only=True)
    for k, v in snap["model"].items():
        assert torch.equal(v, before[f"model.{k}"]), k
    for key in ("mu", "nu"):
        for k, v in snap["optimizer"][key].items():
            assert torch.equal(v, before[f"{key}.{k}"]), (key, k)
    assert snap["step"] == 1 and snap["optimizer"]["count"] == 1


@pytest.mark.parametrize("temporal_fix", ["zeros", "interp", "bilinear"])
def test_import_of_another_frame_count_inflates_like_oatx(tmp_path, temporal_fix):
    """A 2-frame reference .pth into 4-frame towers; and a 16² grid into 32²."""
    jcfg2, pcfg2 = train_cfgs()
    src = oatx_params(jcfg2, seed=3)
    path = str(tmp_path / "ref.pth")
    jconvert.export_torch_checkpoint(path, src, jcfg2.video)
    for kw in (dict(num_frames=4), dict(num_frames=4, img_size=64)):
        jcfg = dataclasses.replace(jcfg2, video=dataclasses.replace(jcfg2.video, **kw))
        pcfg = dataclasses.replace(pcfg2, video=dataclasses.replace(pcfg2.video, **kw))
        want = jckpt.import_initial_weights(path, jcfg, oatx_params(jcfg, seed=4),
                                            temporal_fix=temporal_fix)
        model = DualTower(pcfg, device="cpu")
        pckpt.import_initial_weights(path, model, temporal_fix=temporal_fix)
        want_sd = state_dict_from_oatx(to_numpy(want), pcfg)
        got_sd = model.state_dict()
        assert got_sd["video_model.temporal_embed"].shape[1] == 4
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_import_from_a_port_snapshot_and_its_ema(params, tmp_path):
    state, _ = _trained(params, ema_decay=0.5)
    pckpt.save_checkpoint(tmp_path, "model_best", state, 1, 1.0)
    for ema in (False, True):
        model = DualTower(train_cfgs()[1], device="cpu")
        pckpt.import_initial_weights(str(tmp_path / "model_best"), model, prefer_ema=ema)
        want = (state.optimizer.named_state()["ema"] if ema
                else dict(state.model.named_parameters()))
        for n, p in model.named_parameters():
            assert torch.equal(p, want[n]), n
    with pytest.raises(FileNotFoundError):
        pckpt.import_initial_weights(str(tmp_path / "missing"), model)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
def test_restore_needs_a_card_unless_told_cpu(params, tmp_path):
    state, _ = _trained(params, steps=1)
    path = pckpt.save_checkpoint(tmp_path, "checkpoint-epoch1", state, 1, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pckpt.restore_checkpoint(path, state)
