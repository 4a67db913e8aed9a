"""Remat, scanned blocks and fwd_chunk in the port's train step against
oatx's, and the positional-embedding inflation, on the CPU in f32.

Tiny train geometry (tests/torch_port_helpers.py, TRAIN_*): 2 blocks at 32²,
batch 4. Tolerances:
  * the port with remat (each policy, or scan_blocks) against the port
    without: 1e-6 of each tensor's largest gradient entry (the recompute runs
    the same ops on the same inputs; measured bitwise on the CPU);
  * against oatx's remat step and oatx's loss_fn(fwd_chunk=2): loss rtol
    2e-6, gradients 1e-4 of each tensor's largest entry plus 1e-7 (the
    bound of test_torch_train.py; the products sum in another order);
  * inflation: 1e-6 absolute (interpolation weights in f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.models import vit_spacetime as jvst
from oatx.train import step as jstep
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.train import step as pstep
from torch_port_helpers import jax_batch, oatx_loss_grads, oatx_params, to_numpy, \
    train_batch, train_cfgs, train_port_state

torch.set_num_threads(1)

POLICIES = ("full", "dots", "dots_all")


@pytest.fixture(scope="module")
def params():
    return oatx_params(train_cfgs()[0])


@pytest.fixture(scope="module")
def batch():
    return train_batch()


def _with_video(cfg, **kw):
    return dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, **kw))


def _port_grads(params, pcfg, batch, fwd_chunk=None):
    state = train_port_state(params, pcfg)
    loss, _ = pstep.loss_fn(state.model, pstep.LossConfig(),
                            pstep._to_device(batch, torch.device("cpu")), fwd_chunk)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in state.model.named_parameters()}


def _assert_close(got, want, scale, floor=0.0):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0,
                                   atol=scale * np.abs(w).max() + floor, err_msg=n)


@pytest.fixture(scope="module")
def plain_grads(params, batch):
    return {fq: _port_grads(params, train_cfgs(fused_qkv=fq)[1], batch)
            for fq in (False, True)}


@pytest.mark.parametrize("fused_qkv", [False, True])
@pytest.mark.parametrize("setting", POLICIES + ("scan_blocks",))
def test_remat_gradients_equal_the_port_without_remat(params, batch, plain_grads,
                                                      setting, fused_qkv):
    _, pcfg = train_cfgs(fused_qkv=fused_qkv)
    kw = (dict(scan_blocks=True) if setting == "scan_blocks"
          else dict(remat=True, remat_policy=setting))
    loss, got = _port_grads(params, _with_video(pcfg, **kw), batch)
    want_loss, want = plain_grads[fused_qkv]
    assert loss == want_loss
    _assert_close(got, want, 1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_matches_oatx_remat(params, batch, policy):
    jcfg, pcfg = train_cfgs()
    jcfg = _with_video(jcfg, remat=True, remat_policy=policy)
    want_loss, want = oatx_loss_grads(params, jcfg, batch)
    loss, got = _port_grads(params, _with_video(pcfg, remat=True, remat_policy=policy), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-6)
    _assert_close(got, state_dict_from_oatx(to_numpy(want), pcfg), 1e-4, 1e-7)


def test_selective_policies_keep_the_products(params, batch, monkeypatch):
    """'dots' keeps the 2-D weight products' outputs, 'dots_all' also the
    batched ones; 'full' keeps none (the policy sees the recompute as well)."""
    kept = {}

    def counting(saved, ctx, op, *args, **kwargs):
        decision = real(saved, ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and \
                not ctx.is_recompute:
            kept[op.overloadpacket.__name__] = kept.get(op.overloadpacket.__name__, 0) + 1
        return decision

    real = pvst._save_products
    monkeypatch.setattr(pvst, "_save_products", counting)
    _, pcfg = train_cfgs()
    counts = {}
    for policy in ("dots", "dots_all"):
        kept.clear()
        _port_grads(params, _with_video(pcfg, remat=True, remat_policy=policy), batch)
        counts[policy] = dict(kept)
    assert counts["dots"].get("mm", 0) > 0 and "bmm" not in counts["dots"]
    assert counts["dots_all"].get("bmm", 0) > 0
    assert counts["dots_all"]["mm"] == counts["dots"]["mm"]
    with pytest.raises(ValueError, match="remat_policy"):
        pvst.SpaceTimeTransformer(_with_video(pcfg, remat=True, remat_policy="most").video,
                                  device="cpu")


def test_fwd_chunk_matches_oatx(params, batch):
    jcfg, pcfg = train_cfgs()
    f = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True), static_argnums=(1, 2, 4))
    (want_loss, _), want = f(params, jcfg, jstep.LossConfig(), jax_batch(batch), 2)
    loss, got = _port_grads(params, pcfg, batch, fwd_chunk=2)
    np.testing.assert_allclose(loss, float(want_loss), rtol=2e-6)
    _assert_close(got, state_dict_from_oatx(to_numpy(want), pcfg), 1e-4, 1e-7)
    # the full-batch loss: the same value as without chunks
    plain_loss, _ = _port_grads(params, pcfg, batch)
    np.testing.assert_allclose(loss, plain_loss, rtol=2e-6)


def test_fwd_chunk_with_remat_in_the_train_step(params, batch, plain_grads):
    """fwd_chunk nested around per-block remat, through make_train_step."""
    _, pcfg = train_cfgs()
    pcfg = _with_video(pcfg, remat=True)
    state = train_port_state(params, pcfg)
    step = pstep.make_train_step(pcfg, pstep.LossConfig(), fwd_chunk=2, device="cpu")
    state, metrics = step(state, batch)
    assert state.step == 1
    want_loss, want = plain_grads[False]
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=2e-6)
    _assert_close({n: p.grad for n, p in state.model.named_parameters()}, want, 1e-6)


def test_fwd_chunk_must_divide_the_batch(params, batch):
    jcfg, pcfg = train_cfgs()
    with pytest.raises(ValueError, match="not divisible"):
        jstep.loss_fn(params, jcfg, jstep.LossConfig(), jax_batch(batch), fwd_chunk=3)
    with pytest.raises(ValueError, match="not divisible"):
        _port_grads(params, pcfg, batch, fwd_chunk=3)


@pytest.mark.parametrize("target", [1, 4, 16])
def test_inflate_spatial_embed_matches_oatx(target):
    pos = np.random.default_rng(0).standard_normal((1, 1 + 4, 8)).astype(np.float32)
    want = np.asarray(jvst.inflate_spatial_embed(jnp.asarray(pos), target))
    got = pvst.inflate_spatial_embed(torch.from_numpy(pos), target).numpy()
    assert got.shape == want.shape == (1, 1 + target, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inflate_spatial_embed_shrinks_like_oatx():
    pos = np.random.default_rng(1).standard_normal((1, 1 + 36, 8)).astype(np.float32)
    want = np.asarray(jvst.inflate_spatial_embed(jnp.asarray(pos), 9))
    got = pvst.inflate_spatial_embed(torch.from_numpy(pos), 9).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["zeros", "interp", "bilinear"])
@pytest.mark.parametrize("target", [2, 4, 8])
def test_inflate_temporal_embed_matches_oatx(mode, target):
    te = np.random.default_rng(2).standard_normal((1, 4, 8)).astype(np.float32)
    want = np.asarray(jvst.inflate_temporal_embed(jnp.asarray(te), target, mode))
    got = pvst.inflate_temporal_embed(torch.from_numpy(te), target, mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
