"""The port's train step (oatx_torch.train) against oatx.train.step, on the
CPU, in f32 (bf16, eval and options: test_torch_train_eval.py).

Tiny geometry (tests/torch_port_helpers.py, TRAIN_*): a 2-block ViT (D 32,
2 heads, 2 frames at 32²), a 2-layer DistilBERT (D 32), 16-d projections,
batch 4, numpy-seeded inputs and oatx params carried over by the state_dict
bridge.

Tolerances, f32 unless named:
  * loss: rtol 2e-6 at step 1 (summation order; measured 8.6e-7);
  * gradients: 1e-4 of each tensor's largest entry plus 1e-7 absolute, the
    latter for gradients that are exactly zero in real arithmetic (the k
    biases of attention; measured ~1.6e-9), measured ≤ 2e-6 of the max; the
    AdamW moments after one step (0.1·g and 0.001·g²) scale the same way;
  * later steps: AdamW's m/√v turns summation-order noise in near-zero
    gradients into updates of ±lr, so step 2-3 losses agree only to
    rtol 1e-5 (measured 2e-6) and no parameter is held after the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.train import optim as joptim
from oatx.train import step as jstep
from oatx_torch.models.convert import opt_state_from_optax, state_dict_from_oatx
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep
from torch_port_helpers import TRAIN_LR as LR
from torch_port_helpers import jax_batch as _jb
from torch_port_helpers import oatx_loss_grads, oatx_params, to_numpy, train_batch, \
    train_cfgs as cfgs, train_port_state as port_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return oatx_params(cfgs()[0])


@pytest.fixture(scope="module")
def batch():
    return train_batch()


def _assert_grads(model, want_sd, scale=1e-4, floor=1e-7):
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want_sd)
    for n, p in model.named_parameters():
        assert p.grad is not None, n
        w = want_sd[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=scale * np.abs(w).max() + floor, err_msg=n)

@pytest.mark.parametrize("fused_qkv", [False, True])
def test_step1_loss_and_every_gradient_match_oatx(params, batch, fused_qkv):
    jcfg, pcfg = cfgs(fused_qkv)
    want_loss, want_g = oatx_loss_grads(params, jcfg, batch)
    state = port_state(params, pcfg)
    step = pstep.make_train_step(pcfg, pstep.LossConfig(), device="cpu")
    state, metrics = step(state, batch)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=2e-6)
    # .grad holds the step's gradients until the next step clears them
    _assert_grads(state.model, state_dict_from_oatx(to_numpy(want_g), pcfg))
    want_norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(want_g))))
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_three_steps_and_carried_optax_state_match_oatx(params, batch, fused_qkv):
    """Three AdamW steps (with a parameter EMA) from the same weights; and the
    port continuing from oatx's state after step 1 (params through the
    bridge, moments/count/EMA through opt_state_from_optax)."""
    jcfg, pcfg = cfgs(fused_qkv)
    tx = joptim.make_optimizer(lr=LR, ema_decay=0.99)
    jst = jstep.init_state(None, jcfg, tx, params=params)
    jtrain = jstep.make_train_step(jcfg, jstep.LossConfig(), tx, donate=False)
    jlosses, jstates = [], []
    for _ in range(3):
        jst, m = jtrain(jst, _jb(batch))
        jlosses.append(float(m["loss"]))
        jstates.append(jst)

    step = pstep.make_train_step(pcfg, pstep.LossConfig(), device="cpu")
    state = port_state(params, pcfg, ema_decay=0.99)
    losses = []
    for i in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:  # moments after one update: the gradients' f32 tolerance
            carried = opt_state_from_optax(jstates[0].opt_state, pcfg)
            mine = state.optimizer.named_state()
            assert carried["count"] == mine["count"] == 1
            for key, scale, floor in (("mu", 1e-4, 1e-8), ("nu", 2e-4, 1e-16)):
                for n, w in carried[key].items():
                    np.testing.assert_allclose(mine[key][n].numpy(), w.numpy(), rtol=0,
                                               atol=scale * np.abs(w.numpy()).max() + floor,
                                               err_msg=f"{key} {n}")
            assert sorted(carried["ema"]) == sorted(mine["ema"])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] < losses[0]

    cont = pstep.init_state(pcfg, poptim.make_optimizer(lr=LR, ema_decay=0.99), device="cpu",
                            state_dict=state_dict_from_oatx(to_numpy(jstates[0].params), pcfg))
    cont.optimizer.load_named_state(opt_state_from_optax(jstates[0].opt_state, pcfg))
    cont = cont._replace(step=1)
    cont_losses = []
    for _ in range(2):
        cont, m = step(cont, batch)
        cont_losses.append(float(m["loss"]))
    assert cont.step == 3 and cont.optimizer.named_state()["count"] == 3
    np.testing.assert_allclose(cont_losses, jlosses[1:], rtol=1e-5)


def test_accum_steps_match_oatx(params, batch):
    """accum_steps=2: micro-batch negatives, gradients averaged; the loss
    metric is the micro-batch mean."""
    jcfg, pcfg = cfgs()
    tx = joptim.make_optimizer(lr=LR)
    jtrain = jstep.make_train_step(jcfg, jstep.LossConfig(), tx, donate=False, accum_steps=2)
    _, jm = jtrain(jstep.init_state(None, jcfg, tx, params=params), _jb(batch))
    step = pstep.make_train_step(pcfg, pstep.LossConfig(), accum_steps=2, device="cpu")
    state, m = step(port_state(params, pcfg), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    bad = dict(batch, video=batch["video"][:3], input_ids=batch["input_ids"][:3],
               attention_mask=batch["attention_mask"][:3])
    with pytest.raises(ValueError, match="accum_steps"):
        step(state, bad)


def test_skip_nonfinite_leaves_everything_as_it_was(params, batch):
    """A batch with a NaN: oatx and the port both report skipped = 1; in the
    port params, moments and the step count are bit for bit unchanged."""
    jcfg, pcfg = cfgs()
    nan_batch = dict(batch, video=batch["video"].copy())
    nan_batch["video"][0, 0, 0, 0, 0] = np.nan
    tx = joptim.make_optimizer(lr=LR)
    jtrain = jstep.make_train_step(jcfg, jstep.LossConfig(), tx, donate=False,
                                   skip_nonfinite=True)
    _, jm = jtrain(jstep.init_state(None, jcfg, tx, params=params), _jb(nan_batch))
    step = pstep.make_train_step(pcfg, pstep.LossConfig(), skip_nonfinite=True, device="cpu")
    state, m = step(port_state(params, pcfg), batch)  # one good step first
    assert float(m["skipped"]) == 0.0 and state.step == 1
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
               for k, v in state.optimizer.named_state().items()}
    after, m = step(state, nan_batch)
    assert float(jm["skipped"]) == float(m["skipped"]) == 1.0
    assert float(m["loss"]) == float(jm["loss"]) == 0.0
    assert float(m["grad_norm"]) == float(jm["grad_norm"]) == 0.0
    assert after.step == 1
    assert all(torch.equal(v, before[k]) for k, v in after.model.state_dict().items())
    now = after.optimizer.named_state()
    assert now["count"] == moments["count"] == 1
    for key in ("mu", "nu"):
        assert all(torch.equal(now[key][n], t) for n, t in moments[key].items())


