"""The port's train step against oatx, on the CPU: the bf16 step, the eval
step, the FLOP count and the options not ported yet (the f32 step:
test_torch_train.py; geometry in tests/torch_port_helpers.py, TRAIN_*)."""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from oatx.models import distilbert as jdb
from oatx.models import vit_spacetime as jvst
from oatx.train import step as jstep
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.train import flops as pflops
from oatx_torch.train import step as pstep
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


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_bf16_step_close_to_oatx(params, batch, fused_qkv):
    """bf16 compute, f32 master weights: the same casts, summation orders
    that differ, and under fused_qkv the same f32 qkv bias. The loss after
    two blocks differs by bf16 roundings (2^-8 each): held at 1 % (measured
    0.05 %); gradients by their cosine ≥ 0.99 per tensor and 2 % of the
    global norm (measured cosine ≥ 0.999)."""
    jcfg, pcfg = cfgs(fused_qkv, bf16=True)
    want_loss, want_g = oatx_loss_grads(params, jcfg, batch)
    want = state_dict_from_oatx(to_numpy(want_g), pcfg)
    step = pstep.make_train_step(pcfg, pstep.LossConfig(), device="cpu")
    state, m = step(port_state(params, pcfg), batch)
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-2)
    want_norm = float(np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values())))
    np.testing.assert_allclose(float(m["grad_norm"]), want_norm, rtol=2e-2)
    for n, p in state.model.named_parameters():
        w = want[n].flatten().double()
        g = p.grad.flatten().double()
        if w.norm() < 1e-6 * want_norm:  # zero in real arithmetic (k biases)
            continue
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.99, (n, cos)


def test_eval_step_matches_oatx(params):
    """make_eval_step: uint8 frames through the eval transform, then both
    towers, in sub-batches of 2 (scan_chunked), against oatx's eval step."""
    jcfg, pcfg = cfgs()
    rng = np.random.default_rng(9)
    batch = {"video": rng.integers(0, 256, (4, 2, 40, 40, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 100, (4, 5)).astype(np.int32)}
    want = jstep.make_eval_step(jcfg, chunk=2)(params, _jb(batch))
    model = port_state(params, pcfg).model
    got = pstep.make_eval_step(pcfg, chunk=2, device="cpu")(model, batch)
    for k in ("text_embeds", "video_embeds"):
        assert got[k].shape == (4, 16)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="chunk"):
        pstep.scan_chunked(lambda b: b, 3)({"x": torch.zeros(4)})


def test_unported_train_options_raise():
    """oatx's `mesh` and `manual_axes` have no counterpart: the process
    layout (parallel/mesh.py) takes their place, so passing them raises.
    `grad_reduce_dtype` is ported: it builds, and is unused on one process."""
    _, pcfg = cfgs()
    for kw in (dict(mesh=object()), dict(manual_axes=("data",))):
        with pytest.raises(TypeError):
            pstep.make_train_step(pcfg, pstep.LossConfig(), device="cpu", **kw)
    pstep.make_train_step(pcfg, pstep.LossConfig(), grad_reduce_dtype=torch.bfloat16,
                          device="cpu")
    # remat and fwd_chunk are ported (tests/test_torch_remat.py)
    remat = dataclasses.replace(pcfg, video=dataclasses.replace(pcfg.video, remat=True))
    pstep.make_train_step(remat, pstep.LossConfig(), fwd_chunk=2, device="cpu")
    # the object NCE terms are ported (tests/test_torch_object_tower.py)


def test_flops_copy_matches_bench():
    """The port's FLOP count is bench.py's, at the flagship geometry."""
    vcfg, tcfg = pvst.SpaceTimeViTConfig(num_frames=4), pdb.DistilBertConfig()
    want = bench.flops_forward_per_clip(jvst.SpaceTimeViTConfig(num_frames=4),
                                        jdb.DistilBertConfig(), 24)
    assert pflops.flops_forward_per_clip(vcfg, tcfg, 24) == want
