"""oatx_torch's towers, eval transform and weight bridge against oatx on the
CPU, from numpy-seeded inputs and oatx-initialised params.

f32 towers agree at atol 1e-4 (1e-5 per op; twelve ops deep the summation
orders of XLA:CPU and torch drift apart by a few f32 ulps of O(1) values).
The port has one token order (CLS first, one stream); oatx's
`split_cls_stream` and `cls_position` are layout knobs whose outputs must not
change, so every oatx layout is held against the one port formulation.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.data import transforms as jtr
from oatx.models import convert as jconvert
from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx_torch import resolve_device
from oatx_torch.data import transforms as ptr
from oatx_torch.models import convert as pconvert
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from torch_port_helpers import oatx_cfg, oatx_params, port_cfg, port_model, t, \
    to_numpy

torch.set_num_threads(1)
ATOL = 1e-4
SMOKE_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "smoke",
                            "synthetic.json")
LAYOUTS = [dict(split_cls_stream=s, cls_position=c)
           for s in (False, True) for c in ("first", "last")]
LAYOUT_IDS = [f"split={d['split_cls_stream']}-cls={d['cls_position']}" for d in LAYOUTS]


@pytest.fixture(scope="module")
def params():
    return oatx_params(oatx_cfg())


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


def _video(seed, b=2, f=2, res=32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, f, res, res, 3)).astype(np.float32)


def _text(seed, b=3, length=7, vocab=100):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 4:] = 0
    mask[2, 2:] = 0
    return ids, mask


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("frames", [2, 1])  # F ≤ num_frames
def test_vit_spacetime_matches_oatx(params, model, layout, frames):
    cfg = oatx_cfg(**layout)
    x = _video(frames, f=frames)
    want = jvst.apply(params["video"], cfg.video, jnp.asarray(x))
    with torch.no_grad():
        got = model.video_model(t(x))
    for key in ("cls", "patches"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("frames", [2, 1])
def test_vit_spacetime_fused_qkv_matches_oatx(params, frames):
    """fused_qkv=True: each LN→qkv pair through kernel 3's Function, against
    oatx's ln_linear path (which runs its own CLS-first stream). Forward and
    the gradient of a scalar of it w.r.t. every tower parameter and the input,
    f32 at 1e-4 of each tensor's scale (gradients summed in other orders)."""
    cfg = oatx_cfg(fused_qkv=True)
    pc = port_cfg()
    pc = dataclasses.replace(pc, video=dataclasses.replace(pc.video, fused_qkv=True))
    model = port_model(params, pc).video_model
    x = _video(30 + frames, f=frames)
    proj = np.random.default_rng(3).standard_normal(64).astype(np.float32)

    def scalar(p, v):
        out = jvst.apply(p, cfg.video, v)
        return jnp.sum(out["cls"] @ proj) + jnp.mean(out["patches"] ** 2), out

    (_, want), (gp, gx) = jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True)(
        params["video"], jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = model(xt)
    for key in ("cls", "patches"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    (torch.sum(got["cls"] @ t(proj)) + got["patches"].square().mean()).backward()
    grads = pconvert.state_dict_from_oatx(to_numpy({"video": gp, "text": params["text"]}), pc)
    checked = 0
    for name, prm in model.named_parameters():
        w = grads["video_model." + name].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), w, rtol=0,
                                   atol=ATOL * max(np.abs(w).max(), 1e-3), err_msg=name)
        checked += 1
    assert checked == len(list(model.parameters()))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=ATOL * np.abs(np.asarray(gx)).max())


def test_vit_spacetime_cls_mean_half_pooling(params):
    cfg = oatx_cfg(pooling="cls_mean_half")
    pc = port_cfg()
    pc = dataclasses.replace(pc, video=dataclasses.replace(pc.video, pooling="cls_mean_half"))
    model = port_model(params, pc)
    x = _video(7)
    want = jvst.apply(params["video"], cfg.video, jnp.asarray(x))["cls"]
    with torch.no_grad():
        got = model.video_model(t(x))["cls"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_distilbert_matches_oatx(params, model, masked):
    cfg = oatx_cfg()
    ids, mask = _text(11)
    jmask = jnp.asarray(mask) if masked else None
    want = jdb.apply(params["text"], cfg.text, jnp.asarray(ids), jmask)
    with torch.no_grad():
        got = model.text_model(t(ids), t(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [(40, 32), (64, 32), (20, 32)])
def test_eval_transform_matches_oatx(src, dst):
    """uint8 → bilinear (half-pixel centres, no antialias) → normalize, both
    down- and up-sampling; F.interpolate and jax.image.resize agree at the
    borders too."""
    u8 = np.random.default_rng(src).integers(0, 256, (2, 3, src, src, 3), dtype=np.uint8)
    want = jtr.eval_transform(jnp.asarray(u8), jtr.TransformConfig(input_res=dst))
    got = ptr.eval_transform(t(u8), ptr.TransformConfig(input_res=dst))
    assert got.shape == (2, 3, dst, dst, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_slice_video_uint8_to_embedding(params, model, layout):
    """The whole video side of the slice: uint8 frames → eval transform →
    ViT → vid_proj, oatx (every layout) vs the port."""
    cfg = oatx_cfg(**layout)
    u8 = np.random.default_rng(4).integers(0, 256, (2, 2, 40, 40, 3), dtype=np.uint8)
    x = jtr.eval_transform(jnp.asarray(u8), jtr.TransformConfig(input_res=32))
    want = jtowers.compute_video(params, cfg, x)["cls"]
    with torch.no_grad():
        got = model.compute_video(ptr.eval_transform(t(u8), ptr.TransformConfig(input_res=32)))
    assert got["cls"].shape == (2, 32) and got["cls"].dtype == torch.float32
    np.testing.assert_allclose(got["cls"].numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_slice_text_ids_to_embedding(params, model):
    cfg = oatx_cfg()
    ids, mask = _text(12)
    want = jtowers.compute_text(params, cfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model.compute_text(t(ids), t(mask))
    assert got.shape == (3, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [False, True])
def test_video_tower_bf16_close_to_oatx(params, model, split):
    """bf16 compute: the same casts, different summation orders, and one
    deliberate difference. oatx's split stream runs the CLS row through plain
    `mlp`, which adds the fc biases in bf16 (oatx/ops/layers.py:29-33), while
    the port's single stream sends it through kernel 1's version, which adds
    them in f32 (oatx/ops/pallas/ln_mlp.py:134-135): one extra bf16 rounding
    per bias. Both effects are a few bf16 ulps (2^-8 relative) per block; two
    blocks deep they measured 0.7 % of the output's scale, held at 2 %."""
    cfg = dataclasses.replace(oatx_cfg(split_cls_stream=split, cls_position="first"),
                              compute_dtype=jnp.bfloat16)
    pc = dataclasses.replace(port_cfg(), compute_dtype=torch.bfloat16)
    m = port_model(params, pc)
    x = _video(21)
    want = np.asarray(jtowers.compute_video(params, cfg, jnp.asarray(x))["cls"], np.float32)
    with torch.no_grad():
        got = m.compute_video(t(x))["cls"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.02 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------- bridge

def test_state_dict_from_oatx_equals_oatx_export(params):
    cfg = oatx_cfg()
    want = jconvert.frozen_in_time_to_torch(params, cfg.video, text_family="distilbert")
    got = pconvert.state_dict_from_oatx(to_numpy(params), port_cfg())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    m = ptowers.DualTower(port_cfg(), device="cpu")
    m.load_state_dict(got, strict=True)
    assert sorted(m.state_dict()) == sorted(want)  # the reference schema, exactly


def test_pth_from_export_torch_checkpoint_loads(params, model, tmp_path):
    path = str(tmp_path / "ckpt.pth")
    jconvert.export_torch_checkpoint(path, params, oatx_cfg().video, epoch=3)
    m = ptowers.DualTower(port_cfg(), device="cpu",
                          generator=torch.Generator().manual_seed(123))
    pconvert.load_checkpoint(m, path)
    for k, v in model.state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k
    # DataParallel-prefixed keys load too; a wrong geometry fails the strict load
    sd = torch.load(path, weights_only=True)["state_dict"]
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 0}, path)
    pconvert.load_checkpoint(m, path)
    other = dataclasses.replace(port_cfg(), projection_dim=16)
    with pytest.raises(RuntimeError):
        pconvert.load_checkpoint(ptowers.DualTower(other, device="cpu"), path)


def test_time_attention_zero_init():
    """time_init='zeros': qkv weight and bias 0, proj weight 1, proj bias 0
    (oatx vit_spacetime.py:110-118)."""
    cfg = pvst.SpaceTimeViTConfig(img_size=32, embed_dim=16, depth=1, num_heads=2,
                                  num_frames=2, time_init="zeros")
    blk = pvst.SpaceTimeTransformer(cfg, "cpu").blocks[0]
    ta = blk.timeattn
    assert not ta.qkv.weight.any() and not ta.qkv.bias.any() and not ta.proj.bias.any()
    assert bool((ta.proj.weight == 1).all())
    assert blk.attn.qkv.weight.any()
    jp = jvst.init(jax.random.PRNGKey(0), jvst.SpaceTimeViTConfig(
        img_size=32, embed_dim=16, depth=1, num_heads=2, num_frames=2, time_init="zeros"))
    np.testing.assert_array_equal(np.asarray(jp["blocks"]["timeattn"]["proj"]["kernel"]),
                                  np.ones((1, 16, 16), np.float32))


def test_init_is_seeded():
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = ptowers.DualTower(port_cfg(), "cpu", g()).state_dict()
    b = ptowers.DualTower(port_cfg(), "cpu", g()).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("change", [
    dict(video=dict(remat=True)), dict(video=dict(scan_blocks=True)),
    dict(video=dict(pipeline_stages=2)), dict(video=dict(sequence_parallel=True)),
    dict(video=dict(region_tap_layer=1)),
    dict(video=dict(fused_mlp=False)), dict(variant="global_local"),
    dict(text_family="bert"),
])
def test_unported_options_raise(change):
    cfg = port_cfg()
    if "video" in change:
        cfg = dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, **change["video"]))
    else:
        cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(NotImplementedError):
        ptowers.DualTower(cfg, device="cpu")


def test_entry_points_need_cuda_unless_given_cpu(monkeypatch):
    """Without a card and without device='cpu' every entry point raises; it
    never drops to the CPU on its own."""
    from oatx_torch.cli import serve as pserve
    from oatx_torch.serve.embed_service import EmbedService
    from oatx_torch.serve.retrieval_index import RetrievalIndex
    from oatx_torch.train import optim as poptim
    from oatx_torch.train import step as pstep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptowers.DualTower(port_cfg())
    model = ptowers.DualTower(port_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbedService(model, port_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalIndex(np.ones((2, 4), np.float32), ["a", "b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.build_service(["-c", SMOKE_CONFIG])
    with pytest.raises(RuntimeError, match="CUDA"):
        pstep.init_state(port_cfg(), poptim.make_optimizer())
    with pytest.raises(RuntimeError, match="CUDA"):
        pstep.make_train_step(port_cfg(), pstep.LossConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        pstep.make_eval_step(port_cfg())
    state = pstep.init_state(port_cfg(), poptim.make_optimizer(), device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    assert callable(pstep.make_train_step(port_cfg(), pstep.LossConfig(), device="cpu"))
    assert EmbedService(model, port_cfg(), device="cpu").device.type == "cpu"
    assert RetrievalIndex(np.ones((2, 4), np.float32), ["a", "b"],
                          device="cpu").device.type == "cpu"
