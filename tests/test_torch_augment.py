"""The port's device-side train augmentation against oatx's
(oatx/data/transforms.py), on the CPU in f32.

The two packages draw from different generators (a torch.Generator, a JAX
key), so:
  * given the same crop boxes, flip mask and jitter factors, each stage
    equals oatx's to 1e-6 absolute (f32 interpolation and YIQ products);
  * the random draws are checked for distribution over 2000 clips: every
    crop's scale and aspect ratio inside randcrop_scale / randcrop_ratio,
    and flips at 50 ± 5 %;
  * train_augment is a function of its generator's seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.data import transforms as JT
from oatx.train import step as jstep
from oatx_torch.data import transforms as PT
from oatx_torch.train import step as pstep

torch.set_num_threads(1)


def _boxes(rng, b, h, w):
    ch = rng.uniform(8, h, b).astype(np.float32)
    cw = rng.uniform(8, w, b).astype(np.float32)
    y0 = (rng.random(b) * (h - ch)).astype(np.float32)
    x0 = (rng.random(b) * (w - cw)).astype(np.float32)
    return y0, x0, ch, cw


@pytest.mark.parametrize("out", [16, 56])
def test_crop_resize_matches_oatx_given_the_boxes(out):
    rng = np.random.default_rng(0)
    video = rng.random((3, 2, 40, 36, 3)).astype(np.float32)
    boxes = _boxes(rng, 3, 40, 36)
    want = jax.vmap(lambda c, a, b, ch, cw: JT._bilinear_crop_resize(c, a, b, ch, cw, out))(
        jnp.asarray(video), *map(jnp.asarray, boxes))
    got = PT.crop_resize(torch.from_numpy(video), *map(torch.from_numpy, boxes), out)
    assert got.shape == (3, 2, out, out, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_flip_jitter_normalize_match_oatx_given_the_draws():
    rng = np.random.default_rng(1)
    video = rng.random((6, 2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    flip = np.array(jax.random.bernoulli(key, 0.5, (6,)))
    want = JT.random_hflip(key, jnp.asarray(video))
    got = PT.hflip(torch.from_numpy(video), torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    cfg = JT.TransformConfig(color_jitter=(0.4, 0.3, 0.1))
    kb, ks, kh = jax.random.split(key, 3)
    shape = (6, 1, 1, 1, 1)
    fb = jax.random.uniform(kb, shape, minval=0.6, maxval=1.4)
    fs = jax.random.uniform(ks, shape, minval=0.7, maxval=1.3)
    th = jax.random.uniform(kh, (6, 1, 1, 1), minval=-0.1, maxval=0.1) * 2 * np.pi
    want = JT.color_jitter(key, jnp.asarray(video), cfg)
    got = PT.jitter(torch.from_numpy(video), *(torch.from_numpy(np.asarray(a).reshape(6))
                                               for a in (fb, fs, th)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert not np.allclose(got.numpy(), video)
    np.testing.assert_allclose(PT.normalize(got).numpy(),
                               np.asarray(JT.normalize(want)), rtol=0, atol=1e-6)


def test_jitter_is_the_identity_at_the_reference_default():
    x = torch.rand(2, 1, 4, 4, 3)
    assert PT.color_jitter(torch.Generator().manual_seed(0), x, PT.TransformConfig()) is x


def test_train_augment_is_a_function_of_the_seed():
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 2, 64, 64, 3),
                                                            dtype=np.uint8))
    cfg = PT.TransformConfig(input_res=32, color_jitter=(0.2, 0.2, 0.05))

    def run(seed):
        return PT.train_augment(torch.Generator().manual_seed(seed), u8, cfg)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (4, 2, 32, 32, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert torch.isfinite(a).all()
    # frames of one clip share their crop and flip (identical frames stay equal)
    same = u8[:, :1].expand(4, 2, 64, 64, 3).contiguous()
    out = PT.train_augment(torch.Generator().manual_seed(3), same, cfg)
    assert torch.equal(out[:, 0], out[:, 1])


def test_crop_and_flip_draws_follow_the_configured_distribution():
    cfg = PT.TransformConfig()
    gen = torch.Generator().manual_seed(0)
    n, h, w = 2000, 256, 256
    y0, x0, ch, cw = PT.crop_boxes(gen, n, h, w, cfg)
    scale, ratio = (ch * cw / (h * w)).numpy(), (cw / ch).numpy()
    eps = 1e-5
    assert scale.min() >= cfg.randcrop_scale[0] - eps and scale.max() <= 1 + eps
    assert ratio.min() >= cfg.randcrop_ratio[0] - eps
    assert ratio.max() <= cfg.randcrop_ratio[1] + eps
    assert scale.min() < 0.52 and scale.max() > 0.95  # the whole range is drawn
    assert (y0 >= 0).all() and (y0 + ch <= h + eps).all()
    assert (x0 >= 0).all() and (x0 + cw <= w + eps).all()
    ones = torch.ones(n, 1, 1, 2, 1)
    ones[..., 1, :] = 0
    flipped = PT.random_hflip(gen, ones)[:, 0, 0, 0, 0] == 0
    assert 0.45 <= float(flipped.float().mean()) <= 0.55


def test_make_augmenter_matches_oatx_eval_and_touches_uint8_only():
    """eval augmenter: the same output as oatx's; float frames pass through."""
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (2, 2, 40, 40, 3), dtype=np.uint8)
    jaug = jstep.make_augmenter(JT.TransformConfig(input_res=32, center_crop=40), train=False)
    paug = pstep.make_augmenter(PT.TransformConfig(input_res=32, center_crop=40), train=False)
    want = jaug(jax.random.PRNGKey(0), {"video": jnp.asarray(u8)})["video"]
    got = paug(torch.Generator(), {"video": torch.from_numpy(u8)})["video"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    f = torch.rand(2, 2, 32, 32, 3)
    taug = pstep.make_augmenter(PT.TransformConfig(input_res=32), train=True)
    assert taug(torch.Generator(), {"video": f})["video"] is f
    out = taug(torch.Generator().manual_seed(0), {"video": torch.from_numpy(u8),
                                                   "object_frame": torch.from_numpy(u8)})
    assert out["video"].shape == out["object_frame"].shape == (2, 2, 32, 32, 3)


def test_host_precropped_skips_the_crop():
    u8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 1, 16, 16, 3),
                                                            dtype=np.uint8))
    cfg = PT.TransformConfig(input_res=16, host_precropped=True)
    out = PT.train_augment(torch.Generator().manual_seed(0), u8, cfg)
    x = PT.normalize(u8.float() / 255.0, cfg)
    for i in range(3):  # each clip is either itself or its mirror image
        assert torch.allclose(out[i], x[i]) or torch.allclose(out[i], x[i].flip(-2))
    with pytest.raises(ValueError, match="host_precropped"):
        PT.train_augment(torch.Generator(), u8, PT.TransformConfig(input_res=8,
                                                                   host_precropped=True))
