"""The port's CLIP vision tower (models/clip_vision.py) and its converters
against oatx's (oatx.models.clip_vision, convert.clip_vision_{to,from}_torch).

The same random oatx weights go through oatx's `clip_vision_to_torch`
into the port's `clip_vision_from_torch`. `apply`, `encode_image` and
`encode_image_patches` agree within 1e-5 of each output's scale in f32 at
width 64, 2 layers, 32², patch 8: with the converters' inferred geometry
(heads = width / 64 = 1, as oatx infers it) and with 4 heads set by hand.
The port's converter round-trips exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.models import clip_vision as jcv
from oatx.models import convert as jconvert
from oatx_torch.models import clip_vision as pcv
from oatx_torch.models import convert as pconvert

GEOM = dict(input_resolution=32, patch_size=8, width=64, layers=2, output_dim=48)


def _oatx(heads, seed=0):
    cfg = jcv.ClipVisionConfig(heads=heads, **GEOM)
    params = jax.jit(jcv.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    leaves, tree = jax.tree_util.tree_flatten(params)  # LN affines and biases off 1 / 0
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32)
              for a in leaves]
    return cfg, jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in leaves])


def _close(got, want, scale=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max())


@pytest.mark.parametrize("heads", [None, 4])
def test_clip_vision_matches_oatx(heads):
    torch.set_num_threads(1)
    cfg, params = _oatx(heads or 1)
    sd = jconvert.clip_vision_to_torch(params)
    if heads is None:  # the converters infer the geometry
        model, pcfg = pconvert.clip_vision_from_torch(sd, device="cpu")
        jparams, jcfg = jconvert.clip_vision_from_torch(sd)
        assert pcfg == pcv.ClipVisionConfig(**{f: getattr(jcfg, f) for f in (
            "input_resolution", "patch_size", "width", "heads", "layers", "output_dim")})
    else:
        model = pcv.ClipVision(pcv.ClipVisionConfig(heads=heads, **GEOM), device="cpu")
        model.load_state_dict({k[len("visual."):]: torch.tensor(np.asarray(v))
                               for k, v in sd.items()}, strict=True)
        jparams, jcfg = params, cfg
    images = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    for fn, shape in (("apply", (3, 17, 64)), ("encode_image", (3, 48)),
                      ("encode_image_patches", (3, 16, 48))):
        want = np.asarray(jax.jit(getattr(jcv, fn), static_argnums=1)(
            jparams, jcfg, jnp.asarray(images)))
        with torch.no_grad():
            got = getattr(model, fn)(torch.from_numpy(images)).numpy()
        assert got.shape == shape
        _close(got, want)
    with torch.no_grad():
        norms = torch.linalg.vector_norm(model.encode_image_patches(torch.from_numpy(images)), dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6)


def test_clip_vision_converters_round_trip():
    _, params = _oatx(1, seed=3)
    sd = jconvert.clip_vision_to_torch(params)
    full = {**sd, "text_projection": np.zeros((8, 8), np.float32), "module.x": np.zeros(1)}
    model, _ = pconvert.clip_vision_from_torch(full, device="cpu")  # the text side is ignored
    back = pconvert.clip_vision_to_torch(model)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)
    again, _ = pconvert.clip_vision_from_torch({k[len("visual."):]: v for k, v in back.items()},
                                               device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    # and back through oatx's reader: its params are the ones written
    jparams, _ = jconvert.clip_vision_from_torch({k: v.numpy() for k, v in back.items()})
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_clip_vision_refuses_scan_layers():
    with pytest.raises(NotImplementedError, match="scan_layers"):
        pcv.ClipVision(pcv.ClipVisionConfig(scan_layers=True, **GEOM), device="cpu")
