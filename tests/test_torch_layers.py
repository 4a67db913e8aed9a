"""oatx_torch.ops (layers, attention) against oatx.ops on the CPU, f32,
atol 1e-5, from numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.ops import attention as jatt
from oatx.ops import layers as jl
from oatx_torch.ops import attention as patt
from oatx_torch.ops import layers as pl

torch.set_num_threads(1)
ATOL = 1e-5
T = torch.from_numpy


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _dense(rng, d_in, d_out):
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d_out)).astype(np.float32)
    return w, b  # oatx layout (in, out)


def test_linear(rng):
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    w, b = _dense(rng, 16, 24)
    want = jl.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = pl.linear(T(x), T(w.T.copy()), T(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_linear_adds_bias_in_compute_dtype(rng):
    """bf16: the matmul result is rounded, then the bias (cast to bf16) added
    and rounded again — oatx layers.py:29-33, unlike ln_mlp's f32 biases."""
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w, b = _dense(rng, 16, 8)
    got = pl.linear(T(x).bfloat16(), T(w.T.copy()), T(b))
    mm = (T(x).bfloat16() @ T(w).bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mm + T(b).bfloat16())


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_layer_norm(rng, eps):
    x = (3 + 2 * rng.standard_normal((5, 32))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = jl.layer_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)},
                         jnp.asarray(x), eps)
    got = pl.layer_norm(T(x), T(g), T(b), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_gelu_and_mlp(rng):
    x = rng.standard_normal((6, 16)).astype(np.float32)
    np.testing.assert_allclose(pl.gelu(T(4 * x)).numpy(),
                               np.asarray(jl.gelu(jnp.asarray(4 * x))), atol=ATOL, rtol=0)
    (w1, b1), (w2, b2) = _dense(rng, 16, 64), _dense(rng, 64, 16)
    want = jl.mlp({"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
                   "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}},
                  jnp.asarray(x))
    got = pl.mlp(T(x), T(w1.T.copy()), T(b1), T(w2.T.copy()), T(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_patch_embed_conv(rng):
    """NHWC frames, HWIO kernel in oatx → OIHW weight in the port; tokens in
    row-major (h, w) order."""
    imgs = rng.standard_normal((3, 32, 48, 3)).astype(np.float32)
    k = (0.05 * rng.standard_normal((16, 16, 3, 24))).astype(np.float32)  # HWIO
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    want = jl.patch_embed_conv({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)},
                               jnp.asarray(imgs), 16)
    got = pl.patch_embed_conv(T(imgs), T(k.transpose(3, 2, 0, 1).copy()), T(b), 16)
    assert got.shape == (3, 6, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_embedding_lookup(rng):
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 5)).astype(np.int32)
    want = jl.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(pl.embedding_lookup(T(table), T(ids)).numpy(),
                                  np.asarray(want))


def test_trunc_normal_init():
    g = torch.Generator().manual_seed(0)
    w = pl.trunc_normal_(torch.empty(200, 300), g)
    assert float(w.abs().max()) <= 0.04 + 1e-7  # truncated at 2σ
    assert abs(float(w.std()) - 0.02 * 0.8796) < 1e-3  # σ of N(0,1) cut at ±2
    again = pl.trunc_normal_(torch.empty(200, 300), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)  # explicit generator → reproducible


def _attn_params(rng, d):
    (wq, bq), (wp, bp) = _dense(rng, d, 3 * d), _dense(rng, d, d)
    jp = {"qkv": {"kernel": jnp.asarray(wq), "bias": jnp.asarray(bq)},
          "proj": {"kernel": jnp.asarray(wp), "bias": jnp.asarray(bp)}}
    return jp, (T(wq.T.copy()), T(bq), T(wp.T.copy()), T(bp))


@pytest.mark.parametrize("masked", [False, True])
def test_full_attention(rng, masked):
    b, t, d, h = 3, 9, 32, 4
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    jp, pp = _attn_params(rng, d)
    mask = None
    if masked:
        mask = np.ones((b, t), np.int32)
        mask[0, 5:] = 0
        mask[2, 1:] = 0
    want = jatt.full_attention(jp, jnp.asarray(x), h,
                               None if mask is None else jnp.asarray(mask))
    got = patt.full_attention(T(x), *pp, h, None if mask is None else T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cls_pos", ["first", "last"])
@pytest.mark.parametrize("mode", ["time", "space"])
def test_divided_attention_either_cls_order(rng, mode, cls_pos):
    """The port's one CLS-first formulation equals oatx in both of its token
    orders (the 'last' order is the same math on permuted tokens)."""
    b, f, n, d, h = 2, 3, 4, 32, 4
    x = rng.standard_normal((b, 1 + f * n, d)).astype(np.float32)
    jp, pp = _attn_params(rng, d)
    if cls_pos == "first":
        want = np.asarray(jatt.divided_attention(jp, jnp.asarray(x), h, f, mode=mode,
                                                 cls_pos="first"))
    else:
        xl = np.concatenate([x[:, 1:], x[:, :1]], axis=1)
        wl = np.asarray(jatt.divided_attention(jp, jnp.asarray(xl), h, f, mode=mode,
                                               cls_pos="last"))
        want = np.concatenate([wl[:, -1:], wl[:, :-1]], axis=1)
    got = patt.divided_attention(T(x), *pp, h, f, mode)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_divided_attention_rejects_bad_shapes(rng):
    x = T(rng.standard_normal((1, 8, 16)).astype(np.float32))  # 8 = 1 + 7: not 2 frames
    _, pp = _attn_params(rng, 16)
    with pytest.raises(ValueError, match="incompatible"):
        patt.divided_attention(x, *pp, 4, 2, "space")
    with pytest.raises(ValueError, match="mode"):
        patt.divided_attention(T(rng.standard_normal((1, 9, 16)).astype(np.float32)),
                               *pp, 4, 2, "diagonal")
