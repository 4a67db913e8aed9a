"""The port's two kernel modules against oatx, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against oatx's Pallas kernel (interpret mode)
and XLA reference in f32 at atol 1e-5. The kernels themselves run only on a
card: tests/test_torch_cuda.py compares them with the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.ops import attention as jatt
from oatx.ops.pallas import ln_mlp as jlm
from oatx.ops.pallas import spacetime_attention as jsa
from oatx_torch.ops import attention as patt
from oatx_torch.ops.kernels import ln_mlp as plm
from oatx_torch.ops.kernels import space_attention as psa

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture
def mlp_problem():
    rng = np.random.default_rng(11)
    R, K, H = 300, 64, 256
    x = rng.standard_normal((R, K)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(K)).astype(np.float32)
    w1 = (rng.standard_normal((K, H)) / np.sqrt(K)).astype(np.float32)  # (in, out)
    b1 = (0.1 * rng.standard_normal(H)).astype(np.float32)
    w2 = (rng.standard_normal((H, K)) / np.sqrt(H)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(K)).astype(np.float32)
    return x, gamma, beta, w1, b1, w2, b2


def _port_args(p):
    x, gamma, beta, w1, b1, w2, b2 = (torch.from_numpy(a) for a in p)
    return x, gamma, beta, w1.T.contiguous(), b1, w2.T.contiguous(), b2


@pytest.mark.parametrize("oatx_path", ["pallas_interpret", "xla"])
def test_ln_mlp_plain_matches_oatx(mlp_problem, oatx_path):
    args = [jnp.asarray(a) for a in mlp_problem]
    if oatx_path == "xla":
        want = jlm._fwd_xla(*args, 1e-6)
    else:
        want = jlm._fwd_pallas(*args, 1e-6, row_tile=128, interpret=True)
    got = plm.ln_mlp_plain(*_port_args(mlp_problem), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_ln_mlp_wrapper_takes_plain_version_on_cpu(mlp_problem):
    before = plm.ln_mlp.launches
    x, *rest = _port_args(mlp_problem)
    got = plm.ln_mlp(x.reshape(3, 100, -1), *rest, 1e-6)  # leading dims kept
    want = plm.ln_mlp_plain(x, *rest, 1e-6)
    assert got.shape == (3, 100, x.shape[1])
    assert torch.equal(got.reshape(want.shape), want)
    assert plm.ln_mlp.launches == before  # the count is of kernel launches


def test_ln_mlp_bf16_rounds_like_oatx_xla(mlp_problem):
    """bf16 operands: same rounding points as `_fwd_xla` (z and h cast to the
    compute dtype, biases in f32). Summation order differs between XLA:CPU
    and torch, so a bf16 rounding of h may flip: one bf16 ulp of the output."""
    args = [jnp.asarray(a) for a in mlp_problem]
    want = np.asarray(jlm._fwd_xla(args[0].astype(jnp.bfloat16), *args[1:], 1e-6),
                      np.float32)
    x, *rest = _port_args(mlp_problem)
    got = plm.ln_mlp_plain(x.to(torch.bfloat16), *rest, 1e-6).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


def _qkv_problem(b=2, f=3, n=5, h=4, dh=8, seed=3):
    rng = np.random.default_rng(seed)
    t = 1 + f * n
    q = (rng.standard_normal((b, t, h, dh)) * dh ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    return q, k, v, f


def test_space_attention_plain_matches_oatx_reference():
    q, k, v, f = _qkv_problem()
    want = jsa._space_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), f)
    got = psa.space_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("frames", [1, 2, 4])
def test_space_attention_matches_oatx_divided_attention(frames):
    """Port divided_attention(space) — kernel 2's plain version inside — vs
    oatx divided_attention(mode='space', cls_pos='first') on the same x and
    VarAttention params."""
    rng = np.random.default_rng(frames)
    b, n, d, heads = 2, 4, 32, 4
    x = rng.standard_normal((b, 1 + frames * n, d)).astype(np.float32)
    wq = (rng.standard_normal((d, 3 * d)) / np.sqrt(d)).astype(np.float32)
    bq = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    wp = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    bp = (0.1 * rng.standard_normal(d)).astype(np.float32)
    params = {"qkv": {"kernel": jnp.asarray(wq), "bias": jnp.asarray(bq)},
              "proj": {"kernel": jnp.asarray(wp), "bias": jnp.asarray(bp)}}
    want = jatt.divided_attention(params, jnp.asarray(x), heads, frames,
                                  mode="space", cls_pos="first")
    T = torch.from_numpy
    got = patt.divided_attention(T(x), T(wq.T.copy()), T(bq), T(wp.T.copy()), T(bp),
                                 heads, frames, "space")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_space_attention_wrapper_takes_plain_version_on_cpu():
    q, k, v, f = _qkv_problem()
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2))  # strided views, as served
    before = psa.space_attention.launches
    got = psa.space_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], f)
    want = psa.space_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), f)
    assert torch.equal(got, want)
    assert psa.space_attention.launches == before


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    """On a non-CPU tensor the wrapper launches or raises — never falls back."""
    x = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        plm.ln_mlp(x, *[torch.zeros(1, device="meta")] * 6)
    q = torch.zeros(1, 5, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        psa.space_attention(q, q, q, 2)
