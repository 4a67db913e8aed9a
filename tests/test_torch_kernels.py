"""The port's three kernel modules against oatx, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against oatx's Pallas kernel (interpret mode)
and XLA reference in f32 at atol 1e-5. The kernels themselves run only on a
card: tests/test_torch_cuda.py compares them with the plain versions there.

Each wrapper is a torch.autograd.Function whose backward is a named plain
function; those are held against jax.vjp of oatx's custom-VJP ops (the XLA
code its kernels are differentiated with). Tolerances, per gradient tensor:
  * f32: the same algorithm summed in another order: |err| ≤ 2e-6·max|want|
    (measured ≤ 3.3e-7 of the max);
  * bf16: the same rounding points, so only a rounding that the summation
    order flips (of the output, of dpre1 in ln_mlp, of p in attention)
    differs: |err| ≤ 2^-7·max|want|, two bf16 ulps of the largest entry
    (measured ≤ 3.2e-3 of the max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.ops import attention as jatt
from oatx.ops.pallas import ln_linear as jll
from oatx.ops.pallas import ln_mlp as jlm
from oatx.ops.pallas import spacetime_attention as jsa
from oatx_torch.ops import attention as patt
from oatx_torch.ops.kernels import ln_linear as pll
from oatx_torch.ops.kernels import ln_mlp as plm
from oatx_torch.ops.kernels import space_attention as psa

torch.set_num_threads(1)
ATOL = 1e-5
GRAD_REL = {"f32": 2e-6, "bf16": 2.0 ** -7}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close_grads(got, want, names, dtype, transpose=()):
    """Each port gradient against oatx's (kernels (in, out) → torch (out, in))."""
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        if name in transpose:
            w = w.T
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=GRAD_REL[dtype] * np.abs(w).max(), err_msg=name)


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_mlp_backward_matches_oatx_vjp(mlp_problem, dtype):
    """ln_mlp_backward against jax.vjp of oatx `_ln_mlp2d` (its custom VJP
    `_ln_mlp2d_bwd`, XLA on the CPU)."""
    jdt, tdt = DTYPES[dtype]
    x, *rest = mlp_problem
    dy = np.random.default_rng(12).standard_normal((x.shape[0], x.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jlm._ln_mlp2d(*a, 1e-6), jnp.asarray(x).astype(jdt),
                     *map(jnp.asarray, rest))
    want = vjp(jnp.asarray(dy).astype(jdt))
    px, *prest = _port_args(mlp_problem)
    got = plm.ln_mlp_backward(px.to(tdt), *prest[:5], torch.from_numpy(dy).to(tdt), 1e-6)
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    _close_grads(got, want, ("x", "ln_w", "ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b"),
                 dtype, transpose=("fc1_w", "fc2_w"))


@pytest.fixture
def linear_problem():
    rng = np.random.default_rng(16)
    R, K, N = 300, 64, 192  # R = 300 leaves a ragged row tile, as in test_ln_linear.py
    x = rng.standard_normal((R, K)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)  # (in, out)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return x, gamma, beta, w, b


def _port_linear(p):
    x, gamma, beta, w, b = (torch.from_numpy(a) for a in p)
    return x, gamma, beta, w.T.contiguous(), b


@pytest.mark.parametrize("oatx_path", ["pallas_interpret", "xla"])
def test_ln_linear_plain_matches_oatx(linear_problem, oatx_path):
    args = [jnp.asarray(a) for a in linear_problem]
    if oatx_path == "xla":
        want = jll._fwd_xla(*args, 1e-6)
    else:
        want = jll._fwd_pallas(*args, 1e-6, row_tile=128, interpret=True)
    got = pll.ln_linear_plain(*_port_linear(linear_problem), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_ln_linear_bf16_rounds_like_oatx_xla(linear_problem):
    """bf16 x: z cast to bf16 before the product, bias added in f32, one
    rounding of the output; summation order may flip it: one bf16 ulp."""
    args = [jnp.asarray(a) for a in linear_problem]
    want = np.asarray(jll._fwd_xla(args[0].astype(jnp.bfloat16), *args[1:], 1e-6),
                      np.float32)
    x, *rest = _port_linear(linear_problem)
    got = pll.ln_linear_plain(x.to(torch.bfloat16), *rest, 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -7 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_linear_backward_matches_oatx_vjp(linear_problem, dtype):
    """ln_linear_backward against jax.vjp of oatx `_ln_linear2d` (its custom
    VJP `_ln_linear2d_bwd`)."""
    jdt, tdt = DTYPES[dtype]
    x, *rest = linear_problem
    dy = np.random.default_rng(17).standard_normal((x.shape[0], rest[2].shape[1])) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jll._ln_linear2d(*a, 1e-6), jnp.asarray(x).astype(jdt),
                     *map(jnp.asarray, rest))
    want = vjp(jnp.asarray(dy).astype(jdt))
    px, *prest = _port_linear(linear_problem)
    got = pll.ln_linear_backward(px.to(tdt), *prest[:3], torch.from_numpy(dy).to(tdt), 1e-6)
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    _close_grads(got, want, ("x", "ln_w", "ln_b", "weight", "bias"), dtype,
                 transpose=("weight",))


def test_ln_linear_wrapper_takes_plain_version_on_cpu(linear_problem):
    before = pll.ln_linear.launches
    x, *rest = _port_linear(linear_problem)
    got = pll.ln_linear(x.reshape(3, 100, -1), *rest, 1e-6)  # leading dims kept
    assert got.shape == (3, 100, rest[2].shape[0])
    assert torch.equal(got.reshape(x.shape[0], -1), pll.ln_linear_plain(x, *rest, 1e-6))
    assert pll.ln_linear.launches == before


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_space_attention_backward_matches_oatx_vjp(dtype):
    """space_attention_backward (autograd of the plain version) against
    jax.vjp of oatx `_space_attention_reference`, which oatx's custom VJP
    differentiates: dq, dk and dv."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, f = _qkv_problem()
    dout = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jsa._space_attention_reference(a, b, c, f),
                     *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout).astype(jdt))
    got = psa.space_attention_backward(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                       torch.from_numpy(dout).to(tdt), f)
    assert all(g.dtype == tdt for g in got)
    _close_grads(got, want, ("q", "k", "v"), dtype)


@pytest.mark.parametrize("kernel", ["ln_mlp", "ln_linear", "space_attention"])
def test_wrappers_backward_is_the_named_vjp(kernel, mlp_problem, linear_problem):
    """autograd through each wrapper returns exactly its named backward
    function's gradients (what the card runs too); k and v enter attention
    as strided views of one qkv tensor and get their gradients through it."""
    gen = torch.Generator().manual_seed(4)
    if kernel == "space_attention":
        q, k, v, f = _qkv_problem()
        qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_()
        out = psa.space_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], f)
        dy = torch.randn(out.shape, generator=gen)
        got = torch.autograd.grad(out, qkv, dy)[0]
        want = torch.stack(psa.space_attention_backward(
            *(qkv[:, :, i].detach() for i in range(3)), dy, f), dim=2)
        assert torch.equal(got, want)
        return
    if kernel == "ln_mlp":
        args = [a.requires_grad_() for a in _port_args(mlp_problem)]
        fn, bwd = plm.ln_mlp, lambda dy: plm.ln_mlp_backward(*args[:6], dy, 1e-6)
    else:
        args = [a.requires_grad_() for a in _port_linear(linear_problem)]
        fn, bwd = pll.ln_linear, lambda dy: pll.ln_linear_backward(*args[:4], dy, 1e-6)
    out = fn(*args, 1e-6)
    dy = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, args, dy)
    with torch.no_grad():
        want = bwd(dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
    with pytest.raises(ValueError, match="unsupported device"):
        pll.ln_linear(x, *[torch.zeros(1, device="meta")] * 4)


@pytest.mark.parametrize("k,n", [(100, 128), (128, 100)])
def test_ln_linear_kernel_refuses_widths_tma_cannot_read(k, n):
    """The kernel's TMA reads x, W and writes y in rows of 16-byte multiples:
    the wrapper refuses K or N that is not a multiple of 8 before anything
    reaches a device."""
    meta = dict(device="meta")
    x = torch.zeros(4, k, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match=f"K={k} N={n}"):
        pll._launch(x, torch.zeros(k, **meta), torch.zeros(k, **meta),
                    torch.zeros(n, k, **meta), torch.zeros(n, **meta), 1e-6)


@pytest.mark.parametrize("k,hid,n", [(100, 512, 128), (128, 100, 128), (128, 512, 100)])
def test_ln_mlp_kernel_refuses_widths_tma_cannot_read(k, hid, n):
    """The kernels' TMA reads x, W1, h, W2 and writes h, y in rows of 16-byte
    multiples: the wrapper refuses D, hidden or out that is not a multiple
    of 8 before anything reaches a device."""
    meta = dict(device="meta")
    x = torch.zeros(4, k, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match=f"D={k} hidden={hid} out={n}"):
        plm._launch(x, torch.zeros(k, **meta), torch.zeros(k, **meta),
                    torch.zeros(hid, k, **meta), torch.zeros(hid, **meta),
                    torch.zeros(n, hid, **meta), torch.zeros(n, **meta), 1e-6)


@pytest.mark.parametrize("rows,hid,n,want", [
    (785, 3072, 768, 6),    # serving bucket 1: 7 x 3 tiles of y, 8 chunks a range
    (3140, 3072, 768, 1),   # bucket 4: 25 x 3 tiles fill more than half the card
    (6280, 3072, 768, 1),
    (1, 3072, 768, 12),     # ranges of at least 4 chunks of 64
    (300, 512, 128, 2),     # the small train step
    (50, 192, 48, 1),       # hidden under 4 chunks
])
def test_ln_mlp_down_split_fills_the_card(rows, hid, n, want):
    assert plm._down_split(rows, hid, n, 132) == want


def test_build_rehashes_when_a_shared_header_changes(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh and the flags, so
    an edit of a header that a source includes builds it anew (no nvcc
    here: only the name is computed)."""
    from oatx_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src, hdr = tmp_path / "k.cu", tmp_path / "hopper.cuh"
    src.write_text('#include "hopper.cuh"\n')
    hdr.write_text("constexpr int S = 4;\n")
    first = _build._lib_path(src)
    assert first == _build._lib_path(src) and first.parent == tmp_path / "_build"
    hdr.write_text("constexpr int S = 3;\n")
    assert _build._lib_path(src) != first
    hdr.write_text("constexpr int S = 4;\n")
    assert _build._lib_path(src) == first
