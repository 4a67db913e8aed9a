"""oatx_torch's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one. The file imports
neither jax nor oatx, so on a machine without JAX it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: bf16 kernel vs bf16 plain version, O(1) outputs. Both round to
bf16 at the same points (z, h, p) but sum in different orders, so a rounding
may land one bf16 ulp apart (≈ 4e-3 at 1) and spread through the next
product: atol 2e-2. Gradients through a kernel's autograd.Function against
autograd through its plain version (both bf16 on the card) are held by their
relative L2 error: the two backward passes round at different points (the
Function's VJP keeps dW and dz in f32 and rounds dpre1 once; autograd of the
plain version rounds each cotangent back to bf16 at every cast), so a few
bf16 ulps (2^-8 ≈ 4e-3 each) separate them: GRAD_REL 2e-2.
"""

import json

import pytest
import torch

from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.ops import attention as patt
from oatx_torch.ops.kernels import ln_linear as pll
from oatx_torch.ops.kernels import ln_mlp as plm
from oatx_torch.ops.kernels import space_attention as psa
from oatx_torch.ops.kernels._common import mm_f32
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep

ATOL = 2e-2
GRAD_REL = 2e-2
# At the ViT-L / ViT-H widths outputs reach |y| ≈ 4, where one bf16 ulp
# (2^-7·|y|, 0.031 at 4) is past ATOL: those tests add one ulp of |y|.
BF16_ULP = 2.0 ** -7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,hidden", [
    (6280, 768, 3072), (3140, 768, 3072), (785, 768, 3072), (33, 768, 3072), (1, 768, 3072),
    (300, 128, 512), (1, 128, 512), (50, 48, 192), (129, 1024, 4096),
    (3152, 768, 3072), (12560, 768, 3072), (197, 768, 3072)])
def test_ln_mlp_kernel_matches_plain(card, rows, d, hidden):
    """The ViT-B MLP at the serving and train row counts (6280 = 49·128 + 8,
    785 = 6·128 + 17: the second product split over the hidden dimension at
    785, 33 and 1 rows), the small train step's widths (hidden 512 and out
    128, which the 256-column tile does not divide), D under one 64-column
    chunk (48), ViT-L's 1024 → 4096 → 1024, the object-aware recipes'
    batch of 16: the 1-frame object frame (3152 = 24·128 + 80 rows) and the
    4-frame clip (12560), and one 224² frame as cli.extract sends it (197 =
    128 + 69: a second row tile mostly past the end)."""
    g = torch.Generator(card).manual_seed(rows)
    bf = torch.bfloat16
    x = torch.randn(rows, d, device=card, generator=g).to(bf)
    w1 = (torch.randn(hidden, d, device=card, generator=g) / d ** 0.5).to(bf)
    w2 = (torch.randn(d, hidden, device=card, generator=g) / hidden ** 0.5).to(bf)
    small = [0.1 * torch.randn(n, device=card, generator=g) for n in (d, d, hidden, d)]
    args = (x, 1 + small[0], small[1], w1, small[2], w2, small[3], 1e-6)
    before = plm.ln_mlp.launches
    got = plm.ln_mlp(*args)
    torch.cuda.synchronize()
    assert plm.ln_mlp.launches == before + 1
    torch.testing.assert_close(got.float(), plm.ln_mlp_plain(*args).float(), atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_ln_mlp_kernel_takes_gathered_fsdp_weights(card):
    """Under fsdp a weight reaches kernel 1 as the view of a gathered flat
    buffer (parallel/sharding.FlatShard.whole over every rank's share, here
    4 shares of an odd-sized weight, padded): the kernel launches on it and
    gives bitwise the output it gives on the weight itself."""
    from oatx_torch.parallel.sharding import FlatShard

    g = torch.Generator(card).manual_seed(5)
    d, hidden, rows = 768, 3072, 785
    x = torch.randn(rows, d, device=card, generator=g)
    w1 = torch.randn(hidden, d, device=card, generator=g) / d ** 0.5
    w2 = torch.randn(d, hidden, device=card, generator=g) / hidden ** 0.5
    b1 = 0.1 * torch.randn(hidden + 1, device=card, generator=g)[:hidden]
    small = [0.1 * torch.randn(d, device=card, generator=g) for _ in range(3)]

    def gathered(w):
        shares = [FlatShard(tuple(w.shape), r, 4).take(w) for r in range(4)]
        return FlatShard(tuple(w.shape), 0, 4).whole(torch.cat(shares))

    bf = torch.bfloat16
    before = plm.ln_mlp.launches
    outs = [plm.ln_mlp(x.to(bf), 1 + small[0], small[1], a.to(bf), b1, c.to(bf), small[2],
                       1e-6) for a, c in ((w1, w2), (gathered(w1), gathered(w2)))]
    torch.cuda.synchronize()
    assert plm.ln_mlp.launches == before + 2
    assert torch.equal(outs[0], outs[1])


# a rank's shapes under a model axis: kernel 1 on the hidden shard (rows, D,
# 4D/mp), kernel 2 on the local heads (B, frames, N, H/mp, Dh)
TP_MLP = [(12560, 768, 1536), (12560, 1024, 1024), (4100, 1280, 1280)]
TP_SA = [(16, 4, 196, 6, 64), (16, 4, 196, 4, 64), (4, 4, 256, 4, 80)]
TP_IDS = ["vit_b_mp2", "vit_l_mp4", "vit_h_mp4"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,hidden", TP_MLP, ids=TP_IDS)
def test_ln_mlp_kernel_on_a_hidden_shard(card, rows, d, hidden):
    """Kernel 1 on a rank's fc1 rows and fc2 columns (ViT-B at mp 2, ViT-L
    and ViT-H at mp 4) with a zero fc2 bias, as the model group calls it:
    against its plain version, and against the plain chain with its bias,
    less the bias (the group's sum adds b2 once)."""
    g = torch.Generator(card).manual_seed(rows + hidden)
    bf = torch.bfloat16
    x = torch.randn(rows, d, device=card, generator=g).to(bf)
    w1 = (torch.randn(hidden, d, device=card, generator=g) / d ** 0.5).to(bf)
    w2 = (torch.randn(d, hidden, device=card, generator=g) / hidden ** 0.5).to(bf)
    small = [0.1 * torch.randn(n, device=card, generator=g) for n in (d, d, hidden, d)]
    args = (x, 1 + small[0], small[1], w1, small[2], w2, torch.zeros_like(small[3]), 1e-6)
    before = plm.ln_mlp.launches
    got = plm.ln_mlp(*args)
    torch.cuda.synchronize()
    assert plm.ln_mlp.launches == before + 1
    torch.testing.assert_close(got.float(), plm.ln_mlp_plain(*args).float(), atol=ATOL, rtol=0)
    whole = plm.ln_mlp_plain(*args[:6], small[3], 1e-6).float() - small[3]
    torch.testing.assert_close(got.float(), whole, atol=ATOL + BF16_ULP * float(whole.abs().max()),
                               rtol=0)


def _qkv_views(card, b, frames, n, seed, heads=12, dh=64):
    """q, k, v of a (b, 1 + frames·n, 3, heads, dh) bf16 qkv tensor: k and v
    strided views of it, q a fresh tensor (the view times dh^-0.5), as the
    towers give them."""
    g = torch.Generator(card).manual_seed(seed)
    qkv = torch.randn(b, 1 + frames * n, 3, heads, dh, device=card, generator=g)
    qkv = qkv.to(torch.bfloat16)
    return qkv[:, :, 0] * dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("b,frames,n", [
    (1, 4, 196), (2, 4, 196), (4, 4, 196), (8, 4, 196), (2, 16, 196), (3, 2, 4),
    (1, 1, 196), (2, 4, 48)])
def test_space_attention_kernel_matches_plain(card, b, frames, n):
    """Serving buckets 1, 4 and 8 (each query split of `_query_split`), 16
    frames (T = 3137 CLS logits), N = 4 (one query tile, 11 padded keys),
    one frame (T = 197, the 1-frame image batches) and N = 48."""
    q, k, v = _qkv_views(card, b, frames, n, b * 100 + n)
    before = psa.space_attention.launches
    got = psa.space_attention(q, k, v, frames)
    torch.cuda.synchronize()
    assert psa.space_attention.launches == before + 1
    torch.testing.assert_close(got.float(), psa.space_attention_plain(q, k, v, frames).float(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,frames,n,heads,dh", TP_SA, ids=TP_IDS)
def test_space_attention_kernel_on_local_heads(card, b, frames, n, heads, dh):
    """Kernel 2 on a rank's heads under a model axis (6 of ViT-B's 12 at mp
    2, 4 of ViT-L's and ViT-H's 16 at mp 4), k and v views into the rank's
    qkv (its q, k, v rows of those heads), forward and backward against the
    plain version."""
    q, k, v = _qkv_views(card, b, frames, n, b + n + heads, heads, dh)
    before = psa.space_attention.launches
    got = psa.space_attention(q, k, v, frames)
    torch.cuda.synchronize()
    assert psa.space_attention.launches == before + 1
    torch.testing.assert_close(got.float(), psa.space_attention_plain(q, k, v, frames).float(),
                               atol=ATOL, rtol=0)
    g = torch.Generator(card).manual_seed(7)
    dout = torch.randn(got.shape, device=card, generator=g).to(torch.bfloat16)
    _, lse = psa._launch(q, k, v, frames, with_lse=True)
    grads = psa.space_attention_backward(q, k, v, dout, frames, lse)
    with torch.enable_grad():
        leaves = [a.detach().float().requires_grad_() for a in (q, k, v)]
        want = torch.autograd.grad(psa.space_attention_plain(*leaves, frames), leaves,
                                   dout.float())
    for name, a, w in zip("qkv", grads, want):
        rel = float((a.float() - w).norm() / w.norm())
        assert rel < 2e-2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("b,frames,n,heads,dh", [
    (4, 4, 256, 16, 80), (8, 4, 256, 16, 80), (2, 1, 256, 16, 80), (2, 4, 196, 16, 80),
    (3, 2, 4, 2, 80), (1, 2, 271, 2, 80), (2, 4, 256, 16, 64), (1, 2, 271, 2, 64)])
def test_space_attention_kernel_at_dh80_and_257_keys(card, b, frames, n, heads, dh):
    """ViT-H/14 over 4×224² (Dh 80, 16 heads, N = 256: 257 keys, 17 key
    tiles) at B 4 and 8 and over one frame, Dh 80 at ViT-B's 197 keys and at
    N = 4 (15 padded keys), the new limit of 272 keys at both head dims, and
    ViT-L/16 over 4×256² (Dh 64, 257 keys)."""
    q, k, v = _qkv_views(card, b, frames, n, b * 100 + n + dh, heads, dh)
    before = psa.space_attention.launches
    got = psa.space_attention(q, k, v, frames)
    torch.cuda.synchronize()
    assert psa.space_attention.launches == before + 1
    torch.testing.assert_close(got.float(), psa.space_attention_plain(q, k, v, frames).float(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_space_attention_at_the_object_frame_shape(card):
    """Forward and backward at the object-aware recipes' object frame: B 16,
    one frame, T = 197 (192 frame groups, 192 CLS units each over one
    frame's partial). The forward against the plain version; the backward's
    dq, dk, dv against autograd of it (the CLS row's per-frame partials
    with F = 1)."""
    q, k, v = _qkv_views(card, 16, 1, 196, 1601)
    before = (psa.space_attention.launches, psa.space_attention_backward.launches)
    got = psa.space_attention(q, k, v, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), psa.space_attention_plain(q, k, v, 1).float(),
                               atol=ATOL, rtol=0)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    _grads_match(lambda a, b, c: psa.space_attention(a, b, c, 1),
                 lambda a, b, c: psa.space_attention_plain(a, b, c, 1), leaves, ("q", "k", "v"))
    assert (psa.space_attention.launches, psa.space_attention_backward.launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_space_attention_kernels_are_deterministic(card):
    """Forward and backward twice on the same inputs: bitwise the same (no
    float atomics; every sum in a fixed order)."""
    q, k, v = _qkv_views(card, 2, 4, 196, 7)
    out1, lse1 = psa._launch(q, k, v, 4, with_lse=True)
    out2, lse2 = psa._launch(q, k, v, 4, with_lse=True)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    dout = torch.randn(out1.shape, device=card,
                       generator=torch.Generator(card).manual_seed(8)).to(torch.bfloat16)
    g1 = psa.space_attention_backward(q, k, v, dout, 4, lse1)
    g2 = psa.space_attention_backward(q, k, v, dout, 4, lse1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,n", [(1, 196), (2, 196), (4, 196), (2, 4)])
def test_space_attention_backward_kernel_gradients(card, frames, n):
    """The backward kernels against autograd of the plain version, each of
    dq, dk, dv; the CLS key's gradient gathers from every frame and from the
    CLS row (F = 1, 2, 4). One backward call counts one launch."""
    q, k, v = _qkv_views(card, 2, frames, n, 30 + frames)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (psa.space_attention.launches, psa.space_attention_backward.launches)
    _grads_match(lambda a, b, c: psa.space_attention(a, b, c, frames),
                 lambda a, b, c: psa.space_attention_plain(a, b, c, frames),
                 leaves, ("q", "k", "v"))
    assert (psa.space_attention.launches, psa.space_attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("frames,n,dh", [(1, 256, 80), (2, 256, 80), (4, 256, 80),
                                         (2, 4, 80), (2, 256, 64), (2, 271, 80)])
def test_space_attention_backward_kernel_gradients_at_dh80(card, frames, n, dh):
    """The backward kernels at ViT-H/14's Dh 80 and 257 keys (F = 1, 2, 4),
    at N = 4, at Dh 64 with 257 keys (ViT-L/16 over 256²) and at the 272-key
    limit, against autograd of the plain version."""
    q, k, v = _qkv_views(card, 2, frames, n, 50 + frames + n, 4, dh)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (psa.space_attention.launches, psa.space_attention_backward.launches)
    _grads_match(lambda a, b, c: psa.space_attention(a, b, c, frames),
                 lambda a, b, c: psa.space_attention_plain(a, b, c, frames),
                 leaves, ("q", "k", "v"))
    assert (psa.space_attention.launches, psa.space_attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_space_attention_kernels_are_deterministic_at_dh80(card):
    """ViT-H/14's shape, (4, 1025, 16, 80): the forward 10 times and the
    backward twice, bitwise the same."""
    q, k, v = _qkv_views(card, 4, 4, 256, 9, 16, 80)
    first, lse = psa._launch(q, k, v, 4, with_lse=True)
    for _ in range(9):
        out, lse2 = psa._launch(q, k, v, 4, with_lse=True)
        assert torch.equal(out, first) and torch.equal(lse2, lse)
    dout = torch.randn(first.shape, device=card,
                       generator=torch.Generator(card).manual_seed(10)).to(torch.bfloat16)
    g1 = psa.space_attention_backward(q, k, v, dout, 4, lse)
    g2 = psa.space_attention_backward(q, k, v, dout, 4, lse)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,hidden", [(12560, 1024, 4096), (4100, 1280, 5120)])
def test_ln_mlp_kernel_at_vit_large_and_huge(card, rows, d, hidden):
    """Kernel 1 at the pod recipes' shapes: ViT-L/16 at batch 16 over 4×224²
    (12560 rows, 1024 → 4096 → 1024) and ViT-H/14's micro-batch of 4 (4100
    rows, 1280 → 5120 → 1280)."""
    g = torch.Generator(card).manual_seed(rows)
    bf = torch.bfloat16
    x = torch.randn(rows, d, device=card, generator=g).to(bf)
    w1 = (torch.randn(hidden, d, device=card, generator=g) / d ** 0.5).to(bf)
    w2 = (torch.randn(d, hidden, device=card, generator=g) / hidden ** 0.5).to(bf)
    small = [0.1 * torch.randn(n, device=card, generator=g) for n in (d, d, hidden, d)]
    args = (x, 1 + small[0], small[1], w1, small[2], w2, small[3], 1e-6)
    before = plm.ln_mlp.launches
    got = plm.ln_mlp(*args)
    torch.cuda.synchronize()
    assert plm.ln_mlp.launches == before + 1
    torch.testing.assert_close(got.float(), plm.ln_mlp_plain(*args).float(), atol=ATOL,
                               rtol=BF16_ULP)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", [(6280, 768, 2304), (33, 768, 2304), (1, 768, 2304),
                                      (50, 48, 128), (300, 128, 384), (129, 2048, 264)])
def test_ln_linear_kernel_matches_plain(card, rows, k, n):
    """The train step's LN→qkv shape (6280 = 49·128 + 8 rows), ragged last
    row tiles (33, 1, 129 rows), K under one 64-column chunk (48), N that
    the 256-column tile does not divide (384, as the small train step's
    embed_dim 128 gives, and 264), and K = 2048."""
    g = torch.Generator(card).manual_seed(rows + k)
    bf = torch.bfloat16
    x = torch.randn(rows, k, device=card, generator=g).to(bf)
    w = (torch.randn(n, k, device=card, generator=g) / k ** 0.5).to(bf)
    small = [0.1 * torch.randn(m, device=card, generator=g) for m in (k, k, n)]
    args = (x, 1 + small[0], small[1], w, small[2], 1e-6)
    before = pll.ln_linear.launches
    got = pll.ln_linear(*args)
    torch.cuda.synchronize()
    assert pll.ln_linear.launches == before + 1
    torch.testing.assert_close(got.float(), pll.ln_linear_plain(*args).float(),
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", [(12560, 1024, 3072), (4100, 1280, 3840)])
def test_ln_linear_kernel_at_vit_large_and_huge(card, rows, k, n):
    """Kernel 3 at the LN→qkv shapes of ViT-L/16 at batch 16 over 4×224²
    (12560 rows, 1024 → 3072) and of ViT-H/14's micro-batch of 4 (4100
    rows, 1280 → 3840)."""
    g = torch.Generator(card).manual_seed(rows + k)
    bf = torch.bfloat16
    x = torch.randn(rows, k, device=card, generator=g).to(bf)
    w = (torch.randn(n, k, device=card, generator=g) / k ** 0.5).to(bf)
    small = [0.1 * torch.randn(m, device=card, generator=g) for m in (k, k, n)]
    args = (x, 1 + small[0], small[1], w, small[2], 1e-6)
    before = pll.ln_linear.launches
    got = pll.ln_linear(*args)
    torch.cuda.synchronize()
    assert pll.ln_linear.launches == before + 1
    torch.testing.assert_close(got.float(), pll.ln_linear_plain(*args).float(),
                               atol=ATOL, rtol=BF16_ULP)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _grads_match(fn, plain, args, names):
    """Gradients of a random projection of fn(*args) against the same through
    the plain version (autograd), per input."""
    out = fn(*args)
    dy = torch.randn_like(out.float()).to(out.dtype)
    got = torch.autograd.grad(out, args, dy)
    want = torch.autograd.grad(plain(*args), args, dy)
    for name, a, b in zip(names, got, want):
        assert a is not None and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= GRAD_REL, (name, _rel(a, b))


@pytest.mark.cuda
def test_backward_products_keep_f32(card):
    """mm_f32 takes bf16 operands on the card and returns the f32 sum."""
    g = torch.Generator(card).manual_seed(1)
    a = torch.randn(300, 768, device=card, generator=g).to(torch.bfloat16)
    b = torch.randn(768, 256, device=card, generator=g).to(torch.bfloat16)
    got = mm_f32(a.t().contiguous().t(), b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float(), atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_functions_give_gradients(card):
    """Each of the three autograd.Functions on the card (kernel forward, plain
    VJP) against autograd through its plain version, every input's gradient."""
    g = torch.Generator(card).manual_seed(2)
    bf = torch.bfloat16
    R, D, H, N = 1570, 768, 3072, 2304

    def leaf(*shape, scale=1.0, dtype=torch.float32, offset=0.0):
        t = offset + scale * torch.randn(*shape, device=card, generator=g)
        return t.to(dtype).requires_grad_()

    x = leaf(R, D, dtype=bf)
    ln = [leaf(D, scale=0.1, offset=1.0), leaf(D, scale=0.1)]
    before = (plm.ln_mlp.launches, pll.ln_linear.launches, psa.space_attention.launches)
    _grads_match(plm.ln_mlp, plm.ln_mlp_plain,
                 (x, *ln, leaf(H, D, scale=0.02), leaf(H, scale=0.02),
                  leaf(D, H, scale=0.02), leaf(D, scale=0.02)),
                 ("x", "ln_w", "ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b"))
    _grads_match(pll.ln_linear, pll.ln_linear_plain,
                 (x, *ln, leaf(N, D, scale=0.02), leaf(N, scale=0.02)),
                 ("x", "ln_w", "ln_b", "weight", "bias"))
    qkv = leaf(2, 785, 3, 12, 64, dtype=bf)

    def views(fn):  # k and v are strided views of the qkv tensor, as trained
        return lambda t: fn(t[:, :, 0] * 0.125, t[:, :, 1], t[:, :, 2], 4)

    _grads_match(views(psa.space_attention), views(psa.space_attention_plain),
                 (qkv,), ("qkv",))
    assert (plm.ln_mlp.launches, pll.ln_linear.launches,
            psa.space_attention.launches) == tuple(n + 1 for n in before)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(card):
    x = torch.zeros(4, 128, device=card)  # f32 activations
    w1, w2 = torch.zeros(512, 128, device=card), torch.zeros(128, 512, device=card)
    vec = [torch.zeros(n, device=card) for n in (128, 128, 512, 128)]
    with pytest.raises(ValueError, match="bf16"):
        plm.ln_mlp(x, vec[0], vec[1], w1, vec[2], w2, vec[3])
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="hidden=100"):  # TMA rows of h and W2
        plm.ln_mlp(xb, vec[0], vec[1], w1[:100], vec[2][:100], w2[:, :100], vec[3])
    with pytest.raises(ValueError, match="out=100"):  # TMA rows of y
        plm.ln_mlp(xb, vec[0], vec[1], w1, vec[2], w2[:100], vec[3][:100])
    q = torch.zeros(1, 9, 2, 32, device=card, dtype=torch.bfloat16)  # Dh 32
    with pytest.raises(ValueError, match="Dh"):
        psa.space_attention(q, q, q, 2)
    q = torch.zeros(1, 1 + 2 * 272, 2, 80, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N=272"):  # N + 1 keys of a group > 272
        psa.space_attention(q, q, q, 2)
    w = torch.zeros(256, 128, device=card)
    with pytest.raises(ValueError, match="bf16"):
        pll.ln_linear(x, vec[0], vec[1], w, torch.zeros(256, device=card))
    with pytest.raises(ValueError, match="N=100"):  # TMA rows of y: 16-byte multiples
        pll.ln_linear(xb, vec[0], vec[1], w[:100], torch.zeros(100, device=card))
    with pytest.raises(ValueError, match="K=100"):  # TMA rows of x and W
        pll.ln_linear(torch.zeros(4, 100, device=card, dtype=torch.bfloat16),
                      torch.ones(100, device=card), torch.zeros(100, device=card),
                      torch.zeros(128, 100, device=card), torch.zeros(128, device=card))


@pytest.mark.cuda
def test_video_tower_through_the_kernels(card, monkeypatch):
    """A small bf16 tower on the card (Dh = 64 as the kernel needs): each
    block launches each kernel once, and the embedding agrees with the same
    tower on the plain versions."""
    cfg = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(img_size=32, embed_dim=128, depth=2, num_heads=2,
                                      num_frames=2, time_init="random"),
        text=pdb.DistilBertConfig(vocab_size=100, dim=64, hidden_dim=128, n_layers=1,
                                  n_heads=4),
        projection_dim=32, compute_dtype=torch.bfloat16)
    model = ptowers.DualTower(cfg, device=card).eval()
    x = torch.randn(3, 2, 32, 32, 3, device=card, generator=torch.Generator(card).manual_seed(0))
    before = (plm.ln_mlp.launches, psa.space_attention.launches)
    with torch.inference_mode():
        got = model.compute_video(x)["cls"]
    assert (plm.ln_mlp.launches - before[0], psa.space_attention.launches - before[1]) == (2, 2)
    monkeypatch.setattr(pvst, "ln_mlp", plm.ln_mlp_plain)
    monkeypatch.setattr(patt, "space_attention", psa.space_attention_plain)
    with torch.inference_mode():
        want = model.compute_video(x)["cls"]
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert bool(torch.isfinite(got).all()) and float(cos.min()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("fused_qkv", [False, True])
def test_train_step_through_the_kernels(card, fused_qkv):
    """One bf16 train step of a small tower on the card (Dh = 64): each block
    launches kernels 1 and 2 once and, under fused_qkv, kernel 3 twice; every
    parameter gets a finite gradient (a kernel output without a grad_fn
    would leave whole blocks with None), and the step moves every block
    weight."""
    cfg = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(img_size=32, embed_dim=128, depth=2, num_heads=2,
                                      num_frames=2, time_init="random", fused_qkv=fused_qkv),
        text=pdb.DistilBertConfig(vocab_size=100, dim=64, hidden_dim=128, n_layers=1,
                                  n_heads=4),
        projection_dim=32, compute_dtype=torch.bfloat16)
    state = pstep.init_state(cfg, poptim.make_optimizer(lr=1e-3), device=card,
                             generator=torch.Generator(card).manual_seed(0))
    g = torch.Generator(card).manual_seed(1)
    batch = {"video": torch.randn(4, 2, 32, 32, 3, device=card, generator=g),
             "input_ids": torch.randint(0, 100, (4, 5), device=card, generator=g)}
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    counts = (plm.ln_mlp.launches, psa.space_attention.launches, pll.ln_linear.launches)
    state, metrics = pstep.make_train_step(cfg, pstep.LossConfig(), device=card)(state, batch)
    torch.cuda.synchronize()
    assert (plm.ln_mlp.launches - counts[0], psa.space_attention.launches - counts[1],
            pll.ln_linear.launches - counts[2]) == (2, 2, 4 if fused_qkv else 0)
    assert bool(torch.isfinite(metrics["loss"])) and state.step == 1
    for n, p in state.model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
        if ".blocks." in n and n.endswith("weight"):  # the params behind the kernels
            assert not torch.equal(p.detach(), before[n]), n


def _tower_cfg(depth=2, frames=2, **video):
    """ViT-B widths (D 768, 12 heads of 64) over 224² frames, few blocks; a
    small DistilBERT."""
    return ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(depth=depth, num_frames=frames, time_init="random",
                                      **video),
        text=pdb.DistilBertConfig(vocab_size=100, dim=64, hidden_dim=128, n_layers=1,
                                  n_heads=4),
        projection_dim=32, compute_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "dots", "dots_all"])
def test_remat_gradients_through_the_kernels_match_remat_off(card, policy):
    """2 blocks at 224², B = 2: each remat policy runs kernels 1 and 2 again in
    the backward (2 forward launches a block, 1 backward) and gives the
    gradients of the same step without remat."""
    g = torch.Generator(card).manual_seed(5)
    batch = {"video": torch.randn(2, 2, 224, 224, 3, device=card, generator=g),
             "input_ids": torch.randint(0, 100, (2, 6), device=card, generator=g)}

    def grads(cfg):
        model = ptowers.DualTower(cfg, device=card, generator=torch.Generator(card).manual_seed(0))
        before = (plm.ln_mlp.launches, psa.space_attention.launches,
                  psa.space_attention_backward.launches)
        loss, _ = pstep.loss_fn(model, pstep.LossConfig(), batch)
        loss.backward()
        torch.cuda.synchronize()
        counts = (plm.ln_mlp.launches - before[0], psa.space_attention.launches - before[1],
                  psa.space_attention_backward.launches - before[2])
        return counts, {n: p.grad for n, p in model.named_parameters()}

    off_counts, want = grads(_tower_cfg())
    counts, got = grads(_tower_cfg(remat=True, remat_policy=policy))
    assert off_counts == (2, 2, 2) and counts == (4, 4, 2)
    for n, w in want.items():
        assert got[n] is not None and bool(torch.isfinite(got[n]).all()), n
        assert _rel(got[n], w) <= GRAD_REL, (n, _rel(got[n], w))


@pytest.mark.cuda
def test_space_attention_forward_is_bitwise_repeatable(card):
    """Kernel 2's blocks take units from an atomic counter, so which block
    computes which unit changes from call to call; the output must not (a
    remat recompute must give the forward's values). 20 calls at B = 4."""
    q, k, v = _qkv_views(card, 4, 4, 196, 11)
    first, lse = psa._launch(q, k, v, 4, with_lse=True)
    for _ in range(19):
        out, lse2 = psa._launch(q, k, v, 4, with_lse=True)
        assert torch.equal(out, first) and torch.equal(lse2, lse)


@pytest.mark.cuda
def test_device_prefetch_delivers_batches_while_the_card_works(card):
    """8 batches through pinned memory and the side stream, each equal to its
    host copy, while the consumer runs kernel 1 on the default stream."""
    import numpy as np

    from oatx_torch.data.loader import device_prefetch

    rng = np.random.default_rng(0)
    host = [{"video": rng.integers(0, 256, (8, 4, 256, 256, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 30522, (8, 30)).astype(np.int64),
             "meta": [i]} for i in range(8)]
    g = torch.Generator(card).manual_seed(2)
    x = torch.randn(6280, 768, device=card, generator=g).to(torch.bfloat16)
    w1 = (torch.randn(3072, 768, device=card, generator=g) / 28).to(torch.bfloat16)
    w2 = (torch.randn(768, 3072, device=card, generator=g) / 55).to(torch.bfloat16)
    ones, zeros = torch.ones(768, device=card), torch.zeros(768, device=card)
    got = []
    for i, batch in enumerate(device_prefetch(iter(host), card)):
        for _ in range(4):  # keep the default stream busy behind the copies
            x = plm.ln_mlp(x, ones, zeros, w1, torch.zeros(3072, device=card), w2, zeros)
        assert batch["meta"] == [i] and batch["video"].is_cuda
        got.append({k: batch[k].clone() for k in ("video", "input_ids")})
    torch.cuda.synchronize()
    assert len(got) == 8 and bool(torch.isfinite(x.float()).all())
    for h, b in zip(host, got):
        for k, v in b.items():
            assert torch.equal(v.cpu(), torch.from_numpy(h[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["global_local", "region_mem"])
def test_variant_loss_through_the_kernels(card, variant, monkeypatch):
    """The object-aware variants at ViT-B widths (2 blocks, 224², B = 2, the
    region tap after block 1): the clip (2 frames) and the 1-frame object
    frame each launch kernels 1 and 2 once a block, kernel 2's backward runs
    once a block the loss reaches (region_mem's object frame reaches it only
    through the tap: its block 2 has no backward), every parameter gets a
    finite gradient, and the gradients agree with the same step on the
    plain versions."""
    cfg = _tower_cfg(**({"region_tap_layer": 1} if variant == "region_mem" else {}))
    cfg = ptowers.TowerConfig(**{**cfg.__dict__, "variant": variant})
    g = torch.Generator(card).manual_seed(6)
    b, objects = 2, 3
    batch = {"video": torch.randn(b, 2, 224, 224, 3, device=card, generator=g),
             "object_frame": torch.randn(b, 1, 224, 224, 3, device=card, generator=g),
             "input_ids": torch.randint(0, 100, (b, 6), device=card, generator=g),
             "attention_mask": torch.ones(b, 6, dtype=torch.int32, device=card),
             "patch_masks": (torch.rand(b, objects, 196, device=card, generator=g) > 0.7)
             .float()}
    if variant == "global_local":
        batch.update(pad_input_ids=torch.randint(0, 100, (b, 12), device=card, generator=g),
                     pad_attention_mask=torch.ones(b, 12, dtype=torch.int32, device=card),
                     object_token_masks=torch.tensor([[1, 3, 4], [2, 2, 5]], device=card))
    else:
        batch["text_region_embedding"] = 0.02 * torch.randn(b, objects, 512, device=card,
                                                            generator=g)

    def grads():
        model = ptowers.DualTower(cfg, device=card, generator=torch.Generator(card).manual_seed(0))
        before = (plm.ln_mlp.launches, psa.space_attention.launches,
                  psa.space_attention_backward.launches)
        loss, metrics = pstep.loss_fn(model, pstep.LossConfig(), batch)
        loss.backward()
        torch.cuda.synchronize()
        counts = (plm.ln_mlp.launches - before[0], psa.space_attention.launches - before[1],
                  psa.space_attention_backward.launches - before[2])
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
        return counts, {n: p.grad for n, p in model.named_parameters()}

    counts, got = grads()
    assert counts == (4, 4, 4 if variant == "global_local" else 3)
    monkeypatch.setattr(pvst, "ln_mlp", plm.ln_mlp_plain)
    monkeypatch.setattr(patt, "space_attention", psa.space_attention_plain)
    _, want = grads()
    total = float(torch.sqrt(sum(w.float().square().sum() for w in want.values())))
    for n, w in want.items():
        assert got[n] is not None and bool(torch.isfinite(got[n]).all()), n
        err = float((got[n].float() - w.float()).norm())
        assert err <= 0.1 * float(w.float().norm()) + 0.02 * total, (n, err)


# ------------------------------------------------------------- data plane

@pytest.mark.cuda
def test_decoder_builds_and_round_trips_its_writer(card, tmp_path):
    """On the card's machine (no FFmpeg) the decoder builds from
    oatx_torch/native/decode.cpp with the host compiler, and reads back its
    writer's clip and still: probe, index order from the stamp, clamping,
    and the pattern within JPEG's loss of the written planes."""
    import subprocess

    import numpy as np

    from oatx_torch.data import video_reader as pvr

    clip, still = str(tmp_path / "c.mp4"), str(tmp_path / "s.jpg")
    pvr.write_test_video(clip, 320, 240, 16, 8, seed=3)
    pvr.write_test_image(still, 400, 300, seed=3, frame_index=5)
    ldd = subprocess.run(["ldd", str(pvr.library_path())], capture_output=True, text=True)
    assert "libav" not in ldd.stdout and "libjpeg" not in ldd.stdout
    assert pvr.probe(clip) == (16, 8.0, 320, 240)
    assert pvr.probe(still) == (1, 25.0, 400, 300)
    frames = pvr.decode_indices(clip, list(range(16)) + [99])
    stamp = [float(f[2:6, 2:6, 1].mean()) for f in frames]
    assert all(b - a > 3.0 for a, b in zip(stamp[:16], stamp[1:16]))
    assert np.array_equal(frames[16], frames[15])
    assert pvr.decode_indices(clip, [2], 256).shape == (1, 256, 340, 3)
    s = pvr.decode_indices(still, [0])[0].astype(np.int32)
    d = np.abs(s[:4, :4] - frames[5][:4, :4].astype(np.int32)).mean()  # frame 5's stamp
    assert s.shape == (300, 400, 3) and d < 8


@pytest.mark.cuda
@pytest.mark.parametrize("cli", ["train", "test"])
def test_cli_refuses_the_cpu_without_device_flag(card, cli, tmp_path, monkeypatch):
    """Without a card and without --device cpu the entry points raise
    (the card is hidden here); they never drop to the CPU on their own."""
    import importlib
    import json
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = os.path.join(here, "..", "configs", "smoke", "synthetic.json")
    raw = json.load(open(cfg))
    raw["trainer"]["save_dir"] = str(tmp_path / "exps")
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module(f"oatx_torch.cli.{cli}").main(["-c", str(path)])
    assert not (tmp_path / "exps").exists()


# ------------------------------------------------------------- the new towers

def _small_tower(kind, device):
    """BERT, CLIP text or the object tower at a small size, random from seed 0."""
    from oatx_torch.models import bert as pbert
    from oatx_torch.models import clip_text as pclip
    from oatx_torch.models import object_tower as pobjt

    g = torch.Generator(device).manual_seed(0)
    if kind == "bert":
        return pbert.Bert(pbert.BertConfig(vocab_size=100, dim=128, hidden_dim=256,
                                           n_layers=2, n_heads=2), device, g)
    if kind == "clip":
        return pclip.ClipText(pclip.ClipTextConfig(vocab_size=100, width=128, heads=2,
                                                   layers=2, embed_dim=64), device, g)
    return pobjt.ObjectTower(pobjt.ObjectTowerConfig(dim=128, n_heads=2, hidden_dim=256),
                             device, g)


def _tower_inputs(kind, device):
    g = torch.Generator("cpu").manual_seed(1)
    if kind == "object":
        x = torch.randn(4, 10, 2054, generator=g)
        x[0, 6:] = 0.0  # padding slots
        x[2] = 0.0      # a sample without objects
        return (x.to(device),)
    ids = torch.randint(1, 98, (4, 30), generator=g)
    ids[:, 0], mask = 98, torch.ones(4, 30, dtype=torch.int32)
    for i, n in enumerate((29, 12, 20, 5)):  # <|endoftext|> (the top id), zeros after
        ids[i, n], ids[i, n + 1:], mask[i, n + 1:] = 99, 0, 0
    return (ids.to(device),) if kind == "clip" else (ids.to(device), mask.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bert", "clip", "object"])
def test_new_towers_on_the_card_match_the_cpu(card, kind):
    """The BERT and CLIP text towers and the object tower in bf16 on the
    card against the same module (same weights, same inputs) in f32 on the
    CPU: within 5e-2 of the output's largest entry (bf16 through 2 layers)."""
    cpu = _small_tower(kind, "cpu")
    dev = _small_tower(kind, "cpu").to(card)
    dev.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        if kind == "clip":
            want = cpu.encode_text(*_tower_inputs(kind, "cpu"))
            got = dev.encode_text(*_tower_inputs(kind, card), dtype=torch.bfloat16)
        elif kind == "bert":  # every hidden row, then the pooler output
            h, pooled = cpu(*_tower_inputs(kind, "cpu"))
            want = torch.cat([h.reshape(-1, h.shape[-1]), pooled])
            h, pooled = dev(*_tower_inputs(kind, card), dtype=torch.bfloat16)
            assert pooled.dtype == torch.float32
            got = torch.cat([h.float().reshape(-1, h.shape[-1]), pooled])
        else:
            want = cpu(*_tower_inputs(kind, "cpu"))
            got = dev(*_tower_inputs(kind, card), dtype=torch.bfloat16)
    assert got.dtype in (torch.bfloat16, torch.float32) and got.shape == want.shape
    got = got.float().cpu()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max()), kind


@pytest.mark.cuda
def test_frozen_object_tower_is_bitwise_unchanged_on_the_card(card):
    """AdamW steps with weight decay on the card, the object NCE terms on
    (gradients reach the object tower) but `object_tower` / `obj_proj`
    excluded from the optimizer, as the Trainer freezes them: those tensors
    stay bitwise equal while the video blocks move."""
    from oatx_torch.models import object_tower as pobjt

    cfg = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(img_size=32, embed_dim=128, depth=2, num_heads=2,
                                      num_frames=2, time_init="random"),
        text=pdb.DistilBertConfig(vocab_size=100, dim=64, hidden_dim=128, n_layers=1,
                                  n_heads=4),
        projection_dim=32, compute_dtype=torch.bfloat16,
        object_tower=pobjt.ObjectTowerConfig(dim=64, n_heads=2, hidden_dim=128))
    frozen = ("object_tower", "obj_proj")
    opt = poptim.make_optimizer(lr=1e-3, weight_decay=0.05,
                                trainable_filter=poptim.exclude_subtrees(None, frozen))
    state = pstep.init_state(cfg, opt, device=card, generator=torch.Generator(card).manual_seed(0))
    step = pstep.make_train_step(cfg, pstep.LossConfig(object_nce_weight=0.5), device=card)
    g = torch.Generator(card).manual_seed(2)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for _ in range(3):
        batch = {"video": torch.randn(4, 2, 32, 32, 3, device=card, generator=g),
                 "input_ids": torch.randint(0, 100, (4, 5), device=card, generator=g),
                 "object": torch.randn(4, 10, 2054, device=card, generator=g)}
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["loss_object"]))
    for n, p in state.model.named_parameters():
        if n.startswith(frozen):
            assert p.grad is not None and bool(p.grad.abs().sum() > 0), n
            assert torch.equal(p.detach(), before[n]), n
        elif ".blocks." in n and n.endswith("weight"):
            assert not torch.equal(p.detach(), before[n]), n


@pytest.mark.cuda
def test_build_region_memory_refuses_the_cpu_without_device_flag(card, tmp_path,
                                                                  monkeypatch):
    """cli.build_region_memory raises without a card and without --device
    cpu (the card is hidden here), before it writes anything."""
    from oatx_torch.cli import build_region_memory as pbrm

    vocab = tmp_path / "objects_vocab.txt"
    vocab.write_text("dog\ncat\n")  # __background__ is row 0 implicitly
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbrm.main(["--vocab", str(vocab), "--out", str(tmp_path / "bank.npy")])
    assert not (tmp_path / "bank.npy").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("micro", [1, 4])
def test_pipeline_with_one_stage_is_the_plain_tower(card, micro):
    """parallel/pipeline.py's pipeline_blocks with one stage in one process
    runs the tower's block loop through kernels 1 and 2 (ViT-B/16 width, 2
    blocks, bf16, B 4 × 785 tokens): with one micro-batch bitwise the plain
    loop, output, d(x) and every block gradient; with 4 (a row each) the
    same within ATOL and GRAD_REL (cuBLAS may pick another algorithm for
    the plain products' smaller row counts). time_init 'random': at 'zeros'
    the time branch's gradients are 0 in real arithmetic and bf16 noise in
    both."""
    from oatx_torch.parallel import mesh as pmesh
    from oatx_torch.parallel import pipeline as ppipe

    cfg = pvst.SpaceTimeViTConfig(depth=2, time_init="random")
    tower = pvst.SpaceTimeTransformer(cfg, card, torch.Generator(card).manual_seed(0))
    g = torch.Generator(card).manual_seed(1)
    video = torch.randn(4, 4, 224, 224, 3, device=card, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        x0 = tower.embed(video)
    w = torch.randn(x0.shape, device=card, generator=g).to(torch.bfloat16)

    def run(piped):
        tower.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        if piped:
            out = ppipe.pipeline_blocks([lambda h, b=b: b(h, 4) for b in tower.blocks], x, 1,
                                        micro, pmesh.Layout())
        else:
            out = x
            for b in tower.blocks:
                out = b(out, 4)
        (out.float() * w.float()).sum().backward()
        grads = {n: p.grad.clone() for n, p in tower.blocks.named_parameters()}
        return out.detach(), x.grad, grads

    got, want = run(True), run(False)
    torch.cuda.synchronize()
    if micro == 1:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(got[2][n], want[2][n]) for n in want[2])
        return
    assert float((got[0].float() - want[0].float()).abs().max()) <= ATOL + BF16_ULP * float(
        want[0].float().abs().max())
    assert _rel(got[1], want[1]) <= GRAD_REL
    for n in want[2]:
        assert _rel(got[2][n], want[2][n]) <= GRAD_REL, n


_PP_RANK = r"""
import datetime, json, sys, torch, torch.distributed as dist
from oatx_torch.parallel import collectives as coll
rank, url, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = torch.device("cuda", 0)
dist.init_process_group("gloo", init_method=url, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
res = {}
x = (torch.arange(6 * 785 * 8, device=dev, dtype=torch.float32).view(6, 785, 8) + rank
     ).to(torch.bfloat16)
if rank == 0:
    coll.send_to(x, 1, "pp_send")
    got = coll.recv_from(x.shape, x.dtype, dev, 1)
else:
    got = coll.recv_from(x.shape, x.dtype, dev, 0)
    coll.send_to(x, 0, "pp_grad")
b = torch.full((3, 4), float(rank), device=dev, dtype=torch.bfloat16)
coll.broadcast_from(b, 1, None, "pp_bcast")
other = (torch.arange(6 * 785 * 8, device=dev, dtype=torch.float32).view(6, 785, 8)
         + 1 - rank).to(torch.bfloat16)
res["recv_ok"] = bool(got.device == dev and torch.equal(got, other))
res["bcast_ok"] = bool(b.device == dev and float(b.float().min()) == 1.0)
res["traffic"] = {k: dict(v) for k, v in coll.TRAFFIC.items()}
dist.destroy_process_group()
json.dump(res, open(out, "w"))
"""


@pytest.mark.cuda
def test_pipeline_sends_cuda_tensors_over_gloo(card, tmp_path):
    """The sends phase 13 of chip_smoke.py depends on: two gloo ranks on one
    card exchange a bf16 CUDA activation through parallel/collectives.py's
    send_to / recv_from (gloo's transport aborts on a CUDA address, so each
    side crosses the host, counted as 'pp_host') and broadcast a CUDA tensor
    from the last rank; every tensor arrives whole on the card."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    url = (tmp_path / "store").as_uri()
    env = {**os.environ, "PYTHONPATH": repo}
    procs = [subprocess.Popen([sys.executable, "-c", _PP_RANK, str(r), url,
                               str(tmp_path / f"r{r}.json")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    nbytes = 6 * 785 * 8 * 2
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        assert res["recv_ok"] and res["bcast_ok"], res
        sent = "pp_send" if r == 0 else "pp_grad"
        assert res["traffic"][sent]["bytes"] == nbytes
        assert res["traffic"]["pp_host"]["bytes"] == 2 * nbytes  # its send and its receive
        assert res["traffic"]["pp_bcast"]["bytes"] == 3 * 4 * 2


def _op_inputs(name, card):
    """Inputs of each kernel's custom op at serving bucket 1's shapes."""
    g = torch.Generator(card).manual_seed(17)
    bf = torch.bfloat16

    def r(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(*shape, device=card, generator=g)).to(dtype)

    if name == "ln_mlp":
        return (r(785, 768, dtype=bf), 1 + r(768, scale=0.1), r(768, scale=0.1),
                r(3072, 768, scale=768 ** -0.5, dtype=bf), r(3072, scale=0.1),
                r(768, 3072, scale=3072 ** -0.5, dtype=bf), r(768, scale=0.1), 1e-6)
    if name == "ln_linear":
        return (r(785, 768, dtype=bf), 1 + r(768, scale=0.1), r(768, scale=0.1),
                r(2304, 768, scale=768 ** -0.5, dtype=bf), r(2304, scale=0.1), 1e-6)
    qkv = r(1, 785, 3, 12, 64, dtype=bf)
    return (qkv[:, :, 0] * 0.125, qkv[:, :, 1], qkv[:, :, 2], 4, True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ln_mlp", "ln_linear", "space_attention"])
def test_custom_op_on_cuda_is_the_launch(card, name):
    """Each kernel's custom op (`torch.ops.oatx_torch.<name>`) on CUDA
    tensors is its `_launch`: bitwise the same output (and kernel 2's
    log-sum-exp) as a direct launch on the same inputs, one count each."""
    mod = {"ln_mlp": plm, "ln_linear": pll, "space_attention": psa}[name]
    counter = getattr(mod, name)
    args = _op_inputs(name, card)
    before = counter.launches
    got = getattr(torch.ops.oatx_torch, name)(*args)
    want = mod._launch(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    if name == "space_attention":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].shape == (1, 12, 785)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_exported_artifact_launches_the_kernels(card, tmp_path):
    """A 12-block bf16 tower exported on the card (serve/export.py): the
    program calls the kernels' ops, so each video forward launches kernels 1
    and 2 twelve times each, at batch 1 and at a batch that is no bucket;
    its embeddings agree with the in-process service on the same weights."""
    import numpy as np

    from oatx_torch.serve import embed_service as pes
    from oatx_torch.serve import export as pex

    cfg = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(img_size=32, embed_dim=128, depth=12, num_heads=2,
                                      num_frames=2, time_init="random"),
        text=pdb.DistilBertConfig(vocab_size=100, dim=64, hidden_dim=128, n_layers=1,
                                  n_heads=4),
        projection_dim=32, compute_dtype=torch.bfloat16)
    model = ptowers.DualTower(cfg, device=card, generator=torch.Generator(card).manual_seed(0))
    out = pex.save_artifact(tmp_path / "art", model, cfg, frames=2, canon=40, seq_len=8)
    assert json.loads((out / "meta.json").read_text())["platforms"] == ["cuda"]
    emb = pex.ExportedEmbedder(out)
    svc = pes.EmbedService(model, cfg, buckets=(1, 4), seq_len=8, device=card)
    rng = np.random.default_rng(0)
    for n in (1, 3):
        clips = rng.integers(0, 256, (n, 2, 40, 40, 3), dtype=np.uint8)
        before = (plm.ln_mlp.launches, psa.space_attention.launches)
        got = emb.embed_video(clips)
        torch.cuda.synchronize()
        assert (plm.ln_mlp.launches - before[0],
                psa.space_attention.launches - before[1]) == (12, 12)
        want = svc.embed_video(clips)
        cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
        assert np.isfinite(got).all() and float(cos.min()) >= 0.999
    with pytest.raises(ValueError, match="not cpu"):
        pex.ExportedEmbedder(out, device="cpu")


@pytest.mark.cuda
def test_roi_align_on_the_card_matches_the_cpu(card):
    """ROI-align over ViT-B/16's 14 × 14 grid of 768 channels, forward and
    the features' gradient, on the card against the CPU (f32, boxes on the
    edges, of zero area and reaching outside [0, 1])."""
    from oatx_torch.ops.roi_align import roi_align

    g = torch.Generator().manual_seed(0)
    feat = torch.randn(2, 14, 14, 768, generator=g)
    boxes = torch.cat([torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5],
                                      [-0.2, 0.1, 1.3, 0.4]]]).expand(2, 3, 4),
                       torch.rand(2, 7, 4, generator=g).sort(dim=-1).values],
                      dim=1)
    cot = torch.randn(2, 10, 2, 2, 768, generator=g)
    out = {}
    for dev in ("cpu", card):
        f = feat.to(dev).requires_grad_()
        y = roi_align(f, boxes.to(dev), output_size=2)
        (grad,) = torch.autograd.grad(y, f, cot.to(dev))
        out[str(dev)] = (y.detach().cpu(), grad.cpu())
    (y0, g0), (y1, g1) = out["cpu"], out[str(card)]
    torch.testing.assert_close(y1, y0, atol=1e-6 * float(y0.abs().max()), rtol=0)
    torch.testing.assert_close(g1, g0, atol=1e-6 * float(g0.abs().max()), rtol=0)


@pytest.mark.cuda
def test_roi_backbone_extractor_threads_share_the_card(card):
    """RoiBackboneExtractor on a small bf16 tower (Dh 64): four threads
    extract at once what one thread extracts alone, each frame launching
    each kernel once a block."""
    import concurrent.futures

    import numpy as np

    from oatx_torch.data.extraction import RoiBackboneExtractor

    cfg = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(img_size=64, embed_dim=128, depth=2, num_heads=2,
                                      num_frames=2, time_init="random"),
        text=pdb.DistilBertConfig(vocab_size=100, dim=64, hidden_dim=128, n_layers=1,
                                  n_heads=4),
        projection_dim=32, compute_dtype=torch.bfloat16)
    model = ptowers.DualTower(cfg, device=card).eval()
    ex = RoiBackboneExtractor(model, cfg, num_regions=5, device=card)
    frames = np.random.default_rng(0).integers(0, 256, (16, 48, 80, 3), dtype=np.uint8)
    alone = [ex(f)[0] for f in frames]
    before = (plm.ln_mlp.launches, psa.space_attention.launches)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        together = list(pool.map(lambda f: ex(f)[0], frames))
    torch.cuda.synchronize()
    assert (plm.ln_mlp.launches - before[0], psa.space_attention.launches - before[1]) == \
        (2 * 16, 2 * 16)
    for a, b in zip(alone, together):
        assert a.shape == (5, 2048) and np.isfinite(a).all() and not a[:, 128:].any()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * float(np.abs(a).max()))


# ------------------------------------------------------ visualization

def _cosines(a, b):
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    return (a * b).sum(-1) / a.norm(dim=-1) / b.norm(dim=-1)


@pytest.mark.cuda
def test_visualize_tower_patches_match_the_plain_versions(card, tmp_path, monkeypatch):
    """cli.visualize --backbone tower on a small bf16 config (64², D 128,
    2 heads of 64, 2 blocks): the frame's forward launches kernels 1 and 2
    once a block, and its projected patches hold a cosine of 0.9999 or more
    against the same run through the plain versions on the card."""
    import os

    import numpy as np

    from oatx_torch.cli import visualize as pvis
    from oatx_torch.data import video_reader as pvr
    from oatx_torch.visualization import heatmap as pheat
    from oatx_torch.visualization.png import read_png

    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "smoke",
                           "synthetic.json")) as f:
        raw = json.load(f)
    raw["arch"]["args"]["video_params"]["num_heads"] = 2  # Dh 64: kernel 2's head size
    raw["data_loader"][0]["args"]["data_dir"] = str(tmp_path / "videos")
    raw["trainer"].update(save_dir=str(tmp_path / "exps"), precision="bf16")
    (tmp_path / "c.json").write_text(json.dumps(raw))
    clip = str(tmp_path / "clip.avi")
    pvr.write_test_video(clip, 320, 240, 16, 8, 3)
    seen = []
    render = pheat.render_caption_heatmaps

    def recording(caption, words, patches, frame, prefix, *a, **k):
        seen.append(torch.from_numpy(patches))
        return render(caption, words, patches, frame, prefix, *a, **k)

    monkeypatch.setattr(pheat, "render_caption_heatmaps", recording)
    argv = ["-c", str(tmp_path / "c.json"), "--video", clip, "--caption",
            "a dog chases the ball", "--device", "cuda"]
    before = (plm.ln_mlp.launches, psa.space_attention.launches)
    assert pvis.main([*argv, "--out", str(tmp_path / "k")]) == 0
    torch.cuda.synchronize()
    assert (plm.ln_mlp.launches - before[0], psa.space_attention.launches - before[1]) == (2, 2)
    monkeypatch.setattr(pvst, "ln_mlp", plm.ln_mlp_plain)
    monkeypatch.setattr(patt, "space_attention", psa.space_attention_plain)
    assert pvis.main([*argv, "--out", str(tmp_path / "p")]) == 0
    assert seen[0].shape == (16, 64) and bool(torch.isfinite(seen[0]).all())
    assert float(_cosines(seen[0], seen[1]).min()) >= 0.9999
    pngs = sorted(tmp_path.glob("k_token_*.png"))
    assert [p.name for p in pngs] == ["k_token_1.png", "k_token_2.png", "k_token_4.png"]
    assert all(read_png(str(p)).shape == (274, 448, 3) for p in pngs)
    assert np.isfinite(seen[1].numpy()).all()


@pytest.mark.cuda
def test_export_region_maps_on_the_card(card, tmp_path, monkeypatch):
    """export_region_maps over a region_mem tower at ViT-B widths (2 blocks,
    the tap after block 1), 2 batches of 3 with limit 5: each batch's forward
    launches kernels 1 and 2 once a block of the clip and of the object
    frame, five 224 × 672 panels are written, and each predicted map holds a
    cosine of 0.9999 or more against the plain versions' on the card."""
    import numpy as np

    from oatx_torch.eval import retrieval_eval as peval
    from oatx_torch.visualization.png import read_png

    cfg = _tower_cfg(region_tap_layer=1)
    cfg = ptowers.TowerConfig(**{**cfg.__dict__, "variant": "region_mem"})
    model = ptowers.DualTower(cfg, device=card, generator=torch.Generator(card).manual_seed(0))
    model.eval()
    rng = np.random.default_rng(0)
    batches = [{"video": rng.integers(0, 256, (3, 2, 256, 256, 3), dtype=np.uint8),
                "object_frame": rng.integers(0, 256, (3, 1, 240, 320, 3), dtype=np.uint8),
                "input_ids": rng.integers(1, 100, (3, 6)).astype(np.int32),
                "attention_mask": np.ones((3, 6), np.int32),
                "patch_masks": (rng.uniform(size=(3, 4, 196)) > 0.7).astype(np.float32),
                "text_region_embedding": 0.02 * rng.standard_normal((3, 4, 512))
                .astype(np.float32),
                "meta": [{"raw_captions": f"caption {b}{i} " * 8} for i in range(3)]}
               for b in range(2)]
    preds = {}
    save = peval.save_binary_map

    def saving(path, frame, gt, pred, label=None):
        preds.setdefault(tmp_path.name, []).append(torch.from_numpy(np.array(pred)))
        return save(path, frame, gt, pred, label=label)

    monkeypatch.setattr(peval, "save_binary_map", saving)

    def export(out):
        preds.clear()
        return peval.export_region_maps(model, cfg, [dict(b) for b in batches], str(out),
                                        limit=5, device=card), torch.stack(preds[tmp_path.name])

    before = (plm.ln_mlp.launches, psa.space_attention.launches)
    with torch.no_grad():
        paths, got = export(tmp_path / "k")
    torch.cuda.synchronize()
    assert (plm.ln_mlp.launches - before[0], psa.space_attention.launches - before[1]) == (8, 8)
    assert [p.rsplit("/", 1)[1] for p in paths] == [f"{i}_predict.png" for i in range(5)]
    assert all(read_png(p).shape == (224, 672, 3) for p in paths)
    monkeypatch.setattr(pvst, "ln_mlp", plm.ln_mlp_plain)
    monkeypatch.setattr(patt, "space_attention", psa.space_attention_plain)
    with torch.no_grad():
        _, want = export(tmp_path / "p")
    assert got.shape == (5, 196) and bool(((got > 0) & (got < 1)).all())
    assert float(_cosines(got, want).min()) >= 0.9999
