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
    (300, 128, 512), (1, 128, 512), (50, 48, 192), (129, 1024, 4096)])
def test_ln_mlp_kernel_matches_plain(card, rows, d, hidden):
    """The ViT-B MLP at the serving and train row counts (6280 = 49·128 + 8,
    785 = 6·128 + 17: the second product split over the hidden dimension at
    785, 33 and 1 rows), the small train step's widths (hidden 512 and out
    128, which the 256-column tile does not divide), D under one 64-column
    chunk (48) and ViT-L's 1024 → 4096 → 1024."""
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
@pytest.mark.parametrize("b,frames,n", [(2, 4, 196), (3, 2, 4), (1, 1, 196)])
def test_space_attention_kernel_matches_plain(card, b, frames, n):
    g = torch.Generator(card).manual_seed(b * 100 + n)
    t = 1 + frames * n
    qkv = torch.randn(b, t, 3, 12, 64, device=card, generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0] * 0.125, qkv[:, :, 1], qkv[:, :, 2]  # strided views, as served
    before = psa.space_attention.launches
    got = psa.space_attention(q, k, v, frames)
    torch.cuda.synchronize()
    assert psa.space_attention.launches == before + 1
    torch.testing.assert_close(got.float(), psa.space_attention_plain(q, k, v, frames).float(),
                               atol=ATOL, rtol=0)


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
