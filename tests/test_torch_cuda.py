"""oatx_torch's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one. The file imports
neither jax nor oatx, so on a machine without JAX it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: bf16 kernel vs bf16 plain version, O(1) outputs. Both round to
bf16 at the same points (z, h, p) but sum in different orders, so a rounding
may land one bf16 ulp apart (≈ 4e-3 at 1) and spread through the next
product: atol 2e-2.
"""

import pytest
import torch

from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.ops import attention as patt
from oatx_torch.ops.kernels import ln_mlp as plm
from oatx_torch.ops.kernels import space_attention as psa

ATOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,hidden", [(785, 768, 3072), (33, 768, 3072), (1, 128, 512)])
def test_ln_mlp_kernel_matches_plain(card, rows, d, hidden):
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
def test_kernels_refuse_what_they_cannot_take(card):
    x = torch.zeros(4, 128, device=card)  # f32 activations
    w1, w2 = torch.zeros(512, 128, device=card), torch.zeros(128, 512, device=card)
    vec = [torch.zeros(n, device=card) for n in (128, 128, 512, 128)]
    with pytest.raises(ValueError, match="bf16"):
        plm.ln_mlp(x, vec[0], vec[1], w1, vec[2], w2, vec[3])
    q = torch.zeros(1, 9, 2, 32, device=card, dtype=torch.bfloat16)  # Dh 32
    with pytest.raises(ValueError, match="Dh"):
        psa.space_attention(q, q, q, 2)


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
