"""The tolerance chip_smoke.py holds kernel 2's forward to.

`space_attention_flip_allowance` adds, to 1e-3 + 2^-7·|ref|, the output
moves of the p values that two correct versions may round to neighbouring
bf16 values. Here the second version is the plain function with S summed in
f64 (another order than the plain version's f32 einsum) and exp taken as
2^(x·log2 e) with a reciprocal of the sum, as kernel 2 takes them: every
output must lie within the tolerance with the term, also where p is peaked
(q scaled up) and the bare tolerance does not bound it.
"""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from oatx_torch.ops.kernels.space_attention import space_attention_plain  # noqa: E402

LOG2E = 1.4426950408889634


def _other_order(q, k, v, num_frames):
    b, t, h, dh = q.shape
    f = num_frames
    n = (t - 1) // f
    dt = q.dtype

    def softmax(s):
        s = s.float()
        e = torch.exp2(s * LOG2E - s.amax(-1, keepdim=True) * LOG2E)
        return (e * (1.0 / e.sum(-1, keepdim=True))).to(dt)

    def group(a):
        return torch.cat([a[:, None, :1].expand(b, f, 1, h, dh),
                          a[:, 1:].reshape(b, f, n, h, dh)], dim=2)

    cls_p = softmax(torch.einsum("bqhd,bkhd->bhqk", q[:, :1].double(), k.double()))
    cls = torch.einsum("bhqk,bkhd->bqhd", cls_p.float(), v.float()).to(dt)
    qp = q[:, 1:].reshape(b, f, n, h, dh)
    p = softmax(torch.einsum("bfqhd,bfkhd->bfhqk", qp.double(), group(k).double()))
    out = torch.einsum("bfhqk,bfkhd->bfqhd", p.float(), group(v).float()).to(dt)
    return torch.cat([cls, out.reshape(b, f * n, h, dh)], dim=1)


# (seed, q's scale, whether the bare tolerance misses a rounding flip there)
@pytest.mark.parametrize("seed,scale,bare_misses", [
    (0, 0.125, False), (1, 0.125, False), (9, 0.4, True), (10, 0.4, True), (5, 0.6, True)])
def test_space_attention_flip_allowance_covers_another_summation_order(seed, scale,
                                                                       bare_misses):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(1, 785, 3, 2, 64, generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1], qkv[:, :, 2]
    want = space_attention_plain(q, k, v, 4).float()
    err = (_other_order(q, k, v, 4).float() - want).abs()
    tol = cs.SPACE_ATTENTION_ATOL + cs.BF16_RTOL * want.abs()
    allow = cs.space_attention_flip_allowance(q, k, v, 4)
    assert allow.shape == want.shape and bool((allow >= 0).all())
    assert float((err / (tol + allow)).max()) <= 1
    assert (float((err / tol).max()) > 1) == bare_misses
