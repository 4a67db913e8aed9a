"""Pieces shared by the kernels' plain versions and backward passes.

`ln_parts` is the f32 LayerNorm of oatx's `_fwd_xla` and of its hand-written
VJPs, which recompute the statistics from the saved input
(oatx/ops/pallas/ln_mlp.py:157-162, ln_linear.py:114-119). `mm_f32` is the
product `jnp.dot(a, b, preferred_element_type=jnp.float32)` of those VJPs:
operands in the compute dtype, f32 accumulation and f32 output.
"""

from __future__ import annotations

import torch


def ln_parts(x: torch.Tensor, eps: float):
    """→ (u, rstd): the normalized, pre-affine rows of x in f32 and 1/σ."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return xc * rstd, rstd


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as an f32 tensor, summed in f32.

    bf16 operands on the card go to cuBLAS as bf16 with an f32 output
    (`torch.mm(..., out_dtype=torch.float32)`): the tensor-core rate, and no
    bf16 rounding of the result, which is what JAX's preferred_element_type
    gives. An f32 GEMM on upcast operands would compute the same sums at the
    f32 rate (TF32 stays off), about 15× slower. On the CPU the operands are
    upcast: bf16·bf16 products are exact in f32, so that is the same sum.
    Either way the VJPs differ from oatx's only by summation order, and the
    CPU tests hold them to it at 2e-6 of each gradient's max in f32 and two
    bf16 ulps in bf16 (tests/test_torch_kernels.py)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()
