"""Attention ops (port of oatx/ops/attention.py:82-217).

One formulation, the reference's CLS-first token order:
  * qkv = Linear(x); heads split head-major from the fused 3·D output; q
    pre-scaled by Dh^-0.5 (`qkv_heads`, oatx `_qkv` :82-99). Given LN params,
    x is the pre-norm stream and LN→qkv runs as kernel 3
    (ops/kernels/ln_linear.py), oatx's `fused_qkv` path;
  * `full_attention`: (B, T) mask with 1 = attend, masked logits filled with
    finfo(f32).min, softmax in f32, p cast to the compute dtype before P·V
    (:102-115);
  * `divided_attention`: the CLS row attends over all T tokens; `space`
    groups are frames (kernel 2, ops/kernels/space_attention.py), `time`
    groups are patch positions over [CLS] + F frames (plain PyTorch — oatx's
    N-minor transpose at :186-211 is a TPU tiling choice; this ports the math).

oatx's `cls_position`, `split_cls_stream`, the stream/concat CLS merge and the
`nminor` layout are layout choices with unchanged outputs; the port has none
of them.

Under tensor parallelism (parallel/tensor.py) the same functions run on a
rank's heads: `num_heads` is the local count, the qkv weight holds those
heads' q, k and v rows, the head width comes from the weight, and the
output projection gets the rank's input columns and no bias (the caller
adds it once, after the model group's sum).
"""

from __future__ import annotations

from typing import Optional

import torch

from oatx_torch.ops.kernels.ln_linear import ln_linear
from oatx_torch.ops.kernels.space_attention import space_attention
from oatx_torch.ops.layers import linear


def qkv_heads(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              num_heads: int, ln_w: Optional[torch.Tensor] = None,
              ln_b: Optional[torch.Tensor] = None, ln_eps: float = 1e-6):
    """(B, T, D) → q, k, v each (B, T, H, Dh), Dh = rows of `weight` / 3H;
    q pre-scaled (a new tensor),
    k and v views into the fused qkv output. With `ln_w`/`ln_b`, x is the
    pre-norm stream and qkv = ln_linear(x) (bias added in f32, as oatx's
    ln_linear does; plain `linear` adds it in the compute dtype)."""
    b, t = x.shape[:2]
    dh = weight.shape[0] // (3 * num_heads)
    if ln_w is not None:
        qkv = ln_linear(x, ln_w, ln_b, weight, bias, ln_eps)
    else:
        qkv = linear(x, weight, bias)
    qkv = qkv.reshape(b, t, 3, num_heads, dh)
    return qkv[:, :, 0] * (dh ** -0.5), qkv[:, :, 1], qkv[:, :, 2]


def attend(q, k, v, dt, mask: Optional[torch.Tensor] = None):
    """softmax(q·kᵀ) v over the second axis of (B, T, H, Dh) tensors: f32
    logits and softmax, p rounded to `dt`, f32 accumulation, `dt` output."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(~mask[:, None, None, :].bool(), neg)
    p = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dt)


def full_attention(x: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b, num_heads: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard MHA over the full sequence; mask (B, T) with 1 = attend."""
    q, k, v = qkv_heads(x, qkv_w, qkv_b, num_heads)
    out = attend(q, k, v, x.dtype, mask)
    return linear(out.reshape(*x.shape[:2], -1), proj_w, proj_b)


def time_attention(q, k, v, num_frames: int) -> torch.Tensor:
    """Divided time attention on (B, T, H, Dh), CLS first: the CLS row over
    all T keys, each patch position over [CLS] + its F frame keys."""
    b, t, h, dh = q.shape
    f = num_frames
    n = (t - 1) // f
    dt = q.dtype
    cls_out = attend(q[:, :1], k, v, dt)
    qp = q[:, 1:].reshape(b, f, n, h, dh)
    kg = torch.cat([k[:, None, :1].expand(b, 1, n, h, dh),
                    k[:, 1:].reshape(b, f, n, h, dh)], dim=1)  # (B, F+1, N, H, Dh)
    vg = torch.cat([v[:, None, :1].expand(b, 1, n, h, dh),
                    v[:, 1:].reshape(b, f, n, h, dh)], dim=1)
    logits = torch.einsum("bqnhd,bknhd->bnhqk", qp.float(), kg.float())
    p = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bnhqk,bknhd->bqnhd", p.float(), vg.float()).to(dt)
    return torch.cat([cls_out, out.reshape(b, f * n, h, dh)], dim=1)


def divided_attention(x: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
                      num_heads: int, num_frames: int, mode: str,
                      ln_w: Optional[torch.Tensor] = None,
                      ln_b: Optional[torch.Tensor] = None,
                      ln_eps: float = 1e-6) -> torch.Tensor:
    """One VarAttention pass over x (B, 1 + F·N, D), CLS first, with grouping
    `mode` ∈ {'space', 'time'}. With LN params x is pre-norm and the LN runs
    inside the qkv projection (kernel 3)."""
    b, t = x.shape[:2]
    f = num_frames
    if f < 1 or (t - 1) % f:
        raise ValueError(f"token count {t} incompatible with {f} frames")
    q, k, v = qkv_heads(x, qkv_w, qkv_b, num_heads, ln_w, ln_b, ln_eps)
    if mode == "space":
        out = space_attention(q, k, v, f)
    elif mode == "time":
        out = time_attention(q, k, v, f)
    else:
        raise ValueError(f"mode must be 'space' or 'time', got {mode!r}")
    return linear(out.reshape(b, t, -1), proj_w, proj_b)
