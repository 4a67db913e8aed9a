"""Object-feature tower: BUTD region features → the shared space's input
(port of oatx/models/object_tower.py:34-116).

The reference's `compute_object` (oa_model.py:125-127) calls an
`object_model` that is never assigned; oatx's working design, which this
ports: a small pre-LN transformer encoder over (B, K, 2054) features
(2048-d ROI appearance + 6-d box geometry, data/objects.py), all-zero slots
masked out of attention and pooling, then attention pooling against a
learned query.

    mask   rows whose max |x| > 0, taken after the cast to the compute dtype
           (:89-90); a sample with no object at all unmasks its zero rows so
           no attention row is fully masked (:92-94)
    embed  Linear 2054 → dim, LN (eps 1e-6)
    layers x += MHA(LN(x)) with the (B, K) key mask (full_attention: masked
           logits filled with f32 finfo.min, softmax in f32); x += MLP(LN(x))
    pool   LN, then logits = x · q / √dim in the compute dtype, masked with
           f32 finfo.min, softmax in f32, cast back, Σ_k w_k x_k (:105-116)

K ≤ 10 slots: negligible compute, plain PyTorch (oatx runs it on XLA).
Parameter names mirror oatx's tree (`embed`, `embed_norm`, `layers.N.{norm1,
norm2,attn.qkv,attn.proj,mlp.fc1,mlp.fc2}`, `norm`, `pool_query`); the
reference has no schema for it.

Tensor parallelism (parallel/tensor.py, `enable_model_parallel`; oatx's
Megatron rules on these names, oatx/parallel/sharding.py:23-42): each layer
runs its rank's heads (`attn.qkv` rows of whole heads, q, k and v each,
`groups` = 3; `attn.proj` input columns) and its rows of the hidden width
(`mlp.fc1` rows, `mlp.fc2` columns) between the model group's copy /
all-reduce pair, the row-parallel biases added once after the sum. The
pre-LNs run on the whole stream before the copy; the slot mask, `embed`,
the norms and the attention pooling on `pool_query` stay whole. The
column-parallel biases are the gradients a rank holds in part
(`tp_partial_params`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.ops.attention import full_attention
from oatx_torch.ops.layers import LayerNorm, Linear, layer_norm, mlp, trunc_normal_
from oatx_torch.parallel import tensor as tpl

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ObjectTowerConfig:
    feature_dim: int = 2054     # 2048 ROI + 6 box geometry
    dim: int = 512
    n_layers: int = 2
    n_heads: int = 8
    hidden_dim: int = 1024
    top_k: int = 10             # max objects per sample


class _Attention(nn.Module):
    def __init__(self, d: int, device, generator):
        super().__init__()
        self.qkv = Linear(d, 3 * d, device, generator)
        self.proj = Linear(d, d, device, generator)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, device, generator):
        super().__init__()
        self.fc1 = Linear(d, hidden, device, generator)
        self.fc2 = Linear(hidden, d, device, generator)


class _Layer(nn.Module):
    tp: Optional[tpl.ModelAxis] = None

    def __init__(self, cfg: ObjectTowerConfig, device, generator):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, LN_EPS, device)
        self.norm2 = LayerNorm(cfg.dim, LN_EPS, device)
        self.attn = _Attention(cfg.dim, device, generator)
        self.mlp = _Mlp(cfg.dim, cfg.hidden_dim, device, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
        a, m, axis = self.attn, self.mlp, self.tp
        if axis is None:
            x = x + full_attention(self.norm1(x), a.qkv.weight, a.qkv.bias, a.proj.weight,
                                   a.proj.bias, heads, mask=mask)
            return x + mlp(self.norm2(x), m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)
        t = x.shape[1]
        part = full_attention(tpl.enter(axis, self.norm1(x), t), a.qkv.weight,
                              tpl.local_rows(a.qkv.bias, axis, 3), a.proj.weight, None,
                              axis.heads(heads), mask=mask)
        x = x + (tpl.leave(axis, part) + a.proj.bias.to(x.dtype))
        part = mlp(tpl.enter(axis, self.norm2(x), t), m.fc1.weight,
                   tpl.local_rows(m.fc1.bias, axis), m.fc2.weight, None)
        return x + (tpl.leave(axis, part) + m.fc2.bias.to(x.dtype))


class ObjectTower(nn.Module):
    def __init__(self, cfg: ObjectTowerConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        self.embed = Linear(cfg.feature_dim, cfg.dim, device, generator)
        self.embed_norm = LayerNorm(cfg.dim, LN_EPS, device)
        self.layers = nn.ModuleList(_Layer(cfg, device, generator)
                                    for _ in range(cfg.n_layers))
        self.norm = LayerNorm(cfg.dim, LN_EPS, device)
        self.pool_query = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, cfg.dim, device=device), generator))

    def forward(self, objects: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """objects (B, K, feature_dim) → pooled (B, dim) in `dtype`."""
        x = objects.to(dtype)
        mask = (x.abs().amax(dim=-1) > 0).to(torch.int32)                # (B, K)
        empty = (mask.sum(dim=-1, keepdim=True) == 0).to(torch.int32)
        mask = torch.maximum(mask, empty)
        x = layer_norm(self.embed(x), self.embed_norm.weight, self.embed_norm.bias, LN_EPS)
        for layer in self.layers:
            x = layer(x, mask, self.cfg.n_heads)
        x = self.norm(x)
        logits = torch.einsum("bkd,d->bk", x, self.pool_query.to(x.dtype)[0, 0]) \
            / (self.cfg.dim ** 0.5)
        logits = logits.float().masked_fill(mask == 0, torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.einsum("bk,bkd->bd", w, x)

    def enable_model_parallel(self, axis: tpl.ModelAxis, split) -> None:
        """Run the layers tensor-parallel over `axis` (module docstring).
        `split`: the names (under this module) of the parameters
        parallel/sharding.py splits: every layer's qkv, proj, fc1 and fc2
        weights."""
        cfg = self.cfg
        want = [f"layers.{i}.{m}.weight" for i in range(cfg.n_layers)
                for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")]
        axis = tpl.layer_axis(axis, cfg.n_heads, "the object tower", want, split)
        for layer in self.layers:
            layer.tp = axis

    def tp_partial_params(self):
        """The column-parallel biases, whose gradient each rank holds in part."""
        return [p for layer in self.layers for p in (layer.attn.qkv.bias, layer.mlp.fc1.bias)]
