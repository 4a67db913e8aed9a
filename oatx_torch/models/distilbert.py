"""DistilBERT text tower, forward (port of oatx/models/distilbert.py:24-117).

Learned word + position embeddings with LayerNorm(eps=1e-12) in f32, then
cast to the compute dtype (:104-106); post-LN transformer layers (MHA →
residual → LN → FFN(GELU) → residual → LN) with separate q/k/v/out
projections; attention mask with 1 = attend, masked logits filled with
finfo(f32).min (:74-77). Parameter names follow HF DistilBertModel
(`embeddings.*`, `transformer.layer.N.*`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.ops.attention import attend
from oatx_torch.ops.layers import LayerNorm, Linear, embedding_lookup, gelu, \
    layer_norm, trunc_normal_

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    dim: int = 768
    hidden_dim: int = 3072
    n_layers: int = 6
    n_heads: int = 12
    scan_layers: bool = False


class _Table(nn.Module):
    def __init__(self, rows: int, dim: int, device, generator):
        super().__init__()
        self.weight = nn.Parameter(trunc_normal_(
            torch.empty(rows, dim, device=device), generator))


class Embeddings(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device, generator):
        super().__init__()
        self.word_embeddings = _Table(cfg.vocab_size, cfg.dim, device, generator)
        self.position_embeddings = _Table(cfg.max_position_embeddings, cfg.dim,
                                          device, generator)
        self.LayerNorm = LayerNorm(cfg.dim, LN_EPS, device)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device, generator):
        super().__init__()
        self.n_heads = cfg.n_heads
        d = cfg.dim
        self.q_lin = Linear(d, d, device, generator)
        self.k_lin = Linear(d, d, device, generator)
        self.v_lin = Linear(d, d, device, generator)
        self.out_lin = Linear(d, d, device, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.n_heads
        q = self.q_lin(x).reshape(b, t, self.n_heads, dh) * (dh ** -0.5)
        k = self.k_lin(x).reshape(b, t, self.n_heads, dh)
        v = self.v_lin(x).reshape(b, t, self.n_heads, dh)
        out = attend(q, k, v, x.dtype, mask)
        return self.out_lin(out.reshape(b, t, d))


class FFN(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device, generator):
        super().__init__()
        self.lin1 = Linear(cfg.dim, cfg.hidden_dim, device, generator)
        self.lin2 = Linear(cfg.hidden_dim, cfg.dim, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(gelu(self.lin1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device, generator):
        super().__init__()
        self.attention = MultiHeadSelfAttention(cfg, device, generator)
        self.sa_layer_norm = LayerNorm(cfg.dim, LN_EPS, device)
        self.ffn = FFN(cfg, device, generator)
        self.output_layer_norm = LayerNorm(cfg.dim, LN_EPS, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.sa_layer_norm(x + self.attention(x, mask))
        return self.output_layer_norm(x + self.ffn(x))


class Transformer(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device, generator):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerBlock(cfg, device, generator) for _ in range(cfg.n_layers))


class DistilBert(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError("DistilBertConfig.scan_layers is not ported")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, device, generator)
        self.transformer = Transformer(cfg, device, generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """→ last_hidden_state (B, T, D); the CLS embedding is [:, 0]."""
        b, t = input_ids.shape
        if t > self.cfg.max_position_embeddings:
            raise ValueError(f"sequence length {t} > max_position_embeddings "
                             f"{self.cfg.max_position_embeddings}")
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        emb = self.embeddings
        x = embedding_lookup(emb.word_embeddings.weight, input_ids) \
            + emb.position_embeddings.weight[:t][None]
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, LN_EPS).to(dtype)
        for layer in self.transformer.layer:
            x = layer(x, attention_mask)
        return x

