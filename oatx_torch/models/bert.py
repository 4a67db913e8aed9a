"""BERT text tower, forward (port of oatx/models/bert.py; the reference's
`text_params.model: bert-base-uncased`, pooled by BertModel's pooler,
model.py:104-106).

Word + position + token-type embeddings with LayerNorm(eps=1e-12) in f32,
then cast to the compute dtype (:98-102); post-LN layers (self-attention →
Add & LN → intermediate GELU → output → Add & LN) with separate q/k/v
projections, q pre-scaled, masked logits filled with finfo(f32).min (:65-76);
the tanh pooler over the CLS row in f32 (:113). Parameter names follow HF
`BertModel` (`embeddings.*`, `encoder.layer.N.*`, `pooler.dense`), so a
reference state_dict loads strictly under `text_model.`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.models.distilbert import _Table
from oatx_torch.ops.attention import attend
from oatx_torch.ops.layers import LayerNorm, Linear, embedding_lookup, gelu, layer_norm, \
    linear

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dim: int = 768
    hidden_dim: int = 3072
    n_layers: int = 12
    n_heads: int = 12
    scan_layers: bool = False


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.word_embeddings = _Table(cfg.vocab_size, cfg.dim, device, generator)
        self.position_embeddings = _Table(cfg.max_position_embeddings, cfg.dim, device,
                                          generator)
        self.token_type_embeddings = _Table(cfg.type_vocab_size, cfg.dim, device, generator)
        self.LayerNorm = LayerNorm(cfg.dim, LN_EPS, device)


class SelfAttention(nn.Module):
    def __init__(self, d: int, device, generator):
        super().__init__()
        self.query = Linear(d, d, device, generator)
        self.key = Linear(d, d, device, generator)
        self.value = Linear(d, d, device, generator)


class _Dense(nn.Module):
    """`dense` (+ `LayerNorm`): HF's BertSelfOutput / BertIntermediate /
    BertOutput / BertPooler containers."""

    def __init__(self, d_in: int, d_out: int, device, generator, ln: bool):
        super().__init__()
        self.dense = Linear(d_in, d_out, device, generator)
        if ln:
            self.LayerNorm = LayerNorm(d_out, LN_EPS, device)


class Attention(nn.Module):
    def __init__(self, d: int, device, generator):
        super().__init__()
        self.self = SelfAttention(d, device, generator)
        self.output = _Dense(d, d, device, generator, ln=True)


class Layer(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.attention = Attention(cfg.dim, device, generator)
        self.intermediate = _Dense(cfg.dim, cfg.hidden_dim, device, generator, ln=False)
        self.output = _Dense(cfg.hidden_dim, cfg.dim, device, generator, ln=True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, n_heads: int) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // n_heads
        sa = self.attention.self
        q = sa.query(x).reshape(b, t, n_heads, dh) * (dh ** -0.5)
        k = sa.key(x).reshape(b, t, n_heads, dh)
        v = sa.value(x).reshape(b, t, n_heads, dh)
        a = self.attention.output.dense(attend(q, k, v, x.dtype, mask).reshape(b, t, d))
        x = self.attention.output.LayerNorm(x + a)
        f = self.output.dense(gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + f)


class Encoder(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg, device, generator) for _ in range(cfg.n_layers))


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError("BertConfig.scan_layers is not ported")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, device, generator)
        self.encoder = Encoder(cfg, device, generator)
        self.pooler = _Dense(cfg.dim, cfg.dim, device, generator, ln=False)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (last_hidden_state (B, T, D) in `dtype`, pooler_output (B, D) f32)."""
        b, t = input_ids.shape
        if t > self.cfg.max_position_embeddings:
            raise ValueError(f"sequence length {t} > max_position_embeddings "
                             f"{self.cfg.max_position_embeddings}")
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.embeddings
        x = (embedding_lookup(emb.word_embeddings.weight, input_ids)
             + emb.position_embeddings.weight[:t][None]
             + embedding_lookup(emb.token_type_embeddings.weight, token_type_ids))
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, LN_EPS).to(dtype)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask, self.cfg.n_heads)
        pd = self.pooler.dense
        pooled = torch.tanh(linear(x[:, 0].float(), pd.weight, pd.bias))
        return x, pooled
