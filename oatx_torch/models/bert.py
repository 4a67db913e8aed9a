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

Tensor parallelism (parallel/tensor.py, `enable_model_parallel`; oatx's
Megatron rules on its `attn.q/k/v`, `attn.out`, `intermediate` and `output`
kernels, oatx/parallel/sharding.py:23-42): each layer runs its rank's heads
(`query` / `key` / `value` rows, each its own D rows, so a rank's D/mp rows
are whole heads; `attention.output.dense` columns) and its rows of the
intermediate width (`intermediate.dense` rows, `output.dense` columns)
between the model group's copy / all-reduce pair; the row-parallel biases
are added once after the sum, and both post-LNs read the whole sum, so
their gradients are whole on every rank. The word table is split by
vocabulary rows where the vocabulary divides by the group's width (30522
does at 2, not at 4) and looked up vocabulary-parallel before the
embedding LN; the position and token-type tables and the tanh pooler stay
whole. The column-parallel biases are the gradients a rank holds in part
(`tp_partial_params`).
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
from oatx_torch.parallel import tensor as tpl

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
    tp: Optional[tpl.ModelAxis] = None

    def __init__(self, d: int, device, generator):
        super().__init__()
        self.self = SelfAttention(d, device, generator)
        self.output = _Dense(d, d, device, generator, ln=True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, n_heads: int) -> torch.Tensor:
        """Self-attention → Add & LN."""
        b, t, d = x.shape
        dh = d // n_heads
        axis = self.tp
        y = x if axis is None else tpl.enter(axis, x, t)
        heads = n_heads if axis is None else axis.heads(n_heads)

        def project(lin):
            bias = lin.bias if axis is None else tpl.local_rows(lin.bias, axis)
            return linear(y, lin.weight, bias).reshape(b, t, heads, dh)

        sa, dense = self.self, self.output.dense
        q = project(sa.query) * (dh ** -0.5)
        out = attend(q, project(sa.key), project(sa.value), x.dtype, mask).reshape(b, t, -1)
        a = dense(out) if axis is None else \
            tpl.leave(axis, linear(out, dense.weight)) + dense.bias.to(x.dtype)
        return self.output.LayerNorm(x + a)


class Layer(nn.Module):
    tp: Optional[tpl.ModelAxis] = None  # the feed-forward sublayer's

    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.attention = Attention(cfg.dim, device, generator)
        self.intermediate = _Dense(cfg.dim, cfg.hidden_dim, device, generator, ln=False)
        self.output = _Dense(cfg.hidden_dim, cfg.dim, device, generator, ln=True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, n_heads: int) -> torch.Tensor:
        x = self.attention(x, mask, n_heads)
        fc1, fc2, axis = self.intermediate.dense, self.output.dense, self.tp
        if axis is None:
            f = fc2(gelu(fc1(x)))
        else:
            h = gelu(linear(tpl.enter(axis, x, x.shape[1]), fc1.weight,
                            tpl.local_rows(fc1.bias, axis)))
            f = tpl.leave(axis, linear(h, fc2.weight)) + fc2.bias.to(x.dtype)
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
        word = emb.word_embeddings
        x = ((embedding_lookup(word.weight, input_ids) if word.tp is None
              else tpl.vocab_lookup(word.weight, input_ids, word.tp))
             + emb.position_embeddings.weight[:t][None]
             + embedding_lookup(emb.token_type_embeddings.weight, token_type_ids))
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, LN_EPS).to(dtype)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask, self.cfg.n_heads)
        pd = self.pooler.dense
        pooled = torch.tanh(linear(x[:, 0].float(), pd.weight, pd.bias))
        return x, pooled

    def enable_model_parallel(self, axis: tpl.ModelAxis, split) -> None:
        """Run the layers tensor-parallel over `axis` (module docstring).
        `split`: the names (under this module) of the parameters
        parallel/sharding.py splits: every layer's query / key / value /
        attention.output / intermediate / output dense weights, and the word
        table where the vocabulary divides."""
        cfg = self.cfg
        want = [f"encoder.layer.{i}.{m}.weight" for i in range(cfg.n_layers)
                for m in ("attention.self.query", "attention.self.key",
                          "attention.self.value", "attention.output.dense",
                          "intermediate.dense", "output.dense")]
        axis = tpl.layer_axis(axis, cfg.n_heads, "BERT", want, split)
        for layer in self.encoder.layer:
            layer.attention.tp = layer.tp = axis
        if "embeddings.word_embeddings.weight" in split:
            self.embeddings.word_embeddings.tp = axis

    def tp_partial_params(self):
        """The column-parallel biases, whose gradient each rank holds in part
        (the post-LNs read the whole sum after `leave`: whole on every rank)."""
        return [lin.bias for layer in self.encoder.layer
                for lin in (layer.attention.self.query, layer.attention.self.key,
                            layer.attention.self.value, layer.intermediate.dense)]
