"""DistilBERT text tower, forward (port of oatx/models/distilbert.py:24-117).

Learned word + position embeddings with LayerNorm(eps=1e-12) in f32, then
cast to the compute dtype (:104-106); post-LN transformer layers (MHA →
residual → LN → FFN(GELU) → residual → LN) with separate q/k/v/out
projections; attention mask with 1 = attend, masked logits filled with
finfo(f32).min (:74-77). Parameter names follow HF DistilBertModel
(`embeddings.*`, `transformer.layer.N.*`).

Tensor parallelism (parallel/tensor.py, `enable_model_parallel`): each
layer runs its rank's heads (q_lin / k_lin / v_lin rows, out_lin columns)
and its rows of the FFN's hidden width (lin1 rows, lin2 columns) between
the model group's copy / all-reduce pair; the post-LNs (`sa_layer_norm`,
`output_layer_norm`) run on the whole, replicated stream. The word table is
split by vocabulary rows where the vocabulary divides by the group's width
(30522 does at 2, not at 4), and then looked up vocabulary-parallel. The
column-parallel biases stay whole and their gradients are summed over the
group after the backward (`tp_partial_params`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.ops.attention import attend
from oatx_torch.ops.layers import LayerNorm, Linear, embedding_lookup, gelu, \
    layer_norm, linear, trunc_normal_
from oatx_torch.parallel import tensor as tpl

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
    tp: Optional[tpl.ModelAxis] = None  # set when the rows are split over a model axis

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
    tp: Optional[tpl.ModelAxis] = None

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
        axis = self.tp
        if axis is not None:
            x = tpl.enter(axis, x, t)
        heads = self.n_heads if axis is None else axis.heads(self.n_heads)

        def project(lin):
            bias = lin.bias if axis is None else tpl.local_rows(lin.bias, axis)
            return linear(x, lin.weight, bias).reshape(b, t, heads, dh)

        q = project(self.q_lin) * (dh ** -0.5)
        out = attend(q, project(self.k_lin), project(self.v_lin), x.dtype, mask)
        if axis is None:
            return self.out_lin(out.reshape(b, t, d))
        return tpl.leave(axis, linear(out.reshape(b, t, -1), self.out_lin.weight)) \
            + self.out_lin.bias.to(x.dtype)


class FFN(nn.Module):
    tp: Optional[tpl.ModelAxis] = None

    def __init__(self, cfg: DistilBertConfig, device, generator):
        super().__init__()
        self.lin1 = Linear(cfg.dim, cfg.hidden_dim, device, generator)
        self.lin2 = Linear(cfg.hidden_dim, cfg.dim, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.tp
        if axis is None:
            return self.lin2(gelu(self.lin1(x)))
        h = gelu(linear(tpl.enter(axis, x, x.shape[1]), self.lin1.weight,
                        tpl.local_rows(self.lin1.bias, axis)))
        return tpl.leave(axis, linear(h, self.lin2.weight)) + self.lin2.bias.to(x.dtype)


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
        word = emb.word_embeddings
        x = (embedding_lookup(word.weight, input_ids) if word.tp is None
             else tpl.vocab_lookup(word.weight, input_ids, word.tp)) \
            + emb.position_embeddings.weight[:t][None]
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, LN_EPS).to(dtype)
        for layer in self.transformer.layer:
            x = layer(x, attention_mask)
        return x


    def enable_model_parallel(self, axis: tpl.ModelAxis, split) -> None:
        """Run the layers tensor-parallel over `axis` (module docstring).
        `split`: the names (under this module) of the parameters
        parallel/sharding.py splits: every layer's q/k/v/out_lin and
        lin1/lin2 weights, and the word table where the vocabulary divides."""
        cfg = self.cfg
        if cfg.n_heads % axis.size:
            raise ValueError(f"model_parallel={axis.size} does not divide DistilBERT's "
                             f"{cfg.n_heads} heads")
        want = [f"transformer.layer.{i}.{m}.weight" for i in range(cfg.n_layers)
                for m in ("attention.q_lin", "attention.k_lin", "attention.v_lin",
                          "attention.out_lin", "ffn.lin1", "ffn.lin2")]
        missing = [n for n in want if n not in split]
        if missing:
            raise ValueError(f"model_parallel={axis.size} does not divide the widths of "
                             f"{missing[:3]}")
        axis = dataclasses.replace(axis, sequence_parallel=False)
        for layer in self.transformer.layer:
            layer.attention.tp = layer.ffn.tp = axis
        if "embeddings.word_embeddings.weight" in split:
            self.embeddings.word_embeddings.tp = axis

    def tp_partial_params(self):
        """The column-parallel biases, whose gradient each rank holds in part."""
        return [lin.bias for layer in self.transformer.layer
                for lin in (layer.attention.q_lin, layer.attention.k_lin,
                            layer.attention.v_lin, layer.ffn.lin1)]
