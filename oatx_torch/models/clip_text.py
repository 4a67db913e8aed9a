"""CLIP text transformer, forward (port of oatx/models/clip_text.py; the
reference's vendored CLIP text side, `clip/model.py:160-363`, the encoder
of the region-memory bank and of CoOp prompts).

    token embedding + learned positional embedding (context 77)
    pre-LN blocks (LN eps 1e-5): x += MHA(ln_1(x)) under an additive f32
        causal mask (finfo.min above the diagonal), softmax in f32;
        x += c_proj(QuickGELU(c_fc(ln_2(x)))), QuickGELU = x·σ(1.702x)
    ln_final, then
        encode_text         the EOT row (argmax of the ids: <|endoftext|>
                            has the highest id) @ text_projection → (B, E)
        encode_text_tokens  every row @ text_projection, L2-normalized
`attention_mask` has no part: the mask is causal. `inputs_embeds` replaces
the token lookup (CoOp splices learned context vectors, :121-141).

Parameter names follow the vendored CLIP's text side (`token_embedding`,
`positional_embedding`, `transformer.resblocks.N.{ln_1, attn.in_proj_weight,
attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`,
`text_projection` used as x @ W), so oatx's export (convert.py:277-300)
loads strictly under `text_model.`.

Tensor parallelism (parallel/tensor.py, `enable_model_parallel`; oatx's
Megatron rules on its `attn.qkv`, `attn.out`, `mlp.fc1` and `mlp.fc2`
kernels, oatx/parallel/sharding.py:23-42): each block runs its rank's
heads under the causal mask and its rows of the 4·W hidden width between
the model group's copy / all-reduce pair. The packed `in_proj_weight`
(3W, W) splits by whole heads, the rank's rows of each of q, k and v
(`groups` = 3, as the ViT's fused qkv: oatx's contiguous split holds the
same bytes, other rows); `out_proj` and `mlp.c_proj` take their input
columns, their biases added once after the sum; `mlp.c_fc` its output
rows. `ln_1` / `ln_2` run on the whole stream before the copy, so their
gradients are whole; `token_embedding` (not named `word` in oatx),
`positional_embedding`, `ln_final`, the EOT pick and `text_projection`
stay whole. The column-parallel biases are the gradients a rank holds in
part (`tp_partial_params`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.ops.layers import LayerNorm, Linear, embedding_lookup, layer_norm, linear
from oatx_torch.parallel import tensor as tpl

LN_EPS = 1e-5  # torch nn.LayerNorm's default (the vendored LayerNorm)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512
    scan_layers: bool = False


def _normal(shape, std: float, device, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, device=device, generator=generator) * std)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x · σ(1.702x) (model.py:160-162), not the exact-erf GELU of the ViT."""
    return x * torch.sigmoid(1.702 * x)


class _Table(nn.Module):
    def __init__(self, rows: int, dim: int, std: float, device, generator):
        super().__init__()
        self.weight = _normal((rows, dim), std, device, generator)


class CausalAttention(nn.Module):
    """torch MultiheadAttention's packed layout: in_proj_weight (3D, D) rows
    [q; k; v], out_proj."""
    tp: Optional[tpl.ModelAxis] = None

    def __init__(self, cfg: ClipTextConfig, device, generator):
        super().__init__()
        d = cfg.width
        self.in_proj_weight = _normal((3 * d, d), d ** -0.5, device, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d, device=device))
        self.out_proj = Linear(d, d, device, generator)
        with torch.no_grad():
            self.out_proj.weight.normal_(0.0, (d ** -0.5) * ((2 * cfg.layers) ** -0.5),
                                         generator=generator)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // heads
        axis, bias, y = self.tp, self.in_proj_bias, x
        if axis is not None:
            y, bias, heads = tpl.enter(axis, x, t), tpl.local_rows(bias, axis, 3), \
                axis.heads(heads)
        qkv = linear(y, self.in_proj_weight, bias).reshape(b, t, 3, heads, dh)
        q, k, v = qkv[:, :, 0] * (dh ** -0.5), qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
        p = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(x.dtype)
        if axis is None:
            return self.out_proj(out.reshape(b, t, d))
        return tpl.leave(axis, linear(out.reshape(b, t, -1), self.out_proj.weight)) \
            + self.out_proj.bias.to(x.dtype)


class Mlp(nn.Module):
    tp: Optional[tpl.ModelAxis] = None

    def __init__(self, cfg: ClipTextConfig, device, generator):
        super().__init__()
        d = cfg.width
        self.c_fc = Linear(d, 4 * d, device, generator)
        self.c_proj = Linear(4 * d, d, device, generator)
        with torch.no_grad():
            self.c_fc.weight.normal_(0.0, (2 * d) ** -0.5, generator=generator)
            self.c_proj.weight.normal_(0.0, (d ** -0.5) * ((2 * cfg.layers) ** -0.5),
                                       generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.tp
        if axis is None:
            return self.c_proj(quick_gelu(self.c_fc(x)))
        h = quick_gelu(linear(tpl.enter(axis, x, x.shape[1]), self.c_fc.weight,
                              tpl.local_rows(self.c_fc.bias, axis)))
        return tpl.leave(axis, linear(h, self.c_proj.weight)) + self.c_proj.bias.to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device, generator):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width, LN_EPS, device)
        self.attn = CausalAttention(cfg, device, generator)
        self.ln_2 = LayerNorm(cfg.width, LN_EPS, device)
        self.mlp = Mlp(cfg, device, generator)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), heads)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device, generator):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(cfg, device, generator)
                                       for _ in range(cfg.layers))


class ClipText(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError("ClipTextConfig.scan_layers is not ported")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        d = cfg.width
        self.token_embedding = _Table(cfg.vocab_size, d, 0.02, device, generator)
        self.positional_embedding = _normal((cfg.context_length, d), 0.01, device, generator)
        self.transformer = Transformer(cfg, device, generator)
        self.ln_final = LayerNorm(d, LN_EPS, device)
        self.text_projection = _normal((d, cfg.embed_dim), d ** -0.5, device, generator)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype = torch.float32,
                inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """→ ln_final hidden states (B, T, width) in `dtype`."""
        t = ids.shape[1]
        if t > self.cfg.context_length:
            raise ValueError(f"sequence length {t} > context_length {self.cfg.context_length}")
        x = embedding_lookup(self.token_embedding.weight, ids) if inputs_embeds is None \
            else inputs_embeds
        x = (x + self.positional_embedding[:t][None]).to(dtype)
        for block in self.transformer.resblocks:
            x = block(x, self.cfg.heads)
        return layer_norm(x, self.ln_final.weight, self.ln_final.bias, LN_EPS)

    def encode_text(self, ids: torch.Tensor, dtype: torch.dtype = torch.float32,
                    inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The EOT row @ text_projection → (B, embed_dim) in `dtype`."""
        h = self(ids, dtype, inputs_embeds)
        pooled = h[torch.arange(h.shape[0], device=h.device), ids.argmax(dim=-1)]
        return pooled @ self.text_projection.to(pooled.dtype)

    def encode_text_tokens(self, ids: torch.Tensor,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Every row @ text_projection, L2-normalized → (B, T, embed_dim)."""
        h = self(ids, dtype)
        x = h @ self.text_projection.to(h.dtype)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def enable_model_parallel(self, axis: tpl.ModelAxis, split) -> None:
        """Run the blocks tensor-parallel over `axis` (module docstring).
        `split`: the names (under this module) of the parameters
        parallel/sharding.py splits: every block's in_proj_weight, out_proj,
        c_fc and c_proj weights."""
        cfg = self.cfg
        want = [f"transformer.resblocks.{i}.{m}" for i in range(cfg.layers)
                for m in ("attn.in_proj_weight", "attn.out_proj.weight", "mlp.c_fc.weight",
                          "mlp.c_proj.weight")]
        axis = tpl.layer_axis(axis, cfg.heads, "CLIP text", want, split)
        for block in self.transformer.resblocks:
            block.attn.tp = block.mlp.tp = axis

    def tp_partial_params(self):
        """The column-parallel biases, whose gradient each rank holds in part."""
        return [p for block in self.transformer.resblocks
                for p in (block.attn.in_proj_bias, block.mlp.c_fc.bias)]
