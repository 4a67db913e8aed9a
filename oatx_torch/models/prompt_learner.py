"""CoOp-style learnable prompt contexts for zero-shot classification (port
of oatx/models/prompt_learner.py).

The reference's PromptLearner (model/prompt_learner.py:9-96) is broken and
no entry point uses it; oatx has two working designs, both here:

  * class_embeddings — over the DistilBERT text tower: [CLS] ⊕ n_ctx
    learned context vectors ⊕ the class name's token embeddings, positions
    and LN as the tower's embedding path, padding name tokens masked out,
    the CLS output scores the class;
  * clip_class_embeddings — over the CLIP text tower (the upstream design):
    the learned context replaces the embeddings of the n_ctx 'X'
    placeholders at positions [1, 1 + n_ctx) of 'X … X <name>', through
    `inputs_embeds`; the EOT-pooled CLIP embedding scores the class.

The context is a plain (n_ctx, width) parameter (`PromptContext.ctx`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.losses.contrastive import l2_normalize
from oatx_torch.models import distilbert as dbert
from oatx_torch.ops.layers import embedding_lookup, layer_norm, trunc_normal_


@dataclasses.dataclass(frozen=True)
class PromptConfig:
    n_ctx: int = 8
    max_name_tokens: int = 8


class PromptContext(nn.Module):
    """n_ctx learned context vectors of width `dim`, trunc_normal(0.02)."""

    def __init__(self, dim: int, cfg: PromptConfig = PromptConfig(),
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.ctx = nn.Parameter(trunc_normal_(torch.empty(cfg.n_ctx, dim, device=device),
                                              generator))


def encode_class_names(tokenizer, class_names: Sequence[str], cfg: PromptConfig,
                       device: DeviceLike = "cpu") -> torch.Tensor:
    """Class names → (C, max_name_tokens) token ids, padded with pad_id."""
    ids = np.full((len(class_names), cfg.max_name_tokens), tokenizer.pad_id, np.int32)
    for i, name in enumerate(class_names):
        toks = tokenizer.encode(name, add_special_tokens=False)[: cfg.max_name_tokens]
        ids[i, : len(toks)] = toks
    return torch.from_numpy(ids).to(device)


def class_embeddings(ctx: torch.Tensor, text_model: dbert.DistilBert,
                     name_token_ids: torch.Tensor, cls_id: int, pad_id: int,
                     cfg: PromptConfig = PromptConfig()) -> torch.Tensor:
    """→ (num_classes, dim): [CLS] ⊕ ctx ⊕ name tokens through the tower, in
    f32, the CLS row out."""
    n_cls = name_token_ids.shape[0]
    emb = text_model.embeddings
    word = emb.word_embeddings.weight
    cls_vec = word[cls_id][None, None, :].expand(n_cls, 1, word.shape[1])
    ctx_b = ctx[None].expand(n_cls, cfg.n_ctx, word.shape[1])
    seq = torch.cat([cls_vec, ctx_b, embedding_lookup(word, name_token_ids)], dim=1)
    seq = seq + emb.position_embeddings.weight[: seq.shape[1]][None]
    x = layer_norm(seq, emb.LayerNorm.weight, emb.LayerNorm.bias, dbert.LN_EPS)
    mask = torch.cat([torch.ones(n_cls, 1 + cfg.n_ctx, dtype=torch.int32,
                                 device=name_token_ids.device),
                      (name_token_ids != pad_id).to(torch.int32)], dim=1)
    for layer in text_model.transformer.layer:
        x = layer(x, mask)
    return x[:, 0]


def clip_tokenized_prompts(clip_tokenizer, class_names: Sequence[str], n_ctx: int,
                           context_length: int = 77, device: DeviceLike = "cpu") -> torch.Tensor:
    """'X X … X <name>' per class (n_ctx placeholders whose embeddings the
    learned context replaces), tokenized and truncated to context_length."""
    prefix = " ".join(["X"] * n_ctx)
    ids = clip_tokenizer.tokenize([f"{prefix} {n}" for n in class_names],
                                  context_length=context_length, truncate=True)
    return torch.from_numpy(ids).to(device)


def clip_class_embeddings(ctx: torch.Tensor, clip_model, tokenized_prompts: torch.Tensor,
                          n_ctx: int) -> torch.Tensor:
    """→ (num_classes, embed_dim): the context over positions [1, 1 + n_ctx)
    of each prompt's token embeddings, then the CLIP text tower's
    EOT-pooled embedding. `ctx` is (n_ctx, clip width)."""
    emb = embedding_lookup(clip_model.token_embedding.weight, tokenized_prompts)
    ctx_b = ctx[None].expand(emb.shape[0], n_ctx, emb.shape[-1]).to(emb.dtype)
    emb = torch.cat([emb[:, :1], ctx_b, emb[:, 1 + n_ctx:]], dim=1)
    return clip_model.encode_text(tokenized_prompts, inputs_embeds=emb)


def classify(image_embeds: torch.Tensor, class_embeds: torch.Tensor,
             temperature: float = 0.05) -> torch.Tensor:
    """Cosine-similarity logits (B, num_classes) / temperature."""
    return (l2_normalize(image_embeds) @ l2_normalize(class_embeds).T) / temperature
