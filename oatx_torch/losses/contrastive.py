"""Contrastive losses (port of oatx/losses/contrastive.py:29-251).

  * `l2_normalize`, `sim_matrix` — cosine similarities with the norm clamped
    at eps (:29-39);
  * `norm_softmax_loss` — the symmetric InfoNCE of the reference's
    NormSoftmaxLoss, in f32, over the min(N, M) diagonal (:42-51);
  * `norm_softmax_loss_global` — the same over every rank's embeddings,
    gathered by parallel/collectives.all_gather_rows (:54-70);
  * `norm_softmax_loss_chunked` — the same loss from the embeddings, key
    chunk by key chunk with a running logsumexp, so the full matrix never
    exists (:74-130);
  * `max_margin_ranking_loss` — the bidirectional hinge (:133-148);
  * the object-aware variants' losses (:151-251): cross entropy, NCE with
    the positive at column 0, softmax KL / MSE consistency, BCE on
    probabilities and on logits, `region_bce` (summed over patches, mean
    over (batch, region) rows), the MoCo queue as an explicit state object,
    and the fine-grained region ↔ tag NCE that global_local trains with.

All in f32. Under data parallelism train/step.py gathers each loss's
inputs across the ranks before calling these (global negatives).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from oatx_torch.parallel.collectives import all_gather_rows


def l2_normalize(x: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    """x / max(‖x‖, eps)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarities between the rows of a (N, D) and b (M, D) → (N, M),
    summed in f32."""
    return l2_normalize(a, eps).float() @ l2_normalize(b, eps).float().t()


def norm_softmax_loss(sims: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """−mean diag of the row log-softmax − mean diag of the column
    log-softmax of sims / temperature, in f32."""
    s = sims.float() / temperature
    n = min(s.shape)
    loss_i = F.log_softmax(s, dim=1).diagonal()[:n].mean()
    loss_j = F.log_softmax(s.t(), dim=1).diagonal()[:n].mean()
    return -loss_i - loss_j


def norm_softmax_loss_global(text_embeds: torch.Tensor, video_embeds: torch.Tensor,
                             temperature: float = 0.05, eps: float = 1e-8) -> torch.Tensor:
    """NormSoftmax with global negatives: each rank's rows of both embedding
    sets are gathered across the default process group, in rank order, so
    the similarity matrix is the cross-replica one (the reference's
    AllGather_multi). Its gradient reaches each rank's own rows with JAX's
    transpose semantics (collectives.all_gather_rows). Without a group the
    plain loss."""
    return norm_softmax_loss(sim_matrix(all_gather_rows(text_embeds),
                                        all_gather_rows(video_embeds), eps), temperature)


def norm_softmax_loss_chunked(text_embeds: torch.Tensor, video_embeds: torch.Tensor,
                              temperature: float = 0.05, chunk: int = 4096,
                              eps: float = 1e-8) -> torch.Tensor:
    """`norm_softmax_loss(sim_matrix(t, v))` without the (N, N) matrix: the
    row and column logsumexps accumulate over key chunks of `chunk` rows.
    Square only (N text, N video)."""
    t = l2_normalize(text_embeds.float(), eps)
    v = l2_normalize(video_embeds.float(), eps)
    n = t.shape[0]
    if v.shape[0] != n:
        raise ValueError(f"chunked loss needs square sims, got {n} text and "
                         f"{v.shape[0]} video rows")
    pos = (t * v).sum(dim=-1) / temperature  # diagonal logits
    lse_row = torch.full((n,), float("-inf"), device=t.device)
    lse_col = torch.full((n,), float("-inf"), device=t.device)
    for c0 in range(0, n, chunk):
        v_c, t_c = v[c0:c0 + chunk], t[c0:c0 + chunk]
        lse_row = torch.logaddexp(lse_row, torch.logsumexp(t @ v_c.t() / temperature, dim=1))
        lse_col = torch.logaddexp(lse_col, torch.logsumexp(v @ t_c.t() / temperature, dim=1))
    return -(pos - lse_row).mean() - (pos - lse_col).mean()


def max_margin_ranking_loss(sims: torch.Tensor, margin: float = 1.0,
                            fix_norm: bool = True) -> torch.Tensor:
    """Bidirectional max-margin ranking loss over a square sims matrix."""
    sims = sims.float()
    n = sims.shape[0]
    pos = sims.diagonal()[:, None]
    hinge_r = F.relu(margin - (pos - sims))
    hinge_c = F.relu(margin - (pos - sims.t()))
    if fix_norm:
        keep = 1.0 - torch.eye(n, dtype=sims.dtype, device=sims.device)
        return ((hinge_r * keep).sum() + (hinge_c * keep).sum()) / (2.0 * keep.sum())
    return 0.5 * (hinge_r.mean() + hinge_c.mean())


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with integer targets."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[:, None]).mean()


def nce_softmax_loss(logits: torch.Tensor) -> torch.Tensor:
    """Cross entropy with the positive at column 0."""
    return -F.log_softmax(logits.float(), dim=-1)[:, 0].mean()


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Σ KL(softmax(target) ‖ softmax(input)) over dim 1; no gradient to the
    targets."""
    target = target_logits.detach().float()
    logp = F.log_softmax(input_logits.float(), dim=1)
    q = F.softmax(target, dim=1)
    logq = F.log_softmax(target, dim=1)
    return (q * (logq - logp)).sum()


def softmax_mse_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Σ squared difference of the logits; no gradient to the targets."""
    diff = input_logits.float() - target_logits.detach().float()
    return (diff * diff).sum()


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE on probabilities, clamped to [eps, 1 − eps] (torch BCELoss's
    guard)."""
    p = probs.float().clamp(eps, 1.0 - eps)
    t = targets.float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    x, t = logits.float(), targets.float()
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def sigmoid_binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCE with logits, in oatx's stable form."""
    return _bce_with_logits(logits, targets).mean()


def region_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Region-map BCE with the reference's reduction: summed over the patch
    axis, mean over the (batch, region) rows, N× the element mean."""
    return _bce_with_logits(logits, targets).sum(dim=-1).mean()


@dataclasses.dataclass
class MoCoQueue:
    """MoCo negative queue as explicit state: memory (K, D) and the next
    write position."""

    memory: torch.Tensor  # (K, D) f32
    index: int = 0


def moco_queue_init(generator: torch.Generator, queue_size: int, dim: int,
                    device: Optional[torch.device] = None) -> MoCoQueue:
    """memory ~ U(−stdv, stdv), stdv = 1 / sqrt(dim / 3), from `generator`
    (on its device unless `device` names one)."""
    stdv = 1.0 / math.sqrt(dim / 3.0)
    dev = generator.device if device is None else device
    mem = torch.rand(queue_size, dim, generator=generator, device=dev) * (2 * stdv) - stdv
    return MoCoQueue(memory=mem, index=0)


def moco_logits(q: torch.Tensor, k: torch.Tensor, n: torch.Tensor, queue: MoCoQueue,
                temperature: float = 0.07) -> torch.Tensor:
    """[positive | queue negatives | extra negative] logits / T; k, n and the
    queue carry no gradient."""
    k, n = k.detach(), n.detach()
    l_pos = (q * k).sum(dim=-1, keepdim=True)
    l_neg = q @ queue.memory.detach().t()
    l_neg2 = (q * n).sum(dim=-1, keepdim=True)
    return torch.cat([l_pos, l_neg, l_neg2], dim=1) / temperature


def moco_queue_update(queue: MoCoQueue, k: torch.Tensor) -> MoCoQueue:
    """A new queue with the batch of keys written into the ring buffer at
    the write position (wrapping), and the position advanced."""
    size = queue.memory.shape[0]
    ids = (torch.arange(k.shape[0], device=queue.memory.device) + queue.index) % size
    memory = queue.memory.clone()
    memory[ids] = k.detach().to(memory.dtype)
    return MoCoQueue(memory=memory, index=(queue.index + k.shape[0]) % size)


def fine_grained_region_tag_loss(region_embeds: torch.Tensor, tag_embeds: torch.Tensor,
                                 temperature: float = 0.05) -> torch.Tensor:
    """NormSoftmax between the mean-pooled tags (rows) and the mean-pooled
    regions (columns) of each sample: global_local's fine-grained term."""
    r = region_embeds.mean(dim=1)
    t = tag_embeds.mean(dim=1)
    return norm_softmax_loss(sim_matrix(t, r), temperature)
