"""Contrastive losses of the baseline train step (port of
oatx/losses/contrastive.py:29-148).

  * `l2_normalize`, `sim_matrix` — cosine similarities with the norm clamped
    at eps (:29-39);
  * `norm_softmax_loss` — the symmetric InfoNCE of the reference's
    NormSoftmaxLoss, in f32, over the min(N, M) diagonal (:42-51);
  * `norm_softmax_loss_chunked` — the same loss from the embeddings, key
    chunk by key chunk with a running logsumexp, so the full matrix never
    exists (:74-130);
  * `max_margin_ranking_loss` — the bidirectional hinge (:133-148).

The global-negative gather, the object-aware losses and MoCo belong to later
slices (ROADMAP A).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
