"""Retrieval metrics, numpy on the host (port of oatx/metrics/retrieval.py,
which the port keeps its own copy of).

Semantics match the reference (OATrans model/metric.py):
  * t2v_metrics — rank of each caption's ground-truth video, ties broken
    optimistically (metric.py:16-120), supporting pseudo-rectangular sims
    (num_queries = queries_per_video * num_vids) and query masks for videos with
    missing captions.
  * v2t_metrics — per video, the best rank among its captions, ties broken by
    averaging (metric.py:123-212).
  * cols2metrics — R@1/5/10/50, MedR, MeanR, geometric mean of R1/R5/R10
    (metric.py:281-291).
  * retrieval_as_classification (metric.py:215-278) and mean-average-precision,
    with average precision written in numpy (oatx calls sklearn's
    average_precision_score; `average_precision` computes the same sum).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def cols2metrics(cols: np.ndarray, num_queries: int) -> Dict[str, float]:
    cols = np.asarray(cols)
    metrics: Dict[str, float] = {}
    metrics["R1"] = 100 * float(np.sum(cols == 0)) / num_queries
    metrics["R5"] = 100 * float(np.sum(cols < 5)) / num_queries
    metrics["R10"] = 100 * float(np.sum(cols < 10)) / num_queries
    metrics["R50"] = 100 * float(np.sum(cols < 50)) / num_queries
    metrics["MedR"] = float(np.median(cols) + 1)
    metrics["MeanR"] = float(np.mean(cols) + 1)
    stats = np.array([metrics["R1"], metrics["R5"], metrics["R10"]], dtype=np.float64)
    with np.errstate(divide="ignore"):
        metrics["geometric_mean_R1-R5-R10"] = float(np.exp(np.mean(np.log(stats))))
    return metrics


def t2v_metrics(
    sims: np.ndarray,
    query_masks: Optional[np.ndarray] = None,
    break_ties: str = "optimistically",
) -> Dict[str, float]:
    """Text→video retrieval metrics.

    sims[i, j] = <text_i, video_j>; rows may be grouped: caption i belongs to video
    i // queries_per_video... (reference indexes GT as caption block jj*qpv..(jj+1)*qpv
    for video jj — i.e. caption row ii's GT video is ii // queries_per_video).
    """
    sims = np.asarray(sims)
    assert sims.ndim == 2, "expected a matrix"
    num_queries, num_vids = sims.shape
    dists = -sims
    sorted_dists = np.sort(dists, axis=1)

    queries_per_video = num_queries // num_vids
    gt_vid = np.arange(num_queries) // queries_per_video
    gt_dists = dists[np.arange(num_queries), gt_vid][:, None]

    # Rank = first (optimistic) or mean (averaging) position where the sorted distance
    # equals the GT distance.
    eq = sorted_dists == gt_dists
    if break_ties == "optimistically":
        cols = np.argmax(eq, axis=1).astype(np.float64)
    elif break_ties == "averaging":
        counts = eq.sum(axis=1)
        first = np.argmax(eq, axis=1)
        cols = first + (counts - 1) / 2.0
    else:
        raise ValueError(f"unknown tie-breaking method: {break_ties}")
    assert eq.any(axis=1).all(), "every query must find its GT distance"

    if query_masks is not None:
        query_masks = np.asarray(query_masks).reshape(-1).astype(bool)
        assert query_masks.size == num_queries, "invalid query mask shape"
        cols = cols[query_masks]
        num_queries = int(query_masks.sum())

    return cols2metrics(cols, num_queries)


def v2t_metrics(
    sims: np.ndarray,
    query_masks: Optional[np.ndarray] = None,
    break_ties: str = "averaging",
) -> Dict[str, float]:
    """Video→text retrieval metrics: best rank among each video's captions."""
    sims = np.asarray(sims).T  # → (num_vids, num_caps)
    assert sims.ndim == 2, "expected a matrix"
    num_queries, num_caps = sims.shape
    dists = -sims.copy()
    caps_per_video = num_caps // num_queries

    MISSING_VAL = 1e8
    if query_masks is not None:
        mask = np.asarray(query_masks).reshape(-1).astype(bool)
        dists[:, ~mask] = MISSING_VAL

    if break_ties not in ("optimistically", "averaging"):
        raise ValueError(f"unknown tie-breaking method: {break_ties}")

    # Rank of value v within the sorted row: first index where it appears is the
    # count of strictly-smaller elements (searchsorted left); the reference's
    # np.where(srow == v).mean() over the contiguous tie run equals
    # first + (count-1)/2. One vectorized searchsorted per row replaces the
    # O(caps) scan per caption (metric.py:123-212 semantics preserved).
    sorted_dists = np.sort(dists, axis=1)
    query_ranks = np.empty(num_queries, dtype=np.float64)
    for ii in range(num_queries):
        gt_vals = dists[ii, ii * caps_per_video: (ii + 1) * caps_per_video]
        first = np.searchsorted(sorted_dists[ii], gt_vals, side="left")
        if break_ties == "optimistically":
            ranks = first.astype(np.float64)
        else:
            cnt = np.searchsorted(sorted_dists[ii], gt_vals, side="right") - first
            ranks = first + (cnt - 1) / 2.0
        valid = gt_vals != MISSING_VAL
        query_ranks[ii] = ranks[valid].min() if valid.any() else np.inf
    return cols2metrics(query_ranks, num_queries)


def retrieval_as_classification(
    sims: np.ndarray, query_masks: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """Classification-style metrics: rank every GT label of each video query,
    subtracting out better-ranked GT labels (reference metric.py:215-278).
    REQUIRES query_masks (the multi-hot label matrix) — there is no sensible
    default."""
    if query_masks is None:
        raise ValueError(
            "retrieval_as_classification requires query_masks (multi-hot "
            "labels per video); it cannot run on a plain retrieval sims matrix")
    sims = np.asarray(sims).T
    query_masks = np.asarray(query_masks).T
    dists = -sims
    num_queries, _ = sims.shape
    sorted_dists = np.sort(dists, axis=1)

    query_ranks = []
    for ii in range(num_queries):
        gt_vals = dists[ii, query_masks[ii].astype(bool)]
        first = np.searchsorted(sorted_dists[ii], gt_vals, side="left")
        cnt = np.searchsorted(sorted_dists[ii], gt_vals, side="right") - first
        # averaged tie rank, then subtract out better-ranked GT labels
        label_ranks = first + (cnt - 1) / 2.0 - np.arange(gt_vals.size)
        query_ranks.extend(label_ranks.tolist())
    query_ranks = np.array(query_ranks)
    return cols2metrics(query_ranks, num_queries=len(query_ranks))


def average_precision(targets: np.ndarray, scores: np.ndarray) -> float:
    """Σ_k (R_k − R_{k−1})·P_k over the distinct scores in descending order,
    with every tied score one threshold (sklearn average_precision_score for
    binary targets)."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    s, y = np.asarray(scores)[order], np.asarray(targets)[order] > 0
    last = np.r_[np.flatnonzero(np.diff(s)), s.size - 1]  # each threshold's last row
    tps = np.cumsum(y)[last].astype(np.float64)
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def mean_average_precision(
    sims: np.ndarray, query_masks: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """mAP over video queries (sims.T rows scored against multi-hot
    query_masks.T). REQUIRES query_masks (multi-hot relevance labels)."""
    if query_masks is None:
        raise ValueError("mean_average_precision requires query_masks "
                         "(multi-hot relevance labels per video)")
    scores = np.asarray(sims).T
    targets = np.asarray(query_masks).T
    aps = [average_precision(targets[i], scores[i])
           for i in range(scores.shape[0]) if targets[i].sum() > 0]
    return {"mAP": float(np.mean(aps))}


# metrics that cannot run without a query_masks label matrix — callers with
# only a sims matrix should skip these with a warning rather than crash
REQUIRES_QUERY_MASKS = ("retrieval_as_classification", "mean_average_precision")


def acc(output: np.ndarray, target: np.ndarray) -> float:
    pred = np.argmax(np.asarray(output), axis=1)
    return float(np.sum(pred == np.asarray(target))) / len(target)


def top_k_acc(output: np.ndarray, target: np.ndarray, k: int = 3) -> float:
    topk = np.argsort(-np.asarray(output), axis=1)[:, :k]
    correct = sum(int(t in row) for t, row in zip(np.asarray(target), topk))
    return correct / len(target)
