"""Exact t-SNE in numpy, and the scatter that `plots.tsne_embedding_plot`
draws of it.

oatx takes its embedding from sklearn's `TSNE(n_components=2, init="pca",
random_state=0)` and draws it with matplotlib; the card's machine has
neither, so the port computes it here. `tsne` follows sklearn's exact
method (`sklearn/manifold/_t_sne.py`) step for step: squared Euclidean
distances, a binary search a row for the perplexity's precision, the joint
P symmetrised and floored at the float64 epsilon, a PCA start rescaled to a
standard deviation of 1e-4 on its first axis, 250 iterations at early
exaggeration 12 and momentum 0.5, then momentum 0.8 up to `max_iter`, the
learning rate max(n / 12 / 4, 50), gains (+0.2 / ×0.8, at least 0.01),
and sklearn's stopping rules checked every 50 iterations. oatx's default
is Barnes-Hut, whose gradient approximates this one, so coordinates differ
from oatx's; tests/test_torch_aux.py holds the port against sklearn's exact
method by trustworthiness and final KL.

`render_scatter` draws what oatx's figure holds: a 720 × 720 canvas (6 in
at 120 dpi), the points as discs of matplotlib's size 18 (√18 pt across),
coloured by tab10 over the labels' range as matplotlib's `c=` normalises
them, a colour strip of the same map beside the axes, and the title, in
the port's bitmap font (visualization/font.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from oatx_torch.visualization.font import CELL_W, draw_text

MACHINE_EPSILON = np.finfo(np.double).eps
PERPLEXITY_TOLERANCE = 1e-5   # sklearn's _utils._binary_search_perplexity
BINARY_SEARCH_STEPS = 100
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250       # early exaggeration, momentum 0.5
MAX_ITER = 1000
ITERS_WITHOUT_PROGRESS = 300  # after the exploration (in it: EXPLORATION_ITERS)
MIN_GRAD_NORM = 1e-7
CHECK_EVERY = 50              # iterations between error checks

# matplotlib's tab10, the colour map oatx's scatter uses
TAB10 = np.array([[0x1f, 0x77, 0xb4], [0xff, 0x7f, 0x0e], [0x2c, 0xa0, 0x2c],
                  [0xd6, 0x27, 0x28], [0x94, 0x67, 0xbd], [0x8c, 0x56, 0x4b],
                  [0xe3, 0x77, 0xc2], [0x7f, 0x7f, 0x7f], [0xbc, 0xbd, 0x22],
                  [0x17, 0xbe, 0xcf]], np.uint8)
SIZE = 720                    # 6 in at 120 dpi
MARKER_RADIUS = np.sqrt(18.0) / 72 * 120 / 2   # s=18 pt², in pixels
AXES = (60, 40, 600, 680)     # left, top, right, bottom of the axes frame
STRIP = (630, 104, 648, 616)  # the colour strip: shrink 0.8 of the axes' height


def squared_distances(x: np.ndarray) -> np.ndarray:
    """(n, d) → (n, n) float64 squared Euclidean distances, 0 on the diagonal."""
    x = np.asarray(x, np.float64)
    d = np.square(x[:, None, :] - x[None, :, :]).sum(-1)
    np.fill_diagonal(d, 0.0)
    return d


def conditional_p(distances: np.ndarray, perplexity: float) -> np.ndarray:
    """Row i's p_{j|i} = exp(−β_i d_ij) / Σ, β_i found by sklearn's binary
    search (β from 1, doubled or halved until bracketed, then bisected,
    until the row's entropy is within PERPLEXITY_TOLERANCE of
    log(perplexity), at most BINARY_SEARCH_STEPS steps); every row searches
    at once, a row stops where sklearn's loop would. `distances` are read
    in float32, as sklearn reads them."""
    d = np.asarray(distances, np.float32).astype(np.float64)
    n = d.shape[0]
    off = ~np.eye(n, dtype=bool)
    beta = np.ones(n)
    lo, hi = np.full(n, -np.inf), np.full(n, np.inf)
    want = np.log(np.float32(perplexity))  # sklearn takes it as a C float
    active = np.ones(n, bool)
    p = np.zeros((n, n))
    for _ in range(BINARY_SEARCH_STEPS):
        rows = np.nonzero(active)[0]
        if not len(rows):
            break
        pr = np.where(off[rows], np.exp(-d[rows] * beta[rows, None]), 0.0)
        total = pr.sum(1)
        total[total == 0.0] = 1e-8
        pr /= total[:, None]
        p[rows] = pr
        entropy = np.log(total) + beta[rows] * (d[rows] * pr).sum(1)
        diff = entropy - want
        done = np.abs(diff) <= PERPLEXITY_TOLERANCE
        up = ~done & (diff > 0)
        down = ~done & (diff <= 0)
        b = beta[rows]
        lo[rows[up]] = b[up]
        beta[rows[up]] = np.where(hi[rows[up]] == np.inf, b[up] * 2.0,
                                  (b[up] + hi[rows[up]]) / 2.0)
        hi[rows[down]] = b[down]
        beta[rows[down]] = np.where(lo[rows[down]] == -np.inf, b[down] / 2.0,
                                    (b[down] + lo[rows[down]]) / 2.0)
        active[rows[done]] = False
    return p


def joint_probabilities(distances: np.ndarray, perplexity: float) -> np.ndarray:
    """The condensed joint P (upper triangle, row by row, as
    scipy's squareform orders it) of sklearn's `_joint_probabilities`:
    (P + Pᵀ) / its sum, floored at MACHINE_EPSILON."""
    p = conditional_p(distances, perplexity)
    p = p + p.T
    iu = np.triu_indices(p.shape[0], 1)
    return np.maximum(p[iu] / np.maximum(p.sum(), MACHINE_EPSILON), MACHINE_EPSILON)


def pca_init(x: np.ndarray) -> np.ndarray:
    """sklearn's `init="pca"`: the centred data's first two principal axes
    (SVD, each axis's sign set by its largest entry, as `svd_flip` sets
    it), in float32, scaled to a standard deviation of 1e-4 on the first."""
    x = np.asarray(x, np.float64)
    xc = x - x.mean(0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    y = (u * (s * signs))[:, :2].astype(np.float32)
    return y / np.std(y[:, 0]) * 1e-4


def kl_divergence(params: np.ndarray, p: np.ndarray, n: int,
                  compute_error: bool = True) -> Tuple[float, np.ndarray]:
    """sklearn's exact `_kl_divergence` at 1 degree of freedom: (KL(P‖Q),
    its gradient in params' dtype)."""
    y = params.reshape(n, 2)
    iu = np.triu_indices(n, 1)
    dist = 1.0 / (1.0 + np.square(y[:, None, :].astype(np.float64)
                                  - y[None, :, :]).sum(-1)[iu])
    q = np.maximum(dist / (2.0 * dist.sum()), MACHINE_EPSILON)
    kl = 2.0 * np.dot(p, np.log(np.maximum(p, MACHINE_EPSILON) / q)) if compute_error \
        else np.nan
    pq = np.zeros((n, n))
    pq[iu] = (p - q) * dist
    pq += pq.T
    grad = (pq.sum(1)[:, None] * y - pq @ y).astype(params.dtype) * 4.0
    return kl, grad.ravel()


def _descend(p, params, n, it, max_iter, momentum, lr, without_progress):
    """sklearn's `_gradient_descent` with the exact objective → (params,
    error, last iteration)."""
    update = np.zeros_like(params)
    gains = np.ones_like(params)
    error = best_error = np.finfo(float).max
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        error, grad = kl_divergence(params, p, n, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains[inc] += 0.2
        gains[~inc] *= 0.8
        np.clip(gains, 0.01, np.inf, out=gains)
        grad *= gains
        update = momentum * update - lr * grad
        params += update
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > without_progress:
                break
            if np.linalg.norm(grad) <= MIN_GRAD_NORM:
                break
    return params, error, i


def tsne(x: np.ndarray, perplexity: float = 30.0) -> Tuple[np.ndarray, float]:
    """(n, d) → ((n, 2) float32 embedding, final KL divergence): sklearn's
    `TSNE(method="exact", init="pca")` with its other defaults."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < 2:
        raise ValueError(f"t-SNE needs at least 2 samples, got {n}")
    p = joint_probabilities(squared_distances(x), perplexity)
    lr = np.maximum(n / EARLY_EXAGGERATION / 4, 50)
    params = pca_init(x).ravel()
    params, kl, it = _descend(p * EARLY_EXAGGERATION, params, n, 0, EXPLORATION_ITERS, 0.5,
                              lr, EXPLORATION_ITERS)
    params, kl, _ = _descend(p, params, n, it + 1, MAX_ITER, 0.8, lr, ITERS_WITHOUT_PROGRESS)
    return params.reshape(n, 2), float(kl)


def label_colours(labels: np.ndarray) -> np.ndarray:
    """(n,) labels → (n, 3) uint8: tab10 at (label − min) / (max − min),
    index ⌊10 · that⌋ with 1 mapped to the last colour; all the first
    colour when the labels are one value (matplotlib's Normalize then)."""
    v = np.asarray(labels, np.float64)
    lo, hi = v.min(), v.max()
    t = np.zeros_like(v) if hi == lo else (v - lo) / (hi - lo)
    return TAB10[np.clip((t * len(TAB10)).astype(int), 0, len(TAB10) - 1)]


def scatter_centres(xy: np.ndarray) -> np.ndarray:
    """(n, 2) data → (n, 2) float pixel centres (x right, y down) inside
    the AXES frame, the data's range padded by 5 % a side, as matplotlib's
    autoscale margins pad it."""
    xy = np.asarray(xy, np.float64)
    left, top, right, bottom = AXES
    lo, hi = xy.min(0), xy.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    lo, hi = lo - 0.05 * span, hi + 0.05 * span
    u = (xy - lo) / (hi - lo)
    return np.stack([left + u[:, 0] * (right - left), bottom - u[:, 1] * (bottom - top)], 1)


def _disc(img: np.ndarray, cx: float, cy: float, colour: np.ndarray) -> None:
    r = MARKER_RADIUS
    y0, y1 = int(np.floor(cy - r)), int(np.ceil(cy + r))
    x0, x1 = int(np.floor(cx - r)), int(np.ceil(cx + r))
    ys, xs = np.mgrid[max(y0, 0):min(y1, img.shape[0] - 1) + 1,
                      max(x0, 0):min(x1, img.shape[1] - 1) + 1]
    inside = np.square(xs + 0.5 - cx) + np.square(ys + 0.5 - cy) <= r * r
    img[ys[inside], xs[inside]] = colour


def render_scatter(xy: np.ndarray, labels: Optional[np.ndarray] = None,
                   title: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """The scatter of `xy` → ((SIZE, SIZE, 3) uint8 image, (n, 2) pixel
    centres). Points are drawn in order, a later one over an earlier;
    without labels every point takes tab10's first colour and no strip is
    drawn."""
    img = np.full((SIZE, SIZE, 3), 255, np.uint8)
    left, top, right, bottom = AXES
    black = np.zeros(3, np.uint8)
    img[top, left:right + 1] = img[bottom, left:right + 1] = black
    img[top:bottom + 1, left] = img[top:bottom + 1, right] = black
    centres = scatter_centres(xy)
    colours = (np.repeat(TAB10[:1], len(centres), 0) if labels is None
               else label_colours(labels))
    for (cx, cy), c in zip(centres, colours):
        _disc(img, cx, cy, c)
    if labels is not None:
        sl, st, sr, sb = STRIP
        bands = np.linspace(sb, st, len(TAB10) + 1).round().astype(int)
        for k, c in enumerate(TAB10):  # the lowest label at the bottom
            img[bands[k + 1]:bands[k], sl:sr] = c
        v = np.asarray(labels, np.float64)
        draw_text(img, (sr + 4, st - 4), f"{v.max():g}", black)
        draw_text(img, (sr + 4, sb - 4), f"{v.min():g}", black)
    draw_text(img, ((left + right - CELL_W * len(title)) / 2, top - 20), title, black)
    return img, centres
