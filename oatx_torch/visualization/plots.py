"""Offline analysis plots (port of oatx/visualization/plots.py): box
overlays, video-text-object panels and t-SNE embedding maps, in numpy.

Boxes are outlined as `ImageDraw.rectangle(..., width=2)` rasterizes them:
the corners truncated to whole pixels, then Pillow's rows and columns
(`_rectangle`), which on a box thinner than 2·width reach past its edge.
Text is drawn in the port's bitmap font (visualization/heatmap.py says
why). oatx's `tsne_embedding_plot` takes
its t-SNE from sklearn and its scatter from matplotlib, which the card's
machine lacks: the port's is visualization/tsne.py's exact t-SNE and
scatter, written by png.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from oatx_torch.visualization import tsne as _tsne
from oatx_torch.visualization.font import draw_text
from oatx_torch.visualization.png import write_png


def _rectangle(img: np.ndarray, box, color, width: int) -> None:
    """Pillow's ImagingDrawRectangle outline: for each i < width, the rows
    y0 + i and y1 - i from x0 to x1, and the columns x1 - i and x0 + i from
    y0 + width towards y1 - width + 1, that end excluded (its line drawing),
    clipped to the image."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in box)
    y0, y1 = min(y0, y1), max(y0, y1)
    xa, xb = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    ys = np.arange(y0 + width, y1 - width + 1, 1 if y1 - width + 1 >= y0 + width else -1)
    ys = ys[(ys >= 0) & (ys < h)]
    for i in range(width):
        for y in (y0 + i, y1 - i):
            if 0 <= y < h and xa <= xb:
                img[y, xa:xb + 1] = color
        for x in (x1 - i, x0 + i):
            if 0 <= x < w:
                img[ys, x] = color


def draw_bboxes(frame_rgb: np.ndarray, bboxes_norm: np.ndarray,
                labels: Optional[Sequence[str]] = None, color=(255, 32, 32)) -> np.ndarray:
    """Normalized [x1, y1, x2, y2, ...] boxes outlined on a copy of the
    frame, each label above its box → RGB uint8."""
    img = np.array(frame_rgb, np.uint8)
    h, w = img.shape[:2]
    for i, box in enumerate(np.asarray(bboxes_norm)):
        x1, y1, x2, y2 = box[0] * w, box[1] * h, box[2] * w, box[3] * h
        _rectangle(img, (x1, y1, x2, y2), np.asarray(color, np.uint8), 2)
        if labels is not None and i < len(labels):
            draw_text(img, (x1 + 2, max(0, y1 - 12)), str(labels[i]), color)
    return img


def video_text_object_panel(frames_rgb: np.ndarray, caption: str,
                            bboxes_norm: Optional[np.ndarray] = None,
                            tags: Optional[Sequence[str]] = None) -> np.ndarray:
    """N frames side by side (the first with its boxes) over a 28-pixel
    caption strip, the caption's first 120 characters in black at (6, 6)."""
    frames = [np.asarray(f, np.uint8) for f in frames_rgb]
    if bboxes_norm is not None:
        frames[0] = draw_bboxes(frames[0], bboxes_norm, tags)
    row = np.concatenate(frames, axis=1)
    strip = np.full((28, row.shape[1], 3), 255, np.uint8)
    draw_text(strip, (6, 6), caption[:120], (0, 0, 0))
    return np.concatenate([row, strip], axis=0)


def tsne_embedding_plot(embeddings: np.ndarray, labels: Optional[np.ndarray] = None,
                        out_path: str = "tsne.png", perplexity: float = 10.0,
                        title: str = "learned embeddings (t-SNE)") -> str:
    """A 2-D t-SNE scatter of (n, d) embeddings, coloured by `labels`, as a
    720 × 720 PNG at `out_path`; → out_path. The perplexity is clamped to
    min(perplexity, max(1, n // 3), n − 1) and n < 2 raises ValueError, as
    in oatx."""
    n = len(embeddings)
    if n < 2:
        raise ValueError(f"t-SNE needs at least 2 samples, got {n}")
    xy, _ = _tsne.tsne(np.asarray(embeddings),
                       perplexity=min(perplexity, max(1, n // 3), n - 1))
    img, _ = _tsne.render_scatter(xy, None if labels is None else np.asarray(labels), title)
    return write_png(out_path, img)
