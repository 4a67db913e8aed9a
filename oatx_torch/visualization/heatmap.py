"""Cross-modality attention heatmaps, in numpy (port of
oatx/visualization/heatmap.py; the reference visualization sidecar's
per-word renders, visualize.py:120-217).

    attn = softmax(word_embed · patch_embeds^T · d^-0.5) over the N patches,
    upsampled to the frame (PIL's BILINEAR on a mode-"F" image, rebuilt in
    data/host_transforms.pil_bilinear_resize), min-max normalized,
    JET-coloured, blended 50/50 with the frame, beside the raw frame, over
    a caption strip.

Every array is computed as oatx computes it. Two deliberate differences,
both for want of PIL and nltk on the card's machine:
  * text (the word label, the caption strip) is drawn in the port's
    bitmap font (visualization/font.py) at oatx's anchors, colour and
    60-character wrap, so pixels differ inside the text boxes only;
  * `is_probable_noun` keeps oatx's stopword / suffix heuristic and never
    asks nltk's tagger, which oatx tries first where its data is installed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from oatx_torch.data.host_transforms import pil_bilinear_resize
from oatx_torch.visualization.font import draw_text
from oatx_torch.visualization.png import write_png

_STOPWORDS = {
    "a", "an", "the", "is", "are", "was", "were", "be", "being", "been", "am",
    "do", "does", "did", "will", "would", "can", "could", "of", "in", "on",
    "at", "to", "from", "with", "by", "for", "and", "or", "but", "not", "no",
    "this", "that", "these", "those", "it", "its", "his", "her", "their",
    "there", "here", "very", "so", "such", "as", "than", "then", "into",
    "over", "under", "up", "down", "out", "about", "some", "any", "each",
    "has", "have", "had", "he", "she", "they", "we", "you", "i",
}
RED = (255, 0, 0)


def is_probable_noun(word: str) -> bool:
    """oatx's fallback noun filter: not a stopword, no -ing / -ed / -ly
    ending, letters only (module docstring: nltk is never asked)."""
    w = word.lower().strip(".,!?;:'\"")
    if not w or w in _STOPWORDS or w.endswith(("ing", "ed", "ly")):
        return False
    return w.isalpha()


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] → RGB uint8 with the classic JET map (cv2.COLORMAP_JET)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    four_x = 4.0 * x
    r = np.clip(np.minimum(four_x - 1.5, -four_x + 4.5), 0, 1)
    g = np.clip(np.minimum(four_x - 0.5, -four_x + 3.5), 0, 1)
    b = np.clip(np.minimum(four_x + 0.5, -four_x + 2.5), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def bilinear_upsample(grid: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(h, w) float grid → (out_h, out_w) float32: PIL's BILINEAR resize of
    a mode-"F" image."""
    return pil_bilinear_resize(np.asarray(grid, np.float32), out_w, out_h)


def _normalize01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def word_patch_attention(word_embed: np.ndarray, patch_embeds: np.ndarray,
                         scale: Optional[float] = None) -> np.ndarray:
    """softmax(word · patches^T · scale) → (N,) attention over patches, both
    L2-normalized first; scale defaults to d^-0.5."""
    w = np.asarray(word_embed, np.float32).reshape(-1)
    p = np.asarray(patch_embeds, np.float32)
    w = w / (np.linalg.norm(w) + 1e-8)
    p = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    if scale is None:
        scale = float(len(w)) ** -0.5
    logits = p @ w * scale
    logits -= logits.max()
    e = np.exp(logits)
    return e / e.sum()


def render_heatmap_frame(attn: np.ndarray, frame_rgb: np.ndarray,
                         grid_size: Optional[Tuple[int, int]] = None,
                         label: Optional[str] = None, caption: Optional[str] = None,
                         value_range: str = "unit") -> np.ndarray:
    """attn (N,) over patches + frame (H, W, 3) → [heat | frame] panel, with
    the label at (8, 8) and an optional caption strip → RGB uint8. A float
    frame is read by `value_range` ('unit': [0, 1] scaled by 255, '255':
    already [0, 255]), never by its data range."""
    h, w = frame_rgb.shape[:2]
    n = attn.size
    if grid_size is None:
        g = int(round(np.sqrt(n)))
        grid_size = (g, g)
    cam = _normalize01(bilinear_upsample(attn.reshape(grid_size), h, w))
    heat = jet_colormap(cam)
    f = np.asarray(frame_rgb)
    if f.dtype != np.uint8:
        if value_range == "unit":
            f = np.clip(f, 0.0, 1.0) * 255
        elif value_range == "255":
            f = np.clip(f, 0, 255)
        else:
            raise ValueError(f"value_range must be 'unit' or '255', got {value_range!r}")
    frame = f.astype(np.uint8)
    blend = (heat // 2 + frame // 2).astype(np.uint8)
    if label:
        draw_text(blend, (8, 8), label, RED)
    panel = np.concatenate([blend, frame], axis=1)
    if caption:
        strip = np.full((50, panel.shape[1], 3), 255, np.uint8)
        max_chars = 60
        for j in range(0, len(caption), max_chars):
            draw_text(strip, (8, 4 + 14 * (j // max_chars)), caption[j: j + max_chars], RED)
        panel = np.concatenate([panel, strip], axis=0)
    return panel


def render_featmap(patch_embeds: np.ndarray, frame_rgb: np.ndarray,
                   out_path: Optional[str] = None) -> np.ndarray:
    """Feature-map mode (the reference's feat_map_visualize): the channel
    mean of the patch embeddings as a CAM, JET-blended with the frame,
    beside the raw frame."""
    n = patch_embeds.shape[0]
    g = int(round(np.sqrt(n)))
    cam = np.mean(np.asarray(patch_embeds, np.float32), axis=-1).reshape(g, g)
    panel = render_heatmap_frame(_normalize01(cam).reshape(-1), frame_rgb)
    if out_path:
        write_png(out_path, panel)
    return panel


def render_caption_heatmaps(caption: str, word_embeds: Sequence[np.ndarray],
                            patch_embeds: np.ndarray, frame_rgb: np.ndarray,
                            out_prefix: str, nouns_only: bool = True) -> List[str]:
    """One PNG a word (a noun when `nouns_only`) of the caption, at
    `{out_prefix}_token_{i}.png` → their paths. word_embeds[i] belongs to
    caption.split(" ")[i]."""
    words = caption.split(" ")
    out_paths = []
    for i, word in enumerate(words):
        if i >= len(word_embeds):
            break
        if nouns_only and not is_probable_noun(word):
            continue
        attn = word_patch_attention(word_embeds[i], patch_embeds)
        panel = render_heatmap_frame(attn, frame_rgb, label=word, caption=caption)
        out_paths.append(write_png(f"{out_prefix}_token_{i}.png", panel))
    return out_paths
