"""HTML retrieval-ranking galleries (port of oatx/utils/html_viz.py; the
reference's utils/visualizer.py RetrievalVis and utils/html.py, which used
the `dominate` package).

An optionally auto-refreshing page listing each text query with its top-k
ranked videos, the ground truth outlined, from a plain string template and
the standard library: the same bytes as oatx's for the same sims, captions
and paths.
"""

from __future__ import annotations

import html
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>{title}</title>
{refresh}
<style>
body {{ font-family: sans-serif; margin: 20px; }}
.query {{ margin-bottom: 28px; border-bottom: 1px solid #ccc; padding-bottom: 12px; }}
.rank {{ display: inline-block; margin-right: 12px; text-align: center; }}
.rank video, .rank img {{ height: 120px; }}
.gt {{ outline: 4px solid #2a2; }}
.caption {{ font-weight: bold; margin-bottom: 6px; }}
.meta {{ color: #666; font-size: 12px; }}
</style></head><body>
<h2>{title}</h2>
{body}
</body></html>
"""


def _media_tag(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    esc = html.escape(path)
    if ext in (".mp4", ".avi", ".webm", ".mov"):
        return f'<video src="{esc}" controls muted></video>'
    return f'<img src="{esc}">'


class RetrievalVis:
    """Collects (query caption, ranked video paths, gt path) and writes the
    HTML gallery (the reference's RetrievalVis, utils/visualizer.py:12-140)."""

    def __init__(self, out_dir: str, title: str = "oatx retrieval",
                 top_k: int = 5, refresh_seconds: Optional[int] = None):
        self.out_dir = out_dir
        self.title = title
        self.top_k = top_k
        self.refresh_seconds = refresh_seconds
        self.entries: List[Dict] = []

    def add_ranking(self, caption: str, ranked_paths: Sequence[str],
                    gt_path: Optional[str] = None,
                    scores: Optional[Sequence[float]] = None) -> None:
        self.entries.append({
            "caption": caption,
            "paths": list(ranked_paths[: self.top_k]),
            "gt": gt_path,
            "scores": list(scores[: self.top_k]) if scores is not None else None,
        })

    def from_sims(self, sims: np.ndarray, captions: Sequence[str],
                  video_paths: Sequence[str]) -> None:
        """Populate from a (num_texts, num_videos) similarity matrix; GT video for
        caption i is video i (standard paired eval layout)."""
        order = np.argsort(-np.asarray(sims), axis=1)
        for i, cap in enumerate(captions):
            ranked = [video_paths[j] for j in order[i, : self.top_k]]
            scores = [float(sims[i, j]) for j in order[i, : self.top_k]]
            self.add_ranking(cap, ranked, gt_path=video_paths[i], scores=scores)

    def write(self, filename: str = "index.html") -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        blocks = []
        for e in self.entries:
            ranks = []
            for r, p in enumerate(e["paths"]):
                cls = "rank gt" if e["gt"] and os.path.normpath(p) == os.path.normpath(e["gt"]) else "rank"
                score = (f'<div class="meta">{e["scores"][r]:.3f}</div>'
                         if e["scores"] else "")
                ranks.append(
                    f'<div class="{cls}">{_media_tag(p)}'
                    f'<div class="meta">#{r + 1}</div>{score}</div>')
            blocks.append(
                f'<div class="query"><div class="caption">{html.escape(e["caption"])}</div>'
                + "".join(ranks) + "</div>")
        refresh = (f'<meta http-equiv="refresh" content="{self.refresh_seconds}">'
                   if self.refresh_seconds else "")
        page = _PAGE.format(title=html.escape(self.title), refresh=refresh,
                            body="\n".join(blocks))
        out = os.path.join(self.out_dir, filename)
        with open(out, "w") as f:
            f.write(page)
        return out
