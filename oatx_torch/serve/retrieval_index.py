"""Corpus retrieval index: device-resident embeddings + top-k cosine search
(port of oatx/serve/retrieval_index.py).

  * the corpus lives on the device as one L2-normalized f32 matrix, padded up
    to `pad_multiple` rows; pad rows are masked to -inf;
  * quantize="int8": the device corpus is per-row symmetric int8 with an
    f32 scale a row, from the padded f32 buffer by oatx's arithmetic, and
    scores are (q @ int8 rowsᵀ cast to q's dtype) · scale; the host copy
    (and `save`) stays exact f32;
  * `search()` is one matmul + `torch.topk` (oatx computes it outside any
    Pallas kernel);
  * corpora longer than `score_chunk` rows score chunk by chunk, with a
    per-chunk top-k and a merge top-k, bounding the live similarity buffer at
    (B, score_chunk);
  * `save` / `load` use oatx's `.npz` format.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from oatx_torch import DeviceLike, resolve_device


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-8)


def ids_for_result(res) -> List[str]:
    """One corpus id per `EvalResult.video_embeds` row (oatx
    retrieval_index.py:39-64).

    Mirrors the row-collapsing rules of eval.retrieval_eval.evaluate:
    sliding-window ensembling keeps first-appearance group order, and the
    full-cut caption_group protocol keeps one video per group in
    first-appearance order. Plain runs are one row per sample."""
    metas = res.meta
    if not metas:
        return [str(i) for i in range(res.video_embeds.shape[0])]

    def _collapse(key: str) -> List[str]:
        seen, out = set(), []
        for m in metas:
            g = m[key]
            if g not in seen:
                seen.add(g)
                out.append(str(m.get("paths", g)))
        return out

    for key in ("caption_group", "window_group"):
        if key in metas[0]:
            ids = _collapse(key)
            if len(ids) == res.video_embeds.shape[0]:
                return ids
    return [str(m.get("paths", i)) for i, m in enumerate(metas)]


class RetrievalIndex:
    """Top-k cosine retrieval over a normalized embedding corpus."""

    def __init__(
        self,
        embeddings: Optional[np.ndarray] = None,
        ids: Optional[Sequence[str]] = None,
        pad_multiple: int = 1024,
        score_chunk: int = 16384,
        query_buckets: Sequence[int] = (1, 4, 16),
        quantize: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if pad_multiple < 1 or score_chunk < 1:
            raise ValueError("pad_multiple and score_chunk must be >= 1")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = resolve_device(device)
        self.quantize = quantize
        self.pad_multiple = int(pad_multiple)
        # chunked scoring needs chunk-divisible pad lengths
        self.score_chunk = (max(int(score_chunk), self.pad_multiple)
                            // self.pad_multiple * self.pad_multiple)
        # query batches above the largest bucket are searched in pieces
        self.query_buckets = sorted(int(b) for b in query_buckets)
        self.ids: List[str] = []
        self._emb = np.zeros((0, 0), np.float32)  # normalized, unpadded (host)
        # the padded corpus on the device, and its int8 rows' scales or None
        self._device_corpus: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None
        if embeddings is not None:
            if ids is None:
                raise ValueError("ids required when embeddings are given")
            self.add(embeddings, ids)

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def dim(self) -> int:
        return self._emb.shape[1] if self._emb.size else 0

    def add(self, embeddings: np.ndarray, ids: Sequence[str]) -> None:
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        if embeddings.shape[0] != len(ids):
            raise ValueError(
                f"{embeddings.shape[0]} embeddings vs {len(ids)} ids")
        if self._emb.size and embeddings.shape[1] != self._emb.shape[1]:
            raise ValueError(
                f"dim mismatch: index {self._emb.shape[1]}, new {embeddings.shape[1]}")
        new = _normalize(embeddings)
        self._emb = new if not self._emb.size else np.concatenate([self._emb, new])
        self.ids.extend(str(i) for i in ids)
        self._device_corpus = None  # re-padded lazily on next search

    def _padded_len(self) -> int:
        n = max(1, len(self.ids))
        pad_len = (n + self.pad_multiple - 1) // self.pad_multiple * self.pad_multiple
        if pad_len > self.score_chunk:
            pad_len = ((pad_len + self.score_chunk - 1)
                       // self.score_chunk * self.score_chunk)
        return pad_len

    def _corpus(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self._device_corpus is None:
            buf = np.zeros((self._padded_len(), self._emb.shape[1]), np.float32)
            buf[: len(self.ids)] = self._emb
            scale = None
            if self.quantize == "int8":
                amax = np.max(np.abs(buf), axis=1)
                scale = np.maximum(amax, np.finfo(np.float32).tiny) / 127.0
                buf = np.clip(np.rint(buf / scale[:, None]), -127, 127).astype(np.int8)
                scale = torch.from_numpy(scale.astype(np.float32)).to(self.device)
            self._device_corpus = torch.from_numpy(buf).to(self.device), scale
        return self._device_corpus

    def _topk(self, q: torch.Tensor, k: int):
        corpus, scale = self._corpus()
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
        n_valid = len(self.ids)
        rows = corpus.shape[0]
        chunk = self.score_chunk if rows > self.score_chunk else rows
        scores, idx = [], []
        for start in range(0, rows, chunk):  # pad_len is chunk-divisible
            # (B, chunk): the only live buffer; an int8 chunk is cast to q's
            # dtype and its rows' scales factored out of the product
            sims = q @ corpus[start: start + chunk].T.to(q.dtype)
            if scale is not None:
                sims = sims * scale[None, start: start + chunk]
            valid = torch.arange(start, start + chunk, device=q.device) < n_valid
            sims = sims.masked_fill(~valid[None, :], float("-inf"))
            # k may exceed a chunk (oatx refuses that); the chunks together
            # still hold at least k candidates for the merge
            s, i = torch.topk(sims, min(k, chunk), dim=1)
            scores.append(s)
            idx.append(i + start)
        if len(scores) == 1:
            return scores[0], idx[0]
        s, j = torch.topk(torch.cat(scores, dim=1), k, dim=1)
        return s, torch.gather(torch.cat(idx, dim=1), 1, j)

    @torch.inference_mode()
    def search(self, queries: np.ndarray, k: int = 5
               ) -> List[List[Dict[str, object]]]:
        """(B, D) query embeddings → per query a ranked list of
        {"id", "score", "rank"} dicts. k is clamped to the corpus size."""
        if not self.ids:
            raise ValueError("index is empty")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim}")
        k = max(1, min(int(k), len(self.ids)))
        n = queries.shape[0]
        if n > self.query_buckets[-1]:
            step = self.query_buckets[-1]
            out: List[List[Dict[str, object]]] = []
            for i in range(0, n, step):
                out.extend(self.search(queries[i: i + step], k))
            return out
        q = torch.from_numpy(queries).to(self.device)
        scores, idx = self._topk(q, k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return [
            [{"id": self.ids[int(j)], "score": float(s), "rank": r}
             for r, (j, s) in enumerate(zip(row_i, row_s))]
            for row_i, row_s in zip(idx, scores)
        ]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, embeddings=self._emb,
            ids=np.array(self.ids, dtype=object),
            meta=json.dumps({"pad_multiple": self.pad_multiple,
                             "score_chunk": self.score_chunk,
                             "quantize": self.quantize}))

    @classmethod
    def load(cls, path: str, **kwargs) -> "RetrievalIndex":
        # the ids are a numpy object array (oatx's format): this index file
        # must come from RetrievalIndex.save, as unpickling runs code
        with np.load(path, allow_pickle=True) as z:
            meta = json.loads(str(z["meta"])) if "meta" in z else {}
            meta.update(kwargs)
            idx = cls(**meta)
            emb = np.asarray(z["embeddings"], np.float32)
            if emb.size:
                idx.add(emb, [str(i) for i in z["ids"]])
        return idx
