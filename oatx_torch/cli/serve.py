"""Embedding service entry point — HTTP JSON API over the dual towers
(port of oatx/cli/serve.py; the same endpoints, JSON and startup banner).

    python -m oatx_torch.cli.serve -c <config.json> [-r <ckpt.pth>] --port 8600

Endpoints:
  GET  /healthz            → {"status": "ok"}
  GET  /stats              → latency p50/p90/p99 per modality (+ index size)
  POST /embed_text         → {"texts": [...]}            → {"embeddings": [[...]]}
  POST /embed_video        → {"video_b64": <base64 npy>} → {"embeddings": [[...]]}
                             (uint8 array (B, F, canon, canon, 3) saved with np.save)
  POST /search             → {"texts": [...], "k": 5}    → {"results": [[{"id",
                             "score", "rank"}, ...]]} — text→video top-k over
                             the corpus index (requires --index)
  POST /index_video        → {"video_b64": ..., "ids": [...]} — embed clips and
                             add them to the live index (requires --index)

Runs on CUDA unless `--device cpu` is given. Without `-r` or
arch.load_checkpoint the towers hold random weights from seed 0. Warmup runs
every bucket (and builds the kernels) before the socket opens.
`--quantize int8` serves weight-only int8 towers (serve/quant.py);
`--index-quantize int8` holds the device corpus as per-row int8 whatever
the index file holds; `--artifact DIR` serves an artifact written by
`oatx_torch.cli.export_serving` through serve/export.py's ExportedEmbedder
(no model built, no warmup; the config is still read for the tokenizer).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import pathlib
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from oatx_torch import resolve_device


def build_service(argv, device=None):
    """Parse serve flags + the experiment config → (service, tokenizer,
    index or None, parsed flags). `device` overrides --device."""
    from oatx_torch.cli.common import dataset_captions, resolve_tokenizer
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.models.convert import load_checkpoint
    from oatx_torch.models.towers import DualTower
    from oatx_torch.serve.embed_service import EmbedService

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--buckets", default="1,4,16")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--index", default=None,
                   help="corpus index .npz (RetrievalIndex.save) enabling /search")
    p.add_argument("--index-quantize", default=None, choices=["int8"],
                   help="hold the device corpus as per-row int8, whatever the index "
                        "file holds")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only int8 kernels for the in-process backend; for an "
                        "artifact, quantize at export time instead "
                        "(oatx_torch.cli.export_serving --quantize)")
    p.add_argument("--artifact", default=None,
                   help="serve from an artifact directory (oatx_torch.cli.export_serving) "
                        "instead of building the model; the config is still read for "
                        "the tokenizer")
    our, rest = p.parse_known_args(argv)
    dev = resolve_device(device if device is not None else our.device)

    exp = load_experiment(rest, test=True)
    ckpt = str(exp.resume) if exp.resume else exp.cfg.arch.load_checkpoint
    search = [pathlib.Path(ckpt).parent] if ckpt else []
    tokenizer = resolve_tokenizer(
        exp.cfg, corpus=lambda: dataset_captions(exp.cfg) or ["a video"],
        search_dirs=search)
    if our.artifact:
        from oatx_torch.serve.export import ExportedEmbedder

        svc = ExportedEmbedder(our.artifact, device=dev)
    else:
        tower_cfg = build_tower_config(
            exp.cfg.arch, compute_dtype=precision_dtype(exp.cfg.trainer.precision))
        model = DualTower(tower_cfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
        if ckpt:
            if not ckpt.endswith((".pth", ".pt", ".tar")):
                raise NotImplementedError(
                    f"{ckpt}: only reference-format .pth checkpoints load in the port")
            load_checkpoint(model, ckpt)
        buckets = tuple(int(b) for b in our.buckets.split(","))
        svc = EmbedService(model, tower_cfg, buckets=buckets, quantize=our.quantize,
                           device=dev)
        svc.warmup(frames=exp.cfg.arch.video_params.num_frames)
    index = None
    if our.index:
        from oatx_torch.serve.retrieval_index import RetrievalIndex

        kw = {"quantize": our.index_quantize} if our.index_quantize else {}
        index = RetrievalIndex.load(our.index, device=dev, **kw)
    return svc, tokenizer, index, our


class _Handler(BaseHTTPRequestHandler):
    service = None
    tokenizer = None
    index = None
    # the index is not internally thread-safe (add() swaps the corpus buffer);
    # ThreadingHTTPServer handles requests concurrently, so search/add both
    # take this lock
    _index_lock = threading.Lock()

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"status": "ok"})
        if self.path == "/stats":
            stats = self.service.latency_summary()
            if self.index is not None:
                stats["index"] = {"size": len(self.index), "dim": self.index.dim}
            return self._json(200, stats)
        return self._json(404, {"error": f"unknown path {self.path}"})

    def _embed_texts(self, req):
        """Tokenize + embed req['texts']; shared by /embed_text and /search."""
        texts = req.get("texts")
        if not texts or not isinstance(texts, list):
            raise ValueError("'texts' must be a non-empty list")
        # clamp to the warmed sequence length
        max_len = min(int(req.get("max_length", self.service.seq_len)),
                      self.service.seq_len)
        tok = self.tokenizer(texts, max_length=max_len)
        ids, mask = tok["input_ids"], tok["attention_mask"]
        if ids.shape[1] < self.service.seq_len:
            pad = self.service.seq_len - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        return self.service.embed_text(ids, mask)

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad JSON: {e}"})
        try:
            if self.path == "/embed_text":
                try:
                    emb = self._embed_texts(req)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                return self._json(200, {"embeddings": emb.tolist()})
            if self.path == "/search":
                if self.index is None:
                    return self._json(400, {"error": "no index loaded (--index)"})
                try:
                    emb = self._embed_texts(req)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                k = int(req.get("k", 5))
                with self._index_lock:
                    results = self.index.search(emb, k=k)
                return self._json(200, {"results": results})
            if self.path == "/index_video":
                if self.index is None:
                    return self._json(400, {"error": "no index loaded (--index)"})
                b64, ids = req.get("video_b64"), req.get("ids")
                if not b64 or not isinstance(ids, list) or not ids:
                    return self._json(400, {
                        "error": "'video_b64' (base64 npy) and non-empty 'ids' required"})
                arr = np.load(io.BytesIO(base64.b64decode(b64)), allow_pickle=False)
                if arr.dtype != np.uint8 or arr.ndim != 5 or arr.shape[0] != len(ids):
                    return self._json(400, {
                        "error": f"expected uint8 (B,F,H,W,3) with B == len(ids), "
                                 f"got {arr.dtype} {arr.shape} vs {len(ids)} ids"})
                emb = self.service.embed_video(arr)
                with self._index_lock:
                    self.index.add(emb, [str(i) for i in ids])
                    size = len(self.index)
                return self._json(200, {"indexed": len(ids), "size": size})
            if self.path == "/embed_video":
                b64 = req.get("video_b64")
                if not b64:
                    return self._json(400, {"error": "'video_b64' (base64 npy) required"})
                arr = np.load(io.BytesIO(base64.b64decode(b64)), allow_pickle=False)
                if arr.dtype != np.uint8 or arr.ndim != 5:
                    return self._json(400, {
                        "error": f"expected uint8 (B,F,H,W,3), got {arr.dtype} {arr.shape}"})
                emb = self.service.embed_video(arr)
                return self._json(200, {"embeddings": emb.tolist()})
            return self._json(404, {"error": f"unknown path {self.path}"})
        except Exception as e:  # surfaced, not swallowed
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})


def startup_banner(svc, index, our) -> str:
    """The one-line JSON printed before the socket opens."""
    return json.dumps({
        "serving": f"http://{our.host}:{our.port}",
        "buckets": list(getattr(svc, "buckets", ())),
        "index_size": len(index) if index is not None else None,
    })


def make_server(svc, tokenizer, index, our) -> ThreadingHTTPServer:
    """A handler class bound to this service, and the server on host:port."""
    handler = type("Handler", (_Handler,), {
        "service": svc, "tokenizer": tokenizer, "index": index,
        "_index_lock": threading.Lock()})
    return ThreadingHTTPServer((our.host, our.port), handler)


def main(argv: Optional[Sequence[str]] = None) -> int:
    svc, tokenizer, index, our = build_service(argv)
    server = make_server(svc, tokenizer, index, our)
    print(startup_banner(svc, index, our), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
