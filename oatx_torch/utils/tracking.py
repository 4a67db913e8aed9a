"""Experiment tracking (port of oatx/utils/tracking.py, in place of the
reference's sacred + Neptune, train_dist_multi.py:154-160): an append-only
local JSONL event stream that any dashboard can tail."""

from __future__ import annotations

import json
import platform
import time
from pathlib import Path
from typing import Any, Dict, Optional


class ExperimentTracker:
    def __init__(self, run_dir: str | Path, name: str, config: Optional[Dict] = None,
                 enabled: bool = True):
        self.enabled = enabled
        self.run_dir = Path(run_dir)
        self.name = name
        self._f = None
        if enabled:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._f = open(self.run_dir / "events.jsonl", "a")
            self._emit("run_start", {
                "name": name,
                "host": platform.node(),
                "config": config or {},
            })

    def _emit(self, kind: str, payload: Dict[str, Any]) -> None:
        if not self._f:
            return
        rec = {"ts": time.time(), "kind": kind, **payload}
        self._f.write(json.dumps(rec, default=str) + "\n")
        self._f.flush()

    def log_metrics(self, step: int, metrics: Dict[str, Any], mode: str = "train") -> None:
        clean = {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in metrics.items()}
        self._emit("metrics", {"step": step, "mode": mode, "metrics": clean})

    def log_artifact(self, path: str, kind: str = "file") -> None:
        self._emit("artifact", {"path": str(path), "artifact_kind": kind})

    def finish(self, status: str = "completed") -> None:
        self._emit("run_end", {"status": status})
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        self.finish("failed" if exc_type else "completed")
