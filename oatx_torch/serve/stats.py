"""Latency statistics of a serving backend (port of
oatx/serve/embed_service.py:21-50): a ring buffer of samples in ms and its
percentiles. Its own module, so that the exported-artifact backend
(serve/export.py) needs nothing else of the package to serve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class LatencyStats:
    samples_ms: List[float] = field(default_factory=list)
    max_samples: int = 100_000  # ring buffer: a long-running service must not
    _next: int = 0              # grow (or re-percentile) without bound

    def add(self, ms: float) -> None:
        if len(self.samples_ms) < self.max_samples:
            self.samples_ms.append(ms)
        else:
            self.samples_ms[self._next] = ms
            self._next = (self._next + 1) % self.max_samples

    def percentile(self, p: float) -> float:
        if not self.samples_ms:
            return float("nan")
        return float(np.percentile(self.samples_ms, p))

    def summary(self) -> Dict[str, Optional[float]]:
        # None (JSON null) when empty — json.dumps would otherwise emit bare
        # NaN, which strict JSON parsers reject
        if not self.samples_ms:
            return {"count": 0, "p50_ms": None, "p90_ms": None,
                    "p99_ms": None, "mean_ms": None}
        return {
            "count": len(self.samples_ms),
            "p50_ms": self.percentile(50),
            "p90_ms": self.percentile(90),
            "p99_ms": self.percentile(99),
            "mean_ms": float(np.mean(self.samples_ms)),
        }
