"""Tracing and profiling utilities on torch.profiler (port of
oatx/utils/profiler.py, which wraps jax.profiler).

  * StepTimer — a rolling step timer, oatx's; mark() after the step's work
    has finished (on a card: after a synchronize or a scalar read);
  * trace(log_dir) — a torch.profiler capture (CPU, and CUDA when a card is
    in use) written as a chrome trace `<log_dir>/trace.<n>.json`;
  * summarize_trace — the largest total durations by event name in the
    newest trace under log_dir;
  * summarize_by_source — device time grouped by the innermost `annotate`
    range around each device event (see its docstring for how this differs
    from oatx's grouping by XLA source line);
  * annotate(name) — a named range (torch.profiler.record_function);
  * memory_summary — host RSS and each card's allocated memory, in MB.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import json
import os
import time
from typing import Dict, List, Optional

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_MOVEMENT = ("copy", "cast", "transpose", "permute", "memcpy", "memset", "contiguous",
             "clone", "aten::to")


class StepTimer:
    """Rolling step timer over the last `window` intervals between marks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def mark(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_s(self) -> Optional[float]:
        return sum(self._times) / len(self._times) if self._times else None

    def steps_per_sec(self) -> Optional[float]:
        m = self.mean_step_s
        return 1.0 / m if m else None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block, with CUDA activity where a card is available; on
    exit (after a synchronize when a card is traced) write its chrome trace
    to `<log_dir>/trace.<n>.json`, n one more than the traces already
    there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    n = len(glob.glob(os.path.join(log_dir, "trace.*.json")))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{n}.json"))


def _events(log_dir: str) -> List[Dict]:
    """The events of the newest chrome trace (`*.json`) under log_dir."""
    files = glob.glob(os.path.join(str(log_dir), "**", "*.json"), recursive=True)
    if not files:
        return []
    with open(max(files, key=os.path.getmtime)) as f:
        return json.load(f).get("traceEvents", [])


def summarize_trace(log_dir: str, top: int = 20) -> List[Dict]:
    """The trace's complete events, total duration by name, largest first."""
    durs: Dict[str, float] = collections.Counter()
    for e in _events(log_dir):
        if e.get("ph") == "X" and "dur" in e:
            durs[e.get("name", "?")] += e["dur"]
    return [{"name": n, "total_ms": d / 1e3}
            for n, d in sorted(durs.items(), key=lambda kv: -kv[1])[:top]]


def _is_movement(e: Dict) -> bool:
    name = e.get("name", "").lower()
    return e.get("cat") in ("gpu_memcpy", "gpu_memset") or any(m in name for m in _MOVEMENT)


def summarize_by_source(log_dir: str, steps: int = 1, top: int = 25,
                        data_movement_only: bool = False) -> List[Dict]:
    """Device time by the innermost `annotate` range it ran under.

    oatx groups device ops by the repo source line XLA attaches to each
    (`source`); torch's events carry no such argument. So each device event
    (a kernel, memcpy or memset) is attributed through its correlation id
    to the host launch that enqueued it, and from there to the innermost
    `annotate` / record_function range open on that host thread at the
    launch; failing that, to the innermost range the profiler drew on the
    device's own track around it. A trace without device events (a CPU
    capture) attributes its leaf CPU operators by their own start. Events
    under no range count as "?". `data_movement_only` keeps copy, cast, transpose
    and memory-transfer events."""
    events = [e for e in _events(log_dir) if e.get("ph") == "X"]
    ranges: Dict[tuple, List[Dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("user_annotation", "gpu_user_annotation"):
            ranges[e["pid"], e["tid"]].append(e)
    starts = {}
    for key, rs in ranges.items():
        rs.sort(key=lambda r: r["ts"])
        starts[key] = [r["ts"] for r in rs]

    def innermost(e: Optional[Dict]) -> str:
        """The latest-starting range on e's track still open at e's start."""
        if e is None:
            return "?"
        key = (e["pid"], e["tid"])
        rs = ranges.get(key, [])
        for r in reversed(rs[:bisect.bisect_right(starts.get(key, []), e["ts"])]):
            if r["ts"] + r.get("dur", 0) >= e["ts"]:
                return r["name"]
        return "?"

    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        work = []
        for e in device:  # the launch's range, else the range the profiler put on the device
            src = innermost(launches.get(e.get("args", {}).get("correlation")))
            work.append((e, src if src != "?" else innermost(e)))
    else:
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                     key=lambda e: (e["pid"], e["tid"], e["ts"]))
        work = [(e, innermost(e)) for i, e in enumerate(ops)  # leaves: nothing starts inside
                if i + 1 == len(ops) or (ops[i + 1]["pid"], ops[i + 1]["tid"]) != (e["pid"], e["tid"])
                or ops[i + 1]["ts"] >= e["ts"] + e.get("dur", 0)]

    by_src: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    for e, src in work:
        if data_movement_only and not _is_movement(e):
            continue
        by_src[src] += e.get("dur", 0)
        count[src] += 1
    return [{"source": s, "ms_per_step": us / 1e3 / max(1, steps),
             "ops_per_step": count[s] // max(1, steps)}
            for s, us in sorted(by_src.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the trace (torch.profiler.record_function)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def memory_summary() -> Dict[str, float]:
    """Host RSS and each visible card's allocated memory, in MB (oatx's
    `{platform}{id}_hbm_mb` becomes `cuda{i}_mem_mb`)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host_rss_mb"] = float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda{i}_mem_mb"] = torch.cuda.memory_allocated(i) / 1e6
    return out
