"""The port's profiler utilities (oatx_torch/utils/profiler.py) against
oatx's (oatx.utils.profiler) where the two can meet, and against the
chrome trace they read where they cannot.

StepTimer is held to oatx's with `time.perf_counter` patched to one
sequence. oatx's trace readers parse jax.profiler's xplane output, which a
torch.profiler capture is not, so `summarize_trace` and
`summarize_by_source` are checked on a CPU capture of a small model under
two `annotate` ranges (and a nested one) against sums taken from the
trace's own events, and the device path of `summarize_by_source` (kernels
attributed through their launch's correlation id, else through the
profiler's range on the device track) on a hand-written CUDA-style trace.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from oatx.utils import profiler as jprof
from oatx_torch.utils import profiler as pprof


def test_step_timer_matches_oatx(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.75, 1.8, 4.0, 4.25]
    got = {}
    for name, mod in (("oatx", jprof), ("port", pprof)):
        seq = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(seq))
        timer = mod.StepTimer(window=3)
        assert timer.mean_step_s is None and timer.steps_per_sec() is None
        got[name] = ([timer.mark() for _ in ticks], timer.mean_step_s, timer.steps_per_sec())
    assert got["port"] == got["oatx"]
    assert got["port"][0][0] is None and got["port"][1] == pytest.approx((0.05 + 2.2 + 0.25) / 3)


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("trace")
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 8))
    x = torch.randn(16, 32)
    with torch.no_grad(), pprof.trace(str(d)):
        with pprof.annotate("first"):
            for _ in range(3):
                model(x)
        with pprof.annotate("second"):
            model(x)
            with pprof.annotate("inner"):
                model(x).t().contiguous().to(torch.float64)
    with open(d / "trace.0.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return d, events


def test_summarize_trace_sums_by_name(cpu_trace):
    d, events = cpu_trace
    rows = pprof.summarize_trace(str(d), top=1000)
    want = {}
    for e in events:
        want[e["name"]] = want.get(e["name"], 0) + e["dur"]
    assert {r["name"]: r["total_ms"] for r in rows} == pytest.approx(
        {n: us / 1e3 for n, us in want.items()})
    totals = [r["total_ms"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    assert {"first", "second", "inner", "aten::linear"} <= set(want)
    assert len(pprof.summarize_trace(str(d), top=3)) == 3
    assert pprof.summarize_trace(str(d / "none")) == []


def test_summarize_by_source_on_a_cpu_capture(cpu_trace):
    d, events = cpu_trace
    rows = {r["source"]: r for r in pprof.summarize_by_source(str(d))}
    assert set(rows) <= {"first", "second", "inner", "?"} and {"first", "second",
                                                                "inner"} <= set(rows)
    # three forwards under "first" against one under "second" (the nested
    # one's ops go to "inner"): the same leaf operators, three times over
    assert rows["first"]["ops_per_step"] == 3 * rows["second"]["ops_per_step"]
    assert rows["inner"]["ops_per_step"] > rows["second"]["ops_per_step"]
    halves = {r["source"]: r for r in pprof.summarize_by_source(str(d), steps=2)}
    assert halves["first"]["ms_per_step"] == pytest.approx(rows["first"]["ms_per_step"] / 2)
    # the linears' weight transposes move data everywhere; "inner" adds a
    # transpose, a contiguous copy and a cast
    moves = {r["source"]: r["ops_per_step"]
             for r in pprof.summarize_by_source(str(d), data_movement_only=True)}
    assert moves["inner"] > moves["second"]
    assert all(n < rows[s]["ops_per_step"] for s, n in moves.items())


def _x(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1 if tid < 7 else 0,
            "tid": tid, "args": args}


def test_summarize_by_source_attributes_kernels_to_their_launch(tmp_path):
    """Kernels on the device's track (tid 7) go to the range open on the
    host thread that launched them (correlation id); a kernel whose launch
    is missing goes to the profiler's range on the device track."""
    ev = [_x("viz_tower", "user_annotation", 0, 100, 1),
          _x("blocks", "user_annotation", 10, 50, 1),
          _x("cudaLaunchKernel", "cuda_runtime", 5, 2, 1, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 20, 2, 1, correlation=2),
          _x("cuLaunchKernel", "cuda_driver", 70, 2, 1, correlation=3),
          _x("cudaMemcpyAsync", "cuda_runtime", 200, 2, 1, correlation=4),
          _x("viz_tower", "gpu_user_annotation", 300, 100, 7),
          _x("ln_mlp_kernel", "kernel", 30, 40, 7, correlation=1),
          _x("space_attention_kernel", "kernel", 80, 10, 7, correlation=2),
          _x("direct_copy_kernel", "kernel", 120, 5, 7, correlation=3),
          _x("Memcpy HtoD", "gpu_memcpy", 210, 3, 7, correlation=4),
          _x("orphan_kernel", "kernel", 320, 6, 7, correlation=99)]
    (tmp_path / "trace.0.json").write_text(json.dumps({"traceEvents": ev}))
    rows = {r["source"]: (r["ms_per_step"], r["ops_per_step"])
            for r in pprof.summarize_by_source(str(tmp_path))}
    assert rows == {"viz_tower": (pytest.approx((40 + 5 + 6) / 1e3), 3),
                    "blocks": (pytest.approx(10 / 1e3), 1), "?": (pytest.approx(3 / 1e3), 1)}
    moves = {r["source"]: r["ops_per_step"]
             for r in pprof.summarize_by_source(str(tmp_path), data_movement_only=True)}
    assert moves == {"viz_tower": 1, "?": 1}
    names = [r["name"] for r in pprof.summarize_trace(str(tmp_path), top=3)]
    assert names == ["viz_tower", "blocks", "ln_mlp_kernel"]


def test_memory_summary_has_host_rss():
    out = pprof.memory_summary()
    assert out["host_rss_mb"] > 10
    assert all(k == "host_rss_mb" or (k.startswith("cuda") and k.endswith("_mem_mb"))
               for k in out)
    assert np.isfinite(list(out.values())).all()
