#!/usr/bin/env python3
"""Drive the oatx_torch port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises: the exit code is then not 0 and no `ok` line is
printed):
  1. environment — the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the nvcc build of every kernel in oatx_torch/csrc;
  2. kernels — each hand-written kernel against its plain PyTorch version on
     the card at the main-path shapes of bucket 4 (bf16), with its time, the
     plain version's, one PyTorch library call's and the card's bound;
  3. serve — the full-width zero-shot config (configs/ft/msrvtt/zsl/normal.json:
     ViT-B/16 over 4×224² frames + DistilBERT-base, bf16, random weights from
     seed 0) built through oatx_torch.cli.serve, its HTTP server on a
     localhost port, and real requests: /embed_video at batch 1 and 4,
     /embed_text, /index_video, /search, /stats; then per bucket a latency
     pass (LAT_ROUNDS rounds of LAT_REQUESTS requests after warm-up, each
     round's p50 read back from /stats) and a device trace of
     PROFILED_REQUESTS requests (device busy time, idle share of the
     unprofiled p50, device time by kernel group). The launch counters are
     set to 0 just before and read just after; every kernel must have run 12
     times per video-tower forward. The served embedding is held against the
     same model with the plain versions.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "ft", "msrvtt", "zsl", "normal.json")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Kernel vs plain version, both bf16 on the card, elementwise
# |got - want| <= atol + BF16_RTOL * |want|. The two round to bf16 at the same
# points (z and h in ln_mlp, p in space_attention, then the output) from f32
# sums taken in another order. So an output may land one bf16 ulp apart
# (at most 2^-7 * |want|), and a rounding of z, h or p that lands the other
# way reaches the output as an absolute error well below one ulp at the
# output's typical size: atol, set per kernel from that size.
BF16_RTOL = 2.0 ** -7
# ln_mlp's output at these inputs has rms 0.37 and max 1.9 on an H100 (fc2
# sums 3072 GELU values times N(0, 0.02²) weights); atol is 0.8 % of the rms.
# Observed: max_abs_err 7.8e-3 (one ulp at 1.9), 0.79 of the tolerance at
# atol 2e-3.
LN_MLP_ATOL = 3e-3
# space_attention's output is a softmax-weighted mean of ~197 N(0, 1) rows:
# rms 0.12, max 0.94 on an H100; atol is 0.9 % of the rms. Observed:
# max_abs_err 1.95e-3, 0.91 of the tolerance at atol 5e-4.
SPACE_ATTENTION_ATOL = 1e-3
# Served embedding (12 blocks, bf16) vs the same model with the plain versions
# on the card: the per-layer differences above compound through depth.
E2E_MIN_COSINE = 0.999
LAT_REQUESTS = 100     # timed requests per bucket and round, after warm-up
LAT_ROUNDS = 3         # rounds per bucket: the p50's spread inside one call
LAT_WARMUP = 5
PROFILED_REQUESTS = 10
# device kernels by name, for the per-group breakdown of a video request
KERNEL_GROUPS = (("ln_mlp", ("ln_mlp_kernel",)),
                 ("space_attention", ("space_attention_kernel",)),
                 ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
                 ("softmax", ("softmax",)),
                 ("conv", ("conv", "implicit")),
                 ("memcpy", ("memcpy",)))


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, atol):
    """Errors of got against want, and the share of the tolerance used."""
    want = want.float()
    err = (got.float() - want).abs()
    rec = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / want.abs().clamp_min(1e-3)).max()),
           "tol_used": float((err / (atol + BF16_RTOL * want.abs())).max()),
           "ref_rms": float(want.square().mean().sqrt()),
           "ref_max": float(want.abs().max()), "atol": atol}
    if not rec["tol_used"] <= 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: outside |err| <= {atol} + {BF16_RTOL}·|ref| "
                             f"(or non-finite output): {rec}")
    return rec


def kernel_ln_mlp(dev, g):
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain

    R, D, H = 4 * 785, 768, 3072  # bucket 4: B·T rows of the patch+CLS stream
    bf = torch.bfloat16
    x = torch.randn(R, D, device=dev, generator=g).to(bf)
    gamma = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
    beta = 0.1 * torch.randn(D, device=dev, generator=g)
    w1 = (0.02 * torch.randn(H, D, device=dev, generator=g)).to(bf)
    b1 = 0.02 * torch.randn(H, device=dev, generator=g)
    w2 = (0.02 * torch.randn(D, H, device=dev, generator=g)).to(bf)
    b2 = 0.02 * torch.randn(D, device=dev, generator=g)
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    got = ln_mlp(*args)
    torch.cuda.synchronize()
    want = ln_mlp_plain(*args)
    errs = check_close("ln_mlp", got, want, LN_MLP_ATOL)
    gb, bb, b1b, b2b = (t.to(bf) for t in (gamma, beta, b1, b2))

    def library():
        z = F.layer_norm(x, (D,), gb, bb, 1e-6)
        return F.linear(F.gelu(F.linear(z, w1, b1b)), w2, b2b)

    nbytes = 2 * R * D * 2 + 2 * D * H * 2 + (2 * D + H + D) * 4
    flops = 2 * R * D * H * 2
    b, by = bound_ms(nbytes, flops)
    return {
        "name": "ln_mlp", "route": "cuda", "source": "oatx_torch/csrc/ln_mlp.cu",
        "replaces": "oatx/ops/pallas/ln_mlp.py:98", **errs,
        "ms": time_ms(lambda: ln_mlp(*args)),
        "plain_ms": time_ms(lambda: ln_mlp_plain(*args), iters=5),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(library),
        "shape": f"x ({R}, {D}) bf16, hidden {H}",
    }


def kernel_space_attention(dev, g):
    from oatx_torch.ops.kernels.space_attention import space_attention, \
        space_attention_plain

    B, Fr, N, Hh, Dh = 4, 4, 196, 12, 64  # bucket 4, ViT-B/16 224², 4 frames
    T = 1 + Fr * N
    qkv = torch.randn(B, T, 3, Hh, Dh, device=dev, generator=g).to(torch.bfloat16)
    q = qkv[:, :, 0] * Dh ** -0.5  # as ops.attention.qkv_heads gives them
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    got = space_attention(q, k, v, Fr)
    torch.cuda.synchronize()
    want = space_attention_plain(q, k, v, Fr)
    errs = check_close("space_attention", got, want, SPACE_ATTENTION_ATOL)

    # yardstick: SDPA over the (B·F, H, 196, 197) groups plus the CLS row,
    # on inputs gathered into its layout beforehand (not timed)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, T, Dh)

    def groups(t):
        p = t[:, :, 1:].reshape(B, Hh, Fr, N, Dh).permute(0, 2, 1, 3, 4)
        return p.reshape(B * Fr, Hh, N, Dh)

    def with_cls(t):
        c = t[:, :, :1].unsqueeze(1).expand(B, Fr, Hh, 1, Dh).reshape(B * Fr, Hh, 1, Dh)
        return torch.cat([c, groups(t)], dim=2).contiguous()

    qg, kg, vg = groups(qh).contiguous(), with_cls(kh), with_cls(vh)
    qc, kc, vc = qh[:, :, :1].contiguous(), kh.contiguous(), vh.contiguous()

    def library():
        F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
        F.scaled_dot_product_attention(qc, kc, vc, scale=1.0)

    nbytes = 4 * B * T * Hh * Dh * 2
    flops = 2 * 2 * B * Hh * (T + Fr * N * (N + 1)) * Dh
    b, by = bound_ms(nbytes, flops)
    return {
        "name": "space_attention", "route": "cuda",
        "source": "oatx_torch/csrc/space_attention.cu",
        "replaces": "oatx/ops/pallas/spacetime_attention.py:60", **errs,
        "ms": time_ms(lambda: space_attention(q, k, v, Fr)),
        "plain_ms": time_ms(lambda: space_attention_plain(q, k, v, Fr), iters=5),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(library),
        "shape": f"q/k/v ({B}, {T}, {Hh}, {Dh}) bf16, {Fr} frames",
    }


@contextlib.contextmanager
def plain_versions():
    """Route the towers through the kernels' plain versions (reference run)."""
    from oatx_torch.models import vit_spacetime
    from oatx_torch.ops import attention
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp_plain
    from oatx_torch.ops.kernels.space_attention import space_attention_plain

    saved = vit_spacetime.ln_mlp, attention.space_attention
    vit_spacetime.ln_mlp, attention.space_attention = ln_mlp_plain, space_attention_plain
    try:
        yield
    finally:
        vit_spacetime.ln_mlp, attention.space_attention = saved


def post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def npy_b64(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


def device_trace(fn, n):
    """Trace n calls of fn with CUDA activity only (no host-side tracing to
    slow the host-bound path). Returns per call: device busy ms (the union of
    kernel and copy intervals), device activities, and device ms by group."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    iv = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.time_range.end > e.time_range.start)
    if not iv:
        raise AssertionError("the device trace holds no device activity")
    busy_us, (cur_s, cur_e) = 0.0, iv[0][:2]
    for s, e, _ in iv[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    groups: dict = {}
    for s, e, name in iv:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e3 / n
    return busy_us / 1e3 / n, len(iv) / n, groups


def bucket_latency(url, svc, payload_v, payload_t):
    """LAT_ROUNDS rounds of LAT_REQUESTS video + text requests after warm-up;
    each round's service-time percentiles come back from /stats, and the
    client's wall time per video request gives the HTTP layer's share."""
    from oatx_torch.serve.embed_service import LatencyStats

    for _ in range(LAT_WARMUP):
        post(url + "/embed_video", payload_v)
        post(url + "/embed_text", payload_t)
    rounds = []
    for _ in range(LAT_ROUNDS):
        svc.stats = {"video": LatencyStats(), "text": LatencyStats()}
        wall = []
        for _ in range(LAT_REQUESTS):
            t0 = time.perf_counter()
            post(url + "/embed_video", payload_v)
            wall.append((time.perf_counter() - t0) * 1e3)
            post(url + "/embed_text", payload_t)
        s = get(url + "/stats")
        if s["video"]["count"] != LAT_REQUESTS or s["text"]["count"] != LAT_REQUESTS:
            raise AssertionError(f"/stats counted {s['video']['count']} video, "
                                 f"{s['text']['count']} text requests of {LAT_REQUESTS}")
        rounds.append({"video_p50_ms": s["video"]["p50_ms"],
                       "video_p90_ms": s["video"]["p90_ms"],
                       "text_p50_ms": s["text"]["p50_ms"],
                       "http_video_p50_ms": float(np.median(wall))})
    rec = {"requests": LAT_REQUESTS, "rounds": rounds}
    for key in rounds[0]:
        vals = [r[key] for r in rounds]
        mid = float(np.median(vals))
        rec[key] = mid
        rec[key.replace("_ms", "_spread")] = (max(vals) - min(vals)) / mid
    return rec


def finite_matrix(name, rows, shape):
    a = np.asarray(rows, np.float32)
    if a.shape != shape or not np.isfinite(a).all():
        raise AssertionError(f"{name}: got {a.shape} (finite={np.isfinite(a).all()}), "
                             f"want finite {shape}")
    return a


def serve_phase(tmp, smi):
    from oatx_torch.cli.serve import build_service, make_server
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp
    from oatx_torch.ops.kernels.space_attention import space_attention
    from oatx_torch.serve.retrieval_index import RetrievalIndex

    rng = np.random.default_rng(0)
    dim = ExperimentCfg.from_json(CONFIG).arch.projection_dim
    index_path = os.path.join(tmp, "index.npz")
    RetrievalIndex(rng.standard_normal((64, dim)).astype(np.float32),
                   [f"corpus{i}" for i in range(64)], pad_multiple=64,
                   device="cpu").save(index_path)
    t0 = time.perf_counter()
    svc, tok, index, our = build_service(
        ["-c", CONFIG, "--port", "0", "--index", index_path])
    print(f"serve: model built and warmed up (buckets {svc.buckets}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    server = make_server(svc, tok, index, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    frames = 4
    try:
        if get(url + "/healthz") != {"status": "ok"}:
            raise AssertionError("/healthz")
        clip1 = rng.integers(0, 256, (1, frames, 256, 256, 3), dtype=np.uint8)
        clip4 = rng.integers(0, 256, (4, frames, 256, 256, 3), dtype=np.uint8)
        texts = ["a man is cooking in a kitchen", "a video", "two dogs play"]

        # ---- the main path, counted ----
        ln_mlp.launches = 0
        space_attention.launches = 0
        svc.tower_calls = {"video": 0, "text": 0}
        e1 = finite_matrix("embed_video b1", post(url + "/embed_video", {
            "video_b64": npy_b64(clip1)})["embeddings"], (1, dim))
        e4 = finite_matrix("embed_video b4", post(url + "/embed_video", {
            "video_b64": npy_b64(clip4)})["embeddings"], (4, dim))
        finite_matrix("embed_text", post(url + "/embed_text", {"texts": texts})[
            "embeddings"], (3, dim))
        r = post(url + "/index_video", {"video_b64": npy_b64(clip4),
                                        "ids": ["new0", "new1", "new2", "new3"]})
        if r != {"indexed": 4, "size": 68}:
            raise AssertionError(f"/index_video: {r}")
        res = post(url + "/search", {"texts": texts[:2], "k": 5})["results"]
        for row in res:
            scores = [h["score"] for h in row]
            if len(row) != 5 or scores != sorted(scores, reverse=True) or \
                    not all(-1 - 1e-5 <= s <= 1 + 1e-5 for s in scores) or \
                    [h["rank"] for h in row] != list(range(5)):
                raise AssertionError(f"/search result not a ranked top-5: {row}")
        stats = get(url + "/stats")
        if stats["index"] != {"size": 68, "dim": dim} or stats["video"]["count"] != 3:
            raise AssertionError(f"/stats: {stats}")
        # per bucket: latency from /stats, then the device trace; the idle
        # share is 1 - device busy / the unprofiled service p50
        perf = {}
        for b in svc.buckets:
            clips = rng.integers(0, 256, (b, frames, 256, 256, 3), dtype=np.uint8)
            payload_v = json.dumps({"video_b64": npy_b64(clips)}).encode()
            payload_t = json.dumps({"texts": (texts * b)[:b]}).encode()
            rec = bucket_latency(url, svc, payload_v, payload_t)
            for tower, payload in (("video", payload_v), ("text", payload_t)):
                busy, acts, groups = device_trace(
                    lambda: post(f"{url}/embed_{tower}", payload), PROFILED_REQUESTS)
                rec[f"{tower}_device_busy_ms"] = busy
                rec[f"{tower}_idle_share"] = 1 - busy / rec[f"{tower}_p50_ms"]
                rec[f"{tower}_device_activities"] = acts
                if tower == "video":
                    rec["video_device_ms_by_group"] = groups
            perf[b] = rec
            print(f"serve bucket {b} ({smi}): " + json.dumps(rec), flush=True)
        launches = {"ln_mlp": ln_mlp.launches, "space_attention": space_attention.launches}
        forwards = svc.tower_calls["video"]
        # ---- end of the counted run ----
        for name, n in launches.items():
            if forwards == 0 or n != 12 * forwards:
                raise AssertionError(f"{name}: {n} launches for {forwards} video "
                                     "forwards, want 12 per forward")
        print(f"serve: /embed_video b1 {e1.shape} b4 {e4.shape}, /embed_text, "
              f"/index_video, /search top-5 sorted, /stats ok; {forwards} video "
              f"forwards, launches {launches}", flush=True)
        print(f"serve p50 per bucket ({smi}): " + json.dumps({
            b: {k: r[k] for k in ("video_p50_ms", "video_p50_spread", "text_p50_ms",
                                  "text_p50_spread", "video_idle_share")}
            for b, r in perf.items()}), flush=True)

        # the served embedding against the same model on the plain versions
        with plain_versions():
            ref = svc.embed_video(clip1)
        cos = float((e1 * ref).sum() / np.linalg.norm(e1) / np.linalg.norm(ref))
        err = float(np.abs(e1 - ref).max())
        print(f"serve: b1 embedding vs plain versions on the card: cosine {cos:.6f}, "
              f"max_abs_err {err:.3e} (|ref|max {np.abs(ref).max():.3e})", flush=True)
        if not cos >= E2E_MIN_COSINE:
            raise AssertionError(f"served embedding cosine {cos} < {E2E_MIN_COSINE}")
        return launches
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from oatx_torch.ops.kernels import _build

    # TF32 off: the plain versions and every f32 matmul / convolution on the
    # card must run in full f32 to serve as references (cuDNN convs default
    # to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader", "-i", "0"])
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    secs = _build.build_all()
    ptxas = {k: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for k, log in _build.build_logs.items()}
    print(f"build: nvcc {secs:.1f} s for {[s.name for s in _build.sources()]} "
          f"(sm_90a); ptxas: {json.dumps(ptxas)}", flush=True)

    g = torch.Generator(dev).manual_seed(0)
    kernels = [kernel_ln_mlp(dev, g), kernel_space_attention(dev, g)]
    print("kernels " + " | ".join(
        f"{k['name']}: {k['shape']}, max_abs_err {k['max_abs_err']:.3e}, "
        f"max_rel_err {k['max_rel_err']:.3e}, tolerance |err| <= {k['atol']} + "
        f"2^-7·|ref| used to {k['tol_used']:.3f}, ref rms {k['ref_rms']:.3e} "
        f"max {k['ref_max']:.3e}, "
        f"kernel_ms {k['ms']:.4f}, plain_ms {k['plain_ms']:.4f}, "
        f"library_ms {k['library_ms']:.4f}, bound_ms {k['bound_ms']:.4f} "
        f"({k['bound_by']})" for k in kernels) + f" [{smi}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        launches = serve_phase(tmp, smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
