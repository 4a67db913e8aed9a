#!/usr/bin/env python3
"""Drive the oatx_torch port once on one CUDA card and check it.

    python3 chip_smoke.py [--parent-ln-linear LIB] [--parent-ln-mlp LIB]

--parent-ln-linear names a library built from another csrc/ln_linear.cu
with the same C interface (`ln_linear_fwd_bf16`), e.g. an earlier commit's:
the kernels phase then also checks it and times it in turns with this
tree's kernel (parent, this, this, parent), alone and under forward +
backward, at the train step's shape. --parent-ln-mlp does the same for an
earlier csrc/ln_mlp.cu with the one-kernel C interface (8 pointers, 4 ints,
eps, stream), at R = 785, 3140 and 6280.

Phases (any failure raises: the exit code is then not 0 and no `ok` line is
printed):
  1. environment — the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the nvcc build of every kernel in oatx_torch/csrc;
  2. kernels — each hand-written kernel against its plain PyTorch version on
     the card (bf16): kernel 1 (ln_mlp) at R = 785, 3140 and 6280 rows (its
     record at bucket 4's 3140, with the ms of each split of its second
     product), kernel 2 at bucket 4's serving shapes, kernel 3 (ln_linear)
     at the train step's LN→qkv shape, each with its
     time, achieved TFLOP/s, ptxas registers and spills, the plain
     version's time, one PyTorch library call's and the card's bound; and
     for all three the forward + backward time (and device busy time)
     through the kernel's autograd.Function at the train step's shapes;
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
  4. train — the flagship pretraining step that bench.py builds (ViT-B/16
     divided space-time over 4×224² + DistilBERT-base, 256-d projections,
     bf16 compute with f32 master weights, NormSoftmax at 0.05, AdamW at
     2e-4, batch 8, seq_len 24, random weights from seed 0, one fixed
     numpy-seeded batch), through oatx_torch.train.step's init_state and
     make_train_step, once with fused_qkv=True and once with False. Per run:
     TRAIN_STEPS counted steps (launch counters set to 0 just before and read
     just after: 12 ln_mlp, 12 space_attention and 24 or 0 ln_linear per
     step), each step's loss (finite, and lower at the end than at step 1),
     the median step time over TIME_WINDOWS windows with their spread,
     clips/s, MFU, peak device memory, a CUDA-only device trace, and one
     step's gradients through the kernels against the same through the plain
     versions: every parameter must have a finite gradient. The two runs'
     step-1 losses agree within bf16 tolerance.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import ctypes
import io
import json
import os
import re
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
# ln_linear's output at these inputs (LN(x) rows of 768 times N(0, 0.02²)
# weights, plus a bias) has rms ≈ 0.56; both versions sum the same bf16
# products in f32, so only a flipped bf16 rounding of z or of the output
# separates them: atol 2e-3, 0.4 % of the rms.
LN_LINEAR_ATOL = 2e-3
# Served embedding (12 blocks, bf16) vs the same model with the plain versions
# on the card: the per-layer differences above compound through depth.
E2E_MIN_COSINE = 0.999
TRAIN_BATCH = 8        # bench.py:83-85: batch 8, 4 frames, seq_len 24
TRAIN_SEQ = 24
TRAIN_STEPS = 10       # counted steps per fused_qkv setting (the loss must fall)
TIME_WINDOWS = 5       # timed windows after them; the first is dropped
WINDOW_STEPS = 5       # steps per timed window
PROFILED_STEPS = 2
TOP_OTHER = 8          # largest "other" kernels listed in a train step's trace
# One step's gradients through the kernels vs through the plain versions on
# the card, same weights and batch (bf16 compute through 12 + 6 layers; the
# two backward passes round at different points): per tensor
# ‖g − r‖ ≤ GRAD_RTOL·‖r‖ + GRAD_ATOL·(global ‖r‖) (grad_check), and the
# global norms' relative difference.
# Measured (NVIDIA H100 80GB HBM3, 700.00 W): the tensors that carry the
# gradient agree to ≤ 4.5 % each (patch_embed.proj.weight, the worst), the
# time branch's to 6-106 % of their own size but ≤ 0.6 % of the global norm;
# global norms within 0.53 %, global cosine ≥ 0.99987.
GRAD_RTOL = 0.1
GRAD_ATOL = 0.02
GRAD_NORM_RTOL = 0.02
GRAD_MIN_GLOBAL_COSINE = 0.999
# fused_qkv on vs off, step 1 from the same weights: the same function with
# the qkv product summed by kernel 3 instead of cuBLAS and its bias added in
# f32 instead of bf16 (zero at init): bf16 roundings only. Measured 8.4e-4
# on an H100.
FUSED_LOSS_RTOL = 1e-2
LAT_REQUESTS = 100     # timed requests per bucket and round, after warm-up
LAT_ROUNDS = 3         # rounds per bucket: the p50's spread inside one call
LAT_WARMUP = 5
PROFILED_REQUESTS = 10
# device kernels by name, for the per-group breakdown of a video request
KERNEL_GROUPS = (("ln_mlp", ("ln_mlp_",)),
                 ("space_attention", ("space_attention_kernel",)),
                 ("ln_linear", ("ln_linear_kernel",)),
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


def ptxas_report(log):
    """Registers and spill bytes of every kernel in one nvcc -Xptxas -v log,
    e.g. [{"kernel": "ln_linear_kernel", "registers": 168,
    "spill_stores": 36, "spill_loads": 56}]."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E)+E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(2):
                name += "<" + ", ".join(re.findall(r"Li(\d+)E", k.group(2))) + ">"
            cur = {"kernel": name}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def kernel_name(name):
    """The `..._kernel` identifier in a device kernel's name from a trace."""
    m = re.search(r"\w+_kernel", name)
    return m.group(0) if m else name


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


LN_MLP_ROWS = (785, 3140, 6280)  # serving buckets 1 and 4; bucket 16's halves, the train step
LN_MLP_RECORD_ROWS = 3140        # the record's ms, errors and bound
LN_MLP_SPLITS = (1, 2, 3, 6)     # K ranges of the second product, timed at each R


def load_parent_ln_mlp(path):
    """The library at `path`, built from an earlier csrc/ln_mlp.cu with the
    one-kernel C interface ln_mlp_fwd_bf16(x, gamma, beta, w1, b1, w2, b2, y,
    R, K, H, N, eps, stream), as a drop-in for ln_mlp's `_launch`."""
    lib = ctypes.CDLL(os.path.abspath(path))
    f = lib.ln_mlp_fwd_bf16
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def launch(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
        dev, f32, bf = x2.device, torch.float32, torch.bfloat16
        args = [x2.contiguous(), ln_w.to(f32).contiguous(), ln_b.to(f32).contiguous(),
                fc1_w.to(bf).contiguous(), fc1_b.to(f32).contiguous(),
                fc2_w.to(bf).contiguous(), fc2_b.to(f32).contiguous()]
        y = torch.empty((x2.shape[0], fc2_w.shape[0]), dtype=bf, device=dev)
        err = f(*[a.data_ptr() for a in args], y.data_ptr(), x2.shape[0], x2.shape[1],
                fc1_w.shape[0], fc2_w.shape[0], float(eps),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"parent ln_mlp: CUDA error {err}")
        return y

    return launch


@contextlib.contextmanager
def ln_mlp_library(parent):
    """ln_mlp's Function launches `parent` instead of its own kernels (None:
    its own)."""
    from oatx_torch.ops.kernels import ln_mlp as plm

    saved = plm._launch
    if parent is not None:
        plm._launch = parent
    try:
        yield
    finally:
        plm._launch = saved


def kernel_ln_mlp(dev, g, parent=None):
    """Kernel 1 at each of LN_MLP_ROWS (ViT-B/16's MLP, 768 → 3072 → 768):
    errors against the plain version, ms, bound, library ms and TFLOP/s; ms
    at each split of the second product (stage B); with `parent`, the
    parent's errors and ms in turns (parent, this, this, parent). The
    record's top-level numbers are those at LN_MLP_RECORD_ROWS."""
    from oatx_torch.ops.kernels import ln_mlp as plm

    D, H = 768, 3072
    bf = torch.bfloat16
    xs = torch.randn(max(LN_MLP_ROWS), D, device=dev, generator=g).to(bf)
    gamma = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
    beta = 0.1 * torch.randn(D, device=dev, generator=g)
    w1 = (0.02 * torch.randn(H, D, device=dev, generator=g)).to(bf)
    b1 = 0.02 * torch.randn(H, device=dev, generator=g)
    w2 = (0.02 * torch.randn(D, H, device=dev, generator=g)).to(bf)
    b2 = 0.02 * torch.randn(D, device=dev, generator=g)
    gb, bb, b1b, b2b = (t.to(bf) for t in (gamma, beta, b1, b2))
    by_rows = {}
    for R in LN_MLP_ROWS:
        x = xs[:R]
        args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
        got = plm.ln_mlp(*args)
        torch.cuda.synchronize()
        want = plm.ln_mlp_plain(*args)
        rec = check_close(f"ln_mlp R={R}", got, want, LN_MLP_ATOL)

        def library():
            z = F.layer_norm(x, (D,), gb, bb, 1e-6)
            return F.linear(F.gelu(F.linear(z, w1, b1b)), w2, b2b)

        nbytes = 2 * R * D * 2 + 2 * D * H * 2 + (2 * D + H + D) * 4
        flops = 2 * R * D * H * 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
        rec["flops"] = flops
        call = lambda: plm.ln_mlp(*args)  # noqa: E731
        rec["ms"] = time_ms(call)
        # the same calls' device busy time, without the host's gaps that
        # events count where a call's host work outlasts its kernels, and
        # its device kernels' ms (up, down or part + sum)
        busy, _, _, kernels = device_trace(call, 20, top_of="ln_mlp")
        rec["device_ms"] = busy
        rec["device_ms_by_kernel"] = {kernel_name(k): v for k, v in kernels}
        rec["library_ms"] = time_ms(library)
        rec["library_device_ms"] = device_trace(library, 20)[0]
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["split_rule"] = plm._down_split(R, H, D, torch.cuda.get_device_properties(dev)
                                            .multi_processor_count)
        # stage B: each split of the second product in place of
        # `_down_split`'s choice, launched without the autograd.Function
        # (events, device busy)
        splits, rule = {}, plm._down_split
        fn = lambda: plm._launch(*args)  # noqa: E731
        try:
            for sp in LN_MLP_SPLITS:
                plm._down_split = lambda *_, sp=sp: sp
                check_close(f"ln_mlp R={R} split={sp}", fn(), want, LN_MLP_ATOL)
                splits[sp] = (time_ms(fn), device_trace(fn, 20)[0])
        finally:
            plm._down_split = rule
        rec["ms_by_split"] = {sp: t[0] for sp, t in splits.items()}
        rec["device_ms_by_split"] = {sp: t[1] for sp, t in splits.items()}
        if R == LN_MLP_RECORD_ROWS:
            rec["plain_ms"] = time_ms(lambda: plm.ln_mlp_plain(*args), iters=5)
        if parent is not None:
            with ln_mlp_library(parent):
                perr = check_close(f"ln_mlp R={R} (parent)", plm.ln_mlp(*args), want,
                                   LN_MLP_ATOL)
            turns, busy = [], []
            for lib in (parent, None, None, parent):
                with ln_mlp_library(lib):
                    turns.append(time_ms(call))
                    busy.append(device_trace(call, 20)[0])
            rec["parent"] = {"ms_turns": turns, "device_ms_turns": busy,
                             "max_abs_err": perr["max_abs_err"], "tol_used": perr["tol_used"]}
        by_rows[R] = rec
    top = by_rows[LN_MLP_RECORD_ROWS]
    return {
        "name": "ln_mlp", "route": "cuda", "source": "oatx_torch/csrc/ln_mlp.cu",
        "replaces": "oatx/ops/pallas/ln_mlp.py:98",
        **{k: top[k] for k in ("max_abs_err", "max_rel_err", "tol_used", "ref_rms",
                               "ref_max", "atol", "ms", "plain_ms", "bound_ms", "bound_by",
                               "flops", "library_ms")},
        "by_rows": {R: {k: v for k, v in r.items() if k not in ("flops", "plain_ms")}
                    for R, r in by_rows.items()},
        "shape": f"x ({LN_MLP_RECORD_ROWS}, {D}) bf16, hidden {H}",
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
        "bound_ms": b, "bound_by": by, "flops": flops,
        "library_ms": time_ms(library),
        "shape": f"q/k/v ({B}, {T}, {Hh}, {Dh}) bf16, {Fr} frames",
    }


def load_parent_ln_linear(path):
    """The library at `path`, built from another csrc/ln_linear.cu with the
    same C interface, set up as ln_linear's `_lib()` sets up its own."""
    lib = ctypes.CDLL(os.path.abspath(path))
    f = lib.ln_linear_fwd_bf16
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def ln_linear_library(lib):
    """ln_linear launches `lib`'s kernel instead of its own (None: its own)."""
    from oatx_torch.ops.kernels import ln_linear as pll

    saved = pll._lib
    if lib is not None:
        pll._lib = lambda: lib
    try:
        yield
    finally:
        pll._lib = saved


def kernel_ln_linear(dev, g, parent=None):
    from oatx_torch.ops.kernels.ln_linear import ln_linear, ln_linear_plain

    R, K, N = TRAIN_BATCH * 785, 768, 2304  # the train step's LN→qkv
    bf = torch.bfloat16
    x = torch.randn(R, K, device=dev, generator=g).to(bf)
    gamma = 1 + 0.1 * torch.randn(K, device=dev, generator=g)
    beta = 0.1 * torch.randn(K, device=dev, generator=g)
    w = (0.02 * torch.randn(N, K, device=dev, generator=g)).to(bf)
    b = 0.02 * torch.randn(N, device=dev, generator=g)
    args = (x, gamma, beta, w, b, 1e-6)
    got = ln_linear(*args)
    torch.cuda.synchronize()
    want = ln_linear_plain(*args)
    errs = check_close("ln_linear", got, want, LN_LINEAR_ATOL)
    gb, bb, bbf = (t.to(bf) for t in (gamma, beta, b))

    def library():
        return F.linear(F.layer_norm(x, (K,), gb, bb, 1e-6), w, bbf)

    nbytes = R * K * 2 + N * K * 2 + R * N * 2 + (2 * K + N) * 4
    flops = 2 * R * K * N
    bound, by = bound_ms(nbytes, flops)
    rec = {
        "name": "ln_linear", "route": "cuda", "source": "oatx_torch/csrc/ln_linear.cu",
        "replaces": "oatx/ops/pallas/ln_linear.py:58", **errs,
        "ms": time_ms(lambda: ln_linear(*args)),
        "plain_ms": time_ms(lambda: ln_linear_plain(*args), iters=5),
        "bound_ms": bound, "bound_by": by, "flops": flops,
        "library_ms": time_ms(library),
        "shape": f"x ({R}, {K}) bf16 -> ({R}, {N})",
    }
    if parent is not None:
        with ln_linear_library(parent):
            perr = check_close("ln_linear (parent)", ln_linear(*args), want, LN_LINEAR_ATOL)
        turns = []
        for lib in (parent, None, None, parent):
            with ln_linear_library(lib):
                turns.append(time_ms(lambda: ln_linear(*args)))
        rec["parent"] = {"ms_turns": turns, "max_abs_err": perr["max_abs_err"],
                         "tol_used": perr["tol_used"]}
    return rec


def fwd_bwd_ms(dev, g, parent=None):
    """Forward + backward through kernels 2 and 3's autograd.Functions at the
    train step's shapes (B = 8, T = 785: 6280 rows; f32 master weights as the
    model holds them; kernel 1's is ln_mlp_fwd_bwd's): (ms by CUDA events
    over 10 iterations after warm-up, which counts the host's gaps between
    launches; device busy ms of one call from a CUDA-only trace of 5, which
    does not). With `parent`, "ln_linear_parent" holds the same through the
    parent's kernel, timed before and after this tree's: ((events ms, events
    ms), device ms)."""
    from oatx_torch.ops.kernels.ln_linear import ln_linear
    from oatx_torch.ops.kernels.space_attention import space_attention

    R, D = TRAIN_BATCH * 785, 768

    def leaf(*shape, scale=1.0, dtype=torch.float32, offset=0.0):
        t = offset + scale * torch.randn(*shape, device=dev, generator=g)
        return t.to(dtype).requires_grad_()

    x = leaf(R, D, dtype=torch.bfloat16)
    ln = (leaf(D, scale=0.1, offset=1.0), leaf(D, scale=0.1))
    qkv = leaf(TRAIN_BATCH, 785, 3, 12, 64, dtype=torch.bfloat16)
    calls = {
        "ln_linear": (ln_linear, (x, *ln, leaf(3 * D, D, scale=0.02),
                                  leaf(3 * D, scale=0.02))),
        "space_attention": (lambda t: space_attention(t[:, :, 0] * 0.125, t[:, :, 1],
                                                      t[:, :, 2], 4), (qkv,)),
    }
    out = {}
    for name, (fn, args) in calls.items():
        dy = torch.randn(fn(*args).shape, device=dev, generator=g).to(torch.bfloat16)
        call = lambda: torch.autograd.grad(fn(*args), args, dy)  # noqa: E731
        if name == "ln_linear" and parent is not None:
            with ln_linear_library(parent):
                before = time_ms(call, iters=10)
        out[name] = time_ms(call, iters=10), device_trace(call, 5)[0]
        if name == "ln_linear" and parent is not None:
            with ln_linear_library(parent):
                out["ln_linear_parent"] = ((before, time_ms(call, iters=10)),
                                           device_trace(call, 5)[0])
    return out


def ln_mlp_fwd_bwd(dev, g, parent=None):
    """Forward + backward through ln_mlp's Function at each of LN_MLP_ROWS
    (f32 master weights, as the model holds them): {R: {"ms": CUDA events
    over 10 calls, "device_ms": device busy of one call from a trace of 5}};
    with `parent`, the same through the parent's kernel, timed before and
    after this tree's ("parent_ms": [before, after], "parent_device_ms")."""
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp

    D, H = 768, 3072

    def leaf(*shape, scale=1.0, dtype=torch.float32, offset=0.0):
        t = offset + scale * torch.randn(*shape, device=dev, generator=g)
        return t.to(dtype).requires_grad_()

    params = (leaf(D, scale=0.1, offset=1.0), leaf(D, scale=0.1), leaf(H, D, scale=0.02),
              leaf(H, scale=0.02), leaf(D, H, scale=0.02), leaf(D, scale=0.02))
    out = {}
    for R in LN_MLP_ROWS:
        args = (leaf(R, D, dtype=torch.bfloat16), *params)
        dy = torch.randn(R, D, device=dev, generator=g).to(torch.bfloat16)
        call = lambda: torch.autograd.grad(ln_mlp(*args), args, dy)  # noqa: E731
        rec = {}
        if parent is not None:
            with ln_mlp_library(parent):
                before = time_ms(call, iters=10)
        rec["ms"], rec["device_ms"] = time_ms(call, iters=10), device_trace(call, 5)[0]
        if parent is not None:
            with ln_mlp_library(parent):
                rec["parent_ms"] = [before, time_ms(call, iters=10)]
                rec["parent_device_ms"] = device_trace(call, 5)[0]
        out[R] = rec
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the towers through the kernels' plain versions (reference run;
    autograd differentiates them directly)."""
    from oatx_torch.models import vit_spacetime
    from oatx_torch.ops import attention
    from oatx_torch.ops.kernels.ln_linear import ln_linear_plain
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp_plain
    from oatx_torch.ops.kernels.space_attention import space_attention_plain

    saved = vit_spacetime.ln_mlp, attention.space_attention, attention.ln_linear
    vit_spacetime.ln_mlp = ln_mlp_plain
    attention.space_attention = space_attention_plain
    attention.ln_linear = ln_linear_plain
    try:
        yield
    finally:
        vit_spacetime.ln_mlp, attention.space_attention, attention.ln_linear = saved


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


def device_trace(fn, n, top_of="other"):
    """Trace n calls of fn with CUDA activity only (no host-side tracing to
    slow the host-bound path). Returns per call: device busy ms (the union of
    kernel and copy intervals), device activities, device ms by group, and
    the TOP_OTHER largest kernels of the group `top_of` by ms."""
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
    other: dict = {}
    for s, e, name in iv:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e3 / n
        if g == top_of:
            other[name[:80]] = other.get(name[:80], 0.0) + (e - s) / 1e3 / n
    top = sorted(other.items(), key=lambda kv: -kv[1])[:TOP_OTHER]
    return busy_us / 1e3 / n, len(iv) / n, groups, top


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
                busy, acts, groups, _ = device_trace(
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


def grad_check(got, ref):
    """Per-tensor agreement of two gradient sets: ‖g − r‖ ≤ GRAD_RTOL·‖r‖ +
    GRAD_ATOL·‖r‖_all, where ‖r‖_all is the global norm (the absolute part
    covers tensors whose gradient is rounding noise in both: at time_init
    'zeros' the time branch adds a constant to every channel, which norm1
    removes, so its true gradient is 0). Returns the record's grad_* keys."""
    d = {n: float((got[n].double() - ref[n].double()).norm()) for n in ref}
    r = {n: float(ref[n].double().norm()) for n in ref}
    total = float(np.sqrt(sum(v * v for v in r.values())))
    gnorm = float(np.sqrt(sum(float(g.double().square().sum()) for g in got.values())))
    used = {n: d[n] / (GRAD_RTOL * r[n] + GRAD_ATOL * total) for n in ref}
    dot = sum(float((got[n].double() * ref[n].double()).sum()) for n in ref)
    worst = sorted(used, key=used.get, reverse=True)[:6]
    return {"grad_norm": gnorm, "plain_grad_norm": total,
            "grad_norm_rel_diff": abs(gnorm - total) / total,
            "grad_global_cosine": dot / (gnorm * total),
            "grad_tol_used": used[worst[0]], "grad_tensors": len(ref),
            "grad_worst": [(n, round(used[n], 4), r[n] / total, d[n] / max(r[n], 1e-30))
                           for n in worst]}


def train_cfg(fused_qkv):
    """bench.py:101-113's model: ViT-B/16 over 4 frames (time attention
    zero-initialised), DistilBERT-base, 256-d projections, bf16 compute."""
    from oatx_torch.models import distilbert as dbert
    from oatx_torch.models import towers
    from oatx_torch.models import vit_spacetime as vst

    return towers.TowerConfig(
        video=vst.SpaceTimeViTConfig(num_frames=4, time_init="zeros", fused_qkv=fused_qkv),
        text=dbert.DistilBertConfig(), projection_dim=256, variant="baseline",
        compute_dtype=torch.bfloat16)


def train_run(fused_qkv, batch, smi, dev):
    """One fused_qkv setting of the train phase; returns its record."""
    from oatx_torch.ops.kernels.ln_linear import ln_linear
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp
    from oatx_torch.ops.kernels.space_attention import space_attention
    from oatx_torch.train import optim, step as steplib
    from oatx_torch.train.flops import flops_forward_per_clip

    cfg = train_cfg(fused_qkv)
    depth = cfg.video.depth
    t0 = time.perf_counter()
    state = steplib.init_state(cfg, optim.make_optimizer(lr=2e-4), device=dev,
                               generator=torch.Generator(dev).manual_seed(0))
    train_step = steplib.make_train_step(cfg, steplib.LossConfig(), device=dev)
    tag = f"train fused_qkv={fused_qkv}"
    print(f"{tag}: model and AdamW built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)

    # ---- the main path, counted ----
    for k in (ln_mlp, space_attention, ln_linear):
        k.launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
    launches = {"ln_mlp": ln_mlp.launches, "space_attention": space_attention.launches,
                "ln_linear": ln_linear.launches}
    # ---- end of the counted run ----
    want = {"ln_mlp": depth, "space_attention": depth,
            "ln_linear": 2 * depth if fused_qkv else 0}
    for name, n in launches.items():
        if n != want[name] * TRAIN_STEPS:
            raise AssertionError(f"{tag}: {name} launched {n} times in {TRAIN_STEPS} "
                                 f"steps, want {want[name]} per step")
    print(f"{tag}: losses {json.dumps(losses)}; launches {launches} in "
          f"{TRAIN_STEPS} steps", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss not finite or not falling: {losses}")

    torch.cuda.reset_peak_memory_stats(dev)
    windows = []
    for _ in range(TIME_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            state, m = train_step(state, batch)
        float(m["loss"])
        windows.append((time.perf_counter() - t0) / WINDOW_STEPS * 1e3)
    kept = windows[1:]
    step_ms = float(np.median(kept))
    peak = torch.cuda.max_memory_allocated(dev)
    busy, acts, groups, top = device_trace(lambda: train_step(state, batch), PROFILED_STEPS)
    flops = 3.0 * flops_forward_per_clip(cfg.video, cfg.text, TRAIN_SEQ)
    rec = {"fused_qkv": fused_qkv, "step1_loss": losses[0], "last_loss": losses[-1],
           "step_ms": step_ms, "step_ms_spread": (max(kept) - min(kept)) / step_ms,
           "windows_ms": windows, "clips_per_s": TRAIN_BATCH / step_ms * 1e3,
           "mfu": TRAIN_BATCH / step_ms * 1e3 * flops / PEAK_BF16_FLOPS,
           "flops_per_clip_step": flops, "peak_mem_gib": peak / 2 ** 30,
           "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
           "device_activities": acts, "device_ms_by_group": groups,
           "device_top_other_ms": top,
           "launches": launches}

    # one step's gradients, kernels vs plain versions (not counted, no update)
    model = state.model

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = steplib.loss_fn(model, steplib.LossConfig(), batch)
        loss.backward()
        return {n: (p.grad.detach().clone() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    got = grads()
    with plain_versions():
        ref = grads()
    model.zero_grad(set_to_none=True)
    missing = [n for n, g in got.items() if g is None or not bool(torch.isfinite(g).all())]
    if missing:
        raise AssertionError(f"{tag}: {len(missing)} parameters without a finite "
                             f"gradient through the kernels, e.g. {missing[:5]}")
    rec.update(grad_check(got, ref))
    print(f"{tag} ({smi}): " + json.dumps(rec), flush=True)
    if rec["grad_tol_used"] > 1 or rec["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
            or rec["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
        raise AssertionError(f"{tag}: gradients through the kernels disagree with the "
                             f"plain versions: {rec['grad_worst']}")
    return rec


def train_phase(smi, dev, res=224):
    """The train step at full width, fused_qkv on then off (module docstring)."""
    rng = np.random.default_rng(0)  # bench.py:115-120
    batch = {
        "video": torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, 4, res, res, 3)).astype(np.float32)).to(dev, torch.bfloat16),
        "input_ids": torch.from_numpy(rng.integers(0, 30522, (TRAIN_BATCH, TRAIN_SEQ))).to(dev),
        "attention_mask": torch.ones(TRAIN_BATCH, TRAIN_SEQ, dtype=torch.int32, device=dev),
    }
    runs = [train_run(fused, batch, smi, dev) for fused in (True, False)]
    on, off = runs
    rel = abs(on["step1_loss"] - off["step1_loss"]) / abs(off["step1_loss"])
    print(f"train: step-1 loss fused_qkv on {on['step1_loss']:.6f} vs off "
          f"{off['step1_loss']:.6f} (rel {rel:.2e}); step ms {on['step_ms']:.3f} vs "
          f"{off['step_ms']:.3f}, clips/s {on['clips_per_s']:.3f} vs {off['clips_per_s']:.3f}, "
          f"MFU {on['mfu']:.4f} vs {off['mfu']:.4f}, peak GiB {on['peak_mem_gib']:.2f} vs "
          f"{off['peak_mem_gib']:.2f} ({smi})", flush=True)
    if rel > FUSED_LOSS_RTOL:
        raise AssertionError(f"fused_qkv on/off step-1 losses differ by {rel:.3e}")
    return {name: on["launches"][name] + off["launches"][name] for name in on["launches"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-ln-linear", metavar="LIB",
                    help="library built from another csrc/ln_linear.cu, timed beside this one")
    ap.add_argument("--parent-ln-mlp", metavar="LIB",
                    help="library built from an earlier csrc/ln_mlp.cu (one-kernel C "
                         "interface), timed beside this one")
    opts = ap.parse_args()
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
    ptxas = {k: ptxas_report(log) for k, log in _build.build_logs.items()}
    print(f"build: nvcc {secs:.1f} s for {[s.name for s in _build.sources()]} "
          f"(sm_90a); ptxas: {json.dumps(ptxas)}", flush=True)

    parent = None
    if opts.parent_ln_linear:
        parent = load_parent_ln_linear(opts.parent_ln_linear)
    parent_mlp = load_parent_ln_mlp(opts.parent_ln_mlp) if opts.parent_ln_mlp else None
    g = torch.Generator(dev).manual_seed(0)
    kernels = [kernel_ln_mlp(dev, g, parent_mlp), kernel_space_attention(dev, g),
               kernel_ln_linear(dev, g, parent)]
    fb = fwd_bwd_ms(dev, g, parent)
    for R, rec in ln_mlp_fwd_bwd(dev, g, parent_mlp).items():
        kernels[0]["by_rows"][R]["fwd_bwd"] = rec
    train_rows = kernels[0]["by_rows"][TRAIN_BATCH * 785]["fwd_bwd"]
    fb["ln_mlp"] = train_rows["ms"], train_rows["device_ms"]
    print(f"ln_mlp by rows ({smi}): {json.dumps(kernels[0]['by_rows'])}", flush=True)
    if parent is not None:
        (ev0, ev1), busy = fb["ln_linear_parent"]
        kernels[2]["parent"].update(fwd_bwd_ms=[ev0, ev1], fwd_bwd_device_ms=busy)
        print(f"ln_linear parent ({opts.parent_ln_linear}): {json.dumps(kernels[2]['parent'])}",
              flush=True)
    for k in kernels:
        k["fwd_bwd_ms"], k["fwd_bwd_device_ms"] = fb[k["name"]]
        k["tflops"] = k["flops"] / k["ms"] / 1e9  # achieved, 2 flops per multiply-add
        k["ptxas"] = ptxas.get(k["name"])
    print("kernels " + " | ".join(
        f"{k['name']}: {k['shape']}, max_abs_err {k['max_abs_err']:.3e}, "
        f"max_rel_err {k['max_rel_err']:.3e}, tolerance |err| <= {k['atol']} + "
        f"2^-7·|ref| used to {k['tol_used']:.3f}, ref rms {k['ref_rms']:.3e} "
        f"max {k['ref_max']:.3e}, "
        f"kernel_ms {k['ms']:.4f}, plain_ms {k['plain_ms']:.4f}, "
        f"library_ms {k['library_ms']:.4f}, bound_ms {k['bound_ms']:.4f} "
        f"({k['bound_by']}), {k['tflops']:.1f} TFLOP/s, "
        f"fwd_bwd_ms at the train shape {k['fwd_bwd_ms']:.4f} "
        f"(device busy {k['fwd_bwd_device_ms']:.4f})"
        for k in kernels) + f" [{smi}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        phases = {"serve": serve_phase(tmp, smi)}
    phases["train"] = train_phase(smi, dev)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol_used", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
            "fwd_bwd_ms", "fwd_bwd_device_ms", "ptxas", "launches_by_phase", "parent",
            "by_rows")
    for k in kernels:
        k["launches_by_phase"] = {ph: n[k["name"]] for ph, n in phases.items()
                                  if n.get(k["name"])}
        k["launches"] = sum(k["launches_by_phase"].values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']}: no launch on any main path")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
