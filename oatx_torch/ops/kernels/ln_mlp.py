"""Fused LayerNorm → fc1 → GELU → fc2 (the ViT MLP sublayer), with its gradient.

Replaces the TPU kernel oatx/ops/pallas/ln_mlp.py `_fwd_pallas` (:98-121,
body `_kernel` :84-95) and computes what its `_fwd_xla` (:124-135) computes:

    y = (GELU(LN(x)·γ + β @ W1 + b1) @ W2 + b2)

with f32 LN statistics (eps from the caller), z and h cast to the compute dtype
before each matmul, f32 accumulation, biases added in f32, exact-erf GELU.

What bounds it on an H100: operations. At R = 3140 rows (serving bucket 4)
it does 2·2·R·768·3072 ≈ 29.6 GFLOP, 0.030 ms at 989 TFLOP/s, while the
≈ 14 MB it must move (x, y, W1, W2) take ≈ 4 µs at 3.35 TB/s.

Design (csrc/ln_mlp.cu on csrc/hopper.cuh, the mainloop of kernel 3): two
hand-written products through a bf16 hidden tensor h (R, H) that the
wrapper allocates. `ln_mlp_up_kernel` is kernel 3's LayerNorm → linear
(persistent grid of 128 × 256 tiles, one producer warp issuing TMA loads
into a 4-stage mbarrier ring in the 128-byte swizzle, two consumer
warpgroups on wgmma m64n256k16, z written in place over each x chunk) with
+ b1 → exact-erf GELU → bf16 in its epilogue, stored to h by TMA.
`ln_mlp_down_kernel` is the same mainloop on h and W2 without the
LayerNorm, + b2 → y. When y has fewer 128 × 256 tiles than half the SMs
(bucket 1: 7 × 3 tiles), `_down_split` splits the second product's hidden
dimension into K ranges: `ln_mlp_part_kernel` writes each range's f32 sum
to a workspace and `ln_mlp_sum_kernel` adds them in order, then b2
(deterministic). h goes through device memory because a block cannot hold
its rows' whole y in registers (BM × 768 f32 is 384 KB at BM = 128, 1.5×
an SM's register file) and splitting y's columns recomputes fc1; h costs
one write and one read of R·H bf16, much of it in the 50 MB L2.

Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, device
busy per call; PERF.md §6): 0.051 / 0.120 / 0.200 ms at R = 785 / 3140 /
6280 (≈ 248 TFLOP/s at 3140, 4.0× its bound), 3.8-8.9× faster than the
one-kernel WMMA design it replaced, in turns in the same call; cuBLAS's
layer_norm → linear → gelu → linear takes 0.028 / 0.068 / 0.131 ms. At
785 rows a call's host work (≈ 0.1 ms) outlasts its kernels.

Gradient: `ln_mlp` is a torch.autograd.Function. Its backward is
`ln_mlp_backward`, plain PyTorch that mirrors oatx's `_ln_mlp2d_bwd`
(:154-186; oatx has no Pallas backward either): the statistics, z, pre1 and
h are recomputed from the saved x, and the six products go to cuBLAS as bf16
operands with f32 outputs (`_common.mm_f32`). No backward kernel is written
by hand yet.

The forward is the custom op `oatx_torch::ln_mlp` (`ln_mlp_op`), so that
torch.export keeps it in an exported program whole: on a CPU tensor it runs
`ln_mlp_plain`, on a CUDA tensor it launches the kernels or raises, on a
fake tensor it gives the output's shape. The backward is the same on both
devices. One call counts one launch in `ln_mlp.launches`, whichever device
kernels it runs, inside an exported program too.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from oatx_torch.ops.kernels import _build
from oatx_torch.ops.kernels._common import ln_parts, mm_f32

_TILE_ROWS, _TILE_COLS, _CHUNK = 128, 256, 64  # csrc/hopper.cuh BM, BN, KC
_count_lock = threading.Lock()


def ln_mlp_plain(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float = 1e-6):
    """Plain PyTorch version (oatx `_fwd_xla`); weights in torch layout."""
    dt = x.dtype
    z = (ln_parts(x, eps)[0] * ln_w.float() + ln_b.float()).to(dt)
    # operands rounded to the compute dtype, products summed in f32
    pre1 = z.float() @ fc1_w.to(dt).float().t()
    h = F.gelu(pre1 + fc1_b.float()).to(dt)
    y = h.float() @ fc2_w.to(dt).float().t()
    return (y + fc2_b.float()).to(dt)


def ln_mlp_backward(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, dy, eps: float = 1e-6):
    """VJP of `ln_mlp` on 2-D x (R, K) (oatx `_ln_mlp2d_bwd`, torch layout).
    → (dx, dγ, dβ, dW1, db1, dW2, db2), each in its input's dtype; db2
    (fc2_b is not an input) in f32, as oatx returns it."""
    dt = x.dtype
    u, rstd = ln_parts(x, eps)
    z = (u * ln_w.float() + ln_b.float()).to(dt)
    w1, w2 = fc1_w.to(dt), fc2_w.to(dt)
    pre1 = mm_f32(z, w1.t()) + fc1_b.float()
    h = F.gelu(pre1).to(dt)

    db2 = dy.float().sum(dim=0)
    dw2 = mm_f32(dy.t(), h)                      # (N, H)
    dh = mm_f32(dy, w2)                          # (R, H)
    # exact-GELU derivative: Φ(x) + x·φ(x)
    phi = 0.5 * (1.0 + torch.erf(pre1 * 0.7071067811865476))
    pdf = torch.exp(-0.5 * pre1 * pre1) * 0.3989422804014327
    dpre1 = (dh * (phi + pre1 * pdf)).to(dt)
    db1 = dpre1.float().sum(dim=0)
    dw1 = mm_f32(dpre1.t(), z)                   # (H, K)
    dz = mm_f32(dpre1, w1)                       # (R, K)
    dgamma = (dz * u).sum(dim=0)
    dbeta = dz.sum(dim=0)
    du = dz * ln_w.float()
    dx = rstd * (du - du.mean(dim=-1, keepdim=True)
                 - u * (du * u).mean(dim=-1, keepdim=True))
    return (dx.to(dt), dgamma.to(ln_w.dtype), dbeta.to(ln_b.dtype),
            dw1.to(fc1_w.dtype), db1.to(fc1_b.dtype), dw2.to(fc2_w.dtype), db2)


def _fn(lib):
    f = lib.ln_mlp_fwd_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _down_split(rows: int, hidden: int, n: int, sms: int) -> int:
    """K ranges of the second product (h @ W2ᵀ): 1 when y's 128 × 256 tiles
    fill at least half the card, else as many ranges as give every SM a
    unit, each of at least 4 chunks of 64 hidden columns (the ring's depth)."""
    tiles = -(-rows // _TILE_ROWS) * -(-n // _TILE_COLS)
    if 2 * tiles > sms:
        return 1
    return max(1, min(sms // tiles, -(-hidden // _CHUNK) // 4))


def _launch(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
    """The CUDA kernels on 2-D bf16 x (R, K) → y (R, N) bf16."""
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"ln_mlp kernel takes bf16 activations, got {x2.dtype}")
    k = x2.shape[-1]
    hid, n = fc1_w.shape[0], fc2_w.shape[0]
    if fc1_w.shape != (hid, k) or fc2_w.shape != (n, hid) or fc1_b.shape != (hid,) \
            or fc2_b.shape != (n,) or ln_w.shape != (k,) or ln_b.shape != (k,):
        raise ValueError(f"ln_mlp: fc1 {tuple(fc1_w.shape)}, {tuple(fc1_b.shape)}, fc2 "
                         f"{tuple(fc2_w.shape)}, {tuple(fc2_b.shape)}, LN "
                         f"{tuple(ln_w.shape)}, {tuple(ln_b.shape)} do not fit D={k}")
    if k % 8 or hid % 8 or n % 8 or 0 in (k, hid, n):
        raise ValueError(f"ln_mlp kernel: unsupported widths D={k} hidden={hid} "
                         f"out={n} (each a positive multiple of 8: TMA reads rows "
                         "of 16-byte multiples)")
    x2 = x2.contiguous()
    rows = x2.shape[0]
    dev = x2.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    args = [x2,
            ln_w.to(**f32).contiguous(), ln_b.to(**f32).contiguous(),
            fc1_w.to(**bf16).contiguous(), fc1_b.to(**f32).contiguous(),
            fc2_w.to(**bf16).contiguous(), fc2_b.to(**f32).contiguous()]
    for a in args:
        if a.device != dev:
            raise ValueError("ln_mlp: all operands must be on one device")
    # TMA reads x, W1 and W2; the LayerNorm reads γ and β, the split's sum
    # b2, in 16-byte pieces
    args = [a if a.data_ptr() % 16 == 0 else a.clone() for a in args]
    y = torch.empty((rows, n), **bf16)
    if rows == 0:
        return y
    h = torch.empty((rows, hid), **bf16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = _down_split(rows, hid, n, sms)
    part = None
    if split > 1:
        part = torch.empty((split, -(-rows // _TILE_ROWS) * _TILE_ROWS, n), **f32)
    lib = _build.load("ln_mlp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _fn(lib)(*[a.data_ptr() for a in args], y.data_ptr(), h.data_ptr(),
                       part.data_ptr() if part is not None else None,
                       rows, k, hid, n, split, float(eps), stream)
    _build.check(lib, err, "ln_mlp")
    with _count_lock:
        ln_mlp.launches += 1
    return y


@torch.library.custom_op("oatx_torch::ln_mlp", mutates_args=(), device_types="cpu")
def ln_mlp_op(x2: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              fc1_w: torch.Tensor, fc1_b: torch.Tensor, fc2_w: torch.Tensor,
              fc2_b: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward as one op, which torch.export keeps in its graph: the
    plain version on the CPU, the kernels on CUDA, shapes alone on fake
    tensors."""
    return ln_mlp_plain(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)


# looks `_launch` up at each call, so a caller may put another build in its
# place (chip_smoke.py's --parent-* turns)
@ln_mlp_op.register_kernel("cuda")
def _cuda(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
    return _launch(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)


@ln_mlp_op.register_fake
def _fake(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
    return x2.new_empty((x2.shape[0], fc2_w.shape[0]))


class _LnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w)
        ctx.db2_dtype = fc2_b.dtype
        if x2.device.type not in ("cpu", "cuda"):
            raise ValueError(f"ln_mlp: unsupported device {x2.device}")
        return torch.ops.oatx_torch.ln_mlp(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)

    @staticmethod
    def backward(ctx, dy):
        *grads, db2 = ln_mlp_backward(*ctx.saved_tensors, dy, ctx.eps)
        return (*grads, db2.to(ctx.db2_dtype), None)


def ln_mlp(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float = 1e-6):
    """mlp(layer_norm(x)) in one pass, differentiable. x (..., D); fc1_w
    (4D, D) and fc2_w (D, 4D) in torch layout; LN params and biases in any
    float dtype."""
    k = x.shape[-1]
    y = _LnMlp.apply(x.reshape(-1, k), ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)
    return y.reshape(*x.shape[:-1], y.shape[-1])


ln_mlp.launches = 0
