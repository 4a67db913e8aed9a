"""Fused LayerNorm → fc1 → GELU → fc2 (the ViT MLP sublayer), with its gradient.

Replaces the TPU kernel oatx/ops/pallas/ln_mlp.py `_fwd_pallas` (:98-121,
body `_kernel` :84-95) and computes what its `_fwd_xla` (:124-135) computes:

    y = (GELU(LN(x)·γ + β @ W1 + b1) @ W2 + b2)

with f32 LN statistics (eps from the caller), z and h cast to the compute dtype
before each matmul, f32 accumulation, biases added in f32, exact-erf GELU.

What bounds it on an H100: operations. At R = 12560 rows (bucket 16 without
chunking) it does 2·2·R·768·3072 ≈ 118.5 GFLOP, ≈ 0.12 ms at 989 TFLOP/s,
while the ≈ 48 MB it must move take ≈ 14 µs at 3.35 TB/s.

Design (csrc/ln_mlp.cu): the Pallas kernel keeps all of W1 and W2 resident
in VMEM; a Hopper block has at most 227 KB of shared memory, so here each
block takes 32 rows, writes LN(x) as a bf16 tile into shared memory, then
walks the hidden dimension in chunks of 128: h = GELU(z @ W1[:, chunk] + b1)
stays in shared memory and y += h @ W2[chunk, :] accumulates in f32 WMMA
fragments spread over the block's 8 warps. The (rows × 4D) hidden tensor
never reaches device memory. W1/W2 fragments stream from L2 for every row
tile (no shared-memory staging, no TMA/wgmma yet) and bucket 1 (785 rows,
25 blocks) under-fills the 132 SMs: both are left for a later change.

Gradient: `ln_mlp` is a torch.autograd.Function. Its backward is
`ln_mlp_backward`, plain PyTorch that mirrors oatx's `_ln_mlp2d_bwd`
(:154-186; oatx has no Pallas backward either): the statistics, z, pre1 and
h are recomputed from the saved x, and the six products go to cuBLAS as bf16
operands with f32 outputs (`_common.mm_f32`). No backward kernel is written
by hand yet.

On a CPU tensor the forward runs `ln_mlp_plain`; on a CUDA tensor it
launches the kernel or raises. The backward is the same on both.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from oatx_torch.ops.kernels import _build
from oatx_torch.ops.kernels._common import ln_parts, mm_f32

_ROWS_PER_BLOCK = 32
_HIDDEN_CHUNK = 128
_WARPS = 8
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
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _launch(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
    """The CUDA kernel on 2-D bf16 x (R, K) → y (R, N) bf16."""
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"ln_mlp kernel takes bf16 activations, got {x2.dtype}")
    k = x2.shape[-1]
    hid, n = fc1_w.shape[0], fc2_w.shape[0]
    if fc1_w.shape != (hid, k) or fc2_w.shape != (n, hid):
        raise ValueError(f"ln_mlp: weight shapes {tuple(fc1_w.shape)}, "
                         f"{tuple(fc2_w.shape)} do not fit D={k}")
    if k % 16 or k > 1024 or hid % _HIDDEN_CHUNK or n % (16 * _WARPS) \
            or n // (16 * _WARPS) > 8:
        raise ValueError(f"ln_mlp kernel: unsupported widths D={k} "
                         f"hidden={hid} out={n}")
    x2 = x2.contiguous()
    rows = x2.shape[0]
    dev = x2.device
    f32 = dict(dtype=torch.float32, device=dev)
    args = [x2,
            ln_w.to(**f32).contiguous(), ln_b.to(**f32).contiguous(),
            fc1_w.to(dtype=torch.bfloat16, device=dev).contiguous(),
            fc1_b.to(**f32).contiguous(),
            fc2_w.to(dtype=torch.bfloat16, device=dev).contiguous(),
            fc2_b.to(**f32).contiguous()]
    for a in args:
        if a.device != dev:
            raise ValueError("ln_mlp: all operands must be on one device")
    y = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return y
    lib = _build.load("ln_mlp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _fn(lib)(*[a.data_ptr() for a in args], y.data_ptr(),
                       rows, k, hid, n, float(eps), stream)
    _build.check(lib, err, "ln_mlp")
    with _count_lock:
        ln_mlp.launches += 1
    return y


class _LnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w)
        ctx.db2_dtype = fc2_b.dtype
        if x2.device.type == "cpu":
            return ln_mlp_plain(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)
        if not x2.is_cuda:
            raise ValueError(f"ln_mlp: unsupported device {x2.device}")
        return _launch(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)

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
