"""Fused LayerNorm → Linear (the pre-norm qkv projection), with its gradient.

Replaces the TPU kernel oatx/ops/pallas/ln_linear.py `_fwd_pallas` (:58-77,
body `_kernel` :47-55) and computes what its `_fwd_xla` (:80-88) computes:

    y = bf16( bf16(LN(x)·γ + β) @ bf16(W)ᵀ + b )

with f32 LN statistics and affine, z cast to the compute dtype, f32
accumulation and the bias added in f32. W is in torch layout (N, K).

What bounds it on an H100: operations. At the train step's LN→qkv
(R = 8·785 = 6280 rows, K = 768, N = 2304) it does 2·R·K·N ≈ 22.2 GFLOP,
≈ 0.0225 ms at 989 TFLOP/s, while the ≈ 42 MB it must move (x 9.6 MB, W
3.5 MB, y 28.9 MB) take ≈ 0.0126 ms at 3.35 TB/s.

Design (csrc/ln_linear.cu): a block takes a tile of 64 rows × 128 output
columns. Its 8 warps compute the tile's LN statistics in f32, a warp per row,
and write z as bf16 into shared memory (64 × 768 × 2 = 96 KB, dynamic shared
memory). The block then walks K in chunks of 64: each chunk of W's 128 rows
is staged in shared memory with cp.async, two buffers deep, and every warp
accumulates a 32 × 32 piece of the tile in f32 WMMA fragments. The epilogue
adds the bias in f32 and stores bf16. The grid is (row tiles × column tiles),
99 × 18 at the train shape, so it fills the 132 SMs; every column tile
recomputes its rows' LN. That trade is deliberate: the statistics cost
≈ 1/50 of the tile's products, and one block per row tile looping over all
of N would be kernel 1's under-filled shape. Measured on an H100 (PERF.md,
chip_smoke.py): 0.49 ms at the train shape, 22× the bound and 9× cuBLAS's
layer_norm → linear; the legacy mma.sync path with one 136 KB block per SM
and two barriers per 64-wide K chunk runs the tensor cores at ≈ 5 % of
peak. wgmma, TMA, deeper pipelining and more blocks per SM are left for a
later change.

Gradient: `ln_linear` is a torch.autograd.Function. Its backward is
`ln_linear_backward`, plain PyTorch that mirrors oatx's `_ln_linear2d_bwd`
(:111-132; oatx has no Pallas backward either): the statistics and z are
recomputed from the saved x, and dW and dz go to cuBLAS as bf16 operands with
f32 outputs (`_common.mm_f32`). No backward kernel is written by hand yet.

On a CPU tensor the forward runs `ln_linear_plain`; on a CUDA tensor it
launches the kernel or raises. The backward is the same on both.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from oatx_torch.ops.kernels import _build
from oatx_torch.ops.kernels._common import ln_parts, mm_f32

COL_TILE = 128       # output columns per block (N must be a multiple)
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_count_lock = threading.Lock()


def ln_linear_plain(x, ln_w, ln_b, weight, bias, eps: float = 1e-6):
    """Plain PyTorch version (oatx `_fwd_xla`); weight (N, K) in torch layout."""
    dt = x.dtype
    z = (ln_parts(x, eps)[0] * ln_w.float() + ln_b.float()).to(dt)
    # operands rounded to the compute dtype, products summed in f32
    y = z.float() @ weight.to(dt).float().t()
    return (y + bias.float()).to(dt)


def ln_linear_backward(x, ln_w, ln_b, weight, dy, eps: float = 1e-6):
    """VJP of `ln_linear` on 2-D x (R, K) (oatx `_ln_linear2d_bwd`, torch
    layout). → (dx, dγ, dβ, dW, db), each in its input's dtype; db (the bias
    is not an input) in f32, as oatx returns it."""
    dt = x.dtype
    u, rstd = ln_parts(x, eps)
    z = (u * ln_w.float() + ln_b.float()).to(dt)
    db = dy.float().sum(dim=0)
    dw = mm_f32(dy.t(), z)                       # (N, K)
    dz = mm_f32(dy, weight.to(dt))               # (R, K)
    dgamma = (dz * u).sum(dim=0)
    dbeta = dz.sum(dim=0)
    du = dz * ln_w.float()
    # LN backward: dx = rstd · (du − mean(du) − u · mean(du · u))
    dx = rstd * (du - du.mean(dim=-1, keepdim=True)
                 - u * (du * u).mean(dim=-1, keepdim=True))
    return (dx.to(dt), dgamma.to(ln_w.dtype), dbeta.to(ln_b.dtype),
            dw.to(weight.dtype), db)


def _lib():
    lib = _build.load("ln_linear")
    f = lib.ln_linear_fwd_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        s = lib.ln_linear_smem_bytes
        s.argtypes = [ctypes.c_int]
        s.restype = ctypes.c_longlong
    return lib


def _launch(x2, ln_w, ln_b, weight, bias, eps):
    """The CUDA kernel on 2-D bf16 x (R, K) → y (R, N) bf16."""
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"ln_linear kernel takes bf16 activations, got {x2.dtype}")
    k = x2.shape[-1]
    n = weight.shape[0]
    if weight.shape != (n, k) or bias.shape != (n,) or ln_w.shape != (k,) \
            or ln_b.shape != (k,):
        raise ValueError(f"ln_linear: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}, LN {tuple(ln_w.shape)} do not "
                         f"fit K={k}")
    if k % 16 or n % COL_TILE:
        raise ValueError(f"ln_linear kernel: unsupported widths K={k} (a "
                         f"multiple of 16) N={n} (a multiple of {COL_TILE})")
    x2 = x2.contiguous()
    dev = x2.device
    f32 = dict(dtype=torch.float32, device=dev)
    args = [x2, ln_w.to(**f32).contiguous(), ln_b.to(**f32).contiguous(),
            weight.to(dtype=torch.bfloat16, device=dev).contiguous(),
            bias.to(**f32).contiguous()]
    for a in args:
        if a.device != dev:
            raise ValueError("ln_linear: all operands must be on one device")
    if x2.data_ptr() % 16 or args[3].data_ptr() % 16:
        raise ValueError("ln_linear kernel: x and W must be 16-byte aligned")
    rows = x2.shape[0]
    y = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return y
    lib = _lib()
    if lib.ln_linear_smem_bytes(k) > _SMEM_LIMIT:
        raise ValueError(f"ln_linear kernel: K={k} needs more shared memory "
                         "than a block has")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ln_linear_fwd_bf16(*[a.data_ptr() for a in args], y.data_ptr(),
                                     rows, k, n, float(eps), stream)
    _build.check(lib, err, "ln_linear")
    with _count_lock:
        ln_linear.launches += 1
    return y


class _LnLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln_w, ln_b, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, ln_w, ln_b, weight)
        ctx.db_dtype = bias.dtype
        if x2.device.type == "cpu":
            return ln_linear_plain(x2, ln_w, ln_b, weight, bias, eps)
        if not x2.is_cuda:
            raise ValueError(f"ln_linear: unsupported device {x2.device}")
        return _launch(x2, ln_w, ln_b, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        *grads, db = ln_linear_backward(*ctx.saved_tensors, dy, ctx.eps)
        return (*grads, db.to(ctx.db_dtype), None)


def ln_linear(x, ln_w, ln_b, weight, bias, eps: float = 1e-6):
    """linear(layer_norm(x)) in one pass, differentiable. x (..., K); weight
    (N, K) in torch layout; LN params and bias in any float dtype."""
    k = x.shape[-1]
    y = _LnLinear.apply(x.reshape(-1, k), ln_w, ln_b, weight, bias, eps)
    return y.reshape(*x.shape[:-1], y.shape[-1])


ln_linear.launches = 0
