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

Design (csrc/ln_linear.cu, Hopper): TMA, mbarriers and wgmma. A persistent
block per SM walks a run of 128 × 256 output tiles with two consumer
warpgroups (64 rows each) and one producer warp. The producer's TMA loads
fill a ring of 4 stages, each holding an x chunk (128 × 64) and a W chunk
(256 × 64), both in the 128-byte swizzle. When a block's row tile changes,
the consumers first take the rows' statistics from x chunks streamed
through the ring (Chan's update in f32, three chunks to a stage). Then, per
64-wide K chunk, each warpgroup overwrites its rows of the x chunk with
z = bf16(LN(x)·γ + β) in place, fences it for the async proxy and issues
four wgmma m64n256k16. The LayerNorm of one chunk overlaps the tensor
cores' work on the previous one. The epilogue adds the bias in f32 and
writes y through swizzled 64 × 64 boxes by TMA stores. z never reaches
device memory. K and N need only be multiples of 8 (TMA's 16-byte rows);
ragged R, N and K < 64 are handled by TMA's zero fill and clipped stores.
The kernel needs no shared memory that grows with K, so K has no limit.

Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6,
chip_smoke.py): 0.095 ms at the train shape (233 TFLOP/s, 24 % of peak,
4.2× the bound); 0.089-0.091 ms in turns with the WMMA kernel it replaced
(0.488 ms) in the same call; 0.058 ms for cuBLAS's layer_norm → linear.
The ring is bound by the L2 → SM rate, and the 54 of 132 blocks that take
a fourth tile set the end.

Gradient: `ln_linear` is a torch.autograd.Function. Its backward is
`ln_linear_backward`, plain PyTorch that mirrors oatx's `_ln_linear2d_bwd`
(:111-132; oatx has no Pallas backward either): the statistics and z are
recomputed from the saved x, and dW and dz go to cuBLAS as bf16 operands with
f32 outputs (`_common.mm_f32`). No backward kernel is written by hand yet.

The forward is the custom op `oatx_torch::ln_linear` (`ln_linear_op`), so
that torch.export keeps it in an exported program whole: on a CPU tensor it
runs `ln_linear_plain`, on a CUDA tensor it launches the kernel or raises,
on a fake tensor it gives the output's shape. The backward is the same on
both devices.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from oatx_torch.ops.kernels import _build
from oatx_torch.ops.kernels._common import ln_parts, mm_f32

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
    if k % 8 or n % 8 or k == 0 or n == 0:
        raise ValueError(f"ln_linear kernel: unsupported widths K={k} N={n} "
                         "(each a positive multiple of 8: TMA reads rows of "
                         "16-byte multiples)")
    x2 = x2.contiguous()
    dev = x2.device
    f32 = dict(dtype=torch.float32, device=dev)
    args = [x2, ln_w.to(**f32).contiguous(), ln_b.to(**f32).contiguous(),
            weight.to(dtype=torch.bfloat16, device=dev).contiguous(),
            bias.to(**f32).contiguous()]
    for a in args:
        if a.device != dev:
            raise ValueError("ln_linear: all operands must be on one device")
    # TMA reads x and W, the LayerNorm warps read γ and β, in 16-byte pieces
    args = [a if a.data_ptr() % 16 == 0 else a.clone() for a in args]
    rows = x2.shape[0]
    y = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return y
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ln_linear_fwd_bf16(*[a.data_ptr() for a in args], y.data_ptr(),
                                     rows, k, n, float(eps), stream)
    _build.check(lib, err, "ln_linear")
    with _count_lock:
        ln_linear.launches += 1
    return y


@torch.library.custom_op("oatx_torch::ln_linear", mutates_args=(), device_types="cpu")
def ln_linear_op(x2: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward as one op, which torch.export keeps in its graph: the
    plain version on the CPU, the kernel on CUDA, shapes alone on fake
    tensors."""
    return ln_linear_plain(x2, ln_w, ln_b, weight, bias, eps)


@ln_linear_op.register_kernel("cuda")
def _cuda(x2, ln_w, ln_b, weight, bias, eps):
    return _launch(x2, ln_w, ln_b, weight, bias, eps)


@ln_linear_op.register_fake
def _fake(x2, ln_w, ln_b, weight, bias, eps):
    return x2.new_empty((x2.shape[0], weight.shape[0]))


class _LnLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln_w, ln_b, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, ln_w, ln_b, weight)
        ctx.db_dtype = bias.dtype
        if x2.device.type not in ("cpu", "cuda"):
            raise ValueError(f"ln_linear: unsupported device {x2.device}")
        return torch.ops.oatx_torch.ln_linear(x2, ln_w, ln_b, weight, bias, eps)

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
