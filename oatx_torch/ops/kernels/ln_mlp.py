"""Fused LayerNorm → fc1 → GELU → fc2 (the ViT MLP sublayer), forward.

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

On a CPU tensor the wrapper runs `ln_mlp_plain`; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from oatx_torch.ops.kernels import _build

_ROWS_PER_BLOCK = 32
_HIDDEN_CHUNK = 128
_WARPS = 8
_count_lock = threading.Lock()


def ln_mlp_plain(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float = 1e-6):
    """Plain PyTorch version (oatx `_fwd_xla`); weights in torch layout."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    z = xc * torch.rsqrt(var + eps)
    z = (z * ln_w.float() + ln_b.float()).to(dt)
    # operands rounded to the compute dtype, products summed in f32
    pre1 = z.float() @ fc1_w.to(dt).float().t()
    h = F.gelu(pre1 + fc1_b.float()).to(dt)
    y = h.float() @ fc2_w.to(dt).float().t()
    return (y + fc2_b.float()).to(dt)


def _fn(lib):
    f = lib.ln_mlp_fwd_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def ln_mlp(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float = 1e-6):
    """mlp(layer_norm(x)) in one pass. x (..., D); fc1_w (4D, D) and fc2_w
    (D, 4D) in torch layout; LN params and biases in any float dtype."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps)
    if not x.is_cuda:
        raise ValueError(f"ln_mlp: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ln_mlp kernel takes bf16 activations, got {x.dtype}")
    k = x.shape[-1]
    hid, n = fc1_w.shape[0], fc2_w.shape[0]
    if fc1_w.shape != (hid, k) or fc2_w.shape != (n, hid):
        raise ValueError(f"ln_mlp: weight shapes {tuple(fc1_w.shape)}, "
                         f"{tuple(fc2_w.shape)} do not fit D={k}")
    if k % 16 or k > 1024 or hid % _HIDDEN_CHUNK or n % (16 * _WARPS) \
            or n // (16 * _WARPS) > 8:
        raise ValueError(f"ln_mlp kernel: unsupported widths D={k} "
                         f"hidden={hid} out={n}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    rows = x2.shape[0]
    dev = x.device
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
        return y.reshape(*lead, n)
    lib = _build.load("ln_mlp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _fn(lib)(*[a.data_ptr() for a in args], y.data_ptr(),
                       rows, k, hid, n, float(eps), stream)
    _build.check(lib, err, "ln_mlp")
    with _count_lock:
        ln_mlp.launches += 1
    return y.reshape(*lead, n)


ln_mlp.launches = 0
