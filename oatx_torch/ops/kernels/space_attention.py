"""Divided space attention, CLS-first token order, with its gradient.

Replaces the TPU kernel oatx/ops/pallas/spacetime_attention.py
`_space_attention_fwd_pallas` (:60-84, body `_space_kernel` :30-57) and
computes what its `_space_attention_reference` (:87-110) computes. q, k, v
are (B, T, H, Dh) with T = 1 + F·N and q pre-scaled by Dh^-0.5: the CLS
query attends over all T keys; each frame's N patch queries attend over
[CLS key + that frame's N keys]; softmax in f32 and p cast to the input dtype
before P·V.

What bounds it on an H100: bytes. At bucket 16 (B=16, T=785, H=12, Dh=64)
q, k, v and the output are ≈ 77 MB, ≈ 23 µs at 3.35 TB/s; the ≈ 7.6 GFLOP
take ≈ 8 µs at 989 TFLOP/s.

Design (csrc/space_attention.cu): one block per (frame, head, batch) instead
of the Pallas program per (batch, head) with a loop over frames: the block
holds the group's K and V (the CLS row + 196 frame rows, padded to 208, bf16)
in shared memory and each of its 4 warps takes 16-query tiles: S = Q·Kᵀ in
f32 WMMA fragments, the row softmax in f32 from shared memory, p rounded to
bf16, O = P·V. The logits never reach device memory. One extra block per
(head, batch) computes the CLS row over all T keys in the same launch. The
kernel reads q/k/v through their strides, so the views of the fused qkv
output need no transpose copy. Shared memory (≈ 149 KB at N = 196) allows one
block per SM; that and the scalar CLS block are left for a later change.

Gradient: `space_attention` is a torch.autograd.Function. Its backward is
`space_attention_backward`, plain PyTorch: it recomputes
`space_attention_plain` from the saved q, k, v and differentiates it with
torch.autograd, as oatx differentiates `_space_attention_reference`
(:123-127; oatx has no Pallas backward either). Its einsums run on f32
copies of the bf16 operands, like the plain forward. No backward kernel is
written by hand yet.

On a CPU tensor the forward runs `space_attention_plain`; on a CUDA tensor
it launches the kernel or raises. The backward is the same on both.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from oatx_torch.ops.kernels import _build

_HEAD_DIM = 64
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_count_lock = threading.Lock()


def space_attention_plain(q, k, v, num_frames: int):
    """Plain PyTorch version (oatx `_space_attention_reference`)."""
    b, t, h, dh = q.shape
    f = num_frames
    n = (t - 1) // f
    dt = q.dtype
    cls_logits = torch.einsum("bqhd,bkhd->bhqk", q[:, :1].float(), k.float())
    cls_p = torch.softmax(cls_logits, dim=-1).to(dt)
    cls_out = torch.einsum("bhqk,bkhd->bqhd", cls_p.float(), v.float()).to(dt)
    qp = q[:, 1:].reshape(b, f, n, h, dh)
    kp = k[:, 1:].reshape(b, f, n, h, dh)
    vp = v[:, 1:].reshape(b, f, n, h, dh)
    kg = torch.cat([k[:, None, :1].expand(b, f, 1, h, dh), kp], dim=2)
    vg = torch.cat([v[:, None, :1].expand(b, f, 1, h, dh), vp], dim=2)
    logits = torch.einsum("bfqhd,bfkhd->bfhqk", qp.float(), kg.float())
    p = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bfhqk,bfkhd->bfqhd", p.float(), vg.float()).to(dt)
    return torch.cat([cls_out, out.reshape(b, f * n, h, dh)], dim=1)


def _lib():
    lib = _build.load("space_attention")
    f = lib.space_attention_fwd_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        s = lib.space_attention_smem_bytes
        s.argtypes = [ctypes.c_int, ctypes.c_int]
        s.restype = ctypes.c_longlong
    return lib


def space_attention_backward(q, k, v, dout, num_frames: int):
    """VJP of `space_attention`: (dq, dk, dv), each in its input's dtype and
    shape, through autograd of the plain version."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (q, k, v)]
        out = space_attention_plain(*leaves, num_frames)
        return torch.autograd.grad(out, leaves, dout)


def _launch(q, k, v, num_frames: int):
    """The CUDA kernel: q, k, v (B, T, H, Dh) bf16, read through their
    strides → a contiguous (B, T, H, Dh) output."""
    b, t, h, dh = q.shape
    f = num_frames
    if f < 1 or (t - 1) % f:
        raise ValueError(f"space_attention: {t} tokens do not fit {f} frames")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.shape != q.shape or a.device != q.device:
            raise ValueError(f"space_attention: {name} is {tuple(a.shape)} "
                             f"on {a.device}, q is {tuple(q.shape)} on {q.device}")
        if a.dtype != torch.bfloat16:
            raise ValueError(f"space_attention kernel takes bf16, {name} is {a.dtype}")
        # 16-byte vector loads: contiguous head dim, 8-element strides
        if a.stride(-1) != 1 or any(s % 8 for s in a.stride()[:3]) \
                or a.data_ptr() % 16:
            raise ValueError(f"space_attention: {name} strides {a.stride()} "
                             "are not 16-byte aligned rows")
    if dh != _HEAD_DIM:
        raise ValueError(f"space_attention kernel takes Dh={_HEAD_DIM}, got {dh}")
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lib = _lib()
    if lib.space_attention_smem_bytes(t, f) > _SMEM_LIMIT:
        raise ValueError(f"space_attention kernel: {(t - 1) // f} patches per "
                         "frame need more shared memory than a block has")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.space_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, b, t, h, f, stream)
    _build.check(lib, err, "space_attention")
    with _count_lock:
        space_attention.launches += 1
    return out


class _SpaceAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_frames):
        ctx.num_frames = num_frames
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return space_attention_plain(q, k, v, num_frames)
        if not q.is_cuda:
            raise ValueError(f"space_attention: unsupported device {q.device}")
        return _launch(q, k, v, num_frames)

    @staticmethod
    def backward(ctx, dout):
        return (*space_attention_backward(*ctx.saved_tensors, dout, ctx.num_frames),
                None)


def space_attention(q, k, v, num_frames: int):
    """Divided space attention; q, k, v (B, T, H, Dh), CLS first, q pre-scaled.
    Returns a contiguous (B, T, H, Dh) tensor. Differentiable: k and v may be
    strided views (of the fused qkv output); their gradients flow back
    through the views."""
    return _SpaceAttention.apply(q, k, v, num_frames)


space_attention.launches = 0
