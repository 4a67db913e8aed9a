"""Divided space attention, CLS-first token order, with its gradient.

Replaces the TPU kernel oatx/ops/pallas/spacetime_attention.py
`_space_attention_fwd_pallas` (:60-84, body `_space_kernel` :30-57) and
computes what its `_space_attention_reference` (:87-110) computes. q, k, v
are (B, T, H, Dh) with T = 1 + F·N and q pre-scaled by Dh^-0.5: the CLS
query attends over all T keys; each frame's N patch queries attend over
[CLS key + that frame's N keys]; softmax in f32 and p cast to the input dtype
before P·V. The kernels take Dh 64 and 80 (every head dim of the ViT table:
B/16 and L/16 have 64, H/14 has 80) and frame groups of up to 272 keys (17
tiles of 16: ViT-H/14 at 224² and ViT-L/16 at 256² have 257).

What bounds it on an H100: bytes. At serving bucket 4 (B = 4, T = 785,
H = 12, Dh = 64) q, k, v and the output are 19.3 MB, 5.8 µs at 3.35 TB/s;
its 1.91 GFLOP take 1.9 µs at 989 TFLOP/s. The backward moves 7 such
tensors (20 µs at B = 8) for ≈ 2.5× the forward's products.

Forward design (csrc/space_attention.cu, one launch): blocks take units in
the order they start. First the frame groups': a range of 16-query tiles of
one (frame, head, batch) group. The group's K and V (CLS row + N frame
rows, padded to 16·KT) go once into shared memory, XOR-swizzled at Dh 64
(61 KB at N = 196: 3 blocks, 12 warps, per SM) and at a padded pitch of 88
at Dh 80 (107 KB at N = 256: 2 blocks, as past 256 keys at Dh 64;
`_blocks_per_sm`), and per warp S = Q·Kᵀ by `mma.sync`
m16n8k16 into registers, padded keys at −∞, the row max and sum over quad
shuffles, p = bf16(e / sum) packed straight into the A fragments of O = P·V
(V by `ldmatrix.trans`), and O out as 16-byte stores. S and P never leave
registers. `_query_split` sets how many units share a group's query tiles,
from the batch: at B = 1 each group's 13 tiles go to 4 units, at B = 8 one
unit reads K and V once for all 13. The last unit of each group also
writes the CLS query's logits against its keys. Then F CLS units per
(head, batch) wait for those logits, take the exact max and sum over all T,
p of one frame's keys and their P·V; the last of them adds the F partials
in frame order. Every row's log-sum-exp is written when autograd will need
it.

Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, device
busy per call; PERF.md §6): the forward 0.0106 / 0.0200 / 0.0372 ms at
B = 1 / 4 / 8, 9.8× the one-block-per-frame WMMA kernel it replaced at
B = 4 and below SDPA over the same groups (0.0220); the backward 0.049 /
0.066 / 0.136 ms; forward + backward 0.319 ms at B = 8, against 2.008
with the WMMA forward and the plain backward.

Gradient: `space_attention` is a torch.autograd.Function. On the card its
backward is `space_attention_backward`'s kernels (three launches, no float
atomics, bitwise the same from run to run): the CLS query's P and dP over
each frame's keys; one block per (frame, head, batch) that recomputes P
from the saved log-sum-exp and takes dq of its queries, dk and dv of its
frame keys with the CLS query's share, and per-frame partials of the CLS
row's dq and the CLS key's dk, dv; then those partials summed in frame
order. The function it computes is autograd of `space_attention_plain`,
which is oatx's jax.vjp of `_space_attention_reference` (:123-127):
P = exp(S − lse) in f32, dV = bf16(P)ᵀ·dO, dP = dO·Vᵀ, D = rowsum(P ⊙ dP),
dS = P ⊙ (dP − D), dQ = dS·K, dK = dSᵀ·Q, products from bf16 operands
summed in f32. The forward is the custom op `oatx_torch::space_attention`
(`space_attention_op`), so that torch.export keeps it in an exported
program whole. On a CPU tensor the forward runs `space_attention_plain` and
the backward autograd of it; on a CUDA tensor each launches its kernels or
raises; on a fake tensor the op gives the output's shape.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from oatx_torch.ops.kernels import _build

_HEAD_DIMS = (64, 80)  # every head dim of the ViT table (B/16, L/16: 64; H/14: 80)
_MAX_KEYS = 272       # a frame group's N + 1 keys (csrc MAX_KT · 16)
_MAX_SPLIT = 4        # blocks per group: one 16-query tile a warp at N = 196 and 256
_count_lock = threading.Lock()
_sm_counts: dict = {}


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
    f = lib.space_attention_fwd_bf16_hd
    if f.argtypes is None:
        # f.argtypes last: a thread that finds it set finds the rest set too
        lib.max_tokens = lib.space_attention_max_tokens()
        g = lib.space_attention_bwd_bf16_hd
        g.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 15 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        g.restype = ctypes.c_int
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def _sm_count(device: torch.device) -> int:
    """SMs of the card, looked up once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _blocks_per_sm(head_dim: int, n: int) -> int:
    """Frame-group blocks resident on one SM, as the forward kernel's
    __launch_bounds__ sets them: 3 at Dh 64 up to 256 keys a group, else 2
    (the tiles' shared memory and S's 8 registers per key tile)."""
    return 3 if head_dim == 64 and n + 1 <= 256 else 2


def _query_split(groups: int, query_tiles: int, sms: int, blocks_per_sm: int = 3) -> int:
    """Blocks that share one frame group's 16-query tiles: as many as keep
    all the groups' blocks in one wave of `blocks_per_sm` per SM, at most
    _MAX_SPLIT (each warp then has one tile at N = 196) and at least 1. More
    blocks per group put more warps to work at a small batch; one block per
    group reads the group's K and V once."""
    return max(1, min(_MAX_SPLIT, query_tiles, sms * blocks_per_sm // groups))


def _check_inputs(q, k, v, num_frames: int):
    """The kernels' limits: bf16, Dh in _HEAD_DIMS, N + 1 <= _MAX_KEYS keys
    a group, 16-byte aligned rows. Returns N."""
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
        # 16-byte copies: contiguous head dim, 8-element strides
        if a.stride(-1) != 1 or any(s % 8 for s in a.stride()[:3]) \
                or a.data_ptr() % 16:
            raise ValueError(f"space_attention: {name} strides {a.stride()} "
                             "are not 16-byte aligned rows")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"space_attention kernel takes Dh in {_HEAD_DIMS}, got {dh}")
    n = (t - 1) // f
    if n + 1 > _MAX_KEYS:
        raise ValueError(f"space_attention kernel: N={n} patches per frame; a frame "
                         f"group's N + 1 keys must be at most {_MAX_KEYS}")
    return n


def _launch(q, k, v, num_frames: int, with_lse: bool = False):
    """The forward kernel: q, k, v (B, T, H, Dh) bf16, read through their
    strides → (a contiguous (B, T, H, Dh) output, each row's f32
    log-sum-exp (B, H, T) or None)."""
    b, t, h, dh = q.shape
    n = _check_inputs(q, k, v, num_frames)
    lib = _lib()
    if t > lib.max_tokens:
        raise ValueError(f"space_attention kernel: T={t} tokens; the CLS row's "
                         f"shared memory holds at most {lib.max_tokens} logits")
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    # the CLS row's logits (rows of T rounded up to 4), its P·V per frame,
    # and 1 + 2·B·H counters
    ws = torch.empty(b * h * (-(-t // 4) * 4 + num_frames * dh + 2) + 1,
                     dtype=torch.float32, device=q.device)
    split = _query_split(b * h * num_frames, -(-n // 16), _sm_count(q.device),
                         _blocks_per_sm(dh, n))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.space_attention_fwd_bf16_hd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, ws.data_ptr(),
            *strides, b, t, h, num_frames, split, dh, stream)
    _build.check(lib, err, "space_attention")
    with _count_lock:
        space_attention.launches += 1
    return out, lse


def _launch_backward(q, k, v, dout, lse, num_frames: int):
    """The backward kernels from the forward's log-sum-exp → (dq, dk, dv),
    each a contiguous (B, T, H, Dh) bf16 tensor."""
    b, t, h, dh = q.shape
    _check_inputs(q, k, v, num_frames)
    if dout.shape != q.shape or dout.dtype != torch.bfloat16:
        raise ValueError(f"space_attention backward: dout {tuple(dout.shape)} "
                         f"{dout.dtype}, want {tuple(q.shape)} bf16")
    if lse is None or lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("space_attention backward kernel needs the forward's "
                         f"f32 log-sum-exp of shape {(b, h, t)}")
    lib = _lib()
    if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]) \
            or dout.data_ptr() % 16:
        dout = dout.contiguous()
    lse = lse.contiguous()
    grads = [torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device) for _ in range(3)]
    # the CLS row's P and dP, per-frame partials of its dq and of the CLS
    # key's dk, dv, and its own term at the CLS key
    ws = torch.empty(b * h * (2 * t + 3 * num_frames * dh + 2), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for a in (q, k, v, dout, grads[0]) for s in a.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.space_attention_bwd_bf16_hd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), *strides, b, t, h,
            num_frames, dh, stream)
    _build.check(lib, err, "space_attention backward")
    with _count_lock:
        space_attention_backward.launches += 1
    return tuple(grads)


def space_attention_backward(q, k, v, dout, num_frames: int, lse=None):
    """VJP of `space_attention`: (dq, dk, dv), each in its input's dtype and
    shape. On the CPU: autograd of the plain version. On the card: the
    backward kernels, from the forward's log-sum-exp `lse` (B, H, T)."""
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() for a in (q, k, v)]
            out = space_attention_plain(*leaves, num_frames)
            return torch.autograd.grad(out, leaves, dout)
    if not q.is_cuda:
        raise ValueError(f"space_attention: unsupported device {q.device}")
    return _launch_backward(q, k, v, dout, lse, num_frames)


@torch.library.custom_op("oatx_torch::space_attention", mutates_args=(), device_types="cpu")
def space_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int,
                       with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as one op, which torch.export keeps in its graph: the
    plain version on the CPU, the kernel on CUDA, shapes alone on fake
    tensors. → (output, each row's log-sum-exp (B, H, T) when the kernel
    wrote it, else an empty f32 tensor)."""
    return space_attention_plain(q, k, v, num_frames), q.new_empty(0, dtype=torch.float32)


@space_attention_op.register_kernel("cuda")
def _cuda(q, k, v, num_frames, with_lse):
    out, lse = _launch(q, k, v, num_frames, with_lse)
    return out, lse if lse is not None else q.new_empty(0, dtype=torch.float32)


@space_attention_op.register_fake
def _fake(q, k, v, num_frames, with_lse):
    b, t, h, _ = q.shape
    lse_shape = (b, h, t) if with_lse and q.is_cuda else (0,)
    return q.new_empty(q.shape), q.new_empty(lse_shape, dtype=torch.float32)


class _SpaceAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_frames):
        ctx.num_frames = num_frames
        if q.device.type not in ("cpu", "cuda"):
            raise ValueError(f"space_attention: unsupported device {q.device}")
        with_lse = q.is_cuda and any(ctx.needs_input_grad[:3])
        out, lse = torch.ops.oatx_torch.space_attention(q, k, v, num_frames, with_lse)
        ctx.save_for_backward(q, k, v, lse if with_lse else None)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        return (*space_attention_backward(q, k, v, dout, ctx.num_frames, lse), None)


def space_attention(q, k, v, num_frames: int):
    """Divided space attention; q, k, v (B, T, H, Dh), CLS first, q pre-scaled.
    Returns a contiguous (B, T, H, Dh) tensor. Differentiable: k and v may be
    strided views (of the fused qkv output); their gradients flow back
    through the views."""
    return _SpaceAttention.apply(q, k, v, num_frames)


space_attention.launches = 0
space_attention_backward.launches = 0
