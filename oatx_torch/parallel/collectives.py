"""The collectives of data-parallel training across processes (the port's
counterpart of oatx's `jax.lax.all_gather` / `pmean` inside
`_manual_dp_grads`, oatx/train/step.py:72-178, 208-267).

Every rank runs the same program on its rows of the global batch and seeds
its own copy of the global loss, so the backward of each collective is its
transpose, as JAX differentiates them:
  * `all_gather_rows` concatenates every rank's rows in rank order; its
    backward sums the cotangent over the ranks, then takes the local rows
    (JAX's transpose of a tiled all_gather);
  * `mean_across_ranks` averages a tensor over the ranks (oatx's `pmean` of
    region_mem's BCE); its backward averages the cotangent.
The ranks' gradients then sum to n·dL/dθ, and `reduce_gradients` takes
their mean, dL/dθ, as oatx's pmean does (step.py:222-227). (A backward that
only slices the cotangent, with a mean after it, would give dL/dθ / n.)

`reduce_gradients` sends each gradient element across the ranks once: the
gradients in parameter order, cast to the reduce dtype, flattened into
buckets of up to BUCKET_BYTES and all-reduced bucket by bucket.
`all_gather_ragged` gathers ranks' validation rows of unequal counts.
`broadcast_tensors` makes every rank start from rank 0's state; `barrier`
holds every rank until all reach it (after rank 0 writes a checkpoint);
`any_rank` tells every rank whether a host flag (a preemption signal) is
set on any of them, over a gloo group, so no device work waits for it.

Only collectives that gloo and NCCL both take are used: `all_gather` into a
list, `all_reduce`, `broadcast`, `barrier`. Each call goes through `_all_reduce` /
`_all_gather`, which count the bytes and calls per purpose in `TRAFFIC`:
'grad' (the gradient reduction), 'gather' (the forward gathers),
'gather_bwd' (their backward sums), 'mean' (the averaged losses),
'valid' (validation) and 'flag' (any_rank). Without a process group, or with one rank, every
function here is the identity and sends nothing.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from oatx_torch.parallel.mesh import spans_processes

BUCKET_BYTES = 25 * 2 ** 20

TRAFFIC: Dict[str, Dict[str, int]] = collections.defaultdict(lambda: {"bytes": 0, "calls": 0})


def reset_traffic() -> None:
    TRAFFIC.clear()


def _count(purpose: str, nbytes: int) -> None:
    rec = TRAFFIC[purpose]
    rec["bytes"] += int(nbytes)
    rec["calls"] += 1


def _all_reduce(x: torch.Tensor, purpose: str) -> torch.Tensor:
    """Sum `x` over the ranks in place."""
    _count(purpose, x.numel() * x.element_size())
    dist.all_reduce(x)
    return x


def _all_gather(x: torch.Tensor, purpose: str) -> List[torch.Tensor]:
    """Every rank's `x` (same shape on each), in rank order."""
    x = x.contiguous()
    _count(purpose, x.numel() * x.element_size())
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.rows = dist.get_rank(), x.shape[0]
        return torch.cat(_all_gather(x, "gather"))

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), "gather_bwd")
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) on each rank → (world·B, ...), rank 0's rows first. Every
    rank must pass the same shape."""
    if not spans_processes():
        return x
    return _AllGatherRows.apply(x)


class _MeanAcrossRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.world = dist.get_world_size()
        return _all_reduce(x.detach().clone(), "mean") / ctx.world

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), "mean") / ctx.world


def mean_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks, the same on every rank."""
    if not spans_processes():
        return x
    return _MeanAcrossRanks.apply(x)


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter],
                     dtype: Optional[torch.dtype] = None) -> None:
    """Replace every `.grad` of `params` by its mean over the ranks, in
    place. `dtype` (e.g. torch.bfloat16) is the dtype on the wire: each
    gradient is cast to it before the reduction and back after, as
    `_manual_dp_grads`' grad_reduce_dtype (the mean is taken in that dtype
    too). Parameters without a gradient are skipped; which ones have none
    must be the same on every rank (it follows from the config)."""
    if not spans_processes():
        return
    world = dist.get_world_size()
    grads = [p.grad for p in params if p.grad is not None]
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        wire = dtype or bucket[0].dtype
        flat = torch.cat([g.reshape(-1).to(wire) for g in bucket])
        _all_reduce(flat, "grad")
        flat.div_(world)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        bucket, size = [], 0

    for g in grads:
        wire = dtype or g.dtype
        if bucket and ((dtype or bucket[0].dtype) != wire or bucket[0].device != g.device
                       or size + g.numel() * wire.itemsize > BUCKET_BYTES):
            flush()
        bucket.append(g)
        size += g.numel() * wire.itemsize
    flush()


@torch.no_grad()
def all_gather_ragged(x: torch.Tensor) -> torch.Tensor:
    """(n_r, ...) rows on rank r, n_r free per rank → every rank's rows
    concatenated in rank order, on every rank (the trainer's validation
    gather, oatx `_gather_valid`)."""
    if not spans_processes():
        return x
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [int(c) for c in _all_gather(n, "valid")]
    most = max(counts)
    padded = x.new_zeros((most,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    blocks = _all_gather(padded, "valid")
    return torch.cat([b[:c] for b, c in zip(blocks, counts)])


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor, in order, with rank `src`'s, in place."""
    if not spans_processes():
        return
    for t in tensors:
        dist.broadcast(t, src)


def barrier() -> None:
    if spans_processes():
        dist.barrier()


_host_group = (None, None)  # (the default group it was made for, a gloo group)


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank. Every rank must
    call it at the same point of its program."""
    global _host_group
    if not spans_processes():
        return flag
    world = dist.group.WORLD
    if _host_group[0] is not world:
        _host_group = (world, world if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    t = torch.tensor([int(flag)], dtype=torch.int32)
    _count("flag", t.numel() * t.element_size())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group[1])
    return bool(t.item())
