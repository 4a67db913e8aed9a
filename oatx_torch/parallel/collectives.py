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

The sharded layouts (parallel/sharding.py) add collectives over a group
of ranks. Over the data axis of a slice (`data_group`): `all_gather_flat`
(every rank's 1-D share, in group order; `all_gather_into_tensor`) and
`reduce_scatter_flat` (the sum of every rank's 1-D tensor, this rank's
equal part of it; `reduce_scatter_tensor`), which NCCL takes and gloo
takes on CPU and on CUDA tensors (the probe of chip_smoke.py's phase 11).
Over the ranks that hold one shard in every slice (`cross_group`):
`all_reduce_sum`.

Each call goes through `_count`, which counts the bytes of the tensor a
rank hands in and the calls per purpose in `TRAFFIC`: 'grad' (the gradient
all-reduce), 'gather' (the forward gathers), 'gather_bwd' (their backward
sums), 'mean' (the averaged losses), 'valid' (validation), 'flag'
(any_rank and max_across_ranks), and for the sharded layouts
'param_gather' (fsdp's weight gathers, remat recomputes included),
'grad_scatter' (its gradient reduce-scatter), 'grad_cross' (the scattered
gradients' sum across dcn slices), 'norm' (the sharded gradient norm),
'param_update' (zero1's gather of the updated parameters) and
'state_gather' (whole tensors for a checkpoint or the EMA). Without a
process group, or with one rank, every function here is the identity and
sends nothing.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from oatx_torch.parallel.mesh import Layout, spans_processes

BUCKET_BYTES = 25 * 2 ** 20

TRAFFIC: Dict[str, Dict[str, int]] = collections.defaultdict(lambda: {"bytes": 0, "calls": 0})


def reset_traffic() -> None:
    TRAFFIC.clear()


def _count(purpose: str, nbytes: int) -> None:
    rec = TRAFFIC[purpose]
    rec["bytes"] += int(nbytes)
    rec["calls"] += 1


def _all_reduce(x: torch.Tensor, purpose: str, group=None) -> torch.Tensor:
    """Sum `x` over the ranks (of `group`; default: all) in place."""
    _count(purpose, x.numel() * x.element_size())
    dist.all_reduce(x, group=group)
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
                     dtype: Optional[torch.dtype] = None,
                     scale: Optional[float] = None) -> None:
    """Replace every `.grad` of `params` by its mean over the ranks, in
    place (with `scale`, by the sum times `scale`). `dtype` (e.g.
    torch.bfloat16) is the dtype on the wire: each gradient is cast to it
    before the reduction and back after, as `_manual_dp_grads`'
    grad_reduce_dtype (the mean is taken in that dtype too). Parameters
    without a gradient are skipped; which ones have none must be the same on
    every rank (it follows from the config)."""
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
        if scale is None:
            flat.div_(world)
        else:
            flat.mul_(scale)
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


_groups: dict = {}  # (default group, dcn slices) → (data group, cross-slice group)


def _shard_groups(layout: Layout):
    """This rank's (data group, cross-slice group) for `layout`, (None,
    None) with one slice (the data group is then the default group). Every
    rank makes every group, in the same order, the first time."""
    if layout.dcn_slices == 1 or not spans_processes():
        return None, None
    key = (dist.group.WORLD, layout.dcn_slices)
    if key not in _groups:
        data = [dist.new_group(list(layout.data_ranks(s))) for s in range(layout.dcn_slices)]
        cross = [dist.new_group(list(layout.cross_ranks(j))) for j in range(layout.data_size)]
        _groups[key] = (data[layout.slice_index], cross[layout.data_rank])
    return _groups[key]


def data_group(layout: Layout):
    """The process group of this rank's slice (None: the default group)."""
    return _shard_groups(layout)[0]


def cross_group(layout: Layout):
    """The group of this rank's replicas in the other slices (None when
    there is one slice)."""
    return _shard_groups(layout)[1]


def all_gather_flat(x: torch.Tensor, group, purpose: str) -> torch.Tensor:
    """Every rank's 1-D `x` (same size on each) of `group`, concatenated in
    group order."""
    x = x.contiguous().view(-1)
    if not spans_processes():
        return x
    _count(purpose, x.numel() * x.element_size())
    out = x.new_empty(dist.get_world_size(group) * x.numel())
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_flat(x: torch.Tensor, group, purpose: str) -> torch.Tensor:
    """The sum over `group`'s ranks of the 1-D `x` (a size that divides by
    the group's), this rank's part: elements [r·k, (r + 1)·k) at group rank
    r."""
    x = x.contiguous().view(-1)
    if not spans_processes():
        return x
    _count(purpose, x.numel() * x.element_size())
    out = x.new_empty(x.numel() // dist.get_world_size(group))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, purpose: str, group=None) -> torch.Tensor:
    """`x` summed over `group`'s ranks (default: all), in place."""
    if not spans_processes():
        return x
    return _all_reduce(x, purpose, group)


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


def _host_all_reduce_max(value: int) -> int:
    global _host_group
    world = dist.group.WORLD
    if _host_group[0] is not world:
        _host_group = (world, world if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    t = torch.tensor([int(value)], dtype=torch.int32)
    _count("flag", t.numel() * t.element_size())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group[1])
    return int(t.item())


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank. Every rank must
    call it at the same point of its program."""
    if not spans_processes():
        return flag
    return bool(_host_all_reduce_max(int(flag)))


def max_across_ranks(value: int) -> int:
    """The largest of every rank's `value`, on every rank (over the host)."""
    if not spans_processes():
        return value
    return _host_all_reduce_max(value)
