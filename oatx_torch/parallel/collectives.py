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

Under a model axis (parallel/mesh.py: `model_parallel` mp > 1) the ranks
of one data position form a model group (`model_group`) and the ranks at
one model rank the batch group (`batch_group`): the loss gathers, the
averaged losses, the gradient mean and the validation gather run over the
batch group (their `group` argument), so no row is counted once per model
rank and no weight shard is averaged with another. The data and
cross-slice groups then hold the ranks at this model rank only. Over the
model group run Megatron's four operators, each an autograd.Function whose
backward is its forward's transpose (every model rank computes the same
loss and seeds its own copy of it):
  * `copy_to_model`: identity forward, all-reduce backward (before a
    column-parallel product: each rank's input gradient is a partial sum);
  * `reduce_from_model`: all-reduce forward, identity backward (after a
    row-parallel product, whose outputs are partial sums);
  * `gather_tokens`: all-gather on the token axis forward, reduce-scatter
    backward (before a column-parallel product under sequence
    parallelism);
  * `scatter_tokens`: reduce-scatter on the token axis forward, all-gather
    backward (after a row-parallel product under sequence parallelism);
and the two that enter and leave the token-sharded stream from and to a
replicated one: `split_tokens` (this rank's rows forward, all-gather
backward) and `gather_tokens_whole` (all-gather forward, this rank's rows
backward). A token axis of T rows is padded with zero rows to a multiple of
mp; rank m holds rows [m·t, (m + 1)·t) of the padded axis, t = ⌈T/mp⌉.

Each call goes through `_count`, which counts the bytes of the tensor a
rank hands in and the calls per purpose in `TRAFFIC`: 'grad' (the gradient
all-reduce), 'gather' (the forward gathers), 'gather_bwd' (their backward
sums), 'mean' (the averaged losses), 'valid' (validation), 'flag'
(any_rank and max_across_ranks), and for the sharded layouts
'param_gather' (fsdp's weight gathers, remat recomputes included),
'grad_scatter' (its gradient reduce-scatter), 'grad_cross' (the scattered
gradients' sum across dcn slices), 'norm' (the sharded gradient norm),
'param_update' (zero1's gather of the updated parameters) and
'state_gather' (whole tensors for a checkpoint or the EMA), and under a
model axis 'tp_reduce' (the all-reduces of copy_to_model's backward and
reduce_from_model's forward, the vocabulary-parallel lookup's included),
'sp_gather' and 'sp_scatter' (the token axis' all-gathers and
reduce-scatters, forward and backward alike) and 'tp_norm' (the model
group's sum of the gradients each rank holds in part: parallel/sharding.py
`reduce_model_partials`). A remat recompute runs its forward collectives
again, and they count again. Adafactor's step (train/optim.py) sums over
the ranks holding parts of a leaf: 'factor_sums' (an fsdp share's row
and column sums of g²), 'factor_split' (the sums over a dim the model axis
splits), 'factor_mean' (v_row's sums over a split dim, for its mean) and
'block_rms' (each leaf's sum of squares of its update).

Pipeline stages over the model axis (parallel/pipeline.py) send between
neighbouring stages of a model group, point to point on the default
group: `send_to` (blocking) and `recv_from`, each at a fixed place of both
ranks' programs; the sender counts 'pp_send' (a stage's output activations,
forward) or 'pp_grad' (the cotangents of its input, backward). Over gloo a
CUDA tensor is sent and received through a host copy ('pp_host', the
bytes each side copies). The last stage's output reaches the model group
by `broadcast_from` ('pp_bcast', counted on every rank), and the
embedding's gradients, which stage 0 alone computes, are summed over the
model group ('pp_embed').

Without a process group, or with one rank, every function here but the
pipeline's is the identity and sends nothing.
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


def group_size(group=None) -> int:
    """Ranks of `group` (default: all); 1 without a process group."""
    return dist.get_world_size(group) if spans_processes() else 1


def _all_gather(x: torch.Tensor, purpose: str, group=None) -> List[torch.Tensor]:
    """Every rank's `x` (same shape on each) of `group`, in group order."""
    x = x.contiguous()
    _count(purpose, x.numel() * x.element_size())
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        return torch.cat(_all_gather(x, "gather", group))

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), "gather_bwd", ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(B, ...) on each rank of `group` (default: all) → (n·B, ...), the
    group's first rank's rows first. Every rank must pass the same shape."""
    if group_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)


class _MeanAcrossRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.world = group, dist.get_world_size(group)
        return _all_reduce(x.detach().clone(), "mean", group) / ctx.world

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), "mean", ctx.group) / ctx.world, None


def mean_across_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (default: all), the same on
    each of them."""
    if group_size(group) == 1:
        return x
    return _MeanAcrossRanks.apply(x, group)


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter],
                     dtype: Optional[torch.dtype] = None,
                     scale: Optional[float] = None, group=None,
                     purpose: str = "grad") -> None:
    """Replace every `.grad` of `params` by its mean over the ranks of
    `group` (default: all), in place (with `scale`, by the sum times
    `scale`). `dtype` (e.g. torch.bfloat16) is the dtype on the wire: each
    gradient is cast to it before the reduction and back after, as
    `_manual_dp_grads`' grad_reduce_dtype (the mean is taken in that dtype
    too). Parameters without a gradient are skipped; which ones have none
    must be the same on every rank (it follows from the config)."""
    if group_size(group) == 1:
        return
    world = dist.get_world_size(group)
    grads = [p.grad for p in params if p.grad is not None]
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        wire = dtype or bucket[0].dtype
        flat = torch.cat([g.reshape(-1).to(wire) for g in bucket])
        _all_reduce(flat, purpose, group)
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


_groups: dict = {}  # (default group, dcn slices, model_parallel) → this rank's groups


def _layout_groups(layout: Layout) -> dict:
    """This rank's process groups for `layout`: 'model' (its data
    position's ranks; None without a model axis), 'batch' (the ranks at its
    model rank), 'data' (its slice's ranks at its model rank) and 'cross'
    (its replicas in the other slices; None with one slice). A group of the
    whole world is None (the default group). Every rank makes every group,
    in the same order, the first time."""
    if not spans_processes():
        return {"model": None, "batch": None, "data": None, "cross": None}
    key = (dist.group.WORLD, layout.dcn_slices, layout.model_parallel)
    if key not in _groups:
        world, mp, dcn = layout.world, layout.model_parallel, layout.dcn_slices

        def make(rank_sets, mine):
            made = [dist.new_group(list(r)) if len(r) < world else None for r in rank_sets]
            return made[mine]

        lay = layout
        model = (make([lay.model_ranks(p) for p in range(lay.batch_shards)], lay.position)
                 if mp > 1 else None)
        batch = make([lay.batch_ranks(m) for m in range(mp)], lay.model_rank)
        data = batch if dcn == 1 else make(
            [lay.data_ranks(s, m) for m in range(mp) for s in range(dcn)],
            lay.model_rank * dcn + lay.slice_index)
        cross = None if dcn == 1 else make(
            [lay.cross_ranks(j, m) for m in range(mp) for j in range(lay.data_size)],
            lay.model_rank * lay.data_size + lay.data_rank)
        _groups[key] = {"model": model, "batch": batch, "data": data, "cross": cross}
    return _groups[key]


def model_group(layout: Layout):
    """The process group of this rank's data position (None: no model axis)."""
    return _layout_groups(layout)["model"]


def batch_group(layout: Layout):
    """The ranks at this rank's model rank (None: the default group)."""
    return _layout_groups(layout)["batch"]


def data_group(layout: Layout):
    """The process group of this rank's slice at its model rank (None: the
    default group)."""
    return _layout_groups(layout)["data"]


def cross_group(layout: Layout):
    """The group of this rank's replicas in the other slices (None when
    there is one slice)."""
    return _layout_groups(layout)["cross"]


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
def all_gather_ragged(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n_r, ...) rows on rank r of `group` (default: all), n_r free per
    rank → every rank's rows concatenated in group order, on every rank (the
    trainer's validation gather, oatx `_gather_valid`)."""
    if group_size(group) == 1:
        return x
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [int(c) for c in _all_gather(n, "valid", group)]
    most = max(counts)
    padded = x.new_zeros((most,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    blocks = _all_gather(padded, "valid", group)
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


# ------------------------------------------------------------ model axis


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), "tp_reduce", ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x, replicated over the model group, into a column-parallel product:
    the identity; backward: the sum of the ranks' partial gradients."""
    return _CopyToModel.apply(x, group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), "tp_reduce", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of each rank's partial `x` (a
    row-parallel product's output); backward: the identity."""
    return _ReduceFromModel.apply(x, group)


def tokens_per_rank(total: int, size: int) -> int:
    """Rows of a token axis of `total` a rank holds over `size` ranks."""
    return -(-total // size)


def _gather_tokens(x: torch.Tensor, group, purpose: str) -> torch.Tensor:
    """(B, t, ...) on each rank → (B, size·t, ...), the group's first
    rank's rows first."""
    x = x.contiguous()
    size = dist.get_world_size(group)
    _count(purpose, x.numel() * x.element_size())
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.view(size, *x.shape)
    return out.transpose(0, 1).reshape(x.shape[0], size * x.shape[1], *x.shape[2:])


def _scatter_tokens(y: torch.Tensor, group, purpose: str) -> torch.Tensor:
    """(B, size·t, ...) on each rank → the sum over the ranks, this rank's
    t rows."""
    size = dist.get_world_size(group)
    b, t = y.shape[0], y.shape[1] // size
    send = y.reshape(b, size, t, *y.shape[2:]).transpose(0, 1).reshape(size * b, t,
                                                                        *y.shape[2:])
    _count(purpose, send.numel() * send.element_size())
    out = y.new_empty((b, t) + tuple(y.shape[2:]))
    dist.reduce_scatter_tensor(out, send, group=group)
    return out


def _pad_tokens(y: torch.Tensor, rows: int) -> torch.Tensor:
    if y.shape[1] == rows:
        return y
    pad = y.new_zeros((y.shape[0], rows - y.shape[1]) + tuple(y.shape[2:]))
    return torch.cat([y, pad], dim=1)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, total, whole_grad):
        ctx.group, ctx.rows, ctx.whole_grad = group, x.shape[1], whole_grad
        return _gather_tokens(x, group, "sp_gather")[:, :total]

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        g = _pad_tokens(g, size * ctx.rows)
        if ctx.whole_grad:  # every rank holds the whole gradient: take its rows
            r = dist.get_rank(ctx.group)
            return g[:, r * ctx.rows:(r + 1) * ctx.rows], None, None, None
        return _scatter_tokens(g, ctx.group, "sp_scatter"), None, None, None


def gather_tokens(x: torch.Tensor, group, total: int) -> torch.Tensor:
    """This rank's token rows (B, t, D) → the whole axis (B, total, D) (the
    padding dropped), into a column-parallel product; backward: the
    reduce-scatter of the ranks' partial gradients."""
    return _GatherTokens.apply(x, group, total, False)


def gather_tokens_whole(x: torch.Tensor, group, total: int) -> torch.Tensor:
    """gather_tokens out of the token-sharded stream into a computation
    every model rank repeats (the final norm, the region tap): backward,
    each rank's rows of the whole gradient."""
    return _GatherTokens.apply(x, group, total, True)


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, split):
        size = dist.get_world_size(group)
        ctx.group, ctx.total, ctx.split = group, y.shape[1], split
        t = tokens_per_rank(y.shape[1], size)
        y = _pad_tokens(y, size * t)
        if split:  # every rank holds the whole tensor: take its rows
            r = dist.get_rank(group)
            return y[:, r * t:(r + 1) * t].contiguous()
        return _scatter_tokens(y, group, "sp_scatter")

    @staticmethod
    def backward(ctx, g):
        return _gather_tokens(g, ctx.group, "sp_gather")[:, :ctx.total], None, None


def scatter_tokens(y: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of each rank's partial (B, T, D) (a
    row-parallel product's output), this rank's token rows (B, t, D);
    backward: the all-gather of the rows' gradients."""
    return _ScatterTokens.apply(y, group, False)


def split_tokens(y: torch.Tensor, group) -> torch.Tensor:
    """A (B, T, D) tensor every model rank holds whole → this rank's token
    rows (B, t, D), into the token-sharded stream; backward: the all-gather
    of the rows' gradients."""
    return _ScatterTokens.apply(y, group, True)


# ------------------------------------------------------------ pipeline stages


def _host_staged(device: torch.device) -> bool:
    """gloo's send and recv take host tensors only: its transport writes
    from the tensor's address, and a CUDA tensor aborts the process (torch
    2.11 on an H100: 'writev: Bad address'). Over gloo a CUDA tensor
    therefore crosses through a host copy, counted as 'pp_host'; NCCL sends
    from the card."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def send_to(x: torch.Tensor, dst: int, purpose: str) -> None:
    """Send `x` to rank `dst` (of the default group), blocking until it is
    handed over; the receiver calls `recv_from` at the same place of its
    program."""
    x = x.contiguous()
    _count(purpose, x.numel() * x.element_size())
    if _host_staged(x.device):
        x = x.cpu()
        _count("pp_host", x.numel() * x.element_size())
    dist.send(x, dst)


def recv_from(shape, dtype: torch.dtype, device: torch.device, src: int) -> torch.Tensor:
    """The tensor rank `src` sends with `send_to` (its shape and dtype known
    to both sides)."""
    if _host_staged(device):
        out = torch.empty(shape, dtype=dtype)
        dist.recv(out, src)
        _count("pp_host", out.numel() * out.element_size())
        return out.to(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, src)
    return out


def broadcast_from(x: torch.Tensor, src: int, group, purpose: str) -> torch.Tensor:
    """Overwrite `x` on every rank of `group` (None: all) with rank `src`'s
    (a rank of the default group), in place."""
    _count(purpose, x.numel() * x.element_size())
    dist.broadcast(x, src, group=group)
    return x
