"""Sharding of the training state over the model and data axes (port of
oatx/parallel/sharding.py: `_spec_for`, `param_specs`, `fsdp_param_specs`,
`shard_params_fsdp`, `shard_opt_state_zero1`, `opt_leaf_zero1_sharding`,
:26-182).

Which tensors shard follows oatx's rules, applied to the oatx leaf that each
of the port's parameters belongs to (oatx stacks a tower's layers on a
leading depth axis, so `video_model.blocks.3.mlp.fc1.weight` is row 3 of
oatx's (depth, in, out) `video/blocks/mlp/fc1/kernel`):
  * `fsdp`: a leaf of at least FSDP_MIN_SIZE elements (oatx's `min_size`,
    2**16) with a dimension that divides by the data size shards, parameter,
    gradient and moments alike; oatx never takes the dimension that its
    Megatron rules name for the model axis (a column-parallel kernel's
    output, a row-parallel kernel's input, the vocabulary of `word`), even
    with a model axis of 1, and neither does `fsdp_placement` here. Smaller
    or indivisible leaves replicate;
  * `zero1`: the parameters and gradients replicate; every moment (and the
    EMA) whose leaf has a dimension that divides by the data size shards,
    whatever its size.
Neither crosses dcn slices: the data axis is the ranks of one slice
(parallel/mesh.py), and the slices hold replicas of its shards.

A sharded tensor is held as a `FlatShard`: its elements in row-major order,
padded with zeros to a multiple of the data size, and this rank's equal
share of them. oatx's shards split one dimension; the port's are flat, which
needs no divisibility of the port's own (unstacked) shapes and holds at most
data_size − 1 padding elements per tensor beyond oatx's share
(`state_bytes` counts them).

`place` puts `fsdp` in place on a model (its `ShardedModel`, `model.fsdp`):
each sharded parameter is replaced, under its own name, by a 1-D parameter
holding this rank's share, and its module class gains a property that,
while `ShardedModel.gathering()` is on (the train step's forward and
backward, the eval step), returns the whole tensor all-gathered over the
data axis at each access: the port's
counterpart of the all-gather XLA inserts at each use of an fsdp weight. The
gather's backward adds the whole gradient to a buffer; after the last
micro-batch `ShardedModel.reduce_gradients` reduce-scatters the buffers over
the data axis (then all-reduces across slices) into each share's `.grad`
and all-reduces the replicated leaves' gradients, all to their mean. A remat
recompute accesses the weights again and so gathers them again. Outside
`gathering()` an access returns the share, so nothing off the step sends a
collective. `full_state_dict` and `load_full_state_dict` (module
functions) convert between the shares and whole tensors one tensor at a
time.

Tensor parallelism over a model axis (`model_parallel` mp > 1,
parallel/mesh.py): oatx's Megatron rules (`_spec_for`, `param_specs`,
:26-61) on each parameter's oatx leaf (`oatx_leaf`'s taken dimension):
fc1 / lin1 / qkv / q_lin / k_lin / v_lin weights split their output rows,
fc2 / lin2 / proj / out_lin their input columns, DistilBERT's word table its
vocabulary rows; every bias, norm, embedding, the patch embedding and the
projections replicate, and so does a weight whose taken dimension does not
divide by mp, as in oatx. A split tensor is held as its `ModelShard`: this
rank's rows or columns, the parameter replaced under its own name by a
parameter of the local shape (`place_model_parallel`), and the towers told
to run on it (models/towers.py `enable_model_parallel`). oatx splits the
fused qkv's 3·D outputs contiguously, so at mp 4 its rank 0 would hold q's
first 9 heads of 12; attention on whole heads needs each rank's q, k and v
of the same heads, so the port's rank r holds rows [r·D/mp, (r + 1)·D/mp)
of each of q, k and v (`ModelShard.groups` = 3): the same number of bytes as
oatx's shard, other rows. `fsdp` and `zero1` compose with the split as
oatx's fsdp_param_specs does: their flat data-axis shares are taken of each
rank's model-local tensor, and which leaves shard follows oatx's rules on
the whole leaf. (oatx's zero1 re-places each moment on the data axis alone,
dropping its model-axis split; the port keeps the moments model-local and
takes its data shares of those, so a rank holds no more than oatx's.)
`state_bytes`, `full_state_dict` and `load_full_state_dict` gather and
scatter over the model group too, one whole tensor at a time. After the
backward, `reduce_model_partials` sums over the model group the gradients
each rank holds in part (the towers' `tp_partial_params`).

Pipeline stages over the model axis (`trainer.pipeline`, a Layout whose
`pipeline` is set; oatx `shard_params_pipeline`, :185-204): the video
tower's blocks are split by depth, stage s holding blocks [s·L/P,
(s + 1)·L/P) under their global names (`video_model.blocks.N.*`), and every
other parameter is whole on every rank; no Megatron split applies.
`place_pipeline` drops the other stages' blocks from the model and keeps a
`StagePlan` of the whole model's state-dict keys; `full_state_dict` and
`load_full_state_dict` (and AdamW's named_state) go through it: a block's
tensor comes from its stage's rank of the model group by a broadcast, one
tensor at a time. `zero1` composes: the moments of what a rank holds
(its blocks and the whole rest) shard over the data axis of its stage, by
oatx's rule on the whole leaf. oatx applies zero1 after the pipeline
placement and re-places each moment on the data axis alone
(opt_leaf_zero1_sharding), which takes the depth axis of a stacked (L, ...)
block leaf and drops its stage split: an oatx device then holds L/data
blocks' moments where a port rank holds (L/P)/data (`state_bytes` counts
the port's). The embedding's gradients, which stage 0 alone computes, are
summed over the model group after the backward (`reduce_model_partials`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel.mesh import Layout, current_layout
from oatx_torch.parallel.tensor import ModelAxis

FSDP_MIN_SIZE = 2 ** 16  # oatx fsdp_param_specs' min_size

# the port's module names of oatx's Megatron kernels (oatx sharding.py:24-25):
# a column-parallel kernel's output dim and a row-parallel kernel's input dim
# are the model axis's, which fsdp leaves alone
_COL = {"fc1", "lin1", "qkv", "q_lin", "k_lin", "v_lin", "query", "key", "value", "c_fc"}
_ROW = {"fc2", "lin2", "proj", "out_lin", "out_proj", "c_proj"}
_TABLES = {"word_embeddings", "position_embeddings", "token_type_embeddings",
           "token_embedding"}
_STACKED = re.compile(r"^(.*\.(?:blocks|layer|resblocks|layers))\.(\d+)\.(.+)$")


def _depths(names: Iterable[str]) -> Dict[str, int]:
    """Layers per stacked list (e.g. 'video_model.blocks' → 12)."""
    seen: Dict[str, set] = {}
    for n in names:
        m = _STACKED.match(n)
        if m:
            seen.setdefault(m.group(1), set()).add(m.group(2))
    return {k: len(v) for k, v in seen.items()}


def oatx_leaf(name: str, shape: Sequence[int],
              depths: Dict[str, int]) -> Tuple[Tuple[int, ...], Optional[int]]:
    """(shape of the oatx leaf the parameter belongs to, index of the dim
    that oatx's Megatron rules name for the model axis, or None)."""
    shape = tuple(int(s) for s in shape)
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    grand = parts[-3] if len(parts) > 2 else ""
    taken = None
    if leaf == "in_proj_weight" or (leaf == "weight" and len(shape) == 2
                                    and parent not in _TABLES):
        dims = shape[::-1]  # a Linear's (out, in) is oatx's (in, out) kernel
        kind = "qkv" if leaf == "in_proj_weight" else parent
        if kind == "dense":  # BERT: intermediate.dense / (attention.)output.dense
            kind = {"intermediate": "fc1", "output": "fc2"}.get(grand, kind)
        if kind in _COL:
            taken = 1
        elif kind in _ROW:
            taken = 0
    elif leaf == "weight" and len(shape) == 4:
        dims = (shape[2], shape[3], shape[1], shape[0])  # conv (kh, kw, in, out)
    else:
        dims = shape
        if parent == "word_embeddings" and len(shape) == 2:
            taken = 0
    m = _STACKED.match(name)
    if m:
        dims = (depths[m.group(1)],) + dims
        taken = None if taken is None else taken + 1
    return dims, taken


_STAGED = re.compile(r"^((?:video_model\.)?blocks)\.(\d+)\.")  # in a DualTower, a lone tower


def _video_depth(names: Iterable[str]) -> int:
    """Blocks of the video tower among the names."""
    return len({m.group(2) for n in names if (m := _STAGED.match(n))})


def _stage_of(name: str, depth: int, stages: int) -> Optional[int]:
    """The pipeline stage owning a video block's parameter or buffer (None
    for every other name): block N of L belongs to stage N // (L / P)."""
    m = _STAGED.match(name)
    if m is None:
        return None
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} stages")
    return int(m.group(2)) // (depth // stages)


def _model_split(name: str, shape: Sequence[int], depths: Dict[str, int],
                 size: int) -> Optional[Tuple[int, int]]:
    """(torch dim, groups) that oatx's Megatron rules split over a model axis
    of `size` for this parameter, or None (replicated: no rule names it, or
    the named dimension does not divide by `size`)."""
    if size <= 1:
        return None
    dims, taken = oatx_leaf(name, shape, depths)
    if taken is None or dims[taken] % size:
        return None
    parts = name.split(".")
    if parts[-2] == "word_embeddings":
        return 0, 1
    own = taken - (1 if _STACKED.match(name) else 0)  # oatx (in, out) ↔ torch (out, in)
    if own == 1:
        return 0, (3 if parts[-2] == "qkv" or parts[-1] == "in_proj_weight" else 1)
    return 1, 1


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShard:
    """This rank's part of a tensor split over the model group: `shape` is
    the whole tensor's; dimension `dim`, seen as (groups, size, n), keeps
    index `rank` of its size axis (module docstring; the fused qkv has
    groups = 3, q, k and v)."""
    shape: Tuple[int, ...]
    dim: int
    groups: int
    rank: int
    size: int
    group: object = None

    @property
    def local_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        s[self.dim] //= self.size
        return tuple(s)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole tensor, a new contiguous tensor."""
        d = self.dim
        n = self.shape[d] // (self.groups * self.size)
        part = full.detach().reshape(*self.shape[:d], self.groups, self.size, n,
                                     *self.shape[d + 1:]).select(d + 1, self.rank)
        out = full.new_empty(self.local_shape)
        out.view(part.shape).copy_(part)
        return out

    def whole(self, parts: torch.Tensor) -> torch.Tensor:
        """The tensor from every rank's part, stacked in group order on a
        leading axis of `size`."""
        d = self.dim
        n = self.shape[d] // (self.groups * self.size)
        p = parts.reshape(self.size, *self.shape[:d], self.groups, n, *self.shape[d + 1:])
        return p.movedim(0, d + 1).reshape(self.shape)

    def gather(self, part: torch.Tensor, purpose: str) -> torch.Tensor:
        got = coll.all_gather_flat(part, self.group, purpose)
        return self.whole(got.view(self.size, *self.local_shape))


def model_plan(shapes: Dict[str, Sequence[int]], layout: Layout) -> Dict[str, ModelShard]:
    """{parameter name: its ModelShard} for the parameters (whole `shapes`)
    that oatx's Megatron rules split over `layout`'s model axis."""
    size = layout.split_size
    if size <= 1:
        return {}
    depths = _depths(shapes)
    group = coll.model_group(layout)
    out = {}
    for name, shape in shapes.items():
        split = _model_split(name, shape, depths, size)
        if split is not None:
            out[name] = ModelShard(tuple(int(s) for s in shape), split[0], split[1],
                                   layout.model_rank, size, group)
    return out


def _divisible(dims: Sequence[int], n: int, skip: Optional[int] = None) -> bool:
    return any(d % n == 0 and d >= n for i, d in enumerate(dims) if i != skip)


def fsdp_placement(dims: Sequence[int], taken: Optional[int], data_size: int) -> bool:
    """oatx fsdp_param_specs' `upgrade` on one leaf: does it shard?"""
    if data_size <= 1 or len(dims) == 0 or math.prod(dims) < FSDP_MIN_SIZE:
        return False
    return _divisible(dims, data_size, taken)


def zero1_placement(dims: Sequence[int], data_size: int) -> bool:
    """oatx opt_leaf_zero1_sharding on one moment leaf: does it shard?"""
    return data_size > 1 and len(dims) > 0 and _divisible(dims, data_size)


@dataclasses.dataclass(frozen=True, eq=False)
class FlatShard:
    """This rank's share of one tensor: elements [start, start + chunk) of
    its row-major elements padded with zeros to data_size·chunk. `group` is
    the data axis' process group (None: the default group)."""
    shape: Tuple[int, ...]
    rank: int
    size: int
    group: object = None

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def chunk(self) -> int:
        return -(-self.numel // self.size)

    @property
    def padded(self) -> int:
        return self.chunk * self.size

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's share of a whole tensor, a new contiguous 1-D tensor."""
        flat = full.detach().reshape(-1)
        lo = self.rank * self.chunk
        piece = flat[lo:lo + self.chunk]
        out = flat.new_zeros(self.chunk)
        out[:piece.numel()] = piece
        return out

    def pad(self, full: torch.Tensor) -> torch.Tensor:
        """A whole tensor as (size, chunk): row r is rank r's share."""
        flat = full.reshape(-1)
        if self.padded != self.numel:
            flat = nn.functional.pad(flat, (0, self.padded - self.numel))
        return flat.view(self.size, self.chunk)

    def whole(self, gathered: torch.Tensor) -> torch.Tensor:
        """The tensor from every rank's share in rank order (padded, 1-D)."""
        return gathered[:self.numel].view(self.shape)

    def gather(self, share: torch.Tensor, purpose: str) -> torch.Tensor:
        return self.whole(coll.all_gather_flat(share, self.group, purpose))


def plan(shapes: Dict[str, Sequence[int]], layout: Layout,
         mode: Optional[str]) -> Dict[str, FlatShard]:
    """{parameter name: its FlatShard} for the tensors that `mode` ('fsdp':
    the parameters, their gradients and moments; 'zero1': the moments and
    EMA only) shards on this rank; names absent replicate. `shapes` are the
    whole parameters'; under a model axis a share is of the rank's
    model-local part."""
    if mode not in ("fsdp", "zero1") or layout.data_size <= 1:
        return {}
    depths = _depths(shapes)
    group = coll.data_group(layout)
    out = {}
    for name, shape in shapes.items():
        dims, taken = oatx_leaf(name, shape, depths)
        on = (fsdp_placement(dims, taken, layout.data_size) if mode == "fsdp"
              else zero1_placement(dims, layout.data_size))
        if on:
            split = _model_split(name, shape, depths, layout.split_size)
            local = list(int(s) for s in shape)
            if split is not None:
                local[split[0]] //= layout.split_size
            out[name] = FlatShard(tuple(local), layout.data_rank, layout.data_size, group)
    return out


def state_bytes(shapes: Dict[str, Sequence[int]], data_size: int, mode: Optional[str],
                ema: bool = False, model_parallel: int = 1,
                pipeline: bool = False) -> Dict[str, int]:
    """Per-rank bytes of f32 parameters + gradients + AdamW moments (+ EMA) under
    `mode` (None: replicated) on a data axis of `data_size` and a model axis
    of `model_parallel` (`shapes` whole), its Megatron splits or, with
    `pipeline`, its stages (a rank holds L/P of the video blocks: stage 0's
    are counted, the same bytes as any stage's) → {'bytes', 'padding' (of
    those, the flat shards' zero padding), 'replicated' (the same state
    unsharded on both axes)}. Every parameter is counted with a gradient."""
    data_size = max(data_size, 1)
    depths = _depths(shapes)
    moments = 3 if ema else 2
    total = pad = full = 0
    video_depth = _video_depth(shapes)
    for name, shape in shapes.items():
        whole = math.prod(int(s) for s in shape)
        full += (2 + moments) * whole
        owner = _stage_of(name, video_depth, model_parallel) if pipeline else None
        if owner is not None and owner > 0:  # another stage's block
            continue
        dims, taken = oatx_leaf(name, shape, depths)
        split = None if pipeline else _model_split(name, shape, depths, model_parallel)
        n = whole // model_parallel if split is not None else whole
        chunk = -(-n // data_size)
        extra = chunk - n / data_size
        if mode == "fsdp" and fsdp_placement(dims, taken, data_size):
            total += (2 + moments) * chunk
            pad += (2 + moments) * extra
        elif mode == "zero1" and zero1_placement(dims, data_size):
            total += 2 * n + moments * chunk
            pad += moments * extra
        else:
            total += (2 + moments) * n
    return {"bytes": 4 * total, "padding": round(4 * pad), "replicated": 4 * full}


def held_bytes(model: nn.Module, optimizer) -> Dict[str, int]:
    """Bytes this rank holds for the training state, read from the storage
    of the tensors (each storage once): parameters, gradients and the
    optimizer's per-parameter state."""
    seen = set()

    def size(ts):
        total = 0
        for t in ts:
            if t is None or not isinstance(t, torch.Tensor) or t.numel() == 0:
                continue
            s = t.untyped_storage()
            if s.data_ptr() not in seen:
                seen.add(s.data_ptr())
                total += s.nbytes()
        return total

    params = list(model.parameters())
    out = {"params": size(params), "grads": size(p.grad for p in params),
           "moments": size(v for p in params for v in optimizer.state[p].values())}
    out["total"] = sum(out.values())
    return out


# ------------------------------------------------------------------ fsdp


class _Gather(torch.autograd.Function):
    """share → the whole tensor; backward: the whole gradient into the
    model's buffer (reduced after the last micro-batch)."""

    @staticmethod
    def forward(ctx, share, owner, spec):
        ctx.owner, ctx.share = owner, share
        return spec.gather(share.detach(), "param_gather")

    @staticmethod
    def backward(ctx, g):
        ctx.owner._accumulate(ctx.share, g)
        return None, None, None


def _access(module: nn.Module, name: str):
    p = module._parameters[name]
    owner = p._oatx_owner
    return _Gather.apply(p, owner, p._oatx_shard) if owner.active else p


_CLASSES: Dict[Tuple[type, frozenset], type] = {}


def _gathering_class(cls: type, names: Iterable[str]) -> type:
    """`cls` with a property per sharded parameter name (module docstring)."""
    key = (cls, frozenset(names))
    if key not in _CLASSES:
        props = {n: property(lambda self, n=n: _access(self, n)) for n in key[1]}
        _CLASSES[key] = type(cls.__name__, (cls,), props)
    return _CLASSES[key]


def _owner_of(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


class ShardedModel:
    """The fsdp state of one model (module docstring); `model.fsdp` once
    `place` has put fsdp in place."""

    def __init__(self, model: nn.Module, shards: Dict[str, FlatShard], layout: Layout):
        self.layout = layout
        self.active = False
        self.cross = coll.cross_group(layout)
        self.shares: List[nn.Parameter] = []
        self.pending: Dict[nn.Parameter, torch.Tensor] = {}
        by_module: Dict[nn.Module, List[str]] = {}
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                spec = shards.get(name)
                if spec is None:
                    continue
                module, leaf = _owner_of(model, name)
                share = nn.Parameter(spec.take(p), requires_grad=p.requires_grad)
                share._oatx_shard, share._oatx_owner = spec, self
                share._oatx_tp = getattr(p, "_oatx_tp", None)
                module._parameters[leaf] = share
                by_module.setdefault(module, []).append(leaf)
                self.shares.append(share)
        for module, names in by_module.items():
            module.__class__ = _gathering_class(type(module), names)
        self.replicated = [p for p in model.parameters()
                           if getattr(p, "_oatx_owner", None) is not self]
        self.model = model

    @contextlib.contextmanager
    def gathering(self):
        """Parameter accesses inside gather the whole tensors."""
        prev, self.active = self.active, True
        try:
            yield
        finally:
            self.active = prev

    def _accumulate(self, share: nn.Parameter, g: torch.Tensor) -> None:
        g = g.detach()
        if share in self.pending:
            self.pending[share].add_(g)
        else:
            self.pending[share] = torch.empty_like(
                g, memory_format=torch.contiguous_format).copy_(g)

    @torch.no_grad()
    def reduce_gradients(self, micro_batches: int = 1) -> None:
        """Every share's `.grad` ← its share of the mean gradient over the
        ranks (and micro-batches); the replicated leaves' `.grad` likewise
        whole. Which parameters have a gradient must agree across ranks (it
        follows from the config)."""
        scale = 1.0 / (self.layout.batch_shards * micro_batches)
        todo = [(p, self.pending[p]) for p in self.shares if p in self.pending]
        self.pending = {}
        bucket, size = [], 0
        for i, (p, g) in enumerate(todo):
            bucket.append((p, g))
            size += g.numel() * g.element_size()
            if size >= coll.BUCKET_BYTES or i == len(todo) - 1:
                self._scatter(bucket, scale)
                bucket, size = [], 0
        coll.reduce_gradients(self.replicated, scale=scale,
                              group=coll.batch_group(self.layout))

    def _scatter(self, bucket, scale: float) -> None:
        spec0 = bucket[0][0]._oatx_shard
        send = torch.cat([p._oatx_shard.pad(g) for p, g in bucket], dim=1).reshape(-1)
        got = coll.reduce_scatter_flat(send, spec0.group, "grad_scatter")
        if self.cross is not None:
            coll.all_reduce_sum(got, "grad_cross", self.cross)
        got.mul_(scale)
        off = 0
        for p, _ in bucket:
            n = p._oatx_shard.chunk
            p.grad = got[off:off + n]
            off += n


def held_whole(t: torch.Tensor, p: nn.Parameter, purpose: str,
               share: Optional[FlatShard] = None) -> torch.Tensor:
    """The whole tensor of `t`, held for parameter `p` (the parameter, its
    gradient or a moment): its data-axis `share` (default: fsdp's, if p is
    one) gathered, then its model-axis parts (every rank of the groups
    calls it)."""
    share = share if share is not None else getattr(p, "_oatx_shard", None)
    if share is not None:
        t = share.gather(t, purpose)
    tp = getattr(p, "_oatx_tp", None)
    return tp.gather(t, purpose) if tp is not None else t


def held_part(full: torch.Tensor, p: nn.Parameter,
              share: Optional[FlatShard] = None) -> torch.Tensor:
    """What this rank holds of a whole tensor for parameter `p`: its
    model-axis part, then its data-axis share (held_whole's inverse)."""
    tp = getattr(p, "_oatx_tp", None)
    part = tp.take(full) if tp is not None else full
    share = share if share is not None else getattr(p, "_oatx_shard", None)
    return share.take(part) if share is not None else part


def full_state_dict(model: nn.Module, to_host: bool = False,
                    keep: bool = True) -> Optional[Dict[str, torch.Tensor]]:
    """The model's state_dict with whole tensors, gathered one at a time over
    the data and model axes (every rank must call it); `to_host`: each
    copied to the CPU. `keep=False` (a rank that writes no snapshot): take
    part in each gather, keep nothing, → None; no rank ever holds more than
    one gathered tensor on its device."""
    params = dict(model.named_parameters())
    own = model.state_dict()
    stages = stage_plan_of(model)
    out = {}
    for k in (stages.keys if stages is not None else own):
        if stages is not None and stages.owner(k) is not None:
            v = stages.fetch(k, own.get(k))
        else:
            v, p = own[k], params.get(k)
            if p is not None:
                v = held_whole(v, p, "state_gather")
        if keep:
            out[k] = v.to("cpu", copy=True) if to_host else v
    return out if keep else None


@torch.no_grad()
def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load whole tensors (on any device): each rank keeps its parts."""
    own = model.state_dict()
    stages = stage_plan_of(model)
    want = list(stages.keys) if stages is not None else list(own)
    if sorted(want) != sorted(sd):
        missing, extra = set(want) - set(sd), set(sd) - set(want)
        raise RuntimeError(f"state_dict keys differ: missing {sorted(missing)[:5]}, "
                           f"unexpected {sorted(extra)[:5]}")
    params = dict(model.named_parameters())
    for k, v in own.items():
        p = params.get(k)
        v.copy_(held_part(sd[k], p) if p is not None else sd[k])


def sharded(model: nn.Module) -> bool:
    """True when some parameter of `model` is held in part (fsdp's share, a
    model-axis split or another pipeline stage's blocks): whole tensors
    then need every rank."""
    return stage_plan_of(model) is not None or any(
        getattr(p, "_oatx_shard", None) is not None
        or getattr(p, "_oatx_tp", None) is not None for p in model.parameters())


@dataclasses.dataclass(frozen=True, eq=False)
class StagePlan:
    """The whole model's state as a pipeline stage holds it (module
    docstring): every state-dict key in order with its shape and dtype,
    the parameter names in order, and the stage owning each video block's
    key; `layout` is the rank's, `device` the model's, `group` its model
    group (None: the whole world)."""
    keys: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    params: Tuple[str, ...]
    owners: Dict[str, int]
    layout: Layout
    device: torch.device
    group: object = None

    def owner(self, key: str) -> Optional[int]:
        """The stage holding `key` (None: every stage holds it whole)."""
        return self.owners.get(key)

    def fetch(self, key: str, local: Optional[torch.Tensor]) -> torch.Tensor:
        """The whole tensor of a block's `key` (or of a tensor of its shape
        and dtype: a gradient, a moment) on every rank of the model group,
        from its stage's rank (`local`: this rank's, when it is that stage;
        every rank of the group calls it)."""
        src = self.layout.model_ranks()[self.owners[key]]
        if src == self.layout.rank:
            buf = local.detach().contiguous()
        else:
            shape, dtype = self.keys[key]
            buf = torch.empty(shape, dtype=dtype, device=self.device)
        return coll.broadcast_from(buf, src, self.group, "state_gather")


def stage_plan_of(model: nn.Module) -> Optional[StagePlan]:
    """The StagePlan `place_pipeline` put on `model` (None: not pipelined)."""
    return getattr(model, "pp_plan", None)


def place_pipeline(model: nn.Module, layout: Layout) -> StagePlan:
    """Keep this rank's stage of the video tower's blocks and drop the
    others (module docstring; `enable_pipeline` on the towers) → the plan,
    which each kept block parameter carries as `_oatx_pp`. Every rank must
    call it (it makes the model groups)."""
    sd = model.state_dict()
    keys = {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
    names = tuple(n for n, _ in model.named_parameters())
    depth = _video_depth(keys)
    owners = {k: o for k in keys
              if (o := _stage_of(k, depth, layout.model_parallel)) is not None}
    device = next(iter(sd.values())).device
    del sd
    model.enable_pipeline(layout)
    plan = StagePlan(keys, names, owners, layout, device, coll.model_group(layout))
    for n, p in model.named_parameters():
        if n in owners:
            p._oatx_pp = plan
    model.pp_plan = plan
    return plan


def place_model_parallel(model: nn.Module, layout: Layout) -> Dict[str, ModelShard]:
    """Split `model`'s parameters over `layout`'s model axis (module
    docstring): each split one replaced, under its own name, by a parameter
    holding this rank's part, and the towers told to run on them
    (`enable_model_parallel`) → the plan. Every rank must call it (it makes
    the model groups)."""
    if layout.model_parallel <= 1:
        return {}
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = model_plan(shapes, layout)
    axis = ModelAxis(layout.model_parallel, layout.model_rank, coll.model_group(layout))
    model.enable_model_parallel(axis, set(specs))
    with torch.no_grad():
        for name, spec in specs.items():
            module, leaf = _owner_of(model, name)
            p = module._parameters[leaf]
            part = nn.Parameter(spec.take(p), requires_grad=p.requires_grad)
            part._oatx_tp = spec
            module._parameters[leaf] = part
    model.model_axis = axis
    return specs


@torch.no_grad()
def reduce_model_partials(model: nn.Module) -> None:
    """Sum over the model group the gradients each of its ranks holds in part
    (the towers' `tp_partial_params`: a LayerNorm applied after `enter`, on
    a token shard or inside kernels 1 and 3, and a bias used by rows or on a
    token shard), once a step, after the data axis' reduction: a parameter
    fsdp shares is whole on every model rank, so its ranks' shares cover the
    same elements and their sum is the share of the sum. Under pipeline
    stages: the embedding's gradients (the towers' `pp_partial_params`),
    which only stage 0 computes, summed over the model group."""
    stages = stage_plan_of(model)
    if stages is not None:
        params = model.pp_partial_params()
        for p in params:
            if p.grad is None:  # a stage > 0: the stack's input is stage 0's
                p.grad = torch.zeros_like(p)
        coll.reduce_gradients(params, scale=1.0, group=stages.group, purpose="pp_embed")
        return
    axis = getattr(model, "model_axis", None)
    if axis is None:
        return
    params = [p for p in model.tp_partial_params() if p.grad is not None]
    coll.reduce_gradients(params, scale=1.0, group=axis.group, purpose="tp_norm")


def layout_of(model: nn.Module) -> Layout:
    """The layout `place` put `model` on (the current group's, with one
    slice and no model axis, for a model it never placed)."""
    return getattr(model, "layout", None) or current_layout()


def place(model: nn.Module, mode: Optional[str], layout: Layout) -> Dict[str, FlatShard]:
    """Split `model` over `layout`'s model axis (Megatron's splits, or its
    pipeline stages when `layout.pipeline`), plan `mode` ('fsdp',
    'zero1' or None) for its parameters on the data axis and put fsdp in
    place → the data-axis plan (AdamW's `zero1` under zero1). Every rank
    must call it (it makes the layout's groups)."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    model.layout = layout
    if layout.pipeline:
        if mode == "fsdp":
            raise ValueError("trainer.pipeline and trainer.fsdp both use structured "
                             "placements — enable one")
        place_pipeline(model, layout)
    else:
        place_model_parallel(model, layout)
    held = {n for n, _ in model.named_parameters()}
    shards = {n: s for n, s in plan(shapes, layout, mode).items() if n in held}
    if mode == "fsdp" and layout.spans_processes:
        model.fsdp = ShardedModel(model, shards, layout)
    return shards


def fsdp_of(model: nn.Module) -> Optional[ShardedModel]:
    return getattr(model, "fsdp", None)


def gathered(model: nn.Module):
    """The context in which `model`'s forward may run: gathering() under
    fsdp, else nothing."""
    sm = fsdp_of(model)
    return sm.gathering() if sm is not None else contextlib.nullcontext()
