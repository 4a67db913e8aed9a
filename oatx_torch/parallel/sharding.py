"""Data-axis sharding of the training state (port of oatx/parallel/sharding.py:
`fsdp_param_specs`, `shard_params_fsdp`, `shard_opt_state_zero1`,
`opt_leaf_zero1_sharding`, :76-182).

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
collective. `full_state_dict` and `load_full_state_dict` convert between
the shares and whole tensors one tensor at a time.

The Megatron rules (`_spec_for`, :30-42) and `shard_params_pipeline`
(:185-204) wait for tensor parallelism and pipeline stages (ROADMAP A8b).
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
from oatx_torch.parallel.mesh import Layout

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
    EMA only) shards on this rank; names absent replicate."""
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
            out[name] = FlatShard(tuple(int(s) for s in shape), layout.data_rank,
                                  layout.data_size, group)
    return out


def state_bytes(shapes: Dict[str, Sequence[int]], data_size: int, mode: Optional[str],
                ema: bool = False) -> Dict[str, int]:
    """Per-rank bytes of f32 parameters + gradients + AdamW moments (+ EMA) under
    `mode` (None: replicated) on a data axis of `data_size` → {'bytes',
    'padding' (of those, the flat shards' zero padding), 'replicated' (the
    same state unsharded)}. Every parameter is counted with a gradient."""
    data_size = max(data_size, 1)
    depths = _depths(shapes)
    moments = 3 if ema else 2
    total = pad = full = 0
    for name, shape in shapes.items():
        n = math.prod(int(s) for s in shape)
        dims, taken = oatx_leaf(name, shape, depths)
        chunk = -(-n // data_size)
        extra = chunk - n / data_size
        full += (2 + moments) * n
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
        self.specs: Dict[str, FlatShard] = {}
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
                module._parameters[leaf] = share
                by_module.setdefault(module, []).append(leaf)
                self.specs[name] = spec
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
        scale = 1.0 / (self.layout.world * micro_batches)
        todo = [(p, self.pending[p]) for p in self.shares if p in self.pending]
        self.pending = {}
        bucket, size = [], 0
        for i, (p, g) in enumerate(todo):
            bucket.append((p, g))
            size += g.numel() * g.element_size()
            if size >= coll.BUCKET_BYTES or i == len(todo) - 1:
                self._scatter(bucket, scale)
                bucket, size = [], 0
        coll.reduce_gradients(self.replicated, scale=scale)

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

    def full_state_dict(self, to_host: bool = False,
                        keep: bool = True) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state_dict with whole tensors, gathered one at a time
        (every rank must call it); `to_host`: each copied to the CPU.
        `keep=False` (a rank that writes no snapshot): take part in each
        gather, keep nothing, → None; no rank ever holds more than one
        gathered tensor on its device."""
        out = {}
        for k, v in self.model.state_dict().items():
            spec = self.specs.get(k)
            if spec is not None:
                v = spec.gather(v, "state_gather")
            if keep:
                out[k] = v.to("cpu", copy=True) if to_host else v
        return out if keep else None

    @torch.no_grad()
    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load whole tensors (on any device): each rank keeps its share."""
        own = self.model.state_dict()
        if sorted(own) != sorted(sd):
            missing, extra = set(own) - set(sd), set(sd) - set(own)
            raise RuntimeError(f"state_dict keys differ: missing {sorted(missing)[:5]}, "
                               f"unexpected {sorted(extra)[:5]}")
        for k, v in own.items():
            spec = self.specs.get(k)
            v.copy_(spec.take(sd[k]) if spec is not None else sd[k])


def place(model: nn.Module, mode: Optional[str], layout: Layout) -> Dict[str, FlatShard]:
    """Plan `mode` ('fsdp', 'zero1' or None) for `model`'s parameters on
    `layout` and put fsdp in place → the plan (AdamW's `zero1` under
    zero1). Every rank must call it (it makes the slices' groups)."""
    shards = plan({n: tuple(p.shape) for n, p in model.named_parameters()}, layout, mode)
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
