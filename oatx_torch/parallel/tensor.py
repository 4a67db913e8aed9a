"""Tensor parallelism inside the towers (the port's counterpart of the
Megatron splits oatx expresses as GSPMD annotations, oatx/parallel/
sharding.py:26-61, and of its token-sharded activation stream,
oatx/models/vit_spacetime.py:270-282 `_sp_constrain`).

`ModelAxis` is what a module holds once parallel/sharding.py has put
tensor parallelism in place (`DualTower.enable_model_parallel`): the
model group's width, this rank's place in it, the group, and whether the
module's residual stream is token-sharded (`sequence_parallel`). A
column-parallel product takes this rank's output rows of the weight, a
row-parallel one its input columns; the biases stay whole on every rank, as
oatx replicates every bias (`_spec_for` names kernels only), and a
column-parallel product adds its rows of the bias (`local_rows`), a
row-parallel one the whole bias once, after the reduction.

`enter` and `leave` are the collectives around a tensor-parallel sublayer:
without sequence parallelism the identity / all-reduce pair
(collectives.copy_to_model, reduce_from_model), with it the token axis'
all-gather / reduce-scatter pair (gather_tokens, scatter_tokens).
`vocab_lookup` is the vocabulary-parallel embedding: each rank looks up the
ids in its rows of the table, zeros elsewhere, and the model group sums.
"""

from __future__ import annotations

import dataclasses

import torch

from oatx_torch.ops.layers import embedding_lookup
from oatx_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """The model group as a module sees it (module docstring)."""
    size: int
    rank: int
    group: object = None
    sequence_parallel: bool = False

    def heads(self, num_heads: int) -> int:
        """Attention heads this rank computes."""
        return num_heads // self.size


def layer_axis(axis: ModelAxis, heads: int, tower: str, want, split) -> ModelAxis:
    """The axis a tower's layers run on (sequence_parallel off: only the
    ViT's stream is token-sharded, as oatx constrains it alone), once its
    heads divide by the group's width and every name in `want` is among
    `split` (the parameters parallel/sharding.py splits, which leaves a
    weight whole where its width does not divide); ValueError otherwise."""
    if heads % axis.size:
        raise ValueError(f"model_parallel={axis.size} does not divide {tower}'s {heads} heads")
    missing = [n for n in want if n not in split]
    if missing:
        raise ValueError(f"model_parallel={axis.size} does not divide the widths of "
                         f"{missing[:3]}")
    return dataclasses.replace(axis, sequence_parallel=False)


def local_rows(t: torch.Tensor, axis: ModelAxis, groups: int = 1) -> torch.Tensor:
    """This rank's entries of a whole vector (a column-parallel bias) seen as
    (groups, size, n): the fused qkv's bias takes groups = 3, so the rank's
    q, k and v entries of its heads, as its rows of the weight."""
    return t.view(groups, axis.size, -1)[:, axis.rank].reshape(-1)


def enter(axis: ModelAxis, x: torch.Tensor, total: int) -> torch.Tensor:
    """The input of a column-parallel product: x replicated (identity,
    all-reduce backward) or x's token rows gathered into `total` rows."""
    if axis.sequence_parallel:
        return coll.gather_tokens(x, axis.group, total)
    return coll.copy_to_model(x, axis.group)


def leave(axis: ModelAxis, y: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product, summed over the model group:
    whole (all-reduce) or this rank's token rows (reduce-scatter)."""
    if axis.sequence_parallel:
        return coll.scatter_tokens(y, axis.group)
    return coll.reduce_from_model(y, axis.group)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Rows of a vocabulary split over the model group: `table` is this
    rank's (V / size, D) rows [rank·V/size, (rank + 1)·V/size); ids outside
    them look up zeros; the sum over the group is the whole lookup."""
    rows = table.shape[0]
    lo = axis.rank * rows
    ids = ids.long()
    mine = (ids >= lo) & (ids < lo + rows)
    out = embedding_lookup(table, torch.where(mine, ids - lo, torch.zeros_like(ids)))
    return coll.reduce_from_model(out.masked_fill(~mine[..., None], 0), axis.group)
