"""The process layout and the checks of a trainer config against it (port of
oatx/parallel/mesh.py: `process_index`, `process_count`, `batch_shards`,
`spans_processes` and `make_mesh`'s validation and slice grouping, :44-121).

oatx trains one program over a (data, model) mesh, or ('dcn', 'data',
'model') across slices, and shards by GSPMD. The port runs one process per
device under `torch.distributed` (the reference's own mode). Without a
process group, or with a world of one, this is oatx's 1-device mesh.

The ranks keep make_mesh's device order, the model axis fastest
(oatx mesh.py:84-85 reshapes the devices to (n // mp, mp), or to (dcn,
data, mp) with slices). With `model_parallel` mp, rank r is
  * `model_rank` r mod mp: which shard of the tensor-parallel weights it
    holds (parallel/sharding.py);
  * `position` r // mp: its data position, one oatx process. The mp ranks
    of one position form a model group (`model_ranks`): they read the same
    rows, draw the same augmentation and compute the same loss;
  * `data_rank` position mod data_size and `slice_index` position //
    data_size, where data_size = world / (dcn_slices · mp) is a slice's
    data axis.
`batch_size` stays per process as oatx defines it, and a model group acts
as one oatx process: the global batch is batch_size × world / mp
(`batch_shards` = world / mp positions). The ranks at one model rank form
the batch axes ('dcn', 'data') jointly (`batch_ranks`): the batch shards
over them, the loss inputs gather over them and the gradients average over
them. With `dcn_slices` s a slice's ranks at one model rank are its data
axis (`data_ranks`), and the ranks at one data position and model rank of
every slice form a cross-slice group (`cross_ranks`).

What each trainer key gives:
  * `dp_mode`: 'auto' and 'manual' reduce the gradients once per parameter
    after the backward, as oatx's `_manual_dp_grads`; 'gspmd' reduces the
    same gradients but ignores `grad_reduce_dtype` (trainer.py); 'manual'
    with one batch shard, with `fsdp` or under a model axis raises
    ValueError, as in oatx (trainer.py:301-309);
  * `dcn_slices` × `model_parallel` must divide the world (ValueError, as
    in make_mesh);
  * `zero1` shards the AdamW moments (and the EMA) over the data axis and
    `fsdp` the parameters, gradients and moments (parallel/sharding.py);
    neither crosses slices. On one process the data axis is 1 wide and both
    replicate (oatx/train/trainer.py:186-187);
  * `model_parallel` > 1 splits the ViT and DistilBERT weights over the
    model group by Megatron's column / row rules (oatx sharding.py:26-61;
    parallel/sharding.py, parallel/tensor.py), and the model's
    `sequence_parallel` shards the ViT's residual stream over it
    (models/vit_spacetime.py); without a model axis the key is a no-op;
  * `pipeline` with a model axis of P > 1 turns the axis into P GPipe
    stages over the video tower's blocks instead of Megatron splits
    (parallel/pipeline.py): stage s is the model rank s and owns blocks
    [s·L/P, (s + 1)·L/P) (`stage_blocks`, oatx `stage_block_specs`); its
    neighbours are the ranks of the previous and next stage at the same
    data position (`prev_stage`, `next_stage`). With a model axis of 1 it
    is a no-op, as in oatx, where pipeline_stages = model_parallel = 1 runs
    the blocks one after another. With `fsdp` or the video tower's
    `sequence_parallel` it raises oatx's ValueError (trainer.py:78-85),
    and so does `dp_mode: manual` (oatx's pure-DP test, :301-309).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank and world size of the default process group (0 and 1 without
    one), the dcn slices the world splits into, the model axis' width and
    whether that axis holds pipeline stages (module docstring)."""
    rank: int = 0
    world: int = 1
    dcn_slices: int = 1
    model_parallel: int = 1
    pipeline: bool = False

    @property
    def split_size(self) -> int:
        """Ranks the Megatron splits divide a weight over: the model axis,
        or 1 when it holds pipeline stages."""
        return 1 if self.pipeline else self.model_parallel

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    @property
    def model_rank(self) -> int:
        """This rank's place in its model group: the weight shard it holds."""
        return self.rank % self.model_parallel

    @property
    def position(self) -> int:
        """This rank's data position: the oatx process its model group is."""
        return self.rank // self.model_parallel

    @property
    def batch_shards(self) -> int:
        """Ways the global batch is split: the data positions (oatx's
        product of the batch axes, ('dcn', 'data'))."""
        return self.world // self.model_parallel

    @property
    def data_size(self) -> int:
        """Positions on the data axis of one slice: what a shard divides by."""
        return self.batch_shards // self.dcn_slices

    @property
    def data_rank(self) -> int:
        """This rank's position on its slice's data axis."""
        return self.position % self.data_size

    @property
    def slice_index(self) -> int:
        return self.position // self.data_size

    def model_ranks(self, position: int = None) -> range:
        """The ranks of one data position (default: this rank's), in model
        order: a model group."""
        p = self.position if position is None else position
        return range(p * self.model_parallel, (p + 1) * self.model_parallel)

    def batch_ranks(self, model_rank: int = None) -> range:
        """The ranks at one model rank (default: this rank's) of every data
        position: the batch axes."""
        m = self.model_rank if model_rank is None else model_rank
        return range(m, self.world, self.model_parallel)

    def data_ranks(self, slice_index: int, model_rank: int = None) -> range:
        """The ranks of one slice at one model rank (default: this rank's),
        in data order."""
        m = self.model_rank if model_rank is None else model_rank
        mp, n = self.model_parallel, self.data_size
        return range(slice_index * n * mp + m, (slice_index + 1) * n * mp, mp)

    def cross_ranks(self, data_rank: int, model_rank: int = None) -> range:
        """The ranks at one data position and model rank of every slice: the
        replicas of one shard."""
        m = self.model_rank if model_rank is None else model_rank
        mp = self.model_parallel
        return range(data_rank * mp + m, self.world, self.data_size * mp)

    @property
    def stage(self) -> int:
        """Under `pipeline`: this rank's pipeline stage, its model rank."""
        return self.model_rank

    @property
    def prev_stage(self):
        """The rank of the previous stage at this data position (None on
        stage 0)."""
        return self.rank - 1 if self.stage > 0 else None

    @property
    def next_stage(self):
        """The rank of the next stage at this data position (None on the
        last stage)."""
        return self.rank + 1 if self.stage < self.model_parallel - 1 else None

    def stage_blocks(self, depth: int) -> range:
        """The blocks of a `depth`-block stack that this rank's stage owns:
        [s·L/P, (s + 1)·L/P) (oatx stage_block_specs; L must divide by P, as
        oatx's pipeline_blocks asserts)."""
        p, s = self.model_parallel, self.stage
        if depth % p:
            raise ValueError(f"depth {depth} not divisible by {p} stages")
        return range(s * depth // p, (s + 1) * depth // p)


def current_layout(dcn_slices: int = 1, model_parallel: int = 1,
                   pipeline: bool = False) -> Layout:
    """The default group's layout; `pipeline` (trainer.pipeline) makes the
    model axis pipeline stages when it is wider than 1."""
    pipeline = bool(pipeline) and model_parallel > 1
    if dist.is_available() and dist.is_initialized():
        return Layout(dist.get_rank(), dist.get_world_size(), dcn_slices, model_parallel,
                      pipeline)
    return Layout(dcn_slices=dcn_slices, model_parallel=model_parallel, pipeline=pipeline)


def process_index() -> int:
    return current_layout().rank


def process_count() -> int:
    return current_layout().world


def batch_shards() -> int:
    """Ways the global batch is split without a model axis: one shard per
    rank (oatx's product of the batch axes, ('dcn', 'data')); under one,
    `Layout.batch_shards`."""
    return process_count()


def spans_processes() -> bool:
    """True when the default group holds more than one process: then each
    rank holds its rows of the global batch only."""
    return current_layout().spans_processes


def check_layout(t, world: int = None, sequence_parallel: bool = False) -> None:
    """Raise for a TrainerCfg `t` whose layout the world (default: the
    current process group's) cannot run; accept what it runs as oatx does.
    `sequence_parallel`: the video tower's key of that name."""
    world = process_count() if world is None else world
    if (t.dp_mode or "auto") not in ("auto", "gspmd", "manual"):
        raise ValueError(f"unknown trainer.dp_mode {t.dp_mode!r}")
    if t.dcn_slices < 1:
        raise ValueError(f"dcn_slices must be >= 1, got {t.dcn_slices}")
    if t.model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {t.model_parallel}")
    if t.pipeline and t.fsdp:
        raise ValueError("trainer.pipeline and trainer.fsdp both use structured "
                         "placements — enable one")
    if t.pipeline and sequence_parallel:
        raise ValueError(
            "video_params.sequence_parallel cannot combine with "
            "trainer.pipeline: the sharding constraint targets mesh "
            "axes that are manual inside the pipeline's shard_map")
    if world % (t.model_parallel * t.dcn_slices):
        raise ValueError(f"{world} processes not divisible by model_parallel="
                         f"{t.model_parallel} x dcn_slices={t.dcn_slices}")
    if t.dp_mode == "manual" and (world // t.model_parallel == 1 or t.fsdp
                                  or t.model_parallel > 1 or t.pipeline):
        raise ValueError("trainer.dp_mode='manual' needs a >1-shard batch axis and "
                         "replicated params (model_parallel=1, no fsdp/pipeline)")
