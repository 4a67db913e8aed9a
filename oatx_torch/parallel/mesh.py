"""The process layout and the checks of a trainer config against it (port of
oatx/parallel/mesh.py: `process_index`, `process_count`, `batch_shards`,
`spans_processes` and `make_mesh`'s validation and slice grouping, :44-121).

oatx trains one program over a (data, model) mesh, or ('dcn', 'data',
'model') across slices, and shards by GSPMD. The port runs one process per
device under `torch.distributed` (the reference's own mode): rank r of a
world of n owns a per-process batch, as oatx's per-process batch
(`batch_size` is per process, oatx/train/trainer.py:105-118). Without a
process group, or with a world of one, this is oatx's 1-device mesh. The
ranks form the batch axes ('dcn', 'data') jointly: the batch shards over all
of them. With `dcn_slices` s the world splits into s slices of n/s
consecutive ranks each, as make_mesh groups devices by slice: a slice's
ranks are its data axis (`Layout.data_ranks`), and the ranks at one
position of every slice form a cross-slice group (`Layout.cross_ranks`).

What each trainer key gives:
  * `dp_mode`: 'auto' and 'manual' reduce the gradients once per parameter
    after the backward, as oatx's `_manual_dp_grads`; 'gspmd' reduces the
    same gradients but ignores `grad_reduce_dtype` (trainer.py); 'manual'
    with one shard, or with `fsdp`, raises ValueError, as in oatx
    (trainer.py:301-309);
  * `dcn_slices` must divide the world (ValueError, as in make_mesh);
  * `zero1` shards the AdamW moments (and the EMA) over the data axis and
    `fsdp` the parameters, gradients and moments (parallel/sharding.py);
    neither crosses slices. On one process the data axis is 1 wide and both
    replicate (oatx/train/trainer.py:186-187);
  * `model_parallel` > 1 and `pipeline` need a model axis and raise
    NotImplementedError at any world (ROADMAP A8b); `pipeline` with `fsdp`
    raises ValueError first, as in oatx (trainer.py:78-80). The model's
    `sequence_parallel` is a no-op without a model axis
    (models/vit_spacetime.py).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank and world size of the default process group (0 and 1 without
    one), and the dcn slices the world splits into."""
    rank: int = 0
    world: int = 1
    dcn_slices: int = 1

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    @property
    def data_size(self) -> int:
        """Ranks on the data axis of one slice: what a shard divides by."""
        return self.world // self.dcn_slices

    @property
    def data_rank(self) -> int:
        """This rank's position on its slice's data axis."""
        return self.rank % self.data_size

    @property
    def slice_index(self) -> int:
        return self.rank // self.data_size

    def data_ranks(self, slice_index: int) -> range:
        """The ranks of one slice, in data order."""
        return range(slice_index * self.data_size, (slice_index + 1) * self.data_size)

    def cross_ranks(self, data_rank: int) -> range:
        """The ranks at one data position of every slice: the replicas of
        one shard."""
        return range(data_rank, self.world, self.data_size)


def current_layout(dcn_slices: int = 1) -> Layout:
    if dist.is_available() and dist.is_initialized():
        return Layout(dist.get_rank(), dist.get_world_size(), dcn_slices)
    return Layout()


def process_index() -> int:
    return current_layout().rank


def process_count() -> int:
    return current_layout().world


def batch_shards() -> int:
    """Ways the global batch is split: one shard per rank (oatx's product of
    the batch axes, ('dcn', 'data'))."""
    return process_count()


def spans_processes() -> bool:
    """True when the default group holds more than one process: then each
    rank holds its rows of the global batch only."""
    return current_layout().spans_processes


def check_layout(t, world: int = None) -> None:
    """Raise for a TrainerCfg `t` whose layout the world (default: the
    current process group's) cannot run; accept what it runs as oatx does."""
    world = process_count() if world is None else world
    if (t.dp_mode or "auto") not in ("auto", "gspmd", "manual"):
        raise ValueError(f"unknown trainer.dp_mode {t.dp_mode!r}")
    if t.dcn_slices < 1:
        raise ValueError(f"dcn_slices must be >= 1, got {t.dcn_slices}")
    if t.pipeline and t.fsdp:
        raise ValueError("trainer.pipeline and trainer.fsdp both use structured "
                         "placements — enable one")
    for name, on, item in (
            ("model_parallel > 1", t.model_parallel > 1, "A8b, tensor parallelism"),
            ("pipeline", t.pipeline, "A8b, pipeline stages")):
        if on:
            raise NotImplementedError(
                f"trainer.{name} needs several devices on a model axis; the port "
                f"shards over the data axis only (not ported yet: ROADMAP {item})")
    if world % (t.model_parallel * t.dcn_slices):
        raise ValueError(f"{world} processes not divisible by model_parallel="
                         f"{t.model_parallel} x dcn_slices={t.dcn_slices}")
    if t.dp_mode == "manual" and (world == 1 or t.fsdp):
        raise ValueError("trainer.dp_mode='manual' needs a >1-shard batch axis and "
                         "replicated params (model_parallel=1, no fsdp/pipeline)")
