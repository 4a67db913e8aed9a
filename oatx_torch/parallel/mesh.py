"""The process layout and the checks of a trainer config against it (port of
oatx/parallel/mesh.py: `process_index`, `process_count`, `batch_shards`,
`spans_processes` and `make_mesh`'s validation, :64-73, 90-121).

oatx trains one program over a (data, model) mesh, or ('dcn', 'data',
'model') across slices, and shards by GSPMD. The port runs one process per
device under `torch.distributed` (the reference's own mode): rank r of a
world of n owns a per-process batch, as oatx's per-process batch
(`batch_size` is per process, oatx/train/trainer.py:105-118), and every rank
holds all the parameters. Without a process group, or with a world of one,
this is oatx's 1-device mesh. The ranks form one flat data axis: the batch
shards over ('dcn', 'data') jointly, and with replicated parameters that is
plain data parallelism (train/step.py gathers the loss inputs and reduces
the gradients, parallel/collectives.py).

What each trainer key gives:
  * `dp_mode`: 'auto' and 'manual' reduce the gradients once per parameter
    after the backward, as oatx's `_manual_dp_grads`; 'gspmd' reduces the
    same gradients but ignores `grad_reduce_dtype` (trainer.py); 'manual'
    with one shard raises ValueError, as in oatx (trainer.py:306-309);
  * `dcn_slices` must divide the world (ValueError, as in make_mesh);
  * on one process `fsdp` and `zero1` shard over a 1-wide data axis, that
    is, replicate (oatx/train/trainer.py:186-187), and the model's
    `sequence_parallel` is a no-op (models/vit_spacetime.py); across
    processes `fsdp`, `zero1`, `model_parallel` > 1 and `pipeline` raise
    NotImplementedError (ROADMAP A8b);
  * `model_parallel` > 1 and `pipeline` need a model axis that one device
    lacks and raise NotImplementedError there too (A8b).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank and world size of the default process group (0 and 1 without
    one)."""
    rank: int = 0
    world: int = 1

    @property
    def spans_processes(self) -> bool:
        return self.world > 1


def current_layout() -> Layout:
    if dist.is_available() and dist.is_initialized():
        return Layout(dist.get_rank(), dist.get_world_size())
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
    for name, on, item in (
            ("model_parallel > 1", t.model_parallel > 1, "A8b, tensor parallelism"),
            ("pipeline", t.pipeline, "A8b, pipeline stages")):
        if on:
            raise NotImplementedError(
                f"trainer.{name} needs several devices on a model axis; the port "
                f"trains data-parallel only (not ported yet: ROADMAP {item})")
    if world % (t.model_parallel * t.dcn_slices):
        raise ValueError(f"{world} processes not divisible by model_parallel="
                         f"{t.model_parallel} x dcn_slices={t.dcn_slices}")
    if world > 1:
        for name, on in (("fsdp", t.fsdp), ("zero1", t.zero1)):
            if on:
                raise NotImplementedError(
                    f"trainer.{name} across {world} processes is not ported yet "
                    f"(ROADMAP A8b, sharded parameters and moments)")
    elif t.dp_mode == "manual":
        raise ValueError("trainer.dp_mode='manual' needs a >1-shard batch axis and "
                         "replicated params (model_parallel=1, no fsdp/pipeline)")
