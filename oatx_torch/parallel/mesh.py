"""The device layout a trainer config asks for, checked on one device
(port of oatx/parallel/mesh.py `make_mesh`'s validation, :64-73).

oatx trains one program over a (data, model) mesh, or ('dcn', 'data',
'model') across slices, and shards by GSPMD. The port trains on one device,
which is oatx's mesh with one device: a data axis of width 1 and no model
axis. There
  * `fsdp` shards parameters and moments over a 1-wide data axis, that is,
    replicates them (oatx/train/trainer.py:186-187): nothing to do;
  * `zero1` shards the moments the same way: nothing to do;
  * `dp_mode: auto` / `gspmd` reduce over one replica: nothing to do;
  * the model's `sequence_parallel` constrains activations over the model
    axis, which one device lacks (oatx/models/vit_spacetime.py:270-282):
    a no-op (models/vit_spacetime.py).
What one device cannot give is refused, as oatx's make_mesh refuses
`model_parallel` that does not divide the devices (4 on one device raises
there too): `model_parallel` > 1 and `pipeline` (tensor and pipeline
parallelism, ROADMAP A8b), `dcn_slices` > 1 and `dp_mode: manual`
(data-parallel replicas, A8a).
"""

from __future__ import annotations


def check_layout(t) -> None:
    """Raise for a TrainerCfg `t` whose layout needs more than one device;
    accept the keys that one device runs as oatx does (replicated)."""
    if (t.dp_mode or "auto") not in ("auto", "gspmd", "manual"):
        raise ValueError(f"unknown trainer.dp_mode {t.dp_mode!r}")
    if t.dcn_slices < 1:
        raise ValueError(f"dcn_slices must be >= 1, got {t.dcn_slices}")
    for name, on, item in (
            ("model_parallel > 1", t.model_parallel > 1, "A8b, tensor parallelism"),
            ("pipeline", t.pipeline, "A8b, pipeline stages"),
            ("dcn_slices > 1", t.dcn_slices > 1, "A8a, data parallelism across slices"),
            ("dp_mode 'manual'", t.dp_mode == "manual", "A8a, data-parallel replicas")):
        if on:
            raise NotImplementedError(
                f"trainer.{name} needs several devices; the port trains on "
                f"one (not ported yet: ROADMAP {item})")
