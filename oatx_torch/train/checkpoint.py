"""Checkpoint save/restore and reference-checkpoint import (port of
oatx/train/checkpoint.py:50-208; the reference's base_trainer.py:163-244).

Layout, as oatx's: ckpt_dir/<name>/ is one snapshot (`checkpoint-epoch{N}`,
`model_best`, `preempt-epoch{N}`) and ckpt_dir/<name>.meta.json its metadata
{epoch, monitor_best, step[, cycles_done]}. The snapshot is the port's own
format: `state.pt`, a torch.save of {'model': the model's state_dict,
'optimizer': AdamW.named_state() (count, mu, nu and the EMA when kept),
'step'}. oatx's Orbax snapshots do not restore here.

A snapshot is written into a temporary directory and renamed into place, so
a crash mid-write leaves no readable half-snapshot. `async_save=True` copies
every tensor to host memory before it returns (AdamW updates the parameters
in place, so the next step must not start before the copy is done) and
writes the file in a background thread; `wait_for_async_saves` joins it.

Under data parallelism (parallel/mesh.py) the ranks hold the same state:
rank 0 writes, and every rank waits at a barrier until it has (an async
write is then in flight on rank 0). Every rank restores the same file.
Under a sharded layout (parallel/sharding.py) the schema is the same: every
rank takes part in gathering each tensor whole, one tensor at a time, and
rank 0 copies it to its host, so the whole state is never on one device; a
restore reads the file on the host and each rank keeps its shares. A
model-axis split (tensor parallelism) is gathered and split the same way,
over the model group too. So a snapshot of any layout restores under any
other: a tensor-parallel snapshot in one process and the reverse.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel import sharding
from oatx_torch.parallel.mesh import process_index

STATE_FILE = "state.pt"
_SNAP = re.compile(r"checkpoint-epoch(\d+)")
_writer: Optional[threading.Thread] = None
_writer_error: list = []


def _host_copy(tree):
    """Every tensor of a nested dict copied to CPU memory (a snapshot that
    later in-place updates cannot reach)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write(path: Path, payload: Dict[str, Any]) -> None:
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)


def wait_for_async_saves() -> None:
    """Block until the in-flight async write has committed; re-raise its
    error if it failed."""
    global _writer
    if _writer is not None:
        _writer.join()
        _writer = None
    if _writer_error:
        raise _writer_error.pop()


def _sharded(state) -> bool:
    return (sharding.sharded(state.model)
            or any(spec is not None for spec in state.optimizer.zero1))


def _payload(state, lead: bool) -> Optional[Dict[str, Any]]:
    """The snapshot's tensors, whole, on the `lead` rank's host (→ None
    elsewhere). Shares and model-axis parts are gathered one tensor at a
    time, every rank taking part; a rank keeps none of them on its device
    past its host copy (lead) or past the gather (the others)."""
    if sharding.sharded(state.model):
        model = sharding.full_state_dict(state.model, to_host=lead, keep=lead)
    else:
        model = _host_copy(state.model.state_dict()) if lead else None
    opt = state.optimizer.named_state(to_host=lead, keep=lead)
    return {"model": model, "optimizer": opt, "step": int(state.step)} if lead else None


def save_checkpoint(ckpt_dir: str | Path, name: str, state, epoch: int,
                    monitor_best: float, keep: Optional[int] = None,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    async_save: bool = False) -> Path:
    """Save `state` (train/step.py TrainState) under ckpt_dir/name.
    extra_meta: e.g. {'cycles_done': N} for a mid-epoch preemption snapshot.
    keep: leave only the newest `keep` checkpoint-epoch{N} snapshots."""
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / name
    lead = process_index() == 0
    # a sharded state is gathered by every rank; a replicated one is rank 0's
    payload = _payload(state, lead) if lead or _sharded(state) else None
    if lead:
        _save(ckpt_dir, path, payload, epoch, monitor_best, keep, extra_meta, async_save)
    coll.barrier()
    return path


def _save(ckpt_dir: Path, path: Path, payload, epoch, monitor_best, keep, extra_meta,
          async_save) -> None:
    global _writer
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = path.name
    wait_for_async_saves()  # one write in flight; back-to-back saves stay ordered
    if async_save:
        def run():
            try:
                _write(path, payload)
            except BaseException as e:
                _writer_error.append(e)

        _writer = threading.Thread(target=run, name="oatx_torch-checkpoint")
        _writer.start()
    else:
        _write(path, payload)
    meta = {"epoch": int(epoch), "monitor_best": float(monitor_best),
            "step": payload["step"]}
    if extra_meta:
        meta.update(extra_meta)
    (ckpt_dir / f"{name}.meta.json").write_text(json.dumps(meta))
    if keep is not None:
        _gc_old(ckpt_dir, keep, pending=name)


def _gc_old(ckpt_dir: Path, keep: int, pending: Optional[str] = None) -> None:
    """Delete all but the newest `keep` checkpoint-epoch{N} snapshots (an
    in-flight `pending` one counts and is never deleted), and sidecars whose
    snapshot is gone."""
    snaps, seen = [], set()
    for p in ckpt_dir.iterdir():
        m = _SNAP.fullmatch(p.name)
        if m:
            snaps.append((int(m.group(1)), p))
            seen.add(p.name)
    if pending is not None and pending not in seen:
        m = _SNAP.fullmatch(pending)
        if m:
            snaps.append((int(m.group(1)), None))
            seen.add(pending)
    for _, p in sorted(snaps)[:-keep]:
        if p is None:
            continue
        shutil.rmtree(p, ignore_errors=True)
        p.with_name(p.name + ".meta.json").unlink(missing_ok=True)
    for p in ckpt_dir.glob("checkpoint-epoch*.meta.json"):
        snap = p.name[: -len(".meta.json")]
        if snap not in seen and not (ckpt_dir / snap).exists():
            p.unlink(missing_ok=True)


def _load(path: Path, device: torch.device) -> Dict[str, Any]:
    wait_for_async_saves()  # a same-process snapshot may still be committing
    return torch.load(path / STATE_FILE, map_location=device, weights_only=True)


def restore_checkpoint(path: str | Path, state, device: DeviceLike = None):
    """Load a snapshot into `state`'s model and optimizer in place →
    (state with the saved step, meta). The tensors are read onto `device`
    (CUDA unless the caller names another), or under a sharded layout onto
    the host, each rank keeping its shares."""
    path = Path(path).resolve()
    sharded = _sharded(state)
    snap = _load(path, torch.device("cpu") if sharded else resolve_device(device))
    if sharding.sharded(state.model):
        sharding.load_full_state_dict(state.model, snap["model"])
    else:
        state.model.load_state_dict(snap["model"], strict=True)
    state.optimizer.load_named_state(snap["optimizer"])
    meta: Dict[str, Any] = {"epoch": 0, "monitor_best": float("inf"), "step": 0}
    meta_path = path.with_name(path.name + ".meta.json")
    meta["has_meta"] = meta_path.exists()
    if meta["has_meta"]:
        meta.update(json.loads(meta_path.read_text()))
    return state._replace(step=int(snap["step"])), meta


def import_initial_weights(load_checkpoint: str, model, temporal_fix: str = "zeros",
                           prefer_ema: bool = False) -> None:
    """The reference's `load_checkpoint` (model.py:74-79) into `model` in
    place: a torch .pth / .pth.tar / .pt is loaded with its positional
    embeddings inflated to the model's frame and patch counts; a snapshot
    directory of this package gives its model weights (its EMA with
    prefer_ema, when it kept one); '' leaves the model as it is."""
    from oatx_torch.models import convert

    if not load_checkpoint:
        return
    p = Path(load_checkpoint)
    if not p.exists():
        raise FileNotFoundError(f"load_checkpoint not found: {load_checkpoint}")
    if p.is_file():
        convert.load_checkpoint(model, str(p), temporal_fix)
        return
    snap = _load(p.resolve(), model.device)
    sd = snap["model"]
    if prefer_ema:
        ema = snap["optimizer"].get("ema")
        if ema is not None:
            sd = {**sd, **ema}
        else:
            import logging

            logging.getLogger("oatx_torch.checkpoint").warning(
                "--ema requested but %s carries no EMA state (trained without "
                "trainer.ema_decay?): using the raw parameters", p)
    model.load_state_dict(convert.inflate_state_dict(sd, model.cfg.video, temporal_fix),
                          strict=True)
