"""Epoch engine (port of oatx/train/trainer.py:45-704; the reference's
Multi_BaseTrainer_dist + Multi_Trainer_dist, base_trainer.py:7-244,
trainer_dist.py:57-291).

Per epoch, as oatx's: alternating multi-loader batches (`MultiLoader`), the
epoch cut at `max_samples_per_epoch` or fixed at `len_epoch` cycles, the LR
schedule over the optimizer's step count, `init_val`, validation every
`val_period` epochs (and at the last), a monitored best with early stop, and
`checkpoint-epoch{N}` / `model_best` snapshots (train/checkpoint.py).
Beyond the reference, as oatx: SIGTERM / SIGUSR1 request a snapshot at the
next step boundary, which a resume continues mid-epoch (the loaders skip the
completed cycles by index arithmetic); a step watchdog; an EMA of the
parameters validated in their place; a torch.profiler window
(`profile_epoch`, `profile_start_step`, `profile_steps`).

The model's variant comes from `arch.variant` (baseline, global_local or
region_mem; oatx :638-690 validates each the same way): its batches carry
the object extras (data/datasets/base.py), and global_local's collator needs
`tag_token_lens` (data/factory.tag_token_lens_for). With an object tower
(`arch.stream: 3`) it trains only under the baseline variant with
`loss.args.object_nce_weight` > 0 and a train loader whose dataset serves
object features; otherwise the optimizer leaves `object_tower` / `obj_proj`
untouched (no update, no weight decay). Validation embeds every
sample in chunks of 8 (`make_eval_step`), then takes the t2v / v2t metrics
and NormSoftmax between the eval step's `text_embeds` and `video_embeds`
over the full corpus similarity matrix.

Processes (parallel/mesh.py): the Trainer runs under whatever default
process group the caller set up (cli/train.py under OATX_MULTIHOST=1), one
rank per device, each over its shard of the loaders with a per-process
`batch_size`, as oatx's per-process batch. Across ranks the step is data
parallel (train/step.py: global negatives); rank 0's parameters are
broadcast at the start, before the state is placed; `grad_reduce_dtype`
applies under `dp_mode` auto or manual with replicated parameters and is
warned about and ignored otherwise, as oatx's gating (:296-318);
validation embeds each rank's shard and gathers every rank's rows in rank
order on every rank (oatx `_gather_valid`); the console, TensorBoard
writer, tracker, checkpoints and profiler belong to rank 0, and each rank
logs to info_p{rank}.log; a preemption signal stops every rank at the same
step (collectives.any_rank).

The state is placed as oatx places it (:186-236), after the init and again
by a resume (parallel/sharding.py): `fsdp` shards the parameters, their
gradients and moments over the data axis of a dcn slice, else `zero1`
shards the moments and the EMA; the layout of a fresh run and of a resumed
one is the same, and a snapshot of any layout restores under any other.
Under `fsdp` across ranks `fwd_chunk` and `grad_reduce_dtype` are warned
about and ignored, as in oatx (:279-292, 301-318), and the validation
forwards run in step on every rank (each weight is gathered at its use).
Without a group, or with one rank, this is oatx on a 1-device mesh: `fsdp`,
`zero1` and `dp_mode: auto` shard or reduce over a 1-wide data axis and are
no-ops, and so is `pipeline` (a model axis of 1 is one stage, oatx's
pipeline_stages = model_parallel = 1); `dp_mode: manual` with one batch
shard, with `fsdp`, `pipeline` or under a model axis, `pipeline` with
`fsdp` or the video tower's `sequence_parallel`, and `model_parallel` ×
`dcn_slices` that do not divide the ranks raise ValueError, as in oatx.

With `model_parallel` mp > 1 (parallel/mesh.py) the mp ranks of a data
position form a model group: the towers are split over it after the init
(and the broadcast of rank 0's whole values), and again by a resume, which
splits the whole tensors of any snapshot (parallel/sharding.py; `fsdp` and
`zero1` then shard each rank's part over the data axis). A model group
reads one shard of the loaders (cli/train.py: shards by data position),
so the global batch is batch_size × world / mp. Validation gathers over
the ranks at one model rank; `fwd_chunk` is warned about and ignored when
the batch is also split across positions, and `grad_reduce_dtype` always,
as oatx gates them (:279-318). A rank does 1/mp of a step's FLOPs
(train/flops.py).

With `pipeline` and a model axis of P > 1 the axis holds GPipe stages
instead (oatx :73-90): the tower config gets pipeline_stages = P and the
trainer's `pipeline_microbatches`; after the init (and the broadcast of
rank 0's whole values), and again by a resume, a rank keeps its stage's
video blocks and every other parameter whole (parallel/sharding.py
`place_pipeline`; `zero1` then shards the moments of what it holds over
its stage's data axis). Each train loader's global batch must be a
multiple of pipeline_microbatches × the batch shards (oatx :119-125), and
`fwd_chunk` is warned about and ignored (oatx :285-289). Validation runs
the same pipelined forward without a grad; its embeddings are oatx's
sequential ones (:333-342), the rows being independent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.config.registry import METRICS
from oatx_torch.config.schema import ExperimentCfg, build_tower_config, precision_dtype
from oatx_torch.data.loader import MultiLoader, ShardedLoader, device_prefetch, padded_batches
from oatx_torch.data.transforms import TransformConfig
from oatx_torch.losses import contrastive as C
from oatx_torch.metrics.retrieval import REQUIRES_QUERY_MASKS
from oatx_torch.models.towers import DualTower, text_out_dim
from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel import mesh as meshlib
from oatx_torch.parallel import sharding
from oatx_torch.train import checkpoint as ckptlib
from oatx_torch.train import optim as optimlib
from oatx_torch.train import step as steplib
from oatx_torch.utils import profiler as proflib
from oatx_torch.utils.logging import setup_logging
from oatx_torch.utils.tb import TensorboardWriter
from oatx_torch.utils.watchdog import StepWatchdog


def verbose(epoch: int, metrics: Dict[str, float], name: str, mode: str = "t2v") -> str:
    """The reference's metric line (trainer_dist.py:495-500)."""
    return (f"[{mode}] epoch {epoch}, {name}: "
            f"R@1 {metrics['R1']:.1f} R@5 {metrics['R5']:.1f} "
            f"R@10 {metrics['R10']:.1f} R@50 {metrics['R50']:.1f} "
            f"MedR {metrics['MedR']:g} MeanR {metrics['MeanR']:.1f}")


class Trainer:
    def __init__(self, exp: ExperimentCfg, train_loaders: List[ShardedLoader],
                 valid_loaders: Optional[List[ShardedLoader]] = None,
                 save_dir: Optional[str | Path] = None,
                 log_dir: Optional[str | Path] = None, linear_eval: bool = False,
                 resume: Optional[str] = None, tracker=None, device: DeviceLike = None):
        self.exp = exp
        t = exp.trainer
        self.tower_cfg = build_tower_config(exp.arch, compute_dtype=precision_dtype(t.precision))
        meshlib.check_layout(t, sequence_parallel=self.tower_cfg.video.sequence_parallel)
        if t.pipeline:  # the model axis becomes GPipe stages (oatx :73-90)
            self.tower_cfg = dataclasses.replace(self.tower_cfg, video=dataclasses.replace(
                self.tower_cfg.video, pipeline_stages=t.model_parallel,
                pipeline_microbatches=t.pipeline_microbatches))
        self.layout = layout = meshlib.current_layout(t.dcn_slices, t.model_parallel,
                                                      t.pipeline)
        lead = layout.rank == 0
        self.device = dev = resolve_device(device)
        self.logger = setup_logging(log_dir, "oatx_torch.trainer", t.verbosity, layout.rank)
        self.writer = TensorboardWriter(log_dir if lead else None)
        self.profile_dir = Path(log_dir or save_dir or ".") / "profile"
        self._profiler = None
        self._profile_done = not lead
        self._profile_stop = 0
        self.tracker = tracker if lead else None
        self.save_dir = Path(save_dir) if save_dir else None
        self.train_loaders = train_loaders
        self.valid_loaders = valid_loaders or []

        self.loss_cfg = steplib.LossConfig(
            name=exp.loss.type, temperature=exp.loss.temperature,
            margin=exp.loss.margin, region_bce_weight=exp.loss.region_bce_weight,
            chunked=exp.loss.chunked, chunk_size=exp.loss.chunk_size,
            object_nce_weight=exp.loss.object_nce_weight)

        if layout.pipeline:  # oatx :119-125
            m = t.pipeline_microbatches
            for l in train_loaders:
                gb = l.batch_size * layout.batch_shards
                if gb % m or (gb // m) % layout.batch_shards:
                    raise ValueError(
                        f"pipeline mode: data_loader '{l.dataset_name}' global batch {gb} "
                        f"must be a multiple of pipeline_microbatches ({m}) x batch shards "
                        f"({layout.batch_shards})")

        # steps per epoch for the LR schedule (oatx :127-140)
        cycle_batches = sum(l.batch_size for l in train_loaders) or 1
        steps_per_cycle = len(train_loaders) or 1
        if t.len_epoch is not None and t.len_epoch <= 0:
            raise ValueError(f"trainer.len_epoch must be positive, got {t.len_epoch}")
        if t.len_epoch:  # iteration-based: fixed cycles, loaders cycle endlessly
            n_cycles = t.len_epoch
        else:
            agg = max if t.cycle_shorter else min
            n_cycles = agg(len(l) for l in train_loaders) if train_loaders else 0
            if t.max_samples_per_epoch:
                n_cycles = min(n_cycles, t.max_samples_per_epoch // cycle_batches)
        self.cycles_per_epoch = max(1, n_cycles)
        steps_per_epoch = self.cycles_per_epoch * steps_per_cycle

        self.lr_schedule = optimlib.make_schedule(
            exp.optimizer.lr, steps_per_epoch, t.epochs, kind=exp.optimizer.schedule,
            milestones=exp.optimizer.milestones, gamma=exp.optimizer.gamma,
            warmup_steps=exp.optimizer.warmup_steps, lr_min=exp.optimizer.lr_min)
        tf = optimlib.linear_probe_filter if linear_eval else None
        if self.tower_cfg.object_tower is not None:
            # the object NCE terms fire only on batches that carry object
            # features (step.loss_fn checks 'object'): the object tower
            # trains only when the loss asks for it and a train loader
            # supplies them, and is frozen otherwise, or the weight decay
            # would erode its untrained weights (oatx :150-168)
            object_in_data = any(
                getattr(getattr(l, "dataset", None), "opts", None) is not None
                and l.dataset.opts.features for l in train_loaders)
            trains_object = (self.tower_cfg.variant == "baseline"
                             and self.loss_cfg.object_nce_weight > 0 and object_in_data)
            if self.loss_cfg.object_nce_weight > 0 and not object_in_data:
                self.logger.warning(
                    "loss.object_nce_weight > 0 but no train loader supplies object "
                    "features (object_params.input_objects) — the object tower stays FROZEN")
            if not trains_object:
                tf = optimlib.exclude_subtrees(tf, ("object_tower", "obj_proj"))
        self.optimizer = optimlib.make_optimizer(
            lr=self.lr_schedule, weight_decay=exp.optimizer.weight_decay,
            grad_clip=exp.optimizer.grad_clip, trainable_filter=tf,
            ema_decay=t.ema_decay or None, kind=exp.optimizer.type)

        # fresh init → optional reference-checkpoint import → rank 0's values
        # everywhere → split over the model axis and placed (fsdp, else
        # zero1; oatx :186-197) → the optimizer over it
        model = DualTower(self.tower_cfg, dev, torch.Generator(dev).manual_seed(t.seed))
        if exp.arch.load_checkpoint:
            self.logger.info("importing initial weights from %s", exp.arch.load_checkpoint)
            ckptlib.import_initial_weights(exp.arch.load_checkpoint, model,
                                           temporal_fix=exp.arch.load_temporal_fix)
        if layout.spans_processes:
            coll.broadcast_tensors(model.state_dict().values())
        self.shard_mode = "fsdp" if t.fsdp else "zero1" if t.zero1 else None
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        shards = sharding.place(model, self.shard_mode, layout)
        self.state = steplib.TrainState(
            model, self.optimizer(model.named_parameters(),
                                  zero1=shards if self.shard_mode == "zero1" else None), 0)
        if layout.pipeline:
            mine = layout.stage_blocks(self.tower_cfg.video.depth)
            self.logger.info(
                "pipeline stages over a model axis of %d (stage %d of position %d): video "
                "blocks [%d, %d) of %d, %d micro-batches; global batch = batch_size x %d "
                "positions", layout.model_parallel, layout.stage, layout.position, mine.start,
                mine.stop, self.tower_cfg.video.depth, t.pipeline_microbatches,
                layout.batch_shards)
        elif layout.model_parallel > 1:
            split = sum(getattr(p, "_oatx_tp", None) is not None for p in model.parameters())
            self.logger.info(
                "tensor parallel over a model axis of %d (rank %d of position %d, "
                "sequence_parallel %s): %d of %d parameters split; global batch = "
                "batch_size x %d positions", layout.model_parallel, layout.model_rank,
                layout.position, self.tower_cfg.video.sequence_parallel, split, len(shapes),
                layout.batch_shards)
        if (self.shard_mode and layout.spans_processes) or layout.model_parallel > 1:
            mode = self.shard_mode if layout.spans_processes else None
            want = sharding.state_bytes(shapes, layout.data_size, mode, ema=bool(t.ema_decay),
                                        model_parallel=layout.model_parallel,
                                        pipeline=layout.pipeline, kind=exp.optimizer.type)
            self.logger.info(
                "%s over a data axis of %d (x %d dcn slices, x %d model ranks): %d of %d "
                "parameters sharded, %.3f GB of state a rank (replicated: %.3f GB, "
                "padding %d B)", mode or "replicated", layout.data_size, layout.dcn_slices,
                layout.model_parallel, len(shards), len(shapes), want["bytes"] / 1e9,
                want["replicated"] / 1e9, want["padding"])

        self.start_epoch = 1
        self._resume_cycle = 0
        self.monitor_mode, self.monitor_metric = self._parse_monitor(t.monitor)
        self.monitor_best = np.inf if self.monitor_mode == "min" else -np.inf
        if resume:
            self.state, meta = ckptlib.restore_checkpoint(resume, self.state, dev)
            if meta.get("cycles_done") is not None and \
                    int(meta["cycles_done"]) < self.cycles_per_epoch:
                # a mid-epoch preemption snapshot: continue inside that epoch
                self.start_epoch = meta["epoch"]
                self._resume_cycle = int(meta["cycles_done"])
                self.logger.info("resumed mid-epoch from %s (epoch %d, cycle %d)",
                                 resume, meta["epoch"], self._resume_cycle)
            else:
                self.start_epoch = meta["epoch"] + 1
                self.logger.info("resumed from %s at epoch %d", resume, meta["epoch"])
            if meta["has_meta"] and "monitor_best" in meta:
                mb = meta["monitor_best"]
                # a lost sidecar reads +inf, which would disable max-mode monitoring
                if not (self.monitor_mode == "max" and mb == float("inf")):
                    self.monitor_best = mb

        precropped = [getattr(l.dataset, "train_crop", "device_canonical")
                      == "reference_full_frame" for l in train_loaders]
        if any(precropped) and not all(precropped):
            raise ValueError("train_crop='reference_full_frame' must be set on ALL "
                             "train loaders (the device augmenter is shared)")
        self.augment = steplib.make_augmenter(
            transform_cfg=TransformConfig(input_res=self.tower_cfg.video.img_size,
                                          host_precropped=any(precropped)),
            train=True, tower_cfg=self.tower_cfg, layout=layout)
        fwd_chunk = t.fwd_chunk or None
        fsdp_across = t.fsdp and layout.spans_processes
        split_across = layout.model_parallel > 1 and layout.batch_shards > 1
        if fwd_chunk and (fsdp_across or split_across or layout.pipeline):
            self.logger.warning("fwd_chunk=%d ignored: shard_map fwd_chunk needs replicated "
                                "params (model_parallel=1, no fsdp/pipeline)", fwd_chunk)
            fwd_chunk = None
        if fwd_chunk and t.accum_steps > 1:
            raise ValueError("fwd_chunk and accum_steps are mutually exclusive "
                             "(full-batch vs micro-batch negative semantics)")
        # data parallelism: one reduction per gradient after the backward
        # (step.py); grad_reduce_dtype on the manual path only (oatx :296-318)
        dp_mode = t.dp_mode or "auto"
        pure_dp = (layout.batch_shards > 1 and not t.fsdp and layout.model_parallel == 1
                   and not t.pipeline)
        manual = pure_dp and dp_mode != "gspmd"
        grd = t.grad_reduce_dtype or ""
        if grd and not manual:
            self.logger.warning("trainer.grad_reduce_dtype=%r ignored: needs the manual "
                                "dp_mode path (got dp_mode=%s, pure_dp=%s)", grd, dp_mode,
                                pure_dp)
            grd = ""
        if pure_dp:
            self.logger.info("data-parallel gradients: one mean over %d ranks%s",
                             layout.world, f" in {grd}" if grd else "")
        elif layout.batch_shards > 1 and not t.fsdp:
            self.logger.info("data-parallel gradients: one mean over the %d ranks of each "
                             "model rank", layout.batch_shards)
        self.train_step = steplib.make_train_step(
            self.tower_cfg, self.loss_cfg, augment=self.augment, base_seed=t.seed + 1,
            accum_steps=t.accum_steps, skip_nonfinite=t.skip_nonfinite,
            fwd_chunk=fwd_chunk,
            grad_reduce_dtype={"": None, "bf16": torch.bfloat16, "f32": torch.float32}[grd],
            device=dev)
        vb = max((l.batch_size for l in self.valid_loaders), default=1)
        self.eval_step = steplib.make_eval_step(
            self.tower_cfg, chunk=8 if vb <= 8 or vb % 8 == 0 else None, device=dev)
        self.not_improved = 0
        self.init_val_log: Dict[str, float] = {}

        # preemption: SIGTERM / SIGUSR1 request a snapshot at the next step
        self._preempted = False
        self._preempt_saved = False
        self._install_preemption_handler()
        self.watchdog = StepWatchdog(timeout_s=900.0, logger=self.logger)

    def _stop_requested(self) -> bool:
        """The preemption flag, agreed over the ranks: all stop at one step."""
        return coll.any_rank(self._preempted)

    def _install_preemption_handler(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        ref = weakref.ref(self)  # the handler outlives the run; the Trainer need not

        def handler(signum, frame):
            trainer = ref()
            if trainer is not None:
                trainer._preempted = True

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    @staticmethod
    def _parse_monitor(monitor: str):
        if monitor in ("off", ""):
            return "off", ""
        mode, metric = monitor.split(" ", 1)
        if mode not in ("min", "max"):
            raise ValueError(f"monitor mode {mode!r}")
        return mode, metric

    def _snapshot(self, epoch: int, cycles_done: int) -> None:
        if self.save_dir:
            ckptlib.save_checkpoint(self.save_dir, f"preempt-epoch{epoch}", self.state,
                                    epoch, self.monitor_best,
                                    extra_meta={"cycles_done": cycles_done})
            self._preempt_saved = True

    # ------------------------------------------------------------------ train

    def train(self) -> Dict[int, Dict[str, Any]]:
        t = self.exp.trainer
        history: Dict[int, Dict[str, Any]] = {}
        if t.init_val and self.valid_loaders:
            val_log = self.init_val_log = self._valid_epoch(self.start_epoch - 1)
            self.logger.info("init_val: %s", {k: round(v, 4) for k, v in val_log.items()
                                              if isinstance(v, float)})
        for epoch in range(self.start_epoch, t.epochs + 1):
            if self._stop_requested():
                # the signal landed outside the step loop (validation, a save)
                self._snapshot(epoch - 1, self.cycles_per_epoch)
                self.logger.warning("preemption signal between epochs: checkpoint "
                                    "saved, exiting")
                break
            log: Dict[str, Any] = {"epoch": epoch}
            start_cycle = self._resume_cycle if epoch == self.start_epoch else 0
            log.update(self._train_epoch(epoch, start_cycle))
            if self._stop_requested():
                if not self._preempt_saved:
                    # the flag raced the end of the epoch: snapshot it as complete
                    self._snapshot(epoch, self.cycles_per_epoch)
                self.logger.warning("stopping after preemption checkpoint (epoch %d)", epoch)
                break
            val_period = max(int(t.val_period), 1)
            if self.valid_loaders and (epoch % val_period == 0 or epoch == t.epochs):
                log.update(self._valid_epoch(epoch))
            history[epoch] = log
            for k, v in log.items():
                if isinstance(v, (int, float)):
                    self.logger.info("    %-24s: %s", k, v)
            if self.tracker is not None:
                self.tracker.log_metrics(epoch, {k: v for k, v in log.items()
                                                 if isinstance(v, (int, float))}, mode="epoch")
            best = False
            if self.monitor_mode != "off" and self.monitor_metric in log:
                value = log[self.monitor_metric]
                improved = (value <= self.monitor_best if self.monitor_mode == "min"
                            else value >= self.monitor_best)
                if improved:
                    self.monitor_best, best, self.not_improved = value, True, 0
                else:
                    self.not_improved += 1
                if self.not_improved > t.early_stop:
                    self.logger.info("early stop after %d stale epochs", self.not_improved)
                    break
            if self.save_dir and (epoch % t.save_period == 0 or best):
                self._save(epoch, best)
        ckptlib.wait_for_async_saves()
        self.watchdog.stop()
        return history

    def _train_epoch(self, epoch: int, start_cycle: int = 0) -> Dict[str, float]:
        """start_cycle > 0 resumes mid-epoch: the loaders skip the completed
        cycles by index arithmetic (MultiLoader.iter_from), so the remaining
        cycles see the batches of the uninterrupted run. The epoch's loss is
        the mean over every step, summed on the device and read once."""
        t = self.exp.trainer
        for l in self.train_loaders:
            l.set_epoch(epoch)
        multi = MultiLoader(self.train_loaders, cycle_shorter=t.cycle_shorter,
                            endless=bool(t.len_epoch))
        dev = self.device
        n_loaders = len(self.train_loaders)
        loss_sums = [torch.zeros((), device=dev) for _ in range(n_loaders)]
        valid_sums = [torch.zeros((), device=dev) for _ in range(n_loaders)]
        # the console/TB line fetches the loss, a sync: every sqrt(batch) steps
        # per loader (the reference's log_step, trainer_dist.py:87)
        log_step = max(1, int(np.sqrt(self.train_loaders[0].batch_size)))
        steps_per_loader = [0] * n_loaders
        t0 = time.time()
        cycles_done = start_cycle
        last_metrics = None
        self.watchdog.start()
        # time blocked on the input pipeline (decode + collate + copy not
        # hidden by the prefetch) against the epoch's wall time
        prefetch_iter = iter(device_prefetch(multi.iter_from(start_cycle), dev))
        data_wait = 0.0
        wall_start = time.perf_counter()
        try:
            while True:
                if last_metrics is not None and self._stop_requested():
                    float(last_metrics["loss"])
                    self._snapshot(epoch, cycles_done)
                    self.logger.warning("preemption signal: checkpoint saved at cycle %d, "
                                        "exiting epoch", cycles_done)
                    break
                w0 = time.perf_counter()
                try:
                    loader_idx, batch = next(prefetch_iter)
                except StopIteration:
                    break
                data_wait += time.perf_counter() - w0
                batch.pop("meta", None)
                self.state, metrics = self.train_step(self.state, batch)
                last_metrics = metrics
                loss_sums[loader_idx] += metrics["loss"]
                valid_sums[loader_idx] += 1.0 - metrics.get("skipped", 0.0)
                steps_per_loader[loader_idx] += 1
                self.watchdog.beat()
                self._profile_hook(epoch, sum(steps_per_loader), metrics)
                if loader_idx == n_loaders - 1:
                    cycles_done += 1
                if self._stop_requested():
                    float(metrics["loss"])
                    self._snapshot(epoch, cycles_done)
                    self.logger.warning("preemption signal: checkpoint saved at cycle %d, "
                                        "exiting epoch", cycles_done)
                    break
                if (steps_per_loader[loader_idx] - 1) % log_step == 0:
                    loss = float(metrics["loss"])
                    self.writer.set_step((epoch - 1) * self.cycles_per_epoch + cycles_done)
                    self.writer.add_scalar(f"loss_train_{loader_idx}", loss)
                    self.writer.add_scalar("lr", float(self.lr_schedule(
                        self.state.optimizer.param_groups[0]["count"])))
                    self.logger.info("Train Epoch: %d %d/%d Loss[%d]: %.6f (%.2fs)",
                                     epoch, cycles_done, self.cycles_per_epoch, loader_idx,
                                     loss, time.time() - t0)
                    t0 = time.time()
                if cycles_done >= self.cycles_per_epoch:
                    break
        finally:
            prefetch_iter.close()
        if self._profiler is not None:
            self._finish_profile()  # the epoch ended inside the capture window
        if last_metrics is not None:
            float(last_metrics["loss"])  # drain the device queue
        wall = time.perf_counter() - wall_start
        out: Dict[str, float] = {"epoch_time": wall}
        if wall > 0 and sum(steps_per_loader):
            out["input_wait"] = data_wait / wall
            self.writer.add_scalar("input_wait", out["input_wait"])
        for i, (s, v, n) in enumerate(zip(loss_sums, valid_sums, steps_per_loader)):
            nv = float(v) if n else 0.0
            out[f"loss_{i}"] = float(s) / nv if nv else float("nan")
            if n and nv < n:
                self.logger.warning("loader %d: %d/%d steps skipped (non-finite)",
                                    i, n - int(nv), n)
        return out

    # ------------------------------------------------------------- profiling

    def _profile_hook(self, epoch: int, total_steps: int, metrics) -> None:
        """A torch.profiler capture of steps [profile_start_step,
        + profile_steps) of `profile_epoch`, written to <log_dir>/profile."""
        t = self.exp.trainer
        if self._profile_done or not t.profile_epoch or epoch != t.profile_epoch:
            return
        if self._profiler is None and total_steps >= t.profile_start_step:
            float(metrics["loss"])  # fence: earlier steps stay out
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
            self._profile_stop = total_steps + t.profile_steps
        elif self._profiler is not None and total_steps >= self._profile_stop:
            self._finish_profile()

    def _finish_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        self._profile_done = True
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        path = self.profile_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        self.logger.info("profiler trace captured → %s", path)
        for row in proflib.summarize_trace(str(self.profile_dir), top=5):
            self.logger.info("  trace: %-48s %9.2f ms total", row["name"][:48], row["total_ms"])

    # ------------------------------------------------------------------ valid

    @contextlib.contextmanager
    def _ema_swapped(self):
        """The model holds the EMA parameters inside the context (each
        parameter as it is held: a share under fsdp)."""
        ema = self.state.optimizer.param_shaped("ema")
        params = dict(self.state.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])

    def _rows(self, parts: List[torch.Tensor], tower: str) -> torch.Tensor:
        """A rank's embedding rows of one tower; (0, dim) when its shard is
        empty."""
        if parts:
            return torch.cat(parts)
        cfg = self.tower_cfg
        dim = (cfg.projection_dim if cfg.projection == "minimal"
               else text_out_dim(cfg) if tower == "text" else cfg.video.embed_dim)
        return torch.zeros((0, dim), device=self.device)

    def _valid_epoch(self, epoch: int) -> Dict[str, float]:
        t = self.exp.trainer
        if t.ema_decay and t.ema_eval:
            with self._ema_swapped():  # validate and monitor the EMA model
                return self._validate(epoch)
        return self._validate(epoch)

    def _validate(self, epoch: int) -> Dict[str, float]:
        log: Dict[str, float] = {}
        model = self.state.model
        multiple = max((l.batch_size for l in self.valid_loaders), default=1)
        multiple = max(multiple, self.layout.batch_shards)  # oatx :648-649
        in_step = sharding.fsdp_of(model) is not None
        for vi, loader in enumerate(self.valid_loaders):
            texts, vids = [], []
            # under fsdp every forward gathers the weights: the ranks run as
            # many as the longest shard, the short ones again on their last batch
            n_fwd = coll.max_across_ranks(len(loader)) if in_step else 0
            batch = None
            for batch, n_valid in device_prefetch(padded_batches(iter(loader), multiple),
                                                  self.device):
                batch.pop("meta", None)
                out = self.eval_step(model, batch)
                texts.append(out["text_embeds"][:n_valid].float())
                vids.append(out["video_embeds"][:n_valid].float())
                n_fwd -= 1
                self.watchdog.beat()  # a long validation is not a hang
            if n_fwd > 0 and batch is None:
                raise ValueError(f"fsdp validation: loader {loader.dataset_name!r} has no "
                                 f"batch on rank {self.layout.rank} to run in step with "
                                 "the others (fewer samples than ranks)")
            for _ in range(max(n_fwd, 0)):
                self.eval_step(model, batch)
            if self.layout.batch_shards > 1:
                # every position's valid rows, one after another (oatx
                # _gather_valid), over the ranks at this model rank
                group = coll.batch_group(self.layout)
                texts = [coll.all_gather_ragged(self._rows(texts, "text"), group)]
                vids = [coll.all_gather_ragged(self._rows(vids, "video"), group)]
                if not len(texts[0]):
                    texts = []
            if not texts:
                continue
            sims_t = C.sim_matrix(torch.cat(texts), torch.cat(vids))
            val_loss = float(C.norm_softmax_loss(sims_t, self.loss_cfg.temperature))
            sims = sims_t.cpu().numpy()
            log[f"val_loss_{vi}"] = val_loss
            if vi == 0:
                log["val_loss"] = val_loss
            self.writer.set_step(epoch, mode="valid")
            for metric_name in self.exp.metrics:
                if metric_name in REQUIRES_QUERY_MASKS:
                    self.logger.warning("metric %s needs query_masks (label matrix): "
                                        "skipped during validation", metric_name)
                    continue
                res = METRICS.get(metric_name)(sims)
                short = {"t2v_metrics": "t2v", "v2t_metrics": "v2t"}.get(metric_name,
                                                                        metric_name)
                if "R1" in res:
                    self.logger.info(verbose(epoch, res, loader.dataset_name, short))
                else:
                    self.logger.info("[%s] epoch %d, %s: %s", short, epoch,
                                     loader.dataset_name,
                                     {k: round(float(v), 3) for k, v in res.items()})
                for k, v in res.items():
                    log[f"val_{vi}_{short}_{k}"] = float(v)
                    self.writer.add_scalar(f"val_{vi}_{short}_{k}", float(v), epoch)
            self.writer.set_step(epoch, mode="train")
        return log

    # ------------------------------------------------------------------ save

    def _save(self, epoch: int, best: bool) -> None:
        async_save = bool(self.exp.trainer.async_checkpoint)
        path = ckptlib.save_checkpoint(self.save_dir, f"checkpoint-epoch{epoch}", self.state,
                                       epoch, self.monitor_best, keep=3,
                                       async_save=async_save)
        self.logger.info("saved %s%s", path, " (async)" if async_save else "")
        if best:
            ckptlib.save_checkpoint(self.save_dir, "model_best", self.state, epoch,
                                    self.monitor_best, async_save=async_save)
            self.logger.info("saved model_best (epoch %d)", epoch)
