"""The train step of the baseline dual tower (port of oatx/train/step.py:33-433).

One step: forward both towers on the batch, the contrastive loss over the
batch's (text, video) similarity matrix, backward, AdamW
(train/optim.py). oatx jits a pure function of (params, opt_state); here the
model and its optimizer are updated in place (PyTorch's idiom, and the
counterpart of oatx donating its state), and the step returns a new
`TrainState` whose `step` counts the updates made.

    loss      NormSoftmax(sim(text, video)) (or max-margin), the baseline
              variant of oatx `loss_fn` (:54-69, 143-155)
    accum     `accum_steps` micro-batches, each with its own negatives,
              gradients averaged before one update (:323-345)
    skip      `skip_nonfinite`: a step whose loss or gradient norm is not
              finite leaves params, moments and step untouched, skipped = 1
    metrics   loss, grad_norm (global norm of the unclipped gradients) and,
              with skip_nonfinite, skipped; 0-d tensors on the device

Not ported yet (they need torch.utils.checkpoint or torch.distributed; queued
in ROADMAP A): `fwd_chunk`, `mesh`, `manual_axes`, `grad_reduce_dtype`, the
video tower's remat and scanned blocks, the train-time augmentation, the
object NCE terms and the other variants. Each raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.data import transforms as T
from oatx_torch.losses import contrastive as C
from oatx_torch.models.towers import DualTower, TowerConfig
from oatx_torch.train.optim import AdamW, global_norm

Batch = Dict[str, Any]


class TrainState(NamedTuple):
    model: DualTower
    optimizer: AdamW
    step: int


@dataclasses.dataclass(frozen=True)
class LossConfig:
    name: str = "NormSoftmaxLoss"      # | 'MaxMarginRankingLoss'
    temperature: float = 0.05
    margin: float = 1.0
    region_bce_weight: float = 0.1
    chunked: bool = False
    chunk_size: int = 4096
    object_nce_weight: float = 0.0


def _pair_loss(sims: torch.Tensor, loss_cfg: LossConfig) -> torch.Tensor:
    if loss_cfg.name == "NormSoftmaxLoss":
        return C.norm_softmax_loss(sims, loss_cfg.temperature)
    if loss_cfg.name == "MaxMarginRankingLoss":
        return C.max_margin_ranking_loss(sims, loss_cfg.margin)
    raise ValueError(f"unknown loss {loss_cfg.name!r}")


def _embed_pair_loss(text_e: torch.Tensor, video_e: torch.Tensor,
                     loss_cfg: LossConfig) -> torch.Tensor:
    if loss_cfg.chunked and loss_cfg.name == "NormSoftmaxLoss":
        return C.norm_softmax_loss_chunked(text_e, video_e, loss_cfg.temperature,
                                           chunk=loss_cfg.chunk_size)
    return _pair_loss(C.sim_matrix(text_e, video_e), loss_cfg)


def loss_fn(model: DualTower, loss_cfg: LossConfig,
            batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the baseline variant on a batch of tensors on the
    model's device: 'video' (B, F, H, W, C) normalized frames, 'input_ids'
    (B, L) and optional 'attention_mask'."""
    if loss_cfg.object_nce_weight > 0:
        raise NotImplementedError("object NCE terms: the object tower is not ported yet")
    text_e = model.compute_text(batch["input_ids"], batch.get("attention_mask"))
    video_e = model.compute_video(batch["video"])["cls"]
    loss = _embed_pair_loss(text_e, video_e, loss_cfg)
    return loss, {"loss": loss.detach()}


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            .to(device, non_blocking=True) for k, v in batch.items()}


def _step_seed(base_seed: int, step: int) -> int:
    """A per-step seed for the augmentation's generator (oatx folds the step
    into its base key)."""
    return int(np.random.SeedSequence([base_seed, step]).generate_state(1)[0])


def _check_ported(cfg: TowerConfig, **unported) -> None:
    for name, value in unported.items():
        if value:
            raise NotImplementedError(f"make_train_step({name}=...) is not ported yet")
    for name in ("remat", "scan_blocks"):
        if getattr(cfg.video, name):
            raise NotImplementedError(f"SpaceTimeViTConfig.{name} is not ported yet")


def make_train_step(cfg: TowerConfig, loss_cfg: LossConfig,
                    augment: Optional[Callable[[torch.Generator, Dict[str, torch.Tensor]],
                                               Dict[str, torch.Tensor]]] = None,
                    base_seed: int = 0, accum_steps: int = 1,
                    skip_nonfinite: bool = False, fwd_chunk: Optional[int] = None,
                    mesh: Any = None, manual_axes: Any = None,
                    grad_reduce_dtype: Any = None, device: DeviceLike = None,
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step `step(state, batch) → (state, metrics)`.

    The batch may hold numpy arrays or tensors; the step moves it to
    `device` (CUDA unless the caller passes another). `augment(generator,
    batch)`, if given, runs first with a generator seeded from
    (base_seed, state.step). accum_steps > 1 splits the batch into that many
    micro-batches (negatives then span a micro-batch, as in oatx)."""
    _check_ported(cfg, fwd_chunk=fwd_chunk, mesh=mesh, manual_axes=manual_axes,
                  grad_reduce_dtype=grad_reduce_dtype)
    dev = resolve_device(device)

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        batch = _to_device(batch, dev)
        if augment is not None:
            gen = torch.Generator(dev).manual_seed(_step_seed(base_seed, state.step))
            batch = augment(gen, batch)
        if accum_steps > 1:
            for k, v in batch.items():
                if v.shape[0] % accum_steps:
                    raise ValueError(f"batch size {v.shape[0]} not divisible by "
                                     f"accum_steps={accum_steps}")
            micro = [{k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                     for i in range(accum_steps)]
        else:
            micro = [batch]
        opt.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for mb in micro:
            loss, m = loss_fn(model, loss_cfg, mb)
            loss.backward()
            for k, v in m.items():
                sums[k] = sums[k] + v if k in sums else v
        metrics = {k: v / len(micro) for k, v in sums.items()}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if len(micro) > 1:
            torch._foreach_div_(grads, float(len(micro)))
        metrics["grad_norm"] = global_norm(grads)
        if skip_nonfinite:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"]))
            metrics["skipped"] = torch.tensor(0.0 if ok else 1.0, device=dev)
            if not ok:
                opt.zero_grad(set_to_none=True)
                metrics["loss"] = torch.zeros((), device=dev)
                metrics["grad_norm"] = torch.zeros((), device=dev)
                return state, metrics
        opt.step()
        return state._replace(step=state.step + 1), metrics

    return step


def scan_chunked(fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                 chunk: int) -> Callable:
    """Run fn on chunk-sized sub-batches of a batch larger than `chunk` and
    concatenate the outputs (oatx's lax.scan over sub-batches). The leading
    dim must be divisible by `chunk`; batches ≤ chunk pass through."""

    def wrapped(batch):
        b = next(iter(batch.values())).shape[0]
        if b <= chunk:
            return fn(batch)
        if b % chunk:
            raise ValueError(f"batch {b} not divisible by chunk={chunk}")
        outs = [fn({k: v[i:i + chunk] for k, v in batch.items()})
                for i in range(0, b, chunk)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return wrapped


def make_eval_step(cfg: TowerConfig, augment: Optional[Callable] = None,
                   chunk: Optional[int] = None, device: DeviceLike = None) -> Callable:
    """`eval_step(model, batch) → {'text_embeds', 'video_embeds'}`, no
    gradients. By default a uint8 'video' goes through the eval transform
    at the tower's img_size (oatx make_augmenter(train=False))."""
    dev = resolve_device(device)
    if augment is None:
        tcfg = T.TransformConfig(input_res=cfg.video.img_size)

        def augment(batch):
            if batch["video"].dtype == torch.uint8:
                batch = {**batch, "video": T.eval_transform(batch["video"], tcfg)}
            return batch

    def body(model: DualTower, batch: Dict[str, torch.Tensor]):
        batch = augment(batch)
        return {"text_embeds": model.compute_text(batch["input_ids"],
                                                  batch.get("attention_mask")),
                "video_embeds": model.compute_video(batch["video"])["cls"]}

    @torch.no_grad()
    def eval_step(model: DualTower, batch: Batch):
        batch = _to_device(batch, dev)
        if chunk is None:
            return body(model, batch)
        return scan_chunked(lambda mb: body(model, mb), chunk)(batch)

    return eval_step


def init_state(cfg: TowerConfig, optimizer: Callable[..., AdamW],
               device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """A fresh TrainState: the tower on `device` (CUDA unless the caller
    names another; random init from `generator`, or `state_dict` loaded
    strictly), and `optimizer` (train/optim.make_optimizer) built over its
    named parameters."""
    model = DualTower(cfg, device, generator)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return TrainState(model, optimizer(model.named_parameters()), 0)
