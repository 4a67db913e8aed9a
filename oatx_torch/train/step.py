"""The train step of the dual tower (port of oatx/train/step.py:33-433).

One step: forward both towers on the batch, the variant's loss, backward,
the optimizer (train/optim.py: AdamW, Adafactor, Lion or SGD). oatx jits a
pure function of (params, opt_state); here the model and its optimizer are updated in place (PyTorch's idiom, and
the counterpart of oatx donating its state), and the step returns a new
`TrainState` whose `step` counts the updates made.

    loss      oatx `loss_fn` per variant (:54-69, 143-178), each term also a
              metric:
              baseline      NormSoftmax(sim(text, video)) (or max-margin);
                            with an object tower, object_nce_weight > 0 and
                            an 'object' batch key, + w·(pair(object, video)
                            + pair(text, object)) (loss_object, :148-154),
                            the object tower outside fwd_chunk's chunks
              global_local  pair(text, video) + pair(pad_text, video)
                            + fine-grained NormSoftmax(mean tags, mean regions)
                            (loss_st2sv, loss_lt2sv, loss_fine)
              region_mem    pair(text, video) + w·region_bce(region logits,
                            patch masks) (loss_nce, loss_region)
    accum     `accum_steps` micro-batches, each with its own negatives,
              gradients averaged before one update (:323-345)
    fwd_chunk the tower forwards run on chunk-sized sub-batches, each under
              torch.utils.checkpoint, and the loss spans the FULL batch
              (oatx loss_fn :72-141 without a mesh): exact large-batch
              negatives in the memory of one chunk, for a second forward
    skip      `skip_nonfinite`: a step whose loss or gradient norm is not
              finite leaves params, moments and step untouched, skipped = 1
    metrics   loss, grad_norm (global norm of the unclipped gradients) and,
              with skip_nonfinite, skipped; 0-d tensors on the device

`make_augmenter` is oatx's (:182-205): uint8 'video' and 'object_frame'
→ train_augment (or the eval transform) on the device, each key from a
generator of its own derived from the step's (oatx folds the key's index
into the step's key). `make_eval_step` returns every `*_embeds` output of
the variant's forward (:408-414).

Data parallelism across processes (oatx's manual-DP step, `loss_fn` with
`gather_axes` and `_manual_dp_grads`, :72-178, 208-267): under a default
process group of n > 1 ranks (parallel/mesh.py) each rank runs the step on
its rows of the global batch. `loss_fn` gathers every cross-batch loss
input across the ranks before the loss (the text and video embeddings,
stream 3's object embeddings, global_local's pad_text embeddings, region
and tag features), so negatives span the global batch, and averages
region_mem's BCE over the ranks instead: every rank computes the same loss,
bitwise. `fwd_chunk` chunks the rank's own rows and gathers after. With
`accum_steps` each micro-batch gathers its own global negatives. After the
backward (and the accumulation) each gradient crosses the ranks once and
becomes its mean (collectives.reduce_gradients, in `grad_reduce_dtype` on
the wire when given). The augmenter draws for the global batch
(data/transforms.py). Without a group, or with one rank, none of this runs:
the step is the one-device step.

Under a model axis (parallel/mesh.py, `model_parallel` mp; the model split
by `sharding.place`) the ranks of one model group hold the same rows and
compute the same loss, each on its part of the weights (parallel/
tensor.py): the gathers, region_mem's mean and the gradient mean run over
the batch group (the ranks at this rank's model rank, one per data
position), the augmenter draws for the data position's rows, and after the
backward the gradients a model rank holds in part are summed over the
model group after that mean (`sharding.reduce_model_partials`; an fsdp
share's too: the model ranks' shares of it cover the same elements).

Under pipeline stages over the model axis (a model placed by
`sharding.place` on a Layout with `pipeline`) the step is the same: the
video tower's forward runs its block stack through parallel/pipeline.py on
the accumulation micro-batch, split there into `pipeline_microbatches`
for the stack only, so the loss and its negatives still span the whole
micro-batch; the backward sends the cotangents back stage by stage inside
`loss.backward()`. Every stage computes the same loss and the same
gradients of the heads after the stack, which are whole on each stage; a
stage's block gradients are averaged over the ranks of that stage (the
batch group at its model rank), and the embedding's, which stage 0 alone
computes, are summed over the model group after that
(`sharding.reduce_model_partials`).

Sharded state (parallel/sharding.py): under `zero1` the step is the one
above and the optimizer updates its shares. Under `fsdp` (a model put in
place by `sharding.place`) the forward and backward run inside
`gathering()`, so every access of a sharded weight all-gathers it; the
gradients are not all-reduced: after the last micro-batch each sharded
parameter's whole gradient is reduce-scattered once to its mean share, the
replicated leaves all-reduced, in f32 (`grad_reduce_dtype` does not apply,
as in oatx's GSPMD path). `grad_norm` is the whole gradient's on every
layout (train/optim.py Family.grad_norm).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from oatx_torch import DeviceLike, resolve_device
from oatx_torch.data import transforms as T
from oatx_torch.losses import contrastive as C
from oatx_torch.models.towers import DualTower, TowerConfig
from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel import sharding
from oatx_torch.parallel.mesh import current_layout
from oatx_torch.train.optim import Family

Batch = Dict[str, Any]


class TrainState(NamedTuple):
    model: DualTower
    optimizer: Family
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


def _outputs(model: DualTower, batch: Batch) -> Dict[str, torch.Tensor]:
    """The variant's forward as a dict (baseline: text_embeds, video_embeds)."""
    out = model(batch)
    if model.cfg.variant == "baseline":
        return {"text_embeds": out[0], "video_embeds": out[1]}
    return out


def loss_fn(model: DualTower, loss_cfg: LossConfig, batch: Batch,
            fwd_chunk: Optional[int] = None, gather: bool = False,
            group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the model's variant on a batch of tensors on the
    model's device: 'video' (B, F, H, W, C) normalized frames, 'input_ids'
    (B, L), optional 'attention_mask', and the variant's extras
    (DualTower.forward_*). `fwd_chunk`: the tower forwards run checkpointed
    on sub-batches of that size (B must divide by it), the loss over all
    B. `gather` (oatx's gather_axes): the batch is this rank's rows; every
    cross-batch loss input is gathered across the ranks and region_mem's
    BCE averaged over them (module docstring), over `group` (default: all
    ranks)."""
    g = (lambda x: coll.all_gather_rows(x, group)) if gather else (lambda x: x)
    if fwd_chunk:
        out = scan_chunked(lambda mb: ckpt.checkpoint(_outputs, model, mb, use_reentrant=False),
                           fwd_chunk)(batch)
    else:
        out = _outputs(model, batch)
    variant = model.cfg.variant
    if variant == "baseline":
        text_e, video_e = g(out["text_embeds"]), g(out["video_embeds"])
        loss = _embed_pair_loss(text_e, video_e, loss_cfg)
        if loss_cfg.object_nce_weight > 0 and model.cfg.object_tower is not None \
                and "object" in batch:
            obj_e = g(model.compute_object(batch["object"]))
            l_obj = (_embed_pair_loss(obj_e, video_e, loss_cfg)
                     + _embed_pair_loss(text_e, obj_e, loss_cfg))
            loss = loss + loss_cfg.object_nce_weight * l_obj
            return loss, {"loss": loss.detach(), "loss_object": l_obj.detach()}
        return loss, {"loss": loss.detach()}
    video_e = g(out["video_embeds"])
    if variant == "global_local":
        terms = {
            "loss_st2sv": _pair_loss(C.sim_matrix(g(out["text_embeds"]), video_e), loss_cfg),
            "loss_lt2sv": _pair_loss(C.sim_matrix(g(out["pad_text_embeds"]), video_e),
                                     loss_cfg),
            "loss_fine": C.fine_grained_region_tag_loss(g(out["region_feat"]),
                                                        g(out["tags_feat"]),
                                                        loss_cfg.temperature),
        }
        loss = terms["loss_st2sv"] + terms["loss_lt2sv"] + terms["loss_fine"]
    else:  # region_mem
        l_region = C.region_bce(out["region_sim_logits"], batch["patch_masks"])
        terms = {
            "loss_nce": _pair_loss(C.sim_matrix(g(out["text_embeds"]), video_e), loss_cfg),
            "loss_region": coll.mean_across_ranks(l_region, group) if gather else l_region,
        }
        loss = terms["loss_nce"] + loss_cfg.region_bce_weight * terms["loss_region"]
    return loss, {"loss": loss.detach(), **{k: v.detach() for k, v in terms.items()}}


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            .to(device, non_blocking=True) for k, v in batch.items()}


def _step_seed(base_seed: int, step: int) -> int:
    """A per-step seed for the augmentation's generator (oatx folds the step
    into its base key)."""
    return int(np.random.SeedSequence([base_seed, step]).generate_state(1)[0])


FRAME_KEYS = ("video", "object_frame")  # uint8 frame tensors the augmenter transforms


def key_generator(gen: torch.Generator, i: int) -> torch.Generator:
    """The generator of FRAME_KEYS[i] from the step's generator (oatx's
    fold_in(rng, i)): key 0 draws from `gen` itself, key i > 0 from a
    generator seeded from (gen's seed, i), so no key's draws depend on
    whether or in what order the others were drawn."""
    if i == 0:
        return gen
    seed = np.random.SeedSequence([gen.initial_seed(), i]).generate_state(1)[0]
    return torch.Generator(gen.device).manual_seed(int(seed))


def make_augmenter(transform_cfg: Optional[T.TransformConfig] = None, train: bool = True,
                   tower_cfg: Optional[TowerConfig] = None, layout=None):
    """`augment(generator, batch) → batch`: uint8 'video' / 'object_frame'
    become normalized f32 on the batch's device, through train_augment (from
    `key_generator(generator, i)`) or the eval transform. The output
    resolution follows the tower's img_size when tower_cfg is given (oatx
    make_augmenter). Under a process group of several data positions
    (`layout`, default: the current group's) each rank draws for the global
    batch and keeps its position's rows (data/transforms.py)."""
    if transform_cfg is None:
        res = tower_cfg.video.img_size if tower_cfg is not None else 224
        transform_cfg = T.TransformConfig(input_res=res)
    tcfg = transform_cfg
    layout = layout or current_layout()
    shard = (layout.position, layout.batch_shards) if layout.batch_shards > 1 else None

    def augment(gen: torch.Generator, batch: Dict[str, torch.Tensor]):
        out = dict(batch)
        for i, key in enumerate(FRAME_KEYS):
            if key in out and out[key].dtype == torch.uint8:
                out[key] = (T.train_augment(key_generator(gen, i), out[key], tcfg, shard)
                            if train else T.eval_transform(out[key], tcfg))
        return out

    return augment


def make_train_step(cfg: TowerConfig, loss_cfg: LossConfig,
                    augment: Optional[Callable[[torch.Generator, Dict[str, torch.Tensor]],
                                               Dict[str, torch.Tensor]]] = None,
                    base_seed: int = 0, accum_steps: int = 1,
                    skip_nonfinite: bool = False, fwd_chunk: Optional[int] = None,
                    grad_reduce_dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None,
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step `step(state, batch) → (state, metrics)`.

    The batch may hold numpy arrays or tensors; the step moves it to
    `device` (CUDA unless the caller passes another). `augment(generator,
    batch)`, if given, runs first with a generator seeded from
    (base_seed, state.step). accum_steps > 1 splits the batch into that many
    micro-batches (negatives then span a micro-batch, as in oatx);
    `fwd_chunk` keeps full-batch negatives (loss_fn). The process group
    set up when the step is built (parallel/mesh.py) takes the place of
    oatx's `mesh` / `manual_axes`: with several data positions (the layout
    `sharding.place` put the model on) the batch is this position's rows
    and the step is data-parallel (module docstring), the gradients reduced
    in `grad_reduce_dtype` when given; with one it is unused."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        layout = sharding.layout_of(model)
        dp = layout.batch_shards > 1
        group = coll.batch_group(layout) if dp else None
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
        fsdp = sharding.fsdp_of(model)
        sums: Dict[str, torch.Tensor] = {}
        with sharding.gathered(model):
            for mb in micro:
                loss, m = loss_fn(model, loss_cfg, mb, fwd_chunk, gather=dp, group=group)
                loss.backward()
                for k, v in m.items():
                    sums[k] = sums[k] + v if k in sums else v
        metrics = {k: v / len(micro) for k, v in sums.items()}
        if fsdp is not None:
            fsdp.reduce_gradients(len(micro))
        else:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if len(micro) > 1:
                torch._foreach_div_(grads, float(len(micro)))
            if dp:
                coll.reduce_gradients(model.parameters(), grad_reduce_dtype, group=group)
        sharding.reduce_model_partials(model)
        metrics["grad_norm"] = opt.grad_norm()
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
    """`eval_step(model, batch) → {'text_embeds', 'video_embeds', ...}`: every
    `*_embeds` output of the variant's forward, no gradients. By default a
    uint8 'video' or 'object_frame' goes through the eval transform at the
    tower's img_size (oatx make_augmenter(train=False))."""
    dev = resolve_device(device)
    if augment is None:
        eval_augment = make_augmenter(train=False, tower_cfg=cfg)

        def augment(batch):
            return eval_augment(None, batch)

    def body(model: DualTower, batch: Dict[str, torch.Tensor]):
        out = _outputs(model, augment(batch))
        return {k: v for k, v in out.items() if k.endswith("_embeds")}

    @torch.no_grad()
    def eval_step(model: DualTower, batch: Batch):
        batch = _to_device(batch, dev)
        with sharding.gathered(model):
            if chunk is None:
                return body(model, batch)
            return scan_chunked(lambda mb: body(model, mb), chunk)(batch)

    return eval_step


def init_state(cfg: TowerConfig, optimizer: Callable[..., Family],
               device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               state_dict: Optional[Dict[str, torch.Tensor]] = None,
               shard_mode: Optional[str] = None, layout=None) -> TrainState:
    """A fresh TrainState: the tower on `device` (CUDA unless the caller
    names another; random init from `generator`, or `state_dict` loaded
    strictly), split over `layout`'s model axis and placed by `shard_mode`
    ('fsdp' | 'zero1') on its data axis (default layout: the current
    group's, one slice, no model axis; parallel/sharding.py), and
    `optimizer` (train/optim.make_optimizer) built over its named
    parameters."""
    model = DualTower(cfg, device, generator)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    shards = sharding.place(model, shard_mode, layout or current_layout())
    return TrainState(model, optimizer(model.named_parameters(),
                                       zero1=shards if shard_mode == "zero1" else None), 0)
