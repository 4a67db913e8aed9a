"""Optimizer, LR schedules and parameter freezing (port of
oatx/train/optim.py:19-224).

The port's AdamW computes what oatx's optax chain computes, not what
torch.optim.AdamW does:

    clip_by_global_norm(grad_clip)     optional; g ← g·c/‖g‖ when ‖g‖ ≥ c
    scale_by_adam(b1, b2, eps)         mu, nu; bias-corrected mu_hat/(√nu_hat + eps)
    add_decayed_weights(wd)            + wd·p on EVERY parameter (no mask)
    scale_by_learning_rate(lr)         × −lr(count), count before the increment
    freeze mask                        frozen params get no update (their
                                       moments still move, as in optax)
    EMA                                ema ← d·ema + (1 − d)·p after the update

A parameter without a gradient is given a zero gradient, as optax sees one:
its moments decay and weight decay still applies. The global-norm clip is
optax's formula, written out here: `torch.nn.utils.clip_grad_norm_` adds
1e-6 to the norm. The update runs on torch's `_foreach` kernels over all
parameters at once.

Sharded state (parallel/sharding.py): under `zero1` (the `zero1` argument,
{name: FlatShard}) each rank holds `mu`, `nu` and `ema` for its share of
each sharded parameter only: it takes its share of the parameter and of
the (already averaged) gradient, updates that share, and all-gathers the
updated shares into the whole parameter, which every rank holds. Under
`fsdp` the parameters themselves are shares (`sharding.place`), so the update
runs on them as on whole tensors. Under a model axis (parallel/sharding.py)
a split parameter is the rank's part of the whole, and its moments are too.
Either way the clip and `grad_norm` read the norm of the whole gradient: the
squares of the data-axis shares summed over the data axis, those of the
model-axis parts summed over the model group, and the replicated gradients
counted once, the same value on every rank (optax's global norm of the
whole tree). Under pipeline stages a rank holds its stage's video blocks
and every other parameter whole: the squares of the blocks' gradients are
summed over the model group, each stage's counted once, and the rest once.
`named_state` / `load_named_state` keep the schema of whole tensors,
gathering and slicing one tensor at a time (another stage's moments come
from its rank of the model group: parallel/sharding.py `StagePlan`).

`make_optimizer` returns a factory: call it with `model.named_parameters()`
(train/step.py `init_state` does). Trainable filters take the parameter's
state_dict name split on '.', e.g. ('txt_proj', '1', 'weight'), so oatx's
`linear_probe_filter` keeps its meaning. adafactor, lion and sgd are not
ported yet (ROADMAP A).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel import sharding

Schedule = Callable[[int], float]
PathFilter = Callable[[Tuple[str, ...]], bool]


def step_decay_schedule(base_lr: float, steps_per_epoch: int,
                        milestones: Sequence[int] = (60, 80),
                        gamma: float = 0.1) -> Schedule:
    """lr = base · gamma^(#milestone epochs passed) (optax
    piecewise_constant_schedule)."""
    bounds = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(count: int) -> float:
        return base_lr * gamma ** sum(count >= b for b in bounds)

    return schedule


def make_schedule(base_lr: float, steps_per_epoch: int, total_epochs: int,
                  kind: str = "step", milestones: Sequence[int] = (60, 80),
                  gamma: float = 0.1, warmup_steps: int = 0,
                  lr_min: float = 0.0) -> Schedule:
    """The LR as a function of the step count (oatx make_schedule):
    'step' (epoch milestones × gamma), 'cosine' (base → lr_min over the steps
    after warm-up) or 'constant', after an optional linear 0 → base warm-up."""
    total = max(int(total_epochs) * int(steps_per_epoch), 1)
    if kind == "step":
        main = step_decay_schedule(base_lr, steps_per_epoch, milestones, gamma)
    elif kind == "cosine":
        decay_steps = max(total - warmup_steps, 1)
        alpha = lr_min / base_lr if base_lr else 0.0

        def main(count: int) -> float:
            c = min(count, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return base_lr * ((1 - alpha) * cosine + alpha)
    elif kind == "constant":
        def main(count: int) -> float:
            return base_lr
    else:
        raise ValueError(f"unknown LR schedule {kind!r} "
                         "(expected step|cosine|constant)")
    if warmup_steps <= 0:
        return main

    def warmed(count: int) -> float:
        if count < warmup_steps:
            return base_lr * max(count, 0) / warmup_steps
        return main(count - warmup_steps)

    return warmed


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ‖t‖²) over the tensors, an f32 0-d tensor (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _share_of(p: torch.Tensor):
    """The FlatShard a parameter is this rank's share of (fsdp), or None."""
    return getattr(p, "_oatx_shard", None)


def _split_of(p: torch.Tensor):
    """The ModelShard a parameter is this rank's part of (a model axis), or
    None."""
    return getattr(p, "_oatx_tp", None)


def _stage_of(p: torch.Tensor):
    """The StagePlan of a parameter this rank's pipeline stage owns, or
    None."""
    return getattr(p, "_oatx_pp", None)


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in f32, as optax computes it. With decay 0.999 the
    subtraction cancels most digits (at count 5 the f32 value is 1.2e-5 off
    the exact one), so f32 here is what makes the port's updates optax's."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class AdamW(torch.optim.Optimizer):
    """optax.adamw with oatx's optional clip, freeze mask and EMA (module
    docstring), over named parameters. State per parameter: `mu`, `nu` (and
    `ema`), whole or, for a name in `zero1`, this rank's share; the step
    count is the param group's `count`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: Union[float, Schedule] = 2e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip: Optional[float] = None,
                 trainable_filter: Optional[PathFilter] = None,
                 ema_decay: Optional[float] = None, zero1: Optional[Dict] = None):
        named = list(named_params)
        self.schedule = lr if callable(lr) else None
        super().__init__([p for _, p in named],
                         dict(lr=0.0 if callable(lr) else lr, betas=betas, eps=eps,
                              weight_decay=weight_decay, count=0))
        self.names = [n for n, _ in named]
        self.grad_clip = grad_clip
        self.ema_decay = ema_decay
        self.trainable = [trainable_filter is None or bool(trainable_filter(tuple(n.split("."))))
                          for n in self.names]
        self.zero1 = [(zero1 or {}).get(n) for n in self.names]
        with torch.no_grad():
            for p, spec in zip(self.param_groups[0]["params"], self.zero1):
                held = spec.take(p) if spec is not None else p.detach()
                st = self.state[p]
                st["mu"] = torch.zeros_like(held)
                st["nu"] = torch.zeros_like(held)
                if ema_decay:
                    st["ema"] = held.clone()

    def grad_norm(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None
                  ) -> torch.Tensor:
        """The global norm of the whole gradient (optax.global_norm), the
        same on every rank: `grads` pairs with the parameters (default:
        their `.grad`; None counts as zero)."""
        params = self.param_groups[0]["params"]
        if grads is None:
            grads = [p.grad for p in params]
        live = [(p, g) for p, g in zip(params, grads) if g is not None]
        if any(_split_of(p) is not None for p, _ in live):
            return self._split_norm(live)
        stages = next((_stage_of(p) for p, _ in live if _stage_of(p) is not None), None)
        if stages is not None:
            owned = global_norm([g for p, g in live if _stage_of(p) is not None]).square()
            coll.all_reduce_sum(owned, "norm", stages.group)
            rest = [g for p, g in live if _stage_of(p) is None]
            return (owned + global_norm(rest).square()).sqrt() if rest else owned.sqrt()
        whole = [g for p, g in live if _share_of(p) is None]
        shares = [(g, _share_of(p)) for p, g in live if _share_of(p) is not None]
        if not shares:
            return global_norm(whole) if whole else torch.zeros(
                (), device=params[0].device)
        sq = torch.stack(torch._foreach_norm([g.float() for g, _ in shares])).square().sum()
        coll.all_reduce_sum(sq, "norm", shares[0][1].group)
        if whole:
            sq = sq + global_norm(whole).square()
        return sq.sqrt()

    @staticmethod
    def _split_norm(live) -> torch.Tensor:
        """grad_norm under a model axis: [split, replicated] squares of the
        data-axis shares summed over the data axis, then the split ones'
        over the model group, the replicated whole gradients once."""
        def sq(gs):
            if not gs:
                return torch.zeros((), device=live[0][1].device)
            return torch.stack(torch._foreach_norm([g.float() for g in gs])).square().sum()

        parts = {(split, share): [g for p, g in live
                                  if (_split_of(p) is not None) == split
                                  and (_share_of(p) is not None) == share]
                 for split in (True, False) for share in (True, False)}
        shared = torch.stack([sq(parts[True, True]), sq(parts[False, True])])
        spec = next((_share_of(p) for p, _ in live if _share_of(p) is not None), None)
        if spec is not None:
            coll.all_reduce_sum(shared, "norm", spec.group)
        split = sq(parts[True, False]) + shared[0]
        coll.all_reduce_sum(split, "norm", next(_split_of(p) for p, _ in live
                                                if _split_of(p) is not None).group)
        return (split + shared[1] + sq(parts[False, False])).sqrt()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["betas"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.grad_clip is not None:
            norm = self.grad_norm(grads)
            grads = torch._foreach_mul(grads, torch.where(
                norm < self.grad_clip, 1.0, self.grad_clip / norm))
        count = group["count"]
        if self.schedule is not None:
            group["lr"] = self.schedule(count)
        count += 1
        # zero1: this rank's shares of the sharded parameters and gradients
        held = [spec.take(p) if spec is not None else p for p, spec in zip(params, self.zero1)]
        grads = [spec.take(g) if spec is not None else g for g, spec in zip(grads, self.zero1)]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        denom = torch._foreach_div(nus, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(mus, _bias_correction(b1, count))
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, held, alpha=group["weight_decay"])
        torch._foreach_mul_(upd, -group["lr"])
        live = [i for i, t in enumerate(self.trainable) if t]
        torch._foreach_add_([held[i] for i in live], [upd[i] for i in live])
        if self.ema_decay:
            emas = [self.state[p]["ema"] for p in params]
            torch._foreach_mul_(emas, self.ema_decay)
            torch._foreach_add_(emas, held, alpha=1 - self.ema_decay)
        self._publish([(params[i], held[i], self.zero1[i]) for i in live
                       if self.zero1[i] is not None])
        group["count"] = count

    @staticmethod
    def _publish(items) -> None:
        """zero1: every rank's updated shares all-gathered into the whole
        parameters, in buckets of up to BUCKET_BYTES a rank."""
        bucket, size = [], 0
        for i, item in enumerate(items):
            bucket.append(item)
            size += item[1].numel() * item[1].element_size()
            if size < coll.BUCKET_BYTES and i < len(items) - 1:
                continue
            spec0 = bucket[0][2]
            got = coll.all_gather_flat(torch.cat([h for _, h, _ in bucket]), spec0.group,
                                       "param_update").view(spec0.size, -1)
            off = 0
            for p, h, spec in bucket:
                p.copy_(spec.whole(got[:, off:off + spec.chunk].reshape(-1)))
                off += spec.chunk
            bucket, size = [], 0

    def _spec(self, i: int, p: torch.Tensor):
        return self.zero1[i] if self.zero1[i] is not None else _share_of(p)

    def named_state(self, to_host: bool = False,
                    keep: bool = True) -> Optional[Dict[str, object]]:
        """{'count', 'mu', 'nu'[, 'ema']}, the moments keyed by parameter name,
        whole: a rank's shares, model-axis parts and other stages' moments
        are gathered one tensor at a time (every rank must call it then);
        `to_host` copies each to the CPU. `keep=False`
        (a rank that writes no snapshot): take part in each gather, keep
        nothing, → None."""
        group = self.param_groups[0]
        out: Dict[str, object] = {"count": group["count"]}
        stages = next((_stage_of(p) for p in group["params"] if _stage_of(p) is not None),
                      None)
        index = {n: i for i, n in enumerate(self.names)}
        for key in ("mu", "nu", "ema"):
            if key == "ema" and not self.ema_decay:
                continue
            out[key] = {}
            for n in (stages.params if stages is not None else self.names):
                i = index.get(n)
                t = None
                if i is not None:
                    p = group["params"][i]
                    t = sharding.held_whole(self.state[p][key], p, "state_gather",
                                            self._spec(i, p))
                if stages is not None and stages.owner(n) is not None:
                    t = stages.fetch(n, t)
                if keep:
                    out[key][n] = t.to("cpu", copy=True) if to_host else t
        return out if keep else None

    def param_shaped(self, key: str) -> Dict[str, torch.Tensor]:
        """{name: state `key` shaped as the parameter is held}: zero1's
        shares gathered whole (every rank must call it then)."""
        params = self.param_groups[0]["params"]
        return {n: (spec.gather(self.state[p][key], "state_gather") if spec is not None
                    else self.state[p][key])
                for n, p, spec in zip(self.names, params, self.zero1)}

    @torch.no_grad()
    def load_named_state(self, state: Dict[str, object]) -> None:
        """Load what `named_state` returns (or convert.opt_state_from_optax):
        whole tensors on any device, of which a rank keeps its shares."""
        group = self.param_groups[0]
        group["count"] = int(state["count"])
        for key in ("mu", "nu", "ema"):
            if key == "ema" and not self.ema_decay:
                continue
            for i, (n, p) in enumerate(zip(self.names, group["params"])):
                self.state[p][key].copy_(sharding.held_part(state[key][n], p,
                                                            self._spec(i, p)))


def make_optimizer(lr: Union[float, Schedule] = 2e-4, weight_decay: float = 0.01,
                   betas: Optional[Tuple[float, float]] = None, eps: float = 1e-8,
                   grad_clip: Optional[float] = None,
                   trainable_filter: Optional[PathFilter] = None,
                   ema_decay: Optional[float] = None,
                   kind: str = "adamw") -> Callable[..., AdamW]:
    """Optimizer factory (`optimizer.type`): → a callable taking
    `model.named_parameters()`. Only 'adamw' is ported."""
    k = kind.lower()
    if k in ("adafactor", "lion", "sgd"):
        raise NotImplementedError(f"optimizer {kind!r} is not ported yet")
    if k != "adamw":
        raise ValueError(f"unknown optimizer type {kind!r} "
                         "(expected adamw|adafactor|lion|sgd)")
    if ema_decay and not 0.0 < ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    return functools.partial(AdamW, lr=lr, betas=betas or (0.9, 0.999), eps=eps,
                             weight_decay=weight_decay, grad_clip=grad_clip,
                             trainable_filter=trainable_filter, ema_decay=ema_decay)


def exclude_subtrees(base_filter: Optional[PathFilter], roots: Tuple[str, ...]) -> PathFilter:
    """A trainable filter that also freezes whole top-level subtrees."""

    def f(path: Tuple[str, ...]) -> bool:
        if len(path) > 0 and path[0] in roots:
            return False
        return True if base_filter is None else base_filter(path)

    return f


def linear_probe_filter(path: Tuple[str, ...]) -> bool:
    """Train only the contrastive projection heads (names containing
    'txt_proj' or 'vid_proj' at the top level)."""
    return len(path) > 0 and ("txt_proj" in path[0] or "vid_proj" in path[0])
