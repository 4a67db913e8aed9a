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


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in f32, as optax computes it. With decay 0.999 the
    subtraction cancels most digits (at count 5 the f32 value is 1.2e-5 off
    the exact one), so f32 here is what makes the port's updates optax's."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class AdamW(torch.optim.Optimizer):
    """optax.adamw with oatx's optional clip, freeze mask and EMA (module
    docstring), over named parameters. State per parameter: `mu`, `nu` (and
    `ema`); the step count is the param group's `count`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: Union[float, Schedule] = 2e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip: Optional[float] = None,
                 trainable_filter: Optional[PathFilter] = None,
                 ema_decay: Optional[float] = None):
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
        with torch.no_grad():
            for p in self.param_groups[0]["params"]:
                st = self.state[p]
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
                if ema_decay:
                    st["ema"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["betas"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.grad_clip is not None:
            norm = global_norm(grads)
            grads = torch._foreach_mul(grads, torch.where(
                norm < self.grad_clip, 1.0, self.grad_clip / norm))
        count = group["count"]
        if self.schedule is not None:
            group["lr"] = self.schedule(count)
        count += 1
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
        torch._foreach_add_(upd, params, alpha=group["weight_decay"])
        torch._foreach_mul_(upd, -group["lr"])
        live = [i for i, t in enumerate(self.trainable) if t]
        torch._foreach_add_([params[i] for i in live], [upd[i] for i in live])
        if self.ema_decay:
            emas = [self.state[p]["ema"] for p in params]
            torch._foreach_mul_(emas, self.ema_decay)
            torch._foreach_add_(emas, params, alpha=1 - self.ema_decay)
        group["count"] = count

    def named_state(self) -> Dict[str, object]:
        """{'count', 'mu', 'nu'[, 'ema']}, the moments keyed by parameter name."""
        group = self.param_groups[0]
        out: Dict[str, object] = {"count": group["count"]}
        for key in ("mu", "nu", "ema"):
            if key == "ema" and not self.ema_decay:
                continue
            out[key] = {n: self.state[p][key] for n, p in zip(self.names, group["params"])}
        return out

    @torch.no_grad()
    def load_named_state(self, state: Dict[str, object]) -> None:
        """Load what `named_state` returns (or convert.opt_state_from_optax)."""
        group = self.param_groups[0]
        group["count"] = int(state["count"])
        for key in ("mu", "nu", "ema"):
            if key == "ema" and not self.ema_decay:
                continue
            for n, p in zip(self.names, group["params"]):
                self.state[p][key].copy_(state[key][n])

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
