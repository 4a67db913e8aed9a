"""Optimizers, LR schedules and parameter freezing (port of
oatx/train/optim.py:19-224).

Each family computes what oatx's optax chain computes (`make_optimizer`'s
`kind`, oatx :72-132), not what torch.optim does. Every family composes
the same way:

    clip_by_global_norm(grad_clip)     optional; g ← g·c/‖g‖ when ‖g‖ ≥ c
    the family's update                below
    freeze mask                        frozen params get no update (their
                                       state still moves, as in optax)
    EMA                                ema ← d·ema + (1 − d)·p after the update

  AdamW      scale_by_adam(b1, b2, eps): mu, nu; bias-corrected
             mu_hat/(√nu_hat + eps); then + wd·p, × −lr(count). State:
             mu, nu.
  Adafactor  optax.adafactor(lr, multiply_by_parameter_scale=False,
             weight_decay_rate=wd or None), optax 0.2.6's defaults: β2 =
             1 − t^−0.8 at step t (the first step takes g² alone), g² +
             1e-30; a leaf whose second-largest dim is at least 128 keeps
             v_row and v_col, the running means of g² over its largest and
             its second-largest dim, and is updated by g·(v_row /
             mean(v_row))^−½·v_col^−½; any other leaf keeps a whole v and
             is updated by g·v^−½. The update is divided by max(1, rms(u)),
             the RMS over the whole oatx leaf, × lr, then − wd·p: the decay
             is not scaled by lr (at lr 0 a step still takes wd of every
             parameter). State: v_row and v_col, or v.
  Lion       optax.lion: u = sign((1 − b1)·g + b1·mu), mu ← b2·mu + (1 −
             b2)·g; then + wd·p, × −lr. State: mu.
  SGD        optax.trace(b1, nesterov=True): trace ← g + b1·trace, u = g +
             b1·trace; then + wd·p, × −lr (the decay never enters the
             trace). State: trace.

betas=None is (0.9, 0.99) for Lion and (0.9, 0.999) otherwise. The lr is
read at the count before the step's increment.

"Leaf" is oatx's: oatx stacks each layer list on a leading depth axis
(parallel/sharding.py `oatx_leaf`), so `video_model.blocks.3.mlp.fc1.weight`
is layer 3 of a (12, 768, 3072) leaf. Adafactor factors the dims of that
leaf (sharding.factoring; a stacked bias (12, 768) keeps a whole v, as 12 <
128), holds a parameter's v_row and v_col as its layer's slice of oatx's,
in oatx's layout of the layer (a Linear's (in, out)), and takes the block
RMS over all layers of the leaf together.

A parameter without a gradient is given a zero gradient, as optax sees one:
its state decays and weight decay still applies. The global-norm clip is
optax's formula, written out here: `torch.nn.utils.clip_grad_norm_` adds
1e-6 to the norm. The elementwise updates run on torch's `_foreach` kernels
over all parameters at once; Adafactor's factored ones run per parameter.

Sharded state (parallel/sharding.py): under `zero1` (the `zero1` argument,
{name: FlatShard}) each rank holds the elementwise state (mu, nu, v, trace,
ema) for its share of each sharded parameter only: it takes its share of
the parameter and of the (already averaged) gradient, updates that share,
and all-gathers the updated shares into the whole parameter, which every
rank holds. Under `fsdp` the parameters themselves are shares
(`sharding.place`), so the update runs on them as on whole tensors. Under a
model axis (parallel/sharding.py) a split parameter is the rank's part of
the whole, and its elementwise state is too. Either way the clip and
`grad_norm` read the norm of the whole gradient: the squares of the
data-axis shares summed over the data axis, those of the model-axis parts
summed over the model group, and the replicated gradients counted once, the
same value on every rank (optax's global norm of the whole tree). Under
pipeline stages a rank holds its stage's video blocks and every other
parameter whole: the squares of the blocks' gradients are summed over the
model group, each stage's counted once, and the rest once.

Adafactor's factored v_row and v_col are whole on the data axis, under
zero1 and fsdp alike (oatx's opt_leaf_zero1_sharding would split them too;
they are rows + cols a leaf against its rows × cols, and whole they need no
gather to update a share). On the model axis each is split where
the dim it keeps is: a column-parallel fc1's v_col (its output) is the
rank's part, its v_row whole. So every mean stays the whole leaf's: under
zero1 the row and column sums of g² come from the whole gradient every
rank holds; an fsdp share, cut into boxes of its tensor (`_boxes`), adds
each box's sums into the rows and columns it touches, and the sums are
summed over the data axis ('factor_sums' in collectives.TRAFFIC); then the
sums over a split dim over the model group ('factor_split'), and
mean(v_row) over a split dim too ('factor_mean'). A share's update is
computed box by box on the share itself: no rank builds a tensor of a
parameter's whole size for a share. The
block RMS sums each leaf's squares over every rank holding a part of it:
its data-axis shares, its model-axis parts and, for a stacked video block
under pipeline stages, the stages ('block_rms', one all-reduce a group of
ranks). `named_state` / `load_named_state` keep the schema of whole
tensors, gathering and slicing one tensor at a time (another stage's state
comes from its rank of the model group: parallel/sharding.py `StagePlan`).

`make_optimizer` returns a factory: call it with `model.named_parameters()`
(train/step.py `init_state` does). Trainable filters take the parameter's
state_dict name split on '.', e.g. ('txt_proj', '1', 'weight'), so oatx's
`linear_probe_filter` keeps its meaning.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

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


class Family(torch.optim.Optimizer):
    """What every family shares (module docstring): the global-norm clip,
    the LR schedule, zero1's shares, the freeze mask, the EMA and the state
    in whole tensors. A family names its per-parameter state in `KEYS`
    (tensors shaped like what the rank holds of the parameter) and defines
    `_update(group, count, params, held, grads, whole)`: the update to add
    to each held part at step `count` (1 for the first), the clipped
    gradients of the held parts in (`whole`: the same before zero1 takes
    its shares), −lr·(…) out. The step count is the param group's
    `count`."""

    KEYS: Tuple[str, ...] = ()

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: Union[float, Schedule] = 2e-4, weight_decay: float = 0.01,
                 grad_clip: Optional[float] = None,
                 trainable_filter: Optional[PathFilter] = None,
                 ema_decay: Optional[float] = None, zero1: Optional[Dict] = None,
                 **hyper):
        named = list(named_params)
        self.schedule = lr if callable(lr) else None
        super().__init__([p for _, p in named],
                         dict(lr=0.0 if callable(lr) else lr, weight_decay=weight_decay,
                              count=0, **hyper))
        self.names = [n for n, _ in named]
        self.grad_clip = grad_clip
        self.ema_decay = ema_decay
        self.trainable = [trainable_filter is None or bool(trainable_filter(tuple(n.split("."))))
                          for n in self.names]
        self.zero1 = [(zero1 or {}).get(n) for n in self.names]
        self._setup()
        with torch.no_grad():
            for i, (p, spec) in enumerate(zip(self.param_groups[0]["params"], self.zero1)):
                held = spec.take(p) if spec is not None else p.detach()
                st = self.state[p]
                for key in self.KEYS:
                    if self._has(self.names[i], key):
                        st[key] = self._zeros(i, key, held)
                if ema_decay:
                    st["ema"] = held.clone()

    def _setup(self) -> None:
        """A family's own preparation, before its state is made."""

    def _zeros(self, i: int, key: str, held: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(held)

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
            raise NotImplementedError(f"{type(self).__name__}.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
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
        taken = [spec.take(g) if spec is not None else g for g, spec in zip(grads, self.zero1)]
        upd = self._update(group, count, params, held, taken, grads)
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
    def _decayed(upd: List[torch.Tensor], held, group) -> List[torch.Tensor]:
        """optax's add_decayed_weights then scale_by_learning_rate:
        upd ← −lr·(upd + wd·p), in place."""
        if group["weight_decay"]:
            torch._foreach_add_(upd, held, alpha=group["weight_decay"])
        torch._foreach_mul_(upd, -group["lr"])
        return upd

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

    def _all_keys(self) -> Tuple[str, ...]:
        return self.KEYS + (("ema",) if self.ema_decay else ())

    def _has(self, name: str, key: str) -> bool:
        """Whether parameter `name` (any stage's) holds state `key`."""
        return True

    def _like(self, name: str, key: str):
        """(whole shape, dtype) of `name`'s state `key` where it is not the
        parameter's (None: the parameter's)."""
        return None

    def _whole(self, i: int, p: torch.Tensor, key: str) -> torch.Tensor:
        """State `key` of parameter i, whole (every rank of its groups calls
        it)."""
        return sharding.held_whole(self.state[p][key], p, "state_gather", self._spec(i, p))

    def _part(self, i: int, p: torch.Tensor, key: str, full: torch.Tensor) -> torch.Tensor:
        """What this rank holds of a whole state tensor (_whole's inverse)."""
        return sharding.held_part(full, p, self._spec(i, p))

    def named_state(self, to_host: bool = False,
                    keep: bool = True) -> Optional[Dict[str, object]]:
        """{'count', the family's keys[, 'ema']}, each keyed by parameter
        name, whole: a rank's shares, model-axis parts and other stages'
        state are gathered one tensor at a time (every rank must call it
        then); `to_host` copies each to the CPU. `keep=False` (a rank that
        writes no snapshot): take part in each gather, keep nothing, →
        None."""
        group = self.param_groups[0]
        out: Dict[str, object] = {"count": group["count"]}
        stages = next((_stage_of(p) for p in group["params"] if _stage_of(p) is not None),
                      None)
        index = {n: i for i, n in enumerate(self.names)}
        for key in self._all_keys():
            out[key] = {}
            for n in (stages.params if stages is not None else self.names):
                if not self._has(n, key):
                    continue
                i = index.get(n)
                t = None
                if i is not None:
                    t = self._whole(i, group["params"][i], key)
                if stages is not None and stages.owner(n) is not None:
                    t = stages.fetch(n, t, self._like(n, key))
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
        whole tensors on any device, of which a rank keeps its parts."""
        have = sorted(set(state) - {"count", "ema"})
        if have != sorted(self.KEYS) or (self.ema_decay and "ema" not in state):
            raise ValueError(f"{type(self).__name__} keeps {list(self._all_keys())}; the "
                             f"state given holds {have}: another optimizer's")
        group = self.param_groups[0]
        group["count"] = int(state["count"])
        for key in self._all_keys():
            for i, (n, p) in enumerate(zip(self.names, group["params"])):
                if self._has(n, key):
                    self.state[p][key].copy_(self._part(i, p, key, state[key][n]))


class AdamW(Family):
    """optax.adamw: mu, nu (bias-corrected mu_hat / (√nu_hat + eps)), then
    + wd·p and × −lr. State per parameter: `mu`, `nu`."""

    KEYS = ("mu", "nu")

    def __init__(self, named_params, lr: Union[float, Schedule] = 2e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, **kw):
        super().__init__(named_params, lr, weight_decay, betas=betas, eps=eps, **kw)

    def _update(self, group, count, params, held, grads, whole):
        b1, b2 = group["betas"]
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
        return self._decayed(upd, held, group)


class Lion(Family):
    """optax.lion: u = sign((1 − b1)·g + b1·mu), then mu ← b2·mu + (1 − b2)·g,
    then + wd·p and × −lr. State per parameter: `mu`."""

    KEYS = ("mu",)

    def __init__(self, named_params, lr: Union[float, Schedule] = 2e-4,
                 betas: Tuple[float, float] = (0.9, 0.99), weight_decay: float = 0.01, **kw):
        super().__init__(named_params, lr, weight_decay, betas=betas, **kw)

    def _update(self, group, count, params, held, grads, whole):
        b1, b2 = group["betas"]
        mus = [self.state[p]["mu"] for p in params]
        upd = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(upd, mus, alpha=b1)
        torch._foreach_sign_(upd)
        torch._foreach_mul_(mus, b2)
        torch._foreach_add_(mus, grads, alpha=1 - b2)
        return self._decayed(upd, held, group)


class SGD(Family):
    """oatx's momentum SGD: optax.trace(b1, nesterov=True) (trace ← g + b1·trace,
    u = g + b1·trace), then + wd·p and × −lr: the decay never enters the
    trace. State per parameter: `trace`."""

    KEYS = ("trace",)

    def __init__(self, named_params, lr: Union[float, Schedule] = 2e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), weight_decay: float = 0.01, **kw):
        super().__init__(named_params, lr, weight_decay, betas=betas, **kw)

    def _update(self, group, count, params, held, grads, whole):
        b1 = group["betas"][0]
        traces = [self.state[p]["trace"] for p in params]
        torch._foreach_mul_(traces, b1)
        torch._foreach_add_(traces, grads)
        upd = torch._foreach_mul(traces, b1)
        torch._foreach_add_(upd, grads)
        return self._decayed(upd, held, group)


@dataclasses.dataclass(frozen=True, eq=False)
class _Factored:
    """How a rank holds one factored parameter (module docstring): its
    sharding.Factoring, the dim of oatx's layer layout that the model axis
    splits (None: whole), and v_row's / v_col's model-axis splits (None:
    whole on the model group)."""
    f: sharding.Factoring
    split: Optional[int]
    row: Optional[sharding.ModelShard]
    col: Optional[sharding.ModelShard]


# optax.adafactor's defaults (optax 0.2.6), the values oatx's chain runs
ADAFACTOR_DECAY = 0.8   # decay_rate: β2 = 1 − t^−0.8 at step t
ADAFACTOR_EPS = 1e-30   # epsilon1, added to g² before averaging
ADAFACTOR_CLIP = 1.0    # clipping_threshold of each leaf's update RMS


class Adafactor(Family):
    """optax.adafactor(lr, multiply_by_parameter_scale=False,
    weight_decay_rate=wd or None) with optax 0.2.6's defaults: factored
    second moments (decay 1 − t^−ADAFACTOR_DECAY at step t, g² +
    ADAFACTOR_EPS averaged), the update clipped to an RMS of ADAFACTOR_CLIP
    over each oatx leaf, × lr, then − wd·p, the decay not scaled by lr.
    State per parameter: `v_row` and `v_col` where sharding.factoring
    factors its leaf, else `v`."""

    KEYS = ("v_row", "v_col", "v")

    def _setup(self) -> None:
        params = self.param_groups[0]["params"]
        stages = next((_stage_of(p) for p in params if _stage_of(p) is not None), None)
        if stages is not None:  # every stage's names, for the depths and the state's schema
            whole = {n: stages.keys[n][0] for n in stages.params}
        else:
            whole = {n: _whole_shape(p) for n, p in zip(self.names, params)}
        depths = sharding._depths(whole)
        self.factorings = {n: sharding.factoring(n, s, depths) for n, s in whole.items()}
        self.plans: List[Optional[_Factored]] = []
        for n, p in zip(self.names, params):
            f = self.factorings[n]
            tp = _split_of(p)
            if f is None:
                self.plans.append(None)
                continue
            split = f.perm.index(tp.dim) if tp is not None else None

            def vec(drop, split=split, tp=tp, f=f):
                if split is None or split == drop:
                    return None
                dims = tuple(s for i, s in enumerate(f.dims) if i != drop)
                return dataclasses.replace(tp, shape=dims, dim=split - (split > drop))

            self.plans.append(_Factored(f, split, vec(f.d0), vec(f.d1)))
        # the oatx leaves, for the block RMS: every layer of a stacked list
        # is one leaf, whose sum of squares gathers its layers' parts. Leaf
        # k's j-th held parameter sums into slot k·width + j of a dense
        # (leaves, width) grid (no atomics: the same sums every run)
        leaves: Dict[str, List[int]] = {}
        for i, n in enumerate(self.names):
            leaves.setdefault(_leaf_key(n), []).append(i)
        members = list(leaves.values())
        self.leaf_of = [0] * len(self.names)
        self.width = max(len(m) for m in members)
        self.slot = [0] * len(self.names)
        for k, m in enumerate(members):
            for j, i in enumerate(m):
                self.leaf_of[i], self.slot[i] = k, k * self.width + j
        sizes = {_leaf_key(n): math.prod(sharding.oatx_leaf(n, s, depths)[0])
                 for n, s in whole.items()}
        self.leaf_numel = [sizes[k] for k in leaves]
        # the groups over which a leaf's sum gathers the other parts, in
        # order: its data-axis shares, its model-axis parts, its stages
        first = [(m[0], params[m[0]]) for m in members]
        self.leaf_groups = []
        for part_of in (lambda i, p: self._spec(i, p), lambda i, p: _split_of(p),
                        lambda i, p: _stage_of(p)):
            ks = [k for k, (i, p) in enumerate(first) if part_of(i, p) is not None]
            if ks:
                self.leaf_groups.append((part_of(*first[ks[0]]).group, ks))
        self._on: Dict[torch.device, tuple] = {}

    def _zeros(self, i, key, held):
        plan = self.plans[i]
        if key == "v":
            return torch.zeros_like(held)
        shape = plan.f.row_shape if key == "v_row" else plan.f.col_shape
        spec = plan.row if key == "v_row" else plan.col
        return held.new_zeros(spec.local_shape if spec is not None else shape)

    def _has(self, name: str, key: str) -> bool:
        if key == "ema":
            return True
        return (key == "v") == (self.factorings[name] is None)

    def _like(self, name: str, key: str):
        f = self.factorings[name]
        if key in ("v_row", "v_col"):
            return (f.row_shape if key == "v_row" else f.col_shape), torch.float32
        return None

    def _split(self, i: int, key: str):
        """The model-axis split of parameter i's v_row or v_col (None:
        whole)."""
        return self.plans[i].row if key == "v_row" else self.plans[i].col

    def _whole(self, i, p, key):
        if key not in ("v_row", "v_col"):
            return super()._whole(i, p, key)
        spec, t = self._split(i, key), self.state[p][key]
        return spec.gather(t, "state_gather") if spec is not None else t

    def _part(self, i, p, key, full):
        if key not in ("v_row", "v_col"):
            return super()._part(i, p, key, full)
        spec = self._split(i, key)
        return spec.take(full) if spec is not None else full

    def _indices(self, dev: torch.device):
        """The block RMS's index tensors on `dev`, made once: (slots, leaf
        of each parameter, each leaf group's leaves, leaf sizes)."""
        if dev not in self._on:
            self._on[dev] = (torch.as_tensor(self.slot, device=dev),
                             torch.as_tensor(self.leaf_of, device=dev),
                             [torch.as_tensor(ks, device=dev) for _, ks in self.leaf_groups],
                             torch.as_tensor(self.leaf_numel, dtype=torch.float32, device=dev))
        return self._on[dev]

    def _update(self, group, count, params, held, grads, whole):
        beta = float(np.float32(1) - np.float32(count) ** np.float32(-ADAFACTOR_DECAY))
        rest = float(np.float32(1) - np.float32(beta))
        n = len(params)
        upd: List[Optional[torch.Tensor]] = [None] * n
        whole_v = [i for i in range(n) if self.plans[i] is None]
        if whole_v:
            vs = [self.state[params[i]]["v"] for i in whole_v]
            gs = [grads[i] for i in whole_v]
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_add_(sq, ADAFACTOR_EPS)
            torch._foreach_mul_(vs, beta)
            torch._foreach_add_(vs, sq, alpha=rest)
            u = torch._foreach_rsqrt(vs)
            torch._foreach_mul_(u, gs)
            for i, t in zip(whole_v, u):
                upd[i] = t
        fac = [i for i in range(n) if self.plans[i] is not None]
        # the row and column sums of g² + eps of the model-local tensor:
        # zero1's from the whole gradient, an fsdp share's box by box
        sums = {}
        for i in fac:
            f, st = self.plans[i].f, self.state[params[i]]
            row, col = torch.zeros_like(st["v_row"]), torch.zeros_like(st["v_col"])
            src, spec = ((whole[i], None) if self.zero1[i] is not None
                         else (grads[i], _share_of(params[i])))
            for g, box in _held_boxes(src, spec):
                sq = (g * g + ADAFACTOR_EPS).permute(f.perm)
                row[_cut(box, f, f.d0)] += sq.sum(f.d0)
                col[_cut(box, f, f.d1)] += sq.sum(f.d1)
            sums[i] = [row, col]
        # an fsdp share's sums over the data axis, then the sums over a split
        # dim over the model group: the means of the whole leaf's layer
        self._reduce(sums, [i for i in fac if _share_of(params[i]) is not None],
                     lambda i: (0, 1), lambda i: _share_of(params[i]).group, "factor_sums")
        self._reduce(sums, [i for i in fac if self.plans[i].split in (
            self.plans[i].f.d0, self.plans[i].f.d1)],
                     lambda i: (0,) if self.plans[i].split == self.plans[i].f.d0 else (1,),
                     lambda i: _split_of(params[i]).group, "factor_split")
        means = {}
        for i in fac:
            plan, st = self.plans[i], self.state[params[i]]
            f = plan.f
            st["v_row"].mul_(beta).add_(sums[i][0] / f.dims[f.d0], alpha=rest)
            st["v_col"].mul_(beta).add_(sums[i][1] / f.dims[f.d1], alpha=rest)
            means[i] = [st["v_row"].sum(f.d1 - (f.d1 > f.d0), keepdim=True)]
        self._reduce(means, [i for i in fac if self.plans[i].row is not None
                             and self.plans[i].split == self.plans[i].f.d1],
                     lambda i: (0,), lambda i: _split_of(params[i]).group, "factor_mean")
        # u = g·(v_row / mean(v_row))^−½·v_col^−½ on what the rank holds, box
        # by box (a share's padding stays 0)
        for i in fac:
            plan, st = self.plans[i], self.state[params[i]]
            f = plan.f
            row = (st["v_row"] / (means[i][0] / f.dims[f.d1])).rsqrt()
            col = st["v_col"].rsqrt()
            spec, back = self._spec(i, params[i]), tuple(np.argsort(f.perm))
            u = torch.zeros_like(grads[i]) if spec is not None else torch.empty_like(grads[i])
            for (g, box), (out, _) in zip(_held_boxes(grads[i], spec), _held_boxes(u, spec)):
                out.copy_((g.permute(f.perm) * row[_cut(box, f, f.d0)].unsqueeze(f.d0)
                           * col[_cut(box, f, f.d1)].unsqueeze(f.d1)).permute(back))
            upd[i] = u
        # clip_by_block_rms: each oatx leaf's update to an RMS of at most
        # ADAFACTOR_CLIP, its squares summed over every rank holding a part
        slot, leaf_of, group_leaves, numel = self._indices(upd[0].device)
        sq = torch.stack(torch._foreach_norm(upd)).square()
        leaf = sq.new_zeros(len(self.leaf_numel) * self.width)
        leaf[slot] = sq
        leaf = leaf.view(-1, self.width).sum(1)
        for (grp, _), idx in zip(self.leaf_groups, group_leaves):
            part = leaf.index_select(0, idx)
            coll.all_reduce_sum(part, "block_rms", grp)
            leaf.index_copy_(0, idx, part)
        denom = torch.clamp((leaf / numel).sqrt() / ADAFACTOR_CLIP, min=1.0)
        scale = (group["lr"] / denom)[leaf_of]
        for u, s in zip(upd, scale.unbind()):
            u.mul_(s)
        if group["weight_decay"]:
            torch._foreach_add_(upd, held, alpha=group["weight_decay"])
        torch._foreach_neg_(upd)
        return upd

    @staticmethod
    def _reduce(sums: Dict[int, List[torch.Tensor]], which: List[int], slots, group_of,
                purpose: str) -> None:
        """Sum tensors `slots(i)` of `sums[i]` for each i in `which` over
        `group_of(i)`'s ranks, one all-reduce a group, in place."""
        by_group: Dict[int, Tuple[object, List[Tuple[int, int]]]] = {}
        for i in which:
            g = group_of(i)
            by_group.setdefault(id(g), (g, []))[1].extend((i, j) for j in slots(i))
        for grp, items in by_group.values():
            flat = torch.cat([sums[i][j].reshape(-1) for i, j in items])
            coll.all_reduce_sum(flat, purpose, grp)
            off = 0
            for i, j in items:
                t = sums[i][j]
                sums[i][j] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()


def _boxes(shape: Sequence[int], lo: int, hi: int) -> List[Tuple[slice, ...]]:
    """Elements [lo, hi) of a row-major tensor of `shape` as boxes in order
    (at most 2·ndim − 1), each a tuple of one slice a dim."""
    if lo >= hi:
        return []
    if len(shape) == 1:
        return [(slice(lo, hi),)]
    inner = math.prod(shape[1:])
    a, b = -(-lo // inner), hi // inner  # the whole slices [a, b) of dim 0
    if a > b:  # [lo, hi) inside slice b
        return [(slice(b, b + 1),) + s for s in _boxes(shape[1:], lo - b * inner, hi - b * inner)]
    out = [(slice(a - 1, a),) + s for s in _boxes(shape[1:], lo - (a - 1) * inner, inner)]
    if a < b:
        out.append((slice(a, b),) + tuple(slice(0, d) for d in shape[1:]))
    return out + [(slice(b, b + 1),) + s for s in _boxes(shape[1:], 0, hi - b * inner)]


def _held_boxes(t: torch.Tensor, spec) -> List[Tuple[torch.Tensor, Tuple[slice, ...]]]:
    """What a rank holds of a tensor as (view of `t`, box of the tensor)
    pairs: `t` whole (`spec` None: one box), or `t` the data-axis share
    `spec` (sharding.FlatShard) of it, its padding left out."""
    if spec is None:
        return [(t, tuple(slice(0, d) for d in t.shape))]
    lo, flat, off, out = spec.rank * spec.chunk, t.reshape(-1), 0, []
    for box in _boxes(spec.shape, lo, min(lo + spec.chunk, spec.numel)):
        dims = tuple(s.stop - s.start for s in box)
        out.append((flat[off:off + math.prod(dims)].view(dims), box))
        off += math.prod(dims)
    return out


def _cut(box: Tuple[slice, ...], f: sharding.Factoring, drop: int) -> Tuple[slice, ...]:
    """The part of v_row (`drop` f.d0) or v_col (f.d1) that a box of the
    port's tensor touches."""
    return tuple(box[f.perm[j]] for j in range(len(f.perm)) if j != drop)


def _whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The whole shape of the tensor a held parameter is part of."""
    if _split_of(p) is not None:
        return _split_of(p).shape
    if _share_of(p) is not None:
        return _share_of(p).shape
    return tuple(p.shape)


def _leaf_key(name: str) -> str:
    """The oatx leaf of a parameter: its name with a stacked layer's index
    replaced by '*'."""
    m = sharding._STACKED.match(name)
    return f"{m.group(1)}.*.{m.group(3)}" if m else name


FAMILIES = {"adamw": AdamW, "adafactor": Adafactor, "lion": Lion, "sgd": SGD}


def make_optimizer(lr: Union[float, Schedule] = 2e-4, weight_decay: float = 0.01,
                   betas: Optional[Tuple[float, float]] = None, eps: float = 1e-8,
                   grad_clip: Optional[float] = None,
                   trainable_filter: Optional[PathFilter] = None,
                   ema_decay: Optional[float] = None,
                   kind: str = "adamw") -> Callable[..., Family]:
    """Optimizer factory (`optimizer.type`, any case): → a callable taking
    `model.named_parameters()` (and `zero1`). `betas=None` is (0.9, 0.99)
    for lion and (0.9, 0.999) otherwise (Adafactor takes none); explicit
    betas are taken as given; `eps` is AdamW's."""
    k = kind.lower()
    if k not in FAMILIES:
        raise ValueError(f"unknown optimizer type {kind!r} "
                         "(expected adamw|adafactor|lion|sgd)")
    if ema_decay and not 0.0 < ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    kw = dict(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
              trainable_filter=trainable_filter, ema_decay=ema_decay)
    if k == "adamw":
        kw.update(betas=betas or (0.9, 0.999), eps=eps)
    elif k != "adafactor":
        kw.update(betas=betas or ((0.9, 0.99) if k == "lion" else (0.9, 0.999)))
    return functools.partial(FAMILIES[k], **kw)


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
