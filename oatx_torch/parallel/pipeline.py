"""GPipe pipeline stages over the model axis (port of oatx/parallel/pipeline.py:
`stage_block_specs` and `pipeline_blocks`, :35-120).

Under `trainer.pipeline` with a model axis of P > 1 (parallel/mesh.py) the
model group of a data position is P stages of the video tower's block
stack: stage s, the rank of model rank s, holds blocks [s·L/P, (s + 1)·L/P)
(`Layout.stage_blocks`, oatx's `stage_block_specs`; parallel/sharding.py
`place_pipeline` drops the other blocks) and every other parameter whole.
Every stage computes the embedding and the heads after the stack; only
stage 0 feeds the embedding into the stack, and every stage reads the
stack's output.

`pipeline_blocks(blocks, x, stages, microbatches, layout)` runs x (B, T, D),
the same on every stage of the group, through the stack, as oatx's does:
  * the forward: stage s splits the rows into M micro-batches and runs
    micro-batch m through its blocks once its input is there: stage 0
    takes x's rows, stage s > 0 receives the previous stage's output
    (`collectives.recv_from`), and every stage but the last sends its
    output on (`send_to`, 'pp_send'). Micro-batch m is on stage s at tick
    m + s of oatx's M + P − 1 ticks; oatx also runs the bubble ticks, on a
    clamped or zero input whose output is never read (its :92-99), the
    port skips them: a stage runs its blocks M times a forward, so kernels
    1 and 2 launch L/P × M times on a rank;
  * the last stage puts the outputs back together in micro-batch order and
    broadcasts them to the model group ('pp_bcast'), oatx's psum of the
    last stage's `collected`: every stage returns the same (B, T, D);
  * the backward runs the reverse schedule, micro-batch M − 1 first: the
    last stage backpropagates its own cotangent of the output (the model
    group's ranks compute the same loss, so each holds the same cotangent;
    taking the last stage's, not a sum over stages, is the broadcast's
    transpose), every stage sends the cotangent of its input to the
    previous stage ('pp_grad') and receives its output's from the next,
    and stage 0 ends with d(x). The other stages return no gradient for x:
    their embedding gets its gradient from stage 0 through the model
    group's sum (sharding.reduce_model_partials).
The blocks' gradients accumulate into their `.grad` during the backward;
the heads after the stack are computed identically on every stage, so
their gradients are whole on each stage and are not summed.

Design: one autograd.Function a call. Its forward records, for each
micro-batch, the stage's graph from a detached input to its output (under
remat each block inside is checkpointed as in the tower's loop); its
backward walks the micro-batches and calls `torch.autograd.backward` on
each (a reentrant backward, as torch's reentrant checkpoint makes). Every
send and receive sits at a fixed place of that program, micro-batch by
micro-batch, and every dependency points one way along the stages (a stage
receives from s − 1 before it sends to s + 1 in the forward, from s + 1
before it sends to s − 1 in the backward), so blocking sends cannot
deadlock under NCCL or gloo. A rank runs its backward on one thread, and
the nodes of the reentrant backward run ahead of the outer graph's
(their higher reentrant depth), so when a forward calls the tower twice
(global_local's object frame) the two calls' backwards never interleave;
they run in the same order on every stage because the graph above them,
the heads and the loss, is the same on every stage.

Without a grad (validation) the forward splits the rows into min(M, B)
micro-batches of sizes that may differ (oatx runs its eval forward
sequentially; the rows are independent either way); with one, B must
divide by M, as oatx asserts.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel.mesh import Layout


@dataclasses.dataclass(frozen=True, eq=False)
class _Schedule:
    run: Callable[[torch.Tensor], torch.Tensor]
    micro: int
    first: bool
    last: bool
    prev: Optional[int]
    next: Optional[int]
    src: int
    group: object  # the model group (None: the whole world), when stages > 1
    bcast: bool
    grad: bool


def _splits(b: int, micro: int, grad: bool) -> List[int]:
    """Rows of each micro-batch: M equal parts under a grad, else min(M, B)
    parts as equal as they go."""
    if grad:
        if b % micro:
            raise ValueError(f"batch {b} not divisible by {micro} microbatches")
        return [b // micro] * micro
    n = max(1, min(micro, b))
    return [b // n + (1 if i < b % n else 0) for i in range(n)]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sched: _Schedule, *params):
        rows = _splits(x.shape[0], sched.micro, sched.grad)
        chunks = x.split(rows)
        ins, outs = [], []
        grad = torch.enable_grad() if sched.grad else contextlib.nullcontext()
        for chunk in chunks:
            h = chunk if sched.first else coll.recv_from(chunk.shape, x.dtype, x.device,
                                                         sched.prev)
            if sched.grad:
                h = h.detach().requires_grad_(True)
            with grad:
                y = sched.run(h)
            if not sched.last:
                coll.send_to(y.detach(), sched.next, "pp_send")
            ins.append(h)
            outs.append(y)
        with torch.no_grad():
            out = torch.cat(outs) if sched.last else torch.empty_like(x)
        if sched.bcast:
            coll.broadcast_from(out, sched.src, sched.group, "pp_bcast")
        ctx.sched, ctx.rows = sched, rows
        ctx.ins, ctx.outs = (ins, outs) if sched.grad else (None, None)
        return out

    @staticmethod
    def backward(ctx, dy):
        sched, ins, outs = ctx.sched, ctx.ins, ctx.outs
        ctx.ins = ctx.outs = None
        if outs is None:
            raise RuntimeError("pipeline_blocks: a backward through a forward run "
                               "without a grad")
        dys = dy.split(ctx.rows) if sched.last else None
        dxs: List[Optional[torch.Tensor]] = [None] * len(outs)
        for m in reversed(range(len(outs))):
            y, h = outs[m], ins[m]
            g = dys[m] if sched.last else coll.recv_from(y.shape, y.dtype, y.device,
                                                         sched.next)
            torch.autograd.backward(y, g)
            outs[m] = None
            gx = h.grad if h.grad is not None else torch.zeros_like(h)
            if sched.first:
                dxs[m] = gx
            else:
                coll.send_to(gx, sched.prev, "pp_grad")
            ins[m] = None
        dx = torch.cat(dxs) if sched.first else None
        return (dx, None) + (None,) * (len(ctx.needs_input_grad) - 2)


def pipeline_blocks(blocks: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                    x: torch.Tensor, stages: int, microbatches: int, layout: Layout,
                    params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """x (B, T, D), the same on every stage of this rank's model group,
    through the whole block stack, pipelined over `stages` = the model
    axis' width with `microbatches` GPipe micro-batches (module docstring)
    → (B, T, D) on every stage. `blocks`: this rank's stage's blocks in
    order, each a callable h → h; `params`: the tensors they train, which
    tie the call into the autograd graph."""
    if stages != layout.model_parallel:
        raise ValueError(f"pipeline_stages={stages} must equal the model axis "
                         f"(model_parallel={layout.model_parallel})")
    params = [p for p in params if p.requires_grad]
    grad = torch.is_grad_enabled() and (x.requires_grad or bool(params))

    def run(h):
        for blk in blocks:
            h = blk(h)
        return h

    ranks = layout.model_ranks()
    sched = _Schedule(run, microbatches, layout.prev_stage is None,
                      layout.next_stage is None, layout.prev_stage, layout.next_stage,
                      ranks[-1], coll.model_group(layout) if stages > 1 else None,
                      stages > 1, grad)
    return _Pipeline.apply(x, sched, *params)
