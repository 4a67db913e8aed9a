"""One rank of the port's data-parallel tests (tests/test_torch_dp.py,
tests/test_torch_dp_trainer.py). Imports torch, numpy and oatx_torch only.

    python tests/torch_dp_worker.py MODE RANK WORLD INIT_URL IN OUT

joins a gloo group (INIT_URL, a file:// rendezvous; a 120 s timeout), runs
MODE on the CPU with one thread, writes its results with torch.save to
OUT.rank{RANK}, and leaves the group. IN is a torch.save'd payload the
test wrote:
  collectives  {'x': (world·B, D) rows, 'w': (world·B, D), 'video_u8',
               'object_u8': uint8 clips, 'seed', 'transform_cfg'}:
               all_gather_rows and
               mean_across_ranks forward and backward through a shared
               parameter, reduce_gradients in small buckets,
               all_gather_ragged, broadcast_tensors,
               norm_softmax_loss_global, and the train augmenter on the
               rank's rows;
  step         {'cases': {name: {'cfg', 'state_dict', 'batch' (the global
               batch), 'loss_cfg', 'step' (make_train_step's keywords)}}}:
               one train step per case on the rank's rows, with every
               all_reduce the step sends counted by a wrapper around
               torch.distributed.all_reduce;
  trainer      {'raw': the experiment, 'clips': MemoryClips' keywords,
               'batch' (per rank), 'save_dir' (its '{rank}' filled in),
               'log_dir', 'resume', 'global_batches', 'sigterm': (rank,
               step) to signal that rank after that step}: Trainer.train()
               over the rank's shard of
               MemoryClips (with 'global_batches' n at a world of 1: the
               batches of n shards concatenated, data/loader.py
               GlobalBatches), with a tracker of its own under
               log_dir/tracker{rank}, recording each step's metrics, the
               history and the final parameters;
  shard        {'cases': {name: {'cfg', 'state_dict', 'batches' (global
               batches, one a step), 'loss_cfg', 'mode' ('fsdp', 'zero1'
               or None), 'dcn', 'min_size', 'opt' (make_optimizer's
               keywords), 'freeze' (top-level subtrees the optimizer
               leaves as they are), 'step' (make_train_step's)}}}: the steps of each
               case on the rank's rows with the state placed by `mode`
               (parallel/sharding.py): per step the metrics; after step 1
               the whole gradients; at the end the whole parameters and
               optimizer state, the held and predicted state bytes, each
               share's size and the collectives' traffic;
  tp           {'cases': {name: shard's case keys + 'mp' (the model axis'
               width)}}: shard's steps on the rows of the rank's data
               position, the model split over its model group
               (parallel/sharding.py): per step the metrics; after step 1
               the whole gradients (shares and model-axis parts gathered)
               and the traffic; at the end the whole parameters and
               optimizer state, the held and predicted state bytes, the
               split parameters' names; with 'saved' the bytes of the video
               blocks' inputs that the first forward saves for the backward
               (saved_tensors_hooks);
  tp_trainer   {'jobs': [{'raw', 'save_dir', 'resume', 'min_size'}], 'clips', 'batch'
               (per data position), 'log_dir', 'eval_augment'}: Trainer.train()
               per job over the shard of MemoryClips of the rank's data
               position (the model peers read the same rows), with the
               eval transform in place of train_augment when
               'eval_augment'; records each step's loss terms and
               input_ids, the whole state the Trainer holds once built
               (after a resume: what it restored) and at the end;
  pp           {'blocks': {name: {'cfg' (a SpaceTimeViTConfig), 'state_dict'
               (the tower's), 'x' (B, T, D), 'w' (its cotangent), 'mp'
               (stages), 'micro'}}, 'towers': {name: the same with 'video'
               (B, F, H, W, C) for 'x'}, 'cases': {name: tp's case keys}}:
               pipeline stages over the model axis (parallel/pipeline.py).
               blocks: parallel/pipeline.py pipeline_blocks on the rows of
               the rank's data position and the loss Σ w·out → the output,
               d(x) on stage 0 and the blocks' whole gradients; towers: the
               pipelined tower's forward → its outputs; cases: tp's steps
               with the model placed on its stages → tp's records, the
               whole gradients gathered from the stages, each rank's own
               gradients of what it holds whole, and the traffic a step;
  pp_trainer   {'jobs': [{'raw', 'save_dir', 'resume', 'valid'}], 'clips',
               'batch' (per data position), 'log_dir', 'eval_augment'}:
               tp_trainer's jobs with, where 'valid', a validation loader
               over the position's shard of the clips and every eval
               step's input_ids and embeddings recorded; a job whose
               Trainer raises ValueError records the message ('error');
  shard_trainer {'jobs': [{'raw', 'save_dir', 'resume', 'min_size'}], 'clips',
               'batch', 'log_dir'}: Trainer.train() per job over the rank's
               shard of MemoryClips (with 'global_batches' as in trainer),
               recording each step's metrics, the history, init_val, the
               whole parameters and EMA, the held state bytes, and per
               snapshot saved the tensors gathered and the most of them
               alive at once (_watch_saves).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import sys
import weakref

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# no TensorBoard in the ranks: where it is installed its import can cost
# seconds per process (TensorBoardWriter is then a no-op, as without it)
sys.modules.setdefault("torch.utils.tensorboard", None)
sys.modules.setdefault("tensorboardX", None)

from oatx_torch.parallel import collectives as coll  # noqa: E402


def collectives(p, rank, world):
    from oatx_torch.losses import contrastive as C
    from oatx_torch.train import step as steplib

    rows = p["x"].shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    out = {}
    # all_gather_rows: y = gather(x_r @ θ); every rank seeds its own copy of
    # L = Σ w·y, so x_r's gradient is world·w[rows r] and θ's, after the mean
    # of reduce_gradients, the one-process gradient
    theta = torch.nn.Parameter(torch.eye(p["x"].shape[1]) + 0.1)
    x = p["x"][mine].clone().requires_grad_(True)
    y = coll.all_gather_rows(x @ theta)
    (y * p["w"]).sum().backward()
    out["gathered"] = y.detach()
    out["x_grad"] = x.grad
    coll.reduce_gradients([theta])
    out["theta_grad"] = theta.grad
    # mean_across_ranks through θ: L = mean_r(Σ x_r @ θ · w_r)
    theta.grad = None
    m = coll.mean_across_ranks(((p["x"][mine] @ theta) * p["w"][mine]).sum())
    m.backward()
    coll.reduce_gradients([theta])
    out["mean"], out["mean_theta_grad"] = m.detach(), theta.grad
    # reduce_gradients: each element once, whatever the bucket size
    grads = [torch.full((3, 5), float(rank + 1)), torch.arange(7.0) * (rank + 1),
             torch.full((2,), -1.0 * rank)]
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    for q, g in zip(params, grads):
        q.grad = g.clone()
    coll.reset_traffic()
    coll.BUCKET_BYTES = 40
    coll.reduce_gradients(params)
    out["reduced"] = [q.grad for q in params]
    out["reduce_traffic"] = dict(coll.TRAFFIC["grad"])
    # all_gather_ragged: rank r sends r + 1 rows
    out["ragged"] = coll.all_gather_ragged(torch.full((rank + 1, 2), float(rank)))
    # broadcast_tensors: rank 0's values everywhere
    b = [torch.full((4,), float(rank)), torch.full((2, 2), 10.0 + rank)]
    coll.broadcast_tensors(b)
    out["broadcast"] = b
    # the global NormSoftmax and its gradient to this rank's rows
    t = p["x"][mine].clone().requires_grad_(True)
    v = p["w"][mine].clone().requires_grad_(True)
    loss = C.norm_softmax_loss_global(t, v)
    loss.backward()
    out["global_loss"], out["global_t_grad"], out["global_v_grad"] = loss.detach(), t.grad, v.grad
    # the train augmenter: this rank's rows of the global batch's draws
    b_rows = p["video_u8"].shape[0] // world
    aug = steplib.make_augmenter(train=True, tower_cfg=None,
                                 transform_cfg=p["transform_cfg"])
    batch = {"video": p["video_u8"][rank * b_rows:(rank + 1) * b_rows],
             "object_frame": p["object_u8"][rank * b_rows:(rank + 1) * b_rows]}
    out["augmented"] = aug(torch.Generator().manual_seed(p["seed"]), batch)
    return out


def step(p, rank, world):
    from oatx_torch.train import optim
    from oatx_torch.train import step as steplib

    calls = []
    all_reduce = dist.all_reduce

    def counting(t, *a, **k):  # every all_reduce the step sends
        calls.append((t.numel() * t.element_size(), str(t.dtype)))
        return all_reduce(t, *a, **k)

    out = {}
    for name, case in p["cases"].items():
        batch = {k: torch.from_numpy(np.array_split(v, world)[rank])
                 for k, v in case["batch"].items()}
        state = steplib.init_state(case["cfg"], optim.make_optimizer(lr=1e-3), device="cpu",
                                   state_dict=case["state_dict"])
        fn = steplib.make_train_step(case["cfg"], case["loss_cfg"], device="cpu",
                                     **case["step"])
        calls.clear()
        coll.reset_traffic()
        dist.all_reduce = counting
        try:
            state, metrics = fn(state, batch)
        finally:
            dist.all_reduce = all_reduce
        out[name] = {
            "grads": {n: q.grad.clone() for n, q in state.model.named_parameters()
                      if q.grad is not None},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "calls": list(calls), "traffic": {k: dict(v) for k, v in coll.TRAFFIC.items()}}
    return out


def trainer(p, rank, world):
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data.loader import Collator, GlobalBatches, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.train.trainer import Trainer
    from oatx_torch.utils.tracking import ExperimentTracker
    from torch_port_clips import MemoryClips

    exp = ExperimentCfg.from_dict(p["raw"])
    ds = MemoryClips(**p["clips"])
    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions, vocab_size=100),
                   max_text_len=10)
    batch, n = p["batch"], p.get("global_batches") or 0
    if n:  # one process over the global batches of n ranks
        train = [GlobalBatches([ShardedLoader(ds, batch, col, shard_id=r, num_shards=n,
                                              num_workers=1) for r in range(n)])]
    else:
        train = [ShardedLoader(ds, batch, col, shard_id=rank, num_shards=world,
                               num_workers=1)]
    valid = [ShardedLoader(ds, batch, col, shuffle=False, drop_last=False,
                           shard_id=rank, num_shards=world, num_workers=1)]
    steps = []
    # every rank hands the Trainer a live tracker of its own: only rank 0's
    # may receive metrics
    with ExperimentTracker(os.path.join(p["log_dir"], f"tracker{rank}"), "dp") as tracker:
        tr = Trainer(exp, train, valid, save_dir=p["save_dir"].format(rank=rank),
                     log_dir=p["log_dir"],
                     resume=p.get("resume"), tracker=tracker, device="cpu")
        inner = tr.train_step

        def recorded(state, b):
            state, m = inner(state, b)
            steps.append({k: float(v) for k, v in m.items()})
            if p.get("sigterm") == (rank, len(steps)):  # a preemption on this rank alone
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m

        tr.train_step = recorded
        hist = tr.train()
    return {"steps": steps, "hist": hist, "init_val": tr.init_val_log,
            "params": {k: v.clone() for k, v in tr.state.model.state_dict().items()}}


def _whole_grads(model):
    """Every parameter's gradient, whole (fsdp shares and model-axis parts
    gathered)."""
    from oatx_torch.parallel import sharding

    return {n: sharding.held_whole(q.grad, q, "test").clone()
            for n, q in model.named_parameters() if q.grad is not None}


def shard(p, rank, world):
    from oatx_torch.parallel import mesh, sharding
    from oatx_torch.train import optim
    from oatx_torch.train import step as steplib

    out = {}
    for name, case in p["cases"].items():
        sharding.FSDP_MIN_SIZE = case["min_size"]
        layout = mesh.current_layout(case.get("dcn", 1))
        opt_kw = dict(case.get("opt", {}))
        if case.get("freeze"):
            opt_kw["trainable_filter"] = optim.exclude_subtrees(None, case["freeze"])
        state = steplib.init_state(case["cfg"], optim.make_optimizer(**opt_kw),
                                   device="cpu", state_dict=case["state_dict"],
                                   shard_mode=case["mode"], layout=layout)
        fn = steplib.make_train_step(case["cfg"], case["loss_cfg"], device="cpu",
                                     **case.get("step", {}))
        model, opt = state.model, state.optimizer
        shapes = {n: tuple(getattr(q, "_oatx_shard", q).shape) for n, q in
                  model.named_parameters()}
        coll.reset_traffic()
        rec = {"metrics": []}
        for i, b in enumerate(case["batches"]):
            rows = {k: torch.from_numpy(np.array_split(v, world)[rank]) for k, v in b.items()}
            state, m = fn(state, rows)
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                rec["traffic_step1"] = {k: dict(v) for k, v in coll.TRAFFIC.items()}
                rec["grads"] = _whole_grads(model)
                rec["held"] = sharding.held_bytes(model, opt)
        rec["params"] = {k: v.clone() for k, v in sharding.full_state_dict(model).items()}
        rec["opt"] = opt.named_state()
        rec["predicted"] = sharding.state_bytes(shapes, layout.data_size, case["mode"],
                                                ema=bool(opt.ema_decay))
        rec["shares"] = {n: q.numel() for n, q in model.named_parameters()
                         if hasattr(q, "_oatx_shard")}
        rec["moment_shares"] = {n: opt.state[q]["mu"].numel()
                                for n, q, spec in zip(opt.names, opt.param_groups[0]["params"],
                                                      opt.zero1) if spec is not None}
        rec["share_values"] = {n: q.detach().clone() for n, q in model.named_parameters()
                               if hasattr(q, "_oatx_shard")}
        rec["step"] = state.step
        out[name] = rec
    return out


def _saved_block_inputs(model, batch, loss_cfg):
    """Bytes of the video blocks' inputs among the tensors the loss's
    forward saves for the backward (a block input is what a forward
    pre-hook of a block sees)."""
    from oatx_torch.train import step as steplib

    inputs, packed = set(), []
    hooks = [blk.register_forward_pre_hook(
        lambda m, args: inputs.add(args[0].untyped_storage().data_ptr()))
        for blk in model.video_model.blocks]

    def pack(t):
        packed.append((t.untyped_storage().data_ptr(), t.numel() * t.element_size()))
        return t

    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = steplib.loss_fn(model, loss_cfg, batch)
    finally:
        for h in hooks:
            h.remove()
    return sum(n for ptr, n in packed if ptr in inputs)


def tp(p, rank, world):
    from oatx_torch.parallel import mesh, sharding
    from oatx_torch.train import optim
    from oatx_torch.train import step as steplib

    out = {}
    for name, case in p["cases"].items():
        sharding.FSDP_MIN_SIZE = case["min_size"]
        layout = mesh.current_layout(case.get("dcn", 1), case["mp"])
        opt_kw = dict(case.get("opt", {}))
        state = steplib.init_state(case["cfg"], optim.make_optimizer(**opt_kw),
                                   device="cpu", state_dict=case["state_dict"],
                                   shard_mode=case["mode"], layout=layout)
        fn = steplib.make_train_step(case["cfg"], case["loss_cfg"], device="cpu",
                                     **case.get("step", {}))
        model, opt = state.model, state.optimizer
        shapes = {k: tuple(v.shape) for k, v in case["state_dict"].items()}
        rec = {"metrics": [], "layout": {"position": layout.position,
                                         "model_rank": layout.model_rank,
                                         "batch_shards": layout.batch_shards}}

        def rows(b):
            return {k: torch.from_numpy(np.array_split(v, layout.batch_shards)[layout.position])
                    for k, v in b.items()}

        if case.get("saved"):
            rec["saved_block_inputs"] = _saved_block_inputs(model, rows(case["batches"][0]),
                                                            case["loss_cfg"])
            model.zero_grad(set_to_none=True)
        coll.reset_traffic()
        for i, b in enumerate(case["batches"]):
            state, m = fn(state, rows(b))
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                rec["traffic_step1"] = {k: dict(v) for k, v in coll.TRAFFIC.items()}
                rec["grads"] = _whole_grads(model)
                rec["held"] = sharding.held_bytes(model, opt)
                rec["batch_rows"] = rows(b)["input_ids"].clone()
        rec["params"] = sharding.full_state_dict(model)
        rec["opt"] = opt.named_state()
        rec["predicted"] = sharding.state_bytes(shapes, layout.data_size, case["mode"],
                                                ema=bool(opt.ema_decay),
                                                model_parallel=layout.model_parallel)
        rec["split"] = sorted(n for n, q in model.named_parameters()
                              if getattr(q, "_oatx_tp", None) is not None)
        rec["replicated_values"] = {n: q.detach().clone() for n, q in model.named_parameters()
                                    if getattr(q, "_oatx_tp", None) is None
                                    and getattr(q, "_oatx_shard", None) is None}
        rec["step"] = state.step
        out[name] = rec
    return out


def _watch_saves(saves):
    """Wrap checkpoint._payload so that each snapshot appends to `saves`
    {'gathers': the tensors collectives.all_gather_flat returned while it
    was built, 'live_max': the most of those alive at once, counted before
    each gather and once the payload is built}. A rank that keeps no
    gathered tensor past its use shows at most 2: each of the gloo group's
    two worker threads may still hold the output of the work it ran last."""
    from oatx_torch.train import checkpoint

    payload, gather = checkpoint._payload, coll.all_gather_flat

    def watched(*args, **kwargs):
        refs, live = [], [0]

        def count():
            live[0] = max(live[0], sum(r() is not None for r in refs))

        def gathering(*a, **kw):
            count()
            out = gather(*a, **kw)
            refs.append(weakref.ref(out))
            return out

        coll.all_gather_flat = gathering
        try:
            result = payload(*args, **kwargs)
        finally:
            coll.all_gather_flat = gather
        count()
        saves.append({"gathers": len(refs), "live_max": live[0]})
        return result

    checkpoint._payload = watched


def shard_trainer(p, rank, world):
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data.loader import Collator, GlobalBatches, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.parallel import sharding
    from oatx_torch.train.trainer import Trainer
    from torch_port_clips import MemoryClips

    ds = MemoryClips(**p["clips"])
    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions, vocab_size=100),
                   max_text_len=10)
    batch, n = p["batch"], p.get("global_batches") or 0
    out, saves = [], []
    _watch_saves(saves)
    for job in p["jobs"]:
        sharding.FSDP_MIN_SIZE = job["min_size"]
        exp = ExperimentCfg.from_dict(job["raw"])
        if n:
            train = [GlobalBatches([ShardedLoader(ds, batch, col, shard_id=r, num_shards=n,
                                                  num_workers=1) for r in range(n)])]
        else:
            train = [ShardedLoader(ds, batch, col, shard_id=rank, num_shards=world,
                                   num_workers=1)]
        valid = [ShardedLoader(ds, batch, col, shuffle=False, drop_last=False,
                               shard_id=rank, num_shards=world, num_workers=1)]
        steps, first_save = [], len(saves)
        tr = Trainer(exp, train, valid, save_dir=job["save_dir"], log_dir=p["log_dir"],
                     resume=job.get("resume"), device="cpu")
        inner = tr.train_step

        def recorded(state, b, inner=inner, steps=steps):
            state, m = inner(state, b)
            steps.append({k: float(v) for k, v in m.items()})
            return state, m

        tr.train_step = recorded
        hist = tr.train()
        model, opt = tr.state.model, tr.state.optimizer
        params = sharding.full_state_dict(model)
        named = opt.named_state()
        out.append({"steps": steps, "hist": hist, "init_val": tr.init_val_log,
                    "params": {k: v.clone() for k, v in params.items()},
                    "ema": {k: v.clone() for k, v in named.get("ema", {}).items()},
                    "held": sharding.held_bytes(model, opt), "saves": saves[first_save:],
                    "shares": sum(hasattr(q, "_oatx_shard") for q in model.parameters())})
    return out


def _whole_state(state):
    """The model's and AdamW's state, whole (every rank calls it)."""
    from oatx_torch.parallel import sharding

    return {"model": {k: v.clone() for k, v in sharding.full_state_dict(state.model).items()},
            "optimizer": state.optimizer.named_state(to_host=True)}


def tp_trainer(p, rank, world):
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.parallel import mesh, sharding
    from oatx_torch.train import step as steplib
    from oatx_torch.train.trainer import Trainer
    from torch_port_clips import MemoryClips

    if p.get("eval_augment"):
        make = steplib.make_augmenter
        steplib.make_augmenter = lambda *a, **kw: make(train=False, tower_cfg=kw["tower_cfg"])
    ds = MemoryClips(**p["clips"])
    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions, vocab_size=100),
                   max_text_len=10)
    out = []
    for job in p["jobs"]:
        sharding.FSDP_MIN_SIZE = job.get("min_size", sharding.FSDP_MIN_SIZE)
        exp = ExperimentCfg.from_dict(job["raw"])
        layout = mesh.current_layout(exp.trainer.dcn_slices, exp.trainer.model_parallel)
        train = [ShardedLoader(ds, p["batch"], col, seed=0, num_workers=1,
                               shard_id=layout.position, num_shards=layout.batch_shards)]
        tr = Trainer(exp, train, [], save_dir=job["save_dir"], log_dir=p["log_dir"],
                     resume=job.get("resume"), device="cpu")
        built = _whole_state(tr.state)
        inner, steps, ids = tr.train_step, [], []

        def recorded(state, b, inner=inner, steps=steps, ids=ids):
            ids.append(torch.as_tensor(np.asarray(b["input_ids"])).clone())
            state, m = inner(state, b)
            steps.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
            return state, m

        tr.train_step = recorded
        tr.train()
        out.append({"steps": steps, "input_ids": ids, "built": built,
                    "final": _whole_state(tr.state), "position": layout.position})
    return out


def _whole_stage_grads(model):
    """Every parameter's gradient, whole: the other stages' blocks' from
    their ranks (parallel/sharding.py StagePlan), the rest this rank's."""
    from oatx_torch.parallel import sharding

    stages = sharding.stage_plan_of(model)
    own = {n: q.grad for n, q in model.named_parameters()}
    out = {}
    for n in stages.params:
        g = own.get(n)
        if stages.owner(n) is not None:
            g = stages.fetch(n, g)
        if g is not None:
            out[n] = g.clone()
    return out


def _pp_blocks(job, layout, tower):
    """pipeline_blocks on the rank's rows of job['x'] (module docstring)."""
    from oatx_torch.parallel import pipeline, sharding

    rows = np.array_split(np.arange(job["x"].shape[0]), layout.batch_shards)[layout.position]
    x = job["x"][rows].clone().requires_grad_(True)
    mine = [b for b in tower.blocks if b is not None]
    f = tower.cfg.num_frames
    coll.reset_traffic()
    out = pipeline.pipeline_blocks([lambda h, b=b: b(h, f) for b in mine], x, job["mp"],
                                   job["micro"], layout)
    (out * job["w"][rows]).sum().backward()
    traffic = {k: dict(v) for k, v in coll.TRAFFIC.items()}
    grads = {n: q.grad for n, q in tower.named_parameters()}
    stages = sharding.stage_plan_of(tower)
    whole = {n: stages.fetch(n, grads.get(n)).clone() for n in stages.params
             if stages.owner(n) is not None}
    return {"out": out.detach(), "x_grad": x.grad if layout.stage == 0 else None,
            "grads": whole, "traffic": traffic}


def pp(p, rank, world):
    from oatx_torch.models import vit_spacetime as vst
    from oatx_torch.parallel import mesh, sharding
    from oatx_torch.train import optim
    from oatx_torch.train import step as steplib

    out = {"blocks": {}, "towers": {}, "cases": {}}
    for kind in ("blocks", "towers"):
        for name, job in p.get(kind, {}).items():
            layout = mesh.current_layout(job.get("dcn", 1), job["mp"], True)
            tower = vst.SpaceTimeTransformer(job["cfg"], "cpu")
            tower.load_state_dict(job["state_dict"])
            sharding.place_pipeline(tower, layout)
            if kind == "blocks":
                out[kind][name] = _pp_blocks(job, layout, tower)
            else:
                rows = np.array_split(np.arange(job["video"].shape[0]),
                                      layout.batch_shards)[layout.position]
                with torch.no_grad():
                    out[kind][name] = tower(job["video"][rows])
    for name, case in p.get("cases", {}).items():
        layout = mesh.current_layout(case.get("dcn", 1), case["mp"], True)
        state = steplib.init_state(case["cfg"], optim.make_optimizer(**case.get("opt", {})),
                                   device="cpu", state_dict=case["state_dict"],
                                   shard_mode=case["mode"], layout=layout)
        fn = steplib.make_train_step(case["cfg"], case["loss_cfg"], device="cpu",
                                     **case.get("step", {}))
        model, opt = state.model, state.optimizer
        shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
        whole_shapes = {k: tuple(v.shape) for k, v in case["state_dict"].items()
                        if k in sharding.stage_plan_of(model).params}
        rec = {"metrics": [], "layout": {"position": layout.position, "stage": layout.stage,
                                         "batch_shards": layout.batch_shards},
               "held_names": sorted(shapes)}

        def rows(b):
            return {k: torch.from_numpy(np.array_split(v, layout.batch_shards)[layout.position])
                    for k, v in b.items()}

        coll.reset_traffic()
        for i, b in enumerate(case["batches"]):
            state, m = fn(state, rows(b))
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                rec["traffic_step1"] = {k: dict(v) for k, v in coll.TRAFFIC.items()}
                rec["own_grads"] = {n: q.grad.clone() for n, q in model.named_parameters()
                                    if q.grad is not None}
                rec["grads"] = _whole_stage_grads(model)
                rec["held"] = sharding.held_bytes(model, opt)
        rec["params"] = sharding.full_state_dict(model)
        rec["opt"] = opt.named_state()
        rec["predicted"] = sharding.state_bytes(whole_shapes, layout.data_size, case["mode"],
                                                ema=bool(opt.ema_decay),
                                                model_parallel=layout.model_parallel,
                                                pipeline=True)
        rec["replicated_values"] = {n: q.detach().clone() for n, q in model.named_parameters()
                                    if getattr(q, "_oatx_pp", None) is None}
        rec["step"] = state.step
        out["cases"][name] = rec
    return out


def pp_trainer(p, rank, world):
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.parallel import mesh
    from oatx_torch.train import step as steplib
    from oatx_torch.train.trainer import Trainer
    from torch_port_clips import MemoryClips

    if p.get("eval_augment"):
        make = steplib.make_augmenter
        steplib.make_augmenter = lambda *a, **kw: make(train=False, tower_cfg=kw["tower_cfg"])
    ds = MemoryClips(**p["clips"])
    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions, vocab_size=100),
                   max_text_len=10)
    out = []
    for job in p["jobs"]:
        exp = ExperimentCfg.from_dict(job["raw"])
        t = exp.trainer
        layout = mesh.current_layout(t.dcn_slices, t.model_parallel, t.pipeline)
        shard = dict(shard_id=layout.position, num_shards=layout.batch_shards, num_workers=1)
        train = [ShardedLoader(ds, job.get("batch", p["batch"]), col, seed=0, **shard)]
        valid = ([ShardedLoader(ds, p["batch"], col, shuffle=False, drop_last=False, **shard)]
                 if job.get("valid") else [])
        try:
            tr = Trainer(exp, train, valid, save_dir=job["save_dir"], log_dir=p["log_dir"],
                         resume=job.get("resume"), device="cpu")
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        built = _whole_state(tr.state)
        inner, steps, evals = tr.train_step, [], []

        def recorded(state, b, inner=inner, steps=steps):
            state, m = inner(state, b)
            steps.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
            return state, m

        inner_eval = tr.eval_step

        def recorded_eval(model, b, inner_eval=inner_eval, evals=evals):
            res = inner_eval(model, b)
            evals.append({"input_ids": torch.as_tensor(np.asarray(b["input_ids"])).clone(),
                          **{k: v.clone() for k, v in res.items()}})
            return res

        tr.train_step, tr.eval_step = recorded, recorded_eval
        hist = tr.train()
        out.append({"steps": steps, "evals": evals, "hist": hist, "built": built,
                    "final": _whole_state(tr.state), "layout": dataclasses.asdict(layout)})
    return out


def main():
    mode, rank, world, url, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        payload = torch.load(src, weights_only=False)
        out = {"collectives": collectives, "step": step, "trainer": trainer,
               "shard": shard, "shard_trainer": shard_trainer, "tp": tp,
               "tp_trainer": tp_trainer, "pp": pp, "pp_trainer": pp_trainer}[mode](
            payload, rank, world)
        torch.save(out, f"{dst}.rank{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
