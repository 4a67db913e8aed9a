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
  shard_trainer {'jobs': [{'raw', 'save_dir', 'resume', 'min_size'}], 'clips',
               'batch', 'log_dir'}: Trainer.train() per job over the rank's
               shard of MemoryClips (with 'global_batches' as in trainer),
               recording each step's metrics, the history, init_val, the
               whole parameters and EMA, the held state bytes, and per
               snapshot saved the tensors gathered and the most of them
               alive at once (_watch_saves).
"""

from __future__ import annotations

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
    """Every parameter's gradient, whole (fsdp shares gathered)."""
    out = {}
    for n, q in model.named_parameters():
        if q.grad is None:
            continue
        spec = getattr(q, "_oatx_shard", None)
        out[n] = (spec.gather(q.grad, "test") if spec is not None else q.grad).clone()
    return out


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
        fsdp = sharding.fsdp_of(model)
        rec["params"] = fsdp.full_state_dict() if fsdp else dict(model.state_dict())
        rec["params"] = {k: v.clone() for k, v in rec["params"].items()}
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
        fsdp = sharding.fsdp_of(model)
        params = fsdp.full_state_dict() if fsdp else model.state_dict()
        named = opt.named_state()
        out.append({"steps": steps, "hist": hist, "init_val": tr.init_val_log,
                    "params": {k: v.clone() for k, v in params.items()},
                    "ema": {k: v.clone() for k, v in named.get("ema", {}).items()},
                    "held": sharding.held_bytes(model, opt), "saves": saves[first_save:],
                    "shares": sum(hasattr(q, "_oatx_shard") for q in model.parameters())})
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
               "shard": shard, "shard_trainer": shard_trainer}[mode](
            payload, rank, world)
        torch.save(out, f"{dst}.rank{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
