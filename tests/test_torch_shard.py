"""Sharded training state across processes (`zero1`, `fsdp`), the port against
oatx on the CPU.

The port's ranks (tests/torch_dp_worker.py over gloo, one thread each,
started by `launch_dp`) place the state by parallel/sharding.py and train
the tiny geometry (tests/torch_port_helpers.py, TRAIN_*) for 2 steps, each
on its rows of the same global batches. oatx runs the same steps as one
GSPMD program on a CPU mesh of as many of conftest.py's 8 devices, its
parameters placed by `shard_params_fsdp` (or `shard_params` and
`shard_opt_state_zero1`). Both sides use a `min_size` of MIN_SIZE (oatx's
default 2**16 would leave every leaf of this geometry replicated), so most
kernels shard at 2 ranks, and at 3 ranks, where the tiny widths do not
divide, oatx replicates all but the patch embedding.

Tolerances, f32:
  * against oatx: loss terms 1e-4 of scale; parameters and AdamW moments
    after 2 steps within 1e-4 of each tensor's largest entry (plus 1e-8 /
    1e-16 for the moments of gradients that are 0 in real arithmetic). The
    parameters leave out the attention key biases: their gradient is 0 in
    real arithmetic, so AdamW's first updates there are ±lr·sign(rounding
    noise) in either program (tests/test_torch_train.py);
  * against the port's own replicated data-parallel run at the same world:
    losses within 1e-5 relative; step 1's gradients within 5e-6 +
    1e-4·max|ref| (tests/test_torch_dp.py); zero1 updates the same elements
    with the same arithmetic, so its parameters equal the replicated run's
    bitwise;
  * per-rank bytes: what a rank holds (read from the storage of its
    parameters, gradients and moments) equals sharding.state_bytes, is at
    most oatx's per-device bytes on the same tree plus the padding
    state_bytes states, and is less than the replicated state's.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from oatx.parallel import mesh as jmesh
from oatx.parallel import sharding as jshard
from oatx.train import optim as joptim
from oatx.train import step as jstep
from oatx_torch.models.convert import opt_state_from_optax, state_dict_from_oatx
from oatx_torch.parallel import sharding as pshard
from oatx_torch.train import step as pstep
from torch_port_helpers import REPO, TRAIN_LR, launch_dp, oatx_params, to_numpy, train_cfgs

torch.set_num_threads(1)

MIN_SIZE = 256
STEPS = 2
# the launches run at once beside oatx's compiles: more room than a lone
# launch's 150 s when the suite's workers share the CPUs
LAUNCH_TIMEOUT_S = 300
# (world, dcn slices) of the launches held against oatx
LAYOUTS = {"2": (2, 1), "3": (3, 1), "4dcn2": (4, 2)}
RUNS = [(mode, lay) for lay in LAYOUTS for mode in ("fsdp", "zero1")]
OATX_RUNS = [run for run in RUNS if run != ("zero1", "4dcn2")]
OBJ = dict(feature_dim=2054, dim=32, n_heads=4, hidden_dim=64, top_k=4, n_layers=2)


def _batch(n, seed):
    """n clips and captions of the tiny geometry, some captions padded."""
    rng = np.random.default_rng(seed)
    mask = np.ones((n, 6), np.int32)
    mask[1::3, 4:] = 0
    return {"video": rng.standard_normal((n, 2, 32, 32, 3)).astype(np.float32),
            "input_ids": rng.integers(0, 100, (n, 6)).astype(np.int32),
            "attention_mask": mask}


def _batches(world):
    n = {2: 4, 3: 6, 4: 8}[world]
    return [_batch(n, s) for s in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _tiny():
    jcfg, pcfg = train_cfgs()
    return jcfg, pcfg, oatx_params(jcfg)


@functools.lru_cache(maxsize=None)
def _objects():
    """The tiny geometry with stream 3's object tower, from the port's own
    seeded init."""
    import dataclasses

    from oatx_torch.models import object_tower as pobjt
    from oatx_torch.models.towers import DualTower

    pcfg = dataclasses.replace(train_cfgs()[1], object_tower=pobjt.ObjectTowerConfig(**OBJ))
    sd = DualTower(pcfg, "cpu", torch.Generator().manual_seed(1)).state_dict()
    return pcfg, {k: v.clone() for k, v in sd.items()}


def _case(mode, world, dcn=1, opt=None, step=None, batches=None, objects=False,
          freeze=None, weight=0.0, video=None):
    if objects:
        pcfg, sd = _objects()
    else:
        _, pcfg, params = _tiny()
        sd = state_dict_from_oatx(to_numpy(params), pcfg)
    if video:
        import dataclasses

        pcfg = dataclasses.replace(pcfg, video=dataclasses.replace(pcfg.video, **video))
    return {"cfg": pcfg, "state_dict": sd, "batches": batches or _batches(world),
            "mode": mode, "dcn": dcn, "min_size": MIN_SIZE,
            "opt": {"lr": TRAIN_LR, **(opt or {})}, "step": step or {},
            "loss_cfg": pstep.LossConfig(object_nce_weight=weight), "freeze": freeze}


def _nonfinite(batches):
    """Step 1's batch with a NaN in the last rank's rows, then step 2's."""
    bad = {k: v.copy() for k, v in batches[0].items()}
    bad["video"][-1, 0, 0, 0, 0] = np.nan
    return [bad, batches[1]]


def _object_batches():
    out = []
    for s in range(STEPS):
        b = _batch(4, s)
        b["object"] = np.random.default_rng(s + 100).standard_normal(
            (4, OBJ["top_k"], 2054)).astype(np.float32)
        out.append(b)
    return out


OPTIONS = {  # name → the case's keywords (the replicated run takes the same)
    "accum": dict(step={"accum_steps": 2}),
    "clip": dict(opt={"grad_clip": 1.0}),
    "skip": dict(step={"skip_nonfinite": True}, batches=_nonfinite(_batches(2))),
    "ema": dict(opt={"ema_decay": 0.9}),
    "remat": dict(video={"remat": True, "remat_policy": "dots_all"}),
    "fwd_chunk": dict(step={"fwd_chunk": 1}),
    "frozen": dict(objects=True, batches=_object_batches(), weight=0.5,
                   freeze=("object_tower", "obj_proj")),
}


@pytest.fixture(scope="module", autouse=True)
def launches(tmp_path_factory):
    """Every launch of this file, started at once in the background (the
    ranks are processes of their own; oatx's compiles run meanwhile here):
    name → a future of launch_dp's result."""
    tmp = tmp_path_factory.mktemp("shard")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
    out = _trainer_launches(pool, tmp / "trainer")
    out["cli"] = pool.submit(_cli_fsdp, tmp / "cli")
    for lay, (world, dcn) in LAYOUTS.items():
        cases = {m or "rep": _case(m, world, dcn) for m in (None, "fsdp", "zero1")}
        if lay == "2":
            for name, kw in OPTIONS.items():
                for m in (None, "fsdp", "zero1"):
                    cases[f"{m or 'rep'}_{name}"] = _case(m, world, **kw)
        out[lay] = pool.submit(launch_dp, "shard", world, {"cases": cases}, tmp / lay,
                               LAUNCH_TIMEOUT_S)
    yield out
    pool.shutdown(wait=True)


def _ranks(launches):
    """{layout: [rank r's {case: record}]}; the 2-rank launch also runs
    OPTIONS under each mode and replicated."""
    return {lay: launches[lay].result() for lay in LAYOUTS}


@pytest.fixture(scope="module")
def ranks(launches):
    return _ranks(launches)


@functools.lru_cache(maxsize=None)
def _oatx_run(mode, lay):
    """oatx's GSPMD train step on a CPU mesh of the layout's devices, the
    state placed by `mode`, 2 steps → (metrics per step, parameters and
    moments under the port's names, per-device state bytes)."""
    world, dcn = LAYOUTS[lay]
    jcfg, pcfg, params = _tiny()
    mesh = jmesh.make_mesh(n_devices=world, dcn_slices=dcn)
    try:
        tx = joptim.make_optimizer(lr=TRAIN_LR)
        sp = (jshard.shard_params_fsdp(mesh, params, min_size=MIN_SIZE) if mode == "fsdp"
              else jshard.shard_params(mesh, params))
        st = jstep.init_state(None, jcfg, tx, params=sp)
        if mode == "zero1":
            st = jstep.TrainState(st.params, jshard.shard_opt_state_zero1(mesh, st.opt_state),
                                  st.step)

        def nbytes(tree):
            return sum(4 * math.prod(x.sharding.shard_shape(x.shape))
                       for x in jax.tree_util.tree_leaves(tree) if x.ndim > 0)

        p_bytes = nbytes(st.params)
        g_bytes = p_bytes if mode == "fsdp" else 4 * sum(
            x.size for x in jax.tree_util.tree_leaves(st.params))
        moments = jax.tree_util.tree_leaves(st.opt_state)
        device_bytes = p_bytes + g_bytes + nbytes(moments)
        # every leaf on the mesh, step 1's output put back on the placement:
        # step 2 reuses step 1's compile
        placed = jax.tree_util.tree_map(
            lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
            else NamedSharding(mesh, PartitionSpec()), st)
        st = jax.device_put(st, placed)
        fn = jstep.make_train_step(jcfg, jstep.LossConfig(), tx, donate=False)
        metrics = []
        for b in _batches(world):
            st, m = fn(st, jmesh.shard_batch(mesh, b))
            metrics.append({k: float(v) for k, v in m.items()})
            st = jax.device_put(st, placed)
    finally:
        jmesh.set_current_mesh(None)
    return (metrics, state_dict_from_oatx(to_numpy(st.params), pcfg),
            opt_state_from_optax(to_numpy(st.opt_state), pcfg), device_bytes)


def _key_bias_mask(name, shape):
    """False where the gradient is 0 in real arithmetic: the attention key
    biases (DistilBERT's k_lin, the k third of the ViT's fused qkv)."""
    mask = torch.ones(shape, dtype=torch.bool)
    if name.endswith("k_lin.bias"):
        mask[:] = False
    elif name.endswith("qkv.bias"):
        d = shape[0] // 3
        mask[d:2 * d] = False
    return mask


def _close(got, want, scale=1e-4, floor=0.0, mask=None, what=""):
    assert sorted(got) == sorted(want), what
    for n, w in want.items():
        g, w = got[n].float(), torch.as_tensor(np.asarray(w)).float()
        keep = mask(n, w.shape) if mask else torch.ones_like(w, dtype=torch.bool)
        err = (g - w).abs()[keep]
        tol = scale * float(w.abs().max()) + floor
        assert err.numel() == 0 or float(err.max()) <= tol, (what, n, float(err.max()), tol)


# ------------------------------------------------------------- placements
PLACEMENT_CONFIGS = {
    "norm": ("configs/pt/cc3m_webvid/norm.json", {}),
    "vit_huge_pod": ("configs/pt/cc3m_webvid/vit_huge_pod.json", {}),
    "bert_stream3": ("configs/pt/cc3m_webvid/norm.json", {"text": "bert-base-uncased",
                                                          "stream": 3}),
    "clip": ("configs/pt/cc3m_webvid/norm.json", {"text": "clip-vit-b-32"}),
}


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(oatx's abstract params, the port's parameter shapes) at a config's
    full widths, built without weights (jax.eval_shape, the meta device)."""
    from oatx.config import schema as jschema
    from oatx.models import towers as jtowers
    from oatx_torch.config import schema as pschema
    from oatx_torch.models.towers import DualTower

    path, kw = PLACEMENT_CONFIGS[name]
    with open(f"{REPO}/{path}") as f:
        raw = json.load(f)
    raw["trainer"]["model_parallel"] = 1
    if "text" in kw:
        raw["arch"]["args"]["text_params"]["model"] = kw["text"]
    if kw.get("stream") == 3:
        raw["arch"]["stream"] = 3
        raw["arch"]["args"]["object_params"] = {"model": "ObjectTransformer",
                                                "input_objects": True}
    jcfg = jschema.build_tower_config(jschema.ExperimentCfg.from_dict(raw).arch)
    pcfg = pschema.build_tower_config(pschema.ExperimentCfg.from_dict(raw).arch)
    abstract = jax.eval_shape(lambda: jtowers.init(jax.random.PRNGKey(0), jcfg))
    with torch.device("meta"):
        model = DualTower(pcfg, device="meta", generator=torch.Generator())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return abstract, shapes


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("mode", ["fsdp", "zero1"])
@pytest.mark.parametrize("config", list(PLACEMENT_CONFIGS))
def test_placement_bytes_are_oatx_bytes(config, mode, size):
    """At a config's full widths, the per-rank bytes of parameters,
    gradients and moments that sharding.state_bytes gives equal oatx's
    per-device bytes from fsdp_param_specs / opt_leaf_zero1_sharding on a
    data axis of `size`, once the stated padding is taken off: the port
    shards exactly the leaves oatx shards."""
    abstract, shapes = _trees(config)
    leaves = jax.tree_util.tree_leaves(abstract)
    assert sum(math.prod(s) for s in shapes.values()) == sum(x.size for x in leaves)
    mesh = jmesh.make_mesh(n_devices=size)
    try:
        if mode == "fsdp":
            specs = jax.tree_util.tree_leaves(
                jshard.fsdp_param_specs(abstract, mesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            shard = [x.size / (size if "data" in tuple(s) else 1)
                     for x, s in zip(leaves, specs)]
            want = 4 * sum(4 * s for s in shard)  # params, grads, mu, nu
        else:
            moments = [x.size / (size if "data" in tuple(
                jshard.opt_leaf_zero1_sharding(mesh, x).spec) else 1) for x in leaves]
            want = 4 * sum(2 * x.size for x in leaves) + 4 * 2 * sum(moments)
    finally:
        jmesh.set_current_mesh(None)
    got = pshard.state_bytes(shapes, size, mode)
    assert got["bytes"] < got["replicated"]
    assert abs(got["bytes"] - got["padding"] - want) <= 8, (got, want)


def test_norm_json_bytes_per_rank_at_two():
    """norm.json (180,925,184 parameters) over 2 ranks: about 2.90 GB a rank
    replicated, 2.17 GB under zero1, 1.45 GB under fsdp."""
    _, shapes = _trees("norm")
    assert sum(math.prod(s) for s in shapes.values()) == 180_925_184
    gb = {m: pshard.state_bytes(shapes, 2, m)["bytes"] / 1e9 for m in (None, "zero1", "fsdp")}
    assert abs(gb[None] - 2.895) < 0.01
    assert abs(gb["zero1"] - 2.171) < 0.01
    assert abs(gb["fsdp"] - 1.448) < 0.01


# -------------------------------------------------------- against oatx
@pytest.mark.parametrize("mode,lay", OATX_RUNS)
def test_ranks_match_oatx(launches, mode, lay):
    """Loss terms per step, and the whole parameters and moments after 2
    steps (every rank the same), against oatx's GSPMD step under the same
    placement."""
    want_m, want_p, want_opt, _ = _oatx_run(mode, lay)  # while the ranks run
    for rank in _ranks(launches)[lay]:
        got = rank[mode]
        for g, w in zip(got["metrics"], want_m):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4 * abs(w[k]), err_msg=k)
        _close(got["params"], want_p, mask=_key_bias_mask, what="params")
        assert got["opt"]["count"] == want_opt["count"] == STEPS
        _close(got["opt"]["mu"], want_opt["mu"], floor=1e-8, what="mu")
        _close(got["opt"]["nu"], want_opt["nu"], scale=2e-4, floor=1e-16, what="nu")


@pytest.mark.parametrize("mode,lay", RUNS)
def test_ranks_match_the_replicated_run(ranks, mode, lay):
    """Against the port's replicated data-parallel run at the same world:
    losses, step 1's whole gradients; the ranks agree bitwise."""
    for rank in ranks[lay]:
        got, want = rank[mode], rank["rep"]
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
        _close(got["grads"], {k: v.numpy() for k, v in want["grads"].items()},
               floor=5e-6, what="grads")
        if mode == "zero1":
            assert all(torch.equal(got["params"][k], v) for k, v in want["params"].items())
    first = ranks[lay][0][mode]
    for other in ranks[lay][1:]:
        assert other[mode]["metrics"] == first["metrics"]
        assert all(torch.equal(other[mode]["params"][k], v) for k, v in first["params"].items())


@pytest.mark.parametrize("mode,lay", OATX_RUNS)
def test_state_bytes_at_most_oatx(ranks, mode, lay):
    """What each rank holds equals sharding.state_bytes, is at most oatx's
    per-device bytes plus the stated padding, and is less than the
    replicated state; the replicated run holds the replicated state."""
    _, _, _, oatx_bytes = _oatx_run(mode, lay)
    for rank in ranks[lay]:
        got = rank[mode]
        held, pred = got["held"]["total"], got["predicted"]
        assert held == pred["bytes"]
        assert held <= oatx_bytes + pred["padding"], (held, oatx_bytes, pred)
        assert held < pred["replicated"] == rank["rep"]["held"]["total"]


def test_dcn_slices_shard_in_halves(ranks):
    """fsdp at 4 ranks in 2 dcn slices: each share is half a tensor (the
    data axis of a slice is 2 wide), rank r and rank r + 2 hold the same
    share, and the scattered gradients cross the slices once."""
    four = ranks["4dcn2"]
    _, pcfg, _ = _tiny()
    shapes = {k: tuple(v.shape) for k, v in four[0]["rep"]["params"].items()}
    for r in range(4):
        got = four[r]["fsdp"]
        assert got["shares"] and all(n == -(-math.prod(shapes[k]) // 2)
                                     for k, n in got["shares"].items())
        assert all(n == -(-math.prod(shapes[k]) // 2)
                   for k, n in four[r]["zero1"]["moment_shares"].items())
    for r in range(2):
        a, b = four[r]["fsdp"]["share_values"], four[r + 2]["fsdp"]["share_values"]
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], four[1 - r]["fsdp"]["share_values"][k]) for k in a)
    traffic = four[0]["fsdp"]["traffic_step1"]
    assert traffic["grad_cross"]["bytes"] * 2 == traffic["grad_scatter"]["bytes"]


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_collective_bytes_per_step(ranks, lay):
    """fsdp's step 1 reduce-scatters each sharded gradient once, padded
    (4·data_size·share bytes), and all-reduces the replicated ones once;
    it never all-reduces a sharded gradient. zero1 all-reduces every
    gradient once, as the replicated run does, and all-gathers each
    updated share once."""
    world, dcn = LAYOUTS[lay]
    data = world // dcn
    rank = ranks[lay][0]
    numel = {k: v.numel() for k, v in rank["rep"]["params"].items()}
    sharded = rank["fsdp"]["shares"]
    t = rank["fsdp"]["traffic_step1"]
    assert t["grad_scatter"]["bytes"] == 4 * data * sum(sharded.values())
    assert t["grad"]["bytes"] == 4 * sum(n for k, n in numel.items() if k not in sharded)
    assert t["param_gather"]["bytes"] >= 4 * sum(sharded.values())
    z = rank["zero1"]["traffic_step1"]
    assert z["grad"] == rank["rep"]["traffic_step1"]["grad"]
    assert z["param_update"]["bytes"] == 4 * sum(rank["zero1"]["moment_shares"].values())


# ---------------------------------------------------- the rest of the step
@pytest.mark.parametrize("mode", ["fsdp", "zero1"])
@pytest.mark.parametrize("name", ["accum", "clip", "skip", "ema", "remat", "fwd_chunk"])
def test_step_options_match_the_replicated_run(ranks, name, mode):
    """accum_steps 2 (one reduction after the last micro-batch), a clip that
    fires, skip_nonfinite on a batch with a NaN in one rank's rows (every
    rank skips), an EMA, remat dots_all (its recompute gathers the weights
    again), fwd_chunk's checkpointed chunks: the same losses and norms as
    the replicated run, and the same whole parameters (zero1: bitwise) and
    EMA."""
    for rank in ranks["2"]:
        got, want = rank[f"{mode}_{name}"], rank[f"rep_{name}"]
        assert len(got["metrics"]) == STEPS
        for g, w in zip(got["metrics"], want["metrics"]):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        if name == "clip":
            assert all(m["grad_norm"] > 1.0 for m in want["metrics"])
        if name == "skip":
            assert [m["skipped"] for m in got["metrics"]] == [1.0, 0.0]
            assert got["step"] == 1 and got["opt"]["count"] == 1
        if mode == "zero1":
            assert all(torch.equal(got["params"][k], v) for k, v in want["params"].items())
        else:
            _close(got["params"], want["params"], mask=_key_bias_mask, what="params")
        if name == "ema":
            _close(got["opt"]["ema"], want["opt"]["ema"], mask=_key_bias_mask, what="ema")
        if name == "accum" and mode == "fsdp":  # one reduce-scatter for two micro-batches
            assert got["traffic_step1"]["grad_scatter"] == rank["fsdp"]["traffic_step1"][
                "grad_scatter"]
        if name == "remat" and mode == "fsdp":  # the video blocks' weights gathered twice
            blocks = sum(n for k, n in got["shares"].items() if ".blocks." in k)
            assert blocks and got["traffic_step1"]["param_gather"]["bytes"] == \
                rank["fsdp"]["traffic_step1"]["param_gather"]["bytes"] + 4 * blocks


@pytest.mark.parametrize("mode", ["fsdp", "zero1"])
def test_frozen_object_tower_stays_bitwise(ranks, mode):
    """Stream 3's object tower and obj_proj frozen by the trainable filter
    while its NCE term trains the rest: bitwise unchanged on every rank."""
    _, init = _objects()
    for rank in ranks["2"]:
        got = rank[f"{mode}_frozen"]
        frozen = [k for k in init if k.startswith(("object_tower.", "obj_proj."))]
        assert frozen and all(torch.equal(got["params"][k], init[k]) for k in frozen)
        assert not torch.equal(got["params"]["vid_proj.0.weight"], init["vid_proj.0.weight"])
        for g, w in zip(got["metrics"], rank["rep_frozen"]["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)


# ------------------------------------------------------------- trainer
TRAINER_RAW = {
    "name": "shard",
    "arch": {"type": "FrozenInTime", "args": {
        "video_params": {"model": "SpaceTimeTransformer", "arch_config": "base_patch16_224",
                         "num_frames": 2, "input_res": 32, "embed_dim": 32, "depth": 2,
                         "num_heads": 2, "time_init": "random"},
        "text_params": {"model": "distilbert-base-uncased", "vocab_size": 100, "dim": 32,
                        "hidden_dim": 64, "n_layers": 2, "n_heads": 2},
        "projection": "minimal", "projection_dim": 16, "load_checkpoint": ""}},
    "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
    "loss": {"type": "NormSoftmaxLoss", "args": {}},
    "metrics": ["t2v_metrics", "v2t_metrics"],
    "trainer": {"epochs": 2, "save_period": 1, "verbosity": 1, "init_val": True,
                "precision": "f32", "seed": 0, "monitor": "min val_loss_0",
                "ema_decay": 0.9, "ema_eval": True},
}
# 17 clips: the train shards hold 8 each (2 steps an epoch at batch 4), the
# validation shards 9 and 8, so rank 1 runs one validation forward more in
# step with rank 0 under fsdp
CLIPS = dict(n=17, frames=2, canon=48)


def _raw(**trainer):
    raw = json.loads(json.dumps(TRAINER_RAW))
    raw["trainer"].update(trainer)
    return raw


def _job(save_dir, resume=None, **trainer):
    return {"raw": _raw(**trainer), "save_dir": str(save_dir), "resume": resume,
            "min_size": MIN_SIZE}


def _trainer_launches(pool, tmp):
    """fsdp on 2 ranks for 2 epochs; one process over the same global
    batches; and from the fsdp run's checkpoint-epoch1: fsdp and zero1 on 2
    ranks and one process."""
    common = {"clips": CLIPS, "batch": 4, "log_dir": str(tmp / "log")}
    ckpt = str(tmp / "fsdp" / "checkpoint-epoch1")

    def chain():
        fsdp = launch_dp("shard_trainer", 2, {**common, "jobs": [
            _job(tmp / "fsdp", fsdp=True)]}, tmp / "a", LAUNCH_TIMEOUT_S)
        two = pool.submit(launch_dp, "shard_trainer", 2, {**common, "jobs": [
            _job(tmp / "r_fsdp", ckpt, fsdp=True), _job(tmp / "r_zero1", ckpt, zero1=True)]},
            tmp / "b", LAUNCH_TIMEOUT_S)
        one = launch_dp("shard_trainer", 1, {**common, "global_batches": 2, "jobs": [
            _job(tmp / "r_one", ckpt)]}, tmp / "c", LAUNCH_TIMEOUT_S)[0][0]
        two = two.result()
        saves = {"fsdp": [r[0]["saves"] for r in fsdp],
                 "fsdp resumed": [r[0]["saves"] for r in two],
                 "zero1 resumed": [r[1]["saves"] for r in two]}
        return fsdp[0][0], {"fsdp": two[0][0], "zero1": two[0][1], "one": one}, saves

    one = pool.submit(launch_dp, "shard_trainer", 1, {**common, "global_batches": 2,
                                                      "jobs": [_job(tmp / "one")]}, tmp / "d",
                      LAUNCH_TIMEOUT_S)
    return {"trainer_chain": pool.submit(chain), "trainer_one": one, "trainer_tmp": tmp}


@pytest.fixture(scope="module")
def trainers(launches):
    fsdp, resumed, _ = launches["trainer_chain"].result()
    one = launches["trainer_one"].result()[0][0]
    return launches["trainer_tmp"], fsdp, one, resumed


def test_fsdp_trainer_trains_as_one_process(trainers):
    """Trainer.train() under fsdp on 2 ranks against one process over the
    same global batches: every step's loss terms, and the validation of
    the EMA (init_val and both epochs, 17 clips over uneven shards) within
    1e-5 relative; the EMA within 1e-4 of scale; the state is sharded."""
    _, fsdp, one, _ = trainers
    assert len(fsdp["steps"]) == len(one["steps"]) == 4
    for g, w in zip(fsdp["steps"], one["steps"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    logs = [(fsdp["init_val"], one["init_val"])] + [(fsdp["hist"][e], one["hist"][e])
                                                  for e in (1, 2)]
    for got, want in logs:
        keys = [k for k in want if k.startswith("val_")]
        assert keys and sorted(k for k in got if k.startswith("val_")) == sorted(keys)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _close(fsdp["ema"], one["ema"], mask=_key_bias_mask, what="ema")
    assert fsdp["shares"] > 0 and fsdp["held"]["total"] < one["held"]["total"]


@pytest.mark.parametrize("layout", ["fsdp", "zero1", "one"])
def test_resume_across_layouts(trainers, layout):
    """The fsdp snapshot of epoch 1 restores under fsdp at 2 ranks (the
    uninterrupted run's epoch-2 loss terms within 1e-6 relative), under
    zero1 at 2 ranks and in one process (1e-5)."""
    _, fsdp, _, resumed = trainers
    got = resumed[layout]["steps"]
    assert len(got) == 2
    rtol = 1e-6 if layout == "fsdp" else 1e-5
    for g, w in zip(got, fsdp["steps"][2:]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def test_snapshot_schema_is_one_process(trainers):
    """state.pt written by the fsdp ranks holds the keys and whole shapes of
    a one-process snapshot: model, optimizer (count, mu, nu, ema), step."""
    tmp, _, _, _ = trainers
    a = torch.load(tmp / "fsdp" / "checkpoint-epoch1" / "state.pt", weights_only=True)
    b = torch.load(tmp / "one" / "checkpoint-epoch1" / "state.pt", weights_only=True)
    assert sorted(a) == sorted(b) == ["model", "optimizer", "step"]
    assert a["step"] == b["step"] == 2
    assert sorted(a["optimizer"]) == sorted(b["optimizer"]) == ["count", "ema", "mu", "nu"]
    for part in ("model",) + tuple(f"optimizer.{k}" for k in ("mu", "nu", "ema")):
        x, y = (d[part] if part == "model" else d["optimizer"][part.split(".")[1]]
                for d in (a, b))
        assert sorted(x) == sorted(y), part
        assert all(x[k].shape == y[k].shape and x[k].device.type == "cpu" for k in y), part


@pytest.mark.parametrize("run", ["fsdp", "fsdp resumed", "zero1 resumed"])
def test_saving_holds_one_gathered_tensor_at_a_time(launches, run):
    """Every snapshot the sharded ranks save gathers its tensors one at a
    time: on every rank, none of them outlives its use (rank 0 keeps its
    host copy, the others nothing), so no rank ever holds the whole state.
    Before each gather at most 2 earlier ones are alive, which the gloo
    group's two worker threads may still reference; the whole state is over
    a hundred tensors (torch_dp_worker._watch_saves)."""
    saves = launches["trainer_chain"].result()[2][run]
    assert len(saves) == 2
    for rank, per_rank in enumerate(saves):
        assert len(per_rank) >= 2, (rank, per_rank)  # a snapshot each epoch
        for s in per_rank:
            assert s["gathers"] > 100 and s["live_max"] <= 2, (rank, s)


# ----------------------------------------------------------------- cli
def _cli_fsdp(tmp):
    """`python -m oatx_torch.cli.train` on 2 gloo ranks under
    OATX_MULTIHOST=1 with configs/smoke/synthetic.json and `fsdp: true`,
    nothing else → each rank's output."""
    import os
    import subprocess
    import sys

    from oatx_torch.config.registry import DATASETS
    from oatx_torch.config.schema import DataLoaderCfg
    from oatx_torch.data.datasets import adapters  # noqa: F401 (registers them)

    with open(os.path.join(REPO, "configs", "smoke", "synthetic.json")) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(data_dir=str(tmp / "videos"), object_dir="", num_workers=1)
    raw["trainer"].update(verbosity=1, fsdp=True, save_dir=str(tmp / "out"))
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "cfg.json").write_text(json.dumps(raw))
    DATASETS.get("SyntheticVideoText")(DataLoaderCfg(
        dataset_name="SyntheticVideoText", data_dir=dl["data_dir"], num_workers=1,
        video_params=dl["video_params"], split="train"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("OATX_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", OATX_MULTIHOST="1",
               OATX_COORDINATOR=(tmp / "store").as_uri(), OATX_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, "-m", "oatx_torch.cli.train", "-c",
                               str(tmp / "cfg.json"), "--device", "cpu"], cwd=REPO,
                              env={**env, "OATX_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)], tmp / "out"


def test_cli_train_runs_fsdp_from_the_config(launches):
    """cli.train under OATX_MULTIHOST=1 takes `fsdp: true` from the config
    alone: both ranks exit 0, the state is sharded, rank 0 writes the
    run's snapshots."""
    ranks, out = launches["cli"].result()
    for r, (rc, log) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{log[-4000:]}"
    [run] = list((out / "models").glob("*/*"))
    assert {"checkpoint-epoch2", "vocab.txt"} <= {p.name for p in run.iterdir()}
    [logs] = list((out / "log").glob("*/*"))
    for r in range(2):
        assert "fsdp over a data axis of 2" in (logs / f"info_p{r}.log").read_text()
