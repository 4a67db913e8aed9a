"""Tensor and sequence parallelism over a model axis (`model_parallel`,
`sequence_parallel`), the port against oatx's GSPMD model axis on the CPU.

The port's ranks (tests/torch_dp_worker.py mode `tp` over gloo, one thread
each, started by `launch_dp`) split the tiny geometry below over their
model group (parallel/sharding.py, parallel/tensor.py) and train 2 steps,
each data position on its rows of the same global batches. oatx runs the
same steps as one GSPMD program on a (data, model) — or (dcn, data, model)
— mesh of as many of conftest.py's 8 CPU devices, its parameters placed by
`shard_params` (Megatron `param_specs`), its `sequence_parallel` constraint
on. The geometry: a ViT of depth 2 with 4 heads of 8 (1 head a rank at mp
4, T = 9 tokens, not divisible by 2 or 4: the port pads the token axis),
a DistilBERT of 2 layers with 4 heads and a vocabulary of 102 rows (split
at mp 2, replicated at mp 4, as 30522 is).

Tolerances, f32:
  * against oatx on the same mesh: loss terms 1e-4 relative; step 1's whole
    gradients (gathered over the data and model axes; every LayerNorm's γ
    and β among them) and the parameters after 2 steps within 1e-4 of each
    tensor's largest entry, leaving out the attention key biases (their
    gradient is 0 in real arithmetic: tests/test_torch_shard.py);
  * against the port's own one process on the global batch: loss terms and
    norms 1e-5 relative, gradients within 1e-5 of scale (plus 1e-7 for the
    key biases' rounding noise);
  * sequence parallelism on against off: 1e-6 relative on the losses;
  * per-rank bytes: what a rank holds equals sharding.state_bytes, and at a
    config's full widths state_bytes equals oatx's per-device bytes from
    `param_specs` / `fsdp_param_specs` on the same mesh (fsdp: up to the
    flat shares' stated padding).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.parallel import sharding as jshard
from oatx.train import optim as joptim
from oatx.train import step as jstep
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.parallel import mesh as pmesh
from oatx_torch.parallel import sharding as pshard
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep
from torch_port_helpers import REPO, TRAIN_LR, launch_dp, oatx_params, to_numpy

torch.set_num_threads(1)

VIDEO = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=4, num_frames=2,
             time_init="random")
TEXT = dict(vocab_size=102, max_position_embeddings=32, dim=32, hidden_dim=64, n_layers=2,
            n_heads=4)
MIN_SIZE = 256
STEPS = 2
LAUNCH_TIMEOUT_S = 300
# name → (world, dcn slices, model_parallel)
LAYOUTS = {"mp2": (2, 1, 2), "mp4": (4, 1, 4), "d2mp2": (4, 1, 2), "dcn2mp2": (4, 2, 2)}


def _cfgs(**video):
    """(oatx TowerConfig, port TowerConfig) of the geometry; oatx runs its
    CLS-first fused stream, the port's layout."""
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**VIDEO, split_cls_stream=False, cls_position="first",
                                      **video),
        text=jdb.DistilBertConfig(**TEXT), projection_dim=16)
    p = ptowers.TowerConfig(video=pvst.SpaceTimeViTConfig(**VIDEO, **video),
                            text=pdb.DistilBertConfig(**TEXT), projection_dim=16)
    return j, p


@functools.lru_cache(maxsize=None)
def _params():
    return oatx_params(_cfgs()[0])


def _state_dict(pcfg):
    return state_dict_from_oatx(to_numpy(_params()), pcfg)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, 6), np.int32)
    mask[1::3, 4:] = 0
    return {"video": rng.standard_normal((n, 2, 32, 32, 3)).astype(np.float32),
            "input_ids": rng.integers(0, 100, (n, 6)).astype(np.int32),
            "attention_mask": mask}


def _batches(seed=0):
    return [_batch(4, seed + s) for s in range(STEPS)]


def _nonfinite():
    """Step 1's batch with a NaN in its last row, then step 2's."""
    b = _batches()
    bad = {k: v.copy() for k, v in b[0].items()}
    bad["video"][-1, 0, 0, 0, 0] = np.nan
    return [bad, b[1]]


def _case(mp, mode=None, dcn=1, video=None, opt=None, step=None, loss=None, batches=None,
          saved=False):
    pcfg = _cfgs(**(video or {}))[1]
    return {"cfg": pcfg, "state_dict": _state_dict(pcfg), "batches": batches or _batches(),
            "mode": mode, "dcn": dcn, "mp": mp, "min_size": MIN_SIZE,
            "opt": {"lr": TRAIN_LR, **(opt or {})}, "step": step or {},
            "loss_cfg": pstep.LossConfig(**(loss or {})), "saved": saved}


SP = dict(sequence_parallel=True)
# name → _case keywords at mp 2 (world 2)
CASES_2 = {
    "sp": dict(video=SP),
    "nosp": dict(video={}),
    "fused_qkv": dict(video=dict(fused_qkv=True)),
    "fused_qkv_sp": dict(video=dict(fused_qkv=True, **SP)),
    "unfused_mlp": dict(video=dict(fused_mlp=False, **SP)),
    "accum": dict(video=SP, step={"accum_steps": 2}),
    "clip": dict(video=SP, opt={"grad_clip": 0.05}),
    "skip": dict(video=SP, step={"skip_nonfinite": True}, batches=_nonfinite()),
    "chunked": dict(video=SP, loss={"chunked": True, "chunk_size": 2}),
    "remat_dots_all": dict(video=dict(remat=True, remat_policy="dots_all", **SP)),
    "saved_sp": dict(video=dict(remat=True, **SP), saved=True),
    "saved_nosp": dict(video=dict(remat=True), saved=True),
}
# name → (layout, _case keywords) at a world of 4
CASES_4 = {
    "mp4": ("mp4", dict(video=SP)),
    "mp4_nosp": ("mp4", dict(video={})),
    "d2mp2": ("d2mp2", dict(video=SP)),
    "d2mp2_fsdp": ("d2mp2", dict(video=SP, mode="fsdp")),
    "d2mp2_zero1": ("d2mp2", dict(video=SP, mode="zero1")),
    "dcn2mp2": ("dcn2mp2", dict(video=SP, dcn=2)),
}


def _cases_4():
    return {name: _case(LAYOUTS[lay][2], **kw) for name, (lay, kw) in CASES_4.items()}


@pytest.fixture(scope="module", autouse=True)
def launches(tmp_path_factory):
    """Both launches of this file, started at once in the background (oatx's
    compiles run meanwhile here): name → a future of launch_dp's result."""
    tmp = tmp_path_factory.mktemp("tp")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    out = {"2": pool.submit(launch_dp, "tp", 2,
                            {"cases": {n: _case(2, **kw) for n, kw in CASES_2.items()}},
                            tmp / "2", LAUNCH_TIMEOUT_S),
           "4": pool.submit(launch_dp, "tp", 4, {"cases": _cases_4()}, tmp / "4",
                            LAUNCH_TIMEOUT_S)}
    yield out
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(launches):
    return {k: f.result() for k, f in launches.items()}


def _rank_records(ranks, name):
    return ranks["2"] if name in CASES_2 else ranks["4"]


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port in one process over the global batches of case `name`:
    (metrics per step, step 1's gradients, the parameters after the last
    step)."""
    kw = CASES_2.get(name) or CASES_4[name][1]
    case = _case(1, **{k: v for k, v in kw.items() if k not in ("mode", "dcn")})
    state = pstep.init_state(case["cfg"], poptim.make_optimizer(**case["opt"]), device="cpu",
                             state_dict=case["state_dict"])
    fn = pstep.make_train_step(case["cfg"], case["loss_cfg"], device="cpu", **case["step"])
    metrics, grads = [], None
    for b in case["batches"]:
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                     if p.grad is not None}
    return metrics, grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _oatx_run(lay, fused_mlp=True):
    """oatx's GSPMD train step on the layout's (dcn,) data × model mesh,
    parameters placed by its Megatron specs, sequence_parallel on: (metrics
    per step, step 1's gradients and the parameters after 2 steps under the
    port's names)."""
    world, dcn, mp = LAYOUTS[lay]
    jcfg, pcfg = _cfgs(fused_mlp=fused_mlp, **SP)
    mesh = jmesh.make_mesh(n_devices=world, model_parallel=mp, dcn_slices=dcn)
    try:
        tx = joptim.make_optimizer(lr=TRAIN_LR)
        st = jstep.init_state(None, jcfg, tx, params=jshard.shard_params(mesh, _params()))
        batches = [jmesh.shard_batch(mesh, b) for b in _batches()]
        grad_fn = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(p, jcfg, jstep.LossConfig(), b)[0]))
        grads = grad_fn(st.params, batches[0])
        fn = jstep.make_train_step(jcfg, jstep.LossConfig(), tx, donate=False)
        metrics = []
        for b in batches:
            st, m = fn(st, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jmesh.set_current_mesh(None)
    return (metrics, state_dict_from_oatx(to_numpy(grads), pcfg),
            state_dict_from_oatx(to_numpy(st.params), pcfg))


def _key_bias(name):
    return name.endswith("k_lin.bias") or name.endswith("qkv.bias")


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
PLACEMENT_CONFIGS = ("norm", "pod_v5p", "vit_large_pod", "vit_huge_pod")
MESHES = {"mp2": (1, 2), "mp4": (1, 4), "d2mp2": (2, 2)}  # (data, model)


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(oatx's abstract params, the port's parameter shapes) at a config's
    full widths, built without weights (jax.eval_shape, the meta device)."""
    from oatx.config import schema as jschema
    from oatx_torch.config import schema as pschema

    with open(f"{REPO}/configs/pt/cc3m_webvid/{name}.json") as f:
        raw = json.load(f)
    raw["trainer"]["model_parallel"] = 1
    jcfg = jschema.build_tower_config(jschema.ExperimentCfg.from_dict(raw).arch)
    pcfg = pschema.build_tower_config(pschema.ExperimentCfg.from_dict(raw).arch)
    abstract = jax.eval_shape(lambda: jtowers.init(jax.random.PRNGKey(0), jcfg))
    with torch.device("meta"):
        model = ptowers.DualTower(pcfg, device="meta", generator=torch.Generator())
    return abstract, {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", [None, "fsdp", "zero1"])
@pytest.mark.parametrize("config", PLACEMENT_CONFIGS)
def test_placement_bytes_are_oatx_bytes(config, mode, mesh):
    """At a config's full widths, the per-rank bytes of parameters,
    gradients and moments that sharding.state_bytes gives under the model
    axis equal oatx's per-device bytes from param_specs (tensor parallelism
    alone) and fsdp_param_specs (composed with fsdp) on the same (data,
    model) mesh, fsdp's stated padding taken off. Under zero1 oatx re-places
    each moment on the data axis alone (sharding.py:132-146): the port, which
    keeps the moments model-local, holds less."""
    abstract, shapes = _trees(config)
    data, mp = MESHES[mesh]
    leaves = jax.tree_util.tree_leaves(abstract)
    jm = jmesh.make_mesh(n_devices=data * mp, model_parallel=mp)
    try:
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
        specs = jax.tree_util.tree_leaves(
            jshard.fsdp_param_specs(abstract, jm) if mode == "fsdp"
            else jshard.param_specs(abstract, jm), is_leaf=is_spec)
        sizes = {"data": data, "model": mp}
        shard = [x.size / math.prod(sizes[a] for a in s if a is not None)
                 for x, s in zip(leaves, specs)]
        if mode == "zero1":
            moments = [x.size / (data if "data" in tuple(
                jshard.opt_leaf_zero1_sharding(jm, x).spec) else 1) for x in leaves]
            want = 4 * 2 * sum(shard) + 4 * 2 * sum(moments)
        else:
            want = 4 * 4 * sum(shard)
    finally:
        jmesh.set_current_mesh(None)
    got = pshard.state_bytes(shapes, data, mode, model_parallel=mp)
    assert got["bytes"] < got["replicated"]
    if mode == "zero1":
        assert got["bytes"] <= want
    else:
        assert abs(got["bytes"] - got["padding"] - want) <= 8, (got, want)
    split = pshard.model_plan(shapes, pmesh.Layout(0, data * mp, 1, mp))
    word = "text_model.embeddings.word_embeddings.weight"
    assert (word in split) == (shapes[word][0] % mp == 0)
    assert (word in split) == (mp == 2)  # 30522 rows divide by 2, not by 4


def test_fused_qkv_rows_are_whole_heads():
    """The fused qkv's split holds each rank's q, k and v rows of its heads
    (oatx's contiguous split would give rank 0 q's first heads only): the
    same number of rows as oatx's shard, and take / whole invert each other."""
    shape = (3 * 8, 5)
    spec = pshard.ModelShard(shape, 0, 3, 1, 4)
    full = torch.arange(math.prod(shape), dtype=torch.float32).view(shape)
    part = spec.take(full)
    assert part.shape == (6, 5)
    assert torch.equal(part, full.view(3, 4, 2, 5)[:, 1].reshape(6, 5))
    parts = torch.stack([pshard.ModelShard(shape, 0, 3, r, 4).take(full) for r in range(4)])
    assert torch.equal(spec.whole(parts), full)
    col = pshard.ModelShard((5, 8), 1, 1, 2, 4)
    assert torch.equal(col.take(full.view(5, 24)[:, :8]), full.view(5, 24)[:, 4:6])


# -------------------------------------------------------- against oatx
ORACLE = {"mp2": "sp", "mp4": "mp4", "d2mp2": "d2mp2", "dcn2mp2": "dcn2mp2"}


@pytest.mark.parametrize("lay", list(ORACLE))
def test_ranks_match_oatx(launches, lay):
    """Loss terms per step, step 1's whole gradients (LayerNorm γ and β
    included: norm2's are summed over the model group, being partial in
    each rank's kernel 1) and the whole parameters after 2 steps, on every
    rank, against oatx's GSPMD step on the same mesh."""
    want_m, want_g, want_p = _oatx_run(lay)  # while the ranks run
    name = ORACLE[lay]
    for rank in _rank_records({k: f.result() for k, f in launches.items()}, name):
        got = rank[name]
        for g, w in zip(got["metrics"], want_m):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        norms = [n for n in want_g if ".norm" in n]
        assert any(n.endswith("norm2.weight") for n in norms)
        _close(got["grads"], want_g, mask=_key_bias_mask, what="grads")
        _close(got["params"], want_p, mask=_key_bias_mask, what="params")


def test_unfused_mlp_matches_oatx(ranks):
    """fused_mlp=False at mp 2 (the plain chain on each rank's hidden rows)
    against oatx's fused_mlp=False and True on the same mesh."""
    for fused in (False, True):
        want_m, want_g, _ = _oatx_run("mp2", fused_mlp=fused)
        for rank in ranks["2"]:
            got = rank["unfused_mlp"]
            for g, w in zip(got["metrics"], want_m):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            _close(got["grads"], want_g, mask=_key_bias_mask, what=f"grads fused={fused}")


# ------------------------------------------------- against one process
ALL_CASES = list(CASES_2) + list(CASES_4)


@pytest.mark.parametrize("name", ALL_CASES)
def test_ranks_match_one_process(ranks, name):
    """Every case against the port's one process on the same global
    batches: loss terms and norms per step, step 1's whole gradients; the
    ranks agree on the metrics bitwise, and model peers hold bitwise the same
    replicated parameters."""
    want_m, want_g, want_p = _one_process(name)
    recs = _rank_records(ranks, name)
    for rank in recs:
        got = rank[name]
        assert len(got["metrics"]) == len(want_m) == STEPS
        for g, w in zip(got["metrics"], want_m):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        _close(got["grads"], want_g, scale=1e-5, floor=1e-7, what="grads")
        _close(got["params"], want_p, mask=_key_bias_mask, what="params")
        assert got["metrics"] == recs[0][name]["metrics"]
    by_position = {}
    for rank in recs:
        by_position.setdefault(rank[name]["layout"]["position"], []).append(rank[name])
    for peers in by_position.values():
        for other in peers[1:]:
            a, b = peers[0]["replicated_values"], other["replicated_values"]
            assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["accum", "clip", "skip", "chunked"])
def test_step_options(ranks, name):
    """accum_steps 2, a clip that fires, skip_nonfinite on a NaN row and the
    chunked loss under the model axis: what one process does (the match is
    test_ranks_match_one_process's); the skip skips step 1 on every rank."""
    got = ranks["2"][0][name]
    if name == "clip":
        assert all(m["grad_norm"] > 0.05 for m in got["metrics"])
    if name == "skip":
        assert [m["skipped"] for m in got["metrics"]] == [1.0, 0.0]
        assert got["step"] == 1 and got["opt"]["count"] == 1
    if name == "accum":  # one model-group sum of the partial gradients a step
        assert got["traffic_step1"]["tp_norm"]["calls"] == ranks["2"][0]["sp"][
            "traffic_step1"]["tp_norm"]["calls"]


def test_sequence_parallel_on_against_off(ranks):
    """The token-sharded stream is numerically the replicated one: losses
    within 1e-6 relative, at mp 2 and mp 4, with kernel 3 too."""
    for recs, on, off in ((ranks["2"], "sp", "nosp"), (ranks["4"], "mp4", "mp4_nosp"),
                          (ranks["2"], "fused_qkv_sp", "fused_qkv")):
        for rank in recs:
            for a, b in zip(rank[on]["metrics"], rank[off]["metrics"]):
                np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
            assert "sp_scatter" in rank[on]["traffic_step1"]
            assert "sp_scatter" not in rank[off]["traffic_step1"]


def test_remat_saves_a_rank_s_rows(ranks):
    """Under remat 'full' the block inputs a rank saves for its backward are
    its token rows under sequence parallelism: ⌈9/2⌉/9 of the replicated
    stream's (measured with saved_tensors_hooks)."""
    on, off = ranks["2"][0]["saved_sp"]["saved_block_inputs"], \
        ranks["2"][0]["saved_nosp"]["saved_block_inputs"]
    assert off == VIDEO["depth"] * 4 * 9 * 32 * 4  # depth × B × T × D × f32
    assert on * 9 == off * 5


def test_held_bytes_are_the_plan(ranks):
    """What each rank holds (parameters, gradients, moments, from the
    tensors' storage) equals sharding.state_bytes under its layout, and is
    less than the replicated state; the word table is split at mp 2 only."""
    for key, recs in ranks.items():
        for rank in recs:
            for name, rec in rank.items():
                if name == "skip":  # step 1 skipped: no gradient held after it
                    continue
                assert rec["held"]["total"] == rec["predicted"]["bytes"], (name, rec["held"])
                assert rec["held"]["total"] < rec["predicted"]["replicated"]
                word = "text_model.embeddings.word_embeddings.weight" in rec["split"]
                assert word == (name in CASES_2 or CASES_4[name][0] != "mp4"), name


def test_data_positions_read_their_rows(ranks):
    """Model peers train on the same rows, data positions on theirs."""
    for rank in ranks["4"]:
        rec = rank["d2mp2"]
        pos = rec["layout"]["position"]
        assert rec["layout"]["batch_shards"] == 2
        want = torch.from_numpy(np.array_split(_batches()[0]["input_ids"], 2)[pos])
        assert torch.equal(rec["batch_rows"], want)


# ------------------------------------------------------------- raises
@pytest.mark.parametrize("keys,world,error", [
    (dict(model_parallel=2), 2, None), (dict(model_parallel=4), 4, None),
    (dict(model_parallel=2, dcn_slices=2), 4, None),
    (dict(model_parallel=2, fsdp=True), 4, None),
    (dict(model_parallel=2, zero1=True), 4, None),
    (dict(model_parallel=4), 2, "not divisible by model_parallel=4"),
    (dict(model_parallel=2, dcn_slices=2), 2, "not divisible"),
    (dict(model_parallel=2, dp_mode="manual"), 4, "dp_mode='manual'"),
    pytest.param(dict(pipeline=True, model_parallel=2), 2, None,
                 id="keys8-2-A8b, pipeline stages")])  # the case's name kept
def test_check_layout(keys, world, error):
    """check_layout accepts a model axis that divides the world (with fsdp,
    zero1 and dcn slices), refuses one that does not (oatx's make_mesh
    wording) and dp_mode 'manual' under a model axis (oatx trainer.py:
    304-309); pipeline stages on the model axis run, as in oatx
    (tests/test_torch_pp.py)."""
    from oatx_torch.config.schema import TrainerCfg

    t = dataclasses.replace(TrainerCfg(), **keys)
    if error is None:
        pmesh.check_layout(t, world=world)
        return
    with pytest.raises(ValueError, match=error):
        pmesh.check_layout(t, world=world)


@pytest.mark.parametrize("change,error", [
    pytest.param(dict(video=dict(num_heads=2, embed_dim=32)), "heads",
                 id="change5-heads")])  # the case's name kept
def test_towers_outside_the_slice_raise(change, error):
    """Under a model axis heads that do not divide raise ValueError (every
    text family, the object tower and the variants split:
    tests/test_torch_tp_towers.py, which holds their heads cases too)."""
    pcfg = _cfgs()[1]
    pcfg = dataclasses.replace(pcfg, video=dataclasses.replace(pcfg.video, **change["video"]))
    model = ptowers.DualTower(pcfg, "cpu", torch.Generator().manual_seed(0))
    layout = pmesh.Layout(0, 4, 1, 4)
    with pytest.raises(ValueError, match=error):
        pshard.place(model, None, layout)


def test_layout_ranks():
    """The rank layout keeps oatx make_mesh's device order, the model axis
    fastest: (dcn, data, model) = (2, 2, 2) over 8 ranks."""
    lay = pmesh.Layout(5, 8, 2, 2)
    assert (lay.model_rank, lay.position, lay.data_rank, lay.slice_index) == (1, 2, 0, 1)
    assert (lay.batch_shards, lay.data_size) == (4, 2)
    assert list(lay.model_ranks()) == [4, 5]
    assert list(lay.batch_ranks()) == [1, 3, 5, 7]
    assert list(lay.data_ranks(1)) == [5, 7]
    assert list(lay.cross_ranks(0)) == [1, 5]
    devs = np.arange(8).reshape(2, 2, 2)  # oatx make_mesh's grid
    assert devs[lay.slice_index, lay.data_rank, lay.model_rank] == 5
