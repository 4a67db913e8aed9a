"""Tensor parallelism of the BERT and CLIP text towers, the object tower and
the object-aware variants over a model axis, the port against oatx's GSPMD
model axis on the CPU.

Three combined towers cover the five pieces in few launches:
  A  BERT text, baseline, with the object tower at object_nce_weight 0.5
     (and at 0: frozen), mp 2 and mp 4;
  B  DistilBERT text, global_local (its second text stream, the 1-frame
     object frame through the split ViT), sequence_parallel, mp 2 and
     (data 2, model 2);
  C  CLIP text, region_mem (the tap after block 1 of the split ViT),
     sequence_parallel, mp 2.
The geometry: a ViT of depth 2 with 4 heads of 8 (T = 9 for the 2-frame
clip and 5 for the object frame, neither divisible by 2 or 4: the token
axis pads), text towers of 2 layers with 4 heads of 8 and a vocabulary of
102 rows (the (Distil)BERT word table splits at mp 2 and replicates at mp 4,
as 30522 does), an object tower of 2 layers with 4 heads over K = 4 slots.
The port's ranks are tests/torch_dp_worker.py mode `tp` (gloo, one thread
each, started by `launch_dp` in the background while oatx compiles); oatx
runs the same 2 steps as one GSPMD program on a (data, model) mesh of
conftest.py's CPU devices, its parameters placed by `shard_params`, its
`sequence_parallel` constraint on.

Tolerances, f32, those of tests/test_torch_tp.py:
  * against oatx on the same mesh: loss terms 1e-4 relative; step 1's whole
    gradients and the parameters after 2 steps within 1e-4 of each tensor's
    largest entry, leaving out the attention key biases (their gradient is 0
    in real arithmetic);
  * against the port's own one process on the global batch: loss terms and
    norms 1e-5 relative, gradients within 1e-5 of scale (plus 1e-7);
  * sequence parallelism on against off: 1e-6 relative on the losses;
  * per-rank bytes: what a rank holds equals sharding.state_bytes, and at
    full widths state_bytes equals oatx's per-device bytes from
    `param_specs` / `fsdp_param_specs` on the same mesh.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from oatx.models import bert as jbert
from oatx.models import clip_text as jclip
from oatx.models import distilbert as jdb
from oatx.models import object_tower as jobjt
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.parallel import sharding as jshard
from oatx.train import optim as joptim
from oatx.train import step as jstep
from oatx_torch.models import bert as pbert
from oatx_torch.models import clip_text as pclip
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import object_tower as pobjt
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.parallel import mesh as pmesh
from oatx_torch.parallel import sharding as pshard
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep
from torch_port_helpers import REPO, TRAIN_LR, launch_dp, to_numpy

torch.set_num_threads(1)

VIDEO = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=4, num_frames=2,
             time_init="random")
BERTISH = dict(vocab_size=102, max_position_embeddings=32, dim=32, hidden_dim=64, n_layers=2,
               n_heads=4)
CLIP = dict(vocab_size=102, context_length=16, width=32, heads=4, layers=2, embed_dim=24)
OBJ = dict(feature_dim=2054, dim=32, n_layers=2, n_heads=4, hidden_dim=64, top_k=4)
TEXT = {"bert": (jbert.BertConfig, pbert.BertConfig, BERTISH),
        "distilbert": (jdb.DistilBertConfig, pdb.DistilBertConfig, BERTISH),
        "clip": (jclip.ClipTextConfig, pclip.ClipTextConfig, CLIP)}
# tower → (text family, variant, object tower)
TOWERS = {"A": ("bert", "baseline", True), "B": ("distilbert", "global_local", False),
          "C": ("clip", "region_mem", False)}
SEQ, PAD_SEQ, OBJECTS = 7, 11, 3
MIN_SIZE = 256
STEPS = 2
LAUNCH_TIMEOUT_S = 300
LAYOUTS = {"mp2": (2, 2), "mp4": (4, 4), "d2mp2": (4, 2)}  # name → (world, model_parallel)
# case → (tower, layout, sequence_parallel, object_nce_weight)
CASES = {"A_mp2": ("A", "mp2", True, 0.5), "A_frozen": ("A", "mp2", True, 0.0),
         "A_mp4": ("A", "mp4", True, 0.5), "B_mp2": ("B", "mp2", True, 0.0),
         "B_nosp": ("B", "mp2", False, 0.0), "B_d2mp2": ("B", "d2mp2", True, 0.0),
         "C_mp2": ("C", "mp2", True, 0.0), "C_nosp": ("C", "mp2", False, 0.0)}
ORACLE = ("A_mp2", "A_mp4", "B_mp2", "B_d2mp2", "C_mp2")  # against oatx's GSPMD step


def _cfgs(tower, sp=True):
    """(oatx TowerConfig, port TowerConfig) of a tower; oatx runs its
    CLS-first fused stream, the port's layout."""
    family, variant, objects = TOWERS[tower]
    jt, pt, kw = TEXT[family]
    tap = dict(region_tap_layer=1) if variant == "region_mem" else {}
    video = dict(VIDEO, sequence_parallel=sp, **tap)
    common = dict(text_family=family, variant=variant, projection_dim=16)
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**video, split_cls_stream=False, cls_position="first"),
        text=jt(**kw), object_tower=jobjt.ObjectTowerConfig(**OBJ) if objects else None,
        **common)
    p = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**video), text=pt(**kw),
        object_tower=pobjt.ObjectTowerConfig(**OBJ) if objects else None, **common)
    return j, p


@functools.lru_cache(maxsize=None)
def _params(tower):
    """oatx params of the tower's shapes (jax.eval_shape of its init, no
    weights computed): every leaf 0.05·N(0, 1), LayerNorm scales 1 + that."""
    abstract = jax.eval_shape(lambda: jtowers.init(jax.random.PRNGKey(0), _cfgs(tower)[0]))
    rng = np.random.default_rng(ord(tower))

    def fill(path, x):
        v = 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        return v + 1.0 if path[-1].key == "scale" else v

    return jax.tree_util.tree_map_with_path(fill, abstract)


def _state_dict(tower):
    return state_dict_from_oatx(to_numpy(_params(tower)), _cfgs(tower)[1])


def _ids(rng, n, length, family):
    """Token ids and their mask: CLIP's <|startoftext|> … <|endoftext|> (the
    highest id, its argmax) at a varying position, zeros after; otherwise
    random ids with some rows padded."""
    if family == "clip":
        v = CLIP["vocab_size"]
        ids = np.zeros((n, length), np.int32)
        for i in range(n):
            k = int(rng.integers(2, length))
            ids[i, 0], ids[i, k] = v - 2, v - 1
            ids[i, 1:k] = rng.integers(1, v - 2, k - 1)
        return ids, (ids != 0).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    mask[1::3, length - 2:] = 0
    return rng.integers(0, 100, (n, length)).astype(np.int32), mask


def _batch(tower, seed, n=4):
    family, variant, objects = TOWERS[tower]
    rng = np.random.default_rng(seed)
    ids, mask = _ids(rng, n, SEQ, family)
    out = {"video": rng.standard_normal((n, 2, 32, 32, 3)).astype(np.float32),
           "input_ids": ids, "attention_mask": mask}
    if objects:
        x = rng.standard_normal((n, OBJ["top_k"], 2054)).astype(np.float32)
        x[0, 2:] = 0.0  # two objects; sample 2 has none
        x[2] = 0.0
        out["object"] = x
    if variant != "baseline":
        out["object_frame"] = rng.standard_normal((n, 1, 32, 32, 3)).astype(np.float32)
        out["patch_masks"] = (rng.uniform(size=(n, OBJECTS, 4)) > 0.4).astype(np.float32)
    if variant == "global_local":
        out["pad_input_ids"], out["pad_attention_mask"] = _ids(rng, n, PAD_SEQ, family)
        out["object_token_masks"] = np.cumsum(rng.integers(0, 3, (n, OBJECTS)),
                                              axis=1).astype(np.int32)
    if variant == "region_mem":
        out["text_region_embedding"] = 0.02 * rng.standard_normal(
            (n, OBJECTS, 512)).astype(np.float32)
    return out


def _batches(tower):
    return [_batch(tower, s) for s in range(STEPS)]


def _case(name, mp=None):
    tower, lay, sp, weight = CASES[name]
    return {"cfg": _cfgs(tower, sp)[1], "state_dict": _state_dict(tower),
            "batches": _batches(tower), "mode": None, "dcn": 1,
            "mp": LAYOUTS[lay][1] if mp is None else mp, "min_size": MIN_SIZE,
            "opt": {"lr": TRAIN_LR}, "step": {},
            "freeze": () if weight or not TOWERS[tower][2] else ("object_tower", "obj_proj"),
            "loss_cfg": pstep.LossConfig(object_nce_weight=weight)}


@pytest.fixture(scope="module", autouse=True)
def launches(tmp_path_factory):
    """Both launches of this file, started at once in the background (oatx's
    compiles run meanwhile here): world → a future of launch_dp's result."""
    tmp = tmp_path_factory.mktemp("tp_towers")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    out = {}
    for world in (2, 4):
        cases = {n: _case(n) for n, c in CASES.items() if LAYOUTS[c[1]][0] == world}
        out[world] = pool.submit(launch_dp, "tp", world, {"cases": cases}, tmp / str(world),
                                 LAUNCH_TIMEOUT_S)
    yield out
    pool.shutdown(wait=True)


def _ranks(launches, name):
    return launches[LAYOUTS[CASES[name][1]][0]].result()


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port in one process over the global batches of case `name`:
    (metrics per step, step 1's gradients, the parameters after the last
    step)."""
    case = _case(name, mp=1)
    opt = poptim.make_optimizer(**case["opt"], trainable_filter=poptim.exclude_subtrees(
        None, case["freeze"]) if case["freeze"] else None)
    state = pstep.init_state(case["cfg"], opt, device="cpu", state_dict=case["state_dict"])
    fn = pstep.make_train_step(case["cfg"], case["loss_cfg"], device="cpu")
    metrics, grads = [], None
    for b in case["batches"]:
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                     if p.grad is not None}
    return metrics, grads, {k: v.clone() for k, v in state.model.state_dict().items()}


def _oatx_step(jcfg, loss_cfg, tx):
    """oatx make_train_step's step at accum_steps 1 (oatx/train/step.py:
    313-345: loss_fn's value and gradients, the optimizer's update,
    grad_norm), also returning the gradients."""

    def step(state, batch):
        (_, metrics), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
            state.params, jcfg, loss_cfg, batch)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        return jstep.TrainState(optax.apply_updates(state.params, updates), opt_state,
                                state.step + 1), metrics, grads

    return step


@pytest.fixture(scope="module")
def oatx_runs():
    """oatx's GSPMD train step for each ORACLE case on its data × model mesh,
    parameters placed by its Megatron specs, its sequence_parallel
    constraint as the case sets it: name → (metrics per step, step 1's
    gradients and the parameters after 2 steps under the port's names).
    Each step is traced under its mesh (oatx reads the current mesh while
    tracing) and compiles in a thread meanwhile the next one is traced."""
    jobs = {}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(ORACLE))
    for name in ORACLE:
        tower, lay, sp, weight = CASES[name]
        world, mp = LAYOUTS[lay]
        jcfg, _ = _cfgs(tower, sp)
        mesh = jmesh.make_mesh(n_devices=world, model_parallel=mp)
        try:
            tx = joptim.make_optimizer(lr=TRAIN_LR)
            st = jstep.init_state(None, jcfg, tx,
                                  params=jshard.shard_params(mesh, _params(tower)))
            rep = NamedSharding(mesh, PartitionSpec())
            st = jax.tree_util.tree_map(  # every leaf committed, so step 2 reuses step 1's program
                lambda x: x if isinstance(getattr(x, "sharding", None), NamedSharding)
                else jax.device_put(x, rep), st)
            batches = [jmesh.shard_batch(mesh, b) for b in _batches(tower)]
            placed = jax.tree_util.tree_map(lambda x: x.sharding, st)
            lowered = jax.jit(_oatx_step(jcfg, jstep.LossConfig(object_nce_weight=weight), tx),
                              out_shardings=(placed, rep, None)).lower(st, batches[0])
        finally:
            jmesh.set_current_mesh(None)
        jobs[name] = (pool.submit(lowered.compile), st, batches)
    pool.shutdown(wait=True)
    out = {}
    for name, (compiled, st, batches) in jobs.items():
        pcfg = _cfgs(CASES[name][0])[1]
        metrics, grads = [], None
        for b in batches:
            st, m, g = compiled.result()(st, b)
            metrics.append({k: float(v) for k, v in m.items()})
            grads = g if grads is None else grads
        out[name] = (metrics, state_dict_from_oatx(to_numpy(grads), pcfg),
                     state_dict_from_oatx(to_numpy(st.params), pcfg))
    return out


def _key_bias_mask(name, shape):
    """False where the gradient is 0 in real arithmetic: the attention key
    biases (BERT's key, DistilBERT's k_lin, the k third of a fused qkv)."""
    mask = torch.ones(shape, dtype=torch.bool)
    if name.endswith(("k_lin.bias", "self.key.bias")):
        mask[:] = False
    elif name.endswith(("qkv.bias", "in_proj_bias")):
        d = shape[0] // 3
        mask[d:2 * d] = False
    return mask


def _close(got, want, scale=1e-4, floor=0.0, mask=None, what=""):
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want))[:5])
    for n, w in want.items():
        g, w = got[n].float(), torch.as_tensor(np.asarray(w)).float()
        keep = mask(n, w.shape) if mask else torch.ones_like(w, dtype=torch.bool)
        err = (g - w).abs()[keep]
        tol = scale * float(w.abs().max()) + floor
        assert err.numel() == 0 or float(err.max()) <= tol, (what, n, float(err.max()), tol)


# ------------------------------------------------------------- placements
RAW = {  # full-width recipe → (config file, changes to its raw dict)
    "bert": ("pt/cc3m_webvid/norm.json", "bert"),
    "clip": ("pt/cc3m_webvid/norm.json", "clip"),
    "objects": ("pt/cc3m_webvid/norm.json", "objects"),
    "global_local": ("pt/cc3m_webvid/local_region_loss.json", None),
    "region_mem": ("pt/webvid/region_mem.json", None),
}
MESHES = {"mp2": (1, 2), "mp4": (1, 4), "d2mp2": (2, 2), "d2mp4": (2, 4)}  # (data, model)


def _raw(name):
    path, change = RAW[name]
    with open(f"{REPO}/configs/{path}") as f:
        raw = json.load(f)
    raw["trainer"]["model_parallel"] = 1
    text = raw["arch"]["args"]["text_params"]
    if change == "bert":
        text["model"] = "bert-base-uncased"
    elif change == "clip":
        text["model"] = "openai/clip-vit-base-patch32"
    elif change == "objects":
        raw["arch"]["stream"] = 3
        raw["arch"]["args"]["object_params"].update(input_objects=True, top_k=10)
    return raw


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(oatx's abstract params, the port's parameter shapes, the port's
    tower config) at a recipe's full widths, built without weights
    (jax.eval_shape, the meta device)."""
    from oatx.config import schema as jschema
    from oatx_torch.config import schema as pschema

    raw = _raw(name)
    jcfg = jschema.build_tower_config(jschema.ExperimentCfg.from_dict(raw).arch)
    pcfg = pschema.build_tower_config(pschema.ExperimentCfg.from_dict(raw).arch)
    abstract = jax.eval_shape(lambda: jtowers.init(jax.random.PRNGKey(0), jcfg))
    with torch.device("meta"):
        model = ptowers.DualTower(pcfg, device="meta", generator=torch.Generator())
    return abstract, {n: tuple(p.shape) for n, p in model.named_parameters()}, pcfg


def test_full_width_recipes_are_the_towers_named():
    """The five recipes build the towers this file places: BERT-base,
    CLIP text, the object tower, and the two variants."""
    shapes = {n: _trees(n)[1] for n in RAW}
    cfgs = {n: _trees(n)[2] for n in RAW}
    b = cfgs["bert"].text
    assert (cfgs["bert"].text_family, b.n_layers, b.dim, b.n_heads, b.vocab_size) == \
        ("bert", 12, 768, 12, 30522)
    c = cfgs["clip"].text
    assert (cfgs["clip"].text_family, c.layers, c.width, c.heads, c.vocab_size,
            c.context_length) == ("clip", 12, 512, 8, 49408, 77)
    o = cfgs["objects"].object_tower
    assert (o.feature_dim, o.dim, o.n_layers, o.n_heads, o.hidden_dim) == (2054, 512, 2, 8, 1024)
    assert (cfgs["global_local"].variant, cfgs["region_mem"].variant) == \
        ("global_local", "region_mem")
    assert "vid_local_proj.0.weight" in shapes["global_local"]
    assert "video_model.region_norm.weight" in shapes["region_mem"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", [None, "fsdp", "zero1"])
@pytest.mark.parametrize("config", list(RAW))
def test_placement_bytes_are_oatx_bytes(config, mode, mesh):
    """At a recipe's full widths, the per-rank bytes of parameters,
    gradients and moments that sharding.state_bytes gives under the model
    axis equal oatx's per-device bytes from param_specs (tensor parallelism
    alone) and fsdp_param_specs (composed with fsdp) on the same (data,
    model) mesh, fsdp's stated padding taken off; under zero1 the port,
    which keeps the moments model-local, holds no more than oatx's."""
    abstract, shapes, _ = _trees(config)
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


def _whole_on_every_rank(config):
    """Parameters of a recipe that oatx's rules leave whole at any width."""
    return {"bert": ("text_model.pooler.dense.weight",
                     "text_model.embeddings.position_embeddings.weight",
                     "text_model.embeddings.token_type_embeddings.weight"),
            "clip": ("text_model.token_embedding.weight", "text_model.positional_embedding",
                     "text_model.text_projection"),
            "objects": ("object_tower.embed.weight", "object_tower.embed_norm.weight",
                        "object_tower.norm.weight", "object_tower.pool_query",
                        "obj_proj.weight"),
            "global_local": ("vid_local_proj.0.weight", "text_local_proj.1.weight"),
            "region_mem": ("txt_proj_2.1.weight", "video_model.region_norm.weight")}[config]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("config", list(RAW))
def test_place_splits_every_tower(config, mp):
    """sharding.place at model_parallel 2 and 4 runs at full width for every
    text family, the object tower and both variants: every tower module
    gets the model axis, the word table splits by vocabulary at mp 2 only
    (30522 = 2 · 15261), and the tables, poolers, norms and heads that
    oatx's rules leave whole stay whole."""
    _, shapes, pcfg = _trees(config)
    with torch.device("meta"):
        model = ptowers.DualTower(pcfg, device="meta", generator=torch.Generator())
    pshard.place(model, None, pmesh.Layout(0, mp, 1, mp))
    split = {n for n, p in model.named_parameters() if getattr(p, "_oatx_tp", None)}
    assert all(blk.tp is not None for blk in model.video_model.blocks)
    text = model.text_model
    layers = {"bert": lambda: [m for lay in text.encoder.layer for m in (lay, lay.attention)],
              "clip": lambda: [m for b in text.transformer.resblocks for m in (b.attn, b.mlp)],
              "distilbert": lambda: [m for lay in text.transformer.layer
                                     for m in (lay.attention, lay.ffn)]}[pcfg.text_family]()
    assert layers and all(m.tp is not None and not m.tp.sequence_parallel for m in layers)
    if pcfg.object_tower is not None:
        assert all(lay.tp is not None for lay in model.object_tower.layers)
    for n in _whole_on_every_rank(config):
        assert n in shapes and n not in split, n
    word = "text_model.embeddings.word_embeddings.weight"
    if word in shapes:
        assert (word in split) == (mp == 2)
    # every split tensor holds 1/mp of the whole
    for n, p in model.named_parameters():
        if n in split:
            assert p.numel() * mp == math.prod(shapes[n]), n


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_split_is_oatx_split(tower, mp):
    """At the tiny widths, the port splits a parameter exactly where oatx's
    param_specs puts the model axis on its leaf: each oatx leaf marked 1
    (split) or 0 and carried through the weight converter."""
    jcfg, pcfg = _cfgs(tower)
    params = jax.eval_shape(lambda: jtowers.init(jax.random.PRNGKey(0), jcfg))
    jm = jmesh.make_mesh(n_devices=mp, model_parallel=mp)
    try:
        specs = jshard.param_specs(params, jm)
    finally:
        jmesh.set_current_mesh(None)
    marks = jax.tree_util.tree_map(
        lambda x, s: np.full(x.shape, float("model" in tuple(s)), np.float32), params, specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {n for n, v in state_dict_from_oatx(marks, pcfg).items() if float(v.min()) == 1.0}
    model = ptowers.DualTower(pcfg, "cpu", torch.Generator().manual_seed(0))
    got = set(pshard.model_plan({n: tuple(p.shape) for n, p in model.named_parameters()},
                                pmesh.Layout(0, mp, 1, mp)))
    assert got == want
    assert any(n.startswith("text_model.") for n in got)
    if pcfg.object_tower is not None:
        assert any(n.startswith("object_tower.") for n in got)


@pytest.mark.parametrize("tower", ["bert", "clip", "objects"])
def test_heads_that_do_not_divide_raise(tower):
    """Under a model axis of 4, a text tower or object tower of 2 heads (whose
    widths do divide) raises ValueError naming its heads."""
    pcfg = _cfgs("A")[1]
    if tower == "bert":
        pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, n_heads=2))
    elif tower == "clip":
        pcfg = _cfgs("C")[1]
        pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, heads=2))
    else:
        pcfg = dataclasses.replace(pcfg, object_tower=dataclasses.replace(
            pcfg.object_tower, n_heads=2))
    model = ptowers.DualTower(pcfg, "cpu", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="heads"):
        pshard.place(model, None, pmesh.Layout(0, 4, 1, 4))


# -------------------------------------------------------- against oatx
@pytest.mark.parametrize("name", ORACLE)
def test_ranks_match_oatx(launches, oatx_runs, name):
    """Loss terms per step, step 1's whole gradients (gathered from the
    parts) and the whole parameters after 2 steps, on every rank, against
    oatx's GSPMD step on the same mesh."""
    want_m, want_g, want_p = oatx_runs[name]
    for rank in _ranks(launches, name):
        got = rank[name]
        for g, w in zip(got["metrics"], want_m):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        _close(got["grads"], want_g, mask=_key_bias_mask, what="grads")
        _close(got["params"], want_p, mask=_key_bias_mask, what="params")


# ------------------------------------------------- against one process
@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_one_process(launches, name):
    """Every case against the port's one process on the same global batches:
    loss terms and norms per step, step 1's whole gradients and the
    parameters after 2 steps; the ranks agree on the metrics bitwise, and
    model peers hold bitwise the same replicated parameters."""
    want_m, want_g, want_p = _one_process(name)
    recs = _ranks(launches, name)
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


@pytest.mark.parametrize("on,off", [("B_mp2", "B_nosp"), ("C_mp2", "C_nosp")])
def test_sequence_parallel_on_against_off(launches, on, off):
    """The token-sharded stream (the clip's 9 tokens and the object frame's
    5, padded to the group) is numerically the replicated one: losses
    within 1e-6 relative."""
    for rank in _ranks(launches, on):
        for a, b in zip(rank[on]["metrics"], rank[off]["metrics"]):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
        assert "sp_scatter" in rank[on]["traffic_step1"]
        assert "sp_scatter" not in rank[off]["traffic_step1"]


def test_held_bytes_are_the_plan(launches):
    """What each rank holds equals sharding.state_bytes under its layout (less
    the gradients of a frozen object tower, which it never holds) and is
    less than the replicated state; the word table splits at mp 2 only, and
    the text tower's and object tower's layers are split."""
    for name, (tower, lay, _, weight) in CASES.items():
        mp = LAYOUTS[lay][1]
        for rank in _ranks(launches, name):
            rec = rank[name]
            frozen = 0 if weight or not TOWERS[tower][2] else sum(  # no gradient held
                4 * v.numel() // (mp if n in rec["split"] else 1)
                for n, v in rec["params"].items() if n.startswith(("object_tower", "obj_proj")))
            assert rec["held"]["total"] + frozen == rec["predicted"]["bytes"], (name, rec["held"])
            assert rec["held"]["total"] < rec["predicted"]["replicated"]
            word = "text_model.embeddings.word_embeddings.weight"
            if word in rec["params"]:
                assert (word in rec["split"]) == (mp == 2), name
            assert any(n.startswith("text_model.") for n in rec["split"])
            assert any(n.startswith("object_tower.layers.") for n in rec["split"]) == \
                TOWERS[tower][2]


def test_partial_gradients_are_the_column_biases(launches):
    """The gradients a rank holds in part: every column-parallel bias of the
    text tower and the object tower (BERT's query / key / value and
    intermediate, CLIP's in_proj_bias and c_fc, the object tower's qkv and
    fc1), and no LayerNorm of them: their post- or pre-LNs read the whole
    stream."""
    want = {"A": ("self.query.bias", "self.key.bias", "self.value.bias",
                  "intermediate.dense.bias"),
            "B": ("q_lin.bias", "k_lin.bias", "v_lin.bias", "ffn.lin1.bias"),
            "C": ("attn.in_proj_bias", "mlp.c_fc.bias")}
    for name in ("A_mp2", "B_mp2", "C_mp2"):
        tower = CASES[name][0]
        partial = _ranks(launches, name)[0][name]["partial"]
        text = [n for n in partial if n.startswith("text_model.")]
        assert len(text) == 2 * len(want[tower]) and all(n.endswith(want[tower])
                                                         for n in text), text
        objects = [n for n in partial if n.startswith("object_tower.")]
        assert sorted(objects) == ([f"object_tower.layers.{i}.{m}.bias" for i in range(2)
                                    for m in ("attn.qkv", "mlp.fc1")] if TOWERS[tower][2]
                                   else [])
        assert not any("norm" in n.lower() for n in text + objects)


def test_object_tower_frozen_at_weight_0(launches):
    """At object_nce_weight 0 the split object tower and obj_proj, frozen as
    the Trainer freezes them (optim.exclude_subtrees), get no gradient and
    stay bitwise as loaded after 2 steps, on every rank."""
    sd = _state_dict("A")
    for rank in _ranks(launches, "A_frozen"):
        rec = rank["A_frozen"]
        frozen = [n for n in rec["params"] if n.startswith(("object_tower", "obj_proj"))]
        assert any(n in rec["split"] for n in frozen)
        assert not any(n in rec["grads"] for n in frozen)
        assert all(torch.equal(rec["params"][n], sd[n]) for n in frozen)


@pytest.mark.parametrize("name", list(CASES))
def test_traffic_is_chip_smoke_derivation(launches, name):
    """The model group's collectives of step 1 (tp_reduce, sp_gather,
    sp_scatter bytes a rank) are what chip_smoke.tp_traffic derives from
    the code for this tower, variant and layout (f32 here); tp_norm's are
    the partial gradients' f32 bytes."""
    import chip_smoke as cs

    tower, lay, sp, weight = CASES[name]
    world, mp = LAYOUTS[lay]
    cfg = _cfgs(tower, sp)[1]
    rows = 4 // (world // mp)
    want = cs.tp_traffic(cfg, rows, SEQ, mp, pad_len=PAD_SEQ,
                         slots=OBJ["top_k"] if weight else 0)
    for rank in _ranks(launches, name):
        rec = rank[name]
        got = {k: rec["traffic_step1"].get(k, {}).get("bytes", 0) for k in want}
        assert got == want, (name, got, want)
        partial = sum(4 * rec["params"][n].numel() for n in rec["partial"]
                      if n in rec["grads"])
        assert rec["traffic_step1"]["tp_norm"]["bytes"] == partial
