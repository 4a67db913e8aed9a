"""The port's optimizer families (oatx_torch/train/optim.py: Adafactor, Lion
and momentum SGD) against oatx's optax chains (oatx/train/optim.py
make_optimizer), on the CPU.

Both packages get the SAME gradients, made from a numpy seed, for every
step, so what is compared is the update alone:
  * a toy tree (a plain matrix, a Linear weight, a 3-D tensor, a stacked
    Linear of 2 layers and small leaves) over 5 steps, each family with the
    global-norm clip, the freeze mask, the EMA, a schedule and explicit
    betas on and off;
  * the tiny dual tower at width 128 (WIDE below) carried across by
    models/convert.py: 3 steps, then oatx's optax state loaded into a fresh
    port optimizer through `opt_state_from_optax` and a 4th step on both;
  * the same tower on 2 gloo ranks (tests/torch_dp_worker.py mode `optim`)
    under zero1, fsdp, a model axis of 2 and 2 pipeline stages, against
    oatx's chain on the matching GSPMD placement of a 2-device CPU mesh,
    2 steps.
The suite's usual width of 32 factors nothing (optax factors a leaf whose
second-largest dim is at least 128), so WIDE has stacked Linears (the ViT
blocks' qkv / proj / fc1 / fc2, DistilBERT's layers) and an embedding
table (DistilBERT's 160 × 128 word table) that optax factors.

Tolerance: f32; every parameter and state tensor within 1e-5 of its largest
entry (RTOL), the two programs summing and rounding in another order. The
same bound holds after oatx's state is carried across.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.parallel import sharding as jshard
from oatx.train import optim as joptim
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import opt_state_from_optax, state_dict_from_oatx
from oatx_torch.parallel import sharding as pshard
from oatx_torch.train import checkpoint as pckpt
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep
from torch_port_helpers import REPO, TRAIN_TEXT, TRAIN_VIDEO, launch_dp, oatx_params, to_numpy

torch.set_num_threads(1)

RTOL = 1e-5
FAMILIES = ["adafactor", "lion", "sgd"]
LR = 1e-2


def _close(got, want, what=""):
    """Every tensor of `want` within RTOL of its largest entry."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want))[:5])
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[n].detach() if isinstance(got[n], torch.Tensor) else got[n],
                       np.float32)
        assert g.shape == w.shape, (what, n, g.shape, w.shape)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= RTOL * float(np.abs(w).max()), (what, n, err, float(np.abs(w).max()))


def _optax_steps(tx, params, grads_list, state=None):
    """optax: (params, state) after one update per gradient tree."""
    state = tx.init(params) if state is None else state
    update = jax.jit(tx.update)
    for g in grads_list:
        upd, state = update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    return params, state


def _port_steps(opt, params, grads_list):
    for g in grads_list:
        for n, p in params.items():
            p.grad = None if g.get(n) is None else torch.as_tensor(np.asarray(g[n])).clone()
        opt.step()


# ------------------------------------------------------------------ toy tree
TOY = {"w": (200, 130), "b": (130,), "t3": (4, 130, 140), "lin.weight": (140, 130),
       "m.layers.0.fc1.weight": (150, 130), "m.layers.1.fc1.weight": (150, 130),
       "m.layers.0.fc1.bias": (150,), "m.layers.1.fc1.bias": (150,),
       "txt_proj.1.weight": (3, 5)}


def _toy_oatx(port, layer=np.stack):
    """The port's toy tensors as oatx's tree: the Linear transposed, the
    stacked layers on a leading axis (`layer` stacks them)."""
    out = {k: port[k] for k in ("w", "b", "t3")}
    out["txt_proj"] = port["txt_proj.1.weight"]
    out["lin"] = np.asarray(port["lin.weight"]).T
    out["m"] = {"kernel": layer([np.asarray(port[f"m.layers.{i}.fc1.weight"]).T
                                 for i in range(2)]),
                "bias": layer([port[f"m.layers.{i}.fc1.bias"] for i in range(2)])}
    return out


def _toy_factored(port):
    """The port's Adafactor v_row / v_col of the toy tree as oatx's tree
    (factored moments are held in oatx's layout already)."""
    return {"w": port["w"], "t3": port["t3"], "lin": port["lin.weight"],
            "m": {"kernel": np.stack([port[f"m.layers.{i}.fc1.weight"] for i in range(2)])}}


def _toy_filter(path):
    """The freeze mask of both packages: txt_proj stays as it is."""
    return path[0] != "txt_proj"


TOY_OPTIONS = {"plain": {}, "clip_ema": {"grad_clip": 0.5, "ema_decay": 0.9},
               "freeze_schedule": {"freeze": True, "schedule": True},
               "betas_no_decay": {"betas": (0.8, 0.95), "weight_decay": 0.0}}
TOY_CASES = [(k, o) for k in FAMILIES for o in TOY_OPTIONS]


@pytest.mark.parametrize("kind,option", TOY_CASES)
def test_family_matches_optax_on_a_toy_tree(kind, option):
    """Five steps on the same gradients; on step 3 the bias of layer 0 has
    no gradient in the port (None) and a zero one in optax, which is what
    optax sees for an unused parameter."""
    kw = dict(TOY_OPTIONS[option])
    if kind == "adafactor":
        kw.pop("betas", None)  # Adafactor takes none
    rng = np.random.default_rng(7)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in TOY.items()}
    jkw, pkw = dict(kw), dict(kw)
    if kw.pop("schedule", False):
        jkw.pop("schedule"), pkw.pop("schedule")
        jkw["lr"] = joptim.make_schedule(LR, 2, 3, kind="cosine", warmup_steps=2)
        pkw["lr"] = poptim.make_schedule(LR, 2, 3, kind="cosine", warmup_steps=2)
    frozen = kw.pop("freeze", False)
    if frozen:
        jkw["trainable_filter"], pkw["trainable_filter"] = _toy_filter, _toy_filter
        jkw.pop("freeze"), pkw.pop("freeze")
    tx = joptim.make_optimizer(kind=kind, **{"lr": LR, **jkw})
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in init.items()}
    opt = poptim.make_optimizer(kind=kind, **{"lr": LR, **pkw})(tparams.items())
    grads = []
    for step in range(5):
        g = {n: (rng.standard_normal(s) * (step + 1)).astype(np.float32) for n, s in TOY.items()}
        if step == 2:
            g["m.layers.0.fc1.bias"][:] = 0
        grads.append(g)
    jparams, jstate = _optax_steps(
        tx, jax.tree_util.tree_map(jnp.asarray, _toy_oatx(init)),
        [jax.tree_util.tree_map(jnp.asarray, _toy_oatx(g)) for g in grads])
    port_grads = [dict(g) for g in grads]
    port_grads[2]["m.layers.0.fc1.bias"] = None
    _port_steps(opt, tparams, port_grads)

    def flat(tree):
        return {"/".join(map(str, k)): v for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    _close(flat(_toy_oatx({n: p.detach().numpy() for n, p in tparams.items()})),
           flat(to_numpy(jparams)), "params")
    named = opt.named_state()
    assert named["count"] == 5
    if kind == "adafactor":
        fac = convert_find(jstate, "v_row")
        for key in ("v_row", "v_col"):
            want = {k: v for k, v in flat(to_numpy(getattr(fac, key))).items()
                    if v.shape != (1,)}
            _close(flat(_toy_factored(named[key])), want, key)
        want_v = {k: v for k, v in flat(to_numpy(fac.v)).items() if v.shape != (1,)}
        got_v = flat(_toy_oatx({**{n: np.zeros(s, np.float32) for n, s in TOY.items()},
                                **{n: t.numpy() for n, t in named["v"].items()}}))
        _close({k: got_v[k] for k in want_v}, want_v, "v")
        assert sorted(named["v"]) == ["b", "m.layers.0.fc1.bias", "m.layers.1.fc1.bias",
                                      "txt_proj.1.weight"]
    else:
        key, field = ("mu", "mu") if kind == "lion" else ("trace", "trace")
        src = convert_find(jstate, field)
        _close(flat(_toy_oatx({n: t.numpy() for n, t in named[key].items()})),
               flat(to_numpy(getattr(src, field))), key)
    if kw.get("ema_decay"):
        _close(flat(_toy_oatx({n: t.numpy() for n, t in named["ema"].items()})),
               flat(to_numpy(joptim.find_ema(jstate))), "ema")
    if frozen:
        assert np.array_equal(tparams["txt_proj.1.weight"].detach().numpy(),
                              init["txt_proj.1.weight"])


def convert_find(state, field):
    """The first optax sub-state with `field`."""
    from oatx_torch.models.convert import _find_state

    return _find_state(state, field)


def test_adafactor_decay_is_not_scaled_by_lr():
    """optax.adafactor adds wd·p after the lr scaling: at lr 0 each step
    still takes wd of every parameter (1 % at the configs' 0.01)."""
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((130, 140)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{n: rng.standard_normal(a.shape).astype(np.float32) for n, a in init.items()}]
    tx = joptim.make_optimizer(lr=0.0, weight_decay=0.01, kind="adafactor")
    jparams, _ = _optax_steps(tx, {n: jnp.asarray(a) for n, a in init.items()},
                              [{n: jnp.asarray(a) for n, a in g.items()} for g in grads])
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in init.items()}
    _port_steps(poptim.make_optimizer(lr=0.0, weight_decay=0.01, kind="Adafactor")(
        tparams.items()), tparams, grads)
    for n, a in init.items():
        np.testing.assert_allclose(tparams[n].detach().numpy(), 0.99 * a, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(jparams[n]), 0.99 * a, rtol=1e-6)


@pytest.mark.parametrize("kind,betas", [("lion", (0.9, 0.99)), ("sgd", (0.9, 0.999)),
                                        ("adamw", (0.9, 0.999))])
def test_default_betas_follow_oatx(kind, betas):
    """betas=None is (0.9, 0.99) for Lion and (0.9, 0.999) otherwise; an
    explicit pair is taken as given (the toy tree's 'betas' cases hold it
    against optax); Adafactor takes none."""
    assert poptim.make_optimizer(kind=kind).keywords["betas"] == betas
    assert poptim.make_optimizer(kind=kind, betas=(0.5, 0.6)).keywords["betas"] == (0.5, 0.6)
    assert "betas" not in poptim.make_optimizer(kind="adafactor").keywords


# -------------------------------------------------------- the tiny tower
WIDE_VIDEO = {**TRAIN_VIDEO, "embed_dim": 128}
WIDE_TEXT = {**TRAIN_TEXT, "vocab_size": 160, "dim": 128, "hidden_dim": 128}


@functools.lru_cache(maxsize=None)
def _wide():
    """(oatx TowerConfig, port TowerConfig, oatx params) at width 128."""
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**WIDE_VIDEO, split_cls_stream=False,
                                      cls_position="first"),
        text=jdb.DistilBertConfig(**WIDE_TEXT), projection_dim=16)
    p = ptowers.TowerConfig(video=pvst.SpaceTimeViTConfig(**WIDE_VIDEO),
                            text=pdb.DistilBertConfig(**WIDE_TEXT), projection_dim=16)
    return j, p, to_numpy(oatx_params(j))


def _wide_grads(steps, seed=11):
    """One oatx gradient tree a step, each leaf ~N(0, (step + 1)²)."""
    _, _, params = _wide()
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda a, s=s: (rng.standard_normal(a.shape) * (s + 1)).astype(np.float32), params)
        for s in range(steps)]


TOWER_OPTIONS = {"plain": {}, "clip_freeze_ema": {"grad_clip": 1.0, "ema_decay": 0.9,
                                                  "freeze": True}}


def _tower_kw(opts, lib):
    """make_optimizer's keywords of a TOWER_OPTIONS entry for `lib` (oatx's
    or the port's optim module): the freeze mask leaves txt_proj as it is."""
    kw = {k: v for k, v in opts.items() if k != "freeze"}
    if opts.get("freeze"):
        kw["trainable_filter"] = lib.exclude_subtrees(None, ("txt_proj",))
    return kw


@pytest.mark.parametrize("option", list(TOWER_OPTIONS))
@pytest.mark.parametrize("kind", FAMILIES)
def test_family_matches_optax_on_the_tiny_tower(kind, option):
    """3 steps on both, params and state compared through convert; then
    oatx's state after 3 steps, carried by opt_state_from_optax into a
    fresh port optimizer over oatx's parameters, takes a 4th step that
    oatx takes too."""
    jcfg, pcfg, params = _wide()
    opts = TOWER_OPTIONS[option]
    tx = joptim.make_optimizer(lr=LR, kind=kind, **_tower_kw(opts, joptim))
    grads = _wide_grads(4)
    jparams, jstate = _optax_steps(tx, jax.tree_util.tree_map(jnp.asarray, params),
                                   [jax.tree_util.tree_map(jnp.asarray, g) for g in grads[:3]])
    make = poptim.make_optimizer(lr=LR, kind=kind, **_tower_kw(opts, poptim))
    tparams = {n: torch.nn.Parameter(t) for n, t in state_dict_from_oatx(params, pcfg).items()}
    opt = make(tparams.items())
    _port_steps(opt, tparams, [state_dict_from_oatx(g, pcfg) for g in grads[:3]])
    _close(tparams, state_dict_from_oatx(to_numpy(jparams), pcfg), "params")
    carried = opt_state_from_optax(to_numpy(jstate), pcfg)
    named = opt.named_state()
    assert sorted(carried) == sorted(named) and named["count"] == 3
    # SGD's chain at a constant lr counts nothing: the carried count is 0,
    # which no update of that chain reads
    assert carried["count"] == (0 if kind == "sgd" else 3)
    for key in named:
        if key != "count":
            _close(named[key], carried[key], key)
    # oatx's state carried across, one more step on both
    fresh = {n: torch.nn.Parameter(t) for n, t in
             state_dict_from_oatx(to_numpy(jparams), pcfg).items()}
    other = make(fresh.items())
    other.load_named_state(carried)
    _port_steps(other, fresh, [state_dict_from_oatx(grads[3], pcfg)])
    jparams, _ = _optax_steps(tx, jparams, [jax.tree_util.tree_map(jnp.asarray, grads[3])],
                              jstate)
    _close(fresh, state_dict_from_oatx(to_numpy(jparams), pcfg), "params after the carry")


def test_both_packages_factor_the_same_leaves():
    """optax's FactoredState and the port's Adafactor factor the same leaves
    of the tiny tower, more than none: stacked Linears of both towers and
    the word table."""
    jcfg, pcfg, params = _wide()
    fac = convert_find(joptim.make_optimizer(kind="adafactor").init(params), "v_row")
    oatx_factored = [v.shape for v in jax.tree_util.tree_leaves(fac.v_row) if v.shape != (1,)]
    carried = opt_state_from_optax(to_numpy(joptim.make_optimizer(kind="adafactor")
                                            .init(params)), pcfg)
    sd = state_dict_from_oatx(params, pcfg)
    opt = poptim.make_optimizer(kind="adafactor")(
        (n, torch.nn.Parameter(t)) for n, t in sd.items())
    port = sorted(n for n, f in opt.factorings.items() if f is not None)
    assert port == sorted(carried["v_row"]) == sorted(carried["v_col"])
    assert sorted(set(port) | set(carried["v"])) == sorted(sd)
    leaves = {poptim._leaf_key(n) for n in port}
    assert len(leaves) == len(oatx_factored) > 0
    assert "text_model.embeddings.word_embeddings.weight" in port
    assert "video_model.blocks.1.mlp.fc1.weight" in port
    assert "video_model.blocks.0.norm1.weight" in carried["v"]


@pytest.mark.parametrize("kind", FAMILIES)
def test_snapshot_resumes_bitwise(kind, tmp_path):
    """A snapshot of each family (train/checkpoint.py) restores the
    optimizer's state bitwise, and the restored optimizer's next step
    equals the original's bitwise."""
    _, pcfg, params = _wide()
    sd = state_dict_from_oatx(params, pcfg)
    make = poptim.make_optimizer(lr=LR, kind=kind, ema_decay=0.9)
    state = pstep.init_state(pcfg, make, device="cpu", state_dict=sd)
    grads = [state_dict_from_oatx(g, pcfg) for g in _wide_grads(3)]
    model = dict(state.model.named_parameters())
    _port_steps(state.optimizer, model, grads[:2])
    pckpt.save_checkpoint(tmp_path, "checkpoint-epoch1", state._replace(step=2), 1, 0.0)
    other = pstep.init_state(pcfg, make, device="cpu", state_dict=sd)
    other, _ = pckpt.restore_checkpoint(tmp_path / "checkpoint-epoch1", other, device="cpu")
    a, b = state.optimizer.named_state(), other.optimizer.named_state()
    assert sorted(a) == sorted(b) and a["count"] == b["count"] == 2
    for key in a:
        if key != "count":
            assert all(torch.equal(a[key][n], b[key][n]) for n in a[key]), key
    _port_steps(state.optimizer, model, grads[2:])
    _port_steps(other.optimizer, dict(other.model.named_parameters()), grads[2:])
    for n, p in other.model.named_parameters():
        assert torch.equal(p, model[n]), n


def test_another_familys_state_is_refused():
    """A snapshot of one family does not load into another, even where its
    keys include the other's (AdamW's mu and nu, Lion's mu)."""
    def make(kind):
        return poptim.make_optimizer(kind=kind)([("w", torch.nn.Parameter(torch.ones(3)))])

    for src, dst in (("adamw", "lion"), ("lion", "sgd"), ("sgd", "adafactor")):
        with pytest.raises(ValueError, match="another optimizer"):
            make(dst).load_named_state(make(src).named_state())


# ------------------------------------------------------ the sharded layouts
LAYOUTS = {  # name → (mode, model axis, pipeline)
    "zero1": ("zero1", 1, False), "fsdp": ("fsdp", 1, False),
    "mp2": (None, 2, False), "pp2": (None, 2, True)}
SHARDED_CASES = {  # name → (layout, family, make_optimizer's extra keywords)
    "adafactor_zero1": ("zero1", "adafactor", {}),
    "adafactor_fsdp_clip_ema": ("fsdp", "adafactor", {"grad_clip": 1.0, "ema_decay": 0.9}),
    "adafactor_mp2_clip": ("mp2", "adafactor", {"grad_clip": 1.0}),
    "adafactor_pp2": ("pp2", "adafactor", {}),
    "lion_zero1": ("zero1", "lion", {}), "sgd_mp2": ("mp2", "sgd", {}),
}
SHARDED_STEPS = 2
MIN_SIZE = 256


@pytest.mark.parametrize("shape", [(5,), (3, 7), (4, 3, 5), (2, 3, 4, 5)])
def test_share_boxes_tile_each_share(shape):
    """Adafactor's update of an fsdp or zero1 share runs box by box
    (optim._held_boxes): on every rank of 1-4 data ranks the boxes hold
    exactly the share's elements of the whole tensor, in order, at most
    2·ndim − 1 of them, its padding left out."""
    t = torch.arange(math.prod(shape), dtype=torch.float32).view(shape)
    for size in range(1, 5):
        for rank in range(size):
            spec = pshard.FlatShard(shape, rank, size)
            boxes = poptim._held_boxes(spec.take(t), spec)
            got = torch.cat([torch.zeros(0)] + [v.reshape(-1) for v, _ in boxes])
            want = torch.cat([torch.zeros(0)] + [t[b].reshape(-1) for _, b in boxes])
            lo = rank * spec.chunk
            assert torch.equal(got, want)
            assert torch.equal(got, t.reshape(-1)[lo:lo + spec.chunk])
            assert len(boxes) <= 2 * len(shape) - 1


@pytest.fixture(scope="module", autouse=True)
def sharded_ranks(tmp_path_factory):
    """The 2-rank launch of every case, started in the background at the
    module's first test while oatx compiles here → a future of launch_dp's
    result."""
    _, pcfg, params = _wide()
    sd = state_dict_from_oatx(params, pcfg)
    grads = [state_dict_from_oatx(g, pcfg) for g in _wide_grads(SHARDED_STEPS, seed=5)]
    cases = {}
    for name, (lay, kind, extra) in SHARDED_CASES.items():
        mode, mp, pipe = LAYOUTS[lay]
        cfg = pcfg if not pipe else dataclasses.replace(
            pcfg, video=dataclasses.replace(pcfg.video, pipeline_stages=mp))
        cases[name] = {"cfg": cfg, "state_dict": sd, "grads": grads, "mode": mode, "mp": mp,
                       "pipeline": pipe, "min_size": MIN_SIZE,
                       "opt": {"lr": LR, "kind": kind, **extra}}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(launch_dp, "optim", 2, {"cases": cases},
                      tmp_path_factory.mktemp("optim"), 300)
    yield fut
    pool.shutdown(wait=True)


def _oatx_sharded(lay, kind, extra):
    """oatx's chain on the layout's GSPMD placement of a 2-device mesh:
    the parameters (and the gradients, placed like them) by shard_params /
    shard_params_fsdp / shard_params_pipeline, the state by tx.init (and
    shard_opt_state_zero1) → (params, opt_state) after the steps."""
    mode, mp, pipe = LAYOUTS[lay]
    _, _, params = _wide()
    mesh = jmesh.make_mesh(n_devices=2, model_parallel=mp)
    try:
        tx = joptim.make_optimizer(lr=LR, kind=kind, **extra)
        if mode == "fsdp":
            sp = jshard.shard_params_fsdp(mesh, params, min_size=MIN_SIZE)
        elif pipe:
            sp = jshard.shard_params_pipeline(mesh, params)
        else:
            sp = jshard.shard_params(mesh, params)
        st = tx.init(sp)
        if mode == "zero1":
            st = jshard.shard_opt_state_zero1(mesh, st)
        where = jax.tree_util.tree_map(lambda x: x.sharding, sp)
        grads = [jax.device_put(g, where) for g in _wide_grads(SHARDED_STEPS, seed=5)]
        out = _optax_steps(tx, sp, grads, st)
    finally:
        jmesh.set_current_mesh(None)
    return to_numpy(out[0]), to_numpy(out[1])


def _factored_traffic(lay, kind, extra):
    """The optimizer's bytes a step per purpose on one rank, from the
    factoring rule (sharding.factoring) and the layout: zero1 gathers the
    updated shares; Adafactor sums an fsdp share's row and column sums over
    the data axis ('factor_sums'; zero1's come from the whole gradient),
    the sums over a split dim over the model group ('factor_split'; v_row's
    sums over a split d1 for the mean, 'factor_mean'), and every leaf's sum
    of squares over the ranks holding its parts ('block_rms')."""
    mode, mp, pipe = LAYOUTS[lay]
    out = {}

    def add(purpose, nbytes):
        if nbytes:
            rec = out.setdefault(purpose, {"bytes": 0, "calls": 0})
            rec["bytes"] += nbytes
            rec["calls"] += 1

    _, pcfg, params = _wide()
    sd = state_dict_from_oatx(params, pcfg)
    if extra.get("grad_clip") and mode != "zero1":  # the sharded gradient norm
        add("norm", 4)
    shapes = {n: tuple(t.shape) for n, t in sd.items()}
    depths = pshard._depths(shapes)
    layout = pshard.Layout(0, 2, 1, mp, pipe)
    keep, pshard.FSDP_MIN_SIZE = pshard.FSDP_MIN_SIZE, MIN_SIZE
    try:
        data = pshard.plan(shapes, layout, mode) if mode else {}
    finally:
        pshard.FSDP_MIN_SIZE = keep
    splits = {} if pipe else {n: pshard._model_split(n, s, depths, mp)
                              for n, s in shapes.items()}
    if mode == "zero1":
        add("param_update", 4 * sum(s.chunk for s in data.values()))
    if kind != "adafactor":
        return out
    fac = {n: pshard.factoring(n, s, depths) for n, s in shapes.items()}
    stage0 = {n for n in shapes if not pipe or pshard._stage_of(n, 2, 2) in (None, 0)}
    sums = mean = model = 0
    for n in stage0:
        f, split = fac[n], splits.get(n)
        if f is None:
            continue
        s = None if split is None else f.perm.index(split[0])
        rows = math.prod(f.row_shape) // (mp if s not in (None, f.d0) else 1)
        cols = math.prod(f.col_shape) // (mp if s not in (None, f.d1) else 1)
        if n in data and mode == "fsdp":  # zero1's sums come from the whole gradient
            sums += rows + cols
        model += rows if s == f.d0 else cols if s == f.d1 else 0
        if s == f.d1:  # v_row summed over its split d1 axis
            mean += rows // (f.dims[f.d1] // mp)
    add("factor_sums", 4 * sums)
    add("factor_split", 4 * model)
    add("factor_mean", 4 * mean)
    leaves = {poptim._leaf_key(n) for n in stage0}
    for grouped in ([k for k in leaves if any(poptim._leaf_key(n) == k and n in data
                                              for n in stage0)],
                    [k for k in leaves if any(poptim._leaf_key(n) == k and splits.get(n)
                                              for n in stage0)],
                    [k for k in leaves if pipe and k.startswith("video_model.blocks.")]):
        add("block_rms", 4 * len(grouped))
    return out


@pytest.mark.parametrize("name", list(SHARDED_CASES))
def test_sharded_layouts_match_oatx(name, sharded_ranks):
    """Each rank's whole parameters and optimizer state after 2 steps match
    oatx's GSPMD result; what a rank holds is sharding.state_bytes for the
    family; the optimizer's traffic a step is the derived one."""
    lay, kind, extra = SHARDED_CASES[name]
    _, pcfg, _ = _wide()
    jparams, jstate = _oatx_sharded(lay, kind, extra)
    want_params = state_dict_from_oatx(jparams, pcfg)
    want_state = opt_state_from_optax(jstate, pcfg)
    ranks = sharded_ranks.result()
    for r, out in enumerate(ranks):
        rec = out[name]
        _close(rec["params"], want_params, f"rank {r} params")
        assert rec["opt"]["count"] == SHARDED_STEPS
        assert want_state["count"] == (0 if kind == "sgd" else SHARDED_STEPS)  # as above
        for key in want_state:
            if key != "count":
                _close(rec["opt"][key], want_state[key], f"rank {r} {key}")
        assert rec["held"]["total"] == rec["predicted"]["bytes"], (r, rec["held"],
                                                                   rec["predicted"])
        assert rec["predicted"]["bytes"] < rec["predicted"]["replicated"]
        assert rec["traffic"] == _factored_traffic(lay, kind, extra), (r, rec["traffic"])


# ------------------------------------------------ the bytes at full width
BYTES_CONFIGS = {"norm": "configs/pt/cc3m_webvid/norm.json",
                 "vit_huge_pod": "configs/pt/cc3m_webvid/vit_huge_pod.json"}


@functools.lru_cache(maxsize=None)
def _full_trees(name):
    """(oatx's abstract params, the port's parameter shapes) of a config at
    its full widths, without weights."""
    from oatx.config import schema as jschema
    from oatx_torch.config import schema as pschema
    from oatx_torch.models.towers import DualTower

    with open(f"{REPO}/{BYTES_CONFIGS[name]}") as f:
        raw = json.load(f)
    raw["trainer"]["model_parallel"] = 1
    jcfg = jschema.build_tower_config(jschema.ExperimentCfg.from_dict(raw).arch)
    pcfg = pschema.build_tower_config(pschema.ExperimentCfg.from_dict(raw).arch)
    abstract = jax.eval_shape(lambda: jtowers.init(jax.random.PRNGKey(0), jcfg))
    with torch.device("meta"):
        model = DualTower(pcfg, device="meta", generator=torch.Generator())
    return abstract, {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind", ["adamw"] + FAMILIES)
@pytest.mark.parametrize("config", list(BYTES_CONFIGS))
def test_state_bytes_are_optax_bytes(config, kind):
    """Replicated, at a config's full widths: sharding.state_bytes for the
    family is the parameters, their gradients and optax's state of oatx's
    chain (jax.eval_shape of its init; Adafactor's (1,) placeholders and
    the counts left out), byte for byte."""
    abstract, shapes = _full_trees(config)
    state = jax.eval_shape(joptim.make_optimizer(kind=kind).init, abstract)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(abstract))
    if kind == "adafactor":
        fac = convert_find(state, "v_row")
        held = [x.size for tree in (fac.v_row, fac.v_col, fac.v)
                for x in jax.tree_util.tree_leaves(tree) if x.shape != (1,)]
    else:
        held = [x.size for x in jax.tree_util.tree_leaves(state) if x.ndim > 0]
    got = pshard.state_bytes(shapes, 1, None, kind=kind)
    assert got["bytes"] == got["replicated"] == 4 * (2 * n_params + sum(held))
    if kind == "adafactor":
        assert sum(held) < n_params / 50  # the factored state: under 2 % of AdamW's nu
