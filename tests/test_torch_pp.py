"""Pipeline stages over the model axis (`trainer.pipeline`), the port against
oatx's GPipe `pipeline_blocks` and its `shard_params_pipeline` step on the
CPU.

The port's ranks (tests/torch_dp_worker.py mode `pp`, 4 gloo ranks, one
thread each, started by `launch_dp` in the background while oatx compiles
here) place the tiny geometries below on their stages (parallel/sharding.py
`place_pipeline`) and run parallel/pipeline.py on the rows of their data
position: at (data 2, stages 2), at 4 stages and at (dcn 2, data 1,
stages 2). oatx runs the same work as one program on a (data, model) — or
(dcn, data, model) — mesh of as many of conftest.py's 8 CPU devices.

  * the blocks: oatx test_pipeline.py's geometry (embed 64, depth 4, 4
    heads, T = 9): the port's pipeline_blocks against its own sequential
    blocks at M = 1, 2, 4 and P = 2, 4, the output within 1e-6 relative
    and d(x) and the blocks' gradients within 2e-5 (oatx's own bounds,
    tests/test_pipeline.py:36-57), and against oatx's pipeline_blocks and
    its tower in pipeline mode on a (data 2, model 2) mesh within 1e-5;
  * the train step: the tiny tower of test_torch_tp.py at depth 4 (a
    DistilBERT of 2 layers), global batches of 8, 2 steps. Against oatx's
    make_train_step on its pipeline placement, (data 2, model 2) and
    (dcn 2, data 1, model 2): loss terms 1e-4 relative, step 1's whole
    gradients on every rank (other stages' blocks gathered, the embedding's
    and the heads' the rank's own) and the parameters after 2 steps within
    1e-4 of each tensor's largest entry, leaving out the attention key
    biases (their gradient is 0 in real arithmetic: tests/
    test_torch_shard.py); against the port's one process: loss terms and
    norms 1e-5 relative, gradients 1e-5 of scale (+ 1e-7);
  * what a rank holds equals sharding.state_bytes(pipeline=True), which at
    a config's full widths equals oatx's per-device bytes of its pipeline
    placement; the pp_* traffic of a step is the derived one;
  * the refusals: pipeline with fsdp or sequence_parallel (oatx's
    ValueErrors), a region tap, a micro-batch split that does not divide,
    and a depth that the stages do not divide.
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

from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.parallel import pipeline as jpp
from oatx.parallel import sharding as jshard
from oatx.train import optim as joptim
from oatx.train import step as jstep
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.parallel import mesh as pmesh
from oatx_torch.parallel import pipeline as ppipe
from oatx_torch.parallel import sharding as pshard
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep
from torch_port_helpers import REPO, TRAIN_LR, launch_dp, oatx_params, to_numpy

torch.set_num_threads(1)

WORLD = 4
LAUNCH_TIMEOUT_S = 300
# oatx tests/test_pipeline.py's geometry: 16 rows of 9 tokens of 64
BLOCKS = dict(img_size=32, patch_size=16, embed_dim=64, depth=4, num_heads=4, num_frames=2,
              time_init="random")
# test_torch_tp.py's tiny tower at depth 4
VIDEO = dict(img_size=32, patch_size=16, embed_dim=32, depth=4, num_heads=4, num_frames=2,
             time_init="random")
TEXT = dict(vocab_size=102, max_position_embeddings=32, dim=32, hidden_dim=64, n_layers=2,
            n_heads=4)
OBJECTS, PAD_LEN = 3, 12
ROWS, STEPS, MICRO = 8, 2, 2
# name → (dcn slices, stages): the world is 4
LAYOUTS = {"d2p2": (1, 2), "p4": (1, 4), "dcn2p2": (2, 2)}


# ------------------------------------------------------------------ blocks
@functools.lru_cache(maxsize=None)
def _block_setup():
    """(oatx params of the blocks' tower, the port's SpaceTimeViTConfig and
    state_dict, x (16, 9, 64), its cotangent w, a video (16, 2, 32, 32, 3))."""
    jcfg = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**BLOCKS, split_cls_stream=False, cls_position="first"),
        text=jdb.DistilBertConfig(**TEXT), projection_dim=16)
    params = oatx_params(jcfg)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 9, 64)) * 0.1).astype(np.float32)
    w = rng.standard_normal((16, 9, 64)).astype(np.float32)
    video = rng.standard_normal((16, 2, 32, 32, 3)).astype(np.float32)
    pcfg = pvst.SpaceTimeViTConfig(**BLOCKS)
    return params, pcfg, _video_state(params, pcfg), x, w, video


def _video_state(params, pcfg):
    """The port's video tower state_dict of oatx dual-tower `params`."""
    sd = state_dict_from_oatx(to_numpy(params), ptowers.TowerConfig(
        video=pcfg, text=pdb.DistilBertConfig(**TEXT), projection_dim=16))
    return {k[len("video_model."):]: v for k, v in sd.items() if k.startswith("video_model.")}


BLOCK_JOBS = [(p, m) for p in (2, 4) for m in (1, 2, 4)]


def _block_payload():
    _, pcfg, sd, x, w, video = _block_setup()
    jobs = {f"p{p}m{m}": {"cfg": dataclasses.replace(pcfg, pipeline_stages=p,
                                                      pipeline_microbatches=m),
                          "state_dict": sd, "x": torch.from_numpy(x),
                          "w": torch.from_numpy(w), "mp": p, "micro": m}
            for p, m in BLOCK_JOBS}
    towers = {"p2m2": {"cfg": dataclasses.replace(pcfg, pipeline_stages=2,
                                                  pipeline_microbatches=2),
                       "state_dict": sd, "video": torch.from_numpy(video), "mp": 2}}
    return jobs, towers


@functools.lru_cache(maxsize=None)
def _sequential_blocks():
    """The port's sequential blocks on x: (out, d(x), the blocks' grads)."""
    _, pcfg, sd, x, w, _ = _block_setup()
    tower = pvst.SpaceTimeTransformer(pcfg, "cpu")
    tower.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_(True)
    h = xt
    for blk in tower.blocks:
        h = blk(h, 2)
    (h * torch.from_numpy(w)).sum().backward()
    grads = {f"blocks.{n}": q.grad for n, q in tower.blocks.named_parameters()}
    return h.detach(), xt.grad, grads


# -------------------------------------------------------------- the steps
def _cfgs(variant="baseline", **video):
    """(oatx TowerConfig, port TowerConfig); oatx runs its CLS-first fused
    stream, the port's layout."""
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**VIDEO, split_cls_stream=False, cls_position="first",
                                      **video),
        text=jdb.DistilBertConfig(**TEXT), projection_dim=16, variant=variant)
    p = ptowers.TowerConfig(video=pvst.SpaceTimeViTConfig(**VIDEO, **video),
                            text=pdb.DistilBertConfig(**TEXT), projection_dim=16,
                            variant=variant)
    return j, p


@functools.lru_cache(maxsize=None)
def _params(variant="baseline"):
    return oatx_params(_cfgs(variant)[0])


def _state_dict(pcfg):
    return state_dict_from_oatx(to_numpy(_params(pcfg.variant)), pcfg)


def _batch(seed, variant="baseline"):
    rng = np.random.default_rng(seed)
    mask = np.ones((ROWS, 6), np.int32)
    mask[1::3, 4:] = 0
    out = {"video": rng.standard_normal((ROWS, 2, 32, 32, 3)).astype(np.float32),
           "input_ids": rng.integers(0, 100, (ROWS, 6)).astype(np.int32),
           "attention_mask": mask}
    if variant == "global_local":
        out["object_frame"] = rng.standard_normal((ROWS, 1, 32, 32, 3)).astype(np.float32)
        out["patch_masks"] = (rng.uniform(size=(ROWS, OBJECTS, 4)) > 0.4).astype(np.float32)
        pad = np.ones((ROWS, PAD_LEN), np.int32)
        pad[::2, 9:] = 0
        out["pad_input_ids"] = rng.integers(0, 100, (ROWS, PAD_LEN)).astype(np.int32)
        out["pad_attention_mask"] = pad
        out["object_token_masks"] = np.cumsum(rng.integers(0, 3, (ROWS, OBJECTS)),
                                              axis=1).astype(np.int32)
    return out


def _batches(variant="baseline"):
    return [_batch(s, variant) for s in range(STEPS)]


# name → (layout, tower keys, variant, AdamW keywords, make_train_step keywords, mode)
CASES = {
    "d2p2": ("d2p2", {}, "baseline", {}, {}, None),
    "dcn2p2": ("dcn2p2", {}, "baseline", {}, {}, None),
    "p4": ("p4", {}, "baseline", {}, {}, None),
    "d2p2_zero1": ("d2p2", {}, "baseline", {}, {}, "zero1"),
    "d2p2_remat": ("d2p2", dict(remat=True), "baseline", {}, {}, None),
    "d2p2_accum": ("d2p2", {}, "baseline", {}, {"accum_steps": 2}, None),
    "d2p2_fused_qkv": ("d2p2", dict(fused_qkv=True), "baseline", {}, {}, None),
    "d2p2_clip": ("d2p2", {}, "baseline", {"grad_clip": 0.05}, {}, None),
    "p4_global_local": ("p4", {}, "global_local", {}, {}, None),
}


def _case(name):
    lay, video, variant, opt, step, mode = CASES[name]
    dcn, mp = LAYOUTS[lay]
    pcfg = _cfgs(variant, **video)[1]
    pp = dataclasses.replace(pcfg, video=dataclasses.replace(
        pcfg.video, pipeline_stages=mp, pipeline_microbatches=MICRO))
    return {"cfg": pp, "state_dict": _state_dict(pcfg), "batches": _batches(variant),
            "mode": mode, "dcn": dcn, "mp": mp, "opt": {"lr": TRAIN_LR, **opt}, "step": step,
            "loss_cfg": pstep.LossConfig()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' one launch, started in the background (oatx compiles
    meanwhile): a future of launch_dp's result."""
    blocks, towers = _block_payload()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(launch_dp, "pp", WORLD,
                      {"blocks": blocks, "towers": towers,
                       "cases": {n: _case(n) for n in CASES}},
                      tmp_path_factory.mktemp("pp"), LAUNCH_TIMEOUT_S)
    yield fut
    pool.shutdown(wait=True)


def _layout(rank, name_or_layout):
    dcn, mp = LAYOUTS.get(name_or_layout, (1, None))
    return pmesh.Layout(rank, WORLD, dcn, mp, True)


def _rows(n, layout):
    return np.array_split(np.arange(n), layout.batch_shards)[layout.position]


@pytest.mark.parametrize("stages,micro", BLOCK_JOBS)
def test_pipeline_blocks_match_sequential(ranks, stages, micro):
    """Every rank's output of its position's rows, stage 0's d(x) and every
    block's whole gradient against the port's sequential blocks."""
    out, x_grad, grads = _sequential_blocks()
    name = f"p{stages}m{micro}"
    for rank, rec in enumerate(r["blocks"][name] for r in ranks.result()):
        layout = pmesh.Layout(rank, WORLD, 1, stages, True)
        rows = _rows(16, layout)
        np.testing.assert_allclose(rec["out"].numpy(), out[rows].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(out.abs().max()))
        if layout.stage == 0:
            np.testing.assert_allclose(rec["x_grad"].numpy(), x_grad[rows].numpy(),
                                       atol=2e-5, rtol=2e-5)
        assert sorted(rec["grads"]) == sorted(grads)
        sums = {n: rec["grads"][n] for n in grads}  # this position's rows only
        if layout.batch_shards == 1:
            for n, g in grads.items():
                np.testing.assert_allclose(sums[n].numpy(), g.numpy(), atol=2e-5, rtol=2e-5)
        assert set(rec["traffic"]) == ({"pp_bcast"} | ({"pp_send"} if layout.next_stage
                                                        is not None else set())
                                       | ({"pp_grad"} if layout.prev_stage is not None
                                          else set()))


def test_pipeline_block_gradients_sum_over_positions(ranks):
    """At (data 2, stages 2) each position's block gradients are of its own
    rows: the two positions' sum is the sequential gradient of all 16."""
    _, _, grads = _sequential_blocks()
    for micro in (1, 2, 4):
        recs = [r["blocks"][f"p2m{micro}"] for r in ranks.result()]
        for n, g in grads.items():
            total = recs[0]["grads"][n] + recs[2]["grads"][n]
            np.testing.assert_allclose(total.numpy(), g.numpy(), atol=2e-5, rtol=2e-5)
            assert torch.equal(recs[0]["grads"][n], recs[1]["grads"][n])


@functools.lru_cache(maxsize=None)
def _oatx_blocks():
    """oatx's pipeline_blocks (2 stages, 2 micro-batches) on a (data 2,
    model 2) mesh: (out, d(x), the blocks' grads under the port's names),
    and its tower's cls in pipeline mode on the video."""
    dual, pcfg, _, x, w, video = _block_setup()
    params = dual["video"]
    jcfg = jvst.SpaceTimeViTConfig(**BLOCKS, split_cls_stream=False, cls_position="first")
    mesh = jmesh.make_mesh(n_devices=4, model_parallel=2)
    try:
        block_fn = lambda bp, xx: jvst._block_apply(jcfg, bp, xx, 2)  # noqa: E731

        def loss(b, xx):
            out = jpp.pipeline_blocks(mesh, block_fn, b, xx, 2, 2)
            return jnp.sum(out * w), out

        (_, out), (g_b, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                          has_aux=True))(
            params["blocks"], jnp.asarray(x))
        placed = jshard.shard_params_pipeline(mesh, {"video": params})["video"]
        cfg_pp = dataclasses.replace(jcfg, pipeline_stages=2, pipeline_microbatches=2)
        v = jax.device_put(jnp.asarray(video), jmesh.batch_sharding(mesh))
        cls = jax.jit(lambda p, vv: jvst.apply(p, cfg_pp, vv)["cls"])(placed, v)
    finally:
        jmesh.set_current_mesh(None)
    grads = _video_state({**dual, "video": {**params, "blocks": g_b}}, pcfg)
    grads = {k: v for k, v in grads.items() if k.startswith("blocks.")}
    return np.asarray(out), np.asarray(g_x), grads, np.asarray(cls)


def test_pipeline_matches_oatx(ranks):
    """The port's pipeline_blocks at (data 2, stages 2) against oatx's on a
    (data 2, model 2) mesh: the output rows, stage 0's d(x) and the blocks'
    gradients (the two positions' sum) within 1e-5; the pipelined tower's
    pooled output against oatx's apply in pipeline mode within 1e-5."""
    out, x_grad, grads, cls = _oatx_blocks()
    recs = [r["blocks"]["p2m2"] for r in ranks.result()]
    towers = [r["towers"]["p2m2"] for r in ranks.result()]
    for rank, rec in enumerate(recs):
        rows = _rows(16, pmesh.Layout(rank, WORLD, 1, 2, True))
        np.testing.assert_allclose(rec["out"].numpy(), out[rows], atol=1e-5, rtol=1e-5)
        if rank % 2 == 0:
            np.testing.assert_allclose(rec["x_grad"].numpy(), x_grad[rows], atol=1e-5,
                                       rtol=1e-5)
        np.testing.assert_allclose(towers[rank]["cls"].numpy(), cls[rows], atol=1e-5,
                                   rtol=1e-5)
    for n, g in grads.items():
        g = np.asarray(g)
        total = (recs[0]["grads"][n] + recs[2]["grads"][n]).numpy()
        np.testing.assert_allclose(total, g, atol=1e-5 * max(1.0, float(np.abs(g).max())),
                                   rtol=1e-5)


# ---------------------------------------------------------- against oatx
@functools.lru_cache(maxsize=None)
def _oatx_run(lay):
    """oatx's train step on its pipeline placement (shard_params_pipeline)
    on the layout's mesh: (metrics per step, step 1's gradients and the
    parameters after 2 steps, under the port's names)."""
    dcn, mp = LAYOUTS[lay]
    jcfg, pcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, video=dataclasses.replace(
        jcfg.video, pipeline_stages=mp, pipeline_microbatches=MICRO))
    mesh = jmesh.make_mesh(n_devices=WORLD, model_parallel=mp, dcn_slices=dcn)
    try:
        tx = joptim.make_optimizer(lr=TRAIN_LR)
        st = jstep.init_state(None, jcfg, tx,
                              params=jshard.shard_params_pipeline(mesh, _params()))
        batches = [jmesh.shard_batch(mesh, b) for b in _batches()]
        grad_fn = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(p, jcfg, jstep.LossConfig(),
                                                              b)[0]))
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


EMBED = ("video_model.patch_embed.proj.weight", "video_model.patch_embed.proj.bias",
         "video_model.cls_token", "video_model.pos_embed", "video_model.temporal_embed")
HEADS = ("video_model.norm.weight", "vid_proj.0.weight", "txt_proj.1.weight",
         "text_model.transformer.layer.0.ffn.lin1.weight")


@pytest.mark.parametrize("lay", ["d2p2", "dcn2p2"])
def test_step_matches_oatx(ranks, lay):
    """Loss terms and norms per step, step 1's whole gradients on every rank
    and the whole parameters after 2 steps, against oatx's step on its
    pipeline placement on the same mesh. Each rank's gradients of the
    embedding (summed over the model group: stage 0's alone otherwise) and
    of the heads after the stack (not multiplied by the stages) are its
    own."""
    want_m, want_g, want_p = _oatx_run(lay)  # while the ranks run
    assert set(EMBED) <= set(want_g) and set(HEADS) <= set(want_g)
    for rank in ranks.result():
        got = rank["cases"][lay]
        for g, w in zip(got["metrics"], want_m):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        _close(got["grads"], want_g, mask=_key_bias_mask, what="grads")
        _close({n: got["own_grads"][n] for n in EMBED + HEADS},
               {n: want_g[n] for n in EMBED + HEADS}, what="own grads")
        _close(got["params"], want_p, mask=_key_bias_mask, what="params")


# ------------------------------------------------- against one process
@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port in one process (no stages) over the global batches of case
    `name`: (metrics per step, step 1's gradients, the parameters after the
    last step). With accum_steps a, a rank's micro-batch i is its position's
    i-th part of its rows: the global batch is handed over micro-batch-major
    (the positions' first parts, then their second parts), so one process's
    micro-batches hold the same rows."""
    case = _case(name)
    positions = WORLD // case["mp"]
    accum = case["step"].get("accum_steps", 1)

    def micro_major(v):
        return np.swapaxes(v.reshape(positions, accum, -1, *v.shape[1:]), 0, 1).reshape(
            v.shape)

    cfg = dataclasses.replace(case["cfg"], video=dataclasses.replace(
        case["cfg"].video, pipeline_stages=1))
    state = pstep.init_state(cfg, poptim.make_optimizer(**case["opt"]), device="cpu",
                             state_dict=case["state_dict"])
    fn = pstep.make_train_step(cfg, case["loss_cfg"], device="cpu", **case["step"])
    metrics, grads = [], None
    for b in case["batches"]:
        state, m = fn(state, {k: torch.from_numpy(micro_major(v)) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                     if p.grad is not None}
    return metrics, grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_one_process(ranks, name):
    """Every case against the port's one process on the same global
    batches: loss terms and norms per step, step 1's whole gradients, the
    parameters after 2 steps and the moments; the ranks agree on the
    metrics bitwise, and the stages of a position hold bitwise the same
    parameters they hold whole."""
    want_m, want_g, want_p = _one_process(name)
    recs = [r["cases"][name] for r in ranks.result()]
    for got in recs:
        assert len(got["metrics"]) == len(want_m) == STEPS
        for g, w in zip(got["metrics"], want_m):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        _close(got["grads"], want_g, scale=1e-5, floor=1e-7, what="grads")
        _close(got["params"], want_p, mask=_key_bias_mask, what="params")
        assert sorted(got["opt"]["mu"]) == sorted(want_g)
        assert got["metrics"] == recs[0]["metrics"]
    by_position = {}
    for got in recs:
        by_position.setdefault(got["layout"]["position"], []).append(got)
    for peers in by_position.values():
        assert [p["layout"]["stage"] for p in peers] == list(range(len(peers)))
        for other in peers[1:]:
            a, b = peers[0]["replicated_values"], other["replicated_values"]
            assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_clip_fires_on_the_whole_norm(ranks):
    """grad_clip 0.05 fires on every step: the norm it reads is the whole
    gradient's, the stages' blocks counted once each."""
    for rank in ranks.result():
        assert all(m["grad_norm"] > 0.05 for m in rank["cases"]["d2p2_clip"]["metrics"])


# ------------------------------------------------- bytes and traffic
def pp_traffic(cfg, rows, stage, stages, accum=1, streams=((None, None),)):
    """Bytes a rank of `stage` hands to the pipeline's sends in one step of
    `accum` micro-batches of `rows` rows (parallel/pipeline.py): per tower
    call its (rows, T, D) output once forward ('pp_send', every stage but
    the last), its input's cotangent once backward ('pp_grad', every stage
    but the first), the stack's output broadcast ('pp_bcast', every stage);
    the embedding's f32 gradients once a step ('pp_embed'). `streams`:
    (frames, img_size) of each tower call (None: the config's)."""
    v = cfg.video
    es = torch.finfo(cfg.compute_dtype).bits // 8
    out = {"pp_send": 0, "pp_grad": 0, "pp_bcast": 0}
    for frames, _ in streams:
        tokens = 1 + (frames or v.num_frames) * v.patches_per_frame
        act = rows * tokens * v.embed_dim * es * accum
        out["pp_send"] += act if stage < stages - 1 else 0
        out["pp_grad"] += act if stage > 0 else 0
        out["pp_bcast"] += act
    d, n = v.embed_dim, v.patches_per_frame
    out["pp_embed"] = 4 * (d * v.in_chans * v.patch_size ** 2 + d + d + (n + 1) * d
                           + v.num_frames * d)
    return out


@pytest.mark.parametrize("name", ["d2p2", "p4", "d2p2_accum", "p4_global_local"])
def test_pipeline_traffic_is_derived(ranks, name):
    """Step 1's pp_* bytes on every rank equal pp_traffic's."""
    case = _case(name)
    accum = case["step"].get("accum_steps", 1)
    streams = ((None, None), (1, None)) if case["cfg"].variant == "global_local" else \
        ((None, None),)
    for rank in ranks.result():
        got = rank["cases"][name]
        lay = got["layout"]
        rows = ROWS // lay["batch_shards"] // accum
        want = pp_traffic(case["cfg"], rows, lay["stage"], case["mp"], accum, streams)
        have = {k: got["traffic_step1"].get(k, {}).get("bytes", 0) for k in want}
        assert have == want, (name, lay, have, want)


def test_held_bytes_are_the_plan(ranks):
    """What each rank holds (parameters, gradients, moments, from the
    tensors' storage) equals sharding.state_bytes(pipeline=True), less than
    the replicated state; a rank holds its stage's blocks only."""
    for rank, r in enumerate(ranks.result()):
        for name, rec in r["cases"].items():
            assert rec["held"]["total"] == rec["predicted"]["bytes"], (name, rec["held"])
            assert rec["held"]["total"] < rec["predicted"]["replicated"]
            lay = _layout(rank, CASES[name][0])
            blocks = {int(n.split(".")[2]) for n in rec["held_names"]
                      if n.startswith("video_model.blocks.")}
            assert blocks == set(lay.stage_blocks(VIDEO["depth"])), name


PLACEMENT_CONFIGS = ("norm", "vit_large_pod", "vit_huge_pod")
MESHES = {"p2": (1, 2), "p4": (1, 4), "d2p2": (2, 2)}  # (data, stages)


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(oatx's abstract params, the port's parameter shapes) at a config's
    full widths, built without weights."""
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
@pytest.mark.parametrize("mode", [None, "zero1"])
@pytest.mark.parametrize("config", PLACEMENT_CONFIGS)
def test_pipeline_bytes_are_oatx_bytes(config, mode, mesh):
    """At a config's full widths the per-rank bytes of parameters,
    gradients and moments that state_bytes(pipeline=True) gives equal
    oatx's per-device bytes of shard_params_pipeline's placement (the
    blocks' depth axis over the model axis: stage_block_specs). Under zero1
    oatx re-places each moment on the data axis alone, on its first
    dimension that divides (opt_leaf_zero1_sharding): a stacked block
    moment loses its stage split and shards its depth over the data axis,
    so an oatx device holds the moments of L/data blocks where a port rank
    holds (L/P)/data (with a data axis of 1 oatx replicates them all): the
    port holds less, by the bytes computed here."""
    abstract, shapes = _trees(config)
    data, stages = MESHES[mesh]
    jm = jmesh.make_mesh(n_devices=data * stages, model_parallel=stages)
    try:
        def spec(path, leaf):
            keys = [getattr(k, "key", None) for k in path]
            return stages if keys[:2] == ["video", "blocks"] else 1

        leaves = jax.tree_util.tree_leaves_with_path(abstract)
        split = [x.size / spec(path, x) for path, x in leaves]
        if mode == "zero1":
            moments = [x.size / (data if "data" in tuple(
                jshard.opt_leaf_zero1_sharding(jm, x).spec) else 1) for _, x in leaves]
            want = 4 * 2 * sum(split) + 4 * 2 * sum(moments)
        else:
            want = 4 * 4 * sum(split)
    finally:
        jmesh.set_current_mesh(None)
    assert jpp.stage_block_specs({"w": jnp.zeros((4, 2))})["w"] == \
        jax.sharding.PartitionSpec("model", None)
    got = pshard.state_bytes(shapes, data, mode, model_parallel=stages, pipeline=True)
    assert got["bytes"] < got["replicated"]
    if mode == "zero1":  # with a data axis of 1 oatx replicates every moment
        assert got["bytes"] - got["padding"] < want
    else:
        assert abs(got["bytes"] - got["padding"] - want) <= 8, (got, want)


# ------------------------------------------------------------- raises
@pytest.mark.parametrize("keys,sp,world,error", [
    (dict(pipeline=True, model_parallel=2), False, 2, None),
    (dict(pipeline=True, model_parallel=4), False, 4, None),
    (dict(pipeline=True, model_parallel=2, zero1=True), False, 4, None),
    (dict(pipeline=True, model_parallel=2, dcn_slices=2), False, 4, None),
    (dict(pipeline=True), False, 1, None),
    (dict(pipeline=True, model_parallel=2, fsdp=True), False, 4,
     "pipeline and trainer.fsdp both use structured placements"),
    (dict(pipeline=True, model_parallel=2), True, 2,
     "sequence_parallel cannot combine with trainer.pipeline"),
    (dict(pipeline=True), True, 1, "sequence_parallel cannot combine"),
    (dict(pipeline=True, model_parallel=2, dp_mode="manual"), False, 4, "dp_mode='manual'"),
    (dict(pipeline=True, dp_mode="manual"), False, 2, "dp_mode='manual'")])
def test_check_layout(keys, sp, world, error):
    """check_layout accepts pipeline stages on a model axis that divides the
    world (with zero1 and dcn slices; a model axis of 1 is one stage) and
    raises oatx's ValueErrors for pipeline with fsdp, with the video
    tower's sequence_parallel (oatx trainer.py:78-85) and with dp_mode
    'manual' (:301-309)."""
    from oatx_torch.config.schema import TrainerCfg

    t = dataclasses.replace(TrainerCfg(), **keys)
    if error is None:
        pmesh.check_layout(t, world=world, sequence_parallel=sp)
        return
    with pytest.raises(ValueError, match=error):
        pmesh.check_layout(t, world=world, sequence_parallel=sp)


def test_region_tap_is_refused():
    """A tower with pipeline stages and a region tap raises (oatx asserts it,
    vit_spacetime.py:316); region_mem taps layer K, so its towers raise."""
    cfg = pvst.SpaceTimeViTConfig(**VIDEO, pipeline_stages=2, region_tap_layer=1)
    with pytest.raises(ValueError, match="pipeline parallelism does not support region taps"):
        pvst.SpaceTimeTransformer(cfg, "cpu")
    pcfg = _cfgs("region_mem")[1]
    pcfg = dataclasses.replace(pcfg, video=dataclasses.replace(pcfg.video, pipeline_stages=2))
    with pytest.raises(ValueError, match="region taps"):
        ptowers.DualTower(pcfg, "cpu")


def test_micro_batches_must_divide():
    """Under a grad the rows must divide by the micro-batches (oatx's
    assertion, pipeline.py:62); without one they need not."""
    layout = pmesh.Layout(0, 1, 1, 1)
    blk = torch.nn.Linear(4, 4)
    x = torch.randn(3, 2, 4)
    with pytest.raises(ValueError, match="batch 3 not divisible by 2 microbatches"):
        ppipe.pipeline_blocks([blk], x, 1, 2, layout, list(blk.parameters()))
    with torch.no_grad():
        out = ppipe.pipeline_blocks([blk], x, 1, 2, layout, list(blk.parameters()))
        np.testing.assert_allclose(out.numpy(), blk(x).numpy(), rtol=1e-6, atol=1e-6)


def test_depth_must_divide_by_the_stages():
    """A depth the stages do not divide raises oatx's assertion's message
    (pipeline.py:64) as a ValueError, at placement and in the layout."""
    with pytest.raises(ValueError, match="depth 4 not divisible by 3 stages"):
        pmesh.Layout(0, 3, 1, 3, True).stage_blocks(4)
    pcfg = _cfgs()[1]
    pcfg = dataclasses.replace(pcfg, video=dataclasses.replace(pcfg.video, pipeline_stages=3))
    model = ptowers.DualTower(pcfg, "cpu", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="depth 4 not divisible by 3 stages"):
        pshard.place(model, None, pmesh.Layout(0, 3, 1, 3, True))


def test_unplaced_stages_raise_and_one_stage_is_the_loop():
    """A tower with pipeline stages that no placement put on a model axis
    raises at its forward (oatx asserts the mesh's model axis equals the
    stages); pipeline_blocks with one stage in one process is the block
    loop, forward and backward."""
    pcfg = dataclasses.replace(_cfgs()[1].video, pipeline_stages=2)
    tower = pvst.SpaceTimeTransformer(pcfg, "cpu")
    video = torch.randn(2, 2, 32, 32, 3)
    with pytest.raises(ValueError, match="must equal the registered mesh's model axis"):
        tower(video)
    plain = pvst.SpaceTimeTransformer(_cfgs()[1].video, "cpu")
    x = plain.embed(video).detach()
    for micro in (1, 2):
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        got = ppipe.pipeline_blocks([lambda h, b=b: b(h, 2) for b in plain.blocks], xs[0],
                                    1, micro, pmesh.Layout())
        got.square().sum().backward()
        g1 = {n: p.grad.clone() for n, p in plain.blocks.named_parameters()}
        plain.zero_grad(set_to_none=True)
        want = xs[1]
        for b in plain.blocks:
            want = b(want, 2)
        want.square().sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(xs[0].grad.numpy(), xs[1].grad.numpy(), rtol=2e-5,
                                   atol=2e-5)
        for n, p in plain.blocks.named_parameters():
            np.testing.assert_allclose(g1[n].numpy(), p.grad.numpy(), rtol=2e-5, atol=2e-5)
        plain.zero_grad(set_to_none=True)
