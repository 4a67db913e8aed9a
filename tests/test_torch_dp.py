"""Data-parallel training across processes, the port against oatx on the CPU.

The port runs one process per device under torch.distributed (gloo here):
each rank steps on its rows of the global batch, gathers every cross-batch
loss input, and reduces each gradient once (oatx_torch/parallel/
collectives.py, train/step.py). oatx runs the same semantics as
`_manual_dp_grads` under shard_map (oatx/train/step.py:208-267); its
reference here runs in this process on 2 of conftest.py's 8 CPU devices.
The ranks run tests/torch_dp_worker.py (torch and oatx_torch only), two or
three processes over a file:// rendezvous, one thread each, a 120 s group
timeout and a 150 s limit per launch.

Tolerances: f32 gradients per tensor 5e-6 + 1e-4·max|ref| (as
tests/test_manual_dp.py); losses 1e-4 of scale against oatx, 1e-5 relative
between 2 ranks and one process of the port; a bf16 reduction
1e-5 + 1.6e-2·max|ref| (oatx's test_manual_grads_bf16_reduce).
"""

from __future__ import annotations

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from oatx.models import distilbert as jdb
from oatx.models import object_tower as jobjt
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx_torch.data import transforms as T
from oatx_torch.losses import contrastive as PC
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import object_tower as pobjt
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.parallel import collectives as coll
from oatx_torch.parallel import mesh as pmesh
from oatx_torch.train import optim as poptim
from oatx_torch.train import step as pstep
from torch_port_helpers import (TRAIN_TEXT, TRAIN_VIDEO, launch_dp, oatx_params, to_numpy,
                                train_batch)

torch.set_num_threads(1)

OBJ = dict(feature_dim=2054, dim=32, n_heads=4, hidden_dim=64, top_k=4, n_layers=2)
OBJECTS, PAD_LEN = 3, 12


def cfgs(variant="baseline", objects=False):
    """(oatx, port) TowerConfigs of the tiny train geometry."""
    tap = dict(region_tap_layer=1) if variant == "region_mem" else {}
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**TRAIN_VIDEO, **tap, split_cls_stream=False,
                                      cls_position="first"),
        text=jdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16, variant=variant,
        object_tower=jobjt.ObjectTowerConfig(**OBJ) if objects else None)
    p = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**TRAIN_VIDEO, **tap),
        text=pdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16, variant=variant,
        object_tower=pobjt.ObjectTowerConfig(**OBJ) if objects else None)
    return j, p


def batch_for(variant="baseline", objects=False, seed=0):
    """train_batch's 4 clips and captions with the variant's extras."""
    out = train_batch(seed)
    rng = np.random.default_rng(seed + 100)
    if objects:
        out["object"] = rng.standard_normal((4, OBJ["top_k"], 2054)).astype(np.float32)
        out["object"][2] = 0.0  # a sample with no objects
    if variant == "baseline":
        return out
    out["object_frame"] = rng.standard_normal((4, 1, 32, 32, 3)).astype(np.float32)
    out["patch_masks"] = (rng.uniform(size=(4, OBJECTS, 4)) > 0.4).astype(np.float32)
    if variant == "global_local":
        mask = np.ones((4, PAD_LEN), np.int32)
        for i, n in enumerate((12, 9, 11, 7)):
            mask[i, n:] = 0
        out["pad_input_ids"] = rng.integers(0, 100, (4, PAD_LEN)).astype(np.int32)
        out["pad_attention_mask"] = mask
        out["object_token_masks"] = np.cumsum(rng.integers(0, 3, (4, OBJECTS)),
                                              axis=1).astype(np.int32)
    else:
        out["text_region_embedding"] = 0.02 * rng.standard_normal(
            (4, OBJECTS, 512)).astype(np.float32)
    return out


# name → (variant, stream 3, the loss's object weight, make_train_step keywords)
CASES = {
    "baseline": ("baseline", False, 0.0, {}),
    "stream3": ("baseline", True, 0.5, {}),
    "global_local": ("global_local", False, 0.0, {}),
    "region_mem": ("region_mem", False, 0.0, {}),
    "fwd_chunk": ("baseline", False, 0.0, {"fwd_chunk": 1}),
    "accum": ("baseline", False, 0.0, {"accum_steps": 2}),
    "bf16_reduce": ("baseline", False, 0.0, {"grad_reduce_dtype": torch.bfloat16}),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    variant, objects, weight, kw = CASES[name]
    jcfg, pcfg = cfgs(variant, objects)
    params = oatx_params(jcfg)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, batch=batch_for(variant, objects),
                jloss=jstep.LossConfig(object_nce_weight=weight),
                ploss=pstep.LossConfig(object_nce_weight=weight), step=kw)


def _micro(batch, accum, world=2):
    """The global micro-batches of an accum_steps run: micro i holds chunk i
    of every rank's rows, rank after rank."""
    ranks = [{k: v for k, v in zip(batch, vs)}
             for vs in zip(*(np.array_split(v, world) for v in batch.values()))]
    return [{k: np.concatenate([np.array_split(r[k], accum)[i] for r in ranks])
             for k in batch} for i in range(accum)]


def _oatx_manual(c, batch, fwd_chunk=None, grad_dtype=None):
    """oatx `_manual_dp_grads` on a 2-device mesh → (loss, metrics, grads by
    the port's names)."""
    mesh = jmesh.make_mesh(2)
    try:
        sp = jax.device_put(to_numpy(c["params"]), jmesh.replicated(mesh))
        fn = jax.jit(lambda p, b: jstep._manual_dp_grads(
            p, b, c["jcfg"], c["jloss"], fwd_chunk, mesh, jmesh.batch_axes(mesh), grad_dtype))
        (loss, metrics), g = fn(sp, jmesh.shard_batch(mesh, batch))
    finally:
        jmesh.set_current_mesh(None)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in state_dict_from_oatx(to_numpy(g), c["pcfg"]).items()})


def _port_one_process(c, batch, fwd_chunk=None):
    """The port's loss and gradients on one process over `batch`."""
    model = pstep.init_state(c["pcfg"], poptim.make_optimizer(), device="cpu",
                             state_dict=state_dict_from_oatx(to_numpy(c["params"]),
                                                             c["pcfg"])).model
    loss, m = pstep.loss_fn(model, c["ploss"], {k: torch.from_numpy(v) for k, v in batch.items()},
                            fwd_chunk)
    loss.backward()
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None})


def _mean_of(parts):
    """Metrics and gradients averaged over micro-batches."""
    return ({k: float(np.mean([m[k] for m, _ in parts])) for k in parts[0][0]},
            {n: np.mean([g[n] for _, g in parts], axis=0) for n in parts[0][1]})


def grads_close(got, want, base=5e-6, of_max=1e-4):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n].numpy() if isinstance(got[n], torch.Tensor) else got[n]
        np.testing.assert_allclose(g, w, rtol=0, atol=base + of_max * np.abs(w).max(),
                                   err_msg=n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 2-rank launch runs every case's step: → [rank 0's, rank 1's]
    {case: {grads, metrics, calls, traffic}}."""
    cases = {}
    for name in CASES:
        c = _case(name)
        cases[name] = {"cfg": c["pcfg"], "loss_cfg": c["ploss"], "step": c["step"],
                       "batch": c["batch"],
                       "state_dict": state_dict_from_oatx(to_numpy(c["params"]), c["pcfg"])}
    return launch_dp("step", 2, {"cases": cases}, tmp_path_factory.mktemp("dp_step"))


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("world", [2, 3])
def test_collectives_forward_and_backward(tmp_path, world):
    """all_gather_rows concatenates in rank order; its backward sums the
    cotangent over ranks (JAX's transpose), so x_r's gradient is world·w_r
    and θ's mean over ranks is the one-process gradient of the concatenated
    rows (a backward that only sliced would leave θ's at 1/world of it).
    mean_across_ranks, reduce_gradients in buckets, all_gather_ragged,
    broadcast_tensors and norm_softmax_loss_global likewise; and the train
    augmenter draws for the global batch, so the ranks' rows are one
    process's, bitwise."""
    rng = np.random.default_rng(world)
    x = torch.from_numpy(rng.standard_normal((2 * world, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2 * world, 6)).astype(np.float32))
    video = torch.from_numpy(rng.integers(0, 256, (2 * world, 2, 40, 40, 3), dtype=np.uint8))
    obj = torch.from_numpy(rng.integers(0, 256, (2 * world, 1, 40, 40, 3), dtype=np.uint8))
    tcfg = T.TransformConfig(input_res=32, color_jitter=(0.4, 0.4, 0.1))
    outs = launch_dp("collectives", world, {"x": x, "w": w, "video_u8": video,
                                            "object_u8": obj, "seed": 7,
                                            "transform_cfg": tcfg}, tmp_path)

    theta = torch.nn.Parameter(torch.eye(6) + 0.1)
    ((x @ theta) * w).sum().backward()
    want_theta = theta.grad.clone()
    theta.grad = None
    ((x @ theta) * w).sum().div(world).backward()
    want_mean_theta = theta.grad
    t, v = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want_loss = PC.norm_softmax_loss(PC.sim_matrix(t, v))
    want_loss.backward()
    aug = pstep.make_augmenter(train=True, transform_cfg=tcfg)(
        torch.Generator().manual_seed(7), {"video": video, "object_frame": obj})
    for r, out in enumerate(outs):
        rows = slice(2 * r, 2 * r + 2)
        torch.testing.assert_close(out["gathered"], x @ theta.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out["x_grad"], world * (w[rows] @ theta.detach().t()),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["theta_grad"], want_theta, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out["mean"], ((x @ theta) * w).sum().detach() / world,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out["mean_theta_grad"], want_mean_theta, rtol=1e-5,
                                   atol=1e-6)
        mean = (world + 1) / 2
        assert torch.equal(out["reduced"][0], torch.full((3, 5), mean))
        assert torch.equal(out["reduced"][1], torch.arange(7.0) * mean)
        assert torch.equal(out["reduced"][2], torch.full((2,), -(world - 1) / 2))
        # 24 elements of 4 bytes, each once: buckets of at most 40 bytes, or
        # one tensor that is larger (60 bytes, then 28 + 8)
        assert out["reduce_traffic"] == {"bytes": 96, "calls": 2}
        assert torch.equal(out["ragged"], torch.cat(
            [torch.full((k + 1, 2), float(k)) for k in range(world)]))
        assert torch.equal(out["broadcast"][0], torch.zeros(4))
        assert torch.equal(out["broadcast"][1], torch.full((2, 2), 10.0))
        torch.testing.assert_close(out["global_loss"], want_loss.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out["global_t_grad"], world * t.grad[rows], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(out["global_v_grad"], world * v.grad[rows], rtol=1e-5,
                                   atol=1e-6)
        for key in ("video", "object_frame"):
            assert torch.equal(out["augmented"][key], aug[key][rows]), (r, key)


def test_one_rank_group_is_the_plain_step(tmp_path):
    """Under a group of one process the collectives send nothing and the
    step is the one-device step, bitwise (oatx adds no collective when the
    batch has one shard)."""
    c = _case("global_local")
    sd = state_dict_from_oatx(to_numpy(c["params"]), c["pcfg"])
    batch = c["batch"]

    def run():
        state = pstep.init_state(c["pcfg"], poptim.make_optimizer(lr=1e-3), device="cpu",
                                 state_dict=sd)
        fn = pstep.make_train_step(c["pcfg"], c["ploss"], device="cpu",
                                   grad_reduce_dtype=torch.bfloat16)
        state, m = fn(state, batch)
        return m, state.model.state_dict()

    want_m, want_sd = run()
    dist.init_process_group("gloo", init_method=(tmp_path / "store").as_uri(), rank=0,
                            world_size=1)
    try:
        assert pmesh.current_layout() == pmesh.Layout(0, 1)
        x = torch.ones(2, 3)
        assert coll.all_gather_rows(x) is x and coll.mean_across_ranks(x) is x
        coll.reset_traffic()
        got_m, got_sd = run()
        assert not coll.TRAFFIC
    finally:
        dist.destroy_process_group()
    assert got_m.keys() == want_m.keys()
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_oatx_manual_dp(ranks, name):
    """2 ranks of the port against oatx's `_manual_dp_grads` on a 2-device
    mesh over the same global batch: loss terms and the reduced gradients;
    both ranks hold the same gradients and metrics, bitwise. accum_steps:
    each micro-batch gathers its own global negatives (oatx per micro-batch,
    averaged); bf16_reduce against oatx's bf16 reduction."""
    c = _case(name)
    kw = c["step"]
    if "accum_steps" in kw:
        parts = []
        for mb in _micro(c["batch"], kw["accum_steps"]):
            _, m, g = _oatx_manual(c, mb)
            parts.append((m, g))
        want_m, want_g = _mean_of(parts)
    else:
        _, want_m, want_g = _oatx_manual(
            c, c["batch"], kw.get("fwd_chunk"),
            jnp.bfloat16 if kw.get("grad_reduce_dtype") is not None else None)
    r0, r1 = ranks[0][name], ranks[1][name]
    for k, w in want_m.items():
        np.testing.assert_allclose(r0["metrics"][k], w, rtol=0, atol=1e-4 * abs(w), err_msg=k)
    if "grad_reduce_dtype" in kw:
        grads_close(r0["grads"], want_g, 1e-5, 1.6e-2)
    else:
        grads_close(r0["grads"], want_g)
    assert r0["metrics"] == r1["metrics"]
    assert all(torch.equal(r0["grads"][n], r1["grads"][n]) for n in r0["grads"])


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process(ranks, name):
    """2 ranks against the port's own one-process loss and gradient on the
    concatenated batch (with accum_steps, on each global micro-batch,
    averaged); bf16_reduce against the f32 gradient at bf16's tolerance."""
    c = _case(name)
    kw = c["step"]
    if "accum_steps" in kw:
        want_m, want_g = _mean_of([_port_one_process(c, mb)
                                   for mb in _micro(c["batch"], kw["accum_steps"])])
    else:
        want_m, want_g = _port_one_process(c, c["batch"], kw.get("fwd_chunk"))
    got = ranks[0][name]
    for k, w in want_m.items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5, err_msg=k)
    if "grad_reduce_dtype" in kw:
        grads_close(got["grads"], want_g, 1e-5, 1.6e-2)
    else:
        grads_close(got["grads"], want_g)


@pytest.mark.parametrize("name", ["baseline", "stream3", "region_mem", "bf16_reduce"])
def test_all_reduced_bytes_are_the_parameter_bytes(ranks, name):
    """Per step the gradient reduction sends each trainable parameter's
    bytes in the reduce dtype once, in buckets; every other all_reduce is
    the gathers' backward ((world·B, D) f32 per gathered embedding set) or
    region_mem's averaged BCE (one f32 scalar forward, one back). Counted by a wrapper around
    torch.distributed.all_reduce (the counterpart of
    test_manual_dp_reduces_exactly_param_bytes_with_split_stream)."""
    out = ranks[0][name]
    wire = 2 if name == "bf16_reduce" else 4
    param_elems = sum(g.numel() for g in out["grads"].values())
    traffic, calls = out["traffic"], out["calls"]
    assert traffic["grad"]["bytes"] == wire * param_elems
    assert traffic["grad"]["calls"] == -(-wire * param_elems // coll.BUCKET_BYTES)
    gathered = {"baseline": 2, "stream3": 3, "region_mem": 2, "bf16_reduce": 2}[name]
    assert traffic["gather_bwd"] == {"bytes": gathered * 4 * 16 * 4, "calls": gathered}
    assert traffic.get("mean") == ({"bytes": 8, "calls": 2} if name == "region_mem" else None)
    reduced = [k for k in traffic if k in ("grad", "gather_bwd", "mean")]
    assert sum(b for b, _ in calls) == sum(traffic[k]["bytes"] for k in reduced)
    assert len(calls) == sum(traffic[k]["calls"] for k in reduced)
    assert sum(b for b, d in calls if d == ("torch.bfloat16" if wire == 2 else "torch.float32")) \
        >= wire * param_elems


def test_worker_imports_no_jax_and_no_oatx():
    """The ranks' code (tests/torch_dp_worker.py with its dataset,
    tests/torch_port_clips.py) runs on the port alone: a fresh isolated
    interpreter imports both without jax or the oatx package."""
    import subprocess
    import sys

    from torch_port_helpers import DP_WORKER, REPO

    code = ("import sys; sys.path[:0] = sys.argv[1:3]; "
            "import torch_dp_worker, torch_port_clips, oatx_torch.train.trainer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'oatx', 'flax', 'optax')); "
            "assert not bad, bad")
    tests = str(pathlib.Path(DP_WORKER).parent)
    out = subprocess.run([sys.executable, "-I", "-c", code, tests, REPO],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
