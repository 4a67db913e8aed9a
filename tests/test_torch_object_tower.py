"""The port's object tower (stream 3) against oatx on the CPU: the tower and
`compute_object`, the object NCE terms and their gradients, the Trainer
training it (object_nce_weight 0.5) or keeping it frozen (weight 0), and
`evaluate`'s o2v / o2t streams.

Tiny geometry: the train tests' 2-block ViT (D 32, 2 frames at 32²) and
2-layer DistilBERT (D 32), 16-d projections; the object tower at width 32
(1 or 2 layers, 4 heads, hidden 64) over 2054-d features, 4 slots a sample
with zero-padded slots and an empty sample; oatx params carried over by
`state_dict_from_oatx`.

Tolerances (f32): towers within 1e-4 of each output's largest entry; the
loss terms within 1e-6 (relative); gradients within 1e-4 of each tensor's
largest entry (plus 1e-7); Trainer losses per step rtol 1e-4; the frozen
subtrees bitwise; the eval streams' metrics equal. bf16: 5e-2 of scale.
"""

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.config.schema import ExperimentCfg as JExp
from oatx.config.schema import build_tower_config as jbuild
from oatx.data import loader as JL
from oatx.data.datasets.base import ObjectOptions as JOpts
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx.eval import retrieval_eval as JR
from oatx.models import distilbert as jdb
from oatx.models import object_tower as jobjt
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx.train.trainer import Trainer as JTrainer
from oatx_torch.config.schema import ExperimentCfg as PExp
from oatx_torch.config.schema import build_tower_config as pbuild
from oatx_torch.data import loader as PL
from oatx_torch.data.datasets.base import ObjectOptions as POpts
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.eval import retrieval_eval as PR
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import object_tower as pobjt
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.models.convert import state_dict_from_oatx
from oatx_torch.train import step as pstep
from oatx_torch.train.trainer import Trainer as PTrainer
from torch_port_helpers import (TRAIN_TEXT, TRAIN_VIDEO, MemoryClips, OatxMemoryClips,
                                oatx_params, port_model, t, to_numpy, train_batch)

torch.set_num_threads(1)
SLOTS = 4
OBJ = dict(feature_dim=2054, dim=32, n_heads=4, hidden_dim=64, top_k=SLOTS)


def cfgs(layers=2, bf16=False):
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**TRAIN_VIDEO, split_cls_stream=False,
                                      cls_position="first"),
        text=jdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16,
        object_tower=jobjt.ObjectTowerConfig(n_layers=layers, **OBJ),
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    p = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**TRAIN_VIDEO), text=pdb.DistilBertConfig(**TRAIN_TEXT),
        projection_dim=16, object_tower=pobjt.ObjectTowerConfig(n_layers=layers, **OBJ),
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return j, p


def objects(seed=0, b=4):
    """(b, 4, 2054) features: sample 0 with 2 objects, sample 2 with none."""
    x = np.random.default_rng(seed).standard_normal((b, SLOTS, 2054)).astype(np.float32)
    x[0, 2:] = 0.0
    x[2] = 0.0
    return x


def close(got, want, scale=1e-4, extra=1e-12):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max() + extra)


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = cfgs()
    params = oatx_params(jcfg)
    return jcfg, pcfg, params, port_model(params, pcfg)


# ------------------------------------------------------------------ tower
@pytest.mark.parametrize("layers", [1, 2])
def test_object_tower_and_compute_object_match_oatx(layers):
    jcfg, pcfg = cfgs(layers)
    params = oatx_params(jcfg)
    model = port_model(params, pcfg)
    x = objects(layers)
    with torch.no_grad():
        close(model.object_tower(t(x)),
              jobjt.apply(params["object_tower"], jcfg.object_tower, jnp.asarray(x)))
        got = model.compute_object(t(x))
    close(got, jtowers.compute_object(params, jcfg, jnp.asarray(x)))
    assert got.shape == (4, 16) and got.dtype == torch.float32


def test_object_tower_bf16_cast_order():
    """bf16: the mask after the cast, pooling logits in bf16 masked with the
    f32 minimum, softmax in f32, obj_proj in f32 (oatx's order)."""
    jcfg, pcfg = cfgs(bf16=True)
    params = oatx_params(jcfg)
    model = port_model(params, pcfg)
    x = objects(5)
    with torch.no_grad():
        pooled = model.object_tower(t(x), dtype=torch.bfloat16)
        got = model.compute_object(t(x))
    assert pooled.dtype == torch.bfloat16
    close(got, jtowers.compute_object(params, jcfg, jnp.asarray(x)), 5e-2)


def test_padding_slots_and_empty_samples(setup):
    """Extra all-zero slots change nothing; an all-empty batch is finite."""
    _, _, _, model = setup
    x = objects(1)
    wider = np.zeros((4, SLOTS + 3, 2054), np.float32)
    wider[:, :SLOTS] = x
    with torch.no_grad():
        close(model.compute_object(t(wider)), model.compute_object(t(x)).numpy(), 1e-5)
        assert torch.isfinite(model.compute_object(torch.zeros(2, SLOTS, 2054))).all()


# ------------------------------------------------------------- loss, grads
def _batch():
    b = train_batch(2)
    b["object"] = objects(3)
    return b


def test_object_nce_loss_and_gradients_match_oatx(setup):
    """loss_fn with object_nce_weight 0.5 adds o2v + t2o (loss_object) and
    sends gradients into the object tower, as oatx's; at 0 neither."""
    jcfg, pcfg, params, _ = setup
    b = _batch()
    f = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True), static_argnums=(1, 2))
    (_, jm), jgrads = f(params, jcfg, jstep.LossConfig(object_nce_weight=0.5),
                        {k: jnp.asarray(v) for k, v in b.items()})
    want = state_dict_from_oatx(to_numpy(jgrads), pcfg)
    for weight in (0.5, 0.0):
        model = port_model(params, pcfg).train()
        loss, m = pstep.loss_fn(model, pstep.LossConfig(object_nce_weight=weight),
                                {k: t(v) for k, v in b.items()})
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        obj = [g for n, g in grads.items() if n.startswith(("object_tower", "obj_proj"))]
        if not weight:
            assert sorted(m) == ["loss"] and all(g is None for g in obj)
            continue
        assert sorted(m) == sorted(jm) == ["loss", "loss_object"]
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
        for name, g in grads.items():
            close(g, want[name], 1e-4, 1e-7)
        assert len(obj) == 33 and all(g.abs().sum() > 0 for g in obj)


# ---------------------------------------------------------------- trainer
def _raw(weight):
    return {
        "name": "stream3",
        "arch": {"type": "FrozenInTime", "stream": 3, "args": {
            "video_params": {"model": "SpaceTimeTransformer",
                             "arch_config": "base_patch16_224", "num_frames": 2,
                             "input_res": 32, "embed_dim": 32, "depth": 2,
                             "num_heads": 2, "time_init": "random"},
            "text_params": {"model": "distilbert-base-uncased", "vocab_size": 100,
                            "dim": 32, "hidden_dim": 64, "n_layers": 2, "n_heads": 2},
            "object_params": {"model": "ObjectTransformer", "input_objects": True,
                              "top_k": SLOTS},
            "projection": "minimal", "projection_dim": 16}},
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3, "weight_decay": 0.05}},
        "loss": {"type": "NormSoftmaxLoss", "args": {"object_nce_weight": weight}},
        "metrics": ["t2v_metrics"],
        "trainer": {"epochs": 2, "len_epoch": 2, "save_period": 100, "verbosity": 0,
                    "init_val": False, "precision": "f32", "seed": 0, "monitor": "off"},
    }


@pytest.fixture
def keep_sigterm():
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    yield
    for s, h in handlers.items():
        signal.signal(s, h)


def _record(trainer, out):
    step = trainer.train_step

    def recorded(state, batch):
        state, metrics = step(state, batch)
        out.append({k: float(v) for k, v in metrics.items() if k.startswith("loss")})
        return state, metrics

    trainer.train_step = recorded


def _object_subtrees(named):
    return {n: np.array(v) for n, v in named if n.startswith(("object_tower", "obj_proj"))}


@pytest.mark.parametrize("weight", [0.5, 0.0])
def test_trainer_stream3_matches_oatx(tmp_path, keep_sigterm, weight):
    """Both Trainers on the same in-memory clips with BUTD features (each
    package's own `_add_object_extras` and loaders), from the same weights,
    through the eval transform: 2 epochs of 2 steps at batch 4. At 0.5 the
    losses and loss_object match per step and the object tower moves; at 0
    it is bitwise unchanged in both packages (no update, no weight decay)."""
    raw = _raw(weight)
    jexp, pexp = JExp.from_dict(raw), PExp.from_dict(raw)
    pds = MemoryClips(n=16, frames=2, canon=32, object_dir=str(tmp_path / "objects"),
                      object_options=POpts(features=True, features_top_k=SLOTS))
    jds = OatxMemoryClips(pds, JOpts(features=True, features_top_k=SLOTS))
    params = oatx_params(jbuild(jexp.arch))
    start = state_dict_from_oatx(to_numpy(params), pbuild(pexp.arch))  # oatx donates params

    def loaders(ds, tok_cls, mod):
        col = mod.Collator(tok_cls.build_from_corpus(pds.captions, vocab_size=100),
                           max_text_len=10)
        return [mod.ShardedLoader(ds, 4, col, seed=0, num_workers=2)]

    mesh = jmesh.make_mesh(n_devices=1)
    try:
        jtr = JTrainer(jexp, loaders(jds, JTok, JL), save_dir=tmp_path / "oatx", mesh=mesh)
        jtr.state = jstep.init_state(None, jtr.tower_cfg, jtr.optimizer, params=params)
        jtr.augment = jstep.make_augmenter(train=False, tower_cfg=jtr.tower_cfg)
        jtr.train_step = jstep.make_train_step(jtr.tower_cfg, jtr.loss_cfg, jtr.optimizer,
                                               augment=jtr.augment,
                                               base_rng=jax.random.PRNGKey(1))
        jlosses = []
        _record(jtr, jlosses)
        jtr.train()
        jfinal = jtr.state.params
    finally:
        jmesh.set_current_mesh(None)
    ptr = PTrainer(pexp, loaders(pds, PTok, PL), save_dir=tmp_path / "port", device="cpu")
    ptr.state.model.load_state_dict(start)
    before = _object_subtrees(ptr.state.model.state_dict().items())
    ptr.augment = pstep.make_augmenter(train=False, tower_cfg=ptr.tower_cfg)
    ptr.train_step = pstep.make_train_step(ptr.tower_cfg, ptr.loss_cfg, augment=ptr.augment,
                                           device="cpu")
    plosses = []
    _record(ptr, plosses)
    ptr.train()

    assert len(plosses) == len(jlosses) == 4
    for got, want in zip(plosses, jlosses):
        assert sorted(got) == sorted(want) == (["loss", "loss_object"] if weight else ["loss"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    after = _object_subtrees(ptr.state.model.state_dict().items())
    jafter = _object_subtrees(state_dict_from_oatx(to_numpy(jfinal), ptr.tower_cfg).items())
    jbefore = _object_subtrees(start.items())
    assert sorted(after) == sorted(before) and len(before) == 33  # 2 layers
    # (AdamW's first steps move a weight by ≈ lr whatever its gradient's
    # size, so the trained weights are compared through the losses)
    moved = [n for n in before if not np.array_equal(after[n], before[n])]
    jmoved = [n for n in before if not np.array_equal(jafter[n], jbefore[n])]
    assert moved == jmoved == (list(before) if weight else [])


# ------------------------------------------------------------------- eval
class ObjectCorpus:
    """16 rows: 8 videos × 2 sliding windows (`window_group`), each row a
    distinct clip, caption and object list."""

    dataset_name = "ObjectCorpus"

    def __len__(self):
        return 16

    def get_sample(self, i, rng):
        g = np.random.default_rng(i)
        obj = g.standard_normal((SLOTS, 2054)).astype(np.float32)
        obj[i % SLOTS + 1:] = 0.0
        return {"video": g.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
                "text": f"clip {i // 2} shows thing{i // 2}", "object": obj,
                "meta": {"index": i, "window_group": i // 2}}


def test_evaluate_object_streams_match_oatx(setup):
    """o2v (object ↔ video) and o2t (text ↔ object) streams, ensembled over
    the windows as the videos are: the same embeddings and metrics."""
    jcfg, pcfg, params, model = setup
    ds = ObjectCorpus()
    captions = [ds.get_sample(i, None)["text"] for i in range(16)]
    metrics = ["t2v_metrics", "v2t_metrics"]

    def loader(tok_cls, mod):
        col = mod.Collator(tok_cls.build_from_corpus(captions, vocab_size=100), max_text_len=10)
        return mod.ShardedLoader(ds, 8, col, shuffle=False, drop_last=False, num_workers=1)

    want = JR.evaluate(params, jcfg, loader(JTok, JL), metrics)
    got = PR.evaluate(model, pcfg, loader(PTok, PL), metrics, device="cpu")
    assert got.object_embeds.shape == want.object_embeds.shape == (8, 16)
    close(got.object_embeds, want.object_embeds)
    assert sorted(got.object_streams) == sorted(want.object_streams) == ["o2t", "o2v"]
    assert got.object_streams == want.object_streams
    assert got.metrics == want.metrics


def test_stream3_config_builds_the_object_tower():
    """arch.stream 3 (or object_params.model) builds oatx's ObjectTowerConfig
    with the config's top_k; the model gets object_tower and obj_proj."""
    raw = _raw(0.5)
    p, j = pbuild(PExp.from_dict(raw).arch), jbuild(JExp.from_dict(raw).arch)
    assert dataclasses.asdict(p.object_tower) == dataclasses.asdict(j.object_tower)
    assert p.object_tower.top_k == SLOTS and p.object_tower.feature_dim == 2054
    raw["arch"]["stream"] = 2
    assert pbuild(PExp.from_dict(raw).arch).object_tower is not None  # object_params.model
    raw["arch"]["args"]["object_params"]["model"] = ""
    assert pbuild(PExp.from_dict(raw).arch).object_tower is None
    names = {n for n, _ in ptowers.DualTower(cfgs(1)[1], device="cpu").named_parameters()}
    assert {"obj_proj.weight", "object_tower.pool_query",
            "object_tower.layers.0.attn.qkv.weight"} <= names
