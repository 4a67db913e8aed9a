"""The port's object-aware variants (global_local, region_mem) against oatx,
on the CPU, in f32: the region tap, the towers, the losses, the train
step's loss, fwd_chunk, the eval step, the weight bridge and the Trainer.

Tiny geometry (tests/torch_port_helpers.py TRAIN_*): a 2-block ViT (D 32, 2
heads, 2 frames at 32², 4 patches a frame; region_mem taps after block 1),
a 2-layer DistilBERT (D 32), 16-d projections, batch 4, 3 objects a clip,
numpy-seeded inputs, oatx params carried over by the state_dict bridge.

Tolerances (f32): towers and the region tap 1e-4 of each output's largest
entry; losses 1e-6 (relative, and absolute for values near 0); loss_fn's
terms rtol 1e-5 and its gradients 1e-4 of each tensor's largest entry plus
1e-7; the region tap under remat or scan_blocks, and fwd_chunk, against
the port without them: 1e-6 of scale; the masks and the MoCo ring buffer
exact; Trainer losses rtol 1e-4 as test_torch_trainer.py's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.config.schema import ExperimentCfg as JExp
from oatx.data import factory as jfactory
from oatx.data import loader as JL
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx.losses import contrastive as JC
from oatx.models import convert as jconvert
from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx.train import trainer as jtrainer_mod
from oatx_torch.config.schema import ExperimentCfg as PExp
from oatx_torch.config.schema import build_tower_config as pbuild
from oatx_torch.data import factory as pfactory
from oatx_torch.data import loader as PL
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.losses import contrastive as PC
from oatx_torch.models import convert as pconvert
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.train import checkpoint as pckpt
from oatx_torch.train import step as pstep
from oatx_torch.train import trainer as ptrainer_mod
from torch_port_helpers import (TRAIN_TEXT, TRAIN_VIDEO, MemoryClips, OatxMemoryClips,
                                oatx_params, patch_oatx_decode, port_model, t, to_numpy,
                                train_batch)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RECIPES = {"global_local": os.path.join(HERE, "..", "configs", "pt", "cc3m_webvid",
                                        "local_region_loss.json"),
           "region_mem": os.path.join(HERE, "..", "configs", "pt", "webvid", "region_mem.json")}
VARIANTS = ("global_local", "region_mem")
OBJECTS = 3
PAD_LEN = 12


def cfgs(variant, **video_kw):
    """(oatx TowerConfig, port TowerConfig) of the tiny geometry; region_mem
    taps after block 1 (the recipes' K = 6 needs 6 blocks)."""
    tap = dict(region_tap_layer=1) if variant == "region_mem" else {}
    j = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**TRAIN_VIDEO, **tap, split_cls_stream=False,
                                      cls_position="first"),
        text=jdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16, variant=variant)
    p = ptowers.TowerConfig(
        video=pvst.SpaceTimeViTConfig(**TRAIN_VIDEO, **tap, **video_kw),
        text=pdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16, variant=variant)
    return j, p


def variant_batch(variant, seed=0):
    """train_batch's clips and captions plus the variant's extras."""
    out = train_batch(seed)
    rng = np.random.default_rng(seed + 100)
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


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _close(got, want, scale=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max() + 1e-12)


@pytest.fixture(scope="module", params=VARIANTS)
def setup(request):
    variant = request.param
    jcfg, pcfg = cfgs(variant)
    params = oatx_params(jcfg)
    return variant, jcfg, pcfg, params, variant_batch(variant)


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("variant", VARIANTS)
def test_recipes_load_unchanged_and_build(variant, monkeypatch):
    """Both recipes load as they are; their towers build on device='cpu'
    (depth cut to 6 blocks and 1 text layer here) with the variant's heads; without a card and
    without that argument the build raises."""
    exp = PExp.from_dict(recipe_raw(variant))
    cfg = pbuild(exp.arch)
    assert cfg.variant == variant == JExp.from_dict(recipe_raw(variant)).arch.variant
    assert (cfg.video.embed_dim, cfg.video.depth, cfg.video.num_frames) == (768, 12, 4)
    if variant == "region_mem":
        assert cfg.video.region_tap_layer == 6 and exp.loss.region_bce_weight == 0.1
    else:
        assert cfg.video.pooling == "cls_mean_half"
    small = dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, depth=6),
                                text=dataclasses.replace(cfg.text, n_layers=1))
    names = {n for n, _ in ptowers.DualTower(small, device="cpu").named_parameters()}
    heads = {"global_local": ("text_local_proj.1.weight", "vid_local_proj.0.weight"),
             "region_mem": ("txt_proj_2.1.weight", "video_model.region_norm.weight")}[variant]
    assert set(heads) <= names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptowers.DualTower(small)


def recipe_raw(variant):
    import json

    with open(RECIPES[variant]) as f:
        return json.load(f)


def test_object_tower_still_raises():
    """Stream 3 on the global_local recipe builds oatx's object tower (the
    Trainer then keeps it frozen: tests/test_torch_object_tower.py); what
    still raises, as in oatx (towers.py:84-90), is the clip text family
    under global_local."""
    raw = recipe_raw("global_local")
    raw["arch"]["stream"] = 3
    from oatx.config.schema import build_tower_config as jbuild

    cfg = pbuild(PExp.from_dict(raw).arch)
    jcfg = jbuild(JExp.from_dict(raw).arch)
    assert dataclasses.asdict(cfg.object_tower) == dataclasses.asdict(jcfg.object_tower)
    raw["arch"]["args"]["text_params"]["model"] = "openai/clip-vit-base-patch32"
    small = dataclasses.replace(pbuild(PExp.from_dict(raw).arch), object_tower=None,
                                video=dataclasses.replace(cfg.video, depth=1))
    with pytest.raises(NotImplementedError, match="clip"):
        ptowers.DualTower(small, device="cpu")


# ------------------------------------------------------------------ masks
def test_tag_token_masks_match_oatx():
    rng = np.random.default_rng(4)
    lens = rng.integers(2, 9, 6)
    ends = np.cumsum(rng.integers(0, 4, (6, 5)), axis=1).astype(np.int32)
    for seq_len in (8, 20):
        got = ptowers.tag_token_masks(t(lens), t(ends), seq_len)
        want = jtowers.tag_token_masks(jnp.asarray(lens), jnp.asarray(ends), seq_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32


# ----------------------------------------------------------------- losses
LOSS_CASES = {
    "cross_entropy_loss": lambda r: (r.standard_normal((6, 9)), r.integers(0, 9, 6)),
    "nce_softmax_loss": lambda r: (3 * r.standard_normal((6, 9)),),
    "softmax_kl_loss": lambda r: (r.standard_normal((5, 7)), r.standard_normal((5, 7))),
    "softmax_mse_loss": lambda r: (r.standard_normal((5, 7)), r.standard_normal((5, 7))),
    "binary_cross_entropy": lambda r: (np.concatenate([[0.0, 1.0], r.uniform(0, 1, 10)]),
                                       r.uniform(0, 1, 12) > 0.5),
    "sigmoid_binary_cross_entropy": lambda r: (20 * r.standard_normal((4, 11)),
                                               r.uniform(0, 1, (4, 11)) > 0.5),
    "region_bce": lambda r: (8 * r.standard_normal((4, 3, 196)),
                             r.uniform(0, 1, (4, 3, 196)) > 0.7),
    "fine_grained_region_tag_loss": lambda r: (r.standard_normal((6, 3, 16)),
                                               r.standard_normal((6, 3, 16))),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_oatx(name):
    args = [np.asarray(a) for a in LOSS_CASES[name](np.random.default_rng(len(name)))]
    args = [a.astype(np.float32) if a.dtype.kind in "fb" else a.astype(np.int32)
            for a in args]
    want = float(getattr(JC, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(PC, name)(*[t(a) for a in args])
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def test_consistency_losses_send_no_gradient_to_targets():
    a, b = (torch.randn(3, 5, requires_grad=True) for _ in range(2))
    for fn in (PC.softmax_kl_loss, PC.softmax_mse_loss):
        fn(a, b).backward()
        assert b.grad is None and a.grad is not None


def test_region_bce_is_n_times_the_element_mean():
    r = np.random.default_rng(0)
    x, y = t(r.standard_normal((2, 3, 196)).astype(np.float32)), t(r.uniform(size=(2, 3, 196)))
    np.testing.assert_allclose(float(PC.region_bce(x, y)),
                               196 * float(PC.sigmoid_binary_cross_entropy(x, y)), rtol=1e-6)


def test_moco_queue_ring_buffer_matches_oatx():
    """Init range, logits and four updates of 3 keys into a queue of 7 (the
    writes wrap twice), against oatx's functional queue from the same
    memory."""
    gen = torch.Generator().manual_seed(0)
    q = PC.moco_queue_init(gen, 7, 16)
    stdv = 1 / np.sqrt(16 / 3)
    assert q.memory.shape == (7, 16) and q.index == 0
    assert float(q.memory.abs().max()) <= stdv and float(q.memory.std()) > stdv / 3
    jq = JC.MoCoQueue(memory=jnp.asarray(q.memory.numpy()), index=jnp.zeros((), jnp.int32))
    r = np.random.default_rng(1)
    for step in range(4):
        qv, kv, nv = (r.standard_normal((3, 16)).astype(np.float32) for _ in range(3))
        np.testing.assert_allclose(
            PC.moco_logits(t(qv), t(kv), t(nv), q).numpy(),
            np.asarray(JC.moco_logits(jnp.asarray(qv), jnp.asarray(kv), jnp.asarray(nv), jq)),
            rtol=1e-6, atol=1e-6)
        old, before = q, q.memory.clone()
        q, jq = PC.moco_queue_update(q, t(kv)), JC.moco_queue_update(jq, jnp.asarray(kv))
        np.testing.assert_array_equal(q.memory.numpy(), np.asarray(jq.memory))
        assert q.index == int(jq.index) == (3 * (step + 1)) % 7
        assert torch.equal(old.memory, before)  # the old queue is left as it was
    jloss = JC.nce_softmax_loss(JC.moco_logits(jnp.asarray(qv), jnp.asarray(kv),
                                               jnp.asarray(nv), jq))
    np.testing.assert_allclose(float(PC.nce_softmax_loss(PC.moco_logits(t(qv), t(kv), t(nv),
                                                                         q))),
                               float(jloss), rtol=1e-6)


# ----------------------------------------------------------------- towers
def test_towers_match_oatx(setup):
    variant, jcfg, pcfg, params, batch = setup
    want = jtowers.forward(params, jcfg, _jb(batch))
    got = port_model(params, pcfg)(_tb(batch))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_region_tap_matches_oatx():
    jcfg, pcfg = cfgs("region_mem")
    params = oatx_params(jcfg)
    video = train_batch()["video"]
    for frames in (video, video[:, :1]):  # the clip and a 1-frame object frame
        want = jtowers.compute_video(params, jcfg, jnp.asarray(frames))
        got = port_model(params, pcfg).compute_video(t(frames))
        for k in ("cls", "patches", "region"):
            _close(got[k], want[k])
        assert got["region"].shape == (4, frames.shape[1] * 4, 32)


def _tap_and_grads(pcfg, params, batch):
    model = port_model(params, pcfg).train()
    out = model.compute_video(t(batch["video"]))
    (out["region"].square().sum() + out["cls"].sum()).backward()
    return out["region"].detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                    if p.grad is not None}


@pytest.mark.parametrize("setting", ["full", "dots", "dots_all", "scan_blocks"])
def test_region_tap_under_remat_equals_no_remat(setting):
    jcfg, pcfg = cfgs("region_mem")
    params, batch = oatx_params(jcfg), train_batch()
    kw = (dict(scan_blocks=True) if setting == "scan_blocks"
          else dict(remat=True, remat_policy=setting))
    _, pcfg_r = cfgs("region_mem", **kw)
    ref, ref_g = _tap_and_grads(pcfg, params, batch)
    got, got_g = _tap_and_grads(pcfg_r, params, batch)
    _close(got, ref.numpy(), 1e-6)
    assert sorted(got_g) == sorted(ref_g) and "video_model.region_norm.weight" in ref_g
    for n in ref_g:
        _close(got_g[n], ref_g[n].numpy(), 1e-6)


# ------------------------------------------------------------------- step
def _port_loss_grads(pcfg, params, batch, fwd_chunk=None):
    model = port_model(params, pcfg).train()
    loss, metrics = pstep.loss_fn(model, pstep.LossConfig(), _tb(batch), fwd_chunk)
    loss.backward()
    return metrics, {n: p.grad for n, p in model.named_parameters()}


def test_loss_fn_values_and_gradients_match_oatx(setup):
    variant, jcfg, pcfg, params, batch = setup
    f = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True), static_argnums=(1, 2))
    (_, jmetrics), jgrads = f(params, jcfg, jstep.LossConfig(), _jb(batch))
    metrics, grads = _port_loss_grads(pcfg, params, batch)
    terms = {"global_local": ("loss", "loss_st2sv", "loss_lt2sv", "loss_fine"),
             "region_mem": ("loss", "loss_nce", "loss_region")}[variant]
    assert sorted(metrics) == sorted(jmetrics) == sorted(terms)
    for k in terms:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = pconvert.state_dict_from_oatx(to_numpy(jgrads), pcfg)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g is not None, n
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=n)


def test_fwd_chunk_equals_the_full_batch(setup):
    variant, jcfg, pcfg, params, batch = setup
    ref_m, ref_g = _port_loss_grads(pcfg, params, batch)
    got_m, got_g = _port_loss_grads(pcfg, params, batch, fwd_chunk=2)
    for k in ref_m:
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-6, err_msg=k)
    for n in ref_g:
        _close(got_g[n], ref_g[n].numpy(), 1e-6)


def test_eval_step_matches_oatx(setup):
    variant, jcfg, pcfg, params, batch = setup
    rng = np.random.default_rng(9)
    batch = dict(batch, video=rng.integers(0, 256, (4, 2, 40, 40, 3), dtype=np.uint8),
                 object_frame=rng.integers(0, 256, (4, 1, 40, 40, 3), dtype=np.uint8))
    want = jstep.make_eval_step(jcfg, chunk=2)(params, _jb(batch))
    got = pstep.make_eval_step(pcfg, chunk=2, device="cpu")(port_model(params, pcfg), batch)
    assert sorted(got) == sorted(want) and all(k.endswith("_embeds") for k in got)
    assert {"text_embeds", "video_embeds"} <= set(got)
    for k in want:
        _close(got[k], want[k])


def test_augmenter_draws_each_frame_key_from_its_own_generator():
    """oatx folds the key's index into the step's key: the object frame's
    crop does not depend on whether the clip was augmented first, and the
    clip's draws stay those of the step's generator."""
    rng = np.random.default_rng(0)
    video = t(rng.integers(0, 256, (2, 2, 48, 48, 3), dtype=np.uint8))
    frame = t(rng.integers(0, 256, (2, 1, 48, 48, 3), dtype=np.uint8))
    aug = pstep.make_augmenter(train=True, tower_cfg=cfgs("global_local")[1])
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    both = aug(gen(), {"video": video, "object_frame": frame})
    alone = aug(gen(), {"object_frame": frame})
    clip = aug(gen(), {"video": video})
    assert torch.equal(both["object_frame"], alone["object_frame"])
    assert torch.equal(both["video"], clip["video"])
    assert both["object_frame"].shape == (2, 1, 32, 32, 3)
    g1 = pstep.key_generator(gen(), 1)
    assert g1.initial_seed() != 11 and pstep.key_generator(gen(), 1).initial_seed() == \
        g1.initial_seed()


# ---------------------------------------------------------------- weights
def test_variant_heads_cross_by_state_dict_and_pth(setup, tmp_path):
    variant, jcfg, pcfg, params, batch = setup
    model = port_model(params, pcfg)
    ref = jconvert.frozen_in_time_to_torch(to_numpy(params), jcfg.video)
    assert sorted(model.state_dict()) == sorted(ref)
    path = str(tmp_path / "w.pth")
    jconvert.export_torch_checkpoint(path, params, jcfg.video)
    other = ptowers.DualTower(pcfg, device="cpu")
    pconvert.load_checkpoint(other, path)
    got, want = other.eval()(_tb(batch)), model(_tb(batch))
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- trainer
def _raw(tmp_path, variant):
    return {
        "name": "tiny-" + variant,
        "arch": {"type": "FrozenInTime", "variant": variant, "args": {
            "video_params": {"model": "SpaceTimeTransformer",
                             "arch_config": "base_patch16_224", "num_frames": 2,
                             "input_res": 32, "embed_dim": 32, "depth": 2,
                             "num_heads": 2, "time_init": "random"},
            "text_params": {"model": "distilbert-base-uncased", "vocab_size": 100,
                            "dim": 32, "hidden_dim": 64, "n_layers": 2, "n_heads": 2},
            "projection": "minimal", "projection_dim": 16,
            "load_checkpoint": str(tmp_path / "init.pth")}},
        "data_loader": [{"type": "x", "args": {
            "batch_size": 4, "object_params": {"top_k": 4, "num_mask_objects": 3},
            "video_params": {"input_res": 32, "num_frames": 2}}}],
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
        "loss": {"type": "NormSoftmaxLoss", "args": {}},
        "metrics": ["t2v_metrics", "v2t_metrics"],
        "trainer": {"epochs": 2, "len_epoch": 2, "save_period": 1, "verbosity": 0,
                    "init_val": True, "precision": "f32", "seed": 0,
                    "monitor": "min val_loss_0"},
    }


def _tap_at_1(build):
    """build_tower_config with region_mem's tap after block 1 (2 blocks here)."""
    def wrapped(arch, **kw):
        cfg = build(arch, **kw)
        if cfg.variant != "region_mem":
            return cfg
        return dataclasses.replace(cfg, video=dataclasses.replace(cfg.video,
                                                                  region_tap_layer=1))
    return wrapped


def _record_losses(trainer, out):
    step = trainer.train_step

    def recorded(state, batch):
        state, metrics = step(state, batch)
        out.append({k: float(v) for k, v in metrics.items() if k.startswith("loss")})
        return state, metrics

    trainer.train_step = recorded


@pytest.mark.parametrize("variant", VARIANTS)
def test_trainer_matches_oatx(tmp_path, monkeypatch, variant):
    """Both Trainers on the same in-memory corpus with object fields (each
    package's own `_add_object_extras`, loaders and collator with the
    factory's tag token lengths and region bank), from the same .pth:
    init_val, 2 epochs of 2 steps at batch 4, validation and checkpoints.
    Both train through the eval transform (their augmentation generators
    differ). Then the port's checkpoint restores bitwise, heads included."""
    monkeypatch.setattr(jtrainer_mod, "build_tower_config",
                        _tap_at_1(jtrainer_mod.build_tower_config))
    monkeypatch.setattr(ptrainer_mod, "build_tower_config",
                        _tap_at_1(ptrainer_mod.build_tower_config))
    raw = _raw(tmp_path, variant)
    pexp, jexp = PExp.from_dict(raw), JExp.from_dict(raw)
    jcfg = jtrainer_mod.build_tower_config(jexp.arch)
    jconvert.export_torch_checkpoint(str(tmp_path / "init.pth"), oatx_params(jcfg), jcfg.video)
    popts = pfactory.object_options_for_variant(variant, pexp.data_loaders[0],
                                                pfactory.load_region_bank(pexp))
    jopts = jfactory.object_options_for_variant(variant, jexp.data_loaders[0],
                                                jfactory.load_region_bank(jexp))
    pds = MemoryClips(n=16, frames=2, canon=32, object_dir=str(tmp_path / "objects"),
                      object_options=popts)
    patch_oatx_decode(monkeypatch, pds)
    jds = OatxMemoryClips(pds, jopts)
    corpus = pds.captions + [f"obj{i}" for i in range(1600)]

    def loaders(ds, tok, lens, mod):
        col = mod.Collator(tok, max_text_len=10, max_pad_text_len=24, tag_token_lens=lens)
        return ([mod.ShardedLoader(ds, 4, col, seed=0, num_workers=2)],
                [mod.ShardedLoader(ds, 8, col, shuffle=False, drop_last=False,
                                   num_workers=2)])

    mesh = jmesh.make_mesh(n_devices=1)
    try:
        jtok = JTok.build_from_corpus(corpus, vocab_size=100)
        tl, vl = loaders(jds, jtok, jfactory.tag_token_lens_for(jds.ds, jtok), JL)
        jtr = jtrainer_mod.Trainer(jexp, tl, vl, save_dir=tmp_path / "oatx", mesh=mesh)
        jtr.augment = jstep.make_augmenter(train=False, tower_cfg=jtr.tower_cfg)
        jtr.train_step = jstep.make_train_step(jtr.tower_cfg, jtr.loss_cfg, jtr.optimizer,
                                               augment=jtr.augment,
                                               base_rng=jax.random.PRNGKey(1))
        jlosses = []
        _record_losses(jtr, jlosses)
        jh = jtr.train()
    finally:
        jmesh.set_current_mesh(None)
    ptok = PTok.build_from_corpus(corpus, vocab_size=100)
    tl, vl = loaders(pds, ptok, pfactory.tag_token_lens_for(pds, ptok), PL)
    ptr = ptrainer_mod.Trainer(pexp, tl, vl, save_dir=tmp_path / "port", device="cpu")
    ptr.augment = pstep.make_augmenter(train=False, tower_cfg=ptr.tower_cfg)
    ptr.train_step = pstep.make_train_step(ptr.tower_cfg, ptr.loss_cfg, augment=ptr.augment,
                                           device="cpu")
    plosses = []
    _record_losses(ptr, plosses)
    ph = ptr.train()

    assert len(plosses) == len(jlosses) == 4
    for got, want in zip(plosses, jlosses):
        assert sorted(got) == sorted(want) and len(want) > 2
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for epoch in (1, 2):
        assert sorted(ph[epoch]) == sorted(jh[epoch])
        for k, v in jh[epoch].items():
            if k.startswith("loss_") or k.startswith("val_loss"):
                np.testing.assert_allclose(ph[epoch][k], v, rtol=1e-4, err_msg=k)
            elif k.startswith("val_"):
                assert ph[epoch][k] == v, (epoch, k)

    # the checkpoint holds the variant heads and restores bitwise
    resumed = ptrainer_mod.Trainer(pexp, tl, vl, resume=str(tmp_path / "port" /
                                                            "checkpoint-epoch2"),
                                   device="cpu")
    want_sd = ptr.state.model.state_dict()
    got_sd = resumed.state.model.state_dict()
    head = {"global_local": "vid_local_proj.0.weight", "region_mem": "txt_proj_2.1.weight"}
    assert head[variant] in got_sd
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    assert resumed.state.step == ptr.state.step == 4
    snap = pckpt._load((tmp_path / "port" / "checkpoint-epoch2").resolve(), "cpu")
    assert head[variant] in snap["optimizer"]["mu"]


# ---------------------------------------------------- chip_smoke's derivation
class _CountBackward(torch.autograd.Function):
    counts = None

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _CountBackward.counts["space_attention_bwd"] += 1
        return g


@pytest.mark.parametrize("variant,remat", [("global_local", False), ("region_mem", False),
                                           ("global_local", True), ("region_mem", True)])
def test_launch_counts_chip_smoke_derives(monkeypatch, variant, remat):
    """chip_smoke.want_launches for the object-aware variants, against the
    calls of kernels 1 and 2 (and of kernel 2's backward) that one train
    step and one eval forward make on the CPU: both video streams run every
    block forward; the backward reaches every block of the clip and, for
    region_mem, only the object frame's blocks up to the tap."""
    import sys

    sys.path.insert(0, os.path.join(HERE, ".."))
    import chip_smoke as cs
    from oatx_torch.ops import attention as patt

    counts = {"ln_mlp": 0, "space_attention": 0, "space_attention_bwd": 0, "ln_linear": 0}
    _CountBackward.counts = counts
    ln_mlp, space_attention = pvst.ln_mlp, patt.space_attention

    def counted_mlp(*a):
        counts["ln_mlp"] += 1
        return ln_mlp(*a)

    def counted_attention(*a):
        counts["space_attention"] += 1
        return _CountBackward.apply(space_attention(*a))

    monkeypatch.setattr(pvst, "ln_mlp", counted_mlp)
    monkeypatch.setattr(patt, "space_attention", counted_attention)
    jcfg, pcfg = cfgs(variant, **(dict(remat=True) if remat else {}))
    params, batch = oatx_params(jcfg), variant_batch(variant)
    model = port_model(params, pcfg).train()
    loss, _ = pstep.loss_fn(model, pstep.LossConfig(), _tb(batch))
    loss.backward()
    pstep.make_eval_step(pcfg, device="cpu")(model, batch)
    reached = (2, 2) if variant == "global_local" else (2, 1)
    assert counts == cs.want_launches(2, 1, remat, forwards=1, backward_depths=reached)
