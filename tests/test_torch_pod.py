"""The pod recipes (configs/pt/cc3m_webvid/vit_{large,huge}_pod.json) on one
device, and region_mem from a built bank, against oatx on the CPU in f32.

ViT-H/14 has 16 heads of 80: tiny here as 2 heads over embed 160 (Dh 80),
and at img 32 with patch 2 a frame has N = 256 patches, so each frame group
holds 257 keys, the shape kernel 2 takes since its Dh-80 / 272-key
instantiations. The recipes set `sequence_parallel` and `fsdp`, which oatx
runs on a 1-device mesh as a no-op and as replication, as the port does in
one process (across processes the port shards under fsdp:
tests/test_torch_shard.py), and `model_parallel` 4, which one device
refuses in both packages; the Trainers here run with
`model_parallel` 1 and every other pod key (remat dots_all, accum_steps 2,
the chunked NormSoftmax, skip_nonfinite, async checkpoints, cosine
warm-up), through each package's own loaders, from one .pth.

The region_mem case: the builder's CLIP bank has rms ≈ 1 where the seeded
bank's is 0.02, and on the card `loss_region` rose over a few steps from
it. Both packages' builders make a bank of rms ≈ 1 from the same random
CLIP weights; both region_mem Trainers train from those banks, and their
per-step loss terms (loss_region among them) are held to each other.

Tolerances: the tower's outputs 1e-4 of each output's largest entry; the
banks 1e-4 (as tests/test_torch_towers.py's builder test); Trainer loss
terms rtol 1e-4 as tests/test_torch_trainer.py's.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.config import schema as jschema
from oatx.data import factory as jfactory
from oatx.data import loader as JL
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx.models import clip_text as jclip
from oatx.models import convert as jconvert
from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx.train import trainer as jtrainer_mod
from oatx_torch.config import schema as pschema
from oatx_torch.data import clip_tokenizer as pctok
from oatx_torch.data import factory as pfactory
from oatx_torch.data import loader as PL
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.parallel import mesh as pmesh
from oatx_torch.train import step as pstep
from oatx_torch.train import trainer as ptrainer_mod
from torch_port_helpers import (TRAIN_TEXT, MemoryClips, OatxMemoryClips, oatx_params,
                                patch_oatx_decode, port_model, t)

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
POD = {name: os.path.join(REPO, "configs", "pt", "cc3m_webvid", f"{name}.json")
       for name in ("vit_large_pod", "vit_huge_pod")}
# ViT-H/14 at a tiny width: embed 160 over 2 heads (Dh 80), 2 blocks, patch 2
TINY_HUGE = (160, 2, 2, 2)
TINY_VIDEO = dict(img_size=32, patch_size=2, embed_dim=160, depth=2, num_heads=2,
                  num_frames=2, time_init="random")


def _load(name):
    with open(POD[name]) as f:
        return json.load(f)


@pytest.fixture
def keep_sigterm():
    import signal

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    yield
    for s, h in handlers.items():
        signal.signal(s, h)


@pytest.mark.parametrize("name,dh", [("vit_large_pod", 64), ("vit_huge_pod", 80)])
def test_pod_configs_load_in_both_packages(name, dh):
    """Both recipes as shipped load in both packages to the same tower and
    trainer keys. With `model_parallel: 4` on one device both refuse:
    oatx's make_mesh (4 does not divide 1 device) and the port's layout
    check (tensor parallelism, ROADMAP A8b). With 1 both accept, `fsdp` and
    `sequence_parallel` included (the port's fsdp at any world:
    tests/test_torch_shard.py)."""
    raw = _load(name)
    jexp, pexp = jschema.ExperimentCfg.from_dict(raw), pschema.ExperimentCfg.from_dict(raw)
    jv, pv = jschema.build_tower_config(jexp.arch).video, pschema.build_tower_config(
        pexp.arch).video
    for key in ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "num_frames",
                "remat", "remat_policy", "sequence_parallel", "fused_qkv"):
        assert getattr(pv, key) == getattr(jv, key), key
    assert pv.sequence_parallel and pv.embed_dim // pv.num_heads == dh
    assert pv.patches_per_frame + 1 == (197 if dh == 64 else 257)
    for key in ("fsdp", "model_parallel", "accum_steps", "zero1", "skip_nonfinite",
                "async_checkpoint", "precision"):
        assert getattr(pexp.trainer, key) == getattr(jexp.trainer, key), key
    assert pexp.trainer.fsdp and pexp.trainer.model_parallel == 4
    assert pexp.loss.chunked == jexp.loss.chunked is True
    assert [d.batch_size for d in pexp.data_loaders] == [d.batch_size for d in jexp.data_loaders]

    with pytest.raises(ValueError, match="model_parallel=4"):
        jmesh.make_mesh(n_devices=1, model_parallel=pexp.trainer.model_parallel)
    jmesh.set_current_mesh(None)
    with pytest.raises(NotImplementedError, match="several devices.*A8b"):
        pmesh.check_layout(pexp.trainer)

    raw["trainer"]["model_parallel"] = 1
    jt = jschema.ExperimentCfg.from_dict(raw).trainer
    mesh = jmesh.make_mesh(n_devices=1, model_parallel=jt.model_parallel)
    jmesh.set_current_mesh(None)
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    pmesh.check_layout(pschema.ExperimentCfg.from_dict(raw).trainer)


@pytest.mark.parametrize("frames", [2, 1])
def test_dh80_tower_with_sequence_parallel_matches_oatx(frames):
    """A Dh-80 tower (embed 160, 2 heads) over 257-key frame groups (img 32,
    patch 2) with `sequence_parallel: true`: the port's video tower against
    oatx's `apply` on a 1-device mesh (where `_sp_constrain` is a no-op)."""
    jcfg = jtowers.TowerConfig(
        video=jvst.SpaceTimeViTConfig(**TINY_VIDEO, sequence_parallel=True,
                                      split_cls_stream=False, cls_position="first"),
        text=jdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16)
    pcfg = ptowers.TowerConfig(video=pvst.SpaceTimeViTConfig(**TINY_VIDEO,
                                                             sequence_parallel=True),
                               text=pdb.DistilBertConfig(**TRAIN_TEXT), projection_dim=16)
    assert pcfg.video.head_dim == 80 and pcfg.video.patches_per_frame == 256
    params = oatx_params(jcfg)
    model = port_model(params, pcfg)
    x = np.random.default_rng(frames).standard_normal((2, frames, 32, 32, 3)).astype(
        np.float32)
    jmesh.make_mesh(n_devices=1)
    try:
        want = jvst.apply(params["video"], jcfg.video, jnp.asarray(x))
    finally:
        jmesh.set_current_mesh(None)
    with torch.no_grad():
        got = model.video_model(t(x))
    for key in ("cls", "patches"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)


def _eval_augment(monkeypatch):
    """Both Trainers build their own train step (accum_steps, skip_nonfinite)
    around `make_augmenter`; their augmentation generators differ, so both
    get the eval transform."""
    for mod in (jstep, pstep):
        orig = mod.make_augmenter
        monkeypatch.setattr(mod, "make_augmenter",
                            lambda *a, _o=orig, **kw: _o(train=False, tower_cfg=kw["tower_cfg"]))


def _record_terms(trainer, out):
    step = trainer.train_step

    def recorded(state, batch):
        state, metrics = step(state, batch)
        out.append({k: float(v) for k, v in metrics.items() if k.startswith("loss")})
        return state, metrics

    trainer.train_step = recorded


def _run_both(tmp_path, raw_j, raw_p, jds, pds, corpus, tag_lens=False):
    """Both Trainers from one .pth over their own loaders: (oatx terms, port
    terms, oatx history, port history)."""
    jexp, pexp = jschema.ExperimentCfg.from_dict(raw_j), pschema.ExperimentCfg.from_dict(raw_p)
    jcfg = jtrainer_mod.build_tower_config(jexp.arch)
    jconvert.export_torch_checkpoint(str(tmp_path / "init.pth"), oatx_params(jcfg),
                                     jcfg.video)

    def loaders(ds, tok, mod, lens):
        col = mod.Collator(tok, max_text_len=10, max_pad_text_len=24, tag_token_lens=lens)
        return ([mod.ShardedLoader(ds, 4, col, seed=0, num_workers=2)],
                [mod.ShardedLoader(ds, 8, col, shuffle=False, drop_last=False,
                                   num_workers=2)])

    mesh = jmesh.make_mesh(n_devices=1)
    try:
        jtok = JTok.build_from_corpus(corpus, vocab_size=100)
        lens = jfactory.tag_token_lens_for(jds.ds, jtok) if tag_lens else None
        tl, vl = loaders(jds, jtok, JL, lens)
        jtr = jtrainer_mod.Trainer(jexp, tl, vl, save_dir=tmp_path / "oatx", mesh=mesh)
        jterms = []
        _record_terms(jtr, jterms)
        jh = jtr.train()
    finally:
        jmesh.set_current_mesh(None)
    ptok = PTok.build_from_corpus(corpus, vocab_size=100)
    lens = pfactory.tag_token_lens_for(pds, ptok) if tag_lens else None
    tl, vl = loaders(pds, ptok, PL, lens)
    ptr = ptrainer_mod.Trainer(pexp, tl, vl, save_dir=tmp_path / "port", device="cpu")
    pterms = []
    _record_terms(ptr, pterms)
    ph = ptr.train()
    return jterms, pterms, jh, ph


def _tiny_args(raw, tmp_path):
    args = raw["arch"]["args"]
    args["video_params"].update(input_res=32, num_frames=2)
    args["text_params"].update(vocab_size=100, dim=32, hidden_dim=64, n_layers=2, n_heads=2)
    args["projection_dim"] = 16
    args["load_checkpoint"] = str(tmp_path / "init.pth")


def _close_terms(jterms, pterms, n):
    assert len(pterms) == len(jterms) == n
    for got, want in zip(pterms, jterms):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_pod_recipe_trainers_match_oatx(tmp_path, monkeypatch, keep_sigterm):
    """vit_huge_pod.json with `model_parallel` 1, its tower cut to the tiny
    Dh-80 geometry (arch_config huge_patch14_224 → embed 160, 2 blocks, 2
    heads, patch 2; 2 frames at 32²: 257 keys a frame group): fsdp,
    sequence_parallel, remat dots_all, accum_steps 2 (micro-batches of 2),
    the chunked NormSoftmax, skip_nonfinite, async checkpoints and the cosine
    schedule (warm-up cut to 1 step so the updates move the weights), both
    Trainers over 2 epochs of 2 steps at batch 4 with validation. The
    per-step losses and the validation losses agree within 1e-4."""
    monkeypatch.setitem(jschema.ARCH_TABLE, "huge_patch14_224", TINY_HUGE)
    monkeypatch.setitem(pschema.ARCH_TABLE, "huge_patch14_224", TINY_HUGE)
    _eval_augment(monkeypatch)
    raw = _load("vit_huge_pod")
    _tiny_args(raw, tmp_path)
    raw["data_loader"] = raw["data_loader"][1:]  # the 4-frame loader (2 frames here)
    raw["optimizer"]["args"]["warmup_steps"] = 1
    raw["trainer"].update(model_parallel=1, epochs=2, len_epoch=2, save_period=1,
                          verbosity=0, init_val=False, precision="f32", seed=0)
    pexp = pschema.ExperimentCfg.from_dict(raw)
    pv = pschema.build_tower_config(pexp.arch).video
    assert (pv.embed_dim // pv.num_heads, pv.patches_per_frame) == (80, 256)
    assert pv.sequence_parallel and pv.remat and pv.remat_policy == "dots_all"
    assert pexp.trainer.fsdp and pexp.trainer.accum_steps == 2 and pexp.loss.chunked
    ds = MemoryClips(n=16, frames=2, canon=32)
    jterms, pterms, jh, ph = _run_both(tmp_path, raw, raw, ds, ds, ds.captions)
    _close_terms(jterms, pterms, 4)
    assert sorted(ph) == sorted(jh) == [1, 2]
    for epoch in (1, 2):
        for k, v in jh[epoch].items():
            if k.startswith("loss_") or k.startswith("val_loss"):
                np.testing.assert_allclose(ph[epoch][k], v, rtol=1e-4, err_msg=k)


def _oatx_builder():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import build_region_memory
    finally:
        sys.path.pop(0)
    return build_region_memory


def test_region_mem_from_a_built_bank_matches_oatx(tmp_path, monkeypatch, keep_sigterm):
    """region_mem from a bank of rms ≈ 1: both builders encode 48 class
    names with the same random CLIP text weights (width 64, 2 layers, a
    512-d projection) and agree within 1e-4; region_mem.json's loss (region
    BCE at 0.1) at the tiny geometry trains in both packages from their own
    bank, and every per-step loss term, loss_region included, agrees within
    1e-4."""
    from oatx_torch.cli import build_region_memory as pbrm

    monkeypatch.delenv("OATX_CLIP_BPE", raising=False)
    names = [f"thing{i}" for i in range(48)]
    vocab = tmp_path / "objects_vocab.txt"
    vocab.write_text("\n".join(names) + "\n")  # __background__ is implied
    cfg = jclip.ClipTextConfig(vocab_size=600, width=64, heads=1, layers=2, embed_dim=512)
    sd = jconvert.clip_text_to_torch(jclip.init(jax.random.PRNGKey(3), cfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(tmp_path / "clip.pth"))
    tok = pctok.ClipTokenizer.for_tests([pbrm.PROMPT.format(n) for n in names], 64)
    bpe = pctok.ClipBatchTokenizer(tok).save_vocab(str(tmp_path / "x"))
    port_bank = str(tmp_path / "port_bank.npy")
    assert pbrm.main(["--vocab", str(vocab), "--out", port_bank, "--dim", "512",
                      "--device", "cpu", "--clip-ckpt", str(tmp_path / "clip.pth"),
                      "--bpe", bpe]) == 0
    want, _ = _oatx_builder().encode_with_oatx_clip(names, 512, str(tmp_path / "clip.pth"),
                                                    bpe)
    oatx_bank = str(tmp_path / "oatx_bank.npy")
    np.save(oatx_bank, want)
    got = np.load(port_bank)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rms = float(np.sqrt(np.mean(got.astype(np.float64) ** 2)))
    assert 0.5 < rms < 2, rms  # the seeded bank's is 0.02
    assert np.unique(got.round(4), axis=0).shape[0] == len(names)

    _eval_augment(monkeypatch)
    monkeypatch.setattr(jtrainer_mod, "build_tower_config", _tap_at_1(
        jtrainer_mod.build_tower_config))
    monkeypatch.setattr(ptrainer_mod, "build_tower_config", _tap_at_1(
        ptrainer_mod.build_tower_config))
    with open(os.path.join(REPO, "configs", "pt", "webvid", "region_mem.json")) as f:
        raw = json.load(f)
    args = raw["arch"]["args"]
    args["video_params"].update(arch_config="base_patch16_224", input_res=32, num_frames=2,
                                embed_dim=32, depth=2, num_heads=2, time_init="random")
    args["text_params"].update(vocab_size=100, dim=32, hidden_dim=64, n_layers=2, n_heads=2)
    args["projection_dim"] = 16
    args["load_checkpoint"] = str(tmp_path / "init.pth")
    dl = raw["data_loader"][0] if isinstance(raw["data_loader"], list) else raw["data_loader"]
    dl["args"].update(batch_size=4)
    dl["args"]["video_params"].update(input_res=32, num_frames=2)
    raw["data_loader"] = [dl]
    raw["trainer"].update(epochs=2, len_epoch=2, save_period=1, verbosity=0,
                          init_val=False, precision="f32", seed=0)
    raws = {}
    for pkg, path in (("oatx", oatx_bank), ("port", port_bank)):
        r = json.loads(json.dumps(raw))
        r["data_loader"][0]["args"].setdefault("object_params", {})
        r["data_loader"][0]["args"]["object_params"]["region_memory_path"] = path
        raws[pkg] = r
    pexp = pschema.ExperimentCfg.from_dict(raws["port"])
    jexp = jschema.ExperimentCfg.from_dict(raws["oatx"])
    assert pexp.arch.variant == "region_mem" and pexp.loss.region_bce_weight > 0
    pbank, jbank = pfactory.load_region_bank(pexp), jfactory.load_region_bank(jexp)
    np.testing.assert_array_equal(pbank.embeddings, got)
    popts = pfactory.object_options_for_variant("region_mem", pexp.data_loaders[0], pbank)
    jopts = jfactory.object_options_for_variant("region_mem", jexp.data_loaders[0], jbank)
    pds = MemoryClips(n=16, frames=2, canon=32, object_dir=str(tmp_path / "objects"),
                      object_options=popts)
    patch_oatx_decode(monkeypatch, pds)
    jds = OatxMemoryClips(pds, jopts)
    jterms, pterms, _, _ = _run_both(tmp_path, raws["oatx"], raws["port"], jds, pds,
                                     pds.captions + [f"obj{i}" for i in range(1600)],
                                     tag_lens=True)
    _close_terms(jterms, pterms, 4)
    assert all("loss_region" in m and np.isfinite(m["loss_region"]) for m in pterms)


def _tap_at_1(build):
    """build_tower_config with region_mem's tap after block 1 (2 blocks here)."""
    import dataclasses

    def wrapped(arch, **kw):
        cfg = build(arch, **kw)
        if cfg.variant != "region_mem":
            return cfg
        return dataclasses.replace(cfg, video=dataclasses.replace(cfg.video,
                                                                  region_tap_layer=1))
    return wrapped


class _CountBackward(torch.autograd.Function):
    counts = None

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _CountBackward.counts["space_attention_bwd"] += 1
        return g


def test_pod_launch_counts_chip_smoke_derives(tmp_path, monkeypatch, keep_sigterm):
    """chip_smoke.want_launches with accum_steps, against the calls of
    kernels 1 and 2 (and of kernel 2's backward) that the port's Trainer
    makes on the CPU on the tiny pod recipe: 2 steps of 2 micro-batches
    under remat dots_all (each block's forward again before its backward),
    init_val and one validation over 16 clips at batch 4 (eval forwards
    without remat)."""
    sys.path.insert(0, REPO)
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
    monkeypatch.setitem(pschema.ARCH_TABLE, "huge_patch14_224", TINY_HUGE)
    raw = _load("vit_huge_pod")
    _tiny_args(raw, tmp_path)
    raw["arch"]["args"]["load_checkpoint"] = ""
    raw["trainer"].update(model_parallel=1, epochs=1, len_epoch=2, verbosity=0,
                          precision="f32")
    ds = MemoryClips(n=16, frames=2, canon=32)
    tok = PTok.build_from_corpus(ds.captions, vocab_size=100)
    col = PL.Collator(tok, max_text_len=10)
    tr = ptrainer_mod.Trainer(
        pschema.ExperimentCfg.from_dict(raw), [PL.ShardedLoader(ds, 4, col, seed=0)],
        [PL.ShardedLoader(ds, 4, col, shuffle=False, drop_last=False)], device="cpu")
    tr.train()
    assert counts == cs.want_launches(2, 2, True, forwards=cs.eval_forwards(2, 16, 4),
                                      accum_steps=2)
    assert cs.want_launches(2, 1, True, accum_steps=2)["space_attention_bwd"] == 4
