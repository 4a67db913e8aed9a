"""The port's train / test CLIs and retrieval eval (oatx_torch.cli.train,
cli.test, eval.retrieval_eval) against oatx's, on the CPU in f32.

Both `cli.train.main`s run configs/smoke/synthetic.json (tiny towers, f32,
batch 4, 2 epochs of 4 steps, init_val, a checkpoint per epoch) over the same
seeded SyntheticVideoText clips (oatx's writer; the port's reader patched to
serve oatx's decoded frames), from the same initial weights (a reference
.pth oatx exports, named by arch.load_checkpoint), oatx on a 1-device mesh;
the two packages draw augmentations from different generators, so both
train through the eval transform (make_augmenter patched to train=False).
Held: per-step losses within 1e-4 of their scale (the f32 steps of
test_torch_trainer.py), the same vocab.txt, the same files written. Then
both `cli.test.main`s evaluate their epoch-2 checkpoints with sliding
windows: embeddings within 1e-4 of their scale, metrics equal (the corpus
is separable). `ensemble_windows`, `evaluate_multiple_choice` and
`evaluate_streams` are held the same way on the tiny towers, and one run of
the port's own decoder and writer shows cli.train's loss finite and falling.
The entry points raise without a card unless --device cpu is given.
"""

import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from oatx.config.schema import DataLoaderCfg as JCfg
from oatx.config.schema import ExperimentCfg as JExp
from oatx.config.schema import build_tower_config as jbuild
from oatx.data import factory as jfactory
from oatx.data import loader as JL
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx.eval import retrieval_eval as jeval
from oatx.models import convert as jconvert
from oatx.parallel import mesh as jmesh
from oatx.train import step as jstep
from oatx_torch.config.schema import DataLoaderCfg as PCfg
from oatx_torch.data import factory as pfactory
from oatx_torch.data import loader as PL
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from oatx_torch.eval import retrieval_eval as peval
from oatx_torch.train import step as pstep
from torch_port_helpers import oatx_params, patch_port_decode, port_model, train_cfgs

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(HERE, "..", "configs", "smoke", "synthetic.json")


def _close(got, want, scale=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max() + 1e-12)


def smoke_raw(root, init_pth=""):
    with open(SMOKE) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(data_dir=str(root / "videos"), object_dir="", num_workers=2)
    dl["video_params"]["fixture_seeded"] = True
    raw["arch"]["args"]["load_checkpoint"] = init_pth
    raw["trainer"].update(save_dir=str(root / "exps"), verbosity=0)
    return raw


def _write(path, raw):
    path.write_text(json.dumps(raw))
    return str(path)


def _recording(cls, losses):
    """cls.__init__ wrapped: each Trainer's train_step appends its losses."""
    init = cls.__init__

    def rec_init(self, *a, **k):
        init(self, *a, **k)
        step = self.train_step

        def recorded(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m

        self.train_step = recorded

    return rec_init


def _eval_only(module, monkeypatch):
    make = module.make_augmenter
    monkeypatch.setattr(module, "make_augmenter",
                        lambda *a, **k: make(*a, **{**k, "train": False}))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both CLIs trained on the smoke config; → (root, {pkg: (save_dir, losses)})."""
    from oatx.cli import train as jtrain
    from oatx.train.trainer import Trainer as JTrainer
    from oatx_torch.cli import train as ptrain
    from oatx_torch.train.trainer import Trainer as PTrainer

    root = tmp_path_factory.mktemp("cli")
    raw = smoke_raw(root, str(root / "init.pth"))
    jcfg = jbuild(JExp.from_dict(raw).arch)
    jconvert.export_torch_checkpoint(str(root / "init.pth"), oatx_params(jcfg), jcfg.video)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        make_mesh = jmesh.make_mesh
        mp.setattr(jmesh, "make_mesh", lambda *a, **k: make_mesh(*a, **{**k, "n_devices": 1}))
        _eval_only(jstep, mp)
        _eval_only(pstep, mp)
        patch_port_decode(mp)
        for pkg, main, cls in (("oatx", jtrain.main, JTrainer), ("port", ptrain.main, PTrainer)):
            r = json.loads(json.dumps(raw))
            r["trainer"]["save_dir"] = str(root / pkg)
            cfg = _write(root / f"{pkg}.json", r)
            losses = []
            mp.setattr(cls, "__init__", _recording(cls, losses))
            argv = ["-c", cfg, "--no_timestamp"] + (["--device", "cpu"] if pkg == "port" else [])
            assert main(argv) == 0
            out[pkg] = (root / pkg / "models" / raw["name"], losses)
    finally:
        mp.undo()
        jmesh.set_current_mesh(None)
    return root, raw, out


def test_cli_train_matches_oatx(trained):
    _, _, out = trained
    (jdir, jl), (pdir, pl) = out["oatx"], out["port"]
    assert len(pl) == len(jl) == 8
    _close(pl, jl)
    assert (pdir / "vocab.txt").read_text() == (jdir / "vocab.txt").read_text()
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    assert {"checkpoint-epoch1", "checkpoint-epoch2", "model_best", "config.json",
            "vocab.txt"} <= set(names)
    for name in names:
        if name.endswith(".meta.json"):
            got, want = (json.loads((d / name).read_text()) for d in (pdir, jdir))
            assert sorted(got) == sorted(want)
            assert got["epoch"] == want["epoch"] and got["step"] == want["step"]


def test_cli_test_matches_oatx(trained, monkeypatch):
    from oatx.cli import test as jtest
    from oatx_torch.cli import test as ptest

    root, raw, out = trained
    r = json.loads(json.dumps(raw))
    r["data_loader"][0]["args"]["split"] = "test"
    cfg = _write(root / "test.json", r)
    seen = {}

    def keep(pkg, fn):
        def wrapped(*a, **k):
            seen[pkg] = res = fn(*a, **k)
            return res
        return wrapped

    make_mesh = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: make_mesh(*a, **{**k,
                                                                        "n_devices": 1}))
    monkeypatch.setattr(jtest, "evaluate", keep("oatx", jtest.evaluate))
    monkeypatch.setattr(peval, "evaluate", keep("port", peval.evaluate))
    patch_port_decode(monkeypatch)
    try:
        for pkg, main in (("oatx", jtest.main), ("port", ptest.main)):
            argv = ["-c", cfg, "-r", str(out[pkg][0] / "checkpoint-epoch2"),
                    "--sliding_window_stride", "2"] + (["--device", "cpu"] if pkg == "port"
                                                       else [])
            assert main(argv) == 0
    finally:
        jmesh.set_current_mesh(None)
    j, p = seen["oatx"], seen["port"]
    assert p.video_embeds.shape == j.video_embeds.shape == (16, 64)
    _close(p.text_embeds, j.text_embeds)
    _close(p.video_embeds, j.video_embeds)
    _close(p.sims, j.sims)
    assert p.metrics == j.metrics
    assert [m["window_group"] for m in p.meta] == [m["window_group"] for m in j.meta]


def test_ensemble_windows_matches_oatx():
    rng = np.random.default_rng(0)
    t = rng.standard_normal((9, 5)).astype(np.float32)
    v = rng.standard_normal((9, 5)).astype(np.float32)
    groups = np.array([3, 3, 0, 0, 0, 7, 3, 7, 1])
    for a, b in zip(peval.ensemble_windows(t, v, groups), jeval.ensemble_windows(t, v, groups)):
        np.testing.assert_array_equal(a, b)


def _lsmdc(root):
    sdir = root / "structured-symlinks"
    sdir.mkdir(parents=True)
    stems = [f"1001_Movie_{i:05d}" for i in range(4)]
    (sdir / "test_list.txt").write_text("\n".join(stems) + "\n")
    with open(sdir / "raw-captions.pkl", "wb") as f:
        pickle.dump({s: [["a", "clip", "of", f"thing{i}"]] for i, s in enumerate(stems)}, f)
    (sdir / "multiple_choice_test.tsv").write_text(
        f"{stems[0]}\t2\tsome thing0\tother thing\ta clip of thing0\n")
    from oatx.data import video_reader as jvr

    for i, s in enumerate(stems):
        jvr.write_test_video(str(root / f"{s}.avi"), 96, 64, 8, 8, seed=i + 1)
    return stems


def _tiny(variant="baseline"):
    """The tiny train geometry; 64 text positions for global_local's caption
    + tags (the collator pads them to 60)."""
    jcfg, pcfg = train_cfgs()
    jcfg, pcfg = (dataclasses.replace(c, variant=variant, text=dataclasses.replace(
        c.text, max_position_embeddings=64)) for c in (jcfg, pcfg))
    params = oatx_params(jcfg)
    return jcfg, pcfg, params, port_model(params, pcfg)


def _loaders(dl_kw, variant, tok_corpus):
    out = []
    for fac, cfg, tok, mod in ((jfactory, JCfg, JTok, JL), (pfactory, PCfg, PTok, PL)):
        ds = fac.build_dataset(cfg(**dl_kw), variant, "test")
        t = tok.build_from_corpus(tok_corpus, vocab_size=100)
        lens = fac.tag_token_lens_for(ds, t) if variant == "global_local" else None
        out.append((mod.ShardedLoader(ds, 4, mod.Collator(t, tag_token_lens=lens),
                                      shuffle=False, drop_last=False, num_workers=2), t))
    return out


def test_evaluate_multiple_choice_matches_oatx(tmp_path, monkeypatch):
    patch_port_decode(monkeypatch)
    stems = _lsmdc(tmp_path)
    jcfg, pcfg, params, model = _tiny()
    dl = dict(dataset_name="LSMDC_choice", data_dir=str(tmp_path), split="test",
              video_params={"num_frames": 2, "loading": "strict"})
    (jl, jt), (pl, pt) = _loaders(dl, "baseline",
                                  [f"a clip of thing{i}" for i in range(4)] + ["other some"])
    want = jeval.evaluate_multiple_choice(params, jcfg, jl, jt)
    got = peval.evaluate_multiple_choice(model, pcfg, pl, pt, device="cpu")
    assert got == want and got["n"] == len(stems)


def test_evaluate_streams_matches_oatx(tmp_path, monkeypatch):
    patch_port_decode(monkeypatch)
    jcfg, pcfg, params, model = _tiny("global_local")
    dl = dict(dataset_name="SyntheticVideoText", data_dir=str(tmp_path / "v"),
              object_dir=str(tmp_path / "o"), split="test",
              video_params={"num_frames": 2, "num_videos": 8, "fixture_seeded": True,
                            "input_res": 32, "loading": "strict"})
    jfactory.build_dataset(JCfg(**dl), "global_local", "test")  # oatx's clips first
    (jl, _), (pl, _) = _loaders(dl, "global_local", ["a dog runs in scene"])
    want = jeval.evaluate_streams(jax.tree_util.tree_map(jax.numpy.asarray, params), jcfg, jl,
                                  ["t2v_metrics", "v2t_metrics"])
    got = peval.evaluate_streams(model, pcfg, pl, ["t2v_metrics", "v2t_metrics"],
                                 device="cpu")
    assert sorted(got) == sorted(want) == ["lt2ov", "lt2sv", "st2ov", "st2sv"]
    assert got == want


def test_port_decoder_trains_through_cli(tmp_path):
    """Unpatched: the port's writer makes the clips, its decoder reads them,
    and cli.train's loss (augmentation on) is finite and falls."""
    from oatx_torch.cli import train as ptrain
    from oatx_torch.train.trainer import Trainer as PTrainer

    raw = smoke_raw(tmp_path)
    raw["trainer"].update(epochs=3, init_val=False)
    losses = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(PTrainer, "__init__", _recording(PTrainer, losses))
        assert ptrain.main(["-c", _write(tmp_path / "c.json", raw), "--no_timestamp",
                            "--device", "cpu"]) == 0
    finally:
        mp.undo()
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert sorted(os.listdir(tmp_path / "videos"))[0].endswith(".avi")


@pytest.mark.parametrize("cli", ["train", "test", "serve"])
def test_entry_points_refuse_the_cpu_unless_asked(tmp_path, cli, monkeypatch):
    """Without a card (hidden here if there is one) and without --device
    cpu, each entry point raises before it writes anything."""
    import importlib

    monkeypatch.delenv("OATX_MULTIHOST", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"oatx_torch.cli.{cli}")
    cfg = _write(tmp_path / "c.json", smoke_raw(tmp_path))
    main = mod.build_service if cli == "serve" else mod.main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-c", cfg])
    assert not (tmp_path / "exps").exists()


def test_cli_train_refuses_multihost(tmp_path, monkeypatch):
    """OATX_MULTIHOST=1 at a world of one (oatx's three variables, a file://
    rendezvous, gloo for --device cpu): cli.train joins the group, trains
    exactly as without it (the checkpoint bitwise, the step is the
    one-process step) and tears the group down. Two ranks:
    tests/test_torch_dp_trainer.py."""
    import torch.distributed as dist

    from oatx_torch.cli import train as ptrain

    raw = smoke_raw(tmp_path)
    raw["trainer"].update(epochs=1, init_val=False)
    snaps = {}
    for mode in ("multihost", "plain"):
        r = json.loads(json.dumps(raw))
        r["trainer"]["save_dir"] = str(tmp_path / mode)
        if mode == "multihost":
            monkeypatch.setenv("OATX_MULTIHOST", "1")
            monkeypatch.setenv("OATX_COORDINATOR", (tmp_path / "store").as_uri())
            monkeypatch.setenv("OATX_NUM_PROCESSES", "1")
            monkeypatch.setenv("OATX_PROCESS_ID", "0")
        else:
            monkeypatch.delenv("OATX_MULTIHOST")
        assert ptrain.main(["-c", _write(tmp_path / f"{mode}.json", r), "--no_timestamp",
                            "--device", "cpu"]) == 0
        assert not dist.is_initialized()
        run = tmp_path / mode / "models" / raw["name"]
        assert (run / "vocab.txt").exists() and (run / "config.json").exists()
        snaps[mode] = torch.load(run / "checkpoint-epoch1" / "state.pt", weights_only=True)
    def same(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    assert same(snaps["multihost"], snaps["plain"])
    assert snaps["plain"]["step"] == 4


@pytest.mark.parametrize("what", ["region_mem", "RetrievalVis"])
def test_cli_test_refuses_unported_exports(tmp_path, what):
    """oatx's cli.test writes region_mem's region maps and the RetrievalVis
    gallery; the port has neither yet and raises before it builds a model."""
    from oatx_torch.cli import test as ptest

    raw = smoke_raw(tmp_path)
    if what == "region_mem":
        raw["arch"]["variant"] = "region_mem"
    else:
        raw["visualizer"] = {"type": "RetrievalVis"}
    with pytest.raises(NotImplementedError, match="A14"):
        ptest.main(["-c", _write(tmp_path / "c.json", raw), "--device", "cpu"])
    assert not (tmp_path / "exps").exists()
