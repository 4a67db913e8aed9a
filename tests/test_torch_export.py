"""The port's serving artifact (oatx_torch.serve.export, cli.export_serving,
cli.serve --artifact) and its index tool (cli.build_index) against oatx on
the CPU.

The same numpy-seeded oatx params are exported by both packages, at full
precision and int8 (oatx through jax.export, the port through
torch.export with its kernels as custom ops). The port's artifact serves
batches 1, 3 and 5 from one program exported at batch 2 (torch.export
specialises a size-1 dimension): within the towers' f32 atol 1e-4 of
oatx's ExportedEmbedder and within 1e-6 of the port's in-process
EmbedService on the same weights (the same operations, other matmul
batch shapes). `cli.build_index` is held against tools/build_index.py on
the same clips and weights: the same ids and embeddings within 1e-4.
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oatx.cli import serve as jserve
from oatx.config.schema import ExperimentCfg as JExp
from oatx.config.schema import build_tower_config as jbuild
from oatx.models import convert as jconvert
from oatx.parallel import mesh as jmesh
from oatx.serve import export as jex
from oatx_torch.cli import serve as pserve
from oatx_torch.serve import embed_service as pes
from oatx_torch.serve import export as pex
from torch_port_helpers import oatx_params, patch_port_decode, port_model

torch.set_num_threads(1)
ATOL = 1e-4
SELF_ATOL = 1e-6
FRAMES, CANON, SEQ = 2, 40, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["full", "int8"]


TINY_CONFIG = {
    "name": "tiny-export",
    "tokenizer": {"vocab_size": 100},
    "arch": {"type": "FrozenInTime", "variant": "baseline", "args": {
        "video_params": {"model": "SpaceTimeTransformer", "arch_config": "base_patch16_224",
                         "num_frames": FRAMES, "input_res": 32, "embed_dim": 64, "depth": 1,
                         "num_heads": 4, "time_init": "zeros", "pretrained": False},
        "object_params": {"model": ""},
        "text_params": {"model": "distilbert-base-uncased", "pretrained": False,
                        "vocab_size": 100, "dim": 64, "hidden_dim": 128, "n_layers": 1,
                        "n_heads": 4},
        "projection": "minimal", "projection_dim": 32, "load_checkpoint": ""}},
    "trainer": {"precision": "f32"},
}


def _tool(name):
    """tools/<name>.py's module (oatx's side of a port CLI)."""
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(tools)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both packages' artifacts of one config, full and int8, written by
    their CLIs (tools/export_serving.py, oatx_torch.cli.export_serving) from
    the same reference .pth of numpy-seeded oatx params.
    → {mode: (port artifact dir, oatx ExportedEmbedder, port EmbedService on
    the same weights, {pkg: the CLI's JSON line})}, and the config path."""
    from oatx_torch.cli import export_serving as pexport
    from oatx_torch.config.schema import ExperimentCfg as PExp
    from oatx_torch.config.schema import build_tower_config as pbuild

    root = tmp_path_factory.mktemp("artifacts")
    raw = json.loads(json.dumps(TINY_CONFIG))
    raw["arch"]["args"]["load_checkpoint"] = str(root / "init.pth")
    cfg = root / "c.json"
    cfg.write_text(json.dumps(raw))
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog"]) + "\n")
    jcfg = jbuild(JExp.from_dict(raw).arch)
    pcfg = pbuild(PExp.from_dict(raw).arch)
    params = oatx_params(jcfg, seed=3)
    jconvert.export_torch_checkpoint(str(root / "init.pth"), params, jcfg.video)
    out = {}
    capture = io.StringIO()
    for mode in MODES:
        lines = {}
        for pkg, main, extra in (("oatx", _tool("export_serving").main, []),
                                 ("port", pexport.main, ["--device", "cpu"])):
            argv = ["-c", str(cfg), "--out", str(root / f"{pkg}_{mode}"),
                    "--canon", str(CANON), "--seq-len", str(SEQ)] + extra
            with contextlib.redirect_stdout(capture):
                assert main(argv + (["--quantize", "int8"] if mode == "int8" else [])) == 0
            lines[pkg] = json.loads(capture.getvalue().strip().splitlines()[-1])
        svc = pes.EmbedService(port_model(params, pcfg), pcfg, buckets=(1, 4), seq_len=SEQ,
                               quantize=None if mode == "full" else "int8", device="cpu")
        out[mode] = (root / f"port_{mode}", jex.ExportedEmbedder(root / f"oatx_{mode}"),
                     svc, lines)
    return out, str(cfg)


def _clips(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, FRAMES, CANON, CANON, 3), dtype=np.uint8)


@pytest.mark.parametrize("mode", MODES)
def test_artifact_matches_oatx_and_the_service(artifacts, mode):
    pdir, jemb, svc, _ = artifacts[0][mode]
    emb = pex.ExportedEmbedder(pdir, device="cpu")
    for n in (1, 3, 5):  # 1: below the example batch; 3 and 5: no bucket
        clips = _clips(n, seed=n)
        got = emb.embed_video(clips)
        assert got.shape == (n, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, jemb.embed_video(clips), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, svc.embed_video(clips), atol=SELF_ATOL, rtol=0)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 100, (3, SEQ)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 4:] = 0
    got = emb.embed_text(ids, mask)
    np.testing.assert_allclose(got, jemb.embed_text(ids, mask), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, svc.embed_text(ids, mask), atol=SELF_ATOL, rtol=0)
    s = emb.latency_summary()
    assert s["video"]["count"] == 3 and s["text"]["count"] == 1
    assert emb.buckets == () and emb.seq_len == SEQ


def test_artifact_text_pad_and_trim(artifacts):
    pdir, jemb, _, _ = artifacts[0]["full"]
    emb = pex.ExportedEmbedder(pdir, device="cpu")
    rng = np.random.default_rng(12)
    for length in (5, SEQ + 3):
        ids = rng.integers(1, 100, (2, length)).astype(np.int32)
        mask = np.ones_like(ids)
        np.testing.assert_allclose(emb.embed_text(ids, mask), jemb.embed_text(ids, mask),
                                   atol=ATOL, rtol=0)
        padded = pex._pad_or_trim(ids, SEQ)
        np.testing.assert_array_equal(padded, jex._pad_or_trim(ids, SEQ))
        np.testing.assert_array_equal(emb.embed_text(ids, mask),
                                      emb.embed_text(padded, pex._pad_or_trim(mask, SEQ)))


def test_artifact_shape_and_device_checks(artifacts, monkeypatch, tmp_path):
    pdir = artifacts[0]["full"][0]
    emb = pex.ExportedEmbedder(pdir)  # the device type it was exported for
    assert emb.device.type == "cpu"
    with pytest.raises(ValueError, match="exported"):
        emb.embed_video(np.zeros((1, FRAMES, CANON + 8, CANON, 3), np.uint8))
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not meta"):
        pex.ExportedEmbedder(pdir, device="meta")
    meta = json.loads((pdir / "meta.json").read_text())
    assert meta["platforms"] == ["cpu"]
    assert {k: meta[k] for k in ("frames", "canon", "seq_len", "embed_dim")} == \
        {"frames": FRAMES, "canon": CANON, "seq_len": SEQ, "embed_dim": 32}
    # a card's artifact on a machine without one raises, as oatx refuses a
    # platform it was not lowered for
    (tmp_path / "meta.json").write_text(json.dumps({**meta, "platforms": ["cuda"]}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pex.ExportedEmbedder(tmp_path)
    with pytest.raises(ValueError, match="not cpu"):
        pex.ExportedEmbedder(tmp_path, device="cpu")


def test_quantized_artifact_holds_int8_and_is_smaller(artifacts):
    sizes = {}
    for mode in MODES:
        pdir = artifacts[0][mode][0]
        sizes[mode] = sum(p.stat().st_size for p in pdir.iterdir())
        state = {n: torch.export.load(str(pdir / f"{n}.pt2")).state_dict
                 for n in ("video", "text")}
        q8 = [k for s in state.values() for k, v in s.items() if v.dtype == torch.int8]
        meta = json.loads((pdir / "meta.json").read_text())
        assert meta["quantize"] == artifacts[0][mode][1].meta["quantize"]  # oatx's report
        if mode == "full":
            assert not q8 and meta["quantize"] is None
            continue
        assert q8 and all(k.endswith(".weight_q8") for k in q8)
        assert "video_model.blocks.0.mlp.fc1.weight_q8" in state["video"]
        assert "video_model.blocks.0.mlp.fc1.weight" not in state["video"]
        # each program holds its own tower's weights alone
        assert not any(k.startswith("text_model.") for k in state["video"])
        assert not any(k.startswith("video_model.") for k in state["text"])
        assert len(q8) == sum(1 for s in state.values() for k in s if k.endswith("_q8_scale"))
    assert sizes["int8"] < sizes["full"]


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_programs_call_the_kernels_ops(fused_qkv):
    """The video program holds each kernel as its op, once a block (kernel
    3 twice a block, for the time and space qkv, under fused_qkv), and on
    the CPU runs their plain versions: the in-process tower's embedding."""
    from oatx_torch.models.distilbert import DistilBertConfig
    from oatx_torch.models.towers import DualTower, TowerConfig
    from oatx_torch.models.vit_spacetime import SpaceTimeViTConfig

    cfg = TowerConfig(video=SpaceTimeViTConfig(img_size=32, embed_dim=32, depth=2, num_heads=2,
                                               num_frames=FRAMES, time_init="random",
                                               fused_qkv=fused_qkv),
                      text=DistilBertConfig(vocab_size=100, dim=32, hidden_dim=64, n_layers=1,
                                            n_heads=2), projection_dim=16)
    model = DualTower(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    video = pex.export_embed_fns(model, cfg, frames=FRAMES, canon=CANON, seq_len=SEQ)["video"]
    code = video.graph_module.code
    assert code.count("torch.ops.oatx_torch.ln_mlp.default") == 2
    assert code.count("torch.ops.oatx_torch.space_attention.default") == 2
    assert code.count("torch.ops.oatx_torch.ln_linear.default") == (4 if fused_qkv else 0)
    clips = _clips(3, seed=31)
    svc = pes.EmbedService(model, cfg, buckets=(4,), seq_len=SEQ, device="cpu")
    with torch.no_grad():
        got = video.module()(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, svc.embed_video(clips), atol=SELF_ATOL, rtol=0)


def test_artifact_loads_without_jax_or_the_models(artifacts):
    """A fresh interpreter (isolated: no site hooks) loads and runs an
    artifact without importing jax, oatx or the port's model code."""
    pdir = artifacts[0]["int8"][0]
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import numpy as np; "
            "from oatx_torch.serve.export import ExportedEmbedder; "
            "e = ExportedEmbedder(sys.argv[2]); "
            f"v = e.embed_video(np.zeros((3, {FRAMES}, {CANON}, {CANON}, 3), np.uint8)); "
            "t = e.embed_text(np.ones((2, 4), np.int32), np.ones((2, 4), np.int32)); "
            "assert v.shape == (3, 32) and t.shape == (2, 32) and np.isfinite(v).all(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'oatx') or m.startswith(('oatx_torch.models', "
            "'oatx_torch.config', 'oatx_torch.train'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-I", "-c", code, REPO, str(pdir)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_export_serving_cli_line_matches_oatx(artifacts):
    """cli.export_serving prints tools/export_serving.py's JSON line; the
    int8 report depends on shapes alone and equals oatx's."""
    arts, _ = artifacts
    for mode in MODES:
        lines = arts[mode][3]
        assert sorted(lines["port"]) == sorted(lines["oatx"]) == \
            ["artifact", "bytes", "platforms", "quantize"]
        assert lines["port"]["quantize"] == lines["oatx"]["quantize"]
        assert (lines["port"]["quantize"] is None) == (mode == "full")
        assert lines["port"]["platforms"] == ["cpu"]
        assert lines["port"]["bytes"] == sum(
            p.stat().st_size for p in arts[mode][0].iterdir())


def test_cli_serves_the_artifact(artifacts):
    """cli.serve --artifact serves the directory, with oatx's startup banner
    for both backends (an artifact has no buckets)."""
    arts, cfg = artifacts
    pdir = arts["int8"][0]
    svc, tok, index, our = pserve.build_service(
        ["-c", cfg, "--artifact", str(pdir), "--device", "cpu", "--port", "0"])
    assert isinstance(svc, pex.ExportedEmbedder) and index is None
    banner = pserve.startup_banner(svc, index, our)
    assert banner == jserve.startup_banner(svc, index, our)
    assert json.loads(banner)["buckets"] == []
    in_process = arts["int8"][2]
    assert pserve.startup_banner(in_process, index, our) == \
        jserve.startup_banner(in_process, index, our)
    clips = _clips(3, seed=21)
    np.testing.assert_allclose(svc.embed_video(clips), in_process.embed_video(clips),
                               atol=SELF_ATOL, rtol=0)
    ids = tok(["a dog"], max_length=SEQ)
    np.testing.assert_allclose(svc.embed_text(ids["input_ids"], ids["attention_mask"]),
                               in_process.embed_text(ids["input_ids"], ids["attention_mask"]),
                               atol=SELF_ATOL, rtol=0)


def _index_config(root, init_pth):
    with open(os.path.join(REPO, "configs", "smoke", "synthetic.json")) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(data_dir=str(root / "videos"), object_dir="", num_workers=2, split="test")
    dl["video_params"].update(num_videos=6, fixture_seeded=True)
    raw["arch"]["args"]["load_checkpoint"] = init_pth
    raw["arch"]["args"]["video_params"].update(embed_dim=32, depth=1, num_heads=2)
    raw["arch"]["args"]["text_params"].update(dim=32, hidden_dim=64, n_layers=1, n_heads=2)
    raw["trainer"].update(save_dir=str(root / "exps"), verbosity=0)
    path = root / "index.json"
    path.write_text(json.dumps(raw))
    return raw, str(path)


def test_build_index_matches_oatx_tool(tmp_path, monkeypatch, capsys):
    from oatx_torch.cli import build_index as pbuild
    from oatx_torch.serve.retrieval_index import RetrievalIndex

    jbuild_index = _tool("build_index")

    raw, cfg = _index_config(tmp_path, str(tmp_path / "init.pth"))
    jcfg = jbuild(JExp.from_dict(raw).arch)
    jconvert.export_torch_checkpoint(str(tmp_path / "init.pth"), oatx_params(jcfg, seed=5),
                                     jcfg.video)
    make_mesh = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: make_mesh(*a, **{**k,
                                                                        "n_devices": 1}))
    patch_port_decode(monkeypatch)  # the port reads oatx's decoded frames
    lines = {}
    try:
        for pkg, main, extra in (("oatx", jbuild_index.main, []),
                                 ("port", pbuild.main, ["--device", "cpu"])):
            out = str(tmp_path / f"{pkg}.npz")
            assert main(["-c", cfg, "--index-out", out, "--sliding_window_stride", "2"]
                        + extra) == 0
            lines[pkg] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        jmesh.set_current_mesh(None)
    j = RetrievalIndex.load(str(tmp_path / "oatx.npz"), device="cpu")
    p = RetrievalIndex.load(str(tmp_path / "port.npz"), device="cpu")
    assert p.ids == j.ids and len(p) == 6 and p.ids[0].endswith("clip0000.avi")
    np.testing.assert_allclose(p._emb, j._emb, atol=ATOL, rtol=0)
    for key in ("videos", "dim", "dataset", "split"):
        assert lines["port"][key] == lines["oatx"][key], key
    assert sorted(lines["port"]) == sorted(lines["oatx"])
