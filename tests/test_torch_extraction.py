"""The port's offline object extraction (oatx_torch.ops.roi_align,
oatx_torch.data.extraction, oatx_torch.cli.extract) against oatx's, on the
CPU, with inputs made from numpy seeds.

Tolerances: roi_align's forward and its gradient with respect to the
features within 1e-6 of the reference's scale (max |·|), f32; the resize,
the stub detector, the TorchScript adapter and every `.npz` the stub
pipeline writes (x, bbox, info) exactly equal to oatx's, the stats equal
apart from `seconds` and `frames_per_sec`; RoiBackboneExtractor's features
within 1e-4 of their scale in f32 and 5e-2 in bf16 (the towers' bars), its
boxes, ids and confidences exact. Clips are written by oatx's writer, and
the port's reader is patched to serve oatx's decoded frames
(`patch_port_decode`): the stub's seed hashes the pixels, and the two
decoders differ by up to 4 a pixel.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatx.cli import extract as jcli
from oatx.data import extraction as jex
from oatx.data import video_reader as jvr
from oatx.models import distilbert as jdb
from oatx.models import towers as jtowers
from oatx.models import vit_spacetime as jvst
from oatx.ops import roi_align as jroi
from oatx_torch.cli import extract as pcli
from oatx_torch.data import extraction as pex
from oatx_torch.models import distilbert as pdb
from oatx_torch.models import towers as ptowers
from oatx_torch.models import vit_spacetime as pvst
from oatx_torch.ops import roi_align as proi
from torch_port_helpers import oatx_params, patch_port_decode, port_model

torch.set_num_threads(1)

ROI_TOL = 1e-6
F32_TOL = 1e-4
BF16_TOL = 5e-2
# boxes on the edges, of zero area (a point, a zero-width strip) and reaching
# outside [0, 1], then interior ones
EDGE_BOXES = np.array([[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.1, 1.0], [0.9, 0.0, 1.0, 0.05],
                       [0.5, 0.5, 0.5, 0.5], [0.3, 0.2, 0.3, 0.8], [-0.2, -0.1, 1.3, 0.5],
                       [0.9, 0.9, 1.5, 1.2], [-0.5, 0.4, 0.2, 1.0]], np.float32)
CLIP_FRAMES = (20, 24, 28, 5)  # the last is shorter than the 8-slot grid
# oatx's functions under jit (eager, each of vmap's gathers compiles alone)
_jroi_align = jax.jit(jroi.roi_align, static_argnums=(2, 3))
_jroi_pool = jax.jit(jroi.roi_pool_patches, static_argnums=(2, 3))


def _scaled(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max() + 1e-30)


def _roi_inputs(seed, b=2, h=7, w=9, c=5):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    xs, ys = np.sort(rng.uniform(0, 1, (2, b, 4, 2)), axis=-1)   # x1 < x2, y1 < y2
    inner = np.stack([xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1]], axis=-1)
    boxes = np.concatenate([np.broadcast_to(EDGE_BOXES, (b, 8, 4)), inner], axis=1)
    return feat, boxes.astype(np.float32), rng


@pytest.mark.parametrize("samples_per_bin", [1, 2])
@pytest.mark.parametrize("output_size", [1, 2, 3])
def test_roi_align_matches_oatx(output_size, samples_per_bin):
    feat, boxes, rng = _roi_inputs(output_size * 10 + samples_per_bin)
    want = np.asarray(_jroi_align(jnp.asarray(feat), jnp.asarray(boxes), output_size,
                                  samples_per_bin))
    ft = torch.from_numpy(feat).requires_grad_()
    got = proi.roi_align(ft, torch.from_numpy(boxes), output_size, samples_per_bin)
    _scaled(got.detach().numpy(), want, ROI_TOL)

    cot = rng.standard_normal(want.shape).astype(np.float32)
    jgrad = jax.grad(lambda f: jnp.sum(_jroi_align(f, jnp.asarray(boxes), output_size,
                                                   samples_per_bin) * cot))(jnp.asarray(feat))
    (pgrad,) = torch.autograd.grad(got, ft, torch.from_numpy(cot))
    _scaled(pgrad.numpy(), np.asarray(jgrad), ROI_TOL)


@pytest.mark.parametrize("output_size", [0, 1, 2])
def test_roi_pool_patches_matches_oatx(output_size):
    rng = np.random.default_rng(output_size)
    tokens = rng.standard_normal((2, 14 * 14, 6)).astype(np.float32)
    _, boxes, _ = _roi_inputs(7)
    want = _jroi_pool(jnp.asarray(tokens), jnp.asarray(boxes), 14, output_size)
    got = proi.roi_pool_patches(torch.from_numpy(tokens), torch.from_numpy(boxes), 14,
                                output_size)
    _scaled(got.numpy(), np.asarray(want), ROI_TOL)


@pytest.mark.parametrize("h,w,size", [(48, 96, 32), (32, 32, 32), (20, 30, 32),
                                      (240, 320, 224), (64, 96, 224)])
def test_stretch_resize_matches_oatx(h, w, size):
    frame = np.random.default_rng(h * w).integers(0, 256, (h, w, 3)).astype(np.uint8)
    got, want = pex._stretch_resize_u8(frame, size), jex._stretch_resize_u8(frame, size)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _same_detection(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("regions", [1, 10])
def test_stub_detector_matches_oatx(regions):
    rng = np.random.default_rng(regions)
    for h, w in ((64, 96), (240, 320), (7, 5)):
        frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        _same_detection(pex.StubDetector(num_regions=regions)(frame),
                        jex.StubDetector(num_regions=regions)(frame))


# ------------------------------------------------------------ the pipeline
@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    items = []
    for i, n in enumerate(CLIP_FRAMES):
        p = root / f"v{i}.avi"
        jvr.write_test_video(str(p), 96, 64, n, 8, seed=i)
        items.append((f"v{i}", str(p)))
    lst = root / "items.tsv"
    lst.write_text("".join(f"{v}\t{p}\n" for v, p in items))
    return items, str(lst)


def _same_tree(got_root, want_root):
    """Every .npz under the two roots: the same files, arrays and info."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs if f.endswith(".npz"))

    names = files(want_root)
    assert names and files(got_root) == names
    for name in names:
        got = np.load(os.path.join(got_root, name), allow_pickle=True)
        want = np.load(os.path.join(want_root, name), allow_pickle=True)
        for key in ("x", "bbox"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        gi, wi = got["info"].item(), want["info"].item()
        assert sorted(gi) == sorted(wi) == ["image_h", "image_w", "objects_conf",
                                            "objects_id"]
        for key in wi:
            assert np.asarray(gi[key]).dtype == np.asarray(wi[key]).dtype
            np.testing.assert_array_equal(gi[key], wi[key])
    return names


def _no_clock(stats):
    return {k: v for k, v in stats.items() if k not in ("seconds", "frames_per_sec")}


def test_extract_video_matches_oatx(clips, tmp_path, monkeypatch):
    """Every clip's 8-slot grid (the short clip repeats its last frame), then
    a resumed run that skips every slot and an overwrite."""
    patch_port_decode(monkeypatch)
    items, _ = clips
    for vid, path in items:
        for overwrite in (False, False, True):
            got = pex.extract_video(path, str(tmp_path / "p" / vid), pex.StubDetector(), 8,
                                    overwrite)
            want = jex.extract_video(path, str(tmp_path / "j" / vid), jex.StubDetector(), 8,
                                     overwrite)
            assert got == want
    assert len(_same_tree(str(tmp_path / "p"), str(tmp_path / "j"))) == 8 * len(items)


def test_extract_dataset_and_loss_list_match_oatx(clips, tmp_path, monkeypatch):
    patch_port_decode(monkeypatch)
    items, _ = clips
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    # half the items, then all of them: the loss list, the resumed run
    for part in (items[:2], items):
        assert pex.missing_items(items, p, 4) == jex.missing_items(items, j, 4)
        got = pex.extract_dataset(part, p, num_workers=3, num_extraction_frames=4)
        want = jex.extract_dataset(part, j, num_workers=3, num_extraction_frames=4)
        assert _no_clock(got) == _no_clock(want) and got["failed"] == 0
    assert pex.missing_items(items, p, 4) == jex.missing_items(items, j, 4) == []
    for root in (p, j):
        os.remove(os.path.join(root, "v1", "2.npz"))
    assert pex.missing_items(items, p, 4) == jex.missing_items(items, j, 4) == [items[1]]
    assert _no_clock(pex.extract_dataset(items, p, num_workers=2, num_extraction_frames=4)) \
        == _no_clock(jex.extract_dataset(items, j, num_workers=2, num_extraction_frames=4))
    _same_tree(p, j)


def test_extract_dataset_process_pool_writes_what_threads_write(clips, tmp_path):
    """use_processes: a spawn pool of 2 (each process decodes with the port's
    own reader) writes the files the thread pool writes."""
    items, _ = clips
    items = items[:2]
    a, b = str(tmp_path / "threads"), str(tmp_path / "procs")
    got = pex.extract_dataset(items, b, num_workers=2, num_extraction_frames=2,
                              use_processes=True)
    want = pex.extract_dataset(items, a, num_workers=2, num_extraction_frames=2)
    assert _no_clock(got) == _no_clock(want) == {"processed": 2, "skipped": 0, "failed": 0,
                                                 "frames": 4}
    _same_tree(b, a)


def _run_cli(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr()
    return out.out, out.err


def test_extract_cli_matches_oatx(clips, tmp_path, monkeypatch, capsys):
    """The stub through both CLIs: the stats line, the files, the loss list
    (--missing-only) before and after a file is deleted, --overwrite."""
    patch_port_decode(monkeypatch)
    items, lst = clips
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    common = ["--list", lst, "--workers", "2", "--frames", "3", "--regions", "6"]
    for extra in ([], [], ["--overwrite"]):
        got, _ = _run_cli(pcli.main, [*common, "--out", p, *extra], capsys)
        want, _ = _run_cli(jcli.main, [*common, "--out", j, *extra], capsys)
        assert _no_clock(json.loads(got.splitlines()[-1])) == \
            _no_clock(json.loads(want.splitlines()[-1]))
    _same_tree(p, j)
    for root in (p, j):
        os.remove(os.path.join(root, "v3", "0.npz"))
    got = _run_cli(pcli.main, [*common, "--out", p, "--missing-only"], capsys)
    want = _run_cli(jcli.main, [*common, "--out", j, "--missing-only"], capsys)
    assert got == want and got[0] == f"v3\t{items[3][1]}\n"


# ------------------------------------------------------- TorchScript adapter
class TinyDet(torch.nn.Module):
    """Region features from box-pooled colour: content-dependent, exact."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 16)

    def forward(self, img: torch.Tensor):
        h, w = img.shape[1], img.shape[2]
        boxes = torch.tensor([[0.0, 0.0, 0.5, 0.5], [0.25, 0.25, 1.0, 0.75],
                              [0.5, 0.0, 1.0, 1.0]], device=img.device)
        scale = torch.tensor([float(w), float(h), float(w), float(h)], device=img.device)
        feats = []
        for i in range(3):
            b = (boxes[i] * scale).long()
            feats.append(img[:, b[1]:b[3], b[0]:b[2]].mean(dim=(1, 2)))
        return (self.proj(torch.stack(feats)), boxes * scale,
                torch.arange(3, device=img.device), torch.linspace(0.9, 0.5, 3))


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    torch.manual_seed(0)
    art = tmp_path_factory.mktemp("det") / "det.torchscript"
    torch.jit.script(TinyDet()).save(str(art))
    return str(art)


def test_torchscript_detector_matches_oatx(clips, scripted, tmp_path, monkeypatch, capsys):
    patch_port_decode(monkeypatch)
    items, lst = clips
    det, ref = pex.load_torch_detector(scripted, "cpu"), jex.load_torch_detector(scripted)
    for vid, path in items:
        frame = jvr.decode_indices(path, [2])[0]
        _same_detection(det(frame), ref(frame))
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    common = ["--list", lst, "--frames", "2", "--detector", "torch",
              "--detector-weights", scripted]
    got, _ = _run_cli(pcli.main, [*common, "--out", p, "--device", "cpu"], capsys)
    want, _ = _run_cli(jcli.main, [*common, "--out", j], capsys)
    assert _no_clock(json.loads(got.splitlines()[-1])) == \
        _no_clock(json.loads(want.splitlines()[-1]))
    assert len(_same_tree(p, j)) == 2 * len(items)


# ------------------------------------------------------------ roi_backbone
TINY_VIDEO = dict(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                  num_frames=2)
TINY_TEXT = dict(vocab_size=64, max_position_embeddings=16, dim=32, hidden_dim=64,
                 n_layers=1, n_heads=2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roi_backbone_extractor_matches_oatx(clips, dtype):
    """oatx's tiny tower geometry (tests/test_extraction.py `_tiny_tower`),
    oatx's parameters carried across, on decoded 96×64 frames."""
    jdt, pdt, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                     "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    jcfg = jtowers.TowerConfig(video=jvst.SpaceTimeViTConfig(**TINY_VIDEO),
                               text=jdb.DistilBertConfig(**TINY_TEXT), projection_dim=16,
                               compute_dtype=jdt)
    pcfg = ptowers.TowerConfig(video=pvst.SpaceTimeViTConfig(**TINY_VIDEO),
                               text=pdb.DistilBertConfig(**TINY_TEXT), projection_dim=16,
                               compute_dtype=pdt)
    params = oatx_params(jcfg)
    ref = jex.RoiBackboneExtractor(params, jcfg, num_regions=4)
    got_ex = pex.RoiBackboneExtractor(port_model(params, pcfg), pcfg, num_regions=4,
                                      device="cpu")
    items, _ = clips
    for vid, path in items:
        frame = jvr.decode_indices(path, [1])[0]
        got, want = got_ex(frame), ref(frame)
        assert got[0].shape == want[0].shape == (4, 2048) and got[0].dtype == np.float32
        _scaled(got[0][:, :32], want[0][:, :32], tol)
        np.testing.assert_array_equal(got[0][:, 32:], 0.0)
        _same_detection(got[1:], want[1:])


def test_roi_backbone_cli_feeds_the_global_local_trainer(tmp_path, capsys):
    """cli.extract --detector roi_backbone --device cpu writes every slot of 8
    clips from the port's own tower, and the global_local recipe's loader
    and Trainer (strict loading: a missing or malformed npz raises) take one
    step on them with finite loss terms."""
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data import objects as pobj
    from oatx_torch.data import video_reader as pvr
    from oatx_torch.data.factory import build_loaders
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.train.trainer import Trainer

    vids = tmp_path / "videos"
    vids.mkdir()
    items = []
    for i in range(8):
        p = vids / f"clip{i:04d}.avi"
        pvr.write_test_video(str(p), 96, 64, 6 + 2 * i, 8, seed=i)  # 6: shorter than the grid
        items.append((f"clip{i:04d}", str(p)))
    lst = tmp_path / "items.tsv"
    lst.write_text("".join(f"{v}\t{p}\n" for v, p in items))
    video = {"model": "SpaceTimeTransformer", "arch_config": "base_patch16_224",
             "num_frames": 2, "input_res": 32, "embed_dim": 32, "depth": 1,
             "num_heads": 2, "time_init": "zeros", "pretrained": False}
    cfg = {
        "name": "roi-bb", "tokenizer": {"vocab_size": 256},
        "arch": {"type": "FrozenInTime", "variant": "global_local", "args": {
            "video_params": video,
            "object_params": {"model": "", "input_objects": True},
            "text_params": {"model": "distilbert-base-uncased", "pretrained": False,
                            "vocab_size": 256, "dim": 32, "hidden_dim": 64,
                            "n_layers": 1, "n_heads": 2},
            "projection": "minimal", "projection_dim": 16, "load_checkpoint": ""}},
        "data_loader": [{"type": "MultiDistTextObjectVideoDataLoader", "args": {
            "dataset_name": "SyntheticVideoText", "data_dir": str(vids),
            "object_dir": str(tmp_path / "objects"), "batch_size": 4, "num_workers": 2,
            "split": "train", "object_params": {"num_mask_objects": 3, "top_k": 5},
            "video_params": {"input_res": 32, "num_frames": 2, "num_videos": 8,
                             "loading": "strict"}}}],
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
        "loss": {"type": "NormSoftmaxLoss", "args": {}},
        "metrics": ["t2v_metrics"],
        "trainer": {"epochs": 1, "len_epoch": 1, "save_dir": str(tmp_path / "exps"),
                    "save_period": 1, "verbosity": 0, "monitor": "off", "early_stop": 10,
                    "init_val": False, "precision": "f32", "seed": 0},
        "visualizer": {"type": ""},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out, _ = _run_cli(pcli.main, ["--list", str(lst), "--out", str(tmp_path / "objects"),
                                  "--regions", "5", "--detector", "roi_backbone",
                                  "--detector-config", str(cfg_path), "--device", "cpu"],
                      capsys)
    stats = json.loads(out.splitlines()[-1])
    assert (stats["processed"], stats["failed"], stats["frames"]) == (8, 0, 64)
    f = pobj.read_object_features(str(tmp_path / "objects" / "clip0000" / "7.npz"), top_k=5)
    assert f.shape == (5, 2054) and np.isfinite(f).all() and not np.all(f == 1.0)

    exp = ExperimentCfg.from_dict(cfg)
    tok = WordPieceTokenizer.build_from_corpus(
        [f"a dog runs in scene {i}" for i in range(20)], vocab_size=256)
    tr = Trainer(exp, build_loaders(exp, tok), [], device="cpu")
    hist = tr.train()
    terms = {k: v for k, v in hist[1].items() if k.startswith("loss")}
    assert terms and all(np.isfinite(v) for v in terms.values()), hist[1]


@pytest.mark.parametrize("case", ["torch_no_device", "roi_backbone_no_device",
                                  "roi_backbone_processes", "torch_no_weights",
                                  "roi_backbone_no_config", "bad_list"])
def test_extract_cli_refusals(case, clips, scripted, tmp_path, monkeypatch):
    """Without a card and without --device cpu the torch detectors raise
    (the port never drops to the CPU on its own); oatx's argument errors
    stay errors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, lst = clips
    cfg = os.path.join(os.path.dirname(__file__), "..", "configs", "smoke", "synthetic.json")
    if case == "bad_list":
        bad = tmp_path / "bad.tsv"
        bad.write_text("v0 has no tab\n")
        lst = str(bad)
    argv = {"torch_no_device": ["--detector", "torch", "--detector-weights", scripted],
            "roi_backbone_no_device": ["--detector", "roi_backbone", "--detector-config", cfg],
            "roi_backbone_processes": ["--detector", "roi_backbone", "--detector-config", cfg,
                                       "--processes", "--device", "cpu"],
            "torch_no_weights": ["--detector", "torch", "--device", "cpu"],
            "roi_backbone_no_config": ["--detector", "roi_backbone", "--device", "cpu"],
            "bad_list": []}[case]
    err = RuntimeError if case.endswith("no_device") else SystemExit
    with pytest.raises(err):
        pcli.main(["--list", lst, "--out", str(tmp_path / "o"), *argv])
    assert not (tmp_path / "o").exists()
