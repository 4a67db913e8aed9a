"""The port's renderers, HTML gallery and PNG writer against oatx's
(oatx.visualization.*, oatx.utils.html_viz), on the same numpy inputs.

Tolerances: jet_colormap exact; word_patch_attention 1e-6; the heatmap
upsample 1e-5 absolute of PIL's mode-"F" resize (it is bit-exact here);
every panel pixel-exact without text, and exact outside the text boxes
with text. Deliberate differences, each checked here: the port draws text
in its own bitmap font (visualization/font.py), so a text box is the union
of PIL's `textbbox` and the port's `text_box`; it never asks nltk's tagger
(oatx's is hidden with sys.modules["nltk"] = None, so both use the
heuristic); its PNG bytes are its own (files compare decoded).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

from oatx.utils import html_viz as jhtml
from oatx.visualization import binary_map as jbin
from oatx.visualization import heatmap as jheat
from oatx.visualization import plots as jplots
from oatx_torch.utils import html_viz as phtml
from oatx_torch.visualization import binary_map as pbin
from oatx_torch.visualization import font as pfont
from oatx_torch.visualization import heatmap as pheat
from oatx_torch.visualization import plots as pplots
from oatx_torch.visualization.png import read_png, write_png


@pytest.fixture(autouse=True)
def no_nltk(monkeypatch):
    monkeypatch.setitem(sys.modules, "nltk", None)


def text_mask(shape, texts):
    """(H, W) bool: inside PIL's textbbox or the port's text_box of any
    (xy, text) in `texts` (panel coordinates)."""
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    mask = np.zeros(shape[:2], bool)
    for xy, text in texts:
        for x0, y0, x1, y1 in (draw.textbbox(xy, text), pfont.text_box(xy, text)):
            mask[max(int(y0), 0):max(int(np.ceil(y1)), 0),
                 max(int(x0), 0):max(int(np.ceil(x1)), 0)] = True
    return mask


def heatmap_texts(h, label, caption):
    texts = [((8, 8), label)] if label else []
    if caption:
        texts += [((8, h + 4 + 14 * (j // 60)), caption[j:j + 60])
                  for j in range(0, len(caption), 60)]
    return texts


def same_outside(got, want, texts):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    keep = ~text_mask(got.shape, texts)
    np.testing.assert_array_equal(got[keep], want[keep])
    return keep


def test_jet_colormap_and_attention_match_oatx():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-0.2, 1.2, 1001), rng.uniform(size=500)]).astype(np.float32)
    np.testing.assert_array_equal(pheat.jet_colormap(x), jheat.jet_colormap(x))
    w, p = rng.standard_normal(64), rng.standard_normal((196, 64))
    for scale in (None, 3.0):
        np.testing.assert_allclose(pheat.word_patch_attention(w, p, scale),
                                   jheat.word_patch_attention(w, p, scale), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((14, 14), (224, 224)), ((7, 7), (100, 100)),
                                     ((16, 16), (5, 5)), ((14, 9), (33, 224))])
def test_bilinear_upsample_matches_pil_mode_f(src, dst):
    grid = np.random.default_rng(1).standard_normal(src).astype(np.float32) * 4
    want = np.asarray(Image.fromarray(grid, mode="F").resize(dst[::-1], Image.BILINEAR))
    got = pheat.bilinear_upsample(grid, *dst)
    assert got.dtype == np.float32 and got.shape == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jheat.bilinear_upsample(grid, *dst), rtol=0, atol=1e-5)


FRAMES = {"uint8": lambda r: r.integers(0, 256, (224, 224, 3)).astype(np.uint8),
          "unit": lambda r: r.uniform(-0.1, 1.1, (224, 224, 3)).astype(np.float32),
          "255": lambda r: r.uniform(-5, 260, (224, 224, 3)).astype(np.float32)}


@pytest.mark.parametrize("kind", sorted(FRAMES))
@pytest.mark.parametrize("text", [False, True])
def test_render_heatmap_frame_matches_oatx(kind, text):
    rng = np.random.default_rng(2)
    frame = FRAMES[kind](rng)
    attn = rng.uniform(size=196)
    attn /= attn.sum()
    label, caption = ("dog", "a dog runs after a red ball on the wide green lawn near "
                      "the old stone house by the lake") if text else (None, None)
    vr = "255" if kind == "255" else "unit"
    want = jheat.render_heatmap_frame(attn, frame, label=label, caption=caption, value_range=vr)
    got = pheat.render_heatmap_frame(attn, frame, label=label, caption=caption, value_range=vr)
    assert got.shape == ((274 if text else 224), 448, 3)
    keep = same_outside(got, want, heatmap_texts(224, label, caption))
    if text:  # the text is drawn: the boxes hold red pixels
        assert keep.mean() < 1 and (got[~keep] == [255, 0, 0]).all(-1).any()
    with pytest.raises(ValueError, match="value_range"):
        pheat.render_heatmap_frame(attn, frame.astype(np.float32), value_range="bad")


def test_render_featmap_matches_oatx(tmp_path):
    rng = np.random.default_rng(3)
    frame, patches = FRAMES["uint8"](rng), rng.standard_normal((196, 32))
    got = pheat.render_featmap(patches, frame, str(tmp_path / "p.png"))
    np.testing.assert_array_equal(got, jheat.render_featmap(patches, frame))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")), got)


def test_is_probable_noun_matches_oatx_heuristic():
    words = ["dog", "The", "running", "jumped", "quickly", "ball.", "over", "", "x2",
             "Cats!", "a", "tree,", "\"house\"", "I", "played", "sky"]
    assert [pheat.is_probable_noun(w) for w in words] == [jheat.is_probable_noun(w)
                                                          for w in words]


def test_render_caption_heatmaps_matches_oatx(tmp_path):
    rng = np.random.default_rng(4)
    caption = "a dog chases the red ball across the green grass quickly"
    words = [rng.standard_normal(32) for _ in caption.split(" ")[:-1]]  # one short
    patches, frame = rng.standard_normal((196, 32)), FRAMES["uint8"](rng)
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "p")
    want = jheat.render_caption_heatmaps(caption, words, patches, frame, str(tmp_path / "j/x"))
    got = pheat.render_caption_heatmaps(caption, words, patches, frame, str(tmp_path / "p/x"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    # the heuristic's nouns with an embedding: dog chases ball across green grass
    assert [int(p.rsplit("_", 1)[1][:-4]) for p in got] == [1, 2, 5, 6, 8, 9]
    for g, w in zip(got, want):
        i = int(g.rsplit("_", 1)[1][:-4])
        a, b = np.asarray(Image.open(g)), np.asarray(Image.open(w))
        same_outside(a, b, heatmap_texts(224, caption.split(" ")[i], caption))
        np.testing.assert_array_equal(read_png(g), a)
    every = pheat.render_caption_heatmaps(caption, words, patches, frame,
                                          str(tmp_path / "p/all"), nouns_only=False)
    assert len(every) == len(words)


@pytest.mark.parametrize("label", [None, "a man walks his dog along the beach at dawn"])
@pytest.mark.parametrize("frame_hw", [(256, 256), (240, 320), (96, 128)])
def test_binary_map_matches_oatx(tmp_path, label, frame_hw):
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (*frame_hw, 3)).astype(np.uint8)
    gt = (rng.uniform(size=196) > 0.6).astype(np.float32)
    pred = rng.uniform(size=196).astype(np.float32)
    want = jbin.render_binary_map(frame, gt, pred, label=label[:40] if label else None)
    got = pbin.render_binary_map(frame, gt, pred, label=label[:40] if label else None)
    assert got.shape == (224, 672, 3)
    same_outside(got, want, [((8, 8), label[:40])] if label else [])
    path = pbin.save_binary_map(str(tmp_path / "m.png"), frame, gt, pred, label=None)
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  jbin.render_binary_map(frame, gt, pred))


def test_draw_bboxes_matches_pil_with_fractional_corners():
    """ImageDraw.rectangle(width=2)'s pixels, boxes anywhere (inside, across
    the edge, thinner than 4 pixels), at fractional corners."""
    rng = np.random.default_rng(6)
    for t in range(200):
        h, w = rng.integers(8, 80, 2)
        frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        n = int(rng.integers(1, 5))
        a, b = rng.uniform(-0.1, 1.1, (n, 2)), rng.uniform(-0.1, 1.1, (n, 2))
        boxes = np.concatenate([np.minimum(a, b), np.maximum(a, b)], 1)
        if t % 3 == 0:
            boxes[:, 2:] = boxes[:, :2] + rng.uniform(0, 0.06, (n, 2))
        np.testing.assert_array_equal(pplots.draw_bboxes(frame, boxes),
                                      jplots.draw_bboxes(frame, boxes))


def test_draw_bboxes_labels_and_panel_match_oatx():
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (3, 96, 128, 3)).astype(np.uint8)
    boxes = np.array([[0.1, 0.3, 0.55, 0.9], [0.52, 0.05, 0.97, 0.61]])
    tags = ["dog", "frisbee"]
    got, want = pplots.draw_bboxes(frames[0], boxes, tags), jplots.draw_bboxes(frames[0], boxes,
                                                                               tags)
    texts = [((x1 * 128 + 2, max(0, y1 * 96 - 12)), t) for (x1, y1, _, _), t in zip(boxes, tags)]
    same_outside(got, want, texts)
    caption = "a dog leaps for a frisbee in the park " * 4
    got = pplots.video_text_object_panel(frames, caption, boxes, tags)
    want = jplots.video_text_object_panel(frames, caption, boxes, tags)
    assert got.shape == (96 + 28, 3 * 128, 3)
    same_outside(got, want, texts + [((6, 96 + 6), caption[:120])])
    np.testing.assert_array_equal(pplots.video_text_object_panel(frames, ""),
                                  jplots.video_text_object_panel(frames, ""))


def test_png_writer_round_trips(tmp_path):
    a = np.random.default_rng(8).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), a)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), a)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), a)
    Image.fromarray(a).save(tmp_path / "pil.png")  # PIL filters its rows: refused
    with pytest.raises(ValueError, match="filter"):
        read_png(str(tmp_path / "pil.png"))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "b.png"), a.astype(np.float32))


@pytest.mark.parametrize("refresh", [None, 5])
def test_retrieval_vis_html_is_oatx_bytes(tmp_path, refresh):
    rng = np.random.default_rng(9)
    sims = rng.standard_normal((6, 6))
    caps = [f"caption <{i}> & \"more\"" for i in range(6)]
    paths = [f"videos/v{i}.mp4" if i % 2 else f"stills/s{i}.jpg" for i in range(6)]
    out = []
    for mod, sub in ((jhtml, "j"), (phtml, "p")):
        vis = mod.RetrievalVis(str(tmp_path / sub), title="t & <t>", top_k=3,
                               refresh_seconds=refresh)
        vis.from_sims(sims, caps, paths)
        vis.add_ranking("extra", paths[:2])
        out.append(open(vis.write(), "rb").read())
    assert out[0] == out[1]
    assert (b"http-equiv" in out[1]) == bool(refresh)


# ------------------------------------------------------------ the CLIs
# Both packages' CLIs on configs/smoke/synthetic.json's tiny f32 towers,
# from one exported .pth, over one clip of oatx's writer (the port's reader
# patched to serve oatx's frames). The word embeddings and the patches
# agree within 1e-4 of scale. The display frame is jax.image.resize's in
# oatx and F.interpolate's (antialiased) in the port, cast by truncation, so
# it agrees within 1 level: 3.24 % of its pixels are one level off here
# (FRAME_FLIPS bounds it). The PNGs agree outside the text boxes within 1
# level, off only where their inputs are (the display frame, or a colour
# level that the 1e-7 difference of the attention moves across a
# truncation): 1.36-1.45 % of their pixels here (PANEL_FLIPS). Region maps:
# at most 6.7e-6 of a panel's pixels (MAP_FLIPS).
SMOKE = os.path.join(os.path.dirname(__file__), "..", "configs", "smoke", "synthetic.json")
CAPTION = "a dog chases the ball across green grass"
FRAME_FLIPS, PANEL_FLIPS, MAP_FLIPS = 0.04, 0.02, 0.001


def _close(got, want, scale=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max())


def _within_one(got, want, texts, flips):
    """At most 1 level apart outside the text boxes, on at most `flips` of
    the pixels → the share that differs."""
    assert got.shape == want.shape
    keep = ~text_mask(got.shape, texts)
    d = np.abs(got.astype(np.int16) - want)[keep]
    assert d.max() <= 1
    share = float((d.max(-1) > 0).mean())
    assert share <= flips, share
    return share


def _smoke_raw(root, variant="baseline"):
    import json

    with open(SMOKE) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(data_dir=str(root / "videos"), object_dir="", num_workers=2, split="test")
    dl["video_params"].update(fixture_seeded=True, num_videos=8)
    raw["trainer"].update(save_dir=str(root / "exps"), verbosity=0)
    if variant == "region_mem":
        raw["name"] = "smoke-region"
        raw["arch"]["variant"] = "region_mem"
        raw["arch"]["args"]["video_params"]["depth"] = 6  # the recipe's region tap is block 6
        dl.update(object_dir=str(root / "objects"), object_params={"top_k": 15})
        raw["visualizer"] = {"type": "RetrievalVis"}
    return raw


def _perturbed(sd, seed):
    """Every tensor moved off its init (biases and LN affines off 0 / 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in sd.items()}


def _export_init(root, raw, name):
    """The port's towers of the raw's config, perturbed, saved as the
    reference .pth the config then loads: both packages read the same
    weights."""
    import torch

    from oatx_torch.config.schema import ExperimentCfg as PExp
    from oatx_torch.config.schema import build_tower_config as pbuild
    from oatx_torch.models.towers import DualTower

    model = DualTower(pbuild(PExp.from_dict(raw).arch), "cpu", torch.Generator().manual_seed(1))
    path = str(root / name)
    torch.save({"state_dict": _perturbed(model.state_dict(), 2), "epoch": 0}, path)
    raw["arch"]["args"]["load_checkpoint"] = path
    return path


def _write_cfg(path, raw):
    import json

    path.write_text(json.dumps(raw))
    return str(path)


def jit_oatx(mp):
    """oatx's CLIs call its model functions eagerly, and eager JAX compiles
    every operation apart (≈ 25 s of these tests on this CPU). The same
    functions under jax.jit give the same numbers within float rounding."""
    import jax

    from oatx.models import clip_text as jct
    from oatx.models import clip_vision as jcv
    from oatx.models import towers as jtowers

    for mod, names in ((jtowers, ("init", "compute_video", "compute_text", "_vid_proj")),
                       (jcv, ("encode_image_patches",)), (jct, ("encode_text",))):
        for name in names:
            mp.setattr(mod, name, jax.jit(getattr(mod, name), static_argnums=1))


@pytest.fixture(scope="module")
def visualized(tmp_path_factory):
    """cli.visualize of both packages, both backbones → {(pkg, backbone):
    (paths, word_embeds, patch_embeds, display frame)}."""
    import torch

    from oatx.cli import visualize as jvis
    from oatx.data import video_reader as jvr
    from oatx_torch.cli import visualize as pvis
    from oatx_torch.data.clip_tokenizer import ClipBatchTokenizer, ClipTokenizer
    from oatx_torch.models import clip_text as pct
    from oatx_torch.models import clip_vision as pcv
    from oatx_torch.models import convert as pconvert
    from torch_port_helpers import patch_port_decode

    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("visualize")
    raw = _smoke_raw(root)
    _export_init(root, raw, "init.pth")
    cfg = _write_cfg(root / "c.json", raw)
    clip = str(root / "clip.avi")
    jvr.write_test_video(clip, 320, 240, 16, 8, seed=5)
    vision = pcv.ClipVision(pcv.ClipVisionConfig(input_resolution=32, patch_size=8, width=64,
                                                 heads=1, layers=2, output_dim=32), "cpu")
    text = pct.ClipText(pct.ClipTextConfig(vocab_size=800, context_length=16, width=64, heads=1,
                                           layers=2, embed_dim=32), "cpu")
    torch.save(_perturbed({**pconvert.clip_vision_to_torch(vision), **text.state_dict()}, 3),
               root / "clip.pt")
    bpe = ClipBatchTokenizer(ClipTokenizer.for_tests([CAPTION])).save_vocab(str(root / "x"))
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(sys.modules, "nltk", None)
        patch_port_decode(mp)
        jit_oatx(mp)
        for pkg, mod, heat in (("oatx", jvis, jheat), ("port", pvis, pheat)):
            render = heat.render_caption_heatmaps

            def recording(caption, words, patches, frame, prefix, *a, _r=render, **k):
                paths = _r(caption, words, patches, frame, prefix, *a, **k)
                out[pkg, os.path.basename(prefix)] = (paths, np.stack(words), patches, frame)
                return paths

            mp.setattr(heat, "render_caption_heatmaps", recording)
            os.makedirs(root / pkg)
            dev = ["--device", "cpu"] if pkg == "port" else []
            assert mod.main(["-c", cfg, "--video", clip, "--caption", CAPTION,
                             "--out", str(root / pkg / "tower"), *dev]) == 0
            assert mod.main(["--backbone", "clip", "--clip-ckpt", str(root / "clip.pt"),
                             "--bpe-vocab", bpe, "--video", clip, "--caption", CAPTION,
                             "--out", str(root / pkg / "clip"), *dev]) == 0
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("backbone", ["tower", "clip"])
def test_visualize_matches_oatx(visualized, backbone):
    (jpaths, jwords, jpatches, jframe) = visualized["oatx", backbone]
    (ppaths, pwords, ppatches, pframe) = visualized["port", backbone]
    assert [os.path.basename(p) for p in ppaths] == [os.path.basename(p) for p in jpaths]
    assert [int(p.rsplit("_", 1)[1][:-4]) for p in ppaths] == [1, 2, 4, 5, 6, 7]
    _close(pwords, jwords)
    _close(ppatches, jpatches)
    assert ppatches.shape == ((16, 64) if backbone == "tower" else (16, 32))
    assert pframe.shape == jframe.shape == (224, 224, 3) and pframe.dtype == np.uint8
    _within_one(pframe, jframe, (), FRAME_FLIPS)
    words = CAPTION.split(" ")
    for p, j in zip(ppaths, jpaths):
        got, want = read_png(p), np.asarray(Image.open(j))
        assert got.shape == (274, 448, 3)
        _within_one(got, want, heatmap_texts(224, words[int(p.rsplit("_", 1)[1][:-4])], CAPTION),
                    PANEL_FLIPS)


@pytest.mark.parametrize("backbone", ["tower", "clip"])
def test_visualize_refuses_the_cpu_unless_asked(tmp_path, monkeypatch, backbone):
    import torch

    from oatx_torch.cli import visualize as pvis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--video", str(tmp_path / "v.avi"), "--caption", "a dog", "--out",
            str(tmp_path / "o")]
    argv += (["-c", _write_cfg(tmp_path / "c.json", _smoke_raw(tmp_path))] if backbone == "tower"
             else ["--backbone", "clip", "--clip-ckpt", str(tmp_path / "c.pt")])
    with pytest.raises(RuntimeError, match="CUDA"):
        pvis.main(argv)
    assert not list(tmp_path.glob("o_token_*"))


# ------------------------------------------------- region maps, gallery
# Both cli.tests on a tiny region_mem config (smoke widths, 6 blocks for
# the recipe's region tap, SyntheticVideoText with its object files, the
# seeded region bank) with the RetrievalVis gallery, from one .pth. The
# maps' inputs are captured where each package saves them.
@pytest.fixture(scope="module")
def region_tested(tmp_path_factory):
    import json

    from oatx.cli import test as jtest
    from oatx.parallel import mesh as jmesh
    from oatx_torch.cli import test as ptest
    from oatx_torch.eval import retrieval_eval as peval
    from torch_port_helpers import patch_port_decode

    root = tmp_path_factory.mktemp("region")
    raw = _smoke_raw(root, "region_mem")
    _export_init(root, raw, "init.pth")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        patch_port_decode(mp)
        jit_oatx(mp)
        make_mesh = jmesh.make_mesh
        mp.setattr(jmesh, "make_mesh", lambda *a, **k: make_mesh(*a, **{**k, "n_devices": 1}))
        for pkg, main, mod, attr, dev in (("oatx", jtest.main, jbin, "save_binary_map", []),
                                          ("port", ptest.main, peval, "save_binary_map",
                                           ["--device", "cpu"])):
            maps, evals = [], []
            save, evaluate = getattr(mod, attr), main.__globals__["evaluate"] \
                if pkg == "oatx" else peval.evaluate

            def saving(path, frame, gt, pred, label=None, _s=save, _m=maps):
                _m.append((os.path.basename(path), np.array(frame), np.array(gt),
                           np.array(pred), label))
                return _s(path, frame, gt, pred, label=label)

            def evaluating(*a, _e=evaluate, _r=evals, **k):
                _r.append(_e(*a, **k))
                return _r[-1]

            mp.setattr(mod, attr, saving)
            if pkg == "oatx":
                mp.setattr(jtest, "evaluate", evaluating)
            else:
                mp.setattr(peval, "evaluate", evaluating)
            r = json.loads(json.dumps(raw))
            r["trainer"]["save_dir"] = str(root / pkg)
            assert main(["-c", _write_cfg(root / f"{pkg}.json", r), "--no_timestamp", *dev]) == 0
            out[pkg] = (root / pkg / "web" / raw["name"], maps, evals[0])
    finally:
        mp.undo()
        jmesh.set_current_mesh(None)
    return out


def test_export_region_maps_matches_oatx(region_tested):
    (jdir, jmaps, _), (pdir, pmaps, _) = region_tested["oatx"], region_tested["port"]
    assert [m[0] for m in pmaps] == [m[0] for m in jmaps] == [f"{i}_predict.png"
                                                              for i in range(8)]
    for (name, pframe, pgt, ppred, plabel), (_, jframe, jgt, jpred, jlabel) in zip(pmaps, jmaps):
        assert plabel == jlabel and 0 < len(plabel) <= 40
        np.testing.assert_array_equal(pframe, jframe)
        np.testing.assert_array_equal(pgt, jgt)
        assert ppred.shape == (16,) and ((ppred > 0) & (ppred < 1)).all()
        _close(ppred, jpred)
        got = read_png(str(pdir / "region_maps" / name))
        assert got.shape == (224, 672, 3)
        _within_one(got, np.asarray(Image.open(jdir / "region_maps" / name)),
                    [((8, 8), plabel)], MAP_FLIPS)


def _gallery(path):
    """index.html → [(caption, [(class, src, rank, score)])], parsed."""
    from html.parser import HTMLParser

    rows = []

    class P(HTMLParser):
        div = None

        def handle_starttag(self, tag, attrs):
            a = dict(attrs)
            if tag == "div":
                self.div = a.get("class")
                if self.div in ("rank", "rank gt"):
                    rows[-1][1].append([self.div])
            elif tag in ("video", "img"):
                rows[-1][1][-1].append(a["src"])

        def handle_data(self, data):
            if self.div == "caption":
                rows.append((data, []))
            elif self.div == "meta" and data.strip():
                rows[-1][1][-1].append(data.strip())

        def handle_endtag(self, tag):
            self.div = None

    P().feed(path.read_text())
    return rows


def test_cli_test_region_maps_and_gallery_match_oatx(region_tested):
    (jdir, _, jres), (pdir, _, pres) = region_tested["oatx"], region_tested["port"]
    assert sorted(os.listdir(pdir / "region_maps")) == sorted(os.listdir(jdir / "region_maps"))
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ["index.html", "region_maps"]
    _close(pres.sims, jres.sims)
    # well separated: every row's top 6 apart by far more than the two packages differ
    top = -np.sort(-jres.sims, axis=1)[:, :6]
    assert np.diff(-top, axis=1).min() > 100 * np.abs(pres.sims - jres.sims).max()
    got, want = _gallery(pdir / "index.html"), _gallery(jdir / "index.html")
    assert len(got) == 8 and [c for c, _ in got] == [c for c, _ in want]
    for (_, granks), (_, wranks) in zip(got, want):
        assert [r[:3] for r in granks] == [r[:3] for r in wranks]
        np.testing.assert_allclose([float(r[3]) for r in granks], [float(r[3]) for r in wranks],
                                   rtol=0, atol=1.001e-3)
    assert sum(r[0] == "rank gt" for _, ranks in got for r in ranks) >= 1
