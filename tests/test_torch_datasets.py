"""The port's file-backed datasets, adapters and loaders (oatx_torch.data.
datasets, data.factory) against oatx's, on the CPU.

Every adapter reads the metadata layouts oatx's tests write
(test_dataset_adapters.py, test_metadata_fixtures.py, test_tar_dataset.py)
over clips oatx's writer makes. The port's reader is patched to serve oatx's
decoded frames (torch_port_helpers.patch_port_decode: files through oatx's
FFmpeg reader, tar members through PIL as oatx's tar path does), so `len`,
the records, every `get_sample(i, rng)` (video uint8, text, meta, object
extras), the sliding-window and eval-caption expansions, lax substitution,
the tar path and build_loaders' batches are held EXACTLY equal. The port's
package itself never imports oatx.
"""

import io
import json
import os
import pickle
import tarfile

import numpy as np
import pytest

from oatx.config.schema import DataLoaderCfg as JCfg
from oatx.config.schema import ExperimentCfg as JExp
from oatx.data import factory as jfactory
from oatx.data import loader as JL
from oatx.data import video_reader as jvr
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx_torch.config.schema import DataLoaderCfg as PCfg
from oatx_torch.config.schema import ExperimentCfg as PExp
from oatx_torch.data import factory as pfactory
from oatx_torch.data import loader as PL
from oatx_torch.data import video_reader as pvr
from oatx_torch.data.datasets import adapters as padapters
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from torch_port_helpers import patch_port_decode


@pytest.fixture(autouse=True)
def _oatx_frames(monkeypatch):
    patch_port_decode(monkeypatch)


def _clip(path, frames=16, seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jvr.write_test_video(str(path), 96, 64, frames, 8, seed=seed)


def _still(path, seed):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (300, 400, 3))
                    .astype(np.uint8)).save(path, format="JPEG")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One metadata tree per adapter, in the reference's on-disk formats."""
    base = tmp_path_factory.mktemp("layouts")
    r = {}
    # MSR-VTT: annotation json, structured-symlinks lists, videos/all/<id>.mp4
    ms = r["MSRVTT"] = base / "msrvtt"
    vids = [f"video{i}" for i in range(8)]
    anns = [{"image_id": v, "caption": f"caption {c} of clip {i}"}
            for i, v in enumerate(vids) for c in range(1 + i % 3)]
    (ms / "annotation").mkdir(parents=True)
    (ms / "annotation" / "MSR_VTT.json").write_text(json.dumps({"annotations": anns}))
    sdir = ms / "high-quality" / "structured-symlinks"
    sdir.mkdir(parents=True)
    train, test = vids[:5], vids[5:]
    for name, ids in (("train_list_jsfusion.txt", train), ("val_list_jsfusion.txt", test),
                      ("train_list_miech.txt", train), ("test_list_miech.txt", test),
                      ("train_list_full.txt", train), ("val_list_full.txt", test[:2]),
                      ("test_list_full.txt", vids[3:]), ("train_list.txt", train),
                      ("val_list.txt", test), ("public_server_val.txt", test[:2]),
                      ("public_server_test.txt", test)):
        (sdir / name).write_text("\n".join(ids) + "\n")
    with open(sdir / "jsfusion_val_caption_idx.pkl", "wb") as f:
        pickle.dump({v: 0 for v in test}, f)
    for i, v in enumerate(vids):
        _clip(ms / "videos" / "all" / f"{v}.mp4", frames=12 + 4 * i, seed=i)
    # WebVid: TSVs (caption, videoid), <split>/<id>.mp4; one clip missing, one
    # caption empty (pandas reads it as "nan")
    wv = r["WebVid"] = base / "webvid"
    (wv / "meta_data").mkdir(parents=True)
    for split, tsv, n in (("train", "webvid_training_success_full.tsv", 6),
                          ("val", "webvid_validation_success_full.tsv", 3)):
        rows = ["caption\tvideoid"]
        for i in range(n):
            rows.append(f"{'' if i == 2 else f'a {split} webvid clip {i}'}\t{100 + i}")
            if not (split == "train" and i == 4):
                _clip(wv / split / f"{100 + i}.mp4", seed=10 + i)
        (wv / "meta_data" / tsv).write_text("\n".join(rows) + "\n")
    # CC3M: TSVs (caption, file), training/ and validation/ stills
    cc = r["ConceptualCaptions3M"] = base / "cc3m"
    (cc / "meta_data").mkdir(parents=True)
    for sub, tsv, n in (("training", "cc3m_training_success_full.tsv", 4),
                        ("validation", "cc3m_validation_success_full.tsv", 2)):
        rows = ["caption\tfile"]
        for i in range(n):
            _still(str(cc / sub / f"img{i}.jpg"), seed=20 + i)
            rows.append(f"an image {i} in {sub}\timg{i}.jpg")
        (cc / "meta_data" / tsv).write_text("\n".join(rows) + "\n")
    # CC3M in tar shards: '<shard>.tar/<member>' rows
    ct = r["ConceptualCaptions3MTar"] = base / "cc3m_tar"
    (ct / "meta_data").mkdir(parents=True)
    rows = ["caption\tmember"]
    with tarfile.open(ct / "shard0.tar", "w") as tf:
        for i in range(3):
            p = str(ct / f"tmp{i}.jpg")
            _still(p, seed=30 + i)
            data = open(p, "rb").read()
            info = tarfile.TarInfo(f"images/{i}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            rows.append(f"tar image {i}\tshard0.tar/images/{i}.jpg")
    rows.append("a missing member\tshard0.tar/images/nope.jpg")
    (ct / "meta_data" / "cc3m_tar_train.tsv").write_text("\n".join(rows) + "\n")
    # MSVD: captions comma-joined, <id>.avi
    mv = r["MSVD"] = base / "msvd"
    (mv / "meta_data").mkdir(parents=True)
    _clip(mv / "clipA.avi", seed=40)
    _clip(mv / "clipB.avi", seed=41)
    for tsv in ("MSVD_train.tsv", "MSVD_test.tsv"):
        (mv / "meta_data" / tsv).write_text(
            "caption\tvideoid\nfirst cap,second cap,third cap\tclipA\nonly one\tclipB\n")
    # DiDeMo: (caption, relpath)
    dd = r["DiDeMo"] = base / "didemo"
    (dd / "meta_data").mkdir(parents=True)
    rows = ["caption\tvideo"]
    for i in range(4):
        rel = f"part{i % 2}/vid{i}.mp4"
        rows.append(f"a didemo moment {i}\t{rel}")
        _clip(dd / rel, seed=50 + i)
    for tsv in ("DiDeMo_train.tsv", "DiDeMo_val.tsv", "DiDeMo_test.tsv"):
        (dd / "meta_data" / tsv).write_text("\n".join(rows) + "\n")
    # LSMDC: lists, raw-captions.pkl of token lists, frame_tar_list.txt
    ls = r["LSMDC"] = base / "lsmdc"
    sdir = ls / "structured-symlinks"
    sdir.mkdir(parents=True)
    stems = [f"1001_Movie_{i:05d}" for i in range(6)]
    (sdir / "train_list.txt").write_text("\n".join(stems[:4]) + "\n")
    (sdir / "val_list.txt").write_text("\n".join(stems[4:]) + "\n")
    (sdir / "test_list.txt").write_text("\n".join(stems[2:]) + "\n")
    with open(sdir / "raw-captions.pkl", "wb") as f:
        pickle.dump({s: [["someone", "walks", "in", "scene", str(i)], ["then", str(i)]]
                     for i, s in enumerate(stems)}, f)
    (ls / "frame_tar_list.txt").write_text(
        "\n".join(f"/remote/frames/1001_Movie/{s}.tar" for s in stems) + "\n")
    for i, s in enumerate(stems):
        _clip(ls / "videos" / "1001_Movie" / f"{s}.avi", seed=60 + i)
    (sdir / "multiple_choice_val.tsv").write_text(
        f"{stems[4]}\t1\twrong a\tsomeone walks in scene 4\twrong b\n")
    r["SyntheticVideoText"] = base / "synthetic"
    return r


def _cfgs(root, name, split, **kw):
    vp = {"num_frames": 2, "loading": "lax", **kw.pop("video_params", {})}
    args = dict(dataset_name=name, data_dir=str(root), split=split, video_params=vp, **kw)
    return JCfg(**args), PCfg(**args)


def _pair(root, name, split, variant="baseline", **kw):
    jc, pc = _cfgs(root, name, split, **kw)
    return (jfactory.build_dataset(jc, variant, split),
            pfactory.build_dataset(pc, variant, split))


def assert_same(a, b, path="sample"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def assert_same_samples(jds, pds, seeds=(0, 1)):
    assert len(pds) == len(jds)
    assert_same(jds.metadata, pds.metadata, "metadata")
    for i in range(len(jds)):
        for s in seeds:
            assert_same(jds.get_sample(i, np.random.default_rng((s, i))),
                        pds.get_sample(i, np.random.default_rng((s, i))), f"sample {i}/{s}")


CASES = [
    ("WebVid", "train", {}), ("WebVid", "val", {}), ("WebVid", "test", {}),
    ("ConceptualCaptions3M", "train", {"video_params": {"num_frames": 1}}),
    ("ConceptualCaptions3M", "val", {"video_params": {"num_frames": 1}}),
    ("ConceptualCaptions3MTar", "train", {"video_params": {"num_frames": 1}}),
    ("MSVD", "train", {}), ("MSVD", "test", {}),
    ("DiDeMo", "train", {}), ("DiDeMo", "test", {}),
    ("LSMDC", "train", {}), ("LSMDC", "test", {}),
    ("LSMDC_choice", "val", {}), ("LSMDC_choice", "test", {}),
    ("SyntheticVideoText", "train", {"video_params": {"num_videos": 5, "fixture_seeded": True}}),
] + [("MSRVTT", split, {"cut": cut}) for cut, split in (
    ("jsfusion", "train"), ("jsfusion", "test"), ("miech", "test"), ("full-val", "test"),
    ("full-test", "test"), ("val", "val"), ("public_server_val", "test"),
    ("public_server_test", "test"))]


@pytest.mark.parametrize("name,split,kw", CASES,
                         ids=[f"{n}-{s}-{kw.get('cut', '')}" for n, s, kw in CASES])
def test_adapter_samples_match_oatx(roots, name, split, kw):
    root = roots["LSMDC" if name == "LSMDC_choice" else name]
    jds, pds = _pair(root, name, split, **kw)
    assert type(pds).__name__ == type(jds).__name__
    assert pds.is_video == jds.is_video
    assert_same_samples(jds, pds)


def test_sliding_windows_match_oatx(roots):
    jds, pds = _pair(roots["MSRVTT"], "MSRVTT", "test", cut="jsfusion")
    jds.expand_sliding_windows(2)
    pds.expand_sliding_windows(2)
    assert len(pds) > 3
    assert_same_samples(jds, pds, seeds=(0,))
    assert {s["meta"]["window_group"] for s in (pds.get_sample(i) for i in range(len(pds)))} \
        == {0, 1, 2}


def test_eval_captions_match_oatx(roots):
    jds, pds = _pair(roots["MSRVTT"], "MSRVTT", "test", cut="full-test")
    assert pds.expand_eval_captions() == jds.expand_eval_captions() == 3
    assert_same_samples(jds, pds, seeds=(0,))


@pytest.mark.parametrize("loading", ["lax", "strict"])
def test_missing_clip_substitution_matches_oatx(roots, loading):
    """WebVid train row 4 has no clip: lax substitutes the same other item
    (the same rng draws), strict raises ValueError in both."""
    jds, pds = _pair(roots["WebVid"], "WebVid", "train",
                     video_params={"loading": loading})
    if loading == "strict":
        for ds in (jds, pds):
            with pytest.raises(ValueError, match="strict mode"):
                ds.get_sample(4, np.random.default_rng(0))
        return
    for s in range(3):
        assert_same(jds.get_sample(4, np.random.default_rng(s)),
                    pds.get_sample(4, np.random.default_rng(s)))


def test_tar_missing_member_and_threads_match_oatx(roots):
    jds, pds = _pair(roots["ConceptualCaptions3MTar"], "ConceptualCaptions3MTar", "train",
                     video_params={"num_frames": 1})
    assert pds.metadata[3]["member"].endswith("nope.jpg")
    loaders = [mod.ShardedLoader(ds, 2, mod.Collator(tok.build_from_corpus(["tar image"])),
                                 shuffle=False, drop_last=False, num_workers=3)
               for mod, tok, ds in ((JL, JTok, jds), (PL, PTok, pds))]
    for jb, pb in zip(loaders[0], loaders[1]):
        assert_same(jb, pb, "batch")


def test_tar_path_decodes_with_the_port_decoder(roots, monkeypatch):
    """Unpatched, the port's own decoder reads the members (PIL's fancy
    chroma upsampling differs from FFmpeg's, so no exact check here)."""
    monkeypatch.undo()
    _, pds = _pair(roots["ConceptualCaptions3MTar"], "ConceptualCaptions3MTar", "train",
                   video_params={"num_frames": 1})
    a = pds.get_sample(0, np.random.default_rng(0))["video"]
    b = pds.get_sample(1, np.random.default_rng(0))["video"]
    assert a.shape == b.shape == (1, 256, 256, 3) and not np.array_equal(a, b)


def test_reference_full_frame_crop_matches_oatx(roots):
    jds, pds = _pair(roots["WebVid"], "WebVid", "train",
                     video_params={"train_crop": "reference_full_frame", "input_res": 32})
    assert pds.get_sample(0, np.random.default_rng(0))["video"].shape == (2, 32, 32, 3)
    assert_same_samples(jds, pds, seeds=(3,))


def test_object_extras_match_oatx(tmp_path):
    """global_local over SyntheticVideoText with object npzs: the object
    frame through `_decode_object_frame`, tags, patch masks."""
    root = tmp_path / "syn"
    kw = dict(object_dir=str(tmp_path / "objects"),
              video_params={"num_videos": 4, "fixture_seeded": True, "input_res": 64})
    jds, pds = _pair(root, "SyntheticVideoText", "train", variant="global_local", **kw)
    s = pds.get_sample(1, np.random.default_rng(0))
    assert s["object_frame"].shape == (1, 256, 256, 3) and "patch_masks" in s
    assert_same_samples(jds, pds, seeds=(0,))


def test_build_loaders_batches_match_oatx(roots):
    raw = {"name": "mix", "arch": {"args": {"video_params": {"num_frames": 2}}},
           "data_loader": [
               {"type": "TextVideoDataLoader", "args": {
                   "dataset_name": "ConceptualCaptions3M", "data_dir": str(roots[
                       "ConceptualCaptions3M"]), "batch_size": 2, "num_workers": 2,
                   "video_params": {"num_frames": 1, "loading": "lax"}}},
               {"type": "TextVideoDataLoader", "args": {
                   "dataset_name": "WebVid", "data_dir": str(roots["WebVid"]),
                   "batch_size": 2, "num_workers": 3,
                   "video_params": {"num_frames": 2, "loading": "lax"}}}]}
    corpus = [f"an image {i} in training" for i in range(4)] + ["a train webvid clip 3"]
    for split in ("train", "val"):
        jl = jfactory.build_loaders(JExp.from_dict(raw), JTok.build_from_corpus(corpus),
                                    split=split, seed=3)
        pl = pfactory.build_loaders(PExp.from_dict(raw), PTok.build_from_corpus(corpus),
                                    split=split, seed=3)
        assert [len(l) for l in pl] == [len(l) for l in jl]
        for j, p in zip(jl, pl):
            for epoch in (1, 2):
                j.set_epoch(epoch)
                p.set_epoch(epoch)
                n = 0
                for jb, pb in zip(j, p):
                    assert_same(jb, pb, f"{split} batch")
                    n += 1
                assert n == len(j)


def test_read_tsv_keeps_pandas_semantics(tmp_path):
    import pandas as pd

    p = tmp_path / "t.tsv"
    p.write_text('caption\tvideoid\textra\na "quoted" one\tv1\tx\n\tv2\t\n'
                 '"tab\tinside"\tv3\ny\nlast\tv5\tz\n')
    want = [[str(c) for c in r] for r in pd.read_csv(p, sep="\t").itertuples(index=False)]
    assert padapters._read_tsv(str(p)) == want
    # typed columns: ints, floats, an int column with a gap, NA tokens, bools,
    # ints and floats together, signed zeros, padded numbers and blank lines
    cols = {"int": ["007", "8", " 9 ", "+3", "-0"],
            "float": ["1.50", "2", "3.", "-.5e+3", "1e400"],
            "gapped": ["123", "", "124", "-0", "NA"],
            "na": ["N/A", "null", "None", "#N/A", "<NA>"],
            "bool": ["TRUE", "false", "True", "NULL", "FALSE"],
            "inf": ["inf", "-Infinity", "0001.500", "-0", "nan"],
            "text": ["007", "1.5", "x", "True", "NA"]}
    rows = ["\t".join(r) for r in zip(*cols.values())]
    p.write_text("\t".join(cols) + "\n" + "\n".join(rows[:3]) + "\n  \n\n"
                 + "\n".join(rows[3:]) + "\n")
    df = pd.read_csv(p, sep="\t")
    want = [[str(c) for c in r] for r in df.itertuples(index=False)]
    got = padapters._read_tsv(str(p))
    assert got == want
    assert [r[0] for r in got] == ["7", "8", "9", "3", "0"]
    assert [r[2] for r in got] == ["123.0", "nan", "124.0", "0.0", "nan"]
    assert [r[6] for r in got] == ["007", "1.5", "x", "True", "nan"]
    assert [str(t) for t in df.dtypes] == ["int64", "float64", "float64", "float64", "object",
                                           "float64", "str"]
    with open(p, "a") as f:
        f.write("\t".join(["1"] * (len(cols) + 1)) + "\n")
    with pytest.raises(ValueError, match="fields"):
        padapters._read_tsv(str(p))


@pytest.mark.parametrize("cells, port, pandas", [
    (["12345678901234567890", "+5"], ["12345678901234567890", "5"],
     ["12345678901234567890", "5"]),     # uint64: the same
    (["12345678901234567890", "-5"], ["1.2345678901234567e+19", "-5.0"],
     ["12345678901234567890", "-5"]),    # pandas keeps the text
    (["12345678901234567890", "NA"], ["1.2345678901234567e+19", "nan"],
     ["12345678901234567890", "NA"]),    # pandas keeps the text, even "NA"
    (["9223372036854775807", "1.5"], ["9.223372036854776e+18", "1.5"],
     ["9.223372036854778e+18", "1.5"]),  # pandas' parser lands an ulp away
])
def test_read_tsv_known_differences_from_pandas(tmp_path, cells, port, pandas):
    """Each place the csv reader departs from pandas, stated: integers
    outside int64 beside a negative number or a gap, and numbers of more
    than 17 digits in a float column (uint64 itself agrees)."""
    import pandas as pd

    p = tmp_path / "t.tsv"
    p.write_text("h\tk\n" + "".join(f"{c}\tk\n" for c in cells))
    assert [r[0] for r in padapters._read_tsv(str(p))] == port
    assert [str(r[0]) for r in pd.read_csv(p, sep="\t").itertuples(index=False)] == pandas


def test_dataset_captions_match_oatx(roots):
    from oatx.cli.common import dataset_captions as jcaps
    from oatx_torch.cli.common import dataset_captions as pcaps

    raw = {"name": "caps", "data_loader": [
        {"args": {"dataset_name": n, "data_dir": str(roots[n]),
                  "video_params": {"num_frames": 1}}}
        for n in ("ConceptualCaptions3M", "WebVid", "MSRVTT")]}
    raw["data_loader"].append({"args": {"dataset_name": "WebVid", "data_dir": "/nonexistent"}})
    got = pcaps(PExp.from_dict(raw))
    assert got == jcaps(JExp.from_dict(raw)) and len(got) == 4 + 6 + 5


def test_unported_writer_codecs_raise(tmp_path):
    jc, pc = _cfgs(tmp_path / "syn", "SyntheticVideoText", "train",
                   video_params={"num_videos": 1, "fixture_codec": "libx264"})
    with pytest.raises(pvr.UnsupportedMedia):
        pfactory.build_dataset(pc, "baseline", "train")
