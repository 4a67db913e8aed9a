"""The port's object-aware data plane (oatx_torch.data.{objects, sampling,
datasets.base, factory}) against oatx's, on the CPU.

Every comparison is exact: the same npz files (written here), the same
numpy Generators and the same configs give equal arrays, strings and
batches. The object frame comes from MemoryClips' in-memory frames on both
sides (oatx's decode is patched to serve them)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from oatx.config.schema import ExperimentCfg as JExp
from oatx.data import factory as jfactory
from oatx.data import loader as JL
from oatx.data import objects as jobj
from oatx.data import sampling as jsampling
from oatx.data.tokenizer import WordPieceTokenizer as JTok
from oatx_torch.config.schema import ExperimentCfg as PExp
from oatx_torch.data import factory as pfactory
from oatx_torch.data import loader as PL
from oatx_torch.data import objects as pobj
from oatx_torch.data import sampling as psampling
from oatx_torch.data.datasets.base import ObjectAwareDataset, ObjectOptions
from oatx_torch.data.tokenizer import WordPieceTokenizer as PTok
from torch_port_helpers import (MemoryClips, OatxMemoryClips, patch_oatx_decode,
                                write_object_npz)

torch.set_num_threads(1)

BOX_COUNTS = (0, 1, 3, 12, 40)


def _equal(a, b):
    if isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.fixture
def npz_dir(tmp_path):
    rng = np.random.default_rng(3)
    for n in BOX_COUNTS:
        write_object_npz(str(tmp_path / f"n{n}.npz"), rng, n)
    # a file whose confidences tie and whose class ids repeat
    info = {"objects_id": np.array([5, 3, 5, 9, 3, 1]),
            "objects_conf": np.array([0.5, 0.9, 0.5, 0.2, 0.9, 0.5], np.float32),
            "image_w": 100.0, "image_h": 50.0}
    boxes = np.array([[0, 0, 10, 10], [5, 5, 50, 40], [20, 10, 90, 45], [1, 2, 3, 4],
                      [60, 0, 100, 50], [0, 25, 50, 50]], np.float32)
    np.savez(tmp_path / "ties.npz", x=np.arange(6 * 2048, dtype=np.float32).reshape(6, 2048),
             bbox=boxes, info=info)
    return tmp_path


@pytest.mark.parametrize("name", [f"n{n}" for n in BOX_COUNTS] + ["ties", "missing"])
@pytest.mark.parametrize("unique", [False, True])
def test_npz_readers_match_oatx(npz_dir, name, unique):
    path = str(npz_dir / f"{name}.npz")
    vocab = ["__background__"] + [f"class{i}" for i in range(1600)]
    for top_k in (1, 5, 15):
        _equal(pobj.read_object_features(path, top_k, unique),
               jobj.read_object_features(path, top_k, unique))
        got, want = pobj.read_object_bboxes(path, top_k, unique), \
            jobj.read_object_bboxes(path, top_k, unique)
        assert (got is None) == (want is None)
        if want is not None:
            _equal(got, want)
        _equal(pobj.read_object_tags(path, vocab, top_k), jobj.read_object_tags(path, vocab, top_k))
        _equal(pobj.read_object_labels(path, top_k), jobj.read_object_labels(path, top_k))
        got, want = pobj.read_bboxes_and_ids(path, top_k), jobj.read_bboxes_and_ids(path, top_k)
        assert (got is None) == (want is None)
        if want is not None:
            _equal(got[0], want[0])
            _equal(got[1], want[1])
    _equal(pobj.pseudo_label_vector(path), jobj.pseudo_label_vector(path))


def test_confidence_order_and_edge_padding_match_oatx():
    rng = np.random.default_rng(0)
    conf = np.round(rng.uniform(0, 1, 30), 1).astype(np.float32)  # many ties
    _equal(pobj._conf_sort(conf), jobj._conf_sort(conf))
    for n in (0, 1, 4, 9):
        a = rng.standard_normal((n, 3)).astype(np.float32)
        for k in (1, 4, 7):
            _equal(pobj._edge_pad_rows(a, k), jobj._edge_pad_rows(a, k))
    boxes = rng.uniform(0, 300, (7, 4)).astype(np.float32)
    _equal(pobj.scaled_box_geometry(boxes, 320.0, 240.0),
           jobj.scaled_box_geometry(boxes, 320.0, 240.0))


@pytest.mark.parametrize("patch_rows", [2, 7, 14])
def test_patch_masks_match_oatx(patch_rows):
    rng = np.random.default_rng(patch_rows)
    lo = rng.uniform(0, 0.7, (9, 2))
    hi = np.minimum(lo + rng.uniform(0, 0.6, (9, 2)), 1.0)
    geom = np.concatenate([lo, hi, hi - lo], axis=1).astype(np.float32)
    geom[0, :4] = [0.0, 0.0, 1.0, 1.0]            # the whole frame
    geom[1, :4] = [0.5, 0.5, 0.5, 0.5]            # an empty box on a grid line
    geom[2] = 0.0                                 # a padding row
    keep = geom.copy()
    _equal(pobj.patch_masks_from_bboxes(geom, patch_rows),
           jobj.patch_masks_from_bboxes(geom, patch_rows))
    _equal(pobj.single_patch_mask_from_bboxes(geom, patch_rows),
           jobj.single_patch_mask_from_bboxes(geom, patch_rows))
    _equal(geom, keep)  # the input is not modified


def test_tag_spans_match_oatx():
    lens = np.random.default_rng(1).integers(1, 5, 1600)
    for ids in ([], [0], [3, 3, 1599, 7], list(range(20))):
        got, want = pobj.object_tag_token_spans(lens, ids), jobj.object_tag_token_spans(lens, ids)
        _equal(got[0], want[0])
        assert got[1] == want[1]


def _recipe(variant, **object_params):
    return {"name": "r", "arch": {"type": "FrozenInTime", "variant": variant, "args": {}},
            "data_loader": [{"type": "x", "args": {"object_params": object_params,
                                                   "video_params": {"input_res": 224}}}]}


def test_region_bank_lookup_and_seeded_fallback_match_oatx(tmp_path):
    got = pfactory.load_region_bank(PExp.from_dict(_recipe("region_mem")))
    want = jfactory.load_region_bank(JExp.from_dict(_recipe("region_mem")))
    _equal(got.embeddings, want.embeddings)  # bit for bit
    assert got.embeddings.shape == (1600, 512)
    ids = np.array([-3, 0, 17, 1599, 1600, 99999])
    _equal(got.lookup(ids), want.lookup(ids))
    assert pfactory.load_region_bank(PExp.from_dict(_recipe("global_local"))) is None
    bank = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
    np.save(tmp_path / "bank.npy", bank)
    raw = _recipe("region_mem", region_memory_path=str(tmp_path / "bank.npy"))
    _equal(pfactory.load_region_bank(PExp.from_dict(raw)).embeddings,
           jfactory.load_region_bank(JExp.from_dict(raw)).embeddings)


@pytest.mark.parametrize("mode", ["rand", "uniform", "fix_start"])
def test_sampling_matches_oatx(mode):
    for num_frames, vlen in ((4, 1), (4, 3), (4, 4), (4, 37), (8, 200), (1, 5)):
        kw = {"fix_start": 1} if mode == "fix_start" else {"sample": mode}
        got = psampling.sample_frames(num_frames, vlen, rng=np.random.default_rng(vlen), **kw)
        want = jsampling.sample_frames(num_frames, vlen, rng=np.random.default_rng(vlen), **kw)
        assert got == want
        for ext in (1, 8):
            assert psampling.aligned_object_frame_index(got, vlen, ext) == \
                jsampling.aligned_object_frame_index(got, vlen, ext)
    with pytest.raises(ValueError):
        psampling.sample_frames(4, 0)


VARIANT_PARAMS = {
    "global_local": dict(top_k=4, num_mask_objects=3, input_objects=True),
    "region_mem": dict(top_k=6, num_mask_objects=3),
    "baseline": dict(input_objects=True, top_k=3, pseudo_labels=True),
}


def _loader_cfgs(variant):
    raw = {"name": "r", "arch": {"type": "FrozenInTime", "variant": variant, "args": {}},
           "data_loader": [{"type": "x", "args": {
               "object_params": VARIANT_PARAMS[variant],
               "text_params": {"object_tags": variant == "baseline"},
               "video_params": {"input_res": 32}}}]}
    pexp, jexp = PExp.from_dict(raw), JExp.from_dict(raw)
    return (pexp, pexp.data_loaders[0]), (jexp, jexp.data_loaders[0])


def _options(variant):
    (pexp, pdl), (jexp, jdl) = _loader_cfgs(variant)
    popts = pfactory.object_options_for_variant(variant, pdl, pfactory.load_region_bank(pexp))
    jopts = jfactory.object_options_for_variant(variant, jdl, jfactory.load_region_bank(jexp))
    return popts, jopts


@pytest.mark.parametrize("variant", ["global_local", "region_mem", "baseline"])
def test_object_options_match_oatx(variant):
    popts, jopts = _options(variant)
    for f in dataclasses.fields(popts):
        got, want = getattr(popts, f.name), getattr(jopts, f.name)
        if f.name == "region_memory":
            assert (got is None) == (want is None)
            if want is not None:
                _equal(got.embeddings, want.embeddings)
        else:
            assert got == want, f.name


def _both_datasets(tmp_path, monkeypatch, variant, vocab=None):
    popts, jopts = _options(variant)
    pds = MemoryClips(n=12, frames=2, canon=32, roll=True, object_dir=str(tmp_path),
                      object_options=popts, object_vocab=vocab)
    patch_oatx_decode(monkeypatch, pds)
    return pds, OatxMemoryClips(pds, jopts)


@pytest.mark.parametrize("variant", ["global_local", "region_mem", "baseline"])
def test_add_object_extras_matches_oatx(tmp_path, monkeypatch, variant):
    vocab = ["__background__"] + [f"thing {i}" for i in range(1000)]  # ids ≥ 1000: obj{cid}
    pds, jds = _both_datasets(tmp_path, monkeypatch, variant, vocab)
    for i in range(len(pds)):
        got = pds.get_sample(i, np.random.default_rng((5, i)))
        want = jds.get_sample(i, np.random.default_rng((5, i)))
        assert sorted(got) == sorted(want)
        for k in want:
            if k != "meta":
                _equal(got[k], want[k])
    keys = set(got)
    assert ("object_frame" in keys) == (variant != "baseline")
    assert ("text_region_embedding" in keys) == (variant == "region_mem")
    assert ("pad_text" in keys) == (variant != "region_mem")


@pytest.mark.parametrize("variant", ["global_local", "region_mem"])
def test_collated_batch_matches_oatx(tmp_path, monkeypatch, variant):
    pds, jds = _both_datasets(tmp_path, monkeypatch, variant)
    corpus = pds.captions + [f"obj{i}" for i in range(0, 1600, 7)]
    ptok, jtok = PTok.build_from_corpus(corpus, vocab_size=200), \
        JTok.build_from_corpus(corpus, vocab_size=200)
    plens, jlens = pfactory.tag_token_lens_for(pds, ptok), jfactory.tag_token_lens_for(
        jds.ds, jtok)
    _equal(plens, jlens)
    pcol = PL.Collator(ptok, max_text_len=10, max_pad_text_len=24, tag_token_lens=plens)
    jcol = JL.Collator(jtok, max_text_len=10, max_pad_text_len=24, tag_token_lens=jlens)
    idx = [0, 1, 5, 9]
    got = pcol([pds.get_sample(i, np.random.default_rng(i)) for i in idx])
    want = jcol([jds.get_sample(i, np.random.default_rng(i)) for i in idx])
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "meta":
            _equal(got[k], want[k])
    if variant == "global_local":
        assert "object_token_masks" in got and got["object_token_masks"].max() > 0


def test_object_vocab_and_tag_token_lens_match_oatx(tmp_path):
    path = tmp_path / "objects_vocab.txt"
    path.write_text("Dog,doggy\nTraffic Light\n  cat \nhot dog,hotdog\n")
    raw = {"name": "r", "arch": {"type": "FrozenInTime", "args": {}},
           "data_loader": [{"type": "x", "args": {"object_params": {"vocab_path": str(path)}}}]}
    got = pfactory.load_object_vocab(PExp.from_dict(raw).data_loaders[0])
    assert got == jfactory.load_object_vocab(JExp.from_dict(raw).data_loaders[0])
    assert got == ["__background__", "dog", "traffic light", "cat", "hot dog"]
    assert pfactory.load_object_vocab(PExp.from_dict(_recipe("x")).data_loaders[0]) is None
    corpus = ["a dog near a traffic light", "the cat and a hot dog"]
    ptok, jtok = PTok.build_from_corpus(corpus, vocab_size=60), \
        JTok.build_from_corpus(corpus, vocab_size=60)

    class Named:
        object_vocab = got

    _equal(pfactory.tag_token_lens_for(Named, ptok), jfactory.tag_token_lens_for(Named, jtok))


def test_object_frame_from_a_file_raises_until_the_decode_slice(tmp_path):
    """The decode slice landed: a dataset without video files still raises
    for an object frame; the file-backed TextVideoDataset decodes it (black
    frames when the clip is missing, as oatx)."""
    from oatx_torch.config.schema import DataLoaderCfg
    from oatx_torch.data import video_reader as pvr
    from oatx_torch.data.datasets.base import TextVideoDataset

    class FileBacked(ObjectAwareDataset):
        def _get_object_path(self, rec, frame_index=0):
            return str(tmp_path / "none.npz")

    ds = FileBacked(ObjectOptions(object_frame=True))
    with pytest.raises(NotImplementedError, match="holds no video files"):
        ds._add_object_extras({"text": "t"}, 0, [0], 4, np.random.default_rng(0))

    class Clips(TextVideoDataset):
        def _load_metadata(self):
            self.metadata = ["c0", "missing"]

        def _get_video_path(self, rec):
            return str(tmp_path / f"{rec}.avi"), f"{rec}.avi"

    pvr.write_test_video(str(tmp_path / "c0.avi"), 96, 64, 8, 8, seed=2)
    clips = Clips(DataLoaderCfg(data_dir=str(tmp_path)), canon=32)
    frame = clips._decode_object_frame("c0", 3)
    assert frame.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(
        frame, pvr.decode_indices(str(tmp_path / "c0.avi"), [3], 32)[:, :, 8:40])
    assert not clips._decode_object_frame("missing", 0).any()
    sample = {"text": "t"}
    FileBacked(ObjectOptions())._add_object_extras(sample, 0, [0], 4, np.random.default_rng(0))
    assert sample == {"text": "t"}  # no extras asked for: nothing read


def test_npz_cache_serves_repeat_reads(tmp_path):
    path = str(tmp_path / "a.npz")
    write_object_npz(path, np.random.default_rng(0), 5)
    pobj.set_npz_cache(2)
    try:
        first = pobj.read_object_features(path, 5)
        os.remove(path)
        _equal(pobj.read_object_features(path, 5), first)  # from the cache
        assert not pobj._load_npz(path)[0].flags.writeable
    finally:
        pobj.set_npz_cache(0)
    assert pobj._load_npz(path) is None
