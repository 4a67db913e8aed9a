"""Concrete dataset adapters (port of oatx/data/datasets/adapters.py; the
metadata formats are the reference's data_loader/*_dataset.py readers', so
existing dataset downloads drop in).

Registered under the names the JSON configs use (config.registry.DATASETS).
TSV metadata is read with the csv module where oatx uses pandas.read_csv
and `str()`s each cell, and gives the same text: the header row and blank
lines are skipped, columns are taken by position, a missing cell or one of
pandas' NA tokens reads as "nan", and each column is typed as pandas' C
parser types it (integers "007" → "7", floats "1.50" → "1.5", an integer
column with a gap as floats "123" → "123.0", booleans "TRUE" → "True").
A row wider than the header raises. Where they still differ: integers
outside int64 beside a negative number or a gap (pandas keeps their text),
numbers of more than 17 significant digits in a float column (pandas'
default parser may land an ulp away; this reader rounds correctly), and
files large enough that pandas types them chunk by chunk.
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import List

import numpy as np

from oatx_torch.config.registry import DATASETS
from oatx_torch.data import video_reader as vr
from oatx_torch.data.datasets.base import (TextImageDataset, TextImageTarDataset,
                                           TextVideoDataset)


_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*", re.ASCII)
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:e[+-]?\d+)?|inf|infinity)\s*",
                    re.ASCII | re.IGNORECASE)
_BOOL = {"True": "True", "TRUE": "True", "true": "True",
         "False": "False", "FALSE": "False", "false": "False"}


def _column_text(cells: List[str]) -> List[str]:
    """One column's cells as `str()` of the values pandas infers for it:
    int64 (or uint64) if every cell is an integer, float64 if every cell
    that is not NA is a number, bool if every such cell is a boolean, else
    the text."""
    vals = [c for c in cells if c not in _NA]
    ints = vals and all(_INT.fullmatch(c) and -2 ** 63 <= int(c) < 2 ** 63 for c in vals)
    uints = vals and all(_INT.fullmatch(c) and 0 <= int(c) < 2 ** 64 for c in vals)
    if (ints or uints) and len(vals) == len(cells):
        conv = lambda c: str(int(c))  # noqa: E731
    elif ints:  # int64 with a gap: pandas casts the integers ("-0" → "0.0")
        conv = lambda c: str(float(int(c)))  # noqa: E731
    elif all(_FLOAT.fullmatch(c) for c in vals):
        conv = lambda c: str(float(c))  # noqa: E731
    elif vals and all(c in _BOOL for c in vals):
        conv = _BOOL.__getitem__
    else:
        conv = str
    return ["nan" if c in _NA else conv(c) for c in cells]


def _read_tsv(path: str) -> List[List[str]]:
    """A tab-separated table → its rows after the header, each cell the text
    `str()` gives of pandas.read_csv(path, sep="\\t")'s value for it."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t")
                if len(r) > 1 or (r and r[0].strip())]
    if len(rows) < 2:
        return []
    width = len(rows[0])
    body = rows[1:]
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: data row {i + 1} has {len(r)} fields, the header "
                             f"{width}")
    cols = [_column_text([r[j] if j < len(r) else "" for r in body]) for j in range(width)]
    return [list(r) for r in zip(*cols)]


@DATASETS.register("WebVid")
class WebVid(TextVideoDataset):
    """WebVid-2.5M: TSV metadata (caption, videoid), videos/<split>/<id>.mp4
    (reference data_loader/WebVid_dataset.py:9-65)."""

    SPLIT_FILES = {
        "train": "webvid_training_success_full.tsv",
        "val": "webvid_validation_success_full.tsv",
        "test": "webvid_validation_success_full.tsv",
    }

    def _load_metadata(self):
        fp = os.path.join(self.metadata_dir, "meta_data", self.SPLIT_FILES[self.split])
        rows = _read_tsv(fp)
        self.metadata = [
            {"caption": str(r[0]), "videoid": str(r[1])}
            for r in rows
        ]

    def _get_video_path(self, rec):
        rel = rec["videoid"] + ".mp4"
        return os.path.join(self.data_dir, self.split, rel), rel

    def _get_caption(self, rec, rng):
        return rec["caption"]

    def _get_object_path(self, rec, frame_index: int = 0):
        return os.path.join(self.object_dir, self.split, rec["videoid"], f"{frame_index}.npz")


@DATASETS.register("ConceptualCaptions3M")
class ConceptualCaptions3M(TextImageDataset):
    """CC3M image-text (1-frame path): TSV (caption, file), training/ or
    validation/ subdirs (reference ConceptualCaptions_dataset.py:7-56)."""

    SPLIT_FILES = {
        "train": "cc3m_training_success_full.tsv",
        "val": "cc3m_validation_success_full.tsv",
        "test": "cc3m_validation_success_full.tsv",
    }

    def _load_metadata(self):
        fp = os.path.join(self.metadata_dir, "meta_data", self.SPLIT_FILES[self.split])
        rows = _read_tsv(fp)
        self.metadata = [
            {"caption": str(r[0]), "file": str(r[1])}
            for r in rows
        ]

    def _get_video_path(self, rec):
        rel_dir = "training" if self.split == "train" else "validation"
        rel = os.path.join(rel_dir, rec["file"])
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, rec, rng):
        return rec["caption"]

    def _get_object_path(self, rec, frame_index: int = 0):
        return os.path.join(self.object_dir, self.split, rec["file"], "1.npz")


@DATASETS.register("ConceptualCaptions3MTar")
class ConceptualCaptions3MTar(TextImageTarDataset):
    """CC3M packed in tar shards: TSV (caption, '<shard>.tar/<member>') under
    meta_data/cc3m_tar_<split>.tsv, shards under data_dir."""

    SPLIT_FILES = {"train": "cc3m_tar_train.tsv", "val": "cc3m_tar_val.tsv",
                   "test": "cc3m_tar_val.tsv"}

    def _load_metadata(self):
        fp = os.path.join(self.metadata_dir, "meta_data", self.SPLIT_FILES[self.split])
        rows = _read_tsv(fp)
        self.metadata = [
            {"caption": str(r[0]), "member": str(r[1])}
            for r in rows
        ]

    def _get_video_path(self, rec):
        return os.path.join(self.data_dir, rec["member"]), rec["member"]

    def _get_caption(self, rec, rng):
        return rec["caption"]


@DATASETS.register("MSRVTT")
class MSRVTT(TextVideoDataset):
    """MSR-VTT with miech/jsfusion/full-val/full-test/challenge cuts
    (reference MSRVTT_dataset.py:10-88). Train: random caption per epoch;
    eval: first caption (jsfusion: the designated caption index)."""

    def _load_metadata(self):
        ann = os.path.join(self.metadata_dir, "annotation", "MSR_VTT.json")
        with open(ann) as f:
            data = json.load(f)
        caps_by_vid = {}
        for a in data["annotations"]:
            caps_by_vid.setdefault(a["image_id"], []).append(a["caption"])

        split_dir = os.path.join(self.metadata_dir, "high-quality", "structured-symlinks")
        cut = self.cut or "jsfusion"
        js_cap_idx = None
        if cut == "miech":
            train_list, test_list = "train_list_miech.txt", "test_list_miech.txt"
        elif cut == "jsfusion":
            train_list, test_list = "train_list_jsfusion.txt", "val_list_jsfusion.txt"
            js_cap_idx = "jsfusion_val_caption_idx.pkl"
        elif cut in ("full-val", "full-test"):
            train_list = "train_list_full.txt"
            test_list = "val_list_full.txt" if cut == "full-val" else "test_list_full.txt"
        elif cut in ("val", "public_server_val", "public_server_test"):
            train_list = "train_list.txt"
            test_list = f"{cut}_list.txt" if cut == "val" else f"{cut}.txt"
        else:
            raise ValueError(f"unrecognised MSRVTT cut: {cut}")

        def read_list(name):
            with open(os.path.join(split_dir, name)) as f:
                return [l.strip() for l in f if l.strip()]

        vids = read_list(train_list if self.split == "train" else test_list)
        cap_idx = None
        if js_cap_idx is not None and self.split != "train":
            import pickle

            with open(os.path.join(split_dir, js_cap_idx), "rb") as f:
                cap_idx = pickle.load(f)

        self.metadata = []
        for v in vids:
            caps = caps_by_vid.get(v, [""])
            if cap_idx is not None:
                # keep only the designated eval caption
                ci = cap_idx[v] if isinstance(cap_idx, dict) else cap_idx[len(self.metadata)]
                caps = [caps[int(ci)]]
            self.metadata.append({"videoid": v, "captions": caps})

    def _get_video_path(self, rec):
        rel = rec["videoid"] + ".mp4"
        return os.path.join(self.data_dir, "videos", "all", rel), rel

    def _get_caption(self, rec, rng):
        caps = rec["captions"]
        if self.split in ("train", "val") and self.text_params.get("caption_sample", "rand") == "rand":
            return caps[int(rng.integers(0, len(caps)))]
        return caps[0]

    def _get_object_path(self, rec, frame_index: int = 0):
        return os.path.join(self.object_dir, rec["videoid"], f"{frame_index}.npz")


@DATASETS.register("MSVD")
class MSVD(TextVideoDataset):
    """MSVD: TSV (captions comma-joined, videoid), <id>.avi
    (reference MSVD_dataset.py)."""

    SPLIT_FILES = {"train": "MSVD_train.tsv", "val": "MSVD_test.tsv", "test": "MSVD_test.tsv"}

    def _load_metadata(self):
        fp = os.path.join(self.metadata_dir, "meta_data", self.SPLIT_FILES[self.split])
        rows = _read_tsv(fp)
        self.metadata = [
            {"captions": str(r[0]).split(","), "videoid": str(r[1])}
            for r in rows
        ]

    def _get_video_path(self, rec):
        rel = rec["videoid"] + ".avi"
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, rec, rng):
        caps = rec["captions"]
        if self.split == "train":
            return caps[int(rng.integers(0, len(caps)))]
        return caps[0]


@DATASETS.register("DiDeMo")
class DiDeMo(TextVideoDataset):
    """DiDeMo: TSV (caption, relpath) (reference DiDeMo_dataset.py)."""

    SPLIT_FILES = {"train": "DiDeMo_train.tsv", "val": "DiDeMo_val.tsv", "test": "DiDeMo_test.tsv"}

    def _load_metadata(self):
        fp = os.path.join(self.metadata_dir, "meta_data", self.SPLIT_FILES[self.split])
        rows = _read_tsv(fp)
        self.metadata = [
            {"caption": str(r[0]), "videoid": str(r[1])}
            for r in rows
        ]

    def _get_video_path(self, rec):
        rel = rec["videoid"]
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, rec, rng):
        return rec["caption"]

    def _get_object_path(self, rec, frame_index: int = 0):
        return os.path.join(self.object_dir, self.split, rec["videoid"], "1.npz")


@DATASETS.register("LSMDC")
class LSMDC(TextVideoDataset):
    """LSMDC: structured-symlinks/{split}_list.txt + raw-captions.pkl (dict
    videoid → list of token-lists) + frame_tar_list.txt mapping ids to their
    videos/<movie>/<stem>.avi locations (reference LSMDC_dataset.py:8-49).
    When frame_tar_list.txt is absent, falls back to flat <id>.avi files."""

    def _load_metadata(self):
        import pickle

        sdir = os.path.join(self.metadata_dir, "structured-symlinks")
        with open(os.path.join(sdir, f"{self.split}_list.txt")) as f:
            vids = [l.strip() for l in f if l.strip()]
        with open(os.path.join(sdir, "raw-captions.pkl"), "rb") as f:
            captions = pickle.load(f)

        # reference LSMDC_dataset.py:29-37: frame_tar_list.txt rows are paths
        # whose last two components give '<movie_dir>/<vid_stem>.tar'; videos
        # live at data_dir/videos/<movie_dir>/<vid_stem>.avi
        fn_by_stem = {}
        tar_list = os.path.join(self.metadata_dir, "frame_tar_list.txt")
        if os.path.exists(tar_list):
            with open(tar_list) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    fn = "/".join(line.split("/")[-2:]).replace(".tar", "")
                    fn_by_stem[fn.split("/")[-1]] = fn

        self.metadata = []
        for v in vids:
            caps = captions.get(v)
            if caps is None:
                continue
            texts = [" ".join(c) if isinstance(c, (list, tuple)) else str(c)
                     for c in caps if c is not None]
            self.metadata.append({"videoid": v, "captions": texts,
                                  "fn": fn_by_stem.get(v)})

    def _get_video_path(self, rec):
        if rec.get("fn"):
            rel = os.path.join("videos", rec["fn"] + ".avi")
        else:
            rel = rec["videoid"] + ".avi"
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, rec, rng):
        caps = rec["captions"]
        if self.split == "train":
            return caps[int(rng.integers(0, len(caps)))]
        return caps[0]


@DATASETS.register("LSMDC_choice")
class LSMDCChoice(LSMDC):
    """LSMDC multiple-choice eval variant.

    UPSTREAM VERDICT: the reference's LSMDC_choice_dataset.py is a verbatim
    copy of the plain LSMDC dataset — it never loads candidate captions, so
    the multiple-choice task cannot actually run there. oatx's working design:
    candidates come from `structured-symlinks/multiple_choice_{split}.tsv`
    (tab-separated: videoid, answer index, candidate captions — the public
    LSMDC-MC annotation reshaped one-line-per-clip); records without an
    annotation fall back to candidate sets built from OTHER clips' captions
    as distractors (deterministic per index) so the reported accuracy is
    still a real discrimination task; a one-time warning fires whenever the
    TSV is absent, since these are not the official LSMDC-MC candidates."""

    is_multiple_choice = True

    def _load_metadata(self):
        super()._load_metadata()
        import csv

        mc_path = os.path.join(self.metadata_dir, "structured-symlinks",
                               f"multiple_choice_{self.split}.tsv")
        table = {}
        self._mc_table_found = os.path.exists(mc_path)
        if self._mc_table_found:
            with open(mc_path) as f:
                for row in csv.reader(f, delimiter="\t"):
                    if len(row) >= 3:
                        table[row[0]] = (int(row[1]), row[2:])
        self._mc_warned = False
        for rec in self.metadata:
            if rec["videoid"] in table:
                rec["answer"], rec["choices"] = table[rec["videoid"]]

    def get_sample(self, index, rng=None, _depth=0):
        s = super().get_sample(index, rng, _depth)
        i = index % len(self.metadata)
        rec = self.metadata[i]
        if "choices" in rec:
            choices, answer = rec["choices"], rec["answer"]
        else:
            if not self._mc_warned:
                import logging

                logging.getLogger("oatx_torch.data").warning(
                    "LSMDC_choice: no multiple_choice_%s.tsv — building "
                    "fallback candidate sets from other clips' captions "
                    "(deterministic); accuracy is NOT the official LSMDC-MC "
                    "number", self.split)
                self._mc_warned = True
            # 4 distractors from other clips, deterministic in index (prime
            # stride keeps nearby clips from sharing candidate sets); the true
            # caption lands at a per-index position so answer isn't constant
            n = len(self.metadata)
            distract = []
            k = 1
            while len(distract) < 4 and k < max(n, 5):
                j = (i + 17 * k) % n
                if j != i:
                    cap = self.metadata[j]["captions"][0]
                    if cap != s["text"] and cap not in distract:
                        distract.append(cap)
                k += 1
            answer = i % (len(distract) + 1)
            choices = distract[:answer] + [s["text"]] + distract[answer:]
        s["meta"]["choices"] = choices
        s["meta"]["answer"] = answer
        return s


@DATASETS.register("SyntheticVideoText")
class SyntheticVideoText(TextVideoDataset):
    """Hermetic synthetic dataset: generates fixture clips + captions (and
    optional object npzs) under data_dir on first use. For tests, demos, and
    pipeline benchmarks — no downloads. Clips are MJPEG/AVI by default;
    the port's writer codes MJPEG only (another video_params.fixture_codec
    raises UnsupportedMedia)."""

    def _load_metadata(self):
        n = int(self.video_params.get("num_videos", 16))
        # fixture geometry overridable for realistic-decode benchmarks
        # (tools/bench_train_e2e.py uses WebVid-like 320x240, 64 frames)
        fw = int(self.video_params.get("fixture_width", 128))
        fh = int(self.video_params.get("fixture_height", 96))
        ff = int(self.video_params.get("fixture_frames", 0))
        # oatx's fixture_codec 'libx264'/'mpeg4' writes inter-coded mp4; the
        # port's writer raises UnsupportedMedia for them
        codec = str(self.video_params.get("fixture_codec", "mjpeg"))
        gop = int(self.video_params.get("fixture_gop", 0))
        fps = int(self.video_params.get("fixture_fps", 8))
        # fixture_seeded: give clip i the visual signature seed=i (pattern
        # frequency/phase + chroma, video_reader.write_test_video) so the
        # corpus is SEPARABLE — caption i is identifiable from pixels alone.
        # Default off: the historical fixtures are deliberately identical
        # (pipeline tests want content-independent invariants). The
        # learnability proof (tests/test_learnability.py) turns it on.
        seeded = bool(self.video_params.get("fixture_seeded", False))
        ext = ".avi" if codec == "mjpeg" else ".mp4"
        self._fixture_ext = ext
        os.makedirs(self.data_dir, exist_ok=True)
        nouns = ["dog", "cat", "car", "tree", "person", "bird", "boat", "horse"]
        verbs = ["runs", "jumps", "sits", "moves", "plays", "stands"]
        self.metadata = []
        for i in range(n):
            vid = f"clip{i:04d}"
            path = os.path.join(self.data_dir, vid + ext)
            if not os.path.exists(path):
                vr.write_test_video(path, fw, fh, ff or 24 + (i % 3) * 8, fps,
                                    seed=i if seeded else 0,
                                    codec=codec, gop=gop)
            cap = f"a {nouns[i % len(nouns)]} {verbs[i % len(verbs)]} in scene {i}"
            self.metadata.append({"videoid": vid, "caption": cap})
            if self.object_dir:
                odir = os.path.join(self.object_dir, vid)
                os.makedirs(odir, exist_ok=True)
                for slot in range(self.opts.extraction_frames):
                    ofp = os.path.join(odir, f"{slot}.npz")
                    if not os.path.exists(ofp):
                        k = 6
                        feats = np.abs(np.random.default_rng((i, slot)).standard_normal((k, 2048))).astype(np.float32)
                        boxes = np.array([[4, 4, 60, 50]] * k, np.float32) + \
                            np.random.default_rng((i, slot, 1)).uniform(0, 30, (k, 4)).astype(np.float32)
                        info = {"objects_id": np.arange(k) + (i % 50),
                                "objects_conf": np.linspace(0.9, 0.3, k).astype(np.float32),
                                "image_w": 128, "image_h": 96}
                        np.savez(ofp, x=feats, bbox=boxes, info=info)

    def _get_video_path(self, rec):
        rel = rec["videoid"] + getattr(self, "_fixture_ext", ".avi")
        return os.path.join(self.data_dir, rel), rel

    def _get_caption(self, rec, rng):
        return rec["caption"]

    def _get_object_path(self, rec, frame_index: int = 0):
        return os.path.join(self.object_dir, rec["videoid"], f"{frame_index}.npz")
