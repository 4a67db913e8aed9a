"""The port's first-party decoder (oatx_torch/native/decode.cpp through
oatx_torch.data.video_reader) against oatx's FFmpeg reader, on the CPU.

Forward: files written by oatx's `write_test_video` (FFmpeg's MJPEG encoder
in an AVI) — 128×96 and 320×240, seeds 0-3 — read by both readers at
short_side 0 / 64 / 256. Reverse: files written by the port's writer (its
own baseline JPEG encoder and AVI muxer) read by both. Probe, out_size and
the frame order read from the index stamp are equal; pixels differ only by
IDCT rounding (the port follows swscale's yuv2rgb tables and its bilinear
filters). Tolerance, per channel value: mean |Δ| ≤ PIX_MEAN and no value
more than PIX_MAX off. Measured on these files: mean ≤ 0.0063 and max 2 at
every size, both directions (the ceiling this port allows is mean 1 at the
native size, 2 after the resize, max 16).

Also: bare JPEG stills (PIL's at 4:2:0 / 4:2:2 / 4:4:4, grayscale, with
restart markers; the port's own), index clamping, media the decoder must
refuse (an mp4 oatx writes, MPEG-4 in an AVI, progressive JPEG) with
UnsupportedMedia, which lax loading lets through, and the cases of oatx's
tests/test_video_reader.py that apply to intra-only media, each on files of
both writers.
"""

import os
import subprocess

import numpy as np
import pytest

from oatx.data import video_reader as jvr
from oatx_torch.data import video_reader as pvr

PIX_MEAN = 0.05
PIX_MAX = 4
SIZES = [(128, 96), (320, 240)]
SEEDS = [0, 1, 2, 3]
FRAMES = 12


def close(got, want, mean=PIX_MEAN, mx=PIX_MAX):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.mean() <= mean and d.max() <= mx, (float(d.mean()), int(d.max()))


def stamps(frames):
    """Mean of each frame's index stamp (top-left 8×8 luma block)."""
    return [float(f[2:6, 2:6, 1].mean()) for f in frames]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    out = {}
    for w, h in SIZES:
        for seed in SEEDS:
            j = str(root / f"oatx_{w}_{seed}.avi")
            p = str(root / f"port_{w}_{seed}.avi")
            jvr.write_test_video(j, w, h, FRAMES, 8, seed=seed)
            pvr.write_test_video(p, w, h, FRAMES, 8, seed=seed)
            out[(w, seed)] = {"oatx": j, "port": p}
    return out


@pytest.mark.parametrize("writer", ["oatx", "port"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_decoder_matches_oatx_reader(clips, writer, size, seed):
    path = clips[(size[0], seed)][writer]
    assert pvr.probe(path) == jvr.probe(path) == (FRAMES, 8.0, *size)
    idx = [0, 5, FRAMES - 1, 3, 40]
    for ss in (0, 64, 256):
        with pvr.VideoHandle(path) as ph, jvr.VideoHandle(path) as jh:
            assert ph.out_size(ss) == jh.out_size(ss)
            assert ph.info() == jh.info()
        close(pvr.decode_indices(path, idx, ss), jvr.decode_indices(path, idx, ss))
    full_p = pvr.decode_indices(path, list(range(FRAMES)))
    full_j = jvr.decode_indices(path, list(range(FRAMES)))
    sp, sj = stamps(full_p), stamps(full_j)
    assert np.argsort(sp, kind="stable").tolist() == np.argsort(sj, kind="stable").tolist() \
        == list(range(FRAMES))
    assert all(b - a > 3.0 for a, b in zip(sp, sp[1:]))


def _pil_still(path, subsampling=2, gray=False, **kw):
    from PIL import Image

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:300, 0:400]
    img = np.stack([(xx * 0.6) % 256, (yy * 0.8) % 256, (xx + yy) * 0.3 % 256], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    im = Image.fromarray(img[..., 0] if gray else img)
    im.save(path, format="JPEG", quality=90,
            **({} if gray else {"subsampling": subsampling}), **kw)


@pytest.mark.parametrize("kind", ["420", "422", "444", "gray", "restart", "port"])
def test_jpeg_still_matches_oatx_reader(tmp_path, kind):
    """Bare JPEG stills: one frame at 25 fps (as FFmpeg's image demuxer
    says), under a name that does not say JPEG (content is sniffed).
    4:4:4 and gray take other swscale paths than the 4:2:0 clips (full
    chroma, gray → RGB): measured mean 0.35 / 0.55 and max 4 at 4:4:4."""
    path = str(tmp_path / "still.bin")
    if kind == "port":
        pvr.write_test_image(path, 400, 300, seed=5)
    elif kind == "restart":
        _pil_still(path, restart_marker_blocks=3)
    else:
        _pil_still(path, subsampling={"420": 2, "422": 1, "444": 0}.get(kind, 2),
                   gray=kind == "gray")
    if kind == "restart":
        assert b"\xff\xdd" in open(path, "rb").read()  # a DRI segment
    assert pvr.probe(path) == jvr.probe(path) == (1, 25.0, 400, 300)
    loose = kind in ("444", "gray")
    for ss in (0, 256):
        close(pvr.decode_indices(path, [0, 3], ss), jvr.decode_indices(path, [0, 3], ss),
              mean=0.6 if loose else PIX_MEAN)


def test_decode_jpeg_bytes_matches_the_file_path(tmp_path):
    path = str(tmp_path / "s.jpg")
    _pil_still(path)
    data = open(path, "rb").read()
    np.testing.assert_array_equal(pvr.decode_jpeg_bytes(data), pvr.decode_indices(path, [0])[0])
    with pytest.raises(pvr.DecodeError):
        pvr.decode_jpeg_bytes(b"not a jpeg")


def test_unsupported_media_is_not_a_lax_error():
    for base in (pvr.DecodeError, OSError, AssertionError):
        assert not issubclass(pvr.UnsupportedMedia, base)


@pytest.mark.parametrize("media", ["mp4", "mpeg4_avi", "progressive", "codec"])
def test_unsupported_media_raises(tmp_path, media):
    path = str(tmp_path / "clip.mp4")
    if media == "mp4":
        jvr.write_test_video(path, 128, 96, 8, 8, seed=1, codec="mpeg4")
    elif media == "mpeg4_avi":
        path = str(tmp_path / "clip.avi")
        jvr.write_test_video(path, 128, 96, 8, 8, seed=1, codec="mpeg4")
    elif media == "progressive":
        _pil_still(path, progressive=True)
    else:
        with pytest.raises(pvr.UnsupportedMedia):
            pvr.write_test_video(path, 128, 96, 8, 8, codec="libx264")
        return
    with pytest.raises(pvr.UnsupportedMedia):
        pvr.probe(path)
    with pytest.raises(pvr.UnsupportedMedia):
        pvr.decode_indices(path, [0])


def test_lax_dataset_lets_unsupported_media_through(tmp_path):
    """A lax WebVid whose clip is an mp4 raises UnsupportedMedia instead of
    training on substitute clips."""
    from oatx_torch.config.schema import DataLoaderCfg
    from oatx_torch.data.factory import build_dataset

    (tmp_path / "meta_data").mkdir()
    (tmp_path / "train").mkdir()
    jvr.write_test_video(str(tmp_path / "train" / "v0.mp4"), 128, 96, 8, 8, codec="mpeg4")
    pvr.write_test_video(str(tmp_path / "train" / "v1.mp4"), 128, 96, 8, 8)
    (tmp_path / "meta_data" / "webvid_training_success_full.tsv").write_text(
        "caption\tvideoid\nan mp4\tv0\nan mjpeg avi\tv1\n")
    cfg = DataLoaderCfg(dataset_name="WebVid", data_dir=str(tmp_path), split="train",
                        video_params={"num_frames": 2, "loading": "lax"})
    ds = build_dataset(cfg, "baseline", "train")
    assert ds.get_sample(1, np.random.default_rng(0))["video"].shape == (2, 256, 256, 3)
    with pytest.raises(pvr.UnsupportedMedia):
        ds.get_sample(0, np.random.default_rng(0))


def test_library_links_only_the_cxx_runtime():
    pvr.native_version()
    out = subprocess.run(["ldd", str(pvr.library_path())], capture_output=True,
                         text=True).stdout
    for lib in ("libav", "libswscale", "libjpeg", "libpng", "libturbojpeg"):
        assert lib not in out, out


# ------------------------------------- oatx's test_video_reader.py, intra-only

@pytest.fixture(scope="module", params=["oatx", "port"])
def clip(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "clip.avi")
    writer = jvr if request.param == "oatx" else pvr
    writer.write_test_video(path, width=128, height=96, num_frames=32, fps=8, seed=3)
    return path


@pytest.fixture(scope="module")
def full(clip):
    return pvr.decode_indices(clip, list(range(32)))


def test_probe_and_out_size(clip):
    n, fps, w, h = pvr.probe(clip)
    assert (n, w, h) == (32, 128, 96)
    assert fps == pytest.approx(8.0)


def test_full_decode_is_index_aligned(full):
    st = stamps(full[:30])
    assert all(b - a > 3.0 for a, b in zip(st, st[1:]))


def test_decode_exact_indices(clip, full):
    idxs = [0, 5, 17, 31]
    frames = pvr.decode_indices(clip, idxs)
    assert frames.shape == (4, 96, 128, 3) and frames.dtype == np.uint8
    for got, i in zip(frames, idxs):
        assert np.array_equal(got, full[i]), i


def test_decode_unsorted_and_duplicate_indices(clip, full):
    idxs = [20, 3, 20, 0]
    for got, i in zip(pvr.decode_indices(clip, idxs), idxs):
        assert np.array_equal(got, full[i]), i


def test_out_of_range_lax_fills_last_frame(clip, full):
    frames = pvr.decode_indices(clip, [2, 100])
    assert np.array_equal(frames[0], full[2])
    assert np.array_equal(frames[1], full[31])
    only_oor = pvr.decode_indices(clip, [500, 501])
    assert np.array_equal(only_oor[0], full[31]) and np.array_equal(only_oor[1], full[31])


def test_short_side_resize_geometry(clip):
    assert pvr.decode_indices(clip, [1], short_side=64).shape == (1, 64, 84, 3)


def test_handle_reuse_and_parity_with_path_api(clip):
    idxs = [4, 9, 9, 27, 100]
    via_path = pvr.decode_indices(clip, idxs, short_side=64)
    with pvr.VideoHandle(clip) as h:
        n, fps, w, hh = h.info()
        assert (n, w, hh) == (32, 128, 96)
        assert h.out_size(64) == (84, 64)
        first = h.decode(idxs, short_side=64)
        second = h.decode(idxs, short_side=64)
        native_size = h.decode([0])
    assert np.array_equal(via_path, first) and np.array_equal(first, second)
    assert native_size.shape == (1, 96, 128, 3)


def test_read_frames_roundtrip(clip):
    frames, idxs, vlen = pvr.read_frames(clip, 4, sample="uniform", short_side=64)
    assert vlen == 32 and len(idxs) == 4
    assert np.array_equal(frames, pvr.decode_indices(clip, idxs, short_side=64))


@pytest.mark.parametrize("writer", ["oatx", "port"])
def test_single_frame_clip_decodes(tmp_path, writer):
    p = str(tmp_path / "one.avi")
    (jvr if writer == "oatx" else pvr).write_test_video(p, 128, 96, 1, fps=8, seed=1)
    frames = pvr.decode_indices(p, [0, 5])
    assert frames.shape == (2, 96, 128, 3) and np.array_equal(frames[0], frames[1])


@pytest.mark.parametrize("writer", ["oatx", "port"])
def test_fuzz_random_geometry_and_indices(tmp_path, writer):
    """Random geometry / fps / index sets must match the clamped-index oracle
    byte-exactly (oatx's fuzz, MJPEG trials)."""
    rng = np.random.default_rng(7)
    mod = jvr if writer == "oatx" else pvr
    for trial in range(6):
        nf = int(rng.integers(1, 40))
        w, h = int(rng.integers(3, 12)) * 16, int(rng.integers(3, 10)) * 16
        p = str(tmp_path / f"f{trial}.avi")
        mod.write_test_video(p, w, h, nf, fps=int(rng.integers(5, 31)), seed=trial)
        full = pvr.decode_indices(p, list(range(nf)))
        assert full.shape == (nf, h, w, 3)
        for _ in range(3):
            idxs = rng.integers(0, nf + 20, int(rng.integers(1, 9))).tolist()
            assert np.array_equal(pvr.decode_indices(p, idxs),
                                  full[[min(i, nf - 1) for i in idxs]]), (nf, idxs)


def test_open_missing_file_raises(tmp_path):
    with pytest.raises(pvr.DecodeError):
        pvr.probe(str(tmp_path / "nope.avi"))
    with pytest.raises(pvr.DecodeError):
        pvr.VideoHandle(str(tmp_path / "nope.avi"))
    empty = tmp_path / "empty.avi"
    empty.write_bytes(b"")
    with pytest.raises(pvr.DecodeError):
        pvr.probe(str(empty))


def test_transcode_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        pvr.transcode(str(tmp_path / "a.mp4"), str(tmp_path / "b.avi"))
