"""The port's H.264-in-mp4 path on the CPU, against oatx's FFmpeg reader.

The port's own decoder (native/h264.h) is held against oatx in
tests/test_torch_h264.py; what runs here is every piece around it:

* the ISO BMFF demuxer (native/mp4.cpp): `probe` / `out_size` equal oatx's
  on clips oatx writes at 128×96, 320×240 and 596×336, keyframe intervals
  1 / 4 / 12 / 25, with B-frames (`transcode` to libx264: High profile,
  `ctts`, an edit list) and without (`write_test_video(codec="libx264")`:
  Constrained Baseline); fps to 1e-9; and the same clip rewritten with
  `moov` first, a 64-bit `mdat` size, `size == 0` and `co64` gives the same
  probe and the same bitstream;
* the frame plan and the Annex B stream NVDEC receives: each segment,
  written to a `.h264` file and decoded by oatx's reader, gives frames
  bitwise equal to oatx's decode of the mp4 at the wanted indices (all,
  sampled, past the end), and the index stamps agree;
* the NV12 → RGB arithmetic (`nv12_rgb.nv12_to_rgb_plain`, the card
  kernel's plain version), fed the exact planes of an uncompressed yuv420p
  clip (oatx's `write_test_video(codec="rawvideo")`, I420 in an AVI, the
  test pattern and uniform noise), against oatx's reading of that clip at
  short sides 0 / 64 / 224 / 256 within the reader test's PIX_MEAN /
  PIX_MAX (measured: equal, bitwise);
* the committed fixtures (tests/torch_h264/) against a fresh decode by
  oatx, bitwise;
* decoding H.264 without a card raises unless the caller names the CPU;
  other codecs in mp4 raise UnsupportedMedia naming the codec.
"""

import hashlib
import os
import struct

import numpy as np
import pytest

from oatx.data import video_reader as jvr
from oatx_torch.data import video_reader as pvr
from oatx_torch.ops.kernels import nv12_rgb

PIX_MEAN = 0.05  # tests/test_torch_video_reader.py:32-33
PIX_MAX = 4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_h264")
SIZES = [(128, 96), (320, 240), (596, 336)]
GOPS = [1, 4, 12, 25]
FRAMES = 26


def close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.mean() <= PIX_MEAN and d.max() <= PIX_MAX, (float(d.mean()), int(d.max()))


def stamps(frames):
    """The index stamp (top-left 8×8 luma block: 16 + 8·i) of each frame."""
    return [float(f[2:6, 2:6, 1].mean()) for f in frames]


def write_h264(path, size, gop, bframes, frames=FRAMES, seed=1):
    """An H.264 mp4 by oatx: libx264 through `transcode` (High, B-frames) or
    through `write_test_video` (Constrained Baseline, none)."""
    w, h = size
    if bframes:
        src = path + ".avi"
        jvr.write_test_video(src, w, h, frames, 25, seed=seed)
        jvr.transcode(src, path, "libx264", gop=gop)
        os.remove(src)
    else:
        jvr.write_test_video(path, w, h, frames, 8, seed=seed, codec="libx264", gop=gop)
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("h264")
    return {(w, gop, b): write_h264(str(root / f"c{w}_{gop}_{int(b)}.mp4"), (w, h), gop, b)
            for w, h in SIZES for gop in GOPS for b in (False, True)}


# ------------------------------------------------------------------ demuxer

@pytest.mark.parametrize("bframes", [False, True], ids=["baseline", "bframes"])
@pytest.mark.parametrize("gop", GOPS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_probe_matches_oatx(clips, size, gop, bframes):
    path = clips[(size[0], gop, bframes)]
    n, fps, w, h = pvr.probe(path)
    jn, jfps, jw, jh = jvr.probe(path)
    assert (n, w, h) == (jn, jw, jh) == (FRAMES, *size)
    assert abs(fps - jfps) <= 1e-9
    with pvr.VideoHandle(path) as ph, jvr.VideoHandle(path) as jh_:
        assert ph.is_h264
        assert ph.info() == (n, fps, w, h)
        for ss in (0, 64, 224, 256):
            assert ph.out_size(ss) == jh_.out_size(ss)
        coded_w, coded_h, full_range, profile = ph.h264_info()
    assert (coded_w, coded_h) == (-(-w // 16) * 16, -(-h // 16) * 16)
    assert not full_range and profile == (100 if bframes else 66)


def _boxes(data, start=0, end=None):
    """Top-level (type, offset, header size, size) of an ISO BMFF byte string."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos + 8 <= end:
        size, typ = struct.unpack(">I4s", data[pos:pos + 8])
        hdr = 8
        if size == 1:
            size, hdr = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        out.append((typ.decode(), pos, hdr, size))
        pos += size
    return out


def _find(data, path):
    """(offset, size) of the box at `path` (types, outer to inner)."""
    start, end = 0, len(data)
    for typ in path:
        typ_, pos, hdr, size = next(b for b in _boxes(data, start, end) if b[0] == typ)
        start, end = pos + hdr, pos + size
    return start - hdr, end - (start - hdr)


def rewrite(src, dst, moov_first=False, large_mdat=False, co64=False, mdat_to_end=False):
    """The same clip in another legal layout: `moov` before `mdat`, a
    64-bit `mdat` size, chunk offsets as `co64`, or an `mdat` of size 0
    (to the end of the file, `moov` first)."""
    data = open(src, "rb").read()
    top = {b[0]: b for b in _boxes(data)}
    _, mpos, mhdr, msize = top["mdat"]
    _, vpos, _, vsize = top["moov"]
    moov = bytearray(data[vpos:vpos + vsize])
    payload = data[mpos + mhdr:mpos + msize]
    head = data[:min(mpos, vpos)]
    if co64:
        stbl = ["moov", "trak", "mdia", "minf", "stbl"]
        so, ssize = _find(bytes(moov), stbl + ["stco"])
        count = struct.unpack(">I", moov[so + 12:so + 16])[0]
        offs = struct.unpack(f">{count}I", moov[so + 16:so + 16 + 4 * count])
        box = struct.pack(">I4sII", 16 + 8 * count, b"co64", 0, count) + \
            struct.pack(f">{count}Q", *offs)
        parents = [_find(bytes(moov), stbl[:k])[0] for k in range(1, len(stbl) + 1)]
        moov[so:so + ssize] = box
        for at in parents:  # each container grows by the difference
            struct.pack_into(">I", moov, at,
                             struct.unpack(">I", moov[at:at + 4])[0] + len(box) - ssize)
    mdat_hdr = struct.pack(">I4sQ", 1, b"mdat", 16 + len(payload)) if large_mdat else \
        struct.pack(">I4s", 0 if mdat_to_end else 8 + len(payload), b"mdat")
    if moov_first or mdat_to_end:
        new_mdat_payload = len(head) + len(moov) + len(mdat_hdr)
    else:
        new_mdat_payload = len(head) + len(mdat_hdr)
    shift = new_mdat_payload - (mpos + mhdr)
    name = "co64" if co64 else "stco"
    so, _ = _find(bytes(moov), ["moov", "trak", "mdia", "minf", "stbl", name])
    count = struct.unpack(">I", moov[so + 12:so + 16])[0]
    width = 8 if co64 else 4
    fmt = ">Q" if co64 else ">I"
    for i in range(count):
        at = so + 16 + width * i
        struct.pack_into(fmt, moov, at, struct.unpack(fmt, moov[at:at + width])[0] + shift)
    if moov_first or mdat_to_end:
        out = head + bytes(moov) + mdat_hdr + payload
    else:
        out = head + mdat_hdr + payload + bytes(moov)
    with open(dst, "wb") as f:
        f.write(out)
    return dst


@pytest.mark.parametrize("layout", ["moov_first", "large_mdat", "co64", "mdat_to_end"])
def test_demuxer_reads_every_box_layout(clips, tmp_path, layout):
    src = clips[(596, 12, True)]
    dst = rewrite(src, str(tmp_path / "r.mp4"), **{layout: True})
    assert open(dst, "rb").read() != open(src, "rb").read()
    assert pvr.probe(dst) == pvr.probe(src) == jvr.probe(dst)
    idx = [0, 7, 13, 25, 40]
    with pvr.VideoHandle(src) as a, pvr.VideoHandle(dst) as b:
        pa, pb = a.h264_plan(idx), b.h264_plan(idx)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- plan and bitstream

def segments(plan):
    """Each segment's bytes: a stream any H.264 decoder reads alone."""
    out, start = [], 0
    for end in plan.seg_end:
        b0 = int(plan.pkt_end[start - 1]) if start else 0
        out.append(plan.data[b0:int(plan.pkt_end[end - 1])].tobytes())
        start = int(end)
    return out


def decode_plan(path, indices, tmp_path):
    """The port's Annex B segments for `indices`, each written to a .h264
    file and decoded by oatx's reader → {display index: frame} (at the
    native size) and the plan."""
    with pvr.VideoHandle(path) as h:
        plan = h.h264_plan(indices)
    got, start = {}, 0
    for s, seg in enumerate(segments(plan)):
        f = str(tmp_path / f"seg{s}.h264")
        with open(f, "wb") as out:
            out.write(seg)
        shown = sorted(int(t) for t in plan.pkt_ts[start:plan.seg_end[s]])
        start = int(plan.seg_end[s])
        for t, frame in zip(shown, jvr.decode_indices(f, list(range(len(shown))))):
            got.setdefault(t, frame)
    return got, plan


def index_sets(n):
    rng = np.random.default_rng(n)
    return {"all": list(range(n)), "rand": sorted(rng.choice(n, 4, replace=False).tolist()),
            "uniform": [n // 8, 3 * n // 8, 5 * n // 8, 7 * n // 8],
            "past_end": [n - 1, n, n + 5, 3, 3]}


@pytest.mark.parametrize("clip", ["high", "base", "four", "gop1", "gop4_bframes"])
def test_annexb_stream_decodes_like_the_mp4(clips, tmp_path, clip):
    path = {"gop1": clips.get((320, 1, True)), "gop4_bframes": clips.get((596, 4, True))}.get(
        clip) or os.path.join(FIXTURES, clip + ".mp4")
    n = pvr.probe(path)[0]
    for name, idx in index_sets(n).items():
        got, plan = decode_plan(path, idx, tmp_path)
        want = jvr.decode_indices(path, idx)
        assert plan.wanted.tolist() == sorted({min(i, n - 1) for i in idx})
        for k, i in enumerate(idx):
            np.testing.assert_array_equal(got[min(i, n - 1)], want[k], err_msg=f"{name} {i}")
        if name == "all":
            ordered = [got[i] for i in range(min(n, 30))]  # stamps saturate from frame 30
            assert stamps(ordered) == stamps(want[:30])
            assert all(b > a for a, b in zip(stamps(ordered), stamps(ordered)[1:]))
        assert len(plan.seg_end) <= len(plan.wanted)


def test_plan_starts_each_segment_at_a_sync_sample():
    with pvr.VideoHandle(os.path.join(FIXTURES, "high.mp4")) as h:
        plan = h.h264_plan([30, 2, 49])
    start = 0
    for end in plan.seg_end:
        first = plan.data[(plan.pkt_end[start - 1] if start else 0):][:5].tobytes()
        assert first == b"\x00\x00\x00\x01\x67"  # the SPS opens the segment
        start = int(end)
    assert plan.wanted.tolist() == [2, 30, 49]
    assert len(plan.seg_end) == 2  # gop 25: the first keyframe's run, then the second's


# ------------------------------------------------------------------ colour

def raw_planes(path, w, h, n, planes=None, seed=1):
    """oatx's uncompressed yuv420p clip (I420 in an AVI); its `00dc` chunks
    hold the top-down planes: → each frame's I420 bytes (after writing
    `planes` over them, when given)."""
    jvr.write_test_video(path, w, h, n, 8, seed=seed, codec="rawvideo")
    data = bytearray(open(path, "rb").read())
    size = w * h * 3 // 2
    tag = b"00dc" + struct.pack("<I", size)
    offs, i = [], data.find(tag)
    while i >= 0:
        offs.append(i + 8)
        i = data.find(tag, i + 8)
    assert len(offs) == n
    if planes is not None:
        for o, p in zip(offs, planes):
            data[o:o + size] = p.tobytes()
        with open(path, "wb") as f:
            f.write(data)
    return [np.frombuffer(bytes(data[o:o + size]), np.uint8) for o in offs]


def to_nv12(i420, w, h):
    y = i420[:w * h].reshape(h, w)
    u = i420[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
    v = i420[w * h * 5 // 4:].reshape(h // 2, w // 2)
    return np.concatenate([y, np.stack([u, v], -1).reshape(h // 2, w)])


@pytest.mark.parametrize("short_side", [0, 64, 224, 256])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_colour_matches_oatx(tmp_path, size, short_side):
    import torch

    w, h = size
    path = str(tmp_path / "raw.avi")
    planes = raw_planes(path, w, h, 3)
    planes[2] = np.random.default_rng(w).integers(0, 256, planes[2].shape, dtype=np.uint8)
    raw_planes(path, w, h, 3, planes)
    assert jvr.probe(path) == (3, 8.0, w, h)
    ow, oh = jvr.VideoHandle(path).out_size(short_side)
    nv12 = torch.from_numpy(np.stack([to_nv12(p, w, h) for p in planes]))
    got = nv12_rgb.nv12_to_rgb(nv12, ow, oh, False).numpy()
    close(got, jvr.decode_indices(path, [0, 1, 2], short_side))


def test_native_size_leaves_oatx_unwritten_columns_black():
    """swscale's x86 converter writes whole blocks of 8 pixels; oatx hands
    back the rest of a 596-wide row as its zero-filled buffer holds it."""
    frames = jvr.decode_indices(os.path.join(FIXTURES, "high.mp4"), [0, 24, 49], 0)
    assert nv12_rgb.simd_width(596) == 592
    assert not frames[:, :, 592:].any() and frames[:, :, 584:592].any()


def test_colour_constants_are_swscales():
    """The unscaled converter's 13-bit coefficients FFmpeg's yuv2rgb init
    gives (the full-range ones decode.cpp's JPEG path uses)."""
    full = nv12_rgb.colour_constants(True)
    assert full[:6] == (0, 8192, 11485, 14516, -2819, -5850)
    assert full[9:] == (91881, 116129, -22552, -46800)  # decode.cpp's ColorTables
    assert nv12_rgb.colour_constants(False)[:6] == (128, 9539, 13075, 16525, -3209, -6660)


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("clip", ["high", "base", "one", "four"])
def test_committed_fixtures_match_oatx(clip):
    path = os.path.join(FIXTURES, clip + ".mp4")
    ref = np.load(os.path.join(FIXTURES, clip + ".npz"))
    probe = jvr.probe(path)
    assert tuple(ref["probe"]) == probe
    assert pvr.probe(path)[0] == probe[0] and pvr.probe(path)[2:] == probe[2:]
    n = probe[0]
    sides = sorted({int(k[1:].split("_")[0]) for k in ref.files if k.startswith("s")})
    for ss in sides:
        every = jvr.decode_indices(path, list(range(n)), ss)
        if f"s{ss}_sha256" in ref.files:  # high and four: digests (make_fixtures.py)
            digests = [hashlib.sha256(np.ascontiguousarray(f).tobytes()).digest() for f in every]
            assert digests == [bytes(d) for d in ref[f"s{ss}_sha256"]], (clip, ss)
        else:
            np.testing.assert_array_equal(every[ref[f"s{ss}_idx"]], ref[f"s{ss}_frames"])
        np.testing.assert_array_equal(every.reshape(n, -1, 3).mean(1), ref[f"s{ss}_means"])
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 1 << 20


# ----------------------------------------------------------------- refusals

def test_h264_without_a_card_raises(monkeypatch):
    """Without a card the reader raises unless the caller names the CPU
    (oatx_torch.resolve_device): the decoder runs on the host either way,
    its RGB comes from the card's kernel or, on the CPU, its plain version."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(FIXTURES, "base.mp4")
    for call in (lambda: pvr.decode_indices(path, [0]),
                 lambda: pvr.read_frames(path, 4, rng=np.random.default_rng(0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert pvr.probe(path) == (16, 8.0, 320, 240)  # the demuxer needs no card
    frames, idxs, _ = pvr.read_frames(path, 4, rng=np.random.default_rng(0), device="cpu")
    np.testing.assert_array_equal(frames, jvr.decode_indices(path, idxs, 256))


@pytest.mark.parametrize("fourcc,named", [(b"hvc1", "HEVC"), (b"mp4v", "MPEG-4 Part 2"),
                                          (b"av01", "AV1")])
def test_other_codecs_in_mp4_raise_naming_the_codec(tmp_path, fourcc, named):
    data = open(os.path.join(FIXTURES, "one.mp4"), "rb").read()
    at = data.rindex(b"avc1")  # the sample entry (the first is ftyp's brand)
    assert data[at - 8:at - 4] == b"stsd"[:0] or b"stsd" in data[at - 24:at]
    path = str(tmp_path / "x.mp4")
    with open(path, "wb") as f:
        f.write(data[:at] + fourcc + data[at + 4:])
    with pytest.raises(pvr.UnsupportedMedia, match=named):
        pvr.probe(path)


def test_truncated_mp4_is_a_decode_error(tmp_path):
    data = open(os.path.join(FIXTURES, "base.mp4"), "rb").read()
    path = str(tmp_path / "t.mp4")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])  # moov is at the end
    with pytest.raises(pvr.DecodeError, match="moov"):
        pvr.probe(path)


CAPS_OOM = ("cuvidGetDecoderCaps(H.264, 4:2:0, 8-bit) failed: 2 CUDA_ERROR_OUT_OF_MEMORY "
            "(out of memory)")


class _FailedLib:
    """Stands for csrc/nvdec.cu's library after a failed entry."""

    def __init__(self, msg):
        self.msg = msg

    def oatx_nvdec_error(self):
        return self.msg.encode()


@pytest.mark.parametrize("rc,msg,env,raised", [
    (-1, CAPS_OOM, "compute,utility", "observed"),
    (-1, CAPS_OOM, " compute , utility ", "observed"),
    (-1, "dlopen(\"libnvcuvid.so.1\") failed: not found", "compute,utility", "refused"),
    (-1, CAPS_OOM, "compute,video,utility", "NvdecError"),
    (-1, CAPS_OOM, "all", "NvdecError"),
    (-1, CAPS_OOM, None, "NvdecError"),
    (-1, CAPS_OOM, "", "NvdecError"),
    (-2, "cuvidGetDecoderCaps(H.264, 4:2:0, 8-bit) failed: 1 CUDA_ERROR_INVALID_VALUE",
     "compute,utility", "NvdecError"),
    (-2, "cuvidCreateDecoder failed: 2 CUDA_ERROR_OUT_OF_MEMORY", "compute,utility",
     "NvdecError"),
    (-2, "NVDEC's parser reports coded 608x336", "compute,utility", "NvdecError"),
    (-3, "cuvidParseVideoData failed: 1 CUDA_ERROR_INVALID_VALUE", "compute,utility",
     "DecodeError")], ids=lambda v: str(v)[:24])
def test_nvdec_failures_raise_by_cause(monkeypatch, rc, msg, env, raised):
    """Only a container's refusal (NVIDIA_DRIVER_CAPABILITIES withholding
    'video') is UnsupportedMedia, and only the caps query's
    CUDA_ERROR_OUT_OF_MEMORY is the refusal chip_smoke.py accepts; every
    other failure is NvdecError, which lax loading does not catch, save a
    bitstream NVDEC's parser rejects (DecodeError)."""
    from oatx_torch.data import nvdec

    if env is None:
        monkeypatch.delenv("NVIDIA_DRIVER_CAPABILITIES", raising=False)
    else:
        monkeypatch.setenv("NVIDIA_DRIVER_CAPABILITIES", env)
    kind = {"observed": pvr.UnsupportedMedia, "refused": pvr.UnsupportedMedia,
            "NvdecError": nvdec.NvdecError, "DecodeError": pvr.DecodeError}[raised]
    with pytest.raises(kind) as e:
        nvdec._raise(_FailedLib(msg), rc, "NVDEC caps")
    assert type(e.value) is kind
    assert msg in str(e.value)
    assert nvdec.is_observed_refusal(str(e.value)) == (raised == "observed")
    assert not issubclass(nvdec.NvdecError, (pvr.DecodeError, AssertionError, OSError))
