"""The port's host H.264 decoder on CABAC and B slices (native/h264.h,
h264_cabac.cpp, through data/h264.py) on the CPU, against oatx's FFmpeg
reader, bitwise (tolerance 0).

* every frame of the CABAC / B fixtures (tests/torch_h264: high.mp4 and
  four.mp4 from oatx's `transcode`, cmed.mp4 x264's default preset,
  ctemp.mp4 temporal direct, cbcavlc.mp4 CAVLC B slices, cpcmb.mp4 I_PCM
  in CABAC, cidc1.mp4 cabac_init_idc 1, copen.mp4 an open GOP) equal to
  oatx's stored SHA-256 and channel means at every stored short side, with
  'rand', 'uniform' and past-the-end samples;
* fresh clips from oatx's own `transcode(..., "libx264")` (x264 veryfast:
  CABAC with B-frames) at two sizes and two gops, both decoders fresh;
* streams edited by hand for what x264 never writes, each bitwise against
  oatx's decode of the same bytes: explicit bi-prediction weights
  (weighted_bipred_idc 1, a pred_weight_table in every B slice header),
  direct_8x8_inference_flag 0 under temporal direct, and the IDR picture
  a long-term reference under temporal direct and implicit weights, with
  list 1 modified;
* the tool census of the CABAC / B counters (`h264.stats`): each reached
  by a fixture or an edit, or named in UNTESTED with the reason;
* CABAC table spot checks against Tables 9-12 to 9-33, 9-44 and 9-45 of
  ITU-T H.264 (h264.read_syntax kinds 3 and 4);
* an open GOP read as oatx reads it (from the IDR picture before the
  recovery point), and a stream opening on a recovery point refused;
  cabac_init_idc 1 with the 8×8 transform refused (its ctxIdx 399-435
  initialisation is not verified), both as UnsupportedMedia naming the tool.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from oatx.data import video_reader as jvr
from oatx_torch.data import h264
from oatx_torch.data import video_reader as pvr
from oatx_torch.data.sampling import sample_frames
from test_torch_h264 import (CABAC_COUNTERS, Rbsp, packets, pps_fields_b, replan, sei_options,
                             slice_edit_b, sps_fields)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_h264")
CLIPS = ["high", "four", "cmed", "ctemp", "cbcavlc", "cpcmb", "cidc1", "copen"]
# counters no fixture or edit reaches, and why
UNTESTED = {
    "sub_b8x4", "sub_b4x8", "sub_b4x4",  # x264 writes no B sub-partition below 8×8
    "direct_td_zero",  # RefPicList0[refIdxL0] the co-located picture itself: no x264 B slice
    "bs_same_two_refs",  # both vectors of two bi-predicted blocks from one picture
}


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fixture(clip):
    return os.path.join(FIXTURES, clip + ".mp4")


def sha(frame):
    return np.frombuffer(hashlib.sha256(np.ascontiguousarray(frame).tobytes()).digest(), np.uint8)


# ------------------------------------------------------------ the fixtures

@pytest.mark.parametrize("clip", CLIPS)
def test_cabac_fixtures_match_oatx_digests(clip):
    path = fixture(clip)
    ref = np.load(os.path.join(FIXTURES, clip + ".npz"))
    n, fps, w, h = pvr.probe(path)
    assert tuple(ref["probe"]) == (n, fps, w, h)
    sides = sorted({int(k[1:].split("_")[0]) for k in ref.files if k.startswith("s")})
    assert 0 in sides and len(sides) > 1
    for ss in sides:
        every = pvr.decode_indices(path, list(range(n)), ss, device="cpu")
        got = np.stack([sha(f) for f in every])
        bad = [i for i in range(n) if not np.array_equal(got[i], ref[f"s{ss}_sha256"][i])]
        assert not bad, f"{clip} at short side {ss}: frames {bad} differ from oatx's"
        np.testing.assert_array_equal(every.reshape(n, -1, 3).mean(1), ref[f"s{ss}_means"])
        reads = {"rand": sample_frames(4, n, "rand", rng=np.random.default_rng(0)),
                 "uniform": sample_frames(4, n, "uniform"),
                 "past_end": [n - 1, n, n + 7, 10 * n, 0]}
        for name, idx in reads.items():
            part = pvr.decode_indices(path, idx, ss, device="cpu")
            np.testing.assert_array_equal(part, every[np.minimum(idx, n - 1)], err_msg=name)


def test_fixture_options():
    """The x264 options each fixture carries in its SEI: what it covers."""
    o = {c: sei_options(fixture(c)) for c in CLIPS}
    for c in ("high", "four", "cmed", "ctemp", "cpcmb", "cidc1", "copen"):
        assert o[c]["cabac"] == "1" and o[c]["bframes"] != "0", (c, o[c])
    m = o["cmed"]  # x264's default preset
    assert (m["bframes"], m["b_pyramid"], m["weightb"], m["weightp"], m["ref"], m["8x8dct"],
            m["direct"], m["keyint"]) == ("3", "2", "1", "2", "3", "1", "1", "25"), m
    assert o["ctemp"]["direct"] == "2" and o["cbcavlc"]["direct"] == "2"
    assert (o["cbcavlc"]["cabac"], o["cbcavlc"]["bframes"], o["cbcavlc"]["8x8dct"]) == \
        ("0", "3", "0")
    assert (o["cidc1"]["8x8dct"], o["copen"]["open_gop"], o["cpcmb"]["qp"]) == ("0", "1", "10")


@pytest.mark.parametrize("gop", [12, 25])
@pytest.mark.parametrize("size", [(320, 240), (596, 336)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_transcode_clips_match_oatx(tmp_path, size, gop):
    """oatx's own libx264 transcode (veryfast: CABAC, B-frames), both
    decoders fresh."""
    src, dst = str(tmp_path / "src.avi"), str(tmp_path / "t.mp4")
    jvr.write_test_video(src, *size, 20, 25, seed=gop)
    jvr.transcode(src, dst, "libx264", gop=gop)
    o = sei_options(dst)
    assert o["cabac"] == "1" and o["bframes"] != "0", o
    idx = list(range(20))
    for ss in (0, 224):
        np.testing.assert_array_equal(pvr.decode_indices(dst, idx, ss, device="cpu"),
                                      jvr.decode_indices(dst, idx, ss), err_msg=f"ss {ss}")


# ---------------------------------------------------- hand-edited streams

def weight_table(rng):
    """A pred_weight_table (7.3.3.2) for both lists: luma / chroma weights
    near unity with offsets, some references without them."""
    def table(active):
        r = Rbsp(b"\x00\x80")
        r.put_ue(5), r.put_ue(4)
        for lst in range(2):
            for _ in range(active[lst]):
                r.put(1, 1)
                r.put_se(int(rng.integers(22, 44))), r.put_se(int(rng.integers(-10, 11)))
                chroma = int(rng.integers(0, 2))
                r.put(chroma, 1)
                if chroma:
                    for _ in range(2):
                        r.put_se(int(rng.integers(10, 22))), r.put_se(int(rng.integers(-6, 7)))
        return r.out
    return table


# edit → the counters it must reach
B_EDITS = {
    "explicit_bipred": ["weighted_bipred_explicit", "weighted_blocks", "bipred_blocks"],
    "no_inference": ["direct_4x4", "direct_temporal"],
    "long_term": ["long_term_refs", "long_term_in_b", "direct_long_term",
                  "implicit_default_weights", "list1_mods", "list_mod_idc2", "list1_swapped"],
}


def edited_b(edit):
    """cbcavlc.mp4 (CAVLC, B-pyramid, temporal direct, implicit weights)
    with the hand edit `edit` → (plan, w, h)."""
    with pvr.VideoHandle(fixture("cbcavlc")) as hd:
        n, _, w, h = hd.info()
        plan = hd.h264_plan(list(range(n)))
    pkts = packets(plan)
    # the long-term picture takes a frame of its own, so the short-term ones
    # slide out of the DPB as the encoder had them do
    sps_nal, sps = sps_fields(pkts[0][0], inference=0 if edit == "no_inference" else None,
                              extra_refs=1 if edit == "long_term" else 0)
    pps_nal, pps = pps_fields_b(pkts[0][1], bipred=1 if edit == "explicit_bipred" else None)
    pkts[0][0], pkts[0][1] = sps_nal, pps_nal
    rng = np.random.default_rng(7)
    for p in pkts:
        for j, nal in enumerate(p):
            if nal[0] & 31 not in (1, 5):
                continue
            kw = {}
            if edit == "explicit_bipred":
                kw["weights"] = weight_table(rng)
            if edit == "long_term":  # the IDR picture long-term 0, first in list 0; list 1's
                kw["idr_long_term"] = True  # newest picture first
                kw["mods"] = {0: [(2, 0)], 1: [(0, 0)]}
            p[j], _ = slice_edit_b(nal, sps, pps, **kw)
    return replan(plan, pkts), w, h


@pytest.mark.parametrize("edit", list(B_EDITS))
def test_edited_b_streams_match_oatx(tmp_path, edit):
    """B-slice tools x264 never writes, on hand-edited streams decoded by
    both packages from the same bytes: bitwise equal, the edit reached its
    tools, and it changed the pictures."""
    from oatx_torch.ops.kernels.nv12_rgb import nv12_to_rgb_plain

    plan, w, h = edited_b(edit)
    counters = {}
    nv12 = h264.decode_stream(plan, w, h, counters)
    missed = [k for k in B_EDITS[edit] if not counters[k]]
    assert not missed, f"{edit} did not reach {missed}"
    got = nv12_to_rgb_plain(torch.from_numpy(nv12), w, h, False).numpy()
    path = tmp_path / "edited.h264"
    path.write_bytes(plan.data.tobytes())
    want = jvr.decode_indices(str(path), list(range(len(plan.wanted))), 0)
    bad = [i for i in range(len(got)) if not np.array_equal(got[i], want[i])]
    assert not bad, f"{edit}: frames {bad} differ from oatx's decode of the same stream"
    with pvr.VideoHandle(fixture("cbcavlc")) as hd:
        plain = np.empty_like(nv12)
        h264.decode_nv12(hd, list(range(len(plain))), plain)
    assert not np.array_equal(plain, nv12), f"{edit} changed no sample"


# ------------------------------------------------------------------ census

def test_cabac_tool_census():
    """Every CABAC / B counter is reached by a committed fixture or a hand
    edit (UNTESTED names the rest, with the reason)."""
    total = dict.fromkeys(CABAC_COUNTERS, 0)

    def add(counters):
        for k in total:
            total[k] += counters[k]

    for c in CLIPS:
        with pvr.VideoHandle(fixture(c)) as hd:
            n, _, w, h = hd.info()
            h264.decode_nv12(hd, list(range(n)), np.empty((n, h * 3 // 2, w), np.uint8))
            if c == "cmed":  # a partial read skips the non-reference B pictures it needs not
                h264.decode_nv12(hd, [n - 1], np.empty((1, h * 3 // 2, w), np.uint8))
            add(h264.stats(hd))
    for edit in B_EDITS:
        counters = {}
        h264.decode_stream(*edited_b(edit), counters)
        add(counters)
    assert UNTESTED <= set(total), UNTESTED - set(total)
    missing = sorted(k for k, v in total.items() if not v and k not in UNTESTED)
    assert not missing, f"no committed fixture reaches {missing}"
    reached = sorted(k for k in UNTESTED if total[k])
    assert not reached, f"{reached} are reached now: take them out of UNTESTED"


# ------------------------------------------------------- table spot checks

def state(m, n, qp):
    """9.3.1.1: the context state 2 · pStateIdx + valMPS of (m, n) at SliceQPY."""
    pre = min(max(((m * min(max(qp, 0), 51)) >> 4) + n, 1), 126)
    return 2 * (63 - pre) if pre <= 63 else 2 * (pre - 64) + 1


# slice kind (0 I, 1-3 cabac_init_idc 0-2) → {ctxIdx: (m, n)} from Tables 9-12 to
# 9-33; None where the kind has no such context (or, for cabac_init_idc 1 at
# ctxIdx 399-435, where the port refuses the streams that reach it)
INIT_SPOTS = {
    0: {0: (20, -15), 3: (20, -15), 10: (7, 51), 11: None, 60: (0, 41), 64: (-9, 83),
        69: (3, 62), 73: (-17, 127), 85: (-17, 123), 105: (-7, 93), 166: (24, 0),
        227: (-3, 71), 275: (-14, 97), 300: None, 399: (31, 21), 402: (-17, 120),
        417: (23, -13), 426: (-3, 75), 435: (-9, 92)},
    1: {11: (23, 33), 24: (18, 64), 36: (-6, 86), 40: (-3, 69), 54: (-7, 67), 70: (0, 45),
        105: (-2, 85), 166: (11, 28), 227: (-6, 76), 399: (12, 40), 402: (-4, 79),
        435: (-8, 76)},
    2: {11: (22, 25), 27: (57, 2), 47: (1, 56), 59: (0, 61), 104: (-9, 88), 165: (0, 89),
        178: (102, -94), 226: (-10, 116), 275: (-4, 78), 399: None, 435: None},
    3: {11: (29, 16), 30: (-32, 127), 53: (-1, 101), 85: (11, 80), 116: (-4, 71),
        200: (34, -14), 275: (-10, 87), 399: (21, 33), 435: (-10, 79)},
}


@pytest.mark.parametrize("qp", [0, 26, 51, 60])
@pytest.mark.parametrize("kind", [0, 1, 2, 3], ids=["I", "idc0", "idc1", "idc2"])
def test_cabac_init_spot_checks(kind, qp):
    spots = INIT_SPOTS[kind]
    got, _ = h264.read_syntax("cabac_init", b"", len(spots), 64 * kind + min(qp, 63),
                              ctx=list(spots))
    want = [-1 if mn is None else state(*mn, qp) for mn in spots.values()]
    assert got == want


# Table 9-44 rows (qCodIRangeIdx 0-3) and Table 9-45 transIdxLPS by pStateIdx
RANGE_SPOTS = {0: ((128, 176, 208, 240), 0), 1: ((128, 167, 197, 227), 0),
               12: ((77, 94, 111, 128), 9), 31: ((29, 35, 41, 48), 24),
               33: ((26, 31, 37, 43), 25), 62: ((6, 7, 8, 9), 38), 63: ((2, 2, 2, 2), 63)}


def test_cabac_engine_table_spot_checks():
    rows, trans = h264.read_syntax("cabac_range", b"", len(RANGE_SPOTS), 0,
                                   ctx=list(RANGE_SPOTS))
    assert rows == [r for r, _ in RANGE_SPOTS.values()]
    assert trans == [t for _, t in RANGE_SPOTS.values()]


# ---------------------------------------------------------------- refusals

def test_open_gop_reads_as_oatx_and_a_recovery_point_start_is_refused():
    """copen.mp4's sync samples past the first are recovery points whose
    leading B pictures reference the group before: oatx decodes them in
    sequence (its seek lands past them), the port plans from the IDR
    picture before; a stream that opens on a recovery point is refused."""
    path = fixture("copen")
    n = pvr.probe(path)[0]
    full = jvr.decode_indices(path, list(range(n)), 0)
    for idx in ([18, 19], [20, 29], [8, 21], [28]):
        np.testing.assert_array_equal(pvr.decode_indices(path, idx, 0, device="cpu"),
                                      full[idx], err_msg=str(idx))
    with pvr.VideoHandle(path) as hd:
        w, h = hd.info()[2:]
        plan = hd.h264_plan(list(range(n)))
    pkts = packets(plan)
    at = list(plan.pkt_ts).index(10)  # the first recovery point (display 10)
    assert not any(nal[0] & 31 == 5 for nal in pkts[at])
    data, ends = b"", []
    for p in [pkts[0][:2] + pkts[at]] + pkts[at + 1:]:  # SPS, PPS, then from the recovery point
        data += b"".join(b"\x00\x00\x00\x01" + nal for nal in p)
        ends.append(len(data))
    opened = pvr.H264Plan(np.frombuffer(data, np.uint8), np.asarray(ends, np.int64),
                          plan.pkt_ts[at:], np.asarray([len(ends)], np.int32),
                          np.asarray([12], np.int64))
    with pytest.raises(pvr.UnsupportedMedia, match="open GOP"):
        h264.decode_stream(opened, w, h)


def test_cabac_init_idc1_with_the_8x8_transform_is_refused():
    """cmed.mp4 (its PPS allows the 8×8 transform) with cabac_init_idc 1
    written into its P and B slice headers."""
    with pvr.VideoHandle(fixture("cmed")) as hd:
        w, h = hd.info()[2:]
        plan = hd.h264_plan(list(range(6)))
    pkts = packets(plan)
    (_, sps), (_, pps) = sps_fields(pkts[0][0]), pps_fields_b(pkts[0][1])
    for p in pkts:
        for j, nal in enumerate(p):
            if nal[0] & 31 == 1:
                p[j], _ = slice_edit_b(nal, sps, pps, field=("cabac_init_idc", 1))
    with pytest.raises(pvr.UnsupportedMedia, match="cabac_init_idc 1 with the 8x8 transform"):
        h264.decode_stream(replan(plan, pkts), w, h)
