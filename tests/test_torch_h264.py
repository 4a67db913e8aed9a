"""The port's host H.264 decoder (native/h264.h through data/h264.py) on the
CPU, against oatx's FFmpeg reader, bitwise (tolerance 0).

* every frame of the CAVLC fixtures (tests/torch_h264/cavlc.mp4, cbase.mp4,
  cfour.mp4: make_fixtures.py) equal to oatx's stored SHA-256 and channel
  means at every stored short side, 'rand' / 'uniform' samples and indices
  past the end included; base.mp4 and one.mp4 (x264's ultrafast Baseline)
  equal to oatx's stored frames;
* oatx's `write_test_video(codec="libx264")` clips at 128×96 / 320×240 /
  596×336 × gop 1 / 4 / 12 / 25, decoded fresh by both packages;
* the tool census: the x264 options each fixture carries in its SEI, and
  the decoder's own counters (`h264.stats`), show every CAVLC I / P tool
  reached by a committed fixture (cpcm.mp4: I_PCM) or by a fixture edited
  by hand for what x264 never writes without CABAC and B slices (the CABAC
  and B counters, CABAC_COUNTERS, are test_torch_h264_cabac.py's), each
  edited stream bitwise against oatx's decode of the same bytes: memory
  management control operations 1-6 and long-term references, POC types 0
  and 1, ref_pic_list_modification idc 1 and 2, SPS scaling matrices with
  fall-back rule B, explicit and use-default lists, a second chroma QP
  offset unlike the first, disable_deblocking_filter_idc 2 and a
  non-reference picture (decoded, and skipped when not wanted). No test
  reaches two paths (UNTESTED): level_prefix ≥ 16 (levels beyond ≈ 2^11)
  and mb_qp_delta wrapping past 0 or 51;
* ue(v) / se(v) and CAVLC code table spot checks against Tables 9-5, 9-7,
  9-9a and 9-10 of ITU-T H.264;
* refusals: FMO, redundant pictures, SP / SI slices, data partitioning,
  gaps in frame_num, lossless coding and interlace raise UnsupportedMedia
  naming the tool, on streams edited by hand; nothing decodes in their
  place; syntax elements past their range (the B slices' and CABAC's
  among them) raise DecodeError;
* a lax WebVid dataset over CAVLC and CABAC / B clips read with
  `device="cpu"` gives oatx's samples.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from oatx.data import video_reader as jvr
from oatx_torch.data import h264
from oatx_torch.data import video_reader as pvr
from oatx_torch.data.sampling import sample_frames

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_h264")
CAVLC = ["cavlc", "cbase", "cfour", "cpcm"]
UNTESTED = {"level_prefix_16", "qp_delta_wrap"}
# the CABAC and B-slice counters: tests/test_torch_h264_cabac.py's census
CABAC_COUNTERS = [
    "cabac_slices", "cabac_init_idc0", "cabac_init_idc1", "cabac_init_idc2", "cabac_pcm",
    "cabac_mvd_suffix", "cabac_level_suffix", "cabac_qp_delta_nonzero", "b_slices",
    "b_ref_pictures", "non_ref_skipped", "mb_bskip", "mb_bdirect16x16", "mb_b16x16",
    "mb_b16x8", "mb_b8x16", "mb_b8x8", "intra_in_b", "part_l0", "part_l1", "part_bi",
    "sub_bdirect", "sub_b8x8", "sub_b8x4", "sub_b4x8", "sub_b4x4", "direct_spatial",
    "direct_temporal", "direct_8x8_inference", "direct_4x4", "direct_col_zero",
    "direct_zero_refs", "direct_col_intra", "direct_long_term", "direct_td_zero",
    "list1_swapped", "list1_mods", "long_term_in_b", "weighted_bipred_explicit",
    "weighted_bipred_implicit", "implicit_default_weights", "bipred_blocks", "bs_two_refs",
    "bs_same_two_refs", "bs_mv_count_differs"]


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

@pytest.mark.parametrize("clip", CAVLC)
def test_cavlc_fixtures_match_oatx_digests(clip):
    path = fixture(clip)
    ref = np.load(os.path.join(FIXTURES, clip + ".npz"))
    n, fps, w, h = pvr.probe(path)
    assert tuple(ref["probe"]) == (n, fps, w, h)
    sides = sorted({int(k[1:].split("_")[0]) for k in ref.files if k.startswith("s")})
    assert 0 in sides and 224 in sides
    for ss in sides:
        every = pvr.decode_indices(path, list(range(n)), ss, device="cpu")
        assert every.shape == (n, *pvr.VideoHandle(path).out_size(ss)[::-1], 3)
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
    frames, idxs, vlen = pvr.read_frames(path, 4, rng=np.random.default_rng(3), short_side=256,
                                         device="cpu")
    assert vlen == n and frames.shape[0] == min(4, n)
    jframes, jidxs, _ = jvr.read_frames(path, 4, rng=np.random.default_rng(3), short_side=256)
    assert list(idxs) == list(jidxs)
    np.testing.assert_array_equal(frames, jframes)


@pytest.mark.parametrize("clip", ["base", "one"])
def test_baseline_fixtures_match_oatx_frames(clip):
    """x264's ultrafast Baseline (I16x16, P16x16, P_Skip, no deblocking)."""
    path = fixture(clip)
    ref = np.load(os.path.join(FIXTURES, clip + ".npz"))
    n = pvr.probe(path)[0]
    for ss in sorted({int(k[1:].split("_")[0]) for k in ref.files if k.startswith("s")}):
        every = pvr.decode_indices(path, list(range(n)), ss, device="cpu")
        np.testing.assert_array_equal(every[ref[f"s{ss}_idx"]], ref[f"s{ss}_frames"])
        np.testing.assert_array_equal(every.reshape(n, -1, 3).mean(1), ref[f"s{ss}_means"])


@pytest.mark.parametrize("gop", [1, 4, 12, 25])
@pytest.mark.parametrize("size", [(128, 96), (320, 240), (596, 336)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_libx264_clips_match_oatx(tmp_path, size, gop):
    """oatx's libx264 writer (test_torch_mp4.py's clips), both decoders fresh."""
    path = str(tmp_path / "c.mp4")
    jvr.write_test_video(path, *size, 26, 8, seed=1, codec="libx264", gop=gop)
    idx = list(range(26))
    for ss in (0, 224):
        np.testing.assert_array_equal(pvr.decode_indices(path, idx, ss, device="cpu"),
                                      jvr.decode_indices(path, idx, ss), err_msg=f"ss {ss}")


# ------------------------------------------------------------------ census

def sei_options(path):
    """x264's option string from the stream's user-data SEI → {key: value}."""
    data = open(path, "rb").read()
    at = data.index(b"options: ") + len(b"options: ")
    text = data[at:data.index(b"\x00", at)].decode()
    return dict(kv.split("=", 1) for kv in text.split() if "=" in kv)


def test_tool_census():
    """Every tool of the decoder is reached by a committed fixture (module
    docstring: UNTESTED lists what none reaches)."""
    opts = {c: sei_options(fixture(c)) for c in CAVLC + ["base", "one"]}
    assert (opts["cpcm"]["qp"], opts["cpcm"]["cabac"], opts["cpcm"]["psy"]) == ("10", "0", "0")
    for c in ("cavlc", "cfour"):
        o = opts[c]
        assert (o["cabac"], o["bframes"], o["8x8dct"], o["ref"], o["weightp"], o["slices"],
                o["deblock"], o["cqm"], o["mixed_ref"]) == ("0", "0", "1", "3", "2", "4",
                                                          "1:-1:-1", "1", "1"), o
    o = opts["cbase"]
    assert (o["cabac"], o["bframes"], o["ref"], o["deblock"], o["constrained_intra"]) == \
        ("0", "0", "3", "1:2:2", "1"), o
    for c in ("base", "one"):
        assert (opts[c]["cabac"], opts[c]["deblock"], opts[c]["analyse"]) == \
            ("0", "0:0:0", "0:0"), opts[c]
    total = {}
    for c in CAVLC + ["base", "one"]:
        with pvr.VideoHandle(fixture(c)) as hd:
            n = hd.info()[0]
            w, h = hd.info()[2:]
            h264.decode_nv12(hd, list(range(n)), np.empty((n, h * 3 // 2, w), np.uint8))
            for k, v in h264.stats(hd).items():
                total[k] = total.get(k, 0) + v
    for edit in EDITS:  # test_edited_streams_match_oatx holds these against oatx
        counters = {}
        decode_edit(edit, counters)
        for k, v in counters.items():
            total[k] += v
    assert UNTESTED <= set(total), UNTESTED - set(total)
    missing = sorted(k for k, v in total.items()
                     if not v and k not in UNTESTED and k not in CABAC_COUNTERS)
    assert not missing, f"no committed fixture reaches {missing}"
    reached = sorted(k for k in UNTESTED if total[k])
    assert not reached, f"{reached} are reached now: take them out of UNTESTED"


# ------------------------------------------------------- syntax spot checks

def bits(s):
    s = s.replace(" ", "")
    s += "1" + "0" * (-(len(s) + 1) % 8)  # a stop bit, as rbsp_trailing_bits
    return int(s, 2).to_bytes(len(s) // 8, "big")


def test_exp_golomb_reads():
    # Table 9-2 / 9-3: codeNum 0..8 and the se(v) mapping
    code = bits("1 010 011 00100 00101 00110 00111 0001000 0001001")
    vals, nbits = h264.read_syntax("ue", code, 9)
    assert vals == list(range(9)) and nbits == 1 + 3 * 2 + 5 * 4 + 7 * 2
    vals, _ = h264.read_syntax("se", bits("1 010 011 00100 00101"), 5)
    assert vals == [0, 1, -1, 2, -2]
    vals, _ = h264.read_syntax("ue", bits("000000000011111111111"), 1)
    assert vals == [2 ** 10 - 1 + 2 ** 10 - 1]


# (nC, the bit string of one block, maxNumCoeff) → the levels in coefficient order
CAVLC_CASES = [
    # Table 9-5, 0 <= nC < 2: "1" is TotalCoeff 0
    (0, "1", 16, [0] * 16),
    # "01" T1 1 TC 1, sign "0" → +1; total_zeros (TC 1) "011" → 1 zero before it
    (0, "01 0 011", 16, [0, 1] + [0] * 14),
    # "001" T1 2 TC 2; signs "1" "0" → -1 (higher), +1; total_zeros (TC 2) "111" → 0
    (1, "001 1 0 111", 16, [1, -1] + [0] * 14),
    # 2 <= nC < 4: "11" TC 0; "10" TC 1 T1 1
    (2, "11", 16, [0] * 16),
    (3, "10 1 1", 16, [-1] + [0] * 15),
    # 4 <= nC < 8: "1111" TC 0
    (5, "1111", 16, [0] * 16),
    # nC >= 8: 6-bit FLC "000011" TC 0; "000100" TC 2 T1 0 (levels below)
    (9, "000011", 16, [0] * 16),
    # TC 2 T1 0: level 0 with suffixLength 0, prefix "1" → levelCode 0 + 2 → +2;
    # then suffixLength 1, prefix "01" suffix "1" → levelCode 3 → -2; total_zeros
    # (TC 2) "111" → 0
    (9, "000100 1 01 1 111", 16, [-2, 2] + [0] * 14),
    # chroma DC (nC -1, Table 9-5 last column): "01" TC 0; "1" TC 1 T1 1, then
    # total_zeros (Table 9-9a, TC 1) "001" → 2
    (-1, "01", 4, [0] * 4),
    (-1, "1 0 001", 4, [0, 0, 1, 0]),
    # run_before (Table 9-10): TC 2 T1 2 at nC 0 ("001"), signs "0 0",
    # total_zeros (TC 2) "011" → 4; run_before zerosLeft 4 "001" → 3
    # → levels at coefficients 5 and 1
    (0, "001 0 0 011 001", 16, [0, 1, 0, 0, 0, 1] + [0] * 10),
    # an AC block (maxNumCoeff 15): TC 1 T1 1 "01", sign "1" → -1, total_zeros
    # (TC 1) "1" → 0
    (0, "01 1 1", 15, [-1] + [0] * 14),
]


@pytest.mark.parametrize("nc,code,max_coeff,want", CAVLC_CASES)
def test_cavlc_table_spot_checks(nc, code, max_coeff, want):
    levels, total, nbits = h264.read_syntax("residual", bits(code), max_coeff, nc)
    assert levels == want and total == sum(1 for v in want if v)
    assert nbits == len(code.replace(" ", ""))


# ---------------------------------------------------------------- refusals

def test_h264_without_a_card_and_without_cpu_raises(monkeypatch):
    """No device and no card: the reader raises; nothing decodes in NVDEC's
    place or in the card's."""
    from oatx_torch.data import nvdec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(nvdec, "decode", lambda *a, **k: pytest.fail("NVDEC was tried"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pvr.decode_indices(fixture("cbase"), [0])
    assert pvr.decode_indices(fixture("cbase"), [0], device="cpu").shape == (1, 240, 320, 3)


class Rbsp:
    """Bit reader / writer over one NAL unit's RBSP, to edit headers: the
    reading methods copy what they read to the output unless given a value
    to write instead; take* read without copying; put* write."""

    def __init__(self, nal):
        self.head = nal[:1]
        body, zeros = bytearray(), 0
        for b in nal[1:]:  # emulation prevention removed
            if zeros >= 2 and b == 3:
                zeros = 0
                continue
            zeros = zeros + 1 if b == 0 else 0
            body.append(b)
        self.bits = "".join(f"{b:08b}" for b in body)
        self.bits = self.bits[:self.bits.rindex("1")]  # without rbsp_stop_one_bit
        self.pos, self.out = 0, ""

    def take(self, n):
        v = int(self.bits[self.pos:self.pos + n] or "0", 2)
        self.pos += n
        return v

    def take_ue(self):
        lz = self.bits.index("1", self.pos) - self.pos
        v = int(self.bits[self.pos + lz:self.pos + 2 * lz + 1], 2) - 1
        self.pos += 2 * lz + 1
        return v

    def take_se(self):
        k = self.take_ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def put(self, v, n):
        self.out += format(v, f"0{n}b") if n else ""

    def put_ue(self, v):
        b = format(v + 1, "b")
        self.out += "0" * (len(b) - 1) + b

    def put_se(self, v):
        self.put_ue(2 * v - 1 if v > 0 else -2 * v)

    def u(self, n, value=None):
        v = self.take(n)
        self.put(v if value is None else value, n)
        return v

    def ue(self, value=None):
        v = self.take_ue()
        self.put_ue(v if value is None else value)
        return v

    def se(self, value=None):
        v = self.take_se()
        self.put_se(v if value is None else value)
        return v

    def nal(self, head=None):
        s = self.out + self.bits[self.pos:] + "1"
        s += "0" * (-len(s) % 8)
        body, out, zeros = int(s, 2).to_bytes(len(s) // 8, "big"), bytearray(), 0
        for b in body:  # emulation prevention again
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return (head or self.head) + bytes(out)


HIGH = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


def sps_fields(nal, inference=None, frame_mbs_only=None, extra_refs=0):
    """An SPS without scaling matrices (x264's) → (NAL, fields), its
    direct_8x8_inference_flag / frame_mbs_only_flag replaced when given and
    `extra_refs` added to max_num_ref_frames."""
    r = Rbsp(nal)
    high = r.u(8) in HIGH
    r.u(16), r.ue()
    if high:
        assert r.ue() == 1
        r.ue(), r.ue(), r.u(1)
        assert r.u(1) == 0
    f = {"log2_max_frame_num": r.ue() + 4, "poc": r.ue()}
    if f["poc"] == 0:
        f["log2_poc_lsb"] = r.ue() + 4
    assert f["poc"] != 1
    r.put_ue(r.take_ue() + extra_refs)
    r.u(1), r.ue(), r.ue()
    assert r.u(1, frame_mbs_only) == 1
    f["inference"] = r.u(1, inference)
    return r.nal(), f


def pps_fields_b(nal, bipred=None, transform_8x8=False):
    """A PPS's fields for slice_edit_b, with weighted_bipred_idc replaced
    and / or transform_8x8_mode_flag set when given → (NAL, fields)."""
    r = Rbsp(nal)
    r.ue(), r.ue()
    f = {"cabac": r.u(1)}
    r.u(1)
    assert r.ue() == 0
    f["nref"] = [r.ue() + 1, r.ue() + 1]
    f["wp"] = r.u(1)
    f["bipred"] = r.u(2, bipred)
    if bipred is not None:
        f["bipred"] = bipred
    r.se(), r.se()
    first = r.se()
    f["dfc"] = r.u(1)
    r.u(1), r.u(1)
    if transform_8x8:
        if r.pos < len(r.bits):
            r.u(1, 1)
        else:  # no extension yet: transform_8x8_mode_flag, no matrix, the same offset
            r.put(1, 1), r.put(0, 1), r.put_se(first)
    return r.nal(), f


def slice_edit_b(nal, sps, pps, weights=None, marking=None, mods=None, field=None,
                 idr_long_term=False):
    """A P or B slice (any POC type 0 or 2 SPS of sps_fields) with its header
    edited: `weights` a function (num_ref_idx_active per list) → the
    pred_weight_table's bits written into a B slice (the PPS made
    weighted_bipred_idc 1), `marking` as slice_edit's, an IDR picture made
    long-term 0 by `idr_long_term`, `mods` {list:
    modifications}; `field` (name, value) writes one element past its range
    (num_ref_idx_l1_active_minus1, cabac_init_idc). → (NAL, slice_type)."""
    head = nal[0]
    r = Rbsp(nal)
    r.ue()
    t = r.ue() % 5
    r.ue()
    r.u(sps["log2_max_frame_num"])
    if head & 31 == 5:
        r.ue()
    if sps["poc"] == 0:
        r.u(sps["log2_poc_lsb"])
    if t == 1:
        r.u(1)  # direct_spatial_mv_pred_flag
    active = list(pps["nref"])
    if t in (0, 1):
        override = r.take(1)
        if field and field[0] == "num_ref_idx_l1_active_minus1" and t == 1:
            active = [r.take_ue() + 1, r.take_ue() + 1] if override else active
            r.put(1, 1), r.put_ue(active[0] - 1), r.put_ue(field[1])
        else:
            r.put(override, 1)
            if override:
                active[0] = r.ue() + 1
                if t == 1:
                    active[1] = r.ue() + 1
        for lst in range(2 if t == 1 else 1):
            old = []
            if r.take(1):
                while (idc := r.take_ue()) != 3:
                    old.append((idc, r.take_ue()))
            new = (mods or {}).get(lst, old)
            r.put(bool(new), 1)
            for idc, v in new:
                r.put_ue(idc), r.put_ue(v)
            if new:
                r.put_ue(3)
        if (pps["wp"] and t == 0) or (pps["bipred"] == 1 and t == 1 and weights is None):
            r.ue(), r.ue()  # pred_weight_table copied
            for lst in range(2 if t == 1 else 1):
                for _ in range(active[lst]):
                    if r.u(1):
                        r.se(), r.se()
                    if r.u(1):
                        r.se(), r.se(), r.se(), r.se()
        if weights is not None and t == 1:
            r.out += weights(active)
    if head & 0x60:
        if head & 31 == 5:
            r.u(1), r.u(1, 1 if idr_long_term else None)
        else:
            ops = []
            if r.take(1):
                while (op := r.take_ue()) != 0:
                    args = 2 if op == 3 else 0 if op == 5 else 1
                    ops.append((op, *[r.take_ue() for _ in range(args)]))
            new = ops if marking is None else marking
            r.put(bool(new), 1)
            for op, *args in new:
                r.put_ue(op)
                for a in args:
                    r.put_ue(a)
            if new:
                r.put_ue(0)
    if pps["cabac"] and t != 2:
        idc = r.take_ue()
        r.put_ue(field[1] if field and field[0] == "cabac_init_idc" else idc)
    return r.nal(), t


def scaling_lists(r, n):
    """Copy n scaling lists (7.3.2.1.1.1)."""
    for i in range(n):
        if r.u(1):
            last = nxt = 8
            for _ in range(16 if i < 6 else 64):
                if nxt:
                    nxt = (last + r.se() + 256) % 256
                last = nxt or last


def sps_edit(nal, poc=None, matrices=None):
    """The SPS with its pic_order_cnt_type replaced (0: log2_max_poc_lsb 8;
    1: always-zero deltas, offsets -1 / 0 / [2]) and / or its
    seq_scaling_matrix replaced by `matrices` (8 entries: None absent,
    "default", or the list's values in zigzag order) → (NAL, fields)."""
    r = Rbsp(nal)
    f = {"profile": r.u(8)}
    r.u(16), r.ue()
    if f["profile"] in HIGH:
        assert r.ue() == 1  # chroma_format_idc
        r.ue(), r.ue(), r.u(1)
        if matrices is None:
            if r.u(1):
                scaling_lists(r, 8)
        else:
            assert r.take(1) == 0
            r.put(1, 1)
            for m in matrices:
                r.put(m is not None, 1)
                if m == "default":
                    r.put_se(-8)
                elif m is not None:
                    last = 8
                    for v in m:
                        r.put_se((v - last + 128) % 256 - 128)
                        last = v
    f["log2_max_frame_num"] = r.ue() + 4
    old = r.take_ue()
    assert old == 2, "the fixtures write pic_order_cnt_type 2"
    f["poc"] = old if poc is None else poc
    r.put_ue(f["poc"])
    if f["poc"] == 0:
        r.put_ue(4)
    elif f["poc"] == 1:
        r.put(1, 1), r.put_se(-1), r.put_se(0), r.put_ue(1), r.put_se(2)
    return r.nal(), f


def pps_fields(nal, second_offset_delta=0):
    """PPS fields the slice walker needs, and the PPS with its
    second_chroma_qp_index_offset moved by `second_offset_delta`."""
    r = Rbsp(nal)
    r.ue(), r.ue()
    f = {"cabac": r.u(1), "bottom": r.u(1)}
    assert r.ue() == 0
    f["nref"] = r.ue() + 1
    r.ue()
    f["wp"] = r.u(1)
    r.u(2), r.se(), r.se()
    first = r.se()
    f["dfc"], f["cip"], _ = r.u(1), r.u(1), r.u(1)
    if second_offset_delta:
        t8 = r.u(1)
        if r.u(1):
            scaling_lists(r, 6 + 2 * t8)
        r.se(first + second_offset_delta)
    return r.nal(), f


def slice_edit(nal, sps, pps, poc_lsb=None, deblock=None, mods=None, marking=None,
               non_ref=False, frame_num=None, mb=None):
    """One slice with its header fields replaced: pic_order_cnt_lsb inserted,
    disable_deblocking_filter_idc, the list modifications ((idc, value)
    pairs), the marking ((op, args) tuples), made non-reference (its marking
    dropped), frame_num; a P slice's first macroblock given by `mb` (the
    codeNums after an mb_skip_run of 0; the rest of the slice follows
    unchanged). → (NAL, num_ref_idx_active)."""
    head = nal[0]
    r = Rbsp(nal)
    r.ue()
    slice_type = r.ue() % 5
    r.ue()
    r.u(sps["log2_max_frame_num"], frame_num)
    if head & 31 == 5:
        r.ue()
    if poc_lsb is not None:
        r.put(poc_lsb, 8)
    active = None
    if slice_type == 0:
        active = r.ue() + 1 if r.u(1) else pps["nref"]
        old = []
        if r.take(1):
            while (idc := r.take_ue()) != 3:
                old.append((idc, r.take_ue()))
        new = old if mods is None else mods
        r.put(bool(new), 1)
        for idc, v in new:
            r.put_ue(idc), r.put_ue(v)
        if new:
            r.put_ue(3)
        if pps["wp"]:
            r.ue(), r.ue()
            for _ in range(active):
                if r.u(1):
                    r.se(), r.se()
                if r.u(1):
                    r.se(), r.se(), r.se(), r.se()
    if head & 0x60:
        if head & 31 == 5:
            r.u(1), r.u(1)
        else:
            ops = []
            if r.take(1):
                while (op := r.take_ue()) != 0:
                    args = 2 if op == 3 else 0 if op == 5 else 1
                    ops.append((op, *[r.take_ue() for _ in range(args)]))
            if not non_ref:
                new = ops if marking is None else marking
                r.put(bool(new), 1)
                for op, *args in new:
                    r.put_ue(op)
                    for a in args:
                        r.put_ue(a)
                if new:
                    r.put_ue(0)
    r.se()
    if pps["dfc"]:
        idc = r.take_ue()
        r.put_ue(idc if deblock is None else deblock)
        if idc != 1:
            r.se(), r.se()
        elif deblock not in (None, 1):
            r.put_se(0), r.put_se(0)
    if mb is not None:
        assert slice_type == 0
        r.take_ue()
        for v in (0, *mb):
            r.put_ue(v)
    return r.nal(bytes([head & 0x9F]) if non_ref else None), active


def edited(clip, edit):
    """`clip`'s whole stream with the hand edit `edit` applied → (plan, w, h)."""
    with pvr.VideoHandle(fixture(clip)) as hd:
        n, _, w, h = hd.info()
        plan = hd.h264_plan(list(range(n)))
    pkts = packets(plan)
    sps_nal, sps = sps_edit(pkts[0][0], poc=EDIT_POC.get(edit),
                            matrices=SPS_MATRICES if edit == "sps_matrices" else None)
    pps_nal, pps = pps_fields(pkts[0][1], 4 if edit == "second_chroma_offset" else 0)
    assert not pps["cabac"]
    pkts[0][0], pkts[0][1] = sps_nal, pps_nal
    since_idr = 0
    for i, p in enumerate(pkts):
        for j, nal in enumerate(p):
            if nal[0] & 31 not in (1, 5):
                continue
            if nal[0] & 31 == 5:
                since_idr = 0
            kw = {}
            if edit == "poc0":
                kw["poc_lsb"] = 2 * since_idr % 256
            if edit == "deblock_idc2":
                kw["deblock"] = 2
            if edit == "marking":
                kw["marking"] = MARKING.get(i)
                kw["mods"] = MODS.get(i)
            if edit == "non_ref" and i == n - 2:
                kw["non_ref"] = True
            if edit == "non_ref" and i == n - 1:
                kw["frame_num"] = slice_frame_num(nal, sps) - 1
            p[j], active = slice_edit(nal, sps, pps, **kw)
            if edit == "marking" and i in MODS:
                assert active == 3, active
        since_idr += 1
    return replan(plan, pkts), w, h


def slice_frame_num(nal, sps):
    r = Rbsp(nal)
    r.take_ue(), r.take_ue(), r.take_ue()
    return r.take(sps["log2_max_frame_num"])


def packets(plan):
    """The plan's packets, each a list of NAL units (start codes removed)."""
    out, start = [], 0
    for end in plan.pkt_end:
        data = plan.data[start:end].tobytes()
        out.append([n for n in data.split(b"\x00\x00\x00\x01") if n])
        start = int(end)
    return out


def replan(plan, pkts):
    data, ends = b"", []
    for p in pkts:
        data += b"".join(b"\x00\x00\x00\x01" + n for n in p)
        ends.append(len(data))
    return pvr.H264Plan(np.frombuffer(data, np.uint8), np.asarray(ends, np.int64),
                        plan.pkt_ts[:len(pkts)], np.asarray([len(pkts)], np.int32),
                        plan.wanted[plan.wanted < len(pkts)])


def edit_pps(nal, field):
    r = Rbsp(nal)
    r.ue(), r.ue(), r.u(1), r.u(1)  # pps / sps id, entropy_coding_mode, bottom_field_pic_order
    if field == "fmo":
        r.ue(1)  # num_slice_groups_minus1
        return r.nal()
    r.ue(), r.ue(), r.ue(), r.u(1), r.u(2), r.se(), r.se(), r.se(), r.u(1), r.u(1)
    r.u(1, 1)  # redundant_pic_cnt_present_flag
    return r.nal()


def edit_slice_type(nal, slice_type):
    r = Rbsp(nal)
    r.ue()  # first_mb_in_slice
    r.ue(slice_type)
    return r.nal()


def edit_sps_lossless(nal):
    r = Rbsp(nal)
    assert r.u(8) == 100
    r.u(8), r.u(8), r.ue(), r.ue(), r.ue(), r.ue()
    r.u(1, 1)  # qpprime_y_zero_transform_bypass_flag
    return r.nal()


def hand_made(clip, tool):
    with pvr.VideoHandle(fixture(clip)) as hd:
        n, _, w, h = hd.info()
        plan = hd.h264_plan(list(range(min(n, 6))))
    pkts = packets(plan)
    kinds = [[nal[0] & 31 for nal in p] for p in pkts]
    assert kinds[0][:2] == [7, 8] and 5 in kinds[0] and all(1 in k for k in kinds[1:])
    if tool == "fmo" or tool == "redundant":
        pkts[0][1] = edit_pps(pkts[0][1], tool)
    elif tool in ("sp", "si"):
        i = kinds[1].index(1)
        pkts[1][i] = edit_slice_type(pkts[1][i], {"sp": 3, "si": 4}[tool])
    elif tool == "partition":
        i = kinds[1].index(1)
        pkts[1][i] = bytes([pkts[1][i][0] & 0xE0 | 2]) + pkts[1][i][1:]
    elif tool == "gap":
        del pkts[1]
    elif tool == "lossless":
        pkts[0][0] = edit_sps_lossless(pkts[0][0])
    elif tool == "interlace":
        pkts[0][0] = sps_fields(pkts[0][0], frame_mbs_only=0)[0]
    return replan(plan, pkts), w, h


def test_hand_made_streams_decode_when_unedited():
    """The editing itself changes nothing: an unedited round trip through
    Rbsp decodes to oatx's pictures."""
    with pvr.VideoHandle(fixture("cbase")) as hd:
        n, _, w, h = hd.info()
        plan = hd.h264_plan(list(range(6)))
    pkts = [[Rbsp(nal).nal() for nal in p] for p in packets(plan)]
    got = h264.decode_stream(replan(plan, pkts), w, h)
    want = np.empty_like(got)
    with pvr.VideoHandle(fixture("cbase")) as hd:
        h264.decode_nv12(hd, list(range(6)), want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clip,tool,raised,named", [
    ("cbase", "fmo", pvr.UnsupportedMedia, "flexible macroblock ordering"),
    ("cbase", "redundant", pvr.UnsupportedMedia, "redundant pictures"),
    ("cbase", "sp", pvr.UnsupportedMedia, "SP / SI"),
    ("cbase", "si", pvr.UnsupportedMedia, "SP / SI"),
    ("cbase", "partition", pvr.UnsupportedMedia, "data partitioning"),
    ("cbase", "gap", pvr.UnsupportedMedia, "gaps in frame_num"),
    ("cavlc", "lossless", pvr.UnsupportedMedia, "lossless"),
    ("cmed", "interlace", pvr.UnsupportedMedia, "interlaced")])
def test_refusals_name_the_tool(clip, tool, raised, named):
    plan, w, h = hand_made(clip, tool)
    with pytest.raises(raised, match=named) as e:
        h264.decode_stream(plan, w, h)
    assert type(e.value) is raised


def malformed_b(field, value):
    """A B-frame clip's first 8 pictures (CAVLC cbcavlc.mp4, CABAC cmed.mp4
    for cabac_init_idc) with one element of every P and B slice header, or
    of the PPS, set to `value`."""
    clip = "cmed" if field == "cabac_init_idc" else "cbcavlc"
    with pvr.VideoHandle(fixture(clip)) as hd:
        w, h = hd.info()[2:]
        plan = hd.h264_plan(list(range(8)))
    pkts = packets(plan)
    _, sps = sps_fields(pkts[0][0])
    if field == "weighted_bipred_idc":
        r = Rbsp(pkts[0][1])
        r.ue(), r.ue(), r.u(1), r.u(1), r.ue(), r.ue(), r.ue(), r.u(1)
        r.u(2, value)
        pkts[0][1] = r.nal()
        return replan(plan, pkts), w, h
    _, pps = pps_fields_b(pkts[0][1])
    for p in pkts:
        for j, nal in enumerate(p):
            if nal[0] & 31 == 1:
                p[j], _ = slice_edit_b(nal, sps, pps, field=(field, value))
    return replan(plan, pkts), w, h


def malformed(field, value):
    """cbase's first 6 pictures with one syntax element set to `value`."""
    if field in ("num_ref_idx_l1_active_minus1", "cabac_init_idc", "weighted_bipred_idc"):
        return malformed_b(field, value)
    with pvr.VideoHandle(fixture("cbase")) as hd:
        n, _, w, h = hd.info()
        plan = hd.h264_plan(list(range(6)))
    pkts = packets(plan)
    r = Rbsp(pkts[0][0])
    assert r.u(8) not in HIGH
    r.u(16), r.ue()
    if field == "log2_max_frame_num_minus4":
        r.ue(value)
    elif field == "log2_max_pic_order_cnt_lsb_minus4":
        r.ue()
        assert r.take_ue() == 2
        r.put_ue(0), r.put_ue(value)  # pic_order_cnt_type 0
    pkts[0][0] = r.nal()
    if field == "seq_parameter_set_id":
        r = Rbsp(pkts[0][1])
        r.ue(), r.ue(value)
        pkts[0][1] = r.nal()
    i = next(j for j, nal in enumerate(pkts[4]) if nal[0] & 31 == 1)
    if field in ("first_mb_in_slice", "pic_parameter_set_id"):
        r = Rbsp(pkts[4][i])
        r.ue(value if field == "first_mb_in_slice" else None), r.ue()
        if field == "pic_parameter_set_id":
            r.ue(value)
        pkts[4][i] = r.nal()
    elif field in ("mb_type", "ref_idx"):
        mb = (value,) if field == "mb_type" else (0, value)  # P_L0_16x16, then ref_idx_l0
        (_, sps), (_, pps) = sps_edit(pkts[0][0]), pps_fields(pkts[0][1])
        pkts[4][i], active = slice_edit(pkts[4][i], sps, pps, mb=mb)
        assert active == 3, "ref_idx is read as te(v) over 3 references"
    return replan(plan, pkts), w, h


# (syntax element, a value past its range, the error's words); 2^31 and up
# would be negative as an int
MALFORMED = [
    ("log2_max_frame_num_minus4", 13, "log2_max_frame_num_minus4 out of range"),
    ("log2_max_pic_order_cnt_lsb_minus4", 13, "log2_max_pic_order_cnt_lsb_minus4 out of range"),
    ("seq_parameter_set_id", 2 ** 31, "PPS names a missing SPS"),
    ("first_mb_in_slice", 2 ** 31, "first_mb_in_slice out of range"),
    ("first_mb_in_slice", 2 ** 32 - 2, "first_mb_in_slice out of range"),
    ("pic_parameter_set_id", 2 ** 31, "slice names a missing PPS"),
    ("mb_type", 31, "mb_type out of range"),
    ("mb_type", 2 ** 31, "mb_type out of range"),
    ("ref_idx", 3, "ref_idx out of range"),
    ("ref_idx", 2 ** 31, "ref_idx out of range"),
    ("num_ref_idx_l1_active_minus1", 16, "num_ref_idx_l1_active_minus1 out of range"),
    ("cabac_init_idc", 3, "cabac_init_idc out of range"),
    ("weighted_bipred_idc", 3, "weighted_bipred_idc out of range"),
]


@pytest.mark.parametrize("field,value,named", MALFORMED,
                         ids=[f"{f}={v}" for f, v, _ in MALFORMED])
def test_out_of_range_fields_raise_decode_error(field, value, named):
    """A syntax element past its range in 7.4 raises DecodeError, which lax
    loading skips, and is never used as an index or a shift."""
    plan, w, h = malformed(field, value)
    with pytest.raises(pvr.DecodeError, match=named):
        h264.decode_stream(plan, w, h)


# ---------------------------------------------------- hand-edited streams

EDIT_POC = {"poc0": 0, "poc1": 1}
# seq_scaling_matrix lists 0-7: explicit, use-default, absent (fall-back rule A)
SPS_MATRICES = [[10 + j for j in range(16)], "default", None, [12 + j // 2 for j in range(16)],
                None, [20 - j // 2 for j in range(16)], [8 + j // 4 for j in range(64)], "default"]
# cbase's first gop (IDR at 0, P 1-11, 3 references): by decode index, the
# marking (memory_management_control_operation, its arguments) and list
# modifications that walk every MMCO and long-term path with 3 references
# held throughout: f3 drops f0, allows long-term 0-1, becomes long-term 0;
# f6 makes f5 long-term 1 and drops f4; f8 drops long-term 0 (f3); f9 lists
# f7 (idc 0), f8 (idc 1), long-term 1 (idc 2); f11 ends it all (MMCO 5).
MARKING = {3: [(1, 2), (4, 2), (6, 0)], 6: [(3, 0, 1), (1, 1)], 8: [(2, 0)], 11: [(5,)]}
MODS = {9: [(0, 1), (1, 0), (2, 1)]}
# edit → (clip, the counters it must reach)
EDITS = {
    "deblock_idc2": ("cavlc", ["deblock_idc2", "slice_edge_kept"]),
    "second_chroma_offset": ("cavlc", ["second_chroma_qp_offset"]),
    "sps_matrices": ("cavlc", ["sps_scaling_matrix", "scaling_explicit", "scaling_use_default",
                               "scaling_fallback_b"]),
    "poc0": ("cbase", ["poc_type0"]),
    "poc1": ("cbase", ["poc_type1"]),
    "marking": ("cbase", ["mmco1", "mmco2", "mmco3", "mmco4", "mmco5", "mmco6",
                          "long_term_refs", "list_mod_idc1", "list_mod_idc2"]),
    "non_ref": ("cbase", ["non_ref_pictures"]),
}


def decode_edit(edit, counters=None):
    clip, _ = EDITS[edit]
    plan, w, h = edited(clip, edit)
    return plan, h264.decode_stream(plan, w, h, counters), w, h


@pytest.mark.parametrize("edit", list(EDITS))
def test_edited_streams_match_oatx(tmp_path, edit):
    """Streams edited by hand to reach what x264 never writes without
    CABAC and B slices, decoded by both packages from the same bytes:
    bitwise equal, and the edit reached its tools."""
    from oatx_torch.ops.kernels.nv12_rgb import nv12_to_rgb_plain

    counters = {}
    plan, nv12, w, h = decode_edit(edit, counters)
    missed = [k for k in EDITS[edit][1] if not counters[k]]
    assert not missed, f"{edit} did not reach {missed}"
    got = nv12_to_rgb_plain(torch.from_numpy(nv12), w, h, False).numpy()
    path = tmp_path / "edited.h264"
    path.write_bytes(plan.data.tobytes())
    want = jvr.decode_indices(str(path), list(range(len(plan.wanted))), 0)
    bad = [i for i in range(len(got)) if not np.array_equal(got[i], want[i])]
    assert not bad, f"{edit}: frames {bad} differ from oatx's decode of the same stream"
    if edit in ("deblock_idc2", "second_chroma_offset", "sps_matrices", "marking"):
        with pvr.VideoHandle(fixture(EDITS[edit][0])) as hd:
            plain = np.empty_like(nv12)
            h264.decode_nv12(hd, list(range(len(plain))), plain)
        assert not np.array_equal(plain, nv12), f"{edit} changed no sample"
    if edit == "non_ref":  # the non-reference picture skipped when not wanted
        n = len(plan.wanted)
        keep = np.asarray([i for i in range(n) if i != n - 2])
        part = h264.decode_stream(plan._replace(wanted=keep), w, h)
        np.testing.assert_array_equal(part, nv12[keep])


# ----------------------------------------------------------------- dataset

def test_lax_webvid_over_cavlc_clips_matches_oatx(tmp_path):
    from oatx.config.schema import DataLoaderCfg as JCfg
    from oatx.data import factory as jfactory
    from oatx_torch.config.schema import DataLoaderCfg as PCfg
    from oatx_torch.data import factory as pfactory

    root = tmp_path / "webvid"
    (root / "meta_data").mkdir(parents=True)
    (root / "train").mkdir()
    rows = ["caption\tvideoid"]
    clips = ["cfour", "cbase", "four", "cmed", "cfour", "high"]  # CAVLC, then CABAC with B
    for i, clip in enumerate(clips):
        shutil.copy(fixture(clip), root / "train" / f"{200 + i}.mp4")
        rows.append(f"clip {i} from {clip}\t{200 + i}")
    (root / "meta_data" / "webvid_training_success_full.tsv").write_text("\n".join(rows) + "\n")
    args = dict(dataset_name="WebVid", data_dir=str(root), split="train",
                video_params={"num_frames": 4, "loading": "lax"})
    jds = jfactory.build_dataset(JCfg(**args), "baseline", "train")
    pds = pfactory.build_dataset(PCfg(**args), "baseline", "train", device="cpu")
    assert len(pds) == len(jds) == len(clips)
    for i in range(len(clips)):
        a = jds.get_sample(i, np.random.default_rng((0, i)))
        b = pds.get_sample(i, np.random.default_rng((0, i)))
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(b["video"], a["video"])
        assert a["text"] == b["text"]
