"""Write the H.264 fixtures of the port's mp4 reader, and oatx's frames.

    python tests/torch_h264/make_fixtures.py [CLIP ...]

(every clip without arguments). Needs oatx's FFmpeg reader (oatx/native,
libx264) and, for the encoded clips, FFmpeg's headers and a C++ compiler:
run where FFmpeg is installed; the files it writes are committed, and the
card's machine, which has no FFmpeg, reads them. It writes into this
directory:

  high.mp4  596×336, 50 frames at 25 fps: an MJPEG clip of oatx's test
            pattern (seed 2) through `transcode(..., "libx264", gop=25)`:
            x264 veryfast, High profile, CABAC with B-frames (`ctts`, an
            edit list), WebVid's usual size, cropped from a coded 608×336;
  base.mp4  320×240, 16 frames at 8 fps, `write_test_video(..., codec=
            "libx264", gop=4)`: Constrained Baseline, no B-frames;
  one.mp4   128×96, a single frame (the same writer);
  four.mp4  596×336, 4 frames (seed 3) through the same transcode: a clip
            whose 4-frame 'rand' sample is every frame, so a training batch
            over it reads known frames;

and the clips the port's host decoder is held to tool by tool
(native/h264.h), written by encode.cpp (libx264 through libavcodec with an
x264-params string; built here into a temporary directory) from its own
synthetic content:

  cavlc.mp4  596×336 (coded 608×336), 50 frames at 25 fps, High profile,
             CAVLC_PARAMS: 8×8 transform, every partition, 3 references,
             weighted prediction, 4 slices, deblocking offsets, JVT matrices;
  cbase.mp4  320×240, 24 frames, Constrained Baseline, every partition,
             3 references, deblocking 2,2, constrained intra prediction;
  cfour.mp4  596×336, 4 frames, cavlc.mp4's options (a training batch's clip);
  cpcm.mp4   32×16, 2 frames of noise at qp 10: I_PCM beside I_8x8 and P;
  cmed.mp4   596×336, 50 frames, x264's default preset (medium: CABAC,
             3 B-frames, B-pyramid, implicit weights, weighted P, 3
             references, 8×8 transform, spatial direct), gop 25;
  ctemp.mp4  320×240, 30 frames, medium with temporal direct and
             cabac_init_idc 2;
  cbcavlc.mp4 320×240, 30 frames, CAVLC B slices with B-pyramid, temporal
             direct, implicit weights, every P partition, no 8×8 transform
             (the hand edits' base: explicit bi-prediction,
             direct_8x8_inference_flag 0, long-term references);
  cpcmb.mp4  32×16, 4 frames of noise at qp 10 with CABAC and a B-frame:
             I_PCM inside CABAC slice data;
  cidc1.mp4  128×96, 12 frames, cabac_init_idc 1 without the 8×8 transform;
  copen.mp4  128×96, 30 frames, open GOP (recovery-point I pictures every
             10 frames, leading B pictures);

and, for each clip, <clip>.npz of oatx's decode (`decode_indices`) at
the short sides of SHORT_SIDES: `probe` oatx's (frames, fps, width,
height) and `s<ss>_means` every frame's mean per channel (float64, n × 3);
base.mp4 and one.mp4 also keep frames, `s<ss>_idx` the indices whose
frames are stored (`stored`) and `s<ss>_frames` those frames; every other
clip keeps `s<ss>_sha256` (n, 32) uint8, the SHA-256 of each frame's RGB
bytes (the folder stays under 1 MiB). tests/test_torch_mp4.py holds the
stored frames against a fresh decode by oatx, and chip_smoke.py's decode
phase holds the card's decode against them.
"""

import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

SHORT_SIDES = {"high": (0, 224), "base": (0, 224), "one": (0, 224, 256), "four": (0, 256),
               "cavlc": (0, 224), "cbase": (0, 224, 256), "cfour": (0, 224, 256),
               "cpcm": (0, 224), "cmed": (0, 224, 256), "ctemp": (0, 224), "cbcavlc": (0, 224),
               "cpcmb": (0, 224), "cidc1": (0, 224), "copen": (0, 224)}
OLD = ("high", "base", "one", "four")
FRAMES = ("base", "one")  # clips whose npz keeps frames; the others keep digests
CAVLC_PARAMS = ("cabac=0:bframes=0:8x8dct=1:partitions=all:ref=3:mixed-refs=1:weightp=2:"
                "deblock=-1,-1:slices=4:keyint=25:cqm=jvt")
# clip → (width, height, frames, fps, profile, crf, seed, x264-params[, "noise"])
ENCODED = {"cavlc": (596, 336, 50, 25, "high", 46, 5, CAVLC_PARAMS),
           "cbase": (320, 240, 24, 25, "baseline", 42, 6,
                     "partitions=all:ref=3:deblock=2,2:constrained-intra=1:keyint=12"),
           "cfour": (596, 336, 4, 25, "high", 42, 7, CAVLC_PARAMS),
           "cpcm": (32, 16, 2, 25, "high", 20, 1, "qp=10:psy=0:subme=9:trellis=0:cabac=0:"
                    "bframes=0:8x8dct=1", "noise"),
           "cmed": (596, 336, 50, 25, "high", 40, 8, "keyint=25"),
           "ctemp": (320, 240, 30, 25, "high", 36, 9, "direct=temporal:cabac-idc=2:keyint=25"),
           "cbcavlc": (320, 240, 30, 25, "high", 36, 10,
                       "cabac=0:bframes=3:b-pyramid=normal:direct=temporal:8x8dct=0:weightp=0:"
                       "ref=3:partitions=all:keyint=25"),
           "cpcmb": (32, 16, 4, 25, "high", 20, 2, "qp=10:psy=0:subme=9:trellis=0:bframes=1:"
                     "8x8dct=1", "noise"),
           "cidc1": (128, 96, 12, 25, "high", 30, 11, "cabac-idc=1:8x8dct=0:bframes=2:keyint=12"),
           "copen": (128, 96, 30, 25, "high", 30, 12, "open-gop=1:bframes=3:keyint=10:"
                     "min-keyint=10:scenecut=0")}


def samples(n):
    """The indices read of an n-frame clip: 4 'rand' (numpy seed 0), 4
    'uniform', and past the end (the port's sampler, oatx's copied: the
    card's machine reads these lists through chip_smoke.py)."""
    from oatx_torch.data.sampling import sample_frames

    rand = sample_frames(4, n, "rand", rng=np.random.default_rng(0))
    uniform = sample_frames(4, n, "uniform")
    return {"rand": rand, "uniform": uniform, "past_end": [n - 1, n, n + 7, 10 * n]}


def stored(clip, n, ss):
    """The indices whose frames are stored (clips of FRAMES), the folder
    kept under 1 MiB: every frame of one.mp4 and of base.mp4 at the native
    size; else the last frame with the 'rand' sample."""
    if clip == "one" or (clip, ss) == ("base", 0):
        return list(range(n))
    return sorted(set(samples(n)["rand"]) | {n - 1})


def digest(frame) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(np.ascontiguousarray(frame).tobytes()).digest(),
                         np.uint8)


def write_encoded(clips):
    """Build encode.cpp into a temporary directory and write `clips` (of
    ENCODED) with it, then their digests."""
    from oatx.data import video_reader as jvr

    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "encode")
        subprocess.run([os.environ.get("CXX", "c++"), "-O2", "-std=c++17", "-o", exe,
                        os.path.join(HERE, "encode.cpp"), "-lavformat", "-lavcodec",
                        "-lavutil"], check=True)
        for clip in clips:
            w, h, n, fps, profile, crf, seed, *params = ENCODED[clip]
            subprocess.run([exe, os.path.join(HERE, f"{clip}.mp4"), str(w), str(h), str(n),
                            str(fps), profile, str(crf), str(seed), *params], check=True,
                           stderr=subprocess.DEVNULL)
    write_npz(clips)


def write_npz(clips):
    from oatx.data import video_reader as jvr

    for clip in clips:
        path = os.path.join(HERE, f"{clip}.mp4")
        probe = jvr.probe(path)
        n = probe[0]
        out = {"probe": np.asarray(probe, np.float64)}
        for ss in SHORT_SIDES[clip]:
            every = jvr.decode_indices(path, list(range(n)), ss)
            out[f"s{ss}_means"] = every.reshape(n, -1, 3).mean(1)
            if clip in FRAMES:
                idx = stored(clip, n, ss)
                out[f"s{ss}_idx"] = np.asarray(idx, np.int64)
                out[f"s{ss}_frames"] = jvr.decode_indices(path, idx, ss)
            else:
                out[f"s{ss}_sha256"] = np.stack([digest(f) for f in every])
        np.savez_compressed(os.path.join(HERE, f"{clip}.npz"), **out)


def main(clips=None):
    clips = list(clips or (*OLD, *ENCODED))
    if any(c in ENCODED for c in clips):
        write_encoded([c for c in clips if c in ENCODED])
    if any(c in OLD for c in clips):
        write_old([c for c in clips if c in OLD])
    total = sum(os.path.getsize(os.path.join(HERE, f)) for f in os.listdir(HERE))
    print(f"wrote {sorted(os.listdir(HERE))}: {total} bytes")


def write_old(clips):
    from oatx.data import video_reader as jvr

    with tempfile.TemporaryDirectory() as tmp:
        for name, seed, frames in (("high", 2, 50), ("four", 3, 4)):
            if name not in clips:
                continue
            src = os.path.join(tmp, f"{name}.avi")
            jvr.write_test_video(src, 596, 336, frames, 25, seed=seed)
            jvr.transcode(src, os.path.join(HERE, f"{name}.mp4"), "libx264", gop=25)
    if "base" in clips:
        jvr.write_test_video(os.path.join(HERE, "base.mp4"), 320, 240, 16, 8, seed=1,
                             codec="libx264", gop=4)
    if "one" in clips:
        jvr.write_test_video(os.path.join(HERE, "one.mp4"), 128, 96, 1, 8, seed=4,
                             codec="libx264", gop=4)
    write_npz(clips)


if __name__ == "__main__":
    main(sys.argv[1:])
