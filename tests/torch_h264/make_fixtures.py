"""Write the H.264 fixtures of the port's mp4 reader, and oatx's frames.

    python tests/torch_h264/make_fixtures.py

Needs oatx's FFmpeg reader (oatx/native, libx264): run where FFmpeg is
installed; the files it writes are committed, and the card's machine, which
has no FFmpeg, reads them. It writes into this directory:

  high.mp4  596×336, 50 frames at 25 fps: an MJPEG clip of oatx's test
            pattern (seed 2) through `transcode(..., "libx264", gop=25)`:
            High profile with B-frames (`ctts`, an edit list), WebVid's
            usual size, cropped from a coded 608×336;
  base.mp4  320×240, 16 frames at 8 fps, `write_test_video(..., codec=
            "libx264", gop=4)`: Constrained Baseline, no B-frames;
  one.mp4   128×96, a single frame (the same writer);
  four.mp4  596×336, 4 frames (seed 3) through the same transcode: a clip
            whose 4-frame 'rand' sample is every frame, so a training batch
            over it reads known frames;

and, for each clip, <clip>.npz of oatx's decode (`decode_indices`) at
the short sides of SHORT_SIDES (0 and 224; four.mp4 and one.mp4 also at
256, the datasets' canonical side): `s<ss>_idx` the indices whose frames
are stored (`stored`), `s<ss>_frames` those frames, `s<ss>_means` every
frame's mean per channel (float64, n × 3) and `probe` oatx's (frames, fps,
width, height). tests/test_torch_mp4.py
holds the stored frames against a fresh decode by oatx, and chip_smoke.py's
decode phase holds the card's decode against them.
"""

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

SHORT_SIDES = {"high": (0, 224), "base": (0, 224), "one": (0, 224, 256), "four": (0, 256)}


def samples(n):
    """The indices read of an n-frame clip: 4 'rand' (numpy seed 0), 4
    'uniform', and past the end (the port's sampler, oatx's copied: the
    card's machine reads these lists through chip_smoke.py)."""
    from oatx_torch.data.sampling import sample_frames

    rand = sample_frames(4, n, "rand", rng=np.random.default_rng(0))
    uniform = sample_frames(4, n, "uniform")
    return {"rand": rand, "uniform": uniform, "past_end": [n - 1, n, n + 7, 10 * n]}


def stored(clip, n, ss):
    """The indices whose frames are stored, the folder kept under 1 MB:
    every frame of one.mp4, of four.mp4 at 256 and of base.mp4 at the
    native size; the first and the last of four.mp4 at the native size;
    else the last frame with the 'uniform' sample at the native size and
    the 'rand' sample at 224."""
    if clip == "one" or (clip, ss) in (("four", 256), ("base", 0)):
        return list(range(n))
    if clip == "four":
        return [0, n - 1]
    s = samples(n)
    return sorted(set(s["uniform" if ss == 0 else "rand"]) | {n - 1})


def main():
    from oatx.data import video_reader as jvr

    with tempfile.TemporaryDirectory() as tmp:
        for name, seed, frames in (("high", 2, 50), ("four", 3, 4)):
            src = os.path.join(tmp, f"{name}.avi")
            jvr.write_test_video(src, 596, 336, frames, 25, seed=seed)
            jvr.transcode(src, os.path.join(HERE, f"{name}.mp4"), "libx264", gop=25)
    jvr.write_test_video(os.path.join(HERE, "base.mp4"), 320, 240, 16, 8, seed=1,
                         codec="libx264", gop=4)
    jvr.write_test_video(os.path.join(HERE, "one.mp4"), 128, 96, 1, 8, seed=4,
                         codec="libx264", gop=4)
    for clip in ("high", "base", "one", "four"):
        path = os.path.join(HERE, f"{clip}.mp4")
        probe = jvr.probe(path)
        n = probe[0]
        out = {"probe": np.asarray(probe, np.float64)}
        for ss in SHORT_SIDES[clip]:
            every = jvr.decode_indices(path, list(range(n)), ss)
            idx = stored(clip, n, ss)
            out[f"s{ss}_idx"] = np.asarray(idx, np.int64)
            out[f"s{ss}_frames"] = jvr.decode_indices(path, idx, ss)
            out[f"s{ss}_means"] = every.reshape(n, -1, 3).mean(1)
        np.savez_compressed(os.path.join(HERE, f"{clip}.npz"), **out)
    total = sum(os.path.getsize(os.path.join(HERE, f)) for f in os.listdir(HERE))
    print(f"wrote {sorted(os.listdir(HERE))}: {total} bytes")


if __name__ == "__main__":
    main()
