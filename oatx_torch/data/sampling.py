"""Frame index sampling (the port's own copy of oatx/data/sampling.py).

The video is split into `num_frames` equal intervals and one index is drawn
per interval: at random ('rand'), at the interval midpoint ('uniform'), or
at a fixed offset from the interval start (`fix_start`). Randomness comes
from an explicit `numpy.random.Generator`; an interval narrower than 2
falls back to its start.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def sample_frames(num_frames: int, vlen: int, sample: str = "rand",
                  fix_start: Optional[int] = None,
                  rng: Optional[np.random.Generator] = None) -> List[int]:
    """Pick `min(num_frames, vlen)` frame indices in [0, vlen)."""
    if vlen <= 0:
        raise ValueError(f"vlen must be positive, got {vlen}")
    acc_samples = min(num_frames, vlen)
    intervals = np.linspace(start=0, stop=vlen, num=acc_samples + 1).astype(int)
    starts = intervals[:-1]
    ends = intervals[1:] - 1  # interval [start, next_start - 1]

    if fix_start is not None:
        idxs = starts + int(fix_start)
    elif sample == "rand":
        if rng is None:
            rng = np.random.default_rng()
        highs = np.maximum(ends, starts + 1)  # high exclusive
        idxs = rng.integers(low=starts, high=highs)
    elif sample == "uniform":
        idxs = (starts + ends) // 2
    else:
        raise NotImplementedError(f"unknown sampling mode: {sample!r}")
    return [int(i) for i in np.clip(idxs, 0, vlen - 1)]


def aligned_object_frame_index(frame_idxs: Sequence[int], vlen: int,
                               num_extraction_frames: int = 8) -> int:
    """The slot in [0, num_extraction_frames) of the offline extractor's
    uniform grid nearest the clip's first sampled frame: the object frame
    that goes with the clip."""
    grid = sample_frames(num_extraction_frames, vlen, sample="uniform")
    anchor = frame_idxs[0] if len(frame_idxs) else 0
    return int(np.argmin([abs(g - anchor) for g in grid]))
