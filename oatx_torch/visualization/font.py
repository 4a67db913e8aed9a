"""A small bitmap font for the renderers' labels and caption strips.

oatx draws its text with `ImageDraw.text` in PIL's default font, which
cannot be rebuilt without PIL. The port draws the same strings at the same
anchors in the same colour with this font instead: printable ASCII in
cells of 6 × 8 pixels (a 5-pixel glyph and a column of space), each glyph
five column bytes, bit 0 the top row, bit 7 the lowest (descenders). A
character outside the table is drawn as '?'. The pixels differ from PIL's
inside the text boxes and nowhere else (tests/test_torch_viz.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

CELL_W, CELL_H = 6, 8

# printable ASCII from ' ' (0x20) to '~' (0x7e): five column bytes a glyph
_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462"
    "3649562050" "0008070300" "001c224100" "0041221c00" "2a1c7f1c2a" "08083e0808"
    "0080703000" "0808080808" "0000606000" "2010080402" "3e5149453e" "00427f4000"
    "7249494946" "2141494d33" "1814127f10" "2745454539" "3c4a494931" "4121110907"
    "3649494936" "464949291e" "0000140000" "0040340000" "0008142241" "1414141414"
    "0041221408" "0201590906" "3e415d594e" "7c1211127c" "7f49494936" "3e41414122"
    "7f4141413e" "7f49494941" "7f09090901" "3e41415173" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f021c027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "2649494932" "03017f0103" "3f4040403f"
    "1f2040201f" "3f4038403f" "6314081463" "0304780403" "6159494d43" "007f414141"
    "0204081020" "004141417f" "0402010204" "4040404040" "0003070800" "2054547840"
    "7f28444438" "3844444428" "384444287f" "3854545418" "00087e0902" "18a4a4a47c"
    "7f08040478" "00447d4000" "2040403d00" "7f10284400" "00417f4000" "7c0478047c"
    "7c08040478" "3844444438" "fc24242418" "18242424fc" "7c08040408" "4854545424"
    "04043f4424" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "1ca0a0a07c"
    "4464544c44" "0008364100" "0000770000" "0041360800" "0201020402"
)
_FIRST, _LAST = 0x20, 0x7E
_BITS = np.unpackbits(np.frombuffer(_GLYPHS, np.uint8).reshape(-1, 5, 1), axis=2,
                      bitorder="little")  # (glyphs, column, row)


def text_box(xy: Tuple[float, float], text: str) -> Tuple[int, int, int, int]:
    """The pixels `draw_text` may set: (left, top, right, bottom), right and
    bottom exclusive."""
    x, y = int(xy[0]), int(xy[1])
    return x, y, x + CELL_W * len(text), y + CELL_H


def draw_text(img: np.ndarray, xy: Tuple[float, float], text: str,
              fill: Sequence[int]) -> np.ndarray:
    """Draw `text` into the (H, W, 3) uint8 `img` in place, its top-left
    cell at `xy` (truncated to whole pixels), clipped to the image; → img."""
    x0, y0 = int(xy[0]), int(xy[1])
    h, w = img.shape[:2]
    colour = np.asarray(fill, np.uint8)
    for i, ch in enumerate(text):
        code = ord(ch)
        glyph = _BITS[(code if _FIRST <= code <= _LAST else ord("?")) - _FIRST]
        cols, rows = np.nonzero(glyph)
        xs, ys = x0 + CELL_W * i + cols, y0 + rows
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        img[ys[keep], xs[keep]] = colour
    return img
