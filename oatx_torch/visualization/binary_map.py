"""Region-grounding binary maps (port of oatx/visualization/binary_map.py;
the reference's test_region_mem.py:128-170).

For the top object of a sample: [object frame | GT patch mask | predicted
region similarity], each 224², side by side in one PNG, the qualitative
check that region_mem's region BCE grounds objects. The frame is resized
by PIL's BILINEAR (data/host_transforms.pil_bilinear_resize), the two maps
by its mode-"F" resize, as oatx's; the label is drawn in the port's bitmap
font (visualization/heatmap.py says why).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from oatx_torch.data.host_transforms import pil_bilinear_resize
from oatx_torch.visualization.font import draw_text
from oatx_torch.visualization.heatmap import RED, bilinear_upsample
from oatx_torch.visualization.png import write_png


def _gray_panel(grid: np.ndarray, size: int) -> np.ndarray:
    """A grid of values in [0, 1] → (size, size, 3) uint8 grey render."""
    up = np.clip(bilinear_upsample(np.asarray(grid, np.float32) * 255.0, size, size), 0, 255)
    return np.stack([up.astype(np.uint8)] * 3, axis=-1)


def render_binary_map(frame_rgb: np.ndarray, gt_patch_mask: np.ndarray,
                      pred_region_sim: np.ndarray, label: Optional[str] = None,
                      size: int = 224) -> np.ndarray:
    """frame (H, W, 3) uint8, GT mask (N,), predicted similarity (N,) in
    [0, 1] → the [frame | gt | pred] uint8 panel."""
    g = int(round(np.sqrt(gt_patch_mask.size)))
    frame = pil_bilinear_resize(np.asarray(frame_rgb, np.uint8), size, size)
    if label:
        draw_text(frame, (8, 8), label, RED)
    gt = _gray_panel(gt_patch_mask.reshape(g, g), size)
    pred = _gray_panel(np.asarray(pred_region_sim, np.float32).reshape(g, g), size)
    return np.concatenate([frame, gt, pred], axis=1)


def save_binary_map(path: str, frame_rgb, gt_patch_mask, pred_region_sim,
                    label: Optional[str] = None) -> str:
    return write_png(path, render_binary_map(frame_rgb, gt_patch_mask, pred_region_sim,
                                             label))
