"""Anchor and shift (point) generation — precomputed, shape-static.

Equivalents of detectron2 ``DefaultAnchorGenerator`` (RetinaNet/RPN anchors)
and cvpods ``ShiftGenerator`` (FCOS/ATSS/POTO point grids; reference
thirdparty_heads/fcos.py:97). Grids depend only on the (static) padded
feature-map sizes, so they are computed once per canvas in numpy
and copied to the device once per canvas — no device work per step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def generate_cell_anchors(sizes, aspect_ratios) -> np.ndarray:
    """(A, 4) anchors centered at origin; detectron2 convention:
    area = size^2, w = sqrt(area/ar), h = ar * w."""
    anchors = []
    for size in sizes:
        area = size ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, np.float32)


def grid_anchors(
    grid_hw: Tuple[int, int], stride: int, cell_anchors: np.ndarray,
    offset: float = 0.0,
) -> np.ndarray:
    """(H*W*A, 4) anchors for one level (x1y1x2y2)."""
    h, w = grid_hw
    shifts_x = (np.arange(w) + offset) * stride
    shifts_y = (np.arange(h) + offset) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)  # (h, w)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    out = shifts + cell_anchors[None, :, :]
    return out.reshape(-1, 4).astype(np.float32)


class AnchorGenerator:
    """Per-level anchors. sizes/aspect_ratios follow detectron2 broadcasting:
    one entry per level, or a single entry shared by all levels."""

    def __init__(self, sizes, aspect_ratios, strides: Sequence[int],
                 offset: float = 0.0):
        num_levels = len(strides)
        if len(sizes) == 1:
            sizes = list(sizes) * num_levels
        if len(aspect_ratios) == 1:
            aspect_ratios = list(aspect_ratios) * num_levels
        assert len(sizes) == num_levels and len(aspect_ratios) == num_levels
        self.strides = list(strides)
        self.offset = offset
        self.cell_anchors = [
            generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)
        ]

    @property
    def num_anchors_per_location(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def __call__(self, grid_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        return [
            grid_anchors(hw, s, c, self.offset)
            for hw, s, c in zip(grid_sizes, self.strides, self.cell_anchors)
        ]


class ShiftGenerator:
    """cvpods ShiftGenerator: per-level point grids at (x+offset)*stride.
    NUM_SHIFTS repeats each point (reference SHIFT_GENERATOR.NUM_SHIFTS=1)."""

    def __init__(self, strides: Sequence[int], num_shifts: int = 1,
                 offset: float = 0.5):
        self.strides = list(strides)
        self.num_shifts = num_shifts
        self.offset = offset

    def __call__(self, grid_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        out = []
        for (h, w), stride in zip(grid_sizes, self.strides):
            shifts_x = (np.arange(w) + self.offset) * stride
            shifts_y = (np.arange(h) + self.offset) * stride
            sx, sy = np.meshgrid(shifts_x, shifts_y)
            pts = np.stack([sx, sy], axis=-1).reshape(-1, 2)
            pts = np.repeat(pts, self.num_shifts, axis=0)
            out.append(pts.astype(np.float32))
        return out


def feature_grid_sizes(padded_hw: Tuple[int, int], strides: Sequence[int]):
    """Grid sizes for a padded input of (H, W) at the given strides,
    matching ceil-division conv output sizes."""
    H, W = padded_hw
    return [(-(-H // s), -(-W // s)) for s in strides]
