"""Mask utilities for segm evaluation, on the host in numpy and cv2 (the
port's copy of lgd_tpu/evaluation/mask_utils.py).

They stand in for the pycocotools RLE core: a detection's mask is kept as
its box and its 28x28 probability grid, and its IoU against a polygon GT
is computed over the pair's union bounding region only, never over dense
full-image masks.
"""

from __future__ import annotations

from typing import List, Tuple

import cv2
import numpy as np


def paste_mask_region(box, mask28, region_xywh, thresh: float = 0.5
                      ) -> np.ndarray:
    """Paste a (m, m) prob grid (defined over `box` x1y1x2y2) into a target
    region (x, y, w, h); returns (h, w) bool."""
    x, y, w, h = region_xywh
    x1, y1, x2, y2 = box
    bw = max(x2 - x1, 1e-3)
    bh = max(y2 - y1, 1e-3)
    m = mask28.shape[0]
    # target pixel centers in mask-grid coordinates
    xs = (np.arange(w) + x + 0.5 - x1) / bw * m - 0.5
    ys = (np.arange(h) + y + 0.5 - y1) / bh * m - 0.5
    valid_x = (xs > -1) & (xs < m)
    valid_y = (ys > -1) & (ys < m)
    xs_c = np.clip(xs, 0, m - 1)
    ys_c = np.clip(ys, 0, m - 1)
    x0 = np.floor(xs_c).astype(np.int64)
    y0 = np.floor(ys_c).astype(np.int64)
    x1i = np.minimum(x0 + 1, m - 1)
    y1i = np.minimum(y0 + 1, m - 1)
    fx = xs_c - x0
    fy = ys_c - y0
    g = (
        mask28[np.ix_(y0, x0)] * (1 - fy)[:, None] * (1 - fx)[None]
        + mask28[np.ix_(y0, x1i)] * (1 - fy)[:, None] * fx[None]
        + mask28[np.ix_(y1i, x0)] * fy[:, None] * (1 - fx)[None]
        + mask28[np.ix_(y1i, x1i)] * fy[:, None] * fx[None]
    )
    out = (g >= thresh) & valid_y[:, None] & valid_x[None]
    return out


def rasterize_polygons_region(polygons: List, region_xywh) -> np.ndarray:
    """Rasterize polygon list into a region (x, y, w, h) -> (h, w) bool."""
    x, y, w, h = region_xywh
    mask = np.zeros((h, w), np.uint8)
    pts = []
    for p in polygons:
        q = np.asarray(p, np.float64).reshape(-1, 2).copy()
        q[:, 0] -= x
        q[:, 1] -= y
        if len(q) >= 3:
            pts.append(np.round(q).astype(np.int32))
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


def polygon_area(polygons: List) -> float:
    a = 0.0
    for p in polygons:
        q = np.asarray(p, np.float64).reshape(-1, 2)
        if len(q) >= 3:
            x, y = q[:, 0], q[:, 1]
            a += 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
    return a


def polygon_bbox(polygons: List) -> Tuple[float, float, float, float]:
    pts = np.concatenate(
        [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons
         if len(p) >= 6], axis=0)
    x1, y1 = pts.min(0)
    x2, y2 = pts.max(0)
    return float(x1), float(y1), float(x2), float(y2)


def mask_iou_det_gt(det_box, det_mask28, gt_polygons, gt_crowd: bool
                    ) -> float:
    """Exact IoU between a pasted detection mask and a polygon GT, computed
    over their union bounding region (crowd -> IoA, pycocotools semantics)."""
    try:
        gx1, gy1, gx2, gy2 = polygon_bbox(gt_polygons)
    except ValueError:
        return 0.0
    x1 = min(det_box[0], gx1)
    y1 = min(det_box[1], gy1)
    x2 = max(det_box[2], gx2)
    y2 = max(det_box[3], gy2)
    x, y = int(np.floor(x1)), int(np.floor(y1))
    w = max(int(np.ceil(x2)) - x, 1)
    h = max(int(np.ceil(y2)) - y, 1)
    # bound region cost
    scale = 1.0
    MAXR = 512
    if max(w, h) > MAXR:
        scale = MAXR / max(w, h)
    rw, rh = max(int(w * scale), 1), max(int(h * scale), 1)
    sbox = [(det_box[0] - x) * scale, (det_box[1] - y) * scale,
            (det_box[2] - x) * scale, (det_box[3] - y) * scale]
    d = paste_mask_region(sbox, det_mask28, (0, 0, rw, rh))
    gpolys = [
        ((np.asarray(p, np.float64).reshape(-1, 2)
          - np.asarray([x, y])) * scale).reshape(-1)
        for p in gt_polygons if len(p) >= 6
    ]
    g = rasterize_polygons_region(gpolys, (0, 0, rw, rh))
    inter = float(np.logical_and(d, g).sum())
    if gt_crowd:
        denom = float(d.sum())
    else:
        denom = float(d.sum() + g.sum() - inter)
    return inter / denom if denom > 0 else 0.0
