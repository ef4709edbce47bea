"""Box operations on ``(..., 4)`` x1y1x2y2 tensors, batched by broadcasting.

Port of lgd_tpu/structures/boxes.py: the same formulas in the same order,
so that float32 results agree bit for bit where no transcendental is
involved (the NMS kernel's IoU restates ``pairwise_iou`` exactly).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-7

# detectron2 _DEFAULT_SCALE_CLAMP as the JAX package holds it: log(1000/16)
# rounded to float32 (lgd_tpu/structures/boxes.py:18).
SCALE_CLAMP = float(np.float32(math.log(1000.0 / 16)))


def area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clip(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clamp boxes to [0, w] x [0, h]; h and w are scalars or tensors that
    broadcast against ``boxes[..., 0]``."""
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """(..., 4) -> (...,) bool: width and height both above threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def centers(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 2) box centers (x, y)."""
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) * 0.5,
                        (boxes[..., 1] + boxes[..., 3]) * 0.5], dim=-1)


def pairwise_intersection(boxes1: torch.Tensor,
                          boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) intersection areas."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU; 0 where the union is 0."""
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[..., :, None]
    a2 = area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union.clamp(min=EPS),
                       torch.zeros_like(inter))


class Box2BoxTransform:
    """dx, dy, dw, dh parameterization (detectron2 Box2BoxTransform):
    ``get_deltas`` encodes training targets, ``apply_deltas`` decodes."""

    def __init__(self, weights=(1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = SCALE_CLAMP):
        self.weights = tuple(float(x) for x in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor,
                   target_boxes: torch.Tensor) -> torch.Tensor:
        """src (..., 4), target (..., 4) -> deltas (..., 4). Degenerate
        (padded) sizes are clamped to EPS; such slots are masked out of the
        loss downstream."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h

        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        src_w = src_w.clamp(min=EPS)
        src_h = src_h.clamp(min=EPS)
        dx = wx * (tgt_cx - src_cx) / src_w
        dy = wy * (tgt_cy - src_cy) / src_h
        dw = ww * torch.log(tgt_w.clamp(min=EPS) / src_w)
        dh = wh * torch.log(tgt_h.clamp(min=EPS) / src_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor,
                     boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., 4), boxes (..., 4) -> decoded boxes (..., 4)."""
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + 0.5 * widths
        cy = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = (deltas[..., 2] / ww).clamp(max=self.scale_clamp)
        dh = (deltas[..., 3] / wh).clamp(max=self.scale_clamp)

        pred_cx = dx * widths + cx
        pred_cy = dy * heights + cy
        pred_w = torch.exp(dw) * widths
        pred_h = torch.exp(dh) * heights
        return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                            pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
                           dim=-1)


class Shift2BoxTransform:
    """(l, t, r, b) distances between shift points and box edges, times the
    weights (cvpods Shift2BoxTransform, used by FCOS, ATSS and POTO).
    Both methods broadcast their arguments against each other."""

    def __init__(self, weights=(1.0, 1.0, 1.0, 1.0)):
        self.weights = tuple(float(x) for x in weights)

    def _weights(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.weights, dtype=torch.float32,
                            device=like.device)

    def get_deltas(self, shifts: torch.Tensor,
                   boxes: torch.Tensor) -> torch.Tensor:
        """shifts (..., 2) points, boxes (..., 4) -> (..., 4) ltrb."""
        shifts, lo = torch.broadcast_tensors(shifts, boxes[..., :2])
        hi = boxes[..., 2:].expand_as(lo)
        return torch.cat([shifts - lo, hi - shifts], dim=-1) * self._weights(
            boxes)

    def apply_deltas(self, deltas: torch.Tensor,
                     shifts: torch.Tensor) -> torch.Tensor:
        """deltas (..., 4) ltrb, shifts (..., 2) -> boxes (..., 4)."""
        d = deltas / self._weights(deltas)
        return torch.cat([shifts - d[..., :2], shifts + d[..., 2:]], dim=-1)
