"""Padded, fixed-capacity instance containers (port of
lgd_tpu/structures/instances.py): struct-of-arrays with validity masks, so
every batch has one static shape.

    boxes   : (B, M, 4) float32, x1y1x2y2 in the padded input-image frame
    classes : (B, M)    int64, category index in [0, K)
    valid   : (B, M)    bool, True for real instances
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class BatchedInstances:
    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor

    def to(self, device) -> "BatchedInstances":
        return BatchedInstances(*(t.to(device) for t in
                                  (self.boxes, self.classes, self.valid)))

    @staticmethod
    def from_lists(boxes_list, classes_list,
                   capacity: int) -> "BatchedInstances":
        """Pack per-image ragged numpy annotations into the padded layout,
        in numpy; images with more than ``capacity`` boxes are truncated."""
        B = len(boxes_list)
        boxes = np.zeros((B, capacity, 4), np.float32)
        classes = np.zeros((B, capacity), np.int64)
        valid = np.zeros((B, capacity), bool)
        for i, (bx, cl) in enumerate(zip(boxes_list, classes_list)):
            n = min(len(bx), capacity)
            if n:
                boxes[i, :n] = np.asarray(bx, np.float32)[:n]
                classes[i, :n] = np.asarray(cl, np.int64)[:n]
                valid[i, :n] = True
        return BatchedInstances(torch.from_numpy(boxes),
                                torch.from_numpy(classes),
                                torch.from_numpy(valid))


@dataclasses.dataclass
class BatchedDetections:
    """Padded inference output; boxes in the input (resized) image frame.

    boxes (B, D, 4), scores (B, D), classes (B, D) int64, valid (B, D) bool.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
