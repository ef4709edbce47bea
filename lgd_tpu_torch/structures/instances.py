"""Padded, fixed-capacity instance containers (port of
lgd_tpu/structures/instances.py): struct-of-arrays with validity masks, so
every batch has one static shape.

    boxes   : (B, M, 4) float32, x1y1x2y2 in the padded input-image frame
    classes : (B, M)    int64, category index in [0, K)
    valid   : (B, M)    bool, True for real instances
    masks49 : (B, M, 49) float32, optional: each GT mask cropped to its box
              at 7x7 (the LOAD_LABELMAP descriptors)
    bitmasks: (B, M, Hs, Ws) uint8, optional: each GT mask rasterized at
              TPU.SEGMASK_STRIDE on the padded canvas (the seg-mask
              teacher's inside masks)
    mask_crops: (B, M, G, G) uint8, optional: each GT polygon rasterized
              in its box's frame at G = TPU.MASK_CROP_SIZE (the mask head's
              target source)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class BatchedInstances:
    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks49: Optional[torch.Tensor] = None
    bitmasks: Optional[torch.Tensor] = None
    mask_crops: Optional[torch.Tensor] = None

    def to(self, device) -> "BatchedInstances":
        return BatchedInstances(*(None if t is None else t.to(device)
                                  for t in dataclasses.astuple(self)))

    @staticmethod
    def from_lists(boxes_list, classes_list, capacity: int,
                   masks49_list=None, bitmasks_list=None,
                   mask_crops_list=None) -> "BatchedInstances":
        """Pack per-image ragged numpy annotations into the padded layout,
        in numpy; images with more than ``capacity`` boxes are truncated.
        The mask lists are optional; bitmasks and crops are padded to the
        largest raster among the images, and stay None when no image has
        one (lgd_tpu/structures/instances.py:53-102)."""
        B = len(boxes_list)
        boxes = np.zeros((B, capacity, 4), np.float32)
        classes = np.zeros((B, capacity), np.int64)
        valid = np.zeros((B, capacity), bool)
        masks49 = (None if masks49_list is None
                   else np.zeros((B, capacity, 49), np.float32))

        def padded(arrays):
            hw = [a.shape[1:] for a in arrays or () if a is not None and len(a)]
            return (np.zeros((B, capacity, *np.max(hw, axis=0)), np.uint8)
                    if hw else None)

        bitmasks = padded(bitmasks_list)
        mask_crops = padded(mask_crops_list)
        for i, (bx, cl) in enumerate(zip(boxes_list, classes_list)):
            n = min(len(bx), capacity)
            if not n:
                continue
            boxes[i, :n] = np.asarray(bx, np.float32)[:n]
            classes[i, :n] = np.asarray(cl, np.int64)[:n]
            valid[i, :n] = True
            if masks49 is not None and masks49_list[i] is not None:
                masks49[i, :n] = np.asarray(masks49_list[i], np.float32)[:n]
            for out, arrays in ((bitmasks, bitmasks_list),
                                (mask_crops, mask_crops_list)):
                if out is not None and arrays[i] is not None:
                    a = np.asarray(arrays[i], np.uint8)[:n]
                    out[i, :len(a), :a.shape[1], :a.shape[2]] = a
        as_tensor = lambda a: None if a is None else torch.from_numpy(a)
        return BatchedInstances(*(as_tensor(a) for a in (
            boxes, classes, valid, masks49, bitmasks, mask_crops)))


@dataclasses.dataclass
class BatchedDetections:
    """Padded inference output; boxes in the input (resized) image frame.

    boxes (B, D, 4), scores (B, D), classes (B, D) int64, valid (B, D) bool.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
