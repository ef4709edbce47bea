"""ATSS student (port of lgd_tpu/models/heads/atss.py): adaptive training
sample selection over the FCOS tower.

The vendored cvpods ATSS: per level the TOPK shifts nearest each box's
center, against pseudo-anchors of ANCHOR_SCALE x stride, become candidates;
a candidate is foreground when its IoU reaches the mean plus the unbiased
standard deviation of its box's candidate IoUs and its shift lies inside
the box, the box of largest IoU winning. The losses are FCOS's with the
box loss times REG_WEIGHT; inference is FCOS's.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.topk import topk_stable
from ...structures import BatchedInstances, Shift2BoxTransform
from ...structures import boxes as box_ops
from .fcos import FCOSCT, centerness_target, fcos_inference, fcos_losses


class ATSSCT(FCOSCT):
    """The FCOS student as it is (the reference reuses the FCOS tower,
    atss.py:97); the assignment and the losses differ."""


def atss_ground_truth(cfg, shifts: torch.Tensor, level_counts,
                      shift_strides: torch.Tensor, gt: BatchedInstances):
    """ATSS.get_ground_truth (atss.py:238-330), one image at a time. The
    per-level nearest shifts tie all the time on a regular grid: equal
    distances go to the lower index, as lax.top_k takes them. Returns
    gt_classes (B, R) int64, gt_deltas (B, R, 4), gt_centerness (B, R)."""
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES
    topk = cfg.MODEL.ATSS.TOPK
    tf = Shift2BoxTransform(tuple(cfg.MODEL.FCOS.BBOX_REG_WEIGHTS))
    offsets = np.concatenate([[0], np.cumsum(level_counts)])
    half = shift_strides[:, None] * (cfg.MODEL.ATSS.ANCHOR_SCALE / 2.0)
    anchors = torch.cat([shifts - half, shifts + half], dim=-1)

    out = []
    for boxes, classes, valid in zip(gt.boxes, gt.classes, gt.valid):
        iou = box_ops.pairwise_iou(boxes, anchors)  # (M, R)
        is_in = tf.get_deltas(shifts[None], boxes[:, None, :]).amin(-1) > 0
        dist = torch.sqrt(((box_ops.centers(boxes)[:, None, :]
                            - shifts[None]) ** 2).sum(-1))  # (M, R)
        cand_mask = torch.zeros_like(is_in)
        cand_ious = []
        for li in range(len(level_counts)):
            s, e = int(offsets[li]), int(offsets[li + 1])
            _, idx = topk_stable(-dist[:, s:e], min(topk, e - s))
            cand_mask[:, s:e].scatter_(1, idx, True)
            cand_ious.append(torch.gather(iou[:, s:e], 1, idx))
        cand_ious = torch.cat(cand_ious, dim=1)  # (M, k * levels)
        mean = cand_ious.mean(1, keepdim=True)
        n = cand_ious.shape[1]
        std = torch.sqrt(((cand_ious - mean) ** 2).sum(1, keepdim=True)
                         / max(n - 1, 1))
        fg = cand_mask & (iou >= mean + std) & is_in & valid[:, None]
        quality = torch.where(fg, iou, -1.0)
        max_q, matched = quality.amax(0), quality.argmax(0)
        gt_deltas = tf.get_deltas(shifts, boxes[matched])
        out.append((torch.where(max_q > -1.0, classes[matched], num_classes),
                    gt_deltas, centerness_target(gt_deltas)))
    return tuple(torch.stack(t) for t in zip(*out))


def atss_losses(cfg, gt_classes, gt_deltas, gt_centerness, pred_logits,
                pred_deltas, pred_ctr):
    """atss.py:164-236: FCOS's losses with loss_box_reg times REG_WEIGHT."""
    return fcos_losses(cfg, gt_classes, gt_deltas, gt_centerness,
                       pred_logits, pred_deltas, pred_ctr,
                       reg_weight=cfg.MODEL.FCOS.REG_WEIGHT)


atss_inference = fcos_inference  # the same inference (atss.py:332+)
