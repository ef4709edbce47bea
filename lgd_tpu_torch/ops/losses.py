"""Per-element loss primitives (port of the focal, smooth-L1, binary
cross-entropy and IoU losses of lgd_tpu/ops/losses.py, and of the softmax
cross entropy that lgd_tpu/models/rcnn/roi_heads.py writes inline). Callers
mask and reduce."""

from __future__ import annotations

import torch

EPS = 1e-7


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Focal loss per element (torchvision / cvpods semantics); targets in
    {0, 1}, the one-hot foreground."""
    p = torch.sigmoid(logits)
    # numerically stable BCE with logits
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """Smooth-L1 (Huber) per element; beta < 1e-5 is plain L1, as the
    reference RetinaNet config's SMOOTH_L1_LOSS_BETA 0.0 asks."""
    diff = (pred - target).abs()
    if beta < 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits per element."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[label] over the last axis: logits (..., K),
    labels (...,) int64 -> (...,)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def iou_loss(pred: torch.Tensor, target: torch.Tensor, weight=None,
             box_mode: str = "xyxy", loss_type: str = "giou",
             smooth: bool = False) -> torch.Tensor:
    """IoU-family regression loss per box (cvpods semantics, the FCOS, ATSS
    and POTO box losses): pred and target (..., 4), ``"ltrb"`` distances
    taken as the boxes (-l, -t, r, b); ``loss_type`` is ``"iou"`` (-log
    IoU), ``"linear_iou"`` (1 - IoU) or ``"giou"`` (1 - GIoU); ``weight``
    (...,) multiplies each loss (FCOS's centerness)."""
    if box_mode == "ltrb":
        pred = torch.cat([-pred[..., :2], pred[..., 2:]], dim=-1)
        target = torch.cat([-target[..., :2], target[..., 2:]], dim=-1)
    elif box_mode != "xyxy":
        raise ValueError(box_mode)

    def area(b):
        return ((b[..., 2] - b[..., 0]).clamp(min=0)
                * (b[..., 3] - b[..., 1]).clamp(min=0))

    w_inter = (torch.minimum(pred[..., 2], target[..., 2])
               - torch.maximum(pred[..., 0], target[..., 0])).clamp(min=0)
    h_inter = (torch.minimum(pred[..., 3], target[..., 3])
               - torch.maximum(pred[..., 1], target[..., 1])).clamp(min=0)
    inter = w_inter * h_inter
    union = area(pred) + area(target) - inter
    if smooth:
        ious = (inter + 1.0) / (union + 1.0)
    else:
        ious = inter / union.clamp(min=EPS)

    if loss_type == "iou":
        loss = -torch.log(ious.clamp(min=EPS))
    elif loss_type == "linear_iou":
        loss = 1.0 - ious
    elif loss_type == "giou":
        g_w = (torch.maximum(pred[..., 2], target[..., 2])
               - torch.minimum(pred[..., 0], target[..., 0]))
        g_h = (torch.maximum(pred[..., 3], target[..., 3])
               - torch.minimum(pred[..., 1], target[..., 1]))
        ac_union = g_w * g_h
        loss = 1.0 - (ious - (ac_union - union) / ac_union.clamp(min=EPS))
    else:
        raise ValueError(loss_type)
    return loss if weight is None else loss * weight
