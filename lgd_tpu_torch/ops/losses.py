"""Per-element loss primitives (port of the focal, smooth-L1 and binary
cross-entropy losses of lgd_tpu/ops/losses.py, and of the softmax cross
entropy that lgd_tpu/models/rcnn/roi_heads.py writes inline). Callers mask
and reduce."""

from __future__ import annotations

import torch


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
