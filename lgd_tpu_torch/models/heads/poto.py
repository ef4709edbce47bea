"""POTO student (port of lgd_tpu/models/heads/poto.py): the end-to-end,
one-to-one detector.

The vendored cvpods POTO: the FCOS towers without the centerness branch;
each GT gets at most one shift by a one-to-one matching on the quality
prob^(1 - ALPHA) * IoU^ALPHA of the student's own detached predictions,
restricted to the GT's center region (poto.py:329-359); focal + GIoU x
REG_WEIGHT losses over the foreground count; inference without NMS when
MODEL.NMS_TYPE is "null".

MODEL.POTO.ASSIGNMENT: ``hungarian`` (the default) and ``hungarian_host``
both solve the matching exactly with scipy on the host
(``ops.hungarian.max_quality_assignment``), the reference's own way;
``greedy`` takes the best remaining (GT, shift) pair M times on the
device, with no host sync.
"""

from __future__ import annotations

import torch

from ...ops import hungarian
from ...ops import losses as L
from ...structures import BatchedInstances, Shift2BoxTransform
from ...structures import boxes as box_ops
from .fcos import INF, FCOSCT, center_sampled, shift_inference

ASSIGNMENTS = ("hungarian", "hungarian_host", "greedy")


class POTOCT(FCOSCT):
    """The FCOS student without the centerness branch (poto.py:523-622):
    ``predict`` gives (logits, deltas)."""

    centerness = False


def greedy_one_to_one(quality: torch.Tensor) -> torch.Tensor:
    """Greedy one-to-one assignment on (B, M, R) qualities, masked entries
    -INF: M times, each image's largest remaining entry (the first in
    row-major order on ties) assigns its column to its row, and both are
    removed. Returns (B, M) int64, -1 where a row got nothing."""
    q = quality.clone()
    B, M, R = q.shape
    images = torch.arange(B, device=q.device)
    assign = torch.full((B, M), -1, dtype=torch.long, device=q.device)
    for _ in range(M):
        flat = q.reshape(B, -1).argmax(1)
        row, col = flat // R, flat % R
        ok = q[images, row, col] > -INF
        assign[images, row] = torch.where(ok, col, assign[images, row])
        q[images, row, :] = -INF
        q[images, :, col] = torch.where(ok[:, None], -INF, q[images, :, col])
    return assign


def poto_quality(cfg, shifts: torch.Tensor, shift_strides: torch.Tensor,
                 gt: BatchedInstances, pred_logits: torch.Tensor,
                 pred_deltas: torch.Tensor) -> torch.Tensor:
    """(B, M, R) matching quality of every GT against every shift's
    prediction, -INF outside the GT's center region (or box, with radius
    0) and for padded GT rows (poto.py:329-359)."""
    alpha = cfg.MODEL.POTO.ALPHA
    radius = cfg.MODEL.POTO.CENTER_SAMPLING_RADIUS
    tf = Shift2BoxTransform(tuple(cfg.MODEL.FCOS.BBOX_REG_WEIGHTS))
    probs = torch.sigmoid(pred_logits)  # (B, R, K)
    prob_gt = torch.gather(
        probs, 2, gt.classes[:, None, :].expand(-1, probs.shape[1], -1)
    ).transpose(1, 2)  # (B, M, R)
    iou = box_ops.pairwise_iou(gt.boxes, tf.apply_deltas(pred_deltas, shifts))
    quality = prob_gt ** (1 - alpha) * iou ** alpha
    if radius > 0:
        is_in = center_sampled(gt.boxes, shifts, shift_strides, radius)
    else:
        is_in = tf.get_deltas(shifts, gt.boxes[..., None, :]).amin(-1) > 0
    return torch.where(is_in & gt.valid[..., None], quality, -INF)


@torch.no_grad()
def poto_ground_truth(cfg, shifts: torch.Tensor, shift_strides: torch.Tensor,
                      gt: BatchedInstances, pred_logits: torch.Tensor,
                      pred_deltas: torch.Tensor):
    """poto.py:288-385: the one-to-one assignment of MODEL.POTO.ASSIGNMENT
    on ``poto_quality``. Returns gt_classes (B, R) int64 (NUM_CLASSES =
    background) and gt_deltas (B, R, 4), zero where unassigned."""
    assignment = cfg.MODEL.POTO.ASSIGNMENT
    if assignment not in ASSIGNMENTS:
        raise ValueError(f"unknown MODEL.POTO.ASSIGNMENT {assignment!r}")
    quality = poto_quality(cfg, shifts, shift_strides, gt, pred_logits,
                           pred_deltas)
    if assignment == "greedy":
        assign = greedy_one_to_one(quality)
    else:
        assign = hungarian.max_quality_assignment(quality, penalty=-INF)

    B, R = quality.shape[0], shifts.shape[0]
    tf = Shift2BoxTransform(tuple(cfg.MODEL.FCOS.BBOX_REG_WEIGHTS))
    # unassigned rows write to a column past the end, which is dropped
    col = torch.where(assign >= 0, assign, R)
    gt_classes = torch.full((B, R + 1), cfg.MODEL.FCOS.NUM_CLASSES,
                            dtype=torch.long, device=assign.device)
    gt_classes.scatter_(1, col, gt.classes)
    targets = tf.get_deltas(shifts[assign.clamp(min=0)], gt.boxes)
    gt_deltas = torch.zeros((B, R + 1, 4), dtype=targets.dtype,
                            device=targets.device)
    gt_deltas.scatter_(1, col[..., None].expand(-1, -1, 4), targets)
    return gt_classes[:, :R], gt_deltas[:, :R]


def poto_losses(cfg, gt_classes: torch.Tensor, gt_deltas: torch.Tensor,
                pred_logits: torch.Tensor, pred_deltas: torch.Tensor):
    """poto.py:230-285 normalized over the whole batch's foreground."""
    fcos = cfg.MODEL.FCOS
    num_classes = fcos.NUM_CLASSES
    fg = ((gt_classes >= 0) & (gt_classes != num_classes)).float()
    num_fg = fg.sum().clamp(min=1.0)
    onehot = torch.nn.functional.one_hot(
        gt_classes.clamp(0, num_classes - 1), num_classes).float()
    loss_cls = L.sigmoid_focal_loss(
        pred_logits, onehot * fg[..., None], alpha=fcos.FOCAL_LOSS_ALPHA,
        gamma=fcos.FOCAL_LOSS_GAMMA).sum() / num_fg
    reg = L.iou_loss(pred_deltas, gt_deltas, box_mode="ltrb",
                     loss_type=fcos.IOU_LOSS_TYPE)
    return {"loss_cls": loss_cls,
            "loss_box_reg": (reg * fg).sum() / num_fg
            * cfg.MODEL.POTO.REG_WEIGHT}


def poto_inference(cfg, pred_logits, pred_deltas, shifts, level_counts,
                   image_sizes, keep_fn=None):
    """poto.py:386-489: per-level top-k scored by the class probability;
    NMS (kernel K2) unless MODEL.NMS_TYPE is "null"."""
    return shift_inference(cfg, pred_logits, pred_deltas, None, shifts,
                           level_counts, image_sizes,
                           nms=cfg.MODEL.NMS_TYPE != "null", keep_fn=keep_fn)
