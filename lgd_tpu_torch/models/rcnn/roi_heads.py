"""ROI heads, box half (port of lgd_tpu/models/rcnn/roi_heads.py):
proposal labelling and the 512 @ 0.25 sample into a fixed (B, 512) slab,
the FC box head over multilevel ROIAlign (kernel K3 on the card), the
Fast R-CNN losses, and per-class decode -> class-aware NMS (kernel K2)
inference. The mask head is not ported yet.

As in the RPN, the sample's uniforms are arguments: one per proposal for
the positive/negative sample and one for the order of the slab.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import losses as L
from ...ops.matcher import Matcher
from ...ops.nms import batched_nms_mask, topk_detections
from ...ops.roi_align import multilevel_roi_align
from ...ops.topk import topk_stable
from ...structures import BatchedDetections, BatchedInstances, Box2BoxTransform
from ...structures import boxes as box_ops
from ..layers import Linear, feature_strides
from .rpn import subsample_labels


class FastRCNNConvFCHead(nn.Module):
    """NUM_FC x FC(FC_DIM) with ReLU on the pooled (C, R, R) features.
    The flax head flattens its (R, R, C) pooling in that order; the port
    flattens (C, R, R), and the param bridge reorders ``fc1``'s input rows
    by ``pooled_shape``."""

    def __init__(self, pooled_shape, num_fc: int = 2, fc_dim: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pooled_shape = tuple(pooled_shape)
        self.num_fc = num_fc
        in_dim = math.prod(self.pooled_shape)
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(in_dim, fc_dim,
                                                 compute_dtype=dtype))
            in_dim = fc_dim
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, P, C, R, R)
        x = x.flatten(2)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    def __init__(self, in_dim: int, num_classes: int = 80,
                 cls_agnostic: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1, compute_dtype=dtype)
        self.bbox_pred = Linear(in_dim, (1 if cls_agnostic else num_classes)
                                * 4, compute_dtype=dtype)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x).float(), self.bbox_pred(x).float()


def label_and_sample_proposals(cfg, proposals: torch.Tensor,
                               prop_valid: torch.Tensor, gt: BatchedInstances,
                               rand_sample: torch.Tensor,
                               rand_order: torch.Tensor) -> Dict:
    """detectron2 label_and_sample_proposals, batched: append the GT, match
    at the ROI heads' IoU thresholds, sample BATCH_SIZE_PER_IMAGE at
    POSITIVE_FRACTION into a fixed slab ordered by the uniforms of
    ``rand_order``. rand_sample and rand_order are (B, P + M) for P
    proposals and M GT slots. Returns boxes (B, S, 4), classes (B, S)
    (NUM_CLASSES = background), matched_gt (B, S), valid (B, S) and is_fg
    (B, S)."""
    heads = cfg.MODEL.ROI_HEADS
    matcher = Matcher(heads.IOU_THRESHOLDS, heads.IOU_LABELS,
                      allow_low_quality_matches=False)
    num_classes = heads.NUM_CLASSES
    S = heads.BATCH_SIZE_PER_IMAGE
    if heads.PROPOSAL_APPEND_GT:
        proposals = torch.cat([proposals, gt.boxes], dim=1)
        prop_valid = torch.cat([prop_valid, gt.valid], dim=1)
    matches, match_labels = matcher(
        box_ops.pairwise_iou(gt.boxes, proposals), gt.valid)
    # invalid proposals are ignored outright
    labels = torch.where(prop_valid, match_labels.long(), -1)
    cls = torch.where(labels == 1, torch.gather(gt.classes, 1, matches),
                      num_classes)
    pos_sel, neg_sel = subsample_labels(labels, rand_sample, S,
                                        heads.POSITIVE_FRACTION)
    score = torch.where(pos_sel | neg_sel, 1.0 + rand_order, -1.0)
    k = min(S, score.shape[1])
    top, idx = topk_stable(score, k)
    if k < S:  # a pool under S (tiny configs) pads with invalid slots
        top = F.pad(top, (0, S - k), value=-1.0)
        idx = F.pad(idx, (0, S - k))
    valid = top > 0.0
    take = lambda a: torch.gather(a, 1, idx)
    return {"boxes": torch.gather(proposals, 1,
                                  idx[..., None].expand(-1, -1, 4)),
            "classes": take(cls), "matched_gt": take(matches),
            "valid": valid, "is_fg": take(pos_sel) & valid}


def fast_rcnn_losses(cfg, scores: torch.Tensor, deltas: torch.Tensor,
                     sampled: Dict, gt: BatchedInstances):
    """Softmax cross entropy (mean over the valid slots) and L1 on the
    foreground slots' class-specific deltas (sum over the valid count)."""
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    box_head = cfg.MODEL.ROI_BOX_HEAD
    transform = Box2BoxTransform(tuple(box_head.BBOX_REG_WEIGHTS))
    valid, is_fg, classes = (sampled["valid"], sampled["is_fg"],
                             sampled["classes"])
    ce = L.softmax_cross_entropy(scores, classes)
    n_valid = valid.float().sum().clamp(min=1.0)
    loss_cls = (ce * valid).sum() / n_valid

    B, S = classes.shape
    matched = torch.gather(gt.boxes, 1, sampled["matched_gt"][..., None]
                           .expand(-1, -1, 4))
    gt_deltas = transform.get_deltas(sampled["boxes"], matched)
    if box_head.CLS_AGNOSTIC_BBOX_REG:
        fg_deltas = deltas.reshape(B, S, 4)
    else:
        cls_safe = classes.clamp(0, num_classes - 1)
        fg_deltas = torch.gather(
            deltas.reshape(B, S, num_classes, 4), 2,
            cls_safe[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    reg = L.smooth_l1_loss(fg_deltas, gt_deltas, box_head.SMOOTH_L1_BETA)
    loss_reg = (reg * is_fg[..., None]).sum() / n_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_reg}


def fast_rcnn_inference(cfg, scores: torch.Tensor, deltas: torch.Tensor,
                        proposals: torch.Tensor, prop_valid: torch.Tensor,
                        image_sizes: torch.Tensor) -> BatchedDetections:
    """Per-class decode -> clip -> score filter -> top 2000 -> class-aware
    NMS (kernel K2) -> top DETECTIONS_PER_IMAGE,
    batched over images. scores (B, P, K + 1), deltas (B, P, 4K)."""
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    box_head = cfg.MODEL.ROI_BOX_HEAD
    transform = Box2BoxTransform(tuple(box_head.BBOX_REG_WEIGHTS))
    B, P = scores.shape[:2]
    probs = torch.softmax(scores, dim=-1)[..., :num_classes]
    if box_head.CLS_AGNOSTIC_BBOX_REG:
        boxes = transform.apply_deltas(deltas.reshape(B, P, 4), proposals)
        boxes = boxes[:, :, None].expand(B, P, num_classes, 4)
    else:
        boxes = transform.apply_deltas(deltas.reshape(B, P, num_classes, 4),
                                       proposals[:, :, None, :])
    hw = image_sizes.to(boxes.dtype)
    boxes = box_ops.clip(boxes, hw[:, 0, None, None], hw[:, 1, None, None])
    flat_scores = probs.reshape(B, -1)
    flat_boxes = boxes.reshape(B, -1, 4)
    flat_cls = torch.arange(num_classes, device=scores.device).repeat(P)
    valid = ((flat_scores > cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST)
             & prop_valid.repeat_interleave(num_classes, dim=1))
    top_s, idx = topk_stable(torch.where(valid, flat_scores, -1.0),
                             min(2000, flat_scores.shape[1]))
    b = torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4))
    c = flat_cls[idx]
    keep = batched_nms_mask(b, top_s, c, top_s > 0,
                            cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
    return BatchedDetections(*topk_detections(
        b, top_s, c, keep, cfg.TEST.DETECTIONS_PER_IMAGE))


class StandardROIHeads(nn.Module):
    """The box head over the multilevel ROI pooler of
    MODEL.ROI_HEADS.IN_FEATURES."""

    def __init__(self, cfg, in_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.MODEL.MASK_ON:
            raise NotImplementedError(
                "the mask head comes with the Mask R-CNN slice (ROADMAP.md, "
                "port queue item 9)")
        box_head = cfg.MODEL.ROI_BOX_HEAD
        self.in_features = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        self.strides = feature_strides(self.in_features)
        self.min_level = int(math.log2(self.strides[0]))
        self.resolution = box_head.POOLER_RESOLUTION
        self.sampling_ratio = box_head.POOLER_SAMPLING_RATIO
        self.dtype = dtype
        self.box_head = FastRCNNConvFCHead(
            (in_channels, self.resolution, self.resolution),
            num_fc=box_head.NUM_FC, fc_dim=box_head.FC_DIM, dtype=dtype)
        self.box_predictor = FastRCNNOutputLayers(
            self.box_head.out_dim, cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            box_head.CLS_AGNOSTIC_BBOX_REG, dtype)

    def pool(self, feats: Dict[str, torch.Tensor], boxes: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """(B, P, C, R, R) in the features' dtype."""
        return multilevel_roi_align(
            [feats[f] for f in self.in_features], boxes, valid, self.strides,
            self.resolution, self.min_level,
            sampling_ratio=self.sampling_ratio)

    def predict_boxes(self, pooled: torch.Tensor):
        """pooled (B, P, C, R, R) -> (scores (B, P, K + 1), deltas)."""
        return self.box_predictor(self.box_head(pooled.to(self.dtype)))

    def box_forward(self, feats, boxes, valid):
        return self.predict_boxes(self.pool(feats, boxes, valid))
