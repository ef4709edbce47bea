"""Region Proposal Network (port of lgd_tpu/models/rcnn/rpn.py), NCHW
inside, on padded, fixed-shape tensors: the head, anchor labelling, the
256 @ 0.5 minibatch sample, the losses and proposal generation into a fixed
(B, POST_NMS_TOPK, 4) slab with a validity mask.

The sample's random numbers are an argument: ``subsample_labels`` takes
one uniform per anchor, drawn by the caller (the JAX package draws them
from its ``sampling`` stream inside the module), so the same draws give the
same sample in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import losses as L
from ...ops.matcher import Matcher
from ...ops.nms import batched_nms_mask
from ...ops.topk import topk_stable
from ...structures import BatchedInstances, Box2BoxTransform
from ...structures import boxes as box_ops
from ..heads.anchors import AnchorGenerator, feature_grid_sizes
from ..heads.retinanet import permute_to_n_hwa_k
from ..layers import Conv2d, feature_strides


class StandardRPNHead(nn.Module):
    """detectron2 StandardRPNHead: a shared 3x3 conv (hidden channels =
    input channels) and 1x1 objectness and delta convs over every level."""

    def __init__(self, in_channels: int, num_anchors: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1,
                           compute_dtype=dtype)
        self.objectness_logits = Conv2d(in_channels, num_anchors, 1,
                                        compute_dtype=dtype)
        self.anchor_deltas = Conv2d(in_channels, num_anchors * 4, 1,
                                    compute_dtype=dtype)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


class RPN(nn.Module):
    """The head over MODEL.RPN.IN_FEATURES; levels concatenated in
    (H, W, A) order, as the flax head's NHWC reshape."""

    def __init__(self, cfg, in_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features = tuple(cfg.MODEL.RPN.IN_FEATURES)
        num_anchors = (len(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0])
                       * len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]))
        self.head = StandardRPNHead(in_channels, num_anchors, dtype)

    def forward(self, feats: Dict[str, torch.Tensor]):
        """-> (logits (B, R, 1), deltas (B, R, 4)) in float32."""
        logits, deltas = self.head([feats[f] for f in self.in_features])
        logits = torch.cat([permute_to_n_hwa_k(x, 1) for x in logits], dim=1)
        deltas = torch.cat([permute_to_n_hwa_k(x, 4) for x in deltas], dim=1)
        return logits.float(), deltas.float()


def rpn_anchors(cfg, padded_hw,
                in_features: Sequence[str]) -> Tuple[np.ndarray, List[int]]:
    """(R, 4) anchors over the RPN's levels for one padded canvas, and the
    count per level."""
    gen = AnchorGenerator(
        sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
        aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
        strides=feature_strides(in_features),
        offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
    )
    per_level = gen(feature_grid_sizes(
        padded_hw, feature_strides(in_features)))
    return np.concatenate(per_level), [len(a) for a in per_level]


def subsample_labels(labels: torch.Tensor, rand: torch.Tensor,
                     num_samples: int, positive_fraction: float):
    """detectron2 subsample_labels on fixed shapes, per row: labels (B, N)
    in {-1, 0, 1}, rand (B, N) uniforms in [0, 1). Returns (pos_sel,
    neg_sel) bool masks: the positives with the largest uniforms, up to the
    fraction, then the negatives with the largest uniforms filling the
    rest. The n-th largest uniform of a mask is the threshold, as in the
    JAX package, so ties of its top-k do not matter."""
    pos, neg = labels == 1, labels == 0
    num_pos_max = int(num_samples * positive_fraction)

    def select(mask, n, k):
        k = min(k, labels.shape[-1])
        score = torch.where(mask, rand, -1.0)
        top = torch.topk(score, k, dim=-1).values
        at = torch.gather(top, -1, (n - 1).clamp(0, k - 1)[..., None])[..., 0]
        thresh = torch.where(n > 0, at, 2.0)
        return mask & (score >= thresh[..., None])

    n_pos = pos.sum(dim=-1).clamp(max=num_pos_max)
    pos_sel = select(pos, n_pos, num_pos_max)
    neg_sel = select(neg, num_samples - n_pos, num_samples)
    return pos_sel, neg_sel


def label_rpn_anchors(cfg, anchors: torch.Tensor, gt: BatchedInstances):
    """The matcher at the RPN's thresholds with low-quality matches, one
    image at a time (one (M, R) IoU slab at once). Returns gt_labels (B, R)
    int64 in {-1, 0, 1} and the matched GT boxes (B, R, 4)."""
    matcher = Matcher(cfg.MODEL.RPN.IOU_THRESHOLDS, cfg.MODEL.RPN.IOU_LABELS,
                      allow_low_quality_matches=True)
    labels, matched = [], []
    for boxes, valid in zip(gt.boxes, gt.valid):
        matches, match_labels = matcher(box_ops.pairwise_iou(boxes, anchors),
                                        valid)
        labels.append(match_labels.long())
        matched.append(boxes[matches])
    return torch.stack(labels), torch.stack(matched)


def rpn_losses(cfg, pred_logits: torch.Tensor, pred_deltas: torch.Tensor,
               gt_labels: torch.Tensor, matched_boxes: torch.Tensor,
               anchors: torch.Tensor, rand: torch.Tensor):
    """detectron2 RPN.losses: L1 on the sampled positives and BCE
    objectness on the sampled BATCH_SIZE_PER_IMAGE per image, both
    normalized by B * BATCH_SIZE_PER_IMAGE. rand (B, R): the sample's
    uniforms."""
    B = gt_labels.shape[0]
    rpn = cfg.MODEL.RPN
    pos_sel, neg_sel = subsample_labels(gt_labels, rand,
                                        rpn.BATCH_SIZE_PER_IMAGE,
                                        rpn.POSITIVE_FRACTION)
    normalizer = float(B * rpn.BATCH_SIZE_PER_IMAGE)
    transform = Box2BoxTransform(tuple(rpn.BBOX_REG_WEIGHTS))
    gt_deltas = transform.get_deltas(anchors[None], matched_boxes)
    reg = L.smooth_l1_loss(pred_deltas, gt_deltas, rpn.SMOOTH_L1_BETA)
    loss_loc = (reg * pos_sel[..., None]).sum() / normalizer
    bce = L.binary_cross_entropy_with_logits(pred_logits[..., 0],
                                             pos_sel.float())
    loss_obj = (bce * (pos_sel | neg_sel)).sum() / normalizer
    w = rpn.LOSS_WEIGHT
    return {"loss_rpn_cls": loss_obj * w, "loss_rpn_loc": loss_loc * w}


def generate_proposals(cfg, pred_logits: torch.Tensor,
                       pred_deltas: torch.Tensor, anchors: torch.Tensor,
                       level_counts: Sequence[int], image_sizes: torch.Tensor,
                       training: bool):
    """detectron2 find_top_rpn_proposals on padded shapes, batched over
    images: per-level top PRE_NMS_TOPK -> decode -> clip -> nonempty ->
    the strongest 2 * POST_NMS_TOPK -> NMS with levels as classes
    (kernel K2) -> top POST_NMS_TOPK. Returns
    (boxes (B, P, 4), scores (B, P), valid (B, P))."""
    rpn = cfg.MODEL.RPN
    pre_k = rpn.PRE_NMS_TOPK_TRAIN if training else rpn.PRE_NMS_TOPK_TEST
    post_k = rpn.POST_NMS_TOPK_TRAIN if training else rpn.POST_NMS_TOPK_TEST
    transform = Box2BoxTransform(tuple(rpn.BBOX_REG_WEIGHTS))
    offsets = np.concatenate([[0], np.cumsum(level_counts)])
    obj = pred_logits[..., 0]
    boxes_all, scores_all, lvl_all = [], [], []
    for li in range(len(level_counts)):
        s, e = int(offsets[li]), int(offsets[li + 1])
        # equal scores (flat regions of a map) in index order, as lax.top_k
        score, idx = topk_stable(obj[:, s:e], min(pre_k, e - s))
        d = torch.gather(pred_deltas[:, s:e], 1,
                         idx[..., None].expand(-1, -1, 4))
        boxes_all.append(transform.apply_deltas(d, anchors[s:e][idx]))
        scores_all.append(score)
        lvl_all.append(torch.full_like(idx, li))
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    lvls = torch.cat(lvl_all, dim=1)

    hw = image_sizes.to(boxes.dtype)
    boxes = box_ops.clip(boxes, hw[:, 0, None], hw[:, 1, None])
    valid = box_ops.nonempty(boxes, float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE))
    # keep the strongest 2 * post_k before the NMS sweep
    top_s, idx = topk_stable(torch.where(valid, scores, -1e10),
                             min(2 * post_k, boxes.shape[1]))
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    lvls = torch.gather(lvls, 1, idx)
    keep = batched_nms_mask(boxes, top_s, lvls, top_s > -1e9, rpn.NMS_THRESH)
    out_s, out_i = topk_stable(torch.where(keep, top_s, -1e10), post_k)
    out_b = torch.gather(boxes, 1, out_i[..., None].expand(-1, -1, 4))
    return out_b, out_s, out_s > -1e9
