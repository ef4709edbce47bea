"""ROI heads (port of lgd_tpu/models/rcnn/roi_heads.py): proposal
labelling and the 512 @ 0.25 sample into a fixed (B, 512) slab, the FC box
head over multilevel ROIAlign (kernel K3 on the card), the Fast R-CNN
losses, per-class decode -> class-aware NMS (kernel K2) inference, and the
Mask R-CNN mask head: NUM_CONV 3x3 convs, a 2x deconvolution and a 1x1
predictor over ROIAlign at the mask pooler's resolution (K3 again), its
targets resampled from the GT masks, and its per-pixel sigmoid loss.

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
from ..layers import Conv2d, ConvTranspose2d, Linear, feature_strides
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


class MaskRCNNConvUpsampleHead(nn.Module):
    """NUM_CONV x (conv3x3 + ReLU), deconv 2x + ReLU, 1x1 -> K mask logits
    at twice the pooled resolution: (B, P, C, R, R) -> (B, P, K, 2R, 2R)
    float32 (the flax head's are (B, P, 2R, 2R, K))."""

    def __init__(self, in_channels: int, num_classes: int = 80,
                 num_conv: int = 4, conv_dim: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_conv = num_conv
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(
                in_channels if i == 0 else conv_dim, conv_dim, 3, padding=1,
                compute_dtype=dtype))
        self.deconv = ConvTranspose2d(conv_dim if num_conv else in_channels,
                                      conv_dim, 2, stride=2,
                                      compute_dtype=dtype)
        self.predictor = Conv2d(conv_dim, num_classes, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, P = x.shape[:2]
        x = x.flatten(0, 1)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = self.predictor(F.relu(self.deconv(x)))
        return x.reshape(B, P, *x.shape[1:]).float()


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


def take_fg_subset(sampled: Dict, k: int) -> Dict:
    """The (B, k) foreground-first subset of the sampled slab for the mask
    head: the sample caps the foreground at k = BATCH_SIZE_PER_IMAGE *
    POSITIVE_FRACTION, so a top-k of the foreground flags (ties in index
    order, as ``lax.top_k``) holds every foreground slot."""
    _, idx = topk_stable(sampled["is_fg"].float(), k)
    take = lambda a: torch.gather(a, 1, idx)
    return {"boxes": torch.gather(sampled["boxes"], 1,
                                  idx[..., None].expand(-1, -1, 4)),
            **{key: take(sampled[key])
               for key in ("classes", "matched_gt", "valid", "is_fg")}}


def _sample_grid(m: torch.Tensor, yi: torch.Tensor,
                 xi: torch.Tensor) -> torch.Tensor:
    """m (B, S, H, W) at rows yi and columns xi, both (B, S, out) ->
    (B, S, out, out)."""
    rows = torch.gather(m, 2, yi[..., :, None].expand(-1, -1, -1, m.shape[3]))
    return torch.gather(rows, 3,
                        xi[..., None, :].expand(-1, -1, yi.shape[2], -1))


def _cell_centres(boxes: torch.Tensor, out: int):
    """The x and y of the out x out cell centres of each box: (B, S, out)
    each. The fractions (j + 0.5) / out are taken as (j + 0.5) times the
    float32 reciprocal of out, as XLA compiles the JAX package's division
    by a constant, so that a centre on the midpoint of two target pixels
    rounds to the same side as in JAX's jitted step."""
    g = ((torch.arange(out, dtype=torch.float32, device=boxes.device) + 0.5)
         * torch.tensor(1.0 / out, dtype=torch.float32))
    return (boxes[..., 0:1] + (boxes[..., 2:3] - boxes[..., 0:1]) * g,
            boxes[..., 1:2] + (boxes[..., 3:4] - boxes[..., 1:2]) * g)


def crop_bitmasks(bitmasks: torch.Tensor, matched_gt: torch.Tensor,
                  boxes: torch.Tensor, out: int, stride: int) -> torch.Tensor:
    """Each matched GT bitmask (B, M, Hs, Ws) at ``stride`` sampled
    bilinearly at the out x out cell centres of its box and thresholded at
    0.5 -> (B, S, out, out) float targets: the fallback for batches
    without GT-frame crops (lgd_tpu/models/rcnn/roi_heads.py:193-231)."""
    Hs, Ws = bitmasks.shape[2:]
    masks = torch.gather(bitmasks.float(), 1, matched_gt[..., None, None]
                         .expand(-1, -1, Hs, Ws))
    px, py = _cell_centres(boxes, out)

    def bil(coord, size):
        c0 = torch.floor(coord)
        f = coord - c0
        c0 = c0.long().clamp(0, size - 1)
        return c0, (c0 + 1).clamp(0, size - 1), f

    y0, y1, fy = bil(py / stride - 0.5, Hs)
    x0, x1, fx = bil(px / stride - 0.5, Ws)
    fy, fx = fy[..., :, None], fx[..., None, :]
    m = (_sample_grid(masks, y0, x0) * (1 - fy) * (1 - fx)
         + _sample_grid(masks, y0, x1) * (1 - fy) * fx
         + _sample_grid(masks, y1, x0) * fy * (1 - fx)
         + _sample_grid(masks, y1, x1) * fy * fx)
    return (m >= 0.5).float()


def crop_gt_frame_masks(mask_crops: torch.Tensor, gt_boxes: torch.Tensor,
                        matched_gt: torch.Tensor, boxes: torch.Tensor,
                        out: int) -> torch.Tensor:
    """Mask targets from the exact GT-box-frame polygon rasters (B, M, G,
    G): each proposal's out x out cell centres mapped into its matched GT
    box's frame, the crop sampled bilinearly there (0 outside the GT box),
    thresholded at 0.5 -> (B, S, out, out) float. The four corner terms are
    summed in the JAX package's order, in float32, so that a centre
    halfway between two crop pixels gives the same 0.5 and the same target
    (lgd_tpu/models/rcnn/roi_heads.py:234-282)."""
    G = mask_crops.shape[-1]
    crops = torch.gather(mask_crops.float(), 1, matched_gt[..., None, None]
                         .expand(-1, -1, G, G))
    gbox = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(-1, -1, 4))
    px, py = _cell_centres(boxes, out)
    gw = (gbox[..., 2:3] - gbox[..., 0:1]).clamp(min=1e-3)
    gh = (gbox[..., 3:4] - gbox[..., 1:2]).clamp(min=1e-3)
    u = (px - gbox[..., 0:1]) / gw * G - 0.5
    v = (py - gbox[..., 1:2]) / gh * G - 0.5

    def bil(coord):
        inside = ((coord > -1.0) & (coord < G)).float()
        c = coord.clamp(0.0, G - 1.0)
        c0 = torch.floor(c)
        f = c - c0
        c0i = c0.long()
        return (c0i, (1 - f) * inside), ((c0i + 1).clamp(max=G - 1),
                                         f * inside)

    (v0, wv0), (v1, wv1) = bil(v)
    (u0, wu0), (u1, wu1) = bil(u)
    w = lambda wv, wu: wv[..., :, None] * wu[..., None, :]
    m = (_sample_grid(crops, v0, u0) * w(wv0, wu0)
         + _sample_grid(crops, v0, u1) * w(wv0, wu1)
         + _sample_grid(crops, v1, u0) * w(wv1, wu0)
         + _sample_grid(crops, v1, u1) * w(wv1, wu1))
    return (m >= 0.5).float()


def class_masks(mask_logits: torch.Tensor,
                classes: torch.Tensor) -> torch.Tensor:
    """Each ROI's own class channel of mask_logits (B, S, K, out, out) ->
    (B, S, out, out); classes past K-1 (the background) take the last."""
    out = mask_logits.shape[-1]
    cls = classes.clamp(0, mask_logits.shape[2] - 1)
    return torch.gather(mask_logits, 2, cls[..., None, None, None]
                        .expand(-1, -1, 1, out, out))[:, :, 0]


def mask_rcnn_loss(cfg, mask_logits: torch.Tensor, sampled: Dict,
                   gt: BatchedInstances) -> torch.Tensor:
    """Per-pixel BCE of each foreground ROI's class channel against its
    cropped GT mask, over the foreground pixels of the whole batch.
    mask_logits (B, S, K, out, out)."""
    out = mask_logits.shape[-1]
    per_cls = class_masks(mask_logits, sampled["classes"])
    if gt.mask_crops is not None:
        targets = crop_gt_frame_masks(gt.mask_crops, gt.boxes,
                                      sampled["matched_gt"], sampled["boxes"],
                                      out)
    else:  # the coarser canvas-wide raster, for batches without crops
        targets = crop_bitmasks(gt.bitmasks, sampled["matched_gt"],
                                sampled["boxes"], out, cfg.TPU.SEGMASK_STRIDE)
    bce = L.binary_cross_entropy_with_logits(per_cls, targets)
    fg = sampled["is_fg"][..., None, None]
    n = (fg.float().sum() * out * out).clamp(min=1.0)
    return (bce * fg).sum() / n


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
    """The box head, and with MASK_ON the mask head, over the multilevel
    ROI pooler of MODEL.ROI_HEADS.IN_FEATURES."""

    def __init__(self, cfg, in_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
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
        self.mask_on = cfg.MODEL.MASK_ON
        if self.mask_on:
            mask_head = cfg.MODEL.ROI_MASK_HEAD
            self.mask_resolution = mask_head.POOLER_RESOLUTION
            self.mask_sampling_ratio = mask_head.POOLER_SAMPLING_RATIO
            self.mask_head = MaskRCNNConvUpsampleHead(
                in_channels, cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                mask_head.NUM_CONV, mask_head.CONV_DIM, dtype)

    def pool(self, feats: Dict[str, torch.Tensor], boxes: torch.Tensor,
             valid: torch.Tensor, resolution: int = None,
             sampling_ratio: int = None) -> torch.Tensor:
        """(B, P, C, R, R) in the features' dtype, at the box pooler's R
        unless another is named."""
        return multilevel_roi_align(
            [feats[f] for f in self.in_features], boxes, valid, self.strides,
            resolution or self.resolution, self.min_level,
            sampling_ratio=(self.sampling_ratio if sampling_ratio is None
                            else sampling_ratio))

    def predict_boxes(self, pooled: torch.Tensor):
        """pooled (B, P, C, R, R) -> (scores (B, P, K + 1), deltas)."""
        return self.box_predictor(self.box_head(pooled.to(self.dtype)))

    def box_forward(self, feats, boxes, valid):
        return self.predict_boxes(self.pool(feats, boxes, valid))

    def mask_forward(self, feats, boxes, valid):
        """(B, P, K, 2R, 2R) float32 mask logits of the boxes, R the mask
        pooler's; invalid boxes pool to zero."""
        pooled = self.pool(feats, boxes, valid, self.mask_resolution,
                           self.mask_sampling_ratio)
        return self.mask_head(pooled.to(self.dtype))
