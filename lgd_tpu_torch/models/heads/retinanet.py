"""RetinaNet student (port of lgd_tpu/models/heads/retinanet.py), NCHW
inside, with the same decomposed API: backbone + FPN, ``predict`` to
(logits, deltas) in HWA order, GT assignment and losses with the EMA loss
normalizer, and top-k -> score filter -> decode -> class-aware NMS
inference on padded, fixed-shape tensors. Anchors come from the numpy
generator in ``anchors.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import losses as L
from ...ops.matcher import Matcher
from ...ops.nms import batched_nms_mask, topk_detections
from ...ops.topk import topk_flat_pairs
from ...structures import BatchedDetections, BatchedInstances, Box2BoxTransform
from ...structures import boxes as box_ops
from ..backbones.fpn import bottom_up_features, build_trunk, init_trunk_
from ..layers import Conv2d, feature_strides, normalize_images
from .anchors import AnchorGenerator, feature_grid_sizes



def permute_to_n_hwa_k(t: torch.Tensor, k: int) -> torch.Tensor:
    """(N, A*K, H, W) -> (N, H*W*A, K): detectron2 permute_to_N_HWA_K, the
    NCHW spelling of the flax head's NHWC reshape."""
    n, _, h, w = t.shape
    return t.view(n, -1, k, h, w).permute(0, 3, 4, 1, 2).reshape(n, -1, k)


class RetinaNetHead(nn.Module):
    """Shared cls/box towers over all levels (detectron2 RetinaNetHead)."""

    def __init__(self, num_classes: int = 80, num_anchors: int = 9,
                 num_convs: int = 4, prior_prob: float = 0.01,
                 channels: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        for i in range(num_convs):
            for tower in ("cls_subnet", "bbox_subnet"):
                self.add_module(f"{tower}_{i}", Conv2d(
                    channels, channels, 3, padding=1, compute_dtype=dtype))
        self.cls_score = Conv2d(channels, num_anchors * num_classes, 3,
                                padding=1, compute_dtype=dtype)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 3, padding=1,
                                compute_dtype=dtype)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            c, b = f, f
            for i in range(self.num_convs):
                c = F.relu(getattr(self, f"cls_subnet_{i}")(c))
                b = F.relu(getattr(self, f"bbox_subnet_{i}")(b))
            logits.append(self.cls_score(c))
            deltas.append(self.bbox_pred(b))
        return logits, deltas


class RetinaNetCT(nn.Module):
    """Student detector: feature extraction + ``predict``, split like the
    reference RetinaNetCT so a distillator can drive the head itself."""

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features = tuple(cfg.MODEL.RETINANET.IN_FEATURES)
        self.num_classes = cfg.MODEL.RETINANET.NUM_CLASSES
        self.bottom_up, self.fpn = build_trunk(cfg, "p6p7", dtype)
        num_anchors = (len(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0])
                       * len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]))
        self.head = RetinaNetHead(
            num_classes=self.num_classes,
            num_anchors=num_anchors,
            num_convs=cfg.MODEL.RETINANET.NUM_CONVS,
            prior_prob=cfg.MODEL.RETINANET.PRIOR_PROB,
            channels=cfg.MODEL.FPN.OUT_CHANNELS,
            dtype=dtype,
        )
        self.pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
        self.pixel_std = tuple(cfg.MODEL.PIXEL_STD)

    def normalize(self, images: torch.Tensor,
                  image_sizes: torch.Tensor) -> torch.Tensor:
        return normalize_images(images, image_sizes, self.pixel_mean,
                                self.pixel_std)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                drop_path=None):
        """-> (raw bottom-up features, FPN features), both dicts;
        ``drop_path``: a Swin trunk's drop-path uniforms in training."""
        raw = bottom_up_features(self.bottom_up,
                                 self.normalize(images, image_sizes),
                                 drop_path)
        return raw, self.fpn(raw)

    def predict(self, features: List[torch.Tensor]):
        """Per-level features -> (logits (B, R, K), deltas (B, R, 4)) in
        float32, levels concatenated in HWA order."""
        logits, deltas = self.head(features)
        logits = torch.cat([permute_to_n_hwa_k(x, self.num_classes)
                            for x in logits], dim=1)
        deltas = torch.cat([permute_to_n_hwa_k(x, 4) for x in deltas], dim=1)
        return logits.float(), deltas.float()


def init_retinanet_(model: RetinaNetCT, generator: torch.Generator):
    """Random weights drawn like the flax initializers: the trunk's (see
    ``init_trunk_``), then a normal(0.01) head with the focal-loss prior on
    the class bias."""
    init_trunk_(model, generator)
    head = model.head
    for m in head.modules():
        if isinstance(m, Conv2d):
            nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(m.bias)
    p = head.prior_prob
    nn.init.constant_(head.cls_score.bias, -math.log((1 - p) / p))


def build_anchors(cfg, padded_hw) -> Tuple[np.ndarray, List[int]]:
    """(R, 4) anchors over all levels for one padded canvas, and the count
    per level (lgd_tpu/models/heads/retinanet.py:184-199)."""
    strides = feature_strides(cfg.MODEL.RETINANET.IN_FEATURES)
    gen = AnchorGenerator(
        sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
        aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
        strides=strides,
        offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
    )
    per_level = gen(feature_grid_sizes(padded_hw, strides))
    return np.concatenate(per_level, axis=0), [len(a) for a in per_level]


def label_anchors(cfg, anchors: torch.Tensor, gt: BatchedInstances):
    """detectron2 RetinaNet.label_anchors: the matcher with low-quality
    promotion, one image at a time, so that only one (M, R) IoU slab exists
    at once (at 800x1344 and M = 100 a batch of them would be B x 80 MB).
    anchors (R, 4). Returns gt_labels (B, R) int64 (num_classes =
    background, -1 = ignore) and the matched GT boxes (B, R, 4)."""
    matcher = Matcher(cfg.MODEL.RETINANET.IOU_THRESHOLDS,
                      cfg.MODEL.RETINANET.IOU_LABELS,
                      allow_low_quality_matches=True)
    num_classes = cfg.MODEL.RETINANET.NUM_CLASSES
    labels, matched = [], []
    for boxes, classes, valid in zip(gt.boxes, gt.classes, gt.valid):
        iou = box_ops.pairwise_iou(boxes, anchors)  # (M, R)
        matches, match_labels = matcher(iou, valid)
        labels.append(torch.where(
            match_labels == 1, classes[matches],
            torch.where(match_labels == -1, -1, num_classes)))
        matched.append(boxes[matches])
    return torch.stack(labels), torch.stack(matched)


def retinanet_losses(cfg, pred_logits: torch.Tensor,
                     pred_deltas: torch.Tensor, gt_labels: torch.Tensor,
                     gt_boxes: torch.Tensor, anchors: torch.Tensor,
                     loss_normalizer: torch.Tensor):
    """detectron2 RetinaNet.losses with the EMA normalizer passed through:
    pred_logits (B, R, K), pred_deltas (B, R, 4), gt_labels (B, R), gt_boxes
    (B, R, 4), anchors (R, 4), loss_normalizer a float32 scalar tensor.
    The normalizer is taken over the whole batch. Returns (losses,
    new normalizer)."""
    num_classes = cfg.MODEL.RETINANET.NUM_CLASSES
    transform = Box2BoxTransform(tuple(cfg.MODEL.RETINANET.BBOX_REG_WEIGHTS))
    valid_mask = gt_labels >= 0
    pos_mask = valid_mask & (gt_labels != num_classes)
    num_pos = pos_mask.sum().float()
    new_normalizer = (0.9 * loss_normalizer
                      + (1.0 - 0.9) * num_pos.clamp(min=1.0))

    # one-hot targets without the background class
    onehot = F.one_hot(gt_labels.clamp(0, num_classes - 1),
                       num_classes).to(pred_logits.dtype)
    onehot = onehot * pos_mask[..., None]
    cls_loss = L.sigmoid_focal_loss(
        pred_logits, onehot, alpha=cfg.MODEL.RETINANET.FOCAL_LOSS_ALPHA,
        gamma=cfg.MODEL.RETINANET.FOCAL_LOSS_GAMMA)
    loss_cls = (cls_loss * valid_mask[..., None]).sum()

    gt_deltas = transform.get_deltas(anchors[None], gt_boxes)
    reg_loss = L.smooth_l1_loss(pred_deltas, gt_deltas,
                                cfg.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA)
    loss_box_reg = (reg_loss * pos_mask[..., None]).sum()
    return ({"loss_cls": loss_cls / new_normalizer,
             "loss_box_reg": loss_box_reg / new_normalizer}, new_normalizer)


def retinanet_inference(cfg, pred_logits: torch.Tensor,
                        pred_deltas: torch.Tensor, anchors: torch.Tensor,
                        level_counts: Sequence[int],
                        image_sizes: torch.Tensor,
                        keep_fn=None) -> BatchedDetections:
    """Top-k per level -> score filter -> decode -> clip -> top 2000 ->
    class-aware NMS -> top DETECTIONS_PER_IMAGE, batched over images
    (detectron2 RetinaNet.inference semantics on padded static shapes).

    pred_logits (B, R, K), pred_deltas (B, R, 4), anchors (R, 4) on the
    same device; image_sizes (B, 2) (h, w). ``keep_fn`` is the NMS sweep;
    by default ``nms.greedy_keep_sorted`` (kernel K2), looked up when it
    is called."""
    topk_cand = cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST
    score_thresh = cfg.MODEL.RETINANET.SCORE_THRESH_TEST
    nms_thresh = cfg.MODEL.RETINANET.NMS_THRESH_TEST
    max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
    num_classes = pred_logits.shape[-1]
    b2b = Box2BoxTransform(tuple(cfg.MODEL.RETINANET.BBOX_REG_WEIGHTS))
    offsets = np.concatenate([[0], np.cumsum(level_counts)])

    boxes_all, scores_all, classes_all, valid_all = [], [], [], []
    for li in range(len(level_counts)):
        s, e = int(offsets[li]), int(offsets[li + 1])
        # rank by raw logits (sigmoid is monotone): only the k selected
        # scores are exponentiated, and only their anchors decoded
        top_l, top_i = topk_flat_pairs(pred_logits[:, s:e], topk_cand)
        top_p = torch.sigmoid(top_l)
        keep = top_p > score_thresh
        anchor_idx = top_i // num_classes
        d = torch.gather(pred_deltas[:, s:e], 1,
                         anchor_idx[..., None].expand(-1, -1, 4))
        boxes_all.append(b2b.apply_deltas(d, anchors[s:e][anchor_idx]))
        scores_all.append(torch.where(keep, top_p, 0.0))
        classes_all.append(top_i % num_classes)
        valid_all.append(keep)
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    classes = torch.cat(classes_all, dim=1)
    valid = torch.cat(valid_all, dim=1)

    hw = image_sizes.to(boxes.dtype)
    boxes = box_ops.clip(boxes, hw[:, 0, None], hw[:, 1, None])
    # bound the NMS sweep: keep the top 2000 candidates per image
    pre_nms = min(2000, boxes.shape[1])
    top_s, idx = torch.topk(torch.where(valid, scores, -1.0), pre_nms, dim=1)
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(classes, 1, idx)
    keep = batched_nms_mask(boxes, top_s, classes, top_s > 0, nms_thresh,
                            keep_fn)
    b, s, c, v = topk_detections(boxes, top_s, classes, keep, max_dets)
    return BatchedDetections(boxes=b, scores=s, classes=c, valid=v)


class AnchorCache:
    """Anchors per padded canvas, built once on the host by ``build``
    (padded_hw -> (anchors (R, 4) numpy, count per level)) and kept on the
    device (they depend only on the canvas and the config)."""

    def __init__(self, build):
        self.build = build
        self._cache: Dict[tuple, Tuple[torch.Tensor, List[int]]] = {}

    def __call__(self, padded_hw, device) -> Tuple[torch.Tensor, List[int]]:
        key = (tuple(padded_hw), str(device))
        if key not in self._cache:
            anchors, counts = self.build(tuple(padded_hw))
            self._cache[key] = (torch.from_numpy(anchors).to(device), counts)
        return self._cache[key]
