"""FCOS student (port of lgd_tpu/models/heads/fcos.py), NCHW inside.

The cvpods FCOS: 4-conv towers with GroupNorm(32) and a learnable
``Scale`` per level, center-sampling GT assignment with the object sizes
of interest and the smallest box winning, focal + centerness-weighted
GIoU + BCE centerness losses with normalizers over the whole batch, and
sqrt(cls * ctr)-scored inference through the NMS kernel K2. The same
tower without its centerness branch is POTO's (``poto.py``); ATSS keeps it
whole and changes the assignment (``atss.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import losses as L
from ...ops.nms import batched_nms_mask, topk_detections
from ...ops.topk import topk_flat_pairs, topk_stable
from ...structures import BatchedDetections, BatchedInstances, Shift2BoxTransform
from ...structures import boxes as box_ops
from ..backbones.fpn import bottom_up_features, build_trunk, init_trunk_
from ..layers import Conv2d, GroupNorm32, Scale, normalize_images
from .anchors import ShiftGenerator, feature_grid_sizes
from .retinanet import permute_to_n_hwa_k

INF = 1e8


class FCOSHead(nn.Module):
    """cls and box towers of conv -> GroupNorm(32) -> ReLU shared over the
    levels, a Scale per level on the box output (thirdparty_heads/
    fcos.py:433-546), and with ``centerness`` the centerness branch, on the
    box tower (``centerness_on_reg``) or the cls tower. Submodule names are
    the flax head's."""

    def __init__(self, num_classes: int = 80, num_convs: int = 4,
                 num_levels: int = 5, prior_prob: float = 0.01,
                 channels: int = 256, centerness_on_reg: bool = True,
                 norm_reg_targets: bool = True,
                 fpn_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 centerness: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        self.centerness_on_reg = centerness_on_reg
        self.norm_reg_targets = norm_reg_targets
        self.fpn_strides = tuple(fpn_strides)
        for i in range(num_convs):
            for tower in ("cls", "bbox"):
                self.add_module(f"{tower}_subnet_{i}", Conv2d(
                    channels, channels, 3, padding=1, compute_dtype=dtype))
                self.add_module(f"{tower}_gn_{i}", GroupNorm32(channels))
        self.cls_score = Conv2d(channels, num_classes, 3, padding=1,
                                compute_dtype=dtype)
        self.bbox_pred = Conv2d(channels, 4, 3, padding=1,
                                compute_dtype=dtype)
        self.centerness = (Conv2d(channels, 1, 3, padding=1,
                                  compute_dtype=dtype)
                           if centerness else None)
        for level in range(num_levels):
            self.add_module(f"scale_{level}", Scale(1.0))

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            conv = getattr(self, f"{name}_subnet_{i}")
            x = F.relu(getattr(self, f"{name}_gn_{i}")(conv(x)))
        return x

    def forward(self, features: List[torch.Tensor]):
        """-> per-level lists (logits, box distances[, centerness]) NCHW in
        the compute dtype."""
        logits, bbox_reg, ctrness = [], [], []
        for level, f in enumerate(features):
            c, b = self._tower("cls", f), self._tower("bbox", f)
            logits.append(self.cls_score(c))
            if self.centerness is not None:
                ctrness.append(self.centerness(
                    b if self.centerness_on_reg else c))
            pred = getattr(self, f"scale_{level}")(self.bbox_pred(b))
            bbox_reg.append(F.relu(pred) * self.fpn_strides[level]
                            if self.norm_reg_targets else torch.exp(pred))
        if self.centerness is None:
            return logits, bbox_reg
        return logits, bbox_reg, ctrness


class FCOSCT(nn.Module):
    """Student detector: ResNet or Swin-T, an FPN whose p6/p7 come from p5
    (cvpods; lgd_tpu/models/heads/fcos.py:109-125), and ``predict``, split
    like the reference FCOSCT so that a distillator drives the head
    itself."""

    centerness = True

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        fcos = cfg.MODEL.FCOS
        self.in_features = tuple(fcos.IN_FEATURES)
        self.num_classes = fcos.NUM_CLASSES
        self.bottom_up, self.fpn = build_trunk(cfg, "p6p7", dtype,
                                               resnet_top_in="p5")
        self.head = FCOSHead(
            num_classes=self.num_classes, num_convs=fcos.NUM_CONVS,
            num_levels=len(self.in_features), prior_prob=fcos.PRIOR_PROB,
            channels=cfg.MODEL.FPN.OUT_CHANNELS,
            centerness_on_reg=fcos.CENTERNESS_ON_REG,
            norm_reg_targets=fcos.NORM_REG_TARGETS,
            fpn_strides=fcos.FPN_STRIDES, centerness=self.centerness,
            dtype=dtype)
        self.pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
        self.pixel_std = tuple(cfg.MODEL.PIXEL_STD)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                drop_path=None):
        """-> (raw bottom-up features, FPN features), both dicts;
        ``drop_path``: a Swin trunk's drop-path uniforms in training."""
        raw = bottom_up_features(
            self.bottom_up, normalize_images(images, image_sizes,
                                             self.pixel_mean, self.pixel_std),
            drop_path)
        return raw, self.fpn(raw)

    def predict(self, features: List[torch.Tensor]):
        """Per-level features -> (logits (B, R, K), deltas (B, R, 4),
        centerness (B, R, 1)) in float32, levels concatenated in HW order
        (POTO: the first two)."""
        outputs = self.head(features)
        widths = (self.num_classes, 4, 1)
        return tuple(torch.cat([permute_to_n_hwa_k(x, k) for x in xs],
                               dim=1).float()
                     for xs, k in zip(outputs, widths))


def init_fcos_(model: FCOSCT, generator: torch.Generator):
    """Random weights drawn like the flax initializers: the trunk's (see
    ``init_trunk_``), normal(0.01) head convs with zero biases and the
    focal-loss prior on the class bias, GroupNorm scale 1 and bias 0, and
    every Scale 1.0."""
    init_trunk_(model, generator)
    head = model.head
    for m in head.modules():
        if isinstance(m, Conv2d):
            nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, GroupNorm32):
            nn.init.ones_(m.scale)
            nn.init.zeros_(m.bias)
        elif isinstance(m, Scale):
            nn.init.ones_(m.scale)
    p = head.prior_prob
    nn.init.constant_(head.cls_score.bias, -math.log((1 - p) / p))


# ---------------------------------------------------------------------------
# shifts, GT assignment, losses and inference
# ---------------------------------------------------------------------------


def build_shifts(cfg, padded_hw):
    """The shift points of all levels for one padded canvas, as numpy:
    (points (R, 2), count per level, stride (R,), size-of-interest low
    (R,) and high (R,))."""
    strides = list(cfg.MODEL.FCOS.FPN_STRIDES)
    gen = ShiftGenerator(strides, cfg.MODEL.SHIFT_GENERATOR.NUM_SHIFTS,
                         cfg.MODEL.SHIFT_GENERATOR.OFFSET)
    per_level = gen(feature_grid_sizes(padded_hw, strides))
    counts = [len(s) for s in per_level]
    soi = np.asarray(cfg.MODEL.FCOS.OBJECT_SIZES_OF_INTEREST, np.float32)
    soi = np.where(np.isinf(soi), INF, soi)

    def per_shift(values):
        return np.concatenate([np.full(c, v, np.float32)
                               for c, v in zip(counts, values)])

    return (np.concatenate(per_level), counts, per_shift(strides),
            per_shift(soi[:, 0]), per_shift(soi[:, 1]))


class Shifts(NamedTuple):
    points: torch.Tensor   # (R, 2)
    counts: List[int]
    strides: torch.Tensor  # (R,)
    soi_lo: torch.Tensor   # (R,)
    soi_hi: torch.Tensor   # (R,)


class ShiftCache:
    """``build_shifts`` per padded canvas, kept on the device."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._cache: Dict[tuple, Shifts] = {}

    def __call__(self, padded_hw, device) -> Shifts:
        key = (tuple(padded_hw), str(device))
        if key not in self._cache:
            points, counts, strides, lo, hi = build_shifts(self.cfg,
                                                           tuple(padded_hw))
            dev = [torch.from_numpy(a).to(device)
                   for a in (points, strides, lo, hi)]
            self._cache[key] = Shifts(dev[0], counts, *dev[1:])
        return self._cache[key]


def centerness_target(deltas: torch.Tensor) -> torch.Tensor:
    """(..., 4) ltrb -> (...,) sqrt(min/max(l, r) * min/max(t, b)), 0 where
    a distance is negative."""
    lr, tb = deltas[..., 0::2], deltas[..., 1::2]

    def ratio(x):
        return (x.amin(-1) / x.amax(-1).clamp(min=1e-12)).clamp(min=0)

    return torch.sqrt(ratio(lr) * ratio(tb))


def center_sampled(boxes: torch.Tensor, shifts: torch.Tensor,
                   shift_strides: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., M, R) bool: the shift lies inside its box and within radius x
    its stride of the box's center (cvpods center sampling). boxes
    (..., M, 4), shifts (R, 2), shift_strides (R,)."""
    ctr = box_ops.centers(boxes)[..., None, :]
    r = (shift_strides * radius)[:, None]
    lo = torch.maximum(ctr - r, boxes[..., None, :2])
    hi = torch.minimum(ctr + r, boxes[..., None, 2:])
    return torch.cat([shifts - lo, hi - shifts], dim=-1).amin(-1) > 0


def fcos_ground_truth(cfg, shifts: torch.Tensor, shift_strides: torch.Tensor,
                      soi_lo: torch.Tensor, soi_hi: torch.Tensor,
                      gt: BatchedInstances):
    """FCOS.get_ground_truth (thirdparty_heads/fcos.py:177-284), one image
    at a time as the JAX package's ``lax.map``: a batch of the (M, R, 4)
    workspaces would be 0.57 GB at full width. A shift goes to the smallest
    box (the first on equal areas) whose center region holds it and whose
    largest distance lies in the shift's size range. Returns gt_classes
    (B, R) int64 (NUM_CLASSES = background), gt_deltas (B, R, 4) and
    gt_centerness (B, R)."""
    num_classes = cfg.MODEL.FCOS.NUM_CLASSES
    radius = cfg.MODEL.FCOS.CENTER_SAMPLING_RADIUS
    tf = Shift2BoxTransform(tuple(cfg.MODEL.FCOS.BBOX_REG_WEIGHTS))
    out = []
    for boxes, classes, valid in zip(gt.boxes, gt.classes, gt.valid):
        deltas = tf.get_deltas(shifts[None], boxes[:, None, :])  # (M, R, 4)
        if radius > 0:
            is_in = center_sampled(boxes, shifts, shift_strides, radius)
        else:
            is_in = deltas.amin(-1) > 0
        max_deltas = deltas.amax(-1)
        cared = (max_deltas >= soi_lo) & (max_deltas <= soi_hi)
        areas = torch.where(is_in & cared & valid[:, None],
                            box_ops.area(boxes)[:, None], INF)
        min_area, matched = areas.amin(0), areas.argmin(0)
        gt_deltas = tf.get_deltas(shifts, boxes[matched])
        out.append((torch.where(min_area < INF, classes[matched],
                                num_classes),
                    gt_deltas, centerness_target(gt_deltas)))
    return tuple(torch.stack(t) for t in zip(*out))


def fcos_losses(cfg, gt_classes: torch.Tensor, gt_deltas: torch.Tensor,
                gt_centerness: torch.Tensor, pred_logits: torch.Tensor,
                pred_deltas: torch.Tensor, pred_ctr: torch.Tensor,
                reg_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """cvpods FCOS.losses (fcos.py:107-175) normalized over the whole
    batch: focal loss over the foreground count, the centerness-weighted
    IoU loss over the foreground's summed centerness (times
    ``reg_weight``: ATSS's REG_WEIGHT), BCE centerness over the
    foreground count."""
    fcos = cfg.MODEL.FCOS
    num_classes = fcos.NUM_CLASSES
    fg = ((gt_classes >= 0) & (gt_classes != num_classes)).float()
    num_fg = fg.sum().clamp(min=1.0)
    num_targets = (gt_centerness * fg).sum().clamp(min=1.0)
    onehot = F.one_hot(gt_classes.clamp(0, num_classes - 1),
                       num_classes).float() * fg[..., None]
    loss_cls = L.sigmoid_focal_loss(pred_logits, onehot,
                                    alpha=fcos.FOCAL_LOSS_ALPHA,
                                    gamma=fcos.FOCAL_LOSS_GAMMA).sum() / num_fg
    reg = L.iou_loss(pred_deltas, gt_deltas, weight=gt_centerness,
                     box_mode="ltrb", loss_type=fcos.IOU_LOSS_TYPE)
    loss_box_reg = (reg * fg).sum() / num_targets * reg_weight
    ctr = L.binary_cross_entropy_with_logits(pred_ctr[..., 0], gt_centerness)
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box_reg,
            "loss_centerness": (ctr * fg).sum() / num_fg}


def shift_inference(cfg, pred_logits: torch.Tensor,
                    pred_deltas: torch.Tensor,
                    pred_ctr: Optional[torch.Tensor], shifts: torch.Tensor,
                    level_counts: Sequence[int], image_sizes: torch.Tensor,
                    nms: bool = True, keep_fn=None) -> BatchedDetections:
    """Per-level top-k -> score filter -> decode -> clip, then with ``nms``
    the top 2000 per image (equal scores in index order, as lax.top_k)
    through class-aware NMS, and the top DETECTIONS_PER_IMAGE
    (fcos.py:286-394; poto.py:386-489 without NMS). The score is
    sqrt(cls * ctr) with ``pred_ctr``, else the class probability.
    pred_logits (B, R, K), pred_deltas (B, R, 4), pred_ctr (B, R, 1),
    shifts (R, 2); image_sizes (B, 2) (h, w). ``keep_fn`` is the NMS
    sweep: by default ``nms.greedy_keep_sorted`` (kernel K2), looked up
    when it is called."""
    fcos = cfg.MODEL.FCOS
    num_classes = pred_logits.shape[-1]
    tf = Shift2BoxTransform(tuple(fcos.BBOX_REG_WEIGHTS))
    offsets = np.concatenate([[0], np.cumsum(level_counts)])

    boxes_all, scores_all, classes_all, valid_all = [], [], [], []
    for li in range(len(level_counts)):
        s, e = int(offsets[li]), int(offsets[li + 1])
        top_l, top_i = topk_flat_pairs(pred_logits[:, s:e],
                                       fcos.TOPK_CANDIDATES_TEST)
        top_p = torch.sigmoid(top_l)
        keep = top_p > fcos.SCORE_THRESH_TEST
        shift_idx = top_i // num_classes
        d = torch.gather(pred_deltas[:, s:e], 1,
                         shift_idx[..., None].expand(-1, -1, 4))
        boxes_all.append(tf.apply_deltas(d, shifts[s:e][shift_idx]))
        if pred_ctr is not None:
            ctr_p = torch.sigmoid(torch.gather(pred_ctr[:, s:e, 0], 1,
                                               shift_idx))
            top_p = torch.sqrt(top_p * ctr_p)
        scores_all.append(torch.where(keep, top_p, 0.0))
        classes_all.append(top_i % num_classes)
        valid_all.append(keep)
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    classes = torch.cat(classes_all, dim=1)
    valid = torch.cat(valid_all, dim=1)

    hw = image_sizes.to(boxes.dtype)
    boxes = box_ops.clip(boxes, hw[:, 0, None], hw[:, 1, None])
    max_dets = cfg.TEST.DETECTIONS_PER_IMAGE
    if not nms:
        b, s, c, v = topk_detections(boxes, scores, classes, valid, max_dets)
        return BatchedDetections(boxes=b, scores=s, classes=c, valid=v)
    top_s, idx = topk_stable(torch.where(valid, scores, -1.0),
                             min(2000, boxes.shape[1]))
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(classes, 1, idx)
    keep = batched_nms_mask(boxes, top_s, classes, top_s > 0,
                            fcos.NMS_THRESH_TEST, keep_fn)
    b, s, c, v = topk_detections(boxes, top_s, classes, keep, max_dets)
    return BatchedDetections(boxes=b, scores=s, classes=c, valid=v)


def fcos_inference(cfg, pred_logits, pred_deltas, pred_ctr, shifts,
                   level_counts, image_sizes, keep_fn=None):
    """Top-k per level -> threshold -> sqrt(cls * ctr) -> NMS
    (``shift_inference`` with the centerness)."""
    return shift_inference(cfg, pred_logits, pred_deltas, pred_ctr, shifts,
                           level_counts, image_sizes, keep_fn=keep_fn)
