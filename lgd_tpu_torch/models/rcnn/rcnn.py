"""Generalized R-CNN student (Faster and Mask R-CNN) on the FPN trunk
(port of lgd_tpu/models/rcnn/rcnn.py), NCHW.

The decomposed API of the reference RCNNCT: ``forward`` gives the raw and
FPN features; ``predict`` runs the RPN and the ROI heads on any feature
pyramid (the student's, or the teacher's for the '.tea' losses) and returns
the loss dict; ``infer_boxes`` gives the detections and, with MASK_ON,
their mask probabilities. Proposals are fixed
(B, POST_NMS_TOPK) slabs. ``predict`` takes the sample's uniforms as an
argument, shaped by ``sampling_shapes``, where the JAX package draws them
from its ``sampling`` stream: ``rpn`` (B, R) for the anchor sample, then
``roi_sample`` and ``roi_order`` (B, POST_NMS_TOPK_TRAIN + M) for the
proposal sample, in the order JAX draws them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...structures import BatchedDetections, BatchedInstances
from ..backbones.fpn import bottom_up_features, build_trunk
from ..heads.retinanet import AnchorCache
from ..layers import feature_strides, normalize_images
from .roi_heads import (
    StandardROIHeads,
    class_masks,
    fast_rcnn_inference,
    fast_rcnn_losses,
    label_and_sample_proposals,
    mask_rcnn_loss,
    take_fg_subset,
)
from .rpn import (
    RPN,
    generate_proposals,
    label_rpn_anchors,
    rpn_anchors,
    rpn_losses,
)


class RCNNCT(nn.Module):
    """Decomposed Faster or Mask R-CNN student on a ResNet or Swin-T FPN
    trunk with the max-pool p6 (detectron2 Base-RCNN-FPN; the reference's
    build_swint_fpn_backbone)."""

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        name = cfg.MODEL.BACKBONE.NAME
        if "fpn" not in name:
            raise NotImplementedError(
                f"R-CNN trunk {name!r}: the port has the ResNet and Swin-T "
                "FPN trunks; C4 and DilatedC5 come with ROADMAP.md port "
                "queue item 10")
        if cfg.MODEL.ROI_HEADS.NAME != "StandardROIHeads":
            raise NotImplementedError(
                f"ROI heads {cfg.MODEL.ROI_HEADS.NAME!r} come with the C4 "
                "variants (ROADMAP.md, port queue item 10)")
        self.cfg = cfg
        self.bottom_up, self.fpn = build_trunk(cfg, "maxpool", dtype)
        out_channels = cfg.MODEL.FPN.OUT_CHANNELS
        self.rpn = RPN(cfg, out_channels, dtype=dtype)
        self.roi_heads = StandardROIHeads(cfg, out_channels, dtype=dtype)
        self.pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
        self.pixel_std = tuple(cfg.MODEL.PIXEL_STD)
        self.mask_on = cfg.MODEL.MASK_ON
        self.anchors = AnchorCache(
            lambda hw: rpn_anchors(cfg, hw, self.rpn.in_features))

    def normalize(self, images: torch.Tensor,
                  image_sizes: torch.Tensor) -> torch.Tensor:
        return normalize_images(images, image_sizes, self.pixel_mean,
                                self.pixel_std)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                drop_path=None):
        """-> (raw bottom-up features, FPN features p2-p6), both dicts;
        ``drop_path``: a Swin trunk's drop-path uniforms in training."""
        raw = bottom_up_features(self.bottom_up,
                                 self.normalize(images, image_sizes),
                                 drop_path)
        return raw, self.fpn(raw)

    def _padded_hw(self, feats: Dict[str, torch.Tensor]):
        """The padded canvas, from the first RPN level's grid."""
        f0 = self.rpn.in_features[0]
        stride = feature_strides([f0])[0]
        h, w = feats[f0].shape[-2:]
        return (h * stride, w * stride)

    def sampling_shapes(self, batch_size: int, padded_hw,
                        num_gt: int) -> Dict[str, tuple]:
        """Shapes of ``predict``'s uniforms for a batch on one canvas with
        ``num_gt`` GT slots per image."""
        anchors, _ = self.anchors(padded_hw, self.rpn.head.conv.weight.device)
        pool = self.cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + (
            num_gt if self.cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT else 0)
        return {"rpn": (batch_size, len(anchors)),
                "roi_sample": (batch_size, pool),
                "roi_order": (batch_size, pool)}

    def predict(self, feats: Dict[str, torch.Tensor],
                image_sizes: torch.Tensor, gt: BatchedInstances,
                uniforms: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The RPN and ROI training pass on a feature pyramid; returns the
        loss dict (reference frcnn.py:59-76). The proposals carry no
        gradient. With MASK_ON and GT masks, ``loss_mask`` comes from the
        mask head on the slab's foreground-first top k = BATCH_SIZE_PER_IMAGE
        * POSITIVE_FRACTION, its other slots pooled as invalid ROIs."""
        cfg = self.cfg
        anchors, counts = self.anchors(self._padded_hw(feats),
                                       image_sizes.device)
        logits, deltas = self.rpn(feats)
        gt_labels, matched = label_rpn_anchors(cfg, anchors, gt)
        losses = rpn_losses(cfg, logits, deltas, gt_labels, matched, anchors,
                            uniforms["rpn"])
        prop_boxes, _, prop_valid = generate_proposals(
            cfg, logits.detach(), deltas.detach(), anchors, counts,
            image_sizes, training=True)
        sampled = label_and_sample_proposals(
            cfg, prop_boxes, prop_valid, gt, uniforms["roi_sample"],
            uniforms["roi_order"])
        scores, box_deltas = self.roi_heads.box_forward(
            feats, sampled["boxes"], sampled["valid"])
        losses.update(fast_rcnn_losses(cfg, scores, box_deltas, sampled, gt))
        if self.mask_on and (gt.mask_crops is not None
                             or gt.bitmasks is not None):
            heads = cfg.MODEL.ROI_HEADS
            k = max(int(heads.BATCH_SIZE_PER_IMAGE * heads.POSITIVE_FRACTION),
                    1)
            sub = take_fg_subset(sampled, k)
            mask_logits = self.roi_heads.mask_forward(feats, sub["boxes"],
                                                      sub["is_fg"])
            losses["loss_mask"] = mask_rcnn_loss(cfg, mask_logits, sub, gt)
        return losses

    def infer_boxes(self, feats: Dict[str, torch.Tensor],
                    image_sizes: torch.Tensor
                    ) -> Tuple[BatchedDetections, Optional[torch.Tensor]]:
        """Proposals -> box head -> per-class NMS; with MASK_ON the mask
        head on the detections, the sigmoid of each one's class channel
        (B, D, 2R, 2R), else None."""
        cfg = self.cfg
        anchors, counts = self.anchors(self._padded_hw(feats),
                                       image_sizes.device)
        logits, deltas = self.rpn(feats)
        prop_boxes, _, prop_valid = generate_proposals(
            cfg, logits, deltas, anchors, counts, image_sizes,
            training=False)
        scores, box_deltas = self.roi_heads.box_forward(feats, prop_boxes,
                                                        prop_valid)
        dets = fast_rcnn_inference(cfg, scores, box_deltas, prop_boxes,
                                   prop_valid, image_sizes)
        if not self.mask_on:
            return dets, None
        logits = self.roi_heads.mask_forward(feats, dets.boxes, dets.valid)
        return dets, torch.sigmoid(class_masks(logits, dets.classes))
