"""RetinaNet student for inference (port of lgd_tpu/models/heads/retinanet.py),
NCHW inside, with the same decomposed API: backbone + FPN, ``predict`` to
(logits, deltas) in HWA order, and top-k -> score filter -> decode ->
class-aware NMS inference on padded, fixed-shape tensors.

Anchors come from the JAX package's numpy generator
(lgd_tpu/models/heads/anchors.py, which imports no jax).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lgd_tpu.models.heads.anchors import AnchorGenerator, feature_grid_sizes

from ...ops.nms import batched_nms_mask, greedy_keep_sorted, topk_detections
from ...ops.topk import topk_flat_pairs
from ...structures import BatchedDetections, Box2BoxTransform
from ...structures import boxes as box_ops
from ..backbones.fpn import FPN
from ..backbones.resnet import build_resnet
from ..layers import Conv2d

_LEVEL_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


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
        if "swint" in cfg.MODEL.BACKBONE.NAME:
            raise NotImplementedError(
                "the Swin-T backbone comes with the Swin slice (ROADMAP.md, "
                "queue item 9)")
        self.bottom_up = build_resnet(cfg, dtype=dtype)
        in_feats = tuple(cfg.MODEL.FPN.IN_FEATURES)
        res2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
        channels = {f"res{i + 2}": res2 * 2 ** i for i in range(4)}
        self.fpn = FPN(
            in_features=in_feats,
            in_channels=[channels[f] for f in in_feats],
            in_strides=[{"res2": 4, "res3": 8, "res4": 16, "res5": 32}[f]
                        for f in in_feats],
            out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            top_block_in_feature="res5",
            top_block_in_channels=channels["res5"],
            dtype=dtype,
        )
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
        """(x - mean) / std, then zero the padding again, so padding is
        exactly 0 after normalization (detectron2 pads after normalizing).
        images (B, 3, H, W); image_sizes (B, 2) (h, w)."""
        kw = dict(dtype=images.dtype, device=images.device)
        mean = torch.tensor(self.pixel_mean, **kw)[:, None, None]
        std = torch.tensor(self.pixel_std, **kw)[:, None, None]
        x = (images - mean) / std
        H, W = x.shape[-2:]
        yy = torch.arange(H, device=x.device)[None, :, None]
        xx = torch.arange(W, device=x.device)[None, None, :]
        inside = ((yy < image_sizes[:, 0, None, None])
                  & (xx < image_sizes[:, 1, None, None]))
        return torch.where(inside[:, None], x, 0.0)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor):
        """-> (raw bottom-up features, FPN features), both dicts."""
        raw = self.bottom_up(self.normalize(images, image_sizes))
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
    """Random weights drawn like the flax initializers: lecun-normal
    backbone convs, glorot-uniform FPN, normal(0.01) head with the
    focal-loss prior on the class bias; FrozenBN stays the identity."""
    for m in model.bottom_up.modules():
        if isinstance(m, Conv2d):
            fan_in = m.weight[0].numel()
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(fan_in),
                            generator=generator)
    for m in model.fpn.modules():
        if isinstance(m, Conv2d):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
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
    strides = [_LEVEL_STRIDES[f] for f in cfg.MODEL.RETINANET.IN_FEATURES]
    gen = AnchorGenerator(
        sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
        aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
        strides=strides,
        offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
    )
    per_level = gen(feature_grid_sizes(padded_hw, strides))
    return np.concatenate(per_level, axis=0), [len(a) for a in per_level]


def retinanet_inference(cfg, pred_logits: torch.Tensor,
                        pred_deltas: torch.Tensor, anchors: torch.Tensor,
                        level_counts: Sequence[int],
                        image_sizes: torch.Tensor,
                        keep_fn=greedy_keep_sorted) -> BatchedDetections:
    """Top-k per level -> score filter -> decode -> clip -> top 2000 ->
    class-aware NMS -> top DETECTIONS_PER_IMAGE, batched over images
    (detectron2 RetinaNet.inference semantics on padded static shapes).

    pred_logits (B, R, K), pred_deltas (B, R, 4), anchors (R, 4) on the
    same device; image_sizes (B, 2) (h, w). ``keep_fn`` is the NMS sweep
    (kernel K2 by default)."""
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
    """Anchors per padded canvas, built once on the host and kept on the
    device (they depend only on the canvas and the config)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._cache: Dict[tuple, Tuple[torch.Tensor, List[int]]] = {}

    def __call__(self, padded_hw, device) -> Tuple[torch.Tensor, List[int]]:
        key = (tuple(padded_hw), str(device))
        if key not in self._cache:
            anchors, counts = build_anchors(self.cfg, tuple(padded_hw))
            self._cache[key] = (torch.from_numpy(anchors).to(device), counts)
        return self._cache[key]
