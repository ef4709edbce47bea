"""Distillator meta-architectures (port of lgd_tpu/models/distillator.py).

Only the serving path is ported: the student's inference. The teacher, the
adapter and the distillation loss serve training and EVAL_TEACHER, and are
thrown away at inference (README); they come with the next slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..structures import BatchedDetections, BatchedInstances
from .heads.retinanet import (
    AnchorCache,
    RetinaNetCT,
    init_retinanet_,
    retinanet_inference,
)

META_ARCHS = {}

_TEACHER_LATER = ("the dynamic teacher (label encoder, attention kernel K1a) "
                  "comes with the next slice (ROADMAP.md, queue item 1)")
_TRAIN_LATER = ("training comes with the train step and kernel K1b "
                "(ROADMAP.md, queue item 2)")


def register_meta_arch(name):
    def deco(cls):
        META_ARCHS[name] = cls
        return cls

    return deco


def build_model(cfg, dtype: torch.dtype = torch.bfloat16,
                device="cpu", seed: Optional[int] = None) -> nn.Module:
    """META_ARCH_REGISTRY equivalent. With ``seed`` the weights are drawn
    from a ``torch.Generator`` seeded with it (on the host, so the draw
    does not depend on the device); otherwise they are left to be loaded."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in META_ARCHS:
        raise KeyError(f"Unknown META_ARCHITECTURE {name!r}; have "
                       f"{sorted(META_ARCHS)}")
    model = META_ARCHS[name](cfg, dtype=dtype)
    if seed is not None:
        model.init_weights_(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


@register_meta_arch("DistillatorRetinaNet")
class DistillatorRetinaNet(nn.Module):
    """reference models/distillator.py:23-114, student inference only."""

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.student = RetinaNetCT(cfg, dtype=dtype)
        self.anchors = AnchorCache(cfg)

    def init_weights_(self, generator: torch.Generator):
        init_retinanet_(self.student, generator)

    def _head_features(self, feats: Dict[str, torch.Tensor]):
        return [feats[f] for f in self.cfg.MODEL.RETINANET.IN_FEATURES]

    def train_forward(self, *args, **kwargs):
        raise NotImplementedError(_TRAIN_LATER)

    @torch.no_grad()
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  gt: Optional[BatchedInstances] = None,
                  eval_teacher: bool = False) -> BatchedDetections:
        """Eval path (reference distillator.py:70-86): student features
        through the student head, then NMS. images (B, 3, H, W) float32
        BGR on the model's device; image_sizes (B, 2) int (h, w)."""
        if eval_teacher:
            raise NotImplementedError(_TEACHER_LATER)
        anchors, counts = self.anchors(images.shape[-2:], images.device)
        _, feats = self.student(images, image_sizes)
        logits, deltas = self.student.predict(self._head_features(feats))
        return retinanet_inference(self.cfg, logits, deltas, anchors, counts,
                                   image_sizes)
