"""Feature Pyramid Network with the p6/p7 top (RetinaNet, FCOS) or the
R-CNN max-pool p6 (port of lgd_tpu/models/backbones/fpn.py), NCHW. Submodule
names match the flax module: ``lateral_<in>``, ``output_p<l>``, ``top_p6``,
``top_p7``."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, feature_strides
from .resnet import DeformConvUnit, build_resnet
from .swin import SwinTransformer, build_swint


class FPN(nn.Module):
    """{p_lowest..p_top} from bottom-up features, with a top block:
    ``"p6p7"`` (detectron2 ``LastLevelP6P7``, fed from
    ``top_block_in_feature``) or ``"maxpool"`` (``LastLevelMaxPool``: p6 =
    the 1x1, stride-2 max pool of the last level)."""

    def __init__(self, in_features: Sequence[str],
                 in_channels: Sequence[int], in_strides: Sequence[int],
                 out_channels: int = 256, top_block: str = "p6p7",
                 top_block_in_feature: str = "res5",
                 top_block_in_channels: int = 2048,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if top_block not in ("p6p7", "maxpool"):
            raise ValueError(f"unknown FPN top block {top_block!r}")
        self.in_features = tuple(in_features)
        self.top_block = top_block
        self.top_block_in_feature = top_block_in_feature
        self.lowest_level = {4: 2, 8: 3, 16: 4, 32: 5}[in_strides[0]]
        levels = range(self.lowest_level, self.lowest_level + len(in_features))
        for f, c in zip(in_features, in_channels):
            self.add_module(f"lateral_{f}", Conv2d(
                c, out_channels, 1, compute_dtype=dtype))
        for lvl in levels:
            self.add_module(f"output_p{lvl}", Conv2d(
                out_channels, out_channels, 3, padding=1,
                compute_dtype=dtype))
        if top_block == "p6p7":
            # explicit symmetric padding 1 on the stride-2 convs (detectron2's
            # Conv2d(3, stride=2, padding=1); lgd_tpu/models/backbones/fpn.py:83-94)
            self.top_p6 = Conv2d(top_block_in_channels, out_channels, 3,
                                 stride=2, padding=1, compute_dtype=dtype)
            self.top_p7 = Conv2d(out_channels, out_channels, 3, stride=2,
                                 padding=1, compute_dtype=dtype)

    def forward(self, bottom_up: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral_{f}")(bottom_up[f])
                    for f in self.in_features]
        merged = list(laterals)
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(merged[i + 1], scale_factor=2, mode="nearest")
            merged[i] = laterals[i] + up
        outputs = {}
        for i, m in enumerate(merged):
            lvl = self.lowest_level + i
            outputs[f"p{lvl}"] = getattr(self, f"output_p{lvl}")(m)
        last = self.lowest_level + len(merged) - 1
        if self.top_block == "maxpool":
            outputs[f"p{last + 1}"] = F.max_pool2d(outputs[f"p{last}"], 1, 2)
        else:
            src = (bottom_up[self.top_block_in_feature]
                   if self.top_block_in_feature in bottom_up
                   else outputs[self.top_block_in_feature])
            p6 = self.top_p6(src)
            outputs[f"p{last + 1}"] = p6
            outputs[f"p{last + 2}"] = self.top_p7(F.relu(p6))
        return outputs


def build_fpn(cfg, top_block: str, dtype: torch.dtype,
              top_block_in_feature: str = "res5") -> FPN:
    """The FPN over the trunk's MODEL.FPN.IN_FEATURES (ResNet res2-res5,
    or Swin stage2-stage5 at EMBED_DIM * 2**i channels); the p6p7 top is
    fed from ``top_block_in_feature``: res5 (RetinaNet on ResNet) or p5
    (RetinaNet on Swin, and the cvpods FCOS, ATSS and POTO,
    lgd_tpu/models/heads/fcos.py:109-125)."""
    in_feats = tuple(cfg.MODEL.FPN.IN_FEATURES)
    res2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    embed = cfg.MODEL.SWINT.EMBED_DIM
    out_channels = cfg.MODEL.FPN.OUT_CHANNELS
    channels = {f"res{i + 2}": res2 * 2 ** i for i in range(4)}
    channels.update({f"stage{i + 2}": embed * 2 ** i for i in range(4)})
    channels.update({f"p{i}": out_channels for i in range(2, 8)})
    return FPN(in_features=in_feats,
               in_channels=[channels[f] for f in in_feats],
               in_strides=feature_strides(in_feats),
               out_channels=out_channels, top_block=top_block,
               top_block_in_feature=top_block_in_feature,
               top_block_in_channels=channels[top_block_in_feature],
               dtype=dtype)


def build_trunk(cfg, top_block: str, dtype: torch.dtype,
                resnet_top_in: str = "res5"):
    """(bottom_up, fpn) of a student: the Swin-T trunk when
    MODEL.BACKBONE.NAME names one (its p6/p7 from p5, JAX
    lgd_tpu/models/heads/retinanet.py:99-105), else the ResNet trunk with
    the p6/p7 top fed from ``resnet_top_in``."""
    if "swint" in cfg.MODEL.BACKBONE.NAME:
        return build_swint(cfg, dtype=dtype), build_fpn(cfg, top_block,
                                                        dtype, "p5")
    return build_resnet(cfg, dtype=dtype), build_fpn(cfg, top_block, dtype,
                                                     resnet_top_in)


def bottom_up_features(bottom_up: nn.Module, x: torch.Tensor,
                       drop_path=None) -> Dict[str, torch.Tensor]:
    """The trunk's features of normalized images; ``drop_path`` holds the
    Swin drop-paths' uniforms in training (None: no drop, as at
    inference)."""
    if drop_path is None:
        return bottom_up(x)
    return bottom_up(x, drop_path)


def init_trunk_(student: nn.Module, generator: torch.Generator):
    """Random weights of a student's ``bottom_up`` and ``fpn``, drawn like
    the flax initializers: a Swin trunk's own (``init_weights_``), or
    lecun-normal ResNet convs with FrozenBN the identity and deformable
    units' zero offset convs and he-normal weights; glorot-uniform FPN
    convs with zero biases."""
    if isinstance(student.bottom_up, SwinTransformer):
        student.bottom_up.init_weights_(generator)
    else:
        _init_resnet_(student.bottom_up, generator)
    for m in student.fpn.modules():
        if isinstance(m, Conv2d):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)


def _init_resnet_(bottom_up: nn.Module, generator: torch.Generator):
    for m in bottom_up.modules():
        if isinstance(m, Conv2d):
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(
                m.weight[0].numel()), generator=generator)
    for m in bottom_up.modules():
        if isinstance(m, DeformConvUnit):
            m.init_weights_(generator)
