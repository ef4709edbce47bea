"""Feature Pyramid Network with the RetinaNet p6/p7 top (port of
lgd_tpu/models/backbones/fpn.py), NCHW. Submodule names match the flax
module: ``lateral_<in>``, ``output_p<l>``, ``top_p6``, ``top_p7``."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d


class FPN(nn.Module):
    """{p_lowest..p_top} from bottom-up features, with the p6p7 top block
    (detectron2 ``LastLevelP6P7``) fed from ``top_block_in_feature``."""

    def __init__(self, in_features: Sequence[str],
                 in_channels: Sequence[int], in_strides: Sequence[int],
                 out_channels: int = 256, top_block_in_feature: str = "res5",
                 top_block_in_channels: int = 2048,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features = tuple(in_features)
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
        # explicit symmetric padding 1 on the stride-2 convs (detectron2's
        # Conv2d(3, stride=2, padding=1); lgd_tpu/models/backbones/fpn.py:83-94)
        self.top_p6 = Conv2d(top_block_in_channels, out_channels, 3, stride=2,
                             padding=1, compute_dtype=dtype)
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
        src = (bottom_up[self.top_block_in_feature]
               if self.top_block_in_feature in bottom_up
               else outputs[self.top_block_in_feature])
        p6 = self.top_p6(src)
        outputs[f"p{last + 1}"] = p6
        outputs[f"p{last + 2}"] = self.top_p7(F.relu(p6))
        return outputs
