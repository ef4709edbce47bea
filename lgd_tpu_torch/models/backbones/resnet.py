"""ResNet / ResNeXt bottom-up backbone (port of
lgd_tpu/models/backbones/resnet.py), NCHW.

Same architecture and submodule names as the flax module, so the weight
bridge maps names one to one:

- stem: 7x7/2 conv (padding 3) + FrozenBN + relu + 3x3/2 max-pool
  (padding 1);
- stages res2..res5 of bottleneck blocks, a projection shortcut on the
  first block of each stage, the stride in the 1x1 when STRIDE_IN_1X1;
- ``_STAGE_BLOCKS`` is the JAX package's: depths 18 and 34 are bottleneck
  stacks too, not torchvision's basic blocks.

Deformable stages (DEFORM_ON_PER_STAGE) come with the DCN slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, get_norm

_STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 num_groups: int = 1, norm: str = "FrozenBN",
                 stride_in_1x1: bool = True, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        stride_1x1, stride_3x3 = ((stride, 1) if stride_in_1x1
                                  else (1, stride))

        def conv(name, cin, cout, k, s, groups=1, dil=1):
            self.add_module(name, Conv2d(
                cin, cout, k, stride=s, padding=dil * (k // 2), dilation=dil,
                groups=groups, bias=False, compute_dtype=dtype))
            n = get_norm(norm, cout)
            if n is not None:
                self.add_module(f"{name}_norm", n)

        self.has_shortcut = in_channels != out_channels or stride != 1
        if self.has_shortcut:
            conv("shortcut", in_channels, out_channels, 1, stride)
        conv("conv1", in_channels, bottleneck_channels, 1, stride_1x1)
        conv("conv2", bottleneck_channels, bottleneck_channels, 3, stride_3x3,
             groups=num_groups, dil=dilation)
        conv("conv3", bottleneck_channels, out_channels, 1, 1)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        norm = getattr(self, f"{name}_norm", None)
        return norm(x) if norm is not None else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self._conv("shortcut", x) if self.has_shortcut else x
        out = F.relu(self._conv("conv1", x))
        out = F.relu(self._conv("conv2", out))
        out = self._conv("conv3", out)
        return F.relu(out + shortcut)


class ResNet(nn.Module):
    """Returns {name: feature} for the requested stages; res2..res5 have
    256, 512, 1024, 2048 channels at the default widths."""

    def __init__(self, depth: int = 50, num_groups: int = 1,
                 width_per_group: int = 64, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, stride_in_1x1: bool = True,
                 res5_dilation: int = 1, norm: str = "FrozenBN",
                 out_features: Sequence[str] = ("res3", "res4", "res5"),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.out_features = tuple(out_features)
        self.stem_conv1 = Conv2d(3, stem_out_channels, 7, stride=2,
                                 padding=3, bias=False, compute_dtype=dtype)
        self.stem_conv1_norm = get_norm(norm, stem_out_channels)

        blocks_per_stage = _STAGE_BLOCKS[depth]
        bottleneck = num_groups * width_per_group
        out_channels = res2_out_channels
        in_channels = stem_out_channels
        # build only through the deepest requested stage
        last_stage = max(int(f[3]) for f in self.out_features) - 1
        self.block_names = []
        for stage_idx in range(last_stage):
            dilation = res5_dilation if stage_idx == 3 else 1
            first_stride = 1 if stage_idx == 0 or dilation > 1 else 2
            names = []
            for block_idx in range(blocks_per_stage[stage_idx]):
                name = f"res{stage_idx + 2}_{block_idx}"
                self.add_module(name, BottleneckBlock(
                    in_channels, out_channels, bottleneck,
                    stride=first_stride if block_idx == 0 else 1,
                    num_groups=num_groups, norm=norm,
                    stride_in_1x1=stride_in_1x1, dilation=dilation,
                    dtype=dtype))
                in_channels = out_channels
                names.append(name)
            self.block_names.append((f"res{stage_idx + 2}", names))
            bottleneck *= 2
            out_channels *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem_conv1(x)
        if self.stem_conv1_norm is not None:
            x = self.stem_conv1_norm(x)
        x = F.max_pool2d(F.relu(x), kernel_size=3, stride=2, padding=1)
        outputs = {}
        for stage, names in self.block_names:
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_features:
                outputs[stage] = x
        return outputs


def build_resnet(cfg, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    r = cfg.MODEL.RESNETS
    if any(r.DEFORM_ON_PER_STAGE):
        raise NotImplementedError(
            "deformable ResNet stages (DCNv2, kernel K4) come with the DCN "
            "slice (ROADMAP.md, queue item 8)")
    return ResNet(
        depth=r.DEPTH,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1,
        res5_dilation=r.RES5_DILATION,
        norm=r.NORM,
        out_features=tuple(r.OUT_FEATURES),
        dtype=dtype,
    )
