"""Feature adapters applied to the student FPN features before the distill
loss (port of lgd_tpu/models/lgd/adapters.py); optimized with the student
solver."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d

ADAPTERS = {}


def register_adapter(name):
    def deco(cls):
        ADAPTERS[name] = cls
        return cls

    return deco


@register_adapter("SequentialConvs")
class SequentialConvs(nn.Module):
    """conv3x3 -> relu -> conv3x3 -> relu -> conv3x3, shared across levels,
    computing in ``dtype``."""

    def __init__(self, channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv{i}", Conv2d(channels, channels, 3,
                                               padding=1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        return self.conv2(x)


def build_adapter(cfg, dtype: torch.dtype = torch.float32) -> nn.Module:
    name = cfg.MODEL.DISTILLATOR.ADAPTER.META_ARCH
    if name not in ADAPTERS:
        raise KeyError(f"Unknown ADAPTER.META_ARCH {name!r}; have "
                       f"{sorted(ADAPTERS)}")
    return ADAPTERS[name](channels=cfg.MODEL.FPN.OUT_CHANNELS, dtype=dtype)
