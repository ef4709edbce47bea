"""Shared layers (port of lgd_tpu/models/layers.py), NCHW.

Parameters are kept in float32 and each convolution runs in the model's
compute dtype, as flax's ``nn.Conv(dtype=...)`` does: input, kernel and
bias are cast to that dtype and the output stays in it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` with float32
    parameters."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype`` with
    float32 parameters. flax's ``nn.ConvTranspose`` (transpose_kernel
    False) equals it with the kernel flipped in both spatial axes; the
    param bridge flips."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` with float32
    parameters, as flax's ``nn.Dense(dtype=...)``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with constant affine and statistics (detectron2
    ``FrozenBatchNorm2d``), kept as buffers and folded into one
    ``x * w + b`` in float32 before the cast to the input's dtype
    (lgd_tpu/models/layers.py:36-38)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.scale / torch.sqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        return x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class GroupNorm32(nn.Module):
    """GroupNorm(32, eps 1e-5) as flax's ``nn.GroupNorm(dtype=float32)``
    computes it in the FCOS towers (lgd_tpu/models/heads/fcos.py:62-67):
    the input goes up to float32, is normalized there with the float32
    affine parameters ``scale`` and ``bias`` (flax's names), and goes back
    down to the input's dtype. flax takes the variance as E[x^2] - E[x]^2,
    torch in two passes; the two agree to float32 rounding where the mean
    is small against the spread, as it is after a convolution."""

    def __init__(self, num_features: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.scale,
                            self.bias, self.eps).to(x.dtype)


class Scale(nn.Module):
    """A learnable float32 scalar ``scale`` that multiplies its input in the
    input's dtype (lgd_tpu/models/layers.py:103-113; reference
    thirdparty_heads/scale.py)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last axis as flax's ``nn.LayerNorm(dtype=float32)``
    computes it in the Swin trunk (lgd_tpu/models/backbones/swin.py): the
    input goes up to float32, is normalized there with the float32 affine
    ``weight`` and ``bias``, and goes back down to the input's dtype. The
    epsilon is flax's 1e-6, not torch's 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__(num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample (lgd_tpu/models/backbones/swin.py:103-113):
    with ``u``, one uniform in [0, 1) per sample of axis 0, sample b keeps
    its residual branch when u[b] < 1 - rate and is scaled by 1 / (1 -
    rate); without ``u`` (inference) it is the identity. The JAX package
    draws the same Bernoulli from its ``dropout`` stream; the port takes
    the uniforms from the train step's generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or u is None:
            return x
        keep = 1.0 - self.rate
        mask = (u < keep).to(x.dtype).view(-1, *(1,) * (x.dim() - 1))
        return x * mask / keep


def get_norm(norm: str, num_features: int) -> Optional[nn.Module]:
    if norm in (None, "", "none"):
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(num_features)
    if norm == "GN":
        return GroupNorm32(num_features)
    raise ValueError(f"Unknown norm: {norm}")


def feature_strides(names):
    """Stride of each named feature map (lgd_tpu/models/layers.py:127):
    res<l>, stage<l> (Swin) and p<l> at 2 ** l. The JAX package's ``cfg``
    argument, which it reads for the dilated res5 of the C4 variants, is
    left out until those variants are ported."""
    return [2 ** int(n[-1]) for n in names]


def normalize_images(images: torch.Tensor, image_sizes: torch.Tensor,
                     pixel_mean, pixel_std) -> torch.Tensor:
    """(x - mean) / std, then zero the padding again, so padding is exactly
    0 after normalization (detectron2 pads after normalizing). images
    (B, 3, H, W); image_sizes (B, 2) (h, w)."""
    kw = dict(dtype=images.dtype, device=images.device)
    mean = torch.tensor(pixel_mean, **kw)[:, None, None]
    std = torch.tensor(pixel_std, **kw)[:, None, None]
    x = (images - mean) / std
    H, W = x.shape[-2:]
    yy = torch.arange(H, device=x.device)[None, :, None]
    xx = torch.arange(W, device=x.device)[None, None, :]
    inside = ((yy < image_sizes[:, 0, None, None])
              & (xx < image_sizes[:, 1, None, None]))
    return torch.where(inside[:, None], x, 0.0)
