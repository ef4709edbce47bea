"""Modulated deformable convolution, DCNv2 (port of
lgd_tpu/ops/deform_conv.py, its exact gather form ``impl='gather'``), NCHW.

A 3x3 deformable conv samples each tap k of each output position at the
base grid point plus a learned offset, bilinearly, scales the sample by a
modulation mask, and contracts the sampled columns with the weight. The
offset layout is detectron2's: channels (2k, 2k + 1) of ``offsets`` hold
(dy, dx) of tap k = ky * kw + kx; ``mask`` has one channel per tap and is
already through a sigmoid (None: the unmodulated form). Padding is
dilation * (k // 2), as the ResNet 3x3 uses.

The sampling is kernel K4, hand-written CUDA in ``csrc/deform_conv.cu``
(replacing the Pallas sampler ``_pallas_sampler`` and the dense-path VJP
that served as its backward):

- ``deform_sample_fwd`` writes the columns (B, C, K, Ho, Wo) in the
  input's dtype, each sample computed in float32 and rounded once (per run
  of output positions, from a window of x staged in shared memory);
- ``deform_sample_bwd`` takes the columns' gradient and gives the
  gradients of x (summed per tile of output positions in a fixed-point
  window in shared memory, then added to a float32 buffer with global
  atomics and cast once), of the offsets and of the mask, and recomputes
  the columns on the way for the weight's gradient.

A CUDA tensor always goes to the kernel; a CPU tensor goes to the plain
version, ``deform_sample_reference`` (the backward: its autograd
gradient). The contraction with the weight is ``torch.matmul``, batched
over the groups, outside the kernel as JAX's einsum is. The
``torch.autograd.Function`` keeps only x, the offsets, the mask and the
weight: holding the columns of the 30 deformable layers of R-101-DCNv2
would take about 10 GB at batch 16, so the backward recomputes them, as
JAX's ``jax.checkpoint`` does.

The gather form is exact for any offset: a corner is valid iff it lies in
the image, corners come from ``floor``, and the offset's derivative is the
bilinear weights' derivative with those corners, also at integer positions
(where every zero-initialised offset conv starts). The JAX package's
windowed ``dense``/``pallas`` paths clamp offsets beyond about 6 feature px
(a TPU deviation) and are not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# taps per output position that the forward takes (csrc/deform_conv.cu,
# kMaxTaps): kernels up to 3 x 3
MAX_TAPS = 9

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import csrc

        lib = csrc.load("deform_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        geometry = [i] * 11  # B, C, H, W, Ho, Wo, kh, kw, stride, pad, dil
        lib.lgd_deform_sample_fwd.argtypes = [p, i, p, p, *geometry, p, p]
        lib.lgd_deform_sample_fwd.restype = i
        lib.lgd_deform_sample_bwd.argtypes = [p, p, i, p, p, *geometry, p, p,
                                              p, p, p]
        lib.lgd_deform_sample_bwd.restype = i
        _lib = lib
    return _lib


def output_size(H: int, W: int, kernel_size: int = 3, stride: int = 1,
                dilation: int = 1) -> Tuple[int, int]:
    """(Ho, Wo) with padding dilation * (k // 2)
    (lgd_tpu/ops/deform_conv.py:113-116)."""
    pad = dilation * (kernel_size // 2)
    span = dilation * (kernel_size - 1) + 1
    return ((H + 2 * pad - span) // stride + 1,
            (W + 2 * pad - span) // stride + 1)


def base_grid(Ho: int, Wo: int, kernel_size: int = 3, stride: int = 1,
              dilation: int = 1, device=None) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The sample points with zero offsets, (K, Ho, Wo) float32 each:
    y = ho * stride - pad + ky * dilation, x likewise
    (lgd_tpu/ops/deform_conv.py:118-126)."""
    pad = dilation * (kernel_size // 2)
    taps = torch.arange(kernel_size, device=device) * dilation
    oy = torch.arange(Ho, device=device) * stride - pad
    ox = torch.arange(Wo, device=device) * stride - pad
    ky = taps.repeat_interleave(kernel_size)  # tap k = ky * kw + kx
    kx = taps.repeat(kernel_size)
    K = kernel_size * kernel_size
    y = (ky[:, None, None] + oy[None, :, None]).expand(K, Ho, Wo)
    x = (kx[:, None, None] + ox[None, None, :]).expand(K, Ho, Wo)
    return y.float(), x.float()


def deform_sample_reference(x: torch.Tensor, offsets: torch.Tensor,
                            mask: Optional[torch.Tensor],
                            kernel_size: int = 3, stride: int = 1,
                            dilation: int = 1) -> torch.Tensor:
    """Plain version of kernel K4's forward. x (B, C, H, W); offsets
    (B, 2K, Ho, Wo); mask (B, K, Ho, Wo) or None. Returns the columns
    (B, C, K, Ho, Wo) in x's dtype: each sample in float32 as
    ``g00*(1-wy)*(1-wx) + g01*(1-wy)*wx + g10*wy*(1-wx) + g11*wy*wx``, in
    this order, times the mask, rounded once; the kernel does the same
    arithmetic in the same order, so the two agree bit for bit in float32.
    Differentiable: its autograd gradient is the plain version of the
    backward. One image at a time, so that the gathers stay small."""
    B, C, H, W = x.shape
    K = kernel_size * kernel_size
    Ho, Wo = offsets.shape[-2:]
    base_y, base_x = base_grid(Ho, Wo, kernel_size, stride, dilation,
                               x.device)
    off = offsets.float().reshape(B, K, 2, Ho, Wo)
    py = base_y + off[:, :, 0]  # (B, K, Ho, Wo)
    px = base_x + off[:, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    out = []
    for b in range(B):
        xf = x[b].float().reshape(C, H * W)

        def corner(yc, xc):
            # an invalid corner (outside, or a NaN offset) reads texel 0
            valid = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
            idx = torch.where(valid, yc * W + xc, 0.0).long()
            g = torch.gather(xf, 1, idx.reshape(1, -1).expand(C, -1))
            return torch.where(valid.reshape(1, -1), g, 0.0).reshape(
                C, K, Ho, Wo)

        g00 = corner(y0[b], x0[b])
        g01 = corner(y0[b], x0[b] + 1)
        g10 = corner(y0[b] + 1, x0[b])
        g11 = corner(y0[b] + 1, x0[b] + 1)
        a, ay = 1 - wy[b], wy[b]
        bx, ax = 1 - wx[b], wx[b]
        s = g00 * a * bx + g01 * a * ax + g10 * ay * bx + g11 * ay * ax
        if mask is not None:
            s = s * mask[b].float()
        out.append(s.to(x.dtype))
    return torch.stack(out)


def _geometry(x, offsets, kernel_size, stride, dilation):
    B, C, H, W = x.shape
    Ho, Wo = offsets.shape[-2:]
    return [B, C, H, W, Ho, Wo, kernel_size, kernel_size, stride,
            dilation * (kernel_size // 2), dilation]


def _check(x, offsets, mask, kernel_size, stride, dilation, grad=None):
    """What the kernels take: CUDA tensors on one card, contiguous; x
    (B, C, H, W) float32 or bfloat16; up to MAX_TAPS taps; float32 offsets
    (B, 2K, Ho, Wo) and mask (B, K, Ho, Wo) at the conv's output size; the
    columns' gradient (B, C, K, Ho, Wo) in x's dtype."""
    tensors = [t for t in (x, offsets, mask, grad) if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("deformable sampling kernels take CUDA tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("deformable sampling kernels: tensors on different "
                         "devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("deformable sampling kernels take contiguous "
                         "tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"deformable sampling takes float32 or bfloat16 "
                        f"input, not {x.dtype}")
    if kernel_size ** 2 > MAX_TAPS:
        raise ValueError(f"deformable sampling kernels take up to "
                         f"{MAX_TAPS} taps, not a {kernel_size} x "
                         f"{kernel_size} kernel")
    if any(t.dtype != torch.float32 for t in (offsets, mask)
           if t is not None):
        raise TypeError("offsets and mask must be float32")
    K = kernel_size * kernel_size
    B = x.shape[0]
    Ho, Wo = output_size(*x.shape[-2:], kernel_size, stride, dilation)
    if x.dim() != 4 or tuple(offsets.shape) != (B, 2 * K, Ho, Wo):
        raise ValueError(f"offsets {tuple(offsets.shape)} for input "
                         f"{tuple(x.shape)}: want {(B, 2 * K, Ho, Wo)}")
    if mask is not None and tuple(mask.shape) != (B, K, Ho, Wo):
        raise ValueError(f"mask {tuple(mask.shape)}: want {(B, K, Ho, Wo)}")
    if grad is not None and (grad.dtype != x.dtype or tuple(grad.shape) != (
            B, x.shape[1], K, Ho, Wo)):
        raise ValueError(f"columns' gradient {grad.dtype} "
                         f"{tuple(grad.shape)} for input {x.dtype} "
                         f"{tuple(x.shape)}")
    return _kernel()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def deform_sample_fwd(x: torch.Tensor, offsets: torch.Tensor,
                      mask: Optional[torch.Tensor], kernel_size: int = 3,
                      stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Kernel K4, forward: ``deform_sample_reference`` on the card, for CPU
    tensors the reference itself. Counts each launch in
    ``deform_sample_fwd.launches``."""
    if x.device.type == "cpu":
        return deform_sample_reference(x, offsets, mask, kernel_size, stride,
                                       dilation)
    lib = _check(x, offsets, mask, kernel_size, stride, dilation)
    geo = _geometry(x, offsets, kernel_size, stride, dilation)
    B, C, _, _, Ho, Wo = geo[:6]
    cols = torch.empty((B, C, kernel_size ** 2, Ho, Wo), dtype=x.dtype,
                       device=x.device)
    if cols.numel() == 0:
        return cols
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lgd_deform_sample_fwd(
            x.data_ptr(), _DTYPES[x.dtype], offsets.data_ptr(), _ptr(mask),
            *geo, cols.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"deformable sampling forward launch failed: "
                           f"cudaError {err}")
    deform_sample_fwd.launches += 1
    return cols


def deform_sample_bwd_reference(grad_cols, x, offsets, mask, kernel_size=3,
                                stride=1, dilation=1):
    """Plain version of kernel K4's backward: autograd of the plain
    forward, one image at a time, with the columns it recomputes.
    -> (dx in x's dtype, doffsets and dmask (None without a mask) in
    float32, columns)."""
    outs = []
    for b in range(x.shape[0]):
        one = [t[b:b + 1] for t in (x, offsets, mask) if t is not None]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in one]
            cols = deform_sample_reference(
                leaves[0], leaves[1], leaves[2] if mask is not None else None,
                kernel_size, stride, dilation)
            grads = torch.autograd.grad(cols, leaves, grad_cols[b:b + 1])
        outs.append((*grads, cols.detach()))
    dx, doff, *rest = (torch.cat(t) for t in zip(*outs))
    dmask = rest[0] if mask is not None else None
    return dx, doff, dmask, rest[-1]


def deform_sample_bwd(grad_cols: torch.Tensor, x: torch.Tensor,
                      offsets: torch.Tensor, mask: Optional[torch.Tensor],
                      kernel_size: int = 3, stride: int = 1,
                      dilation: int = 1):
    """Kernel K4, backward, for the columns' gradient ``grad_cols``
    (B, C, K, Ho, Wo) in x's dtype. Returns (dx in x's dtype, doffsets and
    dmask in float32 (dmask None without a mask), the columns recomputed
    as the forward writes them). dx is summed per tile of output
    positions in a window in shared memory, in fixed point scaled to a
    bound of the stage's sums (each share rounded under 2^-29 of it), and
    the windows (and the rare samples that leave them) are added with
    float32 atomics into a zeroed float32 buffer, cast once; so the order
    of its sums changes from run to run. Each offset's and mask's gradient
    is a thread's sum over a block's channels, added across blocks where
    several split the channels. For CPU tensors,
    ``deform_sample_bwd_reference``.
    Counts each launch in ``deform_sample_bwd.launches``."""
    if x.device.type == "cpu":
        return deform_sample_bwd_reference(grad_cols, x, offsets, mask,
                                           kernel_size, stride, dilation)
    lib = _check(x, offsets, mask, kernel_size, stride, dilation, grad_cols)
    geo = _geometry(x, offsets, kernel_size, stride, dilation)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    doff = torch.empty_like(offsets)
    dmask = None if mask is None else torch.empty_like(mask)
    cols = torch.empty_like(grad_cols)
    if cols.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lgd_deform_sample_bwd(
                grad_cols.data_ptr(), x.data_ptr(), _DTYPES[x.dtype],
                offsets.data_ptr(), _ptr(mask), *geo, dx.data_ptr(),
                doff.data_ptr(), _ptr(dmask), cols.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"deformable sampling backward launch failed: "
                               f"cudaError {err}")
        deform_sample_bwd.launches += 1
    else:
        doff.zero_()
        if dmask is not None:
            dmask.zero_()
    return dx.to(x.dtype), doff, dmask, cols


deform_sample_fwd.launches = 0
deform_sample_bwd.launches = 0


class _DeformConv(torch.autograd.Function):
    """K4 forward, then the weight contraction; the backward recomputes the
    columns inside K4's backward. Saves x, offsets, mask and weight only."""

    @staticmethod
    def forward(ctx, x, weight, offsets, mask, stride, dilation, groups):
        ctx.conf = (stride, dilation, groups)
        ctx.save_for_backward(x, weight, offsets, mask)
        cols = deform_sample_fwd(x, offsets, mask, weight.shape[-1], stride,
                                 dilation)
        return _contract(cols, weight, groups)

    @staticmethod
    def backward(ctx, g):
        stride, dilation, groups = ctx.conf
        x, weight, offsets, mask = ctx.saved_tensors
        B, F, Ho, Wo = g.shape
        C, k = x.shape[1], weight.shape[-1]
        Fg, CgK = F // groups, (C // groups) * k * k
        g = g.contiguous().view(B, groups, Fg, Ho * Wo)
        w = weight.reshape(groups, Fg, CgK)
        grad_cols = torch.matmul(w.transpose(1, 2), g)  # (B, g, CgK, P)
        dx, doff, dmask, cols = deform_sample_bwd(
            grad_cols.view(B, C, k * k, Ho, Wo), x, offsets, mask, k, stride,
            dilation)
        # per-image products rounded to the compute dtype, summed in float32
        dw = torch.matmul(g, cols.view(B, groups, CgK, Ho * Wo)
                          .transpose(2, 3)).float().sum(0)
        return (dx, dw.view(weight.shape).to(weight.dtype), doff, dmask,
                None, None, None)


def _contract(cols, weight, groups):
    """(B, C, K, Ho, Wo) columns with the (F, C / groups, kh, kw) weight ->
    (B, F, Ho, Wo), one matrix product per group."""
    B, C, K, Ho, Wo = cols.shape
    F = weight.shape[0]
    w = weight.reshape(groups, F // groups, (C // groups) * K)
    out = torch.matmul(w, cols.view(B, groups, (C // groups) * K, Ho * Wo))
    return out.view(B, F, Ho, Wo)


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor,
                  offsets: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  stride: int = 1, dilation: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """Modulated deformable conv (lgd_tpu/ops/deform_conv.py:76,
    ``impl='gather'``). x (B, C, H, W) in the compute dtype; weight
    (F, C / groups, k, k) in the same dtype; offsets (B, 2k^2, Ho, Wo) and
    mask (B, k^2, Ho, Wo) or None, float32. Returns (B, F, Ho, Wo) in x's
    dtype: the columns in the compute dtype contracted with the weight,
    float32 accumulation inside the matrix product. Kernel K4 samples for
    tensors on the card, the plain version for tensors on the CPU."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deformable conv: unsupported device {x.device}")
    if weight.dtype != x.dtype:
        raise TypeError(f"weight {weight.dtype} and input {x.dtype} differ")
    if x.shape[1] != weight.shape[1] * groups or weight.shape[0] % groups:
        raise ValueError(f"weight {tuple(weight.shape)} for {x.shape[1]} "
                         f"channels in {groups} groups")
    offsets = offsets.float().contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    return _DeformConv.apply(x.contiguous(), weight, offsets, mask, stride,
                             dilation, groups)
