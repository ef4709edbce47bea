"""Multilevel ROIAlign over an FPN pyramid (port of
lgd_tpu/ops/roi_align.py), NCHW. ROIAlignV2 only (aligned: box corners
shifted by half a texel), the one kind the JAX package's heads pool with.

Every ROI is routed to one pyramid level (detectron2
``assign_boxes_to_levels``) and pooled to ``out x out`` bins; each bin
averages an adaptive ``ceil(bin)`` grid of bilinear samples per axis,
capped at ``S_MAX`` = 4 (the JAX package's static sample grid: exact for
FPN-routed ROIs, a uniform 4-point average beyond). A sample
outside ``[-1, size]`` weighs 0, coordinates clamp into ``[0, size - 1]``,
and invalid ROIs pool to zeros.

The routing and each ROI's geometry (level, batch index, sample counts,
origin and bin sizes) are computed here in PyTorch by ``roi_geometry``, for
the kernel and its plain version alike, so that the card's ``log2f`` never
routes a box to another level than the host does. The pooling is kernel K3:
``roi_align_fwd`` and ``roi_align_bwd``, hand-written CUDA in
``csrc/roi_align.cu`` (replacing the Pallas ``_roi_pallas_fwd`` and the
dense-path transpose that served as its VJP), behind a
``torch.autograd.Function`` whose backward gives the features their
gradient and the boxes none (proposals are detached upstream, as in the
JAX package's custom VJP). On the CPU ``multilevel_roi_align`` runs the
plain version, ``multilevel_roi_align_reference``, differentiated by
autograd; any other device raises.

The pooled output is (B, P, C, out, out): channels before the bins, as
detectron2's ROIAlign writes them. The JAX package's is (B, P, out, out,
C); the param bridge reorders the box head's first layer to match.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

# the kernel takes the levels' pointers and sizes by value, in a small
# struct of this many slots
MAX_LEVELS = 8
# samples per bin axis at most: FPN routing keeps a bin near 1-4 texels of
# its level, so the cap binds only past the top level's range
S_MAX = 4
# bins per side that the kernels take (csrc/roi_align.cu, kMaxOut), and
# samples per bin axis (kMaxTexels / 2: each sample's two corners)
MAX_OUT = 16
MAX_SAMPLES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import csrc

        lib = csrc.load("roi_align")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lgd_roi_align_fwd.argtypes = [p, p, p, i, i, i, p, p, i, i, p, i,
                                          p]
        lib.lgd_roi_align_fwd.restype = i
        lib.lgd_roi_align_bwd.argtypes = [p, i, p, p, i, i, i, p, p, p, i, p]
        lib.lgd_roi_align_bwd.restype = i
        _lib = lib
    return _lib


def assign_fpn_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                      canonical_size: float = 224.0,
                      canonical_level: int = 4) -> torch.Tensor:
    """detectron2 assign_boxes_to_levels: floor(canonical_level +
    log2(sqrt(area) / canonical_size + 1e-8)), clamped to [min_level,
    max_level]. boxes (..., 4) -> (...,) int64."""
    area = ((boxes[..., 2] - boxes[..., 0])
            * (boxes[..., 3] - boxes[..., 1])).clamp(min=1e-6)
    lvl = torch.floor(canonical_level + torch.log2(
        torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).long()


def roi_geometry(boxes: torch.Tensor, box_valid: torch.Tensor,
                 strides: Sequence[int], output_size: int, min_level: int,
                 sampling_ratio: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ROI routing and sample geometry, shared by the kernel and its
    plain version. boxes (B, P, 4) in input coordinates, box_valid (B, P)
    bool. Returns, for the R = B * P ROIs in row-major order:

    index  (R, 4) int32: batch index, level (-1 for an invalid ROI),
           samples per bin along y (ny) and along x (nx);
    coords (R, 4) float32: y and x of the ROI's origin on its level, and
           the bin height and width there.

    Sample (iy, ix) of bin (ph, pw) sits at y = y0 + bin_h * (ph + (iy +
    0.5) / ny) (x likewise), weighted 1 / (ny * nx)
    (lgd_tpu/ops/roi_align.py:48-111)."""
    B, P, _ = boxes.shape
    boxes = boxes.detach().float()
    L = len(strides)
    levels = assign_fpn_levels(boxes, min_level, min_level + L - 1) - min_level
    levels = torch.where(box_valid, levels, 0)
    stride = torch.tensor([float(s) for s in strides], device=boxes.device)[
        levels]
    x1 = boxes[..., 0] / stride - 0.5
    y1 = boxes[..., 1] / stride - 0.5
    x2 = boxes[..., 2] / stride - 0.5
    y2 = boxes[..., 3] / stride - 0.5
    bin_w = (x2 - x1).clamp(min=1e-3) / output_size
    bin_h = (y2 - y1).clamp(min=1e-3) / output_size
    if sampling_ratio > 0:
        ny = torch.full_like(bin_h, sampling_ratio, dtype=torch.int32)
        nx = ny
    else:
        # detectron2's roi_bin_grid = ceil(bin), at least 1, capped
        ny = torch.ceil(bin_h).clamp(1, S_MAX).int()
        nx = torch.ceil(bin_w).clamp(1, S_MAX).int()
    batch = torch.arange(B, device=boxes.device)[:, None].expand(B, P)
    level = torch.where(box_valid, levels, -1)
    index = torch.stack([batch, level, ny, nx], dim=-1).reshape(B * P, 4)
    coords = torch.stack([y1, x1, bin_h, bin_w], dim=-1).reshape(B * P, 4)
    return index.int().contiguous(), coords.contiguous()


def _bilinear_axis(coord, size, slot_w):
    """detectron2 bilinear_interpolate along one axis, as the kernel does
    it: (low index, weight, high index, weight), with the sample's share
    ``slot_w`` folded into the weights. coord float32 (n, out); size
    (n, 1) int64; slot_w (n, 1) float32."""
    sizef = size.float()
    inside = (coord >= -1.0) & (coord <= sizef)
    c = torch.minimum(coord.clamp(min=0.0), sizef - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    c0i = c0.long()
    c1i = torch.minimum(c0i + 1, size - 1)
    w0 = torch.where(inside, (1.0 - frac) * slot_w, 0.0)
    w1 = torch.where(inside, frac * slot_w, 0.0)
    return c0i, w0, c1i, w1


def multilevel_roi_align_reference(features: Sequence[torch.Tensor],
                                   index: torch.Tensor, coords: torch.Tensor,
                                   output_size: int, roi_chunk: int = 256,
                                   out_dtype=None) -> torch.Tensor:
    """Plain version of kernel K3's forward: the 4-corner gather form
    (lgd_tpu/ops/roi_align.py:308-330) in float32 accumulation, over ROI
    chunks so that the gathers stay small: the samples of a bin in (iy, ix)
    order, each the sum of its four weighted corners, with the kernel's
    sample positions and weights. The kernel sums the same products in
    another order (along each row of the ROI's window, then down the rows),
    so the two agree within float32 rounding; its autograd gradient is the
    plain version of the backward. features: per-level (B, C, Hl, Wl) of
    one dtype; index
    and coords from ``roi_geometry``. Returns (R, C, out, out) in
    ``out_dtype`` (the features' by default)."""
    B, C = features[0].shape[:2]
    dev = features[0].device
    out_dtype = out_dtype or features[0].dtype
    R, out = index.shape[0], output_size
    hw = torch.tensor([f.shape[-2:] for f in features], device=dev)
    offsets = torch.cumsum(hw[:, 0] * hw[:, 1], 0) - hw[:, 0] * hw[:, 1]
    # every level's pixels on one axis, channels last: (B, sum HlWl, C)
    flat = torch.cat([f.flatten(2) for f in features], dim=2)
    flat = flat.transpose(1, 2).contiguous()
    n_max = max(int(index[:, 2:].max()), 1) if R else 1
    grid = torch.arange(out, device=dev, dtype=torch.float32)
    chunks = []
    for s in range(0, R, roi_chunk):
        idx, crd = index[s:s + roi_chunk].long(), coords[s:s + roi_chunk]
        b, valid = idx[:, 0], idx[:, 1] >= 0
        lvl = idx[:, 1].clamp(min=0)
        H, W = hw[lvl, 0:1], hw[lvl, 1:2]
        base = offsets[lvl][:, None, None]
        ny, nx = idx[:, 2:3].float(), idx[:, 3:4].float()
        acc = 0.0
        for iy in range(n_max):
            # explicit divisions: a python number over a tensor would be a
            # reciprocal times the number, rounded twice
            ty = torch.full_like(ny, iy + 0.5) / ny
            sw = torch.where(iy < ny, torch.ones_like(ny) / ny, 0.0)
            yc = crd[:, 0:1] + crd[:, 2:3] * (grid + ty)
            y0, wy0, y1, wy1 = _bilinear_axis(yc, H, sw)
            for ix in range(n_max):
                tx = torch.full_like(nx, ix + 0.5) / nx
                sw = torch.where(ix < nx, torch.ones_like(nx) / nx, 0.0)
                xc = crd[:, 1:2] + crd[:, 3:4] * (grid + tx)
                x0, wx0, x1, wx1 = _bilinear_axis(xc, W, sw)

                def corner(yi, wy, xi, wx):
                    pix = base + yi[:, :, None] * W[:, :, None] + xi[:, None]
                    g = flat[b[:, None, None], pix].float()  # (n, out, out, C)
                    return g * (wy[:, :, None] * wx[:, None, :])[..., None]

                acc = acc + (corner(y0, wy0, x0, wx0)
                             + corner(y0, wy0, x1, wx1)
                             + corner(y1, wy1, x0, wx0)
                             + corner(y1, wy1, x1, wx1))
        acc = torch.where(valid[:, None, None, None], acc, 0.0)
        chunks.append(acc.permute(0, 3, 1, 2).to(out_dtype))
    if not chunks:
        return torch.zeros((0, C, out, out), dtype=out_dtype, device=dev)
    return torch.cat(chunks)


def _check(features, index, coords, output_size, grad=None):
    """What the kernels take: CUDA tensors on one card, contiguous; the
    levels (B, C, Hl, Wl) in one dtype, float32 or bfloat16, at most
    MAX_LEVELS of them; index (R, 4) int32 and coords (R, 4) float32; at
    most MAX_OUT bins per side."""
    tensors = [*features, index, coords] + ([grad] if grad is not None
                                            else [])
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("ROIAlign kernels take CUDA tensors")
    if any(t.device != index.device for t in tensors):
        raise ValueError("ROIAlign kernels: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ROIAlign kernels take contiguous tensors")
    if not 1 <= len(features) <= MAX_LEVELS:
        raise ValueError(f"ROIAlign kernels take 1..{MAX_LEVELS} levels, got "
                         f"{len(features)}")
    dtype = features[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in features):
        raise TypeError(f"ROIAlign kernels take float32 or bfloat16 levels "
                        f"of one dtype, got {[f.dtype for f in features]}")
    if any(f.dim() != 4 or f.shape[:2] != features[0].shape[:2]
           for f in features):
        raise ValueError(f"ROIAlign kernels take (B, C, H, W) levels of one "
                         f"B and C, got {[tuple(f.shape) for f in features]}")
    if index.dtype != torch.int32 or coords.dtype != torch.float32:
        raise TypeError(f"index must be int32 and coords float32, got "
                        f"{index.dtype} and {coords.dtype}")
    if (index.dim() != 2 or index.shape[1] != 4
            or coords.shape != index.shape):
        raise ValueError(f"index and coords must be (R, 4), got "
                         f"{tuple(index.shape)} and {tuple(coords.shape)}")
    if not 1 <= output_size <= MAX_OUT:
        raise ValueError(f"ROIAlign kernels take 1..{MAX_OUT} bins per side, "
                         f"got {output_size}")
    return _kernel()


def _levels(tensors):
    """The levels' pointers, heights and widths as C arrays (kept alive by
    the caller until the call returns), and their count."""
    L = len(tensors)
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in tensors])
    hs = (ctypes.c_int * L)(*[t.shape[2] for t in tensors])
    ws = (ctypes.c_int * L)(*[t.shape[3] for t in tensors])
    return ptrs, hs, ws, L


def _addr(arr) -> ctypes.c_void_p:
    return ctypes.cast(arr, ctypes.c_void_p)


def roi_align_fwd(features: Sequence[torch.Tensor], index: torch.Tensor,
                  coords: torch.Tensor, output_size: int,
                  out_dtype=None) -> torch.Tensor:
    """Kernel K3, forward: ``multilevel_roi_align_reference`` on the card,
    (R, C, out, out) in ``out_dtype`` (the features' by default; float32
    keeps bfloat16 levels' sums unrounded). Per ROI the kernel lists each
    bin's texels and weights along each axis once; each pooled value is
    then Ay F Ax^T restricted to its bin, every texel its samples touch
    read once (the sums in another order than the plain version's). It
    takes at most MAX_SAMPLES samples per bin axis, as ``roi_geometry``
    gives them. Counts each launch in ``roi_align_fwd.launches``."""
    lib = _check(features, index, coords, output_size)
    out_dtype = out_dtype or features[0].dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"ROIAlign forward writes float32 or bfloat16, not "
                        f"{out_dtype}")
    R, C = index.shape[0], features[0].shape[1]
    out = torch.empty((R, C, output_size, output_size), dtype=out_dtype,
                      device=index.device)
    if R == 0:
        return out
    ptrs, hs, ws, L = _levels(features)
    with torch.cuda.device(index.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lgd_roi_align_fwd(
            _addr(ptrs), _addr(hs), _addr(ws), L, C,
            _DTYPES[features[0].dtype], index.data_ptr(),
            coords.data_ptr(), R, output_size, out.data_ptr(),
            _DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"ROIAlign forward launch failed: cudaError {err}")
    roi_align_fwd.launches += 1
    return out


def roi_align_bwd(grad: torch.Tensor, index: torch.Tensor,
                  coords: torch.Tensor,
                  features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Kernel K3, backward: the gradient of each level for the pooled
    gradient ``grad`` (R, C, out, out), the exact transpose of the forward.
    ``features`` gives the levels' shapes and dtype (their values are not
    read). Per ROI and channel the kernel forms the gradient of the ROI's
    texel window as Ay^T G Ax (the separable sample weights per bin and
    texel along each axis, G the pooled gradient) and adds it with float32
    atomics into zeroed float32 buffers, cast at the end to the levels'
    dtype; ROIs overlap, so the order of the sums changes from run to run.
    Counts each launch in ``roi_align_bwd.launches``."""
    lib = _check(features, index, coords, grad.shape[-1], grad)
    if grad.dtype not in _DTYPES:
        raise TypeError(f"ROIAlign backward takes a float32 or bfloat16 "
                        f"gradient, not {grad.dtype}")
    R, C = index.shape[0], features[0].shape[1]
    out = grad.shape[-1]
    if tuple(grad.shape) != (R, C, out, out):
        raise ValueError(f"gradient {tuple(grad.shape)} for {R} ROIs of "
                         f"{C} channels")
    bufs = [torch.zeros(f.shape, dtype=torch.float32, device=f.device)
            for f in features]
    if R:
        ptrs, hs, ws, L = _levels(bufs)
        with torch.cuda.device(index.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lgd_roi_align_bwd(
                grad.data_ptr(), _DTYPES[grad.dtype], index.data_ptr(),
                coords.data_ptr(), R, C, out, _addr(ptrs), _addr(hs),
                _addr(ws), L, stream)
        if err != 0:
            raise RuntimeError(
                f"ROIAlign backward launch failed: cudaError {err}")
        roi_align_bwd.launches += 1
    return [b.to(f.dtype) for b, f in zip(bufs, features)]


roi_align_fwd.launches = 0
roi_align_bwd.launches = 0


class _MultilevelRoiAlign(torch.autograd.Function):
    """K3 forward, K3 backward; the boxes get no gradient."""

    @staticmethod
    def forward(ctx, index, coords, output_size, *features):
        ctx.save_for_backward(index, coords, *features)
        return roi_align_fwd(features, index, coords, output_size)

    @staticmethod
    def backward(ctx, g):
        index, coords, *features = ctx.saved_tensors
        grads = roi_align_bwd(g.contiguous(), index, coords, features)
        return (None, None, None, *grads)


def multilevel_roi_align(features: Sequence[torch.Tensor],
                         boxes: torch.Tensor, box_valid: torch.Tensor,
                         strides: Sequence[int], output_size: int,
                         min_level: int,
                         sampling_ratio: int = 0) -> torch.Tensor:
    """features: per-level (B, C, Hl, Wl); boxes (B, P, 4) in input
    coordinates; box_valid (B, P) bool. Returns (B, P, C, out, out) in the
    features' dtype: kernel K3 for tensors on the card, the plain version
    for tensors on the CPU."""
    B, P = box_valid.shape
    index, coords = roi_geometry(boxes, box_valid, strides, output_size,
                                 min_level, sampling_ratio)
    dev = features[0].device
    if dev.type == "cpu":
        pooled = multilevel_roi_align_reference(features, index, coords,
                                                output_size)
    elif dev.type == "cuda":
        if sampling_ratio > MAX_SAMPLES:
            raise ValueError(f"ROIAlign kernels take up to {MAX_SAMPLES} "
                             f"samples per bin axis, not {sampling_ratio}")
        feats = [f.contiguous() for f in features]
        pooled = _MultilevelRoiAlign.apply(index, coords, output_size,
                                           *feats)
    else:
        raise ValueError(f"ROIAlign: unsupported device {dev}")
    return pooled.reshape(B, P, *pooled.shape[1:])
