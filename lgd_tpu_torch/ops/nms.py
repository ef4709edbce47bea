"""Exact greedy NMS over padded, batched candidates (port of
lgd_tpu/ops/nms.py).

Candidates are fixed-capacity ``(B, N)`` tensors with a validity mask.
Sorting stays outside the kernel, as in the JAX package: a stable argsort
of the masked scores, so equal scores keep index order. The greedy sweep
over the score-sorted boxes is kernel K2, ``greedy_keep_sorted``: the
hand-written CUDA kernel in ``csrc/nms.cu`` (replacing the Pallas
``_sweep_kernel``) for tensors on the card, and its plain PyTorch version
``greedy_keep_sorted_reference`` for tensors on the CPU. One kernel serves
every NMS call; the JAX package's fixpoint iteration and tiling are not
ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..structures.boxes import pairwise_iou

NEG_INF = -1e10
_WORD = 64
# the sweep keeps ceil(N / 64) uint64 words in (static-limit) shared memory
MAX_CANDIDATES = _WORD * (48 * 1024 // 8)

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .. import csrc

        lib = csrc.load("nms")
        p = ctypes.c_void_p
        lib.lgd_nms_keep_sorted.argtypes = [p, p, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, p, p, p]
        lib.lgd_nms_keep_sorted.restype = ctypes.c_int
        _lib = lib
    return _lib


def greedy_keep_sorted_reference(boxes_s: torch.Tensor,
                                 valid_s: torch.Tensor,
                                 iou_threshold: float) -> torch.Tensor:
    """Plain version of kernel K2: boxes_s (B, N, 4) in score order,
    valid_s (B, N) bool -> keep (B, N) bool in the same order. Row i is
    kept iff it is valid and no kept earlier row j has IoU(j, i) > thr."""
    n = boxes_s.shape[-2]
    thr = float(np.float32(iou_threshold))
    idx = torch.arange(n, device=boxes_s.device)
    sup = (pairwise_iou(boxes_s, boxes_s) > thr) & (idx[:, None] < idx[None])
    removed = ~valid_s
    keep = torch.zeros_like(valid_s)
    for i in range(n):
        k = ~removed[:, i]
        keep[:, i] = k
        removed = removed | (sup[:, i] & k[:, None])
    return keep


def greedy_keep_sorted(boxes_s: torch.Tensor, valid_s: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Kernel K2. Same contract as ``greedy_keep_sorted_reference``, which
    it runs only for tensors on the CPU; on the card it launches
    ``csrc/nms.cu`` and counts the launch in ``greedy_keep_sorted.launches``.
    """
    if boxes_s.device.type == "cpu":
        return greedy_keep_sorted_reference(boxes_s, valid_s, iou_threshold)
    if boxes_s.device.type != "cuda":
        raise ValueError(f"NMS kernel: unsupported device {boxes_s.device}")
    if boxes_s.dtype != torch.float32 or valid_s.dtype != torch.bool:
        raise TypeError(f"NMS kernel takes float32 boxes and bool valid, got "
                        f"{boxes_s.dtype} and {valid_s.dtype}")
    if (boxes_s.dim() != 3 or boxes_s.shape[-1] != 4
            or tuple(valid_s.shape) != tuple(boxes_s.shape[:2])):
        raise ValueError(f"NMS kernel takes boxes (B, N, 4) and valid (B, N),"
                         f" got {tuple(boxes_s.shape)} and "
                         f"{tuple(valid_s.shape)}")
    if valid_s.device != boxes_s.device:
        raise ValueError("NMS kernel: boxes and valid on different devices")
    if not (boxes_s.is_contiguous() and valid_s.is_contiguous()):
        raise ValueError("NMS kernel takes contiguous tensors")
    B, N = valid_s.shape
    if N > MAX_CANDIDATES:
        raise ValueError(f"NMS kernel: {N} candidates > {MAX_CANDIDATES}")
    words = -(-N // _WORD)
    mask = torch.empty((B, N, words), dtype=torch.int64, device=boxes_s.device)
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes_s.device)
    lib = _kernel()
    with torch.cuda.device(boxes_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lgd_nms_keep_sorted(
            boxes_s.data_ptr(), valid_s.data_ptr(), B, N,
            float(np.float32(iou_threshold)), mask.data_ptr(),
            keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    greedy_keep_sorted.launches += 1
    return keep


greedy_keep_sorted.launches = 0


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, keep_fn=None) -> torch.Tensor:
    """Exact greedy NMS per image.

    boxes (B, N, 4), scores (B, N), valid (B, N) bool -> keep (B, N) bool in
    input order; suppressed and invalid entries are False. ``keep_fn`` is
    the sweep: the module's ``greedy_keep_sorted`` (kernel K2) when None,
    looked up at the call, or its plain version for comparison runs.
    """
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.argsort(-masked, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(masked, 1, order) > NEG_INF
    keep_s = (keep_fn or greedy_keep_sorted)(boxes_s.contiguous(), valid_s,
                                             iou_threshold)
    return torch.zeros_like(keep_s).scatter_(1, order, keep_s)


def batched_nms_mask(boxes, scores, classes, valid, iou_threshold: float,
                     keep_fn=None) -> torch.Tensor:
    """Class-aware NMS via the coordinate-offset trick (detectron2
    ``batched_nms``): each class is shifted by class * (max valid coord + 1)
    so boxes of different classes never overlap. Batched over images."""
    max_coord = torch.where(valid[..., None], boxes, 0.0).amax(dim=(1, 2)) + 1.0
    offsets = classes.to(boxes.dtype) * max_coord[:, None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold,
                    keep_fn)


def topk_detections(boxes, scores, classes, keep, k: int):
    """Top-k kept detections per image into fixed-size padded outputs:
    (boxes (B, k, 4), scores (B, k), classes (B, k), valid (B, k))."""
    masked = torch.where(keep, scores, NEG_INF)
    top_scores, idx = torch.topk(masked, k, dim=-1)
    out_valid = top_scores > NEG_INF
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.where(out_valid, top_scores, 0.0),
            torch.gather(classes, 1, idx), out_valid)
