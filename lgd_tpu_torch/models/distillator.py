"""Distillator meta-architectures: student + DynamicTeacher + adapter (port
of lgd_tpu/models/distillator.py: RetinaNet, Faster R-CNN, FCOS, ATSS and
POTO).

``train_forward`` computes the whole LGD loss dict of one step:

    student forward -> student losses
    teacher forward (from GT + student FPN features) -> teacher features
        scored by the student's own head with the student's loss, keys
        suffixed '.tea'
    distill loss: adapter(student) and teacher -> InstanceNorm ->
        lambda * MSE

Detach rules (reference base_distillator.py:52-55): teacher features are
always detached in the distill loss; student features are detached iff
distillation is off. The phase flag is a number, and the gate
``x.detach() + flag * (x - x.detach())`` keeps the value and scales the
gradient by the flag, as the JAX package's traced flag does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.normalization import instance_norm_2d
from ..structures import BatchedDetections, BatchedInstances
from .heads.retinanet import (
    AnchorCache,
    RetinaNetCT,
    build_anchors,
    init_retinanet_,
    label_anchors,
    retinanet_inference,
    retinanet_losses,
)
from .backbones.fpn import init_trunk_
from .heads.atss import ATSSCT, atss_ground_truth, atss_inference, atss_losses
from .heads.fcos import (
    FCOSCT,
    ShiftCache,
    fcos_ground_truth,
    fcos_inference,
    fcos_losses,
    init_fcos_,
)
from .heads.poto import POTOCT, poto_ground_truth, poto_inference, poto_losses
from .layers import Conv2d
from .lgd.adapters import build_adapter
from .lgd.dynamic_teacher import DynamicTeacher
from .rcnn.rcnn import RCNNCT

META_ARCHS = {}


def register_meta_arch(name):
    def deco(cls):
        META_ARCHS[name] = cls
        return cls

    return deco


def build_model(cfg, dtype: torch.dtype = torch.bfloat16,
                device="cuda", seed: Optional[int] = None) -> nn.Module:
    """META_ARCH_REGISTRY equivalent, on the card unless the caller names
    another device. With ``seed`` the weights are drawn from a
    ``torch.Generator`` seeded with it (on the host, so the draw does not
    depend on the device); otherwise they are left to be loaded."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in META_ARCHS:
        raise KeyError(f"Unknown META_ARCHITECTURE {name!r}; have "
                       f"{sorted(META_ARCHS)}")
    model = META_ARCHS[name](cfg, dtype=dtype)
    if seed is not None:
        model.init_weights_(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def gate_gradient(x: torch.Tensor, flag: float) -> torch.Tensor:
    """The value of x with its gradient scaled by flag (0.0 or 1.0)."""
    sg = x.detach()
    return sg + flag * (x - sg)


def _lecun_normal_(modules, generator: torch.Generator):
    """Random weights like flax's default initializers: normal(0,
    1/sqrt(fan_in)) kernels and zero biases."""
    for m in modules:
        if isinstance(m, (Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(fan_in),
                            generator=generator)
            nn.init.zeros_(m.bias)


class BaseDistillator(nn.Module):
    """What every distillator shares (lgd_tpu/models/distillator.py:81-136):
    the float32 teacher, the adapter, the distill loss and their seeded
    initialization. Subclasses give the student, which computes in
    ``dtype``, as does the adapter, and the detector's class count
    ``num_classes``."""

    def __init__(self, cfg, student: nn.Module,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.student = student
        t = cfg.MODEL.DISTILLATOR.TEACHER
        self.teacher = DynamicTeacher(
            num_classes=cfg.NUM_CLASSES,
            channels=cfg.MODEL.FPN.OUT_CHANNELS,
            num_heads=t.NR_TRANSFORMER_HEADS,
            interact_pattern=t.INTERACT_PATTERN,
            add_context_box=t.ADD_CONTEXT_BOX,
            detach_appearance_embed=t.DETACH_APPEARANCE_EMBED,
            use_seg_map=cfg.MODEL.DISTILLATOR.LABEL_ENCODER.LOAD_LABELMAP,
        )
        self.adapter = build_adapter(cfg, dtype=dtype)
        self.distill_lambda = float(cfg.MODEL.DISTILLATOR.LAMBDA)

    def init_weights_(self, generator: torch.Generator):
        self.init_student_(generator)
        _lecun_normal_(self.teacher.modules(), generator)
        _lecun_normal_(self.adapter.modules(), generator)

    def sampling_shapes(self, batch_size: int, padded_hw,
                        num_gt: int) -> Dict[str, Dict[str, tuple]]:
        """The uniforms ``train_forward`` takes, by name and shape: a Swin
        trunk's drop-paths', if any; an R-CNN student's samples come
        first."""
        return self._drop_path_shapes(batch_size)

    def _drop_path_shapes(self, batch_size: int) -> Dict[str, tuple]:
        """``drop_path``: (2 * sum(depths), B), two uniforms per Swin block
        and image, when the student's trunk is Swin with a positive
        DROP_PATH_RATE. The JAX package runs the student with train=True
        in every train_forward, so drop-path is on in training
        (lgd_tpu/models/distillator.py:164,210,255,296,339)."""
        trunk = self.student.bottom_up
        if getattr(trunk, "drop_path_rate", 0.0) > 0.0:
            return {"drop_path": (trunk.num_drop_path_draws, batch_size)}
        return {}

    def _student_features(self, images: torch.Tensor,
                          image_sizes: torch.Tensor, uniforms=None):
        """The student's FPN features in training, with the drop-paths'
        uniforms when ``sampling_shapes`` asked for them."""
        drop_path = None if uniforms is None else uniforms.get("drop_path")
        return self.student(images, image_sizes, drop_path)[1]

    def distill_loss(self, stu_feats: Dict[str, torch.Tensor],
                     tea_feats: Dict[str, torch.Tensor],
                     distill_flag: float) -> torch.Tensor:
        """lambda * MSE over InstanceNorm'd, adapter-mapped features: the
        mean over all elements of every level, as F.mse_loss of the
        per-image concatenation."""
        keys = sorted(set(stu_feats) & set(tea_feats))
        total_se, total_count = 0.0, 0
        for k in keys:
            s = gate_gradient(stu_feats[k].float(), distill_flag)
            t = tea_feats[k].float().detach()
            s = instance_norm_2d(self.adapter(s).float())
            t = instance_norm_2d(t)
            total_se = total_se + ((s - t) ** 2).sum()
            total_count += s.numel() // s.shape[0]
        bs = stu_feats[keys[0]].shape[0]
        return self.distill_lambda * total_se / (bs * total_count)


@register_meta_arch("DistillatorRetinaNet")
class DistillatorRetinaNet(BaseDistillator):
    """reference models/distillator.py:23-114."""

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg, RetinaNetCT(cfg, dtype=dtype), dtype)
        self.num_classes = cfg.MODEL.RETINANET.NUM_CLASSES
        self.anchors = AnchorCache(lambda hw: build_anchors(cfg, hw))

    def init_student_(self, generator: torch.Generator):
        init_retinanet_(self.student, generator)

    def _head_features(self, feats: Dict[str, torch.Tensor]):
        return [feats[f] for f in self.cfg.MODEL.RETINANET.IN_FEATURES]

    def train_forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                      gt: BatchedInstances, distill_flag: float,
                      loss_normalizer: torch.Tensor, uniforms=None):
        """One LGD training forward. images (B, 3, H, W) float32 BGR on the
        model's device; image_sizes (B, 2) (h, w); gt on the same device.
        Returns (losses incl. '.tea' and 'loss_distill', new normalizer):
        the normalizer goes through the student losses, then the teacher's
        (lgd_tpu/models/distillator.py:153-180). ``uniforms`` holds the
        Swin drop-paths' uniforms, if ``sampling_shapes`` names them."""
        padded_hw = tuple(images.shape[-2:])
        anchors, _ = self.anchors(padded_hw, images.device)
        feats = self._student_features(images, image_sizes, uniforms)
        tea_feats, _, _ = self.teacher(gt, feats, padded_hw)
        # the student's head scores both pyramids in two separate passes
        logits, deltas = self.student.predict(self._head_features(feats))
        logits_tea, deltas_tea = self.student.predict(
            self._head_features(tea_feats))
        gt_labels, gt_boxes = label_anchors(self.cfg, anchors, gt)
        losses, loss_normalizer = retinanet_losses(
            self.cfg, logits, deltas, gt_labels, gt_boxes, anchors,
            loss_normalizer)
        losses_tea, loss_normalizer = retinanet_losses(
            self.cfg, logits_tea, deltas_tea, gt_labels, gt_boxes, anchors,
            loss_normalizer)
        losses.update({k + ".tea": v for k, v in losses_tea.items()})
        losses["loss_distill"] = self.distill_loss(feats, tea_feats,
                                                   distill_flag)
        return losses, loss_normalizer

    @torch.no_grad()
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  gt: Optional[BatchedInstances] = None,
                  eval_teacher: bool = False) -> BatchedDetections:
        """Eval path (reference distillator.py:70-86): student features,
        with ``eval_teacher`` replaced by the teacher's (which needs the
        GT), through the student head, then NMS. images (B, 3, H, W)
        float32 BGR on the model's device; image_sizes (B, 2) int (h, w)."""
        padded_hw = tuple(images.shape[-2:])
        anchors, counts = self.anchors(padded_hw, images.device)
        _, feats = self.student(images, image_sizes)
        if eval_teacher:
            if gt is None:
                raise ValueError("eval_teacher needs the GT annotations")
            feats, _, _ = self.teacher(gt, feats, padded_hw)
        logits, deltas = self.student.predict(self._head_features(feats))
        return retinanet_inference(self.cfg, logits, deltas, anchors, counts,
                                   image_sizes)


@register_meta_arch("DistillatorGeneralizedRCNN")
class DistillatorGeneralizedRCNN(BaseDistillator):
    """reference models/distillator.py:117-198: the '.tea' losses re-run
    the student's whole RPN and ROI pipeline on the teacher's p2-p6
    (frcnn.py:59-76), with proposals of their own."""

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg, RCNNCT(cfg, dtype=dtype), dtype)
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES

    def init_student_(self, generator: torch.Generator):
        """The flax initializers: the trunk's (see ``init_trunk_``),
        normal(0.01) RPN convs and class scores, normal(0.001) box deltas,
        lecun-normal FCs, zero biases; the mask head's normal(0.001) convs
        and predictor and its lecun-normal deconvolution."""
        s = self.student
        init_trunk_(s, generator)
        head = s.rpn.head
        predictor = s.roi_heads.box_predictor
        normal = [(head.conv, 0.01), (head.objectness_logits, 0.01),
                  (head.anchor_deltas, 0.01), (predictor.cls_score, 0.01),
                  (predictor.bbox_pred, 0.001)]
        if s.mask_on:
            mask = s.roi_heads.mask_head
            normal += [(getattr(mask, f"mask_fcn{i + 1}"), 0.001)
                       for i in range(mask.num_conv)]
            normal.append((mask.predictor, 0.001))
            # flax's fan-in of a transposed kernel (kh, kw, in, out)
            w = mask.deconv.weight
            fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            nn.init.normal_(w, 0.0, 1.0 / math.sqrt(fan_in),
                            generator=generator)
            nn.init.zeros_(mask.deconv.bias)
        for m, std in normal:
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
            nn.init.zeros_(m.bias)
        _lecun_normal_(s.roi_heads.box_head.modules(), generator)

    def sampling_shapes(self, batch_size: int, padded_hw,
                        num_gt: int) -> Dict[str, Dict[str, tuple]]:
        """The student's uniforms for its pass over its own features, then
        for its pass over the teacher's, then a Swin trunk's drop-paths'
        for its one forward."""
        shapes = self.student.sampling_shapes(batch_size, padded_hw, num_gt)
        return {"student": shapes, "teacher": shapes,
                **self._drop_path_shapes(batch_size)}

    def train_forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                      gt: BatchedInstances, distill_flag: float,
                      loss_normalizer: torch.Tensor,
                      uniforms: Dict[str, Dict[str, torch.Tensor]]):
        """One LGD training forward (as DistillatorRetinaNet's); the loss
        normalizer passes through unchanged. ``uniforms`` holds the
        sample's uniforms of both student passes, and a Swin trunk's
        drop-paths', shaped by ``sampling_shapes``."""
        padded_hw = tuple(images.shape[-2:])
        feats = self._student_features(images, image_sizes, uniforms)
        losses = self.student.predict(feats, image_sizes, gt,
                                      uniforms["student"])
        tea_feats, _, _ = self.teacher(gt, feats, padded_hw)
        losses_tea = self.student.predict(tea_feats, image_sizes, gt,
                                          uniforms["teacher"])
        losses.update({k + ".tea": v for k, v in losses_tea.items()})
        losses["loss_distill"] = self.distill_loss(feats, tea_feats,
                                                   distill_flag)
        return losses, loss_normalizer

    @torch.no_grad()
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  gt: Optional[BatchedInstances] = None,
                  eval_teacher: bool = False):
        """Student features, with ``eval_teacher`` replaced by the
        teacher's, through the RPN, the box head and NMS: the detections,
        or with MASK_ON (detections, mask probabilities (B, D, 28, 28))."""
        padded_hw = tuple(images.shape[-2:])
        _, feats = self.student(images, image_sizes)
        if eval_teacher:
            if gt is None:
                raise ValueError("eval_teacher needs the GT annotations")
            feats, _, _ = self.teacher(gt, feats, padded_hw)
        dets, mask_probs = self.student.infer_boxes(feats, image_sizes)
        return dets if mask_probs is None else (dets, mask_probs)


class _ShiftBasedDistillator(BaseDistillator):
    """What the anchor-free distillators share (reference
    distillator.py:201-494): the student's head reads
    MODEL.FCOS.IN_FEATURES at the shift points of the canvas, the GT
    targets come from the student's pass and serve the teacher's pass too,
    and the loss normalizer passes through unchanged. Subclasses give the
    assignment (``ground_truth``), the losses and the inference."""

    student_class = FCOSCT

    def __init__(self, cfg, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg, self.student_class(cfg, dtype=dtype), dtype)
        self.num_classes = cfg.MODEL.FCOS.NUM_CLASSES
        self.shifts = ShiftCache(cfg)

    def init_student_(self, generator: torch.Generator):
        init_fcos_(self.student, generator)

    def _head_features(self, feats: Dict[str, torch.Tensor]):
        return [feats[f] for f in self.cfg.MODEL.FCOS.IN_FEATURES]

    def train_forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                      gt: BatchedInstances, distill_flag: float,
                      loss_normalizer: torch.Tensor, uniforms=None):
        """One LGD training forward, as DistillatorRetinaNet's: the student
        head scores the student's and the teacher's pyramids in two
        separate passes, both against the targets of the student's pass.
        ``uniforms`` holds the Swin drop-paths' uniforms, if any."""
        padded_hw = tuple(images.shape[-2:])
        shifts = self.shifts(padded_hw, images.device)
        feats = self._student_features(images, image_sizes, uniforms)
        tea_feats, _, _ = self.teacher(gt, feats, padded_hw)
        pred = self.student.predict(self._head_features(feats))
        pred_tea = self.student.predict(self._head_features(tea_feats))
        targets = self.ground_truth(shifts, gt, pred)
        losses = self.losses(targets, pred)
        losses.update({k + ".tea": v for k, v in
                       self.losses(targets, pred_tea).items()})
        losses["loss_distill"] = self.distill_loss(feats, tea_feats,
                                                   distill_flag)
        return losses, loss_normalizer

    @torch.no_grad()
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  gt: Optional[BatchedInstances] = None,
                  eval_teacher: bool = False) -> BatchedDetections:
        """Student features, with ``eval_teacher`` replaced by the
        teacher's, through the student head and the detector's inference.
        images (B, 3, H, W) float32 BGR on the model's device; image_sizes
        (B, 2) int (h, w)."""
        padded_hw = tuple(images.shape[-2:])
        shifts = self.shifts(padded_hw, images.device)
        _, feats = self.student(images, image_sizes)
        if eval_teacher:
            if gt is None:
                raise ValueError("eval_teacher needs the GT annotations")
            feats, _, _ = self.teacher(gt, feats, padded_hw)
        pred = self.student.predict(self._head_features(feats))
        return self.infer(pred, shifts, image_sizes)


@register_meta_arch("DistillatorFCOS")
class DistillatorFCOS(_ShiftBasedDistillator):
    """reference models/distillator.py:201-297."""

    def ground_truth(self, shifts, gt, pred):
        return fcos_ground_truth(self.cfg, shifts.points, shifts.strides,
                                 shifts.soi_lo, shifts.soi_hi, gt)

    def losses(self, targets, pred):
        return fcos_losses(self.cfg, *targets, *pred)

    def infer(self, pred, shifts, image_sizes):
        return fcos_inference(self.cfg, *pred, shifts.points, shifts.counts,
                              image_sizes)


@register_meta_arch("DistillatorATSS")
class DistillatorATSS(_ShiftBasedDistillator):
    """reference models/distillator.py:397-494."""

    student_class = ATSSCT

    def ground_truth(self, shifts, gt, pred):
        return atss_ground_truth(self.cfg, shifts.points, shifts.counts,
                                 shifts.strides, gt)

    def losses(self, targets, pred):
        return atss_losses(self.cfg, *targets, *pred)

    def infer(self, pred, shifts, image_sizes):
        return atss_inference(self.cfg, *pred, shifts.points, shifts.counts,
                              image_sizes)


@register_meta_arch("DistillatorPOTO")
class DistillatorPOTO(_ShiftBasedDistillator):
    """reference models/distillator.py:299-395: the one-to-one assignment
    uses the student's own (detached) predictions, and its targets serve
    the teacher's pass too, as the reference's gt_targets."""

    student_class = POTOCT

    def ground_truth(self, shifts, gt, pred):
        return poto_ground_truth(self.cfg, shifts.points, shifts.strides, gt,
                                 *pred)

    def losses(self, targets, pred):
        return poto_losses(self.cfg, *targets, *pred)

    def infer(self, pred, shifts, image_sizes):
        return poto_inference(self.cfg, *pred, shifts.points, shifts.counts,
                              image_sizes)
