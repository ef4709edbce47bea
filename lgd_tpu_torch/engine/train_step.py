"""The LGD train step (port of lgd_tpu/engine/train_step.py).

One ``train_step(state, batch)`` runs the student forward, the dynamic
teacher, the distill loss, the backward, both optimizer updates and the
loss normalizer. A student that samples (the R-CNN RPN and ROI heads) gets
its uniforms from the state's ``torch.Generator`` on the model's device,
seeded from SEED (17 while SEED is negative, its default), in the shapes
the model's ``sampling_shapes`` names; the JAX package draws them from a
per-step key of its ``sampling`` stream instead. The phase schedule (reference train.py:184-189, distill
on or off; train.py:205-207, the pre-freeze of the student backbone) is
plain Python on the step counter, where the JAX package traces it.
The parameters live in the model and are updated in place; the state holds
the two optimizers' buffers, the step and the normalizer. The forward and
the two updates run inside ``record_function`` ranges
(``train_step.forward``, ``train_step.optimizer``) that a profiler reads to
split a step's device time; the backward runs on autograd's own threads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from ..solver.optim import build_solver


@dataclasses.dataclass
class TrainState:
    stu_opt: Dict                 # optimizer state of {student, adapter}
    tea_opt: Dict                 # optimizer state of {teacher}
    step: int
    loss_normalizer: torch.Tensor  # RetinaNet EMA normalizer, float32 scalar
    generator: torch.Generator     # the sample's uniforms, on the device


def _frozen(name: str, freeze_at: int) -> bool:
    """detectron2 BACKBONE.FREEZE_AT on a student parameter name: 1 freezes
    the stem, k freezes the stem and res2..res{k}; only the bottom-up. A
    Swin trunk's names (``patch_embed``, ``stage<s>_...``) match neither,
    so every Swin parameter trains, as the JAX package's gates have it."""
    parts = name.split(".")
    if parts[0] != "bottom_up":
        return False
    for n in parts[1:]:
        if n.startswith("stem") and freeze_at >= 1:
            return True
        if (n.startswith("res") and len(n) > 3 and n[3].isdigit()
                and freeze_at >= int(n[3])):
            return True
    return False


def freeze_gates(student: torch.nn.Module, freeze_at: int) -> Dict[str, float]:
    """The permanent 0/1 gate of every student parameter, by name."""
    return {name: 0.0 if _frozen(name, freeze_at) else 1.0
            for name, _ in student.named_parameters()}


def phase(cfg, step: int) -> Tuple[float, float]:
    """(distill_flag, backbone_gate) at ``step``: distillation is on from
    PRE_NONDISTILL_ITERS to MAX_ITER - POST_NONDISTILL_ITERS, and the
    student's bottom-up trains from PRE_FREEZE_STUDENT_BACKBONE_ITERS."""
    dist = cfg.MODEL.DISTILLATOR
    on = (int(dist.PRE_NONDISTILL_ITERS) <= step
          <= int(cfg.SOLVER.MAX_ITER) - int(dist.POST_NONDISTILL_ITERS))
    return float(on), float(step >= int(dist.PRE_FREEZE_STUDENT_BACKBONE_ITERS))


def batch_to_device(batch: Dict, device) -> Dict:
    """A numpy batch of the loaders (NHWC images) -> tensors on ``device``:
    image (B, 3, H, W), image_size (B, 2), gt."""
    images = torch.from_numpy(batch["image"]).to(device, non_blocking=True)
    return {"image": images.permute(0, 3, 1, 2),
            "image_size": torch.from_numpy(batch["image_size"]).to(device),
            "gt": batch["gt"].to(device)}


DEFAULT_SAMPLING_SEED = 17


def draw_uniforms(shapes, generator: torch.Generator, device):
    """Uniforms in [0, 1) for every shape of a (nested) dict of shapes, in
    the dict's order."""
    if isinstance(shapes, dict):
        return {k: draw_uniforms(v, generator, device)
                for k, v in shapes.items()}
    return torch.rand(shapes, generator=generator, device=device)


def make_train_step(cfg, model) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step) for ``model``, a distillator with
    ``student``, ``teacher`` and ``adapter`` submodules."""
    dist = cfg.MODEL.DISTILLATOR
    max_iter = int(cfg.SOLVER.MAX_ITER)
    stu_solver = build_solver(dist.STUDENT.SOLVER, cfg.SOLVER.CLIP_GRADIENTS,
                              max_iter)
    tea_solver = build_solver(dist.TEACHER.SOLVER, cfg.SOLVER.CLIP_GRADIENTS,
                              max_iter)
    params = dict(model.named_parameters())
    stu_names = [k for k in params if k.split(".")[0] in ("student",
                                                          "adapter")]
    tea_names = [k for k in params if k.startswith("teacher.")]
    if len(stu_names) + len(tea_names) != len(params):
        raise ValueError("parameters outside student, adapter and teacher: "
                         f"{sorted(set(params) - set(stu_names + tea_names))}")
    permanent = {f"student.{k}": g for k, g in freeze_gates(
        model.student, int(cfg.MODEL.BACKBONE.FREEZE_AT)).items()}

    def init_state() -> TrainState:
        device = next(model.parameters()).device
        seed = int(cfg.SEED) if int(cfg.SEED) >= 0 else DEFAULT_SAMPLING_SEED
        return TrainState(
            stu_opt=stu_solver.init({k: params[k] for k in stu_names}),
            tea_opt=tea_solver.init({k: params[k] for k in tea_names}),
            step=0,
            loss_normalizer=torch.tensor(100.0, device=device),
            generator=torch.Generator(device).manual_seed(seed))

    def train_step(state: TrainState, batch: Dict):
        """batch: device tensors as ``batch_to_device`` makes them.
        Returns (new state, metrics as device scalars)."""
        step = state.step
        distill_flag, backbone_gate = phase(cfg, step)
        images, gt = batch["image"], batch["gt"]
        uniforms = draw_uniforms(
            model.sampling_shapes(images.shape[0], tuple(images.shape[-2:]),
                                  gt.boxes.shape[1]),
            state.generator, images.device)
        with record_function("train_step.forward"):
            losses, new_norm = model.train_forward(
                images, batch["image_size"], gt, distill_flag,
                state.loss_normalizer, uniforms=uniforms)
            total = sum(losses[k] for k in sorted(losses))
        total.backward()

        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        stu_gates = {
            k: permanent.get(k, 1.0) * (backbone_gate if k.startswith(
                "student.bottom_up.") else 1.0)
            for k in stu_names}
        with torch.no_grad(), record_function("train_step.optimizer"):
            stu_updates, stu_opt = stu_solver.update(
                {k: grads[k] for k in stu_names}, state.stu_opt,
                {k: params[k] for k in stu_names}, step, stu_gates)
            tea_updates, tea_opt = tea_solver.update(
                {k: grads[k] for k in tea_names}, state.tea_opt,
                {k: params[k] for k in tea_names}, step)
            for k, u in (*stu_updates.items(), *tea_updates.items()):
                params[k].add_(u)
        model.zero_grad(set_to_none=True)

        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["stu_lr"] = stu_solver.schedule(step)
        metrics["tea_lr"] = tea_solver.schedule(step)
        metrics["distill_flag"] = distill_flag
        return TrainState(stu_opt=stu_opt, tea_opt=tea_opt, step=step + 1,
                          loss_normalizer=new_norm.detach(),
                          generator=state.generator), metrics

    return init_state, train_step
