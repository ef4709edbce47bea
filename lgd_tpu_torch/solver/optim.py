"""LR schedules and gated optimizers (port of lgd_tpu/solver/optim.py).

detectron2 WarmupMultiStepLR / WarmupCosineLR, and the reference's dual
optimizers: one SGD or AdamW for {student, adapter}, one for {teacher},
each with its own schedule and optional per-parameter gradient clipping
(SOLVER.CLIP_GRADIENTS).

A per-parameter gate in {0, 1} multiplies the combined (gradient + weight
decay) input, so a gated-off parameter gets an update of exactly zero and
its momentum stays as it was: the reference's pre-freeze of the student
backbone (train.py:205-207) and detectron2's FREEZE_AT. ``torch.optim``
has no such gate (its weight decay would still move a frozen parameter),
so the update is written out, in the JAX package's order of operations.
Parameters, gradients, gates and state are dicts keyed by parameter name.
The schedules are computed in float32 on the host, as the JAX package
computes them in float32 on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

_f32 = np.float32


def _warmup_factor(method: str, step: int, warmup_iters: float,
                   warmup_factor: float) -> np.float32:
    if warmup_iters <= 0 or step >= warmup_iters:
        return _f32(1.0)
    alpha = min(max(_f32(step) / _f32(warmup_iters), _f32(0.0)), _f32(1.0))
    if method == "linear":
        return _f32(warmup_factor) * (_f32(1.0) - alpha) + alpha
    if method == "constant":
        return _f32(warmup_factor)
    raise ValueError(method)


def warmup_multistep_lr(base_lr, steps, gamma, warmup_factor, warmup_iters,
                        warmup_method="linear") -> Callable[[int], float]:
    steps = tuple(int(s) for s in steps)

    def schedule(step: int) -> float:
        k = sum(1 for s in steps if step >= s)
        f = _warmup_factor(warmup_method, step, float(warmup_iters),
                           float(warmup_factor))
        return float(_f32(base_lr) * f * _f32(gamma) ** k)

    return schedule


def warmup_cosine_lr(base_lr, max_iter, warmup_factor, warmup_iters,
                     warmup_method="linear") -> Callable[[int], float]:
    def schedule(step: int) -> float:
        f = _warmup_factor(warmup_method, step, float(warmup_iters),
                           float(warmup_factor))
        cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * _f32(step)
                                              / _f32(max_iter)))
        return float(_f32(base_lr) * f * cos)

    return schedule


def build_lr_schedule(solver_cfg, max_iter: int) -> Callable[[int], float]:
    name = solver_cfg.LR_SCHEDULER_NAME
    if name == "WarmupMultiStepLR":
        return warmup_multistep_lr(
            solver_cfg.BASE_LR, solver_cfg.STEPS, solver_cfg.GAMMA,
            solver_cfg.WARMUP_FACTOR, solver_cfg.WARMUP_ITERS,
            solver_cfg.WARMUP_METHOD)
    if name == "WarmupCosineLR":
        return warmup_cosine_lr(
            solver_cfg.BASE_LR, max_iter, solver_cfg.WARMUP_FACTOR,
            solver_cfg.WARMUP_ITERS, solver_cfg.WARMUP_METHOD)
    raise ValueError(f"Unknown LR scheduler: {name}")


Tensors = Dict[str, torch.Tensor]


class GatedOptimizer:
    """SGD (momentum) or AdamW with per-parameter update gates.

    ``update(grads, state, params, step, gates)`` -> (updates, new state);
    the caller adds the updates to the parameters. ``gates`` maps names to
    0.0 or 1.0 (all 1.0 when None)."""

    def __init__(self, kind: str, schedule: Callable[[int], float], *,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8, clip_type: str = "",
                 clip_value: float = 1.0):
        self.kind = kind.upper()
        if self.kind not in ("SGD", "ADAMW"):
            raise NotImplementedError(self.kind)
        if clip_type not in ("", "value", "norm"):
            raise ValueError(f"Unknown CLIP_TYPE {clip_type!r}")
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.betas = betas
        self.eps = eps
        self.clip_type = clip_type
        self.clip_value = clip_value

    def init(self, params: Tensors) -> Dict:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        if self.kind == "SGD":
            return {"momentum": zeros, "count": 0}
        return {"mu": zeros,
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        c = self.clip_value
        if self.clip_type == "value":
            return g.clamp(-c, c)
        if self.clip_type == "norm":
            # detectron2 clips each parameter's gradient norm on its own
            n = torch.sqrt((g.float() ** 2).sum())
            return g * torch.clamp(c / n.clamp(min=1e-12), max=1.0)
        return g

    def update(self, grads: Tensors, state: Dict, params: Tensors, step: int,
               gates: Optional[Dict[str, float]] = None):
        lr = self.schedule(step)
        updates = {}
        if self.kind == "SGD":
            wd, momentum = self.weight_decay, {}
            for k, p in params.items():
                gate = 1.0 if gates is None else gates[k]
                eff = (self._clip(grads[k]) + wd * p) * gate
                momentum[k] = self.momentum * state["momentum"][k] + eff
                updates[k] = -lr * momentum[k]
            return updates, {"momentum": momentum,
                             "count": state["count"] + 1}

        # AdamW: decoupled weight decay, torch semantics
        b1, b2 = self.betas
        count = state["count"] + 1
        c1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
        c2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
        mu, nu = {}, {}
        for k, p in params.items():
            gate = 1.0 if gates is None else gates[k]
            g = self._clip(grads[k]) * gate
            mu[k] = b1 * state["mu"][k] + (1 - b1) * g
            nu[k] = b2 * state["nu"][k] + (1 - b2) * (g * g)
            direction = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            updates[k] = -lr * (direction + self.weight_decay * p) * gate
        return updates, {"mu": mu, "nu": nu, "count": count}


def build_solver(solver_cfg, clip_cfg, max_iter: int) -> GatedOptimizer:
    """One of the two distillator solvers, from a
    MODEL.DISTILLATOR.{STUDENT,TEACHER}.SOLVER node and
    SOLVER.CLIP_GRADIENTS."""
    return GatedOptimizer(
        solver_cfg.OPTIMIZER,
        build_lr_schedule(solver_cfg, max_iter),
        momentum=solver_cfg.MOMENTUM,
        weight_decay=float(solver_cfg.WEIGHT_DECAY),
        clip_type=clip_cfg.CLIP_TYPE if clip_cfg.ENABLED else "",
        clip_value=clip_cfg.CLIP_VALUE,
    )
