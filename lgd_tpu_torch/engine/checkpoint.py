"""Checkpoints and resume (port of lgd_tpu/engine/checkpoint.py, with
``torch.save`` where the JAX package uses Orbax).

detectron2's DetectionCheckpointer and PeriodicCheckpointer with the
reference's extra checkpointables (both optimizers and the iteration
counter; train.py:155-167,234). One file per saved iteration,
``OUTPUT_DIR/checkpoints/model_<iteration>.pth``, holds:

- ``model``: the model's state_dict (student, teacher and adapter
  parameters, the FrozenBN buffers);
- ``stu_opt`` and ``tea_opt``: both optimizers' state;
- ``step`` and ``loss_normalizer``;
- ``generator``: the state of the ``torch.Generator`` that draws the
  samples' uniforms. The JAX package derives each step's key from the step;
  the port's generator carries state from step to step, so it is saved;
- ``iteration``: the loop iteration that wrote it.

A save writes a temporary file beside the target and renames it over the
target (``os.replace``), so a process killed during a save leaves the
previous checkpoints as they were; only files named ``model_<digits>.pth``
count. The newest ``max_to_keep`` files stay. Cold-start imports of
detectron2 backbone pickles are ``utils/weight_convert.py``'s.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from .train_step import TrainState

logger = logging.getLogger(__name__)

_NAME = re.compile(r"^model_(\d+)\.pth$")


def _to(tree, device):
    """A nest of dicts with tensor leaves, the tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Checkpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 10):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"model_{step:07d}.pth")

    def steps(self) -> List[int]:
        """The saved iterations, oldest first."""
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, state: TrainState):
        os.makedirs(self.dir, exist_ok=True)
        payload = {"model": model.state_dict(), "stu_opt": state.stu_opt,
                   "tea_opt": state.tea_opt, "step": int(state.step),
                   "loss_normalizer": state.loss_normalizer,
                   "generator": state.generator.get_state(),
                   "iteration": int(step)}
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        logger.info("Saved checkpoint at iteration %d -> %s", step, path)

    def load(self, step: int) -> Dict:
        """The payload of iteration ``step``, its tensors on the CPU."""
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, step: int, model: torch.nn.Module,
                state: Optional[TrainState] = None) -> Optional[TrainState]:
        """Iteration ``step``'s weights into ``model`` (in place, strict)
        and, given a template ``state``, the TrainState it saved."""
        payload = self.load(step)
        model.load_state_dict(payload["model"], strict=True)
        if state is None:
            return None
        device = state.loss_normalizer.device
        state.generator.set_state(payload["generator"])
        return TrainState(
            stu_opt=_to(payload["stu_opt"], device),
            tea_opt=_to(payload["tea_opt"], device),
            step=payload["step"],
            loss_normalizer=payload["loss_normalizer"].to(device),
            generator=state.generator)

    def resume_or_load(self, model: torch.nn.Module, state: TrainState,
                       resume: bool = True):
        """With ``resume`` and a saved checkpoint, restore the latest.
        Returns (state, start_iter): the iteration after the saved one, or
        0 with the state unchanged."""
        step = self.latest_step()
        if not resume or step is None:
            return state, 0
        state = self.restore(step, model, state)
        logger.info("Resumed from checkpoint at iteration %d", step)
        return state, step + 1


class PeriodicCheckpointer:
    """Save every ``period`` iterations and at the last (reference
    train.py:165-167)."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_iter: int):
        self.ckpt = checkpointer
        self.period = period
        self.max_iter = max_iter

    def due(self, iteration: int) -> bool:
        return ((iteration + 1) % self.period == 0
                or iteration == self.max_iter - 1)

    def step(self, iteration: int, model: torch.nn.Module,
             state: TrainState):
        if self.due(iteration):
            self.ckpt.save(iteration, model, state)


def load_weights(path: str, model: torch.nn.Module,
                 state: Optional[TrainState] = None) -> Optional[TrainState]:
    """MODEL.WEIGHTS as ``--eval-only`` resolves it (the reference
    evaluates the weights file directly, train.py:267-270):

    - a run's OUTPUT_DIR, or its ``checkpoints/``: the latest checkpoint
      (and, given ``state``, its TrainState);
    - a ``.npz`` variables dump of the JAX package: through
      utils/param_bridge.py, every key covering the model;
    - any other file: a torch state_dict of the whole model, loaded
      strictly.

    Returns the state (restored, or as given)."""
    if os.path.isdir(path):
        root = os.path.normpath(path)
        if os.path.basename(root) == "checkpoints":
            root = os.path.dirname(root)
        ckpt = Checkpointer(root)
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"MODEL.WEIGHTS={path}: no checkpoint "
                                    "found")
        restored = ckpt.restore(step, model, state)
        logger.info("Loaded the checkpoint of iteration %d from %s", step,
                    path)
        return state if restored is None else restored
    if path.endswith(".npz"):
        from ..utils.param_bridge import load_flax_weights

        with np.load(path) as raw:
            flat = {k: raw[k] for k in raw.files}
        load_flax_weights(model, flat)
        logger.info("Loaded %d tensors from %s", len(flat), path)
        return state
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    logger.info("Loaded %d tensors from %s", len(sd), path)
    return state
