"""Training and evaluation loops (port of lgd_tpu/engine/trainer.py, one
process on one device).

``do_train`` is the reference's plain loop (train.py:148-234) around
``train_step``: a finite-loss check every step, metrics logged every 20
iterations, periodic evaluation, and the final weights saved to
OUTPUT_DIR/model_final.pth. ``do_test`` runs batched inference, rescales
the detections to the original image size and scores them with the COCO
evaluator.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import TestLoader, TrainLoader, get_dataset_dicts
from ..evaluation import COCOEvaluator
from .train_step import batch_to_device, make_train_step

logger = logging.getLogger(__name__)


def do_test(cfg, model, device, batch_size: int = 8,
            eval_teacher: bool = False) -> Dict:
    """COCO evaluation of ``model`` (over its ``num_classes`` classes) on
    every dataset in cfg.DATASETS.TEST. Returns {"bbox": {"AP": ...}} for
    one dataset, else {name: ...}."""
    device = torch.device(device)
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        dicts = get_dataset_dicts(dataset_name)
        loader = TestLoader(cfg, dicts, batch_size=batch_size)
        evaluator = COCOEvaluator(gt_dataset=dicts,
                                  num_classes=model.num_classes)

        num_warmup = min(5, max(len(loader) // batch_size - 1, 0))
        compute_time, n_timed = 0.0, 0
        for idx, batch in enumerate(loader):
            if idx == num_warmup:
                compute_time, n_timed = 0.0, 0
            t0 = time.perf_counter()
            images = torch.from_numpy(batch["image"]).to(device)
            sizes = torch.from_numpy(batch["image_size"]).to(device)
            dets = model.inference(images.permute(0, 3, 1, 2), sizes,
                                   batch["gt"].to(device), eval_teacher)
            # the copy to the host waits for the device
            boxes_b, scores_b, classes_b, valid_b = (
                t.cpu().numpy() for t in (dets.boxes, dets.scores,
                                          dets.classes, dets.valid))
            compute_time += time.perf_counter() - t0

            for i, meta in enumerate(batch["_meta"]):
                if meta is None:  # padded slot in a partial batch
                    continue
                n_timed += 1
                ih, iw = meta["input_hw"]
                sx, sy = meta["width"] / iw, meta["height"] / ih
                valid = valid_b[i]
                boxes = boxes_b[i][valid] * np.asarray([sx, sy, sx, sy])
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, meta["width"])
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, meta["height"])
                evaluator.process(meta["image_id"], boxes,
                                  scores_b[i][valid], classes_b[i][valid])
        logger.info("Total inference pure compute time: %.6f s / img "
                    "(%d imgs, batch=%d, device=%s)",
                    compute_time / max(n_timed, 1), len(loader), batch_size,
                    device)
        dump = (f"{cfg.OUTPUT_DIR}/inference/{dataset_name}"
                if cfg.OUTPUT_DIR else None)
        results[dataset_name] = evaluator.evaluate(("bbox",), output_dir=dump)
        logger.info("Results[%s]: %s", dataset_name, results[dataset_name])
    if len(results) == 1:
        return next(iter(results.values()))
    return results


def _check_finite(iteration: int, total: torch.Tensor):
    t = float(total)
    if not math.isfinite(t):
        raise FloatingPointError(
            f"Loss diverged at iteration {iteration}: total={t}")


def do_train(cfg, model, device, loader: Optional[TrainLoader] = None):
    """SOLVER.MAX_ITER steps of ``train_step`` from step 0 on ``device``.
    Returns the final TrainState; the model holds the trained weights.
    Resume and optimizer checkpoints are not ported yet."""
    device = torch.device(device)
    loader = TrainLoader(cfg) if loader is None else loader
    init_state, train_step = make_train_step(cfg, model)
    state = init_state()
    max_iter = int(cfg.SOLVER.MAX_ITER)
    logger.info("Starting training from iteration 0 on %s", device)

    it = iter(loader)
    prev = None  # (iteration, total loss) of the previous step
    t0 = time.perf_counter()
    for iteration in range(max_iter):
        state, metrics = train_step(state, batch_to_device(next(it), device))
        # checking the previous step's total, ready by now, keeps the
        # device fed and still stops before a second update compounds a NaN
        if prev is not None:
            _check_finite(*prev)
        prev = (iteration, metrics["total_loss"])
        if (iteration + 1) % 20 == 0 or iteration == max_iter - 1:
            host = {k: float(v) for k, v in metrics.items()}
            logger.info("iter: %d  %s  time: %.4f s/iter", iteration + 1,
                        "  ".join(f"{k}: {v:.4g}" for k, v in
                                  sorted(host.items())),
                        (time.perf_counter() - t0) / (iteration + 1))
        if (cfg.TEST.EVAL_PERIOD > 0
                and (iteration + 1) % cfg.TEST.EVAL_PERIOD == 0
                and iteration != max_iter - 1):
            do_test(cfg, model, device)
            if cfg.MODEL.DISTILLATOR.EVAL_TEACHER:
                do_test(cfg, model, device, eval_teacher=True)
    if prev is not None:
        _check_finite(*prev)
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        path = os.path.join(cfg.OUTPUT_DIR, "model_final.pth")
        torch.save(model.state_dict(), path)
        logger.info("Saved %s", path)
    return state
