"""Training and evaluation loops (port of lgd_tpu/engine/trainer.py, one
process on one device).

``do_train`` is the reference's plain loop (train.py:148-234) around
``train_step``: the cold start from a backbone file (MODEL.WEIGHTS), the
resume from OUTPUT_DIR's latest checkpoint, a finite-loss check every
step, periodic evaluation, a checkpoint every SOLVER.CHECKPOINT_PERIOD
iterations and at the last, the metrics to the log, ``metrics.json`` and
TensorBoard every 20 iterations, at the last and at each checkpoint (the
JAX package writes them at a checkpoint only when it falls on one of the
others), and the final weights in OUTPUT_DIR/model_final.pth. Nothing is
written without OUTPUT_DIR.
``do_test`` runs batched inference, rescales the detections to the
original image size and scores them with the dataset's evaluator
(``get_evaluator``, by its ``evaluator_type``): boxes, and with MASK_ON
each detection's mask grid too (bbox and segm).
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
from ..evaluation import get_evaluator
from ..utils.weight_convert import is_backbone_file, maybe_load_pretrained
from .checkpoint import Checkpointer, PeriodicCheckpointer
from .events import (
    CommonMetricPrinter,
    EventStorage,
    JSONWriter,
    TensorboardWriter,
)
from .train_step import TrainState, batch_to_device, make_train_step

logger = logging.getLogger(__name__)


def do_test(cfg, model, device, batch_size: int = 8,
            eval_teacher: bool = False) -> Dict:
    """Evaluation of ``model`` on every dataset in cfg.DATASETS.TEST, each
    by the evaluator its metadata names (over cfg.NUM_CLASSES classes for
    COCO). Returns {"bbox": {"AP": ...}} (and "segm" with MASK_ON) for one
    dataset, else {name: ...}."""
    device = torch.device(device)
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        loader = TestLoader(cfg, get_dataset_dicts(dataset_name),
                            batch_size=batch_size)
        evaluator = get_evaluator(cfg, dataset_name)
        evaluator.reset()

        num_warmup = min(5, max(len(loader) // batch_size - 1, 0))
        compute_time, n_timed = 0.0, 0
        for idx, batch in enumerate(loader):
            if idx == num_warmup:
                compute_time, n_timed = 0.0, 0
            t0 = time.perf_counter()
            images = torch.from_numpy(batch["image"]).to(device)
            sizes = torch.from_numpy(batch["image_size"]).to(device)
            out = model.inference(images.permute(0, 3, 1, 2), sizes,
                                  batch["gt"].to(device), eval_teacher)
            dets, masks = out if isinstance(out, tuple) else (out, None)
            # the copy to the host waits for the device
            boxes_b, scores_b, classes_b, valid_b = (
                t.cpu().numpy() for t in (dets.boxes, dets.scores,
                                          dets.classes, dets.valid))
            masks_b = None if masks is None else masks.cpu().numpy()
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
                extra = ({} if masks_b is None
                         else {"masks": masks_b[i][valid]})
                evaluator.process(meta["image_id"], boxes,
                                  scores_b[i][valid], classes_b[i][valid],
                                  **extra)
        logger.info("Total inference pure compute time: %.6f s / img "
                    "(%d imgs, batch=%d, device=%s)",
                    compute_time / max(n_timed, 1), len(loader), batch_size,
                    device)
        dump = (f"{cfg.OUTPUT_DIR}/inference/{dataset_name}"
                if cfg.OUTPUT_DIR else None)
        iou_types = ("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",)
        results[dataset_name] = evaluator.evaluate(iou_types, output_dir=dump)
        logger.info("Results[%s]: %s", dataset_name, results[dataset_name])
    if len(results) == 1:
        return next(iter(results.values()))
    return results


def _check_finite(iteration: int, total):
    t = float(total)
    if not math.isfinite(t):
        raise FloatingPointError(
            f"Loss diverged at iteration {iteration}: total={t}")


def do_train(cfg, model, device, resume: bool = False,
             loader: Optional[TrainLoader] = None) -> TrainState:
    """Steps ``start_iter`` .. SOLVER.MAX_ITER - 1 of ``train_step`` on
    ``device``: from 0, or with ``resume`` from the iteration after
    OUTPUT_DIR's latest checkpoint, whose weights, optimizer states, step,
    normalizer and sampling generator it restores. The data stream starts
    afresh either way, as in the JAX package. Returns the final TrainState;
    the model holds the trained weights."""
    device = torch.device(device)
    init_state, train_step = make_train_step(cfg, model)
    state = init_state()
    if is_backbone_file(cfg.MODEL.WEIGHTS):
        maybe_load_pretrained(cfg, model)
    max_iter = int(cfg.SOLVER.MAX_ITER)
    start_iter, periodic = 0, None
    writers = [CommonMetricPrinter(max_iter)]
    if cfg.OUTPUT_DIR:
        ckpt = Checkpointer(cfg.OUTPUT_DIR)
        state, start_iter = ckpt.resume_or_load(model, state, resume=resume)
        periodic = PeriodicCheckpointer(ckpt, cfg.SOLVER.CHECKPOINT_PERIOD,
                                        max_iter)
        writers += [JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json")),
                    TensorboardWriter(cfg.OUTPUT_DIR)]
    storage = EventStorage(start_iter)
    loader = TrainLoader(cfg) if loader is None else loader
    logger.info("Starting training from iteration %d on %s", start_iter,
                device)

    it = iter(loader)
    batch = next(it) if start_iter < max_iter else None
    prev = None  # (iteration, total loss) of the previous step
    try:
        for iteration in range(start_iter, max_iter):
            storage.iter = iteration
            state, metrics = train_step(state, batch_to_device(batch, device))
            # checking the previous step's total, ready by now, keeps the
            # device fed and still stops before a second update compounds a
            # NaN
            if prev is not None:
                _check_finite(*prev)
            prev = (iteration, metrics["total_loss"])
            # the metrics of a checkpoint's iteration are written too, so
            # that metrics.json reaches every iteration a resume starts after
            if ((iteration + 1) % 20 == 0 or iteration == max_iter - 1
                    or (periodic is not None and periodic.due(iteration))):
                host = {k: float(v) for k, v in metrics.items()}
                _check_finite(iteration, host["total_loss"])
                storage.put_scalars(**host)
                for w in writers:
                    w.write(storage)
            if (cfg.TEST.EVAL_PERIOD > 0
                    and (iteration + 1) % cfg.TEST.EVAL_PERIOD == 0
                    and iteration != max_iter - 1):
                do_test(cfg, model, device)
                if cfg.MODEL.DISTILLATOR.EVAL_TEACHER:
                    do_test(cfg, model, device, eval_teacher=True)
            if iteration == max_iter - 1:
                # the lagged check never covers the last step: check it
                # before the final save can keep a NaN state
                _check_finite(iteration, metrics["total_loss"])
            if periodic is not None:
                periodic.step(iteration, model, state)
            if iteration < max_iter - 1:
                batch = next(it)
    finally:
        for w in writers:
            w.close()
    if cfg.OUTPUT_DIR:
        path = os.path.join(cfg.OUTPUT_DIR, "model_final.pth")
        torch.save(model.state_dict(), path)
        logger.info("Saved %s", path)
    return state
