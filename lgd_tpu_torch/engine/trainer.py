"""Evaluation loop (port of lgd_tpu/engine/trainer.py:99-186, one process).

Batched inference on an explicit device, detections rescaled to the
original image size, and COCO scoring with the JAX package's evaluator
(lgd_tpu/evaluation/coco_eval.py imports no jax; it is given the GT dicts
directly, so the dataset catalog, which does, is never touched).
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from lgd_tpu.evaluation.coco_eval import COCOEvaluator

from ..data import TestLoader, get_dataset_dicts

logger = logging.getLogger(__name__)


def do_test(cfg, model, device, batch_size: int = 8,
            eval_teacher: bool = False) -> Dict:
    """COCO evaluation of ``model`` on every dataset in cfg.DATASETS.TEST.
    Returns {"bbox": {"AP": ...}} for one dataset, else {name: ...}."""
    device = torch.device(device)
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        dicts = get_dataset_dicts(dataset_name)
        loader = TestLoader(cfg, dicts, batch_size=batch_size)
        evaluator = COCOEvaluator(gt_dataset=dicts,
                                  num_classes=cfg.MODEL.RETINANET.NUM_CLASSES)

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
