"""Padded eval batches on the host (the single-process eval half of
lgd_tpu/data/loader.py).

Every batch is padded onto one of two fixed canvases, landscape
(short, long) or portrait (long, short), with short = MIN_SIZE_TEST and
long = MAX_SIZE_TEST rounded up to TPU.PAD_SIZE_DIVISIBILITY (800x1344 and
1344x800 at the reference test size). Batches stay numpy here; the engine
moves them to the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..structures import BatchedInstances
from .dataset_mapper import DatasetMapper


def _ceil_to(x, d):
    return int(-(-x // d) * d)


def eval_canvas_shapes(cfg):
    """(landscape, portrait) eval canvases (lgd_tpu/data/loader.py:47-57)."""
    d = cfg.TPU.PAD_SIZE_DIVISIBILITY
    if cfg.TPU.EVAL_CANVAS:
        h, w = (int(x) for x in cfg.TPU.EVAL_CANVAS)
        return (h, w), (w, h)
    short = _ceil_to(cfg.INPUT.MIN_SIZE_TEST, d)
    long_ = _ceil_to(cfg.INPUT.MAX_SIZE_TEST, d)
    return (short, long_), (long_, short)


def pack_batch(samples: List[Dict], canvas_hw, max_instances: int) -> Dict:
    """Mapper outputs -> one padded batch: image (B, H, W, 3) float32 BGR
    (NHWC, as the JAX package packs it), image_size (B, 2) int32 (h, w),
    gt BatchedInstances, and host-only ``_meta``."""
    B = len(samples)
    H, W = canvas_hw
    images = np.zeros((B, H, W, 3), np.float32)
    sizes = np.zeros((B, 2), np.int32)
    meta = []
    for i, s in enumerate(samples):
        img = s["image"][:H, :W]  # canvas guard (buckets make it a no-op)
        h, w = img.shape[:2]
        images[i, :h, :w] = img
        sizes[i] = (h, w)
        meta.append({
            "image_id": s.get("image_id", -1),
            "height": s.get("height", h),
            "width": s.get("width", w),
            "input_hw": (h, w),
        })
    gt = BatchedInstances.from_lists([s["boxes"] for s in samples],
                                     [s["classes"] for s in samples],
                                     capacity=max_instances)
    return {"image": images, "image_size": sizes, "gt": gt, "_meta": meta}


class TestLoader:
    """Padded eval batches of ``batch_size`` images, grouped by canvas
    bucket in dataset order (lgd_tpu/data/loader.py:285-385 with one
    process). The last batch of a bucket is filled with dummy slots whose
    ``_meta`` entry is None; consumers skip those."""

    def __init__(self, cfg, dataset_dicts: List[Dict], batch_size: int = 1):
        self.dataset_dicts = dataset_dicts
        self.mapper = DatasetMapper(cfg)
        self.batch_size = batch_size
        self.canvases = eval_canvas_shapes(cfg)
        self.max_instances = cfg.TPU.MAX_INSTANCES
        self._sched = self._schedule()

    def _schedule(self):
        """(bucket, [indices]) groups, from width/height metadata only."""
        buckets = {0: [], 1: []}
        sched = []
        for i, d in enumerate(self.dataset_dicts):
            b = 0 if d.get("width", 1) >= d.get("height", 0) else 1
            buckets[b].append(i)
            if len(buckets[b]) == self.batch_size:
                sched.append((b, buckets[b]))
                buckets[b] = []
        sched.extend((b, idxs) for b, idxs in buckets.items() if idxs)
        return sched

    def __len__(self):
        return len(self.dataset_dicts)

    @staticmethod
    def _dummy_sample():
        return {"image": np.zeros((8, 8, 3), np.float32),
                "boxes": np.zeros((0, 4), np.float32),
                "classes": np.zeros((0,), np.int64)}

    def __iter__(self):
        rng = np.random.RandomState(0)
        for b, idxs in self._sched:
            samples = [self.mapper(self.dataset_dicts[i], rng) for i in idxs]
            n_real = len(samples)
            samples += [self._dummy_sample()
                        for _ in range(self.batch_size - n_real)]
            batch = pack_batch(samples, self.canvases[b], self.max_instances)
            for i in range(n_real, self.batch_size):
                batch["_meta"][i] = None  # padding slot
            yield batch
