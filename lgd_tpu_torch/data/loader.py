"""Padded batches on the host (port of lgd_tpu/data/loader.py, one
process).

Every batch is padded onto one of two fixed canvases, landscape
(short, long) or portrait (long, short). For evaluation short =
MIN_SIZE_TEST and long = MAX_SIZE_TEST, for training short =
max(MIN_SIZE_TRAIN) and long = MAX_SIZE_TRAIN, each rounded up to
TPU.PAD_SIZE_DIVISIBILITY (800x1344 and 1344x800 at the reference sizes).
Batches stay numpy here; the engine moves them to the device.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import Counter
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..structures import BatchedInstances
from .coco import get_detection_dataset_dicts
from .dataset_mapper import DatasetMapper, rasterize_polygons

logger = logging.getLogger(__name__)


def _ceil_to(x, d):
    return int(-(-x // d) * d)


def train_canvas_shapes(cfg):
    """(landscape, portrait) training canvases
    (lgd_tpu/data/loader.py:37-44)."""
    d = cfg.TPU.PAD_SIZE_DIVISIBILITY
    if cfg.TPU.TRAIN_CANVAS:
        h, w = (int(x) for x in cfg.TPU.TRAIN_CANVAS)
        return (h, w), (w, h)
    short = _ceil_to(max(cfg.INPUT.MIN_SIZE_TRAIN), d)
    long_ = _ceil_to(cfg.INPUT.MAX_SIZE_TRAIN, d)
    return (short, long_), (long_, short)


def eval_canvas_shapes(cfg):
    """(landscape, portrait) eval canvases (lgd_tpu/data/loader.py:47-57)."""
    d = cfg.TPU.PAD_SIZE_DIVISIBILITY
    if cfg.TPU.EVAL_CANVAS:
        h, w = (int(x) for x in cfg.TPU.EVAL_CANVAS)
        return (h, w), (w, h)
    short = _ceil_to(cfg.INPUT.MIN_SIZE_TEST, d)
    long_ = _ceil_to(cfg.INPUT.MAX_SIZE_TEST, d)
    return (short, long_), (long_, short)


def segmask_bitmasks(polygons, n: int, hw, canvas_hw,
                     stride: int) -> np.ndarray:
    """(n, H // stride, W // stride) uint8 bitmasks of the first n
    instances on the padded canvas: each polygon rasterized at the image's
    full (h, w), then sampled nearest at every stride-th pixel; cells past
    the image are 0 (lgd_tpu/data/loader.py:160-171)."""
    h, w = hw
    hs, ws = canvas_hw[0] // stride, canvas_hw[1] // stride
    ys = np.minimum(np.arange(hs) * stride, h - 1)
    xs = np.minimum(np.arange(ws) * stride, w - 1)
    bm = np.zeros((n, hs, ws), np.uint8)
    for j, p in enumerate(polygons[:n]):
        sub = rasterize_polygons(p, h, w)[ys][:, xs]
        sub[ys >= h] = 0
        bm[j] = sub
    return bm


def pack_batch(samples: List[Dict], canvas_hw, max_instances: int,
               segmask_stride: Optional[int] = None) -> Dict:
    """Mapper outputs -> one padded batch: image (B, H, W, 3) float32 BGR
    (NHWC, as the JAX package packs it), image_size (B, 2) int32 (h, w),
    gt BatchedInstances, and host-only ``_meta``. The GT carries the
    samples' ``masks49`` and ``mask_crops`` where they have them, and with
    ``segmask_stride`` the bitmasks of their polygons at that stride."""
    B = len(samples)
    H, W = canvas_hw
    images = np.zeros((B, H, W, 3), np.float32)
    sizes = np.zeros((B, 2), np.int32)
    bitmasks = []
    meta = []
    for i, s in enumerate(samples):
        img = s["image"][:H, :W]  # canvas guard (buckets make it a no-op)
        h, w = img.shape[:2]
        images[i, :h, :w] = img
        sizes[i] = (h, w)
        if segmask_stride is not None:
            bitmasks.append(segmask_bitmasks(
                s.get("polygons") or [], len(s["boxes"]), (h, w), canvas_hw,
                segmask_stride))
        meta.append({
            "image_id": s.get("image_id", -1),
            "height": s.get("height", h),
            "width": s.get("width", w),
            "input_hw": (h, w),
        })
    optional = lambda key: ([s.get(key) for s in samples]
                            if any(key in s for s in samples) else None)
    gt = BatchedInstances.from_lists(
        [s["boxes"] for s in samples], [s["classes"] for s in samples],
        capacity=max_instances, masks49_list=optional("masks49"),
        bitmasks_list=bitmasks if segmask_stride is not None else None,
        mask_crops_list=optional("mask_crops"))
    return {"image": images, "image_size": sizes, "gt": gt, "_meta": meta}


def labelmap_stride(cfg) -> Optional[int]:
    """TPU.SEGMASK_STRIDE when the seg-mask teacher needs bitmasks
    (LOAD_LABELMAP), else None."""
    return (cfg.TPU.SEGMASK_STRIDE
            if cfg.MODEL.DISTILLATOR.LABEL_ENCODER.LOAD_LABELMAP else None)


class TestLoader:
    """Padded eval batches of ``batch_size`` images, grouped by canvas
    bucket in dataset order (lgd_tpu/data/loader.py:285-385 with one
    process). The last batch of a bucket is filled with dummy slots whose
    ``_meta`` entry is None; consumers skip those."""

    def __init__(self, cfg, dataset_dicts: List[Dict], batch_size: int = 1):
        self.dataset_dicts = dataset_dicts
        self.mapper = DatasetMapper(cfg, is_train=False)
        self.batch_size = batch_size
        self.canvases = eval_canvas_shapes(cfg)
        self.max_instances = cfg.TPU.MAX_INSTANCES
        self.segmask_stride = labelmap_stride(cfg)
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
        """An image that cannot be read is skipped with a warning: its slot
        is padding, and the schedule stays as it was."""
        rng = np.random.RandomState(0)
        for b, idxs in self._sched:
            samples, unread = [], []
            for i in idxs:
                try:
                    s = self.mapper(self.dataset_dicts[i], rng)
                except OSError as e:
                    logger.warning("skipping unreadable eval image %s: %s",
                                   self.dataset_dicts[i].get("file_name"), e)
                    unread.append(len(samples))
                    s = self._dummy_sample()
                samples.append(s)
            n_real = len(samples)
            samples += [self._dummy_sample()
                        for _ in range(self.batch_size - n_real)]
            batch = pack_batch(samples, self.canvases[b], self.max_instances,
                               self.segmask_stride)
            for i in [*unread, *range(n_real, self.batch_size)]:
                batch["_meta"][i] = None  # padding slot
            yield batch


class TrainingSampler:
    """Infinite shuffled index stream from a fixed seed (reference
    TrainingSampler, one process)."""

    def __init__(self, size: int, seed: int = 2022, shuffle: bool = True):
        self.size = size
        self.seed = seed
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            order = (g.permutation(self.size) if self.shuffle
                     else np.arange(self.size))
            yield from order.tolist()


class RepeatFactorTrainingSampler(TrainingSampler):
    """detectron2's RepeatFactorTrainingSampler (DATALOADER.SAMPLER_TRAIN;
    lgd_tpu/data/loader.py:79-114): each image is repeated
    max over its categories c of max(1, sqrt(t / f(c))) times, f(c) the
    share of images with c, the fraction rounded stochastically in every
    epoch."""

    def __init__(self, dataset_dicts, repeat_thresh: float, seed: int = 2022,
                 shuffle: bool = True):
        super().__init__(len(dataset_dicts), seed, shuffle)
        freq = Counter()
        n = len(dataset_dicts)
        cats_per_img = []
        for d in dataset_dicts:
            cats = {a["category_id"] for a in d.get("annotations", [])
                    if a.get("iscrowd", 0) == 0}
            cats_per_img.append(cats)
            freq.update(cats)
        cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / (v / n)))
                   for c, v in freq.items()}
        self._rep = np.asarray([max([cat_rep[c] for c in cats], default=1.0)
                                for cats in cats_per_img])

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            rands = g.rand(self.size)
            rep = np.floor(self._rep) + (rands < (self._rep % 1.0))
            indices = np.repeat(np.arange(self.size), rep.astype(np.int64))
            if self.shuffle:
                indices = indices[g.permutation(len(indices))]
            yield from indices.tolist()


def log_class_histogram(dataset_dicts, class_names=None):
    """The training set's instances per class, the 20 most frequent
    (reference utils/build.py:167-209)."""
    counts = Counter()
    for d in dataset_dicts:
        counts.update(a["category_id"] for a in d.get("annotations", [])
                      if a.get("iscrowd", 0) == 0)
    rows = "  ".join(
        f"{(class_names[c] if class_names and c < len(class_names) else c)}"
        f":{n}" for c, n in counts.most_common(20))
    logger.info("Instance distribution (%d total, top 20): %s",
                sum(counts.values()), rows)


def train_dataset_dicts(cfg) -> List[Dict]:
    """DATASETS.TRAIN concatenated; with FILTER_EMPTY_ANNOTATIONS, images
    without a non-crowd annotation are dropped (reference
    utils/build.py:48-76)."""
    return get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN,
        filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)


class TrainLoader:
    """Infinite iterator of padded training batches of SOLVER.IMS_PER_BATCH
    images, grouped by aspect into the landscape and portrait canvases
    (the reference's AspectRatioGroupedDataset), mapped ahead of the
    consumer in a thread (TPU.PREFETCH batches). The sampler's seed and the
    augmentation stream are the JAX package's, so both draw the same
    batches: SEED, or 2022 when SEED <= 0. DATALOADER.SAMPLER_TRAIN picks
    the sampler: TrainingSampler, or RepeatFactorTrainingSampler at
    DATALOADER.REPEAT_THRESHOLD."""

    def __init__(self, cfg, dataset_dicts: Optional[List[Dict]] = None):
        self.dataset_dicts = (train_dataset_dicts(cfg) if dataset_dicts is None
                              else dataset_dicts)
        self.mapper = DatasetMapper(cfg, is_train=True)
        log_class_histogram(self.dataset_dicts)
        self.batch_size = cfg.SOLVER.IMS_PER_BATCH
        seed = cfg.SEED if cfg.SEED > 0 else 2022
        if cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler":
            self.sampler = RepeatFactorTrainingSampler(
                self.dataset_dicts, cfg.DATALOADER.REPEAT_THRESHOLD,
                seed=seed)
        else:
            self.sampler = TrainingSampler(len(self.dataset_dicts), seed=seed)
        self.canvases = train_canvas_shapes(cfg)
        self.max_instances = cfg.TPU.MAX_INSTANCES
        self.segmask_stride = labelmap_stride(cfg)
        self.aspect_grouping = cfg.DATALOADER.ASPECT_RATIO_GROUPING
        self.prefetch = cfg.TPU.PREFETCH
        self._rng = np.random.RandomState(seed * 1000)

    def _batch_stream(self):
        buckets: Dict[int, List] = {0: [], 1: []}
        for idx in self.sampler:
            s = self.mapper(self.dataset_dicts[idx], self._rng)
            if s is None:
                continue
            h, w = s["image"].shape[:2]
            b = 0 if w >= h or not self.aspect_grouping else 1
            buckets[b].append(s)
            if len(buckets[b]) == self.batch_size:
                canvas = (self.canvases[b] if self.aspect_grouping
                          else (max(self.canvases[0]),) * 2)
                yield pack_batch(buckets[b], canvas, self.max_instances,
                                 self.segmask_stride)
                buckets[b] = []

    def __iter__(self):
        """Batches from a daemon thread; an error there is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))

        def worker():
            try:
                for batch in self._batch_stream():
                    q.put(batch)
            except Exception as e:  # surfaced on the consumer side
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
