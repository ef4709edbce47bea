"""Metrics writers: terminal, ``metrics.json`` and TensorBoard (port of
lgd_tpu/engine/events.py).

detectron2's EventStorage, CommonMetricPrinter, JSONWriter and
TensorboardXWriter as the reference's train loop wires them
(train.py:169-177,196-199,229-233). Host-side: they take the host floats
of the metrics that ``train_step`` returns.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict

logger = logging.getLogger(__name__)


class EventStorage:
    """The latest value of each scalar and its median over a window."""

    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._history = defaultdict(lambda: deque(maxlen=window))
        self._latest = {}

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            v = float(v)
            self._history[k].append(v)
            self._latest[k] = v

    def median(self, k):
        h = sorted(self._history[k])
        return h[len(h) // 2] if h else float("nan")

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)


class CommonMetricPrinter:
    """One log line: iteration, the losses' medians, both learning rates,
    seconds per iteration since the last write and the time left."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._last_iter = None
        self._last_time = None

    def write(self, storage: EventStorage):
        it = storage.iter
        now = time.perf_counter()
        if self._last_iter is not None and it > self._last_iter:
            iter_time = (now - self._last_time) / (it - self._last_iter)
            eta = (self.max_iter - it) * iter_time
            eta_str = f"{eta / 3600:.1f}h"
        else:
            iter_time, eta_str = float("nan"), "?"
        self._last_iter, self._last_time = it, now
        latest = storage.latest()
        losses = "  ".join(
            f"{k}: {storage.median(k):.4f}"
            for k in sorted(latest)
            if k.startswith("loss") or k == "total_loss"
        )
        lrs = "  ".join(f"{k}: {latest[k]:.2e}"
                        for k in ("stu_lr", "tea_lr") if k in latest)
        logger.info("iter: %d/%d  %s  %s  time: %.3fs/it  eta: %s",
                    it, self.max_iter, losses, lrs, iter_time, eta_str)

    def close(self):
        pass


class JSONWriter:
    """One JSON line per write, ``{"iteration": i, <latest scalars>}``. The
    file is opened for append, so a resumed run continues it."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter}
        rec.update(storage.latest())
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


_told_no_tensorboard = False


def _summary_writer(log_dir: str):
    """tensorboardX's SummaryWriter (the JAX package's), else torch's,
    which imports TensorFlow where it is installed, else None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


class TensorboardWriter:
    """Every latest scalar at the storage's iteration. Without
    ``tensorboardX`` and ``torch.utils.tensorboard`` it writes nothing and
    says so once per process."""

    def __init__(self, log_dir: str):
        global _told_no_tensorboard
        self._w = _summary_writer(log_dir)
        if self._w is None and not _told_no_tensorboard:
            _told_no_tensorboard = True
            logger.info("neither tensorboardX nor torch.utils.tensorboard "
                        "imports: no TensorBoard events are written")

    def write(self, storage: EventStorage):
        if self._w is None:
            return
        for k, v in storage.latest().items():
            self._w.add_scalar(k, v, storage.iter)

    def close(self):
        if self._w is not None:
            self._w.close()
