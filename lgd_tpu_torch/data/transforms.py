"""Host transforms (numpy + cv2), port of lgd_tpu/data/transforms.py:
multi-scale ResizeShortestEdge and RandomFlip for training, a fixed
ResizeShortestEdge for evaluation. They draw from the caller's
``np.random.RandomState`` in the JAX package's order, and ResizeTransform
resizes with cv2.INTER_LINEAR, so both packages hand the model the same
pixels, boxes and polygons for the same seed."""

from __future__ import annotations

import cv2
import numpy as np


class Transform:
    """One applied augmentation, replayable on boxes."""

    def apply_image(self, img):  # pragma: no cover - interface
        raise NotImplementedError

    def apply_coords(self, coords):  # (N, 2)
        raise NotImplementedError

    def apply_box(self, boxes):  # (N, 4) x1y1x2y2
        n = boxes.shape[0]
        if n == 0:
            return boxes
        corners = np.stack([boxes[:, [0, 1]], boxes[:, [2, 1]],
                            boxes[:, [0, 3]], boxes[:, [2, 3]]],
                           axis=1).reshape(-1, 2)
        corners = self.apply_coords(corners).reshape(n, 4, 2)
        return np.concatenate([corners.min(axis=1), corners.max(axis=1)],
                              axis=1).astype(np.float32)

    def apply_polygons(self, polygons):  # [flattened xy, ...]
        return [self.apply_coords(np.asarray(p, np.float64).reshape(-1, 2))
                .reshape(-1) for p in polygons]


class ResizeTransform(Transform):
    def __init__(self, h, w, new_h, new_w):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img):
        return cv2.resize(img, (self.new_w, self.new_h),
                          interpolation=cv2.INTER_LINEAR)

    def apply_coords(self, coords):
        coords = coords.astype(np.float64).copy()
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords


class HFlipTransform(Transform):
    def __init__(self, width):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = coords.astype(np.float64).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords


class ResizeShortestEdge:
    """Resize the short edge to a sampled target and cap the long edge at
    ``max_size`` (detectron2 semantics)."""

    def __init__(self, short_edge_lengths, max_size: int,
                 sample_style: str = "choice"):
        if isinstance(short_edge_lengths, int):
            short_edge_lengths = (short_edge_lengths,)
        self.short = tuple(short_edge_lengths)
        self.max_size = max_size
        self.sample_style = sample_style

    def get_transform(self, img, rng: np.random.RandomState) -> Transform:
        h, w = img.shape[:2]
        if self.sample_style == "choice":
            size = self.short[rng.randint(len(self.short))]
        else:  # range
            size = rng.randint(min(self.short), max(self.short) + 1)
        if size == 0:
            return NoOpTransform()
        scale = size / min(h, w)
        if h < w:
            new_h, new_w = size, scale * w
        else:
            new_h, new_w = scale * h, size
        if max(new_h, new_w) > self.max_size:
            s = self.max_size / max(new_h, new_w)
            new_h, new_w = new_h * s, new_w * s
        return ResizeTransform(h, w, int(new_h + 0.5), int(new_w + 0.5))


class RandomFlip:
    """Horizontal flip with probability ``prob``."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def get_transform(self, img, rng: np.random.RandomState) -> Transform:
        if rng.rand() < self.prob:
            return HFlipTransform(img.shape[1])
        return NoOpTransform()


def build_augmentation(cfg, is_train: bool):
    """detectron2 detection_utils.build_augmentation: multi-scale resize
    and flip for training, a fixed resize for evaluation. The reference's
    optional crop (INPUT.CROP) is not ported."""
    if not is_train:
        return [ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST,
                                   cfg.INPUT.MAX_SIZE_TEST)]
    if cfg.INPUT.CROP.ENABLED:
        raise NotImplementedError("INPUT.CROP is not ported")
    augs = [ResizeShortestEdge(tuple(cfg.INPUT.MIN_SIZE_TRAIN),
                               cfg.INPUT.MAX_SIZE_TRAIN,
                               cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING)]
    if cfg.INPUT.RANDOM_FLIP != "none":
        augs.append(RandomFlip())
    return augs


def apply_augmentations(augs, image, rng):
    tfms = []
    for aug in augs:
        t = aug.get_transform(image, rng)
        image = t.apply_image(image)
        tfms.append(t)
    return image, tfms


def transform_boxes(tfms, boxes):
    for t in tfms:
        boxes = t.apply_box(boxes)
    return boxes


def transform_polygons(tfms, polygons):
    for t in tfms:
        polygons = t.apply_polygons(polygons)
    return polygons
