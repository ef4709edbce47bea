"""COCO box scoring of the port (lgd_tpu_torch/evaluation/coco_eval.py, the
numpy matching loop) against the JAX package's evaluator on the same ground
truth and detections: every metric equal within 1e-9 (the same arithmetic,
with the JAX package's matching done by its C++ core where it builds)."""

import numpy as np
import pytest

from lgd_tpu.evaluation import COCOEvaluator as JaxEvaluator
from lgd_tpu_torch.evaluation import COCOEvaluator

NUM_CLASSES = 5


def _dataset(rng, num_images=6):
    """Images with 0-6 boxes of every COCO size range; some crowd boxes."""
    dicts = []
    for i in range(num_images):
        annos = []
        for _ in range(rng.randint(0, 7)):
            side = rng.choice([12.0, 60.0, 200.0]) * rng.uniform(0.7, 1.3)
            x, y = rng.uniform(0, 400, 2)
            annos.append({"bbox": [x, y, side, side * rng.uniform(0.5, 2.0)],
                          "category_id": int(rng.randint(NUM_CLASSES)),
                          "iscrowd": int(rng.rand() < 0.1)})
        dicts.append({"image_id": i + 1, "height": 640, "width": 640,
                      "annotations": annos})
    return dicts


def _detections(rng, dataset):
    """Per image: jittered copies of its GT boxes, duplicates and false
    positives, xyxy with random scores and classes (mostly the GT's)."""
    out = []
    for d in dataset:
        boxes, classes = [], []
        for a in d["annotations"]:
            x, y, w, h = a["bbox"]
            for _ in range(rng.randint(1, 3)):
                j = rng.normal(0, 0.1, 4) * [w, h, w, h]
                boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
                classes.append(a["category_id"] if rng.rand() < 0.8
                               else int(rng.randint(NUM_CLASSES)))
        for _ in range(rng.randint(0, 4)):
            x, y = rng.uniform(0, 500, 2)
            w, h = rng.uniform(8, 150, 2)
            boxes.append([x, y, x + w, y + h])
            classes.append(int(rng.randint(NUM_CLASSES)))
        out.append((d["image_id"], np.asarray(boxes, np.float64).reshape(-1, 4),
                    rng.rand(len(boxes)), np.asarray(classes, np.int64)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_bbox_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    dataset = _dataset(rng)
    dets = _detections(rng, dataset)
    results = []
    for cls in (COCOEvaluator, JaxEvaluator):
        ev = cls(gt_dataset=dataset, num_classes=NUM_CLASSES)
        for image_id, boxes, scores, classes in dets:
            ev.process(image_id, boxes, scores, classes)
        results.append(ev.evaluate(("bbox",))["bbox"])
    got, want = results
    assert sorted(got) == sorted(want)
    assert 0.0 < want["AP"] < 100.0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-9,
                                   err_msg=key)
