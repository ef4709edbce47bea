"""Datasets, samplers and evaluators of the port (lgd_tpu_torch/data/
{catalog,coco,voc,lvis,loader}.py, lgd_tpu_torch/evaluation/) against the
JAX package's on the same inputs: COCO, VOC and LVIS files written here
from seeded numbers, seeded detections and label maps. Loaders must give
equal dicts and metadata, samplers equal index streams, and evaluators
equal metrics within 1e-12. No model is built."""

import json
import logging
import math

import cv2
import numpy as np
import pytest

import lgd_tpu.data as jdata
import lgd_tpu.evaluation as jeval
import lgd_tpu_torch.data as tdata
import lgd_tpu_torch.evaluation as teval
from lgd_tpu.config import get_cfg as jax_cfg
from lgd_tpu.data.lvis import load_lvis_json as jax_load_lvis
from lgd_tpu.data.voc import load_voc_instances as jax_load_voc
from lgd_tpu.evaluation.voc_eval import voc_ap as jax_voc_ap
from lgd_tpu_torch.config import get_cfg
from lgd_tpu_torch.data.lvis import load_lvis_json
from lgd_tpu_torch.data.voc import load_voc_instances
from lgd_tpu_torch.evaluation.voc_eval import voc_ap

TOL = 1e-12
BUILTIN = ("coco_2017_train", "coco_2017_val", "voc_2007_trainval",
           "voc_2007_test", "voc_2012_trainval", "lvis_v1_train",
           "lvis_v1_val", "synthetic_mini")
COCO_IDS = (1, 2, 18, 44)


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, dict):
            _same_metrics(got[key], value)
        elif math.isnan(value):
            assert math.isnan(got[key]), key
        else:
            assert abs(got[key] - value) <= TOL, (key, got[key], value)


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """A COCO instances JSON with images on disk, after
    tests/test_data_pipeline.py's fixture, with a crowd box, an ignored
    box, an RLE segmentation and an image left with crowd boxes only."""
    root = tmp_path_factory.mktemp("minicoco")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(5):
        h, w = int(rng.randint(60, 120)), int(rng.randint(60, 160))
        fname = f"{i:06d}.png"
        cv2.imwrite(str(img_dir / fname),
                    rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append({"id": i + 1, "file_name": fname, "height": h,
                       "width": w})
        for j in range(int(rng.randint(1, 4))):
            bw, bh = rng.randint(8, w // 2), rng.randint(8, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            ann = {"id": len(annotations) + 1, "image_id": i + 1,
                   "bbox": [float(x), float(y), float(bw), float(bh)],
                   "category_id": int(rng.choice(COCO_IDS)),
                   "iscrowd": int(i == 4 or j == 2), "area": float(bw * bh),
                   "segmentation": [[x, y, x + bw, y, x + bw, y + bh,
                                     x, y + bh], [1, 2, 3]]}
            if i == 1 and j == 0:
                ann["segmentation"] = {"counts": [3, 4], "size": [h, w]}
            if i == 2 and j == 0:
                ann["ignore"] = 1
            annotations.append(ann)
    cats = [{"id": c, "name": f"cls{c}", "supercategory": "thing"}
            for c in COCO_IDS]
    js = root / "instances_mini.json"
    js.write_text(json.dumps({"info": {}, "licenses": [], "images": images,
                              "annotations": annotations,
                              "categories": cats}))
    return str(js), str(img_dir)


def test_load_coco_json_matches_jax(mini_coco):
    js, img_dir = mini_coco
    got = tdata.load_coco_json(js, img_dir, "_t_mini_coco")
    want = jdata.load_coco_json(js, img_dir, "_t_mini_coco")
    assert got == want
    tmeta = tdata.MetadataCatalog.get("_t_mini_coco")
    jmeta = jdata.MetadataCatalog.get("_t_mini_coco")
    for key in ("thing_classes", "thing_dataset_id_to_contiguous_id"):
        assert tmeta[key] == jmeta[key], key
    assert tmeta.thing_dataset_id_to_contiguous_id == {1: 0, 2: 1, 18: 2,
                                                       44: 3}
    assert (tdata.filter_images_with_only_crowd_annotations(got)
            == jdata.filter_images_with_only_crowd_annotations(want))


def test_detection_dataset_dicts_through_the_catalog(mini_coco):
    """Both catalogs: register, get, list, remove, a second registration
    of a name raises KeyError; get_detection_dataset_dicts concatenates
    and filters alike."""
    js, img_dir = mini_coco
    for data, name in ((tdata, "_t_cat_a"), (jdata, "_t_cat_a")):
        data.DatasetCatalog.register(
            name, lambda data=data: data.load_coco_json(js, img_dir, name))
        with pytest.raises(KeyError):
            data.DatasetCatalog.register(name, list)
        assert name in data.DatasetCatalog.list()
    for flt in (True, False):
        got = tdata.get_detection_dataset_dicts(["_t_cat_a", "_t_cat_a"],
                                                filter_empty=flt)
        want = jdata.get_detection_dataset_dicts(["_t_cat_a", "_t_cat_a"],
                                                 filter_empty=flt)
        assert got == want
        assert len(got) == (6 if flt else 10)
    for data in (tdata, jdata):
        data.DatasetCatalog.remove("_t_cat_a")
        assert "_t_cat_a" not in data.DatasetCatalog.list()
    for name in BUILTIN:
        assert name in tdata.DatasetCatalog.list()
        assert (tdata.MetadataCatalog.get(name)
                == jdata.MetadataCatalog.get(name)), name


def _voc_dir(tmp_path):
    d = tmp_path / "VOC2007"
    (d / "Annotations").mkdir(parents=True)
    (d / "ImageSets" / "Main").mkdir(parents=True)
    (d / "JPEGImages").mkdir()
    rng = np.random.RandomState(1)
    ids = [f"{i:06d}" for i in range(1, 5)]
    (d / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids) + "\n")
    names = ["dog", "person", "car", "unicorn"]
    for fid in ids:
        objs = []
        for j in range(int(rng.randint(1, 5))):
            x1, y1 = rng.randint(1, 100, 2)
            diff = ("" if j == 3 else
                    f"<difficult>{int(rng.rand() < 0.3)}</difficult>")
            objs.append(
                f"<object><name>{names[rng.randint(4)]}</name>{diff}"
                f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
                f"<xmax>{x1 + rng.randint(5, 90)}</xmax>"
                f"<ymax>{y1 + rng.randint(5, 90)}</ymax></bndbox></object>")
        (d / "Annotations" / f"{fid}.xml").write_text(
            "<annotation><size><width>353</width><height>500</height>"
            "<depth>3</depth></size>" + "".join(objs) + "</annotation>")
    return str(d)


def test_load_voc_instances_matches_jax(tmp_path):
    d = _voc_dir(tmp_path)
    got, want = load_voc_instances(d, "test"), jax_load_voc(d, "test")
    assert got == want
    assert any(a["difficult"] for r in got for a in r["annotations"])


def _lvis_json(tmp_path):
    rng = np.random.RandomState(2)
    cats = [{"id": c, "name": f"c{c}", "frequency": f}
            for c, f in ((3, "r"), (7, "c"), (9, "f"), (12, "f"))]
    images, anns = [], []
    for i in range(4):
        images.append({
            "id": 10 + i, "height": 100, "width": 120,
            "coco_url": f"images/val2017/{i:012d}.jpg",
            "neg_category_ids": [c["id"] for c in cats if rng.rand() < 0.3],
            "not_exhaustive_category_ids": [cats[i]["id"]]})
        for _ in range(int(rng.randint(1, 4))):
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "bbox": [float(v) for v in rng.rand(4) * 50],
                         "category_id": cats[rng.randint(4)]["id"],
                         "segmentation": [[1, 1, 5, 1, 5, 5]]})
    path = tmp_path / "lvis_v1_val.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    return str(path)


def test_load_lvis_json_matches_jax(tmp_path):
    js = _lvis_json(tmp_path)
    got = load_lvis_json(js, "coco/", "_t_lvis")
    want = jax_load_lvis(js, "coco/", "_t_lvis")
    assert got == want
    assert got[0]["file_name"] == "coco/val2017/000000000000.jpg"
    for key in ("thing_classes", "thing_dataset_id_to_contiguous_id",
                "class_frequencies"):
        assert (tdata.MetadataCatalog.get("_t_lvis")[key]
                == jdata.MetadataCatalog.get("_t_lvis")[key]), key


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.RandomState(3)
    for n in (1, 7, 50):
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        assert abs(voc_ap(rec, prec, use_07)
                   - jax_voc_ap(rec, prec, use_07)) <= TOL


def _detections(rng, gt, num_classes, per_image=12):
    """Seeded detections near the ground truth, some far from it, a few
    duplicated, in original-image coordinates (XYXY)."""
    out = []
    for d in gt:
        boxes, classes = [], []
        for a in d["annotations"]:
            b = np.asarray(a["bbox"], np.float64)
            if a.get("bbox_mode", "XYWH_ABS") == "XYWH_ABS":
                b = np.concatenate([b[:2], b[:2] + b[2:]])
            for _ in range(2):
                boxes.append(b + rng.randn(4) * 3)
                classes.append(a["category_id"])
        while len(boxes) < per_image:
            xy = rng.rand(2) * 80
            boxes.append(np.concatenate([xy, xy + 5 + rng.rand(2) * 40]))
            classes.append(rng.randint(num_classes))
        out.append((d["image_id"], np.asarray(boxes),
                    rng.rand(len(boxes)), np.asarray(classes)))
    return out


def _score(evaluators, dets):
    results = []
    for ev in evaluators:
        ev.reset()
        for args in dets:
            ev.process(*args)
        results.append(ev.evaluate())
    return results


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_evaluator_matches_jax(tmp_path, use_07):
    gt = load_voc_instances(_voc_dir(tmp_path), "test")
    dets = _detections(np.random.RandomState(4), gt, 20)
    got, want = _score(
        [teval.PascalVOCDetectionEvaluator(gt_dataset=gt,
                                           use_07_metric=use_07),
         jeval.PascalVOCDetectionEvaluator(gt_dataset=gt,
                                           use_07_metric=use_07)], dets)
    _same_metrics(got, want)
    assert 0.0 < want["bbox"]["AP50"] < 100.0


def test_lvis_evaluator_matches_jax(tmp_path):
    """Federated scoring on the LVIS fixture's negatives and 300
    detections per image and category: one image and category gets 350."""
    js = _lvis_json(tmp_path)
    gt = load_lvis_json(js, "coco/", "_t_lvis_eval")
    jax_load_lvis(js, "coco/", "_t_lvis_eval")
    rng = np.random.RandomState(5)
    dets = _detections(rng, gt, 4)
    xy = rng.rand(350, 2) * 80
    dets.append((gt[0]["image_id"], np.concatenate([xy, xy + 20], 1),
                 rng.rand(350), np.zeros(350, np.int64)))
    got, want = _score(
        [teval.LVISEvaluator("_t_lvis_eval", gt, num_classes=4),
         jeval.LVISEvaluator("_t_lvis_eval", gt, num_classes=4)], dets)
    _same_metrics(got, want)
    assert "AR@300" in want["bbox"] and "APr" in want["bbox"]


def test_sem_seg_evaluator_matches_jax():
    rng = np.random.RandomState(6)
    evs = [teval.SemSegEvaluator(num_classes=5),
           jeval.SemSegEvaluator(num_classes=5)]
    for _ in range(3):
        gt = rng.randint(0, 5, (17, 23))
        gt[rng.rand(17, 23) < 0.1] = 255
        pred = np.where(rng.rand(17, 23) < 0.6, gt, rng.randint(0, 6,
                                                                 (17, 23)))
        for ev in evs:
            ev.process(pred, gt)
    _same_metrics(evs[0].evaluate(), evs[1].evaluate())


def test_coco_evaluator_by_dataset_name_matches_jax(mini_coco):
    """The constructor's ``dataset_name`` resolves the ground truth and the
    class names through the catalog, as the JAX one does; ``gt_dataset``
    gives the same numbers."""
    js, img_dir = mini_coco
    for data in (tdata, jdata):
        data.DatasetCatalog.register(
            "_t_coco_named",
            lambda data=data: data.load_coco_json(js, img_dir,
                                                  "_t_coco_named"))
    # loading the JSON records the class names, which the evaluators read
    # before they load the ground truth
    gt = tdata.DatasetCatalog.get("_t_coco_named")
    jdata.DatasetCatalog.get("_t_coco_named")
    dets = _detections(np.random.RandomState(7), gt, 4)
    got, want, plain = _score(
        [teval.COCOEvaluator("_t_coco_named", num_classes=4),
         jeval.COCOEvaluator("_t_coco_named", num_classes=4),
         teval.COCOEvaluator(gt_dataset=gt, num_classes=4)], dets)
    _same_metrics(got, want)
    assert "AP-cls1" in got["bbox"]
    assert plain["bbox"]["AP"] == got["bbox"]["AP"]


EVALUATOR_TYPES = ("coco", "coco_panoptic_seg", "crowdHuman", "sem_seg",
                   "cityscapes_instance", "cityscapes_sem_seg", "pascal_voc",
                   "lvis")


@pytest.mark.parametrize("etype", EVALUATOR_TYPES)
def test_get_evaluator_routes_as_jax(etype):
    name = f"_t_route_{etype}"
    for data in (tdata, jdata):
        data.DatasetCatalog.register(name, list)
        data.MetadataCatalog.get(name).update(evaluator_type=etype,
                                              year=2012)
    got = teval.get_evaluator(get_cfg(), name)
    want = jeval.get_evaluator(jax_cfg(), name)
    assert type(got).__name__ == type(want).__name__
    if etype == "coco_panoptic_seg":
        assert ([type(e).__name__ for e in got._evaluators]
                == [type(e).__name__ for e in want._evaluators])
    if etype == "pascal_voc":
        assert got.use_07_metric is want.use_07_metric is False


def test_get_evaluator_raises_on_an_unknown_type():
    for data, ev, cfg in ((tdata, teval, get_cfg()),
                          (jdata, jeval, jax_cfg())):
        data.DatasetCatalog.register("_t_route_unknown", list)
        data.MetadataCatalog.get("_t_route_unknown").update(
            evaluator_type="kitti")
        with pytest.raises(NotImplementedError):
            ev.get_evaluator(cfg, "_t_route_unknown")


def _skewed_dicts(n=40):
    rng = np.random.RandomState(8)
    return [{"annotations": [{"category_id": int(c), "iscrowd": int(k == 2)}
                             for k, c in enumerate(rng.choice(
                                 [0, 0, 0, 0, 1, 2, 3], rng.randint(0, 4)))]}
            for _ in range(n)]


def test_samplers_match_jax():
    import itertools

    from lgd_tpu.data.loader import (
        RepeatFactorTrainingSampler as JaxRepeat,
    )

    dicts = _skewed_dicts()
    pairs = [(tdata.RepeatFactorTrainingSampler(dicts, 0.3, seed=5),
              JaxRepeat(dicts, 0.3, seed=5)),
             (tdata.TrainingSampler(len(dicts), seed=5),
              jdata.TrainingSampler(len(dicts), seed=5))]
    for ours, theirs in pairs:
        got = list(itertools.islice(iter(ours), 2000))
        assert got == list(itertools.islice(iter(theirs), 2000))
    assert pairs[0][0]._rep.max() > 1.0  # the rare classes repeat


def test_train_loader_takes_the_repeat_factor_sampler():
    cfg = get_cfg()
    cfg.DATALOADER.SAMPLER_TRAIN = "RepeatFactorTrainingSampler"
    cfg.DATALOADER.REPEAT_THRESHOLD = 0.3
    loader = tdata.TrainLoader(cfg, tdata.make_synthetic_dataset_dicts(
        4, max_hw=(32, 48)))
    assert isinstance(loader.sampler, tdata.RepeatFactorTrainingSampler)


def test_test_loader_skips_an_unreadable_image(mini_coco, caplog):
    """An eval image that cannot be read becomes a padding slot with a
    warning; the others are evaluated as before."""
    js, img_dir = mini_coco
    dicts = tdata.load_coco_json(js, img_dir)[:3]
    dicts[1] = dict(dicts[1], file_name=dicts[1]["file_name"] + ".gone")
    cfg = get_cfg()
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 64, 96
    with caplog.at_level(logging.WARNING):
        batches = list(tdata.TestLoader(cfg, dicts, batch_size=4))
    metas = [m for b in batches for m in b["_meta"] if m is not None]
    assert sorted(m["image_id"] for m in metas) == [1, 3]
    assert "skipping unreadable eval image" in caplog.text
