"""The whole ported slice against the JAX package: DistillatorRetinaNet
inference (normalize -> ResNet -> FPN -> head -> RetinaNet inference with
NMS) on the same weights and images, the eval data path, and the port's
``do_test`` through COCO scoring."""

import os

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_model,
    random_weights,
    retinanet_cfg,
    student_shapes,
    unflatten,
)

from lgd_tpu_torch.data import loader as tloader
from lgd_tpu_torch.data import make_synthetic_dataset_dicts
from lgd_tpu_torch.engine.trainer import do_test
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.utils.param_bridge import load_flax_weights


def test_distillator_inference_matches_jax():
    """Float32 end to end at a 96x128 canvas, B=2 (one image padded).
    Valid slots must match: classes exactly, scores to 1e-5 and boxes to
    1e-2 px. The tolerances are wider than the inference-only test's
    because the convolutions sum in a different order (features agree to
    about 2e-4 relative, tests/test_torch_backbone.py)."""
    cfg = retinanet_cfg(opts=["TEST.DETECTIONS_PER_IMAGE", 50])
    jm = jax_model(cfg)
    flat = random_weights(student_shapes(jm), seed=2)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32), flat)
    rng = np.random.RandomState(1)
    images = (rng.rand(2, 96, 128, 3) * 255).astype(np.float32)
    sizes = np.asarray([[96, 128], [80, 90]], np.int32)
    images[1, 80:] = 0.0
    images[1, :, 90:] = 0.0

    want = jax.jit(lambda v, x, s: jm.apply(v, x, s, method=jm.inference))(
        unflatten(flat), images, sizes)
    got = tm.inference(torch.from_numpy(images).permute(0, 3, 1, 2),
                       torch.from_numpy(sizes))

    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.all()
    for b in range(2):
        g_s, w_s = got.scores[b].numpy(), np.asarray(want.scores[b])
        g_order = np.lexsort((got.classes[b].numpy(), -g_s))
        w_order = np.lexsort((np.asarray(want.classes[b]), -w_s))
        np.testing.assert_array_equal(got.classes[b].numpy()[g_order],
                                      np.asarray(want.classes[b])[w_order])
        np.testing.assert_allclose(g_s[g_order], w_s[w_order], atol=1e-5)
        np.testing.assert_allclose(got.boxes[b].numpy()[g_order],
                                   np.asarray(want.boxes[b])[w_order],
                                   atol=1e-2)


def test_eval_batches_match_jax_loader():
    """Same synthetic split (identical RNG draw), same resize (cv2), same
    padded batch as the JAX package's TestLoader."""
    from lgd_tpu.data import loader as jloader
    from lgd_tpu.data.synthetic import make_synthetic_dataset_dicts as jdicts

    dicts = make_synthetic_dataset_dicts(4, seed=3)
    want_dicts = jdicts(4, seed=3)
    for d, w in zip(dicts, want_dicts):
        np.testing.assert_array_equal(d["image"], w["image"])
        assert d["annotations"] == w["annotations"]

    cfg = retinanet_cfg(opts=["INPUT.MIN_SIZE_TEST", 96,
                              "INPUT.MAX_SIZE_TEST", 128,
                              "TPU.MAX_INSTANCES", 8])
    # the JAX TestLoader resolves a catalog name, so its mapper and packer
    # are driven here on the port's schedule
    from lgd_tpu.data.dataset_mapper import DatasetMapper as JMapper

    rng_j = np.random.RandomState(0)
    jmapper = JMapper(cfg, is_train=False)
    loader = tloader.TestLoader(cfg, dicts, batch_size=2)
    seen = 0
    for batch in loader:
        idxs = [m["image_id"] - 1 for m in batch["_meta"] if m is not None]
        samples = [jmapper(want_dicts[i], rng_j) for i in idxs]
        canvas = batch["image"].shape[1:3]
        jb = jloader.pack_batch(samples + [loader._dummy_sample()]
                                * (2 - len(samples)), canvas, 8)
        np.testing.assert_array_equal(batch["image"], np.asarray(jb["image"]))
        np.testing.assert_array_equal(batch["image_size"],
                                      np.asarray(jb["image_size"]))
        np.testing.assert_array_equal(batch["gt"].boxes.numpy(),
                                      np.asarray(jb["gt"].boxes))
        np.testing.assert_array_equal(batch["gt"].valid.numpy(),
                                      np.asarray(jb["gt"].valid))
        seen += len(idxs)
    assert seen == 4


def test_do_test_returns_coco_metrics():
    cfg = retinanet_cfg(opts=["INPUT.MIN_SIZE_TEST", 64,
                              "INPUT.MAX_SIZE_TEST", 96,
                              "MODEL.RETINANET.SCORE_THRESH_TEST", 0.0,
                              "DATASETS.TEST", ("synthetic_mini",)])
    model = build_model(cfg, dtype=torch.float32, seed=0)
    res = do_test(cfg, model, "cpu", batch_size=8)
    for key in ("AP", "AP50", "AP75", "APm", "APl", "AR@100"):
        assert key in res["bbox"] and np.isfinite(res["bbox"][key])


def test_eval_teacher_and_training_raise():
    cfg = retinanet_cfg()
    model = build_model(cfg, dtype=torch.float32, seed=0)
    x = torch.zeros(1, 3, 64, 64)
    s = torch.tensor([[64, 64]])
    with pytest.raises(NotImplementedError, match="queue item 1"):
        model.inference(x, s, eval_teacher=True)
    with pytest.raises(NotImplementedError, match="queue item 2"):
        model.train_forward(x, s)
    dcn = retinanet_cfg(opts=["MODEL.RESNETS.DEFORM_ON_PER_STAGE",
                              [False, True, True, True]])
    with pytest.raises(NotImplementedError, match="DCN"):
        build_model(dcn)


def test_eval_only_cli_evaluates_a_jax_npz_dump(tmp_path):
    """``python -m lgd_tpu_torch.train --eval-only`` on the in-repo mini
    config, evaluating a ``.npz`` written by the JAX package's own
    save_variables_npz; the dump's teacher entries are dropped, as
    inference does not use them."""
    import jax.numpy as jnp

    from lgd_tpu.engine.checkpoint import save_variables_npz
    from lgd_tpu_torch import train as ttrain

    flat = random_weights(student_shapes(jax_model(retinanet_cfg())), seed=3)
    tree = unflatten(flat)
    tree["params"]["teacher"] = {"proj": {"kernel": jnp.zeros((4, 4))}}
    path = str(tmp_path / "weights.npz")
    save_variables_npz(path, tree["params"], tree["frozen"])

    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "lgd_tpu",
                        "retinanet_R18_synthetic_mini.yaml")
    argv = ["--config-file", yaml,
            "--eval-only",
            "MODEL.WEIGHTS", path, "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(tmp_path / "out")]
    parser = ttrain.default_argument_parser()
    with pytest.raises(NotImplementedError, match="queue item 1"):
        ttrain.main(parser.parse_args(argv))  # the YAML asks for EVAL_TEACHER
    res = ttrain.main(parser.parse_args(
        argv + ["MODEL.DISTILLATOR.EVAL_TEACHER", "False"]))
    assert np.isfinite(res["bbox"]["AP50"])
    assert (tmp_path / "out" / "inference" / "synthetic_mini"
            / "metrics.json").exists()
    with pytest.raises(NotImplementedError, match="queue item 2"):
        ttrain.main(parser.parse_args(argv[:2]))


def test_eval_only_loads_a_torch_state_dict(tmp_path):
    cfg = retinanet_cfg()
    src = build_model(cfg, dtype=torch.float32, seed=4)
    path = str(tmp_path / "weights.pt")
    torch.save(src.state_dict(), path)
    from lgd_tpu_torch import train as ttrain

    dst = ttrain.load_weights(build_model(cfg, dtype=torch.float32), path)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
