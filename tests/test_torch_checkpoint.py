"""Checkpoints, resume, metrics writers and the backbone import of the port
(lgd_tpu_torch/engine/{checkpoint,events,trainer}.py,
lgd_tpu_torch/utils/weight_convert.py, lgd_tpu_torch/train.py) on the CPU.

Against the JAX package: the converter of detectron2- and Caffe2-named
ResNet pickles (through the param bridge, bit for bit) and the event
storage and JSON writer. The port alone: k steps, a killed run's
checkpoint and a resume, then N - k steps equal N straight steps bit for
bit on fixed batches; a kill during a save; pruning; the command line from
a backbone pickle on a COCO-format dataset, ``--resume`` and
``--eval-only``; a missing ``detectron2://`` file.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from lgd_tpu_torch.data import (
    DatasetCatalog,
    MetadataCatalog,
    TrainLoader,
    load_coco_json,
    make_synthetic_dataset_dicts,
)
from lgd_tpu_torch.engine.checkpoint import Checkpointer
from lgd_tpu_torch.engine.events import EventStorage, JSONWriter
from lgd_tpu_torch.engine.train_step import TrainState
from lgd_tpu_torch.engine.trainer import do_train
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.utils import weight_convert
from lgd_tpu_torch.utils.param_bridge import _to_torch, torch_key
from torch_parity import retinanet_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_YAML = os.path.join(ROOT, "configs", "lgd_tpu",
                         "retinanet_R18_synthetic_mini.yaml")
STEPS, KILLED_AFTER = 4, 2
OPTS = ["MODEL.FPN.OUT_CHANNELS", 64, "TPU.MAX_INSTANCES", 8,
        "MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0,
        "MODEL.DISTILLATOR.PRE_FREEZE_STUDENT_BACKBONE_ITERS", 1,
        "MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS", 2,
        "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96,
        "SOLVER.IMS_PER_BATCH", 1, "SOLVER.MAX_ITER", STEPS,
        "SOLVER.CHECKPOINT_PERIOD", KILLED_AFTER,
        "SOLVER.CLIP_GRADIENTS.ENABLED", True]
for _who in ("STUDENT", "TEACHER"):
    _node = f"MODEL.DISTILLATOR.{_who}.SOLVER."
    OPTS += [_node + "LR_SCHEDULER_NAME", "WarmupMultiStepLR",
             _node + "BASE_LR", 2e-3, _node + "STEPS", (100,),
             _node + "GAMMA", 0.1, _node + "WARMUP_FACTOR", 1e-3,
             _node + "WARMUP_ITERS", 2, _node + "WARMUP_METHOD", "linear"]


def _cfg(out_dir):
    return retinanet_cfg(opts=[*OPTS, "OUTPUT_DIR", str(out_dir)])


def _train(cfg, loader, seed, resume=False):
    """do_train on the CPU; returns the model, the final state and each
    step's losses."""
    model = build_model(cfg, dtype=torch.float32, device="cpu", seed=seed)
    seen, forward = [], model.train_forward

    def recording(*args, **kwargs):
        losses, norm = forward(*args, **kwargs)
        seen.append({k: v.detach().clone() for k, v in losses.items()})
        return losses, norm

    model.train_forward = recording
    state = do_train(cfg, model, "cpu", resume=resume, loader=loader)
    return model, state, seen


def _equal(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def test_resume_after_a_kill_equals_a_straight_run(tmp_path):
    """STEPS straight steps against KILLED_AFTER steps of a run whose
    loader dies after the checkpoint of iteration KILLED_AFTER - 1, then a
    resume in a model built from another seed, fed the remaining batches:
    the same losses, parameters, buffers, optimizer states, normalizer,
    step and generator, bit for bit."""
    straight_cfg = _cfg(tmp_path / "straight")
    it = iter(TrainLoader(straight_cfg, make_synthetic_dataset_dicts(
        4, seed=1, max_hw=(64, 96))))
    batches = [next(it) for _ in range(STEPS)]
    model_a, state_a, seen_a = _train(straight_cfg, batches, seed=0)

    def dies():
        yield from batches[:KILLED_AFTER]
        raise RuntimeError("killed")

    cfg = _cfg(tmp_path / "killed")
    with pytest.raises(RuntimeError, match="killed"):
        _train(cfg, dies(), seed=0)
    assert Checkpointer(cfg.OUTPUT_DIR).steps() == [KILLED_AFTER - 1]
    model_b, state_b, seen_b = _train(cfg, batches[KILLED_AFTER:], seed=5,
                                      resume=True)

    assert len(seen_a) == STEPS and len(seen_b) == STEPS - KILLED_AFTER
    for i, losses in enumerate(seen_b):
        _equal(losses, seen_a[KILLED_AFTER + i], f"step {KILLED_AFTER + i}")
    _equal(model_b.state_dict(), model_a.state_dict(), "model")
    for field in ("stu_opt", "tea_opt", "step", "loss_normalizer"):
        _equal(getattr(state_b, field), getattr(state_a, field), field)
    assert torch.equal(state_b.generator.get_state(),
                       state_a.generator.get_state())
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["iteration"] for r in lines] == [KILLED_AFTER - 1, STEPS - 1]
    assert lines[-1]["total_loss"] == float(sum(
        seen_a[-1][k] for k in sorted(seen_a[-1])))


_KILL_DURING_SAVE = """
import os, sys, torch
from lgd_tpu_torch.engine.checkpoint import Checkpointer
from lgd_tpu_torch.engine.train_step import TrainState
torch.manual_seed(0)
model = torch.nn.Linear(3, 2)
state = TrainState(stu_opt={"momentum": {"w": torch.ones(2)}, "count": 1},
                   tea_opt={}, step=1, loss_normalizer=torch.tensor(5.0),
                   generator=torch.Generator().manual_seed(0))
ckpt = Checkpointer(sys.argv[1])
ckpt.save(0, model, state)
with torch.no_grad():
    model.weight.add_(1.0)

def dies(obj, f, *args, **kwargs):
    f.write(b"half a checkpoint")
    f.flush()
    os._exit(3)

torch.save = dies
ckpt.save(1, model, state)
"""


def test_a_kill_during_a_save_keeps_the_previous_checkpoint(tmp_path):
    run = subprocess.run([sys.executable, "-c", _KILL_DURING_SAVE,
                          str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 3, run.stderr
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_step() == 0
    assert len(os.listdir(ckpt.dir)) == 2  # the torn temporary file
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.weight.zero_()
    template = TrainState({}, {}, 0, torch.tensor(0.0), torch.Generator())
    state = ckpt.restore(0, model, template)
    _equal(model.state_dict(), want, "model")
    assert state.step == 1 and float(state.loss_normalizer) == 5.0
    assert torch.equal(state.stu_opt["momentum"]["w"], torch.ones(2))


def test_max_to_keep_prunes_and_the_generator_resumes(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    model = torch.nn.Linear(2, 2)
    gen = torch.Generator().manual_seed(3)
    for step in range(6):
        torch.rand(5, generator=gen)
        ckpt.save(step, model, TrainState({}, {}, step, torch.tensor(1.0),
                                          gen))
    assert ckpt.steps() == [3, 4, 5]
    want = torch.rand(4, generator=gen)
    template = TrainState({}, {}, 0, torch.tensor(0.0),
                          torch.Generator().manual_seed(9))
    state, start = ckpt.resume_or_load(model, template, resume=True)
    assert start == 6 and state.step == 5
    assert torch.equal(torch.rand(4, generator=state.generator), want)
    assert ckpt.resume_or_load(model, template, resume=False)[1] == 0


def _d2_name(key):
    """A port ResNet key -> its detectron2 name."""
    module, leaf = key.rsplit(".", 1)
    norm = module.endswith("_norm")
    module = module[:-len("_norm")] if norm else module
    if module == "stem_conv1":
        name = "stem.conv1"
    else:
        block, conv = module.split(".")
        name = "{}.{}.{}".format(*block.split("_"), conv)
    stat = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    return ("backbone.bottom_up." + name
            + (f".norm.{stat[leaf]}" if norm else ".weight"))


@pytest.mark.parametrize("naming", ["caffe2", "detectron2"])
def test_convert_resnet_state_matches_jax(naming):
    """An R-18 pickle dict in either naming: the JAX converter's output,
    mapped through the bridge, equals the port's, which covers every
    tensor of the port's bottom_up."""
    from lgd_tpu.utils.weight_convert import (
        convert_resnet_state as jax_convert,
    )
    from lgd_tpu_torch.utils.param_bridge import flatten_variables

    cfg = retinanet_cfg(opts=OPTS)
    bottom_up = build_model(cfg, dtype=torch.float32, device="cpu",
                            seed=1).student.bottom_up
    raw = chip_smoke.caffe2_backbone(
        bottom_up, seed=2, stats=("scale", "bias", "mean", "var"))
    if naming == "detectron2":
        c2 = {chip_smoke.caffe2_name(k): k for k in bottom_up.state_dict()}
        raw = {(_d2_name(c2[k]) if k in c2 else k): v for k, v in raw.items()}
    got = weight_convert.convert_resnet_state(raw)
    want = jax_convert(raw)
    for coll in ("params", "frozen"):
        mapped = {}
        for key, arr in flatten_variables(want[coll]).items():
            flax_key = f"{coll}/student/bottom_up/{key}"
            mapped[torch_key(flax_key)] = _to_torch(flax_key, arr)
        assert sorted(got[coll]) == sorted(mapped)
        for key, arr in mapped.items():
            assert got[coll][key].dtype == np.float32
            np.testing.assert_array_equal(got[coll][key], arr, err_msg=key)
    covered = {k[len("student.bottom_up."):] for coll in got.values()
               for k in coll}
    assert covered == set(bottom_up.state_dict())


def test_events_match_jax(tmp_path):
    """One scalar stream: the same medians over the window of 20, and the
    same metrics.json lines, appended across two writers."""
    from lgd_tpu.engine.events import EventStorage as JaxStorage
    from lgd_tpu.engine.events import JSONWriter as JaxWriter

    rng = np.random.RandomState(0)
    stores = (EventStorage(3), JaxStorage(3))
    paths = (str(tmp_path / "port.json"), str(tmp_path / "jax.json"))
    for half in range(2):
        writers = (JSONWriter(paths[0]), JaxWriter(paths[1]))
        for i in range(25):
            v = float(rng.randn())
            for store, writer in zip(stores, writers):
                store.iter = 3 + 25 * half + i
                store.put_scalars(total_loss=v, stu_lr=np.float32(0.1 * i))
                if i % 7 == 0:
                    writer.write(store)
            assert stores[0].median("total_loss") == stores[1].median(
                "total_loss")
        for w in writers:
            w.close()
    got, want = (open(p).read() for p in paths)
    assert got == want and got.count("\n") == 8


def _write_pickle(path, model, seed):
    with open(path, "wb") as f:
        pickle.dump({"model": chip_smoke.caffe2_backbone(
            model.student.bottom_up, seed), "__author__": "test"}, f)


def test_cli_cold_start_resume_and_eval_only(tmp_path):
    """``python -m lgd_tpu_torch.train`` on a COCO-format split from a
    Caffe2-named backbone pickle: 2 steps with a checkpoint each, then
    ``--resume`` to 3 steps starts at iteration 2, then ``--eval-only``
    restores the last checkpoint and scores what the trained model did."""
    from lgd_tpu_torch import train as ttrain

    js, image_dir, _ = chip_smoke.write_coco_split(
        make_synthetic_dataset_dicts(4, seed=3, max_hw=(64, 96)),
        str(tmp_path / "coco"))
    DatasetCatalog.register("_t_cli_coco",
                            lambda: load_coco_json(js, image_dir,
                                                   "_t_cli_coco"))
    MetadataCatalog.get("_t_cli_coco").update(evaluator_type="coco")
    src = build_model(retinanet_cfg(opts=OPTS), dtype=torch.float32,
                      device="cpu", seed=1)
    pkl = str(tmp_path / "R-18.pkl")
    _write_pickle(pkl, src, seed=2)
    out = tmp_path / "out"
    argv = ["--config-file", MINI_YAML, "MODEL.DEVICE", "cpu",
            "MODEL.WEIGHTS", pkl, "MODEL.FPN.OUT_CHANNELS", "64",
            "MODEL.DISTILLATOR.EVAL_TEACHER", "False",
            "DATASETS.TRAIN", "('_t_cli_coco',)",
            "DATASETS.TEST", "('_t_cli_coco',)",
            "SOLVER.CHECKPOINT_PERIOD", "1",
            "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "96",
            "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
            "MODEL.RETINANET.TOPK_CANDIDATES_TEST", "100",
            "OUTPUT_DIR", str(out)]
    parser = ttrain.default_argument_parser()
    ttrain.main(parser.parse_args(argv + ["SOLVER.MAX_ITER", "2"]))
    ckpt = Checkpointer(str(out))
    assert ckpt.steps() == [0, 1]
    log = (out / "log.txt").read_text()
    assert "(0 unmatched)" in log
    # the YAML freezes the whole backbone for 2 steps: it is the pickle's
    trained = ckpt.load(1)["model"]
    raw = weight_convert.convert_resnet_state(
        weight_convert._load_raw(pkl))
    for key, value in {**raw["params"], **raw["frozen"]}.items():
        np.testing.assert_array_equal(trained[key].numpy(), value,
                                      err_msg=key)

    resumed = ttrain.main(parser.parse_args(
        ["--resume"] + argv + ["SOLVER.MAX_ITER", "3"]))
    assert ckpt.steps() == [0, 1, 2]
    log = (out / "log.txt").read_text()
    assert "Starting training from iteration 2" in log
    with open(out / "metrics.json") as f:
        assert [json.loads(line)["iteration"] for line in f] == [0, 1, 2]

    evaluated = ttrain.main(parser.parse_args(
        ["--eval-only"] + argv + ["SOLVER.MAX_ITER", "3"]))
    assert "Loaded the checkpoint of iteration 2" in (
        out / "log.txt").read_text()
    for key, value in resumed["bbox"].items():
        assert value == evaluated["bbox"][key] or (
            np.isnan(value) and np.isnan(evaluated["bbox"][key])), key


def test_a_missing_detectron2_file_warns_and_trains_from_random_init(
        tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)  # no pretrained_backbones/ here
    cfg = retinanet_cfg(opts=[
        *OPTS, "SOLVER.MAX_ITER", 1, "OUTPUT_DIR", "",
        "MODEL.WEIGHTS", "detectron2://ImageNetPretrained/MSRA/R-50.pkl"])
    model = build_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    weight_convert.maybe_load_pretrained(cfg, model)
    _equal(model.state_dict(), before, "model")
    assert "not found locally" in caplog.text
    it = iter(TrainLoader(cfg, make_synthetic_dataset_dicts(
        2, seed=1, max_hw=(64, 96))))
    state = do_train(cfg, model, "cpu", loader=[next(it)])
    assert state.step == 1
    moved = model.state_dict()["student.head.cls_score.weight"]
    assert not torch.equal(moved, before["student.head.cls_score.weight"])


def test_a_swin_pickle_raises_naming_its_queue_item(tmp_path):
    """A Swin pickle, which its bias tables name, raised until the Swin-T
    trunk was ported (ROADMAP item 11); now ``maybe_load_pretrained``
    routes it through ``convert_swin_state`` into the student's trunk."""
    path = str(tmp_path / "swin.pkl")
    table = np.arange(169, dtype=np.float32).reshape(169, 1)
    with open(path, "wb") as f:
        pickle.dump({"layers.0.blocks.0.attn.relative_position_bias_table":
                     table}, f)
    stages = ["stage3", "stage4", "stage5"]
    cfg = retinanet_cfg(opts=[
        "MODEL.WEIGHTS", path,
        "MODEL.BACKBONE.NAME", "build_retinanet_swint_fpn_backbone",
        "MODEL.SWINT.EMBED_DIM", 24, "MODEL.SWINT.DEPTHS", [2, 2, 2, 2],
        "MODEL.SWINT.NUM_HEADS", [1, 2, 3, 6],
        "MODEL.SWINT.OUT_FEATURES", stages, "MODEL.FPN.IN_FEATURES", stages])
    model = build_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    weight_convert.maybe_load_pretrained(cfg, model)
    got = model.state_dict()[
        "student.bottom_up.stage2_block0.attn.relative_position_bias_table"]
    np.testing.assert_array_equal(got.numpy(), table)
