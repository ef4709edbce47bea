"""The LGD train step of the port against the JAX package at a small size
(R-18, a 64-channel FPN, an 8-head teacher with the context box,
MAX_INSTANCES 8, a 128x128 canvas, batch 2, float32): ``train_forward``,
three optimizer steps across the backbone pre-freeze and the distill-flag
boundaries at a small learning rate, two more at the reference rate, the
training batches, the config tree, and the command line.

Tolerances, float32 on both sides with sums in other orders: losses and the
normalizer within 1e-4 relative; after each step every parameter within
1e-5 of its tensor's largest magnitude and every momentum buffer (the
clipped gradients so far) within 1e-4 of its largest magnitude, except the
buffers of ``LOOSE_MOMENTA``, held at 5e-3. Those gradients pass ReLUs
whose inputs lie within about 1e-5 of zero at these random weights (a few
elements of the teacher's refine_1 and of the head's box subnet), so float32
rounding in either package decides those signs and with them about 1e-3 of
the gradient; the key projection's bias has a zero gradient in exact
arithmetic (softmax ignores a shift shared by every key), so its buffer
holds rounding noise. Shown by ``tests/torch_float64_steps.py``, which runs
these steps with both packages in float64 (JAX with x64): after steps 0-3
the loose buffers then agree within 4.2e-14, 3.2e-10, 7.4e-8 and 5.6e-8 of
their largest magnitudes (in float32 the same script reads 2.0e-3, 9.4e-4,
4.0e-3 and 2.7e-3), so the gap is float32 rounding, not a fault of the
port. The first three steps run at 2e-4 so that they stay
near the random start; steps 3 and 4 run at 0.01, where the box loss of
both packages goes up by nine orders of magnitude in two steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_model,
    random_weights,
    retinanet_cfg,
    torch_instances,
    unflatten,
    variable_shapes,
)

from lgd_tpu.data import make_synthetic_batch
from lgd_tpu.engine.train_step import TrainState
from lgd_tpu.engine.train_step import make_train_step as jax_make_train_step
from lgd_tpu.solver.optim import build_solver
from lgd_tpu_torch.engine import train_step as tstep
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.utils.param_bridge import flatten_variables, load_flax_weights

LOSSES = ("loss_box_reg", "loss_box_reg.tea", "loss_cls", "loss_cls.tea",
          "loss_distill")
# momentum buffers held at 5e-3 (module docstring): the teacher's leaves
# before its refine_1 ReLU, the box subnet's biases, the key bias
LOOSE_MOMENTA = (
    "params/teacher/label_encoder_/", "params/teacher/canoni_proj_1D/",
    "params/teacher/student_proj_2D/", "params/teacher/multi_head_attn/",
    "params/teacher/local_inst_proj_", "params/teacher/global_ctx_proj_1D/",
    "params/teacher/refine_1/",
    *(f"params/student/head/bbox_subnet_{i}/bias" for i in range(4)))
STEPS = 5
LARGE_RATE_FROM = 3  # steps 3 and 4 run at the reference rate, 0.01
OPTS = ["MODEL.FPN.OUT_CHANNELS", 64,
        "TPU.MAX_INSTANCES", 8,
        "MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0,
        "MODEL.DISTILLATOR.PRE_FREEZE_STUDENT_BACKBONE_ITERS", 1,
        "MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS", 2,
        "SOLVER.MAX_ITER", 100,
        "SOLVER.CLIP_GRADIENTS.ENABLED", True]
for _who in ("STUDENT", "TEACHER"):
    _node = f"MODEL.DISTILLATOR.{_who}.SOLVER."
    OPTS += [_node + "LR_SCHEDULER_NAME", "WarmupMultiStepLR",
             _node + "BASE_LR", 2e-4, _node + "STEPS", (LARGE_RATE_FROM,),
             _node + "GAMMA", 50.0, _node + "WARMUP_FACTOR", 1e-3,
             _node + "WARMUP_ITERS", 2, _node + "WARMUP_METHOD", "linear"]


def _jax_momenta(opt_state):
    return {"/".join(["params", *k.split("/")]): v for k, v in
            flatten_variables(opt_state["momentum"]).items()}


@pytest.fixture(scope="module")
def runs():
    """STEPS steps of both packages from the same weights and batch, in
    one JAX compile (the rate is a function of the step)."""
    cfg = retinanet_cfg(opts=OPTS)
    jm = jax_model(cfg)
    flat = random_weights(variable_shapes(jm), seed=11)
    batch = make_synthetic_batch(batch_size=2, canvas_hw=(128, 128),
                                 max_instances=8, seed=4)

    _, train_step = jax_make_train_step(cfg, jm)
    # the JAX initial state, built on the shared weights (its optimizer
    # states start at zero, as init_state makes them)
    params, dist = unflatten(flat)["params"], cfg.MODEL.DISTILLATOR
    solver = lambda node: build_solver(node.SOLVER, cfg.SOLVER.CLIP_GRADIENTS,
                                       cfg.SOLVER.MAX_ITER)
    state = TrainState(
        params=params, frozen=unflatten(flat)["frozen"],
        stu_opt=solver(dist.STUDENT).init(
            {"student": params["student"], "adapter": params["adapter"]}),
        tea_opt=solver(dist.TEACHER).init({"teacher": params["teacher"]}),
        step=jnp.zeros((), jnp.int32),
        loss_normalizer=jnp.asarray(100.0, jnp.float32))
    jstep = jax.jit(train_step)
    jax_runs = []
    for _ in range(STEPS):
        state, metrics = jstep(state, batch)
        jax_runs.append((
            {k: float(v) for k, v in metrics.items()},
            float(state.loss_normalizer),
            flatten_variables({"params": state.params}),
            {**_jax_momenta(state.stu_opt), **_jax_momenta(state.tea_opt)}))

    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    tbatch = {"image": torch.from_numpy(np.asarray(batch["image"]))
              .permute(0, 3, 1, 2),
              "image_size": torch.from_numpy(np.asarray(batch["image_size"])),
              "gt": torch_instances(batch["gt"])}
    with torch.no_grad():
        forward = tm.train_forward(tbatch["image"], tbatch["image_size"],
                                   tbatch["gt"], 0.0, torch.tensor(100.0))
    t_init, t_step = tstep.make_train_step(cfg, tm)
    tstate = t_init()
    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    torch_runs = []
    for _ in range(STEPS):
        tstate, metrics = t_step(tstate, tbatch)
        torch_runs.append((
            {k: float(v) for k, v in metrics.items()},
            float(tstate.loss_normalizer),
            {k: v.clone() for k, v in tm.state_dict().items()},
            {**tstate.stu_opt["momentum"], **tstate.tea_opt["momentum"]}))
    return cfg, forward, initial, jax_runs, torch_runs


def _torch_name(flax_key):
    from lgd_tpu_torch.utils.param_bridge import torch_key

    return torch_key(flax_key)


def _to_flax_layout(key, t):
    a = t.numpy()
    if key.endswith("/kernel"):
        a = a.transpose({4: (2, 3, 1, 0), 2: (1, 0)}[a.ndim])
    return a


def test_train_forward_matches_jax(runs):
    """The five losses and the normalizer of ``train_forward`` at the
    initial weights (distillation off) against the JAX step's first
    metrics, which are JAX ``train_forward``'s outputs."""
    _, (losses, norm), _, jax_runs, _ = runs
    want, want_norm = jax_runs[0][0], jax_runs[0][1]
    assert sorted(losses) == list(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(float(losses[k]), want[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)


def _check_losses(step, jm, jn, tm, tn):
    for k in (*LOSSES, "total_loss", "stu_lr", "tea_lr"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4,
                                   err_msg=f"step {step} {k}")
    np.testing.assert_allclose(tn, jn, rtol=1e-6)


def _check_state(step, jp, jmom, tp, tmom):
    """Parameters and momentum buffers after ``step``."""
    for key, want in jp.items():
        got = _to_flax_layout(key, tp[_torch_name(key)])
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
            err_msg=f"step {step} {key}")
    assert len(jmom) == len(tmom)
    for key, want in jmom.items():
        got = _to_flax_layout(key, tmom[_torch_name(key)])
        want = np.asarray(want)
        tol = 5e-3 if key.startswith(LOOSE_MOMENTA) else 1e-4
        np.testing.assert_allclose(
            got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-12),
            err_msg=f"step {step} momentum {key}")


def test_three_steps_match_jax(runs):
    """Losses of each of the first three steps (at 2e-4), then the
    parameters and momenta after it."""
    _, _, _, jax_runs, torch_runs = runs
    for step in range(LARGE_RATE_FROM):
        jm, jn, jp, jmom = jax_runs[step]
        tm, tn, tp, tmom = torch_runs[step]
        assert tm["distill_flag"] == jm["distill_flag"] == float(step >= 2)
        _check_losses(step, jm, jn, tm, tn)
        _check_state(step, jp, jmom, tp, tmom)


def test_reference_rate_steps_match_jax(runs):
    """Steps 3 and 4 at the reference rate, 0.01, with value clipping:
    both packages send the box loss from about 3 to about 1e9, and their
    losses agree at both steps. The state is compared after step 3 only:
    step 4's gradients come from losses near 1e10, whose float32 sums keep
    too few digits for the 1e-5 parameter limit."""
    _, _, _, jax_runs, torch_runs = runs
    for step in range(LARGE_RATE_FROM, STEPS):
        jm, jn, _, _ = jax_runs[step]
        tm, tn, _, _ = torch_runs[step]
        assert tm["stu_lr"] == pytest.approx(0.01)
        _check_losses(step, jm, jn, tm, tn)
    before = jax_runs[LARGE_RATE_FROM - 1][0]["loss_box_reg"]
    assert jax_runs[-1][0]["loss_box_reg"] > 1e6 * before
    assert torch_runs[-1][0]["loss_box_reg"] > 1e6 * before
    _, _, jp, jmom = jax_runs[LARGE_RATE_FROM]
    _, _, tp, tmom = torch_runs[LARGE_RATE_FROM]
    _check_state(LARGE_RATE_FROM, jp, jmom, tp, tmom)


def test_phase_gates(runs):
    """Step 0 leaves the student's bottom-up as it was (pre-freeze); from
    step 1 res3+ trains; the FREEZE_AT=2 stem and res2 never move; the
    teacher and the head move from step 0."""
    _, _, initial, _, torch_runs = runs
    params0 = torch_runs[0][2]
    params1 = torch_runs[1][2]
    moved = lambda a, b, pre: any(not torch.equal(a[k], b[k]) for k in a
                                  if k.startswith(pre))
    assert not moved(initial, params0, "student.bottom_up.")
    assert moved(initial, params0, "student.head.")
    assert moved(initial, params0, "teacher.")
    assert moved(params0, params1, "student.bottom_up.res3")
    last = torch_runs[-1][2]
    for pre in ("student.bottom_up.stem", "student.bottom_up.res2"):
        assert not moved(initial, last, pre), pre


def test_train_loader_matches_jax():
    """The same sampler order, multi-scale resize, flips and aspect
    buckets as the JAX TrainLoader for one seed."""
    from lgd_tpu.data.loader import TrainLoader as JaxLoader
    from lgd_tpu_torch.data import TrainLoader, make_synthetic_dataset_dicts

    cfg = retinanet_cfg(opts=["INPUT.MIN_SIZE_TRAIN", (64, 80, 96),
                              "INPUT.MAX_SIZE_TRAIN", 128,
                              "SOLVER.IMS_PER_BATCH", 2,
                              "TPU.MAX_INSTANCES", 8, "SEED", 3])
    dicts = make_synthetic_dataset_dicts(6, seed=2, max_hw=(96, 128))
    got, want = iter(TrainLoader(cfg, dicts)), iter(JaxLoader(cfg, dicts))
    for _ in range(4):
        a, b = next(got), next(want)
        np.testing.assert_array_equal(a["image"], np.asarray(b["image"]))
        np.testing.assert_array_equal(a["image_size"],
                                      np.asarray(b["image_size"]))
        for f in ("boxes", "classes", "valid"):
            np.testing.assert_array_equal(getattr(a["gt"], f).numpy(),
                                          np.asarray(getattr(b["gt"], f)))


def test_config_tree_matches_jax():
    """The port's own config copy: every key and value of the JAX tree,
    except MODEL.DEVICE, which defaults to the card."""
    from lgd_tpu.config import get_cfg as jax_cfg
    from lgd_tpu_torch.config import get_cfg

    ours, theirs = get_cfg(), jax_cfg()
    assert ours.MODEL.DEVICE == "cuda"
    ours.MODEL.DEVICE = theirs.MODEL.DEVICE
    assert ours.dump() == theirs.dump()


def test_cli_trains_then_evaluates_on_the_cpu(tmp_path):
    """``python -m lgd_tpu_torch.train`` without --eval-only on the in-repo
    mini config: 3 steps, then COCO evaluation with and without the
    teacher (the YAML's EVAL_TEACHER), and the final weights saved."""
    from lgd_tpu_torch import train as ttrain

    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "lgd_tpu",
                        "retinanet_R18_synthetic_mini.yaml")
    out = tmp_path / "out"
    argv = ["--config-file", yaml, "MODEL.DEVICE", "cpu",
            "SOLVER.MAX_ITER", "3", "INPUT.MIN_SIZE_TRAIN", "(64,)",
            "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(out),
            # the plain NMS's pairwise IoU grows with the square of the pool
            "MODEL.RETINANET.TOPK_CANDIDATES_TEST", "100"]
    res = ttrain.main(ttrain.default_argument_parser().parse_args(argv))
    assert np.isfinite(res["bbox"]["AP50"])
    state = torch.load(out / "model_final.pth", weights_only=True)
    assert any(k.startswith("teacher.") for k in state)
    assert (out / "inference" / "synthetic_mini" / "metrics.json").exists()
