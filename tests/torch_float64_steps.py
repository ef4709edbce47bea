"""The five steps of tests/test_torch_train_step.py in one precision on both
sides, to tell float32 rounding from a port fault in the momentum buffers
that test holds loosely (``LOOSE_MOMENTA``). Not a test: the float64 run
takes about 50 s on one CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python tests/torch_float64_steps.py float64
    PYTHONPATH= JAX_PLATFORMS=cpu python tests/torch_float64_steps.py float32

Both packages name float32 in places (the teacher, the losses, the step);
in float64 mode JAX runs with x64 on, and every float32 that either
package names at run time (``jnp.float32``, ``torch.float32``,
``Tensor.float``) becomes float64, without editing either package. After
each of steps 0-3 it prints, for the loose buffers and for the others, the
largest difference from JAX relative to the buffer's largest magnitude.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
MODE = sys.argv[1] if len(sys.argv) > 1 else "float64"
if MODE not in ("float32", "float64"):
    sys.exit(f"usage: {sys.argv[0]} float32|float64")
if MODE == "float64":
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)

import test_torch_train_step as T  # noqa: E402
from torch_parity import (random_weights, retinanet_cfg,  # noqa: E402
                          torch_instances, unflatten, variable_shapes)

import lgd_tpu.engine.train_step as jstep_mod  # noqa: E402
import lgd_tpu.models.distillator as jdist  # noqa: E402
from lgd_tpu.data import make_synthetic_batch  # noqa: E402
from lgd_tpu.solver.optim import build_solver  # noqa: E402
from lgd_tpu_torch.engine import train_step as tstep  # noqa: E402
from lgd_tpu_torch.models.distillator import build_model  # noqa: E402
from lgd_tpu_torch.utils.param_bridge import load_flax_weights  # noqa: E402


def run():
    """(JAX, port) momenta and metrics after each step, as the test's
    fixture makes them, in MODE."""
    jdt, tdt = (jnp.float64, torch.float64) if MODE == "float64" else (
        jnp.float32, torch.float32)
    cfg = retinanet_cfg(opts=T.OPTS)
    jm = jdist.build_model(cfg, dtype=jdt)
    flat = {k: np.asarray(v).astype(MODE) if np.asarray(v).dtype.kind == "f"
            else v for k, v in random_weights(variable_shapes(jm),
                                              seed=11).items()}
    batch = dict(make_synthetic_batch(batch_size=2, canvas_hw=(128, 128),
                                      max_instances=8, seed=4))
    batch["image"] = jnp.asarray(batch["image"], jdt)
    _, train_step = jstep_mod.make_train_step(cfg, jm)
    params, dist = unflatten(flat)["params"], cfg.MODEL.DISTILLATOR

    def solver(node):
        return build_solver(node.SOLVER, cfg.SOLVER.CLIP_GRADIENTS,
                            cfg.SOLVER.MAX_ITER)

    state = jstep_mod.TrainState(
        params=params, frozen=unflatten(flat)["frozen"],
        stu_opt=solver(dist.STUDENT).init(
            {"student": params["student"], "adapter": params["adapter"]}),
        tea_opt=solver(dist.TEACHER).init({"teacher": params["teacher"]}),
        step=jnp.zeros((), jnp.int32),
        loss_normalizer=jnp.asarray(100.0, jdt))
    jstep = jax.jit(train_step)
    jax_runs = []
    for _ in range(T.STEPS):
        state, metrics = jstep(state, batch)
        jax_runs.append(({**T._jax_momenta(state.stu_opt),
                          **T._jax_momenta(state.tea_opt)},
                         {k: float(v) for k, v in metrics.items()}))
    tm = load_flax_weights(build_model(cfg, dtype=tdt, device="cpu"),
                           flat).to(tdt)
    gt = torch_instances(batch["gt"])
    gt.boxes = gt.boxes.to(tdt)
    tbatch = {"image": torch.from_numpy(np.asarray(batch["image"]))
              .permute(0, 3, 1, 2).to(tdt),
              "image_size": torch.from_numpy(np.asarray(batch["image_size"])),
              "gt": gt}
    t_init, t_step = tstep.make_train_step(cfg, tm)
    tstate = t_init()
    torch_runs = []
    for _ in range(T.STEPS):
        tstate, metrics = t_step(tstate, tbatch)
        torch_runs.append(({**tstate.stu_opt["momentum"],
                            **tstate.tea_opt["momentum"]},
                           {k: float(v) for k, v in metrics.items()}))
    return jax_runs, torch_runs


def report(jax_runs, torch_runs):
    for step in range(T.LARGE_RATE_FROM + 1):
        (jmom, jmet), (tmom, tmet) = jax_runs[step], torch_runs[step]
        worst = {True: (0.0, ""), False: (0.0, "")}
        for key, want in jmom.items():
            got = T._to_flax_layout(key, tmom[T._torch_name(key)].detach())
            want = np.asarray(want)
            rel = float(np.abs(got - want).max()
                        / max(np.abs(want).max(), 1e-12))
            loose = key.startswith(T.LOOSE_MOMENTA)
            worst[loose] = max(worst[loose], (rel, key))
        loss = max(abs(tmet[k] - jmet[k]) / max(abs(jmet[k]), 1e-30)
                   for k in T.LOSSES)
        print(f"{MODE} step {step}: LOOSE_MOMENTA worst {worst[True][0]:.3e} "
              f"({worst[True][1]}); other buffers worst {worst[False][0]:.3e} "
              f"({worst[False][1]}); losses {loss:.2e} relative", flush=True)


if __name__ == "__main__":
    t0 = time.time()
    report(*run())
    print(f"{MODE}: {time.time() - t0:.1f} s", flush=True)
