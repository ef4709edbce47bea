#!/usr/bin/env python
"""LGD command line for the PyTorch port, with the JAX train.py's flags:

    python -m lgd_tpu_torch.train --config-file configs/....yaml --eval-only \
        [opts KEY VALUE ...]

Only ``--eval-only`` is ported: it evaluates MODEL.WEIGHTS, which is either
a ``.npz`` variables dump written by the JAX package (carried across by
utils/param_bridge.py) or a ``torch.save``d state_dict. With no weights the
model gets seeded random weights (SEED, or 0). It runs on the GPU when
there is one, else on the CPU; convolutions run in TPU.COMPUTE_DTYPE, as
in the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch


def default_argument_parser():
    p = argparse.ArgumentParser(description="LGD (PyTorch port)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-gpus", type=int, default=1,
                   help="accepted for reference-CLI parity; the port runs on "
                        "one device")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                   help="'KEY VALUE' config overrides")
    return p


def setup(args):
    from lgd_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if "Distillator" not in cfg.MODEL.META_ARCHITECTURE:
        cfg.MODEL.META_ARCHITECTURE = "Distillator" + cfg.MODEL.META_ARCHITECTURE
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()

    handlers = [logging.StreamHandler(sys.stdout)]
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(cfg.OUTPUT_DIR, "log.txt")))
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s]: %(message)s",
                        handlers=handlers, force=True)
    logging.getLogger(__name__).info("Running with config:\n%s", cfg.dump())
    return cfg


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """MODEL.WEIGHTS: a JAX ``.npz`` dump (teacher and adapter entries are
    dropped: inference does not use them) or a torch state_dict file."""
    from lgd_tpu_torch.utils.param_bridge import load_flax_weights

    if path.endswith(".npz"):
        with np.load(path) as raw:
            flat = {k: raw[k] for k in raw.files}
        return load_flax_weights(model, flat, ignore=("teacher", "adapter"))
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True), strict=True)
    return model


def main(args):
    from lgd_tpu_torch.engine.trainer import do_test
    from lgd_tpu_torch.models.distillator import build_model

    if not args.eval_only:
        raise NotImplementedError(
            "training comes with the train step and kernel K1b (ROADMAP.md, "
            "queue item 2); run with --eval-only")
    cfg = setup(args)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
             else torch.float32)
    if cfg.MODEL.WEIGHTS:
        model = load_weights(build_model(cfg, dtype=dtype), cfg.MODEL.WEIGHTS)
    else:
        logging.getLogger(__name__).warning(
            "MODEL.WEIGHTS is empty: evaluating seeded random weights")
        model = build_model(cfg, dtype=dtype, seed=max(cfg.SEED, 0))
    model = model.to(device)
    if cfg.MODEL.DISTILLATOR.EVAL_TEACHER:
        do_test(cfg, model, device, eval_teacher=True)  # raises: next slice
    return do_test(cfg, model, device)


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
