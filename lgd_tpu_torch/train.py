#!/usr/bin/env python
"""LGD command line for the PyTorch port, with the JAX train.py's flags:

    python -m lgd_tpu_torch.train --config-file configs/....yaml \
        [--resume] [--eval-only] [opts KEY VALUE ...]

Without ``--eval-only`` it trains SOLVER.MAX_ITER steps (``do_train``),
then evaluates the student and, with MODEL.DISTILLATOR.EVAL_TEACHER, the
teacher's features through the student's head. With OUTPUT_DIR set, a run
writes ``log.txt``, ``config.yaml``, ``metrics.json``, a checkpoint every
SOLVER.CHECKPOINT_PERIOD iterations and at the last under
``checkpoints/``, and ``model_final.pth`` there; ``--resume`` continues
from the latest checkpoint of OUTPUT_DIR. MODEL.WEIGHTS, in training: a
detectron2 backbone pickle (``.pkl`` or ``detectron2://...``, resolved
under ``pretrained_backbones/``) is a cold start of the student's
backbone (utils/weight_convert.py); a ``.npz`` variables dump written by
the JAX package (student, teacher and adapter, carried across by
utils/param_bridge.py) or a ``torch.save``d state_dict of the whole model
is loaded whole. With no weights the model gets seeded random weights
(SEED, or 0). ``--eval-only`` evaluates the latest checkpoint of
OUTPUT_DIR when there is one, else MODEL.WEIGHTS: a run directory, a
``.npz`` or a state_dict whole, a backbone pickle into the backbone. It
runs on MODEL.DEVICE, the card by default (``MODEL.DEVICE cpu`` for the
CPU); convolutions of the student run in TPU.COMPUTE_DTYPE, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

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
    """MODEL.WEIGHTS of the whole model: a run directory, a JAX ``.npz``
    dump or a torch state_dict file; every entry must map onto the
    model."""
    from lgd_tpu_torch.engine.checkpoint import load_weights as load

    load(path, model)
    return model


def main(args, loader=None):
    """Runs the command; ``loader``, when given, feeds ``do_train`` in place
    of the TrainLoader of DATASETS.TRAIN (a script's fixed batches)."""
    from lgd_tpu_torch.engine.checkpoint import Checkpointer
    from lgd_tpu_torch.engine.trainer import do_test, do_train
    from lgd_tpu_torch.models.distillator import build_model
    from lgd_tpu_torch.utils.weight_convert import (
        is_backbone_file,
        maybe_load_pretrained,
    )

    cfg = setup(args)
    log = logging.getLogger(__name__)
    device = torch.device(cfg.MODEL.DEVICE)
    dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
             else torch.float32)
    weights = cfg.MODEL.WEIGHTS
    ckpt = Checkpointer(cfg.OUTPUT_DIR) if cfg.OUTPUT_DIR else None
    if args.eval_only and ckpt is not None and ckpt.latest_step() is not None:
        whole = ckpt.dir  # the latest checkpoint of this run
    elif weights and not is_backbone_file(weights):
        whole = weights
    else:
        whole = None
    if whole is not None:
        model = load_weights(build_model(cfg, dtype=dtype, device=device),
                             whole)
    else:
        if not weights:
            log.warning("MODEL.WEIGHTS is empty: starting from seeded random "
                        "weights")
        model = build_model(cfg, dtype=dtype, device=device,
                            seed=max(cfg.SEED, 0))
        if args.eval_only:  # in training, do_train's cold start
            maybe_load_pretrained(cfg, model)
    if not args.eval_only:
        do_train(cfg, model, device, resume=args.resume, loader=loader)
    if cfg.MODEL.DISTILLATOR.EVAL_TEACHER:
        log.info("Evaluating the teacher")
        do_test(cfg, model, device, eval_teacher=True)
    return do_test(cfg, model, device)


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
