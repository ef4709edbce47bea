"""Shared set-up for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both
packages: weights as the flat ``params/...``/``frozen/...`` dict that the
JAX ``.npz`` dump uses, which the port loads through its param bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np

from lgd_tpu.config import get_cfg
from lgd_tpu.models.distillator import build_model as build_jax_model
from lgd_tpu_torch.utils.param_bridge import flatten_variables

ANCHOR_SIZES = [[x, x * 2 ** (1 / 3), x * 2 ** (2 / 3)]
                for x in [32, 64, 128, 256, 512]]


def retinanet_cfg(depth=18, opts=()):
    """DistillatorRetinaNet with 9 anchors per cell; float32 compute."""
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "DistillatorRetinaNet"
    cfg.MODEL.RESNETS.DEPTH = depth
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = ANCHOR_SIZES
    cfg.MODEL.DISTILLATOR.EVAL_TEACHER = False
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.OUTPUT_DIR = ""
    cfg.merge_from_list(list(opts))
    return cfg.freeze()


def jax_model(cfg):
    return build_jax_model(cfg, dtype=jnp.float32)


def student_shapes(model, canvas=(64, 64)):
    """Flat {key: shape} of the student's variables, traced, not computed."""
    images = jnp.zeros((1, *canvas, 3), jnp.float32)
    sizes = jnp.asarray([canvas], jnp.int32)
    tree = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), images, sizes,
                           method=model.inference))
    return {k: tuple(v.shape) for k, v in flatten_variables(tree).items()}


def random_weights(shapes, seed=0):
    """Numpy weights for every key: lecun-normal kernels, small biases, and
    FrozenBN statistics away from the identity, so every layer matters. The
    head's output convs are scaled down so that logits stay within a few
    units of 0 (saturated sigmoids would tie every score at 1.0)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in sorted(shapes.items()):
        leaf = key.rsplit("/", 1)[1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(1.0 / fan_in)
            if "cls_score" in key or "bbox_pred" in key:
                v = v * 0.02
        elif leaf in ("scale", "var"):
            v = rng.rand(*shape) + 0.5
        else:  # bias, mean
            v = rng.randn(*shape) * 0.1
        out[key] = v.astype(np.float32)
    return out


def unflatten(flat):
    """Flat ``coll/a/b/leaf`` dict -> nested variables for ``model.apply``."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree

