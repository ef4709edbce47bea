"""Shared set-up for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both
packages: weights as the flat ``params/...``/``frozen/...`` dict that the
JAX ``.npz`` dump uses, which the port loads through its param bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np

import torch

from lgd_tpu.config import get_cfg
from lgd_tpu.models.distillator import build_model as build_jax_model
from lgd_tpu.structures import BatchedInstances as JaxInstances
from lgd_tpu_torch.structures import BatchedInstances
from lgd_tpu_torch.utils.param_bridge import flatten_variables

ANCHOR_SIZES = [[x, x * 2 ** (1 / 3), x * 2 ** (2 / 3)]
                for x in [32, 64, 128, 256, 512]]

# The suite runs in several worker processes on the machine's cores at
# once. Torch's default of one intra-op thread per core in each of them
# oversubscribes the cores, and its spinning threads then made a port test
# about seven times slower than with one thread while the other cores were
# busy; one thread each keeps the whole run inside its time limit.
torch.set_num_threads(1)


def retinanet_cfg(depth=18, opts=()):
    """DistillatorRetinaNet with 9 anchors per cell and the teacher's
    context box; float32 compute."""
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "DistillatorRetinaNet"
    cfg.MODEL.RESNETS.DEPTH = depth
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = ANCHOR_SIZES
    cfg.MODEL.DISTILLATOR.EVAL_TEACHER = False
    cfg.MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.OUTPUT_DIR = ""
    cfg.merge_from_list(list(opts))
    return cfg.freeze()


def jax_model(cfg):
    return build_jax_model(cfg, dtype=jnp.float32)


def variable_shapes(model, canvas=(64, 64), gt=None):
    """Flat {key: shape} of all the distillator's variables (student,
    teacher and adapter), traced, not computed. The ``sampling`` stream
    feeds an R-CNN student's samples. ``gt`` (one image on ``canvas``)
    defaults to one box without masks."""
    images = jnp.zeros((1, *canvas, 3), jnp.float32)
    sizes = jnp.asarray([canvas], jnp.int32)
    if gt is None:
        gt = JaxInstances.from_lists([np.asarray([[4.0, 4.0, 40.0, 30.0]])],
                                     [np.asarray([3])], capacity=2)
    tree = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0),
                            "sampling": jax.random.PRNGKey(1)},
                           images, sizes, gt,
                           jnp.float32(0.0), jnp.float32(100.0),
                           method=model.train_forward))
    return {k: tuple(v.shape) for k, v in flatten_variables(tree).items()}


def torch_instances(gt) -> BatchedInstances:
    """The port's container holding the same boxes, and masks where the
    JAX one has them, as a JAX one."""
    masks = (None if a is None else torch.tensor(np.asarray(a))
             for a in (gt.masks49, gt.bitmasks, gt.mask_crops))
    return BatchedInstances(torch.tensor(np.asarray(gt.boxes)),
                            torch.tensor(np.asarray(gt.classes)).long(),
                            torch.tensor(np.asarray(gt.valid)), *masks)


def random_weights(shapes, seed=0):
    """Numpy weights for every key: lecun-normal kernels, small biases, and
    FrozenBN statistics away from the identity, so every layer matters. The
    head's output convs are scaled down so that logits stay within a few
    units of 0 (saturated sigmoids would tie every score at 1.0), and the
    R-CNN RPN's likewise (deltas of several units would decode most
    proposals into empty boxes)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in sorted(shapes.items()):
        leaf = key.rsplit("/", 1)[1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(1.0 / fan_in)
            if any(name in key for name in ("cls_score", "bbox_pred",
                                            "objectness_logits",
                                            "anchor_deltas")):
                v = v * 0.02
        elif leaf in ("scale", "var"):
            v = rng.rand(*shape) + 0.5
        else:  # bias, mean
            v = rng.randn(*shape) * 0.1
        out[key] = np.asarray(v, np.float32)  # a Scale's is a 0-d array
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

