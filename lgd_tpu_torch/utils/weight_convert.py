"""Pretrained backbone import (port of lgd_tpu/utils/weight_convert.py):
a detectron2 pickle, or a torch file of a ResNet or a Swin, into the
student's ``bottom_up``.

The cold start of DetectionCheckpointer (reference train.py:159-161
loading ``detectron2://ImageNetPretrained/MSRA/R-50.pkl``). It reads:

- detectron2 pickles, ``{"model": {name: ndarray}}`` or the flat dict,
  with detectron2 names (``backbone.bottom_up.res2.0.conv1.weight``) or
  Caffe2 names (``res2_0_branch2a_w``), as the MSRA ImageNet files have;
- torch files of such a dict (``{"model": ...}``, ``{"state_dict": ...}``
  or flat);
- torch files of an official or timm Swin (routed by their
  ``relative_position_bias_table``), ``convert_swin_state``.

A ResNet's names are mapped as the JAX converter maps them onto its module tree
(``res2_0/conv1/kernel``, ``res2_0/conv1_norm/scale``, ...), and each of
those onto the port's state_dict by the param bridge's own key rule
(``student.bottom_up.res2_0.conv1.weight``). Convolution weights stay OIHW,
which is the port's layout. ``detectron2://<path>`` resolves to
``pretrained_backbones/<file>``; a file that is not there leaves the
random weights, with a warning, as there is no network to fetch it from.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
from typing import Dict

import numpy as np
import torch

from .param_bridge import flatten_variables, torch_key

logger = logging.getLogger(__name__)

_BRANCH = {"branch1": "shortcut", "branch2a": "conv1",
           "branch2b": "conv2", "branch2c": "conv3"}
_STATS = {"weight": "scale", "bias": "bias", "running_mean": "mean",
          "running_var": "var"}
PREFIX = "student/bottom_up"


def _load_raw(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        model = data.get("model", data)
        return {k: np.asarray(v) for k, v in model.items()
                if isinstance(v, np.ndarray) or hasattr(v, "shape")}
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _c2_to_d2_name(k: str) -> str:
    """Caffe2 ImageNet-pkl names -> detectron2 dotted names
    (``res2_0_branch2a_bn_s`` -> ``res2.0.conv1.norm.weight``)."""
    k = re.sub(r"_bn_s$", "_bn.weight", k)
    k = re.sub(r"_bn_b$", "_bn.bias", k)
    k = re.sub(r"_bn_rm$", "_bn.running_mean", k)
    k = re.sub(r"_bn_riv$", "_bn.running_var", k)
    k = re.sub(r"_w$", ".weight", k)
    k = re.sub(r"_b$", ".bias", k)
    k = k.replace("_bn.", ".norm.")
    if k.startswith("conv1.") or k.startswith("res_conv1"):
        k = "stem." + k.replace("res_conv1", "conv1")
    for br, name in _BRANCH.items():
        k = k.replace("_" + br, "." + name)
    return re.sub(r"^res(\d)_(\d+)\.", r"res\1.\2.", k)


def convert_resnet_state(raw: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """A detectron2 or Caffe2 ResNet dict -> {"params": {...}, "frozen":
    {...}}, each flat and keyed by the port's state_dict names
    (``student.bottom_up.res2_0.conv1.weight``,
    ``student.bottom_up.res2_0.conv1_norm.scale``), float32, convolutions
    OIHW. Tensors of no ResNet module (the classifier) are left out."""
    params, frozen = {}, {}
    for k, v in raw.items():
        if k.startswith(("fc", "linear")):
            continue
        if "." not in k:
            k = _c2_to_d2_name(k)
        parts = k.replace("backbone.bottom_up.", "").split(".")
        if parts[0] == "stem" and len(parts) >= 2:
            prefix, conv_name, tail = [], "stem_conv1", parts[2:]
        elif parts[0].startswith("res") and len(parts) >= 3:
            prefix = [f"{parts[0]}_{parts[1]}"]
            conv_name, tail = parts[2], parts[3:]
        else:
            continue
        v = np.asarray(v, np.float32)
        if conv_name.endswith("_offset"):
            # DCNv2 offset/mask predictor (res{s}.{b}.conv2_offset) ->
            # res{s}_{b}/conv2/offset_conv
            path = prefix + [conv_name[:-len("_offset")], "offset_conv"]
            if tail and tail[0] == "weight" and v.ndim == 4:
                params["/".join(path + ["kernel"])] = v
            elif tail and tail[0] == "bias":
                params["/".join(path + ["bias"])] = v
        elif tail and tail[0] == "norm" and len(tail) >= 2:
            frozen["/".join(prefix + [f"{conv_name}_norm",
                                      _STATS[tail[1]]])] = v
        elif tail and tail[0] == "weight" and v.ndim == 4:
            params["/".join(prefix + [conv_name, "kernel"])] = v
    return {coll: {torch_key(f"{coll}/{PREFIX}/{k}"): v
                   for k, v in flatten_variables(tree).items()}
            for coll, tree in (("params", params), ("frozen", frozen))}


def convert_swin_state(raw: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """An official or timm Swin state dict (the reference's
    ``swin_tiny_patch4_window7_224_converted.pth``) -> {"params": {...},
    "frozen": {}}, keyed by the port's state_dict names
    (``student.bottom_up.stage2_block0.attn.qkv.weight``), float32
    (JAX lgd_tpu/utils/weight_convert.py:129-188). The layouts are torch's
    on both sides: linear weights (out, in), the patch embed OIHW, the
    position embedding (1, C, H, W). Buffers (``relative_position_index``,
    ``attn_mask``) and the classifier are left out."""
    params = {}

    def put(name, v):
        params["student.bottom_up." + name] = np.asarray(v, np.float32)

    for k, v in raw.items():
        parts = k.replace("backbone.", "").split(".")
        if parts[0] == "absolute_pos_embed":
            put("absolute_pos_embed", v)
        elif parts[0] == "patch_embed" and len(parts) == 3:
            put(f"{'patch_embed' if parts[1] == 'proj' else 'patch_norm'}."
                f"{parts[2]}", v)
        elif parts[0] == "layers" and parts[2] == "blocks":
            blk = f"stage{int(parts[1]) + 2}_block{parts[3]}"
            rest = parts[4:]
            if rest[0] in ("norm1", "norm2"):
                put(f"{blk}.{rest[0]}.{rest[1]}", v)
            elif rest[0] == "attn" and rest[1] in (
                    "relative_position_bias_table", "qkv", "proj"):
                put(".".join([blk, *rest]), v)
            elif rest[0] == "mlp":
                put(f"{blk}.mlp_{rest[1]}.{rest[2]}", v)
        elif parts[0] == "layers" and parts[2] == "downsample":
            put(f"stage{int(parts[1]) + 2}_downsample.{parts[3]}.{parts[4]}",
                v)
        elif parts[0].startswith("norm") and len(parts[0]) > 4:
            # the out-feature norms: norm0..norm3 -> stage2_norm..stage5_norm
            put(f"stage{int(parts[0][4:]) + 2}_norm.{parts[1]}", v)
    return {"params": params, "frozen": {}}


def _merge_into(model: torch.nn.Module, tensors: Dict[str, np.ndarray]):
    """Copy each tensor whose name and shape the model has; returns
    (copied, unmatched), a shape mismatch warned and counted as unmatched."""
    target = model.state_dict()
    n_ok = n_miss = 0
    for name, v in tensors.items():
        if name not in target:
            n_miss += 1
            logger.debug("no target for %s", name)
        elif tuple(target[name].shape) != tuple(v.shape):
            n_miss += 1
            logger.warning("shape mismatch for %s: %s vs %s", name,
                           tuple(target[name].shape), tuple(v.shape))
        else:
            with torch.no_grad():
                target[name].copy_(torch.from_numpy(v))
            n_ok += 1
    return n_ok, n_miss


def is_backbone_file(path: str) -> bool:
    """MODEL.WEIGHTS names a backbone to import (a cold start), not weights
    of the whole model."""
    return path.startswith("detectron2://") or path.endswith(".pkl")


def maybe_load_pretrained(cfg, model: torch.nn.Module) -> torch.nn.Module:
    """cfg.MODEL.WEIGHTS into the student's bottom_up parameters and
    FrozenBN buffers, in place, when the file is there; otherwise the model
    keeps its random weights."""
    if not cfg.MODEL.WEIGHTS:
        return model
    path = cfg.MODEL.WEIGHTS
    if path.startswith("detectron2://"):
        path = os.path.join("pretrained_backbones", path.split("/")[-1])
    if not os.path.exists(path):
        logger.warning("Pretrained weights %s not found locally (no network "
                       "egress); training from random init.",
                       cfg.MODEL.WEIGHTS)
        return model
    raw = _load_raw(path)
    is_swin = any("relative_position_bias_table" in k for k in raw)
    conv = convert_swin_state(raw) if is_swin else convert_resnet_state(raw)
    ok_p, miss_p = _merge_into(model, conv["params"])
    ok_f, miss_f = _merge_into(model, conv["frozen"])
    logger.info("Loaded pretrained: %d param tensors, %d frozen stats "
                "(%d unmatched)", ok_p, ok_f, miss_p + miss_f)
    return model
