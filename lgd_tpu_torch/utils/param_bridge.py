"""Carry JAX weights across to the port.

The input is a flat dict of numpy arrays keyed as the JAX package's
``.npz`` dump keys them (``save_variables_npz``,
lgd_tpu/engine/checkpoint.py:71-93): ``params/<module path>/<leaf>`` and
``frozen/<module path>/<leaf>``. The port's modules carry the flax
submodule names, so the module path maps one to one onto the state_dict
name, and only the leaves change:

- ``params/.../kernel`` of a convolution (HWIO) -> ``....weight`` (OIHW,
  transpose(3, 2, 0, 1));
- ``params/.../kernel`` of a Dense layer (in, out) -> ``....weight`` of an
  ``nn.Linear`` (out, in);
- ``params/.../bias`` -> ``....bias``;
- ``params/.../scale`` of a GroupNorm (C,) or of a ``Scale`` (a 0-d
  array) -> ``....scale``;
- ``frozen/.../{scale,bias,mean,var}`` -> the FrozenBatchNorm buffers.

The Swin trunk's leaves:

- ``params/.../scale`` of a LayerNorm (``norm1``, ``norm2``, ``norm``,
  ``patch_norm``, ``stage<s>_norm``) -> ``....weight``;
- the Dense kernels (``qkv``, ``proj``, ``mlp_fc1``, ``mlp_fc2``,
  ``reduction``) transposed as above, the patch embed's HWIO kernel to
  OIHW;
- ``relative_position_bias_table`` as it is;
- ``absolute_pos_embed`` (1, H, W, C) -> the port's (1, C, H, W).

A transposed convolution's kernel, the Mask R-CNN head's ``deconv``
(flax ``nn.ConvTranspose``, (kh, kw, in, out)), goes to torch's (in, out,
kh, kw) flipped in both spatial axes: flax's transpose_kernel=False
convolves the dilated input with the kernel as it stands, torch's with it
flipped.

One weight also changes the order of its rows: the R-CNN box head's
``fc1``. The flax head flattens its pooled (R, R, C) features; the port's
ROIAlign writes (C, R, R), so the rows of ``box_head/fc1/kernel`` are
reordered from (R, R, C) to (C, R, R) by the head's ``pooled_shape``.

The student, the teacher and the adapter all map. Every key must map, on
both sides: a key left over raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_FROZEN_LEAVES = ("scale", "bias", "mean", "var")
_AS_IS_LEAVES = ("relative_position_bias_table", "absolute_pos_embed")
_LAYER_NORM = re.compile(r"^(norm\d?|patch_norm|stage\d_norm)$")


def flatten_variables(variables: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested {collection: {module: ... {leaf: array}}} -> flat dict keyed
    like the ``.npz`` dump."""
    out = {}
    for k, v in variables.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_variables(v, name))
        else:
            out[name] = v
    return out


def torch_key(flax_key: str) -> str:
    """``params/student/fpn/top_p6/kernel`` -> ``student.fpn.top_p6.weight``;
    a ResNet norm's GroupNorm, flax's ``<norm>/GroupNorm_0``, is the port's
    ``<norm>`` itself; a LayerNorm's ``scale`` is its ``weight``."""
    coll, *path, leaf = flax_key.split("/")
    if coll == "params" and leaf in ("kernel", "bias", "scale",
                                     *_AS_IS_LEAVES):
        if leaf == "kernel" or (leaf == "scale" and path
                                and _LAYER_NORM.match(path[-1])):
            leaf = "weight"
    elif not (coll == "frozen" and leaf in _FROZEN_LEAVES):
        raise KeyError(f"no port counterpart for {flax_key!r}")
    return ".".join([p for p in path if p != "GroupNorm_0"] + [leaf])


def _transposed_conv(flax_key: str) -> bool:
    return flax_key.endswith("/deconv/kernel")


def _kernel_axes(flax_key: str, ndim: int):
    """The transpose that takes a flax kernel to the torch weight."""
    if _transposed_conv(flax_key) and ndim == 4:
        return (2, 3, 0, 1)
    if flax_key.endswith("/absolute_pos_embed"):
        return (0, 3, 1, 2)
    if flax_key.endswith("/kernel"):
        return {4: (3, 2, 0, 1), 2: (1, 0)}.get(ndim)
    return None


def torch_shape(flax_key: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    axes = _kernel_axes(flax_key, len(shape))
    return tuple(shape[a] for a in axes) if axes else tuple(shape)


def _to_torch(flax_key: str, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if _transposed_conv(flax_key):
        arr = arr[::-1, ::-1]
    axes = _kernel_axes(flax_key, arr.ndim)
    return np.ascontiguousarray(arr.transpose(axes) if axes else arr)


def _pooled_shape(flax_key: str, model: torch.nn.Module):
    """(C, R, R) of the box head whose ``fc1`` this key names, else None."""
    if not flax_key.endswith("/box_head/fc1/kernel"):
        return None
    head = model.get_submodule(torch_key(flax_key)[:-len(".fc1.weight")])
    return head.pooled_shape


def _to_torch_model(flax_key: str, arr: np.ndarray,
                    model: torch.nn.Module) -> np.ndarray:
    shape = _pooled_shape(flax_key, model)
    if shape is not None:
        c, h, w = shape
        arr = (np.asarray(arr).reshape(h, w, c, -1).transpose(2, 0, 1, 3)
               .reshape(c * h * w, -1))
    return _to_torch(flax_key, arr)


def flax_array(flax_key: str, value: np.ndarray,
               model: torch.nn.Module) -> np.ndarray:
    """A port tensor's value (as numpy) in the flax layout of ``flax_key``:
    the inverse of the mapping above, for comparing with the JAX
    package."""
    arr = np.asarray(value)
    axes = _kernel_axes(flax_key, arr.ndim)
    if axes:  # argsort inverts the permutation
        arr = arr.transpose(np.argsort(axes))
    if _transposed_conv(flax_key):
        arr = arr[::-1, ::-1]
    shape = _pooled_shape(flax_key, model)
    if shape is not None:
        c, h, w = shape
        arr = arr.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(
            c * h * w, -1)
    return np.ascontiguousarray(arr)


def state_dict_from_flax(flat: Mapping[str, np.ndarray],
                         model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full state_dict from a flat JAX variables dict. A key
    without a counterpart, a model entry left unfilled, and a shape mismatch
    all raise."""
    want = model.state_dict()
    out, unmapped = {}, []
    for key, arr in flat.items():
        try:
            tk = torch_key(key)
        except KeyError:
            unmapped.append(key)
            continue
        if tk not in want:
            unmapped.append(key)
            continue
        if tk in out:
            raise ValueError(f"two JAX keys map onto {tk!r}")
        shape = torch_shape(key, np.shape(arr))
        if tuple(want[tk].shape) != shape:
            raise ValueError(f"shape mismatch for {key} -> {tk}: {shape} vs "
                             f"{tuple(want[tk].shape)}")
        out[tk] = torch.from_numpy(_to_torch_model(key, arr, model)).to(
            want[tk].dtype)
    missing = sorted(set(want) - set(out))
    if unmapped or missing:
        raise ValueError(
            f"weights do not cover the model: {len(unmapped)} JAX keys "
            f"unmapped (e.g. {unmapped[:5]}), {len(missing)} model entries "
            f"missing (e.g. {missing[:5]})")
    return out


def load_flax_weights(model: torch.nn.Module,
                      flat: Mapping[str, np.ndarray]) -> torch.nn.Module:
    model.load_state_dict(state_dict_from_flax(flat, model), strict=True)
    return model
