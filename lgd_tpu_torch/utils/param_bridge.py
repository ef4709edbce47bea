"""Carry JAX weights across to the port.

The input is a flat dict of numpy arrays keyed as the JAX package's
``.npz`` dump keys them (``save_variables_npz``,
lgd_tpu/engine/checkpoint.py:71-93): ``params/<module path>/<leaf>`` and
``frozen/<module path>/<leaf>``. The port's modules carry the flax
submodule names, so the module path maps one to one onto the state_dict
name, and only the leaves change:

- ``params/.../kernel`` (HWIO) -> ``....weight`` (OIHW, transpose(3, 2, 0, 1));
- ``params/.../bias`` -> ``....bias``;
- ``frozen/.../{scale,bias,mean,var}`` -> the FrozenBatchNorm buffers.

Every key must map, on both sides: a key left over raises.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

_FROZEN_LEAVES = ("scale", "bias", "mean", "var")


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
    """``params/student/fpn/top_p6/kernel`` -> ``student.fpn.top_p6.weight``."""
    coll, *path, leaf = flax_key.split("/")
    if coll == "params" and leaf in ("kernel", "bias"):
        leaf = "weight" if leaf == "kernel" else leaf
    elif not (coll == "frozen" and leaf in _FROZEN_LEAVES):
        raise KeyError(f"no port counterpart for {flax_key!r}")
    return ".".join(path + [leaf])


def torch_shape(flax_key: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if flax_key.endswith("/kernel") and len(shape) == 4:
        h, w, i, o = shape
        return (o, i, h, w)
    return tuple(shape)


def _to_torch(flax_key: str, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if flax_key.endswith("/kernel") and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return np.ascontiguousarray(arr)


def state_dict_from_flax(flat: Mapping[str, np.ndarray], model: torch.nn.Module,
                         ignore: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The model's full state_dict from a flat JAX variables dict.

    ``ignore`` names top-level flax modules that the dump holds and the port
    model does not (the teacher and adapter of a distillator, which
    inference throws away); their keys are dropped. Any other key without a
    counterpart, any model entry left unfilled, and any shape mismatch
    raises."""
    ignore = tuple(ignore)
    want = model.state_dict()
    out, unmapped = {}, []
    for key, arr in flat.items():
        if key.split("/")[1] in ignore:
            continue
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
        out[tk] = torch.from_numpy(_to_torch(key, arr)).to(want[tk].dtype)
    missing = sorted(set(want) - set(out))
    if unmapped or missing:
        raise ValueError(
            f"weights do not cover the model: {len(unmapped)} JAX keys "
            f"unmapped (e.g. {unmapped[:5]}), {len(missing)} model entries "
            f"missing (e.g. {missing[:5]})")
    return out


def load_flax_weights(model: torch.nn.Module, flat: Mapping[str, np.ndarray],
                      ignore: Iterable[str] = ()) -> torch.nn.Module:
    model.load_state_dict(state_dict_from_flax(flat, model, ignore),
                          strict=True)
    return model
