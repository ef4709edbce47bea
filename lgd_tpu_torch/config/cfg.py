"""yacs-compatible hierarchical config node.

Re-implements the config surface LGD relies on (detectron2 ``CfgNode`` /
yacs) so the reference YAMLs under ``configs/**`` load
unchanged: attribute access, ``_BASE_`` inheritance, ``merge_from_file``,
``merge_from_list`` CLI overrides, ``freeze``/``defrost``/``clone``, and the
yacs literal-decoding rules (tuple/list strings, ``!!python/object/apply:eval``
tags used by ``Base-RetinaNet.yaml`` for anchor sizes).

Reference behavior: detectron2 config (see reference train.py:237-256,
reference utils/build.py:557-714).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))

BASE_KEY = "_BASE_"


class _EvalConstructorLoader(yaml.SafeLoader):
    """SafeLoader extended with the one unsafe tag the reference configs use:
    ``!!python/object/apply:eval`` (anchor-size expression in Base-RetinaNet).
    """


def _eval_constructor(loader, node):
    args = loader.construct_sequence(node)
    assert len(args) == 1, f"eval tag expects a single expression, got {args}"
    # Evaluated in an empty namespace: the reference uses a pure arithmetic
    # list comprehension (Base-RetinaNet.yaml anchor SIZES).
    return eval(args[0], {"__builtins__": {}}, {})  # noqa: S307


_EvalConstructorLoader.add_constructor(
    "tag:yaml.org,2002:python/object/apply:eval", _eval_constructor
)


class CfgNode(dict):
    """A dict subclass with attribute access and yacs merge semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            self[k] = self._to_node(v)

    @classmethod
    def _to_node(cls, v):
        if isinstance(v, dict) and not isinstance(v, CfgNode):
            return cls(v)
        return v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(f"Non-existent config key: {name}")

    def __setattr__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = self._to_node(value)

    def __setitem__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        super().__setitem__(name, self._to_node(value))

    # -- freeze ------------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)
        return self

    def defrost(self):
        self._set_immutable(False)
        return self

    def is_frozen(self):
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag):
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def _plain(self):
        """Recursive plain-dict copy (no freeze state)."""
        return {
            k: (v._plain() if isinstance(v, CfgNode) else copy.deepcopy(v))
            for k, v in self.items()
        }

    def clone(self):
        # NOTE: deepcopy of a frozen node restores IMMUTABLE before items
        # are copied and explodes; rebuild from plain dicts instead. The
        # clone is always mutable (callers freeze() when done).
        return type(self)(self._plain())

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode"):
        _merge_a_into_b(other, self, key_path=[])
        return self

    def merge_from_file(self, filename: str, allow_unsafe: bool = True):
        loaded = load_yaml_with_base(filename)
        self.merge_from_other_cfg(CfgNode(loaded))
        return self

    def merge_from_list(self, opts):
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            d = self
            parts = full_key.split(".")
            for sub in parts[:-1]:
                assert sub in d, f"Non-existent key: {full_key}"
                d = d[sub]
            sub = parts[-1]
            assert sub in d, f"Non-existent key: {full_key}"
            value = _decode_cfg_value(v)
            value = _check_and_coerce_cfg_value_type(value, d[sub], sub, full_key)
            d[sub] = value
        return self

    # -- io ----------------------------------------------------------------
    def dump(self, **kwargs):
        def _convert(node):
            if isinstance(node, CfgNode):
                return {k: _convert(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return list(node)
            return node

        return yaml.safe_dump(_convert(self), **kwargs)

    def __repr__(self):
        return f"CfgNode({super().__repr__()})"


def load_yaml_with_base(filename: str) -> dict:
    """Load a YAML file, recursively resolving ``_BASE_`` inheritance
    (relative paths are resolved against the child file's directory,
    matching detectron2 semantics)."""
    with open(filename, "r") as f:
        cfg = yaml.load(f, Loader=_EvalConstructorLoader)
    if cfg is None:
        cfg = {}

    if BASE_KEY in cfg:
        base_file = cfg.pop(BASE_KEY)
        if not os.path.isabs(base_file):
            base_file = os.path.join(os.path.dirname(filename), base_file)
        base_cfg = load_yaml_with_base(base_file)
        _merge_dict_a_into_b(cfg, base_cfg)
        return base_cfg
    return cfg


def _merge_dict_a_into_b(a: dict, b: dict):
    for k, v in a.items():
        if isinstance(v, dict) and k in b and isinstance(b[k], dict):
            _merge_dict_a_into_b(v, b[k])
        else:
            b[k] = v


def _merge_a_into_b(a: CfgNode, b: CfgNode, key_path):
    for k, v_ in a.items():
        full_key = ".".join(key_path + [k])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v = _decode_cfg_value(v_)
        v = _check_and_coerce_cfg_value_type(v, b[k], k, full_key)
        if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], key_path + [k])
        else:
            b[k] = v


def _decode_cfg_value(v):
    """yacs literal decoding: strings that parse as python literals
    (tuples like ``(60000, 80000)``, numbers, booleans) are converted."""
    if isinstance(v, dict):
        return CfgNode(v)
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce_cfg_value_type(replacement, original, key, full_key):
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None or replacement is None:
        return replacement

    # yacs casting rules: list <-> tuple, str <-> number promotions
    casts = [(tuple, list), (list, tuple), (int, float)]
    for src, dst in casts:
        if replacement_type == src and original_type == dst:
            return dst(replacement)
    if isinstance(replacement, (int, float)) and isinstance(original, (int, float)):
        return replacement
    if isinstance(original, CfgNode) and isinstance(replacement, dict):
        return CfgNode(replacement)
    raise ValueError(
        f"Type mismatch ({original_type} vs. {replacement_type}) for config "
        f"key: {full_key}; value: {replacement}"
    )


CN = CfgNode
