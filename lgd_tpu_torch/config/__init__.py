"""The port's own copy of the config tree (lgd_tpu/config/cfg.py,
defaults.py and distillator_defaults.py): the same keys and values, so the
repo's YAMLs merge unchanged, except that MODEL.DEVICE defaults to "cuda"."""

from .cfg import CN, CfgNode
from .defaults import get_cfg

__all__ = ["CN", "CfgNode", "get_cfg"]
