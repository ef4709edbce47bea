"""The config tree is the JAX package's own: ``lgd_tpu.config`` imports no
jax (only yaml, which the card's machine has), so the port re-exports it
and both packages read the same keys and defaults."""

from lgd_tpu.config import CN, CfgNode, get_cfg

__all__ = ["CN", "CfgNode", "get_cfg"]
