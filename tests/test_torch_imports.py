"""The PyTorch port imports no JAX and nothing of the JAX package: every
module of lgd_tpu_torch and chip_smoke.py are imported in a fresh
interpreter, which must end with none of jax, jaxlib, flax, lgd_tpu or
lgd_tpu.* loaded (the card's machine has no JAX, and the port keeps its own
copies of what it needs)."""

import os
import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import lgd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lgd_tpu_torch.__path__,
                                               "lgd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "lgd_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, check=True, cwd=root)
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 20
