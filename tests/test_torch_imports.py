"""The PyTorch port imports no JAX: every module of lgd_tpu_torch is
imported in a fresh interpreter, which must end with neither jax nor flax
loaded (the card's machine has neither)."""

import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import lgd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lgd_tpu_torch.__path__,
                                               "lgd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 20
