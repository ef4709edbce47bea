"""Dataset names the port can resolve. Only the in-repo synthetic split
(registered as in lgd_tpu/data/catalog.py:102-114): COCO and the other
on-disk datasets wait until their data is in the repository."""

from __future__ import annotations

from typing import Dict, List

from .synthetic import make_synthetic_dataset_dicts

_BUILTIN = {"synthetic_mini": lambda: make_synthetic_dataset_dicts(16, seed=0)}


def get_dataset_dicts(name: str) -> List[Dict]:
    if name not in _BUILTIN:
        raise KeyError(f"dataset {name!r} is not available to the port; "
                       f"have {sorted(_BUILTIN)}")
    return _BUILTIN[name]()
