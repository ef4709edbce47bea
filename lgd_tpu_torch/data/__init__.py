from .catalog import get_dataset_dicts
from .dataset_mapper import DatasetMapper
from .loader import TestLoader, eval_canvas_shapes, pack_batch
from .synthetic import make_synthetic_dataset_dicts

__all__ = [
    "get_dataset_dicts",
    "DatasetMapper",
    "TestLoader",
    "eval_canvas_shapes",
    "pack_batch",
    "make_synthetic_dataset_dicts",
]
