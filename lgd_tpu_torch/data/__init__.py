from .catalog import get_dataset_dicts
from .dataset_mapper import DatasetMapper
from .loader import (
    TestLoader,
    TrainingSampler,
    TrainLoader,
    eval_canvas_shapes,
    pack_batch,
    train_canvas_shapes,
    train_dataset_dicts,
)
from .synthetic import make_synthetic_dataset_dicts

__all__ = [
    "get_dataset_dicts",
    "DatasetMapper",
    "TestLoader",
    "TrainingSampler",
    "TrainLoader",
    "eval_canvas_shapes",
    "pack_batch",
    "train_canvas_shapes",
    "train_dataset_dicts",
    "make_synthetic_dataset_dicts",
]
