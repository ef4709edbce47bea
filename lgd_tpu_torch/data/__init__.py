from .catalog import DatasetCatalog, MetadataCatalog, get_dataset_dicts
from .coco import (
    filter_images_with_only_crowd_annotations,
    get_detection_dataset_dicts,
    load_coco_json,
)
from .dataset_mapper import DatasetMapper
from .loader import (
    RepeatFactorTrainingSampler,
    TestLoader,
    TrainingSampler,
    TrainLoader,
    eval_canvas_shapes,
    pack_batch,
    train_canvas_shapes,
    train_dataset_dicts,
)
from .synthetic import make_synthetic_dataset_dicts, register_synthetic

__all__ = [
    "DatasetCatalog",
    "MetadataCatalog",
    "get_dataset_dicts",
    "filter_images_with_only_crowd_annotations",
    "get_detection_dataset_dicts",
    "load_coco_json",
    "DatasetMapper",
    "RepeatFactorTrainingSampler",
    "TestLoader",
    "TrainingSampler",
    "TrainLoader",
    "eval_canvas_shapes",
    "pack_batch",
    "train_canvas_shapes",
    "train_dataset_dicts",
    "make_synthetic_dataset_dicts",
    "register_synthetic",
]
