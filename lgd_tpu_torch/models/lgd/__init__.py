from .adapters import ADAPTERS, SequentialConvs, build_adapter
from .dynamic_teacher import DynamicTeacher, MultiHeadAttention, inside_gt_masks
from .label_encoder import STN, LabelEncoder, TokenMLP, encode_descriptors

__all__ = [
    "ADAPTERS",
    "SequentialConvs",
    "build_adapter",
    "DynamicTeacher",
    "MultiHeadAttention",
    "inside_gt_masks",
    "STN",
    "LabelEncoder",
    "TokenMLP",
    "encode_descriptors",
]
