from .optim import (
    GatedOptimizer,
    build_lr_schedule,
    build_solver,
    warmup_cosine_lr,
    warmup_multistep_lr,
)

__all__ = [
    "GatedOptimizer",
    "build_lr_schedule",
    "build_solver",
    "warmup_cosine_lr",
    "warmup_multistep_lr",
]
