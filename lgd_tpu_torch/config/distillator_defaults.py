"""The LGD distillator / FCOS / POTO / ATSS / SwinT config tree.

Key-for-key port of the *config surface* of ``build_distillator_configs``
(reference utils/build.py:557-714) so the reference distillation YAMLs
merge unchanged. Values are defaults only; behavior is implemented in
the model modules.
"""

from .cfg import CfgNode as CN


def build_distillator_configs(cfg: CN) -> CN:
    cfg.NUM_CLASSES = 80
    cfg.MODEL.DISTILLATOR = CN()

    def _solver():
        s = CN()
        s.OPTIMIZER = "SGD"
        s.BASE_LR = 0.02
        s.MOMENTUM = 0.9
        s.WEIGHT_DECAY = 1e-4
        s.LR_SCHEDULER_NAME = None
        s.STEPS = None
        s.GAMMA = None
        s.WARMUP_FACTOR = None
        s.WARMUP_ITERS = None
        s.WARMUP_METHOD = None
        s.AMP = CN()
        s.AMP.ENABLED = False
        return s

    cfg.MODEL.DISTILLATOR.STUDENT = CN()
    cfg.MODEL.DISTILLATOR.STUDENT.SOLVER = _solver()
    cfg.MODEL.DISTILLATOR.STUDENT.META_ARCH = None

    cfg.MODEL.DISTILLATOR.TEACHER = CN()
    cfg.MODEL.DISTILLATOR.TEACHER.SOLVER = _solver()
    cfg.MODEL.DISTILLATOR.TEACHER.META_ARCH = None

    cfg.MODEL.DISTILLATOR.ADAPTER = CN()
    cfg.MODEL.DISTILLATOR.ADAPTER.META_ARCH = "SequentialConvs"

    # Distill phase schedule (consumed in the jitted train step;
    # reference: train.py:184-189, 205-207).
    cfg.MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS = 40000
    cfg.MODEL.DISTILLATOR.POST_NONDISTILL_ITERS = 0
    cfg.MODEL.DISTILLATOR.PRE_FREEZE_STUDENT_BACKBONE_ITERS = 10000
    cfg.MODEL.DISTILLATOR.DISTILL_OFF = 0
    cfg.MODEL.DISTILLATOR.DISTILL_ON = 1

    cfg.MODEL.RECIPROCAL_FPN_STRIDES = [1 / 8, 1 / 16, 1 / 32, 1 / 64, 1 / 128]

    cfg.MODEL.LOAD_BOXMAP = False
    cfg.MODEL.STRONGER_AUGS = False
    cfg.MODEL.LOAD_BOX_MASK = False

    cfg.MODEL.DISTILLATOR.HIDDEN_DIM = 64
    cfg.MODEL.DISTILLATOR.SMOOTH = 0
    cfg.MODEL.DISTILLATOR.EVAL_TEACHER = True
    cfg.MODEL.DISTILLATOR.TEACHER.INTERACT_PATTERN = "stuGuided"

    cfg.MODEL.DISTILLATOR.LABEL_ENCODER = CN()
    cfg.MODEL.DISTILLATOR.LABEL_ENCODER.LOAD_LABELMAP = False
    cfg.MODEL.DISTILLATOR.LABEL_ENCODER.BOX_FORMAT = "x1y1x2y2"
    cfg.MODEL.DISTILLATOR.LABEL_ENCODER.CATEGORY_FORMAT = "one_hot"

    cfg.MODEL.DISTILLATOR.TEACHER.NR_TRANSFORMER_HEADS = 8
    cfg.MODEL.DISTILLATOR.TEACHER.DETACH_APPEARANCE_EMBED = False
    cfg.MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX = False
    cfg.MODEL.DISTILLATOR.TEACHER.AFFINE = False

    cfg.MODEL.DISTILLATOR.KNOWLEDGE_MAPPER = CN()

    cfg.MODEL.DISTILLATOR.LAMBDA = 1.0
    cfg.MODEL.DISTILLATOR.TOWER_DISTILL_COEF = 1.0
    cfg.MODEL.DISTILLATOR.USE_MTH_HEAD = 1
    cfg.MODEL.DISTILLATOR.DETACH_TEA_WHEN_DISTILL = True
    cfg.MODEL.DISTILLATOR.ADAIN_BEFORE_DISTILL = False

    cfg = build_fcos(cfg)
    cfg = build_swint(cfg)
    return cfg


def build_swint(cfg: CN) -> CN:
    """Swin-Tiny defaults (reference utils/build.py:655-668)."""
    cfg.MODEL.SWINT = CN()
    cfg.MODEL.SWINT.EMBED_DIM = 96
    cfg.MODEL.SWINT.OUT_FEATURES = ["stage2", "stage3", "stage4", "stage5"]
    cfg.MODEL.SWINT.DEPTHS = [2, 2, 6, 2]
    cfg.MODEL.SWINT.NUM_HEADS = [3, 6, 12, 24]
    cfg.MODEL.SWINT.WINDOW_SIZE = 7
    cfg.MODEL.SWINT.MLP_RATIO = 4
    cfg.MODEL.SWINT.DROP_PATH_RATE = 0.2
    cfg.MODEL.SWINT.APE = False
    cfg.MODEL.FPN.TOP_LEVELS = 2
    return cfg


def build_fcos(cfg: CN) -> CN:
    """FCOS / ShiftGenerator / POTO / ATSS defaults
    (reference utils/build.py:671-714)."""
    cfg.MODEL.FCOS = CN(
        dict(
            NUM_CLASSES=80,
            IN_FEATURES=["p3", "p4", "p5", "p6", "p7"],
            NUM_CONVS=4,
            FPN_STRIDES=[8, 16, 32, 64, 128],
            PRIOR_PROB=0.01,
            CENTERNESS_ON_REG=True,
            NORM_REG_TARGETS=True,
            SCORE_THRESH_TEST=0.05,
            TOPK_CANDIDATES_TEST=1000,
            NMS_THRESH_TEST=0.6,
            BBOX_REG_WEIGHTS=(1.0, 1.0, 1.0, 1.0),
            FOCAL_LOSS_GAMMA=2.0,
            FOCAL_LOSS_ALPHA=0.25,
            IOU_LOSS_TYPE="giou",
            CENTER_SAMPLING_RADIUS=1.5,
            OBJECT_SIZES_OF_INTEREST=[
                [-1, 64],
                [64, 128],
                [128, 256],
                [256, 512],
                [512, float("inf")],
            ],
            NORM_SYNC=True,
            REG_WEIGHT=2.0,  # for atss
        )
    )
    cfg.MODEL.SHIFT_GENERATOR = CN(dict(NUM_SHIFTS=1, OFFSET=0.5))
    cfg.MODEL.NMS_TYPE = "normal"
    cfg.MODEL.POTO = CN(dict(ALPHA=0.8, CENTER_SAMPLING_RADIUS=1.5,
                             REG_WEIGHT=2.0,
                             # lgd_tpu extension: 'hungarian' (default —
                             # exact linear-sum assignment ON DEVICE,
                             # ops/hungarian.py, matching the reference's
                             # scipy poto.py:359), 'hungarian_host' (scipy
                             # pure_callback oracle; CPU backends only) or
                             # 'greedy' (on-device sync-free approximation)
                             ASSIGNMENT="hungarian"))
    cfg.MODEL.ATSS = CN(dict(ANCHOR_SCALE=8, TOPK=9))
    return cfg
