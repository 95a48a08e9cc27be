"""Configuration for the PyTorch/CUDA port — the subset the serving and
training paths read.

Field names, defaults and presets mirror ``replication_faster_rcnn_tpu.config``
so a reader can hold the two side by side; knobs the port does not implement
yet (FPN, VGG16, group norm, int8, LAMB/LARS, warmup, K-step fusion,
checkpointing, fleet) are left out rather than accepted and ignored.

Box convention: boxes are ``[r1, c1, r2, c2]`` (``r`` along image rows,
``c`` along columns) and deltas ``[dr, dc, dh, dw]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

VOC_NUM_CLASSES = 21  # 20 VOC classes + background


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    base_size: int = 16
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    scales: Tuple[float, ...] = (8.0, 16.0, 32.0)
    feat_stride: int = 16

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    nms_thresh: float = 0.7
    pre_nms_train: int = 12000
    post_nms_train: int = 600
    pre_nms_test: int = 3000
    post_nms_test: int = 300
    min_size: float = 16.0

    def pre_nms(self, train: bool) -> int:
        return self.pre_nms_train if train else self.pre_nms_test

    def post_nms(self, train: bool) -> int:
        return self.post_nms_train if train else self.post_nms_test


@dataclasses.dataclass(frozen=True)
class RPNTargetConfig:
    """First-stage (anchor) target sampling."""

    n_sample: int = 256
    pos_iou_thresh: float = 0.7
    neg_iou_thresh: float = 0.3
    pos_ratio: float = 0.5


@dataclasses.dataclass(frozen=True)
class ROITargetConfig:
    """Second-stage (head) target sampling, always exactly ``n_sample``
    rois per image; ``reg_mean``/``reg_std`` also normalise the decode."""

    n_sample: int = 128
    pos_ratio: float = 0.5
    pos_iou_thresh: float = 0.5
    neg_iou_thresh_high: float = 0.5
    neg_iou_thresh_low: float = 0.0
    reg_mean: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    reg_std: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)

    @property
    def n_pos_max(self) -> int:
        return int(round(self.n_sample * self.pos_ratio))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: str = "resnet18"
    num_classes: int = VOC_NUM_CLASSES
    rpn_mid_channels: int = 256
    roi_size: int = 7
    roi_op: str = "align"  # "align" | "pool"
    roi_sampling_ratio: int = 2
    compute_dtype: str = "bfloat16"  # float32 | bfloat16

    def __post_init__(self):
        if self.roi_op not in ("align", "pool"):
            raise ValueError(f"roi_op must be 'align' or 'pool', got {self.roi_op!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype!r}"
            )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_size: Tuple[int, int] = (600, 600)
    max_boxes: int = 32  # gt boxes per image, padded with -1 labels
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization: Adam with L2 weight decay added to the gradient and a
    per-epoch cosine schedule (``train/train_step.py::make_optimizer``)."""

    lr: float = 1e-4
    weight_decay: float = 5e-6
    n_epoch: int = 50
    batch_size: int = 8
    smooth_l1_sigma: float = 1.0
    seed: int = 0
    # rpn_cls, rpn_reg, head_cls, head_reg
    loss_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    sampling_strategy: str = "random"  # random | topk_iou
    # a gradient with NaN/Inf: "skip" withholds the whole update (params,
    # Adam state, BN statistics unchanged), "halt" withholds it and raises,
    # "apply" applies it
    nonfinite_policy: str = "skip"  # apply | skip | halt

    def __post_init__(self):
        object.__setattr__(
            self, "loss_weights", tuple(float(w) for w in self.loss_weights)
        )
        if len(self.loss_weights) != 4:
            raise ValueError(
                f"train.loss_weights must have 4 entries, got {self.loss_weights!r}"
            )
        if self.n_epoch < 1 or self.batch_size < 1:
            raise ValueError(
                "train.n_epoch and train.batch_size must be >= 1, got "
                f"{self.n_epoch}, {self.batch_size}"
            )
        if self.sampling_strategy not in ("random", "topk_iou"):
            raise ValueError(
                "sampling_strategy must be 'random' or 'topk_iou', got "
                f"{self.sampling_strategy!r}"
            )
        if self.nonfinite_policy not in ("apply", "skip", "halt"):
            raise ValueError(
                "nonfinite_policy must be apply|skip|halt, got "
                f"{self.nonfinite_policy!r}"
            )


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    score_thresh: float = 0.05
    nms_thresh: float = 0.3
    max_detections: int = 100


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Bucketed micro-batched serving (serving/engine.py)."""

    # () = derived: the configured image size plus its half
    resolutions: Tuple[Tuple[int, int], ...] = ()
    batch_sizes: Tuple[int, ...] = (1, 8)
    max_delay_ms: float = 10.0
    queue_depth: int = 64
    params_dtype: str = "bfloat16"  # float32 | bfloat16
    oversize: str = "downscale"  # downscale | reject

    def __post_init__(self):
        object.__setattr__(
            self, "resolutions",
            tuple((int(r[0]), int(r[1])) for r in self.resolutions),
        )
        object.__setattr__(
            self, "batch_sizes", tuple(int(b) for b in self.batch_sizes)
        )
        for h, w in self.resolutions:
            if h < 1 or w < 1:
                raise ValueError(
                    f"serving.resolutions entries must be positive, got {(h, w)}"
                )
        if not self.batch_sizes or any(b < 1 for b in self.batch_sizes):
            raise ValueError(
                "serving.batch_sizes must be a non-empty tuple of ints >= 1, "
                f"got {self.batch_sizes!r}"
            )
        if self.max_delay_ms < 0:
            raise ValueError(
                f"serving.max_delay_ms must be >= 0, got {self.max_delay_ms}"
            )
        if self.queue_depth < 1:
            raise ValueError(
                f"serving.queue_depth must be >= 1, got {self.queue_depth}"
            )
        if self.params_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "serving.params_dtype must be float32|bfloat16 (int8 serving "
                f"is not ported yet), got {self.params_dtype!r}"
            )
        if self.oversize not in ("downscale", "reject"):
            raise ValueError(
                "serving.oversize must be 'downscale' or 'reject', got "
                f"{self.oversize!r}"
            )

    def bucket_resolutions(
        self, image_size: Tuple[int, int]
    ) -> Tuple[Tuple[int, int], ...]:
        """The resolved bucket list, smallest area first."""
        if self.resolutions:
            res = set(self.resolutions)
        else:
            h, w = image_size
            res = {(max(1, h // 2), max(1, w // 2)), (h, w)}
        return tuple(sorted(res, key=lambda r: (r[0] * r[1], r)))


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    proposals: ProposalConfig = dataclasses.field(default_factory=ProposalConfig)
    rpn_targets: RPNTargetConfig = dataclasses.field(default_factory=RPNTargetConfig)
    roi_targets: ROITargetConfig = dataclasses.field(default_factory=ROITargetConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)

    def replace(self, **kwargs) -> "FasterRCNNConfig":
        return dataclasses.replace(self, **kwargs)


CONFIGS = {
    # ResNet18 + RPN + ROIPool at 600x600 (the flagship preset)
    "voc_resnet18": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet18", roi_op="pool"),
    ),
    # the same network with the ROIAlign head (7x7, 2x2 samples per bin)
    "voc12_resnet18_align": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet18", roi_op="align"),
    ),
}


def get_config(name: str = "voc_resnet18") -> FasterRCNNConfig:
    """Look up a preset by name."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; choices: {sorted(CONFIGS)}")
    return CONFIGS[name]
