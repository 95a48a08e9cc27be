"""Configuration for the PyTorch/CUDA port — the subset the serving,
training and evaluation paths read.

Field names, defaults and presets mirror ``replication_faster_rcnn_tpu.config``
so a reader can hold the two side by side; knobs the port does not implement
yet (``bn_axis``, the mesh's optimizer fields ``backend``, ``shard_opt_state``
and ``grad_allreduce_dtype``) are left out rather than accepted and ignored. ``FleetConfig`` holds the fields the port reads: the engine's
``slo_*`` and ``serve``'s ``drain_grace_s``; the fleet router's fields come
with the router. The data path is the JAX package's: the uint8 feed
(``device_normalize``), the RAM cache, the host and on-device augmentations,
the device-resident dataset cache, device prefetch and the multi-scale
training buckets, with the same validation.

Box convention: boxes are ``[r1, c1, r2, c2]`` (``r`` along image rows,
``c`` along columns) and deltas ``[dr, dc, dh, dw]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOC_CLASSES: Tuple[str, ...] = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat",
    "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)
VOC_NUM_CLASSES = len(VOC_CLASSES)  # 20 VOC classes + background

# COCO-2017 "thing" classes (80 + background)
COCO_CLASSES: Tuple[str, ...] = (
    "__background__",
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)
COCO_NUM_CLASSES = len(COCO_CLASSES)  # 80 COCO-2017 categories + background

# ResNet trunks (models/resnet.py: the plain, grouped and wide ResNets of
# torchvision's constructor table) and the VGG16 trunk (models/vgg.py)
BACKBONES = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
             "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2", "vgg16")


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
    fpn: bool = False  # FPN neck over C2-C5, shared multi-level RPN, two-fc head
    fpn_channels: int = 256  # P-level width (FPN paper)
    compute_dtype: str = "bfloat16"  # float32 | bfloat16
    # recompute each residual block of the trunk (each conv block of VGG16)
    # in the backward pass instead of keeping its activations: more work,
    # less peak memory; the parameter names do not change
    remat: bool = False
    # every BatchNorm of the trunk and the tail applies its running
    # statistics in training too (no batch statistics, nothing to commit);
    # its affine stays trainable, as in the JAX package
    frozen_bn: bool = False
    # the backbone's norm at the BatchNorm sites: "batch", or "group"
    # (GroupNorm(32), no running statistics); VGG16 has no norm layers
    norm: str = "batch"

    def __post_init__(self):
        if self.backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}, got {self.backbone!r}")
        if self.roi_op not in ("align", "pool"):
            raise ValueError(f"roi_op must be 'align' or 'pool', got {self.roi_op!r}")
        if self.norm not in ("batch", "group"):
            raise ValueError(f"norm must be 'batch' or 'group', got {self.norm!r}")
        if self.norm == "group" and self.frozen_bn:
            raise ValueError(
                "frozen_bn freezes BatchNorm statistics; GroupNorm has none "
                "— the combination is meaningless, pick one"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype!r}"
            )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "voc"  # voc | coco | synthetic (data/loader.py::make_dataset)
    root_dir: str = "data/voc/VOCdevkit/VOC2012"
    image_size: Tuple[int, int] = (600, 600)
    max_boxes: int = 32  # gt boxes per image, padded with -1 labels
    # difficult objects join the training mask (evaluation always ignores them)
    use_difficult: bool = False
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # loader workers (data/loader.py): -1 = min(4, the cores this process may use)
    loader_workers: int = -1
    # "thread" scales the decode that releases the interpreter lock (the host
    # library's); "process" (forked workers) scales sample work that holds it
    loader_mode: str = "thread"  # thread | process
    loader_prefetch: int = 2  # batches built ahead of the consumer
    # memoize decoded samples in host RAM (data/cache.py): the first epoch
    # pays the decode, later ones a copy
    loader_cache_ram: bool = False
    # ship uint8 images and normalize on the card (the model's preprocess):
    # a quarter of the host-to-device bytes. Off: the float32 samples
    device_normalize: bool = False
    # 50% horizontal flip, deterministic per (seed, epoch, index); the VOC
    # and COCO presets turn it on, as the JAX presets do
    augment_hflip: bool = False
    # scale jitter (lo, hi) on a fixed canvas, boxes tracked, collapsed rows
    # masked (data/augment.py::scale_jitter_sample). None = off
    augment_scale: Optional[Tuple[float, float]] = None
    # the jitter's image resample on the card (ops/image.py): the host moves
    # the boxes and ships the integer geometry. Requires augment_scale
    augment_scale_device: bool = False
    # every augmentation on the card (ops/image.py::augment_batch): the
    # loader ships raw samples with an int32 [idx, epoch] row and the step
    # draws flip, translate and scale from (seed, epoch, idx). Needs one of
    # augment_hflip / augment_scale / augment_translate; excludes
    # augment_scale_device and cache_device
    augment_device: bool = False
    # translation jitter amplitude (a fraction of the canvas), device mode only
    augment_translate: float = 0.0
    # the whole dataset resident on the card (data/device_cache.py): each
    # step ships indices and augmentation decisions only
    cache_device: bool = False
    # batches (or K-step chunks) staged on the card ahead of the step by a
    # producer thread (data/prefetch_device.py); 0 = staged synchronously
    prefetch_device: int = 0
    # multi-scale training: (h, w) buckets; each global batch trains at one,
    # chosen by data/augment.py::bucket_index and resampled on the card
    # (ops/image.py::resize_batch_with_boxes). () = off
    train_resolutions: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if self.prefetch_device < 0:
            raise ValueError(
                f"prefetch_device must be >= 0, got {self.prefetch_device}"
            )
        if self.augment_scale is not None:
            lo, hi = self.augment_scale
            # fail at config build, not at the first training epoch
            if not 0.1 <= lo <= hi <= 4.0:
                raise ValueError(
                    "augment_scale must satisfy 0.1 <= lo <= hi <= 4.0, "
                    f"got {self.augment_scale!r}"
                )
            # coerce list inputs (dict/JSON config paths) to a tuple so the
            # frozen dataclass stays hashable like its other tuple fields
            object.__setattr__(self, "augment_scale", (float(lo), float(hi)))
        if self.augment_scale_device and self.augment_scale is None:
            raise ValueError(
                "augment_scale_device requires augment_scale to be set"
            )
        if not 0.0 <= self.augment_translate < 1.0:
            raise ValueError(
                "augment_translate must be in [0, 1), got "
                f"{self.augment_translate!r}"
            )
        if self.augment_translate and not self.augment_device:
            raise ValueError(
                "augment_translate is a device-mode op: set "
                "data.augment_device=True (the host pipeline has no "
                "translation path)"
            )
        if self.augment_device:
            if not (
                self.augment_hflip
                or self.augment_scale is not None
                or self.augment_translate
            ):
                raise ValueError(
                    "augment_device is set but no augmentation op is "
                    "enabled (augment_hflip / augment_scale / "
                    "augment_translate)"
                )
            if self.augment_scale_device:
                raise ValueError(
                    "augment_device supersedes augment_scale_device — "
                    "set only one"
                )
            if self.cache_device:
                raise ValueError(
                    "augment_device is incompatible with cache_device: "
                    "the device cache already flips/jitters inside its "
                    "gather (data/device_cache.py)"
                )
        if self.train_resolutions:
            res = tuple(
                (int(r[0]), int(r[1])) for r in self.train_resolutions
            )
            for h, w in res:
                if h < 1 or w < 1:
                    raise ValueError(
                        "data.train_resolutions entries must be positive "
                        f"(h, w) pairs, got {(h, w)}"
                    )
            if len(set(res)) != len(res):
                raise ValueError(
                    f"data.train_resolutions has duplicates: {res!r}"
                )
            # canonical smallest-area-first order: the bucket index is part
            # of the deterministic assignment
            object.__setattr__(
                self,
                "train_resolutions",
                tuple(sorted(res, key=lambda r: (r[0] * r[1], r))),
            )
        else:
            # coerce None/[] (JSON round-trips) to the canonical empty tuple
            object.__setattr__(self, "train_resolutions", ())


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization: optax's chain as the JAX package builds it (L2 weight
    decay added to the gradient, Adam, an optional trust ratio, a per-epoch
    cosine schedule with an optional linear warmup;
    ``train/train_step.py::make_optimizer``)."""

    lr: float = 1e-4
    weight_decay: float = 5e-6
    # "adam", or "lamb": Adam followed by the per-layer trust ratio
    # |param| / |update| (arXiv:1904.00962)
    optimizer: str = "adam"  # adam | lamb
    n_epoch: int = 50
    batch_size: int = 8
    smooth_l1_sigma: float = 1.0
    # scheduled saves (train/trainer.py::Trainer.save) every N epochs, and
    # also every N optimizer steps at dispatch boundaries (0 = off)
    checkpoint_every_epochs: int = 10
    checkpoint_every_steps: int = 0
    seed: int = 0
    # rpn_cls, rpn_reg, head_cls, head_reg
    loss_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    sampling_strategy: str = "random"  # random | topk_iou
    # a gradient with NaN/Inf: "skip" withholds the whole update (params,
    # Adam state, BN statistics unchanged), "halt" withholds it and raises,
    # "apply" applies it
    nonfinite_policy: str = "skip"  # apply | skip | halt
    # consecutive skipped steps before the trainer raises (train/fault.py::SkipMonitor)
    max_consecutive_skips: int = 10
    # scheduled saves on a background writer (train/async_checkpoint.py):
    # the trainer thread pays only the host snapshot
    async_checkpoint: bool = False
    # run the evaluator on the val split every N epochs (0 = off)
    eval_every_epochs: int = 0
    # large-batch recipe (arXiv:1711.04325): "linear" scales the schedule's
    # peak lr by batch_size / base_batch_size; "none" uses lr as it is
    lr_scaling: str = "none"  # none | linear
    base_batch_size: int = 8
    # linear lr warmup over the first warmup_epochs (a fraction is fine) up
    # to the peak, then the cosine schedule; 0 = off
    warmup_epochs: float = 0.0
    # the trust ratio |param| / |update| per leaf after Adam (LARS-style)
    lars: bool = False
    # dtype of Adam's first moment; the second moment stays float32
    adam_mu_dtype: str = "float32"  # float32 | bfloat16
    # steps trained by one dispatch (Trainer.train_chunk): on the card one
    # replay of a CUDA graph of K steps; metrics come back stacked [K]
    steps_per_dispatch: int = 1

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
        if self.checkpoint_every_steps < 0:
            raise ValueError(
                "checkpoint_every_steps must be >= 0 (0 = off), got "
                f"{self.checkpoint_every_steps}"
            )
        if self.max_consecutive_skips < 1:
            raise ValueError(
                "max_consecutive_skips must be >= 1, got "
                f"{self.max_consecutive_skips}"
            )
        if self.optimizer not in ("adam", "lamb"):
            raise ValueError(
                f"optimizer must be 'adam' or 'lamb', got {self.optimizer!r}"
            )
        if self.optimizer == "lamb" and self.lars:
            raise ValueError(
                "optimizer='lamb' already applies the per-layer trust "
                "ratio after Adam; combining it with lars=True would "
                "rescale twice — drop one"
            )
        if self.adam_mu_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"adam_mu_dtype must be float32|bfloat16, got {self.adam_mu_dtype!r}"
            )
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}"
            )
        if self.lr_scaling not in ("none", "linear"):
            raise ValueError(
                f"lr_scaling must be 'none' or 'linear', got {self.lr_scaling!r}"
            )
        if self.base_batch_size < 1:
            raise ValueError(
                f"base_batch_size must be >= 1, got {self.base_batch_size}"
            )
        if self.warmup_epochs < 0:
            raise ValueError(
                f"warmup_epochs must be >= 0, got {self.warmup_epochs}"
            )


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    score_thresh: float = 0.05
    nms_thresh: float = 0.3
    max_detections: int = 100
    iou_thresh: float = 0.5  # mAP@0.5
    use_07_metric: bool = False  # area under the PR curve; True = 11-point
    metric: str = "voc"  # "voc" (mAP@iou_thresh) | "coco" (mAP@[.50:.95])
    # flip test-time augmentation: a second forward on the mirrored image,
    # its candidates reflected back and merged before the one per-class NMS
    # (eval/detect.py::batched_decode_tta)
    tta_hflip: bool = False

    def __post_init__(self):
        if self.metric not in ("voc", "coco"):
            raise ValueError(f"metric must be 'voc' or 'coco', got {self.metric!r}")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Bucketed micro-batched serving (serving/engine.py): one CUDA graph per
    (model version, bucket, batch size), params resident in ``params_dtype``,
    requests coalesced into bucket-sized micro-batches (flush on size or
    ``max_delay_ms``)."""

    # () = derived: the configured image size plus its half
    resolutions: Tuple[Tuple[int, int], ...] = ()
    batch_sizes: Tuple[int, ...] = (1, 8)
    max_delay_ms: float = 10.0
    queue_depth: int = 64
    # float32 | bfloat16 | int8 (int8 needs the calibration sidecar:
    # quant/artifact.py, path from quant.artifact)
    params_dtype: str = "bfloat16"
    oversize: str = "downscale"  # downscale | reject
    # per-request deadline, end to end: the HTTP handler's wait times out to
    # 504 after this many seconds and an entry still queued past it is
    # dropped at flush time, never dispatched (0 = no deadline)
    request_timeout_s: float = 0.0
    # SLO-driven micro-batch deadlines (serving/slo.py): each bucket's
    # max_delay_ms moves by one multiplicative step of adaptive_delay_step
    # per window of queue waits, inside [delay_floor_ms, delay_ceiling_ms]
    adaptive_delay: bool = False
    adaptive_slo_ms: float = 100.0  # target queue-wait p99 per request
    delay_floor_ms: float = 1.0
    delay_ceiling_ms: float = 100.0
    adaptive_delay_step: float = 1.25

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
        if self.params_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                "serving.params_dtype must be float32|bfloat16|int8, got "
                f"{self.params_dtype!r}"
            )
        if self.oversize not in ("downscale", "reject"):
            raise ValueError(
                "serving.oversize must be 'downscale' or 'reject', got "
                f"{self.oversize!r}"
            )
        if self.request_timeout_s < 0:
            raise ValueError(
                "serving.request_timeout_s must be >= 0 (0 = no deadline), "
                f"got {self.request_timeout_s}"
            )
        if self.adaptive_slo_ms <= 0:
            raise ValueError(
                "serving.adaptive_slo_ms must be > 0, got "
                f"{self.adaptive_slo_ms}"
            )
        if not 0 < self.delay_floor_ms <= self.delay_ceiling_ms:
            raise ValueError(
                "serving delay bounds need 0 < delay_floor_ms <= "
                f"delay_ceiling_ms, got floor={self.delay_floor_ms} "
                f"ceiling={self.delay_ceiling_ms}"
            )
        if self.adaptive_delay_step <= 1.0:
            raise ValueError(
                "serving.adaptive_delay_step is multiplicative and must be "
                f"> 1.0, got {self.adaptive_delay_step}"
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
class FleetConfig:
    """Multi-replica serving fleet (serving/fleet/, the ``fleet`` subcommand).

    A front router owns a health-checked replica registry (periodic
    ``/healthz`` probes with lease-style staleness, the elastic trainer's heartbeat
    discipline applied to serving), dispatches by consistent hash over
    (content-hash, bucket), and self-heals: per-replica circuit breakers,
    failover re-dispatch, hedged retries after a p99-derived delay, and
    probe-driven drain/rejoin so a restarted replica re-enters rotation
    without dropped traffic. The fields and their validation are the JAX
    package's; the engine reads the ``slo_*`` fields too.
    """

    # ---- registry / prober
    probe_interval_s: float = 0.5  # /healthz probe cadence per replica
    # a replica whose last successful probe is older than this is DEAD
    # (lease staleness — missing probes age the lease out, exactly like
    # parallel/elastic.py's lease ages out training heartbeats)
    lease_timeout_s: float = 3.0
    # consecutive successful probes a DEAD/JOINING replica needs before
    # it re-enters rotation (a flapping replica can't bounce in and out)
    rejoin_probes: int = 2
    # ---- circuit breaker (per replica)
    breaker_threshold: int = 3  # consecutive dispatch failures to open
    breaker_cooldown_s: float = 1.0  # open -> half-open probe delay
    # ---- dispatch
    max_attempts: int = 3  # primary + failover re-dispatches per request
    request_timeout_s: float = 30.0  # per-attempt replica call deadline
    vnodes: int = 64  # consistent-hash ring points per replica
    # content-hash result cache entries (duplicate images are answered
    # from the router without touching a replica; 0 disables)
    cache_entries: int = 256
    # ---- hedging: after hedge_multiplier x observed p99 (clamped to
    # [hedge_floor_ms, hedge_ceiling_ms]) with no primary response, a
    # second copy goes to the next ring replica; first result wins
    hedge: bool = True
    hedge_multiplier: float = 1.5
    hedge_floor_ms: float = 5.0
    hedge_ceiling_ms: float = 2000.0
    latency_window: int = 128  # per-router latency samples for the p99
    # ---- canary / shadow
    # fraction of requests routed to the canary replica first (decided
    # by content hash, so the split is deterministic per image)
    canary_fraction: float = 0.05
    # ---- replica-side drain: how long a SIGTERMed ``serve
    # --replica-id`` advertises draining=true in /healthz (so the router
    # stops routing to it) before it stops accepting connections
    drain_grace_s: float = 1.0
    # ---- SLO error-budget burn-rate (telemetry/slo_burn.py): every
    # dispatch ATTEMPT outcome (not just final request outcomes — with
    # failover a dying replica barely dents request availability, but
    # its failed attempts are the leading indicator) feeds multi-window
    # burn accounting; the alarm (burn > 1 on BOTH windows) surfaces in
    # /stats and auto-demotes an alarming canary back to serving role
    slo_availability_target: float = 0.999  # error budget = 1 - target
    slo_latency_target_ms: float = 0.0  # 0 = availability-only budget
    slo_short_window_s: float = 300.0  # alarm-clearing window (5 m)
    slo_long_window_s: float = 3600.0  # alarm-meaning window (1 h)

    def __post_init__(self):
        if self.probe_interval_s <= 0:
            raise ValueError(
                f"fleet.probe_interval_s must be > 0, got {self.probe_interval_s}"
            )
        if self.lease_timeout_s <= self.probe_interval_s:
            raise ValueError(
                "fleet.lease_timeout_s must exceed probe_interval_s "
                f"({self.probe_interval_s}), got {self.lease_timeout_s}"
            )
        if self.rejoin_probes < 1:
            raise ValueError(
                f"fleet.rejoin_probes must be >= 1, got {self.rejoin_probes}"
            )
        if self.breaker_threshold < 1:
            raise ValueError(
                "fleet.breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}"
            )
        if self.breaker_cooldown_s <= 0:
            raise ValueError(
                "fleet.breaker_cooldown_s must be > 0, got "
                f"{self.breaker_cooldown_s}"
            )
        if self.max_attempts < 1:
            raise ValueError(
                f"fleet.max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.request_timeout_s <= 0:
            raise ValueError(
                "fleet.request_timeout_s must be > 0, got "
                f"{self.request_timeout_s}"
            )
        if self.vnodes < 1:
            raise ValueError(f"fleet.vnodes must be >= 1, got {self.vnodes}")
        if self.cache_entries < 0:
            raise ValueError(
                f"fleet.cache_entries must be >= 0, got {self.cache_entries}"
            )
        if self.hedge_multiplier <= 0:
            raise ValueError(
                "fleet.hedge_multiplier must be > 0, got "
                f"{self.hedge_multiplier}"
            )
        if not 0 < self.hedge_floor_ms <= self.hedge_ceiling_ms:
            raise ValueError(
                "fleet hedge bounds need 0 < hedge_floor_ms <= "
                f"hedge_ceiling_ms, got floor={self.hedge_floor_ms} "
                f"ceiling={self.hedge_ceiling_ms}"
            )
        if self.latency_window < 1:
            raise ValueError(
                f"fleet.latency_window must be >= 1, got {self.latency_window}"
            )
        if not 0.0 <= self.canary_fraction <= 1.0:
            raise ValueError(
                "fleet.canary_fraction must be in [0, 1], got "
                f"{self.canary_fraction}"
            )
        if self.drain_grace_s < 0:
            raise ValueError(
                f"fleet.drain_grace_s must be >= 0, got {self.drain_grace_s}"
            )
        if not 0.0 < self.slo_availability_target < 1.0:
            raise ValueError(
                "fleet.slo_availability_target must be in (0, 1), got "
                f"{self.slo_availability_target}"
            )
        if self.slo_latency_target_ms < 0:
            raise ValueError(
                "fleet.slo_latency_target_ms must be >= 0, got "
                f"{self.slo_latency_target_ms}"
            )
        if not 0 < self.slo_short_window_s < self.slo_long_window_s:
            raise ValueError(
                "fleet SLO windows need 0 < slo_short_window_s < "
                f"slo_long_window_s, got short={self.slo_short_window_s} "
                f"long={self.slo_long_window_s}"
            )


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Post-training int8 quantization (``quant/``).

    Calibration collects per-channel symmetric int8 weight scales plus the
    activation range of the cls/reg input from a small sweep through the
    inference forward, and writes them as a CRC-manifested sidecar. The
    sensitivity sweep quantizes one layer group at a time and plans bf16
    for a group whose response-reconstruction error or mAP drop exceeds
    its threshold.
    """

    # sidecar path for serving.params_dtype="int8"; "" means
    # "<checkpoint_dir>/quant_artifact.json" (quant/artifact.py)
    artifact: str = ""
    # calibration sweep size: batches x batch_size images in dataset order
    calib_batches: int = 2
    calib_batch_size: int = 2
    # per-group fallback thresholds of the sensitivity sweep
    sensitivity_map_drop_pt: float = 0.1
    sensitivity_recon_rel_err: float = 0.25

    def __post_init__(self):
        if self.calib_batches < 1:
            raise ValueError(
                f"quant.calib_batches must be >= 1, got {self.calib_batches}"
            )
        if self.calib_batch_size < 1:
            raise ValueError(
                "quant.calib_batch_size must be >= 1, got "
                f"{self.calib_batch_size}"
            )
        if self.sensitivity_map_drop_pt < 0:
            raise ValueError(
                "quant.sensitivity_map_drop_pt must be >= 0, got "
                f"{self.sensitivity_map_drop_pt}"
            )
        if self.sensitivity_recon_rel_err <= 0:
            raise ValueError(
                "quant.sensitivity_recon_rel_err must be > 0, got "
                f"{self.sensitivity_recon_rel_err}"
            )


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Observability knobs (``telemetry/``): whether trace context crosses
    HTTP hops, how large a trace buffer may grow, and the latency histogram
    grid the serving engine registers with."""

    # adopt/emit the W3C traceparent header across HTTP hops; off = spans
    # still record locally but requests don't correlate
    trace_propagation: bool = True
    # SpanTracer in-memory event bound (overflow drops events and counts
    # them, never grows)
    trace_max_events: int = 200_000
    # latency histogram upper bounds in ms; () = the built-in log-spaced
    # 1 ms .. 60 s grid (telemetry/metrics.py)
    latency_buckets_ms: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.trace_max_events < 1:
            raise ValueError(
                "telemetry.trace_max_events must be >= 1, got "
                f"{self.trace_max_events}"
            )
        b = list(self.latency_buckets_ms)
        if b and (sorted(b) != b or b[0] <= 0):
            raise ValueError(
                "telemetry.latency_buckets_ms must be ascending and "
                f"positive, got {self.latency_buckets_ms}"
            )

    def buckets_s(self) -> Optional[Tuple[float, ...]]:
        """The configured grid in seconds, or ``None`` for the default."""
        if not self.latency_buckets_ms:
            return None
        return tuple(ms / 1000.0 for ms in self.latency_buckets_ms)


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Rolling weight rollout control plane (serving/rollout/).

    The trainer's ``workdir/manifests/`` feed publishes CRC-manifested
    checkpoint versions; the rollout controller validates eligibility
    (manifest CRC + topology + quant sidecar, *before* any replica
    drains), then drives a rolling fleet upgrade through the registry:
    drain one replica (DRAINING keeps the lease), hot-swap its params,
    re-admit on `fleet.rejoin_probes` consecutive OKs at the new
    version. The first upgraded replica lands as CANARY; a windowed
    burn-rate + shadow-diff gate decides promote vs rollback, and
    rollback is a first-class reverse rollout.
    """

    # watcher poll interval over workdir/manifests/
    poll_interval_s: float = 2.0
    # how long the controller waits for a held replica's queues to
    # drain before swapping (simulated clocks make this cheap in tests)
    drain_timeout_s: float = 10.0
    # per-replica budget for the swap RPC itself
    swap_timeout_s: float = 30.0
    # budget for a swapped replica to re-reach HEALTHY at the new
    # version before the wave is declared failed and rolled back
    rejoin_timeout_s: float = 10.0
    # canary gate: minimum routed canary requests before the windowed
    # decision may *promote* (rollback triggers need no minimum)
    canary_min_requests: int = 0
    # how long the new version must hold CANARY before promotion
    canary_hold_s: float = 5.0
    # rollback if shadow_diffs / shadow_requests exceeds this fraction
    # during the hold window (only when shadow traffic exists)
    max_shadow_diff_fraction: float = 0.25
    # require the manifest's config hash to match the serving config
    # (disable when rolling between intentionally different configs)
    require_config_hash: bool = True
    # auto-reverse the wave on canary alarm/demotion; False = hold as
    # CANARY and leave the decision to the operator
    auto_rollback: bool = True

    def __post_init__(self):
        for name in ("poll_interval_s", "drain_timeout_s",
                     "swap_timeout_s", "rejoin_timeout_s",
                     "canary_hold_s"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"rollout.{name} must be > 0, got {v}")
        if self.canary_min_requests < 0:
            raise ValueError(
                "rollout.canary_min_requests must be >= 0, got "
                f"{self.canary_min_requests}"
            )
        if not (0.0 <= self.max_shadow_diff_fraction <= 1.0):
            raise ValueError(
                "rollout.max_shadow_diff_fraction must be in [0, 1], "
                f"got {self.max_shadow_diff_fraction}"
            )


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
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)
    rollout: RolloutConfig = dataclasses.field(default_factory=RolloutConfig)

    def replace(self, **kwargs) -> "FasterRCNNConfig":
        return dataclasses.replace(self, **kwargs)


def _voc_data(**kw) -> DataConfig:
    """The VOC presets' data pipeline: the 50% horizontal flip on, as the
    JAX package's ``_voc_data``."""
    kw.setdefault("augment_hflip", True)
    return DataConfig(**kw)


CONFIGS = {
    # ResNet18 + RPN + ROIPool at 600x600 on VOC2007 (the flagship preset)
    "voc_resnet18": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet18", roi_op="pool"),
        data=_voc_data(root_dir="data/voc/VOCdevkit/VOC2007"),
    ),
    # ResNet50 (Bottleneck) backbone, ROIPool head, VOC2007
    "voc_resnet50": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet50", roi_op="pool"),
        data=_voc_data(root_dir="data/voc/VOCdevkit/VOC2007"),
    ),
    # FPN over ResNet50: P2-P6 at 256 channels, one anchor scale per level
    # (strides 4-64), multi-level ROIAlign 7x7 into a two-fc (1024) head
    "voc_resnet50_fpn": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet50", roi_op="align", fpn=True),
        anchors=AnchorConfig(scales=(8.0,)),
        data=_voc_data(),
    ),
    # the same network with the ROIAlign head (7x7, 2x2 samples per bin), VOC2012
    "voc12_resnet18_align": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet18", roi_op="align"),
        data=_voc_data(root_dir="data/voc/VOCdevkit/VOC2012"),
    ),
    # COCO-2017: 81 classes, ROIAlign, up to 100 boxes, batch 32, COCO mAP
    "coco_resnet50": FasterRCNNConfig(
        model=ModelConfig(backbone="resnet50", num_classes=COCO_NUM_CLASSES, roi_op="align"),
        data=DataConfig(dataset="coco", root_dir="data/coco", max_boxes=100,
                        augment_hflip=True),
        train=TrainConfig(batch_size=32),
        eval=EvalConfig(metric="coco"),
    ),
    # the py-faster-rcnn VGG16 COCO net: 512-wide RPN conv, 12 anchors (3
    # ratios x 4 scales), ROIPool 7x7, fc6/fc7 tail, 81 classes
    "coco_vgg16": FasterRCNNConfig(
        model=ModelConfig(
            backbone="vgg16", num_classes=COCO_NUM_CLASSES, roi_op="pool", rpn_mid_channels=512,
        ),
        anchors=AnchorConfig(scales=(4.0, 8.0, 16.0, 32.0)),
        data=DataConfig(dataset="coco", root_dir="data/coco", max_boxes=100,
                        augment_hflip=True),
        eval=EvalConfig(metric="coco"),
    ),
}


def get_config(name: str = "voc_resnet18") -> FasterRCNNConfig:
    """Look up a preset by name."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; choices: {sorted(CONFIGS)}")
    return CONFIGS[name]
