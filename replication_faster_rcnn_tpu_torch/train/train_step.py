"""The training step: trunk -> RPN -> anchor targets -> proposals -> proposal
targets -> head -> 4 losses -> backward -> guarded Adam update (counterpart
of the JAX package's ``train/train_step.py``).

The losses follow the JAX package: rpn_cls (2-way CE, ignore -1), rpn_reg
(smooth-L1 on anchor positives), head_cls (21-way CE, ignore -1) and
head_reg (smooth-L1 on sampled positives, class-specific deltas), summed
with ``train.loss_weights``.

Random draws. The JAX step keys its sampling with threefry, which PyTorch
cannot reproduce; here every uniform the targets consume is drawn from the
state's device ``torch.Generator``, in a fixed order (:data:`DRAW_NAMES`),
and after them the VGG16 tail's two dropout keep masks
(:data:`KEEP_MASK_NAMES`), unless the caller injects them. The parity tests
inject the JAX step's own draws and masks; ``chip_smoke.py`` replays one
step's draws and masks under ``ops.reference_scope()``. A captured step
given no draws draws fresh uniforms and masks at every replay.

The optimizer is optax's chain as the JAX package builds it
(:func:`make_optimizer`), computed with plain tensor operations on flat
float32 vectors: ``add_decayed_weights`` -> ``scale_by_adam`` -> the trust
ratio (``train.lars`` or ``train.optimizer="lamb"``) ->
``scale_by_learning_rate(schedule(count))``. Its state is optax's: Adam's
``mu`` (in ``train.adam_mu_dtype``) and ``nu`` (float32) and one int32
``count`` of applied updates on the parameters' device, from which the
learning rate is computed on the device too. The guarded update
(``train/fault.py::guarded_update``) commits or keeps each of them with a
select on a device predicate, so a step never waits for the host.

On a CUDA device :func:`make_train_step` captures the step as a CUDA graph
(:class:`CapturedSteps`), the counterpart of ``jax.jit`` (and, for K steps
per dispatch, of ``build_multi_step``): the first call of a new batch shape
runs real steps eagerly on a side stream, captures the same steps, and every
later call replays the graph. On the CPU, or when ``draws``, ``record`` or
``stage`` is passed, the step runs eagerly.

The step's prologue is the JAX step's (:func:`compute_losses`): a batch with
``jitter`` (``data.augment_scale_device``) is resampled on the card, one with
``aug`` (``data.augment_device``) augmented there from its (seed, epoch, idx)
draws, and a ``resolution`` (a ``data.train_resolutions`` bucket) resamples
the batch to that bucket's shape; each bucket is its own graph.
:func:`make_cached_train_step` takes the device cache's selections (``idx``,
``flip``, ``jitter``) and materializes the batch from the resident cache
inside the same step (``data/device_cache.py::materialize_batch``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
from replication_faster_rcnn_tpu_torch.models.head import select_class_deltas
from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
from replication_faster_rcnn_tpu_torch.models.vgg import KEEP_MASK_NAMES  # noqa: F401 (re-exported)
from replication_faster_rcnn_tpu_torch.targets import (
    batched_anchor_targets,
    batched_proposal_targets,
    draw_uniform,
)
from replication_faster_rcnn_tpu_torch.train import fault, losses

Tensor = torch.Tensor

# the targets' uniform draws, in the order they are taken from the generator:
# anchor positives/negatives [N, A], roi positives/negatives/pack [N, R + G];
# a VGG16 head draws its keep masks (KEEP_MASK_NAMES, [N * R, 4096] bool) after them
DRAW_NAMES = ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_pack")

# stage(name) -> context manager around one stage (timing hooks); the
# default does nothing
StageFn = Callable[[str], contextlib.AbstractContextManager]


def _no_stage(name: str) -> contextlib.AbstractContextManager:
    return contextlib.nullcontext()


# optax.scale_by_adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class TrainState:
    """What a step carries: the model (parameters + BatchNorm statistics),
    the optimizer (its state holds the schedule's count), the sampling
    generator and the step count (dispatched batches, skipped ones
    included). ``graphs`` holds the CUDA graphs captured from this state's
    tensors, by batch signature and steps per dispatch."""

    model: FasterRCNN
    optimizer: "ChainOptimizer"
    generator: torch.Generator
    step: int = 0
    graphs: Dict[tuple, "CapturedSteps"] = dataclasses.field(default_factory=dict, repr=False)


def _schedule_knobs(config: FasterRCNNConfig, steps_per_epoch: int) -> Tuple[float, int]:
    """(peak lr, warmup steps), shared by the device and host schedules:
    under ``lr_scaling="linear"`` the peak scales by ``batch_size /
    base_batch_size`` (arXiv:1711.04325), and ``warmup_epochs`` ramps the lr
    linearly to that peak before the cosine takes over."""
    tc = config.train
    scale = tc.batch_size / tc.base_batch_size if tc.lr_scaling == "linear" else 1.0
    warmup_steps = int(round(tc.warmup_epochs * max(steps_per_epoch, 1)))
    return tc.lr * scale, warmup_steps


def _leaf_norms(x: Tensor, sizes) -> Tensor:
    """The L2 norm of each leaf of a flat vector ([L] float32)."""
    return torch.stack([torch.sum(torch.square(v)) for v in x.split(sizes)]).sqrt()


class ChainOptimizer:
    """optax's ``chain(add_decayed_weights(wd), scale_by_adam(mu_dtype),
    [scale_by_trust_ratio], scale_by_learning_rate(schedule))`` over a list
    of float32 parameters, on their device.

    State (optax's): ``mu`` [P] in ``adam_mu_dtype`` and ``nu`` [P] float32,
    the parameters' moments laid end to end in parameter order, and
    ``count`` (int32, 0-dim) — the updates applied, which both Adam's bias
    correction and the schedule read. :meth:`update` computes one step from
    flat gradients and parameters and commits it, or keeps every tensor as
    it was where a device predicate says so, without a host read.
    ``state_dict`` / ``load_state_dict`` give and take that state (copied in
    place, so a captured CUDA graph stays valid)."""

    def __init__(self, params, config: FasterRCNNConfig, steps_per_epoch: int):
        tc = config.train
        self.params = [p for p in params]
        if not self.params:
            raise ValueError("the optimizer got no parameters")
        dev = self.params[0].device
        self.sizes = [p.numel() for p in self.params]
        n = sum(self.sizes)
        self.weight_decay = tc.weight_decay
        # lars and lamb apply the same trust ratio after Adam; the config
        # refuses both at once
        self.trust_ratio = tc.lars or tc.optimizer == "lamb"
        self.mu_dtype = getattr(torch, tc.adam_mu_dtype)
        self.mu = torch.zeros(n, dtype=self.mu_dtype, device=dev)
        # JAX multiplies a bfloat16 mu by b1 rounded to bfloat16 (a Python
        # scalar takes the array's dtype); exact for float32
        self._b1_mu = float(torch.tensor(ADAM_B1, dtype=self.mu_dtype))
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.peak, self.warmup_steps = _schedule_knobs(config, steps_per_epoch)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.n_epoch = tc.n_epoch
        # the leaf sizes on the device, for the trust ratio's expansion
        self._sizes = torch.tensor(self.sizes, dtype=torch.int64, device=dev)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def leaves(self, flat: Tensor):
        """Views of a flat [P] vector shaped like the parameters."""
        return [v.view(p.shape) for v, p in zip(flat.split(self.sizes), self.params)]

    def lr(self, count: Optional[Tensor] = None) -> Tensor:
        """The schedule at ``count`` (default: the state's), a float32 0-dim
        tensor on the device: ``peak * 0.5 * (1 + cos(pi * epoch /
        n_epoch))``, epoch = min(count // steps_per_epoch, n_epoch), and
        ``peak * (count + 1) / warmup_steps`` during the warmup."""
        count = self.count if count is None else count
        epoch = torch.clamp(torch.div(count, self.steps_per_epoch, rounding_mode="floor"),
                            max=self.n_epoch)
        lr = (self.peak * 0.5) * (1.0 + torch.cos(math.pi * epoch.float() / self.n_epoch))
        if self.warmup_steps > 0:
            warm = self.peak * (count.float() + 1.0) / self.warmup_steps
            lr = torch.where(count < self.warmup_steps, warm, lr)
        return lr

    def update(self, grads: Tensor, params: Tensor, ok: Optional[Tensor]) -> Tensor:
        """One step from flat float32 ``grads`` and ``params`` [P]. Commits
        the new parameters, moments and count where ``ok`` (a 0-dim bool
        tensor; None commits unconditionally) and keeps the old values
        bitwise otherwise. Returns the chain's update [P] (what it adds to
        the parameters)."""
        b1, b2 = ADAM_B1, ADAM_B2
        u = grads + self.weight_decay * params
        # optax's formulas; a bfloat16 mu enters as b1 * mu rounded to bfloat16
        mu = (1 - b1) * u + self._b1_mu * self.mu
        nu = (1 - b2) * (u * u) + b2 * self.nu
        count = self.count + (self.count < _INT32_MAX).to(torch.int32)
        t = count.float()
        mu_hat = mu / (1 - torch.pow(b1, t))
        nu_hat = nu / (1 - torch.pow(b2, t))
        u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
        if self.trust_ratio:
            pn, un = _leaf_norms(params, self.sizes), _leaf_norms(u, self.sizes)
            ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
            u = u * ratio.repeat_interleave(self._sizes, output_size=u.numel())
        delta = -self.lr() * u
        new_params = params + delta
        mu = mu.to(self.mu_dtype)
        if ok is None:
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.count.copy_(count)
        else:
            # a select, not masking: the untaken side's NaN never propagates
            torch.where(ok, mu, self.mu, out=self.mu)
            torch.where(ok, nu, self.nu, out=self.nu)
            torch.where(ok, count, self.count, out=self.count)
            new_params = torch.where(ok, new_params, params)
        live = [p.detach() for p in self.params]
        torch._foreach_copy_(live, self.leaves(new_params))
        return delta

    def state_dict(self) -> Dict[str, Tensor]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: Dict[str, Tensor]) -> None:
        """Copy ``state`` in place. A checkpoint of another layout (the
        ``torch.optim.Adam`` + ``LambdaLR`` state of earlier versions:
        ``state`` / ``param_groups``) is refused."""
        if set(state) != {"mu", "nu", "count"}:
            raise ValueError(
                f"optimizer state with keys {sorted(state)} is not this optimizer's layout "
                "(mu, nu, count: optax's chain): checkpoints of the earlier torch.optim.Adam "
                "+ LambdaLR layout (exp_avg, exp_avg_sq, step, scheduler) do not restore; "
                "start from the weights instead")
        for name in ("mu", "nu", "count"):
            live, new = getattr(self, name), state[name]
            if new.shape != live.shape or new.dtype != live.dtype:
                raise ValueError(
                    f"optimizer state {name!r}: {new.dtype} {tuple(new.shape)} does not fit "
                    f"{live.dtype} {tuple(live.shape)} (another model, or adam_mu_dtype changed)")
            live.copy_(new)


def make_optimizer(
    config: FasterRCNNConfig, params, steps_per_epoch: int
) -> Tuple[ChainOptimizer, Callable[[Tensor], Tensor]]:
    """(the optimizer, its schedule count -> lr on the device), as the JAX
    ``make_optimizer`` returns (tx, schedule): Adam with L2 weight decay
    added to the gradient (torch Adam's ``weight_decay``, not AdamW), a
    per-epoch cosine, the optional warmup, lr scaling and trust ratio."""
    optimizer = ChainOptimizer(params, config, steps_per_epoch)
    return optimizer, optimizer.lr


def host_schedule(config: FasterRCNNConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The schedule's lr at a step, in plain Python (for log rows): the same
    formula as :meth:`ChainOptimizer.lr` (cosine, linear warmup, lr
    scaling), in double precision."""
    tc = config.train
    peak, warmup_steps = _schedule_knobs(config, steps_per_epoch)

    def schedule(step: int) -> float:
        epoch = min(int(step) // max(steps_per_epoch, 1), tc.n_epoch)
        lr = peak * 0.5 * (1.0 + math.cos(math.pi * epoch / tc.n_epoch))
        if warmup_steps > 0 and int(step) < warmup_steps:
            lr = peak * (int(step) + 1.0) / warmup_steps
        return float(lr)

    return schedule


def create_train_state(
    config: FasterRCNNConfig,
    steps_per_epoch: int,
    device: DeviceLike = None,
    seed: int = 0,
) -> TrainState:
    """A seeded model in training mode with its optimizer and a device
    generator seeded from ``seed``."""
    dev = resolve_device(device)
    model = build_model(config, device=dev, seed=seed).train()
    optimizer, _ = make_optimizer(config, model.parameters(), steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model, optimizer, generator)


def pending_batch_stats(model: torch.nn.Module) -> fault.PendingStats:
    """The new BatchNorm running statistics the last training forward left:
    none for a GroupNorm model (no BatchNorm) or a ``frozen_bn`` one (its
    BatchNorms apply their running statistics), so the update commits no
    statistics and the buffers stay bitwise."""
    return [
        (m, m.pending_stats)
        for m in model.modules()
        if isinstance(m, BatchNorm) and m.pending_stats is not None
    ]


def augment_prologue(
    config: FasterRCNNConfig,
    batch: Dict[str, Tensor],
    train_resolution: Optional[Tuple[int, int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The JAX step's input prologue: (images, boxes, labels, mask) after
    the ``jitter`` resample (the boxes came transformed from the host), the
    ``aug`` augmentation (flip, translation, scale jitter from the draws of
    (``train.seed``, epoch, idx)) and the ``train_resolution`` bucket
    resample, in that order; kernels on the card (``ops/image.py``)."""
    from replication_faster_rcnn_tpu_torch.ops import image as image_ops

    images = batch["image"]
    if "jitter" in batch:
        images = image_ops.batched_scale_jitter(images, batch["jitter"])
    gt_boxes, gt_labels, gt_mask = batch["boxes"], batch["labels"], batch["mask"]
    if "aug" in batch:
        data = config.data
        images, gt_boxes, gt_labels, gt_mask = image_ops.augment_batch(
            images, gt_boxes, gt_labels, gt_mask, batch["aug"], seed=config.train.seed,
            hflip=data.augment_hflip, scale_range=data.augment_scale,
            translate=data.augment_translate)
    if train_resolution is not None:
        images, gt_boxes = image_ops.resize_batch_with_boxes(images, gt_boxes, train_resolution)
    return images, gt_boxes, gt_labels, gt_mask


def compute_losses(
    model: FasterRCNN,
    config: FasterRCNNConfig,
    batch: Dict[str, Tensor],
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, Tensor]] = None,
    record: Optional[dict] = None,
    stage: StageFn = _no_stage,
    train_resolution: Optional[Tuple[int, int]] = None,
) -> Tuple[Tensor, Tuple[Dict[str, Tensor], fault.PendingStats]]:
    """Forward + 4 losses on a device batch (``image`` [N, H, W, 3],
    ``boxes`` [N, G, 4], ``labels`` [N, G], ``mask`` [N, G], and ``jitter`` or
    ``aug`` from the augmenting feeds). Returns (total, (metrics, new
    BatchNorm statistics)).

    ``draws`` injects the uniforms by name (:data:`DRAW_NAMES`) and a VGG16
    tail's keep masks (:data:`KEEP_MASK_NAMES`); missing ones come from
    ``generator``. ``record``, when given, receives the draws used (masks
    included) and the targets (``rpn_reg``, ``rpn_labels``,
    ``sample_rois``, ``roi_reg``, ``roi_labels``). ``train_resolution``
    resamples the batch to one multi-scale bucket (:func:`augment_prologue`)."""
    with stage("augment"):
        images, gt_boxes, gt_labels, gt_mask = augment_prologue(config, batch, train_resolution)
    img_h, img_w = float(images.shape[1]), float(images.shape[2])
    sigma = config.train.smooth_l1_sigma
    used = dict(draws or {})

    def draw(name: str, shape) -> Tensor:
        if name not in used:
            if generator is None:
                raise ValueError(f"draw {name!r} was not injected and no generator was given")
            used[name] = draw_uniform(generator, shape, images.device)
        return used[name]

    with stage("trunk"):
        feat = model.extract_features(images)
    with stage("rpn"):
        logits, deltas, anchors = model.rpn_forward(feat)
    n, a = logits.shape[:2]
    with stage("anchor_targets"):
        reg_t, lab_t = batched_anchor_targets(
            gt_boxes, gt_mask, anchors, config.rpn_targets,
            draw("rpn_pos", (n, a)), draw("rpn_neg", (n, a)),
        )
    with stage("losses"):
        rpn_reg_loss = losses.loc_loss(deltas, reg_t, lab_t, sigma)
        rpn_cls_loss = losses.ignore_cross_entropy(logits, lab_t)
    with stage("proposals"):
        rois, roi_valid = model.propose(logits, deltas, anchors, img_h, img_w, train=True)
    n_cand = (n, rois.shape[1] + gt_boxes.shape[1])
    with stage("proposal_targets"):
        sample_rois, reg_t2, lab_t2 = batched_proposal_targets(
            rois, roi_valid, gt_boxes, gt_labels, gt_mask, config.roi_targets,
            draw("roi_pos", n_cand), draw("roi_neg", n_cand), draw("roi_pack", n_cand),
            strategy=config.train.sampling_strategy,
        )
    with stage("head"):
        cls_out, reg_out = model.head_forward(feat, sample_rois, img_h, img_w,
                                              generator=generator, masks=used)
    with stage("losses"):
        reg_sel = select_class_deltas(reg_out, lab_t2)
        head_reg_loss = losses.loc_loss(reg_sel, reg_t2, lab_t2, sigma)
        head_cls_loss = losses.ignore_cross_entropy(cls_out, lab_t2)
        w1, w2, w3, w4 = config.train.loss_weights
        total = w1 * rpn_cls_loss + w2 * rpn_reg_loss + w3 * head_cls_loss + w4 * head_reg_loss
    if record is not None:
        record["draws"] = used
        record["targets"] = {
            "rpn_reg": reg_t, "rpn_labels": lab_t, "sample_rois": sample_rois,
            "roi_reg": reg_t2, "roi_labels": lab_t2,
        }
    metrics = {
        "loss": total.detach(),
        "rpn_cls_loss": rpn_cls_loss.detach(),
        "rpn_reg_loss": rpn_reg_loss.detach(),
        "head_cls_loss": head_cls_loss.detach(),
        "head_reg_loss": head_reg_loss.detach(),
        "n_pos_rpn": (lab_t == 1).sum().float(),
        "n_pos_head": (lab_t2 > 0).sum().float(),
    }
    return total, (metrics, pending_batch_stats(model))


# the step's metrics, in the order of the stacked vector a step returns
METRIC_NAMES = (
    "loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss",
    "n_pos_rpn", "n_pos_head", "grad_norm", "param_norm", "update_norm", "update_ratio",
    "nonfinite_count", "skipped",
)
# the batch keys a step reads, by feed: the loader's (with ``jitter`` from
# augment_scale_device and ``aug`` from augment_device) and the device
# cache's selections
BATCH_KEYS = ("image", "boxes", "labels", "mask", "jitter", "aug")
SELECTION_KEYS = ("idx", "flip", "jitter")


def step_keys(batch: Dict[str, Tensor]) -> Tuple[str, ...]:
    """The keys of ``batch`` the step reads (its feed's), in a fixed order."""
    keys = SELECTION_KEYS if "idx" in batch else BATCH_KEYS
    return tuple(k for k in keys if k in batch)


def unstack_metrics(stacked: Tensor) -> Dict[str, Tensor]:
    """A step's stacked metrics ([M], or [K, M] for K steps) as a dict of
    float32 views ([] or [K]) by :data:`METRIC_NAMES`."""
    return {k: stacked[..., i] for i, k in enumerate(METRIC_NAMES)}


class CapturedSteps:
    """K training steps of one batch signature as one CUDA graph.

    The first call runs its K steps eagerly on the graph's own side stream
    (real steps: they train and draw from the generator), then captures the
    same K steps on that stream — a capture only records, so it trains
    nothing and draws nothing — and every later call copies its batches
    into the graph's static inputs and replays it. The state's generator is
    registered with the graph, so each replay draws fresh uniforms from its
    current Philox offset and advances it as the eager steps would; the
    parameters, optimizer state and BatchNorm statistics are the state's
    own tensors, updated in place. ``share`` is another graph of the same
    state, whose side stream and memory pool this one captures on and into:
    the graphs of one state replay one at a time on the caller's stream, so
    they hold one pool rather than one each (the allocator reuses a pool's
    blocks only on the stream that freed them).

    The kernel wrappers count a launch when Python calls them: the capture's
    calls count once, and a replay, which calls no Python, counts nothing.

    A ``model.remat`` step captures like any other: the recomputation of
    each checkpointed block runs inside the captured backward (no RNG state
    is saved, ``models/resnet.py::run_blocks``). A capture that fails
    raises; nothing falls back to eager steps. One that fails so: a loss the caller still holds from an eager backward on
    another stream keeps the parameters' gradient accumulators, made on
    that stream, alive, and the capture's backward may not wait on it."""

    def __init__(self, run: Callable, k: int, device: torch.device,
                 share: Optional["CapturedSteps"] = None):
        self.run, self.k, self.device = run, k, device
        self.stream = torch.cuda.Stream(device) if share is None else share.stream
        self.pool = None if share is None else share.graph.pool()
        self.graph = None
        self.static_in = None
        self.static_out = None

    def __call__(self, state: TrainState, batches) -> Tensor:
        if self.graph is None:
            out = self._warm_up(state, batches)
            self._capture(state, batches)
            return out
        for static, batch in zip(self.static_in, batches):
            for key, t in static.items():
                t.copy_(batch[key])
        state.model.train()  # what the step's Python does; the graph trains either way
        self.graph.replay()
        # a copy: the next replay overwrites the static output
        return self.static_out.clone()

    def _warm_up(self, state, batches) -> Tensor:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = torch.stack([self.run(state, b) for b in batches])
        current.wait_stream(self.stream)
        return out

    def _capture(self, state, batches) -> None:
        self.static_in = [{key: b[key].clone() for key in step_keys(b)} for b in batches]
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): the captured step would repeat one "
                "Philox offset on every replay")
        graph.register_generator_state(state.generator)
        state.optimizer.zero_grad()
        try:
            # thread_local: a prefetch producer thread may wait on its own
            # copy's event meanwhile; only this thread's calls are checked
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.static_out = torch.stack([self.run(state, b) for b in self.static_in])
        except Exception as e:
            raise RuntimeError(f"capturing {self.k} train step(s) as a CUDA graph failed: "
                               f"{type(e).__name__}: {e}") from e
        self.graph = graph


def make_train_step(config: FasterRCNNConfig, capture: bool = True,
                    cache: Optional[Dict[str, Tensor]] = None):
    """(state, batch, draws=None, record=None, stage=..., resolution=None) ->
    metrics: one optimizer step, gated by ``train.nonfinite_policy``. The
    metrics are 0-dim float32 device tensors (views of one stacked vector,
    :data:`METRIC_NAMES`); nothing is read on the host. ``resolution`` is a
    ``data.train_resolutions`` bucket ((h, w) or None).

    With ``capture`` a CUDA batch runs through a CUDA graph
    (:class:`CapturedSteps`) kept in ``state.graphs``, one per (K, batch
    signature, bucket); a CPU batch, and ``draws``, ``record`` and ``stage``,
    always run eagerly. The returned function's ``chunk(state, batches,
    resolution=None)`` trains ``len(batches)`` steps in one dispatch (one
    replay of a K-step graph on the card) and returns [K] metrics.

    ``cache`` (a ``DeviceCache``'s tensors) makes the step the cached one:
    its batches are selections (``idx``, ``flip``, ``jitter``), and the
    batch is materialized from the cache inside the step (read in place;
    the cache is never copied into a graph)."""
    policy = config.train.nonfinite_policy

    def run(state, batch, draws=None, record=None, stage=_no_stage, resolution=None) -> Tensor:
        if cache is not None:
            from replication_faster_rcnn_tpu_torch.data.device_cache import materialize_batch

            with stage("materialize"):
                batch = materialize_batch(cache, batch, resample=True)
        model = state.model.train()
        state.optimizer.zero_grad()
        total, (metrics, new_stats) = compute_losses(
            model, config, batch, state.generator, draws, record, stage, resolution
        )
        with stage("backward"):
            total.backward()
        with stage("optimizer"):
            health = fault.guarded_update(
                state.optimizer, list(model.parameters()), new_stats, policy)
        metrics.update(health)
        return torch.stack([metrics[k].float() for k in METRIC_NAMES])

    def dispatch(state, batches, resolution) -> Tensor:
        first = batches[0][step_keys(batches[0])[0]]
        on_card = first.is_cuda if cache is None else cache["image"].is_cuda
        if not (capture and on_card):
            return torch.stack([run(state, b, resolution=resolution) for b in batches])
        sig = tuple((k, b[k].dtype, tuple(b[k].shape)) for b in batches for k in step_keys(b))
        key = (config, len(batches), sig, resolution, cache is not None)
        graph = state.graphs.get(key)
        if graph is None:
            share = next((g for g in state.graphs.values() if g.graph is not None), None)
            dev = cache["image"].device if cache is not None else first.device
            graph = state.graphs[key] = CapturedSteps(
                lambda st, b: run(st, b, resolution=resolution), len(batches), dev, share)
        return graph(state, batches)

    def train_step(
        state: TrainState,
        batch: Dict[str, Tensor],
        draws: Optional[Dict[str, Tensor]] = None,
        record: Optional[dict] = None,
        stage: StageFn = _no_stage,
        resolution: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, Tensor]:
        if draws is None and record is None and stage is _no_stage:
            out = dispatch(state, [batch], resolution)[0]
        else:
            out = run(state, batch, draws, record, stage, resolution)
        state.step += 1
        return unstack_metrics(out)

    def chunk(state: TrainState, batches, resolution=None) -> Dict[str, Tensor]:
        out = dispatch(state, list(batches), resolution)
        state.step += len(batches)
        return unstack_metrics(out)

    train_step.chunk = chunk
    return train_step


def make_cached_train_step(config: FasterRCNNConfig, cache: Dict[str, Tensor],
                           capture: bool = True):
    """The device-cache step: (state, sel, ...) -> metrics, the batch
    gathered, flipped and jittered from ``cache`` (a ``DeviceCache``'s
    tensors) inside the step; its ``chunk`` is JAX's
    ``make_cached_multi_step``. The selection is all the host ships."""
    return make_train_step(config, capture=capture, cache=cache)
