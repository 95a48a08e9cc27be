"""Benchmark: train-step throughput of the flagship config on the card
(counterpart of the JAX package's ``benchmark.py``).

Run from the repository root: ``python -m replication_faster_rcnn_tpu_torch.benchmark``
(``BENCH_MODE=eval`` for the inference throughput; ``BENCH_PROFILE_DIR=<dir>``
adds a ``torch.profiler`` capture of ``TRACE_STEPS`` more steps after the
measurement, the profiler's first step left out). It runs on ``cuda``; there is no CPU fallback
(``main(device="cpu")`` measures the plain PyTorch path on the CPU, for
tests). If the whole run, capture, FLOP count and breakdown included, has
not finished within ``BENCH_WATCHDOG_S`` (default 1500) seconds, it prints
an error line and exits 2.

Prints ONE JSON line with the JAX package's keys: {"metric", "value",
"unit", "vs_baseline", "flops_per_step", "mfu", "mfu_basis"} and — unless
BENCH_BREAKDOWN=0 — a per-stage "breakdown".

Metric: VOC-shaped (600x600, synthetic tensors — dataset-independent)
training images/sec of ``voc_resnet18`` at batch ``BENCH_BATCH`` (default
16): ``WARMUP_STEPS`` steps, then ``BENCH_STEPS`` (default 10) timed steps
with one synchronisation after the loop. On the card the step is the one
users run, captured as a CUDA graph (``train/train_step.py::
CapturedSteps``; the first warm-up step runs eagerly and captures, the
others replay), as the JAX bench times its jitted step; ``BENCH_CAPTURE=0``
times the eager step instead (same line, same keys). ``vs_baseline`` is the
ratio against the measured single-host PyTorch-CPU reference throughput in
``benchmarks/baseline_measured.json`` (read only).

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one full step at
the measured batch, with convolution formulas that count only the kernel
taps that fall inside the input, as XLA's HloCostAnalysis (the JAX
package's counter) does: a 3x3 window on a 7x7 map is ~30% padding, and
the stock formula's full windows over-count the step by ~1.2x. Each
convolution backward counts each gradient its ``output_mask`` asks for.
Matmuls use the stock formulas; elementwise work is not counted (XLA counts
it: the step comes out ~3% under the JAX count). The hand-written CUDA
kernels are not torch operators and are not counted (HloCostAnalysis does
not count the JAX package's Pallas calls either).

MFU: ``achieved_flops / (time x peak)`` against the card's dense bf16
datasheet peak (``telemetry/mfu.py``); ``mfu_basis`` labels the regime.

Stage breakdown: the JAX keys, from the train step's ``stage(name)`` hooks
timed with CUDA events over ``STAGE_STEPS`` steps (the mean); the events
time the device timeline between the hooks, idle gaps included, so the
stages of a host-bound step show its host time (the breakdown's steps run
eagerly: a graph has no hooks). With FPN (``voc_resnet50_fpn``) the trunk
hook wraps ``extract_features`` and so times every level, the neck's
included, as the JAX prefix sums every level. ``opt_update_direct_ms`` is the optimizer's
update alone (``ChainOptimizer.update`` on flat zero gradients, eager),
``dispatch_floor_ms`` one launch and one sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device

# failure-path metric label; refined to the actual mode/shape as soon as the
# measurement resolves its config
_METRIC = "train_images_per_sec_600x600"

WARMUP_STEPS = 3  # untimed steps before the timed loop (and before eval's)
STAGE_STEPS = 5  # steps whose stage hooks the breakdown averages
TRACE_STEPS = 3  # steps (or eval batches) captured with a profile_dir
TRACE_WARMUP_STEPS = 1  # steps under the profiler before its capture starts

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wedge_exit(reason: str):
    print(
        json.dumps(
            {
                "metric": _METRIC,
                "value": 0.0,
                "unit": "images/sec",
                "vs_baseline": None,
                "error": reason,
            }
        ),
        flush=True,
    )
    os._exit(2)


def _arm_watchdog() -> threading.Timer:
    """Print the error line and exit 2 if the run has not finished within
    BENCH_WATCHDOG_S (default 1500) seconds, so a hung card leaves a record
    instead of a silent process. Returns the timer; cancel it once the run
    completes."""
    budget = float(os.environ.get("BENCH_WATCHDOG_S", "1500"))
    t = threading.Timer(
        budget,
        lambda: _wedge_exit(f"watchdog: the measurement did not finish within {budget:.0f}s"),
    )
    t.daemon = True
    t.start()
    return t


def main(config=None, profile_dir=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Measure ``config`` (default: the flagship voc_resnet18 at 600x600,
    batch 16) on ``device`` (default ``cuda``, raising without a GPU) and
    print its line; ``BENCH_MODE=eval`` measures inference instead.
    ``profile_dir`` adds a ``torch.profiler`` capture of a few more steps
    after the measurement. One watchdog covers the whole run. Returns the
    printed record."""
    eval_mode = os.environ.get("BENCH_MODE", "train") == "eval"
    global _METRIC
    shape = "600x600" if config is None else "{}x{}".format(*config.data.image_size)
    _METRIC = ("eval" if eval_mode else "train") + f"_images_per_sec_{shape}"
    dev = resolve_device(device)
    watchdog = _arm_watchdog()
    try:
        if eval_mode:
            return _measure_eval(config, profile_dir, device=dev)
        return _measure(config, profile_dir, device=dev)
    finally:
        # a raised exception must not leave the timer alive to later print a
        # bogus zero-metric line and exit the host process
        watchdog.cancel()


def _flagship_cfg():
    """The bench default config: voc_resnet18 at 600x600 on synthetic
    tensors. One definition shared by the train and eval measurements so
    the flagship shape cannot drift between the two metrics."""
    from replication_faster_rcnn_tpu_torch.config import DataConfig, get_config

    return get_config("voc_resnet18").replace(
        data=DataConfig(dataset="synthetic", image_size=(600, 600), max_boxes=32),
    )


def _synthetic_batch(cfg, batch_size: int) -> Dict[str, np.ndarray]:
    from replication_faster_rcnn_tpu_torch.data.loader import collate
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cfg.data, length=batch_size)
    return collate([ds[i] for i in range(batch_size)])


def _timed_step(cfg, batch_size: int, dev: torch.device, capture: bool):
    """(step, device batch) of the train measurement, as the JAX bench's
    ``_measure`` builds them: the fed step on one synthetic batch; with
    ``data.augment_scale`` the batch's jitter geometry (device mode: the
    on-card resample is part of the timed step) or its host-jittered images;
    with ``data.augment_device`` the ``aug`` rows (the on-card augmentation
    is part of the step); with ``data.cache_device`` the cached step over a
    resident synthetic cache, timed on one selection."""
    from replication_faster_rcnn_tpu_torch.data.augment import AugmentedView, AugmentTagView
    from replication_faster_rcnn_tpu_torch.data.loader import collate
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.train.train_step import (
        make_cached_train_step,
        make_train_step,
        step_keys,
    )

    data = cfg.data
    if data.cache_device:
        from replication_faster_rcnn_tpu_torch.data.device_cache import CachedSampler, DeviceCache

        base = SyntheticDataset(data, length=max(2 * batch_size, 64))
        cache = DeviceCache(base, device=dev)
        sampler = CachedSampler(len(base), cache.image_hw, batch_size=batch_size, seed=0,
                                hflip=data.augment_hflip, scale_range=data.augment_scale)
        sel = sampler.selection(np.arange(batch_size) % len(base))
        return (make_cached_train_step(cfg, cache.arrays, capture=capture),
                {k: torch.from_numpy(v).to(dev) for k, v in sel.items()})
    ds = SyntheticDataset(data, length=batch_size)
    if data.augment_device and (data.augment_hflip or data.augment_scale
                                or data.augment_translate):
        ds = AugmentTagView(ds, epoch=0)
    elif data.augment_scale:
        ds = AugmentedView(ds, seed=0, epoch=0, hflip=False, scale_range=data.augment_scale,
                           scale_on_device=data.augment_scale_device)
    batch = collate([ds[i] for i in range(batch_size)])
    return (make_train_step(cfg, capture=capture),
            {k: torch.from_numpy(batch[k]).to(dev) for k in step_keys(batch)})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _capture_trace(profile_dir, run: Callable[[], Any], device: torch.device,
                   n_steps: Optional[int] = None) -> str:
    """Short ``torch.profiler`` capture of ``n_steps`` more calls of the
    already-warm ``run`` (after ``TRACE_WARMUP_STEPS`` uncaptured ones under
    the profiler), after the measurement. Each call is waited for before the
    profiler's next step: a captured step returns long before the card has
    run it, and without the wait an earlier step's kernels would land in a
    later step's window. Returns "ok" or, when the capture raised, the
    reason (the metric is kept)."""
    from replication_faster_rcnn_tpu_torch.utils.profiling import trace

    n_steps = TRACE_STEPS if n_steps is None else n_steps
    try:
        with trace(profile_dir, warmup_steps=TRACE_WARMUP_STEPS) as step:
            for _ in range(TRACE_WARMUP_STEPS + n_steps):
                run()
                _sync(device)
                step()
        return "ok"
    except Exception as e:
        return f"failed: {e!r}"


def _vs_baseline(images_per_sec: float) -> Optional[float]:
    path = os.path.join(_REPO, "benchmarks", "baseline_measured.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        ref = json.load(f).get("torch_cpu_images_per_sec")
    return round(images_per_sec / ref, 3) if ref else None


def _measure(config=None, profile_dir=None, device: DeviceLike = None) -> Dict[str, Any]:
    from replication_faster_rcnn_tpu_torch.config import TrainConfig
    from replication_faster_rcnn_tpu_torch.telemetry.mfu import compute_mfu, peak_flops_per_sec
    from replication_faster_rcnn_tpu_torch.train.train_step import create_train_state

    dev = resolve_device(device)
    if config is None:
        batch_size = int(os.environ.get("BENCH_BATCH", "16"))
        cfg = _flagship_cfg().replace(train=TrainConfig(batch_size=batch_size))
    else:
        # honour the caller's model/image/batch choices; force synthetic data
        # (a dataset-independent measurement)
        cfg = config.replace(data=dataclasses.replace(config.data, dataset="synthetic"))
        batch_size = cfg.train.batch_size
    global _METRIC
    _METRIC = "train_images_per_sec_{}x{}".format(*cfg.data.image_size)
    state = create_train_state(cfg, steps_per_epoch=100, device=dev, seed=0)
    capture = os.environ.get("BENCH_CAPTURE", "1") != "0"
    step, device_batch = _timed_step(cfg, batch_size, dev, capture)

    for _ in range(WARMUP_STEPS):
        metrics = step(state, device_batch)
    _sync(dev)
    n_steps = int(os.environ.get("BENCH_STEPS", "10"))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        metrics = step(state, device_batch)
    _sync(dev)  # waits for the whole dependency chain
    dt = time.perf_counter() - t0
    del metrics
    images_per_sec = n_steps * batch_size / dt

    # the trace runs AFTER the primary measurement, never around it
    trace_status = None
    if profile_dir is not None:
        trace_status = _capture_trace(profile_dir, lambda: step(state, device_batch), dev)

    # counted on an eager step: a graph replay runs no torch operator
    flops_per_step = _step_flops(_timed_step(cfg, batch_size, dev, False)[0], state,
                                 device_batch)
    peak, mfu_basis = peak_flops_per_sec(1, dev)
    mfu = compute_mfu(flops_per_step, images_per_sec / batch_size, peak)
    if mfu is None:
        mfu_basis = None

    out: Dict[str, Any] = {
        "metric": _METRIC,
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": _vs_baseline(images_per_sec),
        "flops_per_step": flops_per_step,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "mfu_basis": mfu_basis,
    }
    if trace_status is not None:
        out["trace"] = trace_status
    if out["mfu"] is None and dev.type == "cpu":
        # a CPU record carries MFU on the measured-matmul basis or fails
        # loudly (exit 3 with ``mfu_error``), as the JAX bench does
        out["mfu_error"] = "cpu record produced no MFU (no FLOP count or no measured peak)"
        print(json.dumps(out), flush=True)
        os._exit(3)
    if os.environ.get("BENCH_BREAKDOWN", "1") != "0":
        step_ms = dt / n_steps * 1e3
        try:
            out["breakdown"] = _stage_breakdown(cfg, step, state, device_batch, step_ms, dev)
        except Exception as e:  # an exception annotates the line; the metric stays
            out["breakdown"] = {"error": repr(e)}
    print(json.dumps(out), flush=True)
    return out


def _measure_eval(config=None, profile_dir=None, device: DeviceLike = None) -> Dict[str, Any]:
    """``BENCH_MODE=eval``: inference throughput — forward + decode +
    per-class NMS (``eval/evaluator.py::make_infer_fn``) on synthetic images
    already on the card, images/sec.

    ``vs_baseline`` is null by design: the reference has no inference/eval
    path to race against."""
    from replication_faster_rcnn_tpu_torch.eval.evaluator import make_infer_fn
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model

    dev = resolve_device(device)
    if config is None:
        cfg = _flagship_cfg()
    else:
        cfg = config.replace(data=dataclasses.replace(config.data, dataset="synthetic"))
    global _METRIC
    _METRIC = "eval_images_per_sec_{}x{}".format(*cfg.data.image_size)
    # batch precedence: BENCH_EVAL_BATCH > the caller's train.batch_size > 8
    if "BENCH_EVAL_BATCH" in os.environ:
        batch_size = int(os.environ["BENCH_EVAL_BATCH"])
    elif config is not None:
        batch_size = cfg.train.batch_size
    else:
        batch_size = 8
    model = build_model(cfg, device=dev, seed=0).eval()
    infer = make_infer_fn(model, cfg)
    images = _synthetic_batch(cfg, batch_size)["image"]
    # upload once, queue every call, one synchronisation at the end
    images_dev = torch.from_numpy(images).to(dev)
    for _ in range(WARMUP_STEPS):
        out = infer(images_dev)
    _sync(dev)
    n_steps = int(os.environ.get("BENCH_STEPS", "10"))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = infer(images_dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    del out
    value = round(n_steps * batch_size / dt, 3)
    record: Dict[str, Any] = {
        "metric": _METRIC,
        "value": value,
        "unit": "images/sec",
        "vs_baseline": None,
        "batch_size": batch_size,
        "note": "reference has no eval/inference path (empty "
        "test_eval.py); no baseline ratio exists",
    }
    if profile_dir is not None:
        record["trace"] = _capture_trace(profile_dir, lambda: infer(images_dev), dev)
    print(json.dumps(record), flush=True)
    return record


# ----------------------------------------------------------------- FLOPs


def in_bounds_taps(in_size: int, kernel: int, stride: int, padding: int,
                   dilation: int, out_size: int) -> int:
    """Along one spatial dimension: the (output position, kernel tap) pairs
    whose input index falls inside ``[0, in_size)`` — the taps that do not
    land on the zero padding."""
    taps = 0
    for o in range(out_size):
        first = o * stride - padding
        taps += sum(1 for k in range(kernel) if 0 <= first + k * dilation < in_size)
    return taps


def _conv_in_bounds(x_shape: Sequence[int], w_shape: Sequence[int], stride, padding,
                    dilation, transposed: bool, out_spatial: Sequence[int]) -> int:
    if transposed:
        raise NotImplementedError("no in-bounds FLOP formula for a transposed convolution")
    n, c_out, c_in_per_group = x_shape[0], w_shape[0], w_shape[1]
    dims = len(w_shape) - 2
    taps = 1
    for d in range(dims):
        taps *= in_bounds_taps(x_shape[2 + d], w_shape[2 + d], stride[d], padding[d],
                               dilation[d], out_spatial[d])
    return 2 * n * c_out * c_in_per_group * taps


def conv_flop(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
              out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten.convolution``: 2 x batch x out channels x in channels
    per group x the in-bounds taps (XLA's convention)."""
    return _conv_in_bounds(x_shape, w_shape, stride, padding, dilation, transposed,
                           out_shape[2:])


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                       transposed, _output_padding, _groups, output_mask, out_shape=None,
                       **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``: the forward's in-bounds count
    once for each gradient ``output_mask`` asks for (input, weight; the
    bias gradient is a sum, not counted)."""
    fwd = _conv_in_bounds(x_shape, w_shape, stride, padding, dilation, transposed,
                          grad_out_shape[2:])
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


FLOP_FORMULAS = {
    torch.ops.aten.convolution: conv_flop,
    torch.ops.aten.convolution_backward: conv_backward_flop,
}


def count_flops(fn: Callable[[], Any]) -> int:
    """FLOPs of the torch operators ``fn()`` runs, with the in-bounds
    convolution formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS) as counter:
        fn()
    return counter.get_total_flops()


def _step_flops(step, state, device_batch) -> float:
    """FLOPs of one full train step at the measured batch (one more step of
    ``state``, counted)."""
    return float(count_flops(lambda: step(state, device_batch)))


# ------------------------------------------------------------- breakdown


class _HostEvent:
    """``torch.cuda.Event``'s timing interface on the host clock, for the
    CPU (where every operator has finished when it returns)."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def _stage_breakdown(cfg, step, state, device_batch, step_ms: float,
                     device: torch.device) -> Dict[str, float]:
    """Time attribution across the step's stages, under the JAX keys.

    The step's ``stage(name)`` hooks record an event at each stage's entry
    and exit; over ``STAGE_STEPS`` steps each stage's mean is taken. The
    hooks map onto the JAX prefixes: trunk -> trunk, rpn -> rpn_heads,
    proposals -> proposal_nms, anchor + proposal targets -> targets, head +
    losses -> head_loss, backward -> backward, optimizer -> opt_update."""
    from replication_faster_rcnn_tpu_torch.train.train_step import make_optimizer

    def event():
        if device.type == "cuda":
            return torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    events: List = []

    @contextlib.contextmanager
    def stage(name: str):
        start = event()
        start.record()
        try:
            yield
        finally:
            end = event()
            end.record()
            events.append((name, start, end))

    for _ in range(STAGE_STEPS):
        step(state, device_batch, stage=stage)
    _sync(device)
    ms: Dict[str, float] = defaultdict(float)
    for name, start, end in events:
        ms[name] += start.elapsed_time(end) / STAGE_STEPS

    def timed(fn: Callable[[], Any]) -> float:
        for _ in range(2):  # first call + 1 stabilizing run
            fn()
        _sync(device)
        n, t0 = 5, time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        return (time.perf_counter() - t0) / n * 1e3

    # the optimizer's update alone (the step's settings) on copies of the
    # parameters, from flat zero gradients
    params = [p.detach().clone() for p in state.model.parameters()]
    optimizer, _ = make_optimizer(cfg, params, steps_per_epoch=100)
    flat_params = torch.cat([p.reshape(-1) for p in params])
    zeros = torch.zeros_like(flat_params)
    t_upd = timed(lambda: optimizer.update(zeros, flat_params, None))
    # one launch and one synchronisation: the floor under any timed call
    scalar = torch.zeros((), device=device)
    t_floor = timed(lambda: scalar.add_(1.0))

    targets = ms["anchor_targets"] + ms["proposal_targets"]
    head_loss = ms["head"] + ms["losses"]
    return {
        "trunk_ms": round(ms["trunk"], 2),
        "rpn_heads_ms": round(ms["rpn"], 2),
        "proposal_nms_ms": round(ms["proposals"], 2),
        "targets_ms": round(targets, 2),
        "head_loss_ms": round(head_loss, 2),
        "targets_head_loss_ms": round(targets + head_loss, 2),
        "backward_ms": round(ms["backward"], 2),
        "opt_update_ms": round(ms["optimizer"], 2),
        "backward_update_ms": round(ms["backward"] + ms["optimizer"], 2),
        "step_ms": round(step_ms, 2),
        "opt_update_direct_ms": round(t_upd, 2),
        "dispatch_floor_ms": round(t_floor, 2),
        "opt_update_direct_adj_ms": round(max(0.0, t_upd - t_floor), 2),
    }


if __name__ == "__main__":
    main(profile_dir=os.environ.get("BENCH_PROFILE_DIR"))
