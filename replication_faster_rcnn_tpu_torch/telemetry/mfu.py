"""Model FLOPs utilisation (MFU) (counterpart of the JAX package's
``telemetry/mfu.py``).

MFU = achieved FLOP/s / peak FLOP/s. Achieved FLOP/s is the step's FLOP
count (``benchmark.py::_step_flops``) times steps/sec; the peak comes from
one of two bases:

- ``h100_datasheet_bf16_dense`` — NVIDIA's published dense bf16 Tensor
  Core peak of the card (half the with-sparsity figure), keyed off
  ``torch.cuda.get_device_name()``, times the device count.
- ``cpu_measured_matmul`` — on the CPU there is no datasheet number, so the
  peak is *measured*: the best throughput of a float32 matmul, cached per
  process. The ``mfu_basis`` label keeps the two regimes apart: a CPU-basis
  MFU says how well a run used the host, nothing about the card.

An unrecognised card gives no peak: a wrong peak distorts MFU more than a
missing one.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple, Union

import torch

# Dense bf16 Tensor Core peaks (NVIDIA H100 datasheet: half of the
# with-sparsity figures). Matched as substrings of the device name, most
# specific first: the SXM5 card reports "NVIDIA H100 80GB HBM3".
GPU_PEAK_BF16_FLOPS = (
    (("h100 pcie",), 756e12),
    (("h100 80gb hbm3", "h100 sxm"), 989.4e12),
)
GPU_BASIS = "h100_datasheet_bf16_dense"
CPU_BASIS = "cpu_measured_matmul"

_cpu_peak_cache: Optional[float] = None


def gpu_peak_flops_per_sec(device_name: str, n_dev: int) -> Optional[float]:
    """Aggregate datasheet bf16 peak for ``n_dev`` cards named
    ``device_name``, or None for a card the table does not hold."""
    name = device_name.lower()
    for names, peak in GPU_PEAK_BF16_FLOPS:
        if any(n in name for n in names):
            return peak * n_dev
    return None


def measured_cpu_peak_flops_per_sec(n: int = 512, iters: int = 4) -> Optional[float]:
    """Best observed FLOP/s of a float32 ``n×n`` torch matmul on the CPU,
    cached per process. ``FRCNN_CPU_PEAK_FLOPS`` overrides the measurement
    (for deterministic tests, and for hosts where a quick matmul
    under-represents sustained throughput)."""
    global _cpu_peak_cache
    override = os.environ.get("FRCNN_CPU_PEAK_FLOPS")
    if override:
        try:
            return float(override)
        except ValueError:
            pass
    if _cpu_peak_cache is not None:
        return _cpu_peak_cache
    a = torch.ones((n, n), dtype=torch.float32)
    b = torch.ones((n, n), dtype=torch.float32)
    a @ b  # the first call may pay the thread pool's spin-up
    flops = 2.0 * n * n * n
    best = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        a @ b
        dt = time.perf_counter() - t0
        if dt > 0:
            best = max(best, flops / dt)
    _cpu_peak_cache = best or None
    return _cpu_peak_cache


def peak_flops_per_sec(
    n_dev: Optional[int] = None, device: Union[str, torch.device] = "cuda"
) -> Tuple[Optional[float], Optional[str]]:
    """(aggregate peak FLOP/s, basis label) for ``n_dev`` devices of the
    kind ``device`` names (default: every visible card): the datasheet
    table on ``cuda`` (``(None, None)`` for a card it does not hold; no GPU
    raises), the measured matmul on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if n_dev is None:
            n_dev = torch.cuda.device_count()
        peak = gpu_peak_flops_per_sec(torch.cuda.get_device_name(device), n_dev)
        return (peak, GPU_BASIS if peak else None)
    if device.type == "cpu":
        peak = measured_cpu_peak_flops_per_sec()
        return (peak, CPU_BASIS if peak else None)
    return (None, None)


def compute_mfu(
    flops_per_step: float,
    steps_per_sec: float,
    peak_flops_per_second: Optional[float],
) -> Optional[float]:
    """Achieved / peak. Pure arithmetic, no backend queries — testable
    against a hand-computed value."""
    if not flops_per_step or not steps_per_sec or not peak_flops_per_second:
        return None
    return (flops_per_step * steps_per_sec) / peak_flops_per_second
