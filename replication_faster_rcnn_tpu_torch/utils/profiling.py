"""Profiling (counterpart of the JAX package's ``utils/profiling.py``).

:func:`trace` is a context manager around ``torch.profiler`` (CPU and CUDA
activities) writing a Chrome trace (``*.pt.trace.json``) that Perfetto and
TensorBoard load, for the device timeline; :func:`has_device_trace` finds
one in a directory.
"""

from __future__ import annotations

import contextlib
import glob
import os
import socket
from typing import Callable, Iterator, Optional

import torch

TRACE_SUFFIX = ".pt.trace.json"


def trace_path(logdir: str) -> str:
    """Where :func:`trace` writes its capture in ``logdir``: one file per
    host and process, as ``torch.profiler.tensorboard_trace_handler`` names
    them."""
    return os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}{TRACE_SUFFIX}")


def has_device_trace(trace_dir: str) -> bool:
    """True when ``trace_dir`` (or a directory below it) holds a capture of
    :func:`trace`. Used by ``telemetry/report.py`` to point a run summary
    at the device timeline beside the host-side span trace."""
    return bool(glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True))


@contextlib.contextmanager
def trace(logdir: Optional[str], warmup_steps: int = 0) -> Iterator[Callable[[], None]]:
    """Capture a device trace viewable in Perfetto / TensorBoard: CPU and
    (with a GPU) CUDA activities, written to :func:`trace_path` on exit.

    The context yields a ``step()`` callable that the caller calls after
    each step. The first ``warmup_steps`` steps run under the profiler but
    stay out of the capture: a process's first profiled step also pays the
    profiler's start-up on the host, which would read as device idle time.

    ``logdir=None`` is a no-op, so callers with an optional profile flag
    can unconditionally write ``with trace(flag) as step:``."""
    if logdir is None:
        yield lambda: None
        return
    from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    schedule = None
    if warmup_steps:
        # record every step after the warm-up until the context exits
        schedule = torch.profiler.schedule(wait=0, warmup=warmup_steps, active=1 << 30)
    os.makedirs(logdir, exist_ok=True)
    # mirrored as a telemetry span so the host-side trace.json shows when
    # (and for how long) the device profiler was recording
    with tspans.current_tracer().span("profiler/trace", cat="profile", logdir=logdir):
        with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
            yield prof.step
        prof.export_chrome_trace(trace_path(logdir))
