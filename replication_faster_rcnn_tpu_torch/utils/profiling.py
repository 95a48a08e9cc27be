"""Profiling (counterpart of the JAX package's ``utils/profiling.py``).

:func:`trace` is a context manager around ``torch.profiler`` (CPU and CUDA
activities) writing a Chrome trace (``*.pt.trace.json``) that Perfetto and
TensorBoard load, for the device timeline; :func:`has_device_trace` finds
one in a directory.

:func:`op_tables` reads such captures back (the command line's
``trace-summary``; the JAX package's ``utils/xplane.py::op_table`` reads its
XPlane protos): the device ms of each kernel, and of each operator that
launched kernels. A kernel event (``cat == "kernel"``) carries the
profiler's ``args.correlation``, which names the runtime call that launched
it (``cudaLaunchKernel`` and the like, ``cat`` ``cuda_runtime`` or
``cuda_driver``); that call belongs to the innermost ``cpu_op`` that
encloses it in time on its thread. A replayed CUDA graph launches all its
kernels from one ``cudaGraphLaunch`` inside no operator that issued them,
so those kernels are labelled as graph replays and not attributed: the
operators of a step are read from eagerly run, profiled steps.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import socket
from typing import Any, Callable, Dict, Iterator, List, Optional

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


# the runtime calls that replay a CUDA graph: their kernels are not attributed
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
GRAPH_REPLAY = "[graph replay]"
GRAPH_REPLAY_OPERATOR = "(CUDA graph replays: not attributed)"
NO_OPERATOR = "(launched outside any cpu_op)"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def find_traces(trace_dir: str) -> List[str]:
    """The captures of :func:`trace` in ``trace_dir`` or below it."""
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True))


def _events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _rows(totals: Dict[str, List[float]], top: int) -> List[Dict[str, Any]]:
    """Rows ``{op, total_ms, count, pct}`` (the JAX ``op_table``'s keys and
    rounding) sorted by time, ``pct`` of the whole table, the first ``top``."""
    grand = sum(ms for ms, _ in totals.values()) or 1.0
    rows = [{"op": name, "total_ms": round(ms, 3), "count": int(n),
             "pct": round(100.0 * ms / grand, 2)} for name, (ms, n) in totals.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top]


def _innermost_operators(ops, launches) -> Dict[Any, Optional[str]]:
    """For each launch ``(thread, ts, key)``, the name of the innermost
    ``cpu_op`` of ``ops`` (``(thread, ts, end, name)``) on the same thread
    whose interval holds ``ts`` (None when none does). One sweep per
    thread: operators nest, so the innermost open one is on top."""
    by_thread = collections.defaultdict(list)
    for thread, ts, end, name in ops:
        by_thread[thread].append((ts, -end, name))
    queries = collections.defaultdict(list)
    for thread, ts, key in launches:
        queries[thread].append((ts, key))
    found: Dict[Any, Optional[str]] = {}
    for thread, qs in queries.items():
        opened = sorted(by_thread.get(thread, ()), key=lambda o: (o[0], o[1]))
        stack: List[tuple] = []  # (end, name)
        i = 0
        for ts, key in sorted(qs, key=lambda q: q[0]):
            while i < len(opened) and opened[i][0] <= ts:
                start, neg_end, name = opened[i]
                while stack and stack[-1][0] < start:
                    stack.pop()
                stack.append((-neg_end, name))
                i += 1
            while stack and stack[-1][0] < ts:
                stack.pop()
            found[key] = stack[-1][1] if stack else None
    return found


def op_tables(trace_dir: str, top: int = 25) -> Dict[str, List[Dict[str, Any]]]:
    """``{"ops": kernel rows, "operators": launching-operator rows}`` over
    every capture in ``trace_dir``, each sorted by device ms and cut to
    ``top`` (pct of the whole table).

    * ``ops``: one row per kernel name, its device ms and launches; the
      kernels of CUDA graph replays in rows of their own, named with a
      ``[graph replay]`` suffix and ``"graph_replay": True``.
    * ``operators``: each kernel's ms and count under the innermost
      ``cpu_op`` that encloses its launch (:data:`NO_OPERATOR` when none
      does), the graph replays' kernels in one row,
      :data:`GRAPH_REPLAY_OPERATOR`. The two tables hold the same total.

    A capture without device kernels (the CPU) falls back, as the JAX
    ``op_table`` falls back to every plane: ``ops`` holds the ``cpu_op``
    rows (inclusive host ms by name) and ``operators`` is empty."""
    kernels, launches, cpu_ops = [], {}, []
    for path in find_traces(trace_dir):
        for ev in _events(path):
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            if cat == "kernel":
                kernels.append((path, ev))
            elif cat in _LAUNCH_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[(path, corr)] = ev
            elif cat == "cpu_op":
                cpu_ops.append(((path, ev.get("pid"), ev.get("tid")), float(ev["ts"]),
                                float(ev["ts"]) + float(ev.get("dur", 0.0)), ev["name"]))
    if not kernels:
        totals: Dict[str, List[float]] = {}
        for _, ts, end, name in cpu_ops:
            row = totals.setdefault(name, [0.0, 0])
            row[0] += (end - ts) / 1e3
            row[1] += 1
        return {"ops": _rows(totals, top), "operators": []}
    queries, replayed = [], set()
    for i, (path, ev) in enumerate(kernels):
        launch = launches.get((path, (ev.get("args") or {}).get("correlation")))
        if launch is None:
            continue
        if launch["name"] in GRAPH_LAUNCHES:
            replayed.add(i)
        else:
            queries.append(((path, launch.get("pid"), launch.get("tid")),
                            float(launch["ts"]), i))
    owner = _innermost_operators(cpu_ops, queries)
    by_kernel: Dict[str, List[float]] = {}
    by_operator: Dict[str, List[float]] = {}
    for i, (_, ev) in enumerate(kernels):
        ms = float(ev.get("dur", 0.0)) / 1e3
        name = ev["name"]
        if i in replayed:
            name, operator = f"{name} {GRAPH_REPLAY}", GRAPH_REPLAY_OPERATOR
        else:
            operator = owner.get(i) or NO_OPERATOR
        for table, key in ((by_kernel, name), (by_operator, operator)):
            row = table.setdefault(key, [0.0, 0])
            row[0] += ms
            row[1] += 1
    ops = _rows(by_kernel, top)
    for row in ops:
        row["graph_replay"] = row["op"].endswith(GRAPH_REPLAY)
    return {"ops": ops, "operators": _rows(by_operator, top)}


def format_table(rows: List[Dict[str, Any]]) -> str:
    """The JAX ``format_table``'s layout."""
    if not rows:
        return "(no events)"
    w = max(len(str(r["op"])) for r in rows)
    out = [f"{'op':<{w}}  total_ms   count    pct"]
    for r in rows:
        out.append(f"{r['op']:<{w}}  {r['total_ms']:>8.3f}  {r['count']:>6}  {r['pct']:>5.2f}%")
    return "\n".join(out)
