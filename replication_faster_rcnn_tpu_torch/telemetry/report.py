"""Summarize a telemetry run directory into a phase-time + health report
(after the JAX package's ``telemetry/report.py``, for one process), and one
request's hop timeline from the traces of several (``telemetry --trace-id``).

Input is whatever a telemetry-enabled run left behind:
``trace.json`` (Chrome-trace spans), ``metrics.jsonl`` (MetricLogger
rows, including the health scalars), ``watchdog.jsonl`` (stall and fault
incidents), ``progress.json`` (last heartbeat). All optional — the report
covers what exists. Pure stdlib on purpose, so it works on a machine
holding only the artifacts; only the probe for a device capture
(``utils/profiling.py::has_device_trace``) imports the port, and the
report goes on without it.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

TRACE_FILE = "trace.json"
METRICS_FILE = "metrics.jsonl"
WATCHDOG_FILE = "watchdog.jsonl"
PROGRESS_FILE = "progress.json"

# Replicas write their request traces under ``<stem>.rank<N>.<ext>``
# (``serve --replica-id``: ``trace.rank<N>.json``) beside the plain name;
# ``telemetry --trace-id`` merges them.
_RANK_RE = re.compile(r"\.rank(\d+)\.[^.]+$")


def rank_variants(run_dir: str, name: str) -> List[Tuple[int, str]]:
    """(rank, path) for every per-rank variant of ``name`` present in
    ``run_dir``: the plain file is rank 0 (the coordinator), plus any
    ``stem.rankN.ext`` siblings, sorted by rank."""
    out: List[Tuple[int, str]] = []
    base = os.path.join(run_dir, name)
    if os.path.exists(base):
        out.append((0, base))
    stem, ext = os.path.splitext(name)
    for path in glob.glob(os.path.join(run_dir, f"{stem}.rank*{ext}")):
        m = _RANK_RE.search(path)
        if m:
            out.append((int(m.group(1)), path))
    out.sort()
    return out

# Health/throughput keys worth surfacing from the JSONL, in display order.
_HEALTH_KEYS = (
    "loss",
    "rpn_cls_loss",
    "rpn_reg_loss",
    "head_cls_loss",
    "head_reg_loss",
    "grad_norm",
    "param_norm",
    "update_norm",
    "update_ratio",
    "nonfinite_count",
    "skipped",
)

# Incident kinds the fault layer records (train/fault.py + trainer) beyond
# the watchdog's own stall/recovered pair.
_FAULT_KINDS = (
    "nonfinite_escalation",
    "preempted",
    "checkpoint_save_failed",
    "checkpoint_fallback",
    "abnormal_exit",
)


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare-array Chrome-trace variant
        return doc
    return doc.get("traceEvents", [])


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # a torn tail line from a killed run is expected
    return rows


def phase_table(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate complete (ph=X) spans by name: count / total / mean / max
    ms, sorted by total time descending."""
    agg: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "?")
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        row = agg.setdefault(name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
    out = []
    for name, row in agg.items():
        out.append(
            {
                "name": name,
                "count": int(row["count"]),
                "total_ms": round(row["total_ms"], 3),
                "mean_ms": round(row["total_ms"] / row["count"], 3),
                "max_ms": round(row["max_ms"], 3),
            }
        )
    out.sort(key=lambda r: -r["total_ms"])
    return out


def trace_timeline(
    events: List[Dict[str, Any]], trace_id: str
) -> Optional[Dict[str, Any]]:
    """One request's hop timeline from the merged Chrome trace.

    Every hop span the serving stack emits (``fleet/request``,
    ``fleet/attempt``, ``serve/request``, ``serve/queue_wait``,
    ``serve/dispatch``) stamps its ``trace_id``/``span_id``/
    ``parent_span_id`` into the event args; filtering on one trace id
    reconstructs the request's path across router and replicas —
    including hedged and abandoned attempts, which share the trace id
    with distinct span ids.  For each ``fleet/attempt`` whose replica-
    side ``serve/request`` child is present, the non-replica remainder
    is reported as ``network_ms``.  Returns None when the trace id
    matches nothing."""
    spans = [
        ev
        for ev in events
        if ev.get("ph") == "X"
        and isinstance(ev.get("args"), dict)
        and ev["args"].get("trace_id") == trace_id
    ]
    if not spans:
        return None
    t0 = min(float(ev.get("ts", 0.0)) for ev in spans)
    rows: List[Dict[str, Any]] = []
    for ev in sorted(spans, key=lambda e: float(e.get("ts", 0.0))):
        args = ev["args"]
        row: Dict[str, Any] = {
            "name": ev.get("name", "?"),
            "start_ms": round((float(ev.get("ts", 0.0)) - t0) / 1e3, 3),
            "dur_ms": round(float(ev.get("dur", 0.0)) / 1e3, 3),
            "span_id": args.get("span_id"),
            "parent_span_id": args.get("parent_span_id"),
            "pid": ev.get("pid"),
            "tid": ev.get("tid"),
        }
        for key in ("replica", "hedge", "ok", "key", "program"):
            if key in args:
                row[key] = args[key]
        rows.append(row)
    for row in rows:
        if row["name"] != "fleet/attempt":
            continue
        child = next(
            (
                r
                for r in rows
                if r["name"] == "serve/request"
                and r["parent_span_id"] == row["span_id"]
            ),
            None,
        )
        if child is not None:
            row["network_ms"] = round(row["dur_ms"] - child["dur_ms"], 3)
    end = max(r["start_ms"] + r["dur_ms"] for r in rows)
    return {
        "trace_id": trace_id,
        "spans": rows,
        "total_ms": round(end, 3),
        "replicas": sorted(
            {r["replica"] for r in rows if "replica" in r}
        ),
    }


def format_trace_timeline(timeline: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`trace_timeline`."""
    lines = [
        f"trace {timeline['trace_id']}: {len(timeline['spans'])} span(s), "
        f"{timeline['total_ms']:.2f} ms end-to-end"
        + (
            f", replicas: {', '.join(timeline['replicas'])}"
            if timeline["replicas"]
            else ""
        )
    ]
    header = (
        f"  {'start_ms':>9}{'dur_ms':>10}  {'span':<18}"
        f"{'span_id':<18}{'detail'}"
    )
    lines.append(header)
    for row in timeline["spans"]:
        detail = []
        if "replica" in row:
            detail.append(f"replica={row['replica']}")
        if row.get("hedge"):
            detail.append("hedge")
        if "ok" in row:
            detail.append("ok" if row["ok"] else "FAILED")
        if "network_ms" in row:
            detail.append(f"network={row['network_ms']:.2f}ms")
        if "key" in row:
            detail.append(f"bucket={row['key']}")
        lines.append(
            f"  {row['start_ms']:>9.2f}{row['dur_ms']:>10.2f}  "
            f"{row['name']:<18}{str(row['span_id']):<18}{' '.join(detail)}"
        )
    return "\n".join(lines)


def overlap_summary(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Feed-vs-dispatch overlap from the span stream.

    Data-pipeline spans (``data/fetch``, ``data/device_put``) emitted on
    the thread(s) that also emit ``step/dispatch`` are host-BLOCKED feed
    time — the trainer paid them on the critical path. The same spans on
    any other thread are the device stager's producer doing that work
    overlapped (``data.prefetch_device``). Returns None when the trace
    has no dispatch spans (nothing to be blocked against)."""
    # key threads by (pid, tid): tid values can repeat across processes
    dispatch_tids = set()
    dispatch_ms = 0.0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "step/dispatch":
            dispatch_tids.add((ev.get("pid"), ev.get("tid")))
            dispatch_ms += float(ev.get("dur", 0.0)) / 1e3
    if not dispatch_tids:
        return None
    blocked_ms = 0.0
    overlapped_ms = 0.0
    for ev in events:
        if ev.get("ph") != "X" or not str(ev.get("name", "")).startswith("data/"):
            continue
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        if (ev.get("pid"), ev.get("tid")) in dispatch_tids:
            blocked_ms += dur_ms
        else:
            overlapped_ms += dur_ms
    return {
        "dispatch_total_ms": round(dispatch_ms, 3),
        "host_blocked_ms": round(blocked_ms, 3),
        "overlapped_ms": round(overlapped_ms, 3),
        "host_blocked_frac_of_dispatch": (
            round(blocked_ms / dispatch_ms, 4) if dispatch_ms > 0 else None
        ),
    }


def health_summary(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Last value + max of each health key across step rows."""
    step_rows = [r for r in rows if "step" in r]
    out: Dict[str, Any] = {"rows": len(step_rows)}
    if not step_rows:
        return out
    out["first_step"] = step_rows[0].get("step")
    out["last_step"] = step_rows[-1].get("step")
    keys: Dict[str, Dict[str, float]] = {}
    for key in _HEALTH_KEYS:
        vals = [
            float(r[key])
            for r in step_rows
            if isinstance(r.get(key), (int, float))
        ]
        if vals:
            keys[key] = {"last": vals[-1], "max": max(vals), "min": min(vals)}
    out["metrics"] = keys
    return out


def summarize_run(run_dir: str) -> Dict[str, Any]:
    summary: Dict[str, Any] = {"run_dir": run_dir, "artifacts": []}

    def present(name: str) -> Optional[str]:
        path = os.path.join(run_dir, name)
        if not os.path.exists(path):
            return None
        summary["artifacts"].append(name)
        return path

    trace_path = present(TRACE_FILE)
    if trace_path:
        events = load_trace_events(trace_path)
        summary["phases"] = phase_table(events)
        overlap = overlap_summary(events)
        if overlap is not None:
            summary["overlap"] = overlap

    metrics_path = present(METRICS_FILE)
    if metrics_path:
        summary["health"] = health_summary(load_jsonl(metrics_path))

    watchdog_path = present(WATCHDOG_FILE)
    if watchdog_path:
        incidents = load_jsonl(watchdog_path)
        summary["incidents"] = {
            "stalls": sum(1 for i in incidents if i.get("kind") == "stall"),
            "recoveries": sum(1 for i in incidents if i.get("kind") == "recovered"),
            "faults": {
                kind: n
                for kind in _FAULT_KINDS
                if (n := sum(1 for i in incidents if i.get("kind") == kind))
            },
            "events": incidents,
        }

    progress_path = present(PROGRESS_FILE)
    if progress_path:
        with open(progress_path) as f:
            summary["progress"] = json.load(f)
    try:  # a torch.profiler device capture next to the host spans?
        from replication_faster_rcnn_tpu_torch.utils.profiling import has_device_trace

        summary["device_trace"] = has_device_trace(run_dir)
    except Exception:  # pragma: no cover - report must survive without it
        summary["device_trace"] = False
    return summary


def format_report(summary: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`summarize_run`."""
    lines = [f"telemetry report: {summary['run_dir']}"]
    if not summary["artifacts"]:
        lines.append("  no telemetry artifacts found "
                     f"({TRACE_FILE}/{METRICS_FILE}/{WATCHDOG_FILE})")
        return "\n".join(lines)

    phases = summary.get("phases")
    if phases is not None:
        lines.append("")
        lines.append("phase time (from trace.json):")
        header = f"  {'span':<26}{'count':>7}{'total_ms':>12}{'mean_ms':>10}{'max_ms':>10}"
        lines.append(header)
        for row in phases:
            lines.append(
                f"  {row['name']:<26}{row['count']:>7}"
                f"{row['total_ms']:>12.1f}{row['mean_ms']:>10.2f}{row['max_ms']:>10.1f}"
            )

    overlap = summary.get("overlap")
    if overlap is not None:
        frac = overlap.get("host_blocked_frac_of_dispatch")
        lines.append("")
        lines.append(
            "feed overlap: "
            f"{overlap['host_blocked_ms']:.1f} ms data time on the dispatch "
            f"thread ({frac:.1%} of dispatch wall), "
            f"{overlap['overlapped_ms']:.1f} ms overlapped on the stager"
            if frac is not None
            else "feed overlap: no dispatch time recorded"
        )

    health = summary.get("health")
    if health is not None:
        lines.append("")
        lines.append(
            f"train health (from metrics.jsonl, {health['rows']} rows"
            + (
                f", steps {health.get('first_step')}..{health.get('last_step')})"
                if health["rows"]
                else ")"
            )
        )
        for key, vals in health.get("metrics", {}).items():
            lines.append(
                f"  {key:<18} last {vals['last']:<12.5g} "
                f"min {vals['min']:<12.5g} max {vals['max']:<12.5g}"
            )

    incidents = summary.get("incidents")
    if incidents is not None:
        lines.append("")
        lines.append(
            f"watchdog: {incidents['stalls']} stall(s), "
            f"{incidents['recoveries']} recovery(ies)"
        )
        for kind, n in incidents.get("faults", {}).items():
            lines.append(f"  fault incidents: {n}x {kind}")
        for ev in incidents["events"]:
            if ev.get("kind") != "stall":
                continue
            span = ev.get("last_span") or {}
            lines.append(
                f"  stall at step={ev.get('last_step')} phase={ev.get('last_phase')} "
                f"after {ev.get('elapsed_since_progress_s')}s "
                f"(last span: {span.get('name') if isinstance(span, dict) else span})"
            )

    progress = summary.get("progress")
    if progress is not None:
        lines.append("")
        lines.append(
            f"last heartbeat: step={progress.get('step')} "
            f"phase={progress.get('phase')} at {progress.get('utc')}"
        )
    if summary.get("device_trace"):
        lines.append("")
        lines.append(
            "device profiler capture present (torch.profiler Chrome trace, "
            f"*.pt.trace.json under {summary['run_dir']}; Perfetto loads it)"
        )
    return "\n".join(lines)
