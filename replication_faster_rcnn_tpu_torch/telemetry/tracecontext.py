"""W3C-traceparent-style request tracing primitives (a copy of the JAX
package's ``telemetry/tracecontext.py``).

A request entering the fleet front door gets a :class:`TraceContext`:
a 128-bit ``trace_id`` naming the request end-to-end and a 64-bit
``span_id`` naming one hop of it.  The context rides across process
boundaries as a ``traceparent`` HTTP header in the W3C Trace Context
wire format::

    00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>

and across thread boundaries inside a process as a thread-local set
with :func:`bind`.  Instrumented code never takes a trace parameter —
it calls :func:`current_trace` and gets the bound context or ``None``,
exactly the shape of ``spans.current_tracer()``.  That keeps call
signatures stable: the router binds a per-attempt child context on the
dispatching thread, the HTTP client picks it up to stamp the header,
the in-process engine client picks the same thread-local up with no
header involved at all.

Spans form a tree: hedged attempts are *siblings* (same ``trace_id``,
distinct ``span_id``, same parent), a replica-side hop is a *child* of
the attempt that carried it.  The tree is recorded as ``trace_id`` /
``span_id`` / ``parent_span_id`` args on ordinary Chrome-trace events
(:mod:`.spans`), so the merged per-process traces already rendered by
``frcnn telemetry`` become a single cross-process timeline — grep one
``trace_id`` and you hold the whole request.
"""

from __future__ import annotations

import os
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Iterator, Optional

__all__ = [
    "TRACEPARENT_HEADER",
    "TraceContext",
    "bind",
    "current_trace",
    "new_span_id",
    "new_trace_context",
    "parse_traceparent",
]

# HTTP header carrying the context (W3C Trace Context name).
TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def new_span_id() -> str:
    """A fresh 64-bit span id as 16 lowercase hex chars."""
    return os.urandom(8).hex()


def _new_trace_id() -> str:
    return os.urandom(16).hex()


@dataclass(frozen=True)
class TraceContext:
    """One node of a request's span tree.

    ``parent_span_id`` never crosses the wire (the W3C header has no
    slot for it — the receiver's parent IS the sender's span); it is
    kept in-process so emitted events can record the tree edge.
    """

    trace_id: str
    span_id: str
    flags: str = "01"
    parent_span_id: Optional[str] = None

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def child(self) -> "TraceContext":
        """A child span: same trace, fresh span id, this span as parent."""
        return replace(
            self, span_id=new_span_id(), parent_span_id=self.span_id
        )

    def sibling(self) -> "TraceContext":
        """A sibling span (hedged attempt): same trace AND same parent,
        fresh span id."""
        return replace(self, span_id=new_span_id())

    def span_args(self) -> dict:
        """The standard Chrome-trace ``args`` fields for this context."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id is not None:
            out["parent_span_id"] = self.parent_span_id
        return out


def new_trace_context() -> TraceContext:
    """A root context for a request entering the system."""
    return TraceContext(trace_id=_new_trace_id(), span_id=new_span_id())


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header; ``None`` on absent or malformed
    input (a bad header must never fail the request it decorates)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id, flags = m.groups()
    # all-zero ids are invalid per the W3C spec
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id, flags=flags)


_local = threading.local()


def current_trace() -> Optional[TraceContext]:
    """The context bound to this thread, or ``None``."""
    return getattr(_local, "ctx", None)


@contextmanager
def bind(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Bind ``ctx`` as this thread's current trace for the block."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev
