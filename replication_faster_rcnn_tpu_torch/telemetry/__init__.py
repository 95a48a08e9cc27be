"""Telemetry of the PyTorch port (the JAX package's ``telemetry/``).

- :mod:`.spans` — host-side span tracer emitting Chrome-trace JSON;
- :mod:`.watchdog` — heartbeat daemon that records a stall's snapshot;
- :mod:`.health` — train-health scalars from the step's own tensors;
- :mod:`.mfu` — model FLOPs utilisation against a datasheet peak;
- :mod:`.report` — a run directory's phase-time and health report;
- :mod:`.tracecontext` — W3C-traceparent request tracing across HTTP hops;
- :mod:`.metrics` — the serving tier's ``MetricsRegistry`` (``/stats``,
  ``/metrics``);
- :mod:`.slo_burn` — multi-window error-budget burn rates (``degraded``).
"""

from replication_faster_rcnn_tpu_torch.telemetry.metrics import (  # noqa: F401
    MetricsRegistry,
)
from replication_faster_rcnn_tpu_torch.telemetry.slo_burn import (  # noqa: F401
    BurnRateTracker,
)
from replication_faster_rcnn_tpu_torch.telemetry.spans import (  # noqa: F401
    NULL_TRACER,
    SpanTracer,
    current_tracer,
    set_tracer,
)
from replication_faster_rcnn_tpu_torch.telemetry.watchdog import StallWatchdog  # noqa: F401
from replication_faster_rcnn_tpu_torch.telemetry.tracecontext import (  # noqa: F401
    TraceContext,
    bind,
    current_trace,
    new_trace_context,
    parse_traceparent,
)
