"""Telemetry of the PyTorch port (the JAX package's ``telemetry/``).

- :mod:`.spans` — host-side span tracer emitting Chrome-trace JSON;
- :mod:`.watchdog` — heartbeat daemon that records a stall's snapshot;
- :mod:`.health` — train-health scalars from the step's own tensors;
- :mod:`.mfu` — model FLOPs utilisation against a datasheet peak;
- :mod:`.report` — a run directory's phase-time and health report.

Not ported: ``metrics.py``, ``slo_burn.py`` and ``tracecontext.py``, which
go with the serving stack.
"""

from replication_faster_rcnn_tpu_torch.telemetry.spans import (  # noqa: F401
    NULL_TRACER,
    SpanTracer,
    current_tracer,
    set_tracer,
)
from replication_faster_rcnn_tpu_torch.telemetry.watchdog import StallWatchdog  # noqa: F401
