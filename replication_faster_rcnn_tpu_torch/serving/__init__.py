"""Bucketed, micro-batched inference serving of the PyTorch port (the JAX
package's ``serving/``).

`engine.InferenceEngine` holds each model version's weights on the card and
replays one CUDA graph per (version, bucket, batch size) flush;
`batcher.MicroBatcher` coalesces concurrent requests into those flushes;
`server.make_server` is the HTTP front end and `loadgen` drives the engine
in closed and open loops and the fleet router in its closed loop.
`fleet/` is the multi-replica router (registry, breakers, hedging, canary
and shadow traffic) and `rollout/` the rolling weight rollout over it.
"""

from replication_faster_rcnn_tpu_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
)
from replication_faster_rcnn_tpu_torch.serving.engine import (
    InferenceEngine,
    OversizedImageError,
    get_engine,
    select_bucket,
)

__all__ = [
    "DeadlineExceeded",
    "InferenceEngine",
    "MicroBatcher",
    "OversizedImageError",
    "get_engine",
    "select_bucket",
]
