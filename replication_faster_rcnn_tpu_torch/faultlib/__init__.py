"""Deterministic fault injection (a copy of the JAX package's ``faultlib``).

`failpoints` is the seeded registry of named injection sites; the port's
micro-batcher (``batcher.flush``) and HTTP handler (``http.handler``)
consult it.
"""

from replication_faster_rcnn_tpu_torch.faultlib import failpoints

__all__ = ["failpoints"]
