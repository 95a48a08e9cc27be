"""Host utilities (counterpart of the JAX package's ``utils/``)."""

from replication_faster_rcnn_tpu_torch.utils.logging import MetricLogger  # noqa: F401
