"""Rolling weight rollout: the versioned train→serve control plane (a port
of the JAX package's ``serving/rollout/``; host code).

The trainer's ``workdir/manifests/`` output is the version feed
(train/fault.py writes one CRC-leaf manifest per checkpoint and appends
to ``manifests/feed.jsonl``); this package closes the loop on the
serving side:

* :mod:`versions` — :class:`~versions.VersionFeed` discovers published
  checkpoint versions and validates eligibility (manifest CRC fields +
  topology + config hash + int8 quant sidecar) BEFORE any replica is
  touched.
* :mod:`controller` — :class:`~controller.RolloutController` drives the
  rolling fleet upgrade through the fleet's replica registry (hold → swap →
  rejoin → canary → windowed promote/rollback), and
  :class:`~controller.RolloutWatcher` polls the feed and triggers waves.
"""

from replication_faster_rcnn_tpu_torch.serving.rollout.controller import (
    RolloutController,
    RolloutError,
    RolloutWatcher,
    WaveResult,
)
from replication_faster_rcnn_tpu_torch.serving.rollout.versions import (
    Eligibility,
    VersionFeed,
)

__all__ = [
    "Eligibility",
    "RolloutController",
    "RolloutError",
    "RolloutWatcher",
    "VersionFeed",
    "WaveResult",
]
