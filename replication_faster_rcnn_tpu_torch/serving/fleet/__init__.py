"""Self-healing multi-replica serving fleet (a port of the JAX package's
``serving/fleet/``; host code, it imports neither JAX nor PyTorch).

A front router (the ``fleet`` subcommand) over N ``serve`` replicas: a
health-checked replica registry with lease-style staleness
(registry.py — the elastic trainer's heartbeat discipline applied to
serving), per-replica circuit breakers (breaker.py), and a dispatcher
(router.py) that consistent-hashes requests over (content-hash, bucket),
answers duplicate images from a content-hash result cache, fails over
mid-request deaths, hedges tail latency after a p99-derived delay, and
runs canary/shadow traffic splits.  Clients (client.py) abstract the
replica transport — in-process engines for tests and ``chip_smoke.py``,
HTTP for real fleets — and server.py is the stdlib HTTP front.
Deterministic drills enter through the ``router.dispatch``/``router.probe``
failpoint sites (the ``chaos --smoke`` fleet_router leg).
"""

from replication_faster_rcnn_tpu_torch.serving.fleet.breaker import CircuitBreaker
from replication_faster_rcnn_tpu_torch.serving.fleet.client import (
    HTTPReplicaClient,
    LocalReplicaClient,
    ReplicaDown,
    engine_client,
)
from replication_faster_rcnn_tpu_torch.serving.fleet.registry import (
    Prober,
    Replica,
    ReplicaRegistry,
)
from replication_faster_rcnn_tpu_torch.serving.fleet.router import (
    FleetRouter,
    FleetUnavailable,
    HashRing,
)
from replication_faster_rcnn_tpu_torch.serving.fleet.server import make_fleet_server

__all__ = [
    "CircuitBreaker",
    "FleetRouter",
    "FleetUnavailable",
    "HTTPReplicaClient",
    "HashRing",
    "LocalReplicaClient",
    "Prober",
    "Replica",
    "ReplicaDown",
    "ReplicaRegistry",
    "engine_client",
    "make_fleet_server",
]
