"""Distributed training (counterpart of the JAX package's ``parallel/``).

Ported so far: ``elastic.py``'s heartbeat agent and fleet file protocol,
which the chaos smoke's fleet leg drives. The mesh, the data-parallel step,
ZeRO and the elastic supervisor are ROADMAP Queue A item 8.
"""

from replication_faster_rcnn_tpu_torch.parallel import elastic

__all__ = ["elastic"]
