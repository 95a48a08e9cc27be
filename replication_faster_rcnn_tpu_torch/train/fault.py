"""The non-finite guarded update (counterpart of the JAX package's
``train/fault.py::guarded_update``; its checkpoint, preemption and monitor
machinery is not ported yet).

Policies (``train.nonfinite_policy``):

* ``skip`` — a gradient with any NaN/Inf withholds the whole update: the
  parameters, the Adam state, the schedule's position and the BatchNorm
  running statistics stay bit-identical, and the metrics carry
  ``skipped = 1``;
* ``halt`` — gates the same way; the trainer then raises
  :class:`NonFiniteEscalation`;
* ``apply`` — applies every update.

The step counter advances either way (it counts dispatched batches).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from replication_faster_rcnn_tpu_torch.telemetry.health import (
    flat,
    global_norm,
    health_metrics,
    nonfinite_count,
)

Tensor = torch.Tensor

NONFINITE_POLICIES = ("apply", "skip", "halt")

# (BatchNorm module, (new running mean, new running var))
PendingStats = List[Tuple[torch.nn.Module, Tuple[Tensor, Tensor]]]


class NonFiniteEscalation(FloatingPointError):
    """A step's update was withheld under ``nonfinite_policy='halt'``."""


def guarded_update(
    optimizer: torch.optim.Optimizer,
    scheduler,
    params: Sequence[torch.nn.Parameter],
    new_stats: PendingStats,
    policy: str = "skip",
) -> Dict[str, Tensor]:
    """Step ``optimizer`` and ``scheduler`` and commit ``new_stats`` unless
    the gradients of ``params`` hold a NaN/Inf and the policy withholds the
    update. Returns the health scalars plus ``skipped``.

    Under ``skip``/``halt`` the gate reads the non-finite count on the
    host (one synchronisation per step). A withheld step reports
    ``update_norm`` and ``update_ratio`` as NaN: Adam's update of a
    non-finite gradient is NaN, which is what the JAX package reports."""
    if policy not in NONFINITE_POLICIES:
        raise ValueError(f"nonfinite_policy must be one of {NONFINITE_POLICIES}, got {policy!r}")
    with torch.no_grad():
        # one flat float32 copy each: a few launches for any parameter count
        grads = flat([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
        params = [p.detach() for p in params]  # views: they see the optimizer's update
        old = flat(params)
        ok = policy == "apply" or int(nonfinite_count([grads])) == 0
        if ok:
            optimizer.step()
            scheduler.step()
            for module, (mean, var) in new_stats:
                module.running_mean.copy_(mean)
                module.running_var.copy_(var)
            health = health_metrics([grads], [old], [flat(params) - old])
            health["skipped"] = torch.zeros((), device=old.device)
        else:
            nan = torch.tensor(float("nan"), device=old.device)
            health = {
                "grad_norm": global_norm([grads]),
                "param_norm": global_norm([old]),
                "update_norm": nan,
                "update_ratio": nan,
                "nonfinite_count": nonfinite_count([grads]),
                "skipped": torch.ones((), device=old.device),
            }
    for module, _ in new_stats:
        module.pending_stats = None
    return health
