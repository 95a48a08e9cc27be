"""Train-health scalars from the tensors a step already holds (counterpart
of the JAX package's ``telemetry/health.py``).

* ``grad_norm`` / ``param_norm`` — global L2 norms;
* ``update_norm`` / ``update_ratio`` — the optimizer's step and its size
  relative to the parameters;
* ``nonfinite_count`` — NaN/Inf entries across the gradients, which gates
  the update.

``train/fault.py::guarded_update`` assembles them from these functions.

Values are 0-dim tensors on the parameters' device; nothing here
synchronises with the host. Each scalar flattens its tensors into one
vector first, so it costs a few kernel launches whatever the parameter
count.
"""

from __future__ import annotations

from typing import Iterable

import torch

Tensor = torch.Tensor

def flat(tensors: Iterable[Tensor]) -> Tensor:
    """All entries of the floating-point ``tensors`` as one float32 vector
    (a lone float32 vector is returned as it is, not copied)."""
    tensors = [t for t in tensors if t.is_floating_point()]
    if len(tensors) == 1 and tensors[0].dim() == 1 and tensors[0].dtype == torch.float32:
        return tensors[0]
    return torch.cat([t.reshape(-1).float() for t in tensors])


def global_norm(tensors: Iterable[Tensor]) -> Tensor:
    """The L2 norm over all entries: sqrt of a float32 sum of squares (a
    tree-shaped sum; ``vector_norm`` on the CPU loses ~1e-3 over 12 M
    entries)."""
    return torch.sqrt(torch.sum(torch.square(flat(tensors))))


def nonfinite_count(tensors: Iterable[Tensor]) -> Tensor:
    """Total NaN/Inf entries across ``tensors`` (an int64 0-dim tensor)."""
    return torch.sum(~torch.isfinite(flat(tensors)))
