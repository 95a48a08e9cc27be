"""Detection ops and the kernel dispatch seam.

Each op that the JAX package runs as a Pallas kernel has two versions here:
a hand-written CUDA kernel (``ops/cuda/``, sources in ``csrc/``) and its
plain PyTorch version in the op's own module. The kernel wrapper is the
dispatch point, and the device decides:

* a CUDA tensor launches the kernel (a failed build or launch raises —
  there is no fallback);
* a CPU tensor runs the plain version.

:class:`reference_scope` is the one explicit override: inside it the ops
run their plain versions even on CUDA tensors. ``chip_smoke.py`` and the
tests use it to hold each kernel against its plain version; nothing on the
serving path enters it unless the caller asks (``reference=True``).
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import torch

_scope = threading.local()

# (values, dtype, device) -> the tensor: built once, never freed
_constants: Dict[Tuple, torch.Tensor] = {}


class reference_scope:
    """Run the plain PyTorch versions on every device for this thread.

    ``with reference_scope(): ...`` (or ``reference_scope(False)``, a no-op,
    so callers can pass a flag through)."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)

    def __enter__(self):
        if self.enabled:
            _scope.depth = getattr(_scope, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _scope.depth -= 1
        return False


def reference_requested() -> bool:
    """True inside a :class:`reference_scope` on this thread."""
    return getattr(_scope, "depth", 0) > 0


def constant(values: Sequence[float], dtype: torch.dtype, device) -> torch.Tensor:
    """A cached tensor of ``values`` on ``device``. Built by the first call
    (a host-to-device copy, which waits for the card), then reused, so a
    step that reads it makes no copy and no synchronisation, and a CUDA
    graph captured after that first call may read it."""
    key = (tuple(float(v) for v in values), dtype, torch.device(device))
    out = _constants.get(key)
    if out is None:
        out = _constants[key] = torch.tensor(key[0], dtype=dtype, device=key[2])
    return out
