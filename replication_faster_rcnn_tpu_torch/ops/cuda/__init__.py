"""Hand-written CUDA kernels for Hopper (sm_90a) and their PyTorch wrappers.

Counterpart of the JAX package's ``ops/pallas/``. Each wrapper validates
its inputs, allocates outputs with ``torch.empty``, launches on the current
stream, raises on a launch error and counts its launches in a module-level
integer (``launches``; the quant module keeps one per kernel). Sources live in ``replication_faster_rcnn_tpu_torch/csrc``
and are compiled by :mod:`.build` at first use.
"""
