"""The port tests' share of the CPU under pytest-xdist.

Under xdist every worker imports every test module while it collects, before
any test runs, so a module that calls :func:`share_cores_among_xdist_workers`
at import sets each worker's torch threads to its share of the cores, at
least two. At torch's default, a thread per core in every worker, six
workers oversubscribe the cores and torch's OpenMP threads spin: six
concurrent 96x96 train steps of the port ran 19x slower (8 steps each in
288 s against 12-16 s at one or two threads, 8 cores). Run without xdist,
torch keeps its default.

``test_torch_quant.py`` calls this too, so that its int8 forwards share the
cores when its file runs alone under xdist. Its checks do not depend on the
thread count: each stage of the tiny FPN's int8 forward is fed the JAX
model's outputs of the stage before.
"""

import os

import torch


def share_cores_among_xdist_workers() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(2, len(os.sched_getaffinity(0)) // workers))
