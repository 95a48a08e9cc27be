"""Decoded-sample RAM cache for the host input pipeline (a copy of the JAX
package's ``data/cache.py``).

A Faster R-CNN sample is small and fixed-shape (a 600x600x3 float32 image
and a few KB of boxes and labels, about 4.3 MB; a quarter of that in uint8),
so a whole VOC trainval split fits in host RAM. Caching the decoded sample
dict makes every epoch after the first a copy instead of a decode.

Placement: the cache wraps the *base* dataset, below ``AugmentedView``
(``data/augment.py``): flips stay per-(seed, epoch, index) on top of cached
decodes, and ``hflip_sample`` copies instead of mutating, so cached arrays
are never written. Consumers must treat samples as read-only (``collate``'s
``np.stack`` copies).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


class CachedView:
    """Map-style view memoizing ``dataset[i]`` sample dicts in RAM.

    First access per index pays the full decode; later accesses return the
    stored dict (shallow-copied so callers replacing keys — e.g.
    ``hflip_sample`` — never touch the cache entry).

    Thread-safety: the hot (cached) path is a lock-free dict read; the
    cold path takes a lock around insert+byte-accounting only, so two
    threads racing on the same cold index may both decode (wasted work)
    but charge the byte budget exactly once.

    ``max_bytes`` (default 64 GiB, env ``FRCNN_CACHE_MAX_BYTES``) bounds
    the cache: once the running total of stored sample bytes would exceed
    it, further samples pass through uncached (no eviction — epoch access
    is uniform, so evicting one entry to admit another buys nothing).
    """

    def __init__(self, dataset, max_bytes: Optional[int] = None) -> None:
        import os

        self.dataset = dataset
        if max_bytes is None:
            max_bytes = int(
                os.environ.get("FRCNN_CACHE_MAX_BYTES", str(64 << 30))
            )
        self.max_bytes = int(max_bytes)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._bytes = 0
        self._full = False
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.dataset)

    def __getattr__(self, name):
        # delegate dataset metadata (class names, ids, ...) transparently
        return getattr(self.dataset, name)

    @property
    def nbytes(self) -> int:
        """Bytes currently held by cached samples."""
        return self._bytes

    def warm(self) -> None:
        """Decode every sample into the cache (the first epoch's cost, paid
        up front)."""
        for i in range(len(self)):
            self[i]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx = int(idx)
        hit = self._cache.get(idx)
        if hit is not None:
            return dict(hit)
        sample = self.dataset[idx]
        if not self._full:
            size = sum(
                v.nbytes for v in sample.values() if isinstance(v, np.ndarray)
            )
            with self._lock:
                if idx not in self._cache:
                    if self._bytes + size <= self.max_bytes:
                        self._cache[idx] = sample
                        self._bytes += size
                    else:
                        self._full = True
        return dict(sample)
