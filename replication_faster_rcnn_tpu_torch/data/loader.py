"""Batch assembly (the JAX package's ``data/loader.py::collate``, numpy only;
the threaded loader, caching and augmentation are not ported yet)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
