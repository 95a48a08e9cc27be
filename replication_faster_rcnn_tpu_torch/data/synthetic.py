"""Synthetic detection dataset: deterministic random images with planted
boxes (a copy of the JAX package's ``data/synthetic.py``, numpy only).

Images hold bright class-coloured rectangles at the box locations, so a
detector can fit the data and not only the shapes. Samples are normalised
float32 images, or with ``data.device_normalize`` the raw pixels as uint8
(the model's preprocess normalizes them on the card).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from replication_faster_rcnn_tpu_torch.config import DataConfig


class SyntheticDataset:
    """Deterministic per-index random samples (same idx -> same sample)."""

    def __init__(
        self,
        cfg: DataConfig,
        split: str = "train",
        length: int = 64,
        num_classes: int = 21,
        max_objects: int = 4,
        seed: int = 0,
    ) -> None:
        self.cfg = cfg
        self.length = length
        self.num_classes = num_classes
        self.max_objects = min(max_objects, cfg.max_boxes)
        # different splits get disjoint streams
        self.seed = seed + {"train": 0, "val": 1 << 20, "test": 2 << 20}.get(split, 0)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        rng = np.random.RandomState(self.seed + idx)
        h, w = self.cfg.image_size
        m = self.cfg.max_boxes

        image = rng.uniform(0.0, 0.15, (h, w, 3)).astype(np.float32)
        n_obj = rng.randint(1, self.max_objects + 1)
        labels = np.full((m,), -1, np.int32)
        boxes = np.full((m, 4), -1.0, np.float32)
        for i in range(n_obj):
            bh = rng.randint(h // 8, h // 2)
            bw = rng.randint(w // 8, w // 2)
            r1 = rng.randint(0, h - bh)
            c1 = rng.randint(0, w - bw)
            cls = rng.randint(1, self.num_classes)
            boxes[i] = [r1, c1, r1 + bh, c1 + bw]
            labels[i] = cls
            # paint the object: class-dependent color block + noise
            color = 0.3 + 0.7 * np.asarray(
                [(cls % 3) / 2.0, ((cls // 3) % 3) / 2.0, ((cls // 9) % 3) / 2.0],
                np.float32,
            )
            image[r1 : r1 + bh, c1 : c1 + bw] = color + rng.uniform(
                -0.05, 0.05, (bh, bw, 3)
            ).astype(np.float32)

        if self.cfg.device_normalize:
            # raw pixels in [0, 1] -> uint8; the u8 and f32 paths see the
            # same image up to 1/255 quantization
            image = np.clip(np.rint(image * 255.0), 0, 255).astype(np.uint8)
        else:
            mean = np.asarray(self.cfg.pixel_mean, np.float32)
            std = np.asarray(self.cfg.pixel_std, np.float32)
            image = (image - mean) / std
        return {
            "image": image,
            "boxes": boxes,
            "labels": labels,
            "mask": labels >= 0,
            "difficult": np.zeros((m,), bool),
        }
