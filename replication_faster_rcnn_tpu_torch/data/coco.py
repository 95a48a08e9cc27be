"""COCO-2017 dataset (a copy of the JAX package's ``data/coco.py``, numpy
and the standard library only).

Annotations are parsed with ``json``; pycocotools is needed only for COCO's
own evaluation metric, not for training. Samples come out in the format of
``VOCDataset``: row-major [ymin, xmin, ymax, xmax] boxes scaled to the
resized image, labels 1..80 (contiguous, background 0), -1 padding.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from replication_faster_rcnn_tpu_torch.config import DataConfig
from replication_faster_rcnn_tpu_torch.data.voc import _load_image


class COCODataset:
    """Map-style COCO detection dataset.

    Expects the standard layout: {root}/annotations/instances_{split}.json
    and {root}/{split}/ images (split like 'train2017'/'val2017').

    ``keep_empty=True`` keeps images whose every annotation was filtered
    (crowd-only or degenerate-only) or that have none at all; they come
    out as valid samples with all -1 padding (every detection on them
    scores as a false positive). Default False: train on images with at
    least one target, like py-faster-rcnn.
    """

    def __init__(
        self, cfg: DataConfig, split: str = "train2017",
        keep_empty: bool = False,
    ) -> None:
        self.cfg = cfg
        self.split = split
        ann_path = os.path.join(
            cfg.root_dir, "annotations", f"instances_{split}.json"
        )
        with open(ann_path) as f:
            ann = json.load(f)

        # category ids are sparse (1..90 with gaps); remap to contiguous 1..80
        cat_ids = sorted(c["id"] for c in ann["categories"])
        self.cat_to_label = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.classes = ["__background__"] + [
            c["name"] for c in sorted(ann["categories"], key=lambda c: c["id"])
        ]

        self.images = {im["id"]: im for im in ann["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {}
        for a in ann["annotations"]:
            if a.get("iscrowd", 0):
                continue  # crowd regions are not box targets
            self.anns_by_image.setdefault(a["image_id"], []).append(a)
        self.ids = [
            i for i in self.images
            if keep_empty or self.anns_by_image.get(i)
        ]
        self.ids.sort()

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_id = self.ids[idx]
        info = self.images[img_id]
        path = os.path.join(self.cfg.root_dir, self.split, info["file_name"])
        image, orig_h, orig_w = _load_image(
            path, self.cfg.image_size, self.cfg.pixel_mean,
            self.cfg.pixel_std, self.cfg.device_normalize,
        )

        m = self.cfg.max_boxes
        labels = np.full((m,), -1, np.int32)
        boxes = np.full((m, 4), -1.0, np.float32)
        new_h, new_w = self.cfg.image_size
        n = 0
        for a in self.anns_by_image.get(img_id, ()):
            if n == m:
                break
            x, y, w, h = a["bbox"]  # COCO xywh, column-major
            # clamp to the resized canvas (real COCO boxes overhang the
            # image edge by a pixel or two) and drop what degenerates to
            # zero extent — a zero-area target would poison the IoU
            # matching and the regression targets downstream
            r1 = min(max(y * new_h / orig_h, 0.0), new_h)
            c1 = min(max(x * new_w / orig_w, 0.0), new_w)
            r2 = min(max((y + h) * new_h / orig_h, 0.0), new_h)
            c2 = min(max((x + w) * new_w / orig_w, 0.0), new_w)
            if r2 - r1 <= 0.0 or c2 - c1 <= 0.0:
                continue
            boxes[n] = [r1, c1, r2, c2]
            labels[n] = self.cat_to_label[a["category_id"]]
            n += 1

        return {
            # float32, or uint8 with device_normalize (the JAX reader casts
            # that uint8 image to float32 0..255, which the model's
            # preprocess then passes through unnormalized)
            "image": image,
            "boxes": boxes,
            "labels": labels,
            "mask": labels >= 0,
            # COCO has no 'difficult' notion; uniform key for collate
            "difficult": np.zeros((m,), bool),
        }
