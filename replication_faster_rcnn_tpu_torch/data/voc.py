"""Pascal VOC dataset (a copy of the JAX package's ``data/voc.py``, numpy
only).

* XML via stdlib ``xml.etree``; 1-based inclusive XML coordinates become
  the package's 0-based continuous ones (mins - 1, maxes kept).
* Boxes are row-major ``[ymin, xmin, ymax, xmax]``, padded to
  ``max_boxes`` with -1; they are scaled to the resized frame and rounded.
* ``difficult`` objects keep their class label: the training ``mask``
  excludes them unless ``use_difficult``, and evaluation reads
  ``difficult`` to ignore them.
* Images are decoded by the host library's libjpeg path where it was built
  with one, else by PIL; the resize and normalize is always the C++ one
  (``data/native_ops.py``).
"""

from __future__ import annotations

import io
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from replication_faster_rcnn_tpu_torch.config import VOC_CLASSES, DataConfig
from replication_faster_rcnn_tpu_torch.data import native_ops


def _load_image(path: str, image_size, pixel_mean, pixel_std,
                device_normalize: bool = False):
    """JPEG file -> (normalized float32 [H, W, 3], orig_h, orig_w), or with
    ``device_normalize`` the resized uint8 image (normalized on the card)."""
    with open(path, "rb") as f:
        data = f.read()
    if native_ops.has_jpeg():
        decoded = (
            native_ops.decode_jpeg_resize_u8(data, image_size)
            if device_normalize
            else native_ops.decode_jpeg_resize_normalize(data, image_size, pixel_mean, pixel_std)
        )
        if decoded is not None:
            return decoded
    from PIL import Image  # a non-JPEG file, or a library built without libjpeg

    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    if device_normalize:
        return native_ops.resize_u8(arr, image_size), arr.shape[0], arr.shape[1]
    out = native_ops.resize_normalize(arr, image_size, pixel_mean, pixel_std)
    return out, arr.shape[0], arr.shape[1]


class VOCDataset:
    """Map-style dataset of fixed-shape numpy samples: ``'image'`` [H, W, 3]
    float32 normalized (uint8 with ``device_normalize``), ``'boxes'`` [M, 4]
    float32, ``'labels'`` [M] int32 (-1 pad), ``'mask'`` [M] bool,
    ``'difficult'`` [M] bool."""

    classes = VOC_CLASSES

    def __init__(self, cfg: DataConfig, split: str = "train",
                 image_set: Optional[str] = None) -> None:
        if split not in ("train", "val", "trainval", "test"):
            raise ValueError(f"bad split {split!r}")
        self.cfg = cfg
        self.split = split
        self.root = cfg.root_dir
        self.class_to_id = {c: i for i, c in enumerate(self.classes)}
        name = f"{image_set}_{split}.txt" if image_set else f"{split}.txt"
        with open(os.path.join(self.root, "ImageSets", "Main", name)) as f:
            self.ids: List[str] = [ln.split()[0] for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def _parse_annotation(self, xml_path: str):
        """XML -> (labels [M], boxes [M, 4], difficult [M]) padded with -1;
        objects past ``max_boxes`` are dropped."""
        m = self.cfg.max_boxes
        labels = np.full((m,), -1, np.int32)
        boxes = np.full((m, 4), -1.0, np.float32)
        difficult = np.zeros((m,), bool)
        root = ET.parse(xml_path).getroot()
        for i, obj in enumerate(root.iter("object")):
            if i >= m:
                break
            name = obj.findtext("name")
            if name not in self.class_to_id:
                raise ValueError(f"unknown class {name!r} in {xml_path}")
            bnd = obj.find("bndbox")
            boxes[i] = [
                float(bnd.findtext("ymin")) - 1.0,
                float(bnd.findtext("xmin")) - 1.0,
                float(bnd.findtext("ymax")),
                float(bnd.findtext("xmax")),
            ]
            labels[i] = self.class_to_id[name]
            difficult[i] = obj.findtext("difficult", default="0").strip() == "1"
        return labels, boxes, difficult

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_id = self.ids[idx]
        image, orig_h, orig_w = _load_image(
            os.path.join(self.root, "JPEGImages", img_id + ".jpg"),
            self.cfg.image_size, self.cfg.pixel_mean, self.cfg.pixel_std,
            self.cfg.device_normalize,
        )
        labels, boxes, difficult = self._parse_annotation(
            os.path.join(self.root, "Annotations", img_id + ".xml"))
        real = labels >= 0
        new_h, new_w = self.cfg.image_size
        boxes = native_ops.scale_boxes(boxes, labels, new_h / orig_h, new_w / orig_w)
        mask = real if self.cfg.use_difficult else (real & ~difficult)
        return {
            "image": image,
            "boxes": boxes,
            "labels": labels,
            "mask": mask,
            "difficult": difficult & real,
        }
