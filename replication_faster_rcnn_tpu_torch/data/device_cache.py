"""Device-resident dataset cache (counterpart of the JAX package's
``data/device_cache.py``): the whole fixed-shape dataset on the card, each
step shipping only its selection.

The dataset is stacked into contiguous tensors (image [N, H, W, 3] uint8 or
float32, boxes [N, M, 4] float32, labels [N, M] int32, mask [N, M] bool, and
any other per-sample key such as ``difficult``) and uploaded once; the
tensors stay at their addresses for the cache's life, so a CUDA graph
captured over the cached step reads them in place. Every step the host ships
the selection (``sel``): indices, flip bits, jitter geometry, a few hundred
bytes. :func:`materialize_batch` gathers, flips and moves the boxes inside
the step (on the card: ``ops/image.py::augment_cached``, the image kernels).

Decisions reuse the host pipeline's counter mix (``augment.draw_decisions``),
so a cached run and a loader-fed ``augment_scale_device`` run with the same
(seed, epoch) see the same samples. The byte guard refuses a dataset over
``FRCNN_DEVICE_CACHE_MAX_BYTES`` (default 8 GiB) before decoding it: VOC2007
trainval at 600x600 is 5.41 GB in uint8 and 21.6 GB in float32.

Not ported yet: multi-process sharding of the sampler.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.data.augment import draw_decisions, jitter_geometry
from replication_faster_rcnn_tpu_torch.data.loader import collate
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans

Tensor = torch.Tensor

# above this the constructor refuses and points at the host loader
DEFAULT_MAX_BYTES = 8 << 30


class DeviceCache:
    """Upload a map-style dataset's samples to the device once.

    ``keep_host_meta`` also keeps a host copy of the small non-image arrays
    (boxes, labels, mask, difficult, ...) as ``self.host_meta``, for an
    evaluation that scores on the host; training leaves it off."""

    def __init__(
        self,
        dataset,
        device: DeviceLike = None,
        max_bytes: Optional[int] = None,
        keep_host_meta: bool = False,
    ):
        if max_bytes is None:
            max_bytes = int(
                os.environ.get("FRCNN_DEVICE_CACHE_MAX_BYTES", DEFAULT_MAX_BYTES)
            )

        def _over_cap(nbytes: int) -> ValueError:
            return ValueError(
                f"device cache would need {nbytes / 2**30:.2f} GiB "
                f"(> {max_bytes / 2**30:.2f} GiB cap). Use uint8 samples "
                "(data.device_normalize=True / --device-normalize) or fall "
                "back to the host loader (--cache-ram). Override with "
                "FRCNN_DEVICE_CACHE_MAX_BYTES."
            )

        # estimate BEFORE materializing anything: samples are fixed-shape, so
        # sample 0 prices the dataset, and an over-cap float32 VOC fails here
        # rather than after a full decode pass
        first = {k: v for k, v in dataset[0].items() if k != "jitter"}
        est = sum(np.asarray(v).nbytes for v in first.values()) * len(dataset)
        if est > max_bytes:
            raise _over_cap(est)
        self.device = resolve_device(device)
        with tspans.current_tracer().span("data/cache_upload", cat="data", n=len(dataset)):
            stacked = collate([dataset[i] for i in range(len(dataset))])
            # jitter geometry attaches per step via sel, never via the cache
            stacked.pop("jitter", None)
            nbytes = sum(v.nbytes for v in stacked.values())
            if nbytes > max_bytes:  # exact check (shapes are fixed)
                raise _over_cap(nbytes)
            self.nbytes = nbytes
            self.n = len(dataset)
            self.image_hw = tuple(stacked["image"].shape[1:3])
            self.host_meta = (
                {k: v for k, v in stacked.items() if k != "image"} if keep_host_meta else None
            )
            self.arrays: Dict[str, Tensor] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in stacked.items()
            }

    def __len__(self) -> int:
        return self.n


class CachedSampler:
    """Per-epoch batch selections for a :class:`DeviceCache`.

    The epoch order is the loader's ``RandomState(seed + epoch)``
    permutation and the per-sample flip / jitter decisions come from
    ``augment.draw_decisions``, so swapping feeds changes nothing about what
    the model sees. Yields ``sel`` dicts: ``idx`` [B] int32, plus ``flip``
    [B] bool with ``hflip`` and ``jitter`` [B, 4] int32 with a scale range."""

    def __init__(
        self,
        n: int,
        image_hw,
        batch_size: int,
        seed: int,
        hflip: bool = False,
        scale_range=None,
        shuffle: bool = True,
        drop_last: bool = True,
        train_resolutions=(),
        bucket_chunk: int = 1,
    ):
        if scale_range is not None:
            lo, hi = float(scale_range[0]), float(scale_range[1])
            if not 0.1 <= lo <= hi <= 4.0:
                raise ValueError(
                    f"scale_range must satisfy 0.1 <= lo <= hi <= 4, got {scale_range!r}")
            scale_range = (lo, hi)
        self.n = int(n)
        self.h, self.w = int(image_hw[0]), int(image_hw[1])
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.hflip = bool(hflip)
        self.scale_range = scale_range
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        # the same bucket contract as DataLoader.bucket_of
        self.train_resolutions = tuple((int(r[0]), int(r[1])) for r in (train_resolutions or ()))
        self.bucket_chunk = max(1, int(bucket_chunk))
        self.epoch = 0
        self.start_batch = 0  # mid-epoch offset (set_epoch)

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Select the epoch, optionally resuming at a mid-epoch batch: the
        consumed prefix of the epoch's order is skipped without being
        drawn (``DataLoader.set_epoch``'s contract)."""
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.epoch = int(epoch)
        self.start_batch = int(start_batch)

    def bucket_of(self, batch_pos: int) -> int:
        """Resolution-bucket index of the batch at ``batch_pos`` (0 when
        bucketing is off), as ``DataLoader.bucket_of``."""
        if len(self.train_resolutions) <= 1:
            return 0
        from replication_faster_rcnn_tpu_torch.data.augment import bucket_index

        return bucket_index(self.seed, self.epoch, int(batch_pos), len(self.train_resolutions),
                            chunk=self.bucket_chunk)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def queue_depth(self) -> int:
        """Selections are drawn on demand: nothing waits (the watchdog's
        gauge, as ``DataLoader.queue_depth``)."""
        return 0

    def selection(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        """The sel dict for explicit sample indices (any feed order)."""
        sel: Dict[str, np.ndarray] = {"idx": np.asarray(idxs, np.int32)}
        if self.hflip:
            sel["flip"] = np.array(
                [draw_decisions(self.seed, self.epoch, int(i), self.scale_range)[0]
                 for i in idxs],
                dtype=bool,
            )
        if self.scale_range is not None:
            geoms = []
            for i in idxs:
                _, scale, off_y, off_x = draw_decisions(
                    self.seed, self.epoch, int(i), self.scale_range)
                geoms.append(jitter_geometry(self.h, self.w, scale, off_y, off_x))
            sel["jitter"] = np.asarray(geoms, np.int32)
        return sel

    def __iter__(self):
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(self.n)
        else:
            order = np.arange(self.n)
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_last else 0)
        for i in range(self.start_batch * bs, end, bs):
            yield self.selection(order[i:i + bs])


def stack_selections(sels) -> Dict[str, np.ndarray]:
    """Stack K per-step selection dicts into one [K, B, ...] chunk for a
    K-step dispatch. All selections carry the same keys (one sampler)."""
    if not sels:
        raise ValueError("stack_selections needs at least one selection")
    return {k: np.stack([s[k] for s in sels]) for k in sels[0]}


def materialize_batch(cache: Dict[str, Tensor], sel: Dict[str, Tensor],
                      resample: bool = False) -> Dict[str, Tensor]:
    """The step's batch from the cache: gather + hflip + jitter box affine,
    as the host device-mode pipeline (``augment.AugmentedView`` with
    ``scale_on_device``) does: flip-then-jitter, flips keyed on
    ``labels >= 0``, jitter box collapse to the padded-row convention, and
    the per-row identity guard. The ``jitter`` key passes through for the
    step's resample (``ops/image.py::batched_scale_jitter``), as JAX's does;
    with ``resample`` the image is resampled here instead (on the card in
    the same pass as the gather) and the key is dropped.

    On the card this is the image kernels (``ops/image.py::augment_cached``),
    and the batch holds the step's four keys only; on the CPU, or under
    ``ops.reference_scope()``, the plain tensor code below, with every
    cached key gathered."""
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.ops import image as image_ops

    idx = sel["idx"]
    images = cache["image"]
    if images.is_cuda and not ops.reference_requested():
        # the kernels gather the step's keys; the others (difficult) stay
        out_images, boxes, labels, mask = image_ops.augment_cached(cache, sel, resample)
        batch = {}
    else:
        gathered = {k: v.index_select(0, idx.long()) for k, v in cache.items()}
        out_images = gathered["image"]
        boxes, labels, mask = gathered["boxes"], gathered["labels"], gathered["mask"]
        h, w = images.shape[1], images.shape[2]
        if "flip" in sel:
            out_images, boxes = image_ops.hflip_batch_with_boxes(
                out_images, boxes, labels, sel["flip"])
        if "jitter" in sel:
            # the host path skips jitter_boxes where the rounded geometry is
            # the identity: without the same skip, the <1px collapse would
            # kill a raw sub-pixel GT box no geometry was applied to
            jitter = sel["jitter"]
            ident = torch.tensor([h, w, 0, 0], dtype=jitter.dtype, device=jitter.device)
            boxes, labels, mask = image_ops.jitter_boxes_batch(
                boxes, labels, mask, jitter, h, w, torch.any(jitter != ident, dim=-1))
            if resample:
                out_images = image_ops.batched_scale_jitter(out_images, jitter)
        batch = {k: v for k, v in gathered.items()
                 if k not in ("image", "boxes", "labels", "mask")}
    batch.update(image=out_images, boxes=boxes, labels=labels, mask=mask)
    if "jitter" in sel and not resample:
        batch["jitter"] = sel["jitter"]
    return batch
