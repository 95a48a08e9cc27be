"""Train-time augmentation, deterministic and resume-reproducible (a copy
of the JAX package's ``data/augment.py``, numpy only).

Everything here is numpy on host samples (the fixed sample dict of
``data/voc.py``), decided by a counter-based per-(seed, epoch, index) mix:
no global state, so the same epoch re-yields the same flips after a
checkpoint resume, whatever the loader's threads. :func:`device_decisions`
is the numpy oracle of the on-card draws (``ops/image.py::augment_draws``
and the geometry kernel), :func:`translate_sample` of the on-card
translation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def hflip_sample(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Mirror a sample left-right: image columns reversed, each real
    box's x-span reflected ((y1,x1,y2,x2) -> (y1, W-x2, y2, W-x1));
    padded (-1) rows stay untouched.

    Keyed on ``labels >= 0``, not the training ``mask``: difficult
    objects keep their geometry consistent with the mirrored pixels even
    when masked out of training (they are ignore-regions at eval time)."""
    # C-contiguous copy, NOT the negative-stride view `[:, ::-1, :]`:
    # consumers that stage samples individually (device_put, per-sample
    # caches) would silently re-copy a strided view per image; collate's
    # np.stack hid that for the batch path only
    image = np.ascontiguousarray(sample["image"][:, ::-1, :])
    w = float(image.shape[1])
    boxes = sample["boxes"].copy()
    valid = np.asarray(sample["labels"] >= 0, bool)
    flipped = boxes[valid]
    boxes[valid] = np.stack(
        [flipped[:, 0], w - flipped[:, 3], flipped[:, 2], w - flipped[:, 1]],
        axis=1,
    )
    out = dict(sample)
    out["image"] = image
    out["boxes"] = boxes
    return out


def _resize_bilinear(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel-center bilinear resize, pure vectorized numpy.

    Matches the continuous-coordinate model the box transform assumes:
    a point at continuous x maps to x * ow/w exactly."""
    h, w = image.shape[:2]
    im = image.astype(np.float32)
    ys = (np.arange(oh, dtype=np.float32) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow, dtype=np.float32) + 0.5) * (w / ow) - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    top = im[y0c][:, x0c] * (1 - wx) + im[y0c][:, x1c] * wx
    bot = im[y1c][:, x0c] * (1 - wx) + im[y1c][:, x1c] * wx
    out = top * (1 - wy) + bot * wy
    if image.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)


def jitter_geometry(
    h: int, w: int, scale: float, off_y: float, off_x: float
) -> tuple:
    """(ch, cw, shift_y, shift_x): the integer jitter geometry shared by
    the host resample below and the on-device one (`ops/image.py`) —
    both sides consume the SAME rounded integers, so they can never
    disagree about sub-pixel placement."""
    ch, cw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    shift_y = int(round((ch - h) * float(np.clip(off_y, 0.0, 1.0))))
    shift_x = int(round((cw - w) * float(np.clip(off_x, 0.0, 1.0))))
    return ch, cw, shift_y, shift_x


def jitter_boxes(
    sample: Dict[str, np.ndarray], geom: tuple, h: int, w: int
) -> Dict[str, np.ndarray]:
    """Box/label/mask half of the jitter (image untouched): the affine
    b*s - shift with canvas clipping; collapsed rows take the padded-row
    convention (label -1, mask False, -1 geometry)."""
    ch, cw, shift_y, shift_x = geom
    sy, sx = ch / h, cw / w
    boxes = sample["boxes"].copy()
    labels = sample["labels"].copy()
    mask = sample["mask"].copy() if "mask" in sample else None
    valid = np.asarray(labels >= 0, bool)
    if valid.any():
        b = boxes[valid]
        b = np.stack(
            [
                b[:, 0] * sy - shift_y,
                b[:, 1] * sx - shift_x,
                b[:, 2] * sy - shift_y,
                b[:, 3] * sx - shift_x,
            ],
            axis=1,
        )
        b[:, 0::2] = np.clip(b[:, 0::2], 0.0, float(h))
        b[:, 1::2] = np.clip(b[:, 1::2], 0.0, float(w))
        collapsed = ((b[:, 2] - b[:, 0]) < 1.0) | ((b[:, 3] - b[:, 1]) < 1.0)
        b[collapsed] = -1.0
        boxes[valid] = b
        vi = np.flatnonzero(valid)[collapsed]
        labels[vi] = -1
        if mask is not None:
            mask[vi] = False
    out = dict(sample)
    out["boxes"] = boxes
    out["labels"] = labels
    if mask is not None:
        out["mask"] = mask
    return out


def scale_jitter_sample(
    sample: Dict[str, np.ndarray],
    scale: float,
    off_y: float,
    off_x: float,
) -> Dict[str, np.ndarray]:
    """Random-scale view on a FIXED canvas (the step's shapes never change).

    The image content is resized by ``scale``; zoom-out (<1) pads the
    canvas with the image's channel means (the normalization's zero in
    f32 samples, a neutral gray for uint8 device-normalize samples),
    zoom-in (>1) crops a canvas-sized window. ``off_y``/``off_x`` in
    [0, 1] place the content/window (0.5 = centered). Boxes follow the
    same continuous-coordinate affine (b*s - shift), are clipped to the
    canvas, and rows that collapse below 1px get label -1 / mask False /
    -1-filled geometry — identical to the loader's padded-row
    convention, so downstream target assignment and eval are unaffected.

    """
    image = sample["image"]
    h, w = image.shape[:2]
    geom = jitter_geometry(h, w, scale, off_y, off_x)
    ch, cw, shift_y, shift_x = geom
    if image.dtype == np.uint8:
        # the host library's uint8 resize (the same half-pixel spec) keeps
        # the device-normalize ingest path off the pure-numpy gather
        from replication_faster_rcnn_tpu_torch.data.native_ops import resize_u8

        content = resize_u8(image, (ch, cw))
    else:
        content = _resize_bilinear(image, ch, cw)

    canvas = np.empty_like(image)
    if ch < h or cw < w:  # zoom-in content covers the whole canvas
        fill = image.mean(axis=(0, 1))
        if image.dtype == np.uint8:
            fill = np.clip(np.rint(fill), 0, 255)
        canvas[:] = fill.astype(image.dtype)[None, None, :]
    # content-placement shift: out = in*s - shift (negative = padding)
    src_y0, dst_y0 = max(0, shift_y), max(0, -shift_y)
    src_x0, dst_x0 = max(0, shift_x), max(0, -shift_x)
    span_y = min(ch - src_y0, h - dst_y0)
    span_x = min(cw - src_x0, w - dst_x0)
    canvas[dst_y0 : dst_y0 + span_y, dst_x0 : dst_x0 + span_x] = content[
        src_y0 : src_y0 + span_y, src_x0 : src_x0 + span_x
    ]

    out = jitter_boxes(sample, geom, h, w)
    out["image"] = canvas
    return out


def _splitmix(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def draw_decisions(seed: int, epoch: int, idx: int, scale_range=None):
    """The per-(seed, epoch, idx) augmentation draws: (flip_bit, scale,
    off_y, off_x); the last three are None without a scale range.

    Shared by :class:`AugmentedView` (host pipeline) and the
    device-resident cache sampler (`data/device_cache.py`) so both feed
    paths make IDENTICAL decisions for the same sample — the counter-mix
    is order-free, so any worker/process/backend agrees."""
    z = _splitmix(
        (
            seed * 0x9E3779B97F4A7C15
            + epoch * 0xBF58476D1CE4E5B9
            + idx * 0x94D049BB133111EB
        )
        & 0xFFFFFFFFFFFFFFFF
    )
    flip = bool(z & 1)
    if scale_range is None:
        return flip, None, None, None
    lo, hi = scale_range
    z2 = _splitmix(z + 0x9E3779B97F4A7C15)
    z3 = _splitmix(z2 + 0x9E3779B97F4A7C15)
    z4 = _splitmix(z3 + 0x9E3779B97F4A7C15)
    u = (z2 >> 11) / float(1 << 53)
    scale = lo + (hi - lo) * u
    off_y = (z3 >> 11) / float(1 << 53)
    off_x = (z4 >> 11) / float(1 << 53)
    return flip, scale, off_y, off_x


def device_decisions(seed: int, epoch: int, idx: int):
    """Host-numpy oracle for the ON-DEVICE draw stream
    (`ops/image.py::augment_draws`): (flip, u_scale, u_off_y, u_off_x,
    u_translate_y, u_translate_x), the uniforms as exact np.float32.

    Same splitmix64 counter-mix as :func:`draw_decisions`, but the +GAMMA
    chain wraps at 64 bits (the device limbs must) and each uniform takes
    the TOP 24 bits scaled by 2^-24 — both exactly representable in f32,
    so device and host compute bit-identical values. A separate stream on
    purpose: the legacy host draws burn 53-bit f64 uniforms that f32
    can't reproduce."""
    z = _splitmix(
        (
            seed * 0x9E3779B97F4A7C15
            + epoch * 0xBF58476D1CE4E5B9
            + idx * 0x94D049BB133111EB
        )
        & 0xFFFFFFFFFFFFFFFF
    )
    flip = bool(z & 1)
    us = []
    for _ in range(5):
        z = _splitmix((z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
        us.append(np.float32(z >> 40) * np.float32(1.0 / (1 << 24)))
    return (flip, *us)


def translate_sample(
    sample: Dict[str, np.ndarray], dy: int, dx: int
) -> Dict[str, np.ndarray]:
    """Host-numpy oracle for `ops/image.py::translate_batch_with_boxes`:
    output pixel (y, x) reads input (y + dy, x + dx), out-of-range reads
    take the channel-mean fill; real boxes move by (-dy, -dx) with canvas
    clipping, sub-1px rows collapse to the padded-row convention."""
    image = sample["image"]
    h, w = image.shape[:2]
    iy = np.arange(h) + int(dy)
    ix = np.arange(w) + int(dx)
    out_img = image[np.clip(iy, 0, h - 1)][:, np.clip(ix, 0, w - 1)].copy()
    fill = image.astype(np.float32).mean(axis=(0, 1))
    if image.dtype == np.uint8:
        fill = np.clip(np.rint(fill), 0, 255)
    fill = fill.astype(image.dtype)
    invalid = ~(
        ((iy >= 0) & (iy < h))[:, None] & ((ix >= 0) & (ix < w))[None, :]
    )
    out_img[invalid] = fill

    boxes = sample["boxes"].copy()
    labels = sample["labels"].copy()
    mask = sample["mask"].copy() if "mask" in sample else None
    valid = np.asarray(labels >= 0, bool)
    if valid.any():
        b = boxes[valid] - np.asarray(
            [dy, dx, dy, dx], boxes.dtype
        )
        b[:, 0::2] = np.clip(b[:, 0::2], 0.0, float(h))
        b[:, 1::2] = np.clip(b[:, 1::2], 0.0, float(w))
        collapsed = ((b[:, 2] - b[:, 0]) < 1.0) | ((b[:, 3] - b[:, 1]) < 1.0)
        b[collapsed] = -1.0
        boxes[valid] = b
        vi = np.flatnonzero(valid)[collapsed]
        labels[vi] = -1
        if mask is not None:
            mask[vi] = False
    out = dict(sample)
    out["image"] = out_img
    out["boxes"] = boxes
    out["labels"] = labels
    if mask is not None:
        out["mask"] = mask
    return out


def bucket_index(
    seed: int, epoch: int, batch: int, n_buckets: int, chunk: int = 1
) -> int:
    """Deterministic resolution-bucket assignment for one GLOBAL batch.

    Multi-scale bucketed training (data.train_resolutions) keys the
    bucket on (seed, epoch, batch // chunk) through the same splitmix
    counter-mix as :func:`draw_decisions` — a pure function of the
    global batch position, so a `set_epoch(epoch, start_batch=)` resume
    replays the identical bucket sequence, every process of a multi-host
    run agrees on each batch's bucket, and all ``chunk`` batches of one
    fused K-step dispatch (train.steps_per_dispatch) land in the SAME
    bucket (one fused program per dispatch). A distinct salt keeps the
    bucket stream independent of the per-sample augmentation draws.
    """
    if n_buckets <= 1:
        return 0
    z = _splitmix(
        (
            seed * 0x9E3779B97F4A7C15
            + epoch * 0x94D049BB133111EB
            + (batch // max(1, chunk)) * 0xBF58476D1CE4E5B9
            + 0xD1B54A32D192ED03  # bucket-stream salt
        )
        & 0xFFFFFFFFFFFFFFFF
    )
    return int(z % n_buckets)


class AugmentTagView:
    """Device-augmentation feed (data.augment_device): samples pass
    through UNTOUCHED except an attached int32 ``aug = [idx, epoch]`` row.
    The train step draws every augmentation decision from
    (seed, epoch, idx) itself (`ops/image.py::augment_batch`), so the
    host loader stops touching pixels entirely — the last host per-image
    loop of the reference pipeline is gone, not moved."""

    def __init__(self, dataset, epoch: int) -> None:
        self.dataset = dataset
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        out = dict(self.dataset[idx])
        out["aug"] = np.asarray([int(idx), self.epoch], np.int32)
        return out


class AugmentedView:
    """Map-style view applying per-sample train augmentations: a 50%
    horizontal flip and/or a scale jitter drawn from ``scale_range``.

    Decisions for (seed, epoch, idx) come from a small counter-based mix
    — not Python ``hash`` (salted for some types) and not a shared RNG
    stream (order-dependent) — so any worker, process or thread,
    computes the same decisions for the same sample.
    """

    def __init__(
        self,
        dataset,
        seed: int,
        epoch: int,
        hflip: bool = True,
        scale_range=None,
        scale_on_device: bool = False,
    ) -> None:
        self.dataset = dataset
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.hflip = bool(hflip)
        if scale_range is not None:
            lo, hi = float(scale_range[0]), float(scale_range[1])
            if not 0.1 <= lo <= hi <= 4.0:
                raise ValueError(
                    f"scale_range must satisfy 0.1 <= lo <= hi <= 4, got {scale_range!r}"
                )
            scale_range = (lo, hi)
        self.scale_range = scale_range
        # device mode: the host transforms boxes only and attaches the
        # integer jitter geometry as sample["jitter"]; the image resample
        # runs on the card (`ops/image.py::batched_scale_jitter`)
        self.scale_on_device = bool(scale_on_device) and scale_range is not None

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        sample = self.dataset[idx]
        # splitmix64 finalizer chain on the (seed, epoch, idx) mix; one
        # output bit is the flip coin, further outputs drive the jitter —
        # no per-sample Mersenne Twister construction on the ingest path
        flip, scale, off_y, off_x = draw_decisions(
            self.seed, self.epoch, idx, self.scale_range
        )
        # Order is mode-dependent ON PURPOSE. Host mode keeps the
        # original jitter-then-flip, so a fixed (seed, epoch, idx) gives the
        # JAX package's samples byte for byte. Device mode is
        # flip-then-jitter: the flip must land before collate (it is a
        # host view), so the on-card resample always acts on the flipped
        # frame. The two orders are distributionally identical (the
        # placement offsets are uniform and mirror-symmetric).
        if self.scale_on_device and self.hflip and flip:
            sample = hflip_sample(sample)
        if self.scale_range is not None:
            # "did this draw move any pixels?" is decided by the ROUNDED
            # integer geometry, not a deadband on the continuous scale: a
            # scale of 1.0009 at 600 px rounds to a 601-px canvas and IS a
            # jitter, while 1.0004 rounds back to identity
            h, w = sample["image"].shape[:2]
            geom = jitter_geometry(h, w, scale, off_y, off_x)
            jittered = geom != (h, w, 0, 0)
            if self.scale_on_device:
                if jittered:
                    sample = jitter_boxes(sample, geom, h, w)
                out = dict(sample)
                out["jitter"] = np.asarray(geom, np.int32)
                sample = out
            elif jittered:
                sample = scale_jitter_sample(sample, scale, off_y, off_x)
        if not self.scale_on_device and self.hflip and flip:
            sample = hflip_sample(sample)
        return sample
