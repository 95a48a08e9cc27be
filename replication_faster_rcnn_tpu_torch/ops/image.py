"""Image ops of the training data path (counterpart of the JAX package's
``ops/image.py``): the on-card scale jitter, the fully on-card augmentation
(draws, flip, translation, jitter) and the multi-scale bucket resample.

Every public function has its plain PyTorch version here, which a CPU tensor
and ``ops.reference_scope()`` run; a CUDA tensor launches the kernels of
``ops/cuda/image_kernel.py`` (or raises). The plain versions repeat the JAX
functions' float32 arithmetic operation for operation, so they agree with
JAX run op by op bitwise, and the kernels repeat theirs.

Geometry contract (the same as ``data/augment.py::scale_jitter_sample``,
which is why the host ships rounded integers rather than the raw scale):
output pixel (y, x) reads content index (y + shift_y, x + shift_x); a content
index inside [0, ch) x [0, cw) maps to the source image at half-pixel-center
coordinates ((i + 0.5) * H / ch - 0.5), bilinear with edge-clamped taps;
outside it takes the per-image channel-mean fill. uint8 inputs round back to
uint8 (half to even) after each op.

Fills: JAX takes a float32 mean, whose summation order is XLA's. Here a
uint8 fill sums in int64 (exact) and rounds the mean; a float32 fill sums
in float64 and rounds to float32. The kernel sums in float64 in another
fixed order, so float32 fills may differ from the plain version by 1 ulp.

Random draws (``augment_draws``): splitmix64 of (seed, epoch, idx) on 32-bit
limbs held in int64 tensors, as JAX runs it on uint32 limbs (no reliance on
int64 wrap-around or on an arithmetic right shift); uniforms are the top 24
bits scaled by 2^-24, exact in float32 (``data/augment.py::device_decisions``
is the numpy oracle).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch import ops

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
_GAMMA = 0x9E3779B97F4A7C15


def _kernel_route(*tensors) -> bool:
    """True when the kernels run: a CUDA tensor outside ``reference_scope``."""
    return any(t is not None and t.is_cuda for t in tensors) and not ops.reference_requested()


def _kernels():
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

    return image_kernel


def _div(x: Tensor, d: float) -> Tensor:
    """``x / d`` divided element by element: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the division JAX and the kernels do."""
    return x / torch.full_like(x, d)


def _round_u8(x: Tensor) -> Tensor:
    return torch.clamp(torch.round(x), 0, 255)


def _channel_fill(image: Tensor) -> Tensor:
    """The channel means of one [H, W, C] image as float32 [C]: uint8 sums in
    int64 (exact), the mean rounded half to even; float32 sums in float64."""
    count = image.shape[0] * image.shape[1]
    if image.dtype == torch.uint8:
        mean = _div(image.to(torch.int64).sum(dim=(0, 1)).double(), count)
        return _round_u8(mean).float()
    return _div(image.double().sum(dim=(0, 1)), count).float()


def _clip(x: Tensor, lo, hi) -> Tensor:
    """jnp.clip: minimum(maximum(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


# --------------------------------------------------------------- scale jitter


def scale_jitter_image(image: Tensor, params: Tensor) -> Tensor:
    """One image [H, W, C] + int32 params [4] = (ch, cw, sy, sx)."""
    return batched_scale_jitter(image[None], params[None])[0]


def _scale_jitter_plain(image: Tensor, params: Tensor) -> Tensor:
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    ch = params[0].float()
    cw = params[1].float()
    im = image.float()
    iy = torch.arange(h, dtype=torch.int32, device=dev) + params[2]
    ix = torch.arange(w, dtype=torch.int32, device=dev) + params[3]
    valid_y = (iy >= 0) & (iy < params[0])
    valid_x = (ix >= 0) & (ix < params[1])
    ys = (iy.float() + 0.5) * (torch.tensor(float(h), dtype=torch.float32, device=dev) / ch) - 0.5
    xs = (ix.float() + 0.5) * (torch.tensor(float(w), dtype=torch.float32, device=dev) / cw) - 0.5
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    wy = (ys - y0.float())[:, None, None]
    wx = (xs - x0.float())[None, :, None]
    y0c, y1c = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    x0c, x1c = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
    top = im[y0c][:, x0c] * (1 - wx) + im[y0c][:, x1c] * wx
    bot = im[y1c][:, x0c] * (1 - wx) + im[y1c][:, x1c] * wx
    out = top * (1 - wy) + bot * wy
    fill = _channel_fill(image)
    valid = valid_y[:, None, None] & valid_x[None, :, None]
    out = torch.where(valid, out, fill[None, None, :])
    if image.dtype == torch.uint8:
        return _round_u8(out).to(torch.uint8)
    return out.to(image.dtype)


def batched_scale_jitter(images: Tensor, params: Tensor) -> Tensor:
    """images [N, H, W, C], params int32 [N, 4] -> jittered images, every row
    resampled (an identity row (H, W, 0, 0) passes through exactly)."""
    if _kernel_route(images):
        k = _kernels()
        _, _, _, geom, fills = k.augment_prepare_cuda(images, None, None, None, jitter=params,
                                                      resample="all")
        return k.augment_image_cuda(images, geom, fills)
    return torch.stack([_scale_jitter_plain(im, p) for im, p in zip(images, params)])


# --------------------------------------------------------------- the draws


def _mul32(a: Tensor, b: int) -> Tuple[Tensor, Tensor]:
    """Full 32x32 -> 64-bit product as (hi, lo) 32-bit limbs (int64 tensors
    holding [0, 2^32)), from 16-bit partial products."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00 = a0 * b0
    mid = a1 * b0 + (p00 >> 16)
    mid2 = a0 * b1 + (mid & 0xFFFF)
    lo = (p00 & 0xFFFF) | ((mid2 & 0xFFFF) << 16)
    hi = (a1 * b1 + (mid >> 16) + (mid2 >> 16)) & _MASK32
    return hi, lo


def _mul64(zh: Tensor, zl: Tensor, c: int) -> Tuple[Tensor, Tensor]:
    """The low 64 bits of z * c."""
    ch, cl = (c >> 32) & _MASK32, c & _MASK32
    hi, lo = _mul32(zl, cl)
    hi = (hi + ((zl * (ch & 0xFFFF)) & _MASK32) + (((zl * (ch >> 16)) & 0xFFFF) << 16)
          + ((zh * (cl & 0xFFFF)) & _MASK32) + (((zh * (cl >> 16)) & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def _add64(ah, al, bh, bl) -> Tuple[Tensor, Tensor]:
    lo = (al + bl) & _MASK32
    carry = (lo < al).to(torch.int64)
    return (ah + bh + carry) & _MASK32, lo


def _shr_xor(zh: Tensor, zl: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """z ^ (z >> n) for 0 < n < 32."""
    return zh ^ (zh >> n), zl ^ ((zl >> n) | ((zh << (32 - n)) & _MASK32))


def _splitmix64(zh: Tensor, zl: Tensor) -> Tuple[Tensor, Tensor]:
    zh, zl = _shr_xor(zh, zl, 30)
    zh, zl = _mul64(zh, zl, 0xBF58476D1CE4E5B9)
    zh, zl = _shr_xor(zh, zl, 27)
    zh, zl = _mul64(zh, zl, 0x94D049BB133111EB)
    return _shr_xor(zh, zl, 31)


def _draws_plain(seed: int, epoch: Tensor, idx: Tensor) -> Tuple[Tensor, ...]:
    s = (int(seed) * _GAMMA) & 0xFFFFFFFFFFFFFFFF
    e = epoch.to(torch.int64) & _MASK32  # int32 -> uint32, as astype(uint32)
    i = idx.to(torch.int64) & _MASK32
    zero = torch.zeros_like(e)
    eh, el = _mul64(zero, e, 0xBF58476D1CE4E5B9)
    ih, il = _mul64(zero, i, 0x94D049BB133111EB)
    mh, ml = _add64(*_add64(torch.full_like(e, s >> 32), torch.full_like(e, s & _MASK32),
                            eh, el), ih, il)
    zh, zl = _splitmix64(mh, ml)
    flip = (zl & 1).bool()
    gh, gl = torch.full_like(e, _GAMMA >> 32), torch.full_like(e, _GAMMA & _MASK32)
    us = []
    for _ in range(5):
        zh, zl = _splitmix64(*_add64(zh, zl, gh, gl))
        us.append((zh >> 8).float() * (1.0 / (1 << 24)))
    return (flip, *us)


def augment_draws(seed: int, epoch: Tensor, idx: Tensor) -> Tuple[Tensor, ...]:
    """Per-row draws: (flip bool, u_scale, u_off_y, u_off_x, u_ty, u_tx),
    bitwise ``data/augment.py::device_decisions`` (the numpy oracle)."""
    if _kernel_route(epoch, idx):
        aug = torch.stack([idx.to(torch.int32), epoch.to(torch.int32)], dim=-1)
        *_, draws = _kernels().augment_geometry_cuda(
            None, None, None, aug.shape[0], 1, 1, aug=aug, seed=seed, draws=True,
            device=aug.device)
        return (draws[:, 0] != 0, *draws[:, 1:].unbind(dim=1))
    return _draws_plain(seed, epoch, idx)


# ------------------------------------------------------- flip and translation


def _flip_boxes(boxes, labels, flip, w):
    """Each real box of a flipped row mirrored: (y1, x1, y2, x2) -> (y1,
    W - x2, y2, W - x1)."""
    mirrored = torch.stack(
        [boxes[..., 0], w - boxes[..., 3], boxes[..., 2], w - boxes[..., 1]], dim=-1)
    return torch.where((flip[:, None] & (labels >= 0))[..., None], mirrored, boxes)


def _hflip_plain(images, boxes, labels, flip):
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    return images, _flip_boxes(boxes, labels, flip, images.shape[2])


def hflip_batch_with_boxes(images: Tensor, boxes: Tensor, labels: Tensor,
                           flip: Tensor) -> Tuple[Tensor, Tensor]:
    """Mirror the rows where ``flip`` is set: image columns reversed, each
    real (labels >= 0) box's x-span reflected; padded rows untouched."""
    if _kernel_route(images):
        k = _kernels()
        n, h, w = images.shape[:3]
        out_boxes, _, _, geom, _ = k.augment_geometry_cuda(
            boxes, labels, None, n, h, w, flip=flip, device=images.device)
        return k.augment_image_cuda(images, geom, None), out_boxes
    return _hflip_plain(images, boxes, labels, flip)


def _translate_image(image: Tensor, dy: Tensor, dx: Tensor) -> Tensor:
    """Integer content shift on a fixed canvas: output (y, x) reads input
    (y + dy, x + dx); out-of-range reads take the channel-mean fill."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    iy = torch.arange(h, dtype=torch.int32, device=dev) + dy
    ix = torch.arange(w, dtype=torch.int32, device=dev) + dx
    out = image[torch.clamp(iy, 0, h - 1).long()][:, torch.clamp(ix, 0, w - 1).long()]
    fill = _channel_fill(image).to(image.dtype)
    valid = ((iy >= 0) & (iy < h))[:, None, None] & ((ix >= 0) & (ix < w))[None, :, None]
    return torch.where(valid, out, fill[None, None, :])


def _kill_collapsed(b, boxes, labels, mask, take):
    collapsed = ((b[..., 2] - b[..., 0]) < 1.0) | ((b[..., 3] - b[..., 1]) < 1.0)
    kill = take & collapsed
    boxes = torch.where(take[..., None], b, boxes)
    boxes = torch.where(kill[..., None], torch.full_like(boxes, -1.0), boxes)
    labels = torch.where(kill, torch.full_like(labels, -1), labels)
    mask = torch.where(kill, torch.zeros_like(mask), mask)
    return boxes, labels, mask


def _translate_boxes(boxes, labels, mask, shifts, h, w):
    """Real boxes moved by (-dy, -dx) with canvas clip; collapsed rows take
    the padded-row convention."""
    d = shifts.to(boxes.dtype)
    d = torch.cat([d, d], dim=-1)[:, None, :]  # (dy, dx, dy, dx)
    lim = torch.tensor([h, w, h, w], dtype=boxes.dtype, device=boxes.device)
    b = _clip(boxes - d, torch.zeros((), dtype=boxes.dtype, device=boxes.device), lim)
    return _kill_collapsed(b, boxes, labels, mask, labels >= 0)


def _translate_plain(images, boxes, labels, mask, shifts):
    h, w = images.shape[1], images.shape[2]
    images = torch.stack([_translate_image(im, s[0], s[1]) for im, s in zip(images, shifts)])
    return (images, *_translate_boxes(boxes, labels, mask, shifts, h, w))


def translate_batch_with_boxes(images: Tensor, boxes: Tensor, labels: Tensor, mask: Tensor,
                               shifts: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Images gather-shifted by int32 ``shifts`` [N, 2] = (dy, dx); real boxes
    move by (-dy, -dx) with canvas clip; rows collapsing below 1 px take the
    padded-row convention (label -1, mask False, -1 geometry)."""
    if _kernel_route(images):
        k = _kernels()
        out_boxes, out_labels, out_mask, geom, fills = k.augment_prepare_cuda(
            images, boxes, labels, mask, shifts=shifts)
        return k.augment_image_cuda(images, geom, fills), out_boxes, out_labels, out_mask
    return _translate_plain(images, boxes, labels, mask, shifts)


# ------------------------------------------------------------ box jitter


def _jitter_boxes_plain(boxes, labels, mask, geom, h, w, apply):
    g = geom.float()
    sy, sx = _div(g[:, 0], h), _div(g[:, 1], w)
    scale = torch.stack([sy, sx, sy, sx], dim=-1)[:, None, :]
    shift = torch.stack([g[:, 2], g[:, 3], g[:, 2], g[:, 3]], dim=-1)[:, None, :]
    lim = torch.tensor([h, w, h, w], dtype=torch.float32, device=boxes.device)
    b = _clip(boxes * scale - shift, torch.zeros((), device=boxes.device), lim).to(boxes.dtype)
    return _kill_collapsed(b, boxes, labels, mask, apply[:, None] & (labels >= 0))


def jitter_boxes_batch(boxes: Tensor, labels: Tensor, mask: Tensor, geom: Tensor, h: int,
                       w: int, apply: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Batch half of ``data/augment.py::jitter_boxes``: the affine b*s - shift
    with canvas clip on the rows ``apply`` [N] marks; sub-1px rows collapse
    to the padded-row convention."""
    if _kernel_route(boxes):
        out_boxes, out_labels, out_mask, _, _ = _kernels().augment_geometry_cuda(
            boxes, labels, mask, boxes.shape[0], h, w, jitter=geom, apply=apply,
            device=boxes.device)
        return out_boxes, out_labels, out_mask
    return _jitter_boxes_plain(boxes, labels, mask, geom, h, w, apply)


# ------------------------------------------------------- the whole augmentation


def augment_batch(images: Tensor, boxes: Tensor, labels: Tensor, mask: Tensor, aug: Tensor, *,
                  seed: int, hflip: bool = False, scale_range=None,
                  translate: float = 0.0) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The whole train augmentation as one batch transform. ``aug`` int32
    [N, 2] = (dataset idx, epoch) per row; ``seed`` is fixed (a kernel
    argument on the card, baked into a captured graph). Order: flip, then
    translation, then fixed-canvas scale jitter, on the base canvas. Rows
    whose draws are the identity pass through bitwise untouched."""
    h, w = images.shape[1], images.shape[2]
    if _kernel_route(images):
        k = _kernels()
        kw = dict(aug=aug, seed=seed, hflip=hflip, scale_range=scale_range, translate=translate)
        if translate or scale_range is not None:  # rows read fills: one launch for both
            out_boxes, out_labels, out_mask, geom, fills = k.augment_prepare_cuda(
                images, boxes, labels, mask, **kw)
        else:
            out_boxes, out_labels, out_mask, geom, _ = k.augment_geometry_cuda(
                boxes, labels, mask, images.shape[0], h, w, device=images.device, **kw)
            fills = None
        return k.augment_image_cuda(images, geom, fills), out_boxes, out_labels, out_mask
    boxes, labels, mask, geom = augment_geometry_plain(
        boxes, labels, mask, aug, h, w, seed=seed, hflip=hflip, scale_range=scale_range,
        translate=translate)
    return augment_images_plain(images, geom), boxes, labels, mask


def augment_geometry_plain(boxes: Tensor, labels: Tensor, mask: Tensor, aug: Tensor, h: int,
                           w: int, *, seed: int, hflip: bool = False, scale_range=None,
                           translate: float = 0.0):
    """The box half of :func:`augment_batch` (the geometry kernel's plain
    version): the draws, the flip, the translation and the jitter of the
    boxes, labels and masks, and the int32 [N, 8] geometry rows (flip, dy,
    dx, ch, cw, shy, shx, resample) that :func:`augment_images_plain`
    applies."""
    flip, u_s, u_oy, u_ox, u_ty, u_tx = _draws_plain(seed, aug[:, 1], aug[:, 0])
    zeros = torch.zeros_like(aug[:, 0])
    flip = flip if hflip else torch.zeros_like(flip)
    if hflip:
        boxes = _flip_boxes(boxes, labels, flip, w)
    dy = dx = zeros
    if translate:
        dy = torch.round((2.0 * u_ty - 1.0) * float(np.float32(translate * h))).to(torch.int32)
        dx = torch.round((2.0 * u_tx - 1.0) * float(np.float32(translate * w))).to(torch.int32)
        boxes, labels, mask = _translate_boxes(boxes, labels, mask,
                                               torch.stack([dy, dx], dim=-1), h, w)
    ch, cw, shy, shx = zeros + h, zeros + w, zeros, zeros
    jittered = torch.zeros_like(flip)
    if scale_range is not None:
        lo, hi = scale_range
        scale = u_s * float(np.float32(hi - lo)) + float(np.float32(lo))
        ch = torch.clamp(torch.round(scale * float(h)), min=1).to(torch.int32)
        cw = torch.clamp(torch.round(scale * float(w)), min=1).to(torch.int32)
        shy = torch.round((ch - h).float() * torch.clamp(u_oy, 0.0, 1.0)).to(torch.int32)
        shx = torch.round((cw - w).float() * torch.clamp(u_ox, 0.0, 1.0)).to(torch.int32)
        jitter = torch.stack([ch, cw, shy, shx], dim=-1)
        ident = torch.tensor([h, w, 0, 0], dtype=torch.int32, device=jitter.device)
        jittered = torch.any(jitter != ident, dim=-1)
        boxes, labels, mask = _jitter_boxes_plain(boxes, labels, mask, jitter, h, w, jittered)
    geom = torch.stack([flip.to(torch.int32), dy.to(torch.int32), dx.to(torch.int32), ch, cw,
                        shy, shx, jittered.to(torch.int32)], dim=-1)
    return boxes, labels, mask, geom


def augment_images_plain(images: Tensor, geom: Tensor) -> Tensor:
    """The image half of :func:`augment_batch` (the fill and image kernels'
    plain version): each row flipped, translated and, where its geometry
    row says so, jittered, in JAX's order; a row whose step is the identity
    passes through bitwise (the translation of (0, 0) reads no fill)."""
    flip = geom[:, 0].bool()
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    if bool((geom[:, 1:3] != 0).any()):
        images = torch.stack([_translate_image(im, g[1], g[2]) for im, g in zip(images, geom)])
    jittered = geom[:, 7].bool()
    if bool(jittered.any()):
        resampled = torch.stack([_scale_jitter_plain(im, g[3:7]) for im, g in zip(images, geom)])
        images = torch.where(jittered[:, None, None, None], resampled, images)
    return images


def image_fills_plain(images: Tensor, geom: Tensor) -> Tensor:
    """The fill kernel's plain version: [N, 2, 3] float32, each row's
    translation fill (the channel means of the flipped image) and jitter
    fill (those of the translated image)."""
    out = []
    for im, g in zip(images, geom):
        flipped = im.flip(1) if bool(g[0]) else im
        moved = _translate_image(flipped, g[1], g[2])
        out.append(torch.stack([_channel_fill(flipped), _channel_fill(moved)]))
    return torch.stack(out)


def _decided_geometry_plain(boxes, labels, mask, n, h, w, flip, shifts, jitter, apply,
                            resample, device):
    """The geometry kernel's plain version on the host's decisions: ``flip``
    [n] bool, ``shifts`` [n, 2] and ``jitter`` [n, 4] (each optional;
    ``apply`` [n] bool the rows whose boxes jitter, default the
    non-identity ones); the boxes (None: none) flipped, translated and
    jittered in JAX's order, and the int32 [n, 8] geometry rows."""
    zeros = torch.zeros(n, dtype=torch.int32, device=device)
    if boxes is not None:
        if flip is not None:
            boxes = _flip_boxes(boxes, labels, flip, w)
        if shifts is not None:
            boxes, labels, mask = _translate_boxes(boxes, labels, mask, shifts, h, w)
    dy, dx = (shifts[:, 0], shifts[:, 1]) if shifts is not None else (zeros, zeros)
    ch, cw, shy, shx = (jitter.unbind(dim=1) if jitter is not None
                        else (zeros + h, zeros + w, zeros, zeros))
    resampled = torch.zeros(n, dtype=torch.bool, device=device)
    if jitter is not None:
        if apply is None:
            ident = torch.tensor([h, w, 0, 0], dtype=torch.int32, device=jitter.device)
            apply = torch.any(jitter != ident, dim=-1)
        if boxes is not None:
            boxes, labels, mask = _jitter_boxes_plain(boxes, labels, mask, jitter, h, w, apply)
        resampled = {"rows": apply, "all": ~resampled, "none": resampled}[resample]
    flip_col = flip.to(torch.int32) if flip is not None else zeros
    geom = torch.stack([flip_col, dy, dx, ch, cw, shy, shx, resampled.to(torch.int32)], dim=-1)
    return boxes, labels, mask, geom.to(torch.int32)


def augment_prepare_plain(images: Tensor, boxes, labels, mask, *, idx=None, aug=None,
                          seed: int = 0, hflip: bool = False, scale_range=None,
                          translate: float = 0.0, flip=None, shifts=None, jitter=None,
                          apply=None, resample: str = "rows"):
    """The prepare kernel's plain version: the geometry (from ``aug``'s
    draws, :func:`augment_geometry_plain`, or from the host's ``flip`` /
    ``shifts`` / ``jitter``) followed by :func:`image_fills_plain` ->
    (boxes, labels, mask, geom int32 [n, 8], fills float32 [n, 2, 3]).
    With ``idx`` [n] the images and boxes are the cache's rows it names;
    ``boxes`` None transforms no box, ``mask`` None returns none."""
    if idx is not None:
        images = images[idx.long()]
        if boxes is not None:
            boxes, labels = boxes[idx.long()], labels[idx.long()]
            mask = mask[idx.long()] if mask is not None else None
    n, h, w = images.shape[:3]
    no_mask = mask is None and boxes is not None
    if no_mask:
        mask = labels >= 0
    if aug is not None:
        b, l, m = ((boxes, labels, mask) if boxes is not None else
                   (torch.zeros(n, 0, 4, device=images.device),
                    torch.zeros(n, 0, dtype=torch.int32, device=images.device),
                    torch.zeros(n, 0, dtype=torch.bool, device=images.device)))
        b, l, m, geom = augment_geometry_plain(b, l, m, aug, h, w, seed=seed, hflip=hflip,
                                               scale_range=scale_range, translate=translate)
        if scale_range is not None and resample != "rows":
            geom[:, 7] = int(resample == "all")
        if boxes is not None:
            boxes, labels, mask = b, l, m
    else:
        boxes, labels, mask, geom = _decided_geometry_plain(
            boxes, labels, mask, n, h, w, flip, shifts, jitter, apply, resample, images.device)
    return boxes, labels, None if no_mask else mask, geom, image_fills_plain(images, geom)


# ------------------------------------------------------------ bucket resample


def resize_band(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The weights of ``jax.image.resize(method="bilinear")`` (antialias on,
    scale out/in, no translation) along one axis, as a band: (start int32
    [out], weight float32 [out, taps]); output o reads inputs start[o] ..
    start[o] + taps - 1. The dense float32 matrix follows JAX's
    ``compute_weight_mat`` (the triangle kernel widened by in/out when
    downsampling, each column normalised by its sum, here summed in input
    order); taps outside an output's support carry weight 0."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.0) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = np.zeros(out_size, np.float32)
    for row in weights:
        total = total + row
    eps = np.float32(1000.0 * float(np.finfo(np.float32).eps))
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, np.float32(0)).astype(np.float32)
    nz = weights != 0
    first = np.where(nz.any(0), nz.argmax(0), 0)
    last = np.where(nz.any(0), in_size - 1 - nz[::-1].argmax(0), 0)
    taps = int(max(1, (last - first + 1).max()))
    start = np.minimum(first, in_size - taps).astype(np.int32)
    cols = start[:, None] + np.arange(taps)[None, :]
    band = weights[cols, np.arange(out_size)[:, None]].astype(np.float32)
    return start, np.ascontiguousarray(band)


def _resize_axis_plain(x: Tensor, start: Tensor, weight: Tensor) -> Tensor:
    """x float32 [outer, len_in, inner] -> [outer, len_out, inner]:
    out[o] = sum_k weight[o, k] * x[start[o] + k], from 0, in tap order."""
    acc = torch.zeros(x.shape[0], start.shape[0], x.shape[2], dtype=torch.float32,
                      device=x.device)
    for k in range(weight.shape[1]):
        acc = acc + weight[:, k][None, :, None] * x[:, (start + k).long(), :]
    return acc


def resize_batch_with_boxes(images: Tensor, boxes: Tensor, out_hw) -> Tuple[Tensor, Tensor]:
    """Antialiased bilinear batch resample to ``out_hw`` (as
    ``jax.image.resize(method="bilinear")``), boxes scaled by (h/H, w/W).
    images [N, H, W, C] float32 or uint8 (rounded back); ``out_hw == (H, W)``
    is the identity."""
    h, w = int(out_hw[0]), int(out_hw[1])
    n, ih, iw, c = images.shape
    if (ih, iw) == (h, w):
        return images, boxes
    if _kernel_route(images):
        return _kernels().resize_aa_cuda(images, boxes, (h, w))
    from replication_faster_rcnn_tpu_torch.ops.cuda.image_kernel import band_tables

    x = images.float()
    if ih != h:
        start, weight = band_tables(ih, h, images.device)
        x = _resize_axis_plain(x.reshape(n, ih, iw * c), start, weight).reshape(n, h, iw, c)
    if iw != w:
        start, weight = band_tables(iw, w, images.device)
        x = _resize_axis_plain(x.reshape(n * h, iw, c), start, weight).reshape(n, h, w, c)
    if images.dtype == torch.uint8:
        x = _round_u8(x)
    out = x.to(images.dtype)
    scale = torch.tensor([float(np.float32(h / ih)), float(np.float32(w / iw))] * 2,
                         dtype=boxes.dtype, device=boxes.device)
    return out, boxes * scale


def augment_cached(cache, sel, resample: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The device cache's batch on the card (``data/device_cache.py::
    materialize_batch``): gather + flip + the jitter's box affine, and with
    ``resample`` the jitter's image resample in the same pass. Kernels only:
    the caller runs the plain version for a CPU cache."""
    k = _kernels()
    images = cache["image"]
    idx = sel["idx"]
    n = idx.shape[0]
    h, w = images.shape[1], images.shape[2]
    jitter = sel.get("jitter")
    kw = dict(idx=idx, flip=sel.get("flip"), jitter=jitter,
              resample="all" if resample else "none")
    if resample and jitter is not None:  # rows read fills: one launch for both
        boxes, labels, mask, geom, fills = k.augment_prepare_cuda(
            images, cache["boxes"], cache["labels"], cache["mask"], **kw)
    else:
        boxes, labels, mask, geom, _ = k.augment_geometry_cuda(
            cache["boxes"], cache["labels"], cache["mask"], n, h, w, device=images.device, **kw)
        fills = None
    return k.augment_image_cuda(images, geom, fills, idx), boxes, labels, mask
