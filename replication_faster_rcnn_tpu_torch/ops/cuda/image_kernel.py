"""Wrappers of the data path's CUDA kernels (``csrc/image_kernel.cu``).

They replace no Pallas kernel: the JAX package runs the on-card augmentation,
the device cache's gather and the bucket resample as XLA ops
(``ops/image.py``, ``data/device_cache.py::materialize_batch``). The plain
versions are in the port's ``ops/image.py``, which dispatches a CUDA tensor
here; each wrapper takes only CUDA tensors and raises on anything else.

* :func:`augment_geometry_cuda`: the draws, the flip / translation / jitter
  decisions and the box, label and mask transforms, a thread per (image,
  box); returns an int32 [N, 8] geometry row per image (flip, dy, dx, ch,
  cw, shy, shx, resample) for the image kernels.
* :func:`augment_prepare_cuda`: the same geometry and the two channel fills
  per image ([N, 2, 3] float32) in one launch, a thread block cluster per
  image; the data path's calls that read fills take it.
* :func:`image_fill_cuda`: the fills alone from given geometry rows (the
  prepare kernel without its geometry).
* :func:`augment_image_cuda`: gather (from the batch, or the cache by
  ``idx``), flip, translation and jitter in one launch, a block per output
  row tile.
* :func:`resize_aa_cuda`: the antialiased bilinear bucket resample in one
  launch: per output tile, the rows band pass into shared memory over the
  input span the tile's column taps need (:func:`resize_tile_spans`, kept on
  the card by :func:`tile_spans`), then the columns pass; the boxes scaled.

Each counts its calls in its own counter (``geometry_launches``,
``prepare_launches``, ``fill_launches``, ``image_launches``,
``resize_launches``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build

Tensor = torch.Tensor

# calls since the last reset (the caller resets them to 0)
geometry_launches = 0
prepare_launches = 0
fill_launches = 0
image_launches = 0
resize_launches = 0

GAMMA = 0x9E3779B97F4A7C15
MASK64 = 0xFFFFFFFFFFFFFFFF
GEOM_COLS = 8
# the resize's block: output rows x output columns, and by dtype its
# threads (x: along a row, y: rows); its staged spans start and end on
# RESIZE_ALIGN elements (its widest input vector). The image pass's block:
# the widest column tile (pixels), and by dtype the output rows and a row's
# pixels per thread. The fastest at 600x600 b8 on the H100
# (tools/image_variants.py).
RESIZE_TILE = (8, 128)
RESIZE_THREADS = {torch.uint8: (32, 4), torch.float32: (32, 8)}
RESIZE_ALIGN = 8
IMAGE_TILE = 1024
IMAGE_ROWS = {torch.uint8: 2, torch.float32: 2}
IMAGE_PIXELS_PER_THREAD = {torch.uint8: 8, torch.float32: 2}
# the prepare kernel's (and the fills') launch by dtype: blocks of a
# cluster (one cluster per image; above 8 a non-portable size) and threads
# a block (a multiple of 96). The fastest at 600x600 b8 on the H100
# (tools/image_variants.py); 768 threads of the uint8 geometry
# instantiation (80 registers) is at the edge of a block's registers.
PREPARE_CLUSTER = {torch.uint8: 16, torch.float32: 8}
PREPARE_THREADS = {torch.uint8: 384, torch.float32: 768}
SMEM_BUDGET = 232448  # bytes of shared memory a block can use on the H100

_fns = None
# (in_size, out_size, device) -> (start int32 [out], weight float32 [out, taps])
_bands: Dict[Tuple[int, int, torch.device], Tuple[Tensor, Tensor]] = {}
# (in_size, out_size, tile, device) -> (spans int32 [tiles, 2], plane)
_spans: Dict[Tuple[int, int, int, torch.device], Tuple[Tensor, int]] = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s C functions typed (the library of ``csrc/image_kernel.cu``,
    or a build of another version of it with the same interface)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.augment_geometry_launch.argtypes = [
        p, p, p, p, p, ctypes.c_ulonglong, i, i, f, f, i, f, f, p, p, p, p, i,
        i, i, i, i, p, p, p, p, p, p,
    ]
    lib.augment_prepare_launch.argtypes = [
        p, p, p, p, p, ctypes.c_ulonglong, i, i, f, f, i, f, f, p, p, p, p, i,
        i, i, i, i, p, i, i, i, p, p, p, p, p, p,
    ]
    lib.image_fill_launch.argtypes = [p, p, p, i, i, i, i, i, i, p, p]
    lib.augment_image_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p]
    lib.resize_aa_launch.argtypes = [
        p, i, p, i, i, i, i, i, p, p, i, p, p, i, p, i, i, i, i, i, p, p,
        ctypes.c_longlong, ctypes.c_longlong, f, f, p,
    ]
    for fn in (lib.augment_geometry_launch, lib.augment_prepare_launch, lib.image_fill_launch,
               lib.augment_image_launch, lib.resize_aa_launch):
        fn.restype = ctypes.c_int
    lib.image_error_string.argtypes = [ctypes.c_int]
    lib.image_error_string.restype = ctypes.c_char_p
    return lib


def _kernels():
    global _fns
    if _fns is None:
        _fns = bind(build.library("image_kernel"))
    return _fns


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on(dev: torch.device, name: str, t: Optional[Tensor], dtype=None, shape=None) -> Optional[Tensor]:
    """``t`` checked (CUDA, on ``dev``, dtype, shape) and made contiguous."""
    if t is None:
        return None
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _image_kind(images: Tensor) -> int:
    if images.dtype == torch.uint8:
        return 1
    if images.dtype == torch.float32:
        return 0
    raise ValueError(f"images must be uint8 or float32, got {images.dtype}")


def _geometry(dev, boxes, labels, mask, n, h, w, idx, aug, seed, hflip, scale_range, translate,
              flip, shifts, jitter, apply, resample):
    """The geometry arguments of the C interface, checked, and the box
    outputs: (arguments up to ``w``, (boxes, labels, mask, geom) outputs)."""
    g = 0
    if boxes is not None:
        rows = boxes.shape[0]
        g = boxes.shape[1]
        boxes = _on(dev, "boxes", boxes, torch.float32, (rows, g, 4))
        labels = _on(dev, "labels", labels, torch.int32, (rows, g))
        mask = _on(dev, "mask", mask, torch.bool, (rows, g))
        if idx is None and rows != n:
            raise ValueError(f"boxes hold {rows} rows for {n} images")
    idx = _on(dev, "idx", idx, torch.int32, (n,))
    aug = _on(dev, "aug", aug, torch.int32, (n, 2))
    flip = _on(dev, "flip", flip, torch.bool, (n,))
    shifts = _on(dev, "shifts", shifts, torch.int32, (n, 2))
    jitter = _on(dev, "jitter", jitter, torch.int32, (n, 4))
    apply = _on(dev, "apply", apply, torch.bool, (n,))
    modes = {"rows": 0, "all": 1, "none": 2}
    if resample not in modes:
        raise ValueError(f"resample must be one of {sorted(modes)}, got {resample!r}")
    if aug is not None and any(t is not None for t in (flip, shifts, jitter, apply)):
        raise ValueError("aug draws its decisions: pass no flip, shifts, jitter or apply")
    out_boxes = out_labels = out_mask = None
    if g:
        out_boxes = torch.empty(n, g, 4, dtype=torch.float32, device=dev)
        out_labels = torch.empty(n, g, dtype=torch.int32, device=dev)
        out_mask = torch.empty(n, g, dtype=torch.bool, device=dev) if mask is not None else None
    geom = torch.empty(n, GEOM_COLS, dtype=torch.int32, device=dev)
    lo, hi = (0.0, 0.0) if scale_range is None else (float(scale_range[0]), float(scale_range[1]))
    args = (_ptr(boxes), _ptr(labels), _ptr(mask), _ptr(idx), _ptr(aug),
            (int(seed) * GAMMA) & MASK64, int(bool(hflip)), int(scale_range is not None),
            float(np.float32(lo)), float(np.float32(hi - lo)), int(bool(translate)),
            float(np.float32(translate * h)), float(np.float32(translate * w)),
            _ptr(flip), _ptr(shifts), _ptr(jitter), _ptr(apply), modes[resample], n, g, h, w)
    # the inputs stay referenced until the launch is queued
    return args, (boxes, labels, mask, idx, aug, flip, shifts, jitter, apply), \
        (out_boxes, out_labels, out_mask, geom)


def augment_geometry_cuda(
    boxes: Optional[Tensor],
    labels: Optional[Tensor],
    mask: Optional[Tensor],
    n: int,
    h: int,
    w: int,
    *,
    idx: Optional[Tensor] = None,
    aug: Optional[Tensor] = None,
    seed: int = 0,
    hflip: bool = False,
    scale_range=None,
    translate: float = 0.0,
    flip: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
    jitter: Optional[Tensor] = None,
    apply: Optional[Tensor] = None,
    resample: str = "rows",
    draws: bool = False,
    device: Optional[torch.device] = None,
):
    """One launch: -> (boxes, labels, mask, geom int32 [n, 8], draws float32
    [n, 6] or None). ``boxes``/``labels``/``mask`` are [n, G, ...] or, with
    ``idx`` [n], the cache's [M, G, ...] rows gathered by it; ``boxes`` None
    transforms no box (the outputs are then None). The decisions come from
    ``aug`` [n, 2] = (idx, epoch) draws (``hflip``, ``scale_range``,
    ``translate``), or from the host's ``flip`` [n] bool, ``shifts`` [n, 2]
    and ``jitter`` [n, 4] (``apply`` [n] bool picks the rows whose boxes
    jitter; default: the non-identity geometries). ``resample`` picks the
    rows the image kernel resamples: ``"rows"`` those whose boxes jitter,
    ``"all"`` every row with a jitter geometry (JAX's
    ``batched_scale_jitter``), ``"none"`` no row."""
    ref = next(t for t in (boxes, aug, flip, shifts, jitter, idx) if t is not None) \
        if device is None else None
    dev = device if device is not None else ref.device
    if dev.type != "cuda":
        raise ValueError(f"augment_geometry_cuda takes CUDA tensors, got {dev}")
    args, _keep, (out_boxes, out_labels, out_mask, geom) = _geometry(
        dev, boxes, labels, mask, n, h, w, idx, aug, seed, hflip, scale_range, translate, flip,
        shifts, jitter, apply, resample)
    out_draws = torch.empty(n, 6, dtype=torch.float32, device=dev) if draws else None
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.augment_geometry_launch(
            *args, _ptr(out_boxes), _ptr(out_labels), _ptr(out_mask), geom.data_ptr(),
            _ptr(out_draws), _stream(dev))
    build.check(rc, lib.image_error_string, "augment_geometry_kernel")
    global geometry_launches
    geometry_launches += 1
    return out_boxes, out_labels, out_mask, geom, out_draws


def augment_prepare_cuda(
    images: Tensor,
    boxes: Optional[Tensor],
    labels: Optional[Tensor],
    mask: Optional[Tensor],
    *,
    idx: Optional[Tensor] = None,
    aug: Optional[Tensor] = None,
    seed: int = 0,
    hflip: bool = False,
    scale_range=None,
    translate: float = 0.0,
    flip: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
    jitter: Optional[Tensor] = None,
    apply: Optional[Tensor] = None,
    resample: str = "rows",
):
    """One launch: :func:`augment_geometry_cuda`'s geometry (no draws) and
    the fills of :func:`image_fill_cuda` -> (boxes, labels, mask, geom int32
    [n, 8], fills float32 [n, 2, 3]). ``images`` [n, H, W, 3] uint8 or
    float32, or with ``idx`` [n] the cache's [M, H, W, 3] rows (the boxes'
    too); the other arguments as :func:`augment_geometry_cuda`'s. A cluster of
    ``PREPARE_CLUSTER`` blocks of ``PREPARE_THREADS`` threads per image."""
    if not isinstance(images, Tensor) or not images.is_cuda:
        dev = images.device if isinstance(images, Tensor) else None
        raise ValueError(f"augment_prepare_cuda takes CUDA tensors, got {dev}")
    dev = images.device
    kind = _image_kind(images)
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N, H, W, 3], got {tuple(images.shape)}")
    n = idx.shape[0] if idx is not None else images.shape[0]
    h, w = images.shape[1], images.shape[2]
    args, _keep, (out_boxes, out_labels, out_mask, geom) = _geometry(
        dev, boxes, labels, mask, n, h, w, idx, aug, seed, hflip, scale_range, translate, flip,
        shifts, jitter, apply, resample)
    images = _on(dev, "images", images)
    fills = torch.empty(n, 2, 3, dtype=torch.float32, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.augment_prepare_launch(
            *args, images.data_ptr(), kind, PREPARE_CLUSTER[images.dtype],
            PREPARE_THREADS[images.dtype], _ptr(out_boxes), _ptr(out_labels), _ptr(out_mask),
            geom.data_ptr(), fills.data_ptr(), _stream(dev))
    build.check(rc, lib.image_error_string, "augment_prepare_kernel")
    global prepare_launches
    prepare_launches += 1
    return out_boxes, out_labels, out_mask, geom, fills


def _source(images: Tensor, geom: Tensor, idx: Optional[Tensor]):
    dev = images.device
    if not images.is_cuda:
        raise ValueError(f"images must be a CUDA tensor, got {images.device}")
    _image_kind(images)
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N, H, W, 3], got {tuple(images.shape)}")
    n = geom.shape[0]
    geom = _on(dev, "geom", geom, torch.int32, (n, GEOM_COLS))
    idx = _on(dev, "idx", idx, torch.int32, (n,))
    if idx is None and images.shape[0] != n:
        raise ValueError(f"images hold {images.shape[0]} rows for {n} geometry rows")
    return _on(dev, "images", images), geom, idx, n


def image_fill_cuda(images: Tensor, geom: Tensor, idx: Optional[Tensor] = None) -> Tensor:
    """One launch (the prepare kernel reading the geometry rows ``geom``):
    the [N, 2, 3] float32 fills (translation, jitter) of each row's source
    (``images[idx[n]]`` with ``idx``)."""
    images, geom, idx, n = _source(images, geom, idx)
    dev = images.device
    h, w = images.shape[1], images.shape[2]
    fills = torch.empty(n, 2, 3, dtype=torch.float32, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.image_fill_launch(images.data_ptr(), _ptr(idx), geom.data_ptr(), n, h, w,
                                   _image_kind(images), PREPARE_CLUSTER[images.dtype],
                                   PREPARE_THREADS[images.dtype], fills.data_ptr(),
                                   _stream(dev))
    build.check(rc, lib.image_error_string, "augment_prepare_kernel (fills)")
    global fill_launches
    fill_launches += 1
    return fills


def augment_image_cuda(images: Tensor, geom: Tensor, fills: Optional[Tensor],
                       idx: Optional[Tensor] = None) -> Tensor:
    """One launch: [N, H, W, 3] in the images' dtype. ``fills`` may be None
    when no row translates or resamples. A block per ``IMAGE_ROWS`` output
    rows (by dtype) and column tile (at most ``IMAGE_TILE`` pixels)."""
    images, geom, idx, n = _source(images, geom, idx)
    dev = images.device
    h, w = images.shape[1], images.shape[2]
    if image_smem_bytes(w, images.dtype) > SMEM_BUDGET:
        raise ValueError(f"rows of {w} pixels exceed the image pass's shared memory")
    fills = _on(dev, "fills", fills, torch.float32, (n, 2, 3))
    out = torch.empty((n, h, w, 3), dtype=images.dtype, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.augment_image_launch(images.data_ptr(), _ptr(idx), geom.data_ptr(), _ptr(fills),
                                      n, h, w, _image_kind(images), IMAGE_TILE,
                                      IMAGE_ROWS[images.dtype],
                                      IMAGE_PIXELS_PER_THREAD[images.dtype], out.data_ptr(),
                                      _stream(dev))
    build.check(rc, lib.image_error_string, "augment_image_kernel")
    global image_launches
    image_launches += 1
    return out


def band_tables(in_size: int, out_size: int, device) -> Tuple[Tensor, Tensor]:
    """The resize's band along one axis on ``device``, built once per
    (in, out, device) from ``ops/image.py::resize_band`` and kept, so a CUDA
    graph captured after the first call reads it. Under capture it must
    already exist."""
    from replication_faster_rcnn_tpu_torch.ops.image import resize_band

    key = (int(in_size), int(out_size), torch.device(device))
    got = _bands.get(key)
    if got is None:
        if key[2].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the resize band {in_size} -> {out_size} is not on the card under CUDA graph "
                "capture: run the resize once before capturing it")
        start, weight = resize_band(in_size, out_size)
        got = _bands[key] = (torch.from_numpy(start).to(key[2]),
                             torch.from_numpy(weight).to(key[2]))
    return got


def image_smem_bytes(w: int, dtype: torch.dtype) -> int:
    """Shared memory of one image-pass block (``csrc/image_kernel.cu::
    image_launch``): the tile's tap table, two staged source rows per
    output row, each a whole row at any 16-byte phase, and the staged
    output row."""
    tiles = -(-w // IMAGE_TILE)
    per_tile = -(-w // tiles)
    tile = -(-per_tile // 4) * 4
    itemsize = torch.empty((), dtype=dtype).element_size()
    per = 16 // itemsize
    source = (3 * w + 2 * per - 2) // per * per
    staged_out = (3 * tile + 2 * per - 2) // per * per
    return 12 * tile + IMAGE_ROWS[dtype] * (2 * source + staged_out) * itemsize


def resize_tile_spans(start: np.ndarray, taps: int, in_size: int,
                      tile: int) -> Tuple[np.ndarray, int]:
    """The input span each tile of ``tile`` output columns stages: int32
    [tiles, 2] (first, end) as elements of an RGB input row, the first
    rounded down and the end up to a multiple of ``RESIZE_ALIGN`` (a vector
    load's boundary; the end not past the row), covering every tile
    output's taps ``start[o] .. start[o] + taps - 1``; and the pixels of a
    staged channel plane (the widest span's, from the pixel of its first
    element)."""
    start = np.asarray(start, np.int64)
    a = RESIZE_ALIGN
    tiles = -(-len(start) // tile)
    spans = np.empty((tiles, 2), np.int32)
    for t in range(tiles):
        s = start[t * tile:(t + 1) * tile]
        end = -(-(int(s.max()) + taps) * 3 // a) * a
        spans[t] = (int(s.min()) * 3 // a * a, min(end, in_size * 3))
    plane = int((-(-spans[:, 1] // 3) - spans[:, 0] // 3).max())
    return spans, plane


def resize_smem_bytes(tile, plane: int, row_taps: int, col_taps: int, itemsize: int = 1) -> int:
    """Shared memory of one resize block (``csrc/image_kernel.cu::
    resize_smem_bytes``): when the columns are resized (``col_taps`` > 0)
    the staged float32 rows (3 channel planes of ``plane`` pixels), the
    staged output rows (at any 16-byte phase) and the columns' band; when
    the rows are (``row_taps`` > 0) the rows' band."""
    ty, tx = tile
    per = 16 // itemsize
    out_stride = (tx * 3 + 2 * per - 2) // per * per
    cols = 4 * ty * 3 * plane + itemsize * ty * out_stride + 4 * tx * (col_taps + 1)
    return (cols if col_taps else 0) + (4 * ty * (row_taps + 1) if row_taps else 0)


def tile_spans(in_size: int, out_size: int, tile: int, device) -> Tuple[Tensor, int]:
    """:func:`resize_tile_spans` of the columns' band on ``device``, built
    once per (in, out, tile, device) and kept, as :func:`band_tables`;
    under CUDA graph capture it must already exist."""
    key = (int(in_size), int(out_size), int(tile), torch.device(device))
    got = _spans.get(key)
    if got is None:
        if key[-1].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the resize's tile spans {in_size} -> {out_size} are not on the card under CUDA "
                "graph capture: run the resize once before capturing it")
        from replication_faster_rcnn_tpu_torch.ops.image import resize_band

        start, weight = resize_band(in_size, out_size)
        spans, plane = resize_tile_spans(start, weight.shape[1], in_size, tile)
        got = _spans[key] = (torch.from_numpy(spans).to(key[-1]), plane)
    return got


def resize_aa_cuda(images: Tensor, boxes: Optional[Tensor], out_hw) -> Tuple[Tensor, Optional[Tensor]]:
    """``ops/image.py::resize_batch_with_boxes`` on the card in one launch:
    per tile of output rows and columns, the rows band pass over the tile's
    input span into shared memory (float32, as the plain version's
    intermediate), then the columns pass from there; an axis that keeps its
    size skips its pass. One block per image scales the boxes. One call,
    counted once. The identity size returns the inputs and launches
    nothing."""
    if not images.is_cuda:
        raise ValueError(f"images must be a CUDA tensor, got {images.device}")
    kind = _image_kind(images)
    n, ih, iw, c = images.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    if (ih, iw) == (h, w):
        return images, boxes
    if c != 3:
        raise ValueError(f"resize_aa_cuda takes RGB [N, H, W, 3], got {tuple(images.shape)}")
    dev = images.device
    images = _on(dev, "images", images)
    if boxes is not None:
        boxes = _on(dev, "boxes", boxes, torch.float32)
    sy, sx = float(np.float32(h / ih)), float(np.float32(w / iw))
    ty, tx = RESIZE_TILE
    rows = band_tables(ih, h, dev) if ih != h else (None, None)
    cols = band_tables(iw, w, dev) if iw != w else (None, None)
    spans, plane = tile_spans(iw, w, tx, dev) if iw != w else (None, 0)
    row_taps = rows[1].shape[1] if ih != h else 0
    col_taps = cols[1].shape[1] if iw != w else 0
    smem = resize_smem_bytes(RESIZE_TILE, plane, row_taps, col_taps, images.element_size())
    if smem > SMEM_BUDGET:
        raise ValueError(f"the resize {ih}x{iw} -> {h}x{w} needs {smem} bytes of shared memory "
                         f"a block, over {SMEM_BUDGET}")
    out = torch.empty((n, h, w, 3), dtype=images.dtype, device=dev)
    out_boxes = torch.empty_like(boxes) if boxes is not None else None
    n_box = boxes.numel() if boxes is not None else 0
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.resize_aa_launch(
            images.data_ptr(), kind, out.data_ptr(), n, ih, iw, h, w,
            _ptr(rows[0]), _ptr(rows[1]), row_taps, _ptr(cols[0]), _ptr(cols[1]), col_taps,
            _ptr(spans), plane, ty, tx, *RESIZE_THREADS[images.dtype],
            _ptr(boxes), _ptr(out_boxes), n_box, -(-n_box // n) if n else 0, sy, sx,
            _stream(dev))
    build.check(rc, lib.image_error_string, "resize_aa_kernel")
    global resize_launches
    resize_launches += 1
    return out, out_boxes
