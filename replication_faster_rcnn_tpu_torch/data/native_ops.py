"""Host image preprocessing: the C++ library ``csrc/frcnn_native.cpp``
(counterpart of the JAX package's ``data/native_ops.py``), bound with
``ctypes``.

The library is built with ``g++`` at first use into ``<repo>/build/host/``,
named by a hash of the source and the flags, and linked with ``-ljpeg``
where ``jpeglib.h`` compiles; otherwise it is built with ``-DFRCNN_NO_JPEG``
and :func:`decode_jpeg_resize_normalize` raises. A build that fails raises
with the compiler's output: there is no numpy fallback. The numpy
specification of the resize stays as :func:`resize_normalize_plain`; it runs
only under ``ops.reference_scope()`` and in the tests, and the C++ resize is
bitwise equal to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from replication_faster_rcnn_tpu_torch import ops

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "frcnn_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"

# -ffp-contract=off: no product is fused into an add, so the resize does the
# numpy specification's float32 arithmetic exactly
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-Wall",
             "-shared", "-fPIC")
# the library with the JPEG decoder first, then without it
VARIANTS = (("-ljpeg",), ("-DFRCNN_NO_JPEG",))

_lock = threading.Lock()  # the engine, loader threads and scripts race to the first build
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The CPU's model and feature flags: ``-march=native`` code built on one
    host may not run on another that shares the checkout."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return platform.processor().encode()
    return b"\n".join(ln for ln in lines if ln.startswith((b"model name", b"flags")))


def library_path(variant: Sequence[str]) -> Path:
    """``build/host/frcnn_native.<hash>.so``, the hash over the source, the
    flags and the host CPU."""
    flags = " ".join(CXX_FLAGS + tuple(variant))
    digest = hashlib.sha256(SOURCE.read_bytes() + flags.encode() + _host_cpu()).hexdigest()[:12]
    return BUILD_DIR / f"frcnn_native.{digest}.so"


def _compile(variant: Sequence[str]) -> Tuple[Optional[Path], str]:
    """(library, "") on success, (None, the compiler's output) on failure;
    the library is written to a temporary name and renamed into place."""
    target = library_path(variant)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *variant]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stdout.decode()}"
    os.replace(tmp, target)
    return target, ""


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.resize_bilinear_normalize.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
    ]
    lib.resize_bilinear_normalize.restype = None
    lib.scale_boxes.argtypes = [f32p, i32p, ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.scale_boxes.restype = None
    if hasattr(lib, "decode_jpeg_resize_normalize"):
        lib.decode_jpeg_resize_normalize.argtypes = [
            u8p, ctypes.c_int64, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
            ctypes.c_int, i32p, i32p,
        ]
        lib.decode_jpeg_resize_normalize.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use (raises if g++ fails)."""
    global _lib
    with _lock:
        if _lib is None:
            path = next((p for p in map(library_path, VARIANTS) if p.exists()), None)
            if path is None:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                errors = []
                for variant in VARIANTS:
                    path, err = _compile(variant)
                    if path is not None:
                        break
                    errors.append(err)
                else:
                    raise RuntimeError(
                        f"building the host library {SOURCE.name} failed:\n" + "\n".join(errors))
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def has_jpeg() -> bool:
    """True when the library was built with the libjpeg decoder."""
    return hasattr(library(), "decode_jpeg_resize_normalize")


def resize_normalize_plain(
    img: np.ndarray,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
) -> np.ndarray:
    """The numpy specification: uint8 HWC RGB -> normalized float32
    [out_h, out_w, 3], bilinear with align_corners=False sampling, then /255
    and per-channel mean/std."""
    img = np.ascontiguousarray(img, np.uint8)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    sh, sw = img.shape[:2]
    dh, dw = out_hw
    sr = np.clip((np.arange(dh) + 0.5) * (sh / dh) - 0.5, 0, sh - 1)
    sc = np.clip((np.arange(dw) + 0.5) * (sw / dw) - 0.5, 0, sw - 1)
    r0 = sr.astype(np.int32)
    c0 = sc.astype(np.int32)
    r1 = np.minimum(r0 + 1, sh - 1)
    c1 = np.minimum(c0 + 1, sw - 1)
    fr = (sr - r0).astype(np.float32)[:, None, None]
    fc = (sc - c0).astype(np.float32)[None, :, None]
    im = img.astype(np.float32)
    top = im[r0][:, c0] * (1 - fc) + im[r0][:, c1] * fc
    bot = im[r1][:, c0] * (1 - fc) + im[r1][:, c1] * fc
    out = top * (1 - fr) + bot * fr
    return ((out / 255.0 - mean) / std).astype(np.float32)


def resize_normalize(
    img: np.ndarray,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
) -> np.ndarray:
    """uint8 HWC RGB -> normalized float32 [out_h, out_w, 3] through the C++
    library (:func:`resize_normalize_plain` inside ``ops.reference_scope``)."""
    if ops.reference_requested():
        return resize_normalize_plain(img, out_hw, mean, std)
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or min(img.shape[:2]) < 1:
        raise ValueError(f"expected a [H, W, 3] image, got {img.shape}")
    dh, dw = int(out_hw[0]), int(out_hw[1])
    if dh < 1 or dw < 1:
        raise ValueError(f"bad output size {out_hw}")
    dst = np.empty((dh, dw, 3), np.float32)
    library().resize_bilinear_normalize(
        img, img.shape[0], img.shape[1], dst, dh, dw,
        np.asarray(mean, np.float32), np.asarray(std, np.float32),
    )
    return dst


def scale_boxes_plain(boxes: np.ndarray, labels: np.ndarray, row_scale: float,
                      col_scale: float) -> np.ndarray:
    """The numpy specification of :func:`scale_boxes`."""
    boxes = np.asarray(boxes, np.float32)
    scale = np.asarray([row_scale, col_scale, row_scale, col_scale], np.float32)
    return np.where((np.asarray(labels) >= 0)[:, None], np.round(boxes * scale), boxes)


def scale_boxes(boxes: np.ndarray, labels: np.ndarray, row_scale: float,
                col_scale: float) -> np.ndarray:
    """Scale and round padded [m, 4] boxes to resized-image coordinates,
    leaving entries with label < 0 untouched (a new array)."""
    if ops.reference_requested():
        return scale_boxes_plain(boxes, labels, row_scale, col_scale)
    boxes = np.array(boxes, np.float32, order="C")  # a copy: scaled in place
    labels = np.ascontiguousarray(labels, np.int32)
    if boxes.ndim != 2 or boxes.shape[1] != 4 or labels.shape != boxes.shape[:1]:
        raise ValueError(f"boxes {boxes.shape} and labels {labels.shape} do not match")
    library().scale_boxes(boxes, labels, len(boxes), row_scale, col_scale)
    return boxes


def decode_jpeg_resize_normalize(
    data: bytes,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
) -> Optional[Tuple[np.ndarray, int, int]]:
    """JPEG bytes -> (normalized float32 [out_h, out_w, 3], orig_h, orig_w) in
    one C++ call; None when the bytes do not decode as a JPEG. libjpeg
    decodes at 1/2..1/8 scale when the source is at least twice the target
    (the JAX package's default). Raises when the library was built without
    libjpeg."""
    lib = library()
    if not hasattr(lib, "decode_jpeg_resize_normalize"):
        raise RuntimeError(
            "the host library was built without libjpeg (jpeglib.h did not compile)")
    buf = np.frombuffer(data, np.uint8)
    dims = np.empty((2,), np.int32)
    dst = np.empty((out_hw[0], out_hw[1], 3), np.float32)
    rc = lib.decode_jpeg_resize_normalize(
        buf, buf.size, dst, out_hw[0], out_hw[1], np.asarray(mean, np.float32),
        np.asarray(std, np.float32), 1, dims[0:1], dims[1:2],
    )
    if rc != 0:
        return None
    return dst, int(dims[0]), int(dims[1])


# --- uint8 (device-normalize) variants: with mean 0 and std 1/255 the
# resize's (x / 255 - mean) / std is the identity on pixel values, so the same
# C++ code gives the resized image in 0..255; rint and clip make it uint8.
# The sample then ships to the card at a quarter of the bytes and the model's
# preprocess normalizes it there.

_U8_MEAN = (0.0, 0.0, 0.0)
_U8_STD = (1.0 / 255.0, 1.0 / 255.0, 1.0 / 255.0)


def _to_u8(arr: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(arr), 0.0, 255.0).astype(np.uint8)


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC RGB -> bilinear-resized uint8 [out_h, out_w, 3]."""
    return _to_u8(resize_normalize(img, out_hw, _U8_MEAN, _U8_STD))


def decode_jpeg_resize_u8(
    data: bytes, out_hw: Tuple[int, int]
) -> Optional[Tuple[np.ndarray, int, int]]:
    """JPEG bytes -> (resized uint8 [out_h, out_w, 3], orig_h, orig_w); None
    when the bytes do not decode as a JPEG."""
    res = decode_jpeg_resize_normalize(data, out_hw, _U8_MEAN, _U8_STD)
    if res is None:
        return None
    out, orig_h, orig_w = res
    return _to_u8(out), orig_h, orig_w
