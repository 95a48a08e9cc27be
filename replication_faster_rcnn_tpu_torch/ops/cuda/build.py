"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries with
a plain C interface, loaded with ``ctypes``.

Every ``csrc/*.cu`` source becomes its own library under
``<repo>/build/torch_kernels/``, named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. All
missing libraries are compiled in parallel (one ``nvcc`` per source) at the
first use of any kernel; nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES: Tuple[str, ...] = (
    "nms_kernel", "roi_align_kernel", "roi_pool_kernel", "iou_match_kernel", "quant_kernel",
    "image_kernel",
)

# sm_90a: Hopper. -fmad=false: no product is contracted into an add, so the
# kernels' float arithmetic is strict IEEE like the plain PyTorch versions'.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc executable: $CUDA_HOME/bin, PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}.{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    at once. Returns ``{name: seconds}`` for what was built (``{}`` when all
    were current); raises with nvcc's output on the first failure. The
    compiler's ``-Xptxas -v`` report lands beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            continue
        exe = exe or nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            ),
            tmp,
            target,
        )
    seconds: Dict[str, float] = {}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu (exit {proc.returncode}):\n{log.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name`` (building on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(rc: int, error_string, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C function returns
    ``cudaGetLastError()``; a refused launch never runs and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({error_string(rc).decode()})")
