#!/usr/bin/env python3
"""Run the data path's image kernels (``csrc/image_kernel.cu``) on the CPU
through an emulation of the CUDA they use, and hold them bit for bit
against their plain versions (``ops/image.py``) and, with
``--first-design PATH``, against another version of the source with the
first design's C interface (``git show
68dca63:replication_faster_rcnn_tpu_torch/csrc/image_kernel.cu``).

Run from the repository root on any machine with g++ 12 or later (C++20):
``python tools/image_kernel_emulated.py [--first-design PATH]`` (about a
minute). The source is compiled with g++ (``-ffp-contract=off``, no fast
math) against ``EMU_RUNTIME``: each kernel launch runs its blocks in order,
one ``std::thread`` per CUDA thread and a barrier for ``__syncthreads``;
dynamic shared memory is one buffer filled with 0xCD before each block, so
a read of an unwritten word shows. That covers what these kernels use
(shared memory, barriers, vector types, the ``__f*_rn`` intrinsics) and
nothing else: no warp functions, atomics or asynchronous copies, so the
other sources do not build here. Cases: odd, non-square and 4-aligned
sizes, both dtypes, every geometry mix (identity, flip, all flipped,
translations to and past the edges, jitters from 0.3x to 1.8x), the
batch's rows or a cache's by an idx with a repeat, and launch settings
that split rows and columns into several tiles; the resize's
downsampling, upsampling and one-axis cases. A CPU run says nothing about
time; the card's numbers come from ``tools/image_variants.py``.
"""

import argparse
import ctypes
import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = REPO / "replication_faster_rcnn_tpu_torch" / "csrc" / "image_kernel.cu"
OUT = REPO / "build" / "image_kernel_emulated"

EMU_RUNTIME = r"""// CPU emulation of the CUDA the image kernels use: one std::thread per CUDA
// thread of a block, blocks in order, a barrier for __syncthreads.
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
struct dim3 { unsigned x, y, z; dim3(unsigned a=1, unsigned b=1, unsigned c=1):x(a),y(b),z(c){} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;
struct float4 { float x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a,b,c,d}; }
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t emu_error = 0;
inline cudaError_t cudaGetLastError() { cudaError_t e = emu_error; emu_error = 0; return e; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline std::barrier<>* emu_bar = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
alignas(16) inline unsigned char emu_smem[256 * 1024];
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long min(long a, long b) { return a < b ? a : b; }
inline long max(long a, long b) { return a > b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
#include <math.h>
template <class F>
void emu_launch(dim3 g, dim3 b, size_t smem, F f) {
  if (smem > sizeof(emu_smem) || b.x * b.y * b.z > 1024 || g.x * g.y * g.z == 0) {
    emu_error = 1;
    return;
  }
  gridDim = g; blockDim = b;
  const unsigned nt = b.x * b.y * b.z;
  for (unsigned z = 0; z < g.z; ++z)
  for (unsigned y = 0; y < g.y; ++y)
  for (unsigned x = 0; x < g.x; ++x) {
    blockIdx = {x, y, z};
    std::memset(emu_smem, 0xCD, smem);
    std::barrier<> bar(nt);
    emu_bar = &bar;
    std::vector<std::thread> ts;
    for (unsigned tz = 0; tz < b.z; ++tz)
    for (unsigned ty = 0; ty < b.y; ++ty)
    for (unsigned tx = 0; tx < b.x; ++tx)
      ts.emplace_back([&, tx, ty, tz] { threadIdx = {tx, ty, tz}; f(); });
    for (auto& t : ts) t.join();
  }
}
#define __launch_bounds__(...)
"""


def _split_top(s):
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def emulated_source(src: str) -> str:
    """``src`` with each ``kernel<<<grid, block, smem, stream>>>(args);``
    made ``emu_launch(grid, block, smem, [&] { kernel(args); });`` and the
    dynamic shared memory declarations pointed at the emulation's buffer."""
    out, i = [], 0
    while True:
        j = src.find("<<<", i)
        if j < 0:
            out.append(src[i:])
            break
        k, depth = j, 0
        while k > 0:  # back over the callee, template arguments included
            ch = src[k - 1]
            if ch == ">":
                depth += 1
            elif ch == "<":
                depth -= 1
            elif depth == 0 and not (ch.isalnum() or ch in "_:"):
                break
            k -= 1
        e = src.index(">>>", j)
        depth, m = 0, e + 3
        while True:  # the balanced argument list
            depth += src[m] == "("
            depth -= src[m] == ")"
            if depth == 0 and src[m] == ")":
                break
            m += 1
        cfg = [p.strip() for p in _split_top(src[j + 3:e])] + ["0"] * 2
        out.append(src[i:k])
        out.append(f"emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), {cfg[2]}, "
                   f"[&] {{ {src[k:j]}({src[e + 4:m]}); }})")
        i = m + 1
    text = "".join(out).replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
    return re.sub(r"extern __shared__ float4 (\w+)\[\];",
                  r"float4* \1 = reinterpret_cast<float4*>(emu_smem);", text)


def build(src_path: Path, name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "emu_runtime.h").write_text(EMU_RUNTIME)
    cpp = OUT / f"{name}.cpp"
    cpp.write_text(emulated_source(src_path.read_text()))
    so = OUT / f"{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
                    "-fPIC", "-I", str(OUT), "-o", str(so), str(cpp)], check=True)
    return ctypes.CDLL(str(so))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bitwise(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


class Committed:
    """The committed C interface, called as the wrapper calls it, with its
    launch settings given."""

    def __init__(self, lib):
        from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

        self.k = image_kernel
        self.lib = image_kernel.bind(lib)

    def image(self, images, geom, fills, idx, tile, rows, per_thread):
        n, h, w = geom.shape[0], images.shape[1], images.shape[2]
        out = torch.empty((n, h, w, 3), dtype=images.dtype)
        rc = self.lib.augment_image_launch(_ptr(images), _ptr(idx), _ptr(geom), _ptr(fills), n, h,
                                           w, int(images.dtype == torch.uint8), tile, rows,
                                           per_thread, _ptr(out), None)
        assert rc == 0, rc
        return out

    def resize(self, images, boxes, hw, tile, threads):
        n, ih, iw, _ = images.shape
        h, w = hw
        rows = self.k.band_tables(ih, h, "cpu") if ih != h else (None, None)
        cols = self.k.band_tables(iw, w, "cpu") if iw != w else (None, None)
        spans, plane = None, 0
        if iw != w:
            s, plane = self.k.resize_tile_spans(cols[0].numpy(), cols[1].shape[1], iw, tile[1])
            spans = torch.from_numpy(s)
        out = torch.empty((n, h, w, 3), dtype=images.dtype)
        out_boxes = torch.empty_like(boxes)
        nb = boxes.numel()
        rc = self.lib.resize_aa_launch(
            _ptr(images), int(images.dtype == torch.uint8), _ptr(out), n, ih, iw, h, w,
            _ptr(rows[0]), _ptr(rows[1]), rows[1].shape[1] if ih != h else 0, _ptr(cols[0]),
            _ptr(cols[1]), cols[1].shape[1] if iw != w else 0, _ptr(spans), plane, tile[0],
            tile[1], threads[0], threads[1], _ptr(boxes), _ptr(out_boxes), nb, -(-nb // n),
            float(np.float32(h / ih)), float(np.float32(w / iw)), None)
        assert rc == 0, rc
        return out, out_boxes


class FirstDesign:
    """The first design's C interface: the image pass without launch
    settings, the resize one launch per resized axis."""

    def __init__(self, lib):
        from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.augment_image_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
        lib.resize_aa_launch.argtypes = [p, i, p, i, p, p, i, ll, i, i, ll, p, p, ll, f, f, p]
        lib.augment_image_launch.restype = lib.resize_aa_launch.restype = i
        self.k, self.lib = image_kernel, lib

    def image(self, images, geom, fills, idx, *settings):
        n, h, w = geom.shape[0], images.shape[1], images.shape[2]
        out = torch.empty((n, h, w, 3), dtype=images.dtype)
        rc = self.lib.augment_image_launch(_ptr(images), _ptr(idx), _ptr(geom), _ptr(fills), n, h,
                                           w, int(images.dtype == torch.uint8), _ptr(out), None)
        assert rc == 0, rc
        return out

    def resize(self, images, boxes, hw, *settings):
        n, ih, iw, c = images.shape
        h, w = hw
        kind = int(images.dtype == torch.uint8)
        passes = ([("rows", ih, h)] if ih != h else []) + ([("cols", iw, w)] if iw != w else [])
        out_boxes = torch.empty_like(boxes)
        x, x_kind, rows = images, kind, ih
        for k, (axis, a, b) in enumerate(passes):
            last = k == len(passes) - 1
            start, weight = self.k.band_tables(a, b, "cpu")
            if axis == "rows":
                outer, inner, shape, rows = n, iw * c, (n, b, iw, c), b
            else:
                outer, inner, shape = n * rows, c, (n, rows, b, c)
            out_kind = kind if last else 0
            y = torch.empty(shape, dtype=torch.uint8 if out_kind else torch.float32)
            rc = self.lib.resize_aa_launch(
                _ptr(x), x_kind, _ptr(y), out_kind, _ptr(start), _ptr(weight), weight.shape[1],
                outer, a, b, inner, _ptr(boxes) if last else None,
                _ptr(out_boxes) if last else None, boxes.numel() if last else 0,
                float(np.float32(h / ih)), float(np.float32(w / iw)), None)
            assert rc == 0, rc
            x, x_kind = y, out_kind
        return x, out_boxes


def geometry(rng, n, h, w, kind):
    """int32 [n, 8] geometry rows of one mix."""
    g = np.zeros((n, 8), np.int32)
    g[:, 3], g[:, 4] = h, w
    for r in range(n):
        if kind in ("flip", "mix"):
            g[r, 0] = rng.integers(0, 2)
        if kind in ("translate", "mix"):
            g[r, 1] = rng.choice([0, h - 1, -(h - 1), rng.integers(-h, h + 1), h + 3])
            g[r, 2] = rng.choice([0, w - 1, -(w - 1), rng.integers(-w, w + 1), -w - 2])
        if kind in ("scale", "mix"):
            g[r, 3] = max(1, int(round(h * rng.uniform(0.3, 1.8))))
            g[r, 4] = max(1, int(round(w * rng.uniform(0.3, 1.8))))
            g[r, 5] = rng.integers(-h // 2, h // 2 + 1)
            g[r, 6] = rng.integers(-w // 2, w // 2 + 1)
            g[r, 7] = int(rng.uniform() < 0.8)
    if kind == "allflip":
        g[:, 0] = 1
    return torch.from_numpy(g)


def images_of(rng, shape, dtype):
    if dtype == "uint8":
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


def check_image(impls, rng):
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.ops import image as I

    count = 0
    for (h, w), dtype, kind, gather, settings in itertools.product(
            [(7, 9), (5, 13), (6, 16), (3, 31)], ["uint8", "float32"],
            ["identity", "flip", "allflip", "translate", "scale", "mix"], [False, True],
            [(1024, 2, 2), (8, 1, 1), (12, 3, 3), (16, 4, 1)]):
        n = 3
        src = images_of(rng, (5 if gather else n, h, w, 3), dtype)
        idx = torch.tensor([4, 1, 4], dtype=torch.int32) if gather else None
        geom = geometry(rng, n, h, w, kind)
        batch = src[idx.long()] if gather else src
        with ops.reference_scope():
            want = I.augment_images_plain(batch, geom)
            fills = I.image_fills_plain(batch, geom).contiguous()
        fills = None if kind in ("identity", "flip", "allflip") else fills
        outs = {name: impl.image(src, geom, fills, idx, *settings) for name, impl in impls.items()}
        for name, got in outs.items():
            assert _bitwise(got, want), (name, h, w, dtype, kind, gather, settings)
        if kind == "allflip":
            assert _bitwise(outs["committed"], torch.flip(batch, [2]))
        if kind == "identity" and gather:
            assert _bitwise(outs["committed"], torch.index_select(src, 0, idx.long()))
        count += 1
    return count


def check_resize(impls, rng):
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.ops import image as I

    count = 0
    for (ih, iw), (h, w), dtype, settings in itertools.product(
            [(11, 13), (9, 10), (40, 33)], [(7, 9), (11, 17), (13, 13), (9, 10), (5, 4), (40, 12)],
            ["uint8", "float32"],
            [((8, 64), (32, 8)), ((3, 4), (2, 2)), ((2, 5), (3, 1)), ((5, 16), (4, 3))]):
        if (ih, iw) == (h, w):
            continue
        images = images_of(rng, (3, ih, iw, 3), dtype)
        boxes = torch.from_numpy(rng.uniform(0, 40, (3, 5, 4)).astype(np.float32))
        with ops.reference_scope():
            want = I.resize_batch_with_boxes(images, boxes, (h, w))
        for name, impl in impls.items():
            got = impl.resize(images, boxes, (h, w), *settings)
            assert _bitwise(got[0], want[0]) and _bitwise(got[1], want[1]), (
                name, ih, iw, h, w, dtype, settings)
        count += 1
    return count


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-design", metavar="PATH", help="the first design's source")
    args = ap.parse_args()
    impls = {"committed": Committed(build(SOURCE, "committed"))}
    if args.first_design:
        impls["first_design"] = FirstDesign(build(Path(args.first_design), "first_design"))
    rng = np.random.default_rng(0)
    n_image, n_resize = check_image(impls, rng), check_resize(impls, rng)
    print(f"bitwise the plain versions ({', '.join(impls)}): {n_image} image-pass cases, "
          f"{n_resize} resize cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
