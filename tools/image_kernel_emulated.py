#!/usr/bin/env python3
"""Run the data path's image kernels (``csrc/image_kernel.cu``) on the CPU
through an emulation of the CUDA they use, and hold them against their
plain versions (``ops/image.py``) and, with ``--first-design PATH``,
against the previous design's source (``git show
c68a333:replication_faster_rcnn_tpu_torch/csrc/image_kernel.cu``: the
geometry a thread per image, the fills in two launches).

Run from the repository root on any machine with g++ 12 or later (C++20):
``python tools/image_kernel_emulated.py [--first-design PATH]`` (a few
minutes). The source is compiled with g++ (``-ffp-contract=off``, no fast
math) against ``EMU_RUNTIME``: one ``std::thread`` per CUDA thread; the
blocks of a thread block cluster (``cudaLaunchKernelEx`` with a cluster
dimension) run together, with a barrier across them for
``cluster.sync()`` and ``map_shared_rank`` onto the other blocks' shared
memory, clusters (single blocks otherwise) in order; a barrier for
``__syncthreads`` and one per warp for ``__shfl_down_sync``; each block's
dynamic shared memory is its own buffer filled with 0xCD, so a read of an
unwritten word shows. That covers what these kernels use (shared memory,
barriers, clusters, warp shuffles, ``__dp4a``, vector types, the
``__f*_rn`` intrinsics) and nothing else: no atomics or asynchronous copies, so the
other sources do not build here. Static ``__shared__`` arrays are one per
launch, so only kernels launched without a cluster may hold them.

Cases, bitwise unless said: the image pass and the resize as before (odd,
non-square and 4-aligned sizes, both dtypes, every geometry mix, the
batch's rows or a cache's by an idx with a repeat, launch settings that
split rows and columns into several tiles; the resize's downsampling,
upsampling and one-axis cases); the geometry kernel (aug draws in four
mixes and the host's flip / shifts / jitter, G = 0, 5 and 100, the cache's
rows by idx) against ``augment_prepare_plain``'s geometry and
``augment_draws``; the prepare kernel and the fills alone at small odd
shapes (rows of fewer elements than a vector, bands of no row, windows
empty and full) and cluster sizes and threads (1 x 96 to 8 x 192): the
geometry outputs bitwise, uint8 fills bitwise and float32 fills within 1
ulp of the plain fills and bitwise between the two kernels. A CPU run
says nothing about time; the card's numbers come from
``tools/image_variants.py``.
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
// thread; the blocks of a cluster run together (a cluster of one block
// outside cluster launches), clusters in order; a barrier per block for
// __syncthreads, one per cluster for cluster.sync(), one per warp for the
// shuffles; each block's dynamic shared memory its own buffer.
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <memory>
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
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;
struct float4 { float x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a,b,c,d}; }
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize,
                         cudaFuncAttributeNonPortableClusterSizeAllowed };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t emu_error = 0;
inline cudaError_t cudaGetLastError() { cudaError_t e = emu_error; emu_error = 0; return e; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline unsigned __dp4a(unsigned a, unsigned b, unsigned c) {
  for (int j = 0; j < 4; ++j) c += ((a >> (8 * j)) & 255u) * ((b >> (8 * j)) & 255u);
  return c;
}
struct alignas(16) EmuChunk { unsigned char b[16]; };
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<unsigned long long> xchg;  // a word a thread for the shuffles
  std::vector<EmuChunk> smem;
  unsigned rank;
  std::barrier<>* cluster_bar;
  std::vector<unsigned char*>* cluster_smem;  // each rank's shared memory
};
inline thread_local EmuBlock* emu_block = nullptr;
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline unsigned emu_tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned d) {
  static_assert(sizeof(T) <= 8);
  const unsigned t = emu_tid(), lane = t % 32;
  unsigned long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_block->xchg[t] = bits;
  emu_block->warp_bars[t / 32]->arrive_and_wait();
  T out = v;
  if (lane + d < 32 && t + d < emu_block->xchg.size())
    std::memcpy(&out, &emu_block->xchg[t + d], sizeof(T));
  emu_block->warp_bars[t / 32]->arrive_and_wait();
  return out;
}
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_block->rank; }
  void sync() const { emu_block->cluster_bar->arrive_and_wait(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned r) const {
    const std::ptrdiff_t off =
        reinterpret_cast<unsigned char*>(p) - reinterpret_cast<unsigned char*>(emu_block->smem.data());
    return reinterpret_cast<T*>((*emu_block->cluster_smem)[r] + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long min(long a, long b) { return a < b ? a : b; }
inline long max(long a, long b) { return a > b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
#include <math.h>
template <class F>
void emu_run(dim3 g, dim3 b, size_t smem, dim3 cl, F f) {
  const unsigned nt = b.x * b.y * b.z, k = cl.x * cl.y * cl.z;
  if (smem > 232448 || nt > 1024 || nt == 0 || g.x * g.y * g.z == 0 || k > 16 ||
      g.x % cl.x || g.y % cl.y || g.z % cl.z) {
    emu_error = 1;
    return;
  }
  gridDim = g; blockDim = b;
  for (unsigned cz = 0; cz < g.z / cl.z; ++cz)
  for (unsigned cy = 0; cy < g.y / cl.y; ++cy)
  for (unsigned cx = 0; cx < g.x / cl.x; ++cx) {
    std::barrier<> cluster_bar(k * nt);
    std::vector<EmuBlock> blocks(k);
    std::vector<unsigned char*> smems(k);
    for (unsigned r = 0; r < k; ++r) {
      EmuBlock& e = blocks[r];
      e.bar = std::make_unique<std::barrier<>>(nt);
      for (unsigned w0 = 0; w0 < nt; w0 += 32)
        e.warp_bars.push_back(std::make_unique<std::barrier<>>(min(32u, nt - w0)));
      e.xchg.assign(nt, 0);
      e.smem.resize((smem + 15) / 16 + 1);
      std::memset(e.smem.data(), 0xCD, e.smem.size() * 16);
      e.rank = r;
      e.cluster_bar = &cluster_bar;
      e.cluster_smem = &smems;
      smems[r] = reinterpret_cast<unsigned char*>(e.smem.data());
    }
    std::vector<std::thread> ts;
    for (unsigned r = 0; r < k; ++r) {
      const uint3 bi = {cx * cl.x + r % cl.x, cy * cl.y + (r / cl.x) % cl.y, cz * cl.z + r / (cl.x * cl.y)};
      for (unsigned tz = 0; tz < b.z; ++tz)
      for (unsigned ty = 0; ty < b.y; ++ty)
      for (unsigned tx = 0; tx < b.x; ++tx)
        ts.emplace_back([&, tx, ty, tz, bi, r] {
          threadIdx = {tx, ty, tz};
          blockIdx = bi;
          emu_block = &blocks[r];
          f();
        });
    }
    for (auto& t : ts) t.join();
  }
}
template <class F>
void emu_launch(dim3 g, dim3 b, size_t smem, F f) { emu_run(g, b, smem, dim3(1, 1, 1), f); }
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; char pad[64]; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*kernel)(Exp...), Act&&... args) {
  dim3 cl(1, 1, 1);
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = dim3(c->attrs[i].val.clusterDim.x, c->attrs[i].val.clusterDim.y,
                c->attrs[i].val.clusterDim.z);
  emu_run(c->gridDim, c->blockDim, c->dynamicSmemBytes, cl, [&] { kernel(args...); });
  return cudaGetLastError();
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
    text = text.replace("#include <cooperative_groups.h>\n", "")
    return re.sub(r"extern __shared__ float4 (\w+)\[\];",
                  r"float4* \1 = reinterpret_cast<float4*>(emu_block->smem.data());", text)


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


GEOMETRY_ARGS = ("idx", "aug", "seed", "hflip", "scale_range", "translate", "flip", "shifts",
                 "jitter", "apply", "resample")


def geometry_args(n, h, w, boxes, labels, mask, kw):
    """The C interface's geometry arguments for the keywords ``kw`` (those
    of ``augment_geometry_cuda``) and the box outputs."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel as K

    kw = {k: kw.get(k) for k in GEOMETRY_ARGS if kw.get(k) is not None}
    seed, lo_hi = kw.get("seed", 0), kw.get("scale_range")
    lo, hi = (0.0, 0.0) if lo_hi is None else lo_hi
    t = kw.get("translate", 0.0)
    g = boxes.shape[1] if boxes is not None else 0
    modes = {"rows": 0, "all": 1, "none": 2}
    args = (_ptr(boxes), _ptr(labels), _ptr(mask), _ptr(kw.get("idx")), _ptr(kw.get("aug")),
            (int(seed) * K.GAMMA) & K.MASK64, int(bool(kw.get("hflip"))), int(lo_hi is not None),
            float(np.float32(lo)), float(np.float32(hi - lo)), int(bool(t)),
            float(np.float32(t * h)), float(np.float32(t * w)), _ptr(kw.get("flip")),
            _ptr(kw.get("shifts")), _ptr(kw.get("jitter")), _ptr(kw.get("apply")),
            modes[kw.get("resample", "rows")], n, g, h, w)
    outs = (torch.empty(n, g, 4), torch.empty(n, g, dtype=torch.int32),
            torch.empty(n, g, dtype=torch.bool) if mask is not None else None) if g else \
        (None, None, None)
    return args, outs


class Committed:
    """The committed C interface, called as the wrapper calls it, with its
    launch settings given."""

    def __init__(self, lib):
        from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

        self.k = image_kernel
        self.lib = image_kernel.bind(lib)

    def geometry(self, n, h, w, boxes, labels, mask, kw, draws=False):
        args, (ob, ol, om) = geometry_args(n, h, w, boxes, labels, mask, kw)
        geom = torch.empty(n, 8, dtype=torch.int32)
        d = torch.empty(n, 6) if draws else None
        rc = self.lib.augment_geometry_launch(*args, _ptr(ob), _ptr(ol), _ptr(om), _ptr(geom),
                                              _ptr(d), None)
        assert rc == 0, rc
        return ob, ol, om, geom, d

    def prepare(self, images, boxes, labels, mask, kw, cluster, threads):
        idx = kw.get("idx")
        n, h, w = (idx.shape[0] if idx is not None else images.shape[0]), *images.shape[1:3]
        args, (ob, ol, om) = geometry_args(n, h, w, boxes, labels, mask, kw)
        geom, fills = torch.empty(n, 8, dtype=torch.int32), torch.empty(n, 2, 3)
        rc = self.lib.augment_prepare_launch(
            *args, _ptr(images), int(images.dtype == torch.uint8), cluster, threads, _ptr(ob),
            _ptr(ol), _ptr(om), _ptr(geom), _ptr(fills), None)
        assert rc == 0, rc
        return ob, ol, om, geom, fills

    def fill(self, images, geom, idx, cluster, threads):
        n, h, w = geom.shape[0], images.shape[1], images.shape[2]
        fills = torch.empty(n, 2, 3)
        rc = self.lib.image_fill_launch(_ptr(images), _ptr(idx), _ptr(geom), n, h, w,
                                        int(images.dtype == torch.uint8), cluster, threads,
                                        _ptr(fills), None)
        assert rc == 0, rc
        return fills

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


class FirstDesign(Committed):
    """The previous design's C interface: the committed one's image pass,
    resize and geometry, and the fills' two launches with a float64 scratch
    (no prepare launch)."""

    def __init__(self, lib):
        from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.augment_geometry_launch.argtypes = [
            p, p, p, p, p, ctypes.c_ulonglong, i, i, f, f, i, f, f, p, p, p, p, i,
            i, i, i, i, p, p, p, p, p, p]
        lib.image_fill_launch.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.augment_image_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p]
        lib.resize_aa_launch.argtypes = [
            p, i, p, i, i, i, i, i, p, p, i, p, p, i, p, i, i, i, i, i, p, p, ll, ll, f, f, p]
        for fn in (lib.augment_geometry_launch, lib.image_fill_launch, lib.augment_image_launch,
                   lib.resize_aa_launch):
            fn.restype = i
        self.k, self.lib = image_kernel, lib

    def prepare(self, *args):
        raise NotImplementedError("the previous design has no prepare launch")

    def fill(self, images, geom, idx, *settings):
        n, h, w = geom.shape[0], images.shape[1], images.shape[2]
        partial, fills = torch.empty(n, 16, 6, dtype=torch.float64), torch.empty(n, 2, 3)
        rc = self.lib.image_fill_launch(_ptr(images), _ptr(idx), _ptr(geom), n, h, w,
                                        int(images.dtype == torch.uint8), _ptr(partial),
                                        _ptr(fills), None)
        assert rc == 0, rc
        return fills


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


def boxes_of(rng, rows, g, h, w):
    """[rows, g] boxes, labels (a third padded: -1) and masks."""
    y = rng.uniform(-2, h, (rows, g, 2))
    x = rng.uniform(-2, w, (rows, g, 2))
    boxes = np.stack([y.min(-1), x.min(-1), y.max(-1) + 0.5, x.max(-1) + 0.5], -1)
    labels = rng.integers(1, 21, (rows, g)).astype(np.int32)
    labels[:, ::3] = -1
    boxes[labels < 0] = -1.0
    return (torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(labels),
            torch.from_numpy(labels >= 0))


def decisions(rng, kind, n, h, w, rows):
    """Keywords of one geometry mix: aug draws, or the host's decisions."""
    if kind.startswith("aug"):
        aug = torch.from_numpy(np.stack([rng.integers(0, 5011, n), rng.integers(0, 50, n)],
                                        -1).astype(np.int32))
        mix = {"aug_flip": dict(hflip=True), "aug_translate": dict(translate=0.2),
               "aug_scale": dict(scale_range=(0.5, 1.5)),
               "aug_all": dict(hflip=True, scale_range=(0.75, 1.25), translate=0.1)}[kind]
        return dict(aug=aug, seed=int(rng.integers(0, 2**31)), **mix)
    g = geometry(rng, n, h, w, "mix").numpy()
    g[0, 1:3] = (h + 3, 0)  # an empty window
    kw = dict(flip=torch.from_numpy(g[:, 0] != 0), shifts=torch.from_numpy(g[:, 1:3].copy()),
              jitter=torch.from_numpy(g[:, 3:7].copy()))
    if kind == "host_apply":
        kw["apply"] = torch.from_numpy(rng.uniform(size=n) < 0.5)
        kw["resample"] = "all"
    if kind == "cache":
        kw["idx"] = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32))
        kw["idx"][-1] = kw["idx"][0]
        del kw["shifts"]
        kw["resample"] = "all"
    return kw


def plain_prepare(images, boxes, labels, mask, kw):
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.ops import image as I

    with ops.reference_scope():
        return I.augment_prepare_plain(images, boxes, labels, mask, **kw)


def fills_close(got, want):
    """uint8 fills bitwise; float32 within 1 float32 ulp."""
    ulp = torch.from_numpy(np.spacing(np.abs(want.numpy())))
    return bool(((got - want).abs() <= ulp).all())


def check_geometry(impls, rng):
    from replication_faster_rcnn_tpu_torch.ops import image as I

    count = 0
    kinds = ["aug_flip", "aug_translate", "aug_scale", "aug_all", "host", "host_apply", "cache"]
    for (h, w), n, g, kind in itertools.product([(7, 9), (16, 6)], [1, 5], [0, 5, 100], kinds):
        rows = 4 if kind == "cache" else n
        boxes, labels, mask = boxes_of(rng, rows, g, h, w)
        kw = decisions(rng, kind, n, h, w, rows)
        images = torch.zeros(rows, h, w, 3, dtype=torch.uint8)
        want = plain_prepare(images, boxes, labels, mask, kw)
        for name, impl in impls.items():
            got = impl.geometry(n, h, w, boxes, labels, mask, kw, draws=kind.startswith("aug"))
            for a, b, what in zip(got[:4], want[:4], ("boxes", "labels", "mask", "geom")):
                if g or what == "geom":
                    assert _bitwise(a, b), (name, what, h, w, n, g, kind)
            if kind.startswith("aug"):
                draws = I._draws_plain(kw["seed"], kw["aug"][:, 1], kw["aug"][:, 0])
                plain = torch.stack([draws[0].float(), *draws[1:]], -1)
                assert _bitwise(got[4], plain), (name, "draws", kind)
        count += 1
    return count


def check_prepare(impls, rng):
    committed = impls["committed"]
    count = 0
    kinds = ["aug_all", "aug_translate", "host", "cache"]
    for (h, w), dtype, kind, settings in itertools.product(
            [(7, 9), (5, 13), (3, 1), (1, 2), (11, 5), (6, 16), (9, 40), (4, 67)],
            ["uint8", "float32"], kinds,
            [(1, 96), (3, 96), (4, 192), (8, 96)]):
        n = 3
        rows = 4 if kind == "cache" else n
        g = 100 if (h, w) == (7, 9) else 5
        images = images_of(rng, (rows, h, w, 3), dtype)
        boxes, labels, mask = boxes_of(rng, rows, g, h, w)
        kw = decisions(rng, kind, n, h, w, rows)
        want = plain_prepare(images, boxes, labels, mask, kw)
        got = committed.prepare(images, boxes, labels, mask, kw, *settings)
        for a, b, what in zip(got[:4], want[:4], ("boxes", "labels", "mask", "geom")):
            assert _bitwise(a, b), (what, h, w, dtype, kind, settings)
        fills = got[4]
        assert fills_close(fills, want[4]), (h, w, dtype, kind, settings, fills, want[4])
        if dtype == "uint8":
            assert _bitwise(fills, want[4]), (h, w, kind, settings)
        idx = kw.get("idx")
        for name, impl in impls.items():
            alone = impl.fill(images, got[3], idx, *settings)
            if name == "committed" or dtype == "uint8":
                assert _bitwise(alone, fills), (name, h, w, dtype, kind, settings)
            else:
                assert fills_close(alone, want[4]), (name, h, w, dtype, kind, settings)
        count += 1
    return count


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-design", metavar="PATH", help="the previous design's source")
    args = ap.parse_args()
    impls = {"committed": Committed(build(SOURCE, "committed"))}
    if args.first_design:
        impls["first_design"] = FirstDesign(build(Path(args.first_design), "first_design"))
    rng = np.random.default_rng(0)
    n_geometry, n_prepare = check_geometry(impls, rng), check_prepare(impls, rng)
    print(f"geometry bitwise the plain version ({', '.join(impls)}): {n_geometry} cases; "
          f"prepare: geometry bitwise, fills uint8 bitwise / float32 within 1 ulp, the fills "
          f"alone bitwise the prepare launch's: {n_prepare} cases")
    n_image, n_resize = check_image(impls, rng), check_resize(impls, rng)
    print(f"bitwise the plain versions ({', '.join(impls)}): {n_image} image-pass cases, "
          f"{n_resize} resize cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
