#!/usr/bin/env python3
"""Time designs of the PyTorch port's data-path image kernels on the card:
the bucket resize ``resize_aa_kernel``, the augmentation / cache-gather
pass ``augment_image_kernel``, the geometry ``augment_geometry_kernel`` and
the prepare launch ``augment_prepare_kernel`` (the geometry and the fills
in one launch, a thread block cluster per image; without its geometry,
``image_fill_cuda``).

Run from the repository root on a machine with an NVIDIA H100:
``python tools/image_variants.py [--first-design PATH] [--only NAME ...]``
(``--edits-only`` checks on any machine that every edit still applies to
the source, and stops), where PATH holds the previous design's source
(``git show c68a333:replication_faster_rcnn_tpu_torch/csrc/image_kernel.cu``:
the geometry one thread per image walking its boxes, the fills two
launches with float64 partials in device memory).

The committed source (``replication_faster_rcnn_tpu_torch/csrc/
image_kernel.cu``) and the first design are compiled with the port's nvcc
flags into ``build/image_variants/``; each ``-Xptxas -v`` report of the
kernels (registers, stack frame, spills) is printed. Cases: ``chip_smoke.py``
[3]'s at 600x600, b8 and b16, uint8 and float32: the resize to 480, 720 and
240; the image pass on [3]'s four row mixes (aug draws), the cache gather
(b8 from a 1,024-image cache, flip + jitter), every row flipped (against
``torch.flip``) and the identity gather (against ``torch.index_select``);
the prepare launch on the four row mixes with 32 boxes and on the cache
path (the first design: its geometry and fill calls, three launches), the
geometry alone at G = 32, 100 and 0, the fills alone, and the whole
``materialize`` chain (prepare + image pass; the first design's geometry,
fills and image pass). The committed source's outputs are held against the
plain versions (``ops/image.py``: the resize, the geometry and uint8
bitwise; float32 fills within 1 ulp, float32 images within
``chip_smoke.image_errors``), the first design's against the committed
source's in both directions (each side's output is the other's reference;
bit for bit but float32 fills within 1 ulp). The variants are the committed
source under other launch settings (``VARIANTS``: the resize's tile and
threads, the image pass's column tile, rows and pixels a thread, the
prepare launch's cluster size and threads a block) or with source edits,
each held bit for bit against it. Order: the first design, the committed
source, the variants, the committed source again, the first design again;
all in one process on one card. Times are device ms per call (CUDA events
behind a device sleep, ``chip_smoke.time_ms``) and, for the main-path
cases, per kernel from ``torch.profiler``; ``library_ms`` is
``torch.sum(images, dim=(1, 2))`` in int64 / float64 beside the prepare
and fill cases (the first fill's sum alone). The last line of standard
output is one JSON object with every result; ``results.json`` in ``--out``
(default ``build/image_variants/``) holds it too.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = REPO / "replication_faster_rcnn_tpu_torch" / "csrc" / "image_kernel.cu"
U8, F32 = "uint8", "float32"
DEFAULTS = {"RESIZE_TILE": (8, 128), "RESIZE_THREADS": {U8: (32, 4), F32: (32, 8)},
            "IMAGE_TILE": 1024, "IMAGE_ROWS": {U8: 2, F32: 2},
            "IMAGE_PIXELS_PER_THREAD": {U8: 8, F32: 2},
            "PREPARE_CLUSTER": {U8: 16, F32: 8}, "PREPARE_THREADS": {U8: 384, F32: 768}}
# name -> (the wrapper's launch settings that differ from DEFAULTS, source
# edits [(old, new)], each old string found exactly once in the committed
# source); a variant with edits is compiled on its own
VARIANTS = {
    "resize_tile_8x64": ({"RESIZE_TILE": (8, 64)}, []),
    "resize_tile_4x128": ({"RESIZE_TILE": (4, 128)}, []),
    "resize_tile_16x128": ({"RESIZE_TILE": (16, 128)}, []),
    "resize_tile_8x256": ({"RESIZE_TILE": (8, 256)}, []),
    "resize_threads_32x8_32x4": ({"RESIZE_THREADS": {U8: (32, 8), F32: (32, 4)}}, []),
    "resize_threads_64x4": ({"RESIZE_THREADS": {U8: (64, 4), F32: (64, 4)}}, []),
    "image_rows_1": ({"IMAGE_ROWS": {U8: 1, F32: 1}}, []),
    "image_rows_4": ({"IMAGE_ROWS": {U8: 4, F32: 4}}, []),
    "image_pixels_4_1": ({"IMAGE_PIXELS_PER_THREAD": {U8: 4, F32: 1}}, []),
    "image_pixels_16_4": ({"IMAGE_PIXELS_PER_THREAD": {U8: 16, F32: 4}}, []),
    "image_tile_320": ({"IMAGE_TILE": 320}, []),
    "prepare_c8_t384": ({"PREPARE_CLUSTER": {U8: 8, F32: 8},
                         "PREPARE_THREADS": {U8: 384, F32: 384}}, []),
    "prepare_c16_t192": ({"PREPARE_CLUSTER": {U8: 16, F32: 16},
                          "PREPARE_THREADS": {U8: 192, F32: 192}}, []),
    "prepare_c16_t384": ({"PREPARE_CLUSTER": {U8: 16, F32: 16},
                          "PREPARE_THREADS": {U8: 384, F32: 384}}, []),
    "prepare_c16_t768": ({"PREPARE_CLUSTER": {U8: 16, F32: 16},
                          "PREPARE_THREADS": {U8: 768, F32: 768}}, []),
    "prepare_c4_t768": ({"PREPARE_CLUSTER": {U8: 4, F32: 4},
                         "PREPARE_THREADS": {U8: 768, F32: 768}}, []),
    "prepare_loads_2": ({}, [("constexpr int PREPARE_LOADS = 4;",
                              "constexpr int PREPARE_LOADS = 2;")]),
    # 8 loads in flight take 96-160 registers: fewer threads a block
    "prepare_loads_8_t192": ({"PREPARE_THREADS": {U8: 192, F32: 384}},
                             [("constexpr int PREPARE_LOADS = 4;",
                               "constexpr int PREPARE_LOADS = 8;")]),
    # uint8 class sums a lane at a time instead of four bytes a dp4a
    "prepare_lanes": ({}, [("    for (int q = 0; q < 4; ++q) acc = __dp4a(word[q], class_mask(q, k), acc);",
                            "    for (int l = k; l < 16; l += 3) acc += v.e[l];")]),
}
MAIN_CASES = ("resize_b8_uint8_480", "resize_b8_uint8_720", "image_b8_uint8_flip+translate+scale",
              "image_cache_b8_uint8", "prepare_b8_uint8_flip+translate+scale",
              "prepare_b8_float32_flip+translate+scale", "prepare_cache_b8_uint8",
              "materialize_b8_uint8", "geometry_b8_g32")
KERNELS = ("resize_aa_kernel", "augment_image_kernel", "augment_prepare_kernel",
           "augment_geometry_kernel", "image_fill_finish_kernel", "image_fill_kernel")
H = W = 600


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def ptxas(log):
    """(kernel, properties) of each resize / image entry function in a
    ``-Xptxas -v`` report, names demangled where c++filt is found."""
    try:
        log = subprocess.run(["c++filt"], input=log, capture_output=True, text=True).stdout or log
    except OSError:
        pass
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and any(k in ln for k in KERNELS):
            props = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "stack frame" in x or "registers" in x)
            out.append([ln.split("'")[1], props])
    return out


def compile_all(build, texts):
    """nvcc every source at once; {name: (library, ptxas entries)}."""
    out_dir = build.BUILD_DIR.parent / "image_variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                              str(cu)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
        return name, (ctypes.CDLL(str(cu.with_suffix(".so"))), ptxas(res.stdout + res.stderr))

    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        return dict(pool.map(one, texts.items()))


def first_design_calls(torch, K, lib):
    """The previous design's calls: its image pass, resize and geometry
    through the committed wrappers (the same C functions), its fills
    through its own C function (two launches, a float64 scratch); its
    prepare is the geometry and the fills, its ``materialize`` both and the
    image pass."""
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
    lib.image_error_string.argtypes = [i]
    lib.image_error_string.restype = ctypes.c_char_p

    def use():
        K._fns = lib
        apply_settings(torch, K, {})

    def fill(images, geom, idx=None):
        use()
        n, h, w = geom.shape[0], images.shape[1], images.shape[2]
        partial = torch.empty(n, 16, 6, dtype=torch.float64, device=images.device)
        fills = torch.empty(n, 2, 3, dtype=torch.float32, device=images.device)
        rc = lib.image_fill_launch(images.data_ptr(), K._ptr(idx), geom.data_ptr(), n, h, w,
                                   K._image_kind(images), partial.data_ptr(), fills.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"first design fills: CUDA error {rc}")
        return fills

    def geometry(boxes, labels, mask, n, h, w, kw):
        use()
        return K.augment_geometry_cuda(boxes, labels, mask, n, h, w, device=boxes.device,
                                       **kw)[:4]

    def prepare(images, boxes, labels, mask, kw):
        n = kw["idx"].shape[0] if "idx" in kw else images.shape[0]
        geom_out = geometry(boxes, labels, mask, n, images.shape[1], images.shape[2], kw)
        return (*geom_out, fill(images, geom_out[3], kw.get("idx")))

    def materialize(images, boxes, labels, mask, kw):
        b, l, m, geom, fills = prepare(images, boxes, labels, mask, kw)
        use()
        return K.augment_image_cuda(images, geom, fills, kw.get("idx")), b, l, m

    def image(images, geom, fills, idx=None):
        use()
        return K.augment_image_cuda(images, geom, fills, idx)

    def resize(images, boxes, out_hw):
        use()
        return K.resize_aa_cuda(images, boxes, out_hw)

    return {"image": image, "resize": resize, "geometry": geometry, "fill": fill,
            "prepare": prepare, "materialize": materialize}


def apply_settings(torch, K, settings):
    """The wrapper's launch settings: DEFAULTS updated by ``settings``."""
    for key, value in {**DEFAULTS, **settings}.items():
        if isinstance(value, dict):  # by dtype
            value = {getattr(torch, k): v for k, v in value.items()}
        setattr(K, key, value)


def wrapper_calls(torch, K, lib, settings):
    """The committed wrappers on ``lib`` under the launch ``settings``."""
    def use():
        K._fns = lib
        apply_settings(torch, K, settings)

    def image(images, geom, fills, idx=None):
        use()
        return K.augment_image_cuda(images, geom, fills, idx)

    def resize(images, boxes, out_hw):
        use()
        return K.resize_aa_cuda(images, boxes, out_hw)

    def geometry(boxes, labels, mask, n, h, w, kw):
        use()
        return K.augment_geometry_cuda(boxes, labels, mask, n, h, w, device=boxes.device,
                                       **kw)[:4]

    def fill(images, geom, idx=None):
        use()
        return K.image_fill_cuda(images, geom, idx)

    def prepare(images, boxes, labels, mask, kw):
        use()
        return K.augment_prepare_cuda(images, boxes, labels, mask, **kw)

    def materialize(images, boxes, labels, mask, kw):
        b, l, m, geom, fills = prepare(images, boxes, labels, mask, kw)
        return K.augment_image_cuda(images, geom, fills, kw.get("idx")), b, l, m

    return {"image": image, "resize": resize, "geometry": geometry, "fill": fill,
            "prepare": prepare, "materialize": materialize}


def make_cases(torch, cs, K, dev):
    """{key: (kind, args)}: [3]'s resize, image-pass, prepare, geometry,
    fill and materialize inputs (the image pass's geometry rows and fills
    from the committed prepare launch)."""
    rng = np.random.default_rng(21)
    cases = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def box_set(rows, g):
        boxes = np.minimum(cs.rand_boxes(rng, (rows, g), 520, 260), 600).astype(np.float32)
        labels = rng.integers(1, 21, (rows, g)).astype(np.int32)
        labels[:, 6:] = -1
        boxes[:, 6:] = -1.0
        return t(boxes), t(labels), t(labels >= 0)

    for b in (8, 16):
        for dtype in ("uint8", "float32"):
            if dtype == "uint8":
                images = t(rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8))
            else:
                images = t(rng.normal(0, 1, (b, H, W, 3)).astype(np.float32))
            boxes = t(np.minimum(cs.rand_boxes(rng, (b, 32), 520, 260), 600).astype(np.float32))
            for size in (480, 720, 240):
                cases[f"resize_b{b}_{dtype}_{size}"] = ("resize", (images, boxes, (size, size)))
            aug = t(np.stack([rng.integers(0, 5011, b), rng.integers(0, 50, b)], -1)
                    .astype(np.int32))
            gb, gl, gm = box_set(b, 32)
            for mode, kw in cs.AUG_MODES:
                kw = dict(aug=aug, seed=cs.AUG_SEED, **kw)
                _, _, _, geom, fills = K.augment_prepare_cuda(images, gb, gl, gm, **kw)
                cases[f"image_b{b}_{dtype}_{mode}"] = ("image", (images, geom, fills, None))
                cases[f"prepare_b{b}_{dtype}_{mode}"] = ("prepare", (images, gb, gl, gm, kw))
                if mode == "flip+translate+scale":
                    cases[f"fill_b{b}_{dtype}"] = ("fill", (images, geom, None))
                    if b == 8:
                        cases[f"materialize_b8_{dtype}"] = ("materialize",
                                                            (images, gb, gl, gm, kw))
                        if dtype == "uint8":
                            for g in (32, 100, 0):
                                cb, cl, cm = box_set(b, g)
                                cases[f"geometry_b8_g{g}"] = ("geometry",
                                                              (cb, cl, cm, b, H, W, kw))
            if b != 8:
                continue
            *_, geom, _ = K.augment_geometry_cuda(
                None, None, None, b, H, W, device=dev,
                flip=torch.ones(b, dtype=torch.bool, device=dev))
            cases[f"image_allflip_b8_{dtype}"] = ("image", (images, geom, None, None))
            m = 1024
            cache = (t(rng.integers(0, 256, (m, H, W, 3), dtype=np.uint8)) if dtype == "uint8"
                     else torch.randn(m, H, W, 3, device=dev,
                                      generator=torch.Generator(dev).manual_seed(3)))
            cb, cl, cm = box_set(m, 32)
            idx = t(rng.choice(m, b, replace=False).astype(np.int32))
            scale = rng.uniform(0.75, 1.25, b)
            ch = np.rint(H * scale).astype(np.int32)
            jitter = np.stack([ch, ch, np.rint((ch - H) * rng.uniform(0, 1, b)),
                               np.rint((ch - W) * rng.uniform(0, 1, b))], -1).astype(np.int32)
            jitter[0] = [H, W, 0, 0]
            kw = dict(idx=idx, flip=t(rng.uniform(size=b) < 0.5), jitter=t(jitter),
                      resample="all")
            _, _, _, geom, fills = K.augment_prepare_cuda(cache, cb, cl, cm, **kw)
            cases[f"image_cache_b8_{dtype}"] = ("image", (cache, geom, fills, idx))
            cases[f"prepare_cache_b8_{dtype}"] = ("prepare", (cache, cb, cl, cm, kw))
            *_, geom, _ = K.augment_geometry_cuda(None, None, None, b, H, W, idx=idx, device=dev)
            cases[f"image_gather_b8_{dtype}"] = ("image", (cache, geom, None, idx))
    return cases


def library_call(torch, key, args):
    """The one PyTorch call that computes a pure-copy case, or the
    yardstick of a fill case (the first fill's sum), or None."""
    if key.startswith("image_allflip"):
        images = args[0]
        return lambda: torch.flip(images, [2])
    if key.startswith("image_gather"):
        cache, idx = args[0], args[3].long()
        return lambda: torch.index_select(cache, 0, idx.long())
    if key.startswith(("prepare_b", "fill_b")):
        images = args[0]
        dtype = torch.int64 if images.dtype == torch.uint8 else torch.float64
        return lambda: torch.sum(images, dim=(1, 2), dtype=dtype)
    return None


def fills_close(torch, got, want):
    """uint8 fills bitwise, float32 within 1 float32 ulp."""
    ulp = torch.from_numpy(np.spacing(want.abs().cpu().numpy())).to(want.device)
    return bool(((got - want).abs() <= ulp).all())


def check_plain(torch, cs, key, kind, args, out):
    """The committed source's output against the plain version."""
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.ops import image as I

    err = 0.0
    with ops.reference_scope():
        if kind == "resize":
            want = I.resize_batch_with_boxes(*args)
            ok = all(cs.bitwise(torch, g, w_) for g, w_ in zip(out, want))
            err = 0.0 if ok else float((out[0].float() - want[0].float()).abs().max())
        elif kind == "image":
            images, geom, _, idx = args
            batch = images[idx.long()] if idx is not None else images
            err, ok = cs.image_errors(torch, out, I.augment_images_plain(batch, geom))
        elif kind == "geometry":
            boxes, labels, mask, n, h, w, kw = args
            dummy = torch.zeros(n, h, w, 3, dtype=torch.uint8, device=boxes.device)
            want = I.augment_prepare_plain(dummy, boxes, labels, mask, **kw)[:4]
            ok = all(cs.bitwise(torch, g, w_) for g, w_ in zip(out, want) if g is not None)
        elif kind == "fill":
            images, geom, idx = args
            want = I.image_fills_plain(images[idx.long()] if idx is not None else images, geom)
            err, ok = float((out - want).abs().max()), fills_close(torch, out, want)
        else:  # prepare, materialize
            images, boxes, labels, mask, kw = args
            want = I.augment_prepare_plain(images, boxes, labels, mask, **kw)
            if kind == "prepare":
                ok = all(cs.bitwise(torch, g, w_) for g, w_ in zip(out[:4], want[:4]))
                ok = ok and fills_close(torch, out[4], want[4])
                err = float((out[4] - want[4]).abs().max())
            else:
                idx = kw.get("idx")
                batch = images[idx.long()] if idx is not None else images
                err, ok = cs.image_errors(torch, out[0], I.augment_images_plain(batch, want[3]))
                ok = ok and all(cs.bitwise(torch, g, w_) for g, w_ in zip(out[1:], want[:3]))
    if kind == "image":
        lib = library_call(torch, key, args)
        if lib is not None:
            ok = ok and cs.bitwise(torch, out, lib())
    if not ok:
        raise AssertionError(f"{key}: committed source != plain version (max error {err})")
    return err


def kernel_ms(torch, fn, reps=20):
    """Device ms per call of each data-path kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    pattern = "|".join(KERNELS)
    for ev in prof.key_averages():
        found = re.search(pattern, ev.key)
        if found:
            dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            out[found.group()] = out.get(found.group(), 0.0) + dev_us / 1e3 / reps
    return out


def run_source(torch, cs, calls, cases, check=False):
    """Each case through ``calls``: outputs (cloned), times, the main-path
    cases' profiler times; ``check`` holds them against the plain versions
    and times the library call of the pure-copy cases."""
    times, outs = {}, {}
    for key, (kind, args) in cases.items():
        def run(kind=kind, args=args):
            return calls[kind](*args)

        out = run()
        outs[key] = [o.clone() for o in (out if isinstance(out, tuple) else (out,))
                     if o is not None]
        times[key] = {"ms": cs.time_ms(torch, run, 20)}
        if key in MAIN_CASES:
            times[key]["kernels"] = kernel_ms(torch, run)
        if check:
            times[key]["max_abs_err"] = check_plain(torch, cs, key, kind, args, out)
            lib = library_call(torch, key, args)
            if lib is not None:
                times[key]["library_ms"] = cs.time_ms(torch, lib, 20)
    torch.cuda.synchronize()
    return times, outs


def same_outputs(torch, cs, outs, ref):
    """{case: equal} of one source's outputs against the reference's: bit for
    bit, but float32 fills within 1 ulp and float32 images of the
    materialize chain within ``chip_smoke.image_errors`` (its fill pixels
    carry the fills)."""
    def same(key, a, b):
        if a.dtype == torch.float32 and tuple(a.shape[-2:]) == (2, 3):  # fills
            return fills_close(torch, a, b)
        if a.dtype == torch.float32 and key.startswith("materialize") and a.dim() == 4:
            return cs.image_errors(torch, a, b)[1]
        return cs.bitwise(torch, a, b)

    return {k: all(same(k, a, b) for a, b in zip(outs[k], ref[k])) for k in ref}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-design", metavar="PATH", help="the first design's source")
    ap.add_argument("--only", nargs="*", help="run only these variants")
    ap.add_argument("--out", metavar="DIR", help="where results.json goes")
    ap.add_argument("--edits-only", action="store_true",
                    help="check that every edit applies to the source, then stop")
    args = ap.parse_args()
    base = SOURCE.read_text()
    variants = {k: v for k, v in VARIANTS.items() if args.only is None or k in args.only}
    texts = {"committed": base}
    texts.update({k: edited(base, edits) for k, (_, edits) in variants.items() if edits})
    if args.edits_only:
        print(json.dumps({"edits_apply": sorted(texts)}))
        return 0

    import torch

    import chip_smoke as cs
    from replication_faster_rcnn_tpu_torch.ops.cuda import build
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel as K

    if not torch.cuda.is_available():
        print("image_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"card: {card}")
    if args.first_design:
        texts["first_design"] = Path(args.first_design).read_text()
    libs = compile_all(build, texts)
    for name, (_, report) in libs.items():
        for kernel, props in report:
            cs.log(f"ptxas {name}: {kernel}: {props}")
    dev = torch.empty(0, device="cuda").device  # with its index, as the wrappers compare
    committed_lib = K.bind(libs["committed"][0])
    K._fns = committed_lib
    cases = make_cases(torch, cs, K, dev)
    results = {"card": card, "defaults": DEFAULTS, "variants": variants, "times": {},
               "bitwise_vs_committed": {},
               "ptxas": {name: entry[1] for name, entry in libs.items()}}
    first = first_design_calls(torch, K, libs["first_design"][0]) if args.first_design else None
    if first:
        cs.log("[first design]")
        results["times"]["first_design"], first_out = run_source(torch, cs, first, cases)
    cs.log("[committed source]")
    committed = wrapper_calls(torch, K, committed_lib, {})
    results["times"]["committed"], ref = run_source(torch, cs, committed, cases, check=True)
    if first:
        results["bitwise_vs_committed"]["first_design"] = same_outputs(torch, cs, first_out, ref)
        results["bitwise_vs_committed"]["committed_vs_first_design"] = same_outputs(
            torch, cs, ref, first_out)
        cs.log(f"  first design bitwise vs committed: "
               f"{results['bitwise_vs_committed']['first_design']}")
    for name, (settings, edits) in variants.items():
        cs.log(f"[{name}] {settings} {len(edits)} edit(s)")
        lib = K.bind(libs[name][0]) if edits else committed_lib
        try:
            results["times"][name], outs = run_source(
                torch, cs, wrapper_calls(torch, K, lib, settings), cases)
            results["bitwise_vs_committed"][name] = same_outputs(torch, cs, outs, ref)
        except (AssertionError, RuntimeError, ValueError) as e:
            results["times"][name] = {"failed": str(e)[:300]}
            cs.log(f"  {name} failed: {e}")
    cs.log("[committed source, again]")
    results["times"]["committed_again"], _ = run_source(torch, cs, committed, cases)
    if first:
        cs.log("[first design, again]")
        results["times"]["first_design_again"], _ = run_source(torch, cs, first, cases)
    apply_settings(torch, K, {})
    K._fns = None
    failed = [f"{name}: {case}" for name, rows in results["bitwise_vs_committed"].items()
              for case, same in rows.items() if not same]
    results["all_bitwise"] = not failed
    for name, rows in results["times"].items():
        if "failed" in rows:
            continue
        cs.log(f"{name:20s} " + " | ".join(f"{k} {v['ms']:.4f}" for k, v in rows.items()))
    if failed:
        cs.log(f"NOT BITWISE: {failed}")
    out_dir = Path(args.out) if args.out else build.BUILD_DIR.parent / "image_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "results.json").write_text(json.dumps(results))
    print(json.dumps(results))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
