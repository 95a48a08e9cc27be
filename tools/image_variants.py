#!/usr/bin/env python3
"""Time designs of the PyTorch port's data-path image kernels (the bucket
resize ``resize_aa_kernel`` and the augmentation / cache-gather pass
``augment_image_kernel``) on the card.

Run from the repository root on a machine with an NVIDIA H100:
``python tools/image_variants.py [--first-design PATH] [--only NAME ...]``
(``--edits-only`` checks on any machine that every edit still applies to
the source, and stops), where PATH holds the first design's source (``git show
68dca63:replication_faster_rcnn_tpu_torch/csrc/image_kernel.cu``: one
thread per output element and one launch per resized axis).

The committed source (``replication_faster_rcnn_tpu_torch/csrc/
image_kernel.cu``) and the first design are compiled with the port's nvcc
flags into ``build/image_variants/``; each ``-Xptxas -v`` report of the two
kernels (registers, stack frame, spills) is printed. Cases: ``chip_smoke.py``
[3]'s at 600x600, b8 and b16, uint8 and float32: the resize to 480, 720 and
240; the image pass on [3]'s four row mixes (aug draws), the cache gather
(b8 from a 1,024-image cache, flip + jitter), every row flipped (against
``torch.flip``) and the identity gather (against ``torch.index_select``).
The committed source's outputs are held against the plain versions
(``ops/image.py``: the resize and uint8 bitwise, float32 within
``chip_smoke.image_errors``), the first design's bit for bit against the
committed source's in both directions (each side's output is the other's
reference). The variants are the committed source under other launch
settings (``VARIANTS``: the resize's tile and threads, the image pass's
column tile, and by dtype its rows a block and pixels per thread) or
with source edits, each held bit for bit against it.
Order: the first design, the committed source, the variants, the committed
source again, the first design again; all in one process on one card.
Times are device ms per call (CUDA events behind a device sleep,
``chip_smoke.time_ms``) and, for the main-path cases, per kernel from
``torch.profiler``. The last line of standard output is one JSON object
with every result; ``results.json`` in ``--out`` (default
``build/image_variants/``) holds it too.
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
            "IMAGE_PIXELS_PER_THREAD": {U8: 8, F32: 2}}
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
}
MAIN_CASES = ("resize_b8_uint8_480", "resize_b8_uint8_720", "image_b8_uint8_flip+translate+scale",
              "image_cache_b8_uint8")
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
        if "Compiling entry function" in ln and ("resize_aa" in ln or "augment_image" in ln):
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
    """The first design's resize (one launch per resized axis, a float32
    intermediate in device memory) and image pass through its own C
    interface, called as its wrapper called them."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.augment_image_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
    lib.resize_aa_launch.argtypes = [p, i, p, i, p, p, i, ll, i, i, ll, p, p, ll, f, f, p]
    lib.augment_image_launch.restype = lib.resize_aa_launch.restype = i

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def image(images, geom, fills, idx=None):
        n, h, w = geom.shape[0], images.shape[1], images.shape[2]
        out = torch.empty((n, h, w, 3), dtype=images.dtype, device=images.device)
        rc = lib.augment_image_launch(images.data_ptr(), K._ptr(idx), geom.data_ptr(),
                                      K._ptr(fills), n, h, w, K._image_kind(images),
                                      out.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"first design image pass: CUDA error {rc}")
        return out

    def resize(images, boxes, out_hw):
        kind = K._image_kind(images)
        n, ih, iw, c = images.shape
        h, w = out_hw
        sy, sx = float(np.float32(h / ih)), float(np.float32(w / iw))
        passes = ([("rows", ih, h)] if ih != h else []) + ([("cols", iw, w)] if iw != w else [])
        out_boxes = torch.empty_like(boxes)
        x, x_kind, rows = images, kind, ih
        for k, (axis, n_in, n_out) in enumerate(passes):
            last = k == len(passes) - 1
            start, weight = K.band_tables(n_in, n_out, images.device)
            if axis == "rows":
                outer, inner, shape = n, iw * c, (n, n_out, iw, c)
                rows = n_out
            else:
                outer, inner, shape = n * rows, c, (n, rows, n_out, c)
            out_kind = kind if last else 0
            y = torch.empty(shape, dtype=torch.uint8 if out_kind else torch.float32,
                            device=images.device)
            rc = lib.resize_aa_launch(
                x.data_ptr(), x_kind, y.data_ptr(), out_kind, start.data_ptr(),
                weight.data_ptr(), weight.shape[1], outer, n_in, n_out, inner,
                boxes.data_ptr() if last else None, out_boxes.data_ptr() if last else None,
                boxes.numel() if last else 0, sy, sx, stream())
            if rc:
                raise RuntimeError(f"first design resize: CUDA error {rc}")
            x, x_kind = y, out_kind
        return x, out_boxes

    return {"image": image, "resize": resize}


def apply_settings(torch, K, settings):
    """The wrapper's launch settings: DEFAULTS updated by ``settings``."""
    for key, value in {**DEFAULTS, **settings}.items():
        if isinstance(value, dict):  # by dtype
            value = {getattr(torch, k): v for k, v in value.items()}
        setattr(K, key, value)


def wrapper_calls(torch, K, lib, settings):
    """The committed wrapper on ``lib`` under the launch ``settings``."""
    def use():
        K._fns = lib
        apply_settings(torch, K, settings)

    def image(images, geom, fills, idx=None):
        use()
        return K.augment_image_cuda(images, geom, fills, idx)

    def resize(images, boxes, out_hw):
        use()
        return K.resize_aa_cuda(images, boxes, out_hw)

    return {"image": image, "resize": resize}


def make_cases(torch, cs, K, dev):
    """{key: (kind, args)}: [3]'s resize and image-pass inputs (the
    geometry rows and fills from the committed geometry and fill kernels)."""
    rng = np.random.default_rng(21)
    cases = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

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
            for mode, kw in cs.AUG_MODES:
                *_, geom, _ = K.augment_geometry_cuda(None, None, None, b, H, W, aug=aug,
                                                      seed=cs.AUG_SEED, **kw)
                fills = K.image_fill_cuda(images, geom)
                cases[f"image_b{b}_{dtype}_{mode}"] = ("image", (images, geom, fills, None))
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
            idx = t(rng.choice(m, b, replace=False).astype(np.int32))
            scale = rng.uniform(0.75, 1.25, b)
            ch = np.rint(H * scale).astype(np.int32)
            jitter = np.stack([ch, ch, np.rint((ch - H) * rng.uniform(0, 1, b)),
                               np.rint((ch - W) * rng.uniform(0, 1, b))], -1).astype(np.int32)
            jitter[0] = [H, W, 0, 0]
            *_, geom, _ = K.augment_geometry_cuda(
                None, None, None, b, H, W, idx=idx, flip=t(rng.uniform(size=b) < 0.5),
                jitter=t(jitter), resample="all", device=dev)
            fills = K.image_fill_cuda(cache, geom, idx)
            cases[f"image_cache_b8_{dtype}"] = ("image", (cache, geom, fills, idx))
            *_, geom, _ = K.augment_geometry_cuda(None, None, None, b, H, W, idx=idx, device=dev)
            cases[f"image_gather_b8_{dtype}"] = ("image", (cache, geom, None, idx))
    return cases


def library_call(torch, key, args):
    """The one PyTorch call that computes a pure-copy case, or None."""
    if key.startswith("image_allflip"):
        images = args[0]
        return lambda: torch.flip(images, [2])
    if key.startswith("image_gather"):
        cache, idx = args[0], args[3].long()
        return lambda: torch.index_select(cache, 0, idx)
    return None


def check_plain(torch, cs, key, kind, args, out):
    """The committed source's output against the plain version."""
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.ops import image as I

    with ops.reference_scope():
        if kind == "resize":
            want = I.resize_batch_with_boxes(*args)
            ok = all(cs.bitwise(torch, g, w_) for g, w_ in zip(out, want))
            err = 0.0 if ok else float((out[0].float() - want[0].float()).abs().max())
        else:
            images, geom, _, idx = args
            batch = images[idx.long()] if idx is not None else images
            err, ok = cs.image_errors(torch, out, I.augment_images_plain(batch, geom))
    lib = library_call(torch, key, args)
    if lib is not None:
        ok = ok and cs.bitwise(torch, out, lib())
    if not ok:
        raise AssertionError(f"{key}: committed source != plain version (max error {err})")
    return err


def kernel_ms(torch, fn, reps=20):
    """Device ms per call of each resize / image kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        found = re.search(r"resize_aa_kernel|augment_image_kernel", ev.key)
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
        outs[key] = [o.clone() for o in (out if isinstance(out, tuple) else (out,))]
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
    """{case: bitwise} of one source's outputs against the reference's."""
    return {k: all(cs.bitwise(torch, a, b) for a, b in zip(outs[k], ref[k])) for k in ref}


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
