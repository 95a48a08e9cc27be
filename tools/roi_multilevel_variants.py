#!/usr/bin/env python3
"""Time source variants of the PyTorch port's multi-level ROIAlign kernels
(the FPN's, forward and backward) on the card.

Run from the repository root on a machine with an NVIDIA H100:
``python tools/roi_multilevel_variants.py [--only NAME ...] [--first-design PATH]``
(``--edits-only`` checks on any machine that every edit still applies to
the source, and stops).

Sources: the port's ``replication_faster_rcnn_tpu_torch/csrc/roi_align_kernel.cu``
("committed"), the same with ``tools/roi_multilevel_staged.cu`` spliced in
("staged": the staged forward design, which measured slower) and each entry of
``VARIANTS``: one of the two with the edits listed (the backward's tile
size and register cap, the forward's, the staged kernel's ring depth and
channel tile). Each is compiled with the port's nvcc flags into
``build/roi_multilevel_variants/`` and swapped into the wrapper. The
committed source runs ``chip_smoke.py``'s [3] multi-level checks on
``chip_smoke.multilevel_cases`` (forward bitwise against the plain
version, backward within ``ROI_BWD_TOL`` of the plain VJP, twice bitwise);
every other source's outputs are held bit for bit against the committed
source's, and its backward launched twice. ``--first-design PATH`` adds the first
design's source (``git show
7f3ed20:replication_faster_rcnn_tpu_torch/csrc/roi_align_kernel.cu``; its
backward takes no scratch), held bit for bit against the committed one in
both directions and timed as the others. Order: the first design, the
committed source, the variants, the committed source again, the first
design again; all in one process on one card. Times are device ms per
call (CUDA events behind a device sleep, ``chip_smoke.time_ms``) and, for
the main-path cases, per kernel from ``torch.profiler``. The last line of
standard output is one JSON object with every result but the ptxas
reports; ``results.json`` in ``--out`` (default
``build/roi_multilevel_variants/``) holds them too.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = REPO / "replication_faster_rcnn_tpu_torch" / "csrc" / "roi_align_kernel.cu"
STAGED = REPO / "tools" / "roi_multilevel_staged.cu"


def _const(name, old, new, kind="int"):
    return [(f"constexpr {kind} {name} = {old};", f"constexpr {kind} {name} = {new};")]


def staged_source(src):
    """The committed source with the staged forward spliced in: its kernel
    before sm_count(), and s = 2 vector calls routed to it."""
    return edited(src, [
        ("int sm_count() {", STAGED.read_text() + "\nint sm_count() {"),
        ("  for (int l = 0; l < LEVELS; ++l) vec = vec && aligned(feats[l], 16);\n"
         "  const int warps = ML_FWD_THREADS / 32;",
         "  for (int l = 0; l < LEVELS; ++l) vec = vec && aligned(feats[l], 16);\n"
         "  if (vec && s == 2) {\n"
         "    return launch_staged<T, O>(pyr, rois, levels, n_rois, c, r, img_h, img_w, out, dst,\n"
         "                               stream);\n"
         "  }\n"
         "  const int warps = ML_FWD_THREADS / 32;"),
    ])


# name -> (source, [(old, new)]), each old string found exactly once in the source
VARIANTS = {
    "ct_128": ("committed", _const("ML_CT", 256, 128)),
    "fine_first": ("committed", _const("ML_COARSE_FIRST", "true", "false", "bool")),
    "tile_2x4": ("committed", _const("ML_TILE_Y", 4, 2) + _const("ML_TILE_X", 8, 4)),
    "tile_4x4": ("committed", _const("ML_TILE_X", 8, 4)),
    "tile_8x8": ("committed", _const("ML_TILE_Y", 4, 8)),
    "bwd_min_blocks_4": ("committed", _const("ML_BWD_MIN_BLOCKS", 3, 4)),
    "bwd_min_blocks_2": ("committed", _const("ML_BWD_MIN_BLOCKS", 3, 2)),
    "fwd_min_blocks_2": ("committed", _const("ML_FWD_MIN_BLOCKS", 3, 2)),
    "staged_ct_64": ("staged", _const("MLF_CT", 32, 64) + _const("MLF_THREADS", 32, 64)),
}
MAIN_CASES = ("serve_b8_bf16", "serve_b1_bf16", "train_b8_bf16", "bwd_bf16")


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def multilevel_ptxas(log):
    """(kernel, properties) of each multi-level entry function in a
    ``-Xptxas -v`` report, names demangled where c++filt is found."""
    try:
        log = subprocess.run(["c++filt"], input=log, capture_output=True, text=True).stdout or log
    except OSError:
        pass
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "multilevel" in ln:
            props = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "stack frame" in x or "registers" in x)
            out.append([ln.split("'")[1], props])
    return out


def compile_all(build, texts):
    """nvcc every source at once; {name: (library, ptxas entries)}."""
    out_dir = build.BUILD_DIR.parent / "roi_multilevel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                              str(cu)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
        return name, (ctypes.CDLL(str(cu.with_suffix(".so"))),
                      multilevel_ptxas(res.stdout + res.stderr))

    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        return dict(pool.map(one, texts.items()))


def bind(lib, first_design=False):
    """The wrapper's function tuple from a library (the first design's
    backward takes no scratch and it has no scratch-size function)."""
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.roi_align_fwd.argtypes = [p, i, p, i, i, i, i, i, i, i, p, i, i, p]
    lib.roi_align_bwd.argtypes = [p, i, p, i, i, i, i, i, i, i, p, i, p]
    lib.roi_align_error_string.argtypes = [i]
    lib.roi_align_error_string.restype = ctypes.c_char_p
    lib.multilevel_roi_align_fwd.argtypes = [p, p, p, i, p, p, i, i, i, f, f, i, i, p, i, p]
    bwd = [p, i, p, p, i, p, p, i, i, f, f, i, i, p, i, p]
    lib.multilevel_roi_align_bwd.argtypes = bwd if first_design else bwd + [p]
    for fn in (lib.roi_align_fwd, lib.roi_align_bwd, lib.multilevel_roi_align_fwd,
               lib.multilevel_roi_align_bwd):
        fn.restype = i
    if first_design:
        return lib
    lib.multilevel_roi_align_bwd_scratch.argtypes = [i, p, p, i]
    lib.multilevel_roi_align_bwd_scratch.restype = ctypes.c_longlong
    return (lib.roi_align_fwd, lib.roi_align_bwd, lib.roi_align_error_string,
            lib.multilevel_roi_align_fwd, lib.multilevel_roi_align_bwd,
            lib.multilevel_roi_align_bwd_scratch)


def first_design_calls(torch, roi_kernel, lib):
    """The first design's forward and backward through its own C interface,
    called as the wrapper called them."""
    flag = {torch.float32: 0, torch.bfloat16: 1}

    def forward(feats, rois, levels, out_dtype):
        n, c, r = feats[0].shape[0], feats[0].shape[-1], rois.shape[1]
        out = torch.empty(n, r, 7, 7, c, dtype=out_dtype, device=rois.device)
        hs, ws = roi_kernel._levels_arrays([f.shape for f in feats])
        rc = lib.multilevel_roi_align_fwd(
            roi_kernel._pointers(feats), hs, ws, flag[feats[0].dtype], rois.data_ptr(),
            levels.data_ptr(), n, c, r, 600.0, 600.0, 7, 2, out.data_ptr(), flag[out_dtype],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"first design forward: CUDA error {rc}")
        return out

    def backward(grad_out, rois, levels, shapes, dtype):
        grads = [torch.empty(sh, dtype=dtype, device=rois.device) for sh in shapes]
        hs, ws = roi_kernel._levels_arrays(shapes)
        n, c, r = shapes[0][0], shapes[0][-1], rois.shape[1]
        rc = lib.multilevel_roi_align_bwd(
            grad_out.data_ptr(), flag[grad_out.dtype], rois.data_ptr(), levels.data_ptr(), n, hs,
            ws, c, r, 600.0, 600.0, 7, 2, roi_kernel._pointers(grads), flag[dtype],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"first design backward: CUDA error {rc}")
        return grads

    return forward, backward


def kernel_ms(torch, fn, reps=20):
    """Device ms per call of each kernel and copy ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        found = re.search(r"multilevel\w*|[Mm]emset\w*", ev.key)
        if found:
            dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            out[found.group()] = out.get(found.group(), 0.0) + dev_us / 1e3 / reps
    return out


def run_source(torch, cs, calls, fwd_cases, bwd_cases, check=False):
    """Each case through ``calls`` = (forward, backward): outputs, times and
    (for the main-path cases) the profiler's per-kernel times; the backward
    launched twice and held bitwise. ``check`` also runs chip_smoke's [3]
    checks against the plain versions."""
    from replication_faster_rcnn_tpu_torch.models.fpn import roi_levels

    forward, backward = calls
    times, outs = {}, {}
    for key, (label, feats, rois, out_dtype) in fwd_cases.items():
        if check:
            cs.check_multilevel(torch, label, feats, rois, out_dtype)
        levels = roi_levels(rois)
        run = lambda: forward(feats, rois, levels, out_dtype)  # noqa: E731
        outs[key] = run()
        times[key] = {"ms": cs.time_ms(torch, run, 20)}
        if key in MAIN_CASES:
            times[key]["kernels"] = kernel_ms(torch, run)
    for key, (label, g, feats, rois) in bwd_cases.items():
        if check:
            cs.check_multilevel_bwd(torch, label, g, feats, rois)
        levels = roi_levels(rois)
        shapes = [tuple(f.shape) for f in feats]
        run = lambda: backward(g, rois, levels, shapes, feats[0].dtype)  # noqa: E731
        outs[key], again = run(), run()
        if not all(bitwise(torch, a, b) for a, b in zip(outs[key], again)):
            raise AssertionError(f"{key}: two backward launches differ")
        times[key] = {"ms": cs.time_ms(torch, run, 10)}
        if key in MAIN_CASES:
            times[key]["kernels"] = kernel_ms(torch, run, 10)
    torch.cuda.synchronize()
    return times, outs


def bitwise(torch, a, b):
    bits = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.shape == b.shape and bool(torch.equal(a.view(bits), b.view(bits)))


def same_outputs(torch, outs, ref):
    """{case: bitwise} of one source's outputs against the reference's."""
    def equal(a, b):
        if isinstance(a, list):
            return all(bitwise(torch, x, y) for x, y in zip(a, b))
        return bitwise(torch, a, b)

    return {k: equal(outs[k], ref[k]) for k in ref}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edits-only", action="store_true",
                    help="check that every edit applies to the source, then stop")
    ap.add_argument("--only", nargs="*", help="run only these variants (and the committed source)")
    ap.add_argument("--first-design", metavar="PATH", help="the first design's source")
    ap.add_argument("--out", metavar="DIR", help="where results.json goes")
    args = ap.parse_args()
    base = SOURCE.read_text()
    srcs = {"committed": base, "staged": staged_source(base)}
    texts = {name: edited(srcs[base], e) for name, (base, e) in VARIANTS.items()
             if args.only is None or name in args.only}
    if args.edits_only:
        print(json.dumps({"edits_apply": sorted(texts)}))
        return 0

    import torch

    import chip_smoke as cs
    from replication_faster_rcnn_tpu_torch.ops.cuda import build, roi_kernel

    if not torch.cuda.is_available():
        print("roi_multilevel_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"card: {card}")
    texts.update(srcs)
    if args.first_design:
        texts["first_design"] = Path(args.first_design).read_text()
    libs = compile_all(build, texts)
    dev = torch.device("cuda")
    fwd_cases, bwd_cases, _ = cs.multilevel_cases(torch, dev)

    def wrapper_calls(fns):
        """The wrapper's forward and backward on the library ``fns``."""
        def forward(feats, rois, levels, out_dtype):
            roi_kernel._fns = fns
            return roi_kernel._multilevel_forward_cuda(feats, rois, levels, 600.0, 600.0, 7, 2,
                                                       out_dtype)

        def backward(g, rois, levels, shapes, dtype):
            roi_kernel._fns = fns
            return roi_kernel.multilevel_roi_align_backward_cuda(g, rois, levels, shapes, dtype,
                                                                 600.0, 600.0, 7, 2)

        return forward, backward

    results = {"card": card, "times": {}, "bitwise_vs_committed": {},
               "ptxas": {name: entry[1] for name, entry in libs.items()}}
    first = None
    if args.first_design:
        first = first_design_calls(torch, roi_kernel, bind(libs["first_design"][0], True))
    if first:
        cs.log("[first design]")
        results["times"]["first_design"], first_out = run_source(torch, cs, first, fwd_cases, bwd_cases)
    cs.log("[committed source]")
    committed_fns = bind(libs["committed"][0])
    committed = wrapper_calls(committed_fns)
    roi_kernel._fns = committed_fns  # chip_smoke's checks call the wrapper
    results["times"]["committed"], ref = run_source(torch, cs, committed, fwd_cases, bwd_cases,
                                                    check=True)
    if first:
        results["bitwise_vs_committed"]["first_design"] = same_outputs(torch, first_out, ref)
        cs.log(f"  first design bitwise vs committed: {results['bitwise_vs_committed']['first_design']}")
    for name in texts:
        if name in ("committed", "first_design"):
            continue
        cs.log(f"[{name}]")
        try:
            results["times"][name], outs = run_source(
                torch, cs, wrapper_calls(bind(libs[name][0])), fwd_cases, bwd_cases)
            results["bitwise_vs_committed"][name] = same_outputs(torch, outs, ref)
        except (AssertionError, RuntimeError, ValueError) as e:
            results["times"][name] = {"failed": str(e)[:300]}
            cs.log(f"  {name} failed: {e}")
    cs.log("[committed source, again]")
    results["times"]["committed_again"], _ = run_source(torch, cs, committed, fwd_cases,
                                                        bwd_cases)
    if first:
        cs.log("[first design, again]")
        results["times"]["first_design_again"], _ = run_source(torch, cs, first, fwd_cases, bwd_cases)
    roi_kernel._fns = None
    for name, rows in results["times"].items():
        if "failed" in rows:
            continue
        cs.log(f"{name:18s} " + " | ".join(f"{k} {v['ms']:.4f}" for k, v in rows.items()))
    out_dir = Path(args.out) if args.out else build.BUILD_DIR.parent / "roi_multilevel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "results.json").write_text(json.dumps(results))
    print(json.dumps({k: v for k, v in results.items() if k != "ptxas"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
