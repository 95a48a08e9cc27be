#!/usr/bin/env python3
"""Time source variants of the PyTorch port's ROIPool kernels on the card.

Run from the repository root on a machine with an NVIDIA H100:
``python tools/roi_pool_variants.py [--only NAME ...] [--pr8 PATH]``
(``--edits-only`` checks on any machine that every edit still applies to
its source, and stops).

Sources: the port's ``replication_faster_rcnn_tpu_torch/csrc/roi_pool_kernel.cu``
("committed") and ``tools/roi_pool_staged.cu`` ("staged", the staged-row
design with the same C interface and scratch), and each entry of
``VARIANTS``: one of the two with the edits listed. Each is compiled with
the port's nvcc flags into ``build/roi_pool_variants/`` and swapped into
the wrapper, then runs ``chip_smoke.py``'s ROIPool checks at [3]'s shapes
(forward bitwise against the plain masked maxes, backward within
``ROI_POOL_BWD`` of the plain VJP and bitwise across two launches), and its
outputs are held bit for bit against the committed source's. ``--pr8 PATH``
also holds the committed backward bit for bit against that source (the first
design's C interface, with two float32 scratch arrays; ``git show
d96a629:replication_faster_rcnn_tpu_torch/csrc/roi_pool_kernel.cu``). The
committed source runs first and last, the others in turn between, all in
one process on one card. Times are device ms per call (CUDA events behind a
device sleep, ``chip_smoke.time_ms``) and, per kernel, from
``torch.profiler``. The last line of standard output is one JSON object with
every result; it is also written to ``build/roi_pool_variants/results.json``.
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

SOURCES = {
    "committed": REPO / "replication_faster_rcnn_tpu_torch" / "csrc" / "roi_pool_kernel.cu",
    "staged": REPO / "tools" / "roi_pool_staged.cu",
}


def _const(name, old, new):
    return [(f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")]


_SMEM_100K = [("constexpr int POOL_SMEM = 56 * 1024;", "constexpr int POOL_SMEM = 100 * 1024;")]

# name -> (source, [(old, new)]), each old string found exactly once in the source
VARIANTS = {
    "f32_loads_2": ("committed", _const("FWD_LOADS_F32", 4, 2)),
    "f32_loads_8": ("committed", _const("FWD_LOADS_F32", 4, 8)),
    "staged_threads_256": ("staged", _const("POOL_THREADS", 128, 256)),
    "staged_ct_64": ("staged", _const("POOL_CT", 128, 64)),
    "staged_ct_256": ("staged", _const("POOL_CT", 128, 256) + _SMEM_100K),
    "staged_ring_32": ("staged", _const("POOL_RING", 64, 32)),
    "staged_ring_128": ("staged", _const("POOL_RING", 64, 128)),
    "staged_ring_256": ("staged", _const("POOL_RING", 64, 256) + _SMEM_100K),
    "staged_row_bins_1": ("staged", _const("POOL_ROW_BINS", 7, 1)),
    "staged_row_bins_2": ("staged", _const("POOL_ROW_BINS", 7, 2)),
    "staged_gather_slabs_8": ("staged", _const("GATHER_SLABS", 12, 8)),
    "staged_gather_slabs_16": ("staged", _const("GATHER_SLABS", 12, 16)),
    "staged_gather_ct_32": ("staged", _const("GATHER_CT", 64, 32)),
}


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def compile_all(build, texts):
    """nvcc every source at once; {name: (library, ptxas lines)}."""
    out_dir = build.BUILD_DIR.parent / "roi_pool_variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                              str(cu)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
        ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]
        return name, (ctypes.CDLL(str(cu.with_suffix(".so"))), ptxas)

    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        return dict(pool.map(one, texts.items()))


def bind(lib):
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.roi_pool_fwd.argtypes = [p, i, p, i, i, i, i, i, i, p, p]
    lib.roi_pool_bwd.argtypes = [p, i, p, i, p, i, i, i, i, i, i, p, p, p, p]
    lib.roi_pool_fwd.restype = lib.roi_pool_bwd.restype = i
    lib.roi_pool_error_string.argtypes = [i]
    lib.roi_pool_error_string.restype = ctypes.c_char_p
    return lib.roi_pool_fwd, lib.roi_pool_bwd, lib.roi_pool_error_string


def pr8_backward(torch, bwd, grad_out, feat, rois):
    """The first design's backward: the same call with two float32 scratch arrays."""
    n, h, w, c = feat.shape
    grad = torch.empty_like(feat)
    m = torch.empty(grad_out.shape, dtype=torch.float32, device=feat.device)
    a = torch.empty_like(m)
    flag = {torch.float32: 0, torch.bfloat16: 1}
    rc = bwd(feat.data_ptr(), flag[feat.dtype], grad_out.data_ptr(), flag[grad_out.dtype],
             rois.data_ptr(), n, h, w, c, rois.shape[1], 7, m.data_ptr(), a.data_ptr(),
             grad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"PR 8 backward: CUDA error {rc}")
    return grad


def cases(torch, cs, dev):
    """chip_smoke.py [3]'s ROIPool inputs, drawn the same way."""
    rng = np.random.default_rng(8)
    bf16, b = torch.bfloat16, 8

    def boxes(r):
        rois = torch.from_numpy(cs.rand_boxes(rng, (b, r), 600, 300) * (cs.FEAT[0] / 600)).to(dev)
        rois[:, :5] = torch.tensor([[-0.9, -0.9, 3.0, 3.0], [35.0, 34.0, 40.0, 41.0],
                                    [2.2, 2.2, 2.2, 2.2], [-5.0, -5.0, -2.0, -1.5],
                                    [float("nan"), 3.0, 9.0, 9.0]], device=dev)
        return rois

    feat = torch.from_numpy(rng.normal(0, 1, (b,) + cs.FEAT).astype(np.float32)).to(dev)
    ties = torch.from_numpy(rng.integers(-3, 4, (b,) + cs.FEAT).astype(np.float32)).to(dev)
    bad = feat.clone()
    for value in (float("nan"), float("inf"), float("-inf")):
        flat = torch.from_numpy(rng.integers(0, bad.numel(), 24)).to(dev)
        bad.view(-1)[flat] = value
    rois, trois = boxes(300), boxes(128)
    g = torch.from_numpy(rng.normal(0, 1, (b, 128, 7, 7, cs.FEAT[2])).astype(np.float32)).to(dev)
    same = torch.tensor([5.3, 7.1, 30.2, 33.9], device=dev).expand(b, 128, 4).contiguous()
    crois = torch.from_numpy(cs.clustered_boxes(rng, b, 128) * (cs.FEAT[0] / 600)).to(dev)
    fb, tb = feat.to(bf16), ties.to(bf16)
    fwd = {"b8 bf16": (fb, rois), "b8 f32": (feat, rois), "b1 bf16": (fb[:1], rois[:1].contiguous()),
           "8x128 bf16": (fb, trois), "ties bf16": (tb, rois), "nonfinite f32": (bad, rois),
           "clustered bf16": (fb, crois)}
    bwd = {"bf16": (g.to(bf16), fb, trois), "f32": (g, feat, trois), "ties f32": (g, ties, trois),
           "ties bf16": (g.to(bf16), tb, trois), "nonfinite f32": (g, bad, trois),
           "identical bf16": (g.to(bf16), fb, same), "clustered bf16": (g.to(bf16), fb, crois)}
    return fwd, bwd


def kernel_ms(torch, fn, reps=20):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        found = re.search(r"roi_pool\w*", ev.key)
        if found:
            dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            out[found.group()] = out.get(found.group(), 0.0) + dev_us / 1e3 / reps
    return out


def run_source(torch, cs, roi_kernel, fwd_cases, bwd_cases):
    """[3]'s checks with the wrapper's current library: times and outputs."""
    times, outs = {}, {}
    for name, (feat, rois) in fwd_cases.items():
        res = cs.check_roi_pool(torch, f"fwd {name}", feat, rois)
        outs[f"fwd {name}"] = roi_kernel.roi_pool_cuda(feat, rois, 7)
        times[f"fwd {name}"] = {"ms": res["ms"], "kernels": kernel_ms(
            torch, lambda: roi_kernel.roi_pool_cuda(feat, rois, 7))}
    for name, (g, feat, rois) in bwd_cases.items():
        res = cs.check_roi_pool_bwd(torch, f"bwd {name}", g, feat, rois)
        outs[f"bwd {name}"] = roi_kernel.roi_pool_backward_cuda(g, feat, rois, 7)
        times[f"bwd {name}"] = {"ms": res["ms"], "scratch_bytes": res["scratch_bytes"],
                                "kernels": kernel_ms(torch, lambda: roi_kernel.roi_pool_backward_cuda(
                                    g, feat, rois, 7))}
    torch.cuda.synchronize()
    return times, outs


def bitwise(torch, a, b):
    bits = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.shape == b.shape and bool(torch.equal(a.view(bits), b.view(bits)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edits-only", action="store_true",
                    help="check that every edit applies to the source, then stop")
    ap.add_argument("--only", nargs="*", help="run only these variants (and the two sources)")
    ap.add_argument("--pr8", metavar="PATH", help="the first design's source, for a bitwise check")
    args = ap.parse_args()
    srcs = {name: path.read_text() for name, path in SOURCES.items()}
    texts = {"staged": srcs["staged"]}
    texts.update({name: edited(srcs[base], e) for name, (base, e) in VARIANTS.items()
                  if not args.only or name in args.only})
    if args.edits_only:
        print(json.dumps({"edits_apply": sorted(texts)}))
        return 0

    import torch

    import chip_smoke as cs
    from replication_faster_rcnn_tpu_torch.ops.cuda import build, roi_kernel

    if not torch.cuda.is_available():
        print("roi_pool_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"card: {card}")
    build.build_all()
    base = roi_kernel._pool_kernels()
    if args.pr8:
        texts["pr8"] = Path(args.pr8).read_text()
    libs = compile_all(build, texts)
    dev = torch.device("cuda")
    fwd_cases, bwd_cases = cases(torch, cs, dev)

    results = {"card": card, "times": {}, "bitwise_vs_committed": {}, "ptxas": {}}
    cs.log("[committed source]")
    results["times"]["committed"], ref = run_source(torch, cs, roi_kernel, fwd_cases, bwd_cases)
    if args.pr8:
        _, bwd8, _ = bind(libs.pop("pr8")[0])
        results["bwd_bitwise_vs_pr8"] = {
            name: bitwise(torch, ref[f"bwd {name}"], pr8_backward(torch, bwd8, *c))
            for name, c in bwd_cases.items()}
        cs.log(f"  backward bitwise vs PR 8: {results['bwd_bitwise_vs_pr8']}")
    for name, (lib, ptxas) in libs.items():
        results["ptxas"][name] = ptxas
        roi_kernel._pool_fns = bind(lib)
        cs.log(f"[{name}]")
        try:
            results["times"][name], outs = run_source(torch, cs, roi_kernel, fwd_cases, bwd_cases)
            results["bitwise_vs_committed"][name] = all(
                bitwise(torch, outs[k], ref[k]) for k in ref)
        except (AssertionError, RuntimeError, ValueError) as e:
            results["times"][name] = {"failed": str(e)[:300]}
            cs.log(f"  {name} failed: {e}")
    roi_kernel._pool_fns = base
    cs.log("[committed source, again]")
    results["times"]["committed_again"], _ = run_source(torch, cs, roi_kernel, fwd_cases,
                                                        bwd_cases)
    for name, rows in results["times"].items():
        if "failed" in rows:
            continue
        cs.log(f"{name:18s} " + " | ".join(
            f"{k} {v['ms']:.4f} (" + " ".join(f"{kn.replace('roi_pool_', '')}={ms:.4f}"
                                              for kn, ms in v["kernels"].items()) + ")"
            for k, v in rows.items()))
    line = json.dumps(results)
    (build.BUILD_DIR.parent / "roi_pool_variants" / "results.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
