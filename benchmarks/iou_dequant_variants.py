#!/usr/bin/env python3
"""Time source variants of the PyTorch port's IoU-matching and dequantize kernels on the card.

Run from the repository root on a machine with an NVIDIA H100:
``python benchmarks/iou_dequant_variants.py`` (``--edits-only`` checks on
any machine that every edit still applies to its source, and stops).

Each variant is ``replication_faster_rcnn_tpu_torch/csrc/iou_match_kernel.cu``
or ``quant_kernel.cu`` with one edit, compiled with the port's nvcc flags
into ``build/iou_dequant_variants/`` and swapped into the wrapper. Before it
is timed, ``chip_smoke.py``'s check functions hold it against the plain
versions: IoU matching bitwise in all four outputs and across two launches,
the dequantize bitwise, one leaf and all 23 conv weights at once. The
committed sources run first and last, the variants in turn between, all in
one process on one card, at ``chip_smoke.py`` [3]'s shapes. The last line
of standard output is one JSON object with every time.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

from roi_align_variants import edited  # one edit per variant, each applying once

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

CSRC = REPO / "replication_faster_rcnn_tpu_torch" / "csrc"

# name -> [(old, new)], each old string found exactly once in the source
IOU_VARIANTS = {
    # the division only for pairs that overlap (a branch, +0 returned early)
    "divide_branch": [
        ("""  const bool overlap = wh_r > 0.f && wh_c > 0.f;
  const float inter = overlap ? __fmul_rn(wh_r, wh_c) : 0.f;""",
         """  if (!(wh_r > 0.f && wh_c > 0.f)) return 0.f;
  const float inter = __fmul_rn(wh_r, wh_c);"""),
        ("""  const bool pos = overlap && uni > 0.f;""", """  const bool pos = uni > 0.f;""")],
    # the division for every pair as it comes, a zero dividend included
    "divide_always": [(
        """  const bool pos = overlap && uni > 0.f;
  const float q = __fdiv_rn(pos ? inter : 1.f, pos ? uni : 1.f);
  return pos ? q : 0.f;""",
        """  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;""")],
    # every gt column computed, a padded one as -1 (no compaction)
    "all_columns": [
        ("""      const bool on = c0 + lane < g_cols && img_mask[c0 + lane];""",
         """      const bool on = c0 + lane < g_cols;"""),
        ("""    if (live) gb = s_gt[s_cols[k0 + k]];""",
         """    bool on = false;
    if (live) {
      gb = s_gt[s_cols[k0 + k]];
      on = img_mask[s_cols[k0 + k]];
    }"""),
        ("""      const float v = iou_strict(t_box[t], t_area[t], gb, area_g);""",
         """      const float v = on ? iou_strict(t_box[t], t_area[t], gb, area_g) : -1.f;""")],
    "threads_64": [("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")],
    "threads_256": [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;")],
    "row_walk_unroll_8": [("#pragma unroll 4\n    for (int t = lane / width;",
                           "#pragma unroll 8\n    for (int t = lane / width;")],
}
DEQUANT_VARIANTS = {
    "dq_threads_128": [("constexpr int DQ_THREADS = 256;", "constexpr int DQ_THREADS = 128;")],
    "dq_threads_512": [("constexpr int DQ_THREADS = 256;", "constexpr int DQ_THREADS = 512;")],
    "dq_32_per_thread": [("constexpr int DQ_PER_THREAD = 16; ", "constexpr int DQ_PER_THREAD = 32; ")],
    # each lane's 16 elements contiguous: every store instruction of a warp
    # writes part of each sector it touches
    "lane_contiguous": [("  return q * 32 * E + lane * E;", "  return lane * DQ_PER_THREAD + q * E;")],
    # no hoisting: each vector loaded just before it is converted and stored
    "loads_in_place": [
        ("  if (vec) {  // every load in flight before the first store", "  if (false) {"),
        ("      float v[E];\n      if (j + E <= inner) {",
         "      float v[E];\n      raw[q] = __ldg(reinterpret_cast<const Raw*>(w + i));\n"
         "      if (j + E <= inner) {")],
}


def compile_variant(build, name, text):
    """Compile one variant with the port's nvcc flags (as
    ``roi_align_variants.build_variant`` does, whose loader binds the
    ROIAlign entry points); returns (library, ptxas lines)."""
    out_dir = build.BUILD_DIR.parent / "iou_dequant_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines() if "registers" in ln]
    return ctypes.CDLL(str(cu.with_suffix(".so"))), ptxas


def iou_fns(lib, base):
    fn = lib.iou_match_launch
    fn.argtypes, fn.restype = base[0].argtypes, ctypes.c_int
    return (fn, base[1])


def quant_fns(lib, base):
    import torch

    single = {torch.float32: lib.dequantize_launch_f32, torch.bfloat16: lib.dequantize_launch_bf16}
    many = {torch.float32: lib.dequantize_many_launch_f32,
            torch.bfloat16: lib.dequantize_many_launch_bf16}
    for dtype in single:
        single[dtype].argtypes = base.single[dtype].argtypes
        many[dtype].argtypes = base.many[dtype].argtypes
        single[dtype].restype = many[dtype].restype = ctypes.c_int
    lib.dequantize_block_elements.restype = ctypes.c_int
    return (types.SimpleNamespace(matmul=base.matmul, single=single, many=many, error=base.error),
            lib.dequantize_block_elements())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edits-only", action="store_true",
                    help="check that every edit applies to its source, then stop")
    args = ap.parse_args()
    iou_src = (CSRC / "iou_match_kernel.cu").read_text()
    quant_src = (CSRC / "quant_kernel.cu").read_text()
    texts = {name: edited(iou_src, e) for name, e in IOU_VARIANTS.items()}
    texts.update({name: edited(quant_src, e) for name, e in DEQUANT_VARIANTS.items()})
    if args.edits_only:
        print(json.dumps({"edits_apply": sorted(texts)}))
        return 0

    import torch

    import chip_smoke as cs
    from replication_faster_rcnn_tpu_torch.config import AnchorConfig
    from replication_faster_rcnn_tpu_torch.ops.anchors import make_anchors
    from replication_faster_rcnn_tpu_torch.ops.cuda import build, iou_kernel, quant_kernel

    if not torch.cuda.is_available():
        print("iou_dequant_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"card: {card}")
    base_iou, base_quant = iou_kernel._kernel(), quant_kernel._kernels()
    base_block = quant_kernel.DQ_BLOCK
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b = 8
    anchors = torch.from_numpy(make_anchors(AnchorConfig(), cs.FEAT[:2])).to(dev)[None]
    gt = torch.from_numpy(cs.rand_boxes(rng, (b, 64), 450, 300)).to(dev)
    gmask = torch.arange(64, device=dev)[None, :] < torch.tensor(
        [1, 3, 32, 5, 8, 2, 0, 17], device=dev)[:, None]
    gmask64 = torch.arange(64, device=dev)[None, :] < torch.tensor(
        [1, 33, 64, 40, 8, 2, 0, 63], device=dev)[:, None]
    cand = torch.cat([torch.from_numpy(cs.rand_boxes(rng, (b, 600), 500, 250)).to(dev),
                      gt[:, :32]], dim=1)
    leaves = []
    for shape in cs.conv_weight_shapes(torch):
        leaves.append((torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev),
                       torch.from_numpy(rng.uniform(1e-4, 0.05, shape[0]).astype(np.float32))
                       .to(dev)))
    largest = max(leaves, key=lambda ws: ws[0].numel())

    def iou_rows():
        g32, m32 = gt[:, :32].contiguous(), gmask[:, :32].contiguous()
        return {
            "anchors 8x12996x32 + col": cs.check_iou(torch, "anchors", anchors, g32, m32,
                                                     True)["ms"],
            "proposals 8x632x32": cs.check_iou(torch, "proposals", cand, g32, m32, False)["ms"],
            "anchors 8x12996x64 + col": cs.check_iou(torch, "anchors g64", anchors, gt, gmask64,
                                                     True)["ms"],
        }

    def dequant_rows():
        return {
            "layer4 -> f32": cs.check_dequantize(torch, "layer4", *largest, "float32")["ms"],
            "layer4 -> bf16": cs.check_dequantize(torch, "layer4", *largest, "bfloat16")["ms"],
            "flush 23 -> bf16": cs.check_dequantize_many(torch, leaves)["ms"],
        }

    results = {"card": card, "iou": {}, "dequantize": {}, "ptxas": {}}
    cs.log("[committed sources]")
    results["iou"]["committed"] = iou_rows()
    results["dequantize"]["committed"] = dequant_rows()
    for name, text in texts.items():
        lib, results["ptxas"][name] = compile_variant(build, name, text)
        cs.log(f"[{name}]")
        if name in IOU_VARIANTS:
            iou_kernel._fn = iou_fns(lib, base_iou)
            results["iou"][name] = iou_rows()
        else:
            quant_kernel._fns, quant_kernel.DQ_BLOCK = quant_fns(lib, base_quant)
            results["dequantize"][name] = dequant_rows()
        iou_kernel._fn, quant_kernel._fns = base_iou, base_quant
        quant_kernel.DQ_BLOCK = base_block
    cs.log("[committed sources, again]")
    results["iou"]["committed_again"] = iou_rows()
    results["dequantize"]["committed_again"] = dequant_rows()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
