#!/usr/bin/env python3
"""Time source variants of the PyTorch port's ROIAlign kernels on the card.

Run from the repository root on a machine with an NVIDIA H100:
``python benchmarks/roi_align_variants.py`` (``--edits-only`` checks on any
machine that every edit still applies to the source, and stops).

Each variant is ``replication_faster_rcnn_tpu_torch/csrc/roi_align_kernel.cu``
with one edit, compiled with the port's nvcc flags into
``build/roi_variants/`` and swapped into the wrapper. Before it is timed,
``chip_smoke.py``'s check functions hold it against the plain versions:
the forward bitwise, the backward to ``ROI_BWD_TOL`` and bitwise across two
launches. The committed source runs first and last, the variants in turn
between, all in one process on one card, at ``chip_smoke.py`` [3]'s shapes.
The last line of standard output is one JSON object with every time.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SRC = REPO / "replication_faster_rcnn_tpu_torch" / "csrc" / "roi_align_kernel.cu"

# name -> [(old, new)], each old string found exactly once in the source
FWD_VARIANTS = {
    # the final division by s*s as a division even when s*s is a power of two
    "divide_by_s2": [(
        "acc[j] = pow2 ? __fmul_rn(acc[j], inv_ns) : __fdiv_rn(acc[j], n_samples);",
        "acc[j] = __fdiv_rn(acc[j], n_samples);")],
    # every sample's taps loaded and the out-of-range ones selected away
    "branch_free_samples": [
        ("""            if (!(ay.in_range && ax.in_range)) {  // contributes +0, as in the plain version
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], 0.f);
              continue;
            }
""", """            const bool inside = ay.in_range && ax.in_range;
"""),
        ("""              acc[j] = __fadd_rn(acc[j], tap_sum(f00[j], f01[j], f10[j], f11[j],
                                                 w00, w01, w10, w11));""",
         """              const float v = tap_sum(f00[j], f01[j], f10[j], f11[j], w00, w01, w10, w11);
              acc[j] = __fadd_rn(acc[j], inside ? v : 0.f);""")],
    "threads_128": [("constexpr int FWD_THREADS = 256;", "constexpr int FWD_THREADS = 128;")],
    "streaming_stores": [
        ("""  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);""",
         """  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p + 4), make_float4(v[4], v[5], v[6], v[7]));"""),
        ("  *reinterpret_cast<uint4*>(p) = u;\n}", "  __stcs(reinterpret_cast<uint4*>(p), u);\n}")],
}
BWD_VARIANTS = {
    # the scalar fallback compiled into the vector instantiation too
    "scalar_in_vector_kernel": [("  if (VEC) {\n    if (nch == 8) {", "  if (VEC && nch == 8) {\n    {")],
    "tile_1x4": [("constexpr int BWD_ROWS = 2;", "constexpr int BWD_ROWS = 1;"),
                 ("constexpr int BWD_MIN_BLOCKS = 4;", "constexpr int BWD_MIN_BLOCKS = 8;")],
    "tile_2x2": [("constexpr int BWD_COLS = 4;", "constexpr int BWD_COLS = 2;"),
                 ("constexpr int BWD_MIN_BLOCKS = 4;", "constexpr int BWD_MIN_BLOCKS = 8;")],
    "tile_4x2": [("constexpr int BWD_ROWS = 2;", "constexpr int BWD_ROWS = 4;"),
                 ("constexpr int BWD_COLS = 4;", "constexpr int BWD_COLS = 2;")],
    "no_register_cap": [("constexpr int BWD_MIN_BLOCKS = 4;", "constexpr int BWD_MIN_BLOCKS = 1;")],
}


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variant(build, name, text):
    """Compile one variant; returns (forward fn, backward fn, ptxas lines)."""
    out_dir = build.BUILD_DIR.parent / "roi_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc {name}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(cu.with_suffix(".so")))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.roi_align_fwd.argtypes = [p, i, p, i, i, i, i, i, i, i, p, i, i, p]
    lib.roi_align_bwd.argtypes = [p, i, p, i, i, i, i, i, i, i, p, i, p]
    lib.roi_align_fwd.restype = lib.roi_align_bwd.restype = i
    ptxas = [ln.strip() for ln in res.stdout.splitlines() if "registers" in ln]
    return lib.roi_align_fwd, lib.roi_align_bwd, ptxas


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edits-only", action="store_true",
                    help="check that every edit applies to the source, then stop")
    args = ap.parse_args()
    src = SRC.read_text()
    texts = {name: edited(src, e) for name, e in {**FWD_VARIANTS, **BWD_VARIANTS}.items()}
    if args.edits_only:
        print(json.dumps({"edits_apply": sorted(texts)}))
        return 0

    import torch

    import chip_smoke as cs
    from replication_faster_rcnn_tpu_torch.ops.cuda import build, roi_kernel

    if not torch.cuda.is_available():
        print("roi_align_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    base = roi_kernel._kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, feat_shape = 8, cs.FEAT
    feat = torch.from_numpy(rng.normal(0, 1, (b,) + feat_shape).astype(np.float32)).to(dev)
    rois = torch.from_numpy(cs.rand_boxes(rng, (b, 300), 600, 300)
                            * (feat_shape[0] / 600)).to(dev)
    rois[:, :4] = torch.tensor([[-0.9, -0.9, 3.0, 3.0], [35.0, 34.0, 40.0, 41.0],
                                [2.2, 2.2, 2.2, 2.2], [-5.0, -5.0, -2.0, -1.5]], device=dev)
    bf16 = torch.bfloat16
    fb = feat.to(bf16)
    trois = rois[:, :128].contiguous()
    g = torch.from_numpy(rng.normal(0, 1, (b, 128, 7, 7, feat_shape[2]))
                         .astype(np.float32)).to(dev)
    same = torch.tensor([5.3, 7.1, 30.2, 33.9], device=dev).expand(b, 128, 4).contiguous()
    shape = (b,) + feat_shape

    def forward_rows():
        return {
            "bf16 8x300 -> f32": cs.check_roi(torch, "bf16 8x300 -> f32", fb, rois)["ms"],
            "bf16 8x300 -> bf16": cs.check_roi(torch, "bf16 8x300 -> bf16", fb, rois,
                                               bf16)["ms"],
            "bf16 1x300 -> bf16": cs.check_roi(torch, "bf16 1x300 -> bf16", fb[:1],
                                               rois[:1].contiguous(), bf16)["ms"],
            "bf16 8x128 -> bf16": cs.check_roi(torch, "bf16 8x128 -> bf16", fb, trois,
                                               bf16)["ms"],
        }

    def backward_rows():
        return {
            "f32 grad -> bf16": cs.check_roi_bwd(torch, "f32 grad -> bf16", g, trois, shape,
                                                 bf16)["ms"],
            "bf16 grad -> bf16": cs.check_roi_bwd(torch, "bf16 grad -> bf16", g.to(bf16),
                                                  trois, shape, bf16)["ms"],
            "bf16 grad, identical rois": cs.check_roi_bwd(torch, "identical rois",
                                                          g.to(bf16), same, shape, bf16)["ms"],
        }

    def one_block_per_roi():
        return {
            "bf16 8x300 -> bf16": cs.time_ms(torch, lambda: roi_kernel._forward_cuda(
                fb, rois, 7, 2, bf16, splits=1), 20),
            "bf16 1x300 -> bf16": cs.time_ms(torch, lambda: roi_kernel._forward_cuda(
                fb[:1], rois[:1].contiguous(), 7, 2, bf16, splits=1), 20),
        }

    results = {"card": card, "forward": {}, "backward": {}, "ptxas": {}}
    cs.log("[committed source]")
    results["forward"]["committed"] = forward_rows()
    results["forward"]["committed_one_block_per_roi"] = one_block_per_roi()
    results["backward"]["committed"] = backward_rows()
    for name, text in texts.items():
        fwd, bwd, ptxas = build_variant(build, name, text)
        results["ptxas"][name] = ptxas
        roi_kernel._fns = (fwd, bwd, base[2])
        cs.log(f"[{name}]")
        if name in FWD_VARIANTS:
            results["forward"][name] = forward_rows()
        else:
            results["backward"][name] = backward_rows()
    roi_kernel._fns = base
    cs.log("[committed source, again]")
    results["forward"]["committed_again"] = forward_rows()
    results["backward"]["committed_again"] = backward_rows()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
