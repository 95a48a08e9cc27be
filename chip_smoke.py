#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``replication_faster_rcnn_tpu_torch``).

Run from the repository root with no arguments on a machine with one NVIDIA
H100:  ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every CUDA kernel from ``replication_faster_rcnn_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/torch_kernels/``) and prints the time;
3. holds each kernel against its plain PyTorch version on the card at the
   serving and training paths' shapes and times both: NMS bitwise (serving
   8 x 3000 -> 300 and 8 x 6300 -> 100, training 8 x 12000 -> 600 on random
   boxes and on clustered boxes, which overlap like the step's proposals);
   ROIAlign forward bitwise against its gather twin (cast to the output
   dtype) at serving 8 x 300 and 1 x 300 and training 8 x 128 rois, float32
   and bfloat16 features and outputs, and within atol 2e-5 / rtol 1e-5 of
   the einsum formulation for float32 outputs; IoU matching bitwise in all four
   outputs at the anchor site (8 x 12996 anchors x 32 gt) and the proposal
   site (8 x 632 x 32); ROIAlign backward (8 x 128 rois on [38, 38, 256])
   within atol 1e-4 / rtol 1e-5 in float32 and one bfloat16 ulp in bfloat16
   of the plain scatter (the kernel groups the same terms by bin and sums
   in float32 in another order), from float32 and bfloat16 gradients, and
   bitwise equal across two launches, also with 128 identical rois per
   image; the int8 GEMM bitwise at the head's cls/reg shapes
   ([300 or 2400, 512] x [512, 21 or 84]) and the dequantize bitwise on all
   23 conv weights of the model, into float32 and bfloat16, with the
   library calls ``torch._int_mm`` and ``torch.mul`` timed beside them;
4. serves ``voc12_resnet18_align`` at 600x600 (ResNet18, 21 classes, ROIAlign
   7x7 s=2, seeded random weights resident in bfloat16) through
   ``InferenceEngine``: one request, then 8 mixed-size images as one b8
   flush, with the kernels' launch counters reset just before and read just
   after; the same requests then go through the plain versions
   (``reference=True``) and every output must be equal;
5. serves the same model in int8: calibrates it on the card with
   ``quant.synthetic_calibration_batches`` and runs the sensitivity sweep
   (``QuantConfig`` defaults), writes the sidecar under ``build/``, then
   serves the same b1 and b8 requests as [4] with ``params_dtype="int8"``,
   the launch counters reset just before and read after each flush (per
   flush: int8 GEMM 2 and dequantize 23 when every group stays int8, NMS 2,
   ROIAlign 1); the replay through the plain versions must give bitwise
   equal detections; the resident tree must be under 0.4 x the float32
   weights and the engine's device memory below the bfloat16 engine's;
6. trains ``voc12_resnet18_align`` at 600x600, batch 8 (bfloat16 compute,
   float32 parameters, 12000 -> 600 proposals, 256 anchor and 128 roi
   samples per image) with the ``Trainer`` on ``SyntheticDataset``: 2
   warm-up steps, then ``TRAIN_REPS`` timed steps with the launch counters
   reset just before and read just after (per step: NMS 1, IoU matching 2,
   ROIAlign forward 1 and backward 1); every loss must be finite; the
   profiler's timeline of 3 more steps gives the NMS kernels' (mask and
   walk) and the ROIAlign kernels' (forward and backward) device ms per
   step. One more forward and backward from the same state and the same
   draws runs under
   ``ops.reference_scope()``: targets, labels, the four losses and the new
   BatchNorm statistics must be bitwise equal to the kernel pass, and each
   parameter's gradient within a relative L2 error of ``GRAD_RTOL``;
7. prints a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without CUDA, or without
the repository beside it, it exits non-zero at once. Comparisons run with
TF32 off for matmuls and convolutions and deterministic cuDNN, so the kernel
and reference passes see bit-identical convolution outputs.
"""

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s and non-tensor-core f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12  # dense int8 tensor-core operations per second
IOU_FLOPS = 16  # max/min x4, sub x6, mul x3, add x2, div x1 per IoU

NMS_SRC = "replication_faster_rcnn_tpu_torch/csrc/nms_kernel.cu"
ROI_SRC = "replication_faster_rcnn_tpu_torch/csrc/roi_align_kernel.cu"
IOU_SRC = "replication_faster_rcnn_tpu_torch/csrc/iou_match_kernel.cu"
NMS_TPU = "replication_faster_rcnn_tpu/ops/pallas/nms_kernel.py:101"
ROI_TPU = "replication_faster_rcnn_tpu/ops/pallas/roi_kernel.py:41"
ROI_BWD_TPU = "replication_faster_rcnn_tpu/ops/pallas/roi_kernel.py:99"
ROI_BWD_NOTE = ("the JAX package has no Pallas backward: its custom_vjp replays the XLA "
                "einsum VJP; the port needs a kernel because its forward is hand-written")
IOU_TPU = "replication_faster_rcnn_tpu/ops/pallas/iou_kernel.py:35"
QUANT_SRC = "replication_faster_rcnn_tpu_torch/csrc/quant_kernel.cu"
GEMM_TPU = "replication_faster_rcnn_tpu/ops/pallas/quant_kernel.py:43"
DEQUANT_TPU = "replication_faster_rcnn_tpu/ops/pallas/quant_kernel.py:84"
NO_LIBRARY = ("torch core has no NMS, ROIAlign or IoU-matching operator "
              "(torchvision is not installed)")

FEAT = (38, 38, 256)  # ResNet18 stride-16 features of a 600x600 image
SLEEP_CYCLES = 10**8  # ~50 ms of device sleep at the H100's ~2 GHz clock
REPS = 10  # timed repetitions of the serving main path
TRAIN_REPS = 10  # timed training steps
# per-parameter relative L2 error of the kernel pass's gradients against the
# plain pass's. The two ROIAlign backward formulations sum the same float32
# products in other orders; the feature gradient is then rounded to bfloat16
# and the trunk's backward runs in bfloat16 (relative step 2**-8), so a few
# flipped roundings compound through the 14 conv layers below the features.
# Measured on the CPU at 96x96 after 6 steps: 1.1e-2 in bfloat16, 1.8e-6 with
# float32 compute.
GRAD_RTOL = 5e-2
ROI_BWD_TOL = {"float32": {"atol": 1e-4, "rtol": 1e-5}, "bfloat16": {"atol": 1e-4, "rtol": 2**-7}}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps, warmup=2, runs=5):
    """Device ms of one call of ``fn``: the median over ``runs`` of CUDA-event
    time around ``reps`` back-to-back calls, divided by ``reps``, after
    warm-up. Each run is queued behind a device sleep of ``SLEEP_CYCLES``,
    so the host has enqueued the calls before the start event executes and
    the events time the card's work, not the host's enqueueing (a call that
    synchronises inside still counts its host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def rand_boxes(rng, shape, size, max_wh):
    p1 = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(8, max_wh, shape + (2,))
    return np.concatenate([p1, p1 + wh], axis=-1).astype(np.float32)


def clustered_boxes(rng, b, n, size=600.0, clusters=40):
    """Boxes jittered around a few centres, so suppression chains are long."""
    centres = rand_boxes(rng, (b, clusters), size - 100, 120)
    pick = rng.integers(0, clusters, (b, n))
    base = np.take_along_axis(centres, pick[..., None], axis=1)
    return (base + rng.normal(0, 6, (b, n, 4))).astype(np.float32)


def nms_bound(torch, boxes, scores, mask, idx, valid, assume_sorted, max_out):
    """(bound_ms, bound_by) for one NMS call from this run's data: each input
    read once and each output written once, and one IoU (16 flops) between
    each examined candidate and every box kept before it."""
    from replication_faster_rcnn_tpu_torch.ops.nms_tiled import prepare_candidates

    nbytes = boxes.numel() * 4 + scores.numel() * 4 + idx.numel() * 9
    if mask is not None:
        nbytes += mask.numel()
    _, s_sorted, order = prepare_candidates(boxes, scores, mask, assume_sorted)
    live = (s_sorted > float("-inf")).cpu().numpy()
    order = order.cpu().numpy()
    idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
    comparisons = 0
    for i in range(live.shape[0]):
        pos = np.argsort(order[i])  # original index -> sorted position
        kept = np.sort(pos[idx[i][valid[i]]])
        last = kept[-1] if len(kept) == max_out else live.shape[1] - 1
        cand = np.nonzero(live[i][: last + 1])[0]
        comparisons += int(np.searchsorted(kept, cand).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = comparisons * IOU_FLOPS / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def roi_bound(feat, rois, out, s):
    out_elems = out.numel()
    nbytes = (feat.numel() * feat.element_size() + rois.numel() * 4
              + out_elems * out.element_size())
    flops = out_elems * (8 * s * s + 1)  # per sample: 4 mul + 3 add + 1 accumulate
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_nms(torch, name, boxes, scores, thresh, max_out, mask=None, assume_sorted=False):
    """Kernel against the plain version (bitwise), then the times; ``prep_ms``
    is the part of the kernel's call that runs outside the kernels (score
    clean-up and, unless ``assume_sorted``, the stable sort)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.nms_kernel import nms_fixed_cuda
    from replication_faster_rcnn_tpu_torch.ops.nms_tiled import nms_fixed_tiled, prepare_candidates

    kw = dict(mask=mask, assume_sorted=assume_sorted)
    idx, valid = nms_fixed_cuda(boxes, scores, thresh, max_out, **kw)
    ridx, rvalid = nms_fixed_tiled(boxes, scores, thresh, max_out, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(idx, ridx) and torch.equal(valid, rvalid)):
        diff = int((idx != ridx).sum()) + int((valid != rvalid).sum())
        raise AssertionError(f"NMS {name}: kernel and plain version differ in {diff} slots")
    kept = valid.sum(dim=1).tolist()
    ms = time_ms(torch, lambda: nms_fixed_cuda(boxes, scores, thresh, max_out, **kw), 20)
    plain_ms = time_ms(torch, lambda: nms_fixed_tiled(boxes, scores, thresh, max_out, **kw), 5, 1)
    prep_ms = time_ms(torch, lambda: prepare_candidates(boxes, scores, mask, assume_sorted), 20)
    bound_ms, bound_by = nms_bound(torch, boxes, scores, mask, idx, valid, assume_sorted, max_out)
    log(f"  nms {name}: bitwise equal, kept per image {kept}, kernel {ms:.4f} ms (of which "
        f"{prep_ms:.4f} outside the kernels), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "prep_ms": prep_ms, "max_abs_err": 0.0}


def check_roi(torch, name, feat, rois, out_dtype=None, unsplit=False):
    """Forward kernel against the gather twin cast to ``out_dtype`` (bitwise)
    and, for float32 outputs, the einsum formulation; then the times (the
    plain time includes the cast). ``unsplit`` also times the kernel with one
    block per roi (the launch otherwise splits a roi's bins over several
    blocks when there are too few rois to fill the card)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import _forward_cuda, roi_align_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align

    out_dtype = out_dtype or torch.float32
    out = roi_align_cuda(feat, rois, 7, 2, out_dtype=out_dtype)
    gather = roi_align(feat, rois, 7, 2, method="gather")
    want = gather.to(out_dtype)
    torch.cuda.synchronize()
    if out.dtype != out_dtype or out.shape != gather.shape:
        raise AssertionError(f"ROIAlign {name}: got {out.dtype} {tuple(out.shape)}")
    err_gather = float((out.float() - want.float()).abs().max())
    if not torch.equal(out, want):
        raise AssertionError(f"ROIAlign {name}: kernel differs from its gather twin by {err_gather}")
    err_einsum = None
    if out_dtype == torch.float32:
        einsum = roi_align(feat, rois, 7, 2, method="einsum")
        err_einsum = float((out - einsum).abs().max())
        if not torch.allclose(out, einsum, atol=2e-5, rtol=1e-5):
            raise AssertionError(f"ROIAlign {name}: kernel vs einsum max err {err_einsum}")
    ms = time_ms(torch, lambda: roi_align_cuda(feat, rois, 7, 2, out_dtype=out_dtype), 20)
    plain_ms = time_ms(torch, lambda: roi_align(feat, rois, 7, 2, method="gather").to(out_dtype),
                       5, 1)
    bound_ms, bound_by = roi_bound(feat, rois, out, 2)
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "max_abs_err": err_gather, "max_abs_err_vs_einsum": err_einsum}
    note = "" if err_einsum is None else f", max |kernel - einsum| {err_einsum:.3e} (atol 2e-5 rtol 1e-5)"
    if unsplit:
        res["one_block_per_roi_ms"] = time_ms(
            torch, lambda: _forward_cuda(feat, rois, 7, 2, out_dtype, splits=1), 20)
        note += f", one block per roi {res['one_block_per_roi_ms']:.4f} ms"
    log(f"  roi_align {name}: bitwise equal to gather{note}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return res


def check_iou(torch, name, boxes, gt, mask, want_col):
    from replication_faster_rcnn_tpu_torch.ops.cuda.iou_kernel import match_boxes_cuda
    from replication_faster_rcnn_tpu_torch.ops.iou_match import match_boxes

    got = match_boxes_cuda(boxes, gt, mask, want_col=True, want_iou=True)
    want = match_boxes(boxes, gt, mask, want_col=True)
    torch.cuda.synchronize()
    for what, a, b in zip(("iou", "argmax", "max_iou", "col_argmax"), got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"IoU matching {name}: kernel and plain {what} differ")
    ms = time_ms(torch, lambda: match_boxes_cuda(boxes, gt, mask, want_col, want_iou=False), 20)
    plain_ms = time_ms(torch, lambda: match_boxes(boxes, gt, mask, want_col), 10)
    b, g = gt.shape[:2]
    m = boxes.shape[1]
    nbytes = (boxes.numel() * 4 + gt.numel() * 4 + mask.numel() + b * m * (8 + 4)
              + (b * g * 8 if want_col else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = b * m * g * IOU_FLOPS / F32_FLOPS * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    log(f"  iou_match {name}: all four outputs bitwise equal, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": 0.0}


def roi_bwd_bound(torch, grad_out, rois, feat_shape, feat_dtype, out, s):
    """Bytes: grad_out and rois read once, grad_feat written once in the
    feature's dtype. Operations: one division per output element and, per
    in-range sample of this run's rois, 4 taps x (2 multiplies + 1 add)."""
    from replication_faster_rcnn_tpu_torch.ops import roi_ops

    n, h, w, c = feat_shape
    rr, cc = roi_ops._sample_coords(rois.float(), out, s)
    in_r = roi_ops._axis_taps(rr, h)[-1]
    in_c = roi_ops._axis_taps(cc, w)[-1]
    inside = int((in_r[..., :, None] & in_c[..., None, :]).sum())
    elem = torch.empty((), dtype=feat_dtype).element_size()
    nbytes = grad_out.numel() * grad_out.element_size() + rois.numel() * 4 + n * h * w * c * elem
    flops = grad_out.numel() + inside * c * 12
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_roi_bwd(torch, name, grad_out, rois, feat_shape, feat_dtype):
    """Backward kernel against the plain scatter (``ROI_BWD_TOL``), a second
    launch on the same inputs bitwise equal to the first, then the times."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_backward_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align_backward

    got = roi_align_backward_cuda(grad_out, rois, feat_shape, feat_dtype, 7, 2)
    again = roi_align_backward_cuda(grad_out, rois, feat_shape, feat_dtype, 7, 2)
    want = roi_align_backward(grad_out, rois, feat_shape, feat_dtype, 7, 2)
    torch.cuda.synchronize()
    tol = ROI_BWD_TOL[str(feat_dtype).split(".")[-1]]
    if got.dtype != feat_dtype or got.shape != want.shape:
        raise AssertionError(f"ROIAlign backward {name}: got {got.dtype} {tuple(got.shape)}")
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"ROIAlign backward {name}: max err {err} beyond {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"ROIAlign backward {name}: two launches on the same inputs differ")
    ms = time_ms(torch, lambda: roi_align_backward_cuda(grad_out, rois, feat_shape, feat_dtype,
                                                        7, 2), 20)
    plain_ms = time_ms(torch, lambda: roi_align_backward(grad_out, rois, feat_shape, feat_dtype,
                                                         7, 2), 5, 1)
    bound_ms, bound_by = roi_bwd_bound(torch, grad_out, rois, feat_shape, feat_dtype, 7, 2)
    log(f"  roi_align_bwd {name}: max |kernel - plain| {err:.3e} ({tol}), two launches bitwise "
        f"equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "deterministic": True}


def bound(nbytes, ops, peak_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_int8_matmul(torch, name, x, w_t):
    """``x [M, K] @ w_t.t()`` as the head calls it (the Linear weight
    ``[N, K]`` seen as ``[K, N]``): kernel against the plain version
    (bitwise), then the times; the library call is ``torch._int_mm`` on the
    weight padded to a multiple of 8 columns, which it requires."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import int8_matmul_cuda
    from replication_faster_rcnn_tpu_torch.ops.quant_ops import int8_matmul_plain

    w = w_t.t()
    got = int8_matmul_cuda(x, w)
    want = int8_matmul_plain(x, w)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or not torch.equal(got, want):
        raise AssertionError(f"int8 GEMM {name}: kernel and plain version differ")
    m, k = x.shape
    n = w.shape[1]
    n_pad = -(-n // 8) * 8
    w_pad = torch.zeros((n_pad, k), dtype=torch.int8, device=x.device)
    w_pad[:n] = w_t
    w_pad = w_pad.t()  # column-major [K, N_pad], the layout cuBLASLt takes for int8
    library = torch._int_mm(x, w_pad)
    torch.cuda.synchronize()
    if not torch.equal(library[:, :n], got):
        raise AssertionError(f"int8 GEMM {name}: torch._int_mm disagrees with the kernel")
    ms = time_ms(torch, lambda: int8_matmul_cuda(x, w), 20)
    plain_ms = time_ms(torch, lambda: int8_matmul_plain(x, w), 10)
    library_ms = time_ms(torch, lambda: torch._int_mm(x, w_pad), 20)
    bound_ms, bound_by = bound(m * k + k * n + m * n * 4, 2 * m * n * k, INT8_OPS)
    log(f"  int8_matmul {name}: bitwise equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch._int_mm (N padded to {n_pad}) {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "max_abs_err": 0.0}


def dequantize_bound(w_q, out_dtype):
    elem = 4 if out_dtype == "float32" else 2
    return bound(w_q.numel() * (1 + elem) + w_q.shape[0] * 4, w_q.numel(), F32_FLOPS)


def check_dequantize(torch, name, w_q, scale, out_dtype):
    """Per-output-channel dequantize of a port-layout weight (channel first)
    against the plain version (bitwise), then the times; for a float32
    output the library call ``torch.mul(w_q, scale)`` computes the same
    function by type promotion."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import dequantize_cuda
    from replication_faster_rcnn_tpu_torch.ops.quant_ops import dequantize_plain

    dtype = getattr(torch, out_dtype)
    got = dequantize_cuda(w_q, scale, 0, dtype)
    want = dequantize_plain(w_q, scale, 0, dtype)
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.equal(got, want):
        raise AssertionError(f"dequantize {name} {out_dtype}: kernel and plain version differ")
    ms = time_ms(torch, lambda: dequantize_cuda(w_q, scale, 0, dtype), 20)
    plain_ms = time_ms(torch, lambda: dequantize_plain(w_q, scale, 0, dtype), 20)
    library_ms = None
    if dtype == torch.float32:
        s_b = scale.view((-1,) + (1,) * (w_q.dim() - 1))
        if not torch.equal(torch.mul(w_q, s_b), got):
            raise AssertionError(f"dequantize {name}: torch.mul disagrees with the kernel")
        library_ms = time_ms(torch, lambda: torch.mul(w_q, s_b), 20)
    bound_ms, bound_by = dequantize_bound(w_q, out_dtype)
    lib = "—" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  dequantize {name} -> {out_dtype}: bitwise equal, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.mul {lib}, bound {bound_ms:.6f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "max_abs_err": 0.0}


def conv_weight_shapes(torch):
    """The state-dict shapes of the serving model's 23 conv weights (OIHW):
    the leaves the int8 path dequantizes on every flush."""
    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN

    model = FasterRCNN(get_config("voc12_resnet18_align"), device="meta")
    return [tuple(v.shape) for v in model.state_dict().values() if v.dim() == 4]


def check_int8_kernels(torch, rng, dev):
    """Phase [3] for the int8 slice: the GEMM at the head's b1 and b8 cls/reg
    shapes and the dequantize on every conv weight of the model."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import dequantize_cuda
    from replication_faster_rcnn_tpu_torch.ops.quant_ops import dequantize_plain

    def int8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    res = {}
    for m in (300, 2400):
        x = int8((m, 512))
        for name, n in (("cls", 21), ("reg", 84)):
            res[f"gemm_b{m // 300}_{name}"] = check_int8_matmul(
                torch, f"b{m // 300} {name} [{m}, 512] x [512, {n}]", x, int8((n, 512)))
    leaves = []
    for shape in conv_weight_shapes(torch):
        w_q = int8(shape)
        scale = torch.from_numpy(rng.uniform(1e-4, 0.05, shape[0]).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            if not torch.equal(dequantize_cuda(w_q, scale, 0, dtype),
                               dequantize_plain(w_q, scale, 0, dtype)):
                raise AssertionError(f"dequantize {shape} {dtype}: kernel and plain differ")
        leaves.append((w_q, scale))
    log(f"  dequantize: all {len(leaves)} conv weights bitwise equal to the plain version "
        "(float32 and bfloat16 outputs)")
    largest = max(leaves, key=lambda ws: ws[0].numel())
    name = "x".join(str(d) for d in largest[0].shape)
    res["dequant_f32"] = check_dequantize(torch, name, *largest, "float32")
    res["dequant_bf16"] = check_dequantize(torch, name, *largest, "bfloat16")

    def flush(fn):
        return lambda: [fn(w, s, 0, torch.bfloat16) for w, s in leaves]

    nbytes = sum(w.numel() * 3 + w.shape[0] * 4 for w, _ in leaves)
    ops = sum(w.numel() for w, _ in leaves)
    bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
    res["dequant_flush"] = {
        "ms": time_ms(torch, flush(dequantize_cuda), 20),
        "plain_ms": time_ms(torch, flush(dequantize_plain), 10),
        "bound_ms": bound_ms, "bound_by": bound_by, "launches": len(leaves),
        "elements": ops,
    }
    log(f"  dequantize, one flush's {len(leaves)} weights into bfloat16 ({ops} elements): kernel "
        f"{res['dequant_flush']['ms']:.4f} ms, plain {res['dequant_flush']['plain_ms']:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    return res


def phase_kernels(torch):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b = 8
    res = {}
    log("[3] kernels vs plain versions on the card")
    # proposal NMS: 3000 candidates per image, sorted by score, -> 300 at 0.7
    boxes = torch.from_numpy(rand_boxes(rng, (b, 3000), 560, 200)).to(dev)
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (b, 3000)), axis=1)
                              .astype(np.float32)).to(dev)
    res["nms_proposal"] = check_nms(torch, "proposal 8x3000->300 thr 0.7", boxes, scores,
                                    0.7, 300, mask=torch.isfinite(scores), assume_sorted=True)
    # detection NMS: 300 rois x 21 classes, unsorted, masked, class offsets
    r, c = 300, 21
    rb = rand_boxes(rng, (b, r), 560, 200)
    det = np.repeat(rb[:, :, None], c, axis=2) + rng.normal(0, 2, (b, r, c, 4))
    det = torch.from_numpy(det.reshape(b, r * c, 4).astype(np.float32)).to(dev)
    cls = torch.arange(c, device=dev).repeat(r)
    det = det + cls.float()[None, :, None] * (det.amax(dim=(1, 2), keepdim=True) + 1.0)
    dscores = torch.from_numpy(rng.uniform(0, 0.2, (b, r * c)).astype(np.float32)).to(dev)
    dmask = (cls[None] > 0) & (dscores >= 0.05)
    res["nms_detection"] = check_nms(torch, "detection 8x6300->100 thr 0.3", det, dscores,
                                     0.3, 100, mask=dmask)
    # clustered boxes: long suppression chains across tiles
    cb = torch.from_numpy(clustered_boxes(rng, b, 3000)).to(dev)
    cscores = torch.from_numpy(rng.uniform(0, 1, (b, 3000)).astype(np.float32)).to(dev)
    res["nms_clustered"] = check_nms(torch, "clustered 8x3000->300 thr 0.7", cb, cscores, 0.7, 300)
    # ROIAlign at the head's shapes: 8 x [38, 38, 256], 300 rois, 7x7, s=2
    feat = torch.from_numpy(rng.normal(0, 1, (b,) + FEAT).astype(np.float32)).to(dev)
    rois = torch.from_numpy(rand_boxes(rng, (b, 300), 600, 300) * (FEAT[0] / 600)).to(dev)
    rois[:, :4] = torch.tensor([[-0.9, -0.9, 3.0, 3.0], [35.0, 34.0, 40.0, 41.0],
                                [2.2, 2.2, 2.2, 2.2], [-5.0, -5.0, -2.0, -1.5]], device=dev)
    res["roi_f32"] = check_roi(torch, f"f32 8x300 {list(FEAT)}", feat, rois)
    res["roi_bf16"] = check_roi(torch, f"bf16 8x300 {list(FEAT)}", feat.to(torch.bfloat16), rois)
    bf16 = torch.bfloat16
    res["roi_bf16_out"] = check_roi(torch, f"bf16 8x300 {list(FEAT)} -> bf16",
                                    feat.to(bf16), rois, bf16)
    res["roi_b1_bf16_out"] = check_roi(torch, f"bf16 1x300 {list(FEAT)} -> bf16",
                                       feat[:1].to(bf16), rois[:1].contiguous(), bf16,
                                       unsplit=True)
    # the training shape, 8 x 128 rois (own generator: the draws of the
    # cases below stay as they were)
    trng = np.random.default_rng(5)
    trois = torch.from_numpy(rand_boxes(trng, (b, 128), 600, 300) * (FEAT[0] / 600)).to(dev)
    trois[:, :4] = rois[:, :4]
    res["roi_train_f32"] = check_roi(torch, f"f32 8x128 {list(FEAT)}", feat, trois)
    res["roi_train_bf16_out"] = check_roi(torch, f"bf16 8x128 {list(FEAT)} -> bf16",
                                          feat.to(bf16), trois, bf16)

    # training shapes: proposal NMS 8 x 12000 sorted -> 600 at 0.7
    boxes = torch.from_numpy(rand_boxes(rng, (b, 12000), 560, 250)).to(dev)
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (b, 12000)), axis=1)
                              .astype(np.float32)).to(dev)
    res["nms_train"] = check_nms(torch, "training 8x12000->600 thr 0.7", boxes, scores, 0.7, 600,
                                 mask=torch.isfinite(scores), assume_sorted=True)
    # the training shape with the overlap of the step's proposals (own
    # generator: the draws of the cases below stay as they were)
    crng = np.random.default_rng(4)
    cb = torch.from_numpy(clustered_boxes(crng, b, 12000)).to(dev)
    cscores = torch.from_numpy(-np.sort(-crng.uniform(0, 1, (b, 12000)), axis=1)
                               .astype(np.float32)).to(dev)
    res["nms_train_clustered"] = check_nms(torch, "clustered 8x12000->600 thr 0.7", cb, cscores,
                                           0.7, 600, mask=torch.isfinite(cscores),
                                           assume_sorted=True)
    # IoU matching: the 12996 anchors of a 38x38 map against 32 padded gt
    # boxes per image (with the column argmax), and 600 proposals + 32 gt
    # against the gt (without it)
    from replication_faster_rcnn_tpu_torch.config import AnchorConfig
    from replication_faster_rcnn_tpu_torch.ops.anchors import make_anchors

    anchors = torch.from_numpy(make_anchors(AnchorConfig(), FEAT[:2])).to(dev)[None]
    gt = torch.from_numpy(rand_boxes(rng, (b, 32), 450, 300)).to(dev)
    gmask = torch.arange(32, device=dev)[None, :] < torch.tensor(
        [1, 3, 32, 5, 8, 2, 0, 17], device=dev)[:, None]
    res["iou_anchor"] = check_iou(torch, "anchors 8x12996x32 + column argmax", anchors, gt, gmask,
                                  True)
    cand = torch.cat([torch.from_numpy(rand_boxes(rng, (b, 600), 500, 250)).to(dev), gt], dim=1)
    res["iou_proposal"] = check_iou(torch, "proposals 8x632x32", cand, gt, gmask, False)
    # ROIAlign backward at the head's training shape: 8 x 128 rois on [38, 38, 256]
    rois = torch.from_numpy(rand_boxes(rng, (b, 128), 600, 300) * (FEAT[0] / 600)).to(dev)
    rois[:, :4] = torch.tensor([[-0.9, -0.9, 3.0, 3.0], [35.0, 34.0, 40.0, 41.0],
                                [2.2, 2.2, 2.2, 2.2], [-5.0, -5.0, -2.0, -1.5]], device=dev)
    g = torch.from_numpy(rng.normal(0, 1, (b, 128, 7, 7, FEAT[2])).astype(np.float32)).to(dev)
    shape = (b,) + FEAT
    res["roi_bwd_f32"] = check_roi_bwd(torch, f"f32 8x128 {list(FEAT)}", g, rois, shape,
                                       torch.float32)
    res["roi_bwd_bf16"] = check_roi_bwd(torch, f"bf16 8x128 {list(FEAT)}", g, rois, shape,
                                        torch.bfloat16)
    # the main path's: a bfloat16 gradient from the bfloat16 crops
    g16 = g.to(torch.bfloat16)
    res["roi_bwd_bf16_grad"] = check_roi_bwd(torch, f"bf16 grad 8x128 {list(FEAT)}", g16, rois,
                                             shape, torch.bfloat16)
    # 128 identical rois per image: every roi adds to the same pixels
    same = torch.tensor([5.3, 7.1, 30.2, 33.9], device=dev).expand(b, 128, 4).contiguous()
    res["roi_bwd_identical"] = check_roi_bwd(torch, "bf16 grad 8x128 identical rois", g16, same,
                                             shape, torch.bfloat16)
    res.update(check_int8_kernels(torch, rng, dev))
    return res


def time_stages(torch, model, cfg, images):
    """Median CUDA-event ms of each stage of one flush's program on a batch."""
    from replication_faster_rcnn_tpu_torch.eval.detect import batched_decode

    h, w = float(images.shape[1]), float(images.shape[2])
    with torch.inference_mode():
        feat = model.extract_features(images)
        logits, deltas, anchors = model.rpn_forward(feat)
        rois, valid = model.propose(logits, deltas, anchors, h, w)
        cls, reg = model.head_forward(feat, rois, h, w)
        steps = {
            "trunk": lambda: model.extract_features(images),
            "rpn_head": lambda: model.rpn_forward(feat),
            "proposals": lambda: model.propose(logits, deltas, anchors, h, w),
            "detection_head": lambda: model.head_forward(feat, rois, h, w),
            "decode": lambda: batched_decode(rois, valid, cls, reg, h, w, cfg.eval,
                                             cfg.roi_targets),
        }
        return {name: time_ms(torch, fn, 5) for name, fn in steps.items()}


def mixed_images(rng):
    shapes = [(375, 500), (480, 640), (600, 600), (500, 375),
              (375, 500), (480, 640), (600, 600), (600, 450)]
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


def phase_serve(torch):
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config, ops
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
    from replication_faster_rcnn_tpu_torch.ops.cuda import nms_kernel, roi_kernel
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    cfg = get_config("voc12_resnet18_align")
    size = cfg.data.image_size
    log(f"[4] main path: voc12_resnet18_align {size} via InferenceEngine, params bfloat16")
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, resolutions=(size,), batch_sizes=(1, 8), params_dtype="bfloat16"))
    rng = np.random.default_rng(1)
    one = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    eight = mixed_images(rng)
    with InferenceEngine(cfg, seed=0) as engine:
        log(f"  engine on {engine.device}, params {engine.params_bytes / 2**20:.1f} MiB "
            f"in {engine.params_dtype}, buckets {engine.buckets} x {engine.batch_sizes}")
        engine.predict(eight)  # warm-up: cuDNN handles and algorithm choice
        engine.submit(one).result(timeout=300)

        nms_kernel.launches = 0
        roi_kernel.launches = 0
        log0 = len(engine.flush_log)
        r1 = engine.submit(one).result(timeout=300)
        r8 = engine.predict(eight)
        launches = {"nms": nms_kernel.launches, "roi_align": roi_kernel.launches}
        flushes = engine.flush_log[log0:]
        log(f"  launches in the main-path run: {launches}; flushes {flushes}")
        if flushes != [((size, False), 1), ((size, False), 8)]:
            raise AssertionError(f"expected one b1 and one b8 flush, got {flushes}")
        if launches["nms"] != 4 or launches["roi_align"] != 2:
            raise AssertionError(f"expected 4 NMS and 2 ROIAlign launches, got {launches}")

        for res, img in zip([r1] + r8, [one] + eight):
            if res["boxes"].shape != (cfg.eval.max_detections, 4):
                raise AssertionError(f"bad boxes shape {res['boxes'].shape}")
            if not (np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()):
                raise AssertionError("non-finite detections")
            h, w = img.shape[:2]
            if (res["boxes"][:, 0::2] > h + 1e-3).any() or (res["boxes"][:, 1::2] > w + 1e-3).any():
                raise AssertionError("boxes outside the original image")
        n_det = [int(r["valid"].sum()) for r in [r1] + r8]
        if sum(n_det) == 0:
            raise AssertionError("no detections at all: the detection NMS saw no candidates")
        log(f"  detections per image (b1, then b8): {n_det}")

        # the same requests through the plain versions: every output equal
        ref1 = engine.submit(one, reference=True).result(timeout=600)
        ref8 = engine.predict(eight, reference=True)
        for got, want in zip([r1] + r8, [ref1] + ref8):
            for k in got:
                if not np.array_equal(got[k], want[k]):
                    raise AssertionError(f"main path output {k!r} differs from the plain run")
        batch = torch.zeros((8,) + size + (3,), device=engine.device)
        for i, img in enumerate(eight):
            batch[i] = torch.from_numpy(resize_normalize(
                img, size, cfg.data.pixel_mean, cfg.data.pixel_std))
        with torch.inference_mode():
            k_out = engine.model(batch)
            with ops.reference_scope():
                p_out = engine.model(batch)
        names = ("rpn_logits", "rpn_deltas", "rois", "roi_valid", "cls", "reg")
        for name, a, b in zip(names, k_out, p_out):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} differs between kernel and plain passes")
        log("  kernel pass == plain pass: rois, valid, cls, reg and all detections bitwise")

        stages = {f"b{n}": time_stages(torch, engine.model, cfg, batch[:n]) for n in (1, 8)}
        t0 = time.perf_counter()
        for img in eight:
            resize_normalize(img, size, cfg.data.pixel_mean, cfg.data.pixel_std)
        resize_ms = (time.perf_counter() - t0) * 1e3 / len(eight)
        log(f"  stage ms (CUDA events, median of 5): {json.dumps(stages)}")
        log(f"  host resize_normalize: {resize_ms:.2f} ms per image (numpy)")

        lat = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            engine.submit(one).result(timeout=300)
            lat.append((time.perf_counter() - t0) * 1e3)
        b8 = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            engine.predict(eight)
            b8.append(time.perf_counter() - t0)
        flush = list(engine.flush_seconds)[-2 * REPS:]  # REPS b1 flushes, then REPS b8
        serve = {
            "b1_latency_ms": statistics.median(lat),
            "b1_latency_note": f"submit->result, includes serving.max_delay_ms={cfg.serving.max_delay_ms}",
            "b1_flush_ms": statistics.median(flush[:REPS]) * 1e3,
            "b8_images_per_s": 8 / statistics.median(b8),
            "b8_flush_ms": statistics.median(flush[REPS:]) * 1e3,
            "b8_note": "predict(8 mixed-size uint8 images): host resize + one b8 flush",
            "stage_ms": stages,
            "host_resize_ms_per_image": resize_ms,
        }
    log(f"  b1 latency {serve['b1_latency_ms']:.2f} ms (median of {REPS}, incl. "
        f"{cfg.serving.max_delay_ms} ms batching delay), b1 flush {serve['b1_flush_ms']:.2f} ms; "
        f"b8 {serve['b8_images_per_s']:.1f} images/s end to end, b8 flush "
        f"{serve['b8_flush_ms']:.2f} ms")
    return launches, serve


def expected_int8_launches(artifact):
    """(GEMMs, dequantizes) per flush under the artifact's plan: the head's
    cls/reg layers run the GEMM when the head group stays int8; every other
    int8 weight is dequantized once."""
    from replication_faster_rcnn_tpu_torch.quant import QUANT_DENSE_PATHS

    dense = {"/".join(p) for p in QUANT_DENSE_PATHS}
    planned = [p for g, ps in artifact["groups"].items() if artifact["plan"][g] == "int8"
               for p in ps]
    gemm = sum(p in dense for p in planned)
    return gemm, len(planned) - gemm


def phase_int8_serve(torch, bf16, cfg=None, device=None):
    """``bf16``: phase [4]'s serving numbers, printed beside these.
    ``cfg``/``device`` default to the full configuration on the card (a CPU
    rehearsal passes a small configuration and ``"cpu"``)."""
    import dataclasses
    import gc

    from replication_faster_rcnn_tpu_torch import get_config, quant
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
    from replication_faster_rcnn_tpu_torch.ops.cuda import nms_kernel, quant_kernel, roi_kernel
    from replication_faster_rcnn_tpu_torch.quant.calibrate import activation_ranges
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    cfg = cfg or get_config("voc12_resnet18_align")
    dev = torch.device(device or "cuda")
    size = cfg.data.image_size
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, resolutions=(size,), batch_sizes=(1, 8), params_dtype="int8"))
    qc = cfg.quant
    log(f"[5] main path: voc12_resnet18_align {size} via InferenceEngine, params int8")

    # calibration and the sensitivity sweep on the card, from the seeded
    # float32 weights the bfloat16 engine of [4] served
    model = build_model(cfg, device=dev, seed=0)
    state = model.state_dict()
    batches = quant.synthetic_calibration_batches(cfg, qc.calib_batches, qc.calib_batch_size)
    t0 = time.perf_counter()
    artifact = quant.calibrate(model, state, batches, cfg)
    artifact = quant.sweep(model, state, artifact, batches, cfg)
    calib_s = time.perf_counter() - t0
    recon = {g: round(r["recon_rel_err"], 5) for g, r in artifact["sensitivity"].items()}
    log(f"  calibrate + sweep ({qc.calib_batches} x {qc.calib_batch_size} synthetic images): "
        f"{calib_s:.2f} s; embed range {artifact['activation_ranges']}; recon rel err {recon}; "
        f"plan {artifact['plan']}")
    # the range the served (normalized) images give, beside the calibrated
    # one: the synthetic calibration images are un-normalized [0, 255) pixels
    rng = np.random.default_rng(1)  # the requests of [4]
    one = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    eight = mixed_images(rng)
    served = np.stack([resize_normalize(img, size, cfg.data.pixel_mean, cfg.data.pixel_std)
                       for img in eight])
    served_range = activation_ranges(model, state, [served])[quant.EMBED_RANGE_KEY]
    log(f"  embed range of the 8 served images (normalized): {served_range}")
    path = REPO / "build" / "quant_artifact.json"
    quant.save_artifact(str(path), artifact)
    log(f"  sidecar: {path.relative_to(REPO)} ({path.stat().st_size} bytes, CRC-checked on load)")
    gemm, deq = expected_int8_launches(artifact)
    if gemm == 0 or deq == 0:
        raise AssertionError(f"the sweep's plan {artifact['plan']} leaves no int8 GEMM or no "
                             "dequantize on the main path")
    f32_bytes = sum(t.numel() * 4 for t in state.values())
    state = {k: v.cpu() for k, v in state.items()}
    del model
    gc.collect()

    def allocated_by(make):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        obj = make()
        torch.cuda.synchronize()
        return obj, torch.cuda.memory_allocated() - base

    bf16_cfg = cfg.replace(serving=dataclasses.replace(cfg.serving, params_dtype="bfloat16"))
    eng, bf16_alloc = allocated_by(lambda: InferenceEngine(bf16_cfg, device=dev, state_dict=state))
    eng.close()
    del eng
    engine, int8_alloc = allocated_by(
        lambda: InferenceEngine(cfg, device=dev, state_dict=state, artifact_path=str(path)))
    with engine:
        log(f"  engine on {engine.device}: resident int8 tree {engine.params_bytes} bytes "
            f"({engine.params_bytes / f32_bytes:.4f} of the float32 weights' {f32_bytes}); "
            f"device memory after construction {int8_alloc} bytes against the bfloat16 "
            f"engine's {bf16_alloc}")
        if not engine.params_bytes < 0.4 * f32_bytes:
            raise AssertionError(f"int8 params {engine.params_bytes} >= 0.4 x {f32_bytes}")
        if not int8_alloc < bf16_alloc:
            raise AssertionError(f"int8 engine holds {int8_alloc} bytes, bf16 {bf16_alloc}")
        engine.predict(eight)  # warm-up: cuDNN handles and algorithm choice
        engine.submit(one).result(timeout=300)

        counters = (("int8_matmul", quant_kernel, "matmul_launches"),
                    ("dequantize", quant_kernel, "dequantize_launches"),
                    ("nms", nms_kernel, "launches"), ("roi_align", roi_kernel, "launches"))

        def reset():
            for _, mod, attr in counters:
                setattr(mod, attr, 0)

        def read():
            return {name: getattr(mod, attr) for name, mod, attr in counters}

        want = {"int8_matmul": gemm, "dequantize": deq, "nms": 2, "roi_align": 1}
        log0 = len(engine.flush_log)
        reset()
        r1 = engine.submit(one).result(timeout=300)
        per_b1 = read()
        reset()
        r8 = engine.predict(eight)
        per_b8 = read()
        launches = {k: per_b1[k] + per_b8[k] for k in per_b1}
        flushes = engine.flush_log[log0:]
        log(f"  launches in the main-path run: b1 flush {per_b1}, b8 flush {per_b8}; "
            f"flushes {flushes}")
        if flushes != [((size, False), 1), ((size, False), 8)]:
            raise AssertionError(f"expected one b1 and one b8 flush, got {flushes}")
        if per_b1 != want or per_b8 != want:
            raise AssertionError(f"expected per flush {want}, got {per_b1} and {per_b8}")
        for res, img in zip([r1] + r8, [one] + eight):
            if res["boxes"].shape != (cfg.eval.max_detections, 4):
                raise AssertionError(f"bad boxes shape {res['boxes'].shape}")
            if not (np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()):
                raise AssertionError("non-finite detections")
            h, w = img.shape[:2]
            if (res["boxes"][:, 0::2] > h + 1e-3).any() or (res["boxes"][:, 1::2] > w + 1e-3).any():
                raise AssertionError("boxes outside the original image")
        n_det = [int(r["valid"].sum()) for r in [r1] + r8]
        if sum(n_det) == 0:
            raise AssertionError("no detections at all: the detection NMS saw no candidates")
        log(f"  detections per image (b1, then b8): {n_det}")

        ref1 = engine.submit(one, reference=True).result(timeout=600)
        ref8 = engine.predict(eight, reference=True)
        for got, plain in zip([r1] + r8, [ref1] + ref8):
            for k in got:
                if not np.array_equal(got[k], plain[k]):
                    raise AssertionError(f"int8 output {k!r} differs from the plain run")
        log("  kernel pass == plain pass: every int8 detection bitwise")

        lat = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            engine.submit(one).result(timeout=300)
            lat.append((time.perf_counter() - t0) * 1e3)
        b8 = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            engine.predict(eight)
            b8.append(time.perf_counter() - t0)
        flush = list(engine.flush_seconds)[-2 * REPS:]
        serve = {
            "b1_latency_ms": statistics.median(lat),
            "b1_flush_ms": statistics.median(flush[:REPS]) * 1e3,
            "b8_images_per_s": 8 / statistics.median(b8),
            "b8_flush_ms": statistics.median(flush[REPS:]) * 1e3,
            "params_bytes": engine.params_bytes,
            "f32_params_bytes": f32_bytes,
            "device_bytes_after_construction": int8_alloc,
            "bf16_device_bytes_after_construction": bf16_alloc,
            "calibrate_and_sweep_s": calib_s,
            "embed_range_calibrated": artifact["activation_ranges"][quant.EMBED_RANGE_KEY],
            "embed_range_served": served_range,
            "plan": artifact["plan"],
            "recon_rel_err": recon,
            "launches_per_flush": want,
            "bf16_same_run": {k: bf16[k] for k in ("b1_latency_ms", "b1_flush_ms",
                                                   "b8_images_per_s", "b8_flush_ms")},
        }
    log(f"  int8: b1 latency {serve['b1_latency_ms']:.2f} ms (bf16 {bf16['b1_latency_ms']:.2f}), "
        f"b1 flush {serve['b1_flush_ms']:.2f} ms (bf16 {bf16['b1_flush_ms']:.2f}); b8 "
        f"{serve['b8_images_per_s']:.1f} images/s (bf16 {bf16['b8_images_per_s']:.1f}), b8 flush "
        f"{serve['b8_flush_ms']:.2f} ms (bf16 {bf16['b8_flush_ms']:.2f})")
    return launches, serve


class StageTimer:
    """stage(name) context manager recording CUDA events; ms() sums them by
    name after a synchronize."""

    def __init__(self, torch):
        self.torch = torch
        self.events = []

    def __call__(self, name):
        timer = self

        class _Span:
            def __enter__(self):
                self.start = timer.torch.cuda.Event(enable_timing=True)
                self.start.record()

            def __exit__(self, *exc):
                end = timer.torch.cuda.Event(enable_timing=True)
                end.record()
                timer.events.append((name, self.start, end))
                return False

        return _Span()

    def ms(self):
        self.torch.cuda.synchronize()
        out = {}
        for name, start, end in self.events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


NMS_KERNELS = ("nms_mask_kernel", "nms_walk_kernel")
ROI_KERNELS = {"forward": "roi_align_kernel", "backward": "roi_align_bwd_kernel"}


def device_timeline(torch, run, steps):
    """torch.profiler over ``run`` (``steps`` training steps): the device's
    busy time (union of kernel and copy intervals), the span from its first
    to its last activity, the idle share of that span, the kernels with the
    most device time, the NMS kernels' device ms per step (mask and walk
    apart and summed) and the ROIAlign kernels' (forward and backward). None
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]  # kernels and copies
    if not acts:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in acts)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    span = max(e for _, e in spans) - spans[0][0]
    by_name = {}
    for e in acts:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    def per_step(kernel):
        return sum(us for name, us in by_name.items() if kernel in name) / 1e3 / steps

    nms = {k: per_step(k) for k in NMS_KERNELS}
    return {
        "nms_device_ms_per_step": sum(nms.values()),
        "nms_device_ms_per_step_by_kernel": nms,
        "roi_align_device_ms_per_step": {k: per_step(v) for k, v in ROI_KERNELS.items()},
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_span_ms_per_step": span / 1e3 / steps,
        "device_idle_share": 1.0 - busy / span,
        "device_activities_per_step": len(acts) / steps,
        "top_device_ms_per_step": {name[:90]: us / 1e3 / steps for name, us in top},
    }


def phase_train(torch, cfg=None, device=None):
    """``cfg``/``device`` default to the full configuration on the card (a
    CPU rehearsal passes a small configuration and ``"cpu"``)."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config, ops
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
    from replication_faster_rcnn_tpu_torch.ops.cuda import iou_kernel, nms_kernel, roi_kernel
    from replication_faster_rcnn_tpu_torch.train.train_step import compute_losses
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = cfg or get_config("voc12_resnet18_align")
    bsz = cfg.train.batch_size
    log(f"[6] main path: train voc12_resnet18_align {cfg.data.image_size} batch {bsz}, "
        f"compute {cfg.model.compute_dtype}, {cfg.proposals.pre_nms_train} -> "
        f"{cfg.proposals.post_nms_train} proposals, Adam lr {cfg.train.lr}")
    dataset = SyntheticDataset(cfg.data, length=2 * bsz)
    trainer = Trainer(cfg, dataset, device=device, seed=0)
    batches = [trainer.stage_batch(b) for b in trainer.batches(0)]
    model, state = trainer.model, trainer.state
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  trainer on {trainer.device}, {n_params / 1e6:.2f} M parameters (float32), "
        f"{trainer.steps_per_epoch} steps per epoch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2):  # warm-up: cuDNN handles and algorithm choice
        m = trainer.train_one_batch(next(trainer.batches(0)))
    log(f"  warm-up: 2 steps in {time.perf_counter() - t0:.2f} s, losses "
        f"{ {k: round(m[k], 4) for k in ('rpn_cls_loss', 'rpn_reg_loss', 'head_cls_loss', 'head_reg_loss')} }")

    counters = (nms_kernel, iou_kernel, roi_kernel)
    for mod in counters:
        mod.launches = 0
    roi_kernel.backward_launches = 0
    step_ms, history = [], []
    for i in range(TRAIN_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = trainer.step_fn(state, batches[i % len(batches)])
        end.record()
        history.append({k: float(v) for k, v in metrics.items()})
        step_ms.append(start.elapsed_time(end))
    launches = {"nms": nms_kernel.launches, "iou_match": iou_kernel.launches,
                "roi_align": roi_kernel.launches, "roi_align_bwd": roi_kernel.backward_launches}
    log(f"  launches in {TRAIN_REPS} timed steps: {launches}")
    want = {"nms": 1, "iou_match": 2, "roi_align": 1, "roi_align_bwd": 1}
    if launches != {k: v * TRAIN_REPS for k, v in want.items()}:
        raise AssertionError(f"expected per step {want}, got {launches} over {TRAIN_REPS} steps")
    for row in history:
        bad = [k for k in ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss",
                           "head_reg_loss", "grad_norm") if not np.isfinite(row[k])]
        if bad or row["skipped"] != 0.0:
            raise AssertionError(f"non-finite training metrics {bad} (skipped {row['skipped']})")
    log("  losses per step: " + ", ".join(f"{r['loss']:.4f}" for r in history))

    # per-stage ms of one more step, CUDA events around each stage
    timer = StageTimer(torch)
    trainer.step_fn(state, batches[0], stage=timer)
    stages = timer.ms()
    log(f"  stage ms (one step, CUDA events): { {k: round(v, 3) for k, v in stages.items()} }")

    # the device timeline of 3 more steps (torch.profiler)
    def three_steps():
        for i in range(3):
            trainer.step_fn(state, batches[i % len(batches)])

    timeline = device_timeline(torch, three_steps, 3)
    if timeline is None:
        log("  device timeline: the profiler saw no device activity (not measured)")
    else:
        log(f"  device timeline (torch.profiler, 3 steps): busy "
            f"{timeline['device_busy_ms_per_step']:.2f} ms of a "
            f"{timeline['device_span_ms_per_step']:.2f} ms span per step, idle share "
            f"{timeline['device_idle_share']:.3f}, "
            f"{timeline['device_activities_per_step']:.0f} device activities per step")
        log(f"  most device time per step: "
            f"{ {k: round(v, 3) for k, v in timeline['top_device_ms_per_step'].items()} }")
        by_kernel = timeline["nms_device_ms_per_step_by_kernel"]
        log(f"  NMS device time per step: {timeline['nms_device_ms_per_step']:.4f} ms "
            f"({ {k: round(v, 4) for k, v in by_kernel.items()} })")
        if not timeline["nms_device_ms_per_step"] > 0:
            raise AssertionError("the profiler saw device activity but no NMS kernel")
        roi_ms = timeline["roi_align_device_ms_per_step"]
        log(f"  ROIAlign device time per step: forward {roi_ms['forward']:.4f} ms, backward "
            f"{roi_ms['backward']:.4f} ms")
        if not (roi_ms["forward"] > 0 and roi_ms["backward"] > 0):
            raise AssertionError("the profiler saw device activity but no ROIAlign kernel")

    # the same state and draws: kernel pass vs plain pass (forward + backward)
    batch = batches[1]
    params = list(model.parameters())

    def pass_(reference, draws, weights=None):
        c = cfg if weights is None else cfg.replace(
            train=dataclasses.replace(cfg.train, loss_weights=weights))
        model.zero_grad(set_to_none=True)
        record = {}
        with ops.reference_scope(reference):
            total, (metrics, stats) = compute_losses(model, c, batch, state.generator, draws,
                                                     record)
            total.backward()
        grads = [None if p.grad is None else p.grad.detach().clone() for p in params]
        stats = [(mean.clone(), var.clone()) for _, (mean, var) in stats]
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.pending_stats = None
        return metrics, record, grads, stats

    km, krec, kgrads, kstats = pass_(False, None)
    before = (nms_kernel.launches, iou_kernel.launches, roi_kernel.launches,
              roi_kernel.backward_launches)
    pm, prec, pgrads, pstats = pass_(True, krec["draws"])
    after = (nms_kernel.launches, iou_kernel.launches, roi_kernel.launches,
             roi_kernel.backward_launches)
    if before != after:
        raise AssertionError("a kernel launched inside reference_scope")
    for k, v in krec["targets"].items():
        if not torch.equal(v, prec["targets"][k]):
            raise AssertionError(f"target {k!r} differs between the kernel and plain passes")
    for k in ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss",
              "n_pos_rpn", "n_pos_head"):
        if not torch.equal(km[k], pm[k]):
            raise AssertionError(f"{k} differs: kernel {float(km[k])} plain {float(pm[k])}")
    if not all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(kstats, pstats)):
        raise AssertionError("new BatchNorm statistics differ between the kernel and plain passes")
    grad_err = 0.0
    for p_k, p_p in zip(kgrads, pgrads):
        if (p_k is None) != (p_p is None):
            raise AssertionError("a parameter has a gradient in one pass only")
        if p_k is not None:
            denom = float(p_p.float().norm())
            err = float((p_k.float() - p_p.float()).norm()) / max(denom, 1e-30)
            grad_err = max(grad_err, err)
    if grad_err > GRAD_RTOL:
        raise AssertionError(f"gradients differ by relative L2 {grad_err} > {GRAD_RTOL}")
    log(f"  kernel pass == plain pass (same state and draws): targets, labels, 4 losses and "
        f"BatchNorm statistics bitwise; gradients max relative L2 error {grad_err:.3e} "
        f"(tolerance {GRAD_RTOL})")
    # the head's losses alone reach the trunk through the ROIAlign kernels
    _, _, hgrads, _ = pass_(False, krec["draws"], (0.0, 0.0, 1.0, 1.0))
    trunk = hgrads[[n for n, _ in model.named_parameters()].index("trunk.conv1.weight")]
    if trunk is None or not float(trunk.abs().sum()) > 0:
        raise AssertionError("the head's losses gave the trunk no gradient")
    model.zero_grad(set_to_none=True)
    log("  the head's losses alone give the trunk a gradient (ROIAlign forward + backward kernels)")

    med = statistics.median(step_ms)
    train = {
        "step_ms": med,
        "images_per_s": bsz / med * 1e3,
        "step_ms_all": step_ms,
        "stage_ms": stages,
        "device_timeline": timeline,
        "losses_first_last": [history[0]["loss"], history[-1]["loss"]],
        "grad_max_rel_l2_err_vs_plain": grad_err,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"  train step {med:.2f} ms (median of {TRAIN_REPS}, CUDA events, batch staged on the "
        f"card), {train['images_per_s']:.1f} images/s")
    return launches, train


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from replication_faster_rcnn_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch: {name} | torch {torch.__version__} CUDA {torch.version.cuda}")
    log("    TF32 off (matmul and cuDNN), cuDNN deterministic")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[2] nvcc build of {list(build.SOURCES)}: {time.perf_counter() - t0:.1f} s "
        f"(per source since start: { {k: round(v, 1) for k, v in built.items()} })")
    for src in build.SOURCES:
        report = build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {src}: {line.strip()}")

    res = phase_kernels(torch)
    launches, serve = phase_serve(torch)
    qlaunches, serve_int8 = phase_int8_serve(torch, serve)
    tlaunches, train = phase_train(torch)

    nms, det, roi = res["nms_proposal"], res["nms_detection"], res["roi_bf16"]
    nms_tr, nms_cl, bwd = res["nms_train"], res["nms_train_clustered"], res["roi_bwd_bf16"]
    in_step = (train["device_timeline"] or {}).get("roi_align_device_ms_per_step", {})
    iou_a, iou_p = res["iou_anchor"], res["iou_proposal"]
    gemm, deq = res["gemm_b8_cls"], res["dequant_f32"]
    timing = ("ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        {
            "name": "nms_mask_walk", "route": "cuda", "source": NMS_SRC, "replaces": NMS_TPU,
            "kernels": list(NMS_KERNELS),
            "note": "one call = the card-wide IoU bitmask kernel + the per-image greedy walk; "
                    "ms, launches and bound cover both",
            "launches": launches["nms"] + qlaunches["nms"] + tlaunches["nms"],
            "launches_by_path": {"serve": launches["nms"], "serve_int8": qlaunches["nms"],
                                 "train": tlaunches["nms"]},
            "parity": "bitwise vs nms_fixed_tiled (proposal, detection, clustered, training, "
                      "clustered training)",
            "max_abs_err": max(r["max_abs_err"] for k, r in res.items() if k.startswith("nms")),
            "ms": nms["ms"], "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
            "bound_by": nms["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": "proposal: 8 x 3000 sorted -> 300, thr 0.7",
            "detection_site": {k: det[k] for k in timing},
            "training_site": {k: nms_tr[k] for k in timing},
            "training_site_clustered": {k: nms_cl[k] for k in timing},
            "outside_kernels_ms": {"proposal": nms["prep_ms"], "detection": det["prep_ms"],
                                   "training": nms_tr["prep_ms"],
                                   "training_clustered": nms_cl["prep_ms"]},
            "train_step_device_ms": None if train["device_timeline"] is None
            else train["device_timeline"]["nms_device_ms_per_step"],
        },
        {
            "name": "roi_align_fwd", "route": "cuda", "source": ROI_SRC, "replaces": ROI_TPU,
            "launches": launches["roi_align"] + qlaunches["roi_align"] + tlaunches["roi_align"],
            "launches_by_path": {"serve": launches["roi_align"],
                                 "serve_int8": qlaunches["roi_align"],
                                 "train": tlaunches["roi_align"]},
            "parity": "bitwise vs roi_align(method='gather') cast to the output dtype; "
                      "float32 outputs vs einsum within atol 2e-5 rtol 1e-5",
            "max_abs_err": max(r["max_abs_err"] for k, r in res.items()
                               if k.startswith("roi_") and not k.startswith("roi_bwd")),
            "max_abs_err_vs_einsum": max(r["max_abs_err_vs_einsum"] for k, r in res.items()
                                         if r.get("max_abs_err_vs_einsum") is not None),
            "ms": roi["ms"], "plain_ms": roi["plain_ms"], "bound_ms": roi["bound_ms"],
            "bound_by": roi["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": "bf16 feat 8 x [38, 38, 256], 300 rois, 7x7, s=2 -> f32",
            "f32": {k: res["roi_f32"][k] for k in timing},
            "bf16_out": {k: res["roi_bf16_out"][k] for k in timing},
            "b1_bf16_out": {k: res["roi_b1_bf16_out"][k]
                            for k in timing + ("one_block_per_roi_ms",)},
            "train_f32": {k: res["roi_train_f32"][k] for k in timing},
            "train_bf16_out": {k: res["roi_train_bf16_out"][k] for k in timing},
            "train_step_device_ms": in_step.get("forward"),
        },
        {
            "name": "roi_align_bwd", "route": "cuda", "source": ROI_SRC, "replaces": ROI_BWD_TPU,
            "replaces_note": ROI_BWD_NOTE,
            "launches": tlaunches["roi_align_bwd"],
            "launches_by_path": {"train": tlaunches["roi_align_bwd"]},
            "parity": f"vs roi_ops.roi_align_backward: {ROI_BWD_TOL} (the same terms grouped "
                      "by bin and summed in float32 in another order); two launches bitwise "
                      "equal (deterministic, no atomics)",
            "max_abs_err": max(r["max_abs_err"] for k, r in res.items()
                               if k.startswith("roi_bwd")),
            "ms": bwd["ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
            "bound_by": bwd["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": "grad [8, 128, 7, 7, 256] f32 -> bf16 grad_feat 8 x [38, 38, 256], s=2",
            "f32": {k: res["roi_bwd_f32"][k] for k in timing},
            "bf16_grad": {k: res["roi_bwd_bf16_grad"][k] for k in timing},
            "identical_rois": {k: res["roi_bwd_identical"][k] for k in timing},
            "train_step_device_ms": in_step.get("backward"),
        },
        {
            "name": "iou_match", "route": "cuda", "source": IOU_SRC, "replaces": IOU_TPU,
            "launches": tlaunches["iou_match"],
            "launches_by_path": {"train": tlaunches["iou_match"]},
            "parity": "bitwise vs ops/iou_match.py::match_boxes (iou, argmax, max, column argmax)",
            "max_abs_err": 0.0,
            "ms": iou_a["ms"], "plain_ms": iou_a["plain_ms"], "bound_ms": iou_a["bound_ms"],
            "bound_by": iou_a["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": "anchor site: 12996 anchors vs 8 x 32 gt, with the column argmax",
            "proposal_site": {k: iou_p[k] for k in timing},
        },
        {
            "name": "int8_matmul", "route": "cuda", "source": QUANT_SRC, "replaces": GEMM_TPU,
            "launches": qlaunches["int8_matmul"],
            "launches_by_path": {"serve_int8": qlaunches["int8_matmul"]},
            "parity": "bitwise vs ops/quant_ops.py::int8_matmul_plain (exact float64 product)",
            "max_abs_err": 0.0,
            **{k: gemm[k] for k in timing + ("library_ms",)},
            "library_note": "torch._int_mm with the weight padded to N = 24 (it needs N a "
                            "multiple of 8); the padding is outside the timed call",
            "shape": "b8 cls: [2400, 512] x [512, 21] int8 -> int32",
            "sites": {k: {f: res[k][f] for f in timing + ("library_ms",)}
                      for k in ("gemm_b8_reg", "gemm_b1_cls", "gemm_b1_reg")},
        },
        {
            "name": "dequantize", "route": "cuda", "source": QUANT_SRC, "replaces": DEQUANT_TPU,
            "launches": qlaunches["dequantize"],
            "launches_by_path": {"serve_int8": qlaunches["dequantize"]},
            "parity": "bitwise vs ops/quant_ops.py::dequantize_plain on all 23 conv weights, "
                      "float32 and bfloat16 outputs",
            "max_abs_err": 0.0,
            **{k: deq[k] for k in timing + ("library_ms",)},
            "library_note": "torch.mul(w_q, scale) (int8 x float32 promotes to float32)",
            "shape": "layer4 conv [512, 512, 3, 3] int8 -> float32 (the Pallas kernel's output)",
            "main_path_bfloat16": {k: res["dequant_bf16"][k] for k in timing},
            "per_flush_bfloat16": res["dequant_flush"],
        },
    ]
    log(json.dumps({"serve": serve, "serve_int8": serve_int8, "train": train, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
