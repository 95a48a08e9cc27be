#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``replication_faster_rcnn_tpu_torch``).

Run from the repository root with no arguments on a machine with one NVIDIA
H100:  ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every CUDA kernel from ``replication_faster_rcnn_tpu_torch/csrc``
   with nvcc for sm_90a (into ``build/torch_kernels/``) and prints the time;
3. holds each kernel against its plain PyTorch version on the card at the
   serving and training paths' shapes and times both: NMS bitwise (serving
   8 x 3000 -> 300 and 8 x 6300 -> 100, the flip-TTA decode's 8 x 12600 ->
   100, training 8 x 12000 -> 600 on random boxes and on clustered boxes,
   which overlap like the step's proposals);
   ROIAlign forward bitwise against its gather twin (cast to the output
   dtype) at serving 8 x 300 and 1 x 300 and training 8 x 128 rois, float32
   and bfloat16 features and outputs, and within atol 2e-5 / rtol 1e-5 of
   the einsum formulation for float32 outputs; IoU matching bitwise in all four
   outputs, two launches bitwise equal and one launch per call, at the anchor
   site (8 x 12996 anchors x 32 gt, and x 64 gt), the proposal site (8 x 632
   x 32) and with exact ties across lanes, warps and blocks; ROIAlign
   backward (8 x 128 rois on [38, 38, 256]) within atol 1e-4 / rtol 1e-5 in
   float32 and one bfloat16 ulp in bfloat16
   of the plain scatter (the kernel groups the same terms by bin and sums
   in float32 in another order), from float32 and bfloat16 gradients, and
   bitwise equal across two launches, also with 128 identical rois per
   image; the int8 GEMM bitwise at every int8 preset's cls/reg shapes
   ([300 or 2400, K] x [K, N], K 512 / 1024 / 2048 / 4096 and N 21 / 84 or
   81 / 324, ``INT8_HEADS``) and the dequantize bitwise on all
   23 conv weights of the model, into float32 and bfloat16, one by one and
   all at once in one grouped launch (``dequantize_many``, timed beside the
   per-leaf loop; then one flush's weights of ``voc_resnet50_fpn``,
   ``voc_resnet50`` and ``coco_vgg16``, up to 136,644,288 elements), with
   the library calls ``torch._int_mm`` and ``torch.mul`` timed beside them; ROIPool forward bitwise against the
   plain masked maxes at serving 8 x 300 and 1 x 300 and training 8 x 128
   rois, float32 and bfloat16, integer-valued features (exact ties) and
   maps with NaN and +-inf, and its backward (8 x 128) bitwise across two
   launches and within ``ROI_POOL_BWD`` of the plain VJP on float32 copies,
   both also on clustered rois that overlap like the train step's proposals
   (with the backward's scratch bytes per call, measured). Then capture
   safety: one launch of each wrapper (NMS, ROIAlign forward and backward,
   ROIPool forward and backward, IoU matching, the int8 GEMM, the
   dequantize and the grouped dequantize) captured in a CUDA graph on a
   side stream after one warm-up call there, and replayed twice with its
   outputs overwritten before each replay: bitwise equal to the eager
   launch, and the IoU kernel's column state zero after each replay. Then
   the data path's four kernels (``csrc/image_kernel.cu``) at 600x600, b8
   and b16, uint8 and float32 (:func:`check_image_kernels`): the prepare
   launch (geometry + fills, a thread block cluster per image), the
   geometry alone and the image pass of ``augment_batch`` on four row mixes
   (flip beside identity rows, translation +-0.1, scale 0.75-1.25, all
   three) against their plain versions (geometry, boxes and uint8 fills
   bitwise, float32 fills within 1 ulp and bitwise across launches, the
   geometry also against the numpy oracle; G = 100 too; images bitwise in
   uint8, within 1e-6 relative in float32), the cache gather from a
   1,024-image cache (an idx repeating a row too)
   (the image kernel timed alone and the whole ``materialize_batch``), two
   pure copies bitwise the one PyTorch call that computes each (every row
   flipped: ``torch.flip``; the identity gather: ``torch.index_select``,
   timed beside the kernel), the bucket resample 600->480, 600->720 and
   600->240 bitwise against the plain band passes with
   ``F.interpolate(antialias=True)`` timed beside it, and each captured and
   replayed twice, bitwise. Then the FPN's multi-level
   ROIAlign (:func:`check_multilevel_kernels`) at the 600x600 pyramid (P2
   150x150 .. P5 19x19, 256 channels): the forward bitwise its plain
   version (``models/fpn.py::multilevel_roi_align_plain``, the JAX ``flat``
   op by op) at serving 8 x 300 and 1 x 300 (bf16 -> bf16, f32 -> f32),
   training 8 x 128, rois at the level-boundary areas, clustered rois,
   elongated rois (about 600 x 20 and 20 x 600 image pixels), 128 rois
   about one spot (more than 32 in a backward tile, every one on P2) and
   1 x 1000 rois; the backward at 8 x 128, 8 x 300 and 1 x 1000 twice
   bitwise and within ``ROI_BWD_TOL`` of the plain VJP on float32 copies,
   a level no roi lands on exactly zero; both captured and replayed in the
   capture check; and
   IoU matching over the FPN's 90,090 anchors (8 x 32 gt, column argmax)
   and the proposal NMS over boxes about them (8 x 12000 -> 600 and 8 x
   3000 -> 300);
4. serves ``voc12_resnet18_align`` (ResNet18, 21 classes, ROIAlign 7x7 s=2)
   and then the flagship ``voc_resnet18`` (ROIPool 7x7) at 600x600, seeded
   random weights resident in bfloat16, through ``InferenceEngine``: one
   request, then 8 mixed-size images as one b8 flush, with the kernels'
   launch counters reset just before and read just after each flush (per
   flush: NMS 2, the preset's ROI forward 1, the other ROI op 0; each flush
   is a CUDA graph replay, counted as :class:`GraphReplays` counts the
   train step's); the same requests then go through the plain versions
   (``reference=True``) and every output must be equal. Then one b1 forward each of ``voc_resnet50``,
   ``coco_resnet50`` and ``coco_vgg16`` at 600x600, launch counts asserted,
   bitwise equal to the plain replay, with the flush time and the resident
   bytes;
5. serves the same model in int8: calibrates it on the card with
   ``quant.synthetic_calibration_batches`` and runs the sensitivity sweep
   (``QuantConfig`` defaults), writes the sidecar under ``build/``, then
   serves the same b1 and b8 requests as [4] with ``params_dtype="int8"``,
   the launch counters reset just before and read after each flush (per
   flush: int8 GEMM 2 and dequantize 1 (one grouped launch) when every group
   stays int8, NMS 2, ROIAlign 1); the replay through the plain versions must
   give bitwise equal detections; the resident tree must be under 0.4 x the float32
   weights and the engine's device memory below the bfloat16 engine's.
   Then ``voc_resnet50``, ``coco_resnet50`` and ``coco_vgg16``, each
   calibrated in this process and served in int8 through graphs at 600x600
   x b1, b8 (:func:`phase_int8_presets`): one b1 and one b8 flush, launches
   per replay (int8 GEMM 2, dequantize 1, NMS 2, the ROI forward 1), every
   detection bitwise the plain replay, the resident and pool bytes;
6. trains ``voc12_resnet18_align``, then ``voc_resnet18``, at 600x600, batch
   8 (bfloat16 compute, float32 parameters, 12000 -> 600 proposals, 256
   anchor and 128 roi samples per image) with two ``Trainer``s on
   ``SyntheticDataset`` from one seed: one captures its step as a CUDA
   graph (as users run it), the other runs it eagerly. The same 6 staged
   steps, step 3 NaN-poisoned (withheld), through both, steps 2-6 under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host read): the two
   end bitwise equal in parameters, BatchNorm statistics, ``mu``, ``nu``,
   ``count``, the generator's state and every step's metrics. Then
   ``TRAIN_REPS`` timed steps of each with the launch counters reset just
   before and read just after (per step: NMS 1, IoU matching 2, the
   preset's ROI forward 1 and backward 1, the other ROI op 0; a replay
   counts the launches its capture recorded, :class:`GraphReplays`), every
   loss finite, the reserved memory not growing; the profiler's timeline
   of 3 more steps of each, counted the same way, gives the device's busy
   ms and idle share and the NMS kernels' (mask and walk), the ROI
   kernels' and the IoU-matching kernel's device ms per step, and must
   show every kernel in both timelines, 2 IoU-matching activities a step
   and the same activities of each kernel captured as eager. Each path's
   device memory is measured alone (:func:`footprint`): the eager step, the
   captured step and ``steps_per_dispatch=4`` with its 1-step tail graph
   in the same pool. Then ``steps_per_dispatch=4``: two chunks (the second
   a replay, a withheld step in each), the tail captured and replayed, and
   a third chunk, bitwise equal to 14 single captured steps, and the
   chunk's ms a step. One more forward and backward from the same
   state and the same draws runs under
   ``ops.reference_scope()``: targets, labels, the four losses and the new
   BatchNorm statistics must be bitwise equal to the kernel pass, and each
   parameter's gradient within a relative L2 error of ``GRAD_RTOL``;
7. evaluates ``voc12_resnet18_align`` at 600x600 (bfloat16 compute, the
   seeded weights) with ``Evaluator`` over 64 VOC-sized uint8 images with
   planted boxes, batch 8, flip TTA off and on: the C++ resize bitwise
   against its numpy specification and both timed; per mode, one batch's
   NMS call shapes (8 x 3000 -> 300 per forward, then 8 x 6300 or, with
   TTA, 8 x 12600 -> 100) and its detections bitwise against the plain
   run; the launch counters reset just before and read just after the
   sweep (per batch: NMS 2 and ROIAlign 1, with TTA 3 and 2) and a finite
   mAP in [0, 1]; then images/s over ``EVAL_SWEEPS`` more sweeps per mode,
   the modes alternating. Then the JAX package's overfit recipe
   (``benchmarks/map_overfit.py``: 128x128 float32, 48 synthetic images,
   360 steps) run as that script runs it: ``Trainer.train(log_every=5)``
   with the val split evaluated every 2 epochs and a save every 15, the
   launch counters reset just before and read just after (per step NMS 1,
   IoU matching 2, ROIAlign 1 and its backward 1; per eval batch NMS 2 and
   ROIAlign 1), then ``save()``; the train-set mAP@0.5 must reach
   ``OVERFIT_MAP_FLOOR`` (printed beside the JAX CPU record), and a fresh
   ``Trainer`` that ``restore()``s must score the final val mAP within
   1e-9; the same weights calibrated as in [5] (and, beside it, on the
   training images, with the sweep's plan and with every group int8) are
   scored in int8. Then the cached evaluation (:func:`phase_cached_evaluate`):
   ``voc_resnet18`` over the same kind of 64 images with the loader feed and
   with ``data.cache_device`` (the set on the card, each batch gathered by
   the image kernels): both results equal entry by entry, the launches per
   batch counted (NMS 2, ROIPool 1; the cached feed's gather geometry 1 and
   image pass 1), and images/s of both feeds;
8. kills and resumes the flagship ``voc_resnet18`` at 600x600, batch 8, 24
   synthetic images (3 steps an epoch), 3 epochs, one sample of step 3's
   batch poisoned with a NaN (the step is skipped): (a) uninterrupted, twice,
   the first with a ``telemetry_dir`` and the second without, bitwise equal
   in the whole state and the logged rows, launch counters
   reset just before and read just after (per step NMS 1, IoU matching 2,
   ROIPool 1 and its backward 1); (b) async saves every 2 steps; (c) sync
   saves every 2 steps and SIGTERM after step 5, which must end in
   ``Preempted`` at step 5 with an emergency manifest that verifies; (d) a
   fresh ``Trainer(...).train(resume=True)`` on (c)'s directory. Every
   run's steps are CUDA graph replays but its first. (b) and (d) must end
   bitwise in (a)'s state (parameters, BatchNorm statistics, the
   optimizer's moments and count, generator, step) with (a)'s logged rows.
   Then one b1
   flush served from ``load_eval_variables`` must equal the same flush from
   (a)'s weights, and with the newest step's file truncated ``restore()``
   must fall back to the step before, log ``checkpoint_fallback`` and delete
   the torn step. Runs (a)-(d) record telemetry: their traces must hold
   every span of ``TRAINER_SPANS`` (the JAX trainer's names), no watchdog
   may record a stall, and (c)'s must record the preemption and the
   abnormal exit; (a)'s report (``telemetry/report.py``) is printed. Prints
   the state's bytes, the save, snapshot, writer and restore ms and the
   steps' ms;
9. runs the benchmark as users run it, ``python -m
   replication_faster_rcnn_tpu_torch.benchmark`` in a subprocess (none of
   this script's TF32 and cuDNN settings), train (``voc_resnet18`` 600x600
   batch 16, the captured step), the eager train step (``BENCH_CAPTURE=0``)
   and eval (batch 8) alternating, ``BENCH_RUNS`` each: every line
   must carry the JAX metric name and keys, a positive value and, for train,
   a FLOP count, an MFU in (0, 1] on the H100 datasheet basis and the JAX
   breakdown keys; prints each metric's median, min and max. The last
   captured and the last eager train run take ``BENCH_PROFILE_DIR``: each
   ``torch.profiler`` capture gives the device busy ms and idle share per
   step, and the idle share of the run's unprofiled timed step, printed.
   Then the b16 step's device memory, captured and eager, each measured
   alone in this process. Then one in-process
   train and one eval measurement at ``BENCH_COUNT_STEPS`` steps, launch counters
   reset just before and read just after (per step NMS 1, IoU matching 2,
   ROIPool 1 and its backward 1; per eval batch NMS 2 and ROIPool 1);
10. drives the training data path (:func:`phase_data_path`):
   ``voc_resnet18`` 600x600 b8 through ``Trainer.train`` on 192 synthetic
   images, four feeds, each with 2 timed epochs and a profiled third: (a)
   float32 without prefetch, (b) uint8 with ``prefetch_device=2``, (c) (b)
   with ``augment_device`` (flip, scale, translation), (d) ``cache_device``
   with flip and scale; images/s, the data spans, the idle share and the
   launch counters per arm; (b) bitwise prefetch off, (d) bitwise the
   loader-fed ``augment_scale_device`` run, K=2 with prefetch bitwise K=1, a
   SIGTERM resumed with prefetch bitwise; the resolution buckets (480, 600,
   720) at K=1 and K=2 in ``bucket_index``'s order, captured bitwise eager,
   launches counted per replay; the cache's bytes against their formula.
   A fifth arm, (e), is (b) fed by the process loader (``loader_mode=
   "process"``, forked workers): bitwise (b)'s state, its epoch's batches
   bitwise the thread loader's, with its images/s and ``data/build`` ms
   beside (b)'s. Then an ``ioerror`` armed at the ``loader.fetch``
   failpoint on two samples (:func:`check_loader_faults`): two
   substitutions by the next index, and with a skip budget of 1 the
   budget's error;
11. drives the serving stack (:func:`phase_serving_stack`): ``voc_resnet18``
   in bfloat16 and ``voc12_resnet18_align`` in int8 ([5]'s sidecar), buckets
   300x300 and 600x600 x b1, b8, every graph captured up front with its
   seconds printed; each (bucket, batch) graph's replay bitwise equal to the
   same function run eagerly and to the plain replay, its launches counted
   per replay; warm flushes with no capture, no growth of the reserved
   memory and no host sync in the flush call from staging to the output
   wait (sync debug mode "error"); the graphs' pool bytes; b1 and b8 flush ms, b1 latency
   and b8 images/s, graph against an eager engine, and the replay's device
   ms against the eager function's. Then on the bf16 flagship with its
   graphs captured at start-up: ``loadgen.run_closed_loop`` at concurrency 8
   and 32 over mixed-size uint8 images and ``run_open_loop`` at half the
   better rate (images/s, p50, p99); ``make_server`` over real HTTP
   (/predict on JPEG files equal to ``submit_path``, a missing file's 400,
   /healthz, /stats, /metrics, /swap's 501); a hot-swap under closed-loop
   load to a second checkpoint written by the port's ``Trainer``
   (``load_eval_variables``): every answer bitwise one version's eager
   flush, answers before the swap from the old version and requests after
   it from the new, no flush whose answers mix versions or differ from its
   key's version, then a second swap retires the first version. The
   launches of that run are its flushes' replays: each flush replays
   exactly the per-replay launches, their sum is the total, and the only
   eager launches in the run are the swap's warm-ups (the eager references
   run before and after it). Outside it: on a second engine with queue
   depth 1 and ``request_timeout_s=1`` whose first flush a ``batcher.flush``
   failpoint holds 3 s, a full queue's 503 with ``Retry-After`` and the held
   requests' 504s; and ``python -m replication_faster_rcnn_tpu_torch
   serve`` as a subprocess: its start-up JSON, one /predict, SIGTERM,
   /healthz draining, exit 0;
12. drives ``voc_resnet50_fpn`` (ResNet50 + FPN, full width, seeded random
   weights): serves it in bfloat16 through ``InferenceEngine`` graphs at
   buckets 300 and 600 x b1, b8 with [11]'s checks (each graph bitwise its
   eager flush and the plain replay; per replay NMS 2 and multi-level
   ROIAlign 1; b1 flush ms, b1 latency, b8 images/s, graph against eager);
   then in int8 (:func:`phase_fpn_int8`): ``python -m
   replication_faster_rcnn_tpu_torch quantize --synthetic-calib --sweep`` in
   a subprocess writes the sidecar, whose int8 graphs at the same buckets
   get the same checks (per replay int8 GEMM 2 and dequantize 1 too), the
   resident tree under 0.4 x float32 and the device memory below the
   bfloat16 engine's, a hot-swap to a second int8 version, and ``predict
   --params-dtype int8`` in a subprocess on a JPEG; trains it at 600x600 b8 with a captured and an eager ``Trainer``, 4
   steps bitwise equal, then 5 timed steps each (per step NMS 1, IoU
   matching 2, multi-level ROIAlign forward 1 and backward 1; step ms and
   peak allocated memory); evaluates the trained weights on 16 VOC-sized
   images (per batch NMS 2, multi-level ROIAlign 1); and runs
   ``benchmark.main`` on it in this process, train and eval at b8
   (images/s, MFU);
13. trains ``voc_resnet50`` (b8, ROIPool on the 1024-channel C4 map),
   ``coco_resnet50`` (b32, ROIAlign, 81 classes, 100 gt slots) and
   ``coco_vgg16`` (b8, ROIPool on 512 channels, 12 anchors, the 512-wide RPN
   conv, dropout) at their own configurations (600x600, bfloat16 compute)
   (:func:`phase_preset_train`): first each kernel at the preset's shapes
   against its plain version (:func:`check_preset_kernels`: the ROI op's
   forward and backward, IoU matching against ``max_boxes`` gt columns, the
   proposal NMS at the batch), then ``2 + TRAIN_REPS`` captured steps and the
   same steps eager, bitwise equal, launches asserted per step (NMS 1, IoU
   matching 2, the ROI op's forward and backward 1), step ms, images/s, the
   idle share of 3 profiled steps, the peak allocated memory and the graph
   pool; one step's forward and backward replayed under
   ``ops.reference_scope()`` with the same draws (VGG16's dropout masks
   included): targets and losses bitwise;
14. drives the grouped and wide backbones and the model knobs
   (:func:`phase_backbones`, :func:`phase_knobs`): ``resnext50_32x4d``,
   ``resnext101_32x8d``, ``wide_resnet50_2`` and ``wide_resnet101_2`` at
   full width and depth on ``voc_resnet50``'s configuration (600x600, b8,
   bfloat16, ROIPool on the 1024-channel C4 map, seeded weights): the
   kernels at their shapes, ``2 + KNOB_REPS`` captured steps and the same
   steps eager bitwise with launches per step (NMS 1, IoU matching 2,
   ROIPool forward and backward 1), step ms, images/s, peak and graph
   pool, and bfloat16 serving graphs at b1 and b8, each replay bitwise its
   eager flush and the plain replay, b1 flush ms and b8 images/s. Then
   ``coco_resnet50`` b32: ``remat`` bitwise the steps without it (peaks
   beside [13]'s), ``frozen_bn``'s running statistics bitwise unchanged,
   ``norm="group"`` captured bitwise eager; ``remat`` on
   ``voc_resnet50_fpn`` b8 and ``coco_vgg16`` b8 bitwise their steps
   without it. Then ``TRACE_STEPS`` eager ``coco_resnet50`` b32 steps with
   BatchNorm, frozen BatchNorm and GroupNorm, each under
   ``utils/profiling.py::trace``, read by ``python -m
   replication_faster_rcnn_tpu_torch trace-summary`` in a subprocess (JSON
   under ``build/``): the top kernels and launching operators printed, the
   operators' ms equal to the kernels' within 1%;
15. prints every phase's wall time, a ``{"kernels": [...]}`` line (the
   serving kernels' launches per graph replay beside their counts; [13]'s
   and [14]'s shapes under ``preset_training_sites``), the card line, and
   last ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without CUDA, or without
the repository beside it, it exits non-zero at once. Comparisons run with
TF32 off for matmuls and convolutions and deterministic cuDNN, so the kernel
and reference passes see bit-identical convolution outputs.
"""

import json
import shutil
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
POOL_SRC = "replication_faster_rcnn_tpu_torch/csrc/roi_pool_kernel.cu"
POOL_JAX = "replication_faster_rcnn_tpu/ops/roi_ops.py:159"
POOL_NOTE = "not a Pallas kernel: the JAX package runs ROIPool as XLA masked maxes"
NO_POOL_LIBRARY = "torch core has no ROIPool operator (torchvision is not installed)"

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
# the ROIPool backward kernel against the plain VJP on float32 copies of the
# same values: the same terms summed in float32 in another order (float32
# features: max 5.7e-6 measured on the H100 at 8 x 128 rois), and for
# bfloat16 features one bfloat16 ulp of that gradient rounded once, or the
# float32 atol where a sum cancels to near zero (the two float32 orders then
# differ by more than one bfloat16 ulp of the small result)
ROI_POOL_BWD = {"float32": {"atol": 1e-5, "rtol": 1e-6},
                "bfloat16": "one bfloat16 ulp of the value, or atol 1e-5"}


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
    """Kernel against the plain version in all four outputs (bitwise), a
    second launch bitwise equal to the first, one counted launch per call
    (the wrapper's count; [6] counts the kernel's activities in the
    profiler); then the times of the main path's call (no IoU matrix).
    The operations bound counts the IoUs of unpadded gt columns only: the
    kernel computes no other."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import iou_kernel
    from replication_faster_rcnn_tpu_torch.ops.cuda.iou_kernel import match_boxes_cuda
    from replication_faster_rcnn_tpu_torch.ops.iou_match import match_boxes

    n0 = iou_kernel.launches
    got = match_boxes_cuda(boxes, gt, mask, want_col=True, want_iou=True)
    again = match_boxes_cuda(boxes, gt, mask, want_col=True, want_iou=True)
    lean = match_boxes_cuda(boxes, gt, mask, want_col, want_iou=False)
    want = match_boxes(boxes, gt, mask, want_col=True)
    torch.cuda.synchronize()
    if iou_kernel.launches != n0 + 3:
        raise AssertionError(f"IoU matching {name}: {iou_kernel.launches - n0} launches for 3 calls")
    for what, a, b, c in zip(("iou", "argmax", "max_iou", "col_argmax"), got, again, want):
        if a.dtype != c.dtype or not torch.equal(a, c):
            raise AssertionError(f"IoU matching {name}: kernel and plain {what} differ")
        if not torch.equal(a, b):
            raise AssertionError(f"IoU matching {name}: two launches differ in {what}")
    if not (torch.equal(lean[1], want[1]) and torch.equal(lean[2], want[2])
            and (lean[3] is None) != want_col and (not want_col or torch.equal(lean[3], want[3]))):
        raise AssertionError(f"IoU matching {name}: the main path's call differs")
    ms = time_ms(torch, lambda: match_boxes_cuda(boxes, gt, mask, want_col, want_iou=False), 20)
    plain_ms = time_ms(torch, lambda: match_boxes(boxes, gt, mask, want_col), 10)
    b, g = gt.shape[:2]
    m = boxes.shape[1]
    nbytes = (boxes.numel() * 4 + gt.numel() * 4 + mask.numel() + b * m * (8 + 4)
              + (b * g * 8 if want_col else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = m * int(mask.sum()) * IOU_FLOPS / F32_FLOPS * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    log(f"  iou_match {name}: all four outputs bitwise equal, two launches bitwise equal, one "
        f"launch per call, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by})")
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


def pool_bin_elements(torch, rois, out, h, w):
    """Feature pixels summed over every ROIPool bin of ``rois`` (feature
    coordinates), with ``roi_ops.roi_pool``'s bin edges: the maxima the
    forward takes per channel."""
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import _reciprocal

    r = rois.float()
    inv = _reciprocal(out)
    p = torch.arange(out, dtype=torch.float32, device=r.device)

    def extents(a, b, extent):
        start, end = torch.round(a), torch.round(b)
        size = torch.clamp(end - start + 1.0, min=1.0) * inv
        lo = torch.clamp(torch.floor(p * size[..., None]) + start[..., None], 0, extent)
        hi = torch.clamp(torch.ceil((p + 1) * size[..., None]) + start[..., None], 0, extent)
        return torch.nan_to_num(torch.clamp(hi - lo, min=0.0))  # [N, R, out]

    rows, cols = extents(r[..., 0], r[..., 2], h), extents(r[..., 1], r[..., 3], w)
    return int((rows[..., :, None] * cols[..., None, :]).sum())


def check_roi_pool(torch, name, feat, rois):
    """ROIPool forward kernel against the plain masked maxes (bitwise: the
    same maxima, the same zeros for non-finite bins), then the times. Bound:
    the map, the rois and the output once; one comparison per channel and
    bin pixel of this run's rois."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_pool_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_pool

    got = roi_pool_cuda(feat, rois, 7)
    want = roi_pool(feat, rois, 7)
    torch.cuda.synchronize()
    if got.dtype != feat.dtype or got.shape != want.shape:
        raise AssertionError(f"ROIPool {name}: got {got.dtype} {tuple(got.shape)}")
    if not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"ROIPool {name}: kernel differs from the plain version by {err}")
    ms = time_ms(torch, lambda: roi_pool_cuda(feat, rois, 7), 20)
    plain_ms = time_ms(torch, lambda: roi_pool(feat, rois, 7), 2, 1, runs=3)
    n, h, w, c = feat.shape
    nbytes = (feat.numel() + got.numel()) * feat.element_size() + rois.numel() * 4
    bound_ms, bound_by = bound(nbytes, pool_bin_elements(torch, rois, 7, h, w) * c, F32_FLOPS)
    log(f"  roi_pool {name}: bitwise equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": 0.0}


def bf16_ulp(torch, x):
    """One bfloat16 ulp at each |x| (8 significant bits; subnormal spacing at 0)."""
    _, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x.float()), e - 8),
                       torch.full_like(x.float(), 2.0**-133))


def check_roi_pool_bwd(torch, name, grad_out, feat, rois):
    """ROIPool backward kernel: two launches bitwise equal, finite, and
    against the plain VJP on float32 copies of the same values (``ROI_POOL_BWD``
    tolerances) wherever that is finite (a NaN in a bin spreads along its
    channel in the plain VJP; the kernel passes nothing through it). Bound:
    grad_out, the map and the rois read once, grad_feat written once; per
    channel and bin pixel a comparison in each pass, and a division per bin.
    ``scratch_bytes`` is the device memory one call allocates beyond its
    output (the peak over the call, measured)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_pool_backward_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_pool_backward

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = roi_pool_backward_cuda(grad_out, feat, rois, 7)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - got.numel() * got.element_size()
    again = roi_pool_backward_cuda(grad_out, feat, rois, 7)
    want = roi_pool_backward(grad_out, feat.float(), rois, 7)
    torch.cuda.synchronize()
    if got.dtype != feat.dtype or got.shape != feat.shape:
        raise AssertionError(f"ROIPool backward {name}: got {got.dtype} {tuple(got.shape)}")
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    if not torch.equal(got.view(bits), again.view(bits)):
        raise AssertionError(f"ROIPool backward {name}: two launches on the same inputs differ")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"ROIPool backward {name}: a non-finite gradient")
    fin = torch.isfinite(want)
    g, p = got.float()[fin], want[fin]
    err = float((g - p).abs().max()) if g.numel() else 0.0
    if feat.dtype == torch.float32:
        ok = torch.allclose(g, p, **ROI_POOL_BWD["float32"])
    else:
        ref = p.to(torch.bfloat16).float()  # the plain gradient rounded once
        tol = torch.clamp(bf16_ulp(torch, ref), min=ROI_POOL_BWD["float32"]["atol"])
        excess = (g - ref).abs() - tol
        ok = bool((excess <= 0).all())
        if not ok:
            i = int(excess.argmax())
            err = f"{err} (worst: kernel {float(g[i])}, plain rounded {float(ref[i])})"
    if not ok:
        raise AssertionError(f"ROIPool backward {name}: max err {err} beyond "
                             f"{ROI_POOL_BWD[str(feat.dtype).split('.')[-1]]}")
    ms = time_ms(torch, lambda: roi_pool_backward_cuda(grad_out, feat, rois, 7), 20)
    plain_ms = time_ms(torch, lambda: roi_pool_backward(grad_out, feat.float(), rois, 7), 1, 1,
                       runs=3)
    n, h, w, c = feat.shape
    nbytes = ((grad_out.numel() * grad_out.element_size() + rois.numel() * 4)
              + 2 * feat.numel() * feat.element_size())
    ops = 2 * pool_bin_elements(torch, rois, 7, h, w) * c + grad_out.numel()
    bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
    log(f"  roi_pool_bwd {name}: two launches bitwise equal, max |kernel - plain| {err:.3e} "
        f"over {int(fin.sum())} of {fin.numel()} finite plain entries "
        f"({ROI_POOL_BWD[str(feat.dtype).split('.')[-1]]}), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), scratch {scratch} bytes")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "deterministic": True, "scratch_bytes": scratch}


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


def check_dequantize_many(torch, leaves):
    """One flush's reconstruction: the grouped kernel (through a table built
    once, as the int8 engine keeps one with its tree) against the plain loop,
    every output bitwise, one launch per call, in float32 and bfloat16; then
    the times of the bfloat16 flush, beside the per-leaf kernel loop it
    replaces. The launch count is the wrapper's, one per call."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import quant_kernel
    from replication_faster_rcnn_tpu_torch.ops.quant_ops import (
        dequantize_many, dequantize_many_plain)

    triples = [(w, s, 0) for w, s in leaves]
    tables = {}
    for dtype in (torch.float32, torch.bfloat16):
        tables[dtype] = quant_kernel.DequantizeTable(triples, dtype)
        n0 = quant_kernel.dequantize_launches
        got = tables[dtype]()
        again = dequantize_many(triples, dtype)  # a table built for this call
        want = dequantize_many_plain(triples, dtype)
        torch.cuda.synchronize()
        if quant_kernel.dequantize_launches != n0 + 2:
            raise AssertionError(f"dequantize_many: {quant_kernel.dequantize_launches - n0} "
                                 "launches for 2 calls")
        for i, (a, b, c) in enumerate(zip(got, again, want)):
            if a.dtype != dtype or not (torch.equal(a, c) and torch.equal(b, c)):
                raise AssertionError(f"dequantize_many {dtype}: leaf {i} {tuple(c.shape)} differs "
                                     "from dequantize_plain")
            if a.data_ptr() % 256:
                raise AssertionError(f"dequantize_many: leaf {i}'s output is not 256-byte aligned")
    log(f"  dequantize_many: all {len(leaves)} weights in one launch, each output bitwise "
        "equal to dequantize_plain (float32 and bfloat16)")
    bf16 = torch.bfloat16
    table = tables[bf16]
    nbytes = sum(w.numel() * 3 + w.shape[0] * 4 for w, _ in leaves)
    ops = sum(w.numel() for w, _ in leaves)
    bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
    res = {
        "ms": time_ms(torch, table, 20),
        "per_leaf_kernels_ms": time_ms(
            torch, lambda: [quant_kernel.dequantize_cuda(w, s, 0, bf16) for w, s in leaves], 20),
        "plain_ms": time_ms(torch, lambda: dequantize_many_plain(triples, bf16), 10),
        "bound_ms": bound_ms, "bound_by": bound_by, "launches": 1, "elements": ops,
        "max_abs_err": 0.0,
    }
    log(f"  dequantize_many, one flush's {len(leaves)} weights into bfloat16 ({ops} elements): "
        f"one launch {res['ms']:.4f} ms, the per-leaf kernel loop ({len(leaves)} launches) "
        f"{res['per_leaf_kernels_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return res


# every int8 preset's head: the cls/reg GEMMs' K (the embedding's width)
# and the class count (reg is 4 x)
INT8_HEADS = {"voc12_resnet18_align": (512, 21), "voc_resnet50_fpn": (1024, 21),
              "voc_resnet50": (2048, 21), "coco_resnet50": (2048, 81), "coco_vgg16": (4096, 81)}


def dequantized_leaf_shapes(name):
    """The state-dict shapes of the weights an int8 flush of ``name``
    dequantizes (every quantizable weight but the cls/reg GEMMs' under the
    all-int8 plan)."""
    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN

    model = FasterRCNN(get_config(name), device="meta")
    return [tuple(v.shape) for k, v in model.state_dict().items()
            if v.dim() >= 2 and v.is_floating_point()
            and k not in ("head.cls.weight", "head.reg.weight")]


def check_int8_kernels(torch, rng, dev):
    """Phase [3] for the int8 slice: the GEMM at every preset's b1 and b8
    cls/reg shapes, the dequantize on every conv weight of the model, and the
    grouped dequantize of one flush's weights of every int8 preset."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import dequantize_cuda
    from replication_faster_rcnn_tpu_torch.ops.quant_ops import dequantize_plain

    def int8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    res = {}
    for preset, (k, classes) in INT8_HEADS.items():
        for m in (300, 2400):
            x = int8((m, k))
            for name, n in (("cls", classes), ("reg", 4 * classes)):
                key = f"gemm_b{m // 300}_{name}"
                if preset != "voc12_resnet18_align":
                    key = f"{preset} {key}"
                res[key] = check_int8_matmul(
                    torch, f"{preset} b{m // 300} {name} [{m}, {k}] x [{k}, {n}]", x,
                    int8((n, k)))
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
    res["dequant_flush"] = check_dequantize_many(torch, leaves)
    gen = torch.Generator(device=dev).manual_seed(19)
    for preset in ("voc_resnet50_fpn", "voc_resnet50", "coco_vgg16"):
        shapes = dequantized_leaf_shapes(preset)
        leaves = [(torch.randint(-128, 128, shape, dtype=torch.int8, device=dev, generator=gen),
                   torch.rand(shape[0], device=dev, generator=gen) * 0.05 + 1e-4)
                  for shape in shapes]
        log(f"  {preset}: one int8 flush dequantizes {len(leaves)} weights")
        res[f"dequant_flush {preset}"] = check_dequantize_many(torch, leaves)
        del leaves
        torch.cuda.empty_cache()
    return res


def tta_detection_candidates(torch, dev, b, r=300, c=21):
    """The flip-TTA decode's NMS input (own generator: the draws of the other
    cases stay as they were): each image's 300 rois and, as the mirrored
    pass reflected back, the same rois moved by ~2 px, each roi x 21 class
    boxes with class offsets -> 8 x 12600 candidates, masked as the decode
    masks them (class > 0, score >= 0.05)."""
    rng = np.random.default_rng(7)
    rb = rand_boxes(rng, (b, r), 560, 200)
    rb = np.concatenate([rb, rb + rng.normal(0, 2, rb.shape)], axis=1)  # [b, 2r, 4]
    det = np.repeat(rb[:, :, None], c, axis=2) + rng.normal(0, 2, (b, 2 * r, c, 4))
    det = torch.from_numpy(det.reshape(b, 2 * r * c, 4).astype(np.float32)).to(dev)
    cls = torch.arange(c, device=dev).repeat(2 * r)
    det = det + cls.float()[None, :, None] * (det.amax(dim=(1, 2), keepdim=True) + 1.0)
    scores = torch.from_numpy(rng.uniform(0, 0.2, (b, 2 * r * c)).astype(np.float32)).to(dev)
    return det, scores, (cls[None] > 0) & (scores >= 0.05)


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
    tboxes, tscores, tmask = tta_detection_candidates(torch, dev, b)
    res["nms_detection_tta"] = check_nms(torch, "TTA detection 8x12600->100 thr 0.3", tboxes,
                                         tscores, 0.3, 100, mask=tmask)
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
    from replication_faster_rcnn_tpu_torch.ops.iou_match import match_boxes as match_boxes_plain

    anchors = torch.from_numpy(make_anchors(AnchorConfig(), FEAT[:2])).to(dev)[None]
    gt = torch.from_numpy(rand_boxes(rng, (b, 32), 450, 300)).to(dev)
    gmask = torch.arange(32, device=dev)[None, :] < torch.tensor(
        [1, 3, 32, 5, 8, 2, 0, 17], device=dev)[:, None]
    res["iou_anchor"] = check_iou(torch, "anchors 8x12996x32 + column argmax", anchors, gt, gmask,
                                  True)
    cand = torch.cat([torch.from_numpy(rand_boxes(rng, (b, 600), 500, 250)).to(dev), gt], dim=1)
    res["iou_proposal"] = check_iou(torch, "proposals 8x632x32", cand, gt, gmask, False)
    # G = 64: two 32-column chunks per lane (own generator: the draws of the
    # cases below stay as they were)
    grng = np.random.default_rng(6)
    gt64 = torch.from_numpy(rand_boxes(grng, (b, 64), 450, 300)).to(dev)
    gmask64 = torch.arange(64, device=dev)[None, :] < torch.tensor(
        [1, 33, 64, 40, 8, 2, 0, 63], device=dev)[:, None]
    res["iou_anchor_g64"] = check_iou(torch, "anchors 8x12996x64 + column argmax", anchors, gt64,
                                      gmask64, True)
    # exact ties: IoU 1 with gt 0 at rows in two warps of block 0 and in later
    # blocks (the lowest row wins the column), and gt 7 equal to gt 0 (the
    # lower column wins the row)
    tied = anchors.expand(b, -1, -1).clone()
    tgt = gt.clone()
    tgt[:, 7] = tgt[:, 0]
    tied[:, [40, 70, 300, 5000, 12995]] = tgt[:, :1]
    tmask = gmask.clone()
    tmask[:, [0, 7]] = True
    res["iou_ties"] = check_iou(torch, "ties 8x12996x32 + column argmax", tied, tgt, tmask, True)
    _, t_arg, _, t_col = match_boxes_plain(tied, tgt, tmask)
    if not (bool((t_col[:, 0] == 40).all()) and bool((t_arg[:, [40, 70, 300]] == 0).all())):
        raise AssertionError("the ties row has no ties: column 0's best row is not 40")
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
    res.update(check_roi_pool_kernels(torch, dev, b))
    res.update(check_int8_kernels(torch, rng, dev))
    res["multilevel"], res["multilevel_levels"] = check_multilevel_kernels(torch, dev, b)
    # the FPN's sites: IoU matching over the 90,090 anchors of P2-P6 at
    # 600x600 (3 ratios, one scale per level) with the column argmax, and the
    # proposal NMS over boxes drawn about those anchors (own generator: the
    # draws above stay as they were)
    frng = np.random.default_rng(12)
    fpn_anchors = torch.from_numpy(fpn_anchor_grid()).to(dev)
    res["iou_anchor_fpn"] = check_iou(torch, f"FPN anchors 8x{fpn_anchors.shape[0]}x32 + column "
                                      "argmax", fpn_anchors[None], gt, gmask, True)
    pick = torch.from_numpy(frng.integers(0, fpn_anchors.shape[0], (b, 12000))).to(dev)
    fboxes = fpn_anchors[pick] + torch.from_numpy(
        frng.normal(0, 4, (b, 12000, 4)).astype(np.float32)).to(dev)
    fboxes = torch.clamp(fboxes, 0.0, 600.0)
    fscores = torch.from_numpy(-np.sort(-frng.uniform(0, 1, (b, 12000)), axis=1)
                               .astype(np.float32)).to(dev)
    res["nms_train_fpn"] = check_nms(torch, "FPN proposals 8x12000->600 thr 0.7", fboxes, fscores,
                                     0.7, 600, mask=torch.isfinite(fscores), assume_sorted=True)
    res["nms_fpn"] = check_nms(torch, "FPN proposals 8x3000->300 thr 0.7", fboxes[:, :3000],
                               fscores[:, :3000].contiguous(), 0.7, 300,
                               mask=torch.isfinite(fscores[:, :3000]), assume_sorted=True)
    return res


def fpn_anchor_grid(size=600):
    """The FPN preset's anchors at ``size`` x ``size``: each level's base
    anchors (stride, 3 ratios, scale 8) over its grid, fine -> coarse."""
    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.models.fpn import FPN_STRIDES
    from replication_faster_rcnn_tpu_torch.ops import anchors as anchor_ops

    acfg = get_config(FPN_NAME).anchors
    grids, h = [], size
    for stride in FPN_STRIDES:
        h = -(-size // stride) if stride < 64 else -(-h // 2)
        base = anchor_ops.anchor_base(stride, acfg.ratios, acfg.scales)
        grids.append(anchor_ops.grid_anchors(base, stride, h, h))
    return np.concatenate(grids)


def check_graph_replays(torch, dev, b=8):
    """Phase [3], capture safety: one launch of each kernel's wrapper at the
    training (or serving) shape captured in a CUDA graph on a side stream
    (after one warm-up call on that stream, as ``train_step.CapturedSteps``
    does) and replayed twice, its outputs overwritten with 0xA5 bytes before
    each replay: every replay must be bitwise equal to the eager launch.
    The IoU-matching kernel's column state for the capturing stream must be
    zero again after each replay."""
    from replication_faster_rcnn_tpu_torch.config import AnchorConfig
    from replication_faster_rcnn_tpu_torch.ops.anchors import make_anchors
    from replication_faster_rcnn_tpu_torch.ops.cuda import iou_kernel, nms_kernel, quant_kernel
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel

    rng = np.random.default_rng(9)
    bf16 = torch.bfloat16

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    boxes = t(rand_boxes(rng, (b, 12000), 560, 250))
    scores = t(-np.sort(-rng.uniform(0, 1, (b, 12000)), axis=1).astype(np.float32))
    feat = t(rng.normal(0, 1, (b,) + FEAT).astype(np.float32)).to(bf16)
    rois = t((rand_boxes(rng, (b, 128), 600, 300) * (FEAT[0] / 600)).astype(np.float32))
    grad = t(rng.normal(0, 1, (b, 128, 7, 7, FEAT[2])).astype(np.float32)).to(bf16)
    anchors = t(make_anchors(AnchorConfig(), FEAT[:2]))[None]
    gt = t(rand_boxes(rng, (b, 32), 450, 300))
    gmask = torch.arange(32, device=dev)[None, :] < t(np.array([1, 3, 32, 5, 8, 2, 0, 17]))[:, None]
    x_q = t(rng.integers(-128, 128, (2400, 512), dtype=np.int8))
    w_q = t(rng.integers(-128, 128, (512, 21), dtype=np.int8))  # [K, N]
    conv = t(rng.integers(-128, 128, (512, 512, 3, 3), dtype=np.int8))
    scale = t(rng.uniform(1e-4, 0.05, 512).astype(np.float32))
    table = quant_kernel.DequantizeTable([(w, s, 0) for w, s in (
        (conv, scale), (conv[:256], scale[:256]))], bf16)
    from replication_faster_rcnn_tpu_torch.models.fpn import roi_levels

    pyramid = ml_pyramid(torch, rng, dev, b, bf16)
    ml_rois = t(rand_boxes(rng, (b, 128), 600, 500))
    ml_levels = roi_levels(ml_rois)
    ml_shapes = [tuple(f.shape) for f in pyramid]
    cases = [
        ("nms_mask_walk 8x12000->600", lambda: nms_kernel.nms_fixed_cuda(
            boxes, scores, 0.7, 600, mask=torch.isfinite(scores), assume_sorted=True)),
        ("roi_align_fwd bf16 8x128", lambda: roi_kernel.roi_align_cuda(
            feat, rois, 7, 2, 1.0, bf16)),
        ("roi_align_bwd bf16 8x128", lambda: roi_kernel.roi_align_backward_cuda(
            grad, rois, feat.shape, bf16, 7, 2)),
        ("roi_pool_fwd bf16 8x128", lambda: roi_kernel.roi_pool_cuda(feat, rois)),
        ("roi_pool_bwd bf16 8x128", lambda: roi_kernel.roi_pool_backward_cuda(
            grad, feat, rois, 7)),
        ("iou_match 8x12996x32 + column argmax", lambda: iou_kernel.match_boxes_cuda(
            anchors, gt, gmask, want_col=True)),
        ("int8_matmul [2400, 512] x [512, 21]", lambda: quant_kernel.int8_matmul_cuda(x_q, w_q)),
        ("dequantize [512, 512, 3, 3] -> bf16", lambda: quant_kernel.dequantize_cuda(
            conv, scale, 0, bf16)),
        ("dequantize_many (2 leaves) -> bf16", lambda: table()),
        ("multilevel_roi_align_fwd bf16 8x128", lambda: roi_kernel.multilevel_roi_align_cuda(
            pyramid, ml_rois, FPN_IMG, FPN_IMG, 7, 2, bf16)),
        ("multilevel_roi_align_bwd bf16 8x128", lambda: roi_kernel.multilevel_roi_align_backward_cuda(
            grad, ml_rois, ml_levels, ml_shapes, bf16, FPN_IMG, FPN_IMG, 7, 2)),
    ]

    def outputs(out):
        return [o for o in (out if isinstance(out, (tuple, list)) else (out,)) if o is not None]

    checked = []
    with torch.no_grad():
        for name, fn in cases:
            want = [o.clone() for o in outputs(fn())]
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                fn()  # warm-up on the capturing stream: its state, attributes, tables
            torch.cuda.current_stream(dev).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                got = outputs(fn())
            for rep in range(2):
                for o in got:
                    o.view(torch.uint8).fill_(0xA5)
                graph.replay()
                torch.cuda.synchronize(dev)
                if len(got) != len(want) or not all(bitwise(torch, g, w)
                                                    for g, w in zip(got, want)):
                    raise AssertionError(f"{name}: replay {rep + 1} of the captured launch "
                                         "differs from the eager launch")
                if name.startswith("iou_match"):
                    state = iou_kernel._states[(gt.device.index, stream.cuda_stream)]
                    if bool(state.any()):
                        raise AssertionError(f"{name}: replay {rep + 1} left the column "
                                             "state non-zero")
            checked.append(name)
            del graph, got
    log(f"  CUDA graph capture: one launch of each of {len(checked)} wrappers captured on a "
        f"side stream and replayed twice, bitwise equal to the eager launch ({checked}); the "
        "IoU column state zero after each replay")
    return checked


IMAGE_SRC = "replication_faster_rcnn_tpu_torch/csrc/image_kernel.cu"
# the XLA code each data-path kernel replaces (no Pallas kernel: ops/image.py)
IMAGE_JAX = {
    "augment_geometry": "replication_faster_rcnn_tpu/ops/image.py:275",
    "augment_prepare": "replication_faster_rcnn_tpu/ops/image.py:275",
    "image_fill": "replication_faster_rcnn_tpu/ops/image.py:58",
    "augment_image": "replication_faster_rcnn_tpu/ops/image.py:31",
    "resize_aa": "replication_faster_rcnn_tpu/ops/image.py:337",
}
IMAGE_NOTE = ("not a Pallas kernel: the JAX package runs the on-card augmentation, the device "
              "cache's gather (data/device_cache.py:286) and the bucket resample as XLA ops")
AUG_SEED = 13
AUG_MODES = (("flip", dict(hflip=True)), ("translate", dict(translate=0.1)),
             ("scale", dict(scale_range=(0.75, 1.25))),
             ("flip+translate+scale", dict(hflip=True, scale_range=(0.75, 1.25), translate=0.1)))


def bytes_bound(*tensors):
    """(bound ms, "bytes"): the tensors' bytes over the card's memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def replays_bitwise(torch, dev, name, fn):
    """One launch of ``fn`` captured on a side stream after a warm-up call
    there, replayed twice with its outputs overwritten: bitwise the eager
    launch."""
    def outputs(out):
        return [o for o in (out if isinstance(out, (tuple, list)) else (out,)) if o is not None]

    want = [o.clone() for o in outputs(fn())]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = outputs(fn())
    for rep in range(2):
        for o in got:
            o.view(torch.uint8).fill_(0xA5)
        graph.replay()
        torch.cuda.synchronize(dev)
        if len(got) != len(want) or not all(bitwise(torch, g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: replay {rep + 1} of the captured launch differs "
                                 "from the eager launch")


def oracle_geometry(aug, h, w, kw):
    """The geometry rows of augment_batch from the numpy oracle
    (data/augment.py::device_decisions), float32 as JAX computes them."""
    from replication_faster_rcnn_tpu_torch.data.augment import device_decisions

    f32 = np.float32
    rows = []
    for idx, epoch in aug:
        flip, u_s, u_oy, u_ox, u_ty, u_tx = device_decisions(AUG_SEED, int(epoch), int(idx))
        dy = dx = 0
        if kw.get("translate"):
            t = kw["translate"]
            dy = int(np.rint((f32(2.0) * u_ty - f32(1.0)) * f32(t * h)))
            dx = int(np.rint((f32(2.0) * u_tx - f32(1.0)) * f32(t * w)))
        ch, cw, shy, shx = h, w, 0, 0
        if kw.get("scale_range"):
            lo, hi = kw["scale_range"]
            scale = f32(lo) + f32(hi - lo) * u_s
            ch = int(max(f32(1.0), np.rint(f32(h) * scale)))
            cw = int(max(f32(1.0), np.rint(f32(w) * scale)))
            shy = int(np.rint(f32(ch - h) * np.clip(u_oy, f32(0), f32(1))))
            shx = int(np.rint(f32(cw - w) * np.clip(u_ox, f32(0), f32(1))))
        jit = int((ch, cw, shy, shx) != (h, w, 0, 0))
        rows.append([int(flip and kw.get("hflip", False)), dy, dx, ch, cw, shy, shx, jit])
    return np.asarray(rows, np.int32)


def image_errors(torch, got, want):
    """(max abs error, the check): uint8 bitwise; float32 within 1e-6 of the
    batch's largest magnitude (the fills: float64 sums in another order, at
    most 1 float32 ulp apart)."""
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.uint8:
        return err, bitwise(torch, got, want)
    return err, got.dtype == want.dtype and err <= 1e-6 * max(1.0, float(want.abs().max()))


def pure_copy_case(torch, dev, K, I, name, args, source, library, captured):
    """An image-pass case that moves bytes alone (every row flipped; the
    identity gather), ``args`` = (images, geom, idx): bitwise its plain
    version and the one PyTorch call ``library`` that computes it, timed
    beside both, captured and replayed twice."""
    from replication_faster_rcnn_tpu_torch import ops

    images, geom, idx = args
    out = K.augment_image_cuda(images, geom, None, idx)
    batch = images[idx.long()] if idx is not None else images
    with ops.reference_scope():
        plain = I.augment_images_plain(batch, geom)
    if not (bitwise(torch, out, plain) and bitwise(torch, out, library())):
        raise AssertionError(f"{name}: kernel != plain version or the library call")
    row = {"max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: K.augment_image_cuda(images, geom, None, idx), 20),
           "library_ms": time_ms(torch, library, 20)}
    with ops.reference_scope():
        row["plain_ms"] = time_ms(torch, lambda: I.augment_images_plain(
            images[idx.long()] if idx is not None else images, geom), 1, 1, 3)
    row["bound_ms"], row["bound_by"] = bytes_bound(source, out)
    replays_bitwise(torch, dev, name, lambda: K.augment_image_cuda(images, geom, None, idx))
    captured.append(name)
    return row


def fills_ok(torch, dtype, got, want):
    """uint8 fills bitwise; float32 within 1 float32 ulp (float64 sums in
    another order)."""
    if dtype == "uint8":
        return bitwise(torch, got, want)
    ulp = torch.from_numpy(np.spacing(want.abs().cpu().numpy())).to(want.device)
    return bool(((got - want).abs() <= ulp).all())


def check_image_kernels(torch, dev):
    """Phase [3] for the data path's kernels at 600x600, b8 and b16, uint8
    and float32. The prepare launch (geometry + fills) and the geometry
    alone on four row mixes (flip only: identity rows beside flipped ones;
    translate +-0.1; scale 0.75-1.25: zoom in and out; all three) against
    ``augment_prepare_plain`` on the card: boxes, labels, masks and
    geometry rows bitwise (and the geometry against the numpy oracle
    ``device_decisions``), the fills bitwise in uint8 and within 1 float32
    ulp, bitwise across two launches and the fills alone
    (``image_fill_cuda``); G = 100 (the COCO padding) and the cache's rows
    by an idx that repeats one the same. The image pass on the prepare
    launch's geometry and fills against ``augment_images_plain``: bitwise
    in uint8 and within 1e-6 relative in float32. The prepare launch and
    the fills alone timed beside ``torch.sum(images, dim=(1, 2))`` in int64
    / float64 (``library_ms``: the first fill's sum alone). The device cache's gather (a
    1,024-image cache, flip + jitter, the resample in the same pass) against
    the plain ``materialize_batch`` + ``batched_scale_jitter``, the image
    kernel timed alone (``ms``) and the whole path (``materialize_ms``: the
    prepare launch and the image pass). Every row flipped and the identity gather
    bitwise the plain version and ``torch.flip`` / ``torch.index_select``
    (``library_ms``). The bucket resample 600->480, 600->720 and 600->240
    bitwise against the plain band passes, with
    ``F.interpolate(antialias=True)`` timed beside it. Every kernel captured
    and replayed twice, bitwise its eager launch."""
    from replication_faster_rcnn_tpu_torch import ops
    from replication_faster_rcnn_tpu_torch.data.device_cache import materialize_batch
    from replication_faster_rcnn_tpu_torch.ops import image as I
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel as K

    rng = np.random.default_rng(21)
    h = w = 600
    g = 32
    res, captured = {}, []

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def make(b, dtype):
        if dtype == "uint8":
            images = t(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
        else:
            images = t(rng.normal(0, 1, (b, h, w, 3)).astype(np.float32))
        return (images,) + make_boxes(b)

    def make_boxes(b, g=g):
        boxes = rand_boxes(rng, (b, g), 520, 260)
        boxes = np.minimum(boxes, 600).astype(np.float32)
        labels = rng.integers(1, 21, (b, g)).astype(np.int32)
        labels[:, 6:] = -1
        boxes[:, 6:] = -1.0
        mask = labels >= 0
        aug = np.stack([rng.integers(0, 5011, b), rng.integers(0, 50, b)], -1).astype(np.int32)
        return t(boxes), t(labels), t(mask), aug

    def held_prepare(name, images, boxes, labels, mask, dtype, kw, want_geom=None):
        """The prepare launch against its plain version, the fills across
        two launches and against the fills alone; -> (outputs, fill error)."""
        got = K.augment_prepare_cuda(images, boxes, labels, mask, **kw)
        again = K.augment_prepare_cuda(images, boxes, labels, mask, **kw)
        alone = K.image_fill_cuda(images, got[3], kw.get("idx"))
        with ops.reference_scope():
            want = I.augment_prepare_plain(images, boxes, labels, mask, **kw)
        if not (all(bitwise(torch, a, c) for a, c in zip(got[:4], want[:4]))
                and (want_geom is None or np.array_equal(got[3].cpu().numpy(), want_geom))):
            raise AssertionError(f"augment_prepare {name}: geometry != plain or oracle")
        if not (fills_ok(torch, dtype, got[4], want[4]) and bitwise(torch, again[4], got[4])
                and bitwise(torch, alone, got[4])):
            raise AssertionError(f"augment_prepare {name}: fills != plain, or not bitwise "
                                 "across launches and the fills alone")
        return got, float((got[4] - want[4]).abs().max())

    for b in (8, 16):
        for dtype in ("uint8", "float32"):
            images, boxes, labels, mask, aug_np = make(b, dtype)
            aug = t(aug_np)
            for mode, kw in AUG_MODES:
                key = f"b{b}_{dtype}_{mode}"
                kw = dict(aug=aug, seed=AUG_SEED, **kw)
                gb, gl, gm, ggeom, _ = K.augment_geometry_cuda(boxes, labels, mask, b, h, w, **kw)
                want_geom = oracle_geometry(aug_np, h, w, kw)
                (pb, pl, pm, geom, fills), fill_err = held_prepare(
                    key, images, boxes, labels, mask, dtype, kw, want_geom)
                if not (bitwise(torch, gb, pb) and bitwise(torch, gl, pl) and bitwise(torch, gm, pm)
                        and bitwise(torch, ggeom, geom)):
                    raise AssertionError(f"augment_geometry {key}: kernel != prepare / plain")
                out = K.augment_image_cuda(images, geom, fills)
                with ops.reference_scope():
                    pout = I.augment_images_plain(images, geom)
                err, ok = image_errors(torch, out, pout)
                if not ok:
                    raise AssertionError(f"augment_image {key}: max error {err}")
                jit = geom[:, 7].sum().item()
                row = {"jittered_rows": int(jit), "flipped_rows": int(geom[:, 0].sum()),
                       "translated_rows": int((geom[:, 1:3] != 0).any(1).sum()),
                       "max_abs_err": err, "fill_max_abs_err": fill_err}
                if mode == "flip+translate+scale":
                    sum_type = torch.int64 if dtype == "uint8" else torch.float64

                    def yardstick():
                        return torch.sum(images, dim=(1, 2), dtype=sum_type)

                    row["prepare"] = dict(zip(("ms", "plain_ms", "library_ms"), (
                        time_ms(torch, lambda: K.augment_prepare_cuda(
                            images, boxes, labels, mask, **kw), 20),
                        time_ms(torch, lambda: I.augment_prepare_plain(
                            images, boxes, labels, mask, **kw), 2, 1, 3),
                        time_ms(torch, yardstick, 20))))
                    row["prepare"].update(zip(("bound_ms", "bound_by"), bytes_bound(
                        images, boxes, labels, mask, aug, pb, pl, pm, geom, fills)))
                    row["geometry"] = dict(zip(("ms", "plain_ms"), (
                        time_ms(torch, lambda: K.augment_geometry_cuda(
                            boxes, labels, mask, b, h, w, **kw), 50),
                        time_ms(torch, lambda: I.augment_geometry_plain(
                            boxes, labels, mask, aug, h, w, seed=AUG_SEED,
                            **{k: v for k, v in kw.items() if k not in ("aug", "seed")}),
                            3, 1, 3))))
                    row["geometry"].update(zip(("bound_ms", "bound_by"), bytes_bound(
                        boxes, labels, mask, aug, gb, gl, gm, geom)))
                    row["fill"] = dict(zip(("ms", "plain_ms", "library_ms"), (
                        time_ms(torch, lambda: K.image_fill_cuda(images, geom), 20),
                        time_ms(torch, lambda: I.image_fills_plain(images, geom), 2, 1, 3),
                        row["prepare"]["library_ms"])))
                    row["fill"].update(zip(("bound_ms", "bound_by"), bytes_bound(images, fills)))
                    row["image"] = dict(zip(("ms", "plain_ms"), (
                        time_ms(torch, lambda: K.augment_image_cuda(images, geom, fills), 20),
                        time_ms(torch, lambda: I.augment_images_plain(images, geom), 1, 1, 3))))
                    row["image"].update(zip(("bound_ms", "bound_by"), bytes_bound(images, out)))
                    if b == 8:
                        for name, fn in (
                                (f"augment_prepare {key}", lambda: K.augment_prepare_cuda(
                                    images, boxes, labels, mask, **kw)),
                                (f"augment_geometry {key}", lambda: K.augment_geometry_cuda(
                                    boxes, labels, mask, b, h, w, **kw)),
                                (f"image_fill {key}", lambda: K.image_fill_cuda(images, geom)),
                                (f"augment_image {key}", lambda: K.augment_image_cuda(
                                    images, geom, fills))):
                            replays_bitwise(torch, dev, name, fn)
                            captured.append(name)
                        # G = 100, the COCO presets' padding: prepare and geometry alone
                        cb, cl, cm, _ = make_boxes(b, 100)
                        (pb100, pl100, pm100, _, _), _ = held_prepare(
                            f"{key} G=100", images, cb, cl, cm, dtype, kw, want_geom)
                        g100 = K.augment_geometry_cuda(cb, cl, cm, b, h, w, **kw)
                        if not all(bitwise(torch, a, c) for a, c in
                                   zip(g100[:3], (pb100, pl100, pm100))):
                            raise AssertionError(f"augment_geometry {key} G=100: != plain")
                        row["geometry_g100_ms"] = time_ms(torch, lambda: K.augment_geometry_cuda(
                            cb, cl, cm, b, h, w, **kw), 50)
                res[key] = row
            # the device cache: gather + flip + jitter (resampled in the same pass)
            if b == 8:
                m = 1024
                cache_images = (t(rng.integers(0, 256, (m, h, w, 3), dtype=np.uint8))
                                if dtype == "uint8" else
                                torch.randn(m, h, w, 3, device=dev,
                                            generator=torch.Generator(dev).manual_seed(3)))
                cb, cl, cm, _ = make_boxes(m)
                cache = {"image": cache_images, "boxes": cb, "labels": cl, "mask": cm}
                idx = t(rng.choice(m, b, replace=False).astype(np.int32))
                scale = rng.uniform(0.75, 1.25, b)
                ch = np.rint(h * scale).astype(np.int32)
                jitter = np.stack([ch, ch, np.rint((ch - h) * rng.uniform(0, 1, b)),
                                   np.rint((ch - w) * rng.uniform(0, 1, b))], -1).astype(np.int32)
                jitter[0] = [h, w, 0, 0]  # an identity row
                sel = {"idx": idx, "flip": t(rng.uniform(size=b) < 0.5), "jitter": t(jitter)}
                got = materialize_batch(cache, sel, resample=True)
                with ops.reference_scope():
                    want = materialize_batch(cache, sel, resample=True)
                err, ok = image_errors(torch, got["image"], want["image"])
                if not ok or not all(bitwise(torch, got[k], want[k])
                                     for k in ("boxes", "labels", "mask")):
                    raise AssertionError(f"cache gather b8 {dtype}: max error {err}")
                key = f"cache_b8_{dtype}"
                # the image kernel alone on the cache path's geometry and fills
                # (ops/image.py::augment_cached); materialize_* is the whole
                # path: the prepare launch and the image pass
                ckw = dict(idx=idx, flip=sel["flip"], jitter=sel["jitter"], resample="all")
                (_, _, _, cgeom, cfills), _ = held_prepare(
                    f"cache b8 {dtype}", cache_images, cb, cl, cm, dtype, ckw)
                # the cache's rows by an idx that repeats one
                ridx = idx.clone()
                ridx[-1] = ridx[0]
                held_prepare(f"cache b8 {dtype} repeated idx", cache_images, cb, cl, cm, dtype,
                             dict(ckw, idx=ridx))
                alone = K.augment_image_cuda(cache_images, cgeom, cfills, idx)
                if not bitwise(torch, alone, got["image"]):
                    raise AssertionError(f"cache gather b8 {dtype}: the image kernel alone "
                                         "differs from materialize_batch's")
                gathered = cache_images[idx.long()]
                res[key] = {"max_abs_err": err, "cache_images": m,
                            "ms": time_ms(torch, lambda: K.augment_image_cuda(
                                cache_images, cgeom, cfills, idx), 20),
                            "materialize_ms": time_ms(
                                torch, lambda: materialize_batch(cache, sel, True), 20)}
                with ops.reference_scope():
                    res[key]["plain_ms"] = time_ms(torch, lambda: I.augment_images_plain(
                        cache_images[idx.long()], cgeom), 1, 1, 3)
                    res[key]["materialize_plain_ms"] = time_ms(
                        torch, lambda: materialize_batch(cache, sel, True), 1, 1, 3)
                res[key]["bound_ms"], res[key]["bound_by"] = bytes_bound(gathered, alone)
                res[key]["materialize_bound_ms"] = bytes_bound(
                    got["image"], got["image"], got["boxes"], got["labels"], got["mask"])[0]
                replays_bitwise(torch, dev, f"cache gather {key}",
                                lambda: materialize_batch(cache, sel, True)["image"])
                captured.append(f"cache gather {key}")
                # the identity gather: one PyTorch call computes it
                _, _, _, igeom, _ = K.augment_geometry_cuda(None, None, None, b, h, w, idx=idx,
                                                            device=images.device)
                res[f"gather_b8_{dtype}"] = pure_copy_case(
                    torch, dev, K, I, f"identity gather b8 {dtype}", (cache_images, igeom, idx),
                    gathered, lambda: torch.index_select(cache_images, 0, idx.long()), captured)
                del cache, cache_images, gathered
                # every row flipped, no translation or jitter
                every = torch.ones(b, dtype=torch.bool, device=images.device)
                _, _, _, fgeom, _ = K.augment_geometry_cuda(None, None, None, b, h, w, flip=every,
                                                            device=images.device)
                res[f"allflip_b8_{dtype}"] = pure_copy_case(
                    torch, dev, K, I, f"all-flip b8 {dtype}", (images, fgeom, None), images,
                    lambda: torch.flip(images, [2]), captured)
            # the bucket resample (and a strong downsample)
            for out_hw in ((480, 480), (720, 720), (240, 240)):
                key = f"resize_b{b}_{dtype}_{out_hw[0]}"
                got, gboxes = I.resize_batch_with_boxes(images, boxes, out_hw)
                with ops.reference_scope():
                    want, wboxes = I.resize_batch_with_boxes(images, boxes, out_hw)
                if not (bitwise(torch, got, want) and bitwise(torch, gboxes, wboxes)):
                    raise AssertionError(f"resize {key}: kernel != plain band passes")
                x = images.permute(0, 3, 1, 2).float()
                lib = torch.nn.functional.interpolate(
                    x, size=out_hw, mode="bilinear", antialias=True, align_corners=False)
                lib_img = lib.permute(0, 2, 3, 1)
                if dtype == "uint8":
                    lib_img = torch.clamp(torch.round(lib_img), 0, 255).to(torch.uint8)
                lib_err = float((lib_img.float() - got.float()).abs().max())
                lib_ok = (lib_err <= 1.0 if dtype == "uint8"
                          else lib_err <= 1e-5 * float(got.abs().max()))
                row = {"max_abs_err": 0.0, "library_max_abs_err": lib_err,
                       "library_within_tolerance": lib_ok,
                       "ms": time_ms(torch, lambda: K.resize_aa_cuda(images, boxes, out_hw), 20),
                       "library_ms": time_ms(torch, lambda: torch.nn.functional.interpolate(
                           x, size=out_hw, mode="bilinear", antialias=True,
                           align_corners=False), 20)}
                with ops.reference_scope():
                    row["plain_ms"] = time_ms(
                        torch, lambda: I.resize_batch_with_boxes(images, boxes, out_hw), 1, 1, 3)
                row["bound_ms"], row["bound_by"] = bytes_bound(images, boxes, got, gboxes)
                res[key] = row
                if b == 8:
                    replays_bitwise(torch, dev, f"resize {key}",
                                    lambda: K.resize_aa_cuda(images, boxes, out_hw))
                    captured.append(f"resize {key}")
            del images
    log("  data-path kernels (600x600, b8 / b16, uint8 / float32): the prepare launch "
        "(geometry + fills), the geometry alone and the image pass against the plain versions "
        "on four row mixes (geometry and boxes bitwise, and against device_decisions; G = 100 "
        "too), the cache gather (1,024 images, an idx repeating a row too; the "
        "image kernel alone and the whole materialize_batch), every row flipped and the "
        "identity gather (bitwise torch.flip / torch.index_select) and the resample 600->480 / "
        "600->720 / 600->240, all within tolerance; "
        + json.dumps({k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                          for kk, vv in v.items() if not isinstance(vv, dict)}
                      for k, v in res.items()}))
    log(f"  their CUDA graph capture: {len(captured)} launches replayed twice, bitwise: "
        f"{captured}")
    res["captured"] = captured
    return res


def check_roi_pool_kernels(torch, dev, b):
    """Phase [3] for ROIPool (own generator: the draws of the other cases
    stay as they were): the forward at serving 8 x 300 and 1 x 300 and
    training 8 x 128 rois on [38, 38, 256], float32 and bfloat16 features,
    integer-valued features (exact ties) and maps with NaN and +-inf; the
    backward at 8 x 128 from float32 and bfloat16 gradients, with ties, with
    non-finite maps and with 128 identical rois per image; both directions
    at 8 x 128 on ``clustered_boxes``, which overlap like the train step's
    proposals."""
    rng = np.random.default_rng(8)
    bf16 = torch.bfloat16

    def boxes(r):
        rois = torch.from_numpy(rand_boxes(rng, (b, r), 600, 300) * (FEAT[0] / 600)).to(dev)
        rois[:, :5] = torch.tensor([[-0.9, -0.9, 3.0, 3.0], [35.0, 34.0, 40.0, 41.0],
                                    [2.2, 2.2, 2.2, 2.2], [-5.0, -5.0, -2.0, -1.5],
                                    [float("nan"), 3.0, 9.0, 9.0]], device=dev)
        return rois

    feat = torch.from_numpy(rng.normal(0, 1, (b,) + FEAT).astype(np.float32)).to(dev)
    ties = torch.from_numpy(rng.integers(-3, 4, (b,) + FEAT).astype(np.float32)).to(dev)
    bad = feat.clone()
    for value in (float("nan"), float("inf"), float("-inf")):  # 24 of each
        flat = torch.from_numpy(rng.integers(0, bad.numel(), 24)).to(dev)
        bad.view(-1)[flat] = value
    rois, trois = boxes(300), boxes(128)
    res = {
        "pool_f32": check_roi_pool(torch, f"f32 8x300 {list(FEAT)}", feat, rois),
        "pool_bf16": check_roi_pool(torch, f"bf16 8x300 {list(FEAT)}", feat.to(bf16), rois),
        "pool_b1_bf16": check_roi_pool(torch, f"bf16 1x300 {list(FEAT)}", feat[:1].to(bf16),
                                       rois[:1].contiguous()),
        "pool_train_bf16": check_roi_pool(torch, f"bf16 8x128 {list(FEAT)}", feat.to(bf16),
                                          trois),
        "pool_ties_bf16": check_roi_pool(torch, "bf16 8x300 integer-valued (ties)",
                                         ties.to(bf16), rois),
        "pool_nonfinite_f32": check_roi_pool(torch, "f32 8x300 with NaN and +-inf", bad, rois),
    }
    g = torch.from_numpy(rng.normal(0, 1, (b, 128, 7, 7, FEAT[2])).astype(np.float32)).to(dev)
    same = torch.tensor([5.3, 7.1, 30.2, 33.9], device=dev).expand(b, 128, 4).contiguous()
    res.update({
        "pool_bwd_f32": check_roi_pool_bwd(torch, f"f32 8x128 {list(FEAT)}", g, feat, trois),
        "pool_bwd_bf16": check_roi_pool_bwd(torch, f"bf16 grad, bf16 8x128 {list(FEAT)}",
                                            g.to(bf16), feat.to(bf16), trois),
        "pool_bwd_ties_f32": check_roi_pool_bwd(torch, "f32 8x128 integer-valued (ties)", g,
                                                ties, trois),
        "pool_bwd_ties_bf16": check_roi_pool_bwd(torch, "bf16 grad, bf16 8x128 integer-valued",
                                                 g.to(bf16), ties.to(bf16), trois),
        "pool_bwd_nonfinite": check_roi_pool_bwd(torch, "f32 8x128 with NaN and +-inf", g, bad,
                                                 trois),
        "pool_bwd_identical": check_roi_pool_bwd(torch, "bf16 grad 8x128 identical rois",
                                                 g.to(bf16), feat.to(bf16), same),
    })
    crois = torch.from_numpy(clustered_boxes(rng, b, 128) * (FEAT[0] / 600)).to(dev)
    res.update({
        "pool_clustered_bf16": check_roi_pool(torch, "bf16 8x128 clustered rois", feat.to(bf16),
                                              crois),
        "pool_bwd_clustered": check_roi_pool_bwd(torch, "bf16 grad 8x128 clustered rois",
                                                 g.to(bf16), feat.to(bf16), crois),
    })
    return res


# ------------------------------------------------------- FPN multi-level ROIAlign

ML_SRC = ROI_SRC
ML_JAX = "replication_faster_rcnn_tpu/models/fpn.py:117"
ML_NOTE = ("not a Pallas kernel: the JAX package runs multilevel_roi_align (method='flat') as "
           "XLA gathers, and its VJP as their scatter")
NO_ML_LIBRARY = ("torch core has no multi-level ROIAlign (torchvision's MultiScaleRoIAlign is "
                 "not installed, and is a library kernel)")
FPN_LEVELS = ((150, 150), (75, 75), (38, 38), (19, 19))  # P2..P5 of a 600x600 image
FPN_C = 256
FPN_IMG = 600.0
ML_SIZES = (112.0, 224.0, 448.0)  # sqrt(area) at the level boundaries


def boundary_rois(torch, dev, b, r):
    """Rois whose sqrt(area) is exactly 112, 224 or 448 or one float32 ulp
    either side (squares, at several places), then zero-area, outside and
    huge ones, repeated to ``r`` per image."""
    rows = []
    for side in ML_SIZES:
        for step in (-1, 0, 1):
            s = np.float32(side)
            if step:
                s = np.nextafter(s, np.float32(np.inf if step > 0 else -np.inf), dtype=np.float32)
            for r1 in (0.0, 37.5, 600.0 - float(s)):
                rows.append([r1, 10.0, r1 + float(s), 10.0 + float(s)])
    rows += [[5.0, 5.0, 5.0, 5.0], [-80.0, -80.0, -20.0, -30.0], [590.0, 590.0, 700.0, 800.0],
             [0.0, 0.0, 600.0, 600.0], [-300.0, -300.0, 900.0, 900.0]]
    base = np.asarray(rows, np.float32)
    reps = np.resize(base, (r, 4))
    return torch.from_numpy(np.broadcast_to(reps, (b, r, 4)).copy()).to(dev)


def ml_pyramid(torch, rng, dev, b, dtype):
    return [torch.from_numpy(rng.normal(0, 1, (b, h, w, FPN_C)).astype(np.float32)).to(dev)
            .to(dtype) for h, w in FPN_LEVELS]


def ml_touched_bytes(torch, feats, rois, s):
    """Bytes of the level pixels the in-range samples of ``rois`` read (each
    once), from the plain version's own taps."""
    from replication_faster_rcnn_tpu_torch.models.fpn import roi_levels

    total = 0
    lv = roi_levels(rois)
    for li, f in enumerate(feats):
        n, h, w, c = f.shape
        sel = lv == li
        if not bool(sel.any()):
            continue
        sr, sc = h / FPN_IMG, w / FPN_IMG
        pts = (torch.arange(7 * s, device=rois.device, dtype=torch.float32) + 0.5) / s
        r1, c1, r2, c2 = rois.unbind(-1)
        bh = torch.clamp(r2 * sr - r1 * sr, min=1.0) / 7
        bw = torch.clamp(c2 * sc - c1 * sc, min=1.0) / 7
        rr = r1[..., None] * sr + pts * bh[..., None]
        cc = c1[..., None] * sc + pts * bw[..., None]
        marks = torch.zeros(n, h, w, dtype=torch.bool, device=rois.device)
        in_r = (rr >= -1) & (rr <= h)
        in_c = (cc >= -1) & (cc <= w)
        y = torch.clamp(rr, 0, h - 1)
        x = torch.clamp(cc, 0, w - 1)
        y0, x0 = y.floor().long(), x.floor().long()
        y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
        img = torch.arange(n, device=rois.device)[:, None, None, None].expand(
            n, rois.shape[1], 7 * s, 7 * s)
        inside = (in_r[..., :, None] & in_c[..., None, :]) & sel[..., None, None]
        for yi in (y0, y1):
            for xi in (x0, x1):
                yy = yi[..., :, None].expand_as(img)
                xx = xi[..., None, :].expand_as(img)
                marks[img[inside], yy[inside], xx[inside]] = True
        total += int(marks.sum()) * c * f.element_size()
    return total


def ml_bound(torch, feats, rois, out, s):
    """(bound_ms, bound_by) of one forward: the level pixels the in-range
    samples read, the rois and levels read once and the crops written once;
    9 float32 operations per output element and sample (4 products, 3 tap
    sums, the range flag's product, the accumulation) and the final scale."""
    nbytes = ml_touched_bytes(torch, feats, rois, s) + rois.numel() * 4 + rois.shape[0] * rois.shape[1] * 4 \
        + out.numel() * out.element_size()
    flops = out.numel() * (9 * s * s + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ml_bwd_bound(torch, grad_out, rois, shapes, feat_dtype, s):
    """(bound_ms, bound_by) of one backward: grad_out, rois and levels read
    once, the four levels' gradients written once (every pixel); one
    division per grad_out element and, per in-range sample, 4 taps x (2
    multiplies + 1 add) per channel."""
    from replication_faster_rcnn_tpu_torch.models.fpn import roi_levels

    elem = torch.empty((), dtype=feat_dtype).element_size()
    nbytes = (grad_out.numel() * grad_out.element_size() + rois.numel() * 4
              + rois.shape[0] * rois.shape[1] * 4 + sum(int(np.prod(sh)) for sh in shapes) * elem)
    lv = roi_levels(rois)
    inside = 0
    c = shapes[0][-1]
    for li, (n, h, w, _) in enumerate(shapes):
        sr, sc = h / FPN_IMG, w / FPN_IMG
        pts = (torch.arange(7 * s, device=rois.device, dtype=torch.float32) + 0.5) / s
        r1, c1, r2, c2 = rois.unbind(-1)
        rr = r1[..., None] * sr + pts * (torch.clamp(r2 * sr - r1 * sr, min=1.0) / 7)[..., None]
        cc = c1[..., None] * sc + pts * (torch.clamp(c2 * sc - c1 * sc, min=1.0) / 7)[..., None]
        in_r = ((rr >= -1) & (rr <= h)).sum(-1)
        in_c = ((cc >= -1) & (cc <= w)).sum(-1)
        inside += int((in_r * in_c * (lv == li)).sum())
    flops = grad_out.numel() + inside * c * 12
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_multilevel(torch, name, feats, rois, out_dtype):
    """Forward kernel against the plain version cast to ``out_dtype``
    (bitwise), then the times: the kernel with the levels given, the levels'
    own operations (``roi_levels``) apart, and the plain version."""
    from replication_faster_rcnn_tpu_torch.models.fpn import (
        multilevel_roi_align_plain,
        roi_levels,
    )
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import (
        _multilevel_forward_cuda,
        multilevel_roi_align_cuda,
    )

    out = multilevel_roi_align_cuda(feats, rois, FPN_IMG, FPN_IMG, 7, 2, out_dtype)
    want = multilevel_roi_align_plain(feats, rois, FPN_IMG, FPN_IMG, 7, 2).to(out_dtype)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    if not bitwise(torch, out, want):
        raise AssertionError(f"multilevel ROIAlign {name}: kernel differs from the plain "
                             f"version (max {err})")
    levels = roi_levels(rois)
    counts = torch.bincount(levels.reshape(-1).long(), minlength=4).tolist()
    ms = time_ms(torch, lambda: _multilevel_forward_cuda(feats, rois, levels, FPN_IMG, FPN_IMG,
                                                         7, 2, out_dtype), 20)
    levels_ms = time_ms(torch, lambda: roi_levels(rois), 20)
    plain_ms = time_ms(torch, lambda: multilevel_roi_align_plain(
        feats, rois, FPN_IMG, FPN_IMG, 7, 2).to(out_dtype), 3, 1)
    bound_ms, bound_by = ml_bound(torch, feats, rois, out, 2)
    log(f"  multilevel_roi_align {name}: bitwise equal to the plain version, rois per level "
        f"{counts}, kernel {ms:.4f} ms (+ roi_levels {levels_ms:.4f} ms), plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"ms": ms, "levels_ms": levels_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "rois_per_level": counts}


def check_multilevel_bwd(torch, name, grad_out, feats, rois):
    """Backward kernel: two launches bitwise equal, and against the plain
    VJP (autograd of the plain forward on float32 copies of the levels and
    the gradient) within ``ROI_BWD_TOL`` of the feature dtype; then the
    times."""
    from replication_faster_rcnn_tpu_torch.models.fpn import (
        multilevel_roi_align_plain,
        roi_levels,
    )
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import (
        multilevel_roi_align_backward_cuda,
    )

    dtype = feats[0].dtype
    shapes = [tuple(f.shape) for f in feats]
    levels = roi_levels(rois)

    def kernel():
        return multilevel_roi_align_backward_cuda(grad_out, rois, levels, shapes, dtype,
                                                  FPN_IMG, FPN_IMG, 7, 2)

    def plain():
        with torch.enable_grad():
            f32 = [f.detach().float().requires_grad_(True) for f in feats]
            out = multilevel_roi_align_plain(f32, rois, FPN_IMG, FPN_IMG, 7, 2)
            return torch.autograd.grad(out, f32, grad_out.float())

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    tol = ROI_BWD_TOL[str(dtype).split(".")[-1]]
    counts = torch.bincount(levels.reshape(-1).long(), minlength=4).tolist()
    err = 0.0
    for li, (g, a, w) in enumerate(zip(got, again, want)):
        if g.dtype != dtype or g.shape != w.shape:
            raise AssertionError(f"multilevel backward {name}: P{li + 2} got {g.dtype} "
                                 f"{tuple(g.shape)}")
        if not bitwise(torch, g, a):
            raise AssertionError(f"multilevel backward {name}: two launches differ at P{li + 2}")
        if counts[li] == 0 and bool(g.any()):
            raise AssertionError(f"multilevel backward {name}: P{li + 2} has no roi but a "
                                 "nonzero gradient")
        err = max(err, float((g.float() - w).abs().max()))
        if not torch.allclose(g.float(), w.to(dtype).float(), **tol):
            raise AssertionError(f"multilevel backward {name}: P{li + 2} max err {err} beyond "
                                 f"{tol}")
    ms = time_ms(torch, kernel, 10)
    plain_ms = time_ms(torch, plain, 2, 1)
    bound_ms, bound_by = ml_bwd_bound(torch, grad_out, rois, shapes, dtype, 2)
    log(f"  multilevel_roi_align_bwd {name}: max |kernel - plain VJP on float32| {err:.3e} "
        f"({tol}), two launches bitwise equal, rois per level {counts}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "deterministic": True, "rois_per_level": counts}


def level_sweep(torch, dev):
    """Squares whose side is every float32 within 4,096 ulps of the boundary
    sides, at two places (0 and 37.5: the second rounds the side once
    more), and 2^20 random rois of the 600x600 image."""
    sides = np.concatenate([
        (np.float32(v).view(np.int32) + np.arange(-4096, 4097, dtype=np.int32)).view(np.float32)
        for v in ML_SIZES])
    rows = [np.stack([r1 + 0 * sides, r1 + 0 * sides, r1 + sides, r1 + sides], -1)
            for r1 in (np.float32(0.0), np.float32(37.5))]
    rng = np.random.default_rng(13)
    rows.append(rand_boxes(rng, (1, 2**20), 600, 600)[0])
    return torch.from_numpy(np.concatenate(rows).astype(np.float32)).to(dev)


def check_levels(torch, dev, edge):
    """``roi_levels`` on the card equal to ``roi_levels`` on the CPU (held to
    the operation-by-operation JAX one by tests/test_torch_fpn.py) at the
    boundary-area rois and :func:`level_sweep`: the card's float32 log2
    puts no roi near a boundary area on another level."""
    from replication_faster_rcnn_tpu_torch.models.fpn import roi_levels

    out = {}
    for name, rois in (("boundary", edge), ("sweep", level_sweep(torch, dev))):
        card, host = roi_levels(rois).cpu(), roi_levels(rois.cpu())
        bad = int((card != host).sum())
        if bad:
            raise AssertionError(f"roi_levels {name}: {bad} of {card.numel()} rois get another "
                                 "level on the card than on the CPU")
        out[name] = {"rois": card.numel(), "differ": bad}
    log(f"  roi_levels on the card equal to the CPU's: {out}")
    return out


def elongated_rois(torch, rng, dev, b, r):
    """Random rois of which a quarter are long and thin: about 600 x 20 image
    pixels (150 x 5 on P2) wide or tall, in equal numbers, some reaching
    past the image."""
    boxes = rand_boxes(rng, (b, r), 600, 500)
    k = r // 4
    long_side = rng.uniform(560, 640, (b, k))
    short_side = rng.uniform(12, 24, (b, k))
    y, x = rng.uniform(-20, 600, (b, k)), rng.uniform(-40, 40, (b, k))
    wide = np.arange(k) < k // 2
    h = np.where(wide, short_side, long_side)
    w = np.where(wide, long_side, short_side)
    y, x = np.where(wide, y, x), np.where(wide, x, y)
    boxes[:, :k] = np.stack([y, x, y + h, x + w], -1)
    return torch.from_numpy(boxes.astype(np.float32)).to(dev)


def dense_rois(torch, rng, dev, b, r):
    """``r`` rois of sides 60-100 image pixels (all on P2) about one spot of
    each image: every one reaches the same few backward tiles, and P3-P5
    get no roi."""
    centre = rng.uniform(150, 450, (b, 1, 2))
    half = rng.uniform(30, 50, (b, r, 2))
    c = centre + rng.normal(0, 4, (b, r, 2))
    return torch.from_numpy(np.concatenate([c - half, c + half], -1).astype(np.float32)).to(dev)


def multilevel_cases(torch, dev, b=8):
    """[3]'s multi-level inputs at the 600x600 pyramid, drawn from one seed:
    the forward's ``{key: (label, levels, rois, out_dtype)}``, the
    backward's ``{key: (label, grad_out, levels, rois)}`` and the
    boundary-area rois."""
    rng = np.random.default_rng(11)
    bf16 = torch.bfloat16
    p32 = ml_pyramid(torch, rng, dev, b, torch.float32)
    p16 = [f.to(bf16) for f in p32]
    rois = torch.from_numpy(rand_boxes(rng, (b, 300), 600, 500)).to(dev)
    rois[:, :32] = boundary_rois(torch, dev, b, 32)
    one = rois[:1].contiguous()
    trois = torch.from_numpy(rand_boxes(rng, (b, 128), 600, 500)).to(dev)
    edge = boundary_rois(torch, dev, b, 128)
    crois = torch.from_numpy(clustered_boxes(rng, b, 128)).to(dev)
    g = torch.from_numpy(rng.normal(0, 1, (b, 128, 7, 7, FPN_C)).astype(np.float32)).to(dev)
    g16 = g.to(bf16)
    lrois = elongated_rois(torch, rng, dev, b, 300)
    drois = dense_rois(torch, rng, dev, b, 128)
    krois = torch.from_numpy(rand_boxes(rng, (1, 1000), 600, 500)).to(dev)
    g300 = torch.from_numpy(rng.normal(0, 1, (b, 300, 7, 7, FPN_C)).astype(np.float32)).to(dev)
    g1000 = torch.from_numpy(rng.normal(0, 1, (1, 1000, 7, 7, FPN_C)).astype(np.float32)).to(dev)
    p1_16, p1_32 = [f[:1] for f in p16], [f[:1] for f in p32]
    fwd = {
        "serve_b8_bf16": ("serve bf16 -> bf16 8x300", p16, rois, bf16),
        "serve_b8_f32": ("serve f32 -> f32 8x300", p32, rois, torch.float32),
        "serve_b1_bf16": ("serve bf16 -> bf16 1x300", p1_16, one, bf16),
        "serve_b1_f32": ("serve f32 -> f32 1x300", p1_32, one, torch.float32),
        "train_b8_bf16": ("train bf16 -> bf16 8x128", p16, trois, bf16),
        "boundary_bf16": ("boundary areas bf16 8x128", p16, edge, bf16),
        "clustered_bf16": ("clustered bf16 8x128", p16, crois, bf16),
        "elongated_bf16": ("elongated bf16 8x300", p16, lrois, bf16),
        "dense_bf16": ("one spot, all P2, bf16 8x128", p16, drois, bf16),
        "b1_1000_bf16": ("bf16 1x1000", p1_16, krois, bf16),
    }
    bwd = {
        "bwd_bf16": ("bf16 grad 8x128", g16, p16, trois),
        "bwd_f32": ("f32 8x128", g, p32, trois),
        "bwd_boundary": ("bf16 boundary areas 8x128", g16, p16, edge),
        "bwd_clustered": ("bf16 clustered 8x128", g16, p16, crois),
        "bwd_serve_300": ("bf16 8x300", g300.to(bf16), p16, rois),
        "bwd_elongated": ("bf16 elongated 8x300", g300.to(bf16), p16, lrois),
        "bwd_dense": ("bf16 one spot, P3-P5 without rois, 8x128", g16, p16, drois),
        "bwd_b1_1000": ("bf16 1x1000", g1000.to(bf16), p1_16, krois),
    }
    return fwd, bwd, edge


def check_multilevel_kernels(torch, dev, b=8):
    """Phase [3], the FPN's multi-level ROIAlign at the 600x600 pyramid
    (P2 150x150 .. P5 19x19, 256 channels; no side a multiple of the
    backward's 8-pixel tiles) on :func:`multilevel_cases`: the forward
    bitwise its plain version at every case; the backward deterministic,
    within ``ROI_BWD_TOL`` of the plain VJP and exactly zero on a level no
    roi lands on; each timed with its bound. Between them, the levels on
    the card against the CPU's (:func:`check_levels`)."""
    fwd, bwd, edge = multilevel_cases(torch, dev, b)
    res = {key: check_multilevel(torch, *case) for key, case in fwd.items()}
    levels = check_levels(torch, dev, edge)
    res.update({key: check_multilevel_bwd(torch, *case) for key, case in bwd.items()})
    return res, levels


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


def resize_ms_per_image(fn, images, cfg):
    """Host ms per image of ``fn`` (``resize_normalize`` or its numpy
    specification) to the configured size, over ``images``."""
    t0 = time.perf_counter()
    for img in images:
        fn(img, cfg.data.image_size, cfg.data.pixel_mean, cfg.data.pixel_std)
    return (time.perf_counter() - t0) * 1e3 / len(images)


ROI_NAMES = ("roi_align", "roi_align_bwd", "roi_pool", "roi_pool_bwd")


def roi_launches(op, forward=1, backward=0):
    """Expected ROI kernel launches: ``forward`` (and ``backward``) of the
    config's op (``align`` or ``pool``), none of the other."""
    want = {"roi_align": 0, "roi_align_bwd": 0, "roi_pool": 0, "roi_pool_bwd": 0}
    want[f"roi_{op}"], want[f"roi_{op}_bwd"] = forward, backward
    return want


def check_served(results, images, cfg, require_detections=True):
    """Detections of the right shape, finite and inside the original images,
    and (``require_detections``) at least one; returns the valid count per
    image."""
    for res, img in zip(results, images):
        if res["boxes"].shape != (cfg.eval.max_detections, 4):
            raise AssertionError(f"bad boxes shape {res['boxes'].shape}")
        if not (np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()):
            raise AssertionError("non-finite detections")
        h, w = img.shape[:2]
        if (res["boxes"][:, 0::2] > h + 1e-3).any() or (res["boxes"][:, 1::2] > w + 1e-3).any():
            raise AssertionError("boxes outside the original image")
    n_det = [int(r["valid"].sum()) for r in results]
    if require_detections and sum(n_det) == 0:
        raise AssertionError("no detections at all: the detection NMS saw no candidates")
    return n_det


def same_results(got, want, what):
    for g, w in zip(got, want):
        for k in g:
            if not np.array_equal(g[k], w[k]):
                raise AssertionError(f"{what}: output {k!r} differs from the plain run")


def phase_serve(torch, name="voc12_resnet18_align"):
    """Phase [4] for one preset: b1 and b8 flushes through ``InferenceEngine``
    in bfloat16, launch counts per flush (NMS 2, the preset's ROI forward 1,
    the other ROI op 0), every output bitwise against the plain replay, then
    stage ms and ``REPS`` timed requests of each size."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config, ops
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    cfg = get_config(name)
    size = cfg.data.image_size
    log(f"[4] main path: {name} {size} (ROI op {cfg.model.roi_op}) via InferenceEngine, params "
        "bfloat16")
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, resolutions=(size,), batch_sizes=(1, 8), params_dtype="bfloat16"))
    rng = np.random.default_rng(1)
    one = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    eight = mixed_images(rng)
    names = ("nms",) + ROI_NAMES

    # each flush is a graph replay: REPLAYS counts the launches its capture
    # recorded
    def reset():
        REPLAYS.reset(names)

    def read():
        return REPLAYS.read(names)

    with InferenceEngine(cfg, seed=0) as engine:
        log(f"  engine on {engine.device}, params {engine.params_bytes / 2**20:.1f} MiB "
            f"in {engine.params_dtype}, buckets {engine.buckets} x {engine.batch_sizes}")
        engine.predict(eight)  # captures the b8 graph (after its eager warm-up run)
        engine.submit(one).result(timeout=300)  # and the b1 graph

        want = {"nms": 2, **roi_launches(cfg.model.roi_op)}
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
        if flushes != [(("0", size, False), 1), (("0", size, False), 8)]:
            raise AssertionError(f"expected one b1 and one b8 flush, got {flushes}")
        if per_b1 != want or per_b8 != want:
            raise AssertionError(f"expected per flush {want}, got {per_b1} and {per_b8}")
        n_det = check_served([r1] + r8, [one] + eight, cfg)
        log(f"  detections per image (b1, then b8): {n_det}")

        # the same requests through the plain versions: every output equal
        ref1 = engine.submit(one, reference=True).result(timeout=600)
        ref8 = engine.predict(eight, reference=True)
        same_results([r1] + r8, [ref1] + ref8, name)
        batch = torch.zeros((8,) + size + (3,), device=engine.device)
        for i, img in enumerate(eight):
            batch[i] = torch.from_numpy(resize_normalize(
                img, size, cfg.data.pixel_mean, cfg.data.pixel_std))
        with torch.inference_mode():
            k_out = engine.model(batch)
            with ops.reference_scope():
                p_out = engine.model(batch)
        names = ("rpn_logits", "rpn_deltas", "rois", "roi_valid", "cls", "reg")
        for what, a, b in zip(names, k_out, p_out):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} differs between kernel and plain passes")
        log("  kernel pass == plain pass: rois, valid, cls, reg and all detections bitwise")

        stages = {f"b{n}": time_stages(torch, engine.model, cfg, batch[:n]) for n in (1, 8)}
        resize_ms = resize_ms_per_image(resize_normalize, eight, cfg)
        log(f"  stage ms (CUDA events, median of 5): {json.dumps(stages)}")
        log(f"  host resize_normalize: {resize_ms:.2f} ms per image (C++)")

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
            "config": name,
            "b1_latency_ms": statistics.median(lat),
            "b1_latency_note": f"submit->result, includes serving.max_delay_ms={cfg.serving.max_delay_ms}",
            "b1_flush_ms": statistics.median(flush[:REPS]) * 1e3,
            "b8_images_per_s": 8 / statistics.median(b8),
            "b8_flush_ms": statistics.median(flush[REPS:]) * 1e3,
            "b8_note": "predict(8 mixed-size uint8 images): host resize + one b8 flush",
            "reps": REPS,
            "stage_ms": stages,
            "host_resize_ms_per_image": resize_ms,
            "params_bytes": engine.params_bytes,
            "launches_per_flush": want,
        }
    log(f"  {name}: b1 latency {serve['b1_latency_ms']:.2f} ms (median of {REPS}, incl. "
        f"{cfg.serving.max_delay_ms} ms batching delay), b1 flush {serve['b1_flush_ms']:.2f} ms; "
        f"b8 {serve['b8_images_per_s']:.1f} images/s end to end, b8 flush "
        f"{serve['b8_flush_ms']:.2f} ms")
    return launches, serve


NEW_PRESETS = ("voc_resnet50", "coco_resnet50", "coco_vgg16")


def phase_presets(torch, device=None, size=None):
    """Phase [4] for the presets that only serve here: one b1 forward each
    through ``InferenceEngine`` in bfloat16 (seeded random weights), launch
    counts of the flush (NMS 2, the preset's ROI forward 1), detections
    bitwise equal to the plain replay, the flush time and the resident
    bytes; and the model's outputs (rois, valid, cls, reg) on the same image
    bitwise equal under ``ops.reference_scope()``, since an 81-class head
    with random weights may score no class above ``eval.score_thresh``.
    ``device``/``size`` default to the card and the preset's 600x600 (a CPU
    rehearsal passes ``"cpu"`` and a small size)."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config, ops
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    names = ("nms",) + ROI_NAMES
    launches = {k: 0 for k in names}
    out = {}
    for name in NEW_PRESETS:
        cfg = get_config(name)
        if size is not None:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=size))
        res = cfg.data.image_size
        cfg = cfg.replace(serving=dataclasses.replace(
            cfg.serving, resolutions=(res,), batch_sizes=(1,), params_dtype="bfloat16"))
        one = np.random.default_rng(1).integers(0, 256, res + (3,), dtype=np.uint8)
        with InferenceEngine(cfg, device=device, seed=0) as engine:
            engine.submit(one).result(timeout=300)  # captures the b1 graph
            REPLAYS.reset(names)
            got = engine.submit(one).result(timeout=300)  # a replay
            run = REPLAYS.read(names)
            flush_ms = engine.flush_seconds[-1] * 1e3
            want = {"nms": 2, **roi_launches(cfg.model.roi_op)}
            if run != want:
                raise AssertionError(f"{name}: expected per flush {want}, got {run}")
            n_det = check_served([got], [one], cfg, require_detections=False)
            same_results([got], [engine.submit(one, reference=True).result(timeout=600)], name)
            image = torch.from_numpy(resize_normalize(
                one, res, cfg.data.pixel_mean, cfg.data.pixel_std))[None].to(engine.device)
            with torch.inference_mode():
                k_out = engine.model(image)
                with ops.reference_scope():
                    p_out = engine.model(image)
            for what, a, b in zip(("rpn_logits", "rpn_deltas", "rois", "roi_valid", "cls", "reg"),
                                  k_out, p_out):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: {what} differs between kernel and plain passes")
            out[name] = {"b1_flush_ms": flush_ms, "params_bytes": engine.params_bytes,
                         "backbone": cfg.model.backbone, "roi_op": cfg.model.roi_op,
                         "num_classes": cfg.model.num_classes, "detections": n_det[0],
                         "launches_per_flush": want}
        for k in launches:
            launches[k] += run[k]
        log(f"[4] preset {name} ({cfg.model.backbone}, ROI {cfg.model.roi_op}, "
            f"{cfg.model.num_classes} classes) {res} b1 bfloat16: launches {run}; rois, cls, reg "
            f"and {n_det[0]} detections bitwise equal to the plain replay; flush {flush_ms:.2f} "
            f"ms, params {engine.params_bytes} bytes")
    return launches, out


def expected_int8_launches(artifact):
    """(GEMMs, dequantizes) per flush under the artifact's plan: the head's
    cls/reg layers run the GEMM when the head group stays int8; every other
    int8 weight is dequantized, all of them in one grouped launch."""
    from replication_faster_rcnn_tpu_torch.quant import QUANT_DENSE_PATHS

    dense = {"/".join(p) for p in QUANT_DENSE_PATHS}
    planned = [p for g, ps in artifact["groups"].items() if artifact["plan"][g] == "int8"
               for p in ps]
    gemm = sum(p in dense for p in planned)
    return gemm, int(len(planned) > gemm)


def allocated_by(torch, make):
    """(``make()``, the device bytes allocated while it ran and still held)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    obj = make()
    torch.cuda.synchronize()
    return obj, torch.cuda.memory_allocated() - base


def phase_int8_serve(torch, bf16, cfg=None, device=None):
    """``bf16``: phase [4]'s serving numbers, printed beside these.
    ``cfg``/``device`` default to the full configuration on the card (a CPU
    rehearsal passes a small configuration and ``"cpu"``)."""
    import dataclasses
    import gc

    from replication_faster_rcnn_tpu_torch import get_config, quant
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
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

    bf16_cfg = cfg.replace(serving=dataclasses.replace(cfg.serving, params_dtype="bfloat16"))
    eng, bf16_alloc = allocated_by(
        torch, lambda: InferenceEngine(bf16_cfg, device=dev, state_dict=state))
    eng.close()
    del eng
    engine, int8_alloc = allocated_by(
        torch, lambda: InferenceEngine(cfg, device=dev, state_dict=state, artifact_path=str(path)))
    with engine:
        log(f"  engine on {engine.device}: resident int8 tree {engine.params_bytes} bytes "
            f"({engine.params_bytes / f32_bytes:.4f} of the float32 weights' {f32_bytes}); "
            f"device memory after construction {int8_alloc} bytes against the bfloat16 "
            f"engine's {bf16_alloc}")
        if not engine.params_bytes < 0.4 * f32_bytes:
            raise AssertionError(f"int8 params {engine.params_bytes} >= 0.4 x {f32_bytes}")
        if not int8_alloc < bf16_alloc:
            raise AssertionError(f"int8 engine holds {int8_alloc} bytes, bf16 {bf16_alloc}")
        engine.predict(eight)  # captures the b8 graph (after its eager warm-up run)
        engine.submit(one).result(timeout=300)  # and the b1 graph
        names = ("int8_matmul", "dequantize", "nms", "roi_align")

        # each flush is a graph replay: REPLAYS counts the launches its
        # capture recorded
        def reset():
            REPLAYS.reset(names)

        def read():
            return REPLAYS.read(names)

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
        if flushes != [(("0", size, False), 1), (("0", size, False), 8)]:
            raise AssertionError(f"expected one b1 and one b8 flush, got {flushes}")
        if per_b1 != want or per_b8 != want:
            raise AssertionError(f"expected per flush {want}, got {per_b1} and {per_b8}")
        n_det = check_served([r1] + r8, [one] + eight, cfg)
        log(f"  detections per image (b1, then b8): {n_det}")

        ref1 = engine.submit(one, reference=True).result(timeout=600)
        ref8 = engine.predict(eight, reference=True)
        same_results([r1] + r8, [ref1] + ref8, "int8")
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


INT8_PRESETS_DIR = REPO / "build" / "chip_smoke_int8_presets"


def phase_int8_presets(torch, device=None, size=None):
    """Phase [5] for ``voc_resnet50``, ``coco_resnet50`` and ``coco_vgg16``:
    each calibrated in this process on its seeded float32 weights (all-int8
    plan), served in int8 through ``InferenceEngine`` graphs at one bucket x
    b1, b8: one b1 and one b8 flush, their launches counted as replays
    (int8 GEMM 2, dequantize 1, NMS 2, the preset's ROI forward 1), every
    detection bitwise the plain replay; the resident bytes (under 0.4 x
    float32), the graphs' pool bytes and the flush times; and the int8
    forward's outputs (rois, valid, cls, reg) on the b1 image bitwise under
    ``ops.reference_scope()``, since an 81-class head with random weights may
    score no detection. ``device``/``size``: a CPU rehearsal passes
    ``"cpu"`` and a small size."""
    import dataclasses
    import gc

    from replication_faster_rcnn_tpu_torch import get_config, ops, quant
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import (
        build_model,
        functional_forward,
    )
    from replication_faster_rcnn_tpu_torch.quant.apply import build_infer_variables
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    dev = torch.device(device or "cuda")
    root = fresh_dir(INT8_PRESETS_DIR)
    launches, out = {}, {}
    for name in NEW_PRESETS:
        t0 = time.perf_counter()
        cfg = get_config(name)
        if size is not None:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=size))
        res = cfg.data.image_size
        cfg = cfg.replace(serving=dataclasses.replace(
            cfg.serving, resolutions=(res,), batch_sizes=(1, 8), params_dtype="int8"))
        model = build_model(cfg, device=dev, seed=0)
        state = model.state_dict()
        qc = cfg.quant
        batches = quant.synthetic_calibration_batches(cfg, qc.calib_batches, qc.calib_batch_size)
        artifact = quant.calibrate(model, state, batches, cfg)
        path = root / f"{name}.json"
        quant.save_artifact(str(path), artifact)
        f32_bytes = sum(t.numel() * 4 for t in state.values())
        state = {k: v.cpu() for k, v in state.items()}
        del model
        gc.collect()
        gemm, deq = expected_int8_launches(artifact)
        roi = f"roi_{cfg.model.roi_op}"
        want = {"int8_matmul": gemm, "dequantize": deq, "nms": 2, roi: 1}
        if (gemm, deq) != (2, 1):
            raise AssertionError(f"{name}: the plan {artifact['plan']} runs {gemm} GEMMs and "
                                 f"{deq} dequantizes a flush, not 2 and 1")
        names = tuple(want)
        rng = np.random.default_rng(5)
        one = rng.integers(0, 256, res + (3,), dtype=np.uint8)
        eight = [rng.integers(0, 256, res + (3,), dtype=np.uint8) for _ in range(8)]
        with InferenceEngine(cfg, device=dev, state_dict=state, artifact_path=str(path)) as eng:
            pool = graph_memory(torch, eng) if eng.capture else 0
            REPLAYS.reset(names)
            r1 = eng.submit(one).result(timeout=300)
            per_b1 = REPLAYS.read(names)
            REPLAYS.reset(names)
            r8 = eng.predict(eight)
            per_b8 = REPLAYS.read(names)
            if eng.capture and (per_b1 != want or per_b8 != want):
                raise AssertionError(f"{name} int8: expected per replay {want}, got {per_b1} "
                                     f"and {per_b8}")
            flush_ms = [t * 1e3 for t in list(eng.flush_seconds)[-2:]]
            n_det = check_served([r1] + r8, [one] + eight, cfg, require_detections=False)
            same_results([r1] + r8, [eng.submit(one, reference=True).result(timeout=600)]
                         + eng.predict(eight, reference=True), f"{name} int8")
            # a random 81-class head may score no class above
            # eval.score_thresh: the int8 forward's outputs too, kernels
            # against plain versions
            qvars = eng._resident[eng.model_version].infer[res].args[0]
            image = torch.from_numpy(resize_normalize(
                one, res, cfg.data.pixel_mean, cfg.data.pixel_std))[None].to(dev)
            outs = []
            for reference in (False, True):
                with ops.reference_scope(reference):
                    v = build_infer_variables(qvars, cfg)
                    outs.append(functional_forward(eng.model, v["params"], image, v["quant"]))
            for what, a, b in zip(("rpn_logits", "rpn_deltas", "rois", "roi_valid", "cls",
                                   "reg"), *outs):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} int8: {what} differs between kernel and "
                                         "plain passes")
            if not eng.params_bytes < 0.4 * f32_bytes:
                raise AssertionError(f"{name}: int8 params {eng.params_bytes} >= 0.4 x "
                                     f"{f32_bytes}")
            out[name] = {"params_bytes": eng.params_bytes, "f32_params_bytes": f32_bytes,
                         "graph_pool_bytes": pool, "b1_flush_ms": flush_ms[0],
                         "b8_flush_ms": flush_ms[1], "detections": n_det,
                         "embed_range": artifact["activation_ranges"][quant.EMBED_RANGE_KEY],
                         "launches_per_flush": want, "seconds": time.perf_counter() - t0}
        for k in names:
            launches[k] = launches.get(k, 0) + per_b1[k] + per_b8[k]
        log(f"[5] preset {name} int8 {res} x b1, b8: launches per replay {per_b1}; every "
            f"detection bitwise the plain replay; resident {out[name]['params_bytes']} bytes "
            f"({out[name]['params_bytes'] / f32_bytes:.4f} of float32), graph pool "
            f"{pool / 2**20:.1f} MiB, flush b1 {flush_ms[0]:.2f} ms, b8 {flush_ms[1]:.2f} ms; "
            f"{out[name]['seconds']:.1f} s")
        del state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches, out


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
# the ROI kernels of each op, by direction (the ROIPool backward is two kernels)
ROI_KERNELS = {
    "align": {"forward": ("roi_align_kernel",), "backward": ("roi_align_bwd_kernel",)},
    "pool": {"forward": ("roi_pool_kernel",),
             "backward": ("roi_pool_bwd_bins_kernel", "roi_pool_bwd_kernel")},
    "multilevel": {"forward": ("multilevel_roi_align_kernel",),
                   "backward": ("multilevel_roi_geometry_kernel",
                                "multilevel_roi_align_bwd_kernel")},
}
IOU_KERNEL = "iou_match_kernel"


def busy_and_span(intervals):
    """(the length of the union of ``(start, end)`` intervals, the span from
    the first start to the last end); the intervals must not be empty."""
    spans = sorted(intervals)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return busy, max(e for _, e in spans) - spans[0][0]


def device_timeline(torch, run, steps, roi_op="align"):
    """torch.profiler over ``run`` (``steps`` training steps): the device's
    busy time (union of kernel and copy intervals), the span from its first
    to its last activity, the idle share of that span, the kernels with the
    most device time, the NMS kernels' device ms per step (mask and walk
    apart and summed), the ROIAlign kernels' (forward and backward) and the
    IoU-matching kernel's (both sites, with its count of activities per
    step) and every hand-written kernel's activities per step; the ROI
    kernels are those of ``roi_op``. None when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]  # kernels and copies
    if not acts:
        return None
    busy, span = busy_and_span((e.time_range.start, e.time_range.end) for e in acts)
    by_name, by_short = {}, {}
    for e in acts:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_short[e.name[:90]] = by_short.get(e.name[:90], 0.0) + us
    # names cut to 90 characters, each cut name's activities summed
    top = sorted(by_short.items(), key=lambda kv: -kv[1])[:10]
    def per_step(kernel):
        return sum(us for name, us in by_name.items() if kernel in name) / 1e3 / steps

    nms = {k: per_step(k) for k in NMS_KERNELS}
    return {
        "nms_device_ms_per_step": sum(nms.values()),
        "nms_device_ms_per_step_by_kernel": nms,
        "roi_device_ms_per_step": {k: sum(per_step(n) for n in names)
                                   for k, names in ROI_KERNELS[roi_op].items()},
        "iou_match_device_ms_per_step": per_step(IOU_KERNEL),
        "iou_match_activities_per_step": sum(IOU_KERNEL in e.name for e in acts) / steps,
        "kernel_activities_per_step": {
            k: sum(k in e.name for e in acts) / steps
            for k in NMS_KERNELS + sum(ROI_KERNELS[roi_op].values(), ()) + (IOU_KERNEL,)},
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_span_ms_per_step": span / 1e3 / steps,
        "device_idle_share": 1.0 - busy / span,
        "device_activities_per_step": len(acts) / steps,
        "top_device_ms_per_step": {name: us / 1e3 / steps for name, us in top},
    }


# every kernel wrapper's launch counter, (wrapper module, attribute) by this
# script's names
COUNTERS = {
    "nms": ("nms_kernel", "launches"), "iou_match": ("iou_kernel", "launches"),
    "roi_align": ("roi_kernel", "launches"), "roi_align_bwd": ("roi_kernel", "backward_launches"),
    "roi_pool": ("roi_kernel", "pool_launches"),
    "roi_pool_bwd": ("roi_kernel", "pool_backward_launches"),
    "roi_multilevel": ("roi_kernel", "multilevel_launches"),
    "roi_multilevel_bwd": ("roi_kernel", "multilevel_backward_launches"),
    "int8_matmul": ("quant_kernel", "matmul_launches"),
    "dequantize": ("quant_kernel", "dequantize_launches"),
    "augment_geometry": ("image_kernel", "geometry_launches"),
    "augment_prepare": ("image_kernel", "prepare_launches"),
    "image_fill": ("image_kernel", "fill_launches"),
    "augment_image": ("image_kernel", "image_launches"),
    "resize_aa": ("image_kernel", "resize_launches"),
}
IMAGE_NAMES = ("augment_geometry", "augment_prepare", "image_fill", "augment_image", "resize_aa")


def counter_module(mod):
    import importlib

    return importlib.import_module(f"replication_faster_rcnn_tpu_torch.ops.cuda.{mod}")


def read_counters():
    """Every wrapper's launch counter, by this script's names."""
    return {k: getattr(counter_module(m), a) for k, (m, a) in COUNTERS.items()}


def write_counters(values):
    for k, v in values.items():
        m, a = COUNTERS[k]
        setattr(counter_module(m), a, v)


class GraphReplays:
    """The kernel launches of the train step's CUDA graph replays.

    A wrapper counts a launch when Python calls it. A capture's calls only
    record launches, which run at each replay, and a replay calls no Python.
    Once installed (:meth:`install`), each capture of ``train_step.CapturedSteps``
    takes its counter increments back and keeps them as that graph's
    launches per replay, and each replay adds them to :attr:`counts`. [6]
    holds these counts against the kernels the profiler saw the card run."""

    def __init__(self):
        self.counts = {}
        # while set, every serving flush call (staging, input copy, replay,
        # output copy, event wait) runs under sync debug mode "error": an
        # implicit host sync raises
        self.sync_check = False

    def install(self):
        from replication_faster_rcnn_tpu_torch.serving.engine import ServingGraph
        from replication_faster_rcnn_tpu_torch.train.train_step import CapturedSteps

        self._install_serving(ServingGraph)
        capture, call, replays = CapturedSteps._capture, CapturedSteps.__call__, self

        def counted_capture(graph, state, batches):
            before = read_counters()
            try:
                capture(graph, state, batches)
            finally:
                after = read_counters()
                write_counters(before)
            graph.per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}

        def counted_call(graph, state, batches):
            replay = graph.graph is not None
            out = call(graph, state, batches)
            if replay:
                for k, n in graph.per_replay.items():
                    replays.counts[k] = replays.counts.get(k, 0) + n
            return out

        CapturedSteps._capture, CapturedSteps.__call__ = counted_capture, counted_call

    def _install_serving(self, graph_cls):
        """The same for the serving engine's flush graphs: a capture's
        counts are taken back and kept as the graph's launches per replay
        (its eager warm-up run before the capture counts as it ran), and
        with :attr:`sync_check` each call runs under sync debug mode
        "error"."""
        import torch

        capture, call, replays = graph_cls._capture, graph_cls.__call__, self

        def counted_capture(graph):
            before = read_counters()
            try:
                capture(graph)
            finally:
                after = read_counters()
                write_counters(before)
            graph.per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}

        def counted_call(graph, images):
            checked = replays.sync_check
            if checked:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = call(graph, images)
            finally:
                if checked:
                    torch.cuda.set_sync_debug_mode(0)
            for k, n in graph.per_replay.items():
                replays.counts[k] = replays.counts.get(k, 0) + n
            return out

        graph_cls._capture, graph_cls.__call__ = counted_capture, counted_call

    def reset(self, names):
        """Set the wrappers' counters ``names`` and the replays' counts to 0."""
        write_counters({k: 0 for k in names})
        self.counts = {}

    def read(self, names):
        """Launches since :meth:`reset`: the wrappers' eager calls plus the
        replays' launches, for ``names``."""
        eager = read_counters()
        return {k: eager[k] + self.counts.get(k, 0) for k in names}


REPLAYS = GraphReplays()


def bitwise(torch, a, b):
    """Two tensors with the same dtype, shape and bits (NaN included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def metrics_differences(torch, got, want):
    """The steps and keys at which two lists of per-step metric dicts differ
    bitwise."""
    if len(got) != len(want):
        return [("steps", len(got), len(want))]
    return [(i, k) for i, (g, w) in enumerate(zip(got, want)) for k in w
            if not bitwise(torch, g[k], w[k])]


def timed_steps(torch, run, n):
    """CUDA-event ms of ``n`` calls of ``run(i)``."""
    out = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(i)
        end.record()
        out.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in out]


def footprint(torch, dev, build, calls):
    """The device memory of one training path, measured alone: from an
    emptied cache, ``build()`` makes its state, then each ``(name, fn)`` of
    ``calls`` runs ``fn(state)``. GiB: the reserved memory's growth since
    before the build after each call, its peak over all (the allocator's
    peak reserved, graph pools included) and the peak allocated (tensors
    in use; a replay allocates nothing, its pool is reserved), both above
    the starting point, and what the path keeps after
    ``torch.cuda.empty_cache()``: its parameters, optimizer state and graph
    pools."""
    import gc

    gib = 2**-30
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reserved0, allocated0 = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
    state = build()
    out = {"reserved_growth_gib_after": {}}
    for name, fn in calls:
        fn(state)
        torch.cuda.synchronize(dev)
        out["reserved_growth_gib_after"][name] = (torch.cuda.memory_reserved(dev) - reserved0) * gib
    out["peak_reserved_gib"] = (torch.cuda.max_memory_reserved(dev) - reserved0) * gib
    out["peak_allocated_gib"] = (torch.cuda.max_memory_allocated(dev) - allocated0) * gib
    torch.cuda.empty_cache()
    out["kept_gib"] = (torch.cuda.memory_reserved(dev) - reserved0) * gib
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def timed_train_path(torch, dev, tag, trainer, batches, names, want, roi_op, op_name):
    """``TRAIN_REPS`` timed steps of one training path (``trainer.step_fn``
    on the staged ``batches``): the launches of ``names`` equal ``want`` a
    step, no growth of the reserved device memory, finite metrics and no
    withheld step; then 3 steps under :func:`device_timeline` with their
    launches counted too. The ROI kernels of the timeline are ``roi_op``'s."""
    torch.cuda.synchronize(dev)
    reserved = torch.cuda.memory_reserved(dev)
    REPLAYS.reset(names)
    history = []
    ms = timed_steps(torch, lambda i: history.append(
        trainer.step_fn(trainer.state, batches[i % 2])), TRAIN_REPS)
    launches = REPLAYS.read(names)
    grown = torch.cuda.memory_reserved(dev) - reserved
    log(f"  {tag}: launches in {TRAIN_REPS} timed steps {launches}; reserved memory grew "
        f"{grown} bytes over them")
    if launches != {k: v * TRAIN_REPS for k, v in want.items()}:
        raise AssertionError(f"{tag}: expected per step {want}, got {launches} over "
                             f"{TRAIN_REPS} steps")
    if grown > 2**21:  # more than one small-allocation segment
        raise AssertionError(f"{tag} steps grew the reserved device memory by {grown} bytes")
    rows = [{k: float(v) for k, v in m.items()} for m in history]
    for row in rows:
        bad_keys = [k for k in ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss",
                                "head_reg_loss", "grad_norm") if not np.isfinite(row[k])]
        if bad_keys or row["skipped"] != 0.0:
            raise AssertionError(f"{tag}: non-finite training metrics {bad_keys} "
                                 f"(skipped {row['skipped']})")

    def three_steps():
        for i in range(3):
            trainer.step_fn(trainer.state, batches[i % 2])

    # the profiled steps' counted launches against the kernels the card ran
    REPLAYS.reset(names)
    timeline = device_timeline(torch, three_steps, 3, roi_op)
    profiled = REPLAYS.read(names)
    if profiled != {k: v * 3 for k, v in want.items()}:
        raise AssertionError(f"{tag}: expected per step {want}, got {profiled} over the 3 "
                             "profiled steps")
    if timeline is None:
        log(f"  {tag} device timeline: the profiler saw no device activity (not measured)")
    else:
        log(f"  {tag} device timeline (torch.profiler, 3 steps): busy "
            f"{timeline['device_busy_ms_per_step']:.2f} ms of a "
            f"{timeline['device_span_ms_per_step']:.2f} ms span per step, idle share "
            f"{timeline['device_idle_share']:.3f}, "
            f"{timeline['device_activities_per_step']:.0f} device activities per step; "
            f"NMS {timeline['nms_device_ms_per_step']:.4f} ms, {op_name} "
            f"{ {k: round(v, 4) for k, v in timeline['roi_device_ms_per_step'].items()} }, "
            f"IoU matching {timeline['iou_match_device_ms_per_step']:.4f} ms in "
            f"{timeline['iou_match_activities_per_step']:g} activities")
    return {"launches": launches, "step_ms_all": ms, "step_ms": statistics.median(ms),
            "losses_first_last": [rows[0]["loss"], rows[-1]["loss"]],
            "reserved_growth_bytes": grown, "device_timeline": timeline}


def check_train_timelines(out, what):
    """The captured and eager timelines of :func:`timed_train_path` (both or
    neither measured): every kernel seen with device time, the top kernels'
    times within the busy time, 2 IoU-matching activities a step, and each
    hand-written kernel as often a step in the replay as in the eager
    step."""
    timelines = {tag: out[tag]["device_timeline"] for tag in ("captured", "eager")}
    if None not in timelines.values():
        log(f"  {what}most device time per step (captured): "
            f"{ {k: round(v, 3) for k, v in timelines['captured']['top_device_ms_per_step'].items()} }")
        for tag, timeline in timelines.items():
            roi_ms = timeline["roi_device_ms_per_step"]
            if not (timeline["nms_device_ms_per_step"] > 0 and roi_ms["forward"] > 0
                    and roi_ms["backward"] > 0 and timeline["iou_match_device_ms_per_step"] > 0):
                raise AssertionError(f"{what}{tag}: the profiler saw device activity but not "
                                     f"every kernel: {timeline}")
            top_sum = sum(timeline["top_device_ms_per_step"].values())
            if top_sum > timeline["device_busy_ms_per_step"] * (1 + 1e-9):
                raise AssertionError(f"{what}{tag}: the top kernels' device ms per step add up "
                                     f"to {top_sum}, more than the busy "
                                     f"{timeline['device_busy_ms_per_step']}")
            if timeline["iou_match_activities_per_step"] != 2:  # one kernel per call
                raise AssertionError(f"{what}{tag}: "
                                     f"{timeline['iou_match_activities_per_step']:g} "
                                     "IoU-matching kernel activities per step, not 2")
        # a replay runs every hand-written kernel the eager step runs, as often
        kernel_acts = {tag: t["kernel_activities_per_step"] for tag, t in timelines.items()}
        if kernel_acts["captured"] != kernel_acts["eager"]:
            raise AssertionError(f"{what}hand-written kernel activities per step differ: "
                                 f"{kernel_acts}")
        log(f"  {what}the profiler saw every kernel in both timelines, the same activities per "
            f"step {kernel_acts['captured']}")
    elif timelines["captured"] is not None or timelines["eager"] is not None:
        raise AssertionError(f"{what}the profiler saw device activity in one timeline only: "
                             f"{ {k: v is not None for k, v in timelines.items()} }")


def phase_train(torch, name="voc12_resnet18_align", cfg=None, device=None):
    """Phase [6] for one preset. ``cfg``/``device`` default to the preset's
    full configuration on the card (a CPU rehearsal passes a small
    configuration and ``"cpu"``)."""
    import dataclasses
    import gc

    from replication_faster_rcnn_tpu_torch import get_config, ops
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
    from replication_faster_rcnn_tpu_torch.train.train_step import compute_losses, make_train_step
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = cfg or get_config(name)
    dev = torch.device(device or "cuda")
    bsz = cfg.train.batch_size
    op = cfg.model.roi_op
    op_name = {"align": "ROIAlign", "pool": "ROIPool"}[op]
    log(f"[6] main path: train {name} {cfg.data.image_size} batch {bsz} (ROI op {op}), "
        f"compute {cfg.model.compute_dtype}, {cfg.proposals.pre_nms_train} -> "
        f"{cfg.proposals.post_nms_train} proposals, optimizer {cfg.train.optimizer} lr "
        f"{cfg.train.lr}; every step a CUDA graph replay, against the same steps eager")
    dataset = SyntheticDataset(cfg.data, length=2 * bsz)

    def make(**train):
        c = cfg.replace(train=dataclasses.replace(cfg.train, **train))
        return Trainer(c, dataset, device=dev, seed=0)

    cap, eag = make(), make()
    eag.step_fn = make_train_step(cfg, capture=False)
    cap.loader.set_epoch(0)
    host = list(cap.loader)  # epoch 0's batches in the trainer's order
    poisoned = dict(host[0], image=host[0]["image"].copy())
    poisoned["image"][0, 3, 3, 0] = np.nan  # the guarded update withholds this step
    batches = [cap.stage_batch(b) for b in host]
    bad = cap.stage_batch(poisoned)
    n_params = sum(p.numel() for p in cap.model.parameters())
    log(f"  trainers on {cap.device}, {n_params / 1e6:.2f} M parameters (float32), "
        f"{cap.steps_per_epoch} steps per epoch")

    # the same 6 steps, step 3 poisoned, captured and eager; the first step
    # of each compiles (cuDNN handles, constants; the captured trainer's
    # first call runs its step eagerly and captures it), the other five run
    # under torch.cuda.set_sync_debug_mode("error"): no host read
    order = [batches[0], batches[1], bad, batches[1], batches[0], batches[1]]
    hist = {"captured": [], "eager": []}
    t0 = time.perf_counter()
    for i, batch in enumerate(order):
        for tag, trainer in (("captured", cap), ("eager", eag)):
            if i > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                hist[tag].append(trainer.train_one_batch(staged=batch))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    diff = state_differences(torch, cap, eag)
    mdiff = metrics_differences(torch, hist["captured"], hist["eager"])
    skipped = [float(m["skipped"]) for m in hist["captured"]]
    if diff or mdiff or skipped != [0, 0, 1, 0, 0, 0]:
        raise AssertionError(f"captured vs eager steps: state differs in {diff[:5]}, metrics in "
                             f"{mdiff[:5]}; skipped {skipped}")
    graphs = list(cap.state.graphs.values())
    log(f"  6 steps (step 3 NaN-poisoned, withheld) captured and eager, {first_s:.1f} s with the "
        f"capture: bitwise equal in parameters, BatchNorm statistics, mu, nu, count, the "
        f"generator's state, the step and every metric; steps 2-6 ran under "
        f"set_sync_debug_mode('error') without a host read; {len(graphs)} graph, launches "
        f"per replay {graphs[0].per_replay}")

    names = ("nms", "iou_match") + ROI_NAMES
    want = {"nms": 1, "iou_match": 2, **roi_launches(op, 1, 1)}
    out = {tag: timed_train_path(torch, dev, tag, trainer, batches, names, want, op, op_name)
           for tag, trainer in (("captured", cap), ("eager", eag))}
    for tag in out:
        log(f"  {tag}: {out[tag]['step_ms']:.2f} ms a step (median of {TRAIN_REPS}, CUDA "
            f"events, batch staged on the card), {bsz / out[tag]['step_ms'] * 1e3:.1f} images/s")
    check_train_timelines(out, "")

    # each path's device memory alone: a fresh trainer, its first calls (the
    # captured paths' warm-up and capture), then replays
    def steps(n):
        return lambda tr: [tr.train_one_batch(staged=batches[i % 2]) for i in range(n)]

    def eager_trainer():
        tr = make()
        tr.step_fn = make_train_step(cfg, capture=False)
        return tr

    memory = {
        "eager": footprint(torch, dev, eager_trainer, [("step 1", steps(1)),
                                                       ("steps 2-3", steps(2))]),
        "captured": footprint(torch, dev, make, [("capture", steps(1)),
                                                 ("2 replays", steps(2))]),
        "k4": footprint(torch, dev, lambda: make(steps_per_dispatch=4), [
            ("capture K=4", lambda tr: tr.train_chunk(staged=batches[:2] * 2)),
            ("capture the 1-step tail", steps(1)),
            ("replays", lambda tr: (tr.train_chunk(staged=batches[:2] * 2), steps(1)(tr)))]),
    }
    for tag, m in memory.items():
        log(f"  {tag} path's device memory, alone (GiB): {m}")

    # per-stage ms of one more eager step, CUDA events around each stage
    timer = StageTimer(torch)
    eag.step_fn(eag.state, batches[0], stage=timer)
    stages = timer.ms()
    log(f"  stage ms (one eager step, CUDA events): "
        f"{ {k: round(v, 3) for k, v in stages.items()} }")

    # steps_per_dispatch=4 against single steps: two chunks (the first runs
    # eagerly and captures, the second replays; a poisoned batch in each),
    # the 1-step tail graph in the same pool (capture, replay), and one more
    # chunk replay after it
    k4, one = make(steps_per_dispatch=4), make()
    chunk_order = [batches[0], batches[1], bad, batches[0], batches[1], batches[0], bad,
                   batches[1]]
    chunked = [k4.train_chunk(staged=chunk_order[:4]), k4.train_chunk(staged=chunk_order[4:]),
               k4.train_one_batch(staged=batches[1]), k4.train_one_batch(staged=batches[0]),
               k4.train_chunk(staged=chunk_order[:4])]
    singles = [one.train_one_batch(staged=b)
               for b in chunk_order + [batches[1], batches[0]] + chunk_order[:4]]
    rows_k = [{k: v[j] for k, v in m.items()} if m["loss"].dim() else m
              for m in chunked for j in range(m["loss"].numel())]
    diff = state_differences(torch, k4, one)
    mdiff = metrics_differences(torch, rows_k, singles)
    if diff or mdiff:
        raise AssertionError(f"steps_per_dispatch=4 vs single steps: state differs in {diff[:5]},"
                             f" metrics in {mdiff[:5]}")
    chunk_ms = timed_steps(torch, lambda i: k4.train_chunk(
        staged=[batches[(i + j) % 2] for j in range(4)]), 3)
    per_step_k4 = statistics.median(chunk_ms) / 4
    log(f"  steps_per_dispatch=4: two chunks (8 steps, a withheld step in each, the second "
        f"chunk a replay), two 1-step tails (capture and replay in the chunk graph's pool) and "
        f"a third chunk bitwise equal to 14 single captured steps in state and metrics; "
        f"{per_step_k4:.2f} ms a step (median of 3 replays of 4 steps)")
    del k4, one

    # the same state and draws: kernel pass vs plain pass (forward + backward)
    model, state = eag.model, eag.state
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
    before = read_counters()
    pm, prec, pgrads, pstats = pass_(True, krec["draws"])
    if before != read_counters():
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
    # the head's losses alone reach the trunk through the ROI kernels
    _, _, hgrads, _ = pass_(False, krec["draws"], (0.0, 0.0, 1.0, 1.0))
    trunk = hgrads[[n for n, _ in model.named_parameters()].index("trunk.conv1.weight")]
    if trunk is None or not float(trunk.abs().sum()) > 0:
        raise AssertionError("the head's losses gave the trunk no gradient")
    model.zero_grad(set_to_none=True)
    log(f"  the head's losses alone give the trunk a gradient ({op_name} forward + backward "
        "kernels)")

    cap_ms, eag_ms = out["captured"]["step_ms"], out["eager"]["step_ms"]
    train = {
        "config": name,
        "step_ms": cap_ms,
        "images_per_s": bsz / cap_ms * 1e3,
        "eager_step_ms": eag_ms,
        "eager_images_per_s": bsz / eag_ms * 1e3,
        "k4_step_ms": per_step_k4,
        "captured": out["captured"],
        "eager": out["eager"],
        "memory_gib": memory,
        "stage_ms": stages,
        "grad_max_rel_l2_err_vs_plain": grad_err,
    }
    idle = {tag: (out[tag]["device_timeline"] or {}).get("device_idle_share")
            for tag in ("captured", "eager")}
    log(f"  {name}: train step {cap_ms:.2f} ms captured against {eag_ms:.2f} ms eager "
        f"({train['images_per_s']:.1f} against {train['eager_images_per_s']:.1f} images/s), "
        f"device idle share { {k: 'not measured' if v is None else round(v, 3) for k, v in idle.items()} }")
    launches = out["captured"]["launches"]
    eager_launches = out["eager"]["launches"]
    del cap, eag
    gc.collect()
    torch.cuda.empty_cache()
    return launches, eager_launches, train


VOC_SIZES = ((375, 500), (500, 333), (333, 500), (500, 375), (480, 640), (366, 500),
             (500, 400), (281, 500))  # (H, W) shapes common in Pascal VOC


class VOCLikeDataset:
    """``n`` seeded uint8 images of VOC's common sizes, each with 1-4 planted
    class-coloured rectangles (about 1 in 8 marked difficult), held as
    decoded pixels: ``__getitem__`` runs the C++ resize and box scaling as
    the VOC reader does after its decode, so no JPEG codec is needed.
    Samples are the VOC reader's (``data/voc.py``)."""

    def __init__(self, data_cfg, n=64, seed=0, num_classes=21):
        rng = np.random.default_rng(seed)
        self.cfg = data_cfg
        m = data_cfg.max_boxes
        self.images, self.boxes, self.labels, self.difficult = [], [], [], []
        for i in range(n):
            h, w = VOC_SIZES[i % len(VOC_SIZES)]
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            boxes = np.full((m, 4), -1.0, np.float32)
            labels = np.full((m,), -1, np.int32)
            difficult = np.zeros((m,), bool)
            for j in range(int(rng.integers(1, 5))):
                bh, bw = int(rng.integers(h // 6, h // 2)), int(rng.integers(w // 6, w // 2))
                r1, c1 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
                cls = int(rng.integers(1, num_classes))
                colour = 80 + 170 * np.asarray([cls % 3, (cls // 3) % 3, (cls // 9) % 3]) / 2
                img[r1:r1 + bh, c1:c1 + bw] = np.clip(
                    colour + rng.integers(-12, 13, (bh, bw, 3)), 0, 255).astype(np.uint8)
                boxes[j] = [r1, c1, r1 + bh, c1 + bw]
                labels[j] = cls
                difficult[j] = rng.uniform() < 0.125
            self.images.append(img)
            self.boxes.append(boxes)
            self.labels.append(labels)
            self.difficult.append(difficult)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize, scale_boxes

        h, w = self.images[i].shape[:2]
        new_h, new_w = self.cfg.image_size
        labels, difficult = self.labels[i], self.difficult[i]
        real = labels >= 0
        return {
            "image": resize_normalize(self.images[i], self.cfg.image_size, self.cfg.pixel_mean,
                                      self.cfg.pixel_std),
            "boxes": scale_boxes(self.boxes[i], labels, new_h / h, new_w / w),
            "labels": labels,
            "mask": real & ~difficult,
            "difficult": difficult & real,
        }


EVAL_BATCH = 8
EVAL_SWEEPS = 8  # timed sweeps per mode, after the counted one
EVAL_PREDICT_REPS = 10
# the train-set mAP@0.5 of benchmarks/map_overfit.py's recipe in the JAX
# package (benchmarks/map_overfit_result.json: a CPU float32 run, not a card
# number)
JAX_OVERFIT_MAP = 0.9591666666666667
OVERFIT_MAP_FLOOR = 0.5
OVERFIT_STEPS = 360  # 60 epochs of 48 images at batch 8


def phase_evaluate(torch, cfg=None, device=None, n_images=64):
    """Phase [7]: the ``Evaluator`` over a VOC-like dataset at batch 8, flip
    TTA off and on. ``cfg``/``device`` default to the full configuration on
    the card (a CPU rehearsal passes a small configuration and ``"cpu"``)."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.data.loader import collate
    from replication_faster_rcnn_tpu_torch.data.native_ops import (
        resize_normalize, resize_normalize_plain)
    from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
    from replication_faster_rcnn_tpu_torch.ops import nms as nms_ops
    from replication_faster_rcnn_tpu_torch.ops.cuda import nms_kernel, roi_kernel

    cfg = cfg or get_config("voc12_resnet18_align")
    dev = torch.device(device or "cuda")
    size = cfg.data.image_size
    log(f"[7] main path: evaluate voc12_resnet18_align {size} (compute "
        f"{cfg.model.compute_dtype}) via Evaluator over {n_images} VOC-sized images, batch "
        f"{EVAL_BATCH}, {cfg.proposals.pre_nms_test} -> {cfg.proposals.post_nms_test} proposals, "
        f"detection NMS at {cfg.eval.nms_thresh} -> {cfg.eval.max_detections}")
    ds = VOCLikeDataset(cfg.data, n_images)
    for img in ds.images:
        got = resize_normalize(img, size, cfg.data.pixel_mean, cfg.data.pixel_std)
        if not np.array_equal(got, resize_normalize_plain(img, size, cfg.data.pixel_mean,
                                                          cfg.data.pixel_std)):
            raise AssertionError(f"C++ resize of a {img.shape} image differs from numpy")
    resize = {"cpp_ms_per_image": resize_ms_per_image(resize_normalize, ds.images, cfg),
              "numpy_ms_per_image": resize_ms_per_image(resize_normalize_plain,
                                                        ds.images[:16], cfg)}
    log(f"  host resize_normalize to {size}: C++ {resize['cpp_ms_per_image']:.3f} ms per image "
        f"(over {len(ds)}), numpy {resize['numpy_ms_per_image']:.3f} ms (over 16); bitwise equal "
        f"on all {len(ds)}")

    model = build_model(cfg, device=dev, seed=0)
    probe = collate([ds[i] for i in range(EVAL_BATCH)])["image"]
    n_batches = -(-len(ds) // EVAL_BATCH)
    evaluators, sweeps, launches = {}, {}, {"nms": 0, "roi_align": 0}
    for tta in (False, True):
        mode = "tta" if tta else "plain"
        ev = evaluators[mode] = Evaluator(
            cfg.replace(eval=dataclasses.replace(cfg.eval, tta_hflip=tta)), device=dev)
        # one batch with the NMS calls' shapes recorded (and as the warm-up)
        shapes, real = [], nms_ops.nms_fixed_cuda

        def record(boxes, scores, thresh, max_out, **kw):
            shapes.append((tuple(boxes.shape[:2]), max_out))
            return real(boxes, scores, thresh, max_out, **kw)

        nms_ops.nms_fixed_cuda = record
        try:
            got = ev.predict_batch(model, probe)
        finally:
            nms_ops.nms_fixed_cuda = real
        r, c = cfg.proposals.post_nms_test, cfg.model.num_classes
        want = ([((EVAL_BATCH, cfg.proposals.pre_nms_test), r)] * (2 if tta else 1)
                + [((EVAL_BATCH, (2 if tta else 1) * r * c), cfg.eval.max_detections)])
        if shapes != want:
            raise AssertionError(f"{mode}: NMS calls {shapes}, expected {want}")
        plain = ev.predict_batch(model, probe, reference=True)
        for k in got:
            if not np.array_equal(got[k], plain[k]):
                raise AssertionError(f"{mode}: detections {k!r} differ from the plain run")
        log(f"  {mode}: NMS calls of one batch {shapes}; kernel detections == plain "
            f"(reference_scope) detections, bitwise ({int(got['valid'].sum())} valid)")

        nms_kernel.launches = 0
        roi_kernel.launches = 0
        result = ev.evaluate(model, ds, batch_size=EVAL_BATCH)
        run = {"nms": nms_kernel.launches, "roi_align": roi_kernel.launches}
        per_batch = {"nms": 3 if tta else 2, "roi_align": 2 if tta else 1}
        log(f"  {mode}: launches in the main-path run {run} over {n_batches} batches; "
            f"mAP@0.5 {result['mAP']:.4f} (random weights)")
        if run != {k: v * n_batches for k, v in per_batch.items()}:
            raise AssertionError(f"{mode}: expected per batch {per_batch}, got {run}")
        if not (np.isfinite(result["mAP"]) and 0.0 <= result["mAP"] <= 1.0):
            raise AssertionError(f"{mode}: mAP {result['mAP']} is not in [0, 1]")
        predict_ms = []
        for _ in range(EVAL_PREDICT_REPS):
            t1 = time.perf_counter()
            ev.predict_batch(model, probe)
            predict_ms.append((time.perf_counter() - t1) * 1e3)
        sweeps[mode] = {
            "predict_batch_ms": statistics.median(predict_ms), "mAP": result["mAP"],
            "launches": run, "launches_per_batch": per_batch, "nms_calls_per_batch": shapes,
            "sweep_s": [], "score_s": [],
        }
        for k in launches:
            launches[k] += run[k]

    # the rate: EVAL_SWEEPS whole sweeps per mode, the modes alternating, so
    # each mode's total spans a few seconds and both see the same host
    for _ in range(EVAL_SWEEPS):
        for mode, ev in evaluators.items():
            rec, score = sweeps[mode], ev._score

            def timed_score(*args, rec=rec, score=score):
                t0 = time.perf_counter()
                out = score(*args)
                rec["score_s"].append(time.perf_counter() - t0)
                return out

            ev._score = timed_score
            t0 = time.perf_counter()
            ev.evaluate(model, ds, batch_size=EVAL_BATCH)
            rec["sweep_s"].append(time.perf_counter() - t0)
            ev._score = score
    for mode, rec in sweeps.items():
        total = sum(rec["sweep_s"])
        rates = [len(ds) / t for t in rec["sweep_s"]]
        rec.update({
            "sweeps": EVAL_SWEEPS, "images": EVAL_SWEEPS * len(ds), "total_s": total,
            "images_per_s": EVAL_SWEEPS * len(ds) / total,
            "ms_per_batch": total / (EVAL_SWEEPS * n_batches) * 1e3,
            "sweep_images_per_s_min_max": [min(rates), max(rates)],
            "score_ms": statistics.median(rec["score_s"]) * 1e3,
        })
        log(f"  {mode}: evaluate {rec['images_per_s']:.1f} images/s over {EVAL_SWEEPS} sweeps of "
            f"{len(ds)} images ({total:.3f} s; one sweep {min(rates):.1f}-{max(rates):.1f}), "
            f"{rec['ms_per_batch']:.2f} ms per batch (loader, forward, decode, copy back, "
            f"scoring); one batch's predict {rec['predict_batch_ms']:.2f} ms (median of "
            f"{EVAL_PREDICT_REPS}); scoring {rec['score_ms']:.2f} ms per sweep")
    return launches, {"resize": resize, "sweeps": sweeps}


CACHED_EVAL_SWEEPS = 3  # timed sweeps per feed, the feeds alternating


def phase_cached_evaluate(torch, cfg=None, device=None, n_images=64):
    """Phase [7]'s cached evaluation: ``voc_resnet18`` (``cfg``; seeded
    weights) over 64 VOC-sized images at batch 8 through ``Evaluator`` with
    the loader feed and with ``data.cache_device`` (the set uploaded to the
    card once, each batch gathered there by the image kernels, the ground
    truth from ``host_meta``): the two results equal exactly, launches per
    batch counted (NMS 2, ROIPool 1; the cached feed also the gather's
    geometry and image launches, 1 each), then images/s of both feeds over
    ``CACHED_EVAL_SWEEPS`` sweeps each, the feeds alternating."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model

    cfg = cfg or get_config("voc_resnet18")
    dev = torch.device(device or "cuda")
    ds = VOCLikeDataset(cfg.data, n_images)
    n_batches = -(-len(ds) // EVAL_BATCH)
    log(f"[7] cached evaluation: voc_resnet18 {cfg.data.image_size} over {len(ds)} images, "
        f"batch {EVAL_BATCH}, the loader feed against cache_device")
    model = build_model(cfg, device=dev, seed=0)
    names = ("nms", "iou_match") + ROI_NAMES + IMAGE_NAMES
    feeds = {"loader": cfg, "device_cache": cfg.replace(
        data=dataclasses.replace(cfg.data, cache_device=True))}
    per_batch = {
        "loader": {"nms": 2, **roi_launches(cfg.model.roi_op, 1, 0)},
        "device_cache": {"nms": 2, **roi_launches(cfg.model.roi_op, 1, 0),
                         "augment_geometry": 1, "augment_image": 1},
    }
    evaluators, results, out = {}, {}, {}
    for feed, c in feeds.items():
        ev = evaluators[feed] = Evaluator(c, device=dev)
        REPLAYS.reset(names)
        t0 = time.perf_counter()
        results[feed] = ev.evaluate(model, ds, batch_size=EVAL_BATCH)
        first_s = time.perf_counter() - t0
        launches = {k: v for k, v in REPLAYS.read(names).items() if v}
        want = {k: v * n_batches for k, v in per_batch[feed].items() if v}
        if launches != want:
            raise AssertionError(f"cached evaluation {feed}: launches {launches}, expected "
                                 f"{want}")
        out[feed] = {"mAP": results[feed]["mAP"], "launches": launches,
                     "launches_per_batch": per_batch[feed], "first_sweep_s": first_s,
                     "sweep_s": []}
    if evaluators["device_cache"]._device_cache is None:
        raise AssertionError("the cache_device evaluation did not build its device cache")
    a, b = results["loader"], results["device_cache"]
    same = set(a) == set(b) and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                                   equal_nan=True) for k in a)
    if not same:
        raise AssertionError(f"cache_device mAP {b['mAP']} differs from the loader feed's "
                             f"{a['mAP']}")
    for _ in range(CACHED_EVAL_SWEEPS):
        for feed, ev in evaluators.items():
            t0 = time.perf_counter()
            ev.evaluate(model, ds, batch_size=EVAL_BATCH)
            out[feed]["sweep_s"].append(time.perf_counter() - t0)
    for feed, rec in out.items():
        rec["images_per_s"] = CACHED_EVAL_SWEEPS * len(ds) / sum(rec["sweep_s"])
    cache = evaluators["device_cache"]._device_cache
    out["device_cache"]["cache_bytes"] = cache.nbytes
    log(f"  loader feed {out['loader']['images_per_s']:.1f} images/s, cache_device "
        f"{out['device_cache']['images_per_s']:.1f} images/s (over {CACHED_EVAL_SWEEPS} sweeps "
        f"each, alternating; the cache's upload {out['device_cache']['first_sweep_s']:.2f} s "
        f"with the first sweep, {cache.nbytes} bytes); mAP@0.5 {a['mAP']:.6f} from both, every "
        f"entry equal; launches per batch {per_batch}")
    del evaluators, cache, model
    torch.cuda.empty_cache()
    return {f"evaluate_{feed}": rec["launches"] for feed, rec in out.items()}, out


def overfit_config():
    """The recipe of the JAX package's ``benchmarks/map_overfit.py``:
    ``voc_resnet18`` with the ROIAlign head, anchor scales (1, 2, 4), float32,
    128x128 synthetic images with up to 8 boxes, batch 8, Adam lr 3e-4,
    60 epochs, the val split evaluated every 2 epochs, a save every 15."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.config import DataConfig, TrainConfig

    base = get_config("voc_resnet18")
    return base.replace(
        anchors=dataclasses.replace(base.anchors, scales=(1.0, 2.0, 4.0)),
        model=dataclasses.replace(base.model, roi_op="align", compute_dtype="float32"),
        data=DataConfig(dataset="synthetic", image_size=(128, 128), max_boxes=8),
        train=TrainConfig(batch_size=8, n_epoch=60, lr=3e-4, eval_every_epochs=2,
                          checkpoint_every_epochs=15, seed=0),
    )


def fresh_dir(path):
    """``path`` emptied (under the repository's ignored ``build/``)."""
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def timed(record, fn):
    """``fn`` wrapped to append each call's host ms to ``record``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            record.append((time.perf_counter() - t0) * 1e3)
    return call


def quiet_logger(path):
    """A metric logger whose rows go to the JSONL file ``path`` only."""
    import io

    from replication_faster_rcnn_tpu_torch.utils.logging import MetricLogger

    return MetricLogger(stream=io.StringIO(), jsonl_path=str(path))


def logged_rows(path):
    """The step rows (those with a loss) of a metric JSONL file."""
    return [r for r in map(json.loads, open(path)) if "step" in r and "loss" in r]


def int8_map(torch, state, dataset, calibration, cfg, dev, sweep=True):
    """Calibrate (weight scales, the embed range from ``calibration``, then
    the sensitivity sweep unless ``sweep`` is false: [5]'s procedure), build
    the int8 resident tree and score its detections on ``dataset`` with
    ``voc_ap``. Without the sweep every layer group stays int8."""
    from replication_faster_rcnn_tpu_torch import quant
    from replication_faster_rcnn_tpu_torch.data.loader import DataLoader
    from replication_faster_rcnn_tpu_torch.eval.evaluator import make_int8_infer_fn
    from replication_faster_rcnn_tpu_torch.eval.voc_eval import voc_ap
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
    from replication_faster_rcnn_tpu_torch.quant.apply import tree_to

    model = build_model(cfg, device=dev, state_dict=state)
    artifact = quant.calibrate(model, state, calibration, cfg)
    if sweep:
        artifact = quant.sweep(model, state, artifact, calibration, cfg)
    qvars = tree_to(quant.quantize_variables({k: v.cpu() for k, v in state.items()}, artifact),
                    dev)
    infer = make_int8_infer_fn(FasterRCNN(cfg, device="meta"), cfg)
    dets, gts = [], []
    for batch in DataLoader(dataset, EVAL_BATCH, drop_last=False, prefetch=0):
        out = infer(qvars, torch.from_numpy(batch["image"]).to(dev))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for i in range(len(batch["image"])):
            v = out["valid"][i]
            dets.append({k: out[k][i][v] for k in ("boxes", "scores", "classes")})
            real = batch["labels"][i] >= 0
            gts.append({"boxes": batch["boxes"][i][real], "labels": batch["labels"][i][real]})
    return {"mAP": voc_ap(dets, gts, cfg.model.num_classes)["mAP"],
            "embed_range": artifact["activation_ranges"][quant.EMBED_RANGE_KEY],
            "plan": artifact["plan"]}


def phase_overfit(torch, cfg=None, device=None, length=48, jax_record=JAX_OVERFIT_MAP):
    """Phase [7], quality: the JAX package's overfit recipe run as
    ``benchmarks/map_overfit.py`` runs it, with the port's ``Trainer``:
    ``train(log_every=5)`` (the val split evaluated every 2 epochs, a save
    every 15), ``save()``, the train-set mAP@0.5 (at least
    ``OVERFIT_MAP_FLOOR``), then a fresh ``Trainer`` that ``restore()``s must
    score the final val mAP within 1e-9; then the same weights in int8.
    ``cfg``/``device`` default to the recipe on the card; an FPN ``cfg``
    counts the multi-level ROIAlign's launches (``tools/fpn_overfit.py``),
    printed beside ``jax_record``, the JAX package's train-set mAP of the
    same recipe."""
    from replication_faster_rcnn_tpu_torch import quant
    from replication_faster_rcnn_tpu_torch.data.loader import make_dataset
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = cfg or overfit_config()
    dev = torch.device(device or "cuda")
    tc = cfg.train
    steps = tc.n_epoch * (length // tc.batch_size)
    root = fresh_dir(REPO / "build" / "chip_smoke_overfit")
    log(f"[7] quality: the JAX overfit recipe on the port: {cfg.data.image_size} "
        f"{cfg.model.compute_dtype}, anchor scales {cfg.anchors.scales}, {length} synthetic "
        f"images, batch {tc.batch_size}, {steps} steps, lr {tc.lr}, val mAP every "
        f"{tc.eval_every_epochs} epochs, a save every {tc.checkpoint_every_epochs}")
    ds = SyntheticDataset(cfg.data, "train", length=length)
    trainer = Trainer(cfg, dataset=ds, device=dev, seed=0, workdir=str(root / "ckpt"))
    trainer.logger = quiet_logger(root / "curve.jsonl")
    save_ms = []
    trainer.save = timed(save_ms, trainer.save)
    roi = "roi_multilevel" if cfg.model.fpn else "roi_align"
    names = ("nms", "iou_match", roi, f"{roi}_bwd")
    REPLAYS.reset(names)
    t0 = time.perf_counter()
    last = trainer.train(log_every=5)
    train_s = time.perf_counter() - t0
    launches = REPLAYS.read(names)
    evals = tc.n_epoch // tc.eval_every_epochs
    eval_batches = evals * -(-len(make_dataset(cfg.data, "val")) // tc.batch_size)
    # per train step NMS 1, IoU matching 2, the ROI op 1 + 1; per eval batch NMS 2, the ROI op 1
    want = {"nms": steps + 2 * eval_batches, "iou_match": 2 * steps,
            roi: steps + eval_batches, f"{roi}_bwd": steps}
    if launches != want:
        raise AssertionError(f"expected {want} over {steps} steps and {eval_batches} eval "
                             f"batches, got {launches}")
    rows = logged_rows(root / "curve.jsonl")
    losses = [r["loss"] for r in rows]
    if (trainer.state.step != steps or len(rows) != steps // 5
            or trainer.skip_monitor.total_skipped or not np.isfinite(losses).all()):
        raise AssertionError(f"the overfit run ended at step {trainer.state.step} with "
                             f"{trainer.skip_monitor.total_skipped} skipped steps")
    val_curve = [r["mAP"] for r in map(json.loads, open(root / "curve.jsonl"))
                 if "mAP" in r and "loss" not in r]
    if len(val_curve) != evals or val_curve[-1] != last["mAP"]:
        raise AssertionError(f"{len(val_curve)} in-training evaluations, expected {evals}")
    trainer.save()  # the final state: already saved at the last epoch, so no write
    log(f"  train(log_every=5): {steps} steps in {train_s:.1f} s with {evals} val evaluations "
        f"and {len(save_ms) - 1} saves ({steps / train_s:.1f} steps/s); logged loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; val mAP@0.5 curve {val_curve[0]:.4f} -> "
        f"{val_curve[-1]:.4f}; save ms {[round(x, 1) for x in save_ms]}; launches {launches}")
    result = Evaluator(cfg, device=dev).evaluate(trainer.model, ds, batch_size=EVAL_BATCH)
    f32 = result["mAP"]
    log(f"  train-set mAP@0.5 {f32:.4f} (port, float32, on {dev}) beside the JAX package's "
        f"{jax_record:.4f} (benchmarks/map_overfit_result*.json, a CPU float32 run)")
    if not f32 >= OVERFIT_MAP_FLOOR:
        raise AssertionError(f"train-set mAP {f32} < {OVERFIT_MAP_FLOOR}: the port did not "
                             "learn the planted rectangles")
    final_map = float(trainer.evaluate()["mAP"])
    restored = Trainer(cfg, dataset=ds, device=dev, seed=0, workdir=str(root / "ckpt"))
    restored.logger = quiet_logger(root / "restored.jsonl")
    t0 = time.perf_counter()
    restored_step = restored.restore()
    restore_ms = (time.perf_counter() - t0) * 1e3
    restored_map = float(restored.evaluate()["mAP"])
    if restored_step != steps or abs(restored_map - final_map) > 1e-9:
        raise AssertionError(f"restored step {restored_step} mAP {restored_map} != final "
                             f"mAP {final_map}")
    log(f"  a fresh Trainer's restore() (step {restored_step}, {restore_ms:.1f} ms with the "
        f"CRC verify) scores val mAP@0.5 {restored_map:.6f} == the final state's "
        f"{final_map:.6f} (within 1e-9)")
    shutil.rmtree(root)
    state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    qc = cfg.quant
    synthetic = quant.synthetic_calibration_batches(cfg, qc.calib_batches, qc.calib_batch_size)
    images = quant.dataset_calibration_batches(ds, qc.calib_batches, qc.calib_batch_size)
    int8 = {
        "synthetic_calibration": int8_map(torch, state, ds, synthetic, cfg, dev),
        "dataset_calibration": int8_map(torch, state, ds, images, cfg, dev),
        "dataset_calibration_all_int8": int8_map(torch, state, ds, images, cfg, dev, sweep=False),
    }
    for name, rec in int8.items():
        log(f"  int8 ({name.replace('_', ' ')}: embed range {rec['embed_range']:.3f}, plan "
            f"{rec['plan']}): train-set mAP@0.5 {rec['mAP']:.4f} against float32 {f32:.4f}")
        if not (np.isfinite(rec["mAP"]) and 0.0 <= rec["mAP"] <= 1.0):
            raise AssertionError(f"int8 mAP {rec['mAP']} is not in [0, 1]")
    return launches, {"steps": steps, "train_s": train_s, "evaluations": evals,
                      "save_ms": save_ms, "restore_ms": restore_ms,
                      "logged_loss_first_last": [losses[0], losses[-1]],
                      "val_mAP_first_last": [val_curve[0], val_curve[-1]],
                      "final_val_mAP": final_map, "restored_val_mAP": restored_map,
                      "train_set_mAP": f32, "jax_cpu_record_mAP": jax_record,
                      "int8": int8}


def poisoned_and_killed(trainer, poison_step, term_after=None, step_ms=None):
    """Drive ``trainer``'s steps: one sample of step ``poison_step``'s batch
    gets a NaN (the guarded update skips that step), SIGTERM is raised after
    step ``term_after``, and each step's host ms (the staging copy, which
    waits for the card, and the dispatch)
    goes to ``step_ms``."""
    import signal

    step_fn = trainer.train_one_batch

    def train_one_batch(batch, **kw):
        if trainer.state.step + 1 == poison_step:
            batch = dict(batch, image=batch["image"].copy())
            batch["image"][0, 3, 3, 0] = np.nan
        t0 = time.perf_counter()
        out = step_fn(batch, **kw)
        if step_ms is not None:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if trainer.state.step == term_after:
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer.train_one_batch = train_one_batch
    return trainer


def state_differences(torch, got, want):
    """The leaves in which two trainers' whole states differ (parameters,
    BatchNorm statistics, Adam state, schedule, generator, step), bitwise."""
    from replication_faster_rcnn_tpu_torch.train import fault

    a = dict(fault._leaves_with_path(got._host_state()))
    b = dict(fault._leaves_with_path(want._host_state()))
    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                 else a[k] == b[k])]


def same_rows(got, want):
    """Logged rows equal but for the clock (NaN where both are NaN)."""
    def key(r):
        return {k: ("nan" if isinstance(v, float) and v != v else v)
                for k, v in r.items() if k != "t"}
    return [key(r) for r in got] == [key(r) for r in want]


# the trainer's spans (the JAX trainer's names), all of which runs (a)-(d) of [8] record
TRAINER_SPANS = ("step/dispatch", "step/sync", "data/fetch", "data/build", "data/device_put",
                 "fault/skip_drain", "state/host_fetch", "checkpoint/save",
                 "checkpoint/snapshot", "checkpoint/manifest", "checkpoint/restore")


def check_telemetry(root):
    """Phase [8]'s telemetry directories: (a) uninterrupted, (b) async saves,
    (c) preempted, (d) resumed. Together their traces hold every span of
    ``TRAINER_SPANS``; no run records a stall; (c)'s watchdog records the
    preemption and the abnormal exit. Prints (a)'s report."""
    from replication_faster_rcnn_tpu_torch.telemetry import report

    names, out = set(), {}
    for run in "abcd":
        summary = report.summarize_run(str(root / f"telemetry_{run}"))
        incidents = summary.get("incidents", {"stalls": 0, "faults": {}})
        if incidents["stalls"] or summary["artifacts"][:1] != ["trace.json"]:
            raise AssertionError(f"telemetry of run ({run}): {summary['artifacts']}, {incidents}")
        names |= {row["name"] for row in summary["phases"]}
        out[run] = {"phases": summary["phases"], "faults": incidents["faults"]}
        if run == "a":
            log("  " + report.format_report(summary).replace("\n", "\n  "))
    if not names >= set(TRAINER_SPANS):
        raise AssertionError(f"spans missing from the traces: {set(TRAINER_SPANS) - names}")
    if set(out["c"]["faults"]) != {"preempted", "abnormal_exit"}:
        raise AssertionError(f"run (c)'s watchdog recorded {out['c']['faults']}")
    log(f"  telemetry: the traces of (a)-(d) hold {sorted(names)}; no stall; (c)'s watchdog "
        f"recorded {out['c']['faults']}")
    return out


def phase_resume(torch, name="voc_resnet18", cfg=None, device=None, length=24):
    """Phase [8], kill and resume: ``name`` (default the flagship, ROIPool)
    for 3 epochs of ``length // batch`` steps, step 3 poisoned with a NaN
    (skipped): (a) uninterrupted twice, bitwise equal; (b) async saves every
    2 steps; (c) sync saves every 2 steps and SIGTERM after step 5, ending in
    ``Preempted`` with a verified emergency checkpoint; (d) a fresh trainer
    resumes (c). (b) and (d) end bitwise in (a)'s state, and (d)'s logged
    rows are (a)'s. Then ``load_eval_variables`` serves one b1 flush bitwise
    equal to (a)'s weights', and ``restore()`` falls back past a truncated
    newest step. ``cfg``/``device`` default to the preset on the card."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
    from replication_faster_rcnn_tpu_torch.telemetry import spans
    from replication_faster_rcnn_tpu_torch.train import fault
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer, load_eval_variables

    cfg = cfg or get_config(name)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, n_epoch=3))
    dev = torch.device(device or "cuda")
    bsz, op = cfg.train.batch_size, cfg.model.roi_op
    steps = cfg.train.n_epoch * (length // bsz)
    root = fresh_dir(REPO / "build" / "chip_smoke_resume")
    log(f"[8] kill and resume: {name} {cfg.data.image_size} batch {bsz} "
        f"{cfg.model.compute_dtype}, {length} synthetic images, {cfg.train.n_epoch} epochs of "
        f"{length // bsz} steps, step 3 poisoned with a NaN")
    ds = SyntheticDataset(cfg.data, length=length)
    names = ("nms", "iou_match") + ROI_NAMES

    def reset():
        REPLAYS.reset(names)

    def read():
        return REPLAYS.read(names)

    def make(tag, log_tag=None, telemetry=None, **train):
        """A trainer on ``root / tag``; ``telemetry`` names a telemetry
        directory under ``root``, whose ``metrics.jsonl`` then takes the
        logged rows (else ``<log_tag or tag>.jsonl``)."""
        c = cfg.replace(train=dataclasses.replace(cfg.train, **train))
        tel = None if telemetry is None else str(root / telemetry)
        trainer = Trainer(c, dataset=ds, device=dev, seed=0, workdir=str(root / tag),
                          telemetry_dir=tel)
        trainer.logger = quiet_logger(root / telemetry / "metrics.jsonl" if telemetry
                                      else root / f"{log_tag or tag}.jsonl")
        return trainer

    per_step = {"nms": 1, "iou_match": 2, **roi_launches(op, 1, 1)}
    step_ms = {"a": [], "a2": [], "b": []}
    reset()
    # (a) records telemetry (the span trace, the metrics, the stall
    # watchdog); (a2) does not, and the two must still be bitwise equal
    ref = poisoned_and_killed(make("a", telemetry="telemetry_a"), 3, step_ms=step_ms["a"])
    ref.train(log_every=1)
    spans.set_tracer(None)
    launches = read()
    if launches != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(f"expected per step {per_step}, got {launches} over {steps} steps")
    ref_rows = logged_rows(root / "telemetry_a" / "metrics.jsonl")
    skipped = [r["step"] for r in ref_rows if r["skipped"]]
    if ref.state.step != steps or skipped != [3] or int(ref.state.optimizer.count) != steps - 1:
        raise AssertionError(f"run (a): step {ref.state.step}, skipped steps {skipped}")
    again = poisoned_and_killed(make("a2"), 3, step_ms=step_ms["a2"])
    again.train(log_every=1)
    diff = state_differences(torch, again, ref)
    if diff or not same_rows(logged_rows(root / "a2.jsonl"), ref_rows):
        raise AssertionError(f"two uninterrupted runs differ: {diff[:5]} (rows or state)")
    state_bytes = sum(v.numel() * v.element_size() for _, v in fault._leaves_with_path(
        ref._host_state()) if isinstance(v, torch.Tensor))
    log(f"  (a) uninterrupted, twice: {steps} steps each (step 3 skipped), the two runs "
        f"bitwise equal in state and logged rows, the first with telemetry and the second "
        f"without; launches {launches}")

    reset()
    snapshot_ms, writer_ms = [], []
    asy = poisoned_and_killed(make("b", telemetry="telemetry_b", checkpoint_every_steps=2,
                                   async_checkpoint=True), 3, step_ms=step_ms["b"])
    asy._host_state = timed(snapshot_ms, asy._host_state)
    submit = asy._async_writer.submit
    asy._async_writer.submit = lambda step, work: submit(step, timed(writer_ms, work))
    asy.train(log_every=1)
    spans.set_tracer(None)
    del asy._host_state  # the comparison's snapshot is not a save's
    diff = state_differences(torch, asy, ref)
    if diff or not same_rows(logged_rows(root / "telemetry_b" / "metrics.jsonl"), ref_rows):
        raise AssertionError(f"the async-checkpointed run differs from (a): {diff[:5]}")
    log(f"  (b) async saves every 2 steps ({len(writer_ms)} saves): bitwise (a)'s state and "
        f"rows; snapshot on the trainer thread {[round(x, 1) for x in snapshot_ms]} ms, "
        f"writer {[round(x, 1) for x in writer_ms]} ms")

    sync_ms = []
    killed = poisoned_and_killed(make("c", telemetry="telemetry_c", checkpoint_every_steps=2),
                                 3, term_after=5)
    killed.save = timed(sync_ms, killed.save)
    try:
        killed.train(log_every=1)
        raise AssertionError("run (c) was not preempted")
    except fault.Preempted as e:
        preempted = e.step
    spans.set_tracer(None)
    manifest = fault.load_manifest(str(root / "c"), 5)
    t0 = time.perf_counter()
    problems = fault.verify_state(manifest, killed.checkpoint_manager.restore(5))
    load_verify_ms = (time.perf_counter() - t0) * 1e3
    if preempted != 5 or manifest["kind"] != "emergency" or problems:
        raise AssertionError(f"preempted at {preempted}, manifest {manifest and manifest['kind']},"
                             f" {problems[:3]}")
    resumed = make("c", telemetry="telemetry_d", checkpoint_every_steps=2)
    restore_ms = []
    resumed.restore = timed(restore_ms, resumed.restore)
    resumed.train(log_every=1, resume=True)
    spans.set_tracer(None)
    diff = state_differences(torch, resumed, ref)
    rows = (logged_rows(root / "telemetry_c" / "metrics.jsonl")
            + logged_rows(root / "telemetry_d" / "metrics.jsonl"))
    if diff or [r["step"] for r in rows] != list(range(1, steps + 1)) or not same_rows(
            rows, ref_rows):
        raise AssertionError(f"the resumed run differs from (a): {diff[:5]}")
    launches_bcd = read()
    runs = steps + 5 + (steps - 5)
    if launches_bcd != {k: v * runs for k, v in per_step.items()}:
        raise AssertionError(f"expected per step {per_step} over {runs} steps, got "
                             f"{launches_bcd}")
    log(f"  (c) sync saves every 2 steps, SIGTERM after step 5: Preempted at step {preempted}, "
        f"the emergency manifest verifies; save ms {[round(x, 1) for x in sync_ms]}; "
        f"(d) a fresh Trainer resumes (restore + verify {restore_ms[0]:.1f} ms) and ends "
        f"bitwise in (a)'s state with (a)'s logged rows for steps 6-{steps}")
    telemetry = check_telemetry(root)

    reset()
    served = load_eval_variables(cfg, str(root / "c"), device=dev)
    image = np.random.default_rng(3).integers(0, 256, cfg.data.image_size + (3,), np.uint8)
    with InferenceEngine(cfg, device=dev, state_dict=served.state_dict()) as engine:
        got = engine.predict([image])[0]
    with InferenceEngine(cfg, device=dev, state_dict=ref.model.state_dict()) as engine:
        want = engine.predict([image])[0]
    same_results([got], [want], "load_eval_variables vs (a)'s live weights")
    serve_launches = read()
    # two engines, each one b1 flush: its graph's eager warm-up run, then its
    # first replay
    want_serve = {"nms": 8, "iou_match": 0, **roi_launches(op, 4, 0)}
    if serve_launches != want_serve:
        raise AssertionError(f"expected {want_serve} over two b1 flushes, got {serve_launches}")

    torn = root / "c" / str(steps) / "state.pt"
    torn.write_bytes(torn.read_bytes()[: torn.stat().st_size // 2])
    fallback = make("c", "fallback")
    t0 = time.perf_counter()
    back = fallback.restore()
    fallback_ms = (time.perf_counter() - t0) * 1e3
    events = [r for r in map(json.loads, open(root / "fallback.jsonl"))
              if r.get("event") == "checkpoint_fallback"]
    if back != steps - 2 or (root / "c" / str(steps)).exists() or len(events) != 1:
        raise AssertionError(f"fallback restored step {back}, events {events}")
    log(f"  load_eval_variables serves one b1 flush bitwise equal to (a)'s weights (launches "
        f"{serve_launches}); the newest step truncated: restore() falls back to step {back} "
        f"in {fallback_ms:.1f} ms, logs checkpoint_fallback and deletes the torn step")
    file_bytes = (root / "c" / str(back) / "state.pt").stat().st_size
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    log(f"  state {state_bytes:,} bytes of tensors ({file_bytes:,} bytes on disk); sync save "
        f"{statistics.median(sync_ms):.1f} ms median; async snapshot "
        f"{statistics.median(snapshot_ms):.1f} ms on the trainer thread, writer "
        f"{statistics.median(writer_ms):.1f} ms; load + verify {load_verify_ms:.1f} ms; step "
        f"(a) {med['a']:.2f} ms, (b) {med['b']:.2f} ms median (host clock around "
        f"train_one_batch: the staging copy, which waits for the card, and the dispatch)")
    shutil.rmtree(root)
    return {"train_resume": {k: launches[k] + launches_bcd[k] for k in launches},
            "serve_resume": serve_launches}, {"telemetry": telemetry,
        "config": name, "steps": steps, "state_bytes": state_bytes, "file_bytes": file_bytes,
        "sync_save_ms": sync_ms, "async_snapshot_ms": snapshot_ms, "async_writer_ms": writer_ms,
        "load_verify_ms": load_verify_ms, "restore_ms": restore_ms[0],
        "fallback_restore_ms": fallback_ms, "step_ms": step_ms,
        "step_ms_median": med, "preempted_at": preempted}


DATA_LENGTH = 192  # images of [10]'s arms (24 b8 steps an epoch)
DATA_SHORT = 48  # images of [10]'s bitwise and bucket runs (6 steps an epoch)
DATA_SPANS = ("data/fetch", "data/build", "data/device_put", "step/dispatch", "data/cache_upload")
BUCKETS = ((480, 480), (600, 600), (720, 720))
BUCKET_SEED = 4  # at 6 steps an epoch (K=1 and 2): 480 captured, then 720, then 480 replayed


def span_stats(trace_dir, before_epoch):
    """{span: {n, mean_ms, median_ms}} for ``DATA_SPANS`` in a run's trace,
    over the epochs before ``before_epoch`` (the profiled epoch is left
    out)."""
    from replication_faster_rcnn_tpu_torch.telemetry import report

    events = [e for e in report.load_trace_events(str(Path(trace_dir) / "trace.json"))
              if e.get("ph") == "X"]
    ends = sorted(e["ts"] + e["dur"] for e in events if e["name"] == "step/sync"
                  and (e.get("args") or {}).get("boundary") == "epoch")
    cutoff = ends[before_epoch - 1] if len(ends) >= before_epoch else float("inf")
    out = {}
    for name in DATA_SPANS:
        durs = [e["dur"] / 1e3 for e in events if e["name"] == name and e["ts"] < cutoff]
        if durs:
            out[name] = {"n": len(durs), "mean_ms": statistics.mean(durs),
                         "median_ms": statistics.median(durs)}
    return out


def profile_epoch(torch, trainer, epoch):
    """Start a CUDA-activity ``torch.profiler`` when ``trainer``'s feed
    enters ``epoch``; :func:`epoch_idle` reads it after ``train()``."""
    from torch.profiler import ProfilerActivity, profile

    box = {}
    set_epoch = trainer.feed.set_epoch

    def hooked(e, start_batch=0):
        if e == epoch and torch.cuda.is_available():
            torch.cuda.synchronize()
            box["prof"] = profile(activities=[ProfilerActivity.CUDA])
            box["prof"].__enter__()
        set_epoch(e, start_batch)

    trainer.feed.set_epoch = hooked
    return box


def epoch_idle(torch, box, steps):
    """The profiled epoch's device busy ms a step, span ms a step and idle
    share (None without a profile or device activity)."""
    from torch.autograd import DeviceType

    prof = box.get("prof")
    if prof is None:
        return None
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not acts:
        return None
    busy, span = busy_and_span((e.time_range.start, e.time_range.end) for e in acts)
    return {"device_busy_ms_per_step": busy / 1e3 / steps,
            "device_span_ms_per_step": span / 1e3 / steps, "device_idle_share": 1 - busy / span}


def sync_checked(torch, trainer, after=2):
    """Every dispatch of ``trainer`` after the first ``after`` (the captures'
    warm-ups build their constants) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host wait for the card
    there raises."""
    calls = [0]
    for name in ("train_one_batch", "train_chunk"):
        fn = getattr(trainer, name)

        def wrapped(*args, _fn=fn, **kw):
            calls[0] += 1
            if calls[0] <= after or not torch.cuda.is_available():
                return _fn(*args, **kw)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        setattr(trainer, name, wrapped)
    return trainer


def check_loader_faults(dataset, bsz):
    """[10]'s sample-fault containment on the host: an ``ioerror`` armed at
    ``loader.fetch`` on two indices (each read and its retry fail, two rules
    of ``max_fires=2``) through the thread loader, one worker, in order: two
    substitutions by the next index, the epoch's other batches untouched;
    with ``sample_skip_budget=1`` the same faults raise the budget's
    error."""
    from replication_faster_rcnn_tpu_torch.data.loader import DataLoader
    from replication_faster_rcnn_tpu_torch.faultlib import failpoints

    # the reads in order: index 0 (hits 0-1 fail, index 1 substitutes it at
    # hit 2), indices 1..bsz (hits 3..), then the first index of the second
    # batch + 1 fails twice (hits after = bsz + 3, + 4) and the next one
    # substitutes it
    second = bsz + 1
    spec = f"loader.fetch:ioerror:1.0:1:0:2:0,loader.fetch:ioerror:1.0:2:0:2:{bsz + 3}"
    out = {}
    for budget in (2, 1):
        loader = DataLoader(dataset, batch_size=bsz, shuffle=False, prefetch=1, num_workers=1,
                            sample_skip_budget=budget)
        events = []
        failpoints.configure(spec, sink=events.append)
        try:
            got = []
            error = None
            try:
                for batch in loader:
                    got.append(batch)
                    if len(got) == 2:
                        break
            except RuntimeError as e:
                error = str(e)
        finally:
            failpoints.disarm()
        out[budget] = {"batches": len(got), "error": error,
                       "faults": [(e["seq"], e["index"]) for e in events]}
        if budget == 2:
            if error is not None or len(got) != 2:
                raise AssertionError(f"loader.fetch faults with budget 2: {error}")
            want = [1] + list(range(1, bsz)), [bsz] + [second + 1] + list(range(bsz + 2, 2 * bsz))
            for b, idxs in zip(got, want):
                for j, i in enumerate(idxs):
                    if not np.array_equal(b["image"][j], dataset[i]["image"]):
                        raise AssertionError(f"loader.fetch faults: slot {j} is not sample {i}")
            faulted = sorted({i for _, i in out[budget]["faults"]})
            if faulted != [0, second]:
                raise AssertionError(f"loader.fetch faults landed on {faulted}")
        elif error is None or "sample-skip budget exhausted: 2 failed samples" not in error:
            raise AssertionError(f"loader.fetch faults with budget 1 did not raise: {error}")
    log(f"  loader.fetch ioerror on samples 0 and {second} (each read and its retry): two "
        f"substitutions by the next index with budget 2; budget 1 raises "
        f"'{out[1]['error'][:60]}...'")
    return out


def phase_data_path(torch, cfg=None, device=None, length=DATA_LENGTH, short=DATA_SHORT):
    """Phase [10], the training data path: ``voc_resnet18`` (``cfg``) at
    600x600 b8 through ``Trainer.train`` on synthetic data, four feeds
    ("arms", ``length`` images, 2 timed epochs and a profiled third): (a)
    the synchronous float32 feed without prefetch; (b) uint8 (``device_normalize``)
    with ``prefetch_device=2``; (c) (b) with ``augment_device`` (flip, scale
    0.75-1.25, translation 0.1); (d) ``cache_device`` with flip and scale
    (uint8, prefetch 2). Per arm: the second epoch's images/s, the spans of
    the first two epochs, the profiled epoch's idle share, and the launch
    counters (reset just before, read just after). (b) is bitwise its run
    with prefetch off and (d) bitwise the loader-fed ``augment_scale_device``
    run; the prefetching arms' dispatches run under sync-debug "error". On
    ``short`` images: K=2 with prefetch bitwise K=1, and a SIGTERM after step
    4 resumed with prefetch bitwise the uninterrupted run. The buckets
    ((480, 480), (600, 600), (720, 720)), K=1 and K=2: the dispatches' bucket
    sequence is ``bucket_index``'s, the captured run bitwise the eager run,
    and per step NMS 1, IoU 2, ROIPool 1 + 1 and the resample 1 off the
    600 bucket. The cache's bytes on the card against its formula."""
    import dataclasses
    import signal

    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.data.augment import bucket_index
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.telemetry import spans
    from replication_faster_rcnn_tpu_torch.train import fault
    from replication_faster_rcnn_tpu_torch.train.train_step import make_train_step
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = cfg or get_config("voc_resnet18")
    dev = torch.device(device or "cuda")
    bsz = cfg.train.batch_size
    root = fresh_dir(REPO / "build" / "chip_smoke_data")
    names = ("nms", "iou_match") + ROI_NAMES + IMAGE_NAMES
    per_step = {"nms": 1, "iou_match": 2, **roi_launches(cfg.model.roi_op, 1, 1)}
    log(f"[10] the data path: {cfg.data.image_size} batch {bsz}, {length} synthetic images, "
        "arms (a) float32 no prefetch, (b) uint8 + prefetch 2, (c) (b) + augment_device, "
        "(d) cache_device uint8 flip + scale, (e) (b) fed by the process loader")

    def config(epochs, **data):
        base = dict(dataset="synthetic", augment_hflip=False)
        base.update(data)
        return cfg.replace(data=dataclasses.replace(cfg.data, **base),
                           train=dataclasses.replace(cfg.train, n_epoch=epochs,
                                                     checkpoint_every_epochs=1000))

    datasets = {}

    def dataset(c, n):
        key = (c.data.device_normalize, n)
        if key not in datasets:
            datasets[key] = SyntheticDataset(c.data, length=n)
        return datasets[key]

    def make(tag, c, n, telemetry=False, seed=0, **train):
        c = c.replace(train=dataclasses.replace(c.train, **train))
        tel = str(root / f"tel_{tag}") if telemetry else None
        tr = Trainer(c, dataset=dataset(c, n), device=dev, seed=seed,
                     workdir=str(root / tag), telemetry_dir=tel)
        tr.logger = quiet_logger(root / f"{tag}.jsonl")
        return tr

    def run(tr, log_every=1000):
        try:
            tr.train(log_every=log_every)
        finally:
            spans.set_tracer(None)
        return tr

    uint8 = dict(device_normalize=True)
    arms = {
        "a": config(3),
        "b": config(3, prefetch_device=2, **uint8),
        "c": config(3, prefetch_device=2, augment_device=True, augment_hflip=True,
                    augment_scale=(0.75, 1.25), augment_translate=0.1, **uint8),
        "d": config(3, prefetch_device=2, cache_device=True, augment_hflip=True,
                    augment_scale=(0.75, 1.25), **uint8),
        "e": config(3, prefetch_device=2, loader_mode="process", **uint8),
    }
    image_per_step = {"a": {}, "b": {},
                      "c": {"augment_prepare": 1, "augment_image": 1},
                      "d": {"augment_prepare": 1, "augment_image": 1}, "e": {}}
    out, trainers = {}, {}
    steps = 3 * (length // bsz)
    for arm, c in arms.items():
        tr = make(arm, c, length, telemetry=True)
        if c.data.prefetch_device:
            sync_checked(torch, tr)
        box = profile_epoch(torch, tr, 2)
        REPLAYS.reset(names)
        t0 = time.perf_counter()
        run(tr)
        wall = time.perf_counter() - t0
        launches = REPLAYS.read(names)
        want = {k: per_step.get(k, 0) * steps + image_per_step[arm].get(k, 0) * steps
                for k in names}
        if launches != want:
            raise AssertionError(f"arm ({arm}): launches {launches}, expected {want}")
        idle = epoch_idle(torch, box, length // bsz)
        rates = [r["images_per_sec"] for r in map(json.loads, open(root / f"{arm}.jsonl"))
                 if "images_per_sec" in r]
        out[arm] = {"images_per_sec_by_epoch": rates, "images_per_sec": rates[1],
                    "wall_s": wall, "spans": span_stats(root / f"tel_{arm}", 2),
                    "profiled_epoch": idle, "launches": launches}
        if arm == "d":
            cache = tr.device_cache
            n_img = len(cache)
            g = c.data.max_boxes
            h, w = c.data.image_size
            formula = n_img * (h * w * 3 + g * 4 * 4 + g * 4 + g + g)
            on_card = sum(v.numel() * v.element_size() for v in cache.arrays.values())
            if not on_card == cache.nbytes == formula:
                raise AssertionError(f"cache bytes {on_card} / {cache.nbytes}, formula {formula}")
            out[arm]["cache"] = {"images": n_img, "bytes_on_card": on_card, "formula": formula,
                                 "bytes_per_image": formula // n_img,
                                 "voc2007_trainval_gb": 5011 * formula / n_img / 1e9}
        trainers[arm] = tr
        log(f"  ({arm}) {out[arm]['images_per_sec']:.1f} images/s (epochs "
            f"{[round(r, 1) for r in rates]}), spans "
            f"{ {k: round(v['mean_ms'], 2) for k, v in out[arm]['spans'].items()} } ms mean, "
            f"profiled epoch {idle and {k: round(v, 4) for k, v in idle.items()} }, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
    # (b) against prefetch off, (d) against the loader-fed device jitter
    ref_b = run(make("b_off", config(3, **uint8), length))
    diff = state_differences(torch, trainers["b"], ref_b)
    if diff:
        raise AssertionError(f"(b) with prefetch differs from prefetch off: {diff[:5]}")
    ref_d = run(make("d_fed", config(3, prefetch_device=2, augment_hflip=True,
                                     augment_scale=(0.75, 1.25), augment_scale_device=True,
                                     **uint8), length))
    diff = state_differences(torch, trainers["d"], ref_d)
    if diff:
        raise AssertionError(f"(d) cache-fed differs from the loader-fed run: {diff[:5]}")
    diff = state_differences(torch, trainers["e"], trainers["b"])
    if diff:
        raise AssertionError(f"(e) fed by the process loader differs from (b): {diff[:5]}")
    # the process loader's batches against the thread loader's, one epoch
    from replication_faster_rcnn_tpu_torch.data.loader import DataLoader

    ds8 = dataset(arms["b"], length)
    thread_b, process_b = (list(DataLoader(ds8, bsz, seed=0, worker_mode=mode,
                                           num_workers=4))
                           for mode in ("thread", "process"))
    if len(thread_b) != len(process_b) or not all(
            np.array_equal(a[k], b[k]) for a, b in zip(thread_b, process_b) for k in a):
        raise AssertionError("the process loader's batches differ from the thread loader's")
    del trainers, ref_b, ref_d, thread_b, process_b
    log(f"  (b) bitwise its run with prefetch off; (d) bitwise the loader-fed "
        "augment_scale_device run; (e) (the process loader, 4 forked workers) bitwise (b), its "
        f"{length // bsz} batches of an epoch bitwise the thread loader's; the prefetching "
        "arms' dispatches after the first two ran under sync-debug 'error'")
    out["loader_faults"] = check_loader_faults(ds8, bsz)

    # K=2 with prefetch against K=1, and kill + resume with prefetch
    short_cfg = config(2, prefetch_device=2, augment_hflip=True, **uint8)
    k1 = make("k1", short_cfg, short - bsz)
    k2 = make("k2", short_cfg, short - bsz, steps_per_dispatch=2)
    for tr in (k1, k2):
        run(sync_checked(torch, tr))
    diff = state_differences(torch, k2, k1)
    if diff:
        raise AssertionError(f"K=2 with prefetch differs from K=1: {diff[:5]}")
    killed = make("killed", short_cfg, short - bsz, checkpoint_every_steps=2)
    step_fn = killed.train_one_batch

    def term_after(*args, **kw):
        res = step_fn(*args, **kw)
        if killed.state.step == 4:
            signal.raise_signal(signal.SIGTERM)
        return res

    killed.train_one_batch = term_after
    try:
        run(killed)
        raise AssertionError("the prefetching run was not preempted")
    except fault.Preempted as e:
        if e.step != 4:
            raise AssertionError(f"preempted at step {e.step}, not 4")
    resumed = make("killed", short_cfg, short - bsz, checkpoint_every_steps=2)
    resumed.train(log_every=1000, resume=True)
    spans.set_tracer(None)
    diff = state_differences(torch, resumed, k1)
    if diff:
        raise AssertionError(f"the resumed prefetching run differs: {diff[:5]}")
    log(f"  K=2 chunks with prefetch (an epoch of {short // bsz - 1} steps: two chunks and a "
        "1-step tail) bitwise K=1; SIGTERM after step 4 with prefetch, resumed: bitwise")
    del k1, k2, killed, resumed

    # the resolution buckets, captured against eager, K=1 and K=2
    buckets = {}
    per_epoch = short // bsz
    for k in (1, 2):
        bcfg = config(2, train_resolutions=BUCKETS, augment_hflip=True, **uint8)
        cap = make(f"buckets{k}", bcfg, short, seed=BUCKET_SEED, steps_per_dispatch=k)
        eag = make(f"buckets{k}_eager", bcfg, short, seed=BUCKET_SEED, steps_per_dispatch=k)
        eag.step_fn = make_train_step(eag.config, capture=False)
        seen = []
        step_fn = cap.step_fn

        def record(state, batch, resolution=None, _fn=step_fn, **kw):
            seen.append(resolution)
            return _fn(state, batch, resolution=resolution, **kw)

        def record_chunk(state, batches, resolution=None, _fn=step_fn):
            seen.extend([resolution] * len(batches))
            return _fn.chunk(state, batches, resolution=resolution)

        record.chunk = record_chunk
        cap.step_fn = record
        REPLAYS.reset(names)
        run(cap)
        launches = REPLAYS.read(names)
        want_seq = [BUCKETS[bucket_index(BUCKET_SEED, e, b, len(BUCKETS), k)]
                    for e in range(2) for b in range(per_epoch)]
        if seen != want_seq:
            raise AssertionError(f"K={k}: buckets {seen}, bucket_index gives {want_seq}")
        lo, hi = min(BUCKETS), max(BUCKETS)
        if not (seen.index(lo) < seen.index(hi) and lo in seen[seen.index(hi):]):
            raise AssertionError(f"K={k}: {seen} does not replay {lo} after capturing {hi}")
        n = len(seen)
        off = sum(r != tuple(cfg.data.image_size) for r in seen)
        want = {key: v for key, v in {**{key: v * n for key, v in per_step.items()},
                                      "resize_aa": off}.items() if v}
        got = {key: v for key, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"K={k} buckets: launches {got}, expected {want}")
        run(eag)
        diff = state_differences(torch, cap, eag)
        if diff:
            raise AssertionError(f"K={k} buckets: captured differs from eager: {diff[:5]}")
        buckets[f"k{k}"] = {"sequence": [r[0] for r in seen], "launches": got,
                            "graphs": len(cap.state.graphs)}
        del cap, eag
    log(f"  buckets {BUCKETS}: sequences = bucket_index, the smallest captured before the "
        f"largest and replayed after it, captured bitwise eager, per step NMS 1, IoU 2, "
        f"ROIPool 1 + 1, the resample 1 off the base canvas: {buckets}")
    shutil.rmtree(root, ignore_errors=True)
    launches = {f"data_{arm}": out[arm]["launches"] for arm in arms}
    launches.update({f"data_buckets_{k}": v["launches"] for k, v in buckets.items()})
    out["buckets"] = buckets
    return launches, out


BENCH_RUNS = 2  # benchmark runs per mode, train and eval alternating
BENCH_COUNT_STEPS = 3  # BENCH_STEPS of the in-process runs that count launches
# the JAX benchmark's breakdown keys
BREAKDOWN_KEYS = ("trunk_ms", "rpn_heads_ms", "proposal_nms_ms", "targets_ms", "head_loss_ms",
                  "targets_head_loss_ms", "backward_ms", "opt_update_ms", "backward_update_ms",
                  "step_ms", "opt_update_direct_ms", "dispatch_floor_ms",
                  "opt_update_direct_adj_ms")


def check_bench_line(line, mode):
    """One benchmark line: the JAX metric name and keys, a positive value;
    for train a FLOP count, an MFU in (0, 1] on the H100 datasheet basis
    and the JAX breakdown keys; for eval no baseline ratio and batch 8."""
    if line.get("metric") != f"{mode}_images_per_sec_600x600" or not line.get("value", 0) > 0:
        raise AssertionError(f"{mode} benchmark line: {line}")
    if mode == "train":
        bd = line.get("breakdown", {})
        if not (line["flops_per_step"] > 0 and line["mfu"] is not None and 0 < line["mfu"] <= 1
                and line["mfu_basis"] == "h100_datasheet_bf16_dense"
                and set(bd) == set(BREAKDOWN_KEYS)):
            raise AssertionError(f"train benchmark line: {line}")
    elif line["vs_baseline"] is not None or line["batch_size"] != 8:
        raise AssertionError(f"eval benchmark line: {line}")


def trace_device_share(trace_dir, steps):
    """From the Chrome trace ``utils/profiling.trace`` wrote in ``trace_dir``:
    the device's busy ms per step (union of kernel, copy and memset
    intervals), the span ms per step from its first to its last activity and
    the idle share of that span; None when the trace holds no device
    activity (a CPU run)."""
    path = next(Path(trace_dir).glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not spans:
        return None
    busy, span = busy_and_span(spans)
    return {"device_busy_ms_per_step": busy / 1e3 / steps,
            "device_span_ms_per_step": span / 1e3 / steps, "device_idle_share": 1 - busy / span}


def phase_bench(torch, device="cuda", runs=BENCH_RUNS):
    """Phase [9]: ``python -m replication_faster_rcnn_tpu_torch.benchmark`` as
    users run it (a subprocess: none of this script's TF32 and cuDNN
    settings), train and eval alternating, ``BENCH_RUNS`` each, every line
    checked; each metric's median, min and max. The last captured and the
    last eager train run also take ``BENCH_PROFILE_DIR``: each
    ``torch.profiler`` capture gives the card's busy ms and idle share per
    b16 step, and the idle share of that run's unprofiled timed step. Then
    each b16 step's device memory, captured and eager, measured alone
    (:func:`footprint`), and
    one in-process train and one eval measurement at ``BENCH_COUNT_STEPS``
    steps with the launch counters reset just before and read just after
    (per train step NMS 1, IoU matching 2, ROIPool 1 and its backward 1; per
    eval batch NMS 2 and ROIPool 1). ``device`` and ``runs`` (the subprocess
    runs per mode) are for rehearsals."""
    import os

    from replication_faster_rcnn_tpu_torch import benchmark
    from replication_faster_rcnn_tpu_torch.utils.profiling import has_device_trace

    log(f"[9] bench: python -m replication_faster_rcnn_tpu_torch.benchmark, train (batch 16) "
        f"and eval (batch 8) at 600x600, {runs} runs each, alternating")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    trace_dirs = {run: fresh_dir(REPO / "build" / f"chip_smoke_bench_trace_{run}")
                  for run in ("train", "train_eager")}
    lines = {"train": [], "train_eager": [], "eval": []}
    for i in range(runs):
        for run in ("train", "train_eager", "eval"):
            mode = "eval" if run == "eval" else "train"
            run_env = dict(env, BENCH_MODE=mode)
            if run == "train_eager":
                run_env["BENCH_CAPTURE"] = "0"  # the eager step, for comparison
            if run in trace_dirs and i == runs - 1:
                run_env["BENCH_PROFILE_DIR"] = str(trace_dirs[run])
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "replication_faster_rcnn_tpu_torch.benchmark"],
                cwd=REPO, env=run_env, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{mode} benchmark run exited {proc.returncode}: "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            check_bench_line(line, mode)
            if "BENCH_PROFILE_DIR" in run_env and (
                    line.get("trace") != "ok" or not has_device_trace(str(trace_dirs[run]))):
                raise AssertionError(f"bench {run}'s profiler capture: {line.get('trace')}")
            lines[run].append(line)
            log(f"  {run} run {i + 1} ({time.perf_counter() - t0:.1f} s): {json.dumps(line)}")
    summary = {}
    for mode, done in lines.items():
        if not done:
            continue
        values = [r["value"] for r in done]
        summary[mode] = {"median": statistics.median(values), "min": min(values),
                         "max": max(values), "values": values}
        if mode != "eval":
            for key in ("mfu", "flops_per_step"):
                summary[mode][key] = [r[key] for r in done]
            summary[mode]["breakdown"] = [r["breakdown"] for r in done]
        what = {"train": "captured step", "train_eager": "eager step (BENCH_CAPTURE=0)",
                "eval": "eval"}[mode]
        log(f"  {done[0]['metric']} ({what}): median {summary[mode]['median']} images/s, min "
            f"{summary[mode]['min']}, max {summary[mode]['max']} over {len(values)} runs")
    for run, trace_dir in trace_dirs.items():
        if lines[run]:
            profiled = trace_device_share(trace_dir, benchmark.TRACE_STEPS)
            if profiled is None:
                raise AssertionError(f"bench {run}'s profiler capture holds no device activity")
            # the profiler adds host time to the steps it captures: the card's
            # busy ms against the same run's unprofiled timed step as well
            step_ms = lines[run][-1]["breakdown"]["step_ms"]
            profiled["device_idle_share_of_timed_step"] = (
                1 - profiled["device_busy_ms_per_step"] / step_ms)
            summary[f"profiled_{run}"] = profiled
            log(f"  the profiled b16 steps of {run} run {runs} (timed step {step_ms} ms): "
                f"{profiled}")
        shutil.rmtree(trace_dir)

    # the b16 step's device memory, each path alone in this process
    from replication_faster_rcnn_tpu_torch.config import TrainConfig
    from replication_faster_rcnn_tpu_torch.train.train_step import (
        create_train_state, make_train_step)

    cfg = benchmark._flagship_cfg().replace(train=TrainConfig(batch_size=16))  # as _measure
    host = benchmark._synthetic_batch(cfg, cfg.train.batch_size)
    dev = torch.device(device)
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in ("image", "boxes", "labels", "mask")}
    memory = {}
    for tag, capture in (("captured", True), ("eager", False)):
        def build(capture=capture):
            return (create_train_state(cfg, steps_per_epoch=100, device=dev, seed=0),
                    make_train_step(cfg, capture=capture))

        def run_steps(obj, n):
            for _ in range(n):
                obj[1](obj[0], batch)

        memory[tag] = footprint(torch, dev, build, [("step 1", lambda obj: run_steps(obj, 1)),
                                                    ("steps 2-3", lambda obj: run_steps(obj, 2))])
        log(f"  b16 {tag} step's device memory, alone: {memory[tag]}")
    summary["memory_b16"] = memory

    names = ("nms", "iou_match") + ROI_NAMES
    saved = os.environ.get("BENCH_STEPS")
    os.environ["BENCH_STEPS"] = str(BENCH_COUNT_STEPS)
    try:
        REPLAYS.reset(names)
        benchmark._measure(device=device)
        train_launches = REPLAYS.read(names)
        REPLAYS.reset(names)
        benchmark._measure_eval(device=device)
        eval_launches = REPLAYS.read(names)
    finally:
        if saved is None:
            del os.environ["BENCH_STEPS"]
        else:
            os.environ["BENCH_STEPS"] = saved
    # warm-up, timed, the FLOP count's and the breakdown's steps
    steps = benchmark.WARMUP_STEPS + BENCH_COUNT_STEPS + 1 + benchmark.STAGE_STEPS
    per_step = {"nms": 1, "iou_match": 2, **roi_launches("pool", 1, 1)}
    if train_launches != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(f"bench train: expected per step {per_step} over {steps} steps, "
                             f"got {train_launches}")
    batches = benchmark.WARMUP_STEPS + BENCH_COUNT_STEPS
    per_batch = {"nms": 2, "iou_match": 0, **roi_launches("pool", 1, 0)}
    if eval_launches != {k: v * batches for k, v in per_batch.items()}:
        raise AssertionError(f"bench eval: expected per batch {per_batch} over {batches} "
                             f"batches, got {eval_launches}")
    log(f"  in-process: train launches {train_launches} over {steps} steps, eval launches "
        f"{eval_launches} over {batches} batches")
    return {"bench_train": train_launches, "bench_eval": eval_launches}, summary


STACK_BUCKETS = ((300, 300), (600, 600))
STACK_BATCHES = (1, 8)
STACK_DIR = REPO / "build" / "chip_smoke_serve"
LOADGEN_REQUESTS = 1024  # per closed-loop run (2-3 s on the H100); the open loop sends half
LOADGEN_CONCURRENCY = (8, 32)
SWAP_CLIENTS = 4
SERVE_TIMEOUT_S = 180  # the serve subprocess's start-up and drain


def stack_config(name, params_dtype, size=None, **serving):
    """``name`` with [11]'s buckets and batch sizes (``size`` shrinks the
    image size and the buckets for a CPU rehearsal)."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config

    cfg = get_config(name)
    buckets = STACK_BUCKETS
    if size is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=(size, size)))
        buckets = ((size // 2, size // 2), (size, size))
    return cfg.replace(serving=dataclasses.replace(
        cfg.serving, resolutions=buckets, batch_sizes=STACK_BATCHES, params_dtype=params_dtype,
        **serving))


def stack_images(rng, cfg):
    """Eight uint8 images of mixed sizes per bucket (each routes to that
    bucket), smallest bucket first."""
    out = {}
    previous = (0, 0)
    for h, w in cfg.serving.bucket_resolutions(cfg.data.image_size):
        shapes = [(h, w)] + [(int(rng.integers(previous[0] + 1, h + 1)),
                              int(rng.integers(previous[1] + 1, w + 1))) for _ in range(7)]
        out[(h, w)] = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
        previous = (h, w)
    return out


def padded(cfg, images, bucket, n):
    """The float32 [n, h, w, 3] batch a flush of ``images`` pads to."""
    from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize

    batch = np.zeros((n,) + tuple(bucket) + (3,), np.float32)
    for i, img in enumerate(images):
        batch[i] = resize_normalize(img, bucket, cfg.data.pixel_mean, cfg.data.pixel_std)
    return batch


def flush_outputs(torch, infer, batch, dev, reference=False):
    return {k: v.cpu().numpy() for k, v in infer(torch.from_numpy(batch).to(dev), reference).items()}


def same_arrays(got, want, what):
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k!r} differs")


def check_stack_graphs(torch, engine, images, want_per_replay):
    """Every (bucket, batch) graph of the current version: one replay on the
    bucket's images, launches counted per replay, bitwise equal to the same
    function run eagerly (the kernels) and to the plain replay
    (``reference=True``). Returns per graph the launches of one replay."""
    version = engine.model_version
    infer = engine._resident[version].infer
    names = tuple(want_per_replay)
    per = {}
    for (bucket, n), graph in sorted(engine.graphs().items()):
        batch = padded(engine.config, images[bucket][:n], bucket, n)
        REPLAYS.reset(names)
        got = graph(list(batch[:n]))
        counts = REPLAYS.read(names)
        if counts != want_per_replay:
            raise AssertionError(f"{bucket} b{n}: expected per replay {want_per_replay}, got "
                                 f"{counts}")
        same_arrays(got, flush_outputs(torch, infer[bucket], batch, engine.device),
                    f"{bucket} b{n} graph vs eager flush")
        same_arrays(got, flush_outputs(torch, infer[bucket], batch, engine.device, True),
                    f"{bucket} b{n} graph vs plain replay")
        per[f"{bucket[0]}x{bucket[1]}_b{n}"] = counts
    return per


def graph_memory(torch, engine):
    """Reserved bytes that capturing the current version's graphs adds (the
    shared pool and the static buffers), each side measured after
    ``empty_cache()``."""
    import gc

    version = engine.model_version
    resident = engine._resident[version]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    engine._capture_all(version, resident)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() - before


def timed_flushes(engine, one, eight, reps):
    """Median b1 latency (submit -> result), b1 and b8 flush ms (the
    engine's wall per flush) and b8 images/s (``predict`` of eight images:
    caller-side resize + one flush)."""
    lat, b8 = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.submit(one).result(timeout=300)
        lat.append((time.perf_counter() - t0) * 1e3)
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.predict(eight)
        b8.append(time.perf_counter() - t0)
    flush = list(engine.flush_seconds)[-2 * reps:]
    return {"b1_latency_ms": statistics.median(lat),
            "b1_flush_ms": statistics.median(flush[:reps]) * 1e3,
            "b8_flush_ms": statistics.median(flush[reps:]) * 1e3,
            "b8_images_per_s": 8 / statistics.median(b8)}


def stack_engines(torch, name, params_dtype, dev, state, artifact_path, size, images, want,
                  reps):
    """[11]'s checks on one preset and dtype: warm-up capture, per-graph
    parity and launches, warm flushes without captures, memory growth or
    host syncs, then graph against eager timings."""
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    cfg = stack_config(name, params_dtype, size)
    kw = dict(device=dev, state_dict=state, artifact_path=artifact_path)
    engine = InferenceEngine(cfg, **kw)
    graph_bytes = graph_memory(torch, engine) if engine.capture else 0
    out = {"config": name, "params_dtype": params_dtype,
           "capture_seconds": dict(engine.compile_seconds),
           "graph_pool_bytes": graph_bytes, "params_bytes": engine.params_bytes}
    big = max(images)
    one, eight = images[big][0], images[big]
    with engine:
        if engine.capture:
            out["launches_per_replay"] = check_stack_graphs(torch, engine, images, want)
            captures, graphs = dict(engine.compile_seconds), len(engine.graphs())
            for _ in range(2):  # warm every graph's pinned buffers and the caller's paths
                for imgs in images.values():
                    engine.predict(imgs)
                    engine.submit(imgs[0]).result(timeout=300)
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            torch.cuda.set_sync_debug_mode("error")  # the check sees a host read
            try:
                torch.ones(1, device=dev).item()
                raise AssertionError("sync debug mode 'error' let a host read through")
            except RuntimeError:
                pass
            finally:
                torch.cuda.set_sync_debug_mode(0)
            REPLAYS.sync_check = True
            try:
                for _ in range(3):
                    for imgs in images.values():
                        engine.predict(imgs)
                        engine.submit(imgs[0]).result(timeout=300)
            finally:
                REPLAYS.sync_check = False
            torch.cuda.synchronize()
            if engine.compile_seconds != captures or len(engine.graphs()) != graphs:
                raise AssertionError("a warm flush captured a graph")
            grown = torch.cuda.memory_reserved() - reserved
            if grown:
                raise AssertionError(f"warm flushes grew the reserved memory by {grown} bytes")
            out["warm_flushes"] = {"captures": 0, "reserved_growth_bytes": grown,
                                   "host_syncs": 0, "flushes": 6 * len(images)}
            timings = {}
            for (bucket, n), graph in sorted(engine.graphs().items()):
                if bucket != big:
                    continue
                infer = engine._resident[engine.model_version].infer[bucket]
                timings[f"b{n}"] = {
                    "graph_replay_ms": time_ms(torch, graph.graph.replay, 5),
                    "eager_ms": time_ms(torch, lambda: infer(graph.static_in), 5),
                }
            out["device_ms"] = timings
        out["graph"] = timed_flushes(engine, one, eight, reps)
    if engine.capture:
        with InferenceEngine(cfg, capture=False, **kw) as eager:
            eager.predict(eight)
            eager.submit(one).result(timeout=300)
            out["eager"] = timed_flushes(eager, one, eight, reps)
    log(f"  {name} {params_dtype}: captures {out['capture_seconds']} s; graph pool "
        f"{graph_bytes / 2**20:.1f} MiB; per replay {out.get('launches_per_replay')}; "
        f"graph {json.dumps(out['graph'])}; eager {json.dumps(out.get('eager'))}; "
        f"device ms {json.dumps(out.get('device_ms'))}")
    return out


def http_call(url, body=None, timeout=60):
    """(status, headers, parsed JSON or text) of one request."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, headers, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, dict(e.headers), e.read()
    text = raw.decode()
    try:
        return status, headers, json.loads(text)
    except ValueError:
        return status, headers, text


def write_jpegs(images, root):
    from PIL import Image

    paths = []
    for i, img in enumerate(images):
        path = root / f"req{i}.jpg"
        Image.fromarray(img).save(path, quality=95)
        paths.append(str(path))
    return paths


class FlushRecorder:
    """Each flush of one engine: its flush key's version, the answers it
    returned (the objects the callers receive), its wall seconds and the
    replay launches it added. The engine has one flush worker, so while only this engine
    serves, the replays between a flush's start and its end are its own."""

    def __init__(self, engine):
        self.flushes = []
        inner = engine._process_bucket_inner

        def recorded(version, resident, bucket, reference, items):
            before = dict(REPLAYS.counts)
            t0 = time.perf_counter()
            answers = inner(version, resident, bucket, reference, items)
            wall_s = time.perf_counter() - t0
            after = dict(REPLAYS.counts)
            self.flushes.append({
                "version": version, "bucket": bucket, "reference": reference,
                "answers": answers, "wall_s": wall_s,
                "launches": {k: after[k] - before.get(k, 0) for k in after
                             if after[k] != before.get(k, 0)}})
            return answers

        engine._process_bucket_inner = recorded


def run_flushes(flushes):
    """The flushes of one load-generator run: how many, their mean batch,
    and their median and p90 wall ms (the worker's staging, replay, copy
    back and unpacking)."""
    wall = sorted(f["wall_s"] * 1e3 for f in flushes)
    return {"flushes": len(flushes),
            "mean_batch": sum(len(f["answers"]) for f in flushes) / len(flushes),
            "wall_ms_p50": statistics.median(wall),
            "wall_ms_p90": wall[int(0.9 * (len(wall) - 1))]}


def http_images(engine, root):
    """Three JPEG files routed to the big bucket (one at its size, two
    smaller)."""
    big = engine.buckets[-1]
    rng = np.random.default_rng(21)
    shapes = [big, (big[0] * 3 // 4, big[1]), (big[0] // 2, big[1] * 2 // 3)]
    return write_jpegs([rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes], root)


def phase_http(engine, paths, root):
    """Real HTTP round trips against ``make_server`` on the warm engine:
    /predict (200, equal to ``submit_path``), a missing file's 400,
    /healthz, /stats, /metrics and /swap (501)."""
    import threading

    from replication_faster_rcnn_tpu_torch.serving.server import make_server

    out = {}
    server = make_server(engine, port=0, score_thresh=0.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, _, body = http_call(f"{base}/predict", {"paths": paths, "score_thresh": 0.0})
        if status != 200 or sorted(body["detections"]) != sorted(paths):
            raise AssertionError(f"/predict: {status} {str(body)[:300]}")
        for p in paths:
            direct = engine.submit_path(p).result(timeout=300)
            want = int(direct["valid"].sum())
            if len(body["detections"][p]) != want:
                raise AssertionError(f"/predict {p}: {len(body['detections'][p])} detections, "
                                     f"submit_path {want}")
        out["predict"] = {"status": status, "detections": [len(body["detections"][p])
                                                           for p in paths]}
        status_bad, _, _ = http_call(f"{base}/predict", {"paths": [str(root / "missing.jpg")]})
        if status_bad != 400:
            raise AssertionError(f"/predict of a missing file: {status_bad}")
        status, _, health = http_call(f"{base}/healthz")
        if status != 200 or not health["ok"] or health["degraded"]:
            raise AssertionError(f"/healthz: {status} {health}")
        status, _, stats = http_call(f"{base}/stats")
        if status != 200 or stats.get("schema") != "frcnn-stats/v1" or "slo" not in stats:
            raise AssertionError(f"/stats: {status} {str(stats)[:300]}")
        status, _, metrics = http_call(f"{base}/metrics")
        for metric in ("serve_requests_total", "serve_flush_seconds_bucket",
                       "serve_queue_wait_seconds_count", "serve_model_version"):
            if metric not in metrics:
                raise AssertionError(f"/metrics lacks {metric}")
        status_swap, _, _ = http_call(f"{base}/swap", {"version": "1"})
        if status_swap != 501:
            raise AssertionError(f"/swap without a handler: {status_swap}")
        out.update(healthz=health["params_dtype"], stats_requests=stats["stats"]["requests"],
                   metrics_lines=len(metrics.splitlines()), bad_path=status_bad,
                   swap=status_swap)
    finally:
        server.shutdown()
        server.server_close()
    log(f"  HTTP: {json.dumps(out)}")
    return out


def phase_overload(cfg, state, path, dev):
    """Overload over HTTP on an engine with ``queue_depth=1`` and
    ``request_timeout_s=1`` whose first flush a ``batcher.flush`` failpoint
    holds for 3 s: a full queue's 503 with ``Retry-After`` and the 504s of
    the requests it held."""
    import dataclasses
    import threading

    from replication_faster_rcnn_tpu_torch.faultlib import failpoints
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
    from replication_faster_rcnn_tpu_torch.serving.server import make_server

    big = cfg.serving.bucket_resolutions(cfg.data.image_size)[-1]
    tight_cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, resolutions=(big,), batch_sizes=(1,), queue_depth=1,
        request_timeout_s=1.0))
    tight = InferenceEngine(tight_cfg, device=dev, state_dict=state, warmup=True)
    server = make_server(tight, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    held = {}
    try:
        failpoints.configure("batcher.flush:delay:1.0:0:3000:1")

        def post(key):
            held[key] = http_call(f"{base}/predict", {"path": path})

        first = threading.Thread(target=post, args=("first",))
        first.start()
        deadline = time.time() + 30
        while failpoints.site_hits().get("batcher.flush", 0) < 1:  # the worker is held
            if time.time() > deadline:
                raise AssertionError("the held flush never started")
            time.sleep(0.01)
        second = threading.Thread(target=post, args=("second",))
        second.start()
        while tight.queue_depth() < 1:  # the one queue slot is taken
            if time.time() > deadline:
                raise AssertionError("the second request never queued")
            time.sleep(0.01)
        status, headers, body = http_call(f"{base}/predict", {"path": path})
        if status != 503 or "Retry-After" not in headers:
            raise AssertionError(f"a full queue: {status} {headers} {body}")
        first.join(60)
        second.join(60)
        codes = (held["first"][0], held["second"][0])
        if codes != (504, 504):
            raise AssertionError(f"requests held past request_timeout_s: {codes}")
        out = {"full_queue": status, "retry_after": headers["Retry-After"],
               "held_past_deadline": list(codes), "stats": tight.stats}
    finally:
        failpoints.disarm()
        server.shutdown()
        server.server_close()
        tight.close()
    log(f"  HTTP overload: {json.dumps(out)}")
    return out


def swap_references(torch, engine, version, images):
    """Per big-bucket image, ``version``'s eager flush of it at b1 and as
    row i of the b8 flush of all eight (the answers a flush can give)."""
    bucket = engine.buckets[-1]
    imgs = images[bucket]
    infer = engine._resident[version].infer[bucket]
    b8 = flush_outputs(torch, infer, padded(engine.config, imgs, bucket, 8), engine.device)
    refs = []
    for i, img in enumerate(imgs):
        b1 = flush_outputs(torch, infer, padded(engine.config, [img], bucket, 1), engine.device)
        refs.append([{k: v[0] for k, v in b1.items()}, {k: v[i] for k, v in b8.items()}])
    return refs


def swap_under_load(torch, engine, state1, images):
    """``SWAP_CLIENTS`` threads submit the big bucket's images while the
    engine swaps to ``state1`` (version "1"). Returns the answers with
    their submit and completion times, the swap's times, and the launches
    of the new version's warm-ups (eager runs, one per captured graph)."""
    import threading

    imgs = images[engine.buckets[-1]]
    records, stop = [], threading.Event()
    lock = threading.Lock()

    def client(k):
        i = k
        while not stop.is_set():
            t0 = time.perf_counter()
            res = engine.submit(imgs[i % len(imgs)]).result(timeout=300)
            with lock:
                records.append((t0, time.perf_counter(), i % len(imgs), res))
            i += SWAP_CLIENTS

    def load_for(seconds, done):
        """Let the load run ``seconds`` and on until ``done()``."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not done():
            if time.perf_counter() - t0 > SERVE_TIMEOUT_S:
                raise AssertionError("the swap's load answered nothing in time")
            time.sleep(0.05)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SWAP_CLIENTS)]
    for t in threads:
        t.start()
    load_for(1.0, lambda: bool(records))
    reserved = torch.cuda.memory_reserved() if engine.capture else 0
    eager0 = read_counters()
    t_swap0 = time.perf_counter()
    prior = engine.swap_params(state1, "1")
    t_swap1 = time.perf_counter()
    eager1 = read_counters()
    reserved = (torch.cuda.memory_reserved() if engine.capture else 0) - reserved
    load_for(1.0, lambda: any(r[0] > t_swap1 for r in list(records)))
    stop.set()
    for t in threads:
        t.join(300)
    if prior != "0":
        raise AssertionError(f"swap returned prior {prior!r}")
    return {"records": records, "t_swap": (t_swap0, t_swap1), "reserved": reserved,
            "warmup_launches": {k: eager1[k] - eager0[k] for k in eager1
                                if eager1[k] != eager0[k]}}


def check_swap(engine, swap, refs, imgs, flushes, state1):
    """The hot-swap's answers against each version's eager flushes: each
    answer equals exactly one version's, answers completed before the swap
    began are version "0" and requests submitted after it returned are
    version "1"; a flush is version-mixed when its answers come from more
    than one version or from another version than its flush key's. Then a
    second swap retires version "0" and its graphs."""
    bucket = engine.buckets[-1]
    t_swap0, t_swap1 = swap["t_swap"]
    version_of = {}
    seen = {"0": 0, "1": 0}
    for t0, t1, i, res in swap["records"]:
        h, w = imgs[i].shape[:2]
        back = np.asarray([h / bucket[0], w / bucket[1]] * 2, np.float32)
        match = [v for v in ("0", "1") if any(
            np.array_equal(res["boxes"], r["boxes"] * back)
            and all(np.array_equal(res[k], r[k]) for k in ("scores", "classes", "valid"))
            for r in refs[v][i])]
        if len(match) != 1:
            raise AssertionError(f"an answer matches {match} of the versions' eager flushes")
        seen[match[0]] += 1
        version_of[id(res)] = match[0]
        if t1 < t_swap0 and match[0] != "0":
            raise AssertionError("an answer completed before the swap came from version 1")
        if t0 > t_swap1 and match[0] != "1":
            raise AssertionError("a request admitted after the swap was answered by version 0")
    if not seen["0"] or not seen["1"]:
        raise AssertionError(f"the load saw one version only: {seen}")
    if len(version_of) != sum(len(f["answers"]) for f in flushes):
        raise AssertionError("the swap's flushes returned answers no client received")
    mixed = [f for f in flushes
             if {version_of[id(a)] for a in f["answers"]} != {f["version"]}]
    if mixed:
        raise AssertionError(f"{len(mixed)} version-mixed flushes: "
                             f"{[(f['version'], len(f['answers'])) for f in mixed[:5]]}")
    by_version = {v: sum(1 for f in flushes if f["version"] == v) for v in ("0", "1")}
    engine.swap_params(state1, "2")
    if set(engine.resident_versions()) != {"1", "2"}:
        raise AssertionError(f"version 0 was not retired: {engine.resident_versions()}")
    out = {"answers": len(swap["records"]), "answers_by_version": seen,
           "flushes_by_version": by_version, "version_mixed_flushes": len(mixed),
           "swap_s": t_swap1 - t_swap0, "reserved_growth_on_swap_bytes": swap["reserved"],
           "swap_warmup_launches": swap["warmup_launches"],
           "resident_after_second_swap": engine.resident_versions()}
    log(f"  hot-swap under load: {json.dumps(out)}")
    return out


def main_path_launches(engine, names, want, flushes, warmups):
    """The launches of the main-path run's traffic: the replays of its
    flushes. On the card every flush replayed a graph with ``want``
    launches, the replays' total is the sum over the flushes, and the
    wrappers' eager calls in the run are the hot-swap's warm-ups only (one
    eager run of each new graph's function)."""
    replayed = {k: REPLAYS.counts.get(k, 0) for k in names}
    if not engine.capture:
        return replayed
    eager = read_counters()
    warm = len(engine.graphs("1"))
    for k in names:
        if eager[k] != warmups.get(k, 0) or warmups.get(k, 0) != warm * want[k]:
            raise AssertionError(f"{k}: {eager[k]} eager launches in the run, the swap's "
                                 f"{warm} warm-ups account for {warmups.get(k, 0)} of "
                                 f"{warm * want[k]} expected")
    for f in flushes:
        if f["reference"] or {k: f["launches"].get(k, 0) for k in names} != want:
            raise AssertionError(f"a flush of {f['bucket']} launched {f['launches']} by "
                                 f"replay, not {want}")
    if replayed != {k: len(flushes) * want[k] for k in names}:
        raise AssertionError(f"{len(flushes)} flushes of {want} each, replays counted "
                             f"{replayed}")
    return replayed


def phase_serve_cli(root, workdir, path, size=None, device=None):
    """``python -m replication_faster_rcnn_tpu_torch serve`` as a user runs it:
    its start-up JSON, one /predict, then SIGTERM: /healthz shows draining
    within the grace window and the process exits 0."""
    import signal
    import threading

    cmd = [sys.executable, "-m", "replication_faster_rcnn_tpu_torch", "serve",
           "--config", "voc_resnet18", "--workdir", str(workdir), "--port", "0",
           "--bucket-batch-sizes", "1", "--replica-id", "r0"]
    if size is not None:
        cmd += ["--image-size", str(size), "--resolutions", f"{size}x{size}"]
    else:
        cmd += ["--resolutions", "600x600"]
    if device is not None:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines, err = [], []
    threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True).start()
    try:
        url = None
        deadline = time.time() + SERVE_TIMEOUT_S
        while url is None:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"serve exited before listening: {''.join(err)[-2000:]}")
            lines.append(line)
            if line.startswith("serving on "):
                url = line.split()[2].rstrip("/")
            if time.time() > deadline:
                raise AssertionError("serve did not start in time")
        first = next(i for i, line in enumerate(lines) if line.startswith("{"))
        last = next(i for i, line in enumerate(lines) if line.startswith("}"))
        startup = json.loads("".join(lines[first:last + 1]))
        ready_s = time.perf_counter() - t0
        status, _, body = http_call(f"{url}/predict", {"path": path})
        if status != 200:
            raise AssertionError(f"serve /predict: {status} {body}")
        proc.send_signal(signal.SIGTERM)
        health = {}
        for _ in range(40):  # the handler runs between the main thread's polls
            status, _, health = http_call(f"{url}/healthz")
            if health.get("draining"):
                break
            time.sleep(0.02)
        rc = proc.wait(timeout=SERVE_TIMEOUT_S)
        if rc != 0 or not health.get("draining"):
            raise AssertionError(f"serve drain: rc {rc}, /healthz {health}, "
                                 f"{''.join(err)[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = {"ready_s": ready_s, "compile_seconds": startup["compile_seconds"],
           "model_version": startup["model_version"], "device": startup["device"],
           "predict_detections": len(body["detections"][path]), "draining_seen": True,
           "exit_code": rc}
    log(f"  serve subprocess: {json.dumps(out)}")
    return out


def phase_serving_stack(torch, int8_artifact=None, device=None, size=None, reps=REPS,
                        requests=LOADGEN_REQUESTS):
    """Phase [11]: the serving stack on the card. ``int8_artifact``: [5]'s
    sidecar (calibrated here when missing). ``device``/``size``/``reps``/
    ``requests``: a CPU rehearsal passes ``"cpu"``, a small image size and
    fewer repetitions (graphs exist on the card only). Returns (launches of
    its main-path run, numbers)."""
    from replication_faster_rcnn_tpu_torch import quant
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
    from replication_faster_rcnn_tpu_torch.serving import loadgen
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer, load_eval_variables

    dev = torch.device(device or "cuda")
    root = fresh_dir(STACK_DIR)
    t_phase = time.perf_counter()
    log("[11] serving stack: voc_resnet18 bfloat16 and voc12_resnet18_align int8, buckets "
        f"{STACK_BUCKETS if size is None else size} x {STACK_BATCHES}")
    rng = np.random.default_rng(11)
    out = {}
    bf16_cfg = stack_config("voc_resnet18", "bfloat16", size)
    images = stack_images(rng, bf16_cfg)
    state0 = build_model(bf16_cfg, device=dev, seed=0).state_dict()
    bf16_want = {"nms": 2, **roi_launches("pool")}
    out["bf16"] = stack_engines(torch, "voc_resnet18", "bfloat16", dev, state0, None, size,
                                images, bf16_want, reps)

    align_cfg = stack_config("voc12_resnet18_align", "int8", size)
    align_state = build_model(align_cfg, device=dev, seed=0).state_dict()
    artifact = int8_artifact
    if artifact is None or not Path(artifact).exists():
        artifact = str(root / "quant_artifact.json")
        model = build_model(align_cfg, device=dev, seed=0)
        qc = align_cfg.quant
        batches = quant.synthetic_calibration_batches(align_cfg, qc.calib_batches,
                                                      qc.calib_batch_size)
        quant.save_artifact(artifact, quant.calibrate(model, align_state, batches, align_cfg))
        del model
    gemm, deq = expected_int8_launches(quant.load_artifact(artifact))
    int8_want = {"nms": 2, "roi_align": 1, "int8_matmul": gemm, "dequantize": deq}
    out["int8"] = stack_engines(torch, "voc12_resnet18_align", "int8", dev, align_state,
                                artifact, size, stack_images(rng, align_cfg), int8_want, reps)
    del align_state

    names = tuple(bf16_want)
    ckpt = root / "ckpt"
    trainer = Trainer(bf16_cfg, SyntheticDataset(bf16_cfg.data, length=8), device=dev, seed=1,
                      workdir=str(ckpt))
    trainer.save(kind="final")
    del trainer
    state1 = load_eval_variables(bf16_cfg, str(ckpt), device=dev).state_dict()
    engine = InferenceEngine(bf16_cfg, device=dev, state_dict=state0, warmup=True)
    recorder = FlushRecorder(engine)
    paths = http_images(engine, root)
    big = engine.buckets[-1]
    with engine:
        refs = {"0": swap_references(torch, engine, "0", images)}
        # the main-path run: the load generator, HTTP and the hot-swap's
        # traffic on the bf16 flagship with its graphs captured at start-up
        first = len(recorder.flushes)
        REPLAYS.reset(names)
        flat = [img for imgs in images.values() for img in imgs]
        closed, flush_stats = {}, {}
        for k in LOADGEN_CONCURRENCY:
            at = len(recorder.flushes)
            closed[k] = loadgen.run_closed_loop(engine, flat, requests, concurrency=k)
            if closed[k]["errors"] or closed[k]["timeouts"]:
                raise AssertionError(f"closed loop at {k}: {closed[k]}")
            flush_stats[f"concurrency_{k}"] = run_flushes(recorder.flushes[at:])
        rate = max(r["images_per_sec"] for r in closed.values()) / 2
        at = len(recorder.flushes)
        opened = loadgen.run_open_loop(engine, flat, rate, n_requests=requests // 2)
        if opened["errors"] or opened["timeouts"]:
            raise AssertionError(f"open loop: {opened}")
        flush_stats["open"] = run_flushes(recorder.flushes[at:])
        out["loadgen"] = {"closed": {f"concurrency_{k}": v for k, v in closed.items()},
                          "open": opened, "flushes": flush_stats}
        log(f"  loadgen: {json.dumps(out['loadgen'])}")
        out["http"] = phase_http(engine, paths, root)
        at_swap = len(recorder.flushes)
        swap = swap_under_load(torch, engine, state1, images)
        launches = main_path_launches(engine, names, bf16_want, recorder.flushes[first:],
                                      swap["warmup_launches"])
        out["flushes"] = len(recorder.flushes) - first
        refs["1"] = swap_references(torch, engine, "1", images)
        out["swap"] = check_swap(engine, swap, refs, images[big], recorder.flushes[at_swap:],
                                 state1)
    if engine.capture and not (launches["nms"] and launches["roi_pool"]):
        raise AssertionError(f"the main-path run launched no NMS or ROIPool: {launches}")
    out["http"]["overload"] = phase_overload(bf16_cfg, state0, paths[0], dev)
    out["serve_cli"] = phase_serve_cli(root, ckpt, paths[0], size, device)
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  [11] took {out['phase_s']:.1f} s; launches in the main-path run {launches}")
    return launches, out


# ------------------------------------------------------------- [12] FPN

FPN_NAME = "voc_resnet50_fpn"
FPN_TRAIN_STEPS = 4  # captured and eager steps held bitwise
FPN_SERVE_WANT = {"nms": 2, "roi_multilevel": 1, "roi_multilevel_bwd": 0, "roi_align": 0,
                  "roi_align_bwd": 0, "roi_pool": 0, "roi_pool_bwd": 0}
FPN_TRAIN_WANT = {"nms": 1, "iou_match": 2, "roi_multilevel": 1, "roi_multilevel_bwd": 1,
                  "roi_align": 0, "roi_align_bwd": 0, "roi_pool": 0, "roi_pool_bwd": 0}


def fpn_config(size=None, batch=8):
    """``voc_resnet50_fpn`` at batch ``batch`` (``size`` shrinks the image
    for a CPU rehearsal)."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config

    cfg = get_config(FPN_NAME)
    if size is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=(size, size)))
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))


def phase_fpn_serve(torch, device=None, size=None, reps=REPS):
    """Phase [12], serving: ``voc_resnet50_fpn`` in bfloat16 through
    ``InferenceEngine`` graphs at buckets 300 and 600 x b1, b8 ([11]'s
    checks, :func:`stack_engines`): every graph bitwise its eager flush and
    the plain replay, NMS 2 and multi-level ROIAlign 1 per replay, warm
    flushes without capture, growth or host sync; b1 flush ms, b1 latency
    and b8 images/s, graph against eager."""
    dev = torch.device(device or "cuda")
    cfg = stack_config(FPN_NAME, "bfloat16", size)
    images = stack_images(np.random.default_rng(12), cfg)
    log(f"[12] main path: serve {FPN_NAME} (ResNet50 + FPN P2-P6, multi-level ROIAlign, two-fc "
        f"head) bfloat16 at buckets {cfg.serving.bucket_resolutions(cfg.data.image_size)} x "
        f"{cfg.serving.batch_sizes}")
    serve = stack_engines(torch, FPN_NAME, "bfloat16", dev, None, None, size, images,
                          FPN_SERVE_WANT, reps)
    launches = {k: 0 for k in FPN_SERVE_WANT}
    for counts in serve.get("launches_per_replay", {}).values():
        for k, v in counts.items():
            launches[k] += v
    return launches, serve


FPN_INT8_DIR = REPO / "build" / "chip_smoke_fpn_int8"


def cli_subprocess(args, timeout=SERVE_TIMEOUT_S):
    """``python -m replication_faster_rcnn_tpu_torch ARGS`` as a user runs
    it (none of this script's TF32 and cuDNN settings): (stdout, seconds);
    a non-zero exit raises with its stderr's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "replication_faster_rcnn_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_fpn_int8(torch, bf16, device=None, size=None, reps=REPS):
    """Phase [12], int8: ``voc_resnet50_fpn`` calibrated and swept by
    ``python -m replication_faster_rcnn_tpu_torch quantize --synthetic-calib
    --sweep`` in a subprocess (its seeded init, as ``load_eval_variables``
    gives it with no checkpoint), its sidecar served through int8 graphs at
    buckets 300 and 600 x b1, b8 with [11]'s checks (:func:`stack_engines`:
    each replay bitwise its eager flush and the plain replay; per replay
    int8 GEMM 2, dequantize 1, NMS 2, multi-level ROIAlign 1); the resident
    tree under 0.4 x float32 and the engine's device memory below the
    bfloat16 engine's; a hot-swap to a second int8 version (its graphs
    captured before the flip, one replay of each bitwise the plain replay,
    the reserved bytes it adds); then ``predict --params-dtype int8`` in a
    subprocess on a JPEG. ``bf16``: [12]'s bfloat16 serving numbers, printed
    beside these."""
    from replication_faster_rcnn_tpu_torch import quant
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    dev = torch.device(device or "cuda")
    root = fresh_dir(FPN_INT8_DIR)
    t_phase = time.perf_counter()
    cfg = stack_config(FPN_NAME, "int8", size)
    log(f"[12] main path: quantize {FPN_NAME} through the command line, serve it in int8 at "
        f"buckets {cfg.serving.bucket_resolutions(cfg.data.image_size)} x "
        f"{cfg.serving.batch_sizes}")
    extra = (["--image-size", str(size)] if size is not None else []) + (
        ["--device", device] if device is not None else [])
    path = root / "quant_artifact.json"
    printed, quant_s = cli_subprocess(["quantize", "--config", FPN_NAME, "--workdir", str(root),
                                       "--synthetic-calib", "--sweep", *extra])
    printed = json.loads(printed)
    artifact = quant.load_artifact(str(path))
    if printed["artifact"] != str(path) or artifact["plan"] != printed["plan"]:
        raise AssertionError(f"quantize printed {printed['artifact']} {printed['plan']}")
    gemm, deq = expected_int8_launches(artifact)
    if (gemm, deq) != (2, 1):
        raise AssertionError(f"the sweep's plan {artifact['plan']} runs {gemm} GEMMs and {deq} "
                             "dequantizes a flush, not 2 and 1")
    recon = {g: round(r["recon_rel_err"], 5) for g, r in artifact["sensitivity"].items()}
    log(f"  quantize subprocess: {quant_s:.1f} s; groups {printed['groups']}; plan "
        f"{artifact['plan']}; recon rel err {recon}; fc7 range "
        f"{artifact['activation_ranges']}")
    state = build_model(cfg, device=dev, seed=0).state_dict()
    f32_bytes = sum(t.numel() * 4 for t in state.values())
    state = {k: v.cpu() for k, v in state.items()}
    bf16_cfg = stack_config(FPN_NAME, "bfloat16", size)
    eng, bf16_alloc = allocated_by(
        torch, lambda: InferenceEngine(bf16_cfg, device=dev, state_dict=state))
    eng.close()
    del eng
    eng, int8_alloc = allocated_by(
        torch, lambda: InferenceEngine(cfg, device=dev, state_dict=state,
                                       artifact_path=str(path)))
    eng.close()
    del eng
    log(f"  device memory after construction: int8 engine {int8_alloc} bytes, bfloat16 "
        f"engine {bf16_alloc}")
    if not int8_alloc < bf16_alloc:
        raise AssertionError(f"int8 FPN engine holds {int8_alloc} bytes, bf16 {bf16_alloc}")
    want = dict(FPN_SERVE_WANT, int8_matmul=gemm, dequantize=deq)
    images = stack_images(np.random.default_rng(12), cfg)
    big = max(images)
    serve = stack_engines(torch, FPN_NAME, "int8", dev, state, str(path), size, images, want,
                          reps)
    if not serve["params_bytes"] < 0.4 * f32_bytes:
        raise AssertionError(f"int8 FPN params {serve['params_bytes']} >= 0.4 x {f32_bytes}")
    serve.update({"f32_params_bytes": f32_bytes, "device_bytes_after_construction": int8_alloc,
                  "bf16_device_bytes_after_construction": bf16_alloc,
                  "quantize_subprocess_s": quant_s, "plan": artifact["plan"],
                  "recon_rel_err": recon,
                  "fc7_range": artifact["activation_ranges"][quant.EMBED_RANGE_KEY],
                  "bf16_same_run": {k: bf16["graph"][k] for k in bf16["graph"]},
                  "bf16_graph_pool_bytes": bf16["graph_pool_bytes"]})
    launches = {k: 0 for k in want}
    for counts in serve.get("launches_per_replay", {}).values():
        for k, v in counts.items():
            launches[k] += v

    # a hot-swap to a second int8 version (the same weights and sidecar as
    # version "1"): captured before the flip, each replay bitwise
    with InferenceEngine(cfg, device=dev, state_dict=state, artifact_path=str(path),
                         warmup=True) as engine:
        if engine.capture:
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
        prior = engine.swap_params(state, "1", artifact_path=str(path))
        if prior != "0" or engine.model_version != "1" or set(engine.resident_versions()) \
                != {"0", "1"}:
            raise AssertionError(f"swap: prior {prior}, now {engine.model_version}, "
                                 f"resident {engine.resident_versions()}")
        added, per = 0, {}
        if engine.capture:
            torch.cuda.synchronize()
            added = torch.cuda.memory_reserved() - reserved
            per = check_stack_graphs(torch, engine, images, want)
        else:
            same_results(engine.predict(images[big]), engine.predict(images[big], reference=True),
                         "int8 FPN version 1")
        for counts in per.values():
            for k, v in counts.items():
                launches[k] += v
        serve["swap"] = {"second_version_reserved_bytes": added, "launches_per_replay": per}
        log(f"  hot-swap to int8 version 1: captured before the flip, adds {added / 2**20:.1f} "
            f"MiB reserved beside version 0; every replay bitwise the plain replay")

    # predict on a JPEG from the sidecar, as a user runs it
    from PIL import Image

    jpeg = root / "image.jpg"
    Image.fromarray(images[big][0]).save(jpeg, quality=95)
    printed, predict_s = cli_subprocess(["predict", "--config", FPN_NAME, "--workdir",
                                         str(root), "--image", str(jpeg), "--params-dtype",
                                         "int8", "--score-thresh", "0.0", *extra])
    dets = json.loads(printed)
    if not isinstance(dets, list) or any(
            sorted(d) != ["box", "class_id", "class_name", "score"] for d in dets):
        raise AssertionError(f"predict printed {printed[:500]}")
    serve["predict_subprocess"] = {"seconds": predict_s, "detections": len(dets)}
    shutil.rmtree(root, ignore_errors=True)
    serve["phase_s"] = time.perf_counter() - t_phase
    g, b = serve["graph"], bf16["graph"]
    log(f"  int8 FPN: b1 flush {g['b1_flush_ms']:.2f} ms (bf16 {b['b1_flush_ms']:.2f}), b1 "
        f"latency {g['b1_latency_ms']:.2f} ms (bf16 {b['b1_latency_ms']:.2f}), b8 "
        f"{g['b8_images_per_s']:.1f} images/s (bf16 {b['b8_images_per_s']:.1f}); graph pool "
        f"{serve['graph_pool_bytes'] / 2**20:.1f} MiB (bf16 {bf16['graph_pool_bytes'] / 2**20:.1f});"
        f" resident {serve['params_bytes']} bytes ({serve['params_bytes'] / f32_bytes:.4f} of "
        f"float32); predict subprocess {predict_s:.1f} s, {len(dets)} detections; "
        f"[12] int8 took {serve['phase_s']:.1f} s")
    return launches, serve


def phase_fpn_train(torch, cfg=None, device=None):
    """Phase [12], training: two ``Trainer``s of ``voc_resnet50_fpn`` at b8
    from one seed, one capturing its step as a CUDA graph, one eager: the
    same ``FPN_TRAIN_STEPS`` steps bitwise equal in state and metrics; then
    each path's timed and profiled steps (:func:`timed_train_path`, [6]'s
    checks: launches per step NMS 1, IoU matching 2, multi-level ROIAlign
    forward 1 and backward 1, the single-map ROI ops 0; no growth of the
    reserved memory; the device timeline and its idle share) and its peak
    allocated memory."""
    import dataclasses
    import gc

    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.train.train_step import make_train_step
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = cfg or fpn_config()
    dev = torch.device(device or "cuda")
    bsz = cfg.train.batch_size
    log(f"[12] main path: train {FPN_NAME} {cfg.data.image_size} batch {bsz}, compute "
        f"{cfg.model.compute_dtype}, {cfg.proposals.pre_nms_train} -> "
        f"{cfg.proposals.post_nms_train} proposals; captured against eager")
    dataset = SyntheticDataset(cfg.data, length=2 * bsz)
    names = tuple(FPN_TRAIN_WANT)
    out = {"config": FPN_NAME, "batch": bsz}
    hist, trainers = {}, {}
    for tag in ("captured", "eager"):
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        trainer = Trainer(cfg, dataset, device=dev, seed=0)
        if tag == "eager":
            trainer.step_fn = make_train_step(cfg, capture=False)
        trainer.loader.set_epoch(0)
        batches = [trainer.stage_batch(b) for b in trainer.loader]
        hist[tag] = [trainer.train_one_batch(staged=batches[i % 2])
                     for i in range(FPN_TRAIN_STEPS)]
        out[tag] = timed_train_path(torch, dev, f"FPN {tag}", trainer, batches, names,
                                    FPN_TRAIN_WANT, "multilevel", "multi-level ROIAlign")
        out[tag]["peak_allocated_gib"] = peak = (
            torch.cuda.max_memory_allocated(dev) - base) / 2**30
        log(f"  {tag}: {out[tag]['step_ms']:.2f} ms a step (median of {TRAIN_REPS}, CUDA "
            f"events), {bsz / out[tag]['step_ms'] * 1e3:.1f} images/s; peak allocated "
            f"{peak:.2f} GiB")
        trainers[tag] = trainer
    check_train_timelines(out, "FPN ")
    diff = state_differences(torch, trainers["captured"], trainers["eager"])
    mdiff = metrics_differences(torch, hist["captured"], hist["eager"])
    if diff or mdiff:
        raise AssertionError(f"FPN captured vs eager: state differs in {diff[:5]}, metrics in "
                             f"{mdiff[:5]}")
    for row in hist["captured"]:
        if not all(np.isfinite(float(row[k])) for k in ("loss", "rpn_cls_loss", "rpn_reg_loss",
                                                         "head_cls_loss", "head_reg_loss")):
            raise AssertionError(f"FPN: non-finite losses {row}")
    log(f"  {FPN_TRAIN_STEPS} steps captured and eager bitwise equal in the whole state and "
        f"every metric; {out['captured']['step_ms']:.2f} ms captured against "
        f"{out['eager']['step_ms']:.2f} ms eager")
    # the evaluator on the trained weights: 16 VOC-sized images, b8 (per
    # batch NMS 2 and multi-level ROIAlign 1), a finite mAP
    from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator

    names = ("nms", "roi_multilevel", "roi_multilevel_bwd")
    REPLAYS.reset(names)
    result = Evaluator(cfg, device=dev).evaluate(trainers["captured"].model,
                                                 VOCLikeDataset(cfg.data, n=16), batch_size=8)
    eval_launches = REPLAYS.read(names)
    if eval_launches != {"nms": 4, "roi_multilevel": 2, "roi_multilevel_bwd": 0}:
        raise AssertionError(f"FPN evaluate: expected NMS 2 and multi-level ROIAlign 1 per "
                             f"batch over 2 batches, got {eval_launches}")
    if not 0.0 <= float(result["mAP"]) <= 1.0:
        raise AssertionError(f"FPN evaluate: mAP {result['mAP']}")
    out["evaluate"] = {"mAP": float(result["mAP"]), "images": 16, "launches": eval_launches}
    log(f"  Evaluator on the trained weights: 16 images, b8, mAP@0.5 {float(result['mAP']):.4f} "
        f"(random start), launches {eval_launches}")
    launches = out["captured"]["launches"]
    eager_launches = out["eager"]["launches"]
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    return launches, eager_launches, out


def phase_fpn_bench(torch):
    """Phase [12], the benchmark in this process (this script's TF32 and
    cuDNN settings): ``benchmark.main`` of ``voc_resnet50_fpn`` at b8, once
    train (the captured step) and once eval, images/s and MFU."""
    import gc
    import os

    from replication_faster_rcnn_tpu_torch import benchmark

    cfg = fpn_config()
    lines = {}
    for mode in ("train", "eval"):
        before = os.environ.get("BENCH_MODE")
        os.environ["BENCH_MODE"] = mode
        try:
            lines[mode] = benchmark.main(cfg)
        finally:
            if before is None:
                os.environ.pop("BENCH_MODE")
            else:
                os.environ["BENCH_MODE"] = before
        check_bench_line(lines[mode], mode)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[12] benchmark.main({FPN_NAME}, b8): train {lines['train']['value']} images/s, MFU "
        f"{lines['train']['mfu']}, {lines['train']['flops_per_step'] / 8e9:.2f} GFLOP an image; "
        f"eval {lines['eval']['value']} images/s")
    return lines


PRESET_ROIS = 128  # sampled rois an image in training (roi_targets.n_sample)


def check_preset_kernels(torch, name, cfg, dev):
    """[13]'s kernel sites at one preset's training shapes, held against
    the plain versions as [3] holds them: the ROI op's forward and backward
    on a bfloat16 38x38 map of the trunk's channels (1024 for ResNet50, 512
    for VGG16), b x 128 rois; IoU matching at the anchor site (the preset's
    anchors x ``max_boxes`` gt columns, column argmax) and the proposal site
    (600 proposals + the gt); the proposal NMS b x 12000 -> 600."""
    from replication_faster_rcnn_tpu_torch.models.resnet import trunk_channels
    from replication_faster_rcnn_tpu_torch.models.vgg import VGG16_TRUNK_CHANNELS
    from replication_faster_rcnn_tpu_torch.ops.anchors import make_anchors

    b, g = cfg.train.batch_size, cfg.data.max_boxes
    channels = (VGG16_TRUNK_CHANNELS if cfg.model.backbone == "vgg16"
                else trunk_channels(cfg.model.backbone))
    shape = (b,) + FEAT[:2] + (channels,)
    rng = np.random.default_rng(20)
    bf16 = torch.bfloat16
    res = {}
    feat = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev).to(bf16)
    rois = torch.from_numpy(rand_boxes(rng, (b, PRESET_ROIS), 600, 300)
                            * (FEAT[0] / 600)).to(dev)
    tag = f"{name} bf16 {b}x{PRESET_ROIS} {list(shape[1:])}"
    grad = torch.from_numpy(rng.normal(0, 1, (b, PRESET_ROIS, 7, 7, channels))
                            .astype(np.float32)).to(dev).to(bf16)
    if cfg.model.roi_op == "align":
        res["roi_fwd"] = check_roi(torch, f"{tag} -> bf16", feat, rois, bf16)
        res["roi_bwd"] = check_roi_bwd(torch, f"bf16 grad {tag}", grad, rois, shape, bf16)
    else:
        res["roi_fwd"] = check_roi_pool(torch, tag, feat, rois)
        res["roi_bwd"] = check_roi_pool_bwd(torch, tag, grad, feat, rois)
    del feat, grad
    anchors = torch.from_numpy(make_anchors(cfg.anchors, FEAT[:2])).to(dev)[None]
    gt = torch.from_numpy(rand_boxes(rng, (b, g), 450, 300)).to(dev)
    counts = torch.from_numpy(rng.integers(0, g + 1, b)).to(dev)
    counts[0] = g  # one image with every gt slot real
    gmask = torch.arange(g, device=dev)[None, :] < counts[:, None]
    res["iou_anchor"] = check_iou(torch, f"{name} anchors {b}x{anchors.shape[1]}x{g} + column "
                                  "argmax", anchors, gt, gmask, True)
    cand = torch.cat([torch.from_numpy(rand_boxes(rng, (b, 600), 500, 250)).to(dev), gt], dim=1)
    res["iou_proposal"] = check_iou(torch, f"{name} proposals {b}x{600 + g}x{g}", cand, gt, gmask,
                                    False)
    boxes = torch.from_numpy(clustered_boxes(rng, b, 12000)).to(dev)
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (b, 12000)), axis=1)
                              .astype(np.float32)).to(dev)
    res["nms_train"] = check_nms(torch, f"{name} clustered {b}x12000->600 thr 0.7", boxes, scores,
                                 0.7, 600, mask=torch.isfinite(scores), assume_sorted=True)
    torch.cuda.empty_cache()
    return res


def phase_preset_train(torch, name, cfg=None, device=None):
    """Phase [13] for one preset: ``name`` trained at its own configuration
    (``cfg`` defaults to it: 600x600, bfloat16 compute, the preset's
    anchors, ``max_boxes`` and batch) on ``SyntheticDataset``, first the
    kernels at its shapes (:func:`check_preset_kernels`). Then a captured
    ``Trainer`` and, after it is freed, an eager one from the same seed,
    each ``2 + TRAIN_REPS`` steps on the same two staged batches
    (:func:`train_run`: the captured trainer's first call captures, then
    replays), the last ``TRAIN_REPS`` timed under sync debug "error" with the
    launch counters reset just before and read just after (per step NMS 1,
    IoU matching 2,
    the preset's ROI forward and backward 1); both runs bitwise equal in
    every step's metrics and in the parameters, BatchNorm statistics and
    optimizer state they end with. Each prints its step ms and images/s,
    the profiler's idle share over 3 more steps, the peak allocated memory
    and (captured) the graph pool: the reserved memory the capture keeps
    after ``empty_cache()``. Then one forward and backward replayed under
    ``ops.reference_scope()`` with the eager pass's draws (the VGG16 tail's
    dropout masks included): targets and losses bitwise, gradients within
    ``GRAD_RTOL``."""
    import dataclasses
    import gc

    from replication_faster_rcnn_tpu_torch import get_config, ops
    from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
    from replication_faster_rcnn_tpu_torch.train.train_step import (
        KEEP_MASK_NAMES, compute_losses)

    cfg = cfg or get_config(name)
    dev = torch.device(device or "cuda")
    bsz, op = cfg.train.batch_size, cfg.model.roi_op
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset="synthetic"))
    log(f"[13] main path: train {name} {cfg.data.image_size} batch {bsz} ({cfg.model.backbone}, "
        f"ROI op {op}, {cfg.model.num_classes} classes, "
        f"{len(cfg.anchors.ratios) * len(cfg.anchors.scales)} anchors, max_boxes "
        f"{cfg.data.max_boxes}), compute {cfg.model.compute_dtype}; captured, then eager")
    kernels = check_preset_kernels(torch, name, cfg, dev)
    names = ("nms", "iou_match") + ROI_NAMES
    want = {"nms": 1, "iou_match": 2, **roi_launches(op, 1, 1)}
    runs = {}
    for tag in ("captured", "eager"):
        runs[tag] = run = train_run(torch, cfg, dev, names, want, capture=tag == "captured",
                                    reps=TRAIN_REPS, timeline=True, keep=tag == "eager")
        idle = run["device_idle_share"]
        log(f"  {name} {tag}: {run['step_ms']:.2f} ms a step (median of {TRAIN_REPS}, CUDA events), "
            f"{run['images_per_s']:.1f} images/s, launches {run['launches']} in {TRAIN_REPS} steps, "
            f"idle share {'not measured' if idle is None else round(idle, 4)}, peak allocated "
            f"{run['peak_allocated_gib']:.2f} GiB, reserved kept after the first 2 steps "
            f"{run['reserved_after_first_steps_gib']:.3f} GiB, loss "
            f"{run['losses_first_last'][0]:.4f} -> {run['losses_first_last'][1]:.4f}")
    # the captured and the eager runs, bitwise
    same_runs(torch, runs["captured"], runs["eager"], f"{name}: captured vs eager")
    tr, batches = runs["eager"].pop("trainer"), runs["eager"].pop("batches")
    runs = {tag: summary_of(run) for tag, run in runs.items()}
    del run
    runs["captured"]["graph_pool_gib"] = runs["captured"]["reserved_after_first_steps_gib"]
    log(f"  {name}: {2 + TRAIN_REPS} captured steps bitwise the same steps eager (every "
        "metric, the parameters, BatchNorm statistics, mu, nu, count)")
    # one step's forward + backward on the eager trainer, kernels against
    # plain, the same draws
    model, state = tr.model, tr.state
    params = list(model.parameters())

    def pass_(reference, draws):
        model.zero_grad(set_to_none=True)
        record = {}
        with ops.reference_scope(reference):
            total, (metrics, _) = compute_losses(model, cfg, batches[1], state.generator, draws,
                                                 record)
            total.backward()
        grads = [None if p.grad is None else p.grad.detach().clone() for p in params]
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.pending_stats = None
        return metrics, record, grads

    km, krec, kgrads = pass_(False, None)
    masks = sorted(k for k in krec["draws"] if k in KEEP_MASK_NAMES)
    if (cfg.model.backbone == "vgg16") != bool(masks):
        raise AssertionError(f"{name}: dropout masks recorded {masks}")
    before = read_counters()
    pm, prec, pgrads = pass_(True, krec["draws"])
    if before != read_counters():
        raise AssertionError(f"{name}: a kernel launched inside reference_scope")
    for k, v in krec["targets"].items():
        if not torch.equal(v, prec["targets"][k]):
            raise AssertionError(f"{name}: target {k!r} differs between the kernel and plain "
                                 "passes")
    for k in ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss",
              "n_pos_rpn", "n_pos_head"):
        if not torch.equal(km[k], pm[k]):
            raise AssertionError(f"{name}: {k} differs: kernel {float(km[k])} plain "
                                 f"{float(pm[k])}")
    grad_err = 0.0
    for a, c in zip(kgrads, pgrads):
        if (a is None) != (c is None):
            raise AssertionError(f"{name}: a parameter has a gradient in one pass only")
        if a is not None:
            grad_err = max(grad_err, float((a.float() - c.float()).norm())
                           / max(float(c.float().norm()), 1e-30))
    if grad_err > GRAD_RTOL:
        raise AssertionError(f"{name}: gradients differ by relative L2 {grad_err} > {GRAD_RTOL}")
    model.zero_grad(set_to_none=True)
    log(f"  {name}: kernel pass == plain pass (same state and draws{', dropout masks ' + str(masks) if masks else ''}): targets and 4 "
        f"losses bitwise; gradients max relative L2 error {grad_err:.3e} (tolerance {GRAD_RTOL})")
    del tr, batches, model, state, params, kgrads, pgrads
    gc.collect()
    torch.cuda.empty_cache()
    out = {"config": name, "roi_op": op, "batch": bsz, "captured": runs["captured"],
           "eager": runs["eager"], "kernels": kernels, "grad_max_rel_l2_err_vs_plain": grad_err,
           "dropout_masks": masks}
    return ({"captured": runs["captured"]["launches"], "eager": runs["eager"]["launches"]}, out)


# ------------------------------------------ [14] backbones, model knobs, trace-summary

KNOB_BACKBONES = ("resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2")
KNOB_REPS = 4  # [14]'s timed steps a run (after 2 untimed ones, the first captures)
KNOB_PRESET = "coco_resnet50"  # [13]'s b32 ROIAlign configuration
TRACE_STEPS = 3  # eager steps in each trace-summary capture
TRACE_TOP = 15
TRACE_DIR = REPO / "build" / "chip_smoke_traces"


def backbone_config(backbone, size=None):
    """``voc_resnet50`` (600x600, b8, bfloat16, ROIPool on the 1024-channel
    C4 map) on another ResNet trunk and tail (``size`` shrinks the image
    for a CPU rehearsal)."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch import get_config

    cfg = get_config("voc_resnet50")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, backbone=backbone),
                      data=dataclasses.replace(cfg.data, dataset="synthetic"))
    if size is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=(size, size)))
    return cfg


def serve_backbone(torch, cfg, dev, reps=REPS):
    """One backbone served in bfloat16 through ``InferenceEngine`` graphs at
    its bucket, b1 and b8 (seeded weights): each graph's replay bitwise its
    eager flush and the plain replay, launches per replay (NMS 2, ROIPool
    1), then the b1 flush ms and b8 images/s over ``reps`` flushes."""
    import dataclasses

    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine

    size = cfg.data.image_size
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, resolutions=(size,), batch_sizes=(1, 8), params_dtype="bfloat16"))
    rng = np.random.default_rng(14)
    images = {size: [rng.integers(0, 256, size + (3,), dtype=np.uint8) for _ in range(8)]}
    want = {"nms": 2, **roi_launches(cfg.model.roi_op)}
    with InferenceEngine(cfg, device=dev, seed=0, warmup=True) as engine:
        per_replay = check_stack_graphs(torch, engine, images, want)
        engine.predict(images[size])  # the callers' paths warm
        engine.submit(images[size][0]).result(timeout=300)
        timings = timed_flushes(engine, images[size][0], images[size], reps)
        out = {"launches_per_replay": per_replay, "capture_seconds": dict(engine.compile_seconds),
               "params_bytes": engine.params_bytes, **timings}
    log(f"  [14] serve {cfg.model.backbone} {size} bfloat16: graphs b1, b8 bitwise their eager "
        f"flushes and the plain replays, per replay {per_replay}; b1 flush "
        f"{timings['b1_flush_ms']:.2f} ms, b8 {timings['b8_images_per_s']:.1f} images/s")
    return out


def phase_backbones(torch, device=None, size=None, reps=KNOB_REPS):
    """Phase [14] (a): ``resnext50_32x4d``, ``resnext101_32x8d``,
    ``wide_resnet50_2`` and ``wide_resnet101_2`` at full width and depth on
    ``voc_resnet50``'s configuration (:func:`backbone_config`): each one's
    kernels at its shapes (:func:`check_preset_kernels`), ``2 + reps``
    captured train steps and the same steps eager (:func:`train_run`, per
    step NMS 1, IoU matching 2, ROIPool forward 1 and backward 1), bitwise
    equal (:func:`same_runs`), and serving (:func:`serve_backbone`)."""
    dev = torch.device(device or "cuda")
    names = ("nms", "iou_match") + ROI_NAMES
    launches, out = {}, {}
    for backbone in KNOB_BACKBONES:
        cfg = backbone_config(backbone, size)
        name, op = f"voc_resnet50/{backbone}", cfg.model.roi_op
        log(f"[14] main path: train {name} {cfg.data.image_size} batch {cfg.train.batch_size}, "
            f"ROI op {op}, compute {cfg.model.compute_dtype}; captured, then eager")
        kernels = check_preset_kernels(torch, name, cfg, dev)
        want = {"nms": 1, "iou_match": 2, **roi_launches(op, 1, 1)}
        runs = {tag: train_run(torch, cfg, dev, names, want, capture=tag == "captured", reps=reps)
                for tag in ("captured", "eager")}
        same_runs(torch, runs["captured"], runs["eager"], f"{name}: captured vs eager")
        runs = {tag: summary_of(run) for tag, run in runs.items()}
        runs["captured"]["graph_pool_gib"] = runs["captured"]["reserved_after_first_steps_gib"]
        for tag, run in runs.items():
            log(f"  {name} {tag}: {run['step_ms']:.2f} ms a step (median of {reps}, CUDA "
                f"events), {run['images_per_s']:.1f} images/s, launches {run['launches']} in "
                f"{reps} steps, peak allocated {run['peak_allocated_gib']:.2f} GiB, reserved "
                f"kept after the first 2 steps {run['reserved_after_first_steps_gib']:.3f} GiB")
        log(f"  {name}: {2 + reps} captured steps bitwise the same steps eager (every metric, "
            "the parameters, BatchNorm statistics, mu, nu, count)")
        launches[f"train_{backbone}"] = runs["captured"]["launches"]
        launches[f"train_{backbone}_eager"] = runs["eager"]["launches"]
        out[backbone] = {"config": name, "backbone": backbone, "roi_op": op,
                         "batch": cfg.train.batch_size, **runs, "kernels": kernels,
                         "serve": serve_backbone(torch, cfg, dev)}
    return launches, out


def train_run(torch, cfg, dev, names, want, capture=True, reps=KNOB_REPS, timeline=False,
              profile=None, keep=False):
    """``2 + reps`` steps of a seeded ``Trainer`` of ``cfg`` on two staged
    synthetic batches (captured: the first call captures, then replays; or
    eager), the last ``reps`` timed under sync debug "error" with the
    launch counters reset just before and read just after (``want`` a
    step). ``timeline``: 3 more steps under :func:`device_timeline` (the
    same launches a step); ``profile`` (a directory): ``TRACE_STEPS`` more
    steps under ``utils/profiling.py::trace``, after one warm-up step kept
    out of the capture. Returns the step ms, images/s, launches, the peak
    allocated GiB and the reserved GiB the first 2 steps keep (a captured
    run's graph pool), both above the start, the idle share, and on the
    host every step's metrics, the model's and the optimizer's state and
    the running statistics before the first step; ``keep`` adds the
    trainer and its staged batches (freed otherwise)."""
    import gc

    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.train.train_step import make_train_step
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer
    from replication_faster_rcnn_tpu_torch.utils.profiling import trace

    bsz, gib = cfg.train.batch_size, 2**-30
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    allocated0 = torch.cuda.memory_allocated(dev)
    tr = Trainer(cfg, SyntheticDataset(cfg.data, length=2 * bsz), device=dev, seed=0)
    if not capture:
        tr.step_fn = make_train_step(cfg, capture=False)
    tr.loader.set_epoch(0)
    batches = [tr.stage_batch(b) for b in tr.loader]
    running0 = {k: v.detach().to("cpu", copy=True) for k, v in tr.model.state_dict().items()
                if "running" in k}
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    REPLAYS.reset(names)
    rows = [tr.train_one_batch(staged=batches[i]) for i in range(2)]
    first = REPLAYS.read(names)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved(dev) - reserved0
    if first != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"first 2 steps launched {first}, expected {want} a step")
    REPLAYS.reset(names)

    def step(i):
        torch.cuda.set_sync_debug_mode("error")
        try:
            rows.append(tr.train_one_batch(staged=batches[i % 2]))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    ms = timed_steps(torch, step, reps)
    launches = REPLAYS.read(names)
    if launches != {k: v * reps for k, v in want.items()}:
        raise AssertionError(f"expected per step {want}, got {launches} over {reps} steps")
    host = [{k: float(v) for k, v in m.items()} for m in rows]
    bad = [i for i, r in enumerate(host) if r["skipped"] != 0.0 or not all(
        np.isfinite(r[k]) for k in ("loss", "head_cls_loss", "head_reg_loss", "grad_norm"))]
    if bad:
        raise AssertionError(f"non-finite or withheld steps {bad}: {host[bad[0]]}")
    med = statistics.median(ms)
    out = {"step_ms": med, "step_ms_all": ms, "images_per_s": bsz / med * 1e3,
           "launches": launches,
           "peak_allocated_gib": (torch.cuda.max_memory_allocated(dev) - allocated0) * gib,
           "reserved_after_first_steps_gib": pool * gib,
           "losses_first_last": [host[0]["loss"], host[-1]["loss"]],
           "rows": [{k: v.cpu() for k, v in m.items()} for m in rows],
           "state": {k: v.detach().to("cpu", copy=True)
                     for k, v in tr.model.state_dict().items()},
           "optimizer": {k: v.to("cpu", copy=True)
                         for k, v in tr.state.optimizer.state_dict().items()},
           "running_before": running0, "device_timeline": None, "device_idle_share": None}
    if timeline:
        REPLAYS.reset(names)
        out["device_timeline"] = device_timeline(
            torch, lambda: [tr.train_one_batch(staged=batches[i % 2]) for i in range(3)], 3,
            cfg.model.roi_op)
        profiled = REPLAYS.read(names)
        if profiled != {k: v * 3 for k, v in want.items()}:
            raise AssertionError(f"expected per step {want}, got {profiled} over the 3 "
                                 "profiled steps")
        if out["device_timeline"] is not None:
            out["device_idle_share"] = out["device_timeline"]["device_idle_share"]
    if profile is not None:
        fresh_dir(Path(profile))
        with trace(str(profile), warmup_steps=1) as prof_step:
            for i in range(1 + TRACE_STEPS):
                tr.train_one_batch(staged=batches[i % 2])
                torch.cuda.synchronize(dev)
                prof_step()
    if keep:
        out["trainer"], out["batches"] = tr, batches
    del tr, batches, rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


def same_runs(torch, got, want, what):
    """Two :func:`train_run` results bitwise: every step's metrics, the
    parameters and buffers, the optimizer's state."""
    mdiff = metrics_differences(torch, got["rows"], want["rows"])
    sdiff = [k for k in want["state"] if not bitwise(torch, got["state"][k], want["state"][k])]
    odiff = [k for k in want["optimizer"]
             if not bitwise(torch, got["optimizer"][k], want["optimizer"][k])]
    if mdiff or sdiff or odiff or set(got["state"]) != set(want["state"]):
        raise AssertionError(f"{what}: differ in metrics {mdiff[:5]}, state {sdiff[:5]}, "
                             f"optimizer {odiff[:5]}")


def summary_of(run):
    """A :func:`train_run` result's numbers (no tensors)."""
    return {k: v for k, v in run.items() if k not in ("rows", "state", "optimizer",
                                                      "running_before", "trainer", "batches")}


def with_model(cfg, **model):
    import dataclasses

    return cfg.replace(model=dataclasses.replace(cfg.model, **model))


def trace_summary(torch, trace_dir, tag, dev):
    """``python -m replication_faster_rcnn_tpu_torch trace-summary`` over
    one capture as a subprocess, every row into ``build/`` as JSON: prints
    the top kernels and launching operators. Of the kernels that are not a
    graph replay, those launched outside any ``cpu_op`` (the row
    ``NO_OPERATOR``) hold under 1% of the ms, and the named operators' ms
    sum to the kernels' ms within 1%."""
    from replication_faster_rcnn_tpu_torch.utils.profiling import (
        GRAPH_REPLAY_OPERATOR, NO_OPERATOR, format_table)

    path = REPO / "build" / f"trace_summary_{tag}.json"
    proc = subprocess.run([sys.executable, "-m", "replication_faster_rcnn_tpu_torch",
                           "trace-summary", str(trace_dir), "--top", "1000000", "--json",
                           str(path)], cwd=str(REPO), capture_output=True, text=True,
                          timeout=SERVE_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"trace-summary {tag} exited {proc.returncode}: {proc.stderr}")
    tables = json.loads(path.read_text())
    kernels = [r for r in tables["ops"] if not r.get("graph_replay")]
    operators = [r for r in tables["operators"]
                 if r["op"] not in (GRAPH_REPLAY_OPERATOR, NO_OPERATOR)]
    if not kernels or not operators:
        raise AssertionError(f"trace-summary {tag}: no eager kernels ({len(kernels)}) or "
                             f"operators ({len(operators)}) in the capture")
    k_ms = sum(r["total_ms"] for r in kernels)
    o_ms = sum(r["total_ms"] for r in operators)
    none_ms = sum(r["total_ms"] for r in tables["operators"] if r["op"] == NO_OPERATOR)
    if none_ms > 0.01 * k_ms:
        raise AssertionError(f"trace-summary {tag}: {none_ms} of {k_ms} kernel ms launched "
                             "outside any cpu_op")
    if abs(o_ms - k_ms) > 0.01 * k_ms:
        raise AssertionError(f"trace-summary {tag}: named operators sum to {o_ms} ms, kernels "
                             f"to {k_ms} ms")
    log(f"  [14] trace-summary {tag} ({TRACE_STEPS} eager steps; {path.relative_to(REPO)}): "
        f"kernels {k_ms:.3f} ms, named operators {o_ms:.3f} ms, outside any cpu_op "
        f"{none_ms:.3f} ms ({len(kernels)} kernel names, {len(operators)} operators)")
    log("  top kernels:\n" + format_table(tables["ops"][:TRACE_TOP]))
    log("  top launching operators:\n" + format_table(tables["operators"][:TRACE_TOP]))
    return {"json": str(path.relative_to(REPO)), "kernels_ms": k_ms, "operators_ms": o_ms,
            "outside_any_cpu_op_ms": none_ms,
            "kernels_ms_per_step": k_ms / TRACE_STEPS,
            "top_kernels": tables["ops"][:TRACE_TOP],
            "top_operators": tables["operators"][:TRACE_TOP]}


def phase_knobs(torch, preset_train=None, device=None, cfgs=None, reps=KNOB_REPS):
    """Phase [14] (b) and (c). ``coco_resnet50`` b32 (:data:`KNOB_PRESET`,
    [13]'s configuration): ``remat`` captured steps bitwise the same steps
    without it (metrics, parameters, statistics, optimizer) with both peaks
    beside [13]'s (``preset_train``); ``frozen_bn`` captured, the running
    statistics bitwise what they were; ``norm="group"`` captured bitwise
    eager. ``remat`` on ``voc_resnet50_fpn`` b8 and ``coco_vgg16`` b8 bitwise
    their steps without it, with peaks. Then (c): ``TRACE_STEPS`` eager
    steps of ``coco_resnet50`` b32 with BatchNorm, frozen BatchNorm and
    GroupNorm each profiled and read by ``trace-summary``
    (:func:`trace_summary`). ``cfgs`` maps the three configurations' names
    to smaller ones for a CPU rehearsal."""
    from replication_faster_rcnn_tpu_torch import get_config

    dev = torch.device(device or "cuda")
    cfgs = cfgs or {}
    cfg_of = lambda name: cfgs.get(name) or (fpn_config() if name == FPN_NAME  # noqa: E731
                                             else get_config(name))
    names = ("nms", "iou_match") + ROI_NAMES
    out, launches = {}, {}

    def want_of(cfg):
        if cfg.model.fpn:
            return dict(FPN_TRAIN_WANT)
        return {"nms": 1, "iou_match": 2, **roi_launches(cfg.model.roi_op, 1, 1)}

    def run(cfg, tag, **kw):
        w = want_of(cfg)
        r = train_run(torch, cfg, dev, tuple(w) if cfg.model.fpn else names, w, reps=reps, **kw)
        log(f"  [14] {tag}: {r['step_ms']:.2f} ms a step (median of {reps}, CUDA events), "
            f"{r['images_per_s']:.1f} images/s, peak allocated {r['peak_allocated_gib']:.2f} "
            f"GiB, launches {r['launches']}")
        launches[f"train_{tag.replace(' ', '_')}"] = r["launches"]
        return r

    coco = cfg_of(KNOB_PRESET)
    log(f"[14] main path: the model knobs on {KNOB_PRESET} {coco.data.image_size} batch "
        f"{coco.train.batch_size} (remat, frozen_bn, norm='group'), remat on {FPN_NAME} and "
        "coco_vgg16 b8; then trace-summary over eager steps")
    base = run(coco, f"{KNOB_PRESET} captured")
    remat = run(with_model(coco, remat=True), f"{KNOB_PRESET} remat captured")
    same_runs(torch, remat, base, f"{KNOB_PRESET} remat vs not")
    peak13 = None
    if preset_train and KNOB_PRESET in preset_train:
        peak13 = preset_train[KNOB_PRESET]["captured"]["peak_allocated_gib"]
    log(f"  [14] {KNOB_PRESET} remat: {2 + reps} captured steps bitwise the same steps without "
        f"remat; peak allocated {remat['peak_allocated_gib']:.2f} GiB against "
        f"{base['peak_allocated_gib']:.2f} without ([13]'s captured run: "
        f"{'n/a' if peak13 is None else f'{peak13:.2f}'} GiB)")
    out["remat"] = {"remat": summary_of(remat), "plain": summary_of(base),
                    "peak_allocated_gib_13": peak13}
    del base, remat

    frozen = run(with_model(coco, frozen_bn=True), f"{KNOB_PRESET} frozen_bn captured")
    moved = [k for k, v in frozen["running_before"].items()
             if not bitwise(torch, frozen["state"][k], v)]
    if not frozen["running_before"] or moved:
        raise AssertionError(f"frozen_bn: running statistics moved: {moved[:5]}")
    log(f"  [14] {KNOB_PRESET} frozen_bn: {len(frozen['running_before'])} running statistics "
        f"bitwise unchanged after {2 + reps} steps")
    out["frozen_bn"] = summary_of(frozen)
    del frozen

    group_cfg = with_model(coco, norm="group")
    group = run(group_cfg, f"{KNOB_PRESET} group captured")
    group_eager = run(group_cfg, f"{KNOB_PRESET} group eager", capture=False,
                      profile=TRACE_DIR / "group")
    same_runs(torch, group, group_eager, f"{KNOB_PRESET} group captured vs eager")
    if group["running_before"]:
        raise AssertionError("a GroupNorm model holds running statistics")
    log(f"  [14] {KNOB_PRESET} norm='group': {2 + reps} captured steps bitwise the same steps "
        "eager")
    out["group"] = {"captured": summary_of(group), "eager": summary_of(group_eager)}
    del group, group_eager

    for name in (FPN_NAME, "coco_vgg16"):
        cfg = cfg_of(name)
        plain = run(cfg, f"{name} captured")
        rem = run(with_model(cfg, remat=True), f"{name} remat captured")
        same_runs(torch, rem, plain, f"{name} remat vs not")
        log(f"  [14] {name} remat: {2 + reps} captured steps bitwise the same steps without; "
            f"peak allocated {rem['peak_allocated_gib']:.2f} GiB against "
            f"{plain['peak_allocated_gib']:.2f}")
        out[f"remat_{name}"] = {"remat": summary_of(rem), "plain": summary_of(plain)}
        del plain, rem

    # (c) eager steps profiled, read back by the command line
    for tag, cfg in (("batch", coco), ("frozen_bn", with_model(coco, frozen_bn=True))):
        r = run(cfg, f"{KNOB_PRESET} {tag} eager", capture=False, profile=TRACE_DIR / tag)
        out.setdefault("eager", {})[tag] = summary_of(r)
        del r
    out["trace_summary"] = {tag: trace_summary(torch, TRACE_DIR / tag, tag, dev)
                            for tag in ("batch", "frozen_bn", "group")}
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    return launches, out


def image_kernel_rows(image, by_path):
    """The ``kernels`` line's rows of the data path's five kernels: [3]'s
    times at 600x600 b8 uint8 (all four row mixes' main one: flip,
    translation and scale), the other shapes beside them, and [10]'s
    launches (the geometry alone and the fills alone are off [10]'s path:
    its steps take the prepare launch)."""
    timing = ("ms", "plain_ms", "bound_ms", "bound_by")
    main = "b8_uint8_flip+translate+scale"
    sum_note = ("torch.sum(images, dim=(1, 2), dtype=int64 / float64): the first fill's sum "
                "alone, no window sum, no geometry")
    rows = []
    for name, part, parity, library_note in (
            ("augment_prepare", "prepare",
             "vs ops/image.py::augment_prepare_plain: geometry, boxes, labels and masks "
             "bitwise (and vs data/augment.py::device_decisions), uint8 fills bitwise, float32 "
             "fills within 1 ulp and bitwise across launches, graph replays and the fills alone",
             sum_note),
            ("augment_geometry", "geometry",
             "bitwise vs ops/image.py::augment_geometry_plain (boxes, labels, masks, geometry "
             "rows) and vs the numpy oracle data/augment.py::device_decisions",
             "torch core has no op for these steps"),
            ("image_fill", "fill",
             "vs ops/image.py::image_fills_plain: uint8 bitwise (exact integer sums), float32 "
             "within 1 ulp (float64 sums in another order)", sum_note),
            ("augment_image", "image",
             "vs ops/image.py::augment_images_plain and the plain cache gather: uint8 bitwise, "
             "float32 within 1e-6 of the largest magnitude (the fills' last bit)",
             "torch core has no op for these steps")):
        err_key = "fill_max_abs_err" if part in ("fill", "prepare") else "max_abs_err"
        sites = {k: {f: v[part][f] for f in timing} for k, v in image.items()
                 if isinstance(v, dict) and isinstance(v.get(part), dict) and k != main}
        if part == "image":
            sites.update({k: {f: image[k][f] for f in timing + ("library_ms", "materialize_ms")
                              if f in image[k]}
                          for k in image if k.startswith(("cache_", "allflip_", "gather_"))})
        rows.append({
            "name": name, "route": "cuda", "source": IMAGE_SRC, "replaces": IMAGE_JAX[name],
            "replaces_note": IMAGE_NOTE,
            "launches": sum(by_path(name).values()), "launches_by_path": by_path(name),
            "parity": parity,
            "max_abs_err": max(v.get(err_key, 0.0) for k, v in image.items()
                               if isinstance(v, dict) and not k.startswith("resize")),
            **{f: image[main][part][f] for f in timing},
            "library_ms": image[main][part].get("library_ms"), "library_note": library_note,
            "shape": "600x600 uint8 b8, flip + translate 0.1 + scale 0.75-1.25 (aug draws)",
            "sites": sites,
        })
    rk = "resize_b8_uint8_480"
    rows.append({
        "name": "resize_aa", "route": "cuda", "source": IMAGE_SRC, "replaces": IMAGE_JAX["resize_aa"],
        "replaces_note": IMAGE_NOTE + "; jax.image.resize(method='bilinear', antialias=True)",
        "launches": sum(by_path("resize_aa").values()), "launches_by_path": by_path("resize_aa"),
        "parity": "bitwise vs the plain band passes (ops/image.py::resize_batch_with_boxes, taps "
                  "in order); the library call's agreement in library_within_tolerance",
        "max_abs_err": 0.0, **{f: image[rk][f] for f in timing + ("library_ms",)},
        "library_note": "torch.nn.functional.interpolate(mode='bilinear', antialias=True, "
                        "align_corners=False) on NCHW float32",
        "shape": "600x600 uint8 b8 -> 480x480 (one launch: both band passes, boxes scaled)",
        "sites": {k: {f: v[f] for f in timing + ("library_ms", "library_within_tolerance",
                                                 "library_max_abs_err")}
                  for k, v in image.items() if k.startswith("resize")},
    })
    return rows


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

    REPLAYS.install()
    walls = {}

    def timed_phase(tag, fn, *args, **kwargs):
        """Run one phase and print its wall time."""
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        walls[tag] = round(time.perf_counter() - t, 1)
        log(f"  ({tag} wall {walls[tag]} s, {time.perf_counter() - t_start:.1f} s since start)")
        return result

    t_start = t0
    walls["[1]-[2] build"] = round(time.perf_counter() - t0, 1)
    res = timed_phase("[3] kernels", phase_kernels, torch)
    graph_replays = timed_phase("[3] graph replays", check_graph_replays, torch,
                                torch.device("cuda"))
    image = timed_phase("[3] image kernels", check_image_kernels, torch, torch.device("cuda"))
    launches, serve = timed_phase("[4] serve align", phase_serve, torch)
    plaunches, serve_pool = timed_phase("[4] serve pool", phase_serve, torch, "voc_resnet18")
    slaunches, presets = timed_phase("[4] presets", phase_presets, torch)
    qlaunches, serve_int8 = timed_phase("[5] int8 align", phase_int8_serve, torch, serve)
    iplaunches, int8_presets = timed_phase("[5] int8 presets", phase_int8_presets, torch)
    tlaunches, tlaunches_eager, train = timed_phase("[6] train align", phase_train, torch)
    ptlaunches, ptlaunches_eager, train_pool = timed_phase("[6] train pool", phase_train, torch,
                                                           "voc_resnet18")
    elaunches, evaluate = timed_phase("[7] evaluate", phase_evaluate, torch)
    celaunches, evaluate["cached"] = timed_phase("[7] cached evaluate", phase_cached_evaluate,
                                                 torch)
    olaunches, overfit = timed_phase("[7] overfit", phase_overfit, torch)
    evaluate["overfit"] = overfit
    rlaunches, resume = timed_phase("[8] resume", phase_resume, torch)
    blaunches, bench = timed_phase("[9] bench", phase_bench, torch)
    dlaunches, data_path = timed_phase("[10] data path", phase_data_path, torch)
    klaunches, stack = timed_phase("[11] serving stack", phase_serving_stack, torch,
                                   int8_artifact=REPO / "build" / "quant_artifact.json")
    flaunches, fpn_serve = timed_phase("[12] FPN serve", phase_fpn_serve, torch)
    fqlaunches, fpn_int8 = timed_phase("[12] FPN int8", phase_fpn_int8, torch, fpn_serve)
    ftlaunches, ftlaunches_eager, fpn_train = timed_phase("[12] FPN train", phase_fpn_train,
                                                          torch)
    fpn_bench = timed_phase("[12] FPN bench", phase_fpn_bench, torch)
    preset_launches, preset_train = {}, {}
    for preset in NEW_PRESETS:
        got, preset_train[preset] = timed_phase(f"[13] train {preset}", phase_preset_train,
                                                torch, preset)
        preset_launches[f"train_{preset}"] = got["captured"]
        preset_launches[f"train_{preset}_eager"] = got["eager"]
    backbone_launches, backbones = timed_phase("[14] backbones", phase_backbones, torch)
    knob_launches, knobs = timed_phase("[14] knobs and trace-summary", phase_knobs, torch,
                                       preset_train)
    log(f"phase walls (s): {json.dumps(walls)}")
    paths = {"serve": launches, "serve_pool": plaunches, "serve_presets": slaunches,
             "serve_int8": qlaunches, "serve_int8_presets": iplaunches, "train": tlaunches,
             "train_eager": tlaunches_eager,
             "train_pool": ptlaunches, "train_pool_eager": ptlaunches_eager,
             "evaluate": elaunches, "overfit_train": olaunches, **rlaunches, **blaunches,
             **dlaunches, "serve_stack": klaunches, "serve_fpn": flaunches,
             "serve_int8_fpn": fqlaunches,
             "train_fpn": ftlaunches, "train_fpn_eager": ftlaunches_eager, **celaunches,
             **preset_launches, **backbone_launches, **knob_launches}

    def by_path(key):
        """A counter's launches on every main path that reads it."""
        return {path: counts[key] for path, counts in paths.items() if key in counts}

    nms, det, roi = res["nms_proposal"], res["nms_detection"], res["roi_bf16"]
    nms_tr, nms_cl, bwd = res["nms_train"], res["nms_train_clustered"], res["roi_bwd_bf16"]
    # the kernels' device ms per step in the profiled captured steps (as users
    # run them), the eager steps' beside them
    def in_step(run, key, part=None):
        timeline = run["device_timeline"] or {}
        value = timeline.get(key)
        return value if part is None or value is None else value[part]

    def step_ms(run, key, part=None):
        return {"train_step_device_ms": in_step(train_runs[run]["captured"], key, part),
                "train_step_device_ms_eager": in_step(train_runs[run]["eager"], key, part)}

    train_runs = {"align": train, "pool": train_pool, "multilevel": fpn_train}
    iou_a, iou_p = res["iou_anchor"], res["iou_proposal"]
    ml = res["multilevel"]
    ml_f, ml_b = ml["serve_b8_bf16"], ml["bwd_bf16"]
    gemm, deq = res["gemm_b8_cls"], res["dequant_f32"]
    timing = ("ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        {
            "name": "nms_mask_walk", "route": "cuda", "source": NMS_SRC, "replaces": NMS_TPU,
            "kernels": list(NMS_KERNELS),
            "note": "one call = the card-wide IoU bitmask kernel + the per-image greedy walk; "
                    "ms, launches and bound cover both",
            "launches": sum(by_path("nms").values()),
            "launches_by_path": by_path("nms"),
            "parity": "bitwise vs nms_fixed_tiled (proposal, detection, TTA detection, "
                      "clustered, training, clustered training)",
            "max_abs_err": max(r["max_abs_err"] for k, r in res.items() if k.startswith("nms")),
            "ms": nms["ms"], "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
            "bound_by": nms["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": "proposal: 8 x 3000 sorted -> 300, thr 0.7",
            "detection_site": {k: det[k] for k in timing},
            "tta_detection_site": {k: res["nms_detection_tta"][k] for k in timing},
            "training_site": {k: nms_tr[k] for k in timing},
            "training_site_clustered": {k: nms_cl[k] for k in timing},
            "fpn_training_site": {k: res["nms_train_fpn"][k] for k in timing},
            "fpn_serving_site": {k: res["nms_fpn"][k] for k in timing},
            "outside_kernels_ms": {"proposal": nms["prep_ms"], "detection": det["prep_ms"],
                                   "tta_detection": res["nms_detection_tta"]["prep_ms"],
                                   "training": nms_tr["prep_ms"],
                                   "training_clustered": nms_cl["prep_ms"]},
            **step_ms("align", "nms_device_ms_per_step"),
        },
        {
            "name": "roi_align_fwd", "route": "cuda", "source": ROI_SRC, "replaces": ROI_TPU,
            "launches": sum(by_path("roi_align").values()),
            "launches_by_path": by_path("roi_align"),
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
            **step_ms("align", "roi_device_ms_per_step", "forward"),
        },
        {
            "name": "roi_align_bwd", "route": "cuda", "source": ROI_SRC, "replaces": ROI_BWD_TPU,
            "replaces_note": ROI_BWD_NOTE,
            "launches": sum(by_path("roi_align_bwd").values()),
            "launches_by_path": by_path("roi_align_bwd"),
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
            **step_ms("align", "roi_device_ms_per_step", "backward"),
        },
        {
            "name": "multilevel_roi_align_fwd", "route": "cuda", "source": ML_SRC,
            "replaces": ML_JAX, "replaces_note": ML_NOTE,
            "kernels": list(ROI_KERNELS["multilevel"]["forward"]),
            "launches": sum(by_path("roi_multilevel").values()),
            "launches_by_path": by_path("roi_multilevel"),
            "parity": "bitwise vs models/fpn.py::multilevel_roi_align_plain (the JAX "
                      "method='flat' operation by operation) cast to the output dtype, at "
                      "serving 8 x 300 and 1 x 300 (bf16 and f32), training 8 x 128, "
                      "boundary-area and clustered rois",
            "max_abs_err": max(r["max_abs_err"] for k, r in ml.items()
                               if not k.startswith("bwd")),
            **{k: ml_f[k] for k in timing}, "library_ms": None, "library_note": NO_ML_LIBRARY,
            "shape": "bf16 P2-P5 8 x [150, 75, 38, 19]^2 x 256, 300 rois -> bf16",
            "levels_ms": ml_f["levels_ms"],
            "levels_note": "roi_levels (plain tensor operations) runs before the kernel in "
                           "each call; ms excludes it",
            "levels_card_vs_cpu": res["multilevel_levels"],
            "sites": {k: {f: v[f] for f in timing + ("levels_ms", "rois_per_level")}
                      for k, v in ml.items() if not k.startswith("bwd") and k != "serve_b8_bf16"},
            **step_ms("multilevel", "roi_device_ms_per_step", "forward"),
        },
        {
            "name": "multilevel_roi_align_bwd", "route": "cuda", "source": ML_SRC,
            "replaces": ML_JAX, "replaces_note": ML_NOTE + " (the VJP: its scatter)",
            "kernels": list(ROI_KERNELS["multilevel"]["backward"]),
            "note": "one call = a memset of the tile masks, the per-roi geometry kernel and "
                    "the tile kernel; ms and launches cover all three",
            "launches": sum(by_path("roi_multilevel_bwd").values()),
            "launches_by_path": by_path("roi_multilevel_bwd"),
            "parity": f"vs the plain VJP (autograd of multilevel_roi_align_plain on float32 "
                      f"copies): {ROI_BWD_TOL}; two launches bitwise equal (deterministic, no "
                      "atomics)",
            "max_abs_err": max(r["max_abs_err"] for k, r in ml.items() if k.startswith("bwd")),
            **{k: ml_b[k] for k in timing}, "library_ms": None, "library_note": NO_ML_LIBRARY,
            "shape": "bf16 grad [8, 128, 7, 7, 256] -> bf16 grads of P2-P5 at 600x600",
            "sites": {k: {f: v[f] for f in timing} for k, v in ml.items()
                      if k.startswith("bwd") and k != "bwd_bf16"},
            **step_ms("multilevel", "roi_device_ms_per_step", "backward"),
        },
        {
            "name": "roi_pool_fwd", "route": "cuda", "source": POOL_SRC, "replaces": POOL_JAX,
            "replaces_note": POOL_NOTE,
            "launches": sum(by_path("roi_pool").values()),
            "launches_by_path": by_path("roi_pool"),
            "parity": "bitwise vs roi_ops.roi_pool (the masked maxes) at serving 8 x 300 and "
                      "1 x 300 and training 8 x 128 (random and clustered rois), float32 and "
                      "bfloat16, integer-valued features (ties), NaN and +-inf in the map",
            "max_abs_err": 0.0,
            **{k: res["pool_bf16"][k] for k in timing},
            "library_ms": None, "library_note": NO_POOL_LIBRARY,
            "shape": "bf16 feat 8 x [38, 38, 256], 300 rois, 7x7 -> bf16",
            "f32": {k: res["pool_f32"][k] for k in timing},
            "b1_bf16": {k: res["pool_b1_bf16"][k] for k in timing},
            "train_bf16": {k: res["pool_train_bf16"][k] for k in timing},
            "ties_bf16": {k: res["pool_ties_bf16"][k] for k in timing},
            "clustered_bf16": {k: res["pool_clustered_bf16"][k] for k in timing},
            **step_ms("pool", "roi_device_ms_per_step", "forward"),
        },
        {
            "name": "roi_pool_bwd", "route": "cuda", "source": POOL_SRC, "replaces": POOL_JAX,
            "replaces_note": POOL_NOTE + "; the backward replaces the VJP of those maxes",
            "kernels": list(ROI_KERNELS["pool"]["backward"]),
            "note": "one call = the bins pass + the gather pass; ms, launches and bound cover both",
            "launches": sum(by_path("roi_pool_bwd").values()),
            "launches_by_path": by_path("roi_pool_bwd"),
            "parity": f"vs roi_ops.roi_pool_backward (the plain VJP on float32 copies): "
                      f"{ROI_POOL_BWD} where the plain gradient is finite; two launches bitwise "
                      "equal (deterministic, no atomics); ties split evenly as the JAX VJP does",
            "max_abs_err": max(r["max_abs_err"] for k, r in res.items()
                               if k.startswith("pool_bwd")),
            **{k: res["pool_bwd_bf16"][k] for k in timing},
            "library_ms": None, "library_note": NO_POOL_LIBRARY,
            "shape": "bf16 grad [8, 128, 7, 7, 256] -> bf16 grad_feat 8 x [38, 38, 256]",
            "f32": {k: res["pool_bwd_f32"][k] for k in timing},
            "ties_bf16": {k: res["pool_bwd_ties_bf16"][k] for k in timing},
            "identical_rois": {k: res["pool_bwd_identical"][k] for k in timing},
            "clustered_bf16": {k: res["pool_bwd_clustered"][k] for k in timing},
            "scratch_bytes_per_call": res["pool_bwd_bf16"]["scratch_bytes"],
            **step_ms("pool", "roi_device_ms_per_step", "backward"),
        },
        {
            "name": "iou_match", "route": "cuda", "source": IOU_SRC, "replaces": IOU_TPU,
            "launches": sum(by_path("iou_match").values()),
            "launches_by_path": by_path("iou_match"),
            "parity": "bitwise vs ops/iou_match.py::match_boxes (iou, argmax, max, column "
                      "argmax) at G = 32 and 64 and with exact ties; two launches bitwise "
                      "equal; one launch per call",
            "max_abs_err": 0.0,
            "ms": iou_a["ms"], "plain_ms": iou_a["plain_ms"], "bound_ms": iou_a["bound_ms"],
            "bound_by": iou_a["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": "anchor site: 12996 anchors vs 8 x 32 gt, with the column argmax",
            "proposal_site": {k: iou_p[k] for k in timing},
            "fpn_anchor_site": {k: res["iou_anchor_fpn"][k] for k in timing},
            "anchor_site_g64": {k: res["iou_anchor_g64"][k] for k in timing},
            "ties": {k: res["iou_ties"][k] for k in timing},
            **step_ms("align", "iou_match_device_ms_per_step"),
        },
        {
            "name": "int8_matmul", "route": "cuda", "source": QUANT_SRC, "replaces": GEMM_TPU,
            "launches": sum(by_path("int8_matmul").values()),
            "launches_by_path": by_path("int8_matmul"),
            "parity": "bitwise vs ops/quant_ops.py::int8_matmul_plain (exact float64 product) "
                      "at every int8 preset's b1 and b8 cls/reg shapes (K 512 to 4096, N up to "
                      "324)",
            "max_abs_err": 0.0,
            **{k: gemm[k] for k in timing + ("library_ms",)},
            "library_note": "torch._int_mm with the weight padded to N a multiple of 8 (it "
                            "needs one); the padding is outside the timed call",
            "shape": "b8 cls: [2400, 512] x [512, 21] int8 -> int32",
            "sites": {k: {f: res[k][f] for f in timing + ("library_ms",)}
                      for k in res if "gemm_" in k and k != "gemm_b8_cls"},
        },
        {
            "name": "dequantize", "route": "cuda", "source": QUANT_SRC, "replaces": DEQUANT_TPU,
            "launches": sum(by_path("dequantize").values()),
            "launches_by_path": by_path("dequantize"),
            "parity": "bitwise vs ops/quant_ops.py::dequantize_plain on all 23 conv weights, "
                      "float32 and bfloat16 outputs, through dequantize_cuda and through "
                      "dequantize_many (one launch per call); dequantize_many also over one "
                      "flush's weights of voc_resnet50_fpn, voc_resnet50 and coco_vgg16",
            "max_abs_err": 0.0,
            **{k: deq[k] for k in timing + ("library_ms",)},
            "library_note": "torch.mul(w_q, scale) (int8 x float32 promotes to float32)",
            "shape": "layer4 conv [512, 512, 3, 3] int8 -> float32 (the Pallas kernel's output)",
            "main_path_bfloat16": {k: res["dequant_bf16"][k] for k in timing},
            "per_flush_bfloat16": res["dequant_flush"],
            "per_flush_bfloat16_by_preset": {k.split(" ", 1)[1]: v for k, v in res.items()
                                             if k.startswith("dequant_flush ")},
            "note": "the int8 flush runs the grouped launch (dequantize_many_kernel, 1 per "
                    "flush); per_leaf_kernels_ms is the same flush as one dequantize_cuda "
                    "call per weight",
        },
    ]
    # [13]'s sites: each preset's training shapes, and its steps' device ms;
    # [14]'s backbones beside them
    site_keys = {"nms_mask_walk": ("nms_train", "nms_device_ms_per_step", None),
                 "roi_align_fwd": ("roi_fwd", "roi_device_ms_per_step", "forward"),
                 "roi_align_bwd": ("roi_bwd", "roi_device_ms_per_step", "backward"),
                 "roi_pool_fwd": ("roi_fwd", "roi_device_ms_per_step", "forward"),
                 "roi_pool_bwd": ("roi_bwd", "roi_device_ms_per_step", "backward"),
                 "iou_match": ("iou_anchor", "iou_match_device_ms_per_step", None)}
    for row in kernels:
        if row["name"] not in site_keys:
            continue
        key, step_key, part = site_keys[row["name"]]
        sites = {}
        for preset, rec in {**preset_train, **{r["config"]: r for r in backbones.values()}}.items():
            op = rec["roi_op"]
            if row["name"].startswith("roi_") and not row["name"].startswith(f"roi_{op}"):
                continue
            site = {k: rec["kernels"][key][k] for k in timing}
            if row["name"] == "iou_match":
                site["proposal_site"] = {k: rec["kernels"]["iou_proposal"][k] for k in timing}
            for tag in ("captured", "eager"):
                timeline = rec[tag]["device_timeline"] or {}
                value = timeline.get(step_key)
                site[f"train_step_device_ms_{tag}"] = (
                    value if part is None or value is None else value[part])
            sites[preset] = site
        row["preset_training_sites"] = sites
    kernels += image_kernel_rows(image, by_path)
    per_replay = {"serve_bf16 voc_resnet18": stack["bf16"]["launches_per_replay"],
                  "serve_int8 voc12_resnet18_align": stack["int8"]["launches_per_replay"],
                  "serve_bf16 voc_resnet50_fpn": fpn_serve["launches_per_replay"],
                  "serve_int8 voc_resnet50_fpn": fpn_int8["launches_per_replay"]}
    counter_of = {"nms_mask_walk": "nms", "roi_align_fwd": "roi_align", "roi_pool_fwd": "roi_pool",
                  "multilevel_roi_align_fwd": "roi_multilevel",
                  "int8_matmul": "int8_matmul", "dequantize": "dequantize"}
    for row in kernels:
        key = counter_of.get(row["name"])
        counts = {path: {graph: n[key] for graph, n in graphs.items() if n.get(key)}
                  for path, graphs in per_replay.items()}
        counts = {path: c for path, c in counts.items() if c}
        if counts:
            row["launches_per_serving_replay"] = counts
            row["launches_note"] = ("serving flushes are CUDA graph replays: launches count "
                                    "each replay's recorded launches")
    log(json.dumps({"graph_replays": graph_replays, "serve": serve, "serve_pool": serve_pool,
                    "presets": presets,
                    "serve_int8": serve_int8, "train": train, "train_pool": train_pool,
                    "evaluate": evaluate, "resume": resume, "bench": bench,
                    "data_path": data_path, "serving_stack": stack,
                    "fpn": {"serve": fpn_serve, "serve_int8": fpn_int8, "train": fpn_train,
                            "bench": fpn_bench},
                    "int8_presets": int8_presets, "preset_train": preset_train,
                    "backbones": backbones, "knobs": knobs,
                    "phase_walls_s": walls, "card": card}))
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
