#!/usr/bin/env python3
"""The JAX package's FPN overfit recipe on the card, through the port.

``python tools/fpn_overfit.py`` from the repository root on a machine with an
NVIDIA GPU runs ``benchmarks/map_overfit.py --config voc_resnet50_fpn
--anchor-scales 2 --epochs 40 --images 32 --batch 4`` (the run behind
``benchmarks/map_overfit_result_fpn.json``: ``voc_resnet50_fpn`` with the
ROIAlign head, one anchor scale 2 a level, float32, 128x128 synthetic images
with up to 8 boxes, Adam lr 3e-4, the val split evaluated every 2 epochs, a
save every 10) with the port's ``Trainer.train`` and ``Evaluator``, through
``chip_smoke.py::phase_overfit``: the launches of the run counted (per step
NMS 1, IoU matching 2, the multi-level ROIAlign forward 1 and backward 1;
per eval batch NMS 2 and the forward 1), the train-set mAP@0.5 held to
``OVERFIT_MAP_FLOOR`` (0.5, the ResNet18 recipe's floor), a fresh trainer's
``restore()`` scoring the final val mAP within 1e-9, then the same weights
in int8. Prints the card, the phase's log, then one JSON line with the
train-set mAP, the wall seconds and the JAX package's record of the same
recipe (a CPU float32 run). Not part of ``chip_smoke.py``. Exits non-zero
without CUDA or on any failed check.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# the JAX package's train-set mAP@0.5 of this recipe
# (benchmarks/map_overfit_result_fpn.json, a CPU float32 run, not a card number)
JAX_FPN_OVERFIT_MAP = 0.9486842105263157


def fpn_overfit_config(epochs, batch, lr, size, anchor_scale):
    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.config import DataConfig, TrainConfig

    base = get_config("voc_resnet50_fpn")
    return base.replace(
        anchors=dataclasses.replace(base.anchors, scales=(anchor_scale,)),
        model=dataclasses.replace(base.model, roi_op="align", compute_dtype="float32"),
        data=DataConfig(dataset="synthetic", image_size=(size, size), max_boxes=8),
        train=TrainConfig(batch_size=batch, n_epoch=epochs, lr=lr, eval_every_epochs=2,
                          checkpoint_every_epochs=max(epochs // 4, 1), seed=0),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--anchor-scale", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fpn_overfit: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    import chip_smoke
    from replication_faster_rcnn_tpu_torch.ops.cuda import build

    # chip_smoke's settings: TF32 off, deterministic cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda}")
    build.build_all()
    chip_smoke.REPLAYS.install()
    cfg = fpn_overfit_config(args.epochs, args.batch, args.lr, args.image_size,
                             args.anchor_scale)
    t0 = time.perf_counter()
    launches, out = chip_smoke.phase_overfit(torch, cfg=cfg, length=args.images,
                                             jax_record=JAX_FPN_OVERFIT_MAP)
    wall = time.perf_counter() - t0
    print(json.dumps({"config": "voc_resnet50_fpn", "card": card, "train_set_mAP":
                      out["train_set_mAP"], "floor": chip_smoke.OVERFIT_MAP_FLOOR,
                      "jax_cpu_record_mAP": JAX_FPN_OVERFIT_MAP, "train_s": out["train_s"],
                      "wall_s": wall, "steps": out["steps"], "launches": launches,
                      "final_val_mAP": out["final_val_mAP"],
                      "int8_train_set_mAP": {k: v["mAP"] for k, v in out["int8"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
