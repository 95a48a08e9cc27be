"""Per-layer-group sensitivity sweep -> int8/bf16 dtype plan (counterpart of
the JAX package's ``quant/sensitivity.py``).

The arXiv:1806.00370 observation: per-layer response-reconstruction error
under compression predicts which layers a network tolerates compressing.
Applied to PTQ: quantize ONE layer group at a time (fake-quant round trip,
``apply.py::fake_quant_variables``), run the inference forward over the
calibration batches, and measure the relative L2 error of the detection
responses (cls logits + box deltas) against the float forward. An optional
``eval_fn`` measures the mAP delta on a mini eval set per group.

A group falls back to bf16 when either signal crosses its threshold
(``quant.sensitivity_recon_rel_err``, ``quant.sensitivity_map_drop_pt``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from replication_faster_rcnn_tpu_torch.models.faster_rcnn import functional_forward
from replication_faster_rcnn_tpu_torch.quant.calibrate import to_device_batch


def _responses(model, variables, images) -> np.ndarray:
    """The detection responses (cls logits ++ reg deltas), flattened f32."""
    outputs = functional_forward(model, variables, to_device_batch(images, variables))
    _, _, _, _, cls, reg, _ = outputs
    return np.concatenate(
        [cls.float().cpu().numpy().ravel(), reg.float().cpu().numpy().ravel()]
    )


def response_reconstruction_error(
    model, variables, fq_variables, batches: Sequence[Any]
) -> float:
    """Relative L2 of quantized vs float detection responses over batches."""
    num = 0.0
    den = 0.0
    for images in batches:
        ref = _responses(model, variables, images)
        got = _responses(model, fq_variables, images)
        num += float(np.sum((got - ref) ** 2))
        den += float(np.sum(ref**2))
    return float(np.sqrt(num) / (np.sqrt(den) + 1e-12))


def sweep(
    model,
    variables,
    artifact: Dict[str, Any],
    batches: Sequence[Any],
    config,
    eval_fn: Optional[Callable[[Any], float]] = None,
) -> Dict[str, Any]:
    """Quantize one group at a time; emit the per-group dtype plan.

    ``variables`` is the float state dict; ``eval_fn(variables) -> mAP``
    runs a mini eval set (None skips the mAP signal — recon error alone
    then drives the plan). Mutates and returns the artifact with ``plan``
    and ``sensitivity`` filled in.
    """
    from replication_faster_rcnn_tpu_torch.quant.apply import fake_quant_variables

    recon_budget = config.quant.sensitivity_recon_rel_err
    map_budget = config.quant.sensitivity_map_drop_pt
    base_map = eval_fn(variables) if eval_fn is not None else None

    plan: Dict[str, str] = {}
    sensitivity: Dict[str, Dict[str, Any]] = {}
    for group, paths in sorted(artifact["groups"].items()):
        fq = fake_quant_variables(variables, artifact["weight_scales"], paths)
        recon = response_reconstruction_error(model, variables, fq, batches)
        record: Dict[str, Any] = {"recon_rel_err": recon}
        drop_pt = None
        if base_map is not None:
            group_map = eval_fn(fq)
            drop_pt = (base_map - group_map) * 100.0
            record["map_drop_pt"] = drop_pt
            record["map"] = group_map
        hostile = recon > recon_budget or (
            drop_pt is not None and drop_pt > map_budget
        )
        plan[group] = "bfloat16" if hostile else "int8"
        record["dtype"] = plan[group]
        sensitivity[group] = record

    artifact["plan"] = plan
    artifact["sensitivity"] = sensitivity
    if base_map is not None:
        artifact["sensitivity"]["__baseline__"] = {"map": base_map}
    return artifact
