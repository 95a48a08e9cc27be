"""Quantized resident tree <-> per-call reconstruction (counterpart of the JAX
package's ``quant/apply.py``).

:func:`quantize_variables` is the host half, run once when an engine starts:
it turns a float32 state dict + a calibration artifact into the resident
tree — planned weights as int8 (in the port's layout: OIHW convs, Linear
``[out, in]``) with their per-channel scales, every other float tensor cast
to bfloat16, as the JAX resident tree does (BatchNorm parameters and
statistics and the cls/reg biases included). The detection head's cls/reg
weights stay int8 and get a ``quant`` entry (``w_scale`` + the calibrated
``x_scale``) so the head runs them as true int8 GEMMs.

:func:`build_infer_variables` is the per-call half: every other int8
weight is reconstructed through ``ops/quant_ops.py::dequantize_many`` (one
launch of the grouped CUDA kernel on the card) straight into the compute
dtype, and the bf16 leaves are cast to it. No weight is cached across
calls: the int8 tree is what stays resident, with the grouped kernel's
descriptor table (built at the first call).

:func:`fake_quant_variables` is the sensitivity sweep's simulator: float
variables with one layer group's weights replaced by their
quantize -> dequantize round trip.

Artifacts are keyed by flax paths (``quant/calibrate.py``); the state-dict
key of a path is :func:`calibrate.state_key`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.models.convert import kernel_from_flax, to_flax_variables
from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.ops import quant_ops
from replication_faster_rcnn_tpu_torch.quant.calibrate import (
    EMBED_RANGE_KEY,
    QUANT_DENSE_PATHS,
    embed_scale,
    flatten_params,
    group_paths,
    layer_group_of,
    path_key,
    quantizable,
    quantize_weight,
    state_key,
)

Tensor = torch.Tensor

_DENSE_KEYS = {path_key(p) for p in QUANT_DENSE_PATHS}
_DENSE_STATE_KEYS = {state_key(p) for p in QUANT_DENSE_PATHS}


def _planned_int8(artifact: Dict[str, Any], path: Tuple[str, ...], leaf) -> bool:
    if not quantizable(path, leaf):
        return False
    if path_key(path) not in artifact["weight_scales"]:
        return False
    return artifact["plan"].get(layer_group_of(path), "bfloat16") == "int8"


def quantize_variables(
    variables: Dict[str, Tensor],
    artifact: Dict[str, Any],
    compute_dtype: torch.dtype = None,
) -> Dict[str, Any]:
    """Build the quantized resident tree from a float32 state dict + artifact.

    Returns ``{"params": {state key: tensor}, "qscales": {state key: scale},
    "quant": {"head": {"cls"|"reg": {"w_scale", "x_scale"}}}}`` on the CPU
    (``quant`` only when the head is planned int8). ``compute_dtype``
    (default bfloat16) is the dtype of everything the plan does not keep
    int8. The int8 leaves are bitwise the JAX package's, transposed: convs
    OIHW and Linear weights ``[out, in]`` (the FPN head's and the VGG16
    tail's ``fc6`` / ``fc7`` among them), so each scale runs along axis 0."""
    compute_dtype = compute_dtype or torch.bfloat16
    x_scale = np.float32(embed_scale(artifact["activation_ranges"]))
    int8: Dict[str, Tensor] = {}
    qscales: Dict[str, Tensor] = {}
    dense_quant: Dict[str, Any] = {}
    for path, leaf in flatten_params(to_flax_variables(variables)["params"]):
        if not _planned_int8(artifact, path, leaf):
            continue
        scale = np.asarray(artifact["weight_scales"][path_key(path)], dtype=np.float32)
        key = state_key(path)
        int8[key] = torch.from_numpy(kernel_from_flax(quantize_weight(leaf, scale)))
        if key in _DENSE_STATE_KEYS:
            # consumed by the head's int8 twin of the cls/reg Linear
            dense_quant[path[-2]] = {
                "w_scale": torch.from_numpy(scale.copy()),
                "x_scale": torch.tensor(float(x_scale), dtype=torch.float32),
            }
        else:
            qscales[key] = torch.from_numpy(scale.copy())
    params = {}
    for key, tensor in variables.items():
        tensor = tensor.detach().cpu()
        if key in int8:
            params[key] = int8[key]
        elif tensor.is_floating_point():
            params[key] = tensor.to(compute_dtype)
        else:
            params[key] = tensor
    out: Dict[str, Any] = {"params": params, "qscales": qscales}
    if dense_quant:
        out["quant"] = {"head": dense_quant}
    return out


def build_infer_variables(
    qvars: Dict[str, Any], config=None, compute_dtype: torch.dtype = None
) -> Dict[str, Any]:
    """Per-call reconstruction: dequantize every int8 weight except the
    cls/reg ones into the compute dtype (``config.model.compute_dtype``;
    bfloat16 without a config), all in one grouped dequantize, and cast the
    other float leaves to it. Returns ``{"params": state dict, "quant":
    ...}`` for ``models/faster_rcnn.py::functional_forward``.

    On the card the grouped kernel's descriptor table is built at the first
    call for each compute dtype and kept in ``qvars["dequantize_tables"]``;
    on the CPU or inside ``ops.reference_scope`` the plain loop runs.

    Residency and compute are decoupled as in the JAX package: the resident
    tree stays int8 + bf16, and each call builds the compute-dtype weights,
    used once and freed."""
    if compute_dtype is None:
        compute_dtype = (
            getattr(torch, config.model.compute_dtype) if config is not None else torch.bfloat16
        )
    qscales = qvars.get("qscales", {})
    keys = [key for key, tensor in qvars["params"].items()
            if tensor.dtype == torch.int8 and key not in _DENSE_STATE_KEYS]
    leaves = [(qvars["params"][key], qscales[key], 0) for key in keys]
    if leaves and leaves[0][0].is_cuda and not ops.reference_requested():
        from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import DequantizeTable

        tables = qvars.setdefault("dequantize_tables", {})
        if compute_dtype not in tables:
            tables[compute_dtype] = DequantizeTable(leaves, compute_dtype)
        outs = tables[compute_dtype]()
    else:
        outs = quant_ops.dequantize_many(leaves, compute_dtype)
    dequantized = dict(zip(keys, outs))
    params = {}
    for key, tensor in qvars["params"].items():
        if key in dequantized:
            params[key] = dequantized[key]
        elif tensor.is_floating_point():
            params[key] = tensor.to(compute_dtype)
        else:
            params[key] = tensor
    out: Dict[str, Any] = {"params": params}
    if qvars.get("quant") is not None:
        out["quant"] = qvars["quant"]
    return out


def fake_quant_variables(
    variables: Dict[str, Tensor],
    scales: Dict[str, np.ndarray],
    paths: List[str],
) -> Dict[str, Tensor]:
    """Float variables (a state dict) with the given param paths' weights
    replaced by their int8 quantize -> dequantize round trip (sensitivity
    sweep). ``scales`` and ``paths`` are keyed by flax paths."""
    wanted = set(paths)
    out = dict(variables)
    for path, leaf in flatten_params(to_flax_variables(variables)["params"]):
        key = path_key(path)
        if key not in wanted:
            continue
        scale = scales[key].astype(np.float32)
        w_rt = quantize_weight(leaf, scale).astype(np.float32) * scale
        target = variables[state_key(path)]
        out[state_key(path)] = torch.from_numpy(kernel_from_flax(w_rt)).to(target.device)
    return out


def round_trip_errors(
    params: Dict[str, Any], scales: Dict[str, np.ndarray]
) -> Dict[str, float]:
    """Per-path max-abs quantize->dequantize error relative to the
    channel scale (<= 0.5 by construction of round-to-nearest).
    ``params``: the flax-layout tree, ``to_flax_variables(state)["params"]``."""
    errors: Dict[str, float] = {}
    for path, leaf in flatten_params(params):
        key = path_key(path)
        if key not in scales:
            continue
        w = np.asarray(leaf, dtype=np.float32)
        scale = scales[key].astype(np.float32)
        w_rt = quantize_weight(w, scale).astype(np.float32) * scale
        errors[key] = float(np.max(np.abs(w - w_rt) / scale))
    return errors


def synthetic_artifact(variables: Dict[str, Tensor]) -> Dict[str, Any]:
    """A structure-only artifact (unit scales, all-int8 plan) for a state
    dict: tests and rehearsals that need the int8 path without a
    calibration run. Never used to serve real traffic."""
    params = to_flax_variables(variables)["params"]
    scales = {
        path_key(path): np.full((leaf.shape[-1],), 1.0 / 127.0, dtype=np.float32)
        for path, leaf in flatten_params(params)
        if quantizable(path, leaf)
    }
    groups = group_paths(params)
    return {
        "weight_scales": scales,
        "activation_ranges": {EMBED_RANGE_KEY: 127.0},
        "groups": groups,
        "plan": {g: "int8" for g in groups},
        "calib": {"batches": 0, "batch_size": 0, "synthetic": True},
    }


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, Tensor):
        yield tree


def quantized_params_bytes(qvars: Dict[str, Any]) -> int:
    """Total bytes of the resident quantized tree (weights + scales)."""
    return int(sum(t.numel() * t.element_size() for t in _tensors(qvars)))


def tree_to(tree: Any, device) -> Any:
    """The same nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, Tensor) else tree
