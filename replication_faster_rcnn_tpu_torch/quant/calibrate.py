"""PTQ calibration: weight scales + activation ranges (counterpart of the JAX
package's ``quant/calibrate.py``).

Weight scales are per-channel symmetric over the output channel —
``scale = max|w| / 127`` — computed in numpy on the flax-layout tree that
``models/convert.py::to_flax_variables`` makes of the port's state dict, so
the artifact's keys (flax paths such as ``trunk/layer2.1/conv1/kernel``) and
scale bytes are the JAX package's own and either package serves the other's
sidecar. Every reduction is an abs-max, exactly associative in IEEE
arithmetic, so the scales are bit-identical however the work is split.

Activation ranges come from a small calibration sweep: the inference
forward over a few batches with forward hooks on the module whose output
feeds the cls/reg GEMMs (the ResNet or VGG16 ``tail``, or the FPN two-fc
head's ``fc7`` with its ReLU folded in; :func:`embed_capture_points`). That
range becomes the static ``x_scale`` of ``ops/quant_ops.py::quant_dense``.

Layer groups follow arXiv:1806.00370's granularity: backbone stages
(``trunk.stem``, ``trunk.layer1`` ...), the FPN laterals and outputs
(``neck``), the RPN head (``rpn``) and the detection head (``head``), each
independently quantizable so the sensitivity sweep can keep one group in
bf16.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.models.convert import to_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import functional_forward

INT8_MAX = 127.0
SCALE_EPS = 1e-12

# param paths (flax keys, under "params") routed through quant_dense — true
# int8 GEMMs with activation quantization, not weight-only dequantize
QUANT_DENSE_PATHS = (
    ("head", "cls", "kernel"),
    ("head", "reg", "kernel"),
)

# activation_ranges key for the cls/reg input (the head embedding)
EMBED_RANGE_KEY = "head.embed"


def layer_group_of(path: Tuple[str, ...]) -> str:
    """Map a param path (under the "params" collection) to its layer group.

    ("trunk", "layer2.1", "conv1", "kernel") -> "trunk.layer2"
    ("trunk", "conv1", "kernel")             -> "trunk.stem"
    ("neck", ...) / ("rpn", ...) / ("head", ...) -> that subsystem.
    """
    top = path[0]
    if top == "trunk":
        if len(path) < 3:
            return "trunk.stem"
        block = path[1].split(".")[0]
        return f"trunk.{block}" if block.startswith("layer") else "trunk.stem"
    return top


def quantizable(path: Tuple[str, ...], leaf: Any) -> bool:
    """int8-eligible leaves: float weight tensors of rank >= 2 (conv and
    dense kernels). Biases and norm scales/offsets stay in bf16."""
    dtype = np.dtype(getattr(leaf, "dtype", np.float32))
    return getattr(leaf, "ndim", 0) >= 2 and dtype.kind == "f"


def flatten_params(params: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Any]]:
    """Deterministic (sorted) flattening of a nested params dict."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(prefix: Tuple[str, ...], node: Any) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + (str(k),), node[k])
        else:
            out.append((prefix, node))

    walk((), params)
    return out


def path_key(path: Sequence[str]) -> str:
    return "/".join(path)


def state_key(path: Sequence[str]) -> str:
    """The port's state-dict key of a flax kernel path:
    ("trunk", "layer1.0", "conv1", "kernel") -> "trunk.layer1.0.conv1.weight"."""
    if path[-1] != "kernel":
        raise ValueError(f"not a kernel path: {path_key(path)!r}")
    return ".".join(path[:-1]) + ".weight"


def channel_scale(w: np.ndarray) -> np.ndarray:
    """Per-output-channel symmetric scale: ``max|w| / 127`` over all but
    the last axis (order-invariant — abs-max is exactly associative)."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    return (np.maximum(amax, SCALE_EPS) / INT8_MAX).astype(np.float32)


def weight_scales(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """All quantizable leaves' per-channel scales, keyed by param path
    (``params``: the flax-layout tree, ``to_flax_variables(state)["params"]``)."""
    scales: Dict[str, np.ndarray] = {}
    for path, leaf in flatten_params(params):
        if quantizable(path, leaf):
            scales[path_key(path)] = channel_scale(np.asarray(leaf))
    return scales


def quantize_weight(w: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Symmetric round-to-nearest int8 against a per-channel scale (over
    the last axis)."""
    w = np.asarray(w, dtype=np.float32)
    q = np.rint(w / scale.astype(np.float32))
    return np.clip(q, -INT8_MAX, INT8_MAX).astype(np.int8)


def to_device_batch(images: Any, variables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A numpy NHWC batch as a float32 tensor on the variables' device."""
    device = next(iter(variables.values())).device
    return torch.from_numpy(np.asarray(images, dtype=np.float32)).to(device)


def embed_capture_points(model) -> List[Tuple[Any, bool]]:
    """The modules whose outputs set the cls/reg input's range, each with
    whether the head applies a ReLU to it before cls/reg: the points the JAX
    package's ``capture_intermediates`` filter (``tail``, ``fc6``, ``fc7``)
    reaches through ``tree.get("fc7") or tree.get("tail")``.

    * The FPN head: ``fc7``'s output before its ReLU (``head.fc7_out``),
      the ReLU folded in; ``fc6`` is captured by JAX but not read.
    * A single-scale head: the ``tail``'s output, and for the VGG16 tail
      also its own ``fc6`` and ``fc7`` outputs before their ReLUs
      (``tail.dense_out``), which JAX's filter captures under ``tail`` and
      counts without a ReLU."""
    head = model.head
    if hasattr(head, "fc7_out"):
        return [(head.fc7_out, True)]
    points = [(head.tail, False)]
    if hasattr(head.tail, "dense_out"):
        points.append((head.tail.dense_out, False))
    return points


def activation_ranges(model, variables: Dict[str, torch.Tensor],
                      batches: Sequence[Any]) -> Dict[str, float]:
    """Run the calibration sweep, returning abs-max activation ranges.

    ``batches`` is a sequence of NHWC image arrays as the engine feeds them;
    ``variables`` the float state dict the forward runs with. Forward hooks
    on :func:`embed_capture_points` see the values in the dtype the head
    computes them in; each is read as float32, ReLU'd where the head does,
    and its abs-max taken."""
    captured: List[Tuple[torch.Tensor, bool]] = []
    hooks = [
        module.register_forward_hook(
            lambda _mod, _inp, out, relu=relu: captured.append((out, relu)))
        for module, relu in embed_capture_points(model)
    ]
    amax = 0.0
    try:
        for images in batches:
            captured.clear()
            functional_forward(model, variables, to_device_batch(images, variables))
            if not captured:
                raise ValueError("calibration captured no head tail/fc7 output")
            for out, relu in captured:
                a = out.detach().float()
                if relu:
                    a = torch.clamp_min(a, 0.0)  # the head applies relu before cls/reg
                amax = max(amax, float(a.abs().amax()))
    finally:
        for hook in hooks:
            hook.remove()
    return {EMBED_RANGE_KEY: amax}


def embed_scale(ranges: Dict[str, float]) -> float:
    """The quant_dense x_scale derived from the calibrated embed range."""
    return max(ranges[EMBED_RANGE_KEY], SCALE_EPS) / INT8_MAX


def group_paths(params: Dict[str, Any]) -> Dict[str, List[str]]:
    """group name -> sorted quantizable param paths in that group."""
    groups: Dict[str, List[str]] = {}
    for path, leaf in flatten_params(params):
        if quantizable(path, leaf):
            groups.setdefault(layer_group_of(path), []).append(path_key(path))
    return {g: sorted(ps) for g, ps in sorted(groups.items())}


def synthetic_calibration_batches(
    config, batches: int, batch_size: int, seed: int = 0
) -> List[np.ndarray]:
    """Deterministic synthetic calibration images (uniform [0, 255) f32,
    the scale the data pipeline's normalize expects) for environments
    without a dataset on disk — tests and the chip smoke."""
    h, w = config.data.image_size
    rng = np.random.RandomState(seed)
    return [
        rng.uniform(0.0, 255.0, size=(batch_size, h, w, 3)).astype(np.float32)
        for _ in range(batches)
    ]


def dataset_calibration_batches(
    dataset, batches: int, batch_size: int
) -> List[np.ndarray]:
    """Calibration batches drawn from a map-style dataset's normalized
    ``"image"`` samples, in index order (deterministic — wrap-around when
    the dataset is smaller than the sweep)."""
    n = len(dataset)
    out = []
    idx = 0
    for _ in range(batches):
        imgs = [
            np.asarray(dataset[(idx + j) % n]["image"], dtype=np.float32)
            for j in range(batch_size)
        ]
        idx += batch_size
        out.append(np.stack(imgs))
    return out


def calibrate(
    model,
    variables: Dict[str, torch.Tensor],
    batches: Sequence[Any],
    config=None,
) -> Dict[str, Any]:
    """The full calibration pass -> an (unplanned) artifact dict.

    ``variables``: the float32 state dict (``model.state_dict()`` of a
    model that holds its weights). Weight scales for every quantizable leaf,
    activation ranges from the sweep, layer-group membership, and an
    all-int8 default plan the sensitivity sweep may later demote per group.
    """
    params = to_flax_variables(variables)["params"]
    scales = weight_scales(params)
    groups = group_paths(params)
    ranges = activation_ranges(model, variables, batches)
    plan = {g: "int8" for g in groups}
    return {
        "weight_scales": scales,
        "activation_ranges": ranges,
        "groups": groups,
        "plan": plan,
        "calib": {
            "batches": len(batches),
            "batch_size": int(np.asarray(batches[0]).shape[0]) if batches else 0,
        },
    }
