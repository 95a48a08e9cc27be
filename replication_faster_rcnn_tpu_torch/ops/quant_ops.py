"""Quantized matmul/conv ops of the int8 serving path (counterpart of the JAX
package's ``ops/quant_ops.py``).

The int8 serve path (``serving.params_dtype = "int8"``) keeps planned weights
resident as int8 plus per-channel symmetric scales and reconstructs
compute-dtype values on the way into each matmul/conv:

* :func:`quant_dense` — a true int8 GEMM: the activation is quantized
  against its calibrated range, the product runs int8 x int8 -> int32, and
  the result is rescaled by ``x_scale * w_scale`` (the detection head's
  cls/reg layers, ``models/head.py``);
* :func:`quant_conv` — weight-only quantization: per-channel dequantize,
  then the convolution in the input's dtype;
* :func:`dequantize` — the shared per-channel reconstruction, and
  :func:`dequantize_many` the same over a list of leaves in one launch (the
  int8 flush's conv weights).

:func:`int8_matmul`, :func:`dequantize` and :func:`dequantize_many` are the
dispatch points (``ops/__init__.py``): a CUDA tensor launches the
hand-written kernel (``ops/cuda/quant_kernel.py``, a failed build or launch
raises), a CPU tensor or :class:`ops.reference_scope` runs the plain version
below.
Integer arithmetic does not round, so kernel and plain GEMM are bitwise
equal; the dequantize is one float32 multiply, bitwise equal as well.

Layouts: the JAX contract puts a weight's channel on its last axis (HWIO,
Dense ``[in, out]``); the port holds conv weights as OIHW and Linear weights
as ``[out, in]``, channel first. :func:`dequantize` takes ``channel_axis``
so both are served; ``int8_matmul`` keeps JAX's ``[M, K] @ [K, N]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from replication_faster_rcnn_tpu_torch import ops

Tensor = torch.Tensor

INT8_MAX = 127.0
# the float64 product of int8 operands is exact while every partial sum
# stays below 2**53: K * 128 * 128 < 2**53
_F64_EXACT_K = 2**53 // (128 * 128)


def _scalar(v: Union[float, Tensor], like: Tensor) -> Tensor:
    """``v`` as a float32 tensor on ``like``'s device, so that dividing by it
    is an IEEE division on every device (on CUDA, PyTorch turns division by
    a Python scalar into a multiply by its reciprocal)."""
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def channel_view(w: Tensor, scale: Tensor, channel_axis: int) -> Tuple[int, int]:
    """``(channels, inner)`` of ``w`` seen as ``[outer, channels, inner]``
    with the channel on ``channel_axis``; checks ``scale`` is ``[channels]``."""
    if w.dim() == 0:
        raise ValueError("a per-channel op needs a tensor of rank >= 1")
    axis = channel_axis % w.dim()
    channels = w.shape[axis]
    if scale.shape != (channels,):
        raise ValueError(
            f"scale must be [{channels}] for axis {channel_axis} of {tuple(w.shape)}, "
            f"got {tuple(scale.shape)}"
        )
    inner = 1
    for d in w.shape[axis + 1:]:
        inner *= d
    return channels, inner


def _broadcast(scale: Tensor, w: Tensor, channel_axis: int) -> Tensor:
    shape = [1] * w.dim()
    shape[channel_axis % w.dim()] = -1
    return scale.to(torch.float32).reshape(shape)


def quantize_channelwise(
    w: Tensor, channel_axis: int = -1, eps: float = 1e-12
) -> Tuple[Tensor, Tensor]:
    """Per-channel symmetric int8 quantization along ``channel_axis``:
    ``(w_q int8, scale float32 [channels])`` with ``scale = max|w| / 127``
    over every other axis (the torch twin of the numpy calibration in
    ``quant/calibrate.py``, which owns artifact determinism)."""
    w = w.float()
    axis = channel_axis % w.dim()
    others = tuple(d for d in range(w.dim()) if d != axis)
    amax = torch.amax(torch.abs(w), dim=others) if others else torch.abs(w)
    scale = torch.clamp(amax, min=eps) / _scalar(INT8_MAX, w)
    q = torch.round(w / _broadcast(scale, w, axis))
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8), scale


def quantize_activation(x: Tensor, x_scale: Union[float, Tensor]) -> Tensor:
    """Symmetric int8 activation quantization against a calibrated scale:
    ``clip(round(float32(x) / x_scale), -127, 127)``, rounding half to even
    as ``jnp.round`` does."""
    q = torch.round(x.float() / _scalar(x_scale, x))
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def int8_matmul_plain(x_q: Tensor, w_q: Tensor) -> Tensor:
    """The plain version of the int8 GEMM kernel: ``[M, K] @ [K, N] -> int32``.
    ``torch.matmul`` on int8 would accumulate in int8 and wrap, and CUDA has
    no integer matmul, so the operands go through a float64 product, which
    is exact here (every partial sum is an integer below 2**53)."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul wants int8 operands, got {x_q.dtype}/{w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"expected [M, K] @ [K, N], got {tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    if x_q.shape[1] > _F64_EXACT_K:
        raise ValueError(f"K = {x_q.shape[1]} is too long for an exact float64 product")
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


def dequantize_plain(
    w_q: Tensor, scale: Tensor, channel_axis: int = -1, out_dtype: torch.dtype = torch.float32
) -> Tensor:
    """The plain version of the dequantize kernel: ``float32(w_q) * scale``
    along ``channel_axis``, converted once to ``out_dtype``."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"dequantize wants an int8 tensor, got {w_q.dtype}")
    channel_view(w_q, scale, channel_axis)
    return (w_q.float() * _broadcast(scale, w_q, channel_axis)).to(out_dtype)


def dequantize_many_plain(
    leaves: Sequence[Tuple[Tensor, Tensor, int]], out_dtype: torch.dtype = torch.float32
) -> List[Tensor]:
    """The plain version of the grouped dequantize kernel: one
    :func:`dequantize_plain` per leaf ``(w_q, scale, channel_axis)``."""
    return [dequantize_plain(w_q, scale, axis, out_dtype) for w_q, scale, axis in leaves]


def int8_matmul(x_q: Tensor, w_q: Tensor) -> Tensor:
    """int8 ``[M, K] @ [K, N] -> int32``: the kernel on a CUDA tensor, the
    plain version on a CPU tensor or inside ``ops.reference_scope``."""
    if ops.reference_requested():
        return int8_matmul_plain(x_q, w_q)
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import int8_matmul_cuda

    return int8_matmul_cuda(x_q, w_q)


def dequantize(
    w_q: Tensor, scale: Tensor, channel_axis: int = -1, out_dtype: torch.dtype = torch.float32
) -> Tensor:
    """Per-channel reconstruction ``w_q * scale`` (JAX's contract with the
    default ``channel_axis=-1``), written as ``out_dtype``: the kernel on a
    CUDA tensor, the plain version on a CPU tensor or inside
    ``ops.reference_scope``."""
    if ops.reference_requested():
        return dequantize_plain(w_q, scale, channel_axis, out_dtype)
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import dequantize_cuda

    return dequantize_cuda(w_q, scale, channel_axis, out_dtype)


def dequantize_many(
    leaves: Sequence[Tuple[Tensor, Tensor, int]], out_dtype: torch.dtype = torch.float32
) -> List[Tensor]:
    """:func:`dequantize` of every leaf ``(w_q, scale, channel_axis)``: one
    launch of the grouped kernel for CUDA leaves, the plain loop for CPU
    leaves or inside ``ops.reference_scope``. Each output is bitwise
    :func:`dequantize_plain` of its leaf."""
    if ops.reference_requested():
        return dequantize_many_plain(leaves, out_dtype)
    from replication_faster_rcnn_tpu_torch.ops.cuda.quant_kernel import dequantize_many_cuda

    return dequantize_many_cuda(leaves, out_dtype)


def quant_dense(
    x: Tensor,
    w_q: Tensor,
    w_scale: Tensor,
    x_scale: Union[float, Tensor],
    bias: Optional[Tensor] = None,
) -> Tensor:
    """int8 dense layer: quantize ``x``, int8 GEMM, rescale, add bias.

    ``x [..., K]`` (any float dtype), ``w_q [K, N] int8`` (JAX's layout; the
    port passes its Linear weight ``[N, K]`` as a ``.t()`` view), ``w_scale
    [N]``, ``x_scale`` scalar (calibrated activation range / 127). Output is
    float32 ``[..., N]``: ``y * (x_scale * w_scale) + bias``, one rounding per
    operation as in the JAX function."""
    lead = x.shape[:-1]
    x_q = quantize_activation(x.reshape(-1, x.shape[-1]), x_scale)
    y = int8_matmul(x_q, w_q).float()
    y = y * (_scalar(x_scale, y) * w_scale.float())[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.reshape(lead + (y.shape[-1],))


def quant_conv(
    x: Tensor,
    w_q: Tensor,
    w_scale: Tensor,
    stride=1,
    padding=0,
    bias: Optional[Tensor] = None,
) -> Tensor:
    """Weight-only quantized convolution (NCHW): per-channel dequantize the
    OIHW int8 kernel into ``x``'s dtype, then convolve."""
    w = dequantize(w_q, w_scale, channel_axis=0, out_dtype=torch.float32).to(x.dtype)
    return F.conv2d(x, w, None if bias is None else bias.to(x.dtype), stride, padding)
