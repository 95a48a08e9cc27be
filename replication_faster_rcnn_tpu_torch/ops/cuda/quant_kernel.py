"""Wrappers of the CUDA int8 kernels (``csrc/quant_kernel.cu``).

Counterparts of the JAX package's ``ops/pallas/quant_kernel.py``:
:func:`int8_matmul_cuda` of ``quant_matmul_pallas`` and
:func:`dequantize_cuda` of ``dequantize_pallas``. A CPU tensor runs the plain
versions in ``ops/quant_ops.py``, which the kernels match bit for bit.
Neither kernel needs padding from the caller: the Pallas wrappers' (32, 128)
zero padding is a TPU tiling detail.
"""

from __future__ import annotations

import ctypes

import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build
from replication_faster_rcnn_tpu_torch.ops.quant_ops import (
    channel_view,
    dequantize_plain,
    int8_matmul_plain,
)

Tensor = torch.Tensor

# kernel launches since the last reset (the caller resets them to 0)
matmul_launches = 0
dequantize_launches = 0

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = build.library("quant_kernel")
        lib.int8_matmul_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        dq_args = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        for fn in (lib.int8_matmul_launch, lib.dequantize_launch_f32, lib.dequantize_launch_bf16):
            fn.restype = ctypes.c_int
        lib.dequantize_launch_f32.argtypes = dq_args
        lib.dequantize_launch_bf16.argtypes = dq_args
        lib.quant_error_string.argtypes = [ctypes.c_int]
        lib.quant_error_string.restype = ctypes.c_char_p
        _fns = (
            lib.int8_matmul_launch,
            {torch.float32: lib.dequantize_launch_f32, torch.bfloat16: lib.dequantize_launch_bf16},
            lib.quant_error_string,
        )
    return _fns


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def int8_matmul_cuda(x_q: Tensor, w_q: Tensor) -> Tensor:
    """int8 ``x_q [M, K] @ w_q [K, N] -> int32 [M, N]``, int32-accumulated,
    bitwise equal to :func:`int8_matmul_plain`. Any M, N and K. The kernel
    reads x row-major and w as its transpose [N, K] row-major, so a
    ``weight.t()`` view of a Linear weight [N, K] costs no copy; other
    layouts are copied."""
    if not x_q.is_cuda:
        return int8_matmul_plain(x_q, w_q)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul_cuda wants int8 operands, got {x_q.dtype}/{w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"expected [M, K] @ [K, N], got {tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    if w_q.device != x_q.device:
        raise ValueError("x_q and w_q must be on the same CUDA device")
    m, k = x_q.shape
    n = w_q.shape[1]
    x = x_q.contiguous()
    wt = w_q.t().contiguous()
    out = torch.empty(m, n, dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn, _, err = _kernels()
    vec = int(k % 16 == 0 and x.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, n, k, vec, _stream(x.device))
    build.check(rc, err, "int8_matmul_kernel")
    global matmul_launches
    matmul_launches += 1
    return out


def dequantize_cuda(
    w_q: Tensor, scale: Tensor, channel_axis: int = -1, out_dtype: torch.dtype = torch.float32
) -> Tensor:
    """Per-channel ``float32(w_q) * scale`` along ``channel_axis`` (-1: the
    JAX contract, 0: the port's OIHW / [out, in] weights), written as
    ``out_dtype`` (float32, or bfloat16 converted once from the float32
    product); bitwise equal to :func:`dequantize_plain`."""
    if not w_q.is_cuda:
        return dequantize_plain(w_q, scale, channel_axis, out_dtype)
    if w_q.dtype != torch.int8:
        raise TypeError(f"dequantize_cuda wants an int8 tensor, got {w_q.dtype}")
    _, fns, err = _kernels()
    fn = fns.get(out_dtype)
    if fn is None:
        raise TypeError(f"dequantize_cuda writes float32 or bfloat16, got {out_dtype}")
    channels, inner = channel_view(w_q, scale, channel_axis)
    if scale.device != w_q.device:
        raise ValueError("w_q and scale must be on the same CUDA device")
    w = w_q.contiguous()
    s = scale.to(torch.float32).contiguous()
    out = torch.empty(w.shape, dtype=out_dtype, device=w.device)
    if out.numel() == 0:
        return out
    align = 16 if out_dtype == torch.float32 else 8
    vec = int(w.data_ptr() % 4 == 0 and out.data_ptr() % align == 0)
    with torch.cuda.device(w.device):
        rc = fn(w.data_ptr(), s.data_ptr(), out.data_ptr(), w.numel(), inner, channels, vec,
                _stream(w.device))
    build.check(rc, err, "dequantize_kernel")
    global dequantize_launches
    dequantize_launches += 1
    return out
