"""Wrappers of the CUDA int8 kernels (``csrc/quant_kernel.cu``).

Counterparts of the JAX package's ``ops/pallas/quant_kernel.py``:
:func:`int8_matmul_cuda` of ``quant_matmul_pallas`` and
:func:`dequantize_cuda` of ``dequantize_pallas``; :func:`dequantize_many_cuda`
runs the dequantize over a list of leaves in one launch (the int8 flush). A
CPU tensor runs the plain versions in ``ops/quant_ops.py``, which the kernels
match bit for bit.
Neither kernel needs padding from the caller: the Pallas wrappers' (32, 128)
zero padding is a TPU tiling detail.
"""

from __future__ import annotations

import ctypes
import types
from typing import List, Optional, Sequence, Tuple

import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build
from replication_faster_rcnn_tpu_torch.ops.quant_ops import (
    channel_view,
    dequantize_many_plain,
    dequantize_plain,
    int8_matmul_plain,
)

Tensor = torch.Tensor

# kernel launches since the last reset (the caller resets them to 0)
matmul_launches = 0
dequantize_launches = 0

# elements per block of the dequantize kernels (csrc: DQ_BLOCK)
DQ_BLOCK = 4096

_fns = None


def _kernels() -> types.SimpleNamespace:
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
        many_args = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        single = {torch.float32: lib.dequantize_launch_f32,
                  torch.bfloat16: lib.dequantize_launch_bf16}
        many = {torch.float32: lib.dequantize_many_launch_f32,
                torch.bfloat16: lib.dequantize_many_launch_bf16}
        lib.int8_matmul_launch.restype = ctypes.c_int
        for fn in single.values():
            fn.argtypes, fn.restype = dq_args, ctypes.c_int
        for fn in many.values():
            fn.argtypes, fn.restype = many_args, ctypes.c_int
        lib.dequantize_block_elements.restype = ctypes.c_int
        if lib.dequantize_block_elements() != DQ_BLOCK:
            raise RuntimeError("csrc/quant_kernel.cu's DQ_BLOCK differs from the wrapper's")
        lib.quant_error_string.argtypes = [ctypes.c_int]
        lib.quant_error_string.restype = ctypes.c_char_p
        _fns = types.SimpleNamespace(matmul=lib.int8_matmul_launch, single=single, many=many,
                                     error=lib.quant_error_string)
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
    lib = _kernels()
    vec = int(k % 16 == 0 and x.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        rc = lib.matmul(x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, n, k, vec, _stream(x.device))
    build.check(rc, lib.error, "int8_matmul_kernel")
    global matmul_launches
    matmul_launches += 1
    return out


def _vector_bytes(out_dtype: torch.dtype) -> int:
    """int8 bytes per vector load of the dequantize kernels: 4 for a float32
    output, 8 for bfloat16 (each vector fills one 16-byte store)."""
    return 4 if out_dtype == torch.float32 else 8


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
    lib = _kernels()
    fn = lib.single.get(out_dtype)
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
    vec = int(w.data_ptr() % _vector_bytes(out_dtype) == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(w.device):
        rc = fn(w.data_ptr(), s.data_ptr(), out.data_ptr(), w.numel(), inner, channels, vec,
                _stream(w.device))
    build.check(rc, lib.error, "dequantize_kernel")
    global dequantize_launches
    dequantize_launches += 1
    return out


# a grouped dequantize's outputs start at multiples of this many bytes of its
# arena: beyond the 16 of the kernel's vector stores, and the 32 up to which
# cuDNN tells pointer alignments apart, so a convolution sees the same
# alignment as on a tensor of its own
ARENA_ALIGN = 256
Leaf = Tuple[Tensor, Tensor, int]  # (w_q int8, scale [channels], channel_axis)


class DequantizeTable:
    """The grouped dequantize's descriptor table for a fixed list of leaves
    ``(w_q, scale, channel_axis)`` on one CUDA device and one output dtype
    (``quant/apply.py::build_infer_variables`` builds one per resident tree
    and keeps it with the tree): per leaf the int8 and scale pointers, n,
    inner, channels, the output's byte offset in the arena and its first
    block. The table reaches the card at the first launch and stays there
    (64 bytes per leaf); it holds the tensors it points at."""

    def __init__(self, leaves: Sequence[Leaf], out_dtype: torch.dtype = torch.float32):
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dequantize_many writes float32 or bfloat16, got {out_dtype}")
        self.out_dtype = out_dtype
        self.leaves = [tuple(leaf) for leaf in leaves]
        elem = torch.empty((), dtype=out_dtype).element_size()
        devices = {w.device for w, _, _ in self.leaves} | {s.device for _, s, _ in self.leaves}
        if len(devices) > 1:
            raise ValueError(f"dequantize_many wants every leaf on one device, got {devices}")
        self.device = devices.pop() if devices else None
        rows: List[List[int]] = []
        self._held = []  # what the table points at (a copy where a leaf was not contiguous)
        self.offsets: List[int] = []  # in elements of the output dtype
        nbytes = blocks = max_n = 0
        for w_q, scale, axis in self.leaves:
            if w_q.dtype != torch.int8:
                raise TypeError(f"dequantize_many wants int8 tensors, got {w_q.dtype}")
            channels, inner = channel_view(w_q, scale, axis)
            w = w_q.contiguous()
            s = scale.to(torch.float32).contiguous()
            self._held.append((w, s))
            n = w.numel()
            rows.append([w.data_ptr(), s.data_ptr(), n, inner, channels, nbytes,
                         int(w.data_ptr() % _vector_bytes(out_dtype) == 0), blocks])
            self.offsets.append(nbytes // elem)
            nbytes += -(-n * elem // ARENA_ALIGN) * ARENA_ALIGN
            blocks += -(-n // DQ_BLOCK)
            max_n = max(max_n, n)
        self.arena_elements = nbytes // elem
        self.blocks, self.max_n = blocks, max_n
        self.host_table = torch.tensor(rows, dtype=torch.int64).reshape(len(rows), 8)
        self.device_table: Optional[Tensor] = None

    def __call__(self) -> List[Tensor]:
        """One launch: every leaf dequantized into views of one fresh arena."""
        arena = torch.empty(self.arena_elements, dtype=self.out_dtype, device=self.device)
        outs = [arena[off:off + w.numel()].view(w.shape)
                for off, (w, _) in zip(self.offsets, self._held)]
        if self.blocks == 0:
            return outs
        lib = _kernels()
        with torch.cuda.device(self.device):
            if self.device_table is None:
                self.device_table = self.host_table.to(self.device)
            rc = lib.many[self.out_dtype](self.device_table.data_ptr(), len(self.leaves),
                                          self.blocks, self.max_n, arena.data_ptr(),
                                          _stream(self.device))
        build.check(rc, lib.error, "dequantize_many_kernel")
        global dequantize_launches
        dequantize_launches += 1
        return outs


def dequantize_many_cuda(
    leaves: Sequence[Leaf], out_dtype: torch.dtype = torch.float32
) -> List[Tensor]:
    """:func:`dequantize_cuda` over every leaf ``(w_q, scale, channel_axis)``
    in one launch (through a :class:`DequantizeTable` built for this call),
    each output bitwise equal to :func:`dequantize_plain` of its leaf. CPU
    leaves run the plain loop."""
    if not any(w.is_cuda for w, _, _ in leaves):
        return dequantize_many_plain(leaves, out_dtype)
    return DequantizeTable(leaves, out_dtype)()
