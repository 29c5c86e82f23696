"""Wrapper of the int8 matmul kernel (``csrc/int8_matmul.cu``).

The CUDA counterpart of the TPU kernel ``int8_matmul_kernel``
(``accelerate_tpu/ops/pallas/int8_mm.py:36``): ``x @ w`` with x quantized
per row and w per column (absmax symmetric int8), an int32 contraction on
the tensor cores, and the f32 rescale cast to ``x.dtype``. Its plain version
is ``ops/int8.int8_matmul_reference``; the two are bitwise equal.

The kernel runs as five launches (quantize the rows of x; the column
absmax of w; quantize w into a transposed scratch; the GEMM, split over K
when its output tiles alone would leave SMs idle; the epilogue that sums
the splits and rescales), counted as one ``int8_matmul`` launch. This
wrapper takes CUDA tensors only — CPU tensors reach the plain version
through the registry — checks device, dtype (x and w both f32 or both
bf16) and shapes (K >= 1), reshapes x's leading dims to rows, allocates the
output and the scratch with ``torch.empty``, launches on the current stream
and raises on a launch error.
"""

from __future__ import annotations

import ctypes

import torch

from ..registry import record_launch
from ._build import load

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_PAD = 64  # the kernel's tile: M, N and K are padded to multiples of it
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("int8_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul_launch.argtypes = [i32] + [ptr] * 9 + [i32, i32, i32, i32, ptr]
        lib.int8_matmul_launch.restype = i32
        lib.int8_matmul_error_string.argtypes = [i32]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"int8_matmul kernel: {msg}")


def _pad(n: int) -> int:
    return -(-n // _PAD) * _PAD


def splits_for(M: int, N: int, K: int, sms: int) -> int:
    """K splits of the GEMM: enough CTAs for two a streaming multiprocessor
    when the 64 x 64 output tiles alone are fewer, each split a whole
    number of 64-deep k tiles and none empty."""
    k_tiles = _pad(K) // _PAD
    tiles = (_pad(M) // _PAD) * (_pad(N) // _PAD)
    want = min(k_tiles, max(1, -(-2 * sms // tiles)))
    per = -(-k_tiles // want)
    return -(-k_tiles // per)


def int8_matmul_cuda(x, w):
    """Launch the int8 matmul: x ``(..., K)``, w ``(K, N)`` → ``(..., N)``
    in ``x.dtype``."""
    _check(x.is_cuda, f"takes CUDA tensors, got a tensor on {x.device}")
    dev = x.device
    _check(w.device == dev, f"w lies on {w.device}, x on {dev}")
    _check(x.dtype == w.dtype and x.dtype in _KIND,
           f"x and w must both be float32 or both bfloat16, got {x.dtype} and {w.dtype}")
    _check(w.dim() == 2 and x.dim() >= 1 and x.shape[-1] == w.shape[0] and w.shape[0] > 0,
           f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not contract over K >= 1")
    K, N = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    w = w.contiguous()
    M = x2.shape[0]
    _check(max(M, N, K) < 2**31 - _PAD and _pad(M) // _PAD <= 65535,
           f"shape ({M}, {K}) @ ({K}, {N}) exceeds the kernel's index range")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if out.numel():
        k_pad = _pad(K)
        qx = torch.empty((_pad(M), k_pad), dtype=torch.int8, device=dev)
        qwT = torch.empty((_pad(N), k_pad), dtype=torch.int8, device=dev)
        sx = torch.empty((M,), dtype=torch.float32, device=dev)
        sw = torch.empty((N,), dtype=torch.float32, device=dev)
        col_amax = torch.empty((N,), dtype=torch.int32, device=dev)
        splits = splits_for(M, N, K, torch.cuda.get_device_properties(dev).multi_processor_count)
        partial = torch.empty((splits, M, N), dtype=torch.int32, device=dev)
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.int8_matmul_launch(_KIND[x.dtype], x2.data_ptr(), w.data_ptr(),
                                        qx.data_ptr(), sx.data_ptr(), qwT.data_ptr(),
                                        sw.data_ptr(), col_amax.data_ptr(), partial.data_ptr(),
                                        out.data_ptr(), M, N, K, splits, stream)
        if rc != 0:
            raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc} "
                               f"({lib.int8_matmul_error_string(rc).decode()})")
        record_launch("int8_matmul")
    return out.reshape(lead + (N,))
