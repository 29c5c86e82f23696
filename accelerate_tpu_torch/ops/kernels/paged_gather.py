"""Wrapper of the paged KV gather kernel (``csrc/paged_gather.cu``).

The CUDA counterpart of the TPU kernel ``gather_block_view_kernel``
(``accelerate_tpu/ops/pallas/paged_decode.py:204``): pool + block tables →
per-slot contiguous views, zeros for inactive slots, with an optional int8
dequant (``scales``). Its plain version is
``ops/paged_attention.gather_block_view``; the two are bitwise equal on
active slots. This wrapper takes CUDA tensors only — CPU tensors reach the
plain version through the registry (``ops/registry.dispatch``) — and it
checks device, dtype, shape and contiguity, allocates its output with
``torch.empty``, launches on the current stream, raises on a launch error,
and counts each launch under its kernel name.
"""

from __future__ import annotations

import ctypes

import torch

from ..registry import record_launch
from ._build import load

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("paged_gather")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.paged_gather_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, ptr]
        lib.paged_gather_launch.restype = i32
        lib.paged_gather_dequant_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                                    i32, i32, i32, i32, ptr]
        lib.paged_gather_dequant_launch.restype = i32
        lib.paged_gather_error_string.argtypes = [i32]
        lib.paged_gather_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_gather kernel: {msg}")


def paged_gather(pool_kv, block_tables, *, active=None, scales=None, out_dtype=None):
    """Launch the gather. ``pool_kv``: ``(L, N, bs, H, D)`` or ``(N, bs, H, D)``;
    ``block_tables``: ``(B, M)`` int32; ``active``: ``(B,)`` bool or None
    (all slots); ``scales``: ``(..., N, bs)`` float32 for an int8 pool.
    Returns ``(..., B, M*bs, H, D)`` in the pool's dtype, or in ``out_dtype``
    (float32 by default) when dequantizing."""
    _check(pool_kv.is_cuda, f"takes CUDA tensors, got a tensor on {pool_kv.device}")
    dev = pool_kv.device
    squeeze = pool_kv.dim() == 4
    if squeeze:
        pool_kv = pool_kv[None]
        scales = None if scales is None else scales[None]
    _check(pool_kv.dim() == 5, f"pool must be 4-D or 5-D, got shape {tuple(pool_kv.shape)}")
    _check(pool_kv.is_contiguous(), "pool must be contiguous")
    L, N, bs, H, D = pool_kv.shape
    _check(block_tables.dim() == 2 and block_tables.dtype == torch.int32
           and block_tables.device == dev and block_tables.is_contiguous(),
           "block_tables must be a contiguous (B, M) int32 tensor on the pool's device")
    B, M = block_tables.shape
    _check(L <= 65535 and B <= 65535, f"grid limit: L={L}, B={B} must be <= 65535")
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    _check(active.dtype == torch.bool and tuple(active.shape) == (B,)
           and active.device == dev and active.is_contiguous(),
           "active must be a contiguous (B,) bool tensor on the pool's device")
    quant = scales is not None
    if quant:
        out_dt = torch.float32 if out_dtype is None else out_dtype
        _check(pool_kv.dtype == torch.int8, f"dequant needs an int8 pool, got {pool_kv.dtype}")
        _check(scales.dtype == torch.float32 and tuple(scales.shape) == (L, N, bs)
               and scales.device == dev and scales.is_contiguous(),
               "scales must be a contiguous (L, N, bs) float32 tensor on the pool's device")
        _check(out_dt in _OUT_KIND, f"dequant output dtype {out_dt} not in {list(_OUT_KIND)}")
        _check((H * D) % 16 == 0, f"dequant needs Hkv*D % 16 == 0, got {H * D}")
    else:
        out_dt = pool_kv.dtype
        block_bytes = bs * H * D * pool_kv.element_size()
        _check(block_bytes % 16 == 0, f"block bytes {block_bytes} must be a multiple of 16")
    out = torch.empty((L, B, M * bs, H, D), dtype=out_dt, device=dev)
    if out.numel():
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if quant:
                rc = lib.paged_gather_dequant_launch(
                    pool_kv.data_ptr(), scales.data_ptr(), block_tables.data_ptr(),
                    active.data_ptr(), out.data_ptr(), _OUT_KIND[out_dt], L, N, B, M, bs,
                    H * D, stream)
            else:
                rc = lib.paged_gather_launch(
                    pool_kv.data_ptr(), block_tables.data_ptr(), active.data_ptr(),
                    out.data_ptr(), L, N, B, M, block_bytes, stream)
        if rc != 0:
            raise RuntimeError(f"paged_gather kernel launch failed: CUDA error {rc} "
                               f"({lib.paged_gather_error_string(rc).decode()})")
        record_launch("paged_gather_dequant" if quant else "paged_gather")
    if not quant and out_dtype is not None:
        out = out.to(out_dtype)
    return out[0] if squeeze else out
