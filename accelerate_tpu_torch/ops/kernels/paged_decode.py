"""Wrapper of the fused paged decode attention kernel (``csrc/paged_decode.cu``).

The CUDA counterpart of the TPU kernel ``paged_attention_kernel``
(``accelerate_tpu/ops/pallas/paged_decode.py:64``): each slot's block chain
is read straight from the pool, dequantized when ``k_scale``/``v_scale`` are
given, and run through the math of ``cached_attention`` (GQA, causality on
chain order, the pool mask, windows in valid-slot distance, softcap, a query
chunk of any S). Slots with ``active == 0`` walk nothing and give zeros. Its
plain version is ``ops/paged_attention.paged_attention_plain`` (the plain
gather, then ``cached_attention``); the two agree to a tolerance: the
kernel sums in another order.

Takes CUDA tensors only — CPU tensors reach the plain version through the
registry — checks device, dtypes, shapes and the shared-memory capacity (the
scores of one chain live in shared memory; a chain that does not fit raises
and is never truncated), allocates the output with ``torch.empty``,
launches on the current stream, raises on a launch error and counts each
launch as ``paged_decode``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..registry import record_launch
from ._build import load

_Q_KIND = {torch.float32: 0, torch.bfloat16: 1}
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
THREADS = 256      # the kernel's CTA
SMEM_LIMIT = 227 * 1024 - 1024  # H100: 227 KB a block, less the kernel's static scratch
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("paged_decode")
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.paged_decode_launch.argtypes = ([i32, i32] + [ptr] * 10 + [i32] * 8
                                            + [i32, i32, f32, f32, i64, ptr])
        lib.paged_decode_launch.restype = i32
        lib.paged_decode_error_string.argtypes = [i32]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_decode kernel: {msg}")


def smem_bytes(T: int, D: int, use_rank: bool) -> int:
    """Dynamic shared memory of one CTA (one query head): the query row, the
    chain's scores, the P.V parts (1024 / D of them, D each), each key's
    pool row, and the valid-slot ranks when a window meets a mask."""
    return 4 * (D + T + 4 * THREADS + T + (T if use_rank else 0))


def paged_decode_cuda(q, k_pool, v_pool, block_tables, *, q_positions, pool_mask=None,
                      window=None, softcap=None, scale=None, active=None, k_scale=None,
                      v_scale=None):
    """Launch the fused decode attention. q ``(B, S, H, D)``; pools ``(N, bs,
    Hkv, D)`` (bf16, f32, or int8 with ``(N, bs)`` f32 scales); tables
    ``(B, M)``; ``q_positions`` ``(S,)`` or ``(B, S)``; ``pool_mask``
    ``(N, bs)``; ``active`` ``(B,)``. Returns ``(B, S, H, D)``: f32 for an
    int8 pool, else the promotion of q's and the pool's types."""
    _check(q.is_cuda, f"takes CUDA tensors, got a tensor on {q.device}")
    dev = q.device
    _check(q.dim() == 4 and q.dtype in _Q_KIND,
           f"q must be a (B, S, H, D) float32 or bfloat16 tensor, got {tuple(q.shape)} {q.dtype}")
    B, S, H, D = q.shape
    _check(k_pool.dim() == 4 and tuple(v_pool.shape) == tuple(k_pool.shape)
           and k_pool.dtype == v_pool.dtype and k_pool.dtype in _KV_KIND,
           f"pools must be two (N, bs, Hkv, D) tensors of one type in {list(_KV_KIND)}, got "
           f"{tuple(k_pool.shape)} {k_pool.dtype} and {tuple(v_pool.shape)} {v_pool.dtype}")
    N, bs, Hkv, Dk = k_pool.shape
    _check(Dk == D and Hkv > 0 and H % Hkv == 0,
           f"q heads {H} x {D} do not group over pool heads {Hkv} x {Dk}")
    _check(D % 4 == 0 and THREADS % (D // 4) == 0,
           f"head width {D} must be a multiple of 4 whose quarter divides {THREADS}")
    quant = k_scale is not None
    _check(quant == (v_scale is not None), "k_scale and v_scale come together")
    _check(quant == (k_pool.dtype == torch.int8),
           "an int8 pool needs k_scale and v_scale, and only an int8 pool takes them")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B and block_tables.shape[1] > 0,
           f"block_tables must be (B={B}, M >= 1), got {tuple(block_tables.shape)}")
    M = block_tables.shape[1]
    T = M * bs
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
                    ("q_positions", q_positions), ("pool_mask", pool_mask),
                    ("active", active), ("k_scale", k_scale), ("v_scale", v_scale)):
        _check(t is None or t.device == dev, f"{name} must lie on q's device, {dev}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t.dtype == torch.float32 and tuple(t.shape) == (N, bs),
                   f"{name} must be ({N}, {bs}) float32, got {tuple(t.shape)} {t.dtype}")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    if pool_mask is not None:
        _check(tuple(pool_mask.shape) == (N, bs), f"pool_mask must be ({N}, {bs})")
        pool_mask = pool_mask.to(torch.int32).contiguous()
    pos = q_positions
    _check(pos.dim() in (1, 2) and pos.shape[-1] == S and (pos.dim() == 1 or pos.shape[0] == B),
           f"q_positions must be ({S},) or ({B}, {S}), got {tuple(pos.shape)}")
    pos = pos.to(torch.int32).expand(B, S).contiguous()
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    _check(tuple(active.shape) == (B,), f"active must be ({B},), got {tuple(active.shape)}")
    active = (active != 0).contiguous()
    _check(softcap is None or softcap > 0, f"softcap must be positive, got {softcap}")
    use_rank = window is not None and pool_mask is not None
    smem = smem_bytes(T, D, use_rank)
    _check(smem <= SMEM_LIMIT,
           f"a chain of {T} keys needs {smem} bytes of shared memory, over the {SMEM_LIMIT} "
           f"a block can have")
    _check(B <= 2**31 - 1 and H <= 65535 and S <= 65535 and N * bs < 2**31,
           f"grid ({B}, {H}, {S}) or pool rows {N * bs} too large")
    out_dt = torch.float32 if quant else torch.promote_types(q.dtype, v_pool.dtype)
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    align = 4 * k_pool.element_size()  # the kernel loads four elements at a time
    _check(k_pool.data_ptr() % align == 0 and v_pool.data_ptr() % align == 0,
           f"pools must be {align}-byte aligned")
    tables = block_tables.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, D), dtype=out_dt, device=dev)
    if out.numel() == 0:
        return out
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.paged_decode_launch(
            _Q_KIND[q.dtype], _KV_KIND[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), ptr(k_scale), ptr(v_scale), tables.data_ptr(), pos.data_ptr(),
            ptr(pool_mask), active.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, N, bs, M,
            int(window is not None), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), scale, smem, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc} "
                           f"({lib.paged_decode_error_string(rc).decode()})")
    record_launch("paged_decode")
    return out
