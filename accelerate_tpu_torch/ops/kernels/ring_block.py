"""Wrapper of the ring-attention block kernels (``csrc/flash_attention.cu``:
``ring_block_fwd_launch`` and ``ring_block_bwd_launch``).

The CUDA counterpart of the library flash calls in the JAX package's ring
(``accelerate_tpu/parallel/ring.py``: ``_flash_block_fwd`` at ``:93``, which
calls ``_flash_attention(..., save_residuals=True)`` at ``:112``, and
``_flash_block_bwd`` at ``:209``, which calls ``_flash_attention_bwd_dq`` /
``_bwd_dkv`` at ``:228`` / ``:234``). Their plain versions, with the same
signatures and contract, are ``parallel/ring.ring_block_fwd_reference`` and
``ring_block_bwd_reference``; ``ops/registry.py`` pairs them as ops
``ring_block_fwd`` and ``ring_block_bwd``.

One visiting KV block of a rank's shard. ``mode``: 0 the diagonal block
(causal inside), 1 fully visible, 2 skipped (no launch, nothing counted).
``kv_mask`` (B, S), 1 = real key, or None: the travelling block's padding,
which the kernel takes as kv segment ids against all-real query segments.

- :func:`ring_block_fwd_cuda` returns ``(o, l, m)``: the block-normalised
  output in q's dtype (bf16) and the row stats (B, H, S) f32; a row with no
  visible key gives ``o = 0, l = 0, m = -1e30``.
- :func:`ring_block_bwd_cuda` adds the block's dq, dk, dv into the f32
  accumulators it is given, from the rank's global log-sum-exp (+inf mapped
  to 1e30) and its delta = rowsum(dO * O), both (B, H, S) f32.

Each counts one launch (``ring_block_fwd`` / ``ring_block_bwd``) where it
launches. Takes CUDA tensors only, bf16 q, k, v, dout of equal shape, D in
(64, 128), S a multiple of 64; anything else raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..registry import record_launch
from ._build import load
from .flash_attention import HEAD_DIMS, SEQ_MULTIPLE

DIAGONAL, FULL, SKIP = 0, 1, 2  # the ring's block modes
MODES = (DIAGONAL, FULL, SKIP)
NEG_INF = -1e30  # the ring's running max of a row that has seen no key
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ring_block_fwd_launch.argtypes = [ptr] * 8 + [i32] * 5 + [f32, ptr]
        lib.ring_block_fwd_launch.restype = i32
        lib.ring_block_bwd_launch.argtypes = [ptr] * 11 + [i32] * 5 + [f32, ptr]
        lib.ring_block_bwd_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ring_block kernel: {msg}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({_lib().flash_attention_error_string(rc).decode()})")


def _check_block(q, k, v, kv_mask, mode):
    _check(q.is_cuda, f"takes CUDA tensors, got a tensor on {q.device}")
    _check(q.dim() == 4, f"q must be (B, S, H, D), got shape {tuple(q.shape)}")
    B, S, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        _check(t.shape == q.shape and t.device == q.device,
               f"{name} must match q's shape {tuple(q.shape)} and device (repeat GQA heads "
               f"first), got {tuple(t.shape)} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.dtype == torch.bfloat16, f"{name} must be bfloat16, got {t.dtype}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(S > 0 and S % SEQ_MULTIPLE == 0, f"shard length {S} must be a positive multiple "
                                            f"of {SEQ_MULTIPLE}")
    _check(S // SEQ_MULTIPLE <= 65535 and B * H <= 65535, f"grid limit: B*H={B * H}")
    _check(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    if kv_mask is not None:
        _check(tuple(kv_mask.shape) == (B, S) and kv_mask.device == q.device,
               f"kv_mask must be (B, S) = {(B, S)} on q's device, got "
               f"{tuple(kv_mask.shape)} on {kv_mask.device}")


def _segments(kv_mask, B, S, device):
    """(q, kv) segment ids: every query real (2), keys real (2) or pads (1)."""
    if kv_mask is None:
        return None, None
    seg_q = torch.full((B, S), 2, dtype=torch.int32, device=device)
    seg_kv = torch.where(kv_mask.bool(), 2, 1).to(torch.int32).contiguous()
    return seg_q, seg_kv


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_f32(name, t, shape, device):
    _check(t.dtype == torch.float32 and tuple(t.shape) == tuple(shape) and t.device == device
           and t.is_contiguous(),
           f"{name} must be a contiguous {tuple(shape)} float32 tensor on {device}")


def ring_block_fwd_cuda(q, k, v, kv_mask, mode: int):
    """One ring block forward on CUDA tensors: ``(o, l, m)``."""
    _check_block(q, k, v, kv_mask, mode)
    B, S, H, D = q.shape
    if mode == SKIP:
        return (torch.zeros_like(q), torch.zeros((B, H, S), dtype=torch.float32, device=q.device),
                torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device))
    o = torch.empty_like(q)
    l = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    seg_q, seg_kv = _segments(kv_mask, B, S, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().ring_block_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), B, S, H, D, int(mode == DIAGONAL), 1.0 / math.sqrt(D),
            stream)
    _raise_on(rc, "ring_block_fwd")
    record_launch("ring_block_fwd")
    return o, l, m


def ring_block_bwd_cuda(q, k, v, kv_mask, mode: int, lse, dout, delta, dq, dk, dv):
    """One ring block backward on CUDA tensors: adds the block's gradients
    into the f32 accumulators ``dq`` (q's rows), ``dk`` and ``dv`` (the KV
    block's rows). Returns nothing."""
    _check_block(q, k, v, kv_mask, mode)
    B, S, H, D = q.shape
    _check(dout.shape == q.shape and dout.dtype == torch.bfloat16 and dout.is_contiguous()
           and dout.device == q.device, "dout must be a contiguous bf16 tensor shaped as q")
    for name, t in (("lse", lse), ("delta", delta)):
        _check_f32(name, t, (B, H, S), q.device)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check_f32(name, t, (B, S, H, D), q.device)
    if mode == SKIP:
        return
    seg_q, seg_kv = _segments(kv_mask, B, S, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().ring_block_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_kv), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, D, int(mode == DIAGONAL), 1.0 / math.sqrt(D), stream)
    _raise_on(rc, "ring_block_bwd")
    record_launch("ring_block_bwd")
