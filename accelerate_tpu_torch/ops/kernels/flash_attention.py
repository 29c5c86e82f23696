"""Wrapper of the causal flash attention kernels (``csrc/flash_attention.cu``).

The CUDA counterpart of the library flash kernel the JAX package calls
(``accelerate_tpu/ops/attention.py:144`` → ``jax/experimental/pallas/ops/
tpu/flash_attention.py``: forward ``pallas_call`` at ``:758``, dkv at
``:1121``, dq at ``:1456``). Its plain version is
``ops/attention.flash_attention_reference``.

One ``torch.autograd.Function``: the forward launches the forward kernel and
saves q, k, v, o and the per-row log-sum-exp; the backward launches the
backward kernels (Δ = rowsum(dO∘O), then dK/dV over KV tiles and dQ over
query tiles; no atomics, so it is deterministic). Each direction counts one
launch, ``flash_attention_fwd`` and ``flash_attention_bwd``.

Takes CUDA tensors only — CPU tensors reach the plain version through the
registry — in the layout (B, S, H, D), bf16, contiguous, with equal head
counts for q, k and v (GQA is repeated by the caller), D in (64, 128) and
S a multiple of 64. Anything else raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..registry import record_launch
from ._build import load

HEAD_DIMS = (64, 128)
SEQ_MULTIPLE = 64
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                                   i32, i32, f32, ptr]
        lib.flash_attention_fwd_launch.restype = i32
        lib.flash_attention_bwd_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                                   ptr, ptr, i32, i32, i32, i32, i32, f32, ptr]
        lib.flash_attention_bwd_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({_lib().flash_attention_error_string(rc).decode()})")


def _seg_ptr(segment_ids):
    return None if segment_ids is None else segment_ids.data_ptr()


def _forward(q, k, v, segment_ids, causal: bool, sm_scale: float):
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids), o.data_ptr(),
            lse.data_ptr(), B, S, H, D, int(causal), sm_scale, stream)
    _raise_on(rc, "flash_attention_fwd")
    record_launch("flash_attention_fwd")
    return o, lse


def _backward(q, k, v, segment_ids, o, lse, do, causal: bool, sm_scale: float):
    B, S, H, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, H, D, int(causal), sm_scale, stream)
    _raise_on(rc, "flash_attention_bwd")
    record_launch("flash_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale):
        o, lse = _forward(q, k, v, segment_ids, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.segment_ids, ctx.causal, ctx.sm_scale = segment_ids, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, ctx.segment_ids, o, lse, do.contiguous(),
                               ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention_cuda(q, k, v, segment_ids=None, causal=True, sm_scale=None):
    """Launch the flash forward (and, under autograd, the backward) on CUDA
    tensors. Same signature and semantics as
    ``ops/attention.flash_attention_reference``; ``sm_scale`` defaults to
    1/sqrt(D)."""
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
    _check(S > 0 and S % SEQ_MULTIPLE == 0, f"sequence length {S} must be a positive "
                                            f"multiple of {SEQ_MULTIPLE}")
    _check(S // SEQ_MULTIPLE <= 65535 and B * H <= 65535, f"grid limit: B*H={B * H}")
    if segment_ids is not None:
        _check(segment_ids.dtype == torch.int32 and tuple(segment_ids.shape) == (B, S)
               and segment_ids.device == q.device and segment_ids.is_contiguous(),
               "segment_ids must be a contiguous (B, S) int32 tensor on q's device")
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal), scale)
