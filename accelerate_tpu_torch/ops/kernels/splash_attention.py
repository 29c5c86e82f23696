"""Wrapper of the splash attention kernels (``csrc/splash_attention.cu``).

The CUDA counterpart of the library splash kernel the JAX package calls
(``accelerate_tpu/ops/attention.py:180`` → ``make_splash_mha`` in
``jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py``:
forward ``flash_attention_kernel``, dq ``_flash_attention_dq_kernel``, dkv
``_flash_attention_dkv_kernel``). Its plain version is
``ops/attention.splash_attention_reference``.

One ``torch.autograd.Function``: the forward launches the forward kernel and
saves q, k, v, o and the per-row log-sum-exp; the backward launches the
backward kernels (Δ = rowsum(dO∘O), then dK/dV over KV tiles and dQ over
query tiles; no atomics, so it is deterministic). Each direction counts one
launch, ``splash_attention_fwd`` and ``splash_attention_bwd``.

Takes CUDA tensors only — CPU tensors reach the plain version through the
registry — in the layout (B, S, H, D), bf16, contiguous, q already scaled,
equal head counts for q, k and v (GQA is repeated by the caller), D in
:data:`HEAD_DIMS` and S a multiple of 64; ``window`` None or a positive int,
``softcap`` None or a positive float. Anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..registry import record_launch
from ._build import load

HEAD_DIMS = (64, 128, 256)
SEQ_MULTIPLE = 64
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("splash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.splash_attention_fwd_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                                    i32, i32, f32, ptr]
        lib.splash_attention_fwd_launch.restype = i32
        lib.splash_attention_bwd_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                                    ptr, ptr, i32, i32, i32, i32, i32, f32, ptr]
        lib.splash_attention_bwd_launch.restype = i32
        lib.splash_attention_error_string.argtypes = [i32]
        lib.splash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"splash_attention kernel: {msg}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({_lib().splash_attention_error_string(rc).decode()})")


def _seg_ptr(segment_ids):
    return None if segment_ids is None else segment_ids.data_ptr()


def _forward(q, k, v, segment_ids, window: int, softcap: float):
    """(o, lse); ``window`` 0 and ``softcap`` 0.0 mean none."""
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().splash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids), o.data_ptr(),
            lse.data_ptr(), B, S, H, D, window, softcap, stream)
    _raise_on(rc, "splash_attention_fwd")
    record_launch("splash_attention_fwd")
    return o, lse


def _backward(q, k, v, segment_ids, o, lse, do, window: int, softcap: float):
    B, S, H, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib().splash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, H, D, window, softcap, stream)
    _raise_on(rc, "splash_attention_bwd")
    record_launch("splash_attention_bwd")
    return dq, dk, dv


class _SplashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, window, softcap):
        o, lse = _forward(q, k, v, segment_ids, window, softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.segment_ids, ctx.window, ctx.softcap = segment_ids, window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, ctx.segment_ids, o, lse, do.contiguous(),
                               ctx.window, ctx.softcap)
        return dq, dk, dv, None, None, None


def splash_attention_cuda(q, k, v, segment_ids=None, window=None, softcap=None):
    """Launch the splash forward (and, under autograd, the backward) on CUDA
    tensors. Same signature and semantics as
    ``ops/attention.splash_attention_reference``."""
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
    if window is not None:
        _check(int(window) == window and window > 0, f"window must be a positive int, got "
                                                     f"{window!r}")
    if softcap is not None:
        _check(softcap > 0, f"softcap must be positive, got {softcap!r}")
    # A window of S or more keys is the causal mask; clamping keeps it an int32.
    window = 0 if window is None else min(int(window), S)
    return _SplashAttention.apply(q, k, v, segment_ids, window,
                                  0.0 if softcap is None else float(softcap))
